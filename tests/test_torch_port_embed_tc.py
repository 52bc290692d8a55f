"""K4 and K8 in bf16 (the patch embed on rows and on the volume) as
csrc/embed_tc.cu computes them, on the CPU: the plain versions against the
JAX package's Pallas kernels in interpret mode, the kernel's decomposition
(a stats pass, then each 64-wide k block normalised with s1 and b1
zero-padded past patch_dim) against the plain version bit for bit, and the
route and launch counters of the CUDA path with the C library stubbed.

    python -m pytest tests/test_torch_port_embed_tc.py -q

Tolerances: max|err| <= 2e-2 max|ref| (bf16 outputs) and mean|err| <=
EMBED_MEAN_TOL mean|ref|.  The max cannot tell two bf16 rounding points
apart; the mean can: the plain version rounds where the TPU kernel does
(xn, y, yb, out), and a copy adding pbias to the f32 y before one rounding
must miss the mean limit.  Interpret mode runs the kernel bodies through
XLA:CPU's jit, which does not keep their bf16 rounding points (the body of
_rows_kernel jitted reads 1.4e-3 of mean from the same body evaluated op by
op): against it the mean limit is INTERPRET_MEAN_TOL, and the rounding
points are held against the bodies evaluated eagerly, op by op.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops import patch_embed as pe
from ct_clip_tpu_torch.ops.norms import layer_norm

BF = torch.bfloat16
REL = 2e-2
EMBED_MEAN_TOL = 2e-4  # chip_smoke.py and the card tests hold the kernel to it too
INTERPRET_MEAN_TOL = 2e-3
PT, P, T, H, W, DIM = 2, 8, 4, 4, 4, 64  # 4 x 4 x 4 tokens of 2 x 8 x 8 patches -> 64


def _bodies_eagerly(jv, jr, jax_w):
    """The TPU kernels' bodies evaluated op by op (no jit): _rows_kernel's
    math on the rows, _embed_kernel (the patch shuffle into its scratch,
    then the math) on each grid step's block of the volume."""
    from ct_clip_tpu.ops.pallas.patchify import (_embed_grid, _embed_kernel, _rows_embed_math,
                                                 _rows_weights)

    ws = _rows_weights(*jax_w, jnp.bfloat16)
    k4 = _rows_embed_math(jr.astype(jnp.float32), *ws, eps=1e-5, dtype=jnp.bfloat16)
    t, h, w, hb, kd = _embed_grid(jv, PT, P, jnp.bfloat16)
    k8 = np.zeros((jv.shape[0], t * h * w, DIM), dtype=jnp.bfloat16)
    for b in range(jv.shape[0]):
        for ti in range(t):
            for si in range(h // hb):
                o = np.zeros((1, hb * w, DIM), dtype=jnp.bfloat16)
                _embed_kernel(jv[b:b + 1, ti * PT:(ti + 1) * PT, si * hb * P:(si + 1) * hb * P],
                              *ws, o, np.zeros((hb * w, PT * P * P), dtype=kd), pt=PT, p=P,
                              hb=hb, w=w, eps=1e-5)
                n0 = (ti * (h // hb) + si) * hb * w
                k8[b, n0:n0 + hb * w] = o[0]
    return k4.astype(jnp.bfloat16), k8


def _torch(a):
    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32)))


@pytest.fixture(scope="module")
def case():
    """Two volumes (bf16), their patch rows and the weights, with the JAX
    Pallas kernels' outputs in interpret mode (bf16 compute), K8 on the
    volume and K4 on the rows, and their bodies evaluated eagerly."""
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.patchify import _pallas_patch_embed, _pallas_row_embed

    rng = np.random.RandomState(24)
    pd = PT * P * P
    video = (rng.rand(2, T * PT, H * P, W * P) * 2 - 1).astype(np.float32)
    w = dict(s1=1 + 0.1 * rng.randn(pd), b1=0.1 * rng.randn(pd),
             wi=rng.randn(pd, DIM) / np.sqrt(pd), pb=0.1 * rng.randn(DIM),
             s2=1 + 0.1 * rng.randn(DIM), b2=0.1 * rng.randn(DIM))
    jax_w = [jnp.asarray(w[k], jnp.float32) for k in ("s1", "b1", "wi", "pb", "s2", "b2")]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    port_w = (t(w["s1"]), t(w["b1"]), t(w["wi"].T), t(w["pb"]), t(w["s2"]), t(w["b2"]))
    vb = torch.from_numpy(video).to(BF)
    rows = pe.rearrange_plain(vb, PT, P)
    jv = jnp.asarray(video).astype(jnp.bfloat16)
    jr = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        k8 = _pallas_patch_embed(jv, *jax_w, PT, P, 1e-5, jnp.bfloat16)
        k4 = _pallas_row_embed(jr, *jax_w, 1e-5, jnp.bfloat16)
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    e4, e8 = _bodies_eagerly(jv, jr, jax_w)
    return dict(video=vb, rows=rows, w=port_w, k8=_torch(k8), k4=_torch(k4),
                eager_k4=_torch(e4), eager_k8=_torch(e8))


def _errors(got, ref):
    d = (got.float() - ref.float()).abs()
    return (d.max() / ref.float().abs().max()).item(), (d.mean() / ref.float().abs().mean()).item()


def one_rounding(rows, s1, b1, w, pbias, s2, b2, eps=1e-5):
    """The planted copy: pbias added to the f32 y before one rounding."""
    x = layer_norm(rows, s1, b1, eps)
    y = x.float() @ w.to(BF).float().t()
    return layer_norm((y + pbias.to(BF).float()).to(BF), s2, b2, eps)


def _plain(case, kind):
    if kind == "k4":
        return pe.row_embed_plain(case["rows"], *case["w"])
    return pe.patch_embed_plain(case["video"], *case["w"], PT, P)


@pytest.mark.parametrize("kind", ["k4", "k8"])
def test_plain_versions_match_the_pallas_kernels_in_interpret_mode(case, kind):
    """row_embed_plain against _pallas_row_embed, patch_embed_plain against
    _pallas_patch_embed in interpret mode: REL of max, INTERPRET_MEAN_TOL
    of mean."""
    got = _plain(case, kind)
    assert got.dtype == BF
    mx, mean = _errors(got, case[kind])
    assert mx <= REL and mean <= INTERPRET_MEAN_TOL, (mx, mean)


@pytest.mark.parametrize("kind", ["k4", "k8"])
def test_plain_versions_keep_the_kernel_bodies_rounding_points(case, kind):
    """The same against the kernel bodies evaluated op by op: REL of max and
    EMBED_MEAN_TOL of mean, which the single rounding of y + pbias misses."""
    ref = case[f"eager_{kind}"]
    mx, mean = _errors(_plain(case, kind), ref)
    assert mx <= REL and mean <= EMBED_MEAN_TOL, (mx, mean)
    _, planted = _errors(one_rounding(case["rows"], *case["w"]), ref)
    assert planted > EMBED_MEAN_TOL, planted


def decomposed_row_embed(rows, s1, b1, w, pbias, s2, b2, eps=1e-5, kb=64, pad=0.0,
                         mask=True):
    """embed_tc.cu's decomposition in plain PyTorch: (mean, rstd) from a
    separate pass as ops/norms.py::layer_norm takes them, then each 64-wide
    k block of the rows, zero-filled past patch_dim, normalised with s1, b1
    (whose slots past patch_dim hold `pad`, as the kernel's ring holds what
    an earlier block left there), each operation rounded alone, xn in bf16,
    the columns past patch_dim written 0 (`mask`); the padded columns must
    come out 0.  Then the product, yb and LN(dim) at the plain version's
    points."""
    x = rows.reshape(-1, rows.shape[-1]).float()
    k = x.shape[1]
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    kp = -(-k // kb) * kb
    xp, s1p, b1p = torch.zeros((x.shape[0], kp)), torch.full((kp,), pad), torch.full((kp,), pad)
    xp[:, :k], s1p[:k], b1p[:k] = x, s1.float(), b1.float()
    blocks = [(((xp[:, k0:k0 + kb] - mean) * rstd) * s1p[k0:k0 + kb]
               + b1p[k0:k0 + kb]).to(BF) for k0 in range(0, kp, kb)]
    xn = torch.cat(blocks, dim=1)
    if mask:
        xn[:, k:] = 0
    assert not xn[:, k:].float().abs().any(), "a padded column normalised to non-zero"
    y = xn[:, :k] @ w.to(BF).t()
    out = layer_norm(y + pbias.to(BF), s2, b2, eps)
    return out.view(*rows.shape[:-1], -1)


@pytest.mark.parametrize("pt,p,dim", [(10, 20, 512), (PT, P, DIM), (4, 16, 64)])
def test_decomposition_equals_the_plain_version_bit_for_bit(pt, p, dim):
    """patch_dim 4,000 = 62 x 64 + 32 (the padded block included), 128 and
    1,024: the decomposition equals row_embed_plain bit for bit, whatever
    the s1, b1 slots past patch_dim hold.  Without writing those columns 0,
    the last block's columns past patch_dim would normalise to b1 - mean
    rstd s1, not 0."""
    g = torch.Generator().manual_seed(pt * p)
    pd = pt * p * p
    rows = (torch.rand((2, 5, pd), generator=g) * 2 - 1).to(BF)
    w = (1 + 0.1 * torch.randn(pd, generator=g), 0.1 * torch.randn(pd, generator=g),
         torch.randn((dim, pd), generator=g) * pd ** -0.5, 0.1 * torch.randn(dim, generator=g),
         1 + 0.1 * torch.randn(dim, generator=g), 0.1 * torch.randn(dim, generator=g))
    want = pe.row_embed_plain(rows, *w)
    assert torch.equal(decomposed_row_embed(rows, *w), want)
    assert torch.equal(decomposed_row_embed(rows, *w, pad=0.7), want)
    if pd % 64:  # the trap: the slots past patch_dim not zero, the columns not masked
        with pytest.raises(AssertionError, match="padded column"):
            decomposed_row_embed(rows, *w, pad=0.7, mask=False)


EMBED_FITS = [
    # patch_dim, dim, the volume (shape, pt, p) or None (rows), whether it fits
    (4000, 512, None, True),                          # K4 at full width
    (4000, 512, ((2, 240, 480, 480), 10, 20), True),  # K8
    (1024, 64, None, True),                           # the tiny configs
    (1024, 128, ((8, 16, 64, 64), 4, 16), True),
    (2560, 512, ((1, 200, 128, 128), 10, 16), True),  # the autoencoder
    (72, 64, ((1, 4, 24, 24), 2, 6), False),          # p % 4: 8-byte gathers
    (72, 64, None, True),                             # the same rows: TMA takes them
    (1000, 64, ((1, 10, 20, 22), 10, 10), False),     # W % 4
    (50, 64, None, False),                            # rows of 100 bytes
    (4000, 100, None, False),                         # dim % 8
    (4104, 512, None, False),                         # beyond the stats' registers
    (4000, 768, None, False),                         # a CTA holds rows of <= 512
]


@pytest.mark.parametrize("pd,dim,geom,fits", EMBED_FITS)
def test_embed_fits(pd, dim, geom, fits):
    assert K.embed_fits(pd, dim, geom) is fits


class _Recorder:
    """Any C entry, recording each call's name and arguments (returns 0)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ct_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


def _stub(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "require", lambda *a, **k: None)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    K.reset_launch_counts()
    return lib


def _weights(pd, dim):
    return (torch.ones(pd), torch.zeros(pd), torch.zeros((dim, pd)), torch.zeros(dim),
            torch.ones(dim), torch.zeros(dim))


@pytest.mark.parametrize("kind", ["rows", "volume"])
def test_k4_k8_launch_embed_tc_once(monkeypatch, kind):
    """The bf16 CUDA bodies of K4 and K8 (CPU tensors, C library stubbed):
    the rows' statistics, then one ct_embed_tc with the rows or the volume's
    geometry and s1 / b1 as given, no layernorm.cu or gemm.cu launch;
    counted embed_tc beside row_embed / patch_embed."""
    lib = _stub(monkeypatch)
    if kind == "volume":
        out = pe._patch_embed_cuda(torch.zeros((1, 20, 40, 40), dtype=BF),
                                   *_weights(4000, 512), 10, 20, 1e-5)
    else:
        out = pe._row_embed_cuda(torch.zeros((1, 8, 4000), dtype=BF), *_weights(4000, 512),
                                 1e-5)
    assert out.shape == (1, 8, 512)
    assert [n for n, _ in lib.calls] == ["ct_embed_stats", "ct_embed_tc"]
    stats, a = lib.calls[0][1], lib.calls[1][1]
    assert stats[:9] == a[:9] and stats[9:11] == (8, 4000)  # the rows; M, K
    if kind == "volume":
        assert a[0] is None and a[3:9] == (1, 20, 40, 40, 10, 20)  # gathered
    else:
        assert a[0] is not None and a[1] == 4000 and a[2] is None
    assert a[11] is not None and a[12] is not None and a[17:20] == (8, 512, 4000)  # M, N, K
    c = K.launch_counts()
    assert c["embed_tc"] == 1
    assert c["patch_embed" if kind == "volume" else "row_embed"] == 1


def test_misfit_widths_raise(monkeypatch):
    """K8 with p = 6 and K4 with patch_dim 50 raise before any launch, and
    no counter rises: no other route takes them."""
    lib = _stub(monkeypatch)
    with pytest.raises(ValueError, match="embed_fits"):
        pe._patch_embed_cuda(torch.zeros((1, 4, 24, 24), dtype=BF), *_weights(72, 64), 2, 6,
                             1e-5)
    with pytest.raises(ValueError, match="embed_fits"):
        pe._row_embed_cuda(torch.zeros((1, 30, 50), dtype=BF), *_weights(50, 64), 1e-5)
    with pytest.raises(ValueError, match="embed_fits"):
        K.embed_tc(torch.zeros((1, 4, 24, 24), dtype=BF), *_weights(72, 64), 1e-5, geom=(2, 6))
    with pytest.raises(ValueError, match="embed_fits"):
        K.embed_tc(torch.zeros((30, 50), dtype=BF), *_weights(50, 64), 1e-5)
    assert lib.calls == [] and not any(K.launch_counts().values())
