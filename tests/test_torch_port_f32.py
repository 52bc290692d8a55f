"""The f32 forms of the port's kernels against the JAX package's Pallas
kernels run in f32, in interpret mode, on the CPU.

The TPU kernels compute f32 operands in true f32 ("highest",
ct_clip_tpu/ops/pallas/_call.py:50-70); the port's f32 forms (csrc/gemm.cu,
attention.cu, layernorm.cu, rearrange.cu) run on the card only, so here each
Pallas kernel is held against the plain version its CUDA form is checked
against on the card, on the same numpy-seeded inputs, at shapes the Pallas
kernel's `_plan` accepts: K3 and K11 (`ffn.py`), K1
(`spatial_attention.py`), K2 in grid and sequence-major form
(`small_attention.py`), K5 on f32 rows (`vq.py::pallas_assign`, normalised
then rounded to bf16) and K6 / K17 on f32 blocks (`patchify.py`).

Tolerances, relative to the largest entry of the JAX result: forwards
1e-5 (f32 sums in other orders; the TPU kernels' Abramowitz-Stegun erf is
~2e-6 from the port's exact one), weight gradients 1e-4 (sums over all
rows); K5's ids equal up to ties of the kernel's own math; K6 / K17 equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FWD = 1e-5
WGRAD = 1e-4


def _close(got, ref, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max abs err {err:.3e} of max {np.abs(ref).max():.3e}"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _f(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


# ------------------------------------------------------------ K3 and K11
def _ff_inputs(seed, rows=1024, dim=128):
    rng = np.random.RandomState(seed)
    inner = int(4 * (2.0 / 3.0) * dim)  # MaskgitFeedForward's width
    return dict(x=rng.randn(rows, dim), scale=1 + 0.2 * rng.randn(dim),
                bias=0.1 * rng.randn(dim), wia=rng.randn(dim, inner) / np.sqrt(dim),
                wig=rng.randn(dim, inner) / np.sqrt(dim),
                wo=rng.randn(inner, dim) / np.sqrt(inner), do=rng.randn(rows, dim))


def _ff_port_args(a):
    """JAX (in, out) kernels -> the port's wi (2 inner, dim), wo (dim, inner)."""
    return (_t(a["x"]), _t(a["scale"]), _t(a["bias"]),
            _t(np.concatenate([a["wia"], a["wig"]], axis=1).T), _t(a["wo"].T))


def test_k3_f32_matches_pallas_ff(pallas_interpret):
    from ct_clip_tpu.ops.pallas.ffn import _pallas_ff, _plan
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff

    a = _ff_inputs(1)
    m = _plan(a["x"].shape, 128, a["wia"].shape[1], 4)
    assert m is not None
    ref = _pallas_ff(*(_f(a[k]) for k in ("x", "scale", "bias", "wia", "wig", "wo")), 1e-5, m,
                     residual=True)
    assert ref.dtype == jnp.float32
    _close(fused_geglu_ff(*_ff_port_args(a)), ref, FWD)


def test_k11_f32_matches_pallas_ff_bwd(pallas_interpret):
    from ct_clip_tpu.ops.pallas.ffn import _pallas_ff_bwd, _pick_m_bwd
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff

    a = _ff_inputs(2)
    m = _pick_m_bwd(1024, 128, a["wia"].shape[1], 4)
    dx, ds, db, dwa, dwg, dwo = _pallas_ff_bwd(
        *(_f(a[k]) for k in ("x", "scale", "bias", "wia", "wig", "wo", "do")), 1e-5, m,
        residual=True)
    leaves = [t.requires_grad_() for t in _ff_port_args(a)]
    got = torch.autograd.grad(fused_geglu_ff(*leaves), leaves, _t(a["do"]))
    _close(got[0], dx, FWD)
    _close(got[1], ds, WGRAD)
    _close(got[2], db, WGRAD)
    _close(got[3], np.concatenate([np.asarray(dwa), np.asarray(dwg)], axis=1).T, WGRAD)
    _close(got[4], np.asarray(dwo).T, WGRAD)


# ------------------------------------------------------------ K1 and K2
def _attn_inputs(seed, shape, dim, heads, dh):
    rng = np.random.RandomState(seed)
    hd = heads * dh
    w = dict(gamma=1 + 0.1 * rng.randn(dim), wq=rng.randn(dim, hd) / np.sqrt(dim),
             wkv=rng.randn(dim, 2 * hd) / np.sqrt(dim), q_scale=1 + 0.3 * rng.rand(dh),
             k_scale=1 + 0.3 * rng.rand(dh), wout=rng.randn(hd, dim) / np.sqrt(hd))
    return rng, rng.randn(*shape), w


def _jax_w(w):
    return tuple(_f(w[k]) for k in ("gamma", "wq", "wkv", "q_scale", "k_scale", "wout"))


def _port_w(w):
    """JAX (in, out) kernels -> nn.Linear (out, in) weights."""
    return (_t(w["gamma"]), _t(w["wq"].T), _t(w["wkv"].T), _t(w["q_scale"]),
            _t(w["k_scale"]), _t(w["wout"].T))


def test_k1_f32_matches_pallas_spatial(pallas_interpret):
    from ct_clip_tpu.ops.pallas.spatial_attention import _pallas_spatial, _plan
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_spatial_qknorm_attention

    b, n, dim, heads, dh = 2, 128, 128, 2, 64
    rng, x, w = _attn_inputs(3, (b, n, dim), dim, heads, dh)
    bias = rng.randn(heads, n, n)
    assert _plan(b, n, dim, heads, dh)
    ref = _pallas_spatial(_f(x), *_jax_w(w), _f(bias), heads=heads, dim_head=dh, scale=8.0,
                          dtype=jnp.float32, residual=True)
    got = fused_spatial_qknorm_attention(_t(x), *_port_w(w), _t(bias), heads, dh)
    _close(got, ref, FWD)


def test_k2_grid_f32_matches_pallas_small_qknorm(pallas_interpret):
    from ct_clip_tpu.ops.pallas.small_attention import _pallas_small_qknorm, _plan_grid
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_grid_qknorm_attention

    b, n, S, dim, heads, dh = 2, 8, 16, 128, 2, 64
    _, x, w = _attn_inputs(4, (b, n, S, dim), dim, heads, dh)
    g = _plan_grid(b, n, S, dim, heads, dh)
    assert g is not None
    ref = _pallas_small_qknorm(_f(x), *_jax_w(w), g, heads=heads, dim_head=dh, scale=8.0,
                               dtype=jnp.float32, residual=True, grid_layout=True)
    _close(fused_grid_qknorm_attention(_t(x), *_port_w(w), heads, dh), ref, FWD)


def test_k2_seq_f32_matches_pallas_small_qknorm(pallas_interpret):
    from ct_clip_tpu.ops.pallas.small_attention import _pallas_small_qknorm, _plan
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_small_qknorm_attention

    b, n, dim, heads, dh = 16, 24, 128, 2, 64
    _, x, w = _attn_inputs(5, (b, n, dim), dim, heads, dh)
    g = _plan(b, n, dim, heads, dh)
    assert g is not None
    ref = _pallas_small_qknorm(_f(x), *_jax_w(w), g, heads=heads, dim_head=dh, scale=8.0,
                               dtype=jnp.float32, residual=True)
    _close(fused_small_qknorm_attention(_t(x), *_port_w(w), heads, dh), ref, FWD)


# ------------------------------------------------------------ K5 on f32 rows
def test_k5_f32_rows_match_pallas_assign(pallas_interpret):
    """The port's plain version of the f32-row form (row normalised in f32,
    rounded to bf16, one pass against the bf16 codebook) against
    `pallas_assign(exact=False)` on f32 rows: ids equal, but where two codes
    tie within the f32 summation order of that math."""
    from ct_clip_tpu.ops.norms import l2norm as jl2norm
    from ct_clip_tpu.ops.pallas.vq import _plan, pallas_assign
    from ct_clip_tpu_torch.ops.vq import vq_assign_rows_plain

    rng = np.random.RandomState(6)
    n, dim, k = 512, 128, 256
    x = rng.randn(n, dim).astype(np.float32)
    embed_n = np.asarray(jl2norm(_f(rng.randn(k, dim))))
    m = _plan(n, dim, k)
    assert m is not None
    ref = np.asarray(pallas_assign(_f(x), _f(embed_n), m, exact=False))
    got = vq_assign_rows_plain(_t(x), _t(embed_n)).numpy()
    xt = _t(x)
    xn = (xt * torch.rsqrt((xt * xt).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    sim = (xn @ _t(embed_n).to(torch.bfloat16).float().t()).numpy()
    rows = np.arange(n)
    gap = np.abs(sim[rows, got] - sim[rows, ref])
    assert (got == ref).mean() >= 0.99
    assert (gap <= 1e-6 * np.abs(sim).max(axis=1)).all()


@pytest.mark.parametrize("n,dim,k", [(512, 128, 256), (27648, 512, 8192), (10240, 512, 8192),
                                     (100, 128, 256), (512, 64, 128), (640, 128, 200),
                                     (384, 256, 128)])
def test_k5_f32_route_follows_pallas_plan(pallas_interpret, n, dim, k):
    """f32 rows take the kernel exactly where the JAX package's `_plan`
    takes its Pallas kernel, and its f32 XLA form's plain version elsewhere."""
    from ct_clip_tpu.ops.pallas.vq import _plan
    from ct_clip_tpu_torch.ops.vq import rows_fit

    assert rows_fit(n, dim, k) == (_plan(n, dim, k) is not None)


# ------------------------------------------------------------ K6 and K17
def test_k6_k17_f32_match_pallas_rearrange(pallas_interpret):
    """f32 volumes through `_pallas_rearrange` and f32 rows through
    `_pallas_unrearrange` (f32 blocks) against the port's plain moves: equal."""
    from ct_clip_tpu.ops.pallas.patchify import _pallas_rearrange, _pallas_unrearrange
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches, unrearrange_patches

    rng = np.random.RandomState(7)
    video = rng.randn(2, 4, 64, 64).astype(np.float32)
    ref = np.asarray(_pallas_rearrange(_f(video), 2, 8))
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(rearrange_patches(_t(video), 2, 8).numpy(), ref)
    rows = rng.randn(2, 2 * 8 * 8, 128).astype(np.float32)
    ref = np.asarray(_pallas_unrearrange(_f(rows), 2, 8, 4, 64, 64))
    np.testing.assert_array_equal(unrearrange_patches(_t(rows), 2, 8, 4, 64, 64).numpy(), ref)
