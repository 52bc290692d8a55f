"""CT-CLIP pretraining with the auxiliary objectives (visual SSL, MLM, FILIP)
and the embed backwards of ct_clip_tpu_torch against the JAX package, f32,
CPU.

The embed backwards' plain versions (autograd of the plain forwards) are held
against the TPU kernels run in interpret mode: K16a `_pallas_patch_embed_bwd`,
K16b `_pallas_row_embed_bwd` and K17 `_pallas_unrearrange`.  The heads,
losses and MLM are held against the JAX modules, and one whole tiny CT-CLIP
loss with MLM, visual SSL (each tap) and FILIP on against
`jax.value_and_grad` of the JAX model, on weights carried across by
`state_dict_from_jax`.  Random draws cannot match across generators: the
tests derive the JAX package's draws from its keys (`jax.random.split` as
its modules do) and hand them to the port.

Tolerances, each relative to the largest entry of the reference tensor: K17
exact (a move); losses 1e-5; outputs and gradients 1e-4 (f32 sums in other
orders).  Parameters whose true gradient is zero hold rounding noise on both
sides and are held to 1e-6 of the largest gradient: the BERT key bias and the
CPB MLP's output bias (softmax shift invariance, as in
test_torch_port_train.py) and the SimSiam predictor's first bias, which a
BatchNorm follows and cancels.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

DIM, HEADS, DIM_HEAD = 32, 2, 16
IMAGE, PATCH, FRAMES, TPATCH = 24, 8, 6, 2
B, L, VOCAB = 4, 16, 40


def _close(got, ref, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-12, f"{what}: max abs err {err:.3e}"


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).requires_grad_(grad)


def _f(a):
    return jnp.asarray(a, jnp.float32)


@pytest.fixture
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


# ------------------------------------------------------------ embed backwards
PT, P, DIM_E = 2, 8, 128
VIDEO = (2, 4, 32, 64)  # t 2, h 4, w 8: 64 patch rows of 128 per volume


def _embed_inputs(seed):
    rng = np.random.RandomState(seed)
    pd = PT * P * P
    n = (VIDEO[1] // PT) * (VIDEO[2] // P) * (VIDEO[3] // P)
    w = dict(s1=rng.rand(pd) + 0.5, b1=0.1 * rng.randn(pd),
             wi=rng.randn(pd, DIM_E) / np.sqrt(pd), pb=0.1 * rng.randn(DIM_E),
             s2=rng.rand(DIM_E) + 0.5, b2=0.1 * rng.randn(DIM_E))
    return rng.randn(*VIDEO), w, rng.randn(VIDEO[0], n, DIM_E)


def _port_weights(w, grad=False):
    return [_t(w["s1"], grad), _t(w["b1"], grad), _t(w["wi"].T, grad), _t(w["pb"], grad),
            _t(w["s2"], grad), _t(w["b2"], grad)]


def _jax_weights(w):
    return [_f(w[k]) for k in ("s1", "b1", "wi", "pb", "s2", "b2")]


def _as_port_layout(grads):
    """JAX (ds1, db1, dwi (pd, dim), dpb, ds2, db2) -> the port's order and
    nn.Linear layout."""
    ds1, db1, dwi, dpb, ds2, db2 = (np.asarray(g) for g in grads)
    return ds1, db1, dwi.T, dpb, ds2, db2


def test_k16a_plain_backward_matches_pallas_patch_embed_bwd(pallas_interpret):
    """K16a's plain version (the backward of `fused_patch_embed` on the CPU)
    against `_pallas_patch_embed_bwd` in interpret mode: the six gradients
    within 1e-4 relative."""
    from ct_clip_tpu.ops.pallas.patchify import _pallas_patch_embed_bwd, _use_pallas
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed

    video, w, do = _embed_inputs(40)
    assert _use_pallas(PT, P, VIDEO[2] // P, VIDEO[3] // P, 1)
    ref = _pallas_patch_embed_bwd(_f(video), *_jax_weights(w), _f(do), PT, P, 1e-5,
                                  jnp.float32)
    leaves = _port_weights(w, grad=True)
    out = fused_patch_embed(_t(video), *leaves, PT, P)
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, r in zip(("ds1", "db1", "dw", "dpb", "ds2", "db2"), got,
                          _as_port_layout(ref)):
        _close(g, r, 1e-4, name)


def k16a_emulated(video, s1, b1, w, pb, s2, do, tile: int, eps: float = 1e-5):
    """K16a's gradients as csrc/ffn_tc.cu reorganises them (f32, so no
    rounding point applies): the patch LN recomputed with each row's mean
    and rstd, yb = xn W^T + b, the LN(dim) backward, dW = dyb^T xn, and
    ds1 / db1 never from a stored dxn but as per-`tile`-row partial column
    sums of (dyb W) xhat and of dyb W, xhat = (x - mean) rstd rebuilt from
    the volume with those stats, added in two levels in a fixed order as
    `kernels.ln_sums_tc` adds them (`kernels.ln_sums_plan`'s grouping).
    Returns (ds1, db1, dw, dpb, ds2, db2)."""
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.patch_embed import patchify

    x = patchify(video, PT, P).reshape(-1, PT * P * P)
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (x - mean) * rstd * s1 + b1
    yb = xn @ w.t() + pb
    m2 = yb.mean(-1, keepdim=True)
    r2 = torch.rsqrt(((yb - m2) ** 2).mean(-1, keepdim=True) + eps)
    xhat2, dyn = (yb - m2) * r2, do.reshape(-1, yb.shape[1])
    dxhat2 = dyn * s2
    dyb = r2 * (dxhat2 - dxhat2.mean(-1, keepdim=True)
                - xhat2 * (dxhat2 * xhat2).mean(-1, keepdim=True))
    rows, n = x.shape
    tiles = -(-rows // tile)
    padded = -(-tiles // K.LN_SUMS_GROUPS) * K.LN_SUMS_GROUPS
    part = torch.zeros((padded, 2 * n))
    for t in range(tiles):  # the epilogue: the tile's dxn, never stored whole
        r = slice(t * tile, (t + 1) * tile)
        dxn = dyb[r] @ w
        xhat = (x[r] - mean[r]) * rstd[r]
        part[t] = torch.cat([(dxn * xhat).sum(0), dxn.sum(0)])
    sums = part.view(K.LN_SUMS_GROUPS, -1).sum(0).view(-1, 2 * n).sum(0)
    return (sums[:n], sums[n:], dyb.t() @ xn, dyb.sum(0), (dyn * xhat2).sum(0), dyn.sum(0))


@pytest.mark.parametrize("tile", [128, 16])
def test_k16a_reorganised_sums_match_pallas_patch_embed_bwd(pallas_interpret, tile):
    """The arithmetic of K16a on ffn_tc.cu (`k16a_emulated`: ds1 and db1 from
    per-tile partials of (dyb W) xhat in the NN product's epilogue, xhat from
    the recompute's stats) against `_pallas_patch_embed_bwd` in interpret
    mode: the six gradients within 1e-4 relative; at the kernel's 128-row
    tiles and at 16-row ones (8 tiles a batch here)."""
    from ct_clip_tpu.ops.pallas.patchify import _pallas_patch_embed_bwd

    video, w, do = _embed_inputs(40)
    ref = _pallas_patch_embed_bwd(_f(video), *_jax_weights(w), _f(do), PT, P, 1e-5,
                                  jnp.float32)
    s1, b1, wi, pb, s2, _ = _port_weights(w)
    got = k16a_emulated(_t(video), s1, b1, wi, pb, s2, _t(do), tile)
    for name, g, r in zip(("ds1", "db1", "dw", "dpb", "ds2", "db2"), got,
                          _as_port_layout(ref)):
        _close(g, r, 1e-4, name)


def test_k16b_plain_backward_matches_pallas_row_embed_bwd(pallas_interpret):
    """K16b's plain version (the backward of `fused_row_embed` on the CPU)
    against `_pallas_row_embed_bwd` in interpret mode: d(rows) and the six
    gradients within 1e-4 relative."""
    from ct_clip_tpu.ops.pallas.patchify import _pallas_row_embed_bwd, _use_pallas_rows
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed, rearrange_plain

    video, w, do = _embed_inputs(41)
    rows = rearrange_plain(_t(video), PT, P).numpy()
    assert _use_pallas_rows(rows.shape[1], rows.shape[2], DIM_E)
    drows, *ref = _pallas_row_embed_bwd(_f(rows), *_jax_weights(w), _f(do), 1e-5,
                                        jnp.float32)
    leaves = [_t(rows, grad=True)] + _port_weights(w, grad=True)
    got = torch.autograd.grad(fused_row_embed(*leaves), leaves, _t(do))
    for name, g, r in zip(("drows", "ds1", "db1", "dw", "dpb", "ds2", "db2"), got,
                          (np.asarray(drows),) + _as_port_layout(ref)):
        _close(g, r, 1e-4, name)


def test_k17_matches_pallas_unrearrange_and_inverts_k6(pallas_interpret):
    """K17's plain version (`unrearrange_patches` on the CPU, and the
    backward of `rearrange_patches`) against `_pallas_unrearrange` in
    interpret mode: equal, a pure move; and the inverse of K6."""
    from ct_clip_tpu.ops.pallas.patchify import _pallas_unrearrange
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches, unrearrange_patches

    video, _, _ = _embed_inputs(42)
    rows = np.random.RandomState(43).randn(VIDEO[0], 64, PT * P * P)
    ref = np.asarray(_pallas_unrearrange(_f(rows), PT, P, *VIDEO[1:]))
    got = unrearrange_patches(_t(rows), PT, P, *VIDEO[1:])
    np.testing.assert_array_equal(got.numpy(), ref)
    v = _t(video, grad=True)
    dv, = torch.autograd.grad(rearrange_patches(v, PT, P), v, _t(rows))
    np.testing.assert_array_equal(dv.numpy(), ref)
    np.testing.assert_array_equal(
        unrearrange_patches(rearrange_patches(_t(video), PT, P), PT, P, *VIDEO[1:]).numpy(),
        video.astype(np.float32))


def test_embed_dvolume_matches_jax_vjp_of_xla_patch_embed():
    """d(volume) and the weight gradients of `fused_patch_embed` against
    jax.vjp of `_xla_patch_embed`, the composition `_pe_bwd` takes d(video)
    from (rearrange_patches' VJP is K17): within 1e-4 relative."""
    from ct_clip_tpu.ops.pallas.patchify import _xla_patch_embed
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed

    video, w, do = _embed_inputs(44)
    _, vjp = jax.vjp(lambda *a: _xla_patch_embed(*a, PT, P, 1e-5, jnp.float32),
                     _f(video), *_jax_weights(w))
    dvideo, *ref = vjp(_f(do))
    leaves = [_t(video, grad=True)] + _port_weights(w, grad=True)
    got = torch.autograd.grad(fused_patch_embed(*leaves, PT, P), leaves, _t(do))
    for name, g, r in zip(("dvideo", "ds1", "db1", "dw", "dpb", "ds2", "db2"), got,
                          (np.asarray(dvideo),) + _as_port_layout(ref)):
        _close(g, r, 1e-4, name)


@pytest.mark.parametrize("input_grad", [False, True], ids=["weights", "weights+input"])
@pytest.mark.parametrize("route", ["volume", "rows"])
def test_embed_functions_pass_gradients_to_all_weights(route, input_grad):
    """The embeds' autograd Functions give each of the six weights its
    gradient, and the input one exactly when it requires grad: equal to
    autograd of the plain composition.  Through the model too:
    `CTViT.embed_patches(train=False)` under grad reaches to_patch_emb."""
    from ct_clip_tpu_torch.ops.patch_embed import (fused_patch_embed, fused_row_embed,
                                                   patch_embed_plain, rearrange_plain,
                                                   row_embed_plain)

    video, w, do = _embed_inputs(45)
    x = _t(video) if route == "volume" else rearrange_plain(_t(video), PT, P)
    fused = ((lambda x_, *a: fused_patch_embed(x_, *a, PT, P)) if route == "volume"
             else fused_row_embed)
    plain = ((lambda x_, *a: patch_embed_plain(x_, *a, PT, P)) if route == "volume"
             else row_embed_plain)
    grads = []
    for fn in (fused, plain):
        xi = x.clone().requires_grad_(input_grad)
        leaves = _port_weights(w, grad=True)
        (fn(xi, *leaves) * _t(do)).sum().backward()
        grads.append([xi.grad] + [t.grad for t in leaves])
    assert (grads[0][0] is not None) == input_grad
    for name, g, r in zip(("input", "s1", "b1", "w", "pbias", "s2", "b2"), *grads):
        if r is None:
            continue
        assert g is not None and g.abs().max() > 0, name
        _close(g, r, 1e-5, name)


def test_ctvit_inference_embed_under_grad_reaches_the_patch_weights():
    """Fault 1 at the model level: the inference embed (K8 / K4 route) under
    grad gives to_patch_emb's six parameters the training embed's gradients."""
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_plain

    cfg = CTViTConfig(dim=DIM, codebook_size=64, image_size=IMAGE, patch_size=PATCH,
                      temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=1,
                      temporal_depth=1, dim_head=DIM_HEAD, heads=HEADS)
    vt = CTViT(cfg)
    with torch.no_grad():
        for prm in vt.to_patch_emb.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(3)))
    rng = np.random.RandomState(46)
    video = _t(rng.uniform(-1, 1, (2, FRAMES, IMAGE, IMAGE, 1)))
    g = _t(rng.randn(2, 3, 3, 3, DIM))
    for x in (video, rearrange_plain(video[..., 0], TPATCH, PATCH)):
        grads = []
        for train in (False, True):
            vt.zero_grad()
            (vt.embed_patches(x, train=train) * g).sum().backward()
            grads.append([prm.grad.clone() for prm in vt.to_patch_emb.parameters()])
        for a, r in zip(*grads):
            _close(a, r, 1e-5, "to_patch_emb")


# -------------------------------------------------------------- visual SSL
def _draws_of(key):
    """The (4,) draws `augment_volume(key, .)` makes (visual_ssl.py:49-57)."""
    r1, r2, r3, r4 = jax.random.split(key, 4)
    return np.array([float(jax.random.bernoulli(r1)), float(jax.random.bernoulli(r2)),
                     float(jax.random.uniform(r3, (), minval=-1.0, maxval=1.0)),
                     float(jax.random.uniform(r4, (), minval=-1.0, maxval=1.0))], np.float32)


def test_augment_volume_matches_jax_with_handed_draws():
    """Keys chosen so that each flip combination occurs: the views equal the
    JAX package's (f32 arithmetic on both sides)."""
    from ct_clip_tpu.models.visual_ssl import augment_volume as jaug
    from ct_clip_tpu_torch.models.visual_ssl import augment_volume

    video = np.random.RandomState(47).uniform(-1, 1, (2, 4, 6, 5, 1)).astype(np.float32)
    seen = set()
    for i in range(64):
        key = jax.random.PRNGKey(i)
        d = _draws_of(key)
        flips = tuple(d[:2])
        if flips in seen:
            continue
        seen.add(flips)
        got = augment_volume(_t(video), torch.from_numpy(d))
        _close(got, jaug(key, jnp.asarray(video)), 1e-6, f"flips {flips}")
    assert len(seen) == 4


def _head_tree(rng, dim, proj, hidden, predictor):
    """A JAX SimSiamMLP (projector) or MLP (predictor) tree with moved BN
    affines and biases."""
    def dense(i, o, bias):
        d = {"kernel": rng.randn(i, o).astype(np.float32) / np.sqrt(i)}
        if bias:
            d["bias"] = 0.1 * rng.randn(o).astype(np.float32)
        return d

    def bn(n):
        return {"scale": (rng.rand(n) + 0.5).astype(np.float32),
                "bias": 0.1 * rng.randn(n).astype(np.float32)}
    if predictor:
        return {"fc0": dense(dim, hidden, True), "bn0": bn(hidden),
                "out": dense(hidden, proj, True)}
    return {"fc0": dense(dim, hidden, False), "bn0": bn(hidden),
            "fc1": dense(hidden, hidden, False), "bn1": bn(hidden),
            "out": dense(hidden, proj, False)}


@pytest.mark.parametrize("head", ["projector", "predictor"])
def test_ssl_heads_match_jax(head):
    """SimSiamMLP (projector, closing affine-free BatchNorm) and MLP
    (predictor), carried across by the converter's head mapping: outputs,
    input gradients and parameter gradients within 1e-4 relative.  The
    predictor's first bias meets a BatchNorm: zero true gradient."""
    from ct_clip_tpu.models.visual_ssl import MLP as JMLP, SimSiamMLP as JSimSiamMLP
    from ct_clip_tpu_torch.convert.from_jax import _ssl_heads
    from ct_clip_tpu_torch.models.visual_ssl import SimSiam

    rng = np.random.RandomState(48)
    dim, proj, hidden, rows = 24, 16, 48, 10
    predictor = head == "predictor"
    tree = _head_tree(rng, proj if predictor else dim, proj, hidden, predictor)
    x = rng.randn(rows, proj if predictor else dim).astype(np.float32)
    g = rng.randn(rows, proj).astype(np.float32)
    jm = (JMLP if predictor else JSimSiamMLP)(projection_size=proj, hidden=hidden)

    def jloss(params, x_):
        return jnp.sum(jm.apply({"params": params}, x_) * g)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jout = jm.apply({"params": params}, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    sd = {}
    _ssl_heads(sd, {"predictor" if predictor else "projector": tree})
    module = SimSiam(dim, proj, hidden)
    mod = module.online_predictor if predictor else module.net.projector
    prefix = "visual_ssl.online_predictor." if predictor else "visual_ssl.net.projector."
    mod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    xt = _t(x, grad=True)
    out = mod(xt)
    _close(out, jout, 1e-4, "output")
    (out * _t(g)).sum().backward()
    _close(xt.grad, jgx, 1e-4, "dx")
    gsd = {}
    _ssl_heads(gsd, {"predictor" if predictor else "projector":
                     jax.tree_util.tree_map(np.asarray, jgp)})
    top = max(np.abs(v.numpy()).max() for v in gsd.values())
    for name, prm in mod.named_parameters():
        want = gsd[prefix + name]
        if predictor and name == "0.bias":
            assert prm.grad.abs().max() <= 1e-6 * top and want.abs().max() <= 1e-6 * top
            continue
        _close(prm.grad, want.numpy(), 1e-4, name)


@pytest.mark.parametrize("loss", ["simsiam", "nt_xent"])
def test_ssl_losses_match_jax(loss):
    """simsiam_loss (stop-gradient targets) and nt_xent_loss: the value
    within 1e-5 and the inputs' gradients within 1e-4 relative."""
    from ct_clip_tpu.models import visual_ssl as J
    from ct_clip_tpu_torch.models import visual_ssl as Pt

    rng = np.random.RandomState(49)
    args = [rng.randn(6, 16).astype(np.float32) for _ in range(4 if loss == "simsiam" else 2)]
    jfn = J.simsiam_loss if loss == "simsiam" else J.nt_xent_loss
    pfn = Pt.simsiam_loss if loss == "simsiam" else Pt.nt_xent_loss
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [_t(a, grad=True) for a in args]
    val = pfn(*leaves)
    assert abs(val.item() - float(jval)) <= 1e-5 * abs(float(jval))
    got = torch.autograd.grad(val, leaves, allow_unused=True)
    for i, (g, r) in enumerate(zip(got, jgrads)):
        r = np.asarray(r)
        if not np.abs(r).max():  # a stop-gradient target
            assert g is None or not g.abs().max()
            continue
        _close(g, r, 1e-4, f"input {i}")


@pytest.mark.parametrize("kind", ["plain", "dcl", "extra", "multiview"])
def test_filip_loss_matches_jax(kind):
    """filip_loss with DCL, CLOOB extra tokens and a 2 x 2 multiview batch:
    the losses within 1e-5 and the token gradients within 1e-4 relative."""
    from ct_clip_tpu.models.ctclip import filip_loss as jfilip
    from ct_clip_tpu_torch.models.ctclip import filip_loss

    rng = np.random.RandomState(50)
    m = n = 2 if kind == "multiview" else 1
    b, Lt, I, d = 3, 7, 9, 8

    def tok(k, length):
        a = rng.randn(k, b, length, d).astype(np.float32)
        return a / np.linalg.norm(a, axis=-1, keepdims=True)
    lengths = rng.randint(2, Lt + 1, (m, b))
    mask = (np.arange(Lt)[None, None] < lengths[..., None]).astype(np.int32)
    args = [tok(m, Lt), tok(n, I)]
    if kind == "extra":
        args += [tok(m, Lt), tok(n, I)]
    kw = dict(decoupled=kind == "dcl")

    def jloss(*a):
        cl, mv = jfilip(a[0], a[1], jnp.asarray(mask), jnp.float32(2.5),
                        extra_tokens=tuple(a[2:]) or None, **kw)
        return cl + 0.3 * jnp.sum(mv), (cl, mv)
    (_, (jcl, jmv)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(args))),
                                                 has_aux=True)(*map(jnp.asarray, args))
    leaves = [_t(a, grad=True) for a in args]
    cl, mv = filip_loss(leaves[0], leaves[1], torch.from_numpy(mask), torch.tensor(2.5),
                        extra_tokens=tuple(leaves[2:]) or None, **kw)
    assert abs(cl.item() - float(jcl)) <= 1e-5 * abs(float(jcl))
    np.testing.assert_allclose(mv.detach().numpy(), np.asarray(jmv), rtol=1e-5)
    got = torch.autograd.grad(cl + 0.3 * mv.sum(), leaves)
    for i, (g, r) in enumerate(zip(got, jgrads)):
        _close(g, r, 1e-4, f"input {i}")


# -------------------------------------------------------------------- MLM
def _mlm_draws_of(key, b, n):
    """The (2, b, n) uniforms the JAX MLM draws from its key (mlm.py:55-60):
    the candidate scores and the replacement draws (bernoulli(0.9) is
    uniform < 0.9)."""
    rng_pos, rng_rep = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(rng_pos, (b, n))),
                     np.asarray(jax.random.uniform(rng_rep, (b, n)))])


def test_mlm_matches_jax_with_handed_draws():
    """MLM on a fixed embedding-table encoder: the mask (ceil(0.15 valid)
    per row, pads never chosen), the loss within 1e-5 and the gradients of
    to_logits and the table within 1e-4 relative."""
    from ct_clip_tpu.models.mlm import MLM as JMLM, subset_mask_with_prob as jsubset
    from ct_clip_tpu_torch.models.mlm import MLM, subset_mask_with_prob

    rng = np.random.RandomState(51)
    b, n, dim, vocab = 5, 24, 12, 30
    lengths = np.array([24, 20, 7, 1, 13])
    amask = (np.arange(n)[None] < lengths[:, None]).astype(np.int32)
    seq = np.where(amask > 0, rng.randint(5, vocab, (b, n)), 0).astype(np.int32)
    table = rng.randn(vocab, dim).astype(np.float32)
    kernel = (rng.randn(dim, vocab) / np.sqrt(dim)).astype(np.float32)
    bias = 0.1 * rng.randn(vocab).astype(np.float32)
    key = jax.random.PRNGKey(52)
    draws = _mlm_draws_of(key, b, n)

    valid = (seq != 0) & (amask > 0)
    want_mask = np.asarray(jsubset(jax.random.split(key)[0], jnp.asarray(valid), 0.15))
    got_mask = subset_mask_with_prob(torch.from_numpy(valid), 0.15, torch.from_numpy(draws[0]))
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(want_mask.sum(-1), np.ceil(0.15 * lengths.astype(np.float32)))

    def jloss(params, tbl):
        mlm = JMLM(encode_fn=lambda s, m: tbl[s] * m[..., None], dim=dim, num_tokens=vocab)
        return mlm.apply({"params": params}, jnp.asarray(seq), jnp.asarray(amask), rng=key)
    params = {"to_logits": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    jval, (jgp, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(table))
    mlm = MLM(dim, vocab)
    with torch.no_grad():
        mlm.to_logits.weight.copy_(_t(kernel.T))
        mlm.to_logits.bias.copy_(_t(bias))
    tbl = _t(table, grad=True)
    val = mlm(torch.from_numpy(seq).long(), torch.from_numpy(amask).long(),
              lambda s, m: tbl[s] * m[..., None], torch.from_numpy(draws))
    assert abs(val.item() - float(jval)) <= 1e-5 * abs(float(jval))
    val.backward()
    _close(tbl.grad, jgt, 1e-4, "table")
    _close(mlm.to_logits.weight.grad, np.asarray(jgp["to_logits"]["kernel"]).T, 1e-4, "kernel")
    _close(mlm.to_logits.bias.grad, jgp["to_logits"]["bias"], 1e-4, "bias")


# ------------------------------------------- the whole tiny CT-CLIP objective
SSL_HIDDEN = 256
CODES = 128  # >= the batch's 4 x 27 tokens: each token gets a code of its own


def _is_zero_grad(name):
    """Parameters whose true gradient is zero: softmax shift invariance (the
    BERT key bias, the CPB MLP's output bias) and a bias a BatchNorm cancels
    (the SimSiam predictor's first)."""
    return name.endswith(("attention.self.key.bias", "spatial_rel_pos_bias.net.2.bias",
                          "visual_ssl.online_predictor.0.bias"))


def _configs(tap, ssl_type):
    import ct_clip_tpu as J
    import ct_clip_tpu_torch as P

    vit = dict(dim=DIM, codebook_size=CODES, image_size=IMAGE, patch_size=PATCH,
               temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=1,
               temporal_depth=1, dim_head=DIM_HEAD, heads=HEADS)
    bert = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=512, hidden_dropout=0.0, attention_dropout=0.0)
    top = dict(dim_text=32, dim_image=DIM, dim_latent=24, use_all_token_embeds=True,
               use_mlm=True, use_visual_ssl=True, visual_ssl_type=ssl_type,
               visual_ssl_tap=tap)
    return (J.CTCLIPConfig(**top, ctvit=J.CTViTConfig(**vit), bert=J.BertConfig(**bert)),
            P.CTCLIPConfig(**top, ctvit=P.CTViTConfig(**vit), bert=P.BertConfig(**bert)))


def _batch(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, L, B)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(5, VOCAB, (B, L)), 0).astype(np.int32)
    ids[:, 0] = 2
    video = rng.uniform(-1, 1, (B, FRAMES, IMAGE, IMAGE, 1)).astype(np.float32)
    return dict(input_ids=ids, attention_mask=mask, video=video)


def _narrow_ssl_heads(monkeypatch):
    """Both packages' SSL heads at hidden width SSL_HIDDEN instead of 4096:
    at 4096 the f32 gradients of SimSiam's heads at this tiny batch carry
    rounding noise of ~5% of their largest entry (the port's f32 against its
    own f64, tests' random rows), which no f32 comparison can resolve."""
    import functools

    from ct_clip_tpu.models import visual_ssl as J
    from ct_clip_tpu_torch.models import ctclip as P

    for name in ("SimSiam", "SimCLR"):
        cls = getattr(J, name)
        narrow = type(name, (cls,), {"__annotations__": {"projection_hidden": int},
                                     "projection_hidden": SSL_HIDDEN})
        monkeypatch.setattr(J, name, narrow)
    monkeypatch.setattr(P, "SSL_TYPES", {
        k: functools.partial(v, projection_hidden=SSL_HIDDEN) for k, v in P.SSL_TYPES.items()})


def _jax_variables(jmodel, jb, keys):
    """Variables of the JAX model from a numpy seed (no init compile): unit
    scales and zero biases moved by 0.2 N(0, 1), fan-in normal matrices,
    and a codebook whose first codes are the batch's own training tokens,
    so every token has a code of its own (FILIP's max over image tokens then
    sees no exactly tied tokens, whose gradient split differs between the
    frameworks)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), **keys}, jb["input_ids"], jb["attention_mask"],
        jb["video"], return_loss=True))
    rng = np.random.RandomState(61)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) <= 1:
            base = 1.0 if any(k in name for k in ("scale", "gamma", "temperature")) else 0.0
            return np.asarray(base + 0.2 * rng.randn(*s.shape), np.float32)
        return np.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])), np.float32)
    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    vq = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["vq"])
    node = vq["visual_transformer"]["vq"]
    tokens = np.asarray(jmodel.apply(
        {"params": params, "vq": vq}, jb["video"],
        method=lambda m, v: m.visual_transformer.encode(
            m.visual_transformer.embed_patches(v, train=True)))).reshape(-1, DIM)
    embed = rng.randn(CODES, DIM)
    embed[: len(tokens)] = tokens
    node["embed"] = (embed / np.linalg.norm(embed, axis=-1, keepdims=True)).astype(
        np.float32).reshape(node["embed"].shape)
    node["cluster_size"] = np.asarray(rng.rand(*node["cluster_size"].shape), np.float32)
    return {"params": params, "vq": vq}


@pytest.mark.parametrize("tap,ssl_type", [("temporal", "simsiam"), ("spatial", "simsiam"),
                                          ("pooled", "simclr")])
def test_ctclip_with_mlm_ssl_and_filip_matches_jax_value_and_grad(tap, ssl_type,
                                                                   monkeypatch):
    """The training loss (train=True) with MLM, visual SSL on `tap` and FILIP
    on, its gradient for every parameter and the VQ's EMA state, against
    jax.value_and_grad of the JAX model from the same weights and draws.
    JAX runs eagerly: its per-operation compiles are shared by the three
    cases, where a jit would compile each whole graph anew."""
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu_torch.convert import state_dict_from_jax
    from ct_clip_tpu_torch.models import CTCLIP

    _narrow_ssl_heads(monkeypatch)
    jcfg, pcfg = _configs(tap, ssl_type)
    jmodel = JCTCLIP(jcfg, dtype=jnp.float32)
    batch = _batch(60)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = {"dropout": jax.random.PRNGKey(1), "mlm": jax.random.PRNGKey(2),
            "ssl": jax.random.PRNGKey(3)}
    variables = _jax_variables(jmodel, jb, keys)

    def loss_fn(params, vq):
        return jmodel.apply({"params": params, "vq": vq}, jb["input_ids"],
                            jb["attention_mask"], jb["video"], return_loss=True, train=True,
                            deterministic=False, rngs=keys, mutable=["vq"])

    (loss, new_vars), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["vq"])
    # the root scope's first make_rng of each stream, as _weighted_total draws them
    mlm_key, ssl_key = jmodel.apply(variables, method=lambda mod: (mod.make_rng("mlm"),
                                                                  mod.make_rng("ssl")),
                                    rngs=keys)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    model = CTCLIP(pcfg)
    model.load_state_dict(state_dict_from_jax(variables, pcfg), strict=True)
    model.train()
    ssl_draws = np.stack([_draws_of(k) for k in jax.random.split(ssl_key)])
    got = model(torch.from_numpy(batch["input_ids"]).long(),
                torch.from_numpy(batch["attention_mask"]).long(),
                torch.from_numpy(batch["video"]), return_loss=True, train=True,
                mlm_draws=torch.from_numpy(_mlm_draws_of(mlm_key, B, L)),
                ssl_draws=torch.from_numpy(ssl_draws))
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss)), (got.item(), float(loss))
    got.backward()
    want = state_dict_from_jax({"params": to_np(grads), "vq": to_np(new_vars["vq"])}, pcfg)
    named = [(n, p) for n, p in model.named_parameters() if p.numel()]
    top = max(want[n].abs().max().item() for n, _ in named)
    for name, p in named:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if _is_zero_grad(name):
            assert g.abs().max().item() <= 1e-6 * top, name
            assert want[name].abs().max().item() <= 1e-6 * top, name
            continue
        _close(g, want[name].numpy(), 1e-4, name)
    for key in ("embed", "cluster_size"):  # the main CLIP branch's EMA only
        name = f"visual_transformer.vq._codebook.{key}"
        _close(model.state_dict()[name], want[name].numpy(), 1e-5, name)
    assert model.visual_ssl.net.projector[0].weight.grad.abs().max() > 0
    assert model.mlm.to_logits.weight.grad.abs().max() > 0


def test_trainer_with_mlm_and_visual_ssl_on_cpu(tmp_path):
    """`CTClipTrainer` with MLM and visual SSL on (dropout 0.1 in the text
    tower): it ingests volumes, runs two steps with finite losses, the mini
    evaluation and a checkpoint holding the heads; the step's draws come
    from `step_generators`, so a second trainer from the same weights and
    seed logs the same losses."""
    from test_torch_port_train import _write_corpus

    import ct_clip_tpu_torch as P
    from ct_clip_tpu_torch.data import (CTReportDataset, CTReportDatasetInfer,
                                        WordPieceTokenizer)
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CTClipTrainer

    _write_corpus(tmp_path)
    _, pcfg = _configs("temporal", "simsiam")
    pcfg = pcfg.replace(use_all_token_embeds=False, dim_image=9 * DIM,
                        bert=pcfg.bert.replace(hidden_dropout=0.1, attention_dropout=0.1))
    start = CTCLIP(pcfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    losses = []
    for run in range(2):
        model = CTCLIP(pcfg)
        model.load_state_dict(start)
        trainer = CTClipTrainer(
            model, WordPieceTokenizer(str(tmp_path / "vocab.txt")),
            train_dataset=CTReportDataset(str(tmp_path / "train"),
                                          str(tmp_path / "reports_train.csv"),
                                          str(tmp_path / "meta_train.csv")),
            valid_dataset=CTReportDatasetInfer(str(tmp_path / "valid"),
                                               str(tmp_path / "reports_valid.csv"),
                                               str(tmp_path / "meta_valid.csv"),
                                               str(tmp_path / "labels.csv")),
            config=P.TrainConfig(batch_size=2, lr=1e-3, save_results_every=2,
                                 save_model_every=2),
            results_folder=str(tmp_path / f"results{run}"), num_workers=2)
        assert not trainer.patch_rows
        trainer.train(2)
        out = tmp_path / f"results{run}"
        recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        losses.append([r["loss"] for r in recs if "loss" in r])
        assert len(losses[-1]) == 2 and np.isfinite(losses[-1]).all()
        assert (out / "mini_eval_step2.csv").exists()
    assert losses[0] == losses[1]
    saved = torch.load(out / "checkpoints" / "step_2.pt", map_location="cpu")
    keys = set(saved["model"])
    assert "mlm.to_logits.weight" in keys and "visual_ssl.online_predictor.3.bias" in keys
