"""The f32 CTViT training kernels (K9, K10 grid and seq, K5 exact and K15 on
f32 rows) and two tiny f32 training steps, the port against the JAX package,
on the CPU.

The TPU kernels run f32 operands in true f32 ("highest",
spatial_attention.py:323, small_attention.py:487; the bf16 roundings of qn,
kn, P and dS in their bodies are no-ops in f32), K5 exact on f32 rows in
three bf16 passes (vq.py:83-95) and K15 on f32 rows as bf16 hi + lo parts
(vq.py:132-165).  The port's f32 forms of them run on the card only; here
each Pallas kernel runs in interpret mode, at shapes its `_plan` accepts,
against the plain version its CUDA form is checked against on the card, on
the same numpy-seeded inputs.

The two steps (a tiny f32 CT-CLIP contrastive loss in training mode and a
tiny f32 autoencoder generator loss) run JAX eagerly, in interpret mode: at
their shapes the JAX package's VQ takes `pallas_assign(exact=True)` and
`pallas_cluster_stats` on f32 rows, as on the TPU, while the port on the CPU
takes its full-f32 plain versions, as JAX's XLA forms.  The codebook holds
the batch's own tokens, so every id is a clear top-1 on both sides.

Tolerances, relative to the largest entry of the JAX result: dx 1e-5, the
parameter gradients (sums over all sequences) 1e-4; K5's ids equal up to
ties of the kernel's own math within 1e-5; K15's bins equal and sums within
1e-6 in all but 1% of the entries, those within one bf16 ulp of each
row's lo part (XLA sums a row's squares in another order; the full-f32 sums
must miss this); the steps' losses 1e-5,
gradients 1e-4 and VQ state 1e-5.  The CPB MLPs' output biases and BERT's key bias have a zero true gradient (softmax
shift invariance): both sides hold rounding noise there, held to 1e-6 of the
largest gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

DX, WGRAD = 1e-5, 1e-4
ZERO_GRAD = ("rel_pos_bias.net.2.bias", "attention.self.key.bias")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _f(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, ref, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-12, \
        f"max abs err {err:.3e} of max {np.abs(ref).max():.3e}"


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


# ------------------------------------------------------------ K9 and K10
def _attn_inputs(seed, shape, dim, heads, dh):
    rng = np.random.RandomState(seed)
    hd = heads * dh
    w = dict(gamma=1 + 0.1 * rng.randn(dim), wq=rng.randn(dim, hd) / np.sqrt(dim),
             wkv=rng.randn(dim, 2 * hd) / np.sqrt(dim), q_scale=1 + 0.3 * rng.rand(dh),
             k_scale=1 + 0.3 * rng.rand(dh), wout=rng.randn(hd, dim) / np.sqrt(hd))
    return rng, rng.randn(*shape), w, rng.randn(*shape)


def _jax_w(w):
    return tuple(_f(w[k]) for k in ("gamma", "wq", "wkv", "q_scale", "k_scale", "wout"))


def _port_w(w):
    """JAX (in, out) kernels -> nn.Linear (out, in) weights."""
    return (_t(w["gamma"]), _t(w["wq"].T), _t(w["wkv"].T), _t(w["q_scale"]),
            _t(w["k_scale"]), _t(w["wout"].T))


def _bwd_close(got, ref):
    """(dx, dgamma, dwq, dwkv, dq_scale, dk_scale, dwout[, dbias]): dx to DX,
    the rest to WGRAD; the JAX (in, out) weight gradients transposed."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        _close(g, r.T if i in (2, 3, 6) else r, DX if i == 0 else WGRAD)


def test_k9_f32_backward_matches_pallas_spatial_bwd():
    """K9 f32 at (2, 128, 128), 2 heads of 64, with the (heads, n, n) bias
    whose gradient sums over the planes."""
    from ct_clip_tpu.ops.pallas.spatial_attention import _pallas_spatial_bwd, _plan
    from ct_clip_tpu_torch.ops.qknorm_attention import qknorm_attention_bwd_plain

    b, n, dim, heads, dh = 2, 128, 128, 2, 64
    rng, x, w, do = _attn_inputs(21, (b, n, dim), dim, heads, dh)
    bias = rng.randn(heads, n, n)
    assert _plan(b, n, dim, heads, dh)
    ref = _pallas_spatial_bwd(_f(x), *_jax_w(w), _f(bias), _f(do), heads=heads, dim_head=dh,
                              scale=8.0, dtype=jnp.float32, residual=True)
    got = qknorm_attention_bwd_plain(_t(x), *_port_w(w), _t(bias), _t(do), heads, dh)
    _bwd_close(got, ref)


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "seq"])
def test_k10_f32_backward_matches_pallas_small_qknorm_bwd(grid):
    """K10 f32 in grid form on a (2, 8, 16, 128) token grid (attending along
    t = 8) and in sequence-major form on (16, 24, 128) sequences."""
    from ct_clip_tpu.ops.pallas.small_attention import (_pallas_small_qknorm_bwd, _plan_bwd,
                                                        _plan_grid_bwd)
    from ct_clip_tpu_torch.ops.qknorm_attention import (grid_qknorm_attention_bwd_plain,
                                                        qknorm_attention_bwd_plain)

    heads, dh, dim = 2, 64, 128
    shape = (2, 8, 16, dim) if grid else (16, 24, dim)
    _, x, w, do = _attn_inputs(22 + grid, shape, dim, heads, dh)
    g = _plan_grid_bwd(*shape[:3], dim, heads, dh) if grid else _plan_bwd(*shape[:2], dim,
                                                                          heads, dh)
    assert g is not None
    ref = _pallas_small_qknorm_bwd(_f(x), *_jax_w(w), _f(do), g, heads=heads, dim_head=dh,
                                   scale=8.0, dtype=jnp.float32, residual=True,
                                   grid_layout=grid)
    if grid:
        got = grid_qknorm_attention_bwd_plain(_t(x), *_port_w(w), _t(do), heads, dh)
    else:
        got = qknorm_attention_bwd_plain(_t(x), *_port_w(w), None, _t(do), heads, dh)[:7]
    _bwd_close(got, ref)


# ------------------------------------------------------ K5 exact and K15
def _vq_inputs(seed, n=512, dim=128, k=256):
    from ct_clip_tpu.ops.norms import l2norm as jl2norm

    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32) * 3.0
    return x, np.asarray(jl2norm(_f(rng.randn(k, dim))))


def test_k5_exact_f32_rows_match_pallas_assign():
    """`pallas_assign(exact=True)` on f32 rows against the plain version of
    its math (rows normalised in f32, split into bf16 hi + lo, three bf16
    products): ids equal but where two codes tie within 1e-5 of that math."""
    from ct_clip_tpu.ops.pallas.vq import _plan, pallas_assign
    from ct_clip_tpu_torch.ops.vq import vq_assign_exact_rows_plain, vq_assign_exact_rows_sim

    x, embed_n = _vq_inputs(23)
    m = _plan(x.shape[0], x.shape[1], embed_n.shape[0])
    assert m is not None
    ref = np.asarray(pallas_assign(_f(x), _f(embed_n), m, exact=True))
    got = vq_assign_exact_rows_plain(_t(x), _t(embed_n)).numpy()
    sim = vq_assign_exact_rows_sim(_t(x), _t(embed_n)).numpy()
    rows = np.arange(len(x))
    gap = np.abs(sim[rows, got] - sim[rows, ref])
    assert (got == ref).mean() >= 0.99
    assert (gap <= 1e-5 * np.abs(sim).max(axis=1)).all()


def test_k15_f32_rows_match_pallas_cluster_stats():
    """`pallas_cluster_stats` on f32 rows against the plain version of its
    math (each normalised row as its bf16 hi + lo parts): bins equal, sums
    within 1e-6 of max but in at most 1% of the entries, and those within
    one bf16 ulp of each row's lo part (2^-16 |xn|).  The plain version sums
    each row's squares in the CUDA form's order, XLA in its own: a norm one
    f32 ulp apart moves the lo part's rounding that far, here in 0.27% of
    the entries (the full-f32 sums: 3.5%).  The full-f32 sums (JAX's XLA form, within 1e-4) and the
    hi parts alone must miss that check."""
    from ct_clip_tpu.ops.pallas.vq import _plan, pallas_cluster_stats
    from ct_clip_tpu_torch.ops.vq import _split_rows, cluster_stats_plain, cluster_stats_rows_plain

    x, _ = _vq_inputs(24)
    k = 256
    ids = torch.from_numpy(np.random.RandomState(25).randint(0, k // 2, len(x)).astype(np.int32))
    m = _plan(x.shape[0], x.shape[1], k)
    bins, esum = pallas_cluster_stats(_f(x), jnp.asarray(ids.numpy()), k, m)
    got_bins, got_esum = cluster_stats_rows_plain(_t(x), ids, k)
    np.testing.assert_array_equal(got_bins.numpy(), np.asarray(bins))
    esum = np.asarray(esum)
    slack = 2.0 ** -16 * cluster_stats_plain(_t(np.abs(x)), ids, k)[1].numpy()

    def holds(sums):
        diff = np.abs(np.asarray(sums) - esum)
        beyond = diff > 1e-6 * np.abs(esum).max()
        return beyond.mean() <= 1e-2 and (diff <= 1e-6 * np.abs(esum).max() + slack).all()

    assert holds(got_esum.numpy())
    full = cluster_stats_plain(_t(x), ids, k)[1]
    _close(full, esum, 1e-4)
    onehot = (ids[:, None].long() == torch.arange(k)).float()
    assert not holds(full.numpy()) and not holds(onehot.t() @ _split_rows(_t(x))[0])


# ------------------------------------------------------ tiny f32 steps
@pytest.fixture(scope="module")
def eager():
    with jax.disable_jit():
        yield


VIT = dict(dim=128, codebook_size=128, image_size=32, patch_size=8, temporal_patch_size=2,
           spatial_depth=1, temporal_depth=1, dim_head=64, heads=2)


def _seed_codebook(vt, video, rows: int) -> None:
    """Vectors off their init values, then the batch's own normalised
    tokens as the first codes: each id a clear top-1."""
    with torch.no_grad():
        tokens = vt.encode(vt.embed_patches(video, train=True)).reshape(-1, vt.config.dim)
        assert tokens.shape[0] == rows
        embed = vt.vq._codebook.embed
        embed[:rows] = tokens[:rows]
        embed.copy_(embed / embed.norm(dim=-1, keepdim=True))


def _perturb(model, g) -> None:
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))


def _grads_close(model, want, prefix=""):
    params = [(n, p) for n, p in model.named_parameters()
              if p.numel() and prefix + n in want and "_extra" not in n]
    top = max(want[prefix + n].abs().max().item() for n, _ in params)
    for name, p in params:
        grad = torch.zeros_like(p) if p.grad is None else p.grad  # the unused pooler
        if name.endswith(ZERO_GRAD):
            assert grad.abs().max().item() <= 1e-6 * top, name
            continue
        _close(grad, want[prefix + name].numpy(), WGRAD)


def test_tiny_f32_ctclip_step_matches_jax(eager):
    """A tiny f32 CT-CLIP, its (4, 4, 4) token grid cubic (K2 grid / K10
    grid) and its 128 VQ rows of 128 dims against 128 codes within JAX's
    VQ plan: the contrastive loss in training mode, every gradient and the
    VQ's EMA state against jax.value_and_grad of the JAX CTCLIP."""
    import ct_clip_tpu as J
    from ct_clip_tpu.convert.torch_to_jax import ctclip_params_from_torch
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu.ops.pallas.vq import _plan
    from ct_clip_tpu_torch import config as P
    from ct_clip_tpu_torch.convert import state_dict_from_jax
    from ct_clip_tpu_torch.models import CTCLIP

    b, frames, text = 2, 8, 10
    vit = dict(VIT, num_frames=frames)
    bert = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, hidden_dropout=0.0, attention_dropout=0.0)
    top = dict(dim_text=32, dim_image=16 * 128, dim_latent=24)
    jcfg = J.CTCLIPConfig(**top, ctvit=J.CTViTConfig(**vit, vq_exact_sim=True),
                          bert=J.BertConfig(**bert))
    pcfg = P.CTCLIPConfig(**top, ctvit=P.CTViTConfig(**vit), bert=P.BertConfig(**bert))
    assert _plan(b * 64, 128, 128) is not None  # JAX's VQ takes its kernels
    g = torch.Generator().manual_seed(26)
    model = CTCLIP(pcfg).init_weights(g)
    _perturb(model, g)
    rng = np.random.RandomState(26)
    video = rng.uniform(-1, 1, (b, frames, 32, 32, 1)).astype(np.float32)
    mask = (np.arange(text)[None] < np.array([[text], [6]])).astype(np.int64)
    ids = np.where(mask > 0, rng.randint(5, 40, (b, text)), 0)
    _seed_codebook(model.visual_transformer, torch.from_numpy(video), b * 64)
    variables = ctclip_params_from_torch(model.state_dict(), jcfg)
    jmodel = JCTCLIP(jcfg, dtype=jnp.float32)

    def loss_fn(params, vq):
        loss, new = jmodel.apply({"params": params, "vq": vq}, jnp.asarray(ids),
                                 jnp.asarray(mask), jnp.asarray(video), return_loss=True,
                                 train=True, mutable=["vq"])
        return loss, new["vq"]
    (jloss, new_vq), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["vq"])
    model.train()
    loss = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(video),
                 return_loss=True, train=True)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    want = state_dict_from_jax({"params": grads, "vq": new_vq}, pcfg)
    _grads_close(model, want)
    for key in ("embed", "cluster_size"):
        name = f"visual_transformer.vq._codebook.{key}"
        _close(model.state_dict()[name], want[name].numpy(), 1e-5)


def test_tiny_f32_autoencoder_step_matches_jax(eager, tmp_path):
    """A tiny f32 CTViT autoencoder on a non-cubic (2, 4, 4) token grid (K2
    seq / K10 seq), 4 volumes: 128 VQ rows within JAX's VQ plan.  The
    generator loss (reconstruction, commitment, the discriminator's hinge
    term), every gradient and the VQ's EMA state against
    jax.value_and_grad of the JAX trainer's gen_loss_fn."""
    import ct_clip_tpu as J
    from ct_clip_tpu.models import CTViT as JCTViT
    from ct_clip_tpu.ops.pallas.vq import _plan
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.convert import ctvit_state_dict_from_jax
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.train import CTViTTrainer
    from test_torch_port_ctvit_ae import _jax_gen_loss, _jax_params

    b, frames = 4, 4
    vit = dict(VIT, num_frames=frames, with_decoder=True)
    jcfg, pcfg = J.CTViTConfig(**vit, vq_exact_sim=True), CTViTConfig(**vit)
    assert _plan(b * 32, 128, 128) is not None
    g = torch.Generator().manual_seed(27)
    model = CTViT(pcfg).init_weights(g)
    _perturb(model, g)
    video = np.random.RandomState(27).uniform(-1, 1, (b, frames, 32, 32, 1)).astype(np.float32)
    _seed_codebook(model, torch.from_numpy(video), b * 32)
    params, vq = _jax_params(model.state_dict(), jcfg)
    trainer = CTViTTrainer(model, lr=1e-3, use_discr=True, results_folder=str(tmp_path))
    discr = trainer.state.discr
    with torch.no_grad():
        for t in discr.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * (0.1 if t.dim() == 1 else
                                                         t[0].numel() ** -0.5))
    dparams = {name: {"kernel": getattr(discr, name).weight.detach().numpy().transpose(
        2, 3, 4, 1, 0), "bias": getattr(discr, name).bias.detach().numpy()}
        for name in [f"conv_{i}" for i in range(4)] + ["to_logit"]}
    (jloss, new_vq), grads = jax.value_and_grad(
        _jax_gen_loss(JCTViT(jcfg, dtype=jnp.float32)), has_aux=True)(
            params, vq, jnp.asarray(video), dparams)
    loss, _, _ = trainer.generator_loss(torch.from_numpy(video))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    want = ctvit_state_dict_from_jax({"params": grads, "vq": new_vq}, pcfg)
    _grads_close(model, want)
    for key in ("embed", "cluster_size"):
        _close(model.state_dict()[f"vq._codebook.{key}"], want[f"vq._codebook.{key}"], 1e-5)
