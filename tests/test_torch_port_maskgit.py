"""The MaskGIT stack of ct_clip_tpu_torch against the JAX package, f32, CPU.

A tiny MaskGit (dim 32, depth 1, 4 heads x 8, text width 16, 24 codes) over
a (2, 4, 4) token grid, 32 tokens, and a TokenCritic of the same width.
Weights are initialised in JAX (every vector moved off its init value) and
carried across with `maskgit_state_dict_from_jax` /
`critic_state_dict_from_jax`; inputs come from a numpy seed, and each
random draw of the JAX functions (cond drop, the training mask, gumbel and
critic noise) is derived from its key and handed to the port through
`draws`.  The port runs its plain versions; JAX, off the TPU, its XLA
branch, or for K7 dense / K12b its Pallas kernels in interpret mode.

Tolerances, relative to the largest entry of the reference: 1e-4 (f32
sums in other orders through the transformer), 1e-3 for the interpret-mode
K12b (the TPU kernel's dS rounding pass), ids exactly.  The CPB MLP's
output bias adds one constant to every score of a head, so its true
gradient is zero: both sides hold rounding noise there (held to 1e-6 of the
largest gradient), which Adam turns into steps of up to lr (held to that
bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

V, GRID, N, B = 24, (2, 4, 4), 32, 2
M, T5D = 5, 16  # text tokens, text width
RTOL = 1e-4
ZERO_GRAD = ("continuous_pos_bias.net.2.bias",)


def _cfgs():
    import ct_clip_tpu as J
    from ct_clip_tpu_torch.config import MaskGitConfig

    kw = dict(dim=32, depth=1, dim_head=8, heads=4, max_seq_len=40, t5_dim=T5D)
    return J.MaskGitConfig(**kw), MaskGitConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-12, f"max abs err {err:.3e}"


def _perturb(params, seed):
    """Every vector (gammas, scales, biases) moved off its init value."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: np.asarray(p) + (0.2 * rng.randn(*p.shape).astype(
        np.float32) if np.ndim(p) <= 1 else 0.0), params)


@pytest.fixture(scope="module")
def ref():
    return build_ref()


def build_ref():
    """The tiny JAX MaskGit (initialised with the context, so it holds its
    cross attention) and TokenCritic, their port twins, the context (its
    second row padded) and code ids.  The inits run under jax.jit."""
    from ct_clip_tpu.models import MaskGit as JMaskGit, TokenCritic as JCritic
    from ct_clip_tpu_torch.convert.from_jax import (critic_state_dict_from_jax,
                                                    maskgit_state_dict_from_jax)
    from ct_clip_tpu_torch.models import MaskGit, TokenCritic

    jcfg, pcfg = _cfgs()
    rng = np.random.RandomState(0)
    ctx = rng.randn(B, M, T5D).astype(np.float32)
    ctx[1, 3:] = 0.0  # pad rows: text_mask defaults to the non-zero rows
    ids = rng.randint(0, V, (B, N))
    jm, jc = JMaskGit(jcfg, num_tokens=V), JCritic(jcfg, num_tokens=V)
    mparams = _perturb(jax.jit(lambda k, i, c: jm.init(k, i, GRID, context=c))(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(ctx))["params"], 1)
    cparams = _perturb(jax.jit(lambda k, i: jc.init(k, i, GRID))(
        jax.random.PRNGKey(1), jnp.asarray(ids))["params"], 2)
    pm, pc = MaskGit(pcfg, num_tokens=V), TokenCritic(pcfg, num_tokens=V)
    pm.load_state_dict(maskgit_state_dict_from_jax(mparams, pcfg))
    pc.load_state_dict(critic_state_dict_from_jax(cparams, pcfg))
    return dict(jm=jm, jc=jc, mparams=mparams, cparams=cparams, pm=pm, pc=pc,
                ctx=ctx, ids=ids, pcfg=pcfg, jcfg=jcfg)


@pytest.fixture(scope="module")
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


# ----------------------------------------------------- K7 dense and K12b
def _attn_args(n, seed, bh, b=2, h=2, d=16):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    bias = rng.randn(1, bh, n, n).astype(np.float32)
    return q, k, v, bias, do


@pytest.mark.parametrize("bh", [2, 1])
def test_k7_dense_and_k12b_plain_match_pallas_interpret(pallas_interpret, bh):
    """The port's fused_attention with a dense (1, 1|h, n, n) bias and its
    backward (CPU: the plain versions of K7 dense and K12b) against
    `_pallas_attention` / `_pallas_attention_bwd` in interpret mode at (2,
    2, 128, 16): 1e-4 forward, 1e-3 backward (dq, dk, dv, dbias summed over
    the batch, and over the heads for the one-head bias)."""
    from ct_clip_tpu.ops.pallas.attention import (_pallas_attention, _pallas_attention_bwd,
                                                  _plan)
    from ct_clip_tpu_torch.ops.attention import fused_attention

    q, k, v, bias, do = _attn_args(128, 3, bh)
    jq, jk, jv, jb, jdo = map(jnp.asarray, (q, k, v, bias, do))
    g = _plan(q.shape, 4, bias.shape)
    assert g is not None  # interpret mode opens the kernel's gate
    want = _pallas_attention(jq, jk, jv, jb, g)
    want_grads = _pallas_attention_bwd(jq, jk, jv, jb, jdo)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = fused_attention(*leaves[:3], bias=leaves[3])
    _close(out, want)
    for got, w in zip(torch.autograd.grad(out, leaves, _t(do)), want_grads):
        _close(got, w, 1e-3)


@pytest.mark.parametrize("bh", [2, 1])
def test_fused_attention_dense_bias_and_vjp_match_jax_at_n40(bh):
    """Below the TPU kernels' n >= 128 gate JAX computes the same function
    in XLA: the port's output and every gradient against its VJP."""
    from ct_clip_tpu.ops.pallas.attention import fused_attention as jfused
    from ct_clip_tpu_torch.ops.attention import fused_attention

    q, k, v, bias, do = _attn_args(40, 4, bh)
    want, vjp = jax.vjp(lambda *a: jfused(*a), *map(jnp.asarray, (q, k, v, bias)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = fused_attention(*leaves[:3], bias=leaves[3])
    _close(out, want)
    for got, w in zip(torch.autograd.grad(out, leaves, _t(do)), vjp(jnp.asarray(do))):
        _close(got, w)


def test_sdpa_masked_and_cross_match_jax():
    """`sdpa` with a ragged key mask (self attention, dense bias) and with
    unequal lengths (cross attention over 2 null + 5 text keys) against
    `_sdpa`'s XLA branch."""
    from ct_clip_tpu.ops.attention import _sdpa
    from ct_clip_tpu_torch.ops.attention import sdpa

    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 4, 12, 8).astype(np.float32) for _ in range(3))
    bias = rng.randn(1, 4, 12, 12).astype(np.float32)
    mask = np.arange(12)[None] < np.array([[12], [7]])
    _close(sdpa(_t(q), _t(k), _t(v), _t(bias), torch.from_numpy(mask)),
           _sdpa(*map(jnp.asarray, (q, k, v, bias)), mask=jnp.asarray(mask)))
    kc, vc = (rng.randn(2, 4, 7, 8).astype(np.float32) for _ in range(2))
    cmask = np.arange(7)[None] < np.array([[7], [4]])
    _close(sdpa(_t(q), _t(kc), _t(vc), mask=torch.from_numpy(cmask)),
           _sdpa(*map(jnp.asarray, (q, kc, vc)), mask=jnp.asarray(cmask)))
    with pytest.raises(NotImplementedError):
        sdpa(_t(q), _t(k), _t(v), causal=True)


# ------------------------------------------- attention, PEG and CPB modules
@pytest.mark.parametrize("cross", [False, True])
def test_qknorm_attention_generic_path_matches_jax(cross):
    """QKNormAttention's generic path: self attention with a 3-D bias and a
    ragged mask, or cross attention over a normed context with 2 null
    key/values and a text mask; output and every parameter's gradient."""
    from ct_clip_tpu.ops.attention import QKNormAttention as JAttn
    from ct_clip_tpu_torch.convert.from_jax import _attention
    from ct_clip_tpu_torch.ops.attention import QKNormAttention

    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 32).astype(np.float32)
    do = rng.randn(2, 12, 32).astype(np.float32)
    if cross:
        ctx = rng.randn(2, 5, 16).astype(np.float32)
        mask = np.arange(5)[None] < np.array([[5], [3]])
        jmod = JAttn(32, dim_context=16, dim_head=8, heads=4, num_null_kv=2, residual=True)
        jargs = dict(mask=jnp.asarray(mask), context=jnp.asarray(ctx))
        pmod = QKNormAttention(32, 8, 4, dim_context=16, num_null_kv=2)
        pargs = dict(mask=torch.from_numpy(mask), context=_t(ctx))
    else:
        bias = rng.randn(4, 12, 12).astype(np.float32)
        mask = np.arange(12)[None] < np.array([[12], [9]])
        jmod = JAttn(32, dim_head=8, heads=4, residual=True)
        jargs = dict(mask=jnp.asarray(mask), attn_bias=jnp.asarray(bias))
        pmod = QKNormAttention(32, 8, 4)
        pargs = dict(mask=torch.from_numpy(mask), attn_bias=_t(bias))
    params = _perturb(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), **jargs)["params"], 7)
    sd = {}
    _attention(sd, params, "m", 4, 8)
    pmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    want, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, jnp.asarray(x), **jargs), params)
    got = pmod(_t(x), **pargs)
    _close(got, want)
    got.backward(_t(do))
    sd = {}
    _attention(sd, vjp(jnp.asarray(do))[0], "m", 4, 8)
    for name, p in pmod.named_parameters():
        if p.numel():  # self attention's empty null_kv
            _close(p.grad, sd["m." + name])


@pytest.mark.parametrize("biased", [False, True])
def test_qknorm_attention_routes_by_fit(monkeypatch, biased):
    """A self-attention without a mask, context or null key/values takes a
    fused sublayer (K1 with a bias, K2 seq without) where `sublayer_fits`
    accepts and the generic path where it does not; both routes give the
    same output and gradients in f32.  The fit: CT-CLIP's 576-token planes
    of width 32 and the CTViT's (20, 8, 8) grid at width 64 fit, MaskGIT's
    1,280 tokens at width 64 do not."""
    from ct_clip_tpu_torch.ops import attention as A
    from ct_clip_tpu_torch.ops.qknorm_attention import sublayer_fits

    assert sublayer_fits(576, 32) and sublayer_fits(64, 64) and sublayer_fits(20, 64)
    assert not sublayer_fits(1280, 64) and not sublayer_fits(512, 64)
    g = torch.Generator().manual_seed(11)
    mod = A.QKNormAttention(32, 8, 4)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=g))
    x = torch.randn((2, 12, 32), generator=g)
    do = torch.randn((2, 12, 32), generator=g)
    bias = torch.randn((4, 12, 12), generator=g) if biased else None
    routes = []
    for name in ("fused_spatial_qknorm_attention", "fused_small_qknorm_attention", "sdpa"):
        monkeypatch.setattr(A, name, lambda *a, _f=getattr(A, name), _n=name, **kw:
                            routes.append(_n) or _f(*a, **kw))

    def run():
        mod.zero_grad()
        out = mod(x, bias)
        out.backward(do)
        return [out] + [p.grad.clone() for p in mod.parameters() if p.numel()]

    fused = run()
    monkeypatch.setattr(A, "sublayer_fits", lambda n, d, dtype: False)
    generic = run()
    assert routes == ["fused_spatial_qknorm_attention" if biased
                      else "fused_small_qknorm_attention", "sdpa"]
    for a, b in zip(fused, generic):
        _close(a, b.detach().numpy(), 1e-5)


@pytest.mark.parametrize("pallas", [False, True])
def test_peg_non_causal_and_k14_pads_match_jax(pallas_interpret, pallas):
    """MaskGIT's PEG pads every axis by 1 (causal=False): x + conv(x) + b and
    its dx, dW, db against JAX's PEG (XLA conv) in f32; and K14's plain
    version at leading pads (1, 1, 1) against `_pallas_peg_bwd` in
    interpret mode with causal=False on bf16 activations (exact bf16
    products summed in f32: 1e-5)."""
    from ct_clip_tpu.ops.attention import PEG as JPEG
    from ct_clip_tpu.ops.pallas.peg import _pallas_peg_bwd, _plan
    from ct_clip_tpu_torch.ops.attention import PEG, peg_dw_plain

    rng = np.random.RandomState(8)
    c = 128 if pallas else 16
    shape = (1, 3, 8, 8, c) if pallas else (2, 3, 4, 4, c)
    x = rng.randn(*shape).astype(np.float32)
    do = rng.randn(*shape).astype(np.float32)
    weight = (rng.randn(c, 1, 3, 3, 3) * 0.2).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    kernel = weight.transpose(2, 3, 4, 1, 0)  # flax DHWIO
    if pallas:
        xb, dob = (jnp.asarray(a, jnp.bfloat16) for a in (x, do))
        _, dw, db = _pallas_peg_bwd(xb, jnp.asarray(kernel), dob, False,
                                    _plan(xb.shape, xb.dtype), residual=True)
        got = peg_dw_plain(*(torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                             for a in (xb, dob)), (1, 1, 1))
        _close(got[:27].t().reshape(c, 1, 3, 3, 3), np.asarray(dw).transpose(4, 3, 0, 1, 2),
               1e-5)
        _close(got[27], db, 1e-5)
        return
    params = {"dsconv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    jmod = JPEG(c, causal=False, residual=True)
    want, vjp = jax.vjp(lambda p, x_: jmod.apply({"params": p}, x_), params, jnp.asarray(x))
    peg = PEG(c, causal=False)
    with torch.no_grad():
        peg.dsconv.weight.copy_(_t(weight))
        peg.dsconv.bias.copy_(_t(bias))
    xt = _t(x).requires_grad_()
    out = peg(xt)
    _close(out, want)
    out.backward(_t(do))
    dparams, dx = vjp(jnp.asarray(do))
    _close(xt.grad, dx)
    _close(peg.dsconv.weight.grad,
           np.asarray(dparams["dsconv"]["kernel"]).transpose(4, 3, 0, 1, 2))
    _close(peg.dsconv.bias.grad, dparams["dsconv"]["bias"])


def test_cpb_3d_forward_and_table_gradient_match_jax():
    """The 3-D continuous position bias (MLP width dim_head) on the (2, 4,
    4) grid: the (heads, N, N) bias and the MLP's gradients (autograd of the
    gather here, JAX's scatter VJP there)."""
    from ct_clip_tpu.ops.attention import ContinuousPositionBias as JCPB
    from ct_clip_tpu_torch.convert.from_jax import _cpb
    from ct_clip_tpu_torch.ops.attention import ContinuousPositionBias

    jmod = JCPB(dim=8, heads=4, num_dims=3)
    params = _perturb(jmod.init(jax.random.PRNGKey(3), *GRID)["params"], 9)
    cpb = ContinuousPositionBias(8, 4, num_dims=3)
    sd = {}
    _cpb(sd, "m", params)
    cpb.load_state_dict({k[2:]: v for k, v in sd.items()})
    want, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, *GRID), params)
    got = cpb(*GRID)
    _close(got, want)
    do = np.random.RandomState(10).randn(4, N, N).astype(np.float32)
    got.backward(_t(do))
    sd = {}
    _cpb(sd, "m", vjp(jnp.asarray(do))[0])
    for name, p in cpb.named_parameters():
        _close(p.grad, sd["m." + name])


# --------------------------------------------------------------- MaskGit
def _jkey(seed):
    return jax.random.PRNGKey(seed)


def loss_draws(rng, b, n, steps=18, cond_drop_prob=0.25):
    """maskgit_train_loss's draws from its key (maskgit.py:197-205, :52-55)."""
    r_mask, r_drop = jax.random.split(rng)
    r_step, r_pick = jax.random.split(r_mask)
    return {"step": torch.from_numpy(np.asarray(jax.random.randint(r_step, (b,), 0, steps))),
            "scores": _t(jax.random.uniform(r_pick, (b, n))),
            "keep": torch.from_numpy(np.asarray(
                jax.random.bernoulli(r_drop, 1.0 - cond_drop_prob, (b,))))}


def critic_draws(rng, logits_shape):
    """critic_train_loss's gumbel noise from its key (maskgit.py:224-227)."""
    r_samp, _ = jax.random.split(rng)
    return {"noise": _t(jax.random.uniform(r_samp, logits_shape, minval=1e-20, maxval=1.0))}


def sampler_draws(rng, steps, b, n, vocab):
    """sample_tokens' per-step draws from its key (maskgit.py:296-297)."""
    out = []
    for _ in range(steps):
        rng, r_gumbel, _, r_noise = jax.random.split(rng, 4)
        out.append({"gumbel": _t(jax.random.uniform(r_gumbel, (b, n, vocab), minval=1e-20,
                                                    maxval=1.0)),
                    "noise": _t(jax.random.uniform(r_noise, (b, n)))})
    return out


def _grads_close(model, grads, convert, cfg):
    sd = convert(grads, cfg)
    top = max(np.abs(np.asarray(v)).max() for v in sd.values() if v.numel())
    for name, p in model.named_parameters():
        if not p.numel():  # self attention's empty null_kv
            continue
        want = sd[name].numpy()
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if name.endswith(ZERO_GRAD):
            assert got.abs().max().item() <= 1e-6 * top, name
            assert np.abs(want).max() <= 1e-6 * top, name
        else:
            _close(got, want)


@pytest.mark.parametrize("with_context", [True, False])
def test_maskgit_logits_embeds_and_cond_drop_match_jax(ref, with_context):
    """Logits and `return_embeds` with the text context (its pad rows
    masked) and without; then cond drop at 0.5 with JAX's Bernoulli draw
    handed across."""
    jm, params, pm = ref["jm"], {"params": ref["mparams"]}, ref["pm"]
    ids = np.random.RandomState(11).randint(0, V + 1, (B, N))
    jctx = jnp.asarray(ref["ctx"]) if with_context else None
    pctx = _t(ref["ctx"]) if with_context else None
    _close(pm(torch.from_numpy(ids), GRID, context=pctx),
           jm.apply(params, jnp.asarray(ids), GRID, context=jctx))
    _close(pm(torch.from_numpy(ids), GRID, context=pctx, return_embeds=True),
           jm.apply(params, jnp.asarray(ids), GRID, context=jctx, return_embeds=True))
    if with_context:
        key = _jkey(12)
        keep = torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (B,))))
        _close(pm(torch.from_numpy(ids), GRID, context=pctx, cond_drop_prob=0.5, keep=keep),
               jm.apply(params, jnp.asarray(ids), GRID, context=jctx, cond_drop_rng=key,
                        cond_drop_prob=0.5))


@pytest.mark.parametrize("ragged", [False, True])
def test_maskgit_train_loss_and_grads_match_jax(ref, ragged):
    """maskgit_train_loss with the context and cond drop 0.25: the loss, the
    mask and every parameter's gradient against jax.value_and_grad.  No
    video_mask: the port's model sees None (K7 dense / K12b on the card),
    JAX an all-True mask (its XLA branch): the same function.  Ragged: a
    (b, N) mask, which both take through the masked plain path."""
    from ct_clip_tpu.models import maskgit_train_loss as jloss
    from ct_clip_tpu_torch.convert.from_jax import maskgit_state_dict_from_jax
    from ct_clip_tpu_torch.models.maskgit import maskgit_train_loss

    jm, pm, ids = ref["jm"], ref["pm"], ref["ids"].reshape(B, *GRID)
    vm = (np.arange(N)[None] < np.array([[N], [21]])) if ragged else None
    key = _jkey(13)

    def f(p, vm_):
        return jloss(jm, {"params": p}, key, jnp.asarray(ids), GRID,
                     context=jnp.asarray(ref["ctx"]), video_mask=vm_)

    (want, (masked, mask, _)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        ref["mparams"], jnp.asarray(np.ones((B, N), bool) if vm is None else vm))
    pm.zero_grad()
    loss, (pmasked, pmask, _) = maskgit_train_loss(
        pm, torch.from_numpy(ids), GRID, context=_t(ref["ctx"]),
        video_mask=None if vm is None else torch.from_numpy(vm),
        draws=loss_draws(key, B, N))
    assert np.array_equal(pmask.numpy(), np.asarray(mask))
    assert np.array_equal(pmasked.numpy(), np.asarray(masked))
    _close(loss, want, 1e-5)
    loss.backward()
    _grads_close(pm, grads, maskgit_state_dict_from_jax, ref["pcfg"])


def test_self_critic_matches_jax(ref):
    """SelfCritic.wrap over the trained MaskGit with a head's state dict
    against the JAX SelfCritic built by `wrap_variables`."""
    from ct_clip_tpu.models import SelfCritic as JSelfCritic
    from ct_clip_tpu_torch.models import SelfCritic

    rng = np.random.RandomState(21)
    head = {"kernel": rng.randn(32, 1).astype(np.float32), "bias": rng.randn(1).astype(np.float32)}
    ids = rng.randint(0, V + 1, (B, N))
    want = JSelfCritic(ref["jm"]).apply(
        JSelfCritic.wrap_variables({"params": ref["mparams"]}, head), jnp.asarray(ids), GRID,
        context=jnp.asarray(ref["ctx"]))
    critic = SelfCritic.wrap(ref["pm"], {"to_pred.weight": _t(head["kernel"].T),
                                         "to_pred.bias": _t(head["bias"])})
    assert critic.maskgit is ref["pm"]
    _close(critic(torch.from_numpy(ids), GRID, context=_t(ref["ctx"])), want)


def test_critic_train_loss_and_token_critic_match_jax(ref):
    """TokenCritic logits, and critic_train_loss on the MaskGit's logits
    with JAX's gumbel noise: the loss and every critic gradient."""
    from ct_clip_tpu.models import critic_train_loss as jcloss
    from ct_clip_tpu_torch.convert.from_jax import critic_state_dict_from_jax
    from ct_clip_tpu_torch.models.maskgit import critic_train_loss

    jc, pc, ids = ref["jc"], ref["pc"], ref["ids"]
    rng = np.random.RandomState(14)
    logits = rng.randn(B, N, V).astype(np.float32)
    mask = rng.rand(B, N) < 0.5
    _close(pc(torch.from_numpy(ids), GRID),
           jc.apply({"params": ref["cparams"]}, jnp.asarray(ids), GRID))
    key = _jkey(15)
    want, grads = jax.jit(jax.value_and_grad(lambda p: jcloss(
        jc, {"params": p}, key, jnp.asarray(ids), jnp.asarray(logits), jnp.asarray(mask),
        GRID)))(ref["cparams"])
    pc.zero_grad()
    loss = critic_train_loss(pc, torch.from_numpy(ids), _t(logits), torch.from_numpy(mask),
                             GRID, draws=critic_draws(key, logits.shape))
    _close(loss, want, 1e-5)
    loss.backward()
    _grads_close(pc, grads, critic_state_dict_from_jax, ref["pcfg"])


@pytest.mark.parametrize("mode", ["confidence", "critic_cfg", "primed"])
def test_sample_tokens_match_jax(ref, mode):
    """sample_tokens over 4 steps with JAX's gumbel and critic draws: the
    confidence scores without text; the critic with the context and CFG
    (cond_scale 3); the first 16 tokens primed, with the context.  Ids
    equal."""
    from ct_clip_tpu.models import sample_tokens as jsample
    from ct_clip_tpu_torch.models.maskgit import sample_tokens

    jm, pm = ref["jm"], ref["pm"]
    ctx = None if mode == "confidence" else ref["ctx"]
    prime = ref["ids"][:, :16] if mode == "primed" else None
    critic = mode == "critic_cfg"
    key, steps = _jkey(16), 4
    want = jsample(jm, {"params": ref["mparams"]}, key, GRID, batch_size=B,
                   context=None if ctx is None else jnp.asarray(ctx), steps=steps,
                   cond_scale=3.0, critic=ref["jc"] if critic else None,
                   critic_vars={"params": ref["cparams"]} if critic else None,
                   prime_token_ids=None if prime is None else jnp.asarray(prime))
    n = N - (0 if prime is None else prime.shape[1])
    got = sample_tokens(pm, GRID, batch_size=B, context=None if ctx is None else _t(ctx),
                        steps=steps, cond_scale=3.0, critic=ref["pc"] if critic else None,
                        prime_token_ids=None if prime is None else torch.from_numpy(prime),
                        draws=sampler_draws(key, steps, B, n, V))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cosine_schedule_mask_and_gumbel_sample_match_jax():
    from ct_clip_tpu.models.maskgit import cosine_schedule_mask as jmask, gumbel_sample as jgs
    from ct_clip_tpu_torch.models.maskgit import cosine_schedule_mask, gumbel_sample

    valid = np.arange(40)[None] < np.array([[40], [23], [7]])
    key = _jkey(17)
    d = loss_draws(key, 3, 40)
    want = jmask(jax.random.split(key)[0], jnp.asarray(valid), 18)  # r_mask
    got = cosine_schedule_mask(torch.from_numpy(valid), 18, (d["step"], d["scores"]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    logits = np.random.RandomState(18).randn(3, 7, 11).astype(np.float32)
    noise = jax.random.uniform(key, logits.shape, minval=1e-20, maxval=1.0)
    for temp in (0.0, 0.45, 1.0):
        assert np.array_equal(gumbel_sample(_t(logits), temp, _t(noise)).numpy(),
                              np.asarray(jgs(key, jnp.asarray(logits), temp)))
