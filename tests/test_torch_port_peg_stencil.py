"""The PEG stencil's plain versions (ct_clip_tpu_torch/ops/attention.py:
`peg_fwd_plain`, `peg_dx_plain`, `peg_dw_plain`), which the CPU takes and the
card checks csrc/peg_stencil.cu against, held to the JAX package's PEG
functions on the CPU (ct_clip_tpu/ops/pallas/peg.py), for the three
geometries the port runs: frame-causal (leading pads (2, 1, 1)), rotated
(the temporal stage on a cubic grid: taps rotated, (1, 2, 1), JAX's
causal_axis 1) and non-causal (MaskGIT, (1, 1, 1)).

Tolerances.  f32: 1e-5 of max|JAX| (the same products summed in another
order).  bf16: both sides round at `lax_peg_conv`'s three points (the conv's
f32 sum, + x, + bias) or `lax_peg_dx`'s two; an f32 sum in another order
lands a rounding one bf16 ulp apart now and then, so the max error is held
to 1e-2 of max|JAX| and the mean |error| to BF16_MEAN_TOL of mean|JAX|,
which `xla_peg_conv`'s single rounding of the whole sum (the point the
stencil does not take) misses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_tpu.ops.pallas.peg import lax_peg_conv, lax_peg_dx, xla_peg_conv
from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops.attention import (PEG, _peg_leads, _peg_taps, peg_conv, peg_dw_plain,
                                             peg_dx_plain, peg_fwd_plain)

BF16_MEAN_TOL = 1e-3
# (rotated, causal) -> JAX's (causal, causal_axis)
GEOMETRIES = {"frame_causal": (False, True, True, 0), "rotated": (True, True, True, 1),
              "non_causal": (False, False, False, 0)}
SHAPE = (2, 4, 4, 4, 16)  # cubic, as the rotated form needs


def _inputs(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    do = rng.randn(*shape).astype(np.float32)
    weight = (rng.randn(c, 1, 3, 3, 3) * 0.3).astype(np.float32)  # Conv3d layout
    bias = (rng.randn(c) * 0.5).astype(np.float32)
    return x, do, weight, bias


def _jax_kernel(weight, rotated):
    """The flax DHWIO kernel of the Conv3d weight, rotated as JAX's PEG does."""
    kernel = jnp.asarray(weight.transpose(2, 3, 4, 1, 0))
    return jnp.transpose(kernel, (2, 0, 1, 3, 4)) if rotated else kernel


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _errs(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(got - ref)
    return d.max() / np.abs(ref).max(), d.mean() / np.abs(ref).mean()


def _port(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_peg_fwd_plain_bf16_matches_lax_peg_conv(geometry):
    rotated, causal, jcausal, axis = GEOMETRIES[geometry]
    x, _, weight, bias = _inputs(1)
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = _jax_kernel(weight, rotated)
    ref = lax_peg_conv(xb, kernel, jnp.asarray(bias), jcausal, residual=True, causal_axis=axis)
    xt = _port(_np(xb), torch.bfloat16)
    got = peg_fwd_plain(xt, _peg_taps(_port(weight, torch.float32), rotated, torch.bfloat16),
                        _port(bias, torch.float32), _peg_leads(rotated, causal))
    assert got.dtype == torch.bfloat16
    rel, mean = _errs(got, ref)
    assert rel <= 1e-2 and mean <= BF16_MEAN_TOL, (rel, mean)
    # the single rounding of the whole sum misses the mean limit
    one = xla_peg_conv(xb, kernel, jnp.asarray(bias), jcausal, residual=True, causal_axis=axis)
    assert _errs(one, ref)[1] > BF16_MEAN_TOL


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_peg_fwd_plain_f32_matches_xla_peg_conv(geometry):
    rotated, causal, jcausal, axis = GEOMETRIES[geometry]
    x, _, weight, bias = _inputs(2)
    ref = xla_peg_conv(jnp.asarray(x), _jax_kernel(weight, rotated), jnp.asarray(bias), jcausal,
                       residual=True, causal_axis=axis)
    got = peg_fwd_plain(_port(x, torch.float32),
                        _peg_taps(_port(weight, torch.float32), rotated, torch.float32),
                        _port(bias, torch.float32), _peg_leads(rotated, causal))
    assert _errs(got, ref)[0] <= 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_peg_dx_plain_matches_lax_peg_dx(geometry, dtype):
    rotated, causal, jcausal, axis = GEOMETRIES[geometry]
    _, do, weight, _ = _inputs(3)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                        torch.float32)
    dj = jnp.asarray(do, jdt)
    ref = lax_peg_dx(dj, _jax_kernel(weight, rotated), jcausal, residual=True, causal_axis=axis)
    got = peg_dx_plain(_port(_np(dj), tdt), _peg_taps(_port(weight, torch.float32), rotated, tdt),
                       _peg_leads(rotated, causal))
    assert got.dtype == tdt
    rel, mean = _errs(got, ref)
    if dtype == "bf16":
        assert rel <= 1e-2 and mean <= BF16_MEAN_TOL, (rel, mean)
    else:
        assert rel <= 1e-5


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_peg_dw_plain_matches_jax_vjp(geometry):
    """dW and db of the plain version (taps as applied, un-rotated as the
    autograd Function does) against jax.vjp of `xla_peg_conv` in f32."""
    rotated, causal, jcausal, axis = GEOMETRIES[geometry]
    x, do, weight, bias = _inputs(4)
    kernel = _jax_kernel(weight, rotated)
    _, vjp = jax.vjp(lambda k, b: xla_peg_conv(jnp.asarray(x), k, b, jcausal, residual=True,
                                                causal_axis=axis), kernel, jnp.asarray(bias))
    dk, db = vjp(jnp.asarray(do))
    got = peg_dw_plain(_port(x, torch.float32), _port(do, torch.float32),
                       _peg_leads(rotated, causal))
    c = x.shape[-1]
    want = np.asarray(dk).reshape(27, c)  # DHWIO as applied: (kz, ky, kx) rows
    assert _errs(got[:27], want)[0] <= 1e-5
    assert _errs(got[27], db)[0] <= 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_peg_module_matches_jax_peg(geometry, dtype):
    """The whole PEG module, forward and backward (x, weight, bias), against
    JAX's PEG with the weights copied across.  JAX's PEG on the CPU takes
    `xla_peg_conv` in both dtypes (its grouped conv and K14 are gated to the
    TPU), so in bf16 the output and dx are held to 2e-2 of max (one rounding
    against three), and dW and db, K14's f32 sums of exact bf16 products, to
    1e-5 of JAX's f32 PEG on the same bf16 values."""
    from ct_clip_tpu.ops.attention import PEG as JPEG

    rotated, causal, _, _ = GEOMETRIES[geometry]
    x, do, weight, bias = _inputs(5)
    c = x.shape[-1]
    jdt, tdt, tol = ((jnp.bfloat16, torch.bfloat16, 2e-2) if dtype == "bf16"
                     else (jnp.float32, torch.float32, 1e-5))
    xj, dj = jnp.asarray(x, jdt), jnp.asarray(do, jdt)
    params = {"dsconv": {"kernel": jnp.asarray(weight.transpose(2, 3, 4, 1, 0)),
                         "bias": jnp.asarray(bias)}}

    def jax_peg(dt, x_):
        jmod = JPEG(c, causal=causal, residual=True, dtype=dt, rotated=rotated)
        return jax.vjp(lambda p, y: jmod.apply({"params": p}, y), params, x_)
    want, vjp = jax_peg(jdt, xj)
    _, dx = vjp(dj)
    _, vjp32 = jax_peg(jnp.float32, xj.astype(jnp.float32))
    dparams, _ = vjp32(dj.astype(jnp.float32))
    peg = PEG(c, causal=causal)
    with torch.no_grad():
        peg.dsconv.weight.copy_(_port(weight, torch.float32))
        peg.dsconv.bias.copy_(_port(bias, torch.float32))
    xt = _port(_np(xj), tdt).requires_grad_()
    out = peg(xt, rotated=rotated)
    out.backward(_port(_np(dj), tdt))
    assert out.dtype == tdt and xt.grad.dtype == tdt
    assert _errs(out, want)[0] <= tol
    assert _errs(xt.grad, dx)[0] <= tol
    assert _errs(peg.dsconv.weight.grad,
                 np.asarray(dparams["dsconv"]["kernel"]).transpose(4, 3, 0, 1, 2))[0] <= 1e-5
    assert _errs(peg.dsconv.bias.grad, dparams["dsconv"]["bias"])[0] <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_peg_routes_to_plain_versions_on_the_cpu(dtype):
    """On the CPU `peg_conv` runs the plain versions, forward and backward,
    and no launch counter rises."""
    x, do, weight, bias = _inputs(6, (1, 3, 5, 6, 8))
    xt = _port(x, dtype).requires_grad_()
    wt, bt = _port(weight, torch.float32).requires_grad_(), _port(bias, torch.float32)
    K.reset_launch_counts()
    out = peg_conv(xt, wt, bt.requires_grad_())
    dx, dw, db = torch.autograd.grad(out, (xt, wt, bt), _port(do, dtype))
    assert not any(K.launch_counts().values())
    taps, pads = _peg_taps(wt.detach(), False, dtype), _peg_leads(False, True)
    assert torch.equal(out, peg_fwd_plain(xt.detach(), taps, bt.detach(), pads))
    assert torch.equal(dx, peg_dx_plain(_port(do, dtype), taps, pads))
    dwb = peg_dw_plain(xt.detach(), _port(do, dtype), pads)
    assert torch.equal(dw.reshape(8, 27), dwb[:27].t()) and torch.equal(db, dwb[27])


@pytest.mark.parametrize("shape,dtype,bwd,plan", [
    ((8, 24, 24, 24, 512), torch.bfloat16, False, (4, 24, 48)),  # contrastive, forward
    ((8, 24, 24, 24, 512), torch.bfloat16, True, (2, 24, 96)),   # K14: its x tiles too
    ((2, 24, 24, 24, 512), torch.bfloat16, False, (1, 24, 48)),  # zero-shot: fill 132 x 2
    ((8, 20, 8, 8, 512), torch.float32, True, (2, 8, 32)),       # f32: 32-channel slabs
    ((8, 20, 8, 8, 512), torch.bfloat16, True, (1, 8, 64)),
    ((1, 3, 5, 33, 8), torch.float32, False, (1, 32, 10)),       # W past one 32-wide tile
    ((4, 3, 3, 3, 64), torch.bfloat16, True, (1, 4, 12)),        # W rounded up to 4
])
def test_peg_plan_tiles(shape, dtype, bwd, plan):
    """The stencil's tiles (kernels.peg_plan): the most rows (4 forward, 2
    backward) that still give two CTAs an SM of an H100's 132, columns W
    rounded up to 4, at most 32; the tile count sizes K14's partial rows."""
    assert K.peg_plan(shape, dtype, bwd) == plan
