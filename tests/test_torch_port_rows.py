"""The patch-row ingest of ct_clip_tpu_torch against the JAX package, f32, CPU:
K6 (`rearrange_patches`), `preprocess_to_patch_rows` /
`preprocess_rows_into`, and K4 (`fused_row_embed`).

On the CPU the port takes its plain versions.  The JAX side runs both its
CPU fallbacks (the gather for K6, `row_embed_train` for K4) and the Pallas
kernels themselves in interpret mode (`_call.set_interpret(True)`, as
tests/test_pallas_interpret.py does), on geometries the kernels' block plans
accept.  Tolerances: K6 moves values, so it is exact; K4 sums in other
orders, so max|port - jax| <= 1e-4 * max|jax|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

RTOL = 1e-4


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max abs err {err:.3e}"


@pytest.fixture
def interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # kernel plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


# ----------------------------------------------------------------------- K6
@pytest.mark.parametrize("shape,pt,p", [((2, 6, 12, 8), 2, 4),
                                        ((1, 20, 40, 60), 10, 20)])
def test_rearrange_patches_matches_jax_gather(shape, pt, p):
    from ct_clip_tpu.ops.pallas.patchify import rearrange_patches as jax_rearrange
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    video = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.asarray(jax_rearrange(jnp.asarray(video), pt, p))
    got = rearrange_patches(torch.from_numpy(video), pt, p)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rearrange_patches_matches_pallas_interpret(interpret):
    from ct_clip_tpu.ops.pallas.patchify import _pallas_rearrange
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    # the kernel-legal geometry of tests/test_pallas.py (h = w = 8, p = 8)
    video = np.random.RandomState(3).randn(1, 4, 64, 64).astype(np.float32)
    ref = np.asarray(_pallas_rearrange(jnp.asarray(video), 2, 8))
    got = rearrange_patches(torch.from_numpy(video), 2, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rearrange_patches_writes_into_a_slot_view():
    from ct_clip_tpu_torch.ops.patch_embed import patchify, rearrange_patches

    video = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 12, 8)
                             .astype(np.float32))
    buf = torch.full((3, 3 * 3 * 2, 2 * 4 * 4), 7.0)
    out = rearrange_patches(video, 2, 4, out=buf[1:2])
    assert out.data_ptr() == buf[1].data_ptr()
    torch.testing.assert_close(buf[1], patchify(video, 2, 4)[0], rtol=0, atol=0)
    assert (buf[0] == 7).all() and (buf[2] == 7).all()
    with pytest.raises(ValueError):
        rearrange_patches(video, 2, 4, out=buf[:2])


# ------------------------------------------------------------------- ingest
def _raw_volume():
    rng = np.random.RandomState(6)
    vol = rng.randint(-1200, 1500, (20, 40, 36)).astype(np.int16)  # (Z, Y, X)
    true = np.array([17, 33, 38], np.int32)  # semantic (z, x, y)
    spacing = np.array([3.0, 0.9, 0.9], np.float32)
    return vol, true, spacing


def test_preprocess_to_patch_rows_matches_jax():
    """The rows are the port's volume moved exactly as JAX moves it; the
    volumes themselves agree to f32 ulps (F.interpolate against the JAX
    package's index maps, as test_torch_port_ops checks), so the whole ingest
    is held to that test's 1e-5."""
    from ct_clip_tpu.ops.pallas.patchify import rearrange_patches as jax_rearrange
    from ct_clip_tpu.ops.resample import preprocess_to_patch_rows as jax_rows
    from ct_clip_tpu_torch.config import PreprocessConfig
    from ct_clip_tpu_torch.ops.resample import (preprocess_to_patch_rows,
                                                preprocess_volume)

    vol, true, spacing = _raw_volume()
    target, pt, p = (24, 40, 48), 4, 8
    for clip_before in (False, True):
        cfg = PreprocessConfig(target_shape=target, clip_before_resample=clip_before)
        kw = dict(true_sizes=true, input_layout="zyx", config=cfg)
        got = preprocess_to_patch_rows(torch.from_numpy(vol), spacing, 1.0, -24.0,
                                       temporal_patch_size=pt, patch_size=p, **kw)
        assert got.shape == (6 * 5 * 6, pt * p * p) and got.dtype == torch.float32
        port_vol = preprocess_volume(torch.from_numpy(vol), spacing, 1.0, -24.0, **kw)
        moved = jax_rearrange(jnp.asarray(port_vol.numpy())[None], pt, p)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(moved))
        ref = jax_rows(jnp.asarray(vol), jnp.asarray(spacing), jnp.float32(1.0),
                       jnp.float32(-24.0), true_sizes=jnp.asarray(true),
                       clip_before_resample=clip_before, temporal_patch_size=pt,
                       patch_size=p, out_dtype=jnp.float32, target_shape=target,
                       input_layout="zyx", compute_dtype=jnp.float32)
        _close(got, ref, rtol=1e-5)


def test_preprocess_rows_into_fills_one_slot():
    from ct_clip_tpu_torch.config import PreprocessConfig
    from ct_clip_tpu_torch.ops.resample import (preprocess_rows_into,
                                                preprocess_to_patch_rows)

    vol, true, spacing = _raw_volume()
    cfg = PreprocessConfig(target_shape=(24, 40, 48))
    kw = dict(true_sizes=true, input_layout="zyx", config=cfg,
              temporal_patch_size=4, patch_size=8)
    rows = preprocess_to_patch_rows(torch.from_numpy(vol), spacing, 1.0, -24.0, **kw)
    buf = torch.zeros((2,) + tuple(rows.shape))
    out = preprocess_rows_into(buf, 1, torch.from_numpy(vol), spacing, 1.0, -24.0, **kw)
    assert out is buf
    np.testing.assert_array_equal(buf[1].numpy(), rows.numpy())
    assert not buf[0].any()


# ----------------------------------------------------------------------- K4
def _row_embed_inputs(seed, b, n, pd, dim):
    rng = np.random.RandomState(seed)
    rows = rng.randn(b, n, pd).astype(np.float32)
    w = dict(s1=1 + 0.1 * rng.randn(pd), b1=0.1 * rng.randn(pd),
             wi=rng.randn(pd, dim) / np.sqrt(pd), pb=0.1 * rng.randn(dim),
             s2=1 + 0.1 * rng.randn(dim), b2=0.1 * rng.randn(dim))
    jax_w = [jnp.asarray(w[k], jnp.float32) for k in ("s1", "b1", "wi", "pb", "s2", "b2")]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    port_w = [t(w["s1"]), t(w["b1"]), t(w["wi"].T), t(w["pb"]), t(w["s2"]), t(w["b2"])]
    return rows, jax_w, port_w


def test_row_embed_matches_row_embed_train():
    from ct_clip_tpu.ops.pallas.patchify import row_embed_train
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed, row_embed_plain

    rows, jax_w, port_w = _row_embed_inputs(7, 2, 30, 200, 24)
    ref = row_embed_train(jnp.asarray(rows), *jax_w, 1e-5, jnp.float32)
    got = fused_row_embed(torch.from_numpy(rows), *port_w)
    _close(got, ref)
    torch.testing.assert_close(got, row_embed_plain(torch.from_numpy(rows), *port_w),
                               rtol=0, atol=0)


def test_row_embed_matches_pallas_interpret(interpret):
    from ct_clip_tpu.ops.pallas.patchify import _pallas_row_embed
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed

    # the smallest geometry the kernel's block plan takes (n % 16, dim % 128)
    rows, jax_w, port_w = _row_embed_inputs(12, 2, 64, 128, 128)
    ref = _pallas_row_embed(jnp.asarray(rows), *jax_w, 1e-5, jnp.float32)
    got = fused_row_embed(torch.from_numpy(rows), *port_w)
    _close(got, ref)


def test_row_embed_of_rows_equals_patch_embed_of_volume():
    from ct_clip_tpu_torch.ops.patch_embed import (fused_patch_embed,
                                                   fused_row_embed,
                                                   rearrange_patches)

    pt, p = 2, 4
    video = torch.from_numpy(np.random.RandomState(9).randn(2, 6, 12, 8)
                             .astype(np.float32))
    _, _, port_w = _row_embed_inputs(8, 1, 1, pt * p * p, 24)
    rows = rearrange_patches(video, pt, p)
    torch.testing.assert_close(fused_row_embed(rows, *port_w),
                               fused_patch_embed(video, *port_w, pt, p),
                               rtol=1e-5, atol=1e-5)
