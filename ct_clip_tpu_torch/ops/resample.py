"""CT volume preprocessing on the device: HU rescale -> trilinear resample to
(1.5, 0.75, 0.75) mm -> HU clip -> /1000 -> centre crop/pad to 240x480x480
with -1 fill.

Port of ct_clip_tpu/ops/resample.py::preprocess_volume.  The reference
defines the resample as torch `F.interpolate(mode="trilinear",
align_corners=False)` on the rescaled volume (scripts/data.py:24-31), and the
JAX package reproduces it with per-axis index maps; here it is that op
itself.  Clip before the resample is the inference ordering
(data_inference_nii.py:115-117), clip after it the training ordering
(data.py:122-123).  Numerics follow the exact f32 chain of the JAX package.

The patch-row ingest (`preprocess_to_patch_rows`, `preprocess_rows_into`)
ends with K6 (ops/patch_embed.py::rearrange_patches), so the scored step
starts from the model's (t*h*w, pt*p*p) patch rows.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PreprocessConfig
from .patch_embed import rearrange_patches


def _crop_pad(res: int, out: int) -> Tuple[int, int, int]:
    """(crop_start, size, pad_before) of one axis, as ops/resample.py
    `_axis_params` computes them."""
    crop_start = max((res - out) // 2, 0)
    size = min(crop_start + out, res) - crop_start
    return crop_start, size, (out - size) // 2


def preprocess_volume(vol: torch.Tensor, spacing_zxy: Sequence[float],
                      slope: float, intercept: float,
                      true_sizes: Optional[Sequence[int]] = None,
                      input_layout: str = "zxy",
                      out_dtype: Optional[torch.dtype] = None,
                      config: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """vol: raw voxels (Z, X, Y), or (Z, Y, X) with input_layout="zyx", on
    any device, possibly zero-padded beyond `true_sizes` (semantic (z, x, y)
    order).  Returns the `config.target_shape` (240, 480, 480) model input on
    vol's device."""
    if input_layout == "zyx":
        vol = vol.transpose(1, 2)
    elif input_layout != "zxy":
        raise ValueError(f"input_layout must be zxy or zyx, got {input_layout!r}")
    true = tuple(int(s) for s in (true_sizes if true_sizes is not None
                                  else vol.shape))
    v = vol[: true[0], : true[1], : true[2]].float() * float(slope) + float(intercept)
    if config.clip_before_resample:
        v = v.clamp(config.hu_min, config.hu_max)
    # new size = int(orig * current / target), in f32 as the JAX package does
    res = (np.asarray(true, np.float32) * np.asarray(spacing_zxy, np.float32)
           / np.asarray(config.target_spacing, np.float32)).astype(np.int32)
    res = [max(int(r), 1) for r in res]
    v = F.interpolate(v[None, None], size=res, mode="trilinear",
                      align_corners=False)[0, 0]
    if not config.clip_before_resample:
        v = v.clamp(config.hu_min, config.hu_max)
    v = v / config.norm_scale
    out = torch.full(config.target_shape, config.pad_value, dtype=torch.float32,
                     device=vol.device)
    (c0, n0, p0), (c1, n1, p1), (c2, n2, p2) = (
        _crop_pad(r, o) for r, o in zip(res, config.target_shape))
    out[p0:p0 + n0, p1:p1 + n1, p2:p2 + n2] = v[c0:c0 + n0, c1:c1 + n1, c2:c2 + n2]
    return out if out_dtype is None else out.to(out_dtype)


def preprocess_to_patch_rows(vol: torch.Tensor, spacing_zxy: Sequence[float],
                             slope: float, intercept: float,
                             true_sizes: Optional[Sequence[int]] = None,
                             input_layout: str = "zxy",
                             out_dtype: Optional[torch.dtype] = None,
                             config: PreprocessConfig = PreprocessConfig(),
                             temporal_patch_size: int = 10,
                             patch_size: int = 20) -> torch.Tensor:
    """`preprocess_volume` followed by K6: the (t*h*w, pt*p*p) patch rows of
    the model input, in the '(c pt p1 p2)' order of the reference's
    to_patch_emb.  Port of ct_clip_tpu/ops/resample.py::preprocess_to_patch_rows;
    the values are those of the volume, moved."""
    v = preprocess_volume(vol, spacing_zxy, slope, intercept, true_sizes,
                          input_layout, out_dtype, config)
    return rearrange_patches(v[None], temporal_patch_size, patch_size)[0]


def preprocess_rows_into(buf: torch.Tensor, slot: int, vol: torch.Tensor,
                         spacing_zxy: Sequence[float], slope: float,
                         intercept: float,
                         true_sizes: Optional[Sequence[int]] = None,
                         input_layout: str = "zxy",
                         config: PreprocessConfig = PreprocessConfig(),
                         temporal_patch_size: int = 10,
                         patch_size: int = 20) -> torch.Tensor:
    """`preprocess_to_patch_rows` fused with the batch assembly: K6 writes
    the volume's rows straight into `buf[slot]` of the (B, n, patch_dim)
    batch buffer, in the buffer's dtype, so no stacked copy of the batch is
    made.  Updates `buf` in place and returns it.  Port of
    ct_clip_tpu/ops/resample.py::preprocess_rows_into, which donates the
    buffer to the same effect."""
    v = preprocess_volume(vol, spacing_zxy, slope, intercept, true_sizes,
                          input_layout, buf.dtype, config)
    rearrange_patches(v[None], temporal_patch_size, patch_size,
                      out=buf[slot:slot + 1])
    return buf
