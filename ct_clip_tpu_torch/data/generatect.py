"""GenerateCT-style datasets (the transformer_maskgit data layer), numpy only.

Copy of ct_clip_tpu/data/generatect.py, which the port cannot import (every
ct_clip_tpu module imports JAX through its package):
  * `VideoTextDataset` (videotextdataset.py:25-135): NIfTI + per-accession
    JSON metadata (RescaleSlope/Intercept; Manufacturer == 'PNMS' flips the
    slice order) -> HU clip +-1000 -> /1000 -> resize to (num_frames=201,
    128, 128) with a separable trilinear resize (`resize_video`);
  * `VideoTextDatasetSuperres` (videotextdatasetsuperres.py): the same
    normalisation with a low-res (201, 128, 128) and a high-res
    (201, 512, 512) output;
  * `VideoDataset` (data.py:268-312): a NIfTI folder with the 100-600
    slice-count filter, yielding (f, H, W) float32 volumes, what the CTViT
    autoencoder trains on and `cli reconstruct` reads.
"""
from __future__ import annotations

import glob
import json
import os
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .nifti import load_header, read_volume


def torch_style_resize_1d(in_size: int, out_size: int):
    """align_corners=False linear resample indices and weights."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    lam = np.clip(src - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, lam


def resize_video(video: np.ndarray, out_shape: Tuple[int, int, int]) -> np.ndarray:
    """Separable trilinear resize (f, H, W) -> out_shape, matching
    F.interpolate(..., mode='trilinear', align_corners=False)."""
    out = video.astype(np.float32)
    for axis, target in enumerate(out_shape):
        if out.shape[axis] == target:
            continue
        i0, i1, lam = torch_style_resize_1d(out.shape[axis], target)
        a = np.take(out, i0, axis=axis)
        b = np.take(out, i1, axis=axis)
        shape = [1] * out.ndim
        shape[axis] = target
        lam = lam.reshape(shape)
        out = a * (1 - lam) + b * lam
    return out


@dataclass
class VideoTextSample:
    video: np.ndarray  # (f, H, W) float32 in [-1, 1]
    text: str
    path: str


class VideoTextDataset:
    """NIfTI + JSON-metadata + reports text, GenerateCT preprocessing."""

    def __init__(self, data_folder: str, num_frames: int = 201,
                 image_size: int = 128, reports: Optional[dict] = None,
                 min_slices: int = 20):
        self.num_frames = num_frames
        self.image_size = image_size
        self.reports = reports or {}
        self.samples: List[Tuple[str, Optional[str]]] = []
        for nii in sorted(glob.glob(os.path.join(data_folder, "**", "*.nii*"),
                                    recursive=True)):
            try:
                hdr = load_header(nii)
            except (OSError, EOFError, ValueError, zlib.error):  # not a NIfTI: skipped
                continue
            if len(hdr.shape) < 3 or hdr.shape[2] < min_slices:
                continue
            meta = Path(nii).with_suffix("").with_suffix(".json")
            self.samples.append((nii, str(meta) if meta.exists() else None))

    def __len__(self):
        return len(self.samples)

    def _normalized_frames(self, index: int) -> np.ndarray:
        """(Z, X, Y) HU-rescaled, PNMS-flipped, clipped, /1000 frames."""
        nii, meta_path = self.samples[index]
        vol, _hdr = read_volume(nii)  # (X, Y, Z)
        slope, intercept, flip = 1.0, 0.0, False
        if meta_path:
            with open(meta_path) as f:
                meta = json.load(f)
            slope = float(meta.get("RescaleSlope", 1.0))
            intercept = float(meta.get("RescaleIntercept", 0.0))
            # Manufacturer 'PNMS' stores slices reversed
            # (videotextdataset.py:100-106)
            flip = str(meta.get("Manufacturer", "")).upper() == "PNMS"
        img = vol * slope + intercept
        img = img.transpose(2, 0, 1)  # (Z, X, Y) = frames first
        if flip:
            img = img[::-1]
        return np.clip(img, -1000, 1000) / 1000.0

    def __getitem__(self, index: int) -> VideoTextSample:
        nii, _ = self.samples[index]
        img = self._normalized_frames(index)
        video = resize_video(img, (self.num_frames, self.image_size,
                                   self.image_size))
        name = os.path.basename(nii)
        return VideoTextSample(video=video.astype(np.float32),
                               text=self.reports.get(name, ""), path=nii)


class VideoTextDatasetSuperres(VideoTextDataset):
    """Paired low-res/high-res outputs (videotextdatasetsuperres.py:135)."""

    def __init__(self, data_folder: str, num_frames: int = 201,
                 low_size: int = 128, high_size: int = 512, **kw):
        super().__init__(data_folder, num_frames, low_size, **kw)
        self.high_size = high_size

    def __getitem__(self, index: int):
        nii, _ = self.samples[index]
        low = super().__getitem__(index)
        # the high-res view goes through the same slope/intercept/flip/clip
        # normalization as the low-res one; only the target size differs
        img = self._normalized_frames(index)
        high = resize_video(img, (self.num_frames, self.high_size,
                                  self.high_size)).astype(np.float32)
        return low, VideoTextSample(video=high, text=low.text, path=nii)


class VideoDataset:
    """Generic NIfTI folder with the 100-600 slice-count filter
    (transformer_maskgit/data.py:268-312)."""

    def __init__(self, folder: str, num_frames: int = 201,
                 image_size: int = 128, min_slices: int = 100,
                 max_slices: int = 600):
        self.inner = VideoTextDataset(folder, num_frames, image_size,
                                      min_slices=0)
        keep = []
        for nii, meta in self.inner.samples:
            z = load_header(nii).shape[2]
            if min_slices <= z <= max_slices:
                keep.append((nii, meta))
        self.inner.samples = keep

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.inner[index].video
