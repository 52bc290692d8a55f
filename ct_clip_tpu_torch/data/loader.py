"""Host-side parallel volume loader.

Copy of ct_clip_tpu/data/loader.py trimmed to `VolumeLoader` and `RawSample`
as zero-shot uses them (int16 voxels in the file's (Z, Y, X) order): reader
threads decode NIfTI files, pad each raw volume to a shape bucket (so
downstream shapes repeat) and yield them in dataset order through a bounded
prefetch window.  Shuffling and multi-host sharding are not ported.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

from .datasets import CTReportDatasetInfer, VolumeMeta

# Raw CT volumes are typically (Z, 512, 512) with Z in [100, 600]: round Z
# up to 64s and XY up to 128s.
BUCKET_Z = 64
BUCKET_XY = 128


def bucket_shape(shape: Sequence[int]) -> Tuple[int, int, int]:
    z, y, x = shape

    def up(v, m):
        return ((v + m - 1) // m) * m

    return (up(z, BUCKET_Z), up(y, BUCKET_XY), up(x, BUCKET_XY))


@dataclass
class RawSample:
    vol: np.ndarray            # (Z, Y, X), zero-padded to the bucket
    true_sizes: np.ndarray     # (3,) int32 actual extents, (z, y, x)
    spacing: np.ndarray        # (3,) f32 (z, x, y)
    slope: np.float32
    intercept: np.float32
    meta: VolumeMeta

    @property
    def true_sizes_zxy(self) -> np.ndarray:
        return self.true_sizes[[0, 2, 1]]


class VolumeLoader:
    """Iterates RawSamples with `num_workers` reader threads and a window of
    `prefetch` volumes in flight."""

    def __init__(self, dataset: CTReportDatasetInfer, num_workers: int = 8,
                 prefetch: int = 8):
        self.ds = dataset
        self.num_workers = num_workers
        self.prefetch = prefetch

    def _load(self, index: int) -> RawSample:
        vol, meta = self.ds.read_raw(index)
        true = np.asarray(vol.shape, np.int32)
        bshape = bucket_shape(vol.shape)
        if tuple(bshape) != vol.shape:
            padded = np.zeros(bshape, vol.dtype)
            padded[: vol.shape[0], : vol.shape[1], : vol.shape[2]] = vol
            vol = padded
        return RawSample(vol=vol, true_sizes=true,
                         spacing=np.asarray(meta.spacing_zxy, np.float32),
                         slope=np.float32(meta.slope),
                         intercept=np.float32(meta.intercept), meta=meta)

    def __iter__(self) -> Iterator[RawSample]:
        indices = iter(range(len(self.ds)))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = [pool.submit(self._load, i)
                       for _, i in zip(range(self.prefetch), indices)]
            while pending:
                fut = pending.pop(0)
                nxt = next(indices, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield fut.result()
