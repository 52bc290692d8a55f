"""Minimal NIfTI-1 reader/writer, pure numpy.

Copy of ct_clip_tpu/data/nifti.py on its numpy path (the C++ reader in
ct_clip_tpu/native is not ported yet).  Covers what the reference uses
nibabel for: `nib.load(...).get_fdata()` (scripts/data.py:93-94) and writing
volumes.  Handles .nii and .nii.gz, both endiannesses, the common scalar
dtypes, and header scl_slope/scl_inter scaling like nibabel's get_fdata.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

HEADER_SIZE = 348

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiHeader:
    shape: Tuple[int, ...]
    dtype: np.dtype
    pixdim: Tuple[float, ...]       # (x, y, z) voxel sizes in mm
    scl_slope: float
    scl_inter: float
    vox_offset: int
    byteorder: str                  # '<' or '>'


def _read_header(raw: bytes) -> NiftiHeader:
    if len(raw) < HEADER_SIZE:
        raise ValueError("truncated NIfTI header")
    for bo in ("<", ">"):
        (sizeof_hdr,) = struct.unpack(bo + "i", raw[0:4])
        if sizeof_hdr == HEADER_SIZE:
            break
    else:
        raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    dim = struct.unpack(bo + "8h", raw[40:56])
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack(bo + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    pixdim = struct.unpack(bo + "8f", raw[76:108])
    (vox_offset,) = struct.unpack(bo + "f", raw[108:112])
    scl_slope, scl_inter = struct.unpack(bo + "2f", raw[112:120])
    return NiftiHeader(shape=shape, dtype=np.dtype(_DTYPES[datatype]),
                       pixdim=tuple(pixdim[1:4]), scl_slope=scl_slope,
                       scl_inter=scl_inter,
                       vox_offset=int(vox_offset) if vox_offset else HEADER_SIZE + 4,
                       byteorder=bo)


def _read_bytes(path: str | Path) -> bytes:
    data = Path(path).read_bytes()
    if data[:2] == b"\x1f\x8b":  # gzip magic
        data = gzip.decompress(data)
    return data


def load_header(path: str | Path) -> NiftiHeader:
    return _read_header(_read_bytes(path)[:HEADER_SIZE])


def read_volume(path: str | Path, apply_scaling: bool = True,
                dtype=np.float32,
                layout: str = "xyz") -> Tuple[np.ndarray, NiftiHeader]:
    """Returns (volume, header); volume shape = header.shape in Fortran
    (x-fastest) order, matching nibabel's array layout.  With apply_scaling,
    values are scl_slope * raw + scl_inter when slope != 0 (get_fdata).

    `layout="zyx"` returns the reversed-axes C-contiguous view of the same
    buffer (an F-order (X, Y, Z) file is a C-order (Z, Y, X) array), with
    no copy when dtype matches the stored dtype."""
    if layout not in ("xyz", "zyx"):
        raise ValueError(f"bad layout {layout!r}")
    raw = _read_bytes(path)
    hdr = _read_header(raw[:HEADER_SIZE])
    count = int(np.prod(hdr.shape))
    dt = hdr.dtype.newbyteorder(hdr.byteorder)
    arr = np.frombuffer(raw, dtype=dt, count=count, offset=hdr.vox_offset)
    if layout == "zyx":
        vol = arr.reshape(hdr.shape[::-1]).astype(dtype, copy=False)
    else:
        vol = arr.reshape(hdr.shape, order="F").astype(dtype, copy=False)
    if apply_scaling and hdr.scl_slope not in (0.0,) and not np.isnan(hdr.scl_slope):
        if hdr.scl_slope != 1.0 or hdr.scl_inter != 0.0:
            vol = vol * dtype(hdr.scl_slope) + dtype(hdr.scl_inter)
    return vol, hdr


def write_volume(path: str | Path, vol: np.ndarray,
                 pixdim: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a 3D volume as .nii or .nii.gz (tensor_to_nifti equivalent,
    transformer_maskgit/data.py:105-125)."""
    path = Path(path)
    vol = np.asarray(vol)
    if vol.dtype not in _CODES:
        vol = vol.astype(np.float32)
    code = _CODES[np.dtype(vol.dtype)]

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dims = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    pd = [1.0] + list(pixdim) + [0.0] * (7 - len(pixdim))
    struct.pack_into("<8f", hdr, 76, *pd[:8])
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + vol.tobytes(order="F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload, compresslevel=1))
    else:
        path.write_bytes(payload)
