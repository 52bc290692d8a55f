"""Build, load, launch and count the hand-written Hopper kernels.

The CUDA sources live in `ct_clip_tpu_torch/csrc/`.  On first use each is
compiled with its own `nvcc` for `sm_90a`, all at once, and the objects are
linked into one shared library with a plain C interface, placed in
`build/ct_clip_tpu_torch/` at the root of the checkout and named by a hash of
the sources and flags, then loaded with `ctypes`.
Nothing is compiled or loaded at import time: the CPU tests import every
module on a machine with no `nvcc`.

The launch helpers below take tensors, check device, dtype, shape and
layout, pass raw pointers and PyTorch's current stream, and raise when the
C entry point reports a CUDA error.  Outputs are allocated by the callers
(the op modules) with `torch.empty`.

Launch counts: each op module that ports a TPU kernel adds one to its
counter (`count_launch`) where its CUDA path runs, so a run can show that
its main path went through the kernels (`launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ct_clip_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# One counter per ported TPU kernel (ct_clip_tpu/ops/pallas/...):
KERNELS = (
    "patch_embed",         # K8 patchify.py::fused_patch_embed
    "spatial_attention",   # K1 spatial_attention.py::fused_spatial_qknorm_attention
    "grid_attention",      # K2 small_attention.py::fused_small_qknorm_attention_grid
    "geglu_ff",            # K3 ffn.py::fused_geglu_ff
    "vq_assign",           # K5 vq.py::pallas_assign
    "fused_attention",     # K7 attention.py::fused_attention
    "rearrange_patches",   # K6 patchify.py::rearrange_patches
    "row_embed",           # K4 patchify.py::fused_row_embed
)
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

EPI_STORE, EPI_RESIDUAL, EPI_BIAS_ROUNDED, EPI_GEGLU = 0, 1, 2, 3

_lib = None
_lock = threading.Lock()


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _cu_sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are compiled on the machine with the card")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libct_clip_kernels_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless the current sources
    are already built: one `nvcc -c` per source, all started together, then
    one link.  Writes the compiler's output (register and shared memory use
    from -Xptxas -v) beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc, logs = _nvcc(), []

    def run(procs):
        failed = None
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed with code {proc.returncode}:\n{stderr[-6000:]}"
        out.with_suffix(".log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(failed)

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _cu_sources()]
    try:
        run([start([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
             for src, obj in zip(_cu_sources(), objs)])
        tmp = out.with_name(f"{tag}.so.tmp")
        run([start([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])])
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _declare(lib) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.ct_gemm.argtypes = [i, p, i, p, p, i, i, i, i, p, i, p, i, p, i, p]
    lib.ct_gemm_argmax.argtypes = [p, i, p, i, i, i, i, p, i, p]
    lib.ct_layernorm.argtypes = [p, i, i, p, p, f, p, p]
    lib.ct_patch_layernorm.argtypes = [p, i, i, i, i, i, i, p, p, f, p, p]
    lib.ct_attention.argtypes = [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll,
                                 i, i, i, i, i, p, p, p, i, i, p]
    lib.ct_rearrange_patches.argtypes = [p, i, i, i, i, i, i, p, ll, ll, i, p]
    lib.ct_error_string.argtypes = [i]
    lib.ct_error_string.restype = ctypes.c_char_p
    for name in ("ct_gemm", "ct_gemm_argmax", "ct_layernorm",
                 "ct_patch_layernorm", "ct_attention", "ct_rearrange_patches"):
        getattr(lib, name).restype = ctypes.c_int


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


# ------------------------------------------------------------ launch helpers
def _check(err: int, name: str) -> None:
    if err != 0:
        msg = library().ct_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            contiguous: bool = True) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _rows_ok(t: torch.Tensor) -> bool:
    """16-byte loads: rows of a multiple of 8 bf16 on a 16-byte boundary."""
    return t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0


def gemm(epi: int, a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
         w2: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[m, n] = epilogue(sum_k a[m, k] * w[n, k]) (gemm.cu)."""
    bf = torch.bfloat16
    require(a, "a", bf, 2, contiguous=False)
    require(w, "w", bf, 2)
    require(out, "out", bf, 2, contiguous=False)
    if a.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError("gemm: rows of a and out must be contiguous")
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K or out.shape != (M, N):
        raise ValueError(f"gemm: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)}")
    if epi == EPI_GEGLU and (w2 is None or w2.shape != w.shape
                             or w2.stride() != w.stride()):
        raise ValueError("gemm: GEGLU needs a second weight like the first")
    if epi == EPI_RESIDUAL:
        require(residual, "residual", bf, 2, contiguous=False)
        if residual.shape != (M, N) or residual.stride(1) != 1:
            raise ValueError("gemm: residual must match out")
    if epi == EPI_BIAS_ROUNDED:
        require(bias, "bias", bf, 1)
        if bias.shape[0] != N:
            raise ValueError("gemm: bias must have N entries")
    vec = (K % 8 == 0 and _rows_ok(a) and _rows_ok(w)
           and (w2 is None or _rows_ok(w2)))
    err = library().ct_gemm(
        epi, _ptr(a), a.stride(0), _ptr(w), _ptr(w2), w.stride(0), M, N, K,
        _ptr(out), out.stride(0), _ptr(residual),
        residual.stride(0) if residual is not None else 0, _ptr(bias),
        int(vec), _stream())
    _check(err, "ct_gemm")
    return out


def gemm_argmax(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmax_n sum_k a[m, k] * w[n, k] as int32 (gemm.cu)."""
    bf = torch.bfloat16
    require(a, "a", bf, 2)
    require(w, "w", bf, 2)
    M, K = a.shape
    if w.shape[1] != K:
        raise ValueError("gemm_argmax: a and w disagree on K")
    ids = torch.empty((M,), dtype=torch.int32, device=a.device)
    vec = K % 8 == 0 and _rows_ok(a) and _rows_ok(w)
    err = library().ct_gemm_argmax(_ptr(a), a.stride(0), _ptr(w), w.stride(0),
                                   M, w.shape[0], K, _ptr(ids), int(vec),
                                   _stream())
    _check(err, "ct_gemm_argmax")
    return ids


def _f32_vector(t: Optional[torch.Tensor], n: int, name: str):
    if t is None:
        return None
    t = t.to(torch.float32).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{name}: expected ({n},), got {tuple(t.shape)}")
    return t


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float,
              out: torch.Tensor) -> torch.Tensor:
    """Row LN of a contiguous (rows, D) bf16 tensor (layernorm.cu)."""
    require(x, "x", torch.bfloat16, 2)
    require(out, "out", torch.bfloat16, 2)
    rows, D = x.shape
    if out.shape != x.shape or D > 4096:
        raise ValueError(f"layernorm: bad shapes {tuple(x.shape)}")
    scale, bias = _f32_vector(scale, D, "scale"), _f32_vector(bias, D, "bias")
    err = library().ct_layernorm(_ptr(x), rows, D, _ptr(scale), _ptr(bias),
                                 float(eps), _ptr(out), _stream())
    _check(err, "ct_layernorm")
    return out


def patch_layernorm(video: torch.Tensor, pt: int, p: int,
                    scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W) video -> LN over each (pt, p, p) patch (layernorm.cu)."""
    require(video, "video", torch.bfloat16, 4)
    require(out, "out", torch.bfloat16, 2)
    B, F, H, W = video.shape
    D = pt * p * p
    if F % pt or H % p or W % p or D > 4096:
        raise ValueError(f"patch_layernorm: {tuple(video.shape)} vs {pt}x{p}x{p}")
    if out.shape != (B * (F // pt) * (H // p) * (W // p), D):
        raise ValueError("patch_layernorm: bad out shape")
    scale, bias = _f32_vector(scale, D, "scale"), _f32_vector(bias, D, "bias")
    err = library().ct_patch_layernorm(_ptr(video), B, F, H, W, pt, p,
                                       _ptr(scale), _ptr(bias), float(eps),
                                       _ptr(out), _stream())
    _check(err, "ct_patch_layernorm")
    return out


def rearrange_patches(video: torch.Tensor, pt: int, p: int,
                      out: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W) video -> out (B, t*h*w, pt*p*p) patch rows (rearrange.cu).

    `out` may be a view, such as one slot of a batch buffer: its rows must
    be contiguous and must not overlap."""
    bf = torch.bfloat16
    require(video, "video", bf, 4)
    require(out, "out", bf, 3, contiguous=False)
    B, F, H, W = video.shape
    if F % pt or H % p or W % p:
        raise ValueError(f"rearrange_patches: {tuple(video.shape)} vs {pt}x{p}x{p}")
    n, pd = (F // pt) * (H // p) * (W // p), pt * p * p
    sb, sr, se = out.stride()
    if out.shape != (B, n, pd) or se != 1 or sr < pd or (B > 1 and sb < n * sr):
        raise ValueError(f"rearrange_patches: out {tuple(out.shape)} with strides "
                         f"{out.stride()} is not ({B}, {n}, {pd}) rows")
    vec = (W % 8 == 0 and (p * p) % 8 == 0 and sb % 8 == 0 and sr % 8 == 0
           and video.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = library().ct_rearrange_patches(_ptr(video), B, F, H, W, pt, p,
                                         _ptr(out), sb, sr, int(vec), _stream())
    _check(err, "ct_rearrange_patches")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, *, sequences: int, inner: int, heads: int,
              n: int, d: int, q_strides, kv_strides,
              q_scale: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, bias_mode: int = 0,
              warps: int = 8) -> torch.Tensor:
    """softmax(q k^T + bias) v per (sequence, head) (attention.cu).

    q/out and k/v are addressed through (outer, inner, head, token) element
    strides; their last dim must be contiguous.  The caller checks that the
    strides stay inside the tensors."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        require(t, name, torch.bfloat16, t.dim(), contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"attention: last dim of {name} must be contiguous")
    if d % 2 or d > 128:
        raise ValueError(f"attention: head dim {d} must be even and <= 128")
    qs = _f32_vector(q_scale, d, "q_scale")
    ks = _f32_vector(k_scale, d, "k_scale")
    if (qs is None) != (ks is None):
        raise ValueError("attention: pass both q_scale and k_scale or neither")
    if bias is not None:
        require(bias, "bias", torch.float32, bias.dim())
        want = (heads, n, n) if bias_mode == 1 else (sequences, n)
        if tuple(bias.shape) != want:
            raise ValueError(f"attention: bias {tuple(bias.shape)} != {want}")
    elif bias_mode:
        raise ValueError("attention: bias_mode needs a bias")
    err = library().ct_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), *map(int, q_strides),
        *map(int, kv_strides), inner, sequences, heads, n, d, _ptr(qs),
        _ptr(ks), _ptr(bias), bias_mode, warps, _stream())
    _check(err, "ct_attention")
    return out
