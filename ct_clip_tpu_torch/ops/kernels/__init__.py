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
counter (`count_launch`) where its CUDA path runs, and a launch helper that
chooses between kernels counts the one it launched (`qk_attention_tc_bwd`,
`qk_attention_tc32_bwd`),
so a run can show that its main path went through the kernels
(`launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
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
    "fused_attention",     # K7 attention.py::fused_attention (bf16 and f32)
    "rearrange_patches",   # K6 patchify.py::rearrange_patches
    "row_embed",           # K4 patchify.py::fused_row_embed
    "attention_bwd",       # K12a attention.py::_pallas_attention_bwd_kbias (a key bias)
    "attention_dropout",   # K13 attention.py::_pallas_attention_kbias_drop_impl
    "attention_dropout_bwd",  # K13 attention.py::_pallas_attention_kbias_drop_bwd
    "geglu_ff_bwd",        # K11 ffn.py::_pallas_ff_bwd
    "spatial_attention_bwd",  # K9 spatial_attention.py::_pallas_spatial_bwd
    "grid_attention_bwd",  # K10 small_attention.py::_pallas_small_qknorm_bwd (grid)
    "peg_bwd",             # K14 peg.py::_pallas_peg_bwd
    "vq_cluster_stats",    # K15 vq.py::pallas_cluster_stats
    "vq_assign_exact",     # K5 vq.py::pallas_assign(exact=True)
    "patch_embed_bwd",     # K16a patchify.py::_pallas_patch_embed_bwd
    "row_embed_bwd",       # K16b patchify.py::_pallas_row_embed_bwd
    "unrearrange_patches",  # K17 patchify.py::_pallas_unrearrange
    "seq_attention",       # K2 small_attention.py::fused_small_qknorm_attention
    "seq_attention_bwd",   # K10 small_attention.py::_pallas_small_qknorm_bwd (sequence-major)
    "attention_dense",     # K7 attention.py::_pallas_attention, dense (1, 1|h, n, n) bias
    "attention_dense_bwd",  # K12b attention.py::_pallas_attention_bwd, dense bias or none
                            # (the TokenCritic's, XLA in JAX), on every route
    # the source that ran, counted beside the function's own counter:
    # attention_tc.cu's bf16 tensor-core kernels
    "attention_tc",        # every forward there: K7, any bias form (fused_attention,
                           # attention_dense), K13a, key bias and dropout
                           # (attention_dropout)
    "attention_tc_bwd",    # every backward there: K12b, dense bias or none
                           # (attention_dense_bwd), K12a, key bias (attention_bwd),
                           # K13b, key bias and dropout (attention_dropout_bwd)
    # attention_tc32.cu's f32 3xTF32 kernels at head dim 64
    "attention_tc32",      # every f32 forward there: K7, any bias form (fused_attention,
                           # attention_dense), K13a, key bias and dropout
                           # (attention_dropout)
    "attention_tc32_bwd",  # every f32 backward there: K12b, dense bias or none
                           # (attention_dense_bwd), K12a, key bias (attention_bwd),
                           # K13b, key bias and dropout (attention_dropout_bwd)
    # qknorm_attention_tc.cu's bf16 tensor-core core of the QK-norm backward
    "qk_attention_tc_bwd",  # K9 where `qk_bwd_tensor_cores` gives QK_WGMMA
                            # (spatial_attention_bwd)
    # qknorm_attention_tc32.cu's f32 3xTF32 core of the QK-norm backward
    "qk_attention_tc32_bwd",  # K9 f32 where `qk_bwd_tensor_cores` gives QK_TC32
                              # (spatial_attention_bwd, spatial_attention_bwd_f32)
    # ffn_tc.cu's bf16 K11 on the tensor cores (`wgmma`), beside geglu_ff_bwd
    "ff_tc_tile",          # the tile: a, g, dact and the GEGLU derivative (one a call)
    "ff_tc_gemm",          # its products: dxn (NN), [dwa; dwg] and dwo (TN), three a call
    # the f32 forms, counted beside the function's own counter
    "geglu_ff_f32",        # K3 f32 (gemm.cu f32 products, layernorm.cu f32 rows)
    "geglu_ff_bwd_f32",    # K11 f32
    "spatial_attention_f32",  # K1 f32 (attention.cu attention_f32_kernel)
    "grid_attention_f32",  # K2 grid f32
    "seq_attention_f32",   # K2 seq f32
    "vq_assign_f32",       # K5 on f32 rows (gemm.cu gemm_argmax_kernel's f32-row form)
    "rearrange_patches_f32",  # K6 f32 (rearrange.cu)
    "unrearrange_patches_f32",  # K17 f32
    "spatial_attention_bwd_f32",  # K9 f32 (qknorm_attention_bwd.cu qk_attention_bwd_f32_kernel)
    "grid_attention_bwd_f32",  # K10 grid f32
    "seq_attention_bwd_f32",  # K10 seq f32
    "vq_assign_exact_f32",  # K5 exact on f32 rows (gemm.cu gemm_argmax3_rows_kernel)
    "vq_cluster_stats_f32",  # K15 on f32 rows (vq_stats.cu sum_f32_kernel)
    # the plain routes where the JAX package runs XLA in f32 (`ROUTES`)
    "patch_embed_plain",   # K8 / K16a f32: patch_embed_plain and its autograd
    "row_embed_plain",     # K4 / K16b f32: row_embed_plain and its autograd
    "peg_dw_plain",        # K14 f32: peg_dw_plain
    # K5 (either mode) and K15 on f32 rows of shapes vq.py's _plan refuses
    # (ops/vq.py::vq_route): vq_assign_plain, cluster_stats_plain
    "vq_assign_plain",
    "vq_cluster_stats_plain",
)
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

BF16, F32 = torch.bfloat16, torch.float32
KERNEL, PLAIN, RAISES = "kernel", "plain", "raises"
# What a CUDA tensor of each dtype takes, op by op: its kernel, or its plain
# version (where the JAX package's dispatch gates the Pallas kernel to bf16
# and runs XLA in f32: patchify.py:440, 685, 700, 714 and peg.py:106); any
# other dtype a ValueError.  K5 and K15 on f32 rows also follow the shape
# test of vq.py's _plan (ops/vq.py::vq_route).  Nothing gives way quietly.
ROUTES = {
    "patch_embed": {BF16: KERNEL, F32: PLAIN},         # K8
    "patch_embed_bwd": {BF16: KERNEL, F32: PLAIN},     # K16a
    "row_embed": {BF16: KERNEL, F32: PLAIN},           # K4
    "row_embed_bwd": {BF16: KERNEL, F32: PLAIN},       # K16b
    "peg_bwd": {BF16: KERNEL, F32: PLAIN},             # K14
    "geglu_ff": {BF16: KERNEL, F32: KERNEL},           # K3
    "geglu_ff_bwd": {BF16: KERNEL, F32: KERNEL},       # K11
    "spatial_attention": {BF16: KERNEL, F32: KERNEL},  # K1
    "grid_attention": {BF16: KERNEL, F32: KERNEL},     # K2 grid
    "seq_attention": {BF16: KERNEL, F32: KERNEL},      # K2 seq
    "vq_assign": {BF16: KERNEL, F32: KERNEL},          # K5 (f32: where vq.py's _plan takes it)
    "rearrange_patches": {BF16: KERNEL, F32: KERNEL},  # K6
    "unrearrange_patches": {BF16: KERNEL, F32: KERNEL},  # K17
    "spatial_attention_bwd": {BF16: KERNEL, F32: KERNEL},  # K9
    "grid_attention_bwd": {BF16: KERNEL, F32: KERNEL},  # K10 grid
    "seq_attention_bwd": {BF16: KERNEL, F32: KERNEL},  # K10 seq
    "vq_assign_exact": {BF16: KERNEL, F32: KERNEL},    # K5 exact
    "vq_cluster_stats": {BF16: KERNEL, F32: KERNEL},   # K15
}


def route(op: str, dtype: torch.dtype) -> str:
    """KERNEL, PLAIN or RAISES: what a CUDA tensor of `dtype` takes for
    `op` (`ROUTES`; any other dtype raises)."""
    return ROUTES[op].get(dtype, RAISES)


def not_ported(op: str, dtype: torch.dtype) -> ValueError:
    """The error of a RAISES route."""
    return ValueError(f"{op}: no CUDA kernel takes {dtype} here; the kernels take "
                      "torch.bfloat16 and torch.float32 (kernels.ROUTES)")

EPI_STORE, EPI_RESIDUAL, EPI_BIAS_ROUNDED, EPI_GEGLU = 0, 1, 2, 3

_lib = None
_lock = threading.Lock()


def count_launch(name: str, dtype: Optional[torch.dtype] = None) -> None:
    """One launch of `name`; with dtype f32 its f32 form's counter too."""
    _launches[name] += 1
    if dtype == torch.float32:
        _launches[f"{name}_f32"] += 1


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


def _signatures():
    """argtypes of every C entry point, each of which returns an int."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lp, u = ctypes.POINTER(ll), ctypes.c_uint
    return {
        "ct_gemm": [i, p, i, p, p, i, i, i, i, p, i, p, i, p, i, p],
        "ct_gemm_argmax": [p, i, p, i, i, i, i, p, i, p],
        "ct_gemm_f32": [i, p, i, p, p, i, i, i, i, p, i, p, i, p, i, p],
        "ct_gemm_argmax_rows": [p, i, p, i, i, i, i, p, i, p],
        "ct_layernorm_f32": [p, i, i, p, p, f, p, p],
        "ct_attention_f32": [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, i, p, p, p,
                             i, p],
        "ct_rearrange_patches_f32": [p, i, i, i, i, i, i, p, ll, ll, i, p],
        "ct_unrearrange_patches_f32": [p, ll, ll, i, i, i, i, i, i, p, i, p],
        "ct_gemm_layout_f32": [i, i, p, i, p, i, i, i, i, i, p, i, ll, i, p],
        "ct_ff_bwd_f32": [p, p, i, p, p, p, i, i, i, i, p, i, p, i, i, p],
        "ct_layernorm_bwd_f32": [p, i, i, p, p, p, p, f, p, p, p, p, i, p],
        "ct_layernorm": [p, i, i, p, p, f, p, p],
        "ct_patch_layernorm": [p, i, i, i, i, i, i, p, p, f, p, p],
        "ct_attention": [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, i, p, p, p, i,
                         p],
        "ct_rearrange_patches": [p, i, i, i, i, i, i, p, ll, ll, i, p],
        "ct_unrearrange_patches": [p, ll, ll, i, i, i, i, i, i, p, i, p],
        "ct_attn_train_fwd": [i, p, p, p, p, p, lp, p, p, i, p, p, u, f, i, i, i, i, p],
        "ct_attn_train_bwd": [i, p, p, p, p, p, p, p, p, p, lp, p, p, i, p, p, p, p, p, p, p, u,
                              f, i, i, i, i, p],
        "ct_attn_tc_fwd": [p, p, p, p, lp, p, p, i, p, p, u, f, i, i, i, p],
        "ct_attn_tc_bwd": [p, p, p, p, p, p, p, lp, p, p, i, p, p, p, p, p, p, p, u, f, i, i, i,
                           p],
        "ct_attn_tc32_fwd": [p, p, p, p, lp, p, p, i, p, p, u, f, i, i, i, p],
        "ct_attn_tc32_bwd": [p, p, p, p, p, p, p, p, lp, p, p, i, p, p, p, p, p, p, p, u, f, i,
                             i, i, p],
        "ct_gemm_argmax2": [p, i, p, p, i, i, i, i, p, i, p],
        "ct_gemm_argmax2_rows": [p, i, p, p, i, i, i, i, p, i, p],
        "ct_gemm_layout": [i, i, p, i, p, i, i, i, i, i, p, i, ll, i, p],
        "ct_sum_splits": [p, i, ll, p, p],
        "ct_ff_tc_tile": [p, p, i, p, p, p, i, i, i, i, p, i, p, i, p],
        "ct_ff_tc_gemm": [i, p, i, p, i, i, i, i, i, p, i, ll, p],
        "ct_layernorm_bwd": [p, i, i, p, p, p, p, f, p, p, p, p, i, p],
        "ct_patch_layernorm_bwd": [p, i, i, i, i, i, i, p, p, f, p, p, p, i, p],
        "ct_qk_attention_bwd": [p, p, p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i,
                                i, i, i, p, p, p, p, p, p, p, i, p],
        "ct_qk_attention_bwd_f32": [p, p, p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i,
                                    i, i, i, i, p, p, p, p, p, p, p, i, p],
        "ct_qk_attention_tc_bwd": [p, p, p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i,
                                   i, i, i, p, p, p, p, p, p, p, p, p, p, i, p, p, p],
        "ct_qk_attention_tc32_bwd": [p, p, p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i,
                                     i, i, i, i, p, p, p, p, p, p, p, p, p, p, i, p, p, p],
        "ct_peg_dw": [p, p, i, i, i, i, i, i, i, i, p, p],
        "ct_vq_cluster_stats": [p, p, i, i, i, p, p, p, p, p, p, p],
        "ct_vq_cluster_stats_f32": [p, p, i, i, i, p, p, p, p, p, p, p],
    }


def _declare(lib) -> None:
    """Types of every entry point `lib` exports (a copy built from one source
    exports that source's alone)."""
    for name, args in _signatures().items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    if hasattr(lib, "ct_error_string"):
        lib.ct_error_string.argtypes = [ctypes.c_int]
        lib.ct_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def copy_library(source: str, **defines: int):
    """A one-change copy for the card checks: csrc/`source` built alone with
    `-D name=value` for each of `defines` (e.g. attention_tc32.cu with
    CT_TC32_PASSES=1, plain TF32) into its own library beside the package's,
    loaded and typed.  The package never launches from it."""
    flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.read_bytes())
    out = BUILD_DIR / f"copy_{Path(source).stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-shared", "-o", str(tmp),
                               str(CSRC / source)], capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-6000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib


# ------------------------------------------------------------ launch helpers
def _check(err: int, name: str) -> None:
    if err != 0:
        msg = library().ct_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream() -> int:
    """The current device's current CUDA stream as an address, by the
    binding PyTorch's own generated launchers read it with
    (torch/_dynamo/device_interface.py), without building a
    torch.cuda.Stream, which costs ~8 us of host time a call (NVIDIA H100
    80GB HBM3; tools/port_attention_tc_probe.py --kernel k17): as much as a
    small kernel.  A PyTorch that lacks the private binding takes the public
    call."""
    raw, device = (getattr(torch._C, name, None)
                   for name in ("_cuda_getCurrentRawStream", "_cuda_getDevice"))
    if raw is None or device is None:  # a PyTorch without the binding
        return torch.cuda.current_stream().cuda_stream
    return raw(device())


def require(t: torch.Tensor, name: str, dtype, ndim: int,
            contiguous: bool = True) -> None:
    """`dtype`: the one dtype the kernel takes, or a tuple of its forms'."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


FORMS = (BF16, F32)  # the element types of the kernels with an f32 form


def _chunk(t: torch.Tensor) -> int:
    """Elements per 16-byte access."""
    return 16 // t.element_size()


def _rows_ok(t: torch.Tensor) -> bool:
    """16-byte loads: rows of a multiple of 16 bytes on a 16-byte boundary."""
    return t.stride(0) % _chunk(t) == 0 and t.data_ptr() % 16 == 0


def _form(name: str, t: torch.Tensor):
    """The C entry point `name`, or its f32 form `name`_f32 for an f32 t."""
    return getattr(library(), f"{name}_f32" if t.dtype == F32 else name)


def _same_form(a: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.dtype != a.dtype:
            raise ValueError(f"{name}: expected {a.dtype} like the first operand, got {t.dtype}")


def gemm(epi: int, a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
         w2: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[m, n] = epilogue(sum_k a[m, k] * w[n, k]) (gemm.cu); every
    operand bf16 (WMMA) or every operand f32 (the f32 form, FFMA)."""
    dt = a.dtype
    require(a, "a", FORMS, 2, contiguous=False)
    require(w, "w", dt, 2)
    require(out, "out", dt, 2, contiguous=False)
    if a.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError("gemm: rows of a and out must be contiguous")
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K or out.shape != (M, N):
        raise ValueError(f"gemm: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)}")
    if epi == EPI_GEGLU and (w2 is None or w2.shape != w.shape or w2.dtype != dt
                             or w2.stride() != w.stride()):
        raise ValueError("gemm: GEGLU needs a second weight like the first")
    if epi == EPI_RESIDUAL:
        require(residual, "residual", dt, 2, contiguous=False)
        if residual.shape != (M, N) or residual.stride(1) != 1:
            raise ValueError("gemm: residual must match out")
    if epi == EPI_BIAS_ROUNDED:
        require(bias, "bias", dt, 1)
        if bias.shape[0] != N:
            raise ValueError("gemm: bias must have N entries")
    vec = (K % _chunk(a) == 0 and _rows_ok(a) and _rows_ok(w)
           and (w2 is None or _rows_ok(w2)))
    err = _form("ct_gemm", a)(
        epi, _ptr(a), a.stride(0), _ptr(w), _ptr(w2), w.stride(0), M, N, K,
        _ptr(out), out.stride(0), _ptr(residual),
        residual.stride(0) if residual is not None else 0, _ptr(bias),
        int(vec), _stream())
    _check(err, "ct_gemm")
    return out


def gemm_argmax(a: torch.Tensor, w: torch.Tensor,
                w_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax_n sum_k a[m, k] * w[n, k] as int32 (gemm.cu); with `w_lo`, the
    similarities are a w^T + a w_lo^T (w and w_lo the bf16 hi and lo parts of
    one codebook).  f32 rows `a` (K5 on f32 rows): each row l2-normalised in
    f32 as the kernel loads it, then rounded to bf16 and taken against the
    bf16 codebook `w`, or with `w_lo` (K5 exact) split into bf16 hi + lo
    parts xh + xl and taken as (xh w^T + xh w_lo^T) + xl w^T."""
    bf = torch.bfloat16
    require(a, "a", FORMS, 2)
    require(w, "w", bf, 2)
    M, K = a.shape
    if w.shape[1] != K:
        raise ValueError("gemm_argmax: a and w disagree on K")
    ids = torch.empty((M,), dtype=torch.int32, device=a.device)
    vec = K % 8 == 0 and _rows_ok(a) and _rows_ok(w)
    if a.dtype == F32 and w_lo is not None:
        require(w_lo, "w_lo", bf, 2)
        if w_lo.shape != w.shape:
            raise ValueError("gemm_argmax: w_lo must match w")
        err = library().ct_gemm_argmax2_rows(_ptr(a), a.stride(0), _ptr(w), _ptr(w_lo),
                                             w.stride(0), M, w.shape[0], K, _ptr(ids),
                                             int(vec and _rows_ok(w_lo)), _stream())
    elif a.dtype == F32:
        err = library().ct_gemm_argmax_rows(_ptr(a), a.stride(0), _ptr(w), w.stride(0), M,
                                            w.shape[0], K, _ptr(ids), int(vec), _stream())
    elif w_lo is None:
        err = library().ct_gemm_argmax(_ptr(a), a.stride(0), _ptr(w), w.stride(0),
                                       M, w.shape[0], K, _ptr(ids), int(vec),
                                       _stream())
    else:
        require(w_lo, "w_lo", bf, 2)
        if w_lo.shape != w.shape:
            raise ValueError("gemm_argmax: w_lo must match w")
        err = library().ct_gemm_argmax2(_ptr(a), a.stride(0), _ptr(w), _ptr(w_lo),
                                        w.stride(0), M, w.shape[0], K, _ptr(ids),
                                        int(vec and _rows_ok(w_lo)), _stream())
    _check(err, "ct_gemm_argmax")
    return ids


def _vec_ok(*tensors) -> bool:
    """16-byte loads: every row stride and row length a multiple of 16
    bytes and every base on a 16-byte boundary."""
    return all(t.stride(0) % _chunk(t) == 0 and t.shape[1] % _chunk(t) == 0
               and t.data_ptr() % 16 == 0 for t in tensors)


def _rows_contig(t: torch.Tensor, name: str) -> None:
    require(t, name, FORMS, 2, contiguous=False)
    if t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")


def gemm_nn(dy: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = dy @ w for dy (M, K) and w (K, N), an nn.Linear weight whose
    input width is N (dX = dY W) (gemm.cu); bf16 operands with out bf16 or
    f32, or f32 operands (the f32 form) with out f32."""
    _rows_contig(dy, "dy")
    _rows_contig(w, "w")
    M, K = dy.shape
    N = w.shape[1]
    outs = (torch.float32,) if dy.dtype == F32 else (torch.bfloat16, torch.float32)
    if w.shape[0] != K or tuple(out.shape) != (M, N) or out.stride(1) != 1 \
            or out.device != dy.device or out.dtype not in outs:
        raise ValueError(f"gemm_nn: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)} {out.dtype}")
    _same_form(dy, w=w)
    err = _form("ct_gemm_layout", dy)(0, int(out.dtype == torch.float32), _ptr(dy),
                                      dy.stride(0), _ptr(w), w.stride(0), M, N, K,
                                      -(-K // 32) * 32, _ptr(out), out.stride(0), 0,
                                      int(_vec_ok(dy, w)), _stream())
    _check(err, "ct_gemm_layout")
    return out


TN_ROWS = 4096  # rows of a weight-gradient product per split


def gemm_tn(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dy^T @ x over all rows as f32 (M, N), for dy (R, M) and x (R, N), both
    bf16 or both f32: the weight gradient dW of y = x W^T (gemm.cu).  The rows
    are split in blocks of TN_ROWS whose partial sums are added in order
    (sum_splits)."""
    _rows_contig(dy, "dy")
    _rows_contig(x, "x")
    R, M = dy.shape
    N = x.shape[1]
    if x.shape[0] != R:
        raise ValueError(f"gemm_tn: dy {tuple(dy.shape)} and x {tuple(x.shape)}")
    splits = max(1, -(-R // TN_ROWS))
    chunk = -(-R // (splits * 32)) * 32
    splits = -(-R // chunk)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dy.device)
    _same_form(dy, x=x)
    err = _form("ct_gemm_layout", dy)(1, 1, _ptr(dy), dy.stride(0), _ptr(x), x.stride(0),
                                      M, N, R, chunk, _ptr(part), N, M * N,
                                      int(_vec_ok(dy, x)), _stream())
    _check(err, "ct_gemm_layout")
    return part[0] if splits == 1 else sum_splits(part)


def sum_splits(part: torch.Tensor) -> torch.Tensor:
    """part (S, ...) f32 -> its sum over the first axis, the splits added in
    order (gemm.cu)."""
    require(part, "part", torch.float32, part.dim())
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    err = library().ct_sum_splits(_ptr(part), part.shape[0], out.numel(), _ptr(out),
                                  _stream())
    _check(err, "ct_sum_splits")
    return out


def ff_bwd_core(xn: torch.Tensor, dout: torch.Tensor, wa: torch.Tensor,
                wg: torch.Tensor, woT: torch.Tensor):
    """K11's tile in f32 (gemm.cu, ff_bwd_kernel): a = xn wa^T, g = xn wg^T
    and dact = dout woT^T -> act (M, N) and dcat (M, 2N) = [da | dg], every
    operand and output f32, unrounded (bf16: `ff_tc_tile`)."""
    for name, t in (("xn", xn), ("dout", dout), ("wa", wa), ("wg", wg), ("woT", woT)):
        require(t, name, F32, 2)
    M, K = xn.shape
    N = wa.shape[0]
    if dout.shape != xn.shape or any(w.shape != (N, K) for w in (wa, wg, woT)):
        raise ValueError("ff_bwd_core: shapes do not fit")
    act = torch.empty((M, N), dtype=xn.dtype, device=xn.device)
    dcat = torch.empty((M, 2 * N), dtype=xn.dtype, device=xn.device)
    vec = K % _chunk(xn) == 0 and all(_rows_ok(t) for t in (xn, dout, wa, wg, woT))
    err = library().ct_ff_bwd_f32(_ptr(xn), _ptr(dout), K, _ptr(wa), _ptr(wg), _ptr(woT), K,
                                  M, N, K, _ptr(act), N, _ptr(dcat), 2 * N, int(vec),
                                  _stream())
    _check(err, "ct_ff_bwd_f32")
    return act, dcat


# K11 in bf16 on the tensor cores (ffn_tc.cu)
FF_TC_SPLIT_ROWS = 8192  # rows of a weight-gradient split, at most (tensor-core drift)
FF_TC_K = 64  # a split's rows are a multiple of the kernels' k block


def _ff_tc_operands(name: str, **tensors) -> None:
    """bf16 (rows, width) tensors with contiguous rows whose widths, row
    strides and bases are multiples of 16 bytes: the 16-byte copies of
    ffn_tc.cu."""
    for key, t in tensors.items():
        _rows_contig(t, key)
        if t.dtype != BF16 or t.shape[1] % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be bf16 with widths, row strides and bases "
                             f"of multiples of 16 bytes (got {t.dtype} {tuple(t.shape)}, "
                             f"stride {t.stride(0)})")


def ff_tc_tile(xn: torch.Tensor, dout: torch.Tensor, wa: torch.Tensor, wg: torch.Tensor,
               woT: torch.Tensor, lib=None):
    """K11's tile on ffn_tc.cu (bf16 `wgmma`): a = xn wa^T, g = xn wg^T and
    dact = dout woT^T -> act (M, N) and dcat (M, 2N) = [da | dg], bf16,
    rounded where ffn.py::_bwd_kernel rounds them (counted `ff_tc_tile`).
    `lib`: a one-change copy of ffn_tc.cu (`copy_library`) to launch
    instead, for the card checks."""
    _ff_tc_operands("ff_tc_tile", xn=xn, dout=dout, wa=wa, wg=wg, woT=woT)
    M, K = xn.shape
    N = wa.shape[0]
    if dout.shape != xn.shape or any(w.shape != (N, K) for w in (wa, wg, woT)) \
            or dout.stride(0) != xn.stride(0) \
            or not wa.stride(0) == wg.stride(0) == woT.stride(0):
        raise ValueError("ff_tc_tile: shapes or row strides do not fit")
    act = torch.empty((M, N), dtype=BF16, device=xn.device)
    dcat = torch.empty((M, 2 * N), dtype=BF16, device=xn.device)
    err = (lib or library()).ct_ff_tc_tile(
        _ptr(xn), _ptr(dout), xn.stride(0), _ptr(wa), _ptr(wg), _ptr(woT), wa.stride(0), M, N,
        K, _ptr(act), N, _ptr(dcat), 2 * N, _stream())
    _check(err, "ct_ff_tc_tile")
    count_launch("ff_tc_tile")
    return act, dcat


def ff_tc_split(rows: int) -> int:
    """Rows per split of a weight-gradient product on ffn_tc.cu: the fewest
    splits of at most FF_TC_SPLIT_ROWS rows, each a multiple of FF_TC_K."""
    splits = max(1, -(-rows // FF_TC_SPLIT_ROWS))
    return -(-rows // (splits * FF_TC_K)) * FF_TC_K


def gemm_nn_tc(dy: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out (M, N) f32 = dy (M, K) @ w (K, N), bf16 operands, on ffn_tc.cu
    (`wgmma`, w read MN-major): K11's dxn = [da | dg] [wa; wg] (counted
    `ff_tc_gemm`)."""
    _ff_tc_operands("gemm_nn_tc", dy=dy, w=w)
    M, K = dy.shape
    N = w.shape[1]
    if w.shape[0] != K or tuple(out.shape) != (M, N) or out.dtype != F32 \
            or out.stride(1) != 1 or out.stride(0) % 2 or out.data_ptr() % 16 \
            or out.device != dy.device:
        raise ValueError(f"gemm_nn_tc: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)} {out.dtype}")
    err = library().ct_ff_tc_gemm(0, _ptr(dy), dy.stride(0), _ptr(w), w.stride(0), M, N, K,
                                  -(-K // FF_TC_K) * FF_TC_K, _ptr(out), out.stride(0), 0,
                                  _stream())
    _check(err, "ct_ff_tc_gemm")
    count_launch("ff_tc_gemm")
    return out


def gemm_tn_tc(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dy^T @ x over all rows as f32 (M, N), for dy (R, M) and x (R, N) bf16,
    on ffn_tc.cu (`wgmma`, both read MN-major): K11's weight gradients.  The
    rows split in blocks of `ff_tc_split` whose partial sums are added in
    order (sum_splits) (counted `ff_tc_gemm`)."""
    _ff_tc_operands("gemm_tn_tc", dy=dy, x=x)
    R, M = dy.shape
    N = x.shape[1]
    if x.shape[0] != R:
        raise ValueError(f"gemm_tn_tc: dy {tuple(dy.shape)} and x {tuple(x.shape)}")
    chunk = ff_tc_split(R)
    splits = -(-R // chunk)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dy.device)
    err = library().ct_ff_tc_gemm(1, _ptr(dy), dy.stride(0), _ptr(x), x.stride(0), M, N, R,
                                  chunk, _ptr(part), N, M * N, _stream())
    _check(err, "ct_ff_tc_gemm")
    count_launch("ff_tc_gemm")
    return part[0] if splits == 1 else sum_splits(part)


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
    """Row LN of a contiguous (rows, D) bf16 or f32 tensor into `out` of its
    dtype (layernorm.cu)."""
    require(x, "x", FORMS, 2)
    require(out, "out", x.dtype, 2)
    rows, D = x.shape
    if out.shape != x.shape or D > 4096:
        raise ValueError(f"layernorm: bad shapes {tuple(x.shape)}")
    scale, bias = _f32_vector(scale, D, "scale"), _f32_vector(bias, D, "bias")
    err = _form("ct_layernorm", x)(_ptr(x), rows, D, _ptr(scale), _ptr(bias),
                                   float(eps), _ptr(out), _stream())
    _check(err, "ct_layernorm")
    return out


LN_BWD_ROWS = 64  # rows per block of the LayerNorm backward


def layernorm_bwd(x: torch.Tensor, scale: Optional[torch.Tensor], dxn: torch.Tensor,
                  eps: float, add: Optional[torch.Tensor] = None,
                  add2: Optional[torch.Tensor] = None, want_dbias: bool = False,
                  want_dx: bool = True, want_dxsum: bool = False):
    """Backward of the row LN of x (rows, D) bf16 or f32 given dxn =
    dL/dLN(x) f32: dx (x's dtype, plus `add` f32 and `add2` of x's dtype when
    given; None without want_dx), dscale = sum of dxn * xhat and, with
    want_dbias, dbias = sum of dxn, both f32 (layernorm.cu; column sums added
    over row blocks in order).  With want_dxsum a fourth result: the column
    sum of the f32 dx before its rounding to x's dtype."""
    require(x, "x", FORMS, 2)
    require(dxn, "dxn", torch.float32, 2)
    rows, D = x.shape
    if dxn.shape != x.shape or D > 4096:
        raise ValueError(f"layernorm_bwd: x {tuple(x.shape)}, dxn {tuple(dxn.shape)}")
    for name, t, dt in (("add", add, torch.float32), ("add2", add2, x.dtype)):
        if t is not None:
            require(t, name, dt, 2)
            if t.shape != x.shape:
                raise ValueError(f"layernorm_bwd: {name} must match x")
    scale = _f32_vector(scale, D, "scale")
    blocks = -(-rows // LN_BWD_ROWS)
    dx = torch.empty_like(x) if want_dx else None
    part_ds = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    part_db = torch.empty_like(part_ds) if want_dbias else None
    part_dxs = torch.empty_like(part_ds) if want_dxsum else None
    err = _form("ct_layernorm_bwd", x)(_ptr(x), rows, D, _ptr(scale), _ptr(dxn), _ptr(add),
                                       _ptr(add2), float(eps), _ptr(dx), _ptr(part_ds),
                                       _ptr(part_db), _ptr(part_dxs), LN_BWD_ROWS,
                                       _stream())
    _check(err, "ct_layernorm_bwd")
    out = (dx, sum_splits(part_ds), None if part_db is None else sum_splits(part_db))
    return out + (sum_splits(part_dxs),) if want_dxsum else out


def patch_layernorm_bwd(video: torch.Tensor, pt: int, p: int, scale: torch.Tensor,
                        dxn: torch.Tensor, eps: float, want_dx: bool = False):
    """Backward of `patch_layernorm` given dxn (B*t*h*w, pt*p*p) f32: dx as
    patch rows bf16 (None without want_dx), dscale and dbias f32
    (layernorm.cu; xhat recomputed through the patch gather, column sums
    added over row blocks in order)."""
    require(video, "video", torch.bfloat16, 4)
    require(dxn, "dxn", torch.float32, 2)
    B, F, H, W = video.shape
    D = pt * p * p
    rows = B * (F // pt) * (H // p) * (W // p)
    if F % pt or H % p or W % p or D > 4096 or tuple(dxn.shape) != (rows, D):
        raise ValueError(f"patch_layernorm_bwd: video {tuple(video.shape)} vs {pt}x{p}x{p}, "
                         f"dxn {tuple(dxn.shape)}")
    scale = _f32_vector(scale, D, "scale")
    blocks = -(-rows // LN_BWD_ROWS)
    dx = torch.empty((rows, D), dtype=torch.bfloat16, device=video.device) if want_dx else None
    part_ds = torch.empty((blocks, D), dtype=torch.float32, device=video.device)
    part_db = torch.empty_like(part_ds)
    err = library().ct_patch_layernorm_bwd(_ptr(video), B, F, H, W, pt, p, _ptr(scale),
                                           _ptr(dxn), float(eps), _ptr(dx), _ptr(part_ds),
                                           _ptr(part_db), LN_BWD_ROWS, _stream())
    _check(err, "ct_patch_layernorm_bwd")
    return dx, sum_splits(part_ds), sum_splits(part_db)


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


def _on_card(name: str, *tensors) -> None:
    """The per-call checks of the rearrange.cu wrappers: CUDA tensors of one
    kernel form (their geometry is checked once, by the cached functions)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype not in FORMS or t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: expected {FORMS} alike, got {t.dtype}")


@functools.lru_cache(maxsize=128)
def rearrange_geometry(video_shape, dtype: torch.dtype, pt: int, p: int, out_shape,
                       out_strides, aligned: bool):
    """`rearrange_patches`' checks that depend on the geometry alone, once
    per geometry (shapes, dtype, patch, the strides of `out` and whether both
    bases are 16-byte aligned): the C entry's integer arguments (B, F, H,
    W, pt, p), (batch, row strides of out) and `vec` (16-byte accesses).
    Raises ValueError on a geometry the kernel does not take, every call."""
    if len(video_shape) != 4 or len(out_shape) != 3:
        raise ValueError(f"rearrange_patches: video {tuple(video_shape)} must be (B, F, H, W), "
                         f"out {tuple(out_shape)} (B, n, pt*p*p)")
    B, F, H, W = video_shape
    if pt < 1 or p < 1 or F % pt or H % p or W % p:
        raise ValueError(f"rearrange_patches: {tuple(video_shape)} vs {pt}x{p}x{p}")
    n, pd = (F // pt) * (H // p) * (W // p), pt * p * p
    sb, sr, se = out_strides
    if tuple(out_shape) != (B, n, pd) or se != 1 or sr < pd or (B > 1 and sb < n * sr):
        raise ValueError(f"rearrange_patches: out {tuple(out_shape)} with strides "
                         f"{tuple(out_strides)} is not ({B}, {n}, {pd}) rows")
    c = 16 // dtype.itemsize
    vec = W % c == 0 and (p * p) % c == 0 and sb % c == 0 and sr % c == 0 and aligned
    return (B, F, H, W, pt, p), (sb, sr), int(vec)


def rearrange_patches(video: torch.Tensor, pt: int, p: int,
                      out: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W) video -> out (B, t*h*w, pt*p*p) patch rows (rearrange.cu),
    bf16 or f32 (the f32 form).

    `out` may be a view, such as one slot of a batch buffer: its rows must
    be contiguous and must not overlap."""
    _on_card("rearrange_patches", video, out)
    if not video.is_contiguous():
        raise ValueError("rearrange_patches: expected a contiguous video")
    vp, op = video.data_ptr(), out.data_ptr()
    geom, strides, vec = rearrange_geometry(video.shape, video.dtype, pt, p, out.shape,
                                            out.stride(), (vp | op) % 16 == 0)
    err = _form("ct_rearrange_patches", video)(vp, *geom, op, *strides, vec, _stream())
    _check(err, "ct_rearrange_patches")
    return out


@functools.lru_cache(maxsize=128)
def unrearrange_geometry(rows_shape, dtype: torch.dtype, pt: int, p: int, out_shape,
                         aligned: bool):
    """`unrearrange_patches`' checks that depend on the geometry alone, once
    per geometry: the C entry's integer arguments (batch and row strides of
    the rows, B, F, H, W, pt, p) and `vec`.  Raises ValueError on a geometry
    the kernel does not take, every call."""
    if len(rows_shape) != 3 or len(out_shape) != 4:
        raise ValueError(f"unrearrange_patches: rows {tuple(rows_shape)} must be (B, n, "
                         f"pt*p*p), out {tuple(out_shape)} (B, F, H, W)")
    B, F, H, W = out_shape
    if pt < 1 or p < 1 or F % pt or H % p or W % p:
        raise ValueError(f"unrearrange_patches: {tuple(out_shape)} vs {pt}x{p}x{p}")
    n, pd = (F // pt) * (H // p) * (W // p), pt * p * p
    if tuple(rows_shape) != (B, n, pd):
        raise ValueError(f"unrearrange_patches: rows {tuple(rows_shape)} != {(B, n, pd)}")
    c = 16 // dtype.itemsize
    vec = W % c == 0 and (p * p) % c == 0 and pd % c == 0 and aligned
    return (n * pd, pd, B, F, H, W, pt, p), int(vec)


def unrearrange_patches(rows: torch.Tensor, pt: int, p: int,
                        out: torch.Tensor) -> torch.Tensor:
    """(B, t*h*w, pt*p*p) patch rows -> out (B, F, H, W), the inverse of
    `rearrange_patches` (rearrange.cu), bf16 or f32; both contiguous."""
    _on_card("unrearrange_patches", rows, out)
    if not (rows.is_contiguous() and out.is_contiguous()):
        raise ValueError("unrearrange_patches: expected contiguous rows and out")
    rp, op = rows.data_ptr(), out.data_ptr()
    geom, vec = unrearrange_geometry(rows.shape, rows.dtype, pt, p, out.shape, (rp | op) % 16 == 0)
    err = _form("ct_unrearrange_patches", rows)(rp, *geom, op, vec, _stream())
    _check(err, "ct_unrearrange_patches")
    return out


# the dynamic shared memory one H100 block may opt into (bytes)
SMEM_LIMIT = 227 * 1024


def qk_attention_bwd_f32_smem(n: int, d: int, warps: int) -> int:
    """Bytes of shared memory qknorm_attention_bwd.cu's f32 form takes
    (bwd_f32_smem_floats): per warp (max(n, 64), 4) score and dP tiles and
    (d, 4) row tiles, two 64-row chunks, the rows' lse, rowsum and inverse
    q and k norms."""
    return 4 * (warps * 4 * (2 * max(n, 64) + 2 * d) + 2 * 64 * (d + 1) + 4 * n)


def attention_f32_smem(n: int, d: int, warps: int) -> int:
    """Bytes of shared memory attention.cu's f32 form takes (f32_smem_floats):
    the (4 warps, n) score tile, the (4 warps, d) q tile, a 64-key chunk."""
    qt = 4 * warps
    return 4 * (qt * n + qt * d + 64 * (d + 1))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, *, sequences: int, inner: int, heads: int,
              n: int, d: int, q_strides, kv_strides,
              q_scale: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              warps: int = 8) -> torch.Tensor:
    """softmax(q k^T + bias) v per (sequence, head) (attention.cu); bias
    (heads, n, n) f32 or None.  q, k, v and out all bf16, or all f32 (the f32
    form: nothing rounded, blocks of 4 x `warps` query rows).

    q/out and k/v are addressed through (outer, inner, head, token) element
    strides; their last dim must be contiguous.  The caller checks that the
    strides stay inside the tensors."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        require(t, name, q.dtype if name != "q" else FORMS, t.dim(), contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"attention: last dim of {name} must be contiguous")
    if d % 2 or d > 128:
        raise ValueError(f"attention: head dim {d} must be even and <= 128")
    if q.dtype == F32 and attention_f32_smem(n, d, warps) > SMEM_LIMIT:
        raise ValueError(f"attention: {n} tokens of f32 width {d} take "
                         f"{attention_f32_smem(n, d, warps)} bytes of shared memory")
    qs = _f32_vector(q_scale, d, "q_scale")
    ks = _f32_vector(k_scale, d, "k_scale")
    if (qs is None) != (ks is None):
        raise ValueError("attention: pass both q_scale and k_scale or neither")
    if bias is not None:
        require(bias, "bias", torch.float32, 3)
        if tuple(bias.shape) != (heads, n, n):
            raise ValueError(f"attention: bias {tuple(bias.shape)} != {(heads, n, n)}")
    err = _form("ct_attention", q)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), *map(int, q_strides),
        *map(int, kv_strides), inner, sequences, heads, n, d, _ptr(qs),
        _ptr(ks), _ptr(bias), warps, _stream())
    _check(err, "ct_attention")
    return out


# the QK-norm core on the tensor cores: bf16 (qknorm_attention_tc.cu) and
# f32 in 3xTF32 (qknorm_attention_tc32.cu)
QK_TC_HEAD_DIM = 32
QK_TC_MIN_TOKENS = 32  # half a 64-row tile; K10's 16-24-token sequences stay
# dbias-pass CTAs to aim for, one wave of three per SM (132): 576-token planes
# give 648 CTAs of one group; three waves (two groups) read no faster
QK_TC_DBIAS_CTAS = 396
# the routes of the core's backward (`qk_bwd_tensor_cores`)
QK_WGMMA, QK_TC32, QK_CUDA_CORES = "wgmma", "tc32", "cuda_cores"
# the dynamic shared memory the largest pass of qknorm_attention_tc32.cu
# takes (its dbias pass: the bias tile and two stages of qn, dO, kn, v, lse
# and D, 1024-byte aligned); the same at every n
QK_TC32_BWD_SMEM = 1024 + 18432 + 2 * 37888


def qk_bwd_tensor_cores(dtype: torch.dtype, n: int, d: int) -> str:
    """The route of the QK-norm attention core's backward on `n`-token
    sequences of head dim `d`: QK_WGMMA, qknorm_attention_tc.cu (bf16
    `wgmma`), or QK_TC32, qknorm_attention_tc32.cu (f32 in 3xTF32 on
    `mma.sync`), for K9's 576- and 64-token planes with or without the
    bias and any ragged n from 32 in zero-filled 64-row tiles; otherwise
    QK_CUDA_CORES, qknorm_attention_bwd.cu (qk_attention_bwd_kernel and its
    f32 form: K10's 16-24-token sequences, other head dims).  `_qk_tc_bwd`
    and `_qk_tc32_bwd` count each launch of their route."""
    if d != QK_TC_HEAD_DIM or n < QK_TC_MIN_TOKENS:
        return QK_CUDA_CORES
    return {BF16: QK_WGMMA, F32: QK_TC32}.get(dtype, QK_CUDA_CORES)


def qk_tc_dbias_groups(sequences: int, heads: int, n: int) -> int:
    """The dbias pass's groups of sequences: about QK_TC_DBIAS_CTAS CTAs of
    one (64 x 64 tile, head, group), the kernel giving each group
    ceil(sequences / groups) sequences in order, and no group left empty."""
    tiles = -(-n // 64)
    groups = max(1, min(sequences, -(-QK_TC_DBIAS_CTAS // (tiles * tiles * heads))))
    per = -(-sequences // groups)
    return -(-sequences // per)


def _qk_core_bwd(entry, counter, q, kv, dout, qs, ks, bias, *, sequences, inner, heads, n, d,
                 q_strides, kv_strides, lib):
    """qk_attention_bwd on a tensor-core source (`entry`, counted `counter`
    where it launches): its scratch (qn, kn in q's dtype and the rows'
    inverse norms, lse, D_i) and the per-CTA scale partials, added in two
    levels (one thread a column would sum 13,824 rows in turn: 0.6 ms); dbias
    from the dbias pass's groups of sequences, added in order."""
    strides = [*map(int, q_strides), *map(int, kv_strides)]
    chunk = _chunk(q)
    if any(st % chunk for st in strides) or any(t.data_ptr() % 16 for t in (q, kv, dout)):
        raise ValueError(f"qk_attention_bwd: the tensor-core core takes strides of multiples "
                         f"of {chunk} elements and 16-byte aligned tensors")
    merged, dq, dkv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(kv)
    f32 = dict(dtype=torch.float32, device=q.device)
    qn, kn = (torch.empty((sequences, heads, n, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    rq, rk, lse, rowsum = (torch.empty((sequences, heads, n), **f32) for _ in range(4))
    tiles = -(-n // 64)
    groups, dbias_part = 1, None
    if bias is not None:
        groups = qk_tc_dbias_groups(sequences, heads, n)
        dbias_part = torch.empty((groups, heads, n, n), **f32)
    dqs_part = torch.empty((sequences * heads * tiles, d), **f32)
    dks_part = torch.empty_like(dqs_part)
    hd = heads * d
    err = getattr(lib or library(), entry)(
        _ptr(q), _ptr(kv), _ptr(kv[:, hd:]), _ptr(dout), _ptr(merged), _ptr(dq), _ptr(dkv),
        _ptr(dkv[:, hd:]), *strides, inner, sequences, heads, n, d, _ptr(qs), _ptr(ks),
        _ptr(bias), _ptr(qn), _ptr(kn), _ptr(rq), _ptr(rk), _ptr(lse), _ptr(rowsum),
        _ptr(dbias_part), groups, _ptr(dqs_part), _ptr(dks_part), _stream())
    _check(err, entry)
    count_launch(counter)
    dbias = None
    if bias is not None:
        dbias = dbias_part[0] if groups == 1 else sum_splits(dbias_part)

    def scale_sum(part):  # over the sequences, then the (head, tile) rows, in order
        return sum_splits(sum_splits(part.view(sequences, -1)).view(-1, d))
    return merged, dq, dkv, scale_sum(dqs_part), scale_sum(dks_part), dbias


def _qk_tc_bwd(*args, **kw):
    """The bf16 core on qknorm_attention_tc.cu (`wgmma`)."""
    return _qk_core_bwd("ct_qk_attention_tc_bwd", "qk_attention_tc_bwd", *args, **kw)


def _qk_tc32_bwd(*args, **kw):
    """The f32 core on qknorm_attention_tc32.cu (3xTF32 on `mma.sync`)."""
    return _qk_core_bwd("ct_qk_attention_tc32_bwd", "qk_attention_tc32_bwd", *args, **kw)


def qk_attention_bwd(q, kv, dout, *, sequences: int, inner: int, heads: int,
                     n: int, d: int, q_strides, kv_strides, q_scale, k_scale,
                     bias: Optional[torch.Tensor] = None, group: int = 1,
                     warps: int = 8, lib=None):
    """The QK-norm attention core's backward on the projections q (rows,
    h*d) and kv (rows, 2*h*d) [k | v], and dout, the gradient of the merged
    heads, laid out as q; all bf16, or all f32.  By `qk_bwd_tensor_cores`:
    qknorm_attention_tc.cu (bf16 `wgmma`) or qknorm_attention_tc32.cu (f32 in
    3xTF32), `group` and `warps` unused; otherwise qknorm_attention_bwd.cu
    (bf16 on the CUDA cores, or its f32 form: nothing rounded, query and key
    tiles of 4 x `warps` rows, sequences in blocks of `group`).  Heads are addressed through (outer, inner, head,
    token) element strides: `q_strides` for q, dout and the outputs like q,
    `kv_strides` for k and v (the caller checks they stay inside the tensors).
    Returns merged and dq (like q), dkv (like kv), dq_scale and dk_scale (d,)
    f32 (dq_scale before the logit scale) and dbias (heads, n, n) f32 or None;
    sums over sequences are added in a fixed order. `lib`: a one-change copy
    (`copy_library`) of the source the call takes, to launch instead, for the
    card checks."""
    hd = heads * d
    for name, t, width in (("q", q, hd), ("kv", kv, 2 * hd), ("dout", dout, hd)):
        require(t, name, q.dtype if name != "q" else FORMS, 2)
        if t.shape[1] != width or t.shape[0] != q.shape[0]:
            raise ValueError(f"qk_attention_bwd: {name} {tuple(t.shape)}")
    if d % 2 or d > 64:
        raise ValueError(f"qk_attention_bwd: head dim {d} must be even and <= 64")
    core = qk_bwd_tensor_cores(q.dtype, n, d)
    if core == QK_CUDA_CORES and q.dtype == F32 \
            and qk_attention_bwd_f32_smem(n, d, warps) > SMEM_LIMIT:
        raise ValueError(f"qk_attention_bwd: {n} tokens of f32 width {d} take "
                         f"{qk_attention_bwd_f32_smem(n, d, warps)} bytes of shared memory")
    qs, ks = _f32_vector(q_scale, d, "q_scale"), _f32_vector(k_scale, d, "k_scale")
    if bias is not None:
        require(bias, "bias", torch.float32, 3)
        if tuple(bias.shape) != (heads, n, n):
            raise ValueError(f"qk_attention_bwd: bias {tuple(bias.shape)}")
    layout = dict(sequences=sequences, inner=inner, heads=heads, n=n, d=d,
                  q_strides=q_strides, kv_strides=kv_strides)
    if core != QK_CUDA_CORES:
        launch = _qk_tc_bwd if core == QK_WGMMA else _qk_tc32_bwd
        return launch(q, kv, dout, qs, ks, bias, lib=lib, **layout)
    merged, dq, dkv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(kv)
    groups = -(-sequences // group)
    f32 = dict(dtype=torch.float32, device=q.device)
    bias_t = dbias_part = None
    if bias is not None:
        bias_t = bias.transpose(1, 2).contiguous()
        dbias_part = torch.empty((groups, heads, n, n), **f32)
    dqs_part = torch.empty((groups * heads * warps, d), **f32)
    dks_part = torch.empty_like(dqs_part)
    fn = getattr(lib or library(), "ct_qk_attention_bwd_f32" if q.dtype == F32
                 else "ct_qk_attention_bwd")
    err = fn(
        _ptr(q), _ptr(kv), _ptr(kv[:, hd:]), _ptr(dout), _ptr(merged), _ptr(dq),
        _ptr(dkv), _ptr(dkv[:, hd:]), *map(int, q_strides), *map(int, kv_strides),
        inner, sequences, heads, n, d, group, _ptr(qs), _ptr(ks), _ptr(bias),
        _ptr(bias_t), _ptr(dbias_part), _ptr(dqs_part), _ptr(dks_part), warps,
        _stream())
    _check(err, "ct_qk_attention_bwd")
    dbias = None if dbias_part is None else sum_splits(dbias_part)
    return merged, dq, dkv, sum_splits(dqs_part), sum_splits(dks_part), dbias


def peg_dw(x: torch.Tensor, dout: torch.Tensor, pads) -> torch.Tensor:
    """(28, C) f32: rows 0-26 the depthwise 3x3x3 weight gradient, tap
    (kz * 3 + ky) * 3 + kx, row 27 the bias gradient, of a conv over the
    (B, T, H, W, C) bf16 x with leading pads `pads` = (t, h, w); the frames
    added in order (peg_bwd.cu)."""
    require(x, "x", torch.bfloat16, 5)
    require(dout, "dout", torch.bfloat16, 5)
    if dout.shape != x.shape or x.shape[-1] % 2 or x.data_ptr() % 4 or dout.data_ptr() % 4:
        raise ValueError(f"peg_dw: x {tuple(x.shape)}, dout {tuple(dout.shape)}")
    B, T, H, W, C = x.shape
    part = torch.empty((B * T, 28, C), dtype=torch.float32, device=x.device)
    err = library().ct_peg_dw(_ptr(x), _ptr(dout), B, T, H, W, C, *map(int, pads),
                              _ptr(part), _stream())
    _check(err, "ct_peg_dw")
    return sum_splits(part)


def vq_cluster_stats(x: torch.Tensor, ids: torch.Tensor, codes: int):
    """bins (codes,) and embed_sum (codes, D) f32 of the l2-normalised rows
    of x (rows, D) grouped by ids (rows,) int32 (vq_stats.cu): bf16 rows, or
    f32 rows (the f32 form: each normalised row added as its bf16 hi + lo
    parts)."""
    require(x, "x", FORMS, 2)
    require(ids, "ids", torch.int32, 1)
    rows, D = x.shape
    if ids.shape[0] != rows or D % _chunk(x) or D > 1024 or x.data_ptr() % 16:
        raise ValueError(f"vq_cluster_stats: x {tuple(x.shape)}, ids {tuple(ids.shape)}")
    i32 = dict(dtype=torch.int32, device=x.device)
    rank, perm = torch.empty((rows,), **i32), torch.empty((rows,), **i32)
    counts = torch.empty((-(-rows // 1024), codes), **i32)
    start = torch.empty((codes,), **i32)
    bins = torch.empty((codes,), dtype=torch.float32, device=x.device)
    embed_sum = torch.empty((codes, D), dtype=torch.float32, device=x.device)
    err = _form("ct_vq_cluster_stats", x)(_ptr(x), _ptr(ids), rows, D, codes, _ptr(rank),
                                          _ptr(counts), _ptr(start), _ptr(perm), _ptr(bins),
                                          _ptr(embed_sum), _stream())
    _check(err, "ct_vq_cluster_stats")
    return bins, embed_sum


# ------------------------------------------- training attention (f32, bf16)
_TRAIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dropout_threshold(rate: float) -> int:
    """K13's mask keeps a probability iff its Philox bits are >= this
    (`_drop_mask`, ct_clip_tpu/ops/pallas/attention.py:406)."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to f32, as the TPU kernel multiplies it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _bhnd_strides(*tensors):
    """(batch, head, token) element strides of (b, h, n, d) tensors whose
    last dim is contiguous, as the C array the kernels take."""
    vals = []
    for t in tensors:
        st = t.stride()  # one call: Tensor.stride(dim) costs ~10x more
        if st[-1] != 1:
            raise ValueError("attention: the head dim must be contiguous")
        vals.extend(st[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_bhnd(shape, dtype, **tensors):
    for name, t in tensors.items():
        require(t, name, dtype, 4, contiguous=False)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"attention: {name} {tuple(t.shape)} != {tuple(shape)}")
    b, h, n, d = shape
    if dtype not in _TRAIN_DTYPES:
        raise ValueError(f"attention: the training kernels take {list(_TRAIN_DTYPES)}, "
                         f"got {dtype}")
    if d > 64:
        raise ValueError(f"attention: head dim {d} > 64")
    if b * h > 65535:  # one grid row per (sequence, head)
        raise ValueError(f"attention: {b} x {h} (sequence, head) pairs > 65535")


def _dropout_args(seed: Optional[torch.Tensor], thresh: int, device):
    if not thresh:
        return None
    if seed is None or seed.dtype != torch.int64 or seed.numel() != 1 \
            or seed.device != device:
        raise ValueError("attention: dropout needs a (1,) int64 seed on the device")
    return seed


def _check_key_bias(key_bias, b: int, n: int) -> None:
    if key_bias is not None:
        require(key_bias, "key_bias", torch.float32, 2)
        if tuple(key_bias.shape) != (b, n):
            raise ValueError(f"attention: key_bias {tuple(key_bias.shape)} != {(b, n)}")


def _check_out32(out32, shape) -> None:
    if out32 is not None:
        require(out32, "out32", torch.float32, 4)
        if tuple(out32.shape) != tuple(shape):
            raise ValueError(f"attention: out32 {tuple(out32.shape)} != {tuple(shape)}")


def _bias_heads(bias, h: int, n: int) -> int:
    """The head count (1 or h) of a dense (1|h, n, n) f32 bias, 0 for None."""
    if bias is None:
        return 0
    require(bias, "bias", torch.float32, 3)
    if bias.shape[0] not in (1, h) or tuple(bias.shape[1:]) != (n, n):
        raise ValueError(f"attention: bias {tuple(bias.shape)} is not (1|{h}, {n}, {n})")
    return bias.shape[0]


def attention_train_fwd(q, k, v, out, lse, *, out32=None, key_bias=None, bias=None,
                        seed=None, thresh=0, keep_scale=1.0) -> torch.Tensor:
    """out = (softmax(q k^T + bias + key_bias) * dropout mask) v and the row
    log-sum-exp lse (b, h, n) f32 (attention_train.cu).  out32 a contiguous
    (b, h, n, d) f32 tensor to receive out before rounding, or None;
    key_bias (b, n) or None; bias a contiguous (1|h, n, n) f32 dense bias or
    None; thresh 0: no dropout."""
    b, h, n, d = q.shape
    _check_bhnd(q.shape, q.dtype, q=q, k=k, v=v, out=out)
    _check_out32(out32, q.shape)
    require(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != (b, h, n):
        raise ValueError(f"attention: lse {tuple(lse.shape)} != {(b, h, n)}")
    _check_key_bias(key_bias, b, n)
    bias_heads = _bias_heads(bias, h, n)
    seed = _dropout_args(seed, thresh, q.device)
    err = library().ct_attn_train_fwd(
        _TRAIN_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(out32),
        _bhnd_strides(q, k, v, out), _ptr(key_bias), _ptr(bias), bias_heads, _ptr(lse),
        _ptr(seed), thresh, float(keep_scale), b, h, n, d, _stream())
    _check(err, "ct_attn_train_fwd")
    return out


def attention_train_bwd(q, k, v, out, dout, lse, *, out32=None, key_bias=None,
                        want_dkey_bias=False, bias=None, want_dbias=False, seed=None,
                        thresh=0, keep_scale=1.0):
    """dq, dk, dv, dkey_bias ((b, n) summed over heads and query rows, or
    None) and dbias ((1|h, n, n) f32 summed over the batch, and over the
    heads for a one-head bias, or None) of attention_train_fwd
    (attention_train.cu).  out32: the forward's f32 out, which D_i =
    dO_i . O_i then reads in place of `out`, or None.  dbias takes a (b, h,
    n, n) f32 scratch of each (b, h)'s dS."""
    b, h, n, d = q.shape
    _check_bhnd(q.shape, q.dtype, q=q, k=k, v=v, out=out, dout=dout)
    _check_out32(out32, q.shape)
    require(lse, "lse", torch.float32, 3)
    _check_key_bias(key_bias, b, n)
    bias_heads = _bias_heads(bias, h, n)
    if key_bias is None and want_dkey_bias:
        raise ValueError("attention: dkey_bias needs a key_bias")
    if bias is None and want_dbias:
        raise ValueError("attention: dbias needs a bias")
    seed = _dropout_args(seed, thresh, q.device)
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    rowdot = torch.empty((b, h, n), **f32)
    dkb_head = torch.empty((b, h, n), **f32) if want_dkey_bias else None
    dkb = torch.empty((b, n), **f32) if want_dkey_bias else None
    ds = torch.empty((b, h, n, n), **f32) if want_dbias else None
    dbias = torch.empty((bias_heads, n, n), **f32) if want_dbias else None
    err = library().ct_attn_train_bwd(
        _TRAIN_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(out32),
        _ptr(dout), _ptr(dq), _ptr(dk), _ptr(dv), _bhnd_strides(q, k, v, out, dout, dq, dk, dv),
        _ptr(key_bias), _ptr(bias), bias_heads, _ptr(lse), _ptr(rowdot), _ptr(dkb_head),
        _ptr(dkb), _ptr(ds), _ptr(dbias), _ptr(seed), thresh, float(keep_scale),
        b, h, n, d, _stream())
    _check(err, "ct_attn_train_bwd")
    return dq, dk, dv, dkb, dbias


# --------------------------------- bf16 attention on the tensor cores (d 64)
TC_HEAD_DIM = 64


def tc_addressable(t: torch.Tensor) -> bool:
    """Whether attention_tc.cu (bf16) or attention_tc32.cu (f32) can copy t's
    (b, h, n, 64) rows as 16-byte chunks: a contiguous last dim, every other
    stride a multiple of 16 bytes (8 bf16, 4 f32) and a base on a 16-byte
    boundary."""
    st, chunk = t.stride(), 16 // t.element_size()
    return (len(st) == 4 and st[3] == 1 and st[0] % chunk == 0 and st[1] % chunk == 0
            and st[2] % chunk == 0 and t.data_ptr() % 16 == 0)


def _check_tc(shape, dtype=torch.bfloat16, **tensors) -> None:
    _check_bhnd(shape, dtype, **tensors)
    if shape[-1] != TC_HEAD_DIM:
        raise ValueError(f"attention_tc: head dim {shape[-1]} != {TC_HEAD_DIM}")
    for name, t in tensors.items():
        if not tc_addressable(t):
            raise ValueError(f"attention_tc: {name} with strides {t.stride()} is not "
                             "addressable in 16-byte chunks (pass a contiguous copy)")


def _tc_fwd_launch(name, entry, dtype, lib, q, k, v, out, lse, key_bias, bias, seed, rate):
    """The tensor-core forwards' shared checks and launch: `entry` of `lib`
    (or the package's library) on q, k, v, out (b, h, n, 64) `dtype` views
    as `tc_addressable` says, lse (b, h, n) f32."""
    b, h, n, d = q.shape
    _check_tc(q.shape, dtype, q=q, k=k, v=v, out=out)
    require(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} != {(b, h, n)}")
    _check_key_bias(key_bias, b, n)
    if key_bias is not None and bias is not None:
        raise ValueError(f"{name}: a key bias and a dense bias together")
    bias_heads = _bias_heads(bias, h, n)
    thresh = dropout_threshold(rate) if rate > 0 else 0
    if thresh and key_bias is None:
        raise ValueError(f"{name}: dropout (K13a) takes a key bias")
    seed = _dropout_args(seed, thresh, q.device)
    err = getattr(lib or library(), entry)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _bhnd_strides(q, k, v, out), _ptr(key_bias),
        _ptr(bias), bias_heads, _ptr(lse), _ptr(seed), thresh,
        dropout_keep_scale(rate) if thresh else 1.0, b, h, n, _stream())
    _check(err, entry)
    return out


def attention_tc_fwd(q, k, v, out, lse, *, key_bias=None, bias=None, seed=None,
                     rate=0.0) -> torch.Tensor:
    """out = (softmax(q k^T + bias + key_bias) * dropout mask) v in bf16 and
    the row log-sum-exp lse (b, h, n) f32 (attention_tc.cu, wgmma): q, k, v,
    out (b, h, n, 64) bf16 views as `tc_addressable` says; key_bias (b, n)
    f32 or None; bias a contiguous (1|h, n, n) f32 dense bias or None, not
    both; `seed` (1,) int64 on the device and `rate` > 0 apply K13a's mask
    (key bias only)."""
    return _tc_fwd_launch("attention_tc", "ct_attn_tc_fwd", torch.bfloat16, None, q, k, v,
                          out, lse, key_bias, bias, seed, rate)


def attention_tc32_fwd(q, k, v, out, lse, *, key_bias=None, bias=None, seed=None,
                       rate=0.0, lib=None) -> torch.Tensor:
    """out = (softmax(q k^T + bias + key_bias) * dropout mask) v in f32 and
    the row log-sum-exp lse (b, h, n) f32, both products as 3xTF32 on the
    tensor cores (attention_tc32.cu): K7 with a key bias, a dense bias or
    none, K13a with a key bias and dropout.  q, k, v, out (b, h, n, 64) f32
    views as `tc_addressable` says; key_bias (b, n) f32 or None; bias a
    contiguous (1|h, n, n) f32 dense bias or None, not both; `seed` (1,)
    int64 on the device and `rate` > 0 apply K13a's mask (key bias only),
    the bits K13b regenerates.  `lib`: a one-change copy (`copy_library`)
    to launch instead, for the card checks."""
    return _tc_fwd_launch("attention_tc32", "ct_attn_tc32_fwd", torch.float32, lib, q, k,
                          v, out, lse, key_bias, bias, seed, rate)


def _tc_bwd_buffers(name, q, lse, bias, want_dbias, key_bias, want_dkey_bias, seed, rate):
    """The tensor-core backwards' shared checks and buffers: (bias_heads,
    seed, thresh, keep_scale, dq, dk, dv, rowsum, ds, dbias, dkb_head, dkb),
    the scratches and dbias / dkey_bias None where not wanted."""
    b, h, n, d = q.shape
    require(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} != {(b, h, n)}")
    _check_key_bias(key_bias, b, n)
    bias_heads = _bias_heads(bias, h, n)
    if key_bias is not None and bias is not None:
        raise ValueError(f"{name}: a key bias and a dense bias together")
    if bias is None and want_dbias:
        raise ValueError(f"{name}: dbias needs a bias")
    if key_bias is None and want_dkey_bias:
        raise ValueError(f"{name}: dkey_bias needs a key_bias")
    thresh = dropout_threshold(rate) if rate > 0 else 0
    if thresh and key_bias is None:
        raise ValueError(f"{name}: dropout (K13b) takes a key bias")
    seed = _dropout_args(seed, thresh, q.device)
    grads = [torch.empty((b, h, n, d), dtype=q.dtype, device=q.device) for _ in range(3)]
    f32 = dict(dtype=torch.float32, device=q.device)
    return (bias_heads, seed, thresh, dropout_keep_scale(rate) if thresh else 1.0, *grads,
            torch.empty((b, h, n), **f32),
            torch.empty((b, h, n, n), **f32) if want_dbias else None,
            torch.empty((bias_heads, n, n), **f32) if want_dbias else None,
            torch.empty((b, h, n), **f32) if want_dkey_bias else None,
            torch.empty((b, n), **f32) if want_dkey_bias else None)


def attention_tc_bwd(q, k, v, dout, lse, *, bias=None, want_dbias=False, key_bias=None,
                     want_dkey_bias=False, seed=None, rate=0.0):
    """dq, dk, dv (b, h, n, 64) bf16, dbias ((1|h, n, n) f32 summed over the
    batch, and over the heads for a one-head bias, or None) and dkey_bias
    ((b, n) f32 summed over the heads and query rows, or None) of
    attention_tc_fwd, with dropout of its K13a (attention_tc.cu, wgmma): a
    row pass (D_i = sum_j P_ij dP_ij M_ij in f32, then dq; each (b, h)'s dS
    into a (b, h, n, n) f32 scratch for dbias), a column pass (dk, dv, each
    head's dkey_bias share into a (b, h, n) f32 scratch) and the
    scratches' sums in a fixed order.  A dense bias
    or a key bias (b, n) f32, not both; `seed` (1,) int64 on the device and
    `rate` > 0 regenerate K13a's mask M (key bias only)."""
    b, h, n, d = q.shape
    _check_tc(q.shape, q=q, k=k, v=v, dout=dout)
    (bias_heads, seed, thresh, keep_scale, dq, dk, dv, rowsum, ds, dbias, dkb_head,
     dkb) = _tc_bwd_buffers("attention_tc", q, lse, bias, want_dbias, key_bias,
                            want_dkey_bias, seed, rate)
    err = library().ct_attn_tc_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(dq), _ptr(dk), _ptr(dv),
        _bhnd_strides(q, k, v, dout, dq, dk, dv), _ptr(key_bias), _ptr(bias), bias_heads,
        _ptr(lse), _ptr(rowsum), _ptr(ds), _ptr(dbias), _ptr(dkb_head), _ptr(dkb), _ptr(seed),
        thresh, keep_scale, b, h, n, _stream())
    _check(err, "ct_attn_tc_bwd")
    return dq, dk, dv, dbias, dkb


def attention_tc32_bwd(q, k, v, out, dout, lse, *, bias=None, want_dbias=False,
                       key_bias=None, want_dkey_bias=False, seed=None, rate=0.0, lib=None):
    """dq, dk, dv (b, h, n, 64) f32, dbias ((1|h, n, n) f32 summed over the
    batch, and over the heads for a one-head bias, or None) and dkey_bias
    ((b, n) f32 summed over the heads and query rows, or None) of f32
    attention, each product as 3xTF32 on the tensor cores
    (attention_tc32.cu): K12b with a dense bias or none, K12a with a key
    bias, K13b with a key bias and dropout.  A row pass (D_i = dO_i . O_i
    from the forward's f32 output `out`, then dq; each (b, h)'s dS into a
    (b, h, n, n) f32 scratch for dbias), a column pass (dk, dv, each head's
    dkey_bias share into a (b, h, n) f32 scratch) and the scratches' sums in
    a fixed order.  q, k, v, out, dout (b, h, n, 64) f32 views as
    `tc_addressable` says; lse (b, h, n) f32 from the forward; a contiguous
    (1|h, n, n) f32 dense bias or a (b, n) f32 key bias, not both; `seed`
    (1,) int64 on the device and `rate` > 0 regenerate K13a's mask (key bias
    only).  `lib`: a one-change copy (`copy_library`) to launch instead, for
    the card checks."""
    b, h, n, d = q.shape
    _check_tc(q.shape, torch.float32, q=q, k=k, v=v, out=out, dout=dout)
    (bias_heads, seed, thresh, keep_scale, dq, dk, dv, rowsum, ds, dbias, dkb_head,
     dkb) = _tc_bwd_buffers("attention_tc32", q, lse, bias, want_dbias, key_bias,
                            want_dkey_bias, seed, rate)
    err = (lib or library()).ct_attn_tc32_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(dq), _ptr(dk), _ptr(dv),
        _bhnd_strides(q, k, v, out, dout, dq, dk, dv), _ptr(key_bias), _ptr(bias), bias_heads,
        _ptr(lse), _ptr(rowsum), _ptr(ds), _ptr(dbias), _ptr(dkb_head), _ptr(dkb), _ptr(seed),
        thresh, keep_scale, b, h, n, _stream())
    _check(err, "ct_attn_tc32_bwd")
    return dq, dk, dv, dbias, dkb
