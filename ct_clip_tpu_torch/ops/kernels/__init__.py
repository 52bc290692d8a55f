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
chooses between kernels counts the one it launched (`qk_attention_tc`,
`qk_attention_tc32`, `qk_attention_short`, `qk_attention_tc_bwd`,
`qk_attention_tc32_bwd`, `qk_proj_tc`), as do the PEG stencil's helpers
(`peg_fwd`, `peg_bwd` and their `_f32` forms), so a run can show that its
main path went through the kernels (`launch_counts`).
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
    "peg_bwd",             # K14 peg.py::_pallas_peg_bwd: dx, dW and db (peg_stencil.cu)
    "peg_fwd",             # the PEG forward, XLA's conv in JAX (peg.py::lax_peg_conv): no TPU
                           # kernel; the stencil's forward form (peg_stencil.cu)
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
    # qknorm_attention_tc.cu's bf16 tensor-core core of the QK-norm sublayer
    "qk_attention_tc",     # K1 (and K2 grid / seq at n >= 32) where `qk_fwd_route`
                           # gives QK_WGMMA: the forward core (spatial_attention)
    "qk_attention_tc_bwd",  # K9 where `qk_bwd_tensor_cores` gives QK_WGMMA
                            # (spatial_attention_bwd)
    # qknorm_attention_tc32.cu's f32 3xTF32 core of the QK-norm sublayer
    "qk_attention_tc32",   # K1 f32 where `qk_fwd_route` gives QK_TC32: the forward
                           # core (spatial_attention, spatial_attention_f32)
    "qk_attention_tc32_bwd",  # K9 f32 where `qk_bwd_tensor_cores` gives QK_TC32
                              # (spatial_attention_bwd, spatial_attention_bwd_f32)
    # qknorm_attention_short.cu's core of the QK-norm sublayer's forward on
    # 16-31-token sequences (bf16 on mma.sync, f32 on the CUDA cores)
    "qk_attention_short",  # K2 grid / seq where `qk_fwd_route` gives QK_SHORT (grid_attention,
                           # seq_attention; their f32 forms beside qk_attention_short_f32)
    "qk_attention_cuda_cores",  # the forward core on attention.cu where `qk_fwd_route`
                                # gives QK_CUDA_CORES (other head dims and lengths)
    # the QK-norm sublayer's projections: q, kv and the output product (three a
    # forward; q and kv, two, a backward's recompute)
    "qk_proj_tc",          # bf16 on ffn_tc.cu (`wgmma`: the NT store and residual forms)
    "qk_proj_gemm",        # on gemm.cu (bf16 at widths TMA cannot take, and f32 outside the
                           # 3xTF32 forward: the backwards' recompute, other head dims)
    # ffn_tc.cu's bf16 K11 on the tensor cores (`wgmma`), beside geglu_ff_bwd
    "ff_tc_tile",          # the tile: a, g, dact and the GEGLU derivative (one a call)
    "ff_tc_gemm",          # its products: dxn (NN), [dwa; dwg] and dwo (TN), three a call;
                           # K16a's three (yb NT, dW TN, dxn NN with the LN sums or stored)
    "ff_tc_ln_sums",       # K16a's dxn = dyb W reduced to the LN(4000) sums in the
                           # product's epilogue (patch_embed_bwd without d(volume))
    "ff_tc_fwd",           # K3 bf16 after its LN: the GEGLU and residual products on
                           # ffn_tc.cu (one a call, beside geglu_ff) where `ops/ffn.py::
                           # fwd_route` gives FF_WGMMA
    # embed_tc.cu's bf16 K4 / K8 on the tensor cores (`wgmma`), beside row_embed /
    # patch_embed: the row statistics, the product on tiles normalised in shared
    # memory, LN(dim) (one a call)
    "embed_tc",
    # vq_tc.cu's K5 inference assignment on the tensor cores (`wgmma`), beside
    # vq_assign / vq_assign_f32
    "vq_assign_tc",        # one a call: bf16 rows, or f32 rows after the pre-pass
    "vq_assign_exact_tc",  # K5's exact mode there (beside vq_assign_exact / _f32): one a call,
                           # bf16 rows, or f32 rows after the splitting pre-pass
    # ffn_tc32.cu's f32 K3 in 3xTF32 on the tensor cores (`wgmma`), beside geglu_ff
    "geglu_ff_tc32",       # the weight split, the GEGLU product and the residual product
    "tc32_gemm",           # one product there (plain store or + x): K1 and K2 f32's q, kv
                           # and output projections, three a call beside qk_attention_tc32
                           # or qk_attention_short; K11 f32's dxn (one a call); K9 / K10
                           # f32's q and kv recompute, dmerged, dxn, dx_kv (five a call)
    # ffn_tc32.cu's f32 backwards in 3xTF32 on the tensor cores (`wgmma`)
    "ff_tc32_tile",        # K11 f32's tile: a, g, dact, the GEGLU derivative (one a call,
                           # beside geglu_ff_bwd)
    "tc32_gemm_tn",        # a weight gradient over all rows (TN): K11's [dwa; dwg], dwo
                           # (two a call); K9 / K10's dWq, dWkv, dWout (three)
    "qk_attention_short_bwd",  # K10's core on 16-31-token sequences (qknorm_attention_short.cu)
                               # where `qk_bwd_route` gives QK_SHORT, bf16 or f32 (the f32 form
                               # beside qk_attention_short_bwd_f32)
    "qk_attention_short_bwd_f32",
    # the f32 forms, counted beside the function's own counter
    "geglu_ff_f32",        # K3 f32 (gemm.cu f32 products, layernorm.cu f32 rows)
    "geglu_ff_bwd_f32",    # K11 f32
    "spatial_attention_f32",  # K1 f32 (attention.cu attention_f32_kernel)
    "grid_attention_f32",  # K2 grid f32
    "seq_attention_f32",   # K2 seq f32
    "qk_attention_short_f32",  # K2's f32 core (qknorm_attention_short.cu)
    "vq_assign_f32",       # K5 on f32 rows (vq_tc.cu's pre-pass and assignment; gemm.cu's
                           # gemm_argmax_kernel f32-row form at widths vq_tc.cu does not fit)
    "rearrange_patches_f32",  # K6 f32 (rearrange.cu)
    "unrearrange_patches_f32",  # K17 f32
    "spatial_attention_bwd_f32",  # K9 f32 (qknorm_attention_bwd.cu qk_attention_bwd_f32_kernel)
    "grid_attention_bwd_f32",  # K10 grid f32
    "seq_attention_bwd_f32",  # K10 seq f32
    "vq_assign_exact_f32",  # K5 exact on f32 rows (gemm.cu gemm_argmax3_rows_kernel)
    "vq_cluster_stats_f32",  # K15 on f32 rows (vq_stats.cu sum_f32_kernel)
    "peg_fwd_f32",         # the PEG forward in f32 (peg_stencil.cu)
    "peg_bwd_f32",         # K14 in f32 (peg_stencil.cu)
    # the plain routes where the JAX package runs XLA in f32 (`ROUTES`)
    "patch_embed_plain",   # K8 / K16a f32: patch_embed_plain and its autograd
    "row_embed_plain",     # K4 / K16b f32: row_embed_plain and its autograd
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
# and runs XLA in f32: patchify.py:440, 685, 700, 714); any other dtype a
# ValueError.  K5 and K15 on f32 rows also follow the shape test of vq.py's
# _plan (ops/vq.py::vq_route).  Nothing gives way quietly.  The PEG in f32
# is XLA in JAX too (peg.py:106: the forward `xla_peg_conv`, the backward
# `jax.vjp` of it, :234-246), but the port computes that function, forward,
# dx, dW and db, with the stencil in both dtypes (peg_stencil.cu): its plain
# versions are 27 full-size shifted products and reductions a call, and a
# plain version stays off the card's path.
ROUTES = {
    "patch_embed": {BF16: KERNEL, F32: PLAIN},         # K8
    "patch_embed_bwd": {BF16: KERNEL, F32: PLAIN},     # K16a
    "row_embed": {BF16: KERNEL, F32: PLAIN},           # K4
    "row_embed_bwd": {BF16: KERNEL, F32: PLAIN},       # K16b
    "peg_bwd": {BF16: KERNEL, F32: KERNEL},            # K14
    "peg_fwd": {BF16: KERNEL, F32: KERNEL},            # the PEG forward (XLA's conv in JAX)
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
        "ct_patch_layernorm": [p, i, i, i, i, i, i, p, p, f, p, p, p],
        "ct_layernorm_split_f32": [p, i, i, p, p, f, p, p, p],
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
        "ct_ff_tc_gemm_bias": [p, i, p, i, i, i, i, p, p, i, p],
        "ct_ff_tc_gemm_nt": [p, i, p, i, i, i, i, p, i, p],
        "ct_ff_tc_gemm_nt_f32": [p, i, p, i, i, i, i, p, i, p],
        "ct_ff_tc_ln_sums": [p, i, p, i, i, i, i, p, i, i, i, i, i, i, p, p, p],
        "ct_ff_tc_geglu": [p, i, p, i, i, i, i, p, i, p],
        "ct_ff_tc_residual": [p, i, p, i, i, i, i, p, i, p, i, p],
        "ct_vq_assign_tc": [p, i, p, i, i, i, i, p, p],
        "ct_vq_assign_exact_tc": [p, p, i, p, p, i, i, i, i, p, p],
        "ct_vq_rows_bf16": [p, i, i, p, p, p],
        "ct_tc32_split": [p, p, p, ll, p],
        "ct_ff_tc32_geglu": [p, p, i, p, p, p, p, i, i, i, i, p, p, i, p],
        "ct_ff_tc32_residual": [p, p, i, p, p, i, i, i, i, p, p, i, p],
        "ct_tc32_gemm": [p, p, i, p, p, i, i, i, i, p, i, p],
        "ct_tc32_split_t": [p, p, i, i, i, i, i, p, p, p, p, i, p],
        "ct_ff_tc32_tile": [p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, p, p, p, p, p, p, i, p],
        "ct_tc32_gemm_tn": [p, p, i, p, p, i, i, i, i, i, p, p],
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
        "ct_qk_attention_tc_fwd": [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, i, p,
                                   p, p, p, p, p, p, p],
        "ct_qk_attention_tc32_fwd": [p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i,
                                     i, p, p, p, p, p, p, p, p],
        "ct_qk_attention_short": [p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, i, p, p,
                                  p],
        "ct_qk_attention_short_f32": [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, i,
                                      p, p, p],
        "ct_qk_attention_short_bwd_f32": [p, p, p, p, p, p, p, p, p, p, p, p, p, i, ll, ll, ll,
                                          ll, ll, ll, ll, ll, i, i, i, i, i, p, p, p, p, p],
        "ct_qk_attention_short_bwd": [p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i,
                                      i, i, p, p, p, p, p],
        "ct_peg_fwd": [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "ct_peg_fwd_f32": [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "ct_peg_bwd": [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "ct_peg_bwd_f32": [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "ct_vq_cluster_stats": [p, p, i, i, i, p, p, p, p, p, p, p],
        "ct_vq_cluster_stats_f32": [p, p, i, i, i, p, p, p, p, p, p, p],
        "ct_embed_stats": [p, i, p, i, i, i, i, i, i, i, i, f, p, p],
        "ct_embed_tc": [p, i, p, i, i, i, i, i, i, p, i, p, p, p, p, p, f, i, i, i, p, p, p],
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
    (`wgmma`, w read MN-major): K11's dxn = [da | dg] [wa; wg], the QK-norm
    sublayer's backward dxn = dq wq, dx_kv = dkv wkv and (K10) dmerged = dO
    wout; out bf16 rounds each element once (K9's dmerged) (counted
    `ff_tc_gemm`)."""
    _ff_tc_operands("gemm_nn_tc", dy=dy, w=w)
    M, K = dy.shape
    N = w.shape[1]
    if w.shape[0] != K or tuple(out.shape) != (M, N) or out.dtype not in FORMS \
            or out.stride(1) != 1 or out.stride(0) % 2 or out.data_ptr() % 16 \
            or out.device != dy.device:
        raise ValueError(f"gemm_nn_tc: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)} {out.dtype}")
    layout = 0 if out.dtype == F32 else 2
    err = library().ct_ff_tc_gemm(layout, _ptr(dy), dy.stride(0), _ptr(w), w.stride(0), M, N, K,
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


def gemm_bias_tc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """out (M, N) bf16 = bf16(bf16(x w^T) + bias) for x (M, K) and w (N, K)
    bf16, bias (N,) bf16, on ffn_tc.cu ("NT", `wgmma`, both K-major): K16a's
    recompute of yb, rounded as gemm.cu's EPI_BIAS_ROUNDED rounds it (counted
    `ff_tc_gemm`)."""
    _ff_tc_operands("gemm_bias_tc", x=x, w=w)
    require(bias, "bias", BF16, 1)
    M, K = x.shape
    N = w.shape[0]
    if w.shape[1] != K or bias.shape != (N,):
        raise ValueError(f"gemm_bias_tc: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty((M, N), dtype=BF16, device=x.device)
    err = library().ct_ff_tc_gemm_bias(_ptr(x), x.stride(0), _ptr(w), w.stride(0), M, N, K,
                                       _ptr(bias), _ptr(out), N, _stream())
    _check(err, "ct_ff_tc_gemm_bias")
    count_launch("ff_tc_gemm")
    return out


def gemm_nt_tc(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """out (M, N) bf16 = bf16(x w^T) for x (M, K) and w (N, K) bf16 on
    ffn_tc.cu's NT store form (`wgmma`, one m64n128k16 a k16 slice): the
    QK-norm sublayer's q and kv projections, rounded once as gemm.cu's
    EPI_STORE rounds them; with out_dtype f32 the unrounded f32 sums
    (GEMM_NT_F32: K10 bf16's recompute, kept f32 as small_attention.py
    :278-279 keeps it) (counted `qk_proj_tc`)."""
    _ff_tc_operands("gemm_nt_tc", x=x, w=w)
    M, Kd = x.shape
    N = w.shape[0]
    if w.shape[1] != Kd or out_dtype not in FORMS:
        raise ValueError(f"gemm_nt_tc: x {tuple(x.shape)}, w {tuple(w.shape)} -> {out_dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    entry = "ct_ff_tc_gemm_nt_f32" if out_dtype == F32 else "ct_ff_tc_gemm_nt"
    _check(getattr(library(), entry)(_ptr(x), x.stride(0), _ptr(w), w.stride(0), M, N, Kd,
                                     _ptr(out), N, _stream()), entry)
    count_launch("qk_proj_tc")
    return out


def gemm_residual_tc(a: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out (M, N) bf16 = bf16(f32(a w^T) + x) for a (M, K), w (N, K) and x
    (M, N) bf16 on ffn_tc.cu's residual form (K3's; x read in the epilogue,
    one rounding): the QK-norm sublayer's output product (counted
    `qk_proj_tc`)."""
    _ff_tc_operands("gemm_residual_tc", a=a, w=w, x=x)
    M, Kd = a.shape
    N = w.shape[0]
    if w.shape[1] != Kd or x.shape != (M, N):
        raise ValueError(f"gemm_residual_tc: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x.shape)}")
    out = torch.empty((M, N), dtype=BF16, device=a.device)
    _check(library().ct_ff_tc_residual(_ptr(a), a.stride(0), _ptr(w), w.stride(0), M, N, Kd,
                                       _ptr(x), x.stride(0), _ptr(out), N, _stream()),
           "ct_ff_tc_residual")
    count_launch("qk_proj_tc")
    return out


def ff_tc_fwd(x: torch.Tensor, xn: torch.Tensor, wcat: torch.Tensor, wo: torch.Tensor,
              lib=None) -> torch.Tensor:
    """The bf16 K3 after its LN on ffn_tc.cu (`wgmma`, both products "NT"):
    x (M, D), xn = LN(x) (M, D), wcat (2 P, D) = [wa; wg] and wo (D, P), P
    the inner width padded to a multiple of 8 with zero rows of wa and wg
    and zero columns of wo -> out = bf16(act wo^T + x) (M, D), act =
    bf16(a gelu(g)) (M, P) with a = xn wa^T, g = xn wg^T, rounded where
    gemm.cu's EPI_GEGLU and EPI_RESIDUAL round them.  Counted `ff_tc_fwd`
    once, after both launches.  `lib`: a one-change copy of ffn_tc.cu
    (`copy_library`) to launch instead."""
    _ff_tc_operands("ff_tc_fwd", x=x, xn=xn, wcat=wcat, wo=wo)
    M, D = x.shape
    P = wo.shape[1]
    if xn.shape != x.shape or wcat.shape != (2 * P, D) or wo.shape[0] != D:
        raise ValueError(f"ff_tc_fwd: x {tuple(x.shape)}, xn {tuple(xn.shape)}, wcat "
                         f"{tuple(wcat.shape)}, wo {tuple(wo.shape)}")
    lib = lib or library()
    act = torch.empty((M, P), dtype=BF16, device=x.device)
    _check(lib.ct_ff_tc_geglu(_ptr(xn), xn.stride(0), _ptr(wcat), wcat.stride(0), M, P, D,
                              _ptr(act), P, _stream()), "ct_ff_tc_geglu")
    out = torch.empty((M, D), dtype=BF16, device=x.device)
    _check(lib.ct_ff_tc_residual(_ptr(act), P, _ptr(wo), wo.stride(0), M, D, P, _ptr(x),
                                 x.stride(0), _ptr(out), D, _stream()), "ct_ff_tc_residual")
    count_launch("ff_tc_fwd")
    return out


# K4 / K8 in bf16 on the tensor cores (embed_tc.cu)
EMBED_MAX_K = 4096  # patch_dim: embed_tc.cu's stats pass holds a row in registers
EMBED_MAX_DIM = 512  # dim: a CTA holds whole output rows, for LN(dim) in its epilogue


def embed_fits(patch_dim: int, dim: int, geom=None) -> bool:
    """Whether embed_tc.cu takes the bf16 embed: patch_dim and dim multiples
    of 8 (16-byte rows for TMA), patch_dim <= EMBED_MAX_K, dim <=
    EMBED_MAX_DIM; on the volume (`geom` = (video shape, pt, p)) also p and W
    multiples of 4 (its 8-byte gathers).  Every config of the repo fits;
    `embed_tc` raises on a width that does not."""
    ok = patch_dim % 8 == 0 and dim % 8 == 0 and patch_dim <= EMBED_MAX_K \
        and dim <= EMBED_MAX_DIM
    if geom is not None:
        shape, _, p = geom
        ok = ok and p % 4 == 0 and shape[-1] % 4 == 0
    return ok


def embed_tc(x: torch.Tensor, s1, b1, w: torch.Tensor, pbias, s2, b2, eps: float,
             geom: Optional[tuple] = None, lib=None) -> torch.Tensor:
    """The bf16 patch embed on embed_tc.cu (`wgmma`): (M, dim) bf16 =
    LN(dim)(bf16(bf16(xn w^T) + pbias)), xn = LN(patch_dim) of the rows,
    rounded where patchify.py::_rows_embed_math rounds them.  The rows: x
    (M, patch_dim) bf16 with contiguous rows (K4), or, with geom = (pt, p),
    the patch rows of the (B, F, H, W) bf16 volume x (K8).  w (dim,
    patch_dim); s1, b1 (patch_dim,), pbias, s2, b2 (dim,).  Raises on a
    width `embed_fits` refuses.  Counted `embed_tc`.  `lib`: a copy of
    embed_tc.cu (`copy_library`) to launch instead."""
    lib = lib or library()
    bf = BF16
    dim, pd = w.shape
    if geom is None:
        require(x, "x", bf, 2, contiguous=False)
        if x.stride(1) != 1 or x.shape[1] != pd:
            raise ValueError(f"embed_tc: rows {tuple(x.shape)} (contiguous rows) vs w "
                             f"{tuple(w.shape)}")
        M, rows, video, shape = x.shape[0], x, None, None
    else:
        require(x, "video", bf, 4)
        pt, p = geom
        Bv, F, H, W = x.shape
        if F % pt or H % p or W % p or pt * p * p != pd:
            raise ValueError(f"embed_tc: video {tuple(x.shape)} vs {pt}x{p}x{p}, w "
                             f"{tuple(w.shape)}")
        M, rows, video, shape = Bv * (F // pt) * (H // p) * (W // p), None, x, (x.shape, pt, p)
    if not embed_fits(pd, dim, shape):
        raise ValueError(f"embed_tc: patch_dim {pd}, dim {dim}"
                         + ("" if geom is None else f", video {tuple(x.shape)}, p {geom[1]}")
                         + " do not fit embed_tc.cu (kernels.embed_fits)")
    # the rows' statistics first: the card runs them while the operands below
    # are cast
    src = (_ptr(rows), 0 if rows is None else rows.stride(0), _ptr(video),
           *((0,) * 6 if geom is None else (Bv, F, H, W, *geom)))
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device)
    stream = _stream()
    _check(lib.ct_embed_stats(*src, M, pd, float(eps), _ptr(stats), stream), "ct_embed_stats")
    wb = w.to(bf).contiguous()
    pb = pbias.to(bf).contiguous()
    s1, b1 = _f32_vector(s1, pd, "s1"), _f32_vector(b1, pd, "b1")
    s2, b2 = _f32_vector(s2, dim, "s2"), _f32_vector(b2, dim, "b2")
    out = torch.empty((M, dim), dtype=bf, device=x.device)
    _check(lib.ct_embed_tc(*src, _ptr(wb), wb.stride(0), _ptr(s1), _ptr(b1), _ptr(pb),
                           _ptr(s2), _ptr(b2), float(eps), M, dim, pd, _ptr(stats), _ptr(out),
                           stream), "ct_embed_tc")
    count_launch("embed_tc")
    return out


# K5's inference assignment on the tensor cores (vq_tc.cu)
VQ_TC_MAX_DIM = 512  # the widest row vq_tc.cu's resident row tile holds


def vq_tc_fits(dim: int) -> bool:
    """Whether vq_tc.cu takes rows of width `dim`: TMA's 16-byte rows (a
    multiple of 8 bf16) and a row tile that fits shared memory."""
    return dim % 8 == 0 and 0 < dim <= VQ_TC_MAX_DIM


def vq_assign_tc(x: torch.Tensor, codes: torch.Tensor, lib=None) -> torch.Tensor:
    """K5's inference assignment on vq_tc.cu (`wgmma`): ids (M,) int32 =
    argmax_n x[m] . codes[n], f32 sums, a tie to the lower code, for codes
    (N, D) bf16 and x (M, D) bf16 rows (raw) or f32 rows, each of which a
    pre-pass normalises (the order of `ops/vq.py::_lane_inv_norm`) and
    rounds to bf16 first.  D must fit (`vq_tc_fits`).  Counted
    `vq_assign_tc` once a call, after its launches.  `lib`: a one-change
    copy of vq_tc.cu (`copy_library`) to launch instead."""
    require(x, "x", FORMS, 2)
    require(codes, "codes", BF16, 2)
    M, D = x.shape
    if codes.shape[1] != D or not vq_tc_fits(D):
        raise ValueError(f"vq_assign_tc: x {tuple(x.shape)}, codes {tuple(codes.shape)} "
                         f"(width a multiple of 8 up to {VQ_TC_MAX_DIM})")
    lib = lib or library()
    if x.dtype == F32:
        if x.data_ptr() % 16:
            raise ValueError("vq_assign_tc: f32 rows must start on a 16-byte boundary")
        rows = torch.empty((M, D), dtype=BF16, device=x.device)
        _check(lib.ct_vq_rows_bf16(_ptr(x), M, D, _ptr(rows), None, _stream()),
               "ct_vq_rows_bf16")
        x = rows
    _ff_tc_operands("vq_assign_tc", x=x, codes=codes)
    ids = torch.empty((M,), dtype=torch.int32, device=x.device)
    _check(lib.ct_vq_assign_tc(_ptr(x), x.stride(0), _ptr(codes), codes.stride(0), M,
                               codes.shape[0], D, _ptr(ids), _stream()), "ct_vq_assign_tc")
    count_launch("vq_assign_tc")
    return ids


def vq_assign_exact_tc(x: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                       lib=None) -> torch.Tensor:
    """K5's exact assignment on vq_tc.cu (`wgmma`): ids (M,) int32, a tie to
    the lower code, against the normalised codebook's bf16 hi and lo parts
    (N, D) (`ops/vq.py::split_hi_lo`).  bf16 rows x (M, D), raw: argmax_n x
    . hi[n] + x . lo[n]; f32 rows: a pre-pass normalises each (the order of
    `ops/vq.py::_lane_inv_norm`) and splits it into bf16 xh and xl =
    bf16(xn - xh), then argmax_n (xh . hi[n] + xh . lo[n]) + xl . hi[n]; the
    products of each k16 slice summed in f32 in that order.  D must fit
    (`vq_tc_fits`).  Counted `vq_assign_exact_tc` once a call, after its
    launches.  `lib`: a one-change copy of vq_tc.cu (`copy_library`) to
    launch instead."""
    require(x, "x", FORMS, 2)
    for name, t in (("hi", hi), ("lo", lo)):
        require(t, name, BF16, 2)
    M, D = x.shape
    if hi.shape[1] != D or lo.shape != hi.shape or hi.stride(0) != lo.stride(0) \
            or not vq_tc_fits(D):
        raise ValueError(f"vq_assign_exact_tc: x {tuple(x.shape)}, hi {tuple(hi.shape)}, "
                         f"lo {tuple(lo.shape)} (width a multiple of 8 up to {VQ_TC_MAX_DIM})")
    lib = lib or library()
    xl = None
    if x.dtype == F32:
        if x.data_ptr() % 16:
            raise ValueError("vq_assign_exact_tc: f32 rows must start on a 16-byte boundary")
        xh, xl = (torch.empty((M, D), dtype=BF16, device=x.device) for _ in range(2))
        _check(lib.ct_vq_rows_bf16(_ptr(x), M, D, _ptr(xh), _ptr(xl), _stream()),
               "ct_vq_rows_bf16")
        x = xh
    _ff_tc_operands("vq_assign_exact_tc", x=x, hi=hi, lo=lo)
    ids = torch.empty((M,), dtype=torch.int32, device=x.device)
    _check(lib.ct_vq_assign_exact_tc(_ptr(x), _ptr(xl), x.stride(0), _ptr(hi), _ptr(lo),
                                     hi.stride(0), M, hi.shape[0], D, _ptr(ids), _stream()),
           "ct_vq_assign_exact_tc")
    count_launch("vq_assign_exact_tc")
    return ids


LN_SUMS_GROUPS = 32  # first-level groups of the tiles' partial sums (ln_sums_tc)


def ln_sums_plan(rows: int):
    """(tiles, padded tiles) of `ln_sums_tc`'s partials: one row per 128
    rows, padded with zero rows to a multiple of LN_SUMS_GROUPS.  They are
    added in two levels, in a fixed order: the LN_SUMS_GROUPS blocks of
    consecutive rows row by row (one thread a column, each LN_SUMS_GROUPS
    deep), then the rows of that sum."""
    tiles = -(-rows // 128)
    return tiles, -(-tiles // LN_SUMS_GROUPS) * LN_SUMS_GROUPS


def ln_sums_tc(dy: torch.Tensor, w: torch.Tensor, video: torch.Tensor, pt: int, p: int,
               stats: torch.Tensor, lib=None):
    """K16a's LN(pt p p) scale and bias gradients, (ds, db) f32, without dxn
    in device memory: dxn = dy w for dy (M, K) and w (K, N = pt p p) bf16 on
    ffn_tc.cu ("NN", `wgmma`), each f32 accumulator times xhat = (x - mean)
    rstd, x read from the bf16 video (B, F, H, W) through the patch gather,
    mean and rstd from the recompute's stats (M, 2) f32 (`patch_layernorm`);
    the 128-row tiles' column sums added in order (`ln_sums_plan`, two
    levels of sum_splits) (counted `ff_tc_gemm` and `ff_tc_ln_sums`).  p and
    W must be multiples of 4 (the volume tile is copied 4 columns at a
    time).  `lib`: a one-change copy of ffn_tc.cu (`copy_library`)
    to launch instead, for the card checks."""
    _ff_tc_operands("ln_sums_tc", dy=dy, w=w)
    require(video, "video", BF16, 4)
    require(stats, "stats", F32, 2)
    M, K = dy.shape
    N = w.shape[1]
    B, F, H, W = video.shape
    if (w.shape[0] != K or N != pt * p * p or F % pt or H % p or W % p or p % 4 or W % 4
            or M != B * (F // pt) * (H // p) * (W // p) or stats.shape != (M, 2)
            or video.data_ptr() % 16):
        raise ValueError(f"ln_sums_tc: dy {tuple(dy.shape)}, w {tuple(w.shape)}, video "
                         f"{tuple(video.shape)} vs {pt}x{p}x{p} (p and W multiples of 4), "
                         f"stats "
                         f"{tuple(stats.shape)}")
    tiles, padded = ln_sums_plan(M)
    part = torch.empty((padded, 2 * N), dtype=F32, device=dy.device)
    part[tiles:].zero_()
    err = (lib or library()).ct_ff_tc_ln_sums(
        _ptr(dy), dy.stride(0), _ptr(w), w.stride(0), M, N, K, _ptr(video), B, F, H, W, pt, p,
        _ptr(stats), _ptr(part), _stream())
    _check(err, "ct_ff_tc_ln_sums")
    count_launch("ff_tc_gemm")
    count_launch("ff_tc_ln_sums")
    sums = sum_splits(sum_splits(part.view(LN_SUMS_GROUPS, -1)).view(-1, 2 * N))
    return sums[:N], sums[N:]


# the f32 K3 in 3xTF32 on the tensor cores (ffn_tc32.cu)
def _tc32_operands(name: str, **tensors) -> None:
    """f32 (rows, width) tensors with contiguous rows whose widths, row
    strides and bases are multiples of 16 bytes: ffn_tc32.cu's TMA copies."""
    for key, t in tensors.items():
        _rows_contig(t, key)
        if t.dtype != F32 or t.shape[1] % 4 or t.stride(0) % 4 or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be f32 with widths, row strides and bases "
                             f"of multiples of 16 bytes (got {t.dtype} {tuple(t.shape)}, "
                             f"stride {t.stride(0)})")


def ff_tc32(x: torch.Tensor, xn_hi: torch.Tensor, xn_lo: torch.Tensor, w: torch.Tensor,
            lib=None) -> torch.Tensor:
    """The f32 K3 after its LN, in 3xTF32 on ffn_tc32.cu (`wgmma`): x (M, D)
    f32, LN(x) split as xn_hi, xn_lo (`layernorm_split`), w (3, P D) f32 the
    value and gate weights (P, D) and wo (D, P) side by side, P the inner
    width padded to a multiple of 4 with zero rows (and columns of wo) ->
    act wo^T + x, f32 (M, D), act = a gelu(g) with a = xn wa^T, g = xn wg^T.
    Splits w into TF32 hi and lo planes, then the GEGLU product (act written
    split) and the residual product (counted `geglu_ff_tc32` once, after the
    three launches).  `lib`: a one-change copy of ffn_tc32.cu
    (`copy_library`, e.g. CT_TC32_PASSES=1) to launch instead."""
    _tc32_operands("ff_tc32", x=x, xn_hi=xn_hi, xn_lo=xn_lo)
    require(w, "w", F32, 2)
    M, D = x.shape
    P = w.shape[1] // D
    if xn_hi.shape != x.shape or xn_lo.shape != x.shape or w.shape != (3, P * D) or P % 4:
        raise ValueError(f"ff_tc32: x {tuple(x.shape)}, xn {tuple(xn_hi.shape)}, "
                         f"w {tuple(w.shape)}")
    lib = lib or library()
    hi, lo = tc32_split(w, lib)
    act_hi = torch.empty((M, P), dtype=F32, device=x.device)
    act_lo = torch.empty_like(act_hi)
    _check(lib.ct_ff_tc32_geglu(_ptr(xn_hi), _ptr(xn_lo), D, _ptr(hi[0]), _ptr(lo[0]),
                                _ptr(hi[1]), _ptr(lo[1]), D, M, P, D, _ptr(act_hi),
                                _ptr(act_lo), P, _stream()), "ct_ff_tc32_geglu")
    out = torch.empty_like(x)
    _check(lib.ct_ff_tc32_residual(_ptr(act_hi), _ptr(act_lo), P, _ptr(hi[2]), _ptr(lo[2]), P,
                                   M, D, P, _ptr(x), _ptr(out), D, _stream()),
           "ct_ff_tc32_residual")
    count_launch("geglu_ff_tc32")
    return out


def tc32_split(x: torch.Tensor, lib=None):
    """A contiguous f32 tensor -> its TF32 hi plane and lo plane, hi + lo =
    x exactly (ffn_tc32.cu's tc32_split_kernel: tc32.cuh's split)."""
    require(x, "x", F32, x.dim())
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    _check((lib or library()).ct_tc32_split(_ptr(x), _ptr(hi), _ptr(lo), x.numel(), _stream()),
           "ct_tc32_split")
    return hi, lo


def tc32_gemm(a_hi: torch.Tensor, a_lo: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
              residual: Optional[torch.Tensor] = None, lib=None) -> torch.Tensor:
    """out (M, N) = A W^T in 3xTF32 on ffn_tc32.cu (`wgmma`), f32: A (M, K)
    and W (N, K) each as its TF32 hi and lo planes (`tc32_split`,
    `layernorm_split`, `tc32_split_t`, or a kernel's split output); with
    `residual` (M, N) f32, contiguous, the residual form adds it to the f32
    sum once (ct_ff_tc32_residual), without it the plain-store form
    (ct_tc32_gemm).  Counted `tc32_gemm` at the launch.  `lib`: a one-change
    copy of ffn_tc32.cu (`copy_library`) to launch instead."""
    ops = dict(a_hi=a_hi, a_lo=a_lo, w_hi=w_hi, w_lo=w_lo)
    if residual is not None:
        ops["residual"] = residual
    _tc32_operands("tc32_gemm", **ops)
    (M, Kd), N = a_hi.shape, w_hi.shape[0]
    if a_lo.shape != a_hi.shape or w_lo.shape != w_hi.shape or w_hi.shape[1] != Kd \
            or a_lo.stride(0) != a_hi.stride(0) or w_lo.stride(0) != w_hi.stride(0) \
            or (residual is not None and (residual.shape != (M, N) or residual.stride(0) != N)):
        raise ValueError(f"tc32_gemm: A {tuple(a_hi.shape)} / {tuple(a_lo.shape)}, W "
                         f"{tuple(w_hi.shape)} / {tuple(w_lo.shape)}, residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    lib = lib or library()
    out = torch.empty((M, N), dtype=F32, device=a_hi.device)
    a_args = (_ptr(a_hi), _ptr(a_lo), a_hi.stride(0), _ptr(w_hi), _ptr(w_lo), w_hi.stride(0),
              M, N, Kd)
    if residual is None:
        name = "ct_tc32_gemm"
        err = lib.ct_tc32_gemm(*a_args, _ptr(out), N, _stream())
    else:
        name = "ct_ff_tc32_residual"
        err = lib.ct_ff_tc32_residual(*a_args, _ptr(residual), _ptr(out), N, _stream())
    _check(err, name)
    count_launch("tc32_gemm")
    return out


def tc32_split_t(x: torch.Tensor, x2: Optional[torch.Tensor] = None, *, rows: bool = False,
                 seq=(1, 1), lib=None):
    """x (R, C) f32 with contiguous rows (+ x2 of its layout: the lo plane of
    a split x, whose sum with x is exact) -> the TF32 hi and lo planes
    transposed, (C, R) views of (C, ldt) tensors, ldt = R rounded up to a
    multiple of 4 (ffn_tc32.cu's tc32_split_t_kernel); with `rows` also the
    row-major planes (R, C) first: (hi, lo, hi_t, lo_t).  `seq` = (n, S):
    the transposed planes take the rows of a (b, n, S) token grid in the
    order of its t-columns, (b S + s) n + t for row (b n + t) S + s (K10
    grid's order: the TN products' operands must share it); (1, 1) keeps
    the order."""
    ops = dict(x=x) if x2 is None else dict(x=x, x2=x2)
    _tc32_operands("tc32_split_t", **ops)
    R, C = x.shape
    n, S = seq
    if (x2 is not None and (x2.shape != x.shape or x2.stride(0) != x.stride(0))) \
            or R % (n * S):
        raise ValueError(f"tc32_split_t: x {tuple(x.shape)}, grid (n, S) {seq}")
    ldt = -(-R // 4) * 4
    hi_t, lo_t = (torch.empty((C, ldt), dtype=F32, device=x.device) for _ in range(2))
    hi = lo = None
    if rows:
        hi, lo = (torch.empty((R, C), dtype=F32, device=x.device) for _ in range(2))
    _check((lib or library()).ct_tc32_split_t(
        _ptr(x), _ptr(x2), R, C, x.stride(0), n, S, _ptr(hi), _ptr(lo), _ptr(hi_t), _ptr(lo_t),
        ldt, _stream()), "ct_tc32_split_t")
    planes = (hi_t[:, :R], lo_t[:, :R])
    return (hi, lo) + planes if rows else planes


def ff_tc32_tile(xn_hi: torch.Tensor, xn_lo: torch.Tensor, do_hi: torch.Tensor,
                 do_lo: torch.Tensor, wa: tuple, wg: tuple, wo_t: tuple, lib=None):
    """K11 f32's tile in 3xTF32 on ffn_tc32.cu (`wgmma`): from LN(x) and dout
    (M, D), each as its TF32 hi and lo planes, and the (hi, lo) planes of
    wa, wg and wo^T (P, D) (P the inner width padded to a multiple of 4 with
    zero rows), a = xn wa^T, g = xn wg^T and dact = dout wo, then act =
    a gelu(g), da = dact gelu(g), dg = dact a (Phi(g) + g phi(g)) in f32 ->
    (dcat hi, lo) (M, 2P) = [da | dg], (dcat^T hi, lo) (2P, M) and (act^T
    hi, lo) (P, M): the operands of the NN product dxn = dcat [wa; wg] and
    of the TN products (`tc32_gemm_tn`).  Counted `ff_tc32_tile`.  `lib`: a
    one-change copy of ffn_tc32.cu (`copy_library`) to launch instead."""
    ws = dict(wa_hi=wa[0], wa_lo=wa[1], wg_hi=wg[0], wg_lo=wg[1], wo_hi=wo_t[0], wo_lo=wo_t[1])
    _tc32_operands("ff_tc32_tile", xn_hi=xn_hi, xn_lo=xn_lo, do_hi=do_hi, do_lo=do_lo, **ws)
    M, D = xn_hi.shape
    P = wa[0].shape[0]
    ldx, ldw = xn_hi.stride(0), wa[0].stride(0)
    if any(t.shape != (M, D) or t.stride(0) != ldx for t in (xn_lo, do_hi, do_lo)) \
            or any(t.shape != (P, D) or t.stride(0) != ldw for t in ws.values()) or P % 4:
        raise ValueError(f"ff_tc32_tile: xn {tuple(xn_hi.shape)}, wa {tuple(wa[0].shape)}: "
                         "shapes or row strides do not fit")
    ldt = -(-M // 4) * 4
    dev = xn_hi.device
    dcat_hi, dcat_lo = (torch.empty((M, 2 * P), dtype=F32, device=dev) for _ in range(2))
    dcat_t_hi, dcat_t_lo = (torch.empty((2 * P, ldt), dtype=F32, device=dev) for _ in range(2))
    act_t_hi, act_t_lo = (torch.empty((P, ldt), dtype=F32, device=dev) for _ in range(2))
    _check((lib or library()).ct_ff_tc32_tile(
        _ptr(xn_hi), _ptr(xn_lo), _ptr(do_hi), _ptr(do_lo), ldx, *map(_ptr, ws.values()), ldw,
        M, P, D, _ptr(dcat_hi), _ptr(dcat_lo), _ptr(dcat_t_hi), _ptr(dcat_t_lo), _ptr(act_t_hi),
        _ptr(act_t_lo), ldt, _stream()), "ct_ff_tc32_tile")
    count_launch("ff_tc32_tile")
    return (dcat_hi, dcat_lo, dcat_t_hi[:, :M], dcat_t_lo[:, :M], act_t_hi[:, :M],
            act_t_lo[:, :M])


TC32_TN_SPLIT_ROWS = 8192  # rows of a TN product's split, at most
TC32_TN_CTAS = 264  # CTAs of a TN product to aim for: two per SM of the H100's 132
TC32_FLUSH_ROWS = 256  # a split's rows are whole k ranges of ffn_tc32.cu (FLUSH x 32)


def tc32_tn_split(rows: int, tiles: int) -> int:
    """Rows per split of a TN product over `rows` rows with `tiles` output
    tiles of 128 x 128: the fewest splits of at most TC32_TN_SPLIT_ROWS rows
    that give TC32_TN_CTAS CTAs, each a multiple of TC32_FLUSH_ROWS."""
    splits = max(-(-rows // TC32_TN_SPLIT_ROWS), -(-TC32_TN_CTAS // tiles), 1)
    return -(-rows // (splits * TC32_FLUSH_ROWS)) * TC32_FLUSH_ROWS


def tc32_gemm_tn(a_hi: torch.Tensor, a_lo: torch.Tensor, w_hi: torch.Tensor,
                 w_lo: torch.Tensor, lib=None) -> torch.Tensor:
    """out (M, N) f32 = A W^T over all K in 3xTF32 on ffn_tc32.cu (`wgmma`),
    for A (M, K) and W (N, K) given as transposed TF32 planes (`tc32_split_t`,
    `ff_tc32_tile`, `qk_attention_short_bwd`): K is the rows of a weight
    gradient's two operands, so out is dY^T X.  The rows split in blocks of
    `tc32_tn_split` whose partial sums are added in order (sum_splits).
    Counted `tc32_gemm_tn`.  `lib`: a one-change copy of ffn_tc32.cu to
    launch instead."""
    for key, t in dict(a_hi=a_hi, a_lo=a_lo, w_hi=w_hi, w_lo=w_lo).items():
        _rows_contig(t, key)
        if t.dtype != F32 or t.stride(0) % 4 or t.data_ptr() % 16:
            raise ValueError(f"tc32_gemm_tn: {key} must be f32 with row strides and bases of "
                             f"multiples of 16 bytes")
    (M, Kr), N = a_hi.shape, w_hi.shape[0]
    if a_lo.shape != a_hi.shape or w_lo.shape != w_hi.shape or w_hi.shape[1] != Kr \
            or a_lo.stride(0) != a_hi.stride(0) or w_lo.stride(0) != w_hi.stride(0) \
            or M % 4 or N % 4:
        raise ValueError(f"tc32_gemm_tn: A {tuple(a_hi.shape)}, W {tuple(w_hi.shape)}")
    chunk = tc32_tn_split(Kr, -(-M // 128) * -(-N // 128))
    splits = -(-Kr // chunk)
    part = torch.empty((splits, M, N), dtype=F32, device=a_hi.device)
    _check((lib or library()).ct_tc32_gemm_tn(
        _ptr(a_hi), _ptr(a_lo), a_hi.stride(0), _ptr(w_hi), _ptr(w_lo), w_hi.stride(0), M, N,
        Kr, chunk, _ptr(part), _stream()), "ct_tc32_gemm_tn")
    count_launch("tc32_gemm_tn")
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


def layernorm_split(x: torch.Tensor, scale: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], eps: float):
    """Row LN of a contiguous (rows, D) f32 tensor, written split for 3xTF32
    (layernorm.cu's LN_SPLIT form): the TF32 hi plane and the lo plane, (rows,
    D) f32 each, hi + lo the f32 LN(x)."""
    require(x, "x", F32, 2)
    rows, D = x.shape
    if D > 4096:
        raise ValueError(f"layernorm_split: bad shape {tuple(x.shape)}")
    scale, bias = _f32_vector(scale, D, "scale"), _f32_vector(bias, D, "bias")
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    err = library().ct_layernorm_split_f32(_ptr(x), rows, D, _ptr(scale), _ptr(bias),
                                           float(eps), _ptr(hi), _ptr(lo), _stream())
    _check(err, "ct_layernorm_split_f32")
    return hi, lo


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
                    out: torch.Tensor, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F, H, W) video -> LN over each (pt, p, p) patch (layernorm.cu);
    with `stats` (rows, 2) f32, each row's mean and rstd written there too
    (K16a's recompute, patch_ln_stats_kernel: p and W multiples of 4)."""
    require(video, "video", torch.bfloat16, 4)
    require(out, "out", torch.bfloat16, 2)
    B, F, H, W = video.shape
    D = pt * p * p
    if F % pt or H % p or W % p or D > 4096:
        raise ValueError(f"patch_layernorm: {tuple(video.shape)} vs {pt}x{p}x{p}")
    rows = B * (F // pt) * (H // p) * (W // p)
    if out.shape != (rows, D):
        raise ValueError("patch_layernorm: bad out shape")
    if stats is not None:  # the 8-byte gathers of patch_ln_stats_kernel
        require(stats, "stats", torch.float32, 2)
        if stats.shape != (rows, 2) or p % 4 or W % 4:
            raise ValueError(f"patch_layernorm: stats {tuple(stats.shape)}, want ({rows}, 2), "
                             f"with p ({p}) and W ({W}) multiples of 4")
    scale, bias = _f32_vector(scale, D, "scale"), _f32_vector(bias, D, "bias")
    err = library().ct_patch_layernorm(_ptr(video), B, F, H, W, pt, p,
                                       _ptr(scale), _ptr(bias), float(eps),
                                       _ptr(out), _ptr(stats), _stream())
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
QK_TC_MIN_TOKENS = 32  # half a 64-row tile; below it K10 keeps the CUDA cores, K2 `qk_fwd_route`
QK_SHORT_MIN_TOKENS = 16  # the least n the short-sequence forward core takes
# dbias-pass CTAs to aim for, one wave of three per SM (132): 576-token planes
# give 648 CTAs of one group; three waves (two groups) read no faster
QK_TC_DBIAS_CTAS = 396
# the routes of the core's backward (`qk_bwd_tensor_cores`)
QK_WGMMA, QK_TC32, QK_CUDA_CORES = "wgmma", "tc32", "cuda_cores"
# ... and the forward's short-sequence core (`qk_fwd_route`)
QK_SHORT = "short"
# the dynamic shared memory the largest pass of qknorm_attention_tc32.cu
# takes (its dbias pass: the bias tile and two stages of qn, dO, kn, v, lse
# and D, 1024-byte aligned); the same at every n
QK_TC32_BWD_SMEM = 1024 + 18432 + 2 * 37888
# ... and the forward passes' with the bias (qk_tc_fwd: [qn | qn], two stages
# of [kn | v] and the bias tile; qk32_fwd: qn, two stages of kn, v and the
# bias tile), the same at every n
QK_TC_FWD_SMEM = 1024 + 8192 + 2 * 26624
QK_TC32_FWD_SMEM = 1024 + 9216 + 2 * 36864


def qk_bwd_tensor_cores(dtype: torch.dtype, n: int, d: int) -> str:
    """The route of the QK-norm attention core's backward, and of its
    forward from 32 tokens on, on `n`-token sequences of head dim `d`:
    QK_WGMMA, qknorm_attention_tc.cu (bf16 `wgmma`), or QK_TC32,
    qknorm_attention_tc32.cu (f32 in 3xTF32 on `mma.sync`, and the f32
    sublayer's projections in 3xTF32 on ffn_tc32.cu), for K1's and K9's 576-
    and 64-token planes with or without the bias and any ragged n from 32 in
    zero-filled 64-row tiles; otherwise QK_CUDA_CORES: the backward on
    qknorm_attention_bwd.cu (qk_attention_bwd_kernel and its f32 form: other
    head dims and lengths; `qk_bwd_route` sends K10's 16-31-token sequences
    to qknorm_attention_short.cu).  The forward below
    32 tokens reads `qk_fwd_route` (K2's sequences take
    qknorm_attention_short.cu).
    `qk_attention_fwd`, `qk_attention_short`, `_qk_tc_bwd` and `_qk_tc32_bwd`
    count each launch of their route."""
    if d != QK_TC_HEAD_DIM or n < QK_TC_MIN_TOKENS:
        return QK_CUDA_CORES
    return {BF16: QK_WGMMA, F32: QK_TC32}.get(dtype, QK_CUDA_CORES)


def qk_short_smem(n: int, heads: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a CTA of qknorm_attention_short.cu takes: one
    sequence's n token rows of q (heads x 32) and kv (2 heads x 32), each
    padded by 16 bytes, and the two scale vectors."""
    return n * (3 * heads * QK_TC_HEAD_DIM * (4 if dtype == F32 else 2) + 32) + 256


def qk_fwd_route(dtype: torch.dtype, n: int, d: int, heads: int, bias: bool = False) -> str:
    """The route of the QK-norm attention core's forward: `qk_bwd_tensor_cores`'
    QK_WGMMA or QK_TC32 (K1's planes, n >= 32); QK_SHORT, qknorm_attention_short.cu
    (bf16 on `mma.sync`, f32 on the CUDA cores, and in f32 the sublayer's
    projections in 3xTF32 on ffn_tc32.cu), for K2's 16-31-token sequences at
    head dim 32 without a bias, in both its layouts, where one sequence's rows
    fit a CTA's shared memory; otherwise QK_CUDA_CORES, attention.cu
    (attention_kernel and its f32 form, counted `qk_attention_cuda_cores`).
    A shape gate: the backward keeps its own (`qk_bwd_tensor_cores`)."""
    core = qk_bwd_tensor_cores(dtype, n, d)
    if (core == QK_CUDA_CORES and dtype in FORMS and d == QK_TC_HEAD_DIM and not bias
            and QK_SHORT_MIN_TOKENS <= n < QK_TC_MIN_TOKENS
            and qk_short_smem(n, heads, dtype) <= SMEM_LIMIT):
        return QK_SHORT
    return core


QK_SHORT_BWD_HEADS = 4  # heads of a CTA of the short backward core: one a warp


def qk_short_bwd_smem(n: int, heads: int) -> int:
    """Bytes of shared memory a CTA of qknorm_attention_short.cu's backward
    takes, in either form (both read f32 q, kv and dO): its group of heads'
    n token rows of q, k, v and dO in f32 (up to QK_SHORT_BWD_HEADS x 32
    each, padded by 16 bytes), each
    warp's n x (n | 1) tiles of P and dS, and its static scratch (the
    scales, the rows' norms, the scale sums)."""
    width = min(heads, QK_SHORT_BWD_HEADS) * QK_TC_HEAD_DIM + 4
    return 4 * (4 * n * width + QK_SHORT_BWD_HEADS * 2 * n * (n | 1)) + 4096


def qk_bwd_route(dtype: torch.dtype, n: int, d: int, heads: int, bias: bool = False) -> str:
    """The route of the QK-norm attention core's backward: `qk_bwd_tensor_cores`'
    QK_WGMMA or QK_TC32 (K9's planes, n >= 32), QK_SHORT for K10's
    16-31-token sequences at head dim 32 without a bias, bf16 or f32, where a
    CTA's rows (one sequence's, up to four heads) fit (`qk_short_bwd_smem`):
    qknorm_attention_short.cu's backward core in true f32 (its bf16 form
    rounds only its outputs, at small_attention.py::_bwd_kernel's points),
    and the sublayer's backward products in 3xTF32 on ffn_tc32.cu (f32) or
    on ffn_tc.cu's bf16 `wgmma` forms (bf16); otherwise QK_CUDA_CORES,
    qknorm_attention_bwd.cu (other head dims and lengths).  The forward's
    gate is `qk_fwd_route`; this one moves none of its answers."""
    core = qk_bwd_tensor_cores(dtype, n, d)
    if (core == QK_CUDA_CORES and dtype in FORMS and d == QK_TC_HEAD_DIM and not bias
            and QK_SHORT_MIN_TOKENS <= n < QK_TC_MIN_TOKENS
            and qk_short_bwd_smem(n, heads) <= SMEM_LIMIT):
        return QK_SHORT
    return core


def qk_tc_dbias_groups(sequences: int, heads: int, n: int) -> int:
    """The dbias pass's groups of sequences: about QK_TC_DBIAS_CTAS CTAs of
    one (64 x 64 tile, head, group), the kernel giving each group
    ceil(sequences / groups) sequences in order, and no group left empty."""
    tiles = -(-n // 64)
    groups = max(1, min(sequences, -(-QK_TC_DBIAS_CTAS // (tiles * tiles * heads))))
    per = -(-sequences // groups)
    return -(-sequences // per)


def _qk_tc_strides(name: str, q_strides, kv_strides, q, *tensors):
    """The eight element strides of a tensor-core core's launch, checked:
    multiples of 16 bytes, every tensor 16-byte aligned."""
    strides = [*map(int, q_strides), *map(int, kv_strides)]
    chunk = _chunk(q)
    if any(st % chunk for st in strides) or any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError(f"{name}: the tensor-core core takes strides of multiples "
                         f"of {chunk} elements and 16-byte aligned tensors")
    return strides


def _qk_core_bwd(entry, counter, q, kv, dout, qs, ks, bias, *, sequences, inner, heads, n, d,
                 q_strides, kv_strides, lib):
    """qk_attention_bwd on a tensor-core source (`entry`, counted `counter`
    where it launches): its scratch (qn, kn in q's dtype and the rows'
    inverse norms, lse, D_i) and the per-CTA scale partials, added in two
    levels (one thread a column would sum 13,824 rows in turn: 0.6 ms); dbias
    from the dbias pass's groups of sequences, added in order."""
    strides = _qk_tc_strides("qk_attention_bwd", q_strides, kv_strides, q, kv, dout)
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


def qk_attention_fwd(q, kv, *, sequences: int, inner: int, heads: int, n: int, d: int,
                     q_strides, kv_strides, q_scale, k_scale,
                     bias: Optional[torch.Tensor] = None, lib=None):
    """The QK-norm attention core's forward (K1's) on the tensor cores, on
    the projections q (rows, h*d) and kv (rows, 2*h*d) [k | v], addressed as
    `qk_attention_bwd` addresses them: softmax(l2norm(q) q_scale (l2norm(k)
    k_scale)^T + bias) v per (sequence, head), q_scale including the logit
    scale, bias (heads, n, n) f32 or None.  bf16 (QK_WGMMA): merged, like
    q, on qknorm_attention_tc.cu, counted `qk_attention_tc`; f32 (QK_TC32):
    (hi, lo), merged's TF32 planes (hi + lo = merged), each laid out as q, in
    3xTF32 on qknorm_attention_tc32.cu, counted `qk_attention_tc32`.  A
    shape `qk_bwd_tensor_cores` sends to the CUDA cores raises (the caller
    launches attention.cu there).  `lib`: a one-change copy (`copy_library`)
    of the source, to launch instead."""
    hd = heads * d
    for name, t, width in (("q", q, hd), ("kv", kv, 2 * hd)):
        require(t, name, q.dtype if name != "q" else FORMS, 2)
        if t.shape[1] != width or t.shape[0] != q.shape[0]:
            raise ValueError(f"qk_attention_fwd: {name} {tuple(t.shape)}")
    core = qk_bwd_tensor_cores(q.dtype, n, d)
    if core == QK_CUDA_CORES:
        raise ValueError(f"qk_attention_fwd: {q.dtype} at n {n}, head dim {d} takes "
                         "qk_attention_short or attention.cu (kernels.qk_fwd_route)")
    strides = _qk_tc_strides("qk_attention_fwd", q_strides, kv_strides, q, kv)
    qs, ks = _f32_vector(q_scale, d, "q_scale"), _f32_vector(k_scale, d, "k_scale")
    if bias is not None:
        require(bias, "bias", torch.float32, 3)
        if tuple(bias.shape) != (heads, n, n):
            raise ValueError(f"qk_attention_fwd: bias {tuple(bias.shape)}")
    qn, kn = (torch.empty((sequences, heads, n, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    rq, rk = (torch.empty((sequences, heads, n), dtype=torch.float32, device=q.device)
              for _ in range(2))
    merged = torch.empty_like(q)
    outs = (merged,) if core == QK_WGMMA else (merged, torch.empty_like(q))
    entry, counter = (("ct_qk_attention_tc_fwd", "qk_attention_tc") if core == QK_WGMMA
                      else ("ct_qk_attention_tc32_fwd", "qk_attention_tc32"))
    err = getattr(lib or library(), entry)(
        _ptr(q), _ptr(kv), _ptr(kv[:, hd:]), *map(_ptr, outs), *strides, inner, sequences, heads,
        n, d, _ptr(qs), _ptr(ks), _ptr(bias), _ptr(qn), _ptr(kn), _ptr(rq), _ptr(rk), _stream())
    _check(err, entry)
    count_launch(counter)
    return merged if core == QK_WGMMA else outs


def qk_attention_short(q, kv, *, sequences: int, inner: int, heads: int, n: int, d: int,
                       q_strides, kv_strides, q_scale, k_scale,
                       bias: Optional[torch.Tensor] = None, lib=None):
    """The QK-norm attention core's forward (K2's) on 16-31-token sequences
    (qknorm_attention_short.cu), on the projections q (rows, h*d) and kv
    (rows, 2*h*d) [k | v] addressed as `qk_attention_fwd` addresses them, the
    head strides d: softmax(l2norm(q) q_scale (l2norm(k) k_scale)^T) v per
    (sequence, head), q_scale including the logit scale; no bias (K2 has
    none).  bf16: merged, like q, at the TPU kernel's rounding points (on
    `mma.sync`); f32: (hi, lo), merged's TF32 planes (hi + lo = merged), each
    laid out as q (on the CUDA cores, nothing rounded).  Counted
    `qk_attention_short` (and `qk_attention_short_f32`).  A shape
    `qk_fwd_route` does not send here raises.  `lib`: a one-change copy
    (`copy_library`) of the source, to launch instead."""
    hd = heads * d
    for name, t, width in (("q", q, hd), ("kv", kv, 2 * hd)):
        require(t, name, q.dtype if name != "q" else FORMS, 2)
        if t.shape[1] != width or t.shape[0] != q.shape[0]:
            raise ValueError(f"qk_attention_short: {name} {tuple(t.shape)}")
    if bias is not None or qk_fwd_route(q.dtype, n, d, heads) != QK_SHORT:
        raise ValueError(f"qk_attention_short: {q.dtype} at n {n}, head dim {d}, "
                         f"{heads} heads{', a bias' if bias is not None else ''} is not "
                         "its route (kernels.qk_fwd_route)")
    strides = _qk_tc_strides("qk_attention_short", q_strides, kv_strides, q, kv)
    if strides[2] != d or strides[6] != d:
        raise ValueError("qk_attention_short: the heads of a token must lie side by side")
    qs, ks = _f32_vector(q_scale, d, "q_scale"), _f32_vector(k_scale, d, "k_scale")
    f32 = q.dtype == F32
    outs = (torch.empty_like(q), torch.empty_like(q)) if f32 else (torch.empty_like(q),)
    entry = "ct_qk_attention_short_f32" if f32 else "ct_qk_attention_short"
    err = getattr(lib or library(), entry)(
        _ptr(q), _ptr(kv), *map(_ptr, outs), *strides, inner, sequences, heads, n, d, _ptr(qs),
        _ptr(ks), _stream())
    _check(err, entry)
    count_launch("qk_attention_short", q.dtype)
    return outs if f32 else outs[0]


QK_SHORT_SCALE_GROUPS = 32  # first-level groups of the short backward's scale partials


def qk_attention_short_bwd(q, kv, dout, *, sequences: int, inner: int, heads: int, n: int,
                           d: int, q_strides, kv_strides, q_scale, k_scale, lib=None,
                           out_dtype: torch.dtype = F32):
    """The QK-norm attention core's backward (K10's) on 16-31-token
    sequences (qknorm_attention_short.cu), on the f32 projections q (rows,
    h*d), kv (rows, 2*h*d) [k | v] and dout, the gradient of the merged
    heads laid out as q, addressed as `qk_attention_short` addresses them,
    in true f32.  out_dtype bf16 (K10 bf16, at small_attention.py::
    _bwd_kernel's rounding points): returns (merged, dq, dkv, dq_scale,
    dk_scale), merged and dq like q and dkv like kv in bf16, each rounded
    once from f32, the strides multiples of 8 elements; counted
    `qk_attention_short_bwd`.  out_dtype f32 (K10 f32):
    returns the operands of the 3xTF32 products after it: (dq hi, lo) like q,
    (dkv hi, lo) like kv, and the transposed planes (merged hi, lo), (dq hi,
    lo) (h*d, S n) and (dkv hi, lo) (2*h*d, S n), sequence s's token t in
    column s n + t (`tc32_split_t`'s order for seq = (n, inner)); then
    dq_scale (before the logit scale) and dk_scale (d,) f32: the partials of
    each (sequence, group of QK_SHORT_BWD_HEADS heads), one CTA's, added in
    two levels (QK_SHORT_SCALE_GROUPS blocks of them row by row, then the
    blocks' sums), in a fixed order.  Counted `qk_attention_short_bwd` and
    `qk_attention_short_bwd_f32`.  A shape `qk_bwd_route` does not send here
    raises.  `lib`: a one-change copy (`copy_library`) of the source, to
    launch instead."""
    hd = heads * d
    for name, t, width in (("q", q, hd), ("kv", kv, 2 * hd), ("dout", dout, hd)):
        require(t, name, F32, 2)
        if t.shape[1] != width or t.shape[0] != q.shape[0]:
            raise ValueError(f"qk_attention_short_bwd: {name} {tuple(t.shape)}")
    if out_dtype not in FORMS or qk_bwd_route(out_dtype, n, d, heads) != QK_SHORT \
            or q.shape[0] != sequences * n or any(t.dtype != F32 for t in (q, kv, dout)):
        raise ValueError(f"qk_attention_short_bwd: {out_dtype} at n {n}, head dim {d}, "
                         f"{heads} heads, {q.shape[0]} rows is not its route "
                         "(kernels.qk_bwd_route)")
    strides = _qk_tc_strides("qk_attention_short_bwd", q_strides, kv_strides, q, kv, dout)
    if strides[2] != d or strides[6] != d:
        raise ValueError("qk_attention_short_bwd: the heads of a token must lie side by side")
    if out_dtype == BF16 and any(st % 8 for st in strides):
        raise ValueError("qk_attention_short_bwd: its bf16 rows take strides of multiples of "
                         "8 elements")
    qs, ks = _f32_vector(q_scale, d, "q_scale"), _f32_vector(k_scale, d, "k_scale")
    rows, ldt = q.shape[0], -(-q.shape[0] // 4) * 4
    dev = q.device
    ctas = sequences * -(-heads // QK_SHORT_BWD_HEADS)
    rows_p = -(-ctas // QK_SHORT_SCALE_GROUPS) * QK_SHORT_SCALE_GROUPS
    parts = torch.zeros((2, rows_p, d), dtype=F32, device=dev)

    def scale_sum(part):  # blocks of sequences row by row, then the blocks' sums
        return sum_splits(sum_splits(part.view(QK_SHORT_SCALE_GROUPS, -1)).view(-1, d))
    if out_dtype == BF16:
        merged, dq, dkv = (torch.empty(t.shape, dtype=BF16, device=dev) for t in (q, q, kv))
        err = (lib or library()).ct_qk_attention_short_bwd(
            _ptr(q), _ptr(kv), _ptr(dout), _ptr(dq), _ptr(dkv), _ptr(merged), *strides, inner,
            sequences, heads, n, d, _ptr(qs), _ptr(ks), _ptr(parts[0]), _ptr(parts[1]),
            _stream())
        _check(err, "ct_qk_attention_short_bwd")
        count_launch("qk_attention_short_bwd")
        return merged, dq, dkv, scale_sum(parts[0]), scale_sum(parts[1])
    dq_hi, dq_lo, dkv_hi, dkv_lo = (torch.empty_like(t) for t in (q, q, kv, kv))
    m_t_hi, m_t_lo, dq_t_hi, dq_t_lo = (torch.empty((hd, ldt), dtype=F32, device=dev)
                                        for _ in range(4))
    dkv_t_hi, dkv_t_lo = (torch.empty((2 * hd, ldt), dtype=F32, device=dev) for _ in range(2))
    err = (lib or library()).ct_qk_attention_short_bwd_f32(
        _ptr(q), _ptr(kv), _ptr(dout), _ptr(dq_hi), _ptr(dq_lo), _ptr(dkv_hi), _ptr(dkv_lo),
        _ptr(m_t_hi), _ptr(m_t_lo), _ptr(dq_t_hi), _ptr(dq_t_lo), _ptr(dkv_t_hi),
        _ptr(dkv_t_lo), ldt, *strides, inner, sequences, heads, n, d, _ptr(qs), _ptr(ks),
        _ptr(parts[0]), _ptr(parts[1]), _stream())
    _check(err, "ct_qk_attention_short_bwd_f32")
    count_launch("qk_attention_short_bwd", F32)
    cols = slice(0, rows)
    return (dq_hi, dq_lo, dkv_hi, dkv_lo, m_t_hi[:, cols], m_t_lo[:, cols], dq_t_hi[:, cols],
            dq_t_lo[:, cols], dkv_t_hi[:, cols], dkv_t_lo[:, cols], scale_sum(parts[0]),
            scale_sum(parts[1]))


PEG_NQ = 4  # peg_stencil.cu: consecutive w outputs of a warp step (tile widths its multiples)
PEG_TH = {False: 4, True: 2}  # the most h rows a tile takes: forward, backward (shared memory)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def peg_plan(shape, dtype: torch.dtype, bwd: bool, sms: int = 132):
    """(th, tw, tiles) of a peg_stencil.cu launch over (B, T, H, W, C): tiles
    of tw columns (W rounded up to PEG_NQ, at most 32) and th rows, the most
    rows (PEG_TH) that still give two CTAs per SM on `sms` SMs, each CTA 128
    bytes of channels; tiles = B x ceil(H / th) x ceil(W / tw), the partial
    dW / db rows of the backward."""
    B, _, H, W, C = shape
    tw = min(-(-W // PEG_NQ) * PEG_NQ, 32)
    nwt, slabs = -(-W // tw), -(-C // (64 if dtype == BF16 else 32))
    th = PEG_TH[bwd]
    while th > 1 and slabs * B * -(-H // th) * nwt < 2 * sms:
        th //= 2
    return th, tw, B * -(-H // th) * nwt


def _peg_operands(name: str, x: torch.Tensor, weight: torch.Tensor, pads, **tensors):
    require(x, "x", FORMS, 5)
    for label, t in tensors.items():
        require(t, label, x.dtype, 5)
        if t.shape != x.shape:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} != x {tuple(x.shape)}")
    C = x.shape[-1]
    require(weight, "weight", F32, 5)
    if tuple(weight.shape) != (C, 1, 3, 3, 3):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} for {C} channels")
    if C % 8 or any(t.data_ptr() % 16 for t in (x, *tensors.values())):
        raise ValueError(f"{name}: takes C a multiple of 8 and 16-byte aligned tensors "
                         f"(x {tuple(x.shape)})")
    if len(pads) != 3 or any(p not in (0, 1, 2) for p in pads):
        raise ValueError(f"{name}: leading pads {pads} must each be 0, 1 or 2")
    plan = peg_plan(x.shape, x.dtype, bool(tensors), _sm_count(x.device.index or 0))
    return (*x.shape, *map(int, pads)), plan


def peg_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pads,
            rotated: bool) -> torch.Tensor:
    """x + the depthwise 3x3x3 conv of x + bias (peg_stencil.cu's forward
    form) over the contiguous (B, T, H, W, C) bf16 or f32 x, with the f32
    Conv3d weight (C, 1, 3, 3, 3), its taps rotated (t, h, w) -> (h, w, t)
    with `rotated`, the f32 bias (C,) and leading pads `pads` = (t, h, w),
    at the rounding points of JAX's `lax_peg_conv` (bf16) or `xla_peg_conv`
    (f32).  Counted `peg_fwd` (and `peg_fwd_f32`)."""
    dims, (th, tw, _) = _peg_operands("peg_fwd", x, weight, pads)
    require(bias, "bias", F32, 1)
    if bias.shape[0] != x.shape[-1]:
        raise ValueError(f"peg_fwd: bias {tuple(bias.shape)} for {x.shape[-1]} channels")
    out = torch.empty_like(x)
    err = _form("ct_peg_fwd", x)(_ptr(x), _ptr(weight), _ptr(bias), _ptr(out), *dims,
                                 int(rotated), th, tw, _stream())
    _check(err, "ct_peg_fwd")
    count_launch("peg_fwd", x.dtype)
    return out


def peg_bwd(x: torch.Tensor, dout: torch.Tensor, weight: torch.Tensor, pads, rotated: bool):
    """K14 in one pass over x and dout (peg_stencil.cu's backward form): dx
    (B, T, H, W, C) in x's dtype, the correlation of dout with the flipped
    taps and complemented pads plus dout (`lax_peg_dx`'s rounding in bf16),
    and (28, C) f32: rows 0-26 the weight gradient of tap (kz * 3 + ky) * 3
    + kx as applied, row 27 the bias gradient, the tiles' partial rows added
    in order.  Counted `peg_bwd` (and `peg_bwd_f32`)."""
    dims, (th, tw, tiles) = _peg_operands("peg_bwd", x, weight, pads, dout=dout)
    dx = torch.empty_like(x)
    part = torch.empty((tiles, 28, x.shape[-1]), dtype=F32, device=x.device)
    err = _form("ct_peg_bwd", x)(_ptr(x), _ptr(dout), _ptr(weight), _ptr(dx), _ptr(part),
                                 *dims, int(rotated), th, tw, _stream())
    _check(err, "ct_peg_bwd")
    dwb = sum_splits(part)
    count_launch("peg_bwd", x.dtype)
    return dx, dwb


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
