#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ct_clip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. build the hand-written kernels from ct_clip_tpu_torch/csrc (one nvcc
     per source, all at once);
  2. kernel phase: each ported TPU kernel's wrapper against its plain
     PyTorch version on the same inputs, at the shapes its main path gives
     it: the CT-CLIP inference kernels at full width, batch 2, in bf16 (K6
     as the ingest calls it: one volume into a slot of the batch buffer);
     the RadBERT training attention (K7 f32, K12 and K13, forward and
     backward) at (32, 12, 512, 64) in f32, checked at batch 8 (the plain
     K13 holds a (b, 12, 512, 512) mask) and timed at batch 32, plus K13's
     determinism, kept share and forward/backward mask identity (K13a f32's
     keep bits equal to K13b f32's and the plain mask's, bit for bit); all
     four run 3xTF32 on the tensor cores (attention_tc32.cu) and are held
     to TC32_REL_TOL (the backwards at n 512 and a ragged n 500),
     bit-identical across runs, beside a plain-TF32 copy of the kernel that
     must miss that tolerance; the forward's lse against the backward row
     pass's own S (key bias and dense).  For each:
     max abs / rel error against a stated tolerance (K6, a pure move, must be
     bit-exact), median times (CUDA events) of the kernel, the plain version
     and, where one PyTorch call computes the same function, that call, and
     the bound: the least time the card could take, from the call's bytes
     and products and the H100's published peaks (bf16 tensor cores for the
     bf16 kernels, f32 CUDA cores for the f32 ones, TF32 for the 3xTF32
     f32 attention, the f32 CUDA-core bound beside it).  The bf16 K7 / K12b
     / K12a / K13a / K13b kernels of attention_tc.cu (wgmma) and the f32 K7,
     K13a, K12a, K12b and K13b of attention_tc32.cu also time the CUDA-core
     kernels of attention_train.cu they replaced, on the same inputs
     ("replaced").  K1, its core on the tensor cores (qknorm_attention_tc.cu's
     forward pass), at zero-shot's (48, 576, 512), the contrastive step's
     (192, 576, 512) and a ragged (48, 40, 512) (the autoencoder's (160, 64,
     512) in phase 8), the replaced path (the core on attention.cu's CUDA
     cores) timed beside it; the core alone at those planes against its plain
     version at the TPU's rounding points, bit-identical across runs, with
     SDPA on the normalised heads as the library call (`k1_phase`); its
     projections on ffn_tc.cu's NT store and residual forms (counter
     `qk_proj_tc`).  K2 grid with its core on qknorm_attention_short.cu
     (counter `qk_attention_short`) and its products on ffn_tc.cu at
     zero-shot's (2, 24, 576, 512) and the contrastive step's (8, 24, 576,
     512), the replaced path (attention.cu's core, gemm.cu's WMMA products)
     timed beside it; the core alone at those grids and at the
     sequence-major (4,608, 16) and (512, 20) against its plain version at
     the TPU's rounding points, bit-identical across runs, attention.cu's
     core timed beside it and SDPA on the normalised heads as the library
     call (`k2_phase`).  K3 bf16
     (its GEGLU and residual products on ffn_tc.cu's `wgmma`, counter
     `ff_tc_fwd`) at zero-shot's 27,648 rows, MaskGIT's 10,240, the
     contrastive step's 110,592 and a ragged 10,001 (`k3_phase`: bit-identical
     across runs), and K5's inference assignment on bf16 rows (vq_tc.cu,
     counter `vq_assign_tc`) at (27,648, 512, 8,192), ragged rows and a
     ragged code count (>= 99% of ids equal, the rest near-ties) and on
     planted exact ties (ids equal to torch.argmax's, bit for bit); each with
     the replaced gemm.cu path and a cuBLAS yardstick timed beside it (a
     note: no one PyTorch call computes K3 or K5); K4 and K8 on embed_tc.cu
     (counter `embed_tc`) also held to a mean limit that a planted copy
     rounding y + bias once must miss, bit-identical across runs, the
     three passes they replaced and a cuBLAS yardstick timed beside them;
  3. zero-shot phase: a 3-volume synthetic CT-RATE corpus (NIfTI + CSVs +
     a toy vocab) through `run_zero_shot` at full CT-CLIP width (seeded
     random weights), batch 2 with a tail batch, twice: on the patch-row
     route (the default on CUDA: K6 ingest, K4 embed) and on the volume
     route (K8 embed).  Checks the (3, 18) probabilities, that the two
     routes agree, the artifacts, and that each route's kernels' launch
     counters rose; times `score_batch` on both routes.  Then
     `export_latents` on one volume (the volume route) with its counters;
  4. RadBERT phase: 64 synthetic reports with the 18 label columns and a
     generated vocab of CXR-BERT's size (30,522 entries) through the CLI's
     `radbert-train` (full RadBERT width, f32, batch 32, max length 512, 2
     epochs, validation on a second CSV, --out .pt), then `radbert-infer`
     and `radbert-eval` on that .pt, each with its launch counters (K13
     forward and backward in training, K7 f32 in validation and inference);
     checks the loss and the (64, 18) probabilities and times the training
     step, whose 12 K13a f32 and 12 K13b f32 run on attention_tc32.cu
     (counted, one step).  Then one step of a 2-layer full-width RadBERT
     with attention_dropout 0, which must run its 2 K7 f32 and 2 K12a f32
     on attention_tc32.cu
     (RadBERT is f32: nothing of it runs on attention_tc.cu), and one
     forward and backward of a 2-layer
     CXR-BERT in bf16 with attention dropout off, whose key-bias attention
     under grad runs K7 and K12a on the tensor cores (attention_tc.cu), with
     K12a bf16 at (8, 12, 512, 64) against its plain version, bit-identical
     across two runs, the replaced CUDA-core K12a timed beside it;
  5. reference checks on small inputs: a tiny CT-CLIP scores the same
     volumes on the card (kernels) and on the CPU (plain versions), both
     bf16, from volumes and from patch rows, and must agree; a tiny RadBERT
     with both dropouts 0 takes one training step from the same weights on
     the card (K12a f32 on attention_tc32.cu) and on the CPU, and the
     logits, loss, gradients and updated weights must agree, and must not
     with TC32 planted faults (D_i forced to 0; the backward in plain TF32;
     the forward in plain TF32); then the same with attention dropout 0.1
     (K13a f32 and K13b f32 on attention_tc32.cu, the same seeds on both
     sides, so the same Philox masks);
  6. CT-CLIP pretraining: the training kernels against their plain versions
     at full width, batch 8 (K11, its tile and three products on
     ffn_tc.cu's `wgmma`, bit-identical across runs, a copy whose dg lacks
     g phi(g) outside the limit; K9 with the CUDA-core attention core it
     replaced timed beside it, K9's bf16 core alone on the tensor cores
     (qknorm_attention_tc.cu) against the plain version at the TPU's
     rounding points, bit-identical across runs, its dbias rows within 16x
     the plain f32 version's sums and a copy summing D_i from bf16(P)
     outside them, the replaced core timed beside it; K9's products on
     ffn_tc.cu with the replaced gemm.cu products timed beside it
     (`replaced_qk_bwd_bf16`); K10 grid bf16 (its core the short core's bf16
     form, every product on ffn_tc.cu) against its plain version at the TPU
     kernel's own rounding points (`small_qknorm_bwd_plain`: each gradient
     within REL_TOL of max and K10_MEAN_TOL of mean|plain|, bit-identical
     across runs), the replaced path (qknorm_attention_bwd.cu at K9's
     rounding points, gemm.cu's products) timed beside it, which must miss
     the mean tolerance; K10's bf16 core alone (`short_core_bf16_case`:
     K2_POINT_TOL of mean, the copy rounding P to bf16 outside it); K14,
     K15 on vq_segstats.cu at 110,592 and 10,240 rows, on uniform ids and
     with half the rows in one code (`k15_case`: bins exact, sums within
     SUM_REL_TOL, bit-identical across runs, vq_stats.cu's path and
     `index_add_` + `bincount` timed beside it, a copy dropping a segment
     of each crowded code outside the limit), K5 exact on vq_tc.cu at
     110,592 and 10,240 rows (gemm.cu's
     gemm_argmax2_kernel and a cuBLAS yardstick timed beside it) with
     planted exact ties (`k5_exact_planted_ties`), and K13 in
     bf16 at CXR-BERT's batch 8 x 512 and a ragged n: K13a and K13b on
     attention_tc.cu, bit-identical across two runs, against the plain
     version with the forward's mask and, which must miss the tolerance,
     with another seed's, K13a's kept share, the replaced CUDA-core K13a
     and K13b timed beside them), then
     `cli train` on a synthetic corpus of 20 volumes (16 kept by the 80%
     split) at full width, batch 8, 4 steps, with one mini evaluation on 2
     validation volumes and one checkpoint; every training counter must
     rise, and each step runs 12 K13a and 12 K13b on the tensor cores (every
     attention forward of the run on attention_tc.cu), its 4 K9 cores on
     qknorm_attention_tc.cu (counter `qk_attention_tc_bwd`) and its 8 K11 on
     ffn_tc.cu (counters `ff_tc_tile`, 8, and `ff_tc_gemm`, 72 with the six
     products each of K9's 4 and K10's 4), its 4 K10 cores on the short
     core's bf16 form (`qk_attention_short_bwd`) and its K5 exact on
     vq_tc.cu (`vq_assign_exact_tc`).  The step time
     (CUDA events), peak memory and a profiled step's breakdown and idle
     share follow, then a tiny CT-CLIP
     training step on the card against the CPU (both bf16, each gradient
     held against the CPU's own bf16-vs-f32 distance; its BERT has one head
     of 64, so K7 and K12a run on the tensor cores), the same card step with
     planted kernel faults that must fail that comparison (K12a with D_i
     forced to 0 among them), and a save -> resume round trip on the card;
  7. CT-CLIP pretraining with the auxiliary objectives: the embed backwards
     against their plain versions at full width, batch AUX_B (K16a and K16b
     within BWD_REL_TOL of max|plain|, K17 bit-exact; K16a's products on
     ffn_tc.cu's `wgmma` with the LN(4000) sums in the dxn product's
     epilogue, bit-identical across runs, a copy whose epilogue drops rstd
     outside the limit, the replaced WMMA path with the LN(4000) backward
     over a stored dxn timed beside it, and again with d(volume), dxn
     stored; K16b on K16a's forms with d(rows) and into the weights alone,
     bit-identical across runs, the weights' LN(4000) sums from the rows in
     the dxn product's epilogue with its no-rstd copy outside the limit,
     the replaced path timed beside both); the embeds under grad
     at full width, which must pass gradients to all six weights and to the
     input (K8 / K16a / K17 on a volume, K4 / K16b on rows); then
     `CTClipTrainer` at full width on phase 6's corpus, (a) with visual SSL
     (SimSiam, temporal tap) and MLM for 3 steps with the mini evaluation
     (volumes, K8) and a checkpoint, and (b) with FILIP (dim_image 512) and
     SimCLR on the pooled tap for 2 steps, each with its launch counters (the
     volume training embed runs K6, each SSL view K8 and K16a, and MLM runs
     the text tower twice, so K13 launches twice as often per step as in
     phase 6: K13a and K13b 24 times each on the tensor cores; K16a's LN
     sums, counter `ff_tc_ln_sums`, once per view and step), step time
     (CUDA events), peak memory and a profiled step;
     last, a tiny CT-CLIP step with all three objectives on (its BERT at
     four heads of 16, K12a on attention_train.cu), the card held to the
     f32 step with the CPU's own bf16 noise pooled over six init seeds
     (`compare_tiny_steps`), and again with K16a's LN scale gradient
     dropped, which must fail;
  8. non-cubic token grids and the CTViT autoencoder: K2 and K10 in
     sequence-major form at (4608, 16, 512) (CT-CLIP at 160 frames, batch
     8) and (512, 20, 512) (the autoencoder's batch 8; K2 with its replaced
     path timed beside it; K10 as K10 grid in phase 6, and its core alone
     at both shapes), K1 and K9 on its
     (160, 64, 512) planes with the (8, 64, 64) bias, each against its
     plain version (K9 with the replaced gemm.cu products timed beside it,
     and its tensor-core core alone there as in phase 6); `CTViTTrainer` at
     full width on 8 synthetic 201 x 128 x 128 NIfTIs through
     VideoDataset(num_frames=200), (t, h, w) = (20, 8,
     8): 3 generator steps with falling losses, one round with the
     discriminator, step times, peak memory, a profiled step, a checkpoint
     round trip and a reconstruction dump, with the sequence-major counters
     rising and the grid ones not; K15 on the ids of its third step's VQ
     statistics (`k15_ae_cases`: its own 10,240 rows, and the ids repeated
     over 110,592, bf16 and f32 rows); `cli reconstruct` on two volumes at its
     default 240 x 480 x 480 (the grid path); CT-CLIP at 160 frames, one
     contrastive step at batch 8 and one zero-shot batch of 2; a tiny
     autoencoder step card against CPU, and again with K10 seq's dk_scale
     sum dropped, which must fail; a tiny bf16 autoencoder with heads of 32
     on a (16, 4, 4) grid, whose K10 takes the short core's bf16 form, card
     against CPU with each short-core call also held to its plain version
     (K2_POINT_TOL of mean), and again with the copy rounding P to bf16,
     which must fail (`tiny_ae_short_phase`);
  9. MaskGIT, the generative stack's second stage: K7's dense-bias form and
     K12b against their plain versions at MaskGIT's (8, 8, 1280, 64) with
     the (1, 8, n, n) CPB bias in bf16 (attention_tc.cu) and f32 (both on
     attention_tc32.cu), the critic's no-bias form at that shape in bf16 and
     f32, T5's (8, 12, 256, 64) in f32 and a ragged n = 1,000 with a
     one-head bias in bf16 and f32, dbias bit-identical run to run, its
     rows summing to zero within 16x the plain version's rounding; each f32
     forward and backward within TC32_REL_TOL, its plain-TF32 copy outside,
     the replaced CUDA-core kernel timed beside it; `MaskGitTrainer` at full
     width
     (MaskGitConfig(), 8,192 codes, bf16 compute) with the TokenCritic at
     batch 8 on the codes of 8 synthetic 200 x 128 x 128 volumes from phase
     8's frozen autoencoder (`encode_ids`) and a CXR-BERT context of 8
     reports (8, 512, 768): 4 steps with the launches per step (on the
     tensor cores 12 forwards, the MaskGit's K7 dense and the critic's K7,
     and 12 K12b backwards; K12a none), step time, peak memory, a profiled
     step, a .pt round trip, one step with a seeded T5-base context;
     `MaskGITPipeline.sample` of 2 volumes (18 steps, cond scale 3, the
     critic: 216 K7 dense launches, every K7 on the tensor cores) and a
     primed sample; T5-base on 8 x 256 ids without a mask (12 K7 dense
     launches) and with a pad mask (none); a tiny MaskGit step card against
     CPU, and again with K12b's dbias (attention_tc.cu) from batch row 0
     only, which must fail;
 10. f32, the JAX package's default dtype: the f32 forms (compile-time
     templates of the bf16 kernels) against their plain versions in true
     f32 at full width (TC32_REL_TOL; K11's weight gradients over 10,240 rows
     F32_REL_TOL): K3 at MaskGIT's, zero-shot's and the contrastive step's
     rows (3xTF32 on ffn_tc32.cu's `wgmma`, bit-identical across runs, a
     plain-TF32 copy outside TC32_REL_TOL, the replaced FFMA gemm_kernel
     path timed beside it; counter `geglu_ff_tc32` on every f32 path that
     runs K3), K11 at MaskGIT's and the contrastive step's 110,592 rows,
     K1 on the zero-shot and autoencoder planes (all in 3xTF32: the core on
     qknorm_attention_tc32.cu, the products on ffn_tc32.cu; the replaced
     path, attention.cu's f32 core and gemm.cu's FFMA products, timed beside
     it; the contrastive and ragged planes and the core alone, its plain-TF32
     copy outside TC32_REL_TOL, as in phase 2), K2 grid and seq (the core
     on qknorm_attention_short.cu's CUDA cores in true f32, merged written
     as hi and lo planes, the products in 3xTF32 on ffn_tc32.cu; the replaced
     path, attention.cu's f32 core and gemm.cu's FFMA products, timed beside
     it; the contrastive grid and the core alone as in phase 2), K5 on f32
     rows on three seeds (vq_tc.cu's pre-pass and assignment; ids equal to
     the plain version of its own math, `vq_assign_rows_lane_plain`, whose
     bf16 rows are the pre-pass's bit for bit, the rest ties within 1e-5 of
     the row's largest |sim|; the share equal to the full-f32 argmax
     reported; gemm.cu's f32-row form timed beside it),
     K6 and K17 bit-exact; `run_zero_shot` with CTCLIP(dtype=float32) on
     both routes (launches per kernel equal to the bf16 run's, on the f32
     forms, the embeds on their plain route, as JAX takes XLA there) with
     `score_batch` times and peak memory; a tiny f32 CT-CLIP card against CPU
     from volumes and rows; `MaskGitTrainer` in f32 with the critic on a
     frozen f32 autoencoder's codes and an f32 CXR-BERT context (4 steps,
     launches per step: 12 forwards and 12 backwards on attention_tc32.cu,
     step time, peak
     memory, a profiled step), f32 sampling of one volume; a tiny f32
     MaskGit step card against CPU (gradients 1e-4 of max, weights 1e-5,
     its K7 dense and K12b f32 on attention_tc32.cu), and again with K11's
     act rounded to bf16, with K12b f32's D_i forced to 0, with K12b f32 in
     plain TF32 and with K7 dense f32 in plain TF32, each of which must
     fail;
 11. f32 training, the JAX package's f32 CT-CLIP and CTViT autoencoder: the
     f32 backwards against their plain versions in true f32 at full width
     (dx TC32_REL_TOL, the sums over all sequences F32_REL_TOL): K9 f32 on
     the contrastive batch's (192, 576, 512) planes with the CPB bias and on
     the autoencoder's (160, 64, 512), the CUDA-core core it replaced timed
     beside it, K10 grid f32 at (8, 24, 576, 512), K10 seq f32 at (4,608, 16,
     512) and (512, 20, 512), K9's f32 core alone in 3xTF32 on
     qknorm_attention_tc32.cu at (192, 576) and (160, 64) (merged heads, dq,
     dkv TC32_REL_TOL, the sums F32_REL_TOL, bit-identical across runs,
     dbias rows within 16x the plain version's sums; a plain-TF32 copy and
     the CUDA-core kernel's copy with P rounded to bf16 must each miss; the
     CUDA-core f32 kernel timed beside it), K5 exact on vq_tc.cu on 110,592
     and 10,240 f32 rows (ids against the plain version of its math, the rows
     split in the pre-pass's order; the full-f32 share reported; gemm.cu's
     gemm_argmax3_rows_kernel and a cuBLAS yardstick timed beside it; planted
     exact ties), K15 on them and on 10,240, uniform and with half the rows
     in one code (`k15_case`: bins exact, sums 1e-6 of max of the plain
     version in the kernel's order, which the full-f32 sums of the uniform
     rows must miss), K17 f32 as K6's
     backward (bit-exact); `cli train --no-bf16` at batch 8, 4 steps with
     the mini evaluation and a checkpoint (launches per step, 12 K13a f32
     and 12 K13b f32 on attention_tc32.cu and 4 K9 f32 cores on
     qknorm_attention_tc32.cu among them, step time,
     peak memory, a profiled step); `CTViTTrainer` on an f32
     CTViT(ae_config()): 3 generator steps with falling losses and a round
     with the discriminator (the sequence-major f32 counters, K9 f32 at n =
     64; step time, peak memory, a profiled step); a tiny f32 CT-CLIP step
     and a tiny f32 autoencoder step card against CPU (gradients 1e-4 of
     max, weights 1e-5, VQ ids equal and its EMA state 1e-5), each again
     with K9/K10 f32's P rounded to bf16, which must fail.

Prints the end-to-end numbers and the kernel table as one JSON line each,
then the card's name and power limit (nvidia-smi), then
{"ok": true, "device": {...}} as the last line.  Working files go to
build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B = 2  # volumes per batch
# max abs err <= REL_TOL * max|plain|: kernel and plain version round to bf16
# at the same points but sum in other orders, so an intermediate may land
# one bf16 ulp (2^-8 relative) apart and carry that through later stages
REL_TOL = 2e-2
# the f32 kernels run the same products as their plain versions in f32, in
# another summation order
F32_REL_TOL = 1e-4
# the f32 attention backwards in 3xTF32 (attention_tc32.cu: K12a, K12b,
# K13b) against the plain version in true f32 (TF32 off): each product's
# operands split into TF32 hi + lo drop ~2^-22 of it, f32's own rounding
# order; plain TF32 (~2^-11) lands near 5e-4
TC32_REL_TOL = 1e-5
# K2's bf16 core against its plain version at the TPU kernel's rounding
# points (e = exp(S - rowmax) rounded before e v, then divided by the f32
# sum): mean|err| <= K2_POINT_TOL * mean|plain|.  Another f32 summation
# order flips a bf16 rounding in well under 1% of merged's elements;
# rounding the normalised p instead (attention.cu's point, the XLA twin's)
# moves ~43% of them, ~1.8e-3, and the check requires that reading to miss.
# On an H100 the core reads below 1e-6 (PERF.md, section 6)
K2_POINT_TOL = 2e-4
# K10 bf16 (the short core's bf16 form) rounds only its outputs, each once
# from f32 (small_attention.py::_bwd_kernel's points): the core alone holds
# merged, dq and dkv to K2_POINT_TOL of mean|plain| as K2's core, which the
# copy with P rounded to bf16 (CT_QK_SHORT_BWD_ROUND_P) must miss; the whole
# sublayer's seven gradients each to K10_MEAN_TOL of mean|plain|, which K9's
# rounding points (q, kv, dmerged, qn, kn, P and dS rounded: the replaced
# path) must miss.  Max errors stay within REL_TOL: both sets of points pass
# that.  (CPU: 8e-5 against the JAX kernel in interpret mode; K9's points
# read 3e-3-9e-3, tests/test_torch_port_k10k5_tc.py.)
K10_MEAN_TOL = 5e-4
# the two zero-shot routes see the same bf16 values and differ only in the
# order LN(4000) sums them: P(present) agree far inside this
ROUTE_TOL = 0.05
# NVIDIA H100 SXM published peaks (dense): bf16 and TF32 tensor cores, f32
# CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PALLAS = "ct_clip_tpu/ops/pallas/"
CSRC = "ct_clip_tpu_torch/csrc/"


def _kernel(name, replaces, source, sources, counter, path):
    return dict(name=name, replaces=PALLAS + replaces, source=source,
                sources=sources, counter=counter, path=path)


# table entry -> its TPU kernel (Pallas function file:line), main CUDA
# source, every CUDA file its wrapper launches from, its launch counter and
# the driven path whose count the table reports
ATTN_TRAIN = ["attention_train.cu"]
ATTN_TC = ["attention_tc.cu"]
ATTN_TC32 = ["attention_tc32.cu"]
KERNELS = {
    # K8 and K4 bf16 on embed_tc.cu (`wgmma`, the row tiles normalised in
    # shared memory; counter embed_tc beside patch_embed / row_embed)
    "patch_embed": _kernel("fused_patch_embed", "patchify.py:341", "embed_tc.cu",
                           ["embed_tc.cu"], "patch_embed", "zero_shot_volume"),
    # K1: its core on the tensor cores (qknorm_attention_tc.cu's forward
    # pass, counter qk_attention_tc beside spatial_attention), its products
    # on ffn_tc.cu's NT forms (counter qk_proj_tc)
    "spatial_attention": _kernel("fused_spatial_qknorm_attention",
                                 "spatial_attention.py:276", "qknorm_attention_tc.cu",
                                 ["layernorm.cu", "ffn_tc.cu", "qknorm_attention_tc.cu"],
                                 "spatial_attention", "zero_shot_rows"),
    # K1's bf16 attention core alone (the route kernels.qk_bwd_tensor_cores
    # gives K1's planes), its own counter
    "spatial_attention_tc": _kernel("_pallas_spatial (bf16 attention core)",
                                    "spatial_attention.py:276", "qknorm_attention_tc.cu",
                                    ["qknorm_attention_tc.cu"], "qk_attention_tc",
                                    "zero_shot_rows"),
    # K2 grid: its core on qknorm_attention_short.cu (counter
    # qk_attention_short beside grid_attention), its products on ffn_tc.cu
    "grid_attention": _kernel("fused_small_qknorm_attention_grid",
                              "small_attention.py:196", "qknorm_attention_short.cu",
                              ["layernorm.cu", "ffn_tc.cu", "qknorm_attention_short.cu"],
                              "grid_attention", "zero_shot_rows"),
    # K2's bf16 attention core alone (the route kernels.qk_fwd_route gives
    # its 16-31-token sequences, grid and sequence-major), its own counter
    "grid_attention_short": _kernel("_pallas_small_qknorm (bf16 attention core)",
                                    "small_attention.py:196", "qknorm_attention_short.cu",
                                    ["qknorm_attention_short.cu"], "qk_attention_short",
                                    "zero_shot_rows"),
    # K3 bf16: its GEGLU and residual products on ffn_tc.cu (`wgmma`, counter
    # ff_tc_fwd beside geglu_ff)
    "geglu_ff": _kernel("fused_geglu_ff", "ffn.py:105", "ffn_tc.cu",
                        ["layernorm.cu", "ffn_tc.cu"], "geglu_ff", "zero_shot_rows"),
    # K5 inference on vq_tc.cu (`wgmma`, counter vq_assign_tc beside vq_assign)
    "vq_assign": _kernel("pallas_assign", "vq.py:104", "vq_tc.cu", ["vq_tc.cu"],
                         "vq_assign", "zero_shot_rows"),
    "fused_attention": _kernel("fused_attention", "attention.py:129", "attention_tc.cu",
                               ATTN_TC, "fused_attention", "zero_shot_rows"),
    "rearrange_patches": _kernel("rearrange_patches", "patchify.py:105", "rearrange.cu",
                                 ["rearrange.cu"], "rearrange_patches", "zero_shot_rows"),
    "row_embed": _kernel("fused_row_embed", "patchify.py:609", "embed_tc.cu",
                         ["embed_tc.cu"], "row_embed", "zero_shot_rows"),
    "fused_attention_f32": _kernel("fused_attention (f32)", "attention.py:129",
                                   "attention_tc32.cu", ATTN_TC32, "fused_attention",
                                   "radbert_train"),
    "attention_bwd": _kernel("_pallas_attention_bwd_kbias", "attention.py:271",
                             "attention_tc32.cu", ATTN_TC32, "attention_tc32_bwd",
                             "radbert_dropout_off"),
    "attention_dropout": _kernel("_pallas_attention_kbias_drop_impl", "attention.py:474",
                                 "attention_tc32.cu", ATTN_TC32, "attention_dropout",
                                 "radbert_train"),
    "attention_dropout_bwd": _kernel("_pallas_attention_kbias_drop_bwd",
                                     "attention.py:499", "attention_tc32.cu", ATTN_TC32,
                                     "attention_dropout_bwd", "radbert_train"),
    # K11 bf16: the tile and its three products on ffn_tc.cu (`wgmma`,
    # counters ff_tc_tile and ff_tc_gemm beside geglu_ff_bwd)
    "geglu_ff_bwd": _kernel("_pallas_ff_bwd", "ffn.py:238", "ffn_tc.cu",
                            ["layernorm.cu", "ffn_tc.cu", "gemm.cu"], "geglu_ff_bwd",
                            "ctclip_train"),
    "spatial_attention_bwd": _kernel("_pallas_spatial_bwd", "spatial_attention.py:297",
                                     "qknorm_attention_tc.cu",
                                     ["layernorm.cu", "ffn_tc.cu", "gemm.cu",
                                      "qknorm_attention_tc.cu"],
                                     "spatial_attention_bwd", "ctclip_train"),
    # K9's bf16 attention core alone, on the tensor cores (the route
    # kernels.qk_bwd_tensor_cores gives K9's planes), its own counter
    "spatial_attention_bwd_tc": _kernel("_pallas_spatial_bwd (bf16 attention core)",
                                        "spatial_attention.py:297", "qknorm_attention_tc.cu",
                                        ["qknorm_attention_tc.cu", "gemm.cu"],
                                        "qk_attention_tc_bwd", "ctclip_train"),
    # K10 bf16: its core on qknorm_attention_short.cu's bf16 form (true f32
    # inside, at the TPU kernel's rounding points; counter
    # qk_attention_short_bwd), every product on ffn_tc.cu (`wgmma`)
    "grid_attention_bwd": _kernel("_pallas_small_qknorm_bwd (grid_layout)",
                                  "small_attention.py:437", "qknorm_attention_short.cu",
                                  ["layernorm.cu", "ffn_tc.cu", "gemm.cu",
                                   "qknorm_attention_short.cu"],
                                  "grid_attention_bwd", "ctclip_train"),
    # K10's bf16 attention core alone (the route kernels.qk_bwd_route gives
    # its 16-31-token sequences, grid and sequence-major), its own counter
    "grid_attention_bwd_short": _kernel("_pallas_small_qknorm_bwd (bf16 attention core)",
                                        "small_attention.py:437", "qknorm_attention_short.cu",
                                        ["qknorm_attention_short.cu", "gemm.cu"],
                                        "qk_attention_short_bwd", "ctclip_train"),
    # K14 whole (dx, dW and db) in one pass: peg_stencil.cu's backward form,
    # the tiles' dW / db rows added by gemm.cu's sum_splits
    "peg_bwd": _kernel("_pallas_peg_bwd", "peg.py:181", "peg_stencil.cu",
                       ["peg_stencil.cu", "gemm.cu"], "peg_bwd", "ctclip_train"),
    # the PEG forward: peg_stencil.cu's forward form, which replaces XLA's conv
    "peg_fwd": dict(name="PEG forward (replaces no TPU kernel: XLA's conv, lax_peg_conv "
                         "peg.py:83)", replaces=f"none: XLA's conv, {PALLAS}peg.py:83",
                    source="peg_stencil.cu", sources=["peg_stencil.cu"], counter="peg_fwd",
                    path="ctclip_train"),
    # K15 on vq_segstats.cu: rows grouped by code in one cooperative launch,
    # then a warp per segment of <= 32 rows and the partials added in order
    "vq_cluster_stats": _kernel("pallas_cluster_stats", "vq.py:168", "vq_segstats.cu",
                                ["vq_segstats.cu"], "vq_cluster_stats", "ctclip_train"),
    # K5 exact on vq_tc.cu (`wgmma`, counter vq_assign_exact_tc beside it)
    "vq_assign_exact": _kernel("pallas_assign (exact)", "vq.py:104", "vq_tc.cu", ["vq_tc.cu"],
                               "vq_assign_exact", "ctclip_train"),
    "attention_dropout_bf16": _kernel("_pallas_attention_kbias_drop_impl (bf16)",
                                      "attention.py:474", "attention_tc.cu", ATTN_TC,
                                      "attention_dropout", "ctclip_train"),
    "attention_dropout_bwd_bf16": _kernel("_pallas_attention_kbias_drop_bwd (bf16)",
                                          "attention.py:499", "attention_tc.cu",
                                          ATTN_TC, "attention_dropout_bwd", "ctclip_train"),
    # K16a: its three products on ffn_tc.cu (`wgmma`), the LN(4000) sums in
    # the dxn product's epilogue (counter ff_tc_ln_sums beside it)
    "patch_embed_bwd": _kernel("_pallas_patch_embed_bwd", "patchify.py:375", "ffn_tc.cu",
                               ["layernorm.cu", "ffn_tc.cu", "gemm.cu"], "patch_embed_bwd",
                               "ctclip_aux_ssl_mlm"),
    # K16b on K16a's forms: xn and its stats on embed_tc.cu, the products on
    # ffn_tc.cu (`wgmma`), without d(rows) the LN(4000) sums in the dxn
    # product's epilogue (counter ff_tc_ln_sums)
    "row_embed_bwd": _kernel("_pallas_row_embed_bwd", "patchify.py:637", "ffn_tc.cu",
                             ["embed_tc.cu", "ffn_tc.cu", "layernorm.cu", "gemm.cu"],
                             "row_embed_bwd", "embed_grad"),
    "unrearrange_patches": _kernel("_pallas_unrearrange", "patchify.py:138", "rearrange.cu",
                                   ["rearrange.cu"], "unrearrange_patches", "embed_grad"),
    "seq_attention": _kernel("fused_small_qknorm_attention", "small_attention.py:196",
                             "qknorm_attention_short.cu",
                             ["layernorm.cu", "ffn_tc.cu", "qknorm_attention_short.cu"],
                             "seq_attention", "ctvit_ae_train"),
    "seq_attention_bwd": _kernel("_pallas_small_qknorm_bwd (sequence-major)",
                                 "small_attention.py:437", "qknorm_attention_short.cu",
                                 ["layernorm.cu", "ffn_tc.cu", "gemm.cu",
                                  "qknorm_attention_short.cu"],
                                 "seq_attention_bwd", "ctvit_ae_train"),
    "attention_dense": _kernel("_pallas_attention (dense bias)", "attention.py:157",
                               "attention_tc.cu", ATTN_TC, "attention_dense",
                               "maskgit_train"),
    "attention_dense_bwd": _kernel("_pallas_attention_bwd", "attention.py:301",
                                   "attention_tc.cu", ATTN_TC, "attention_dense_bwd",
                                   "maskgit_train"),
    # the TokenCritic's self-attention: no bias, bf16; its backward is K12b
    # with a zero bias and no dbias (the JAX package takes XLA there)
    "attention_nobias": _kernel("_pallas_attention (no bias)", "attention.py:149",
                                "attention_tc.cu", ATTN_TC, "fused_attention", "maskgit_train"),
    "attention_nobias_bwd": _kernel("_pallas_attention_bwd (no bias)", "attention.py:301",
                                    "attention_tc.cu", ATTN_TC, "attention_tc_bwd",
                                    "maskgit_train"),
    # K7 in f32 (3xTF32) at MaskGIT's shape: the MaskGit's dense CPB bias
    # and the critic's no bias (each f32 step runs 6 of each: 12 on
    # attention_tc32)
    "attention_dense_f32": _kernel("_pallas_attention (dense bias, f32)", "attention.py:157",
                                   "attention_tc32.cu", ATTN_TC32, "attention_dense",
                                   "maskgit_f32_train"),
    "attention_nobias_f32": _kernel("_pallas_attention (no bias, f32)", "attention.py:149",
                                    "attention_tc32.cu", ATTN_TC32, "fused_attention",
                                    "maskgit_f32_train"),
    # K12b in f32 (3xTF32) at MaskGIT's shape: the MaskGit's dense CPB bias
    # and the critic's no bias (each f32 step runs 6 of each: 12 on
    # attention_tc32_bwd)
    "attention_dense_bwd_f32": _kernel("_pallas_attention_bwd (f32)", "attention.py:301",
                                       "attention_tc32.cu", ATTN_TC32, "attention_tc32_bwd",
                                       "maskgit_f32_train"),
    "attention_nobias_bwd_f32": _kernel("_pallas_attention_bwd (no bias, f32)",
                                        "attention.py:301", "attention_tc32.cu", ATTN_TC32,
                                        "attention_tc32_bwd", "maskgit_f32_train"),
    # K12a in bf16: CXR-BERT with attention dropout off, under grad
    "attention_bwd_bf16": _kernel("_pallas_attention_bwd_kbias (bf16)", "attention.py:271",
                                  "attention_tc.cu", ATTN_TC, "attention_bwd",
                                  "bert_bf16_dropout_off"),
    # the f32 forms (phase 10), each with its own counter
    # K3 f32: 3xTF32 on ffn_tc32.cu (`wgmma`, counter geglu_ff_tc32 beside it)
    "geglu_ff_f32": _kernel("fused_geglu_ff (f32)", "ffn.py:105", "ffn_tc32.cu",
                            ["layernorm.cu", "ffn_tc32.cu"], "geglu_ff_f32",
                            "maskgit_f32_train"),
    # K11 f32: 3xTF32 on ffn_tc32.cu (`wgmma`: the tile, counter
    # ff_tc32_tile; dxn on the plain-store form, tc32_gemm; the weight
    # gradients on the TN form, tc32_gemm_tn)
    "geglu_ff_bwd_f32": _kernel("_pallas_ff_bwd (f32)", "ffn.py:238", "ffn_tc32.cu",
                                ["layernorm.cu", "ffn_tc32.cu"], "geglu_ff_bwd_f32",
                                "maskgit_f32_train"),
    # K1 f32: all in 3xTF32, the core on qknorm_attention_tc32.cu's forward
    # pass (counter qk_attention_tc32), the three products on ffn_tc32.cu
    # (counter tc32_gemm)
    "spatial_attention_f32": _kernel("fused_spatial_qknorm_attention (f32)",
                                     "spatial_attention.py:276", "qknorm_attention_tc32.cu",
                                     ["layernorm.cu", "ffn_tc32.cu", "qknorm_attention_tc32.cu"],
                                     "spatial_attention_f32", "zero_shot_f32_rows"),
    # K1's f32 attention core alone, 3xTF32 on the tensor cores, its own counter
    "spatial_attention_f32_tc": _kernel("_pallas_spatial (f32 attention core)",
                                        "spatial_attention.py:276", "qknorm_attention_tc32.cu",
                                        ["qknorm_attention_tc32.cu"], "qk_attention_tc32",
                                        "zero_shot_f32_rows"),
    # K2 f32: its core on qknorm_attention_short.cu (CUDA cores, counter
    # qk_attention_short_f32), its three products in 3xTF32 on ffn_tc32.cu
    "grid_attention_f32": _kernel("fused_small_qknorm_attention_grid (f32)",
                                  "small_attention.py:196", "qknorm_attention_short.cu",
                                  ["layernorm.cu", "ffn_tc32.cu", "qknorm_attention_short.cu"],
                                  "grid_attention_f32", "zero_shot_f32_rows"),
    # K2's f32 attention core alone, its own counter
    "grid_attention_f32_short": _kernel("_pallas_small_qknorm (f32 attention core)",
                                        "small_attention.py:196", "qknorm_attention_short.cu",
                                        ["qknorm_attention_short.cu"], "qk_attention_short_f32",
                                        "zero_shot_f32_rows"),
    "seq_attention_f32": _kernel("fused_small_qknorm_attention (f32)",
                                 "small_attention.py:196", "qknorm_attention_short.cu",
                                 ["layernorm.cu", "ffn_tc32.cu", "qknorm_attention_short.cu"],
                                 "seq_attention_f32", "maskgit_f32_encode_ids"),
    # K5 on f32 rows: vq_tc.cu's pre-pass, then its assignment
    "vq_assign_f32": _kernel("pallas_assign (f32 rows)", "vq.py:104", "vq_tc.cu", ["vq_tc.cu"],
                             "vq_assign_f32", "zero_shot_f32_rows"),
    "rearrange_patches_f32": _kernel("rearrange_patches (f32)", "patchify.py:105",
                                     "rearrange.cu", ["rearrange.cu"], "rearrange_patches_f32",
                                     "zero_shot_f32_rows"),
    "unrearrange_patches_f32": _kernel("_pallas_unrearrange (f32)", "patchify.py:138",
                                       "rearrange.cu", ["rearrange.cu"],
                                       "unrearrange_patches_f32", "maskgit_f32_sample"),
    # the f32 CTViT backwards (phase 11), each with its own counter
    # K9 f32: its core 3xTF32 on qknorm_attention_tc32.cu, its products in
    # 3xTF32 on ffn_tc32.cu (counters tc32_gemm, tc32_gemm_tn)
    "spatial_attention_bwd_f32": _kernel("_pallas_spatial_bwd (f32)", "spatial_attention.py:297",
                                         "qknorm_attention_tc32.cu",
                                         ["layernorm.cu", "ffn_tc32.cu",
                                          "qknorm_attention_tc32.cu"],
                                         "spatial_attention_bwd_f32", "ctclip_f32_train"),
    # K9's f32 attention core alone, 3xTF32 on the tensor cores (the route
    # kernels.qk_bwd_tensor_cores gives K9's f32 planes), its own counter
    "spatial_attention_bwd_f32_tc": _kernel("_pallas_spatial_bwd (f32 attention core)",
                                            "spatial_attention.py:297",
                                            "qknorm_attention_tc32.cu",
                                            ["qknorm_attention_tc32.cu"],
                                            "qk_attention_tc32_bwd", "ctclip_f32_train"),
    # K10 f32: its core on qknorm_attention_short.cu (true f32, counter
    # qk_attention_short_bwd_f32), its products in 3xTF32 on ffn_tc32.cu
    "grid_attention_bwd_f32": _kernel("_pallas_small_qknorm_bwd (grid_layout, f32)",
                                      "small_attention.py:437", "qknorm_attention_short.cu",
                                      ["layernorm.cu", "ffn_tc32.cu",
                                       "qknorm_attention_short.cu"],
                                      "grid_attention_bwd_f32", "ctclip_f32_train"),
    "seq_attention_bwd_f32": _kernel("_pallas_small_qknorm_bwd (sequence-major, f32)",
                                     "small_attention.py:437", "qknorm_attention_short.cu",
                                     ["layernorm.cu", "ffn_tc32.cu", "qknorm_attention_short.cu"],
                                     "seq_attention_bwd_f32", "ctvit_ae_f32_train"),
    # K10's f32 attention core alone (the route kernels.qk_bwd_route gives
    # its 16-31-token sequences, grid and sequence-major), its own counter
    "grid_attention_bwd_f32_short": _kernel("_pallas_small_qknorm_bwd (f32 attention core)",
                                            "small_attention.py:437",
                                            "qknorm_attention_short.cu",
                                            ["qknorm_attention_short.cu"],
                                            "qk_attention_short_bwd_f32", "ctclip_f32_train"),
    # K5 exact on f32 rows: vq_tc.cu's splitting pre-pass, then its exact form
    "vq_assign_exact_f32": _kernel("pallas_assign (exact, f32 rows)", "vq.py:104", "vq_tc.cu",
                                   ["vq_tc.cu"], "vq_assign_exact_f32", "ctclip_f32_train"),
    "vq_cluster_stats_f32": _kernel("pallas_cluster_stats (f32 rows)", "vq.py:168",
                                    "vq_segstats.cu", ["vq_segstats.cu"],
                                    "vq_cluster_stats_f32", "ctclip_f32_train"),
    # the PEG in f32 (XLA in JAX: xla_peg_conv and its jax.vjp), the stencil's
    # f32 forms, each with its own counter
    "peg_bwd_f32": _kernel("_pallas_peg_bwd (f32)", "peg.py:181", "peg_stencil.cu",
                           ["peg_stencil.cu", "gemm.cu"], "peg_bwd_f32", "ctclip_f32_train"),
    "peg_fwd_f32": dict(name="PEG forward, f32 (replaces no TPU kernel: XLA's conv, "
                             "xla_peg_conv peg.py:55)", replaces=f"none: XLA, {PALLAS}peg.py:55",
                        source="peg_stencil.cu", sources=["peg_stencil.cu"],
                        counter="peg_fwd_f32", path="ctclip_f32_train"),
}
# launch counters each driven path must raise
COMMON = ["spatial_attention", "qk_attention_tc", "grid_attention", "qk_attention_short",
          "qk_proj_tc", "geglu_ff", "ff_tc_fwd", "vq_assign", "vq_assign_tc", "fused_attention",
          "attention_tc", "peg_fwd"]
PATHS = {
    "zero_shot_rows": COMMON + ["rearrange_patches", "row_embed", "embed_tc"],
    "zero_shot_volume": COMMON + ["patch_embed", "embed_tc"],
    "export_latents": COMMON + ["patch_embed", "embed_tc"],
    "radbert_train": ["attention_dropout", "attention_dropout_bwd", "attention_tc32",
                      "attention_tc32_bwd", "fused_attention"],
    "radbert_step": ["attention_dropout", "attention_dropout_bwd", "attention_tc32",
                     "attention_tc32_bwd"],
    "radbert_infer": ["fused_attention", "attention_tc32"],
    "radbert_eval": ["fused_attention", "attention_tc32"],
    "radbert_dropout_off": ["fused_attention", "attention_bwd", "attention_tc32",
                            "attention_tc32_bwd"],
    "bert_bf16_dropout_off": ["fused_attention", "attention_bwd", "attention_tc",
                              "attention_tc_bwd"],
    # the training step (K13a and K13b on the tensor cores) and the mini
    # evaluation (K6 ingest, K4 embed, K5)
    "ctclip_train": ["geglu_ff_bwd", "ff_tc_tile", "ff_tc_gemm", "spatial_attention_bwd",
                     "qk_attention_tc_bwd", "qk_attention_short_bwd", "vq_assign_exact_tc",
                     "grid_attention_bwd", "peg_bwd", "peg_fwd", "vq_cluster_stats",
                     "vq_assign_exact", "geglu_ff", "ff_tc_fwd", "spatial_attention",
                     "qk_attention_tc",
                     "grid_attention", "qk_attention_short", "qk_proj_tc",
                     "attention_dropout", "attention_dropout_bwd", "attention_tc_bwd",
                     "rearrange_patches",
                     "row_embed", "embed_tc", "vq_assign", "vq_assign_tc", "fused_attention",
                     "attention_tc"],
    # the inference embeds under grad, on a volume and on rows
    "embed_grad": ["patch_embed", "patch_embed_bwd", "ff_tc_gemm", "unrearrange_patches",
                   "row_embed", "row_embed_bwd", "embed_tc"],
}
# a training step on volumes with visual SSL: K6 in the CLIP embed, K8 and
# K16a in each view's embed, the tower's kernels and backwards, K13
AUX_TRAIN = ["patch_embed", "embed_tc", "patch_embed_bwd", "ff_tc_ln_sums", "rearrange_patches",
             "geglu_ff_bwd", "ff_tc_tile", "ff_tc_gemm",
             "spatial_attention_bwd", "qk_attention_tc_bwd", "grid_attention_bwd", "peg_bwd",
             "peg_fwd",
             "qk_attention_short_bwd", "vq_assign_exact_tc",
             "vq_cluster_stats", "vq_assign_exact", "geglu_ff", "ff_tc_fwd", "spatial_attention",
             "qk_attention_tc", "grid_attention", "qk_attention_short", "qk_proj_tc",
             "attention_dropout", "attention_dropout_bwd", "attention_tc", "attention_tc_bwd"]
PATHS["ctclip_aux_ssl_mlm"] = AUX_TRAIN + ["vq_assign", "vq_assign_tc",
                                           "fused_attention"]  # + mini-eval
PATHS["ctclip_aux_filip_simclr"] = AUX_TRAIN
# phase 8: the CTViT autoencoder on GenerateCT's non-cubic (20, 8, 8) grid
# (training embed K6, decoder un-patchify K17 forward and K6 backward),
# `cli reconstruct` on the cubic 24^3 grid, CT-CLIP at 160 frames (16, 24, 24)
AE_TRAIN = ["seq_attention", "qk_attention_short", "qk_proj_tc", "seq_attention_bwd",
            "qk_attention_short_bwd", "vq_assign_exact_tc", "spatial_attention", "qk_attention_tc",
            "spatial_attention_bwd", "qk_attention_tc_bwd", "geglu_ff", "ff_tc_fwd",
            "geglu_ff_bwd", "ff_tc_tile", "ff_tc_gemm",
            "peg_bwd", "peg_fwd", "vq_cluster_stats", "vq_assign_exact", "rearrange_patches",
            "unrearrange_patches"]
PATHS["ctvit_ae_train"] = AE_TRAIN
# + the inference recon
PATHS["ctvit_ae_discr"] = AE_TRAIN + ["vq_assign", "vq_assign_tc", "patch_embed",
                                      "embed_tc"]
PATHS["reconstruct"] = ["patch_embed", "embed_tc", "spatial_attention", "qk_attention_tc",
                        "grid_attention",
                        "qk_attention_short", "qk_proj_tc", "geglu_ff", "ff_tc_fwd",
                        "vq_assign", "vq_assign_tc", "unrearrange_patches", "peg_fwd"]
PATHS["ctclip_160_train"] = ["seq_attention", "qk_attention_short", "qk_proj_tc",
                             "seq_attention_bwd", "qk_attention_short_bwd",
                             "vq_assign_exact_tc", "spatial_attention",
                             "qk_attention_tc", "spatial_attention_bwd", "qk_attention_tc_bwd",
                             "geglu_ff", "ff_tc_fwd",
                             "geglu_ff_bwd", "ff_tc_tile", "ff_tc_gemm", "peg_bwd", "peg_fwd",
                             "vq_cluster_stats", "vq_assign_exact",
                             "rearrange_patches", "attention_dropout", "attention_dropout_bwd",
                             "attention_tc", "attention_tc_bwd"]
PATHS["zero_shot_160"] = ["row_embed", "embed_tc", "spatial_attention", "qk_attention_tc",
                          "seq_attention",
                          "qk_attention_short", "qk_proj_tc",
                          "geglu_ff", "ff_tc_fwd",
                          "vq_assign", "vq_assign_tc", "fused_attention", "attention_tc",
                          "peg_fwd"]
# phase 9: MaskGIT on the frozen autoencoder's (20, 8, 8) codes.  A training
# step: the MaskGit's self-attention with the 3-D CPB bias (K7 dense, K12b)
# and the critic's without a bias (K7, K12b with no bias), all bf16 on the
# tensor cores (attention_tc), the FF (K3, K11), the non-causal PEG (the
# stencil's forward and K14);
# the CTViT's inference encode (K8, K1, K2 seq, K3, K5); the sampler (K7
# dense, the critic's K7, the decoder's K2 seq, K1, K3, K17); T5 without a
# mask (K7 dense in f32, 12 per-head biases)
PATHS["maskgit_train"] = ["attention_dense", "attention_dense_bwd", "fused_attention",
                          "attention_tc", "attention_tc_bwd", "geglu_ff", "ff_tc_fwd",
                          "geglu_ff_bwd",
                          "ff_tc_tile", "ff_tc_gemm", "peg_bwd", "peg_fwd"]
PATHS["maskgit_encode_ids"] = ["patch_embed", "embed_tc", "spatial_attention",
                               "qk_attention_tc", "seq_attention", "qk_attention_short",
                               "qk_proj_tc", "geglu_ff", "ff_tc_fwd", "vq_assign",
                               "vq_assign_tc", "peg_fwd"]
PATHS["maskgit_sample"] = ["attention_dense", "fused_attention", "attention_tc", "geglu_ff",
                           "ff_tc_fwd",
                           "seq_attention", "qk_attention_short", "qk_proj_tc",
                           "spatial_attention", "qk_attention_tc", "unrearrange_patches",
                           "peg_fwd"]
PATHS["maskgit_sample_primed"] = PATHS["maskgit_sample"] + ["patch_embed", "embed_tc",
                                                             "vq_assign", "vq_assign_tc"]
PATHS["t5_no_mask"] = ["attention_dense", "attention_tc32"]
# phase 10: f32 zero-shot (the f32 forms of K1, K2 grid, K3, K5 on f32 rows,
# K6; the embeds on their plain route, K7 f32 for the prompts) and the f32
# MaskGIT stage (the frozen f32 CTViT's encode, K3 / K11 f32, K7 dense f32,
# K12b f32 dense and with no bias on attention_tc32.cu, the PEG's f32 stencil;
# sampling's decoder with K2 seq, K1, K3 and K17 f32)
F32_ZS = ["spatial_attention_f32", "qk_attention_tc32", "tc32_gemm", "grid_attention_f32",
          "qk_attention_short_f32", "geglu_ff_f32", "geglu_ff_tc32", "vq_assign_f32",
          "vq_assign_tc", "fused_attention", "attention_tc32", "peg_fwd", "peg_fwd_f32"]
PATHS["zero_shot_f32_rows"] = F32_ZS + ["rearrange_patches_f32", "row_embed_plain"]
PATHS["zero_shot_f32_volume"] = F32_ZS + ["patch_embed_plain"]
PATHS["maskgit_f32_encode_ids"] = ["patch_embed_plain", "spatial_attention_f32",
                                   "qk_attention_tc32", "tc32_gemm", "seq_attention_f32",
                                   "qk_attention_short_f32", "geglu_ff_f32", "geglu_ff_tc32",
                                   "vq_assign_f32", "vq_assign_tc", "peg_fwd_f32"]
PATHS["maskgit_f32_train"] = ["geglu_ff_f32", "geglu_ff_tc32", "geglu_ff_bwd_f32",
                              "ff_tc32_tile", "tc32_gemm", "tc32_gemm_tn",
                              "attention_dense",
                              "attention_dense_bwd", "attention_tc32", "attention_tc32_bwd",
                              "fused_attention", "peg_fwd_f32", "peg_bwd", "peg_bwd_f32"]
PATHS["maskgit_f32_sample"] = ["attention_dense", "fused_attention", "attention_tc32",
                               "geglu_ff_f32", "geglu_ff_tc32", "seq_attention_f32",
                               "qk_attention_short_f32", "spatial_attention_f32",
                               "qk_attention_tc32", "tc32_gemm",
                               "unrearrange_patches_f32", "peg_fwd_f32"]
# phase 11: f32 CT-CLIP pretraining (`cli train --no-bf16`: the f32 forms of
# K1, K2 grid, K3 and their backwards K9, K10 grid, K11, K5 exact and K15 on
# f32 rows, K6 f32 in the ingest, K13a f32 and K13b f32 (attention_tc32.cu),
# the PEG's f32 stencil (forward and K14); the
# mini evaluation's K5 f32 rows, plain row embed, K7 f32) and the f32
# autoencoder (K1 / K9 f32 at n = 64, K2 / K10 seq f32, K6 and K17 f32)
PATHS["ctclip_f32_train"] = ["spatial_attention_bwd_f32", "qk_attention_tc32_bwd",
                             "grid_attention_bwd_f32", "qk_attention_short_bwd_f32",
                             "ff_tc32_tile", "tc32_gemm_tn",
                             "vq_assign_exact_f32", "vq_assign_exact_tc",
                             "vq_cluster_stats_f32", "geglu_ff_bwd_f32",
                             "geglu_ff_f32", "geglu_ff_tc32", "spatial_attention_f32",
                             "qk_attention_tc32", "tc32_gemm", "grid_attention_f32",
                             "qk_attention_short_f32", "rearrange_patches_f32",
                             "attention_dropout",
                             "attention_dropout_bwd", "attention_tc32", "attention_tc32_bwd",
                             "peg_fwd_f32", "peg_bwd", "peg_bwd_f32",
                             "vq_assign_f32", "vq_assign_tc",
                             "row_embed_plain", "fused_attention"]
AE_F32_TRAIN = ["seq_attention_f32", "qk_attention_short_f32", "seq_attention_bwd_f32",
                "qk_attention_short_bwd_f32", "ff_tc32_tile", "tc32_gemm_tn",
                "spatial_attention_f32",
                "qk_attention_tc32", "tc32_gemm", "spatial_attention_bwd_f32", "qk_attention_tc32_bwd", "geglu_ff_f32",
                "geglu_ff_tc32", "geglu_ff_bwd_f32", "peg_fwd_f32", "peg_bwd", "peg_bwd_f32",
                "vq_cluster_stats_f32", "vq_assign_exact_f32", "vq_assign_exact_tc",
                "rearrange_patches_f32", "unrearrange_patches_f32"]
PATHS["ctvit_ae_f32_train"] = AE_F32_TRAIN
PATHS["ctvit_ae_f32_discr"] = AE_F32_TRAIN
# the paths on a non-cubic grid must not take the grid form, and back
GRID_COUNTERS = ("grid_attention", "grid_attention_bwd")
SEQ_COUNTERS = ("seq_attention", "seq_attention_bwd")
# training backwards: autograd of the plain forward in bf16 rounds each
# gradient tensor to bf16 where the kernels keep f32 (weight gradients, dxn)
# or round at the JAX kernels' points, a few bf16 ulps apart
BWD_REL_TOL = 3e-2
# exact bf16 products summed in f32, in another order
SUM_REL_TOL = 1e-5
TRAIN_B = 8  # volumes per training batch
AUX_B = 8  # volumes per training batch with the auxiliary objectives
BERT_LAYERS = 12  # K13 launches per text-tower pass in training
# RadBERT training attention: (batch, heads, tokens, head dim), f32
BERT_SHAPE = (32, 12, 512, 64)
CHECK_BATCH = 8
DROP_RATE = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` timed calls (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- phase 2
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_bytes: int, flops: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" | "operations"): the least time the card could take for
    a call that reads its inputs once, writes its output once and runs
    `flops` operations at the published `peak` (bf16 tensor cores unless
    stated) and the published memory rate."""
    t_bytes, t_ops = read_bytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_cases(dev):
    """name -> dict(kern, plain, library (one PyTorch call computing the same
    function, or None), inputs (tensors the call reads), flops) at the
    full-width shapes of the zero-shot path with B volumes per batch."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention
    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_gemm, fused_geglu_ff, geglu_ff_plain
    from ct_clip_tpu_torch.ops.patch_embed import (
        fused_patch_embed, fused_row_embed, patch_embed_plain, rearrange_patches,
        rearrange_plain, row_embed_plain)
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_spatial_qknorm_attention,
        grid_qknorm_attention_plain, qknorm_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd, n_tok, pd = 512, 8, 32, 256, 13824, 4000
    tokens = B * n_tok
    cases = {}

    video = (torch.rand((B, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(bf)
    pe = (1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1))
    cases["patch_embed"] = dict(
        kern=lambda: fused_patch_embed(video, *pe, 10, 20),
        plain=lambda: patch_embed_plain(video, *pe, 10, 20), library=None,
        **embed_checks(video, pe, (10, 20)), inputs=(video, *pe), flops=2 * tokens * pd * dim)
    rows = rearrange_plain(video, 10, 20)
    # as the ingest calls it: one volume into the last slot of the batch buffer
    one, slot = video[-1:], torch.empty_like(rows)[-1:]
    cases["rearrange_patches"] = dict(
        kern=lambda: rearrange_patches(one, 10, 20, out=slot),
        plain=lambda: rearrange_plain(one, 10, 20),
        library=lambda: one.reshape(1, 24, 10, 24, 20, 24, 20)
        .permute(0, 1, 3, 5, 2, 4, 6).contiguous(),
        inputs=(one,), flops=0)
    cases["row_embed"] = dict(
        kern=lambda: fused_row_embed(rows, *pe),
        plain=lambda: row_embed_plain(rows, *pe), library=None,
        **embed_checks(rows, pe, None), inputs=(rows, *pe), flops=2 * tokens * pd * dim)

    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    proj_flops = 2 * tokens * dim * (hd + 2 * hd + hd)
    xs = rn(B * 24, 576, dim, dtype=bf)
    cpb = rn(heads, 576, 576)
    k1 = lambda: fused_spatial_qknorm_attention(xs, *w_attn, cpb, heads, dh)  # noqa: E731
    cases["spatial_attention"] = dict(
        kern=k1, plain=lambda: qknorm_attention_plain(xs, *w_attn, cpb, heads, dh),
        # the core on attention.cu's CUDA cores, as before the tensor cores
        twin=cuda_core_k9(k1), twin_source=K1_REPLACED,
        library=None, inputs=(xs, *w_attn, cpb),
        flops=proj_flops + 4 * (B * 24) * heads * 576 * 576 * dh)
    xg = rn(B, 24, 576, dim, dtype=bf)
    k2 = lambda: fused_grid_qknorm_attention(xg, *w_attn, heads, dh)  # noqa: E731
    cases["grid_attention"] = dict(
        kern=k2, plain=lambda: grid_qknorm_attention_plain(xg, *w_attn, heads, dh),
        # the core on attention.cu's CUDA cores, the products on gemm.cu
        twin=cuda_core_k2(k2), twin_source=K2_REPLACED,
        library=None, inputs=(xg, *w_attn),
        flops=proj_flops + 4 * (B * 576) * heads * 24 * 24 * dh)

    xf = rn(tokens, dim, dtype=bf)
    w_ff = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1),
            rn(2730, dim, scale=dim ** -0.5), rn(dim, 1365, scale=1365 ** -0.5))
    cases["geglu_ff"] = dict(
        kern=lambda: fused_geglu_ff(xf, *w_ff), plain=lambda: geglu_ff_plain(xf, *w_ff),
        twin=lambda: _geglu_ff_gemm(xf, *w_ff, 1e-5), twin_source=K3_REPLACED,
        yardstick=k3_yardstick(xf, w_ff), yardstick_is=K3_YARDSTICK,
        library=None, inputs=(xf, *w_ff), flops=2 * tokens * dim * (2730 + 1365))

    # BERT: 36 prompts x 12 heads x 512 positions x 64, head-major views of
    # the (b, n, h, d) projections, prompt-length pad masks
    q, k, v = (rn(36, 512, 12, 64, dtype=bf).transpose(1, 2) for _ in range(3))
    q = q * 64 ** -0.5
    lengths = torch.randint(5, 16, (36,), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None] < lengths[:, None]).float()
    key_bias = (1 - mask) * torch.finfo(torch.float32).min
    sdpa_mask = key_bias.to(bf)[:, None, None, :]  # additive, in q's dtype
    cases["fused_attention"] = dict(
        kern=lambda: fused_attention(q, k, v, key_bias=key_bias),
        plain=lambda: attention_plain(q, k, v, key_bias=key_bias),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                       scale=1.0),
        twin=cuda_core_twin(q, k, v, key_bias=key_bias)[0],
        inputs=(q, k, v, key_bias), flops=4 * 36 * 12 * 512 * 512 * 64)
    return cases


# K4 / K8 bf16 on embed_tc.cu against their plain versions: mean|err| <=
# EMBED_MEAN_TOL * mean|plain| besides REL_TOL of max.  The kernel rounds
# where the TPU kernel does (xn, y, yb = bf16(bf16(y) + bias), out) and sums
# in other orders; the planted copy adding the bias to the f32 y before one
# rounding (CT_EMBED_TC_ONE_ROUNDING) reads ~1.6e-3 (CPU, 2,000 x 4,000 ->
# 512) and must miss, as the max cannot tell the two apart
EMBED_MEAN_TOL = 2e-4
EMBED_REPLACED = ("layernorm.cu (LN(4000), plain or through the patch gather), gemm.cu "
                  "(WMMA product, EPI_BIAS_ROUNDED), layernorm.cu (LN(512))")
EMBED_YARDSTICK = "F.layer_norm, F.linear with the bias, F.layer_norm (cuBLAS)"


def embed_three_passes(x, pe, geom, eps: float = 1e-5):
    """K4 (x the (b, n, 4000) rows) or K8 (x the volume, geom (pt, p)) as
    the port ran them before embed_tc.cu: LN(4000) into stored normalised
    rows, gemm.cu's WMMA product with the rounded bias, LN(512): the
    replaced path, timed beside the kernel."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    s1, b1, w, pbias, s2, b2 = pe
    dim, pd = w.shape
    bf = torch.bfloat16
    b = x.shape[0]
    n = x.shape[1] if geom is None else x[0].numel() // pd
    xn = torch.empty((b * n, pd), dtype=bf, device=x.device)
    if geom is None:
        K.layernorm(x.reshape(b * n, pd), s1, b1, eps, xn)
    else:
        K.patch_layernorm(x, *geom, s1, b1, eps, xn)
    y = torch.empty((b * n, dim), dtype=bf, device=x.device)
    K.gemm(K.EPI_BIAS_ROUNDED, xn, w.to(bf).contiguous(), y, bias=pbias.to(bf).contiguous())
    out = torch.empty_like(y)
    K.layernorm(y, s2, b2, eps, out)
    return out.view(b, n, dim)


def embed_checks(x, pe, geom) -> dict:
    """The K4 / K8 case's extra checks for `kernel_phase`: the mean limit,
    the planted single rounding (which must miss it), bit-identical runs, the
    replaced three passes timed beside it, and the cuBLAS yardstick (a note:
    no one PyTorch call computes the embed)."""
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_plain

    s1, b1, w, pbias, s2, b2 = pe
    dim, pd = w.shape
    bf = x.dtype
    src = x.reshape(-1, pd) if geom is None else x

    def planted():
        return K.embed_tc(src, *pe, 1e-5, geom=geom,
                          lib=K.copy_library("embed_tc.cu", CT_EMBED_TC_ONE_ROUNDING=1))

    def yard():
        rows = x if geom is None else rearrange_plain(x, *geom)
        h = F.layer_norm(rows, (pd,), s1.to(bf), b1.to(bf))
        return F.layer_norm(F.linear(h, w.to(bf), pbias.to(bf)), (dim,), s2.to(bf), b2.to(bf))
    return dict(mean_tol=EMBED_MEAN_TOL, planted=planted, bit_identical=True,
                twin=lambda: embed_three_passes(x, pe, geom), twin_source=EMBED_REPLACED,
                yardstick=yard, yardstick_is=EMBED_YARDSTICK
                + ("" if geom is None else ", after the patch rows' contiguous copy"))


# K3 bf16's replaced path and its cuBLAS yardstick (a note, not the row's
# one-call library time: no PyTorch call computes K3 whole)
K3_REPLACED = "gemm.cu (WMMA EPI_GEGLU and EPI_RESIDUAL, layernorm.cu's LN as on the new route)"
K3_YARDSTICK = "F.layer_norm, F.linear to [a | g], a * gelu(g), F.linear + x (cuBLAS)"
K5_REPLACED = "gemm.cu (gemm_argmax_kernel, WMMA)"
K5_YARDSTICK = "x @ c^T (cuBLAS, bf16 out) then argmax"


def k3_yardstick(x, w_ff):
    """K3 bf16 as PyTorch calls (`K3_YARDSTICK`) on the same x and weights."""
    import torch.nn.functional as F

    scale, bias, wi, wo = w_ff
    wi, wo = wi.to(x.dtype), wo.to(x.dtype)
    inner = wo.shape[1]

    def run():
        h = F.linear(F.layer_norm(x, (x.shape[1],), scale.to(x.dtype), bias.to(x.dtype)), wi)
        return F.linear(h[:, :inner] * F.gelu(h[:, inner:]), wo) + x
    return run


def vq_case(dev, rows: int = B * 13824, codes: int = 8192, seed: int = 1):
    """K5 on bf16 rows: (x, embed_n, kernel, plain) at zero-shot's (27,648,
    512, 8,192) unless stated."""
    import torch

    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, 512), generator=g, device=dev).to(torch.bfloat16)
    embed_n = l2norm(torch.randn((codes, 512), generator=g, device=dev))
    return x, embed_n, (lambda: vq_assign(x, embed_n)), (lambda: vq_assign_plain(x, embed_n))


def k5_bf16_check(label: str, x, embed_n, got, ref) -> dict:
    """K5 bf16's check: >= 99% of ids equal to the plain version's, the rest
    near-ties within the bf16 margin (4e-3 of the row's largest |sim|,
    vq.py:17-22)."""
    import torch

    sim = x.float() @ embed_n.to(torch.bfloat16).float().t()
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    agree = (got == ref).float().mean().item()
    margin_ok = bool((gap <= 4e-3 * sim.abs().max(dim=1).values).all())
    log(f"kernel {label}: id agreement {agree:.6f} max sim gap {gap.max().item():.4e} "
        f"(>= 0.99 equal, the rest within 4e-3 of max)")
    if agree < 0.99 or not margin_ok:
        raise AssertionError(f"{label}: agreement {agree}, near-ties {margin_ok}")
    del sim
    return dict(max_abs_err=gap.max().item(), id_agreement=agree,
                tolerance=">= 0.99 ids equal, rest near-ties")


def ids_twin_result(name: str, fn, ref, source: str) -> dict:
    """The replaced assignment `fn` on the same rows: its median time and
    its ids' agreement with the plain version's `ref` (reported)."""
    import torch

    got = fn().long()
    torch.cuda.synchronize()
    agree = (got == ref.long()).float().mean().item()
    ms = cuda_ms(fn)
    log(f"kernel {name}: the replaced form ({source}) {ms:.3f} ms, ids equal to the plain "
        f"version's {agree:.6f}")
    return dict(source=CSRC + source.split(" ")[0], source_is=source, ms=ms, id_agreement=agree)


def k5_planted_ties(dev) -> dict:
    """K5 bf16 on exactly tied similarities at zero-shot's (27,648, 512,
    8,192): rows of integers in [-2, 2] against codes of integers in [-1,
    1] (every product and f32 sum exact, in any order), with the best code
    of one row in eleven copied to another index, lower or higher; the ids
    must equal torch.argmax's on the exact similarities, bit for bit (the
    lower code wins a tie)."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.vq import vq_assign

    g = torch.Generator(device=dev).manual_seed(19)
    rows, dim, codes = B * 13824, 512, 8192
    x = torch.randint(-2, 3, (rows, dim), generator=g, device=dev).to(torch.bfloat16)
    c = torch.randint(-1, 2, (codes, dim), generator=g, device=dev).float()
    best = (x.float() @ c.t()).argmax(dim=-1)[::11]
    dst = torch.randint(0, codes, best.shape, generator=g, device=dev)
    c[dst] = c[best]
    sim = x.float() @ c.t()
    want = sim.argmax(dim=-1).to(torch.int32)
    tied = int(((sim == sim.max(dim=-1, keepdim=True).values).sum(dim=-1) > 1).sum())
    del sim
    K.reset_launch_counts()
    got = vq_assign(x, c)
    torch.cuda.synchronize()
    launched = K.launch_counts()["vq_assign_tc"]
    equal = bool(torch.equal(got, want))
    log(f"kernel vq_assign on planted exact ties: {tied} of {rows} rows tie at their max; ids "
        f"equal to torch.argmax's: {equal} (vq_tc.cu launches {launched})")
    if not equal or tied < 1000 or launched != 1:
        raise AssertionError(f"vq_assign planted ties: equal {equal}, tied rows {tied}, "
                             f"launches {launched}")
    return dict(rows_tied_at_max=tied, ids_equal_torch_argmax=equal)


def k5_exact_planted_ties(dev, rows_form: str) -> dict:
    """K5 exact on vq_tc.cu on exactly tied similarities at the contrastive
    step's (110,592, 512, 8,192), as `k5_planted_ties`: codes of integers
    in [-1, 1] (so c_lo = 0), the best code of one row in eleven copied to
    another index; bf16 rows of integers in [-2, 2], or f32 rows of 64
    entries +-1 (the rest 0), which normalise exactly (xn = +-1/8, xl = 0):
    every product and f32 sum exact, in any order.  The ids must equal
    torch.argmax's on the exact similarities, bit for bit (the lower code
    wins a tie)."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.vq import vq_assign

    g = torch.Generator(device=dev).manual_seed(23)
    rows, dim, codes = TRAIN_B * 13824, 512, 8192
    if rows_form == "bf16":
        x = torch.randint(-2, 3, (rows, dim), generator=g, device=dev).to(torch.bfloat16)
        xs = x.float()
    else:
        x = torch.zeros((rows, dim), device=dev)
        at = torch.rand((rows, dim), generator=g, device=dev).argsort(dim=1)[:, :64]
        x.scatter_(1, at, torch.randint(0, 2, (rows, 64), generator=g, device=dev).float() * 2 - 1)
        xs = x / 8
        del at
    c = torch.randint(-1, 2, (codes, dim), generator=g, device=dev).float()
    best = (xs @ c.t()).argmax(dim=-1)[::11]
    dst = torch.randint(0, codes, best.shape, generator=g, device=dev)
    c[dst] = c[best]
    sim = xs @ c.t()
    want = sim.argmax(dim=-1).to(torch.int32)
    tied = int(((sim == sim.max(dim=-1, keepdim=True).values).sum(dim=-1) > 1).sum())
    del sim, xs
    K.reset_launch_counts()
    got = vq_assign(x, c, exact=True)
    torch.cuda.synchronize()
    launched = K.launch_counts()["vq_assign_exact_tc"]
    equal = bool(torch.equal(got, want))
    log(f"kernel vq_assign exact ({rows_form} rows) on planted exact ties: {tied} of {rows} rows "
        f"tie at their max; ids equal to torch.argmax's: {equal} (vq_tc.cu launches {launched})")
    if not equal or tied < 1000 or launched != 1:
        raise AssertionError(f"vq_assign exact ({rows_form}) planted ties: equal {equal}, tied "
                             f"rows {tied}, launches {launched}")
    return dict(rows_tied_at_max=tied, ids_equal_torch_argmax=equal)


def timing(case, out) -> dict:
    """Median kernel, plain and library times, and the bound, of one case
    (`out`: the tensor or tensors the call writes)."""
    ms, plain_ms = cuda_ms(case["kern"]), cuda_ms(case["plain"])
    library_ms = cuda_ms(case["library"]) if case["library"] else None
    outs = out if isinstance(out, (tuple, list)) else (out,)
    peak = case.get("peak", PEAK_BF16_FLOPS)
    bound_ms, bound_by = bound(nbytes(*case["inputs"], *outs), case["flops"], peak)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                peak_tflops=peak / 1e12, library_ms=library_ms,
                bound_share=bound_ms / ms)


def cuda_core_twin(q, k, v, do=None, key_bias=None, bias=None, seed=None, rate=0.0):
    """The CUDA-core kernels of attention_train.cu that attention_tc.cu (bf16)
    and attention_tc32.cu (f32) replaced, on the same inputs through their
    binding: a forward closure
    returning out and, given `do`, a backward closure returning dq, dk, dv
    and dbias with a (1, 1|h, n, n) `bias` or dkey_bias with a (b, n) f32
    `key_bias`, reading the f32 output as that backward did; with `seed` and
    `rate` > 0 the dropout forward and backward (K13a, K13b)."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    b, h, n, d = q.shape
    rows = [t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v)]
    kbias = None if bias is None else bias[0].float().contiguous()
    thresh = K.dropout_threshold(rate) if rate > 0 else 0
    drop = dict(seed=seed, thresh=thresh,
                keep_scale=K.dropout_keep_scale(rate) if thresh else 1.0)

    def fwd(out32=None):
        out = torch.empty_like(rows[0])
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        K.attention_train_fwd(*rows, out, lse, out32=out32, key_bias=key_bias, bias=kbias,
                              **drop)
        return out, lse

    if do is None:
        return lambda: fwd()[0], None
    out32 = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    out, lse = fwd(out32)

    def bwd():
        dq, dk, dv, dkb, db = K.attention_train_bwd(
            *rows, out, do.contiguous(), lse, out32=out32, key_bias=key_bias,
            want_dkey_bias=key_bias is not None, bias=kbias, want_dbias=kbias is not None,
            **drop)
        extra = () if db is None else (db.reshape(bias.shape),)
        return (dq, dk, dv) + extra + (() if dkb is None else (dkb,))
    return lambda: fwd()[0], bwd


def twin_result(name: str, fn, ref, source: str = "attention_train.cu") -> dict:
    """Error against the plain outputs `ref` and median time of the replaced
    kernel `fn` (cuda_core_twin; cuda_core_k9: `source`
    qknorm_attention_bwd.cu; k16a_replaced; K3 f32's FFMA path)."""
    import torch

    got = _as_tuple(fn())
    torch.cuda.synchronize()
    err, rel = _rel_errors(got, _as_tuple(ref))
    dtype = str(got[0].dtype).split(".")[-1]
    del got
    ms = cuda_ms(fn)
    log(f"kernel {name}: the replaced form ({source}, {dtype}) "
        f"{ms:.3f} ms, max_abs_err {err:.4e} max_rel_err {rel:.4e}")
    return dict(source=CSRC + source, ms=ms, max_abs_err=err, max_rel_err=rel)


def cuda_core_k9(fn):
    """`fn`, a call that reaches K9's attention core or K1's forward, with
    the core on the CUDA-core kernels that qknorm_attention_tc.cu and
    qknorm_attention_tc32.cu replaced (K9: qknorm_attention_bwd.cu's
    qk_attention_bwd_kernel, or qk_attention_bwd_f32_kernel in f32; K1:
    attention.cu's attention_kernel, or attention_f32_kernel in f32 with the
    projections on gemm.cu's FFMA tiles): kernels.qk_bwd_tensor_cores, the
    one gate of both directions, answers QK_CUDA_CORES inside it, so neither
    the launch nor the counter takes the tensor cores."""
    from ct_clip_tpu_torch.ops import kernels as K

    def run():
        with replaced(K, "qk_bwd_tensor_cores", lambda *a: K.QK_CUDA_CORES):
            return fn()
    return run


# the sources of K1's replaced path (`cuda_core_k9`), by dtype
K1_REPLACED = "attention.cu (attention_kernel; the products on ffn_tc.cu, as on the new route)"
K1_F32_REPLACED = "attention.cu (attention_f32_kernel; gemm.cu's FFMA products)"
# ... and K2's (`cuda_core_k2`)
K2_REPLACED = "attention.cu (attention_kernel) and gemm.cu's WMMA products"
K2_F32_REPLACED = "attention.cu (attention_f32_kernel) and gemm.cu's FFMA products"
# ... K11 f32's (ops/ffn.py::_geglu_ff_bwd_products on gemm.cu's f32 forms)
K11_F32_REPLACED = "gemm.cu (ff_bwd_kernel<float>, gemm_layout_f32_kernel: FFMA)"
# ... and K9 / K10 f32's (`replaced_qk_bwd_f32`)
K10_F32_REPLACED = ("qknorm_attention_bwd.cu (qk_attention_bwd_f32_kernel) and gemm.cu's FFMA "
                    "products")
K9_F32_REPLACED = "qknorm_attention_tc32.cu's core (as now) and gemm.cu's FFMA products"


def replaced_qk_bwd_f32(fn):
    """`fn`, a call that reaches K9 / K10 f32's backward, on the path the
    3xTF32 products and the short backward core replaced:
    kernels.qk_bwd_route answers QK_CUDA_CORES inside it, so the sublayer's
    backward takes gemm.cu's FFMA products around the core that
    kernels.qk_bwd_tensor_cores picks (K9: qknorm_attention_tc32.cu, K10:
    qknorm_attention_bwd.cu's f32 kernel).  The forward's gates are not
    touched."""
    from ct_clip_tpu_torch.ops import kernels as K

    def run():
        with replaced(K, "qk_bwd_route", lambda *a: K.QK_CUDA_CORES):
            return fn()
    return run


def replaced_qk_bwd_bf16(fn):
    """`fn`, a call that reaches K9 / K10 bf16's backward, on the path that
    ffn_tc.cu's NN / TN products and K10's short core replaced: the products
    on gemm.cu's gemm_layout (kernels.gemm_nn_tc and gemm_tn_tc answered by
    gemm_nn and gemm_tn) and kernels.qk_bwd_route answering QK_CUDA_CORES
    (K10's core on qknorm_attention_bwd.cu at K9's rounding points; K9's
    core stays on qknorm_attention_tc.cu); the q and kv recompute on
    ffn_tc.cu's NT store form, as before."""
    from ct_clip_tpu_torch.ops import kernels as K

    def run():
        with replaced(K, "qk_bwd_route", lambda *a: K.QK_CUDA_CORES), \
                replaced(K, "gemm_nn_tc", K.gemm_nn), replaced(K, "gemm_tn_tc", K.gemm_tn):
            return fn()
    return run


# the sources of K9 / K10 bf16's replaced path (`replaced_qk_bwd_bf16`)
K10_REPLACED = ("qknorm_attention_bwd.cu (qk_attention_bwd_kernel) and gemm.cu's WMMA "
                "products (gemm_layout_kernel)")
K9_REPLACED = "qknorm_attention_tc.cu's core (as now) and gemm.cu's WMMA products"


def k10_bf16_check(name: str, copy=None):
    """The check of K10 bf16's whole backward (seven gradients) or of its
    core alone (`copy`: a call of the core on a one-change copy, whose
    outputs must miss the mean tolerance): each output's max error within
    REL_TOL of max|plain| and its mean error within the mean tolerance of
    mean|plain| (K10_MEAN_TOL whole, K2_POINT_TOL for the core's merged, dq
    and dkv; the core's f32 scale sums within F32_REL_TOL)."""
    def check(got, ref):
        core = copy is not None
        rels = [_rel_errors((a,), (b,))[1] for a, b in zip(got, ref)]
        means = [_mean_rel_error(a, b) for a, b in zip(got, ref)]
        if core:
            ok = all(r <= REL_TOL and m <= K2_POINT_TOL for r, m in zip(rels[:3], means[:3])) \
                and all(r <= F32_REL_TOL for r in rels[3:])
            tol = (f"merged, dq, dkv: rel {REL_TOL} of max and {K2_POINT_TOL} of mean; the "
                   f"scale sums rel {F32_REL_TOL}")
        else:
            ok = all(r <= REL_TOL for r in rels) and all(m <= K10_MEAN_TOL for m in means)
            tol = f"rel {REL_TOL} of max and {K10_MEAN_TOL} of mean, each output"
        res = dict(max_abs_err=_rel_errors(got, ref)[0], max_rel_err=max(rels),
                   rel_err_by_output=rels, mean_rel_err_by_output=means, tolerance=tol)
        log(f"kernel {name}: by output max_rel_err {[f'{r:.2e}' for r in rels]}, mean "
            f"{[f'{m:.2e}' for m in means]} ({tol})")
        if core:
            cmeans = [_mean_rel_error(a, b) for a, b in zip(_as_tuple(copy())[:3], ref[:3])]
            res["round_p_copy_mean_rel_err"] = cmeans
            missed = max(cmeans) > K2_POINT_TOL
            log(f"kernel {name}: the copy with P rounded to bf16 (CT_QK_SHORT_BWD_ROUND_P) "
                f"reads mean {[f'{m:.2e}' for m in cmeans]}: outside {missed}")
            ok = ok and missed
        return ok, res
    return check


def k10_points_miss(name: str, res: dict, twin, ref) -> None:
    """K9's rounding points (the replaced path `twin`) must miss K10_MEAN_TOL
    against the plain version at the TPU's points `ref`."""
    import torch

    got = _as_tuple(twin())
    torch.cuda.synchronize()
    means = [_mean_rel_error(a, b) for a, b in zip(got, ref)]
    res["replaced"]["mean_rel_err_by_output"] = means
    log(f"kernel {name}: the replaced path (K9's rounding points) reads mean "
        f"{[f'{m:.2e}' for m in means]}: must exceed {K10_MEAN_TOL}")
    if min(means) <= K10_MEAN_TOL:
        raise AssertionError(f"{name}: K9's rounding points read within {K10_MEAN_TOL}")


def cuda_core_k2(fn):
    """`fn`, a call that reaches K2's forward, on the path that
    qknorm_attention_short.cu and the tensor-core products replaced:
    kernels.qk_fwd_route answers QK_CUDA_CORES inside it (the core on
    attention.cu's attention_kernel, or attention_f32_kernel with gemm.cu's
    FFMA products in f32) and qknorm_attention.proj_route PROJ_WMMA (the bf16
    products on gemm.cu's WMMA)."""
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    def run():
        with replaced(K, "qk_fwd_route", lambda *a: K.QK_CUDA_CORES), \
                replaced(Q, "proj_route", lambda *a: Q.PROJ_WMMA):
            return fn()
    return run


def k2_core_case(dev, g, shape, dtype) -> dict:
    """K2's attention core alone (kernels.qk_attention_short) as the
    sublayer's forward hands it over, 8 heads of 32: the (rows, 256) q and
    (rows, 512) kv of a (b, t, S) token grid read through its t-columns, or
    of (S, n) sequences.  bf16 on mma.sync against qk_attention_core_plain
    (the TPU's rounding points) within REL_TOL of max|plain| and its mean
    error within K2_POINT_TOL of mean|plain|, which attention_plain (the
    normalised p rounded, attention.cu's point) on the same heads must miss;
    f32 on the CUDA cores, merged written as hi and lo planes, hi + lo
    within TC32_REL_TOL; bit-identical across runs.  The replaced core (attention.cu's
    attention_kernel / attention_f32_kernel) is timed beside it, and, as
    K1's core row, SDPA on the normalised heads ((sequences, 8, n, 32),
    computed outside the timing, scale 1) as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.attention import attention_plain
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    heads, d = 8, 32
    hd, f32 = heads * d, dtype == torch.float32
    if len(shape) == 3:  # the grid's t-columns
        b, n, S = shape
        seqs = b * S
        layout = dict(sequences=seqs, inner=S, q_strides=(n * S * hd, hd, d, S * hd),
                      kv_strides=(n * S * 2 * hd, 2 * hd, d, S * 2 * hd))
    else:
        seqs, n = shape
        layout = dict(sequences=seqs, inner=1, q_strides=(n * hd, 0, d, hd),
                      kv_strides=(n * 2 * hd, 0, d, 2 * hd))
    rows = seqs * n
    q, kv = (torch.randn((rows, w), generator=g, device=dev).to(dtype) for w in (hd, 2 * hd))
    qs = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0
    ks = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    layout.update(heads=heads, n=n, d=d, q_scale=qs, k_scale=ks)
    counter = "qk_attention_short"
    tol = TC32_REL_TOL if f32 else REL_TOL

    def seq_major(t):  # grid rows (b, t, S) -> sequence-major (b, S, t)
        return t if len(shape) == 2 else t.view(b, n, S, -1).transpose(1, 2).reshape(rows, -1)

    def as_q(out):  # sequence-major rows (b, S, t) -> q's rows
        return out if len(shape) == 2 else out.view(b, S, n, -1).transpose(1, 2).reshape(rows, -1)

    def plain():
        return as_q(qk_attention_core_plain(seq_major(q), seq_major(kv), heads, d, n, qs, ks,
                                            None))

    def kern():
        before = K.launch_counts()[counter]
        out = K.qk_attention_short(q, kv, **layout)
        if K.launch_counts()[counter] != before + 1:
            raise AssertionError(f"K2 core did not launch {counter}")
        return out

    def replaced_core():
        merged = torch.empty_like(q)
        return K.attention(q, kv, kv[:, hd:], merged, warps=2, **layout)

    def heads_of(t, sc):
        return (l2norm(seq_major(t).float().view(seqs, n, heads, d)) * sc).to(dtype) \
            .transpose(1, 2)
    lib_in = (heads_of(q, qs), heads_of(kv[:, :hd], ks),
              seq_major(kv)[:, hd:].reshape(seqs, n, heads, d).transpose(1, 2))

    def check(got, ref):
        merged = got[0] + got[1] if f32 else got[0]
        err, rel = _rel_errors((merged,), ref)
        res = dict(max_abs_err=err, max_rel_err=rel,
                   tolerance=f"rel {tol}" + (" (hi + lo)" if f32 else ""))
        ok = rel <= tol
        if not f32:
            p_point = as_q(attention_plain(*lib_in).transpose(1, 2).reshape(rows, hd))
            res.update(mean_rel_err=_mean_rel_error(merged, ref[0]),
                       p_point_mean_rel_err=_mean_rel_error(p_point, ref[0]),
                       tolerance=f"rel {tol}; mean {K2_POINT_TOL}")
            ok = ok and res["mean_rel_err"] <= K2_POINT_TOL < res["p_point_mean_rel_err"]
        log(f"kernel K2 core ({str(dtype)[6:]}) at {shape}: max_abs_err {err:.4e} "
            f"max_rel_err {rel:.4e} (rel {tol})"
            + ("" if f32 else f"; mean_rel_err {res['mean_rel_err']:.4e} (mean {K2_POINT_TOL}), "
               f"rounding the normalised p {res['p_point_mean_rel_err']:.4e} (must miss)"))
        return ok, res
    return dict(kern=kern, plain=plain, check=check, bit_identical=True, twin=replaced_core,
                twin_source=("attention.cu (attention_f32_kernel)" if f32
                             else "attention.cu (attention_kernel)"),
                library=lambda: F.scaled_dot_product_attention(*lib_in, scale=1.0),
                inputs=(q, kv), outputs=(q, q) if f32 else (q,),
                flops=4 * seqs * heads * n * n * d,
                peak=PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)


def k2_cases(dev, dtype):
    """K2 in `dtype` beyond the shapes of the kernel phases (zero-shot's (2,
    24, 576, 512) grid there in kernel_cases / f32_kernel_cases, the
    sequence-major shapes in seq_kernel_cases / f32_kernel_cases): the
    sublayer at the contrastive step's (8, 24, 576, 512) grid, the replaced
    path (`cuda_core_k2`) timed beside it; the core alone (`k2_core_case`)
    at zero-shot's and the contrastive step's grids and at the
    sequence-major (4,608, 16) and (512, 20)."""
    import torch

    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_grid_qknorm_attention,
                                                        grid_qknorm_attention_plain)

    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(80 + f32)
    tag = "grid_attention_f32" if f32 else "grid_attention"

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    dim, heads, dh, hd = 512, 8, 32, 256
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    x = rn(TRAIN_B, 24, 576, dim).to(dtype)
    kern = lambda: fused_grid_qknorm_attention(x, *w, heads, dh)  # noqa: E731
    flops = 2 * x.numel() * 4 * hd + 4 * TRAIN_B * 576 * heads * 24 * 24 * dh
    case = dict(kern=kern, plain=lambda: grid_qknorm_attention_plain(x, *w, heads, dh),
                twin=cuda_core_k2(kern), twin_source=K2_F32_REPLACED if f32 else K2_REPLACED,
                library=None, inputs=(x, *w), outputs=(x,), flops=flops,
                tol=TC32_REL_TOL if f32 else REL_TOL)
    if f32:
        case.update(peak=PEAK_TF32_FLOPS, flops=3 * flops, f32_flops=flops)
    yield f"{tag}_contrastive", case
    del x, case
    for label, shape in (("", (B, 24, 576)), ("_contrastive", (TRAIN_B, 24, 576)),
                         ("_seq160", (CLIP160_B * 576, 16)), ("_generatect", (AE_B * 64, 20))):
        yield f"{tag}_short{label}", k2_core_case(dev, g, shape, dtype)


def k2_phase(dev, dtype, results: dict) -> None:
    """`k2_cases` through `train_kernel_phase`, into `results`: the
    contrastive sublayer under K2's entry, the core's shapes under its own
    (`grid_attention_short`, `grid_attention_f32_short`)."""
    import torch

    tag = "grid_attention_f32" if dtype == torch.float32 else "grid_attention"
    res = train_kernel_phase(dev, k2_cases(dev, dtype), B)
    results[tag]["at_contrastive"] = res.pop(f"{tag}_contrastive")
    core = res.pop(f"{tag}_short")
    for label in ("contrastive", "seq160", "generatect"):
        core[f"at_{label}"] = res.pop(f"{tag}_short_{label}")
    results[f"{tag}_short"] = core


def k1_core_case(dev, g, S: int, n: int, dtype) -> dict:
    """K1's attention core alone (kernels.qk_attention_fwd) on (S, n) planes,
    8 heads of 32, with an (8, n, n) bias, as the sublayer's forward hands it
    over (q (S n, 256) and kv (S n, 512) in `dtype`; the pre-pass included):
    bf16 on qknorm_attention_tc.cu against qk_attention_core_plain (the
    TPU's rounding points) within REL_TOL of max|plain|; f32 in 3xTF32 on
    qknorm_attention_tc32.cu, merged written as hi and lo planes, hi + lo
    within TC32_REL_TOL, a plain-TF32 copy (CT_TC32_PASSES=1) outside it;
    bit-identical across runs.  The replaced core (attention.cu's
    attention_kernel / attention_f32_kernel) is timed beside it, and, as the
    library yardstick, SDPA on the normalised heads (computed outside the
    timing) with the bias as attn_mask and scale 1."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    heads, d = 8, 32
    hd, f32 = heads * d, dtype == torch.float32
    q, kv = (torch.randn((S * n, w), generator=g, device=dev).to(dtype) for w in (hd, 2 * hd))
    qs = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0
    ks = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    bias = torch.randn((heads, n, n), generator=g, device=dev)
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d, q_strides=(n * hd, 0, d, hd),
                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), q_scale=qs, k_scale=ks, bias=bias)
    counter = "qk_attention_tc32" if f32 else "qk_attention_tc"
    tol = TC32_REL_TOL if f32 else REL_TOL

    def kern(lib=None):
        before = K.launch_counts()[counter]
        out = K.qk_attention_fwd(q, kv, lib=lib, **layout)
        if lib is None and K.launch_counts()[counter] != before + 1:
            raise AssertionError(f"K1 core did not launch {counter}")
        return out

    def replaced():
        merged = torch.empty_like(q)
        return K.attention(q, kv, kv[:, hd:], merged, warps=8 if n >= 128 else 2, **layout)

    def check(got, ref):
        merged = got[0] + got[1] if f32 else got[0]
        err, rel = _rel_errors((merged,), ref)
        log(f"kernel K1 core ({str(dtype)[6:]}) at ({S}, {n}): max_abs_err {err:.4e} "
            f"max_rel_err {rel:.4e} (rel {tol})")
        return rel <= tol, dict(max_abs_err=err, max_rel_err=rel,
                                tolerance=f"rel {tol}" + (" (hi + lo)" if f32 else ""))

    def sdpa_heads():
        def heads_of(t, sc):
            return (l2norm(t.float().view(S, n, heads, d)) * sc).to(dtype).transpose(1, 2)
        v = kv[:, hd:].reshape(S, n, heads, d).transpose(1, 2)
        return heads_of(q, qs), heads_of(kv[:, :hd], ks), v, bias.to(dtype)[None]
    lib_in = sdpa_heads()
    flops = 4 * S * heads * n * n * d
    case = dict(kern=kern, plain=lambda: qk_attention_core_plain(q, kv, heads, d, n, qs, ks, bias),
                check=check, bit_identical=True, twin=replaced,
                twin_source=("attention.cu (attention_f32_kernel)" if f32
                             else "attention.cu (attention_kernel)"),
                library=lambda: F.scaled_dot_product_attention(
                    *lib_in[:3], attn_mask=lib_in[3], scale=1.0),
                inputs=(q, kv, bias), outputs=(q, q) if f32 else (q,), flops=flops)
    if f32:
        tf32_lib = K.copy_library("qknorm_attention_tc32.cu", CT_TC32_PASSES=1)
        case.update(peak=PEAK_TF32_FLOPS, flops=3 * flops, f32_flops=flops, tols=(tol,),
                    copies={"qknorm_attention_tc32.cu in plain TF32 (CT_TC32_PASSES=1), hi + lo":
                            lambda: sum(kern(tf32_lib))})
    return case


def k1_cases(dev, dtype):
    """K1 in `dtype` on the tensor cores beyond the shapes of the kernel
    phases (zero-shot's (48, 576, 512) there in kernel_cases /
    f32_kernel_cases, the autoencoder's (160, 64, 512) in seq_kernel_cases /
    f32_kernel_cases): the sublayer at the contrastive step's (192, 576,
    512) and a ragged (48, 40, 512), the replaced path (`cuda_core_k9`)
    timed beside it; the core alone (`k1_core_case`) at zero-shot's,
    the contrastive step's, the autoencoder's and the ragged planes."""
    import torch

    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_spatial_qknorm_attention,
                                                        qknorm_attention_plain)

    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(70 + f32)
    tag = "spatial_attention_f32" if f32 else "spatial_attention"

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    dim, heads, dh, hd = 512, 8, 32, 256
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    for label, (S, n) in (("contrastive", (TRAIN_B * 24, 576)), ("ragged_n40", (B * 24, 40))):
        x, bias = rn(S, n, dim).to(dtype), rn(heads, n, n)
        kern = lambda x=x, bias=bias: fused_spatial_qknorm_attention(  # noqa: E731
            x, *w, bias, heads, dh)
        flops = 2 * S * n * dim * 4 * hd + 4 * S * heads * n * n * dh
        case = dict(kern=kern, plain=lambda x=x, bias=bias: qknorm_attention_plain(
            x, *w, bias, heads, dh), twin=cuda_core_k9(kern),
            twin_source=K1_F32_REPLACED if f32 else K1_REPLACED, library=None,
            inputs=(x, *w, bias), outputs=(x,), flops=flops,
            tol=TC32_REL_TOL if f32 else REL_TOL)
        if f32:
            case.update(peak=PEAK_TF32_FLOPS, flops=3 * flops, f32_flops=flops)
        yield f"{tag}_{label}", case
        del x, bias
    for label, (S, n) in (("", (B * 24, 576)), ("_contrastive", (TRAIN_B * 24, 576)),
                          ("_n64", (AE_B * AE_FRAMES // 10, 64)), ("_ragged_n40", (B * 24, 40))):
        yield f"{tag}_tc{label}", k1_core_case(dev, g, S, n, dtype)


def k1_phase(dev, dtype, results: dict) -> None:
    """`k1_cases` through `train_kernel_phase`, into `results`: the
    sublayer's shapes under the K1 entry, the core's under its own
    (`spatial_attention_tc`, `spatial_attention_f32_tc`)."""
    import torch

    tag = "spatial_attention_f32" if dtype == torch.float32 else "spatial_attention"
    res = train_kernel_phase(dev, k1_cases(dev, dtype), B)
    for label in ("contrastive", "ragged_n40"):
        results[tag][f"at_{label}"] = res.pop(f"{tag}_{label}")
    core = res.pop(f"{tag}_tc")
    for label in ("contrastive", "n64", "ragged_n40"):
        core[f"at_{label}"] = res.pop(f"{tag}_tc_{label}")
    results[f"{tag}_tc"] = core


def k3_cases(dev):
    """K3 bf16 on ffn_tc.cu beyond zero-shot's 27,648 rows (kernel_cases):
    MaskGIT's (and the autoencoder's) 10,240 rows, the contrastive step's
    110,592 (its 8 forward FFs a step) and a ragged 10,001, each within
    REL_TOL of max|plain| and bit-identical across runs, the replaced path
    (gemm.cu's WMMA epilogues) and the cuBLAS yardstick timed beside it."""
    import torch

    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_gemm, fused_geglu_ff, geglu_ff_plain

    g = torch.Generator(device=dev).manual_seed(72)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    dim, inner = 512, 1365
    w_ff = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
            rn(dim, inner, scale=inner ** -0.5))
    for label, rows in (("maskgit", MG_B * 1280), ("contrastive", TRAIN_B * 13824),
                        ("ragged", 10001)):
        x = rn(rows, dim).to(torch.bfloat16)
        yield f"geglu_ff_{label}", dict(
            kern=lambda x=x: fused_geglu_ff(x, *w_ff), plain=lambda x=x: geglu_ff_plain(x, *w_ff),
            twin=lambda x=x: _geglu_ff_gemm(x, *w_ff, 1e-5), twin_source=K3_REPLACED,
            yardstick=k3_yardstick(x, w_ff), yardstick_is=K3_YARDSTICK, bit_identical=True,
            library=None, inputs=(x, *w_ff), outputs=(x,),
            flops=2 * rows * dim * (2 * inner + inner), tol=REL_TOL)
        del x


def k3_phase(dev, results: dict) -> None:
    """`k3_cases` through `train_kernel_phase`, nested under K3's entry."""
    res = train_kernel_phase(dev, k3_cases(dev), B)
    for label in ("maskgit", "contrastive", "ragged"):
        results["geglu_ff"][f"at_{label}"] = res.pop(f"geglu_ff_{label}")


def qk_core_case(dev, g, S: int, n: int) -> dict:
    """K9's bf16 attention core alone (kernels.qk_attention_bwd) on (S, n)
    planes, 8 heads of 32, with an (8, n, n) bias, as the sublayer's backward
    hands it over (q and dO (S n, 256), kv (S n, 512)): on the tensor cores
    against qk_attention_bwd_core_plain (the TPU kernel's rounding points),
    merged, dq and dkv within REL_TOL of max|plain|, the sums over all planes
    (dq_scale, dk_scale, dbias) within BWD_REL_TOL; dbias's rows sum to zero
    within 16x the plain f32 version's rounding, and a copy summing D_i from
    bf16(P) (CT_QK_TC_D_FROM_BF16_P) must land outside that; the replaced
    CUDA-core kernel timed beside it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain

    heads, d = 8, 32
    hd = heads * d
    q, kv, dm = (torch.randn((S * n, w), generator=g, device=dev).to(torch.bfloat16)
                 for w in (hd, 2 * hd, hd))
    qs = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0
    ks = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    bias = torch.randn((heads, n, n), generator=g, device=dev)
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d, q_strides=(n * hd, 0, d, hd),
                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), q_scale=qs, k_scale=ks, bias=bias)
    plain_args = (heads, d, n, qs, ks, bias)
    tols = (REL_TOL,) * 3 + (BWD_REL_TOL,) * 3

    def check(got, ref):
        rels = [_rel_errors((a,), (b,))[1] for a, b in zip(got, ref)]
        f32 = qk_attention_bwd_core_plain(q.float(), kv.float(), dm.float(), *plain_args)[5]
        plain_rows = f32.sum(-1).abs().max().item()
        del f32
        rows = got[5].sum(-1).abs().max().item()
        copy = K.copy_library("qknorm_attention_tc.cu", CT_QK_TC_D_FROM_BF16_P=1)
        fault_rows = K.qk_attention_bwd(q, kv, dm, lib=copy, **layout)[5].sum(-1) \
            .abs().max().item()
        res = dict(max_abs_err=_rel_errors(got, ref)[0], max_rel_err=max(rels),
                   rel_err_by_output=rels, tolerance=f"rel {tols} by output; dbias rows within "
                   "16x the plain f32 version's sums, the D_i-from-bf16(P) copy outside",
                   dbias_row_sum_max=rows, plain_f32_dbias_row_sum_max=plain_rows,
                   d_from_bf16_p_dbias_row_sum_max=fault_rows)
        log(f"kernel K9 core at ({S}, {n}): max_rel_err by output "
            f"{[f'{r:.2e}' for r in rels]}; largest |row sum| of dbias {rows:.3e}, plain f32 "
            f"{plain_rows:.3e}, the copy with D_i from bf16(P) {fault_rows:.3e} (must exceed "
            f"16x the plain's)")
        return all(r <= t for r, t in zip(rels, tols)) and rows <= 16 * plain_rows < fault_rows, \
            res

    return dict(kern=lambda: K.qk_attention_bwd(q, kv, dm, **layout),
                plain=lambda: qk_attention_bwd_core_plain(q, kv, dm, *plain_args),
                twin=cuda_core_k9(lambda: K.qk_attention_bwd(
                    q, kv, dm, group=-(-S // min(S, 33)), warps=8, **layout)),
                twin_source="qknorm_attention_bwd.cu", check=check, bit_identical=True,
                library=None, inputs=(q, kv, dm, bias), outputs=(q, q, kv, bias),
                flops=12 * S * heads * n * n * d)


def kernel_phase(dev):
    import torch

    results = {}
    for name, case in kernel_cases(dev).items():
        got, ref = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: bad kernel output {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        # K6 moves values: it must equal its plain version bit for bit
        exact = name == "rearrange_patches"
        res = dict(max_abs_err=err, max_rel_err=rel,
                   tolerance="bit-exact" if exact else f"rel {REL_TOL}",
                   **timing(case, got))
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
        log(f"kernel {name}: max_abs_err {err:.4e} max_rel_err {rel:.4e} "
            f"({res['tolerance']}) kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {lib} bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, {100 * res['bound_share']:.1f}% of it reached)")
        if (exact and not torch.equal(got, ref)) or rel > REL_TOL:
            raise AssertionError(f"{name}: error {err:.3e} (rel {rel:.3e}) "
                                 f"outside {res['tolerance']}")
        if case.get("mean_tol"):  # K4 / K8: the mean tells the rounding points apart
            res["mean_rel_err"] = _mean_rel_error(got, ref)
            res["planted_one_rounding_mean_rel_err"] = _mean_rel_error(
                case["planted"]().view(ref.shape), ref)
            res["tolerance"] += f", mean {case['mean_tol']}"
            res["bit_identical"] = bool(torch.equal(case["kern"](), got))
            log(f"kernel {name}: mean_rel_err {res['mean_rel_err']:.3e} (limit "
                f"{case['mean_tol']}); the planted single rounding of y + bias "
                f"{res['planted_one_rounding_mean_rel_err']:.3e} (must exceed it); "
                f"bit-identical across two runs: {res['bit_identical']}")
            if res["mean_rel_err"] > case["mean_tol"] or not res["bit_identical"] \
                    or res["planted_one_rounding_mean_rel_err"] <= case["mean_tol"]:
                raise AssertionError(f"{name}: mean check failed: {res}")
        if case.get("twin"):
            res["replaced"] = twin_result(name, case["twin"], ref,
                                          case.get("twin_source", "attention_train.cu"))
        yardstick(case, res, name)
        results[name] = res
        del got, ref

    # K5 on bf16 rows at zero-shot's (27,648, 512, 8,192), then ragged rows
    # and a ragged code count (checked, untimed), then planted exact ties
    from ct_clip_tpu_torch.ops import kernels as K

    for label, shape in (("", {}), ("_ragged_rows", dict(rows=10001, seed=2)),
                         ("_ragged_codes", dict(codes=8000, seed=3))):
        x, embed_n, kern, plain = vq_case(dev, **shape)
        got, ref = kern().long(), plain().long()
        res = k5_bf16_check(f"vq_assign{label}", x, embed_n, got, ref)
        if label:
            results["vq_assign"][f"at{label}"] = dict(res, rows=x.shape[0],
                                                      codes=embed_n.shape[0])
            del x, embed_n, got, ref
            continue
        cb = embed_n.to(torch.bfloat16).contiguous()
        case = dict(kern=kern, plain=plain, library=None, inputs=(x, embed_n),
                    flops=2 * x.shape[0] * 512 * 8192, yardstick_is=K5_YARDSTICK,
                    yardstick=lambda: (x @ cb.t()).argmax(dim=-1))
        res.update(timing(case, got.int()))
        res["replaced"] = ids_twin_result("vq_assign", lambda: K.gemm_argmax(x, cb), ref,
                                          K5_REPLACED)
        yardstick(case, res, "vq_assign")
        log(f"kernel vq_assign: kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} ms "
            f"library none bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
            f"{100 * res['bound_share']:.1f}% of it reached)")
        results["vq_assign"] = res
        del x, embed_n, cb, got, ref
    results["vq_assign"]["planted_ties"] = k5_planted_ties(dev)
    torch.cuda.empty_cache()
    return results


def yardstick(case, res: dict, name: str) -> None:
    """A case's cuBLAS yardstick (`yardstick`: PyTorch calls computing the
    same function, not one call, so not the row's library time): its median
    time into `res` as a note."""
    if not case.get("yardstick"):
        return
    res["cublas_yardstick_ms"] = cuda_ms(case["yardstick"])
    res["cublas_yardstick"] = case["yardstick_is"]
    log(f"kernel {name}: cuBLAS yardstick ({case['yardstick_is']}) "
        f"{res['cublas_yardstick_ms']:.3f} ms")


# ------------------------------------------ phase 2, RadBERT training attention
def train_attention_inputs(dev, b: int, seed: int, n: int = BERT_SHAPE[2]):
    """BERT's (b, n, h, d) f32 projections viewed head-major, q scaled, a
    per-key pad bias from report lengths in [64, n], an output gradient."""
    import torch

    _, h, _, d = BERT_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=dev).transpose(1, 2)
               for _ in range(3))
    lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
    key_bias = (1 - mask) * torch.finfo(torch.float32).min
    do = torch.randn((b, h, n, d), generator=g, device=dev)
    return q * d ** -0.5, k, v, key_bias, do


def sdpa_backend(q, k, v, mask, dropout_p: float) -> str:
    """The backend F.scaled_dot_product_attention dispatches these inputs to."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=dropout_p,
                                              is_causal=False, scale=1.0)).name


def train_attention_cases(dev, b: int):
    """K7 f32, K13 forward, K12 and K13 backward at (b, 12, 512, 64), all on
    attention_tc32.cu: each case's kernel call (through the wrapper the
    model calls; a backward is torch.autograd.grad of a kept forward), plain
    version, library call (F.scaled_dot_product_attention in f32 with the
    additive key mask, or autograd.grad of a kept SDPA output), the tensors
    it reads and its products, at the TF32 peak, three TF32 products for
    each f32 one, with the CUDA-core bound beside it and the replaced
    CUDA-core kernel (`twin`); the forwards also bit-identical across two
    runs, and their plain-TF32 copy (`copy`), which must miss
    TC32_REL_TOL."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_dropout_plain, attention_plain, dropout_mask,
        fused_attention, fused_attention_kbias_dropout)

    _, h, n, d = BERT_SHAPE
    q, k, v, kb, do = train_attention_inputs(dev, b, seed=20)
    seed = torch.tensor([20231016], dtype=torch.int64, device=dev)
    sdpa_mask = kb[:, None, None, :]
    product = 2 * b * h * n * n * d
    leaves = [t.detach().requires_grad_() for t in (q, k, v, kb)]
    out_k12 = fused_attention(*leaves[:3], key_bias=leaves[3])
    out_k13 = fused_attention_kbias_dropout(*leaves, seed, DROP_RATE)
    lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask, scale=1.0)
    lib_drop = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask,
                                              dropout_p=DROP_RATE, scale=1.0)
    lse = torch.empty((b, h, n), device=dev)  # the residual a backward reads

    def grad(out, ins):
        return torch.autograd.grad(out, ins, do, retain_graph=True)

    def plain_bwd(mask=None):
        return tuple(t for t in attention_bwd_plain(q, k, v, do, key_bias=kb, mask=mask)
                     if t is not None)

    def k7():
        return fused_attention(q, k, v, key_bias=kb)

    def k13a():
        return fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE)
    fwd = dict(flops=3 * 2 * product, peak=PEAK_TF32_FLOPS, f32_flops=2 * product,
               tol=TC32_REL_TOL, bit_identical=True)
    return {
        "fused_attention_f32": dict(
            kern=k7, plain=lambda: attention_plain(q, k, v, key_bias=kb),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                           scale=1.0),
            backend=sdpa_backend(q, k, v, sdpa_mask, 0.0), inputs=(q, k, v, kb),
            copy=tf32_copy(k7, "attention_tc32_fwd"),
            twin=cuda_core_twin(q, k, v, key_bias=kb)[0], **fwd),
        "attention_dropout": dict(
            kern=k13a, plain=lambda: attention_dropout_plain(q, k, v, kb, seed, DROP_RATE),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, dropout_p=DROP_RATE, scale=1.0),
            backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE), inputs=(q, k, v, kb, seed),
            copy=tf32_copy(k13a, "attention_tc32_fwd"),
            twin=cuda_core_twin(q, k, v, key_bias=kb, seed=seed, rate=DROP_RATE)[0], **fwd),
        "attention_bwd": dict(
            kern=lambda: grad(out_k12, leaves), plain=plain_bwd,
            library=lambda: grad(lib_out, lib_in),
            backend=sdpa_backend(q, k, v, sdpa_mask, 0.0),
            inputs=(q, k, v, kb, do, out_k12, lse), flops=3 * 5 * product,
            peak=PEAK_TF32_FLOPS, f32_flops=5 * product, tol=TC32_REL_TOL,
            twin=cuda_core_twin(q, k, v, do, key_bias=kb)[1]),
        "attention_dropout_bwd": dict(
            kern=lambda: grad(out_k13, leaves),
            plain=lambda: plain_bwd(dropout_mask(seed, b, h, n, DROP_RATE, dev)),
            library=lambda: grad(lib_drop, lib_in),
            backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE),
            inputs=(q, k, v, kb, seed, do, out_k13, lse), flops=3 * 5 * product,
            peak=PEAK_TF32_FLOPS, f32_flops=5 * product, tol=TC32_REL_TOL,
            twin=cuda_core_twin(q, k, v, do, key_bias=kb, seed=seed, rate=DROP_RATE)[1]),
    }


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def kept_shares(dev, seed, dtype) -> tuple:
    """The kept share of K13's mask in its forward and in its backward at
    (CHECK_BATCH, 12, 512, 64) in `dtype`, and 4 sigma of a share: uniform
    probabilities, v = 1 and dO = 1 turn the output and dv into kept counts
    times the kept value, 1 / (1 - rate) as the kernels multiply it into P
    (rounded to bf16 with P in bf16)."""
    import torch

    from ct_clip_tpu_torch.ops.attention import (dropout_keep_scale,
                                                 fused_attention_kbias_dropout)

    b, (_, h, n, d) = CHECK_BATCH, BERT_SHAPE
    zeros = torch.zeros((b, h, n, d), dtype=dtype, device=dev)
    ones = torch.ones_like(zeros)
    free = torch.zeros((b, n), device=dev)
    scale = torch.tensor(dropout_keep_scale(DROP_RATE)).to(dtype).item()
    v1 = ones.clone().requires_grad_()
    out = fused_attention_kbias_dropout(zeros, zeros, v1, free, seed, DROP_RATE)
    dv, = torch.autograd.grad(out, v1, ones)
    share_fwd = out[..., 0].double().mean().item() / scale
    share_bwd = dv[..., 0].double().sum().item() / (scale * b * h * n)
    return share_fwd, share_bwd, 4 * (DROP_RATE * (1 - DROP_RATE) / (b * h * n * n)) ** 0.5


def dropout_checks(dev) -> dict:
    """K13 at (CHECK_BATCH, 12, 512, 64): the same seed gives the same bits;
    the kept share of the forward's and of the backward's mask lies within
    4 sigma of 1 - rate (`kept_shares`); and the backward's mask is the
    forward's: the output is linear in v, so the difference of two forwards
    along a direction must equal the VJP's dv along it."""
    import torch

    from ct_clip_tpu_torch.ops.attention import fused_attention_kbias_dropout

    b = CHECK_BATCH
    q, k, v, kb, _ = train_attention_inputs(dev, b, seed=21)
    seed = torch.tensor([77], dtype=torch.int64, device=dev)

    def f(v_):
        return fused_attention_kbias_dropout(q, k, v_, kb, seed, DROP_RATE)

    same = torch.equal(f(v), f(v))
    ones = torch.ones_like(q)
    share_fwd, share_bwd, four_sigma = kept_shares(dev, seed, torch.float32)

    g = torch.Generator(device=dev).manual_seed(22)
    direction = torch.randn(v.shape, generator=g, device=dev) * 0.1
    vg = v.detach().clone().requires_grad_()
    dv, = torch.autograd.grad(f(vg), vg, ones)
    jvp_fwd = (f(v + direction).double() - f(v).double()).sum().item()
    jvp_vjp = (dv.double() * direction.double()).sum().item()
    identity_rel = abs(jvp_fwd - jvp_vjp) / max(abs(jvp_vjp), 1.0)
    res = dict(deterministic=same, kept_share_fwd=share_fwd, kept_share_bwd=share_bwd,
               kept_share_4sigma=four_sigma, mask_identity_rel_err=identity_rel)
    log(f"kernel attention_dropout: same seed same output {same}; kept share "
        f"forward {share_fwd:.6f} backward {share_bwd:.6f} (1 - rate {1 - DROP_RATE}, "
        f"4 sigma {four_sigma:.2e}); forward/backward mask identity rel err "
        f"{identity_rel:.2e} (tol {F32_REL_TOL})")
    if not same or identity_rel > F32_REL_TOL or any(
            abs(x - (1 - DROP_RATE)) > four_sigma for x in (share_fwd, share_bwd)):
        raise AssertionError(f"attention_dropout checks failed: {res}")
    return res


def k13a_f32_mask_bits(dev) -> dict:
    """K13a f32's mask (attention_tc32.cu's forward) is K13b f32's (its
    backward) and the plain version's (`dropout_mask`), bit for bit, at
    (CHECK_BATCH, 12, 512, 64), and its kept share lies within 4 sigma of
    1 - rate: with q = k = 0 and no key bias every P is 1 / n, so with v
    one-hot over 64 keys the output's column c is P M of key j0 + c (0 where
    dropped), and with dO one-hot over 64 queries dv's column c is P M of
    query i0 + c: eight calls each read every element's keep bit."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.attention import dropout_mask, fused_attention_kbias_dropout

    b, (_, h, n, d) = CHECK_BATCH, BERT_SHAPE
    seed = torch.tensor([20261020], dtype=torch.int64, device=dev)
    zeros = torch.zeros((b, h, n, d), device=dev)
    free = torch.zeros((b, n), device=dev)
    fwd_keep = torch.empty((b, h, n, n), dtype=torch.bool, device=dev)
    bwd_keep = torch.empty_like(fwd_keep)
    before = K.launch_counts()
    for c0 in range(0, n, d):
        onehot = torch.zeros_like(zeros)
        onehot[:, :, c0:c0 + d] = torch.eye(d, device=dev)
        v = onehot.clone().requires_grad_()
        out = fused_attention_kbias_dropout(zeros, zeros, v, free, seed, DROP_RATE)
        dv, = torch.autograd.grad(out, v, onehot)
        fwd_keep[..., c0:c0 + d] = out.detach() > 0  # [i, c]: query i, key c0 + c
        bwd_keep[:, :, c0:c0 + d] = (dv > 0).transpose(-1, -2)  # [j, c]: key j, query c0 + c
    ran = {k: K.launch_counts()[k] - before[k] for k in ("attention_tc32", "attention_tc32_bwd")}
    plain = dropout_mask(seed, b, h, n, DROP_RATE, dev) > 0
    share = fwd_keep.double().mean().item()
    four_sigma = 4 * (DROP_RATE * (1 - DROP_RATE) / (b * h * n * n)) ** 0.5
    res = dict(mask_fwd_equals_bwd=torch.equal(fwd_keep, bwd_keep),
               mask_fwd_equals_plain=torch.equal(fwd_keep, plain),
               mask_elements_differing=int((fwd_keep != bwd_keep).sum()),
               kept_share_mask_bits=share, kept_share_4sigma=four_sigma)
    log(f"kernel attention_dropout (K13a f32, attention_tc32.cu): keep bits of all "
        f"{fwd_keep.numel():,} elements equal to K13b f32's {res['mask_fwd_equals_bwd']} "
        f"({res['mask_elements_differing']} differ) and to the plain mask's "
        f"{res['mask_fwd_equals_plain']}; kept share {share:.6f} (1 - rate {1 - DROP_RATE}, "
        f"4 sigma {four_sigma:.2e}); launches {ran}")
    if not (res["mask_fwd_equals_bwd"] and res["mask_fwd_equals_plain"]) \
            or abs(share - (1 - DROP_RATE)) > four_sigma \
            or ran != dict(attention_tc32=n // d, attention_tc32_bwd=n // d):
        raise AssertionError(f"K13a f32 mask checks failed: {res}, launches {ran}")
    return res


def lse_identity_checks(dev) -> dict:
    """The forward's lse against the S that attention_tc32.cu's backward row
    pass recomputes, with a pad key bias at (CHECK_BATCH, 12, 512, 64) and
    with MaskGIT's dense per-head bias at (2, 8, 1280, 64): with q's first
    column 0 and k's 1 (S does not see them), v = 0 and out = dO = e_0 (so
    D_i = 1 and dP = 0), the row pass's dS is -P and dq[..., 0] = -sum_j
    P_ij = -exp(lse_S - lse), lse_S the log-sum-exp of the row pass's own
    S + bias.  The largest |log(-dq[..., 0])| over the rows is the largest
    difference, read through the backward's arithmetic (P K's rounding, ~1e-7,
    included); it must stay under TC32_REL_TOL, and the CUDA-core forward's
    (attention_train.cu, true f32 S) is reported beside it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    res = {}
    for label, (b, h, n), bias_heads in (("key_bias", (CHECK_BATCH, 12, 512), 0),
                                         ("dense", (2, 8, 1280), 8)):
        g = torch.Generator(device=dev).manual_seed(26)
        q, k = (torch.randn((b, h, n, 64), generator=g, device=dev) for _ in range(2))
        q = q * 0.125
        q[..., 0], k[..., 0] = 0.0, 1.0
        zeros, e0 = torch.zeros_like(q), torch.zeros_like(q)
        e0[..., 0] = 1.0
        bias = kb = None
        if bias_heads:
            bias = torch.randn((bias_heads, n, n), generator=g, device=dev)
        else:
            lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
            kb = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() \
                * torch.finfo(torch.float32).min
        diffs = {}
        for fwd in (K.attention_tc32_fwd, K.attention_train_fwd):
            lse = torch.empty((b, h, n), device=dev)
            fwd(q, k, zeros, torch.empty_like(q), lse, key_bias=kb, bias=bias)
            dq = K.attention_tc32_bwd(q, k, zeros, e0, e0, lse, key_bias=kb, bias=bias)[0]
            diffs[fwd.__name__] = torch.log(-dq[..., 0].double()).abs().max().item()
        res[f"{label}_max_lse_diff"] = diffs["attention_tc32_fwd"]
        res[f"{label}_cuda_core_forward_max_lse_diff"] = diffs["attention_train_fwd"]
        log(f"kernel fused_attention_f32: lse identity ({label}, ({b}, {h}, {n}, 64)): the "
            f"largest |lse of the backward row pass's S - the forward's lse| "
            f"{diffs['attention_tc32_fwd']:.3e} (attention_tc32.cu; tol {TC32_REL_TOL}), "
            f"{diffs['attention_train_fwd']:.3e} from the CUDA-core forward (reported)")
        if not diffs["attention_tc32_fwd"] <= TC32_REL_TOL:
            raise AssertionError(f"lse identity ({label}): {diffs}")
    return res


def k13a_bf16_checks(dev) -> dict:
    """K13a in bf16 on attention_tc.cu at a ragged n 500 (batch CHECK_BATCH,
    12 heads, pad key bias): within REL_TOL of the plain version with the
    same mask, outside it with another seed's, bit-identical across two
    runs, one launch of attention_tc each; and the kept share of the bf16
    forward's and backward's mask (`kept_shares`) within 4 sigma of
    1 - rate."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.attention import (attention_dropout_plain,
                                                 fused_attention_kbias_dropout)

    n, bf = 500, torch.bfloat16
    q, k, v, kb, _ = train_attention_inputs(dev, CHECK_BATCH, seed=25, n=n)
    q, k, v = (t.to(bf) for t in (q, k, v))
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    before = K.launch_counts()["attention_tc"]
    got = fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE)
    again = fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE)
    on_tc = K.launch_counts()["attention_tc"] - before
    ref = attention_dropout_plain(q, k, v, kb, seed, DROP_RATE)
    wrong = attention_dropout_plain(q, k, v, kb, seed + 1, DROP_RATE)
    _, rel = _rel_errors((got,), (ref,))
    _, rel_wrong = _rel_errors((got,), (wrong,))
    share_fwd, share_bwd, four_sigma = kept_shares(dev, seed, bf)
    res = dict(ragged_n500_max_rel_err=rel, ragged_n500_wrong_seed_max_rel_err=rel_wrong,
               ragged_n500_bit_identical=torch.equal(got, again), kept_share_fwd=share_fwd,
               kept_share_bwd=share_bwd, kept_share_4sigma=four_sigma)
    log(f"kernel attention_dropout_bf16 (K13a, attention_tc.cu) at ({CHECK_BATCH}, 12, {n}, 64): "
        f"max_rel_err {rel:.4e} (rel {REL_TOL}), another seed's mask {rel_wrong:.4e} (must "
        f"exceed it), bit-identical {res['ragged_n500_bit_identical']}, launches on the "
        f"tensor cores {on_tc} of 2; kept share forward {share_fwd:.6f} backward "
        f"{share_bwd:.6f} (1 - rate {1 - DROP_RATE}, 4 sigma {four_sigma:.2e})")
    if rel > REL_TOL or rel_wrong <= REL_TOL or not res["ragged_n500_bit_identical"] \
            or on_tc != 2 or any(abs(x - (1 - DROP_RATE)) > four_sigma
                                 for x in (share_fwd, share_bwd)):
        raise AssertionError(f"attention_dropout_bf16 checks failed: {res}")
    return res


def train_attention_phase(dev) -> dict:
    """Check at batch CHECK_BATCH against the plain versions (relative to the
    largest plain value of each output), then time at the full batch."""
    import torch

    results = {}
    for name, case in train_attention_cases(dev, CHECK_BATCH).items():
        got, ref = _as_tuple(case["kern"]()), _as_tuple(case["plain"]())
        torch.cuda.synchronize()
        if len(got) != len(ref) or any(g.shape != r.shape or not torch.isfinite(g).all()
                                       for g, r in zip(got, ref)):
            raise AssertionError(f"{name}: bad kernel outputs")
        errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        rels = [e / r.abs().max().item() for e, r in zip(errs, ref)]
        tol = case.get("tol", F32_REL_TOL)
        res = results[name] = dict(max_abs_err=max(errs), max_rel_err=max(rels),
                                   tolerance=f"rel {tol} per output", check_batch=CHECK_BATCH)
        if max(rels) > tol:
            raise AssertionError(f"{name}: rel errors {rels} outside {tol}")
        if case.get("bit_identical"):  # no atomics: a second run equals the first
            res["bit_identical"] = all(torch.equal(a, g)
                                       for a, g in zip(_as_tuple(case["kern"]()), got))
            if not res["bit_identical"]:
                raise AssertionError(f"{name}: a second run differs from the first")
        if case.get("copy"):  # the plain-TF32 copy must miss the tolerance
            res["plain_tf32_max_rel_err"] = _rel_errors(_as_tuple(case["copy"]()), ref)[1]
            log(f"kernel {name} (3xTF32) at ({CHECK_BATCH}, 12, 512, 64): max_rel_err "
                f"{max(rels):.4e} (rel {tol}); bit-identical across two runs: "
                f"{res['bit_identical']}; the plain-TF32 copy max_rel_err "
                f"{res['plain_tf32_max_rel_err']:.4e} (must exceed {tol})")
            if res["plain_tf32_max_rel_err"] <= tol:
                raise AssertionError(f"{name}: the plain-TF32 copy is within {tol}: {res}")
        del got, ref
    results["attention_dropout"].update(dropout_checks(dev))
    results["attention_dropout"].update(k13a_f32_mask_bits(dev))
    results["fused_attention_f32"].update(lse_identity_checks(dev))
    results["attention_bwd"].update(tc32_checks(dev))
    results["attention_dropout_bwd"].update(tc32_checks(dev, DROP_RATE))
    torch.cuda.empty_cache()

    for name, case in train_attention_cases(dev, BERT_SHAPE[0]).items():
        res = results[name]
        got = _as_tuple(case["kern"]())
        res.update(timing(case, got), library_backend=case["backend"], shape=list(BERT_SHAPE))
        peak = "f32 peak"
        if case.get("bound_tf32_ms"):  # an f32 form's bound were it in 3xTF32
            res["bound_3xtf32_ms"] = case["bound_tf32_ms"]
        if case.get("f32_flops"):  # 3xTF32: the f32 CUDA-core bound beside the TF32 one
            res["bound_f32_cuda_cores_ms"] = bound(nbytes(*case["inputs"], *got),
                                                   case["f32_flops"], PEAK_F32_FLOPS)[0]
            peak = (f"3 TF32 products per f32 one at the TF32 peak; on the f32 CUDA cores "
                    f"{res['bound_f32_cuda_cores_ms']:.4f} ms")
        if case.get("twin"):
            res["replaced"] = twin_result(name, case["twin"], case["plain"]())
        del got
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.4e} max_rel_err "
            f"{res['max_rel_err']:.4e} ({res['tolerance']}, batch {CHECK_BATCH}) at "
            f"{tuple(BERT_SHAPE)} f32: kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {res['library_ms']:.3f} ms (SDPA "
            f"{case['backend']}) bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
            f"{peak}, {100 * res['bound_share']:.1f}% of it reached)")
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def replaced(module, attr: str, value):
    """module.attr set to `value` inside the block (a planted fault)."""
    original = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, original)


def plain_tf32(wrapper: str = "attention_tc32_bwd"):
    """attention_tc32.cu's `wrapper` (kernels.attention_tc32_bwd, the
    backwards, or kernels.attention_tc32_fwd, the forwards) launching a copy
    of the source built with CT_TC32_PASSES=1: hi hi alone, plain TF32."""
    import functools

    from ct_clip_tpu_torch.ops import kernels as K

    return functools.partial(getattr(K, wrapper),
                             lib=K.copy_library("attention_tc32.cu", CT_TC32_PASSES=1))


def tf32_copy(kern, wrapper: str = "attention_tc32_bwd"):
    """`kern` with attention_tc32.cu's `wrapper` launched from its
    plain-TF32 copy (`plain_tf32`)."""
    from ct_clip_tpu_torch.ops import kernels as K

    hi_only = plain_tf32(wrapper)

    def run():
        with replaced(K, wrapper, hi_only):
            return kern()
    return run


def tc32_checks(dev, rate: float = 0.0) -> dict:
    """K12a f32 (rate 0) or K13b f32 (rate > 0) after the 3xTF32 forward,
    on attention_tc32.cu (3xTF32) at (CHECK_BATCH, 12, n, 64)
    against the plain version in f32 (TF32 off; K13b with the same seed's
    mask): within TC32_REL_TOL of max|plain| per output at n 512 and a
    ragged n 500; dq, dk, dv and dkey_bias bit-identical across two runs;
    and the same call through a plain-TF32 copy of the kernel
    (`plain_tf32`), whose error must exceed TC32_REL_TOL: the
    tolerance tells 3xTF32 from TF32."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.attention import (attention_bwd_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    res, name = {}, "K13b f32" if rate else "K12a f32"
    for label, n, seed in (("n512", BERT_SHAPE[2], 23), ("ragged_n500", 500, 24)):
        q, k, v, kb, do = train_attention_inputs(dev, CHECK_BATCH, seed, n)
        drop_seed = torch.tensor([seed + 20261017], dtype=torch.int64, device=dev)
        leaves = [t.detach().requires_grad_() for t in (q, k, v, kb)]
        if rate:
            out = fused_attention_kbias_dropout(*leaves, drop_seed, rate)
            mask = dropout_mask(drop_seed, CHECK_BATCH, BERT_SHAPE[1], n, rate, dev)
        else:
            out, mask = fused_attention(*leaves[:3], key_bias=leaves[3]), None

        def grad():
            before = K.launch_counts()["attention_tc32_bwd"]
            g = torch.autograd.grad(out, leaves, do, retain_graph=True)
            if K.launch_counts()["attention_tc32_bwd"] != before + 1:
                raise AssertionError(f"{name} did not run on attention_tc32.cu")
            return g
        got = grad()
        ref = tuple(t for t in attention_bwd_plain(q, k, v, do, key_bias=kb, mask=mask)
                    if t is not None)
        err, rel = _rel_errors(got, ref)
        res[f"{label}_max_rel_err"] = rel
        same = all(torch.equal(a, g) for a, g in zip(grad(), got))
        res[f"{label}_bit_identical"] = same
        _, rel1 = _rel_errors(tf32_copy(grad)(), ref)
        res[f"{label}_plain_tf32_max_rel_err"] = rel1
        log(f"kernel {name} (3xTF32) at ({CHECK_BATCH}, 12, {n}, 64): max_abs_err {err:.4e} "
            f"max_rel_err {rel:.4e} (rel {TC32_REL_TOL}); dq, dk, dv, dkey_bias "
            f"bit-identical across two runs: {same}; the plain-TF32 copy max_rel_err "
            f"{rel1:.4e} (must exceed {TC32_REL_TOL})")
        if rel > TC32_REL_TOL or not same or rel1 <= TC32_REL_TOL:
            raise AssertionError(f"{name} checks failed: {res}")
        del got, ref, out, leaves, mask
    return res


# ------------------------------------------- phase 2, CT-CLIP training kernels
def _rel_errors(got, ref):
    """(max abs err, max over outputs of abs err / max|plain|)."""
    errs, rels = [], []
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        if g.shape != r.shape or not torch_finite(g):
            raise AssertionError(f"bad kernel output {tuple(g.shape)} vs {tuple(r.shape)}")
        e = (g.float() - r.float()).abs().max().item()
        errs.append(e)
        rels.append(e / max(r.float().abs().max().item(), 1e-30))
    return max(errs), max(rels)


def _mean_rel_error(got, ref) -> float:
    """mean|got - ref| / mean|ref|."""
    d = (got.float() - ref.float()).abs().mean().item()
    return d / max(ref.float().abs().mean().item(), 1e-30)


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def no_gphi_k11(fn):
    """`fn` with K11's tile launched from a copy of ffn_tc.cu built with
    CT_FF_TC_NO_GPHI=1: dg = dact a Phi(g), the g phi(g) term dropped."""
    import functools

    from ct_clip_tpu_torch.ops import kernels as K

    tile = functools.partial(K.ff_tc_tile, lib=K.copy_library("ffn_tc.cu", CT_FF_TC_NO_GPHI=1))

    def run():
        with replaced(K, "ff_tc_tile", tile):
            return fn()
    return run


def train_kernel_cases(dev):
    """The CT-CLIP training kernels at full width, batch 8 (K13 at CXR-BERT's
    batch 8 x 512): each case's kernel call through the wrapper the model
    calls (a backward is torch.autograd.grad of a kept forward), its plain
    version, a library call where one computes the same function, the
    tensors it reads and writes, its products and its tolerance."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_dropout_plain, dropout_mask,
        fused_attention_kbias_dropout)
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_bwd_plain
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_spatial_qknorm_attention,
        qknorm_attention_bwd_plain, small_qknorm_bwd_plain)
    from ct_clip_tpu_torch.ops.vq import split_hi_lo, vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(30)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd, n_tok, inner = 512, 8, 32, 256, 13824, 1365
    R = TRAIN_B * n_tok

    def grad_case(fn, leaves, do):
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    # K11: the tile and its products on ffn_tc.cu (wgmma); a copy whose dg
    # lacks g phi(g)
    x, do = rn(R, dim, dtype=bf), rn(R, dim, dtype=bf)
    w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
         rn(dim, inner, scale=inner ** -0.5))
    leaves = [t.requires_grad_() for t in (x.clone(), *w)]
    k11 = grad_case(fused_geglu_ff, leaves, do)
    yield "geglu_ff_bwd", dict(
        kern=k11, plain=lambda: geglu_ff_bwd_plain(x, *w, do), library=None,
        copies={"ffn_tc.cu with dg lacking g phi(g) (CT_FF_TC_NO_GPHI)": no_gphi_k11(k11)},
        bit_identical=True,
        inputs=(x, do, *w), outputs=(x, *w), flops=2 * R * dim * 8 * inner,
        tols=(BWD_REL_TOL,) * 5)
    del x, do, w, leaves, k11

    # K9, K10: the same weights; spatial planes with the CPB bias, the grid
    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    proj = 2 * R * dim * hd * 11
    xs, dos, cpb = rn(TRAIN_B * 24, 576, dim, dtype=bf), rn(TRAIN_B * 24, 576, dim, dtype=bf), \
        rn(heads, 576, 576)
    leaves = [t.clone().requires_grad_() for t in (xs, *w_attn, cpb)]
    k9 = grad_case(lambda *a: fused_spatial_qknorm_attention(*a, heads, dh), leaves, dos)
    yield "spatial_attention_bwd", dict(
        kern=k9, twin=replaced_qk_bwd_bf16(k9), twin_source=K9_REPLACED,
        plain=lambda: qknorm_attention_bwd_plain(xs, *w_attn, cpb, dos, heads, dh),
        library=None, inputs=(xs, dos, *w_attn, cpb), outputs=(xs, *w_attn, cpb),
        flops=proj + 12 * TRAIN_B * 24 * heads * 576 * 576 * dh, tol=BWD_REL_TOL)
    del xs, dos, cpb, leaves, k9
    yield "spatial_attention_bwd_tc", qk_core_case(dev, g, TRAIN_B * 24, 576)
    # K10 bf16: against its plain version at the TPU kernel's rounding
    # points; K9's points (the replaced path) must miss the mean tolerance
    xg, dog = rn(TRAIN_B, 24, 576, dim, dtype=bf), rn(TRAIN_B, 24, 576, dim, dtype=bf)
    leaves = [t.clone().requires_grad_() for t in (xg, *w_attn)]
    k10 = grad_case(lambda *a: fused_grid_qknorm_attention(*a, heads, dh), leaves, dog)
    yield "grid_attention_bwd", dict(
        kern=k10, plain=lambda: small_qknorm_bwd_plain(xg, *w_attn, dog, heads, dh, 8.0, True),
        check=k10_bf16_check("grid_attention_bwd"), twin=replaced_qk_bwd_bf16(k10),
        twin_source=K10_REPLACED, twin_must_miss=True, bit_identical=True,
        library=None, inputs=(xg, dog, *w_attn), outputs=(xg, *w_attn),
        flops=proj + 12 * TRAIN_B * 576 * heads * 24 * 24 * dh)
    del xg, dog, leaves, k10
    yield "grid_attention_bwd_short", short_core_bf16_case(dev, g, w_attn, TRAIN_B, 24, 576)
    del w_attn

    # K15 at the contrastive step's 110,592 rows and the autoencoder's 10,240,
    # on uniform ids (13.5 and 1.25 rows per code) and with half the rows in
    # one code (the autoencoder's own ids in phase 8)
    xv = rn(R, dim, dtype=bf)
    for label, x15 in (("vq_cluster_stats", xv), ("vq_cluster_stats_10240", xv[:10240])):
        for dist in K15_IDS[:2]:
            yield label + K15_SUFFIX[dist], k15_case(x15, k15_ids(dist, x15.shape[0], g, dev))

    # K5 exact on vq_tc.cu: ids, checked as the inference K5 (agreement,
    # near-ties), at the contrastive step's rows and the autoencoder's
    # 10,240; gemm.cu's gemm_argmax2_kernel timed beside it
    embed_n = l2norm(rn(8192, dim))
    hi, lo = split_hi_lo(embed_n)
    for label, x5 in (("vq_assign_exact", xv), ("vq_assign_exact_10240", xv[:10240])):
        yield label, dict(
            kern=lambda x5=x5: vq_assign(x5, embed_n, exact=True),
            plain=lambda x5=x5: vq_assign_plain(x5, embed_n, exact=True), library=None,
            twin=lambda x5=x5: K.gemm_argmax(x5, hi, lo),
            twin_source="gemm.cu (gemm_argmax2_kernel, WMMA)",
            yardstick=lambda x5=x5: (x5.float() @ hi.float().t()).add_(
                x5.float() @ lo.float().t()).argmax(dim=-1),
            yardstick_is="x c_hi^T + x c_lo^T in f32 (cuBLAS), then argmax",
            inputs=(x5, embed_n), outputs=(torch.empty(x5.shape[0], dtype=torch.int32,
                                                       device=dev),),
            flops=2 * 2 * x5.shape[0] * dim * 8192, ids=True)
    del xv, embed_n, hi, lo

    # K13 in bf16 at CXR-BERT's training batch (8, 12, 512, 64): K13a and
    # K13b on attention_tc.cu
    b, h, n, d = TRAIN_B, 12, 512, 64
    q, k, v = (rn(b, n, h, d, dtype=bf).transpose(1, 2) for _ in range(3))
    q = q * d ** -0.5
    lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
    kb = (1 - (torch.arange(n, device=dev)[None] < lengths[:, None]).float()) \
        * torch.finfo(f32).min
    dob = rn(b, h, n, d, dtype=bf)
    seed = torch.tensor([20261016], dtype=torch.int64, device=dev)
    mask = dropout_mask(seed, b, h, n, DROP_RATE, dev)
    sdpa_mask = kb.to(bf)[:, None, None, :]
    product = 2 * b * h * n * n * d
    yield "attention_dropout_bf16", dict(
        kern=lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE),
        plain=lambda: attention_dropout_plain(q, k, v, kb, seed, DROP_RATE),
        # the same inputs under another seed's mask: the kernel must miss it
        wrong_plain=lambda: attention_dropout_plain(q, k, v, kb, seed + 1, DROP_RATE),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                       dropout_p=DROP_RATE, scale=1.0),
        backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE),
        twin=cuda_core_twin(q, k, v, key_bias=kb, seed=seed, rate=DROP_RATE)[0],
        bit_identical=True, inputs=(q, k, v, kb, seed), outputs=(q,), flops=2 * product,
        tol=REL_TOL)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, kb)]
    out = fused_attention_kbias_dropout(*leaves, seed, DROP_RATE)
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask,
                                             dropout_p=DROP_RATE, scale=1.0)
    other = dropout_mask(seed + 1, b, h, n, DROP_RATE, dev)
    yield "attention_dropout_bwd_bf16", dict(
        kern=lambda: torch.autograd.grad(out, leaves, dob, retain_graph=True),
        plain=lambda: tuple(t for t in attention_bwd_plain(q, k, v, dob, key_bias=kb,
                                                           mask=mask) if t is not None),
        # the same inputs under another seed's mask: the kernel must miss it
        wrong_plain=lambda: tuple(t for t in attention_bwd_plain(q, k, v, dob, key_bias=kb,
                                                                 mask=other) if t is not None),
        library=lambda: torch.autograd.grad(lib_out, lib_in, dob, retain_graph=True),
        backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE),
        twin=cuda_core_twin(q, k, v, dob, key_bias=kb, seed=seed, rate=DROP_RATE)[1],
        bit_identical=True, inputs=(q, k, v, kb, seed, dob), outputs=(q, k, v, kb),
        flops=5 * product, tol=BWD_REL_TOL)


# ------------------------------------------------------------- K15's cases
# the id distributions K15 is held on: uniform over the 8,192 codes; half the
# rows (at random positions) in code 0, the rest uniform; the autoencoder's
# own ids (phase 8: its VQ's statistics in its third step, repeated to fill
# larger row counts)
K15_IDS = ("uniform", "half", "ae")
K15_SUFFIX = {"uniform": "", "half": "_half", "ae": "_ae"}


def k15_ids(dist: str, rows: int, g, dev, ae_ids=None, codes: int = 8192):
    """(rows,) int32 ids over `codes` codes in distribution `dist`
    (K15_IDS)."""
    import torch

    ids = torch.randint(0, codes, (rows,), generator=g, device=dev, dtype=torch.int32)
    if dist == "ae":
        ids = ae_ids.repeat(-(-rows // ae_ids.numel()))[:rows].contiguous()
    elif dist == "half":
        ids[torch.randperm(rows, generator=g, device=dev)[: rows // 2]] = 0
    return ids


def vq_stats_twin(x, ids, codes: int):
    """K15's (bins, embed_sum) as vq_stats.cu computes them (one warp
    walking each code's rows, the (chunk, code) counts scanned by one CTA):
    the path vq_segstats.cu replaced, launched from the package's library
    and timed and checked beside it.  The package never launches it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    rows, dim = x.shape
    i32 = dict(dtype=torch.int32, device=x.device)
    rank, perm = torch.empty((rows,), **i32), torch.empty((rows,), **i32)
    counts = torch.empty((-(-rows // 1024), codes), **i32)
    start = torch.empty((codes,), **i32)
    bins = torch.empty((codes,), dtype=torch.float32, device=x.device)
    embed_sum = torch.empty((codes, dim), dtype=torch.float32, device=x.device)
    entry = "ct_vq_cluster_stats_f32" if x.dtype == torch.float32 else "ct_vq_cluster_stats"
    args = (x, ids, rows, dim, codes, rank, counts, start, perm, bins, embed_sum)
    K._check(getattr(K.library(), entry)(
        *(K._ptr(a) if isinstance(a, torch.Tensor) else a for a in args), K._stream()), entry)
    return bins, embed_sum


def k15_case(x, ids, codes: int = 8192, full_must_miss: bool = False) -> dict:
    """K15 (`ops/vq.py::cluster_stats`, vq_segstats.cu) on the rows x and
    ids: bins exact; sums within SUM_REL_TOL of max|plain| (bf16 rows,
    `cluster_stats_plain`'s one-hot products) or within 1e-6 (f32 rows,
    `cluster_stats_segments_plain`: each normalised row as its bf16 hi + lo
    parts, added in the kernel's order -- another order of 5,120 rows in one
    code moves the sums by ~1e-6 of max; the full-f32 sums' distance
    reported, and with `full_must_miss` required to exceed the limit, which
    it does on random rows); bit-identical across two runs; vq_stats.cu's path
    (`vq_stats_twin`, the one it replaced) checked and timed
    beside it; the library call, index_add_ of the normalised rows with
    bincount.  Where a code holds more than one segment of rows, the copy of
    vq_segstats.cu whose second segment of each such code adds nothing
    (CT_VQ_SEG_DROP) must miss the limit."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import (SEG_ROWS, cluster_stats, cluster_stats_plain,
                                          cluster_stats_segments_plain)

    f32 = x.dtype == torch.float32
    tol = 1e-6 if f32 else SUM_REL_TOL
    plain = cluster_stats_segments_plain if f32 else cluster_stats_plain
    rows, dim = x.shape

    def check(got, ref):
        (bins, esum), (rbins, resum) = got, ref
        top = resum.abs().max().item()
        err = (esum - resum).abs().max().item()
        res = dict(max_abs_err=err, max_rel_err=err / top, bins_equal=torch.equal(bins, rbins),
                   fullest_code_rows=int(rbins.max()),
                   tolerance=f"bins exact; sums {tol} of max"
                   + ("; the full-f32 sums must miss" if full_must_miss else ""))
        ok = res["bins_equal"] and res["max_rel_err"] <= tol
        if f32:
            full = cluster_stats_plain(x, ids, codes)[1]
            res["full_f32_max_rel"] = (resum - full).abs().max().item() / top
            ok = ok and (res["full_f32_max_rel"] > tol or not full_must_miss)
        log(f"kernel K15 {rows} x {dim} {x.dtype}, fullest code {res['fullest_code_rows']} rows: "
            f"bins equal {res['bins_equal']}; sums {res['max_rel_err']:.2e} of max (limit {tol})"
            + (f"; the full-f32 sums {res['full_f32_max_rel']:.2e}"
               + (" (must exceed it)" if full_must_miss else "") if f32 else ""))
        return ok, res

    def library():
        esum = torch.zeros(codes, dim, device=x.device).index_add_(0, ids.long(),
                                                                   l2norm(x.float()))
        return torch.bincount(ids, minlength=codes), esum
    case = dict(kern=lambda: cluster_stats(x, ids, codes), plain=lambda: plain(x, ids, codes),
                library=library, check=check, bit_identical=True,
                twin=lambda: vq_stats_twin(x, ids, codes),
                twin_source="vq_stats.cu (a warp a code)", tols=(0.0, tol), inputs=(x, ids),
                outputs=(torch.empty(codes, device=x.device),
                         torch.empty(codes, dim, device=x.device)),
                flops=3 * rows * dim)
    if f32:
        case["peak"] = PEAK_F32_FLOPS
    if int(torch.bincount(ids, minlength=codes).max()) > SEG_ROWS:
        drop = K.copy_library("vq_segstats.cu", CT_VQ_SEG_DROP=1)

        def dropped():
            with replaced(K, "vq_cluster_stats", functools.partial(K.vq_cluster_stats, lib=drop)):
                return cluster_stats(x, ids, codes)
        case["copies"] = {"vq_segstats.cu without each crowded code's second segment "
                          "(CT_VQ_SEG_DROP)": dropped}
    return case


def k15_ae_cases(dev, x, ids):
    """K15 on the autoencoder's ids (phase 8's third step's VQ statistics): its own
    10,240 bf16 rows and ids, the same rows in f32, and the ids repeated
    over the contrastive step's 110,592 rows (bf16 and f32, random rows)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(31)
    big = torch.randn((TRAIN_B * 13824, x.shape[1]), generator=g, device=dev)
    for label, x15 in (("vq_cluster_stats_10240_ae", x),
                       ("vq_cluster_stats_ae", big.to(torch.bfloat16)),
                       ("vq_cluster_stats_f32_10240_ae", x.float()),
                       ("vq_cluster_stats_f32_ae", big)):
        yield label, k15_case(x15, k15_ids("ae", x15.shape[0], g, dev, ids))


def nest_k15(results: dict, key: str) -> None:
    """K15's other cases under `key`'s entry ("vq_cluster_stats" or
    "vq_cluster_stats_f32"): each `key`_rest popped into results[key] as
    "at_"rest (at_half, at_10240, at_ae, ...); the f32 ones stay apart."""
    for name in [n for n in results if n.startswith(key + "_")
                 and not n.startswith(key + "_f32")]:
        results[key][f"at_{name[len(key) + 1:]}"] = results.pop(name)


# ------------------------------------------------ the PEG stencil, K14
# The bf16 forward and dx round where JAX's grouped convs do (the conv's f32
# sum, + x or + dout, + bias): the kernel sums the 27 exact products in the
# plain version's order, so a reading other than 0 is a rounding one bf16 ulp
# apart.  mean|err| <= PEG_MEAN_TOL * mean|plain|, which the single rounding
# of xla_peg_conv's point (x, taps and bias summed in f32, rounded once: a
# planted copy) must miss; the max alone cannot tell the two points apart.
# (CPU: 0 against lax_peg_conv, the single rounding 2.2e-3-2.4e-3 of mean;
# tests/test_torch_port_peg_stencil.py.)
PEG_MEAN_TOL = 5e-4
# label -> (B, T, H, W), rotated, causal, the directions timed: every shape
# and geometry a path runs the stencil at (C 512; the tiny steps' 64): the
# contrastive step's spatial (frame-causal) and temporal (rotated) stages,
# zero-shot's batch of 2, CT-CLIP at 160 frames (its temporal stage reads the
# reinterpreted (b, h, w, t) memory as the same dims), the autoencoder's
# (20, 8, 8) grid and MaskGIT's non-causal PEG on it, the tiny steps' grid
PEG_CASES = {
    "ctclip": ((TRAIN_B, 24, 24, 24), False, True, "fb"),
    "ctclip_rotated": ((TRAIN_B, 24, 24, 24), True, True, "fb"),
    "zero_shot": ((B, 24, 24, 24), False, True, "f"),
    "zero_shot_rotated": ((B, 24, 24, 24), True, True, "f"),
    "frames_160": ((8, 16, 24, 24), False, True, "fb"),
    "autoencoder": ((8, 20, 8, 8), False, True, "fb"),
    "maskgit": ((8, 20, 8, 8), False, False, "fb"),
    "tiny": ((4, 3, 3, 3), True, True, "fb"),
}


def _depthwise(x, w, pad):
    """Depthwise conv of the channels-last (b, t, h, w, c) x with the Conv3d
    weight w (c, 1, kt, kh, kw), padded by the F.pad list `pad`: cuDNN's
    grouped conv, the PEG stencil's library yardstick (the port calls it
    nowhere); channels-last out."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)
    return F.conv3d(F.pad(xc, pad), w, groups=x.shape[-1]).permute(0, 2, 3, 4, 1)


def cudnn_peg(x, do, weight, bias, rotated: bool, causal: bool):
    """(forward, backward): cuDNN's calls computing the PEG forward (x + conv
    + bias) and its backward (dx: the flipped kernel, pads complemented, +
    dout; dW and db: `convolution_backward`) on the channels-last x and dout,
    as the port ran them before the stencil (`_depthwise`)."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import _peg_geometry

    w, pad = _peg_geometry(weight.to(x.dtype), rotated, causal)
    c = x.shape[-1]

    def fwd():
        return _depthwise(x, w, pad) + x + bias.to(x.dtype)

    def bwd():
        dx = _depthwise(do, w.flip(2, 3, 4), [2 - p for p in pad]) + do
        xc = F.pad(x.permute(0, 4, 1, 2, 3), pad)
        return (dx, *torch.ops.aten.convolution_backward(
            do.permute(0, 4, 1, 2, 3), xc, w, [c], [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
            [0, 0, 0], c, [False, True, True])[1:])
    return fwd, bwd


def peg_one_rounding(x, taps, bias, pads):
    """The PEG forward at xla_peg_conv's point (a planted copy): from x, the
    27 bf16 taps' products and the f32 bias summed in f32, rounded once."""
    from ct_clip_tpu_torch.ops.attention import _peg_shifts

    s = x.float()
    for j, win in enumerate(_peg_shifts(x, pads)):
        s = s + win * taps[j]
    return (s + bias.float()).to(x.dtype)


def peg_check(bf16: bool, bwd: bool, planted=None):
    """A PEG case's check: bf16 forward and dx within REL_TOL of max|plain|
    and PEG_MEAN_TOL of mean|plain| (the planted single rounding must miss
    the mean), f32 within 1e-5 of max; dW and db within SUM_REL_TOL (bf16)
    or 1e-4 (f32)."""
    def check(got, ref):
        rel = _rel_errors(got[:1], ref[:1])[1]
        res = dict(max_abs_err=_rel_errors(got, ref)[0], max_rel_err=rel,
                   mean_rel_err=_mean_rel_error(got[0], ref[0]),
                   tolerance=(f"{'dx' if bwd else 'out'} rel {REL_TOL}, mean {PEG_MEAN_TOL}"
                              if bf16 else f"{'dx' if bwd else 'out'} rel 1e-5"))
        ok = rel <= (REL_TOL if bf16 else 1e-5)
        if bf16:
            ok = ok and res["mean_rel_err"] <= PEG_MEAN_TOL
        if bwd:
            res["dwb_rel_err"] = _rel_errors(got[1:], ref[1:])[1]
            res["tolerance"] += f"; dW, db rel {SUM_REL_TOL if bf16 else 1e-4}"
            ok = ok and res["dwb_rel_err"] <= (SUM_REL_TOL if bf16 else 1e-4)
        if planted is not None:
            res["one_rounding_mean_rel_err"] = _mean_rel_error(planted(), ref[0])
            log(f"PEG forward: xla_peg_conv's single rounding (planted) reads mean "
                f"{res['one_rounding_mean_rel_err']:.3e} of mean|plain| (must exceed "
                f"{PEG_MEAN_TOL})")
            ok = ok and res["one_rounding_mean_rel_err"] > PEG_MEAN_TOL
        return ok, res
    return check


def peg_kernel_cases(dev, dtype):
    """The PEG stencil (csrc/peg_stencil.cu) at every PEG_CASES shape in
    `dtype`: the forward (`ops/attention.py::peg_fwd`) and K14 whole, dx, dW
    and db (`peg_bwd`), each through the function `peg_conv` calls, against
    its plain versions and cuDNN: the forward's library is `_depthwise(x) + x +
    bias`, K14's cuDNN's dx (`_depthwise` of dout with the flipped kernel and
    complemented pads, + dout) and its weight and bias gradient
    (`convolution_backward`), as the parent's path ran them."""
    import torch

    from ct_clip_tpu_torch.ops.attention import (_peg_leads, _peg_taps, peg_bwd, peg_dw_plain,
                                                 peg_dx_plain, peg_fwd, peg_fwd_plain)

    g = torch.Generator(device=dev).manual_seed(32)
    bf = dtype == torch.bfloat16
    for label, (dims, rotated, causal, dirs) in PEG_CASES.items():
        dim = 64 if label == "tiny" else 512
        x, do = (torch.randn((*dims, dim), generator=g, device=dev).to(dtype) for _ in range(2))
        weight = torch.randn((dim, 1, 3, 3, 3), generator=g, device=dev) * 0.2
        bias = torch.randn(dim, generator=g, device=dev) * 0.1
        taps, pads = _peg_taps(weight, rotated, dtype), _peg_leads(rotated, causal)
        cudnn_fwd, cudnn_bwd = cudnn_peg(x, do, weight, bias, rotated, causal)
        dwb = torch.empty((28, dim), device=dev)
        yield ("fwd", label), dict(
            kern=lambda: peg_fwd(x, weight, bias, rotated, causal),
            plain=lambda: peg_fwd_plain(x, taps, bias, pads),
            library=cudnn_fwd,
            check=peg_check(bf, False, (lambda: peg_one_rounding(x, taps, bias, pads))
                            if bf and label == "ctclip" else None),
            bit_identical=True, inputs=(x, weight, bias), outputs=(x,),
            flops=2 * 27 * x.numel(), peak=PEAK_F32_FLOPS)
        if "b" in dirs:
            yield ("bwd", label), dict(
                kern=lambda: peg_bwd(x, do, weight, rotated, causal),
                plain=lambda: (peg_dx_plain(do, taps, pads), peg_dw_plain(x, do, pads)),
                library=cudnn_bwd, check=peg_check(bf, True), bit_identical=True,
                inputs=(x, do, weight), outputs=(x, dwb), flops=2 * 54 * x.numel(),
                peak=PEAK_F32_FLOPS)
        del x, do


def peg_phase(dev) -> dict:
    """The PEG stencil's cases in bf16 and f32 (`peg_kernel_cases`, checked
    and timed by `train_kernel_phase`): the contrastive step's frame-causal
    shape as the rows peg_fwd, peg_bwd (K14), peg_fwd_f32 and peg_bwd_f32,
    every other shape nested in its row as at_<label>."""
    import torch

    out = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        cases = ((f"peg_{d}{suffix}:{label}", case)
                 for (d, label), case in peg_kernel_cases(dev, dtype))
        for key, res in train_kernel_phase(dev, cases, TRAIN_B).items():
            row, label = key.split(":")
            dims = PEG_CASES[label][0]
            res.update(batch=dims[0], shape=[*dims, 64 if label == "tiny" else 512])
            if label == "ctclip":
                out.setdefault(row, {}).update(res)
            else:
                out.setdefault(row, {})[f"at_{label}"] = res
    return out


def train_kernel_phase(dev, cases=None, batch: int = TRAIN_B) -> dict:
    import torch

    results = {}
    for name, case in cases if cases is not None else train_kernel_cases(dev):
        got, ref = _as_tuple(case["kern"]()), _as_tuple(case["plain"]())
        torch.cuda.synchronize()
        if case.get("ids"):
            x, embed_n = case["inputs"]
            from ct_clip_tpu_torch.ops.vq import split_hi_lo

            if case.get("sim"):  # the similarities of the kernel's own math
                sims = [case["sim"]()]
            else:
                hi, lo = split_hi_lo(embed_n)
                sims = [x.float() @ hi.float().t() + x.float() @ lo.float().t()]
            gi, ri = got[0].long(), ref[0].long()
            gap = (sims[0].gather(1, ri[:, None]) - sims[0].gather(1, gi[:, None])).abs()[:, 0]
            agree = (gi == ri).float().mean().item()
            margin = sims[0].abs().max(dim=1).values
            ok = agree >= 0.999 and bool((gap <= 1e-5 * margin).all())
            res = dict(max_abs_err=gap.max().item(), max_rel_err=None, id_agreement=agree,
                       max_gap_of_row_max=(gap / margin).max().item(),
                       tolerance=">= 0.999 ids equal, the rest ties within 1e-5")
            log(f"kernel {name}: ids equal {agree:.6f}, largest gap {gap.max().item():.3e} = "
                f"{res['max_gap_of_row_max']:.3e} of its row's largest |sim| (limit 1e-5)")
            if case.get("f32_plain"):  # the share equal to the full-f32 plain version
                res["id_agreement_full_f32"] = (gi == case["f32_plain"]().long()).float() \
                    .mean().item()
                log(f"kernel {name}: ids equal to the full-f32 plain version's "
                    f"{res['id_agreement_full_f32']:.6f} (reported)")
            del sims
        elif case.get("exact"):  # a move: bit for bit
            err, rel = _rel_errors(got, ref)
            ok = all(torch.equal(g, r) for g, r in zip(got, ref))
            res = dict(max_abs_err=err, max_rel_err=rel, tolerance="bit-exact")
        elif case.get("check"):  # a check the case states itself
            ok, res = case["check"](got, ref)
        elif case.get("tols"):  # one tolerance per output
            rels = [_rel_errors((g,), (r,))[1] for g, r in zip(got, ref)]
            err = _rel_errors(got, ref)[0]
            ok = all(r <= t for r, t in zip(rels, case["tols"]))
            res = dict(max_abs_err=err, max_rel_err=max(rels), rel_err_by_output=rels,
                       tolerance=f"rel {case['tols']} by output")
        else:
            err, rel = _rel_errors(got, ref)
            ok = rel <= case["tol"]
            res = dict(max_abs_err=err, max_rel_err=rel, tolerance=f"rel {case['tol']}")
        if not ok:
            raise AssertionError(f"{name}: outside tolerance: {res}")
        if case.get("bit_identical"):  # no atomics: a second run equals the first
            res["bit_identical"] = all(torch.equal(a, g) for a, g in
                                       zip(_as_tuple(case["kern"]()), got))
            log(f"kernel {name}: outputs bit-identical across two runs: {res['bit_identical']}")
            if not res["bit_identical"]:
                raise AssertionError(f"{name}: a second run differs from the first")
        if case.get("wrong_plain"):  # another seed's mask must miss the tolerance
            res["wrong_seed_max_rel_err"] = _rel_errors(got, _as_tuple(case["wrong_plain"]()))[1]
            log(f"kernel {name}: against the plain version with another seed's mask "
                f"max_rel_err {res['wrong_seed_max_rel_err']:.4e} (must exceed {case['tol']})")
            if res["wrong_seed_max_rel_err"] <= case["tol"]:
                raise AssertionError(f"{name}: another seed's mask reads within tolerance")
        if case.get("twin") and case.get("ids"):
            res["replaced"] = ids_twin_result(name, case["twin"], ref[0], case["twin_source"])
        elif case.get("twin"):
            res["replaced"] = twin_result(name, case["twin"], ref,
                                          case.get("twin_source", "attention_train.cu"))
        if case.get("twin_must_miss"):  # K10 bf16: K9's rounding points miss the mean
            k10_points_miss(name, res, case["twin"], ref)
        yardstick(case, res, name)
        for label, copy in case.get("copies", {}).items():  # one-change copies must miss
            crels = [_rel_errors((c,), (r,))[1] for c, r in zip(_as_tuple(copy()), ref)]
            res.setdefault("copies_rel_err_by_output", {})[label] = crels
            missed = any(r > t for r, t in zip(crels, case["tols"]))
            log(f"kernel {name}: the one-change copy ({label}) reads max_rel_err by "
                f"output {[f'{r:.2e}' for r in crels]}, limits {case['tols']}: outside {missed}")
            if not missed:
                raise AssertionError(f"{name}: the copy ({label}) is within the limits")
        del got, ref
        torch.cuda.empty_cache()
        res.update(timing(case, case["outputs"]), batch=batch)
        if case.get("bound_tf32_ms"):  # an f32 form's bound were it in 3xTF32
            res["bound_3xtf32_ms"] = case["bound_tf32_ms"]
        if case.get("f32_flops"):  # 3xTF32: the f32 CUDA-core bound beside the TF32 one
            res["bound_f32_cuda_cores_ms"] = bound(nbytes(*case["inputs"], *case["outputs"]),
                                                   case["f32_flops"], PEAK_F32_FLOPS)[0]
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
        if case.get("backend"):
            res["library_backend"] = case["backend"]
            lib += f" (SDPA {case['backend']})"
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.4e} max_rel_err "
            f"{res['max_rel_err'] if res['max_rel_err'] is None else round(res['max_rel_err'], 6)} "
            f"({res['tolerance']}) batch {batch}: kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {lib} bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, {100 * res['bound_share']:.1f}% of it reached)")
        results[name] = res
        torch.cuda.empty_cache()
    return results


# --------------------------------------------- phase 7, the embed backwards
def embed_bwd_cases(dev):
    """K16a, K16b and K17 at full width, batch AUX_B, as the training step's
    SSL views and a gradient into the input reach them: each kernel through
    the wrapper the model calls (a backward is torch.autograd.grad of a kept
    forward: K16a into the six weights, K16b also into the rows), its plain
    version (autograd of the plain forward, into the same tensors), the
    library call where one computes the same function (K17: the inverse
    permutation's .contiguous()), the tensors it reads and writes and its
    products (K16: the recomputed forward product, dW and dX, 2 x 4000 x 512
    multiply-adds per row each)."""
    import torch

    from ct_clip_tpu_torch.ops.patch_embed import (
        fused_patch_embed, fused_row_embed, patch_embed_plain, rearrange_plain,
        row_embed_plain, unrearrange_patches, unrearrange_plain)

    g = torch.Generator(device=dev).manual_seed(40)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, pd, n_tok = 512, 4000, 13824
    flops = 3 * 2 * AUX_B * n_tok * pd * dim
    video = (torch.rand((AUX_B, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(bf)
    pe = [1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1)]
    do = rn(AUX_B, n_tok, dim, dtype=bf)

    def plain_grads(fn, tensors):
        leaves = [t.detach().requires_grad_() for t in tensors]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    leaves = [t.clone().requires_grad_() for t in pe]
    out = fused_patch_embed(video, *leaves, 10, 20)
    k16a = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    yield "patch_embed_bwd", dict(
        kern=k16a, plain=lambda: plain_grads(lambda *w: patch_embed_plain(video, *w, 10, 20), pe),
        copies={"ffn_tc.cu with the epilogue's xhat lacking rstd (CT_FF_TC_LN_NO_RSTD)":
                no_rstd_ln_sums(k16a)},
        twin=lambda: k16a_replaced(video, pe, do), twin_source="layernorm.cu and gemm.cu",
        bit_identical=True, library=None, inputs=(video, do, *pe), outputs=tuple(pe),
        flops=flops, tols=(BWD_REL_TOL,) * 6)
    del out, leaves, k16a
    # with d(volume): dxn stored, the LN(4000) backward through the gather and K17
    leaves = [t.clone().requires_grad_() for t in (video, *pe)]
    out = fused_patch_embed(*leaves[:1], *leaves[1:], 10, 20)
    yield "patch_embed_bwd_dvideo", dict(
        kern=lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        plain=lambda: plain_grads(lambda *a: patch_embed_plain(a[0], *a[1:], 10, 20),
                                  (video, *pe)),
        library=None, inputs=(video, do, *pe), outputs=(video, *pe), flops=flops,
        tol=BWD_REL_TOL)
    del out, leaves
    rows = rearrange_plain(video, 10, 20)
    # K16b with d(rows) (the embed_grad path): dxn stored, the LN(4000) row
    # backward; then into the weights alone, the LN(4000) sums in the dxn
    # product's epilogue, and a copy whose epilogue drops rstd
    leaves = [t.clone().requires_grad_() for t in (rows, *pe)]
    out = fused_row_embed(*leaves)
    yield "row_embed_bwd", dict(
        kern=lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        plain=lambda: plain_grads(row_embed_plain, (rows, *pe)), library=None,
        twin=lambda: k16b_replaced(rows, pe, do, True), twin_source=K16B_REPLACED,
        bit_identical=True, inputs=(rows, do, *pe), outputs=(rows, *pe), flops=flops,
        tol=BWD_REL_TOL)
    del out, leaves
    leaves = [t.clone().requires_grad_() for t in pe]
    out = fused_row_embed(rows, *leaves)
    k16b = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    yield "row_embed_bwd_weights", dict(
        kern=k16b, plain=lambda: plain_grads(lambda *w: row_embed_plain(rows, *w), pe),
        copies={"ffn_tc.cu with the epilogue's xhat lacking rstd (CT_FF_TC_LN_NO_RSTD)":
                no_rstd_ln_sums(k16b, "ln_sums_rows_tc")},
        twin=lambda: k16b_replaced(rows, pe, do, False), twin_source=K16B_REPLACED,
        bit_identical=True, library=None, inputs=(rows, do, *pe), outputs=tuple(pe),
        flops=flops, tols=(BWD_REL_TOL,) * 6)
    del out, leaves, k16b
    yield "unrearrange_patches", dict(
        kern=lambda: unrearrange_patches(rows, 10, 20, 240, 480, 480),
        plain=lambda: unrearrange_plain(rows, 10, 20, 240, 480, 480),
        library=lambda: rows.reshape(AUX_B, 24, 24, 24, 10, 20, 20)
        .permute(0, 1, 4, 2, 5, 3, 6).contiguous(),
        inputs=(rows,), outputs=(video,), flops=0, exact=True)


def embed_tail_replaced(xn, w, pbias, s2, dout, eps):
    """The backward of the embed's product, bias and LN(dim) from the
    normalised rows xn (R, pd) as the port ran it for K16a and K16b before
    ffn_tc.cu's forms, on gemm.cu's WMMA: the product and its rounded
    bias add again, the LN(dim) backward (dyb, ds2, db2 and dpb, the column
    sum of the f32 dyb), dW = dyb^T xn (split TN product) and dxn = dyb W
    (NN product), f32."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    bf = torch.bfloat16
    R, pd = xn.shape
    dim = w.shape[0]
    wb = w.to(bf).contiguous()
    yb = torch.empty((R, dim), dtype=bf, device=xn.device)
    K.gemm(K.EPI_BIAS_ROUNDED, xn, wb, yb, bias=pbias.to(bf).contiguous())
    dyn = dout.reshape(R, dim).float().contiguous()
    dyb, ds2, db2, dpb = K.layernorm_bwd(yb, s2, dyn, eps, want_dbias=True, want_dxsum=True)
    del yb
    dw = K.gemm_tn(dyb, xn)
    dxn = torch.empty((R, pd), dtype=torch.float32, device=xn.device)
    K.gemm_nn(dyb, wb, dxn)
    return dxn, dw, dpb, ds2, db2


K16B_REPLACED = "layernorm.cu and gemm.cu (LN(4000), WMMA products, dxn stored, LN backwards)"


def k16b_replaced(rows, pe, do, want_drows: bool, eps: float = 1e-5):
    """K16b's gradients (d(rows) first with `want_drows`) as the port ran
    them before ffn_tc.cu's forms: layernorm.cu's LN(4000) writing xn,
    `embed_tail_replaced`, the LN(4000) row backward over the stored dxn --
    the path it replaced, timed beside it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    s1, b1, w, pbias, s2, _ = pe
    x = rows.reshape(-1, rows.shape[-1])
    xn = torch.empty_like(x)
    K.layernorm(x, s1, b1, eps, xn)
    dxn, dw, dpb, ds2, db2 = embed_tail_replaced(xn, w, pbias, s2, do, eps)
    del xn
    drows, ds1, db1 = K.layernorm_bwd(x, s1, dxn, eps, want_dbias=True, want_dx=want_drows)
    return ((drows.view(rows.shape),) if want_drows else ()) + (ds1, db1, dw, dpb, ds2, db2)


def k16a_replaced(video, pe, do, eps: float = 1e-5):
    """K16a's six weight gradients as the port ran them before ffn_tc.cu:
    the patch LN, gemm.cu's WMMA recompute, TN and NN products (dxn stored
    in f32) and the LN(4000) backward through the patch gather
    (ln_bwd_kernel<true>) -- the path it replaced, timed beside it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    s1, b1, w, pbias, s2, _ = pe
    b, F, H, W = video.shape
    xn = torch.empty((b * (F // 10) * (H // 20) * (W // 20), w.shape[1]), dtype=torch.bfloat16,
                     device=video.device)
    K.patch_layernorm(video, 10, 20, s1, b1, eps, xn)
    dxn, dw, dpb, ds2, db2 = embed_tail_replaced(xn, w, pbias, s2, do, eps)
    del xn
    _, ds1, db1 = K.patch_layernorm_bwd(video, 10, 20, s1, dxn, eps)
    return ds1, db1, dw, dpb, ds2, db2


def no_rstd_ln_sums(fn, wrapper: str = "ln_sums_tc"):
    """`fn` with K16a's (`ln_sums_tc`) or K16b's (`ln_sums_rows_tc`) LN sums
    launched from a copy of ffn_tc.cu built with CT_FF_TC_LN_NO_RSTD=1: the
    epilogue's xhat = x - mean, rstd dropped."""
    from ct_clip_tpu_torch.ops import kernels as K

    sums = functools.partial(getattr(K, wrapper),
                             lib=K.copy_library("ffn_tc.cu", CT_FF_TC_LN_NO_RSTD=1))

    def run():
        with replaced(K, wrapper, sums):
            return fn()
    return run


# ---------------------------------------------------------------- phase 3
def write_corpus(root: Path, shapes, spacing_xy: float, spacing_z: float):
    from ct_clip_tpu_torch.config import PATHOLOGIES
    from ct_clip_tpu_torch.data import write_volume
    from ct_clip_tpu_torch.data.tokenizer import WordPieceTokenizer
    from ct_clip_tpu_torch.inference import pathology_prompts

    rng = np.random.RandomState(0)
    names = []
    for i, shape in enumerate(shapes):
        name = f"valid_{i}_a_1.nii.gz"
        folder = root / "data" / f"valid_{i}" / f"valid_{i}_a"
        folder.mkdir(parents=True)
        vol = rng.randint(0, 2000, shape).astype(np.int16)  # (x, y, z) stored ints
        write_volume(folder / name, vol, (spacing_xy, spacing_xy, spacing_z))
        names.append(name)
    rows = {
        "reports.csv": (["VolumeName", "Findings_EN", "Impressions_EN"],
                        [{"VolumeName": n, "Findings_EN": "No acute findings.",
                          "Impressions_EN": ""} for n in names]),
        "meta.csv": (["VolumeName", "XYSpacing", "ZSpacing", "RescaleSlope",
                      "RescaleIntercept"],
                     [{"VolumeName": n, "XYSpacing": f"[{spacing_xy}, {spacing_xy}]",
                       "ZSpacing": str(spacing_z), "RescaleSlope": "1",
                       "RescaleIntercept": "-1024"} for n in names]),
        "labels.csv": (["VolumeName"] + list(PATHOLOGIES),
                       [dict(VolumeName=n, **{p: int(rng.rand() < 0.3)
                                              for p in PATHOLOGIES}) for n in names]),
    }
    for fname, (fields, data) in rows.items():
        with open(root / fname, "w", newline="") as f:
            w = csv.DictWriter(f, fields)
            w.writeheader()
            w.writerows(data)
    basic = WordPieceTokenizer({"[UNK]": 0})._basic_tokenize
    words = sorted({w for p in pathology_prompts() for w in basic(p)})
    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    return [str(root / x) for x in ("data", "reports.csv", "meta.csv", "labels.csv")]


def drive(name: str, fn):
    """Run one path with every launch counter set to 0 just before it, read
    the counters just after, and require that the path's kernels ran."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"e2e {name}: {secs:.2f} s (host clock); launch counts {counts}")
    missing = [k for k in PATHS[name] if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    return out, counts, secs


def check_predictions(name: str, out, results: Path):
    pred = out["predicted"]
    if pred.shape != (3, 18) or not np.isfinite(pred).all() \
            or pred.min() < 0 or pred.max() > 1:
        raise AssertionError(f"{name}: bad predictions {pred.shape} {pred}")
    for fname in ("predicted_weights.npz", "labels_weights.npz", "accessions.txt",
                  "aurocs.csv"):
        if not (results / fname).exists():
            raise AssertionError(f"{name}: missing artifact {fname}")


def end_to_end_phase(dev, work: Path, card: str):
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig
    from ct_clip_tpu_torch.data import CTReportDatasetInfer, WordPieceTokenizer
    from ct_clip_tpu_torch.inference import (ZeroShotClassifier, export_latents,
                                             run_zero_shot)
    from ct_clip_tpu_torch.models import CTCLIP

    # 256 x 256 x 60 at 1.5 x 1.5 x 6 mm resamples to 240 x 512 x 512 and
    # crops to the 240 x 480 x 480 model grid
    paths = write_corpus(work, [(256, 256, 60)] * 3, 1.5, 6.0)
    tok = WordPieceTokenizer(str(work / "vocab.txt"))
    ds = CTReportDatasetInfer(*paths)
    t0 = time.perf_counter()
    model = CTCLIP(CTCLIPConfig(), dtype=torch.bfloat16, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"e2e: full-width CT-CLIP built ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) in {time.perf_counter() - t0:.1f} s")

    counts, outs = {}, {}
    for name, rows in (("zero_shot_rows", None), ("zero_shot_volume", False)):
        results = work / name
        outs[name], counts[name], secs = drive(name, lambda: run_zero_shot(
            model, tok, ds, str(results), batch_size=B, num_workers=2,
            patch_rows=rows))
        check_predictions(name, outs[name], results)
        # the prompt latents: 36 prompts through the 12 BERT layers, once
        if counts[name]["attention_tc"] != 12 or counts[name]["fused_attention"] != 12:
            raise AssertionError(f"{name}: prompt attention launches "
                                 f"{counts[name]['attention_tc']} on the tensor cores of "
                                 f"{counts[name]['fused_attention']}, want 12 of 12")
        log(f"e2e {name}: run_zero_shot scored 3 volumes = {3 / secs:.3f} volumes/s "
            f"(prompt encoding and NIfTI decode included) on {card}")
    # the rows route is the default on CUDA, and each route skips the other's embed
    if counts["zero_shot_rows"]["patch_embed"] or counts["zero_shot_volume"]["row_embed"] \
            or counts["zero_shot_volume"]["rearrange_patches"]:
        raise AssertionError("a zero-shot route ran the other route's embed")
    # every embed on embed_tc.cu, no gemm.cu product
    for name in ("zero_shot_rows", "zero_shot_volume"):
        c = counts[name]
        if c["qk_proj_gemm"] or c["embed_tc"] != c["row_embed"] + c["patch_embed"]:
            raise AssertionError(f"{name}: embeds {c['row_embed'] + c['patch_embed']}, on "
                                 f"embed_tc.cu {c['embed_tc']}; gemm.cu launches "
                                 f"{c['qk_proj_gemm']}")
    route_diff = float(np.abs(outs["zero_shot_rows"]["predicted"]
                              - outs["zero_shot_volume"]["predicted"]).max())
    log(f"e2e: P(present) rows route vs volume route max abs diff {route_diff:.4e} "
        f"(tol {ROUTE_TOL})")
    if route_diff > ROUTE_TOL:
        raise AssertionError(f"the zero-shot routes disagree: {route_diff}")

    # export-latents, the second serving entry point, on one volume
    one = write_corpus(work / "one", [(256, 256, 60)], 1.5, 6.0)
    lat, counts["export_latents"], _ = drive("export_latents", lambda: export_latents(
        model, tok, CTReportDatasetInfer(*one), str(work / "latents"), num_workers=1))
    vcfg = model.config.ctvit
    grid = (vcfg.patch_t, vcfg.patch_hw, vcfg.patch_hw, vcfg.dim)
    for kind, shape in (("image", grid), ("text", (model.config.dim_latent,))):
        files = sorted((work / "latents" / f"{kind}_latents").glob("*.npz"))
        arrs = [np.load(f)["arr"] for f in files]
        if len(arrs) != 1 or arrs[0].shape != shape or not np.isfinite(arrs[0]).all():
            raise AssertionError(f"export_latents: bad {kind} latents "
                                 f"{[a.shape for a in arrs]}")
    log(f"e2e export_latents: image {grid} and text ({model.config.dim_latent},) "
        "latents finite")

    # steady-state device time of one scored batch (embed + encode + scoring)
    clf = ZeroShotClassifier(model, tok)
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = {"zero_shot_rows": (B, vcfg.patch_t * vcfg.patch_hw ** 2, vcfg.patch_dim),
              "zero_shot_volume": (B, vcfg.num_frames, vcfg.image_size,
                                   vcfg.image_size, 1)}
    inputs = {name: torch.rand(shape, generator=g, device=dev) * 2 - 1
              for name, shape in shapes.items()}
    batch_ms = {}

    def prompt_latents():  # the set-up once per weight load: 36 prompts, 12 layers
        clf._prompt_latents = None
        return clf.prompt_latents()
    with torch.inference_mode():
        batch_ms["prompt_latents"] = cuda_ms(prompt_latents, reps=5)
        log(f"e2e zero-shot set-up: prompt latents (36 prompts x 512 tokens, CXR-BERT, tokenizer "
            f"included) {batch_ms['prompt_latents']:.2f} ms on {card}")
        for name, x in inputs.items():
            x = x.to(torch.bfloat16)
            batch_ms[name] = cuda_ms(lambda: clf.score_batch(x), reps=5)
            log(f"e2e {name}: score_batch({B}) {batch_ms[name]:.2f} ms = "
                f"{B / batch_ms[name] * 1e3:.2f} volumes/s device-side on {card}")
            if name == "zero_shot_rows":
                profile = profile_step(lambda: clf.score_batch(x), CTCLIP_GROUPS,
                                       "zero-shot score_batch (rows)")
                no_cudnn("zero-shot score_batch", profile)
            del x
    return counts, route_diff, batch_ms, profile


# ---------------------------------------------------------------- phase 4
def report_words():
    """The words of the synthetic reports: the pathology names' words, a few
    report words and 1,000 generated terms."""
    from ct_clip_tpu_torch.config import PATHOLOGIES

    words = {w.lower() for p in PATHOLOGIES for w in p.split()}
    words |= {"no", "the", "is", "seen", "present", "not", "of", "with", "and", "mild",
              "lung", "right", "left", "lobe", "chest", "ct"}
    return sorted(words) + [f"term{i:04d}" for i in range(1000)]


def write_reports(path: Path, n: int, seed: int) -> str:
    """n synthetic reports of 20-600 words (some beyond the 512-token
    truncation) with random 0/1 labels in the 18 pathology columns."""
    from ct_clip_tpu_torch.config import PATHOLOGIES

    rng = np.random.RandomState(seed)
    words = report_words()
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["report"] + list(PATHOLOGIES))
        w.writeheader()
        for _ in range(n):
            text = " ".join(rng.choice(words, rng.randint(20, 600)))
            text = ". ".join(text[i:i + 80] for i in range(0, len(text), 80)) + "."
            w.writerow({"report": text, **{p: int(rng.rand() < 0.3) for p in PATHOLOGIES}})
    return str(path)


def write_vocab(path: Path, size: int = 30522) -> str:
    """A generated WordPiece vocab of CXR-BERT's size: the special tokens,
    the report words, '.', and filler entries."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + report_words()
    words += [f"[unused{i}]" for i in range(size - len(words))]
    path.write_text("\n".join(words) + "\n")
    return str(path)


# kernel-name fragments of the groups a training step's device time is read
# in; attention_tc.cu's bf16 forward and backward on the tensor cores first
TC_BWD_GROUP = ("K12a / K12b / K13b bf16 backward on the tensor cores (attention_tc.cu)",
                ("attn_tc_rows", "attn_tc_cols", "attn_tc_dkb", "attn_tc_dbias"))
TC_FWD_GROUP = ("K7 / K13a bf16 forward on the tensor cores (attention_tc.cu)",
                ("attn_tc_forward",))
TC32_GROUP = ("K12a / K12b / K13b f32 backward, 3xTF32 on the tensor cores (attention_tc32.cu)",
              ("tc32_rows", "tc32_cols", "tc32_dkb", "tc32_dbias"))
TC32_FWD_GROUP = ("K7 / K13a f32 forward, 3xTF32 on the tensor cores (attention_tc32.cu)",
                  ("tc32_fwd",))
STEP_GROUPS = (
    TC_BWD_GROUP,
    TC_FWD_GROUP,
    TC32_GROUP,
    TC32_FWD_GROUP,
    ("K13/K12 backward (attention_train.cu)", ("bwd_dq_kernel<", "bwd_dkv_kernel<",
                                               "rowdot_kernel<", "dkb_sum_kernel")),
    ("K13/K7 forward (attention_train.cu)", ("::fwd_kernel<",)),
    ("f32 matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas")),
    ("AdamW (multi-tensor)", ("multi_tensor", "foreach")),
)
STEP_OTHER = "other (LayerNorm, GELU, dropout, elementwise, embedding)"


def device_busy_ms(prof):
    """(busy, span) ms of a profile: the union of its device events' [start,
    end) intervals (kernels that overlap, as cuDNN's per-group convolutions
    do, count once), and first start to last end."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("profile: no device events recorded")
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    return busy / 1e3, (max(e for _, e in spans) - spans[0][0]) / 1e3


def profile_step(step, groups_spec=STEP_GROUPS, label: str = "radbert") -> dict:
    """Device time of one step by kernel (torch.profiler over a synchronised
    step, after a warm-up), grouped by `groups_spec` (kernel-name fragments,
    first match wins: summed kernel times, which count overlapping kernels
    each), and the idle share of the step's host-clock time: 1 - the union
    of the device intervals over it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    summed = sum(ms for _, ms, _ in kernels)
    busy, span = device_busy_ms(prof)
    groups = {name: 0.0 for name, _ in groups_spec}
    groups[STEP_OTHER] = 0.0
    for key, ms, _ in kernels:
        low = key.lower()
        group = next((g for g, frags in groups_spec if any(f in low for f in frags)),
                     STEP_OTHER)
        groups[group] += ms
    idle = 1 - busy / wall_ms
    log(f"{label} step profile: device busy (union of intervals) {busy:.2f} ms of "
        f"{wall_ms:.2f} ms host clock, idle share {idle:.4f} (profiler on); first to last "
        f"device event {span:.2f} ms; kernel times summed {summed:.2f} ms; by group (summed) "
        + "; ".join(f"{g} {ms:.2f} ms" for g, ms in groups.items()))
    for key, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:110]}")
    return dict(busy_ms=busy, wall_ms=wall_ms, idle_share=idle, device_span_ms=span,
                summed_kernel_ms=summed, groups=groups,
                top=[dict(kernel=k[:160], ms=ms, count=c) for k, ms, c in kernels[:12]])


def radbert_phase(dev, work: Path, card: str) -> dict:
    """radbert-train / -infer / -eval through the CLI at full RadBERT width,
    the training step time, and the dropout-off step (K12)."""
    import torch

    from ct_clip_tpu_torch import cli
    from ct_clip_tpu_torch.config import PATHOLOGIES, RadBertConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import RadBertClassifier
    from ct_clip_tpu_torch.train import ReportClassificationDataset, TextClassifierTrainer

    vocab = write_vocab(work / "radbert_vocab.txt")
    train_csv = write_reports(work / "reports_train.csv", 64, seed=0)
    valid_csv = write_reports(work / "reports_valid.csv", 64, seed=1)
    pt, inferred, report = (str(work / x) for x in ("radbert.pt", "inferred.csv",
                                                    "radbert_report.json"))
    base = ["--vocab", vocab, "--device", "cuda", "--seed", "0"]
    counts = {}
    result, counts["radbert_train"], train_s = drive("radbert_train", lambda: cli.main(
        base + ["radbert-train", "--reports", train_csv, "--reports-valid", valid_csv,
                "--batch-size", "32", "--epochs", "2", "--out", pt]))
    hist = result["history"]
    losses = [h[k] for h in hist for k in ("train_loss", "valid_loss")]
    log(f"radbert-train: 2 epochs x 2 steps of 32 reports at full width in {train_s:.2f} s "
        f"(host clock, model build, validation and the .pt included); history {hist}")
    if len(hist) != 2 or not np.isfinite(losses + [result["best_loss"]]).all():
        raise AssertionError(f"radbert-train: bad history {hist}")

    _, counts["radbert_infer"], _ = drive("radbert_infer", lambda: cli.main(
        base + ["radbert-infer", "--reports", valid_csv, "--head", pt, "--out", inferred]))
    rows = list(csv.DictReader(open(inferred)))
    if len(rows) != 64 or any(r[p] not in ("0", "1") for r in rows for p in PATHOLOGIES):
        raise AssertionError("radbert-infer: bad inferred CSV")
    probs, counts["radbert_eval"], _ = drive("radbert_eval", lambda: cli.main(
        base + ["radbert-eval", "--reports", valid_csv, "--head", pt, "--out", report]))
    rep = json.loads(Path(report).read_text())
    if probs.shape != (64, 18) or not np.isfinite(probs).all() or probs.min() < 0 \
            or probs.max() > 1 or PATHOLOGIES[0] not in rep:
        raise AssertionError(f"radbert-eval: bad probabilities {probs.shape} or report")
    log(f"radbert-infer / -eval: 64 reports, P in [{probs.min():.4f}, {probs.max():.4f}], "
        f"macro avg f1 {rep['macro avg']['f1-score']:.4f}")

    # steady-state training step (CUDA events), from the trained weights
    tok = WordPieceTokenizer(vocab)
    model = RadBertClassifier(RadBertConfig(vocab_size=tok.vocab_size), device=dev)
    cli.load_radbert_checkpoint(model, pt)
    trainer = TextClassifierTrainer(model, tok, batch_size=32)
    batch = next(ReportClassificationDataset(train_csv).batches(tok, 32, shuffle=False))
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step(batch, 2e-5, i)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step = statistics.median(step_ms[1:])
    log(f"radbert step: batch 32 x 512 tokens, full width, f32: median {step:.2f} ms of "
        f"steps 2-5 {[round(t, 2) for t in step_ms]} = {32 / step * 1e3:.1f} reports/s; "
        f"peak memory {peak_gb:.2f} GB; loss {loss.item():.4f} on {card}")
    # one step's launches: each of the 12 layers' K13a f32 and K13b f32 on
    # attention_tc32.cu (3xTF32)
    _, one, _ = drive("radbert_step", lambda: trainer.train_step(batch, 2e-5, 7))
    counts["radbert_step"] = one
    per_step = {k: one[k] for k in ("attention_dropout", "attention_dropout_bwd",
                                    "attention_tc32", "attention_tc32_bwd", "attention_bwd")}
    want = dict(attention_dropout=BERT_LAYERS, attention_dropout_bwd=BERT_LAYERS,
                attention_tc32=BERT_LAYERS, attention_tc32_bwd=BERT_LAYERS, attention_bwd=0)
    log(f"radbert step: launches in one step {per_step}")
    if per_step != want:
        raise AssertionError(f"radbert step: launches {per_step}, want {want}")
    breakdown = profile_step(lambda: trainer.train_step(batch, 2e-5, 9))
    del model, trainer
    torch.cuda.empty_cache()

    # the same step with attention dropout off runs K7 and K12a, not K13:
    # one K7 f32 and one K12a f32 per layer, on attention_tc32.cu (3xTF32)
    cfg = RadBertConfig(vocab_size=tok.vocab_size, num_hidden_layers=2,
                        attention_dropout=0.0)
    model = RadBertClassifier(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(1))
    trainer = TextClassifierTrainer(model, tok, batch_size=32)
    loss, counts["radbert_dropout_off"], _ = drive(
        "radbert_dropout_off", lambda: trainer.train_step(batch, 2e-5, 0))
    off = counts["radbert_dropout_off"]
    if not np.isfinite(loss.item()) or off["attention_dropout"] \
            or (off["fused_attention"], off["attention_tc32"], off["attention_bwd"],
                off["attention_tc32_bwd"]) != (2, 2, 2, 2):
        raise AssertionError(f"radbert dropout-off step: loss {loss.item()}, launches {off}, "
                             "want 2 K7 and 2 K12a on attention_tc32.cu and no K13")
    # RadBERT is f32: nothing of it moves to the bf16 tensor-core kernels
    on_tc = {path: (c["attention_tc"], c["attention_tc_bwd"]) for path, c in counts.items()
             if c["attention_tc"] or c["attention_tc_bwd"]}
    if on_tc:
        raise AssertionError(f"radbert (f32) ran attention_tc.cu: {on_tc}")
    del model, trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=step, step_ms_all=step_ms, peak_gb=peak_gb,
                history=hist, train_cli_s=train_s, step_breakdown=breakdown,
                launches_per_step=per_step)


# ---------------------------------------------------------------- phase 5
def tiny_zero_shot_config():
    """The tiny CT-CLIP of the small-input references (3 x 3 x 3 tokens of
    width 64, a 2-layer BERT of width 64)."""
    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig

    return CTCLIPConfig(
        dim_text=64, dim_image=9 * 64, dim_latent=32,
        ctvit=CTViTConfig(dim=64, codebook_size=128, image_size=48, patch_size=16,
                          temporal_patch_size=4, num_frames=12, spatial_depth=2,
                          temporal_depth=2, dim_head=16, heads=4),
        bert=BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128))


def small_reference_phase(dev, work: Path):
    """Tiny CT-CLIP: card (kernels) vs CPU (plain versions), same weights,
    both bf16, from volumes (K8) and from patch rows (K6 on the card, K4).
    Both round to bf16 at the same points; they differ in summation order,
    so the P(present) agree to 0.05 (a pair softmax at temperature e of
    latents ~1% apart)."""
    import torch

    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    cfg = tiny_zero_shot_config()
    tok = WordPieceTokenizer(str(work / "vocab.txt"))
    cpu = CTCLIP(cfg, dtype=torch.bfloat16).eval()
    cpu.init_weights(torch.Generator().manual_seed(1))
    gpu = CTCLIP(cfg, dtype=torch.bfloat16, device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    video = torch.rand((3, 12, 48, 48, 1), generator=torch.Generator().manual_seed(2))
    video = (video * 2 - 1).to(torch.bfloat16)
    ref_clf = ZeroShotClassifier(cpu, tok, max_text_len=64)
    gpu_clf = ZeroShotClassifier(gpu, tok, max_text_len=64)
    errs = {}
    for route in ("volume", "rows"):
        if route == "volume":
            ref = ref_clf.score_batch(video)
            got = gpu_clf.score_batch(video.to(dev)).cpu()
        else:
            ref = ref_clf.score_batch(rearrange_patches(video[..., 0], 4, 16))
            got = gpu_clf.score_batch(rearrange_patches(video[..., 0].to(dev), 4, 16)).cpu()
        err = errs[route] = (got - ref).abs().max().item()
        log(f"reference: tiny CT-CLIP P(present) from {route}, card vs CPU max abs "
            f"diff {err:.4e} (tol 0.05)")
        if got.shape != (3, 18) or not torch.isfinite(got).all() or err > 0.05:
            raise AssertionError(f"small-input reference ({route}) disagrees: {err}")
    return errs


def tc32_planted_faults(kernel: str = "K12a f32", forward: str = "K7 f32"):
    """name -> (wrapper, broken): attention_tc32.cu's wrappers broken on
    purpose, which a tiny card-vs-CPU step must catch: the backward
    (kernels.attention_tc32_bwd) with D_i forced to 0 (the kernel's
    gradients plus the P D terms its omission adds, with or without
    dropout: dS = P (dP M - D)) and in its plain-TF32 copy, and the forward
    (kernels.attention_tc32_fwd) in its plain-TF32 copy; `kernel` and
    `forward` name the forms in the names."""
    from ct_clip_tpu_torch.ops import kernels as K

    tc32 = K.attention_tc32_bwd

    def no_rowsum(q, k, v, out, dout, lse, **kw):
        dq, dk, dv, db, dkb = tc32(q, k, v, out, dout, lse, **kw)
        s = q @ k.transpose(-1, -2) - lse[..., None]
        if kw.get("bias") is not None:
            s = s + kw["bias"]
        if kw.get("key_bias") is not None:
            s = s + kw["key_bias"][:, None, None, :]
        extra = s.exp() * (dout * out).sum(-1, keepdim=True)  # dS with D_i = 0 is dS + P D
        if db is not None:  # summed over the batch, and the heads for a one-head bias
            db = db + (extra.sum(0).sum(0, keepdim=True) if db.shape[0] == 1 else extra.sum(0))
        return (dq + extra @ k, dk + extra.transpose(-1, -2) @ q, dv, db,
                None if dkb is None else dkb + extra.sum(dim=(1, 2)))
    return {f"{kernel} with D_i forced to 0": ("attention_tc32_bwd", no_rowsum),
            f"{kernel} in plain TF32 (hi hi alone)": ("attention_tc32_bwd", plain_tf32()),
            f"{forward} forward in plain TF32 (hi hi alone)":
                ("attention_tc32_fwd", plain_tf32("attention_tc32_fwd"))}


@contextlib.contextmanager
def same_seeds(first: int = 20261017):
    """Inside the block BERT's attention dropout (`fused_attention_kbias_dropout`
    as models/bert.py calls it) takes the seeds first, first + 1, ... in
    call order on the call's device, in place of its generator's draws,
    which differ between the CPU and the card: so a step draws the same
    Philox masks on both."""
    import torch

    from ct_clip_tpu_torch.models import bert

    calls = iter(range(first, first + 10 ** 6))
    drop = bert.fused_attention_kbias_dropout

    def seeded(q, k, v, key_bias, seed, rate):
        return drop(q, k, v, key_bias,
                    torch.tensor([next(calls)], dtype=torch.int64, device=q.device), rate)
    with replaced(bert, "fused_attention_kbias_dropout", seeded):
        yield


def radbert_reference_phase(dev, work: Path, attention_dropout: float = 0.0) -> dict:
    """One training step of a tiny RadBERT (2 layers, width 128, 2 heads of
    64, hidden dropout 0, batch 8 x 512 tokens) from the same weights on the
    card (K7 f32, and K12a f32 or, with `attention_dropout` > 0, K13a f32
    and K13b f32, the backward on attention_tc32.cu, asserted) and on the
    CPU (plain versions), both f32.  With dropout both sides take the same
    seeds, one per layer (`same_seeds`), so the same Philox masks.  They sum
    in other orders: logits and loss
    within 1e-5 relative, each parameter's gradient within 1e-4 of its
    largest entry, the updated weights within 1e-5.  The key biases'
    gradient is zero in exact arithmetic (softmax is shift invariant), so
    both sides hold rounding noise there, which Adam turns into steps of up
    to lr: they are held to that bound.  Then the card step again with each
    of `tc32_planted_faults`, which must fall outside these limits."""
    import torch

    from ct_clip_tpu_torch.config import RadBertConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import RadBertClassifier
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.train import ReportClassificationDataset, TextClassifierTrainer

    tok = WordPieceTokenizer(str(work / "radbert_vocab.txt"))
    cfg = RadBertConfig(vocab_size=tok.vocab_size, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        hidden_dropout=0.0, attention_dropout=attention_dropout)
    kernel = "K13b f32" if attention_dropout else "K12a f32"
    start = {k: v.clone() for k, v in
             RadBertClassifier(cfg).init_weights(torch.Generator().manual_seed(5))
             .state_dict().items()}
    batch = next(ReportClassificationDataset(str(work / "reports_valid.csv")).batches(
        tok, 8, shuffle=False))
    lr = 1e-3

    def side(device):
        model = RadBertClassifier(cfg, device=device)
        model.load_state_dict(start)
        tr = TextClassifierTrainer(model, tok, lr=lr, batch_size=8)
        with torch.no_grad():
            ids, mask = (torch.from_numpy(batch[k]).to(tr.device)
                         for k in ("input_ids", "attention_mask"))
            logits = model.eval()(ids, mask).cpu()
        before = K.launch_counts()
        with same_seeds():
            loss = tr.train_step(batch, lr).item()
        ran = {c: K.launch_counts()[c] - before[c] for c in ("attention_tc32_bwd",
                                                             "attention_dropout_bwd")}
        want = {"attention_tc32_bwd": cfg.num_hidden_layers,
                "attention_dropout_bwd": cfg.num_hidden_layers if attention_dropout else 0}
        if device.type == "cuda" and ran != want:
            raise AssertionError(f"tiny RadBERT: {kernel} launches {ran}, want {want}")
        return dict(logits=logits, loss=loss,
                    grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                    weights={k: v.cpu() for k, v in model.state_dict().items()})

    def compare(c, g):
        logit_rel = (g["logits"] - c["logits"]).abs().max().item() \
            / c["logits"].abs().max().item()
        loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        grad_rel = weight_err = key_bias_step = 0.0
        for n in c["grads"]:
            if n.endswith("attention.self.key.bias"):
                key_bias_step = max(key_bias_step,
                                    (g["weights"][n] - start[n]).abs().max().item())
                continue
            ref = c["grads"][n].abs().max().item()
            if ref > 0:
                grad_rel = max(grad_rel,
                               (g["grads"][n] - c["grads"][n]).abs().max().item() / ref)
            weight_err = max(weight_err, (g["weights"][n] - c["weights"][n]).abs().max().item())
        res = dict(logits_rel=logit_rel, loss_rel=loss_rel, grad_rel=grad_rel,
                   weight_abs=weight_err, key_bias_step_over_lr=key_bias_step / lr)
        limits = dict(logits_rel=1e-5, loss_rel=1e-5, grad_rel=1e-4, weight_abs=1e-5,
                      key_bias_step_over_lr=2.0)
        return res, [k for k, lim in limits.items() if res[k] > lim]

    label = f"tiny RadBERT step (attention dropout {attention_dropout})"
    c = side(torch.device("cpu"))
    res, failures = compare(c, side(dev))
    log(f"reference: {label} card vs CPU: logits rel {res['logits_rel']:.2e}, loss "
        f"rel {res['loss_rel']:.2e} (tol 1e-5), grads rel {res['grad_rel']:.2e} (tol 1e-4), "
        f"updated weights abs {res['weight_abs']:.2e} (tol 1e-5), key bias step "
        f"{res['key_bias_step_over_lr']:.3f} lr (tol 2)")
    if failures:
        raise AssertionError(f"{label}: card vs CPU disagree on {failures}: {res}")
    res["faults"] = {}
    for name, (wrapper, broken) in tc32_planted_faults(
            kernel, "K13a f32" if attention_dropout else "K7 f32").items():
        with replaced(K, wrapper, broken):
            fres, ffail = compare(c, side(dev))
        log(f"reference: {label}, planted fault '{name}': grads rel "
            f"{fres['grad_rel']:.2e}, updated weights abs {fres['weight_abs']:.2e}, logits rel "
            f"{fres['logits_rel']:.2e}, loss rel {fres['loss_rel']:.2e}; outside {ffail}")
        if not ffail:
            raise AssertionError(f"{label}: planted fault '{name}' passes the limits: {fres}")
        res["faults"][name] = dict(outside=ffail, **fres)
    return res


# ---------------------------------------------------------------- phase 6
# cuDNN's convolutions: the discriminator's k4 s2 convs (XLA's conv in JAX
# too) and nothing else; until the PEG stencil, the PEG forward and dx, 512
# per-group kernels a call.  The contrastive and zero-shot profiles must show
# none.
CUDNN_GROUP = "cuDNN conv (no PEG since the stencil; the discriminator's convs)"


def no_cudnn(label: str, breakdown: dict) -> None:
    """A profiled step without a cuDNN convolution: every PEG on the stencil."""
    ms = breakdown["groups"][CUDNN_GROUP]
    if ms > 0:
        raise AssertionError(f"{label}: {ms:.3f} ms of cuDNN convolution kernels in the profile")


# kernel-name fragments of a CT-CLIP training step's groups (first match)
CTCLIP_GROUPS = (
    ("K11 f32 tile and the f32 backwards' TN products and transposed splits, 3xTF32 on the "
     "tensor cores (ffn_tc32.cu: ff_tc32_bwd_kernel, tc32_split_t_kernel)",
     ("ff_tc32_bwd_kernel", "tc32_split_t_kernel")),
    ("K10 attention core backward on 16-31-token sequences, bf16 and f32 "
     "(qknorm_attention_short.cu: qk_short_bwd<true>, <false>)", ("qk_short_bwd",)),
    ("K5 exact assignment on the tensor cores (vq_tc.cu: vq_tc_argmax<1>, <2>, and the f32 "
     "rows' splitting pre-pass vq_rows_bf16_kernel<true>)",
     ("vq_tc_argmax<1>", "vq_tc_argmax<2>", "vq_rows_bf16_kernel<true>")),
    ("K3 f32 and K1 f32's projections, 3xTF32 on the tensor cores (ffn_tc32.cu: "
     "ff_tc32_kernel, tc32_split_kernel; the f32 backwards' plain-store products too)",
     ("ff_tc32_kernel", "tc32_split_kernel")),
    TC_BWD_GROUP,
    TC_FWD_GROUP,
    TC32_GROUP,
    TC32_FWD_GROUP,
    ("K3 bf16 GEGLU and residual products on the tensor cores (ffn_tc.cu: ff_tc_gemm<0, 3>, "
     "<0, 4>; <0, 4> is K1 / K2 bf16's output product too)",
     ("ff_tc_gemm<0, 3>", "ff_tc_gemm<0, 4>", "ff_tc_gemm<0,3>", "ff_tc_gemm<0,4>")),
    ("K1 / K2 bf16 q and kv products on the tensor cores (ffn_tc.cu: ff_tc_gemm<0, 5>; K9 / "
     "K10's recompute too)", ("ff_tc_gemm<0, 5>", "ff_tc_gemm<0,5>")),
    ("K5 inference assignment on the tensor cores (vq_tc.cu: vq_tc_argmax, and the f32 rows' "
     "pre-pass vq_rows_bf16_kernel)", ("vq_tc_argmax", "vq_rows_bf16")),
    ("K4 / K8 bf16 embed on the tensor cores (embed_tc.cu: embed_stats, embed_tc_kernel)",
     ("embed_stats", "embed_tc_kernel")),
    ("K11 bf16 tile and products, K9 / K10 bf16's products on the tensor cores (ffn_tc.cu: "
     "ff_tc_tile, ff_tc_gemm; K10's f32-store NT recompute <0, 6>, K9's bf16-store NN <0, 7>)",
     ("ff_tc_",)),
    ("K11 GEGLU FF backward tile (ff_bwd_kernel)", ("ff_bwd_kernel",)),
    ("backward products NN/TN + split sums (gemm_layout_kernel, sum_splits)",
     ("gemm_layout_kernel", "gemm_layout_f32_kernel", "sum_splits_kernel")),
    ("K1 bf16 attention core forward on the tensor cores (qknorm_attention_tc.cu: qk_tc_fwd)",
     ("qk_tc_fwd",)),
    ("K1 f32 attention core forward, 3xTF32 on the tensor cores (qknorm_attention_tc32.cu: "
     "qk32_fwd)", ("qk32_fwd",)),
    ("K2 attention core forward, bf16 and f32 (qknorm_attention_short.cu: qk_short_fwd)",
     ("qk_short_fwd",)),
    ("K9 bf16 attention core backward on the tensor cores (qknorm_attention_tc.cu; the "
     "pre-pass of K1's too)", ("qk_tc_",)),
    ("K9 f32 attention core backward, 3xTF32 on the tensor cores (qknorm_attention_tc32.cu; "
     "the pre-pass of K1 f32's too)", ("qk32_",)),
    ("K9/K10 attention core backward (qk_attention_bwd_kernel)", ("qk_attention_bwd_kernel",)),
    ("LayerNorm backward (ln_bwd_kernel; the warp-a-row ln_bwd_rows_kernel, f32 and bf16)",
     ("ln_bwd_kernel", "ln_bwd_rows_kernel")),
    ("PEG stencil: forward and K14 (peg_stencil.cu: peg_stencil_kernel<T, false>, <T, true>)",
     ("peg_stencil",)),
    ("K15 VQ statistics (vq_segstats.cu: group_rows, seg_sum)", ("group_rows", "seg_sum")),
    ("K5 exact assignment (gemm_argmax2_kernel)", ("gemm_argmax2",)),
    ("forward products K1-K3 (gemm_kernel) and LN (ln_kernel)", ("gemm_kernel<",
                                                                 "ln_kernel")),
    ("K1/K2 attention core forward on the CUDA cores (attention_kernel: K2, and K1 off the "
     "tensor cores)",
     ("attention_kernel", "attention_f32_kernel")),
    ("CUDA-core attention forward (attention_train.cu)", ("fwd_kernel<",)),
    ("CUDA-core attention backward (attention_train.cu)", ("bwd_dq_kernel", "bwd_dkv_kernel",
                                                           "rowdot_kernel", "dkb_sum")),
    (CUDNN_GROUP, ("conv", "cudnn", "depthwise")),
    ("cuBLAS products (BERT, embed, latent projections)", ("gemm", "xmma", "cutlass",
                                                           "cublas", "sm90")),
    ("Adam (multi-tensor)", ("multi_tensor", "foreach")),
)


def write_train_corpus(work: Path):
    """20 training volumes (16 kept by the 80% split) with generated reports
    and 2 labelled validation volumes, 256 x 256 x 60 at 1.5 x 1.5 x 6 mm,
    which the ingest resamples and crops to 240 x 480 x 480."""
    train = write_corpus(work / "train", [(256, 256, 60)] * 20, 1.5, 6.0)
    rng = np.random.RandomState(4)
    words = report_words()
    rows = list(csv.DictReader(open(train[1])))
    for r in rows:
        r["Findings_EN"] = " ".join(rng.choice(words, rng.randint(20, 200))) + "."
    with open(train[1], "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    valid = write_corpus(work / "valid", [(256, 256, 60)] * 2, 1.5, 6.0)
    return train, valid, write_vocab(work / "ctclip_vocab.txt")


def timed_steps(step, state, batch, card: str, label: str, batch_size: int,
                groups=None) -> dict:
    """Steady-state step time (CUDA events, 4 steps, median of steps 2-4),
    peak memory and a profiled step of a CT-CLIP training step."""
    import torch

    from ct_clip_tpu_torch.train import step_generators

    dev = state.model.temperature.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch, step_generators(5 + i, dev))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms[1:])
    vcfg = state.model.config.ctvit
    dtype = str(state.model.dtype).replace("torch.", "")
    log(f"{label} step: batch {batch_size} x ({vcfg.patch_t * vcfg.patch_hw ** 2:,} tokens, 512 "
        f"text tokens), full width, {dtype}: "
        f"median {med:.2f} ms of steps 2-4 {[round(t, 2) for t in step_ms]} = "
        f"{batch_size / med * 1e3:.3f} volumes/s; peak memory {peak_gb:.2f} GB; loss "
        f"{m['loss'].item():.4f} on {card}")
    breakdown = profile_step(lambda: step(state, batch, step_generators(9, dev)),
                             groups or CTCLIP_GROUPS, label)
    return dict(step_ms=med, step_ms_all=step_ms, volumes_per_s=batch_size / med * 1e3,
                peak_gb=peak_gb, step_breakdown=breakdown)


# launches per step of `cli train`: bf16, the text tower's 12 layers' K13a
# and K13b on the tensor cores, the 4 spatial layers' K9 core on the tensor
# cores (qknorm_attention_tc.cu); f32, each of the 4 + 4 layers' backward, one
# K5 exact and one K15, K13a f32 and K13b f32 on the tensor cores in 3xTF32
# (attention_tc32.cu), K11's tile, K10's short core and the backwards'
# products in 3xTF32 (ffn_tc32.cu)
CLIP_PER_STEP = {
    # K11's three products, K9's and K10's six each on ffn_tc.cu
    "bf16": dict(attention_dropout=BERT_LAYERS, attention_dropout_bwd=BERT_LAYERS,
                 attention_tc_bwd=BERT_LAYERS, spatial_attention_bwd=4, qk_attention_tc_bwd=4,
                 grid_attention_bwd=4, qk_attention_short_bwd=4, vq_assign_exact=1,
                 vq_assign_exact_tc=1, geglu_ff_bwd=8, ff_tc_tile=8, ff_tc_gemm=3 * 8 + 6 * 8,
                 qk_attention_tc32_bwd=0, qk_attention_short_bwd_f32=0, peg_bwd=8,
                 peg_bwd_f32=0),
    "f32": dict(spatial_attention_bwd_f32=4, grid_attention_bwd_f32=4, vq_assign_exact_f32=1,
                vq_cluster_stats_f32=1, geglu_ff_bwd_f32=8, attention_dropout=BERT_LAYERS,
                attention_dropout_bwd=BERT_LAYERS, attention_tc32_bwd=BERT_LAYERS,
                attention_tc=0, attention_tc_bwd=0, peg_bwd=8, peg_bwd_f32=8,
                spatial_attention_bwd=4,
                grid_attention_bwd=4, qk_attention_tc_bwd=0, qk_attention_tc32_bwd=4,
                ff_tc_tile=0, ff_tc_gemm=0, ff_tc32_tile=8, qk_attention_short_bwd_f32=4,
                vq_assign_exact_tc=1,
                # K11: two TN products; K9 and K10: three TN (their plain-store
                # products count as tc32_gemm, checked with the forwards')
                tc32_gemm_tn=2 * 8 + 3 * 8, qk_proj_gemm=0),
}


def ctclip_train_phase(dev, work: Path, card: str, corpus, dtype: str = "bf16") -> dict:
    """`cli train` at full width, batch 8, 4 steps (mini evaluation and
    checkpoint at step 4), in bf16 or with `--no-bf16` in f32 (the JAX
    package's f32 CT-CLIP training); the launches per step against
    CLIP_PER_STEP, then the steady-state step time (CUDA events), peak
    memory and a profiled step."""
    import torch

    from ct_clip_tpu_torch import cli

    f32 = dtype == "f32"
    train, valid, vocab = corpus
    results = work / ("train_f32_results" if f32 else "train_results")
    argv = ["--vocab", vocab, "--device", "cuda", "--seed", "0",
            *(["--no-bf16"] if f32 else []), "train",
            "--data-train", train[0], "--reports-train", train[1], "--meta-train", train[2],
            "--data-valid", valid[0], "--reports-valid", valid[1], "--meta-valid", valid[2],
            "--labels", valid[3], "--results", str(results), "--batch-size", str(TRAIN_B),
            "--steps", "4", "--workers", "4", "--save-results-every", "4",
            "--save-model-every", "4"]
    label = "ctclip f32" if f32 else "ctclip"
    trainer, counts, secs = drive("ctclip_f32_train" if f32 else "ctclip_train",
                                  lambda: cli.main(argv))
    recs = [json.loads(x) for x in (results / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r["mini_eval_mean_auc"] for r in recs if "mini_eval_mean_auc" in r]
    ckpts = sorted(p.name for p in (results / "checkpoints").iterdir())
    model_dtype = trainer.state.model.dtype
    log(f"{label} train: {len(trainer.train_ds)} volumes, 4 steps of {TRAIN_B} at full width, "
        f"{model_dtype}, in {secs:.1f} s (host clock: build, ingest, mini evaluation and the "
        f"checkpoint included); losses {losses}; grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs if 'loss' in r]}; mini-eval mean AUC "
        f"{evals}; checkpoints {ckpts}")
    if model_dtype != (torch.float32 if f32 else torch.bfloat16) or len(losses) != 4 \
            or not np.isfinite(losses).all() or len(evals) != 1 \
            or ckpts != ["step_4.pt"] or not (results / "mini_eval_step4.csv").exists():
        raise AssertionError(f"{label} train: {model_dtype}, losses {losses}, evals {evals}, "
                             f"ckpts {ckpts}")
    want = CLIP_PER_STEP[dtype]
    per_step = {k: counts[k] / 4 for k in want}
    if f32:
        # K6 f32 moves each ingested volume (the mini evaluation's too) into
        # its batch slot; K17 f32 none (the volume takes no gradient)
        extra = {k: counts[k] / 4 for k in ("rearrange_patches_f32", "unrearrange_patches_f32")}
        # every attention forward of the run (K13a, the mini evaluation's
        # K7) on attention_tc32.cu, the step's 12 K13a among them
        extra["forwards_off_tc32"] = counts["attention_dropout"] + counts["fused_attention"] \
            - counts["attention_tc32"]
        extra["attention_tc32_k13a"] = (counts["attention_tc32"] - counts["fused_attention"]) / 4
        # every K1 f32 of the run (the steps' and the mini evaluation's) on
        # qknorm_attention_tc32.cu, every K2 f32 on qknorm_attention_short.cu,
        # the plain-store products on ffn_tc32.cu: three a K1 / K2 forward,
        # five a K9 / K10 backward (q and kv recomputed, dmerged, dxn, dx_kv),
        # one a K11 backward (dxn)
        extra["k1_off_tc32"] = counts["spatial_attention_f32"] - counts["qk_attention_tc32"]
        extra["k2_off_short"] = counts["grid_attention_f32"] - counts["qk_attention_short_f32"]
        extra["products_off_tc32"] = 3 * (counts["spatial_attention_f32"]
                                          + counts["grid_attention_f32"]) \
            + 5 * (counts["spatial_attention_bwd_f32"] + counts["grid_attention_bwd_f32"]) \
            + counts["geglu_ff_bwd_f32"] - counts["tc32_gemm"]
        extra_ok = not extra["unrearrange_patches_f32"] \
            and extra["rearrange_patches_f32"] >= TRAIN_B and not extra["forwards_off_tc32"] \
            and extra["attention_tc32_k13a"] == BERT_LAYERS and not extra["k1_off_tc32"] \
            and not extra["k2_off_short"] and not extra["products_off_tc32"] \
            and not counts["qk_attention_tc"] and not counts["qk_proj_tc"]
    else:
        # every attention forward of the run (K13a, the mini evaluation's
        # K7) on attention_tc.cu, none on attention_train.cu
        extra = dict(forwards_off_tc=counts["attention_dropout"] + counts["fused_attention"]
                     - counts["attention_tc"],
                     # every K1 of the run on qknorm_attention_tc.cu, every K2
                     # on qknorm_attention_short.cu
                     k1_off_tc=counts["spatial_attention"] - counts["qk_attention_tc"],
                     k2_off_short=counts["grid_attention"] - counts["qk_attention_short"],
                     # their products on ffn_tc.cu: three a forward, two a
                     # backward's recompute
                     products_off_wgmma=3 * (counts["spatial_attention"]
                                             + counts["grid_attention"])
                     + 2 * (counts["spatial_attention_bwd"] + counts["grid_attention_bwd"])
                     - counts["qk_proj_tc"])
        extra_ok = not extra["forwards_off_tc"] and not extra["k1_off_tc"] \
            and not extra["k2_off_short"] and not extra["products_off_wgmma"] \
            and not counts["qk_attention_tc32"] and not counts["qk_proj_gemm"]
    # every PEG forward of the run on the stencil (8 a step, 4 + 4 layers, and
    # the mini evaluation's), each in the run's dtype
    extra["peg_fwd"] = counts["peg_fwd"] / 4
    extra_ok = extra_ok and extra["peg_fwd"] >= 8 \
        and counts["peg_fwd_f32"] == (counts["peg_fwd"] if f32 else 0)
    log(f"{label} train: launches per step {per_step}; {extra}")
    if any(per_step[k] != v for k, v in want.items()) or not extra_ok:
        raise AssertionError(f"{label} train: launches per step {per_step}, want {want}; "
                             f"{extra}")
    shutil.rmtree(results / "checkpoints")

    batch = next(trainer._batches())
    timed = timed_steps(trainer.step_fn, trainer.state, batch, card, label, TRAIN_B,
                        F32_TRAIN_GROUPS if f32 else None)
    no_cudnn(f"{label} step", timed["step_breakdown"])
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, losses=losses, mini_eval_mean_auc=evals[0], cli_s=secs,
                launches_per_step=dict(per_step, **extra), **timed)


def tiny_ctclip_config():
    """The tiny CT-CLIP of phase 6's card-vs-CPU step: its BERT has one head
    of 64, CXR-BERT's head dim, so its key-bias attention under grad takes
    the tensor cores (K7 and K12a, attention_tc.cu) as the full tower's does
    (phase 7's `tiny_aux_config` keeps four heads of 16)."""
    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig

    return CTCLIPConfig(
        dim_text=64, dim_image=9 * 64, dim_latent=32,
        ctvit=CTViTConfig(dim=64, codebook_size=128, image_size=48, patch_size=16,
                          temporal_patch_size=4, num_frames=12, spatial_depth=2,
                          temporal_depth=2, dim_head=16, heads=4),
        bert=BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=1, intermediate_size=128, hidden_dropout=0.0,
                        attention_dropout=0.0))


# the tiny CT-CLIP step, card against CPU (both bf16): limits.  Each
# gradient is held against the CPU's own bf16 rounding noise, its distance
# from the same step in f32; the readings of the kernels as built and of the
# planted faults (PERF.md) put TINY_GRAD_RATIO between them
TINY_LOSS_TOL = 2e-3
TINY_GRAD_RATIO = 1.15
TINY_ZERO_TOL = 1e-3  # x the largest gradient, parameters whose true gradient is zero
TINY_UPDATE_TOL = 1e-2  # x lr, entries whose gradient is >= 0.2 of its tensor's max
# init seeds over which phase 7's tiny aux step pools the CPU's own bf16
# noise (its own, 8, first): at one init a tensor's bf16 gradient can land
# near its f32 value by chance (the temperature's lies 0.6-13% from it over
# these six), which the card's other rounding points need not repeat
AUX_NOISE_SEEDS = (1, 2, 3, 4, 5)
# parameters whose true gradient is zero: softmax shift invariance, and the
# SimSiam predictor's first bias, which a BatchNorm cancels
ZERO_GRAD = ("attention.self.key.bias", "spatial_rel_pos_bias.net.2.bias",
             "visual_ssl.online_predictor.0.bias", "continuous_pos_bias.net.2.bias")


def tiny_ctclip_inputs():
    import torch

    g = torch.Generator().manual_seed(7)
    ids = torch.randint(5, 64, (4, 32), generator=g)
    mask = (torch.arange(32)[None] < torch.tensor([[32], [20], [9], [27]])).long()
    video = torch.rand((4, 12, 48, 48, 1), generator=g) * 2 - 1
    return ids * mask, mask, video


def tiny_ctclip_side(cfg, tcfg, start, inputs, device, dtype) -> dict:
    """From the state dict `start` on `device`, computing in `dtype`: the VQ
    ids, one forward/backward (the loss and every parameter's gradient),
    then one `make_train_step` from `start`.  The MLM and augmentation draws
    come from `step_generators`' host generators, so every side masks and
    augments alike."""
    import torch

    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.train import create_train_state, make_train_step, step_generators

    ids, mask, video = (t.to(device) for t in inputs)
    batch = dict(input_ids=ids, attention_mask=mask, video=video)
    model = CTCLIP(cfg, dtype=dtype, device=device)
    model.load_state_dict(start)
    state = create_train_state(model, tcfg)
    with torch.no_grad():
        vt = model.visual_transformer
        codes = vt.vq(vt.encode(vt.embed_patches(video, train=True)), train=True)[1].cpu()
    model.load_state_dict(start)  # the VQ call moved the codebook
    model.train()
    model.zero_grad()
    gens = step_generators(7, device)
    loss = model(**batch, return_loss=True, train=True, mlm_generator=gens["mlm"],
                 ssl_generator=gens["ssl"])
    before = K.launch_counts()
    loss.backward()
    # one K12a per BERT layer and text pass (two with MLM): on the tensor
    # cores at CXR-BERT's head dim 64 (bf16 attention_tc.cu, f32
    # attention_tc32.cu), else on attention_train.cu
    k12a = cfg.bert.num_hidden_layers * (2 if cfg.use_mlm else 1)
    on_tc = cfg.bert.hidden_size // cfg.bert.num_attention_heads == K.TC_HEAD_DIM
    tc = "attention_tc_bwd" if dtype == torch.bfloat16 else "attention_tc32_bwd"
    want = {"attention_bwd": k12a, tc: k12a if on_tc else 0}
    ran = {k: K.launch_counts()[k] - before[k] for k in want}
    if device.type == "cuda" and ran != want:
        raise AssertionError(f"tiny CT-CLIP: key-bias backwards {ran}, want {want}")
    grads = {n: p.grad.float().cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.load_state_dict(start)
    m = make_train_step(tcfg)(state, batch, step_generators(7, device))
    return dict(loss=loss.item(), grads=grads, codes=codes, state=state, batch=batch,
                metrics={k: v.item() for k, v in m.items()},
                sd={k: v.float().cpu() for k, v in model.state_dict().items()})


def update_noise(x: dict, x32: dict, start: dict, lr: float) -> dict:
    """How the update of side `x` strays from the f32 step `x32` on the
    entries whose f32 gradient is >= 2e-1 of its tensor's largest: per
    tensor the entries whose step differs by more than lr (Adam's first step
    is lr g / (|g| + eps): a sign flip), their total, and the largest
    difference where the signs agree (a size, which moves only where |g|
    nears eps)."""
    flips, size, worst = {}, 0.0, ""
    for n, true in x32["grads"].items():
        if not true.numel() or n.endswith(ZERO_GRAD):
            continue
        big = true.abs() >= 2e-1 * true.abs().max()
        d = (x["sd"][n] - x32["sd"][n]).abs()[big]
        if int((d > lr).sum()):
            flips[n] = int((d > lr).sum())
        agree = d[d <= lr]
        if agree.numel() and agree.max().item() > size:
            size, worst = agree.max().item(), n
    return dict(flips=flips, total_flips=sum(flips.values()), size=size, size_worst=worst)


def pooled_cpu_noise(sides, lr: float) -> dict:
    """The CPU's own bf16 noise pooled over init seeds: `sides` (c, c32,
    start) of the tiny step at each seed, on the CPU in bf16 and in f32.  Per
    tensor the largest relative L2 distance of the bf16 gradient from the
    f32 one, each seed's over that seed's f32 norm (a tensor's gradient at
    one init may round to near its f32 value by chance, as the
    temperature's reads 0.6-13% over six seeds), and the most update signs
    the bf16 step flips against the f32 step on that tensor's large entries;
    over the step's tensors and seeds the largest update size error where
    the signs agree (`update_noise`)."""
    grad, flips, size, seeds = {}, {}, 0.0, 0
    for c, c32, start in sides:
        for n, true in c32["grads"].items():
            rel = (c["grads"][n] - true).norm().item() / max(true.norm().item(), 1e-30)
            grad[n] = max(grad.get(n, 0.0), rel)
        u = update_noise(c, c32, start, lr)
        for n, k in u["flips"].items():
            flips[n] = max(flips.get(n, 0), k)
        size, seeds = max(size, u["size"]), seeds + 1
    return dict(grad=grad, flips=flips, size=size, seeds=seeds)


def compare_tiny_steps(c: dict, c32: dict, g: dict, start: dict, lr: float,
                       pooled=None,
                       vq_prefix: str = "visual_transformer.vq._codebook.",
                       grad_ratio: float = TINY_GRAD_RATIO):
    """(readings, failures) of a card side `g` against the CPU side `c`,
    with the CPU's f32 side `c32` giving each gradient's bf16 noise.  With
    `pooled` (`pooled_cpu_noise`), for configurations whose bf16 gradients
    lie 15-25% from the f32 ones on the CPU itself and flip the sign of
    Adam's first step there: the card is held to the f32 step, its noise
    scale the CPU's own bf16 noise pooled over init seeds.  Each gradient's
    L2 distance card-f32 over the f32 norm within `grad_ratio` times the
    largest such CPU bf16-f32 distance of that tensor over the seeds (the
    card rounds at the TPU kernels' points and the CPU at the plain chain's:
    two roundings lie ~sqrt(2) times one apart, so the f32 step and not the
    CPU's bf16 step is the reference); on each tensor the update signs the
    card flips against the f32 step on its large entries within the most
    the CPU's bf16 step flips there over the seeds; the largest update size
    error where the signs agree within TINY_UPDATE_TOL lr or the CPU bf16
    step's largest over the tensors and seeds (`update_noise`).  Without
    `pooled`: each gradient against the CPU's bf16 one over that tensor's
    own bf16-f32 distance, each update on the entries whose CPU bf16
    gradient is large within TINY_UPDATE_TOL lr of the CPU bf16 step.
    `grad_ratio` is the gradients' limit (TINY_GRAD_RATIO unless a
    configuration states its own)."""
    def l2_rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    ratio, zero = {}, 0.0
    top = max(t.abs().max().item() for t in c["grads"].values())
    for n, ref in c["grads"].items():
        if n.endswith(ZERO_GRAD):
            zero = max(zero, g["grads"][n].abs().max().item() / top)
            continue
        if pooled is None:
            noise = max(l2_rel(ref, c32["grads"][n]), 1e-3)
            dist = l2_rel(g["grads"][n], ref)
        else:  # over the f32 gradient's norm, the pooled noise each over its seed's
            noise = max(pooled["grad"][n], 1e-3)
            dist = l2_rel(g["grads"][n], c32["grads"][n])
        ratio[n] = (dist / noise, dist, noise)
    worst = sorted(ratio.items(), key=lambda kv: -kv[1][0])
    agree, cs_err, cb_err = 1.0, 0.0, 0.0
    if vq_prefix is not None:  # a model with a VQ (None: MaskGIT)
        key = vq_prefix
        agree = (g["codes"] == c["codes"]).float().mean().item()
        cs_err = (g["sd"][key + "cluster_size"] - c["sd"][key + "cluster_size"]).abs().max().item()
        cb_err = (g["sd"][key + "embed"] - c["sd"][key + "embed"]).abs().max().item()
    upd_err, upd_worst, upd_max = 0.0, "", 0.0
    for n, ref in c["grads"].items():
        if not ref.numel() or n.endswith(ZERO_GRAD):
            continue
        step = g["sd"][n] - start[n].float()
        diff = (step - (c["sd"][n] - start[n].float())).abs()
        upd_max = max(upd_max, diff.max().item())
        big = ref.abs() >= 2e-1 * ref.abs().max()
        if pooled is None and big.any() and diff[big].max().item() > upd_err:
            upd_err, upd_worst = diff[big].max().item(), n
    flips, over = {}, {}
    if pooled is not None:
        u = update_noise(g, c32, start, lr)
        upd_err, upd_worst, flips = u["size"], u["size_worst"], u["flips"]
        over = {n: [k, pooled["flips"].get(n, 0)] for n, k in flips.items()
                if k > pooled["flips"].get(n, 0)}
    res = dict(grad_ratio_limit=grad_ratio,
               loss_rel=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
               loss_rel_cpu_bf16_vs_f32=abs(c["loss"] - c32["loss"]) / abs(c32["loss"]),
               grad_ratio=worst[0][1][0], grad_worst=worst[0][0],
               grad_top=[[n, *r] for n, r in worst[:5]],
               grad_ratio_median=statistics.median(r[0] for r in ratio.values()),
               grad_l2_rel_max=max(r[1] for r in ratio.values()),
               zero_grads_over_top=zero, id_agreement=agree,
               cluster_size_abs=cs_err, codebook_abs=cb_err, update_err_over_lr=upd_err / lr,
               update_worst=upd_worst, update_max_over_lr=upd_max / lr)
    size_limit = TINY_UPDATE_TOL * lr
    if pooled is not None:  # tensor -> the card's flips; the limits pooled over seeds
        size_limit = max(size_limit, pooled["size"])
        res.update(noise_pooled_over_seeds=pooled["seeds"], update_sign_flips=flips,
                   update_sign_flips_total=sum(flips.values()),
                   update_sign_flips_limit=pooled["flips"], update_sign_flips_over=over,
                   update_size_limit_over_lr=size_limit / lr)
    failures = [name for name, bad in (
        ("loss", res["loss_rel"] > TINY_LOSS_TOL),
        ("gradients", res["grad_ratio"] > grad_ratio),
        ("zero gradients", zero > TINY_ZERO_TOL), ("VQ ids", agree < 1.0),
        ("cluster sizes", cs_err > 1e-6), ("codebook", cb_err > 1e-2),
        ("updates", upd_err > size_limit),
        ("update signs", bool(over)),
        ("update bound", upd_max > 2 * lr * (1 + 1e-6))) if bad]
    return res, failures


def _log_tiny(label: str, res: dict, failures) -> None:
    top = [(n, f"{r:.3f}", f"{d:.2e}", f"{e:.2e}") for n, r, d, e in res["grad_top"]]
    pooled = "update_sign_flips" in res
    log(f"reference: tiny step card vs CPU, {label}: loss rel {res['loss_rel']:.2e} "
        f"(tol {TINY_LOSS_TOL}; CPU bf16 vs f32 {res['loss_rel_cpu_bf16_vs_f32']:.2e}); "
        + (f"gradients, card-f32 L2 distance over the CPU's largest bf16-f32 one over "
           f"{res['noise_pooled_over_seeds']} init seeds, each over its f32 norm" if pooled else
           "gradients, card-CPU L2 distance over the CPU's bf16-f32 L2 distance")
        + f", largest first (tensor, ratio, card's, CPU's, over the reference's norm): {top}, "
        f"median {res['grad_ratio_median']:.3f} (tol {res['grad_ratio_limit']}); zero-gradient "
        f"params {res['zero_grads_over_top']:.2e} of the largest gradient (tol {TINY_ZERO_TOL}); "
        f"VQ ids equal {res['id_agreement']:.4f} (all); cluster sizes abs "
        f"{res['cluster_size_abs']:.2e} (tol 1e-6); codebook abs {res['codebook_abs']:.2e} "
        f"(tol 1e-2); "
        + (f"update signs flipped against the f32 step on its large entries "
           f"{res['update_sign_flips_total']} (by tensor {res['update_sign_flips'] or 'none'}; "
           f"above the CPU bf16 step's most on that tensor over the seeds "
           f"{res['update_sign_flips_over'] or 'none'}), "
           f"update sizes where the signs agree {res['update_err_over_lr']:.2e} lr "
           f"({res['update_worst'] or '-'}; tol {res['update_size_limit_over_lr']:.2e} lr)"
           if pooled else
           f"update err {res['update_err_over_lr']:.2e} lr ({res['update_worst']}; tol "
           f"{TINY_UPDATE_TOL} lr)")
        + f", every update within {res['update_max_over_lr']:.2e} lr (tol 2 lr); "
        f"outside: {failures or 'none'}")


def planted_faults():
    """name -> (module, attribute, replacement): a kernel wrapper broken on
    purpose, which the tiny step's comparison must catch."""
    import importlib

    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.attention import dropout_mask

    qa = importlib.import_module("ct_clip_tpu_torch.ops.qknorm_attention")
    ffn = importlib.import_module("ct_clip_tpu_torch.ops.ffn")
    k9, k11, k15 = qa._qknorm_attention_bwd_cuda, ffn._geglu_ff_bwd_cuda, K.vq_cluster_stats
    tc_bwd, peg_fwd = K.attention_tc_bwd, K.peg_fwd

    def k12a_no_rowsum(q, k, v, dout, lse, **kw):
        # the key-bias backward with D_i forced to 0, so dS = P dA: the
        # kernel's gradients plus the P D terms that D_i's omission adds
        # (the class of fault whose dkey_bias rows leave their zero sum)
        dq, dk, dv, db, dkb = tc_bwd(q, k, v, dout, lse, **kw)
        kb = kw.get("key_bias")
        if kb is None:
            return dq, dk, dv, db, dkb
        qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
        p = torch.exp(qf @ kf.transpose(-1, -2) + kb[:, None, None, :] - lse[..., None])
        da = gf @ vf.transpose(-1, -2)
        if kw.get("rate"):
            da = da * dropout_mask(kw["seed"], *q.shape[:3], kw["rate"], q.device)
        extra = p * (p * da).sum(-1, keepdim=True)
        dq = (dq.float() + extra @ kf).to(dq.dtype)
        dk = (dk.float() + extra.transpose(-1, -2) @ qf).to(dk.dtype)
        return dq, dk, dv, db, None if dkb is None else dkb + extra.sum(dim=(1, 2))

    def k9_no_dbias(*a, **kw):
        g = k9(*a, **kw)
        return g[:-1] + (None if g[-1] is None else torch.zeros_like(g[-1]),)

    def k11_dwo_high(*a, **kw):
        g = k11(*a, **kw)
        return g[:-1] + (g[-1] * 1.05,)

    def k15_drop_fullest(x, ids, codes):
        bins, esum = k15(x, ids, codes)
        c = int(bins.argmax())
        bins[c], esum[c] = 0.0, 0.0
        return bins, esum

    def peg_rotated_frame_pads(x, weight, bias, pads, rotated):
        # the rotated form (the temporal stage on the cubic grid) with the
        # frame-causal leading pads (2, 1, 1) in place of its (1, 2, 1)
        return peg_fwd(x, weight, bias, (2, 1, 1) if rotated else pads, rotated)
    return {"K9 without the bias gradient": (qa, "_qknorm_attention_bwd_cuda", k9_no_dbias),
            "K11 with dW_out 5% high": (ffn, "_geglu_ff_bwd_cuda", k11_dwo_high),
            "K15 dropping its fullest code": (K, "vq_cluster_stats", k15_drop_fullest),
            "K12a with D_i forced to 0": (K, "attention_tc_bwd", k12a_no_rowsum),
            "the PEG stencil's rotated form with the frame-causal pads":
                (K, "peg_fwd", peg_rotated_frame_pads)}


def tiny_sides(cfg, tcfg, seed: int = 8):
    """(side(device, dtype), start state) of the tiny CT-CLIP step of `cfg`
    from the weights of init seed `seed` (tiny_step_check's is 8), the
    codebook at the CPU's own tokens."""
    import torch

    from ct_clip_tpu_torch.models import CTCLIP

    inputs = tiny_ctclip_inputs()
    cpu = CTCLIP(cfg, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(seed))
    seed_codebook_at_tokens(cpu.visual_transformer, inputs[2])
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    return (lambda device, dtype: tiny_ctclip_side(cfg, tcfg, start, inputs, device,
                                                   dtype)), start


def cpu_noise_sides(cfg, tcfg, seeds):
    """The tiny step's (c, c32, start) on the CPU in bf16 and in f32 at each
    init seed of `seeds`, one seed at a time: the CPU's own noise to pool
    (`pooled_cpu_noise`)."""
    import torch

    cpu = torch.device("cpu")
    for seed in seeds:
        side, start = tiny_sides(cfg, tcfg, seed)
        yield side(cpu, torch.bfloat16), side(cpu, torch.float32), start


def tiny_step_check(dev, cfg, faults, label: str, noise_seeds=None):
    """One training step of the tiny CT-CLIP `cfg` (both dropouts 0, batch 4)
    from the same weights on the card (kernels) and on the CPU (plain
    versions), both bf16 compute with f32 parameters, lr 1e-3, and on the
    CPU in f32.  The two bf16 sides round at nearly the same points and sum
    in other orders (the kernels keep P, dxn and the weight gradients in f32
    where the plain chain rounds them to bf16); at this random init every
    gradient of a bf16 step lies a few % from the f32 step's (LayerNorm,
    l2norm and the temperature's gradients are sums whose terms cancel).
    Held: the loss within TINY_LOSS_TOL relative; each gradient's L2
    distance card-CPU within TINY_GRAD_RATIO times the CPU's own bf16-f32
    distance; the parameters whose true gradient is zero within
    TINY_ZERO_TOL of the largest gradient; every VQ id (the codebook starts
    at the CPU's own tokens, so each id is a clear top-1), the cluster sizes
    within 1e-6 and the codebook after the EMA within 1e-2; the update of
    each entry whose gradient is above 2e-1 of its tensor's largest within
    TINY_UPDATE_TOL lr (Adam's first step is lr g / (|g| + eps), so a
    gradient's relative difference reaches the step only through eps),
    every entry within 2 lr.  With `noise_seeds` (more init seeds), the card
    is held to the f32 step with the CPU's own noise pooled over those seeds
    and this one (see compare_tiny_steps).  Then the same card step with each
    planted fault (`faults`: name -> (module, attribute, replacement[, the
    check it must fail])) must fall outside these limits.  Returns (readings, the card side, the start
    state, the train config)."""
    from ct_clip_tpu_torch.config import TrainConfig

    lr = 1e-3
    tcfg = TrainConfig(lr=lr)
    side, start = tiny_sides(cfg, tcfg)
    more = None if noise_seeds is None else (lambda: cpu_noise_sides(cfg, tcfg, noise_seeds))
    res, gp = card_vs_cpu(dev, side, start, lr, faults, label, more)
    return res, gp, start, tcfg


def seed_codebook_at_tokens(vt, video) -> None:
    """Codes at the tokens of `video` (the CTViT's training embed and
    encode, on the CPU): every id a clear top-1 on both sides."""
    import torch

    with torch.no_grad():
        tokens = vt.encode(vt.embed_patches(video, train=True)).float()
        tokens = tokens.reshape(-1, vt.config.dim)
        vt.vq._codebook.embed[: tokens.shape[0]] = tokens / tokens.norm(dim=-1, keepdim=True)


def card_vs_cpu(dev, side, start: dict, lr: float, faults, label: str,
                noise_sides=None,
                vq_prefix: str = "visual_transformer.vq._codebook.",
                grad_ratio: float = TINY_GRAD_RATIO):
    """`side(device, dtype)` on the CPU in bf16 and f32 and on the card in
    bf16, held by `compare_tiny_steps`; then the card side again with each
    planted fault, which must fail (where its tuple names a check, that
    one).  `noise_sides`: a callable giving the
    (c, c32, start) CPU sides at more init seeds, over which the CPU's own
    noise is pooled with this seed's (`pooled_cpu_noise`), or None.
    Returns (readings, the card side)."""
    import torch

    bf, cpu_dev = torch.bfloat16, torch.device("cpu")
    c, c32, gp = side(cpu_dev, bf), side(cpu_dev, torch.float32), side(dev, bf)
    pooled = None if noise_sides is None else pooled_cpu_noise(
        itertools.chain([(c, c32, start)], noise_sides()), lr)
    held = dict(pooled=pooled, vq_prefix=vq_prefix, grad_ratio=grad_ratio)
    res, failures = compare_tiny_steps(c, c32, gp, start, lr, **held)
    _log_tiny(f"{label}, kernels as built", res, failures)
    if failures:
        raise AssertionError(f"tiny {label} training step: card and CPU disagree on "
                             f"{failures}: {res}")
    res.update(metrics_gpu=gp["metrics"], metrics_cpu=c["metrics"], faults={})
    for name, (module, attr, broken, *must) in faults.items():
        with replaced(module, attr, broken):
            fres, ffail = compare_tiny_steps(c, c32, side(dev, bf), start, lr, **held)
        _log_tiny(f"{label}, planted fault: {name}", fres, ffail)
        if not ffail or not set(must) <= set(ffail):
            raise AssertionError(f"tiny {label} training step: planted fault '{name}' "
                                 f"passes the limits{' of ' + must[0] if must else ''}: {fres}")
        res["faults"][name] = dict(outside=ffail, **{k: fres[k] for k in (
            "grad_ratio", "grad_worst", "grad_top", "cluster_size_abs", "codebook_abs",
            "update_err_over_lr", "update_sign_flips_over") if k in fres})
    return res, gp


def ctclip_train_reference_phase(dev, work: Path) -> dict:
    """`tiny_step_check` of the tiny CT-CLIP with the three planted faults of
    `planted_faults`.  Last, a save -> restore round trip on the card: the
    restored state and one more step from it equal the original's."""
    import torch

    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CheckpointManager, create_train_state, make_train_step

    cfg = tiny_ctclip_config()
    res, gp, start, tcfg = tiny_step_check(dev, cfg, planted_faults(), "CT-CLIP")
    # save -> restore on the card, then one more step on both
    st = gp["state"]
    mgr = CheckpointManager(str(work / "tiny_ckpt"))
    mgr.save(1, st)
    other = CTCLIP(cfg, dtype=torch.bfloat16, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(9))
    restored = mgr.restore(create_train_state(other, tcfg))
    restored_step = restored.step
    same_state = all(torch.equal(v, restored.model.state_dict()[k])
                     for k, v in st.model.state_dict().items())
    step = make_train_step(tcfg)
    m1, m2 = step(st, gp["batch"]), step(restored, gp["batch"])
    resume_diff = max((v.float() - restored.model.state_dict()[k].float()).abs().max().item()
                      for k, v in st.model.state_dict().items() if v.numel())
    log(f"reference: save -> restore on the card: state equal {same_state}, step "
        f"{restored_step}; the next step's loss {m1['loss'].item():.6f} vs "
        f"{m2['loss'].item():.6f}, weights max diff after it {resume_diff:.2e} (tol 1e-6)")
    if not same_state or restored_step != 1 or resume_diff > 1e-6:
        raise AssertionError("tiny CT-CLIP save -> restore round trip differs")
    res.update(resume_state_equal=same_state, resume_next_step_max_diff=resume_diff)
    return res


# ---------------------------------------------------------------- phase 7
# kernel-name fragments of an aux-objective step's groups (first match),
# ahead of the CT-CLIP step's
AUX_GROUPS = (
    ("K16a NT recompute and NN with the LN(4000) sums on the tensor cores (ffn_tc.cu: "
     "ff_tc_gemm<0, 1>, <0, 2>; its TN dW counts with K11's products)",
     ("ff_tc_gemm<0, 1>", "ff_tc_gemm<0, 2>")),
    ("K16a LN(4000) backward through the patch gather (ln_bwd_kernel<bf16, true>; with "
     "d(volume))", ("ln_bwd_kernel<__nv_bfloat16, true>",)),
    ("K6/K17 rearrange (rearrange_kernel, unrearrange_runs_kernel)",
     ("rearrange_kernel", "unrearrange_runs_kernel")),
    ("BatchNorm of the SSL heads", ("batch_norm",)),
    # cuBLAS's f32 kernels; cuDNN's PEG kernels are also named "..._sgemm"
    ("f32 products: SSL heads, MLM head (cuBLAS)", ("_f32f32_", "simt_sgemm")),
) + CTCLIP_GROUPS


def embed_grad_phase(dev) -> dict:
    """The inference embeds under grad at full width, batch 1: on a volume
    (K8, backward K16a and, the volume requiring grad, K17) and on its patch
    rows (K4, backward K16b with d(rows)).  Each of the six to_patch_emb
    weights must get a gradient within BWD_REL_TOL of the training
    composition's (autograd of the plain LN-proj-LN, after K6 on the
    volume), and the input a finite, nonzero one."""
    import torch

    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_plain

    g = torch.Generator(device=dev).manual_seed(41)
    vt = CTViT(CTViTConfig(), dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        for prm in vt.to_patch_emb.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=g, device=dev))
    video = (torch.rand((1, 240, 480, 480, 1), generator=g, device=dev) * 2 - 1).to(
        torch.bfloat16)
    inputs = {"volume": video, "rows": rearrange_plain(video[..., 0], 10, 20)}
    dout = torch.randn((1, 24, 24, 24, 512), generator=g, device=dev).to(torch.bfloat16)

    def grads(train: bool):
        out = {}
        for route, x in inputs.items():
            x = x.detach().requires_grad_()
            vt.zero_grad()
            vt.embed_patches(x, train=train).backward(dout)
            out[route] = (x.grad, [p.grad.clone() for p in vt.to_patch_emb.parameters()])
        return out
    got, counts, _ = drive("embed_grad", lambda: grads(False))
    ref = grads(True)
    res = {}
    for route in inputs:
        dx, dw = got[route]
        errs = [(a - r).abs().max().item() / r.abs().max().item()
                for a, r in zip(dw + [dx], ref[route][1] + [ref[route][0]])]
        finite = torch_finite(dx) and dx.abs().max().item() > 0
        res[route] = dict(weight_rel_err=max(errs[:-1]), input_rel_err=errs[-1],
                          input_grad_finite_nonzero=finite)
        log(f"embed under grad ({route}): six weight gradients within "
            f"{max(errs[:-1]):.3e} of the training composition's, input gradient "
            f"{errs[-1]:.3e} (tol {BWD_REL_TOL}), finite and nonzero {finite}")
        if not finite or max(errs) > BWD_REL_TOL:
            raise AssertionError(f"embed under grad ({route}): {res[route]}")
    del vt, inputs, got, ref
    torch.cuda.empty_cache()
    return dict(counts=counts, **res)


def aux_train_phase(dev, work: Path, card: str, corpus, base_counts) -> dict:
    """`CTClipTrainer` at full width, batch AUX_B, on phase 6's corpus: (a)
    visual SSL (SimSiam, temporal tap) with MLM, 3 steps, a mini evaluation
    and a checkpoint at step 3; (b) FILIP (dim_image 512) with SimCLR on the
    pooled tap, 2 steps.  Each run's counters must rise, the volumes must go
    in as volumes, K13 must launch twice per layer and step with MLM (once
    in phase 6's `base_counts`), K16a once per view and step and K6 once per
    step; then the step time, peak memory and a profiled step."""
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig, TrainConfig
    from ct_clip_tpu_torch.data import CTReportDataset, CTReportDatasetInfer, WordPieceTokenizer
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CTClipTrainer

    train, valid, vocab = corpus
    tok = WordPieceTokenizer(vocab)
    base_rate = base_counts["attention_dropout"] / 4  # phase 6: 4 steps
    runs = {}
    for name, kw, steps, evaluate in (
            ("ctclip_aux_ssl_mlm", dict(use_visual_ssl=True, use_mlm=True), 3, True),
            ("ctclip_aux_filip_simclr", dict(use_all_token_embeds=True, dim_image=512,
                                             use_visual_ssl=True, visual_ssl_type="simclr",
                                             visual_ssl_tap="pooled"), 2, False)):
        cfg = CTCLIPConfig(**kw)
        model = CTCLIP(cfg, dtype=torch.bfloat16, device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(0))
        results = work / name
        every = steps if evaluate else 10 ** 9
        trainer = CTClipTrainer(
            model, tok, train_dataset=CTReportDataset(*train[:3]),
            valid_dataset=CTReportDatasetInfer(*valid) if evaluate else None,
            config=TrainConfig(batch_size=AUX_B, save_results_every=every,
                               save_model_every=every),
            results_folder=str(results), num_workers=4)
        if trainer.patch_rows:
            raise AssertionError(f"{name}: visual SSL must ingest volumes, not patch rows")
        _, counts, secs = drive(name, lambda: trainer.train(steps))
        recs = [json.loads(x) for x in (results / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["mini_eval_mean_auc"] for r in recs if "mini_eval_mean_auc" in r]
        ckpts = sorted(p.name for p in (results / "checkpoints").glob("*.pt"))
        k13_rate = counts["attention_dropout"] / steps
        k13 = (2 if cfg.use_mlm else 1) * BERT_LAYERS * steps
        # K16a: one per view and step, each with its LN sums in the product's epilogue
        want = dict(patch_embed_bwd=2 * steps, ff_tc_ln_sums=2 * steps,
                    rearrange_patches=steps, attention_dropout=k13,
                    attention_dropout_bwd=k13, attention_tc_bwd=k13,
                    # every forward (K13a, the mini evaluation's K7) on the tensor cores
                    attention_tc=k13 + counts["fused_attention"])
        log(f"{name}: {steps} steps of {AUX_B} at full width in {secs:.1f} s (host clock: "
            f"build, ingest, evaluation and checkpoint included); losses {losses}; grad norms "
            f"{[round(r['grad_norm'], 4) for r in recs if 'loss' in r]}; mini-eval mean AUC "
            f"{evals}; checkpoints {ckpts}; K13 launches per step {k13_rate} (phase 6: "
            f"{base_rate})")
        bad = [k for k, v in want.items() if counts[k] != v]
        if len(losses) != steps or not np.isfinite(losses).all() or bad \
                or (evaluate and (evals == [] or ckpts != [f"step_{steps}.pt"]
                                  or not (results / f"mini_eval_step{steps}.csv").exists())) \
                or k13_rate != (2 if cfg.use_mlm else 1) * base_rate:
            raise AssertionError(f"{name}: losses {losses}, evals {evals}, ckpts {ckpts}, "
                                 f"counters off {[(k, counts[k], want[k]) for k in bad]}")
        shutil.rmtree(results / "checkpoints", ignore_errors=True)
        batch = next(trainer._batches())
        timed = timed_steps(trainer.step_fn, trainer.state, batch, card, name, AUX_B,
                            AUX_GROUPS)
        runs[name] = dict(counts=counts, losses=losses, mini_eval_mean_auc=evals,
                          k13_launches_per_step=k13_rate, cli_s=secs, **timed)
        del trainer, model, batch
        torch.cuda.empty_cache()
    return runs


def tiny_aux_config():
    """The tiny CT-CLIP with FILIP (dim_image = the CTViT width), MLM and
    visual SSL (SimSiam, temporal tap) on, the auxiliary weights raised so
    that their gradients carry weight in every tensor they reach.  With the
    SSL heads' gradient in them, ten tensors' bf16 gradients lie ~20% (L2)
    from the f32 ones on the CPU itself and flip the sign of some of Adam's
    first steps there (a CPU reading), so this check holds the card to the
    f32 step with the CPU's own noise pooled over AUX_NOISE_SEEDS
    (`compare_tiny_steps`).  Its BERT keeps four heads of 16 (K12a on attention_train.cu): with one head
    of 64 the CPU's bf16 gradient of to_visual_latent.weight reads -0.23 of
    its max at an entry where the f32 one reads -0.003, so the card's Adam
    step there flips against the CPU's, with the CUDA-core K12a as with the
    tensor-core one (PERF.md §6, tools/port_tiny_aux_probe.py)."""
    base = tiny_ctclip_config()
    return base.replace(
        dim_image=64, use_all_token_embeds=True, use_mlm=True, use_visual_ssl=True,
        text_ssl_loss_weight=0.3, image_ssl_loss_weight=0.5,
        bert=base.bert.replace(num_attention_heads=4))


def aux_planted_faults():
    """K16a with its LN scale gradient dropped (zeros); and two faults of
    the optimizer step alone, which leave every gradient as it is, so only
    the update checks can catch them (the fourth element: the check each
    must fail): Adam's first step without its first moment's bias
    correction (0.1 lr g / (|g| + eps), every size 0.9 lr off), and
    to_text_latent.weight stepped up its gradient (every sign flipped)."""
    import importlib

    import torch

    pe = importlib.import_module("ct_clip_tpu_torch.ops.patch_embed")
    train = importlib.import_module("ct_clip_tpu_torch.train")
    k16a, create = pe._patch_embed_bwd_cuda, train.create_train_state

    def k16a_no_ds1(*a, **kw):
        g = list(k16a(*a, **kw))
        g[1] = torch.zeros_like(g[1])
        return tuple(g)

    def with_step(move):
        """create_train_state whose optimizer step ends with
        `move(model, before)`, `before` the parameters ahead of it."""
        def broken(model, cfg):
            state = create(model, cfg)
            step = state.optimizer.step

            def stepped():
                before = {n: p.detach().clone() for n, p in model.named_parameters()}
                norm = step()
                with torch.no_grad():
                    move(model, before)
                return norm
            state.optimizer.step = stepped
            return state
        return broken

    def no_first_moment_correction(model, before):
        beta1 = 0.9  # train/optimizer.py's betas
        for n, p in model.named_parameters():
            p.copy_(before[n] + (1 - beta1) * (p - before[n]))

    def text_latent_ascent(model, before):
        p = model.to_text_latent.weight
        p.copy_(2 * before["to_text_latent.weight"] - p)
    return {"K16a without ds1": (pe, "_patch_embed_bwd_cuda", k16a_no_ds1),
            "Adam without the first moment's bias correction":
                (train, "create_train_state", with_step(no_first_moment_correction), "updates"),
            "to_text_latent.weight stepping up its gradient":
                (train, "create_train_state", with_step(text_latent_ascent), "update signs")}


# ---------------------------------------------------------------- phase 8
AE_B = 8  # volumes per CTViT autoencoder batch (GenerateCT stage 1)
AE_FRAMES = 200  # the data layer's 201 frames cut to whole temporal patches (t = 20)
CLIP160_B = 8  # CT-CLIP contrastive batch at 160 frames
# the tiny autoencoder's gradient limit: K9/K10 round P and dS to bf16 before
# their products, as the TPU kernels do (_bwd_kernel :176, :189), where the
# plain autograd keeps dS in f32; the decoder's spatial QK-scale gradients,
# sums over 90 tokens that cancel, carry that rounding: on an H100 80GB HBM3
# they read 1.35x the CPU's bf16-f32 distance (every other tensor <= 1.22),
# the planted K10 fault > 10
TINY_AE_GRAD_RATIO = 1.5
# kernel-name fragments of an autoencoder step's groups (first match)
AE_GROUPS = (("K6/K17 rearrange (rearrange_kernel, unrearrange_runs_kernel)",
              ("rearrange_kernel", "unrearrange_runs_kernel")),) + CTCLIP_GROUPS


def ae_config():
    """The CTViT autoencoder at full width on GenerateCT's 200 x 128 x 128
    volumes: patch 16, temporal patch 10, (t, h, w) = (20, 8, 8), patch_dim
    2,560; dim 512, 8192 codes, 4 + 4 layers each way, 8 heads x 32."""
    from ct_clip_tpu_torch.config import CTViTConfig

    return CTViTConfig(image_size=128, patch_size=16, temporal_patch_size=10,
                       num_frames=AE_FRAMES, with_decoder=True)


def seq_kernel_cases(dev):
    """K2 and K10 in sequence-major form at CT-CLIP's 160-frame batch of 8,
    (4608, 16, 512), and at the autoencoder's batch of 8, (512, 20, 512);
    K1 and K9 on the autoencoder's (160, 64, 512) planes with the (8, 64,
    64) bias (K9 with the replaced CUDA-core core timed beside), and K9's
    core alone there (`qk_core_case`).  Each as train_kernel_cases gives
    them."""
    import torch

    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_small_qknorm_attention, fused_spatial_qknorm_attention,
        qknorm_attention_bwd_plain, qknorm_attention_plain, small_qknorm_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(50)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd = 512, 8, 32, 256
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
         rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2),
         rn(dim, hd, scale=hd ** -0.5))

    def pair(name, S, n, bias):
        x, do = rn(S, n, dim, dtype=bf), rn(S, n, dim, dtype=bf)
        rows = S * n
        core = 4 * S * heads * n * n * dh
        extra = () if bias is None else (bias,)
        if bias is None:
            fwd = lambda *a: fused_small_qknorm_attention(*a, heads, dh)  # noqa: E731
        else:
            fwd = lambda *a: fused_spatial_qknorm_attention(*a, heads, dh)  # noqa: E731
        kern_fwd = lambda: fwd(x, *w, *extra)  # noqa: E731
        # the replaced path: K1 (a bias) the core on attention.cu's CUDA
        # cores; K2 that and gemm.cu's products
        twin = dict(twin=cuda_core_k2(kern_fwd), twin_source=K2_REPLACED) if bias is None \
            else dict(twin=cuda_core_k9(kern_fwd), twin_source=K1_REPLACED)
        yield name, dict(kern=kern_fwd, **twin,
                         plain=lambda: qknorm_attention_plain(x, *w, bias, heads, dh),
                         library=None, inputs=(x, *w, *extra), outputs=(x,),
                         flops=2 * rows * dim * 4 * hd + core, tol=REL_TOL)
        leaves = [t.clone().requires_grad_() for t in (x, *w, *extra)]
        out = fwd(*leaves)
        kern = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        # the replaced path timed beside: gemm.cu's products (K9's core as
        # now; K10's on the CUDA cores at K9's rounding points, which must
        # miss K10's mean tolerance)
        if bias is None:
            check = dict(plain=lambda: small_qknorm_bwd_plain(x, *w, do, heads, dh),
                         check=k10_bf16_check(name + "_bwd"), twin_source=K10_REPLACED,
                         twin_must_miss=True, bit_identical=True)
        else:
            check = dict(plain=lambda: tuple(t for t in qknorm_attention_bwd_plain(
                x, *w, bias, do, heads, dh) if t is not None), tol=BWD_REL_TOL,
                twin_source=K9_REPLACED)
        yield name + "_bwd", dict(
            kern=kern, twin=replaced_qk_bwd_bf16(kern), **check,
            library=None, inputs=(x, do, *w, *extra), outputs=(x, *w, *extra),
            flops=2 * rows * dim * hd * 11 + 3 * core)

    yield from pair("seq_attention", CLIP160_B * 576, 16, None)
    yield "grid_attention_bwd_short_seq16", short_core_bf16_case(dev, g, w, CLIP160_B * 576,
                                                                 16, 1)
    yield from pair("seq_attention_generatect", AE_B * 64, 20, None)
    yield "grid_attention_bwd_short_generatect", short_core_bf16_case(dev, g, w, AE_B * 64, 20,
                                                                      1)
    yield from pair("spatial_attention_n64", AE_B * AE_FRAMES // 10, 64, rn(heads, 64, 64))
    yield "spatial_attention_n64_bwd_tc", qk_core_case(dev, g, AE_B * AE_FRAMES // 10, 64)


def write_volumes(root: Path, n: int, shape, seed: int):
    """n NIfTI volumes (x, y, z) of int16 HU: smooth structure plus noise."""
    from ct_clip_tpu_torch.data import write_volume

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(n):
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        f = rng.uniform(1, 4, 3) * 2 * np.pi
        vol = (600 * np.sin(f[0] * x / shape[0] + i) * np.cos(f[1] * y / shape[1])
               + 300 * np.sin(f[2] * z / shape[2]) + rng.normal(0, 50, shape))
        write_volume(root / f"vol_{i}.nii.gz", vol.astype(np.int16), (1.0, 1.0, 1.0))
    return root


def cuda_step_ms(fn, steps: int):
    """CUDA-event times (ms) of `steps` calls of fn."""
    import torch

    out = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _no_grid_path(name: str, counts) -> None:
    if any(counts[k] for k in GRID_COUNTERS):
        raise AssertionError(f"{name}: a non-cubic grid took the grid form: {counts}")


def ctvit_ae_phase(dev, work: Path, card: str, dtype: str = "bf16") -> dict:
    """The CTViT autoencoder at full width, batch AE_B, in bf16 or in f32
    (CTViT(ae_config(), dtype=float32), the JAX package's default), on a synthetic
    GenerateCT corpus of 201 x 128 x 128 NIfTIs through VideoDataset(
    num_frames=200): `CTViTTrainer` 3 generator-only steps, whose losses
    must be finite and below step 1's, then one round with the
    discriminator (3 generator steps and a discriminator step); the
    sequence-major counters must rise and the grid ones not (in f32, K9 f32
    runs at n = 64).  Then the launches per generator step, the step times
    (CUDA events, median), peak memory, a profiled generator step, a .pt
    save -> restore round trip and one `dump_reconstruction` NIfTI."""
    import torch

    from ct_clip_tpu_torch.data import read_volume
    from ct_clip_tpu_torch.data.generatect import VideoDataset
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops import vq as vq_mod
    from ct_clip_tpu_torch.train import CTViTTrainer

    f32 = dtype == "f32"
    tag, model_dtype = ("_f32", torch.float32) if f32 else ("", torch.bfloat16)
    groups = F32_TRAIN_GROUPS if f32 else AE_GROUPS
    cfg = ae_config()
    ds = VideoDataset(str(write_volumes(work / f"generatect{tag}", AE_B, (128, 128, 201), 6)),
                      num_frames=AE_FRAMES, image_size=cfg.image_size)
    t0 = time.perf_counter()
    video = torch.from_numpy(np.stack([ds[i] for i in range(len(ds))]))[..., None].to(dev)
    ingest_s = time.perf_counter() - t0
    if video.shape != (AE_B, AE_FRAMES, 128, 128, 1):
        raise AssertionError(f"ctvit ae: bad batch {tuple(video.shape)}")
    model = CTViT(cfg, dtype=model_dtype, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    results = work / f"ctvit_ae{tag}"
    trainer = CTViTTrainer(model, results_folder=str(results), save_model_every=10 ** 9,
                           save_results_every=10 ** 9)
    counts = {}
    train_path, discr_path = f"ctvit_ae{tag}_train", f"ctvit_ae{tag}_discr"
    vq_rows, stats = [], vq_mod.cluster_stats

    def recorded(x, ids, codes):  # the third step's statistics: K15's "ae" ids (k15_ae_cases)
        vq_rows[:] = [(x.detach().clone(), ids.to(torch.int32).clone())]
        return stats(x, ids, codes)
    with replaced(vq_mod, "cluster_stats", recorded):
        logs, counts[train_path], secs = drive(
            train_path, lambda: [trainer.train_step(video) for _ in range(3)])
    losses = [x["loss"] for x in logs]
    per_step = {k: counts[train_path][k] / 3 for k in PATHS[train_path]}
    log(f"ctvit ae {dtype}: {AE_B} volumes of {AE_FRAMES}x128x128 ingested in {ingest_s:.2f} s "
        f"(host: NIfTI decode + resize); 3 generator steps in {secs:.2f} s; losses "
        f"{losses}; recon {[x['recon_loss'] for x in logs]}; commit "
        f"{[x['commit_loss'] for x in logs]}; launches per step {per_step}")
    if not np.isfinite(losses).all() or not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"ctvit ae {dtype}: losses not finite and falling: {losses}")
    _no_grid_path(train_path, counts[train_path])
    dtrainer = CTViTTrainer(model, use_discr=True, results_folder=str(results / "discr"),
                            save_model_every=10 ** 9, save_results_every=10 ** 9)
    dlogs, counts[discr_path], _ = drive(discr_path, lambda: dtrainer.train_step(video))
    log(f"ctvit ae {dtype} with the discriminator: {dlogs}")
    if not np.isfinite(list(dlogs.values())).all():
        raise AssertionError(f"ctvit ae {dtype} discriminator round: {dlogs}")
    _no_grid_path(discr_path, counts[discr_path])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen_ms = cuda_step_ms(lambda: trainer.train_step(video), 4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    round_ms = cuda_step_ms(lambda: dtrainer.train_step(video), 2)
    gen = statistics.median(gen_ms[1:])
    log(f"ctvit ae step: batch {AE_B} x {AE_FRAMES}x128x128 (1,280 tokens each), full width, "
        f"{dtype}: median {gen:.2f} ms of generator steps 2-4 {[round(t, 2) for t in gen_ms]} = "
        f"{AE_B / gen * 1e3:.2f} volumes/s, peak memory {peak_gb:.2f} GB; a round with the "
        f"discriminator (3 generator steps + 1) {[round(t, 2) for t in round_ms]} ms on {card}")
    breakdown = profile_step(lambda: trainer.train_step(video), groups, f"ctvit_ae{tag}")

    path = trainer.ckpt.save(trainer.state.step, trainer.state)
    other = CTViTTrainer(CTViT(cfg, dtype=model_dtype, device=dev),
                         results_folder=str(results / "restored"))
    trainer.ckpt.restore(other.state)
    same = all(torch.equal(t, other.state.model.state_dict()[k])
               for k, t in trainer.state.model.state_dict().items()) and all(
        torch.equal(t, other.state.ema_model.state_dict()[k])
        for k, t in trainer.state.ema_model.state_dict().items())
    dump = trainer.dump_reconstruction(video)
    arr = read_volume(dump)[0]
    log(f"ctvit ae {dtype}: checkpoint {path.name} ({path.stat().st_size / 1e6:.1f} MB) restored equal "
        f"{same} at step {other.state.step}; reconstruction dump {dump.name} {arr.shape}, "
        f"finite {bool(np.isfinite(arr).all())}")
    if not same or other.state.step != trainer.state.step or arr.shape != (128, 128, AE_FRAMES) \
            or not np.isfinite(arr).all():
        raise AssertionError(f"ctvit ae {dtype}: checkpoint round trip or reconstruction "
                             "dump failed")
    del trainer, dtrainer, other, model, video
    torch.cuda.empty_cache()
    return dict(counts=counts, vq_rows=vq_rows[0], losses=losses, discr_round=dlogs,
                ingest_s=ingest_s,
                launches_per_step=per_step,
                step_ms=gen, step_ms_all=gen_ms, round_with_discr_ms=round_ms,
                volumes_per_s=AE_B / gen * 1e3, peak_gb=peak_gb, step_breakdown=breakdown,
                checkpoint_mb=path.stat().st_size / 1e6)


def reconstruct_phase(dev, work: Path, card: str) -> dict:
    """`cli reconstruct` at its default geometry (CTViTConfig(with_decoder=
    True): 240 x 480 x 480, the cubic 24^3 grid, so the grid path) on two
    synthetic volumes with seeded weights: two finite (480, 480, 240)
    NIfTIs."""
    import torch

    from ct_clip_tpu_torch import cli
    from ct_clip_tpu_torch.data import read_volume

    data = write_volumes(work / "reconstruct", 2, (256, 256, 120), 7)
    out = work / "reconstructions"
    files, counts, secs = drive("reconstruct", lambda: cli.main(
        ["--device", "cuda", "--seed", "0", "reconstruct", "--data", str(data),
         "--results", str(out)]))
    arrs = [read_volume(f)[0] for f in files]
    log(f"reconstruct: {len(files)} volumes at 240x480x480 in {secs:.2f} s (host clock: model "
        f"build, NIfTI decode and resize, NIfTI write included) on {card}; "
        f"{[a.shape for a in arrs]}")
    if len(arrs) != 2 or any(a.shape != (480, 480, 240) or not np.isfinite(a).all()
                             for a in arrs) or any(counts[k] for k in SEQ_COUNTERS):
        raise AssertionError("reconstruct: bad reconstructions or a sequence-major launch")
    torch.cuda.empty_cache()
    return dict(counts=counts, cli_s=secs)


def ctclip_160_phase(dev, work: Path, card: str, corpus) -> dict:
    """CT-CLIP with CTViTConfig(num_frames=160), (t, h, w) = (16, 24, 24):
    `CTClipTrainer` one contrastive step at batch 8 on phase 6's corpus
    (ingested to 160 x 480 x 480), the step time, peak memory and profile,
    then one scored zero-shot batch of 2 on its patch rows; the
    sequence-major counters must rise and the grid ones not."""
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig, CTViTConfig, TrainConfig
    from ct_clip_tpu_torch.data import CTReportDataset, WordPieceTokenizer
    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CTClipTrainer

    train, _, vocab = corpus
    tok = WordPieceTokenizer(vocab)
    model = CTCLIP(CTCLIPConfig(ctvit=CTViTConfig(num_frames=160)), dtype=torch.bfloat16,
                   device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    trainer = CTClipTrainer(model, tok, train_dataset=CTReportDataset(*train[:3]),
                            config=TrainConfig(batch_size=CLIP160_B,
                                               save_results_every=10 ** 9,
                                               save_model_every=10 ** 9),
                            results_folder=str(work / "ctclip_160"), num_workers=4)
    counts = {}
    _, counts["ctclip_160_train"], secs = drive("ctclip_160_train", lambda: trainer.train(1))
    _no_grid_path("ctclip_160_train", counts["ctclip_160_train"])
    batch = next(trainer._batches())
    want = (CLIP160_B, 16 * 576, 4000) if trainer.patch_rows else (CLIP160_B, 160, 480, 480, 1)
    if batch["video"].shape != want:
        raise AssertionError(f"ctclip 160: bad batch {tuple(batch['video'].shape)}")
    timed = timed_steps(trainer.step_fn, trainer.state, batch, card, "ctclip_160", CLIP160_B)
    model.eval()
    rows = batch["video"][:2]
    with torch.inference_mode():
        probs, counts["zero_shot_160"], _ = drive(
            "zero_shot_160", lambda: ZeroShotClassifier(model, tok).score_batch(rows))
        batch_ms = cuda_ms(lambda: ZeroShotClassifier(model, tok).score_batch(rows), reps=3)
    _no_grid_path("zero_shot_160", counts["zero_shot_160"])
    probs = probs.float().cpu().numpy()
    log(f"ctclip 160 frames: 1 step of {CLIP160_B} in {secs:.1f} s (host clock, ingest "
        f"included); zero-shot P(present) {probs.shape} in [{probs.min():.4f}, "
        f"{probs.max():.4f}], score_batch(2) {batch_ms:.2f} ms (prompts encoded in it) on {card}")
    if probs.shape != (2, 18) or not np.isfinite(probs).all():
        raise AssertionError(f"ctclip 160: bad zero-shot probabilities {probs.shape}")
    del trainer, model, batch, rows
    torch.cuda.empty_cache()
    return dict(counts=counts, train_cli_s=secs, score_batch_ms_with_prompts=batch_ms, **timed)


def tiny_ae_config():
    """A tiny autoencoder on a non-cubic grid: (t, h, w) = (5, 3, 3)."""
    from ct_clip_tpu_torch.config import CTViTConfig

    return CTViTConfig(dim=64, codebook_size=128, image_size=48, patch_size=16,
                       temporal_patch_size=4, num_frames=20, spatial_depth=2,
                       temporal_depth=2, dim_head=16, heads=4, with_decoder=True)


def tiny_ae_side(cfg, start, video, device, dtype, lr: float, folder: Path) -> dict:
    """From `start` on `device` in `dtype`: the VQ ids, the generator loss
    and every gradient, then one `CTViTTrainer` step from `start`."""
    import torch

    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.train import CTViTTrainer

    v = video.to(device)
    model = CTViT(cfg, dtype=dtype, device=device)
    model.load_state_dict(start)
    trainer = CTViTTrainer(model, lr=lr, results_folder=str(folder))
    with torch.no_grad():
        codes = model(v, train=True, return_recons=True)[1].cpu()
    model.load_state_dict(start)  # the VQ call moved the codebook
    loss, _, _ = trainer.generator_loss(v)
    loss.backward()
    grads = {n: p.grad.float().cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.load_state_dict(start)
    metrics = trainer.train_step(v)
    return dict(loss=loss.item(), grads=grads, codes=codes, metrics=metrics,
                sd={k: t.float().cpu() for k, t in model.state_dict().items()})


def ae_planted_faults():
    """K10's sequence-major form without its dk_scale sum."""
    import importlib

    import torch

    qa = importlib.import_module("ct_clip_tpu_torch.ops.qknorm_attention")
    bwd = qa._qknorm_attention_bwd_cuda

    def k10_seq_no_dks(*a):
        g = bwd(*a)
        bias, grid = a[7], a[-1]
        return g if bias is not None or grid else g[:5] + (torch.zeros_like(g[5]),) + g[6:]
    return {"K10 seq without its dk_scale sum": (qa, "_qknorm_attention_bwd_cuda",
                                                 k10_seq_no_dks)}


def tiny_ae_phase(dev, work: Path) -> dict:
    """One tiny autoencoder generator step, card against CPU (both bf16),
    held as the tiny CT-CLIP step is (`card_vs_cpu`), with the codebook at
    the CPU's own tokens, and the gradients to TINY_AE_GRAD_RATIO; then
    with K10 seq's dk_scale sum dropped, which must fail."""
    import torch

    from ct_clip_tpu_torch.models import CTViT

    cfg, lr = tiny_ae_config(), 1e-3
    video = torch.rand((2, 20, 48, 48, 1), generator=torch.Generator().manual_seed(11)) * 2 - 1
    cpu = CTViT(cfg, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(12))
    seed_codebook_at_tokens(cpu, video)
    start = {k: t.clone() for k, t in cpu.state_dict().items()}
    res, _ = card_vs_cpu(dev, lambda device, dtype: tiny_ae_side(
        cfg, start, video, device, dtype, lr, work / f"tiny_ae_{device.type}"), start, lr,
        ae_planted_faults(), "CTViT autoencoder", vq_prefix="vq._codebook.",
        grad_ratio=TINY_AE_GRAD_RATIO)
    return res


def tiny_ae_short_config():
    """A tiny bf16 autoencoder whose temporal stage takes K10 bf16's short
    route: heads of 32 on a non-cubic (16, 4, 4) grid (16-token sequences,
    `kernels.qk_bwd_route`), as the tiny f32 one of `tiny_f32_configs`."""
    from ct_clip_tpu_torch.config import CTViTConfig

    return CTViTConfig(dim=64, codebook_size=768, image_size=64, patch_size=16,
                       temporal_patch_size=4, num_frames=64, spatial_depth=1, temporal_depth=1,
                       dim_head=32, heads=2, with_decoder=True)


def short_core_checked(fn, record: list):
    """kernels.qk_attention_short_bwd as `fn` computes it (the build, or a
    one-change copy), each bf16 call's merged, dq and dkv held against the
    plain version of the core at the TPU kernel's rounding points
    (`qk_short_bwd_core_plain`) on its own inputs: the mean error of each
    call, over its three outputs the largest, into `record`."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_short_bwd_core_plain

    def call(q, kv, dout, **kw):
        out = fn(q, kv, dout, **kw)
        if kw.get("out_dtype") is not None and kw["out_dtype"] != q.dtype \
                and kw["inner"] == 1:  # the bf16 form on sequences
            ref = qk_short_bwd_core_plain(q, kv, dout, kw["heads"], kw["d"], kw["n"],
                                          kw["q_scale"], kw["k_scale"])
            record.append(max(_mean_rel_error(a, b) for a, b in zip(out[:3], ref[:3])))
        return out
    return call


def tiny_ae_short_phase(dev, work: Path) -> dict:
    """One tiny bf16 autoencoder generator step on K10 bf16's short route
    (`tiny_ae_short_config`), card against CPU as `tiny_ae_phase` holds it,
    every short-core call of the card step also held against its plain
    version on its own inputs (mean error within K2_POINT_TOL of
    mean|plain|); then with the short core's copy rounding P to bf16
    (CT_QK_SHORT_BWD_ROUND_P), which must fail."""
    import functools

    import torch

    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops import kernels as K

    cfg, lr, bf = tiny_ae_short_config(), 1e-3, torch.bfloat16
    video = torch.rand((2, 64, 64, 64, 1), generator=torch.Generator().manual_seed(21)) * 2 - 1
    cpu = CTViT(cfg, dtype=bf).init_weights(torch.Generator().manual_seed(22))
    seed_codebook_at_tokens(cpu, video)
    start = {k: t.clone() for k, t in cpu.state_dict().items()}

    def side(device, dtype):
        return tiny_ae_side(cfg, start, video, device, dtype, lr,
                            work / f"tiny_ae_short_{device.type}")
    c, c32 = side(torch.device("cpu"), bf), side(torch.device("cpu"), torch.float32)
    held = dict(vq_prefix="vq._codebook.", grad_ratio=TINY_AE_GRAD_RATIO)
    copy = K.copy_library("qknorm_attention_short.cu", CT_QK_SHORT_BWD_ROUND_P=1)
    out = {}
    for label, core in (("kernels as built", K.qk_attention_short_bwd),
                        ("planted fault: the short core with P rounded to bf16",
                         functools.partial(K.qk_attention_short_bwd, lib=copy))):
        record = []
        K.reset_launch_counts()
        with replaced(K, "qk_attention_short_bwd", short_core_checked(core, record)):
            gp = side(dev, bf)
        counts = K.launch_counts()
        res, failures = compare_tiny_steps(c, c32, gp, start, lr, **held)
        res["short_core_mean_rel_err"] = max(record) if record else None
        if not record or max(record) > K2_POINT_TOL:
            failures = failures + ["K10 bf16's short core against its plain version"]
        _log_tiny(f"CTViT autoencoder (bf16, K10's short route), {label}", res, failures)
        log(f"reference: tiny bf16 short-route autoencoder, {label}: {len(record)} short-core "
            f"calls, largest mean error {res['short_core_mean_rel_err']} (limit {K2_POINT_TOL}); "
            f"launches qk_attention_short_bwd {counts['qk_attention_short_bwd']}, "
            f"seq_attention_bwd {counts['seq_attention_bwd']}, vq_assign_exact_tc "
            f"{counts['vq_assign_exact_tc']}")
        fault = label != "kernels as built"
        if not fault and (failures or not counts["qk_attention_short_bwd"]
                          or not counts["vq_assign_exact_tc"]):
            raise AssertionError(f"tiny bf16 short-route autoencoder step: card and CPU "
                                 f"disagree on {failures}, launches {counts}: {res}")
        if fault and not failures:
            raise AssertionError(f"tiny bf16 short-route autoencoder step: the planted fault "
                                 f"passes: {res}")
        out[label] = dict(outside=failures, **{k: res[k] for k in (
            "grad_ratio", "grad_worst", "short_core_mean_rel_err") if k in res})
    return out


# ---------------------------------------------------------------- phase 9
MG_B = 8  # MaskGIT training batch: 8 volumes' (20, 8, 8) codes
MG_STEPS = 4
MG_TEXT = 512  # CXR-BERT context tokens
# kernel-name fragments of a MaskGIT step's groups (first match)
MG_GROUPS = (
    ("K12a/K12b backward (attention_train.cu)", ("bwd_dq_kernel<", "bwd_dkv_kernel<",
                                                 "rowdot_kernel<", "dbias_sum_kernel")),
    ("K7 / K7 dense forward (attention_train.cu)", ("::fwd_kernel<",)),
) + CTCLIP_GROUPS


def dense_attention_cases(dev):
    """K7 dense and K12b against their plain versions at MaskGIT's (8, 8,
    1280, 64) with the (1, 8, n, n) CPB bias in bf16 (attention_tc.cu) and
    f32 (both in 3xTF32 on attention_tc32.cu), the TokenCritic's no-bias
    form at that shape in bf16 and f32, T5's (8, 12, 256, 64) with its
    per-head bias in f32 and a ragged n = 1,000 with a one-head bias in bf16
    and f32: each case's kernel call (fused_attention, its backward
    autograd.grad of a kept forward), plain version, library call
    (F.scaled_dot_product_attention with the bias as attn_mask, scale 1; the
    backward its autograd with the bias requiring grad), the tensors it
    reads and writes and its products, at the bf16 tensor-core or (f32,
    three TF32 products per f32 one) the TF32 peak, the f32 CUDA-core bound
    beside it; every case also the replaced CUDA-core kernel on the same
    inputs (`twin`); the f32 cases within TC32_REL_TOL per output,
    bit-identical across runs, and their plain-TF32 copy (`copy`)."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain,
                                                 fused_attention)

    g = torch.Generator(device=dev).manual_seed(90)
    for label, (b, h, n, d), bh, dtype in (
            ("maskgit_bf16", (MG_B, 8, 1280, 64), 8, torch.bfloat16),
            ("critic_bf16", (MG_B, 8, 1280, 64), 0, torch.bfloat16),
            ("maskgit_f32", (MG_B, 8, 1280, 64), 8, torch.float32),
            ("critic_f32", (MG_B, 8, 1280, 64), 0, torch.float32),
            ("t5_f32", (8, 12, 256, 64), 12, torch.float32),
            ("ragged_one_head_bf16", (MG_B, 8, 1000, 64), 1, torch.bfloat16),
            ("ragged_one_head_f32", (MG_B, 8, 1000, 64), 1, torch.float32)):
        q, k, v, do = ((torch.randn((b, n, h, d), generator=g, device=dev)).to(dtype)
                       .transpose(1, 2) for _ in range(4))
        q = q * d ** -0.5
        bias = torch.randn((1, bh, n, n), generator=g, device=dev) if bh else None
        with_bias = () if bias is None else (bias,)
        leaves = [t.detach().requires_grad_() for t in (q, k, v, *with_bias)]
        out = fused_attention(*leaves[:3], bias=leaves[3] if bh else None)
        lib_in = [t.detach().requires_grad_()
                  for t in (q, k, v, *(x.to(dtype) for x in with_bias))]
        lib_out = F.scaled_dot_product_attention(*lib_in[:3], attn_mask=lib_in[3] if bh else None,
                                                 scale=1.0)
        lse = torch.empty((b, h, n), device=dev)  # the residual a backward reads
        product = 2 * b * h * n * n * d
        f32 = dtype == torch.float32
        twin_fwd, twin_bwd = cuda_core_twin(q, k, v, do, bias=bias)

        def kern_fwd():
            return fused_attention(q, k, v, bias)
        fwd = dict(
            kern=kern_fwd, plain=lambda: attention_plain(q, k, v, bias),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias.to(dtype) if bh else None, scale=1.0),
            twin=twin_fwd, inputs=(q, k, v, *with_bias), outputs=(q,))
        if f32:
            fwd.update(flops=3 * 2 * product, peak=PEAK_TF32_FLOPS, f32_flops=2 * product,
                       tols=(TC32_REL_TOL,), bit_identical=True,
                       copies={"attention_tc32.cu in plain TF32":
                               tf32_copy(kern_fwd, "attention_tc32_fwd")})
        else:
            fwd.update(flops=2 * product, peak=PEAK_BF16_FLOPS, tol=REL_TOL)
        yield f"attention_dense@{label}", fwd
        kern = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        bwd = dict(
            kern=kern, plain=lambda: attention_bwd_plain(q, k, v, do, bias)[:4 if bh else 3],
            library=lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True),
            twin=twin_bwd, inputs=(q, k, v, *with_bias, do, lse),
            outputs=(q, k, v, *with_bias))
        if f32:
            bwd.update(flops=3 * 5 * product, peak=PEAK_TF32_FLOPS, f32_flops=5 * product,
                       tols=(TC32_REL_TOL,) * len(leaves), bit_identical=True,
                       copies={"attention_tc32.cu in plain TF32": tf32_copy(kern)})
        else:
            bwd.update(flops=5 * product, peak=PEAK_BF16_FLOPS, tol=BWD_REL_TOL)
        yield f"attention_dense_bwd@{label}", bwd


DENSE_SOURCES = {"attention_dense": ("attention_tc.cu", "attention_tc32.cu"),
                 "attention_dense_bwd": ("attention_tc.cu", "attention_tc32.cu")}


def dense_attention_phase(dev) -> dict:
    """`train_kernel_phase` over `dense_attention_cases`, and K12b's dbias
    bit-identical across two runs of each case, its rows summing to zero
    within 16x the plain version's rounding, each f32 forward and backward
    one launch on attention_tc32.cu.  Returns the MaskGIT bf16 rows as the
    table's, the ragged bf16 shape under `at_<label>`, the critic's no-bias
    rows, and the f32 rows (K7 dense and K12b f32 at MaskGIT's shape with
    T5's and the ragged one-head shape under `at_<label>`, and with no
    bias)."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    results = {}
    # one case at a time: each case's closures read the generator's current
    # tensors, so it runs before the generator moves on
    for name, case in dense_attention_cases(dev):
        results[name] = train_kernel_phase(dev, [(name, case)], MG_B)[name]
        f32 = name.endswith("_f32")
        results[name]["source"] = CSRC + DENSE_SOURCES[name.split("@")[0]][f32]
        if f32:
            counter = "attention_tc32_bwd" if name.startswith("attention_dense_bwd") \
                else "attention_tc32"
            before = K.launch_counts()[counter]
            case["kern"]()
            if K.launch_counts()[counter] != before + 1:
                raise AssertionError(f"{name}: the f32 kernel did not run on attention_tc32.cu")
        if name.startswith("attention_dense_bwd") and len(case["outputs"]) == 4:
            first = case["kern"]()[3].clone()
            same = torch.equal(case["kern"]()[3], first)
            results[name]["dbias_bit_identical"] = same
            log(f"kernel {name}: dbias bit-identical across two runs: {same}")
            if not same:
                raise AssertionError(f"{name}: dbias differs between two runs")
            # dS rows sum to zero exactly; the kernel's stay at f32 rounding
            # (D_i summed from the f32 P and dP, or read from the f32 output),
            # like the plain version's
            rows = first.sum(-1).abs().max().item()
            plain_rows = case["plain"]()[3].sum(-1).abs().max().item()
            results[name].update(dbias_row_sum_max=rows, plain_dbias_row_sum_max=plain_rows)
            log(f"kernel {name}: largest |row sum| of dbias {rows:.3e}, plain {plain_rows:.3e}")
            if rows > 16 * plain_rows:
                raise AssertionError(f"{name}: dbias rows sum to {rows:.3e}, over 16x the "
                                     f"plain version's {plain_rows:.3e}")
        del case
        torch.cuda.empty_cache()
    table = {}
    for key in ("attention_dense", "attention_dense_bwd"):
        table[key] = dict(results[f"{key}@maskgit_bf16"], shape=[MG_B, 8, 1280, 64],
                          at_ragged_one_head_bf16=results[f"{key}@ragged_one_head_bf16"])
        table[f"{key}_f32"] = dict(
            results[f"{key}@maskgit_f32"], shape=[MG_B, 8, 1280, 64],
            **{f"at_{label}": results[f"{key}@{label}"]
               for label in ("t5_f32", "ragged_one_head_f32")})
    table["attention_nobias"] = dict(results["attention_dense@critic_bf16"],
                                     shape=[MG_B, 8, 1280, 64])
    table["attention_nobias_f32"] = dict(results["attention_dense@critic_f32"],
                                         shape=[MG_B, 8, 1280, 64])
    table["attention_nobias_bwd"] = dict(results["attention_dense_bwd@critic_bf16"],
                                         shape=[MG_B, 8, 1280, 64])
    table["attention_nobias_bwd_f32"] = dict(results["attention_dense_bwd@critic_f32"],
                                             shape=[MG_B, 8, 1280, 64])
    return table


def bert_bf16_bwd_cases(dev):
    """K12a in bf16 at CXR-BERT's (8, 12, 512, 64) with a pad key bias under
    grad (attention_tc.cu, after the tensor-core K7): torch.autograd.grad of
    a kept fused_attention, its plain version, SDPA's backward, the replaced
    CUDA-core K12a (attention_train.cu) on the same inputs, the tensors read
    and written; bit-identical across two runs."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import attention_bwd_plain, fused_attention

    g = torch.Generator(device=dev).manual_seed(91)
    bf, (b, h, n, d) = torch.bfloat16, (TRAIN_B, 12, 512, 64)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=dev).to(bf).transpose(1, 2)
               for _ in range(3))
    q = q * d ** -0.5
    lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
    kb = (1 - (torch.arange(n, device=dev)[None] < lengths[:, None]).float()) \
        * torch.finfo(torch.float32).min
    do = torch.randn((b, h, n, d), generator=g, device=dev).to(bf)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, kb)]
    out = fused_attention(*leaves[:3], key_bias=leaves[3])
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=kb.to(bf)[:, None, None, :],
                                             scale=1.0)
    lse = torch.empty((b, h, n), device=dev)
    yield "attention_bwd_bf16", dict(
        kern=lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        plain=lambda: tuple(t for t in attention_bwd_plain(q, k, v, do, key_bias=kb)
                            if t is not None),
        library=lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True),
        twin=cuda_core_twin(q, k, v, do, key_bias=kb)[1], bit_identical=True,
        inputs=(q, k, v, kb, do, lse), outputs=(q, k, v, kb),
        flops=5 * 2 * b * h * n * n * d, tol=BWD_REL_TOL)


def bert_bf16_dropout_off(dev) -> dict:
    """One forward and backward of a 2-layer full-width CXR-BERT in bf16 with
    attention dropout off (8 reports of 512 tokens with pads): its key-bias
    attention under grad takes the tensor cores (attention_tc.cu), K7 then
    K12a, once per layer each."""
    import torch

    from ct_clip_tpu_torch.config import BertConfig
    from ct_clip_tpu_torch.models import BertModel
    from ct_clip_tpu_torch.models.ctvit import init_param_

    cfg = BertConfig(num_hidden_layers=2, attention_dropout=0.0)
    bert = BertModel(cfg, dtype=torch.bfloat16, device=dev).train()
    g = torch.Generator(device=dev).manual_seed(92)
    for name, t in bert.named_parameters():
        init_param_(name, t, g)
    ids = torch.randint(5, cfg.vocab_size, (TRAIN_B, 512), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None]
            < torch.randint(64, 513, (TRAIN_B, 1), generator=g, device=dev)).long()

    def step():
        hidden = bert(ids, mask, generator=g)
        hidden.float().square().mean().backward()
        return hidden
    hidden, counts, _ = drive("bert_bf16_dropout_off", step)
    want = dict(fused_attention=2, attention_tc=2, attention_bwd=2, attention_tc_bwd=2,
                attention_dropout=0, attention_dropout_bwd=0)
    if any(counts[k] != v for k, v in want.items()) or not torch_finite(hidden):
        raise AssertionError(f"bert bf16 dropout off: launches {counts}, want {want}")
    del bert
    torch.cuda.empty_cache()
    return counts


def maskgit_models(dev, dtype, seed: int = 0):
    """MaskGitConfig() at full width over the autoencoder's 8,192 codes:
    the MaskGit (with cross attention to 768-wide text) and the TokenCritic,
    seeded, f32 parameters computing in `dtype`."""
    import torch

    from ct_clip_tpu_torch.config import MaskGitConfig
    from ct_clip_tpu_torch.models import MaskGit, TokenCritic

    cfg = MaskGitConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    maskgit = MaskGit(cfg, 8192, dtype=dtype, device=dev).init_weights(g)
    critic = TokenCritic(cfg, 8192, dtype=dtype, device=dev).init_weights(g)
    return maskgit, critic


def bert_embedder(dev, vocab: str, dtype=None):
    """The full-width CXR-BERT tower, seeded, bf16 (or `dtype`), eval, as a
    text embedder (max length 512, pad rows zeroed)."""
    import torch

    from ct_clip_tpu_torch.config import BertConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import BertModel
    from ct_clip_tpu_torch.models.ctvit import init_param_
    from ct_clip_tpu_torch.models.t5 import bert_text_embedder

    bert = BertModel(BertConfig(), dtype=dtype or torch.bfloat16, device=dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    for name, t in bert.named_parameters():
        init_param_(name, t, g)
    return bert_text_embedder(bert, WordPieceTokenizer(vocab), max_length=MG_TEXT)


def report_texts(path: str):
    with open(path, newline="") as f:
        return [row["report"] for row in csv.DictReader(f)]


def maskgit_phase(dev, work: Path, card: str) -> dict:
    """MaskGIT at full width on the frozen autoencoder (phase 8's
    `ae_config()`, seeded): (b) `MaskGitTrainer` with the TokenCritic at
    batch 8 on the codes of 8 synthetic 200 x 128 x 128 volumes, CXR-BERT
    context of 8 reports (8, 512, 768): 4 steps, finite losses, the launches
    per step (K7 dense 6, K12b 6, the critic's K7 6 and K12a 6), the median
    step time of steps 2-4 (CUDA events), peak memory, a profiled step, a
    .pt round trip; one step with a seeded T5-base context; (c)
    `MaskGITPipeline.sample` of 2 volumes from 2 reports (18 steps, cond
    scale 3, the critic), then a sample of 100 frames primed with the last
    100 of the first; (d) T5-base alone on 8 x 256 ids without a mask (K7
    dense, 12 launches) and with a pad mask (plain attention, none)."""
    import torch

    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.data.generatect import VideoDataset
    from ct_clip_tpu_torch.models import CTViT, MaskGITPipeline, T5Encoder, t5_base_v1_1
    from ct_clip_tpu_torch.models.t5 import t5_embedder
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.train import MaskGitTrainer

    bf = torch.bfloat16
    cfg = ae_config()
    grid = (AE_FRAMES // cfg.temporal_patch_size, cfg.patch_hw, cfg.patch_hw)
    ds = VideoDataset(str(write_volumes(work / "maskgit", MG_B, (128, 128, 201), 9)),
                      num_frames=AE_FRAMES, image_size=cfg.image_size)
    video = torch.from_numpy(np.stack([ds[i] for i in range(len(ds))]))[..., None].to(dev)
    ctvit = CTViT(cfg, dtype=bf, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    vocab = write_vocab(work / "maskgit_vocab.txt")
    texts = report_texts(write_reports(work / "maskgit_reports.csv", MG_B, 10))
    embed = bert_embedder(dev, vocab)
    context = embed(texts)
    maskgit, critic = maskgit_models(dev, bf)
    trainer = MaskGitTrainer(maskgit, ctvit, critic, results_folder=str(work / "maskgit_run"),
                             save_model_every=10 ** 9)
    counts = {}
    ids, counts["maskgit_encode_ids"], enc_s = drive("maskgit_encode_ids",
                                                      lambda: trainer.encode_ids(video))
    if ids.shape != (MG_B, *grid) or context.shape != (MG_B, MG_TEXT, 768):
        raise AssertionError(f"maskgit: ids {tuple(ids.shape)}, context "
                             f"{tuple(context.shape)}")
    # step 1 with the counters, steps 2-4 timed (CUDA events)
    first, counts["maskgit_train"], _ = drive(
        "maskgit_train", lambda: trainer.train_step(ids, grid, context=context))
    torch.cuda.reset_peak_memory_stats()
    logs = [first]
    step_ms = cuda_step_ms(lambda: logs.append(trainer.train_step(ids, grid, context=context)),
                           MG_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms)
    c = counts["maskgit_train"]
    per_step = {k: c[k] for k in ("attention_dense", "attention_dense_bwd", "fused_attention",
                                  "attention_bwd", "attention_tc", "attention_tc_bwd",
                                  "geglu_ff", "geglu_ff_bwd", "peg_bwd", "peg_bwd_f32",
                                  "peg_fwd")}
    log(f"maskgit step: batch {MG_B} x {int(np.prod(grid)):,} tokens, full width, bf16, CXR-BERT "
        f"context {tuple(context.shape)}, critic on: median {med:.2f} ms of steps 2-4 "
        f"{[round(t, 2) for t in step_ms]} = {MG_B / med * 1e3:.2f} volumes/s; peak memory "
        f"{peak_gb:.2f} GB; losses {[round(x['loss'], 4) for x in logs]}, critic "
        f"{[round(x['critic_loss'], 4) for x in logs]}; launches in one step {per_step} on {card}")
    if not all(np.isfinite([x["loss"], x["critic_loss"]]).all() for x in logs):
        raise AssertionError(f"maskgit: losses not finite: {logs}")
    # the MaskGit's K7 dense / K12b and the critic's no-bias K7 / K12b, all on
    # the tensor cores; K12a (attention_bwd) no more; the 6 + 6 layers' PEG on
    # the stencil, forward and K14
    want = dict(attention_dense=6, fused_attention=6, attention_dense_bwd=12, attention_bwd=0,
                attention_tc=12, attention_tc_bwd=12, peg_bwd=12, peg_bwd_f32=0)
    if any(per_step[k] != n for k, n in want.items()) or per_step["peg_fwd"] < 12:
        raise AssertionError(f"maskgit: launches per step {per_step}, want {want}")
    breakdown = profile_step(lambda: trainer.train_step(ids, grid, context=context),
                             MG_GROUPS, "maskgit")

    path = trainer.ckpt.save(trainer.state.step, trainer.state)
    m2, c2 = maskgit_models(dev, bf, seed=1)
    other = MaskGitTrainer(m2, ctvit, c2, results_folder=str(work / "maskgit_restored"))
    trainer.ckpt.restore(other.state)
    same = all(torch.equal(t, other.state.maskgit.state_dict()[k])
               for k, t in maskgit.state_dict().items()) and all(
        torch.equal(t, other.state.critic.state_dict()[k]) for k, t in critic.state_dict().items())
    log(f"maskgit: checkpoint {path.name} ({path.stat().st_size / 1e6:.1f} MB) restored equal "
        f"{same} at step {other.state.step}")
    if not same or other.state.step != trainer.state.step:
        raise AssertionError("maskgit: checkpoint round trip failed")
    del other, m2, c2, path
    torch.cuda.empty_cache()

    t5 = T5Encoder(t5_base_v1_1(), device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(4)).eval()
    tok = WordPieceTokenizer(vocab)
    t5_context = t5_embedder(t5, tok)(texts)
    t5_step = trainer.train_step(ids, grid, context=t5_context)
    log(f"maskgit: one step with seeded T5-base context {tuple(t5_context.shape)}: {t5_step}")
    if not np.isfinite([t5_step["loss"], t5_step["critic_loss"]]).all():
        raise AssertionError(f"maskgit with T5 context: {t5_step}")

    t5_ids = torch.randint(1, t5.config.vocab_size, (8, 256),
                           generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    t5_mask = (torch.arange(256, device=dev)[None] < torch.tensor(
        [256, 200, 180, 150, 120, 100, 80, 40], device=dev)[:, None]).long()
    with torch.no_grad():
        hidden, counts["t5_no_mask"], _ = drive("t5_no_mask", lambda: t5(t5_ids))
        K.reset_launch_counts()
        masked = t5(t5_ids, t5_mask)
        torch.cuda.synchronize()
        masked_counts = K.launch_counts()
        t5_ms = cuda_ms(lambda: t5(t5_ids), reps=5)
        t5_mask_ms = cuda_ms(lambda: t5(t5_ids, t5_mask), reps=5)
    log(f"t5-base (f32, seeded) on 8 x 256 ids: no mask {t5_ms:.2f} ms (K7 dense launches "
        f"{counts['t5_no_mask']['attention_dense']}), pad mask {t5_mask_ms:.2f} ms (K7 dense "
        f"launches {masked_counts['attention_dense']}, plain attention) on {card}")
    if counts["t5_no_mask"]["attention_dense"] != 12 \
            or counts["t5_no_mask"]["attention_tc32"] != 12 or masked_counts["attention_dense"] \
            or not (torch.isfinite(hidden).all() and torch.isfinite(masked).all()):
        raise AssertionError("t5: launches or outputs wrong")
    del t5, t5_context, hidden, masked
    torch.cuda.empty_cache()

    pipe = MaskGITPipeline(ctvit, maskgit, critic=critic, text_embed_fn=embed)
    gen = torch.Generator(device=dev).manual_seed(6)
    vols, counts["maskgit_sample"], sample_s = drive(
        "maskgit_sample", lambda: pipe.sample(num_frames=AE_FRAMES, texts=texts[:2],
                                              generator=gen))
    sc = counts["maskgit_sample"]
    dense = sc["attention_dense"]
    log(f"maskgit sample: 2 volumes {tuple(vols.shape)} in {sample_s:.2f} s host clock (18 steps, "
        f"cond scale 3, critic, text embedding and decoder included) = {sample_s / 2:.2f} s per "
        f"volume, K7 dense launches {dense}, on the tensor cores {sc['attention_tc']} of "
        f"{dense + sc['fused_attention']} K7 launches on {card}")
    hw = cfg.image_size
    # every K7 of sampling (the MaskGit's, the critic's, the text tower's) is
    # bf16 without grad: all on the tensor cores
    if vols.shape != (2, AE_FRAMES, hw, hw, 1) or not torch_finite(vols) \
            or dense != 18 * 2 * 6 or sc["attention_tc"] != dense + sc["fused_attention"]:
        raise AssertionError(f"maskgit sample: {tuple(vols.shape)}, launches {sc}")
    primed, counts["maskgit_sample_primed"], primed_s = drive(
        "maskgit_sample_primed", lambda: pipe.sample(
            num_frames=AE_FRAMES // 2, texts=texts[:1], prime_frames=vols[:1, AE_FRAMES // 2:],
            generator=gen))
    log(f"maskgit primed sample: {tuple(primed.shape)} after 100 primed frames in "
        f"{primed_s:.2f} s host clock")
    if primed.shape != (1, AE_FRAMES // 2, hw, hw, 1) or not torch_finite(primed):
        raise AssertionError(f"maskgit primed sample: {tuple(primed.shape)}")
    del trainer, maskgit, critic, ctvit, pipe, vols, primed, video, context
    torch.cuda.empty_cache()
    return dict(counts=counts, encode_ids_s=enc_s, step_ms=med, step_ms_all=step_ms,
                volumes_per_s=MG_B / med * 1e3, peak_gb=peak_gb, step_breakdown=breakdown,
                losses=[x["loss"] for x in logs], critic_losses=[x["critic_loss"] for x in logs],
                launches_per_step=per_step, t5_context_step=t5_step, t5_ms=t5_ms,
                t5_mask_ms=t5_mask_ms, sample_s=sample_s, sample_s_per_volume=sample_s / 2,
                sample_dense_launches=dense, primed_sample_s=primed_s)


def tiny_maskgit_side(cfg, start, inputs, device, dtype, lr: float, folder: Path) -> dict:
    """From `start` on `device` in `dtype`: the MaskGit's loss with the
    handed-in draws and every gradient, then one `MaskGitTrainer` step from
    `start` with the same draws."""
    import torch

    from ct_clip_tpu_torch.models import CTViT, MaskGit
    from ct_clip_tpu_torch.models.maskgit import maskgit_train_loss
    from ct_clip_tpu_torch.train import MaskGitTrainer

    from ct_clip_tpu_torch.ops import kernels as K

    ids, ctx, draws, grid = inputs
    ids, ctx = ids.to(device), ctx.to(device)
    model = MaskGit(cfg, 64, dtype=dtype, device=device)
    model.load_state_dict(start)
    # K12b on the tensor cores: bf16 attention_tc.cu, f32 attention_tc32.cu
    counter = "attention_tc_bwd" if dtype == torch.bfloat16 else "attention_tc32_bwd"
    before = K.launch_counts()[counter]
    loss, _ = maskgit_train_loss(model, ids, grid, context=ctx, draws=draws)
    loss.backward()
    if device.type == "cuda" and K.launch_counts()[counter] == before:
        raise AssertionError(f"tiny MaskGit: the self-attention did not run K12b ({counter})")
    grads = {n: p.grad.float().cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.load_state_dict(start)
    model.zero_grad()
    trainer = MaskGitTrainer(model, CTViT(tiny_ae_config(), device=device), lr=lr,
                             warmup_steps=0, results_folder=str(folder))
    metrics = trainer.train_step(ids, grid, context=ctx, draws={"maskgit": draws})
    return dict(loss=loss.item(), grads=grads, metrics=metrics,
                sd={k: t.float().cpu() for k, t in model.state_dict().items()})


def maskgit_planted_faults():
    """K12b's dbias (attention_tc.cu) taken from the batch's first row only."""
    from ct_clip_tpu_torch.ops import kernels as K

    bwd = K.attention_tc_bwd

    def k12b_first_row(q, k, v, dout, lse, **kw):
        g = bwd(q, k, v, dout, lse, **kw)
        if g[3] is None:
            return g
        return g[:3] + (bwd(q[:1], k[:1], v[:1], dout[:1], lse[:1], **kw)[3],) + g[4:]
    return {"K12b with dbias from batch row 0 only": (K, "attention_tc_bwd", k12b_first_row)}


def tiny_maskgit_phase(dev, work: Path) -> dict:
    """(e) One tiny MaskGit training step (dim 128, 2 layers, 2 heads x 64,
    a (2, 16, 16) grid, batch 4, text width 32 with pad rows), card bf16
    against the CPU, held as the tiny CT-CLIP step is (`card_vs_cpu`, no
    VQ): the card's K7 dense / K12b, K3 / K11, K14 against the plain
    versions; then with K12b's dbias from batch row 0 only, which must
    fail.  512 tokens of width 64 do not fit the fused sublayer K1
    (`sublayer_fits`), so the self-attention takes K7 dense and K12b, as at
    full width."""
    import torch

    from ct_clip_tpu_torch.config import MaskGitConfig
    from ct_clip_tpu_torch.models import MaskGit

    cfg = MaskGitConfig(dim=128, depth=2, dim_head=64, heads=2, max_seq_len=512, t5_dim=32)
    lr, grid = 1e-3, (2, 16, 16)
    n = int(np.prod(grid))
    g = torch.Generator().manual_seed(13)
    ids = torch.randint(0, 64, (4, n), generator=g)
    ctx = torch.randn((4, 6, 32), generator=g)
    ctx[1, 4:] = 0.0
    ctx[3, 2:] = 0.0
    draws = {"step": torch.randint(0, 18, (4,), generator=g),
             "scores": torch.rand((4, n), generator=g),
             "keep": torch.tensor([True, True, False, True])}
    cpu = MaskGit(cfg, 64, dtype=torch.bfloat16).init_weights(g)
    start = {k: t.clone() for k, t in cpu.state_dict().items()}
    res, _ = card_vs_cpu(dev, lambda device, dtype: tiny_maskgit_side(
        cfg, start, (ids, ctx, draws, grid), device, dtype, lr,
        work / f"tiny_maskgit_{device.type}"), start, lr, maskgit_planted_faults(),
        "MaskGit", vq_prefix=None)
    return res


# ---------------------------------------------------------------- phase 10
# f32 on the card: the f32 forms of K1, K2, K3, K11, K5 (f32 rows), K6 and
# K17, CT-CLIP zero-shot and the MaskGIT stage at the JAX package's default
# dtype.  Every product in true f32 (TF32 off, as main() sets it).
def f32_kernel_cases(dev):
    """The f32 forms at the shapes of their main paths, each against its
    plain version in true f32: K3 at MaskGIT's 10,240 x 512 -> 2 x 1,365 ->
    512, zero-shot's 27,648 rows and the contrastive step's 110,592 (in
    3xTF32: bounds at the TF32 peak, the f32 CUDA-core one beside them),
    K11 at MaskGIT's rows, K1 on the
    zero-shot batch's (48, 576, 512) planes and the autoencoder's (160, 64,
    512), K2 grid on the zero-shot grid and K2 seq at (512, 20, 512), K5 on
    the zero-shot batch's f32 rows, K6 on one f32 volume into its slot and
    K17 on the sampler's decoded rows.  Bounds at the f32 CUDA-core peak
    unless stated."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.ffn import (_geglu_ff_bwd_products, _geglu_ff_bwd_tc32,
                                           _geglu_ff_gemm, _geglu_ff_tc32, fused_geglu_ff,
                                           geglu_ff_bwd_plain, geglu_ff_plain)
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.patch_embed import (rearrange_patches, rearrange_plain,
                                                   unrearrange_patches, unrearrange_plain)
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_small_qknorm_attention,
        fused_spatial_qknorm_attention, grid_qknorm_attention_plain, qknorm_attention_plain)
    from ct_clip_tpu_torch.ops.vq import (vq_assign, vq_assign_plain, vq_assign_rows_lane_plain,
                                          vq_rows_lane_sim)

    g = torch.Generator(device=dev).manual_seed(40)
    f32 = torch.float32

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    dim, heads, dh, hd, inner = 512, 8, 32, 256, 1365
    mg_rows, zs_rows = MG_B * 1280, B * 13824
    f32_case = dict(peak=PEAK_F32_FLOPS, library=None)

    # K3 in 3xTF32 on ffn_tc32.cu, a plain-TF32 copy of it, the replaced
    # FFMA path (gemm.cu's f32 gemm_kernel) timed beside it; the products'
    # operations at the padded inner width, 1,368
    w_ff = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
            rn(dim, inner, scale=inner ** -0.5))
    tf32_lib = K.copy_library("ffn_tc32.cu", CT_TC32_PASSES=1)
    for name, rows in (("geglu_ff_f32", mg_rows), ("geglu_ff_f32_zero_shot", zs_rows),
                       ("geglu_ff_f32_contrastive", TRAIN_B * 13824)):
        x = rn(rows, dim)
        products = 6 * rows * dim * 1368
        yield name, dict(
            f32_case, kern=lambda x=x: fused_geglu_ff(x, *w_ff),
            plain=lambda x=x: geglu_ff_plain(x, *w_ff),
            copies={"ffn_tc32.cu in plain TF32 (CT_TC32_PASSES=1)":
                    lambda x=x: _geglu_ff_tc32(x, *w_ff, 1e-5, lib=tf32_lib)},
            twin=lambda x=x: _geglu_ff_gemm(x, *w_ff, 1e-5),
            twin_source="gemm.cu (f32 gemm_kernel, FFMA)", bit_identical=True,
            inputs=(x, *w_ff), outputs=(x,), flops=3 * products, f32_flops=products,
            peak=PEAK_TF32_FLOPS, tols=(TC32_REL_TOL,))
        del x
    # K11 f32 in 3xTF32 on ffn_tc32.cu (the tile, one NN and two TN
    # products) at MaskGIT's (and the autoencoder's) 10,240 rows and at the
    # contrastive step's 110,592 (8 launches a step): dx to TC32_REL_TOL;
    # dscale, dbias, dwi, dwo sum over all rows (F32_REL_TOL); the plain-TF32
    # copy must miss; the replaced path (gemm.cu's FFMA tile and products)
    # timed beside it.  Both draw from the shared generator, so K5's first
    # f32-row seed below gets the inputs that once showed its check's fault
    # (ROADMAP 3)
    for name, rows, gen in (("geglu_ff_bwd_f32", mg_rows, g),
                            ("geglu_ff_bwd_f32_contrastive", TRAIN_B * 13824, g)):
        x, do = (torch.randn((rows, dim), generator=gen, device=dev) for _ in range(2))
        leaves = [t.clone().requires_grad_() for t in (x, *w_ff)]
        out = fused_geglu_ff(*leaves)
        flops = 2 * rows * dim * 8 * inner
        yield name, dict(
            f32_case, kern=lambda out=out, leaves=leaves, do=do: torch.autograd.grad(
                out, leaves, do, retain_graph=True),
            plain=lambda x=x, do=do: geglu_ff_bwd_plain(x, *w_ff, do),
            copies={"ffn_tc32.cu in plain TF32 (CT_TC32_PASSES=1)":
                    lambda x=x, do=do: _geglu_ff_bwd_tc32(x, *w_ff, do, 1e-5, lib=tf32_lib)},
            twin=lambda x=x, do=do: _geglu_ff_bwd_products(x, *w_ff, do, 1e-5, K.ff_bwd_core,
                                                           K.gemm_nn, K.gemm_tn),
            twin_source=K11_F32_REPLACED, bit_identical=True, inputs=(x, do, *w_ff),
            outputs=(x, *w_ff), flops=3 * flops, f32_flops=flops, peak=PEAK_TF32_FLOPS,
            tols=(TC32_REL_TOL,) + (F32_REL_TOL,) * 4)
        del x, do, leaves, out

    # K1, K2
    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))

    def proj(rows):
        return 2 * rows * dim * (hd + 2 * hd + hd)
    # K1 in 3xTF32 (the core on qknorm_attention_tc32.cu, the products on
    # ffn_tc32.cu), the replaced path (attention.cu's f32 core, gemm.cu's
    # FFMA products) timed beside it
    for name, (b, n) in (("spatial_attention_f32", (B * 24, 576)),
                         ("spatial_attention_f32_n64", (MG_B * 20, 64))):
        xs, cpb = rn(b, n, dim), rn(heads, n, n)
        k1 = lambda xs=xs, cpb=cpb: fused_spatial_qknorm_attention(  # noqa: E731
            xs, *w_attn, cpb, heads, dh)
        flops = proj(b * n) + 4 * b * heads * n * n * dh
        yield name, dict(
            f32_case, kern=k1, twin=cuda_core_k9(k1), twin_source=K1_F32_REPLACED,
            plain=lambda xs=xs, cpb=cpb: qknorm_attention_plain(xs, *w_attn, cpb, heads, dh),
            inputs=(xs, *w_attn, cpb), outputs=(xs,), flops=3 * flops, f32_flops=flops,
            peak=PEAK_TF32_FLOPS, tol=TC32_REL_TOL)
        del xs, cpb
    # K2 grid and seq: the products in 3xTF32 on ffn_tc32.cu, the core on
    # qknorm_attention_short.cu's CUDA cores; the replaced path (attention.cu's
    # f32 core, gemm.cu's FFMA products) timed beside it
    xg = rn(B, 24, 576, dim)
    k2 = lambda: fused_grid_qknorm_attention(xg, *w_attn, heads, dh)  # noqa: E731
    flops = proj(B * 24 * 576) + 4 * B * 576 * heads * 24 * 24 * dh
    yield "grid_attention_f32", dict(
        f32_case, kern=k2, twin=cuda_core_k2(k2), twin_source=K2_F32_REPLACED,
        plain=lambda: grid_qknorm_attention_plain(xg, *w_attn, heads, dh),
        inputs=(xg, *w_attn), outputs=(xg,), flops=3 * flops, f32_flops=flops,
        peak=PEAK_TF32_FLOPS, tol=TC32_REL_TOL)
    del xg
    xq = rn(MG_B * 64, 20, dim)
    k2 = lambda: fused_small_qknorm_attention(xq, *w_attn, heads, dh)  # noqa: E731
    flops = proj(MG_B * 64 * 20) + 4 * MG_B * 64 * heads * 20 * 20 * dh
    yield "seq_attention_f32", dict(
        f32_case, kern=k2, twin=cuda_core_k2(k2), twin_source=K2_F32_REPLACED,
        plain=lambda: qknorm_attention_plain(xq, *w_attn, None, heads, dh),
        inputs=(xq, *w_attn), outputs=(xq,), flops=3 * flops, f32_flops=flops,
        peak=PEAK_TF32_FLOPS, tol=TC32_REL_TOL)
    del xq

    # K5 on f32 rows (vq_tc.cu: the pre-pass, then the bf16 assignment): ids
    # against the plain version of the kernel's own math, whose bf16 rows are
    # the pre-pass's bit for bit (`vq_assign_rows_lane_plain`), on three
    # seeds: the shared generator, then two of their own; the first with the
    # replaced gemm.cu f32-row form and the yardstick timed beside it
    for name, gen in (("vq_assign_f32", g),
                      *((f"vq_assign_f32_seed{sd}", torch.Generator(device=dev).manual_seed(sd))
                        for sd in VQ_F32_SEEDS)):
        xv = torch.randn((zs_rows, dim), generator=gen, device=dev)
        embed_n = l2norm(torch.randn((8192, dim), generator=gen, device=dev))
        cb = embed_n.to(torch.bfloat16).contiguous()
        case = dict(
            f32_case, kern=lambda xv=xv, e=embed_n: vq_assign(xv, e),
            plain=lambda xv=xv, e=embed_n: vq_assign_rows_lane_plain(xv, e),
            sim=lambda xv=xv, e=embed_n: vq_rows_lane_sim(xv, e),
            f32_plain=lambda xv=xv, e=embed_n: vq_assign_plain(xv, e), inputs=(xv, embed_n),
            outputs=(torch.empty(zs_rows, dtype=torch.int32, device=dev),),
            flops=2 * zs_rows * dim * 8192, peak=PEAK_BF16_FLOPS, ids=True)
        if name == "vq_assign_f32":
            case.update(twin=lambda xv=xv, cb=cb: K.gemm_argmax(xv, cb),
                        twin_source="gemm.cu (gemm_argmax_kernel's f32-row form, WMMA)",
                        yardstick_is="row l2norm, then " + K5_YARDSTICK,
                        yardstick=lambda xv=xv, cb=cb: (
                            l2norm(xv).to(torch.bfloat16) @ cb.t()).argmax(dim=-1))
        yield name, case
        del xv, embed_n, cb, case

    # K6 on one f32 volume into the last slot of the batch buffer; K17 on the
    # sampler's decoded (1, 1,280, 2,560) pixel rows
    video = rn(1, 240, 480, 480)
    slot = torch.empty((B, 13824, 4000), dtype=f32, device=dev)[-1:]
    yield "rearrange_patches_f32", dict(
        f32_case, kern=lambda: rearrange_patches(video, 10, 20, out=slot),
        plain=lambda: rearrange_plain(video, 10, 20),
        library=lambda: video.reshape(1, 24, 10, 24, 20, 24, 20)
        .permute(0, 1, 3, 5, 2, 4, 6).contiguous(),
        inputs=(video,), outputs=(video,), flops=0, exact=True)
    del video, slot
    cfg = ae_config()
    pt, p, hw = cfg.temporal_patch_size, cfg.patch_size, cfg.image_size
    t, h = AE_FRAMES // pt, hw // p
    pix = rn(1, t * h * h, cfg.patch_dim)
    yield "unrearrange_patches_f32", dict(
        f32_case, kern=lambda: unrearrange_patches(pix, pt, p, AE_FRAMES, hw, hw),
        plain=lambda: unrearrange_plain(pix, pt, p, AE_FRAMES, hw, hw),
        library=lambda: pix.reshape(1, t, h, h, pt, p, p).permute(0, 1, 4, 2, 5, 3, 6)
        .contiguous(), inputs=(pix,), outputs=(pix,), flops=0, exact=True)


# K5 f32 rows' own seeds beside the shared generator's (f32_kernel_cases)
VQ_F32_SEEDS = (401, 402)


def f32_kernel_phase(dev) -> dict:
    """`f32_kernel_cases` through `train_kernel_phase`, the second shapes
    and K5's other seeds nested under their kernel's entry."""
    res = train_kernel_phase(dev, f32_kernel_cases(dev), MG_B)
    for sd in VQ_F32_SEEDS:
        res["vq_assign_f32"][f"at_seed{sd}"] = res.pop(f"vq_assign_f32_seed{sd}")
    res["geglu_ff_f32"]["at_zero_shot"] = res.pop("geglu_ff_f32_zero_shot")
    res["geglu_ff_f32"]["at_contrastive"] = res.pop("geglu_ff_f32_contrastive")
    res["geglu_ff_bwd_f32"]["at_contrastive"] = res.pop("geglu_ff_bwd_f32_contrastive")
    res["spatial_attention_f32"]["at_n64"] = res.pop("spatial_attention_f32_n64")
    return res


# the launches an f32 zero-shot run must show: the same per kernel as the
# bf16 run on the same corpus, on the f32 forms, and the plain embed route
F32_ZS_SAME = ("spatial_attention", "grid_attention", "geglu_ff", "vq_assign",
               "fused_attention", "peg_fwd")


def zero_shot_f32_phase(dev, work: Path, card: str, bf16_counts: dict) -> dict:
    """`run_zero_shot` with CTCLIP(CTCLIPConfig(), dtype=float32) on 3
    synthetic 240 x 480 x 480 volumes, batch 2, on both routes: P(present)
    finite, (3, 18), in [0, 1], the routes within ROUTE_TOL; the launches
    per kernel equal the bf16 run's, on the f32 forms, with the plain embed
    route counted; `score_batch` device ms (CUDA events) and peak memory."""
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig
    from ct_clip_tpu_torch.data import CTReportDatasetInfer, WordPieceTokenizer
    from ct_clip_tpu_torch.inference import ZeroShotClassifier, run_zero_shot
    from ct_clip_tpu_torch.models import CTCLIP

    root = work / "f32"
    root.mkdir()
    paths = write_corpus(root, [(256, 256, 60)] * 3, 1.5, 6.0)
    tok = WordPieceTokenizer(str(root / "vocab.txt"))
    ds = CTReportDatasetInfer(*paths)
    model = CTCLIP(CTCLIPConfig(), dtype=torch.float32, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    counts, outs = {}, {}
    for name, rows, bf16_name, embed in (
            ("zero_shot_f32_rows", None, "zero_shot_rows", ("row_embed_plain", "row_embed")),
            ("zero_shot_f32_volume", False, "zero_shot_volume",
             ("patch_embed_plain", "patch_embed"))):
        results = root / name
        outs[name], counts[name], secs = drive(name, lambda: run_zero_shot(
            model, tok, ds, str(results), batch_size=B, num_workers=2, patch_rows=rows))
        check_predictions(name, outs[name], results)
        c, cb = counts[name], bf16_counts[bf16_name]
        want = {k: cb[k] for k in F32_ZS_SAME}
        want.update({f"{k}_f32": cb[k] for k in F32_ZS_SAME if k != "fused_attention"})
        want[embed[0]] = cb[embed[1]]
        # the prompts' K7 f32 on attention_tc32.cu, as the bf16 run's on attention_tc.cu;
        # every K3 f32 in 3xTF32 on ffn_tc32.cu
        want["attention_tc32"] = cb["attention_tc"]
        want["geglu_ff_tc32"] = cb["geglu_ff"]
        # every K1 f32 core on qknorm_attention_tc32.cu as the bf16 run's on
        # qknorm_attention_tc.cu, its three products in 3xTF32 on ffn_tc32.cu
        want["qk_attention_tc32"] = cb["qk_attention_tc"]
        # every K2 f32 core on qknorm_attention_short.cu as the bf16 run's,
        # its three products in 3xTF32 too
        want["qk_attention_short_f32"] = cb["qk_attention_short"]
        want["tc32_gemm"] = 3 * (cb["qk_attention_tc"] + cb["qk_attention_short"])
        # every K5 on vq_tc.cu, its f32 rows through the pre-pass
        want["vq_assign_tc"] = cb["vq_assign_tc"]
        got = {k: c[k] for k in want}
        log(f"e2e {name}: run_zero_shot in f32 scored 3 volumes in {secs:.2f} s host clock; "
            f"launches {got}, the bf16 run's {want}")
        if got != want or c[embed[1]] or c["attention_tc"] or c["qk_attention_tc"] \
                or c["ff_tc_fwd"] or c["qk_proj_tc"] or c["qk_proj_gemm"]:
            raise AssertionError(f"{name}: launches {got}, want {want}")
    diff = float(np.abs(outs["zero_shot_f32_rows"]["predicted"]
                        - outs["zero_shot_f32_volume"]["predicted"]).max())
    log(f"e2e f32: P(present) rows route vs volume route max abs diff {diff:.4e} "
        f"(tol {ROUTE_TOL})")
    if diff > ROUTE_TOL:
        raise AssertionError(f"the f32 zero-shot routes disagree: {diff}")

    clf = ZeroShotClassifier(model, tok)
    vcfg = model.config.ctvit
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = {"zero_shot_f32_rows": (B, vcfg.patch_t * vcfg.patch_hw ** 2, vcfg.patch_dim),
              "zero_shot_f32_volume": (B, vcfg.num_frames, vcfg.image_size,
                                       vcfg.image_size, 1)}
    batch_ms, peak_gb = {}, {}
    with torch.inference_mode():
        clf.prompt_latents()
        for name, shape in shapes.items():
            x = torch.rand(shape, generator=g, device=dev) * 2 - 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            clf.score_batch(x)
            torch.cuda.synchronize()
            peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
            batch_ms[name] = cuda_ms(lambda: clf.score_batch(x), reps=5)
            log(f"e2e {name}: score_batch({B}) in f32 {batch_ms[name]:.2f} ms = "
                f"{B / batch_ms[name] * 1e3:.2f} volumes/s device-side, peak memory "
                f"{peak_gb[name]:.2f} GB on {card}")
            del x
    del model, clf
    torch.cuda.empty_cache()
    return dict(counts=counts, route_max_abs_diff=diff, score_batch_ms=batch_ms,
                score_batch_peak_gb=peak_gb)


def small_reference_f32_phase(dev, work: Path) -> dict:
    """`small_reference_phase` in f32: the tiny CT-CLIP scores the same
    volumes on the card (K1, K2, K3 f32; K5 and the embeds by the JAX
    package's gates, the plain versions at this width) and on the CPU (plain
    versions), both f32, from volumes and from patch rows (K6 f32 on the
    card): P(present) and the image latents within F32_REL_TOL of max."""
    import torch

    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    cfg = tiny_zero_shot_config()
    tok = WordPieceTokenizer(str(work / "vocab.txt"))
    cpu = CTCLIP(cfg).eval()
    cpu.init_weights(torch.Generator().manual_seed(1))
    gpu = CTCLIP(cfg, device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    video = torch.rand((3, 12, 48, 48, 1), generator=torch.Generator().manual_seed(2)) * 2 - 1
    ref_clf = ZeroShotClassifier(cpu, tok, max_text_len=64)
    gpu_clf = ZeroShotClassifier(gpu, tok, max_text_len=64)
    errs = {}
    for route in ("volume", "rows"):
        x = video if route == "volume" else rearrange_patches(video[..., 0], 4, 16)
        xg = video.to(dev) if route == "volume" else rearrange_patches(
            video[..., 0].to(dev), 4, 16)
        K.reset_launch_counts()
        with torch.inference_mode():
            ref_lat = cpu.encode_image(x, ref_clf.spatial_bias())[0]
            got_lat = gpu.encode_image(xg, gpu_clf.spatial_bias())[0].cpu()
            ref, got = ref_clf.score_batch(x), gpu_clf.score_batch(xg).cpu()
        counts = K.launch_counts()
        errs[route] = dict(
            p_rel=(got - ref).abs().max().item() / ref.abs().max().item(),
            latents_rel=(got_lat - ref_lat).abs().max().item() / ref_lat.abs().max().item())
        log(f"reference: tiny CT-CLIP in f32 from {route}, card vs CPU: P(present) "
            f"{errs[route]['p_rel']:.2e}, image latents {errs[route]['latents_rel']:.2e} of max "
            f"(tol {F32_REL_TOL}); f32 launches "
            f"{ {k: v for k, v in counts.items() if k.endswith('_f32') and v} }")
        if got.shape != (3, 18) or not torch.isfinite(got).all() \
                or max(errs[route].values()) > F32_REL_TOL \
                or not (counts["spatial_attention_f32"] and counts["grid_attention_f32"]
                        and counts["geglu_ff_f32"]):
            raise AssertionError(f"small-input f32 reference ({route}) disagrees: {errs}")
    return errs


def maskgit_f32_phase(dev, work: Path, card: str) -> dict:
    """MaskGIT at the JAX package's default f32: `MaskGitTrainer` with the
    MaskGit and the TokenCritic as MaskGitConfig() in f32, over the codes of
    8 synthetic 200 x 128 x 128 volumes from a frozen f32 CTViT(ae_config())
    (K8 plain route, K1 and K2 seq f32, K3 f32, K5 on f32 rows), with an f32
    CXR-BERT context of 8 reports: 4 steps with finite losses, the launches
    per step (K3 f32, K11 f32, K7 dense f32 on the CUDA cores, K12b f32 and
    the critic's no-bias backward on attention_tc32.cu, the PEG's forward and
    K14 on the stencil's f32 forms), the median step of steps 2-4
    (CUDA events), peak memory and a profiled step's idle share; then
    `MaskGITPipeline.sample` of 1 volume in f32 (K17 f32 in the decoder)."""
    import torch

    from ct_clip_tpu_torch.data.generatect import VideoDataset
    from ct_clip_tpu_torch.models import CTViT, MaskGITPipeline
    from ct_clip_tpu_torch.train import MaskGitTrainer

    f32 = torch.float32
    cfg = ae_config()
    grid = (AE_FRAMES // cfg.temporal_patch_size, cfg.patch_hw, cfg.patch_hw)
    ds = VideoDataset(str(write_volumes(work / "maskgit_f32", MG_B, (128, 128, 201), 19)),
                      num_frames=AE_FRAMES, image_size=cfg.image_size)
    video = torch.from_numpy(np.stack([ds[i] for i in range(len(ds))]))[..., None].to(dev)
    ctvit = CTViT(cfg, dtype=f32, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    vocab = write_vocab(work / "maskgit_f32_vocab.txt")
    texts = report_texts(write_reports(work / "maskgit_f32_reports.csv", MG_B, 20))
    embed = bert_embedder(dev, vocab, f32)
    context = embed(texts)
    maskgit, critic = maskgit_models(dev, f32)
    trainer = MaskGitTrainer(maskgit, ctvit, critic, results_folder=str(work / "maskgit_f32_run"),
                             save_model_every=10 ** 9)
    counts = {}
    ids, counts["maskgit_f32_encode_ids"], enc_s = drive("maskgit_f32_encode_ids",
                                                          lambda: trainer.encode_ids(video))
    if ids.shape != (MG_B, *grid) or context.dtype != f32:
        raise AssertionError(f"maskgit f32: ids {tuple(ids.shape)}, context {context.dtype}")
    first, counts["maskgit_f32_train"], _ = drive(
        "maskgit_f32_train", lambda: trainer.train_step(ids, grid, context=context))
    torch.cuda.reset_peak_memory_stats()
    logs = [first]
    step_ms = cuda_step_ms(lambda: logs.append(trainer.train_step(ids, grid, context=context)),
                           MG_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms)
    c = counts["maskgit_f32_train"]
    per_step = {k: c[k] for k in ("geglu_ff_f32", "geglu_ff_tc32", "geglu_ff_bwd_f32",
                                  "attention_dense",
                                  "attention_dense_bwd", "fused_attention", "attention_bwd",
                                  "attention_tc", "attention_tc_bwd", "attention_tc32",
                                  "attention_tc32_bwd", "peg_bwd", "peg_bwd_f32", "peg_fwd",
                                  "peg_fwd_f32")}
    log(f"maskgit f32 step: batch {MG_B} x {int(np.prod(grid)):,} tokens, full width, f32, "
        f"CXR-BERT f32 context {tuple(context.shape)}, critic on: median {med:.2f} ms of steps "
        f"2-4 {[round(t, 2) for t in step_ms]} = {MG_B / med * 1e3:.2f} volumes/s; peak "
        f"memory {peak_gb:.2f} GB; losses {[round(x['loss'], 4) for x in logs]}, critic "
        f"{[round(x['critic_loss'], 4) for x in logs]}; launches in one step {per_step} on {card}")
    if not all(np.isfinite([x["loss"], x["critic_loss"]]).all() for x in logs):
        raise AssertionError(f"maskgit f32: losses not finite: {logs}")
    # 6 + 6 layers: the MaskGit's K7 dense and the critic's no-bias K7 in
    # f32 and both backwards K12b (the critic's with no bias) on
    # attention_tc32.cu in 3xTF32 (none on attention_tc.cu), K12a none;
    # every FF forward on K3's f32 form, its backward on K11's; every PEG on
    # the stencil's f32 forms, forward and K14; every K3 f32 in 3xTF32 on
    # ffn_tc32.cu
    want = dict(attention_dense=6, fused_attention=6, attention_dense_bwd=12, attention_bwd=0,
                attention_tc32=12, attention_tc32_bwd=12, attention_tc=0, attention_tc_bwd=0,
                peg_bwd=12, peg_bwd_f32=12, peg_fwd_f32=c["peg_fwd"],
                geglu_ff_f32=c["geglu_ff"], geglu_ff_tc32=c["geglu_ff"],
                geglu_ff_bwd_f32=c["geglu_ff_bwd"])
    if any(per_step[k] != n for k, n in want.items()) or not (
            per_step["geglu_ff_f32"] and per_step["geglu_ff_bwd_f32"] and per_step["peg_fwd"]):
        raise AssertionError(f"maskgit f32: launches per step {per_step}, want {want}")
    breakdown = profile_step(lambda: trainer.train_step(ids, grid, context=context),
                             MG_GROUPS, "maskgit f32")

    pipe = MaskGITPipeline(ctvit, maskgit, critic=critic, text_embed_fn=embed)
    gen = torch.Generator(device=dev).manual_seed(6)
    vols, counts["maskgit_f32_sample"], sample_s = drive(
        "maskgit_f32_sample", lambda: pipe.sample(num_frames=AE_FRAMES, texts=texts[:1],
                                                  generator=gen))
    hw = cfg.image_size
    log(f"maskgit f32 sample: 1 volume {tuple(vols.shape)} {vols.dtype} in {sample_s:.2f} s host "
        f"clock (18 steps, cond scale 3, critic, text embedding and decoder included) on {card}")
    if vols.shape != (1, AE_FRAMES, hw, hw, 1) or vols.dtype != f32 or not torch_finite(vols):
        raise AssertionError(f"maskgit f32 sample: {tuple(vols.shape)} {vols.dtype}")
    del trainer, maskgit, critic, ctvit, pipe, vols, video, context
    torch.cuda.empty_cache()
    return dict(counts=counts, encode_ids_s=enc_s, step_ms=med, step_ms_all=step_ms,
                volumes_per_s=MG_B / med * 1e3, peak_gb=peak_gb, step_breakdown=breakdown,
                losses=[x["loss"] for x in logs], critic_losses=[x["critic_loss"] for x in logs],
                launches_per_step=per_step, sample_s_per_volume=sample_s)


# the tiny f32 MaskGit step, card against CPU, both f32: as the tiny RadBERT
# f32 step (`radbert_reference_phase`)
F32_GRAD_TOL = 1e-4  # x each gradient's largest entry
F32_WEIGHT_TOL = 1e-5  # abs, the weights after the step
F32_NEAR_ZERO = 100  # x the card-CPU gradient difference: Adam's sensitive entries


def compare_f32_steps(c: dict, g: dict, start: dict, lr: float):
    """(readings, failures) of a card f32 step `g` against the CPU's `c`:
    the loss within 1e-5 relative, each gradient within F32_GRAD_TOL of its
    largest entry, the weights after the step within F32_WEIGHT_TOL.  Two
    kinds of entries are held to Adam's first-step bound (2 lr) instead:
    those of ZERO_GRAD (a zero true gradient, rounding noise on both sides)
    and those whose CPU gradient lies within F32_NEAR_ZERO times the
    card-CPU difference of zero: Adam's first step lr g / (|g| + eps) is
    flat in g but near 0, where it turns a gradient's rounding difference dg
    into up to lr eps dg / g^2 (and flips with g's sign); they are counted."""
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    grad_rel, grad_worst, weight_abs, weight_worst, free, step_max = 0.0, "", 0.0, "", 0, 0.0
    for n, ref in c["grads"].items():
        if not ref.numel():
            continue
        diff = (g["grads"][n] - ref).abs()
        new_c, new_g = c["sd"][n], g["sd"][n]
        if n.endswith(ZERO_GRAD):
            step_max = max(step_max, (new_g - start[n].float()).abs().max().item())
            continue
        rel = diff.max().item() / max(ref.abs().max().item(), 1e-30)
        if rel > grad_rel:
            grad_rel, grad_worst = rel, n
        undecided = ref.abs() <= F32_NEAR_ZERO * diff
        free += int(undecided.sum())
        step_max = max(step_max, (new_g - start[n].float()).abs().max().item())
        werr = (new_g - new_c).abs()[~undecided]
        if werr.numel() and werr.max().item() > weight_abs:
            weight_abs, weight_worst = werr.max().item(), n
    res = dict(loss_rel=loss_rel, grad_rel=grad_rel, grad_worst=grad_worst,
               weight_abs=weight_abs, weight_worst=weight_worst, sign_undecided_entries=free,
               step_max_over_lr=step_max / lr)
    limits = dict(loss_rel=1e-5, grad_rel=F32_GRAD_TOL, weight_abs=F32_WEIGHT_TOL,
                  step_max_over_lr=2.0 * (1 + 1e-6))
    return res, [k for k, lim in limits.items() if res[k] > lim]


def f32_planted_faults():
    """K11 f32 with act rounded to bf16 in its 3xTF32 tile (the f32 form must
    keep it f32: a copy of ffn_tc32.cu built with CT_FF_TC32_ACT_BF16=1
    launched for the whole backward), and K12b f32's and K7 dense f32's
    `tc32_planted_faults` (D_i forced to 0; the backward in plain TF32; the
    forward in plain TF32)."""
    from ct_clip_tpu_torch.ops import ffn
    from ct_clip_tpu_torch.ops import kernels as K

    act_bf16 = K.copy_library("ffn_tc32.cu", CT_FF_TC32_ACT_BF16=1)
    faults = {"K11 f32 with act rounded to bf16": (
        ffn, "_geglu_ff_bwd_tc32", functools.partial(ffn._geglu_ff_bwd_tc32, lib=act_bf16))}
    for name, (wrapper, broken) in tc32_planted_faults("K12b f32", "K7 dense f32").items():
        faults[name] = (K, wrapper, broken)
    return faults


def tiny_maskgit_f32_phase(dev, work: Path) -> dict:
    """The tiny MaskGit step of `tiny_maskgit_phase` in f32 on both sides:
    the card's K7 dense f32 (CUDA cores), K12b f32 (attention_tc32.cu, its
    launches asserted), K3 / K11 f32 and the PEG's f32 stencil against the
    CPU's plain versions, held by `compare_f32_steps`; then with each of
    `f32_planted_faults` (K11's act rounded to bf16, K12b f32's D_i forced
    to 0, K12b f32 in plain TF32), which must fail."""
    import torch

    from ct_clip_tpu_torch.config import MaskGitConfig
    from ct_clip_tpu_torch.models import MaskGit
    from ct_clip_tpu_torch.ops import kernels as K

    cfg = MaskGitConfig(dim=128, depth=2, dim_head=64, heads=2, max_seq_len=512, t5_dim=32)
    lr, grid = 1e-3, (2, 16, 16)
    n = int(np.prod(grid))
    g = torch.Generator().manual_seed(14)
    ids = torch.randint(0, 64, (4, n), generator=g)
    ctx = torch.randn((4, 6, 32), generator=g)
    ctx[1, 4:] = 0.0
    ctx[3, 2:] = 0.0
    draws = {"step": torch.randint(0, 18, (4,), generator=g),
             "scores": torch.rand((4, n), generator=g),
             "keep": torch.tensor([True, True, False, True])}
    start = {k: t.clone() for k, t in MaskGit(cfg, 64).init_weights(g).state_dict().items()}

    def side(device):
        return tiny_maskgit_side(cfg, start, (ids, ctx, draws, grid), device, torch.float32,
                                 lr, work / f"tiny_maskgit_f32_{device.type}_{len(faults)}")
    faults = {}
    c = side(torch.device("cpu"))
    K.reset_launch_counts()
    res, failures = compare_f32_steps(c, side(dev), start, lr)
    counts = K.launch_counts()
    log(f"reference: tiny MaskGit f32 step card vs CPU: loss rel {res['loss_rel']:.2e} (tol "
        f"1e-5), grads {res['grad_rel']:.2e} of max ({res['grad_worst']}; tol {F32_GRAD_TOL}), "
        f"updated weights abs {res['weight_abs']:.2e} ({res['weight_worst']}; tol "
        f"{F32_WEIGHT_TOL}; {res['sign_undecided_entries']} entries whose gradient is within "
        f"{F32_NEAR_ZERO}x its card-CPU difference of 0 held to the step bound), every step within "
        f"{res['step_max_over_lr']:.3f} lr (tol 2); K11 f32 launches {counts['geglu_ff_bwd_f32']}, "
        f"K12b f32 on attention_tc32.cu {counts['attention_tc32_bwd']}, K7 (dense) f32 "
        f"{counts['attention_tc32']}")
    if failures or not counts["geglu_ff_bwd_f32"] or not counts["attention_tc32_bwd"] \
            or counts["attention_tc32_bwd"] != counts["attention_dense_bwd"] \
            or counts["attention_tc32"] != counts["attention_dense"] + counts["fused_attention"] \
            or not counts["attention_tc32"]:
        raise AssertionError(f"tiny MaskGit f32 card vs CPU disagree on {failures}: {res}")
    res["faults"] = {}
    for name, (module, attr, broken) in f32_planted_faults().items():
        faults[name] = broken
        with replaced(module, attr, broken):
            fres, ffail = compare_f32_steps(c, side(dev), start, lr)
        log(f"reference: tiny MaskGit f32 step, planted fault '{name}': grads "
            f"{fres['grad_rel']:.2e} of max ({fres['grad_worst']}), weights abs "
            f"{fres['weight_abs']:.2e}; outside {ffail}")
        if not ffail:
            raise AssertionError(f"tiny MaskGit f32: planted fault '{name}' passes: {fres}")
        res["faults"][name] = dict(outside=ffail, **fres)
    return res


# --------------------------------------------------------------- phase 11
# the f32 forms of the CTViT backwards and the two f32 training steps
# kernel-name fragments of an f32 training step's groups (first match),
# ahead of the CT-CLIP step's
F32_TRAIN_GROUPS = (
    ("K9/K10 f32 attention core backward on the CUDA cores (qk_attention_bwd_f32_kernel: "
     "head dims other than 32, lengths off the other routes)",
     ("qk_attention_bwd_f32_kernel",)),
    ("K5 exact on f32 rows (gemm_argmax3_rows_kernel)", ("gemm_argmax3_rows",)),
    ("K15 f32 row sums (vq_segstats.cu: seg_sum<float>)", ("seg_sum<float",)),
    ("K6/K17 rearrange (rearrange_kernel, unrearrange_runs_kernel)",
     ("rearrange_kernel", "unrearrange_runs_kernel")),
) + CTCLIP_GROUPS


def qk_core_plain(q, kv, dout, heads: int, d: int, n: int, qs, ks, bias):
    """Plain version of the QK-norm attention core's backward on
    sequence-major (S * n, heads * d) projections q and kv [k | v]: the
    merged heads, dq, dkv, and the sums dq_scale (of the scale `qs` that
    includes the logit scale), dk_scale and dbias, by autograd in f32."""
    import torch

    from ct_clip_tpu_torch.ops.norms import l2norm

    hd = heads * d
    leaves = [t.detach().clone().requires_grad_() for t in (q, kv, qs, ks, bias)]
    ql, kvl, qsl, ksl, bl = leaves
    S = ql.shape[0] // n
    qn = l2norm(ql.view(S, n, heads, d)) * qsl
    kn = l2norm(kvl[:, :hd].reshape(S, n, heads, d)) * ksl
    v = kvl[:, hd:].reshape(S, n, heads, d)
    p = (torch.einsum("sihd,sjhd->shij", qn, kn) + bl).softmax(dim=-1)
    merged = torch.einsum("shij,sjhd->sihd", p, v).reshape(S * n, hd)
    grads = torch.autograd.grad(merged, leaves, dout)
    return (merged.detach(),) + grads


def qk_core_f32_case(dev, g, w, S: int, n: int) -> dict:
    """K9's f32 attention core alone (kernels.qk_attention_bwd) on (S, n)
    planes, 8 heads of 32, with an (8, n, n) bias, as the f32 sublayer's
    backward hands it over: 3xTF32 on qknorm_attention_tc32.cu against the
    plain version in true f32 (`qk_core_plain`, TF32 off): merged, dq and
    dkv within TC32_REL_TOL of max|plain|, the sums over all planes
    (dq_scale, dk_scale, dbias) within F32_REL_TOL; dbias's rows sum to zero
    within 16x the plain f32 version's rounding; a plain-TF32 copy
    (CT_TC32_PASSES=1) and the CUDA-core kernel's copy with P rounded to
    bf16 (CT_QK_BWD_F32_ROUND_P) must each miss TC32_REL_TOL; the replaced
    CUDA-core f32 kernel timed beside it."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    heads, d = 8, 32
    hd = heads * d

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, kv, dm, bias = rn(S * n, hd), rn(S * n, 2 * hd), rn(S * n, hd), rn(heads, n, n)
    qs, ks = w[3] * 8.0, w[4]
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d, q_strides=(n * hd, 0, d, hd),
                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), q_scale=qs, k_scale=ks, bias=bias,
                  group=-(-S // min(S, 33)), warps=8)
    tols = (TC32_REL_TOL,) * 3 + (F32_REL_TOL,) * 3
    hi_only = K.copy_library("qknorm_attention_tc32.cu", CT_TC32_PASSES=1)
    round_p = K.copy_library("qknorm_attention_bwd.cu", CT_QK_BWD_F32_ROUND_P=1)

    def kern():
        before = K.launch_counts()["qk_attention_tc32_bwd"]
        out = K.qk_attention_bwd(q, kv, dm, **layout)
        if K.launch_counts()["qk_attention_tc32_bwd"] != before + 1:
            raise AssertionError("K9 f32 core did not run on qknorm_attention_tc32.cu")
        return out

    def check(got, ref):
        rels = [_rel_errors((a,), (b,))[1] for a, b in zip(got, ref)]
        rows, plain_rows = (t[5].sum(-1).abs().max().item() for t in (got, ref))
        copies = {"plain TF32 (CT_TC32_PASSES=1)":
                  K.qk_attention_bwd(q, kv, dm, lib=hi_only, **layout),
                  "CUDA-core kernel with P rounded to bf16 (CT_QK_BWD_F32_ROUND_P=1)":
                  cuda_core_k9(lambda: K.qk_attention_bwd(q, kv, dm, lib=round_p, **layout))()}
        copy_rels = {k: max(_rel_errors((a,), (b,))[1] for a, b in zip(c[:3], ref[:3]))
                     for k, c in copies.items()}
        res = dict(max_abs_err=_rel_errors(got, ref)[0], max_rel_err=max(rels),
                   rel_err_by_output=rels, tolerance=f"rel {tols} by output; dbias rows within "
                   "16x the plain f32 version's sums; each copy outside the merged heads', "
                   "dq's and dkv's limit", dbias_row_sum_max=rows,
                   plain_f32_dbias_row_sum_max=plain_rows, copies_max_rel_err=copy_rels)
        log(f"kernel K9 f32 core (3xTF32) at ({S}, {n}): max_rel_err by output "
            f"{[f'{r:.2e}' for r in rels]} (limits {tols}); largest |row sum| of dbias "
            f"{rows:.3e}, plain f32 {plain_rows:.3e} (limit 16x); the copies "
            f"{ {k: f'{v:.2e}' for k, v in copy_rels.items()} } (must exceed {TC32_REL_TOL})")
        ok = all(r <= t for r, t in zip(rels, tols)) and rows <= 16 * plain_rows \
            and all(v > TC32_REL_TOL for v in copy_rels.values())
        return ok, res

    flops = 12 * S * heads * n * n * d
    return dict(kern=kern, plain=lambda: qk_core_plain(q, kv, dm, heads, d, n, qs, ks, bias),
                twin=cuda_core_k9(lambda: K.qk_attention_bwd(q, kv, dm, **layout)),
                twin_source="qknorm_attention_bwd.cu", check=check, bit_identical=True,
                library=None, inputs=(q, kv, dm, bias), outputs=(q, q, kv, bias),
                peak=PEAK_TF32_FLOPS, flops=3 * flops, f32_flops=flops)


def short_core_inputs(dev, g, w, B: int, n: int, S: int):
    """The short backward core's f32 inputs on a (B, n, S) token grid's
    t-columns (S = 1: B sequences), 8 heads of 32, as the sublayer's backward
    hands them over: (heads, d, heads d, sequences, q, kv, dmerged, order,
    layout, in_grid_order), `order` the grid's row of each sequence-major
    row (c = (b S + s) n + t), `in_grid_order` putting sequence-major rows
    back in the grid's order."""
    import torch

    heads, d = 8, 32
    hd, rows, sequences = heads * d, B * n * S, B * S
    q, kv, dm = (torch.randn((rows, width), generator=g, device=dev)
                 for width in (hd, 2 * hd, hd))
    c = torch.arange(rows, device=dev)
    order = ((c // n // S) * n + c % n) * S + c // n % S
    layout = dict(sequences=sequences, inner=S, heads=heads, n=n, d=d,
                  q_strides=(n * S * hd, hd, d, S * hd),
                  kv_strides=(n * S * 2 * hd, 2 * hd, d, S * 2 * hd), q_scale=w[3] * 8.0,
                  k_scale=w[4])

    def in_grid_order(t):
        out = torch.empty_like(t)
        out[order] = t
        return out
    return heads, d, hd, sequences, q, kv, dm, order, layout, in_grid_order


def short_core_f32_case(dev, g, w, B: int, n: int, S: int) -> dict:
    """K10's f32 attention core alone (kernels.qk_attention_short_bwd) on a
    (B, n, S) token grid's t-columns (S = 1: B sequences, sequence-major), 8
    heads of 32, as the f32 sublayer's backward hands it over: true f32 on
    qknorm_attention_short.cu against the plain version of its math
    (`qk_attention_bwd_core_plain` in f32, its rows put back in the grid's
    order): merged, dq and dkv (hi + lo of the planes it writes, row-major
    and transposed) within TC32_REL_TOL of max|plain|, dq_scale and dk_scale
    within F32_REL_TOL; the replaced CUDA-core kernel (qknorm_attention_bwd.cu's
    f32 form) timed beside it.  The timed call is the wrapper alone.  Bound:
    the function's own bytes, q, kv and dO read once and merged, dq and dkv
    written once in f32 (8 x 256 floats a row; the ten TF32 planes the kernel
    writes instead, 14 x 256 floats a row, are its layout's cost, not the
    function's); the six n x n x 32 products at the f32 CUDA-core peak."""
    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.qknorm_attention import GRID_GROUPS, qk_attention_bwd_core_plain

    heads, d, hd, sequences, q, kv, dm, order, layout, in_grid_order = short_core_inputs(
        dev, g, w, B, n, S)

    def plain():
        merged, dq, dkv, dqs, dks, _ = qk_attention_bwd_core_plain(
            q[order], kv[order], dm[order], heads, d, n, layout["q_scale"], layout["k_scale"],
            None)
        return in_grid_order(merged), in_grid_order(dq), in_grid_order(dkv), dqs, dks

    def check(got, ref):
        planes = [(got[0] + got[1], ref[1]), (got[2] + got[3], ref[2]),
                  (in_grid_order((got[4] + got[5]).t()), ref[0]),
                  (in_grid_order((got[6] + got[7]).t()), ref[1]),
                  (in_grid_order((got[8] + got[9]).t()), ref[2]),
                  (got[10], ref[3]), (got[11], ref[4])]
        tols = (TC32_REL_TOL,) * 5 + (F32_REL_TOL,) * 2
        rels = [_rel_errors((a,), (b,))[1] for a, b in planes]
        res = dict(max_abs_err=max(_rel_errors((a,), (b,))[0] for a, b in planes),
                   max_rel_err=max(rels), rel_err_by_output=rels,
                   tolerance=f"rel {tols} by output (dq, dkv row-major; merged, dq, dkv "
                   "transposed; dq_scale, dk_scale)")
        return all(r <= t for r, t in zip(rels, tols)), res

    def replaced_core():  # n < 32: kernels.qk_attention_bwd takes the CUDA-core kernel
        return K.qk_attention_bwd(q, kv, dm, group=-(-sequences // min(sequences, GRID_GROUPS)),
                                  warps=2, **layout)[:5]
    return dict(kern=lambda: K.qk_attention_short_bwd(q, kv, dm, **layout), plain=plain,
                check=check, twin=replaced_core,
                twin_source="qknorm_attention_bwd.cu (qk_attention_bwd_f32_kernel)",
                bit_identical=True, library=None, inputs=(q, kv, dm),
                outputs=(dm, q, kv),  # merged, dq, dkv: the same shapes
                peak=PEAK_F32_FLOPS, flops=12 * sequences * heads * n * n * d)


def short_core_bf16_case(dev, g, w, B: int, n: int, S: int) -> dict:
    """K10's bf16 attention core alone (kernels.qk_attention_short_bwd with
    out_dtype bf16) on a (B, n, S) token grid's t-columns (S = 1: B
    sequences, sequence-major), 8 heads of 32, as the bf16 sublayer's
    backward hands it over (f32 q, kv and dmerged): against the plain
    version at the TPU kernel's rounding points (`qk_short_bwd_core_plain`,
    rows put back in the grid's order) by `k10_bf16_check`, with the copy
    rounding P to bf16 (CT_QK_SHORT_BWD_ROUND_P), which must miss the mean
    tolerance; the replaced bf16 CUDA-core kernel (qknorm_attention_bwd.cu,
    K9's rounding points, on the inputs rounded to bf16) timed beside it.
    Bound: q, kv and dmerged read in f32, merged, dq and dkv written in
    bf16; the six n x n x 32 products at the f32 CUDA-core peak."""
    import functools

    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.qknorm_attention import GRID_GROUPS, qk_short_bwd_core_plain

    heads, d, hd, sequences, q, kv, dm, order, old, in_grid_order = short_core_inputs(
        dev, g, w, B, n, S)
    layout = dict(old, out_dtype=torch.bfloat16)

    def plain():
        merged, dq, dkv, dqs, dks = qk_short_bwd_core_plain(
            q[order], kv[order], dm[order], heads, d, n, layout["q_scale"], layout["k_scale"])
        return in_grid_order(merged), in_grid_order(dq), in_grid_order(dkv), dqs, dks

    copy = functools.partial(K.qk_attention_short_bwd, q, kv, dm, **layout, lib=K.copy_library(
        "qknorm_attention_short.cu", CT_QK_SHORT_BWD_ROUND_P=1))
    qb, kvb, dmb = q.bfloat16(), kv.bfloat16(), dm.bfloat16()

    def replaced_core():  # the bf16 CUDA-core kernel at n < 32, K9's rounding points
        return K.qk_attention_bwd(qb, kvb, dmb, group=-(-sequences // min(sequences, GRID_GROUPS)),
                                  warps=2, **old)[:5]
    # merged, dq and dkv: 4 heads x 32 bf16 a row
    outs = torch.empty((q.shape[0], 4 * hd), dtype=torch.bfloat16, device=dev)
    return dict(kern=lambda: K.qk_attention_short_bwd(q, kv, dm, **layout), plain=plain,
                check=k10_bf16_check(f"K10 bf16 core at ({B}, {n}, {S})", copy),
                twin=replaced_core,
                twin_source="qknorm_attention_bwd.cu (qk_attention_bwd_kernel, bf16 inputs)",
                bit_identical=True, library=None, inputs=(q, kv, dm), outputs=(outs,),
                peak=PEAK_F32_FLOPS, flops=12 * sequences * heads * n * n * d)


def f32_train_kernel_cases(dev):
    """The f32 training backwards at full width, each against its plain
    version in true f32 (TF32 off): K9 f32 through the sublayer's backward
    on the contrastive batch's (192, 576, 512) planes with the CPB bias and
    on the autoencoder's (160, 64, 512) with an (8, 64, 64) bias (its core
    3xTF32 on the tensor cores, bound at 3 TF32 products per f32 one, the
    f32 CUDA-core bound and the replaced CUDA-core core's time beside it),
    K10 grid f32 at (8, 24, 576, 512), K10 seq f32 at (4,608, 16, 512) and
    (512, 20, 512): dx within TC32_REL_TOL of max|plain|, the sums over all
    sequences (dgamma, dW, dq_scale, dk_scale, dbias) within F32_REL_TOL;
    K9's attention core alone on both planes (`qk_core_f32_case`); K5 exact on the batch's
    110,592 f32 rows against 8,192 codes (ids equal to the plain version of
    its own math up to ties within 1e-5; the share equal to the full-f32
    argmax reported); K15 on the same rows and the first 10,240, uniform and
    with half the rows in one code (`k15_case`: bins exact, sums within 1e-6
    of max of the plain version in the kernel's order, which the full-f32
    sums of the uniform rows must miss); K17 f32 as K6's backward on
    one f32 training volume
    (bit-exact).  Bounds: the bf16 rows' products at the f32 CUDA-core peak,
    K5 exact's three bf16 products at the bf16 peak, K15's bytes."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches, unrearrange_plain
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        _qknorm_attention_bwd_tc32, fused_grid_qknorm_attention, fused_small_qknorm_attention,
        fused_spatial_qknorm_attention, grid_qknorm_attention_bwd_plain,
        qknorm_attention_bwd_plain)
    from ct_clip_tpu_torch.ops.vq import (_lane_inv_norm, _split_rows, split_hi_lo, vq_assign,
                                          vq_assign_exact_rows_lane_plain, vq_assign_plain,
                                          vq_exact_rows_lane_sim)

    g = torch.Generator(device=dev).manual_seed(60)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    dim, heads, dh, hd = 512, 8, 32, 256
    R = TRAIN_B * 13824
    f32_case = dict(peak=PEAK_F32_FLOPS, library=None)
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
         rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2),
         rn(dim, hd, scale=hd ** -0.5))

    tf32_lib = K.copy_library("ffn_tc32.cu", CT_TC32_PASSES=1)
    round_p = K.copy_library("qknorm_attention_short.cu", CT_QK_SHORT_BWD_ROUND_P=1)

    def bwd_case(fwd, plain, x, do, extra, core, grid, core_tc32):
        # every product in 3xTF32 (ffn_tc32.cu): bound at 3 TF32 products per
        # f32 one; the core in 3xTF32 too (K9) or in f32 on the CUDA cores
        # (K10's short core: its operations counted at the f32 peak, scaled
        # to the TF32 one); the f32 CUDA-core bound beside it; the replaced
        # path (gemm.cu's FFMA products) timed beside the call; the products
        # in plain TF32 must miss the limits
        leaves = [t.clone().requires_grad_() for t in (x, *w, *extra)]
        out = fwd(*leaves)
        products = 2 * (x.numel() // dim) * dim * hd * 11
        kern = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        route = K.QK_TC32 if core_tc32 else K.QK_SHORT
        return dict(f32_case, kern=kern, plain=plain, inputs=(x, do, *w, *extra),
                    outputs=(x, *w, *extra), peak=PEAK_TF32_FLOPS, f32_flops=products + core,
                    flops=3 * (products + core) if core_tc32
                    else 3 * products + core * PEAK_TF32_FLOPS / PEAK_F32_FLOPS,
                    twin=replaced_qk_bwd_f32(kern),
                    twin_source=K9_F32_REPLACED if core_tc32 else K10_F32_REPLACED,
                    copies={"ffn_tc32.cu in plain TF32 (CT_TC32_PASSES=1)":
                            lambda: _qknorm_attention_bwd_tc32(
                                x, *w, *(extra or (None,)), do, heads, dh, 8.0, grid, route,
                                lib=tf32_lib)},
                    tols=(TC32_REL_TOL,) + (F32_REL_TOL,) * (6 + len(extra)))

    def with_round_p(case):
        # beside the plain-TF32 copy, the short core built with P rounded to
        # bf16 before the merged heads
        def run():
            with replaced(K, "qk_attention_short_bwd",
                          functools.partial(K.qk_attention_short_bwd, lib=round_p)):
                return case["kern"]()
        case["copies"]["the short core with P rounded to bf16 (CT_QK_SHORT_BWD_ROUND_P=1)"] = run
        return case

    def spatial(S, n):
        x, do, bias = rn(S, n, dim), rn(S, n, dim), rn(heads, n, n)
        return bwd_case(lambda *a: fused_spatial_qknorm_attention(*a, heads, dh),
                        lambda: qknorm_attention_bwd_plain(x, *w, bias, do, heads, dh),
                        x, do, (bias,), 12 * S * heads * n * n * dh, False, True)
    yield "spatial_attention_bwd_f32", spatial(TRAIN_B * 24, 576)
    yield "spatial_attention_bwd_f32_n64", spatial(AE_B * AE_FRAMES // 10, 64)
    xg, dog = rn(TRAIN_B, 24, 576, dim), rn(TRAIN_B, 24, 576, dim)
    yield "grid_attention_bwd_f32", with_round_p(bwd_case(
        lambda *a: fused_grid_qknorm_attention(*a, heads, dh),
        lambda: grid_qknorm_attention_bwd_plain(xg, *w, dog, heads, dh), xg, dog, (),
        12 * TRAIN_B * 576 * heads * 24 * 24 * dh, True, False))
    del xg, dog
    for name, (S, n) in (("seq_attention_bwd_f32", (CLIP160_B * 576, 16)),
                         ("seq_attention_bwd_f32_generatect", (AE_B * 64, 20))):
        x, do = rn(S, n, dim), rn(S, n, dim)
        yield name, with_round_p(bwd_case(
            lambda *a: fused_small_qknorm_attention(*a, heads, dh),
            lambda x=x, do=do: qknorm_attention_bwd_plain(x, *w, None, do, heads, dh)[:7],
            x, do, (), 12 * S * heads * n * n * dh, False, False))
        del x, do

    # the core alone on qknorm_attention_tc32.cu (3xTF32)
    yield "spatial_attention_bwd_f32_tc", qk_core_f32_case(dev, g, w, TRAIN_B * 24, 576)
    yield "spatial_attention_bwd_f32_tc_n64", qk_core_f32_case(dev, g, w, AE_B * AE_FRAMES // 10,
                                                               64)
    # K10's core alone on qknorm_attention_short.cu (true f32): the contrastive
    # grid's t-columns, the 160-frame and the autoencoder's sequences
    yield "grid_attention_bwd_f32_core", short_core_f32_case(dev, g, w, TRAIN_B, 24, 576)
    yield "seq_attention_bwd_f32_core", short_core_f32_case(dev, g, w, CLIP160_B * 576, 16, 1)
    yield "seq_attention_bwd_f32_core_generatect", short_core_f32_case(dev, g, w, AE_B * 64, 20,
                                                                       1)

    # K5 exact on vq_tc.cu (its splitting pre-pass, then three products a k
    # block) and K15 on the training batch's f32 rows, K5 also on the
    # autoencoder's 10,240: against the plain version of the kernel's own
    # math (the rows split in `_lane_inv_norm`'s order), gemm.cu's
    # gemm_argmax3_rows_kernel and a cuBLAS yardstick timed beside it
    xv, embed_n = rn(R, dim), l2norm(rn(8192, dim))
    hi, lo = split_hi_lo(embed_n)

    def k5_yardstick(x5):  # normalised, split, three f32 products, argmax
        xh, xl = _split_rows(x5, _lane_inv_norm)
        return (xh @ hi.float().t()).add_(xh @ lo.float().t()).add_(xl @ hi.float().t()) \
            .argmax(dim=-1)
    for label, x5 in (("vq_assign_exact_f32", xv), ("vq_assign_exact_f32_10240", xv[:10240])):
        yield label, dict(
            f32_case, kern=lambda x5=x5: vq_assign(x5, embed_n, exact=True),
            plain=lambda x5=x5: vq_assign_exact_rows_lane_plain(x5, embed_n),
            sim=lambda x5=x5: vq_exact_rows_lane_sim(x5, embed_n),
            f32_plain=lambda x5=x5: vq_assign_plain(x5, embed_n, exact=True),
            twin=lambda x5=x5: K.gemm_argmax(x5, hi, lo),
            twin_source="gemm.cu (gemm_argmax3_rows_kernel, WMMA)",
            yardstick=lambda x5=x5: k5_yardstick(x5),
            yardstick_is="rows normalised and split, xh c_hi^T + xh c_lo^T + xl c_hi^T in f32 "
                         "(cuBLAS), then argmax",
            inputs=(x5, embed_n), outputs=(torch.empty(x5.shape[0], dtype=torch.int32,
                                                       device=dev),),
            flops=2 * 3 * x5.shape[0] * dim * 8192, peak=PEAK_BF16_FLOPS, ids=True)
    del hi, lo
    # K15 on f32 rows as on bf16 rows in phase 6 (`k15_case`; the
    # autoencoder's ids in phase 8)
    for label, x15 in (("vq_cluster_stats_f32", xv), ("vq_cluster_stats_f32_10240", xv[:10240])):
        for dist in K15_IDS[:2]:
            yield label + K15_SUFFIX[dist], k15_case(
                x15, k15_ids(dist, x15.shape[0], g, dev),
                full_must_miss=label == "vq_cluster_stats_f32" and dist == "uniform")
    del xv, embed_n

    # K17 f32 as the backward of K6 on one f32 training volume
    video = rn(1, 240, 480, 480).requires_grad_()
    rows = rearrange_patches(video, 10, 20)
    drows = rn(*rows.shape)
    yield "unrearrange_patches_f32_bwd", dict(
        f32_case, kern=lambda: torch.autograd.grad(rows, video, drows, retain_graph=True),
        plain=lambda: unrearrange_plain(drows, 10, 20, 240, 480, 480),
        library=lambda: drows.reshape(1, 24, 24, 24, 10, 20, 20)
        .permute(0, 1, 4, 2, 5, 3, 6).contiguous(),
        inputs=(drows,), outputs=(drows,), flops=0, exact=True)


def f32_train_kernel_phase(dev) -> dict:
    """`f32_train_kernel_cases` through `train_kernel_phase`, the second
    shapes and the core nested under their kernel's entry (K17 f32 as K6's
    backward stays `unrearrange_patches_f32_bwd`, for phase 10's entry);
    every f32 form the cases drive must have launched."""
    from ct_clip_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    res = train_kernel_phase(dev, f32_train_kernel_cases(dev), TRAIN_B)
    counts = K.launch_counts()
    for k in ("spatial_attention_bwd_f32", "grid_attention_bwd_f32", "seq_attention_bwd_f32",
              "vq_assign_exact_f32", "vq_cluster_stats_f32", "unrearrange_patches_f32",
              "qk_attention_short_bwd_f32", "tc32_gemm", "tc32_gemm_tn", "vq_assign_exact_tc"):
        if not counts[k]:
            raise AssertionError(f"f32 training kernels: {k} never launched")
    res["vq_assign_exact_f32"]["at_10240"] = res.pop("vq_assign_exact_f32_10240")
    res["vq_assign_exact_f32"]["planted_ties"] = k5_exact_planted_ties(dev, "f32")
    for key in ("spatial_attention_bwd_f32", "spatial_attention_bwd_f32_tc"):
        res[key]["at_n64"] = res.pop(f"{key}_n64")
    res["seq_attention_bwd_f32"]["at_generatect"] = res.pop("seq_attention_bwd_f32_generatect")
    res["grid_attention_bwd_f32_short"] = res.pop("grid_attention_bwd_f32_core")
    res["grid_attention_bwd_f32_short"]["at_seq_4608x16"] = res.pop("seq_attention_bwd_f32_core")
    res["grid_attention_bwd_f32_short"]["at_seq_512x20"] = res.pop(
        "seq_attention_bwd_f32_core_generatect")
    return res


def tiny_f32_configs():
    """The tiny f32 CT-CLIP and autoencoder of the card-vs-CPU steps, whose
    VQ rows (256 and 640 of 128 dims against 768 codes, room for the tokens
    the codebook is seeded with) lie within the JAX package's plan, so the
    card takes K5 exact f32 and K15 f32: CT-CLIP on a
    cubic (4, 4, 4) grid (K1 / K9, K2 / K10 grid), its BERT one head of 64
    (K12a f32 on attention_tc32.cu); the autoencoder on a non-cubic (5, 8,
    8) grid (K9 at n = 64, K2 / K10 seq); and an autoencoder with heads of 32
    on a (16, 4, 4) grid (512 VQ rows), whose 16-token sequences take K10
    f32's short route (`kernels.qk_bwd_route`: qknorm_attention_short.cu's
    backward core and the 3xTF32 products)."""
    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig

    vit = dict(dim=128, codebook_size=768, patch_size=16, temporal_patch_size=4,
               spatial_depth=1, temporal_depth=1, dim_head=64, heads=2)
    clip = CTCLIPConfig(
        dim_text=64, dim_image=16 * 128, dim_latent=32,
        ctvit=CTViTConfig(image_size=64, num_frames=16, **vit),
        bert=BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=1, intermediate_size=128, hidden_dropout=0.0,
                        attention_dropout=0.0))
    short = dict(vit, dim_head=32, heads=4)
    return (clip, CTViTConfig(image_size=128, num_frames=20, with_decoder=True, **vit),
            CTViTConfig(image_size=64, num_frames=64, with_decoder=True, **short))


def k9_f32_round_p_fault():
    """K9 / K10 f32 launching a copy of qknorm_attention_bwd.cu built with
    CT_QK_BWD_F32_ROUND_P=1: P rounded to bf16 before the merged heads'
    product in the row pass."""
    import functools

    from ct_clip_tpu_torch.ops import kernels as K

    copy = K.copy_library("qknorm_attention_bwd.cu", CT_QK_BWD_F32_ROUND_P=1)
    return {"K9/K10 f32 with P rounded to bf16 in the row pass": (
        K, "qk_attention_bwd", functools.partial(K.qk_attention_bwd, lib=copy))}


def k10_short_round_p_fault():
    """K10 f32's short backward core launching a copy of
    qknorm_attention_short.cu built with CT_QK_SHORT_BWD_ROUND_P=1: P rounded
    to bf16 before the merged heads."""
    import functools

    from ct_clip_tpu_torch.ops import kernels as K

    copy = K.copy_library("qknorm_attention_short.cu", CT_QK_SHORT_BWD_ROUND_P=1)
    return {"K10 f32's short core with P rounded to bf16": (
        K, "qk_attention_short_bwd", functools.partial(K.qk_attention_short_bwd, lib=copy))}


# the f32 kernels each tiny f32 step must launch on the card
TINY_F32_KERNELS = {
    "CT-CLIP": ("spatial_attention_bwd_f32", "grid_attention_bwd_f32", "vq_assign_exact_f32",
                "vq_cluster_stats_f32", "geglu_ff_bwd_f32", "ff_tc32_tile", "tc32_gemm_tn",
                "attention_tc32_bwd"),
    "CTViT autoencoder": ("spatial_attention_bwd_f32", "seq_attention_bwd_f32",
                          "vq_assign_exact_f32", "vq_cluster_stats_f32", "geglu_ff_bwd_f32",
                          "ff_tc32_tile", "tc32_gemm_tn", "unrearrange_patches_f32"),
    "CTViT autoencoder, short route": ("spatial_attention_bwd_f32", "seq_attention_bwd_f32",
                                       "qk_attention_short_bwd_f32", "vq_assign_exact_f32",
                                       "vq_cluster_stats_f32", "geglu_ff_bwd_f32",
                                       "ff_tc32_tile", "tc32_gemm_tn",
                                       "unrearrange_patches_f32")}


def tiny_f32_train_phase(dev, work: Path) -> dict:
    """One tiny f32 CT-CLIP training step and two tiny f32 autoencoder
    generator steps (`tiny_f32_configs`), each from the same weights and
    inputs on the card (the f32 kernels) and on the CPU (plain versions),
    with the codebook at the CPU's own tokens: held by `compare_f32_steps`
    (gradients 1e-4 of max, the weights after the step 1e-5, Adam's
    sensitive entries to its step bound), every VQ id equal and the EMA
    state (codebook, cluster sizes) within 1e-5; then each with a planted
    fault that must fail: K9/K10 f32's P rounded to bf16 in
    qknorm_attention_bwd.cu's row pass, and on the short route's run also
    K10's short backward core with P rounded to bf16."""
    import torch

    from ct_clip_tpu_torch.config import TrainConfig
    from ct_clip_tpu_torch.models import CTCLIP, CTViT
    from ct_clip_tpu_torch.ops import kernels as K

    f32, lr = torch.float32, 1e-3
    clip_cfg, ae_cfg, short_cfg = tiny_f32_configs()
    g = torch.Generator().manual_seed(15)
    ids = torch.randint(5, 64, (4, 32), generator=g)
    mask = (torch.arange(32)[None] < torch.tensor([[32], [20], [9], [27]])).long()
    clip_video = torch.rand((4, 16, 64, 64, 1), generator=g) * 2 - 1
    ae_video = torch.rand((2, 20, 128, 128, 1), generator=g) * 2 - 1
    short_video = torch.rand((2, 64, 64, 64, 1), generator=g) * 2 - 1
    cpu_clip = CTCLIP(clip_cfg).init_weights(torch.Generator().manual_seed(16))
    seed_codebook_at_tokens(cpu_clip.visual_transformer, clip_video)
    cpu_ae = CTViT(ae_cfg).init_weights(torch.Generator().manual_seed(17))
    seed_codebook_at_tokens(cpu_ae, ae_video)
    cpu_short = CTViT(short_cfg).init_weights(torch.Generator().manual_seed(18))
    seed_codebook_at_tokens(cpu_short, short_video)
    tcfg = TrainConfig(lr=lr)
    runs = {
        "CT-CLIP": ({k: t.clone() for k, t in cpu_clip.state_dict().items()},
                    "visual_transformer.vq._codebook.",
                    lambda start, device: tiny_ctclip_side(
                        clip_cfg, tcfg, start, (ids * mask, mask, clip_video), device, f32)),
        "CTViT autoencoder": ({k: t.clone() for k, t in cpu_ae.state_dict().items()},
                              "vq._codebook.",
                              lambda start, device: tiny_ae_side(
                                  ae_cfg, start, ae_video, device, f32, lr,
                                  work / f"tiny_ae_f32_{device.type}")),
        "CTViT autoencoder, short route": (
            {k: t.clone() for k, t in cpu_short.state_dict().items()}, "vq._codebook.",
            lambda start, device: tiny_ae_side(short_cfg, start, short_video, device, f32, lr,
                                               work / f"tiny_ae_short_f32_{device.type}"))}
    faults = dict(k9_f32_round_p_fault())
    short_faults = dict(faults, **k10_short_round_p_fault())
    out = {}
    for label, (start, vq, side) in runs.items():
        c = side(start, torch.device("cpu"))

        def card_check(tag):
            K.reset_launch_counts()
            gside = side(start, dev)
            counts = K.launch_counts()
            res, failures = compare_f32_steps(c, gside, start, lr)
            res["id_agreement"] = (gside["codes"] == c["codes"]).float().mean().item()
            for key in ("embed", "cluster_size"):
                res[f"{key}_abs"] = (gside["sd"][vq + key] - c["sd"][vq + key]).abs().max().item()
            failures += [k for k, bad in (
                ("VQ ids", res["id_agreement"] < 1.0), ("codebook", res["embed_abs"] > 1e-5),
                ("cluster sizes", res["cluster_size_abs"] > 1e-5)) if bad]
            log(f"reference: tiny {label} f32 step card vs CPU, {tag}: loss rel "
                f"{res['loss_rel']:.2e} (tol 1e-5), grads {res['grad_rel']:.2e} of max "
                f"({res['grad_worst']}; tol {F32_GRAD_TOL}), updated weights abs "
                f"{res['weight_abs']:.2e} ({res['weight_worst']}; tol {F32_WEIGHT_TOL}; "
                f"{res['sign_undecided_entries']} entries held to the step bound), steps within "
                f"{res['step_max_over_lr']:.3f} lr; VQ ids equal {res['id_agreement']:.4f}, "
                f"codebook abs {res['embed_abs']:.2e}, cluster sizes abs "
                f"{res['cluster_size_abs']:.2e} (tol 1e-5); outside {failures or 'none'}; f32 "
                f"launches { {k: counts[k] for k in TINY_F32_KERNELS[label]} }")
            return res, failures, counts
        res, failures, counts = card_check("kernels as built")
        missing = [k for k in TINY_F32_KERNELS[label] if not counts[k]]
        if failures or missing:
            raise AssertionError(f"tiny {label} f32 step: card and CPU disagree on {failures}, "
                                 f"kernels not launched {missing}: {res}")
        res["faults"] = {}
        for name, (module, attr, broken) in (short_faults if "short" in label
                                             else faults).items():
            with replaced(module, attr, broken):
                fres, ffail, _ = card_check(f"planted fault '{name}'")
            if not ffail:
                raise AssertionError(f"tiny {label} f32 step: planted fault '{name}' passes")
            res["faults"][name] = dict(outside=ffail, **fres)
        out[label] = res
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from ct_clip_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t0 = time.perf_counter()
    K.library()
    log(f"build: kernels compiled and loaded in {time.perf_counter() - t0:.1f} s "
        f"({K.library_path().name})")

    results = kernel_phase(dev)
    k3_phase(dev, results)
    k1_phase(dev, torch.bfloat16, results)
    k2_phase(dev, torch.bfloat16, results)
    results.update(train_attention_phase(dev))
    results.update(train_kernel_phase(dev))
    nest_k15(results, "vq_cluster_stats")
    results.update(peg_phase(dev))
    results["vq_assign_exact"]["at_10240"] = results.pop("vq_assign_exact_10240")
    results["vq_assign_exact"]["planted_ties"] = k5_exact_planted_ties(dev, "bf16")
    results["attention_dropout_bf16"].update(k13a_bf16_checks(dev))
    work_root = ROOT / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=work_root))
    try:
        counts, route_diff, batch_ms, batch_profile = end_to_end_phase(dev, work, card)
        radbert = radbert_phase(dev, work, card)
        counts.update(radbert.pop("counts"))
        counts["bert_bf16_dropout_off"] = bert_bf16_dropout_off(dev)
        results.update(train_kernel_phase(dev, bert_bf16_bwd_cases(dev), TRAIN_B))
        ref_errs = small_reference_phase(dev, work)
        radbert_ref = radbert_reference_phase(dev, work)
        radbert_drop_ref = radbert_reference_phase(dev, work, DROP_RATE)
        corpus = write_train_corpus(work)
        ctclip = ctclip_train_phase(dev, work, card, corpus)
        counts["ctclip_train"] = ctclip.pop("counts")
        ctclip_ref = ctclip_train_reference_phase(dev, work)
        results.update(train_kernel_phase(dev, embed_bwd_cases(dev), AUX_B))
        results["patch_embed_bwd"]["with_dvideo"] = results.pop("patch_embed_bwd_dvideo")
        results["row_embed_bwd"]["without_drows"] = results.pop("row_embed_bwd_weights")
        embed_grad = embed_grad_phase(dev)
        counts["embed_grad"] = embed_grad.pop("counts")
        aux = aux_train_phase(dev, work, card, corpus, counts["ctclip_train"])
        for name, run in aux.items():
            counts[name] = run.pop("counts")
        aux_ref, _, _, _ = tiny_step_check(dev, tiny_aux_config(), aux_planted_faults(),
                                           "CT-CLIP with MLM, visual SSL and FILIP",
                                           noise_seeds=AUX_NOISE_SEEDS)
        seq = train_kernel_phase(dev, seq_kernel_cases(dev), CLIP160_B)
        for key in ("seq_attention", "seq_attention_bwd"):
            results[key] = dict(seq[key], at_generatect=seq[key.replace(
                "seq_attention", "seq_attention_generatect")])
        for key in ("spatial_attention", "spatial_attention_bwd", "spatial_attention_bwd_tc"):
            results[key]["at_n64"] = seq[key.replace("spatial_attention",
                                                     "spatial_attention_n64")]
        for at in ("seq16", "generatect"):
            results["grid_attention_bwd_short"][f"at_{at}"] = \
                seq[f"grid_attention_bwd_short_{at}"]
        ae = ctvit_ae_phase(dev, work, card)
        counts.update(ae.pop("counts"))
        results.update(train_kernel_phase(dev, k15_ae_cases(dev, *ae.pop("vq_rows")), AE_B))
        nest_k15(results, "vq_cluster_stats")
        recon = reconstruct_phase(dev, work, card)
        counts["reconstruct"] = recon.pop("counts")
        clip160 = ctclip_160_phase(dev, work, card, corpus)
        counts.update(clip160.pop("counts"))
        ae_ref = tiny_ae_phase(dev, work)
        ae_ref["short_route_bf16"] = tiny_ae_short_phase(dev, work)
        results.update(dense_attention_phase(dev))
        mg = maskgit_phase(dev, work, card)
        counts.update(mg.pop("counts"))
        mg_ref = tiny_maskgit_phase(dev, work)
        results.update(f32_kernel_phase(dev))
        k1_phase(dev, torch.float32, results)
        k2_phase(dev, torch.float32, results)
        zs32 = zero_shot_f32_phase(dev, work, card, counts)
        counts.update(zs32.pop("counts"))
        ref32 = small_reference_f32_phase(dev, work)
        mg32 = maskgit_f32_phase(dev, work, card)
        counts.update(mg32.pop("counts"))
        mg32_ref = tiny_maskgit_f32_phase(dev, work)
        train32 = f32_train_kernel_phase(dev)
        k17 = train32.pop("unrearrange_patches_f32_bwd")
        results.update(train32)
        nest_k15(results, "vq_cluster_stats_f32")
        results["unrearrange_patches_f32"]["as_k6_backward"] = k17
        clip32 = ctclip_train_phase(dev, work, card, corpus, "f32")
        counts["ctclip_f32_train"] = clip32.pop("counts")
        ae32 = ctvit_ae_phase(dev, work, card, "f32")
        counts.update(ae32.pop("counts"))
        del ae32["vq_rows"]
        train32_ref = tiny_f32_train_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for key, k in KERNELS.items():
        by_path = {path: c[k["counter"]] for path, c in counts.items()
                   if k["counter"] in PATHS[path]}
        table.append({"name": k["name"], "route": "cuda", "source": CSRC + k["source"],
                      "sources": [CSRC + f for f in k["sources"]], "replaces": k["replaces"],
                      "counter": k["counter"], "main_path": k["path"],
                      "launches": counts[k["path"]][k["counter"]],
                      "launches_by_path": by_path, **results[key]})
    print(json.dumps({"e2e": {"score_batch_ms": batch_ms, "batch": B,
                              "score_batch_profile_rows": batch_profile,
                              "route_max_abs_diff": route_diff,
                              "tiny_card_vs_cpu_max_abs_diff": ref_errs,
                              "radbert": radbert, "radbert_tiny_card_vs_cpu": radbert_ref,
                              "radbert_dropout_tiny_card_vs_cpu": radbert_drop_ref,
                              "ctclip_train": ctclip,
                              "ctclip_train_tiny_card_vs_cpu": ctclip_ref,
                              "embed_grad": embed_grad, "ctclip_aux": aux,
                              "ctclip_aux_tiny_card_vs_cpu": aux_ref, "ctvit_ae": ae,
                              "reconstruct": recon, "ctclip_160": clip160,
                              "ctvit_ae_tiny_card_vs_cpu": ae_ref, "maskgit": mg,
                              "maskgit_tiny_card_vs_cpu": mg_ref, "zero_shot_f32": zs32,
                              "tiny_f32_card_vs_cpu": ref32, "maskgit_f32": mg32,
                              "maskgit_f32_tiny_card_vs_cpu": mg32_ref,
                              "ctclip_train_f32": clip32, "ctvit_ae_f32": ae32,
                              "f32_train_tiny_card_vs_cpu": train32_ref}}),
          flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
