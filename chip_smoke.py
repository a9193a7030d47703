"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):

1. card identity (nvidia-smi name and power limit); a CUDA device is
   required, there is no CPU fallback;
2. build the CUDA kernels from grav1synth_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, integer-
   equal, over 4:2:0/4:2:2/4:4:4 x 8/10/12-bit x small odd and even sizes,
   the edge geometries of the vectorised luma, chroma-pair and fused
   kernels
   (widths 520-535, every residue mod 8, at odd and even heights, with
   planes switched off in mixed batches; a batch slice whose frame bases
   are not 16-byte aligned; more work units than resident CTAs) and at
   3840x2160 10-bit 4:2:0 with 16 frames (the kernels reading grain_ref's
   patterns); two small frames also through ``apply_grain`` against
   grain_ref on the host;
4. the main path at full size: the frame parameters of
   .bench_cache/bench_4k10_grainy.ivf (3840x2160, 10-bit, 4:2:0), parsed
   on the host and reseeded to batches of 16 and 112, applied through
   ``ops.grain.apply_grain`` on the card (3-plane and luma-only tables;
   each batch one parameter program with the tables and pattern kernels
   in it, captured here and replayed, then the fused grain kernel, or
   the luma kernel alone for luma-only tables), first frames checked
   against grain_ref and every frame against the luma and chroma-pair
   kernels on grain_ref's patterns, the tables, pattern, fused, luma and
   chroma-pair kernels' launches and the programs' replays counted, one a
   batch once the programs are captured (the luma kernel only for the
   luma-only tables, the chroma-pair kernel never); then kernel times
   (CUDA events, on grain_ref's patterns) beside the plain versions', the
   fused kernel's at B = 16 and 112 beside the luma and chroma-pair
   kernels' on the same inputs, and apply frames/s; then the same main
   path at the 4K benchmark cells' layouts and tables (``CELL_LAYOUTS``:
   uhd10_420, uhd10_422 at 3840x2160 10-bit 4:2:2 and uhd12_444 at 12-bit
   4:4:4, tables drawn as those cells draw them by the benchmark's own
   ``draw_tables``, uhd10_422's with 14 luma, 10 Cb and 10 Cr points, AR
   lag 3, overlap and the restricted-range clip on; frame k of a batch
   takes table k % 64): batches of 16 and 112, the fused kernel's
   instantiation of the layout counted (``launch.grain_fused.<sx><sy>``),
   the kernels against their plain versions at B = 16, every frame
   against the luma and chroma-pair kernels on grain_ref's patterns and
   the first and last frames against grain_ref, then the fused kernel's
   times at B = 16 and 112 beside its bytes bound and beside the luma and
   chroma-pair kernels on the same inputs, and apply frames/s;
5. the two diff kernels against their plain versions on the card, equal
   to the last bit, over 4:2:0/4:2:2/4:4:4 x 8/10/12-bit x lag 1-3 x
   small odd and even sizes (a plane under 16 px included) and at
   3840x2160 10-bit 4:2:0 with 16 frames; the statistics kernel also at
   the ends of the ranges its 32-bit sums rest on (12-bit r = +-4095, aux
   = +-16380, every block flat), on a plane 10000 rows tall and on rows
   off the 16-byte boundary; the flat-block activity kernel also at widths
   512-543 (every residue mod 16) x heights 64, 65, 79, 129 over the whole
   int16 range, on bases off the 16-byte boundary, on samples alternating
   -32768 / 32767 and on more CTAs than the card holds at once;
6. the diff main path at full size: film-like clean frames at 3840x2160
   10-bit 4:2:0 made from a numpy seed, grained on the card by
   ``apply_grain`` with the stream's tables reseeded per frame, then two
   batches of 16 (grainy as source, clean as denoised) through
   ``DiffEstimator.diff_batch`` on the card; the fitted table must equal
   the one fitted from the plain versions' statistics, and the recovered
   luma sigma curve is scored against the injected one; then each diff
   kernel's time (CUDA events) beside its plain version's at 4K10 B = 16
   and 1080p8 B = 32 (lag 2; the statistics kernel also at lag 3), and
   diff_batch frames/s with the upload and the statistics download
   included;
7. the single-chroma-plane kernel against its plain version on the card,
   integer-equal, over the sizes of phase 3, at its edges (luma widths
   520-535 with planes switched off, bases off the 16-byte boundary, more
   units than resident CTAs, offsets larger than the plane) and, as its
   main path, the entry point ``apply_plane_chroma`` on Cb and Cr at
   3840x2160 10-bit
   4:2:0 with 16 frames (averaged luma from ``_avg_luma``): equal to the
   plain version, to the chroma-pair kernel and, on frame 0, to
   grain_ref; two small frames also against grain_ref; then its time
   (CUDA events) beside its plain version's;
8. the blur and self-statistics kernels of the estimate path against their
   plain versions on the card, equal to the last bit, over 4:2:0/4:2:2/
   4:4:4 x 8/10/12-bit x lag 0-3 x small odd and even sizes (planes under
   9 and under 16 samples) and at 3840x2160 10-bit 4:2:0 with 16 frames,
   luma and chroma with the pooled luma column; the blur also at widths
   520-531 (every residue of its 4-column lanes), on uint8 planes, on bases
   off the 16-byte boundary, on 41,000 CTAs and over the int16 range; the
   statistics on the 12-bit 0/max checkerboard (|q| = 40 max), a plane
   10000 rows tall and q/den/lsum off the 16-byte boundary. Then the
   estimate main path at full size: the grained film-like frames of phase
   6, two batches of 16 through ``NoiseEstimator.push_batch`` and
   ``finish`` on the card, with the blur, flat-block and statistics
   kernels' launches counted exactly (once a plane and batch); the table
   must equal the one from the same estimator on the plain versions, and
   the blur, residual, flat map and statistics of the first two frames
   must equal the port's CPU run (an entry whose raw sum may pass 2^53 at
   rtol 1e-9); the recovered luma sigma curve is scored against the
   injected one; then both kernels' times (CUDA events) beside their plain
   versions' and bounds (the blur also beside one cuDNN convolution of
   its box sum; the statistics kernel alone, around its C launches, beside
   its wrapper's time and its padded tensor-core floor, at lag 2 and 3);
   the statistics kernel on a textured plate at 3840x2160 10-bit 4:2:0
   B = 16 (a third of the blocks textured, whole tiles without a flat
   block, flat blocks on the band's edge), equal to its plain version at
   lags 0-3 and timed at lag 2; the "[dmma]" line: the float64
   tensor-core MMA shapes m8n8k4, m16n8k4, m16n8k8 and m16n8k16 on one SM
   (multiply-adds a clock and latency by clock64, and a Gram through each
   shape's fragments held to D^T D; the shape K9 uses must hold); and
   push_batch frames/s with the upload and the
   statistics download, its device busy and idle share and its device
   time by entry under torch.profiler;
9. the grain-pattern kernel against its plain version on the card, equal
   (tolerance 0), over 8/10/12-bit x 4:2:0/4:2:2/4:4:4/monochrome with
   mixed batches (AR lag 0-3, grain_scale_shift 0-3, chroma scaling from
   luma, inactive planes), batches of one lag each (0-3) and lag-2 frames
   with a stray lag-3 slot, and on the 16 and 112 reseeded frames of
   phase 4 against grain_ref's patterns; then the pattern kernel's time
   (CUDA events) at lag 2 and lag 3 beside its plain version's, its chain
   bound and grain_ref's host ms/frame;
10. the sharded paths: ``sharded_apply_with_stats`` over ``make_mesh()``
   (every card) and over a two-shard mesh that names the card twice, at
   4K10 B = 16, equal to the unsharded output, frames exact, energy
   within rtol 1e-6 of an int64 recount; ``DiffEstimator.diff_batch``
   over the two-shard mesh fits phase 6's table; the entry point
   ``entry.dryrun_multichip(1)``;
11. distributed: two processes on one card. The script spawns two ranks
   (spawn start method) that join one gloo process group through
   ``parallel.distributed.initialize``, each with the card as its local
   mesh. Each rebuilds phase 4's 4K10 B = 16 planes and reseeded
   parameters from the same seed and applies its 8 frames through
   ``sharded_apply_with_stats`` over the ``ProcessMesh`` (patterns made on
   the card): every frame equal by sha256 to phase 10's unsharded output,
   frames 16 and energy equal to the int64 recount on both ranks, the
   tables, pattern and fused kernels launched once in each rank; then
   ``mesh_pair_stats_per_frame`` over the two ranks on phase 6's first
   batch of 16 (lag 2): the whole batch's per-frame statistics on each
   rank equal to the single-process ones to the last bit, both diff
   kernels launched 3 times or more in each rank. The two-rank apply's
   frames/s (host clock) is printed beside phase 10's two-shard number,
   with each exchange alone (host copies and gloo); two ranks on one card
   take turns on its SMs, so it is no scaling figure. A rank that fails or hangs (waited for with a timeout, then
   killed) fails the script, its log's tail printed;
12. the parameter program (``ops.program``): at 3840x2160 10-bit 4:2:0,
   B = 16 and 112 (the latter a ragged batch of a program made at 128),
   patterns made on the card, 3-plane tables (the chroma tables and kernel
   on) and luma-only tables (off, as ``pack_params`` reads the tables):
   every frame of the graph path equal to the
   program's eager body on the card followed by the same kernels, frame 0
   to grain_ref (chroma to the input where it is off); captures, replays and the
   tables, pattern, fused and luma kernels' launches counted exactly;
   each program's graph nodes (read through libcuda: two kernel nodes, the
   tables and pattern kernels, and at most one memset or memcpy), capture
   ms and device time a replay; the tables kernel on each program's whole
   static input equal (tolerance 0) to its plain version, the PyTorch ops
   of ``program.program_tables`` captured as a graph of their own, and
   both timed (the kernel as 20 launches in one graph, the plain tables'
   graph a replay) beside the kernel's bound and both graphs' nodes; the
   host ms of ``pack_params`` (on one table with new
   seeds and on a table a frame, with the rows it built); per batch the
   host issue ms, device busy
   ms and idle share (torch.profiler) of both paths, and both paths'
   frames/s in turns (eager, graph, graph, eager);
13. render's host staging (``pipelines._upload``) at 3840x2160 10-bit
   and 1920x1080 8-bit 4:2:0, B = 16 uint16 or uint8 planes, the 4K
   luma also as strided views: every batch equal on the card to the
   planes' int16 stack, ``upload.frames`` counting each frame, twelve
   batches in render's FIFO (one in flight) pinning no new block after
   the first two, and the host ms a batch of the three planes.

Every ``apply_grain`` makes its grain patterns on the card, inside the
batch's parameter program (one graph replay); the kernels timed or held
alone read grain_ref's patterns from the host (the native libav*/dav1d
shim, and with it ``generate_patterns_native`` and the render pipeline's
decoder, is not built on hosts without those libraries).

Every ``[time]`` line gives the kernel's time beside its plain version's
and its bound: the larger of the bytes it must move (inputs read once,
outputs written once) over the card's 3.35 TB/s and its operations over
the card's peak for their type (integer ones over the int32 rate, the
self-statistics' float64 multiply-adds over the tensor cores' float64
rate, with their bound outside the tensor cores beside it), computed
from that run's inputs, and the share (bound / time). The pattern kernel is a dependent chain, which that
bound does not see: its lines add the chain bound, the wavefront steps of
the slowest frame times the least cycles a step can take, which a loop of
the step's dependent instructions measures in the same run (the "[chain]"
line) with the SM clock it ran at. No PyTorch call computes any kernel's function but
the blur's box sum (``library_ms`` of ``self_blur``: one convolution), so
the others' ``library_ms`` is null. The script ends by checking that neither jax nor
any module of the JAX package ``grav1synth_tpu`` was imported.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import logging
import multiprocessing
import multiprocessing.connection
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from grav1synth_tpu_torch.utils import spans

IVF = ".bench_cache/bench_4k10_grainy.ivf"
SOURCES = {
    "grain_luma": "grav1synth_tpu_torch/csrc/grain_kernels.cu",
    "grain_chroma_pair": "grav1synth_tpu_torch/csrc/grain_kernels.cu",
    "grain_fused": "grav1synth_tpu_torch/csrc/grain_kernels.cu",
    "grain_chroma": "grav1synth_tpu_torch/csrc/grain_kernels.cu",
    "grain_pattern": "grav1synth_tpu_torch/csrc/pattern_kernels.cu",
    "grain_tables": "grav1synth_tpu_torch/csrc/tables_kernels.cu",
    "flat_block_activity": "grav1synth_tpu_torch/csrc/diff_kernels.cu",
    "plane_stats": "grav1synth_tpu_torch/csrc/diff_kernels.cu",
    "self_blur": "grav1synth_tpu_torch/csrc/estimate_kernels.cu",
    "self_stats": "grav1synth_tpu_torch/csrc/estimate_kernels.cu",
}
REPLACES = {
    "grain_luma": "grav1synth_tpu/ops/grain_pallas.py:575",  # _luma_kernel
    "grain_chroma_pair": "grav1synth_tpu/ops/grain_pallas.py:775",  # _chroma_pair_kernel
    "grain_fused": "grav1synth_tpu/ops/grain_pallas.py:885",  # _fused_kernel
    "grain_chroma": "grav1synth_tpu/ops/grain_pallas.py:584",  # _chroma_kernel
    # _ar_filter: an XLA lax.scan (with _gaussian_base and
    # _ar_filter_chroma), not a Pallas kernel
    "grain_pattern": "grav1synth_tpu/ops/grain_jax.py:266",
    # not a Pallas kernel: the jitted apply's glue, block_offsets (:400) with
    # lfsr_outputs (:206), _scaling_eval8 (:553) and the per-plane rows
    "grain_tables": "grav1synth_tpu/ops/grain_jax.py:400",
    "flat_block_activity": "grav1synth_tpu/ops/diff_pallas.py:272",  # _act_kernel
    "plane_stats": "grav1synth_tpu/ops/diff_pallas.py:108",  # _stats_kernel
    # not Pallas kernels: XLA inside the jitted frame_self_stats (:77) and
    # frame_self_stats_chroma (:114)
    "self_blur": "grav1synth_tpu/ops/estimate.py:52",  # _box_blur, round and clip :85-88
    # _masked_normal_eqs (:128) and _binned_moments (:175)
    "self_stats": "grav1synth_tpu/ops/diff_estimate.py:128",
}
# integer arithmetic (grain, blur) and exact int64 / float64 sums (diff,
# estimate statistics): the kernels and their plain versions must be equal
TOLERANCE = 0
# the estimate statistics on the card against the CPU run: equal, but for an
# entry whose raw integer sum may pass 2^53, where the CPU's float64 sums,
# taken in another order, may round
ESTIMATE_RTOL = 1e-9
KERNELS = (
    "grain_luma", "grain_chroma_pair", "grain_fused", "grain_chroma", "grain_pattern",
    "grain_tables",
    "flat_block_activity", "plane_stats", "self_blur", "self_stats",
)
# energy of the sharded apply (an exact int64 sum per shard, added in
# float64) against an int64 recount
ENERGY_RTOL = 1e-6
# phase 11: the process group's timeout (start-up and each collective), and
# how long the script waits for both ranks
RANK_GROUP_TIMEOUT = 180.0
RANK_WAIT = 480.0
# what a kernel's entry of the summary line may carry beside the common keys
EXTRA_KEYS = ("label", "chain_bound_ms", "chain_steps", "chain_step_cycles", "sm_clock_mhz",
              "fp64_core_bound_ms", "wrapper_ms", "padded_floor_ms", "other_cases")
# (sub_x, sub_y, monochrome) of the pattern kernel's cases
PATTERN_LAYOUTS = ((1, 1, False), (1, 0, False), (0, 0, False), (1, 1, True))

# The card's peaks for a kernel's bound (H100 SXM at 700 W): HBM3 at
# 3.35 TB/s. For int32 outside the tensor cores, an SM has 64 int32 lanes
# against 128 float32 ones, so half of its 67 TFLOP/s float32 rate, a
# multiply-add counted as two operations. float64 runs at 67 TFLOP/s on the
# tensor cores (DMMA), the card's peak for the type, and at half that
# outside them (the data sheet's 34 TFLOP/s), where a float64 multiply-add
# of the self-statistics runs today: its bound takes the first, and its line
# adds the second as its own ceiling.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FP64_OPS_PER_S = 67e12
FP64_CORE_OPS_PER_S = 33.5e12
# Integer operations of the grain arithmetic per sample (a multiply-add
# counts two): scaling input clamp 2, scale x noise + rounding 2, shift 1,
# add 1, clip 2. Chroma adds the pair average (3 per sample, shared by Cb
# and Cr) and, where a plane combines luma and chroma, two multiply-adds,
# a shift, the offset and a clamp (8).
GRAIN_OPS, AVG_OPS, COMBINE_OPS = 8, 3, 8
# flat-block activity: two differences, two absolute values, two adds
ACTIVITY_OPS = 6
# the tables kernel: a LUT node's test of one segment (two compares, their
# AND, the select) and the segment's value (a subtraction, a multiply-add,
# the shift, the add): 8; an LFSR update (three shifts, three XORs, the
# mask, the shift and the OR) with its 8-bit output: 10
TABLE_SEGMENT_OPS, LFSR_OPS = 8, 10
# blur, per sample: the vertical and horizontal running sums (an add and a
# subtraction each), the rounding add and the division by 81 (a multiply-
# high and a shift), the clip (2) and q = 81 f - S (a multiply-add)
BLUR_OPS = 11
# pattern generation: per Gaussian sample an LFSR step, the table read and
# a Round2 (6); per AR position a Round2 and a clamp (4) beside one
# multiply-add per tap
GAUSS_OPS, AR_POS_OPS = 6, 4
# The least cycles one wavefront step of the pattern kernel can take is
# measured in the run that states it (``chain_step_cycles``): one warp loops
# over exactly the instructions that wait for one another in a step. With
# the wavefront slope at lag + 1 (lag 2 and 3) the result of step t - 1
# crosses to the lane below by one warp shuffle, then a multiply-add, the
# Round2 shift, the add to the base sample and the two halves of the clamp.
# At lag 1 the slope is 3, the sample from the row above is two steps old,
# and the chain is the same without the shuffle. out[0] = cycles by
# clock64, out[1] = the value (so that the loop is kept).
CHAIN_SRC = r"""
#include <cuda_runtime.h>
template <bool SHUFFLE>
__global__ void chain(long long* out, int iters, int c, int e, int shift, int base) {
  const int up = (threadIdx.x + 31) & 31;
  int v = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    int u = v;
    if constexpr (SHUFFLE) u = __shfl_sync(0xffffffffu, v, up);
    v = min(max(base + ((e + c * u) >> shift), -512), 511);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) { out[0] = t1 - t0; out[1] = v; }
}
extern "C" int chain_cycles(void* out, int iters, int shuffle, void* stream) {
  if (shuffle) chain<true><<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, iters, 7, 300, 7, 5);
  else chain<false><<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, iters, 7, 300, 7, 5);
  return (int)cudaGetLastError();
}
"""
# The float64 tensor-core MMA shapes (``dmma_rates``): name, M, K (N = 8).
# In every shape lane l = 4 * gid + tig holds A's elements of rows gid (and
# gid + 8) and B's of column gid, at k index tig + 4 j in its j-th register
# pair, so that one register x_g = D[pixel tig + 4 j][8 g + gid] is both
# A^T's and B's element: the self-statistics kernel's Gram.
DMMA_SHAPES = (("m8n8k4", 8, 4), ("m16n8k4", 16, 4), ("m16n8k8", 16, 8), ("m16n8k16", 16, 16))
# the shape K9's Gram uses (csrc/estimate_kernels.cu)
DMMA_LANDED = "m16n8k4"
DMMA_SRC = r"""
#include <cuda_runtime.h>
template <int S> struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, K = 4, A = 1, B = 1, C = 2; };
template <> struct Shape<1> { static constexpr int M = 16, K = 4, A = 2, B = 1, C = 4; };
template <> struct Shape<2> { static constexpr int M = 16, K = 8, A = 4, B = 2, C = 4; };
template <> struct Shape<3> { static constexpr int M = 16, K = 16, A = 8, B = 4, C = 4; };
template <int S> __device__ __forceinline__ void mma(double* d, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<0>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
               "{%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<2>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
               "{%8,%9}, {%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<3>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                 "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int S, int CHAINS>
__global__ void rate(double* sink, long long* cycles, int iters) {
  using F = Shape<S>;
  double a[F::A], b[F::B], acc[CHAINS][F::C];
  for (int i = 0; i < F::A; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < F::B; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int c = 0; c < CHAINS; ++c)
    for (int i = 0; i < F::C; ++i) acc[c][i] = 0.0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma<S>(acc[c], a, b);
  }
  const long long t1 = clock64();
  double s = 0.0;
  for (int c = 0; c < CHAINS; ++c)
    for (int i = 0; i < F::C; ++i) s += acc[c][i];
  sink[threadIdx.x] = s;
  if ((threadIdx.x & 31) == 0) cycles[threadIdx.x / 32] = t1 - t0;
}
// The 32 x 32 Gram of D (P x 32, row-major, P a multiple of 16) on one warp.
template <int S>
__global__ void gram(const double* D, int P, double* G) {
  using F = Shape<S>;
  constexpr int NA = F::M / 8;  // 8-groups in A
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  double acc[4 / NA][4][F::C] = {};
  for (int p0 = 0; p0 < P; p0 += F::K) {
#pragma unroll
    for (int ga = 0; ga < 4 / NA; ++ga) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        double a[F::A], b[F::B];
#pragma unroll
        for (int j = 0; j < F::K / 4; ++j) {
          const double* row = D + (p0 + tig + 4 * j) * 32;
          for (int u = 0; u < NA; ++u) a[NA * j + u] = row[8 * (NA * ga + u) + gid];
          b[j] = row[8 * h + gid];
        }
        mma<S>(acc[ga][h], a, b);
      }
    }
  }
  for (int ga = 0; ga < 4 / NA; ++ga)
    for (int h = 0; h < 4; ++h)
      for (int i = 0; i < F::C; ++i)
        G[(8 * (NA * ga + i / 2) + gid) * 32 + 8 * h + 2 * tig + (i & 1)] = acc[ga][h][i];
}
#define RATE(S) \
  if (chains == 1) rate<S, 1><<<1, 32 * warps, 0, st>>>(sink, cycles, iters); \
  else rate<S, 4><<<1, 32 * warps, 0, st>>>(sink, cycles, iters);
extern "C" int dmma_rate(void* s, void* c, int shape, int warps, int chains, int iters,
                         void* stream) {
  double* sink = (double*)s;
  long long* cycles = (long long*)c;
  cudaStream_t st = (cudaStream_t)stream;
  switch (shape) {
    case 0: RATE(0); break;
    case 1: RATE(1); break;
    case 2: RATE(2); break;
    default: RATE(3); break;
  }
  return (int)cudaGetLastError();
}
extern "C" int dmma_gram(const void* d, int p, void* g, int shape, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const double* D = (const double*)d;
  double* G = (double*)g;
  switch (shape) {
    case 0: gram<0><<<1, 32, 0, st>>>(D, p, G); break;
    case 1: gram<1><<<1, 32, 0, st>>>(D, p, G); break;
    case 2: gram<2><<<1, 32, 0, st>>>(D, p, G); break;
    default: gram<3><<<1, 32, 0, st>>>(D, p, G); break;
  }
  return (int)cudaGetLastError();
}
"""
# No PyTorch call computes the function of any kernel but the blur's, whose
# box sum one convolution computes (timed in phase 8 as its library_ms).
LIBRARY_NOTE = {
    "grain_luma": "none: per-block pattern gather, LUT scaling and overlap blend",
    "grain_chroma_pair": "none: the chroma grain of grain_luma with the luma pair average",
    "grain_fused": "none: grain_luma's and grain_chroma_pair's functions in one pass",
    "grain_chroma": "none: one plane of grain_chroma_pair's function",
    "grain_pattern": "none: an AR recurrence over LFSR Gaussian noise",
    "grain_tables": "none: scaling LUTs, parameter rows and LFSR block offsets",
    "flat_block_activity": "none: per-block sum of absolute gradients",
    "plane_stats": "none: a masked lag-window Gram and binned moments",
    "self_blur": "torch.nn.functional.conv2d of the box sum (float32; den and q not formed)",
    "self_stats": "none: the Gram needs the shifted, masked design built first",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counts(*kernels) -> dict:
    """Launches of each kernel counted since the last ``spans.reset()``."""
    return {k: spans.counter("launch." + k) for k in kernels}


def program_counts() -> dict:
    """Parameter-program captures and replays since the last
    ``spans.reset()``."""
    return {k: spans.counter("program." + k) for k in ("captures", "replays")}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def timing(ms: float, plain_ms: float, moved: float, ops: float, fp64_ops: float = 0.0) -> dict:
    """A kernel's time beside its plain version's and its bound: the
    larger of the bytes it must move over the HBM rate and its operations
    over the card's peak for their type (integer over the int32 rate,
    float64 over the tensor cores' float64 rate). With float64 operations
    the record adds ``fp64_core_bound_ms``, the bound with them outside the
    tensor cores."""
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = (ops / INT32_OPS_PER_S + fp64_ops / FP64_OPS_PER_S) * 1e3
    bound_ms, by = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "bytes": moved, "ops": ops, "fp64_ops": fp64_ops}
    if fp64_ops:
        rec["fp64_core_bound_ms"] = max(
            b_ms, (ops / INT32_OPS_PER_S + fp64_ops / FP64_CORE_OPS_PER_S) * 1e3)
    return rec


def time_line(name: str, label: str, t: dict, card: str) -> str:
    plain = "not timed" if t["plain_ms"] is None else f"{t['plain_ms']:.3f} ms"
    ops = f"{t['ops'] / 1e9:.3f} G int ops"
    core = ""
    if t["fp64_ops"]:
        ops += f" + {t['fp64_ops'] / 1e9:.3f} G float64 ops"
        core = (f"; outside the tensor cores {t['fp64_core_bound_ms']:.4f} ms, share "
                f"{t['fp64_core_bound_ms'] / t['ms']:.3f}")
    if "padded_floor_ms" in t:
        core += (f"; padded tensor-core floor {t['padded_floor_ms']:.4f} ms (the MMAs' "
                 f"8 x 8 blocks, padding included)")
    wrapper = f", through its wrapper {t['wrapper_ms']:.4f} ms" if "wrapper_ms" in t else ""
    return (f"[time] {name} {label}: kernel {t['ms']:.4f} ms{wrapper}, plain PyTorch {plain}"
            f"; bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes'] / 1e6:.1f} MB, "
            f"{ops}), share {t['bound_ms'] / t['ms']:.3f}{core}; library "
            f"call {LIBRARY_NOTE[name]} on {card}")


def luma_work(luma_args):
    """(bytes, operations) of the luma kernel on its arguments: each frame
    read and written, its pattern, randoms and parameter row read once."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    y, pat, offs, prm, _ = luma_args
    active = int((prm[:, gk.P_ACTIVE] > 0).sum())
    return 2 * nbytes(y) + nbytes(pat, offs, prm), GRAIN_OPS * active * y.shape[1] * y.shape[2]


def chroma_ops(prm, samples: int) -> float:
    """Grain operations of one chroma plane's rows over ``samples`` per
    frame: active frames only, the combination where it is used."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    active = prm[:, gk.P_ACTIVE] > 0
    per = GRAIN_OPS + COMBINE_OPS * (prm[:, gk.P_USE_MULT] > 0).to(torch.int64)
    return float((per * active).sum()) * samples


def pair_work(pair_args):
    """(bytes, operations) of the chroma-pair kernel: Cb and Cr read and
    written, the luma rows the average reads (even rows when vertically
    subsampled), patterns, randoms and parameter rows."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    y, cb, cr, cbp, crp, offs, p2, _, _, _ = pair_args
    b, hc, wc = cb.shape
    luma = b * hc * y.shape[2] * y.element_size()
    samples = hc * wc
    on = (p2[:b, gk.P_ACTIVE] > 0) | (p2[b:, gk.P_ACTIVE] > 0)
    ops = AVG_OPS * float(on.sum()) * samples + chroma_ops(p2[:b], samples) + chroma_ops(p2[b:], samples)
    return luma + 2 * nbytes(cb, cr) + nbytes(cbp, crp, offs, p2), ops


def fused_args(luma_args, pair_args):
    """The fused kernel's arguments from the luma and chroma-pair
    kernels'."""
    y, lp, offs, py, bd = luma_args
    _, cb, cr, cbp, crp, _, p2, _, sx, sy = pair_args
    return (y, cb, cr, lp, cbp, crp, offs, py, p2, bd, sx, sy)


def fused_work(luma_args, pair_args):
    """(bytes, operations) of the fused kernel: every plane read and
    written once, its luma too; patterns, randoms and parameter rows read
    once; the luma and chroma-pair kernels' operations."""
    y, lp, offs, py, _ = luma_args
    _, cb, cr, cbp, crp, _, p2, _, _, _ = pair_args
    ops = luma_work(luma_args)[1] + pair_work(pair_args)[1]
    return 2 * nbytes(y, cb, cr) + nbytes(lp, cbp, crp, offs, py, p2), ops


def time_fused(what: str, luma_args, pair_args, card: str, plain: bool = False) -> dict:
    """The fused kernel's ``[time]`` line on the luma and chroma-pair
    kernels' inputs (its plain version's time where ``plain``), then the
    two kernels on the same inputs: their time, their own bound (the luma
    read twice) and the share of the fused kernel's bound their time
    reaches. Returns the fused kernel's record."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    fa = fused_args(luma_args, pair_args)
    k3 = timing(cuda_ms(lambda: gk.apply_planes_fused(*fa), 10),
                cuda_ms(lambda: gk.apply_planes_fused_reference(*fa), 3, 1) if plain else None,
                *fused_work(luma_args, pair_args))
    log(time_line("grain_fused", what, k3, card))
    two_ms = cuda_ms(lambda: (gk.apply_plane_luma(*luma_args), gk.apply_planes_pair(*pair_args)), 10)
    (lb, lo), (pb, po) = luma_work(luma_args), pair_work(pair_args)
    two = timing(two_ms, None, lb + pb, lo + po)
    log(f"[time] grain_luma + grain_chroma_pair {what}: kernels {two_ms:.4f} ms; their bound "
        f"{two['bound_ms']:.4f} ms by {two['bound_by']} ({two['bytes'] / 1e6:.1f} MB, the luma "
        f"read twice), share {two['bound_ms'] / two_ms:.3f}; the fused kernel's bound over their "
        f"time {k3['bound_ms'] / two_ms:.3f}; the fused kernel {two_ms / k3['ms']:.3f}x their "
        f"speed, on {card}")
    return k3


def pattern_work(params, packed, rows, sub_x: int, sub_y: int):
    """(bytes, operations) of the pattern kernel on one batch: rows and the
    Gaussian table read, the packed patterns written; the Gaussian samples
    and AR taps of each active plane at each frame's own lag."""
    from grav1synth_tpu_torch.ops import grain as tg

    ch, cw = tg.chroma_pattern_shape(sub_x, sub_y)
    ops = 0
    for p in params:
        has_y = bool(p.scaling_points_y)
        taps = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
        if has_y:
            ops += GAUSS_OPS * tg.GRAIN_H * tg.GRAIN_W + (tg.GRAIN_H - 3) * (tg.GRAIN_W - 6) * (
                2 * taps + AR_POS_OPS)
        for pts in (p.scaling_points_cb, p.scaling_points_cr):
            if pts or p.chroma_scaling_from_luma:
                ops += GAUSS_OPS * ch * cw + (ch - 3) * (cw - 6) * (
                    2 * (taps + has_y) + AR_POS_OPS)
    return nbytes(rows, packed) + 2048 * 2, ops


def device_busy(prof) -> float:
    """ms of the union of the device intervals (kernels and copies) that
    ``prof`` recorded."""
    intervals = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_batches(fn, reps: int) -> dict:
    """Per call of ``fn`` (one batch), after one warm-up call: the host
    issue ms (host clock around each call, no synchronise between calls),
    then under torch.profiler the wall ms of ``reps`` calls that end in a
    synchronise, the device busy ms (``device_busy``) and the idle share."""
    fn()
    torch.cuda.synchronize()
    issue = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        issue += time.perf_counter() - t0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy = device_busy(prof) / reps
    return {"issue_ms": issue * 1e3 / reps, "wall_ms": wall, "busy_ms": busy,
            "idle": 1 - busy / wall}


# CUgraphNodeType values the parameter program's graph holds
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), by type, read through libcuda
    (cuGraphGetNodes, cuGraphNodeGetType)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUresult {err}")

    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {"nodes": n.value}
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)), "cuGraphNodeGetType")
        kind = GRAPH_NODE_TYPES.get(t.value, f"type {t.value}")
        out[kind] = out.get(kind, 0) + 1
    return out


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def small_params(base):
    """Variants of one parameter set: overlap off, chroma scaling from
    luma, restricted clip with an extreme curve, a dense 14-point curve."""
    p1 = dataclasses.replace(base, grain_seed=4242, overlap_flag=False)
    p2 = dataclasses.replace(
        base, grain_seed=31337, chroma_scaling_from_luma=True,
        scaling_points_cb=[], scaling_points_cr=[],
    )
    p3 = dataclasses.replace(
        base, grain_seed=9001, clip_to_restricted_range=True,
        scaling_points_y=[(0, 0), (1, 255), (2, 0), (128, 200), (255, 10)],
    )
    dense = [(x, (x * 7 + 13 * (i % 5)) % 256) for i, x in enumerate(range(0, 256, 19))]
    p4 = dataclasses.replace(base, grain_seed=77, scaling_points_y=dense[:14])
    return [base, p1, p2, p3, p4]


def mixed_params(base):
    """small_params and frames whose planes are off: no luma points; no
    chroma points (the chroma-pair kernel copies both planes); no Cr
    points."""
    return small_params(base) + [
        dataclasses.replace(base, grain_seed=11, scaling_points_y=[]),
        dataclasses.replace(base, grain_seed=12, scaling_points_cb=[], scaling_points_cr=[],
                            chroma_scaling_from_luma=False),
        dataclasses.replace(base, grain_seed=13, scaling_points_cr=[]),
    ]


def luma_only(params):
    return [
        dataclasses.replace(
            p, scaling_points_cb=[], scaling_points_cr=[],
            chroma_scaling_from_luma=False, ar_coeffs_cb=[], ar_coeffs_cr=[],
        )
        for p in params
    ]


def reseeded(params, n):
    return [
        dataclasses.replace(p, grain_seed=(p.grain_seed + 7919 * i) & 0xFFFF)
        for i, p in ((i, params[i % len(params)]) for i in range(n))
    ]


def random_planes(rng, b, h, w, bd, sub_x, sub_y):
    maxv = (1 << bd) - 1
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    return [
        rng.integers(0, maxv + 1, shape, dtype=np.int16)
        for shape in ((b, h, w), (b, hc, wc), (b, hc, wc))
    ]


def kernel_inputs(params, planes, bd, sub_x, sub_y, device, generate=None):
    """Everything the two kernels take, on ``device``."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    y, cb, cr = (t if torch.is_tensor(t) else torch.from_numpy(t).to(device) for t in planes)
    pats = (generate or tg.generate_patterns_ref)(params, bd, sub_x, sub_y, False)
    lp, cbp, crp = given_patterns(pats, sub_x, sub_y, device)
    pb = tg.pack_params(params, device)
    _, h, w = y.shape
    offs = tg.block_offsets(pb.seed, (h + 31) // 32, (w + 31) // 32)
    py = gk.pack_plane_params(pb, "y", bd)
    p2 = torch.cat([gk.pack_plane_params(pb, pl, bd) for pl in ("cb", "cr")])
    luma_args = (y, lp, offs, py, bd)
    pair_args = (y, cb, cr, cbp, crp, offs, p2, bd, sub_x, sub_y)
    return luma_args, pair_args


def given_patterns(pats, sub_x, sub_y, device):
    """Host (luma, cb, cr) patterns (cb/cr None when monochrome) on
    ``device`` as the grain kernels read them: packed as the pattern
    kernel writes them, uploaded in one copy."""
    from grav1synth_tpu_torch.ops import grain as tg

    packed = tg.pack_patterns(*(None if a is None else torch.from_numpy(a) for a in pats))
    chroma_shape = None if pats[1] is None else tg.chroma_pattern_shape(sub_x, sub_y)
    return tg._unpack_patterns(packed.to(device), chroma_shape)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def compare_kernels(params, planes, bd, sub_x, sub_y, device, errs, what, generate=None):
    """Each kernel (luma, chroma-pair, fused) against its plain version on
    the same device inputs."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    luma_args, pair_args = kernel_inputs(params, planes, bd, sub_x, sub_y, device, generate)
    got = gk.apply_plane_luma(*luma_args)
    want = gk.apply_plane_luma_reference(*luma_args)
    e_l = max_abs_err(got, want)
    got2 = gk.apply_planes_pair(*pair_args)
    want2 = gk.apply_planes_pair_reference(*pair_args)
    e_c = max(max_abs_err(g, w) for g, w in zip(got2, want2))
    got3 = gk.apply_planes_fused(*fused_args(luma_args, pair_args))
    e_f = max(max_abs_err(g, w) for g, w in zip(got3, (want, *want2)))
    errs["grain_luma"] = max(errs["grain_luma"], e_l)
    errs["grain_chroma_pair"] = max(errs["grain_chroma_pair"], e_c)
    errs["grain_fused"] = max(errs["grain_fused"], e_f)
    if e_l > TOLERANCE or e_c > TOLERANCE or e_f > TOLERANCE:
        raise AssertionError(f"{what}: kernel vs plain max |err| luma {e_l}, chroma {e_c}, "
                             f"fused {e_f}")


def check_against_grain_ref(out, planes, params, bd, sub_x, sub_y, frames, what):
    from grav1synth_tpu_torch.ops import grain_ref

    nplanes = len([o for o in out if o is not None])
    for i in frames:
        ref = grain_ref.apply_grain_frame(
            [planes[k][i].astype(np.int32) for k in range(nplanes)], params[i], bd,
            sub_x, sub_y,
        )
        for k in range(nplanes):
            got = out[k][i].cpu().numpy().astype(np.int64)
            if not np.array_equal(got, ref[k].astype(np.int64)):
                bad = int((got != ref[k]).sum())
                raise AssertionError(f"{what}: frame {i} plane {k}: {bad} samples differ from grain_ref")


def stream_params(path):
    """Effective FilmGrainParams of each displayed frame, and the
    stream's geometry, by the pure-Python parse path."""
    from grav1synth_tpu_torch.obu import Av1Parser
    from grav1synth_tpu_torch.pipelines import GrainFrameState, VideoFile

    eff = []
    with VideoFile(path) as vf:
        parser = Av1Parser()
        state = GrainFrameState()
        for pkt in vf.packets():
            for obu in parser.parse_packet(pkt.data, pkt.av1_ts, pkt.obu_extents):
                if obu.frame is not None and not obu.is_redundant_frame_header:
                    shown, p = state.frame_params(obu.frame)
                    if shown and p is not None:
                        eff.append(p)
        seq = parser.sequence_header
        cc = seq.color_config
        geom = (seq.max_frame_width, seq.max_frame_height, cc.bit_depth, cc.subsampling)
    return eff, geom


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def film_frames(rng, n, h, w, bd):
    """Structured, moving clean 4:2:0 frames (the shape of
    tests/test_diff_quality.film_like_clip, at any size and bit depth):
    gradients, texture, a panning bright disc, per-frame exposure wobble.
    Returns int16 (n, h, w) luma and two (n, hc, wc) chroma planes."""
    hc, wc = (h + 1) >> 1, (w + 1) >> 1
    scale = 1 << (bd - 8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 50 + 120 * (xx / w) + 30 * (yy / h) + 8 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    ys = np.empty((n, h, w), np.int16)
    for i in range(n):
        cx, cy, rad = w * (0.2 + 0.02 * i), h * 0.5, 28.0 * w / 256
        disc = 70 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * rad**2)))
        ys[i] = np.clip((base + disc + rng.normal(0, 0.3)) * scale, 16 * scale, 235 * scale)
    cyy, cxx = np.mgrid[0:hc, 0:wc].astype(np.float32)
    u = np.clip((110 + 30 * (cxx / wc)) * scale, 16 * scale, 240 * scale).astype(np.int16)
    v = np.clip((130 - 20 * (cyy / hc)) * scale, 16 * scale, 240 * scale).astype(np.int16)
    return ys, np.repeat(u[None], n, 0), np.repeat(v[None], n, 0)


def stats_err(got: dict, want: dict) -> float:
    """Largest |difference| over the statistics (the Gram of a lag-0 luma
    plane is empty); differing keys or shapes raise."""
    if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
        raise AssertionError(f"statistics differ in keys or shapes: {sorted(got)}, {sorted(want)}")
    return max((float((got[k] - want[k]).abs().max().item()) for k in want if want[k].numel()),
               default=0.0)


def diff_planes(rng, b, h, w, bd, sub_x, sub_y):
    """(sy, dy, sc, dc, sr, dr) int16 numpy planes: each source is its
    denoised plane plus noise; each denoised plane is flat on its upper
    half and random below."""
    maxv = (1 << bd) - 1
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    out = []
    for ph, pw in ((h, w), (hc, wc), (hc, wc)):
        d = rng.integers(0, maxv + 1, (b, ph, pw))
        d[:, : ph // 2] = maxv // 3 + rng.integers(0, 3, (b, ph // 2, pw))
        s = np.clip(d + rng.integers(-40, 41, d.shape), 0, maxv)
        out += [s.astype(np.int16), d.astype(np.int16)]
    return out


def compare_diff_kernels(planes, bd, sub_x, sub_y, lags, device, errs, what):
    """Both diff kernels against their plain versions on the same device
    inputs, luma and (with the x4 luma-residual column) both chroma."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    sy, dy, sc, dc, sr, dr = (torch.from_numpy(a).to(device) for a in planes)
    lavg4 = de.chroma_lavg4(sy, dy, sc.shape[1], sc.shape[2], sub_x, sub_y)
    for s, d, aux in ((sy, dy, None), (sc, dc, lavg4), (sr, dr, lavg4)):
        act = dk.flat_block_activity(d)
        e_a = max_abs_err(act, dk.flat_block_activity_reference(d)) if act.numel() else 0
        errs["flat_block_activity"] = max(errs["flat_block_activity"], e_a)
        blocks = de.flat_blocks(d)
        for lag in lags:
            e_s = stats_err(
                dk.plane_stats(s, d, blocks, aux, lag, bd),
                dk.plane_stats_reference(s, d, blocks, aux, lag, bd),
            )
            errs["plane_stats"] = max(errs["plane_stats"], e_s)
            if e_a > TOLERANCE or e_s > TOLERANCE:
                raise AssertionError(
                    f"{what} lag {lag}: diff kernel vs plain max |err| activity {e_a}, stats {e_s}"
                )


def hold_stats(s, d, blocks, aux, lags, bd, errs, what):
    """``plane_stats`` against its plain version, with and without aux."""
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    for lag in lags:
        for a in (None, aux):
            e = stats_err(dk.plane_stats(s, d, blocks, a, lag, bd),
                          dk.plane_stats_reference(s, d, blocks, a, lag, bd))
            errs["plane_stats"] = max(errs["plane_stats"], e)
            if e > TOLERANCE:
                raise AssertionError(
                    f"{what} lag {lag} aux {a is not None}: plane_stats vs plain max |err| {e}")


def shifted(t, by: int = 3):
    """``t`` copied into a view ``by`` samples into a larger storage: every
    row off the 16-byte boundary by 2 * by bytes."""
    store = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = store[by:].view(t.shape)
    view.copy_(t)
    return view


def extreme_stats_cases(rng, dev, errs) -> int:
    """``plane_stats`` where its 32-bit sums are largest and where its
    staging changes path (as tests/test_torch_cuda.py): constant 12-bit
    planes with r = +-4095 and aux = +-16380 and every block flat, 200 x 160
    (three tiles and twelve 16-row segments tall) and 10000 x 32 (a column's
    int64 sum passes 2^32); a random plane 3 samples into its storage and
    one whose width is no multiple of 8. Returns the number of cases."""
    from grav1synth_tpu_torch.ops import diff_estimate as de

    def constant(s_val, d_val, aux_val, b, h, w):
        planes = [torch.full((b, h, w), v, dtype=torch.int16, device=dev)
                  for v in (s_val, d_val, aux_val)]
        blocks = torch.ones((b, h // 16, w // 16), dtype=torch.uint8, device=dev)
        return planes[0], planes[1], blocks, planes[2]

    n = 0
    for s_val, d_val, aux_val in ((4095, 0, 16380), (0, 4095, 16380), (4095, 0, -16380),
                                  (0, 4095, -16380)):
        hold_stats(*constant(s_val, d_val, aux_val, 2, 200, 160), (1, 2, 3), 12, errs,
                   f"12-bit constant s {s_val} d {d_val} aux {aux_val} 160x200")
        n += 1
    hold_stats(*constant(4095, 0, 16380, 1, 10000, 32), (1, 2, 3), 12, errs, "12-bit 32x10000")
    n += 1
    for h, w in ((150, 264), (150, 260)):
        sy, dy = (torch.from_numpy(a).to(dev) for a in diff_planes(rng, 2, h, w, 10, 0, 0)[:2])
        aux = torch.from_numpy(rng.integers(-400, 401, (2, h, w)).astype(np.int16)).to(dev)
        views = [shifted(t) for t in (sy, dy, aux)]  # every row off by 6 bytes
        hold_stats(views[0], views[1], de.flat_blocks(dy), views[2], (1, 2, 3), 10, errs,
                   f"10-bit {w}x{h} off the 16-byte boundary")
        n += 1
    return n


def hold_activity(d, errs, what):
    """``flat_block_activity`` against its plain version."""
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    e = max_abs_err(dk.flat_block_activity(d), dk.flat_block_activity_reference(d))
    errs["flat_block_activity"] = max(errs["flat_block_activity"], e)
    if e > TOLERANCE:
        raise AssertionError(f"{what}: flat_block_activity vs plain max |err| {e}")


def activity_edge_cases(rng, dev, errs) -> int:
    """The flat-block activity kernel at its edges (as
    tests/test_torch_cuda.py): widths 512-543 (every residue mod 16) at
    heights 64, 65, 79 and 129 over the whole int16 range; a batch slice
    ``[1:]`` and a plane 3 samples into its storage (bases off the 16-byte
    boundary); samples alternating -32768 and 32767 (every block sum 512 x
    65535); 4 frames of 2600x16000 (1375 CTAs of 64-row strips, more than
    the card holds at once) and 32 of 960x540 (a 1080p chroma batch: strips
    of 32 rows; the small planes take 16). Returns the number of cases."""
    n = 0
    for h in (64, 65, 79, 129):
        for w in range(512, 544):
            d = rng.integers(-32768, 32768, (2, h, w), dtype=np.int16)
            hold_activity(torch.from_numpy(d).to(dev), errs, f"{w}x{h}")
            n += 1
    big = torch.from_numpy(rng.integers(0, 1024, (4, 67, 301), dtype=np.int16)).to(dev)
    hold_activity(big[1:], errs, "batch slice [1:] of 301x67")
    d = torch.from_numpy(rng.integers(-32768, 32768, (2, 80, 512), dtype=np.int16)).to(dev)
    hold_activity(shifted(d), errs, "512x80 3 samples into its storage")
    i, j = np.mgrid[0:81, 0:520]
    alt = np.where((i + j) % 2, -32768, 32767).astype(np.int16)
    hold_activity(torch.from_numpy(np.stack([alt, -1 - alt])).to(dev), errs,
                  "alternating -32768 / 32767")
    tall = rng.integers(0, 1024, (4, 16000, 2600), dtype=np.int16)
    hold_activity(torch.from_numpy(tall).to(dev), errs, "4 x 2600x16000")
    mid = rng.integers(0, 256, (32, 540, 960), dtype=np.int16)
    hold_activity(torch.from_numpy(mid).to(dev), errs, "32 x 960x540")
    return n + 5


class plain_diff_path:
    """Within the block, ops.diff_estimate runs the diff kernels' plain
    PyTorch versions instead of the kernels (the reference the fitted
    table is held against)."""

    def __enter__(self):
        from grav1synth_tpu_torch.ops import diff_estimate as de
        from grav1synth_tpu_torch.ops import diff_kernels as dk

        self.saved = de.flat_block_activity, de.plane_stats
        de.flat_block_activity = dk.flat_block_activity_reference
        de.plane_stats = dk.plane_stats_reference

    def __exit__(self, *exc):
        from grav1synth_tpu_torch.ops import diff_estimate as de

        de.flat_block_activity, de.plane_stats = self.saved


def sigma_curve(params, xs):
    """sigma(intensity) in 8-bit units that a table synthesizes (as
    tests/test_diff_quality.sigma_curve)."""
    from grav1synth_tpu_torch.ops import grain_ref

    pat = grain_ref.generate_grain(params, 8, False, 1, 1)
    sg = float(pat.luma[3:, 3:-3].astype(np.float64).std())
    lut = grain_ref.build_scaling_lut(params.scaling_points_y, 8)
    return np.array([lut[x] * sg / (1 << params.scaling_shift) for x in xs])


def grained_film(eff, dev, n=32, h=2160, w=3840, bd=10):
    """Film-like clean 4:2:0 frames and the same frames grained on the
    card by ``apply_grain`` with the stream's tables reseeded per frame,
    16 at a time: (clean, grainy), each three int16 (n, ., .) arrays."""
    from grav1synth_tpu_torch.ops import grain as tg

    clean = film_frames(np.random.default_rng(11), n, h, w, bd)
    params = reseeded(eff, n)
    grainy = []
    for i0 in range(0, n, 16):
        out = tg.apply_grain(*(torch.from_numpy(p[i0 : i0 + 16]).to(dev) for p in clean),
                             tg.pack_params(params[i0 : i0 + 16], dev), bd, 1, 1)
        grainy.append([t.cpu().numpy() for t in out])
    grainy = [np.concatenate([g[k] for g in grainy]) for k in range(3)]
    if np.array_equal(grainy[0], clean[0]):
        raise AssertionError("no grain was injected")
    return clean, grainy


def frames_of(planes, i0, n):
    """Per-frame [y, cb, cr] plane lists of frames i0 .. i0 + n - 1."""
    return [[p[i] for p in planes] for i in range(i0, i0 + n)]


def sigma_curve_error(injected, got) -> str:
    """The recovered luma sigma curve against the injected one over
    intensities 40-235: median and mean relative error."""
    xs = np.arange(40, 236)
    want = sigma_curve(injected, xs)
    rel = np.abs(sigma_curve(got, xs) - want) / np.maximum(want, 1e-6)
    if not np.isfinite(rel).all():
        raise AssertionError("sigma curve error is not finite")
    return (f"median {float(np.median(rel)):.4f}, mean {float(rel.mean()):.4f} "
            f"(points {got.scaling_points_y}, shift {got.scaling_shift})")


def stats_trip(h, w, bd, b, dev):
    """The diff kernels' timing inputs: ``b`` film-like clean 4:2:0 frames
    as the denoised planes, the same plus uniform noise in [-8, 8] as the
    source. Returns the source and clean numpy planes and, on ``dev``, one
    (s, d, flat blocks, aux) per plane as ``plane_stats`` takes them."""
    from grav1synth_tpu_torch.ops import diff_estimate as de

    clean = film_frames(np.random.default_rng(3), b, h, w, bd)
    noise = np.random.default_rng(4)
    src = [np.clip(p + noise.integers(-8, 9, p.shape, dtype=np.int16), 0, (1 << bd) - 1)
           for p in clean]
    sy, sc, sr = (torch.from_numpy(a).to(dev) for a in src)
    dy, dc, dr = (torch.from_numpy(a).to(dev) for a in clean)
    lavg4 = de.chroma_lavg4(sy, dy, sc.shape[1], sc.shape[2], 1, 1)
    blk = [de.flat_blocks(d) for d in (dy, dc, dr)]
    return src, clean, ((sy, dy, blk[0], None), (sc, dc, blk[1], lavg4), (sr, dr, blk[2], lavg4))


def stats_work(trip, lag: int, outs):
    """(bytes, operations) of ``plane_stats`` on the planes of ``trip``:
    the bytes it must move (inputs once, ``outs`` once) and the operations
    this run's flat blocks need: per sample the residual and the flat
    test, per flat sample the n(n+1)/2 multiply-adds of the Gram over its
    n design columns and 4 for the binned moments."""
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    moved = sum(nbytes(s, d, bl, a) for s, d, bl, a in trip) + sum(
        nbytes(*out.values()) for out in outs)
    ops = 0.0
    for s, _, bl, a in trip:
        n_cols = len(dk.offsets(lag)) + (a is not None)  # r at (0, 0), its lags, aux
        ops += 2 * s.numel() + float(bl.sum()) * 256 * (n_cols * (n_cols + 1) + 4)
    return moved, ops


def diff_phases(card, eff, dev, clean, grainy):
    """Phases 5 and 6; returns the diff kernels' launches, times and
    errors for the summary."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    # 5. kernels against their plain versions
    errs = {"flat_block_activity": 0, "plane_stats": 0.0}
    rng = np.random.default_rng(2025)
    n_cases = 0
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            for h, w in ((64, 64), (70, 100), (40, 301), (150, 260), (33, 17), (12, 40)):
                planes = diff_planes(rng, 3, h, w, bd, sub_x, sub_y)
                compare_diff_kernels(
                    planes, bd, sub_x, sub_y, (1, 2, 3), dev, errs, f"{bd}-bit {sub_x}{sub_y} {w}x{h}"
                )
                n_cases += 1
    H, W, BD = 2160, 3840, 10
    big = diff_planes(rng, 16, H, W, BD, 1, 1)
    compare_diff_kernels(big, BD, 1, 1, (2,), dev, errs, f"{BD}-bit 4:2:0 {W}x{H} B=16")
    del big
    n_extreme = extreme_stats_cases(rng, dev, errs)
    n_act = activity_edge_cases(rng, dev, errs)
    torch.cuda.synchronize()
    log(f"[diff kernels] {n_cases + 1} cases (x lags, x 3 planes) equal to the plain "
        f"versions; plane_stats also on {n_extreme} cases (x lag 1-3, with and without aux) at "
        f"the ends of its ranges (12-bit r = +-4095, aux = +-16380, every block flat), on a "
        f"10000 x 32 plane and on rows off the 16-byte boundary; flat_block_activity also on "
        f"{n_act} edge cases (widths 512-543 x 4 heights, bases off the 16-byte boundary, "
        f"alternating -32768 / 32767, 1375 CTAs, strips of 16, 32 and 64 rows) (max |err| "
        f"{errs})")

    # 6. the diff main path at full size: inject known grain, estimate it back
    def estimate(device):
        est = de.DiffEstimator((30, 1), BD, BD, chunk_frames=1000, device=device)
        for i0 in (0, 16):
            est.diff_batch(frames_of(grainy, i0, 16), frames_of(clean, i0, 16))
        return est.finish()

    torch.cuda.synchronize()
    spans.reset()
    tables = estimate(dev)
    torch.cuda.synchronize()
    launches = launch_counts("flat_block_activity", "plane_stats")
    log(f"[diff main path] launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a diff kernel of the main path never launched: {launches}")
    with plain_diff_path():
        plain_tables = estimate(dev)
    if not tables or [(t.start_time, t.end_time, t.params) for t in tables] != [
        (t.start_time, t.end_time, t.params) for t in plain_tables
    ]:
        raise AssertionError(f"kernel tables {tables} != plain tables {plain_tables}")
    got = tables[0].params
    if not got.scaling_points_y or not got.ar_coeffs_y:
        raise AssertionError(f"no luma model recovered: {got}")
    log(f"[diff main path] 4K10 4:2:0, 2 batches of 16 through DiffEstimator.diff_batch: "
        f"{len(tables)} segment(s), table equal to the plain path's; luma sigma-curve error "
        f"vs injected: {sigma_curve_error(eff[0], got)}")

    # times
    times = {}
    for label, (h, w, bd, b) in (("4K10 B=16", (H, W, BD, 16)), ("1080p8 B=32", (1080, 1920, 8, 32))):
        src, (cy, cu, cv), trip = stats_trip(h, w, bd, b, dev)

        def act(fn):
            return lambda: [fn(d) for _, d, _, _ in trip]

        def st(fn, lag=2):
            return lambda: [fn(s, d, bl, a, lag, bd) for s, d, bl, a in trip]

        act_bytes = sum(nbytes(d) for _, d, _, _ in trip) + nbytes(*act(dk.flat_block_activity)())
        t = {
            "flat_block_activity": timing(
                cuda_ms(act(dk.flat_block_activity), 20),
                cuda_ms(act(dk.flat_block_activity_reference), 3, 1),
                act_bytes, ACTIVITY_OPS * sum(d.numel() for _, d, _, _ in trip),
            ),
            "plane_stats": timing(
                cuda_ms(st(dk.plane_stats), 10),
                cuda_ms(st(dk.plane_stats_reference), 2, 1),
                *stats_work(trip, 2, st(dk.plane_stats)()),
            ),
        }
        for k, tk in t.items():
            tk["label"] = f"{label} (3 planes, lag 2)"
            log(time_line(k, tk["label"], tk, card))
        if label.startswith("4K"):
            times = t
            lag3 = timing(cuda_ms(st(dk.plane_stats, 3), 5), None,
                          *stats_work(trip, 3, st(dk.plane_stats, 3)()))
            lag3["label"] = f"{label} (3 planes, lag 3)"
            log(time_line("plane_stats", lag3["label"], lag3, card))
            times["plane_stats"]["other_cases"] = [lag3]
        else:
            times["plane_stats"]["other_cases"].append(t["plane_stats"])
        sf, df = frames_of(src, 0, b), frames_of((cy, cu, cv), 0, b)
        est = de.DiffEstimator((30, 1), bd, bd, chunk_frames=10**6, device=dev)
        est.diff_batch(sf, df)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            est.diff_batch(sf, df)
        dt = time.perf_counter() - t0
        log(f"[diff] diff_batch {label} 4:2:0: {b * reps / dt:.1f} frames/s (stack, pinned "
            f"upload, kernels, one stats download, host chunking) on {card}")
        del trip
        torch.cuda.empty_cache()
    return launches, times, errs


def chroma_args(pair_args):
    """``apply_plane_chroma``'s arguments for Cb and for Cr, from the pair
    kernel's: the averaged luma from ``_avg_luma``, the plane's rows of
    the parameter table."""
    from grav1synth_tpu_torch.ops import grain as tg

    y, cb, cr, cbp, crp, offs, p2, bd, sub_x, sub_y = pair_args
    b = y.shape[0]
    avg = tg._avg_luma(y.to(torch.int32), cb.shape[1], cb.shape[2], sub_x, sub_y)
    avg = avg.to(torch.int16)
    return [
        (src, avg, pat, offs, prm, bd, sub_x, sub_y)
        for src, pat, prm in ((cb, cbp, p2[:b]), (cr, crp, p2[b:]))
    ]


def hold_chroma_to_plain(outs, cargs, errs, what):
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    for plane, got, args in zip(("cb", "cr"), outs, cargs):
        e = max_abs_err(got, gk.apply_plane_chroma_reference(*args))
        errs["grain_chroma"] = max(errs["grain_chroma"], e)
        if e > TOLERANCE:
            raise AssertionError(f"{what} {plane}: chroma kernel vs plain max |err| {e}")


def hold_chroma(cargs, errs, what):
    """``apply_plane_chroma`` on each of ``cargs`` against its plain version."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    hold_chroma_to_plain([gk.apply_plane_chroma(*a) for a in cargs], cargs, errs, what)


def chroma_edge_cases(base, rng, dev, errs) -> int:
    """The single-chroma-plane kernel at its edges (as
    tests/test_torch_cuda.py), on Cb and Cr of mixed batches (overlap on
    and off, planes switched off): luma widths 520-535 at odd and even
    heights, 8/10/12-bit x 4:2:0/4:2:2/4:4:4; at 10-bit a batch slice
    ``[1:]`` and src, avg or both 3 samples into their storage (bases off
    the 16-byte boundary), 9 frames of 1000x520 (more units than resident
    CTAs) and offsets that cover more stripes and blocks than the plane.
    Returns the number of cases."""
    from grav1synth_tpu_torch.ops import grain as tg

    mixed = mixed_params(base)
    n = 0
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            pats = tg.generate_patterns_ref(mixed, bd, sub_x, sub_y)

            def cargs_of(planes, params=mixed, gen=lambda *a: pats):
                return chroma_args(kernel_inputs(params, planes, bd, sub_x, sub_y, dev, gen)[1])

            what = f"{bd}-bit {sub_x}{sub_y}"
            for w in range(520, 536):
                h = (41, 33, 64, 71)[w % 4]
                planes = random_planes(rng, len(mixed), h, w, bd, sub_x, sub_y)
                hold_chroma(cargs_of(planes), errs, f"{what} {w}x{h}")
                n += 1
            if bd != 10:
                continue
            big = [torch.from_numpy(a).to(dev)
                   for a in random_planes(rng, len(mixed) + 1, 41, 301, bd, sub_x, sub_y)]
            hold_chroma(cargs_of([t[1:] for t in big]), errs, f"{what} batch slice [1:] of 301x41")
            cargs = cargs_of(random_planes(rng, len(mixed), 64, 256, bd, sub_x, sub_y))
            for src_off, avg_off in ((True, False), (False, True), (True, True)):
                moved = [(shifted(a[0]) if src_off else a[0], shifted(a[1]) if avg_off else a[1])
                         + a[2:] for a in cargs]
                hold_chroma(moved, errs, f"{what} 256x64 src/avg off the boundary "
                                         f"{src_off}/{avg_off}")
            wide = mixed + small_params(base)[:1]
            hold_chroma(cargs_of(random_planes(rng, len(wide), 520, 1000, bd, sub_x, sub_y), wide,
                                 None), errs, f"{what} 9 x 1000x520")
            for h, w, (ds, dn) in ((70, 301, (2, 3)), (64, 256, (1, 0)), (41, 527, (0, 5))):
                cargs = cargs_of(random_planes(rng, len(mixed), h, w, bd, sub_x, sub_y))
                seed = tg.pack_params(mixed, dev).seed
                offs = tg.block_offsets(seed, (h + 31) // 32 + ds, (w + 31) // 32 + dn)
                hold_chroma([a[:3] + (offs,) + a[4:] for a in cargs], errs,
                            f"{what} {w}x{h} offsets {ds} stripes, {dn} blocks larger")
            n += 8
    return n


def chroma_phase(card, eff, dev):
    """Phase 7; returns the single-chroma-plane kernel's launches, time
    and error for the summary."""
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    errs = {"grain_chroma": 0}
    rng = np.random.default_rng(2026)
    n_cases = 0
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            for h, w in ((64, 64), (70, 100), (128, 160), (40, 99), (40, 301)):
                params = small_params(eff[0])
                planes = random_planes(rng, len(params), h, w, bd, sub_x, sub_y)
                _, pair_args = kernel_inputs(params, planes, bd, sub_x, sub_y, dev)
                cargs = chroma_args(pair_args)
                outs = [gk.apply_plane_chroma(*a) for a in cargs]
                hold_chroma_to_plain(outs, cargs, errs, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
                n_cases += 1
    n_edge = chroma_edge_cases(eff[0], rng, dev, errs)
    small = small_params(eff[0])[:2]
    sp = random_planes(rng, 2, 70, 301, 10, 1, 1)
    luma_args, pair_args = kernel_inputs(small, sp, 10, 1, 1, dev)
    out = [gk.apply_plane_luma(*luma_args)] + [gk.apply_plane_chroma(*a) for a in chroma_args(pair_args)]
    check_against_grain_ref(out, sp, small, 10, 1, 1, range(2), "small frames, chroma kernel")

    # the main path: the entry point on both chroma planes of a 4K10 batch
    H, W, BD = 2160, 3840, 10
    params = reseeded(eff, 16)
    planes = random_planes(rng, 16, H, W, BD, 1, 1)
    luma_args, pair_args = kernel_inputs(params, planes, BD, 1, 1, dev)
    cargs = chroma_args(pair_args)
    torch.cuda.synchronize()
    spans.reset()
    outs = [gk.apply_plane_chroma(*a) for a in cargs]
    torch.cuda.synchronize()
    launches = launch_counts("grain_chroma")["grain_chroma"]
    log(f"[chroma main path] launches {{'grain_chroma': {launches}}}")
    if launches < 1:
        raise AssertionError("the chroma kernel never launched on its main path")
    for t, src in zip(outs, cargs):
        if tuple(t.shape) != tuple(src[0].shape) or t.dtype != torch.int16:
            raise AssertionError(f"chroma kernel output {tuple(t.shape)} {t.dtype}")
    hold_chroma_to_plain(outs, cargs, errs, f"{BD}-bit 4:2:0 {W}x{H} B=16")
    pair = gk.apply_planes_pair(*pair_args)
    if not all(torch.equal(o, p) for o, p in zip(outs, pair)):
        raise AssertionError("chroma kernel on Cb and Cr differs from the chroma-pair kernel")
    check_against_grain_ref(
        [gk.apply_plane_luma(*luma_args)] + outs, planes, params, BD, 1, 1, [0], "4K B=16 chroma kernel"
    )
    torch.cuda.synchronize()
    log(f"[chroma kernel] {n_cases + 1} cases and {n_edge} edge cases (widths 520-535 with "
        f"planes off, bases off the 16-byte boundary, more units than resident CTAs, offsets "
        f"larger than the plane) x 2 planes integer-equal to the plain version (max |err| "
        f"{errs}); 2 small frames and 4K frame 0 equal to grain_ref; 4K10 B=16 Cb and Cr "
        f"equal to the chroma-pair kernel's")
    src, avg, pat, offs, prm = cargs[0][:5]
    t = timing(
        cuda_ms(lambda: gk.apply_plane_chroma(*cargs[0]), 20),
        cuda_ms(lambda: gk.apply_plane_chroma_reference(*cargs[0]), 3, 1),
        2 * nbytes(src) + nbytes(avg, pat, offs, prm), chroma_ops(prm, src.shape[1] * src.shape[2]),
    )
    log(time_line("grain_chroma", "4K10 4:2:0 B=16, one plane (Cb)", t, card))
    return {"grain_chroma": launches}, {"grain_chroma": t}, errs


def stats_rel_err(got: dict, want: dict) -> float:
    """Largest difference of each statistic, over its largest magnitude."""
    return max(
        float((got[k].cpu() - want[k]).abs().max()) / max(float(want[k].abs().max()), 1.0)
        for k in want
    )


def blur_equal(f, bd, errs, what):
    """``self_blur`` against its plain version; returns (den, q)."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    den, q = ek.self_blur(f, bd)
    pden, pq = ek.self_blur_reference(f, bd)
    e = max(max_abs_err(den, pden), int((q.long() - pq.long()).abs().max().item()))
    errs["self_blur"] = max(errs["self_blur"], e)
    if e > TOLERANCE:
        raise AssertionError(f"{what}: self_blur vs plain max |err| {e}")
    return den, q


def self_stats_equal(q, den, lsum, n_pool, lags, bd, errs, what):
    """``self_stats`` against its plain version on the same card inputs,
    without and (where given) with the pooled luma column; returns the
    number of comparisons."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    blocks = de.flat_blocks(den)
    n = 0
    for lag in lags:
        for aux in (None,) if lsum is None else (None, lsum):
            e = stats_err(ek.self_stats(q, den, blocks, aux, n_pool, lag, bd),
                          ek.self_stats_reference(q, den, blocks, aux, n_pool, lag, bd))
            errs["self_stats"] = max(errs["self_stats"], e)
            if e > TOLERANCE:
                raise AssertionError(f"{what} lag {lag} lsum {aux is not None}: self_stats vs "
                                     f"plain max |err| {e}")
            n += 1
    return n


def estimate_planes_equal(planes, bd, sub_x, sub_y, lags, dev, errs, what):
    """Both estimate kernels on a luma and a chroma plane batch (numpy or
    card tensors): the blur of each, then the statistics of luma and of
    chroma with the luma pooled as the estimate path pools it."""
    from grav1synth_tpu_torch.ops import diff_estimate as de

    y, c = (t if torch.is_tensor(t) else torch.from_numpy(t).to(dev) for t in planes)
    den_y, q_y = blur_equal(y, bd, errs, f"{what} luma")
    den_c, q_c = blur_equal(c, bd, errs, f"{what} chroma")
    lsum = de.pool_sum(q_y, c.shape[1], c.shape[2], sub_x, sub_y)
    return (self_stats_equal(q_y, den_y, None, 1, lags, bd, errs, f"{what} luma")
            + self_stats_equal(q_c, den_c, lsum, (1 + sub_x) * (1 + sub_y), lags, bd, errs,
                               f"{what} chroma"))


def textured_plate(rng, b, h, w, bd):
    """(b, h, w) int16 planes where only some blocks are flat (as
    tests/test_torch_cuda.py): a smooth gradient with grain, textured
    (random levels on 8 x 8 cells) on every 2 x 8-block tile of every
    fourth tile diagonal, so that whole statistics tiles hold no flat
    block, and on about one block in seven elsewhere; smooth blocks along
    the sides are flat and touch the 4-sample band."""
    maxv = (1 << bd) - 1
    hb, wb = h // 16, w // 16
    by, bx = np.mgrid[0:hb, 0:wb]
    tex = ((by // 2 + bx // 8) % 4 == 1)[None] | (rng.random((b, hb, wb)) < 0.15)
    tex = np.pad(tex.repeat(16, 1).repeat(16, 2), ((0, 0), (0, h - 16 * hb), (0, w - 16 * wb)))
    cells = rng.integers(0, maxv + 1, (b, (h + 7) // 8, (w + 7) // 8), dtype=np.int32)
    cells = cells.repeat(8, 1).repeat(8, 2)[:, :h, :w]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((0.2 + 0.5 * xx / w + 0.1 * yy / h) * maxv).astype(np.float32)
    plate = np.where(tex, cells, smooth[None]) + rng.normal(0, 0.02 * maxv, (b, h, w))
    return np.clip(np.round(plate), 0, maxv).astype(np.int16)


def textured_4k(dev, b=16):
    """The textured plate at 3840x2160 10-bit 4:2:0: luma, Cb and Cr."""
    rng = np.random.default_rng(77)
    return [torch.from_numpy(textured_plate(rng, b, h, w, 10)).to(dev)
            for h, w in ((2160, 3840), (1080, 1920), (1080, 1920))]


def checkerboard(b, h, w, bd):
    """0 / max in a checkerboard (mirrored in odd frames): every block away
    from the edge has the same activity, so all of them are flat, and |q|
    reaches 40 max inside the edge band."""
    i, j = np.mgrid[0:h, 0:w]
    board = np.where((i + j) % 2, 0, (1 << bd) - 1).astype(np.int16)
    return np.stack([board if k % 2 == 0 else board[:, ::-1] for k in range(b)])


def estimate_edge_cases(rng, dev, errs) -> int:
    """The estimate kernels at their edges (as tests/test_torch_cuda.py):
    the blur at widths 520-531 (every residue of its 4-column lanes), on
    uint8 planes, on bases off the 16-byte boundary and a batch slice, on
    4 frames of 16000x2600 (41,000 CTAs), over the whole int16 range; the
    statistics on the 12-bit 0/max checkerboard (|q| = 40 max), on a plane
    10000 rows tall, on q, den and lsum off the 16-byte boundary, at lags
    0-3. Returns the number of cases."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    n = 0
    for w in range(520, 532):
        for bd in (8, 10, 12):
            h = (33, 64, 41)[w % 3]
            f = torch.from_numpy(rng.integers(0, 1 << bd, (3, h, w), dtype=np.int16)).to(dev)
            blur_equal(f, bd, errs, f"{bd}-bit {w}x{h}")
            if bd == 8:
                blur_equal(f.to(torch.uint8), bd, errs, f"uint8 {w}x{h}")
            n += 1
    f = torch.from_numpy(rng.integers(0, 1024, (4, 40, 528), dtype=np.int16)).to(dev)
    blur_equal(shifted(f), 10, errs, "528x40 3 samples into its storage")
    blur_equal(f[1:], 10, errs, "batch slice [1:] of 528x40")
    big = torch.from_numpy(rng.integers(0, 4096, (4, 2600, 16000), dtype=np.int16)).to(dev)
    blur_equal(big, 12, errs, "4 x 16000x2600")
    del big
    for v in (-32768, 32767):
        blur_equal(torch.full((2, 40, 150), v, dtype=torch.int16, device=dev), 12, errs, f"all {v}")
    n += 5
    for sub in ((0, 0), (1, 1)):
        y = torch.from_numpy(checkerboard(2, 96, 200, 12)).to(dev)
        c = torch.from_numpy(checkerboard(2, 96 >> sub[1], 200 >> sub[0], 12)).to(dev)
        den, q = ek.self_blur(y, 12)
        if int(q[:, 4:-4, 4:-4].abs().max()) != 40 * 4095:
            raise AssertionError("the checkerboard's |q| is not 40 max")
        estimate_planes_equal((y, c), 12, *sub, (0, 1, 2, 3), dev, errs,
                              f"12-bit checkerboard {sub}")
        n += 1
    tall = torch.from_numpy(diff_planes(rng, 1, 10000, 48, 10, 0, 0)[0]).to(dev)
    den, q = blur_equal(tall, 10, errs, "48x10000")
    self_stats_equal(q, den, q, 1, (0, 1, 2, 3), 10, errs, "10-bit 48x10000")
    sy = torch.from_numpy(diff_planes(rng, 2, 150, 264, 10, 0, 0)[0]).to(dev)
    den, q = blur_equal(sy, 10, errs, "264x150")
    self_stats_equal(shifted(q), shifted(den), shifted(q, 1), 1, (0, 1, 2, 3), 10, errs,
                     "264x150 q, den, lsum off the 16-byte boundary")
    return n + 2


class plain_estimate_path:
    """Within the block, ops.estimate runs the plain PyTorch versions of
    the blur, the flat-block activity and the statistics instead of the
    kernels (the reference the fitted table is held against)."""

    def __enter__(self):
        from grav1synth_tpu_torch.ops import diff_estimate as de
        from grav1synth_tpu_torch.ops import diff_kernels as dk
        from grav1synth_tpu_torch.ops import estimate as te
        from grav1synth_tpu_torch.ops import estimate_kernels as ek

        self.saved = te.self_blur, te.self_stats, de.flat_block_activity
        te.self_blur, te.self_stats = ek.self_blur_reference, ek.self_stats_reference
        de.flat_block_activity = dk.flat_block_activity_reference

    def __exit__(self, *exc):
        from grav1synth_tpu_torch.ops import diff_estimate as de
        from grav1synth_tpu_torch.ops import estimate as te

        te.self_blur, te.self_stats, de.flat_block_activity = self.saved


def estimate_launches():
    return launch_counts("self_blur", "self_stats", "flat_block_activity")


def exact_or_rtol(got: dict, want: dict, n_pool, what: str) -> str:
    """Card statistics against the CPU run's: equal where every raw integer
    sum behind an entry is below 2^53 (both sides then hold it exactly);
    an entry whose raw sum may pass 2^53 is compared at ESTIMATE_RTOL, and
    the returned note says how many did."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    loose = 0
    for k, w in want.items():
        g = got[k].cpu()
        # the largest factor between an entry and its raw integer sum
        unscale = {"ata": ek.AREA**2 * (n_pool or 1) ** 2, "atb": ek.AREA**2 * (n_pool or 1),
                   "bin_sum": ek.AREA, "bin_sumsq": ek.AREA**2}.get(k, 1)
        big = w.abs() * unscale >= 2.0**53
        loose += int(big.sum())
        if not torch.equal(g[~big], w[~big]):
            raise AssertionError(f"{what} {k}: card differs from the CPU run")
        if big.any():
            scale = max(float(w.abs().max()), 1.0)
            if float((g[big] - w[big]).abs().max()) / scale > ESTIMATE_RTOL:
                raise AssertionError(f"{what} {k}: card vs CPU beyond rtol {ESTIMATE_RTOL}")
    return f"{what}: {loose} entries past 2^53 (at rtol {ESTIMATE_RTOL}), the rest equal"


def top_device_ops(fn, reps: int, n: int = 8) -> str:
    """The ``n`` largest device-time entries of torch.profiler's key
    averages over ``reps`` calls of ``fn``, ms per call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted((e for e in prof.key_averages() if dev_us(e) > 0), key=dev_us, reverse=True)
    return "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3 / reps:.3f} ms" for e in rows[:n])


def estimate_phase(card, eff, dev, grainy):
    """Phase 8: the estimate kernels against their plain versions, then
    the estimate main path at full size; returns K8's and K9's launches,
    times and errors for the summary."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate as te
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    BD = 10
    errs = {"self_blur": 0, "self_stats": 0.0}
    rng = np.random.default_rng(2027)
    n_cases = n_stats = 0
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            for h, w in ((64, 64), (70, 100), (41, 301), (33, 17), (12, 40), (8, 77), (150, 260)):
                sy, _, sc = diff_planes(rng, 3, h, w, bd, sub_x, sub_y)[:3]
                n_stats += estimate_planes_equal((sy, sc), bd, sub_x, sub_y, (0, 1, 2, 3), dev,
                                                 errs, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
                n_cases += 1
    n_edge = estimate_edge_cases(rng, dev, errs)
    # the main path's inputs: the first batch of grained 4K10 frames
    y16, cb16, cr16 = (torch.from_numpy(p[:16]).to(dev) for p in grainy)
    for c in (cb16, cr16):
        n_stats += estimate_planes_equal((y16, c), BD, 1, 1, (0, 1, 2, 3), dev, errs,
                                         "10-bit 4:2:0 3840x2160 B=16")
    torch.cuda.synchronize()
    log(f"[estimate kernels] {n_cases + 1} plane sets (4:2:0/4:2:2/4:4:4 x 8/10/12-bit, planes "
        f"under 9 and 16 samples, 3840x2160 10-bit 4:2:0 B=16) and {n_edge} edge cases (blur "
        f"widths 520-531, uint8, bases off the 16-byte boundary, 41,000 CTAs, int16 extremes; "
        f"the 12-bit 0/max checkerboard, a 10000-row plane, unaligned q/den/lsum); {n_stats} "
        f"statistics comparisons at lags 0-3, luma and chroma with the pooled luma column; equal "
        f"to the plain versions (max |err| {errs})")

    # the main path: two batches of 16 through push_batch, then finish
    def estimate(device, counts=None):
        est = te.NoiseEstimator((30, 1), BD, device=device)
        for i0 in (0, 16):
            est.push_batch(frames_of(grainy, i0, 16))
        if counts is not None:
            torch.cuda.synchronize()
            counts.append(estimate_launches())
        return est.finish()

    torch.cuda.synchronize()
    spans.reset()
    pushed = []
    tables = estimate(dev, pushed)
    torch.cuda.synchronize()
    launches = estimate_launches()
    log(f"[estimate main path] launches after the two push_batch calls {pushed[0]}, after "
        f"finish (its calibration pushes one 6-frame batch) {launches}")
    # K8, K5 and K9 once a plane and batch: 3 planes x 2 batches, then the
    # calibration's 3-plane batch
    if pushed[0] != {"self_blur": 6, "self_stats": 6, "flat_block_activity": 6} or launches != {
            "self_blur": 9, "self_stats": 9, "flat_block_activity": 9}:
        raise AssertionError(f"estimate main path launches {pushed[0]}, {launches}")
    with plain_estimate_path():
        plain_tables = estimate(dev)
    if not tables or [(t.start_time, t.end_time, t.params) for t in tables] != [
        (t.start_time, t.end_time, t.params) for t in plain_tables
    ]:
        raise AssertionError(f"kernel tables {tables} != plain tables {plain_tables}")
    got = tables[0].params
    if not got.scaling_points_y or not got.ar_coeffs_y:
        raise AssertionError(f"no luma model recovered: {got}")

    # the first two frames against the port's CPU run
    y, cb, cr = (torch.from_numpy(p[:2]) for p in grainy)
    den_c, q_c = te.self_blur(y, BD)
    den_d, q_d = te.self_blur(y.to(dev), BD)
    if not torch.equal(den_d.cpu(), den_c) or not torch.equal(q_d.cpu(), q_c):
        raise AssertionError("blurred plane or residual on the card differs from the CPU's")
    if not torch.equal(te.flat_blocks(den_d).cpu(), te.flat_blocks(den_c)):
        raise AssertionError("flat map on the card differs from the CPU's")
    notes = [exact_or_rtol(te.batch_self_stats(y.to(dev), 2, BD), te.batch_self_stats(y, 2, BD),
                           None, "luma")]
    for name, c in (("cb", cb), ("cr", cr)):
        notes.append(exact_or_rtol(
            te.batch_self_stats_chroma(c.to(dev), y.to(dev), 2, BD, 1, 1),
            te.batch_self_stats_chroma(c, y, 2, BD, 1, 1), 4, name))
    log(f"[estimate main path] 4K10 4:2:0, 2 batches of 16 through NoiseEstimator.push_batch "
        f"and finish: {len(tables)} segment(s), table equal to the plain path's (blur, flat-block "
        f"activity and statistics plain); frames 0-1 blur, residual and flat map equal to the CPU "
        f"run, statistics {'; '.join(notes)}; luma sigma-curve error vs injected: "
        f"{sigma_curve_error(eff[0], got)}")

    # times: the kernels at the main path's shapes (4K10 4:2:0 B = 16, three
    # planes, lag 2), beside their plain versions and their bounds
    planes = (y16, cb16, cr16)
    blurred = [ek.self_blur(p, BD) for p in planes]
    lsum = de.pool_sum(blurred[0][1], cb16.shape[1], cb16.shape[2], 1, 1)
    blocks = [de.flat_blocks(den) for den, _ in blurred]
    stat_args = [(q, den, bl, None if k == 0 else lsum, 1 if k == 0 else 4)
                 for k, ((den, q), bl) in enumerate(zip(blurred, blocks))]

    def blur_all(fn):
        return lambda: [fn(p, BD) for p in planes]

    def stats_all(fn, lag=2, args=None):
        return lambda: [fn(q, den, bl, ls, npool, lag, BD)
                        for q, den, bl, ls, npool in args or stat_args]

    def stats_time(lag, plain_iters=0, args=None, iters=10):
        """K9 on ``args`` (default: the main path's): the kernel alone (CUDA
        events around its C launches), beside its wrapper's time, its bound,
        its padded tensor-core floor and (where ``plain_iters``) its plain
        version's time."""
        args = args or stat_args
        outs = stats_all(ek.self_stats, lag, args)()
        t = timing(
            cuda_ms(self_stats_launches(args, lag, BD), iters),
            cuda_ms(stats_all(ek.self_stats_reference, lag, args), plain_iters, 1)
            if plain_iters else None,
            *self_stats_work(args, lag, outs),
        )
        t["wrapper_ms"] = cuda_ms(stats_all(ek.self_stats, lag, args), iters)
        t["padded_floor_ms"] = self_stats_padded_floor(args, lag, outs)
        return t

    blur_bytes = sum(nbytes(p, den, q) for p, (den, q) in zip(planes, blurred))
    floats = [p.to(torch.float32).unsqueeze(1) for p in planes]
    box = torch.ones((1, 1, ek.BLUR, ek.BLUR), dtype=torch.float32, device=dev)
    times = {
        "self_blur": timing(
            cuda_ms(blur_all(ek.self_blur), 20),
            cuda_ms(blur_all(ek.self_blur_reference), 3, 1),
            blur_bytes, BLUR_OPS * sum(p.numel() for p in planes),
        ),
        "self_stats": stats_time(2, plain_iters=2),
    }
    # the yardstick: one float32 convolution (cuDNN, TF32 off) of the 9x9
    # box sum S alone, on float32 copies of the planes
    times["self_blur"]["library_ms"] = cuda_ms(
        lambda: [torch.nn.functional.conv2d(x, box, padding=ek.EDGE) for x in floats], 20)
    del floats
    for k, t in times.items():
        t["label"] = "4K10 4:2:0 B=16 (3 planes, lag 2)"
        log(time_line(k, t["label"], t, card))
    log(f"[time] library call for self_blur: torch.nn.functional.conv2d of the box sum "
        f"(float32, cuDNN, TF32 off; den and q not formed): "
        f"{times['self_blur']['library_ms']:.4f} ms on {card}")
    lag3 = stats_time(3, iters=5)
    lag3["label"] = "4K10 4:2:0 B=16 (3 planes, lag 3)"
    log(time_line("self_stats", lag3["label"], lag3, card))
    # the textured plate: K9 against its plain version at lags 0-3, then timed
    tex = textured_4k(dev)
    tex_blur = [ek.self_blur(p, BD) for p in tex]
    tex_lsum = de.pool_sum(tex_blur[0][1], tex[1].shape[1], tex[1].shape[2], 1, 1)
    tex_args = [(q, den, de.flat_blocks(den), None if k == 0 else tex_lsum, 1 if k == 0 else 4)
                for k, (den, q) in enumerate(tex_blur)]
    n_tex = 0
    for k, (q, den, _, _, _) in enumerate(tex_args):
        n_tex += self_stats_equal(q, den, None if k == 0 else tex_lsum, 1 if k == 0 else 4,
                                  (0, 1, 2, 3), BD, errs, f"textured 4K10 plane {k}")
    flat = sum(int((a[2] != 0).sum()) for a in tex_args) / sum(a[2].numel() for a in tex_args)
    textured = stats_time(2, args=tex_args)
    textured["label"] = "4K10 4:2:0 B=16 textured plate (3 planes, lag 2)"
    log(f"[estimate kernels] textured plate 4K10 4:2:0 B=16: {flat:.3f} of the blocks flat; "
        f"{n_tex} statistics comparisons at lags 0-3 equal to the plain version (max |err| "
        f"{errs['self_stats']})")
    log(time_line("self_stats", textured["label"], textured, card))
    times["self_stats"]["other_cases"] = [lag3, textured]
    del tex, tex_blur, tex_lsum, tex_args
    probe = dmma_rates()
    log("[dmma] float64 tensor-core MMA on one SM (16 warps x 4 independent MMAs, clock64): " +
        "; ".join(f"{k} {v['fma_per_clk']:.1f} multiply-adds a clock ({v['tflops']:.2f} TFLOP/s "
                  f"over {torch.cuda.get_device_properties(0).multi_processor_count} SMs at "
                  f"{v['mhz']:.0f} MHz), latency {v['latency']:.1f} cycles, Gram through the "
                  f"fragments {'exact' if v['gram_ok'] else 'WRONG'}" for k, v in probe.items())
        + f" on {card}")
    if not probe[DMMA_LANDED]["gram_ok"]:
        raise AssertionError(f"{DMMA_LANDED}: the fragment layout K9 rests on gives a wrong Gram")
    del blurred, stat_args, blocks, lsum

    est = te.NoiseEstimator((30, 1), BD, device=dev)
    batch = frames_of(grainy, 0, 16)
    prof = profile_batches(lambda: est.push_batch(batch), 4)
    fps = frames_per_s(lambda: est.push_batch(batch), 16, 4)
    log(f"[estimate] push_batch 4K10 4:2:0 B=16: {fps:.1f} frames/s (pinned stack, upload, "
        f"blur, flat map, pooled luma, statistics, one stats download); per batch host issue "
        f"{prof['issue_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms profiled, device busy "
        f"{prof['busy_ms']:.3f} ms, idle share {prof['idle']:.3f}; on {card}")
    by_entry = top_device_ops(lambda: est.push_batch(batch), 4)
    log(f"[estimate] push_batch device time by entry: {by_entry}")
    return {k: launches[k] for k in ("self_blur", "self_stats")}, times, errs


def self_stats_work(stat_args, lag: int, outs):
    """(bytes, operations) of ``self_stats`` on ``stat_args``: the bytes it
    must move (q, den, the block map and lsum read once, the outputs
    written once), its integer operations (per sample the mask test, per
    masked pixel 4 for the binned moments) and its float64 ones (per masked
    pixel the n(n+1)/2 multiply-adds of the Gram over its n design values),
    counted on this run's masked pixels."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    moved = sum(nbytes(q, den, bl, ls) for q, den, bl, ls, _ in stat_args) + sum(
        nbytes(*out.values()) for out in outs)
    ops = fp64_ops = 0.0
    for (q, _, _, ls, _), out in zip(stat_args, outs):
        n = len(ek.offsets(lag)) + (ls is not None)
        masked = float(out["n_ar"].sum())
        ops += 2 * q.numel() + 4 * masked
        fp64_ops += n * (n + 1) * masked
    return moved, ops, fp64_ops


def self_stats_launches(stat_args, lag: int, bd: int, lib=None, outs=None, zero=False):
    """A zero-argument run of K9's C launches on ``stat_args`` through
    ``lib`` (default: the package's library) into ``outs`` (default:
    buffers made once), zeroed first only where ``zero``: the kernel alone,
    without the wrapper's allocation and unpacking, and no launch counted."""
    from grav1synth_tpu_torch import _build
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    lib = lib or _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    if outs is None:
        outs = []
        for q, _, _, ls, _ in stat_args:
            n = len(ek.offsets(lag)) + (ls is not None)
            outs.append(torch.zeros((q.shape[0], n * (n + 1) // 2 + 1 + 3 * ek.NUM_BINS),
                                    dtype=torch.int64, device=q.device))

    def run():
        for (q, den, bl, ls, npool), out in zip(stat_args, outs):
            if zero:
                out.zero_()
            b, h, w = q.shape
            err = lib.estimate_self_stats(
                q.data_ptr(), den.data_ptr(), bl.data_ptr(), None if ls is None else ls.data_ptr(),
                out.data_ptr(), b, h, w, h // 16, w // 16, lag, npool, bd, stream)
            if err != 0:
                raise RuntimeError(f"estimate_self_stats: CUDA error {err}")
    return run


def self_stats_padded_floor(stat_args, lag: int, outs) -> float:
    """K9's least time on the tensor cores with its padding: per masked
    pixel the multiply-adds of the m16n8k4 MMAs its Gram takes (the design
    values in groups of 8; 1, 2 or 5 MMAs of 16 x 8 x 4 a k-step of 4
    pixels for 1, 2 or 4 groups) over the float64 tensor-core peak."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    fma = 0.0
    for (_, _, _, ls, _), out in zip(stat_args, outs):
        groups = -(-(len(ek.offsets(lag)) + (ls is not None)) // 8)
        mmas = {1: 1, 2: 2, 4: 5}[groups]
        fma += float(out["n_ar"].sum()) * mmas * 16 * 8
    return 2 * fma / FP64_OPS_PER_S * 1e3


def frames_per_s(fn, b: int, reps: int) -> float:
    """Frames/s of ``fn`` (one batch of ``b`` frames), host clock around
    ``reps`` calls that end in a synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return b * reps / (time.perf_counter() - t0)


def pattern_grid(base, seed: int, n: int = 8):
    """A mixed batch of variants of one table covering what pattern
    generation branches on: AR lag 0-3, ar_coeff_shift 6-9,
    grain_scale_shift 0-3, chroma scaling from luma, inactive planes (no
    luma points, no Cr points, no points at all) and random coefficients,
    small on even frames and over the whole int8 range on odd ones (as
    tests/test_torch_cuda.pattern_zoo)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y, cb, cr = base.scaling_points_y, base.scaling_points_cb, base.scaling_points_cr
        csfl = False
        kind = i % 5
        if kind == 0:
            y = []
        elif kind == 1:
            csfl, cb, cr = True, [], []
        elif kind == 2:
            cr = []
        elif kind == 3:
            y, cb, cr = [], [], []
        lag = i % 4
        bound = 128 if i % 2 else 12

        def coeffs(k):
            return [int(c) for c in rng.integers(-bound, bound, k)]

        n_pos = 2 * lag * (lag + 1)
        n_chroma = n_pos + (1 if y else 0)
        out.append(dataclasses.replace(
            base, grain_seed=int(rng.integers(0, 1 << 16)), scaling_points_y=y,
            scaling_points_cb=cb, scaling_points_cr=cr, chroma_scaling_from_luma=csfl,
            ar_coeff_lag=lag, ar_coeff_shift=6 + int(rng.integers(0, 4)),
            grain_scale_shift=int(rng.integers(0, 4)),
            ar_coeffs_y=coeffs(n_pos) if y else [],
            ar_coeffs_cb=coeffs(n_chroma) if cb or csfl else [],
            ar_coeffs_cr=coeffs(n_chroma) if cr or csfl else [],
        ))
    return out


def lagged(params, lag: int, seed: int):
    """``params`` with AR lag ``lag`` and small random coefficients (the
    luma tap included where the frame has luma points), from a numpy seed."""
    rng = np.random.default_rng(seed)
    n_pos = 2 * lag * (lag + 1)
    out = []
    for p in params:
        def coeffs(k):
            return [int(c) for c in rng.integers(-12, 13, k)]

        n_chroma = n_pos + (1 if p.scaling_points_y else 0)
        csfl = p.chroma_scaling_from_luma
        out.append(dataclasses.replace(
            p, ar_coeff_lag=lag,
            ar_coeffs_y=coeffs(n_pos) if p.scaling_points_y else [],
            ar_coeffs_cb=coeffs(n_chroma) if p.scaling_points_cb or csfl else [],
            ar_coeffs_cr=coeffs(n_chroma) if p.scaling_points_cr or csfl else [],
        ))
    return out


def stray_slot_batch(base, dev):
    """Lag-2 frames whose rows carry one non-zero lag-3 slot each (luma
    slot (-3, -3), Cb slot (-3, +3), Cr slot (0, -3)), and one clean lag-2
    frame: the kernel must filter the first three at lag 3."""
    from grav1synth_tpu_torch.ops import grain as tg

    pb = tg.pack_params(lagged(reseeded([base], 4), 2, 5), dev)
    pb.coeffs_y[0, 0] = 70
    pb.coeffs_cb[1, 6] = -90
    pb.coeffs_cr[2, 21] = 50
    return pb


def nvcc_shared(src: str, stem: str) -> str:
    """``src`` compiled into a shared library under the build directory,
    named by ``stem`` and the source's hash; returns its path."""
    from grav1synth_tpu_torch import _build

    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    out_dir = os.path.join(_build.build_dir(), "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{stem}_{tag}.so")
    if not os.path.exists(so):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return so


def chain_step_cycles(iters: int = 100000) -> dict:
    """The cycles of one step of the pattern kernel's dependent chain, with
    and without the shuffle: ``{shuffle: (cycles a step, SM clock in MHz
    while the loop ran)}``, by clock64 around ``iters`` steps on one warp,
    the clock as those cycles over the launch's time by CUDA events (the
    launch itself is some microseconds of 2 ms)."""
    from grav1synth_tpu_torch import _build

    src = os.path.join(_build.build_dir(), "ab", "chain.cu")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(src, "w") as fh:
        fh.write(CHAIN_SRC)
    lib = ctypes.CDLL(nvcc_shared(src, "chain"))
    lib.chain_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chain_cycles.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    got = {}
    for shuffle in (True, False):
        def launch():
            err = lib.chain_cycles(out.data_ptr(), iters, int(shuffle), stream)
            if err != 0:
                raise RuntimeError(f"chain probe: CUDA error {err}")

        ms = cuda_ms(launch, 5)
        cycles = float(out[0])
        got[shuffle] = (cycles / iters, cycles / ms / 1e3)
    return got


def dmma_rates(iters: int = 20000) -> dict:
    """The float64 tensor-core (DMMA) shapes on one SM: ``{shape: {"fma_per_clk":
    multiply-adds a clock on the SM, "tflops": that rate over every SM at the
    clock the loop ran at, "latency": cycles of one MMA that waits for the last,
    "mhz": SM clock, "gram_ok": the Gram of a random integer matrix through the
    shape's fragments, one register per design value and pixel serving as A
    and B, equal to D^T D}}``. The rate is 16 warps of one CTA, each issuing 4
    independent MMAs ``iters`` times, by clock64 (the slowest warp); the
    latency one warp with one chain; the clock those cycles over the launch's
    time by CUDA events."""
    from grav1synth_tpu_torch import _build

    src = os.path.join(_build.build_dir(), "ab", "dmma.cu")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(src, "w") as fh:
        fh.write(DMMA_SRC)
    lib = ctypes.CDLL(nvcc_shared(src, "dmma"))
    lib.dmma_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dmma_gram.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p]
    lib.dmma_rate.restype = lib.dmma_gram.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(16 * 32, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(16, dtype=torch.int64, device="cuda")
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.integers(-1326780, 1326781, (64, 32)).astype(np.float64)).cuda()
    want = d.T @ d
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    got = {}
    for shape, (name, m, k) in enumerate(DMMA_SHAPES):
        def run(warps, chains, n):
            err = lib.dmma_rate(sink.data_ptr(), cyc.data_ptr(), shape, warps, chains, n, stream)
            if err != 0:
                raise RuntimeError(f"dmma probe {name}: CUDA error {err}")

        ms = cuda_ms(lambda: run(16, 4, iters), 3)
        cycles = float(cyc.max())
        mhz = cycles / ms / 1e3
        fma_clk = 16 * 4 * iters * m * 8 * k / cycles
        run(1, 1, iters)
        torch.cuda.synchronize()
        latency = float(cyc[0]) / iters
        gram = torch.zeros((32, 32), dtype=torch.float64, device="cuda")
        err = lib.dmma_gram(d.data_ptr(), d.shape[0], gram.data_ptr(), shape, stream)
        if err != 0:
            raise RuntimeError(f"dmma gram {name}: CUDA error {err}")
        got[name] = {"fma_per_clk": fma_clk, "tflops": 2 * fma_clk * n_sm * mhz * 1e6 / 1e12,
                     "latency": latency, "mhz": mhz, "gram_ok": bool(torch.equal(gram, want))}
    return got


def pattern_chain(params, sub_x: int, sub_y: int, probe: dict) -> dict:
    """The pattern kernel's bound as a dependent chain: the wavefront steps
    of the batch's slowest frame (frames run side by side, one CTA each;
    luma and chroma side by side within one) times the least cycles a step
    of that frame's lag can take, as ``probe`` (``chain_step_cycles``)
    measured them, at the clock the probe ran at."""
    from grav1synth_tpu_torch.ops import grain as tg

    ch, cw = tg.chroma_pattern_shape(sub_x, sub_y)
    worst = {"chain_steps": 0, "chain_step_cycles": 0.0, "sm_clock_mhz": probe[True][1],
             "chain_bound_ms": 0.0}
    for p in params:
        if p.ar_coeff_lag == 0:
            continue
        slope = max(p.ar_coeff_lag + 1, 3)
        # the sample from the row above is one step old, and comes by
        # shuffle, only where the slope is lag + 1
        cycles, mhz = probe[slope == p.ar_coeff_lag + 1]
        steps = 0
        if p.scaling_points_y:
            steps = slope * (tg.GRAIN_H - 4) + tg.GRAIN_W - 5
        if p.scaling_points_cb or p.scaling_points_cr or p.chroma_scaling_from_luma:
            steps = max(steps, slope * (ch - 4) + cw - 5)
        bound = steps * cycles / (mhz * 1e3)
        if bound > worst["chain_bound_ms"]:
            worst = {"chain_steps": steps, "chain_step_cycles": cycles, "sm_clock_mhz": mhz,
                     "chain_bound_ms": bound}
    return worst


def pattern_phase(card, eff, dev, apply4):
    """Phase 9; returns the pattern kernel's time and error for the
    summary."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    BD, SX, SY = 10, 1, 1
    err = 0
    n_cases = 0

    def hold(pb, bd, sub_x, sub_y, mono, what):
        nonlocal err
        got = gk.generate_patterns_packed(pb, bd, sub_x, sub_y, mono)
        want = gk.generate_patterns_packed_reference(pb, bd, sub_x, sub_y, mono)
        if got.shape != want.shape or got.dtype != torch.int16:
            raise AssertionError(f"pattern kernel output {tuple(got.shape)} {got.dtype}")
        e = max_abs_err(got, want)
        err = max(err, e)
        if e > TOLERANCE:
            raise AssertionError(
                f"{bd}-bit {sub_x}{sub_y} mono={mono} {what}: pattern kernel vs plain max |err| {e}"
            )

    for bd in (8, 10, 12):
        for sub_x, sub_y, mono in PATTERN_LAYOUTS:
            hold(tg.pack_params(pattern_grid(eff[0], 100 * bd + n_cases), dev),
                 bd, sub_x, sub_y, mono, "mixed batch")
            n_cases += 1
            # every lag on its own: the kernel's filter is a template on it
            for lag in range(4):
                hold(tg.pack_params(lagged(pattern_grid(eff[0], 7 * bd + lag), lag, lag), dev),
                     bd, sub_x, sub_y, mono, f"lag {lag}")
                n_cases += 1
            hold(stray_slot_batch(eff[0], dev), bd, sub_x, sub_y, mono, "stray lag-3 slots")
            n_cases += 1
    batches, pats = apply4["batches"], apply4["pats"]
    pbs = {b: tg.pack_params(ps, dev) for b, ps in batches.items()}
    for b, pb in pbs.items():
        got = gk.generate_patterns_packed(pb, BD, SX, SY).cpu()
        want = torch.from_numpy(
            np.concatenate([p.reshape(b, -1) for p in pats[b]], 1).astype(np.int16)
        )
        if not torch.equal(got, want):
            raise AssertionError(f"4K stream B={b}: pattern kernel differs from grain_ref")
    torch.cuda.synchronize()
    log(f"[pattern kernel] {n_cases} cases (8/10/12-bit x 4:2:0/4:2:2/4:4:4/mono x a mixed "
        f"batch, lags 0-3 each on its own, stray lag-3 slots in lag-2 frames) equal to the "
        f"plain version (max |err| {err}); the 4K stream's 16 and 112 reseeded frames equal "
        f"to grain_ref")

    # times: the kernel alone on rows built once, and the wrapper with the
    # row pack (a dozen small device ops) in front of it
    t = {}
    probe = chain_step_cycles()
    log("[chain] one wavefront step's dependent chain (multiply-add, shift, add, min, max) on "
        f"one warp: {probe[True][0]:.2f} cycles a step behind a shuffle at {probe[True][1]:.0f} "
        f"MHz, {probe[False][0]:.2f} without one at {probe[False][1]:.0f} MHz on {card}")
    lag = batches[16][0].ar_coeff_lag
    cases = [(f"B={b} lag {lag}", batches[b], pb) for b, pb in pbs.items()]
    lag3 = lagged(batches[16], 3, 3)
    cases.append(("B=16 lag 3", lag3, tg.pack_params(lag3, dev)))
    for label, params, pb in cases:
        rows = gk.pattern_params(pb)
        t[label] = timing(
            cuda_ms(lambda: gk.pattern_kernel(rows, BD, SX, SY), 50),
            cuda_ms(lambda: gk.generate_patterns_packed_reference(pb, BD, SX, SY), 3, 1),
            *pattern_work(params, gk.pattern_kernel(rows, BD, SX, SY), rows, SX, SY),
        )
        rec = t[label]
        rec.update(pattern_chain(params, SX, SY, probe), label=f"4K10 4:2:0 {label}")
        wrapped = cuda_ms(lambda: gk.generate_patterns_packed(pb, BD, SX, SY), 50)
        log(time_line("grain_pattern", rec["label"], rec, card))
        log(f"[time] grain_pattern {rec['label']}: chain bound {rec['chain_bound_ms']:.4f} "
            f"ms ({rec['chain_steps']} dependent steps x {rec['chain_step_cycles']:.2f} cycles "
            f"at {rec['sm_clock_mhz']:.0f} MHz), share of it "
            f"{rec['chain_bound_ms'] / rec['ms']:.3f}; with the row pack {wrapped:.4f} ms per "
            f"batch; grain_ref on the host {apply4['gen_ms']:.1f} ms/frame "
            f"({apply4['gen_ms'] * len(params):.1f} ms per batch) on {card}")
    main_case = t.pop(f"B=16 lag {lag}")
    main_case["other_cases"] = list(t.values())
    return {"grain_pattern": main_case}, {"grain_pattern": err}


def sharded_phase(card, dev, apply4, dev_outs, clean, grainy):
    """Phase 10: the sharded apply and diff paths; returns the two-shard
    apply's frames/s."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.parallel import DeviceMesh, make_mesh, sharded_apply_with_stats

    BD = 10
    y, cb, cr = apply4["frames"][16]
    pb = tg.pack_params(apply4["batches"][16], dev)
    want = dev_outs[16]
    d = want[0].to(torch.int64) - y.to(torch.int64)
    recount = float((d * d).sum())
    fps = {}
    for name, mesh in (("make_mesh()", make_mesh()), ("two shards on one card", DeviceMesh([dev, dev]))):
        sharded_apply_with_stats(mesh, y, cb, cr, pb, BD)  # captures the shards' programs
        torch.cuda.synchronize()
        spans.reset()
        out = sharded_apply_with_stats(mesh, y, cb, cr, pb, BD)
        torch.cuda.synchronize()
        launches = launch_counts("grain_tables", "grain_pattern", "grain_fused")
        others = launch_counts("grain_luma", "grain_chroma_pair")
        programs = program_counts()
        if set(launches.values()) != {len(mesh)} or set(others.values()) != {0} or \
                programs != {"captures": 0, "replays": len(mesh)}:
            raise AssertionError(f"sharded apply over {name}: launches {launches}, {others}, "
                                 f"programs {programs}")
        for k in range(3):
            if not torch.equal(out[k], want[k]):
                raise AssertionError(f"sharded apply over {name}: plane {k} differs from unsharded")
        energy, frames = float(out[3]), int(out[4])
        if frames != 16 or not abs(energy - recount) <= ENERGY_RTOL * recount:
            raise AssertionError(
                f"sharded apply over {name}: frames {frames}, energy {energy} vs {recount}"
            )
        fps[name] = frames_per_s(
            lambda: sharded_apply_with_stats(mesh, y, cb, cr, pb, BD), 16, 10)
        log(f"[sharded] sharded_apply_with_stats over {name} ({len(mesh)} shard(s)), 4K10 4:2:0 "
            f"B=16: planes equal to the unsharded apply, frames 16, energy {energy:.6g} "
            f"(int64 recount {recount:.6g}); launches {launches}; {fps[name]:.1f} frames/s "
            f"on {card}")

    def estimate(mesh):
        est = de.DiffEstimator((30, 1), BD, BD, chunk_frames=1000, device=dev)
        for i0 in (0, 16):
            est.diff_batch(frames_of(grainy, i0, 16), frames_of(clean, i0, 16), mesh=mesh)
        return [(t.start_time, t.end_time, t.params) for t in est.finish()]

    tables = estimate(None)
    sharded = estimate(DeviceMesh([dev, dev]))
    if not tables or sharded != tables:
        raise AssertionError(f"diff over two shards: {sharded} != {tables}")
    log(f"[sharded] DiffEstimator.diff_batch over two shards on one card, 4K10 4:2:0, "
        f"2 batches of 16: {len(sharded)} segment(s), table equal to the unsharded one")
    from grav1synth_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(1)
    return fps["two shards on one card"]


def frame_digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DIST_KERNELS = ("grain_tables", "grain_pattern", "grain_fused", "flat_block_activity",
                "plane_stats")


def distributed_rank(rank, world, port, work, eff, digests, recount, diff_mine, diff_want):
    """One rank of phase 11 (a spawned process). Its output goes to
    ``work``/rank<r>.log, its result to ``work``/rank<r>.json; any failed
    check raises, and the process exits non-zero."""
    log_fd = os.open(os.path.join(work, f"rank{rank}.log"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.parallel import (
        DeviceMesh, initialize, process_allgather, sharded_apply_with_stats, shutdown,
        sync_global_devices,
    )
    from grav1synth_tpu_torch.parallel.distributed import all_sum, gather_frames, global_batch

    BD, B = 10, 16
    dev = torch.device("cuda", 0)
    pm = initialize(f"127.0.0.1:{port}", world, rank, local=DeviceMesh([dev]),
                    timeout=RANK_GROUP_TIMEOUT)
    a, b = pm.frame_range(B)
    host16 = random_planes(np.random.default_rng(7), B, 2160, 3840, BD, 1, 1)
    y, cb, cr = (torch.from_numpy(p[a:b]).to(dev) for p in host16)
    pb = tg.pack_params(reseeded(eff, B)[a:b], dev)

    # the sharded apply, patterns made on the card (its program captured
    # first)
    sharded_apply_with_stats(pm, y, cb, cr, pb, BD)
    torch.cuda.synchronize()
    spans.reset()
    out = sharded_apply_with_stats(pm, y, cb, cr, pb, BD)
    torch.cuda.synchronize()
    launches = launch_counts(*DIST_KERNELS[:3])
    programs = program_counts()
    if set(launches.values()) != {1} or programs != {"captures": 0, "replays": 1}:
        raise AssertionError(f"rank {rank}: sharded apply launches {launches}, programs {programs}")
    for k in range(3):
        for i in range(b - a):
            if frame_digest(out[k][i]) != digests[k][a + i]:
                raise AssertionError(f"rank {rank}: frame {a + i} plane {k} differs from unsharded")
    energy, frames = float(out[3]), int(out[4])
    energies = process_allgather(np.array([energy]))[:, 0]
    if frames != B or energy != float(recount) or (energies != energy).any():
        raise AssertionError(f"rank {rank}: frames {frames}, energy {energies} vs {recount}")
    reps = 10
    sharded_apply_with_stats(pm, y, cb, cr, pb, BD)
    torch.cuda.synchronize()
    sync_global_devices("apply timed: start")
    t0 = time.perf_counter()
    for _ in range(reps):
        sharded_apply_with_stats(pm, y, cb, cr, pb, BD)
    torch.cuda.synchronize()
    sync_global_devices("apply timed: end")
    fps = B * reps / (time.perf_counter() - t0)

    # the sharded per-frame diff statistics
    planes = [torch.from_numpy(p).to(dev) for p in diff_mine]
    torch.cuda.synchronize()
    spans.reset()
    stats = de.mesh_pair_stats_per_frame(pm, *planes, lag=2, bit_depth=BD, sub_x=1, sub_y=1,
                                         has_chroma=True)
    torch.cuda.synchronize()
    diff_launches = launch_counts(*DIST_KERNELS[3:])
    launches.update(diff_launches)
    if min(diff_launches.values()) < 3:
        raise AssertionError(f"rank {rank}: diff kernels launched {diff_launches}")
    for name, got, want in zip(("y", "cb", "cr"), stats, diff_want):
        for key, w in want.items():
            g = got[key].cpu().numpy()
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"rank {rank}: {name} {key} differs from one process")

    # the exchanges alone, host copies included: the apply's (frame counts,
    # then the int64 energy) and the diff's per-frame statistics of this
    # rank's frames
    energy_t = torch.zeros((), dtype=torch.int64, device=dev)
    mine = [v[a:b] for st in stats for v in st.values()]
    exchange = {}
    for what, fn in (("apply", lambda: (global_batch(b - a), all_sum(energy_t))),
                     ("diff", lambda: gather_frames(mine))):
        fn()
        sync_global_devices(f"{what} exchange timed")
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        exchange[what] = (time.perf_counter() - t0) / 50 * 1e3
    exchange["diff_bytes"] = sum(v.numel() * v.element_size() for v in mine)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump({"rank": rank, "frames": [a, b], "launches": launches, "fps": fps,
                   "energy": energy, "exchange": exchange}, fh)
    sync_global_devices("done")
    shutdown()


def run_ranks(work, rank_args):
    """Run ``distributed_rank`` once for each argument tuple, each in a
    spawned process; wait for all with a timeout, and stop the others as
    soon as one fails. Returns each rank's result and the seconds taken;
    raises, with the failed ranks' log tails, if a rank failed or hung."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=distributed_rank, args=args) for args in rank_args]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + RANK_WAIT
    pending = list(procs)
    while pending and time.perf_counter() < deadline:
        multiprocessing.connection.wait([p.sentinel for p in pending],
                                        timeout=max(0.0, deadline - time.perf_counter()))
        for p in [p for p in pending if p.exitcode is not None]:
            pending.remove(p)
            if p.exitcode != 0:
                deadline = 0.0  # one rank failed: stop the others
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    elapsed = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    for r in failed:
        path = os.path.join(work, f"rank{r}.log")
        tail = "(no log)"
        if os.path.exists(path):
            with open(path, errors="replace") as fh:
                tail = "".join(fh.readlines()[-30:])
        log(f"[distributed] rank {r} exit code {procs[r].exitcode}"
            f"{' (killed: hung or stopped)' if r in hung else ''}; its log's tail:\n{tail}")
    if failed:
        raise AssertionError(f"phase 11: ranks {failed} failed after {elapsed:.1f} s")
    results = []
    for r in range(len(procs)):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results, elapsed


def distributed_phase(card, dev, eff, apply4, dev_outs, clean, grainy, two_shard_fps):
    """Phase 11: two processes sharing the card; returns each kernel's
    launches in each rank."""
    from grav1synth_tpu_torch import _build
    from grav1synth_tpu_torch.ops import diff_estimate as de

    world, B = 2, 16
    want = dev_outs[16]
    digests = [[frame_digest(t[i]) for i in range(B)] for t in want]
    d = want[0].to(torch.int64) - apply4["frames"][16][0].to(torch.int64)
    recount = int((d * d).sum())
    batch = [p[:B] for pair in zip(grainy, clean) for p in pair]  # sy, dy, sc, dc, sr, dr
    stats = de.batch_pair_stats_per_frame(
        *(torch.from_numpy(p).to(dev) for p in batch), lag=2, bit_depth=10, sub_x=1, sub_y=1,
        has_chroma=True,
    )
    diff_want = [{k: v.cpu().numpy() for k, v in s.items()} for s in stats]
    port = free_port()
    os.makedirs(_build.build_dir(), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as work:
        results, elapsed = run_ranks(work, [
            (rank, world, port, work, eff, digests, recount,
             [p[rank * B // world:(rank + 1) * B // world] for p in batch], diff_want)
            for rank in range(world)
        ])
    for res in results:
        log(f"[distributed] rank {res['rank']} of {world} (gloo, local mesh cuda:0): frames "
            f"{res['frames'][0]}-{res['frames'][1] - 1} of 4K10 4:2:0 B={B} equal by sha256 "
            f"to the unsharded output, frames 16, energy {res['energy']:.6g} (int64 recount "
            f"{recount}); per-frame diff statistics of all {B} frames equal to one process's; "
            f"launches {res['launches']}; exchange alone (host copies and gloo) "
            f"{res['exchange']['apply']:.3f} ms for the apply's frame counts and energy, "
            f"{res['exchange']['diff']:.3f} ms for the diff's per-frame statistics "
            f"({res['exchange']['diff_bytes']} bytes a rank), on {card}")
    fps = results[0]["fps"]
    log(f"[distributed] sharded_apply_with_stats over 2 processes sharing one card, 4K10 "
        f"4:2:0 B=16 (8 frames a rank, patterns made on the card): {fps:.1f} frames/s on the "
        f"host clock; phase 10's two shards in one process: {two_shard_fps:.1f} frames/s; two "
        f"ranks on one card take turns on its SMs, so this is no scaling figure; phase "
        f"{elapsed:.1f} s with start-up, on {card}")
    return {k: [res["launches"][k] for res in results] for k in DIST_KERNELS}


def graph_ms(fn, n: int) -> float:
    """Device ms of one call of ``fn`` (kernel launches only): ``n`` calls
    captured back to back in one CUDA graph, its replays timed by CUDA
    events, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 10) / n


def plain_tables_graph(buf, key):
    """(graph, outputs): the plain tables (``program.program_tables``, the
    PyTorch ops the parameter program ran before the tables kernel) of the
    static input ``buf``, captured as one CUDA graph (made with
    ``keep_graph=True``, so ``graph_nodes`` reads it)."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import program as pg

    def body():
        out = pg.program_tables(tg.GrainParamsBatch(buf), key)
        return out.params_y, out.params2, out.offsets, out.rows

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = body()
    graph.instantiate()
    return graph, out


def tables_work(buf, outs):
    """(bytes, operations) of the tables kernel: the parameter buffer read
    and its four outputs written; per frame and plane 256 LUT nodes, each a
    walk over 13 segments (TABLE_SEGMENT_OPS each), and per block offset
    one LFSR update with its output (LFSR_OPS)."""
    params_y, params2, offsets, _ = outs
    planes = 1 if params2 is None else 3
    ops = (buf.shape[0] * planes * 256 * 13 * TABLE_SEGMENT_OPS
           + offsets.numel() * LFSR_OPS)
    return nbytes(buf, *outs), ops


def program_cells(apply4, lum112):
    """Phase 12's cells: (B, kind, params) at 4K10 4:2:0 for B = 16 and
    112, 3-plane tables (the chroma tables and kernel on) and luma-only
    tables (off), as ``pack_params`` reads them from the tables."""
    return [(b, kind, params) for b in (16, 112)
            for kind, params in (("3-plane", apply4["batches"][b]),
                                 ("luma-only", apply4["lum16"] if b == 16 else lum112))]


def program_paths(cell, frames, dev):
    """(graph, eager, key) of a phase-12 cell: the apply through its
    parameter program (one upload, one graph replay with the pattern
    kernel in it, the grain kernels), and the same with the program's
    eager body in the replay's place; both pack the parameters in the
    call."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import program as pg

    BD, SX, SY = 10, 1, 1
    _, _, params = cell
    y, cb, cr = frames
    key = pg.ProgramKey.of(y, BD, SX, SY, False, tg._touches_chroma(params))

    def graph():
        return tg.apply_grain(y, cb, cr, tg.pack_params(params, dev), BD, SX, SY)

    def eager():
        tables = pg.program_body(tg.pack_params(params, dev).buffer, key)
        planes = tg._unpack_patterns(tables.patterns, tg.chroma_pattern_shape(SX, SY))
        return tg.apply_with_tables(y, cb, cr, tables, planes, BD, SX, SY)

    return graph, eager, key


def staging_phase(card, dev):
    """13. render's host staging (see the module's note)."""
    from grav1synth_tpu_torch import pipelines

    rng = np.random.default_rng(13)
    host_stats = getattr(torch.cuda, "host_memory_stats", dict)
    for h, w, bd in ((2160, 3840, 10), (1080, 1920, 8)):
        dtype = np.uint8 if bd == 8 else np.uint16
        shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
        pool = [rng.integers(0, 1 << bd, (16,) + s, dtype=dtype) for s in shapes]
        if bd == 10:  # the luma's rows inside a wider buffer, as a decoder may hand them
            wide = np.zeros((16, h, w + 64), dtype)
            wide[:, :, :w] = pool[0]
            pool[0] = wide[:, :, :w]
        want = [torch.from_numpy(p.astype(np.int16)).to(dev) for p in pool]

        def hold(got, done):
            done.synchronize()
            if not all(g.dtype == torch.int16 and torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"{w}x{h} {bd}-bit: a staged batch differs")

        frames0 = spans.counter("upload.frames")
        pending, ms, allocs = [], [], None
        for i in range(12):
            if i == 2:
                allocs = host_stats().get("num_host_alloc")
            t0 = time.perf_counter()
            got = [pipelines._upload(list(p), dev) for p in pool]
            ms.append((time.perf_counter() - t0) * 1e3)
            done = torch.cuda.Event()
            done.record()
            pending.append((got, done))
            if len(pending) > 1:
                hold(*pending.pop(0))
        hold(*pending.pop())
        frames = spans.counter("upload.frames") - frames0
        new_blocks = None if allocs is None else host_stats().get("num_host_alloc") - allocs
        if frames != 12 * 3 * 16 or new_blocks not in (0, None):
            raise AssertionError(f"staging: upload.frames {frames}, new pinned blocks {new_blocks}")
        log(f"[staging] {w}x{h} {bd}-bit 4:2:0 B=16, 3 planes: equal to the int16 stack; "
            f"upload.frames {frames}; new pinned blocks after 2 batches {new_blocks}; "
            f"host ms a batch median {np.median(ms[2:]):.2f} (min {min(ms[2:]):.2f}, "
            f"max {max(ms[2:]):.2f}; first {ms[0]:.2f}) on {card}")


def program_phase(card, dev, apply4):
    """Phase 12: the apply path's parameter program (``ops.program``) at
    4K10 4:2:0, B = 16 and 112, 3-plane tables (the chroma tables and
    kernel on) and luma-only tables (off). Every frame of the
    graph path equal to the eager body on the card followed by the same
    kernels, frame 0 to grain_ref (chroma to the input where it is off);
    captures, replays and launches counted exactly; each program's graph
    nodes, capture ms and device time per replay; the host ms of the
    parameter pack; per batch the host issue ms, device busy ms and idle
    share of both paths; frames/s of both in turns (eager, graph, graph,
    eager)."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk
    from grav1synth_tpu_torch.ops import grain_ref
    from grav1synth_tpu_torch.ops import program as pg

    BD, SX, SY = 10, 1, 1
    host16, frames = apply4["host16"], apply4["frames"]
    lum112 = luma_only(apply4["batches"][112])
    refs = {}
    for kind, p0 in (("3-plane", apply4["batches"][16][0]), ("luma-only", apply4["lum16"][0])):
        refs[kind] = grain_ref.apply_grain_frame(
            [host16[k][0].astype(np.int32) for k in range(3)], p0, BD, SX, SY)
    kernels = ("grain_tables", "grain_pattern", "grain_fused", "grain_luma", "grain_chroma_pair")
    t, err = {}, 0
    pg.clear_programs()
    for b in (16, 112):
        cells = [c for c in program_cells(apply4, lum112) if c[0] == b]
        paths = [program_paths(c, frames[b], dev) for c in cells]
        # first pass: the graph path (capturing each key's program) against
        # the eager body with the same kernels, frame 0 against grain_ref;
        # the spans summed, for the captures' time
        torch.cuda.synchronize()
        spans.reset()
        level = spans.log.level
        spans.log.setLevel(logging.DEBUG)
        for (_, kind, _), (graph, eager, key) in zip(cells, paths):
            got, want = graph(), eager()
            for k in range(3):
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"B={b} {kind}: plane {k} of the graph path differs "
                                         "from the eager body's")
                ref = refs[kind][k] if key.chroma_static or k == 0 else host16[k][0]
                if not np.array_equal(got[k][0].cpu().numpy().astype(np.int64),
                                      ref.astype(np.int64)):
                    raise AssertionError(f"B={b} {kind}: frame 0 plane {k} differs from "
                                         "grain_ref")
        torch.cuda.synchronize()
        spans.log.setLevel(level)
        capture = spans.snapshot()["spans"]["program.capture"]
        keys = list(dict.fromkeys(key for _, _, key in paths))
        first = {**program_counts(), **launch_counts(*kernels)}
        if first["captures"] != len(keys) or first["replays"] != len(cells):
            raise AssertionError(f"B={b} first pass: {first}, {len(keys)} keys, {len(cells)} cells")
        # second pass, every program captured: one replay a batch, the
        # tables and pattern kernels once a batch, then the fused kernel, or
        # the luma kernel alone where the tables touch no chroma
        chroma = sum(key.chroma_static for _, _, key in paths)
        want_counts = {
            "captures": 0, "replays": len(cells),
            "grain_tables": len(cells),
            "grain_pattern": len(cells),
            "grain_fused": chroma,
            "grain_luma": len(cells) - chroma,
            "grain_chroma_pair": 0,
        }
        torch.cuda.synchronize()
        spans.reset()
        for graph, _, _ in paths:
            graph()
        torch.cuda.synchronize()
        counts = {**program_counts(), **launch_counts(*kernels)}
        if counts != want_counts:
            raise AssertionError(f"B={b} second pass: counts {counts}, expected {want_counts}")
        log(f"[program] 4K10 4:2:0 B={b}, {len(cells)} cells (3-plane tables, chroma on; "
            f"luma-only tables, chroma off): every frame of the graph path equal to the eager body's, frame 0 to grain_ref; first pass "
            f"{first}, {len(keys)} programs, their captures (with the eager warm-up; span "
            f"program.capture) {capture['total_ms'] / capture['count']:.1f} ms on average, "
            f"{capture['max_ms']:.1f} at most; then one batch a cell: {counts}")
        # each program alone: its graph (the tables and pattern kernels,
        # nothing else), device ms per replay, against the plain tables'
        # graph; the tables kernel on the whole static input against its
        # plain version, and both timed
        for (_, kind, params), (_, _, key) in zip(cells, paths):
            if key not in keys:
                continue
            keys.remove(key)
            prog = pg.program_for(key)
            pb = tg.pack_params(params, dev)
            prog.run(pb)
            nodes = graph_nodes(prog.graph)
            if (nodes.get("kernel") != 2 or nodes["nodes"] - 2 > 1
                    or prog.kernels != {"grain_tables": 1, "grain_pattern": 1}):
                raise AssertionError(f"B={b} {kind}: the program's graph {nodes}, kernels "
                                     f"recorded {prog.kernels}")
            replay_ms = cuda_ms(lambda: prog.run(pb), 50)
            alone = profile_batches(lambda: prog.run(pb), 20)
            tables_args = (prog.static_in, key.height, key.width, key.bit_depth,
                           key.chroma_static)
            got = gk.grain_tables(*tables_args)
            plain_graph, plain_out = plain_tables_graph(prog.static_in, key)
            plain_graph.replay()
            e = max(max_abs_err(g, w) for g, w in zip(got, plain_out) if w is not None)
            if e > TOLERANCE or (got[1] is None) != (plain_out[1] is None):
                raise AssertionError(f"B={b} {kind}: tables kernel vs plain max |err| {e}")
            err = max(err, e)
            plain_nodes = graph_nodes(plain_graph)
            rec = timing(graph_ms(lambda: gk.grain_tables(*tables_args), 20),
                         cuda_ms(plain_graph.replay, 20), *tables_work(prog.static_in, got))
            rec["label"] = (f"4K10 4:2:0 B={b} (made at {key.batch}), chroma "
                            f"{'on' if key.chroma_static else 'off'}")
            t[rec["label"]] = rec
            log(time_line("grain_tables", rec["label"], rec, card) +
                " (kernel: 20 launches in one graph; plain: the plain tables' graph, "
                f"{plain_nodes})")
            log(f"[program] B={b} (made at {key.batch}), chroma "
                f"{'on' if key.chroma_static else 'off'} ({kind}): "
                f"graph {nodes} (the plain tables' graph and the pattern kernel: "
                f"{plain_nodes['nodes'] + 1} nodes), kernels recorded {prog.kernels}; "
                f"tables equal to the plain version's on all {key.batch} rows; "
                f"replay {replay_ms:.4f} ms back to back (CUDA events), "
                f"device busy {alone['busy_ms']:.4f} ms a replay (torch.profiler) on {card}")
            del plain_graph, plain_out, got
        # the host's two pieces of a batch left outside the program;
        # pack_params on one table with new seeds (one row built) and on
        # a table a frame (a row each)
        params = apply4["batches"][b]
        one_table = reseeded(params[:1], b)
        own_tables = [dataclasses.replace(p, cb_offset=(p.cb_offset + i) % 512)
                      for i, p in enumerate(one_table)]
        host_ms, packed = {}, {}
        for what, fn in (
            ("one table", lambda: tg.pack_params(one_table, dev)),
            ("a table a frame", lambda: tg.pack_params(own_tables, dev)),
        ):
            fn()
            torch.cuda.synchronize()
            counts = spans.counter("pack.rows"), spans.counter("pack.frames")
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host_ms[what] = (time.perf_counter() - t0) / 20 * 1e3
            packed[what] = (f"{spans.counter('pack.rows') - counts[0]} rows / "
                            f"{spans.counter('pack.frames') - counts[1]} frames")
            torch.cuda.synchronize()
        log(f"[program] 4K10 4:2:0 3-plane B={b}, host clock a batch (no synchronise): "
            f"pack_params on one table with new seeds {host_ms['one table']:.3f} ms "
            f"({packed['one table']} in 20 calls), on a table a frame "
            f"{host_ms['a table a frame']:.3f} ms ({packed['a table a frame']}) on {card}")
        # both paths per batch, in turns
        reps = 10 if b == 16 else 3
        for (_, kind, _), (graph, eager, key) in zip(cells, paths):
            fps = {"eager": [], "graph": []}
            for which in ("eager", "graph", "graph", "eager"):
                fps[which].append(frames_per_s(eager if which == "eager" else graph, b, reps))
            prof = {"graph": profile_batches(graph, reps), "eager": profile_batches(eager, reps)}
            log(f"[program] 4K10 4:2:0 {kind} B={b} (made at {key.batch}, chroma "
                f"{'on' if key.chroma_static else 'off'}): graph "
                f"{fps['graph'][0]:.1f} / {fps['graph'][1]:.1f} frames/s, eager body "
                f"{fps['eager'][0]:.1f} / {fps['eager'][1]:.1f} (turns eager, graph, graph, "
                f"eager); per batch, graph: host issue {prof['graph']['issue_ms']:.3f} ms, "
                f"profiled wall {prof['graph']['wall_ms']:.3f} ms, device busy "
                f"{prof['graph']['busy_ms']:.3f} ms, idle {prof['graph']['idle']:.3f}; eager: "
                f"host issue {prof['eager']['issue_ms']:.3f} ms, wall "
                f"{prof['eager']['wall_ms']:.3f} ms, busy {prof['eager']['busy_ms']:.3f} ms, "
                f"idle {prof['eager']['idle']:.3f}; on {card}")
        del paths
        torch.cuda.empty_cache()
    main_case = t.pop("4K10 4:2:0 B=16 (made at 16), chroma on")
    main_case["other_cases"] = list(t.values())
    return {"grain_tables": main_case}, {"grain_tables": err}


def cell_tables(config: str, seed: int, n: int):
    """A benchmark configuration (``benchmark/configs/<config>.json``) and
    ``n`` tables of its shape, drawn by the benchmark's own ``draw_tables``
    as its apply cells draw them, as the port's parameters."""
    from grav1synth_tpu_torch.obu.types import FilmGrainParams

    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark")
    with open(os.path.join(bench, "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    sys.path.insert(0, bench)
    try:
        import inputs
    finally:
        sys.path.remove(bench)
    return cfg, [FilmGrainParams(**t) for t in inputs.draw_tables(seed, cfg["grain"], n)]


# The 4K benchmark cells' layouts phase 4 runs: a configuration of
# benchmark/configs, its geometry (H, W, bit depth, sub_x, sub_y), the shape
# of its tables (AR lag, Y/Cb/Cr points, overlap, clip) and the seed of the
# draw.
CELL_LAYOUTS = {
    "uhd10_420": ((2160, 3840, 10, 1, 1), (2, 4, 2, 2, True, False), 2**33 + 4201),
    "uhd10_422": ((2160, 3840, 10, 1, 0), (3, 14, 10, 10, True, True), 2**33 + 4221),
    "uhd12_444": ((2160, 3840, 12, 0, 0), (2, 4, 2, 2, True, False), 2**33 + 4441),
}


LAYOUT_NAMES = {(1, 1): "4:2:0", (1, 0): "4:2:2", (0, 0): "4:4:4"}


def cell_layout_phase(card, dev, config: str) -> None:
    """Phase 4's main path at a 4K benchmark cell's layout and tables
    (``CELL_LAYOUTS``)."""
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    geometry, table_shape, seed = CELL_LAYOUTS[config]
    cfg, pool = cell_tables(config, seed, 64)
    h, w, bd = cfg["height"], cfg["width"], cfg["bit_depth"]
    sx, sy = cfg["subsampling"]
    shape = {(p.ar_coeff_lag, len(p.scaling_points_y), len(p.scaling_points_cb),
              len(p.scaling_points_cr), p.overlap_flag, p.clip_to_restricted_range) for p in pool}
    if (h, w, bd, sx, sy) != geometry or shape != {table_shape}:
        raise AssertionError(f"{config}: geometry {(h, w, bd, sx, sy)}, tables {shape}")
    what = f"4K{bd} {LAYOUT_NAMES[sx, sy]} {config} tables"
    layout = f"{sx}{sy}"
    # as the cell's batches take them: frame k the table k % 64
    batches = {b: [pool[k % len(pool)] for k in range(b)] for b in (16, 112)}
    host16 = random_planes(np.random.default_rng(seed % 1000), 16, h, w, bd, sx, sy)
    dev16 = [torch.from_numpy(a).to(dev) for a in host16]
    frames = {16: dev16, 112: [t.repeat(7, 1, 1) for t in dev16]}
    pats = {b: tg.generate_patterns_ref(ps, bd, sx, sy) for b, ps in batches.items()}

    def run(b):
        return tg.apply_grain(*frames[b], tg.pack_params(batches[b], dev), bd, sx, sy)

    for b in batches:  # the captures
        run(b)
    torch.cuda.synchronize()
    spans.reset()
    outs = {b: run(b) for b in batches}
    torch.cuda.synchronize()
    launches = launch_counts("grain_tables", "grain_pattern", "grain_fused", "grain_luma",
                             "grain_chroma_pair")
    layouts = spans.counters("launch.grain_fused.")
    programs = program_counts()
    packed = {k: spans.counter("pack." + k) for k in ("frames", "rows")}
    log(f"[main path {config}] launches {launches}, fused by layout {layouts}, parameter "
        f"programs {programs}, pack {packed}")
    # one program replay and one fused kernel (of the layout's
    # instantiation) a batch; the cell's 64 tables differ only in
    # grain_seed, so each batch packs one parameter row
    if launches != {"grain_tables": 2, "grain_pattern": 2, "grain_fused": 2, "grain_luma": 0,
                    "grain_chroma_pair": 0} or layouts != {layout: 2} or \
            programs != {"captures": 0, "replays": 2} or packed != {"frames": 128, "rows": 2}:
        raise AssertionError(f"{what}: launches {launches}, by layout {layouts}, "
                             f"programs {programs}, pack {packed}")
    for b, o in outs.items():
        for k, t in enumerate(o):
            if tuple(t.shape) != tuple(frames[b][k].shape) or t.dtype != torch.int16:
                raise AssertionError(f"{what} B={b} plane {k}: shape {tuple(t.shape)} {t.dtype}")
    errs = {"grain_luma": 0, "grain_chroma_pair": 0, "grain_fused": 0}
    compare_kernels(batches[16], frames[16], bd, sx, sy, dev, errs, f"{what} B=16",
                    lambda *a: pats[16])
    check_against_grain_ref(outs[16], host16, batches[16], bd, sx, sy, [0], f"{what} B=16")
    check_against_grain_ref([t[96:] for t in outs[112]], host16, batches[112][96:], bd, sx, sy,
                            [15], f"{what} B=112 last frame")
    args = {b: kernel_inputs(batches[b], frames[b], bd, sx, sy, dev, lambda *a, b=b: pats[b])
            for b in batches}
    for b, (la, pa) in args.items():
        want = [gk.apply_plane_luma(*la), *gk.apply_planes_pair(*pa)]
        for k, wt in enumerate(want):
            if not torch.equal(outs[b][k], wt):
                raise AssertionError(f"{what} B={b} plane {k}: differs from the luma and "
                                     "chroma-pair kernels on grain_ref's patterns")
        del want
    log(f"[main path {config}] {what}, B=16 and B=112: the kernels equal to their plain "
        f"versions at B=16 (max |err| {errs}); every frame equal to the luma and chroma-pair "
        "kernels on grain_ref's patterns; first/last frames equal to grain_ref")
    del outs
    for b, (la, pa) in args.items():
        time_fused(f"{what} B={b} (<{sx},{sy}>)", la, pa, card)
    fps = frames_per_s(lambda: run(112), 112, 3)
    log(f"[apply] {what} B=112: {fps:.1f} frames/s (param pack, the parameter program with the "
        f"tables and pattern kernels, the fused grain kernel) on {card}")
    del args, frames, dev16
    torch.cuda.empty_cache()


def main() -> int:
    # 1. card identity
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from grav1synth_tpu_torch import _build
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    card = card_identity()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {name}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    eff, (W, H, BD, (SX, SY)) = stream_params(IVF)
    if (W, H, BD, (SX, SY)) != (3840, 2160, 10, (1, 1)) or not eff:
        raise AssertionError(f"unexpected stream geometry {(W, H, BD, SX, SY)}, {len(eff)} frames")
    base = eff[0]
    errs = {"grain_luma": 0, "grain_chroma_pair": 0, "grain_fused": 0}
    rng = np.random.default_rng(2024)
    n_cases = 0
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            for h, w in ((64, 64), (70, 100), (128, 160), (40, 99), (40, 301)):
                params = small_params(base)
                planes = random_planes(rng, len(params), h, w, bd, sub_x, sub_y)
                compare_kernels(params, planes, bd, sub_x, sub_y, dev, errs, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
                n_cases += 1
    # the edge geometries of the vectorised luma, chroma-pair and fused kernels:
    # widths 520-535 (every residue mod 8, luma and chroma) at odd and even
    # heights, with frames whose planes are off; planes whose base is not
    # 16-byte aligned; more work units than CTAs on the card
    mixed = mixed_params(base)
    for bd in (8, 10, 12):
        for sub_x, sub_y in ((1, 1), (1, 0), (0, 0)):
            pats = tg.generate_patterns_ref(mixed, bd, sub_x, sub_y)
            for w in range(520, 536):
                h = (41, 33, 64, 71)[w % 4]
                planes = random_planes(rng, len(mixed), h, w, bd, sub_x, sub_y)
                compare_kernels(mixed, planes, bd, sub_x, sub_y, dev, errs,
                                f"{bd}-bit {sub_x}{sub_y} {w}x{h}", lambda *a: pats)
                n_cases += 1
            if bd != 10:
                continue
            big = [torch.from_numpy(a).to(dev)
                   for a in random_planes(rng, len(mixed) + 1, 41, 301, bd, sub_x, sub_y)]
            planes = [t[1:] for t in big]  # frame bases 24682 bytes apart
            if not all(t.data_ptr() % 16 for t in planes):
                raise AssertionError("the batch slice's planes are 16-byte aligned")
            compare_kernels(mixed, planes, bd, sub_x, sub_y, dev, errs,
                            f"{bd}-bit {sub_x}{sub_y} batch slice [1:] of 301x41", lambda *a: pats)
            wide = mixed + small_params(base)[:1]  # 9 frames x 17 stripes x 4 segments
            compare_kernels(wide, random_planes(rng, len(wide), 520, 1000, bd, sub_x, sub_y),
                            bd, sub_x, sub_y, dev, errs, f"{bd}-bit {sub_x}{sub_y} 9 x 1000x520")
            n_cases += 2
    params = reseeded(eff, 16)
    planes = random_planes(rng, 16, H, W, BD, SX, SY)
    compare_kernels(params, planes, BD, SX, SY, dev, errs, f"{BD}-bit 4:2:0 {W}x{H} B=16")
    n_cases += 1
    small = small_params(base)[:2]
    sp = random_planes(rng, 2, 70, 301, 10, 1, 1)
    out = tg.apply_grain(*(torch.from_numpy(a).to(dev) for a in sp), tg.pack_params(small, dev),
                         10, 1, 1)
    check_against_grain_ref(out, sp, small, 10, 1, 1, range(2), "small frames")
    torch.cuda.synchronize()
    log(f"[kernels] {n_cases} cases integer-equal to the plain versions "
        f"(max |err| {errs}); 2 small frames equal to grain_ref")

    # 4. the main path at full size
    batches = {16: reseeded(eff, 16), 112: reseeded(eff, 112)}
    lum16 = luma_only(batches[16])
    host16 = random_planes(np.random.default_rng(7), 16, H, W, BD, SX, SY)
    dev16 = [torch.from_numpy(a).to(dev) for a in host16]
    frames = {16: dev16, 112: [t.repeat(7, 1, 1) for t in dev16]}
    t0 = time.perf_counter()
    pats = {b: tg.generate_patterns_ref(ps, BD, SX, SY) for b, ps in batches.items()}
    pats["luma16"] = tg.generate_patterns_ref(lum16, BD, SX, SY)
    gen_ms = (time.perf_counter() - t0) / (16 + 112 + 16) * 1e3
    log(f"[patterns] grain_ref on the host: {gen_ms:.1f} ms/frame ({16 + 112 + 16} frames)")

    cases = ((16, 16, batches[16]), (112, 112, batches[112]), (16, "luma16", lum16))

    def run(b, params):
        return tg.apply_grain(*frames[b], tg.pack_params(params, dev), BD, SX, SY)

    # capture each batch's program first (a capture's eager warm-up
    # launches the pattern kernel), then count one batch each
    for b, _, params in cases:
        run(b, params)
    torch.cuda.synchronize()
    spans.reset()
    outs = {key: run(b, params) for b, key, params in cases}
    torch.cuda.synchronize()
    launches = launch_counts("grain_tables", "grain_pattern", "grain_fused", "grain_luma",
                             "grain_chroma_pair")
    programs = program_counts()
    log(f"[main path] launches {launches}, parameter programs {programs}")
    # one program replay (the tables and pattern kernels in it) a batch,
    # then the fused kernel, or the luma kernel alone for the luma-only batch
    if launches != {"grain_tables": 3, "grain_pattern": 3, "grain_fused": 2, "grain_luma": 1,
                    "grain_chroma_pair": 0} or \
            programs != {"captures": 0, "replays": 3}:
        raise AssertionError(f"main path: launches {launches}, programs {programs}")
    out16, out112, outl = outs[16], outs[112], outs["luma16"]
    for o, b in ((out16, 16), (out112, 112)):
        for k, t in enumerate(o):
            if tuple(t.shape) != tuple(frames[b][k].shape) or t.dtype != torch.int16:
                raise AssertionError(f"B={b} plane {k}: shape {tuple(t.shape)} {t.dtype}")
    if outl[1] is not frames[16][1] or outl[2] is not frames[16][2]:
        raise AssertionError("luma-only batch touched chroma")
    check_against_grain_ref(out16, host16, batches[16], BD, SX, SY, [0], "4K B=16")
    check_against_grain_ref(
        [t[96:] for t in out112], host16, batches[112][96:], BD, SX, SY, [15], "4K B=112 last frame"
    )
    check_against_grain_ref(outl, host16, lum16, BD, SX, SY, [0], "4K luma-only")
    log("[main path] 4K10 B=16, B=112 and luma-only batches: first/last frames equal to grain_ref")

    # times: kernels (CUDA events) and their plain versions at B=16
    luma_args, pair_args = kernel_inputs(
        batches[16], frames[16], BD, SX, SY, dev, lambda *a: pats[16]
    )
    times = {
        "grain_luma": timing(
            cuda_ms(lambda: gk.apply_plane_luma(*luma_args), 20),
            cuda_ms(lambda: gk.apply_plane_luma_reference(*luma_args), 3, 1),
            *luma_work(luma_args),
        ),
        "grain_chroma_pair": timing(
            cuda_ms(lambda: gk.apply_planes_pair(*pair_args), 20),
            cuda_ms(lambda: gk.apply_planes_pair_reference(*pair_args), 3, 1),
            *pair_work(pair_args),
        ),
    }
    for k, t in times.items():
        log(time_line(k, "4K10 4:2:0 B=16", t, card))
    times["grain_fused"] = time_fused("4K10 4:2:0 B=16", luma_args, pair_args, card, plain=True)
    # at B = 112 the plain versions' intermediates (a gathered window per
    # block per frame) run to gigabytes: kernels only
    luma112, pair112 = kernel_inputs(
        batches[112], frames[112], BD, SX, SY, dev, lambda *a: pats[112]
    )
    log(time_line("grain_luma", "4K10 4:2:0 B=112", timing(
        cuda_ms(lambda: gk.apply_plane_luma(*luma112), 10), None, *luma_work(luma112)), card))
    log(time_line("grain_chroma_pair", "4K10 4:2:0 B=112", timing(
        cuda_ms(lambda: gk.apply_planes_pair(*pair112), 10), None, *pair_work(pair112)), card))
    time_fused("4K10 4:2:0 B=112", luma112, pair112, card)
    # every frame of the main path against the luma and chroma-pair kernels
    # on grain_ref's patterns, with tables built outside the program
    lum_args = kernel_inputs(lum16, frames[16], BD, SX, SY, dev, lambda *a: pats["luma16"])[0]
    for key, la, pa in ((16, luma_args, pair_args), (112, luma112, pair112),
                        ("luma16", lum_args, None)):
        want = [gk.apply_plane_luma(*la)] + ([] if pa is None else list(gk.apply_planes_pair(*pa)))
        for k, w in enumerate(want):
            if not torch.equal(outs[key][k], w):
                raise AssertionError(f"main path {key} plane {k}: differs from the luma and "
                                     "chroma-pair kernels on grain_ref's patterns")
    del want, lum_args
    log("[main path] 4K10 B=16, B=112 and luma-only batches: every frame equal to the luma and "
        "chroma-pair kernels on grain_ref's patterns")
    for b, key, params in cases:
        fps = frames_per_s(lambda: run(b, params), b, 10 if b == 16 else 3)
        kind = "luma-only" if key == "luma16" else "3-plane"
        log(f"[apply] 4K10 4:2:0 {kind} B={b}: {fps:.1f} frames/s (param pack, the parameter "
            f"program with the pattern kernel, the grain kernel) on {card}")
    pats16 = given_patterns(pats[16], SX, SY, dev)
    pb16 = tg.pack_params(batches[16], dev)
    plain_s = cuda_ms(
        lambda: tg.apply_grain_reference(*frames[16], *pats16, pb16, BD, SX, SY), 2, 1,
    ) / 1e3
    log(f"[apply] plain PyTorch apply_grain_reference 4K10 B=16: {16 / plain_s:.1f} frames/s on {card}")

    # phases 9 to 12 reuse the batches, frames and the main path's outputs
    apply4 = dict(
        batches=batches, lum16=lum16, host16=host16, frames=frames, pats=pats, outs=outs,
        gen_ms=gen_ms,
    )
    del luma_args, pair_args, luma112, pair112, pats16
    torch.cuda.empty_cache()
    for config in CELL_LAYOUTS:
        cell_layout_phase(card, dev, config)
    clean, grainy = grained_film(eff, dev)
    for phase in (
        lambda: diff_phases(card, eff, dev, clean, grainy),
        lambda: chroma_phase(card, eff, dev),
    ):
        phase_launches, phase_times, phase_errs = phase()
        launches.update(phase_launches)
        times.update(phase_times)
        errs.update(phase_errs)
        torch.cuda.empty_cache()
    phase_launches, phase_times, phase_errs = estimate_phase(card, eff, dev, grainy)
    launches.update(phase_launches)
    times.update(phase_times)
    errs.update(phase_errs)
    torch.cuda.empty_cache()
    phase_times, phase_errs = pattern_phase(card, eff, dev, apply4)
    times.update(phase_times)
    errs.update(phase_errs)
    two_shard_fps = sharded_phase(card, dev, apply4, outs, clean, grainy)
    rank_launches = distributed_phase(card, dev, eff, apply4, outs, clean, grainy,
                                      two_shard_fps)
    phase_times, phase_errs = program_phase(card, dev, apply4)
    times.update(phase_times)
    errs.update(phase_errs)
    staging_phase(card, dev)

    summary = {
        "kernels": [
            {
                "name": k,
                "route": "cuda",
                "source": SOURCES[k],
                "replaces": REPLACES[k],
                "launches": launches[k],
                "max_abs_err": errs[k],
                "ms": times[k]["ms"],
                "plain_ms": times[k]["plain_ms"],
                "bound_ms": times[k]["bound_ms"],
                "bound_by": times[k]["bound_by"],
                "share": times[k]["bound_ms"] / times[k]["ms"],
                "library_ms": times[k].get("library_ms"),
                "library_note": LIBRARY_NOTE[k],
                # the pattern kernel's chain bound, and a kernel's times at
                # its other sizes and lags
                **{x: times[k][x] for x in EXTRA_KEYS if x in times[k]},
                # phase 11: this kernel's launches in each rank
                **({"rank_launches": rank_launches[k]} if k in rank_launches else {}),
            }
            for k in KERNELS
        ]
    }
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    jax_package = sorted(
        m for m in sys.modules if m == "grav1synth_tpu" or m.startswith("grav1synth_tpu.")
    )
    if jax_package:
        raise AssertionError(f"modules of the JAX package were imported: {jax_package}")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
