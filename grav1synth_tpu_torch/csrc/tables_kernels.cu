// The apply's parameter tables on Hopper (sm_90a): from a batch's
// (B, PARAMS_WIDTH) int32 parameter buffer (ops/grain.py _PARAM_FIELDS), in
// one launch, everything the grain kernels and the pattern kernel read:
// the per-plane rows (11 scalars and the 256-node scaling LUT of
// ops/grain_kernels.pack_plane_params), the Cb and Cr rows when asked for,
// the block offsets (ops/grain.block_offsets) and the pattern rows
// (ops/grain_kernels.pattern_params). Bound to Python through a plain C
// interface (ctypes; see _build.py).
//
// grain_tables_kernel replaces the glue of grav1synth_tpu/ops/grain_jax.py's
// jitted apply: block_offsets (:400) with lfsr_outputs (:206), the scaling
// curve _scaling_eval8 (:553), and the per-plane rows the Pallas kernels
// take. In the port these were some 260 PyTorch ops, each a launch of its
// own inside the parameter program's CUDA graph (ops/program.py), and their
// plain PyTorch versions stay as what the CPU runs and the tests hold this
// kernel to, at tolerance 0.
//
// What bounds it on this card: latency. Bytes are small (a 4K frame's rows
// are 3 x 1088 B in and 32.6 KB of block offsets out; 3.7 MB in all at
// B = 112, a microsecond at the card's bandwidth), and so is the arithmetic.
// What counts is the launch, and the one serial chain of the block offsets:
// a stripe's NB offsets are NB updates of one 16-bit LFSR, each reading the
// state the last one made.
//
// What the design does about it: one CTA a frame, so the whole batch is one
// wave up to 132 frames. In a CTA each plane's 13 segments are made once,
// with their slopes (a division each), by a thread a segment; the 256 LUT
// nodes of each plane lie across the threads (a node tests the 13 segments,
// the last that holds it wins, as in the spec's loop), the rows' scalars
// across the first threads, and the stripes across the threads: each thread
// runs its stripe's LFSR in a register, 32 updates at a time, into a
// shared-memory tile whose rows the warps then write out, a lane an offset,
// so the stores are whole 128-byte lines. Values the spec never makes (a curve with points out
// of order, an out-of-range count in a bucket's zero rows) come out as the
// plain version's do: integer arithmetic wraps as PyTorch's int32 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;  // LFSR updates a stripe makes between two writes: a warp's lanes

// the parameter buffer's columns (ops/grain.py PARAM_COLUMNS)
constexpr int C_SEED = 0;
constexpr int C_NUM_Y = 1;
constexpr int C_NUM_CB = 2;
constexpr int C_NUM_CR = 3;
constexpr int C_PTS_Y = 4;     // 14 (x, y) pairs
constexpr int C_PTS_CB = 32;   // 10 pairs
constexpr int C_PTS_CR = 52;   // 10 pairs
constexpr int C_COEFFS_Y = 72;   // 24 lag-3 slots
constexpr int C_COEFFS_CB = 96;  // 24 slots + the luma coefficient
constexpr int C_COEFFS_CR = 121;
constexpr int C_SCALING_SHIFT = 146;
constexpr int C_AR_SHIFT = 147;
constexpr int C_GRAIN_SCALE_SHIFT = 148;
constexpr int C_CB_MULT = 149;  // Cb mult, luma_mult, offset, then the same three of Cr
constexpr int C_CSFL = 155;
constexpr int C_OVERLAP = 156;
constexpr int C_CLIP = 157;
constexpr int PARAMS_WIDTH = 158;

constexpr int MAX_POINTS = 14;  // a curve as the LUT reads it; chroma's 10 padded with zeros

// a plane's row (ops/grain_kernels.py P_*)
constexpr int P_ACTIVE = 0;
constexpr int P_SCALING_SHIFT = 1;
constexpr int P_OVERLAP = 2;
constexpr int P_CLIP_LO = 3;
constexpr int P_CLIP_HI = 4;
constexpr int P_GMIN = 5;
constexpr int P_GMAX = 6;
constexpr int P_USE_MULT = 7;
constexpr int P_MULT = 8;
constexpr int P_LUMA_MULT = 9;
constexpr int P_OFFSET = 10;
constexpr int P_LUT = 16;
constexpr int P_LEN = P_LUT + 256;

// a frame's pattern row (ops/grain_kernels.py Q_*)
constexpr int Q_HAS_Y = 1;
constexpr int Q_CB_ACTIVE = 2;
constexpr int Q_CR_ACTIVE = 3;
constexpr int Q_AR_SHIFT = 4;
constexpr int Q_GRAIN_SCALE_SHIFT = 5;
constexpr int Q_CB_LUMA = 6;
constexpr int Q_CR_LUMA = 7;
constexpr int Q_COEFFS_Y = 8;
constexpr int Q_COEFFS_CB = Q_COEFFS_Y + 24;
constexpr int Q_COEFFS_CR = Q_COEFFS_CB + 24;
constexpr int Q_LEN = Q_COEFFS_CR + 24;

// int32 arithmetic that wraps, as PyTorch's does
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// A plane's curve as its LUT reads it, value i of the 14 (x, y) pairs: luma's
// for luma and under chroma scaling from luma, else the plane's own 10 and
// zeros after them.
__device__ int curve_value(const int* r, int plane, int i) {
  if (plane == 0 || r[C_CSFL] > 0) return r[C_PTS_Y + i];
  return i < 20 ? r[(plane == 1 ? C_PTS_CB : C_PTS_CR) + i] : 0;
}

// The scaling curve at the 8-bit node v (ops/grain.py _scaling_eval8): the
// last valid segment [x_j, x_{j+1}) holding v gives
// y_j + ((v - x_j) * delta_j + 32768) >> 16. seg[j] is that segment's
// (x_j, x_{j+1}, y_j, delta_j), an empty range where it is not valid; ends
// the first and the last point, (x_0, y_0, x_last, y_last): below the
// first the curve is y_0, from the last on y_last, and 0 without points.
__device__ int scaling_node(int v, const int (*seg)[4], const int* ends, int num) {
  int val = 0;
#pragma unroll
  for (int j = 0; j < MAX_POINTS - 1; ++j)
    if (v >= seg[j][0] && v < seg[j][1])
      val = wrap_add(seg[j][2], wrap_add(wrap_mul(wrap_sub(v, seg[j][0]), seg[j][3]), 32768) >> 16);
  if (v < ends[0]) val = ends[1];
  if (v >= ends[2]) val = ends[3];
  return num > 0 ? val : 0;
}

// plane 0 luma, 1 Cb, 2 Cr: the row's scalars at slot k < P_LUT
__device__ int row_scalar(const int* r, int plane, int k, int bit_depth) {
  const bool clip = r[C_CLIP] > 0;
  const bool csfl = r[C_CSFL] > 0;
  const int grain_center = 128 << (bit_depth - 8);
  const int c = C_CB_MULT + 3 * (plane - 1);  // this chroma plane's mult, luma_mult, offset
  switch (k) {
    case P_ACTIVE:
      return plane == 0 ? r[C_NUM_Y] > 0 : (csfl || r[plane == 1 ? C_NUM_CB : C_NUM_CR] > 0);
    case P_SCALING_SHIFT: return r[C_SCALING_SHIFT];
    case P_OVERLAP: return r[C_OVERLAP];
    case P_CLIP_LO: return clip ? 16 << (bit_depth - 8) : 0;
    case P_CLIP_HI: return clip ? (plane == 0 ? 235 : 240) << (bit_depth - 8) : (1 << bit_depth) - 1;
    case P_GMIN: return -grain_center;
    case P_GMAX: return grain_center - 1;
    case P_USE_MULT: return plane != 0 && !csfl;
    case P_MULT: return plane == 0 ? 0 : r[c];
    case P_LUMA_MULT: return plane == 0 ? 0 : r[c + 1];
    case P_OFFSET: return plane == 0 ? 0 : r[c + 2];
    default: return 0;
  }
}

// the frame's pattern row at slot k (ops/grain_kernels.pattern_params)
__device__ int pattern_value(const int* r, int k) {
  const int has_y = r[C_NUM_Y] > 0;
  const int cb_on = r[C_NUM_CB] > 0 || r[C_CSFL] > 0;
  const int cr_on = r[C_NUM_CR] > 0 || r[C_CSFL] > 0;
  if (k >= Q_COEFFS_CR) return wrap_mul(r[C_COEFFS_CR + k - Q_COEFFS_CR], cr_on);
  if (k >= Q_COEFFS_CB) return wrap_mul(r[C_COEFFS_CB + k - Q_COEFFS_CB], cb_on);
  if (k >= Q_COEFFS_Y) return r[C_COEFFS_Y + k - Q_COEFFS_Y];
  switch (k) {
    case Q_HAS_Y: return has_y;
    case Q_CB_ACTIVE: return cb_on;
    case Q_CR_ACTIVE: return cr_on;
    case Q_AR_SHIFT: return r[C_AR_SHIFT];
    case Q_GRAIN_SCALE_SHIFT: return r[C_GRAIN_SCALE_SHIFT];
    case Q_CB_LUMA: return wrap_mul(r[C_COEFFS_CB + 24], cb_on * has_y);
    case Q_CR_LUMA: return wrap_mul(r[C_COEFFS_CR + 24], cr_on * has_y);
    default: return r[C_SEED];  // Q_SEED
  }
}

__device__ __forceinline__ unsigned lfsr_step(unsigned r) {
  const unsigned bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1u;
  return (r >> 1) | (bit << 15);
}

// Grid (B); THREADS threads. Frame bi's luma row, its Cb and Cr rows (rows
// bi and B + bi of params2, when params2 is not null), its S x NB block
// offsets and its pattern row.
__global__ void __launch_bounds__(THREADS)
grain_tables_kernel(const int* __restrict__ params, int* __restrict__ params_y,
                    int* __restrict__ params2, int* __restrict__ offsets,
                    int* __restrict__ rows, int B, int S, int NB, int bit_depth) {
  __shared__ int r[PARAMS_WIDTH];
  __shared__ int seg[3][MAX_POINTS - 1][4];  // luma, Cb, Cr: scaling_node's segments
  __shared__ int ends[3][4];                 // and first and last points
  __shared__ int tile[THREADS][CHUNK + 1];
  const int bi = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < PARAMS_WIDTH; i += THREADS) r[i] = params[(int64_t)bi * PARAMS_WIDTH + i];
  __syncthreads();

  // each plane's curve once: thread 16 p + j makes plane p's segment j
  // (the one division a segment), thread 16 p + 13 its ends
  const bool csfl = r[C_CSFL] > 0;
  if (t < 3 * 16 && t % 16 < MAX_POINTS) {
    const int plane = t / 16, j = t % 16;
    const int num = csfl && plane != 0 ? r[C_NUM_Y] : r[C_NUM_Y + plane];
    if (j < MAX_POINTS - 1) {
      const int x0 = curve_value(r, plane, 2 * j), x1 = curve_value(r, plane, 2 * j + 2);
      const int y0 = curve_value(r, plane, 2 * j + 1);
      const int dx = wrap_sub(x1, x0);
      const bool valid = j < num - 1 && dx > 0;
      seg[plane][j][0] = valid ? x0 : 0;
      seg[plane][j][1] = valid ? x1 : 0;
      seg[plane][j][2] = y0;
      seg[plane][j][3] = valid ? wrap_mul(wrap_sub(curve_value(r, plane, 2 * j + 3), y0),
                                          (65536 + (dx >> 1)) / dx)
                               : 0;
    } else {
      const int last = min(max(num - 1, 0), MAX_POINTS - 1);
      ends[plane][0] = curve_value(r, plane, 0);
      ends[plane][1] = curve_value(r, plane, 1);
      ends[plane][2] = curve_value(r, plane, 2 * last);
      ends[plane][3] = curve_value(r, plane, 2 * last + 1);
    }
  }
  __syncthreads();

  const int planes = params2 != nullptr ? 3 : 1;
  for (int plane = 0; plane < planes; ++plane) {
    int* dst = plane == 0 ? params_y + (int64_t)bi * P_LEN
                          : params2 + ((int64_t)(plane - 1) * B + bi) * P_LEN;
    const int num = csfl && plane != 0 ? r[C_NUM_Y] : r[C_NUM_Y + plane];
    for (int v = t; v < 256; v += THREADS)
      dst[P_LUT + v] = scaling_node(v, seg[plane], ends[plane], num);
    for (int k = t; k < P_LUT; k += THREADS) dst[k] = row_scalar(r, plane, k, bit_depth);
  }
  for (int k = t; k < Q_LEN; k += THREADS) rows[(int64_t)bi * Q_LEN + k] = pattern_value(r, k);

  // block offsets: stripe s reseeds the LFSR with the frame's seed and s,
  // then each block takes the top 8 bits of the state after one update;
  // a warp writes a stripe's 32 offsets of a chunk, a lane each
  const int warp = t / 32, lane = t % 32;
  int* out = offsets + (int64_t)bi * S * NB;
  for (int s0 = 0; s0 < S; s0 += THREADS) {
    const int s = s0 + t;
    const int n_rows = min(THREADS, S - s0);
    unsigned state = (unsigned)(r[C_SEED] ^ (((s * 37 + 178) & 255) << 8) ^ ((s * 173 + 105) & 255))
                     & 0xFFFFu;
    for (int c0 = 0; c0 < NB; c0 += CHUNK) {
      const int n = min(CHUNK, NB - c0);
      if (s < S) {
        for (int k = 0; k < n; ++k) {
          state = lfsr_step(state);
          tile[t][k] = (int)(state >> 8);
        }
      }
      __syncthreads();
      for (int row = warp; row < n_rows; row += THREADS / 32)
        if (lane < n) out[(int64_t)(s0 + row) * NB + c0 + lane] = tile[row][lane];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int grain_tables(const void* params, void* params_y, void* params2, void* offsets, void* rows,
                 int B, int S, int NB, int bit_depth, void* stream) {
  if (B <= 0 || S < 0 || NB < 0 || (bit_depth != 8 && bit_depth != 10 && bit_depth != 12))
    return (int)cudaErrorInvalidValue;
  grain_tables_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)params, (int*)params_y, (int*)params2, (int*)offsets, (int*)rows, B, S, NB,
      bit_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
