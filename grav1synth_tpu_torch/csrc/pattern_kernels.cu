// AV1 film grain patterns on Hopper (sm_90a): the Gaussian base noise and
// the auto-regressive filter of spec 7.18.3.3 for a batch of frames, written
// straight into the packed int16 buffer the grain kernels read (luma 73x82,
// then Cb and Cr; grav1synth_tpu_torch/ops/grain.py PreparedPatterns).
// Bound to Python through a plain C interface (ctypes; see _build.py).
//
// grain_pattern_kernel replaces grav1synth_tpu/ops/grain_jax.py:
// generate_patterns with its parts _gaussian_base, _ar_filter and
// _ar_filter_chroma: an XLA lax.scan over wavefronts, not a Pallas kernel.
//
// What bounds it on this card: latency. The AR filter is a recurrence:
// position (y, x) reads its causal neighbours, so the 70 x 76 filtered luma
// positions take 352 dependent steps (the wavefronts t = 4y + x) and each
// 4:2:0 chroma plane 174. Bytes are nothing (26 KB out per 4:2:0 frame) and
// so is arithmetic (at most 25 multiply-adds per position).
//
// What the design does about it: one CTA per frame, every plane in shared
// memory as int16 (|grain| < 2^11; the AR sums are int32). The 16-bit LFSR
// is linear over GF(2), so each thread jumps to the start of its run of
// positions with the 13 matrices "2^i updates" (columns computed on the
// host once, passed by value) and steps the LFSR from there: the base costs
// each thread about 24 steps per plane. The luma wavefront then runs on one
// warp (at most 19 positions a step, __syncwarp between steps), Cb and Cr on
// two warps at once. Every step reads all 24 taps, zero coefficients
// included: a branch per tap would expose each read's latency in turn.
//
// The spec's rules that the wavefront form hides are kept: the luma base is
// zero without luma points, a chroma plane's base and filter run only when
// it has points or chroma scaling from luma is on, its luma tap counts only
// when the frame has luma points (ops/grain_kernels.pattern_params folds
// these into the row), Round2 by 0 is the identity, and right shifts of
// negative sums are arithmetic, as in grain_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GH = 73, GW = 82;  // luma pattern
constexpr int JUMP_BITS = 13;    // 2^13 > 73 * 82 LFSR updates

// per-frame pattern row (grain_kernels.pattern_params)
constexpr int Q_SEED = 0;
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

// col[i][b]: the LFSR state after 2^i updates from the state 1 << b
struct LfsrJump {
  uint16_t col[JUMP_BITS][16];
};

__host__ __device__ __forceinline__ unsigned lfsr_step(unsigned r) {
  const unsigned bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1u;
  return (r >> 1) | (bit << 15);
}

__device__ __forceinline__ int round2(int x, int shift) {
  return shift > 0 ? (x + (1 << (shift - 1))) >> shift : x;
}

// The state after k updates from `state`: the product of the jump matrices
// of k's set bits (powers of one matrix commute).
__device__ __forceinline__ unsigned lfsr_jump(unsigned state, int k,
                                              const uint16_t (*jump)[16]) {
  for (int i = 0; i < JUMP_BITS; ++i) {
    if (!((k >> i) & 1)) continue;
    unsigned next = 0;
    for (int b = 0; b < 16; ++b)
      if ((state >> b) & 1u) next ^= jump[i][b];
    state = next;
  }
  return state;
}

// Rounded Gaussian base of one plane of n samples: sample k is entry
// (state after k + 1 updates) >> 5 of the Gaussian sequence. Each thread
// takes a contiguous run of positions; zeros when the plane is off.
__device__ void gaussian_base(int16_t* dst, int n, unsigned seed, int shift,
                              bool active, const int16_t* gauss,
                              const uint16_t (*jump)[16]) {
  const int run = (n + THREADS - 1) / THREADS;
  const int k0 = threadIdx.x * run;
  const int k1 = min(k0 + run, n);
  if (!active) {
    for (int k = k0; k < k1; ++k) dst[k] = 0;
    return;
  }
  unsigned s = k0 < n ? lfsr_jump(seed & 0xFFFFu, k0, jump) : 0;
  for (int k = k0; k < k1; ++k) {
    s = lfsr_step(s);
    dst[k] = (int16_t)round2(gauss[(s >> 5) & 2047], shift);
  }
}

// The AR filter of one H x W plane, run by one warp over the wavefronts
// t = 4y + x of the region y in [3, H), x in [3, W - 3). c holds the 24
// lag-3 slots (deltaRow -3..0, deltaCol -3..3, before (0, 0)): slot k is at
// (k / 7 - 3, k % 7 - 3). A chroma plane adds luma_coeff times the rounded
// average of its collocated luma samples, anchored at
// (((y - 3) << SY) + 3, ((x - 3) << SX) + 3).
template <int H, int W, int SX, int SY>
__device__ void ar_filter_warp(int16_t* g, const int (&c)[24], int ar_shift,
                               int gmin, int gmax, const int16_t* luma,
                               int luma_coeff) {
  const int lane = threadIdx.x & 31;
  for (int t = 15; t <= 4 * (H - 1) + (W - 4); ++t) {
    // positions of this wavefront: x = t - 4y <= W - 4, so y >= ceil((t - (W - 4)) / 4)
    const int y = max(3, (t - (W - 4) + 3) / 4) + lane;
    const int x = t - 4 * y;
    if (y < H && x >= 3) {
      // every tap, zero or not: no branch between the loads, so the 24
      // shared-memory reads issue back to back; two partial sums halve
      // the dependent multiply-add chain
      int s0 = 0, s1 = 0;
#pragma unroll
      for (int k = 0; k < 24; k += 2) {
        s0 += c[k] * g[(y + k / 7 - 3) * W + x + k % 7 - 3];
        s1 += c[k + 1] * g[(y + (k + 1) / 7 - 3) * W + x + (k + 1) % 7 - 3];
      }
      int s = s0 + s1;
      if (luma_coeff != 0) {
        const int ly = ((y - 3) << SY) + 3, lx = ((x - 3) << SX) + 3;
        int acc = 0;
#pragma unroll
        for (int i = 0; i <= SY; ++i)
#pragma unroll
          for (int j = 0; j <= SX; ++j) acc += luma[(ly + i) * GW + lx + j];
        s += luma_coeff * round2(acc, SX + SY);
      }
      const int v = g[y * W + x] + round2(s, ar_shift);
      g[y * W + x] = (int16_t)min(max(v, gmin), gmax);
    }
    __syncwarp();
  }
}

// Grid (B); THREADS threads. Writes row bi of out: luma, then (unless
// monochrome) Cb and Cr, each plane's rows back to back.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS)
grain_pattern_kernel(const int* __restrict__ rows, const int16_t* __restrict__ gauss_g,
                     int16_t* __restrict__ out, int64_t out_stride, LfsrJump jump,
                     int bit_depth, int mono) {
  constexpr int CH = SY ? 38 : 73, CW = SX ? 44 : 82;
  constexpr int NL = GH * GW, NC = CH * CW;
  __shared__ int16_t gauss[2048];
  __shared__ int16_t pat[NL + 2 * NC];
  __shared__ uint16_t sjump[JUMP_BITS][16];

  const int bi = blockIdx.x;
  const int* q = rows + (int64_t)bi * Q_LEN;
  for (int i = threadIdx.x; i < 2048; i += THREADS) gauss[i] = gauss_g[i];
  for (int i = threadIdx.x; i < JUMP_BITS * 16; i += THREADS)
    sjump[i / 16][i % 16] = jump.col[i / 16][i % 16];
  __syncthreads();

  const unsigned seed = (unsigned)q[Q_SEED];
  const int shift = 12 - bit_depth + q[Q_GRAIN_SCALE_SHIFT];
  const bool has_y = q[Q_HAS_Y] != 0;
  const bool cb_on = q[Q_CB_ACTIVE] != 0, cr_on = q[Q_CR_ACTIVE] != 0;
  int16_t* luma = pat;
  int16_t* cb = pat + NL;
  int16_t* cr = pat + NL + NC;
  gaussian_base(luma, NL, seed, shift, has_y, gauss, sjump);
  if (!mono) {
    gaussian_base(cb, NC, seed ^ 0xB524u, shift, cb_on, gauss, sjump);
    gaussian_base(cr, NC, seed ^ 0x49D8u, shift, cr_on, gauss, sjump);
  }
  __syncthreads();

  const int grain_center = 128 << (bit_depth - 8);
  const int gmin = -grain_center, gmax = grain_center - 1;
  const int ar_shift = q[Q_AR_SHIFT];
  const int warp = threadIdx.x / 32;
  // without luma points the luma pattern is zero and stays zero
  if (warp == 0 && has_y) {
    int c[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) c[k] = q[Q_COEFFS_Y + k];
    ar_filter_warp<GH, GW, 0, 0>(luma, c, ar_shift, gmin, gmax, nullptr, 0);
  }
  __syncthreads();
  if (!mono && warp < 2 && (warp == 0 ? cb_on : cr_on)) {
    const int base = warp == 0 ? Q_COEFFS_CB : Q_COEFFS_CR;
    int c[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) c[k] = q[base + k];
    ar_filter_warp<CH, CW, SX, SY>(warp == 0 ? cb : cr, c, ar_shift, gmin, gmax, luma,
                                   q[warp == 0 ? Q_CB_LUMA : Q_CR_LUMA]);
  }
  __syncthreads();

  int16_t* o = out + (int64_t)bi * out_stride;
  const int n = mono ? NL : NL + 2 * NC;
  for (int i = threadIdx.x; i < n; i += THREADS) o[i] = pat[i];
}

LfsrJump make_jump() {
  LfsrJump j;
  for (int b = 0; b < 16; ++b) {
    unsigned s = 1u << b;
    int done = 0;
    for (int i = 0; i < JUMP_BITS; ++i) {
      for (; done < (1 << i); ++done) s = lfsr_step(s);
      j.col[i][b] = (uint16_t)s;
    }
  }
  return j;
}

}  // namespace

extern "C" {

int grain_pattern(const void* rows, const void* gauss, void* out, int64_t out_stride,
                  int B, int sub_x, int sub_y, int bit_depth, int mono, void* stream) {
  static const LfsrJump jump = make_jump();
#define LAUNCH(SX, SY)                                                        \
  grain_pattern_kernel<SX, SY><<<B, THREADS, 0, (cudaStream_t)stream>>>(      \
      (const int*)rows, (const int16_t*)gauss, (int16_t*)out, out_stride, jump, \
      bit_depth, mono)
  if (sub_x == 1 && sub_y == 1) {
    LAUNCH(1, 1);
  } else if (sub_x == 1 && sub_y == 0) {
    LAUNCH(1, 0);
  } else if (sub_x == 0 && sub_y == 0) {
    LAUNCH(0, 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
