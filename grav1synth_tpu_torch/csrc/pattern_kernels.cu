// AV1 film grain patterns on Hopper (sm_90a): the Gaussian base noise and
// the auto-regressive filter of spec 7.18.3.3 for a batch of frames, written
// straight into the packed int16 buffer the grain kernels read (luma 73x82,
// then Cb and Cr; grav1synth_tpu_torch/ops/grain.py pack_patterns).
// Bound to Python through a plain C interface (ctypes; see _build.py).
//
// grain_pattern_kernel replaces grav1synth_tpu/ops/grain_jax.py:
// generate_patterns with its parts _gaussian_base, _ar_filter and
// _ar_filter_chroma: an XLA lax.scan over wavefronts, not a Pallas kernel.
//
// What bounds it on this card: latency. The AR filter is a recurrence:
// position (y, x) reads its causal neighbours, so the filtered positions of
// a plane are taken in wavefronts, one dependent step after another. Bytes
// are nothing (26 KB out per 4:2:0 frame) and so is arithmetic (at most 25
// multiply-adds per position). What counts is the number of steps and the
// cycles between one step's result and the next one's.
//
// What the design does about it: one CTA per frame, every plane in shared
// memory as int16 (|grain| < 2^11; the AR sums are int32). The 16-bit LFSR
// is linear over GF(2), so each thread jumps to the start of its run of
// positions with the 13 matrices "2^i updates" (columns computed on the
// host once, passed by value) and steps the LFSR from there: the base costs
// each thread about 24 steps per plane. Then the filter:
//
// - The frame's lag is found from its coefficients (the largest lag whose
//   ring holds a non-zero slot of a plane that is filtered), and the filter
//   is a template on it: lag L reads 2L(L+1) taps and runs the wavefronts
//   t = S y + x with the least slope a warp can hold, S = max(L + 1, 3):
//   283 steps for the 70 x 76 luma positions at lag 1 and 2, 352 at lag 3.
//   (Slope 2 would put 38 rows in flight, more than a warp's lanes.) Lag 0
//   is no recurrence: every thread clamps, and adds the luma tap to chroma.
// - A lane owns a row (rows 32 apart in turn) and keeps every tap of its
//   position in registers: its own last L results, and for each row above a
//   window of 2L + 1 samples that shifts by one a step. One sample enters a
//   window per step: from shared memory for the rows whose sample was
//   stored two steps ago or earlier (2 loads a step at lag 3, not 22), and
//   for the row above, when S = L + 1, by one shuffle from the lane above,
//   which made it in the step before.
// - On the wavefront only two taps were made one step earlier: (0, -1), the
//   lane's own last result, and that shuffled (-1, +L). The sum of all the
//   others (with the rounding term, and for chroma the luma tap) is formed
//   one step ahead, beside the dependent chain, not in it. A step's chain
//   is the shuffle, two multiply-adds, the shift, the add and the clamp.
// - Luma runs on warp 0, Cb and Cr on warps 1 and 2 in the same loop: the
//   luma warp publishes its finished wavefront in shared memory every few
//   steps, and a chroma warp waits until the luma samples under the
//   position it prepares are final. Nothing waits for chroma.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int PUBLISH_EVERY = 16;  // luma steps between two progress updates

// Orders this thread's shared-memory accesses before and after it, as seen
// by the CTA's other warps: the release before the luma warp's progress
// store, the acquire after a chroma warp's progress load. (Lighter than
// __threadfence_block, which is sequentially consistent.)
__device__ __forceinline__ void fence_cta() { asm volatile("fence.acq_rel.cta;" ::: "memory"); }

// The lag whose ring holds slot k of the 24 lag-3 slots (deltaRow -3..0,
// deltaCol -3..3, before (0, 0)): slot k is at (k / 7 - 3, k % 7 - 3).
__device__ __forceinline__ int slot_lag(int k) { return max(3 - k / 7, abs(k % 7 - 3)); }

// The rounded average of the luma samples under chroma position (y, x),
// anchored at (((y - 3) << SY) + 3, ((x - 3) << SX) + 3).
template <int SX, int SY>
__device__ __forceinline__ int luma_under(const int16_t* luma, int y, int x) {
  const int16_t* l = luma + (((y - 3) << SY) + 3) * GW + ((x - 3) << SX) + 3;
  int acc = 0;
#pragma unroll
  for (int i = 0; i <= SY; ++i)
#pragma unroll
    for (int j = 0; j <= SX; ++j) acc += l[i * GW + j];
  return round2(acc, SX + SY);
}

// Lag 0: no tap but, for chroma, the luma one. Every filtered position
// y in [3, H), x in [3, W - 3) is clamped, by all the CTA's threads.
template <int H, int W, bool CHROMA, int SX, int SY>
__device__ void ar_filter_lag0(int16_t* g, int ar_shift, int gmin, int gmax,
                               const int16_t* luma, int luma_coeff) {
  for (int i = threadIdx.x; i < (H - 3) * (W - 6); i += THREADS) {
    const int y = 3 + i / (W - 6), x = 3 + i % (W - 6);
    int v = g[y * W + x];
    if constexpr (CHROMA) v += round2(luma_coeff * luma_under<SX, SY>(luma, y, x), ar_shift);
    g[y * W + x] = (int16_t)min(max(v, gmin), gmax);
  }
}

// The AR filter of lag LAG >= 1 over one H x W plane, run by one warp over
// the wavefronts t = S y + x of the region y in [3, H), x in [3, W - 3).
// cq holds the plane's 24 lag-3 slots; slots outside the lag's rings are
// zero and not read. Lane l takes rows 3 + l, 35 + l, ... and walks each
// from x = 2 - 2 LAG or before: a row ends before the lane's next row has
// to begin, and at most ceil((W - 6) / S) <= 32 rows are in flight.
//
// The lane keeps the taps of its position in registers: its own last LAG
// results (own), and for each row above a window of the 2 LAG + 1 samples
// over the position (win), shifted by one each step. A row two or more
// above takes the sample that enters its window from shared memory: it was
// stored two steps ago or earlier. So does the row above when S > LAG + 1.
// When S = LAG + 1 the sample that enters the row above's window was made
// in the step before, by the lane above: it comes by shuffle, or, left and
// right of the filtered columns and under row 2, it is a base sample that
// was loaded a step ahead. Outside the filtered columns the lane walks
// over base samples, which fills the windows before the row's first step.
// In step t a lane finishes (y, x = t - S y) from the early sum formed in
// step t - 1, its last result and the sample from the lane above, then
// forms the early sum of (y, x + 1) from the shifted windows.
//
// A chroma plane adds luma_coeff times the rounded average of its
// collocated luma samples to the early sum. With `beside` the luma plane
// is being filtered by another warp at the same LAG (so the same S), which
// writes the last luma wavefront that is final to *progress: the chroma
// warp waits for the wavefront of the last sample it is about to read, and
// the luma warp publishes.
template <int H, int W, int LAG, bool CHROMA, int SX, int SY>
__device__ void ar_filter_warp(int16_t* g, const int* __restrict__ cq, int ar_shift,
                               int gmin, int gmax, const int16_t* luma, int luma_coeff,
                               volatile int* progress, bool beside) {
  constexpr int S = LAG + 1 > 3 ? LAG + 1 : 3;
  constexpr bool UP_LATE = S == LAG + 1;  // (-1, +LAG) was made one step ago
  constexpr int NW = 2 * LAG + 1;
  constexpr int T0 = 3 * S + 1 - 2 * LAG;  // row 3 starts to fill its windows
  constexpr int T1 = S * (H - 1) + W - 4;
  static_assert(W - 3 - 32 * S <= 1 - 2 * LAG && (W - 6 + S - 1) / S <= 32,
                "the rows of a lane overlap");
  const int lane = threadIdx.x & 31;
  const int up_lane = (lane + 31) & 31;

  // tap (dr, dc), dr in [-LAG, 0], dc in [-LAG, LAG], before (0, 0)
  int c[LAG + 1][NW];
#pragma unroll
  for (int dr = -LAG; dr <= 0; ++dr)
#pragma unroll
    for (int dc = -LAG; dc <= LAG; ++dc)
      c[dr + LAG][dc + LAG] = (dr < 0 || dc < 0) ? cq[(dr + 3) * 7 + dc + 3] : 0;
  const int c_own = c[LAG][LAG - 1];
  const int c_up = c[LAG - 1][2 * LAG];
  const int rnd = ar_shift > 0 ? 1 << (ar_shift - 1) : 0;

  int y = 3 + lane, x = T0 - S * y;  // this lane's row, and x = t - S y
  int own[LAG];                      // (y, x - 1 - k)
  int win[LAG][NW];                  // row y + r - LAG, columns x - LAG + k
#pragma unroll
  for (int k = 0; k < LAG; ++k) own[k] = 0;
#pragma unroll
  for (int r = 0; r < LAG; ++r)
#pragma unroll
    for (int k = 0; k < NW; ++k) win[r][k] = 0;
  int early = 0, base = 0, up_static = 0;
  bool up_dyn = false;
  int seen = -1;  // the last value read from *progress
  for (int t = T0; t <= T1; ++t) {
    int up_sel = 0;
    if constexpr (UP_LATE) {
      const int up = __shfl_sync(FULL, own[0], up_lane);
      up_sel = up_dyn ? up : up_static;
    }
    const bool active = y < H && x >= 3 && x <= W - 4;
    const int yy = min(y, H - 1);
    const int16_t* row = g + yy * W;
    const int col_n = min(max(x + 1, 0), W - 1);
    const int col_f = min(max(x + 1 + LAG, 0), W - 1);
    if constexpr (CHROMA) {
      if (beside) {
        int need = -1;
        if (y < H && x + 1 >= 3 && x + 1 <= W - 4)
          need = S * (((yy - 3) << SY) + 3 + SY) + ((x + 1 - 3) << SX) + 3 + SX;
        need = __reduce_max_sync(FULL, need);
        if (seen < need) {
          do seen = *progress; while (seen < need);
          fence_cta();
        }
      }
    }
    // the samples that enter the windows of (y, x + 1)
    const int base_next = row[col_n];
    int enter[LAG];
#pragma unroll
    for (int r = 0; r < LAG; ++r)
      enter[r] = (r < LAG - 1 || !UP_LATE) ? row[(r - LAG) * W + col_f] : 0;
    // the sample from the lane above comes by shuffle when that lane made
    // it in the step before; else it is a base sample (when it does come
    // by shuffle, the load reads this lane's own next base sample instead)
    const bool up_dyn_next =
        UP_LATE && yy - 1 >= 3 && (unsigned)(x + 1 + LAG - 3) <= (unsigned)(W - 7);
    const int up_static_next = UP_LATE ? row[up_dyn_next ? col_n : col_f - W] : 0;
    int lum = 0;
    if constexpr (CHROMA) lum = luma_under<SX, SY>(luma, yy, min(max(x + 1, 3), W - 4));

    // this step: the dependent chain
    int s = early + c_own * own[0];
    if constexpr (UP_LATE) s += c_up * up_sel;
    const int v = min(max(base + (s >> ar_shift), gmin), gmax);
    if (active) g[y * W + x] = (int16_t)v;
    const int cur = active ? v : base;  // (y, x): the result, or a base sample

    // the early sum of (y, x + 1), in two chains: own taps -2 and beyond,
    // then the shifted windows, the samples that entered last
    int e0 = rnd, e1 = luma_coeff * lum;
#pragma unroll
    for (int dc = -LAG; dc <= -2; ++dc) e0 += c[LAG][dc + LAG] * own[-dc - 2];
#pragma unroll
    for (int k = LAG - 1; k > 0; --k) own[k] = own[k - 1];
    own[0] = cur;
#pragma unroll
    for (int r = 0; r < LAG; ++r) {
      const bool fed = r < LAG - 1 || !UP_LATE;  // by a load; else by the shuffle
      const int n = fed ? NW : NW - 1;
#pragma unroll
      for (int k = 0; k < NW - 1; ++k) {
        if (k < n - 1) {
          win[r][k] = win[r][k + 1];
          if (k & 1) e1 += c[r][k] * win[r][k];
          else e0 += c[r][k] * win[r][k];
        }
      }
      win[r][n - 1] = fed ? enter[r] : up_sel;
    }
#pragma unroll
    for (int r = 0; r < LAG; ++r) {
      const int n = (r < LAG - 1 || !UP_LATE) ? NW : NW - 1;
      if (r & 1) e1 += c[r][n - 1] * win[r][n - 1];
      else e0 += c[r][n - 1] * win[r][n - 1];
    }
    early = e0 + e1;
    base = base_next;
    up_dyn = up_dyn_next;
    up_static = up_static_next;
    __syncwarp();
    if constexpr (!CHROMA) {
      if (beside && lane == 0 && (t % PUBLISH_EVERY == 0 || t == T1)) {
        fence_cta();
        *progress = t;
      }
    }
    if (++x > W - 4) {
      y += 32;
      x -= 32 * S;
    }
  }
}

// The filter of every plane of one frame at lag LAG >= 1: luma on warp 0,
// Cb and Cr on warps 1 and 2, trailing the luma wavefront.
template <int LAG, int SX, int SY>
__device__ void ar_filter_frame(int16_t* luma, int16_t* cb, int16_t* cr, const int* q,
                                int gmin, int gmax, int mono, volatile int* progress) {
  constexpr int CH = SY ? 38 : 73, CW = SX ? 44 : 82;
  const int warp = threadIdx.x / 32;
  const int ar_shift = q[Q_AR_SHIFT];
  const bool has_y = q[Q_HAS_Y] != 0;
  // without luma points the luma pattern is zero and stays zero, and no
  // chroma plane has a luma tap
  if (warp == 0 && has_y) {
    ar_filter_warp<GH, GW, LAG, false, 0, 0>(luma, q + Q_COEFFS_Y, ar_shift, gmin, gmax,
                                             nullptr, 0, progress, !mono);
  } else if (!mono && (warp == 1 || warp == 2) && q[warp == 1 ? Q_CB_ACTIVE : Q_CR_ACTIVE]) {
    const int luma_coeff = q[warp == 1 ? Q_CB_LUMA : Q_CR_LUMA];
    ar_filter_warp<CH, CW, LAG, true, SX, SY>(
        warp == 1 ? cb : cr, q + (warp == 1 ? Q_COEFFS_CB : Q_COEFFS_CR), ar_shift, gmin,
        gmax, luma, luma_coeff, progress, has_y && luma_coeff != 0);
  }
}

// Grid (B); THREADS threads. Writes row bi of out: luma, then (unless
// monochrome) Cb and Cr, each plane's rows back to back.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS, 1)
grain_pattern_kernel(const int* __restrict__ rows, const int16_t* __restrict__ gauss_g,
                     int16_t* __restrict__ out, int64_t out_stride, LfsrJump jump,
                     int bit_depth, int mono) {
  constexpr int CH = SY ? 38 : 73, CW = SX ? 44 : 82;
  constexpr int NL = GH * GW, NC = CH * CW;
  __shared__ int16_t gauss[2048];
  __shared__ int16_t pat[NL + 2 * NC];
  __shared__ uint16_t sjump[JUMP_BITS][16];
  __shared__ int luma_progress;

  const int bi = blockIdx.x;
  const int* q = rows + (int64_t)bi * Q_LEN;
  for (int i = threadIdx.x; i < 2048; i += THREADS) gauss[i] = gauss_g[i];
  for (int i = threadIdx.x; i < JUMP_BITS * 16; i += THREADS)
    sjump[i / 16][i % 16] = jump.col[i / 16][i % 16];
  if (threadIdx.x == 0) luma_progress = -1;

  const unsigned seed = (unsigned)q[Q_SEED];
  const int shift = 12 - bit_depth + q[Q_GRAIN_SCALE_SHIFT];
  const bool has_y = q[Q_HAS_Y] != 0;
  const bool cb_on = q[Q_CB_ACTIVE] != 0, cr_on = q[Q_CR_ACTIVE] != 0;
  // the frame's lag: the widest ring with a non-zero slot, over the planes
  // that are filtered (an inactive chroma plane's slots are zero already)
  int ring = 0;
  if (threadIdx.x < 72) {
    const int plane = threadIdx.x / 24;
    const bool filtered = plane == 0 ? has_y : !mono;
    if (filtered && q[Q_COEFFS_Y + threadIdx.x] != 0) ring = slot_lag(threadIdx.x % 24);
  }
  const int lag = (__syncthreads_or(ring >= 1) != 0) + (__syncthreads_or(ring >= 2) != 0) +
                  (__syncthreads_or(ring >= 3) != 0);

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
  switch (lag) {
    case 0: {
      const int ar_shift = q[Q_AR_SHIFT];
      if (has_y) ar_filter_lag0<GH, GW, false, 0, 0>(luma, ar_shift, gmin, gmax, nullptr, 0);
      __syncthreads();
      if (!mono && cb_on)
        ar_filter_lag0<CH, CW, true, SX, SY>(cb, ar_shift, gmin, gmax, luma, q[Q_CB_LUMA]);
      if (!mono && cr_on)
        ar_filter_lag0<CH, CW, true, SX, SY>(cr, ar_shift, gmin, gmax, luma, q[Q_CR_LUMA]);
      break;
    }
    case 1: ar_filter_frame<1, SX, SY>(luma, cb, cr, q, gmin, gmax, mono, &luma_progress); break;
    case 2: ar_filter_frame<2, SX, SY>(luma, cb, cr, q, gmin, gmax, mono, &luma_progress); break;
    default: ar_filter_frame<3, SX, SY>(luma, cb, cr, q, gmin, gmax, mono, &luma_progress); break;
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
