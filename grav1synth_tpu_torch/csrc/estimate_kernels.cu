// The estimate path's device program on Hopper (sm_90a): the 9x9 blur and
// the self-statistics of its residual, bound to Python through a plain C
// interface (ctypes; see grav1synth_tpu_torch/_build.py).
//
// self_blur_kernel replaces the blur of grav1synth_tpu/ops/estimate.py:
// _box_blur (:52) with the round and clip of frame_self_stats (:85-88), an
// XLA convolution inside the jitted batch_self_stats. Per sample it writes
// den = clip((S + 40) / 81, 0, max) as int16 and q = 81 f - S as int32,
// with S the 9x9 box sum of the plane, zero outside it: the integer form of
// the JAX package's float32 round(blur) and residual f - blur (the port's
// ops/estimate_kernels.self_blur_reference says why the two agree).
//
// self_stats_kernel replaces diff_estimate.py: _masked_normal_eqs (:128)
// and _binned_moments (:175) as frame_self_stats / frame_self_stats_chroma
// (estimate.py:77, :114) call them, XLA matrix products and one-hot sums
// inside the jitted program. Per frame it masks each pixel by its flat
// block (the block map of den, zero past the last full block row or
// column) and by the edge band 4 <= i < H-4, 4 <= j < W-4, and sums at
// every masked pixel every product of two design values: q shifted by each
// causal lag offset ((0,0) first; lag 0-3) and, for chroma, the pooled
// luma residual lsum. It also sums the 64-bin moments (count, q, q^2) of
// the masked pixels binned on den >> (bit_depth - 6). The band (4) is wider
// than any lag (<= 3), so every shifted read lies inside the plane.
//
// Both kernels are exact. The blur adds at most 81 samples of int16 in
// int32. The statistics are exact on the inputs they are made for, which
// the caller must keep to and which nothing here checks: q from the blur of
// samples in [0, 2^bit_depth) with bit_depth <= 12, so |q| <= 81 max (80
// max, in fact), and lsum a sum of n_pool <= 4 such q. A product reaches
// 1.8e12 and a frame's sum about 1e19, past int32 and past float64's 2^53,
// so K6's int32 runs (diff_kernels.cu) cannot be reused. A thread adds its
// products with float64 fused multiply-adds of exact integers over its
// tile column (32 rows), and the warp adds its 32 threads' sums in
// float64, which keeps every partial sum an integer below 2^53
// (static_asserts below); each warp sum is converted exactly to int64
// (__double2ll_rn) and added over the CTA by 64-bit shared atomics (one
// lane a sum), and the CTA's sums into the frame's int64 by one global
// atomic per sum. The C
// entry point refuses a frame whose int64 sums could overflow. The host
// unpacks the int64 sums to float64.
//
// What bounds them on this card. The blur moves bytes: 2 read and 6
// written a sample (0.48 ms for a 4K10 4:2:0 batch of 16 at 3.35 TB/s).
// Its design:
//
// - A CTA stages a 32 x 128 tile of the plane with a 4-sample halo on
//   every side (40 x 136 samples, int16) in shared memory, so each input
//   sample is read from device memory 1.33 times; each thread has 16
//   single-sample loads in flight (``stage``). (Loads of four samples took
//   11-31% longer on the card: their registers cost the kernel CTAs.)
// - Vertical sums first: a thread walks a run of 8 rows of one staged
//   column with a running sum (2 shared reads a row). Then horizontal: a
//   lane owns 4 neighbouring output columns, reads the 12 vertical sums they
//   need as three 16-byte shared loads, and slides the 9-wide window in
//   registers.
// - Outputs are written once, as one 16-byte store of q and one 8-byte
//   store of den a lane where rows are aligned (W % 4 == 0 and aligned
//   bases), sample by sample elsewhere.
//
// The statistics are bound by operations: at lag 2 a luma pixel has 13
// design values and 91 pair products, a chroma pixel 14 and 105, while it
// reads 6-10 bytes. One float64 FMA per pair and masked pixel is the least
// a plain (non-tensor-core) kernel can do; Hopper's FP64 pipe issues them at
// 33.5 T op/s, half the card's float64 peak of 67 TFLOP/s on the tensor
// cores (DMMA), which chip_smoke.py's bound takes. What the design does
// about it:
//
// - A CTA stages a 32 x 128 tile of q, with lag halo rows above and 4 halo
//   columns on both sides, in shared memory as float64 (the conversion is
//   done once a sample, not once a pair), so each shifted read is a plain
//   shared load. The bins of den and, for chroma, lsum (int32, converted
//   once a row and pass) are staged beside it, so no global load waits
//   inside the row loops. A thread has 16 staging loads in flight
//   (``stage``), of four samples each where rows are aligned: one sample at
//   a time, the staging's latency took longer than the arithmetic.
// - One thread owns one tile column. Its column crosses its flat blocks
//   whole, so the flat test is per 16-row segment and the band a row range:
//   the inner loop has no per-pixel mask. Tiles without a flat block leave
//   after the block map is read.
// - The pairs go in passes of PAIR_CHUNK accumulators, each a template
//   instance whose every pair index is a compile-time constant, so that the
//   accumulators stay in registers (lag 0-1 one pass, lag 2 three or four,
//   lag 3 eleven or twelve); each pass reads its design values from shared
//   memory again. (Carrying the lag window in registers from row to row, so
//   that a row read only its own 2 lag + 1 values, took 1.4% longer at lag
//   2 on the card and 5% less at lag 3.)
// - A pass ends with one reduce-scatter over the warp (recursive halving:
//   about two shuffles per accumulator instead of five), after which each
//   lane adds its share of the warp's sums to the CTA's.
// - The bins are summed in runs of equal bins down the column, so that
//   smooth areas cost few shared atomics, and those 32-bit (a 64-bit shared
//   atomic is a compare-and-swap loop, which neighbouring lanes ending runs
//   of one bin together would repeat in turn).
//
// Tensor-core (DMMA) Gram products and a persistent grid that stages the
// next tile under the current one's arithmetic are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FB = 16;       // flat block edge
constexpr int NUM_BINS = 64;
constexpr int BLUR = 9;      // box width
constexpr int EDGE = BLUR / 2;
constexpr int AREA = BLUR * BLUR;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGE_BATCH = 16;  // global loads a thread keeps in flight while staging

// Stages n elements into shared memory: element i = t, t + THREADS, ...
// is store(i, load(i)). A thread issues STAGE_BATCH loads before it stores
// any, so that their latencies overlap.
template <int THREADS, typename Load, typename Store>
__device__ __forceinline__ void stage(int n, int t, Load load, Store store) {
  using V = decltype(load(0));
  for (int i0 = t; i0 < n; i0 += STAGE_BATCH * THREADS) {
    V v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) store(i, v[u]);
    }
  }
}

// Four neighbouring samples from one aligned load (8 or 16 bytes).
__device__ __forceinline__ int4 load4(const int16_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_int4((int16_t)(v.x & 0xffffu), (int16_t)(v.x >> 16), (int16_t)(v.y & 0xffffu),
                   (int16_t)(v.y >> 16));
}
__device__ __forceinline__ int4 load4(const int* p) { return *reinterpret_cast<const int4*>(p); }

// what a staging load of den and lsum returns
struct Int4Pair {
  int4 a, b;
};

// ---------------------------------------------------------------------------
// 9x9 blur

constexpr int BL_TW = 128;                 // output columns of a tile
constexpr int BL_TR = 32;                  // output rows of a tile
constexpr int BL_SW = BL_TW + 2 * EDGE;    // staged columns, x0 - EDGE first
constexpr int BL_SR = BL_TR + 2 * EDGE;    // staged rows, y0 - EDGE first
constexpr int BL_THREADS = 128;
constexpr int BL_RUN = 8;                  // rows of a vertical running sum
constexpr int BL_LANE_COLS = 4;            // output columns of a lane
static_assert(BL_TR % BL_RUN == 0, "runs tile the rows");
static_assert(BL_LANE_COLS * 32 == BL_TW, "a warp covers a tile row");
static_assert(BL_SW % 4 == 0, "vertical-sum rows stay 16-byte aligned");
// a box sum of int16 samples in int32
static_assert((long long)AREA * 32768 <= 2147483647LL, "a box sum overflows int32");
static_assert((long long)AREA * 32767 + (long long)AREA * 32768 <= 2147483647LL,
              "q = 81 f - S overflows int32");

// Grid (ceil(W / 128), ceil(H / 32), B). wide: every row of den and q
// starts on a boundary of four samples (W % 4 == 0 and aligned bases).
template <typename T>
__global__ void __launch_bounds__(BL_THREADS)
self_blur_kernel(const T* __restrict__ f, int16_t* __restrict__ den, int* __restrict__ q,
                 int H, int W, int maxv, bool wide) {
  __shared__ int16_t sf[BL_SR][BL_SW];
  __shared__ __align__(16) int sv[BL_TR][BL_SW];  // vertical 9-sums of each staged column

  const int b = blockIdx.z, y0 = blockIdx.y * BL_TR, x0 = blockIdx.x * BL_TW;
  const int t = threadIdx.x;
  const int64_t fo = (int64_t)b * H * W;

  stage<BL_THREADS>(
      BL_SR * BL_SW, t,
      [&](int i) {
        const int r = i / BL_SW, c = i - r * BL_SW;
        const int y = y0 - EDGE + r, x = x0 - EDGE + c;
        return (y >= 0 && y < H && x >= 0 && x < W) ? (int16_t)f[fo + (int64_t)y * W + x]
                                                    : (int16_t)0;
      },
      [&](int i, int16_t v) { (&sf[0][0])[i] = v; });
  __syncthreads();

  constexpr int RUNS = BL_TR / BL_RUN;
  for (int i = t; i < BL_SW * RUNS; i += BL_THREADS) {
    const int c = i % BL_SW, r0 = (i / BL_SW) * BL_RUN;
    int s = 0;
#pragma unroll
    for (int k = 0; k < BLUR; ++k) s += sf[r0 + k][c];
    sv[r0][c] = s;
#pragma unroll
    for (int r = 1; r < BL_RUN; ++r) {
      s += sf[r0 + r + BLUR - 1][c] - sf[r0 + r - 1][c];
      sv[r0 + r][c] = s;
    }
  }
  __syncthreads();

  const int lane = t & 31, c0 = lane * BL_LANE_COLS, x = x0 + c0;
  for (int r = t / 32; r < BL_TR; r += BL_THREADS / 32) {
    const int y = y0 + r;
    if (y >= H || x >= W) continue;
    int v[BL_LANE_COLS + BLUR - 1];
#pragma unroll
    for (int k = 0; k < (BL_LANE_COLS + BLUR - 1) / 4; ++k) {
      const int4 w4 = *reinterpret_cast<const int4*>(&sv[r][c0 + 4 * k]);
      v[4 * k] = w4.x, v[4 * k + 1] = w4.y, v[4 * k + 2] = w4.z, v[4 * k + 3] = w4.w;
    }
    int s = 0;
#pragma unroll
    for (int k = 0; k < BLUR; ++k) s += v[k];
    int qv[BL_LANE_COLS];
    int16_t dv[BL_LANE_COLS];
#pragma unroll
    for (int k = 0; k < BL_LANE_COLS; ++k) {
      if (k > 0) s += v[k + BLUR - 1] - v[k - 1];
      // truncating division: it differs from floor only below 0, where the
      // clip gives 0 either way
      dv[k] = (int16_t)min(max((s + AREA / 2) / AREA, 0), maxv);
      qv[k] = AREA * (int)sf[r + EDGE][c0 + k + EDGE] - s;
    }
    const int64_t o = fo + (int64_t)y * W + x;
    if (wide && x + BL_LANE_COLS <= W) {
      *reinterpret_cast<int4*>(q + o) = make_int4(qv[0], qv[1], qv[2], qv[3]);
      const unsigned lo = (unsigned)(uint16_t)dv[0] | ((unsigned)(uint16_t)dv[1] << 16);
      const unsigned hi = (unsigned)(uint16_t)dv[2] | ((unsigned)(uint16_t)dv[3] << 16);
      *reinterpret_cast<uint2*>(den + o) = make_uint2(lo, hi);
    } else {
#pragma unroll
      for (int k = 0; k < BL_LANE_COLS; ++k) {
        if (x + k < W) {
          q[o + k] = qv[k];
          den[o + k] = dv[k];
        }
      }
    }
  }
}

template <typename T>
int launch_blur(const void* f, void* den, void* q, int B, int H, int W, int bit_depth,
                cudaStream_t stream) {
  const dim3 grid((W + BL_TW - 1) / BL_TW, (H + BL_TR - 1) / BL_TR, B);
  const bool wide = W % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)den % 8 == 0;
  self_blur_kernel<T><<<grid, BL_THREADS, 0, stream>>>(
      (const T*)f, (int16_t*)den, (int*)q, H, W, (1 << bit_depth) - 1, wide);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Self-statistics

constexpr int ST_TW = 128;            // tile columns, one thread each
constexpr int ST_THREADS = ST_TW;
constexpr int ST_BX = ST_TW / FB;     // block columns in a tile
constexpr int ST_HALO = 4;            // halo columns staged on each side (>= lag)
constexpr int ST_SW = ST_TW + 2 * ST_HALO;
constexpr int ST_CTAS_PER_SM = 2;     // the register budget: 255 a thread
constexpr int MAX_LAG = 3;
constexpr int BIN_NONE = 255;         // a staged bin outside 0..NUM_BINS-1
static_assert(ST_HALO >= MAX_LAG, "the halo holds every lag");
static_assert(EDGE > MAX_LAG, "the band keeps every shifted read inside the plane");

// Tile rows: two block rows. (Four took 20% longer at lag 2 on the card
// and 5% less at lag 3.)
constexpr int ST_TR = 2 * FB;
constexpr int ST_SEGS = ST_TR / FB;   // block rows in a tile

// The ranges the sums rest on (the C entry point refuses deeper samples
// and larger pools).
constexpr int MAX_BIT_DEPTH = 12;
constexpr long long MAX_Q = (long long)AREA * ((1LL << MAX_BIT_DEPTH) - 1);
constexpr int MAX_POOL = 4;
constexpr long long MAX_DESIGN = MAX_POOL * MAX_Q;  // lsum; q is smaller
constexpr long long EXACT_F64 = 1LL << 53;
// a warp's float64 sums of products over its tile columns stay exact
// integers: a thread's over its column, and their sum over the warp
static_assert(32LL * ST_TR * MAX_DESIGN * MAX_DESIGN < EXACT_F64,
              "a warp's float64 sum of products leaves the exact integers");
// a CTA's int64 sums in shared memory
static_assert((long long)ST_TR * ST_TW * MAX_DESIGN * MAX_DESIGN <= 9223372036854775807LL,
              "a tile's sum of products overflows int64");
// A tile's bin moments in 32-bit shared sums: the count and the sum of q
// in int32; the sum of q^2 as the sums of each run's low SQ_LO_BITS bits
// (at most one run a pixel) and of its high bits.
constexpr int SQ_LO_BITS = 19;
constexpr long long SQ_LO_MASK = (1LL << SQ_LO_BITS) - 1;
static_assert((long long)ST_TR * ST_TW * MAX_Q <= 2147483647LL,
              "a tile's sum of q overflows int32");
static_assert((long long)ST_TR * ST_TW * SQ_LO_MASK <= 4294967295LL,
              "a tile's sum of low bits overflows uint32");
static_assert((long long)ST_TR * ST_TW * MAX_Q * MAX_Q / (1LL << SQ_LO_BITS) <= 4294967295LL,
              "a tile's sum of high bits overflows uint32");

template <int LAG>
__host__ __device__ constexpr int off_dr(int k) {
  return k == 0 ? 0 : -LAG + (k - 1) / (2 * LAG + 1);
}
template <int LAG>
__host__ __device__ constexpr int off_dc(int k) {
  return k == 0 ? 0 : -LAG + (k - 1) % (2 * LAG + 1);
}

template <int LAG, bool AUX>
struct SelfShape {
  static constexpr int K = 2 * LAG * LAG + 2 * LAG + 1;  // shifted copies of q
  static constexpr int NP = K + (AUX ? 1 : 0);           // design values
  static constexpr int NPAIR = NP * (NP + 1) / 2;        // upper triangle
  // per-frame output: pair sums (row-major, i <= j), n_ar, then the bin
  // counts, sums and sums of squares
  static constexpr int OUT_LEN = NPAIR + 1 + 3 * NUM_BINS;
  static constexpr int TR = ST_TR, SEGS = ST_SEGS;
  // dynamic shared memory: q (float64) with its halo, the pooled luma
  // column (int32, chroma only), the bins of den (uint8)
  static constexpr size_t SQ = (size_t)(TR + LAG) * ST_SW;
  static constexpr size_t SMEM =
      SQ * sizeof(double) + (AUX ? (size_t)TR * ST_TW * sizeof(int) : 0) + (size_t)TR * ST_TW;
};

// float64 accumulators a thread holds in one pass, a multiple of the warp
// (lag 0-1: every pair in one pass; lag 2 three or four passes, lag 3 eleven
// or twelve). Passes of 64 took 12% longer at lag 2 on the card: more
// registers, fewer CTAs an SM.
constexpr int PAIR_CHUNK = 32;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sums each of a lane's N values over the warp, N a multiple of 32, by
// recursive halving: at each of five steps a lane adds its partner's copy of
// the half of its values that it keeps, so the warp moves N * 31/16 values
// instead of 5 N. (Both halves cross, and each lane selects between the two
// sums it formed: a select between two elements of ``a`` would let the
// compiler index ``a`` at run time and move it to local memory.) Afterwards
// lane L holds in a[i], i < N / 32, the warp's sum of value L * N / 32 + i.
// (A template per step, so that every index of ``a`` is a compile-time
// constant: with a loop over the steps the inner loops' bounds were not,
// and ``a`` went to local memory.)
template <int N, int STEP = 0>
__device__ __forceinline__ void warp_reduce_scatter(double (&a)[N], int lane) {
  static_assert(N % 32 == 0, "a multiple of the warp");
  constexpr int o = 16 >> STEP, n = N >> STEP;
  const bool upper = lane & o;
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const double lo = a[i] + __shfl_xor_sync(FULL, a[i], o);
    const double hi = a[i + n / 2] + __shfl_xor_sync(FULL, a[i + n / 2], o);
    a[i] = upper ? hi : lo;
  }
  if constexpr (STEP < 4) warp_reduce_scatter<N, STEP + 1>(a, lane);
}

// One pass over this thread's column for pairs P0 .. P0+CHUNK-1 of the
// upper triangle (row-major, i <= j), then the next pass. The thread's
// rows are the flat segments in seg_mask, cut to [row_lo, row_hi).
template <int LAG, bool AUX, int P0>
__device__ __forceinline__ void self_gram_pass(const double* __restrict__ sq,
                                               const int* __restrict__ slsum,
                                               unsigned long long* spair, int c, int lane,
                                               int seg_mask, int row_lo, int row_hi) {
  using S = SelfShape<LAG, AUX>;
  constexpr int K = S::K, NP = S::NP, NPAIR = S::NPAIR, CHUNK = PAIR_CHUNK;
  double acc[CHUNK];
#pragma unroll
  for (int p = 0; p < CHUNK; ++p) acc[p] = 0.0;
  for (int seg = 0; seg < S::SEGS; ++seg) {
    if (!((seg_mask >> seg) & 1)) continue;
    const int lo = max(seg * FB, row_lo), hi = min(seg * FB + FB, row_hi);
    for (int rr = lo; rr < hi; ++rr) {
      double v[NP];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = sq[(rr + LAG + off_dr<LAG>(k)) * ST_SW + c + ST_HALO + off_dc<LAG>(k)];
      if constexpr (AUX) v[NP - 1] = (double)slsum[rr * ST_TW + c];
      int p = 0;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int j = i; j < NP; ++j, ++p) {
          if (p >= P0 && p < P0 + CHUNK) acc[p - P0] = fma(v[i], v[j], acc[p - P0]);
        }
      }
    }
  }
  warp_reduce_scatter(acc, lane);
#pragma unroll
  for (int i = 0; i < CHUNK / 32; ++i) {
    const int p = P0 + lane * (CHUNK / 32) + i;
    const long long a = __double2ll_rn(acc[i]);
    if (p < NPAIR && a) atomicAdd(&spair[p], (unsigned long long)a);
  }
  if constexpr (P0 + CHUNK < NPAIR)
    self_gram_pass<LAG, AUX, P0 + CHUNK>(sq, slsum, spair, c, lane, seg_mask, row_lo, row_hi);
}

// Grid (max(1, ceil(WB*16 / 128)), max(1, ceil(HB*16 / TR)), B): only
// pixels inside the full blocks can be flat. The grid is never empty, so a
// plane with no full block still launches and adds nothing to its zeroed
// outputs. Dynamic shared memory: SelfShape::SMEM. wide: every row of q,
// den and lsum starts on a boundary of four samples (W % 4 == 0 and
// aligned bases).
template <int LAG, bool AUX>
__global__ void __launch_bounds__(ST_THREADS, ST_CTAS_PER_SM)
self_stats_kernel(const int* __restrict__ q, const int16_t* __restrict__ den,
                  const uint8_t* __restrict__ blocks, const int* __restrict__ lsum,
                  unsigned long long* __restrict__ out, int H, int W, int HB, int WB,
                  int bin_shift, bool wide) {
  using S = SelfShape<LAG, AUX>;
  constexpr int NPAIR = S::NPAIR, OUT_LEN = S::OUT_LEN, TR = S::TR, SEGS = S::SEGS;
  // q at rows y0-LAG.., columns x0-ST_HALO..; lsum and the bins at the
  // tile's rows and columns
  extern __shared__ __align__(16) double sq[];
  int* slsum = reinterpret_cast<int*>(sq + S::SQ);
  uint8_t* sbin = reinterpret_cast<uint8_t*>(slsum + (AUX ? TR * ST_TW : 0));
  __shared__ unsigned long long spair[NPAIR];
  __shared__ unsigned long long sn_ar;
  // per bin: the count, the sum of q, and the sum of q^2 as the sums of its
  // runs' low SQ_LO_BITS bits and of their high bits
  __shared__ int sbin_cnt[NUM_BINS], sbin_sum[NUM_BINS];
  __shared__ unsigned sbin_sq[2][NUM_BINS];
  __shared__ uint8_t sflat[ST_SEGS][ST_BX];

  const int b = blockIdx.z, y0 = blockIdx.y * TR, x0 = blockIdx.x * ST_TW;
  const int t = threadIdx.x, lane = t & 31;
  const int64_t fo = (int64_t)b * H * W;

  int fl = 0;
  if (t < SEGS * ST_BX) {
    const int by = y0 / FB + t / ST_BX, bx = x0 / FB + t % ST_BX;
    if (by < HB && bx < WB) fl = blocks[((int64_t)b * HB + by) * WB + bx] != 0;
    sflat[t / ST_BX][t % ST_BX] = (uint8_t)fl;
  }
  for (int i = t; i < NPAIR; i += ST_THREADS) spair[i] = 0ull;
  for (int i = t; i < NUM_BINS; i += ST_THREADS) {
    sbin_cnt[i] = sbin_sum[i] = 0;
    sbin_sq[0][i] = sbin_sq[1][i] = 0u;
  }
  if (t == 0) sn_ar = 0ull;
  if (!__syncthreads_or(fl)) return;  // no flat block: nothing to add

  auto put_bin = [&](int i, int d) {
    const int bin = d >> bin_shift;
    sbin[i] = (uint8_t)(bin >= 0 && bin < NUM_BINS ? bin : BIN_NONE);
  };
  if (wide) {
    // four samples a load: a chunk starts at a column that is a multiple of
    // 4, so it lies in the plane whole or not at all
    constexpr int QCH = ST_SW / 4, CH = ST_TW / 4;
    stage<ST_THREADS>(
        (TR + LAG) * QCH, t,
        [&](int i) {
          const int r = i / QCH, y = y0 - LAG + r, x = x0 - ST_HALO + 4 * (i - r * QCH);
          return (y >= 0 && y < H && x >= 0 && x < W) ? load4(q + fo + (int64_t)y * W + x)
                                                      : make_int4(0, 0, 0, 0);
        },
        [&](int i, int4 v) {
          double* d = sq + 4 * i;
          d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
        });
    // (den, lsum) at the tile's pixels -> the bin of den, and lsum
    stage<ST_THREADS>(
        TR * CH, t,
        [&](int i) {
          const int r = i / CH, y = y0 + r, x = x0 + 4 * (i - r * CH);
          int4 d = make_int4(-1, -1, -1, -1), l = make_int4(0, 0, 0, 0);
          if (y < H && x < W) {
            const int64_t o = fo + (int64_t)y * W + x;
            d = load4(den + o);
            if constexpr (AUX) l = load4(lsum + o);
          }
          return Int4Pair{d, l};
        },
        [&](int i, Int4Pair v) {
          put_bin(4 * i, v.a.x);
          put_bin(4 * i + 1, v.a.y);
          put_bin(4 * i + 2, v.a.z);
          put_bin(4 * i + 3, v.a.w);
          if constexpr (AUX) {
            int* l = slsum + 4 * i;
            l[0] = v.b.x, l[1] = v.b.y, l[2] = v.b.z, l[3] = v.b.w;
          }
        });
  } else {
    stage<ST_THREADS>(
        (TR + LAG) * ST_SW, t,
        [&](int i) {
          const int r = i / ST_SW, cc = i - r * ST_SW;
          const int y = y0 - LAG + r, x = x0 - ST_HALO + cc;
          return (y >= 0 && y < H && x >= 0 && x < W) ? q[fo + (int64_t)y * W + x] : 0;
        },
        [&](int i, int v) { sq[i] = (double)v; });
    stage<ST_THREADS>(
        TR * ST_TW, t,
        [&](int i) {
          const int r = i / ST_TW, cc = i - r * ST_TW;
          const int y = y0 + r, x = x0 + cc;
          int2 v = make_int2(-1, 0);
          if (y < H && x < W) {
            const int64_t o = fo + (int64_t)y * W + x;
            v.x = den[o];
            if constexpr (AUX) v.y = lsum[o];
          }
          return v;
        },
        [&](int i, int2 v) {
          put_bin(i, v.x);
          if constexpr (AUX) slsum[i] = v.y;
        });
  }
  __syncthreads();

  // this column's masked rows: flat segments, cut to the band
  const int c = t, x = x0 + c;
  const bool col_in = x >= EDGE && x < W - EDGE;
  const int row_lo = max(EDGE - y0, 0), row_hi = min(H - EDGE - y0, TR);
  int seg_mask = 0;
  long long n_ar = 0;
  for (int seg = 0; seg < SEGS; ++seg) {
    if (col_in && sflat[seg][c / FB]) {
      const int n = min(seg * FB + FB, row_hi) - max(seg * FB, row_lo);
      if (n > 0) {
        seg_mask |= 1 << seg;
        n_ar += n;
      }
    }
  }
  n_ar = warp_sum(n_ar);
  if (lane == 0 && n_ar) atomicAdd(&sn_ar, (unsigned long long)n_ar);

  // 64-bin moments over the masked rows, summed in runs of equal bins down
  // the column, each run added to the CTA's bin by native 32-bit shared
  // atomics: neighbouring lanes often end runs of one bin together, and a
  // 64-bit shared atomic is a compare-and-swap loop that they would repeat
  // in turn. (Grouping each row's lanes by bin with __match_any_sync and
  // hardware reductions took 14% longer on the card.)
  {
    int cur = BIN_NONE, cnt = 0, sum = 0;
    long long sq2 = 0;
    auto flush = [&]() {
      if (cnt > 0 && cur < NUM_BINS) {
        atomicAdd(&sbin_cnt[cur], cnt);
        atomicAdd(&sbin_sum[cur], sum);
        atomicAdd(&sbin_sq[0][cur], (unsigned)(sq2 & SQ_LO_MASK));
        atomicAdd(&sbin_sq[1][cur], (unsigned)(sq2 >> SQ_LO_BITS));
      }
    };
    for (int seg = 0; seg < SEGS; ++seg) {
      if (!((seg_mask >> seg) & 1)) continue;
      const int lo = max(seg * FB, row_lo), hi = min(seg * FB + FB, row_hi);
      for (int rr = lo; rr < hi; ++rr) {
        const int bin = sbin[rr * ST_TW + c];
        const int v = (int)sq[(rr + LAG) * ST_SW + c + ST_HALO];
        if (bin != cur) {
          flush();
          cur = bin;
          cnt = sum = 0;
          sq2 = 0;
        }
        ++cnt;
        sum += v;
        sq2 += (long long)v * v;
      }
    }
    flush();
  }

  self_gram_pass<LAG, AUX, 0>(sq, slsum, spair, c, lane, seg_mask, row_lo, row_hi);
  __syncthreads();

  // the CTA's sums into the frame's: pairs, n_ar, then the bins' counts,
  // sums and sums of squares
  unsigned long long* o = out + (int64_t)b * OUT_LEN;
  for (int i = t; i < OUT_LEN; i += ST_THREADS) {
    unsigned long long v;
    if (i < NPAIR) {
      v = spair[i];
    } else if (i == NPAIR) {
      v = sn_ar;
    } else {
      const int k = i - NPAIR - 1, bin = k % NUM_BINS;
      v = k < NUM_BINS       ? (unsigned long long)sbin_cnt[bin]
          : k < 2 * NUM_BINS ? (unsigned long long)(long long)sbin_sum[bin]
                             : ((unsigned long long)sbin_sq[1][bin] << SQ_LO_BITS) +
                                   sbin_sq[0][bin];
    }
    if (v) atomicAdd(&o[i], v);
  }
}

template <int LAG, bool AUX>
int launch_self_stats(const void* q, const void* den, const void* blocks, const void* lsum,
                      void* out, int B, int H, int W, int HB, int WB, int bit_depth,
                      cudaStream_t stream) {
  using S = SelfShape<LAG, AUX>;
  auto kernel = self_stats_kernel<LAG, AUX>;
  cudaError_t err;
  if (S::SMEM > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::SMEM)) != cudaSuccess)
    return (int)err;
  const dim3 grid(max(1, (WB * FB + ST_TW - 1) / ST_TW), max(1, (HB * FB + S::TR - 1) / S::TR),
                  B);
  const bool wide = W % 4 == 0 && ((uintptr_t)q | (uintptr_t)lsum) % 16 == 0 &&
                    (uintptr_t)den % 8 == 0;
  kernel<<<grid, ST_THREADS, S::SMEM, stream>>>(
      (const int*)q, (const int16_t*)den, (const uint8_t*)blocks, (const int*)lsum,
      (unsigned long long*)out, H, W, HB, WB, bit_depth - 6, wide);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (B, H, W) int16 (u8 = 0) or uint8 (u8 = 1) plane -> den (B, H, W) int16
// and q (B, H, W) int32.
int estimate_self_blur(const void* f, int u8, void* den, void* q, int B, int H, int W,
                       int bit_depth, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (H + BL_TR - 1) / BL_TR > 65535 ||
      bit_depth < 8 || bit_depth > 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return u8 ? launch_blur<uint8_t>(f, den, q, B, H, W, bit_depth, st)
            : launch_blur<int16_t>(f, den, q, B, H, W, bit_depth, st);
}

// Per-frame int64 sums into a zeroed (B, SelfShape::OUT_LEN) buffer: q and
// lsum (B, H, W) int32, lsum null for luma; den (B, H, W) int16; blocks
// (B, HB, WB) uint8. n_pool: the luma samples a chroma sample pools (1 for
// luma). Refuses a frame whose int64 sums could overflow at this depth and
// pool.
int estimate_self_stats(const void* q, const void* den, const void* blocks, const void* lsum,
                        void* out, int B, int H, int W, int HB, int WB, int lag, int n_pool,
                        int bit_depth, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || bit_depth < 8 || bit_depth > MAX_BIT_DEPTH ||
      n_pool < 1 || n_pool > MAX_POOL || (lsum == nullptr && n_pool != 1))
    return (int)cudaErrorInvalidValue;
  const long long max_q = (long long)AREA * ((1LL << bit_depth) - 1);
  const long long max_design = (lsum ? n_pool : 1) * max_q;
  if ((long long)H * W > 9223372036854775807LL / (max_design * max_design))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SELF_STATS(L)                                                                      \
  return lsum ? launch_self_stats<L, true>(q, den, blocks, lsum, out, B, H, W, HB, WB,     \
                                           bit_depth, st)                                  \
              : launch_self_stats<L, false>(q, den, blocks, lsum, out, B, H, W, HB, WB,    \
                                            bit_depth, st)
  switch (lag) {
    case 0: SELF_STATS(0);
    case 1: SELF_STATS(1);
    case 2: SELF_STATS(2);
    case 3: SELF_STATS(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SELF_STATS
}

}  // extern "C"
