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
// so K6's int32 runs (diff_kernels.cu) cannot be reused. The tensor cores
// add products of exact integers in float64 over at most 4096 pixels, which
// keeps every partial sum an integer below 2^53 in any order of summation
// (static_asserts below); each accumulator is converted exactly to int64
// (__double2ll_rn) and added over the CTA by 64-bit shared atomics, and the
// CTA's sums into the frame's int64 by one global atomic per sum. The C
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
// reads 6-10 bytes. The card's float64 peak, 67 TFLOP/s, is on its tensor
// cores, and only the m16n8k4/k8/k16 shapes reach it (m8n8k4 issues at half
// of it; chip_smoke.py's "[dmma]" line). The MMAs work on 8 x 8 blocks of
// the Gram, so they do more multiply-adds than the 91-105 a pixel needs:
// 256 at lag 0-2 (the blocks of two groups of 8 design values), 640 at lag
// 3 (325-351 needed). What the design does about it:
//
// - Persistent: one wave of resident CTAs (the occupancy API times the SM
//   count, at most one a tile) walks the 32 x 128 tiles in frame-major
//   order, CTA c taking tiles c, c + grid, ... A warp reads a candidate
//   tile's 2 x 8 block-map bytes, two candidates a ballot, and skips a tile
//   without a flat block before anything is staged; every warp finds the
//   same tile, so the search needs no barrier, and the search for the tile
//   after next is read before the Gram and looked at after it.
// - Staging by cp.async under the Gram: while a tile's Gram runs, the next
//   tile's q (int32, with its lag rows above and 4 columns on each side),
//   den and lsum land in shared memory, 16 bytes (den 8) a copy where rows
//   are aligned, with zeros outside the plane, 4 bytes (den by plain loads)
//   elsewhere. q is then converted to float64 once a sample (not once a
//   fragment: converting every fragment value cost more than the staged
//   float64's shared-memory bytes); den and lsum, which the bins and the
//   Gram read while the next copies land, have two buffers.
// - The Gram on the tensor cores (``tile_gram``): mma.sync m16n8k4 float64,
//   one register per group of 8 design values and 4 pixels serving as both
//   A = D^T and B = D, loaded straight from the float64 tile (the pooled
//   column from a row the warp converts); pixels outside the band and design
//   values past NP are zero. The 8 warps take the rows of every flat block
//   in turn. A warp's accumulators carry up to 4096 pixels (8 tiles) before
//   they go to the CTA's int64 pair sums: every partial sum stays an exact
//   integer (static_assert), and the compare-and-swap loops of the 64-bit
//   shared atomics run once in 8 tiles.
// - The bins: a thread owns one column of one block row and sums its masked
//   rows in runs of equal bins, each run added to the tile's bin by native
//   32-bit shared atomics (a 64-bit shared atomic is a compare-and-swap
//   loop, which neighbouring lanes ending runs of one bin together would
//   repeat in turn), after its Gram rows; after the tile they go to the
//   CTA's 64-bit sums.
// - The CTA's pair, n_ar and bin sums stay in shared memory over its tiles
//   of one frame and go to the frame's outputs by one global atomic each
//   when the frame changes and at the end.
//
// The Gram's 8 warps a CTA, two CTAs an SM (registers), are what holds it
// below the MMA rate: with 6 warps on the Gram and 2 on the bins beside it,
// the Gram took a third longer.

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

constexpr int ST_TW = 128;            // tile columns
constexpr int ST_TR = 2 * FB;         // tile rows: two block rows
constexpr int ST_BX = ST_TW / FB;     // block columns in a tile
constexpr int ST_SEGS = ST_TR / FB;   // block rows in a tile
constexpr int ST_THREADS = 256;       // a thread owns one column of one block row
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_HALO = 4;            // halo columns staged on each side (>= lag)
constexpr int ST_SW = ST_TW + 2 * ST_HALO;  // staged row stride, in samples
constexpr int MAX_LAG = 3;
static_assert(ST_HALO >= MAX_LAG, "the halo holds every lag");
static_assert(EDGE > MAX_LAG, "the band keeps every shifted read inside the plane");
static_assert(ST_THREADS == ST_TW * ST_SEGS, "a thread a column of a block row");
static_assert(ST_SEGS * ST_BX <= 16, "a tile's block map fits half a warp's ballot");
static_assert(ST_SW % 4 == 0 && ST_HALO % 4 == 0, "staged rows and tiles stay 16-byte aligned");

// The ranges the sums rest on (the C entry point refuses deeper samples
// and larger pools).
constexpr int MAX_BIT_DEPTH = 12;
constexpr long long MAX_Q = (long long)AREA * ((1LL << MAX_BIT_DEPTH) - 1);
constexpr int MAX_POOL = 4;
constexpr long long MAX_DESIGN = MAX_POOL * MAX_Q;  // lsum; q is smaller
constexpr long long EXACT_F64 = 1LL << 53;
// A warp's MMA accumulators sum at most ACC_PIXELS pixels before they are
// converted to int64: every product and every partial sum is then an integer
// below 2^53, exact in float64 in any order of summation (4096 x
// (4 x 81 x 4095)^2 < 2^53). A warp takes at most ST_TR * ST_TW / ST_WARPS
// pixels of a tile.
constexpr int ACC_PIXELS = 4096;
static_assert((long long)ACC_PIXELS * MAX_DESIGN * MAX_DESIGN < EXACT_F64,
              "a float64 sum of products leaves the exact integers");
static_assert(ST_TR * ST_TW / ST_WARPS <= ACC_PIXELS, "a warp's share of a tile fits");
// A tile's bin moments in 32-bit shared sums: the count and the sum of q
// in int32; the sum of q^2 as the sums of each run's low SQ_LO_BITS bits
// (at most one run a pixel) and of its high bits. After each tile they are
// added to the CTA's 64-bit sums, so these bounds hold for any number of
// tiles.
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
  static constexpr int G = NP <= 8 ? 1 : NP <= 16 ? 2 : 4;  // groups of 8 (tensor cores)
  // per-frame output: pair sums (row-major, i <= j), n_ar, then the bin
  // counts, sums and sums of squares
  static constexpr int OUT_LEN = NPAIR + 1 + 3 * NUM_BINS;
  // Shared memory, in 32-bit words: q as float64 at rows y0 - LAG ..
  // y0 + ST_TR - 1 and columns x0 - ST_HALO .. x0 + ST_TW + ST_HALO - 1
  // (converted once a tile); the staging of q (int32, the same layout) and
  // den (int16, the tile's pixels), one buffer; for chroma lsum (int32, the
  // tile's rows with q's row stride and column origin), two buffers, since
  // the Gram reads it while the next tile's copies land.
  static constexpr int QW = (ST_TR + LAG) * ST_SW;
  static constexpr int LW = AUX ? ST_TR * ST_SW : 0;
  static constexpr int DW = ST_TR * ST_TW / 2;
  // (then each warp's row of the pooled column and 16 zeros, as float64)
  static constexpr int AUXD = QW, ZEROD = AUXD + ST_WARPS * FB;  // in doubles
  static constexpr int F64 = 0, QI = 2 * (ZEROD + FB), DEN = QI + QW, LS = DEN + 2 * DW;
  static constexpr size_t SMEM = (size_t)(LS + 2 * LW) * sizeof(int);
  static_assert(QW % 4 == 0 && LW % 4 == 0 && DW % 4 == 0, "16-byte aligned parts");
};

// cp.async: ``bytes`` (4, 8 or 16) from global to shared memory, or zeros
// where ``valid`` is false (source size 0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// What a CTA needs to know of the plane.
struct Plane {
  const int* q;
  const int16_t* den;
  const uint8_t* blocks;
  const int* lsum;
  unsigned long long* out;
  int H, W, HB, WB, TX, TY, bin_shift;
  int ntiles;  // B * TY * TX, frame-major
  bool wide;   // rows of q, den and lsum start on 4-sample boundaries
};

// Lane l's flag in the search for a tile with a flat block: block (l & 15)
// of tile k + (l >> 4) * stride (bit by * ST_BX + bx of the tile's map), so
// that a ballot looks at two candidates' 2 x 8 block-map bytes at a time.
__device__ __forceinline__ bool candidate_flat(const Plane& p, int k, int stride, int lane) {
  const int kk = k + (lane >> 4) * stride, bit = lane & 15;
  if (kk >= p.ntiles || bit >= ST_SEGS * ST_BX) return false;
  const int per = p.TX * p.TY, b = kk / per, r = kk - b * per;
  const int by = (r / p.TX) * ST_SEGS + bit / ST_BX, bx = (r % p.TX) * ST_BX + bit % ST_BX;
  return by < p.HB && bx < p.WB && p.blocks[((int64_t)b * p.HB + by) * p.WB + bx] != 0;
}

// The first tile at or after ``k`` in steps of ``stride`` that holds a flat
// block, or p.ntiles; ``mask`` gets its block map. Every warp of the CTA
// finds the same tile without a barrier.
__device__ __forceinline__ int next_tile(const Plane& p, int k, int stride, int lane,
                                         unsigned& mask) {
  for (; k < p.ntiles; k += 2 * stride) {
    const unsigned m = __ballot_sync(FULL, candidate_flat(p, k, stride, lane));
    if (m & 0xffffu) {
      mask = m & 0xffffu;
      return k;
    }
    if (m >> 16) {
      mask = m >> 16;
      return k + stride;
    }
  }
  mask = 0;
  return p.ntiles;
}

// Issues the copies of tile ``k`` into ``sq``, ``sd`` and ``sl`` (one cp.async group is
// committed by the caller): 16-byte copies of q and lsum and 8-byte copies
// of den where rows are aligned, 4-byte ones of q and lsum and plain loads
// of den elsewhere; zeros outside the plane.
template <int LAG, bool AUX>
__device__ __forceinline__ void stage_tile(const Plane& p, int k, int* sq, int16_t* sd, int* sl,
                                           int t) {
  const int per = p.TX * p.TY, b = k / per, r = k - b * per;
  const int y0 = (r / p.TX) * ST_TR, x0 = (r % p.TX) * ST_TW;
  const int64_t fo = (int64_t)b * p.H * p.W;
  if (p.wide) {
    constexpr int QCH = ST_SW / 4, CH = ST_TW / 4;
    for (int i = t; i < (ST_TR + LAG) * QCH; i += ST_THREADS) {
      const int rr = i / QCH, c = 4 * (i - rr * QCH);
      const int y = y0 - LAG + rr, x = x0 - ST_HALO + c;
      const bool ok = y >= 0 && y < p.H && x >= 0 && x < p.W;
      cp_async<16>(sq + rr * ST_SW + c, ok ? p.q + fo + (int64_t)y * p.W + x : p.q, ok);
    }
    for (int i = t; i < ST_TR * CH; i += ST_THREADS) {
      const int rr = i / CH, c = 4 * (i - rr * CH);
      const int y = y0 + rr, x = x0 + c;
      const bool ok = y < p.H && x < p.W;
      const int64_t o = ok ? fo + (int64_t)y * p.W + x : 0;
      cp_async<8>(sd + rr * ST_TW + c, p.den + o, ok);
      if constexpr (AUX) cp_async<16>(sl + rr * ST_SW + ST_HALO + c, p.lsum + o, ok);
    }
  } else {
    for (int i = t; i < (ST_TR + LAG) * ST_SW; i += ST_THREADS) {
      const int rr = i / ST_SW, c = i - rr * ST_SW;
      const int y = y0 - LAG + rr, x = x0 - ST_HALO + c;
      const bool ok = y >= 0 && y < p.H && x >= 0 && x < p.W;
      cp_async<4>(sq + i, ok ? p.q + fo + (int64_t)y * p.W + x : p.q, ok);
    }
    for (int i = t; i < ST_TR * ST_TW; i += ST_THREADS) {
      const int rr = i / ST_TW, c = i - rr * ST_TW;
      const int y = y0 + rr, x = x0 + c;
      const bool ok = y < p.H && x < p.W;
      const int64_t o = ok ? fo + (int64_t)y * p.W + x : 0;
      sd[i] = ok ? p.den[o] : (int16_t)0;
      if constexpr (AUX) cp_async<4>(sl + rr * ST_SW + ST_HALO + c, p.lsum + o, ok);
    }
  }
}

// The Gram on the float64 tensor cores (mma.sync m16n8k4; Hopper's float64
// shapes m16n8k4/k8/k16 issue at the card's 67 TFLOP/s, m8n8k4 at half of
// it: chip_smoke.py's [dmma] line; k8 and k16 took 1-3% longer here). D is
// the (pixels x design) matrix of a tile's masked pixels, A = D^T and B = D.
// Lane l = 4 gid + tig holds A's rows gid and gid + 8 and B's column gid at
// k index tig, so with the design values in groups of 8 one register, x_g =
// D[pixel tig][8 g + gid], is both operands: one MMA sums the 8 x 8 blocks
// (a, h) and (a', h) of the Gram over 4 pixels with A = (x_a, x_a') and B =
// x_h. A block below the diagonal is the transpose of one above it, so the
// ten blocks g <= h of four groups take five MMAs, the three of two groups
// two.
__device__ __forceinline__ void mma_16x8x4(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The plan for G groups (1, 2 or 4): MMA m takes A = (x_top, x_bot) and
// B = x_b; its lower block is added only where take_bot. Two groups share
// one A, (x_1, x_0), so that no register is copied into a second pair: B =
// x_0 gives (1, 0) = (0, 1)^T and (0, 0), B = x_1 gives (1, 1) and (0, 1)
// again.
__host__ __device__ constexpr int plan_mmas(int g) { return g == 1 ? 1 : g == 2 ? 2 : 5; }
__host__ __device__ constexpr int plan_top(int g, int m) {
  return g == 4 ? (m == 4 ? 1 : m) : g == 2 ? 1 : 0;
}
__host__ __device__ constexpr int plan_bot(int g, int m) {
  return g == 4 ? (m == 0 ? 2 : m == 1 ? 3 : m == 2 ? 1 : m == 3 ? 2 : 3) : 0;
}
__host__ __device__ constexpr int plan_b(int g, int m) {
  return g == 4 ? (m == 4 ? 0 : m) : g == 2 ? m : 0;
}
__host__ __device__ constexpr bool plan_take_bot(int g, int m) {
  return g == 4 || (g == 2 && m == 0);
}

// A warp's MMA accumulators: the plan's NM 16 x 8 C fragments.
template <int LAG, bool AUX>
struct GramAcc {
  static constexpr int NM = plan_mmas(SelfShape<LAG, AUX>::G);
  double c[NM][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < NM; ++m) c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.0;
  }
};

// This warp's share of the tile's Gram: rows warp and warp + 8 of every flat
// block in ``mask``, each row 4 k-steps of 4 neighbouring pixels, added to
// the warp's accumulators. Design values past NP are zero, and so are
// pixels outside the band (in a block that the band cuts; elsewhere the
// fragments are plain loads). Lane (gid, tig)'s design value of group g at
// tile row rr and column c is s64[off[g] + rr * ST_SW + c] for q (bit g of
// qmask) and s64[off[g] + c - c0] otherwise: the pooled column from this
// warp's float64 row of it (``aux``, converted a row at a time), or zeros.
template <int LAG, bool AUX>
__device__ __forceinline__ void tile_gram(const int* __restrict__ sl,
                                          const double* __restrict__ s64, double* __restrict__ aux,
                                          GramAcc<LAG, AUX>& acc, unsigned mask, int y0,
                                          int x0, int H, int W, int warp, int lane,
                                          const int (&off)[SelfShape<LAG, AUX>::G], unsigned qmask) {
  constexpr int G = SelfShape<LAG, AUX>::G, NM = plan_mmas(G);
  const int tig = lane & 3;
  // one row of the block at tile column c0; ``cut``: the band cuts its columns
  auto row = [&](int rr, int c0, bool cut) {
    if constexpr (AUX) {
      __syncwarp();  // the last row's fragments are read
      if (lane < FB) aux[lane] = (double)sl[rr * ST_SW + ST_HALO + c0 + lane];
      __syncwarp();
    }
    const int rowoff = rr * ST_SW + c0;
    int at[G];
#pragma unroll
    for (int g = 0; g < G; ++g) at[g] = off[g] + ((qmask >> g) & 1 ? rowoff : 0) + tig;
#pragma unroll
    for (int s = 0; s < FB / 4; ++s) {
      const int xx = x0 + c0 + 4 * s + tig;
      const bool in = !cut || (xx >= EDGE && xx < W - EDGE);
      double x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double v = s64[at[g] + 4 * s];
        x[g] = in ? v : 0.0;
      }
#pragma unroll
      for (int m = 0; m < NM; ++m)
        mma_16x8x4(acc.c[m], x[plan_top(G, m)], x[plan_bot(G, m)], x[plan_b(G, m)]);
    }
  };
  for (unsigned mm = mask; mm; mm &= mm - 1) {
    const int blk = __ffs(mm) - 1, by = blk / ST_BX, c0 = (blk % ST_BX) * FB;
    const bool cut = x0 + c0 < EDGE || x0 + c0 + FB > W - EDGE;
#pragma unroll
    for (int k = 0; k < FB / ST_WARPS; ++k) {
      const int rr = by * FB + warp + k * ST_WARPS, y = y0 + rr;
      if (y < EDGE || y >= H - EDGE) continue;  // the same for the whole warp
      if (cut)
        row(rr, c0, true);
      else
        row(rr, c0, false);
    }
  }
}

// The warp's accumulators into the CTA's int64 pair sums, and zeroed: C's rows
// gid (c0, c1) and gid + 8 (c2, c3), columns 2 tig and 2 tig + 1, are block
// (a, h)'s element (8 a + row, 8 h + column), the pair of its lower and
// higher index; a diagonal block gives its upper half. Each pair comes from
// one lane.
template <int LAG, bool AUX>
__device__ __forceinline__ void gram_to_shared(GramAcc<LAG, AUX>& acc, unsigned long long* spair,
                                               int lane) {
  using S = SelfShape<LAG, AUX>;
  constexpr int NP = S::NP, G = S::G, NM = plan_mmas(G);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= 2 && !plan_take_bot(G, m)) continue;
      const int a = i < 2 ? plan_top(G, m) : plan_bot(G, m), h = plan_b(G, m);
      const int r = 8 * a + gid, c = 8 * h + 2 * tig + (i & 1);
      const int lo = min(r, c), hi = max(r, c);
      if (hi >= NP || (a == h && r > c)) continue;
      const long long v = __double2ll_rn(acc.c[m][i]);
      if (v) atomicAdd(&spair[lo * NP - lo * (lo - 1) / 2 + hi - lo], (unsigned long long)v);
    }
  }
  acc.zero();
}

// Persistent: CTA c takes tiles c, c + gridDim.x, ... of the frame-major
// tile order, skipping those without a flat block. A tile's int32 q, den
// and lsum land by cp.async while the last tile's Gram runs; then q is
// converted to float64, the next tile's copies are issued, and this tile's
// Gram and bins run. The pair sums, n_ar and the bin sums stay in shared
// memory over the CTA's tiles of one frame, and go to the frame's outputs by
// one global atomic each when the frame changes and at the end. Dynamic
// shared memory: SelfShape::SMEM.
template <int LAG, bool AUX>
__global__ void __launch_bounds__(ST_THREADS, 2)
self_stats_kernel(Plane p) {
  using S = SelfShape<LAG, AUX>;
  constexpr int NPAIR = S::NPAIR, OUT_LEN = S::OUT_LEN;
  extern __shared__ __align__(16) int smem[];
  double* s64 = reinterpret_cast<double*>(smem + S::F64);
  int* sq = smem + S::QI;
  int16_t* sd = reinterpret_cast<int16_t*>(smem + S::DEN);
  __shared__ unsigned long long spair[NPAIR];
  __shared__ unsigned long long sn_ar;
  __shared__ int sn_tile;
  // per bin and tile: the count, the sum of q, and the sum of q^2 as the sums
  // of its runs' low SQ_LO_BITS bits and of their high bits; then the CTA's
  // 64-bit sums over the frame
  __shared__ int sbin_cnt[NUM_BINS], sbin_sum[NUM_BINS];
  __shared__ unsigned sbin_sq[2][NUM_BINS];
  __shared__ long long sbin64[3][NUM_BINS];

  const int t = threadIdx.x, lane = t & 31, warp = t / 32, stride = gridDim.x;
  double* saux = s64 + S::AUXD + warp * FB;  // this warp's row of the pooled column
  // where this lane's design value of each group (8 g + lane / 4) lies
  int off[S::G];
  unsigned qmask = 0;
#pragma unroll
  for (int g = 0; g < S::G; ++g) {
    const int d = 8 * g + lane / 4;
    if (d < S::K) qmask |= 1u << g;
    off[g] = d < S::K ? (LAG + off_dr<LAG>(d)) * ST_SW + ST_HALO + off_dc<LAG>(d)
                      : AUX && d == S::K ? S::AUXD + warp * FB : S::ZEROD;
  }
  GramAcc<LAG, AUX> acc;
  acc.zero();
  int acc_px = 0;  // pixels a warp's accumulators may hold, at most
  unsigned mask;
  int cur = next_tile(p, blockIdx.x, stride, lane, mask);
  if (cur >= p.ntiles) return;
  for (int i = t; i < NPAIR; i += ST_THREADS) spair[i] = 0ull;
  if (t < NUM_BINS) {
    sbin_cnt[t] = sbin_sum[t] = 0;
    sbin_sq[0][t] = sbin_sq[1][t] = 0u;
    sbin64[0][t] = sbin64[1][t] = sbin64[2][t] = 0;
  }
  if (t < FB) s64[S::ZEROD + t] = 0.0;
  if (t == 0) sn_ar = 0ull, sn_tile = 0;
  stage_tile<LAG, AUX>(p, cur, sq, sd, smem + S::LS, t);
  cp_async_commit();
  unsigned next_mask;
  int nxt = next_tile(p, cur + stride, stride, lane, next_mask);

  const int per = p.TX * p.TY;
  const int c = t % ST_TW, seg = t / ST_TW;
  for (int lb = 0; cur < p.ntiles; lb ^= 1) {
    cp_async_wait<0>();  // this tile's copies have landed
    __syncthreads();
    const int b = cur / per, r = cur - b * per;
    const int y0 = (r / p.TX) * ST_TR, x0 = (r % p.TX) * ST_TW;

    // q to float64, once a tile
    for (int i = t; i < S::QW / 4; i += ST_THREADS) {
      const int4 v = reinterpret_cast<const int4*>(sq)[i];
      double2* d = reinterpret_cast<double2*>(s64 + 4 * i);
      d[0] = make_double2(v.x, v.y);
      d[1] = make_double2(v.z, v.w);
    }
    // this thread's masked rows: its block-row segment if the block is flat
    // and the column in the band, cut to the band's rows
    const int x = x0 + c;
    int lo = max(max(seg * FB, EDGE - y0), 0), hi = min(seg * FB + FB, p.H - EDGE - y0);
    if (!((mask >> (seg * ST_BX + c / FB)) & 1) || x < EDGE || x >= p.W - EDGE) hi = lo;
    const int n = max(hi - lo, 0);
    const int wn = (int)warp_sum((long long)n);
    if (lane == 0 && wn) atomicAdd(&sn_tile, wn);

    __syncthreads();  // the float64 tile is whole; the int32 staging is free

    if (nxt < p.ntiles)
      stage_tile<LAG, AUX>(p, nxt, sq, sd + (lb ^ 1) * 2 * S::DW, smem + S::LS + (lb ^ 1) * S::LW,
                           t);
    cp_async_commit();
    // the search for the tile after next: its block-map bytes are read now
    // and looked at after the Gram
    const bool pre = nxt < p.ntiles && candidate_flat(p, nxt + stride, stride, lane);
    tile_gram<LAG, AUX>(smem + S::LS + lb * S::LW, s64, saux, acc, mask, y0, x0, p.H, p.W, warp,
                        lane, off, qmask);
    acc_px += ST_TR * ST_TW / ST_WARPS;  // a warp's rows of a tile
    // 64-bin moments over the masked rows, summed in runs of equal bins down
    // the column, each run added to the tile's bin by native 32-bit shared
    // atomics: neighbouring lanes often end runs of one bin together, and a
    // 64-bit shared atomic is a compare-and-swap loop that they would repeat
    // in turn. (Grouping each row's lanes by bin with __match_any_sync and
    // hardware reductions took 14% longer on the card.)
    {
      int run_bin = -1, cnt = 0, sum = 0;
      long long sq2 = 0;
      auto run_end = [&]() {
        if (cnt > 0 && run_bin >= 0 && run_bin < NUM_BINS) {
          atomicAdd(&sbin_cnt[run_bin], cnt);
          atomicAdd(&sbin_sum[run_bin], sum);
          atomicAdd(&sbin_sq[0][run_bin], (unsigned)(sq2 & SQ_LO_MASK));
          atomicAdd(&sbin_sq[1][run_bin], (unsigned)(sq2 >> SQ_LO_BITS));
        }
      };
      for (int rr = lo; rr < hi; ++rr) {
        const int bin = sd[lb * 2 * S::DW + rr * ST_TW + c] >> p.bin_shift;
        const int v = (int)s64[(rr + LAG) * ST_SW + ST_HALO + c];
        if (bin != run_bin) {
          run_end();
          run_bin = bin;
          cnt = sum = 0;
          sq2 = 0;
        }
        ++cnt;
        sum += v;
        sq2 += (long long)v * v;
      }
      run_end();
    }
    // the frame's last tile of this CTA
    const bool flush = nxt >= p.ntiles || nxt / per != b;
    if (flush || acc_px + ST_TR * ST_TW / ST_WARPS > ACC_PIXELS) {
      gram_to_shared<LAG, AUX>(acc, spair, lane);
      acc_px = 0;
    }
    unsigned nn_mask = 0;
    int nn = p.ntiles;
    if (nxt < p.ntiles) {
      const unsigned m = __ballot_sync(FULL, pre);
      if (m & 0xffffu)
        nn = nxt + stride, nn_mask = m & 0xffffu;
      else if (m >> 16)
        nn = nxt + 2 * stride, nn_mask = m >> 16;
      else
        nn = next_tile(p, nxt + 3 * stride, stride, lane, nn_mask);
    }
    __syncthreads();

    // the tile's bins into the CTA's 64-bit sums; at the frame's last tile
    // of this CTA, the CTA's sums into the frame's outputs
    unsigned long long* o = p.out + (int64_t)b * OUT_LEN;
    if (t < NUM_BINS) {
      sbin64[0][t] += sbin_cnt[t];
      sbin64[1][t] += sbin_sum[t];
      sbin64[2][t] += ((long long)sbin_sq[1][t] << SQ_LO_BITS) + sbin_sq[0][t];
      sbin_cnt[t] = sbin_sum[t] = 0;
      sbin_sq[0][t] = sbin_sq[1][t] = 0u;
      if (flush) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (sbin64[m][t])
            atomicAdd(&o[NPAIR + 1 + m * NUM_BINS + t], (unsigned long long)sbin64[m][t]);
          sbin64[m][t] = 0;
        }
      }
    }
    if (t == ST_THREADS - 1) {
      sn_ar += (unsigned long long)sn_tile;
      sn_tile = 0;
      if (flush) {
        if (sn_ar) atomicAdd(&o[NPAIR], sn_ar);
        sn_ar = 0ull;
      }
    }
    if (flush) {
      for (int i = t; i < NPAIR; i += ST_THREADS) {
        if (spair[i]) atomicAdd(&o[i], spair[i]);
        spair[i] = 0ull;
      }
    }
    cur = nxt;
    mask = next_mask;
    nxt = nn;
    next_mask = nn_mask;
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
  Plane p;
  p.q = (const int*)q;
  p.den = (const int16_t*)den;
  p.blocks = (const uint8_t*)blocks;
  p.lsum = (const int*)lsum;
  p.out = (unsigned long long*)out;
  p.H = H, p.W = W, p.HB = HB, p.WB = WB;
  p.TX = (WB + ST_BX - 1) / ST_BX;
  p.TY = (HB + ST_SEGS - 1) / ST_SEGS;
  p.bin_shift = bit_depth - 6;
  p.ntiles = B * p.TX * p.TY;
  p.wide = W % 4 == 0 && ((uintptr_t)q | (uintptr_t)lsum) % 16 == 0 && (uintptr_t)den % 8 == 0;
  // one wave of resident CTAs, at most one a tile
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ST_THREADS,
                                                           S::SMEM)) != cudaSuccess)
    return (int)err;
  const int grid = max(1, min(max(per_sm, 1) * sms, p.ntiles));
  kernel<<<grid, ST_THREADS, S::SMEM, stream>>>(p);
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
  // the tiles, frame-major, are counted in int
  if ((long long)B * ((HB + ST_SEGS - 1) / ST_SEGS) * ((WB + ST_BX - 1) / ST_BX) > (1LL << 30))
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
