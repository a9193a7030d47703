// The diff path's statistics on Hopper (sm_90a): the flat-block activity
// kernel and the lag-window statistics kernel, bound to Python through a
// plain C interface (ctypes; see grav1synth_tpu_torch/_build.py).
//
// flat_block_activity_kernel replaces grav1synth_tpu/ops/diff_pallas.py:
// _act_kernel (plus the column pooling that pallas_flat_blocks left to
// XLA): it writes each full 16x16 block's sum of |d[i,j+1]-d[i,j]|
// (j < W-1) + |d[i+1,j]-d[i,j]| (i < H-1) directly.
//
// plane_stats_kernel replaces diff_pallas.py: _stats_kernel in its
// block-mask mode (pallas_plane_stats(..., mask_blocks=16)). Per frame it
// forms r = s - d, masks each pixel by its flat block (zero past the last
// full block row or column) and by the interior band lag <= i < H-lag,
// lag <= j < W-lag, and sums every product of two design values: r
// shifted by each causal lag offset ((0,0) first) and, for chroma, the x4
// luma-residual aux column. It also sums the 64-bin moments (count, r,
// r^2) of flat pixels binned on d >> (bit_depth - 6), with no interior
// test. Bins outside 0..63 (values above the bit depth) are dropped, as
// the Pallas kernel's 8x8 one-hot drops them.
//
// Both kernels are exact. Every product is an int32 (|r| <= 4095, aux <=
// 16380) and every sum is carried in int64: per-thread registers, then
// one shared-memory int64 atomic per warp, then one global int64 atomic
// (two's complement in unsigned long long) per output and CTA. The host
// unpacks the int64 sums to float64.
//
// What bounds them on this card. The activity kernel moves bytes: one
// read of the int16 plane. The stats kernel is bound by issue: at lag 2
// a luma pixel has 13 design values and 91 pair products, at lag 3 with
// aux 26 values and 351 products, while it reads 4-6 bytes. What the
// design does about it: a CTA stages a 64 x 128 tile of r, with lag halo
// rows above and lag halo columns on both sides, in shared memory, so the
// shifted reads are plain shared loads; one thread owns one tile column,
// and the pair products run in passes of PAIR_CHUNK pairs, so a thread
// holds PAIR_CHUNK int64 sums and at most one pass's design values in
// registers instead of every pair. A thread's column crosses its flat
// blocks whole, so the flat test is per 16-row segment and the interior
// test a row range: the inner loop has no per-pixel mask. Tiles without
// a flat block leave after the block map is read. Tensor-core Gram
// products (wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FB = 16;  // flat block edge
constexpr int NUM_BINS = 64;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// Flat-block activity

constexpr int ACT_BLOCKS = 16;                 // blocks per CTA along x
constexpr int ACT_THREADS = ACT_BLOCKS * FB;   // one thread per column

// Grid (ceil(WB / ACT_BLOCKS), HB, B): one CTA per block row and 256
// columns. The CTA stages its 16 rows and the row below (the halo), plus
// one column to the right, then each thread sums its column and the 16
// columns of a block are summed over their half-warp.
__global__ void __launch_bounds__(ACT_THREADS)
flat_block_activity_kernel(const int16_t* __restrict__ d, int* __restrict__ out,
                           int H, int W, int HB, int WB) {
  constexpr int TW = ACT_THREADS + 1;
  __shared__ int16_t tile[FB + 1][TW];
  const int b = blockIdx.z, by = blockIdx.y, bx0 = blockIdx.x * ACT_BLOCKS;
  const int y0 = by * FB, x0 = bx0 * FB;
  const int16_t* frame = d + (int64_t)b * H * W;
  for (int i = threadIdx.x; i < (FB + 1) * TW; i += ACT_THREADS) {
    const int r = i / TW, c = i - r * TW;
    const int y = y0 + r, x = x0 + c;
    tile[r][c] = (y < H && x < W) ? frame[(int64_t)y * W + x] : (int16_t)0;
  }
  __syncthreads();
  const int c = threadIdx.x, x = x0 + c;
  int sum = 0;
  if (x < WB * FB) {  // rows y0..y0+15 are inside the HB full block rows
    const bool right = x + 1 < W;
#pragma unroll
    for (int r = 0; r < FB; ++r) {
      const int v = tile[r][c];
      if (right) sum += abs(tile[r][c + 1] - v);
      if (y0 + r + 1 < H) sum += abs(tile[r + 1][c] - v);
    }
  }
  // lanes 0-15 and 16-31 of a warp are one block each
#pragma unroll
  for (int o = FB / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  const int bx = bx0 + c / FB;
  if (c % FB == 0 && bx < WB) out[((int64_t)b * HB + by) * WB + bx] = sum;
}

// ---------------------------------------------------------------------------
// Lag-window statistics

constexpr int ST_TW = 128;           // tile columns, one thread each
constexpr int ST_TR = 64;            // tile rows: four block rows
constexpr int ST_THREADS = ST_TW;
constexpr int ST_SEGS = ST_TR / FB;  // block rows in a tile
constexpr int ST_BX = ST_TW / FB;    // block columns in a tile
constexpr int PAIR_CHUNK = 32;       // int64 pair sums a thread holds

// Design value k: offset (0,0) for k = 0, then the causal window in the
// order of diff_pallas._offsets (rows -lag..0, columns -lag..lag, up to
// but not including (0,0)).
template <int LAG>
__host__ __device__ constexpr int off_dr(int k) {
  return k == 0 ? 0 : -LAG + (k - 1) / (2 * LAG + 1);
}
template <int LAG>
__host__ __device__ constexpr int off_dc(int k) {
  return k == 0 ? 0 : -LAG + (k - 1) % (2 * LAG + 1);
}

template <int LAG, bool AUX>
struct StatsShape {
  static constexpr int K = 2 * LAG * LAG + 2 * LAG + 1;  // shifted copies of r
  static constexpr int NP = K + (AUX ? 1 : 0);           // design values
  static constexpr int NPAIR = NP * (NP + 1) / 2;        // upper triangle
  // per-frame output: pair sums (row-major, i <= j), n_ar, then the bin
  // counts, sums and sums of squares
  static constexpr int OUT_LEN = NPAIR + 1 + 3 * NUM_BINS;
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One pass over this thread's Gram rows for pairs P0 .. P0+PAIR_CHUNK-1 of
// the upper triangle (row-major, i <= j), then the next pass. A template
// per pass, so that every pair index, and with it every accumulator and
// design value, is a compile-time constant that stays in a register.
template <int LAG, bool AUX, int P0>
__device__ __forceinline__ void gram_pass(const int16_t (*sr)[ST_TW + 2 * LAG],
                                          const int16_t (*saux)[ST_TW],
                                          unsigned long long* sacc, int c, int lane,
                                          int seg_mask, int row_lo, int row_hi) {
  using S = StatsShape<LAG, AUX>;
  constexpr int K = S::K, NP = S::NP, NPAIR = S::NPAIR;
  long long acc[PAIR_CHUNK];
#pragma unroll
  for (int q = 0; q < PAIR_CHUNK; ++q) acc[q] = 0;
  for (int seg = 0; seg < ST_SEGS; ++seg) {
    if (!((seg_mask >> seg) & 1)) continue;
    const int lo = max(seg * FB, row_lo), hi = min(seg * FB + FB, row_hi);
    for (int rr = lo; rr < hi; ++rr) {
      int v[NP];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = sr[rr + LAG + off_dr<LAG>(k)][c + LAG + off_dc<LAG>(k)];
      if constexpr (AUX) v[NP - 1] = saux[rr][c];
      int q = 0;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int j = i; j < NP; ++j, ++q) {
          if (q >= P0 && q < P0 + PAIR_CHUNK) acc[q - P0] += (long long)(v[i] * v[j]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PAIR_CHUNK; ++q) {
    if (P0 + q < NPAIR) {
      const long long a = warp_sum(acc[q]);
      if (lane == 0 && a) atomicAdd(&sacc[P0 + q], (unsigned long long)a);
    }
  }
  if constexpr (P0 + PAIR_CHUNK < NPAIR)
    gram_pass<LAG, AUX, P0 + PAIR_CHUNK>(sr, saux, sacc, c, lane, seg_mask, row_lo,
                                         row_hi);
}

// Grid (max(1, ceil(WB*16 / 128)), max(1, ceil(HB*16 / 64)), B). Only
// pixels inside the full blocks can be flat, so the grid covers that
// area; it is never empty, so a plane with no full block still launches
// and adds nothing to its zeroed outputs.
template <int LAG, bool AUX>
__global__ void __launch_bounds__(ST_THREADS)
plane_stats_kernel(const int16_t* __restrict__ s, const int16_t* __restrict__ d,
                   const uint8_t* __restrict__ blocks, const int16_t* __restrict__ aux,
                   unsigned long long* __restrict__ out, int H, int W, int HB,
                   int WB, int bin_shift) {
  using S = StatsShape<LAG, AUX>;
  constexpr int NPAIR = S::NPAIR, OUT_LEN = S::OUT_LEN;
  constexpr int SW = ST_TW + 2 * LAG;
  __shared__ int16_t sr[ST_TR + LAG][SW];  // r at rows y0-LAG.., cols x0-LAG..
  __shared__ int16_t saux[AUX ? ST_TR : 1][ST_TW];
  __shared__ unsigned long long sacc[OUT_LEN];
  __shared__ uint8_t sflat[ST_SEGS][ST_BX];

  const int b = blockIdx.z, y0 = blockIdx.y * ST_TR, x0 = blockIdx.x * ST_TW;
  const int t = threadIdx.x, lane = t & 31;
  const int64_t fo = (int64_t)b * H * W;

  int f = 0;
  if (t < ST_SEGS * ST_BX) {
    const int by = y0 / FB + t / ST_BX, bx = x0 / FB + t % ST_BX;
    if (by < HB && bx < WB) f = blocks[((int64_t)b * HB + by) * WB + bx] != 0;
    sflat[t / ST_BX][t % ST_BX] = (uint8_t)f;
  }
  for (int i = t; i < OUT_LEN; i += ST_THREADS) sacc[i] = 0ull;
  if (!__syncthreads_or(f)) return;  // no flat block: nothing to add

  for (int i = t; i < (ST_TR + LAG) * SW; i += ST_THREADS) {
    const int r = i / SW, c = i - r * SW;
    const int y = y0 - LAG + r, x = x0 - LAG + c;
    int v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int64_t o = fo + (int64_t)y * W + x;
      v = s[o] - d[o];
    }
    sr[r][c] = (int16_t)v;
  }
  if constexpr (AUX) {
    for (int i = t; i < ST_TR * ST_TW; i += ST_THREADS) {
      const int r = i / ST_TW, c = i - r * ST_TW;
      const int y = y0 + r, x = x0 + c;
      saux[r][c] = (y < H && x < W) ? aux[fo + (int64_t)y * W + x] : (int16_t)0;
    }
  }
  __syncthreads();

  const int c = t, x = x0 + c;

  // 64-bin moments over this column's flat rows, summed in runs of equal
  // bins so that smooth areas cost few shared atomics
  {
    int cur = -1, cnt = 0, sum = 0;
    unsigned sq = 0;  // <= 64 * 4095^2
    auto flush = [&]() {
      if (cnt > 0 && cur >= 0 && cur < NUM_BINS) {
        atomicAdd(&sacc[NPAIR + 1 + cur], (unsigned long long)cnt);
        atomicAdd(&sacc[NPAIR + 1 + NUM_BINS + cur],
                  (unsigned long long)(long long)sum);
        atomicAdd(&sacc[NPAIR + 1 + 2 * NUM_BINS + cur], (unsigned long long)sq);
      }
    };
    for (int seg = 0; seg < ST_SEGS; ++seg) {
      if (!sflat[seg][c / FB]) continue;
      for (int rr = seg * FB; rr < seg * FB + FB; ++rr) {
        const int bin = d[fo + (int64_t)(y0 + rr) * W + x] >> bin_shift;
        const int v = sr[rr + LAG][c + LAG];
        if (bin != cur) {
          flush();
          cur = bin;
          cnt = sum = 0;
          sq = 0;
        }
        ++cnt;
        sum += v;
        sq += (unsigned)(v * v);
      }
    }
    flush();
  }

  // the rows of this column that enter the Gram: flat segments (a bit
  // each), cut to the interior band
  const bool col_in = x >= LAG && x < W - LAG;
  const int row_lo = LAG - y0, row_hi = H - LAG - y0;
  int seg_mask = 0;
  long long n_ar = 0;
  for (int seg = 0; seg < ST_SEGS; ++seg) {
    if (col_in && sflat[seg][c / FB]) {
      seg_mask |= 1 << seg;
      n_ar += max(min(seg * FB + FB, row_hi) - max(seg * FB, row_lo), 0);
    }
  }
  n_ar = warp_sum(n_ar);
  if (lane == 0 && n_ar) atomicAdd(&sacc[NPAIR], (unsigned long long)n_ar);

  gram_pass<LAG, AUX, 0>(sr, saux, sacc, c, lane, seg_mask, row_lo, row_hi);
  __syncthreads();

  unsigned long long* o = out + (int64_t)b * OUT_LEN;
  for (int i = t; i < OUT_LEN; i += ST_THREADS) {
    const unsigned long long v = sacc[i];
    if (v) atomicAdd(&o[i], v);
  }
}

template <int LAG, bool AUX>
int launch_stats(const void* s, const void* d, const void* blocks, const void* aux,
                 void* out, int B, int H, int W, int HB, int WB, int bit_depth,
                 cudaStream_t stream) {
  const dim3 grid(max(1, (WB * FB + ST_TW - 1) / ST_TW),
                  max(1, (HB * FB + ST_TR - 1) / ST_TR), B);
  plane_stats_kernel<LAG, AUX><<<grid, ST_THREADS, 0, stream>>>(
      (const int16_t*)s, (const int16_t*)d, (const uint8_t*)blocks,
      (const int16_t*)aux, (unsigned long long*)out, H, W, HB, WB, bit_depth - 6);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (B, H, W) int16 -> (B, H/16, W/16) int32 block sums.
int diff_flat_block_activity(const void* d, void* out, int B, int H, int W,
                             void* stream) {
  const int HB = H / FB, WB = W / FB;
  if (B < 1 || HB < 1 || WB < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((WB + ACT_BLOCKS - 1) / ACT_BLOCKS, HB, B);
  flat_block_activity_kernel<<<grid, ACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)d, (int*)out, H, W, HB, WB);
  return (int)cudaGetLastError();
}

// Per-frame int64 sums into a zeroed (B, StatsShape::OUT_LEN) buffer; aux
// may be null (luma). blocks is (B, HB, WB) uint8.
int diff_plane_stats(const void* s, const void* d, const void* blocks,
                     const void* aux, void* out, int B, int H, int W, int HB,
                     int WB, int lag, int bit_depth, void* stream) {
  if (B < 1 || H < 1 || W < 1 || bit_depth < 8 || bit_depth > 12)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define STATS(L)                                                                    \
  return aux ? launch_stats<L, true>(s, d, blocks, aux, out, B, H, W, HB, WB,       \
                                     bit_depth, st)                                 \
             : launch_stats<L, false>(s, d, blocks, aux, out, B, H, W, HB, WB,      \
                                      bit_depth, st)
  switch (lag) {
    case 1: STATS(1);
    case 2: STATS(2);
    case 3: STATS(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef STATS
}

}  // extern "C"
