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
// test. Bins outside 0..63 are dropped, as the Pallas kernel's 8x8 one-hot
// drops them.
//
// Both kernels are exact. The statistics kernel is exact on the inputs it
// is made for, which the caller must keep to and which nothing here checks:
// samples of s and d in [0, 2^bit_depth) with bit_depth <= 12, as a decoder
// gives them, so |r| <= 4095, and aux a sum of four such residuals, |aux|
// <= 16380. Then every product fits an int32, and so does a bounded run of
// them (the static_asserts under "Lag-window statistics" hold the bounds).
// Samples outside that range can overflow the 32-bit sums unseen. A thread adds its products in 32 bits over such a run; a CTA adds
// its threads' sums in shared memory, as 16-bit halves in int32 where that
// keeps the atomics native; and the sums leave the kernel as int64, by one
// global int64 atomic (two's complement in unsigned long long) per sum and
// CTA. The host unpacks the int64 sums to float64.
//
// What bounds them on this card. The activity kernel moves bytes: one
// read of the int16 plane. Beside it, a sample's two absolute steps are two
// instructions (VABSDIFF takes the difference, its absolute value and the
// add), and unpacking about one more. It streams, as the grain kernels do
// (grain_kernels.cu):
//
// - A lane owns 8 neighbouring columns, x = 0 mod 8, and moves a row of
//   them with one 16-byte streaming load. It walks down a strip of 64 rows
//   (four block rows), keeping the last row in registers, so a vertical
//   step needs no second read; the only halo is the row below the strip
//   (1.6% more bytes). Where 64-row strips would fill less than half of
//   what the card holds at once (1080p8 chroma), strips are 32 or 16 rows.
// - Each lane issues the loads of its next 8 rows before their arithmetic.
// - The horizontal step at column x + 7 takes sample x + 8 from the next
//   lane by one shuffle; the warp's last lane, and the last lane before the
//   right edge of the full blocks, load that sample themselves.
// - Columns x .. x + 7 lie in one 16-wide block, so a block is two
//   neighbouring lanes: after each 16 rows one shuffle adds the pair and
//   the even lane stores the block's int32 sum. No shared memory, no
//   atomics.
// - The grid is plain: one warp per (frame, strip, 256 columns), eight
//   warps a CTA, neighbouring warps on neighbouring columns. (A persistent
//   grid, each warp striding over the units, came within 3% of it either
//   way on the card.)
// - Edges need no branch in the arithmetic. The horizontal step of a full
//   block's last column reads column W - 1 again where it is the plane's
//   last (a zero step); the vertical step of the last full row reads its own
//   row again where it is the plane's last. Rows and columns past the full
//   blocks are read only for those steps. Rows that do not start on a
//   16-byte boundary (W % 8 != 0, or a base off the boundary) load sample
//   by sample.
// - Exact over all of int16: a step is at most 65535 and a block adds 512
//   of them, which an int32 holds.
//
// The stats kernel is bound by issue: at lag 2
// a luma pixel has 13 design values and 91 pair products, at lag 3 with
// aux 26 values and 351 products, while it reads 4-6 bytes: an int32
// multiply-add per pair and flat pixel is the least it can do. What the
// design does about it:
//
// - A CTA stages a 64 x 128 tile of r, with lag halo rows above and halo
//   columns on both sides, in shared memory, so the shifted reads are plain
//   shared loads. Where rows are 16-byte aligned the tile goes in as 16-byte
//   loads of s and d, eight residuals at a time; the bins of d are kept from
//   the same loads, so d is read from device memory once.
// - One thread owns one tile column. A thread's column crosses its flat
//   blocks whole, so the flat test is per 16-row segment and the interior
//   test a row range: the inner loop has no per-pixel mask, only one int32
//   multiply-add per pair into a register. Tiles without a flat block leave
//   after the block map is read.
// - At lag 1 and 2 every pair (at most 105) has its register, so a row's
//   design values are read from shared memory once. At lag 3 (325 or 351
//   pairs) the pairs go in four passes (PAIR_CHUNK).
// - Products of two residuals are added over the thread's whole column (at
//   most 64 rows) before they leave its registers: once a tile, by two
//   hardware warp reductions over the sum's 16-bit halves and two native
//   shared-memory atomics a warp (a 64-bit shared atomic is a
//   compare-and-swap loop; so the bin moments are 32-bit halves too, and
//   128 threads of a smooth tile can hit one bin). Products with the aux
//   column are larger, so a thread widens them into int64 registers after
//   every 16-row segment; aux times aux is added as unsigned.
//
// Tensor-core Gram products and a persistent grid over tiles are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FB = 16;  // flat block edge
constexpr int NUM_BINS = 64;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// Flat-block activity

constexpr int ACT_WARPS = 8;                  // warps of a CTA
constexpr int ACT_THREADS = ACT_WARPS * 32;
constexpr int ACT_GROUP = 8;                  // columns of a lane: 16 bytes
constexpr int ACT_SEG = 32 * ACT_GROUP;       // columns of a warp: 16 blocks
constexpr int ACT_STRIP = 4 * FB;             // rows of a warp: at most 4 block rows
constexpr int ACT_BATCH = 8;                  // rows loaded before their arithmetic
static_assert(FB % ACT_BATCH == 0, "a batch lies in one block row");
static_assert(2 * ACT_GROUP == FB, "a block is two lanes");
// a block's sum: 2 * FB * FB steps of at most 65535
static_assert(2LL * FB * FB * 65535 <= 2147483647LL, "a block's sum overflows int32");

// row[0 .. 7], one 16-byte streaming load where `wide`, else sample by
// sample, packed two to a word
__device__ __forceinline__ int4 act_load8(const int16_t* row, bool wide) {
  if (wide) return __ldcs(reinterpret_cast<const int4*>(row));
  unsigned w[ACT_GROUP / 2];
#pragma unroll
  for (int i = 0; i < ACT_GROUP / 2; ++i)
    w[i] = (unsigned)(uint16_t)__ldg(row + 2 * i) |
           ((unsigned)(uint16_t)__ldg(row + 2 * i + 1) << 16);
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

__device__ __forceinline__ void act_unpack(const int4 v, int (&s)[ACT_GROUP]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] = (int)(int16_t)(w[i] & 0xFFFF);  // low half, sign-extended
    s[2 * i + 1] = w[i] >> 16;                 // high half, arithmetic shift
  }
}

// Grid ceil(warps / ACT_WARPS) x 1: warp g is strip-column unit g of the
// B x NSTRIP x NSEG units (frame, strip of strip_rows = 16, 32 or 64 rows,
// 256 columns), columns fastest. wide: every row starts on a 16-byte
// boundary.
__global__ void __launch_bounds__(ACT_THREADS)
flat_block_activity_kernel(const int16_t* __restrict__ d, int* __restrict__ out, int H,
                           int W, int HB, int WB, int strip_rows, int NSTRIP, int NSEG,
                           int64_t warps, bool wide) {
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * ACT_WARPS + threadIdx.x / 32;
  if (g >= warps) return;  // a whole warp
  const int per_frame = NSTRIP * NSEG;
  const int b = (int)(g / per_frame), q = (int)(g - (int64_t)b * per_frame);
  const int strip = q / NSEG, seg = q - strip * NSEG;
  const int y0 = strip * strip_rows, rows = min(strip_rows, HB * FB - y0);
  const int x = seg * ACT_SEG + lane * ACT_GROUP;
  // `on`: this lane's columns lie in full blocks. `own`: the lane reads
  // sample x + 8 itself, as column xe (x + 8, or x + 7 again where x + 8
  // is past the plane: a zero step). Lanes that are not on take part in
  // the shuffles with zeros.
  const bool on = x < WB * FB;
  const bool own = on && (lane == 31 || x + ACT_GROUP == WB * FB);
  const int xe = min(x + ACT_GROUP, W - 1);
  const int16_t* frame = d + (int64_t)b * H * W;
  const int4 zero = make_int4(0, 0, 0, 0);

  int cur[ACT_GROUP], cur_e;  // row y0 + r0 + k: its 8 samples, sample xe
  {
    const int16_t* row = frame + (int64_t)y0 * W;
    act_unpack(on ? act_load8(row + x, wide) : zero, cur);
    cur_e = own ? __ldg(row + xe) : 0;
  }
  unsigned acc = 0;
  for (int r0 = 0; r0 < rows; r0 += ACT_BATCH) {
    // the next ACT_BATCH rows; the strip's last is the row below it, or
    // its own last row again at the plane's bottom (a zero vertical step)
    int4 nx[ACT_BATCH];
    int ne[ACT_BATCH];
#pragma unroll
    for (int k = 0; k < ACT_BATCH; ++k) {
      const int16_t* row = frame + (int64_t)min(y0 + r0 + k + 1, H - 1) * W;
      nx[k] = on ? act_load8(row + x, wide) : zero;
      ne[k] = own ? __ldg(row + xe) : 0;
    }
#pragma unroll
    for (int k = 0; k < ACT_BATCH; ++k) {
      int nv[ACT_GROUP];
      act_unpack(nx[k], nv);
      const int up = __shfl_down_sync(FULL, cur[0], 1);
      acc = __sad(own ? cur_e : up, cur[ACT_GROUP - 1], acc);
#pragma unroll
      for (int j = 0; j + 1 < ACT_GROUP; ++j) acc = __sad(cur[j + 1], cur[j], acc);
#pragma unroll
      for (int j = 0; j < ACT_GROUP; ++j) {
        acc = __sad(nv[j], cur[j], acc);
        cur[j] = nv[j];
      }
      cur_e = ne[k];
    }
    if ((r0 + ACT_BATCH) % FB == 0) {  // a block row is done
      const unsigned blk = acc + __shfl_xor_sync(FULL, acc, 1);
      if (on && !(lane & 1))
        __stcs(out + ((int64_t)b * HB + (y0 + r0) / FB) * WB + x / FB, (int)blk);
      acc = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Lag-window statistics

constexpr int ST_TW = 128;           // tile columns, one thread each
constexpr int ST_TR = 64;            // tile rows: four block rows
constexpr int ST_THREADS = ST_TW;
constexpr int ST_SEGS = ST_TR / FB;  // block rows in a tile
constexpr int ST_BX = ST_TW / FB;    // block columns in a tile
constexpr int ST_HALO = 8;           // halo columns staged on each side (>= lag)
constexpr int ST_SW = ST_TW + 2 * ST_HALO;  // staged columns, x0 - ST_HALO first
constexpr int ST_CTAS_PER_SM = 3;    // the register budget: 65536 / (3 * 128) a thread
constexpr int BIN_NONE = 255;        // a staged bin outside 0..NUM_BINS-1

// The ranges the 32-bit sums rest on. Samples are at most MAX_BIT_DEPTH bits
// (the C entry point refuses more), so a residual r = s - d has |r| <=
// MAX_RES; the aux column is a sum of four luma residuals.
constexpr int MAX_BIT_DEPTH = 12;
constexpr long long MAX_RES = (1LL << MAX_BIT_DEPTH) - 1;
constexpr long long MAX_AUX = 4 * MAX_RES;
// Rows a thread adds in 32 bits before it widens: a product of two
// residuals over its whole tile column; a product with the aux column over
// one 16-row segment.
constexpr int ROWS_PER_FLUSH_RES = ST_TR;
constexpr int ROWS_PER_FLUSH_AUX = FB;
constexpr long long INT32_LIMIT = 2147483647LL;
constexpr long long UINT32_LIMIT = 4294967295LL;
static_assert(ROWS_PER_FLUSH_RES * MAX_RES * MAX_RES <= INT32_LIMIT,
              "a column's sum of r * r products overflows int32");
static_assert(ROWS_PER_FLUSH_AUX * MAX_RES * MAX_AUX <= INT32_LIMIT,
              "a segment's sum of r * aux products overflows int32");
static_assert(ROWS_PER_FLUSH_AUX * MAX_AUX * MAX_AUX <= UINT32_LIMIT,
              "a segment's sum of aux * aux products overflows uint32");
// the bin moments of a column: r and r * r over ST_TR rows
static_assert(ST_TR * MAX_RES * MAX_RES <= UINT32_LIMIT, "a column's bin moments overflow");
// A CTA's sums in shared memory are int32 too, so that its atomics are the
// native 32-bit ones: a pair sum as the sums of its threads' 16-bit halves,
// a bin's count, its sum of r, and its sum of r * r as the sums of halves
// of at most one run per pixel.
static_assert(ST_THREADS * 65535LL <= INT32_LIMIT, "a CTA's sum of 16-bit halves overflows");
static_assert(ST_TR * ST_TW * MAX_RES <= INT32_LIMIT, "a tile's bin sum of r overflows int32");
static_assert(ST_TR * ST_TW * 65535LL <= UINT32_LIMIT, "a tile's bin sum of halves overflows");
static_assert(ST_HALO >= 3 && ST_HALO % 8 == 0, "the halo holds lag 3 and keeps 16-byte chunks");

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

// Adds the warp's int32 values a, exactly, to a CTA's sum kept as two
// int32: a = hi * 65536 + lo with 0 <= lo < 65536 and |hi| <= 32768, each
// half summed over the warp by one hardware reduction and added by lane 0
// with a native shared-memory atomic. The sum is halves[1] * 65536 +
// halves[0] (halves_sum).
__device__ __forceinline__ void add_halves(int (*halves)[2], int a, int lane) {
  const int slo = __reduce_add_sync(FULL, a & 0xffff);
  const int shi = __reduce_add_sync(FULL, a >> 16);
  if (lane == 0) {
    atomicAdd(&halves[0][0], slo);
    atomicAdd(&halves[0][1], shi);
  }
}

__device__ __forceinline__ long long halves_sum(const int (*halves)[2]) {
  return (long long)halves[0][1] * 65536 + halves[0][0];
}

// The int32 pair sums a thread holds in one pass: every pair at lag 1 and
// 2 (at most 105); at lag 3 a quarter of its 325 or 351, which with the 25
// or 26 design values stays inside the register budget.
template <int LAG>
constexpr int PAIR_CHUNK = LAG <= 2 ? 105 : 88;

// One pass over this thread's Gram rows for pairs P0 .. P0+CHUNK-1 of
// the upper triangle (row-major, i <= j), then the next pass. A template
// per pass, so that every pair index, and with it every accumulator and
// design value, is a compile-time constant that stays in a register.
// Pair (i, NP - 1) of a plane with aux is a product with the aux column:
// its 32-bit sum is widened into wide[i] after every segment, and goes to
// saux_sum[i]; every other pair q goes to spair[q] as halves.
template <int LAG, bool AUX, int P0>
__device__ __forceinline__ void gram_pass(const int16_t (*sr)[ST_SW],
                                          const int16_t (*saux)[ST_TW],
                                          int (*spair)[2], unsigned long long* saux_sum,
                                          int c, int lane, int seg_mask, int row_lo,
                                          int row_hi) {
  using S = StatsShape<LAG, AUX>;
  constexpr int K = S::K, NP = S::NP, NPAIR = S::NPAIR, CHUNK = PAIR_CHUNK<LAG>;
  int acc[CHUNK];
  long long wide[NP];
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) acc[q] = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) wide[i] = 0;
  for (int seg = 0; seg < ST_SEGS; ++seg) {
    if (!((seg_mask >> seg) & 1)) continue;
    const int lo = max(seg * FB, row_lo), hi = min(seg * FB + FB, row_hi);
    for (int rr = lo; rr < hi; ++rr) {
      int v[NP];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = sr[rr + LAG + off_dr<LAG>(k)][c + ST_HALO + off_dc<LAG>(k)];
      if constexpr (AUX) v[NP - 1] = saux[rr][c];
      int q = 0;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int j = i; j < NP; ++j, ++q) {
          if (q >= P0 && q < P0 + CHUNK) {
            if (AUX && i == NP - 1)  // aux * aux: non-negative, up to 2^32 a segment
              acc[q - P0] = (int)((unsigned)acc[q - P0] + (unsigned)(v[i] * v[j]));
            else
              acc[q - P0] += v[i] * v[j];
          }
        }
      }
    }
    if constexpr (AUX) {
      int q = 0;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        q += NP - 1 - i;  // pair (i, NP - 1)
        if (q >= P0 && q < P0 + CHUNK) {
          wide[i] += i == NP - 1 ? (long long)(unsigned)acc[q - P0] : (long long)acc[q - P0];
          acc[q - P0] = 0;
        }
        ++q;
      }
    }
  }
  int q = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = i; j < NP; ++j, ++q) {
      if (q >= P0 && q < P0 + CHUNK) {
        if (AUX && j == NP - 1) {
          const long long a = warp_sum(wide[i]);
          if (lane == 0 && a) atomicAdd(&saux_sum[i], (unsigned long long)a);
        } else {
          add_halves(spair + q, acc[q - P0], lane);
        }
      }
    }
  }
  if constexpr (P0 + CHUNK < NPAIR)
    gram_pass<LAG, AUX, P0 + CHUNK>(sr, saux, spair, saux_sum, c, lane, seg_mask, row_lo,
                                    row_hi);
}

__device__ __forceinline__ int staged_bin(int d, int bin_shift) {
  const int bin = d >> bin_shift;
  return bin >= 0 && bin < NUM_BINS ? bin : BIN_NONE;
}

// Grid (max(1, ceil(WB*16 / 128)), max(1, ceil(HB*16 / 64)), B). Only
// pixels inside the full blocks can be flat, so the grid covers that
// area; it is never empty, so a plane with no full block still launches
// and adds nothing to its zeroed outputs. wide: every row of s, d and aux
// starts on a 16-byte boundary (W % 8 == 0 and aligned bases).
template <int LAG, bool AUX>
__global__ void __launch_bounds__(ST_THREADS, ST_CTAS_PER_SM)
plane_stats_kernel(const int16_t* __restrict__ s, const int16_t* __restrict__ d,
                   const uint8_t* __restrict__ blocks, const int16_t* __restrict__ aux,
                   unsigned long long* __restrict__ out, int H, int W, int HB,
                   int WB, int bin_shift, bool wide) {
  using S = StatsShape<LAG, AUX>;
  constexpr int NP = S::NP, NPAIR = S::NPAIR, OUT_LEN = S::OUT_LEN;
  // r at rows y0-LAG.., columns x0-ST_HALO..
  __shared__ __align__(16) int16_t sr[ST_TR + LAG][ST_SW];
  __shared__ __align__(16) int16_t saux[AUX ? ST_TR : 1][ST_TW];
  __shared__ __align__(16) uint8_t sbin[ST_TR][ST_TW];  // staged_bin of d
  // the CTA's sums: pair sums as 16-bit halves (add_halves), the pairs with
  // the aux column (row i of the Gram) and n_ar as int64, and per bin the
  // count, the sum of r and the two halves of the sum of r * r
  __shared__ int spair[NPAIR][2];
  __shared__ unsigned long long swide[NP + 1];
  __shared__ int sbins[4][NUM_BINS];
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
  for (int i = t; i < NPAIR; i += ST_THREADS) spair[i][0] = spair[i][1] = 0;
  for (int i = t; i < 4 * NUM_BINS; i += ST_THREADS) sbins[i / NUM_BINS][i % NUM_BINS] = 0;
  if (t <= NP) swide[t] = 0ull;
  if (!__syncthreads_or(f)) return;  // no flat block: nothing to add

  if (wide) {
    // eight samples a load: chunk ch of a staged row covers columns
    // x0 - ST_HALO + 8 ch .., inside the plane whole or not at all
    constexpr int CHUNKS = ST_SW / 8;
    for (int i = t; i < (ST_TR + LAG) * CHUNKS; i += ST_THREADS) {
      const int r = i / CHUNKS, ch = i - r * CHUNKS;
      const int y = y0 - LAG + r, x = x0 - ST_HALO + 8 * ch;
      uint4 rv = make_uint4(0u, 0u, 0u, 0u);
      uint2 bins = make_uint2(0u, 0u);
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const int64_t o = fo + (int64_t)y * W + x;
        const uint4 sv = *reinterpret_cast<const uint4*>(s + o);
        const uint4 dv = *reinterpret_cast<const uint4*>(d + o);
        // two int16 differences a word, modulo 2^16 each like the int16 cast
        rv = make_uint4(__vsub2(sv.x, dv.x), __vsub2(sv.y, dv.y), __vsub2(sv.z, dv.z),
                        __vsub2(sv.w, dv.w));
        const unsigned w[4] = {dv.x, dv.y, dv.z, dv.w};
        unsigned packed[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dk = (int16_t)(w[k / 2] >> (16 * (k & 1)));
          packed[k / 4] |= (unsigned)staged_bin(dk, bin_shift) << (8 * (k & 3));
        }
        bins = make_uint2(packed[0], packed[1]);
      }
      *reinterpret_cast<uint4*>(&sr[r][8 * ch]) = rv;
      if (r >= LAG && ch >= ST_HALO / 8 && ch < CHUNKS - ST_HALO / 8)
        *reinterpret_cast<uint2*>(&sbin[r - LAG][8 * ch - ST_HALO]) = bins;
    }
    if constexpr (AUX) {
      constexpr int ACHUNKS = ST_TW / 8;
      for (int i = t; i < ST_TR * ACHUNKS; i += ST_THREADS) {
        const int r = i / ACHUNKS, ch = i - r * ACHUNKS;
        const int y = y0 + r, x = x0 + 8 * ch;
        uint4 av = make_uint4(0u, 0u, 0u, 0u);
        if (y < H && x < W) av = *reinterpret_cast<const uint4*>(aux + fo + (int64_t)y * W + x);
        *reinterpret_cast<uint4*>(&saux[r][8 * ch]) = av;
      }
    }
  } else {
    constexpr int SW = ST_TW + 2 * LAG;  // the columns the Gram reads
    for (int i = t; i < (ST_TR + LAG) * SW; i += ST_THREADS) {
      const int r = i / SW, c = i - r * SW;
      const int y = y0 - LAG + r, x = x0 - LAG + c;
      int v = 0, bin = BIN_NONE;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const int64_t o = fo + (int64_t)y * W + x;
        const int dv = d[o];
        v = s[o] - dv;
        bin = staged_bin(dv, bin_shift);
      }
      sr[r][c + ST_HALO - LAG] = (int16_t)v;
      if (r >= LAG && c >= LAG && c < LAG + ST_TW) sbin[r - LAG][c - LAG] = (uint8_t)bin;
    }
    if constexpr (AUX) {
      for (int i = t; i < ST_TR * ST_TW; i += ST_THREADS) {
        const int r = i / ST_TW, c = i - r * ST_TW;
        const int y = y0 + r, x = x0 + c;
        saux[r][c] = (y < H && x < W) ? aux[fo + (int64_t)y * W + x] : (int16_t)0;
      }
    }
  }
  __syncthreads();

  const int c = t, x = x0 + c;

  // 64-bin moments over this column's flat rows, summed in runs of equal
  // bins so that smooth areas cost few shared atomics
  {
    int cur = BIN_NONE, cnt = 0, sum = 0;
    unsigned sq = 0;  // <= ST_TR * MAX_RES^2
    auto flush = [&]() {
      if (cnt > 0 && cur != BIN_NONE) {
        atomicAdd(&sbins[0][cur], cnt);
        atomicAdd(&sbins[1][cur], sum);
        atomicAdd((unsigned*)&sbins[2][cur], sq & 0xffffu);
        atomicAdd((unsigned*)&sbins[3][cur], sq >> 16);
      }
    };
    for (int seg = 0; seg < ST_SEGS; ++seg) {
      if (!sflat[seg][c / FB]) continue;
      for (int rr = seg * FB; rr < seg * FB + FB; ++rr) {
        const int bin = sbin[rr][c];
        const int v = sr[rr + LAG][c + ST_HALO];
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
  if (lane == 0 && n_ar) atomicAdd(&swide[NP], (unsigned long long)n_ar);

  gram_pass<LAG, AUX, 0>(sr, saux, spair, swide, c, lane, seg_mask, row_lo, row_hi);
  __syncthreads();

  // the CTA's sums, widened, into the frame's: pair q = (i, j) of the upper
  // triangle, n_ar, then the bins' counts, sums and sums of squares
  unsigned long long* o = out + (int64_t)b * OUT_LEN;
  for (int i = t; i < OUT_LEN; i += ST_THREADS) {
    long long v;
    if (i < NPAIR) {
      v = halves_sum(spair + i);
      if constexpr (AUX) {
        // row r of the triangle ends with pair (r, NP - 1) at index
        // (r + 1) NP - r (r + 1) / 2 - 1
        for (int r = 0; r < NP; ++r)
          if (i == (r + 1) * NP - r * (r + 1) / 2 - 1) v = (long long)swide[r];
      }
    } else if (i == NPAIR) {
      v = (long long)swide[NP];
    } else {
      const int k = i - NPAIR - 1, bin = k % NUM_BINS;
      v = k < NUM_BINS       ? (long long)sbins[0][bin]
          : k < 2 * NUM_BINS ? (long long)sbins[1][bin]
                             : (long long)(unsigned)sbins[3][bin] * 65536 + (unsigned)sbins[2][bin];
    }
    if (v) atomicAdd(&o[i], (unsigned long long)v);
  }
}

template <int LAG, bool AUX>
int launch_stats(const void* s, const void* d, const void* blocks, const void* aux,
                 void* out, int B, int H, int W, int HB, int WB, int bit_depth,
                 cudaStream_t stream) {
  const dim3 grid(max(1, (WB * FB + ST_TW - 1) / ST_TW),
                  max(1, (HB * FB + ST_TR - 1) / ST_TR), B);
  const bool wide = W % 8 == 0 && ((uintptr_t)s | (uintptr_t)d | (uintptr_t)aux) % 16 == 0;
  plane_stats_kernel<LAG, AUX><<<grid, ST_THREADS, 0, stream>>>(
      (const int16_t*)s, (const int16_t*)d, (const uint8_t*)blocks, (const int16_t*)aux,
      (unsigned long long*)out, H, W, HB, WB, bit_depth - 6, wide);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (B, H, W) int16 -> (B, H/16, W/16) int32 block sums.
int diff_flat_block_activity(const void* d, void* out, int B, int H, int W,
                             void* stream) {
  const int HB = H / FB, WB = W / FB;
  if (B < 1 || HB < 1 || WB < 1) return (int)cudaErrorInvalidValue;
  // Strips of 64 rows (a halo of 1.6%) where they make at least half a
  // wave of the warps the card holds at once; shorter ones, down to one
  // block row, on small planes, so that enough warps keep loads in flight.
  cudaError_t err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flat_block_activity_kernel,
                                                           ACT_THREADS, 0)) != cudaSuccess)
    return (int)err;
  const int64_t resident = (int64_t)sms * per_sm * ACT_WARPS;
  const int NSEG = (WB * FB + ACT_SEG - 1) / ACT_SEG;
  int strip = ACT_STRIP;
  auto strips = [&](int rows) { return (HB * FB + rows - 1) / rows; };
  while (strip > FB && 2 * (int64_t)B * strips(strip) * NSEG < resident) strip /= 2;
  const int64_t warps = (int64_t)B * strips(strip) * NSEG;
  const int64_t ctas = (warps + ACT_WARPS - 1) / ACT_WARPS;
  if (ctas > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool wide = W % ACT_GROUP == 0 && (uintptr_t)d % 16 == 0;
  flat_block_activity_kernel<<<(unsigned)ctas, ACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)d, (int*)out, H, W, HB, WB, strip, strips(strip), NSEG, warps, wide);
  return (int)cudaGetLastError();
}

// Per-frame int64 sums into a zeroed (B, StatsShape::OUT_LEN) buffer; aux
// may be null (luma). blocks is (B, HB, WB) uint8.
int diff_plane_stats(const void* s, const void* d, const void* blocks,
                     const void* aux, void* out, int B, int H, int W, int HB,
                     int WB, int lag, int bit_depth, void* stream) {
  if (B < 1 || H < 1 || W < 1 || bit_depth < 8 || bit_depth > MAX_BIT_DEPTH)
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
