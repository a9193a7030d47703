// AV1 film grain application on Hopper (sm_90a): a luma kernel, a Cb+Cr
// chroma-pair kernel, a fused luma+Cb+Cr kernel and a single-chroma-plane
// kernel, bound to Python through a plain C interface (ctypes; see
// grav1synth_tpu_torch/_build.py).
//
// grain_luma_kernel replaces grav1synth_tpu/ops/grain_pallas.py:
// _luma_kernel (body _apply_groups); grain_chroma_pair_kernel replaces
// grain_pallas.py: _chroma_pair_kernel (body _apply_groups_pair);
// grain_fused_kernel replaces grain_pallas.py: _fused_kernel, the two
// bodies in one launch (see its own note below). grain_chroma_kernel
// replaces grain_pallas.py: _chroma_kernel (one chroma plane, its averaged
// luma read from an input).
//
// What bounds them on this card: bytes. A 3840x2160 4:2:0 frame moves
// about 50 MB of int16 samples in and out; a frame's patterns, scaling
// LUTs and block randoms are a few KB. The arithmetic per sample is about
// a dozen integer operations, below what the SMs can issue per byte of
// HBM traffic.
//
// The luma and chroma-pair kernels are persistent and vectorised:
//
// - Bytes in flight. Each thread owns 8 neighbouring samples of a row
//   and moves them with one 16-byte load and one 16-byte streaming store.
//   A thread issues the loads of all its rows of a work unit (4 luma rows;
//   2 or 4 chroma rows with their Cb, Cr and collocated luma) before any
//   arithmetic, so an SM with 1024 (luma) or 512 (chroma pair) threads
//   keeps 32-64 KB of loads outstanding.
// - Tables staged once per frame, not once per tile. The grid is a few
//   CTAs per SM; CTA i walks the contiguous range [U*i/G, U*(i+1)/G) of
//   the U = frames x stripes x 256-sample segments work units, so it meets
//   one or two frames. Only when the frame changes does it copy the
//   frame's pattern(s) into shared memory and expand the 256-node scaling
//   LUT(s) to one entry per sample value (1 << bit_depth int32), which
//   makes the scaling one shared-memory read per sample. The block
//   randoms are read per unit through the read-only cache.
// - A group of 8 samples at x = 0 mod 8 lies in one grain block (32 luma
//   or 32 >> sub_x chroma samples wide), so a group reads one pattern
//   window; only lanes 0-1 (lane 0 on a subsampled axis) of a block's
//   first group blend with the left block, and only the first 2 (1) rows
//   of a stripe with the stripe above. The pattern window starts at an
//   odd x, so the 8 pattern values are 8 two-byte shared-memory reads.
// - Edges. A row whose start is not 16-byte aligned (a width that is not
//   a multiple of 8, or a frame base that is not aligned), and the last
//   group of a row that ends inside it, load and store per sample; the
//   last stripe's rows and the last segment's columns are bounded.
//   Inactive planes are copied through.
//
// grain_chroma_kernel is the chroma-pair kernel's form for one plane: the
// same units, staging, loads and edges, with its averaged luma read as an
// input (16-byte loads where src, avg and out rows all start on a 16-byte
// boundary) and its stripes and blocks counted from the plane's size, while
// the randoms come from the caller's offsets, which may cover more. One
// plane's tables are half of the pair's, so four CTAs share an SM at 4:2:0
// (three where a unit has 4 rows a thread, which need the registers).
//
// Arithmetic is int32 throughout. Round2 of a negative value, the
// ">> 6" of the chroma combination and the overlap blends are arithmetic
// right shifts, exactly as the spec (and grain_ref) write them.
//
// The kernels never write their inputs: outputs are separate tensors, so
// the chroma-pair kernel reads ungrained luma whether it runs before or
// after the luma kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 32;       // luma block edge
constexpr int THREADS = 256;

// per-plane parameter row (grain_kernels.pack_plane_params)
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Scaling of a sample through the 8-bit node LUT; above 8 bits,
// a + (((b - a) * rem + pad/2) >> shift) between nodes, a at node 255.
__device__ __forceinline__ int scale_lookup(const int* lut, int v, int bit_depth) {
  v = clampi(v, 0, (1 << bit_depth) - 1);
  if (bit_depth == 8) return lut[v];
  const int shift = bit_depth - 8;
  const int idx = v >> shift;
  const int a = lut[idx];
  if (idx >= 255) return a;
  const int rem = v & ((1 << shift) - 1);
  return a + (((lut[idx + 1] - a) * rem + (1 << (shift - 1))) >> shift);
}

// Overlap weights (spec 7.18.3.5): 27/17 then 17/27 at full resolution,
// 23/22 on a subsampled axis. Blend = Round2(old*w_old + new*w_new, 5).
template <int SUB>
__device__ __forceinline__ int blend(int old_v, int new_v, int idx) {
  if (SUB) return (old_v * 23 + new_v * 22 + 16) >> 5;
  return idx == 0 ? (old_v * 27 + new_v * 17 + 16) >> 5
                  : (old_v * 17 + new_v * 27 + 16) >> 5;
}

// Pattern offset of a block from its 8-bit random (high nibble x, low y).
template <int SX>
__device__ __forceinline__ int off_x(int rd) { return 3 + (2 >> SX) * (3 + (rd >> 4)); }
template <int SY>
__device__ __forceinline__ int off_y(int rd) { return 3 + (2 >> SY) * (3 + (rd & 15)); }

__device__ __forceinline__ int grained(int src, int noise, int scale, int ss,
                                       int lo, int hi) {
  return clampi(src + ((scale * noise + (1 << (ss - 1))) >> ss), lo, hi);
}

// ---------------------------------------------------------------------------
// Persistent, vectorised luma and chroma-pair kernels

constexpr int GROUP = 8;                // samples per thread and row: 16 bytes
constexpr int TX = 32;                  // threads across a unit's row
constexpr int RPW = THREADS / TX;       // row phases of a CTA
constexpr int UNIT_W = TX * GROUP;      // samples across a unit

// The geometry of a plane's grain at subsampling (SX, SY).
template <int SX, int SY>
struct Geo {
  static constexpr int GW = SX ? 44 : 82, GH = SY ? 38 : 73;  // pattern
  static constexpr int BW = BLOCK >> SX, BH = BLOCK >> SY;    // block
  static constexpr int OVC = 2 >> SX, OVR = 2 >> SY;          // overlap
  // pattern bytes in shared memory, rounded up to 16
  static constexpr int PAT_BYTES = (GH * GW * 2 + 15) & ~15;
};

// Bytes of dynamic shared memory: `planes` patterns and expanded LUTs.
template <int SX, int SY>
size_t table_bytes(int planes, int bit_depth) {
  return (size_t)planes * (Geo<SX, SY>::PAT_BYTES + (sizeof(int) << bit_depth));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

__device__ __forceinline__ void unpack8(const int4 v, int (&s)[GROUP]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] = (int)(int16_t)(w[i] & 0xFFFF);  // low half, sign-extended
    s[2 * i + 1] = w[i] >> 16;                 // high half, arithmetic shift
  }
}

__device__ __forceinline__ int4 pack8(const int (&s)[GROUP]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = ((unsigned)s[2 * i] & 0xFFFFu) | ((unsigned)s[2 * i + 1] << 16);
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// The 8 samples row[x .. x+7] (zero from column n on): one 16-byte
// streaming load when `vec` (the row start is 16-byte aligned and
// x + 8 <= n), else one load per sample. x is a multiple of 8.
__device__ __forceinline__ int4 load8(const int16_t* row, int x, int n, bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const int4*>(row + x));
  int s[GROUP];
#pragma unroll
  for (int k = 0; k < GROUP; ++k) s[k] = x + k < n ? row[x + k] : 0;
  return pack8(s);
}

__device__ __forceinline__ void store8(int16_t* row, int x, int n, bool vec, const int4 v) {
  if (vec) {
    __stcs(reinterpret_cast<int4*>(row + x), v);
    return;
  }
  int s[GROUP];
  unpack8(v, s);
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    if (x + k < n) row[x + k] = (int16_t)s[k];
}

// The pattern windows a group of 8 reads, as indices into the (GH, GW)
// pattern at the group's row 0: its block's (cur); the left block's
// continuation past its right edge (lft, lanes < OVC of a block's first
// group); the block above's continuation below its bottom edge (top,
// rows < OVR), and the top-left block's (tl).
struct Windows {
  int cur, lft, top, tl;
  bool left, above;
};

// orow: the stripe's NB block randoms; blk: the group's block index;
// c0: the group's first column within its block; s: the stripe.
template <int SX, int SY>
__device__ __forceinline__ Windows windows(const int* orow, int NB, int blk, int c0,
                                           int s, bool overlap) {
  using G = Geo<SX, SY>;
  auto base = [](int rd) { return off_y<SY>(rd) * G::GW + off_x<SX>(rd); };
  Windows w;
  w.cur = base(__ldg(orow + blk)) + c0;
  w.left = overlap && blk > 0 && c0 == 0;
  w.above = overlap && s > 0;
  w.lft = w.left ? base(__ldg(orow + blk - 1)) + G::BW : 0;
  w.top = w.above ? base(__ldg(orow - NB + blk)) + G::BH * G::GW + c0 : 0;
  w.tl = w.left && w.above ? base(__ldg(orow - NB + blk - 1)) + G::BH * G::GW + G::BW : 0;
  return w;
}

// Grain of a group's 8 samples at row r of its stripe, before scaling,
// with the overlap blends (spec 7.18.3.5).
template <int SX, int SY>
__device__ __forceinline__ void noise8(const int16_t* pat, const Windows& w, int r,
                                       int gmin, int gmax, int (&g)[GROUP]) {
  using G = Geo<SX, SY>;
  const int16_t* p = pat + w.cur + r * G::GW;
#pragma unroll
  for (int k = 0; k < GROUP; ++k) g[k] = p[k];
  if (w.left) {
    const int16_t* q = pat + w.lft + r * G::GW;
#pragma unroll
    for (int k = 0; k < G::OVC; ++k) g[k] = clampi(blend<SX>(q[k], g[k], k), gmin, gmax);
  }
  if (w.above && r < G::OVR) {
    const int16_t* t = pat + w.top + r * G::GW;
    int tg[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) tg[k] = t[k];
    if (w.left) {
      const int16_t* q = pat + w.tl + r * G::GW;
#pragma unroll
      for (int k = 0; k < G::OVC; ++k) tg[k] = clampi(blend<SX>(q[k], tg[k], k), gmin, gmax);
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) g[k] = clampi(blend<SY>(tg[k], g[k], r), gmin, gmax);
  }
}

// Stage one plane's tables: its (GH, GW) pattern, and its scaling LUT
// expanded to one entry per sample value (scale_lookup of every value,
// 0-255, so any integer type holds it).
template <typename Lut>
__device__ __forceinline__ void stage_tables(int16_t* spat, Lut* slut, const int16_t* pat,
                                             int n, const int* prm, int bit_depth) {
  for (int i = threadIdx.x; i < n; i += THREADS) spat[i] = pat[i];
  for (int v = threadIdx.x; v < (1 << bit_depth); v += THREADS)
    slut[v] = (Lut)scale_lookup(prm + P_LUT, v, bit_depth);
}

// The scalars of a plane's parameter row that the kernels read.
struct PlaneParams {
  int active, ss, lo, hi, gmin, gmax, overlap, use_mult, mult, luma_mult, offset;
};

__device__ __forceinline__ PlaneParams plane_params(const int* prm, int bit_depth) {
  PlaneParams q;
  q.active = prm[P_ACTIVE];
  q.ss = prm[P_SCALING_SHIFT];
  q.lo = prm[P_CLIP_LO];
  q.hi = prm[P_CLIP_HI];
  q.gmin = prm[P_GMIN];
  q.gmax = prm[P_GMAX];
  q.overlap = prm[P_OVERLAP] != 0;
  q.use_mult = prm[P_USE_MULT] != 0;
  q.mult = prm[P_MULT] - 128;
  q.luma_mult = prm[P_LUMA_MULT] - 128;
  // (offset - 256) << (bd - 8), written as a product: a left shift of a
  // negative int is undefined before C++20
  q.offset = (prm[P_OFFSET] - 256) * (1 << (bit_depth - 8));
  return q;
}

// A work unit as (frame, stripe, segment), stepped in that order.
struct Unit {
  int b, s, xs;
  __device__ __forceinline__ void next(int S, int NX) {
    if (++xs == NX) {
      xs = 0;
      if (++s == S) {
        s = 0;
        ++b;
      }
    }
  }
};

// This CTA's contiguous range [u0, u1) of the units, and its first unit.
__device__ __forceinline__ void unit_range(int units, int S, int NX, int& u0, int& u1,
                                           Unit& u) {
  u0 = (int)((int64_t)units * blockIdx.x / gridDim.x);
  u1 = (int)((int64_t)units * (blockIdx.x + 1) / gridDim.x);
  u.b = u0 / (S * NX);
  const int rest = u0 - u.b * S * NX;
  u.s = rest / NX;
  u.xs = rest - u.s * NX;
}

// Grid: a few CTAs per SM, each walking a contiguous range of the
// B x S x NX units (frame, 32-row stripe, 256-sample segment). Thread
// (phase, lane) owns columns x .. x+7, x = 256 xs + 8 lane, on the
// stripe's rows phase, phase + 8, phase + 16, phase + 24.
__global__ void __launch_bounds__(THREADS, 4)
grain_luma_kernel(const int16_t* __restrict__ src, int16_t* __restrict__ out,
                  const int16_t* __restrict__ pattern, int64_t pat_stride,
                  const int* __restrict__ offsets, const int* __restrict__ params,
                  int H, int W, int S, int NB, int NX, int units, int bit_depth) {
  using G = Geo<0, 0>;
  constexpr int RT = BLOCK / RPW;  // rows of a unit per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* spat = reinterpret_cast<int16_t*>(smem);
  int* slut = reinterpret_cast<int*>(smem + G::PAT_BYTES);

  const int lane = threadIdx.x % TX, phase = threadIdx.x / TX;
  const int maxv = (1 << bit_depth) - 1;
  int u0, u1;
  Unit u;
  unit_range(units, S, NX, u0, u1, u);
  int staged = -1;  // the frame whose tables are in shared memory
  PlaneParams q{};
  for (int i = u0; i < u1; ++i, u.next(S, NX)) {
    if (u.b != staged) {  // uniform across the CTA
      staged = u.b;
      const int* prm = params + (int64_t)u.b * P_LEN;
      q = plane_params(prm, bit_depth);
      __syncthreads();  // the previous frame's tables are no longer read
      if (q.active)
        stage_tables(spat, slut, pattern + u.b * pat_stride, G::GH * G::GW, prm, bit_depth);
      __syncthreads();
    }
    const int x = u.xs * UNIT_W + lane * GROUP;
    if (x >= W) continue;
    const int rows = min(BLOCK, H - u.s * BLOCK);
    const int16_t* s0 = src + ((int64_t)u.b * H + u.s * BLOCK) * W;
    int16_t* o0 = out + ((int64_t)u.b * H + u.s * BLOCK) * W;

    int4 v[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) {
        const int16_t* row = s0 + (int64_t)r * W;
        v[t] = load8(row, x, W, x + GROUP <= W && aligned16(row, o0 + (int64_t)r * W));
      }
    }
    if (!q.active) {  // inactive plane: samples pass through
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int r = phase + t * RPW;
        if (r < rows) {
          int16_t* row = o0 + (int64_t)r * W;
          store8(row, x, W, x + GROUP <= W && aligned16(row, s0 + (int64_t)r * W), v[t]);
        }
      }
      continue;
    }
    const Windows w = windows<0, 0>(offsets + ((int64_t)u.b * S + u.s) * NB, NB,
                                    x / BLOCK, x % BLOCK, u.s, q.overlap);
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) {
        int sm[GROUP], g[GROUP];
        unpack8(v[t], sm);
        noise8<0, 0>(spat, w, r, q.gmin, q.gmax, g);
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          sm[k] = grained(sm[k], g[k], slut[clampi(sm[k], 0, maxv)], q.ss, q.lo, q.hi);
        }
        int16_t* row = o0 + (int64_t)r * W;
        store8(row, x, W, x + GROUP <= W && aligned16(row, s0 + (int64_t)r * W), pack8(sm));
      }
    }
  }
}

// The collocated source luma of a chroma group, as the 16 (SX) or 8
// samples the pair average reads: row[2 xc + j] (row[xc + j]), the
// column clamped to W - 1 (an odd width pairs the last sample with
// itself), zero past the chroma row's end.
template <int SX>
__device__ __forceinline__ void load_luma(const int16_t* row, int xc, int W, int Wc,
                                          bool vec, int4 (&l)[1 + SX]) {
  if (vec) {
#pragma unroll
    for (int h = 0; h <= SX; ++h)
      l[h] = __ldcs(reinterpret_cast<const int4*>(row + (xc << SX) + h * GROUP));
    return;
  }
#pragma unroll
  for (int h = 0; h <= SX; ++h) {
    int s[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int j = h * GROUP + k;
      s[k] = xc + (j >> SX) < Wc ? row[min((xc << SX) + j, W - 1)] : 0;
    }
    l[h] = pack8(s);
  }
}

// Grid as the luma kernel's, over units of (frame, luma stripe, 256
// chroma samples). Thread (phase, lane) owns chroma columns xc .. xc+7 of
// the stripe's chroma rows phase, phase + 8, ... (BH = 32 >> SY rows), and
// reads their collocated luma (even rows when SY) for the scaling input.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS, 2)
grain_chroma_pair_kernel(const int16_t* __restrict__ y,
                         const int16_t* __restrict__ cb,
                         const int16_t* __restrict__ cr,
                         int16_t* __restrict__ out_cb, int16_t* __restrict__ out_cr,
                         const int16_t* __restrict__ cb_pat, int64_t cb_stride,
                         const int16_t* __restrict__ cr_pat, int64_t cr_stride,
                         const int* __restrict__ offsets,
                         const int* __restrict__ params2, int B, int H, int W,
                         int S, int NB, int NX, int units, int bit_depth) {
  using G = Geo<SX, SY>;
  constexpr int RT = G::BH / RPW;  // chroma rows of a unit per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* spat[2] = {reinterpret_cast<int16_t*>(smem),
                      reinterpret_cast<int16_t*>(smem + G::PAT_BYTES)};
  int* slut[2] = {reinterpret_cast<int*>(smem + 2 * G::PAT_BYTES),
                  reinterpret_cast<int*>(smem + 2 * G::PAT_BYTES + (sizeof(int) << bit_depth))};
  __shared__ PlaneParams sq[2];

  const int Hc = (H + SY) >> SY, Wc = (W + SX) >> SX;
  const int lane = threadIdx.x % TX, phase = threadIdx.x / TX;
  const int maxv = (1 << bit_depth) - 1;
  const int16_t* srcs[2] = {cb, cr};
  int16_t* outs[2] = {out_cb, out_cr};
  int u0, u1;
  Unit u;
  unit_range(units, S, NX, u0, u1, u);
  int staged = -1;
  PlaneParams q[2] = {};
  for (int i = u0; i < u1; ++i, u.next(S, NX)) {
    if (u.b != staged) {  // uniform across the CTA
      staged = u.b;
      __syncthreads();  // the previous frame's tables are no longer read
      const int16_t* pats[2] = {cb_pat + u.b * cb_stride, cr_pat + u.b * cr_stride};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int* prm = params2 + ((int64_t)p * B + u.b) * P_LEN;
        if (threadIdx.x == 0) sq[p] = plane_params(prm, bit_depth);
        if (prm[P_ACTIVE])
          stage_tables(spat[p], slut[p], pats[p], G::GH * G::GW, prm, bit_depth);
      }
      __syncthreads();
      q[0] = sq[0];
      q[1] = sq[1];
    }
    const int xc = u.xs * UNIT_W + lane * GROUP;
    if (xc >= Wc) continue;
    const int yc0 = u.s * G::BH;
    const int rows = min(G::BH, Hc - yc0);
    const int64_t cbase = ((int64_t)u.b * Hc + yc0) * Wc;

    int4 v[2][RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int16_t* row = srcs[p] + cbase + (int64_t)r * Wc;
          v[p][t] = load8(row, xc, Wc,
                          xc + GROUP <= Wc && aligned16(row, outs[p] + cbase + (int64_t)r * Wc));
        }
      }
    }
    if (!q[0].active && !q[1].active) {  // both planes inactive: samples pass through
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int r = phase + t * RPW;
        if (r < rows) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            int16_t* row = outs[p] + cbase + (int64_t)r * Wc;
            store8(row, xc, Wc,
                   xc + GROUP <= Wc && aligned16(row, srcs[p] + cbase + (int64_t)r * Wc),
                   v[p][t]);
          }
        }
      }
      continue;
    }
    int4 l[RT][1 + SX];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) {
        const int16_t* lrow = y + ((int64_t)u.b * H + ((yc0 + r) << SY)) * W;
        const bool vec = ((xc + GROUP) << SX) <= W &&
                         (reinterpret_cast<uintptr_t>(lrow) & 15) == 0;
        load_luma<SX>(lrow, xc, W, Wc, vec, l[t]);
      }
    }
    const int* orow = offsets + ((int64_t)u.b * S + u.s) * NB;
    Windows w[2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
      w[p] = windows<SX, SY>(orow, NB, xc / G::BW, xc % G::BW, u.s, q[p].overlap);
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r >= rows) continue;
      int avg[GROUP];
      if (SX) {
        int a[GROUP], b2[GROUP];
        unpack8(l[t][0], a);
        unpack8(l[t][SX], b2);
#pragma unroll
        for (int k = 0; k < GROUP / 2; ++k) {
          avg[k] = (a[2 * k] + a[2 * k + 1] + 1) >> 1;
          avg[k + GROUP / 2] = (b2[2 * k] + b2[2 * k + 1] + 1) >> 1;
        }
      } else {
        unpack8(l[t][0], avg);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        int16_t* row = outs[p] + cbase + (int64_t)r * Wc;
        const bool vec = xc + GROUP <= Wc && aligned16(row, srcs[p] + cbase + (int64_t)r * Wc);
        if (!q[p].active) {
          store8(row, xc, Wc, vec, v[p][t]);
          continue;
        }
        int sm[GROUP], g[GROUP];
        unpack8(v[p][t], sm);
        noise8<SX, SY>(spat[p], w[p], r, q[p].gmin, q[p].gmax, g);
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int val = q[p].use_mult
              ? clampi(((avg[k] * q[p].luma_mult + sm[k] * q[p].mult) >> 6) + q[p].offset, 0,
                       maxv)
              : avg[k];
          sm[k] = grained(sm[k], g[k], slut[p][clampi(val, 0, maxv)], q[p].ss, q[p].lo,
                          q[p].hi);
        }
        store8(row, xc, Wc, vec, pack8(sm));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fused kernel: luma, Cb and Cr of a frame region in one pass
//
// grain_fused_kernel replaces grain_pallas.py: _fused_kernel. What bounds
// it is bytes, as the two kernels it stands for: but where the luma kernel
// then the chroma-pair kernel read the luma twice (all of it, then every
// row the chroma collocates with for the scaling input), this kernel reads
// every sample of every plane once and writes it once, which is the least
// the apply can move. Its design, each point timed on the card at B = 112
// in the three layouts (PERF.md):
//
// - A work unit is (frame, 32-row luma stripe, 256 chroma columns), so
//   256 << SX luma columns. Each luma row of a unit is read once. The luma
//   pass grains it and writes the chroma scaling input's luma of every
//   collocated row (the pair average at 4:2:0 and 4:2:2, the sample at
//   4:4:4) into shared memory from the source samples it holds in
//   registers; after one barrier the chroma pass reads it there, not from
//   device memory.
// - The luma pass is laid out as the luma kernel: thread (phase, lane)
//   owns the unit's 8-column group lane + 32 (phase & SX) on its rows
//   phase >> SX, + (8 >> SX), ..., so each 16-byte load and store of a
//   warp covers one contiguous 512 bytes of a row. (A thread owning the 16 luma columns
//   of its 8 chroma columns stores two 16-byte halves 32 bytes apart into
//   every sector: 0.70-0.72 of the bound at 4:2:0 and 4:2:2 against 0.76
//   at 4:4:4; a copy with such stores reaches 0.77 of the HBM rate where a
//   plain one reaches 0.87.) The chroma pass is the chroma-pair kernel's:
//   thread (phase, lane) owns chroma columns 256 xs + 8 lane of the rows
//   phase, phase + 8, ... (BH = 32 >> SY rows).
// - Bytes in flight: a thread issues its unit's Cb and Cr loads, then its
//   luma loads, before any arithmetic, so the chroma arrives under the
//   luma pass (3-6% against loading the chroma after the barrier). The
//   averages alternate between two buffers, so one barrier a unit keeps
//   the next unit's writes off the averages still read. Two CTAs an SM:
//   three spill the registers and run slower.
// - As the luma and chroma-pair kernels: persistent, 16-byte streaming
//   loads and stores, tables staged when the frame changes, the same edges
//   (per-sample loads and stores where a row is not 16-byte aligned or ends
//   inside a group; an odd width pairs the last luma sample with itself),
//   and an inactive plane copied through (its luma still averaged).
// - Shared memory holds three patterns, three expanded LUTs and the two
//   buffers of averages. The scaling values are 0-255, so a LUT entry is
//   one byte (FusedLut; faster than 2 or 4 bytes), and the LUTs sit 4096
//   entries apart whatever the bit depth: every table's offset is a
//   constant of the layout. 47,344 B at 4:2:0, 69,888 B at 4:2:2 and
//   81,008 B at 4:4:4 (with int32 LUTs at 12 bits 4:4:4, 117,872).
// - The chroma scaling input ((avg lm + src m) >> 6) + offset folds the
//   offset into the sum before the shift, ((avg lm + src m + 64 offset)
//   >> 6), which is equal for integers; a plane that takes its scaling
//   from luma runs the same expression with lm = 64, m = 0, offset = 0,
//   which gives avg exactly. The clamps are Hopper's DPX min/max
//   instructions (a clamp at 0 and an add with a min in one each).

using FusedLut = uint8_t;
constexpr int FUSED_LUT = 1 << 12;  // entries of an expanded LUT, the 12-bit range
constexpr int FUSED_CTAS = 2;       // CTAs an SM holds at once: the registers' budget

// Byte offsets in the fused kernel's dynamic shared memory: the Y, Cb and
// Cr LUTs, the luma pattern, Cb's and Cr's, then two buffers of a unit's
// chroma scaling input luma, (BH, 256) int16 each.
template <int SX, int SY>
struct FusedSmem {
  static constexpr int PAT_Y = 3 * FUSED_LUT * (int)sizeof(FusedLut);
  static constexpr int PAT_C = PAT_Y + Geo<0, 0>::PAT_BYTES;
  static constexpr int AVG = PAT_C + 2 * Geo<SX, SY>::PAT_BYTES;
  static constexpr int AVG_BYTES = Geo<SX, SY>::BH * UNIT_W * 2;
  static constexpr int BYTES = AVG + 2 * AVG_BYTES;
};

// clamp(v, 0, hi), and grained() with its clamp, as DPX instructions
__device__ __forceinline__ int clamp0(int v, int hi) { return __vimin_s32_relu(v, hi); }
__device__ __forceinline__ int grained_dpx(int src, int noise, int scale, int ss, int lo, int hi) {
  return max(__viaddmin_s32(src, (scale * noise + (1 << (ss - 1))) >> ss, hi), lo);
}

// A plane's scalars for the fused kernel: plane_params, with a chroma
// plane's combination written as the kernel evaluates it (see above).
__device__ __forceinline__ PlaneParams fused_params(const int* prm, int bit_depth) {
  PlaneParams q = plane_params(prm, bit_depth);
  if (!q.use_mult) {
    q.luma_mult = 64;
    q.mult = 0;
    q.offset = 0;
  }
  q.offset *= 64;
  return q;
}

template <int SX, int SY>
__global__ void __launch_bounds__(THREADS, FUSED_CTAS)
grain_fused_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ cb,
                   const int16_t* __restrict__ cr, int16_t* __restrict__ out_y,
                   int16_t* __restrict__ out_cb, int16_t* __restrict__ out_cr,
                   const int16_t* __restrict__ y_pat, int64_t y_stride,
                   const int16_t* __restrict__ cb_pat, int64_t cb_stride,
                   const int16_t* __restrict__ cr_pat, int64_t cr_stride,
                   const int* __restrict__ offsets, const int* __restrict__ params_y,
                   const int* __restrict__ params2, int B, int H, int W, int S, int NB,
                   int NX, int units, int bit_depth) {
  using L = Geo<0, 0>;
  using C = Geo<SX, SY>;
  using M = FusedSmem<SX, SY>;
  constexpr int RT = C::BH / RPW;  // chroma rows of a unit per thread
  constexpr int LP = RPW >> SX;    // luma rows one pass of the CTA covers
  constexpr int RL = BLOCK / LP;   // luma rows of a unit per thread
  extern __shared__ __align__(16) unsigned char smem[];
  FusedLut* slut = reinterpret_cast<FusedLut*>(smem);  // plane p's at p * FUSED_LUT
  int16_t* spat[3] = {reinterpret_cast<int16_t*>(smem + M::PAT_Y),
                      reinterpret_cast<int16_t*>(smem + M::PAT_C),
                      reinterpret_cast<int16_t*>(smem + M::PAT_C + C::PAT_BYTES)};
  __shared__ PlaneParams sq[3];

  const int Hc = (H + SY) >> SY, Wc = (W + SX) >> SX;
  const int lane = threadIdx.x % TX, phase = threadIdx.x / TX;
  // luma: the thread's group of 8 columns within a unit's 256 << SX, on
  // the unit's rows lrow0, lrow0 + LP, ...; each 16-byte access of a warp
  // covers one contiguous 512 bytes of a row
  const int lcol = ((phase & SX) * TX + lane) * GROUP;
  const int lrow0 = phase >> SX;
  const int maxv = (1 << bit_depth) - 1;
  const int16_t* csrc[2] = {cb, cr};
  int16_t* cout[2] = {out_cb, out_cr};
  int u0, u1;
  Unit u;
  unit_range(units, S, NX, u0, u1, u);
  int staged = -1;  // the frame whose tables are in shared memory
  PlaneParams qy{}, qc[2] = {};
  for (int i = u0; i < u1; ++i, u.next(S, NX)) {
    if (u.b != staged) {  // uniform across the CTA
      staged = u.b;
      __syncthreads();  // the previous frame's tables are no longer read
      const int* prm[3] = {params_y + (int64_t)u.b * P_LEN, params2 + (int64_t)u.b * P_LEN,
                           params2 + ((int64_t)B + u.b) * P_LEN};
      const int16_t* pats[3] = {y_pat + u.b * y_stride, cb_pat + u.b * cb_stride,
                                cr_pat + u.b * cr_stride};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (threadIdx.x == 0) sq[p] = fused_params(prm[p], bit_depth);
        if (prm[p][P_ACTIVE])
          stage_tables(spat[p], slut + p * FUSED_LUT, pats[p],
                       p ? C::GH * C::GW : L::GH * L::GW, prm[p], bit_depth);
      }
      __syncthreads();
      qy = sq[0];
      qc[0] = sq[1];
      qc[1] = sq[2];
    }
    // the unit's chroma scaling input luma, (BH, 256) int16; units alternate
    // between two buffers, so one barrier a unit keeps writes of the next
    // unit off the averages still read
    int16_t* avgs = reinterpret_cast<int16_t*>(smem + M::AVG + ((i - u0) & 1) * M::AVG_BYTES);
    const int crows = min(C::BH, Hc - u.s * C::BH);
    const int lrows = min(BLOCK, H - u.s * BLOCK);
    const int64_t lbase = ((int64_t)u.b * H + u.s * BLOCK) * W;
    const int64_t cbase = ((int64_t)u.b * Hc + u.s * C::BH) * Wc;
    const int* orow = offsets + ((int64_t)u.b * S + u.s) * NB;
    const int xc = u.xs * UNIT_W + lane * GROUP;
    // a chroma row's group moves as 16 bytes where it lies inside the row
    // and source and output rows start on a 16-byte boundary
    auto cvec = [&](int p, int64_t o) {
      return xc + GROUP <= Wc && aligned16(csrc[p] + o, cout[p] + o);
    };
    // the unit's Cb and Cr loads first: they arrive under the luma pass
    int4 vc[2][RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < crows && xc < Wc) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int64_t o = cbase + (int64_t)r * Wc;
          vc[p][t] = load8(csrc[p] + o, xc, Wc, cvec(p, o));
        }
      }
    }

    // luma: grained, and the averages (or samples) of the collocated rows
    // into shared memory from the source samples
    const int xg = ((u.xs * UNIT_W) << SX) + lcol;
    if (xg < W) {
      int4 v[RL];
#pragma unroll
      for (int k = 0; k < RL; ++k) {
        const int rl = lrow0 + k * LP;
        if (rl < lrows) {
          const int64_t o = lbase + (int64_t)rl * W;
          v[k] = load8(y + o, xg, W, xg + GROUP <= W && aligned16(y + o, out_y + o));
        }
      }
      const Windows w = windows<0, 0>(orow, NB, xg / BLOCK, xg % BLOCK, u.s, qy.overlap);
#pragma unroll
      for (int k = 0; k < RL; ++k) {
        const int rl = lrow0 + k * LP;
        if (rl >= lrows) continue;
        int sm[GROUP];
        unpack8(v[k], sm);
        if (!SY || !(rl & 1)) {
          int16_t* arow = avgs + (rl >> SY) * UNIT_W;
          if (SX) {
            int a[GROUP];
#pragma unroll
            for (int k2 = 0; k2 < GROUP; ++k2) a[k2] = sm[k2];
            if (xg + GROUP > W) {  // an odd width pairs the last sample with itself
#pragma unroll
              for (int k2 = 1; k2 < GROUP; k2 += 2)
                if (xg + k2 >= W) a[k2] = a[k2 - 1];
            }
            unsigned pw[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              pw[h] = ((unsigned)((a[4 * h] + a[4 * h + 1] + 1) >> 1) & 0xFFFFu) |
                      ((unsigned)((a[4 * h + 2] + a[4 * h + 3] + 1) >> 1) << 16);
            *reinterpret_cast<uint2*>(arow + lcol / 2) = make_uint2(pw[0], pw[1]);
          } else {
            *reinterpret_cast<int4*>(arow + lcol) = v[k];
          }
        }
        if (qy.active) {
          int g[GROUP];
          noise8<0, 0>(spat[0], w, rl, qy.gmin, qy.gmax, g);
#pragma unroll
          for (int k2 = 0; k2 < GROUP; ++k2)
            sm[k2] = grained_dpx(sm[k2], g[k2], slut[clamp0(sm[k2], maxv)], qy.ss, qy.lo, qy.hi);
          v[k] = pack8(sm);
        }
        const int64_t o = lbase + (int64_t)rl * W;
        store8(out_y + o, xg, W, xg + GROUP <= W && aligned16(y + o, out_y + o), v[k]);
      }
    }
    __syncthreads();  // the unit's averages are in shared memory

    // chroma, with the averages from shared memory
    if (xc >= Wc) continue;
    Windows wc[2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
      wc[p] = windows<SX, SY>(orow, NB, xc / C::BW, xc % C::BW, u.s, qc[p].overlap);
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r >= crows) continue;
      int avg[GROUP];
      unpack8(*reinterpret_cast<const int4*>(avgs + r * UNIT_W + lane * GROUP), avg);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int64_t o = cbase + (int64_t)r * Wc;
        int4 res = vc[p][t];
        if (qc[p].active) {
          const PlaneParams& q = qc[p];
          int sm[GROUP], g[GROUP];
          unpack8(res, sm);
          noise8<SX, SY>(spat[1 + p], wc[p], r, q.gmin, q.gmax, g);
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            const int val = (avg[k] * q.luma_mult + sm[k] * q.mult + q.offset) >> 6;
            sm[k] = grained_dpx(sm[k], g[k], slut[(1 + p) * FUSED_LUT + clamp0(val, maxv)], q.ss,
                                q.lo, q.hi);
          }
          res = pack8(sm);
        }
        store8(cout[p] + o, xc, Wc, cvec(p, o), res);
      }
    }
  }
}

// One chroma plane, its scaling input's averaged luma given as an input:
// the chroma-pair kernel's form for one plane. Grid as the luma kernel's,
// over units of (frame, chroma stripe of BH rows, 256 chroma samples): SC
// x NX units a frame, from the plane's size. The offsets are the caller's,
// (B, S, NB) luma-block indexed and possibly larger than the plane, so the
// stripe's row of randoms is at (b S + s) NB. Thread (phase, lane) owns
// columns xc .. xc+7 of the stripe's rows phase, phase + 8, ...; it loads
// src and avg of all its rows before any arithmetic.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS, SY ? 4 : 3)
grain_chroma_kernel(const int16_t* __restrict__ src, const int16_t* __restrict__ avg,
                    int16_t* __restrict__ out, const int16_t* __restrict__ pattern,
                    int64_t pat_stride, const int* __restrict__ offsets,
                    const int* __restrict__ params, int Hc, int Wc, int S, int NB, int SC,
                    int NX, int units, int bit_depth) {
  using G = Geo<SX, SY>;
  constexpr int RT = G::BH / RPW;  // rows of a unit per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* spat = reinterpret_cast<int16_t*>(smem);
  int* slut = reinterpret_cast<int*>(smem + G::PAT_BYTES);

  const int lane = threadIdx.x % TX, phase = threadIdx.x / TX;
  const int maxv = (1 << bit_depth) - 1;
  int u0, u1;
  Unit u;
  unit_range(units, SC, NX, u0, u1, u);
  int staged = -1;  // the frame whose tables are in shared memory
  PlaneParams q{};
  for (int i = u0; i < u1; ++i, u.next(SC, NX)) {
    if (u.b != staged) {  // uniform across the CTA
      staged = u.b;
      const int* prm = params + (int64_t)u.b * P_LEN;
      q = plane_params(prm, bit_depth);
      __syncthreads();  // the previous frame's tables are no longer read
      if (q.active)
        stage_tables(spat, slut, pattern + u.b * pat_stride, G::GH * G::GW, prm, bit_depth);
      __syncthreads();
    }
    const int xc = u.xs * UNIT_W + lane * GROUP;
    if (xc >= Wc) continue;
    const int rows = min(G::BH, Hc - u.s * G::BH);
    const int64_t base = ((int64_t)u.b * Hc + u.s * G::BH) * Wc;
    const int16_t* s0 = src + base;
    const int16_t* a0 = avg + base;
    int16_t* o0 = out + base;
    // a row's 8 samples move as 16 bytes where src, avg and out all start
    // it on a 16-byte boundary
    auto vec = [&](int r) {
      const int64_t o = (int64_t)r * Wc;
      return xc + GROUP <= Wc && aligned16(s0 + o, o0 + o) && aligned16(a0 + o, o0 + o);
    };

    int4 v[RT], a[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) v[t] = load8(s0 + (int64_t)r * Wc, xc, Wc, vec(r));
    }
    if (!q.active) {  // inactive plane: samples pass through
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int r = phase + t * RPW;
        if (r < rows) store8(o0 + (int64_t)r * Wc, xc, Wc, vec(r), v[t]);
      }
      continue;
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r < rows) a[t] = load8(a0 + (int64_t)r * Wc, xc, Wc, vec(r));
    }
    const Windows w = windows<SX, SY>(offsets + ((int64_t)u.b * S + u.s) * NB, NB,
                                      xc / G::BW, xc % G::BW, u.s, q.overlap);
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int r = phase + t * RPW;
      if (r >= rows) continue;
      int sm[GROUP], av[GROUP], g[GROUP];
      unpack8(v[t], sm);
      unpack8(a[t], av);
      noise8<SX, SY>(spat, w, r, q.gmin, q.gmax, g);
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int val = q.use_mult
            ? clampi(((av[k] * q.luma_mult + sm[k] * q.mult) >> 6) + q.offset, 0, maxv)
            : av[k];
        sm[k] = grained(sm[k], g[k], slut[clampi(val, 0, maxv)], q.ss, q.lo, q.hi);
      }
      store8(o0 + (int64_t)r * Wc, xc, Wc, vec(r), pack8(sm));
    }
  }
}
int nblocks(int n) { return (n + BLOCK - 1) / BLOCK; }

// Launch a persistent kernel over `units` work units with `smem` bytes of
// dynamic shared memory: as many CTAs as fit on the card at once, at
// most one per unit.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int64_t units, int bit_depth, size_t smem,
                      cudaStream_t stream, Args... args) {
  if (units == 0) return (int)cudaSuccess;
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
          cudaSuccess)
    return (int)err;
  const int64_t resident = (int64_t)sms * max(per_sm, 1);
  const int64_t grid = units < resident ? units : resident;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(args..., (int)units, bit_depth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grain_luma(const void* src, void* out, const void* pattern, int64_t pat_stride,
               const void* offsets, const void* params, int B, int H, int W,
               int bit_depth, void* stream) {
  const int S = nblocks(H), NB = nblocks(W), NX = (W + UNIT_W - 1) / UNIT_W;
  const int64_t units = (int64_t)B * S * NX;
  return launch_persistent(grain_luma_kernel, units, bit_depth,
                           table_bytes<0, 0>(1, bit_depth), (cudaStream_t)stream,
                           (const int16_t*)src, (int16_t*)out,
                           (const int16_t*)pattern, pat_stride, (const int*)offsets,
                           (const int*)params, H, W, S, NB, NX);
}

int grain_chroma_pair(const void* y, const void* cb, const void* cr, void* out_cb,
                      void* out_cr, const void* cb_pat, int64_t cb_stride,
                      const void* cr_pat, int64_t cr_stride, const void* offsets,
                      const void* params2, int B, int H, int W, int sub_x,
                      int sub_y, int bit_depth, void* stream) {
  const int S = nblocks(H), NB = nblocks(W);
  const int NX = (((W + sub_x) >> sub_x) + UNIT_W - 1) / UNIT_W;
  const int64_t units = (int64_t)B * S * NX;
#define LAUNCH(SX, SY)                                                              \
  return launch_persistent(grain_chroma_pair_kernel<SX, SY>, units, bit_depth,      \
                           table_bytes<SX, SY>(2, bit_depth), (cudaStream_t)stream, \
                           (const int16_t*)y, (const int16_t*)cb, (const int16_t*)cr, \
                           (int16_t*)out_cb, (int16_t*)out_cr, (const int16_t*)cb_pat, \
                           cb_stride, (const int16_t*)cr_pat, cr_stride,              \
                           (const int*)offsets, (const int*)params2, B, H, W, S, NB, NX)
  if (sub_x == 1 && sub_y == 1) LAUNCH(1, 1);
  if (sub_x == 1 && sub_y == 0) LAUNCH(1, 0);
  if (sub_x == 0 && sub_y == 0) LAUNCH(0, 0);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

int grain_fused(const void* y, const void* cb, const void* cr, void* out_y, void* out_cb,
                void* out_cr, const void* y_pat, int64_t y_stride, const void* cb_pat,
                int64_t cb_stride, const void* cr_pat, int64_t cr_stride, const void* offsets,
                const void* params_y, const void* params2, int B, int H, int W, int sub_x,
                int sub_y, int bit_depth, void* stream) {
  const int S = nblocks(H), NB = nblocks(W);
  const int NX = (((W + sub_x) >> sub_x) + UNIT_W - 1) / UNIT_W;
  const int64_t units = (int64_t)B * S * NX;
#define LAUNCH(SX, SY)                                                                     \
  return launch_persistent(grain_fused_kernel<SX, SY>, units, bit_depth,                   \
                           (size_t)FusedSmem<SX, SY>::BYTES, (cudaStream_t)stream,         \
                           (const int16_t*)y, (const int16_t*)cb, (const int16_t*)cr,       \
                           (int16_t*)out_y, (int16_t*)out_cb, (int16_t*)out_cr,             \
                           (const int16_t*)y_pat, y_stride, (const int16_t*)cb_pat,         \
                           cb_stride, (const int16_t*)cr_pat, cr_stride,                    \
                           (const int*)offsets, (const int*)params_y, (const int*)params2, \
                           B, H, W, S, NB, NX)
  if (sub_x == 1 && sub_y == 1) LAUNCH(1, 1);
  if (sub_x == 1 && sub_y == 0) LAUNCH(1, 0);
  if (sub_x == 0 && sub_y == 0) LAUNCH(0, 0);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

int grain_chroma(const void* src, const void* avg, void* out, const void* pattern,
                 int64_t pat_stride, const void* offsets, const void* params, int B,
                 int Hc, int Wc, int S, int NB, int sub_x, int sub_y, int bit_depth,
                 void* stream) {
  const int SC = (Hc + (BLOCK >> sub_y) - 1) / (BLOCK >> sub_y);
  const int NX = (Wc + UNIT_W - 1) / UNIT_W;
  const int64_t units = (int64_t)B * SC * NX;
#define LAUNCH(SX, SY)                                                              \
  return launch_persistent(grain_chroma_kernel<SX, SY>, units, bit_depth,           \
                           table_bytes<SX, SY>(1, bit_depth), (cudaStream_t)stream, \
                           (const int16_t*)src, (const int16_t*)avg, (int16_t*)out,  \
                           (const int16_t*)pattern, pat_stride, (const int*)offsets, \
                           (const int*)params, Hc, Wc, S, NB, SC, NX)
  if (sub_x == 1 && sub_y == 1) LAUNCH(1, 1);
  if (sub_x == 1 && sub_y == 0) LAUNCH(1, 0);
  if (sub_x == 0 && sub_y == 0) LAUNCH(0, 0);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* grain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
