// AV1 film grain application on Hopper (sm_90a): a luma kernel, a Cb+Cr
// chroma-pair kernel and a single-chroma-plane kernel, bound to Python
// through a plain C interface (ctypes; see grav1synth_tpu_torch/_build.py).
//
// grain_luma_kernel replaces grav1synth_tpu/ops/grain_pallas.py:
// _luma_kernel (body _apply_groups); grain_chroma_pair_kernel replaces
// grain_pallas.py: _chroma_pair_kernel (body _apply_groups_pair). Run back
// to back on one stream they also replace _fused_kernel, which is the two
// bodies in one launch. grain_chroma_kernel replaces grain_pallas.py:
// _chroma_kernel (one chroma plane, its averaged luma read from an input).
//
// What bounds them on this card: bytes. A 3840x2160 4:2:0 frame moves
// about 50 MB of int16 samples in and out; a frame's patterns, scaling
// LUTs and block randoms are a few KB. The arithmetic per sample is a few
// dozen integer operations, far below what the SMs can issue per byte of
// HBM traffic.
//
// What the design does about it: every sample of a plane is read once and
// written once, with neighbouring threads on neighbouring samples. One
// CTA covers a 32-luma-row stripe across CTA_BLOCKS 32x32 luma blocks
// and stages what it gathers from at data-dependent offsets in shared
// memory: the frame's grain pattern(s), 256-entry scaling LUT(s) and the
// block randoms of this stripe and the one above. The chroma-pair kernel
// reads the collocated source luma for its scaling input (averaged in
// registers) and grains Cb and Cr in one pass over their shared randoms.
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
constexpr int CTA_BLOCKS = 8;   // luma blocks per CTA along x
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

// Randoms of this CTA's blocks: rnd[0][k] for stripe s, rnd[1][k] for
// stripe s-1, at luma block bx0 + k - 1 (k = 0 is the left neighbour of
// the CTA's first block), clamped into the frame.
__device__ __forceinline__ void load_randoms(int (*rnd)[CTA_BLOCKS + 1],
                                             const int* offsets, int bi, int s,
                                             int bx0, int S, int NB) {
  const int t = threadIdx.x;
  if (t < 2 * (CTA_BLOCKS + 1)) {
    const int row = t / (CTA_BLOCKS + 1);
    const int k = t - row * (CTA_BLOCKS + 1);
    const int ss = row == 0 ? s : max(s - 1, 0);
    const int blk = clampi(bx0 + k - 1, 0, NB - 1);
    rnd[row][k] = offsets[((int64_t)bi * S + ss) * NB + blk];
  }
}

// Pattern offset of a block from its 8-bit random (high nibble x, low y).
template <int SX>
__device__ __forceinline__ int off_x(int rd) { return 3 + (2 >> SX) * (3 + (rd >> 4)); }
template <int SY>
__device__ __forceinline__ int off_y(int rd) { return 3 + (2 >> SY) * (3 + (rd & 15)); }

// Per-pixel grain before scaling, with overlap blending. pat is the
// plane's (GH, GW) pattern in shared memory; j is the CTA-local block,
// jg the block's index in the stripe, (c, r) the pixel within its block.
template <int SX, int SY>
__device__ __forceinline__ int grain_noise(const int16_t* pat,
                                           const int (*rnd)[CTA_BLOCKS + 1],
                                           int j, int jg, int c, int r, int s,
                                           bool overlap, int gmin, int gmax) {
  constexpr int GW = SX ? 44 : 82;
  constexpr int BW = BLOCK >> SX, BH = BLOCK >> SY;
  constexpr int OVC = 2 >> SX, OVR = 2 >> SY;
  const int rd = rnd[0][j + 1];
  int g = pat[(off_y<SY>(rd) + r) * GW + off_x<SX>(rd) + c];
  if (!overlap) return g;
  const bool left = jg > 0 && c < OVC;
  if (left) {
    const int rl = rnd[0][j];
    const int lg = pat[(off_y<SY>(rl) + r) * GW + off_x<SX>(rl) + BW + c];
    g = clampi(blend<SX>(lg, g, c), gmin, gmax);
  }
  if (s > 0 && r < OVR) {
    const int rt = rnd[1][j + 1];
    int tg = pat[(off_y<SY>(rt) + BH + r) * GW + off_x<SX>(rt) + c];
    if (left) {
      const int rtl = rnd[1][j];
      const int tlg = pat[(off_y<SY>(rtl) + BH + r) * GW + off_x<SX>(rtl) + BW + c];
      tg = clampi(blend<SX>(tlg, tg, c), gmin, gmax);
    }
    g = clampi(blend<SY>(tg, g, r), gmin, gmax);
  }
  return g;
}

__device__ __forceinline__ int grained(int src, int noise, int scale, int ss,
                                       int lo, int hi) {
  return clampi(src + ((scale * noise + (1 << (ss - 1))) >> ss), lo, hi);
}

// Grid (ceil(NB / CTA_BLOCKS), S, B); one thread per column of the
// CTA's 32 x 256 tile, looping over the stripe's rows.
__global__ void __launch_bounds__(THREADS)
grain_luma_kernel(const int16_t* __restrict__ src, int16_t* __restrict__ out,
                  const int16_t* __restrict__ pattern, int64_t pat_stride,
                  const int* __restrict__ offsets, const int* __restrict__ params,
                  int H, int W, int S, int NB, int bit_depth) {
  constexpr int GH = 73, GW = 82;
  constexpr int TW = CTA_BLOCKS * BLOCK;
  static_assert(TW == THREADS, "one thread per tile column");
  __shared__ int16_t spat[GH * GW];
  __shared__ int lut[256];
  __shared__ int rnd[2][CTA_BLOCKS + 1];

  const int bi = blockIdx.z, s = blockIdx.y, bx0 = blockIdx.x * CTA_BLOCKS;
  const int* prm = params + (int64_t)bi * P_LEN;
  const int active = prm[P_ACTIVE];
  const int64_t frame = (int64_t)bi * H * W;
  const int y0 = s * BLOCK, x0 = bx0 * BLOCK;
  const int rows = min(BLOCK, H - y0), cols = min(TW, W - x0);
  const int xl = threadIdx.x;

  if (!active) {  // inactive plane: samples pass through
    if (xl < cols)
      for (int r = 0; r < rows; ++r) {
        const int64_t idx = frame + (int64_t)(y0 + r) * W + x0 + xl;
        out[idx] = src[idx];
      }
    return;
  }
  const int16_t* pat = pattern + bi * pat_stride;
  for (int i = threadIdx.x; i < GH * GW; i += THREADS) spat[i] = pat[i];
  lut[threadIdx.x] = prm[P_LUT + threadIdx.x];
  load_randoms(rnd, offsets, bi, s, bx0, S, NB);
  __syncthreads();
  if (xl >= cols) return;

  const int ss = prm[P_SCALING_SHIFT], lo = prm[P_CLIP_LO], hi = prm[P_CLIP_HI];
  const int gmin = prm[P_GMIN], gmax = prm[P_GMAX];
  const bool overlap = prm[P_OVERLAP] != 0;
  const int j = xl / BLOCK, c = xl % BLOCK, jg = bx0 + j;
  for (int r = 0; r < rows; ++r) {
    const int64_t idx = frame + (int64_t)(y0 + r) * W + x0 + xl;
    const int v = src[idx];
    const int n = grain_noise<0, 0>(spat, rnd, j, jg, c, r, s, overlap, gmin, gmax);
    out[idx] = (int16_t)grained(v, n, scale_lookup(lut, v, bit_depth), ss, lo, hi);
  }
}

// Grid (ceil(NB / CTA_BLOCKS), S, B) over LUMA blocks; each CTA grains
// the collocated (32>>SY) x (CTA_BLOCKS * 32>>SX) tile of Cb and of Cr.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS)
grain_chroma_pair_kernel(const int16_t* __restrict__ y,
                         const int16_t* __restrict__ cb,
                         const int16_t* __restrict__ cr,
                         int16_t* __restrict__ out_cb, int16_t* __restrict__ out_cr,
                         const int16_t* __restrict__ cb_pat, int64_t cb_stride,
                         const int16_t* __restrict__ cr_pat, int64_t cr_stride,
                         const int* __restrict__ offsets,
                         const int* __restrict__ params2, int B, int H, int W,
                         int S, int NB, int bit_depth) {
  constexpr int GH = SY ? 38 : 73, GW = SX ? 44 : 82;
  constexpr int BW = BLOCK >> SX, BH = BLOCK >> SY;
  constexpr int TW = CTA_BLOCKS * BW;  // tile width in chroma samples
  constexpr int RP = THREADS / TW;     // tile rows per pass
  __shared__ int16_t spat[2][GH * GW];
  __shared__ int lut[2][256];
  __shared__ int rnd[2][CTA_BLOCKS + 1];

  const int bi = blockIdx.z, s = blockIdx.y, bx0 = blockIdx.x * CTA_BLOCKS;
  const int Hc = (H + SY) >> SY, Wc = (W + SX) >> SX;
  const int* prm[2] = {params2 + (int64_t)bi * P_LEN,
                       params2 + ((int64_t)B + bi) * P_LEN};
  const int16_t* pats[2] = {cb_pat + bi * cb_stride, cr_pat + bi * cr_stride};
  for (int p = 0; p < 2; ++p) {
    for (int i = threadIdx.x; i < GH * GW; i += THREADS) spat[p][i] = pats[p][i];
    lut[p][threadIdx.x] = prm[p][P_LUT + threadIdx.x];
  }
  load_randoms(rnd, offsets, bi, s, bx0, S, NB);
  __syncthreads();

  const int yc0 = s * BH, xc0 = bx0 * BW;
  const int rows = min(BH, Hc - yc0), cols = min(TW, Wc - xc0);
  const int xl = threadIdx.x % TW;
  if (xl >= cols) return;
  const int j = xl / BW, c = xl % BW, jg = bx0 + j;
  const int xc = xc0 + xl;
  const int maxval = (1 << bit_depth) - 1;
  const int64_t lframe = (int64_t)bi * H * W;
  const int64_t cframe = (int64_t)bi * Hc * Wc;
  const int16_t* srcs[2] = {cb, cr};
  int16_t* outs[2] = {out_cb, out_cr};

  for (int r = threadIdx.x / TW; r < rows; r += RP) {
    const int yc = yc0 + r;
    // collocated source luma: even rows when vertically subsampled; the
    // horizontal pair average clamps to the last column for odd widths
    const int16_t* lrow = y + lframe + (int64_t)(yc << SY) * W;
    int avg;
    if (SX) {
      const int lx = xc << 1;
      avg = (lrow[lx] + lrow[min(lx + 1, W - 1)] + 1) >> 1;
    } else {
      avg = lrow[xc];
    }
    const int64_t idx = cframe + (int64_t)yc * Wc + xc;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int* q = prm[p];
      const int v = srcs[p][idx];
      int res = v;
      if (q[P_ACTIVE]) {
        int val = avg;
        if (q[P_USE_MULT]) {
          const int combined = avg * (q[P_LUMA_MULT] - 128) + v * (q[P_MULT] - 128);
          // (offset - 256) << (bd - 8), written as a product: a left
          // shift of a negative int is undefined before C++20
          val = clampi((combined >> 6) + (q[P_OFFSET] - 256) * (1 << (bit_depth - 8)),
                       0, maxval);
        }
        const int n = grain_noise<SX, SY>(spat[p], rnd, j, jg, c, r, s,
                                          q[P_OVERLAP] != 0, q[P_GMIN], q[P_GMAX]);
        res = grained(v, n, scale_lookup(lut[p], val, bit_depth),
                      q[P_SCALING_SHIFT], q[P_CLIP_LO], q[P_CLIP_HI]);
      }
      outs[p][idx] = (int16_t)res;
    }
  }
}

// One chroma plane with its scaling input's averaged luma given as an
// input. Grid (ceil(NB / CTA_BLOCKS), S, B) over the LUMA blocks of the
// offsets (S, NB come from the caller's offsets, not from Hc and Wc);
// each CTA grains the collocated (32>>SY) x (CTA_BLOCKS * 32>>SX) tile.
template <int SX, int SY>
__global__ void __launch_bounds__(THREADS)
grain_chroma_kernel(const int16_t* __restrict__ src, const int16_t* __restrict__ avg,
                    int16_t* __restrict__ out, const int16_t* __restrict__ pattern,
                    int64_t pat_stride, const int* __restrict__ offsets,
                    const int* __restrict__ params, int Hc, int Wc, int S, int NB,
                    int bit_depth) {
  constexpr int GH = SY ? 38 : 73, GW = SX ? 44 : 82;
  constexpr int BW = BLOCK >> SX, BH = BLOCK >> SY;
  constexpr int TW = CTA_BLOCKS * BW;  // tile width in chroma samples
  constexpr int RP = THREADS / TW;     // tile rows per pass
  __shared__ int16_t spat[GH * GW];
  __shared__ int lut[256];
  __shared__ int rnd[2][CTA_BLOCKS + 1];

  const int bi = blockIdx.z, s = blockIdx.y, bx0 = blockIdx.x * CTA_BLOCKS;
  const int* prm = params + (int64_t)bi * P_LEN;
  const int64_t frame = (int64_t)bi * Hc * Wc;
  const int yc0 = s * BH, xc0 = bx0 * BW;
  const int rows = min(BH, Hc - yc0), cols = min(TW, Wc - xc0);
  const int xl = threadIdx.x % TW;

  if (!prm[P_ACTIVE]) {  // inactive plane: samples pass through
    if (xl < cols)
      for (int r = threadIdx.x / TW; r < rows; r += RP) {
        const int64_t idx = frame + (int64_t)(yc0 + r) * Wc + xc0 + xl;
        out[idx] = src[idx];
      }
    return;
  }
  const int16_t* pat = pattern + bi * pat_stride;
  for (int i = threadIdx.x; i < GH * GW; i += THREADS) spat[i] = pat[i];
  lut[threadIdx.x] = prm[P_LUT + threadIdx.x];
  load_randoms(rnd, offsets, bi, s, bx0, S, NB);
  __syncthreads();
  if (xl >= cols) return;

  const int ss = prm[P_SCALING_SHIFT], lo = prm[P_CLIP_LO], hi = prm[P_CLIP_HI];
  const int gmin = prm[P_GMIN], gmax = prm[P_GMAX];
  const bool overlap = prm[P_OVERLAP] != 0;
  const bool use_mult = prm[P_USE_MULT] != 0;
  const int mult = prm[P_MULT] - 128, luma_mult = prm[P_LUMA_MULT] - 128;
  // (offset - 256) << (bd - 8), written as a product (see the pair kernel)
  const int offset = (prm[P_OFFSET] - 256) * (1 << (bit_depth - 8));
  const int maxval = (1 << bit_depth) - 1;
  const int j = xl / BW, c = xl % BW, jg = bx0 + j;
  for (int r = threadIdx.x / TW; r < rows; r += RP) {
    const int64_t idx = frame + (int64_t)(yc0 + r) * Wc + xc0 + xl;
    const int v = src[idx];
    const int a = avg[idx];
    const int val = use_mult ? clampi(((a * luma_mult + v * mult) >> 6) + offset, 0, maxval) : a;
    const int n = grain_noise<SX, SY>(spat, rnd, j, jg, c, r, s, overlap, gmin, gmax);
    out[idx] = (int16_t)grained(v, n, scale_lookup(lut, val, bit_depth), ss, lo, hi);
  }
}

int nblocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" {

int grain_luma(const void* src, void* out, const void* pattern, int64_t pat_stride,
               const void* offsets, const void* params, int B, int H, int W,
               int bit_depth, void* stream) {
  const int S = nblocks(H), NB = nblocks(W);
  const dim3 grid((NB + CTA_BLOCKS - 1) / CTA_BLOCKS, S, B);
  grain_luma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)src, (int16_t*)out, (const int16_t*)pattern, pat_stride,
      (const int*)offsets, (const int*)params, H, W, S, NB, bit_depth);
  return (int)cudaGetLastError();
}

int grain_chroma_pair(const void* y, const void* cb, const void* cr, void* out_cb,
                      void* out_cr, const void* cb_pat, int64_t cb_stride,
                      const void* cr_pat, int64_t cr_stride, const void* offsets,
                      const void* params2, int B, int H, int W, int sub_x,
                      int sub_y, int bit_depth, void* stream) {
  const int S = nblocks(H), NB = nblocks(W);
  const dim3 grid((NB + CTA_BLOCKS - 1) / CTA_BLOCKS, S, B);
#define LAUNCH(SX, SY)                                                          \
  grain_chroma_pair_kernel<SX, SY><<<grid, THREADS, 0, (cudaStream_t)stream>>>( \
      (const int16_t*)y, (const int16_t*)cb, (const int16_t*)cr,                \
      (int16_t*)out_cb, (int16_t*)out_cr, (const int16_t*)cb_pat, cb_stride,    \
      (const int16_t*)cr_pat, cr_stride, (const int*)offsets,                   \
      (const int*)params2, B, H, W, S, NB, bit_depth)
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

int grain_chroma(const void* src, const void* avg, void* out, const void* pattern,
                 int64_t pat_stride, const void* offsets, const void* params, int B,
                 int Hc, int Wc, int S, int NB, int sub_x, int sub_y, int bit_depth,
                 void* stream) {
  const dim3 grid((NB + CTA_BLOCKS - 1) / CTA_BLOCKS, S, B);
#define LAUNCH(SX, SY)                                                              \
  grain_chroma_kernel<SX, SY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(          \
      (const int16_t*)src, (const int16_t*)avg, (int16_t*)out,                      \
      (const int16_t*)pattern, pat_stride, (const int*)offsets, (const int*)params, \
      Hc, Wc, S, NB, bit_depth)
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

const char* grain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
