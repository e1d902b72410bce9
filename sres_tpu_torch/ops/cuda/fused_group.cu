// The direct-conv residual group (model.fused) for Hopper.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/attic/residual_group.py:_fwd_kernel (via _fwd_call):
//       nb x RCAB + trailing conv of one group, every conv 9 accumulated
//       (M, C).(C, C) products on shifted rows (:91-96), writing the stashes;
//   sres_tpu/ops/pallas/attic/residual_group.py:_bwd_kernel (via _bwd_call):
//       the group backward from the stashes: conv adjoints (convT :217-224),
//       weight gradients (:226-237), the channel-attention backward
//       (:285-313).
// The TPU kernel keeps a whole tile (act, apad, cpad, skip) resident in VMEM
// for a whole group and streams one RCAB's weights per grid step. A 48x48x64
// bf16 tile is 288 KiB, more than an SM's shared memory, and channel
// attention needs the mean of the whole conv2 output before its gate
// applies. So the group is split in two passes per RCAB around channel
// attention, composed by ops/fused_group.py:
//   (a) fg_conv: a direct 3x3 SAME conv, 64 -> 64, NHWC. One persistent
//       block per (two per SM) walks 8x16-pixel output tiles; it keeps the 9
//       taps' weights (72 KB bf16) in shared memory for all its tiles and
//       the tile's 10x18 input halo (23 KB); zero padding by bounds checks.
//       bf16 on mma.sync m16n8k16 (warp = one output row of 16 pixels x 64
//       channels), f32 on FMAs. Prologue: x * gate + ds (the CA cotangent),
//       rounded to T. Epilogue: + bias, ReLU, zero where mask <= 0, per-tile
//       channel sums of that f32 value (no atomics), (res + v) + res2,
//       stored as T or f32. With flipped, transposed weights it is the dgrad.
//   (b) fg_ca: per sample, the tile sums in a fixed order -> mean -> 1x1 ->
//       ReLU -> 1x1 -> sigmoid gate; x_next = T(x + c * gate), optionally the
//       T stash of c.
//   (c) fg_wgrad: dW[tap] = sum_pixels x_shift(tap)^T . g, db = sum g. Block
//       (tap row, pixel chunk) accumulates 3 taps on tensor cores (bf16) or
//       FMAs (f32) and writes its own f32 partial; sum_partials_kernel adds
//       them in a fixed order, so the gradients are the same bits every run.
//   (d) fg_ca_bwd: per (sample, chunk) partial sums of c and g * c; one
//       block per sample for the MLP backward (ds = dm / npix); the CA weight
//       gradients summed over samples in order.
//
// Rounding points (those of the TPU kernel, :105-133 and :260-336): weights
// and CA weights in T, biases f32; conv outputs are f32 until the stated
// rounding; the CA mean and hidden vector are rounded to T before their 1x1
// products; the gate is f32; x * gate + ds and x + c * gate are a product
// then a sum (no fused multiply-add), as in JAX.
//
// What bounds the conv on this card: at 72x64x48x48 it reads 21 MB and
// writes 21 MB (bf16), 12.7 us at 3.35 TB/s, and its products are 12.2
// GFLOP, 12.4 us at 989 TFLOP/s: it sits on the ridge. This first design
// reads its fragments with 32-bit shared loads (20 per 8 mma) and does not
// overlap a tile's halo load with the previous tile's products except
// across the two blocks of an SM; wgmma, TMA and a pipelined halo are later
// work.

#include "wino_common.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;              // output tile: 8 rows x 16 columns
constexpr int kHH = kTH + 2, kHW = kTW + 2;   // its 3x3 input halo
constexpr int kTaps = 9;
constexpr int kRowB = kC + 8;                 // bf16 shared row: 72 (conflict-free fragments)
constexpr int kRowF = kC + 1;                 // f32 shared row: 65
constexpr int kWarps = kThreads / 32;

struct ConvArgs {
  const void* x;       // (nimg, h, w, 64) T
  const void* wt;      // (9, 64 out, 64 in) T
  const float* bias;   // (64,) or null
  const float* gate;   // (nimg, 64) or null: input prologue x * gate + ds
  const float* ds;
  const void* mask;    // like x, or null: output zeroed where mask <= 0
  const void* res;     // like x, or null
  const void* res2;    // like x, or null
  void* y;             // (nimg, h, w, 64) T or f32
  float* part;         // (nimg * tiles, 64) f32, or null
  int nimg, h, w, relu;
};

__host__ __device__ __forceinline__ int tiles_per_img(int h, int w) {
  return ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x * g + d of a bf16 pair, a product then a sum, each rounded to f32
__device__ __forceinline__ void affine2(uint32_t w, const float* g, const float* d,
                                        float& lo, float& hi) {
  lo = __fadd_rn(__fmul_rn(lo_bf(w), g[0]), d[0]);
  hi = __fadd_rn(__fmul_rn(hi_bf(w), g[1]), d[1]);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack_bf(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// the prologue on 8 channels: T(x * gate + ds)
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* g, const float* d) {
  float lo, hi;
  affine2(v.x, g, d, lo, hi);
  v.x = pack_f2(lo, hi);
  affine2(v.y, g + 2, d + 2, lo, hi);
  v.y = pack_f2(lo, hi);
  affine2(v.z, g + 4, d + 4, lo, hi);
  v.z = pack_f2(lo, hi);
  affine2(v.w, g + 6, d + 6, lo, hi);
  v.w = pack_f2(lo, hi);
  return v;
}

// Epilogue: bias, ReLU, mask -- the value the partial sums see
template <typename T>
__device__ __forceinline__ float epi_value(float v, const ConvArgs& a, int co, size_t off) {
  if (a.bias != nullptr) v += a.bias[co];
  if (a.relu) v = fmaxf(v, 0.0f);
  if (a.mask != nullptr && !(to_f(static_cast<const T*>(a.mask)[off]) > 0.0f)) v = 0.0f;
  return v;
}

// Epilogue: (res + v) + res2
template <typename T>
__device__ __forceinline__ float epi_sum(float v, const ConvArgs& a, size_t off) {
  if (a.res != nullptr) v = to_f(static_cast<const T*>(a.res)[off]) + v;
  if (a.res2 != nullptr) v = v + to_f(static_cast<const T*>(a.res2)[off]);
  return v;
}

// ---------------------------------------------------- (a) conv, bf16
// Shared: the 9 taps' weights [9][64 out][kRowB] and the halo [kHH][kHW][kRowB].
// Warp w computes output row w of the tile: 16 pixels (the m16 fragment,
// pixels gq and gq + 8) x 64 channels (8 n8 fragments).
template <bool kOutF32>
__global__ void __launch_bounds__(kThreads, 2)
fg_conv_bf16_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = ws + kTaps * kC * kRowB;
  __shared__ float red[kWarps][kC];
  const int tid = threadIdx.x;
  const bf16* x = static_cast<const bf16*>(a.x);
  const uint4* wsrc = static_cast<const uint4*>(a.wt);
  for (int i = tid; i < kTaps * kC * (kC / 8); i += kThreads)
    *reinterpret_cast<uint4*>(ws + (i >> 3) * kRowB + (i & 7) * 8) = __ldg(wsrc + i);

  const int ntx = (a.w + kTW - 1) / kTW, per_img = tiles_per_img(a.h, a.w);
  const int ntiles = a.nimg * per_img;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();                         // the previous tile is done with hs, red
    for (int i = tid; i < kHH * kHW * (kC / 8); i += kThreads) {
      const int pos = i >> 3, cv = (i & 7) * 8;
      const int yy = y0 + pos / kHW - 1, xx = x0 + pos % kHW - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (((size_t)im * a.h + yy) * a.w + xx) * kC + cv));
        if (a.gate != nullptr)
          v = prologue8(v, a.gate + im * kC + cv, a.ds + im * kC + cv);
      }
      *reinterpret_cast<uint4*>(hs + pos * kRowB + cv) = v;
    }
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nb][r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int ky = t / 3, kx = t % 3;
      const bf16* ab = hs + ((warp + ky) * kHW + kx + gq) * kRowB + 2 * q4;
      const bf16* bb = ws + (t * kC + gq) * kRowB + 2 * q4;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4];
        af[0] = ld32(ab + 16 * ks);
        af[1] = ld32(ab + 8 * kRowB + 16 * ks);
        af[2] = ld32(ab + 16 * ks + 8);
        af[3] = ld32(ab + 8 * kRowB + 16 * ks + 8);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const bf16* bp = bb + nb * 8 * kRowB + 16 * ks;
          mma_bf16(acc[nb], af, ld32(bp), ld32(bp + 8));
        }
      }
    }

    // epilogue: acc[nb][2*hr + e] is pixel gq + 8*hr, channel 8*nb + 2*q4 + e
    const int oy = y0 + warp;
    float psum[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) psum[nb][0] = psum[nb][1] = 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int ox = x0 + gq + 8 * hr;
      if (oy >= a.h || ox >= a.w) continue;
      const size_t pix = ((size_t)im * a.h + oy) * a.w + ox;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int co = 8 * nb + 2 * q4;
        const size_t off = pix * kC + co;
        float v0 = epi_value<bf16>(acc[nb][2 * hr], a, co, off);
        float v1 = epi_value<bf16>(acc[nb][2 * hr + 1], a, co + 1, off + 1);
        psum[nb][0] += v0;
        psum[nb][1] += v1;
        v0 = epi_sum<bf16>(v0, a, off);
        v1 = epi_sum<bf16>(v1, a, off + 1);
        if constexpr (kOutF32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.y) + off) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.y) + off) = pack_f2(v0, v1);
      }
    }
    if (a.part != nullptr) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = psum[nb][e];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (gq == 0) red[warp][8 * nb + 2 * q4 + e] = s;
        }
      __syncthreads();
      if (tid < kC) {
        float s = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
        a.part[(size_t)tile * kC + tid] = s;
      }
    }
  }
}

// ----------------------------------------------------- (a) conv, f32
// Shared: weights transposed to [9][64 in][64 out] and the halo
// [kHH][kHW][kRowF]. Thread (pixel group pg, channel quad cq): output row
// pg / 2, columns 8 * (pg % 2) .. + 7, channels 4 * cq .. + 3.
__global__ void __launch_bounds__(kThreads)
fg_conv_f32_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);
  float* hs = ws + kTaps * kC * kC;
  __shared__ float red[kWarps][kC];
  const int tid = threadIdx.x;
  const float* x = static_cast<const float*>(a.x);
  const float* wsrc = static_cast<const float*>(a.wt);
  for (int i = tid; i < kTaps * kC * kC; i += kThreads) {
    const int t = i / (kC * kC), o = (i / kC) % kC, ci = i % kC;
    ws[(t * kC + ci) * kC + o] = wsrc[i];
  }

  const int ntx = (a.w + kTW - 1) / kTW, per_img = tiles_per_img(a.h, a.w);
  const int ntiles = a.nimg * per_img;
  const int cq = tid & 15, pg = tid >> 4, r = pg >> 1, cb = (pg & 1) * 8, co0 = 4 * cq;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();
    for (int i = tid; i < kHH * kHW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;
      const int yy = y0 + pos / kHW - 1, xx = x0 + pos % kHW - 1;
      float v = 0.0f;
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
        v = x[(((size_t)im * a.h + yy) * a.w + xx) * kC + c];
        if (a.gate != nullptr)
          v = __fadd_rn(__fmul_rn(v, a.gate[im * kC + c]), a.ds[im * kC + c]);
      }
      hs[pos * kRowF + c] = v;
    }
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
    for (int t = 0; t < kTaps; ++t) {
      const int ky = t / 3, kx = t % 3;
      const float* hp = hs + ((r + ky) * kHW + cb + kx) * kRowF;
      const float* wp = ws + t * kC * kC + co0;
#pragma unroll 4
      for (int ci = 0; ci < kC; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(wp + ci * kC);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = hp[j * kRowF + ci];
          acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
        }
      }
    }

    const int oy = y0 + r;
    float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = x0 + cb + j;
      if (oy >= a.h || ox >= a.w) continue;
      const size_t off = (((size_t)im * a.h + oy) * a.w + ox) * kC + co0;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = epi_value<float>(acc[j][q], a, co0 + q, off + q);
        psum[q] += v;
        o[q] = epi_sum<float>(v, a, off + q);
      }
      store4(static_cast<float*>(a.y) + off, o);
    }
    if (a.part != nullptr) {
      // lanes l and l + 16 of a warp hold the two column halves of one row
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = psum[q] + __shfl_xor_sync(0xffffffffu, psum[q], 16);
        if (lane < 16) red[warp][co0 + q] = s;
      }
      __syncthreads();
      if (tid < kC) {
        float s = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
        a.part[(size_t)tile * kC + tid] = s;
      }
    }
  }
}

// ------------------------------------------- (b) gate + skip, per RCAB
// gate = sigmoid(W2 T(relu(W1 T(mean) + b1)) + b2) from the conv's per-tile
// sums; out = T(x + c * gate). Every block recomputes its sample's gate.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_kernel(const T* __restrict__ x, const float* __restrict__ c,
             const float* __restrict__ part, int npart,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ w2, const float* __restrict__ b2,
             T* __restrict__ xn, float* __restrict__ gate_out, T* __restrict__ cst,
             int hw, int hidden) {
  const int im = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x, tid = threadIdx.x;
  __shared__ float mean[kC], hid[kMaxHidden], gate[kC];
  if (tid < kC) {
    float t = 0.0f;
    for (int p = 0; p < npart; ++p) t += part[((size_t)im * npart + p) * kC + tid];
    mean[tid] = rnd<T>(t / (float)hw);
  }
  __syncthreads();
  if (tid < hidden) {
    float t = 0.0f;
    for (int k = 0; k < kC; ++k) t = fmaf(mean[k], w1[tid * kC + k], t);
    hid[tid] = rnd<T>(fmaxf(t + b1[tid], 0.0f));
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(hid[k], w2[tid * hidden + k], t);
    const float g = 1.0f / (1.0f + expf(-(t + b2[tid])));
    gate[tid] = g;
    if (chunk == 0) gate_out[(size_t)im * kC + tid] = g;
  }
  __syncthreads();
  const long long per = (long long)hw * kC;
  const long long e0 = per * chunk / nchunk, e1 = per * (chunk + 1) / nchunk;
  const size_t base = (size_t)im * per;
  for (long long e = e0 + tid; e < e1; e += kThreads) {
    const float cv = c[base + e];
    xn[base + e] = from_f<T>(__fadd_rn(to_f(x[base + e]), __fmul_rn(cv, gate[e % kC])));
    if (cst != nullptr) cst[base + e] = from_f<T>(cv);
  }
}

// ------------------------------------------ (c) weight gradient, bf16
// Block (tap row ky, pixel chunk s) walks its tiles in order. Shared: the
// input rows ky - 1 .. ky + 6 of the tile's halo [kTH][kHW][kRowB] and the
// cotangent tile [kTH][kTW][kRowB] (the prologue applied, rounded to T).
// Warp (mi, nh): dW rows ci = 16 mi .. + 15, columns co = 32 nh .. + 31,
// for the 3 taps kx; one k-step = one tile row of 16 pixels. Thread tid
// sums db over channels 8 * (tid % 8) .. + 7 of the pixels it loads.
__global__ void __launch_bounds__(kThreads)
fg_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const float* __restrict__ gate, const float* __restrict__ ds,
                     float* __restrict__ wpart, float* __restrict__ dbpart, int own_db,
                     int nimg, int h, int w) {
  __shared__ __align__(16) bf16 xs[kTH][kHW][kRowB];
  __shared__ __align__(16) bf16 gs[kTH][kTW][kRowB];
  __shared__ float dbs[kThreads][8];
  const int ky = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y, tid = threadIdx.x;
  const int ntx = (w + kTW - 1) / kTW, per_img = tiles_per_img(h, w);
  const int ntiles = nimg * per_img;
  const int t0 = (int)((long long)ntiles * s / nsplit);
  const int t1 = (int)((long long)ntiles * (s + 1) / nsplit);
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const int mi = warp & 3, nh = warp >> 2;
  const bool sum_db = own_db && ky == 0;
  float acc[3][4][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kx][jn][e] = 0.0f;
  float dbacc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) dbacc[j] = 0.0f;

  for (int tile = t0; tile < t1; ++tile) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();
    for (int i = tid; i < kTH * kHW * (kC / 8); i += kThreads) {
      const int pos = i >> 3, cv = (i & 7) * 8;
      const int rr = pos / kHW, cx = pos % kHW;
      const int yy = y0 + ky - 1 + rr, xx = x0 - 1 + cx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        v = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)im * h + yy) * w + xx) * kC + cv));
      *reinterpret_cast<uint4*>(&xs[rr][cx][cv]) = v;
    }
    for (int i = tid; i < kTH * kTW * (kC / 8); i += kThreads) {
      const int pos = i >> 3, cv = (i & 7) * 8;       // cv == 8 * (tid % 8)
      const int rr = pos / kTW, cx = pos % kTW;
      const int yy = y0 + rr, xx = x0 + cx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy < h && xx < w) {
        v = __ldg(reinterpret_cast<const uint4*>(g + (((size_t)im * h + yy) * w + xx) * kC + cv));
        float f[8];
        const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gate != nullptr) {
            affine2(wd[j], gate + im * kC + cv + 2 * j, ds + im * kC + cv + 2 * j,
                    f[2 * j], f[2 * j + 1]);
          } else {
            f[2 * j] = lo_bf(wd[j]);
            f[2 * j + 1] = hi_bf(wd[j]);
          }
        }
        if (sum_db) {
#pragma unroll
          for (int j = 0; j < 8; ++j) dbacc[j] += f[j];
        }
        v = make_uint4(pack_f2(f[0], f[1]), pack_f2(f[2], f[3]), pack_f2(f[4], f[5]),
                       pack_f2(f[6], f[7]));
      }
      *reinterpret_cast<uint4*>(&gs[rr][cx][cv]) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int rr = 0; rr < kTH; ++rr) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int n0 = 32 * nh + 8 * jn + gq;
        bfr[jn][0] = pack_bf(gs[rr][2 * q4][n0], gs[rr][2 * q4 + 1][n0]);
        bfr[jn][1] = pack_bf(gs[rr][2 * q4 + 8][n0], gs[rr][2 * q4 + 9][n0]);
      }
      const int m0 = 16 * mi + gq;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int p0 = 2 * q4 + kx;
        uint32_t af[4];
        af[0] = pack_bf(xs[rr][p0][m0], xs[rr][p0 + 1][m0]);
        af[1] = pack_bf(xs[rr][p0][m0 + 8], xs[rr][p0 + 1][m0 + 8]);
        af[2] = pack_bf(xs[rr][p0 + 8][m0], xs[rr][p0 + 9][m0]);
        af[3] = pack_bf(xs[rr][p0 + 8][m0 + 8], xs[rr][p0 + 9][m0 + 8]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_bf16(acc[kx][jn], af, bfr[jn][0], bfr[jn][1]);
      }
    }
  }

#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* pt = wpart + ((size_t)(3 * ky + kx) * nsplit + s) * kC * kC;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int ci = 16 * mi + gq, co = 32 * nh + 8 * jn + 2 * q4;
      *reinterpret_cast<float2*>(pt + ci * kC + co) = make_float2(acc[kx][jn][0], acc[kx][jn][1]);
      *reinterpret_cast<float2*>(pt + (ci + 8) * kC + co) =
          make_float2(acc[kx][jn][2], acc[kx][jn][3]);
    }
  }
  if (sum_db) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dbs[tid][j] = dbacc[j];
    __syncthreads();
    if (tid < kC) {                      // channel tid: threads t = tid / 8 + 8 k
      float t = 0.0f;
      for (int k = 0; k < kThreads / 8; ++k) t += dbs[tid / 8 + 8 * k][tid % 8];
      dbpart[(size_t)s * kC + tid] = t;
    }
  }
}

// ------------------------------------------- (c) weight gradient, f32
// The bf16 kernel's blocks on FMAs; shared rows of kRowF floats. Thread
// (ci = tid / 4, co = 16 * (tid % 4) .. + 15) x the 3 taps kx; thread tid
// sums db over channel tid % 64 of the pixels it loads.
__global__ void __launch_bounds__(kThreads)
fg_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ gate, const float* __restrict__ ds,
                    float* __restrict__ wpart, float* __restrict__ dbpart, int own_db,
                    int nimg, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [kTH][kHW][kRowF]
  float* gs = xs + kTH * kHW * kRowF;                  // [kTH][kTW][kRowF]
  __shared__ float dbs[kThreads];
  const int ky = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y, tid = threadIdx.x;
  const int ntx = (w + kTW - 1) / kTW, per_img = tiles_per_img(h, w);
  const int ntiles = nimg * per_img;
  const int t0 = (int)((long long)ntiles * s / nsplit);
  const int t1 = (int)((long long)ntiles * (s + 1) / nsplit);
  const int ci = tid >> 2, cg = 16 * (tid & 3);
  const bool sum_db = own_db && ky == 0;
  float acc[3][16];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[kx][k] = 0.0f;
  float dbacc = 0.0f;

  for (int tile = t0; tile < t1; ++tile) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();
    for (int i = tid; i < kTH * kHW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;
      const int yy = y0 + ky - 1 + pos / kHW, xx = x0 - 1 + pos % kHW;
      xs[pos * kRowF + c] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                                ? x[(((size_t)im * h + yy) * w + xx) * kC + c] : 0.0f;
    }
    for (int i = tid; i < kTH * kTW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;              // c == tid % 64
      const int yy = y0 + pos / kTW, xx = x0 + pos % kTW;
      float v = 0.0f;
      if (yy < h && xx < w) {
        v = g[(((size_t)im * h + yy) * w + xx) * kC + c];
        if (gate != nullptr)
          v = __fadd_rn(__fmul_rn(v, gate[im * kC + c]), ds[im * kC + c]);
        if (sum_db) dbacc += v;
      }
      gs[pos * kRowF + c] = v;
    }
    __syncthreads();
    for (int p = 0; p < kTH * kTW; ++p) {
      const int rr = p / kTW, j = p % kTW;
      float gv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) gv[k] = gs[p * kRowF + cg + k];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float xv = xs[(rr * kHW + j + kx) * kRowF + ci];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[kx][k] = fmaf(xv, gv[k], acc[kx][k]);
      }
    }
  }

#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* pt = wpart + ((size_t)(3 * ky + kx) * nsplit + s) * kC * kC + ci * kC + cg;
#pragma unroll
    for (int k = 0; k < 16; k += 4) store4(pt + k, &acc[kx][k]);
  }
  if (sum_db) {
    dbs[tid] = dbacc;
    __syncthreads();
    if (tid < kC) {
      float t = 0.0f;
      for (int k = 0; k < kThreads / kC; ++k) t += dbs[tid + kC * k];
      dbpart[(size_t)s * kC + tid] = t;
    }
  }
}

// --------------------------------------- (d) channel-attention backward
// (d1) per (sample, chunk): partial sums of c and of g * c per channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_pool_kernel(const T* __restrict__ g, const T* __restrict__ c,
                      float* __restrict__ partial, int hw) {
  const int s = blockIdx.x, nsplit = gridDim.x, im = blockIdx.y;
  const int ch = threadIdx.x % kC, lane = threadIdx.x / kC;
  constexpr int kLanes = kThreads / kC;
  const int p0 = (int)((long long)hw * s / nsplit);
  const int p1 = (int)((long long)hw * (s + 1) / nsplit);
  const size_t base = (size_t)im * hw * kC + ch;
  float a_s = 0.0f, a_g = 0.0f;
  for (int p = p0 + lane; p < p1; p += kLanes) {
    const float cv = to_f(c[base + (size_t)p * kC]);
    a_s += cv;
    a_g += __fmul_rn(to_f(g[base + (size_t)p * kC]), cv);
  }
  __shared__ float red[2][kThreads];
  red[0][threadIdx.x] = a_s;
  red[1][threadIdx.x] = a_g;
  __syncthreads();
  if (threadIdx.x < kC) {
    float ts = 0.0f, tg = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      ts += red[0][l * kC + ch];
      tg += red[1][l * kC + ch];
    }
    float* pp = partial + (((size_t)im * nsplit + s) * 2) * kC + ch;
    pp[0] = ts;
    pp[kC] = tg;
  }
}

// (d2) one block per sample. work rows per sample:
// [T(mean) | du | T(du) | T(h) | dv | T(dv)], 64 wide.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_mlp_kernel(const float* __restrict__ partial, int npart,
                     const float* __restrict__ gate, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     float* __restrict__ ds_out, float* __restrict__ work, int hidden,
                     int hw) {
  const int im = blockIdx.x, tid = threadIdx.x;
  __shared__ float mr[kC], dur[kC], dvr[kMaxHidden];
  float* wk = work + (size_t)im * 6 * kC;
  if (tid < kC) {
    float ts = 0.0f, tg = 0.0f;
    for (int s = 0; s < npart; ++s) {
      const float* pp = partial + (((size_t)im * npart + s) * 2) * kC + tid;
      ts += pp[0];
      tg += pp[kC];
    }
    mr[tid] = rnd<T>(ts / (float)hw);
    const float gt = gate[(size_t)im * kC + tid];
    const float du = __fmul_rn(__fmul_rn(tg, gt), 1.0f - gt);
    dur[tid] = rnd<T>(du);
    wk[tid] = mr[tid];
    wk[kC + tid] = du;
    wk[2 * kC + tid] = dur[tid];
  }
  __syncthreads();
  if (tid < hidden) {
    float v = 0.0f, dh = 0.0f;
    for (int k = 0; k < kC; ++k) {
      v = fmaf(mr[k], w1[tid * kC + k], v);
      dh = fmaf(dur[k], w2[k * hidden + tid], dh);
    }
    v += b1[tid];
    const float dv = v > 0.0f ? dh : 0.0f;
    dvr[tid] = rnd<T>(dv);
    wk[3 * kC + tid] = rnd<T>(fmaxf(v, 0.0f));
    wk[4 * kC + tid] = dv;
    wk[5 * kC + tid] = dvr[tid];
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(dvr[k], w1[k * kC + tid], t);
    ds_out[(size_t)im * kC + tid] = t / (float)hw;
  }
}

// (d3) the CA weight gradients, summed over samples in order: thread
// e = (k, c) gives dW1[k][c] and dW2[c][k]; c == 0 also db1[k], k == 0 db2[c].
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_wgrad_kernel(const float* __restrict__ work, int nimg, int hidden,
                       float* __restrict__ dw1, float* __restrict__ db1,
                       float* __restrict__ dw2, float* __restrict__ db2) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= hidden * kC) return;
  const int k = e / kC, c = e % kC;
  float a1 = 0.0f, a2 = 0.0f, ab1 = 0.0f, ab2 = 0.0f;
  for (int im = 0; im < nimg; ++im) {
    const float* wk = work + (size_t)im * 6 * kC;
    a1 = fmaf(wk[5 * kC + k], wk[c], a1);              // T(dv) x T(mean)
    a2 = fmaf(wk[2 * kC + c], wk[3 * kC + k], a2);     // T(du) x T(h)
    ab1 += wk[4 * kC + k];
    ab2 += wk[kC + c];
  }
  dw1[k * kC + c] = a1;
  dw2[c * hidden + k] = a2;
  if (c == 0) db1[k] = ab1;
  if (k == 0) db2[c] = ab2;
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1)
    n = 132;
  return n;
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise. Activations are NHWC with 64
// channels, of bf16 (bf16_ = 1) or float.
extern "C" {

// output tiles per image (the rows per sample of a conv's partials)
int sres_fg_tiles(int h, int w) { return tiles_per_img(h, w); }

// x, mask, res, res2: T; wt: (9, 64 out, 64 in) T; bias (64,), gate and ds
// (nimg, 64) f32 or null (gate and ds together); y: T, or f32 when out_f32
// (always f32 for float); part: (nimg * sres_fg_tiles(h, w), 64) f32 or null.
int sres_fg_conv(const void* x, const void* wt, const float* bias, const float* gate,
                 const float* ds, const void* mask, const void* res, const void* res2,
                 void* y, float* part, int nimg, int h, int w, int bf16_, int out_f32,
                 int relu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nimg < 1 || h < 1 || w < 1 || (gate == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvArgs a{x, wt, bias, gate, ds, mask, res, res2, y, part, nimg, h, w, relu};
  const int ntiles = nimg * tiles_per_img(h, w);
  const int nsm = sm_count(device);
  if (bf16_) {
    const size_t smem = (size_t)(kTaps * kC + kHH * kHW) * kRowB * sizeof(bf16);
    const int grid = ntiles < 2 * nsm ? ntiles : 2 * nsm;
    if (out_f32) {
      static bool done = false;
      if ((e = allow_smem(fg_conv_bf16_kernel<true>, smem, done)) != cudaSuccess) return (int)e;
      fg_conv_bf16_kernel<true><<<grid, kThreads, smem, s>>>(a);
    } else {
      static bool done = false;
      if ((e = allow_smem(fg_conv_bf16_kernel<false>, smem, done)) != cudaSuccess) return (int)e;
      fg_conv_bf16_kernel<false><<<grid, kThreads, smem, s>>>(a);
    }
  } else {
    const size_t smem = ((size_t)kTaps * kC * kC + kHH * kHW * kRowF) * sizeof(float);
    static bool done = false;
    if ((e = allow_smem(fg_conv_f32_kernel, smem, done)) != cudaSuccess) return (int)e;
    fg_conv_f32_kernel<<<ntiles < nsm ? ntiles : nsm, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// x, xn, cst: (nimg, hw, 64) T (cst may be null); c: f32; part: (nimg, npart,
// 64) f32; w1 (hidden, 64) and w2 (64, hidden) f32 holding T values, b1
// (hidden,), b2 (64,) f32; gate: (nimg, 64) f32 out.
int sres_fg_ca(const void* x, const float* c, const float* part, int npart,
               const float* w1, const float* b1, const float* w2, const float* b2,
               void* xn, float* gate, void* cst, int nimg, int hw, int hidden,
               int nchunk, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || npart < 1 || nchunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunk, nimg);
  if (bf16_)
    fg_ca_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), c, part, npart, w1, b1, w2, b2,
        static_cast<bf16*>(xn), gate, static_cast<bf16*>(cst), hw, hidden);
  else
    fg_ca_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), c, part, npart, w1, b1, w2, b2,
        static_cast<float*>(xn), gate, static_cast<float*>(cst), hw, hidden);
  return (int)cudaGetLastError();
}

// x, g: T; gate, ds: (nimg, 64) f32 or null (prologue g * gate + ds);
// db_part: null, or ndb_part rows of 64 f32 whose sum is db. Scratch: wpart
// (9, nsplit, 64, 64), dbpart (nsplit, 64) f32. Out: dw (9, 64 in, 64 out),
// db (64,) f32.
int sres_fg_wgrad(const void* x, const void* g, const float* gate, const float* ds,
                  const float* db_part, int ndb_part, float* wpart, float* dbpart,
                  float* dw, float* db, int nimg, int h, int w, int nsplit, int bf16_,
                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nsplit < 1 || (gate == nullptr) != (ds == nullptr) ||
      (db_part != nullptr && ndb_part < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(3, nsplit);
  const int own_db = db_part == nullptr;
  if (bf16_) {
    fg_wgrad_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), gate, ds, wpart, dbpart,
        own_db, nimg, h, w);
  } else {
    const size_t smem = (size_t)(kTH * kHW + kTH * kTW) * kRowF * sizeof(float);
    static bool done = false;
    if ((e = allow_smem(fg_wgrad_f32_kernel, smem, done)) != cudaSuccess) return (int)e;
    fg_wgrad_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), gate, ds, wpart, dbpart,
        own_db, nimg, h, w);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(kTaps * kC * kC + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      wpart, dw, kTaps, nsplit, kC * kC);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (own_db)
    sum_partials_kernel<<<1, kThreads, 0, s>>>(dbpart, db, 1, nsplit, kC);
  else
    sum_partials_kernel<<<1, kThreads, 0, s>>>(db_part, db, 1, ndb_part, kC);
  return (int)cudaGetLastError();
}

// g, c: (nimg, hw, 64) T; gate (nimg, 64) f32, the forward's; w1, b1, w2 as
// sres_fg_ca.
// Scratch: partial (nimg, npart, 2, 64), work (nimg, 6, 64) f32. Out: ds
// (nimg, 64); dw1 (hidden, 64), db1 (hidden,), dw2 (64, hidden), db2 (64,).
int sres_fg_ca_bwd(const void* g, const void* c, const float* gate, const float* w1,
                   const float* b1, const float* w2, float* partial,
                   float* work, float* ds, float* dw1, float* db1, float* dw2, float* db2,
                   int nimg, int hw, int hidden, int npart, int bf16_, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || npart < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    fg_ca_bwd_pool_kernel<bf16><<<dim3(npart, nimg), kThreads, 0, s>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(c), partial, hw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fg_ca_bwd_mlp_kernel<bf16><<<nimg, kThreads, 0, s>>>(partial, npart, gate, w1, b1, w2,
                                                         ds, work, hidden, hw);
  } else {
    fg_ca_bwd_pool_kernel<float><<<dim3(npart, nimg), kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(c), partial, hw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fg_ca_bwd_mlp_kernel<float><<<nimg, kThreads, 0, s>>>(partial, npart, gate, w1, b1, w2,
                                                          ds, work, hidden, hw);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fg_ca_bwd_wgrad_kernel<<<(hidden * kC + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      work, nimg, hidden, dw1, db1, dw2, db2);
  return (int)cudaGetLastError();
}

}  // extern "C"
