// Winograd F(m x m, 3 x 3) convolution and RCAB channel attention for Hopper.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/winograd_conv.py:_fwd_kernel        (wino_conv_quad forward)
//   sres_tpu/ops/pallas/winograd_conv.py:_group_fwd_kernel  (RCAB chain: conv unit
//       :492-525, channel attention + block skip :533-549, trailing conv :554-560;
//       the ungated ResBlock skip x + res_scale * conv2 :545 is kernel (a)'s
//       scaled residual epilogue)
//   sres_tpu/ops/pallas/winograd_conv.py:_chain_fwd_kernel  (K conv+ReLU chain,
//       kernel (c) below)
// The TPU group kernel keeps one sample block resident in VMEM across a whole
// residual group. One 48x48x64 bf16 tile is 288 KiB, more than an SM's shared
// memory, and channel attention needs the mean over the whole tile, so here
// the group is a sequence of launches: conv, conv, pool, gate+skip per RCAB.
//
// Layout: activations are NHWC (a torch NCHW tensor in channels_last memory
// format), C = 64 in and out. U = (n*n, Cin, Cout) transform-domain weights.
//
// Rounding points follow the TPU kernel: both input-transform stages round to
// the activation type T (:501, :503), the tap products take T operands and
// accumulate in f32, the inverse transform, bias, ReLU and the channel
// attention run in f32, and every conv output and skip sum is rounded to T.
//
// What bounds the conv on this card: per conv at 72x64x48x48, m=4, the n*n
// tap products are 3.1 GFLOP, the input and output move 21 MB each (bf16),
// and every block re-reads U (295 KB bf16) from L2. Measured on an H100 for
// the first f32-FMA design (one FMA per U element loaded): the U traffic
// from L2 was two thirds of the time, the input transform most of the rest.
// So the bf16 kernel runs the tap products on the tensor cores (mma.sync
// m16n8k16) with U pre-arranged in fragment order, one coalesced load per
// lane; both kernels keep V of one block of tiles in shared memory, load
// the input patch with unconditional loads, and fold every tap straight
// into the inverse transform in registers, so M = V.U never leaves the SM.
// Not yet: U staged once per block, wgmma/TMA, fusing the RCAB chain.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "wino_common.cuh"

namespace {

// ------------------------------------------------------ kernel (a): conv
// Fold one tap's product into the inverse transform: Y[u][v] += AT[u][ti] *
// AT[v][tj] * m, for compile-time (ti, tj).
template <int M>
__device__ __forceinline__ void fold_tap(float* yacc, float m, int ti, int tj) {
#pragma unroll
  for (int uu = 0; uu < M; ++uu) {
    const float cu = at_coef<M>(uu, ti);
    if (cu == 0.0f) continue;
#pragma unroll
    for (int vv = 0; vv < M; ++vv) {
      const float cv = at_coef<M>(vv, tj);
      if (cv == 0.0f) continue;
      yacc[uu * M + vv] = fmaf(cu * cv, m, yacc[uu * M + vv]);
    }
  }
}

// Epilogue value: + bias (+ ReLU), round to T, optional scaled residual
// sum r + res_scale * o (the JAX order, winograd_conv.py:547-549: the
// product, then the sum; written with __fmul_rn/__fadd_rn so that nvcc
// does not contract it into an FMA JAX does not have). At res_scale 1 the
// product is exact, so the sum is the unscaled epilogue's, bit for bit.
template <typename T>
__device__ __forceinline__ float finish(float acc, float b, int relu,
                                        const float* r, int k, float res_scale) {
  float o = acc + b;
  if (relu) o = fmaxf(o, 0.0f);
  o = rnd<T>(o);
  return r != nullptr ? rnd<T>(__fadd_rn(r[k], __fmul_rn(res_scale, o))) : o;
}

// (a, f32) tap products on the FMA pipes. Block = 16 tiles x 64 output
// channels; thread (j, cq) owns tile j and channels 4*cq..4*cq+3.
// V is [tap][ci][tile] with a padded row (conflict-free phase-1 stores).
constexpr int kF32Tiles = kThreads / kCoQuads;
constexpr int kF32Row = kF32Tiles + 1;

template <int M, bool kCoherent>
__device__ __forceinline__ void conv_tiles_f32(
    const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, int nimg, int h, int w, int relu, float res_scale,
    int tile0, float* vs) {                           // vs: [N*N][kC][kF32Row]
  constexpr int N = M + 2, TB = kF32Tiles;
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int tid = threadIdx.x;

  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ci = item % kC;
    float v[N][N];
    input_transform<float, M, kCoherent>(x, tile0 + j, ntiles, h, w, ci, v);
#pragma unroll
    for (int ti = 0; ti < N; ++ti)
#pragma unroll
      for (int tj = 0; tj < N; ++tj)
        vs[((ti * N + tj) * kC + ci) * kF32Row + j] = v[ti][tj];
  }
  __syncthreads();

  const int cq = tid % kCoQuads, j = tid / kCoQuads, co0 = cq * 4;
  float acc_y[4][M * M];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < M * M; ++k) acc_y[q][k] = 0.0f;
#pragma unroll
  for (int ti = 0; ti < N; ++ti) {
#pragma unroll
    for (int tj = 0; tj < N; ++tj) {
      const int t = ti * N + tj;
      const float* ut = u + (size_t)t * kC * kC + co0;
      const float* vt = vs + t * kC * kF32Row + j;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int ci = 0; ci < kC; ++ci) {
        float uf[4];
        load4(ut + ci * kC, uf);
        const float vf = vt[ci * kF32Row];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(vf, uf[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) fold_tap<M>(acc_y[q], acc[q], ti, tj);
    }
  }

  const int g = tile0 + j;
  if (g < ntiles) {
    const int im = g / (th * tw), rr = (g / tw) % th, cc = g % tw;
    float b[4];
    load4(bias + co0, b);
#pragma unroll
    for (int uu = 0; uu < M; ++uu) {
#pragma unroll
      for (int vv = 0; vv < M; ++vv) {
        const size_t off = (((size_t)im * h + rr * M + uu) * w + cc * M + vv) * kC + co0;
        float r[4], o[4];
        if (res != nullptr) load4(res + off, r);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = finish<float>(acc_y[q][uu * M + vv], b[q], relu,
                               res != nullptr ? r : nullptr, q, res_scale);
        store4(y + off, o);
      }
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
wino_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ bias, const float* __restrict__ res,
                     float* __restrict__ y, int nimg, int h, int w, int relu,
                     float res_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  conv_tiles_f32<M, false>(x, u, bias, res, y, nimg, h, w, relu, res_scale,
                           blockIdx.x * kF32Tiles, reinterpret_cast<float*>(smem_raw));
}

// (a, bf16) tap products on the tensor cores: mma.sync m16n8k16, bf16
// operands, f32 accumulate. Block = 16 tiles (one m16 fragment) x 64
// output channels, 8 warps; warp nb computes channels 8*nb..+7 (one n8
// fragment) of every tap and folds each tap into its registers' Y (4 pairs
// x m*m per thread). V is [tap][tile][ci] with a padded row, so the
// A-fragment loads are conflict-free; at m=4 it takes 83 KB, so two
// blocks share an SM and one block's loads overlap the other's tap
// products (measured on an H100: 15 % faster than 32 tiles per block,
// where one 166 KB block per SM ran its phases back to back). U arrives
// in fragment order (see sres_wino_conv): one coalesced 8-byte load per
// lane per (tap, n8 block, k-step).
template <int M, bool kCoherent>
__device__ __forceinline__ void conv_tiles_bf16(
    const bf16* __restrict__ x, const uint2* __restrict__ ufrag,
    const float* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ y, int nimg, int h, int w, int relu, float res_scale,
    int tile0, bf16* vs) {                            // vs: [N*N][TB][kMmaRow]
  constexpr int N = M + 2, TB = kMmaTiles;
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int tid = threadIdx.x;

  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ci = item % kC;
    float v[N][N];
    input_transform<bf16, M, kCoherent>(x, tile0 + j, ntiles, h, w, ci, v);
#pragma unroll
    for (int ti = 0; ti < N; ++ti)
#pragma unroll
      for (int tj = 0; tj < N; ++tj)
        vs[((ti * N + tj) * TB + j) * kMmaRow + ci] = __float2bfloat16_rn(v[ti][tj]);
  }
  __syncthreads();

  const int nb = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  // acc_y[r]: the C-fragment element r, i.e. tile gq + 8*(r >> 1),
  // channel 8*nb + 2*q4 + (r & 1)
  float acc_y[4][M * M];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < M * M; ++k) acc_y[r][k] = 0.0f;

#pragma unroll
  for (int ti = 0; ti < N; ++ti) {
#pragma unroll
    for (int tj = 0; tj < N; ++tj) {
      const int t = ti * N + tj;
      const bf16* va = vs + ((size_t)t * TB + gq) * kMmaRow + 2 * q4;
      const uint2* ub = ufrag + ((size_t)(t * 8 + nb) * 4) * 32 + lane;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(va + 16 * ks);
        a[1] = *reinterpret_cast<const uint32_t*>(va + 8 * kMmaRow + 16 * ks);
        a[2] = *reinterpret_cast<const uint32_t*>(va + 16 * ks + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(va + 8 * kMmaRow + 16 * ks + 8);
        const uint2 b = __ldg(ub + ks * 32);
        mma_bf16(c, a, b.x, b.y);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) fold_tap<M>(acc_y[r], c[r], ti, tj);
    }
  }

  const int co = 8 * nb + 2 * q4;
  const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int g = tile0 + gq + 8 * hr;
    if (g >= ntiles) continue;
    const int im = g / (th * tw), rr = (g / tw) % th, cc = g % tw;
#pragma unroll
    for (int uu = 0; uu < M; ++uu) {
#pragma unroll
      for (int vv = 0; vv < M; ++vv) {
        const size_t off =
            (((size_t)im * h + rr * M + uu) * w + cc * M + vv) * kC + co;
        float r[2];
        if (res != nullptr) {
          const uint32_t rw = *reinterpret_cast<const uint32_t*>(res + off);
          r[0] = lo_bf(rw);
          r[1] = hi_bf(rw);
        }
        const float* rp = res != nullptr ? r : nullptr;
        const float o0 = finish<bf16>(acc_y[2 * hr][uu * M + vv], b0, relu, rp, 0,
                                        res_scale);
        const float o1 = finish<bf16>(acc_y[2 * hr + 1][uu * M + vv], b1, relu, rp, 1,
                                        res_scale);
        // o0, o1 are bf16-representable: truncation is exact
        *reinterpret_cast<uint32_t*>(y + off) =
            (__float_as_uint(o0) >> 16) | (__float_as_uint(o1) & 0xffff0000u);
      }
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
wino_conv_bf16_kernel(const bf16* __restrict__ x, const uint2* __restrict__ ufrag,
                      const float* __restrict__ bias, const bf16* __restrict__ res,
                      bf16* __restrict__ y, int nimg, int h, int w, int relu,
                      float res_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  conv_tiles_bf16<M, false>(x, ufrag, bias, res, y, nimg, h, w, relu, res_scale,
                            blockIdx.x * kMmaTiles, reinterpret_cast<bf16*>(smem_raw));
}

// ------------------------------------------------ kernel (c): conv chain
// K convs (+ bias, + ReLU) in one persistent cooperative launch (replaces
// sres_tpu/ops/pallas/winograd_conv.py:_chain_fwd_kernel, :339). The TPU
// kernel keeps a sample block resident in VMEM across the K convs; here a
// 48x48x64 bf16 sample (288 KiB) does not fit an SM, so the activations
// ping-pong through device memory between y and one scratch buffer (2 x
// 21 MB at batch 72 in bf16: both fit the 50 MB L2) and a grid-wide
// barrier separates the convs. Each conv runs the tile-block code of
// kernel (a) over a grid-stride loop, so the chain equals K launches of
// kernel (a) bit for bit; what one launch saves is K - 1 launches and
// their host wrappers. Activations are read with ld.global.cg (coherent
// at L2 after the barrier). The grid is the co-resident maximum
// (occupancy x SMs), as a cooperative launch requires.
template <int M, typename T, typename U>
__global__ void __launch_bounds__(kThreads)
wino_chain_kernel(const T* x, const U* __restrict__ u, size_t ustride,
                  const float* __restrict__ bias, T* buf, T* y, int nchain,
                  int nimg, int h, int w, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int TB = kBf16 ? kMmaTiles : kF32Tiles;
  const int ntiles = nimg * (h / M) * (w / M);
  const int nblk = (ntiles + TB - 1) / TB;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < nchain; ++k) {
    // conv k writes y when nchain - 1 - k is even, else buf: the last conv
    // lands in y and no conv reads the buffer it writes
    const T* src = k == 0 ? x : ((nchain - k) % 2 == 0 ? y : buf);
    T* dst = (nchain - 1 - k) % 2 == 0 ? y : buf;
    for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
      if constexpr (kBf16)
        conv_tiles_bf16<M, true>(src, u + k * ustride, bias + k * kC, nullptr, dst,
                                 nimg, h, w, relu, 1.0f, blk * TB,
                                 reinterpret_cast<bf16*>(smem_raw));
      else
        conv_tiles_f32<M, true>(src, u + k * ustride, bias + k * kC, nullptr, dst,
                                nimg, h, w, relu, 1.0f, blk * TB,
                                reinterpret_cast<float*>(smem_raw));
      __syncthreads();                     // vs is rewritten by the next block
    }
    if (k + 1 < nchain) grid.sync();
  }
}

// ------------------------------------------- kernel (b): channel attention
// (b1) per-sample, per-channel partial sums of r over S spatial chunks
template <typename T>
__global__ void __launch_bounds__(kThreads)
ca_pool_kernel(const T* __restrict__ r, float* __restrict__ partial, int hw) {
  const int s = blockIdx.x, nsplit = gridDim.x, im = blockIdx.y;
  const int c = threadIdx.x % kC, lane = threadIdx.x / kC;
  constexpr int kLanes = kThreads / kC;
  const int p0 = (int)((long long)hw * s / nsplit);
  const int p1 = (int)((long long)hw * (s + 1) / nsplit);
  const T* rb = r + (size_t)im * hw * kC + c;
  float acc = 0.0f;
  for (int p = p0 + lane; p < p1; p += kLanes) acc += to_f(rb[(size_t)p * kC]);
  __shared__ float red[kThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < kC) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) t += red[l * kC + c];
    partial[((size_t)im * nsplit + s) * kC + c] = t;
  }
}

// (b2) gate = sigmoid(W2 relu(W1 mean + b1) + b2); out = q + r * gate.
// Every block recomputes its sample's gate from the partial sums (a few
// thousand MACs), then streams its share of the sample's elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ca_gate_skip_kernel(const T* __restrict__ q, const T* __restrict__ r,
                    const float* __restrict__ partial, int npart,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    T* __restrict__ out, int hw, int hidden, float inv_npix) {
  const int im = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  __shared__ float mean[kC], hid[kMaxHidden], gate[kC];
  if (tid < kC) {
    float t = 0.0f;
    for (int s = 0; s < npart; ++s) t += partial[((size_t)im * npart + s) * kC + tid];
    mean[tid] = t * inv_npix;
  }
  __syncthreads();
  if (tid < hidden) {
    float t = 0.0f;
    for (int c = 0; c < kC; ++c) t = fmaf(mean[c], w1[tid * kC + c], t);
    hid[tid] = fmaxf(t + b1[tid], 0.0f);
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(hid[k], w2[tid * hidden + k], t);
    gate[tid] = 1.0f / (1.0f + expf(-(t + b2[tid])));
  }
  __syncthreads();
  const long long per = (long long)hw * kC;
  const long long e0 = per * chunk / nchunk, e1 = per * (chunk + 1) / nchunk;
  const size_t base = (size_t)im * per;
  for (long long e = e0 + tid; e < e1; e += kThreads) {
    const float v = to_f(q[base + e]) + to_f(r[base + e]) * gate[e % kC];
    out[base + e] = from_f<T>(v);
  }
}

template <int M>
int launch_conv_f32(const void* x, const void* u, const float* bias, const void* res,
                    void* y, int nimg, int h, int w, int relu, float res_scale,
                    cudaStream_t stream) {
  const size_t smem = (size_t)(M + 2) * (M + 2) * kC * kF32Row * sizeof(float);
  static bool done = false;
  const cudaError_t e = allow_smem(wino_conv_f32_kernel<M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = nimg * (h / M) * (w / M);
  wino_conv_f32_kernel<M><<<(ntiles + kF32Tiles - 1) / kF32Tiles, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), bias,
      static_cast<const float*>(res), static_cast<float*>(y), nimg, h, w, relu, res_scale);
  return (int)cudaGetLastError();
}

template <int M>
int launch_conv_bf16(const void* x, const void* u, const float* bias, const void* res,
                     void* y, int nimg, int h, int w, int relu, float res_scale,
                     cudaStream_t stream) {
  const size_t smem = (size_t)(M + 2) * (M + 2) * kMmaTiles * kMmaRow * sizeof(bf16);
  static bool done = false;
  const cudaError_t e = allow_smem(wino_conv_bf16_kernel<M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = nimg * (h / M) * (w / M);
  wino_conv_bf16_kernel<M><<<(ntiles + kMmaTiles - 1) / kMmaTiles, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint2*>(u), bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(y), nimg, h, w, relu, res_scale);
  return (int)cudaGetLastError();
}

// The chain kernel's shared memory (kernel (a)'s, per dtype) and the
// co-resident blocks per SM it gets; 0 blocks is an error.
template <int M, typename T>
size_t chain_smem() {
  return std::is_same<T, bf16>::value
             ? (size_t)(M + 2) * (M + 2) * kMmaTiles * kMmaRow * sizeof(bf16)
             : (size_t)(M + 2) * (M + 2) * kC * kF32Row * sizeof(float);
}

template <int M, typename T, typename U>
cudaError_t chain_occupancy(int* blocks_per_sm) {
  const size_t smem = chain_smem<M, T>();
  static bool done = false;
  cudaError_t e = allow_smem(wino_chain_kernel<M, T, U>, smem, done);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wino_chain_kernel<M, T, U>, kThreads, smem);
  if (e == cudaSuccess && *blocks_per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  return e;
}

template <int M, typename T, typename U>
int launch_chain(const void* x, const void* u, const float* bias, void* buf, void* y,
                 int nchain, int nimg, int h, int w, int relu, int device,
                 cudaStream_t stream) {
  int per_sm = 0, nsm = 0, coop = 0;
  cudaError_t e = chain_occupancy<M, T, U>(&per_sm);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  constexpr int TB = std::is_same<T, bf16>::value ? kMmaTiles : kF32Tiles;
  const int nblk = (nimg * (h / M) * (w / M) + TB - 1) / TB;
  const int grid = std::max(1, std::min(nblk, per_sm * nsm));
  // U per conv: n*n*64*64 elements, in units of U (uint2 = 4 bf16 values)
  const size_t ustride = (size_t)(M + 2) * (M + 2) * kC * kC * sizeof(T) / sizeof(U);
  const T* xp = static_cast<const T*>(x);
  const U* up = static_cast<const U*>(u);
  T* bp = static_cast<T*>(buf);
  T* yp = static_cast<T*>(y);
  void* args[] = {(void*)&xp, (void*)&up, (void*)&ustride, (void*)&bias, (void*)&bp,
                  (void*)&yp, (void*)&nchain, (void*)&nimg, (void*)&h, (void*)&w,
                  (void*)&relu};
  e = cudaLaunchCooperativeKernel((const void*)wino_chain_kernel<M, T, U>, dim3(grid),
                                  dim3(kThreads), args, chain_smem<M, T>(), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ca(const void* q, const void* r, const float* w1, const float* b1,
              const float* w2, const float* b2, float* partial, void* out,
              int nimg, int hw, int hidden, int npart, int nchunk,
              cudaStream_t stream) {
  ca_pool_kernel<T><<<dim3(npart, nimg), kThreads, 0, stream>>>(
      static_cast<const T*>(r), partial, hw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ca_gate_skip_kernel<T><<<dim3(nchunk, nimg), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(r), partial, npart, w1, b1,
      w2, b2, static_cast<T*>(out), hw, hidden, 1.0f / (float)hw);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" {

int sres_channels() { return kC; }
int sres_max_hidden() { return kMaxHidden; }

const char* sres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, res, y: (nimg, h, w, 64) NHWC of float (bf16_ = 0) or bf16 (bf16_ = 1);
// bias: (64,) f32; res may be null. u holds U = (n*n, Cin=64, Cout=64):
// for float as it is; for bf16 in mma fragment order, element
// U[t][16*ks + 8*hh + 2*q + e][8*nb + g] at [t][nb][ks][g][q][hh][e]
// (g, q: the lane's group and index in group; hh, e: register and half).
// With res: y = res + res_scale * conv (the scaled residual epilogue).
int sres_wino_conv(const void* x, const void* u, const float* bias,
                   const void* res, void* y, int nimg, int h, int w, int m,
                   int bf16_, int relu, float res_scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((m != 2 && m != 4) || h % m || w % m) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return m == 4 ? launch_conv_bf16<4>(x, u, bias, res, y, nimg, h, w, relu, res_scale, s)
                  : launch_conv_bf16<2>(x, u, bias, res, y, nimg, h, w, relu, res_scale, s);
  return m == 4 ? launch_conv_f32<4>(x, u, bias, res, y, nimg, h, w, relu, res_scale, s)
                : launch_conv_f32<2>(x, u, bias, res, y, nimg, h, w, relu, res_scale, s);
}

// nchain convs (+ bias, + ReLU when relu) in one cooperative launch:
// x, buf, y (nimg, h, w, 64) NHWC of float or bf16, buf scratch (unused
// when nchain is 1); u: nchain U operands back to back, each as
// sres_wino_conv takes it; bias (nchain, 64) f32. x is not written.
int sres_wino_chain(const void* x, const void* u, const float* bias, void* buf,
                    void* y, int nchain, int nimg, int h, int w, int m, int bf16_,
                    int relu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((m != 2 && m != 4) || h % m || w % m || nchain < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return m == 4 ? launch_chain<4, bf16, uint2>(x, u, bias, buf, y, nchain, nimg, h, w,
                                                 relu, device, s)
                  : launch_chain<2, bf16, uint2>(x, u, bias, buf, y, nchain, nimg, h, w,
                                                 relu, device, s);
  return m == 4 ? launch_chain<4, float, float>(x, u, bias, buf, y, nchain, nimg, h, w,
                                                relu, device, s)
                : launch_chain<2, float, float>(x, u, bias, buf, y, nchain, nimg, h, w,
                                                relu, device, s);
}

// q, r, out: (nimg, hw, 64) NHWC; w1: (hidden, 64), b1: (hidden,),
// w2: (64, hidden), b2: (64,) f32; partial: (nimg, npart, 64) f32 scratch.
int sres_ca_skip(const void* q, const void* r, const float* w1, const float* b1,
                 const float* w2, const float* b2, float* partial, void* out,
                 int nimg, int hw, int hidden, int npart, int nchunk, int bf16_,
                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_ca<bf16>(q, r, w1, b1, w2, b2, partial, out, nimg, hw, hidden,
                           npart, nchunk, s);
  return launch_ca<float>(q, r, w1, b1, w2, b2, partial, out, nimg, hw, hidden,
                          npart, nchunk, s);
}

}  // extern "C"
