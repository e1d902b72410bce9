// Winograd F(m x m, 3 x 3) convolution and RCAB channel attention for Hopper.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/winograd_conv.py:_fwd_kernel        (wino_conv_quad forward)
//   sres_tpu/ops/pallas/winograd_conv.py:_group_fwd_kernel  (RCAB chain: conv unit
//       :492-525, channel attention + block skip :533-549, trailing conv :554-560)
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // channels in and out
constexpr int kThreads = 256;   // threads per block, every kernel
constexpr int kCoQuads = kC / 4;
constexpr int kMaxHidden = 64;  // channel-attention bottleneck width bound

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- type help
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// bf16 pair in one 32-bit word -> two floats (element 0 in the low half)
__device__ __forceinline__ float lo_bf(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// four consecutive floats from global memory (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// ---------------------------------------------------- transform programs
// The straight-line programs of sres_tpu/ops/winograd.py:bt_apply, in the
// same operation order: out[i] = sum_q BT[i][q] * d[q].
template <int M> __device__ __forceinline__ void bt_apply(const float* f, float* o);
template <> __device__ __forceinline__ void bt_apply<2>(const float* f, float* o) {
  o[0] = f[0] - f[2];
  o[1] = f[1] + f[2];
  o[2] = f[2] - f[1];
  o[3] = f[1] - f[3];
}
template <> __device__ __forceinline__ void bt_apply<4>(const float* f, float* o) {
  const float p = f[4] - 4.0f * f[2];
  const float q = 4.0f * f[1] - f[3];
  const float s = f[4] - f[2];
  const float t = 2.0f * (f[1] - f[3]);
  o[0] = 4.0f * f[0] - 5.0f * f[2] + f[4];
  o[1] = p - q;
  o[2] = p + q;
  o[3] = s - t;
  o[4] = s + t;
  o[5] = 4.0f * f[1] - 5.0f * f[3] + f[5];
}

// A^T coefficients (sres_tpu/ops/winograd.py:_AT2/_AT4); called with
// compile-time indices only, so every lookup folds to a constant.
template <int M> __device__ __forceinline__ float at_coef(int u, int i);
template <> __device__ __forceinline__ float at_coef<2>(int u, int i) {
  const float t[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
  return t[u][i];
}
template <> __device__ __forceinline__ float at_coef<4>(int u, int i) {
  const float t[4][6] = {{1, 1, 1, 1, 1, 0},
                         {0, 1, -1, 2, -2, 0},
                         {0, 1, 1, 4, 4, 0},
                         {0, 1, -1, 8, -8, 1}};
  return t[u][i];
}

// ------------------------------------------------------ kernel (a): conv
// Phase 1, shared by both conv kernels: V = BT . d . B of one (tile, input
// channel), SAME zero padding, each stage rounded to T. The n*n loads are
// unconditional (clamped address, zeroed value) so all are in flight at once.
template <typename T, int M>
__device__ __forceinline__ void input_transform(const T* __restrict__ x, int g,
                                                int ntiles, int h, int w, int ci,
                                                float (&v)[M + 2][M + 2]) {
  constexpr int N = M + 2;
  const int th = h / M, tw = w / M;
  const bool valid = g < ntiles;
  const int gg = valid ? g : 0;
  const int im = gg / (th * tw), rr = (gg / tw) % th, cc = gg % tw;
  const int y0 = rr * M - 1, x0 = cc * M - 1;
  const T* xb = x + (size_t)im * h * w * kC + ci;
  float d[N][N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const int yy = y0 + p;
    const int yc = min(max(yy, 0), h - 1);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int xx = x0 + q;
      const int xc = min(max(xx, 0), w - 1);
      const float val = to_f(xb[((size_t)yc * w + xc) * kC]);
      d[p][q] = (valid && yy == yc && xx == xc) ? val : 0.0f;
    }
  }
  float w1[N][N];                                    // w1[p][tj]
#pragma unroll
  for (int p = 0; p < N; ++p) {
    bt_apply<M>(d[p], w1[p]);
#pragma unroll
    for (int q = 0; q < N; ++q) w1[p][q] = rnd<T>(w1[p][q]);
  }
#pragma unroll
  for (int tj = 0; tj < N; ++tj) {
    float col[N], out[N];
#pragma unroll
    for (int p = 0; p < N; ++p) col[p] = w1[p][tj];
    bt_apply<M>(col, out);
#pragma unroll
    for (int ti = 0; ti < N; ++ti) v[ti][tj] = rnd<T>(out[ti]);
  }
}

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

// Epilogue value: + bias (+ ReLU), round to T, optional residual sum.
template <typename T>
__device__ __forceinline__ float finish(float acc, float b, int relu,
                                        const float* r, int k) {
  float o = acc + b;
  if (relu) o = fmaxf(o, 0.0f);
  o = rnd<T>(o);
  return r != nullptr ? rnd<T>(r[k] + o) : o;
}

// (a, f32) tap products on the FMA pipes. Block = 16 tiles x 64 output
// channels; thread (j, cq) owns tile j and channels 4*cq..4*cq+3.
// V is [tap][ci][tile] with a padded row (conflict-free phase-1 stores).
constexpr int kF32Tiles = kThreads / kCoQuads;
constexpr int kF32Row = kF32Tiles + 1;

template <int M>
__global__ void __launch_bounds__(kThreads)
wino_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ bias, const float* __restrict__ res,
                     float* __restrict__ y, int nimg, int h, int w, int relu) {
  constexpr int N = M + 2, TB = kF32Tiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* vs = reinterpret_cast<float*>(smem_raw);      // [N*N][kC][kF32Row]
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int tile0 = blockIdx.x * TB, tid = threadIdx.x;

  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ci = item % kC;
    float v[N][N];
    input_transform<float, M>(x, tile0 + j, ntiles, h, w, ci, v);
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
  if (g >= ntiles) return;
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
                             res != nullptr ? r : nullptr, q);
      store4(y + off, o);
    }
  }
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
constexpr int kMmaTiles = 16;
constexpr int kMmaRow = kC + 8;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int M>
__global__ void __launch_bounds__(kThreads)
wino_conv_bf16_kernel(const bf16* __restrict__ x, const uint2* __restrict__ ufrag,
                      const float* __restrict__ bias, const bf16* __restrict__ res,
                      bf16* __restrict__ y, int nimg, int h, int w, int relu) {
  constexpr int N = M + 2, TB = kMmaTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* vs = reinterpret_cast<bf16*>(smem_raw);        // [N*N][TB][kMmaRow]
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int tile0 = blockIdx.x * TB, tid = threadIdx.x;

  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ci = item % kC;
    float v[N][N];
    input_transform<bf16, M>(x, tile0 + j, ntiles, h, w, ci, v);
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
        const float o0 = finish<bf16>(acc_y[2 * hr][uu * M + vv], b0, relu, rp, 0);
        const float o1 = finish<bf16>(acc_y[2 * hr + 1][uu * M + vv], b1, relu, rp, 1);
        // o0, o1 are bf16-representable: truncation is exact
        *reinterpret_cast<uint32_t*>(y + off) =
            (__float_as_uint(o0) >> 16) | (__float_as_uint(o1) & 0xffff0000u);
      }
    }
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

// Opt in to more than 48 KB of dynamic shared memory, once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

template <int M>
int launch_conv_f32(const void* x, const void* u, const float* bias, const void* res,
                    void* y, int nimg, int h, int w, int relu, cudaStream_t stream) {
  const size_t smem = (size_t)(M + 2) * (M + 2) * kC * kF32Row * sizeof(float);
  static bool done = false;
  const cudaError_t e = allow_smem(wino_conv_f32_kernel<M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = nimg * (h / M) * (w / M);
  wino_conv_f32_kernel<M><<<(ntiles + kF32Tiles - 1) / kF32Tiles, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), bias,
      static_cast<const float*>(res), static_cast<float*>(y), nimg, h, w, relu);
  return (int)cudaGetLastError();
}

template <int M>
int launch_conv_bf16(const void* x, const void* u, const float* bias, const void* res,
                     void* y, int nimg, int h, int w, int relu, cudaStream_t stream) {
  const size_t smem = (size_t)(M + 2) * (M + 2) * kMmaTiles * kMmaRow * sizeof(bf16);
  static bool done = false;
  const cudaError_t e = allow_smem(wino_conv_bf16_kernel<M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = nimg * (h / M) * (w / M);
  wino_conv_bf16_kernel<M><<<(ntiles + kMmaTiles - 1) / kMmaTiles, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint2*>(u), bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(y), nimg, h, w, relu);
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
int sres_wino_conv(const void* x, const void* u, const float* bias,
                   const void* res, void* y, int nimg, int h, int w, int m,
                   int bf16_, int relu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((m != 2 && m != 4) || h % m || w % m) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return m == 4 ? launch_conv_bf16<4>(x, u, bias, res, y, nimg, h, w, relu, s)
                  : launch_conv_bf16<2>(x, u, bias, res, y, nimg, h, w, relu, s);
  return m == 4 ? launch_conv_f32<4>(x, u, bias, res, y, nimg, h, w, relu, s)
                : launch_conv_f32<2>(x, u, bias, res, y, nimg, h, w, relu, s);
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
