// Fused window multi-head attention for Hopper (SwinIR), forward and backward.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/window_attention.py:_fwd_kernel (:74, pallas_call :154)
//   sres_tpu/ops/pallas/window_attention.py:_bwd_kernel (:84, pallas_call :195)
// Per window of T = 64 tokens (8x8) and C = 64 channels: qkv = x.Wqkv + b;
// per head s = q.k^T * hd^-1/2 + bias[h] (+ mask[w % nm]), p = softmax(s),
// o_h = p.v_h; y = o.Wo + bo. The backward recomputes the forward and
// returns dx and the weight gradients summed over the windows.
//
// Layout: x, g, y, dx are (NW, T, C) row-major in the activation type T
// (float or bf16); Wqkv (C, 3C) and Wo (C, C) in T; bqkv, bo, bias (h, T, T)
// and the group mask (nm, T, T) in f32. Rounding points: see
// sres_tpu_torch/ops/window_attention.py (q, k, v, p, o, do, ds*hd^-1/2 and
// dqkv round to T; scores, softmax, dp, ds and every sum stay f32).
//
// Design (simple and right first): one 256-thread block per window keeps
// every per-window operand in shared memory (x, qkv, one head's f32 scores,
// o: 64 KB in bf16), so none of the six (NW, T, C)-sized intermediates the
// composition writes reaches device memory. All products are block_gemm
// calls: bf16 on mma.sync m16n8k16 with f32 accumulation (operands gathered
// element by element, so one routine serves every transpose), f32 on FMAs
// (the f32 mode exists for exact checks). The weights are read through L1
// from device memory. T = 64 is small, so each softmax row is one warp.
//
// The weight gradients are sums over all windows. On the TPU the grid ran
// in order and accumulated them in resident output blocks; here the
// backward runs one persistent block per SM, each walking its share of the
// windows and adding into its own f32 partial in device memory (no other
// block touches it, and each element is always updated by the same thread,
// so there are no atomics), then sum_partials_kernel adds the partials in
// a fixed order: every run gives the same bits.
//
// What bounds them on this card (batch 12: NW = 1728): the forward moves
// x and y (14.2 MB each in bf16) plus the group mask; its products are
// 5.4 GFLOP; bytes bound it. The backward reads x and g and writes dx
// (42.5 MB) and does 2.8x the products; the two bounds are close. This
// first design is bound by neither. Measured on an H100 SXM (700 W) at
// 1728 windows in bf16: forward 0.56 ms, backward 2.5 ms, 61x and 162x
// their bounds, both slower than cuDNN's fused attention composed with
// two GEMMs. Suspects: scalar fragment gathers with bank conflicts,
// weights, bias and mask read per element inside the product loops,
// runtime product shapes, and in the backward one 8-warp block per SM and
// 132 KB of (L2-resident) partials updated per window. Later work.

#include "wino_common.cuh"

namespace {

constexpr int kT = 64;              // tokens per window
constexpr int kC3 = 3 * kC;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 32;          // head widths 16 and 32 (h = 4, 2)

// ------------------------------------------------------------ block GEMMs
// C[m][n] = sum_k A(m, k) B(k, n) for an M x N x K block product with
// A(m, k) = a[m * sam + k * sak] and B(k, n) = b[k * sbk + n * sbn] (shared
// or device memory); ep(m, n, value) is called once per output element, by
// the same thread for the same (M, N, K) on every call.

// bf16: warp w takes the 16 x 8 tiles w, w + 8, ...; M, N, K multiples of
// 16, 8, 16.
template <typename Ep>
__device__ __forceinline__ void block_gemm(const bf16* a, int sam, int sak,
                                           const bf16* b, int sbk, int sbn,
                                           int M, int N, int K, Ep ep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q4 = lane & 3;
  const int ntn = N / 8, ntiles = (M / 16) * ntn;
  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int m0 = (tile / ntn) * 16, n0 = (tile % ntn) * 8;
    const bf16* ar0 = a + (size_t)(m0 + gq) * sam;
    const bf16* ar1 = ar0 + (size_t)8 * sam;
    const bf16* bc = b + (size_t)(n0 + gq) * sbn;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * q4, kb = ka + 8;
      uint32_t af[4];
      af[0] = pack_bf(ar0[ka * sak], ar0[(ka + 1) * sak]);
      af[1] = pack_bf(ar1[ka * sak], ar1[(ka + 1) * sak]);
      af[2] = pack_bf(ar0[kb * sak], ar0[(kb + 1) * sak]);
      af[3] = pack_bf(ar1[kb * sak], ar1[(kb + 1) * sak]);
      mma_bf16(c, af, pack_bf(bc[ka * sbk], bc[(ka + 1) * sbk]),
               pack_bf(bc[kb * sbk], bc[(kb + 1) * sbk]));
    }
    ep(m0 + gq, n0 + 2 * q4, c[0]);
    ep(m0 + gq, n0 + 2 * q4 + 1, c[1]);
    ep(m0 + gq + 8, n0 + 2 * q4, c[2]);
    ep(m0 + gq + 8, n0 + 2 * q4 + 1, c[3]);
  }
}

// f32: thread t takes elements t, t + 256, ...; k summed in order.
template <typename Ep>
__device__ __forceinline__ void block_gemm(const float* a, int sam, int sak,
                                           const float* b, int sbk, int sbn,
                                           int M, int N, int K, Ep ep) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    const float* ar = a + (size_t)m * sam;
    const float* bc = b + (size_t)n * sbn;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(ar[k * sak], bc[k * sbk], acc);
    ep(m, n, acc);
  }
}

// ------------------------------------------------------------ pieces
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ src, T* dst) {
  for (int e = threadIdx.x; e < kT * kC; e += kThreads) dst[e] = src[e];
}

// One head's scores into s (f32), then its softmax: p (f32) in s and p
// rounded to T in pb. Warp w owns rows w, w + 8, ...; lane l columns l and
// l + 32.
template <typename T>
__device__ void head_softmax(const T* qkv, const float* bias_h, const float* maskw,
                             float* s, T* pb, int hh, int hd, float scale) {
  block_gemm(qkv + hh * hd, kC3, 1, qkv + kC + hh * hd, 1, kC3, kT, kT, hd,
             [&](int m, int n, float v) {
               float val = v * scale + bias_h[m * kT + n];
               if (maskw != nullptr) val += maskw[m * kT + n];
               s[m * kT + n] = val;
             });
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kT; r += kWarps) {
    float* row = s + r * kT;
    const float v0 = row[lane], v1 = row[lane + 32];
    float mx = fmaxf(v0, v1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e0 = expf(v0 - mx), e1 = expf(v1 - mx);
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p0 = e0 / sum, p1 = e1 / sum;
    row[lane] = p0;
    row[lane + 32] = p1;
    pb[r * kT + lane] = from_f<T>(p0);
    pb[r * kT + lane + 32] = from_f<T>(p1);
  }
  __syncthreads();
}

// The attention of one window up to o: qkv (rounded to T), then per head
// the softmax and o_h = p.v_h, rounded to T into os.
template <typename T>
__device__ void attend(const T* xs, const T* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const float* __restrict__ bias,
                       const float* maskw, T* qkv, float* s, T* pb, T* os,
                       int heads, float scale) {
  block_gemm(xs, kC, 1, wqkv, kC3, 1, kT, kC3, kC, [&](int m, int n, float v) {
    qkv[m * kC3 + n] = from_f<T>(v + bqkv[n]);
  });
  __syncthreads();
  const int hd = kC / heads;
  for (int hh = 0; hh < heads; ++hh) {
    head_softmax(qkv, bias + hh * kT * kT, maskw, s, pb, hh, hd, scale);
    block_gemm(pb, kT, 1, qkv + 2 * kC + hh * hd, kC3, 1, kT, hd, kT,
               [&](int m, int n, float v) { os[m * kC + hh * hd + n] = from_f<T>(v); });
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward
// Shared memory: s [T][T] f32, then xs [T][C], os [T][C], pb [T][T],
// qkv [T][3C] in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wattn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                 const float* __restrict__ bqkv, const T* __restrict__ wo,
                 const float* __restrict__ bo, const float* __restrict__ bias,
                 const float* __restrict__ mask, T* __restrict__ y, int nm,
                 int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);
  T* xs = reinterpret_cast<T*>(s + kT * kT);
  T* os = xs + kT * kC;
  T* pb = os + kT * kC;
  T* qkv = pb + kT * kT;
  const int w = blockIdx.x;
  const float* maskw = mask != nullptr ? mask + (size_t)(w % nm) * kT * kT : nullptr;
  load_window(x + (size_t)w * kT * kC, xs);
  __syncthreads();
  attend(xs, wqkv, bqkv, bias, maskw, qkv, s, pb, os, heads, scale);
  T* yw = y + (size_t)w * kT * kC;
  block_gemm(os, kC, 1, wo, kC, 1, kT, kC, kC, [&](int m, int n, float v) {
    yw[m * kC + n] = from_f<T>(v + bo[n]);
  });
}

// --------------------------------------------------------------- backward
// Shared memory: s, dp [T][T] f32, hs [T][3 hd] f32 (one head's dq | dk |
// dv), then xs, gs, os [T][C], pb [T][T], qkv, dqkv [T][3C] in T. os holds
// o, then do; pb holds p, then ds * hd^-1/2.
// part: per block, f32 [dWqkv C*3C | dbqkv 3C | dWo C*C | dbo C | dbias h*T*T].
template <typename T>
__global__ void __launch_bounds__(kThreads)
wattn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                 const float* __restrict__ bqkv, const T* __restrict__ wo,
                 const float* __restrict__ bias, const float* __restrict__ mask,
                 const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                 int nw, int nm, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = kC / heads, h3 = 3 * hd, tid = threadIdx.x;
  float* s = reinterpret_cast<float*>(smem_raw);
  float* dp = s + kT * kT;
  float* hs = dp + kT * kT;
  T* xs = reinterpret_cast<T*>(hs + kT * 3 * kMaxHd);
  T* gs = xs + kT * kC;
  T* os = gs + kT * kC;
  T* pb = os + kT * kC;
  T* qkv = pb + kT * kT;
  T* dqkv = qkv + kT * kC3;

  const int width = kC * kC3 + kC3 + kC * kC + kC + heads * kT * kT;
  float* pdwqkv = part + (size_t)blockIdx.x * width;
  float* pdbqkv = pdwqkv + kC * kC3;
  float* pdwo = pdbqkv + kC3;
  float* pdbo = pdwo + kC * kC;
  float* pdbias = pdbo + kC;
  for (int e = tid; e < width; e += kThreads) pdwqkv[e] = 0.0f;

  for (int w = blockIdx.x; w < nw; w += gridDim.x) {
    __syncthreads();   // the zeroing, or the previous window's last reads
    const float* maskw = mask != nullptr ? mask + (size_t)(w % nm) * kT * kT : nullptr;
    load_window(x + (size_t)w * kT * kC, xs);
    load_window(g + (size_t)w * kT * kC, gs);
    __syncthreads();
    attend(xs, wqkv, bqkv, bias, maskw, qkv, s, pb, os, heads, scale);

    // output projection: dWo += o^T g, dbo += sum_t g, then do = g Wo^T
    block_gemm(os, 1, kC, gs, kC, 1, kC, kC, kT,
               [&](int m, int n, float v) { pdwo[m * kC + n] += v; });
    if (tid < kC) {
      float t = 0.0f;
      for (int r = 0; r < kT; ++r) t += to_f(gs[r * kC + tid]);
      pdbo[tid] += t;
    }
    __syncthreads();
    block_gemm(gs, kC, 1, wo, 1, kC, kT, kC, kC,
               [&](int m, int n, float v) { os[m * kC + n] = from_f<T>(v); });
    __syncthreads();

    for (int hh = 0; hh < heads; ++hh) {
      const T* q = qkv + hh * hd;
      const T* k = q + kC;
      const T* v = q + 2 * kC;
      head_softmax(qkv, bias + hh * kT * kT, maskw, s, pb, hh, hd, scale);
      // dv = p^T do_h; dp = do_h v^T
      block_gemm(pb, 1, kT, os + hh * hd, kC, 1, kT, hd, kT,
                 [&](int m, int n, float val) { hs[m * h3 + 2 * hd + n] = val; });
      block_gemm(os + hh * hd, kC, 1, v, 1, kC3, kT, kT, hd,
                 [&](int m, int n, float val) { dp[m * kT + n] = val; });
      __syncthreads();
      // ds = p (dp - rowsum(dp p)); dbias += ds; pb = ds * hd^-1/2 in T
      {
        const int warp = tid >> 5, lane = tid & 31;
        float* pdb = pdbias + hh * kT * kT;
        for (int r = warp; r < kT; r += kWarps) {
          const float p0 = s[r * kT + lane], p1 = s[r * kT + lane + 32];
          const float d0 = dp[r * kT + lane], d1 = dp[r * kT + lane + 32];
          float rs = p0 * d0 + p1 * d1;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
          const float ds0 = p0 * (d0 - rs), ds1 = p1 * (d1 - rs);
          pdb[r * kT + lane] += ds0;
          pdb[r * kT + lane + 32] += ds1;
          pb[r * kT + lane] = from_f<T>(ds0 * scale);
          pb[r * kT + lane + 32] = from_f<T>(ds1 * scale);
        }
      }
      __syncthreads();
      // dq = ds k; dk = ds^T q
      block_gemm(pb, kT, 1, k, kC3, 1, kT, hd, kT,
                 [&](int m, int n, float val) { hs[m * h3 + n] = val; });
      block_gemm(pb, 1, kT, q, kC3, 1, kT, hd, kT,
                 [&](int m, int n, float val) { hs[m * h3 + hd + n] = val; });
      __syncthreads();
      // dbqkv += the column sums of the f32 dq | dk | dv; dqkv = them in T
      for (int j = tid; j < h3; j += kThreads) {
        float t = 0.0f;
        for (int r = 0; r < kT; ++r) t += hs[r * h3 + j];
        pdbqkv[(j / hd) * kC + hh * hd + j % hd] += t;
      }
      for (int e = tid; e < kT * h3; e += kThreads) {
        const int r = e / h3, j = e % h3;
        dqkv[r * kC3 + (j / hd) * kC + hh * hd + j % hd] = from_f<T>(hs[e]);
      }
      __syncthreads();
    }

    // QKV projection: dWqkv += x^T dqkv, dx = dqkv Wqkv^T
    block_gemm(xs, 1, kC, dqkv, kC3, 1, kC, kC3, kT,
               [&](int m, int n, float v) { pdwqkv[m * kC3 + n] += v; });
    T* dxw = dx + (size_t)w * kT * kC;
    block_gemm(dqkv, kC3, 1, wqkv, 1, kC3, kT, kC, kC3,
               [&](int m, int n, float v) { dxw[m * kC + n] = from_f<T>(v); });
  }
}

template <typename T>
size_t fwd_smem() {
  return (size_t)kT * kT * sizeof(float) + (size_t)kT * (2 * kC + kT + kC3) * sizeof(T);
}

template <typename T>
size_t bwd_smem() {
  return (size_t)kT * (2 * kT + 3 * kMaxHd) * sizeof(float) +
         (size_t)kT * (3 * kC + kT + 2 * kC3) * sizeof(T);
}

template <typename T>
int launch_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
               const float* bo, const float* bias, const float* mask, void* y,
               int nw, int nm, int heads, float scale, cudaStream_t stream) {
  static bool done = false;
  const cudaError_t e = allow_smem(wattn_fwd_kernel<T>, fwd_smem<T>(), done);
  if (e != cudaSuccess) return (int)e;
  wattn_fwd_kernel<T><<<nw, kThreads, fwd_smem<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wo), bo, bias, mask, static_cast<T*>(y), nm, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
               const float* bias, const float* mask, const void* g, void* dx,
               float* part, float* grads, int nw, int nm, int heads, int nblk,
               float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t e = allow_smem(wattn_bwd_kernel<T>, bwd_smem<T>(), done);
  if (e != cudaSuccess) return (int)e;
  wattn_bwd_kernel<T><<<nblk, kThreads, bwd_smem<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wo), bias, mask, static_cast<const T*>(g),
      static_cast<T*>(dx), part, nw, nm, heads, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int width = kC * kC3 + kC3 + kC * kC + kC + heads * kT * kT;
  sum_partials_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, grads, 1, nblk, width);
  return (int)cudaGetLastError();
}

bool bad_shape(int nw, int nm, const float* mask, int heads) {
  const int hd = heads > 0 ? kC / heads : 0;
  return nw < 1 || heads < 1 || kC % heads || hd % 16 || hd > kMaxHd ||
         (mask != nullptr) != (nm > 0) || (nm > 0 && nw % nm);
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" {

int sres_wattn_tokens() { return kT; }

// x, y: (nw, 64, 64) of float (bf16_ = 0) or bf16 (bf16_ = 1); wqkv (64,
// 192) and wo (64, 64) of the same type; bqkv (192,), bo (64,), bias
// (heads, 64, 64) f32; mask: null (nm = 0) or (nm, 64, 64) f32, window w
// reading mask[w % nm]. heads in {2, 4}; scale = (64 / heads)^-1/2.
int sres_wattn_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                   const float* bo, const float* bias, const float* mask, void* y,
                   int nw, int nm, int heads, float scale, int bf16_, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(nw, nm, mask, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_fwd<bf16>(x, wqkv, bqkv, wo, bo, bias, mask, y, nw, nm, heads, scale, s);
  return launch_fwd<float>(x, wqkv, bqkv, wo, bo, bias, mask, y, nw, nm, heads, scale, s);
}

// As sres_wattn_fwd, plus g (the cotangent of y) and dx, both like x; bo
// is not read. Scratch: part (nblk, W) f32 with W = 4*64*64 + 4*64 +
// heads*64*64. Out: grads (W,) f32 = [dWqkv (64, 192) | dbqkv (192,) |
// dWo (64, 64) | dbo (64,) | dbias (heads, 64, 64)], summed over the windows.
int sres_wattn_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                   const float* bo, const float* bias, const float* mask,
                   const void* g, void* dx, float* part, float* grads, int nw,
                   int nm, int heads, float scale, int nblk, int bf16_, int device,
                   void* stream) {
  (void)bo;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(nw, nm, mask, heads) || nblk < 1 || nblk > nw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_bwd<bf16>(x, wqkv, bqkv, wo, bias, mask, g, dx, part, grads, nw, nm,
                            heads, nblk, scale, s);
  return launch_bwd<float>(x, wqkv, bqkv, wo, bias, mask, g, dx, part, grads, nw, nm,
                           heads, nblk, scale, s);
}

}  // extern "C"
