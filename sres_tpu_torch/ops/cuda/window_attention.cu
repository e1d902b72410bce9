// Fused window multi-head attention for Hopper (SwinIR), forward and backward.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/window_attention.py:_fwd_kernel (:74, pallas_call :154)
//   sres_tpu/ops/pallas/window_attention.py:_bwd_kernel (:84, pallas_call :195)
// Two sets of kernels, one function: the whole-window kernels at T = 64
// (8x8 windows) and the tiled kernels at any other T that is a multiple of
// 16 up to 256 (4x4, 12x12 and 16x16 windows; see "tiled T" below).
// Per window of T tokens and C = 64 channels: qkv = x.Wqkv + b;
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
// Design of the T = 64 kernels (simple and right first): one 256-thread
// block per window keeps every per-window operand in shared memory (x,
// qkv, one head's f32 scores, o: 64 KB in bf16), so none of the six (NW,
// T, C)-sized intermediates the composition writes reaches device memory.
// All products are tile_gemm calls: bf16 on mma.sync m16n8k16 with f32
// accumulation (operands gathered element by element, so one routine
// serves every transpose), f32 on FMAs (the f32 mode exists for exact
// checks). The weights are read through L1 from device memory. T = 64 is
// small, so each softmax row is one warp.
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
//
// What bounds the tiled kernels (SwinIR-w16 at batch 12: 432 windows of T
// = 256, 4 heads, shifted): the forward moves x and y (14.2 MB each in
// bf16), the 36-window group mask (9.4 MB) and the (h, T, T) bias (1 MB),
// 0.0116 ms at 3.35 TB/s; its 10.9 GFLOP of products take 0.0110 ms, so
// bytes bound it, narrowly. The backward's 31.7 GFLOP (recompute, six
// attention products, the projections' adjoints) take 0.032 ms and bound
// it; its bytes take 0.016 ms. The design spends more than either: q, k,
// v and do go through a device-memory stash (56.6 MB at this shape in
// bf16) that the dbias kernel's 64 row blocks each read again, the dbias
// kernel recomputes the scores and dp, and every product gathers its
// operands element by element as above. Measured on an H100 SXM (700 W),
// bf16, shifted: forward 2.23 ms, backward 11.1 ms (7.4 main kernel, 2.2
// dbias kernel), 190x and 350x their bounds, and 2.6x and 4.8x the
// F.scaled_dot_product_attention composition. Later work.

#include <math_constants.h>
#include <type_traits>

#include "wino_common.cuh"

namespace {

constexpr int kT = 64;              // tokens per window
constexpr int kC3 = 3 * kC;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 32;          // head widths 16 and 32 (h = 4, 2)

// ------------------------------------------------------------ block GEMMs
// C[m][n] = sum_k A(m, k) B(k, n) for an M x N x K block product with
// A(m, k) = a[m * sam + k * sak] and B(k, n) = b[k * sbk + n * sbn] (shared
// or device memory, of either element type); ep(m, n, value) is called once
// per output element, by the same thread for the same (M, N) on every call.
// Mode bf16: mma.sync m16n8k16 with f32 accumulation, each operand rounded
// to bf16 as it is gathered (element by element, so one routine serves
// every transpose); warp w takes the 16 x 8 tiles w, w + 8, ...; M, N, K
// multiples of 16, 8, 16. Mode float: FMAs, thread t takes elements t,
// t + 256, ...; k summed in order.
__device__ __forceinline__ bf16 to_bf(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16_rn(v); }

template <typename Mode, typename TA, typename TB, typename Ep>
__device__ __forceinline__ void tile_gemm(const TA* a, int sam, int sak,
                                          const TB* b, int sbk, int sbn,
                                          int M, int N, int K, Ep ep) {
  if constexpr (std::is_same_v<Mode, bf16>) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, q4 = lane & 3;
    const int ntn = N / 8, ntiles = (M / 16) * ntn;
    for (int tile = warp; tile < ntiles; tile += kWarps) {
      const int m0 = (tile / ntn) * 16, n0 = (tile % ntn) * 8;
      const TA* ar0 = a + (size_t)(m0 + gq) * sam;
      const TA* ar1 = ar0 + (size_t)8 * sam;
      const TB* bc = b + (size_t)(n0 + gq) * sbn;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < K; k0 += 16) {
        const int ka = k0 + 2 * q4, kb = ka + 8;
        uint32_t af[4];
        af[0] = pack_bf(to_bf(ar0[ka * sak]), to_bf(ar0[(ka + 1) * sak]));
        af[1] = pack_bf(to_bf(ar1[ka * sak]), to_bf(ar1[(ka + 1) * sak]));
        af[2] = pack_bf(to_bf(ar0[kb * sak]), to_bf(ar0[(kb + 1) * sak]));
        af[3] = pack_bf(to_bf(ar1[kb * sak]), to_bf(ar1[(kb + 1) * sak]));
        mma_bf16(c, af, pack_bf(to_bf(bc[ka * sbk]), to_bf(bc[(ka + 1) * sbk])),
                 pack_bf(to_bf(bc[kb * sbk]), to_bf(bc[(kb + 1) * sbk])));
      }
      ep(m0 + gq, n0 + 2 * q4, c[0]);
      ep(m0 + gq, n0 + 2 * q4 + 1, c[1]);
      ep(m0 + gq + 8, n0 + 2 * q4, c[2]);
      ep(m0 + gq + 8, n0 + 2 * q4 + 1, c[3]);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int m = e / N, n = e % N;
      const TA* ar = a + (size_t)m * sam;
      const TB* bc = b + (size_t)n * sbn;
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc = fmaf(to_f(ar[k * sak]), to_f(bc[k * sbk]), acc);
      ep(m, n, acc);
    }
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
  tile_gemm<T>(qkv + hh * hd, kC3, 1, qkv + kC + hh * hd, 1, kC3, kT, kT, hd,
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
  tile_gemm<T>(xs, kC, 1, wqkv, kC3, 1, kT, kC3, kC, [&](int m, int n, float v) {
    qkv[m * kC3 + n] = from_f<T>(v + bqkv[n]);
  });
  __syncthreads();
  const int hd = kC / heads;
  for (int hh = 0; hh < heads; ++hh) {
    head_softmax(qkv, bias + hh * kT * kT, maskw, s, pb, hh, hd, scale);
    tile_gemm<T>(pb, kT, 1, qkv + 2 * kC + hh * hd, kC3, 1, kT, hd, kT,
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
  tile_gemm<T>(os, kC, 1, wo, kC, 1, kT, kC, kC, [&](int m, int n, float v) {
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
    tile_gemm<T>(os, 1, kC, gs, kC, 1, kC, kC, kT,
               [&](int m, int n, float v) { pdwo[m * kC + n] += v; });
    if (tid < kC) {
      float t = 0.0f;
      for (int r = 0; r < kT; ++r) t += to_f(gs[r * kC + tid]);
      pdbo[tid] += t;
    }
    __syncthreads();
    tile_gemm<T>(gs, kC, 1, wo, 1, kC, kT, kC, kC,
               [&](int m, int n, float v) { os[m * kC + n] = from_f<T>(v); });
    __syncthreads();

    for (int hh = 0; hh < heads; ++hh) {
      const T* q = qkv + hh * hd;
      const T* k = q + kC;
      const T* v = q + 2 * kC;
      head_softmax(qkv, bias + hh * kT * kT, maskw, s, pb, hh, hd, scale);
      // dv = p^T do_h; dp = do_h v^T
      tile_gemm<T>(pb, 1, kT, os + hh * hd, kC, 1, kT, hd, kT,
                 [&](int m, int n, float val) { hs[m * h3 + 2 * hd + n] = val; });
      tile_gemm<T>(os + hh * hd, kC, 1, v, 1, kC3, kT, kT, hd,
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
      tile_gemm<T>(pb, kT, 1, k, kC3, 1, kT, hd, kT,
                 [&](int m, int n, float val) { hs[m * h3 + n] = val; });
      tile_gemm<T>(pb, 1, kT, q, kC3, 1, kT, hd, kT,
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
    tile_gemm<T>(xs, 1, kC, dqkv, kC3, 1, kC, kC3, kT,
               [&](int m, int n, float v) { pdwqkv[m * kC3 + n] += v; });
    T* dxw = dx + (size_t)w * kT * kC;
    tile_gemm<T>(dqkv, kC3, 1, wqkv, 1, kC3, kT, kC, kC3,
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

// ===================================================== tiled T (16 ... 256)
// Windows of T = 16 n tokens, n <= 16 (4x4 up to 16x16 windows; T = 64 has
// the kernels above). At T = 256 a window's x, qkv and o take 160 KB in
// bf16 (320 KB in f32) and one head's f32 scores 256 KB, more than an SM
// holds, so these kernels keep one head's K and V and a tile of query rows
// resident and walk the query tiles; each score row is complete (all T keys
// at once), so the softmax is taken exactly as the twin takes it, with no
// online rescaling. Products, rounding points and the weights' reads are
// those of the T = 64 kernels; a product's operand that lives in f32 (p,
// ds * hd^-1/2) is rounded to bf16 as the product gathers it.

constexpr int kTile = 16;              // T is a multiple of this
constexpr int kMaxT = 256;             // 16 x 16 windows
constexpr int kQF = 64;                // query rows per forward step
constexpr int kQB = 32;                // query rows per backward step
constexpr int kRowVals = kMaxT / 32;   // score values per lane of a row's warp

// One head's scores for `rows` query rows starting at q0, then their softmax:
// s[r][n] = q(r).k(n) * scale + bias_h[q0 + r][n] (+ maskw[q0 + r][n]),
// f32, then p in place. q(r) = qa[r * sq + 0 .. hd), k(n) = kb[n * skn + 0 .. hd).
// Warp w owns rows w, w + 8, ...; lane l the columns l, l + 32, ...
template <typename T, typename TQ, typename TK>
__device__ void scores_softmax(const TQ* qa, int sq, const TK* kb, int skn,
                               const float* bias_h, const float* maskw, float* s,
                               int q0, int rows, int t, int hd, float scale) {
  tile_gemm<T>(qa, sq, 1, kb, 1, skn, rows, t, hd, [&](int m, int n, float v) {
    const size_t i = (size_t)(q0 + m) * t + n;
    float val = v * scale + bias_h[i];
    if (maskw != nullptr) val += maskw[i];
    s[m * t + n] = val;
  });
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = s + r * t;
    float v[kRowVals];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < t ? row[c] : -CUDART_INF_F;
      mx = fmaxf(mx, v[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) {
      v[j] = lane + 32 * j < t ? expf(v[j] - mx) : 0.0f;
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int j = 0; j < kRowVals; ++j)
      if (lane + 32 * j < t) row[lane + 32 * j] = v[j] / sum;
  }
  __syncthreads();
}

// ds = p (dp - sum_n dp p) for `rows` rows of p and dp ([rows][t] f32);
// ep(r, n, ds) once per element, by the thread that owns it in
// scores_softmax's layout (it may overwrite dp).
template <typename Ep>
__device__ void softmax_grad_rows(const float* p, const float* dp, int rows, int t, Ep ep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float pv[kRowVals], dv[kRowVals];
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) {
      const int c = lane + 32 * j;
      pv[j] = c < t ? p[r * t + c] : 0.0f;
      dv[j] = c < t ? dp[r * t + c] : 0.0f;
      rs += pv[j] * dv[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
#pragma unroll
    for (int j = 0; j < kRowVals; ++j)
      if (lane + 32 * j < t) ep(r, lane + 32 * j, pv[j] * (dv[j] - rs));
  }
}

// dst[r][n] = T(a(r) . wqkv[:, col0 + n] + bqkv[col0 + n]) for `rows` rows
// of a (row stride C) and n < ncols: columns of the QKV projection.
template <typename T>
__device__ __forceinline__ void project(const T* a, const T* __restrict__ wqkv,
                                        const float* __restrict__ bqkv, int col0,
                                        T* dst, int rows, int ncols) {
  tile_gemm<T>(a, kC, 1, wqkv + col0, kC3, 1, rows, ncols, kC,
               [&](int m, int n, float v) { dst[m * ncols + n] = from_f<T>(v + bqkv[col0 + n]); });
}

// ---------------------------------------------------------- tiled forward
// One block per window. Per head: K, V (T x hd, in T) from x, then per
// tile of kQF query rows: q, the scores and softmax (kQF x T f32), o rows
// = p.v into os; last y = o.Wo + bo. x is read from device memory (L1):
// in f32 a resident copy would not fit beside the rest.
// Shared memory: s [kQF][T] f32, then os [T][C], ks, vs [T][hd], qs
// [kQF][hd] in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wattn_tiled_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const T* __restrict__ wo,
                       const float* __restrict__ bo, const float* __restrict__ bias,
                       const float* __restrict__ mask, T* __restrict__ y, int t, int nm,
                       int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = kC / heads;
  float* s = reinterpret_cast<float*>(smem_raw);
  T* os = reinterpret_cast<T*>(s + kQF * t);
  T* ks = os + t * kC;
  T* vs = ks + t * hd;
  T* qs = vs + t * hd;
  const int w = blockIdx.x;
  const T* xw = x + (size_t)w * t * kC;
  const float* maskw = mask != nullptr ? mask + (size_t)(w % nm) * t * t : nullptr;
  for (int hh = 0; hh < heads; ++hh) {
    project(xw, wqkv, bqkv, kC + hh * hd, ks, t, hd);
    project(xw, wqkv, bqkv, 2 * kC + hh * hd, vs, t, hd);
    for (int q0 = 0; q0 < t; q0 += kQF) {
      const int rows = min(kQF, t - q0);
      project(xw + (size_t)q0 * kC, wqkv, bqkv, hh * hd, qs, rows, hd);
      __syncthreads();
      scores_softmax<T>(qs, hd, ks, hd, bias + (size_t)hh * t * t, maskw, s, q0, rows, t,
                        hd, scale);
      tile_gemm<T>(s, t, 1, vs, hd, 1, rows, hd, t, [&](int m, int n, float v) {
        os[(q0 + m) * kC + hh * hd + n] = from_f<T>(v);
      });
      __syncthreads();
    }
  }
  T* yw = y + (size_t)w * t * kC;
  tile_gemm<T>(os, kC, 1, wo, kC, 1, t, kC, kC,
               [&](int m, int n, float v) { yw[m * kC + n] = from_f<T>(v + bo[n]); });
}

// --------------------------------------------------------- tiled backward
// Two kernels and the fixed-order sums. The main kernel runs one
// persistent block per SM over its share of the windows; per window:
//   1. qkv = x.Wqkv + b (T x 3C) into the stash (device memory, one slot
//      per window; the dbias kernel reads it);
//   2. the forward again, head by head: o into the block's scratch;
//   3. dWo += o^T g, dbo += sum g, do = g.Wo^T into the stash;
//   4. per head, K and V resident, per tile of kQB query rows: p, dv +=
//      p^T do, dp = do.v^T, ds, dq = ds.k, dk += ds^T q (dk, dv in f32
//      over the window's query tiles), then dqkv (in T) into the scratch;
//   5. dWqkv += x^T dqkv, dx = dqkv.Wqkv^T.
// Weight gradients go to the block's own f32 partial (no other block
// touches it; each element always updated by the same thread). dbias =
// sum over windows of ds (h x T x T) would need 1 MB of partial a block at
// T = 256 (138 MB for 132 blocks), so the dbias kernel owns the sum
// instead: one block per (16 query rows, head, window split) recomputes p
// and ds from the stash's q, k, v and do for every window of its split,
// in order, in shared memory, and writes its slice once. Every run gives
// the same bits.
// Main kernel's shared memory: s, dp [kQB][T], dk, dv [T][hd], dq
// [kQB][hd], dbq [kMaxHd] in f32, then ks, vs [T][hd] in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wattn_tiled_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const T* __restrict__ wo,
                       const float* __restrict__ bias, const float* __restrict__ mask,
                       const T* __restrict__ g, T* __restrict__ dx, T* stash, T* scratch,
                       float* __restrict__ part, int nw, int t, int nm, int heads,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = kC / heads, tid = threadIdx.x;
  float* s = reinterpret_cast<float*>(smem_raw);
  float* dp = s + kQB * t;
  float* dk = dp + kQB * t;
  float* dv = dk + t * hd;
  float* dq = dv + t * hd;
  float* dbq = dq + kQB * hd;
  T* ks = reinterpret_cast<T*>(dbq + kMaxHd);
  T* vs = ks + t * hd;

  const int width = kC * kC3 + kC3 + kC * kC + kC;
  float* pdwqkv = part + (size_t)blockIdx.x * width;
  float* pdbqkv = pdwqkv + kC * kC3;
  float* pdwo = pdbqkv + kC3;
  float* pdbo = pdwo + kC * kC;
  for (int e = tid; e < width; e += kThreads) pdwqkv[e] = 0.0f;
  // o [T][C], then dqkv [T][3C]; written and read by this block only
  T* scr = scratch + (size_t)blockIdx.x * t * kC3;

  for (int w = blockIdx.x; w < nw; w += gridDim.x) {
    __syncthreads();   // the zeroing, or the previous window's last reads
    const T* xw = x + (size_t)w * t * kC;
    const T* gw = g + (size_t)w * t * kC;
    const float* maskw = mask != nullptr ? mask + (size_t)(w % nm) * t * t : nullptr;
    T* qkv = stash + (size_t)w * t * 4 * kC;
    T* dob = qkv + (size_t)t * kC3;

    // 1. the QKV projection
    project(xw, wqkv, bqkv, 0, qkv, t, kC3);
    __syncthreads();

    // 2. o, head by head
    for (int hh = 0; hh < heads; ++hh) {
      for (int e = tid; e < t * hd; e += kThreads) {
        const int r = e / hd, j = e % hd;
        ks[e] = qkv[r * kC3 + kC + hh * hd + j];
        vs[e] = qkv[r * kC3 + 2 * kC + hh * hd + j];
      }
      __syncthreads();
      for (int q0 = 0; q0 < t; q0 += kQB) {
        const int rows = min(kQB, t - q0);
        scores_softmax<T>(qkv + (size_t)q0 * kC3 + hh * hd, kC3, ks, hd,
                          bias + (size_t)hh * t * t, maskw, s, q0, rows, t, hd, scale);
        tile_gemm<T>(s, t, 1, vs, hd, 1, rows, hd, t, [&](int m, int n, float v) {
          scr[(q0 + m) * kC + hh * hd + n] = from_f<T>(v);
        });
        __syncthreads();
      }
    }

    // 3. output projection: dWo += o^T g, dbo += sum_t g, do = g Wo^T
    tile_gemm<T>(scr, 1, kC, gw, kC, 1, kC, kC, t,
                 [&](int m, int n, float v) { pdwo[m * kC + n] += v; });
    if (tid < kC) {
      float acc = 0.0f;
      for (int r = 0; r < t; ++r) acc += to_f(gw[r * kC + tid]);
      pdbo[tid] += acc;
    }
    tile_gemm<T>(gw, kC, 1, wo, 1, kC, t, kC, kC,
                 [&](int m, int n, float v) { dob[m * kC + n] = from_f<T>(v); });
    __syncthreads();

    // 4. the attention backward, head by head
    for (int hh = 0; hh < heads; ++hh) {
      for (int e = tid; e < t * hd; e += kThreads) {
        const int r = e / hd, j = e % hd;
        ks[e] = qkv[r * kC3 + kC + hh * hd + j];
        vs[e] = qkv[r * kC3 + 2 * kC + hh * hd + j];
        dk[e] = 0.0f;
        dv[e] = 0.0f;
      }
      if (tid < hd) dbq[tid] = 0.0f;
      __syncthreads();
      for (int q0 = 0; q0 < t; q0 += kQB) {
        const int rows = min(kQB, t - q0);
        const T* qr = qkv + (size_t)q0 * kC3 + hh * hd;
        const T* dor = dob + (size_t)q0 * kC + hh * hd;
        scores_softmax<T>(qr, kC3, ks, hd, bias + (size_t)hh * t * t, maskw, s, q0, rows,
                          t, hd, scale);
        // dv += p^T do; dp = do v^T
        tile_gemm<T>(s, 1, t, dor, kC, 1, t, hd, rows,
                     [&](int m, int n, float v) { dv[m * hd + n] += v; });
        tile_gemm<T>(dor, kC, 1, vs, 1, hd, rows, t, hd,
                     [&](int m, int n, float v) { dp[m * t + n] = v; });
        __syncthreads();
        // dp <- ds * hd^-1/2 (f32; rounded to T as the products gather it)
        softmax_grad_rows(s, dp, rows, t,
                          [&](int r, int n, float d) { dp[r * t + n] = d * scale; });
        __syncthreads();
        // dq = ds k; dk += ds^T q
        tile_gemm<T>(dp, t, 1, ks, hd, 1, rows, hd, t,
                     [&](int m, int n, float v) { dq[m * hd + n] = v; });
        tile_gemm<T>(dp, 1, t, qr, kC3, 1, t, hd, rows,
                     [&](int m, int n, float v) { dk[m * hd + n] += v; });
        __syncthreads();
        // dbqkv's q columns sum the f32 dq; dqkv holds it in T
        if (tid < hd) {
          float acc = 0.0f;
          for (int r = 0; r < rows; ++r) acc += dq[r * hd + tid];
          dbq[tid] += acc;
        }
        for (int e = tid; e < rows * hd; e += kThreads)
          scr[(q0 + e / hd) * kC3 + hh * hd + e % hd] = from_f<T>(dq[e]);
      }
      // the head's dk, dv: dbqkv and dqkv
      if (tid < hd) pdbqkv[hh * hd + tid] += dbq[tid];
      for (int j = tid; j < 2 * hd; j += kThreads) {
        const float* src = j < hd ? dk : dv;
        float acc = 0.0f;
        for (int r = 0; r < t; ++r) acc += src[r * hd + j % hd];
        pdbqkv[(1 + j / hd) * kC + hh * hd + j % hd] += acc;
      }
      for (int e = tid; e < t * hd; e += kThreads) {
        const int r = e / hd, j = e % hd;
        scr[r * kC3 + kC + hh * hd + j] = from_f<T>(dk[e]);
        scr[r * kC3 + 2 * kC + hh * hd + j] = from_f<T>(dv[e]);
      }
      __syncthreads();
    }

    // 5. QKV projection: dWqkv += x^T dqkv, dx = dqkv Wqkv^T
    tile_gemm<T>(xw, 1, kC, scr, kC3, 1, kC, kC3, t,
                 [&](int m, int n, float v) { pdwqkv[m * kC3 + n] += v; });
    T* dxw = dx + (size_t)w * t * kC;
    tile_gemm<T>(scr, kC3, 1, wqkv, 1, kC3, t, kC, kC3,
                 [&](int m, int n, float v) { dxw[m * kC + n] = from_f<T>(v); });
  }
}

// dbias: block (rt, hh, sp) sums ds over rows [16 rt, 16 rt + 16) of head
// hh for windows [sp * per, (sp + 1) * per), in order, into dbpart[sp][hh].
// Shared memory: s, dp, acc [16][T] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wattn_tiled_dbias_kernel(const T* __restrict__ stash, const float* __restrict__ bias,
                         const float* __restrict__ mask, float* __restrict__ dbpart,
                         int nw, int t, int nm, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = kC / heads, q0 = blockIdx.x * kTile, hh = blockIdx.y;
  const int per = (nw + gridDim.z - 1) / gridDim.z;
  const int w0 = blockIdx.z * per, w1 = min(nw, w0 + per);
  float* s = reinterpret_cast<float*>(smem_raw);
  float* dp = s + kTile * t;
  float* acc = dp + kTile * t;
  for (int e = threadIdx.x; e < kTile * t; e += kThreads) acc[e] = 0.0f;
  const float* bias_h = bias + (size_t)hh * t * t;
  for (int w = w0; w < w1; ++w) {
    const T* qkv = stash + (size_t)w * t * 4 * kC;
    const T* dor = qkv + (size_t)t * kC3 + q0 * kC + hh * hd;
    const float* maskw = mask != nullptr ? mask + (size_t)(w % nm) * t * t : nullptr;
    tile_gemm<T>(dor, kC, 1, qkv + 2 * kC + hh * hd, 1, kC3, kTile, t, hd,
                 [&](int m, int n, float v) { dp[m * t + n] = v; });
    scores_softmax<T>(qkv + (size_t)q0 * kC3 + hh * hd, kC3, qkv + kC + hh * hd, kC3,
                      bias_h, maskw, s, q0, kTile, t, hd, scale);
    softmax_grad_rows(s, dp, kTile, t, [&](int r, int n, float d) { acc[r * t + n] += d; });
    __syncthreads();
  }
  float* out = dbpart + ((size_t)blockIdx.z * heads + hh) * t * t + (size_t)q0 * t;
  for (int e = threadIdx.x; e < kTile * t; e += kThreads) out[e] = acc[e];
}

template <typename T>
size_t tiled_fwd_smem(int t, int hd) {
  return (size_t)kQF * t * sizeof(float) + (size_t)(t * kC + 2 * t * hd + kQF * hd) * sizeof(T);
}

template <typename T>
size_t tiled_bwd_smem(int t, int hd) {
  return (size_t)(2 * kQB * t + 2 * t * hd + kQB * hd + kMaxHd) * sizeof(float) +
         (size_t)2 * t * hd * sizeof(T);
}

size_t dbias_smem(int t) { return (size_t)3 * kTile * t * sizeof(float); }

template <typename T>
int launch_tiled_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                     const float* bo, const float* bias, const float* mask, void* y, int nw,
                     int t, int nm, int heads, float scale, cudaStream_t stream) {
  static bool done = false;
  const cudaError_t e =
      allow_smem(wattn_tiled_fwd_kernel<T>, tiled_fwd_smem<T>(kMaxT, kMaxHd), done);
  if (e != cudaSuccess) return (int)e;
  wattn_tiled_fwd_kernel<T><<<nw, kThreads, tiled_fwd_smem<T>(t, kC / heads), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wo), bo, bias, mask, static_cast<T*>(y), t, nm, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tiled_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                     const float* bias, const float* mask, const void* g, void* dx,
                     void* stash, void* scratch, float* part, float* dbpart, float* grads,
                     int nw, int t, int nm, int heads, int nblk, int nsplit, float scale,
                     cudaStream_t stream) {
  static bool done = false, done_db = false;
  cudaError_t e =
      allow_smem(wattn_tiled_bwd_kernel<T>, tiled_bwd_smem<T>(kMaxT, kMaxHd), done);
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(wattn_tiled_dbias_kernel<T>, dbias_smem(kMaxT), done_db)) != cudaSuccess)
    return (int)e;
  wattn_tiled_bwd_kernel<T><<<nblk, kThreads, tiled_bwd_smem<T>(t, kC / heads), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wo), bias, mask, static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<T*>(stash), static_cast<T*>(scratch), part, nw, t, nm, heads, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wattn_tiled_dbias_kernel<T><<<dim3(t / kTile, heads, nsplit), kThreads, dbias_smem(t),
                                stream>>>(static_cast<const T*>(stash), bias, mask, dbpart,
                                          nw, t, nm, heads, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int width = kC * kC3 + kC3 + kC * kC + kC, nbias = heads * t * t;
  sum_partials_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, grads, 1, nblk, width);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(nbias + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dbpart, grads + width, 1, nsplit, nbias);
  return (int)cudaGetLastError();
}

bool bad_shape(int nw, int nm, const float* mask, int heads) {
  const int hd = heads > 0 ? kC / heads : 0;
  return nw < 1 || heads < 1 || kC % heads || hd % 16 || hd > kMaxHd ||
         (mask != nullptr) != (nm > 0) || (nm > 0 && nw % nm);
}

bool bad_tiled_shape(int nw, int t, int nm, const float* mask, int heads) {
  return bad_shape(nw, nm, mask, heads) || t < kTile || t > kMaxT || t % kTile;
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

// The tiled kernels: T tokens a window, a multiple of sres_wattn_tile() up
// to sres_wattn_max_tokens(); otherwise as sres_wattn_fwd.
int sres_wattn_tile() { return kTile; }
int sres_wattn_max_tokens() { return kMaxT; }

int sres_wattn_tiled_fwd(const void* x, const void* wqkv, const float* bqkv,
                         const void* wo, const float* bo, const float* bias,
                         const float* mask, void* y, int nw, int t, int nm, int heads,
                         float scale, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_tiled_shape(nw, t, nm, mask, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_tiled_fwd<bf16>(x, wqkv, bqkv, wo, bo, bias, mask, y, nw, t, nm, heads,
                                  scale, s);
  return launch_tiled_fwd<float>(x, wqkv, bqkv, wo, bo, bias, mask, y, nw, t, nm, heads,
                                 scale, s);
}

// As sres_wattn_bwd at T tokens. Scratch: stash (nw, t, 4*64) and scratch
// (nblk, t, 3*64) of x's type; part (nblk, W1) f32 with W1 = 4*64*64 +
// 4*64; dbpart (nsplit, heads, t, t) f32. Out: grads (W1 + heads*t*t,) f32
// laid out as sres_wattn_bwd's.
int sres_wattn_tiled_bwd(const void* x, const void* wqkv, const float* bqkv,
                         const void* wo, const float* bo, const float* bias,
                         const float* mask, const void* g, void* dx, void* stash,
                         void* scratch, float* part, float* dbpart, float* grads, int nw,
                         int t, int nm, int heads, float scale, int nblk, int nsplit,
                         int bf16_, int device, void* stream) {
  (void)bo;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_tiled_shape(nw, t, nm, mask, heads) || nblk < 1 || nblk > nw || nsplit < 1 ||
      nsplit > nw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_tiled_bwd<bf16>(x, wqkv, bqkv, wo, bias, mask, g, dx, stash, scratch,
                                  part, dbpart, grads, nw, t, nm, heads, nblk, nsplit,
                                  scale, s);
  return launch_tiled_bwd<float>(x, wqkv, bqkv, wo, bias, mask, g, dx, stash, scratch, part,
                                 dbpart, grads, nw, t, nm, heads, nblk, nsplit, scale, s);
}

}  // extern "C"
