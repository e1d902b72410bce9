// Fused window multi-head attention for Hopper (SwinIR), forward and backward.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/window_attention.py:_fwd_kernel (:74, pallas_call :154)
//   sres_tpu/ops/pallas/window_attention.py:_bwd_kernel (:84, pallas_call :195)
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
// Forward: two kernels, picked by T. At T = 64 (8x8 windows) one 256-thread
// block per window keeps every per-window operand in shared memory
// (wattn_fwd_kernel); at any other multiple of 16 up to 256 (4x4 ... 16x16
// windows) wattn_tiled_fwd_kernel keeps one head's K and V and a tile of
// query rows with their full f32 score rows (a 16x16 window does not fit an
// SM). Their products are tile_gemm calls that gather each operand element
// by element (bf16 mma.sync, f32 FMAs). Measured on an H100 SXM (700 W),
// bf16: 0.56 ms at 1728 windows of T = 64, 2.23 ms at 432 of T = 256
// shifted, 61x and 190x their bounds and slower than cuDNN's fused
// attention composed with two GEMMs. Later work.
//
// Backward: one design for every T up to 256, made for Hopper. It replaces
// an earlier three-kernel backward (a whole-window kernel at T = 64; at
// other T a tiled kernel with a q/k/v/do stash in device memory, 56.6 MB
// at SwinIR-w16's shape, and a dbias kernel recomputing p and ds from it),
// which gathered every product operand element by element, from device
// memory too. Per call at SwinIR-w16 (batch 12: 432 windows of T = 256, 4
// heads): x and g read, dx written (42.5 MB, 0.016 ms at 3.35 TB/s) and
// 31.7 GFLOP of products (0.032 ms at 989 TFLOP/s): operations bound it.
//  - wattn_bwd_core_kernel: one thread-block cluster per (head, window
//    range) of ceil(T / R) CTAs, each owning R query rows (R = 64 in bf16,
//    32 in f32; a short last CTA at T = 144). Per window each CTA projects
//    its rows' q, k, v from x (the head's Wqkv columns resident), pushes k
//    and v to every CTA of the cluster through distributed shared memory,
//    and keeps the scores and dp as mma accumulators in registers (16
//    warps, 4 x 4 over rows and columns in bf16; row reductions by quad
//    shuffles and a few shared floats), so the softmax is exact over all T keys with no
//    recompute and no stash. dbias is a (R x T) f32 slice in shared memory
//    across the whole window range, each element always updated by the
//    same thread; dWo_h and the bias-gradient columns stay in registers.
//    dq is complete per CTA; the dk and dv partials over each CTA's rows
//    are summed in rank order through distributed shared memory. dqkv (in
//    T) goes to device memory once.
//  - wattn_bwd_proj_kernel: dx = dqkv.Wqkv^T over all 3C columns in one
//    product (the sum over heads in one accumulator, as in the twin) and
//    per-block partials of dWqkv = x^T dqkv, over tiles of 64 rows.
//  - sum_partials_kernel adds the partials in a fixed order: no atomics,
//    every run gives the same bits. The number of window ranges and of
//    projection blocks is a function of the shape, never of the card.
// Every product's operands are staged in shared memory by 16-byte copies
// and reach mma.sync m16n8k16 through ldmatrix; the next window's x and g
// rows load (cp.async) while the current one computes. Bias and mask are
// read through L1 from L2 in the score epilogue: a resident bias slice
// would take the shared memory that L1 needs for the mask's reads.
// Measured on an H100 SXM (700 W), bf16, shifted: 1.10 ms at SwinIR-w16's
// shape (the three-kernel backward 11.0 ms; the composition's autograd
// backward 1.81) and 0.57 ms at SwinIR's 1728 windows of T = 64 (2.47;
// the composition 1.69), 34x and 36x their bounds. What bounds it now is
// latency: one 16-warp CTA per SM, about a dozen barriers a window, and no
// part dominant (sres_tpu_torch/probes/wattn_bwd_variants.py): the bias and
// mask reads take 0.30 of the 1.10 ms at T = 256 (and push the bf16 kernels
// past the 128 registers a thread of 512 has: 160-208 bytes of spills),
// p.V and ds.K, where 4 of 16 warps work at head width 16, 0.11, every
// other product, the exp and the exchange barrier 0.03-0.08 each.
// Clusters must fit the card in one wave: an H100 holds 30 clusters of 4
// such CTAs, so the wrapper sizes the grid to 28 (32 took 1.64x as long).

#include <cooperative_groups.h>
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

template <typename T>
size_t fwd_smem() {
  return (size_t)kT * kT * sizeof(float) + (size_t)kT * (2 * kC + kT + kC3) * sizeof(T);
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

// ============================================= tiled forward (16 ... 256)
// Windows of T = 16 n tokens, n <= 16 (4x4 up to 16x16 windows; T = 64 has
// the kernel above). At T = 256 a window's x, qkv and o take 160 KB in
// bf16 (320 KB in f32) and one head's f32 scores 256 KB, more than an SM
// holds, so this kernel keeps one head's K and V and a tile of query rows
// resident and walks the query tiles; each score row is complete (all T keys
// at once), so the softmax is taken exactly as the twin takes it, with no
// online rescaling. Products, rounding points and the weights' reads are
// those of the T = 64 kernel; p (f32) is rounded to bf16 as p.v gathers it.

constexpr int kTile = 16;              // T is a multiple of this
constexpr int kMaxT = 256;             // 16 x 16 windows
constexpr int kQF = 64;                // query rows per forward step
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

template <typename T>
size_t tiled_fwd_smem(int t, int hd) {
  return (size_t)kQF * t * sizeof(float) + (size_t)(t * kC + 2 * t * hd + kQF * hd) * sizeof(T);
}

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

// ============================================== backward (every T up to 256)
// Two kernels and three fixed-order partial sums; see the note at the top.
// Every product runs on bwd_mma: operands staged in shared memory by
// 16-byte cp.async (or 16-byte distributed-shared-memory stores), in rows
// padded by 8 bf16 (a row stride of 16 bytes times an odd number: the eight
// rows of an ldmatrix phase fall in distinct banks), fed to mma.sync
// m16n8k16 through ldmatrix (.trans for the operands stored transposed).
// The f32 mode (exact checks) keeps the same data layout and thread
// ownership, and computes each accumulator element with FMAs in k order.

// rows x cols elements (cols * sizeof(E) a multiple of 16) from global
// memory (row stride gld) to shared memory (row stride sld), 16 bytes a copy
template <typename E>
__device__ __forceinline__ void copy_rows_async(E* dst, int sld, const E* src, int gld, int rows,
                                                int cols) {
  constexpr int kV = 16 / sizeof(E);
  const int cpr = cols / kV;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * kV;
    cp_async16(dst + (size_t)r * sld + c, src + (size_t)r * gld + c);
  }
}

// two adjacent elements (p even-indexed), rounded to E
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// four adjacent elements (p 4-aligned), rounded to E
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// ------------------------------------------------------- the warp product
// acc[j] += A[m0 : m0 + 16, k0 : k1] . B[k0 : k1, n0 + 8 j : n0 + 8 j + 8]
// for j < nt (nt <= NT), in the m16n8 accumulator layout (lane l: rows
// l / 4 and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1). A(m, k) is
// a[m * lda + k], or (kAT) a[k * lda + m]; B(k, n) is b[n * ldb + k], or
// (kBKN) b[k * ldb + n]; all in shared memory. k1 - k0 is a multiple of 16.
template <typename E, bool kAT, bool kBKN, int NT>
__device__ __forceinline__ void bwd_mma(float (&acc)[NT][4], const E* a, int lda, int m0,
                                        const E* b, int ldb, int n0, int k0, int k1, int nt) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<E, bf16>) {
    const int r8 = lane & 7, mat = lane >> 3;
    for (int k = k0; k < k1; k += 16) {
      uint32_t af[4];
      if constexpr (kAT)
        ldsm_x4<true>(af, a + (size_t)(k + r8 + (mat >> 1) * 8) * lda + m0 + (mat & 1) * 8);
      else
        ldsm_x4<false>(af, a + (size_t)(m0 + r8 + (mat & 1) * 8) * lda + k + (mat >> 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j < nt) {
          const E* bp;
          if constexpr (kBKN)
            bp = b + (size_t)(k + r8 + (mat & 1) * 8) * ldb + n0 + 8 * j + (mat >> 1) * 8;
          else
            bp = b + (size_t)(n0 + 8 * j + r8 + (mat >> 1) * 8) * ldb + k + (mat & 1) * 8;
          uint32_t bfr[4];
          if (j + 1 < nt) {
            ldsm_x4<kBKN>(bfr, bp);
            mma_bf16(acc[j], af, bfr[0], bfr[1]);
            if constexpr (NT > 1) mma_bf16(acc[j + 1], af, bfr[2], bfr[3]);
          } else {
            ldsm_x2<kBKN>(bfr, bp);
            mma_bf16(acc[j], af, bfr[0], bfr[1]);
          }
        }
      }
    }
  } else {
    const int gq = lane >> 2, q4 = lane & 3;
    for (int k = k0; k < k1; ++k) {
      const float a0 = kAT ? a[(size_t)k * lda + m0 + gq] : a[(size_t)(m0 + gq) * lda + k];
      const float a1 = kAT ? a[(size_t)k * lda + m0 + gq + 8] : a[(size_t)(m0 + gq + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const int n = n0 + 8 * j + 2 * q4;
          const float b0 = kBKN ? b[(size_t)k * ldb + n] : b[(size_t)n * ldb + k];
          const float b1 = kBKN ? b[(size_t)k * ldb + n + 1] : b[(size_t)(n + 1) * ldb + k];
          acc[j][0] = fmaf(a0, b0, acc[j][0]);
          acc[j][1] = fmaf(a0, b1, acc[j][1]);
          acc[j][2] = fmaf(a1, b0, acc[j][2]);
          acc[j][3] = fmaf(a1, b1, acc[j][3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// ----------------------------------------------------- the core kernel
constexpr int kBT = 512;          // threads of a core CTA
constexpr int kBW = kBT / 32;     // its warps
static_assert(kMaxT / 16 <= kBW, "a warp holds the dk, dv rows of one 16-key tile");

// Per element type: query rows a CTA owns (R; the cluster has ceil(T / R)
// CTAs), the warps' 4 x 4 (bf16) or 2 x 8 (f32) grid over its score rows
// and columns, and the score n-tiles a warp holds at T = 256.
template <typename E>
struct BwdCfg {
  static constexpr bool kBf = std::is_same_v<E, bf16>;
  static constexpr int R = kBf ? 64 : 32;
  static constexpr int RG = R / 16;
  static constexpr int CG = kBW / RG;
  static constexpr int NT = 2 * ((kMaxT / 16 + CG - 1) / CG);
  static constexpr int kPad = kBf ? 8 : 0;
};

// The columns [n0, n0 + 8 nt) of the scores that column group cg holds:
// whole 16-column chunks, as even as T allows.
template <typename E>
__host__ __device__ __forceinline__ void score_cols(int t, int cg, int& n0, int& nt) {
  constexpr int CG = BwdCfg<E>::CG;
  const int nk = t / 16, base = nk / CG, extra = nk % CG;
  n0 = 16 * (cg * base + (cg < extra ? cg : extra));
  nt = 2 * (base + (cg < extra ? 1 : 0));
}

// Shared-memory map of the core kernel (byte offsets; leading dimensions
// in elements), the same on host and device.
struct CoreSmem {
  size_t dbias, x, g, wq, wo, q, o, dO, k, v, pd, red, colq, bq, bytes;
  int ldx, ldw, ldh, ldp;
};

template <typename E>
__host__ __device__ inline CoreSmem core_smem(int t, int hd) {
  using Cf = BwdCfg<E>;
  const int es = sizeof(E);
  CoreSmem s{};
  s.ldx = kC + Cf::kPad;        // x, g rows; Wo's head rows
  s.ldw = 3 * hd + Cf::kPad;    // Wqkv's head columns
  s.ldh = hd + Cf::kPad;        // q, o, do, K, V
  s.ldp = t + Cf::kPad;         // p, ds in E
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  };
  int n0, nt;
  score_cols<E>(t, 0, n0, nt);  // column group 0 holds the most
  s.dbias = take((size_t)nt * kBT * 4 * sizeof(float));
  s.x = take((size_t)Cf::R * s.ldx * es);
  s.g = take((size_t)Cf::R * s.ldx * es);
  s.wq = take((size_t)kC * s.ldw * es);
  s.wo = take((size_t)hd * s.ldx * es);
  s.q = take((size_t)Cf::R * s.ldh * es);
  s.o = take((size_t)Cf::R * s.ldh * es);
  s.dO = take((size_t)Cf::R * s.ldh * es);
  s.k = take((size_t)t * s.ldh * es);
  s.v = take((size_t)t * s.ldh * es);
  const size_t pds = (size_t)Cf::R * s.ldp * es, part = (size_t)t * 2 * hd * sizeof(float);
  s.pd = take(pds > part ? pds : part);
  s.red = take((size_t)2 * Cf::CG * Cf::R * sizeof(float));
  s.colq = take((size_t)Cf::RG * hd * sizeof(float));
  s.bq = take((size_t)3 * hd * sizeof(float));
  s.bytes = off;
  return s;
}

// width of one core partial: [dbqkv 3C | dWo C*C | dbo C]
constexpr int kCoreW = kC3 + kC * kC + kC;

// Grid: nq x heads x nsplit CTAs, clusters of the nq = ceil(T / R) CTAs of
// one (head, window range); CTA rank qt owns query rows [qt R, qt R + rows)
// and, for dk and dv, the same key rows. Per window: (B) its rows' q, k, v
// for the head, k and v pushed to every CTA of the cluster; (C, D) scores
// (+ bias, mask from L2) and the exact softmax in registers, p in E to
// shared memory; (G) do = g.Wo_h^T, dbo; (E) o = p.V; (H) dp = do.V^T in
// registers; (K) the dv partial p^T do; (F) dWo_h += o^T g; (I) ds, dbias,
// and ds hd^-1/2 in E over p; (J) dq = ds.K, written; (K) the dk partial
// ds^T q; the dk | dv partials exchanged through distributed shared memory
// and (M) summed in rank order for the CTA's key rows, written. dqkv: (nw,
// T, 3C) in E. part: (nq * nsplit, kCoreW) f32, slot qt * nsplit + split;
// dbpart: (nsplit, heads, T, T) f32. HD = C / heads, the head width.
template <typename E, int HD>
__global__ void __launch_bounds__(kBT, 1)
wattn_bwd_core_kernel(const E* __restrict__ x, const E* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const E* __restrict__ wo,
                      const float* __restrict__ bias, const float* __restrict__ mask,
                      const E* __restrict__ g, E* __restrict__ dqkv, float* __restrict__ part,
                      float* __restrict__ dbpart, int nw, int t, int nm, int heads, int nsplit,
                      float scale) {
  using Cf = BwdCfg<E>;
  constexpr int R = Cf::R, CG = Cf::CG, NT = Cf::NT;
  constexpr int kV = 16 / sizeof(E);   // elements in 16 bytes
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = (t + R - 1) / R;
  const int qt = (int)cluster.block_rank();
  const int hh = (blockIdx.x / nq) % heads, split = blockIdx.x / (nq * heads);
  constexpr int hd = HD;
  const int q0 = qt * R, rows = min(R, t - q0);
  const int w0 = (int)((long long)split * nw / nsplit);
  const int w1 = (int)((long long)(split + 1) * nw / nsplit);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const int rg = warp % Cf::RG, cgi = warp / Cf::RG;
  const bool live = rg * 16 < rows;   // this warp's score rows exist
  const int lr0 = rg * 16 + gq;       // the thread's score rows lr0, lr0 + 8
  int n0, nt;
  score_cols<E>(t, cgi, n0, nt);

  const CoreSmem L = core_smem<E>(t, hd);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dbf = reinterpret_cast<float*>(smem_raw + L.dbias);
  E* xs = reinterpret_cast<E*>(smem_raw + L.x);
  E* gs = reinterpret_cast<E*>(smem_raw + L.g);
  E* wq = reinterpret_cast<E*>(smem_raw + L.wq);
  E* wos = reinterpret_cast<E*>(smem_raw + L.wo);
  E* qs = reinterpret_cast<E*>(smem_raw + L.q);
  E* os = reinterpret_cast<E*>(smem_raw + L.o);
  E* dos = reinterpret_cast<E*>(smem_raw + L.dO);
  E* ks = reinterpret_cast<E*>(smem_raw + L.k);
  E* vs = reinterpret_cast<E*>(smem_raw + L.v);
  E* pb = reinterpret_cast<E*>(smem_raw + L.pd);   // p, then ds hd^-1/2
  E* dsb = pb;
  float* kvp = reinterpret_cast<float*>(smem_raw + L.pd);   // (T, 2 hd) dk | dv partial
  float* red0 = reinterpret_cast<float*>(smem_raw + L.red);
  float* red1 = red0 + CG * R;
  float* colq = reinterpret_cast<float*>(smem_raw + L.colq);
  float* colkv = reinterpret_cast<float*>(smem_raw + L.q);   // (M): [kBW][2 hd], over q, o, do
  float* bq = reinterpret_cast<float*>(smem_raw + L.bq);
  const float* bias_h = bias + ((size_t)hh * t + q0) * t;   // the CTA's rows

  // the head's weights and biases, resident; the first window's rows
  {
    const int cph = hd / kV;
    for (int i = tid; i < kC * 3 * cph; i += kBT) {
      const int c = i / (3 * cph), seg = (i / cph) % 3, ch = i % cph;
      cp_async16(wq + c * L.ldw + seg * hd + ch * kV,
                 wqkv + (size_t)c * kC3 + seg * kC + hh * hd + ch * kV);
    }
  }
  copy_rows_async(wos, L.ldx, wo + (size_t)hh * hd * kC, kC, hd, kC);
  if (w0 < w1) {
    copy_rows_async(xs, L.ldx, x + ((size_t)w0 * t + q0) * kC, kC, rows, kC);
    copy_rows_async(gs, L.ldx, g + ((size_t)w0 * t + q0) * kC, kC, rows, kC);
  }
  cp_async_commit();
  for (int j = tid; j < 3 * hd; j += kBT) bq[j] = bqkv[(j / hd) * kC + hh * hd + j % hd];
  for (int i = tid; i < (int)((L.x - L.dbias) / sizeof(float)); i += kBT) dbf[i] = 0.0f;

  // persistent sums: dWo's head rows (warps < 8 hd / 16: the 16 x 8 tile
  // at rows 16 wm, columns 8 wn), and the columns a thread owns of dbq,
  // dbk | dbv and dbo
  const int wm = warp >> 3, wn = warp & 7;
  const bool wlive = wm < hd / 16;
  float dwo[1][4];
  zero_acc(dwo);
  float dbq = 0.0f, dbkv = 0.0f, dbo = 0.0f;
  const int cpr = hd / 2;   // float4 chunks in a row of the dk | dv partial

  cluster.sync();   // every CTA of the cluster runs: shared memory may be shared
  for (int w = w0; w < w1; ++w) {
    cp_async_wait<0>();
    __syncthreads();
    // (B) q, k, v of the CTA's rows: [rows x C] . [C x 3 hd] + b, in E
    {
      const int npair = 3 * hd / 16;
      for (int u = warp; u < (rows / 16) * npair; u += kBW) {
        const int mt = u / npair, np = u % npair;
        float acc[2][4];
        zero_acc(acc);
        bwd_mma<E, false, true, 2>(acc, xs, L.ldx, mt * 16, wq, L.ldw, np * 16, 0, kC, 2);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = mt * 16 + gq + 8 * hf, col = np * 16 + 8 * j + 2 * q4;
            const int seg = col / hd, c = col % hd;
            E* dst = seg == 0 ? qs + r * L.ldh : (seg == 1 ? ks : vs) + (q0 + r) * L.ldh;
            store2(dst + c, acc[j][2 * hf] + bq[col], acc[j][2 * hf + 1] + bq[col + 1]);
          }
      }
    }
    __syncthreads();
    if (w + 1 < w1) copy_rows_async(xs, L.ldx, x + ((size_t)(w + 1) * t + q0) * kC, kC, rows, kC);
    cp_async_commit();
    if (nq > 1) {   // this CTA's k, v rows into the other CTAs' K, V
      const int cph = hd / kV, n = rows * cph;
      for (int i = tid; i < 2 * n; i += kBT) {
        const int r = (i % n) / cph, ch = i % cph;
        E* src = (i < n ? ks : vs) + (q0 + r) * L.ldh + ch * kV;
        const uint4 val = *reinterpret_cast<const uint4*>(src);
        for (int rank = 0; rank < nq; ++rank)
          if (rank != qt) *reinterpret_cast<uint4*>(cluster.map_shared_rank(src, rank)) = val;
      }
    }
    cluster.sync();   // K, V whole in every CTA

    // (C) scores of the warp's 16 rows and columns [n0, n0 + 8 nt)
    float sc[NT][4];
    zero_acc(sc);
    if (live) {
      bwd_mma<E, false, false, NT>(sc, qs, L.ldh, rg * 16, ks, L.ldh, n0, 0, hd, nt);
      // + bias[h] (+ mask[w % nm]), read through L1 from L2
      const float* maskw = mask != nullptr ? mask + ((size_t)(w % nm) * t + q0) * t : nullptr;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const size_t i = (size_t)(lr0 + 8 * hf) * t + n0 + 8 * j + 2 * q4;
            const float2 b = ldg2(bias_h + i);
            float v0 = sc[j][2 * hf] * scale + b.x, v1 = sc[j][2 * hf + 1] * scale + b.y;
            if (maskw != nullptr) {
              const float2 m = ldg2(maskw + i);
              v0 += m.x;
              v1 += m.y;
            }
            sc[j][2 * hf] = v0;
            sc[j][2 * hf + 1] = v1;
          }
    }
    // (D) the exact softmax over all T columns: row max and sum over the
    // quad, then over the column groups (in order) through shared memory
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    if (q4 == 0) {
      red0[cgi * R + lr0] = mx0;
      red0[cgi * R + lr0 + 8] = mx1;
    }
    __syncthreads();
    mx0 = red0[lr0];
    mx1 = red0[lr0 + 8];
#pragma unroll
    for (int c = 1; c < CG; ++c) {
      mx0 = fmaxf(mx0, red0[c * R + lr0]);
      mx1 = fmaxf(mx1, red0[c * R + lr0 + 8]);
    }
    float sm0 = 0.0f, sm1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) {
        sc[j][0] = expf(sc[j][0] - mx0);
        sc[j][1] = expf(sc[j][1] - mx0);
        sc[j][2] = expf(sc[j][2] - mx1);
        sc[j][3] = expf(sc[j][3] - mx1);
        sm0 += sc[j][0] + sc[j][1];
        sm1 += sc[j][2] + sc[j][3];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sm0 += __shfl_xor_sync(0xffffffffu, sm0, o);
      sm1 += __shfl_xor_sync(0xffffffffu, sm1, o);
    }
    if (q4 == 0) {
      red1[cgi * R + lr0] = sm0;
      red1[cgi * R + lr0 + 8] = sm1;
    }
    __syncthreads();
    sm0 = red1[lr0];
    sm1 = red1[lr0 + 8];
#pragma unroll
    for (int c = 1; c < CG; ++c) {
      sm0 += red1[c * R + lr0];
      sm1 += red1[c * R + lr0 + 8];
    }
    if (live) {
      const float inv0 = 1.0f / sm0, inv1 = 1.0f / sm1;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          sc[j][0] *= inv0;
          sc[j][1] *= inv0;
          sc[j][2] *= inv1;
          sc[j][3] *= inv1;
          const int col = n0 + 8 * j + 2 * q4;
          store2(pb + lr0 * L.ldp + col, sc[j][0], sc[j][1]);
          store2(pb + (lr0 + 8) * L.ldp + col, sc[j][2], sc[j][3]);
        }
    }
    // (G) do = g . Wo_h^T in E; dbo sums g's columns (head 0's CTAs)
    {
      const int npair = hd / 16;
      for (int u = warp; u < (rows / 16) * npair; u += kBW) {
        const int mt = u / npair, np = u % npair;
        float acc[2][4];
        zero_acc(acc);
        bwd_mma<E, false, false, 2>(acc, gs, L.ldx, mt * 16, wos, L.ldx, np * 16, 0, kC, 2);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store2(dos + (mt * 16 + gq + 8 * hf) * L.ldh + np * 16 + 8 * j + 2 * q4,
                   acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
      if (hh == 0 && tid < kC)
        for (int r = 0; r < rows; ++r) dbo += to_f(gs[r * L.ldx + tid]);
    }
    __syncthreads();
    // (E) o = p . V in E
    {
      const int npair = hd / 16;
      for (int u = warp; u < (rows / 16) * npair; u += kBW) {
        const int mt = u / npair, np = u % npair;
        float acc[2][4];
        zero_acc(acc);
        bwd_mma<E, false, true, 2>(acc, pb, L.ldp, mt * 16, vs, L.ldh, np * 16, 0, t, 2);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store2(os + (mt * 16 + gq + 8 * hf) * L.ldh + np * 16 + 8 * j + 2 * q4,
                   acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    }
    // (H) dp = do . V^T, in the scores' layout
    float dp[NT][4];
    zero_acc(dp);
    if (live) bwd_mma<E, false, false, NT>(dp, dos, L.ldh, rg * 16, vs, L.ldh, n0, 0, hd, nt);
    // (K) partials over the CTA's query rows, T x hd each, warp w holding
    // key rows [16 w, 16 w + 16) (T <= 16 kBW): here dv = p^T do, from p
    // before ds takes its place; dk = ds^T q after (J)
    const bool kvlive = warp < t / 16;
    float dvp[hd / 8][4];
    zero_acc(dvp);
    if (kvlive)
      bwd_mma<E, true, true, hd / 8>(dvp, pb, L.ldp, warp * 16, dos, L.ldh, 0, 0, rows, hd / 8);
    __syncthreads();
    // (F) dWo_h += o^T g over the CTA's rows
    if (wlive) bwd_mma<E, true, true, 1>(dwo, os, L.ldh, wm * 16, gs, L.ldx, wn * 8, 0, rows, 1);
    // (I) ds = p (dp - rowsum(dp p)); dbias += ds; ds hd^-1/2 in E
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) {
        rs0 += dp[j][0] * sc[j][0] + dp[j][1] * sc[j][1];
        rs1 += dp[j][2] * sc[j][2] + dp[j][3] * sc[j][3];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    if (q4 == 0) {
      red0[cgi * R + lr0] = rs0;
      red0[cgi * R + lr0 + 8] = rs1;
    }
    __syncthreads();
    rs0 = red0[lr0];
    rs1 = red0[lr0 + 8];
#pragma unroll
    for (int c = 1; c < CG; ++c) {
      rs0 += red0[c * R + lr0];
      rs1 += red0[c * R + lr0 + 8];
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          const float d0 = sc[j][0] * (dp[j][0] - rs0), d1 = sc[j][1] * (dp[j][1] - rs0);
          const float d2 = sc[j][2] * (dp[j][2] - rs1), d3 = sc[j][3] * (dp[j][3] - rs1);
          float4* acc = reinterpret_cast<float4*>(dbf) + (j * kBW + warp) * 32 + lane;
          float4 a = *acc;
          a.x += d0;
          a.y += d1;
          a.z += d2;
          a.w += d3;
          *acc = a;
          const int col = n0 + 8 * j + 2 * q4;
          store2(dsb + lr0 * L.ldp + col, d0 * scale, d1 * scale);
          store2(dsb + (lr0 + 8) * L.ldp + col, d2 * scale, d3 * scale);
        }
    }
    __syncthreads();
    if (w + 1 < w1) copy_rows_async(gs, L.ldx, g + ((size_t)(w + 1) * t + q0) * kC, kC, rows, kC);
    cp_async_commit();
    E* dqw = dqkv + ((size_t)w * t + q0) * kC3 + hh * hd;
    // (J) dq = ds . K: written in E; its column sums (unrounded) for dbq
    {
      const int npair = hd / 16;
      for (int u = warp; u < (rows / 16) * npair; u += kBW) {
        const int mt = u / npair, np = u % npair;
        float acc[2][4];
        zero_acc(acc);
        bwd_mma<E, false, true, 2>(acc, dsb, L.ldp, mt * 16, ks, L.ldh, np * 16, 0, t, 2);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = np * 16 + 8 * j + 2 * q4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store2(dqw + (size_t)(mt * 16 + gq + 8 * hf) * kC3 + col, acc[j][2 * hf],
                   acc[j][2 * hf + 1]);
          float s0 = acc[j][0] + acc[j][2], s1 = acc[j][1] + acc[j][3];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (gq == 0) {
            colq[mt * hd + col] = s0;
            colq[mt * hd + col + 1] = s1;
          }
        }
      }
    }
    // (K) dk = ds^T q
    float dkp[hd / 8][4];
    zero_acc(dkp);
    if (kvlive)
      bwd_mma<E, true, true, hd / 8>(dkp, dsb, L.ldp, warp * 16, qs, L.ldh, 0, 0, rows, hd / 8);
    __syncthreads();   // ds, q read; colq written
    if (tid < hd)
      for (int mt = 0; mt < rows / 16; ++mt) dbq += colq[mt * hd + tid];
    if (kvlive)
#pragma unroll
      for (int j = 0; j < hd / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float* dst = kvp + (size_t)(warp * 16 + gq + 8 * hf) * 2 * hd + 8 * j + 2 * q4;
          store2(dst, dkp[j][2 * hf], dkp[j][2 * hf + 1]);
          store2(dst + hd, dvp[j][2 * hf], dvp[j][2 * hf + 1]);
        }
    cluster.sync();   // every CTA's partial complete
    // (M) dk, dv of the CTA's key rows: the partials summed in rank order
    {
      float4 cs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = tid; i < rows * cpr; i += kBT) {
        const int r = i / cpr, c4 = i % cpr;
        const float* src = kvp + (size_t)(q0 + r) * 2 * hd + 4 * c4;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int rank = 0; rank < nq; ++rank) {
          const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, rank));
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        cs.x += s.x;
        cs.y += s.y;
        cs.z += s.z;
        cs.w += s.w;
        const int col = 4 * c4;
        store4(dqw + (size_t)r * kC3 + (1 + col / hd) * kC + col % hd, s);
      }
      // the warp's lanes l, l + cpr, ... hold the same columns
      for (int o = cpr; o < 32; o <<= 1) {
        cs.x += __shfl_xor_sync(0xffffffffu, cs.x, o);
        cs.y += __shfl_xor_sync(0xffffffffu, cs.y, o);
        cs.z += __shfl_xor_sync(0xffffffffu, cs.z, o);
        cs.w += __shfl_xor_sync(0xffffffffu, cs.w, o);
      }
      if (lane < cpr) reinterpret_cast<float4*>(colkv)[warp * cpr + lane] = cs;
    }
    __syncthreads();
    if (tid < 2 * hd)
      for (int i = 0; i < kBW; ++i) dbkv += colkv[i * 2 * hd + tid];
  }
  cp_async_wait<0>();
  cluster.sync();   // no CTA leaves while another may read its partial

  // this CTA's share of the sums over its windows
  float* pc = part + (size_t)(qt * nsplit + split) * kCoreW;
  if (tid < hd) pc[hh * hd + tid] = dbq;
  if (tid < 2 * hd) pc[(1 + tid / hd) * kC + hh * hd + tid % hd] = dbkv;
  if (wlive)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(pc + kC3 + (size_t)(hh * hd + wm * 16 + gq + 8 * hf) * kC +
                                 wn * 8 + 2 * q4) = make_float2(dwo[0][2 * hf], dwo[0][2 * hf + 1]);
  if (hh == 0 && tid < kC) pc[kC3 + kC * kC + tid] = dbo;
  float* db = dbpart + ((size_t)split * heads + hh) * t * t;
  if (live)
    for (int j = 0; j < nt; ++j) {
      const float4 a = reinterpret_cast<const float4*>(dbf)[(j * kBW + warp) * 32 + lane];
      const size_t i = (size_t)(q0 + lr0) * t + n0 + 8 * j + 2 * q4;
      *reinterpret_cast<float2*>(db + i) = make_float2(a.x, a.y);
      *reinterpret_cast<float2*>(db + i + (size_t)8 * t) = make_float2(a.z, a.w);
    }
}

// ------------------------------------------ the projection adjoint kernel
// Over all NW * T rows, in tiles of 64: dx = dqkv . Wqkv^T (all 3C columns
// in one product, so the sum over heads stays in one accumulator), and
// dWqkv += x^T dqkv into the block's partial part[block] (C x 3C f32).
// Wqkv resident; the next tile's dqkv and x rows load while this one
// computes. Warps: dx m-tile warp % 4, columns 32 (warp / 4) ..; dWqkv
// m-tile warp % 4 (channels), columns 96 (warp / 4) ...
constexpr int kProjRows = 64;

template <typename E>
__host__ __device__ inline size_t proj_ld(int cols) {
  return cols + BwdCfg<E>::kPad;
}

template <typename E>
__host__ __device__ inline size_t proj_smem() {
  return (kC * proj_ld<E>(kC3) + 2 * kProjRows * (proj_ld<E>(kC3) + proj_ld<E>(kC))) * sizeof(E);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
wattn_bwd_proj_kernel(const E* __restrict__ dqkv, const E* __restrict__ x,
                      const E* __restrict__ wqkv, E* __restrict__ dx, float* __restrict__ part,
                      int nrows) {
  const int ldq = (int)proj_ld<E>(kC3), ldx = (int)proj_ld<E>(kC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ws = reinterpret_cast<E*>(smem_raw);
  E* buf = ws + kC * ldq;   // 2 x (dqkv tile [64][ldq], x tile [64][ldx])
  const int bstride = kProjRows * (ldq + ldx);
  const int ntile = (nrows + kProjRows - 1) / kProjRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;

  auto load = [&](int tile, int b) {
    const int r0 = tile * kProjRows, rows = min(kProjRows, nrows - r0);
    E* d = buf + b * bstride;
    copy_rows_async(d, ldq, dqkv + (size_t)r0 * kC3, kC3, rows, kC3);
    copy_rows_async(d + kProjRows * ldq, ldx, x + (size_t)r0 * kC, kC, rows, kC);
  };
  copy_rows_async(ws, ldq, wqkv, kC3, kC, kC3);
  if ((int)blockIdx.x < ntile) load(blockIdx.x, 0);
  cp_async_commit();

  float dw[12][4];
  zero_acc(dw);
  int b = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, b ^= 1) {
    if (tile + (int)gridDim.x < ntile) load(tile + gridDim.x, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int r0 = tile * kProjRows, rows = min(kProjRows, nrows - r0);
    const E* dq = buf + b * bstride;
    const E* xs = dq + kProjRows * ldq;
    if (mt * 16 < rows) {
      float acc[4][4];
      zero_acc(acc);
      bwd_mma<E, false, false, 4>(acc, dq, ldq, mt * 16, ws, ldq, half * 32, 0, kC3, 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store2(dx + (size_t)(r0 + mt * 16 + gq + 8 * hf) * kC + half * 32 + 8 * j + 2 * q4,
                 acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
    bwd_mma<E, true, true, 12>(dw, xs, ldx, mt * 16, dq, ldq, half * 96, 0, rows, 12);
    __syncthreads();   // this buffer is the next-but-one tile's
  }
  cp_async_wait<0>();
  float* p = part + (size_t)blockIdx.x * kC * kC3;
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(p + (size_t)(mt * 16 + gq + 8 * hf) * kC3 + half * 96 + 8 * j +
                                 2 * q4) = make_float2(dw[j][2 * hf], dw[j][2 * hf + 1]);
}

template <typename E, int HD>
int launch_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
               const float* bias, const float* mask, const void* g, void* dx, void* dqkv,
               float* part_w, float* part_c, float* part_b, float* grads, int nw, int t, int nm,
               int heads, int nsplit, int nproj, float scale, cudaStream_t stream) {
  static bool done_c = false, done_p = false;
  cudaError_t e = allow_smem(wattn_bwd_core_kernel<E, HD>, core_smem<E>(kMaxT, HD).bytes, done_c);
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(wattn_bwd_proj_kernel<E>, proj_smem<E>(), done_p)) != cudaSuccess)
    return (int)e;
  const int hd = kC / heads, nq = (t + BwdCfg<E>::R - 1) / BwdCfg<E>::R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq * heads * nsplit);
  cfg.blockDim = dim3(kBT);
  cfg.dynamicSmemBytes = core_smem<E>(t, hd).bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nq;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wattn_bwd_core_kernel<E, HD>, static_cast<const E*>(x),
                         static_cast<const E*>(wqkv), bqkv, static_cast<const E*>(wo), bias,
                         mask, static_cast<const E*>(g), static_cast<E*>(dqkv), part_c, part_b,
                         nw, t, nm, heads, nsplit, scale);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wattn_bwd_proj_kernel<E><<<nproj, kThreads, proj_smem<E>(), stream>>>(
      static_cast<const E*>(dqkv), static_cast<const E*>(x), static_cast<const E*>(wqkv),
      static_cast<E*>(dx), part_w, nw * t);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // grads = [dWqkv | dbqkv, dWo, dbo | dbias], each summed in slot order
  const int ww = kC * kC3, nb = heads * t * t;
  sum_partials_kernel<<<(ww + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_w, grads, 1, nproj, ww);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(kCoreW + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_c, grads + ww, 1, nq * nsplit, kCoreW);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_b, grads + ww + kCoreW, 1, nsplit, nb);
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

// The tiled forward: T tokens a window, a multiple of sres_wattn_tile() up
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

// The backward's shape constants: query rows a core CTA owns (a cluster
// holds ceil(T / rows) CTAs) and rows of a projection tile.
int sres_wattn_bwd_rows(int bf16_) { return bf16_ ? BwdCfg<bf16>::R : BwdCfg<float>::R; }
int sres_wattn_bwd_proj_rows() { return kProjRows; }

// The backward at any T of the tiled forward (64 included); operands as
// sres_wattn_tiled_fwd, plus g (the cotangent of y) and dx, both like x; bo
// is not read. nsplit window ranges (1 <= nsplit <= nw), nproj projection
// blocks (1 <= nproj <= the count of 64-row tiles of the nw * t rows).
// Scratch: dqkv (nw, t, 3*64) of x's type; f32 partials part_w (nproj,
// 64*192), part_c (nq * nsplit, 4*64 + 64*64) with nq = ceil(t /
// sres_wattn_bwd_rows(bf16_)), part_b (nsplit, heads, t, t). Out: grads
// (4*64*64 + 4*64 + heads*t*t,) f32 = [dWqkv (64, 192) | dbqkv (192,) | dWo
// (64, 64) | dbo (64,) | dbias (heads, t, t)], summed over the windows.
int sres_wattn_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                   const float* bo, const float* bias, const float* mask, const void* g,
                   void* dx, void* dqkv, float* part_w, float* part_c, float* part_b,
                   float* grads, int nw, int t, int nm, int heads, float scale, int nsplit,
                   int nproj, int bf16_, int device, void* stream) {
  (void)bo;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long ntile = ((long long)nw * t + kProjRows - 1) / kProjRows;
  if (bad_tiled_shape(nw, t, nm, mask, heads) || nsplit < 1 || nsplit > nw || nproj < 1 ||
      nproj > ntile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel_launch) {
    return kernel_launch(x, wqkv, bqkv, wo, bias, mask, g, dx, dqkv, part_w, part_c, part_b,
                         grads, nw, t, nm, heads, nsplit, nproj, scale, s);
  };
  if (bf16_) return heads == 4 ? launch(launch_bwd<bf16, 16>) : launch(launch_bwd<bf16, 32>);
  return heads == 4 ? launch(launch_bwd<float, 16>) : launch(launch_bwd<float, 32>);
}

}  // extern "C"
