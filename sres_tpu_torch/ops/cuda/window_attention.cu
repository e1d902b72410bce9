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
// Layout: x, g, y, dx are (NW, T, C) row-major in the activation type E
// (float or bf16); Wqkv (C, 3C) and Wo (C, C) in E; bqkv, bo, bias (h, T, T)
// and the group mask (nm, T, T) in f32. Rounding points: see
// sres_tpu_torch/ops/window_attention.py (q, k, v, p, o, do, ds*hd^-1/2 and
// dqkv round to E; scores, softmax, dp, ds and every sum stay f32).
//
// Both directions are one design for every T that is a multiple of 16 up to
// 256 (4x4 ... 16x16 windows), built from the same stages (B)-(E) of a
// window: (B) the CTA's rows of q, k, v, (C) their scores, (D) the exact
// softmax, (E) o = p.V.
//  - The core kernels run one thread-block cluster per (head, window
//    range) of nq = ceil(T / R) CTAs of 512 threads, each owning R query
//    rows (R = 64 in bf16, 32 in f32; a short last CTA at T = 144). Per
//    window each CTA projects its rows' q, k, v from x (the head's Wqkv
//    columns resident), pushes k and v to every CTA of the cluster through
//    distributed shared memory, and keeps the scores as mma accumulators
//    in registers (16 warps, 4 x 4 over rows and columns in bf16; row
//    reductions by quad shuffles and a few shared floats), so the softmax
//    is exact over all T keys with no recompute, no stash and no f32
//    score tile. The next window's x rows load (cp.async) while the
//    current one computes.
//  - Every product's operands are staged in shared memory by 16-byte copies
//    and reach mma.sync m16n8k16 through ldmatrix.
//
// Forward: wattn_fwd_core_kernel writes o (NW, T, C) in E at each head's
// columns, then wattn_fwd_proj_kernel forms y = o.Wo + bo over tiles of 64
// rows (y needs every head's o; the core clusters are per head). Per call
// at SwinIR-w16's shape (batch 12: 432 windows of T = 256, 4 heads): x
// read and y written, the group mask, weights and bias (38.7 MB, 0.0116
// ms at 3.35 TB/s), 10.9 GFLOP of products (0.0110 ms at 989 TFLOP/s):
// bytes bound it on paper; o's round trip adds 28.3 MB, mostly in L2.
// What bounds the kernel in practice is latency at one 16-warp CTA per SM
// and a handful of barriers per window, and the L2's bandwidth for the
// f32 bias and mask: read per window they would be 0.45 GB a call each.
// So the head's (R x T) bias slice stays in shared memory for the whole
// window range (a CTA's head and query rows never change), and a range
// walks its windows grouped by w % nm, so that each thread's mask values
// stay in registers across a group (12 windows at SwinIR's shapes). A
// cluster's CTAs may be a window apart: window i + 1's k, v push waits on a
// split cluster barrier (arrive after the CTA's last read of K, V in (E),
// wait before the push), so one full cluster barrier per window remains.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, bf16 (sres_tpu_torch/probes/
// wattn_ab.py): 0.213-0.217 ms at 1728 windows of T = 64 shifted, 0.443-
// 0.446 at 432 of T = 256 shifted, against 0.55 and 2.17 for the two
// earlier forward kernels (whose products gathered every operand element
// by element, with an f32 score tile in shared memory) and the
// composition's about 0.39 and 0.86 (PERF.md). Reading the mask for every
// window took 0.50-0.51 at T = 256.

// Backward: the core kernel also keeps dp in registers and a (R x T) f32
// dbias slice in shared memory across the whole window range, each element
// always updated by the same thread; dWo_h and the bias-gradient columns
// stay in registers. dq is complete per CTA; the dk and dv partials over
// each CTA's rows are summed in rank order through distributed shared
// memory. dqkv (in E) goes to device memory once. wattn_bwd_proj_kernel
// forms dx = dqkv.Wqkv^T over all 3C columns in one product (the sum over
// heads in one accumulator, as in the twin) and per-block partials of
// dWqkv = x^T dqkv; sum_partials_kernel adds the partials in a fixed order:
// no atomics, every run gives the same bits. The number of window ranges
// and of projection blocks is a function of the shape, never of the card.
// Per call at SwinIR-w16's shape: x and g read, dx written (42.5 MB, 0.016
// ms) and 31.7 GFLOP of products (0.032 ms): operations bound it. Bias and
// mask are read through L1 from L2 in the score epilogue: a resident bias
// slice would take the shared memory that L1 needs for the mask's reads,
// beside the dbias slice. Measured on an H100 SXM (700 W), bf16, shifted:
// 1.10 ms at SwinIR-w16's shape (an earlier three-kernel backward with a
// q/k/v/do stash in device memory 11.0; the composition's autograd
// backward 1.81) and 0.57 ms at SwinIR's 1728 windows of T = 64 (2.47; the
// composition 1.69), 34x and 36x their bounds: latency at one 16-warp CTA
// per SM, about a dozen barriers a window, and no part dominant
// (sres_tpu_torch/probes/wattn_bwd_variants.py): the bias and mask reads
// take 0.30 of the 1.10 ms at T = 256 (and push the bf16 kernels past the
// 128 registers a thread of 512 has: 160-208 bytes of spills), p.V and
// ds.K, where 4 of 16 warps work at head width 16, 0.11, every other
// product, the exp and the exchange barrier 0.03-0.08 each.
// Clusters must fit the card in one wave: an H100 holds 30 clusters of 4
// such CTAs, so the wrapper sizes both core grids to 28 (32 took 1.64x as
// long in the backward).

#include <cooperative_groups.h>
#include <math_constants.h>
#include <type_traits>

#include "wino_common.cuh"

namespace {

constexpr int kC3 = 3 * kC;
constexpr int kMaxHd = 32;   // head widths 16 and 32 (h = 4, 2)
constexpr int kTile = 16;    // T is a multiple of this
constexpr int kMaxT = 256;   // 16 x 16 windows

// Every product runs on warp_mma: operands staged in shared memory by
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
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const E* a, int lda, int m0,
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

// ------------------------------------------------ the core CTAs' geometry
constexpr int kBT = 512;          // threads of a core CTA
constexpr int kBW = kBT / 32;     // its warps
static_assert(kMaxT / 16 <= kBW, "a warp holds the dk, dv rows of one 16-key tile");

// Per element type: query rows a CTA owns (R; the cluster has ceil(T / R)
// CTAs), the warps' 4 x 4 (bf16) or 2 x 8 (f32) grid over its score rows
// and columns, and the score n-tiles a warp holds at T = 256.
template <typename E>
struct CoreCfg {
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
  constexpr int CG = CoreCfg<E>::CG;
  const int nk = t / 16, base = nk / CG, extra = nk % CG;
  n0 = 16 * (cg * base + (cg < extra ? cg : extra));
  nt = 2 * (base + (cg < extra ? 1 : 0));
}

// ------------------------------------------- stages (B)-(E) of one window
// Called by every thread of the CTA. The forward and backward core kernels
// share (B), the k, v exchange and (E), so the backward's recomputed o is
// the forward's. (C) and (D) are written twice, as the same arithmetic: the
// backward keeps them inline, because as functions they cost its bf16
// instances 24-40 more bytes of spills at the 128-register cap (ptxas -v),
// and the forward's copies below read the bias from shared memory.

// The head's columns of Wqkv (C x 3 hd: q | k | v) into wq (row stride
// ldw), resident for the window range (cp.async; the caller commits).
template <typename E, int HD>
__device__ __forceinline__ void load_head_weights(E* wq, int ldw, const E* __restrict__ wqkv,
                                                  int hh) {
  constexpr int cph = HD * (int)sizeof(E) / 16;
  constexpr int kV = 16 / sizeof(E);
  for (int i = threadIdx.x; i < kC * 3 * cph; i += kBT) {
    const int c = i / (3 * cph), seg = (i / cph) % 3, ch = i % cph;
    cp_async16(wq + c * ldw + seg * HD + ch * kV, wqkv + (size_t)c * kC3 + seg * kC + hh * HD + ch * kV);
  }
}

// (B) q, k, v of the CTA's rows: [rows x C] . [C x 3 hd] + b, rounded to E;
// q to qs row r, k and v to ks, vs row q0 + r (row stride ldh)
template <typename E, int HD>
__device__ __forceinline__ void stage_qkv(const E* xs, int ldx, const E* wq, int ldw,
                                          const float* bq, E* qs, E* ks, E* vs, int ldh, int q0,
                                          int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  constexpr int npair = 3 * HD / 16;
  for (int u = warp; u < (rows / 16) * npair; u += kBW) {
    const int mt = u / npair, np = u % npair;
    float acc[2][4];
    zero_acc(acc);
    warp_mma<E, false, true, 2>(acc, xs, ldx, mt * 16, wq, ldw, np * 16, 0, kC, 2);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + gq + 8 * hf, col = np * 16 + 8 * j + 2 * q4;
        const int seg = col / HD, c = col % HD;
        E* dst = seg == 0 ? qs + r * ldh : (seg == 1 ? ks : vs) + (q0 + r) * ldh;
        store2(dst + c, acc[j][2 * hf] + bq[col], acc[j][2 * hf + 1] + bq[col + 1]);
      }
  }
}

// This CTA's k, v rows [q0, q0 + rows) into the K, V of every other CTA of
// the cluster: 16-byte distributed-shared-memory stores.
template <typename E, int HD>
__device__ __forceinline__ void push_kv(cooperative_groups::cluster_group& cluster, E* ks, E* vs,
                                        int ldh, int q0, int rows, int nq, int qt) {
  constexpr int cph = HD * (int)sizeof(E) / 16, kV = 16 / sizeof(E);
  const int n = rows * cph;
  for (int i = threadIdx.x; i < 2 * n; i += kBT) {
    const int r = (i % n) / cph, ch = i % cph;
    E* src = (i < n ? ks : vs) + (q0 + r) * ldh + ch * kV;
    const uint4 val = *reinterpret_cast<const uint4*>(src);
    for (int rank = 0; rank < nq; ++rank)
      if (rank != qt) *reinterpret_cast<uint4*>(cluster.map_shared_rank(src, rank)) = val;
  }
}

// The mask values of the thread's score elements (stage_scores' layout),
// read through L1 from L2 into registers, where they stay for the windows
// of one w % nm group. mask_r: the CTA's first row of mask[w % nm] (row
// stride t).
template <int NT>
__device__ __forceinline__ void load_mask(float2 (&mk)[NT][2], const float* mask_r, int t, int rg,
                                          int n0, int nt) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        mk[j][hf] = ldg2(mask_r + (size_t)(rg * 16 + gq + 8 * hf) * t + n0 + 8 * j + 2 * q4);
}

// (C) the scores of the warp's 16 rows (row group rg) and columns [n0, n0 +
// 8 nt) as mma accumulators, then s * scale + bias, then + mask (if
// masked, from load_mask): the twin's order. bias_r: the CTA's rows of the
// head's bias in shared memory (row stride ldb).
template <typename E, int NT>
__device__ __forceinline__ void stage_scores(float (&sc)[NT][4], const E* qs, const E* ks, int ldh,
                                             int hd, int rg, int n0, int nt, const float* bias_r,
                                             int ldb, const float2 (&mk)[NT][2], bool masked,
                                             float scale) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const int lr0 = rg * 16 + gq;
  warp_mma<E, false, false, NT>(sc, qs, ldh, rg * 16, ks, ldh, n0, 0, hd, nt);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = lr0 + 8 * hf, col = n0 + 8 * j + 2 * q4;
        const float2 b = *reinterpret_cast<const float2*>(bias_r + r * ldb + col);
        float v0 = sc[j][2 * hf] * scale + b.x, v1 = sc[j][2 * hf + 1] * scale + b.y;
        if (masked) {
          v0 += mk[j][hf].x;
          v1 += mk[j][hf].y;
        }
        sc[j][2 * hf] = v0;
        sc[j][2 * hf + 1] = v1;
      }
}

// (D) the exact softmax over all T columns of the warp's rows, in place:
// row max and sum over the quad, then over the column groups (in order)
// through red0 and red1 (CG x R floats each); p rounded to E into pb (row
// stride ldp) where the warp's rows exist (live). Two CTA barriers.
template <typename E, int NT>
__device__ __forceinline__ void stage_softmax(float (&sc)[NT][4], float* red0, float* red1, E* pb,
                                              int ldp, int rg, int cgi, int n0, int nt,
                                              bool live) {
  constexpr int R = CoreCfg<E>::R, CG = CoreCfg<E>::CG;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const int lr0 = rg * 16 + gq;
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
        store2(pb + lr0 * ldp + col, sc[j][0], sc[j][1]);
        store2(pb + (lr0 + 8) * ldp + col, sc[j][2], sc[j][3]);
      }
  }
}

// (E) o = p . V for the CTA's rows, rounded to E into dst (row stride ldd;
// shared or device memory)
template <typename E, int HD>
__device__ __forceinline__ void stage_pv(const E* pb, int ldp, const E* vs, int ldh, E* dst,
                                         int ldd, int rows, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  constexpr int npair = HD / 16;
  for (int u = warp; u < (rows / 16) * npair; u += kBW) {
    const int mt = u / npair, np = u % npair;
    float acc[2][4];
    zero_acc(acc);
    warp_mma<E, false, true, 2>(acc, pb, ldp, mt * 16, vs, ldh, np * 16, 0, t, 2);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store2(dst + (mt * 16 + gq + 8 * hf) * ldd + np * 16 + 8 * j + 2 * q4, acc[j][2 * hf],
               acc[j][2 * hf + 1]);
  }
}

// ================================================================ forward
// Shared-memory map of the forward core kernel (byte offsets; leading
// dimensions in elements), the same on host and device. The bias slice's
// rows are padded by 8 floats: the score layout's float2 reads of a half
// warp (four rows, eight columns each) fall in distinct banks.
struct FwdSmem {
  size_t bias, x, wq, q, k, v, p, red, bq, bytes;
  int ldb, ldx, ldw, ldh, ldp;
};

template <typename E>
__host__ __device__ inline FwdSmem fwd_smem(int t, int hd) {
  using Cf = CoreCfg<E>;
  const int es = sizeof(E);
  FwdSmem s{};
  s.ldb = t + 8;                // the bias slice, f32
  s.ldx = kC + Cf::kPad;        // x rows
  s.ldw = 3 * hd + Cf::kPad;    // Wqkv's head columns
  s.ldh = hd + Cf::kPad;        // q, K, V
  s.ldp = t + Cf::kPad;         // p in E
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  };
  s.bias = take((size_t)Cf::R * s.ldb * sizeof(float));
  s.x = take((size_t)Cf::R * s.ldx * es);
  s.wq = take((size_t)kC * s.ldw * es);
  s.q = take((size_t)Cf::R * s.ldh * es);
  s.k = take((size_t)t * s.ldh * es);
  s.v = take((size_t)t * s.ldh * es);
  s.p = take((size_t)Cf::R * s.ldp * es);
  s.red = take((size_t)2 * Cf::CG * Cf::R * sizeof(float));
  s.bq = take((size_t)3 * hd * sizeof(float));
  s.bytes = off;
  return s;
}

// Grid: nq x heads x nsplit CTAs, clusters of the nq = ceil(T / R) CTAs of
// one (head, window range); CTA rank qt owns query rows [qt R, qt R + rows).
// Per window: (B) its rows' q, k, v for the head, k and v pushed to every
// CTA of the cluster; (C, D) scores (+ the resident bias, + the mask from
// L2) and the exact softmax in registers, p in E to shared memory; (E) o_h
// = p.V in E to o (NW, T, C) at the head's columns. HD = C / heads.
template <typename E, int HD>
__global__ void __launch_bounds__(kBT, 1)
wattn_fwd_core_kernel(const E* __restrict__ x, const E* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const float* __restrict__ bias,
                      const float* __restrict__ mask, E* __restrict__ o, int nw, int t, int nm,
                      int heads, int nsplit, float scale) {
  using Cf = CoreCfg<E>;
  constexpr int R = Cf::R, NT = Cf::NT;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = (t + R - 1) / R;
  const int qt = (int)cluster.block_rank();
  const int hh = (blockIdx.x / nq) % heads, split = blockIdx.x / (nq * heads);
  const int q0 = qt * R, rows = min(R, t - q0);
  const int w0 = (int)((long long)split * nw / nsplit);
  const int w1 = (int)((long long)(split + 1) * nw / nsplit);
  const int warp = threadIdx.x >> 5, rg = warp % Cf::RG, cgi = warp / Cf::RG;
  const bool live = rg * 16 < rows;   // this warp's score rows exist
  int n0, nt;
  score_cols<E>(t, cgi, n0, nt);

  const FwdSmem L = fwd_smem<E>(t, HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw + L.bias);
  E* xs = reinterpret_cast<E*>(smem_raw + L.x);
  E* wq = reinterpret_cast<E*>(smem_raw + L.wq);
  E* qs = reinterpret_cast<E*>(smem_raw + L.q);
  E* ks = reinterpret_cast<E*>(smem_raw + L.k);
  E* vs = reinterpret_cast<E*>(smem_raw + L.v);
  E* pb = reinterpret_cast<E*>(smem_raw + L.p);
  float* red0 = reinterpret_cast<float*>(smem_raw + L.red);
  float* red1 = red0 + Cf::CG * R;
  float* bq = reinterpret_cast<float*>(smem_raw + L.bq);

  // Windows in an order that keeps w % nm for nw / nm windows in a row: the
  // range's index i runs over (w % nm, w / nm), so a thread's mask values
  // stay in registers until the group changes.
  const int per = nm > 0 ? nw / nm : nw;
  auto window = [&](int i) { return nm > 0 ? (i % per) * nm + i / per : i; };
  float2 mk[NT][2];
  const bool masked = mask != nullptr;

  // resident for the range: the head's weights and its bias rows; then the
  // first window's x rows
  load_head_weights<E, HD>(wq, L.ldw, wqkv, hh);
  copy_rows_async(bs, L.ldb, bias + ((size_t)hh * t + q0) * t, t, rows, t);
  copy_rows_async(xs, L.ldx, x + ((size_t)window(w0) * t + q0) * kC, kC, rows, kC);
  cp_async_commit();
  for (int j = threadIdx.x; j < 3 * HD; j += kBT) bq[j] = bqkv[(j / HD) * kC + hh * HD + j % HD];

  // K and V between windows: a CTA pushes window i + 1's rows only once
  // every CTA of the cluster has arrived after its last read of window i's
  // (E); the first wait also finds every CTA running
  if (nq > 1) cluster_arrive();
  for (int i = w0; i < w1; ++i) {
    const int w = window(i);
    cp_async_wait<0>();
    __syncthreads();
    if (masked && live && (i == w0 || i % per == 0))
      load_mask(mk, mask + ((size_t)(w % nm) * t + q0) * t, t, rg, n0, nt);
    stage_qkv<E, HD>(xs, L.ldx, wq, L.ldw, bq, qs, ks, vs, L.ldh, q0, rows);   // (B)
    __syncthreads();
    if (i + 1 < w1)
      copy_rows_async(xs, L.ldx, x + ((size_t)window(i + 1) * t + q0) * kC, kC, rows, kC);
    cp_async_commit();
    if (nq > 1) {
      cluster_wait();
      push_kv<E, HD>(cluster, ks, vs, L.ldh, q0, rows, nq, qt);
      cluster.sync();   // K, V whole in every CTA
    }
    float sc[NT][4];
    zero_acc(sc);
    if (live) stage_scores<E, NT>(sc, qs, ks, L.ldh, HD, rg, n0, nt, bs, L.ldb, mk, masked, scale);
    stage_softmax<E, NT>(sc, red0, red1, pb, L.ldp, rg, cgi, n0, nt, live);   // (D)
    __syncthreads();   // p whole
    stage_pv<E, HD>(pb, L.ldp, vs, L.ldh, o + ((size_t)w * t + q0) * kC + hh * HD, kC, rows, t);
    if (nq > 1) cluster_arrive();   // K, V read
  }
  if (nq > 1) cluster_wait();
}

// ------------------------------------------- projection tiles (both ways)
constexpr int kProjRows = 64;
constexpr int kFwdProjBlocks = 256;   // the forward projection's grid bound

template <typename E>
__host__ __device__ inline size_t proj_ld(int cols) {
  return cols + CoreCfg<E>::kPad;
}

// The forward's output projection, over all NW * T rows in tiles of 64:
// y = o . Wo + bo (bo added in f32, y rounded to E). Wo resident; the next
// tile's o rows load while this one computes. Warp w: rows 16 (w % 4) of
// the tile, columns 32 (w / 4) ... + 32.
template <typename E>
__host__ __device__ inline size_t fwd_proj_smem() {
  return (size_t)(kC + 2 * kProjRows) * proj_ld<E>(kC) * sizeof(E);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
wattn_fwd_proj_kernel(const E* __restrict__ o, const E* __restrict__ wo,
                      const float* __restrict__ bo, E* __restrict__ y, int nrows) {
  const int ld = (int)proj_ld<E>(kC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ws = reinterpret_cast<E*>(smem_raw);
  E* buf = ws + kC * ld;   // 2 x o tile [64][ld]
  const int ntile = (nrows + kProjRows - 1) / kProjRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;

  auto load = [&](int tile, int b) {
    const int r0 = tile * kProjRows;
    copy_rows_async(buf + b * kProjRows * ld, ld, o + (size_t)r0 * kC, kC,
                    min(kProjRows, nrows - r0), kC);
  };
  copy_rows_async(ws, ld, wo, kC, kC, kC);
  if ((int)blockIdx.x < ntile) load(blockIdx.x, 0);
  cp_async_commit();

  int b = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, b ^= 1) {
    if (tile + (int)gridDim.x < ntile) load(tile + gridDim.x, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int r0 = tile * kProjRows, rows = min(kProjRows, nrows - r0);
    if (mt * 16 < rows) {
      float acc[4][4];
      zero_acc(acc);
      warp_mma<E, false, true, 4>(acc, buf + b * kProjRows * ld, ld, mt * 16, ws, ld, half * 32,
                                  0, kC, 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = half * 32 + 8 * j + 2 * q4;
        const float2 bb = ldg2(bo + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store2(y + (size_t)(r0 + mt * 16 + gq + 8 * hf) * kC + col, acc[j][2 * hf] + bb.x,
                 acc[j][2 * hf + 1] + bb.y);
      }
    }
    __syncthreads();   // this buffer is the next-but-one tile's
  }
  cp_async_wait<0>();
}

// A launch of `kernel` in clusters of nq CTAs of kBT threads.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), int nq, int ctas, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kBT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nq;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename E, int HD>
int launch_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
               const float* bo, const float* bias, const float* mask, void* y, void* o, int nw,
               int t, int nm, int heads, int nsplit, float scale, cudaStream_t stream) {
  static bool done_c = false, done_p = false;
  cudaError_t e = allow_smem(wattn_fwd_core_kernel<E, HD>, fwd_smem<E>(kMaxT, HD).bytes, done_c);
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(wattn_fwd_proj_kernel<E>, fwd_proj_smem<E>(), done_p)) != cudaSuccess)
    return (int)e;
  const int nq = (t + CoreCfg<E>::R - 1) / CoreCfg<E>::R;
  e = launch_clusters(wattn_fwd_core_kernel<E, HD>, nq, nq * heads * nsplit,
                      fwd_smem<E>(t, HD).bytes, stream, static_cast<const E*>(x),
                      static_cast<const E*>(wqkv), bqkv, bias, mask, static_cast<E*>(o), nw, t,
                      nm, heads, nsplit, scale);
  if (e != cudaSuccess) return (int)e;
  const int nrows = nw * t, ntile = (nrows + kProjRows - 1) / kProjRows;
  const int nproj = ntile < kFwdProjBlocks ? ntile : kFwdProjBlocks;
  wattn_fwd_proj_kernel<E><<<nproj, kThreads, fwd_proj_smem<E>(), stream>>>(
      static_cast<const E*>(o), static_cast<const E*>(wo), bo, static_cast<E*>(y), nrows);
  return (int)cudaGetLastError();
}

// =============================================================== backward
// Two kernels and three fixed-order partial sums; see the note at the top.

// Shared-memory map of the backward core kernel (byte offsets; leading
// dimensions in elements), the same on host and device.
struct CoreSmem {
  size_t dbias, x, g, wq, wo, q, o, dO, k, v, pd, red, colq, bq, bytes;
  int ldx, ldw, ldh, ldp;
};

template <typename E>
__host__ __device__ inline CoreSmem core_smem(int t, int hd) {
  using Cf = CoreCfg<E>;
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

// Grid and cluster as the forward core kernel's; CTA rank qt owns query
// rows [qt R, qt R + rows) and, for dk and dv, the same key rows. Per
// window: (B) its rows' q, k, v for the head, k and v pushed to every CTA
// of the cluster; (C, D) scores (+ bias, mask from L2) and the exact
// softmax in registers, p in E to shared memory; (G) do = g.Wo_h^T, dbo;
// (E) o = p.V; (H) dp = do.V^T in registers; (K) the dv partial p^T do;
// (F) dWo_h += o^T g; (I) ds, dbias, and ds hd^-1/2 in E over p; (J) dq =
// ds.K, written; (K) the dk partial ds^T q; the dk | dv partials exchanged
// through distributed shared memory and (M) summed in rank order for the
// CTA's key rows, written. dqkv: (nw, T, 3C) in E. part: (nq * nsplit,
// kCoreW) f32, slot qt * nsplit + split; dbpart: (nsplit, heads, T, T) f32.
// HD = C / heads, the head width.
template <typename E, int HD>
__global__ void __launch_bounds__(kBT, 1)
wattn_bwd_core_kernel(const E* __restrict__ x, const E* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const E* __restrict__ wo,
                      const float* __restrict__ bias, const float* __restrict__ mask,
                      const E* __restrict__ g, E* __restrict__ dqkv, float* __restrict__ part,
                      float* __restrict__ dbpart, int nw, int t, int nm, int heads, int nsplit,
                      float scale) {
  using Cf = CoreCfg<E>;
  constexpr int R = Cf::R, CG = Cf::CG, NT = Cf::NT;
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
  load_head_weights<E, HD>(wq, L.ldw, wqkv, hh);
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
    stage_qkv<E, HD>(xs, L.ldx, wq, L.ldw, bq, qs, ks, vs, L.ldh, q0, rows);   // (B)
    __syncthreads();
    if (w + 1 < w1) copy_rows_async(xs, L.ldx, x + ((size_t)(w + 1) * t + q0) * kC, kC, rows, kC);
    cp_async_commit();
    if (nq > 1) push_kv<E, HD>(cluster, ks, vs, L.ldh, q0, rows, nq, qt);
    cluster.sync();   // K, V whole in every CTA

    // (C) scores of the warp's 16 rows and columns [n0, n0 + 8 nt)
    float sc[NT][4];
    zero_acc(sc);
    if (live) {
      warp_mma<E, false, false, NT>(sc, qs, L.ldh, rg * 16, ks, L.ldh, n0, 0, hd, nt);
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
        warp_mma<E, false, false, 2>(acc, gs, L.ldx, mt * 16, wos, L.ldx, np * 16, 0, kC, 2);
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
    stage_pv<E, HD>(pb, L.ldp, vs, L.ldh, os, L.ldh, rows, t);   // (E)
    // (H) dp = do . V^T, in the scores' layout
    float dp[NT][4];
    zero_acc(dp);
    if (live) warp_mma<E, false, false, NT>(dp, dos, L.ldh, rg * 16, vs, L.ldh, n0, 0, hd, nt);
    // (K) partials over the CTA's query rows, T x hd each, warp w holding
    // key rows [16 w, 16 w + 16) (T <= 16 kBW): here dv = p^T do, from p
    // before ds takes its place; dk = ds^T q after (J)
    const bool kvlive = warp < t / 16;
    float dvp[hd / 8][4];
    zero_acc(dvp);
    if (kvlive)
      warp_mma<E, true, true, hd / 8>(dvp, pb, L.ldp, warp * 16, dos, L.ldh, 0, 0, rows, hd / 8);
    __syncthreads();
    // (F) dWo_h += o^T g over the CTA's rows
    if (wlive) warp_mma<E, true, true, 1>(dwo, os, L.ldh, wm * 16, gs, L.ldx, wn * 8, 0, rows, 1);
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
        warp_mma<E, false, true, 2>(acc, dsb, L.ldp, mt * 16, ks, L.ldh, np * 16, 0, t, 2);
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
      warp_mma<E, true, true, hd / 8>(dkp, dsb, L.ldp, warp * 16, qs, L.ldh, 0, 0, rows, hd / 8);
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
      warp_mma<E, false, false, 4>(acc, dq, ldq, mt * 16, ws, ldq, half * 32, 0, kC3, 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store2(dx + (size_t)(r0 + mt * 16 + gq + 8 * hf) * kC + half * 32 + 8 * j + 2 * q4,
                 acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
    warp_mma<E, true, true, 12>(dw, xs, ldx, mt * 16, dq, ldq, half * 96, 0, rows, 12);
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
  const int nq = (t + CoreCfg<E>::R - 1) / CoreCfg<E>::R;
  e = launch_clusters(wattn_bwd_core_kernel<E, HD>, nq, nq * heads * nsplit,
                      core_smem<E>(t, HD).bytes, stream, static_cast<const E*>(x),
                      static_cast<const E*>(wqkv), bqkv, static_cast<const E*>(wo), bias, mask,
                      static_cast<const E*>(g), static_cast<E*>(dqkv), part_c, part_b, nw, t, nm,
                      heads, nsplit, scale);
  if (e != cudaSuccess) return (int)e;
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

bool bad_shape(int nw, int t, int nm, const float* mask, int heads, int nsplit) {
  const int hd = heads > 0 ? kC / heads : 0;
  return nw < 1 || heads < 1 || kC % heads || hd % 16 || hd > kMaxHd ||
         (mask != nullptr) != (nm > 0) || (nm > 0 && nw % nm) || t < kTile || t > kMaxT ||
         t % kTile || nsplit < 1 || nsplit > nw;
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" {

// Window shapes the kernels take: T a multiple of sres_wattn_tile() up to
// sres_wattn_max_tokens(); query rows a core CTA owns (a cluster holds
// ceil(T / rows) CTAs); rows of a projection tile.
int sres_wattn_tile() { return kTile; }
int sres_wattn_max_tokens() { return kMaxT; }
int sres_wattn_rows(int bf16_) { return bf16_ ? CoreCfg<bf16>::R : CoreCfg<float>::R; }
int sres_wattn_bwd_proj_rows() { return kProjRows; }

// x, y: (nw, t, 64) of float (bf16_ = 0) or bf16 (bf16_ = 1); wqkv (64,
// 192) and wo (64, 64) of the same type; bqkv (192,), bo (64,), bias
// (heads, t, t) f32; mask: null (nm = 0) or (nm, t, t) f32, window w
// reading mask[w % nm]. heads in {2, 4}; scale = (64 / heads)^-1/2. Scratch
// o: like x. nsplit window ranges (1 <= nsplit <= nw).
int sres_wattn_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                   const float* bo, const float* bias, const float* mask, void* y, void* o,
                   int nw, int t, int nm, int heads, float scale, int nsplit, int bf16_,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(nw, t, nm, mask, heads, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel_launch) {
    return kernel_launch(x, wqkv, bqkv, wo, bo, bias, mask, y, o, nw, t, nm, heads, nsplit, scale,
                         s);
  };
  if (bf16_) return heads == 4 ? launch(launch_fwd<bf16, 16>) : launch(launch_fwd<bf16, 32>);
  return heads == 4 ? launch(launch_fwd<float, 16>) : launch(launch_fwd<float, 32>);
}

// The backward; operands as sres_wattn_fwd, plus g (the cotangent of y) and
// dx, both like x; bo is not read. nproj projection blocks (1 <= nproj <=
// the count of 64-row tiles of the nw * t rows). Scratch: dqkv (nw, t,
// 3*64) of x's type; f32 partials part_w (nproj, 64*192), part_c (nq *
// nsplit, 4*64 + 64*64) with nq = ceil(t / sres_wattn_rows(bf16_)), part_b
// (nsplit, heads, t, t). Out: grads (4*64*64 + 4*64 + heads*t*t,) f32 =
// [dWqkv (64, 192) | dbqkv (192,) | dWo (64, 64) | dbo (64,) | dbias
// (heads, t, t)], summed over the windows.
int sres_wattn_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                   const float* bo, const float* bias, const float* mask, const void* g,
                   void* dx, void* dqkv, float* part_w, float* part_c, float* part_b,
                   float* grads, int nw, int t, int nm, int heads, float scale, int nsplit,
                   int nproj, int bf16_, int device, void* stream) {
  (void)bo;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long ntile = ((long long)nw * t + kProjRows - 1) / kProjRows;
  if (bad_shape(nw, t, nm, mask, heads, nsplit) || nproj < 1 || nproj > ntile)
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
