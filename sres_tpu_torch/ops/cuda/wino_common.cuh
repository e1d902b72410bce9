// Helpers shared by the kernels of this directory (winograd.cu,
// winograd_bwd.cu, window_attention.cu, fused_group.cu): channel count,
// type conversions, the transform programs of sres_tpu/ops/winograd.py
// (same operation order), the input transform of one (tile, channel), the
// bf16 mma.sync wrapper, cp.async, ldmatrix and the mbarrier wait, the
// Hopper building blocks (wgmma descriptors and fences, named barriers,
// mbarriers, bulk copies), the fixed-order sum of f32 partials.
#pragma once

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

// The inverse-transform program of sres_tpu_torch/ops/winograd.py:at_apply
// (the twins' order): out[u] = sum_i AT[u][i] * f[i]  (n -> m).
template <int M> __device__ __forceinline__ void at_apply(const float* f, float* o);
template <> __device__ __forceinline__ void at_apply<2>(const float* f, float* o) {
  o[0] = f[0] + f[1] + f[2];
  o[1] = f[1] - f[2] - f[3];
}
template <> __device__ __forceinline__ void at_apply<4>(const float* f, float* o) {
  const float s1 = f[1] + f[2], d1 = f[1] - f[2];
  const float s2 = f[3] + f[4], d2 = f[3] - f[4];
  o[0] = f[0] + s1 + s2;
  o[1] = d1 + 2.0f * d2;
  o[2] = s1 + 4.0f * s2;
  o[3] = d1 + 8.0f * d2 + f[5];
}

// The adjoint programs of sres_tpu/ops/winograd.py:bt_t_apply (:183) and
// at_t_apply (:215), same operation order.
// bt_t: out[q] = sum_i BT[i][q] * f[i]  (n -> n)
template <int M> __device__ __forceinline__ void bt_t_apply(const float* f, float* o);
template <> __device__ __forceinline__ void bt_t_apply<2>(const float* f, float* o) {
  o[0] = f[0];
  o[1] = f[1] - f[2] + f[3];
  o[2] = f[1] + f[2] - f[0];
  o[3] = -f[3];
}
template <> __device__ __forceinline__ void bt_t_apply<4>(const float* f, float* o) {
  const float u = f[1] + f[2], v = f[1] - f[2];
  const float w = f[3] + f[4], z = f[3] - f[4];
  o[0] = 4.0f * f[0];
  o[1] = 4.0f * (f[5] - v) - 2.0f * z;
  o[2] = -5.0f * f[0] - 4.0f * u - w;
  o[3] = v + 2.0f * z - 5.0f * f[5];
  o[4] = f[0] + u + w;
  o[5] = f[5];
}

// at_t: out[i] = sum_u AT[u][i] * f[u]  (m -> n)
template <int M> __device__ __forceinline__ void at_t_apply(const float* f, float* o);
template <> __device__ __forceinline__ void at_t_apply<2>(const float* f, float* o) {
  o[0] = f[0];
  o[1] = f[0] + f[1];
  o[2] = f[0] - f[1];
  o[3] = -f[1];
}
template <> __device__ __forceinline__ void at_t_apply<4>(const float* f, float* o) {
  const float s = f[0] + f[2], t = f[1] + f[3];
  const float u = f[0] + 4.0f * f[2], v = 2.0f * f[1] + 8.0f * f[3];
  o[0] = f[0];
  o[1] = s + t;
  o[2] = s - t;
  o[3] = u + v;
  o[4] = u - v;
  o[5] = f[3];
}

// An activation load: plain, or (kCoherent) ld.global.cg from L2, for a
// kernel that reads what other blocks of the same launch wrote before a
// grid-wide barrier (the read-only and L1 paths are not coherent there).
template <bool kCoherent, typename T>
__device__ __forceinline__ float load_act(const T* p) {
  if constexpr (kCoherent) return to_f(__ldcg(p));
  return to_f(*p);
}

// ------------------------------------------------------- input transform
// Shared by the forward and backward conv kernels: V = BT . d . B of one (tile, input
// channel), SAME zero padding, each stage rounded to T. The n*n loads are
// unconditional (clamped address, zeroed value) so all are in flight at once.
template <typename T, int M, bool kCoherent = false>
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
      const float val = load_act<kCoherent>(xb + ((size_t)yc * w + xc) * kC);
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

// two bf16 values in one 32-bit word, the first in the low half
__device__ __forceinline__ uint32_t pack_bf(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ PTX helpers
// 16-byte asynchronous copies into shared memory, and ldmatrix (.trans for
// an operand stored transposed), which feeds mma.sync from shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
}

// Wait for phase `parity` of an mbarrier in this CTA's shared memory; traps
// (a launch error, not a hang) if it never completes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 24)) __trap();
  }
}

// ------------------------------------------------ Hopper building blocks
// A wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices adjacent in K (lbo) and in M or N (sbo).
// A start offset of `off` bytes is desc + (off >> 4).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching accumulators across wgmma_wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) become
// visible to wgmma's async-proxy reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arm `bar` for `bytes` of asynchronous copies (this thread's arrival).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// A bulk copy of `bytes` (a multiple of 16) from global to this CTA's shared
// memory, completing on the mbarrier `bar` (the async proxy, as wgmma reads).
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// out[o][i] = sum_s part[o][s][i], in order of s
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int nouter, int nsplit, int inner) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)nouter * inner) return;
  const int o = (int)(idx / inner), i = (int)(idx % inner);
  float t = 0.0f;
  for (int s = 0; s < nsplit; ++s) t += part[((size_t)o * nsplit + s) * inner + i];
  out[idx] = t;
}

}  // namespace
