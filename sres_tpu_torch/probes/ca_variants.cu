// Variants of the fused trunk's channel-attention stream, for
// probes/ca_variants.py: out = bf16(x + c * gate) at (72, 64, 48, 48), x bf16,
// c f32, 18 partial rows a sample, hidden 32; one line of device times in
// microseconds (CUDA events over 20 back-to-back launches, after 3).
//   ldg:       gates computed beforehand, plain launch, loads through L1
//              (__ldg); 3 vectors a thread in flight, as ca_common.cuh's
//              CaStream;
//   noalloc:   the same, loads that skip L1 (ldg16, as shipped);
//   coop:      noalloc launched cooperatively, with a grid barrier and no
//              gate work before it;
//   gates:     coop with each sample's gate computed by block `sample`
//              before the barrier (the shipped scheme);
//   ring:      gates beforehand; x and c staged through a ring of three
//              64-pixel shared-memory stages filled by bulk copies;
//   cpasync:   gates beforehand; a per-thread pipeline of four cp.async
//              stages in shared memory;
//   copy:      out = bf16(x + c) with no gate: the stream alone.
#include <cstdio>
#include <cstdlib>

#include "../ops/cuda/ca_common.cuh"

namespace {

struct Args {
  const bf16* x;
  const float* c;
  const float* part;
  const float *w1, *b1, *w2, *b2;
  bf16* xn;
  float* gate;
  int nimg, hw, npart, hidden;
};

constexpr int kB = 3;

template <bool kL1>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (kL1) return __ldg(reinterpret_cast<const uint4*>(p));
  return ldg16(p);
}

// kMode 0: gates given; 1: grid barrier first; 2: gates, then the barrier;
// 3: no gate at all (copy)
template <bool kL1, int kMode>
__global__ void __launch_bounds__(kThreads, 3) stream_var(Args a) {
  __shared__ __align__(16) float stage[kCaRowChunk][kC];
  __shared__ float mlp[3][kC];
  const int tid = threadIdx.x;
  if (kMode == 2 && (int)blockIdx.x < a.nimg) {
    CaWeights cw;
    ca_load_weights(cw, a.w1, a.b1, a.w2, a.b2, a.hidden);
    ca_sum_rows<false>(a.part + (size_t)blockIdx.x * a.npart * kC, a.npart, stage, mlp[0]);
    if (tid < kC) mlp[0][tid] = rnd<bf16>(mlp[0][tid] / (float)a.hw);
    __syncthreads();
    ca_mlp<bf16, true>(cw, mlp[0], mlp[1], mlp[2], a.hidden);
    if (tid < kC) a.gate[(size_t)blockIdx.x * kC + tid] = mlp[2][tid];
  }
  const long long npix = (long long)a.nimg * a.hw;
  const long long p0 = npix * blockIdx.x / gridDim.x, p1 = npix * (blockIdx.x + 1) / gridDim.x;
  const long long v1 = p1 * 8, per = (long long)a.hw * 8;
  long long v = p0 * 8 + tid;
  uint4 xs[kB], cs[kB][2];
  auto load = [&](long long at) {
#pragma unroll
    for (int j = 0; j < kB; ++j, at += kThreads) {
      if (at >= v1) break;
      xs[j] = load16<kL1>(a.x + at * 8);
      cs[j][0] = load16<kL1>(a.c + at * 8);
      cs[j][1] = load16<kL1>(a.c + at * 8 + 4);
    }
  };
  load(v);
  if (kMode == 1 || kMode == 2) cooperative_groups::this_grid().sync();
  const int grp = tid % 8;
  long long next = 0;
  float g[8] = {1, 1, 1, 1, 1, 1, 1, 1};
  for (; v < v1; v += kB * kThreads) {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const long long vj = v + j * kThreads;
      if (vj >= v1) break;
      if (kMode != 3 && vj >= next) {
        const long long im = vj / per;
        next = (im + 1) * per;
        for (int k = 0; k < 8; k += 4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(a.gate + im * kC + grp * 8 + k));
          g[k] = q.x, g[k + 1] = q.y, g[k + 2] = q.z, g[k + 3] = q.w;
        }
      }
      float xf[8], cf[8], o[8];
      unpack16<bf16>(xs[j], xf);
      unpack16<float>(cs[j][0], cf);
      unpack16<float>(cs[j][1], cf + 4);
      for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(xf[k], __fmul_rn(cf[k], g[k]));
      stg16(a.xn + vj * 8, pack16<bf16>(o));
    }
    if (v + kB * kThreads < v1) load(v + kB * kThreads);
  }
}

// x and c through a ring of kSt stages of kPix pixels, bulk copies (thread 0)
template <int kPix, int kSt>
__global__ void __launch_bounds__(kThreads) ring_var(Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t full[kSt];
  constexpr uint32_t kX = kPix * 128, kStage = kPix * 384;
  const int tid = threadIdx.x;
  const long long npix = (long long)a.nimg * a.hw;
  const long long p0 = npix * blockIdx.x / gridDim.x, p1 = npix * (blockIdx.x + 1) / gridDim.x;
  const int nst = (int)((p1 - p0 + kPix - 1) / kPix);
  auto fill = [&](int k) {
    const long long s0 = p0 + (long long)k * kPix;
    const uint32_t n = (uint32_t)min((long long)kPix, p1 - s0);
    const uint32_t st = smem_u32(sm + (k % kSt) * kStage), bar = smem_u32(&full[k % kSt]);
    mbar_expect_tx(bar, n * 384);
    bulk_g2s(st, a.x + s0 * 64, n * 128, bar);
    bulk_g2s(st + kX, a.c + s0 * 64, n * 256, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kSt && k < nst; ++k) fill(k);
  }
  __syncthreads();
  const int grp = tid % 8;
  const long long per = (long long)a.hw * 8;
  long long next = 0;
  float g[8];
  for (int k = 0; k < nst; ++k) {
    const long long s0 = p0 + (long long)k * kPix;
    const int nv = (int)min((long long)kPix, p1 - s0) * 8;
    const unsigned char* st = sm + (k % kSt) * kStage;
    mbar_wait(smem_u32(&full[k % kSt]), (k / kSt) & 1);
    for (int v = tid; v < nv; v += kThreads) {
      const long long gv = s0 * 8 + v;
      if (gv >= next) {
        const long long im = gv / per;
        next = (im + 1) * per;
        for (int j = 0; j < 8; j += 4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(a.gate + im * kC + grp * 8 + j));
          g[j] = q.x, g[j + 1] = q.y, g[j + 2] = q.z, g[j + 3] = q.w;
        }
      }
      float xf[8], cf[8], o[8];
      unpack16<bf16>(*reinterpret_cast<const uint4*>(st + v * 16), xf);
      unpack16<float>(*reinterpret_cast<const uint4*>(st + kX + v * 32), cf);
      unpack16<float>(*reinterpret_cast<const uint4*>(st + kX + v * 32 + 16), cf + 4);
      for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(xf[j], __fmul_rn(cf[j], g[j]));
      stg16(a.xn + gv * 8, pack16<bf16>(o));
    }
    __syncthreads();
    if (tid == 0 && k + kSt < nst) fill(k + kSt);
  }
}

// a per-thread pipeline of kD cp.async stages ([kD][3][kThreads][16 bytes])
template <int kD>
__global__ void __launch_bounds__(kThreads, 3) cpasync_var(Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x;
  const long long npix = (long long)a.nimg * a.hw;
  const long long p0 = npix * blockIdx.x / gridDim.x, p1 = npix * (blockIdx.x + 1) / gridDim.x;
  const long long v1 = p1 * 8, per = (long long)a.hw * 8, vb = p0 * 8 + tid;
  auto slot = [&](int k, int plane) {
    return sm + ((size_t)((k % kD) * 3 + plane) * kThreads + tid) * 16;
  };
  auto issue = [&](int k) {
    const long long v = vb + (long long)k * kThreads;
    if (v < v1) {
      cp_async16(slot(k, 0), a.x + v * 8);
      cp_async16(slot(k, 1), a.c + v * 8);
      cp_async16(slot(k, 2), a.c + v * 8 + 4);
    }
    cp_async_commit();
  };
  for (int k = 0; k < kD; ++k) issue(k);
  const int grp = tid % 8;
  long long next = 0;
  float g[8];
  for (int k = 0; vb + (long long)k * kThreads < v1; ++k) {
    const long long v = vb + (long long)k * kThreads;
    cp_async_wait<kD - 1>();
    if (v >= next) {
      const long long im = v / per;
      next = (im + 1) * per;
      for (int j = 0; j < 8; j += 4) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(a.gate + im * kC + grp * 8 + j));
        g[j] = q.x, g[j + 1] = q.y, g[j + 2] = q.z, g[j + 3] = q.w;
      }
    }
    float xf[8], cf[8], o[8];
    unpack16<bf16>(*reinterpret_cast<const uint4*>(slot(k, 0)), xf);
    unpack16<float>(*reinterpret_cast<const uint4*>(slot(k, 1)), cf);
    unpack16<float>(*reinterpret_cast<const uint4*>(slot(k, 2)), cf + 4);
    for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(xf[j], __fmul_rn(cf[j], g[j]));
    stg16(a.xn + v * 8, pack16<bf16>(o));
    issue(k + kD);
  }
  cp_async_wait<0>();
}

__global__ void fill_f32(float* p, long long n, float scale, float shift) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    p[i] = scale * (float)((i * 2654435761ll) % 1000) / 1000.0f + shift;
}

}  // namespace

#define CK(x)                                                                    \
  do {                                                                           \
    const cudaError_t e_ = (x);                                                  \
    if (e_ != cudaSuccess) {                                                     \
      std::printf("error %s at line %d: %s\n", #x, __LINE__, cudaGetErrorString(e_)); \
      std::exit(1);                                                              \
    }                                                                            \
  } while (0)

template <typename K>
float time_us(K kernel, const Args& a, bool coop, uint32_t smem) {
  CK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  int per_sm = 0, nsm = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem));
  CK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, 0));
  const int grid = per_sm * nsm;
  auto launch = [&] { CK(ca_launch(kernel, grid, 1, smem, coop, (cudaStream_t)0, a)); };
  for (int i = 0; i < 3; ++i) launch();
  CK(cudaDeviceSynchronize());
  cudaEvent_t s, e;
  CK(cudaEventCreate(&s));
  CK(cudaEventCreate(&e));
  CK(cudaEventRecord(s));
  for (int i = 0; i < 20; ++i) launch();
  CK(cudaEventRecord(e));
  CK(cudaEventSynchronize(e));
  float ms = 0.0f;
  CK(cudaEventElapsedTime(&ms, s, e));
  return ms * 1000.0f / 20;
}

int main() {
  const int nimg = 72, hw = 48 * 48, npart = 18, hidden = 32;
  const long long n = (long long)nimg * hw * kC;
  Args a{};
  bf16 *x, *xn;
  float *c, *part, *w, *gate;
  CK(cudaMalloc(&x, n * 2));
  CK(cudaMalloc(&xn, n * 2));
  CK(cudaMalloc(&c, n * 4));
  CK(cudaMalloc(&part, (size_t)nimg * npart * kC * 4));
  CK(cudaMalloc(&w, 2 * kC * kC * 4 + 2 * kC * 4));
  CK(cudaMalloc(&gate, (size_t)nimg * kC * 4));
  fill_f32<<<1024, 256>>>(c, n, 1.0f, 0.3f);
  fill_f32<<<1024, 256>>>(reinterpret_cast<float*>(x), n / 2, 0.0f, 0.0f);
  fill_f32<<<64, 256>>>(part, (long long)nimg * npart * kC, 50.0f, 0.0f);
  fill_f32<<<64, 256>>>(w, 2 * kC * kC + 2 * kC, 0.1f, -0.05f);
  fill_f32<<<16, 256>>>(gate, (long long)nimg * kC, 1.0f, 0.0f);
  CK(cudaDeviceSynchronize());
  a = Args{x, c, part, w, w + kC * kC, w + kC * kC + kC, w + 2 * kC * kC + kC, xn, gate,
           nimg, hw, npart, hidden};
  std::printf("{\"bound_us\": %.3f, \"device_us\": {", 8.0 * n / 3.35e6);
  std::printf("\"ldg\": %.3f, ", time_us(stream_var<true, 0>, a, false, 0));
  std::printf("\"noalloc\": %.3f, ", time_us(stream_var<false, 0>, a, false, 0));
  std::printf("\"coop\": %.3f, ", time_us(stream_var<false, 1>, a, true, 0));
  std::printf("\"gates\": %.3f, ", time_us(stream_var<false, 2>, a, true, 0));
  std::printf("\"ring\": %.3f, ", time_us(ring_var<64, 3>, a, false, 3 * 64 * 384));
  std::printf("\"cpasync\": %.3f, ", time_us(cpasync_var<4>, a, false, 4 * 3 * kThreads * 16));
  std::printf("\"copy\": %.3f}}\n", time_us(stream_var<false, 3>, a, false, 0));
  return 0;
}
