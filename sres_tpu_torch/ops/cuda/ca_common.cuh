// Channel attention (the RCAB's gate and block skip) for Hopper, shared by
// winograd.cu (the Winograd trunk's ca_skip) and fused_group.cu (the fused
// trunk's fg_ca): both compute, per sample,
//   mean = the channels' mean (of r; of c from the conv's per-tile sums),
//   gate = sigmoid(W2 relu(W1 mean + b1) + b2),
//   out  = T(x + c * gate)   (a product, then a sum, in f32; rounded once).
// The function moves bytes and does a few thousand MACs a sample, so what
// bounds it is device memory: each operand read once, each output written
// once. Here: the 16-byte vector of (pixel, channel group) every stream
// uses, the block's fixed-order channel sums, the two-layer MLP spread over
// warps with its weights loaded at once (no thread loops over a row), the
// gated stream over a block's pixel range, the in-order sum of partial
// rows, and the launch helper (clusters, cooperative grids). Every sum runs in a
// fixed order: the same bits on every run.
#pragma once

#include <cooperative_groups.h>

#include "wino_common.cuh"

namespace {

constexpr int kCaWarps = kThreads / 32;
constexpr int kCaRows = (kMaxHidden + kCaWarps - 1) / kCaWarps;   // MLP rows a warp

// A 16-byte vector of T: kVec channels of one pixel; kPerPix vectors a pixel.
// Thread t of a block reads the vectors t, t + kThreads, ... of a
// pixel-aligned range, all of one channel group (t % kPerPix).
template <typename T>
struct CaVec {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kPerPix = kC / kVec;
  static_assert(kThreads % kPerPix == 0, "a thread keeps one channel group");
};

// 16 bytes of T as floats, and back (bf16 rounded to nearest even).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo_bf(w[i]);
      f[2 * i + 1] = hi_bf(w[i]);
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack_bf(__float2bfloat16_rn(f[2 * i]), __float2bfloat16_rn(f[2 * i + 1]));
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
}

// A streamed 16-byte load: read-only, not kept in L1 (through L1 the fused
// stream took 10 % longer on the H100: probes/ca_variants.py).
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ void stg16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}
// A 16-byte store that is evicted from L2 first (an output read much later).
__device__ __forceinline__ void stg16_cs(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[c] = the block's sum of channel c, for c < kC (written by threads
// c < kC; out may be shared or global memory). acc: a thread's sums of
// its channel group's kVec channels. Lanes of one group by shuffles, then
// the warps in order. Ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void ca_block_sum(const float* acc, float (*red)[kC], float* out) {
  using V = CaVec<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < V::kVec; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = V::kPerPix; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane < V::kPerPix) red[warp][lane * V::kVec + j] = v;
  }
  __syncthreads();
  if (tid < kC) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kCaWarps; ++w) s += red[w][tid];
    out[tid] = s;
  }
  __syncthreads();
}

// The MLP's weights as one warp uses them: rows warp + kCaWarps * i of each
// layer, lane l holding columns l and l + 32 (zero past hidden), and lane
// i < kCaRows the bias of row i. Loaded at once, ahead of the mean.
struct CaWeights {
  float w1[kCaRows][2], w2[kCaRows][2], b1, b2;
};

__device__ __forceinline__ void ca_load_weights(CaWeights& cw, const float* __restrict__ w1,
                                                const float* __restrict__ b1,
                                                const float* __restrict__ w2,
                                                const float* __restrict__ b2, int hidden) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kCaRows; ++i) {
    const int j = warp + kCaWarps * i, c = warp + kCaWarps * i;
    cw.w1[i][0] = j < hidden ? __ldg(w1 + j * kC + lane) : 0.0f;
    cw.w1[i][1] = j < hidden ? __ldg(w1 + j * kC + lane + 32) : 0.0f;
    cw.w2[i][0] = lane < hidden ? __ldg(w2 + c * hidden + lane) : 0.0f;
    cw.w2[i][1] = lane + 32 < hidden ? __ldg(w2 + c * hidden + lane + 32) : 0.0f;
  }
  const int jb = warp + kCaWarps * lane;
  cw.b1 = lane < kCaRows && jb < hidden ? __ldg(b1 + jb) : 0.0f;
  cw.b2 = lane < kCaRows ? __ldg(b2 + jb) : 0.0f;
}

// gate = sigmoid(W2 h + b2), h = relu(W1 mean + b1), rounded to T when
// kRound (the fused trunk's point; its caller rounds the mean). mean, hid,
// gate: [kC] in shared memory; mean is ready when every thread enters, gate
// when every thread returns.
template <typename T, bool kRound>
__device__ __forceinline__ void ca_mlp(const CaWeights& cw, const float* mean, float* hid,
                                       float* gate, int hidden) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float m0 = mean[lane], m1 = mean[lane + 32];
#pragma unroll
  for (int i = 0; i < kCaRows; ++i) {
    const float t = warp_sum(fmaf(m1, cw.w1[i][1], m0 * cw.w1[i][0]));
    const float b = __shfl_sync(0xffffffffu, cw.b1, i);
    const int j = warp + kCaWarps * i;
    if (lane == 0 && j < hidden) {
      const float h = fmaxf(t + b, 0.0f);
      hid[j] = kRound ? rnd<T>(h) : h;
    }
  }
  __syncthreads();
  const float h0 = lane < hidden ? hid[lane] : 0.0f;
  const float h1 = lane + 32 < hidden ? hid[lane + 32] : 0.0f;
#pragma unroll
  for (int i = 0; i < kCaRows; ++i) {
    const float t = warp_sum(fmaf(h1, cw.w2[i][1], h0 * cw.w2[i][0]));
    const float b = __shfl_sync(0xffffffffu, cw.b2, i);
    if (lane == 0) gate[warp + kCaWarps * i] = 1.0f / (1.0f + expf(-(t + b)));
  }
  __syncthreads();
}

// The gated stream: out = T(x + c * gate), and with kStash cst = T(c), over
// a block's share of the flat (nimg * hw) pixels, in 16-byte vectors
// straight from and to device memory; thread t takes the vectors t, t +
// kThreads, ... (one channel group), kB at a time in registers. (Staged
// through shared memory, by bulk copies or by cp.async, the stream took 13
// and 34 % longer on the H100: probes/ca_variants.py.)
template <typename T, typename TC, int kB, bool kStash>
struct CaStream {
  using V = CaVec<T>;
  static constexpr int kCv = V::kVec * (int)sizeof(TC) / 16;   // c's 16-byte words a vector
  const T* x;
  const TC* c;
  T* out;
  T* cst;
  long long v, v1;                  // this thread's next vector; the range's end
  uint4 xs[kB], cs[kB][kCv];        // the batch in flight

  // Set up this block's share of npix pixels (blocks in order, pixel-aligned).
  __device__ void start(const T* x_, const TC* c_, T* out_, T* cst_, long long npix) {
    x = x_, c = c_, out = out_, cst = cst_;
    const long long p0 = npix * blockIdx.x / gridDim.x, p1 = npix * (blockIdx.x + 1) / gridDim.x;
    v = p0 * V::kPerPix + threadIdx.x;
    v1 = p1 * V::kPerPix;
  }
  // Issue the loads of the batch at vector `at`.
  __device__ void load(long long at) {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const long long vj = at + j * kThreads;
      if (vj >= v1) break;
      xs[j] = ldg16(x + vj * V::kVec);
#pragma unroll
      for (int i = 0; i < kCv; ++i)
        cs[j][i] = ldg16(c + vj * V::kVec + i * (16 / (int)sizeof(TC)));
    }
  }
  __device__ void unpack_c(int j, float* cf) const {
#pragma unroll
    for (int i = 0; i < kCv; ++i) unpack16<TC>(cs[j][i], cf + i * (16 / (int)sizeof(TC)));
  }
  // Write the stash of the first batch, in flight (it needs no gate).
  __device__ void stash_first() {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const long long vj = v + j * kThreads;
      if (vj >= v1) break;
      float cf[V::kVec];
      unpack_c(j, cf);
      stg16_cs(cst + vj * V::kVec, pack16<T>(cf));
    }
  }
  // Stream the range, its first batch in flight (and with kStash its stash
  // written); gates (nimg, kC) f32 written earlier in this launch, read
  // through L2 once per sample a thread meets.
  __device__ void run(const float* gates, int hw) {
    const int grp = threadIdx.x % V::kPerPix;
    const long long per = (long long)hw * V::kPerPix;
    long long next = 0;                                  // the first vector of the next sample
    float g[V::kVec];
    for (bool first = true; v < v1; v += kB * kThreads, first = false) {
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const long long vj = v + j * kThreads;
        if (vj >= v1) break;
        if (vj >= next) {                                // a new sample: its gates
          const long long im = vj / per;
          next = (im + 1) * per;
#pragma unroll
          for (int k = 0; k < V::kVec; k += 4) {
            const float4 q = __ldcg(reinterpret_cast<const float4*>(
                gates + im * kC + grp * V::kVec + k));
            g[k] = q.x, g[k + 1] = q.y, g[k + 2] = q.z, g[k + 3] = q.w;
          }
        }
        float xf[V::kVec], cf[V::kVec], o[V::kVec];
        unpack16<T>(xs[j], xf);
        unpack_c(j, cf);
#pragma unroll
        for (int k = 0; k < V::kVec; ++k) o[k] = __fadd_rn(xf[k], __fmul_rn(cf[k], g[k]));
        stg16(out + vj * V::kVec, pack16<T>(o));
        if (kStash && !first) stg16_cs(cst + vj * V::kVec, pack16<T>(cf));
      }
      if (v + kB * kThreads < v1) load(v + kB * kThreads);
    }
  }
};

// Sum the partial rows rows[0 .. nrow) of kC floats in row order into
// out[c] (threads c < kC), the rows staged through shared memory kCaRowChunk
// at a time with 16-byte loads (kCoherent: through L2, for rows written
// earlier in the same launch). Ends with the block synchronised.
constexpr int kCaRowChunk = 32;

template <bool kCoherent>
__device__ __forceinline__ void ca_sum_rows(const float* rows, int nrow, float (*stage)[kC],
                                            float* out) {
  const int tid = threadIdx.x;
  float s = 0.0f;
  for (int r0 = 0; r0 < nrow; r0 += kCaRowChunk) {
    const int n4 = min(kCaRowChunk, nrow - r0) * kC / 4;
    const float4* src = reinterpret_cast<const float4*>(rows + (size_t)r0 * kC);
    for (int i = tid; i < n4; i += kThreads)
      reinterpret_cast<float4*>(stage[0])[i] = kCoherent ? __ldcg(src + i) : __ldg(src + i);
    __syncthreads();
    if (tid < kC)
      for (int r = 0; r < min(kCaRowChunk, nrow - r0); ++r) s += stage[r][tid];
    __syncthreads();
  }
  if (tid < kC) out[tid] = s;
  __syncthreads();
}

// Launch `kernel` on `grid` blocks of kThreads in clusters of `cluster`
// blocks (1: none), cooperatively when `coop` (a grid-wide barrier).
template <typename K, typename... Args>
cudaError_t ca_launch(K kernel, int grid, int cluster, uint32_t smem, bool coop,
                      cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (coop) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The most blocks of `kernel` (kThreads, no dynamic shared memory) resident
// on `device` at once: a cooperative grid's limit. Queried once per kernel.
template <typename K>
cudaError_t ca_resident(K kernel, int device, int& cache, int& out) {
  if (cache == 0) {
    int per_sm = 0, nsm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache = per_sm * nsm;
  }
  out = cache;
  return cudaSuccess;
}

}  // namespace
