// Channel attention (the RCAB's gate and block skip) for Hopper, shared by
// winograd.cu (the Winograd trunk's ca_skip) and fused_group.cu (the fused
// trunk's fg_ca): both compute, per sample,
//   mean = the channels' mean (of r; of c from the conv's per-tile sums),
//   gate = sigmoid(W2 relu(W1 mean + b1) + b2),
//   out  = T(x + c * gate)   (a product, then a sum, in f32; rounded once).
// and its backward, shared by winograd_bwd.cu (ca_skip_bwd) and
// fused_group.cu (fg_ca_bwd): per sample the sums of c and of g * c, the
// MLP backward, and the weight gradients summed over samples (ca_bwd, at
// the end of this file).
// The functions move bytes and do a few thousand MACs a sample, so what
// bounds them is device memory: each operand read once, each output written
// once. Here: the 16-byte vector of (pixel, channel group) every stream
// uses, the block's fixed-order channel sums, the two-layer MLP spread over
// warps with its weights loaded at once (no thread loops over a row), the
// gated stream over a block's pixel range, the in-order sum of partial
// rows, the launch helper (clusters, cooperative grids) and the backward.
// Every sum runs in a fixed order: the same bits on every run.
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

// out[a * kC + c] = the block's sum of channel c of array a < kN, for c <
// kC (written by threads < kN * kC; out may be shared or global memory).
// acc[a * kVec + j]: a thread's sums of its channel group's kVec channels,
// kN arrays of them. Lanes of one group by shuffles, then the warps in
// order. Ends with the block synchronised.
template <typename T, int kN = 1>
__device__ __forceinline__ void ca_block_sum(const float* acc, float (*red)[kN * kC],
                                             float* out) {
  using V = CaVec<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kN * V::kVec; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = V::kPerPix; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane < V::kPerPix) red[warp][j / V::kVec * kC + lane * V::kVec + j % V::kVec] = v;
  }
  __syncthreads();
  if (tid < kN * kC) {
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


// ------------------------------------------------------------ the backward
// Given the cotangent g of the RCAB output x + c * gate(c), per sample:
//   Σc and dsg = Σ g * c over the pixels, the MLP backward (its hidden layer
//   recomputed from the mean; the Winograd trunk recomputes the gate too),
//   ds = W1ᵀ dz1 / npix, and the weight gradients summed over samples:
//   dW1 = Σ_n dz1 ⊗ mean, db1 = Σ_n dz1, dW2 = Σ_n dz2 ⊗ h, db2 = Σ_n dz2.
// The Winograd trunk (winograd_bwd.cu): g is f32, c T or f32, nothing
// rounded, dsg by FMAs. The fused trunk (fused_group.cu): g and c in T, the
// gate given, and the TPU kernel's rounding points: dsg a sum of rounded
// products, T(mean), T(h), T(du) and T(dv) before their products, du =
// (dsg * gate) * (1 - gate) as two rounded products; db1 and db2 sum the
// unrounded dv and du.
//
// What bounds it: g and c read once (at 72x64x48x48, 63.7 MB with g f32
// and c bf16: 19.0 us at 3.35 TB/s; 42.5 MB both bf16: 12.7 us); the rest
// is a few thousand MACs a sample. One cooperative launch on the card's
// resident blocks, in three phases, a grid barrier after the first:
//   (1) block b streams the b-th of grid equal ranges of the flat (nimg *
//       hw) pixels, so every SM holds the same bytes: the sums of each
//       sample's segment in 16-byte vectors straight from device memory, kB
//       vectors a thread in flight, past L1; the block's fixed-order sums go
//       to the segment's partial row (a sample's rows in block order).
//   (2) one block a sample, spread over the grid (ca_first_item): the
//       sample's partial rows summed in order (the MLP's weights, whose
//       copies into shared memory it issued before the barrier, waited for
//       beside them), then the MLP backward over the warps (each warp 8 rows
//       of a matrix-vector product from shared memory, lanes over the
//       64-long dimension, the rows reduced together in 9 shuffles,
//       warp_sum8); writes gate (Winograd), ds and the sample's rows for
//       (3), then adds one to a count in scratch (zeroed before the
//       barrier).
//   (3) once the count shows every MLP block done, 2 ceil(hidden / 4) + 1
//       blocks sum the weight gradients over the samples in order, one
//       output (and its bias) a thread, 4 hidden units a block; the blocks
//       that have no part in (2) or (3) have left. One grid barrier, not
//       two: the second would wait for every block.
// Rows written in the launch are read through L2 (__ldcg, cp.async.cg) after
// the barrier or an acquire load of the count. No float atomics: the same
// bits on every call.
struct CaBwdArgs {
  const void* g;           // (nimg, hw, kC): f32 (Winograd) or T (fused)
  const void* c;           // (nimg, hw, kC) T
  const float* gate;       // fused: the forward's gate (nimg, kC); else null
  const float *w1, *b1;    // (hidden, kC), (hidden,)
  const float *w2, *b2;    // (kC, hidden), (kC,) (b2: Winograd only)
  float* scratch;          // ca_bwd_scratch floats
  float* gate_out;         // Winograd: (nimg, kC)
  float* ds;               // (nimg, kC)
  float *dw1, *db1, *dw2, *db2;
  int nimg, hw, hidden, nrow;   // nrow: partial rows a sample has room for
};

// The rows a sample's MLP backward leaves for the weight gradient, laid out
// [row][nimg][kC] after the partial rows: dW1 = Σ kDz1 ⊗ kMean, dW2 = Σ kDz2
// ⊗ kHid, db1 = Σ kDb1, db2 = Σ kDb2.
template <bool kFused> struct CaBwdRows;
template <> struct CaBwdRows<false> {      // s, dz2, h, dz1
  static constexpr int kN = 4, kMean = 0, kDz2 = 1, kHid = 2, kDz1 = 3, kDb1 = 3, kDb2 = 1;
};
template <> struct CaBwdRows<true> {       // T(mean), T(du), T(h), T(dv), du, dv
  static constexpr int kN = 6, kMean = 0, kDz2 = 1, kHid = 2, kDz1 = 3, kDb2 = 4, kDb1 = 5;
};

constexpr int kCaWs = kC + 1;    // a staged weight row: conflict-free down a column
constexpr int kCaWgN = 72;       // samples a weight-gradient stage holds
static_assert(kCaWgN % 8 == 0 && 4 * kCaWgN <= 2 * kThreads, "whole groups; 2 entries a thread");

struct CaBwdSmem {
  union {
    struct {                     // phases (1) and (2)
      float w1[kMaxHidden][kCaWs];   // W1[j][c], zero past hidden
      float w2[kC][kCaWs];           // W2[c][j], zero past hidden
      float b[2][kC];                // b1, b2 (zero past hidden; b2 zero when fused)
      float red[kCaWarps][2 * kC];   // the block sums
    } mlp;
    struct {                     // phase (3)
      float a[kCaWgN][kC];       // the block's row: kMean, kDz2 or kDb2
      __align__(16) float col[2][kCaWgN][4];   // kDz1 and kDb1, or kHid, at its 4 units
    } wg;
  };
  float vec[5][kC];              // dsg, mean, pre-activation, dz2, dz1
};

// 4 bytes into shared memory, asynchronously; zeros when !valid (src unread).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The blocks whose pixel ranges meet sample im, when grid blocks split the
// flat npix pixels in order (block b: [npix b / grid, npix (b + 1) / grid)):
// from `first`, `n` of them.
__host__ __device__ __forceinline__ void ca_bwd_span(long long im, long long hw, long long npix,
                                                     long long grid, int& first, int& n) {
  first = (int)((grid * (im * hw + 1) + npix - 1) / npix - 1);
  n = (int)((grid * (im + 1) * hw + npix - 1) / npix) - first;
}

// The grid of a call (the resident blocks, at most one a kThreads vectors)
// and the partial rows a sample needs room for.
inline void ca_bwd_plan(int nimg, int hw, int per_pix, int resident, int& grid, int& nrow) {
  const long long npix = (long long)nimg * hw;
  const long long cap = (npix * per_pix + kThreads - 1) / kThreads;
  grid = (int)(cap < resident ? cap : resident);
  nrow = 1;
  for (int im = 0; im < nimg; ++im) {
    int first = 0, n = 0;
    ca_bwd_span(im, hw, npix, grid, first, n);
    nrow = n > nrow ? n : nrow;
  }
}

// Floats of scratch: a count (16 bytes), the partial rows (nimg, nrow, 2,
// kC), then the rows.
inline long long ca_bwd_scratch(int nimg, int nrow, int nrows) {
  return 4 + (long long)nimg * nrow * 2 * kC + (long long)nrows * nimg * kC;
}

// The first item (a sample, a weight-gradient unit) block b runs when nitem
// items go to grid blocks: item i to block i grid / nitem, spread over the
// grid (and so over the SMs) when there are no more items than blocks; else
// items b, b + grid, ... Returns nitem when the block runs none.
__device__ __forceinline__ int ca_first_item(int b, int nitem, int grid) {
  if (nitem > grid) return b;
  const int i = (int)(((long long)b * nitem + grid - 1) / grid);
  return i < nitem && (int)((long long)i * grid / nitem) == b ? i : nitem;
}

// Phase (3)'s operands of 4 samples from shared memory (the row's value at
// the thread's channel r, its unit's column), and their sums in sample
// order: kind 0 dW1 (column x row) and db1, 1 dW2 (row x column), 2 db2.
struct CaWgGroup {
  float x[4], c[4], b[4];
  __device__ __forceinline__ void load(const CaBwdSmem& sm, int n, int kind, int r, int g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = sm.wg.a[n + k][r];
      c[k] = sm.wg.col[0][n + k][g];
      b[k] = sm.wg.col[1][n + k][g];
    }
  }
  __device__ __forceinline__ void add(float& acc, float& accb, int kind) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kind == 0) {
        acc = fmaf(c[k], x[k], acc);
        accb += b[k];
      } else if (kind == 1) {
        acc = fmaf(x[k], c[k], acc);
      } else {
        acc += x[k];
      }
    }
  }
};

// A load that orders the loads after it (the count of phase (3)).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The rows of a warp's kCaRows = 8 matrix-vector products: t[i] holds each
// lane's partial product of row i. Recursive halving: at each of the first
// three butterflies a lane keeps half of its rows and sends the other half
// (4 + 2 + 1 shuffles), then two more sum the last row over the quad: 9
// shuffles where a butterfly a row takes 40. Returns the sum of row (lane >>
// 2) & 7, which lane 4i of the quad of row i uses.
static_assert(kCaRows == 8, "warp_sum8 reduces 8 rows");

__device__ __forceinline__ float warp_sum8(const float (&t)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float u[4], w[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (h16 ? t[i + 4] : t[i]) + __shfl_xor_sync(0xffffffffu, h16 ? t[i] : t[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w[i] = (h8 ? u[i + 2] : u[i]) + __shfl_xor_sync(0xffffffffu, h8 ? u[i] : u[i + 2], 8);
  float x = (h4 ? w[1] : w[0]) + __shfl_xor_sync(0xffffffffu, h4 ? w[0] : w[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// Phase (1): the sums of c and g * c over each sample's segment of this
// block's pixel range, into the segment's partial row (2 * kC floats). A
// vector is 16 bytes of c (kVec channels of a pixel) and the same channels
// of g (16 or 32 bytes).
template <typename TG, typename TC, bool kFused, int kB>
__device__ __forceinline__ void ca_bwd_stream(const TG* g, const TC* c, int nimg, int hw,
                                              int nrow, float (*red)[2 * kC], float* part) {
  using V = CaVec<TC>;
  constexpr int kGe = 16 / (int)sizeof(TG);          // g's elements a 16-byte word
  constexpr int kGv = V::kVec / kGe;                 // g's words a vector
  const long long npix = (long long)nimg * hw;
  const long long p1 = npix * (blockIdx.x + 1) / gridDim.x;
  for (long long q0 = npix * blockIdx.x / gridDim.x; q0 < p1;) {
    const int im = (int)(q0 / hw);
    const long long q1 = min(p1, (long long)(im + 1) * hw);
    const TC* cp = c + q0 * kC;
    const TG* gp = g + q0 * kC;
    const int nv = (int)(q1 - q0) * V::kPerPix;
    float acc[2 * V::kVec];                          // Σc, then Σ g * c
#pragma unroll
    for (int e = 0; e < 2 * V::kVec; ++e) acc[e] = 0.0f;
    for (int v = threadIdx.x; v < nv; v += kB * kThreads) {
      uint4 cv[kB], gv[kB][kGv];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int vj = v + j * kThreads;
        if (vj < nv) {
          cv[j] = ldg16(cp + (size_t)vj * V::kVec);
#pragma unroll
          for (int i = 0; i < kGv; ++i) gv[j][i] = ldg16(gp + (size_t)vj * V::kVec + i * kGe);
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        if (v + j * kThreads >= nv) break;
        float cf[V::kVec], gf[V::kVec];
        unpack16<TC>(cv[j], cf);
#pragma unroll
        for (int i = 0; i < kGv; ++i) unpack16<TG>(gv[j][i], gf + i * kGe);
#pragma unroll
        for (int e = 0; e < V::kVec; ++e) {
          acc[e] += cf[e];
          acc[V::kVec + e] = kFused ? acc[V::kVec + e] + __fmul_rn(gf[e], cf[e])
                                    : fmaf(gf[e], cf[e], acc[V::kVec + e]);
        }
      }
    }
    int first = 0, n = 0;
    ca_bwd_span(im, hw, npix, gridDim.x, first, n);
    ca_block_sum<TC, 2>(acc, red, part + ((size_t)im * nrow + blockIdx.x - first) * 2 * kC);
    q0 = q1;
  }
}

template <typename TG, typename TC, bool kFused, int kB>
__device__ __forceinline__ void ca_bwd(const CaBwdArgs& a) {
  using R = CaBwdRows<kFused>;
  __shared__ __align__(16) CaBwdSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nimg = a.nimg, hidden = a.hidden, hw = a.hw;
  unsigned* done = reinterpret_cast<unsigned*>(a.scratch);   // MLP blocks done
  float* part = a.scratch + 4;
  float* rows = part + (size_t)nimg * a.nrow * 2 * kC;
  const auto row = [&](int r, int im) { return rows + ((size_t)r * nimg + im) * kC; };

  // (1) the sums of each sample's segments (block 0 zeroes the count that
  // phase (3) waits on; the barrier publishes it)
  if (blockIdx.x == 0 && tid == 0) *done = 0u;
  ca_bwd_stream<TG, TC, kFused, kB>(static_cast<const TG*>(a.g), static_cast<const TC*>(a.c),
                                    nimg, hw, a.nrow, sm.mlp.red, part);
  // the MLP's weights: copies issued now, completing under the barrier
  const int im0 = ca_first_item(blockIdx.x, nimg, gridDim.x);   // this block's first sample
  const int imstep = min(nimg, (int)gridDim.x);
  if (im0 < nimg) {
    for (int e = tid; e < kMaxHidden * kC; e += kThreads) {
      const int j = e / kC, ch = e % kC;                  // W1[j][ch] = w1[e]
      cp_async4(&sm.mlp.w1[j][ch], a.w1 + (j < hidden ? e : 0), j < hidden);
      const int c2 = e / kMaxHidden, j2 = e % kMaxHidden;   // W2[c2][j2]
      cp_async4(&sm.mlp.w2[c2][j2], a.w2 + (j2 < hidden ? c2 * hidden + j2 : 0), j2 < hidden);
    }
    if (tid < kC) {
      cp_async4(&sm.mlp.b[0][tid], a.b1 + (tid < hidden ? tid : 0), tid < hidden);
      cp_async4(&sm.mlp.b[1][tid], kFused ? a.b1 : a.b2 + tid, !kFused);
    }
    cp_async_commit();
  }
  cooperative_groups::this_grid().sync();            // every partial row written

  // (2) per sample: its sums, then the MLP backward over the warps; lane 4i
  // finishes the warp's row i
  const float inv_npix = 1.0f / (float)hw;
  float *dg = sm.vec[0], *mean = sm.vec[1], *pre = sm.vec[2], *dz2 = sm.vec[3],
        *dz1 = sm.vec[4];
  const bool fin = (lane & 3) == 0;                   // a lane that finishes a row
  const int lr = warp + kCaWarps * ((lane >> 2) & 7); // the row it finishes
  for (int im = im0; im < nimg; im += imstep) {
    int first = 0, n = 0;
    ca_bwd_span(im, hw, (long long)nimg * hw, gridDim.x, first, n);
    if (tid < kC) {                                   // the partial rows in block order
      const float* pr = part + (size_t)im * a.nrow * 2 * kC + tid;
      const float gt = kFused ? __ldg(a.gate + (size_t)im * kC + tid) : 0.0f;
      float sc = 0.0f, sg = 0.0f;
      for (int k0 = 0; k0 < n; k0 += 8) {            // 8 rows' loads in flight at once
        float vc[8], vg[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k0 + k < n) {
            vc[k] = __ldcg(pr + (size_t)(k0 + k) * 2 * kC);
            vg[k] = __ldcg(pr + (size_t)(k0 + k) * 2 * kC + kC);
          }
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k0 + k < n) {
            sc += vc[k];
            sg += vg[k];
          }
      }
      if (kFused) {
        const float m = rnd<TC>(sc / (float)hw);
        const float du = __fmul_rn(__fmul_rn(sg, gt), 1.0f - gt);
        mean[tid] = m;
        dz2[tid] = rnd<TC>(du);
        row(R::kMean, im)[tid] = m;
        row(R::kDz2, im)[tid] = dz2[tid];
        row(R::kDb2, im)[tid] = du;
      } else {
        mean[tid] = sc * inv_npix;
        dg[tid] = sg;
        row(R::kMean, im)[tid] = mean[tid];
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float t[kCaRows];
    {                                                 // v = W1 mean + b1: rows j
      const float m0 = mean[lane], m1 = mean[lane + 32];
#pragma unroll
      for (int i = 0; i < kCaRows; ++i) {
        const int j = warp + kCaWarps * i;
        t[i] = fmaf(sm.mlp.w1[j][lane + 32], m1, sm.mlp.w1[j][lane] * m0);
      }
      const float v = warp_sum8(t, lane) + sm.mlp.b[0][lr];
      if (fin && lr < hidden) {
        pre[lr] = v;
        row(R::kHid, im)[lr] = kFused ? rnd<TC>(fmaxf(v, 0.0f)) : fmaxf(v, 0.0f);
      }
    }
    __syncthreads();
    if (!kFused) {                                    // the gate, dz2: rows c
      const float h0 = lane < hidden ? fmaxf(pre[lane], 0.0f) : 0.0f;
      const float h1 = lane + 32 < hidden ? fmaxf(pre[lane + 32], 0.0f) : 0.0f;
#pragma unroll
      for (int i = 0; i < kCaRows; ++i) {
        const int ch = warp + kCaWarps * i;
        t[i] = fmaf(sm.mlp.w2[ch][lane + 32], h1, sm.mlp.w2[ch][lane] * h0);
      }
      const float v = warp_sum8(t, lane);
      if (fin) {
        const float gt = 1.0f / (1.0f + expf(-(v + sm.mlp.b[1][lr])));
        const float d = dg[lr] * gt * (1.0f - gt);
        a.gate_out[(size_t)im * kC + lr] = gt;
        dz2[lr] = d;
        row(R::kDz2, im)[lr] = d;
      }
      __syncthreads();
    }
    {                                                 // dz1 = [v > 0] W2ᵀ dz2: rows j
      const float z0 = dz2[lane], z1 = dz2[lane + 32];
#pragma unroll
      for (int i = 0; i < kCaRows; ++i) {
        const int j = warp + kCaWarps * i;
        t[i] = fmaf(sm.mlp.w2[lane + 32][j], z1, sm.mlp.w2[lane][j] * z0);
      }
      const float v = warp_sum8(t, lane);
      if (fin && lr < hidden) {
        const float d = pre[lr] > 0.0f ? v : 0.0f;
        dz1[lr] = kFused ? rnd<TC>(d) : d;
        row(R::kDz1, im)[lr] = dz1[lr];
        if (kFused) row(R::kDb1, im)[lr] = d;
      }
    }
    __syncthreads();
    {                                                 // ds = W1ᵀ dz1 / npix: rows c
      const float z0 = lane < hidden ? dz1[lane] : 0.0f;
      const float z1 = lane + 32 < hidden ? dz1[lane + 32] : 0.0f;
#pragma unroll
      for (int i = 0; i < kCaRows; ++i) {
        const int ch = warp + kCaWarps * i;
        t[i] = fmaf(sm.mlp.w1[lane + 32][ch], z1, sm.mlp.w1[lane][ch] * z0);
      }
      const float v = warp_sum8(t, lane);
      if (fin) a.ds[(size_t)im * kC + lr] = kFused ? v / (float)hw : v * inv_npix;
    }
    __syncthreads();                                  // the vectors, for the next sample
  }
  if (im0 < nimg) {                                   // this block's rows are out
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(done, 1u);
  }

  // (3) the weight gradients, over 2 nq + 1 blocks (nq = hidden / 4, rounded
  // up), once every MLP block has counted itself done: block u < nq gives
  // dW1[j][r] and db1[j] for the hidden units j = 4u .. 4u + 3, thread (j,
  // r) one of them; nq <= u < 2 nq dW2[c][j] for its 4 units; u = 2 nq db2,
  // thread c. Each sums over the samples in order: its row (kMean, kDz2 or
  // kDb2) staged by asynchronous copies through L2, padded with zeros to
  // whole groups of 8 samples, and its unit's column, 4 samples' operands
  // loaded before their sums (CaWgGroup).
  const int nq = (hidden + 3) / 4, nunit = 2 * nq + 1;
  const int u0 = ca_first_item(blockIdx.x, nunit, gridDim.x);
  for (int u = u0; u < nunit; u += min(nunit, (int)gridDim.x)) {
    if (u == u0) {
      if (tid == 0)
        while (ld_acquire(done) < (unsigned)imstep) {
        }
      __syncthreads();
    }
    const int kind = u < nq ? 0 : u < 2 * nq ? 1 : 2;   // dW1, dW2, db2
    const int j0 = 4 * (kind == 0 ? u : u - nq);
    float acc = 0.0f, accb = 0.0f;
    for (int n0 = 0; n0 < nimg; n0 += kCaWgN) {
      const int nn = min(kCaWgN, nimg - n0), nn8 = (nn + 7) & ~7;
      const float4* src = reinterpret_cast<const float4*>(
          row(kind == 0 ? R::kMean : kind == 1 ? R::kDz2 : R::kDb2, n0));
      for (int e = tid; e < nn * kC / 4; e += kThreads)
        cp_async16(reinterpret_cast<float4*>(sm.wg.a[0]) + e, src + e);
      cp_async_commit();
      float cv[2][2];                                 // column entries tid, tid + kThreads
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = tid + k * kThreads, q = j0 + (e & 3);
        const bool ok = kind < 2 && e < 4 * nn && q < hidden;
        cv[k][0] = ok ? __ldcg(row(kind == 0 ? R::kDz1 : R::kHid, n0 + (e >> 2)) + q) : 0.0f;
        cv[k][1] = !kFused ? cv[k][0]                   // db1 sums dz1 itself
                   : ok && kind == 0 ? __ldcg(row(R::kDb1, n0 + (e >> 2)) + q) : 0.0f;
      }
      for (int e = nn * kC + tid; e < nn8 * kC; e += kThreads) sm.wg.a[e / kC][e % kC] = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = tid + k * kThreads;
        if (e < 4 * nn8) {
          sm.wg.col[0][e >> 2][e & 3] = cv[k][0];
          sm.wg.col[1][e >> 2][e & 3] = cv[k][1];
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      if (kind < 2 || tid < kC) {                    // 4 samples' operands, then their sums
        CaWgGroup gr;
        for (int n = 0; n < nn8; n += 4) {
          gr.load(sm, n, kind, tid & (kC - 1), tid >> 6);
          gr.add(acc, accb, kind);
        }
      }
      __syncthreads();
    }
    const int j = j0 + (tid >> 6), r = tid & (kC - 1);   // this thread's unit and channel
    if (kind == 0 && j < hidden) {
      a.dw1[j * kC + r] = acc;
      if (r == 0) a.db1[j] = accb;
    } else if (kind == 1 && j < hidden) {
      a.dw2[r * hidden + j] = acc;
    } else if (kind == 2 && tid < kC) {
      a.db2[tid] = acc;
    }
  }
}

// Launch `kernel` (a ca_bwd instance with `per_pix` vectors a pixel, of
// which `resident` blocks fit the card) cooperatively, as ca_bwd_plan says.
template <typename K>
cudaError_t ca_bwd_launch(K kernel, CaBwdArgs a, int per_pix, int resident, cudaStream_t s) {
  int grid = 0;
  ca_bwd_plan(a.nimg, a.hw, per_pix, resident, grid, a.nrow);
  return ca_launch(kernel, grid, 1, 0, true, s, a);
}

}  // namespace
