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
// the group is a sequence of launches: conv, conv, channel attention per
// RCAB (kernel (b): one launch that reads r once, see its comment).
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
// and the two transforms are a few hundred FP32 instructions per (tile,
// channel). U (295 KB at m=4) read from L2 by every block of tiles (191
// MB a call at 16 tiles a block) and phases that run back to back would
// bound it. So kernel (a, bf16) (see its comment) runs persistent
// clusters of two blocks that split the taps, each keeping its half of U
// resident; tap products on wgmma with both operands in shared memory, the
// inverse transform folded per column of taps in registers, the partial
// sums swapped over DSMEM; warpgroups that run their own units, so that
// one's transform overlaps the other's products; an epilogue writing
// whole pixels, ReLU a select. f32 keeps the FMA kernel: V of 16 tiles in
// shared memory, every tap folded straight into the inverse transform.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "ca_common.cuh"
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

// (a, bf16) the conv on Hopper: clusters of two blocks, tap products on
// wgmma, U resident.
//
// U is 36 taps x 8 KB = 295 KB at m=4, more than a block's shared memory,
// and streaming it from L2 for each unit of tiles makes L2 and the copies
// the bottleneck (measured on an H100 with a ring of bulk copies: the
// ring's refills set the pace). So the two blocks of a cluster split the taps
// by column: block r holds U of tap columns tj in [r * n/2, (r + 1) * n/2)
// (147 KB at m=4, 64 KB at m=2), loaded once by bulk copies and resident
// for the kernel's life. (A split of the input channels instead halves
// each block's input reads but doubles the fold, and measured 35 % slower
// on an H100: the transform is bound by issue and latency, not by L2.)
// Both blocks take the same tile range; each warpgroup works through its
// own units of kTW tiles (16 at m=4, 32 at m=2; warpgroup g takes units
// g, g + 2, ...) with the same warpgroup of the peer block, in phases:
//   (A) V of the unit for the block's taps: the warpgroup's 128 threads run
//       the input transform (input_transform's two stages, each rounded to
//       bf16: V's bits are the mma.sync kernel's; stage 1 computes only the
//       block's columns) for items of (tile, 8 input channels), from
//       16-byte loads into the warpgroup's V buffer in wgmma's core-matrix
//       layout [tap][ci chunk][tile][8];
//   (B) the tap products: M_t = U_t^T . V_t^T on wgmma m64n{kTW}k16 (rows:
//       the 64 output channels, columns: tiles), both operands in shared
//       memory, a column of taps (fixed tj, ti = 0..n-1) at a time, folded
//       at once into the output in registers: R = A^T applied over ti
//       (at_apply, the twins' first stage), then Y[u][v] += AT[v][tj] *
//       R[u], m*m f32 values a (tile, channel); M never leaves the SM;
//   (X) the exchange: block r finishes output rows u in [r m/2, (r+1) m/2)
//       of every tile, so once the peer warpgroup's products have read its
//       V (an mbarrier it arrives on remotely), each thread writes the
//       other rows of its partial Y there (DSMEM, 16-byte stores at m=4,
//       8-byte at m=2) and arrives on the peer's second mbarrier; then it
//       adds the peer's partial of its own rows, columns 0..n/2-1 first;
//   (C) the epilogue: bias and ReLU (a select) in f32, one rounding to
//       bf16, staged as [tile][pixel][channel],
//       then read back as 16-byte pieces, with the scaled residual
//       r + res_scale * o (a product, then a sum, rounded once; the
//       residual loaded before the exchange), and written as whole 128-byte
//       pixels with 16-byte stores.
// The warpgroups synchronise only with their peers and within themselves
// (named barriers), so one's transform overlaps the other's products,
// exchange and epilogue: 10-14 % faster on an H100 than the same phases
// run by the whole block in step.
// Bounds at (72, 64, 48, 48), m=4: 21 MB in and 21 MB out (12.7 us at
// 3.35 TB/s) against 3.1 GFLOP of tap products (3.1 us on the tensor
// cores); the two transforms are about 0.3 G FP32 instructions.
template <int M>
struct WGeo {
  static constexpr int kN = M + 2;                 // transform size
  static constexpr int kCols = kN / 2;             // tap columns a block
  static constexpr int kTaps = kN * kCols;         // taps a block
  static constexpr int kTW = M == 4 ? 16 : 32;     // tiles a warpgroup unit: wgmma N
  static constexpr int kE = kTW / 2;               // accumulators a tap, a thread
  static constexpr uint32_t kUTap = kC * kC * 2;   // [ci chunk][co][8] bf16
  static constexpr uint32_t kVChunk = kTW * 16 + 16;    // V: [tap][ci chunk][tile][8]
  static constexpr uint32_t kVTap = 8 * kVChunk;
  static constexpr uint32_t kVBytes = kTaps * kVTap;    // a warpgroup's V buffer
  static constexpr uint32_t kVOff = kTaps * kUTap;      // V of warpgroup g at + g kVBytes
  static constexpr uint32_t kTileOff = kVOff + 2 * kVBytes;   // TileRefs, [g][kTW]
  static constexpr uint32_t kBarOff = kTileOff + 2 * kTW * 16;
  // mbarriers: U; then per warpgroup "the peer's V is free" and "the peer's
  // partial sums are here"
  static constexpr uint32_t kSmem = kBarOff + 5 * 8;
  static constexpr int kHalf = M * M / 2;          // pixels a block finishes, a tile
  static constexpr uint32_t kStgTile = kHalf * 128 + 16;  // staging, per tile
  static_assert(kE * kHalf * 128 * 4 <= kVBytes && kTW * kStgTile <= kVBytes,
                "the exchange and the staging fit a warpgroup's V buffer");
};
constexpr int kWThreads = 256;                     // 2 warpgroups
constexpr int kWCluster = 2;                       // blocks splitting the taps

struct WinoArgs {
  const bf16* x;             // (nimg, h, w, 64)
  const unsigned char* u;    // U in kernel order: [tj][ti][ci chunk][co][8] bf16
  const float* bias;         // (64,)
  const bf16* res;           // like x, or null
  bf16* y;
  int nimg, h, w, relu;
  float res_scale;
};

// D(64 x kTW, f32) (+)= A(64 x 16) . B(16 x kTW), both K-major in shared
// memory; acc = 0 starts a new sum.
template <int TW>
__device__ __forceinline__ void wgmma_ss(float (&d)[TW / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <bool kCoherent>
__device__ __forceinline__ uint4 load_u4(const bf16* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const uint4*>(p));
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// two floats rounded to bf16 in one word, the first in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A unit's tiles, computed once a unit: the image's offset and the top
// left corner of the tile's input patch (y0, x0; one pixel outside the
// tile); x0 < -1 marks a tile past the unit's end.
struct TileRef {
  int img, y0, x0, pad;
};

template <int M>
__device__ __forceinline__ void unit_tiles(TileRef* tref, int u0, int uend, int h, int w,
                                           int wt) {
  if (wt < WGeo<M>::kTW) {
    const int tw = w / M, per = (h / M) * tw, g = u0 + wt;
    TileRef t{0, 0, -2, 0};
    if (g < uend) {
      const int im = g / per, rem = g - im * per, r = rem / tw;
      t = TileRef{im * h * w * kC, r * M - 1, (rem - r * tw) * M - 1, 0};
    }
    tref[wt] = t;
  }
}

// 8 bf16 in a uint4 -> floats
__device__ __forceinline__ void unpack8f(uint4 v, float* f) {
  f[0] = lo_bf(v.x); f[1] = hi_bf(v.x); f[2] = lo_bf(v.y); f[3] = hi_bf(v.y);
  f[4] = lo_bf(v.z); f[5] = hi_bf(v.z); f[6] = lo_bf(v.w); f[7] = hi_bf(v.w);
}

// (A) V of a warpgroup unit's tiles for tap columns C0 .. C0 + kCols - 1
// into vs, local tap (tj - C0) * n + ti. Items (tile, 8-channel chunk),
// thread wt (0..127) item wt + 128 k: a warp loads 4 tiles' pixels as
// whole 128-byte lines; the chunk stride's 16 bytes of padding keep the
// 16-byte stores off shared bank conflicts.
template <int M, int C0, bool kCoherent>
__device__ __forceinline__ void produce_v(const bf16* __restrict__ x, unsigned char* vs,
                                          const TileRef* tref, int h, int w, int wt) {
  using G = WGeo<M>;
  constexpr int N = G::kN, NC = G::kCols;
  for (int it = wt; it < G::kTW * 8; it += 128) {
    const int c = it & 7, jt = it >> 3;
    const TileRef t = tref[jt];
    if (t.x0 < -1) continue;
    uint4 d[N][N];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      // the patch row's first pixel (read only inside the image): the
      // row's loads are immediate offsets from it
      const int yy = t.y0 + p;
      const bf16* row = x + t.img + ((ptrdiff_t)yy * w + t.x0) * kC + 8 * c;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const bool in = (unsigned)yy < (unsigned)h && (unsigned)(t.x0 + q) < (unsigned)w;
        d[p][q] = make_uint4(0u, 0u, 0u, 0u);
        if (in) d[p][q] = load_u4<kCoherent>(row + q * kC);
      }
    }
    // stage 1 over the patch's columns, rounded to bf16: w1[p][tj - C0]
    uint4 w1[N][NC];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      float f[8][N], o[8][N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        float v8[8];
        unpack8f(d[p][q], v8);
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k][q] = v8[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) bt_apply<M>(f[k], o[k]);
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
        w1[p][jj] = make_uint4(pack_rn(o[0][C0 + jj], o[1][C0 + jj]),
                               pack_rn(o[2][C0 + jj], o[3][C0 + jj]),
                               pack_rn(o[4][C0 + jj], o[5][C0 + jj]),
                               pack_rn(o[6][C0 + jj], o[7][C0 + jj]));
    }
    // stage 2 over the rows, rounded to bf16
    unsigned char* dst = vs + c * G::kVChunk + jt * 16;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      float col[8][N], out[8][N];
#pragma unroll
      for (int p = 0; p < N; ++p) {
        float v8[8];
        unpack8f(w1[p][jj], v8);
#pragma unroll
        for (int k = 0; k < 8; ++k) col[k][p] = v8[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) bt_apply<M>(col[k], out[k]);
#pragma unroll
      for (int ti = 0; ti < N; ++ti)
        *reinterpret_cast<uint4*>(dst + (jj * N + ti) * G::kVTap) =
            make_uint4(pack_rn(out[0][ti], out[1][ti]), pack_rn(out[2][ti], out[3][ti]),
                       pack_rn(out[4][ti], out[5][ti]), pack_rn(out[6][ti], out[7][ti]));
    }
  }
}

// Load this block's half of U (kernel order: its tap columns are one
// contiguous run) into shared memory, completing on the block's mbarrier.
template <int M>
__device__ __forceinline__ void load_u_half(const unsigned char* u, uint32_t sb, int rank) {
  using G = WGeo<M>;
  if (threadIdx.x == 0) {
    const uint32_t bar = sb + G::kBarOff;
    mbar_expect_tx(bar, G::kTaps * G::kUTap);
    for (int t = 0; t < G::kTaps; ++t)
      bulk_g2s(sb + t * G::kUTap, u + ((size_t)rank * G::kTaps + t) * G::kUTap, G::kUTap, bar);
  }
}

// The block's mbarriers, then a cluster barrier: the peer arrives on them.
template <int M>
__device__ __forceinline__ void wino_barrier_init(unsigned char* smem) {
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(smem) + WGeo<M>::kBarOff;
    mbar_init(bar, 1);                                 // U: thread 0's arming
    for (int k = 1; k < 5; ++k) mbar_init(bar + 8 * k, 128);   // a peer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();
}

// Arrive on the mbarrier at the same offset in the cluster's block `cta`,
// releasing this thread's earlier writes (DSMEM included) at cluster scope.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
// Wait for phase `parity` of this block's mbarrier, acquiring at cluster
// scope what the peer released; traps if it never completes.
__device__ __forceinline__ void mbar_wait_acq_cluster(uint32_t bar, int parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 24)) __trap();
  }
}

// One conv over the cluster's tile range, on block rank R's tap columns.
// Warpgroup g takes the range's units g, g + 2, ... of kTW tiles and runs
// (A) (B) (X) (C) on each by itself, pairing with warpgroup g of the peer
// block through mbarriers, so one warpgroup's transform overlaps the
// other's products, exchange and epilogue. U of this conv arrives on the
// block's mbarrier (phase `uphase`) while the first units' V is computed;
// `iter` counts a warpgroup's units over the launch (the exchange's phases).
// kMode: 0 no residual (ReLU from a.relu, a select), 1 the residual, 2 the
// residual after ReLU.
template <int M, int R, int kMode, bool kCoherent>
__device__ __forceinline__ void wino_conv_wgmma(const WinoArgs& a, unsigned char* smem,
                                                int uphase, int& iter) {
  using G = WGeo<M>;
  constexpr int N = G::kN, NC = G::kCols, TW = G::kTW, E = G::kE;
  constexpr int C0 = R * NC;
  constexpr bool kRes = kMode != 0;
  const bool relu = kMode == 0 ? a.relu != 0 : kMode == 2;
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wt = tid & 127, wq = warp & 3, g8 = lane >> 2, q4 = lane & 3;
  const int tw = a.w / M, per = (a.h / M) * tw, ntiles = a.nimg * per;
  const int cl = blockIdx.x / kWCluster, ncl = gridDim.x / kWCluster;
  const int t0 = (int)((long long)ntiles * cl / ncl);
  const int t1 = (int)((long long)ntiles * (cl + 1) / ncl);
  const float bias0 = a.bias[16 * wq + g8], bias1 = a.bias[16 * wq + g8 + 8];
  const uint32_t vsb = sb + G::kVOff + wg * G::kVBytes;
  const uint32_t ubar = sb + G::kBarOff, vfree = ubar + 8 * (1 + wg), xready = ubar + 8 * (3 + wg);
  const uint64_t udesc = gmma_desc(sb, 1024, 128);
  const uint64_t vdesc = gmma_desc(vsb, G::kVChunk, 128);
  unsigned char* vs = smem + G::kVOff + wg * G::kVBytes;
  TileRef* tref = reinterpret_cast<TileRef*>(smem + G::kTileOff) + wg * TW;
  // the exchange: [element][pixel group][thread][V] f32 of the receiver's
  // rows (V = 4 at m=4, 2 at m=2) in the receiving warpgroup's V buffer;
  // this block's pixels are kHalf * R .. kHalf * R + kHalf - 1
  constexpr int H = G::kHalf, PX0 = H * R, PEER0 = H * (1 - R);
  using Vec = std::conditional_t<H % 4 == 0, float4, float2>;
  constexpr int VW = sizeof(Vec) / 4, NG = H / VW;
  Vec* peer = cooperative_groups::this_cluster().map_shared_rank(reinterpret_cast<Vec*>(vs),
                                                                 (unsigned)(1 - R));
  const int bar_id = 1 + wg;               // the warpgroup's named barrier
  for (int u0 = t0 + wg * TW; u0 < t1; u0 += 2 * TW, ++iter) {
    const int uend = min(t1, u0 + TW);
    unit_tiles<M>(tref, u0, uend, a.h, a.w, wt);
    named_bar(bar_id, 128);
    produce_v<M, C0, kCoherent>(a.x, vs, tref, a.h, a.w, wt);
    fence_proxy_async();                   // V's generic stores, for wgmma
    named_bar(bar_id, 128);
    mbar_wait(ubar, uphase);               // U (at once after the first units)
    __syncwarp();                          // converged for the aligned wgmma

    // (B) y[e][u * M + v], e = 4 j + 2 i + ee: output channel 16 wq + g8 +
    // 8 i of tile 8 j + 2 q4 + ee of the unit
    float y[E][M * M];
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int px = 0; px < M * M; ++px) y[e][px] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float acc[N][E];
      wgmma_fence();
#pragma unroll
      for (int ti = 0; ti < N; ++ti)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<TW>(acc[ti], udesc + (((j * N + ti) * G::kUTap + ks * 2048) >> 4),
                       vdesc + (((j * N + ti) * G::kVTap + ks * 2 * G::kVChunk) >> 4), ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ti = 0; ti < N; ++ti) reg_fence(acc[ti]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float f[N], r[M];
#pragma unroll
        for (int ti = 0; ti < N; ++ti) f[ti] = acc[ti][e];
        at_apply<M>(f, r);
#pragma unroll
        for (int uu = 0; uu < M; ++uu)
#pragma unroll
          for (int vv = 0; vv < M; ++vv) {
            const float cv = at_coef<M>(vv, C0 + j);
            if (cv != 0.0f) y[e][uu * M + vv] = fmaf(cv, r[uu], y[e][uu * M + vv]);
          }
      }
    }
    // this warpgroup's products have read its V: the peer may write there
    mbar_arrive_peer(vfree, 1 - R);

    // (C)'s 16-byte pieces (tile, pixel, 8 channels), 8 lanes a pixel; the
    // residual is loaded now, so that its latency hides behind the exchange
    constexpr int kPer = TW * H * 8 / 128;
    // pixel (u, v) of tile tl at element t.img + ((y0 + 1 + u) * w + x0 + 1 + v) * 64
    auto out_off = [&](int it, bool& valid) {
      const int ch = it & 7, pix = PX0 + (it >> 3) % H;
      const TileRef t = tref[(it >> 3) / H];
      valid = t.x0 >= -1;
      return (size_t)t.img + ((size_t)(t.y0 + 1 + pix / M) * a.w + t.x0 + 1 + pix % M) * kC +
             8 * ch;
    };
    uint4 rv[kRes ? kPer : 1];
    if constexpr (kRes) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        bool valid;
        const size_t off = out_off(wt + 128 * k, valid);
        rv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (valid) rv[k] = __ldg(reinterpret_cast<const uint4*>(a.res + off));
      }
    }
    // (X) once the peer warpgroup's products have read its V, the partial
    // sums of the peer's output rows go there (512-byte rows a warp at
    // m=4), announced on its mbarrier
    mbar_wait_acq_cluster(vfree, iter & 1);
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        Vec v;
        float* vf = reinterpret_cast<float*>(&v);
#pragma unroll
        for (int jj = 0; jj < VW; ++jj) vf[jj] = y[e][PEER0 + VW * k + jj];
        peer[(e * NG + k) * 128 + wt] = v;
      }
    mbar_arrive_peer(xready, 1 - R);
    // (C) columns 0..n/2-1 first; bias, ReLU, bf16, staged as [tile][pixel]
    // [channel] over the exchange rows every thread has read
    mbar_wait_acq_cluster(xready, iter & 1);
    const Vec* part = reinterpret_cast<const Vec*>(vs);
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const Vec v = part[(e * NG + k) * 128 + wt];
        const float* vf = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int jj = 0; jj < VW; ++jj) {
          float& yy = y[e][PX0 + VW * k + jj];
          yy = R == 0 ? yy + vf[jj] : vf[jj] + yy;
        }
      }
    named_bar(bar_id, 128);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = (e >> 1) & 1, tile = 8 * (e >> 2) + 2 * q4 + (e & 1);
      const float b = i ? bias1 : bias0;
      unsigned char* row = vs + tile * G::kStgTile + (16 * wq + g8 + 8 * i) * 2;
#pragma unroll
      for (int px = 0; px < H; ++px) {
        float o = y[e][PX0 + px] + b;
        o = relu ? fmaxf(o, 0.0f) : o;            // a select, or folded
        *reinterpret_cast<bf16*>(row + px * 128) = __float2bfloat16_rn(o);
      }
    }
    named_bar(bar_id, 128);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int it = wt + 128 * k;
      bool valid;
      const size_t off = out_off(it, valid);
      if (!valid) continue;
      uint4 o = *reinterpret_cast<const uint4*>(vs + (it >> 3) / H * G::kStgTile +
                                                (it >> 3) % H * 128 + (it & 7) * 16);
      if constexpr (kRes) {
        // r + res_scale * o: the product, then the sum (the JAX order,
        // winograd_conv.py:547-549; no contraction into an FMA), rounded once
        const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
        const uint32_t rw[4] = {rv[k].x, rv[k].y, rv[k].z, rv[k].w};
        uint32_t out[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          out[jj] = pack_rn(__fadd_rn(lo_bf(rw[jj]), __fmul_rn(a.res_scale, lo_bf(ow[jj]))),
                            __fadd_rn(hi_bf(rw[jj]), __fmul_rn(a.res_scale, hi_bf(ow[jj]))));
        o = make_uint4(out[0], out[1], out[2], out[3]);
      }
      *reinterpret_cast<uint4*>(a.y + off) = o;
    }
    named_bar(bar_id, 128);                // the staging is read before V is rewritten
  }
  mbar_wait(ubar, uphase);                 // no copy outlives the block
}

template <int M, int R, int kMode>
__device__ __forceinline__ void wino_conv_block(const WinoArgs& a, unsigned char* smem) {
  load_u_half<M>(a.u, smem_u32(smem), R);
  int iter = 0;
  wino_conv_wgmma<M, R, kMode, false>(a, smem, 0, iter);
}

// Without a residual, ReLU is a select, not a template: RCAN's trunk
// alternates the ReLU and plain convs, and one instance each made every
// switch refetch the kernel's code (measured on an H100: 0.075 ms a call
// inside a residual group against 0.062 alone; 0.064 with one instance).
// With the residual it is a template: there the select's register took
// the instance to 254 registers and cost 13 %.
template <int M, int kMode>
__global__ void __launch_bounds__(kWThreads, 1)
wino_conv_wgmma_kernel(WinoArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wino_barrier_init<M>(smem);
  if (cooperative_groups::this_cluster().block_rank() == 0)
    wino_conv_block<M, 0, kMode>(a, smem);
  else
    wino_conv_block<M, 1, kMode>(a, smem);
}

// ------------------------------------------------ kernel (c): conv chain
// K convs (+ bias, + ReLU) in one persistent cooperative launch (replaces
// sres_tpu/ops/pallas/winograd_conv.py:_chain_fwd_kernel, :339). The TPU
// kernel keeps a sample block resident in VMEM across the K convs; here a
// 48x48x64 bf16 sample (288 KiB) does not fit an SM, so the activations
// ping-pong through device memory between y and one scratch buffer (2 x
// 21 MB at batch 72 in bf16: both fit the 50 MB L2) and a grid-wide
// barrier separates the convs. Each conv runs the code of kernel (a) on the
// same grid and tile ranges (bf16: the clusters of the wgmma conv, each
// block loading its half of the conv's U; f32: the tile blocks over a
// grid-stride loop), so the chain equals K launches of kernel (a) bit for
// bit; what one
// launch saves is K - 1 launches and their host wrappers. Activations are
// read with ld.global.cg (coherent at L2 after the barrier). The grid is
// co-resident, as a cooperative launch requires: bf16 that of kernel (a),
// f32 the occupancy times the SMs.
//
// conv k writes y when nchain - 1 - k is even, else buf: the last conv
// lands in y and no conv reads the buffer it writes.
template <typename T>
__device__ __forceinline__ const T* chain_src(int k, int nchain, const T* x, T* buf, T* y) {
  return k == 0 ? x : ((nchain - k) % 2 == 0 ? y : buf);
}
template <typename T>
__device__ __forceinline__ T* chain_dst(int k, int nchain, T* buf, T* y) {
  return (nchain - 1 - k) % 2 == 0 ? y : buf;
}

template <int M, int R>
__device__ __forceinline__ void wino_chain_block(const bf16* x, const unsigned char* u,
                                                 const float* bias, bf16* buf, bf16* y,
                                                 int nchain, int nimg, int h, int w, int relu,
                                                 unsigned char* smem) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int iter = 0;
  for (int k = 0; k < nchain; ++k) {
    // conv k's U replaces conv k - 1's, which every product has read
    load_u_half<M>(u + (size_t)k * (M + 2) * (M + 2) * WGeo<M>::kUTap, smem_u32(smem), R);
    const WinoArgs a{chain_src(k, nchain, x, buf, y), nullptr, bias + k * kC, nullptr,
                     chain_dst(k, nchain, buf, y), nimg, h, w, relu, 1.0f};
    wino_conv_wgmma<M, R, 0, true>(a, smem, k & 1, iter);
    if (k + 1 < nchain) grid.sync();
  }
}

template <int M>
__global__ void __launch_bounds__(kWThreads, 1)
wino_chain_wgmma_kernel(const bf16* x, const unsigned char* __restrict__ u,
                        const float* __restrict__ bias, bf16* buf, bf16* y, int nchain,
                        int nimg, int h, int w, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  wino_barrier_init<M>(smem);
  if (cooperative_groups::this_cluster().block_rank() == 0)
    wino_chain_block<M, 0>(x, u, bias, buf, y, nchain, nimg, h, w, relu, smem);
  else
    wino_chain_block<M, 1>(x, u, bias, buf, y, nchain, nimg, h, w, relu, smem);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
wino_chain_f32_kernel(const float* x, const float* __restrict__ u,
                      const float* __restrict__ bias, float* buf, float* y, int nchain,
                      int nimg, int h, int w, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntiles = nimg * (h / M) * (w / M);
  const int nblk = (ntiles + kF32Tiles - 1) / kF32Tiles;
  const size_t ustride = (size_t)(M + 2) * (M + 2) * kC * kC;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < nchain; ++k) {
    const float* src = chain_src(k, nchain, x, buf, y);
    float* dst = chain_dst(k, nchain, buf, y);
    for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
      conv_tiles_f32<M, true>(src, u + k * ustride, bias + k * kC, nullptr, dst, nimg, h, w,
                              relu, 1.0f, blk * kF32Tiles, reinterpret_cast<float*>(smem_raw));
      __syncthreads();                     // vs is rewritten by the next block
    }
    if (k + 1 < nchain) grid.sync();
  }
}

// ------------------------------------------- kernel (b): channel attention
// out = q + r * gate(r) in one launch. What bounds it: q and r read once,
// out written once (63.7 MB at 72x64x48x48 bf16: 19.0 us at 3.35 TB/s);
// the MLP is a few thousand MACs a sample. Two kernels, chosen by shape
// (ca_route):
// (b1) ca_cluster_kernel, when a sample's r fits the shared memory of a
//   cluster of 1, 2, 4 or 8 blocks at kCaSliceMax bytes a block (three
//   blocks an SM; 48x48 bf16: 4 blocks of 576 pixels): the cluster holds
//   its sample's r, each block a slice of pixels loaded by kCaStages bulk
//   copies on mbarriers and summed per channel as each lands; the blocks
//   add the cluster's sums through distributed shared memory in rank
//   order (each block gets the same bits), each runs the MLP over its
//   warps, then streams q in with 16-byte loads (a thread's first
//   kCaPrefetch vectors in flight since the start, then the next
//   kCaPrefetch while it computes the current ones) and out with 16-byte
//   stores, r from shared memory. r is read from device memory once.
// (b2) ca_two_pass_kernel, for larger samples (above 4640 pixels in bf16,
//   as 96x96; above 2320 in f32): one
//   cooperative launch that sums r per chunk of kCaChunkPix pixels into
//   f32 partials, computes each sample's gate once (one block a sample,
//   its partials in order) and streams q and r again (CaStream), 16-byte
//   accesses throughout: r is read twice.
constexpr int kCaStages = 4;         // (b1): bulk copies a slice of r comes in
constexpr int kCaSliceMax = 74240;   // (b1): r's bytes a block holds, three blocks an SM
constexpr int kCaPrefetch = 4;       // q vectors a thread has in flight, twice over
constexpr int kCaChunkPix = 256;     // (b2): pixels a partial sum covers
constexpr int kCaBatch = 3;          // (b2): vectors a thread streams at a time

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ca_cluster_kernel(const T* __restrict__ q, const T* __restrict__ r,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  T* __restrict__ out, int hw, int hidden, float inv_npix) {
  using V = CaVec<T>;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int nc = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int im = blockIdx.x / nc, tid = threadIdx.x;
  const int p0 = (int)((long long)hw * rank / nc);
  const int npix = (int)((long long)hw * (rank + 1) / nc) - p0, nvec = npix * V::kPerPix;
  const size_t base = ((size_t)im * hw + p0) * kC;          // the slice's first element
  extern __shared__ __align__(128) unsigned char rs[];       // r's slice, as in memory
  __shared__ __align__(8) uint64_t bars[kCaStages];
  __shared__ float csum[kC];                                 // read by the cluster's blocks
  __shared__ float red[kCaWarps][kC];                        // the block sum; mean, hid, gate
  if (tid == 0) {
    for (int s = 0; s < kCaStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kCaStages; ++s) {
      const int a = npix * s / kCaStages, e = npix * (s + 1) / kCaStages;
      const uint32_t bytes = (uint32_t)(e - a) * kC * sizeof(T);
      mbar_expect_tx(smem_u32(&bars[s]), bytes);
      if (bytes)
        bulk_g2s(smem_u32(rs + (size_t)a * kC * sizeof(T)), r + base + (size_t)a * kC, bytes,
                 smem_u32(&bars[s]));
    }
  }
  uint4 qa[kCaPrefetch];
#pragma unroll
  for (int j = 0; j < kCaPrefetch; ++j) {
    const int v = tid + j * kThreads;
    if (v < nvec) qa[j] = ldg16(q + base + (size_t)v * V::kVec);
  }
  __syncthreads();                                           // the mbarriers are set
  float acc[V::kVec] = {};
  for (int s = 0; s < kCaStages; ++s) {
    const int a = npix * s / kCaStages * V::kPerPix, e = npix * (s + 1) / kCaStages * V::kPerPix;
    mbar_wait(smem_u32(&bars[s]), 0);
    for (int v = a + tid; v < e; v += kThreads) {
      float f[V::kVec];
      unpack16<T>(*reinterpret_cast<const uint4*>(rs + (size_t)v * 16), f);
#pragma unroll
      for (int k = 0; k < V::kVec; ++k) acc[k] += f[k];
    }
  }
  ca_block_sum<T>(acc, red, csum);
  cluster_arrive();                                          // this block's sums in place
  CaWeights cw;
  ca_load_weights(cw, w1, b1, w2, b2, hidden);
  cluster_wait();                                            // every block's
  float *mean = red[0], *hid = red[1], *gate = red[2];
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < nc; ++k) t += cluster.map_shared_rank(csum, k)[tid];
    mean[tid] = t * inv_npix;
  }
  cluster_arrive();                                          // done with the peers' sums
  __syncthreads();
  ca_mlp<T, false>(cw, mean, hid, gate, hidden);
  const int grp = tid % V::kPerPix;
  float g[V::kVec];
#pragma unroll
  for (int k = 0; k < V::kVec; ++k) g[k] = gate[grp * V::kVec + k];
  for (int v0 = 0; v0 < nvec; v0 += kCaPrefetch * kThreads) {
    uint4 qn[kCaPrefetch];                                   // the next batch, in flight
#pragma unroll
    for (int j = 0; j < kCaPrefetch; ++j) {
      const int v = v0 + (kCaPrefetch + j) * kThreads + tid;
      if (v < nvec) qn[j] = ldg16(q + base + (size_t)v * V::kVec);
    }
#pragma unroll
    for (int j = 0; j < kCaPrefetch; ++j) {
      const int v = v0 + tid + j * kThreads;
      if (v >= nvec) break;
      float qf[V::kVec], rf[V::kVec], o[V::kVec];
      unpack16<T>(qa[j], qf);
      unpack16<T>(*reinterpret_cast<const uint4*>(rs + (size_t)v * 16), rf);
#pragma unroll
      for (int k = 0; k < V::kVec; ++k) o[k] = __fadd_rn(qf[k], __fmul_rn(rf[k], g[k]));
      stg16(out + base + (size_t)v * V::kVec, pack16<T>(o));
    }
#pragma unroll
    for (int j = 0; j < kCaPrefetch; ++j) qa[j] = qn[j];
  }
  cluster_wait();                              // no block leaves while a peer reads its sums
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ca_two_pass_kernel(const T* __restrict__ q, const T* __restrict__ r,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* partial, float* gates, T* __restrict__ out, int nimg, int hw,
                   int hidden, float inv_npix) {
  using V = CaVec<T>;
  __shared__ __align__(16) float red[kCaRowChunk][kC];  // block sums; partial rows
  __shared__ float mlp[3][kC];                           // mean, hid, gate
  const int tid = threadIdx.x, nch = (hw + kCaChunkPix - 1) / kCaChunkPix;
  for (int u = blockIdx.x; u < nimg * nch; u += gridDim.x) {    // pass 1: chunk sums
    const int im = u / nch, pc = u % nch * kCaChunkPix;
    const int nvec = min(kCaChunkPix, hw - pc) * V::kPerPix;
    const T* rb = r + ((size_t)im * hw + pc) * kC;
    float acc[V::kVec] = {};
    for (int v = tid; v < nvec; v += kThreads) {
      float f[V::kVec];
      unpack16<T>(ldg16(rb + (size_t)v * V::kVec), f);
#pragma unroll
      for (int k = 0; k < V::kVec; ++k) acc[k] += f[k];
    }
    ca_block_sum<T>(acc, red, partial + (size_t)u * kC);
  }
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();
  if ((int)blockIdx.x < nimg) {                                 // each sample's gate, once
    CaWeights cw;
    ca_load_weights(cw, w1, b1, w2, b2, hidden);
    for (int im = blockIdx.x; im < nimg; im += gridDim.x) {
      ca_sum_rows<true>(partial + (size_t)im * nch * kC, nch, red, mlp[0]);
      if (tid < kC) mlp[0][tid] *= inv_npix;
      __syncthreads();
      ca_mlp<T, false>(cw, mlp[0], mlp[1], mlp[2], hidden);
      if (tid < kC) gates[(size_t)im * kC + tid] = mlp[2][tid];
    }
  }
  CaStream<T, T, kCaBatch, false> st;
  st.start(q, r, out, nullptr, (long long)nimg * hw);
  st.load(st.v);
  grid.sync();                                                  // pass 2: the stream
  st.run(gates, hw);
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

// The SMs of `device`, read once.
int num_sms(int device) {
  static int cache[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0 &&
      cudaDeviceGetAttribute(&cache[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    cache[device] = 0;
  return cache[device];
}

// Launch kernel (a, bf16) or the chain in clusters of kWCluster, on the
// persistent grid: the most clusters resident at once (one block an SM), or
// one a unit when the tiles make fewer units. `coop` adds a cooperative
// launch (the chain's grid barrier).
template <typename K, typename... Args>
cudaError_t launch_wgmma(K kernel, int* resident, uint32_t smem, int units, bool coop,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kWCluster);
  cudaError_t e;
  if (*resident == 0) {                    // queried once per kernel
    if ((e = cudaOccupancyMaxActiveClusters(resident, kernel, &cfg)) != cudaSuccess) return e;
    if (*resident < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.numAttrs = coop ? 2 : 1;
  cfg.gridDim = dim3(kWCluster * std::max(1, std::min(units, *resident)));   // a unit a cluster
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int M>
int wgmma_units(int nimg, int h, int w) {
  return (nimg * (h / M) * (w / M) + 2 * WGeo<M>::kTW - 1) / (2 * WGeo<M>::kTW);
}

template <int M, int kMode>
int launch_conv_wgmma(const WinoArgs& a, cudaStream_t stream) {
  static bool done = false;
  static int resident = 0;
  const cudaError_t e = allow_smem(wino_conv_wgmma_kernel<M, kMode>, WGeo<M>::kSmem, done);
  if (e != cudaSuccess) return (int)e;
  if (a.nimg == 0) return 0;
  return (int)launch_wgmma(wino_conv_wgmma_kernel<M, kMode>, &resident, WGeo<M>::kSmem,
                           wgmma_units<M>(a.nimg, a.h, a.w), false, stream, a);
}

template <int M>
int launch_conv_bf16(const void* x, const void* u, const float* bias, const void* res,
                     void* y, int nimg, int h, int w, int relu, float res_scale,
                     cudaStream_t s) {
  const WinoArgs a{static_cast<const bf16*>(x), static_cast<const unsigned char*>(u), bias,
                   static_cast<const bf16*>(res), static_cast<bf16*>(y), nimg, h, w, relu != 0,
                   res_scale};
  if (res == nullptr) return launch_conv_wgmma<M, 0>(a, s);
  return relu ? launch_conv_wgmma<M, 2>(a, s) : launch_conv_wgmma<M, 1>(a, s);
}

template <typename K>
cudaError_t launch_coop(K kernel, int grid, int threads, size_t smem, void** args,
                        int device, cudaStream_t stream) {
  int coop = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(threads), args,
                                     smem, stream);
}

template <int M>
int launch_chain_bf16(const void* x, const void* u, const float* bias, void* buf, void* y,
                      int nchain, int nimg, int h, int w, int relu, int device,
                      cudaStream_t stream) {
  static bool done = false;
  static int resident = 0;
  cudaError_t e = allow_smem(wino_chain_wgmma_kernel<M>, WGeo<M>::kSmem, done);
  if (e != cudaSuccess) return (int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  return (int)launch_wgmma(wino_chain_wgmma_kernel<M>, &resident, WGeo<M>::kSmem,
                           wgmma_units<M>(nimg, h, w), true, stream,
                           static_cast<const bf16*>(x), static_cast<const unsigned char*>(u),
                           bias, static_cast<bf16*>(buf), static_cast<bf16*>(y), nchain, nimg,
                           h, w, relu != 0);
}

template <int M>
int launch_chain_f32(const void* x, const void* u, const float* bias, void* buf, void* y,
                     int nchain, int nimg, int h, int w, int relu, int device,
                     cudaStream_t stream) {
  const size_t smem = (size_t)(M + 2) * (M + 2) * kC * kF32Row * sizeof(float);
  static bool done = false;
  cudaError_t e = allow_smem(wino_chain_f32_kernel<M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wino_chain_f32_kernel<M>,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int nblk = (nimg * (h / M) * (w / M) + kF32Tiles - 1) / kF32Tiles;
  const int grid = std::max(1, std::min(nblk, per_sm * num_sms(device)));
  const float* xp = static_cast<const float*>(x);
  const float* up = static_cast<const float*>(u);
  float* bp = static_cast<float*>(buf);
  float* yp = static_cast<float*>(y);
  void* args[] = {(void*)&xp, (void*)&up, (void*)&bias, (void*)&bp, (void*)&yp,
                  (void*)&nchain, (void*)&nimg, (void*)&h, (void*)&w, (void*)&relu};
  e = launch_coop(wino_chain_f32_kernel<M>, grid, kThreads, smem, args, device, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size ca_cluster_kernel takes for a sample of hw pixels of T:
// the fewest blocks (1, 2, 4 or 8) whose slices fit kCaSliceMax, or 0 (the
// two-pass kernel) when none does or such clusters cannot be resident.
template <typename T>
cudaError_t ca_route(int hw, int& nc) {
  static bool done = false;
  static int fits = -1;
  nc = 0;
  if (!done) {
    cudaError_t e = allow_smem(ca_cluster_kernel<T>, kCaSliceMax, done);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ca_cluster_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  if (fits < 0) {                          // the largest cluster at the largest slice
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(8);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kCaSliceMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 8;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, ca_cluster_kernel<T>, &cfg);
    if (e != cudaSuccess) return e;
    fits = n >= 1;
  }
  if (!fits) return cudaSuccess;
  for (int k = 1; k <= 8; k *= 2)
    if ((long long)((hw + k - 1) / k) * kC * sizeof(T) <= kCaSliceMax) {
      nc = k;
      break;
    }
  return cudaSuccess;
}

template <typename T>
int launch_ca(const void* q, const void* r, const float* w1, const float* b1,
              const float* w2, const float* b2, float* scratch, void* out, int nimg,
              int hw, int hidden, int device, cudaStream_t stream) {
  int nc = 0;
  cudaError_t e = ca_route<T>(hw, nc);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* rt = static_cast<const T*>(r);
  T* ot = static_cast<T*>(out);
  const float inv_npix = 1.0f / (float)hw;
  if (nc > 0) {
    const uint32_t smem = (uint32_t)((hw + nc - 1) / nc) * kC * sizeof(T);
    return (int)ca_launch(ca_cluster_kernel<T>, nimg * nc, nc, smem, false, stream, qt, rt,
                          w1, b1, w2, b2, ot, hw, hidden, inv_npix);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  static int cache = 0;
  int resident = 0;
  if ((e = ca_resident(ca_two_pass_kernel<T>, device, cache, resident)) != cudaSuccess)
    return (int)e;
  const int units = nimg * ((hw + kCaChunkPix - 1) / kCaChunkPix);
  float* gates = scratch + (size_t)units * kC;
  return (int)ca_launch(ca_two_pass_kernel<T>, std::min(units, resident), 1, 0, true, stream,
                        qt, rt, w1, b1, w2, b2, scratch, gates, ot, nimg, hw, hidden, inv_npix);
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
// for float as it is; for bf16 in the kernel order, element U[ti*n + tj]
// [ci][co] at [tj][ti][ci / 8][co][ci % 8] (a column of taps after another,
// each tap wgmma's K-major core-matrix layout of U^T).
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
    return m == 4 ? launch_chain_bf16<4>(x, u, bias, buf, y, nchain, nimg, h, w, relu, device, s)
                  : launch_chain_bf16<2>(x, u, bias, buf, y, nchain, nimg, h, w, relu, device, s);
  return m == 4 ? launch_chain_f32<4>(x, u, bias, buf, y, nchain, nimg, h, w, relu, device, s)
                : launch_chain_f32<2>(x, u, bias, buf, y, nchain, nimg, h, w, relu, device, s);
}

// The cluster size of ca_skip's one-launch kernel for (nimg, hw) in this
// dtype: 1, 2, 4 or 8 (ca_cluster_kernel: r read once), 0 (the two-pass
// kernel), or minus a cudaError_t.
int sres_ca_skip_cluster(int nimg, int hw, int bf16_, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (nimg < 1 || hw < 1)) e = cudaErrorInvalidValue;
  int nc = 0;
  if (e == cudaSuccess) e = bf16_ ? ca_route<bf16>(hw, nc) : ca_route<float>(hw, nc);
  return e != cudaSuccess ? -(int)e : nc;
}

// Floats of scratch sres_ca_skip needs for (nimg, hw): 0 on the cluster
// kernel; the two-pass kernel's chunk sums and gates; or minus a cudaError_t.
int sres_ca_skip_scratch(int nimg, int hw, int bf16_, int device) {
  const int nc = sres_ca_skip_cluster(nimg, hw, bf16_, device);
  if (nc != 0) return nc < 0 ? nc : 0;
  return nimg * ((hw + kCaChunkPix - 1) / kCaChunkPix + 1) * kC;
}

// out = q + r * sigmoid(W2 relu(W1 mean(r) + b1) + b2), one launch.
// q, r, out: (nimg, hw, 64) NHWC, 16-byte aligned; w1: (hidden, 64), b1:
// (hidden,), w2: (64, hidden), b2: (64,) f32; scratch:
// sres_ca_skip_scratch(...) floats (may be null when that is 0).
int sres_ca_skip(const void* q, const void* r, const float* w1, const float* b1,
                 const float* w2, const float* b2, float* scratch, void* out,
                 int nimg, int hw, int hidden, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || nimg < 1 || hw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return launch_ca<bf16>(q, r, w1, b1, w2, b2, scratch, out, nimg, hw, hidden, device, s);
  return launch_ca<float>(q, r, w1, b1, w2, b2, scratch, out, nimg, hw, hidden, device, s);
}

}  // extern "C"
