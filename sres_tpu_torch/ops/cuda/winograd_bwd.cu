// Backward of the Winograd conv and of the RCAB channel attention, for Hopper.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/winograd_conv.py:_bwd_kernel (via _bwd_exec_impl):
//       the per-conv exact adjoint dx, dU, db;
//   sres_tpu/ops/pallas/wino_group_grad.py:_conv_adj and the channel-attention
//       half of _bwd_chunk_kernel (via _bwd_chunk_exec_impl): the conv
//       adjoint with the CA prologue (dc2 = da * gate + ds) or the ReLU gate,
//       accumulating dx into an f32 cotangent, and the CA backward.
// The reversed RCAB loop that composes them is ops/winograd_conv.py.
//
// (K1) wino_conv_bwd, three launches per call. Per tile, the cotangent's
// prologue (CA scaling, ReLU gate) and its A-adjoint dM (both stages rounded
// to T) feed two products: dV = dM . U^T, whose B-adjoint dd (first stage
// s2 rounded to T, second in f32) is overlap-added into dx, and dU = V^T . dM
// summed over the batch, V being the input transform of x. No tensor of
// tiles x n^2 x 64 passes through device memory:
//   1. wino_bwd_dx_kernel: a thread-block cluster per (image, column strip),
//      one CTA per band of tile rows, walking down its band in passes of up
//      to 32 tiles (two tile rows at 48 x 48, m = 4). A pass puts dM in
//      shared memory. Warp w runs dV for 16 tiles x 8 channels on mma.sync
//      m16n8k16 (A by ldmatrix; the U^T fragments straight from L2, four
//      taps ahead in registers, so the tap loop has no barrier of its own),
//      one tap row (n taps) at a time in registers; after each row a barrier,
//      and the first stage of the B-adjoint writes s2 over the row's dM.
//      Then, in rounds of channels, dd is overlap-added into an f32 band in
//      shared memory in four phases, by tile-row and tile-column parity, so
//      no two threads add to one element at once and each element sums in
//      one fixed order. Finished pixel rows are written once: rounded once
//      to T, or written or added in f32. Two pixel rows lie under two tile
//      rows: inside a band the lower pass adds to the rows carried from the
//      upper one; across bands each CTA keeps its top two rows and its
//      carried two, and after a cluster barrier finishes the row it owns with
//      its neighbour's through distributed shared memory. Each such pixel is
//      (upper tile row's sum) + (lower tile row's sum), whichever CTA adds
//      them. An image too wide for the band is cut into column strips, each
//      recomputing the tile column beside it on either side. The prologue
//      gives one db partial per CTA.
//   2. wino_bwd_du_kernel: a cluster of four CTAs per range of tiles, CTA q
//      holding dU for input channels 16 q.. of every tap in mma accumulators.
//      A pass of 32 tiles: each CTA recomputes V of its 16 input channels
//      from x and dM of output channels 16 q.. from g (the prologue
//      included), sends that quarter of dM to the three other CTAs by bulk
//      copy (cp.async.bulk into their shared memory, completing on their
//      mbarriers), and runs V^T . dM on mma.sync. One partial per range.
//   3. wino_bwd_sum_kernel: the dU and db partials summed in a fixed order.
// No atomics, so two runs give the same bits. f32 activations run the same
// layout and thread ownership with FMAs in place of mma (U^T read from L2),
// 16 tiles a pass.
//
// What bounds it on this card: at 72x64x48x48, m=4, the call must read g,
// y, x and write dx (and read dprev): 85-170 MB by mode, 25-51 us at 3.35
// TB/s; the two products are 6.2 GFLOP, 6 us at the bf16 tensor-core peak.
// It is bound by bytes, and runs at 9-14x that bound. Measured on an H100
// with clock counters per phase (PERF.md, section 6): a CTA fills an SM (shared
// memory), so each pass is a chain of latencies at 16 warps an SM (the
// prologue's loads, the tap loop's L2 fragment loads, the overlap-add's
// shared-memory round trips), and the dx kernel runs two waves; in the dU
// kernel the recompute of V and dM takes longer than the exchange of dM
// and the products together.

// (K2) ca_skip_bwd, one cooperative launch (ca_skip_bwd_kernel, the shared
// design of ca_common.cuh's ca_bwd): the sums of c2 and of da * c2 over
// equal ranges of the pixels in 16-byte vectors, da and c2 read once; after
// a grid barrier each sample's MLP backward over the warps (gate
// recomputed, ds = W1^T dz1 / npix); once a count shows them all done, the
// weight gradients summed over samples in order, one output a thread.
// Bound: one read of da (f32) and c2, 63.7 MB at bf16, 19.0 us.

#include <cooperative_groups.h>

#include <algorithm>

#include "ca_common.cuh"
#include "wino_common.cuh"

namespace {

namespace cg = cooperative_groups;

// ------------------------------------------------------------- geometry
// Per activation type: the threads of a dx or dU CTA (dx: warp w owns
// channels 8 (w % 8).. of tiles 16 (w / 8)..) and the tiles a pass holds at
// most (the same bytes of dM either way).
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int kThr = 512;
  static constexpr int TB = 32;
};
template <> struct Cfg<float> {
  static constexpr int kThr = 256;
  static constexpr int TB = 16;
};

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt in to
constexpr int kDuBlocks = 4;      // channel blocks of 16: the dU kernel's cluster
constexpr int kDuRanges = 28;     // tile ranges at most: 28 clusters of 4 fit an H100 at once
constexpr int kPrefetch = 4;      // U taps the dx kernel's warps load ahead

// f32 stride of one pixel in the overlap-add band of cg channels: + 2 (m = 4)
// or + 4 (m = 2), so the two tiles of a warp's 16-channel halves, 2 M pixels
// apart, add into distinct banks
template <int M>
__host__ __device__ constexpr int band_stride(int cg) {
  return cg + (M == 4 ? 2 : 4);
}

// Element (row, col) of a [rows][64] array whose 16-byte chunks are
// XOR-swizzled by row % 8: ldmatrix over 8 rows and reads of one column by
// 8 rows are conflict-free.
template <typename T>
__device__ __forceinline__ int sw64(int row, int col) {
  constexpr int CE = 16 / sizeof(T);
  return row * kC + (((col / CE) ^ (row & 7)) * CE) + col % CE;
}

// Element (row, col) of a [rows][16] array: bf16 rows are two chunks,
// swapped on rows 4-7 of every 8 (conflict-free ldmatrix.trans).
template <typename T>
__device__ __forceinline__ int sw16(int row, int col) {
  if constexpr (sizeof(T) == 2)
    return row * 16 + (((col >> 3) ^ ((row >> 2) & 1)) << 3) + (col & 7);
  return row * 16 + col;
}

// Layout of the dx kernel: column strips, tile rows a pass, channels a
// round of the overlap-add, bands (the cluster), shared-memory offsets.
// Computed on the host from the shape.
struct DxGeo {
  int ns;       // column strips
  int kr;       // tile rows a pass holds
  int tbs;      // dM rows a tap: the pass's tiles, rounded up to 8
  int cg;       // channels of one round of the overlap-add
  int nb;       // bands of tile rows per (image, strip): the cluster size
  int cols;     // pixel columns of the widest strip
  int band;     // byte offset of the overlap-add band
  int rows;     // byte offset of the kept rows (top two, carried two)
  int red;      // byte offset of the db reduction
  int smem;     // bytes in all; 0 if no layout fits
};

template <typename T, int M>
DxGeo dx_geometry(int h, int w) {
  constexpr int N2 = (M + 2) * (M + 2), TB = Cfg<T>::TB;
  const int th = h / M, tw = w / M;
  DxGeo g = {};
  for (int ns = 1; ns <= tw && g.smem == 0; ++ns) {
    const int s = (tw + ns - 1) / ns, cs = std::min(tw, s + (ns > 1 ? 2 : 0));
    if (cs > TB) continue;
    for (int kr = std::min(TB / cs, th); kr >= 1 && g.smem == 0; --kr) {
      for (int cg = kC; cg >= 16 && g.smem == 0; cg /= 2) {
        const int tbs = (kr * cs + 7) / 8 * 8, cols = M * s;
        const int dm = tbs * N2 * kC * (int)sizeof(T);
        const int band = (M * kr + 2) * cols * band_stride<M>(cg) * 4;
        const int keep = 4 * cols * kC * 4;
        const int total = dm + band + keep + Cfg<T>::kThr * 4;
        if (total <= kMaxSmem)
          g = DxGeo{ns, kr, tbs, cg, 0, cols, dm, dm + band, dm + band + keep, total};
      }
    }
  }
  if (g.smem) g.nb = std::max(1, std::min({8, th, (th + 2 * g.kr - 1) / (2 * g.kr)}));
  return g;
}

// dU kernel: tile ranges (one cluster of kDuBlocks CTAs each)
int du_ranges(int ntiles, int tb) { return std::max(1, std::min(kDuRanges, ntiles / tb)); }

// A zero the compiler cannot see through. Added to a pass's base pointers,
// it keeps addresses that do not change from pass to pass from being
// computed once and held, spilled, across the pass loop.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

// ------------------------------------------------- the cotangent of a tile
// One (tile, channel) of the cotangent: its raw values (g, and y where the
// ReLU gate applies), loaded all at once so that the loads of several
// tiles are in flight together, then the prologue (CA scaling g * gate +
// ds, ReLU gate y > 0), its sum over the tile's pixels (for db), and dM =
// the A-adjoint of it, both stages rounded to T. A tile that is not valid
// reads tile (0, 0) of image 0 and gives zeros.
template <int M>
struct CotIn {
  float g[M][M], y[M][M], ga, gd;
};

template <typename T, typename G, int M>
__device__ __forceinline__ void cot_load(CotIn<M>& in, const G* __restrict__ g,
                                         const T* __restrict__ y,
                                         const float* __restrict__ gate,
                                         const float* __restrict__ ds, bool valid, int im,
                                         int rr, int cc, int h, int w, int ch) {
  if (!valid) im = rr = cc = 0;
  const size_t base = (((size_t)im * h + rr * M) * w + cc * M) * kC + ch;
  const int row = w * kC;
#pragma unroll
  for (int u = 0; u < M; ++u)
#pragma unroll
    for (int v = 0; v < M; ++v) in.g[u][v] = to_f(g[base + u * row + v * kC]);
  if (y != nullptr) {
#pragma unroll
    for (int u = 0; u < M; ++u)
#pragma unroll
      for (int v = 0; v < M; ++v) in.y[u][v] = to_f(y[base + u * row + v * kC]);
  }
  in.ga = gate != nullptr ? gate[im * kC + ch] : 1.0f;
  in.gd = gate != nullptr ? ds[im * kC + ch] : 0.0f;
}

template <typename T, int M>
__device__ __forceinline__ float cot_dm(const CotIn<M>& in, bool gated, bool relu, bool valid,
                                        float (&dm)[M + 2][M + 2]) {
  constexpr int N = M + 2;
  float gu[M][M], sum = 0.0f;
#pragma unroll
  for (int u = 0; u < M; ++u) {
#pragma unroll
    for (int v = 0; v < M; ++v) {
      float gv = in.g[u][v];
      if (gated) gv = gv * in.ga + in.gd;
      if (relu && !(in.y[u][v] > 0.0f)) gv = 0.0f;
      if (!valid) gv = 0.0f;
      sum += gv;
      gu[u][v] = gv;
    }
  }
  float zz[M][N];                                    // zz[u][tj]
#pragma unroll
  for (int u = 0; u < M; ++u) {
    at_t_apply<M>(gu[u], zz[u]);
#pragma unroll
    for (int tj = 0; tj < N; ++tj) zz[u][tj] = rnd<T>(zz[u][tj]);
  }
#pragma unroll
  for (int tj = 0; tj < N; ++tj) {
    float col[M], out[N];
#pragma unroll
    for (int u = 0; u < M; ++u) col[u] = zz[u][tj];
    at_t_apply<M>(col, out);
#pragma unroll
    for (int ti = 0; ti < N; ++ti) dm[ti][tj] = rnd<T>(out[ti]);
  }
  return sum;
}

// Two channels of dx at one pixel: rounded to T (mode 0), written in f32
// (1) or added to the f32 value there (2).
template <typename T>
__device__ __forceinline__ void put_dx(void* out, size_t off, int mode, float a, float b) {
  if (mode == 2) {
    float2* p = reinterpret_cast<float2*>(static_cast<float*>(out) + off);
    const float2 o = *p;
    *p = make_float2(o.x + a, o.y + b);
  } else if (mode == 1) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(a, b);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off) =
        pack_bf(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(a, b);
  }
}

// ------------------------------------------------------ (1) dx kernel
// T: activation type (y, U, dM, dV); G: type of the cotangent g. ut: U^T,
// for bf16 in the mma fragment order of sres_wino_conv (one 8-byte load a
// lane per (tap, n8 block, k-step)), for f32 plain (n*n, Cout, Cin). Grid:
// nb x ns x nimg CTAs in clusters of nb (the bands of one image strip).
template <typename T, typename G, int M>
__global__ void __launch_bounds__(Cfg<T>::kThr, 1)
wino_bwd_dx_kernel(const G* __restrict__ g, const T* __restrict__ y, const void* __restrict__ ut,
                   const float* __restrict__ gate, const float* __restrict__ ds,
                   void* __restrict__ out, float* __restrict__ dbpart, int h, int w,
                   int out_mode, DxGeo geo) {
  constexpr int N = M + 2, N2 = N * N, NT = Cfg<T>::kThr;
  cg::cluster_group cluster = cg::this_cluster();
  const int th = h / M, tw = w / M, nb = geo.nb, rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / nb, im = unit / geo.ns, strip = unit % geo.ns;
  const int rb0 = rank * th / nb, rb1 = (rank + 1) * th / nb;
  const int s0 = strip * tw / geo.ns, s1 = (strip + 1) * tw / geo.ns;
  const int c0 = max(s0 - 1, 0), cs = min(s1 + 1, tw) - c0;
  const int cols = M * (s1 - s0), px0 = M * s0, tbs = geo.tbs, cgn = geo.cg;
  const int ps = band_stride<M>(cgn);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dms = reinterpret_cast<T*>(smem_raw);                 // [N2][tbs][64] dM, then s2
  float* band = reinterpret_cast<float*>(smem_raw + geo.band);   // [rows][cols][ps]
  float* top = reinterpret_cast<float*>(smem_raw + geo.rows);    // [2][cols][64]
  float* carry = top + 2 * geo.cols * kC;                  // [2][cols][64]
  float* red = reinterpret_cast<float*>(smem_raw + geo.red);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const int mb = warp >> 3, nbk = warp & 7, ci = 8 * nbk + 2 * q4, ch = tid % kC;
  const size_t img = (size_t)im * h * w * kC;
  float dbacc = 0.0f;

  for (int r = rb0; r < rb1; r += geo.kr) {
    const int kk = min(geo.kr, rb1 - r), ntile = kk * cs, z = opaque_zero();
    const int brows = M * kk + 2;

    // (a) the prologue and dM of every tile of the pass, two items at once
    for (int item = tid; item < ntile * kC; item += 2 * NT) {
      float dm0[N][N], dm1[N][N];
      const int j0 = item / kC, j1 = (item + NT) / kC;
      const bool v1 = item + NT < ntile * kC;
      const int cc0 = c0 + j0 % cs, cc1 = c0 + j1 % cs;
      CotIn<M> in0, in1;
      cot_load<T, G, M>(in0, g, y, gate, ds, true, im, r + j0 / cs, cc0, h, w, ch);
      cot_load<T, G, M>(in1, g, y, gate, ds, v1, im, r + j1 / cs, cc1, h, w, ch);
      const float sa = cot_dm<T, M>(in0, gate != nullptr, y != nullptr, true, dm0);
      const float sb = cot_dm<T, M>(in1, gate != nullptr, y != nullptr, v1, dm1);
      if (cc0 >= s0 && cc0 < s1) dbacc += sa;
      if (v1 && cc1 >= s0 && cc1 < s1) dbacc += sb;
#pragma unroll
      for (int ti = 0; ti < N; ++ti)
#pragma unroll
        for (int tj = 0; tj < N; ++tj) {
          dms[z + sw64<T>((ti * N + tj) * tbs + j0, ch)] = from_f<T>(dm0[ti][tj]);
          if (v1) dms[z + sw64<T>((ti * N + tj) * tbs + j1, ch)] = from_f<T>(dm1[ti][tj]);
        }
    }
    __syncthreads();

    // (b) dV = dM . U^T, one tap row (ti) at a time: the warp's 16 tiles x
    // 8 channels of the row's N taps in registers (rounded to T); after the
    // row, a barrier, and the first stage of the B-adjoint, s2[ti][q]
    // (rounded to T), is stored over the row's dM, which no warp reads
    // again. bf16: U^T fragments straight from L2, kPrefetch taps ahead.
    const bool live = 16 * mb < ntile;
    const int j0 = 16 * mb + gq, j1 = j0 + 8;
    uint2 bq[kPrefetch][4];
    const uint2* uf = static_cast<const uint2*>(ut) + z + nbk * 4 * 32 + lane;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) bq[p][ks] = __ldg(uf + (p * 32 + ks) * 32);
    }
#pragma unroll
    for (int ti = 0; ti < N; ++ti) {
      float dv[N][4];
#pragma unroll
      for (int tj = 0; tj < N; ++tj) {
        const int t = ti * N + tj;
        float* c = dv[tj];
        c[0] = c[1] = c[2] = c[3] = 0.0f;
        if constexpr (sizeof(T) == 2) {
          uint2 b[4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) b[ks] = bq[t % kPrefetch][ks];
          if (t + kPrefetch < N2) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              bq[t % kPrefetch][ks] = __ldg(uf + ((t + kPrefetch) * 32 + ks) * 32);
          }
          if (live) {
            const int r8 = lane & 7, mat = lane >> 3, arow = 16 * mb + r8 + (mat & 1) * 8;
            const T* a = dms + z + (t * tbs + arow) * kC;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              uint32_t af[4];
              ldsm_x4<false>(af, a + (((2 * ks + (mat >> 1)) ^ (arow & 7)) << 3));
              mma_bf16(c, af, b[ks].x, b[ks].y);
            }
          }
        } else {
          const float* ub = static_cast<const float*>(ut) + z + (size_t)t * kC * kC + ci;
#pragma unroll 8
          for (int k = 0; k < kC; ++k) {
            const float a0 = dms[z + sw64<float>(t * tbs + j0, k)];
            const float a1 = dms[z + sw64<float>(t * tbs + j1, k)];
            const float2 bb = __ldg(reinterpret_cast<const float2*>(ub + k * kC));
            c[0] = fmaf(a0, bb.x, c[0]);
            c[1] = fmaf(a0, bb.y, c[1]);
            c[2] = fmaf(a1, bb.x, c[2]);
            c[3] = fmaf(a1, bb.y, c[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = rnd<T>(c[e]);
      }
      __syncthreads();      // every warp is done with this tap row's dM
#pragma unroll
      for (int e = 0; e < 4; ++e) {          // e: (tile j0 + 8 (e / 2), channel ci + e % 2)
        float row[N], s2[N];
#pragma unroll
        for (int tj = 0; tj < N; ++tj) row[tj] = dv[tj][e];
        bt_t_apply<M>(row, s2);
#pragma unroll
        for (int q = 0; q < N; ++q) dv[q][e] = s2[q];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = j0 + 8 * hh;
        if (j < ntile) {
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const int at = z + sw64<T>((ti * N + q) * tbs + j, ci);
            const float a = dv[q][2 * hh], b = dv[q][2 * hh + 1];
            if constexpr (sizeof(T) == 2)
              *reinterpret_cast<uint32_t*>(dms + at) =
                  pack_bf(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
            else
              *reinterpret_cast<float2*>(dms + at) = make_float2(a, b);
          }
        }
      }
    }
    __syncthreads();        // s2 whole

    // (c) rounds of cgn channels: dd = the second stage of the B-adjoint
    // (f32) overlap-added into the band, phase (tile-row parity,
    // tile-column parity) at a time, then the band's pixel rows M r - 1 + i
    // out: the first two finish the carried rows (or, in a band's first
    // pass, are kept for the cluster exchange), the last two are carried,
    // the rest are done
    for (int g0 = 0; g0 < kC; g0 += cgn) {
      for (int i = tid; i < brows * cols * ps; i += NT) band[z + i] = 0.0f;
      __syncthreads();
#pragma unroll 1
      for (int ph = 0; ph < 4; ++ph) {
        const int pr = ph >> 1, pc = ph & 1;
        const int nr = (kk - pr + 1) / 2, nc = (cs - pc + 1) / 2;
        for (int it = tid; it < nr * nc * cgn; it += NT) {
          const int a = it / cgn, c = g0 + it % cgn;
          const int lr = pr + 2 * (a / nc), lc = pc + 2 * (a % nc), j = lr * cs + lc;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const int bc = M * (c0 + lc) - 1 + q - px0;
            if (bc < 0 || bc >= cols) continue;
            float col[N], dd[N];
#pragma unroll
            for (int ti = 0; ti < N; ++ti)
              col[ti] = to_f(dms[z + sw64<T>((ti * N + q) * tbs + j, c)]);
            bt_t_apply<M>(col, dd);
            float* bp = band + z + ((M * lr) * cols + bc) * ps + c - g0;
#pragma unroll
            for (int p = 0; p < N; ++p) bp[p * cols * ps] += dd[p];
          }
        }
        __syncthreads();
      }
      for (int it = tid; it < cols * (cgn / 2); it += NT) {
        const int bc = it / (cgn / 2), cl = 2 * (it % (cgn / 2)), cp = g0 + cl;
        const size_t col = img + (size_t)(px0 + bc) * kC + cp;
        for (int i = 0; i < brows; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(band + z + (i * cols + bc) * ps + cl);
          if (i < 2) {
            float* kept = (r == rb0 ? top : carry) + (i * cols + bc) * kC + cp;
            float2* kp = reinterpret_cast<float2*>(kept);
            if (r == rb0) {
              *kp = v;
            } else {
              const float2 c = *kp;
              put_dx<T>(out, col + (size_t)(M * r - 1 + i) * w * kC, out_mode, c.x + v.x,
                        c.y + v.y);
            }
          } else if (i < M * kk) {
            put_dx<T>(out, col + (size_t)(M * r - 1 + i) * w * kC, out_mode, v.x, v.y);
          } else {
            *reinterpret_cast<float2*>(carry + ((i - M * kk) * cols + bc) * kC + cp) = v;
          }
        }
      }
      __syncthreads();      // the band is free for the next round
    }
  }

  // (d) the rows under two bands: pixel row M rb0 (this band's top row, plus
  // the band above's carried row) and M rb1 - 1 (the carried row, plus the
  // band below's top row)
  cluster.sync();
  const float* above = rank > 0 ? cluster.map_shared_rank(carry, rank - 1) : nullptr;
  const float* below = rank < nb - 1 ? cluster.map_shared_rank(top, rank + 1) : nullptr;
  for (int it = tid; it < cols * (kC / 2); it += NT) {
    const int bc = it / (kC / 2), cp = 2 * (it % (kC / 2));
    const size_t col = img + (size_t)(px0 + bc) * kC + cp;
    const int i1 = (cols + bc) * kC + cp, i0 = bc * kC + cp;
    float2 v = *reinterpret_cast<const float2*>(top + i1);
    if (above != nullptr) {
      const float2 c = *reinterpret_cast<const float2*>(above + i1);
      v = make_float2(v.x + c.x, v.y + c.y);
    }
    put_dx<T>(out, col + (size_t)(M * rb0) * w * kC, out_mode, v.x, v.y);
    v = *reinterpret_cast<const float2*>(carry + i0);
    if (below != nullptr) {
      const float2 c = *reinterpret_cast<const float2*>(below + i0);
      v = make_float2(v.x + c.x, v.y + c.y);
    }
    put_dx<T>(out, col + (size_t)(M * rb1 - 1) * w * kC, out_mode, v.x, v.y);
  }
  red[tid] = dbacc;
  cluster.sync();           // no CTA leaves while a neighbour reads its rows
  if (tid < kC) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < NT / kC; ++l) t += red[l * kC + tid];
    dbpart[(size_t)blockIdx.x * kC + tid] = t;
  }
}

// ------------------------------------------------------ (2) dU kernel
// Grid: kDuBlocks x ranges, a cluster per range. CTA cb of a cluster holds
// dU[t][16 cb + i][co] for every tap t over the range's tiles, in passes of
// TB tiles: it recomputes V of its 16 input channels and dM of output
// channels 16 cb.. (its quarter) into shared memory, sends the quarter to
// the three other CTAs with bulk copies (cp.async.bulk into distributed
// shared memory, each completing on the receiver's mbarrier), and runs
// V^T . dM on mma.sync (bf16) or FMAs (f32). dM is kept by quarter,
// [q][t][tile][16]. Warp w holds the output channels 16 (w % 4).. (quarter
// w % 4) of taps w / 4, w / 4 + NW / 4, ...
template <typename T, typename G, int M>
__global__ void __launch_bounds__(Cfg<T>::kThr, 1)
wino_bwd_du_kernel(const G* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y,
                   const float* __restrict__ gate, const float* __restrict__ ds,
                   float* __restrict__ part, int nimg, int h, int w) {
  constexpr int N = M + 2, N2 = N * N, TB = Cfg<T>::TB, NT = Cfg<T>::kThr, NW = NT / 32;
  constexpr int TPW = N2 * 4 / NW;                  // taps a warp accumulates
  constexpr int QE = N2 * TB * 16;                  // elements of a quarter of dM
  constexpr uint32_t QB = QE * sizeof(T);           // its bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int cb = (int)cluster.block_rank(), rng = blockIdx.y, nrng = gridDim.y;
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int t0 = (int)((long long)rng * ntiles / nrng);
  const int t1 = (int)((long long)(rng + 1) * ntiles / nrng);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dmq = reinterpret_cast<T*>(smem_raw);                  // [4][N2][TB][16]
  T* vs = dmq + kDuBlocks * QE;                             // [N2][TB][16]
  const uint32_t bar = smem_u32(vs + QE);                   // the other quarters landed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const int nq = warp & 3, tw0 = warp >> 2;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();           // every CTA's mbarrier is set before a copy signals it
  float acc[TPW][2][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  int phase = 0;
  for (int tile0 = t0; tile0 < t1; tile0 += TB, phase ^= 1) {
    const int nt = min(TB, t1 - tile0), z = opaque_zero();
    // V of channels 16 cb.., dM of channels 16 cb.. (the CTA's quarter)
    for (int item = tid; item < TB * 32; item += NT) {
      const int j = (item >> 4) & (TB - 1), cl = item & 15, c = 16 * cb + cl;
      float v[N][N];
      if (item < TB * 16) {
        input_transform<T, M>(x, j < nt ? tile0 + j : ntiles, ntiles, h, w, c, v);
#pragma unroll
        for (int ti = 0; ti < N; ++ti)
#pragma unroll
          for (int tj = 0; tj < N; ++tj)
            vs[z + sw16<T>((ti * N + tj) * TB + j, cl)] = from_f<T>(v[ti][tj]);
      } else {
        const int gg = tile0 + j;
        CotIn<M> in;
        cot_load<T, G, M>(in, g, y, gate, ds, j < nt, gg / (th * tw), (gg / tw) % th, gg % tw,
                          h, w, c);
        cot_dm<T, M>(in, gate != nullptr, y != nullptr, j < nt, v);
#pragma unroll
        for (int ti = 0; ti < N; ++ti)
#pragma unroll
          for (int tj = 0; tj < N; ++tj)
            dmq[z + cb * QE + sw16<T>((ti * N + tj) * TB + j, cl)] = from_f<T>(v[ti][tj]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the bulk copies
    __syncthreads();        // this CTA's quarter of dM written
    // sent to the other three CTAs at the same place; their quarters come
    // in on this CTA's mbarrier
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"((kDuBlocks - 1) * QB)
                   : "memory");
      const uint32_t src = smem_u32(dmq + cb * QE);
#pragma unroll
      for (int a = 1; a < kDuBlocks; ++a) {
        const uint32_t peer = (cb + a) % kDuBlocks;
        uint32_t dst, pbar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(src), "r"(peer));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(pbar) : "r"(bar), "r"(peer));
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(dst),
            "r"(src), "r"(QB), "r"(pbar)
            : "memory");
      }
    }
    mbar_wait(bar, phase);  // dM whole in every CTA of the cluster
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = tw0 + (NW / 4) * i;
      const T* va = vs + z + t * TB * 16;
      const T* db = dmq + z + nq * QE + t * TB * 16;
      if constexpr (sizeof(T) == 2) {
        const int r8 = lane & 7, mat = lane >> 3;
#pragma unroll
        for (int ks = 0; ks < TB / 16; ++ks) {
          uint32_t af[4], bfr[4];
          const int arow = 16 * ks + r8 + (mat >> 1) * 8;
          ldsm_x4<true>(af, va + sw16<T>(arow, (mat & 1) * 8));
          const int brow = 16 * ks + r8 + (mat & 1) * 8;
          ldsm_x4<true>(bfr, db + sw16<T>(brow, (mat >> 1) * 8));
          mma_bf16(acc[i][0], af, bfr[0], bfr[1]);
          mma_bf16(acc[i][1], af, bfr[2], bfr[3]);
        }
      } else {
        for (int k = 0; k < TB; ++k) {
          const float a0 = va[sw16<T>(k, gq)], a1 = va[sw16<T>(k, gq + 8)];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 8 * j + 2 * q4;
            const float b0 = db[sw16<T>(k, n)], b1 = db[sw16<T>(k, n + 1)];
            acc[i][j][0] = fmaf(a0, b0, acc[i][j][0]);
            acc[i][j][1] = fmaf(a0, b1, acc[i][j][1]);
            acc[i][j][2] = fmaf(a1, b0, acc[i][j][2]);
            acc[i][j][3] = fmaf(a1, b1, acc[i][j][3]);
          }
        }
      }
    }
    cluster.sync();         // no CTA reads V or dM of this pass any more
  }

  // one partial per range: part[range][t][ci][co], this CTA's 16 channels
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int t = tw0 + (NW / 4) * i;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(part + (((size_t)rng * N2 + t) * kC + 16 * cb + gq + 8 * hf) *
                                              kC + 16 * nq + 8 * j + 2 * q4) =
            make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
  }
}

// ------------------------------------------------------ (3) the sums
// du[e] = sum over ranges of dupart[range][e], db[c] = sum over dx CTAs of
// dbpart[cta][c], each in order.
__global__ void __launch_bounds__(kThreads)
wino_bwd_sum_kernel(const float* __restrict__ dupart, int nrng, int ndu,
                    const float* __restrict__ dbpart, int nblk, float* __restrict__ du,
                    float* __restrict__ db) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  float t = 0.0f;
  if (idx < ndu) {
    for (int s = 0; s < nrng; ++s) t += dupart[(size_t)s * ndu + idx];
    du[idx] = t;
  } else if (idx < ndu + kC) {
    for (int s = 0; s < nblk; ++s) t += dbpart[(size_t)s * kC + idx - ndu];
    db[idx - ndu] = t;
  }
}

// ------------------------------------------------ (K2) channel attention
// Vectors a thread has in flight in the stream (48 bytes each with c2 in
// bf16), and the blocks an SM.
constexpr int kCaBwdBatch = 4, kCaBwdBlocks = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads, kCaBwdBlocks) ca_skip_bwd_kernel(const CaBwdArgs a) {
  ca_bwd<float, T, false, kCaBwdBatch>(a);
}

// The kernel's resident blocks on the card, queried once per instance.
template <typename T>
cudaError_t ca_skip_bwd_resident(int device, int& resident) {
  static int cache = 0;
  return ca_resident(ca_skip_bwd_kernel<T>, device, cache, resident);
}

// ------------------------------------------------------------ launchers
template <typename T, int M>
int scratch_floats(int nimg, int h, int w) {
  constexpr int N2 = (M + 2) * (M + 2);
  const DxGeo geo = dx_geometry<T, M>(h, w);
  if (geo.smem == 0) return -1;
  const int nrng = du_ranges(nimg * (h / M) * (w / M), Cfg<T>::TB);
  return geo.nb * geo.ns * nimg * kC + nrng * N2 * kC * kC;
}

template <typename K, typename... Args>
cudaError_t launch_clustered(K kernel, dim3 grid, dim3 cluster, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, typename G, int M>
int launch_conv_bwd(const void* g, const void* x, const void* y, const void* ut,
                    const float* gate, const float* ds, float* scratch, void* out, float* du,
                    float* db, int nimg, int h, int w, int out_mode, cudaStream_t stream) {
  constexpr int N2 = (M + 2) * (M + 2), TB = Cfg<T>::TB;
  const DxGeo geo = dx_geometry<T, M>(h, w);
  if (geo.smem == 0) return (int)cudaErrorInvalidValue;
  static bool done_dx = false, done_du = false;
  cudaError_t e = allow_smem(wino_bwd_dx_kernel<T, G, M>, kMaxSmem, done_dx);
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(wino_bwd_du_kernel<T, G, M>, kMaxSmem, done_du)) != cudaSuccess)
    return (int)e;
  const int nblk = geo.nb * geo.ns * nimg, ntiles = nimg * (h / M) * (w / M);
  const int nrng = du_ranges(ntiles, TB);
  float* dbpart = scratch;
  float* dupart = scratch + (size_t)nblk * kC;
  const G* gg = static_cast<const G*>(g);
  const T* yy = static_cast<const T*>(y);
  e = launch_clustered(wino_bwd_dx_kernel<T, G, M>, dim3(nblk), dim3(geo.nb, 1, 1),
                       Cfg<T>::kThr, geo.smem, stream, gg, yy, ut, gate, ds, out, dbpart, h, w,
                       out_mode, geo);
  if (e != cudaSuccess) return (int)e;
  e = launch_clustered(wino_bwd_du_kernel<T, G, M>, dim3(kDuBlocks, nrng),
                       dim3(kDuBlocks, 1, 1), Cfg<T>::kThr,
                       N2 * TB * (kC + 16) * (int)sizeof(T) + 16, stream, gg,
                       static_cast<const T*>(x), yy, gate, ds, dupart, nimg, h, w);
  if (e != cudaSuccess) return (int)e;
  const int ndu = N2 * kC * kC;
  wino_bwd_sum_kernel<<<(ndu + kC + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dupart, nrng, ndu, dbpart, nblk, du, db);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int dispatch_m(int m, const void* g, const void* x, const void* y, const void* ut,
               const float* gate, const float* ds, float* scratch, void* out, float* du,
               float* db, int nimg, int h, int w, int out_mode, cudaStream_t s) {
  if (m == 4)
    return launch_conv_bwd<T, G, 4>(g, x, y, ut, gate, ds, scratch, out, du, db, nimg, h, w,
                                    out_mode, s);
  return launch_conv_bwd<T, G, 2>(g, x, y, ut, gate, ds, scratch, out, du, db, nimg, h, w,
                                  out_mode, s);
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" {

// f32 elements of the conv backward's scratch (the dx kernel's db partials
// and the dU kernel's per-cluster partials), or -1 for a shape it does not take.
int sres_wino_bwd_scratch(int nimg, int h, int w, int m, int bf16_) {
  if ((m != 2 && m != 4) || nimg < 1 || h < m || w < m || h % m || w % m) return -1;
  if (bf16_)
    return m == 4 ? scratch_floats<bf16, 4>(nimg, h, w) : scratch_floats<bf16, 2>(nimg, h, w);
  return m == 4 ? scratch_floats<float, 4>(nimg, h, w) : scratch_floats<float, 2>(nimg, h, w);
}

// g (nimg, h, w, 64) NHWC of float (g_f32 = 1) or of the activation type;
// x, y: activation type (bf16_ = 1: bf16, else float; y may be null); ut:
// U^T = (n*n, Cout, Cin) in the activation type, for bf16 in the mma
// fragment order of sres_wino_conv; gate, ds: (nimg, 64) f32 or null;
// scratch: sres_wino_bwd_scratch floats. Out: `out` (nimg, h, w, 64) in the
// activation type (out_mode 0), f32 written (1) or f32 added to (2); du
// (n*n, 64, 64) f32; db (64,) f32.
int sres_wino_conv_bwd(const void* g, const void* x, const void* y, const void* ut,
                       const float* gate, const float* ds, float* scratch, void* out,
                       float* du, float* db, int nimg, int h, int w, int m, int bf16_,
                       int g_f32, int out_mode, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (sres_wino_bwd_scratch(nimg, h, w, m, bf16_) < 0 || out_mode < 0 || out_mode > 2 ||
      (!bf16_ && !g_f32) || (out_mode == 0 && g_f32 && bf16_))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_)
    return dispatch_m<float, float>(m, g, x, y, ut, gate, ds, scratch, out, du, db, nimg, h, w,
                                    out_mode, s);
  if (g_f32)
    return dispatch_m<bf16, float>(m, g, x, y, ut, gate, ds, scratch, out, du, db, nimg, h, w,
                                   out_mode, s);
  return dispatch_m<bf16, bf16>(m, g, x, y, ut, gate, ds, scratch, out, du, db, nimg, h, w,
                                out_mode, s);
}

// Floats of scratch sres_ca_skip_bwd needs (partial rows and the rows of
// the weight gradient), or minus a cudaError_t.
int sres_ca_skip_bwd_scratch(int nimg, int hw, int bf16_, int device) {
  if (nimg < 1 || hw < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  int resident = 0;
  if (e == cudaSuccess)
    e = bf16_ ? ca_skip_bwd_resident<bf16>(device, resident)
              : ca_skip_bwd_resident<float>(device, resident);
  if (e != cudaSuccess) return -(int)e;
  int grid = 0, nrow = 0;
  ca_bwd_plan(nimg, hw, bf16_ ? CaVec<bf16>::kPerPix : CaVec<float>::kPerPix, resident, grid,
              nrow);
  const long long n = ca_bwd_scratch(nimg, nrow, CaBwdRows<false>::kN);
  return n > 0x7fffffff ? -(int)cudaErrorInvalidValue : (int)n;
}

// da (nimg, hw, 64) f32; c2 (nimg, hw, 64) of float or bf16, both 16-byte
// aligned; w1 (hidden, 64), b1 (hidden,), w2 (64, hidden), b2 (64,) f32;
// scratch: sres_ca_skip_bwd_scratch floats. Out: gate, ds (nimg, 64); dw1
// (hidden, 64), db1 (hidden,), dw2 (64, hidden), db2 (64,), all f32. One
// cooperative launch (ca_skip_bwd_kernel).
int sres_ca_skip_bwd(const float* da, const void* c2, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* scratch, float* gate, float* ds,
                     float* dw1, float* db1, float* dw2, float* db2, int nimg, int hw,
                     int hidden, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || nimg < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CaBwdArgs a{da, c2, nullptr, w1, b1, w2, b2, scratch, gate, ds, dw1, db1, dw2, db2,
                    nimg, hw, hidden, 0};
  int resident = 0;
  if (bf16_) {
    if ((e = ca_skip_bwd_resident<bf16>(device, resident)) != cudaSuccess) return (int)e;
    return (int)ca_bwd_launch(ca_skip_bwd_kernel<bf16>, a, CaVec<bf16>::kPerPix, resident, s);
  }
  if ((e = ca_skip_bwd_resident<float>(device, resident)) != cudaSuccess) return (int)e;
  return (int)ca_bwd_launch(ca_skip_bwd_kernel<float>, a, CaVec<float>::kPerPix, resident, s);
}

}  // extern "C"
