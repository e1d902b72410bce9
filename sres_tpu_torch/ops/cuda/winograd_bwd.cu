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
// (K1) wino_conv_bwd, four launches per call:
//   1. wino_bwd_tile_kernel: per block of tiles, the output cotangent's
//      prologue (CA scaling / ReLU gate, db partial), dM = A-adjoint of it
//      (two stages, each rounded to T), V recomputed from x (as the forward),
//      dV = dM . U^T (tensor cores for bf16), rounded to T, and the per-tile
//      B-adjoint dd = BT^T dV BT (first stage rounded to T, second in f32).
//      It writes dM and V (T) for the weight gradient and dd (f32) per tile.
//   2. wino_dx_gather_kernel: dx of each input pixel = the sum, in a fixed
//      order, of the dd entries of the (at most 2 x 2) tiles whose patch
//      covers it; entries that fall in the zero padding are never read. So
//      no two blocks write one pixel, and the result does not depend on the
//      schedule. Rounds to T once, writes f32, or adds into an f32 buffer.
//   3. wino_du_kernel: dU[t] = V[t]^T . dM[t], the sum over all tiles of the
//      batch, split over (tap, K-slice) blocks, each writing one partial.
//   4. sum_partials_kernel: the partials summed in a fixed order (dU, db).
// On the TPU the grid ran in order and dU sat in one resident output block;
// here blocks run in parallel, so the sum is a deterministic two-pass
// reduction, with no atomics.
//
// What bounds it on this card: at 72x64x48x48, m=4, the dV and dU products
// are 3.1 GFLOP each (about 6 us at the bf16 tensor-core peak), while the
// call must read g, x (and y) and write dx: 85-130 MB, 25-39 us at 3.35 TB/s.
// It is memory-bound. This first design is not: it moves dM, V (T) and dd
// (f32) through device memory, about 380 MB more at bf16. Keeping them on
// chip (dU partials per tap in registers, the overlap-add inside a block
// that owns whole tile rows) is later work.
//
// (K2) ca_skip_bwd, three launches: per-(sample, chunk) partial sums of c2
// and of da * c2 (split as the forward's pooling), one block per sample for
// the 32-wide MLP backward (gate, ds = dz1 . W1 / npix), and one small
// kernel summing the weight gradients over samples. Bound: one read of da
// (f32) and c2, 63 MB at bf16, 19 us.

#include "wino_common.cuh"

namespace {

// ------------------------------------------------- shared-memory layouts
// bf16: [tap][tile][ch] with 72-element rows (the forward's mma layout);
// f32: [tap][ch][tile] with a padded tile row, 8 tiles per block.
template <typename T> struct Bwd;
template <> struct Bwd<bf16> {
  static constexpr int TB = kMmaTiles;
  static constexpr int kPerTap = kMmaTiles * kMmaRow;
  __device__ static int at(int tap, int tile, int ch) {
    return (tap * TB + tile) * kMmaRow + ch;
  }
};
template <> struct Bwd<float> {
  static constexpr int TB = 8;
  static constexpr int kRow = TB + 1;
  static constexpr int kPerTap = kC * kRow;
  __device__ static int at(int tap, int tile, int ch) {
    return (tap * kC + ch) * kRow + tile;
  }
};

// dV[t] (tiles x ci) = dM[t] (tiles x co) . U[t]^T, rounded to T, for all
// taps. bf16: mma.sync m16n8k16, warp nb computes ci 8*nb..+7; ut holds
// U^T in the forward's B-fragment order. f32: FMA, thread (tile j, ci pair).
template <typename T, int N2>
struct DvProducts;

template <int N2>
struct DvProducts<bf16, N2> {
  __device__ static void run(const bf16* dms, bf16* dvs, const void* ut, int tid) {
    const uint2* ufrag = static_cast<const uint2*>(ut);
    const int nb = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
    for (int t = 0; t < N2; ++t) {
      const bf16* va = dms + ((size_t)t * kMmaTiles + gq) * kMmaRow + 2 * q4;
      const uint2* ub = ufrag + ((size_t)(t * 8 + nb) * 4) * 32 + lane;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(va + 16 * ks);
        a[1] = *reinterpret_cast<const uint32_t*>(va + 8 * kMmaRow + 16 * ks);
        a[2] = *reinterpret_cast<const uint32_t*>(va + 16 * ks + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(va + 8 * kMmaRow + 16 * ks + 8);
        const uint2 b = __ldg(ub + ks * 32);
        mma_bf16(c, a, b.x, b.y);
      }
      const int ci = 8 * nb + 2 * q4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dvs[Bwd<bf16>::at(t, gq + 8 * (r >> 1), ci + (r & 1))] = __float2bfloat16_rn(c[r]);
    }
  }
};

template <int N2>
struct DvProducts<float, N2> {
  __device__ static void run(const float* dms, float* dvs, const void* ut, int tid) {
    const float* uts = static_cast<const float*>(ut);       // [t][co][ci]
    const int j = tid / 32, ci = 2 * (tid % 32);
    for (int t = 0; t < N2; ++t) {
      const float* ut_t = uts + (size_t)t * kC * kC + ci;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
      for (int co = 0; co < kC; ++co) {
        const float d = dms[Bwd<float>::at(t, j, co)];
        const float2 uu = __ldg(reinterpret_cast<const float2*>(ut_t + co * kC));
        a0 = fmaf(d, uu.x, a0);
        a1 = fmaf(d, uu.y, a1);
      }
      dvs[Bwd<float>::at(t, j, ci)] = a0;
      dvs[Bwd<float>::at(t, j, ci + 1)] = a1;
    }
  }
};

// ------------------------------------------------ (K1.1) per-tile kernel
// T: activation type (x, y, U, V, dM); G: type of the cotangent g.
// gate/ds (nimg, 64) f32, or null; y (post-ReLU output) or null.
template <typename T, typename G, int M>
__global__ void __launch_bounds__(kThreads)
wino_bwd_tile_kernel(const G* __restrict__ g, const T* __restrict__ x,
                     const T* __restrict__ y, const void* __restrict__ ut,
                     const float* __restrict__ gate, const float* __restrict__ ds,
                     T* __restrict__ vbuf, T* __restrict__ dmbuf,
                     float* __restrict__ ddbuf, float* __restrict__ dbpart,
                     int nimg, int h, int w) {
  constexpr int N = M + 2, N2 = N * N, TB = Bwd<T>::TB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dms = reinterpret_cast<T*>(smem_raw);                 // dM, Bwd<T> layout
  T* dvs = dms + (size_t)N2 * Bwd<T>::kPerTap;             // dV
  __shared__ float dbred[kThreads];
  const int th = h / M, tw = w / M, ntiles = nimg * th * tw;
  const int tile0 = blockIdx.x * TB, tid = threadIdx.x;

  // phase 1: prologue + dM (to shared and global), V (to global)
  float dbacc = 0.0f;                        // channel tid % 64 (256 % 64 == 0)
  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ch = item % kC, gt = tile0 + j;
    const bool valid = gt < ntiles;
    const int gg = valid ? gt : 0;
    const int im = gg / (th * tw), rr = (gg / tw) % th, cc = gg % tw;
    float gu[M][M];
#pragma unroll
    for (int u = 0; u < M; ++u) {
#pragma unroll
      for (int v = 0; v < M; ++v) {
        const size_t off = (((size_t)im * h + rr * M + u) * w + cc * M + v) * kC + ch;
        float gv = 0.0f;
        if (valid) {
          gv = to_f(g[off]);
          if (gate != nullptr) gv = gv * gate[im * kC + ch] + ds[im * kC + ch];
          if (y != nullptr && !(to_f(y[off]) > 0.0f)) gv = 0.0f;
        }
        dbacc += gv;
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
      for (int ti = 0; ti < N; ++ti) {
        const T d = from_f<T>(out[ti]);
        dms[Bwd<T>::at(ti * N + tj, j, ch)] = d;
        if (valid) dmbuf[((size_t)gt * N2 + ti * N + tj) * kC + ch] = d;
      }
    }
    float vv[N][N];
    input_transform<T, M>(x, gt, ntiles, h, w, ch, vv);
    if (valid) {
#pragma unroll
      for (int ti = 0; ti < N; ++ti)
#pragma unroll
        for (int tj = 0; tj < N; ++tj)
          vbuf[((size_t)gt * N2 + ti * N + tj) * kC + ch] = from_f<T>(vv[ti][tj]);
    }
  }
  dbred[tid] = dbacc;
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < kThreads / kC; ++l) t += dbred[l * kC + tid];
    dbpart[(size_t)blockIdx.x * kC + tid] = t;
  }

  // phase 2: dV = dM . U^T per tap, rounded to T
  DvProducts<T, N2>::run(dms, dvs, ut, tid);
  __syncthreads();

  // phase 3: dd = BT^T . dV . BT per (tile, ci): s2[ti][q] rounded to T
  for (int item = tid; item < TB * kC; item += kThreads) {
    const int j = item / kC, ci = item % kC, gt = tile0 + j;
    if (gt >= ntiles) continue;
    float s2[N][N];                                    // s2[ti][q]
#pragma unroll
    for (int ti = 0; ti < N; ++ti) {
      float row[N];
#pragma unroll
      for (int tj = 0; tj < N; ++tj) row[tj] = to_f(dvs[Bwd<T>::at(ti * N + tj, j, ci)]);
      bt_t_apply<M>(row, s2[ti]);
#pragma unroll
      for (int q = 0; q < N; ++q) s2[ti][q] = rnd<T>(s2[ti][q]);
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float col[N], dd[N];
#pragma unroll
      for (int ti = 0; ti < N; ++ti) col[ti] = s2[ti][q];
      bt_t_apply<M>(col, dd);
#pragma unroll
      for (int p = 0; p < N; ++p)
        ddbuf[((size_t)gt * N2 + p * N + q) * kC + ci] = dd[p];
    }
  }
}

// ------------------------------------------------ (K1.2) dx gather
// Thread = (pixel, 4 channels). OutT = T (mode 0: round once) or float
// (mode 1: write; mode 2: add into out).
template <typename OutT, int M>
__global__ void __launch_bounds__(kThreads)
wino_dx_gather_kernel(const float* __restrict__ dd, OutT* __restrict__ out,
                      int nimg, int h, int w, int accumulate) {
  constexpr int N = M + 2;
  const long long total = (long long)nimg * h * w * (kC / 4);
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c4 = (int)(idx % (kC / 4)) * 4;
  const long long pix = idx / (kC / 4);
  const int xx = (int)(pix % w), yy = (int)((pix / w) % h), im = (int)(pix / ((long long)w * h));
  const int th = h / M, tw = w / M;
  // tiles r with 0 <= yy + 1 - M*r <= N - 1
  const int r_hi = min((yy + 1) / M, th - 1), s_hi = min((xx + 1) / M, tw - 1);
  const int r_lo = yy + 2 - N <= 0 ? 0 : (yy + 2 - N + M - 1) / M;
  const int s_lo = xx + 2 - N <= 0 ? 0 : (xx + 2 - N + M - 1) / M;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = r_lo; r <= r_hi; ++r) {
    const int p = yy + 1 - M * r;
    for (int s = s_lo; s <= s_hi; ++s) {
      const int q = xx + 1 - M * s;
      const size_t tile = ((size_t)im * th + r) * tw + s;
      float f[4];
      load4(dd + (tile * N * N + p * N + q) * kC + c4, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += f[k];
    }
  }
  OutT* o = out + pix * kC + c4;
  if constexpr (sizeof(OutT) == 4) {
    float* of = reinterpret_cast<float*>(o);
    if (accumulate) {
      const float4 prev = *reinterpret_cast<const float4*>(of);
      acc[0] += prev.x;
      acc[1] += prev.y;
      acc[2] += prev.z;
      acc[3] += prev.w;
    }
    store4(of, acc);
  } else {
    uint2 pk;
    pk.x = pack_bf(__float2bfloat16_rn(acc[0]), __float2bfloat16_rn(acc[1]));
    pk.y = pack_bf(__float2bfloat16_rn(acc[2]), __float2bfloat16_rn(acc[3]));
    *reinterpret_cast<uint2*>(o) = pk;
  }
}

// ------------------------------------------------ (K1.3) weight gradient
// Block (tap t, K-slice s) sums V[tile][t]^T dM[tile][t] over its tiles in
// chunks of 32 staged in shared memory; writes one 64x64 f32 partial.
constexpr int kDuChunk = 32;
constexpr int kDuRow = kC + 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
wino_du_kernel(const T* __restrict__ vbuf, const T* __restrict__ dmbuf,
               float* __restrict__ part, int ntiles, int n2) {
  __shared__ __align__(16) T vc[kDuChunk][kDuRow];
  __shared__ __align__(16) T dc[kDuChunk][kDuRow];
  const int t = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y, tid = threadIdx.x;
  const int k_begin = (int)((long long)ntiles * s / nsplit);
  const int k_end = (int)((long long)ntiles * (s + 1) / nsplit);
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const int mi = warp & 3, nh = warp >> 2;               // bf16 warp tiling

  for (int k0 = k_begin; k0 < k_end; k0 += kDuChunk) {
    for (int e = tid; e < kDuChunk * kC; e += kThreads) {
      const int kk = e / kC, ch = e % kC, tile = k0 + kk;
      const bool ok = tile < k_end;
      const size_t off = ((size_t)(ok ? tile : 0) * n2 + t) * kC + ch;
      vc[kk][ch] = ok ? vbuf[off] : from_f<T>(0.0f);
      dc[kk][ch] = ok ? dmbuf[off] : from_f<T>(0.0f);
    }
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      // 64 (ci) x 64 (co): warp = rows 16*mi.., columns 32*nh.. (4 n8 blocks)
#pragma unroll
      for (int ks = 0; ks < kDuChunk / 16; ++ks) {
        const int kb = 16 * ks + 2 * q4, r0 = 16 * mi + gq;
        uint32_t a[4];
        a[0] = pack_bf(vc[kb][r0], vc[kb + 1][r0]);
        a[1] = pack_bf(vc[kb][r0 + 8], vc[kb + 1][r0 + 8]);
        a[2] = pack_bf(vc[kb + 8][r0], vc[kb + 9][r0]);
        a[3] = pack_bf(vc[kb + 8][r0 + 8], vc[kb + 9][r0 + 8]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int n0 = 32 * nh + 8 * jn + gq;
          const uint32_t b0 = pack_bf(dc[kb][n0], dc[kb + 1][n0]);
          const uint32_t b1 = pack_bf(dc[kb + 8][n0], dc[kb + 9][n0]);
          mma_bf16(acc + 4 * jn, a, b0, b1);
        }
      }
    } else {
      // thread (ci = tid / 4, co = 16 * (tid % 4) + k)
      const int ci = tid >> 2, co0 = 16 * (tid & 3);
      for (int kk = 0; kk < kDuChunk; ++kk) {
        const float v = to_f(vc[kk][ci]);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = fmaf(v, to_f(dc[kk][co0 + k]), acc[k]);
      }
    }
    __syncthreads();
  }
  float* pt = part + ((size_t)t * nsplit + s) * kC * kC;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int ci = 16 * mi + gq, co = 32 * nh + 8 * jn + 2 * q4;
      pt[ci * kC + co] = acc[4 * jn];
      pt[ci * kC + co + 1] = acc[4 * jn + 1];
      pt[(ci + 8) * kC + co] = acc[4 * jn + 2];
      pt[(ci + 8) * kC + co + 1] = acc[4 * jn + 3];
    }
  } else {
    const int ci = tid >> 2, co0 = 16 * (tid & 3);
#pragma unroll
    for (int k = 0; k < 16; ++k) pt[ci * kC + co0 + k] = acc[k];
  }
}

// ------------------------------------------------ (K2) channel attention
// (K2.1) per (sample, chunk): partial sums of c2 and of da * c2 per channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
ca_bwd_pool_kernel(const float* __restrict__ da, const T* __restrict__ c2,
                   float* __restrict__ partial, int hw) {
  const int s = blockIdx.x, nsplit = gridDim.x, im = blockIdx.y;
  const int c = threadIdx.x % kC, lane = threadIdx.x / kC;
  constexpr int kLanes = kThreads / kC;
  const int p0 = (int)((long long)hw * s / nsplit);
  const int p1 = (int)((long long)hw * (s + 1) / nsplit);
  const size_t base = (size_t)im * hw * kC + c;
  float a_s = 0.0f, a_g = 0.0f;
  for (int p = p0 + lane; p < p1; p += kLanes) {
    const float v = to_f(c2[base + (size_t)p * kC]);
    a_s += v;
    a_g = fmaf(da[base + (size_t)p * kC], v, a_g);
  }
  __shared__ float red[2][kThreads];
  red[0][threadIdx.x] = a_s;
  red[1][threadIdx.x] = a_g;
  __syncthreads();
  if (threadIdx.x < kC) {
    float ts = 0.0f, tg = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      ts += red[0][l * kC + c];
      tg += red[1][l * kC + c];
    }
    float* pp = partial + (((size_t)im * nsplit + s) * 2) * kC + c;
    pp[0] = ts;
    pp[kC] = tg;
  }
}

// (K2.2) one block per sample: s, h, gate recomputed; dg; the MLP backward.
// work rows per sample: [s (64) | dz2 (64) | h (64) | dz1 (64)].
__global__ void __launch_bounds__(kThreads)
ca_bwd_mlp_kernel(const float* __restrict__ partial, int npart,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ gate_out, float* __restrict__ ds_out,
                  float* __restrict__ work, int hidden, float inv_npix) {
  const int im = blockIdx.x, tid = threadIdx.x;
  __shared__ float sm[kC], dg[kC], hid[kMaxHidden], dz2[kC], dz1[kMaxHidden];
  float* wk = work + (size_t)im * 4 * kC;
  if (tid < kC) {
    float ts = 0.0f, tg = 0.0f;
    for (int s = 0; s < npart; ++s) {
      const float* pp = partial + (((size_t)im * npart + s) * 2) * kC + tid;
      ts += pp[0];
      tg += pp[kC];
    }
    sm[tid] = ts * inv_npix;
    dg[tid] = tg;
    wk[tid] = sm[tid];
  }
  __syncthreads();
  if (tid < hidden) {
    float t = 0.0f;
    for (int c = 0; c < kC; ++c) t = fmaf(sm[c], w1[tid * kC + c], t);
    hid[tid] = fmaxf(t + b1[tid], 0.0f);
    wk[2 * kC + tid] = hid[tid];
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(hid[k], w2[tid * hidden + k], t);
    const float gt = 1.0f / (1.0f + expf(-(t + b2[tid])));
    gate_out[(size_t)im * kC + tid] = gt;
    dz2[tid] = dg[tid] * gt * (1.0f - gt);
    wk[kC + tid] = dz2[tid];
  }
  __syncthreads();
  if (tid < hidden) {
    float t = 0.0f;
    for (int c = 0; c < kC; ++c) t = fmaf(dz2[c], w2[c * hidden + tid], t);
    dz1[tid] = hid[tid] > 0.0f ? t : 0.0f;
    wk[3 * kC + tid] = dz1[tid];
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(dz1[k], w1[k * kC + tid], t);
    ds_out[(size_t)im * kC + tid] = t * inv_npix;
  }
}

// (K2.3) weight gradients summed over samples in order: thread e = (k, c)
// gives dW1[k][c] and dW2[c][k]; e < hidden also db1, e < 64 also db2.
__global__ void __launch_bounds__(kThreads)
ca_bwd_wgrad_kernel(const float* __restrict__ work, int nimg, int hidden,
                    float* __restrict__ dw1, float* __restrict__ db1,
                    float* __restrict__ dw2, float* __restrict__ db2) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= hidden * kC) return;
  const int k = e / kC, c = e % kC;
  float a1 = 0.0f, a2 = 0.0f, ab1 = 0.0f, ab2 = 0.0f;
  for (int im = 0; im < nimg; ++im) {
    const float* wk = work + (size_t)im * 4 * kC;
    const float s = wk[c], d2 = wk[kC + c], h = wk[2 * kC + k], d1 = wk[3 * kC + k];
    a1 = fmaf(d1, s, a1);
    a2 = fmaf(d2, h, a2);
    ab1 += d1;
    ab2 += d2;
  }
  dw1[k * kC + c] = a1;
  dw2[c * hidden + k] = a2;
  if (c == 0) db1[k] = ab1;
  if (k == 0) db2[c] = ab2;
}

// ------------------------------------------------------------ launchers
template <typename T, typename G, int M>
int launch_conv_bwd(const void* g, const void* x, const void* y, const void* ut,
                    const float* gate, const float* ds, void* vbuf, void* dmbuf,
                    float* ddbuf, float* dbpart, float* dupart, void* out,
                    float* du, float* db, int nimg, int h, int w, int out_mode,
                    int ksplit, cudaStream_t stream) {
  constexpr int N2 = (M + 2) * (M + 2), TB = Bwd<T>::TB;
  const size_t smem = 2 * (size_t)N2 * Bwd<T>::kPerTap * sizeof(T);
  static bool done = false;
  cudaError_t e = allow_smem(wino_bwd_tile_kernel<T, G, M>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = nimg * (h / M) * (w / M);
  const int nblk = (ntiles + TB - 1) / TB;
  wino_bwd_tile_kernel<T, G, M><<<nblk, kThreads, smem, stream>>>(
      static_cast<const G*>(g), static_cast<const T*>(x), static_cast<const T*>(y),
      ut, gate, ds, static_cast<T*>(vbuf), static_cast<T*>(dmbuf), ddbuf, dbpart,
      nimg, h, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const long long nthr = (long long)nimg * h * w * (kC / 4);
  const int gblk = (int)((nthr + kThreads - 1) / kThreads);
  if (out_mode == 0)
    wino_dx_gather_kernel<T, M><<<gblk, kThreads, 0, stream>>>(
        ddbuf, static_cast<T*>(out), nimg, h, w, 0);
  else
    wino_dx_gather_kernel<float, M><<<gblk, kThreads, 0, stream>>>(
        ddbuf, static_cast<float*>(out), nimg, h, w, out_mode == 2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  wino_du_kernel<T><<<dim3(N2, ksplit), kThreads, 0, stream>>>(
      static_cast<const T*>(vbuf), static_cast<const T*>(dmbuf), dupart, ntiles, N2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(N2 * kC * kC + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dupart, du, N2, ksplit, kC * kC);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(dbpart, db, 1, nblk, kC);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int dispatch_m(int m, const void* g, const void* x, const void* y, const void* ut,
               const float* gate, const float* ds, void* vbuf, void* dmbuf,
               float* ddbuf, float* dbpart, float* dupart, void* out, float* du,
               float* db, int nimg, int h, int w, int out_mode, int ksplit,
               cudaStream_t s) {
  if (m == 4)
    return launch_conv_bwd<T, G, 4>(g, x, y, ut, gate, ds, vbuf, dmbuf, ddbuf, dbpart,
                                    dupart, out, du, db, nimg, h, w, out_mode, ksplit, s);
  return launch_conv_bwd<T, G, 2>(g, x, y, ut, gate, ds, vbuf, dmbuf, ddbuf, dbpart,
                                  dupart, out, du, db, nimg, h, w, out_mode, ksplit, s);
}

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" {

int sres_wino_bwd_tiles(int bf16_) { return bf16_ ? Bwd<bf16>::TB : Bwd<float>::TB; }

// g (nimg, h, w, 64) NHWC of float (g_f32 = 1) or of the activation type;
// x, y: activation type (bf16_ = 1: bf16, else float; y may be null);
// ut: U^T = (n*n, Cout, Cin), for bf16 in the mma fragment order of
// sres_wino_conv; gate, ds: (nimg, 64) f32 or null. Scratch: vbuf, dmbuf
// (ntiles, n*n, 64) activation type; ddbuf (ntiles, n*n, 64) f32; dbpart
// (ceil(ntiles / sres_wino_bwd_tiles), 64) f32; dupart (n*n, ksplit, 64, 64)
// f32. Out: `out` (nimg, h, w, 64) in the activation type (out_mode 0), f32
// written (1) or f32 added to (2); du (n*n, 64, 64) f32; db (64,) f32.
int sres_wino_conv_bwd(const void* g, const void* x, const void* y, const void* ut,
                       const float* gate, const float* ds, void* vbuf, void* dmbuf,
                       float* ddbuf, float* dbpart, float* dupart, void* out,
                       float* du, float* db, int nimg, int h, int w, int m,
                       int bf16_, int g_f32, int out_mode, int ksplit, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((m != 2 && m != 4) || h % m || w % m || ksplit < 1 || out_mode < 0 ||
      out_mode > 2 || (!bf16_ && !g_f32) || (out_mode == 0 && g_f32 && bf16_))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_)
    return dispatch_m<float, float>(m, g, x, y, ut, gate, ds, vbuf, dmbuf, ddbuf, dbpart,
                                    dupart, out, du, db, nimg, h, w, out_mode, ksplit, s);
  if (g_f32)
    return dispatch_m<bf16, float>(m, g, x, y, ut, gate, ds, vbuf, dmbuf, ddbuf, dbpart,
                                   dupart, out, du, db, nimg, h, w, out_mode, ksplit, s);
  return dispatch_m<bf16, bf16>(m, g, x, y, ut, gate, ds, vbuf, dmbuf, ddbuf, dbpart,
                                dupart, out, du, db, nimg, h, w, out_mode, ksplit, s);
}

// da (nimg, hw, 64) f32; c2 (nimg, hw, 64) of float or bf16; w1 (hidden, 64),
// b1 (hidden,), w2 (64, hidden), b2 (64,) f32. Scratch: partial (nimg, npart,
// 2, 64), work (nimg, 4, 64) f32. Out: gate, ds (nimg, 64); dw1 (hidden, 64),
// db1 (hidden,), dw2 (64, hidden), db2 (64,), all f32.
int sres_ca_skip_bwd(const float* da, const void* c2, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* partial, float* work,
                     float* gate, float* ds, float* dw1, float* db1, float* dw2,
                     float* db2, int nimg, int hw, int hidden, int npart, int bf16_,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || npart < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    ca_bwd_pool_kernel<bf16><<<dim3(npart, nimg), kThreads, 0, s>>>(
        da, static_cast<const bf16*>(c2), partial, hw);
  else
    ca_bwd_pool_kernel<float><<<dim3(npart, nimg), kThreads, 0, s>>>(
        da, static_cast<const float*>(c2), partial, hw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ca_bwd_mlp_kernel<<<nimg, kThreads, 0, s>>>(partial, npart, w1, b1, w2, b2, gate, ds,
                                             work, hidden, 1.0f / (float)hw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ca_bwd_wgrad_kernel<<<(hidden * kC + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      work, nimg, hidden, dw1, db1, dw2, db2);
  return (int)cudaGetLastError();
}

}  // extern "C"
