// The direct-conv residual group (model.fused) for Hopper.
//
// Replaces the TPU Pallas kernels
//   sres_tpu/ops/pallas/attic/residual_group.py:_fwd_kernel (via _fwd_call):
//       nb x RCAB + trailing conv of one group, every conv 9 accumulated
//       (M, C).(C, C) products on shifted rows (conv9, :91-97), writing the
//       stashes;
//   sres_tpu/ops/pallas/attic/residual_group.py:_bwd_kernel (via _bwd_call):
//       the group backward from the stashes: conv adjoints (convT :217-224),
//       weight gradients (wgrads :226-237), the channel-attention backward
//       (:285-313).
// The TPU kernel keeps a whole tile (act, apad, cpad, skip) resident in VMEM
// for a whole group and streams one RCAB's weights per grid step. A 48x48x64
// bf16 tile is 288 KiB, more than an SM's shared memory, and channel
// attention needs the mean of the whole conv2 output before its gate
// applies. So the group is split in two passes per RCAB around channel
// attention, composed by ops/fused_group.py:
//   (a) fg_conv: a direct 3x3 SAME conv, 64 -> 64, NHWC. bf16: an implicit
//       GEMM on wgmma (fg_conv_wgmma_kernel, 16 x 8-pixel tiles); f32: FMAs
//       on 8 x 16-pixel tiles. Prologue: x * gate + ds (the CA cotangent),
//       rounded to T, inside the image only. Epilogue: + bias, ReLU, zero
//       where mask <= 0, per-tile channel sums of that f32 value (no
//       atomics), (res + v) + res2, stored as T or f32. With flipped,
//       transposed weights it is the dgrad.
//   (b) fg_ca: per sample, the tile sums in a fixed order -> mean -> 1x1 ->
//       ReLU -> 1x1 -> sigmoid gate; x_next = T(x + c * gate), optionally the
//       T stash of c.
//   (c) fg_wgrad: dW[tap] = sum_pixels x_shift(tap)^T . g, db = sum g. bf16:
//       one launch (fg_wgrad_wgmma_kernel) whose thread-block clusters
//       reduce on chip, the last cluster summing the clusters' partials;
//       f32: blocks (tap row, pixel chunk) on FMAs, each writing an f32
//       partial that sum_partials_kernel adds in a fixed order. Either way
//       the gradients are the same bits every run.
//   (d) fg_ca_bwd: per (sample, chunk) partial sums of c and g * c; one
//       block per sample for the MLP backward (ds = dm / npix); the CA weight
//       gradients summed over samples in order.
//
// Rounding points (those of the TPU kernel, :105-133 and :260-336): weights
// and CA weights in T, biases f32; conv outputs are f32 until the stated
// rounding; the CA mean and hidden vector are rounded to T before their 1x1
// products; the gate is f32; x * gate + ds and x + c * gate are a product
// then a sum (no fused multiply-add), as in JAX.
//
// What bounds the bf16 conv and wgrad on this card: at 72x64x48x48 the conv
// reads 21 MB and writes 21 MB (12.7 us at 3.35 TB/s) and its products are
// 12.2 GFLOP (12.4 us at 989 TFLOP/s): it sits on the ridge, so it needs
// both the tensor-core rate and copies that overlap the products. Hence
// wgmma with both operands in shared memory in the non-swizzled core-matrix
// layout (a tap is a descriptor offset into the halo, no fragment loads),
// weights resident per block, a ring of halo stages filled by cp.async on
// mbarriers by a producer warp, and two consumer warpgroups in turn so one
// tile's epilogue (through shared memory, 16-byte accesses) overlaps the
// other's products. The wgrad's products are the same 12.2 GFLOP on 21 MB
// read; it reads each halo and cotangent tile once (one block holds all 9
// taps) and keeps its reduction on chip, in one launch.

#include <cooperative_groups.h>

#include "wino_common.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;              // output tile: 8 rows x 16 columns
constexpr int kHH = kTH + 2, kHW = kTW + 2;   // its 3x3 input halo
constexpr int kTaps = 9;
constexpr int kRowF = kC + 1;                 // f32 shared row: 65
constexpr int kWarps = kThreads / 32;

struct ConvArgs {
  const void* x;       // (nimg, h, w, 64) T
  const void* wt;      // (9, 64 out, 64 in) T
  const float* bias;   // (64,) or null
  const float* gate;   // (nimg, 64) or null: input prologue x * gate + ds
  const float* ds;
  const void* mask;    // like x, or null: output zeroed where mask <= 0
  const void* res;     // like x, or null
  const void* res2;    // like x, or null
  void* y;             // (nimg, h, w, 64) T or f32
  float* part;         // (nimg * tiles, 64) f32, or null
  int nimg, h, w, relu;
};

__host__ __device__ __forceinline__ int tiles_per_img(int h, int w) {
  return ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
}

// x * g + d of a bf16 pair, a product then a sum, each rounded to f32
__device__ __forceinline__ void affine2(uint32_t w, const float* g, const float* d,
                                        float& lo, float& hi) {
  lo = __fadd_rn(__fmul_rn(lo_bf(w), g[0]), d[0]);
  hi = __fadd_rn(__fmul_rn(hi_bf(w), g[1]), d[1]);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack_bf(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// the prologue on 8 channels: T(x * gate + ds)
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* g, const float* d) {
  float lo, hi;
  affine2(v.x, g, d, lo, hi);
  v.x = pack_f2(lo, hi);
  affine2(v.y, g + 2, d + 2, lo, hi);
  v.y = pack_f2(lo, hi);
  affine2(v.z, g + 4, d + 4, lo, hi);
  v.z = pack_f2(lo, hi);
  affine2(v.w, g + 6, d + 6, lo, hi);
  v.w = pack_f2(lo, hi);
  return v;
}

// Epilogue: bias, ReLU, mask -- the value the partial sums see
template <typename T>
__device__ __forceinline__ float epi_value(float v, const ConvArgs& a, int co, size_t off) {
  if (a.bias != nullptr) v += a.bias[co];
  if (a.relu) v = fmaxf(v, 0.0f);
  if (a.mask != nullptr && !(to_f(static_cast<const T*>(a.mask)[off]) > 0.0f)) v = 0.0f;
  return v;
}

// Epilogue: (res + v) + res2
template <typename T>
__device__ __forceinline__ float epi_sum(float v, const ConvArgs& a, size_t off) {
  if (a.res != nullptr) v = to_f(static_cast<const T*>(a.res)[off]) + v;
  if (a.res2 != nullptr) v = v + to_f(static_cast<const T*>(a.res2)[off]);
  return v;
}

// ------------------------------------------------ Hopper building blocks
// The bf16 kernels work on 16 x 8-pixel tiles (an 18 x 10 halo): 8 output
// pixels of a tile row are one core-matrix row group of wgmma, so a tap's
// shift is a start-address offset and tile rows sit a fixed stride apart.
constexpr int kPH = 16, kPW = 8;                   // bf16 tile: 16 rows x 8 columns
constexpr int kPHH = kPH + 2, kPHW = kPW + 2;      // its halo
constexpr int kPix = kPH * kPW, kHalo = kPHH * kPHW;
// Shared operands in wgmma's non-swizzled core-matrix layout: [8-channel
// chunk][pixel][8 channels], 16 bytes a pixel; a chunk's stride is padded by
// 16 bytes so the eight chunks of one pixel land on distinct banks.
constexpr uint32_t kXChunk = kHalo * 16 + 16;      // halo chunk stride (2896)
constexpr uint32_t kXStage = 8 * kXChunk;          // one halo
constexpr uint32_t kGChunk = kPix * 16 + 16;       // cotangent-tile chunk stride (2064)
constexpr uint32_t kGStage = 8 * kGChunk;
constexpr uint32_t kWBytes = kTaps * kC * kC * 2;  // the 9 taps' bf16 weights

__host__ __device__ __forceinline__ int bf_tiles_per_img(int h, int w) {
  return ((h + kPH - 1) / kPH) * ((w + kPW - 1) / kPW);
}

struct BTile {
  int im, y0, x0;
};
__device__ __forceinline__ BTile btile(int tile, int h, int w) {
  const int ntx = (w + kPW - 1) / kPW, per = bf_tiles_per_img(h, w);
  const int im = tile / per, tr = tile - im * per;
  return {im, (tr / ntx) * kPH, (tr % ntx) * kPW};
}

// D(64 x 128, f32) += A(64 x 16) . B(16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_kk(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16) . B(16 x 64), both MN-major (transposed) in
// shared memory
__device__ __forceinline__ void wgmma_m64n64_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// A 16-byte copy, or 16 zero bytes when !valid (src is not read then).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// The producer warpgroup copies a tile's 18 x 10 halo of x into `dst`
// ([chunk][pixel][8]), zeros outside the image (SAME padding): thread pt
// takes channels 8 (pt % 8) .. + 7 of halo pixels pt / 8 + 16 j.
constexpr int kHaloJ = (kHalo + 15) / 16;
__device__ __forceinline__ void load_halo(uint32_t dst, const bf16* __restrict__ x, BTile t,
                                          int h, int w, int pt) {
  const int c = pt & 7, p0 = pt >> 3;
  const bf16* xi = x + (size_t)t.im * h * w * kC + 8 * c;
#pragma unroll
  for (int j = 0; j < kHaloJ; ++j) {
    const int pos = p0 + 16 * j;
    if (pos < kHalo) {
      const int r = pos / kPHW, yy = t.y0 - 1 + r, xx = t.x0 - 1 + pos - r * kPHW;
      const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
      cp_async16_zfill(dst + c * kXChunk + pos * 16, xi + (in ? ((size_t)yy * w + xx) * kC : 0),
                       in);
    }
  }
}

// 8 floats rounded to bf16 in a uint4, and back
__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack_f2(f[0], f[1]), pack_f2(f[2], f[3]), pack_f2(f[4], f[5]),
                    pack_f2(f[6], f[7]));
}
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = lo_bf(wd[j]);
    f[2 * j + 1] = hi_bf(wd[j]);
  }
}

// ---------------------------------------------------- (a) conv, bf16
// An implicit GEMM per 16 x 8 tile: D[co][pixel] (64 x 128) = sum over 9
// taps and 4 k-steps of W_tap[co][16 ci] . halo_shift(tap)[16 ci][pixel], on
// wgmma m64n128k16 with both operands in shared memory: the 9 taps'
// weights ([tap][chunk][co][8], 72 KB) resident for the block's life, the
// halo in a ring of kConvStages stages. Warps 0-7 are two consumer
// warpgroups taking the block's tiles in turn (one's epilogue overlaps the
// other's products); warps 8-11, the producer warpgroup, fill the ring with
// cp.async (zero-filled outside the image), each stage completing on an
// mbarrier. With the prologue T(x * gate + ds) the producer loads through
// registers instead, a tile ahead in two alternating buffers, and stores
// T(x * gate + ds) for in-image pixels (zeros outside) before it signals
// the stage.
// Epilogue, branch-free (an absent bias, mask or residual is a neutral
// value): bias and ReLU on the accumulators, staged as f32 [pixel][co];
// then per (pixel, 8 channels) the mask and res (prefetched while the
// products run: with the prologue the mask, otherwise res), res2 (without
// the prologue loaded once the accumulators are staged), the tile's
// channel sums, (res + v) + res2, and 16-byte stores.
constexpr int kConvWG = 2;
constexpr int kConvThreads = 128 * (kConvWG + 1);
constexpr int kConvStages = 3;
constexpr int kStgRow = kC + 4;                    // staging row: conflict-free scatter
constexpr uint32_t kStgBytes = kPix * kStgRow * 4;
constexpr uint32_t kCX = kWBytes;                  // halo ring
constexpr uint32_t kCS = kCX + kConvStages * kXStage;   // staging, one per warpgroup
constexpr uint32_t kCR = kCS + kConvWG * kStgBytes;     // [warpgroup][warp][64] sums
constexpr uint32_t kCB = kCR + kConvWG * 4 * kC * 4;    // mbarriers: full, empty
constexpr uint32_t kConvSmem = kCB + 2 * kConvStages * 8;
// Registers a thread, after the split: the producer warpgroup gives back
// what the consumers take (12 warps start at 168, 128 * P + 256 * C must
// stay within 65536); the prologue's producer holds two tiles' items.
constexpr int kConvProducerRegs = 56, kConvConsumerRegs = 224;
constexpr int kConvProducerRegsGate = 136, kConvConsumerRegsGate = 184;
static_assert(128 * kConvProducerRegs + 256 * kConvConsumerRegs <= 65536 &&
                  128 * kConvProducerRegsGate + 256 * kConvConsumerRegsGate <= 65536,
              "register budget of one block");

// The prologue path of the producer: thread pt's halo items (those of
// load_halo) through registers, T(x * gate + ds) inside the image, and
// zeros outside (the zero padding does not become ds).
__device__ __forceinline__ void halo_ld(uint4 (&v)[kHaloJ], const bf16* __restrict__ x, BTile t,
                                        int h, int w, int pt) {
  const int c = pt & 7, p0 = pt >> 3;
  const bf16* xi = x + (size_t)t.im * h * w * kC + 8 * c;
#pragma unroll
  for (int j = 0; j < kHaloJ; ++j) {
    const int pos = p0 + 16 * j, r = pos / kPHW, yy = t.y0 - 1 + r, xx = t.x0 - 1 + pos - r * kPHW;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (pos < kHalo && yy >= 0 && yy < h && xx >= 0 && xx < w)
      v[j] = __ldg(reinterpret_cast<const uint4*>(xi + ((size_t)yy * w + xx) * kC));
  }
}
// gate and ds of the thread's 8 channels for image `im`
struct Affine8 {
  float g[8], d[8];
};
__device__ __forceinline__ void affine_ld(Affine8& f, const float* __restrict__ gate,
                                          const float* __restrict__ ds, int im, int pt) {
  const int o = im * kC + 8 * (pt & 7);
  load4(gate + o, f.g);
  load4(gate + o + 4, f.g + 4);
  load4(ds + o, f.d);
  load4(ds + o + 4, f.d + 4);
}
__device__ __forceinline__ void halo_st_prologue(unsigned char* st, const uint4 (&v)[kHaloJ],
                                                 const float* __restrict__ gate,
                                                 const float* __restrict__ ds, BTile t, int h,
                                                 int w, int pt) {
  const int c = pt & 7, p0 = pt >> 3;
  Affine8 f;
  affine_ld(f, gate, ds, t.im, pt);
#pragma unroll
  for (int j = 0; j < kHaloJ; ++j) {
    const int pos = p0 + 16 * j, r = pos / kPHW, yy = t.y0 - 1 + r, xx = t.x0 - 1 + pos - r * kPHW;
    if (pos < kHalo)
      *reinterpret_cast<uint4*>(st + c * kXChunk + pos * 16) =
          yy >= 0 && yy < h && xx >= 0 && xx < w ? prologue8(v[j], f.g, f.d) : v[j];
  }
}

template <bool kOutF32, bool kRelu, bool kGate>
__global__ void __launch_bounds__(kConvThreads, 1)
fg_conv_wgmma_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem), full0 = sb + kCB, empty0 = full0 + 8 * kConvStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(full0 + 8 * s, 128);           // the producer threads
      mbar_init(empty0 + 8 * s, 4);            // the consuming warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const uint4* wsrc = static_cast<const uint4*>(a.wt);
  for (int i = tid; i < kTaps * kC * 8; i += kConvThreads)
    *reinterpret_cast<uint4*>(smem + (i >> 9) * 8192 + (i & 7) * 1024 + ((i >> 3) & 63) * 16) =
        __ldg(wsrc + i);
  fence_proxy_async();
  __syncthreads();

  const int ntiles = a.nimg * bf_tiles_per_img(a.h, a.w);
  if (warp >= 4 * kConvWG) {                   // the producer warpgroup
    setmaxnreg_dec<kGate ? kConvProducerRegsGate : kConvProducerRegs>();
    const int pt = tid - 128 * kConvWG;
    const bf16* x = static_cast<const bf16*>(a.x);
    if constexpr (!kGate) {                    // cp.async, completing on the stage's mbarrier
      int k = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
        const int s = k % kConvStages;
        if (k >= kConvStages) mbar_wait(empty0 + 8 * s, (k / kConvStages - 1) & 1);
        load_halo(sb + kCX + s * kXStage, x, btile(tile, a.h, a.w), a.h, a.w, pt);
        cp_async_arrive(full0 + 8 * s);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {                                   // through registers, a tile ahead
      uint4 ba[kHaloJ], bb[kHaloJ];
      // store `cur` (tile `tile`, the k-th of this block) after loading the
      // block's next tile into `nxt`, so the loads fly while it waits
      auto step = [&](uint4 (&cur)[kHaloJ], uint4 (&nxt)[kHaloJ], int tile, int k) {
        const int s = k % kConvStages;
        if (tile + (int)gridDim.x < ntiles)
          halo_ld(nxt, x, btile(tile + gridDim.x, a.h, a.w), a.h, a.w, pt);
        if (k >= kConvStages) mbar_wait(empty0 + 8 * s, (k / kConvStages - 1) & 1);
        halo_st_prologue(smem + kCX + s * kXStage, cur, a.gate, a.ds, btile(tile, a.h, a.w),
                         a.h, a.w, pt);
        fence_proxy_async();
        mbar_arrive(full0 + 8 * s);
      };
      if (blockIdx.x < ntiles) halo_ld(ba, x, btile(blockIdx.x, a.h, a.w), a.h, a.w, pt);
      for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += 2 * gridDim.x, k += 2) {
        step(ba, bb, tile, k);
        if (tile + (int)gridDim.x < ntiles) step(bb, ba, tile + gridDim.x, k + 1);
      }
    }
    return;
  }

  setmaxnreg_inc<kGate ? kConvConsumerRegsGate : kConvConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3, ct = tid & 127, g8 = lane >> 2, q4 = lane & 3;
  float* stg = reinterpret_cast<float*>(smem + kCS + wg * kStgBytes);
  float* red = reinterpret_cast<float*>(smem + kCR) + wg * 4 * kC;
  const bf16* mask = static_cast<const bf16*>(a.mask);
  const bf16* res = static_cast<const bf16*>(a.res);
  const bf16* res2 = static_cast<const bf16*>(a.res2);
  // this thread's accumulator rows: output channels 16 wq + g8 (+ 8)
  const float b0 = a.bias != nullptr ? a.bias[16 * wq + g8] : 0.0f;
  const float b1 = a.bias != nullptr ? a.bias[16 * wq + g8 + 8] : 0.0f;
  // epilogue items: pixel 16 it + pe0 of the tile, channels 8 ce .. + 7
  const int ce = ((lane >> 3) & 1) * 4 + (lane & 3);
  const int pe0 = 4 * wq + 2 * (lane >> 4) + ((lane >> 2) & 1);
  const uint64_t wdesc = gmma_desc(sb, 1024, 128);
  for (int k = wg, tile = blockIdx.x + wg * gridDim.x; tile < ntiles;
       k += kConvWG, tile += kConvWG * gridDim.x) {
    const int s = k % kConvStages;
    const BTile t = btile(tile, a.h, a.w);
    const uint32_t stage = sb + kCX + s * kXStage;
    mbar_wait(full0 + 8 * s, (k / kConvStages) & 1);
    fence_proxy_async();                       // the cp.async writes, for wgmma

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    wgmma_fence();
    const uint64_t xdesc = gmma_desc(stage, kXChunk, kPHW * 16);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const uint32_t shift = ((tap / 3) * kPHW + tap % 3) * 16;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wgmma_m64n128_kk(acc, wdesc + ((tap * 8192 + q * 2048) >> 4),
                         xdesc + ((2 * q * kXChunk + shift) >> 4));
    }
    wgmma_commit();

    // while the products run: with the prologue (conv2's dgrad) the mask,
    // raw (1 without one), else res and the mask as bits (all set without one)
    uint4 pv[8];
    uint32_t mbits[2] = {~0u, ~0u};
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int px = 16 * it + pe0, oy = t.y0 + (px >> 3), ox = t.x0 + (px & 7);
      const bool in = oy < a.h && ox < a.w;
      const size_t off = (((size_t)t.im * a.h + oy) * a.w + ox) * kC + 8 * ce;
      if constexpr (kGate) {
        pv[it] = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);   // bf16 1.0
        if (in && mask != nullptr) pv[it] = __ldg(reinterpret_cast<const uint4*>(mask + off));
      } else {
        pv[it] = make_uint4(0u, 0u, 0u, 0u);
        if (in && res != nullptr) pv[it] = __ldg(reinterpret_cast<const uint4*>(res + off));
        if (in && mask != nullptr) {
          float m[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(mask + off)), m);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!(m[j] > 0.0f)) mbits[it >> 2] &= ~(1u << (8 * (it & 3) + j));
        }
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the products have read the stage

    // bias, ReLU; staged as [pixel][co]. acc[4 jn + 2 i + e] is channel
    // 16 wq + g8 + 8 i of pixel 8 jn + 2 q4 + e.
    named_bar(1 + wg, 128);                    // the last tile's epilogue is done with stg, red
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[4 * jn + 2 * i + e] + (i ? b1 : b0);
          if constexpr (kRelu) v = fmaxf(v, 0.0f);
          stg[(8 * jn + 2 * q4 + e) * kStgRow + 16 * wq + g8 + 8 * i] = v;
        }
    // without the prologue, res2 all at once: the accumulators are dead (the
    // empty asm keeps the compiler from hoisting these loads into their
    // live range); with it (never beside res2 on the main path), per pixel
    asm volatile("" ::: "memory");
    uint4 r2v[8];
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int px = 16 * it + pe0, oy = t.y0 + (px >> 3), ox = t.x0 + (px & 7);
      r2v[it] = make_uint4(0u, 0u, 0u, 0u);
      if (!kGate && res2 != nullptr && oy < a.h && ox < a.w)
        r2v[it] = __ldg(reinterpret_cast<const uint4*>(
            res2 + (((size_t)t.im * a.h + oy) * a.w + ox) * kC + 8 * ce));
    }
    named_bar(1 + wg, 128);

    float psum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) psum[j] = 0.0f;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int px = 16 * it + pe0, oy = t.y0 + (px >> 3), ox = t.x0 + (px & 7);
      if (oy >= a.h || ox >= a.w) continue;
      const size_t off = (((size_t)t.im * a.h + oy) * a.w + ox) * kC + 8 * ce;
      float v[8], r[8], r2[8];
      const float4 lo = *reinterpret_cast<const float4*>(stg + px * kStgRow + 8 * ce);
      const float4 hi = *reinterpret_cast<const float4*>(stg + px * kStgRow + 8 * ce + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kGate) {
        unpack8(pv[it], r);                    // the mask
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = r[j] > 0.0f ? v[j] : 0.0f;
        unpack8(res != nullptr ? __ldg(reinterpret_cast<const uint4*>(res + off)) : z4, r);
        unpack8(res2 != nullptr ? __ldg(reinterpret_cast<const uint4*>(res2 + off)) : z4, r2);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (mbits[it >> 2] >> (8 * (it & 3) + j)) & 1u ? v[j] : 0.0f;
        unpack8(pv[it], r);
        unpack8(r2v[it], r2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        psum[j] += v[j];
        v[j] = (r[j] + v[j]) + r2[j];
      }
      if constexpr (kOutF32) {
        float* y = static_cast<float*>(a.y) + off;
        store4(y, v);
        store4(y + 4, v + 4);
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.y) + off) = pack8(v);
      }
    }
    if (a.part != nullptr) {
      // lanes l, l ^ 4, l ^ 16, l ^ 20 hold the same channels
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = psum[j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if ((lane & 0x14) == 0) red[wq * kC + 8 * ce + j] = v;
      }
      named_bar(1 + wg, 128);
      if (ct < kC)
        a.part[(size_t)tile * kC + ct] =
            ((red[ct] + red[kC + ct]) + red[2 * kC + ct]) + red[3 * kC + ct];
    }
  }
}

// ----------------------------------------------------- (a) conv, f32
// Shared: weights transposed to [9][64 in][64 out] and the halo
// [kHH][kHW][kRowF]. Thread (pixel group pg, channel quad cq): output row
// pg / 2, columns 8 * (pg % 2) .. + 7, channels 4 * cq .. + 3.
__global__ void __launch_bounds__(kThreads)
fg_conv_f32_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);
  float* hs = ws + kTaps * kC * kC;
  __shared__ float red[kWarps][kC];
  const int tid = threadIdx.x;
  const float* x = static_cast<const float*>(a.x);
  const float* wsrc = static_cast<const float*>(a.wt);
  for (int i = tid; i < kTaps * kC * kC; i += kThreads) {
    const int t = i / (kC * kC), o = (i / kC) % kC, ci = i % kC;
    ws[(t * kC + ci) * kC + o] = wsrc[i];
  }

  const int ntx = (a.w + kTW - 1) / kTW, per_img = tiles_per_img(a.h, a.w);
  const int ntiles = a.nimg * per_img;
  const int cq = tid & 15, pg = tid >> 4, r = pg >> 1, cb = (pg & 1) * 8, co0 = 4 * cq;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();
    for (int i = tid; i < kHH * kHW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;
      const int yy = y0 + pos / kHW - 1, xx = x0 + pos % kHW - 1;
      float v = 0.0f;
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
        v = x[(((size_t)im * a.h + yy) * a.w + xx) * kC + c];
        if (a.gate != nullptr)
          v = __fadd_rn(__fmul_rn(v, a.gate[im * kC + c]), a.ds[im * kC + c]);
      }
      hs[pos * kRowF + c] = v;
    }
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
    for (int t = 0; t < kTaps; ++t) {
      const int ky = t / 3, kx = t % 3;
      const float* hp = hs + ((r + ky) * kHW + cb + kx) * kRowF;
      const float* wp = ws + t * kC * kC + co0;
#pragma unroll 4
      for (int ci = 0; ci < kC; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(wp + ci * kC);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = hp[j * kRowF + ci];
          acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
        }
      }
    }

    const int oy = y0 + r;
    float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = x0 + cb + j;
      if (oy >= a.h || ox >= a.w) continue;
      const size_t off = (((size_t)im * a.h + oy) * a.w + ox) * kC + co0;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = epi_value<float>(acc[j][q], a, co0 + q, off + q);
        psum[q] += v;
        o[q] = epi_sum<float>(v, a, off + q);
      }
      store4(static_cast<float*>(a.y) + off, o);
    }
    if (a.part != nullptr) {
      // lanes l and l + 16 of a warp hold the two column halves of one row
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = psum[q] + __shfl_xor_sync(0xffffffffu, psum[q], 16);
        if (lane < 16) red[warp][co0 + q] = s;
      }
      __syncthreads();
      if (tid < kC) {
        float s = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
        a.part[(size_t)tile * kC + tid] = s;
      }
    }
  }
}

// ------------------------------------------- (b) gate + skip, per RCAB
// gate = sigmoid(W2 T(relu(W1 T(mean) + b1)) + b2) from the conv's per-tile
// sums; out = T(x + c * gate). Every block recomputes its sample's gate.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_kernel(const T* __restrict__ x, const float* __restrict__ c,
             const float* __restrict__ part, int npart,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ w2, const float* __restrict__ b2,
             T* __restrict__ xn, float* __restrict__ gate_out, T* __restrict__ cst,
             int hw, int hidden) {
  const int im = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x, tid = threadIdx.x;
  __shared__ float mean[kC], hid[kMaxHidden], gate[kC];
  if (tid < kC) {
    float t = 0.0f;
    for (int p = 0; p < npart; ++p) t += part[((size_t)im * npart + p) * kC + tid];
    mean[tid] = rnd<T>(t / (float)hw);
  }
  __syncthreads();
  if (tid < hidden) {
    float t = 0.0f;
    for (int k = 0; k < kC; ++k) t = fmaf(mean[k], w1[tid * kC + k], t);
    hid[tid] = rnd<T>(fmaxf(t + b1[tid], 0.0f));
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(hid[k], w2[tid * hidden + k], t);
    const float g = 1.0f / (1.0f + expf(-(t + b2[tid])));
    gate[tid] = g;
    if (chunk == 0) gate_out[(size_t)im * kC + tid] = g;
  }
  __syncthreads();
  const long long per = (long long)hw * kC;
  const long long e0 = per * chunk / nchunk, e1 = per * (chunk + 1) / nchunk;
  const size_t base = (size_t)im * per;
  for (long long e = e0 + tid; e < e1; e += kThreads) {
    const float cv = c[base + e];
    xn[base + e] = from_f<T>(__fadd_rn(to_f(x[base + e]), __fmul_rn(cv, gate[e % kC])));
    if (cst != nullptr) cst[base + e] = from_f<T>(cv);
  }
}

// ------------------------------------------ (c) weight gradient, bf16
// dW[tap][ci][co] = sum over pixels of x_shift(tap)[ci][pixel] . T(g')[pixel][co]
// in one launch. Each block walks a fixed range of 16 x 8 tiles; warps 0-11
// are three consumer warpgroups, warpgroup ky holding the three taps (ky,
// kx) as 64 x 64 f32 accumulators (96 registers a thread) over the whole
// range, on wgmma m64n64k16 with both operands transposed from shared
// memory: the tile's halo ([chunk][pixel][8 ci]; a tap is a start offset)
// and the cotangent tile ([chunk][pixel][8 co]); one k-step is two tile
// rows, and a tile's products overlap the wait for the next. Warps 12-15,
// the producer warpgroup, keep a ring of kWgStages (halo, cotangent) stages
// filled with cp.async, completing on mbarriers, so each x halo and g tile
// is read once; one tile behind its copies, each producer thread applies
// the prologue g' = g * gate + ds to its cotangent pixels in shared memory
// (in-image only) and sums db from the same f32 values. Reduction, all on
// chip and in
// fixed order: each block's dW and db go to its shared memory; the blocks
// of a kCluster-block cluster sum them rank by rank through distributed
// shared memory into the cluster's partial in device memory; an integer
// ticket elects the last cluster to finish, which sums the clusters'
// partials in index order into dw and db. With db_part, each block's db
// partial is the sum of a fixed slice of its rows. No float atomics: the
// same bits every run.
constexpr int kWgWG = 3;
constexpr int kWgThreads = 128 * (kWgWG + 1);
constexpr int kWgStages = 4;
constexpr int kCluster = 8;
constexpr uint32_t kWgStage = kXStage + kGStage;
constexpr int kWgPart = kTaps * kC * kC;           // floats of a dW partial
constexpr int kWgE = kWgPart + kC;                 // with db
constexpr uint32_t kWgBar = kWgStages * kWgStage;  // mbarriers after the ring
constexpr uint32_t kWgSmem = kWgBar + 2 * kWgStages * 8 + 16;
static_assert((kWgE + 4 * kC) * 4 <= (int)kWgBar,
              "a block's dW, db and per-warp db sums reuse the ring");

// A block's dW partial in shared memory, [tap][ci][co] with co's 8-column
// groups XOR-swizzled by ci, so the accumulator scatter is conflict-free.
__device__ __forceinline__ int part_idx(int tap, int ci, int co) {
  return tap * kC * kC + ci * kC + (co ^ ((ci & 7) << 3));
}

__device__ unsigned int g_wgrad_ticket = 0;   // clusters done in this launch

// The producer warpgroup copies a tile's cotangent into `dst`
// ([chunk][pixel][8]), zeros outside the image: thread pt takes channels
// 8 (pt % 8) .. + 7 of pixels pt / 8 + 16 j.
constexpr int kGJ = kPix / 16;
__device__ __forceinline__ void load_gtile(uint32_t dst, const bf16* __restrict__ g, BTile t,
                                           int h, int w, int pt) {
  const int c = pt & 7, p0 = pt >> 3;
  const bf16* gi = g + (size_t)t.im * h * w * kC + 8 * c;
#pragma unroll
  for (int j = 0; j < kGJ; ++j) {
    const int px = p0 + 16 * j, yy = t.y0 + (px >> 3), xx = t.x0 + (px & 7);
    const bool in = yy < h && xx < w;
    cp_async16_zfill(dst + c * kGChunk + px * 16, gi + (in ? ((size_t)yy * w + xx) * kC : 0), in);
  }
}

// The producer thread pt's cotangent pixels of a landed stage: g' = g * gate
// + ds (f32, a product then a sum) rounded to T in place, and db summed
// from the same f32 values, inside the image only.
__device__ __forceinline__ void gtile_prologue(unsigned char* st, const float* __restrict__ gate,
                                               const float* __restrict__ ds, bool own_db, BTile t,
                                               int h, int w, int pt, float (&dbacc)[8]) {
  const int c = pt & 7, p0 = pt >> 3;
  Affine8 f;
  if (gate != nullptr) affine_ld(f, gate, ds, t.im, pt);
#pragma unroll
  for (int j = 0; j < kGJ; ++j) {
    const int px = p0 + 16 * j;
    if (t.y0 + (px >> 3) >= h || t.x0 + (px & 7) >= w) continue;
    uint4* p = reinterpret_cast<uint4*>(st + c * kGChunk + px * 16);
    float v[8];
    unpack8(*p, v);
    if (gate != nullptr) {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __fadd_rn(__fmul_rn(v[q], f.g[q]), f.d[q]);
      *p = pack8(v);
    }
    if (own_db) {
#pragma unroll
      for (int q = 0; q < 8; ++q) dbacc[q] += v[q];
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
fg_wgrad_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      const float* __restrict__ gate, const float* __restrict__ ds,
                      const float* __restrict__ db_part, int ndb_part, float* cpart,
                      float* __restrict__ dw, float* __restrict__ db, int nimg, int h, int w) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem), full0 = sb + kWgBar, empty0 = full0 + 8 * kWgStages;
  int* flag = reinterpret_cast<int*>(smem + kWgBar + 16 * kWgStages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster.block_rank(), ncl = gridDim.x / kCluster;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 128);           // the producer threads
      mbar_init(empty0 + 8 * s, 4 * kWgWG);    // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntiles = nimg * bf_tiles_per_img(h, w);
  const int t0 = (int)((long long)ntiles * blockIdx.x / gridDim.x);
  const int t1 = (int)((long long)ntiles * (blockIdx.x + 1) / gridDim.x);
  const bool own_db = db_part == nullptr, pass = gate != nullptr || own_db;
  float acc[3][32];
  float dbacc[8];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[kx][i] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) dbacc[j] = 0.0f;
  const int ky = warp >> 2, wq = warp & 3, g8 = lane >> 2, q4 = lane & 3;

  if (warp >= 4 * kWgWG) {                     // the producer warpgroup
    const int pt = tid - 128 * kWgWG;
    // tile kk of the range, one behind the copies: its prologue and db
    auto finish = [&](int kk) {
      const int sp = kk % kWgStages;
      gtile_prologue(smem + sp * kWgStage + kXStage, gate, ds, own_db, btile(t0 + kk, h, w), h,
                     w, pt, dbacc);
      fence_proxy_async();
      mbar_arrive(full0 + 8 * sp);
    };
    int k = 0;
    for (int tile = t0; tile < t1; ++tile, ++k) {
      const int s = k % kWgStages;
      if (k >= kWgStages) mbar_wait(empty0 + 8 * s, (k / kWgStages - 1) & 1);
      const BTile t = btile(tile, h, w);
      load_halo(sb + s * kWgStage, x, t, h, w, pt);
      load_gtile(sb + s * kWgStage + kXStage, g, t, h, w, pt);
      if (!pass) {
        cp_async_arrive(full0 + 8 * s);
        continue;
      }
      cp_async_commit();
      if (k >= 1) {
        cp_async_wait<1>();
        finish(k - 1);
      }
    }
    if (pass && k >= 1) {
      cp_async_wait<0>();
      finish(k - 1);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int tile = t0, k = 0; tile < t1; ++tile, ++k) {
      const int s = k % kWgStages;
      mbar_wait(full0 + 8 * s, (k / kWgStages) & 1);
      fence_proxy_async();                     // the cp.async writes, for wgmma
      wgmma_fence();
      const uint32_t st = sb + s * kWgStage;
      const uint64_t gdesc = gmma_desc(st + kXStage, kPW * 16, kGChunk);
      const uint64_t xdesc = gmma_desc(st + ky * kPHW * 16, kPHW * 16, kXChunk);
#pragma unroll
      for (int r2 = 0; r2 < kPH / 2; ++r2)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          wgmma_m64n64_tt(acc[kx], xdesc + ((2 * r2 * kPHW + kx) * 16 >> 4),
                          gdesc + ((2 * r2 * kPW) * 16 >> 4));
      wgmma_commit();
      if (k > 0) {                             // the previous tile's products are done
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % kWgStages));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) reg_fence(acc[kx]);
  }
  __syncthreads();                             // the ring is free

  // the block's dW and db into shared memory
  float* part = reinterpret_cast<float*>(smem);
  float* dbw = part + kWgE;                    // [producer warp][64]
  if (warp < 4 * kWgWG) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(part + part_idx(3 * ky + kx, 16 * wq + g8 + 8 * i,
                                                     8 * jn + 2 * q4)) =
              make_float2(acc[kx][4 * jn + 2 * i], acc[kx][4 * jn + 2 * i + 1]);
  } else {
    // lanes l, l ^ 8, l ^ 16, l ^ 24 sum the same channels
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = dbacc[j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) dbw[(warp - 4 * kWgWG) * kC + 8 * lane + j] = v;
    }
  }
  __syncthreads();
  if (tid < kC) {
    float v = 0.0f;
    if (own_db) {
      v = ((dbw[tid] + dbw[kC + tid]) + dbw[2 * kC + tid]) + dbw[3 * kC + tid];
    } else {                                   // this block's fixed slice of db_part's rows
      const int r0 = (int)((long long)ndb_part * blockIdx.x / gridDim.x);
      const int r1 = (int)((long long)ndb_part * (blockIdx.x + 1) / gridDim.x);
      for (int r = r0; r < r1; ++r) v += db_part[(size_t)r * kC + tid];
    }
    part[kWgPart + tid] = v;
  }
  cluster.sync();                              // every block's partial is in place

  // rank r sums its slice over the cluster's blocks in rank order
  constexpr int kSlice = kWgPart / 4 / kCluster;   // float4s of dW a rank sums
  float* cp = cpart + (size_t)(blockIdx.x / kCluster) * kWgE;
  for (int i = tid; i < kSlice + (rank == 0 ? kC / 4 : 0); i += kWgThreads) {
    const int e = i < kSlice ? 4 * (rank * kSlice + i) : kWgPart + 4 * (i - kSlice);
    float4 u[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      u[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part + e, q));
    float4 v = u[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) {
      v.x += u[q].x; v.y += u[q].y; v.z += u[q].z; v.w += u[q].w;
    }
    *reinterpret_cast<float4*>(cp + e) = v;
  }
  __threadfence();
  cluster.sync();                              // the cluster's partial is out
  if (rank == 0 && tid == 0) {
    const int last = atomicAdd(&g_wgrad_ticket, 1u) == (unsigned)(ncl - 1);
    if (last) g_wgrad_ticket = 0;              // for the next launch
    for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(flag, q) = last;
  }
  cluster.sync();
  if (!*flag) return;

  // the last cluster: every cluster's partial, in index order
  __threadfence();
  for (int i = tid; i < kSlice; i += kWgThreads) {
    const int e = 4 * (rank * kSlice + i);
    float4 v = __ldcg(reinterpret_cast<const float4*>(cpart + e));
    for (int q0 = 1; q0 < ncl; q0 += 8) {     // eight loads in flight, summed in order
      float4 u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < ncl) u[q] = __ldcg(reinterpret_cast<const float4*>(cpart + (size_t)(q0 + q) * kWgE + e));
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < ncl) {
          v.x += u[q].x; v.y += u[q].y; v.z += u[q].z; v.w += u[q].w;
        }
    }
    const int tap = e / (kC * kC), ci = (e / kC) % kC, co = (e % kC) ^ ((ci & 7) << 3);
    *reinterpret_cast<float4*>(dw + tap * kC * kC + ci * kC + co) = v;
  }
  if (rank == 0 && tid < kC) {
    float v = 0.0f;
    for (int q = 0; q < ncl; ++q) v += __ldcg(cpart + (size_t)q * kWgE + kWgPart + tid);
    db[tid] = v;
  }
}

// ------------------------------------------- (c) weight gradient, f32
// The bf16 kernel's blocks on FMAs; shared rows of kRowF floats. Thread
// (ci = tid / 4, co = 16 * (tid % 4) .. + 15) x the 3 taps kx; thread tid
// sums db over channel tid % 64 of the pixels it loads.
__global__ void __launch_bounds__(kThreads)
fg_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ gate, const float* __restrict__ ds,
                    float* __restrict__ wpart, float* __restrict__ dbpart, int own_db,
                    int nimg, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [kTH][kHW][kRowF]
  float* gs = xs + kTH * kHW * kRowF;                  // [kTH][kTW][kRowF]
  __shared__ float dbs[kThreads];
  const int ky = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y, tid = threadIdx.x;
  const int ntx = (w + kTW - 1) / kTW, per_img = tiles_per_img(h, w);
  const int ntiles = nimg * per_img;
  const int t0 = (int)((long long)ntiles * s / nsplit);
  const int t1 = (int)((long long)ntiles * (s + 1) / nsplit);
  const int ci = tid >> 2, cg = 16 * (tid & 3);
  const bool sum_db = own_db && ky == 0;
  float acc[3][16];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[kx][k] = 0.0f;
  float dbacc = 0.0f;

  for (int tile = t0; tile < t1; ++tile) {
    const int im = tile / per_img, tr = tile - im * per_img;
    const int y0 = (tr / ntx) * kTH, x0 = (tr % ntx) * kTW;
    __syncthreads();
    for (int i = tid; i < kTH * kHW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;
      const int yy = y0 + ky - 1 + pos / kHW, xx = x0 - 1 + pos % kHW;
      xs[pos * kRowF + c] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                                ? x[(((size_t)im * h + yy) * w + xx) * kC + c] : 0.0f;
    }
    for (int i = tid; i < kTH * kTW * kC; i += kThreads) {
      const int pos = i / kC, c = i % kC;              // c == tid % 64
      const int yy = y0 + pos / kTW, xx = x0 + pos % kTW;
      float v = 0.0f;
      if (yy < h && xx < w) {
        v = g[(((size_t)im * h + yy) * w + xx) * kC + c];
        if (gate != nullptr)
          v = __fadd_rn(__fmul_rn(v, gate[im * kC + c]), ds[im * kC + c]);
        if (sum_db) dbacc += v;
      }
      gs[pos * kRowF + c] = v;
    }
    __syncthreads();
    for (int p = 0; p < kTH * kTW; ++p) {
      const int rr = p / kTW, j = p % kTW;
      float gv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) gv[k] = gs[p * kRowF + cg + k];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float xv = xs[(rr * kHW + j + kx) * kRowF + ci];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[kx][k] = fmaf(xv, gv[k], acc[kx][k]);
      }
    }
  }

#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* pt = wpart + ((size_t)(3 * ky + kx) * nsplit + s) * kC * kC + ci * kC + cg;
#pragma unroll
    for (int k = 0; k < 16; k += 4) store4(pt + k, &acc[kx][k]);
  }
  if (sum_db) {
    dbs[tid] = dbacc;
    __syncthreads();
    if (tid < kC) {
      float t = 0.0f;
      for (int k = 0; k < kThreads / kC; ++k) t += dbs[tid + kC * k];
      dbpart[(size_t)s * kC + tid] = t;
    }
  }
}

// --------------------------------------- (d) channel-attention backward
// (d1) per (sample, chunk): partial sums of c and of g * c per channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_pool_kernel(const T* __restrict__ g, const T* __restrict__ c,
                      float* __restrict__ partial, int hw) {
  const int s = blockIdx.x, nsplit = gridDim.x, im = blockIdx.y;
  const int ch = threadIdx.x % kC, lane = threadIdx.x / kC;
  constexpr int kLanes = kThreads / kC;
  const int p0 = (int)((long long)hw * s / nsplit);
  const int p1 = (int)((long long)hw * (s + 1) / nsplit);
  const size_t base = (size_t)im * hw * kC + ch;
  float a_s = 0.0f, a_g = 0.0f;
  for (int p = p0 + lane; p < p1; p += kLanes) {
    const float cv = to_f(c[base + (size_t)p * kC]);
    a_s += cv;
    a_g += __fmul_rn(to_f(g[base + (size_t)p * kC]), cv);
  }
  __shared__ float red[2][kThreads];
  red[0][threadIdx.x] = a_s;
  red[1][threadIdx.x] = a_g;
  __syncthreads();
  if (threadIdx.x < kC) {
    float ts = 0.0f, tg = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      ts += red[0][l * kC + ch];
      tg += red[1][l * kC + ch];
    }
    float* pp = partial + (((size_t)im * nsplit + s) * 2) * kC + ch;
    pp[0] = ts;
    pp[kC] = tg;
  }
}

// (d2) one block per sample. work rows per sample:
// [T(mean) | du | T(du) | T(h) | dv | T(dv)], 64 wide.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_mlp_kernel(const float* __restrict__ partial, int npart,
                     const float* __restrict__ gate, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     float* __restrict__ ds_out, float* __restrict__ work, int hidden,
                     int hw) {
  const int im = blockIdx.x, tid = threadIdx.x;
  __shared__ float mr[kC], dur[kC], dvr[kMaxHidden];
  float* wk = work + (size_t)im * 6 * kC;
  if (tid < kC) {
    float ts = 0.0f, tg = 0.0f;
    for (int s = 0; s < npart; ++s) {
      const float* pp = partial + (((size_t)im * npart + s) * 2) * kC + tid;
      ts += pp[0];
      tg += pp[kC];
    }
    mr[tid] = rnd<T>(ts / (float)hw);
    const float gt = gate[(size_t)im * kC + tid];
    const float du = __fmul_rn(__fmul_rn(tg, gt), 1.0f - gt);
    dur[tid] = rnd<T>(du);
    wk[tid] = mr[tid];
    wk[kC + tid] = du;
    wk[2 * kC + tid] = dur[tid];
  }
  __syncthreads();
  if (tid < hidden) {
    float v = 0.0f, dh = 0.0f;
    for (int k = 0; k < kC; ++k) {
      v = fmaf(mr[k], w1[tid * kC + k], v);
      dh = fmaf(dur[k], w2[k * hidden + tid], dh);
    }
    v += b1[tid];
    const float dv = v > 0.0f ? dh : 0.0f;
    dvr[tid] = rnd<T>(dv);
    wk[3 * kC + tid] = rnd<T>(fmaxf(v, 0.0f));
    wk[4 * kC + tid] = dv;
    wk[5 * kC + tid] = dvr[tid];
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.0f;
    for (int k = 0; k < hidden; ++k) t = fmaf(dvr[k], w1[k * kC + tid], t);
    ds_out[(size_t)im * kC + tid] = t / (float)hw;
  }
}

// (d3) the CA weight gradients, summed over samples in order: thread
// e = (k, c) gives dW1[k][c] and dW2[c][k]; c == 0 also db1[k], k == 0 db2[c].
__global__ void __launch_bounds__(kThreads)
fg_ca_bwd_wgrad_kernel(const float* __restrict__ work, int nimg, int hidden,
                       float* __restrict__ dw1, float* __restrict__ db1,
                       float* __restrict__ dw2, float* __restrict__ db2) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= hidden * kC) return;
  const int k = e / kC, c = e % kC;
  float a1 = 0.0f, a2 = 0.0f, ab1 = 0.0f, ab2 = 0.0f;
  for (int im = 0; im < nimg; ++im) {
    const float* wk = work + (size_t)im * 6 * kC;
    a1 = fmaf(wk[5 * kC + k], wk[c], a1);              // T(dv) x T(mean)
    a2 = fmaf(wk[2 * kC + c], wk[3 * kC + k], a2);     // T(du) x T(h)
    ab1 += wk[4 * kC + k];
    ab2 += wk[kC + c];
  }
  dw1[k * kC + c] = a1;
  dw2[c * hidden + k] = a2;
  if (c == 0) db1[k] = ab1;
  if (k == 0) db2[c] = ab2;
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1)
    n = 132;
  return n;
}

template <bool kOutF32, bool kRelu, bool kGate>
cudaError_t launch_conv(const ConvArgs& a, int grid, cudaStream_t s) {
  static bool done = false;
  const cudaError_t e = allow_smem(fg_conv_wgmma_kernel<kOutF32, kRelu, kGate>, kConvSmem, done);
  if (e != cudaSuccess) return e;
  fg_conv_wgmma_kernel<kOutF32, kRelu, kGate><<<grid, kConvThreads, kConvSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kOutF32, bool kRelu>
cudaError_t launch_conv(const ConvArgs& a, int grid, cudaStream_t s) {
  return a.gate != nullptr ? launch_conv<kOutF32, kRelu, true>(a, grid, s)
                           : launch_conv<kOutF32, kRelu, false>(a, grid, s);
}

// The bf16 wgrad's clusters for a call: as many as fit the card at once,
// at most one per kCluster tiles. Queried once per device.
cudaError_t wgrad_clusters(int device, int ntiles, int& ncl) {
  static int resident[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    static bool done = false;
    cudaError_t e = allow_smem(fg_wgrad_wgmma_kernel, kWgSmem, done);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = kWgSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, fg_wgrad_wgmma_kernel, &cfg)) != cudaSuccess)
      return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    resident[device] = n;
  }
  const int want = (ntiles + kCluster - 1) / kCluster;
  ncl = want < resident[device] ? want : resident[device];
  return cudaSuccess;
}

// f32 wgrad: pixel chunks (x 3 tap rows, about two blocks per SM of an H100)
constexpr int kWgradSplitF32 = 88;

}  // namespace

// ------------------------------------------------------------ C interface
// Every entry returns a cudaError_t (0 = success); it launches on `stream`,
// allocates nothing and does not synchronise. Activations are NHWC with 64
// channels, of bf16 (bf16_ = 1) or float.
extern "C" {

// output tiles per image (the rows per sample of a conv's partials): 16 x 8
// pixels in bf16, 8 x 16 in f32
int sres_fg_tiles(int h, int w, int bf16_) {
  return bf16_ ? bf_tiles_per_img(h, w) : tiles_per_img(h, w);
}

// x, mask, res, res2: T; wt: (9, 64 out, 64 in) T; bias (64,), gate and ds
// (nimg, 64) f32 or null (gate and ds together); y: T, or f32 when out_f32
// (always f32 for float); part: (nimg * sres_fg_tiles(h, w, bf16_), 64) f32
// or null.
int sres_fg_conv(const void* x, const void* wt, const float* bias, const float* gate,
                 const float* ds, const void* mask, const void* res, const void* res2,
                 void* y, float* part, int nimg, int h, int w, int bf16_, int out_f32,
                 int relu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nimg < 1 || h < 1 || w < 1 || (gate == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvArgs a{x, wt, bias, gate, ds, mask, res, res2, y, part, nimg, h, w, relu};
  const int nsm = sm_count(device);
  if (bf16_) {
    const int ntiles = nimg * bf_tiles_per_img(h, w);
    const int grid = ntiles < nsm ? ntiles : nsm;
    e = out_f32 ? (relu ? launch_conv<true, true>(a, grid, s) : launch_conv<true, false>(a, grid, s))
                : (relu ? launch_conv<false, true>(a, grid, s) : launch_conv<false, false>(a, grid, s));
    if (e != cudaSuccess) return (int)e;
  } else {
    const size_t smem = ((size_t)kTaps * kC * kC + kHH * kHW * kRowF) * sizeof(float);
    const int ntiles = nimg * tiles_per_img(h, w);
    static bool done = false;
    if ((e = allow_smem(fg_conv_f32_kernel, smem, done)) != cudaSuccess) return (int)e;
    fg_conv_f32_kernel<<<ntiles < nsm ? ntiles : nsm, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// x, xn, cst: (nimg, hw, 64) T (cst may be null); c: f32; part: (nimg, npart,
// 64) f32; w1 (hidden, 64) and w2 (64, hidden) f32 holding T values, b1
// (hidden,), b2 (64,) f32; gate: (nimg, 64) f32 out.
int sres_fg_ca(const void* x, const float* c, const float* part, int npart,
               const float* w1, const float* b1, const float* w2, const float* b2,
               void* xn, float* gate, void* cst, int nimg, int hw, int hidden,
               int nchunk, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || npart < 1 || nchunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunk, nimg);
  if (bf16_)
    fg_ca_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), c, part, npart, w1, b1, w2, b2,
        static_cast<bf16*>(xn), gate, static_cast<bf16*>(cst), hw, hidden);
  else
    fg_ca_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), c, part, npart, w1, b1, w2, b2,
        static_cast<float*>(xn), gate, static_cast<float*>(cst), hw, hidden);
  return (int)cudaGetLastError();
}

// Floats of scratch sres_fg_wgrad needs for this shape (the bf16 clusters'
// partials, or the f32 blocks'), or minus a cudaError_t.
int sres_fg_wgrad_scratch(int nimg, int h, int w, int bf16_, int device) {
  if (nimg < 1 || h < 1 || w < 1) return -(int)cudaErrorInvalidValue;
  if (bf16_) {
    int ncl = 0;
    cudaError_t e = cudaSetDevice(device);
    if (e == cudaSuccess) e = wgrad_clusters(device, nimg * bf_tiles_per_img(h, w), ncl);
    return e != cudaSuccess ? -(int)e : ncl * kWgE;
  }
  const int tiles = nimg * tiles_per_img(h, w);
  const int nsplit = tiles < kWgradSplitF32 ? tiles : kWgradSplitF32;
  return nsplit * (kTaps * kC * kC + kC);
}

// x, g: T; gate, ds: (nimg, 64) f32 or null (prologue g * gate + ds);
// db_part: null, or ndb_part rows of 64 f32 whose sum is db. scratch:
// sres_fg_wgrad_scratch(...) floats. Out: dw (9, 64 in, 64 out), db (64,) f32.
int sres_fg_wgrad(const void* x, const void* g, const float* gate, const float* ds,
                  const float* db_part, int ndb_part, float* scratch, float* dw, float* db,
                  int nimg, int h, int w, int bf16_, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nimg < 1 || h < 1 || w < 1 || (gate == nullptr) != (ds == nullptr) ||
      (db_part != nullptr && ndb_part < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int own_db = db_part == nullptr;
  if (bf16_) {
    int ncl = 0;
    if ((e = wgrad_clusters(device, nimg * bf_tiles_per_img(h, w), ncl)) != cudaSuccess)
      return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ncl * kCluster);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = kWgSmem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, fg_wgrad_wgmma_kernel, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(g), gate, ds, db_part, ndb_part, scratch,
                           dw, db, nimg, h, w);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const int tiles = nimg * tiles_per_img(h, w);
  const int nsplit = tiles < kWgradSplitF32 ? tiles : kWgradSplitF32;
  float* wpart = scratch;                              // (9, nsplit, 64, 64)
  float* dbpart = scratch + (size_t)kTaps * nsplit * kC * kC;   // (nsplit, 64)
  const size_t smem = (size_t)(kTH * kHW + kTH * kTW) * kRowF * sizeof(float);
  static bool done = false;
  if ((e = allow_smem(fg_wgrad_f32_kernel, smem, done)) != cudaSuccess) return (int)e;
  fg_wgrad_f32_kernel<<<dim3(3, nsplit), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), gate, ds, wpart, dbpart,
      own_db, nimg, h, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(kTaps * kC * kC + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      wpart, dw, kTaps, nsplit, kC * kC);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (own_db)
    sum_partials_kernel<<<1, kThreads, 0, s>>>(dbpart, db, 1, nsplit, kC);
  else
    sum_partials_kernel<<<1, kThreads, 0, s>>>(db_part, db, 1, ndb_part, kC);
  return (int)cudaGetLastError();
}

// g, c: (nimg, hw, 64) T; gate (nimg, 64) f32, the forward's; w1, b1, w2 as
// sres_fg_ca.
// Scratch: partial (nimg, npart, 2, 64), work (nimg, 6, 64) f32. Out: ds
// (nimg, 64); dw1 (hidden, 64), db1 (hidden,), dw2 (64, hidden), db2 (64,).
int sres_fg_ca_bwd(const void* g, const void* c, const float* gate, const float* w1,
                   const float* b1, const float* w2, float* partial,
                   float* work, float* ds, float* dw1, float* db1, float* dw2, float* db2,
                   int nimg, int hw, int hidden, int npart, int bf16_, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (hidden < 1 || hidden > kMaxHidden || npart < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    fg_ca_bwd_pool_kernel<bf16><<<dim3(npart, nimg), kThreads, 0, s>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(c), partial, hw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fg_ca_bwd_mlp_kernel<bf16><<<nimg, kThreads, 0, s>>>(partial, npart, gate, w1, b1, w2,
                                                         ds, work, hidden, hw);
  } else {
    fg_ca_bwd_pool_kernel<float><<<dim3(npart, nimg), kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(c), partial, hw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fg_ca_bwd_mlp_kernel<float><<<nimg, kThreads, 0, s>>>(partial, npart, gate, w1, b1, w2,
                                                          ds, work, hidden, hw);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fg_ca_bwd_wgrad_kernel<<<(hidden * kC + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      work, nimg, hidden, dw1, db1, dw2, db2);
  return (int)cudaGetLastError();
}

}  // extern "C"
