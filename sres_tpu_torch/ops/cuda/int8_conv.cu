// Dynamically quantized int8 convolutions (model.quantization: int8,
// int8_fused, int8_full) on the s8 tensor cores.
//
// These kernels replace no Pallas kernel: sres_tpu/ops/int8_conv.py and
// sres_tpu/models/layers.py:67-101 (AQT) hand their s8 x s8 convolutions to
// XLA, which runs them on the TPU's int8 MXU. PyTorch has no int8
// convolution on CUDA, so the port needs its own:
//
//   q8_quantize    absmax over a scale group (a group of samples, an output
//                  channel, an input channel of the flipped weight, or the
//                  whole tensor), then t * (1/scale), round half to even and
//                  clip to s8, on int8_fused's grid (scale amax/127) or AQT's
//                  (amax/127.5, clip 127, bf16 arithmetic for bf16 input).
//                  Two launches: the absmax (atomicMax on the float bits,
//                  order-free) and the quantize. Bound by bytes.
//   s8_conv_fprop  k x k stride-1 'same' implicit-GEMM conv of NHWC s8
//                  activations against [O][kh][kw][I] s8 weights on
//                  mma.sync m16n8k32 s8 with int32 accumulators; the
//                  epilogue rounds as JAX does (below). Serves every
//                  quantized forward and int8_full's dx. Bound by bytes
//                  at the models' shapes: 1152 int8 operations per bf16
//                  output element and s8 input is 384 a byte, below the
//                  card's ratio of int8 peak to memory rate (about 590).
//   s8_conv_wgrad  dw[o][i][tap] = sum over pixels of x(tap shift) * g, per
//                  pack slot (samples b = j mod pk), int32 over chunks of at
//                  most 16384 pixels (16384 * 127^2 < 2^31), the chunks
//                  added in int64 by integer atomics (exact, so the order
//                  does not matter), then per slot: f32, bf16, * sgp,
//                  the weights' dtype, and the slots summed in f32.
//
// Rounding (sres_tpu/ops/int8_conv.py: the conv has bf16 operands and a bf16
// output, then .astype(f32) * (sx * sw)): the integer sum is exact in int32
// (K = 576 gives |sum| < 9.3e6); the epilogue is int32 -> f32 -> bf16 (RNE)
// -> f32 * (sx * sw) -> output dtype -> + bias in the output dtype (mode 0).
// AQT dequantizes (q * s_lhs) * s_rhs in the scales' dtype: f32 (mode 1), or
// bf16 with a rounding after the sum and each product (mode 2). Products use
// __fmul_rn and sums __fadd_rn so that nvcc does not contract them into FMAs.
//
// A simple design that is right: one block of 8 warps holds all 64 output
// channels of 128 pixels, the weights resident in shared memory, one tap's
// activations staged at a time; no cp.async, TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 64;          // output channels the conv kernels take
constexpr int kTaps = 9;         // 3 x 3
constexpr int kThreads = 256;    // 8 warps
constexpr int kBM = 128;         // pixels of a conv block (16 a warp)
constexpr int kQPer = 8;         // elements a thread reduces in the absmax
constexpr int kWgStage = 64;     // pixels a wgrad stage stages
constexpr int kWgMaxChunk = 16384;  // pixels a wgrad block sums in int32
constexpr float kInv127 = (float)(1.0 / 127.0);   // jnp: 1.0 / 127.0 as f32

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ float load_f(const T* p, long long i);
template <> __device__ __forceinline__ float load_f<float>(const float* p, long long i) {
  return p[i];
}
template <> __device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                   long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// ------------------------------------------------------------ q8_quantize
// The output is s8 in channels_last order of the logical (d0, d1, d2, d3):
// element j of row i0 enumerates (i2, i3, i1), i1 fastest. The input is read
// at base + i0*s0 + i1*s1 + i2*s2 + i3*s3 (strides in elements; negative
// strides flip). Row i0 belongs to group i0 / gdiv.
struct QArgs {
  const void* in;
  long long base, s0, s1, s2, s3;
  int d0, d1, d2, d3, gdiv;
  const float* pre;   // per-row multiplier (g * sx) or null
  int* amax;          // per group, the float bits of max |t|; zeroed
  float* scale;       // per group
  int8_t* q;
  int aqt;            // 0: int8_fused's grid; 1: AQT's
};

template <typename T>
__device__ __forceinline__ float q_value(const QArgs& a, int i0, int j) {
  const int i1 = j % a.d1;
  const int r = j / a.d1;
  const int i3 = r % a.d3, i2 = r / a.d3;
  const long long off = a.base + i0 * a.s0 + i1 * a.s1 + i2 * a.s2 + i3 * a.s3;
  float v = load_f<T>(static_cast<const T*>(a.in), off);
  if (a.pre != nullptr) v = __fmul_rn(v, a.pre[i0]);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) q8_absmax_kernel(QArgs a) {
  const int i0 = blockIdx.y;
  const int n = a.d1 * a.d2 * a.d3;
  const int j0 = blockIdx.x * kThreads * kQPer + threadIdx.x;
  float m = 0.f;
#pragma unroll
  for (int t = 0; t < kQPer; ++t) {
    const int j = j0 + t * kThreads;
    if (j < n) m = fmaxf(m, fabsf(q_value<T>(a, i0, j)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float wmax[kThreads / 32];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, wmax[w]);
    // non-negative floats order as their bits do
    atomicMax(&a.amax[i0 / a.gdiv], __float_as_int(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) q8_quantize_kernel(QArgs a, int total) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int n = a.d1 * a.d2 * a.d3;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const int i0 = e / n, j = e - i0 * n;
    const int g = i0 / a.gdiv;
    const float amax = __int_as_float(a.amax[g]);
    const float v = q_value<T>(a, i0, j);
    float s, inv, r;
    if (!a.aqt) {
      // sres_tpu/ops/int8_conv.py:_q8s: max(amax, 1e-30) * (1/127), then
      // round(t * (1/scale)) clipped to +-127
      s = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
      inv = 1.0f / s;
      r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
    } else {
      // AQT: absmax (1 where 0) / 127.5 in the input's dtype, its
      // reciprocal (1 where infinite), t * s_inv, clip to +-127, round
      s = __fdiv_rn(amax == 0.f ? 1.f : amax, 127.5f);
      if (kBf16) s = bf16r(s);
      inv = 1.0f / s;
      if (kBf16) inv = bf16r(inv);
      if (isinf(inv)) inv = 1.f;
      float x = __fmul_rn(v, inv);
      if (kBf16) x = bf16r(x);
      r = rintf(fminf(fmaxf(x, -127.f), 127.f));
    }
    a.q[e] = static_cast<int8_t>(r);
    if (j == 0 && i0 % a.gdiv == 0) a.scale[g] = s;
  }
}

template <typename T>
cudaError_t launch_quantize(const QArgs& a, cudaStream_t s) {
  const int n = a.d1 * a.d2 * a.d3;
  const int ngroups = (a.d0 + a.gdiv - 1) / a.gdiv;
  cudaError_t e = cudaMemsetAsync(a.amax, 0, ngroups * sizeof(int), s);
  if (e != cudaSuccess) return e;
  dim3 grid1((n + kThreads * kQPer - 1) / (kThreads * kQPer), a.d0);
  q8_absmax_kernel<T><<<grid1, kThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = a.d0 * n;
  int blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  q8_quantize_kernel<T><<<blocks, kThreads, 0, s>>>(a, total);
  return cudaGetLastError();
}

// ---------------------------------------------------------- s8_conv_fprop
struct FArgs {
  const int8_t* x;     // (B, H, W, CIN) s8
  const int8_t* w;     // (64, 3, 3, CIN) s8
  const float* sx;     // per group of sdiv samples
  const float* sw;     // (64,)
  const float* bias;   // (64,) values in the output dtype, or null
  void* y;             // (B, H, W, 64) float or bf16
  int B, H, W, sdiv, mode;
};

// K layout: CIN = 64: k = tap * 64 + ci, two k-steps of 32 a tap;
// CIN = 1: k = tap, padded with zeros to one k-step of 32.
template <int CIN> struct FpropShape {
  static constexpr int kK = CIN == 1 ? 32 : kTaps * CIN;   // weight row
  static constexpr int kWRow = kK + 16;                      // + pad (banks)
  static constexpr int kARowK = CIN == 1 ? 32 : CIN;         // a staged row
  static constexpr int kARow = kARowK + 16;
};

__device__ __forceinline__ float fprop_epilogue(int acc, float sx, float sw, int mode) {
  const float r = static_cast<float>(acc);
  if (mode == 0) return __fmul_rn(bf16r(r), __fmul_rn(sx, sw));
  if (mode == 1) return __fmul_rn(__fmul_rn(r, sx), sw);
  return bf16r(__fmul_rn(bf16r(__fmul_rn(bf16r(r), sx)), sw));
}

__device__ __forceinline__ void store2(float* y, long long i, float a, float b) {
  *reinterpret_cast<float2*>(y + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* y, long long i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(a, b);
}

template <int CIN, typename TO>
__global__ void __launch_bounds__(kThreads) s8_conv_fprop_kernel(FArgs a) {
  using S = FpropShape<CIN>;
  __shared__ __align__(16) int8_t w_s[kCo * S::kWRow];
  __shared__ __align__(16) int8_t a_s[kBM * S::kARow];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int hw = a.H * a.W;
  const long long M = (long long)a.B * hw;
  const long long m0 = (long long)blockIdx.x * kBM;

  // the weights, resident
  if (CIN == 1) {
    for (int i = tid; i < kCo * 32; i += kThreads) {
      const int o = i >> 5, t = i & 31;
      w_s[o * S::kWRow + t] = t < kTaps ? a.w[o * kTaps + t] : int8_t(0);
    }
  } else {
    constexpr int kVec = kCo * S::kK / 16;
    for (int i = tid; i < kVec; i += kThreads) {
      const int o = i / (S::kK / 16), c = i % (S::kK / 16);
      *reinterpret_cast<int4*>(w_s + o * S::kWRow + c * 16) =
          *reinterpret_cast<const int4*>(a.w + (long long)o * S::kK + c * 16);
    }
  }

  int acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0;

  constexpr int kStages = CIN == 1 ? 1 : kTaps;
  for (int st = 0; st < kStages; ++st) {
    __syncthreads();   // a_s free (and, at st 0, w_s written)
    if (CIN == 1) {
      for (int i = tid; i < kBM * 32; i += kThreads) {
        const int px = i >> 5, t = i & 31;
        const long long m = m0 + px;
        int8_t v = 0;
        if (t < kTaps && m < M) {
          const int b = (int)(m / hw), rem = (int)(m - (long long)b * hw);
          const int h = rem / a.W + t / 3 - 1, w = rem % a.W + t % 3 - 1;
          if (h >= 0 && h < a.H && w >= 0 && w < a.W)
            v = a.x[((long long)b * a.H + h) * a.W + w];
        }
        a_s[px * S::kARow + t] = v;
      }
    } else {
      const int dh = st / 3 - 1, dw = st % 3 - 1;
      constexpr int kParts = CIN / 16;
      for (int i = tid; i < kBM * kParts; i += kThreads) {
        const int px = i / kParts, part = i % kParts;
        const long long m = m0 + px;
        int4 v = make_int4(0, 0, 0, 0);
        if (m < M) {
          const int b = (int)(m / hw), rem = (int)(m - (long long)b * hw);
          const int h = rem / a.W + dh, w = rem % a.W + dw;
          if (h >= 0 && h < a.H && w >= 0 && w < a.W)
            v = *reinterpret_cast<const int4*>(
                a.x + (((long long)b * a.H + h) * a.W + w) * CIN + part * 16);
        }
        *reinterpret_cast<int4*>(a_s + px * S::kARow + part * 16) = v;
      }
    }
    __syncthreads();
    constexpr int kSteps = CIN == 1 ? 1 : CIN / 32;
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc) {
      const int8_t* ar = a_s + (warp * 16 + g) * S::kARow + kc * 32 + tig * 4;
      unsigned af[4];
      af[0] = lds32(ar);
      af[1] = lds32(ar + 8 * S::kARow);
      af[2] = lds32(ar + 16);
      af[3] = lds32(ar + 8 * S::kARow + 16);
      const int kb = (CIN == 1 ? 0 : st * CIN) + kc * 32 + tig * 4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* br = w_s + (nt * 8 + g) * S::kWRow + kb;
        mma_s8(acc[nt], af, lds32(br), lds32(br + 16));
      }
    }
  }

  // epilogue: c0, c1 at row g, c2, c3 at row g + 8; columns 2*tig, +1
  TO* y = static_cast<TO*>(a.y);
  constexpr bool kBf16 = sizeof(TO) == 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long m = m0 + warp * 16 + g + half * 8;
    if (m >= M) continue;
    const float sx = a.sx[(int)(m / hw) / a.sdiv];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int o = nt * 8 + tig * 2;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float r = fprop_epilogue(acc[nt][half * 2 + c], sx, a.sw[o + c], a.mode);
        if (kBf16) r = bf16r(r);
        if (a.bias != nullptr) {
          r = __fadd_rn(r, a.bias[o + c]);
          if (kBf16) r = bf16r(r);
        }
        v[c] = r;
      }
      store2(y, m * kCo + o, v[0], v[1]);
    }
  }
}

// ---------------------------------------------------------- s8_conv_wgrad
struct WArgs {
  const int8_t* x;     // (B, H, W, CIN) s8, the forward's stash
  const int8_t* g;     // (B, H, W, 64) s8
  long long* acc;      // (pk, 9, CIN, 64) int64, zeroed
  int B, H, W, pk, chunk;
};

// Block: slot j = blockIdx.z, chunk c = blockIdx.x of the slot's pixel
// stream (its samples b = j, j + pk, ... one after another), tap blockIdx.y
// (CIN = 64; CIN = 1 takes the 9 taps as the rows of one m-tile).
// A = x(tap)ᵀ (rows i or taps, k = pixels), B = g (k = pixels, n = o), both
// staged transposed: [row][pixel].
template <int CIN>
__global__ void __launch_bounds__(kThreads) s8_conv_wgrad_kernel(WArgs a) {
  constexpr int kRows = CIN == 1 ? 16 : CIN;   // A rows: taps (padded) or i
  constexpr int kRow = kWgStage + 16;
  __shared__ __align__(16) int8_t xt[kRows * kRow];
  __shared__ __align__(16) int8_t gt[kCo * kRow];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int slot = blockIdx.z, tap = blockIdx.y;
  const int hw = a.H * a.W;
  const int nslot = (a.B - slot + a.pk - 1) / a.pk;   // samples of the slot
  const long long npx = (long long)nslot * hw;
  const long long p0 = (long long)blockIdx.x * a.chunk;
  long long p1 = p0 + a.chunk;
  if (p1 > npx) p1 = npx;
  // CIN = 64: warp -> m-tile warp & 3, n-tiles (warp >> 2) * 4 + 0..3;
  // CIN = 1: m-tile 0, n-tile warp
  constexpr int kNt = CIN == 1 ? 1 : 4;
  const int mt = CIN == 1 ? 0 : (warp & 3);
  const int nt0 = CIN == 1 ? warp : (warp >> 2) * 4;
  int acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0;

  for (long long s0 = p0; s0 < p1; s0 += kWgStage) {
    __syncthreads();
    // g: 64 pixels x 64 channels, a thread 16 channels of one pixel
    {
      const int px = tid & 63, part = tid >> 6;
      const long long p = s0 + px;
      int4 v = make_int4(0, 0, 0, 0);
      if (p < p1) {
        const long long b = slot + (long long)a.pk * (p / hw);
        v = *reinterpret_cast<const int4*>(a.g + (b * hw + p % hw) * kCo + part * 16);
      }
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int c = 0; c < 16; ++c) gt[(part * 16 + c) * kRow + px] = vb[c];
    }
    if (CIN == 1) {
      for (int i = tid; i < 16 * kWgStage; i += kThreads) {
        const int t = i / kWgStage, px = i % kWgStage;
        const long long p = s0 + px;
        int8_t v = 0;
        if (t < kTaps && p < p1) {
          const long long b = slot + (long long)a.pk * (p / hw);
          const int rem = (int)(p % hw);
          const int h = rem / a.W + t / 3 - 1, w = rem % a.W + t % 3 - 1;
          if (h >= 0 && h < a.H && w >= 0 && w < a.W) v = a.x[(b * a.H + h) * a.W + w];
        }
        xt[t * kRow + px] = v;
      }
    } else {
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      const int px = tid & 63, part = tid >> 6;
      const long long p = s0 + px;
      int4 v = make_int4(0, 0, 0, 0);
      if (p < p1) {
        const long long b = slot + (long long)a.pk * (p / hw);
        const int rem = (int)(p % hw);
        const int h = rem / a.W + dh, w = rem % a.W + dw;
        if (h >= 0 && h < a.H && w >= 0 && w < a.W)
          v = *reinterpret_cast<const int4*>(a.x + ((b * a.H + h) * a.W + w) * CIN + part * 16);
      }
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int c = 0; c < 16; ++c) xt[(part * 16 + c) * kRow + px] = vb[c];
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kWgStage / 32; ++kc) {
      const int8_t* ar = xt + (mt * 16 + g) * kRow + kc * 32 + tig * 4;
      unsigned af[4];
      af[0] = lds32(ar);
      af[1] = lds32(ar + 8 * kRow);
      af[2] = lds32(ar + 16);
      af[3] = lds32(ar + 8 * kRow + 16);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const int8_t* br = gt + ((nt0 + n) * 8 + g) * kRow + kc * 32 + tig * 4;
        mma_s8(acc[n], af, lds32(br), lds32(br + 16));
      }
    }
  }
  // the chunk's int32 sums into the slot's int64 totals
  unsigned long long* tot = reinterpret_cast<unsigned long long*>(a.acc);
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = mt * 16 + g + (r >> 1) * 8;     // i (CIN 64) or tap (CIN 1)
      const int o = (nt0 + n) * 8 + tig * 2 + (r & 1);
      if (CIN == 1 && row >= kTaps) continue;
      const int t = CIN == 1 ? row : tap, i = CIN == 1 ? 0 : row;
      const long long idx = (((long long)slot * kTaps + t) * CIN + i) * kCo + o;
      atomicAdd(tot + idx, (unsigned long long)(long long)acc[n][r]);
    }
}

// dw[o][i][kh][kw] (f32) = sum over slots j, in order, of
// wdt(f32(bf16(f32(acc[j][tap][i][o]))) * sgp)
__global__ void s8_wgrad_finish_kernel(const long long* acc, const float* sgp, float* dw,
                                       int cin, int pk, int wdt_bf16) {
  const int n = kCo * cin * kTaps;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int t = e % kTaps, i = (e / kTaps) % cin, o = e / (kTaps * cin);
  const float s = *sgp;
  float v = 0.f;
  for (int j = 0; j < pk; ++j) {
    float f = bf16r(static_cast<float>(acc[(((long long)j * kTaps + t) * cin + i) * kCo + o]));
    f = __fmul_rn(f, s);
    if (wdt_bf16) f = bf16r(f);
    v = j == 0 ? f : __fadd_rn(v, f);
  }
  dw[e] = v;
}

}  // namespace

extern "C" {

// in: float (in_bf16 = 0) or bf16, read at base + i0*s0 + ... (elements);
// (d0, d1, d2, d3) the logical shape, q: its channels_last s8; amax: int
// scratch and scale: f32, one per group of gdiv rows; pre: (d0,) f32 or
// null; aqt: 0 int8_fused's grid, 1 AQT's.
int sres_q8_quantize(const void* in, int in_bf16, long long base, long long s0, long long s1,
                     long long s2, long long s3, int d0, int d1, int d2, int d3, int gdiv,
                     const float* pre, int aqt, int* amax, float* scale, int8_t* q,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (d0 < 1 || d1 < 1 || d2 < 1 || d3 < 1 || gdiv < 1 ||
      (long long)d0 * d1 * d2 * d3 >= (1LL << 31) || (pre != nullptr && aqt))
    return (int)cudaErrorInvalidValue;
  const QArgs a{in, base, s0, s1, s2, s3, d0, d1, d2, d3, gdiv, pre, amax, scale, q, aqt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(in_bf16 ? launch_quantize<__nv_bfloat16>(a, s) : launch_quantize<float>(a, s));
}

// x: (B, H, W, cin) s8, w: (64, 3, 3, cin) s8, cin 1 or 64; sx: one per
// group of sdiv samples, sw: (64,), bias (64,) or null, all f32; y: (B, H,
// W, 64) f32 (out_bf16 = 0) or bf16; mode: 0 int8_fused's epilogue, 1 AQT's
// in f32, 2 AQT's in bf16.
int sres_s8_conv_fprop(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                       const float* bias, void* y, int B, int H, int W, int cin, int sdiv,
                       int mode, int out_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || H < 1 || W < 1 || sdiv < 1 || mode < 0 || mode > 2 || (cin != 1 && cin != 64))
    return (int)cudaErrorInvalidValue;
  const FArgs a{x, w, sx, sw, bias, y, B, H, W, sdiv, mode};
  const long long M = (long long)B * H * W;
  const long long blocks = (M + kBM - 1) / kBM;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 1) {
    if (out_bf16) s8_conv_fprop_kernel<1, __nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(a);
    else s8_conv_fprop_kernel<1, float><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else {
    if (out_bf16) s8_conv_fprop_kernel<64, __nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(a);
    else s8_conv_fprop_kernel<64, float><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// x: (B, H, W, cin) s8, g: (B, H, W, 64) s8; acc: (pk, 9, cin, 64) int64
// scratch; sgp: one f32 on the card; dw: (64, cin, 3, 3) f32. Pack slot j
// sums the samples b = j mod pk; chunk: pixels a block sums in int32.
int sres_s8_conv_wgrad(const int8_t* x, const int8_t* g, long long* acc, const float* sgp,
                       float* dw, int B, int H, int W, int cin, int pk, int chunk,
                       int wdt_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || H < 1 || W < 1 || pk < 1 || (cin != 1 && cin != 64) || chunk < kWgStage ||
      chunk > kWgMaxChunk || chunk % kWgStage)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(acc, 0, (size_t)pk * kTaps * cin * kCo * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  const long long npx = (long long)((B + pk - 1) / pk) * H * W;   // slot 0's, the longest
  const long long nchunks = (npx + chunk - 1) / chunk;
  if (nchunks >= (1LL << 31) || pk > 65535) return (int)cudaErrorInvalidValue;
  const WArgs a{x, g, acc, B, H, W, pk, chunk};
  if (cin == 1) {
    s8_conv_wgrad_kernel<1><<<dim3((unsigned)nchunks, 1, pk), kThreads, 0, s>>>(a);
  } else {
    s8_conv_wgrad_kernel<64><<<dim3((unsigned)nchunks, kTaps, pk), kThreads, 0, s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = kCo * cin * kTaps;
  s8_wgrad_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(acc, sgp, dw, cin, pk, wdt_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
