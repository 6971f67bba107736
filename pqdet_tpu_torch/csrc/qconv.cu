// Int8 convolutions of the quantized serving path, for Hopper (sm_90a):
//
//   qconv1x1_s8: pointwise conv, s8 x s8 -> s32 on tensor cores;
//   qdwconv3x3_s8: depthwise 3x3, pad 1, stride 1 or 2, on CUDA cores;
//
// both with the fused epilogue of the TPU kernels
//
//   y = act(alpha * acc + (alpha * ((128 - x_zp) * colsum) + b))
//   alpha = x_scale * w_scale_c
//   out = requant ? clip(rint(y * (1 / out_scale) + (out_zp - 128)), -128, 127)
//                 : y  (f32)
//
// on NHWC activations in the recentred signed representation s = q_u8 - 128.
// The scalars ride in a device vector s = (x_scale, x_zp, 1/out_scale,
// out_zp - 128) (ops/qconv.py::make_scalars).
//
// Replaces the TPU kernels pqdet_tpu/ops/pallas_qconv.py::qconv1x1_s8
// (_qconv1x1_kernel + _epilogue) and ::qdwconv3x3_s8 (_qdw_kernel). Same
// arithmetic as their plain versions ops/qconv.py::qconv1x1_reference and
// ::qdwconv3x3_reference: the integer sum is exact; it is converted to f32
// with round-to-nearest (__int2float_rn, as the TPU kernel's
// acc.astype(f32)), and every f32 step of the epilogue is one rounded
// operation in the TPU kernel's order (__fmul_rn/__fadd_rn keep nvcc from
// contracting a multiply and an add into one FMA, which rounds once
// instead of twice). rintf rounds half to even, as jnp.round and
// torch.round do.
//
// What bounds them on this card. Bytes, at the shapes of mobilenetv2-fpn:
// a pointwise conv reads M x Cin int8 and writes M x Cout int8 (M = N*H*W)
// and does 2*M*Cin*Cout int8 operations, at most ~320 operations per byte
// at Cin = Cout = 1280 against the 1979 TOP/s / 3.35 TB/s ~ 590 the card
// needs before the tensor cores are the limit; the depthwise conv does 18
// operations per output byte. Neither kernel reaches its bound: this is the
// simple version. qconv1x1 issues WMMA s8 16x16x16 tiles out of shared
// memory with no overlap of loads and math (one load -> sync -> mma round
// per 64-deep K step); qdwconv3x3 reads its nine taps from L1/L2 without a
// shared-memory window. wgmma, TMA and a shared-memory ring come later.
//
// qconv1x1 design:
// - rows are N*H*W merged (a 1x1 conv is position independent), as the
//   TPU kernel merges the batch into rows; one block = a 64-row x 64-col
//   output tile, 4 warps, each a 32 x 32 sub-tile of 2 x 2 WMMA fragments;
// - K steps of 64 staged in shared memory as 16-byte-wide sub-blocks
//   ([k/16][row][16] for x, [k/16][n/16][16][16] for w), so every WMMA
//   fragment pointer is 256-bit aligned and every leading dimension is 16;
// - ragged K (Cin 24, the stem's 27) and ragged N (the heads' 75) are
//   zero-filled in shared memory: a zero contributes exactly 0 to the
//   integer sum, and columns >= Cout are not stored;
// - the s32 accumulators are staged through shared memory for the
//   epilogue, which writes s8 or f32 with consecutive threads on
//   consecutive channels.
//
// qdwconv3x3 design: one thread per output pixel and group of 4 channels
// (char4 loads and stores; 1 channel when C % 4 != 0). Taps outside the
// image read the pad value rint(x_zp) - 128, the recentred zero point. The
// sum is the TPU kernel's: acc += w * (tap - (x_zp - 128)) in f32 over
// (kh, kw) in order, exact for s8 operands and an integer zero point
// (|acc| <= 9 * 127 * 255 < 2^24), and the epilogue's colsum term is 0.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each entry point returns a CUDA error code (0 = launched).

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output channels per block
constexpr int BK = 64;           // K step staged in shared memory
constexpr int KC = BK / 16;      // 16-deep sub-blocks per K step
constexpr int NC = BN / 16;      // 16-wide column sub-blocks
constexpr int NT = 128;          // threads per block (4 warps)
constexpr int LDC = BN + 4;      // int32 row stride of the accumulator tile

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3,
           ACT_LOGISTIC = 4 };

__device__ __forceinline__ float apply_act(int act, float y) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_RELU6: return fminf(fmaxf(y, 0.f), 6.f);
    case ACT_LEAKY: return y > 0.f ? y : __fmul_rn(0.1f, y);
    case ACT_LOGISTIC: return 1.f / (1.f + expf(-y));
    default: return y;
  }
}

// alpha = x_scale * w_scale; beta = alpha * ((128 - x_zp) * colsum) + b
__device__ __forceinline__ void affine(const float* s, float ws, float b,
                                       float colsum, float& alpha, float& beta) {
  alpha = __fmul_rn(s[0], ws);
  beta = __fadd_rn(__fmul_rn(alpha, __fmul_rn(__fsub_rn(128.f, s[1]), colsum)), b);
}

// act(acc * alpha + beta), then the requantised code when requant
__device__ __forceinline__ float epilogue(float acc, float alpha, float beta,
                                          int act) {
  return apply_act(act, __fadd_rn(__fmul_rn(acc, alpha), beta));
}

__device__ __forceinline__ int8_t requant_code(float y, const float* s) {
  float q = rintf(__fadd_rn(__fmul_rn(y, s[2]), s[3]));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0:16] = src[0:valid] then zeros; one 16-byte move when allowed
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src,
                                       int valid, bool vec) {
  if (vec && valid >= 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < valid ? src[i] : int8_t(0);
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__global__ void __launch_bounds__(NT) qconv1x1_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    const int* __restrict__ colsum, const float* __restrict__ s,
    void* __restrict__ out, int M, int K, int N, int act, int requant) {
  __shared__ __align__(128) int8_t xs[KC][BM][16];
  __shared__ __align__(128) int8_t wsm[KC][NC][16][16];
  __shared__ __align__(128) int cs[BM][LDC];
  __shared__ float alpha_s[BN], beta_s[BN];

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp / 2) * 32;   // the warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const bool vec_x = (K % 16 == 0) && aligned16(x);
  const bool vec_w = (N % 16 == 0) && aligned16(w);

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = t; idx < BM * KC; idx += NT) {
      const int m = idx / KC, kc = idx % KC;
      const int gm = m0 + m, gk = k0 + kc * 16;
      const int valid = gm < M ? max(0, min(16, K - gk)) : 0;
      copy16(&xs[kc][m][0], valid > 0 ? x + static_cast<size_t>(gm) * K + gk : x,
             valid, vec_x);
    }
    for (int idx = t; idx < BK * NC; idx += NT) {
      const int k = idx / NC, nc = idx % NC;
      const int gk = k0 + k, gn = n0 + nc * 16;
      const int valid = gk < K ? max(0, min(16, N - gn)) : 0;
      copy16(&wsm[k / 16][nc][k % 16][0],
             valid > 0 ? w + static_cast<size_t>(gk) * N + gn : w, valid, vec_w);
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (k0 + kc * 16 >= K) break;   // all-zero sub-blocks (uniform per block)
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(
                                         &xs[kc][wm + 16 * i][0]), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], reinterpret_cast<const signed char*>(
                                         &wsm[kc][wn / 16 + j][0][0]), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  if (t < BN) {
    const int gn = n0 + t;
    float a = 0.f, b = 0.f;
    if (gn < N) affine(s, wscale[gn], bias[gn], __int2float_rn(colsum[gn]), a, b);
    alpha_s[t] = a;
    beta_s[t] = b;
  }
  __syncthreads();

  for (int idx = t; idx < BM * BN; idx += NT) {
    const int m = idx / BN, n = idx % BN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= M || gn >= N) continue;
    const float y = epilogue(__int2float_rn(cs[m][n]), alpha_s[n], beta_s[n], act);
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (requant)
      static_cast<int8_t*>(out)[o] = requant_code(y, s);
    else
      static_cast<float*>(out)[o] = y;
  }
}

template <int V>
__global__ void __launch_bounds__(256) qdw3x3_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    const float* __restrict__ s, void* __restrict__ out, int N, int H, int W,
    int C, int Ho, int Wo, int stride, int act, int requant) {
  const int CG = C / V;
  const size_t total = static_cast<size_t>(N) * Ho * Wo * CG;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cg = static_cast<int>(idx % CG);
  size_t p = idx / CG;
  const int ox = static_cast<int>(p % Wo);
  p /= Wo;
  const int oy = static_cast<int>(p % Ho);
  const int n = static_cast<int>(p / Ho);
  const int c = cg * V;

  const float x_off = __fsub_rn(s[1], 128.f);
  const int8_t pad = static_cast<int8_t>(static_cast<int>(rintf(s[1])) - 128);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int iy = oy * stride - 1 + kh;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ix = ox * stride - 1 + kw;
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
      int8_t tap[V], wk[V];
      const int8_t* wp = w + static_cast<size_t>(kh * 3 + kw) * C + c;
      const int8_t* xp = x + ((static_cast<size_t>(n) * H + iy) * W + ix) * C + c;
      if constexpr (V == 4) {
        const char4 wv = *reinterpret_cast<const char4*>(wp);
        const char4 xv = inside ? *reinterpret_cast<const char4*>(xp)
                                : make_char4(pad, pad, pad, pad);
        wk[0] = wv.x; wk[1] = wv.y; wk[2] = wv.z; wk[3] = wv.w;
        tap[0] = xv.x; tap[1] = xv.y; tap[2] = xv.z; tap[3] = xv.w;
      } else {
        wk[0] = wp[0];
        tap[0] = inside ? xp[0] : pad;
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(static_cast<float>(wk[v]),
                                              __fsub_rn(static_cast<float>(tap[v]), x_off)));
    }
  }

  const size_t o = (((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * C) + c;
  float y[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float a, b;
    affine(s, wscale[c + v], bias[c + v], 0.f, a, b);
    y[v] = epilogue(acc[v], a, b, act);
  }
  if (requant) {
    int8_t* ob = static_cast<int8_t*>(out) + o;
    if constexpr (V == 4) {
      *reinterpret_cast<char4*>(ob) = make_char4(requant_code(y[0], s), requant_code(y[1], s),
                                                 requant_code(y[2], s), requant_code(y[3], s));
    } else {
      ob[0] = requant_code(y[0], s);
    }
  } else {
    float* of = static_cast<float*>(out) + o;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(of) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      of[0] = y[0];
    }
  }
}

}  // namespace

extern "C" int qconv1x1_launch(const void* x, const void* w, const void* wscale,
                               const void* bias, const void* colsum,
                               const void* scalars, void* out, int m, int k,
                               int n, int act, int requant, void* stream) {
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  qconv1x1_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const int*>(colsum), static_cast<const float*>(scalars), out,
      m, k, n, act, requant);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qdw3x3_launch(const void* x, const void* w, const void* wscale,
                             const void* bias, const void* scalars, void* out,
                             int n, int h, int wd, int c, int stride, int act,
                             int requant, void* stream) {
  const int ho = h / stride, wo = wd / stride;
  const bool vec = (c % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const size_t total = static_cast<size_t>(n) * ho * wo * (vec ? c / 4 : c);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xb = static_cast<const int8_t*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* wsf = static_cast<const float*>(wscale);
  const float* bf = static_cast<const float*>(bias);
  const float* sf = static_cast<const float*>(scalars);
  if (vec)
    qdw3x3_kernel<4><<<blocks, 256, 0, st>>>(xb, wb, wsf, bf, sf, out, n, h, wd,
                                             c, ho, wo, stride, act, requant);
  else
    qdw3x3_kernel<1><<<blocks, 256, 0, st>>>(xb, wb, wsf, bf, sf, out, n, h, wd,
                                             c, ho, wo, stride, act, requant);
  return static_cast<int>(cudaGetLastError());
}
