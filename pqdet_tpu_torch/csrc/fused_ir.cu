// Fused bf16 inverted-residual block for Hopper (sm_90a):
//
//   [1x1 expand + act_e] -> [depthwise 3x3, stride 1, pad 1, + act_dw]
//                        -> [1x1 project + act_p]
//
// on NHWC activations, or a bare dw3x3 + pw1x1 pair (expand == 0, E == Cin).
//
// Replaces the TPU kernel pqdet_tpu/ops/pallas_fused.py::fused_ir_conv
// (_fused_ir_kernel). Same arithmetic as its plain version
// pqdet_tpu_torch/ops/fused_ir.py::fused_ir_reference: bf16 inputs and
// weights, f32 accumulation, and a round to bf16 at each stage boundary
// (after expand + bias + act + pad mask, after dw + bias + act, after
// project + bias + act).
//
// What bounds it on this card. The point of the fusion is bytes: the
// expanded (E-wide) and depthwise activations never reach device memory,
// so a block reads x (Cin wide) and the weights and writes y (P wide).
// At mobilenetv2-fpn's shapes that is 2-8 MB per chain, a few
// microseconds at 3.35 TB/s; the 2*H*W*(Cin*E + 9*E + E*P) operations at
// the bf16 tensor-core rate are of the same order. Neither is what this
// version reaches: it issues the two 1x1 products as warp-level tensor-core
// tiles (WMMA 16x16x16, bf16 in, f32 out) out of shared memory with no
// overlap of loads and math, so it is bound by the latency of each
// load -> sync -> mma round. wgmma, TMA and a pipelined ring come later.
//
// Design:
// - one block = an 8x8 output-pixel tile (10x10 halo window, padded to 112
//   rows for the 16-row tiles) of one image, times a tile of PT output
//   channels (PT = 32, 64 or 128 by P); 8 warps;
// - the sum over E cannot be carried across blocks (Hopper blocks run in
//   no order, unlike the TPU's sequential grid axis with its VMEM
//   accumulator), so each block loops over E in chunks of EC = 64 and
//   keeps the f32 projection accumulator (64 pixels x PT) in registers,
//   as WMMA accumulator fragments;
// - per E chunk: expand = [112 x Cin] x [Cin x 64], summed over Cin in
//   steps of CK = 64 staged in shared memory, so Cin up to 1280
//   (nodes 62-64) never has to fit at once (a 10x10 window of 1280 bf16
//   channels alone is 256 KB); its f32 result gets bias + act + the pad
//   mask and a bf16 round in shared memory; the dw 3x3 runs as scalar
//   FMAs from there (9 taps, no reuse worth a product); the project adds
//   [64 x 64] x [64 x PT] into the accumulators;
// - when P > PT the P tiles are separate blocks and each recomputes the
//   expand and dw of its window: the recompute factor is ceil(P / 128),
//   up to 8 on this model (P = 1024);
// - zero-pad domain: window pixels outside the image are set to 0 AFTER
//   expand + bias + act (relu6(expand(0)) = relu6(be) != 0), exactly as
//   the dw conv's zero padding sees them;
// - ragged Cin, E and P are masked here (the weights come unpadded): the
//   tiles are zero-filled beyond them, channels >= E contribute exactly 0
//   and channels >= P are not stored, so the output has exactly P
//   channels;
// - 80.5 KB of dynamic shared memory (above the 48 KB default, so the
//   launcher raises the limit with cudaFuncSetAttribute); the epilogue's
//   f32 staging reuses the expand's buffers.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns a CUDA error code (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TH = 8;                   // output tile rows
constexpr int TW = 8;                   // output tile cols
constexpr int HWIN = TW + 2;            // halo window width
constexpr int NPIX = TH * TW;           // 64 output pixels per block
constexpr int NHALO = (TH + 2) * HWIN;  // 100 window pixels
constexpr int MPAD = 112;               // NHALO rounded up to 16
constexpr int EC = 64;                  // expanded channels per chunk
constexpr int CK = 64;                  // input channels per expand step
constexpr int NT = 256;                 // threads per block (8 warps)
constexpr int NWARP = NT / 32;
constexpr int LDX = CK + 8;             // bf16 row strides (16-byte rows,
constexpr int LDW = EC + 8;             //  off the 128-byte bank period)
constexpr int LDE = EC + 4;             // f32 row stride of the expanded tile

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3,
           ACT_LOGISTIC = 4 };

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ uint16_t f2bf(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

__device__ __forceinline__ float round_bf(float f) { return bf2f(f2bf(f)); }

__device__ __forceinline__ float apply_act(int act, float y) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_RELU6: return fminf(fmaxf(y, 0.f), 6.f);
    case ACT_LEAKY: return y > 0.f ? y : 0.1f * y;
    case ACT_LOGISTIC: return 1.f / (1.f + expf(-y));
    default: return y;
  }
}

// dst[0:8] = src[0:valid] then zeros; one 16-byte move when allowed
__device__ __forceinline__ void copy8(uint16_t* dst, const uint16_t* src,
                                      int valid, bool vec) {
  if (vec && valid >= 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < valid ? src[i] : uint16_t(0);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int PT>
constexpr int smem_bytes() {
  return MPAD * LDX * 2 + CK * LDW * 2 + MPAD * LDE * 4  // expand stage
         + NPIX * LDW * 2 + EC * (PT + 8) * 2;           // project stage
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int PT>
__global__ void __launch_bounds__(NT) fused_ir_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ we,
    const float* __restrict__ be, const uint16_t* __restrict__ wdw,
    const float* __restrict__ bdw, const uint16_t* __restrict__ wp,
    const float* __restrict__ bp, uint16_t* __restrict__ out, int H, int W,
    int Cin, int E, int P, int expand, int act_e, int act_dw, int act_p) {
  constexpr int LDP = PT + 8;         // bf16 row stride of the project tile
  constexpr int LDO = PT + 4;         // f32 row stride of the output tile
  constexpr int NT_P = PT / 16;       // project N tiles
  constexpr int TPW = 4 * NT_P / NWARP;  // project tiles per warp
  static_assert(NPIX * LDO * 4 <= MPAD * LDX * 2 + CK * LDW * 2 + MPAD * LDE * 4,
                "output staging must fit in the expand buffers");

  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);        // [MPAD][LDX]
  uint16_t* wes = xs + MPAD * LDX;                          // [CK][LDW]
  float* xe = reinterpret_cast<float*>(wes + CK * LDW);     // [MPAD][LDE]
  uint16_t* ys = reinterpret_cast<uint16_t*>(xe + MPAD * LDE);  // [NPIX][LDW]
  uint16_t* wps = ys + NPIX * LDW;                          // [EC][LDP]
  float* os = reinterpret_cast<float*>(smem);               // [NPIX][LDO]

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int p0 = blockIdx.y * PT;
  const int n = blockIdx.z;
  const uint16_t* xn = x + static_cast<size_t>(n) * H * W * Cin;
  const bool vec_x = (Cin % 8 == 0) && aligned16(x);
  const bool vec_we = (E % 8 == 0) && aligned16(we);
  const bool vec_wp = (P % 8 == 0) && aligned16(wp);

  FragC acc_p[TPW];
#pragma unroll
  for (int j = 0; j < TPW; ++j) wmma::fill_fragment(acc_p[j], 0.f);

  for (int e0 = 0; e0 < E; e0 += EC) {
    // ---- stage 1: expanded window xe[NHALO][EC], f32 holding bf16 values
    if (expand) {
      FragC acc_e[4];  // tiles warp + 8j of the 7 x 4 grid of 16x16 tiles
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc_e[j], 0.f);
      for (int c0 = 0; c0 < Cin; c0 += CK) {
        for (int idx = t; idx < MPAD * (CK / 8); idx += NT) {
          const int hp = idx / (CK / 8), col = (idx % (CK / 8)) * 8;
          const int gy = ty0 - 1 + hp / HWIN, gx = tx0 - 1 + hp % HWIN;
          const bool inside = hp < NHALO && gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int valid = inside ? min(8, Cin - c0 - col) : 0;
          copy8(xs + hp * LDX + col,
                inside ? xn + (static_cast<size_t>(gy) * W + gx) * Cin + c0 + col : xn,
                valid, vec_x);
        }
        for (int idx = t; idx < CK * (EC / 8); idx += NT) {
          const int ci = idx / (EC / 8), col = (idx % (EC / 8)) * 8;
          const bool row_ok = c0 + ci < Cin;
          const int valid = row_ok ? min(8, E - e0 - col) : 0;
          copy8(wes + ci * LDW + col,
                row_ok ? we + static_cast<size_t>(c0 + ci) * E + e0 + col : we,
                valid, vec_we);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tile = warp + NWARP * j;
          if (tile >= (MPAD / 16) * (EC / 16)) break;
          const int mt = tile / (EC / 16), nt = tile % (EC / 16);
#pragma unroll
          for (int kk = 0; kk < CK / 16; ++kk) {
            FragA a;
            FragB b;
            wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(
                                          xs + mt * 16 * LDX + kk * 16), LDX);
            wmma::load_matrix_sync(b, reinterpret_cast<const __nv_bfloat16*>(
                                          wes + kk * 16 * LDW + nt * 16), LDW);
            wmma::mma_sync(acc_e[j], a, b, acc_e[j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tile = warp + NWARP * j;
        if (tile >= (MPAD / 16) * (EC / 16)) break;
        const int mt = tile / (EC / 16), nt = tile % (EC / 16);
        wmma::store_matrix_sync(xe + mt * 16 * LDE + nt * 16, acc_e[j], LDE,
                                wmma::mem_row_major);
      }
      __syncthreads();
      for (int idx = t; idx < NHALO * EC; idx += NT) {
        const int hp = idx / EC, ec = idx % EC, e = e0 + ec;
        const int gy = ty0 - 1 + hp / HWIN, gx = tx0 - 1 + hp % HWIN;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && e < E;
        float* v = xe + hp * LDE + ec;
        *v = inside ? round_bf(apply_act(act_e, *v + be[e])) : 0.f;
      }
    } else {
      // bare dw + pw pair: the window itself is the dw input (Cin == E)
      for (int idx = t; idx < NHALO * EC; idx += NT) {
        const int hp = idx / EC, ec = idx % EC, e = e0 + ec;
        const int gy = ty0 - 1 + hp / HWIN, gx = tx0 - 1 + hp % HWIN;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && e < E;
        xe[hp * LDE + ec] =
            inside ? bf2f(xn[(static_cast<size_t>(gy) * W + gx) * Cin + e]) : 0.f;
      }
    }
    __syncthreads();

    // ---- stage 2: depthwise 3x3 -> ys[NPIX][EC] bf16; stage the project tile
    {
      const int ec = t % EC, e = e0 + ec;
      float wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        wk[k] = e < E ? bf2f(wdw[static_cast<size_t>(k) * E + e]) : 0.f;
      const float bias = e < E ? bdw[e] : 0.f;
#pragma unroll 4
      for (int op = t / EC; op < NPIX; op += NT / EC) {
        const int oy = op / TW, ox = op % TW;
        float s = 0.f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            s += xe[((oy + kh) * HWIN + ox + kw) * LDE + ec] * wk[kh * 3 + kw];
        ys[op * LDW + ec] = e < E ? f2bf(apply_act(act_dw, s + bias)) : uint16_t(0);
      }
    }
    for (int idx = t; idx < EC * (PT / 8); idx += NT) {
      const int k = idx / (PT / 8), col = (idx % (PT / 8)) * 8;
      const bool row_ok = e0 + k < E;
      const int valid = row_ok ? min(8, P - p0 - col) : 0;
      copy8(wps + k * LDP + col,
            row_ok ? wp + static_cast<size_t>(e0 + k) * P + p0 + col : wp, valid,
            vec_wp);
    }
    __syncthreads();

    // ---- stage 3: partial projection over this E chunk, on tensor cores
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int tile = warp + NWARP * j;
      const int mt = tile / NT_P, nt = tile % NT_P;
#pragma unroll
      for (int kk = 0; kk < EC / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(
                                      ys + mt * 16 * LDW + kk * 16), LDW);
        wmma::load_matrix_sync(b, reinterpret_cast<const __nv_bfloat16*>(
                                      wps + kk * 16 * LDP + nt * 16), LDP);
        wmma::mma_sync(acc_p[j], a, b, acc_p[j]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: stage f32 sums, bias + act, round to bf16, store P channels
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int tile = warp + NWARP * j;
    const int mt = tile / NT_P, nt = tile % NT_P;
    wmma::store_matrix_sync(os + mt * 16 * LDO + nt * 16, acc_p[j], LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = t; idx < NPIX * PT; idx += NT) {
    const int op = idx / PT, c = idx % PT;
    const int oy = ty0 + op / TW, ox = tx0 + op % TW;
    if (oy >= H || ox >= W || p0 + c >= P) continue;
    out[((static_cast<size_t>(n) * H + oy) * W + ox) * P + p0 + c] =
        f2bf(apply_act(act_p, os[op * LDO + c] + bp[p0 + c]));
  }
}

template <int PT>
int launch(dim3 grid, cudaStream_t stream, const uint16_t* x,
           const uint16_t* we, const float* be, const uint16_t* wdw,
           const float* bdw, const uint16_t* wp, const float* bp,
           uint16_t* out, int h, int w, int cin, int e, int p, int expand,
           int act_e, int act_dw, int act_p) {
  constexpr int bytes = smem_bytes<PT>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_ir_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ir_kernel<PT><<<grid, NT, bytes, stream>>>(
      x, we, be, wdw, bdw, wp, bp, out, h, w, cin, e, p, expand, act_e,
      act_dw, act_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_ir_p_tile(int p) { return p <= 32 ? 32 : p <= 64 ? 64 : 128; }

extern "C" int fused_ir_launch(const void* x, const void* we, const void* be,
                               const void* wdw, const void* bdw,
                               const void* wp, const void* bp, void* out,
                               int n, int h, int w, int cin, int e, int p,
                               int expand, int act_e, int act_dw, int act_p,
                               void* stream) {
  const int pt = fused_ir_p_tile(p);
  dim3 grid(((w + TW - 1) / TW) * ((h + TH - 1) / TH), (p + pt - 1) / pt, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint16_t* web = static_cast<const uint16_t*>(we);
  const uint16_t* wdwb = static_cast<const uint16_t*>(wdw);
  const uint16_t* wpb = static_cast<const uint16_t*>(wp);
  const float* bef = static_cast<const float*>(be);
  const float* bdwf = static_cast<const float*>(bdw);
  const float* bpf = static_cast<const float*>(bp);
  uint16_t* ob = static_cast<uint16_t*>(out);
  if (pt == 32)
    return launch<32>(grid, s, xb, web, bef, wdwb, bdwf, wpb, bpf, ob, h, w,
                      cin, e, p, expand, act_e, act_dw, act_p);
  if (pt == 64)
    return launch<64>(grid, s, xb, web, bef, wdwb, bdwf, wpb, bpf, ob, h, w,
                      cin, e, p, expand, act_e, act_dw, act_p);
  return launch<128>(grid, s, xb, web, bef, wdwb, bdwf, wpb, bpf, ob, h, w,
                     cin, e, p, expand, act_e, act_dw, act_p);
}
