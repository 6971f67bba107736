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
// operations per output byte. Neither kernel reaches its bound. At 16x16
// and 32x32 (M = 1024, 4096 at batch 4) qconv1x1 is bound by the latency of
// each CTA's few steps, at 64x64 and up by its epilogue's instructions
// (about ten per output, 25 M outputs at 256x256) and the per-tile copies.
// qdwconv3x3 does 18 operations per output byte; measured on the card its
// tiles are bound by the latency of each CTA's load -> taps -> store
// sequence, and the small layers by the launch (PERF.md).
//
// qconv1x1 design (tiles, K step, split-K and stages from the host's plan,
// ops/qconv.py::plan_qconv1x1, as plain ints):
// - rows are N*H*W merged (a 1x1 conv is position independent), as the
//   TPU kernel merges the batch into rows; a CTA of 8 warps takes a BM x BN
//   output tile (128 x 32 mostly, 128 x 64 where the tiles would be too
//   many, 64 x 64/128 below 512 rows), each warp 32 rows x BN/(256/BM);
// - s8 x s8 -> s32 on mma.sync m16n8k32 from ldmatrix. The instruction
//   wants both operands k-contiguous and w is [K][N]: each K step's w tile
//   is transposed in shared memory, 4 x 4 bytes a thread (byte_perm);
// - K steps of BK = 32/64/128 (32 for K <= 32: the stem's 27 padded to 32
//   by the port's im2col, Cin 16/24/32) through a ring of 2-3 cp.async
//   stages of 16 bytes (8 for K or N a multiple of 8 only; four byte loads
//   a word for the rest); rows or columns outside M, K and N are
//   zero-filled (source size 0): a zero adds exactly 0 to the integer sum;
// - split-K where the tiles alone do not fill the card (the 16x16 and
//   32x32 layers): SPLIT CTAs of a cluster take KPR whole K steps each,
//   stage their s32 partial tiles in shared memory, and after
//   cluster.sync() each adds the ranks' partials for 1/SPLIT of the rows
//   through distributed shared memory (all ranks' loads in flight at once)
//   and runs the epilogue: an integer sum, exact in any order, one launch;
// - epilogue: affine/epilogue/requant_code's arithmetic with the scalars
//   in registers and the activation decoded once. Output rows go out as
//   16-byte stores; rows that are not 16-byte aligned (Cout 24, 75) are
//   staged in shared memory and stored with consecutive threads on
//   consecutive elements. Without split-K and with s8 output the epilogue
//   runs on the accumulators in registers and stages one byte per output.
//
// qdwconv3x3 design (tiles from the host's plan, ops/qconv.py::
// plan_qdwconv3x3, as plain ints). By its bytes bound the conv is 18
// operations per output byte, and at stride 2 the input is four times the
// output; each input byte is read from device memory once per CTA:
// - one CTA of 256 threads per output tile of (image, TH rows x TW columns,
//   CS channels), the channel slices of a tile neighbours in the grid; its
//   input window with halo, (TH*s+2) x (TW*s+2) x CS int8 (rows padded to a
//   bank-skewed pitch), the CS-channel slices of the weights, w_scale and
//   bias all come into shared memory by cp.async in one round trip (16-byte
//   copies; 8 or 4 where C is not a multiple of 16, byte loads where C is
//   odd); window pixels outside the image get the pad code rint(x_zp) -
//   128, the recentred zero point;
// - each thread takes 4 consecutive output columns x 4 channels (1 where C
//   % 4 != 0) of one row: per kernel row it reads a 1 x (3s+3) slice of the
//   window;
// - an integer zero point in [0, 255] (every edge act_qparams makes): the
//   taps are integer dot products. The slice's pixel words (4 channels
//   each) are transposed into channel words (4 pixels each) by byte
//   permutes, and an output's three taps of a kernel row are one dp4a
//   against [w0, w1, w2, 0]; sum w * (x - x_off) = sum w * x - x_off *
//   sum w is exact, and so is the TPU kernel's f32 sum of these integers
//   (all below 2^24), so the two agree bit for bit. The integer goes to
//   f32 through the mantissa of 1.5 * 2^23 (an add), not the conversion
//   unit, which runs at a quarter of the FP32 rate;
// - any other zero point: the taps in f32 in the TPU kernel's order, acc +=
//   w * (tap - x_off) over (kh, kw), the multiply and the add rounded
//   apart; each s8 tap is converted to f32 once, exactly, through the
//   mantissa of 2^23;
// - the epilogue is affine/epilogue/requant_code's rounded steps, with
//   rint done by adding 1.5 * 2^23 (round to nearest even) after the clamp:
//   no conversion-unit instruction per output;
// - all index arithmetic is 32-bit shifts and masks (TH, TW and CS are
//   powers of two): nothing is divided in the tap loop;
// - s8 codes are staged in shared memory and stored as 16-byte rows (8, 4
//   or 1 bytes where C is not a multiple of 16); f32 goes out as float4.
// The epilogue's colsum term is 0.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each entry point returns a CUDA error code (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per qconv1x1 CTA (8 warps)

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

__device__ __forceinline__ int8_t requant_code(float y, float inv_scale, float zp_off) {
  float q = rintf(__fadd_rn(__fmul_rn(y, inv_scale), zp_off));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ int8_t requant_code(float y, const float* s) {
  return requant_code(y, s[2], s[3]);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `bytes` (16 or 8) global -> shared, zeros where !valid (source size 0)
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
}

// bytes src[0:min(4, valid)] (zeros after) as one little-endian word: four
// independent read-only loads, for rows that are not 4-byte aligned
__device__ __forceinline__ uint32_t load4(const int8_t* src, int valid) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + i))) << (8 * i);
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct QParams {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const int* colsum;
  const float* s;
  void* out;
  int M, K, N, act, requant;
  int bm, bn, split, kpr, stages;
  // derived by the host from the plan
  int ldx, slot, off_wt, off_ab, ldc, xcopy, wcopy, vec_out;
};

// Pointwise conv as an M x K by K x N s8 product, one bm x bn output tile
// per cluster of `split` CTAs (see the note at the head of the file).
template <int BK>
__global__ void __launch_bounds__(NT, 3) qconv1x1_kernel(const QParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m0 = blockIdx.y * p.bm, n0 = (blockIdx.x / p.split) * p.bn;
  const int wm_n = p.bm / 32, wn_n = (NT / 32) / wm_n;
  const int wm = warp / wn_n, wn = warp - wm * wn_n;
  const int wtile = p.bn / wn_n, nt8 = wtile / 8;   // warp tile 32 x wtile
  const int ksteps = (p.K + BK - 1) / BK;
  const int kbeg = rank * p.kpr, kend = min(ksteps, kbeg + p.kpr);
  const int total = max(0, kend - kbeg);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t wt = sbase + p.off_wt;   // [bn][ldx]: w transposed, k contiguous
  float* alpha_s = reinterpret_cast<float*>(smem + p.off_ab);
  float* beta_s = alpha_s + p.bn;
  int* ct = reinterpret_cast<int*>(smem);  // [bm][ldc] s32, after the K loop
  float* stage = reinterpret_cast<float*>(smem + p.bm * p.ldc * 4);   // [bm][bn] outputs

  // one K step: x rows [m0, m0+bm) x [k0, k0+BK) -> [bm][ldx]; w rows
  // [k0, k0+BK) x [n0, n0+bn) -> [BK][bn], by cp.async of 16 or 8 bytes
  // (zero-filled outside M, K and N), or byte by byte where K or N is odd
  auto issue = [&](int step, int slot) {
    const int k0 = (kbeg + step) * BK;
    const uint32_t xs = sbase + slot * p.slot;
    const uint32_t ws = xs + p.bm * p.ldx;
    if (p.xcopy) {
      const int per_row = BK / p.xcopy;
      for (int idx = t; idx < p.bm * per_row; idx += NT) {
        const int r = idx / per_row, c = (idx - r * per_row) * p.xcopy;
        const bool ok = m0 + r < p.M && k0 + c < p.K;
        cp_async(xs + r * p.ldx + c, ok ? p.x + static_cast<size_t>(m0 + r) * p.K + k0 + c : p.x,
                 ok, p.xcopy);
      }
    } else {
      unsigned char* xg = smem + slot * p.slot;
      for (int idx = t; idx < p.bm * (BK / 4); idx += NT) {
        const int r = idx / (BK / 4), c = (idx - r * (BK / 4)) * 4;
        const int8_t* src = p.x + static_cast<size_t>(m0 + r) * p.K + k0 + c;
        *reinterpret_cast<uint32_t*>(xg + r * p.ldx + c) =
            m0 + r < p.M ? load4(src, p.K - k0 - c) : 0u;
      }
    }
    if (p.wcopy) {
      const int per_row = p.bn / p.wcopy;
      for (int idx = t; idx < BK * per_row; idx += NT) {
        const int r = idx / per_row, c = (idx - r * per_row) * p.wcopy;
        const bool ok = k0 + r < p.K && n0 + c < p.N;
        cp_async(ws + r * p.bn + c, ok ? p.w + static_cast<size_t>(k0 + r) * p.N + n0 + c : p.w,
                 ok, p.wcopy);
      }
    } else {
      unsigned char* wg = smem + slot * p.slot + p.bm * p.ldx;
      const int per_row = p.bn / 4;
      for (int idx = t; idx < BK * per_row; idx += NT) {
        const int r = idx / per_row, c = (idx - r * per_row) * 4;
        const int8_t* src = p.w + static_cast<size_t>(k0 + r) * p.N + n0 + c;
        *reinterpret_cast<uint32_t*>(wg + r * p.bn + c) =
            k0 + r < p.K ? load4(src, p.N - n0 - c) : 0u;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < total) issue(s, s);
    cp_commit();
  }
  // per-channel affine terms, read by the epilogue (after the first copies
  // are on their way); the scalars stay in registers
  const float s0 = p.s[0], s1 = p.s[1], s2 = p.s[2], s3 = p.s[3];
  if (t < p.bn) {
    const int gn = n0 + t;
    float a = 0.f, b = 0.f;
    if (gn < p.N) {
      const float sv[2] = {s0, s1};
      affine(sv, p.wscale[gn], p.bias[gn], __int2float_rn(p.colsum[gn]), a, b);
    }
    alpha_s[t] = a;
    beta_s[t] = b;
  }
  const bool clamp = p.act == ACT_RELU || p.act == ACT_RELU6, leaky = p.act == ACT_LEAKY;
  const float hi = p.act == ACT_RELU6 ? 6.f : __int_as_float(0x7f800000);
  for (int step = 0; step < total; ++step) {
    if (p.stages >= 3)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      cp_wait_all();
    __syncthreads();   // this step's tiles landed; the last step's mma is done
    const int nxt = step + p.stages - 1;
    if (nxt < total) issue(nxt, nxt % p.stages);
    cp_commit();
    // s8 mma wants both operands k-contiguous: transpose the [BK][bn] w
    // tile into wt [bn][ldx], 4x4 bytes per thread and round (byte_perm)
    {
      const unsigned char* wsrc = smem + (step % p.stages) * p.slot + p.bm * p.ldx;
      unsigned char* wdst = smem + p.off_wt;
      const int nb4 = p.bn / 4;
      for (int idx = t; idx < (BK / 4) * nb4; idx += NT) {
        const int k = (idx / nb4) * 4, c = (idx - (idx / nb4) * nb4) * 4;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wsrc + (k + 0) * p.bn + c);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wsrc + (k + 1) * p.bn + c);
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(wsrc + (k + 2) * p.bn + c);
        const uint32_t r3 = *reinterpret_cast<const uint32_t*>(wsrc + (k + 3) * p.bn + c);
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
        *reinterpret_cast<uint32_t*>(wdst + (c + 0) * p.ldx + k) = __byte_perm(t0, t1, 0x5410);
        *reinterpret_cast<uint32_t*>(wdst + (c + 1) * p.ldx + k) = __byte_perm(t0, t1, 0x7632);
        *reinterpret_cast<uint32_t*>(wdst + (c + 2) * p.ldx + k) = __byte_perm(t2, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(wdst + (c + 3) * p.ldx + k) = __byte_perm(t2, t3, 0x7632);
      }
    }
    __syncthreads();
    const uint32_t xs = sbase + (step % p.stages) * p.slot;
    const uint32_t a_row = xs + (wm * 32 + (lane & 15)) * p.ldx + (lane >> 4) * 16;
    const uint32_t b_row =
        wt + (wn * wtile + (lane & 7) + ((lane >> 4) << 3)) * p.ldx + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t fa[2][4];
      ldsm_x4(fa[0], a_row + kk * 32);
      ldsm_x4(fa[1], a_row + 16 * p.ldx + kk * 32);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        if (2 * jp >= nt8) break;
        uint32_t fb[4];
        ldsm_x4(fb, b_row + jp * 16 * p.ldx + kk * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * jp], fa[i], fb[0], fb[1]);
          mma_s8(acc[i][2 * jp + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  }
  cp_wait_all();
  __syncthreads();   // the ring is free: stage the s32 tile there

  if (p.split == 1 && p.requant) {
    // one CTA holds the whole sum: the epilogue runs on the accumulators
    // in registers, the s8 codes are staged as bytes [bm][bn] and stored as
    // 16-byte rows (a quarter of the shared-memory traffic of the s32 tile)
    unsigned char* codes = smem;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nt8) break;
      const int c = wn * wtile + j * 8 + (lane & 3) * 2;
      const float2 al = *reinterpret_cast<const float2*>(alpha_s + c);
      const float2 bt = *reinterpret_cast<const float2*>(beta_s + c);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
          float u[2] = {__fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), al.x), bt.x),
                        __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), al.y), bt.y)};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            u[q] = clamp ? fminf(fmaxf(u[q], 0.f), hi) : u[q];
            u[q] = leaky && !(u[q] > 0.f) ? __fmul_rn(0.1f, u[q]) : u[q];
            if (p.act == ACT_LOGISTIC) u[q] = 1.f / (1.f + expf(-u[q]));
          }
          *reinterpret_cast<uint16_t*>(codes + r * p.bn + c) = static_cast<uint16_t>(
              static_cast<uint8_t>(requant_code(u[0], s2, s3)) |
              static_cast<uint16_t>(static_cast<uint8_t>(requant_code(u[1], s2, s3))) << 8);
        }
    }
    __syncthreads();
    const int g16 = p.bn / 16, cols = min(p.bn, p.N - n0);
    int8_t* out = static_cast<int8_t*>(p.out);
    if (p.vec_out) {
      for (int idx = t; idx < p.bm * g16; idx += NT) {
        const int r = idx / g16, c = (idx - r * g16) * 16;
        if (m0 + r < p.M && c < cols)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * p.N + n0 + c) =
              *reinterpret_cast<const uint4*>(codes + r * p.bn + c);
      }
    } else {   // rows not 16-byte aligned: consecutive threads, consecutive bytes
      for (int idx = t; idx < p.bm * cols; idx += NT) {
        const int r = idx / cols, c = idx - r * cols;
        if (m0 + r < p.M)
          out[static_cast<size_t>(m0 + r) * p.N + n0 + c] =
              static_cast<int8_t>(codes[r * p.bn + c]);
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nt8) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int c = wn * wtile + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<int2*>(ct + r * p.ldc + c) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  if (p.split > 1)
    cluster.sync();   // every rank's partial tile is staged
  else
    __syncthreads();

  // rows [r0, r1) of the tile are this rank's: add the ranks' partials
  // (16 channels at a time, int4 loads, distributed shared memory, all
  // ranks' loads in flight together), then the epilogue and 16-byte stores
  // (16 s8 or 4 x 4 f32)
  const int rpr = (p.bm + p.split - 1) / p.split;
  const int r0 = rank * rpr, r1 = min(p.bm, r0 + rpr);
  const int g16 = p.bn / 16;
  for (int idx = t; idx < (r1 - r0) * g16; idx += NT) {
    const int r = r0 + idx / g16, c = (idx - (idx / g16) * g16) * 16;
    const int gm = m0 + r;
    int v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= p.split) break;
      const int* part = p.split > 1 ? cluster.map_shared_rank(ct, q) : ct;
      const int4* src = reinterpret_cast<const int4*>(part + r * p.ldc + c);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int4 u = src[g];
        v[4 * g] += u.x;
        v[4 * g + 1] += u.y;
        v[4 * g + 2] += u.z;
        v[4 * g + 3] += u.w;
      }
    }
    if (gm >= p.M) continue;
    // the epilogue of affine/epilogue/requant_code, with the scalars and
    // the activation decoded once: the same rounded operations in order
    float y[16];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 al = *reinterpret_cast<const float4*>(alpha_s + c + 4 * g);
      const float4 bt = *reinterpret_cast<const float4*>(beta_s + c + 4 * g);
      const float av[4] = {al.x, al.y, al.z, al.w}, bv[4] = {bt.x, bt.y, bt.z, bt.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float u = __fadd_rn(__fmul_rn(__int2float_rn(v[4 * g + q]), av[q]), bv[q]);
        u = clamp ? fminf(fmaxf(u, 0.f), hi) : u;
        u = leaky && !(u > 0.f) ? __fmul_rn(0.1f, u) : u;
        if (p.act == ACT_LOGISTIC) u = 1.f / (1.f + expf(-u));
        y[4 * g + q] = u;
      }
    }
    const int gn = n0 + c;
    if (!p.vec_out) {
      // rows not 16-byte aligned (N 75): stage the tile, stored below with
      // consecutive threads on consecutive elements
      if (p.requant) {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          reinterpret_cast<int8_t*>(stage)[r * p.bn + c + q] = requant_code(y[q], s2, s3);
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) stage[r * p.bn + c + q] = y[q];
      }
      continue;
    }
    if (gn >= p.N) continue;   // N is a multiple of 16 here: groups are whole or out
    const size_t o = static_cast<size_t>(gm) * p.N + gn;
    if (p.requant) {
      uint32_t w4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 16; ++q)
        w4[q / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(requant_code(y[q], s2, s3)))
                     << (8 * (q % 4));
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + o) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
    } else {
      float* of = static_cast<float*>(p.out) + o;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        reinterpret_cast<float4*>(of)[g] =
            make_float4(y[4 * g], y[4 * g + 1], y[4 * g + 2], y[4 * g + 3]);
    }
  }
  if (!p.vec_out) {
    __syncthreads();
    const int cols = min(p.bn, p.N - n0);
    for (int idx = t; idx < (r1 - r0) * cols; idx += NT) {
      const int r = r0 + idx / cols, cc = idx - (idx / cols) * cols;
      if (m0 + r >= p.M) continue;
      const size_t o = static_cast<size_t>(m0 + r) * p.N + n0 + cc;
      if (p.requant)
        static_cast<int8_t*>(p.out)[o] = reinterpret_cast<const int8_t*>(stage)[r * p.bn + cc];
      else
        static_cast<float*>(p.out)[o] = stage[r * p.bn + cc];
    }
  }
  if (p.split > 1) cluster.sync();   // no rank exits while a peer reads its tile
}

struct DwParams {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const float* s;
  void* out;
  int H, W, C, Ho, Wo, act, requant;
  int th, tw, cs, cw;   // the plan
  int tiles_x, tiles_y, slices;
  // derived by dwlayout from the plan: the window, weights, w_scale and
  // bias (buf bytes), then the staged codes
  int wr, wc, rp, sp, off_w, off_ab, buf;
  int lg_th, lg_tw, lg_cs, lg_cw;
};

constexpr int DW_PX = 4;   // output columns per thread
constexpr int DW_LG_PX = 2;   // log2(DW_PX)

int ilog2(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

// Shared-memory layout of the depthwise kernel; returns its bytes, -1 for a
// plan the kernel does not take. ops/qconv.py::qdwconv3x3_smem_bytes is the
// same formula, and the launch refuses a mismatch.
int dwlayout(DwParams& p, int stride) {
  auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if (!pow2(p.th) || p.th > 64 || !pow2(p.tw) || p.tw < DW_PX || p.tw > 64 ||
      !pow2(p.cs) || p.cs < 4 || p.cs > 256 || p.cw > p.cs ||
      (p.cw != 16 && p.cw != 8 && p.cw != 4 && p.cw != 1) || p.C % p.cw)
    return -1;
  p.wr = (p.th - 1) * stride + 3;
  p.wc = (p.tw - 1) * stride + 3;
  // rows of the window padded to 128 bytes and then skewed, so the rows a
  // warp reads fall on other banks
  const int skew = (stride == 1 ? p.cs : p.cs / 2) % 128;
  p.rp = (p.wc * p.cs + 127) / 128 * 128 + (skew > 16 ? skew : 16);
  p.off_w = p.wr * p.rp;                     // s8 weights [9][cs]
  p.off_ab = p.off_w + (9 * p.cs + 15) / 16 * 16;   // f32 w_scale [cs], bias [cs]
  p.buf = p.off_ab + 8 * p.cs;
  // s8 codes [th][sp], the rows skewed like the window's (a warp writes
  // 32 / (cs / 4) consecutive rows)
  p.sp = p.tw * p.cs + (p.cs % 128 > 16 ? p.cs % 128 : 16);
  p.lg_th = ilog2(p.th);
  p.lg_tw = ilog2(p.tw);
  p.lg_cs = ilog2(p.cs);
  p.lg_cw = ilog2(p.cw);
  return p.buf + p.th * p.sp;
}

// f32 value of byte v (0-3) of a word of four s8 codes, exactly: the byte
// + 128 as the low mantissa bits of 2^23, minus 2^23 + 128
__device__ __forceinline__ float s8_to_f32(uint32_t biased, int v) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u,
                                                               0x7440u | v))),
                   8388736.f);
}

// The s8 code of y as the low byte of the returned bits: requant_code's
// rounded steps, with the clamp before the rounding (the bounds are
// integers, so the order does not matter) and rint done by adding 1.5 * 2^23
// in round-to-nearest-even, which leaves the integer in the low mantissa
// bits: full-rate adds where rintf and the f32 -> s32 conversion run at a
// quarter of the rate or less.
__device__ __forceinline__ uint32_t requant_bits(float y, float inv_scale, float zp_off) {
  const float q = fminf(fmaxf(__fadd_rn(__fmul_rn(y, inv_scale), zp_off), -128.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// One output pixel's V channels: the epilogue of affine/epilogue/
// requant_code in the same rounded steps, into the staged codes (s8) or
// straight out as f32.
template <int V>
__device__ __forceinline__ void dw_out(const DwParams& p, unsigned char* stage, int n,
                                       int c0, int cl, int ty, int px, int oy, int ox,
                                       const float (&acc)[V], const float (&al)[V],
                                       const float (&bt)[V], const float (&sc)[4]) {
  const bool relu = p.act == ACT_RELU || p.act == ACT_RELU6;
  float y[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float e = __fadd_rn(__fmul_rn(acc[v], al[v]), bt[v]);
    if (relu) e = fmaxf(e, 0.f);
    if (p.act == ACT_RELU6) e = fminf(e, 6.f);
    if (p.act == ACT_LEAKY) e = e > 0.f ? e : __fmul_rn(0.1f, e);
    if (p.act == ACT_LOGISTIC) e = 1.f / (1.f + expf(-e));
    y[v] = e;
  }
  if (p.requant) {
    unsigned char* sp = stage + ty * p.sp + (px << p.lg_cs) + cl;
    if constexpr (V == 4) {
      const uint32_t lo = __byte_perm(requant_bits(y[0], sc[2], sc[3]),
                                      requant_bits(y[1], sc[2], sc[3]), 0x0040u);
      const uint32_t hi = __byte_perm(requant_bits(y[2], sc[2], sc[3]),
                                      requant_bits(y[3], sc[2], sc[3]), 0x0040u);
      *reinterpret_cast<uint32_t*>(sp) = __byte_perm(lo, hi, 0x5410u);
    } else {
      *sp = static_cast<unsigned char>(requant_bits(y[0], sc[2], sc[3]));
    }
  } else if (oy < p.Ho && ox < p.Wo && c0 + cl < p.C) {
    float* of = static_cast<float*>(p.out) + static_cast<size_t>(n) * p.Ho * p.Wo * p.C +
                (oy * p.Wo + ox) * p.C + c0 + cl;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(of) = make_float4(y[0], y[1], y[2], y[3]);
    else
      *of = y[0];
  }
}

// Unit u of the CTA: V channels (from cl), one row (ty) and DW_PX columns
// (from gx); channels fastest, then rows, then column groups, so a warp's
// reads of the window fall on the bank-skewed rows.
struct DwUnit {
  int cl, ty, gx;
};

__device__ __forceinline__ DwUnit dw_unit(const DwParams& p, int u, int lg_cg) {
  return {(u & ((1 << lg_cg) - 1)) << (p.lg_cs - lg_cg), (u >> lg_cg) & (p.th - 1),
          u >> (lg_cg + p.lg_th)};
}

// The taps in f32 in the TPU kernel's order: for each output, over (kh, kw),
// acc += w * (tap - x_off) with the multiply and the add rounded apart.
template <int V, int S>
__device__ __forceinline__ void dw_units_f32(const DwParams& p, const unsigned char* buf,
                                             unsigned char* stage, int n, int oy0, int ox0,
                                             int c0, const float (&sc)[4]) {
  constexpr int SL = (DW_PX - 1) * S + 3;          // window columns a unit reads
  const unsigned char* wsm = buf + p.off_w;
  const float* wsc = reinterpret_cast<const float*>(buf + p.off_ab);
  const float* bsc = wsc + p.cs;
  const float x_off = __fsub_rn(sc[1], 128.f);
  const int lg_cg = p.lg_cs - (V == 4 ? 2 : 0);
  const int units = 1 << (lg_cg + p.lg_th + p.lg_tw - DW_LG_PX);
  for (int u = threadIdx.x; u < units; u += 256) {
    const DwUnit un = dw_unit(p, u, lg_cg);
    float wk[9][V];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if constexpr (V == 4) {
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(wsm + (k << p.lg_cs) + un.cl) ^ 0x80808080u;
#pragma unroll
        for (int v = 0; v < 4; ++v) wk[k][v] = s8_to_f32(word, v);
      } else {
        wk[k][0] = static_cast<float>(static_cast<int8_t>(wsm[(k << p.lg_cs) + un.cl]));
      }
    }
    float acc[DW_PX][V];
#pragma unroll
    for (int q = 0; q < DW_PX; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = 0.f;
    const unsigned char* base =
        buf + un.ty * S * p.rp + ((un.gx * DW_PX * S) << p.lg_cs) + un.cl;
    // rows and columns ascend, so each output takes its taps in (kh, kw)
    // order
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const unsigned char* row = base + kh * p.rp;
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        float d[V];
        if constexpr (V == 4) {
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(row + (j << p.lg_cs)) ^ 0x80808080u;
#pragma unroll
          for (int v = 0; v < 4; ++v) d[v] = __fsub_rn(s8_to_f32(word, v), x_off);
        } else {
          d[0] = __fsub_rn(static_cast<float>(static_cast<int8_t>(row[j << p.lg_cs])), x_off);
        }
#pragma unroll
        for (int q = 0; q < DW_PX; ++q) {
          const int kw = j - q * S;
          if (kw < 0 || kw > 2) continue;
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[q][v] = __fadd_rn(acc[q][v], __fmul_rn(wk[kh * 3 + kw][v], d[v]));
        }
      }
    }
    float al[V], bt[V];
    const float sv[2] = {sc[0], sc[1]};
#pragma unroll
    for (int v = 0; v < V; ++v) affine(sv, wsc[un.cl + v], bsc[un.cl + v], 0.f, al[v], bt[v]);
#pragma unroll
    for (int q = 0; q < DW_PX; ++q)
      dw_out<V>(p, stage, n, c0, un.cl, un.ty, un.gx * DW_PX + q, oy0 + un.ty,
                ox0 + un.gx * DW_PX + q, acc[q], al, bt, sc);
  }
}

// 4x4 byte transpose: word v of the result holds byte v of a, b, c, d
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&t)[4]) {
  const uint32_t ab02 = __byte_perm(a, b, 0x5140u), cd02 = __byte_perm(c, d, 0x5140u);
  const uint32_t ab13 = __byte_perm(a, b, 0x7362u), cd13 = __byte_perm(c, d, 0x7362u);
  t[0] = __byte_perm(ab02, cd02, 0x5410u);
  t[1] = __byte_perm(ab02, cd02, 0x7632u);
  t[2] = __byte_perm(ab13, cd13, 0x5410u);
  t[3] = __byte_perm(ab13, cd13, 0x7632u);
}

// The taps as integer dot products where the zero point is an integer:
// sum w * (x - x_off) = sum w * x - x_off * sum w exactly, so the f32 sum of
// the TPU kernel's order (exact here: integers below 2^24) is this integer.
// Each window row's pixel words (4 channels each) are transposed into
// channel words of 4 pixels; an output's 3 taps of a row are one dp4a
// against [w(kh,0), w(kh,1), w(kh,2), 0] of its channel.
template <int S>
__device__ __forceinline__ void dw_units_dp4a(const DwParams& p, const unsigned char* buf,
                                              unsigned char* stage, int n, int oy0, int ox0,
                                              int c0, const float (&sc)[4]) {
  constexpr int SL = (DW_PX - 1) * S + 3;          // window columns a unit reads
  constexpr int NB = (SL + 3) / 4;                 // blocks of 4 pixels
  const unsigned char* wsm = buf + p.off_w;
  const float* wsc = reinterpret_cast<const float*>(buf + p.off_ab);
  const float* bsc = wsc + p.cs;
  const int xo = static_cast<int>(sc[1]) - 128;   // x_off, an integer here
  const int lg_cg = p.lg_cs - 2;
  const int units = 1 << (lg_cg + p.lg_th + p.lg_tw - DW_LG_PX);
  // the channel groups divide 256, so all of a thread's units have its
  // channels: their weights and constants are made once
  const int cl = (threadIdx.x & ((1 << lg_cg) - 1)) << 2;
  // wk[kh][v] = [w(kh,0), w(kh,1), w(kh,2), 0] of channel cl + v
  uint32_t wk[3][4];
  int kbias[4] = {0, 0, 0, 0};
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const unsigned char* wrow = wsm + ((kh * 3) << p.lg_cs) + cl;
    transpose4(*reinterpret_cast<const uint32_t*>(wrow),
               *reinterpret_cast<const uint32_t*>(wrow + p.cs),
               *reinterpret_cast<const uint32_t*>(wrow + 2 * p.cs), 0u, wk[kh]);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      kbias[v] = __dp4a(static_cast<int>(wk[kh][v]), 0x01010101, kbias[v]);
  }
  // the integer sum plus 1.5 * 2^23's bits is the f32 1.5 * 2^23 + sum
#pragma unroll
  for (int v = 0; v < 4; ++v) kbias[v] = 0x4B400000 - xo * kbias[v];
  float al[4], bt[4];
  const float sv[2] = {sc[0], sc[1]};
#pragma unroll
  for (int v = 0; v < 4; ++v) affine(sv, wsc[cl + v], bsc[cl + v], 0.f, al[v], bt[v]);
  for (int u = threadIdx.x; u < units; u += 256) {
    const DwUnit un = dw_unit(p, u, lg_cg);
    int acc[DW_PX][4];
#pragma unroll
    for (int q = 0; q < DW_PX; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[q][v] = 0;
    const unsigned char* base =
        buf + un.ty * S * p.rp + ((un.gx * DW_PX * S) << p.lg_cs) + un.cl;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const unsigned char* row = base + kh * p.rp;
      uint32_t px[NB * 4];
#pragma unroll
      for (int j = 0; j < NB * 4; ++j)
        px[j] = j < SL ? *reinterpret_cast<const uint32_t*>(row + (j << p.lg_cs)) : 0u;
      uint32_t ch[NB][4];                        // ch[b][v]: pixels 4b..4b+3 of channel v
#pragma unroll
      for (int b = 0; b < NB; ++b)
        transpose4(px[4 * b], px[4 * b + 1], px[4 * b + 2], px[4 * b + 3], ch[b]);
#pragma unroll
      for (int q = 0; q < DW_PX; ++q) {
        // pixels q*S .. q*S+2 of each channel: bytes (q*S % 4)... of block q*S / 4
        const int b = q * S / 4, o = q * S % 4;
        int x[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          x[v] = static_cast<int>(o == 0 ? ch[b][v]
                                         : __byte_perm(ch[b][v], ch[b + 1 < NB ? b + 1 : b][v],
                                                       (o | (o + 1) << 4 | (o + 2) << 8 |
                                                        (o + 3) << 12)));
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[q][v] = __dp4a(x[v], static_cast<int>(wk[kh][v]), acc[q][v]);
      }
    }
#pragma unroll
    for (int q = 0; q < DW_PX; ++q) {
      float a[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) a[v] = __fsub_rn(__int_as_float(acc[q][v] + kbias[v]), 12582912.f);
      dw_out<4>(p, stage, n, c0, un.cl, un.ty, un.gx * DW_PX + q, oy0 + un.ty,
                ox0 + un.gx * DW_PX + q, a, al, bt, sc);
    }
  }
}

// `bytes` (16, 8, 4 or 1) global -> shared: cp.async, or a plain byte copy
__device__ __forceinline__ void dw_copy(int bytes, unsigned char* dst, const int8_t* src) {
  const uint32_t d = smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    *dst = static_cast<unsigned char>(__ldg(src));
}

// Everything one tile reads from device memory, put in flight at once into
// `buf`: the window's pixels inside the image by cp.async (the pad code
// stored where the window leaves the image), the CS-channel slices of the
// weights (s8 [9][cs]), w_scale and bias (f32 [cs] each). Warps take window
// rows, lanes cw-byte chunks of a row. Commits one cp.async group.
template <int S>
__device__ __forceinline__ void dw_issue(const DwParams& p, unsigned char* buf,
                                         const int8_t* ximg, int oy0, int ox0, int c0,
                                         uint32_t pad8) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
  const int lg_k = p.lg_cs - p.lg_cw, per_row = p.wc << lg_k;
  for (int r = warp; r < p.wr; r += 8) {
    const int iy = iy0 + r;
    if (iy < 0 || iy >= p.H) continue;
    for (int j = lane; j < per_row; j += 32) {
      const int col = j >> lg_k, cc = (j & ((1 << lg_k) - 1)) << p.lg_cw;
      const int ix = ix0 + col;
      if (ix < 0 || ix >= p.W || c0 + cc >= p.C) continue;   // pad, or never stored
      dw_copy(p.cw, buf + r * p.rp + (col << p.lg_cs) + cc,
              ximg + (iy * p.W + ix) * p.C + c0 + cc);
    }
  }
  unsigned char* wsm = buf + p.off_w;
  float* wsc = reinterpret_cast<float*>(buf + p.off_ab);
  float* bsc = wsc + p.cs;
  for (int i = t; i < 9 << lg_k; i += 256) {
    const int tap = i >> lg_k, cc = (i & ((1 << lg_k) - 1)) << p.lg_cw;
    if (c0 + cc < p.C) dw_copy(p.cw, wsm + tap * p.cs + cc, p.w + tap * p.C + c0 + cc);
  }
  for (int i = t; i < p.cs / 2; i += 256) {   // 4 floats a copy, zeros beyond C
    const int c = c0 + (i & (p.cs / 4 - 1)) * 4;
    const float* src = (i < p.cs / 4 ? p.wscale : p.bias) + c;
    const int valid = 4 * max(0, min(4, p.C - c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32((i < p.cs / 4 ? wsc : bsc) + c - c0)),
                 "l"(valid ? src : p.bias), "r"(valid)
                 : "memory");
  }
  cp_commit();
  const uint32_t pad = pad8 * 0x01010101u;
  for (int r = warp; r < p.wr; r += 8) {
    const int iy = iy0 + r;
    const bool row_in = iy >= 0 && iy < p.H;
    for (int j = lane; j < per_row; j += 32) {
      const int col = j >> lg_k, cc = (j & ((1 << lg_k) - 1)) << p.lg_cw;
      const int ix = ix0 + col;
      if ((row_in && ix >= 0 && ix < p.W) || c0 + cc >= p.C) continue;
      unsigned char* dst = buf + r * p.rp + (col << p.lg_cs) + cc;
      if (p.cw == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(pad, pad, pad, pad);
      else if (p.cw == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(pad, pad);
      else if (p.cw == 4)
        *reinterpret_cast<uint32_t*>(dst) = pad;
      else
        *dst = static_cast<unsigned char>(pad8);
    }
  }
}

// Depthwise 3x3, pad 1, stride S, V channels a thread (4, or 1 where C % 4
// != 0), one output tile per CTA (see the note at the head of the file).
template <int V, int S>
__global__ void __launch_bounds__(256, 4) qdw3x3_kernel(const DwParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const float s0 = p.s[0], s1 = p.s[1], s2 = p.s[2], s3 = p.s[3];
  const float sc[4] = {s0, s1, s2, s3};
  const uint32_t pad8 = static_cast<uint8_t>(static_cast<int>(rintf(s1)) - 128);
  // tile index -> (image, tile origin, channel slice); the channel slices of
  // a tile are neighbours, so the slices of one pixel's row are read from
  // device memory at about the same time
  const int per_img = p.tiles_x * p.tiles_y * p.slices;
  const int n = blockIdx.x / per_img, rem = blockIdx.x - n * per_img;
  const int tile = rem / p.slices, c0 = (rem - tile * p.slices) * p.cs;
  const int ty0 = tile / p.tiles_x;
  const int oy0 = ty0 * p.th, ox0 = (tile - ty0 * p.tiles_x) * p.tw;
  dw_issue<S>(p, smem, p.x + static_cast<size_t>(n) * p.H * p.W * p.C, oy0, ox0, c0, pad8);
  cp_wait_all();
  __syncthreads();        // the window, weights and constants landed
  unsigned char* stage = smem + p.buf;
  // the dp4a path's integers stay below 2^22 for a zero point in [0, 255]
  if (V == 4 && s1 == rintf(s1) && s1 >= 0.f && s1 <= 255.f)
    dw_units_dp4a<S>(p, smem, stage, n, oy0, ox0, c0, sc);
  else
    dw_units_f32<V, S>(p, smem, stage, n, oy0, ox0, c0, sc);
  if (!p.requant) return;
  __syncthreads();        // the codes are staged
  // the staged codes out, cw bytes a thread (16 where C % 16 == 0)
  int8_t* oimg = static_cast<int8_t*>(p.out) + static_cast<size_t>(n) * p.Ho * p.Wo * p.C;
  const int lg_k = p.lg_cs - p.lg_cw;
  const int chunks = 1 << (lg_k + p.lg_tw + p.lg_th);
  for (int j = t; j < chunks; j += 256) {
    const int cc = (j & ((1 << lg_k) - 1)) << p.lg_cw;
    const int px = (j >> lg_k) & (p.tw - 1), ty = j >> (lg_k + p.lg_tw);
    const int oy = oy0 + ty, ox = ox0 + px;
    if (oy >= p.Ho || ox >= p.Wo || c0 + cc >= p.C) continue;
    const unsigned char* sp = stage + ty * p.sp + (px << p.lg_cs) + cc;
    int8_t* dst = oimg + (oy * p.Wo + ox) * p.C + c0 + cc;
    if (p.cw == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(sp);
    else if (p.cw == 8)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(sp);
    else if (p.cw == 4)
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(sp);
    else
      *dst = static_cast<int8_t>(*sp);
  }
}

int qlayout(QParams& p, int bk) {
  const int ksteps = (p.K + bk - 1) / bk;
  if ((p.bm != 64 && p.bm != 128) || (bk != 32 && bk != 64 && bk != 128) || p.bn < 32 ||
      p.bn % 32 || p.split < 1 || p.split > 8 || p.kpr < 1 || p.split * p.kpr < ksteps ||
      (p.split - 1) * p.kpr >= ksteps || p.stages < 2 || p.stages > 3)
    return -1;
  const int wtile = p.bn / ((NT / 32) / (p.bm / 32));
  if (wtile % 16 || wtile > 32) return -1;
  p.ldx = bk + 16;
  p.slot = p.bm * p.ldx + bk * p.bn;
  p.off_wt = p.stages * p.slot;
  p.ldc = p.bn + 4;
  // the s32 tile [bm][ldc] and, for rows not 16-byte aligned, the staged
  // outputs [bm][bn] (4 bytes each) after it, both over the ring
  const int ring = p.off_wt + p.bn * p.ldx, tile = p.bm * p.ldc * 4 + p.bm * p.bn * 4;
  p.off_ab = ring > tile ? ring : tile;
  return p.off_ab + 8 * p.bn;
}

}  // namespace

extern "C" int qconv1x1_launch(const void* x, const void* w, const void* wscale,
                               const void* bias, const void* colsum,
                               const void* scalars, void* out, int m, int k,
                               int n, int act, int requant, int bm, int bn, int bk,
                               int split, int kpr, int stages, int smem, void* stream) {
  QParams prm{};
  prm.x = static_cast<const int8_t*>(x);
  prm.w = static_cast<const int8_t*>(w);
  prm.wscale = static_cast<const float*>(wscale);
  prm.bias = static_cast<const float*>(bias);
  prm.colsum = static_cast<const int*>(colsum);
  prm.s = static_cast<const float*>(scalars);
  prm.out = out;
  prm.M = m; prm.K = k; prm.N = n; prm.act = act; prm.requant = requant;
  prm.bm = bm; prm.bn = bn; prm.split = split; prm.kpr = kpr; prm.stages = stages;
  if (qlayout(prm, bk) != smem || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  prm.xcopy = k % 16 == 0 && xa % 16 == 0 ? 16 : k % 8 == 0 && xa % 8 == 0 ? 8 : 0;
  prm.wcopy = n % 16 == 0 && wa % 16 == 0 ? 16 : n % 8 == 0 && wa % 8 == 0 ? 8 : 0;
  prm.vec_out = aligned16(out) && n % 16 == 0;   // else the staged store
  void (*kern)(QParams) = bk == 32 ? qconv1x1_kernel<32>
                          : bk == 64 ? qconv1x1_kernel<64> : qconv1x1_kernel<128>;
  // raise the shared-memory limit only when a larger one is needed (one
  // host call per size, not per launch); the process uses one device
  static int given[3] = {0, 0, 0};
  int& g = given[bk == 32 ? 0 : bk == 64 ? 1 : 2];
  cudaError_t err = cudaSuccess;
  if (smem > g) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(((n + bn - 1) / bn) * split),
                     static_cast<unsigned>((m + bm - 1) / bm), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(split);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qdw3x3_launch(const void* x, const void* w, const void* wscale,
                             const void* bias, const void* scalars, void* out,
                             int n, int h, int wd, int c, int stride, int act,
                             int requant, int th, int tw, int cs, int cw, int smem,
                             int grid, void* stream) {
  DwParams prm{};
  prm.x = static_cast<const int8_t*>(x);
  prm.w = static_cast<const int8_t*>(w);
  prm.wscale = static_cast<const float*>(wscale);
  prm.bias = static_cast<const float*>(bias);
  prm.s = static_cast<const float*>(scalars);
  prm.out = out;
  prm.H = h; prm.W = wd; prm.C = c; prm.act = act; prm.requant = requant;
  prm.th = th; prm.tw = tw; prm.cs = cs; prm.cw = cw;
  if ((stride != 1 && stride != 2) || (stride == 2 && (h % 2 || wd % 2)) || n < 1 ||
      n > 65535 || h < 1 || wd < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.Ho = h / stride;
  prm.Wo = wd / stride;
  // 32-bit offsets within one image, f32 output included
  if (static_cast<long long>(h) * wd * c * 4 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = c % 4 == 0 ? 4 : 1;
  const uintptr_t al = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(w);
  const uintptr_t al16 = reinterpret_cast<uintptr_t>(wscale) | reinterpret_cast<uintptr_t>(bias);
  if (dwlayout(prm, stride) != smem || smem > 232448 || al % cw || al16 % 16 ||
      (!requant && v == 4 && reinterpret_cast<uintptr_t>(out) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.tiles_x = (prm.Wo + tw - 1) / tw;
  prm.tiles_y = (prm.Ho + th - 1) / th;
  prm.slices = (c + cs - 1) / cs;
  // one CTA a tile: the plan's grid must be the tile count
  if (static_cast<long long>(prm.tiles_x) * prm.tiles_y * prm.slices * n != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(DwParams) = v == 4 ? (stride == 1 ? qdw3x3_kernel<4, 1> : qdw3x3_kernel<4, 2>)
                                  : (stride == 1 ? qdw3x3_kernel<1, 1> : qdw3x3_kernel<1, 2>);
  // raise the shared-memory limit only when a larger one is needed; the
  // process uses one device
  static int given[4] = {0, 0, 0, 0};
  int& g = given[(v == 4 ? 0 : 2) + stride - 1];
  if (smem > 48 * 1024 && smem > g) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g = smem;
  }
  kern<<<static_cast<unsigned>(grid), 256, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
