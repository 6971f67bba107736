// Int8 convolutions of the quantized serving path, for Hopper (sm_90a):
//
//   qconv1x1_s8: pointwise conv, s8 x s8 -> s32 on tensor cores;
//   qdwconv3x3_s8: depthwise 3x3, pad 1, stride 1 or 2, on CUDA cores;
//   qconv3x3_s8: dense 3x3, pad 1, stride 1 or 2, an implicit GEMM on
//     tensor cores (wgmma), with its own note after int8_sandwich's;
//   qgconv3x3_s8: grouped 3x3, pad 1, stride 1 or 2, group width 8, 16 or
//     24, on tensor cores (mma.sync), with its own note after qconv3x3's;
//
// all with the fused epilogue of the TPU kernels
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
  // one grid axis: the split CTAs of a tile neighbours, the row tiles
  // outermost (2^31 - 1 CTAs, past the 65,535 row tiles a y axis holds)
  const int per_row = ((p.N + p.bn - 1) / p.bn) * p.split;
  const int tile_m = static_cast<int>(blockIdx.x / per_row);
  const int m0 = tile_m * p.bm,
            n0 = ((static_cast<int>(blockIdx.x) - tile_m * per_row) / p.split) * p.bn;
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


// ---------------------------------------------------------------------------
// int8_sandwich: the f32 work of the int8 walk between a dequant and a
// requant (compress/quantized.py, Int8Inference in kernel mode), one launch
// a node, s8 in (f32 for the input) and s8 out. The f32 values stay in
// registers. It replaces no TPU kernel: the JAX package leaves these chains
// to XLA, which fuses them, while eager PyTorch runs each step as a launch
// that writes f32 (13 launches a shortcut). Three forms:
//
//   SW_INPUT     out = q(x)                                 x f32
//   SW_SHORTCUT  out = q(act(d0(a) + d1(b)))      act linear, relu or leaky
//   SW_ROUTE     out[..., off_j : off_j + C_j] = q(d_j(src_j)), j < nsrc
//
//   d_j(s) = (s - zo_j) * scale_j
//   q(y)   = clip(rint(y * (1 / scale_o) + zo_o), -128, 127)
//
// with zo = zp - 128. These are the steps of the PyTorch chain it replaces
// (ops/qconv.py::int8_sandwich_reference), each one rounded operation in
// the chain's order (__fsub_rn/__fmul_rn/__fadd_rn keep nvcc from
// contracting a multiply and an add into one FMA). The chain's division by
// the out scale, an f32 tensor over a Python scalar, runs on the card as a
// multiply by the f32 reciprocal of the f32 scalar (PyTorch's CUDA
// true-division kernel takes a CPU scalar so), which __frcp_rn gives bit
// for bit. The scalars ride in a device vector s = (scale_j, zo_j for each
// s8 source, then scale_o, zo_o) (ops/qconv.py::sandwich_scalars).
//
// What bounds it: bytes. Each input byte is read once and each output byte
// written once; a thread takes V output bytes a step, 16 where the element
// count (a route: every source's channel count) and the pointers allow,
// else 8, 4, 2 or 1 (a concat of 88 + 96 channels takes 8). A route of two
// or more sources finds its source by the output channel of the step's
// first byte (V divides every C_j, so a step never straddles two sources).
// Grid-stride loop over the steps, 32-bit indices (the wrapper keeps the
// element count under 2^31).
constexpr int SW_MAX_SRC = 8;
enum SwForm { SW_INPUT = 0, SW_SHORTCUT = 1, SW_ROUTE = 2 };

struct SwParams {
  const void* src[SW_MAX_SRC];
  int c[SW_MAX_SRC];     // channels of each source (route)
  int off[SW_MAX_SRC];   // its first channel in the output (route)
  int nsrc, ctot, act;
  unsigned steps;        // output bytes / V
  const float* s;
  int8_t* out;
};

template <int V> struct SwWord;
template <> struct SwWord<16> { using T = uint4; };
template <> struct SwWord<8> { using T = uint2; };
template <> struct SwWord<4> { using T = unsigned int; };
template <> struct SwWord<2> { using T = unsigned short; };
template <> struct SwWord<1> { using T = unsigned char; };

template <int V>
union SwBytes {
  typename SwWord<V>::T w;
  int8_t b[V];
};

template <int V>
__device__ __forceinline__ SwBytes<V> sw_load(const void* base, unsigned step) {
  SwBytes<V> v;
  v.w = __ldg(static_cast<const typename SwWord<V>::T*>(base) + step);
  return v;
}

__device__ __forceinline__ float sw_dequant(int8_t s, float scale, float zo) {
  return __fmul_rn(__fsub_rn(static_cast<float>(s), zo), scale);
}

template <int V, int FORM>
__global__ void __launch_bounds__(256) sandwich_kernel(const SwParams p) {
  const int nq = FORM == SW_INPUT ? 0 : FORM == SW_SHORTCUT ? 2 : p.nsrc;
  const float rcp = __frcp_rn(__ldg(p.s + 2 * nq)), zo_o = __ldg(p.s + 2 * nq + 1);
  for (unsigned step = blockIdx.x * blockDim.x + threadIdx.x; step < p.steps;
       step += gridDim.x * blockDim.x) {
    SwBytes<V> o;
    if constexpr (FORM == SW_INPUT) {
      const float* x = static_cast<const float*>(p.src[0]) + static_cast<size_t>(step) * V;
      float f[V];
      if constexpr (V >= 4) {
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(x) + k);
          f[4 * k] = q.x; f[4 * k + 1] = q.y; f[4 * k + 2] = q.z; f[4 * k + 3] = q.w;
        }
      } else if constexpr (V == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(x));
        f[0] = q.x; f[1] = q.y;
      } else {
        f[0] = __ldg(x);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) o.b[i] = requant_code(f[i], rcp, zo_o);
    } else if constexpr (FORM == SW_SHORTCUT) {
      const SwBytes<V> a = sw_load<V>(p.src[0], step), b = sw_load<V>(p.src[1], step);
      const float sa = __ldg(p.s), za = __ldg(p.s + 1), sb = __ldg(p.s + 2),
                  zb = __ldg(p.s + 3);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = __fadd_rn(sw_dequant(a.b[i], sa, za), sw_dequant(b.b[i], sb, zb));
        o.b[i] = requant_code(apply_act(p.act, y), rcp, zo_o);
      }
    } else {
      int j = 0;
      unsigned at = step;
      if (p.nsrc > 1) {
        const unsigned e = step * V, pixel = e / p.ctot, c = e - pixel * p.ctot;
        while (j + 1 < p.nsrc && c >= static_cast<unsigned>(p.off[j + 1])) ++j;
        at = (pixel * p.c[j] + (c - p.off[j])) / V;
      }
      const SwBytes<V> a = sw_load<V>(p.src[j], at);
      const float sj = __ldg(p.s + 2 * j), zj = __ldg(p.s + 2 * j + 1);
#pragma unroll
      for (int i = 0; i < V; ++i) o.b[i] = requant_code(sw_dequant(a.b[i], sj, zj), rcp, zo_o);
    }
    reinterpret_cast<typename SwWord<V>::T*>(p.out)[step] = o.w;
  }
}

template <int FORM>
void (*sandwich_of(int v))(SwParams) {
  return v == 16 ? sandwich_kernel<16, FORM> : v == 8 ? sandwich_kernel<8, FORM>
         : v == 4 ? sandwich_kernel<4, FORM> : v == 2 ? sandwich_kernel<2, FORM>
                  : sandwich_kernel<1, FORM>;
}

// ---------------------------------------------------------------------------
// qconv3x3_s8: a dense 3x3 conv (groups 1, padding 1, stride 1 or 2) of
// NHWC s8 as an implicit GEMM on the tensor cores, with qconv1x1's fused
// epilogue. It replaces, for the dense 3x3s whose Cin is a multiple of 16
// (compress/quantized.py, Int8Inference in kernel mode), the port's im2col
// route: 3x3 patches written to device memory (9 x the input's bytes at
// stride 1) and read back by qconv1x1_s8. The JAX package has no such
// kernel: it runs its dense 3x3s up to Cin 115 as im2col into
// pqdet_tpu/ops/pallas_qconv.py::qconv1x1_s8 and wider ones as a bf16
// dequant conv. Same arithmetic as the route and as the plain version
// ops/qconv.py::qconv3x3_reference: the s32 sum over (kh, kw, cin) is
// exact (|sum| <= 9 * Cin * 128 * 127, under 2^31 to Cin 14,678), and the
// epilogue is qconv1x1's, step for rounded step, so every s8 code and f32
// output equals the route's bit for bit.
//
// What bounds it: operations. YOLOv3's dense 3x3s at 608 do 1,000-4,000
// operations per byte of input, weights and output, past the ~590 at which
// the tensor cores and not the memory are the limit; only the Cin-32 convs
// (K 288) sit near the line.
//
// Design (tiles and stages from the host's plan, ops/qconv.py::
// plan_qconv3x3, as plain ints):
// - a CTA of two warpgroups takes BM = 128 output pixels (rows in N*Ho*Wo
//   order, 64 a warpgroup) x BN = 64 or 128 output channels, two CTAs an
//   SM (BN = 256, one CTA an SM, was slower at every YOLOv3 shape);
// - K = 9 * Cin in (kh, kw, cin) order is walked in steps of 128 bytes. A
//   step's A tile is the BM pixels' input at the step's taps: each 16-byte
//   chunk of a row lies in one tap (Cin is a multiple of 16) and is copied
//   by cp.async straight from the input at (oy*s + kh - 1, ox*s + kw - 1);
//   a chunk outside the image gets the pad code rint(x_zp) - 128 (the
//   recentred zero point, the route's padding) by a shared-memory store,
//   and one past K gets zeros. No patch is written to device memory. The
//   B tile is BN rows of the K-major weights (Cout, 9 * Cin), staged once
//   by Int8Inference.prepare, zero-filled past Cout and K;
// - both tiles sit in shared memory in the 128-byte swizzle (16-byte chunk
//   c of row r at chunk c ^ (r % 8)), which wgmma reads conflict-free; a
//   ring of STAGES slots, loads issued STAGES - 2 steps ahead, one wgmma
//   group in flight (a slot is refilled two steps after its product was
//   issued, when both warpgroups have waited for it);
// - the product is wgmma.mma_async m64nBNk32 s8 x s8 -> s32, four a step a
//   warpgroup, both operands K-major from swizzled shared memory;
// - epilogue: affine/epilogue/requant_code's arithmetic on the s32
//   accumulators in registers; s8 codes staged in shared memory and stored
//   as 16-byte rows (byte stores where Cout is not a multiple of 16), f32
//   stored from the registers.
constexpr int C3_THREADS = 256;          // two warpgroups
constexpr int C3_BM = 128;               // output pixels a CTA
constexpr int C3_BK = 128;               // K bytes a step: one swizzled row
constexpr int C3_ATILE = C3_BM * C3_BK;  // bytes of an A tile

struct C3Params {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const int* colsum;
  const float* s;
  void* out;
  int H, W, C, Ho, Wo, stride, N, K, M, act, requant, stages;
  // derived by c3layout from the plan
  int ksteps, slot, off_ab, pitch, vec_out;
};

// Shared-memory layout of qconv3x3_kernel: 1024 bytes of slack to align the
// ring to the swizzle's 1024-byte period, the ring of `stages` slots (A
// tile [128][128], B tile [bn][128]), then f32 alpha and beta [bn]; the
// staged s8 codes [128][bn + 16] reuse the ring after the K loop. Returns
// its bytes, -1 for a plan the kernel does not take.
// ops/qconv.py::qconv3x3_smem_bytes is the same formula, and the launch
// refuses a mismatch.
int c3layout(C3Params& p, int bn) {
  if ((bn != 64 && bn != 128) || p.stages < 3 || p.stages > 6) return -1;
  p.ksteps = (p.K + C3_BK - 1) / C3_BK;
  p.slot = C3_ATILE + bn * C3_BK;
  p.off_ab = p.stages * p.slot;
  p.pitch = bn + 16;
  return 1024 + p.off_ab + 8 * bn;
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(v) : "memory");
}

// wait until at most n (0-3) cp.async groups of this thread are pending
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// wgmma's shared-memory matrix descriptor of a K-major operand in the
// 128-byte swizzle: start address, leading offset 1 (unused by this
// layout), 1024 bytes from one 8-row group to the next
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N s32, in the warpgroup's registers) += A (64 x 32 s8) B^T (N x
// 32 s8), both K-major in swizzled shared memory
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n128(d, a, b);
}

// One BM x BN output tile of a dense 3x3 conv (see the note above).
template <int BN>
__global__ void __launch_bounds__(C3_THREADS, 2) qconv3x3_kernel(const C3Params p) {
  extern __shared__ __align__(1024) unsigned char c3smem[];
  const uint32_t raw = smem_u32(c3smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* base = c3smem + (sbase - raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wg = warp >> 2;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tile_m = static_cast<int>(blockIdx.x) / n_tiles;
  const int m0 = tile_m * C3_BM, n0 = (static_cast<int>(blockIdx.x) - tile_m * n_tiles) * BN;
  float* alpha_s = reinterpret_cast<float*>(base + p.off_ab);
  float* beta_s = alpha_s + BN;

  // the loader: this thread copies 16-byte chunk j of rows r0 + 32 i of
  // the A tile (i < 4) and of the B tile (i < BN / 32); all its rows share
  // r0 % 8, so one swizzled column
  const int j = t & 7, r0 = t >> 3;
  const uint32_t swz = static_cast<uint32_t>((j ^ (r0 & 7)) << 4);
  int pix[4], iy0[4], ix0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    if (m < p.M) {
      const int hw = p.Ho * p.Wo;
      const int img = m / hw, rem = m - img * hw, oy = rem / p.Wo, ox = rem - oy * p.Wo;
      iy0[i] = oy * p.stride - 1;
      ix0[i] = ox * p.stride - 1;
      pix[i] = (img * p.H + iy0[i]) * p.W + ix0[i];   // the tap (0, 0)'s pixel
    } else {
      iy0[i] = -4;   // a row past M: every tap outside the image
      ix0[i] = 0;
      pix[i] = 0;
    }
  }
  const uint32_t padw = static_cast<uint32_t>((static_cast<int>(rintf(p.s[1])) - 128) & 0xFF) *
                        0x01010101u;

  auto issue = [&](int step, int slot) {
    const uint32_t a_s = sbase + slot * p.slot, b_s = a_s + C3_ATILE;
    const int k = step * C3_BK + 16 * j;
    const bool kin = k < p.K;
    const int tap = kin ? k / p.C : 0, ci = k - tap * p.C;
    const int kh = tap / 3, kw = tap - 3 * kh;
    const int doff = kh * p.W + kw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = a_s + (r0 + 32 * i) * C3_BK + swz;
      const int iy = iy0[i] + kh, ix = ix0[i] + kw;
      if (kin && static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
          static_cast<unsigned>(ix) < static_cast<unsigned>(p.W))
        cp_async(dst, p.x + static_cast<size_t>(pix[i] + doff) * p.C + ci, true, 16);
      else
        st_shared16(dst, kin ? padw : 0u);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int rb = r0 + 32 * i;
      const bool ok = kin && n0 + rb < p.N;
      cp_async(b_s + rb * C3_BK + swz, ok ? p.w + static_cast<size_t>(n0 + rb) * p.K + k : p.w,
               ok, 16);
    }
  };

  const int pf = p.stages - 2;   // steps loaded ahead
  for (int s = 0; s < pf; ++s) {
    if (s < p.ksteps) issue(s, s);
    cp_commit();
  }
  // per-channel affine terms, read by the epilogue; the scalars stay in
  // registers
  const float s0 = p.s[0], s1 = p.s[1], s2 = p.s[2], s3 = p.s[3];
  if (t < BN) {
    const int gn = n0 + t;
    float a = 0.f, b = 0.f;
    if (gn < p.N) {
      const float sv[2] = {s0, s1};
      affine(sv, p.wscale[gn], p.bias[gn], __int2float_rn(p.colsum[gn]), a, b);
    }
    alpha_s[t] = a;
    beta_s[t] = b;
  }

  int acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0;
  const uint32_t a_rows = static_cast<uint32_t>(wg * 64 * C3_BK);   // this warpgroup's rows
  for (int step = 0; step < p.ksteps; ++step) {
    cp_wait_upto(pf - 1);   // this thread's copies of the step landed
    // its shared-memory writes (the copies and the pad stores) visible to
    // wgmma's async proxy, then everyone's; after the barrier every
    // warpgroup has waited for the product of step - 2, so its slot is free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int nxt = step + pf;
    if (nxt < p.ksteps) issue(nxt, nxt % p.stages);
    cp_commit();
    const uint32_t a_s = sbase + (step % p.stages) * p.slot, b_s = a_s + C3_ATILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C3_BK / 32; ++kk)
      wgmma_s8<BN>(acc, sw128_desc(a_s + a_rows + 32 * kk), sw128_desc(b_s + 32 * kk));
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) asm volatile("" : "+r"(acc[q])::"memory");
  cp_wait_all();
  __syncthreads();   // every product is done and every copy landed: the ring is free

  // the accumulator layout of wgmma m64nN: register 4 jn + 2 h + q holds
  // row 16 (warp % 4) + lane / 4 + 8 h, column 8 jn + 2 (lane % 4) + q
  const bool clamp = p.act == ACT_RELU || p.act == ACT_RELU6, leaky = p.act == ACT_LEAKY;
  const float hi = p.act == ACT_RELU6 ? 6.f : __int_as_float(0x7f800000);
  const int wrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  auto finish = [&](int v, float al, float bt) {
    float u = __fadd_rn(__fmul_rn(__int2float_rn(v), al), bt);
    u = clamp ? fminf(fmaxf(u, 0.f), hi) : u;
    u = leaky && !(u > 0.f) ? __fmul_rn(0.1f, u) : u;
    if (p.act == ACT_LOGISTIC) u = 1.f / (1.f + expf(-u));
    return u;
  };
  if (p.requant) {
    unsigned char* codes = base;   // [128][pitch]
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int c = jn * 8 + (lane & 3) * 2;
      const float2 al = *reinterpret_cast<const float2*>(alpha_s + c);
      const float2 bt = *reinterpret_cast<const float2*>(beta_s + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float u0 = finish(acc[4 * jn + 2 * h], al.x, bt.x);
        const float u1 = finish(acc[4 * jn + 2 * h + 1], al.y, bt.y);
        *reinterpret_cast<uint16_t*>(codes + (wrow + 8 * h) * p.pitch + c) =
            static_cast<uint16_t>(static_cast<uint8_t>(requant_code(u0, s2, s3)) |
                                  static_cast<uint16_t>(static_cast<uint8_t>(
                                      requant_code(u1, s2, s3))) << 8);
      }
    }
    __syncthreads();
    const int cols = min(BN, p.N - n0);
    int8_t* out = static_cast<int8_t*>(p.out);
    if (p.vec_out) {
      for (int idx = t; idx < C3_BM * (BN / 16); idx += C3_THREADS) {
        const int r = idx / (BN / 16), c = (idx - r * (BN / 16)) * 16;
        if (m0 + r < p.M && c < cols)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * p.N + n0 + c) =
              *reinterpret_cast<const uint4*>(codes + r * p.pitch + c);
      }
    } else {   // rows not 16-byte aligned: consecutive threads, consecutive bytes
      for (int idx = t; idx < C3_BM * cols; idx += C3_THREADS) {
        const int r = idx / cols, c = idx - r * cols;
        if (m0 + r < p.M)
          out[static_cast<size_t>(m0 + r) * p.N + n0 + c] =
              static_cast<int8_t>(codes[r * p.pitch + c]);
      }
    }
    return;
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int c = jn * 8 + (lane & 3) * 2, gn = n0 + c;
    const float2 al = *reinterpret_cast<const float2*>(alpha_s + c);
    const float2 bt = *reinterpret_cast<const float2*>(beta_s + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wrow + 8 * h;
      if (gm >= p.M || gn >= p.N) continue;
      const float u0 = finish(acc[4 * jn + 2 * h], al.x, bt.x);
      const float u1 = finish(acc[4 * jn + 2 * h + 1], al.y, bt.y);
      float* o = out + static_cast<size_t>(gm) * p.N + gn;
      if (p.N % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(u0, u1);
      } else {
        o[0] = u0;
        if (gn + 1 < p.N) o[1] = u1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// qgconv3x3_s8: a grouped 3x3 conv (padding 1, stride 1 or 2, Cout = Cin,
// group width GW of 8, 16 or 24) of NHWC s8 on the tensor cores, with
// qconv1x1's fused epilogue. It replaces no TPU kernel: the JAX package
// densifies these convs into block-diagonal weights and runs them as im2col
// patches into pqdet_tpu/ops/pallas_qconv.py::qconv1x1_s8, as the port's
// 'im2col' route does (9 x the input's bytes written as patches at stride 1
// and read back, and a GEMM of Cin / GW times the real work, mostly zeros).
// Same arithmetic as that route and as the plain version
// ops/qconv.py::qgconv3x3_reference: a group's s32 sum over (kh, kw, cin)
// is the densified sum term by term without its zero terms, colsum is the
// same integer, and the epilogue is qconv1x1's step for rounded step, so
// every s8 code and f32 output equals the route's bit for bit.
//
// What bounds it: bytes. A group's product is 9 * GW deep and GW wide, 2 *
// 9 * GW operations per output byte (432 at GW 24), and the input is read
// once (four times the output at stride 2): about 140 operations per byte
// over the RegNets' convs, against the ~590 at which the tensor cores and
// not the memory are the limit.
//
// Design (tiles, groups a slice and stages from the host's plan,
// ops/qconv.py::plan_qgconv3x3, as plain ints), so that each input byte is
// read from device memory once per CTA and each output written once:
// - a CTA of 8 warps takes tiles of (image, TH x TW output pixels, a slice
//   of G whole groups), slices innermost; with one stage a CTA a tile, with
//   two the CTAs stay resident and load the next tile's window while they
//   compute this one's;
// - the tile's input window with its halo, ((TH-1)S+3) x ((TW-1)S+3) pixels
//   x G*GW channels, comes into shared memory by cp.async (16-byte copies,
//   8 where Cin or the slice is not a multiple of 16); a pixel outside the
//   image gets the pad code rint(x_zp) - 128 (the recentred zero point, the
//   route's padding) by a shared-memory store. At stride 2 the even and odd
//   window columns are stored apart, so consecutive output pixels of a tap
//   are one pitch apart at either stride; the pitch is 16 mod 32 bytes, so
//   the 8 pixels x 4 words of a fragment load fall on 32 banks;
// - a warp takes units of 16 consecutive output pixels of a row x one group:
//   D (16 x GW) = A (16 x 9GW) B^T on mma.sync m16n8k32 s8, K = 9 * GW in
//   (kh, kw, cin) order padded to a multiple of 32 with zero weights (a
//   zero weight adds exactly 0). Each A fragment word is 4 channels of one
//   tap of one pixel, read from the window at an offset the thread computes
//   once: no patch exists anywhere. The B fragments (the compact weights
//   (Cout, 9 * GW) that Int8Inference.prepare stages, read through the
//   cache) and the group's alpha and beta stay in registers while the
//   warp's units are of one group;
// - epilogue: affine/epilogue/requant_code's arithmetic on the s32
//   accumulators in registers; s8 codes staged in shared memory and stored
//   as 16-byte (or 8-byte) pieces of each pixel's slice, f32 stored from
//   the registers.
constexpr int GC_THREADS = 256;

struct GcParams {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const int* colsum;
  const float* s;
  void* out;
  int H, W, C, Ho, Wo, act, requant;
  int th, tw, g, stages;   // the plan
  int tiles_x, tiles_y, slices, ntiles;
  // derived by gclayout from the plan (cw by the launch from the pointers)
  int cs, pitch, rowp, phase, wr, wc, win, spitch, cw;
};

// Shared-memory layout of qgconv3x3_kernel: `stages` windows of wr rows x
// wc pixels (rowp bytes a row, pitch bytes a pixel: the slice's cs
// channels, then padding to 16 mod 32; at stride 2 the even columns, then
// the odd ones from byte `phase` of the row), each rounded up to 128 bytes,
// then the staged s8 codes [th * tw][spitch]. Returns its bytes, -1 for a
// plan the kernel does not take. ops/qconv.py::qgconv3x3_smem_bytes is the
// same formula, and the launch refuses a mismatch.
int gclayout(GcParams& p, int gw, int stride) {
  if (p.th < 1 || p.th > 64 || p.tw < 16 || p.tw > 64 || p.tw % 16 || p.g < 1 ||
      p.stages < 1 || p.stages > 2)
    return -1;
  p.cs = p.g * gw;
  p.pitch = p.cs % 32 <= 16 ? p.cs / 32 * 32 + 16 : p.cs / 32 * 32 + 48;
  p.wr = (p.th - 1) * stride + 3;
  p.wc = (p.tw - 1) * stride + 3;
  p.rowp = p.wc * p.pitch;
  p.phase = stride == 2 ? (p.tw + 1) * p.pitch : 0;   // even columns 0, 2, ..., 2 tw
  p.win = (p.wr * p.rowp + 127) / 128 * 128;
  p.spitch = (p.cs + 15) / 16 * 16;
  return p.stages * p.win + p.th * p.tw * p.spitch;
}

// byte offset of window column `col` in a row
template <int S>
__device__ __forceinline__ int gc_col(const GcParams& p, int col) {
  return S == 1 ? col * p.pitch : (col & 1) * p.phase + (col >> 1) * p.pitch;
}

// Grouped 3x3, pad 1, stride S, group width GW (see the note above).
template <int GW, int S>
__global__ void __launch_bounds__(GC_THREADS, 2) qgconv3x3_kernel(const GcParams p) {
  constexpr int K = 9 * GW;
  constexpr int KS = (K + 31) / 32;   // k32 steps
  constexpr int NT8 = GW / 8;          // n8 tiles of a group's outputs
  extern __shared__ __align__(128) unsigned char gsmem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = lane & 3, r8 = lane >> 2;
  const float s0 = p.s[0], s1 = p.s[1], s2 = p.s[2], s3 = p.s[3];
  const uint32_t padw =
      static_cast<uint32_t>((static_cast<int>(rintf(s1)) - 128) & 0xFF) * 0x01010101u;
  unsigned char* stage = gsmem + p.stages * p.win;
  const int per_img = p.tiles_y * p.tiles_x * p.slices;
  const int mt_row = p.tw / 16, mt_per = p.th * mt_row;   // 16-pixel units a group

  // window offsets of this thread's A fragment words: k = 32 ks + 16 h + 4 q
  // is tap k / GW, channel k % GW; a k past 9 GW meets zero weights
  int off[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 32 * ks + 16 * h + 4 * q;
      const int tap = k / GW, c = k - tap * GW, kh = tap / 3, kw = tap - 3 * kh;
      off[ks][h] = k < K ? kh * p.rowp + gc_col<S>(p, kw) + c : 0;
    }

  auto coords = [&](int tile, int& n, int& oy0, int& ox0, int& sl) {
    n = tile / per_img;
    const int rem = tile - n * per_img, txy = rem / p.slices;
    sl = rem - txy * p.slices;
    const int ty = txy / p.tiles_x;
    oy0 = ty * p.th;
    ox0 = (txy - ty * p.tiles_x) * p.tw;
  };

  // the tile's window into slot `slot`: warps take window rows, lanes cw-byte
  // pieces of a row; one cp.async group
  auto issue = [&](int tile, int slot) {
    int n, oy0, ox0, sl;
    coords(tile, n, oy0, ox0, sl);
    unsigned char* win = gsmem + slot * p.win;
    const int c0 = sl * p.cs, nch = min(p.cs, p.C - c0) / p.cw;
    const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
    const int8_t* ximg = p.x + static_cast<size_t>(n) * p.H * p.W * p.C + c0;
    for (int row = warp; row < p.wr; row += GC_THREADS / 32) {
      const int iy = iy0 + row;
      const bool row_in = static_cast<unsigned>(iy) < static_cast<unsigned>(p.H);
      for (int j = lane; j < p.wc * nch; j += 32) {
        const int col = j / nch, ch = (j - col * nch) * p.cw;
        const int ix = ix0 + col;
        unsigned char* dst = win + row * p.rowp + gc_col<S>(p, col) + ch;
        if (row_in && static_cast<unsigned>(ix) < static_cast<unsigned>(p.W))
          dw_copy(p.cw, dst, ximg + (static_cast<size_t>(iy) * p.W + ix) * p.C + ch);
        else if (p.cw == 16)
          *reinterpret_cast<uint4*>(dst) = make_uint4(padw, padw, padw, padw);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(padw, padw);
      }
    }
    cp_commit();
  };

  const bool clamp = p.act == ACT_RELU || p.act == ACT_RELU6, leaky = p.act == ACT_LEAKY;
  const float hi = p.act == ACT_RELU6 ? 6.f : __int_as_float(0x7f800000);
  auto finish = [&](int v, float al, float bt) {
    float u = __fadd_rn(__fmul_rn(__int2float_rn(v), al), bt);
    u = clamp ? fminf(fmaxf(u, 0.f), hi) : u;
    u = leaky && !(u > 0.f) ? __fmul_rn(0.1f, u) : u;
    if (p.act == ACT_LOGISTIC) u = 1.f / (1.f + expf(-u));
    return u;
  };

  // the group whose weights and affine terms the registers hold; a new
  // group's are read through the cache
  int held = -1;
  uint32_t bf[KS][NT8][2];
  float al[NT8][2], bt[NT8][2];
  const float sv[2] = {s0, s1};
  auto hold = [&](int grp) {
    held = grp;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int co = grp * GW + j * 8;
      const int8_t* wrow = p.w + static_cast<size_t>(co + r8) * K;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 32 * ks + 16 * h + 4 * q;
          bf[ks][j][h] = k < K ? __ldg(reinterpret_cast<const unsigned int*>(wrow + k)) : 0u;
        }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = co + 2 * q + v;
        affine(sv, __ldg(p.wscale + c), __ldg(p.bias + c), __int2float_rn(__ldg(p.colsum + c)),
               al[j][v], bt[j][v]);
      }
    }
  };
  const int units = p.g * mt_per, warps = GC_THREADS / 32;
  const int u_lo = warp * units / warps, u_hi = (warp + 1) * units / warps;

  const int step = p.stages == 2 ? static_cast<int>(gridDim.x) : p.ntiles;
  int slot = 0;
  if (static_cast<int>(blockIdx.x) < p.ntiles) issue(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += step) {
    int n, oy0, ox0, sl;
    coords(tile, n, oy0, ox0, sl);
    // the first unit's group weights are read while the window lands
    const int first = sl * p.g + u_lo / mt_per;
    if (u_lo < u_hi && first * GW < p.C && first != held) hold(first);
    cp_wait_all();
    __syncthreads();   // the window landed; the last tile's codes are out
    const int next = tile + step;
    if (p.stages == 2 && next < p.ntiles) issue(next, slot ^ 1);
    const unsigned char* win = gsmem + slot * p.win;
    for (int u = u_lo; u < u_hi; ++u) {
      const int gi = u / mt_per, mt = u - gi * mt_per;
      const int grp = sl * p.g + gi;
      if (grp * GW >= p.C) break;   // past the last group (units are group-major)
      if (grp != held) hold(grp);
      const int r = mt / mt_row, px0 = (mt - r * mt_row) * 16;
      const unsigned char* a_lo = win + r * S * p.rowp + (px0 + r8) * p.pitch + gi * GW;
      const unsigned char* a_hi = a_lo + 8 * p.pitch;
      auto word = [](const unsigned char* at) { return *reinterpret_cast<const uint32_t*>(at); };
      int acc[NT8][4];
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t a[4] = {word(a_lo + off[ks][0]), word(a_hi + off[ks][0]),
                               word(a_lo + off[ks][1]), word(a_hi + off[ks][1])};
#pragma unroll
        for (int j = 0; j < NT8; ++j) mma_s8(acc[j], a, bf[ks][j][0], bf[ks][j][1]);
      }
      // the accumulator layout of m16n8: register 2 h + v holds pixel px0 +
      // r8 + 8 h, channel 8 j + 2 q + v of the group
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = gi * GW + j * 8 + 2 * q;   // in the slice
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float u0 = finish(acc[j][2 * h], al[j][0], bt[j][0]);
          const float u1v = finish(acc[j][2 * h + 1], al[j][1], bt[j][1]);
          const int px = px0 + r8 + 8 * h;
          if (p.requant) {
            *reinterpret_cast<uint16_t*>(stage + (r * p.tw + px) * p.spitch + c) =
                static_cast<uint16_t>(static_cast<uint8_t>(requant_code(u0, s2, s3)) |
                                      static_cast<uint16_t>(static_cast<uint8_t>(
                                          requant_code(u1v, s2, s3))) << 8);
          } else if (oy0 + r < p.Ho && ox0 + px < p.Wo) {
            float* o = static_cast<float*>(p.out) +
                       (static_cast<size_t>(n) * p.Ho * p.Wo +
                        static_cast<size_t>(oy0 + r) * p.Wo + ox0 + px) * p.C + sl * p.cs + c;
            *reinterpret_cast<float2*>(o) = make_float2(u0, u1v);
          }
        }
      }
    }
    __syncthreads();   // every unit is done: the window is free, the codes staged
    if (p.stages == 1 && next < p.ntiles) issue(next, 0);
    if (p.requant) {
      // the staged codes out: cw-byte pieces of each pixel's slice
      const int c0 = sl * p.cs, nch = min(p.cs, p.C - c0) / p.cw;
      int8_t* oimg = static_cast<int8_t*>(p.out) + static_cast<size_t>(n) * p.Ho * p.Wo * p.C + c0;
      for (int idx = t; idx < p.th * p.tw * nch; idx += GC_THREADS) {
        const int pl = idx / nch, ch = (idx - pl * nch) * p.cw;
        const int r = pl / p.tw, px = pl - r * p.tw;
        const int oy = oy0 + r, ox = ox0 + px;
        if (oy >= p.Ho || ox >= p.Wo) continue;
        int8_t* dst = oimg + (static_cast<size_t>(oy) * p.Wo + ox) * p.C + ch;
        const unsigned char* src = stage + pl * p.spitch + ch;
        if (p.cw == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
    }
    if (p.stages == 2) slot ^= 1;
  }
  cp_wait_all();
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
  const long long ctas = static_cast<long long>((m + bm - 1) / bm) * ((n + bn - 1) / bn) * split;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
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

// form (SwForm), nsrc sources src[j] of rows x chans[j] (the input and the
// shortcut's sources: chans[j] = the output's channels), act (Act), the
// scalar vector, out (rows x sum chans int8 for a route, rows x chans[0]
// else). The step width V is the widest of 16, 8, 4, 2, 1 that divides
// the element count (every chans[j] for a route of two or more) and every
// pointer's alignment in elements.
extern "C" int sandwich_launch(int form, int nsrc, const void* const* src, const int* chans,
                               long long rows, int act, const void* scalars, void* out,
                               void* stream) {
  SwParams prm{};
  if (form < SW_INPUT || form > SW_ROUTE || nsrc < 1 || nsrc > SW_MAX_SRC || rows < 1 ||
      (form == SW_INPUT && nsrc != 1) || (form == SW_SHORTCUT && nsrc != 2) ||
      (act != ACT_LINEAR && act != ACT_RELU && act != ACT_LEAKY))
    return static_cast<int>(cudaErrorInvalidValue);
  long long ctot = 0;
  // the widest step each pointer's alignment allows: an s8 pointer's
  // alignment in bytes; the input's f32 loads are float4 for V >= 4, float2
  // for V = 2
  auto widest = [](uintptr_t a, bool f32) {
    if (f32) return a % 16 == 0 ? 16 : a % 8 == 0 ? 2 : 1;
    int v = 16;
    while (a % v) v /= 2;
    return v;
  };
  int v = widest(reinterpret_cast<uintptr_t>(out), false);
  for (int j = 0; j < nsrc; ++j) {
    if (chans[j] < 1) return static_cast<int>(cudaErrorInvalidValue);
    prm.src[j] = src[j];
    prm.c[j] = chans[j];
    prm.off[j] = static_cast<int>(ctot);
    ctot += chans[j];
    const int w = widest(reinterpret_cast<uintptr_t>(src[j]), form == SW_INPUT);
    v = w < v ? w : v;
    if (form == SW_ROUTE && nsrc > 1)
      while (chans[j] % v) v /= 2;
  }
  if (form != SW_ROUTE) {
    ctot = chans[0];
    if (form == SW_SHORTCUT && chans[1] != chans[0]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = rows * ctot;
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  while (total % v) v /= 2;
  prm.nsrc = nsrc;
  prm.ctot = static_cast<int>(ctot);
  prm.act = act;
  prm.steps = static_cast<unsigned>(total / v);
  prm.s = static_cast<const float*>(scalars);
  prm.out = static_cast<int8_t*>(out);
  // enough CTAs to fill the card several times over, each looping over
  // steps; the process uses one device
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long need = (static_cast<long long>(prm.steps) + 255) / 256;
  const unsigned grid = static_cast<unsigned>(need < 8LL * sms ? need : 8LL * sms);
  void (*kern)(SwParams) = form == SW_INPUT ? sandwich_of<SW_INPUT>(v)
                           : form == SW_SHORTCUT ? sandwich_of<SW_SHORTCUT>(v)
                                                 : sandwich_of<SW_ROUTE>(v);
  kern<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// x (n, h, wd, c) s8 with c a multiple of 16, w (cout, 9 c) s8 in (kh, kw,
// cin) order, both 16-byte aligned; out (n, h / stride, wd / stride, cout)
// s8 (requant) or f32. The plan (bn, stages, smem) from ops/qconv.py::
// plan_qconv3x3; the grid is one CTA an output tile, the column tiles of a
// row tile neighbours.
extern "C" int qconv3x3_launch(const void* x, const void* w, const void* wscale,
                               const void* bias, const void* colsum, const void* scalars,
                               void* out, int n, int h, int wd, int c, int stride, int cout,
                               int act, int requant, int bn, int stages, int smem,
                               void* stream) {
  C3Params prm{};
  prm.x = static_cast<const int8_t*>(x);
  prm.w = static_cast<const int8_t*>(w);
  prm.wscale = static_cast<const float*>(wscale);
  prm.bias = static_cast<const float*>(bias);
  prm.colsum = static_cast<const int*>(colsum);
  prm.s = static_cast<const float*>(scalars);
  prm.out = out;
  prm.H = h; prm.W = wd; prm.C = c; prm.stride = stride; prm.N = cout;
  prm.act = act; prm.requant = requant; prm.stages = stages;
  if (c < 16 || c % 16 || (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || wd % 2)) || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.Ho = h / stride;
  prm.Wo = wd / stride;
  prm.K = 9 * c;
  const long long m = static_cast<long long>(n) * prm.Ho * prm.Wo;
  const long long ctas = (m + C3_BM - 1) / C3_BM * ((cout + bn - 1) / bn);
  if (m > 2147483648LL - C3_BM || ctas > 2147483647LL ||
      static_cast<long long>(n) * h * wd * c > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.M = static_cast<int>(m);
  if (c3layout(prm, bn) != smem || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  prm.vec_out = aligned16(out) && cout % 16 == 0;
  void (*kern)(C3Params) = bn == 64 ? qconv3x3_kernel<64> : qconv3x3_kernel<128>;
  static int given[2] = {0, 0};
  int& g = given[bn == 64 ? 0 : 1];
  cudaError_t err = cudaSuccess;
  if (smem > g) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g = smem;
  }
  kern<<<static_cast<unsigned>(ctas), C3_THREADS, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// x (n, h, wd, c) s8, w (c, 9 gw) s8 in (kh, kw, cin-in-group) order, both
// 16-byte aligned, gw 8, 16 or 24 dividing c; out (n, h / stride, wd /
// stride, c) s8 (requant) or f32. The plan (th, tw, g, stages, smem) from
// ops/qconv.py::plan_qgconv3x3; with one stage the grid is one CTA a tile,
// with two as many CTAs as stay resident, each walking tiles.
extern "C" int qgconv3x3_launch(const void* x, const void* w, const void* wscale,
                                const void* bias, const void* colsum, const void* scalars,
                                void* out, int n, int h, int wd, int c, int gw, int stride,
                                int act, int requant, int th, int tw, int g, int stages,
                                int smem, void* stream) {
  GcParams prm{};
  prm.x = static_cast<const int8_t*>(x);
  prm.w = static_cast<const int8_t*>(w);
  prm.wscale = static_cast<const float*>(wscale);
  prm.bias = static_cast<const float*>(bias);
  prm.colsum = static_cast<const int*>(colsum);
  prm.s = static_cast<const float*>(scalars);
  prm.out = out;
  prm.H = h; prm.W = wd; prm.C = c; prm.act = act; prm.requant = requant;
  prm.th = th; prm.tw = tw; prm.g = g; prm.stages = stages;
  if ((gw != 8 && gw != 16 && gw != 24) || c < gw || c % gw || (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || wd % 2)) || n < 1 || h < 1 || wd < 1 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) || static_cast<long long>(n) * h * wd * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.Ho = h / stride;
  prm.Wo = wd / stride;
  if (gclayout(prm, gw, stride) != smem || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.cw = c % 16 == 0 && prm.cs % 16 == 0 ? 16 : 8;
  prm.tiles_x = (prm.Wo + tw - 1) / tw;
  prm.tiles_y = (prm.Ho + th - 1) / th;
  prm.slices = (c / gw + g - 1) / g;
  const long long ntiles = static_cast<long long>(n) * prm.tiles_x * prm.tiles_y * prm.slices;
  if (ntiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  prm.ntiles = static_cast<int>(ntiles);
  void (*kern)(GcParams) =
      stride == 1 ? (gw == 8 ? qgconv3x3_kernel<8, 1> : gw == 16 ? qgconv3x3_kernel<16, 1>
                                                                 : qgconv3x3_kernel<24, 1>)
                  : (gw == 8 ? qgconv3x3_kernel<8, 2> : gw == 16 ? qgconv3x3_kernel<16, 2>
                                                                 : qgconv3x3_kernel<24, 2>);
  // raise the shared-memory limit only when a larger one is needed; the
  // process uses one device
  static int given[6] = {0, 0, 0, 0, 0, 0};
  int& gv = given[(gw / 8 - 1) * 2 + stride - 1];
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024 && smem > gv) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gv = smem;
  }
  int grid = prm.ntiles;
  if (stages == 2) {
    static int sms = 0;
    int dev = 0, per_sm = 0;
    if (sms == 0) {
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, GC_THREADS,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long resident = static_cast<long long>(per_sm) * sms;
    grid = static_cast<int>(resident < grid ? resident : grid);
  }
  kern<<<static_cast<unsigned>(grid), GC_THREADS, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
