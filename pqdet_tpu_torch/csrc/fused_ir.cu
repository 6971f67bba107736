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
// project + bias + act). Only the order of the f32 sums differs.
//
// What bounds it on this card. The fusion keeps the expanded (E-wide)
// activation out of device memory, so the bytes that must move are x, the
// weights and y: 2-8 MB a chain at mobilenetv2-fpn's shapes, a few
// microseconds at 3.35 TB/s, and the multiply-adds are of the same order
// at the bf16 tensor-core rate. What the kernel meets instead is the L2
// traffic of its own tiling: every pixel tile reads the weights again, and
// every rank of a cluster reads the tile's x window again; at 16x16 and
// 32x32 that traffic, and the latency of each step, set the time.
//
// Design (pixel tile, cluster, K step, stages and projection form come
// from the host's plan, ops/fused_ir.py::plan_fused_ir, as plain ints):
// - one thread-block cluster of CL CTAs (CL <= 8) per TH x TW output-pixel
//   tile of one image (8x8, or 8x16 where the plan finds it cheaper). Rank
//   r owns the expanded channels [r*ES, (r+1)*ES) and computes expand +
//   bias + act + pad mask, then the depthwise conv + bias + act, for that
//   slice ONCE, keeping the bf16 result (pixels x ES) in its shared memory.
//   The previous design recomputed the expand for every 32-128-wide P tile
//   (up to 8x) and ran 32-128 blocks at 16x16; a 16x16 chain at batch 4
//   now runs 16 tiles x 8 ranks = 128 CTAs, two to an SM;
// - the projection, after cluster.sync(), in one of two forms:
//   gather: rank r projects the P slice [r*PS, (r+1)*PS) over all of E;
//     every rank pushes its dw slice into every rank's A tile with bulk
//     copies between shared memories (cp.async.bulk shared::cluster, each
//     receiver waiting on its mbarrier for all the bytes), since ldmatrix
//     reads only local shared memory; a cluster of one reads its own slice;
//   reduce (P <= E/2): each rank projects its own E slice onto all of P in
//     chunks, the f32 partial tiles are added across the cluster through
//     distributed shared memory (each rank 1/CL of the pixels), then bias
//     + act + round. It moves P x 4 bytes a pixel between SMs rather than
//     E x 2;
// - both 1x1 products are mma.sync m16n8k16 (bf16 in, f32 accumulate)
//   with operands from ldmatrix (x4; .trans for the [k][n] weight tiles);
//   each warp owns up to three 16x32 output units; the row strides are 16
//   bytes off a multiple of 128 so ldmatrix's eight rows fall on distinct
//   banks. The kernel is a template on the expand's K step (CK 32/64/128,
//   0 for a bare pair) so the inner loops are unrolled;
// - the x window and `we` tiles (expand: K steps of CK, E sub-chunks of
//   <= 64; with one K step the x tile is loaded once for all sub-chunks)
//   and the `wp` tiles (projection: K steps of 64, P chunks of PN <= 128)
//   arrive by cp.async in a ring of 2-3 stages, the next step's copies in
//   flight under the current step's mma; rows or channels outside the
//   image, Cin, E or P are zero-filled by the copy (source size 0), so the
//   weights come unpadded; every copy is 16 bytes, so Cin, E and P are
//   multiples of 8 (the wrapper checks);
// - the depthwise conv: one thread per 4 adjacent output pixels and 8
//   channels, the window rows read once for the four, f32 taps in shared
//   memory;
// - activations are decoded once into branch-free parameters; f32 -> bf16
//   is cvt.rn.bf16x2 (round to nearest even, as torch);
// - zero-pad domain: window pixels outside the image are set to 0 AFTER
//   expand + bias + act (relu6(expand(0)) = relu6(be) != 0), exactly as
//   the dw conv's zero padding sees them;
// - shared memory: the rank's dw slice, its f32 taps and biases, the
//   gather's mbarrier, then a union of the expand stage (expanded window +
//   ring) and the projection stage; the plan keeps it within 113 KB where
//   two CTAs then share an SM, and the host entry checks it against its own
//   layout. wgmma, TMA and multicast of the x window across a cluster are
//   not used yet (ROADMAP.md).
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream through cudaLaunchKernelEx with the cluster dimension as a launch
// attribute; the function returns a CUDA error code (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per CTA (8 warps)
constexpr int NWARP = NT / 32;
constexpr int UPW = 3;    // 16x32 output units per warp, at most
constexpr int KP = 64;    // K step of the projection
constexpr int MAXI = 8;   // x-tile copies per thread and step, at most
constexpr int MAXW = 4;   // we-tile copies per thread and step, at most
constexpr int MAXP = 4;   // wp-tile copies per thread and step, at most

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3,
           ACT_LOGISTIC = 4 };

struct Params {
  const uint16_t* x;
  const uint16_t* we;
  const float* be;
  const uint16_t* wdw;
  const float* bdw;
  const uint16_t* wp;
  const float* bp;
  uint16_t* out;
  int H, W, Cin, E, P, expand, act_e, act_dw, act_p;
  int th, tw, cl, es, ps, ck, pn, stages, reduce;
  // derived by the host from the plan
  int tiles_x, hwin, nwin, mw, npix, lds, ldx, ec, ldwe, lda, pnw, ldwp;
  int off_const, off_bar, off_xe, off_ringa, off_ringb, off_part, slot_a, slot_b;
};

__host__ __device__ constexpr int r16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int r32(int v) { return (v + 31) / 32 * 32; }

__device__ __forceinline__ float bf2f(uint32_t v) {
  return __uint_as_float((v & 0xffffu) << 16);
}

// two f32 -> bf16 round to nearest even (as torch's .to(torch.bfloat16)),
// packed lo | hi << 16
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// An activation as branch-free parameters, decoded once per kernel:
// y = clamp ? min(max(y, 0), hi) : y; y = y > 0 ? y : slope * y; and the
// logistic 1 / (1 + exp(-y)) where asked. Linear keeps y as it is (slope
// 1), leaky is y > 0 ? y : 0.1f * y, relu / relu6 clamp.
struct ActP {
  bool clamp, logistic;
  float hi, slope;
};

__device__ __forceinline__ ActP decode_act(int act) {
  ActP a;
  a.clamp = act == ACT_RELU || act == ACT_RELU6;
  a.logistic = act == ACT_LOGISTIC;
  a.hi = act == ACT_RELU6 ? 6.f : __int_as_float(0x7f800000);
  a.slope = act == ACT_LEAKY ? 0.1f : 1.f;
  return a;
}

__device__ __forceinline__ float apply_act(const ActP& a, float y) {
  y = a.clamp ? fminf(fmaxf(y, 0.f), a.hi) : y;
  y = y > 0.f ? y : a.slope * y;
  if (a.logistic) y = 1.f / (1.f + expf(-y));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most stages - 2 groups are pending (stages is 2 or 3)
__device__ __forceinline__ void cp_wait_ring(int stages) {
  if (stages >= 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (source size 0)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// the shared::cluster address of a shared::cta address in rank q's CTA
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(q));
  return r;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// acc[0..3] += A[16 x 16*KS] x B[16*KS x 32] for one 16x32 unit. A is
// row-major with a row stride of lda bytes, B is [k][n] with ldb bytes;
// a and b are the shared addresses of the unit's corner. The tiles are
// zero-filled beyond the valid K, so every step is whole.
template <int KS>
__device__ __forceinline__ void mma_unit(float (&acc)[4][4], uint32_t a, int lda,
                                         uint32_t b, int ldb, int lane) {
  a += (lane & 15) * lda + (lane >> 4) * 16;
  b += (lane & 15) * ldb + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t fa[4], fb[4], fc[4];
    ldsm_x4(fa, a + kk * 32);
    ldsm_x4_t(fb, b + kk * 16 * ldb);
    ldsm_x4_t(fc, b + kk * 16 * ldb + 32);
    mma_bf16(acc[0], fa, fb[0], fb[1]);
    mma_bf16(acc[1], fa, fb[2], fb[3]);
    mma_bf16(acc[2], fa, fc[0], fc[1]);
    mma_bf16(acc[3], fa, fc[2], fc[3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[UPW][4][4]) {
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][i][j] = 0.f;
}

// CK: the expand's K step (32, 64 or 128), or 0 for a bare dw + pw pair
template <int CK>
__global__ void __launch_bounds__(NT, 2) fused_ir_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x / p.cl, n = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * p.th, tx0 = (tile % p.tiles_x) * p.tw;
  const uint16_t* xn = p.x + static_cast<size_t>(n) * p.H * p.W * p.Cin;
  const int e_lo = rank * p.es;
  const int e_n = max(0, min(p.E - e_lo, p.es));   // channels of this slice
  const int e_w = r16(e_n);                         // ... in whole k16 steps
  const int p_lo = rank * p.ps;
  const int p_n = max(0, min(p.P - p_lo, p.ps));   // output channels of this rank

  uint16_t* ys = reinterpret_cast<uint16_t*>(smem);                // [npix][lds]
  float* wdw_s = reinterpret_cast<float*>(smem + p.off_const);     // [9][es]
  float* bdw_s = wdw_s + 9 * p.es;                                  // [es]
  float* be_s = bdw_s + p.es;                                       // [es]
  float* bp_s = be_s + p.es;                                        // [ps]
  uint16_t* xe = reinterpret_cast<uint16_t*>(smem + p.off_xe);     // [mw][lds]
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ringa = sbase + p.off_ringa;    // stages x ([mw][ldx], [ck][ldwe])
  const uint32_t ringb = sbase + p.off_ringb;    // stages x [KP][ldwp]

  // this rank's biases and dw taps, as f32, read by the epilogues and the dw
  for (int i = t; i < 9 * p.es; i += NT) {
    const int k = i / p.es, c = i - k * p.es;
    wdw_s[i] = c < e_n ? bf2f(p.wdw[static_cast<size_t>(k) * p.E + e_lo + c]) : 0.f;
  }
  for (int c = t; c < p.es; c += NT) {
    bdw_s[c] = c < e_n ? p.bdw[e_lo + c] : 0.f;
    be_s[c] = c < e_n && CK ? p.be[e_lo + c] : 0.f;
  }
  for (int c = t; c < p.ps; c += NT) bp_s[c] = c < p_n ? p.bp[p_lo + c] : 0.f;
  // the gather's mbarrier (gather form, cluster > 1): one arrival, armed
  // with the bytes every rank will push (cl slices of npix rows of es)
  const uint32_t bar = sbase + p.off_bar;
  if (t == 0 && !p.reduce && p.cl > 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(p.cl * p.npix * p.es * 2)
                 : "memory");
  }

  auto window_pixel = [&](int hp, int& gy, int& gx) {
    gy = ty0 - 1 + hp / p.hwin;
    gx = tx0 - 1 + hp % p.hwin;
    return hp < p.nwin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
  };

  const ActP act_e = decode_act(p.act_e), act_dw = decode_act(p.act_dw),
             act_p = decode_act(p.act_p);
  float acc[UPW][4][4];

  // ---- stage 1: the expanded window xe[nwin][e_n], bf16 after bias + act
  // + pad mask, in E sub-chunks of <= 64 channels x K steps of CK
  if constexpr (CK > 0) {
    const int ksteps = (p.Cin + CK - 1) / CK;
    const int total = ((e_w + 63) / 64) * ksteps;
    const int ec8 = p.ec / 8, mt_n = p.mw / 16;
    const int slot_bytes = p.slot_a * 2, xtile_bytes = p.mw * p.ldx * 2;
    // each thread copies the same tile elements at every step; their
    // shared byte offsets (low 16 bits) and columns or rows (high bits)
    // are computed once, with the window pixel's offset in x (-1 outside)
    int xd[MAXI], xg[MAXI], wd[MAXW];
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int idx = t + i * NT;
      xd[i] = xg[i] = -1;
      if (idx < p.mw * (CK / 8)) {
        const int hp = idx / (CK / 8), col = (idx % (CK / 8)) * 8;
        int gy, gx;
        xd[i] = (hp * p.ldx + col) * 2 | (col << 16);
        if (window_pixel(hp, gy, gx)) xg[i] = (gy * p.W + gx) * p.Cin + col;
      }
    }
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      const int idx = t + i * NT;
      wd[i] = -1;
      if (idx < CK * ec8) {
        const int ci = idx / ec8, col = (idx - ci * ec8) * 8;
        wd[i] = xtile_bytes + (ci * p.ldwe + col) * 2 | (ci << 16) | (col << 24);
      }
    }
    // the thread's accumulator rows that are window pixels inside the image
    unsigned row_in = 0;
#pragma unroll
    for (int u = 0; u < UPW; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hp = ((warp + NWARP * u) >> 1) * 16 + (lane >> 2) + 8 * h;
        int gy, gx;
        if (window_pixel(hp, gy, gx)) row_in |= 1u << (2 * u + h);
      }

    auto issue = [&](int step, int slot) {
      const int j = step / ksteps, c0 = (step - j * ksteps) * CK;
      const int eo = e_lo + j * 64, cin_left = p.Cin - c0, e_end = e_lo + e_n;
      const uint32_t s = ringa + slot * slot_bytes;
#pragma unroll
      for (int i = 0; i < MAXI; ++i) {
        // one K step over Cin: the x tile of slot 0 serves every E sub-chunk
        if (xd[i] < 0 || (ksteps == 1 && step > 0)) continue;
        const bool ok = xg[i] >= 0 && (xd[i] >> 16) < cin_left;
        cp16(s + (xd[i] & 0xffff), ok ? xn + xg[i] + c0 : xn, ok);
      }
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (wd[i] < 0) continue;
        const int row = c0 + ((wd[i] >> 16) & 0xff), col = eo + (wd[i] >> 24);
        const bool ok = row < p.Cin && col < e_end;
        cp16(s + (wd[i] & 0xffff), ok ? p.we + static_cast<size_t>(row) * p.E + col : p.we,
             ok);
      }
    };
    zero_acc(acc);
    for (int s = 0; s < p.stages - 1; ++s) {
      if (s < total) issue(s, s);
      cp_commit();
    }
    for (int step = 0; step < total; ++step) {
      cp_wait_ring(p.stages);
      __syncthreads();
      const int nxt = step + p.stages - 1;
      if (nxt < total) issue(nxt, nxt % p.stages);
      cp_commit();
      const int j = step / ksteps, kq = step - j * ksteps;
      const int ecw = min(64, e_w - j * 64);
      const uint32_t ws = ringa + (step % p.stages) * slot_bytes + xtile_bytes;
      const uint32_t xs = ksteps == 1 ? ringa : ws - xtile_bytes;
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int unit = warp + NWARP * u, mt = unit >> 1, ng = unit & 1;
        if (mt < mt_n && ng * 32 < ecw)
          mma_unit<CK / 16>(acc[u], xs + mt * 16 * p.ldx * 2, p.ldx * 2, ws + ng * 64,
                            p.ldwe * 2, lane);
      }
      if (kq == ksteps - 1) {   // sub-chunk done: bias + act + mask -> xe
#pragma unroll
        for (int u = 0; u < UPW; ++u) {
          const int unit = warp + NWARP * u, mt = unit >> 1, ng = unit & 1;
          if (!(mt < mt_n && ng * 32 < ecw)) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int hp = mt * 16 + (lane >> 2) + 8 * h;
              const int e = j * 64 + ng * 32 + i * 8 + (lane & 3) * 2;   // slice-local
              if (e >= e_w) continue;
              uint32_t v = 0;   // e_n is a multiple of 8: both or neither
              if (((row_in >> (2 * u + h)) & 1u) && e < e_n)
                v = pack_bf2(apply_act(act_e, acc[u][i][2 * h] + be_s[e]),
                             apply_act(act_e, acc[u][i][2 * h + 1] + be_s[e + 1]));
              *reinterpret_cast<uint32_t*>(xe + hp * p.lds + e) = v;
            }
        }
        zero_acc(acc);
      }
    }
    cp_wait_all();
  } else {
    // bare dw + pw pair: the window itself is the dw input (Cin == E)
    const int e8 = e_w / 8;
    for (int idx = t; idx < p.nwin * e8; idx += NT) {
      const int hp = idx / e8, col = (idx - hp * e8) * 8;
      int gy, gx;
      const bool ok = window_pixel(hp, gy, gx) && col < e_n;
      cp16(smem_u32(xe + hp * p.lds + col),
           ok ? xn + (static_cast<size_t>(gy) * p.W + gx) * p.Cin + e_lo + col : xn, ok);
    }
    cp_commit();
    cp_wait_all();
  }
  __syncthreads();

  // ---- stage 2: depthwise 3x3 -> ys[npix][es] bf16, zeros beyond e_n;
  // one thread per 4 adjacent output pixels of a row and 8 channels: the
  // three window rows are read once for the four (6 taps a row) and each
  // tap's weights once, 16-byte smem loads throughout
  {
    const int g8 = p.es / 8, q4 = p.tw / 4;
    for (int idx = t; idx < p.th * q4 * g8; idx += NT) {
      const int cg = idx % g8, rest = idx / g8;
      const int c = cg * 8, oy = rest / q4, ox0 = (rest - oy * q4) * 4;
      uint32_t packed[4][4] = {};
      if (c < e_n) {
        float s[4][8];
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int q = 0; q < 8; ++q) s[o][q] = 0.f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const uint16_t* xrow = xe + ((oy + kh) * p.hwin + ox0) * p.lds + c;
          float xv[6][8];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const uint4 v = *reinterpret_cast<const uint4*>(xrow + i * p.lds);
            const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 8; ++q) xv[i][q] = bf2f(w4[q / 2] >> (16 * (q & 1)));
          }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float* wk = wdw_s + (kh * 3 + kw) * p.es + c;
            const float4 w0 = *reinterpret_cast<const float4*>(wk);
            const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
            const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int o = 0; o < 4; ++o)
#pragma unroll
              for (int q = 0; q < 8; ++q) s[o][q] += xv[o + kw][q] * ws[q];
          }
        }
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int q = 0; q < 4; ++q)   // e_n is a multiple of 8: all 8 or none
            packed[o][q] = pack_bf2(apply_act(act_dw, s[o][2 * q] + bdw_s[c + 2 * q]),
                                    apply_act(act_dw, s[o][2 * q + 1] + bdw_s[c + 2 * q + 1]));
      }
#pragma unroll
      for (int o = 0; o < 4; ++o)
        *reinterpret_cast<uint4*>(ys + (oy * p.tw + ox0 + o) * p.lds + c) =
            make_uint4(packed[o][0], packed[o][1], packed[o][2], packed[o][3]);
    }
  }
  cluster.sync();   // every rank's ys is complete; xe and ring A are free

  if (p.reduce) {
    // ---- stage 3, reduce form (P small against E): each rank projects its
    // own E slice (A = its ys, local) onto all P channels, in chunks of pn;
    // per chunk the f32 partial tiles are added across the cluster through
    // distributed shared memory, each rank taking 1/cl of the pixels, then
    // bias + act + round. The sum over E is slice by slice, ranks in order.
    float* part = reinterpret_cast<float*>(smem + p.off_part);   // [npix][pnw + 4]
    const int ldp = p.pnw + 4;
    const int ksteps_l = (p.es + KP - 1) / KP;
    const int chunks = (p.P + p.pn - 1) / p.pn;
    const int total_r = chunks * ksteps_l;
    const int ng_n = p.pnw / 32, mt_p = p.npix / 16;
    const int slot_b = p.slot_b * 2;
    int pd[MAXP];
    {
      const int pn8 = p.pnw / 8;
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        const int idx = t + i * NT;
        pd[i] = -1;
        if (idx < KP * pn8) {
          const int k = idx / pn8, col = (idx - k * pn8) * 8;
          pd[i] = (k * p.ldwp + col) * 2 | (k << 16) | (col << 23);
        }
      }
    }
    auto issue_r = [&](int step, int slot) {
      const int ch = step / ksteps_l, k0 = (step - ch * ksteps_l) * KP;
      const int cb = ch * p.pn, c_end = min(p.P, cb + p.pn), e_end = e_lo + e_n;
      const uint32_t sb = ringb + slot * slot_b;
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (pd[i] < 0) continue;
        const int row = e_lo + k0 + ((pd[i] >> 16) & 0x7f), col = cb + (pd[i] >> 23);
        const bool ok = row < e_end && col < c_end;
        cp16(sb + (pd[i] & 0xffff), ok ? p.wp + static_cast<size_t>(row) * p.P + col : p.wp,
             ok);
      }
    };
    for (int st = 0; st < p.stages - 1; ++st) {
      if (st < total_r) issue_r(st, st);
      cp_commit();
    }
    const uint32_t ys_s = sbase;
    const int rpr = (p.npix + p.cl - 1) / p.cl;
    const int r0 = rank * rpr, r1 = min(p.npix, r0 + rpr);
    zero_acc(acc);
    for (int step = 0; step < total_r; ++step) {
      cp_wait_ring(p.stages);
      __syncthreads();
      const int nxt = step + p.stages - 1;
      if (nxt < total_r) issue_r(nxt, nxt % p.stages);
      cp_commit();
      const int ch = step / ksteps_l, kq = step - ch * ksteps_l, k0 = kq * KP;
      const int cw = min(p.pn, p.P - ch * p.pn);
      const uint32_t ws = ringb + (step % p.stages) * slot_b;
      const int ksub = min(KP, e_w - k0) / 16;   // ys is zero from e_n to e_w
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int unit = warp + NWARP * u, mt = unit / ng_n, ng = unit - mt * ng_n;
        if (mt < mt_p && ng * 32 < cw)
          for (int kk = 0; kk < ksub; ++kk)
            mma_unit<1>(acc[u], ys_s + (mt * 16 * p.lds + k0 + kk * 16) * 2, p.lds * 2,
                        ws + kk * 16 * p.ldwp * 2 + ng * 64, p.ldwp * 2, lane);
      }
      if (kq == ksteps_l - 1) {
        // this rank's partial of the chunk -> part, then add the ranks'
#pragma unroll
        for (int u = 0; u < UPW; ++u) {
          const int unit = warp + NWARP * u, mt = unit / ng_n, ng = unit - mt * ng_n;
          if (!(mt < mt_p && ng * 32 < cw)) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int op = mt * 16 + (lane >> 2) + 8 * h;
              const int col = ng * 32 + i * 8 + (lane & 3) * 2;
              *reinterpret_cast<float2*>(part + op * ldp + col) =
                  make_float2(acc[u][i][2 * h], acc[u][i][2 * h + 1]);
            }
        }
        zero_acc(acc);
        cluster.sync();   // every rank's partial of this chunk is staged
        const int c4 = cw / 4;   // cw is a multiple of 8
        for (int idx = t; idx < (r1 - r0) * c4; idx += NT) {
          const int op = r0 + idx / c4, col = (idx - (idx / c4) * c4) * 4;
          const int oy = ty0 + op / p.tw, ox = tx0 + op % p.tw;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q >= p.cl) break;
            const float4 v =
                *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + op * ldp + col);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          if (oy >= p.H || ox >= p.W) continue;
          const int gc = ch * p.pn + col;
          *reinterpret_cast<uint2*>(
              p.out + ((static_cast<size_t>(n) * p.H + oy) * p.W + ox) * p.P + gc) =
              make_uint2(pack_bf2(apply_act(act_p, sum.x + p.bp[gc]),
                                  apply_act(act_p, sum.y + p.bp[gc + 1])),
                         pack_bf2(apply_act(act_p, sum.z + p.bp[gc + 2]),
                                  apply_act(act_p, sum.w + p.bp[gc + 3])));
        }
        cluster.sync();   // the partials are read: part may be written again
      }
    }
    cp_wait_all();
    return;
  }

  // ---- stage 3: project this rank's P slice over the whole E, in chunks
  // of pn channels. The A operand [npix][E] is gathered once: every rank
  // pushes its ys rows into every rank's ya with bulk copies between
  // shared memories (cp.async.bulk shared::cluster, completing on the
  // receiver's mbarrier), since ldmatrix reads only local shared memory;
  // a cluster of one reads its own ys. The wp tiles come by cp.async
  // through the ring. Then bias + act + round.
  const int kpad = r16(p.E);
  const int ksteps_p = (kpad + KP - 1) / KP;
  const int total_p = ((p_n + p.pn - 1) / p.pn) * ksteps_p;
  const int ng_n = p.pnw / 32, mt_p = p.npix / 16;
  const int slot_b = p.slot_b * 2;
  const uint32_t ya = p.cl > 1 ? sbase + p.off_xe : sbase;   // [npix][lda]
  const int lda = p.cl > 1 ? p.lda : p.lds;
  int pd[MAXP];
  {
    const int pn8 = p.pnw / 8;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int idx = t + i * NT;
      pd[i] = -1;
      if (idx < KP * pn8) {
        const int k = idx / pn8, col = (idx - k * pn8) * 8;
        pd[i] = (k * p.ldwp + col) * 2 | (k << 16) | (col << 23);
      }
    }
  }
  auto issue_p = [&](int step, int slot) {
    const int ch = step / ksteps_p, k0 = (step - ch * ksteps_p) * KP;
    const int cb = p_lo + ch * p.pn, p_end = p_lo + p_n;
    const uint32_t sb = ringb + slot * slot_b;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (pd[i] < 0) continue;
      const int row = k0 + ((pd[i] >> 16) & 0x7f), col = cb + (pd[i] >> 23);
      const bool ok = row < p.E && col < p_end;
      cp16(sb + (pd[i] & 0xffff), ok ? p.wp + static_cast<size_t>(row) * p.P + col : p.wp, ok);
    }
  };
  for (int st = 0; st < p.stages - 1; ++st) {
    if (st < total_p) issue_p(st, st);
    cp_commit();
  }
  if (p.cl > 1) {
    // push this rank's slice: row op of ys -> row op, columns [rank*es,
    // (rank+1)*es) of every rank's ya; then wait for all slices to land
    const uint32_t row_bytes = p.es * 2;
    for (int idx = t; idx < p.cl * p.npix; idx += NT) {
      const int q = idx / p.npix, op = idx - q * p.npix;
      const uint32_t src = sbase + op * p.lds * 2;
      const uint32_t dst = mapa(ya + (op * p.lda + rank * p.es) * 2, q);
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(row_bytes), "r"(mapa(bar, q))
          : "memory");
    }
    mbar_wait(bar, 0);
  }
  zero_acc(acc);
  for (int step = 0; step < total_p; ++step) {
    cp_wait_ring(p.stages);
    __syncthreads();
    const int nxt = step + p.stages - 1;
    if (nxt < total_p) issue_p(nxt, nxt % p.stages);
    cp_commit();
    const int ch = step / ksteps_p, kq = step - ch * ksteps_p, k0 = kq * KP;
    const int cw = min(p.pn, p_n - ch * p.pn);     // valid channels of the chunk
    const uint32_t ws = ringb + (step % p.stages) * slot_b;
    const int ksub = min(KP, kpad - k0) / 16;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + NWARP * u, mt = unit / ng_n, ng = unit - mt * ng_n;
      if (mt < mt_p && ng * 32 < cw)
        for (int kk = 0; kk < ksub; ++kk)
          mma_unit<1>(acc[u], ya + (mt * 16 * lda + k0 + kk * 16) * 2, lda * 2,
                      ws + kk * 16 * p.ldwp * 2 + ng * 64, p.ldwp * 2, lane);
    }
    if (kq == ksteps_p - 1) {
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int unit = warp + NWARP * u, mt = unit / ng_n, ng = unit - mt * ng_n;
        if (!(mt < mt_p && ng * 32 < cw)) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int op = mt * 16 + (lane >> 2) + 8 * h;
            const int oy = ty0 + op / p.tw, ox = tx0 + op % p.tw;
            const int col = ng * 32 + i * 8 + (lane & 3) * 2;   // cw is a multiple of 8
            if (oy >= p.H || ox >= p.W || col >= cw) continue;
            const int lc = ch * p.pn + col;
            *reinterpret_cast<uint32_t*>(
                p.out + ((static_cast<size_t>(n) * p.H + oy) * p.W + ox) * p.P + p_lo + lc) =
                pack_bf2(apply_act(act_p, acc[u][i][2 * h] + bp_s[lc]),
                         apply_act(act_p, acc[u][i][2 * h + 1] + bp_s[lc + 1]));
          }
      }
      zero_acc(acc);
    }
  }
  cp_wait_all();
  // no rank exits while its slice may still be on its way to a peer: each
  // peer waited for all of its bytes before its own loop
  cluster.sync();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Fill the derived fields and the shared-memory layout from the plan;
// returns the dynamic shared-memory bytes, or -1 for a plan the kernel
// does not take. The same formula is ops/fused_ir.py::fused_ir_smem_bytes.
int layout(Params& p) {
  if (p.cl < 1 || p.cl > 8 || p.th < 1 || p.tw < 4 || p.tw % 4 || p.th * p.tw % 16 || p.es < 16 ||
      p.es % 16 || p.ps < 8 || p.ps % 8 || p.pn < 8 || p.pn > 128 || p.pn % 8 ||
      p.stages < 2 || p.stages > 3 || p.cl * p.es < p.E || p.cl * p.ps < p.P ||
      p.Cin % 8 || p.E % 8 || p.P % 8 || (p.reduce && (p.cl < 2 || p.ps != p.P)))
    return -1;
  if (p.expand ? (p.ck != 32 && p.ck != 64 && p.ck != 128) : p.ck != 0) return -1;
  p.tiles_x = (p.W + p.tw - 1) / p.tw;
  p.hwin = p.tw + 2;
  p.nwin = (p.th + 2) * p.hwin;
  p.mw = r16(p.nwin);
  p.npix = p.th * p.tw;
  p.lds = p.es + 8;
  p.ldx = p.ck + 8;
  p.ec = r32(p.es < 64 ? p.es : 64);
  p.ldwe = p.ec + 8;
  p.lda = p.cl * p.es + 8;
  p.pnw = r32(p.pn);
  p.ldwp = p.pnw + 8;
  if (p.expand && (p.mw / 16 * 2 > UPW * NWARP || p.mw * p.ck / 8 > MAXI * NT ||
                   p.ck * p.ec / 8 > MAXW * NT || (p.mw * p.ldx + p.ck * p.ldwe) * 2 >= 65536))
    return -1;
  if (KP * p.pnw / 8 > MAXP * NT || p.npix / 16 * (p.pnw / 32) > UPW * NWARP) return -1;
  const int y_bytes = p.npix * p.lds * 2;
  const int c_bytes = (11 * p.es + p.ps) * 4;
  p.slot_a = p.expand ? p.mw * p.ldx + p.ck * p.ldwe : 0;   // in bf16 elements
  p.slot_b = KP * p.ldwp;
  const int a_bytes = p.mw * p.lds * 2 + p.stages * p.slot_a * 2;
  // project stage: the gathered A [npix][lda] (a cluster of one reads its
  // ys) and the wp ring; in the reduce form the wp ring and the f32
  // partial tile [npix][pnw + 4]
  const int ya_bytes = p.cl > 1 ? p.npix * p.lda * 2 : 0;
  const int b_bytes = p.reduce ? p.stages * p.slot_b * 2 + p.npix * (p.pnw + 4) * 4
                               : ya_bytes + p.stages * p.slot_b * 2;
  p.off_const = y_bytes;
  p.off_bar = y_bytes + r16(c_bytes);   // the gather's mbarrier, 16 bytes
  p.off_xe = p.off_bar + 16;
  p.off_ringa = p.off_xe + p.mw * p.lds * 2;
  p.off_ringb = p.reduce ? p.off_xe : p.off_xe + ya_bytes;
  p.off_part = p.off_xe + p.stages * p.slot_b * 2;
  return p.off_xe + (a_bytes > b_bytes ? a_bytes : b_bytes);
}

using Kernel = void (*)(Params);

Kernel kernel_for(int ck) {
  switch (ck) {
    case 0: return fused_ir_kernel<0>;
    case 32: return fused_ir_kernel<32>;
    case 64: return fused_ir_kernel<64>;
    default: return fused_ir_kernel<128>;
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for a kernel when it
// needs more than it was last given (one host call per size, not per
// launch); the process uses one device
cudaError_t raise_smem(Kernel k, int ck, int smem) {
  static int given[4] = {0, 0, 0, 0};
  int& g = given[ck == 0 ? 0 : ck == 32 ? 1 : ck == 64 ? 2 : 3];
  if (smem <= g) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g = smem;
  return err;
}

// the launch configuration of a plan: grid (tiles * cl, n), 256 threads,
// the cluster dimension (cl, 1, 1) as a launch attribute
void config(const Params& p, int n, int smem, cudaLaunchConfig_t& cfg,
            cudaLaunchAttribute& attr) {
  const int tiles = p.tiles_x * ((p.H + p.th - 1) / p.th);
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * p.cl), static_cast<unsigned>(n), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(p.cl);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

extern "C" int fused_ir_launch(const void* x, const void* we, const void* be,
                               const void* wdw, const void* bdw,
                               const void* wp, const void* bp, void* out,
                               int n, int h, int w, int cin, int e, int p,
                               int expand, int act_e, int act_dw, int act_p,
                               int th, int tw, int cl, int es, int ps, int ck,
                               int pn, int stages, int reduce, int smem, void* stream) {
  Params prm{};
  prm.x = static_cast<const uint16_t*>(x);
  prm.we = static_cast<const uint16_t*>(we);
  prm.be = static_cast<const float*>(be);
  prm.wdw = static_cast<const uint16_t*>(wdw);
  prm.bdw = static_cast<const float*>(bdw);
  prm.wp = static_cast<const uint16_t*>(wp);
  prm.bp = static_cast<const float*>(bp);
  prm.out = static_cast<uint16_t*>(out);
  prm.H = h; prm.W = w; prm.Cin = cin; prm.E = e; prm.P = p;
  prm.expand = expand; prm.act_e = act_e; prm.act_dw = act_dw; prm.act_p = act_p;
  prm.th = th; prm.tw = tw; prm.cl = cl; prm.es = es; prm.ps = ps; prm.ck = ck;
  prm.pn = pn; prm.stages = stages; prm.reduce = reduce;
  if (layout(prm) != smem || smem > 232448 || !aligned16(x) || !aligned16(wp) ||
      !aligned16(out) || (expand && !aligned16(we)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel k = kernel_for(ck);
  cudaError_t err = raise_smem(k, ck, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(prm, n, smem, cfg, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, k, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
extern "C" int fused_ir_max_active_clusters(int h, int w, int cin, int e, int p,
                                            int expand, int th, int tw, int cl,
                                            int es, int ps, int ck, int pn,
                                            int stages, int reduce, int smem) {
  Params prm{};
  prm.H = h; prm.W = w; prm.Cin = cin; prm.E = e; prm.P = p; prm.expand = expand;
  prm.th = th; prm.tw = tw; prm.cl = cl; prm.es = es; prm.ps = ps; prm.ck = ck;
  prm.pn = pn; prm.stages = stages; prm.reduce = reduce;
  if (layout(prm) != smem) return -static_cast<int>(cudaErrorInvalidValue);
  const Kernel k = kernel_for(ck);
  cudaError_t err = raise_smem(k, ck, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(prm, 1, smem, cfg, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
