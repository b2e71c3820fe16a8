// MaxViT partition-attention blocks and the ConvLSTM update for Hopper.
//
// Replaces the Pallas TPU kernels `fused_block_pair` and `fused_stage`
// (leod_tpu/ops/maxvit_pallas.py:254 and :206; bodies `_apply_block` :46,
// `_lstm_update` :163). A Pallas program holds one whole image in VMEM;
// on Hopper one image of stage 1 (64x80x64 bf16, 655 KB) does not fit in
// the 227 KB of shared memory a block may use, so each block is split:
//
//   block_attention_kernel  one CTA per (window, head): gathers the
//       window's T tokens straight from NHWC through the window or grid
//       index map (no partition copy), LayerNorm 1, this head's q|k|v
//       GEMM, softmax(q k^T / sqrt(dh)) v, and writes the head's 32
//       channels of the pre-projection output back to NHWC positions.
//       One CTA per (window, head) rather than per window keeps stage 4
//       (one window per image) at 16 CTAs per image instead of 1.
//   block_mlp_kernel  per-token, 64 rows of B*H*W per CTA (wgmma's M):
//       the output projection, LayerScale, residual, LayerNorm 2, and the
//       MLP with the hidden dim walked in 64-wide chunks whose activations
//       stay in shared memory, on wgmma with every weight tile streamed
//       by TMA through a ring of shared-memory stages (section below).
//       Where B*H*W gives too few row tiles to fill the card (stages 3-4,
//       or any stage at small B), a thread-block cluster of up to 8 CTAs
//       shares a row tile: each projects C / size of the columns and
//       runs a share of the hidden chunks, and their fp32 partial sums
//       are added over distributed shared memory.
//   lstm_update_kernel  a tiled GEMM over rows B*H*W with K = 2C read
//       from the two pointers x and h (no concat); one CTA owns channels
//       j..j+15 of all four gates, so the gate epilogue writes h' and c'
//       in one pass.
//
// Bound on the H100: at the RVT-B Gen1 shapes the blocks do about
// 2*T*C*(3C + 2T) + 2*C*C + 16*C*C flops per token against 4*C bytes of
// activations in and out, i.e. hundreds of flops per byte, so they are
// bound by tensor-core operations (989 TFLOP/s bf16). The attention and
// LSTM kernels are first versions on warp-level WMMA (mma.sync) with the
// weight fragments read straight from L2, far from that bound; the MLP
// kernel feeds wgmma from TMA. Rounding points follow the Pallas kernel:
// fp32 accumulate, bias added in fp32, one rounding to the working dtype
// after each dense layer and LayerScale, LayerNorm and softmax in fp32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int DH = 32;            // dim_head
constexpr int QKV_H = 3 * DH;      // one head's packed q|k|v columns
constexpr int LD_QKV = QKV_H + 4;  // fp32 row stride of the q|k|v tile
constexpr int ATTN_THREADS = 256;

constexpr int LSTM_BM = 32;
constexpr int LSTM_BN = 16;        // channels per CTA (x 4 gates)
constexpr int LD_G = 4 * LSTM_BN + 4;

constexpr size_t kMaxSmem = 227 * 1024;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
// B given as the rows of W[n][k] (nn.Linear layout) is column-major B[k][n]
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float opt(const bf16* p, int i) {
  return p ? __bfloat162float(p[i]) : 0.f;
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// 0: tanh-approximate GELU (jax.nn.gelu's default), 1: SiLU, 2: ReLU
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) {
    const float k = 0.7978845608028654f;   // sqrt(2 / pi)
    return v * (0.5f * (1.f + tanhf(k * (v + 0.044715f * (v * v * v)))));
  }
  if (act == 1) return v * sigmoid(v);
  return fmaxf(v, 0.f);
}

// LayerNorm of one row of C values, fp32 statistics (two passes).
// One warp per row; `src` and `dst` may be shared or global.
__device__ __forceinline__ void layernorm_row(const bf16* src, bf16* dst,
                                              const bf16* w, const bf16* b,
                                              int C, float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += f32(src[c]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = f32(src[c]) - mean;
    v += d * d;
  }
  const float inv = 1.f / sqrtf(warp_sum(v) / C + eps);
  for (int c = lane; c < C; c += 32)
    dst[c] = __float2bfloat16((f32(src[c]) - mean) * inv * opt(w, c) + opt(b, c));
}

// ---------------------------------------------------------------------------
// Attention half of a block
// ---------------------------------------------------------------------------

// Shared-memory carve-up for T tokens (padded to TP, a multiple of 16).
__host__ __device__ inline size_t attn_smem(int T, int C, size_t off[5]) {
  const int TP = (T + 15) / 16 * 16;
  const int ldf = (TP + 4 > LD_QKV) ? TP + 4 : LD_QKV;
  const size_t sz[5] = {
      static_cast<size_t>(TP) * (C + 8) * 2,        // tok   bf16 [TP][C+8]
      static_cast<size_t>(TP) * ldf * 4,            // f32 scratch: qkv, S, out
      static_cast<size_t>(TP) * (DH + 8) * 2 * 3,   // q, k, v bf16 [TP][DH+8]
      static_cast<size_t>(TP) * (TP + 8) * 2,       // P     bf16 [TP][TP+8]
      static_cast<size_t>(TP) * 4};                 // token rows (int)
  size_t s = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = s;
    s = align128(s + sz[i]);
  }
  return s;
}

__global__ void __launch_bounds__(ATTN_THREADS) block_attention_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ o,
    const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
    const bf16* __restrict__ qkv_w, const bf16* __restrict__ qkv_b,
    int H, int W, int C, int ph, int pw, int grid_kind, float eps,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = ph * pw, TP = (T + 15) / 16 * 16, mt = TP / 16;
  size_t off[5];
  attn_smem(T, C, off);
  bf16* tok = reinterpret_cast<bf16*>(smem + off[0]);
  float* fs = reinterpret_cast<float*>(smem + off[1]);
  bf16* qs = reinterpret_cast<bf16*>(smem + off[2]);
  bf16* ks = qs + TP * (DH + 8);
  bf16* vs = ks + TP * (DH + 8);
  bf16* ps = reinterpret_cast<bf16*>(smem + off[3]);
  int* rows = reinterpret_cast<int*>(smem + off[4]);

  const int ldt = C + 8, ldq = DH + 8, ldp = TP + 8, lds = TP + 4,
            ldo = DH + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            nwarps = blockDim.x >> 5;
  const int nh = H / ph, nw = W / pw;
  const int head = blockIdx.y;
  const int b = blockIdx.x / (nh * nw), wi = blockIdx.x % (nh * nw);
  const int wy = wi / nw, wx = wi % nw;

  // token t = (tr, tc) of window (wy, wx); the grid partition indexes the
  // outer, strided dims (layers.py grid_partition)
  for (int t = threadIdx.x; t < TP; t += blockDim.x) {
    int row = -1;
    if (t < T) {
      const int tr = t / pw, tc = t % pw;
      const int r = grid_kind ? tr * nh + wy : wy * ph + tr;
      const int c = grid_kind ? tc * nw + wx : wx * pw + tc;
      row = (b * H + r) * W + c;
    }
    rows[t] = row;
  }
  __syncthreads();

  // 1. gather the window's tokens, LayerNorm 1 unless skipped
  for (int t = warp; t < TP; t += nwarps) {
    bf16* dst = tok + t * ldt;
    const int row = rows[t];
    if (row < 0) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.f);
    } else if (ln_w == nullptr) {
      const bf16* src = x + static_cast<size_t>(row) * C;
      for (int c = lane; c < C; c += 32) dst[c] = src[c];
    } else {
      layernorm_row(x + static_cast<size_t>(row) * C, dst, ln_w, ln_b, C,
                    eps, lane);
    }
  }
  __syncthreads();

  // 2. this head's q|k|v columns (head-major packing: head*3*dh + {q,k,v}*dh)
  const bf16* wq = qkv_w + static_cast<size_t>(head) * QKV_H * C;
  for (int tile = warp; tile < mt * (QKV_H / 16); tile += nwarps) {
    const int mi = tile / (QKV_H / 16), ni = tile % (QKV_H / 16);
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragA a;
      FragBt bw;
      wmma::load_matrix_sync(a, tok + mi * 16 * ldt + k0, ldt);
      wmma::load_matrix_sync(bw, wq + static_cast<size_t>(ni * 16) * C + k0, C);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(fs + mi * 16 * LD_QKV + ni * 16, acc, LD_QKV,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 3. + bias in fp32, one rounding, split into q, k, v (padded rows zero)
  for (int i = threadIdx.x; i < TP * QKV_H; i += blockDim.x) {
    const int t = i / QKV_H, col = i % QKV_H;
    const float v =
        t < T ? fs[t * LD_QKV + col] + opt(qkv_b, head * QKV_H + col) : 0.f;
    bf16* dst = col < DH ? qs : (col < 2 * DH ? ks : vs);
    dst[t * ldq + col % DH] = __float2bfloat16(v);
  }
  __syncthreads();

  // 4. logits = q k^T in fp32
  for (int tile = warp; tile < mt * mt; tile += nwarps) {
    const int mi = tile / mt, ni = tile % mt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < DH; k0 += 16) {
      FragA a;
      FragBt bk;
      wmma::load_matrix_sync(a, qs + mi * 16 * ldq + k0, ldq);
      wmma::load_matrix_sync(bk, ks + ni * 16 * ldq + k0, ldq);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(fs + mi * 16 * lds + ni * 16, acc, lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 5. softmax(logits * scale) over the T real keys, fp32, rounded once
  for (int t = warp; t < TP; t += nwarps) {
    float* srow = fs + t * lds;
    bf16* prow = ps + t * ldp;
    if (t >= T) {
      for (int c = lane; c < TP; c += 32) prow[c] = __float2bfloat16(0.f);
      continue;
    }
    float m = -INFINITY;
    for (int c = lane; c < T; c += 32) m = fmaxf(m, srow[c] * scale);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(srow[c] * scale - m);
      srow[c] = e;
      s += e;
    }
    s = warp_sum(s);
    __syncwarp();
    for (int c = lane; c < TP; c += 32)
      prow[c] = __float2bfloat16(c < T ? srow[c] / s : 0.f);
  }
  __syncthreads();

  // 6. out = P v
  for (int tile = warp; tile < mt * (DH / 16); tile += nwarps) {
    const int mi = tile / (DH / 16), ni = tile % (DH / 16);
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < TP; k0 += 16) {
      FragA a;
      FragB bv;
      wmma::load_matrix_sync(a, ps + mi * 16 * ldp + k0, ldp);
      wmma::load_matrix_sync(bv, vs + k0 * ldq + ni * 16, ldq);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(fs + mi * 16 * ldo + ni * 16, acc, ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 7. scatter this head's channels back to the tokens' NHWC positions
  for (int i = threadIdx.x; i < T * DH; i += blockDim.x) {
    const int t = i / DH, col = i % DH;
    o[static_cast<size_t>(rows[t]) * C + head * DH + col] =
        __float2bfloat16(fs[t * ldo + col]);
  }
}

// ---------------------------------------------------------------------------
// Per-token half of a block: proj, LayerScale, residual, LN2, MLP
// ---------------------------------------------------------------------------
//
// One CTA owns 64 token rows (wgmma's M) and runs three chained products
// on them, all with A and B in shared memory:
//   GEMM0  o [64, C] x proj^T          -> y = x + ls1 (proj + b), stored
//   GEMM1  z [64, C] x proj_in^T chunk -> act(. + b), bf16, into an H tile
//   GEMM2  H [64, 64] x proj_out^T     -> the [64, C] fp32 accumulator
// with z = LN2(y) written over the o rows. The hidden activations never
// reach device memory (flash attention's P.V pattern). Consumer
// warpgroups (one, or two at C = 512, each owning C / NWG output
// columns) issue wgmma.mma_async; one producer warp streams every weight
// tile through a ring of NS stages per warpgroup with TMA (128- or
// 64-byte swizzle, matching the wgmma descriptors), full/empty mbarriers.
//
// Shared memory at C = 512: the A tile (64 KB), 2 warpgroups x 2 stages
// of 32 KB, two 8 KB H tiles; the fp32 partial of a cluster's reduction
// (130 KB) reuses A and the ring once the last product is done. The y
// rows go through `out` (L2) rather than a 64 KB shared tile, which
// would leave one ring stage per warpgroup.

constexpr int MLP_BM = 64;         // token rows per CTA (wgmma's M)
constexpr int MLP_HBUF = 8192;     // bytes of one H tile (64 x 64 bf16)

template <int C>
struct MlpShape {
  static constexpr int NWG = C > 256 ? 2 : 1;   // consumer warpgroups
  static constexpr int NW = C / NWG;            // output columns of each
  static constexpr int KB = C >= 64 ? 64 : 32;  // K-block of a C-deep operand
  static constexpr int NKB = C / KB;
  static constexpr int SW = KB * 2;             // its swizzle (= row) bytes
  static constexpr int NS = C > 256 ? 2 : 4;    // ring stages per warpgroup
  static constexpr int STAGE = NW * 128;        // bytes of one stage
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int MINB = C >= 256 ? 1 : (C == 128 ? 2 : 3);
  static constexpr int RING = 128 * C;          // offset of the ring (after A)
  static constexpr int HOFF = RING + NWG * NS * STAGE;
  static constexpr int BOFF = HOFF + 2 * MLP_HBUF;
  static constexpr int SMEM = BOFF + 2 * NWG * NS * 8 + 1024;  // + alignment
};

struct MlpArgs {
  const bf16 *x, *o, *proj_b, *ls1, *ln_w, *ln_b, *in_b, *out_b, *ls2;
  bf16* out;      // holds the y rows until the last step overwrites them
  int R, inner, gated, act;
  float eps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte `b` of row `r` in a K-block whose rows are `sw`
// bytes, swizzled as TMA's SWIZZLE_<sw>B writes it (16-byte chunks XORed
// with the row's position in its 1024- or 512-byte atom).
__device__ __forceinline__ uint32_t swz(int r, int b, int sw) {
  const uint32_t o = static_cast<uint32_t>(r * sw + b);
  return o ^ (((o >> 7) & static_cast<uint32_t>(sw / 16 - 1)) << 4);
}

// wgmma descriptor of a K-major tile in that layout: rows of `sw` bytes,
// 8-row groups `8 * sw` bytes apart (SBO), LBO unused when swizzled.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int sw) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sw / 2) << 32) |
         (static_cast<uint64_t>(sw == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits for the phase of parity `parity` to complete. A wait of more
// than about 10 s (2^34 cycles) can only be a fault of the kernel: it
// traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// all consumer threads (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads above wgmma_wait0
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, N] (+)= A[64, 16] B[N, 16]^T, A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// barrier.cluster: arrive releases this thread's writes (shared and
// global) to the cluster, wait acquires every peer's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
// 16 bytes at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float4 ld_peer(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// Producer: one thread walks the CTA's weight tiles in the consumers'
// order, for each warpgroup its own ring stage: the projection's
// K-blocks for this CTA's columns (kpt K-blocks a stage), then per hidden
// chunk j the proj_in rows (GEMM1) and the proj_out columns (GEMM2).
// `first`: issue the projection's tiles, else the MLP's.
template <int C>
__device__ void mlp_produce(const CUtensorMap* m_proj, const CUtensorMap* m_in,
                            const CUtensorMap* m_out, unsigned char* ring,
                            uint64_t* full, uint64_t* empty, int inner,
                            int gated, int col0, int n0, int j0, int j1,
                            bool first, int& stage, uint32_t& phase) {
  using S = MlpShape<C>;
  const int hc = gated ? 32 : 64;       // hidden units per chunk
  const int hr = hc / S::NWG;           // of them, per warpgroup
  const int kpt = S::STAGE / (n0 * S::SW) < S::NKB ? S::STAGE / (n0 * S::SW) : S::NKB;
  const int tiles = first ? S::NKB / kpt : 2 * (j1 - j0);
  for (int t = 0; t < tiles; ++t) {
    for (int w = 0; w < S::NWG; ++w) {
      const int slot = w * S::NS + stage;
      unsigned char* dst = ring + slot * S::STAGE;
      mbar_wait(&empty[slot], phase ^ 1);
      if (first) {
        mbar_expect_tx(&full[slot], kpt * n0 * S::SW);
        for (int k = 0; k < kpt; ++k)
          tma_load_2d(dst + k * n0 * S::SW, m_proj, &full[slot],
                      (t * kpt + k) * S::KB, col0 + w * n0);
        continue;
      }
      const int j = j0 + t / 2;
      if (t % 2 == 0) {
        mbar_expect_tx(&full[slot], hr * C * 2 * (gated ? 2 : 1));
        for (int kb = 0; kb < S::NKB; ++kb) {
          tma_load_2d(dst + kb * hr * S::SW, m_in, &full[slot], kb * S::KB,
                      j * hc + w * hr);
          if (gated)
            tma_load_2d(dst + (S::NKB + kb) * hr * S::SW, m_in, &full[slot],
                        kb * S::KB, inner + j * hc + w * hr);
        }
      } else {
        mbar_expect_tx(&full[slot], S::NW * hc * 2);
        tma_load_2d(dst, m_out, &full[slot], j * hc, w * S::NW);
      }
    }
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The projection of this CTA's columns col0.. (N0 per warpgroup) and
// y = x + ls1 * (proj + b), each step rounded as in the plain path, into
// `out` (read back by every CTA of the cluster for LayerNorm 2).
template <int C, int N0>
__device__ __forceinline__ void mlp_project(const MlpArgs& p,
                                            unsigned char* smem,
                                            uint64_t* full, uint64_t* empty,
                                            int w, int col0, int row0, int wr,
                                            int q2, int& stage,
                                            uint32_t& phase) {
  using S = MlpShape<C>;
  constexpr int KPT = S::STAGE / (N0 * S::SW) < S::NKB ? S::STAGE / (N0 * S::SW) : S::NKB;
  float acc[N0 / 2];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < S::NKB / KPT; ++t) {
    const int slot = w * S::NS + stage;
    mbar_wait(&full[slot], phase);
    const uint32_t b = smem_u32(smem + S::RING + slot * S::STAGE);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const uint32_t a = smem_u32(smem + (t * KPT + k) * 64 * S::SW);
#pragma unroll
      for (int kk = 0; kk < S::KB / 16; ++kk)
        wgmma_ss<N0>(acc, gmma_desc(a + 32 * kk, S::SW),
                     gmma_desc(b + k * N0 * S::SW + 32 * kk, S::SW), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<N0 / 2>(acc);
    mbar_arrive(&empty[slot]);
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < N0 / 8; ++i) {
    const int col = col0 + w * N0 + 8 * i + q2;
    const float b0 = opt(p.proj_b, col), b1 = opt(p.proj_b, col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr + 8 * h;
      if (row >= p.R) continue;
      float v0 = round_bf16(acc[4 * i + 2 * h] + b0);
      float v1 = round_bf16(acc[4 * i + 2 * h + 1] + b1);
      if (p.ls1) {
        v0 = round_bf16(v0 * f32(p.ls1[col]));
        v1 = round_bf16(v1 * f32(p.ls1[col + 1]));
      }
      const size_t idx = static_cast<size_t>(row) * C + col;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(p.x + idx);
      *reinterpret_cast<__nv_bfloat162*>(p.out + idx) =
          __floats2bfloat162_rn(f32(xv.x) + v0, f32(xv.y) + v1);
    }
  }
}

// A cluster of CS CTAs (2, 4 or 8; the launch's cluster dimension x)
// shares a row tile (a CTA launched alone has the tile to itself): CTA r
// projects columns [r C/CS, (r+1) C/CS) and writes their y rows; after
// a cluster barrier every CTA runs LN2 on the whole rows and the MLP
// over its share of the hidden chunks; each keeps
// its fp32 [64, C] partial in its own shared memory, and CTA r sums the
// peers' partials of its columns over distributed shared memory in rank
// order (so runs agree bit for bit) and writes them out.
template <int C>
__global__ void __launch_bounds__(MlpShape<C>::THREADS, MlpShape<C>::MINB)
    block_mlp_kernel(const __grid_constant__ CUtensorMap m_proj,
                     const __grid_constant__ CUtensorMap m_in,
                     const __grid_constant__ CUtensorMap m_out,
                     const MlpArgs p) {
  using S = MlpShape<C>;
  constexpr int HN = 64 / S::NWG;   // GEMM1 columns per warpgroup
  constexpr int HG = HN / 2;        // gated: of each half
  constexpr int NCT = S::NWG * 128; // consumer threads
  constexpr int LDP = C + 4;        // fp32 row stride of the partial
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + S::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BOFF);
  uint64_t* empty = full + S::NWG * S::NS;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * MLP_BM;
  const int hc = p.gated ? 32 : 64;
  const int nchunks = p.inner / hc;
  const int cs = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int j0 = rank * nchunks / cs, j1 = (rank + 1) * nchunks / cs;
  const int ccols = C / cs, col0 = rank * ccols;   // this CTA's columns

  if (tid == 0) {
    for (int i = 0; i < S::NWG * S::NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCT) {
    // producer warp: it takes part in the three cluster barriers, and
    // arrives at the first before it streams the MLP's tiles, which the
    // consumers free only after that barrier
    int stage = 0;
    uint32_t phase = 0;
    auto produce = [&](bool first) {
      if (tid == NCT)
        mlp_produce<C>(&m_proj, &m_in, &m_out, ring, full, empty, p.inner,
                       p.gated, col0, ccols / S::NWG, j0, j1, first, stage,
                       phase);
    };
    produce(true);
    if (cs == 1) {
      produce(false);
      return;
    }
    __syncwarp();
    cluster_arrive();
    produce(false);
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  const int w = tid / 128, t = tid % 128;
  const int wr = (t / 32) * 16 + (t % 32) / 4;  // the thread's rows wr, wr + 8
  const int q2 = (t % 4) * 2;                   // its column pair in each 8
  int stage = 0;
  uint32_t phase = 0;

  // 1. attention output rows into A, swizzled (zero past R)
#pragma unroll
  for (int it = 0; it < MLP_BM * C / 8 / NCT; ++it) {
    const int i = tid + it * NCT;
    const int r = i / (C / 8), c8 = i % (C / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.R)
      v = reinterpret_cast<const uint4*>(p.o + static_cast<size_t>(row0 + r) * C)[c8];
    const int kb = c8 / (S::KB / 8), b = (c8 % (S::KB / 8)) * 16;
    *reinterpret_cast<uint4*>(smem + kb * 64 * S::SW + swz(r, b, S::SW)) = v;
  }
  fence_async_smem();
  consumer_sync(NCT);

  // 2. projection and residual for this CTA's columns, y rows to `out`
  if (cs == 1) {
    mlp_project<C, S::NW>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else if (cs == 2) {
    mlp_project<C, S::NW / 2>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else if (cs == 4) {
    if constexpr (S::NW / 4 >= 8)
      mlp_project<C, S::NW / 4>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else {
    if constexpr (S::NW / 8 >= 8)
      mlp_project<C, S::NW / 8>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  }
  if (cs == 1) {
    consumer_sync(NCT);
  } else {
    cluster_arrive();
    cluster_wait();
  }

  // 3. z = LayerNorm 2 of the whole y rows, over the o rows in A (zero
  // past R); fp32 statistics in two passes, one warp a row, each warp's
  // loads of LG rows in flight together
  {
    constexpr int NCH = (C / 8 + 31) / 32;   // 16-byte chunks per lane
    constexpr int LG = 4;                    // rows a warp loads at once
    const int warp = tid / 32, lane = tid % 32;
    for (int r0 = warp * LG; r0 < MLP_BM; r0 += NCT / 32 * LG) {
      uint4 raw[LG][NCH];
#pragma unroll
      for (int g = 0; g < LG; ++g)
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const int row = row0 + r0 + g, c8 = lane + 32 * u;
          raw[g][u] = make_uint4(0u, 0u, 0u, 0u);
          if (row < p.R && c8 < C / 8)
            raw[g][u] = __ldcg(reinterpret_cast<const uint4*>(
                                   p.out + static_cast<size_t>(row) * C) + c8);
        }
#pragma unroll
      for (int g = 0; g < LG; ++g) {
        const int r = r0 + g;
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const bf16* e = reinterpret_cast<const bf16*>(&raw[g][u]);
#pragma unroll
          for (int k = 0; k < 8; ++k) s += f32(e[k]);
        }
        const float mean = warp_sum(s) / C;
        float ss = 0.f;
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          if (lane + 32 * u >= C / 8) continue;
          const bf16* e = reinterpret_cast<const bf16*>(&raw[g][u]);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = f32(e[k]) - mean;
            ss += d * d;
          }
        }
        const float inv = 1.f / sqrtf(warp_sum(ss) / C + p.eps);
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const int c8 = lane + 32 * u;
          if (c8 >= C / 8) continue;
          uint4 z = make_uint4(0u, 0u, 0u, 0u);
          if (row0 + r < p.R) {
            const bf16* e = reinterpret_cast<const bf16*>(&raw[g][u]);
            bf16* ze = reinterpret_cast<bf16*>(&z);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int c = c8 * 8 + k;
              ze[k] = __float2bfloat16((f32(e[k]) - mean) * inv *
                                       f32(p.ln_w[c]) + f32(p.ln_b[c]));
            }
          }
          const int kb = c8 / (S::KB / 8), b = (c8 % (S::KB / 8)) * 16;
          *reinterpret_cast<uint4*>(smem + kb * 64 * S::SW + swz(r, b, S::SW)) = z;
        }
      }
    }
  }
  fence_async_smem();
  consumer_sync(NCT);

  // 4. MLP over this CTA's hidden chunks: GEMM1 into registers, bias and
  // activation, bf16 into the H tile (two, alternating), GEMM2 into acc
  float acc[S::NW / 2];
#pragma unroll
  for (int i = 0; i < S::NW / 2; ++i) acc[i] = 0.f;
  float hreg[HN / 2];
  const int hsw = p.gated ? 64 : 128;   // H tile rows: hc bf16
  int pend = -1;                         // ring slot GEMM2 may still read
  for (int j = j0; j < j1; ++j) {
    unsigned char* H = smem + S::HOFF + ((j - j0) & 1) * MLP_HBUF;
    const int slot1 = w * S::NS + stage;
    mbar_wait(&full[slot1], phase);
    const uint32_t b1 = smem_u32(ring + slot1 * S::STAGE);
    wgmma_fence();
    if (!p.gated) {
#pragma unroll
      for (int kb = 0; kb < S::NKB; ++kb) {
        const uint32_t a = smem_u32(smem + kb * 64 * S::SW);
#pragma unroll
        for (int k = 0; k < S::KB / 16; ++k)
          wgmma_ss<HN>(hreg, gmma_desc(a + 32 * k, S::SW),
                       gmma_desc(b1 + kb * HN * S::SW + 32 * k, S::SW),
                       kb + k > 0);
      }
    } else {
#pragma unroll
      for (int kb = 0; kb < S::NKB; ++kb) {
        const uint32_t a = smem_u32(smem + kb * 64 * S::SW);
#pragma unroll
        for (int k = 0; k < S::KB / 16; ++k) {
          wgmma_ss<HG>(hreg, gmma_desc(a + 32 * k, S::SW),
                       gmma_desc(b1 + kb * HG * S::SW + 32 * k, S::SW),
                       kb + k > 0);
          wgmma_ss<HG>(hreg + HG / 2, gmma_desc(a + 32 * k, S::SW),
                       gmma_desc(b1 + (S::NKB + kb) * HG * S::SW + 32 * k, S::SW),
                       kb + k > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait0();      // this chunk's GEMM1 and the last chunk's GEMM2
    fence_regs<HN / 2>(hreg);
    fence_regs<S::NW / 2>(acc);
    mbar_arrive(&empty[slot1]);
    if (pend >= 0) mbar_arrive(&empty[pend]);
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }

    if (!p.gated) {
#pragma unroll
      for (int i = 0; i < HN / 8; ++i) {
        const int cl = w * HN + 8 * i + q2;
        const float b0 = opt(p.in_b, j * 64 + cl), b1v = opt(p.in_b, j * 64 + cl + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(H + swz(wr + 8 * h, cl * 2, 128)) =
              __floats2bfloat162_rn(activate(hreg[4 * i + 2 * h] + b0, p.act),
                                    activate(hreg[4 * i + 2 * h + 1] + b1v, p.act));
      }
    } else {
#pragma unroll
      for (int i = 0; i < HG / 8; ++i) {
        const int cl = w * HG + 8 * i + q2;
        const float a0 = opt(p.in_b, j * 32 + cl), a1 = opt(p.in_b, j * 32 + cl + 1);
        const float g0 = opt(p.in_b, p.inner + j * 32 + cl);
        const float g1 = opt(p.in_b, p.inner + j * 32 + cl + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(H + swz(wr + 8 * h, cl * 2, 64)) =
              __floats2bfloat162_rn(
                  (hreg[e] + a0) * activate(hreg[HG / 2 + e] + g0, p.act),
                  (hreg[e + 1] + a1) * activate(hreg[HG / 2 + e + 1] + g1, p.act));
        }
      }
    }
    fence_async_smem();
    consumer_sync(NCT);

    const int slot2 = w * S::NS + stage;
    mbar_wait(&full[slot2], phase);
    const uint32_t b2 = smem_u32(ring + slot2 * S::STAGE), ha = smem_u32(H);
    wgmma_fence();
    for (int k = 0; k < hc / 16; ++k)
      wgmma_ss<S::NW>(acc, gmma_desc(ha + 32 * k, hsw),
                      gmma_desc(b2 + 32 * k, hsw), 1);
    wgmma_commit();
    pend = slot2;
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait0();
  fence_regs<S::NW / 2>(acc);
  if (pend >= 0) mbar_arrive(&empty[pend]);

  if (cs == 1) {
    // alone on its tile: out = y + ls2 * (mlp + b) from the registers
#pragma unroll
    for (int i = 0; i < S::NW / 8; ++i) {
      const int col = w * S::NW + 8 * i + q2;
      const float b0 = opt(p.out_b, col), b1 = opt(p.out_b, col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wr + 8 * h;
        if (row >= p.R) continue;
        const size_t idx = static_cast<size_t>(row) * C + col;
        float m0 = round_bf16(acc[4 * i + 2 * h] + b0);
        float m1 = round_bf16(acc[4 * i + 2 * h + 1] + b1);
        if (p.ls2) {
          m0 = round_bf16(m0 * f32(p.ls2[col]));
          m1 = round_bf16(m1 * f32(p.ls2[col + 1]));
        }
        const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(p.out + idx);
        *reinterpret_cast<__nv_bfloat162*>(p.out + idx) =
            __floats2bfloat162_rn(f32(yv.x) + m0, f32(yv.y) + m1);
      }
    }
    return;
  }
  // every wgmma of both warpgroups is done with A and the ring, which the
  // partial now overwrites
  consumer_sync(NCT);

  // 5. this CTA's fp32 partial [64, C] into its own shared memory
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < S::NW / 8; ++i) {
    const int col = w * S::NW + 8 * i + q2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (wr + 8 * h) * LDP + col) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  cluster_arrive();
  cluster_wait();

  // 6. out = y + ls2 * (sum of the cluster's partials + b) for this CTA's
  // columns, the partials added in rank order
  for (int i = tid; i < MLP_BM * ccols / 4; i += NCT) {
    const int r = i / (ccols / 4), col = col0 + (i % (ccols / 4)) * 4;
    const int row = row0 + r;
    if (row >= p.R) continue;
    float4 sum = ld_peer(part + r * LDP + col, 0);
    for (int q = 1; q < cs; ++q) {
      const float4 v = ld_peer(part + r * LDP + col, q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float m[4] = {sum.x, sum.y, sum.z, sum.w};
    const size_t idx = static_cast<size_t>(row) * C + col;
    const uint2 yraw = *reinterpret_cast<const uint2*>(p.out + idx);
    const bf16* y = reinterpret_cast<const bf16*>(&yraw);
    uint2 oraw;
    bf16* o = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = round_bf16(m[k] + opt(p.out_b, col + k));
      if (p.ls2) v = round_bf16(v * f32(p.ls2[col + k]));
      o[k] = __float2bfloat16(f32(y[k]) + v);
    }
    *reinterpret_cast<uint2*>(p.out + idx) = oraw;
  }
  // peers may still read this CTA's partial
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// ConvLSTM update: mix = x Kx + h Kh + b, gates [f, i, o, g]
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_state(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_state(const bf16* p, size_t i) { return f32(p[i]); }
__device__ __forceinline__ void store_state(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_state(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__host__ __device__ inline size_t lstm_smem(int C, size_t off[2]) {
  off[0] = 0;                                                     // x, h rows
  off[1] = align128(static_cast<size_t>(2) * LSTM_BM * (C + 8) * 2);  // gates
  return align128(off[1] + static_cast<size_t>(LSTM_BM) * LD_G * 4);
}

template <typename CT>
__global__ void __launch_bounds__(256) lstm_update_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ h,
    const CT* __restrict__ c, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, bf16* __restrict__ h_out,
    CT* __restrict__ c_out, int R, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off[2];
  lstm_smem(C, off);
  const int lda = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* hs = xs + LSTM_BM * lda;
  float* G = reinterpret_cast<float*>(smem + off[1]);
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * LSTM_BM, j0 = blockIdx.y * LSTM_BN;

  const int vec = C / 8;
  for (int i = threadIdx.x; i < 2 * LSTM_BM * vec; i += blockDim.x) {
    const int which = i / (LSTM_BM * vec), r = (i / vec) % LSTM_BM, v = i % vec;
    const bf16* src = which ? h : x;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < R)
      val = reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * C)[v];
    *reinterpret_cast<uint4*>((which ? hs : xs) + r * lda + v * 8) = val;
  }
  __syncthreads();

  // warp = (row tile, gate): columns gate*C + j0 .. +16 of the [4C, 2C] kernel
  const int mi = warp / 4, gate = warp % 4;
  const bf16* wg = w + static_cast<size_t>(gate * C + j0) * (2 * C);
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  for (int k0 = 0; k0 < C; k0 += 16) {
    FragA a;
    FragBt bw;
    wmma::load_matrix_sync(a, xs + mi * 16 * lda + k0, lda);
    wmma::load_matrix_sync(bw, wg + k0, 2 * C);
    wmma::mma_sync(acc, a, bw, acc);
  }
  for (int k0 = 0; k0 < C; k0 += 16) {
    FragA a;
    FragBt bw;
    wmma::load_matrix_sync(a, hs + mi * 16 * lda + k0, lda);
    wmma::load_matrix_sync(bw, wg + C + k0, 2 * C);
    wmma::mma_sync(acc, a, bw, acc);
  }
  wmma::store_matrix_sync(G + mi * 16 * LD_G + gate * LSTM_BN, acc, LD_G,
                          wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < LSTM_BM * LSTM_BN; i += blockDim.x) {
    const int r = i / LSTM_BN, jj = i % LSTM_BN, row = row0 + r;
    if (row >= R) continue;
    const int ch = j0 + jj;
    const float* g = G + r * LD_G;
    const float fg = sigmoid(g[jj] + opt(bias, ch));
    const float ig = sigmoid(g[LSTM_BN + jj] + opt(bias, C + ch));
    const float og = sigmoid(g[2 * LSTM_BN + jj] + opt(bias, 2 * C + ch));
    const float cg = tanhf(g[3 * LSTM_BN + jj] + opt(bias, 3 * C + ch));
    const size_t idx = static_cast<size_t>(row) * C + ch;
    const float cn = fg * load_state(c, idx) + ig * cg;
    h_out[idx] = __float2bfloat16(og * tanhf(cn));
    store_state(c_out, idx, cn);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Tensor maps for the MLP kernel's TMA loads
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

struct MapKey {
  const void* ptr;
  uint64_t cols, rows;
  uint32_t box_cols, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && cols == o.cols && rows == o.rows &&
           box_cols == o.box_cols && box_rows == o.box_rows;
  }
};

// A [rows, cols] row-major bf16 matrix read in boxes of box_rows x
// box_cols (box_cols * 2 = 128 or 64 bytes, the swizzle). Weights do not
// move between steps, so maps are kept by their arguments (64 entries,
// oldest replaced first).
bool weight_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  static std::mutex lock;
  static EncodeTiledFn encode = nullptr;
  static MapKey keys[64];
  static CUtensorMap maps[64];
  static int used = 0, next = 0;
  const MapKey key{ptr, cols, rows, box_cols, box_rows};
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return false;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  return true;
}

template <int C>
cudaError_t launch_mlp(const MlpArgs& a, const void* proj_w, const void* in_w,
                       const void* out_w, int cluster, cudaStream_t st) {
  using S = MlpShape<C>;
  const int hc = a.gated ? 32 : 64;
  CUtensorMap m_proj, m_in, m_out;
  if (!weight_map(&m_proj, proj_w, C, C, S::NW / cluster, S::KB) ||
      !weight_map(&m_in, in_w, a.gated ? 2 * a.inner : a.inner, C,
                  hc / S::NWG, S::KB) ||
      !weight_map(&m_out, out_w, C, a.inner, S::NW, hc))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem(block_mlp_kernel<C>, S::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(cluster, (a.R + MLP_BM - 1) / MLP_BM);
  if (cluster == 1) {
    // alone on its tile, a CTA needs no cluster: no cluster barrier,
    // the epilogue straight from the registers
    block_mlp_kernel<C><<<grid, S::THREADS, S::SMEM, st>>>(m_proj, m_in,
                                                            m_out, a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, block_mlp_kernel<C>, m_proj, m_in, m_out, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int mlp_smem_bytes(int C) {
  switch (C) {
    case 32: return MlpShape<32>::SMEM;
    case 64: return MlpShape<64>::SMEM;
    case 128: return MlpShape<128>::SMEM;
    case 256: return MlpShape<256>::SMEM;
    case 512: return MlpShape<512>::SMEM;
    default: return 0;
  }
}

// The cluster sizes a width takes: each CTA projects at least 8 columns
// a warpgroup and owns at least one hidden chunk.
bool mlp_cluster_ok(int C, int inner, int gated, int cluster) {
  const int nwg = C > 256 ? 2 : 1;
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         C / nwg / cluster >= 8 && cluster <= inner / (gated ? 32 : 64);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success). Optional vectors may be NULL.

extern "C" int leod_block_attention(const void* x, void* o, const void* ln_w,
                                    const void* ln_b, const void* qkv_w,
                                    const void* qkv_b, int B, int H, int W,
                                    int C, int ph, int pw, int grid_kind,
                                    float eps, void* stream) {
  if (C % DH || H % ph || W % pw) return cudaErrorInvalidValue;
  size_t off[5];
  const size_t smem = attn_smem(ph * pw, C, off);
  cudaError_t e = set_smem(block_attention_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * (H / ph) * (W / pw), C / DH);
  block_attention_kernel<<<grid, ATTN_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(o),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(qkv_w), static_cast<const bf16*>(qkv_b), H, W,
      C, ph, pw, grid_kind, eps, 1.f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// How many CTAs (a cluster) share a row tile: the largest size among
// 1, 2, 4, 8 that the width takes and that keeps the grid within one
// wave (num_sms x the CTAs an SM holds by shared memory). Splitting a
// grid that already fills the card costs more than it gains: every CTA
// pays its o load, LN2 over the whole rows and the cluster's barriers
// (stage 1 at B = 8 ran 2.2x slower split 4 ways than alone, H100).
extern "C" int leod_block_mlp_cluster(int R, int C, int inner, int gated,
                                      int num_sms) {
  const int smem = mlp_smem_bytes(C);
  if (R < 1 || smem == 0) return 1;
  const long tiles = (R + MLP_BM - 1) / MLP_BM;
  const long slots = static_cast<long>(num_sms) * ((228 * 1024) / (smem + 1024));
  int best = 1;
  for (int cs = 2; cs <= 8; cs *= 2)
    if (mlp_cluster_ok(C, inner, gated, cs) && tiles * cs <= slots) best = cs;
  return best;
}

// C in {32, 64, 128, 256, 512}; `cluster` CTAs share each 64-row tile
extern "C" int leod_block_mlp(const void* x, const void* o, void* out,
                              const void* proj_w, const void* proj_b,
                              const void* ls1, const void* ln_w,
                              const void* ln_b, const void* in_w,
                              const void* in_b, const void* out_w,
                              const void* out_b, const void* ls2, int R,
                              int C, int inner, int gated, int act, float eps,
                              int cluster, void* stream) {
  if (R < 1 || inner % (gated ? 32 : 64) || ln_w == nullptr ||
      ln_b == nullptr || !mlp_cluster_ok(C, inner, gated, cluster))
    return cudaErrorInvalidValue;
  MlpArgs a;
  a.x = static_cast<const bf16*>(x);
  a.o = static_cast<const bf16*>(o);
  a.proj_b = static_cast<const bf16*>(proj_b);
  a.ls1 = static_cast<const bf16*>(ls1);
  a.ln_w = static_cast<const bf16*>(ln_w);
  a.ln_b = static_cast<const bf16*>(ln_b);
  a.in_b = static_cast<const bf16*>(in_b);
  a.out_b = static_cast<const bf16*>(out_b);
  a.ls2 = static_cast<const bf16*>(ls2);
  a.out = static_cast<bf16*>(out);
  a.R = R;
  a.inner = inner;
  a.gated = gated;
  a.act = act;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch_mlp<32>(a, proj_w, in_w, out_w, cluster, st);
    case 64: return launch_mlp<64>(a, proj_w, in_w, out_w, cluster, st);
    case 128: return launch_mlp<128>(a, proj_w, in_w, out_w, cluster, st);
    case 256: return launch_mlp<256>(a, proj_w, in_w, out_w, cluster, st);
    case 512: return launch_mlp<512>(a, proj_w, in_w, out_w, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int leod_lstm_update(const void* x, const void* h, const void* c,
                                const void* w, const void* b, void* h_out,
                                void* c_out, int R, int C, int c_f32,
                                void* stream) {
  if (C % LSTM_BN) return cudaErrorInvalidValue;
  size_t off[2];
  const size_t smem = lstm_smem(C, off);
  const dim3 grid((R + LSTM_BM - 1) / LSTM_BM, C / LSTM_BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (c_f32) {
    e = set_smem(lstm_update_kernel<float>, smem);
    if (e != cudaSuccess) return e;
    lstm_update_kernel<float><<<grid, 256, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(h),
        static_cast<const float*>(c), static_cast<const bf16*>(w),
        static_cast<const bf16*>(b), static_cast<bf16*>(h_out),
        static_cast<float*>(c_out), R, C);
  } else {
    e = set_smem(lstm_update_kernel<bf16>, smem);
    if (e != cudaSuccess) return e;
    lstm_update_kernel<bf16><<<grid, 256, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(h),
        static_cast<const bf16*>(c), static_cast<const bf16*>(w),
        static_cast<const bf16*>(b), static_cast<bf16*>(h_out),
        static_cast<bf16*>(c_out), R, C);
  }
  return cudaGetLastError();
}
