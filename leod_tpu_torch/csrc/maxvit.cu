// MaxViT partition-attention blocks and the ConvLSTM update for Hopper.
//
// Replaces the Pallas TPU kernels `fused_block_pair` and `fused_stage`
// (leod_tpu/ops/maxvit_pallas.py:254 and :206; bodies `_apply_block` :46,
// `_lstm_update` :163). A Pallas program holds one whole image in VMEM;
// on Hopper one image of stage 1 (64x80x64 bf16, 655 KB) does not fit in
// the 227 KB of shared memory a block may use, so each block is split:
//
//   block_attention_kernel  a CTA per group of windows and of heads:
//       gathers the windows' tokens straight from NHWC through the window
//       or grid index map (no partition copy) and normalizes each once
//       (LayerNorm 1) into a tile that wgmma reads; per head, q|k|v on
//       wgmma with the weight rows streamed by TMA through a ring, then
//       softmax(q k^T / sqrt(dh)) v on mma.sync with S and P held in
//       registers; writes the heads' channels of the pre-projection
//       output back to NHWC positions. Where windows are few (stages
//       3-4, or any stage at small B), the head groups of a window group
//       are a cluster that shares the LayerNorm over distributed shared
//       memory (section below).
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
//   block_residual_kernel  the model axis's last residual (below).
//   lstm_update_kernel  the gate product [rows, 2C] x [2C, 4C] on wgmma,
//       a CTA per 128 rows of B*H*W and 64 channels of all four gates,
//       with x and h (no concat) and the weight streamed by TMA through
//       a ring; the gates meet in the accumulator registers, where the
//       epilogue writes h' and c'. Where rows are few and K long, a
//       cluster of CTAs splits K and adds its partial sums over
//       distributed shared memory (section below).
//
// Bound on the H100: at the RVT-B Gen1 shapes the blocks do about
// 2*T*C*(3C + 2T) + 2*C*C + 16*C*C flops per token against 4*C bytes of
// activations in and out, i.e. hundreds of flops per byte, so they are
// bound by tensor-core operations (989 TFLOP/s bf16). The ConvLSTM update
// does 16*C*C flops per token against 10*C bytes: bytes bound below
// C = 256 (its section). All three feed wgmma from TMA. Rounding points
// follow the Pallas kernel:
// fp32 accumulate, bias added in fp32, one rounding to the working dtype
// after each dense layer and LayerScale, LayerNorm and softmax in fp32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr size_t kMaxSmem = 227 * 1024;

// The K-block of a C-deep operand: the largest of 64, 32 and 16 columns
// that divides C (its rows are 128, 64 or 32 bytes, the swizzle). RVT-T
// and RVT-B (C = 32-512) take 64, or 32 at C = 32; RVT-S (48-384) takes
// 16 at C = 48 and 32 at C = 96.
__host__ __device__ constexpr int kblock(int c) {
  return c % 64 == 0 ? 64 : (c % 32 == 0 ? 32 : 16);
}

// K-blocks one ring stage of `stage` bytes holds of an n0-row operand
// with rows of `sw` bytes: the largest divisor of nkb that fits
__host__ __device__ constexpr int kblocks_per_stage(int stage, int n0, int sw,
                                                    int nkb) {
  int k = stage / (n0 * sw) < nkb ? stage / (n0 * sw) : nkb;
  while (nkb % k) --k;
  return k;
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
// tile through a ring of NS stages per warpgroup with TMA (128-, 64- or
// 32-byte swizzle, matching the wgmma descriptors), full/empty mbarriers.
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
  static constexpr int KB = kblock(C);          // K-block of a C-deep operand
  static constexpr int NKB = C / KB;
  static constexpr int SW = KB * 2;             // its swizzle (= row) bytes
  static constexpr int NS = C > 256 ? 2 : 4;    // ring stages per warpgroup
  static constexpr int STAGE = NW * 128;        // bytes of one stage
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int MINB = C >= 192 ? 1 : (C >= 96 ? 2 : 3);
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
  // the model axis's mode (tp = 1): the out-projection summed over the
  // model group `a` (fp32, no bias) replaces o and GEMM0, `out` keeps
  // the y rows (x1), and the fp32 partial MLP output, without its bias,
  // goes to `part`
  int tp;
  const float* a;
  float* part;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte `b` of row `r` in a K-block whose rows are `sw`
// bytes, swizzled as TMA's SWIZZLE_<sw>B writes it (16-byte chunks XORed
// with the row's position in its 1024-, 512- or 256-byte atom).
__device__ __forceinline__ uint32_t swz(int r, int b, int sw) {
  const uint32_t o = static_cast<uint32_t>(r * sw + b);
  return o ^ (((o >> 7) & static_cast<uint32_t>(sw / 16 - 1)) << 4);
}

// wgmma descriptor of a K-major tile in that layout: rows of `sw` bytes,
// 8-row groups `8 * sw` bytes apart (SBO), LBO unused when swizzled;
// layout type 1, 2 or 3 for the 128-, 64- or 32-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int sw) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sw / 2) << 32) |
         (static_cast<uint64_t>(sw == 128 ? 1 : (sw == 64 ? 2 : 3)) << 62);
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
// all consumer threads (named barrier 1; the producer warp is not in it).
// bar.sync wants each warp converged, which the compiler does not see to
// for inline PTX: the warp reconverges first.
__device__ __forceinline__ void consumer_sync(int threads) {
  __syncwarp();
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
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
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
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

template <>
__device__ __forceinline__ void wgmma_ss<24>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<72>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
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
// 8 bytes at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float2 ld_peer2(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
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
  const int kpt = kblocks_per_stage(S::STAGE, n0, S::SW, S::NKB);
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
  constexpr int KPT = kblocks_per_stage(S::STAGE, N0, S::SW, S::NKB);
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

// y = x + ls1 * (a + b) for this CTA's columns col0.. (ccols of them)
// from the out-projection summed over the model group a (fp32), rounded
// as the plain path rounds, into `out` (the model axis's mode).
template <int C>
__device__ __forceinline__ void mlp_residual_tp(const MlpArgs& p, int row0,
                                                int col0, int ccols, int tid,
                                                int nthreads) {
  for (int i = tid; i < MLP_BM * ccols / 2; i += nthreads) {
    const int r = i / (ccols / 2), col = col0 + (i % (ccols / 2)) * 2;
    const int row = row0 + r;
    if (row >= p.R) continue;
    const size_t idx = static_cast<size_t>(row) * C + col;
    const float2 av = *reinterpret_cast<const float2*>(p.a + idx);
    float v0 = round_bf16(av.x + opt(p.proj_b, col));
    float v1 = round_bf16(av.y + opt(p.proj_b, col + 1));
    if (p.ls1) {
      v0 = round_bf16(v0 * f32(p.ls1[col]));
      v1 = round_bf16(v1 * f32(p.ls1[col + 1]));
    }
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(p.x + idx);
    *reinterpret_cast<__nv_bfloat162*>(p.out + idx) =
        __floats2bfloat162_rn(f32(xv.x) + v0, f32(xv.y) + v1);
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
//
// The model axis's mode (p.tp, a block sharded over the model group,
// parallel/tensor.py): the out-projection's sum crosses the ranks before
// the residual, so o and GEMM0 give way to y = x + ls1 * (a + b) from
// the summed projection a; LN2 is unchanged, the hidden chunks are this
// rank's inner units (its rows of proj_in, of both halves where gated,
// and its columns of proj_out: `inner` is the rank's), and the epilogue
// writes the fp32 partial sum, without bias, LayerScale or residual,
// to `part`; `out` keeps y (x1). The last residual waits for the
// partials' sum over the ranks (block_residual_kernel).
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
  // an ungated inner dim of 32 mod 64 (a model rank's shard: RVT-S
  // stage 1's 96 units) ends in a half chunk: TMA fills the weight rows
  // and columns past `inner` with zeros, the bias reads stop there, so
  // its missing units are act(0) = 0 and add nothing
  const int nchunks = (p.inner + hc - 1) / hc;
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
    if (!p.tp) produce(true);
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

  // 1. attention output rows into A, swizzled (zero past R); none in
  // the model axis's mode, whose A is LN2's alone
  if (!p.tp) {
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
  }

  // 2. projection and residual for this CTA's columns, y rows to `out`
  // (a cluster size is taken only where each CTA's share of a warpgroup's
  // columns is a multiple of 8, wgmma's N step: mlp_cluster_ok)
  if (p.tp) {
    mlp_residual_tp<C>(p, row0, col0, ccols, tid, NCT);
  } else if (cs == 1) {
    mlp_project<C, S::NW>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else if (cs == 2) {
    if constexpr (S::NW % 16 == 0)
      mlp_project<C, S::NW / 2>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else if (cs == 4) {
    if constexpr (S::NW % 32 == 0)
      mlp_project<C, S::NW / 4>(p, smem, full, empty, w, col0, row0, wr, q2, stage, phase);
  } else {
    if constexpr (S::NW % 64 == 0)
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
        const int u = j * 64 + cl;
        const float b0 = u < p.inner ? opt(p.in_b, u) : 0.f;
        const float b1v = u + 1 < p.inner ? opt(p.in_b, u + 1) : 0.f;
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

  if (cs == 1 && p.tp) {
    // alone on its tile, the model axis's mode: the fp32 partial
#pragma unroll
    for (int i = 0; i < S::NW / 8; ++i) {
      const int col = w * S::NW + 8 * i + q2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wr + 8 * h;
        if (row >= p.R) continue;
        *reinterpret_cast<float2*>(p.part + static_cast<size_t>(row) * C + col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    return;
  }
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
    const size_t idx = static_cast<size_t>(row) * C + col;
    if (p.tp) {
      *reinterpret_cast<float4*>(p.part + idx) = sum;
      continue;
    }
    const float m[4] = {sum.x, sum.y, sum.z, sum.w};
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
// Attention half of a block: LN1, partition, q|k|v, softmax(q k^T) v
// ---------------------------------------------------------------------------
//
// A CTA owns a group of `nwin` windows (or grid cells) and a group of
// heads. Each window's T tokens take TP = T rounded up to 16 rows of a
// token tile (64-row slices, wgmma's M), gathered from NHWC through the
// window or grid index map and normalized once, in bf16, swizzled as the
// wgmma descriptors read it. Per head, q|k|v (3 DH columns: 96 at
// dim_head DH = 32, 72 at DH = 24) is one wgmma product a 64-row slice,
// whose weight rows stream in K-blocks by TMA through a ring (one
// producer warp, full/empty mbarriers); each weight tile serves two
// slices of the CTA's windows (one a warpgroup where two warpgroups
// share the tile). Bias in fp32 and one rounding give bf16 q, k, v
// tiles of 64-byte rows (XOR-swizzled for ldmatrix; at DH = 24 columns
// 24-31 of q and k hold zeros, so that q k^T runs as two k16 steps).
// Each warp then takes 16-query blocks: S = q k^T on mma.sync m16n8k16
// fed by ldmatrix, the softmax over the T real keys in fp32 registers,
// P rounded to bf16 and reused from the registers as the A operand of
// P v (flash attention 2's layout; DH / 8 n8 tiles), so S and P never
// touch shared memory. O, rounded once, goes over the block's q rows and
// leaves in 16-byte stores to the tokens' NHWC rows.
//
// The head groups of one window group form a cluster (grid x): CTA r
// normalizes the r-th block of the tile's rows into its own tile, and
// the bulk-copy engine copies the block into every peer's tile over
// distributed shared memory, so LN1 runs once per token per launch.
//
// Head shards (the model axis, parallel/tensor.py): the launch's heads
// are a count Hl at most C / DH, its q|k|v weight the [3 Hl DH, C] rows
// of those heads (a contiguous block: the projection is packed
// head-major), and o has Hl DH channels. C (LN1 and the product's K)
// stays the token width, so one kernel per (C, DH) serves every shard.

template <int C, int DH>
struct AttnShape {
  static_assert(DH == 32 || DH == 24, "dim_head 32 or 24");
  static constexpr int KB = kblock(C);           // K-block of the q|k|v product
  static constexpr int SW = KB * 2;              // its swizzle (= row) bytes
  static constexpr int NKB = C / KB;
  static constexpr int QKV_N = 3 * DH;           // a head's q|k|v: one wgmma's N
  // 64-row slices of the token tile; with q, k and v (3 x 64 bytes a
  // row) and the ring they keep two CTAs an SM below C = 256
  static constexpr int NMT = C <= 48 ? 5 : (C <= 96 ? 4 : (C <= 128 ? 3 : 2));
  static constexpr int MP = NMT * 64;
  // consumer warpgroups: two where one CTA fills an SM (C >= 256), so
  // that eight warps share the gather and the attention, a slice each
  static constexpr int NWG = C >= 256 ? 2 : 1;
  static constexpr int NCT = NWG * 128;          // consumer threads
  static constexpr int THREADS = NCT + 32;       // + a producer warp
  static constexpr int MINB = C >= 256 ? 1 : 2;
  // slices a warpgroup accumulates at once (48 fp32 registers each); a
  // head's weights stream once per such pass
  static constexpr int MG = NWG == 1 ? 2 : 1;
  // K-blocks a ring stage (a divisor of NKB), and stages, as deep as
  // shared memory allows
  static constexpr int KPS = C == 256 || C == 384 ? 2 : 1;
  static constexpr int NS = C <= 48 || C >= 256 ? 4 : 2;
  static_assert(NKB % KPS == 0, "a ring stage holds whole K-blocks");
  static constexpr int STAGE = QKV_N * KPS * SW;
  static constexpr int RING = MP * C * 2;        // after the token tile
  static constexpr int QKV = MP * 64;            // bytes of one of q, k, v
  static constexpr int QOFF = RING + NS * STAGE;
  static constexpr int ROFF = QOFF + 3 * QKV;    // the rows' NHWC indices
  static constexpr int BOFF = ROFF + MP * 4;
  static constexpr int SMEM = BOFF + (2 * NS + 1) * 8 + 1024;  // + alignment
};
constexpr int ATTN_MAX_T = 80;     // a warp holds S of 16 queries x 80 keys
constexpr int ATTN_LG = 4;         // row sets a warp normalizes at once

struct AttnArgs {
  const bf16 *x, *ln_w, *ln_b, *qkv_b;
  bf16* o;
  int H, W, ph, pw, grid_kind, nwin, nwindows, heads;   // heads a CTA
  int oc;         // o's channels: the launch's heads x DH
  float eps, scale;
};

// Byte offset of bf16 column `col` of row `r` in a q, k or v tile: rows
// of 64 bytes, their 16-byte chunks XORed with bits 1-2 of the row, so
// that the eight rows an ldmatrix reads of one chunk hit distinct banks.
__device__ __forceinline__ uint32_t qkv_off(int r, int col) {
  return static_cast<uint32_t>(r * 64 + ((((col >> 3) ^ (r >> 1)) & 3) << 4) +
                               (col & 7) * 2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* d, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* d, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr) : "memory");
}
// D[16, 8] += A[16, 16] B[16, 8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// `bytes` of this CTA's shared memory at `src` to the same offset in the
// shared memory of the cluster's CTA `rank`, by the bulk-copy engine; the
// bytes count against that CTA's mbarrier at `bar`'s offset
__device__ __forceinline__ void copy_to_peer(const void* src, uint32_t rank,
                                             uint32_t bytes, uint64_t* bar) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(dst) : "r"(smem_u32(src)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "r"(smem_u32(src)), "r"(bytes),
      "r"(rbar) : "memory");
}

// 2^x on the SFU
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// LN1 (or a copy, where the block skips it) of token rows r_begin..r_end
// into this CTA's token tile; rows that are no token are zero. A row is
// LPR lanes of 16-byte chunks (a warp takes 32 / LPR rows at once,
// ATTN_LG such sets in flight), its statistics in fp32, two passes,
// reduced over its lanes.
template <int C, int DH>
__device__ __forceinline__ void attn_gather(const AttnArgs& p,
                                            unsigned char* smem,
                                            const int* rows, int r_begin,
                                            int r_end, int warp, int lane) {
  using S = AttnShape<C, DH>;
  // lanes a row: the largest power of two up to 32 that divides the
  // row's C / 8 chunks (4-32 at C = 32-512, 2-16 at C = 48-384), so
  // that every lane of a row takes NCH chunks and a row's sums reduce
  // by xor-shuffles
  constexpr int LOW = (C / 8) & -(C / 8);        // C / 8's lowest set bit
  constexpr int LPR = LOW < 32 ? LOW : 32;
  constexpr int RPW = 32 / LPR;                  // rows a warp takes at once
  constexpr int NCH = C / 8 / LPR;               // chunks a lane
  constexpr int NWARP = S::NCT / 32;
  const int sub = lane / LPR, ln = lane % LPR;
  float w[NCH][8], b[NCH][8];                    // this lane's LN1 columns
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    uint4 wv = make_uint4(0u, 0u, 0u, 0u), bv = wv;
    if (p.ln_w) {
      wv = reinterpret_cast<const uint4*>(p.ln_w)[ln + LPR * u];
      bv = reinterpret_cast<const uint4*>(p.ln_b)[ln + LPR * u];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[u][k] = f32(reinterpret_cast<const bf16*>(&wv)[k]);
      b[u][k] = f32(reinterpret_cast<const bf16*>(&bv)[k]);
    }
  }
  for (int r0 = r_begin + warp * RPW * ATTN_LG; r0 < r_end;
       r0 += NWARP * RPW * ATTN_LG) {
    uint4 raw[ATTN_LG][NCH];
    int row[ATTN_LG];
#pragma unroll
    for (int g = 0; g < ATTN_LG; ++g) {
      const int r = r0 + g * RPW + sub;
      row[g] = r < r_end ? rows[r] : -1;
#pragma unroll
      for (int u = 0; u < NCH; ++u)
        raw[g][u] = row[g] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                               : reinterpret_cast<const uint4*>(
                                     p.x + static_cast<size_t>(row[g]) * C)[ln + LPR * u];
    }
#pragma unroll
    for (int g = 0; g < ATTN_LG; ++g) {
      const int r = r0 + g * RPW + sub;
      float v[NCH][8];
#pragma unroll
      for (int u = 0; u < NCH; ++u)
#pragma unroll
        for (int k = 0; k < 8; ++k) v[u][k] = f32(reinterpret_cast<const bf16*>(&raw[g][u])[k]);
      if (p.ln_w) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < NCH; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k) s += v[u][k];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float mean = s / C;
        float ss = 0.f;
#pragma unroll
        for (int u = 0; u < NCH; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k) ss += (v[u][k] - mean) * (v[u][k] - mean);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        const float inv = 1.f / sqrtf(ss / C + p.eps);
#pragma unroll
        for (int u = 0; u < NCH; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k) v[u][k] = (v[u][k] - mean) * inv * w[u][k] + b[u][k];
      }
      if (r >= r_end) continue;
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        uint4 z = make_uint4(0u, 0u, 0u, 0u);
        uint32_t* zw = reinterpret_cast<uint32_t*>(&z);
        if (row[g] >= 0)
#pragma unroll
          for (int k = 0; k < 4; ++k) zw[k] = pack_bf16(v[u][2 * k], v[u][2 * k + 1]);
        const int c8 = ln + LPR * u;
        const int kb = c8 / (S::KB / 8), off = (c8 % (S::KB / 8)) * 16;
        *reinterpret_cast<uint4*>(smem + kb * S::MP * S::SW + swz(r, off, S::SW)) = z;
      }
    }
  }
}

// One warp, one block of 16 queries (rows r0..r0+15) of the window whose
// keys are rows wb..wb+TP-1 (T real): S = q k^T in registers, softmax
// over the real keys in fp32, O = P v; O in bf16 over the block's q rows
// (its DH columns: DH / 8 n8 tiles). q and k hold zeros past DH, so
// S = q k^T takes two k16 steps at DH = 24 as at 32.
// sl2 is the logits' scale times log2(e): exp(scale (s - m)) = 2^(sl2 (s - m)).
template <int DH>
__device__ __forceinline__ void attn_block(unsigned char* q, uint32_t kv_bytes,
                                           int r0, int wb, int T, int TP,
                                           float sl2, int lane) {
  constexpr int NT = ATTN_MAX_T / 8;
  constexpr int ND = DH / 8;          // n8 tiles of O
  const uint32_t qs = smem_u32(q), ks = qs + kv_bytes, vs = ks + kv_bytes;
  const int nt = TP / 8, g = lane >> 2, c2 = (lane & 3) * 2;
  uint32_t qa[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    ldsm_x4(qa[k], qs + qkv_off(r0 + (lane & 15), (2 * k + (lane >> 4)) * 8));
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (j < nt) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + qkv_off(wb + 8 * j + (lane & 7), (lane >> 3) * 8));
      mma_bf16(s[j], qa[0], kb[0], kb[1]);
      mma_bf16(s[j], qa[1], kb[2], kb[3]);
    }
  }
  // rows g and g + 8 of the block; a row's 4 lanes hold its 8-key slices.
  // Keys past T are masked to -inf (their probability is exactly 0).
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (j >= nt || 8 * j + c2 + e >= T) s[j][e] = s[j][2 + e] = -INFINITY;
  float m0 = s[0][0], m1 = s[0][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const float n0 = -m0 * sl2, n1 = -m1 * sl2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
    s[j][0] = ex2(fmaf(s[j][0], sl2, n0));
    s[j][1] = ex2(fmaf(s[j][1], sl2, n0));
    s[j][2] = ex2(fmaf(s[j][2], sl2, n1));
    s[j][3] = ex2(fmaf(s[j][3], sl2, n1));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  float acc[2 * ((ND + 1) / 2)][4];   // v's ldmatrix.x4 serves n8 tiles in pairs
#pragma unroll
  for (int d = 0; d < 2 * ((ND + 1) / 2); ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk >= nt) continue;
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0),
        pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1),
        pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0),
        pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1)};
#pragma unroll
    for (int dp = 0; dp < (ND + 1) / 2; ++dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + qkv_off(wb + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 (2 * dp + (lane >> 4)) * 8));
      mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
      if (2 * dp + 1 < ND) mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    *reinterpret_cast<uint32_t*>(q + qkv_off(r0 + g, 8 * d + c2)) =
        pack_bf16(acc[d][0], acc[d][1]);
    *reinterpret_cast<uint32_t*>(q + qkv_off(r0 + g + 8, 8 * d + c2)) =
        pack_bf16(acc[d][2], acc[d][3]);
  }
}

// grid (cs, window groups): CTA x of a window group runs heads
// [x * heads, (x + 1) * heads); a launch with cs > 1 is a cluster of the
// group's cs CTAs (a CTA launched alone gathers its whole tile).
template <int C, int DH>
__global__ void __launch_bounds__(AttnShape<C, DH>::THREADS, AttnShape<C, DH>::MINB)
    block_attention_kernel(const __grid_constant__ CUtensorMap m_qkv,
                           const AttnArgs p) {
  using S = AttnShape<C, DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + S::RING;
  unsigned char* qkv = smem + S::QOFF;
  int* rows = reinterpret_cast<int*>(smem + S::ROFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BOFF);
  uint64_t* empty = full + S::NS;
  uint64_t* tok_full = empty + S::NS;    // the peers' rows have arrived

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cs = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int T = p.ph * p.pw, TP = (T + 15) / 16 * 16;
  const int w0 = blockIdx.y * p.nwin;
  const int nwin = min(p.nwin, p.nwindows - w0);
  const int nrows = (nwin * TP + 63) / 64 * 64;   // rows the products cover
  const int nmt = nrows / 64;
  const int head0 = blockIdx.x * p.heads;
  constexpr int TILES = S::NKB / S::KPS;          // ring stages a pass
  // passes over a head's weights: each warpgroup's slices MG at a time
  const int passes = (nmt + S::NWG * S::MG - 1) / (S::NWG * S::MG);

  const int rb = nrows / cs;                      // token rows a CTA normalizes
  if (tid == 0) {
    for (int i = 0; i < S::NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], S::NCT);
    }
    mbar_init(tok_full, 1);
    if (cs > 1) mbar_expect_tx(tok_full, (nrows - rb) * C * 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // a peer's shared memory may be written only once the peer runs and its
  // barriers are set up: a cluster barrier (arrived here, waited for
  // before the gather) orders it
  if (cs > 1) cluster_arrive();
  // token t of window w at row w * TP + t; the grid partition indexes the
  // outer, strided dims (layers.py grid_partition)
  const int nh = p.H / p.ph, nw = p.W / p.pw;
  for (int r = tid; r < nrows; r += blockDim.x) {
    const int w = r / TP, t = r % TP;
    int row = -1;
    if (w < nwin && t < T) {
      const int gw = w0 + w, b = gw / (nh * nw), wi = gw % (nh * nw);
      const int wy = wi / nw, wx = wi % nw, tr = t / p.pw, tc = t % p.pw;
      const int y = p.grid_kind ? tr * nh + wy : wy * p.ph + tr;
      const int x = p.grid_kind ? tc * nw + wx : wx * p.pw + tc;
      row = (b * p.H + y) * p.W + x;
    }
    rows[r] = row;
  }
  __syncthreads();

  if (tid >= S::NCT) {
    // producer: each head's 96 q|k|v weight rows, K-block by K-block, once
    // a pass, in the consumers' order; it arrives at the second cluster
    // barrier first, since the consumers free the ring only after it
    if (cs > 1) {
      cluster_wait();
      cluster_arrive();
    }
    if (tid == S::NCT) {
      int stage = 0;
      uint32_t phase = 0;
      for (int h = 0; h < p.heads; ++h)
        for (int pass = 0; pass < passes; ++pass)
          for (int t = 0; t < TILES; ++t) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], S::STAGE);
            for (int k = 0; k < S::KPS; ++k)
              tma_load_2d(ring + stage * S::STAGE + k * S::QKV_N * S::SW,
                          &m_qkv, &full[stage], (t * S::KPS + k) * S::KB,
                          (head0 + h) * S::QKV_N);
            if (++stage == S::NS) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
    if (cs > 1) {
      __syncwarp();
      cluster_wait();
    }
    return;
  }

  // the token tile: this CTA's block of rb rows normalized here, each
  // peer's block copied in by the bulk-copy engine (a K-block's rows of a
  // block are contiguous bytes, swizzle included)
  if (cs > 1) cluster_wait();
  attn_gather<C, DH>(p, smem, rows, rank * rb, (rank + 1) * rb, warp, lane);
  if constexpr (DH < 32) {
    // q and k: zeros in columns DH..31 of every row, which the products
    // below never write, so that q k^T may run its two k16 steps
    for (int r = tid; r < 2 * S::MP; r += S::NCT)
      for (int c8 = DH / 8; c8 < 4; ++c8)
        *reinterpret_cast<uint4*>(qkv + r / S::MP * S::QKV +
                                  qkv_off(r % S::MP, c8 * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  consumer_sync(S::NCT);
  if (cs > 1) {
    if (tid == 0)
      for (int q = 1; q < cs; ++q)
        for (int kb = 0; kb < S::NKB; ++kb)
          copy_to_peer(smem + kb * S::MP * S::SW + rank * rb * S::SW,
                       (rank + q) % cs, rb * S::SW, tok_full);
    mbar_wait(tok_full, 0);
    // arrived once every copy into this CTA is done; waited for before
    // exiting, so that no CTA leaves while its rows are being copied
    cluster_arrive();
  }

  const uint32_t tok = smem_u32(smem), wring = smem_u32(ring);
  const int wg = warp / 4;                        // warpgroup: slices wg, wg + NWG, ...
  const int wr = (warp % 4) * 16 + lane / 4, q2 = (lane % 4) * 2;
  constexpr int NPT = DH / 8;                     // n8 tiles of each of q, k, v
  const float sl2 = p.scale * 1.4426950408889634f;
  int stage = 0;
  uint32_t phase = 0;
  for (int h = 0; h < p.heads; ++h) {
    const int head = head0 + h;
    // 1. q|k|v = tok W^T + b, one N = 3 DH product a slice, bf16 into the
    // q, k and v tiles, zero on rows that are no token
    float bias[S::QKV_N / 8][2];                  // loaded while wgmma runs
#pragma unroll
    for (int n = 0; n < S::QKV_N / 8; ++n) {
      bias[n][0] = opt(p.qkv_b, head * S::QKV_N + 8 * n + q2);
      bias[n][1] = opt(p.qkv_b, head * S::QKV_N + 8 * n + q2 + 1);
    }
    for (int pass = 0; pass < passes; ++pass) {
      float acc[S::MG][S::QKV_N / 2];
#pragma unroll
      for (int i = 0; i < S::MG; ++i) {
#pragma unroll
        for (int e = 0; e < S::QKV_N / 2; ++e) acc[i][e] = 0.f;
        fence_regs<S::QKV_N / 2>(acc[i]);   // zeroed before the first wgmma's fence
      }
      for (int t = 0; t < TILES; ++t) {
        mbar_wait(&full[stage], phase);
        const uint32_t b = wring + stage * S::STAGE;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < S::KPS; ++k)
#pragma unroll
          for (int i = 0; i < S::MG; ++i) {
            const int mt = (pass * S::MG + i) * S::NWG + wg;
            if (mt >= nmt) continue;
            const uint32_t a = tok + (t * S::KPS + k) * S::MP * S::SW + mt * 64 * S::SW;
#pragma unroll
            for (int kk = 0; kk < S::KB / 16; ++kk)
              wgmma_ss<S::QKV_N>(acc[i], gmma_desc(a + 32 * kk, S::SW),
                                 gmma_desc(b + k * S::QKV_N * S::SW + 32 * kk, S::SW), 1);
          }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < S::MG; ++i) fence_regs<S::QKV_N / 2>(acc[i]);
        mbar_arrive(&empty[stage]);
        if (++stage == S::NS) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int i = 0; i < S::MG; ++i) {
        const int mt = (pass * S::MG + i) * S::NWG + wg;
        if (mt >= nmt) continue;
#pragma unroll
        for (int n = 0; n < S::QKV_N / 8; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mt * 64 + wr + 8 * hh;
            // columns 8n..8n+7 of q|k|v: tile n / NPT, its columns 8 (n % NPT)..
            *reinterpret_cast<uint32_t*>(qkv + n / NPT * S::QKV +
                                         qkv_off(r, 8 * (n % NPT) + q2)) =
                rows[r] >= 0 ? pack_bf16(acc[i][4 * n + 2 * hh] + bias[n][0],
                                         acc[i][4 * n + 2 * hh + 1] + bias[n][1])
                             : 0u;
          }
      }
    }
    consumer_sync(S::NCT);

    // 2. softmax(q k^T * scale) v, a warp per 16-query block
    for (int qb = warp; qb < nwin * TP / 16; qb += S::NCT / 32) {
      attn_block<DH>(qkv, S::QKV, qb * 16, qb * 16 / TP * TP, T, TP, sl2, lane);
    }
    consumer_sync(S::NCT);

    // 3. the head's DH channels of each token to NHWC, 16 bytes a store
    for (int i = tid; i < nrows * NPT; i += S::NCT) {
      const int r = i / NPT, c = i % NPT, row = rows[r];
      if (row < 0) continue;
      *reinterpret_cast<uint4*>(p.o + static_cast<size_t>(row) * p.oc + head * DH + c * 8) =
          *reinterpret_cast<const uint4*>(qkv + qkv_off(r, c * 8));
    }
    consumer_sync(S::NCT);
  }
  if (cs > 1) cluster_wait();
}

// ---------------------------------------------------------------------------
// The model axis's last residual: x2 = x1 + ls2 (p + out_b)
// ---------------------------------------------------------------------------
//
// Replaces no TP kernel: the JAX package's model axis runs on its flax
// path, whose last residual XLA fuses after GSPMD's all-reduce. Under the
// port's model axis (parallel/tensor.py) the MLP's output is a partial
// sum on each rank until that all-reduce, so block_mlp_kernel (its
// model-axis mode) stops at the fp32 partial and this pass adds the
// bias, LayerScale 2 and the residual, rounded as the plain path rounds.
// One pass over 8 bytes of x1 and p and 2 of out per channel, no
// product: bound by bytes. A thread takes 8 channels of a row (16 bytes
// of x1 and out, 32 of p), a grid-stride loop the rows.
__global__ void block_residual_kernel(const bf16* __restrict__ x1,
                                      const float* __restrict__ p,
                                      const bf16* __restrict__ out_b,
                                      const bf16* __restrict__ ls2,
                                      bf16* __restrict__ out, long n8, int C) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(i * 8 % C);
    const uint4 xr = reinterpret_cast<const uint4*>(x1)[i];
    const float4 p0 = reinterpret_cast<const float4*>(p)[2 * i];
    const float4 p1 = reinterpret_cast<const float4*>(p)[2 * i + 1];
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const bf16* xv = reinterpret_cast<const bf16*>(&xr);
    uint4 o;
    bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v = round_bf16(pv[k] + opt(out_b, c0 + k));
      if (ls2) v = round_bf16(v * f32(ls2[c0 + k]));
      ov[k] = __float2bfloat16(f32(xv[k]) + v);
    }
    reinterpret_cast<uint4*>(out)[i] = o;
  }
}

// ---------------------------------------------------------------------------
// ConvLSTM update: mix = x Kx + h Kh + b, gates [f, i, o, g]
// ---------------------------------------------------------------------------
//
// A tile is BM = 128 rows of B*H*W (two consumer warpgroups of 64 rows,
// wgmma's M) by J channels of all four gates (64 where 64 divides C, else
// 48 where 48 does, else C: 32 at C = 32, 48 at C = 48 and 96): the
// product [128, 2C] x [2C, 4J], with N = 4J <= 256 one wgmma N. Its B operand is
// rows g C + j0 .. + J of the [4C, 2C] weight for g = f, i, o, g, four
// TMA boxes that land as one K-major [4J, KB] tile. K = 2C walks through
// a ring of NS stages in KB-wide chunks (kblock), first the C / KB
// chunks of x, then those of h (no concat); one producer thread keeps them
// in flight with TMA (the A box [BM, KB] of x or h, rows past R filled
// with zeros; the 128-, 64- or 32-byte swizzle of KB), full/empty mbarriers. Each
// warpgroup multiplies its 64 rows of a chunk by the shared B chunk, one
// wgmma group in flight while the next is issued. Two warpgroups share
// every weight chunk, which halves the weight bytes a row costs; the
// N = 256 accumulator (128 registers a thread) keeps one CTA an SM either
// way.
//
// The gate epilogue runs in registers: in the m64nNk16 accumulator a
// thread holds columns 8t + 2 (lane % 4) + {0, 1} for every t, so channel
// j's f, i, o and g (columns j, J + j, 2J + j, 3J + j) sit in the same
// thread. Bias in fp32, sigmoid and tanh (on the SFU where the result
// reaches only bf16 outputs, accurate for c' in fp32: gate_tanh),
// c' = f c + i g in fp32 and h' = o tanh(c'), each rounded once and
// written in paired stores. The
// producer brings each tile's c (a swizzled TMA box) and biases into one
// of two epilogue buffers while the tile's products run, so the epilogue
// waits on no load from device memory (read from global memory, each
// thread's loads of c and the biases queued behind its stores of h' and
// c', which may alias them).
//
// Where tiles outnumber the CTAs one wave holds, CTAs are persistent: a
// CTA walks tiles blockIdx.y, + gridDim.y, ..., and the producer streams
// the next tile's chunks while the consumers run the epilogue. Where
// tiles are few and K is long (the plan in launch_lstm; at the RVT-B
// shapes, C = 512), a cluster of CS CTAs (2, 4 or 8; the launch's cluster
// dimension x) shares one tile and splits K: rank r takes chunks
// [r NK / CS, (r + 1) NK / CS), writes its fp32 [BM, N] partial over its
// own ring, and after a cluster barrier each rank sums the partials of
// BM / CS rows over distributed shared memory in rank order (so launches
// agree bit for bit) and runs their epilogue.
//
// Bound: 16 R C^2 flops against 10 R C bytes of bf16 activations and
// 16 C^2 of weights: bytes at C = 64-128 (about 1.6 C flops a byte,
// below the card's 295), tensor-core operations at C = 256-512 for
// B = 8 (R = 2560 and 640).

template <int C, typename CT>
struct LstmShape {
  static constexpr int BM = 128;                 // rows a tile
  static constexpr int NCT = 256;                // consumer threads
  // + a producer warpgroup (one thread of it issues the loads): three
  // warpgroups let setmaxnreg move registers to the consumers, 232 a
  // thread; with a producer warp alone, ptxas capped every thread at 168
  // (three warps on an SM sub-partition) and the epilogue spilled
  static constexpr int THREADS = NCT + 128;
  static constexpr int J = C % 64 == 0 ? 64 : (C % 48 == 0 ? 48 : C);   // channels a tile, each gate
  static constexpr int N = 4 * J;                // the product's width
  static constexpr int KB = kblock(C);           // K chunk
  static constexpr int SW = KB * 2;              // its swizzle (= row) bytes
  static constexpr int NKX = C / KB;             // chunks of x, and of h
  static constexpr int NK = 2 * NKX;
  static constexpr int A_BYTES = BM * SW;
  static constexpr int STAGE = A_BYTES + N * SW;
  static constexpr int NS = 3;                   // ring stages
  static constexpr int LDP = N + 4;              // fp32 row stride of a partial
  static constexpr int PART = BM * LDP * 4;
  static constexpr int BODY = NS * STAGE > PART ? NS * STAGE : PART;
  // a tile's c [BM, J] in boxes of CIB bytes a row (the swizzle: the
  // largest of 128, 64 and 32 that divides a row's J * sizeof(CT)
  // bytes), then its four gates' J biases: an epilogue buffer, two of them
  static constexpr int CROW = J * static_cast<int>(sizeof(CT));
  static constexpr int CIB = CROW % 128 == 0 ? 128 : (CROW % 64 == 0 ? 64 : 32);
  static constexpr int C_BYTES = BM * J * sizeof(CT);
  static constexpr int EPI = (C_BYTES + 8 * J + 1023) / 1024 * 1024;
  static constexpr int BOFF = BODY + 2 * EPI;    // the mbarriers
  static constexpr int SMEM = BOFF + (2 * NS + 4) * 8 + 1024;   // + alignment
};

template <typename CT>
struct LstmArgs {
  const bf16* bias;
  bf16* h_out;
  CT* c_out;
  int R, tiles;
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` by the
// bulk-copy engine, counted against the mbarrier at `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// The gates' tanh and sigmoid, ACCURATE (tanhf and expf, as the plain
// version computes them) or on the SFU's tanh, with sigmoid(v) =
// (1 + tanh(v/2)) / 2 (tanh.approx.f32: at most 2^-11 relative error).
// The SFU serves whatever reaches only a bf16 output, whose ulp is far
// coarser: h' always (o and tanh(c')), and c' where c is bf16. The
// accurate tanhf and expf, five an output, made the epilogue the larger
// part of a launch. An fp32 c' keeps fp32's accuracy: f, i and g are
// accurate where c is fp32, and `test_lstm_update_kernel_matches_plain`
// holds c' to 2^-18 · max|plain|, which the SFU's gates miss.
template <bool ACCURATE>
__device__ __forceinline__ float gate_tanh(float v) {
  if constexpr (ACCURATE) {
    return tanhf(v);
  } else {
    float y;
    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(v));
    return y;
  }
}
template <bool ACCURATE>
__device__ __forceinline__ float gate_sigmoid(float v) {
  if constexpr (ACCURATE) {
    return sigmoid(v);
  } else {
    return fmaf(0.5f, gate_tanh<false>(0.5f * v), 0.5f);
  }
}

// h' and c' of channels (cl, cl + 1) of the tile, row r of the tile
// (`row` of the map), from their gate sums mix[gate] (bias not yet
// added), with c and the biases read from the epilogue buffer `eb`
template <int C, typename CT>
__device__ __forceinline__ void lstm_out2(const LstmArgs<CT>& p,
                                          const unsigned char* eb, int r,
                                          int row, int j0, int cl,
                                          const float (&mix)[4][2]) {
  using S = LstmShape<C, CT>;
  const int cb = cl * static_cast<int>(sizeof(CT));
  const float2 cp = load_pair(reinterpret_cast<const CT*>(
      eb + cb / S::CIB * S::BM * S::CIB + swz(r, cb % S::CIB, S::CIB)));
  const bf16* bias = reinterpret_cast<const bf16*>(eb + S::C_BYTES);
  float2 bv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bv[g] = load_pair(bias + g * S::J + cl);
  const float cprev[2] = {cp.x, cp.y};
  constexpr bool C32 = std::is_same_v<CT, float>;   // c' in fp32
  float hn[2], cn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float f = gate_sigmoid<C32>(mix[0][e] + (e ? bv[0].y : bv[0].x));
    const float i = gate_sigmoid<C32>(mix[1][e] + (e ? bv[1].y : bv[1].x));
    const float o = gate_sigmoid<false>(mix[2][e] + (e ? bv[2].y : bv[2].x));
    const float g = gate_tanh<C32>(mix[3][e] + (e ? bv[3].y : bv[3].x));
    cn[e] = f * cprev[e] + i * g;
    hn[e] = o * gate_tanh<false>(cn[e]);
  }
  const size_t idx = static_cast<size_t>(row) * C + j0 + cl;
  store_pair(p.h_out + idx, hn[0], hn[1]);
  store_pair(p.c_out + idx, cn[0], cn[1]);
}

template <int C, typename CT>
__global__ void __launch_bounds__(LstmShape<C, CT>::THREADS, 1)
    lstm_update_kernel(const __grid_constant__ CUtensorMap m_x,
                       const __grid_constant__ CUtensorMap m_h,
                       const __grid_constant__ CUtensorMap m_w,
                       const __grid_constant__ CUtensorMap m_c,
                       const LstmArgs<CT> p) {
  using S = LstmShape<C, CT>;
  constexpr int NBLK = C / S::J;   // channel blocks: tile = row tile * NBLK + block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* epi = smem + S::BODY;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BOFF);
  uint64_t* empty = full + S::NS;
  uint64_t* efull = empty + S::NS;     // the two epilogue buffers
  uint64_t* eempty = efull + 2;
  const int tid = threadIdx.x;
  const int cs = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int k0 = rank * S::NK / cs, k1 = (rank + 1) * S::NK / cs;

  if (tid == 0) {
    for (int i = 0; i < S::NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], S::NCT);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&efull[i], 1);
      mbar_init(&eempty[i], S::NCT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= S::NCT) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // producer: chunk k of a tile is the A box of x (k < NKX) or h, and
    // the four gates' weight boxes at the same K; after a tile's chunks,
    // its c and biases into epilogue buffer n % 2 (n: the CTA's tiles so far)
    if (tid == S::NCT) {
      int stage = 0;
      uint32_t phase = 0;
      int n = 0;
      for (int tile = blockIdx.y; tile < p.tiles; tile += gridDim.y, ++n) {
        const int row0 = tile / NBLK * S::BM, j0 = tile % NBLK * S::J;
        for (int k = k0; k < k1; ++k) {
          unsigned char* dst = smem + stage * S::STAGE;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], S::STAGE);
          tma_load_2d(dst, k < S::NKX ? &m_x : &m_h, &full[stage],
                      (k % S::NKX) * S::KB, row0);
          for (int g = 0; g < 4; ++g)
            tma_load_2d(dst + S::A_BYTES + g * S::J * S::SW, &m_w, &full[stage],
                        k * S::KB, g * C + j0);
          if (++stage == S::NS) {
            stage = 0;
            phase ^= 1;
          }
        }
        const int b = n & 1;
        unsigned char* eb = epi + b * S::EPI;
        mbar_wait(&eempty[b], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&efull[b], S::C_BYTES + 8 * S::J);
        for (int bx = 0; bx < S::C_BYTES / (S::BM * S::CIB); ++bx)
          tma_load_2d(eb + bx * S::BM * S::CIB, &m_c, &efull[b],
                      j0 + bx * S::CIB / static_cast<int>(sizeof(CT)), row0);
        for (int g = 0; g < 4; ++g)
          bulk_load(eb + S::C_BYTES + g * S::J * 2, p.bias + g * C + j0,
                    S::J * 2, &efull[b]);
      }
    }
    // a cluster's CTA owns one tile: the consumers' two cluster barriers
    if (cs > 1) {
      __syncwarp();
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int w = tid / 128, t = tid % 128;
  const int wr = (t / 32) * 16 + (t % 32) / 4;  // the thread's rows wr, wr + 8
  const int q2 = (t % 4) * 2;                   // its column pair in each 8
  int stage = 0;
  uint32_t phase = 0;
  float acc[S::N / 2];
  int n = 0;
  for (int tile = blockIdx.y; tile < p.tiles; tile += gridDim.y, ++n) {
    const int row0 = tile / NBLK * S::BM, j0 = tile % NBLK * S::J;
#pragma unroll
    for (int i = 0; i < S::N / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int k = k0; k < k1; ++k) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(smem + stage * S::STAGE) + w * 64 * S::SW;
      const uint32_t b = smem_u32(smem + stage * S::STAGE + S::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::KB / 16; ++kk)
        wgmma_ss<S::N>(acc, gmma_desc(a + 32 * kk, S::SW),
                       gmma_desc(b + 32 * kk, S::SW), 1);
      wgmma_commit();
      wgmma_wait1();     // the previous chunk's products are done
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == S::NS) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait0();
    fence_regs<S::N / 2>(acc);
    mbar_arrive(&empty[prev]);
    const unsigned char* eb = epi + (n & 1) * S::EPI;

    if (cs == 1) {
      // gate g of channel 8u + q2 + e of the tile, row wr + 8hh of this
      // warpgroup's 64: acc[g J / 2 + 4u + 2hh + e]
      mbar_wait(&efull[n & 1], (n >> 1) & 1);
#pragma unroll
      for (int u = 0; u < S::J / 8; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = w * 64 + wr + 8 * hh;
          if (row0 + r >= p.R) continue;
          float mix[4][2];
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e) mix[g][e] = acc[g * S::J / 2 + 4 * u + 2 * hh + e];
          lstm_out2<C>(p, eb, r, row0 + r, j0, 8 * u + q2, mix);
        }
      mbar_arrive(&eempty[n & 1]);
      continue;
    }

    // cluster: every wgmma of both warpgroups is done with the ring, which
    // this CTA's fp32 partial [BM, N] now overwrites
    consumer_sync(S::NCT);
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < S::N / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(part + (w * 64 + wr + 8 * hh) * S::LDP + 8 * i + q2) =
            make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    cluster_arrive();
    mbar_wait(&efull[n & 1], (n >> 1) & 1);
    cluster_wait();
    // rows [rank BM / cs, (rank + 1) BM / cs) of the tile, a pair of
    // channels a thread at a time: the partials added in rank order, all
    // 4 cs loads of a pair in flight at once (issued one after another,
    // each waiting on the sum before it, they took most of the launch)
    const int rb = S::BM / cs;
    for (int i = tid; i < rb * S::J / 2; i += S::NCT) {
      const int r = rank * rb + i / (S::J / 2), cl = (i % (S::J / 2)) * 2;
      if (row0 + r >= p.R) continue;
      float2 v[4][8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (q < cs) v[g][q] = ld_peer2(part + r * S::LDP + g * S::J + cl, q);
      float mix[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        mix[g][0] = v[g][0].x;
        mix[g][1] = v[g][0].y;
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (q < cs) {
            mix[g][0] += v[g][q].x;
            mix[g][1] += v[g][q].y;
          }
      }
      lstm_out2<C>(p, eb, r, row0 + r, j0, cl, mix);
    }
    // peers may still read this CTA's partial
    cluster_arrive();
    cluster_wait();
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

EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A [rows, cols] row-major bf16 (or, with elem = 4, fp32) matrix read
// in boxes of box_rows x box_cols (box_cols * elem = 128, 64 or 32 bytes,
// the swizzle); boxes reaching past the matrix read zeros there.
bool encode_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                uint32_t elem = 2) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_cols * elem == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_map for weights: they do not move between steps, so maps are
// kept by their arguments (64 entries, oldest replaced first).
// Activations, which move every step, are encoded per launch instead, so
// that they never evict the weights' maps.
bool weight_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  static std::mutex lock;
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
  if (!encode_map(map, ptr, rows, cols, box_rows, box_cols)) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  return true;
}

// Launches kernel<<<grid, threads, smem, st>>>(args...), as a cluster of
// `cluster` CTAs along x when cluster > 1 (above 8, Hopper's
// non-portable sizes, up to 16).
template <typename... K, typename... A>
cudaError_t launch(void (*kernel)(K...), dim3 grid, int threads, int smem,
                   int cluster, cudaStream_t st, A... args) {
  cudaError_t e = set_smem(kernel, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mlp(const MlpArgs& a, const void* proj_w, const void* in_w,
                       const void* out_w, int cluster, cudaStream_t st) {
  using S = MlpShape<C>;
  const int hc = a.gated ? 32 : 64;
  CUtensorMap m_proj = {}, m_in, m_out;
  // the model axis's mode reads no projection weight
  if ((!a.tp && !weight_map(&m_proj, proj_w, C, C, S::NW / cluster, S::KB)) ||
      !weight_map(&m_in, in_w, a.gated ? 2 * a.inner : a.inner, C,
                  hc / S::NWG, S::KB) ||
      !weight_map(&m_out, out_w, C, a.inner, S::NW, hc))
    return cudaErrorInvalidValue;
  // alone on its tile (cluster 1), a CTA takes the path with no cluster
  // barrier and writes its epilogue straight from the registers
  return launch(block_mlp_kernel<C>, dim3(cluster, (a.R + MLP_BM - 1) / MLP_BM),
                S::THREADS, S::SMEM, cluster, st, m_proj, m_in, m_out, a);
}

// CTAs of `kernel` (threads, smem bytes) the current card runs at once
// in clusters of cs (0 if it cannot run such clusters), by the occupancy
// calculator, kept per (kernel, card, cs): the answer does not change on
// a card
template <typename... K>
long cluster_slots(void (*kernel)(K...), int threads, int smem, int cs,
                   int num_sms) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, long> known;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const std::tuple<const void*, int, int> key(fn, dev, cs);
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  long& slots = known[key];
  slots = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return slots;
  int n = 0;
  if (cs == 1) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem) ==
        cudaSuccess)
      slots = static_cast<long>(n) * num_sms;
    return slots;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) == cudaSuccess)
    slots = static_cast<long>(n) * cs;
  return slots;
}

// Plans and launches block_attention_kernel<C, DH> over a.nwindows windows of
// T = ph * pw tokens and `heads` heads. The plan deals `a.nwin` windows a
// CTA (at most what its token tile holds) and `cs` CTAs to each window
// group, one head group each (a cluster of 1, 2, 4, 8 or 16 that divides
// the heads). The
// pair gives the most CTAs within one wave (the CTAs the card runs at
// once in clusters of cs, by the occupancy calculator), the larger nwin
// on a tie: each CTA pays its token gather and barriers, so splitting
// past one wave only adds them. `cluster` > 0 fixes cs. The plan goes to
// plan[0] (windows a CTA) and plan[1] (cs) where plan is not NULL.
template <int C, int DH>
cudaError_t launch_attention(AttnArgs a, const void* qkv_w, int heads,
                             int cluster, int num_sms, int* plan,
                             cudaStream_t st) {
  using S = AttnShape<C, DH>;
  const int tp = (a.ph * a.pw + 15) / 16 * 16;
  a.scale = 1.f / sqrtf(static_cast<float>(DH));
  a.oc = heads * DH;
  if (heads < 1 || heads > C / DH ||
      (cluster > 0 && ((cluster & (cluster - 1)) || cluster > 16 || heads % cluster)))
    return cudaErrorInvalidValue;
  const int max_win = S::MP / tp;
  long best = -1;
  int cs = cluster > 0 ? cluster : 1;
  a.nwin = max_win;
  for (int c = 1; c <= 16 && c <= heads; c *= 2) {
    if ((cluster > 0 && c != cluster) || heads % c) continue;
    const long slots = cluster_slots(block_attention_kernel<C, DH>, S::THREADS,
                                     S::SMEM, c, num_sms);
    for (int n = max_win; n >= 1; --n) {
      const long ctas = static_cast<long>((a.nwindows + n - 1) / n) * c;
      if (ctas <= slots && (ctas > best || (ctas == best && n > a.nwin))) {
        best = ctas;
        a.nwin = n;
        cs = c;
      }
    }
  }
  const int groups = (a.nwindows + a.nwin - 1) / a.nwin;
  if (groups > 65535) return cudaErrorInvalidValue;
  a.heads = heads / cs;
  if (plan != nullptr) {
    plan[0] = a.nwin;
    plan[1] = cs;
  }
  CUtensorMap m_qkv;
  if (!weight_map(&m_qkv, qkv_w, 3 * heads * DH, C, S::QKV_N, S::KB))
    return cudaErrorInvalidValue;
  return launch(block_attention_kernel<C, DH>, dim3(cs, groups), S::THREADS,
                S::SMEM, cs, st, m_qkv, a);
}

int mlp_smem_bytes(int C) {
  switch (C) {
    case 32: return MlpShape<32>::SMEM;
    case 48: return MlpShape<48>::SMEM;
    case 64: return MlpShape<64>::SMEM;
    case 96: return MlpShape<96>::SMEM;
    case 128: return MlpShape<128>::SMEM;
    case 192: return MlpShape<192>::SMEM;
    case 256: return MlpShape<256>::SMEM;
    case 384: return MlpShape<384>::SMEM;
    case 512: return MlpShape<512>::SMEM;
    default: return 0;
  }
}

// Hidden chunks of block_mlp_kernel: 64 units (32 of each half gated);
// an ungated inner dim may end in a half chunk (inner % 32 == 0 either
// way: `mlp_inner_ok`)
int mlp_chunks(int inner, int gated) {
  const int hc = gated ? 32 : 64;
  return (inner + hc - 1) / hc;
}
bool mlp_inner_ok(int inner) { return inner > 0 && inner % 32 == 0; }

// The cluster sizes a width takes: each CTA projects a multiple of 8
// columns a warpgroup (wgmma's N step) and owns at least one hidden chunk.
bool mlp_cluster_ok(int C, int inner, int gated, int cluster) {
  const int nwg = C > 256 ? 2 : 1;
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         C % (nwg * 8 * cluster) == 0 && cluster <= mlp_chunks(inner, gated);
}

// Plans and launches lstm_update_kernel<C, CT> over a.R rows: tiles of
// BM rows by J channels, and cs CTAs (a cluster splitting K) a tile, the
// largest cs of 2, 4, 8 whose grid the card runs in one wave and that
// spares each CTA at least LSTM_SPLIT_SAVES of the NK K chunks it would
// walk alone; else cs = 1 and at most one wave of persistent CTAs that
// walk the tiles. `cluster` > 0 fixes cs. The plan goes to plan[0..2]
// (BM, J, cs) where plan is not NULL.
//
// A split costs the partials' reduction over distributed shared memory
// (128 KB a CTA), about as long as 8 chunks take on an H100: at the RVT-B
// Gen1 shapes, B = 1, C = 64-256 (2-8 chunks) ran faster alone than
// split, C = 512 (16 chunks) faster split 8 ways (`chip_smoke.py`'s
// kernel phase times each cluster size, "lstm_update_clusters").
constexpr int LSTM_SPLIT_SAVES = 8;
template <int C, typename CT>
cudaError_t launch_lstm(LstmArgs<CT> a, const void* x, const void* h,
                        const void* c, const void* w, int cluster,
                        int num_sms, int* plan, cudaStream_t st) {
  using S = LstmShape<C, CT>;
  if (cluster < 0 || cluster > 8 || (cluster & (cluster - 1)) || cluster > S::NK)
    return cudaErrorInvalidValue;
  auto kernel = lstm_update_kernel<C, CT>;
  a.tiles = (a.R + S::BM - 1) / S::BM * (C / S::J);
  int cs = cluster > 0 ? cluster : 1;
  for (int n = 2; cluster == 0 && n <= 8 && n <= S::NK; n *= 2)
    if (S::NK - S::NK / n >= LSTM_SPLIT_SAVES &&
        static_cast<long>(a.tiles) * n <=
            cluster_slots(kernel, S::THREADS, S::SMEM, n, num_sms))
      cs = n;
  // a cluster's CTA owns one tile (its partial overwrites the ring)
  long ctas = a.tiles;
  if (cs == 1) {
    const long slots = cluster_slots(kernel, S::THREADS, S::SMEM, 1, num_sms);
    if (slots == 0) return cudaErrorInvalidValue;
    ctas = slots < ctas ? slots : ctas;
  }
  if (ctas > 65535) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    plan[0] = S::BM;
    plan[1] = S::J;
    plan[2] = cs;
  }
  CUtensorMap m_x, m_h, m_w, m_c;
  if (!encode_map(&m_x, x, a.R, C, S::BM, S::KB) ||
      !encode_map(&m_h, h, a.R, C, S::BM, S::KB) ||
      !encode_map(&m_c, c, a.R, C, S::BM, S::CIB / sizeof(CT), sizeof(CT)) ||
      !weight_map(&m_w, w, 4 * C, 2 * C, S::J, S::KB))
    return cudaErrorInvalidValue;
  return launch(kernel, dim3(cs, static_cast<unsigned>(ctas)), S::THREADS,
                S::SMEM, cs, st, m_x, m_h, m_w, m_c, a);
}

template <int C>
cudaError_t launch_lstm_c(const void* x, const void* h, const void* c,
                          const void* w, const void* b, void* h_out,
                          void* c_out, int R, int c_f32, int cluster,
                          int num_sms, int* plan, cudaStream_t st) {
  if (c_f32) {
    const LstmArgs<float> a{static_cast<const bf16*>(b), static_cast<bf16*>(h_out),
                            static_cast<float*>(c_out), R, 0};
    return launch_lstm<C, float>(a, x, h, c, w, cluster, num_sms, plan, st);
  }
  const LstmArgs<bf16> a{static_cast<const bf16*>(b), static_cast<bf16*>(h_out),
                         static_cast<bf16*>(c_out), R, 0};
  return launch_lstm<C, bf16>(a, x, h, c, w, cluster, num_sms, plan, st);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success). Optional vectors may be NULL.

// (C, dim_head) in {32, 64, 128, 256, 512} x {32} (RVT-T, RVT-B) and
// {48, 96, 192, 384} x {24} (RVT-S), T = ph * pw <= 80; LN1 skipped
// where ln_w and ln_b are NULL. `heads` (at most C / dim_head) are the
// heads of qkv_w [3 heads dim_head, C], and o has heads * dim_head
// channels: all of a block's heads, or a model rank's shard of them.
// `cluster` > 0 fixes how many CTAs
// (one head group each) share a window group; 0 lets the plan choose.
// `plan` (NULL or two ints) receives the windows a CTA and the cluster
// size the launch took.
extern "C" int leod_block_attention(const void* x, void* o, const void* ln_w,
                                    const void* ln_b, const void* qkv_w,
                                    const void* qkv_b, int B, int H, int W,
                                    int C, int dim_head, int heads, int ph,
                                    int pw, int grid_kind, float eps,
                                    int cluster, int num_sms, int* plan,
                                    void* stream) {
  if (B < 1 || ph < 1 || pw < 1 || H % ph || W % pw || ph * pw > ATTN_MAX_T ||
      (ln_w == nullptr) != (ln_b == nullptr))
    return cudaErrorInvalidValue;
  AttnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_w = static_cast<const bf16*>(ln_w);
  a.ln_b = static_cast<const bf16*>(ln_b);
  a.qkv_b = static_cast<const bf16*>(qkv_b);
  a.o = static_cast<bf16*>(o);
  a.H = H;
  a.W = W;
  a.ph = ph;
  a.pw = pw;
  a.grid_kind = grid_kind;
  a.nwindows = B * (H / ph) * (W / pw);
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim_head == 32 ? C : (dim_head == 24 ? -C : 0)) {
    case 32: return launch_attention<32, 32>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case 64: return launch_attention<64, 32>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case 128: return launch_attention<128, 32>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case 256: return launch_attention<256, 32>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case 512: return launch_attention<512, 32>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case -48: return launch_attention<48, 24>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case -96: return launch_attention<96, 24>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case -192: return launch_attention<192, 24>(a, qkv_w, heads, cluster, num_sms, plan, st);
    case -384: return launch_attention<384, 24>(a, qkv_w, heads, cluster, num_sms, plan, st);
    default: return cudaErrorInvalidValue;
  }
}

// How many CTAs (a cluster) share a row tile: the largest size among
// 1, 2, 4, 8 that the width takes, that divides the hidden chunks evenly
// (3 at C = 48 give no cluster, 6 at 96 two CTAs) and that keeps the
// grid within one wave (num_sms x the CTAs an SM holds by shared
// memory). Splitting a
// grid that already fills the card costs more than it gains: every CTA
// pays its o load, LN2 over the whole rows and the cluster's barriers
// (stage 1 at B = 8 ran 2.2x slower split 4 ways than alone, H100).
extern "C" int leod_block_mlp_cluster(int R, int C, int inner, int gated,
                                      int num_sms) {
  const int smem = mlp_smem_bytes(C);
  if (R < 1 || smem == 0) return 1;
  const long tiles = (R + MLP_BM - 1) / MLP_BM;
  const long slots = static_cast<long>(num_sms) * ((228 * 1024) / (smem + 1024));
  const int chunks = mlp_chunks(inner, gated);
  int best = 1;
  for (int cs = 2; cs <= 8; cs *= 2)
    if (mlp_cluster_ok(C, inner, gated, cs) && chunks % cs == 0 &&
        tiles * cs <= slots)
      best = cs;
  return best;
}

// C in {32, 48, 64, 96, 128, 192, 256, 384, 512}; `cluster` CTAs share
// each 64-row tile
extern "C" int leod_block_mlp(const void* x, const void* o, void* out,
                              const void* proj_w, const void* proj_b,
                              const void* ls1, const void* ln_w,
                              const void* ln_b, const void* in_w,
                              const void* in_b, const void* out_w,
                              const void* out_b, const void* ls2, int R,
                              int C, int inner, int gated, int act, float eps,
                              int cluster, void* stream) {
  if (R < 1 || !mlp_inner_ok(inner) || ln_w == nullptr ||
      ln_b == nullptr || !mlp_cluster_ok(C, inner, gated, cluster))
    return cudaErrorInvalidValue;
  MlpArgs a = {};
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
    case 48: return launch_mlp<48>(a, proj_w, in_w, out_w, cluster, st);
    case 64: return launch_mlp<64>(a, proj_w, in_w, out_w, cluster, st);
    case 96: return launch_mlp<96>(a, proj_w, in_w, out_w, cluster, st);
    case 128: return launch_mlp<128>(a, proj_w, in_w, out_w, cluster, st);
    case 192: return launch_mlp<192>(a, proj_w, in_w, out_w, cluster, st);
    case 256: return launch_mlp<256>(a, proj_w, in_w, out_w, cluster, st);
    case 384: return launch_mlp<384>(a, proj_w, in_w, out_w, cluster, st);
    case 512: return launch_mlp<512>(a, proj_w, in_w, out_w, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}

// The model axis's mode of block_mlp_kernel: from x and the
// out-projection summed over the model group a (fp32 [R, C], no bias),
// x1 = x + ls1 (a + proj_b) into x1 and this rank's fp32 partial MLP
// output (its `inner` units, no bias) into part. C and the cluster as
// leod_block_mlp's.
extern "C" int leod_block_mlp_tp(const void* x, const void* a, void* x1,
                                 void* part, const void* proj_b,
                                 const void* ls1, const void* ln_w,
                                 const void* ln_b, const void* in_w,
                                 const void* in_b, const void* out_w, int R,
                                 int C, int inner, int gated, int act,
                                 float eps, int cluster, void* stream) {
  if (R < 1 || !mlp_inner_ok(inner) || ln_w == nullptr ||
      ln_b == nullptr || a == nullptr || part == nullptr ||
      !mlp_cluster_ok(C, inner, gated, cluster))
    return cudaErrorInvalidValue;
  MlpArgs m = {};
  m.x = static_cast<const bf16*>(x);
  m.proj_b = static_cast<const bf16*>(proj_b);
  m.ls1 = static_cast<const bf16*>(ls1);
  m.ln_w = static_cast<const bf16*>(ln_w);
  m.ln_b = static_cast<const bf16*>(ln_b);
  m.in_b = static_cast<const bf16*>(in_b);
  m.out = static_cast<bf16*>(x1);
  m.R = R;
  m.inner = inner;
  m.gated = gated;
  m.act = act;
  m.eps = eps;
  m.tp = 1;
  m.a = static_cast<const float*>(a);
  m.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch_mlp<32>(m, nullptr, in_w, out_w, cluster, st);
    case 48: return launch_mlp<48>(m, nullptr, in_w, out_w, cluster, st);
    case 64: return launch_mlp<64>(m, nullptr, in_w, out_w, cluster, st);
    case 96: return launch_mlp<96>(m, nullptr, in_w, out_w, cluster, st);
    case 128: return launch_mlp<128>(m, nullptr, in_w, out_w, cluster, st);
    case 192: return launch_mlp<192>(m, nullptr, in_w, out_w, cluster, st);
    case 256: return launch_mlp<256>(m, nullptr, in_w, out_w, cluster, st);
    case 384: return launch_mlp<384>(m, nullptr, in_w, out_w, cluster, st);
    case 512: return launch_mlp<512>(m, nullptr, in_w, out_w, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}

// out = x1 + ls2 (p + out_b) over R rows of C channels (a multiple of
// 8): x1 and out bf16, p fp32, out_b and ls2 NULL where absent.
extern "C" int leod_block_residual(const void* x1, const void* p,
                                   const void* out_b, const void* ls2,
                                   void* out, int R, int C, void* stream) {
  if (R < 1 || C < 8 || C % 8) return cudaErrorInvalidValue;
  const long n8 = static_cast<long>(R) * C / 8;
  const int threads = 256;
  const long blocks = (n8 + threads - 1) / threads;
  block_residual_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x1), static_cast<const float*>(p),
      static_cast<const bf16*>(out_b), static_cast<const bf16*>(ls2),
      static_cast<bf16*>(out), n8, C);
  return cudaGetLastError();
}

// C in {32, 48, 64, 96, 128, 192, 256, 384, 512}; x, h, w [4C, 2C], b
// and h_out bf16, c
// and c_out fp32 where c_f32, else bf16. `cluster` > 0 fixes how many
// CTAs (1, 2, 4 or 8) split K for a tile; 0 lets the plan choose. `plan`
// (NULL or three ints) receives the rows and channels a tile and the
// cluster size the launch took.
extern "C" int leod_lstm_update(const void* x, const void* h, const void* c,
                                const void* w, const void* b, void* h_out,
                                void* c_out, int R, int C, int c_f32,
                                int cluster, int num_sms, int* plan,
                                void* stream) {
  if (R < 1 || b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch_lstm_c<32>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 48: return launch_lstm_c<48>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 64: return launch_lstm_c<64>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 96: return launch_lstm_c<96>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 128: return launch_lstm_c<128>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 192: return launch_lstm_c<192>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 256: return launch_lstm_c<256>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 384: return launch_lstm_c<384>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    case 512: return launch_lstm_c<512>(x, h, c, w, b, h_out, c_out, R, c_f32, cluster, num_sms, plan, st);
    default: return cudaErrorInvalidValue;
  }
}
