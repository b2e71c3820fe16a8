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
//   block_mlp_kernel  per-token on 64-row tiles of B*H*W (wgmma's M):
//       the output projection, LayerScale, residual, LayerNorm 2, and the
//       MLP with the hidden dim walked in 64-wide chunks whose activations
//       stay in shared memory, on wgmma with every weight tile streamed
//       by TMA through a ring of shared-memory stages; persistent CTAs of
//       a producer warpgroup and two consumer warpgroups, which take a
//       tile each (C <= 64) or split one tile's columns (section below).
//       Where B*H*W gives too few tiles to fill the card (stages 3-4,
//       or any stage at small B), a thread-block cluster of up to 8 CTAs
//       shares a unit of tiles: each projects C / size of the columns and
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
// Three chained products a 64-row tile of tokens (wgmma's M), with A and
// B in shared memory:
//   GEMM0  o [64, C] x proj^T          -> y = x + ls1 (proj + b)
//   GEMM1  z [64, C] x proj_in^T chunk -> act(. + b), bf16, into an H tile
//   GEMM2  H [64, 64] x proj_out^T     -> the [64, C] fp32 accumulator
// with z = LN2(y) written over the o rows. The hidden activations never
// reach device memory (flash attention's P.V pattern).
//
// What bounds it on the H100, at LEOD's Gen1 B = 16 (R C^2 is the same
// at every stage): 18 C^2 flops a token against 6 C bytes of bf16 rows
// in and out, so C = 64 is bound by bytes (9.4 us) and C = 128-512 by
// tensor-core operations (6.1 us). The roofline leaves out the exact
// GELU on the SIMT units (tanhf: about 21 instructions an element, 4 C
// elements a row, most of the SIMT work at C = 64-128) and the weights,
// which every unit streams from L2 (18 C^2 bytes a tile). Measured, a
// launch is bound by latency: each warpgroup's chain of wgmma and
// mbarrier waits and dependent SIMT work a hidden chunk, with 8
// consumer warps an SM (PERF.md, section 6).
//
// The schedule: persistent and warp-specialised. A producer warpgroup
// (one thread issues every TMA load; setmaxnreg hands its registers to
// the consumers, 232 a thread) and two consumer warpgroups, one CTA an
// SM. The grid is one wave; each CTA, or each cluster, walks units
// blockIdx.y, + gridDim.y, ...
//   C <= 64 (PAIR): a unit is two row tiles, one a warpgroup. Each
//     warpgroup runs its own tile's chain, unsynchronised with the other,
//     and both read every weight tile the producer streams, which halves
//     the weight bytes a row costs.
//   C >= 96: a [64, C] accumulator would crowd a warpgroup's registers,
//     so a unit is one tile whose columns the two split (GEMM1's hidden
//     units, GEMM2's output columns; two H tiles between them, a named
//     barrier a chunk). One-tile units also spread a stage's rows more
//     evenly over the card (C = 128 at B = 16: 320 tiles on 132 CTAs).
// One ring of NS stages (full/empty mbarriers) holds a chunk's proj_in
// rows or proj_out columns, or the projection's K-blocks. The next
// unit's o rows come by TMA into A once a warpgroup's last GEMM1 is done
// with it, its x rows a unit ahead into an x tile. Chunk j's GEMM1 is
// issued with chunk j - 1's GEMM2, which runs beside chunk j's bias,
// activation and H-tile stores (C <= 256); at C = 384-512, where the
// registers do not hold both, chunk j's GEMM2 is issued as soon as its H
// tile is written and runs beside the wait for chunk j + 1's weights.
//
// y stays on chip at C <= 256: it replaces x in the x tile, where LN2
// takes its row statistics (a quad's shuffles; across two warpgroups
// through 1 KB of shared memory) and the epilogue its residual, and
// `out` is written once. At C = 384-512 no x tile fits beside the ring:
// y is written to `out` once and read back in the epilogue. Where units
// are fewer than the card's slots, a cluster of CS CTAs (2, 4 or 8; the
// launch's cluster dimension x) shares each unit: CTA r projects
// columns [r C / CS, (r + 1) C / CS) and takes a share of the hidden
// chunks; the y slices meet in `out` (L2) for LN2, and the fp32 partial
// sums are added over distributed shared memory in rank order, with no
// atomics, so launches agree bit for bit.
//
// Shared memory at C = 256: the A tile (32 KB), the x tile (32 KB), two H
// tiles (16 KB) and four 32 KB ring stages; a cluster's fp32 partials
// (65 KB) reuse them once the unit's last product is done.

constexpr int MLP_BM = 64;         // token rows a tile (wgmma's M)
constexpr int MLP_HBUF = 8192;     // bytes of one H tile (64 x 64 bf16)

template <int C>
struct MlpShape {
  // C <= 64: each consumer warpgroup runs its own row tile; above, a
  // [64, C] accumulator would crowd a warpgroup's registers, and the two
  // split one tile's columns (and a unit of one tile spreads fewer rows'
  // tiles over the card more evenly)
  static constexpr bool PAIR = C <= 64;
  static constexpr int TPC = PAIR ? 2 : 1;        // row tiles a unit
  static constexpr int NW = PAIR ? C : C / 2;     // output columns a warpgroup
  static constexpr int PB = PAIR ? 1 : 2;         // weight boxes a stage row block
  // GEMM1's product columns a warpgroup, a chunk
  static constexpr int HN = PAIR ? 64 : 32;
  // GEMM2 of chunk j - 1 runs beside chunk j's activation where the
  // registers hold both (a warpgroup's accumulator of 64 at most); wider,
  // chunk j's GEMM2 is issued as soon as its H tile is written and runs
  // beside the wait for chunk j + 1's weights
  static constexpr bool OVERLAP = NW <= 128;
  static constexpr int KB = kblock(C);            // K-block of a C-deep operand
  static constexpr int NKB = C / KB;
  static constexpr int SW = KB * 2;               // its swizzle (= row) bytes
  static constexpr int NCT = 256;                 // two consumer warpgroups
  static constexpr int THREADS = NCT + 128;       // + the producer warpgroup
  static constexpr int TILE = 128 * C;            // a [64, C] bf16 tile
  // a ring stage: a chunk's proj_in rows, its proj_out columns, or
  // K-blocks of the projection
  static constexpr int STAGE = 128 * C;
  static constexpr int HBYTES = TPC * 2 * MLP_HBUF;  // two H tiles a group
  // where they fit beside four ring stages, x tiles (two a unit tile in
  // PAIR mode, whose CTAs walk many units; else one): a unit's x rows
  // come by TMA ahead of it, y replaces them in place and stays there
  // until the epilogue; else x is read from device memory and y goes to
  // `out` (C = 384, 512)
  static constexpr int XB = PAIR ? 2 : 1;
  static constexpr bool XS = (1 + XB) * TPC * TILE + HBYTES + 4 * STAGE + 3072 <=
                             static_cast<int>(kMaxSmem);
  static constexpr int XOFF = TPC * TILE;
  static constexpr int HOFF = XOFF + (XS ? XB * TPC * TILE : 0);
  static constexpr int RING = HOFF + HBYTES;
  static constexpr int NSF = (static_cast<int>(kMaxSmem) - 3072 - RING) / STAGE;
  static constexpr int NS = NSF < 8 ? NSF : 8;    // ring stages
  static constexpr int LDP = C + 4;               // fp32 row stride of a partial
  static constexpr int PART = TPC * MLP_BM * LDP * 4;
  static constexpr int BODY = RING + NS * STAGE > PART ? RING + NS * STAGE : PART;
  // mbarriers: full, empty (NS each), afull, aempty (TPC each), xfull,
  // xempty (XB TPC each); then LN2's row sums of the two warpgroups (two
  // exchanges)
  static constexpr int BOFF = BODY;
  static constexpr int ROFF = BOFF + (2 * NS + 2 * TPC + 2 * XB * TPC) * 8;
  static constexpr int SMEM = ROFF + 4 * MLP_BM * 4 + 1024;   // + alignment
  static_assert(NS >= 2 && SMEM <= static_cast<int>(kMaxSmem), "MLP smem");
};

// Weight boxes a K-block of a cluster's projection weight (ccols rows a
// CTA): one a warpgroup (pb, 2 where the warpgroups split a tile's
// columns) where each box's rows are a multiple of 8, else one, which
// warpgroup 0 alone projects (mlp_project_cs)
__host__ __device__ constexpr int mlp_proj_boxes(int ccols, int pb) {
  return ccols / pb % 8 == 0 ? pb : 1;
}

struct MlpArgs {
  const bf16 *x, *proj_b, *ls1, *ln_w, *ln_b, *in_b, *out_b, *ls2;
  bf16* out;      // a cluster keeps the y rows here until its epilogue
  int R, inner, gated, act, units;
  float eps;
  // the model axis's mode (tp = 1): the out-projection summed over the
  // model group `a` (fp32, no bias) replaces o and GEMM0, `out` gets the
  // y rows (x1), and the fp32 partial MLP output, without its bias,
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

// mbar_wait for block_mlp_kernel: the same wait, its trap counted in
// tries (2^28, many seconds) rather than cycles, which keeps a 64-bit
// clock out of the registers of every wait in its loops
__device__ __forceinline__ void mlp_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, tries = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && ++tries > (1u << 28)) __trap();
  }
}

// named barrier `id` over `threads` threads (each warp reconverges first)
__device__ __forceinline__ void named_sync(int id, int threads) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// Loads and stores stay on their side of it. Every few column groups of
// an unrolled loop over a thread's accumulator layout, it keeps the
// compiler from hoisting every group's loads (or interleaving every
// group's activations) at once beside the accumulators, which spilled.
__device__ __forceinline__ void group_fence() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// elements i, i + 1 (i even) of an optional bf16 vector, zeros where absent
__device__ __forceinline__ float2 opt2(const bf16* p, int i) {
  return p ? unpack_bf16(*reinterpret_cast<const uint32_t*>(p + i))
           : make_float2(0.f, 0.f);
}

// GEMM1 of a chunk: HN product columns from proj_in stage row ua, z
// from A, into h; in the GLU HN / 2 from row ua and HN / 2 of the gate
// half from row ub
template <int C>
__device__ __forceinline__ void mlp_gemm1(float* h, const unsigned char* A,
                                          uint32_t b1, int ua, int ub,
                                          int gated) {
  using S = MlpShape<C>;
  if (!gated) {
#pragma unroll
    for (int kb = 0; kb < S::NKB; ++kb) {
      const uint32_t a = smem_u32(A + kb * MLP_BM * S::SW);
      const uint32_t b = b1 + (kb * 64 + ua) * S::SW;
#pragma unroll
      for (int k = 0; k < S::KB / 16; ++k)
        wgmma_ss<S::HN>(h, gmma_desc(a + 32 * k, S::SW),
                        gmma_desc(b + 32 * k, S::SW), kb + k > 0);
    }
    return;
  }
#pragma unroll
  for (int kb = 0; kb < S::NKB; ++kb) {
    const uint32_t a = smem_u32(A + kb * MLP_BM * S::SW);
    const uint32_t b = b1 + kb * 64 * S::SW;
#pragma unroll
    for (int k = 0; k < S::KB / 16; ++k) {
      wgmma_ss<S::HN / 2>(h, gmma_desc(a + 32 * k, S::SW),
                          gmma_desc(b + ua * S::SW + 32 * k, S::SW), kb + k > 0);
      wgmma_ss<S::HN / 2>(h + S::HN / 4, gmma_desc(a + 32 * k, S::SW),
                          gmma_desc(b + ub * S::SW + 32 * k, S::SW), kb + k > 0);
    }
  }
}

// GEMM2's k16 steps [k0, k1) of one chunk: acc (+)= H x the chunk's
// proj_out columns at b2 (rows of hsw bytes, both); `add` false starts
// the sum
template <int C>
__device__ __forceinline__ void mlp_gemm2(float* acc, const unsigned char* H,
                                          uint32_t b2, int hsw, int k0,
                                          int k1, bool add) {
  using S = MlpShape<C>;
  const uint32_t ha = smem_u32(H);
  for (int k = k0; k < k1; ++k)
    wgmma_ss<S::NW>(acc, gmma_desc(ha + 32 * k, hsw),
                    gmma_desc(b2 + 32 * k, hsw), add || k > k0);
}

// bias and activation of one pass's products, bf16 into H tile `H`
// (64 hidden units of chunk j a row, 32 in the GLU) from unit u0
template <int C>
__device__ __forceinline__ void mlp_activate(const MlpArgs& p, const float* h,
                                             unsigned char* H, int j, int u0,
                                             int wr, int q2) {
  using S = MlpShape<C>;
  if (!p.gated) {
#pragma unroll
    for (int i = 0; i < S::HN / 8; ++i) {
      const int cl = u0 + 8 * i + q2;
      const int u = j * 64 + cl;
      // an inner dim of 32 mod 64 ends in a half chunk: TMA filled its
      // missing weight rows with zeros, and act(0 + 0) = 0 adds nothing
      const float2 b = u < p.inner ? opt2(p.in_b, u) : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(H + swz(wr + 8 * hh, cl * 2, 128)) =
            pack_bf16(activate(h[4 * i + 2 * hh] + b.x, p.act),
                      activate(h[4 * i + 2 * hh + 1] + b.y, p.act));
      if (i % 2) group_fence();
    }
  } else {
#pragma unroll
    for (int i = 0; i < S::HN / 16; ++i) {
      const int cl = u0 + 8 * i + q2;
      const float2 a = opt2(p.in_b, j * 32 + cl);
      const float2 g = opt2(p.in_b, p.inner + j * 32 + cl);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * i + 2 * hh;
        *reinterpret_cast<uint32_t*>(H + swz(wr + 8 * hh, cl * 2, 64)) =
            pack_bf16((h[e] + a.x) * activate(h[S::HN / 4 + e] + g.x, p.act),
                      (h[e + 1] + a.y) * activate(h[S::HN / 4 + e + 1] + g.y, p.act));
      }
      if (i % 2) group_fence();
    }
  }
}

// Chunk j of the MLP for one warpgroup: its GEMM1 into registers, then
// bias, activation and the H tile. PREV (OVERLAP): chunk j - 1's GEMM2
// is issued after the GEMM1 and runs beside the activation; else, where
// `s_prev` >= 0, it was issued after chunk j - 1 and ends with the GEMM1.
// Either way its proj_out stage is then freed. `first`: chunk j - 1 is
// the first whose GEMM2 this warpgroup issues (it starts the sum).
// `aempty`, where not NULL: the unit's last GEMM1 is done with A, so the
// next unit's o rows may come.
template <int C, bool PREV>
__device__ __forceinline__ void mlp_chunk(
    const MlpArgs& p, float* acc, float* hreg, const unsigned char* A,
    const unsigned char* ring, uint64_t* full, uint64_t* empty, int s_in,
    uint32_t par_in, int s_prev, uint32_t par_prev, const unsigned char* hprev,
    unsigned char* hj, int j, int w, int wr, int q2, int hsw, bool first,
    uint64_t* aempty) {
  using S = MlpShape<C>;
  mlp_wait(&full[s_in], par_in);
  // the chunk's first hidden unit of this warpgroup, and its product rows
  const int u0 = S::PAIR ? 0 : w * (p.gated ? S::HN / 2 : S::HN);
  const int ub = p.gated ? 32 + u0 : u0 + S::HN / 2;
  wgmma_fence();
  mlp_gemm1<C>(hreg, A, smem_u32(ring + s_in * S::STAGE), u0, ub, p.gated);
  wgmma_commit();
  if constexpr (PREV) {
    mlp_wait(&full[s_prev], par_prev);
    mlp_gemm2<C>(acc, hprev,
                 smem_u32(ring + s_prev * S::STAGE) + (S::PAIR ? 0 : w * S::NW * hsw),
                 hsw, 0, hsw / 32, !first);
    wgmma_commit();
    wgmma_wait1();   // this chunk's GEMM1
  } else {
    wgmma_wait0();
  }
  fence_regs<S::HN / 2>(hreg);
  mbar_arrive(&empty[s_in]);
  if (aempty != nullptr) mbar_arrive(aempty);
  if (!PREV && s_prev >= 0) mbar_arrive(&empty[s_prev]);
  mlp_activate<C>(p, hreg, hj, j, u0, wr, q2);
  if constexpr (PREV) {
    wgmma_wait0();
    mbar_arrive(&empty[s_prev]);
  }
}

// Issues chunk j's GEMM2 (its H tile at h, its proj_out stage s) once
// the stage has come; `first` starts the sum
template <int C>
__device__ __forceinline__ void mlp_issue_gemm2(float* acc, const unsigned char* h,
                                                const unsigned char* ring,
                                                uint64_t* full, int s,
                                                uint32_t par, int w, int hsw,
                                                bool first) {
  using S = MlpShape<C>;
  mlp_wait(&full[s], par);
  wgmma_fence();
  mlp_gemm2<C>(acc, h, smem_u32(ring + s * S::STAGE) + (S::PAIR ? 0 : w * S::NW * hsw),
               hsw, 0, hsw / 32, !first);
  wgmma_commit();
}

// A row's sums over its C columns from each thread's share (rows wr and
// wr + 8): a quad holds a warpgroup's columns of a row; above C = 256
// the two warpgroups add theirs through `red` (64 floats each), in one
// order for both, so both take the same statistics
template <int C>
__device__ __forceinline__ void mlp_row_sums(float (&s)[2], float* red, int w,
                                             int wr, int q2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
  }
  if constexpr (!MlpShape<C>::PAIR) {
    if (q2 == 0)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) red[w * MLP_BM + wr + 8 * hh] = s[hh];
    consumer_sync(MlpShape<C>::NCT);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      s[hh] = red[wr + 8 * hh] + red[MLP_BM + wr + 8 * hh];
  }
}

// A cluster's projection: N0 columns from c0 of the warpgroup's tile
// (row0..), kpt K-blocks a ring stage, and y = x + ls1 * (proj + b),
// each step rounded as in the plain path, into `out` (where every CTA
// of the cluster reads the whole rows for LayerNorm 2)
template <int C, int N0>
__device__ __forceinline__ void mlp_project(const MlpArgs& p,
                                            const unsigned char* A,
                                            const unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int boff, int c0, int row0,
                                            int ccols, int kpt, int wr,
                                            int q2, int& stage,
                                            uint32_t& phase) {
  using S = MlpShape<C>;
  float acc[N0 / 2];
  int prev = -1;
  for (int t = 0; t < S::NKB / kpt; ++t) {
    const int s = stage;
    mlp_wait(&full[s], phase);
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }
    const uint32_t b = smem_u32(ring + s * S::STAGE) + boff;
    wgmma_fence();
    for (int k = 0; k < kpt; ++k) {
      const uint32_t a = smem_u32(A + (t * kpt + k) * MLP_BM * S::SW);
#pragma unroll
      for (int kk = 0; kk < S::KB / 16; ++kk)
        wgmma_ss<N0>(acc, gmma_desc(a + 32 * kk, S::SW),
                     gmma_desc(b + k * ccols * S::SW + 32 * kk, S::SW),
                     t + k + kk > 0);
    }
    wgmma_commit();
    wgmma_wait1();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait0();
  fence_regs<N0 / 2>(acc);
  mbar_arrive(&empty[prev]);
#pragma unroll
  for (int i = 0; i < N0 / 8; ++i) {
    const int col = c0 + 8 * i + q2;
    const float2 b = opt2(p.proj_b, col), l = opt2(p.ls1, col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + wr + 8 * hh;
      float v0 = round_bf16(acc[4 * i + 2 * hh] + b.x);
      float v1 = round_bf16(acc[4 * i + 2 * hh + 1] + b.y);
      if (p.ls1) {
        v0 = round_bf16(v0 * l.x);
        v1 = round_bf16(v1 * l.y);
      }
      if (row >= p.R) continue;
      const size_t idx = static_cast<size_t>(row) * C + col;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(p.x + idx));
      *reinterpret_cast<uint32_t*>(p.out + idx) = pack_bf16(xv.x + v0, xv.y + v1);
    }
  }
}

// A cluster of CS CTAs' projection (C / CS columns a CTA): each
// warpgroup's share, where that is a multiple of 8 (wgmma's N step);
// else (C = 96 over 4 CTAs, 192 over 8) warpgroup 0 projects all the
// CTA's columns, from one weight box a K-block (mlp_proj_boxes), and
// warpgroup 1 only passes the ring's stages on
template <int C, int CS>
__device__ __forceinline__ void mlp_project_cs(
    const MlpArgs& p, const unsigned char* A, const unsigned char* ring,
    uint64_t* full, uint64_t* empty, int boff, int c0, int row0, int ccols,
    int kpt, int w, int wr, int q2, int& stage, uint32_t& phase) {
  using S = MlpShape<C>;
  constexpr int N2 = S::NW / CS;
  if constexpr (N2 % 8 == 0) {
    mlp_project<C, N2>(p, A, ring, full, empty, boff, c0, row0, ccols, kpt,
                       wr, q2, stage, phase);
  } else if constexpr (!S::PAIR && N2 % 4 == 0) {
    if (w == 0) {
      mlp_project<C, 2 * N2>(p, A, ring, full, empty, 0, c0, row0, ccols,
                             kpt, wr, q2, stage, phase);
      return;
    }
    for (int t = 0; t < S::NKB / kpt; ++t) {
      mlp_wait(&full[stage], phase);
      mbar_arrive(&empty[stage]);
      if (++stage == S::NS) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// y = x + ls1 * (a + b) for the columns col0.. (ccols of them) of the
// tile at row0, from the out-projection summed over the model group a
// (fp32), rounded as the plain path rounds, into `out` (a cluster in
// the model axis's mode)
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
    const float2 b = opt2(p.proj_b, col), l = opt2(p.ls1, col);
    float v0 = round_bf16(av.x + b.x);
    float v1 = round_bf16(av.y + b.y);
    if (p.ls1) {
      v0 = round_bf16(v0 * l.x);
      v1 = round_bf16(v1 * l.y);
    }
    const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(p.x + idx));
    *reinterpret_cast<uint32_t*>(p.out + idx) = pack_bf16(xv.x + v0, xv.y + v1);
  }
}

// A cluster's LayerNorm 2 of the tile's whole y rows, read from `out`,
// into A (swizzled, zero past R): fp32 statistics in two passes, a warp
// a row, each warp's loads of LG rows in flight together
template <int C>
__device__ __forceinline__ void mlp_ln2_from_out(const MlpArgs& p,
                                                 unsigned char* A, int row0,
                                                 int warp, int nwarps) {
  using S = MlpShape<C>;
  constexpr int NCH = (C / 8 + 31) / 32;   // 16-byte chunks per lane
  constexpr int LG = 4;                    // rows a warp loads at once
  const int lane = threadIdx.x % 32;
  for (int r0 = warp * LG; r0 < MLP_BM; r0 += nwarps * LG) {
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
        *reinterpret_cast<uint4*>(A + kb * MLP_BM * S::SW + swz(r, b, S::SW)) = z;
      }
    }
  }
}

// The model axis's mode (p.tp, a block sharded over the model group,
// parallel/tensor.py): the out-projection's sum crosses the ranks before
// the residual, so o and GEMM0 give way to y = x + ls1 * (a + b) from
// the summed projection a, written to `out` (x1); LN2 is unchanged, the
// hidden chunks are this rank's inner units (its rows of proj_in, of
// both halves where gated, and its columns of proj_out: `inner` is the
// rank's), and the epilogue writes the fp32 partial sum, without bias,
// LayerScale or residual, to `part`. The last residual waits for the
// partials' sum over the ranks (block_residual_kernel).
template <int C>
__global__ void __launch_bounds__(MlpShape<C>::THREADS, 1)
    block_mlp_kernel(const __grid_constant__ CUtensorMap m_o,
                     const __grid_constant__ CUtensorMap m_x,
                     const __grid_constant__ CUtensorMap m_proj,
                     const __grid_constant__ CUtensorMap m_in,
                     const __grid_constant__ CUtensorMap m_out,
                     const MlpArgs p) {
  using S = MlpShape<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + S::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BOFF);
  uint64_t* empty = full + S::NS;
  uint64_t* afull = empty + S::NS;      // a unit's o rows in A tile ts
  uint64_t* aempty = afull + S::TPC;
  uint64_t* xfull = aempty + S::TPC;    // its x rows in x tile (n % XB, ts)
  uint64_t* xempty = xfull + S::XB * S::TPC;

  const int tid = threadIdx.x;
  const int hc = p.gated ? 32 : 64;     // hidden units a chunk
  const int hsw = hc * 2;               // an H row's bytes (its swizzle)
  // an ungated inner dim of 32 mod 64 (a model rank's shard: RVT-S
  // stage 1's 96 units) ends in a half chunk
  const int nchunks = (p.inner + hc - 1) / hc;
  const int cs = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int j0 = rank * nchunks / cs, j1 = (rank + 1) * nchunks / cs;
  const int ccols = C / cs, col0 = rank * ccols;   // this CTA's columns
  const int pb = mlp_proj_boxes(ccols, S::PB);
  const int n0 = ccols / pb;                       // of them, a box's
  const int kpt = kblocks_per_stage(S::STAGE, ccols, S::SW, S::NKB);
  // x rows come by TMA into x tiles where they fit, for a CTA alone on
  // its tiles and outside the model axis's mode; else they are read
  // where y is made
  const bool xs = S::XS && cs == 1 && !p.tp;

  if (tid == 0) {
    for (int i = 0; i < S::NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], S::NCT);
    }
    for (int i = 0; i < S::TPC; ++i) {
      mbar_init(&afull[i], 1);
      mbar_init(&aempty[i], S::NCT / S::TPC);
    }
    for (int i = 0; i < S::XB * S::TPC; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], S::NCT / S::TPC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= S::NCT) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // producer: a unit's x tiles (xs), o tiles, the projection's K-blocks
    // of this CTA's columns (kpt a stage), then per hidden chunk j its
    // proj_in rows (GEMM1) and its proj_out columns (GEMM2), in the
    // consumers' order. In a cluster every thread of the warpgroup also
    // takes part in the unit's three cluster barriers, and the next unit
    // waits for the last: the partials overwrite A and the ring.
    const bool issuer = tid == S::NCT;
    if (!issuer && cs == 1) return;
    int stage = 0;
    uint32_t phase = 0;
    auto take = [&]() {
      const int s = stage;
      mlp_wait(&empty[s], phase ^ 1);
      if (++stage == S::NS) {
        stage = 0;
        phase ^= 1;
      }
      return s;
    };
    int n = 0;
    for (int g = blockIdx.y; g < p.units; g += gridDim.y, ++n) {
      if (issuer && !p.tp) {
        for (int ts = 0; xs && ts < S::TPC; ++ts) {
          const int xb = (n % S::XB) * S::TPC + ts;
          mlp_wait(&xempty[xb], ((n / S::XB) & 1) ^ 1);
          mbar_expect_tx(&xfull[xb], S::TILE);
          for (int kb = 0; kb < S::NKB; ++kb)
            tma_load_2d(smem + S::XOFF + xb * S::TILE + kb * MLP_BM * S::SW, &m_x,
                        &xfull[xb], kb * S::KB, (g * S::TPC + ts) * MLP_BM);
        }
        for (int ts = 0; ts < S::TPC; ++ts) {
          mlp_wait(&aempty[ts], (n & 1) ^ 1);
          mbar_expect_tx(&afull[ts], S::TILE);
          for (int kb = 0; kb < S::NKB; ++kb)
            tma_load_2d(smem + ts * S::TILE + kb * MLP_BM * S::SW, &m_o,
                        &afull[ts], kb * S::KB, (g * S::TPC + ts) * MLP_BM);
        }
        for (int t = 0; t < S::NKB / kpt; ++t) {
          const int s = take();
          unsigned char* dst = ring + s * S::STAGE;
          mbar_expect_tx(&full[s], kpt * ccols * S::SW);
          for (int k = 0; k < kpt; ++k)
            for (int h = 0; h < pb; ++h)
              tma_load_2d(dst + (k * ccols + h * n0) * S::SW, &m_proj, &full[s],
                          (t * kpt + k) * S::KB, col0 + h * n0);
        }
      }
      if (cs > 1) {
        __syncwarp();
        cluster_arrive();
      }
      if (issuer) {
        for (int j = j0; j < j1; ++j) {
          int s = take();
          unsigned char* dst = ring + s * S::STAGE;
          mbar_expect_tx(&full[s], S::STAGE);
          for (int kb = 0; kb < S::NKB; ++kb) {
            if (!p.gated) {
              tma_load_2d(dst + kb * 64 * S::SW, &m_in, &full[s], kb * S::KB, j * 64);
            } else {
              tma_load_2d(dst + kb * 64 * S::SW, &m_in, &full[s], kb * S::KB, j * 32);
              tma_load_2d(dst + (kb * 64 + 32) * S::SW, &m_in, &full[s],
                          kb * S::KB, p.inner + j * 32);
            }
          }
          s = take();
          dst = ring + s * S::STAGE;
          mbar_expect_tx(&full[s], C * hsw);
          for (int h = 0; h < S::PB; ++h)
            tma_load_2d(dst + h * S::NW * hsw, &m_out, &full[s], j * hc, h * S::NW);
        }
      }
      if (cs > 1) {
        __syncwarp();
        cluster_wait();
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
        cluster_wait();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int w = tid / 128, t = tid % 128;
  const int wr = (t / 32) * 16 + (t % 32) / 4;  // the thread's rows wr, wr + 8
  const int q2 = (t % 4) * 2;                   // its column pair in each 8
  const int ts = S::PAIR ? w : 0;               // its warpgroup's tile of a unit
  // the threads that share its A and H tiles, and their named barrier
  const int gid = S::PAIR ? 2 + w : 1;
  const int gn = S::PAIR ? 128 : S::NCT;
  const int gt = S::PAIR ? t : tid;
  unsigned char* A = smem + ts * S::TILE;
  unsigned char* H0 = smem + S::HOFF + (S::PAIR ? w * 2 * MLP_HBUF : 0);
  float* red = reinterpret_cast<float*>(smem + S::ROFF);
  const int cb = S::PAIR ? 0 : w * S::NW;       // its first output column
  const int c0 = col0 + (S::PAIR ? 0 : w * n0); // and a cluster's projection's
  int stage = 0;
  uint32_t phase = 0;
  auto claim = [&](uint32_t& par) {
    const int s = stage;
    par = phase;
    if (++stage == S::NS) {
      stage = 0;
      phase ^= 1;
    }
    return s;
  };

  int n = 0;
  for (int g = blockIdx.y; g < p.units; g += gridDim.y, ++n) {
    const int row0 = (g * S::TPC + ts) * MLP_BM;
    // this unit's x tile (XS): y replaces x in it, until the epilogue
    const int xb = (n % S::XB) * S::TPC + ts;
    unsigned char* X = smem + S::XOFF + xb * S::TILE;
    uint64_t* xf = &xfull[xb];
    uint64_t* xe = &xempty[xb];
    const uint32_t xpar = (n / S::XB) & 1;
    float acc[S::NW / 2];

    if (cs == 1 && !p.tp) {
      // 1. x in the accumulator's layout where no x tile holds it (rows
      // past R read row R - 1, not stored)
      uint32_t yv[S::XS ? 1 : S::NW / 4];
      if constexpr (!S::XS) {
#pragma unroll
        for (int i = 0; i < S::NW / 8; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = min(row0 + wr + 8 * hh, p.R - 1);
            yv[2 * i + hh] = *reinterpret_cast<const uint32_t*>(
                p.x + static_cast<size_t>(row) * C + cb + 8 * i + q2);
          }
      }
      // 2. GEMM0 over the o rows in A (TMA, zero past R)
      constexpr int KPT = kblocks_per_stage(S::STAGE, C, S::SW, S::NKB);
      mlp_wait(&afull[ts], n & 1);
#pragma unroll
      for (int i = 0; i < S::NW / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < S::NKB / KPT; ++kt) {
        uint32_t par;
        const int s = claim(par);
        mlp_wait(&full[s], par);
        const uint32_t b = smem_u32(ring + s * S::STAGE) + (S::PAIR ? 0 : w * S::NW * S::SW);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          const uint32_t a = smem_u32(A + (kt * KPT + k) * MLP_BM * S::SW);
#pragma unroll
          for (int kk = 0; kk < S::KB / 16; ++kk)
            wgmma_ss<S::NW>(acc, gmma_desc(a + 32 * kk, S::SW),
                            gmma_desc(b + k * C * S::SW + 32 * kk, S::SW), 1);
        }
        wgmma_commit();
        wgmma_wait1();
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait0();
      fence_regs<S::NW / 2>(acc);
      mbar_arrive(&empty[prev]);
      // 3. y = x + ls1 * (proj + b), each step rounded as in the plain
      // path: over x in its tile (XS), else into `out`; and its row sums
      if constexpr (S::XS) mlp_wait(xf, xpar);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < S::NW / 8; ++i) {
        const int col = cb + 8 * i + q2;
        const float2 b = opt2(p.proj_b, col), l = opt2(p.ls1, col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v0 = round_bf16(acc[4 * i + 2 * hh] + b.x);
          float v1 = round_bf16(acc[4 * i + 2 * hh + 1] + b.y);
          if (p.ls1) {
            v0 = round_bf16(v0 * l.x);
            v1 = round_bf16(v1 * l.y);
          }
          uint32_t* xy = reinterpret_cast<uint32_t*>(
              X + col / S::KB * MLP_BM * S::SW + swz(wr + 8 * hh, col % S::KB * 2, S::SW));
          const float2 xv = unpack_bf16(S::XS ? *xy : yv[2 * i + hh]);
          const uint32_t y = pack_bf16(xv.x + v0, xv.y + v1);
          const float2 yf = unpack_bf16(y);
          s[hh] += yf.x + yf.y;
          if constexpr (S::XS) {
            *xy = y;
          } else {
            yv[2 * i + hh] = y;
            const int row = row0 + wr + 8 * hh;
            if (row < p.R)
              *reinterpret_cast<uint32_t*>(p.out + static_cast<size_t>(row) * C + col) = y;
          }
        }
        if (i % 4 == 3) group_fence();
      }
      // 4. z = LayerNorm 2 of y, fp32 statistics in two passes, over the
      // o rows in A (above C = 128 the first exchange of row sums is also
      // where both warpgroups are done with A)
      auto y_at = [&](int i, int hh) {
        if constexpr (S::XS) {
          const int col = cb + 8 * i + q2;
          return unpack_bf16(*reinterpret_cast<const uint32_t*>(
              X + col / S::KB * MLP_BM * S::SW + swz(wr + 8 * hh, col % S::KB * 2, S::SW)));
        } else {
          return unpack_bf16(yv[2 * i + hh]);
        }
      };
      float mean[2], inv[2];
      mlp_row_sums<C>(s, red, w, wr, q2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mean[hh] = s[hh] / C;
        s[hh] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < S::NW / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 v = y_at(i, hh);
          const float d0 = v.x - mean[hh], d1 = v.y - mean[hh];
          s[hh] += d0 * d0 + d1 * d1;
        }
      mlp_row_sums<C>(s, red + 2 * MLP_BM, w, wr, q2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / sqrtf(s[hh] / C + p.eps);
#pragma unroll
      for (int i = 0; i < S::NW / 8; ++i) {
        const int col = cb + 8 * i + q2;
        const float2 lw = opt2(p.ln_w, col), lb = opt2(p.ln_b, col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 v = y_at(i, hh);
          *reinterpret_cast<uint32_t*>(A + col / S::KB * MLP_BM * S::SW +
                                       swz(wr + 8 * hh, col % S::KB * 2, S::SW)) =
              pack_bf16((v.x - mean[hh]) * inv[hh] * lw.x + lb.x,
                        (v.y - mean[hh]) * inv[hh] * lw.y + lb.y);
        }
        if (i % 4 == 3) group_fence();
      }
    } else {
      // 1-4 in a cluster, or in the model axis's mode: this CTA's
      // columns of y into `out` (a cluster size is taken only where they
      // are a multiple of 8, wgmma's N step: mlp_cluster_ok; both
      // warpgroups' shares, or warpgroup 0's: mlp_project_cs), a barrier,
      // then LN2 of the whole rows from there
      if (p.tp) {
        mlp_residual_tp<C>(p, row0, col0, ccols, gt, gn);
      } else {
        mlp_wait(&afull[ts], n & 1);
        const int boff = S::PAIR ? 0 : w * n0 * S::SW;
        if (cs == 2)
          mlp_project_cs<C, 2>(p, A, ring, full, empty, boff, c0, row0, ccols,
                               kpt, w, wr, q2, stage, phase);
        else if (cs == 4)
          mlp_project_cs<C, 4>(p, A, ring, full, empty, boff, c0, row0, ccols,
                               kpt, w, wr, q2, stage, phase);
        else if (cs == 8)
          mlp_project_cs<C, 8>(p, A, ring, full, empty, boff, c0, row0, ccols,
                               kpt, w, wr, q2, stage, phase);
      }
      if (cs > 1) {
        cluster_arrive();
        cluster_wait();
      } else {
        named_sync(gid, gn);
      }
      mlp_ln2_from_out<C>(p, A, row0, gt / 32, gn / 32);
    }
    fence_async_smem();
    named_sync(gid, gn);

    // 5. MLP over this CTA's hidden chunks (mlp_chunk), H tiles in turn,
    // the fp32 sum in acc; the first chunk issues no GEMM2
    float hreg[S::HN / 2];
#pragma unroll
    for (int i = 0; i < S::NW / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < S::HN / 2; ++i) hreg[i] = 0.f;
    uint64_t* ae = cs == 1 && !p.tp ? &aempty[ts] : nullptr;
    uint32_t par_in, par_out;
    int s_in = claim(par_in);
    int s_out = claim(par_out);
    mlp_chunk<C, false>(p, acc, hreg, A, ring, full, empty, s_in, par_in, -1, 0,
                        nullptr, H0, j0, w, wr, q2, hsw, true,
                        j0 + 1 == j1 ? ae : nullptr);
    fence_async_smem();
    named_sync(gid, gn);
    if constexpr (!S::OVERLAP)
      mlp_issue_gemm2<C>(acc, H0, ring, full, s_out, par_out, w, hsw, true);
    for (int j = j0 + 1; j < j1; ++j) {
      const int s_prev = s_out;
      const uint32_t par_prev = par_out;
      s_in = claim(par_in);
      s_out = claim(par_out);
      unsigned char* hj = H0 + ((j - j0) & 1) * MLP_HBUF;
      mlp_chunk<C, S::OVERLAP>(p, acc, hreg, A, ring, full, empty, s_in, par_in,
                               s_prev, par_prev, H0 + ((j - 1 - j0) & 1) * MLP_HBUF,
                               hj, j, w, wr, q2, hsw, j == j0 + 1,
                               j + 1 == j1 ? ae : nullptr);
      fence_async_smem();
      named_sync(gid, gn);
      if constexpr (!S::OVERLAP)
        mlp_issue_gemm2<C>(acc, hj, ring, full, s_out, par_out, w, hsw, false);
    }
    // the last chunk's GEMM2 (issued already where not OVERLAP)
    if constexpr (S::OVERLAP)
      mlp_issue_gemm2<C>(acc, H0 + ((j1 - 1 - j0) & 1) * MLP_HBUF, ring, full,
                         s_out, par_out, w, hsw, j1 - j0 == 1);
    wgmma_wait0();
    fence_regs<S::NW / 2>(acc);
    mbar_arrive(&empty[s_out]);

    if (cs == 1) {
      // 6. alone on the tile, from the registers: the model axis's fp32
      // partial, else out = y + ls2 * (mlp + b), y from its x tile (XS)
      // or from `out`
#pragma unroll
      for (int i = 0; i < S::NW / 8; ++i) {
        const int col = cb + 8 * i + q2;
        const float2 b = opt2(p.out_b, col), l = opt2(p.ls2, col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + wr + 8 * hh;
          const size_t idx = static_cast<size_t>(row) * C + col;
          const float a0 = acc[4 * i + 2 * hh], a1 = acc[4 * i + 2 * hh + 1];
          if (p.tp) {
            if (row < p.R)
              *reinterpret_cast<float2*>(p.part + idx) = make_float2(a0, a1);
            continue;
          }
          float m0 = round_bf16(a0 + b.x);
          float m1 = round_bf16(a1 + b.y);
          if (p.ls2) {
            m0 = round_bf16(m0 * l.x);
            m1 = round_bf16(m1 * l.y);
          }
          const uint32_t yr = S::XS
              ? *reinterpret_cast<const uint32_t*>(
                    X + col / S::KB * MLP_BM * S::SW + swz(wr + 8 * hh, col % S::KB * 2, S::SW))
              : *reinterpret_cast<const uint32_t*>(
                    p.out + static_cast<size_t>(min(row, p.R - 1)) * C + col);
          const float2 yy = unpack_bf16(yr);
          if (row < p.R)
            *reinterpret_cast<uint32_t*>(p.out + idx) = pack_bf16(yy.x + m0, yy.y + m1);
        }
        if (i % 4 == 3) group_fence();
      }
      if (S::XS && !p.tp) mbar_arrive(xe);
      continue;
    }

    // 6. a cluster: every wgmma of both warpgroups is done with A and the
    // ring, which the fp32 partials [64, C] of the unit's tiles now
    // overwrite; CTA r sums its columns' partials over distributed shared
    // memory in rank order (every load of a group in flight at once)
    consumer_sync(S::NCT);
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < S::NW / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(part + (ts * MLP_BM + wr + 8 * hh) * S::LDP + cb + 8 * i + q2) =
            make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    cluster_arrive();
    cluster_wait();
    for (int tt = 0; tt < S::TPC; ++tt) {
      const int rbase = (g * S::TPC + tt) * MLP_BM;
      for (int i = tid; i < MLP_BM * ccols / 4; i += S::NCT) {
        const int r = i / (ccols / 4), col = col0 + (i % (ccols / 4)) * 4;
        const int row = rbase + r;
        if (row >= p.R) continue;
        const float* src = part + (tt * MLP_BM + r) * S::LDP + col;
        float4 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < cs) v[q] = ld_peer(src, q);
        float4 sum = v[0];
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (q < cs) {
            sum.x += v[q].x;
            sum.y += v[q].y;
            sum.z += v[q].z;
            sum.w += v[q].w;
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
    }
    // peers may still read this CTA's partials; then A is free for the
    // next unit's o rows
    cluster_arrive();
    cluster_wait();
    if (!p.tp) mbar_arrive(&aempty[ts]);
  }
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

// Hidden chunks of block_mlp_kernel: 64 units (32 of each half gated);
// an ungated inner dim may end in a half chunk (inner % 32 == 0 either
// way: `mlp_inner_ok`)
int mlp_chunks(int inner, int gated) {
  const int hc = gated ? 32 : 64;
  return (inner + hc - 1) / hc;
}
bool mlp_inner_ok(int inner) { return inner > 0 && inner % 32 == 0; }

// The cluster sizes a width takes: each CTA projects a multiple of 8
// columns (wgmma's N step; mlp_proj_boxes) and owns at least one hidden
// chunk.
bool mlp_cluster_ok(int C, int inner, int gated, int cluster) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         C % (8 * cluster) == 0 && cluster <= mlp_chunks(inner, gated);
}

// Plans and launches block_mlp_kernel<C> over a.R rows. Units of TPC row
// tiles (two at C <= 64, one above); cs CTAs (a cluster splitting the
// hidden chunks) a unit: the largest cs of 2, 4, 8 that the width takes,
// that divides the chunks evenly (3 at C = 48 give no cluster, 6 at 96
// two CTAs) and whose units the card runs in one wave (num_sms x the
// CTAs an SM holds, by the occupancy calculator); else cs = 1 and one
// wave of persistent CTAs walks the units. Splitting a grid that
// already fills the card costs more than it gains: every CTA of a
// cluster pays the unit's o load, LN2 over the whole rows and the
// cluster's barriers. `cluster` > 0 fixes cs. The plan goes to
// plan[0..3] (cs, row tiles, tiles split over a cluster, CTAs) where
// plan is not NULL.
template <int C>
cudaError_t launch_mlp(MlpArgs a, const void* o, const void* proj_w,
                       const void* in_w, const void* out_w, int cluster,
                       int num_sms, int* plan, cudaStream_t st) {
  using S = MlpShape<C>;
  auto kernel = block_mlp_kernel<C>;
  const int hc = a.gated ? 32 : 64;
  const int chunks = mlp_chunks(a.inner, a.gated);
  const long tiles = (a.R + MLP_BM - 1) / MLP_BM;
  const long units = (tiles + S::TPC - 1) / S::TPC;
  int cs = cluster > 0 ? cluster : 1;
  for (int n = 2; cluster == 0 && n <= 8; n *= 2)
    if (mlp_cluster_ok(C, a.inner, a.gated, n) && chunks % n == 0 &&
        units * n <= cluster_slots(kernel, S::THREADS, S::SMEM, n, num_sms))
      cs = n;
  const long slots = cluster_slots(kernel, S::THREADS, S::SMEM, cs, num_sms);
  const long clusters = slots / cs < units ? slots / cs : units;
  if (clusters < 1 || clusters > 65535 || units > (1l << 30))
    return cudaErrorInvalidValue;
  a.units = static_cast<int>(units);
  if (plan != nullptr) {
    plan[0] = cs;
    plan[1] = static_cast<int>(tiles);
    plan[2] = cs > 1 ? static_cast<int>(tiles) : 0;
    plan[3] = static_cast<int>(clusters * cs);
  }
  const int ccols = C / cs;
  CUtensorMap m_o = {}, m_x = {}, m_proj = {}, m_in, m_out;
  // the model axis's mode reads neither o nor the projection's weight,
  // and reads x where it makes y
  if (!a.tp && (!encode_map(&m_o, o, a.R, C, MLP_BM, S::KB) ||
                (S::XS && !encode_map(&m_x, a.x, a.R, C, MLP_BM, S::KB)) ||
                !weight_map(&m_proj, proj_w, C, C,
                            ccols / mlp_proj_boxes(ccols, S::PB), S::KB)))
    return cudaErrorInvalidValue;
  if (!weight_map(&m_in, in_w, a.gated ? 2 * a.inner : a.inner, C, hc, S::KB) ||
      !weight_map(&m_out, out_w, C, a.inner, S::NW, hc))
    return cudaErrorInvalidValue;
  return launch(kernel, dim3(cs, static_cast<unsigned>(clusters)), S::THREADS,
                S::SMEM, cs, st, m_o, m_x, m_proj, m_in, m_out, a);
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

// C in {32, 48, 64, 96, 128, 192, 256, 384, 512}. `cluster` > 0 fixes
// how many CTAs share each unit of row tiles (1, 2, 4 or 8); 0 lets the
// plan choose. `plan` (NULL or four ints) receives the cluster size, the
// row tiles, the tiles a cluster split and the CTAs the launch took.
extern "C" int leod_block_mlp(const void* x, const void* o, void* out,
                              const void* proj_w, const void* proj_b,
                              const void* ls1, const void* ln_w,
                              const void* ln_b, const void* in_w,
                              const void* in_b, const void* out_w,
                              const void* out_b, const void* ls2, int R,
                              int C, int inner, int gated, int act, float eps,
                              int cluster, int num_sms, int* plan,
                              void* stream) {
  if (R < 1 || !mlp_inner_ok(inner) || ln_w == nullptr ||
      ln_b == nullptr ||
      (cluster != 0 && !mlp_cluster_ok(C, inner, gated, cluster)))
    return cudaErrorInvalidValue;
  MlpArgs a = {};
  a.x = static_cast<const bf16*>(x);
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
    case 32: return launch_mlp<32>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 48: return launch_mlp<48>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 64: return launch_mlp<64>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 96: return launch_mlp<96>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 128: return launch_mlp<128>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 192: return launch_mlp<192>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 256: return launch_mlp<256>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 384: return launch_mlp<384>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    case 512: return launch_mlp<512>(a, o, proj_w, in_w, out_w, cluster, num_sms, plan, st);
    default: return cudaErrorInvalidValue;
  }
}

// The model axis's mode of block_mlp_kernel: from x and the
// out-projection summed over the model group a (fp32 [R, C], no bias),
// x1 = x + ls1 (a + proj_b) into x1 and this rank's fp32 partial MLP
// output (its `inner` units, no bias) into part. C, `cluster` and
// `plan` as leod_block_mlp's.
extern "C" int leod_block_mlp_tp(const void* x, const void* a, void* x1,
                                 void* part, const void* proj_b,
                                 const void* ls1, const void* ln_w,
                                 const void* ln_b, const void* in_w,
                                 const void* in_b, const void* out_w, int R,
                                 int C, int inner, int gated, int act,
                                 float eps, int cluster, int num_sms,
                                 int* plan, void* stream) {
  if (R < 1 || !mlp_inner_ok(inner) || ln_w == nullptr ||
      ln_b == nullptr || a == nullptr || part == nullptr ||
      (cluster != 0 && !mlp_cluster_ok(C, inner, gated, cluster)))
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
    case 32: return launch_mlp<32>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 48: return launch_mlp<48>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 64: return launch_mlp<64>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 96: return launch_mlp<96>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 128: return launch_mlp<128>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 192: return launch_mlp<192>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 256: return launch_mlp<256>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 384: return launch_mlp<384>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
    case 512: return launch_mlp<512>(m, nullptr, nullptr, in_w, out_w, cluster, num_sms, plan, st);
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
