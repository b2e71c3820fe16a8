// Greedy NMS keep mask for Hopper: a parallel mask build, then one
// sweep warp per image that resolves 32 boxes at a time.
//
// Replaces the Pallas TPU kernel `nms_mask_pallas`
// (leod_tpu/ops/nms_pallas.py:65, body `_nms_kernel` :27). Input: per
// image K <= 1024 boxes (xyxy, fp32) already sorted by score descending,
// a valid mask and optional class ids. Output: keep[K].
//
// Design. The Pallas kernel builds a K x K IoU matrix in VMEM and then
// runs K sequential steps over it. Here:
//   1. nms_build_kernel builds the suppression bitmask in device memory:
//      bit j of row i is set when j > i, the classes match, and
//      IoU(i, j) > thr. At K = 1000 that is 32 uint32 words a row. Its
//      unit of work is a task, one (row tile, word) pair: 32 rows by the
//      32 columns of one mask word, and a warp runs it. Lane l owns
//      column 32 b + l, its box in registers; the warp walks the tile's
//      32 rows, whose boxes it staged in shared memory (one broadcast
//      read a row, no bank conflict), and the 32 tests of a row run at
//      once, one a lane, `__ballot_sync` forming the word. Only the
//      tasks on or above the diagonal (word >= row tile) exist, K/32
//      (K/32 + 1) / 2 an image (528 at K = 1000, 4 warps a CTA: 132 CTAs
//      an image, every SM of an H100 at B = 1). Words below the diagonal
//      are never written, and the sweep never uses them.
//   2. nms_sweep_kernel, a warp an image, walks the row tiles in order.
//      At launch the image's mask goes to shared memory in whole row
//      tiles by at most 6 bulk copies of doubling length (tile 0, tiles
//      1-2, 3-6, ...), each completing on its own mbarrier: the sweep
//      starts once tile 0 (4 KB at K = 1000) has landed, while later
//      tiles are still landing, and waits once a copy. (Whole tiles carry
//      the words below the diagonal, unwritten and never read; copying
//      only the upper triangle took a copy a row, 1000 an image, and ran
//      slower. A row is 32 words in memory, so that a tile is whole
//      16-byte units.) Lane v keeps word v of the keep bitmap in a
//      register and reads the rows of a tile at word v into 32 more, a
//      tile ahead, only on or above the diagonal. At tile t, lane t holds
//      the tile's 32 diagonal words and resolves its 32 boxes by the
//      greedy in registers, box q clearing its row from the word when its
//      bit is still set; one shuffle broadcasts the kept word, and every
//      lane clears the OR of the kept boxes' rows from its own word. The
//      dependent chain is ceil(K/32) such word steps instead of K
//      shuffle-and-load steps. `valid` is read and `keep` written a byte
//      a lane, 32 boxes a warp instruction.
// Class ids are compared exactly, as the default `nms_mask`
// (leod_tpu/ops/nms.py:45-46) does, instead of the coordinate-offset
// trick that quantizes coordinates. Areas are `pairwise_iou`'s (not
// clamped at 0, unlike the Pallas kernel); the two agree for decoded
// boxes, whose w and h are exp(.)*stride > 0. Every product, sum and the
// division use the _rn intrinsics so nvcc cannot contract them into
// FMAs: the keep mask then matches the plain PyTorch version bit for bit.
//
// Bound on the H100: the work is K(K-1)/2 IoU tests an image (about 13
// fp32 operations each) plus a K-box sequential sweep; at K = 1000 that
// is a few MFLOP and about 20 KB of inputs an image, so neither the
// fp32 rate nor the memory rate bounds it. The build issues about 30
// instructions a test (the division alone about 10), 4 M tests at
// B = 8: a few microseconds of the SMs' instruction slots. The sweep
// needs the 66 KB of mask words on and above the diagonal an image; its
// time is its dependent chain, 32 word steps at K = 1000 (in each, 31
// bit steps of three dependent operations, a shuffle and an OR of up to
// 32 rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;        // one warp sweeps <= 32 words a row
constexpr int kRowWords = 32;      // a mask row in memory: 128 bytes, whole
                                   // 16-byte units for the bulk copies
constexpr int kBuildWarps = 4;     // build tasks (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr in the exact operation order of ops/boxes.py
// pairwise_iou: strict tl < br overlap, union floored at 1e-16. Where the
// boxes do not overlap, inter is +0 and the quotient +0 (the floored
// union is positive), so the division, whose zero dividend would send it
// down its slow path, is skipped: the same bit for every input.
__device__ __forceinline__ bool iou_exceeds(float4 a, float area_a, float4 b,
                                            float area_b, float thr) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  if (!(tlx < brx && tly < bry)) return 0.f > thr;
  const float inter = __fmul_rn(__fsub_rn(brx, tlx), __fsub_rn(bry, tly));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-16f)) > thr;
}

// Row tile a and word b of an image's task t: tasks are numbered row
// tile by row tile, words - a of them in row tile a (b = a .. words - 1).
__device__ __forceinline__ void build_task(int t, int words, int& a, int& b) {
  a = 0;
  while (t >= words - a) {
    t -= words - a;
    ++a;
  }
  b = a + t;
}

// grid (ceil(tasks / kBuildWarps), B), a warp a task of image blockIdx.y.
__global__ void __launch_bounds__(kBuildWarps * 32) nms_build_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ cls,
    float thr, int K, int words, uint32_t* __restrict__ mask) {
  __shared__ float4 rbox[kBuildWarps][32];      // the tile's row boxes
  __shared__ float2 rac[kBuildWarps][32];       // their (area, class)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * kBuildWarps + warp;
  if (t >= words * (words + 1) / 2) return;     // a whole warp leaves
  int a, b;
  build_task(t, words, a, b);
  const float4* bimg = boxes + static_cast<size_t>(blockIdx.y) * K;
  const float* cimg = cls ? cls + static_cast<size_t>(blockIdx.y) * K : nullptr;
  // row i = 32 a + lane into the warp's slice; column j = 32 b + lane
  // into this lane's registers (zeros past K, never stored or set)
  const int i = 32 * a + lane, j = 32 * b + lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bi = i < K ? bimg[i] : zero;
  rbox[warp][lane] = bi;
  rac[warp][lane] = make_float2(area_of(bi), i < K && cimg ? cimg[i] : 0.f);
  __syncwarp();
  const bool jin = j < K;
  const float4 bj = jin ? bimg[j] : zero;
  const float aj = area_of(bj), cj = jin && cimg ? cimg[j] : 0.f;

  uint32_t mine = 0u;                           // the word of row 32 a + lane
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const float4 br = rbox[warp][r];
    const float2 ac = rac[warp][r];              // (area, class) of row r
    const bool hit = jin && ac.y == cj && iou_exceeds(br, ac.x, bj, aj, thr);
    const uint32_t word = __ballot_sync(0xffffffffu, hit);
    if (lane == r) mine = word;
  }
  if (a == b) mine &= lane == 31 ? 0u : ~0u << (lane + 1);   // only j > i
  if (i < K)
    mask[(static_cast<size_t>(blockIdx.y) * K + i) * kRowWords + b] = mine;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool landed_now(uint32_t bar) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar) : "memory");
  return done;
}

// Waits for the phase of parity 0 of the mbarrier at `bar`, at the cost
// of one test where it has completed. A wait of more than about 10 s
// (2^34 cycles) can only be a fault of the kernel: it traps, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void wait_landed(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  if (landed_now(addr)) return;
  const long long start = clock64();
  while (!landed_now(addr))
    if (clock64() - start > (1ll << 34)) __trap();
}

// Row tile t (rows 32 t .. 32 t + 31 of the image's mask) from shared
// memory at word `lane`, into r: zero for a row past K
// and for a word past the row or below the diagonal (lane < t), which
// the build does not write. Tile t is the first of its copy when t + 1
// is a power of two, and then waits for it to land.
__device__ __forceinline__ void read_tile(const uint32_t* tiles,
                                          uint64_t* landed, int t, int K,
                                          int words, int lane,
                                          uint32_t (&r)[32]) {
  if (t < words && ((t + 1) & t) == 0) wait_landed(&landed[31 - __clz(t + 1)]);
  const bool on = lane >= t && lane < words;
  const uint32_t* p = tiles + 32 * t * kRowWords + lane;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    r[q] = on && 32 * t + q < K ? p[q * kRowWords] : 0u;
}

// The greedy over one word's 32 boxes: kw is the word's keep bits after
// every earlier word, d[q] the word of box q's own row (the later boxes
// of the word that q suppresses, all above bit q). Box 31 suppresses
// none in its word. A step compiles to three dependent operations (bit
// test, select, AND).
__device__ __forceinline__ uint32_t resolve_word(uint32_t kw,
                                                 const uint32_t (&d)[32]) {
#pragma unroll
  for (int q = 0; q < 31; ++q)
    if ((kw >> q) & 1u) kw &= ~d[q];
  return kw;
}

// The OR of the rows r[q] of the boxes q kept: a predicated OR a box into
// eight independent accumulators, then a tree
__device__ __forceinline__ uint32_t kept_rows(uint32_t kept,
                                              const uint32_t (&r)[32]) {
  uint32_t a[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if ((kept >> q) & 1u) a[q % 8] |= r[q];
  return ((a[0] | a[1]) | (a[2] | a[3])) | ((a[4] | a[5]) | (a[6] | a[7]));
}

// One step of the sweep's chain, row tile t: lane t resolves its word
// from the diagonal words it holds, and every lane clears the kept
// boxes' rows from its keep word (lane t's then equals the kept word;
// below the diagonal r is zero and nothing changes).
__device__ __forceinline__ uint32_t sweep_tile(uint32_t kw,
                                               const uint32_t (&r)[32],
                                               int t) {
  const uint32_t kept = __shfl_sync(kFull, resolve_word(kw, r), t);
  return kw & ~kept_rows(kept, r);
}

// grid B, one warp an image (the compile-time row stride makes every
// shared-memory read an immediate offset). Image blockIdx.x's mask goes
// to shared memory in whole row tiles by at most 6 bulk copies of
// doubling length, lane g's copy holding tiles 2^g - 1 .. 2^(g+1) - 2
// and completing on mbarrier g: the first lands after 4 KB, and each
// lands before the sweep, reading a tile ahead, reaches it.
__global__ void __launch_bounds__(32) nms_sweep_kernel(
    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid,
    int K, int words, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) uint32_t tiles[];   // [K][kRowWords]
  __shared__ __align__(8) uint64_t landed[6];          // a barrier a copy
  const int img = blockIdx.x, lane = threadIdx.x;
  const uint32_t* m = mask + static_cast<size_t>(img) * K * kRowWords;
  const int row0 = lane < 6 ? 32 * ((1 << lane) - 1) : K;   // lane g's copy
  const bool copies = row0 < K;
  if (copies)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&landed[lane])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();
  if (copies) {
    const uint32_t bytes = (min(2 * row0 + 32, K) - row0) * kRowWords * 4;
    const uint32_t bar = smem_u32(&landed[lane]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(tiles + row0 * kRowWords)),
        "l"(reinterpret_cast<uint64_t>(m + row0 * kRowWords)), "r"(bytes),
        "r"(bar) : "memory");
  }

  // keep word v = valid[32 v .. 32 v + 31], a warp-wide byte load a word
  const uint8_t* vimg = valid + static_cast<size_t>(img) * K;
  uint8_t vb[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const int j = 32 * s + lane;
    vb[s] = j < K ? vimg[j] : 0;
  }
  uint32_t kw = 0u;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const uint32_t w = __ballot_sync(kFull, vb[s] != 0);
    if (lane == s) kw = w;
  }

  uint32_t r0[32], r1[32];
  read_tile(tiles, landed, 0, K, words, lane, r0);
  for (int t = 0; t < words; t += 2) {
    read_tile(tiles, landed, t + 1, K, words, lane, r1);
    kw = sweep_tile(kw, r0, t);
    if (t + 1 == words) break;
    read_tile(tiles, landed, t + 2, K, words, lane, r0);
    kw = sweep_tile(kw, r1, t + 1);
  }

  uint8_t* kimg = keep + static_cast<size_t>(img) * K;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const uint32_t w = __shfl_sync(kFull, kw, s);
    const int j = 32 * s + lane;
    if (j < K) kimg[j] = static_cast<uint8_t>((w >> lane) & 1u);
  }
}

}  // namespace

// boxes [B, K, 4] f32 (16-byte aligned), valid [B, K] uint8, cls [B, K]
// f32 or NULL (class-agnostic), mask [B, K, 32] uint32 scratch, 16-byte
// aligned (a row's ceil(K/32) words on or above the diagonal written and
// read), keep [B, K] uint8. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int leod_nms_mask(const void* boxes, const void* valid,
                             const void* cls, float thr, int B, int K,
                             void* mask, void* keep, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(boxes) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16)
    return cudaErrorInvalidValue;
  const int words = (K + 31) / 32;
  const int tasks = words * (words + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((tasks + kBuildWarps - 1) / kBuildWarps, B);
  nms_build_kernel<<<grid, kBuildWarps * 32, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(cls), thr,
      K, words, static_cast<uint32_t*>(mask));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the sweep's shared memory holds an image's mask: its ceiling is set
  // once a device
  static bool smem_set[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!smem_set[dev % 64]) {
    e = cudaFuncSetAttribute(nms_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxK * kRowWords * 4);
    if (e != cudaSuccess) return e;
    smem_set[dev % 64] = true;
  }
  nms_sweep_kernel<<<B, 32, static_cast<size_t>(K) * kRowWords * 4, st>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint8_t*>(valid),
      K, words, static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
