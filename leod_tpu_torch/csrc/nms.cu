// Greedy NMS keep mask for Hopper: a parallel mask build, then one
// sweep CTA per image.
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
//      IoU(i, j) > thr. At K = 1000 that is 32 uint32 words a row, 128 KB
//      an image. Its unit of work is a task, one (row tile, word) pair:
//      32 rows by the 32 columns of one mask word, and a warp runs it.
//      Lane l owns column 32 b + l, its box in registers; the warp walks
//      the tile's 32 rows, whose boxes it staged in shared memory (one
//      broadcast read a row, no bank conflict), and the 32 tests of a
//      row run at once, one a lane, `__ballot_sync` forming the word.
//      Only the tasks on or above the diagonal (word >= row tile) exist,
//      K/32 (K/32 + 1) / 2 an image (528 at K = 1000, 4 warps a CTA:
//      132 CTAs an image, every SM of an H100 at B = 1); each task above
//      the diagonal also writes its mirror below it, row tile b's word a,
//      as zeros, which the sweep reads.
//   2. nms_sweep_kernel, one CTA per image, stages the image's mask in
//      shared memory (128 KB fits), then one warp sweeps it: lane w keeps
//      word w of the keep bitmap in a register, box i's bit is broadcast
//      with a shuffle, and a kept box clears its row's bits from every
//      word at once.
// Class ids are compared exactly, as the default `nms_mask`
// (leod_tpu/ops/nms.py:45-46) does, instead of the coordinate-offset
// trick that quantizes coordinates. Areas are `pairwise_iou`'s (not
// clamped at 0, unlike the Pallas kernel); the two agree for decoded
// boxes, whose w and h are exp(.)*stride > 0. Every product, sum and the
// division use the _rn intrinsics so nvcc cannot contract them into
// FMAs: the keep mask then matches the plain PyTorch version bit for bit.
//
// Bound on the H100: the work is K(K-1)/2 IoU tests an image (about 13
// fp32 operations each) plus a K-step sequential sweep; at K = 1000 that
// is a few MFLOP and about 20 KB of inputs an image, so neither the
// fp32 rate nor the memory rate bounds it. The build issues about 30
// instructions a test (the division alone about 10), 4 M tests at
// B = 8: a few microseconds of the SMs' issue slots. The sweep's time is
// its dependent chain of K shuffles and shared-memory reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;        // one warp sweeps <= 32 words a row
constexpr int kBuildWarps = 4;     // build tasks (warps) a CTA
constexpr int kSweepThreads = 256;

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
  if (i < K) mask[(static_cast<size_t>(blockIdx.y) * K + i) * words + b] = mine;
  // the mirror below the diagonal: rows 32 b + lane, word a, all zero
  if (b > a && j < K)
    mask[(static_cast<size_t>(blockIdx.y) * K + j) * words + a] = 0u;
}

// grid B: stage image blockIdx.x's [K][words] mask, then one warp sweeps
__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid,
    int K, int words, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t sm[];                             // [K][words]
  const int img = blockIdx.x;
  const uint32_t* m = mask + static_cast<size_t>(img) * K * words;
  for (int i = threadIdx.x; i < K * words; i += blockDim.x) sm[i] = m[i];
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const uint8_t* vimg = valid + static_cast<size_t>(img) * K;
  uint32_t kw = 0u;
  for (int s = 0; s < 32; ++s) {
    const int j = lane * 32 + s;
    if (j < K && vimg[j]) kw |= 1u << s;
  }
  for (int i = 0; i < K; ++i) {
    const uint32_t owner = __shfl_sync(0xffffffffu, kw, i >> 5);
    if (((owner >> (i & 31)) & 1u) && lane < words) kw &= ~sm[i * words + lane];
  }
  uint8_t* kimg = keep + static_cast<size_t>(img) * K;
  for (int s = 0; s < 32; ++s) {
    const int j = lane * 32 + s;
    if (j < K) kimg[j] = static_cast<uint8_t>((kw >> s) & 1u);
  }
}

}  // namespace

// boxes [B, K, 4] f32 (16-byte aligned), valid [B, K] uint8, cls [B, K]
// f32 or NULL (class-agnostic), mask [B, K, ceil(K/32)] uint32 scratch,
// keep [B, K] uint8. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int leod_nms_mask(const void* boxes, const void* valid,
                             const void* cls, float thr, int B, int K,
                             void* mask, void* keep, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(boxes) % 16)
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
  const size_t sweep_smem = static_cast<size_t>(K) * words * 4;
  e = cudaFuncSetAttribute(nms_sweep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sweep_smem));
  if (e != cudaSuccess) return e;
  nms_sweep_kernel<<<B, kSweepThreads, sweep_smem, st>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint8_t*>(valid),
      K, words, static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
