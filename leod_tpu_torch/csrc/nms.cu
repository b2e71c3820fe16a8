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
//   1. nms_build_kernel, one CTA per 32 rows of one image, builds the
//      suppression bitmask in device memory: bit j of row i is set when
//      j > i, the classes match, and IoU(i, j) > thr. At K = 1000 that
//      is 32 uint32 words a row, 128 KB an image, spread over 32 CTAs
//      an image (the IoU tests are the work; one CTA an image left 131
//      of 132 SMs idle at B = 1). Words wholly at or below the diagonal
//      are written as 0 without a test.
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
// fp32 rate nor the memory rate bounds it: its time is the sweep's
// dependent chain of K shuffles and shared-memory reads, and the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;        // one warp sweeps <= 32 words a row
constexpr int kRows = 32;          // mask rows per build CTA
constexpr int kBuildThreads = 256;
constexpr int kSweepThreads = 256;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr in the exact operation order of ops/boxes.py
// pairwise_iou: strict tl < br overlap, union floored at 1e-16
__device__ __forceinline__ bool iou_exceeds(float4 a, float area_a, float4 b,
                                            float area_b, float thr) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  const float inter = (tlx < brx && tly < bry)
                          ? __fmul_rn(__fsub_rn(brx, tlx), __fsub_rn(bry, tly))
                          : 0.f;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-16f)) > thr;
}

// grid (ceil(K / kRows), B): rows r0 .. r0 + kRows of image blockIdx.y.
// Only boxes r0 .. K can appear in these rows, so only they are staged.
__global__ void __launch_bounds__(kBuildThreads) nms_build_kernel(
    const float* __restrict__ boxes, const float* __restrict__ cls, float thr,
    int K, int words, uint32_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.y, r0 = blockIdx.x * kRows, n = K - r0;
  float4* bx = reinterpret_cast<float4*>(smem);                // [n]
  float* area = reinterpret_cast<float*>(bx + n);              // [n]
  float* cl = area + n;                                        // [n]
  const float* b = boxes + (static_cast<size_t>(img) * K + r0) * 4;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float4 v = make_float4(b[4 * t], b[4 * t + 1], b[4 * t + 2], b[4 * t + 3]);
    bx[t] = v;
    area[t] = area_of(v);
    cl[t] = cls ? cls[static_cast<size_t>(img) * K + r0 + t] : 0.f;
  }
  __syncthreads();

  uint32_t* out = mask + (static_cast<size_t>(img) * K + r0) * words;
  const int rows = n < kRows ? n : kRows;
  for (int idx = threadIdx.x; idx < rows * words; idx += blockDim.x) {
    const int r = idx / words, w = idx % words;    // row i = r0 + r
    uint32_t bits = 0u;
    if (w * 32 + 31 > r0 + r) {
      const float4 bi = bx[r];
      const float ai = area[r], ci = cl[r];
      for (int s = 0; s < 32; ++s) {
        const int t = w * 32 + s - r0;               // column j = r0 + t
        if (t > r && t < n && cl[t] == ci &&
            iou_exceeds(bi, ai, bx[t], area[t], thr))
          bits |= 1u << s;
      }
    }
    out[idx] = bits;
  }
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

// boxes [B, K, 4] f32, valid [B, K] uint8, cls [B, K] f32 or NULL
// (class-agnostic), mask [B, K, ceil(K/32)] uint32 scratch, keep [B, K]
// uint8. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int leod_nms_mask(const void* boxes, const void* valid,
                             const void* cls, float thr, int B, int K,
                             void* mask, void* keep, void* stream) {
  if (K < 1 || K > kMaxK || B < 1) return cudaErrorInvalidValue;
  const int words = (K + 31) / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t build_smem = static_cast<size_t>(K) * (16 + 4 + 4);
  nms_build_kernel<<<dim3((K + kRows - 1) / kRows, B), kBuildThreads,
                     build_smem, st>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(cls), thr,
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
