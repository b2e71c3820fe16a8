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
//   block_mlp_kernel  per-token, 32 rows of B*H*W per CTA: the output
//       projection, LayerScale, residual, LayerNorm 2, the MLP with the
//       hidden dim 4C walked in chunks (the [32, C] fp32 accumulator
//       stays in registers, NF fragments a warp, templated on C so that
//       the narrow stages keep registers free for occupancy), LayerScale,
//       residual. Where B*H*W gives too few row tiles to fill the card
//       (stages 3-4, or any stage at small B), gridDim.y CTAs split the
//       hidden chunks of a row tile, each redoing the projection and
//       LN2, and write fp32 partial sums; mlp_combine_kernel adds them
//       and applies the bias, LayerScale and residual.
//   lstm_update_kernel  a tiled GEMM over rows B*H*W with K = 2C read
//       from the two pointers x and h (no concat); one CTA owns channels
//       j..j+15 of all four gates, so the gate epilogue writes h' and c'
//       in one pass.
//
// Bound on the H100: at the RVT-B Gen1 shapes the blocks do about
// 2*T*C*(3C + 2T) + 2*C*C + 16*C*C flops per token against 4*C bytes of
// activations in and out, i.e. hundreds of flops per byte, so they are
// bound by tensor-core operations (989 TFLOP/s bf16). This first version
// uses warp-level WMMA (mma.sync, bf16 in, fp32 accumulate) with the
// weight tiles read straight from L2, not TMA + wgmma, and is far from
// that bound; making it fast is later work. Rounding points follow the
// Pallas kernel: fp32 accumulate, bias added in fp32, one rounding to the
// working dtype after each dense layer, LayerNorm and softmax in fp32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int DH = 32;            // dim_head
constexpr int QKV_H = 3 * DH;      // one head's packed q|k|v columns
constexpr int LD_QKV = QKV_H + 4;  // fp32 row stride of the q|k|v tile
constexpr int ATTN_THREADS = 256;

constexpr int MLP_BM = 32;         // token rows per CTA
constexpr int MLP_WARPS = 8;
constexpr int MLP_MAXF = 8;        // accumulator tiles per warp (C <= 512)
constexpr int MLP_MIN_CHUNKS = 4;  // hidden chunks per split at least
constexpr int LD_HF = 64 + 4;      // fp32 hidden-chunk row stride
constexpr int LD_HB = 64 + 8;      // bf16 hidden-chunk row stride

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

__host__ __device__ inline size_t mlp_smem(int C, size_t off[5]) {
  const size_t sz[5] = {
      static_cast<size_t>(MLP_BM) * (C + 8) * 2,   // A: attention rows, then LN2
      static_cast<size_t>(MLP_BM) * (C + 8) * 2,   // Y: block input + attention
      static_cast<size_t>(MLP_BM) * (C + 4) * 4,   // F: fp32 [BM][C] staging
      static_cast<size_t>(MLP_BM) * LD_HF * 4,     // Hf: fp32 hidden chunk
      static_cast<size_t>(MLP_BM) * LD_HB * 2};    // Hb: bf16 hidden chunk
  size_t s = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = s;
    s = align128(s + sz[i]);
  }
  return s;
}

// gridDim.y > 1 splits the hidden chunks: split s writes its partial
// MLP sums to part[s] and split 0 the block input + attention to y_ws;
// mlp_combine_kernel finishes. NF >= ceil(2 * C / 16 / MLP_WARPS).
template <int NF>
__global__ void __launch_bounds__(MLP_WARPS * 32) block_mlp_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o,
    bf16* __restrict__ out, const bf16* __restrict__ proj_w,
    const bf16* __restrict__ proj_b, const bf16* __restrict__ ls1,
    const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
    const bf16* __restrict__ in_w, const bf16* __restrict__ in_b,
    const bf16* __restrict__ out_w, const bf16* __restrict__ out_b,
    const bf16* __restrict__ ls2, float* __restrict__ part,
    bf16* __restrict__ y_ws, int R, int C, int inner, int gated, int act,
    float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off[5];
  mlp_smem(C, off);
  bf16* A = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* Y = reinterpret_cast<bf16*>(smem + off[1]);
  float* F = reinterpret_cast<float*>(smem + off[2]);
  float* Hf = reinterpret_cast<float*>(smem + off[3]);
  bf16* Hb = reinterpret_cast<bf16*>(smem + off[4]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * MLP_BM;
  const int lda = C + 8, ldf = C + 4, nt = C / 16;

  // 1. attention output rows, 16 bytes a thread (zero past R)
  const int vec = C / 8;
  for (int i = threadIdx.x; i < MLP_BM * vec; i += blockDim.x) {
    const int r = i / vec, v = i % vec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < R)
      val = reinterpret_cast<const uint4*>(o + static_cast<size_t>(row0 + r) * C)[v];
    *reinterpret_cast<uint4*>(A + r * lda + v * 8) = val;
  }
  __syncthreads();

  // 2. output projection, fp32 accumulate
  for (int tile = warp; tile < 2 * nt; tile += MLP_WARPS) {
    const int mi = tile / nt, ni = tile % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragA a;
      FragBt bw;
      wmma::load_matrix_sync(a, A + mi * 16 * lda + k0, lda);
      wmma::load_matrix_sync(bw, proj_w + static_cast<size_t>(ni * 16) * C + k0, C);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(F + mi * 16 * ldf + ni * 16, acc, ldf,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 3. y = x + ls1 * (proj + b), each step rounded as in the plain path
  for (int i = threadIdx.x; i < MLP_BM * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    float y = 0.f;
    if (row0 + r < R) {
      float p = round_bf16(F[r * ldf + c] + opt(proj_b, c));
      if (ls1) p = round_bf16(p * f32(ls1[c]));
      y = f32(x[static_cast<size_t>(row0 + r) * C + c]) + p;
    }
    Y[r * lda + c] = __float2bfloat16(y);
  }
  __syncthreads();

  // 4. LayerNorm 2 into A
  for (int r = warp; r < MLP_BM; r += MLP_WARPS)
    layernorm_row(Y + r * lda, A + r * lda, ln_w, ln_b, C, eps, lane);
  __syncthreads();

  // 5. MLP over this split's hidden chunks: 8 warps compute one 32 x 64
  // chunk of act(z W_in + b) (gated: 32 columns of each half), then add
  // its product with W_out into the [32, C] accumulators in registers
  const int hc = gated ? 32 : 64;
  const int nchunks = inner / hc;
  const int splits = gridDim.y, split = blockIdx.y;
  const int j0 = split * nchunks / splits;
  const int j1 = (split + 1) * nchunks / splits;
  const int ot = 2 * nt;
  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j = j0; j < j1; ++j) {
    {
      const int mi = warp / 4, q = warp % 4;
      const int col = gated ? (q / 2) * inner + j * 32 + (q % 2) * 16
                            : j * 64 + q * 16;
      FragC h;
      wmma::fill_fragment(h, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        FragBt bw;
        wmma::load_matrix_sync(a, A + mi * 16 * lda + k0, lda);
        wmma::load_matrix_sync(bw, in_w + static_cast<size_t>(col) * C + k0, C);
        wmma::mma_sync(h, a, bw, h);
      }
      wmma::store_matrix_sync(Hf + mi * 16 * LD_HF + q * 16, h, LD_HF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    if (gated) {
      for (int i = threadIdx.x; i < MLP_BM * 32; i += blockDim.x) {
        const int r = i / 32, c = i % 32;
        const float a = Hf[r * LD_HF + c] + opt(in_b, j * 32 + c);
        const float g = Hf[r * LD_HF + 32 + c] + opt(in_b, inner + j * 32 + c);
        Hb[r * LD_HB + c] = __float2bfloat16(a * activate(g, act));
      }
    } else {
      for (int i = threadIdx.x; i < MLP_BM * 64; i += blockDim.x) {
        const int r = i / 64, c = i % 64;
        Hb[r * LD_HB + c] = __float2bfloat16(
            activate(Hf[r * LD_HF + c] + opt(in_b, j * 64 + c), act));
      }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int tile = warp + f * MLP_WARPS;
      if (tile < ot) {
        const int mi = tile / nt, ni = tile % nt;
        for (int k0 = 0; k0 < hc; k0 += 16) {
          FragA a;
          FragBt bw;
          wmma::load_matrix_sync(a, Hb + mi * 16 * LD_HB + k0, LD_HB);
          wmma::load_matrix_sync(
              bw, out_w + static_cast<size_t>(ni * 16) * inner + j * hc + k0,
              inner);
          wmma::mma_sync(acc[f], a, bw, acc[f]);
        }
      }
    }
  }

  // 6. out = y + ls2 * (mlp + b), or this split's partial sums
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int tile = warp + f * MLP_WARPS;
    if (tile < ot) {
      const int mi = tile / nt, ni = tile % nt;
      wmma::store_matrix_sync(F + mi * 16 * ldf + ni * 16, acc[f], ldf,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MLP_BM * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    if (row0 + r >= R) continue;
    const size_t idx = static_cast<size_t>(row0 + r) * C + c;
    if (splits > 1) {
      part[static_cast<size_t>(split) * R * C + idx] = F[r * ldf + c];
      if (split == 0) y_ws[idx] = Y[r * lda + c];
      continue;
    }
    float m = round_bf16(F[r * ldf + c] + opt(out_b, c));
    if (ls2) m = round_bf16(m * f32(ls2[c]));
    out[idx] = __float2bfloat16(f32(Y[r * lda + c]) + m);
  }
}

// out = y + ls2 * (sum of the splits' partial MLP sums + b), elementwise
__global__ void __launch_bounds__(256) mlp_combine_kernel(
    const float* __restrict__ part, const bf16* __restrict__ y,
    const bf16* __restrict__ out_b, const bf16* __restrict__ ls2,
    bf16* __restrict__ out, int R, int C, int splits) {
  const size_t n = static_cast<size_t>(R) * C;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * n + i];
    float m = round_bf16(sum + opt(out_b, c));
    if (ls2) m = round_bf16(m * f32(ls2[c]));
    out[i] = __float2bfloat16(f32(y[i]) + m);
  }
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

// How many CTAs share a row tile's hidden chunks: enough CTAs for two
// waves over the card's SMs, but at least MLP_MIN_CHUNKS chunks each,
// since every split redoes the projection and LN2. The wrapper sizes the
// scratch of leod_block_mlp by it.
extern "C" int leod_block_mlp_splits(int R, int inner, int gated,
                                     int num_sms) {
  if (R < 1) return 1;
  const int tiles = (R + MLP_BM - 1) / MLP_BM;
  const int most = inner / (gated ? 32 : 64) / MLP_MIN_CHUNKS;
  const int want = (2 * num_sms + tiles - 1) / tiles;
  return want < most ? want : (most > 1 ? most : 1);
}

template <int NF>
cudaError_t launch_mlp(dim3 grid, size_t smem, cudaStream_t st,
                       const void* x, const void* o, void* out,
                       const void* proj_w, const void* proj_b,
                       const void* ls1, const void* ln_w, const void* ln_b,
                       const void* in_w, const void* in_b, const void* out_w,
                       const void* out_b, const void* ls2, void* part,
                       void* y_ws, int R, int C, int inner, int gated,
                       int act, float eps) {
  cudaError_t e = set_smem(block_mlp_kernel<NF>, smem);
  if (e != cudaSuccess) return e;
  block_mlp_kernel<NF><<<grid, MLP_WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o),
      static_cast<bf16*>(out), static_cast<const bf16*>(proj_w),
      static_cast<const bf16*>(proj_b), static_cast<const bf16*>(ls1),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(in_w), static_cast<const bf16*>(in_b),
      static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b),
      static_cast<const bf16*>(ls2), static_cast<float*>(part),
      static_cast<bf16*>(y_ws), R, C, inner, gated, act, eps);
  return cudaGetLastError();
}

// splits > 1 needs part [splits, R, C] fp32 and y_ws [R, C] bf16 scratch
extern "C" int leod_block_mlp(const void* x, const void* o, void* out,
                              const void* proj_w, const void* proj_b,
                              const void* ls1, const void* ln_w,
                              const void* ln_b, const void* in_w,
                              const void* in_b, const void* out_w,
                              const void* out_b, const void* ls2, void* part,
                              void* y_ws, int R, int C, int inner, int gated,
                              int act, float eps, int splits, void* stream) {
  const int tiles = 2 * (C / 16);   // 16 x 16 output tiles of a 32-row CTA
  if (C % 16 || tiles > MLP_MAXF * MLP_WARPS || inner % (gated ? 32 : 64) ||
      splits < 1 || splits > inner / (gated ? 32 : 64) ||
      (splits > 1 && (part == nullptr || y_ws == nullptr)))
    return cudaErrorInvalidValue;
  size_t off[5];
  const size_t smem = mlp_smem(C, off);
  const dim3 grid((R + MLP_BM - 1) / MLP_BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nf = (tiles + MLP_WARPS - 1) / MLP_WARPS;
  cudaError_t e;
#define LEOD_MLP(NF)                                                         \
  launch_mlp<NF>(grid, smem, st, x, o, out, proj_w, proj_b, ls1, ln_w, ln_b, \
                 in_w, in_b, out_w, out_b, ls2, part, y_ws, R, C, inner,     \
                 gated, act, eps)
  if (nf <= 1) e = LEOD_MLP(1);
  else if (nf <= 2) e = LEOD_MLP(2);
  else if (nf <= 4) e = LEOD_MLP(4);
  else e = LEOD_MLP(MLP_MAXF);
#undef LEOD_MLP
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n = static_cast<size_t>(R) * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  mlp_combine_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(y_ws),
      static_cast<const bf16*>(out_b), static_cast<const bf16*>(ls2),
      static_cast<bf16*>(out), R, C, splits);
  return cudaGetLastError();
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
