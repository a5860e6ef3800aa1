// Fused decode-score + masked loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of recoder_tpu/experiments/pallas_loss.py:
// _fwd_kernel (reached through _fwd_call's pl.pallas_call) and _bwd_kernel
// (through _bwd_call). For h [B, d], rows [W, d], bias [W], target [B, W]
// (float32 or bfloat16), row_mask [B] and col_mask [W] (float32, row-major,
// contiguous):
//
//   S      = h @ rows^T + bias                          (never stored)
//   loss   = sum_ij  l(S_ij, T_ij) * row_mask_i * col_mask_j
//   E0_ij  = l'(S_ij, T_ij) * row_mask_i * col_mask_j
//   dh     = g * E0 @ rows,  drows = g * E0^T @ h,  dbias = g * sum_i E0_ij
//
// with l the confidence-weighted MSE (1 + c*[t>0]) * (s - t)^2 or the
// BCE-with-logits max(s,0) - s*t + log1p(exp(-|s|)), and g the upstream
// gradient, a device scalar read in the epilogue (no host sync).
//
// Design: the cotangent is stashed, S is computed once a step.
//   * decode_loss_fwd_kernel: one S tile per block (128 batch rows x 128
//     items, K = d); the epilogue adds the tile's loss to ONE partial per
//     block (summed by sum_partials_kernel in a fixed order) and, when a
//     backward will follow, writes E0 in float32 ([B, lde], lde = W
//     rounded up to 4, the pad columns zero). S itself never reaches
//     device memory.
//   * drows_dbias_kernel: [drows | dbias] = g * E0^T [h | 1] over
//     128-item x 128-feature tiles, K = B: the loader puts a column of
//     ones beside h in shared memory (never in global memory), so the
//     tensor cores sum E0's columns for dbias in the same pass.
//   * dh_splitk_kernel: dh = E0 rows, split-K over the items (about two
//     blocks per SM), one [B, d] partial per split, summed in split order
//     by sum_splits_kernel, which applies g.
// No atomics anywhere: two runs are bitwise equal.
//
// Work at the ML-20M step (B=500, d=200, W=20,224): 3 products of
// 2*B*W*d = 4.04 GFLOP (12.1 GFLOP a step; the first version recomputed S
// in both backward kernels, 5 products, 20.2 GFLOP). Bytes: the forward
// reads 57.2 MB (target in float32; 37.0 MB in bfloat16) and writes the
// 40.4 MB E0; the backward reads E0, h and rows (57.0 MB) and writes
// 16.6 MB. On this card (495 TFLOP/s TF32, 3.35 TB/s) the products take
// ~8 us each at the TF32 rate and the bytes ~17 us a kernel: one 40 MB
// write and two reads of E0 cost less than two recomputed products.
//
// Products on the tensor cores at float32 accuracy (3xTF32): each operand
// x is split in registers into hi = tf32_rna(x) and lo = tf32_rna(x - hi),
// and the tile accumulates lo*hi + hi*lo + hi*hi in float32 through
// mma.sync.m16n8k8 (TF32), which keeps the error near float32's (~2^-21
// relative) where one TF32 pass would not. mma.sync and not wgmma: TF32
// wgmma takes only K-major shared-memory operands, which suits S = h
// rows^T but not E0^T h or E0 rows (rows and h are N-major there, E0^T
// M-major); mma.sync loads its register fragments from shared memory in
// any layout, so one main loop serves all three products.
//
// Tiles come in through cp.async into a 3-stage ring (16-byte copies when
// d % 4 == 0 and the operands are 16-byte aligned, 4-byte copies
// otherwise; ragged edges and the K edge of d are zero-filled in shared
// memory, never padded in global memory). Each of the 8 warps owns a
// 64 x 32 register tile (16 mma tiles of 16 x 8), so each k-step of 8
// issues 48 mma.sync against 24 shared-memory loads. Shared-memory rows
// are padded (K-major rows by 4 floats, M/N-major rows by 8) so that the
// fragment loads of a warp hit 32 distinct banks.
//
// Any B, W >= 1 and 1 <= d <= 256.
//
// The bfloat16 variant (compute_dtype='bfloat16', the JAX package's
// decode at bf16: both operands rounded to bf16, products accumulated in
// float32) is a second set of the three kernels, *_bf16_kernel, on the
// same tiles, ring and warp layout. It reads the float32 h and rows and
// rounds them to bf16 in registers while building the fragments
// (cvt.rn.bf16x2.f32), so no extra pass over the table runs, and issues
// ONE mma.sync.m16n8k16.bf16 where 3xTF32 issues three m16n8k8. Its
// rounding points are those of the JAX composition (jax.vjp of
// decode_gather_matmul + astype(bf16) + the loss):
//   S   = bf16(h_bf16 rows_bf16^T + bias)    the loss from it, in float32
//   E0  = bf16(l'(S, T) * masks)             stored bf16 [B, lde], lde = W
//                                            rounded up to 8 (the JAX
//                                            cotangent is bf16 too; the
//                                            port rounds before g)
//   dh    = bf16(g * E0 rows_bf16),  drows = bf16(g * E0^T h_bf16)
//   dbias = g * sum_i E0_ij                  (float32)
// The bf16 E0 halves the forward's largest write and the backward's two
// reads of it: at the ML-20M step the forward moves ~57 MB (f32 rows
// 16.2, bf16 target 20.2, bf16 E0 20.2), the backward ~53 MB.
// Fragments take element pairs (k, k+4) and (k+8, k+12) of each 16-wide
// k slice, a permutation of the slice's k order that A and B share, so
// the sum is the same; the loads are then the 4-byte (or 2-byte) loads
// of the float32 kernels and hit 32 distinct banks. E0 comes into shared
// memory by 16-byte cp.async (8 elements; its zero pad columns make every
// run start inside the operand or past its edge).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 256;
// block tile kBM x kBN, k-step kBK; 8 warps as 2 (M) x 4 (N)
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kWarpsN = 4;
constexpr int kWM = 64;
constexpr int kWN = 32;
constexpr int kMT = kWM / 16;  // mma tiles along M per warp
constexpr int kNT = kWN / 8;   // mma tiles along N per warp
constexpr int kPadK = 4;       // K-major shared rows: kBK + 4 floats
constexpr int kPadMN = 8;      // M/N-major shared rows: rows + 8 floats

constexpr int kMse = 0;
constexpr int kLogistic = 1;

// The three products. A is [M, K], B is [N, K]; "K-major" means k is the
// contiguous index in global memory.
//   kFwd:   A = h [B, d] K-major,      B = rows [W, d] K-major
//   kDrows: A = E0^T (E0 [B, lde]) M-major, B = h (as [d, B]) N-major
//   kDh:    A = E0 [B, lde] K-major,   B = rows (as [d, W]) N-major
constexpr int kFwd = 0;
constexpr int kDrows = 1;
constexpr int kDh = 2;

struct Params {
  const float* a;
  const float* b;
  int lda, ldb;
  int M, N, K;
  int ktiles;  // k tiles of one split (blockIdx.z)
  // forward epilogue
  const float* bias;
  const void* target;
  int target_bf16;
  const float* row_mask;
  const float* col_mask;
  int kind;
  float confidence;
  float* e0;  // null: no backward follows, no E0
  int lde;
  float* partials;
  // backward epilogues
  const float* g;
  float* out;
  float* dbias;
  // the bf16 variant: E0 written by the forward, A of both backward
  // products
  __nv_bfloat16* e0b;
  const __nv_bfloat16* ab;
};

__host__ __device__ constexpr bool a_kmajor(int op) { return op != kDrows; }
__host__ __device__ constexpr bool b_kmajor(int op) { return op == kFwd; }
__host__ __device__ constexpr int tile_floats(int rows, bool kmajor) {
  return kmajor ? rows * (kBK + kPadK) : kBK * (rows + kPadMN);
}
__host__ __device__ constexpr int stage_floats(int op) {
  return tile_floats(kBM, a_kmajor(op)) + tile_floats(kBN, b_kmajor(op));
}
__host__ __device__ constexpr size_t smem_bytes(int op) {
  return (size_t)kStages * stage_floats(op) * sizeof(float);
}

__device__ __forceinline__ float elem_loss(float s, float t, int kind,
                                           float confidence) {
  if (kind == kMse) {
    const float w = 1.f + confidence * (t > 0.f ? 1.f : 0.f);
    const float e = s - t;
    return w * (e * e);
  }
  return fmaxf(s, 0.f) - s * t + log1pf(expf(-fabsf(s)));
}

__device__ __forceinline__ float elem_dloss(float s, float t, int kind,
                                            float confidence) {
  if (kind == kMse) {
    const float w = 1.f + confidence * (t > 0.f ? 1.f : 0.f);
    return 2.f * w * (s - t);
  }
  return 1.f / (1.f + expf(-s)) - t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_ok false zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool src_ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool src_ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying the [kRows x kBK] tile at (r0, k0) of an operand into
// shared memory. K-major: element (r, k) at g[r * ld + k], stored [r][kBK +
// kPadK]; else at g[k * ld + r], stored [k][kRows + kPadMN]. Elements with
// r >= R or k >= K are zero. The 16-byte path needs ld % 4 == 0, a 16-byte
// aligned g, and every 4-element run either inside the operand or past its
// edge: the caller's E0 pads its rows with zeros to lde. kOnes (M/N-major
// only): row r == R holds ones for k < K instead, so that the product's
// column R sums A's rows over k.
template <int kRows, bool kKMajor, bool kVec, bool kOnes = false>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int ld, int R, int K, int r0,
                                          int k0) {
  if (kKMajor) {
    constexpr int kLd = kBK + kPadK;
    if (kVec) {
      constexpr int kPerRow = kBK / 4;
#pragma unroll
      for (int c = threadIdx.x; c < kRows * kPerRow; c += kThreads) {
        const int r = c / kPerRow, k = (c % kPerRow) * 4;
        const bool ok = r0 + r < R && k0 + k < K;
        cp_async16(s + r * kLd + k, ok ? g + (size_t)(r0 + r) * ld + k0 + k
                                       : g, ok);
      }
    } else {
#pragma unroll 4
      for (int c = threadIdx.x; c < kRows * kBK; c += kThreads) {
        const int r = c / kBK, k = c % kBK;
        const bool ok = r0 + r < R && k0 + k < K;
        cp_async4(s + r * kLd + k, ok ? g + (size_t)(r0 + r) * ld + k0 + k
                                      : g, ok);
      }
    }
  } else {
    constexpr int kLd = kRows + kPadMN;
    if (kVec) {
      constexpr int kPerK = kRows / 4;
#pragma unroll
      for (int c = threadIdx.x; c < kBK * kPerK; c += kThreads) {
        const int k = c / kPerK, r = (c % kPerK) * 4;
        const bool ok = r0 + r < R && k0 + k < K;
        if (kOnes && r0 + r == R)
          *reinterpret_cast<float4*>(s + k * kLd + r) =
              make_float4(k0 + k < K ? 1.f : 0.f, 0.f, 0.f, 0.f);
        else
          cp_async16(s + k * kLd + r,
                     ok ? g + (size_t)(k0 + k) * ld + r0 + r : g, ok);
      }
    } else {
#pragma unroll 4
      for (int c = threadIdx.x; c < kBK * kRows; c += kThreads) {
        const int k = c / kRows, r = c % kRows;
        const bool ok = r0 + r < R && k0 + k < K;
        if (kOnes && r0 + r == R)
          s[k * kLd + r] = k0 + k < K ? 1.f : 0.f;
        else
          cp_async4(s + k * kLd + r,
                    ok ? g + (size_t)(k0 + k) * ld + r0 + r : g, ok);
      }
    }
  }
}

// element (r, k) of a shared tile of kRows rows
template <int kRows, bool kKMajor>
__device__ __forceinline__ float tile_at(const float* s, int r, int k) {
  return kKMajor ? s[r * (kBK + kPadK) + k] : s[k * (kRows + kPadMN) + r];
}

// x = hi + lo, both TF32 (round to nearest, ties away). Two bit-identical
// forms: cvt.rna, or the same rounding in integer arithmetic, which issues
// faster but holds more registers; only dh's main loop spills with it.
template <int kOp>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (kOp == kDh) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const float rest = x - __uint_as_float(hi);
    lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A_tile B_tile^T over one k tile, 3xTF32. Fragment layouts of
// m16n8k8 (g = lane / 4, t = lane % 4): A (g | g+8, t | t+4), B (n = g,
// k = t | t+4), C (g | g+8, 2t | 2t+1).
template <int kOp>
__device__ __forceinline__ void mma_tile(const float* as, const float* bs,
                                         float (&acc)[kMT][kNT][4], int wm,
                                         int wn, int g, int t) {
  constexpr bool ak = a_kmajor(kOp), bk = b_kmajor(kOp);  // K-major?
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int n = wn + ni * 8 + g;
      split_tf32<kOp>(tile_at<kBN, bk>(bs, n, kk + t), bh[ni][0], bl[ni][0]);
      split_tf32<kOp>(tile_at<kBN, bk>(bs, n, kk + t + 4), bh[ni][1],
                      bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r = wm + mi * 16 + g;
      uint32_t ah[4], al[4];
      split_tf32<kOp>(tile_at<kBM, ak>(as, r, kk + t), ah[0], al[0]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r + 8, kk + t), ah[1], al[1]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r, kk + t + 4), ah[2], al[2]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r + 8, kk + t + 4), ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        mma_tf32(acc[mi][ni], al, bh[ni]);
        mma_tf32(acc[mi][ni], ah, bl[ni]);
        mma_tf32(acc[mi][ni], ah, bh[ni]);
      }
    }
  }
}

// One [kBM x kBN] output tile of A B^T over this block's k range, then the
// product's epilogue.
template <int kOp, bool kVec>
__device__ __forceinline__ void tile_product(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kAFloats = tile_floats(kBM, a_kmajor(kOp));
  constexpr int kStage = stage_floats(kOp);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kt0 = blockIdx.z * p.ktiles;
  const int nk = min(p.ktiles, (p.K + kBK - 1) / kBK - kt0);

  auto load_stage = [&](int i) {
    float* s = smem + (i % kStages) * kStage;
    const int k0 = (kt0 + i) * kBK;
    load_tile<kBM, a_kmajor(kOp), kVec>(s, p.a, p.lda, p.M, p.K, m0, k0);
    // kDrows: h gets a column of ones at n = d, which makes the product's
    // column d the column sums of E0 (dbias)
    load_tile<kBN, b_kmajor(kOp), kVec, kOp == kDrows>(
        s + kAFloats, p.b, p.ldb, p.N, p.K, n0, k0);
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + kStages - 1 < nk) load_stage(i + kStages - 1);
    cp_async_commit();
    const float* s = smem + (i % kStages) * kStage;
    mma_tile<kOp>(s, s + kAFloats, acc, wm, wn, g, t);
  }
  cp_async_wait<0>();

  // acc[mi][ni][2 * hf + c] is element (wm + mi*16 + g + 8*hf,
  // wn + ni*8 + 2t + c) of the tile
  if constexpr (kOp == kFwd) {
    __shared__ float warp_partials[kThreads / 32];
    float loss = 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm + mi * 16 + g + 8 * hf;
        if (row >= p.M) continue;
        const float rm = p.row_mask[row];
        const size_t trow = (size_t)row * p.N;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int col0 = n0 + wn + ni * 8 + 2 * t;
          float e[2] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = col0 + c;
            if (col < p.N) {
              const float s = acc[mi][ni][2 * hf + c] + p.bias[col];
              const float tv =
                  p.target_bf16
                      ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                            p.target)[trow + col])
                      : static_cast<const float*>(p.target)[trow + col];
              const float w = rm * p.col_mask[col];
              loss += elem_loss(s, tv, p.kind, p.confidence) * w;
              e[c] = elem_dloss(s, tv, p.kind, p.confidence) * w;
            }
          }
          // lde and col0 are even: the pair lies inside [0, lde) or past it
          if (p.e0 != nullptr && col0 < p.lde)
            *reinterpret_cast<float2*>(p.e0 + (size_t)row * p.lde + col0) =
                make_float2(e[0], e[1]);
        }
      }
    loss = warp_sum(loss);
    if (lane == 0) warp_partials[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_partials[w];
      p.partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
  } else {
    // kDrows: out = drows [W, d], scaled by g; kDh: out = this split's
    // [B, d] partial, unscaled
    const float scale = kOp == kDrows ? *p.g : 1.f;
    float* out = p.out + (kOp == kDh ? (size_t)blockIdx.z * p.M * p.N : 0);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm + mi * 16 + g + 8 * hf;
        if (row >= p.M) continue;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + wn + ni * 8 + 2 * t + c;
            if (col < p.N)
              out[(size_t)row * p.N + col] = scale * acc[mi][ni][2 * hf + c];
            else if (kOp == kDrows && col == p.N)
              p.dbias[row] = scale * acc[mi][ni][2 * hf + c];
          }
      }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    decode_loss_fwd_kernel(const Params p) {
  tile_product<kFwd, kVec>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    drows_dbias_kernel(const Params p) {
  tile_product<kDrows, kVec>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    dh_splitk_kernel(const Params p) {
  tile_product<kDh, kVec>(p);
}

// out[0] = sum of partials[0..n), in a fixed order (one block).
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ partials, int n,
                        float* __restrict__ out) {
  __shared__ float warp_partials[kThreads / 32];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) v += partials[i];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_partials[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_partials[w];
    out[0] = total;
  }
}

// out[i] = g * sum_s parts[s * n + i], s in order.
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ parts, int nsplit,
                      long long n, const float* __restrict__ g,
                      float* __restrict__ out) {
  const float scale = *g;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += parts[s * n + i];
    out[i] = scale * v;
  }
}

// -- the bfloat16 variant ----------------------------------------------------

constexpr int kPadK16 = 8;   // bf16 K-major shared rows: kBK + 8 halves
constexpr int kPadMN16 = 8;  // bf16 M-major shared rows: rows + 8 halves

// Shared bytes of one stage's A tile: h (float32) in the forward, E0
// (bf16) in the backward products; B is float32 in all three.
__host__ __device__ constexpr int a_bytes_bf16(int op) {
  return op == kFwd ? tile_floats(kBM, true) * 4
         : a_kmajor(op) ? kBM * (kBK + kPadK16) * 2
                        : kBK * (kBM + kPadMN16) * 2;
}
__host__ __device__ constexpr int stage_bytes_bf16(int op) {
  return a_bytes_bf16(op) + tile_floats(kBN, b_kmajor(op)) * 4;
}
__host__ __device__ constexpr size_t smem_bytes_bf16(int op) {
  return (size_t)kStages * stage_bytes_bf16(op);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16_any(void* dst, const void* src,
                                               bool src_ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_ok ? 16 : 0)
               : "memory");
}

// Start copying the [kRows x kBK] tile at (r0, k0) of the bf16 E0 into
// shared memory, 8 elements a copy. K-major: element (r, k) at g[r * ld +
// k], stored [r][kBK + kPadK16]; else at g[k * ld + r], stored [k][kRows +
// kPadMN16]. Needs ld % 8 == 0, a 16-byte aligned g and zeros in g's pad
// columns up to ld; elements with r >= R or k >= K come out zero.
template <int kRows, bool kKMajor>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* s, const __nv_bfloat16* __restrict__ g, int ld, int R,
    int K, int r0, int k0) {
  if (kKMajor) {
    constexpr int kLd = kBK + kPadK16, kPerRow = kBK / 8;
#pragma unroll
    for (int c = threadIdx.x; c < kRows * kPerRow; c += kThreads) {
      const int r = c / kPerRow, k = (c % kPerRow) * 8;
      const bool ok = r0 + r < R && k0 + k < K;
      cp_async16_any(s + r * kLd + k,
                     ok ? g + (size_t)(r0 + r) * ld + k0 + k : g, ok);
    }
  } else {
    constexpr int kLd = kRows + kPadMN16, kPerK = kRows / 8;
#pragma unroll
    for (int c = threadIdx.x; c < kBK * kPerK; c += kThreads) {
      const int k = c / kPerK, r = (c % kPerK) * 8;
      const bool ok = r0 + r < R && k0 + k < K;
      cp_async16_any(s + k * kLd + r,
                     ok ? g + (size_t)(k0 + k) * ld + r0 + r : g, ok);
    }
  }
}

// The bf16 bits of element (r, k) of a shared bf16 tile of kRows rows.
template <int kRows, bool kKMajor>
__device__ __forceinline__ uint32_t bf16_bits(const void* s, int r, int k) {
  const unsigned short* u = static_cast<const unsigned short*>(s);
  return kKMajor ? u[r * (kBK + kPadK16) + k] : u[k * (kRows + kPadMN16) + r];
}

// Elements (r, k) and (r, k + 4) of operand A (kIsA) or B of product kOp
// as one bf16x2 register, (r, k) in the lower half: E0 as it is stored,
// float32 tiles rounded to nearest even.
template <int kOp, bool kIsA>
__device__ __forceinline__ uint32_t frag_pair(const void* s, int r, int k) {
  if constexpr (kIsA && kOp != kFwd) {
    return bf16_bits<kBM, a_kmajor(kOp)>(s, r, k) |
           (bf16_bits<kBM, a_kmajor(kOp)>(s, r, k + 4) << 16);
  } else {
    constexpr int kRows = kIsA ? kBM : kBN;
    constexpr bool kKMajor = kIsA ? a_kmajor(kOp) : b_kmajor(kOp);
    const float* f = static_cast<const float*>(s);
    const __nv_bfloat162 v = __floats2bfloat162_rn(
        tile_at<kRows, kKMajor>(f, r, k), tile_at<kRows, kKMajor>(f, r, k + 4));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A_tile B_tile^T over one k tile in bf16. m16n8k16 fragments (g =
// lane / 4, t = lane % 4): A (g | g+8, k slots 2t, 2t+1 | 2t+8, 2t+9), B
// (n = g, the same k slots), C as m16n8k8. Slots 2t, 2t+1, 2t+8, 2t+9
// hold the slice's k = t, t+4, t+8, t+12 in both operands.
template <int kOp>
__device__ __forceinline__ void mma_tile_bf16(const void* as, const void* bs,
                                              float (&acc)[kMT][kNT][4],
                                              int wm, int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[kNT][2];
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int n = wn + ni * 8 + g;
      b[ni][0] = frag_pair<kOp, false>(bs, n, kk + t);
      b[ni][1] = frag_pair<kOp, false>(bs, n, kk + t + 8);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r = wm + mi * 16 + g;
      const uint32_t a[4] = {frag_pair<kOp, true>(as, r, kk + t),
                             frag_pair<kOp, true>(as, r + 8, kk + t),
                             frag_pair<kOp, true>(as, r, kk + t + 8),
                             frag_pair<kOp, true>(as, r + 8, kk + t + 8)};
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
    }
  }
}

// tile_product's bf16 twin: the same tile, ring and epilogues, with the
// roundings of the header.
template <int kOp, bool kVec>
__device__ __forceinline__ void tile_product_bf16(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem16[];
  constexpr int kABytes = a_bytes_bf16(kOp);
  constexpr int kStage = stage_bytes_bf16(kOp);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kt0 = blockIdx.z * p.ktiles;
  const int nk = min(p.ktiles, (p.K + kBK - 1) / kBK - kt0);

  auto load_stage = [&](int i) {
    unsigned char* s = smem16 + (i % kStages) * kStage;
    const int k0 = (kt0 + i) * kBK;
    if constexpr (kOp == kFwd)
      load_tile<kBM, true, kVec>(reinterpret_cast<float*>(s), p.a, p.lda,
                                 p.M, p.K, m0, k0);
    else
      load_tile_bf16<kBM, a_kmajor(kOp)>(reinterpret_cast<__nv_bfloat16*>(s),
                                         p.ab, p.lda, p.M, p.K, m0, k0);
    load_tile<kBN, b_kmajor(kOp), kVec, kOp == kDrows>(
        reinterpret_cast<float*>(s + kABytes), p.b, p.ldb, p.N, p.K, n0, k0);
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < nk) load_stage(i + kStages - 1);
    cp_async_commit();
    const unsigned char* s = smem16 + (i % kStages) * kStage;
    mma_tile_bf16<kOp>(s, s + kABytes, acc, wm, wn, g, t);
  }
  cp_async_wait<0>();

  if constexpr (kOp == kFwd) {
    __shared__ float warp_partials[kThreads / 32];
    float loss = 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm + mi * 16 + g + 8 * hf;
        if (row >= p.M) continue;
        const float rm = p.row_mask[row];
        const size_t trow = (size_t)row * p.N;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int col0 = n0 + wn + ni * 8 + 2 * t;
          float e[2] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = col0 + c;
            if (col < p.N) {
              const float s = round_bf16(acc[mi][ni][2 * hf + c] + p.bias[col]);
              const float tv =
                  p.target_bf16
                      ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                            p.target)[trow + col])
                      : static_cast<const float*>(p.target)[trow + col];
              const float w = rm * p.col_mask[col];
              loss += elem_loss(s, tv, p.kind, p.confidence) * w;
              e[c] = elem_dloss(s, tv, p.kind, p.confidence) * w;
            }
          }
          // lde and col0 are even: the pair lies inside [0, lde) or past it
          if (p.e0b != nullptr && col0 < p.lde)
            *reinterpret_cast<__nv_bfloat162*>(p.e0b + (size_t)row * p.lde +
                                               col0) =
                __floats2bfloat162_rn(e[0], e[1]);
        }
      }
    loss = warp_sum(loss);
    if (lane == 0) warp_partials[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_partials[w];
      p.partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
  } else {
    // kDrows: out = drows [W, d] = bf16(g * acc), dbias in float32; kDh:
    // out = this split's [B, d] partial, unscaled and unrounded
    const float scale = kOp == kDrows ? *p.g : 1.f;
    float* out = p.out + (kOp == kDh ? (size_t)blockIdx.z * p.M * p.N : 0);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm + mi * 16 + g + 8 * hf;
        if (row >= p.M) continue;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + wn + ni * 8 + 2 * t + c;
            const float v = scale * acc[mi][ni][2 * hf + c];
            if (col < p.N)
              out[(size_t)row * p.N + col] = kOp == kDrows ? round_bf16(v) : v;
            else if (kOp == kDrows && col == p.N)
              p.dbias[row] = v;
          }
      }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    decode_loss_fwd_bf16_kernel(const Params p) {
  tile_product_bf16<kFwd, kVec>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    drows_dbias_bf16_kernel(const Params p) {
  tile_product_bf16<kDrows, kVec>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    dh_splitk_bf16_kernel(const Params p) {
  tile_product_bf16<kDh, kVec>(p);
}

// out[i] = bf16(g * sum_s parts[s * n + i]), s in order (dh of the bf16
// variant).
__global__ void __launch_bounds__(kThreads)
    sum_splits_bf16_kernel(const float* __restrict__ parts, int nsplit,
                           long long n, const float* __restrict__ g,
                           float* __restrict__ out) {
  const float scale = *g;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += parts[s * n + i];
    out[i] = round_bf16(scale * v);
  }
}

int round8(int n) { return (n + 7) & ~7; }

int round4(int n) { return (n + 3) & ~3; }
int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_args(int B, int W, int d) {
  return B < 1 || W < 1 || d < 1 || d > kMaxD;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

const char* fdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fdl_max_d() { return kMaxD; }

// The launch plan of one shape on a card with `sms` SMs:
// out[0] forward partials (= forward blocks), out[1] k tiles per dh split,
// out[2] dh splits, out[3] lde (E0's row stride: W rounded up to 4, or to
// 8 for the bf16 variant's bf16 E0).
int fdl_plan(int B, int W, int d, int sms, int bf16, int* out) {
  if (bad_args(B, W, d) || sms < 1) return cudaErrorInvalidValue;
  const int nk = cdiv(W, kBK);
  const int tiles = cdiv(B, kBM) * cdiv(d, kBN);
  int splits = std::max(1, std::min(nk, cdiv(2 * sms, tiles)));
  const int per = cdiv(nk, splits);
  splits = cdiv(nk, per);
  out[0] = cdiv(B, kBM) * cdiv(W, kBN);
  out[1] = per;
  out[2] = splits;
  out[3] = bf16 ? round8(W) : round4(W);
  return cudaSuccess;
}

// Once per device: the tile kernels' shared-memory limits.
int fdl_configure(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_kernel<true>, smem_bytes(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_kernel<false>, smem_bytes(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_kernel<true>, smem_bytes(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_kernel<false>, smem_bytes(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_kernel<true>, smem_bytes(kDh));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_kernel<false>, smem_bytes(kDh));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_bf16_kernel<true>, smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_bf16_kernel<false>,
                     smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_bf16_kernel<true>, smem_bytes_bf16(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_bf16_kernel<false>, smem_bytes_bf16(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<true>, smem_bytes_bf16(kDh));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<false>, smem_bytes_bf16(kDh));
  return err;
}

// Forward: out[0] = masked sum loss; with e0 non-null also E0 [B, lde]
// (float32, or bf16 when bf16 is set: the bf16 variant). target_bf16:
// target holds bfloat16, else float32. partials: float[out[0] of
// fdl_plan].
int fdl_forward(const float* h, const float* rows, const float* bias,
                const void* target, int target_bf16, const float* row_mask,
                const float* col_mask, int B, int W, int d, int kind,
                float confidence, int bf16, void* e0, int lde,
                float* partials, float* out, int device, void* stream) {
  if (bad_args(B, W, d) || (kind != kMse && kind != kLogistic) ||
      (e0 != nullptr && lde != (bf16 ? round8(W) : round4(W))) ||
      (bf16 && e0 != nullptr && !aligned16(e0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.a = h;
  p.b = rows;
  p.lda = p.ldb = d;
  p.M = B;
  p.N = W;
  p.K = d;
  p.ktiles = cdiv(d, kBK);
  p.bias = bias;
  p.target = target;
  p.target_bf16 = target_bf16;
  p.row_mask = row_mask;
  p.col_mask = col_mask;
  p.kind = kind;
  p.confidence = confidence;
  if (bf16)
    p.e0b = static_cast<__nv_bfloat16*>(e0);
  else
    p.e0 = static_cast<float*>(e0);
  p.lde = lde;
  p.partials = partials;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(B, kBM), cdiv(W, kBN));
  const bool vec = d % 4 == 0 && aligned16(h) && aligned16(rows);
  if (bf16) {
    const size_t smem = smem_bytes_bf16(kFwd);
    if (vec)
      decode_loss_fwd_bf16_kernel<true><<<grid, kThreads, smem, s>>>(p);
    else
      decode_loss_fwd_bf16_kernel<false><<<grid, kThreads, smem, s>>>(p);
  } else if (vec) {
    decode_loss_fwd_kernel<true><<<grid, kThreads, smem_bytes(kFwd), s>>>(p);
  } else {
    decode_loss_fwd_kernel<false><<<grid, kThreads, smem_bytes(kFwd), s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, out);
  return cudaGetLastError();
}

// Backward from the stashed E0 [B, lde] (bf16 when bf16 is set): dh [B,
// d], drows [W, d], dbias [W] for the upstream gradient *g (a device
// scalar). ktiles, nsplit: out[1], out[2] of fdl_plan. dh_partials:
// float[nsplit * B * d].
int fdl_backward(const float* g, const void* e0, int lde, const float* h,
                 const float* rows, int B, int W, int d, int ktiles,
                 int nsplit, int bf16, float* dh_partials, float* dh,
                 float* drows, float* dbias, int device, void* stream) {
  if (bad_args(B, W, d) || lde != (bf16 ? round8(W) : round4(W)) ||
      ktiles < 1 || nsplit < 1 ||
      (long long)ktiles * nsplit < cdiv(W, kBK) ||
      (long long)ktiles * (nsplit - 1) >= cdiv(W, kBK) ||
      (bf16 && !aligned16(e0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bf16 E0 is always copied 16 bytes at a time (lde % 8 == 0)
  const bool vec = d % 4 == 0 && (bf16 || aligned16(e0)) && aligned16(h) &&
                   aligned16(rows);

  Params p = {};
  if (bf16)
    p.ab = static_cast<const __nv_bfloat16*>(e0);
  else
    p.a = static_cast<const float*>(e0);
  p.lda = lde;
  p.b = h;
  p.ldb = d;
  p.M = W;
  p.N = d;
  p.K = B;
  p.ktiles = cdiv(B, kBK);
  p.g = g;
  p.out = drows;
  p.dbias = dbias;
  const dim3 grid_rows(cdiv(W, kBM), cdiv(d + 1, kBN));  // + dbias column
  if (bf16) {
    const size_t smem = smem_bytes_bf16(kDrows);
    if (vec)
      drows_dbias_bf16_kernel<true><<<grid_rows, kThreads, smem, s>>>(p);
    else
      drows_dbias_bf16_kernel<false><<<grid_rows, kThreads, smem, s>>>(p);
  } else if (vec) {
    drows_dbias_kernel<true>
        <<<grid_rows, kThreads, smem_bytes(kDrows), s>>>(p);
  } else {
    drows_dbias_kernel<false>
        <<<grid_rows, kThreads, smem_bytes(kDrows), s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  p.b = rows;
  p.M = B;
  p.N = d;
  p.K = W;
  p.ktiles = ktiles;
  p.g = nullptr;
  p.out = dh_partials;
  p.dbias = nullptr;
  const dim3 grid_dh(cdiv(B, kBM), cdiv(d, kBN), nsplit);
  if (bf16) {
    const size_t smem = smem_bytes_bf16(kDh);
    if (vec)
      dh_splitk_bf16_kernel<true><<<grid_dh, kThreads, smem, s>>>(p);
    else
      dh_splitk_bf16_kernel<false><<<grid_dh, kThreads, smem, s>>>(p);
  } else if (vec) {
    dh_splitk_kernel<true><<<grid_dh, kThreads, smem_bytes(kDh), s>>>(p);
  } else {
    dh_splitk_kernel<false><<<grid_dh, kThreads, smem_bytes(kDh), s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)B * d;
  const int sum_blocks = (int)std::min<long long>((n + kThreads - 1) / kThreads,
                                                  4096);
  if (bf16)
    sum_splits_bf16_kernel<<<sum_blocks, kThreads, 0, s>>>(dh_partials, nsplit,
                                                           n, g, dh);
  else
    sum_splits_kernel<<<sum_blocks, kThreads, 0, s>>>(dh_partials, nsplit, n,
                                                      g, dh);
  return cudaGetLastError();
}

}  // extern "C"
