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
//
// The bf16 variant has two sets of kernels, chosen by shape in the
// wrapper (ops/fused_decode_loss.py, bf16_route): the mma.sync set above
// ("mma", any shape) and a set designed for Hopper ("wgmma"), which also
// replaces pallas_loss.py's _fwd_kernel and _bwd_kernel. The wgmma set
// takes a call when TMA can describe every operand: a bf16 target [B, W]
// at any W whose row stride is a multiple of 8 elements (16-byte runs;
// the trainer's union targets are built at a row stride of W rounded up
// to 8), a feature width d % 8 == 0 up to 248 (kWgMaxD: hb's row,
// d + 8, is one wgmma N) and 16-byte aligned bases. Every bf16 training
// path of the port at d = 200 takes it: bench.py's ML-20M step, [500,
// 200, 20,224], and the exact union widths (e.g. 18,117). The mma.sync
// set serves what TMA or the ladder cannot: d > 248, d % 8 != 0, a
// float32 target, a misaligned pointer or row stride.
// Both sets round at the same points and compute the same function.
//
// What bounds it is bytes: at the ML-20M step the forward moves 57.2 MB
// (float32 rows 16.2, the bf16 target 20.2 and E0 20.2) and the backward
// 53.5 MB, against 4.04 GFLOP a product (4 us at the bf16 tensor-core
// rate, 17 us for the forward's bytes). The mma.sync set spent its time
// elsewhere: converting float32 shared-memory tiles to bf16 fragments per
// register per warp, 16-byte E0 runs spread over 8 rows, d = 200 padded
// to two 128-wide tiles in the backward, and the rows tile loaded anew for
// each of 4 batch tiles. The wgmma set:
//   * every operand tile is a 64 x 64 bf16 TMA box in the 128-byte
//     swizzle that wgmma reads, brought in by a producer warp through
//     mbarriers; the products are wgmma (m64nNk16, float32 accumulators)
//     with both operands in shared memory, K-major or MN-major as stored,
//     so nothing is converted or transposed per fragment;
//   * cast_operands_bf16_kernel writes hb = [bf16(h) | 1 | 0..] [B, dp]
//     (dp = d rounded up to 8 past the ones column; 200 KB) once a forward:
//     the forward's A operand, and drows' B operand, whose ones column
//     sums E0's columns for dbias inside the product;
//   * the forward (decode_loss_fwd_bf16_wgmma_kernel, compiled at the K
//     ladder 64, 128, 208, 256: 13 k steps of 16 at d = 200) is
//     persistent: one block an SM walks its share of the units (a 64-item
//     tile and half of the batch), loads each tile's float32 rows once
//     (into registers, while the tile before it runs), rounds them into
//     the swizzled bf16 layout once (writing the bf16 rows copy rows_b
//     [W, d] for the backward when one follows) and keeps them; two
//     consumer warpgroups take the batch's 64-row tiles in turn, each fed
//     hb tiles and target blocks by its own producer warp; the epilogue
//     computes the loss and E0 in registers over the target's
//     shared-memory tile and one TMA store writes E0 (nothing but the
//     loss partials without a backward);
//   * drows_dbias_bf16_wgmma_kernel: M = 64 items a warpgroup, N = dp
//     on a ladder of compiled widths (64, 128, 208, 256; 208 at d = 200:
//     one wgmma, no pad tile), K = the batch, A = E0^T read MN-major from
//     E0 as stored;
//   * dh_bf16_wgmma_kernel: M = 64 batch rows a warpgroup, N = d on the
//     ladder 64, 128, 200, 256, K = the items split into about one block
//     an SM, A = E0 (K-major), B = rows_b (MN-major); the splits'
//     partials summed in split order by sum_splits_bf16_kernel.
// The backward reads rows_b (8.1 MB) and hb as the forward left them:
// keeping them costs the forward less than casting again would cost the
// backward (measured, PERF.md). No atomics; every sum has a fixed order,
// so two runs, and a captured and an eager step, are bitwise equal. TMA
// descriptors are encoded on the host from each call's pointers
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint) and passed as
// __grid_constant__ parameters, so a CUDA graph records them.
//
// bf16 parameter storage (params_dtype='bfloat16'): the rows may be a
// bf16 table, read as stored and never copied. The wgmma forward
// (kRowsB16) loads each tile's rows 16 bytes a thread into the same
// registers and swizzled layout, with no rounding, and writes no rows_b:
// the backward takes the table itself as its TMA operand (nothing writes
// the table between the two; the optimizer steps after the backward).
// The mma.sync set's kFwd and kDh take them as a bf16 B tile
// (kB16: load_tile_b16, 16-byte cp.async where d % 8 == 0 and the base
// is aligned, else element by element) read by its fragments as stored.
// drows is then written in bf16 (out_b16), rounded once from its
// float32 value; at float32 compute the 3xTF32 set reads a float32 copy
// of the rows that the wrapper makes, and writes drows in bf16 the same
// way. A bf16 row is the bf16 rounding of itself, so every result is
// bitwise that of float32 rows holding the same values.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

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
  int ldt;  // the target's row stride (>= N)
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
  // bf16 parameter storage: B is bf16 rows (the bf16 variant's kFwd and
  // kDh, as kB16), drows is written in bf16 (kDrows)
  const __nv_bfloat16* bb;
  int out_b16;
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
        const size_t trow = (size_t)row * p.ldt;
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
            const float v = scale * acc[mi][ni][2 * hf + c];
            if (col < p.N) {
              if (kOp == kDrows && p.out_b16)
                reinterpret_cast<__nv_bfloat16*>(p.out)[(size_t)row * p.N +
                                                         col] =
                    __float2bfloat16_rn(v);
              else
                out[(size_t)row * p.N + col] = v;
            } else if (kOp == kDrows && col == p.N) {
              p.dbias[row] = v;
            }
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

// load_tile_bf16 for a bf16 operand that may not meet its conditions (the
// rows of a bf16 table): kVec takes load_tile_bf16 (d % 8 == 0, a 16-byte
// aligned base); else element by element, plain loads and stores, which
// the __syncthreads before the tile's use publishes as it does the
// cp.async copies.
template <int kRows, bool kKMajor, bool kVec>
__device__ __forceinline__ void load_tile_b16(
    __nv_bfloat16* s, const __nv_bfloat16* __restrict__ g, int ld, int R,
    int K, int r0, int k0) {
  if constexpr (kVec) {
    load_tile_bf16<kRows, kKMajor>(s, g, ld, R, K, r0, k0);
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(g);
    unsigned short* o = reinterpret_cast<unsigned short*>(s);
#pragma unroll 4
    for (int c = threadIdx.x; c < kRows * kBK; c += kThreads) {
      const int r = kKMajor ? c / kBK : c % kRows;
      const int k = kKMajor ? c % kBK : c / kRows;
      const bool ok = r0 + r < R && k0 + k < K;
      const size_t at = kKMajor ? (size_t)(r0 + r) * ld + k0 + k
                                : (size_t)(k0 + k) * ld + r0 + r;
      o[kKMajor ? r * (kBK + kPadK16) + k : k * (kRows + kPadMN16) + r] =
          ok ? u[at] : (unsigned short)0;
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
// as one bf16x2 register, (r, k) in the lower half: E0 and bf16 rows
// (kB16, operand B) as they are stored, float32 tiles rounded to nearest
// even.
template <int kOp, bool kIsA, bool kB16>
__device__ __forceinline__ uint32_t frag_pair(const void* s, int r, int k) {
  if constexpr (kIsA && kOp != kFwd) {
    return bf16_bits<kBM, a_kmajor(kOp)>(s, r, k) |
           (bf16_bits<kBM, a_kmajor(kOp)>(s, r, k + 4) << 16);
  } else if constexpr (!kIsA && kB16) {
    return bf16_bits<kBN, b_kmajor(kOp)>(s, r, k) |
           (bf16_bits<kBN, b_kmajor(kOp)>(s, r, k + 4) << 16);
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
template <int kOp, bool kB16>
__device__ __forceinline__ void mma_tile_bf16(const void* as, const void* bs,
                                              float (&acc)[kMT][kNT][4],
                                              int wm, int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[kNT][2];
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int n = wn + ni * 8 + g;
      b[ni][0] = frag_pair<kOp, false, kB16>(bs, n, kk + t);
      b[ni][1] = frag_pair<kOp, false, kB16>(bs, n, kk + t + 8);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r = wm + mi * 16 + g;
      const uint32_t a[4] = {frag_pair<kOp, true, kB16>(as, r, kk + t),
                             frag_pair<kOp, true, kB16>(as, r + 8, kk + t),
                             frag_pair<kOp, true, kB16>(as, r, kk + t + 8),
                             frag_pair<kOp, true, kB16>(as, r + 8,
                                                        kk + t + 8)};
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
    }
  }
}

// tile_product's bf16 twin: the same tile, ring and epilogues, with the
// roundings of the header. kB16 (kFwd, kDh): B is the bf16 rows p.bb,
// brought in by load_tile_b16 and read as stored (it fits in the float32
// B tile's room).
template <int kOp, bool kVec, bool kB16 = false>
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
    if constexpr (kB16)
      load_tile_b16<kBN, b_kmajor(kOp), kVec>(
          reinterpret_cast<__nv_bfloat16*>(s + kABytes), p.bb, p.ldb, p.N,
          p.K, n0, k0);
    else
      load_tile<kBN, b_kmajor(kOp), kVec, kOp == kDrows>(
          reinterpret_cast<float*>(s + kABytes), p.b, p.ldb, p.N, p.K, n0,
          k0);
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
    mma_tile_bf16<kOp, kB16>(s, s + kABytes, acc, wm, wn, g, t);
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
        const size_t trow = (size_t)row * p.ldt;
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
            if (col < p.N) {
              if (kOp == kDrows && p.out_b16)
                reinterpret_cast<__nv_bfloat16*>(p.out)[(size_t)row * p.N +
                                                         col] =
                    __float2bfloat16_rn(v);
              else
                out[(size_t)row * p.N + col] =
                    kOp == kDrows ? round_bf16(v) : v;
            } else if (kOp == kDrows && col == p.N) {
              p.dbias[row] = v;
            }
          }
      }
  }
}

template <bool kVec, bool kB16>
__global__ void __launch_bounds__(kThreads, 2)
    decode_loss_fwd_bf16_kernel(const Params p) {
  tile_product_bf16<kFwd, kVec, kB16>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    drows_dbias_bf16_kernel(const Params p) {
  tile_product_bf16<kDrows, kVec>(p);
}

template <bool kVec, bool kB16>
__global__ void __launch_bounds__(kThreads, 2)
    dh_splitk_bf16_kernel(const Params p) {
  tile_product_bf16<kDh, kVec, kB16>(p);
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

// -- the bfloat16 wgmma route (TMA-fed tiles, warpgroup products) ------------

// Every tile is a 64 x 64 bf16 TMA box with 128-byte rows in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), which is both
// the layout wgmma reads and the one TMA writes. A block is two consumer
// warpgroups (threads 0-255) and producer warps after them, whose first
// lanes issue the TMA loads.
constexpr int kBox = 64;
constexpr int kBoxBytes = kBox * kBox * 2;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
// hb's row length: d, its ones column, zeros to a multiple of 8
__host__ __device__ constexpr int pad_ones(int d) { return (d + 8) & ~7; }

// The feature widths: any d % 8 == 0 up to kWgMaxD, so that hb's row
// (pad_ones(d) <= 256) is one wgmma N and the forward's tiles (4 K atoms
// of 64) hold it. The forward's K (d), dh's N (d) and drows' N
// (pad_ones(d)) are each compiled at a short ladder of widths (wgmma's N
// is an immediate, and its accumulators want the K loop unrolled), and a
// shape takes the smallest rung that holds its width; past d the
// operands are zeros (hb's own, the rows tile's, TMA's fill past the
// table's d) and nothing past d is written. The rungs of 200 / 208 are
// bench.py's ML-20M step, which runs at its exact width.
constexpr int kWgMaxD = 248;
template <int... kN>
struct Rungs {};
using DhRungs = Rungs<64, 128, 200, 256>;
// the forward's K and drows' N
using KRungs = Rungs<64, 128, 208, 256>;

// f(std::integral_constant<int, N>) for the smallest rung N >= n
template <typename F, int... kN>
void on_rung(Rungs<kN...>, int n, F f) {
  bool done = false;
  ((done = done || (n <= kN && (f(std::integral_constant<int, kN>{}), true))),
   ...);
}

// f(std::integral_constant<int, N>) for every rung
template <typename F, int... kN>
void each_rung(Rungs<kN...>, F f) {
  (f(std::integral_constant<int, kN>{}), ...);
}

// the backward kernels: 2 consumers (128 items or batch rows a block) and
// one producer warp, a ring of 4 stages, each stage the two consumers' A
// boxes and the B operand's ceil(N / 64) boxes; then 2 barriers a stage
constexpr int kBwdThreads = 2 * 128 + 32;
constexpr int kBwdStages = 4;
__host__ __device__ constexpr size_t bwd_smem(int n) {
  return (size_t)kBwdStages * (2 + ceil_div(n, kBox)) * kBoxBytes +
         kBwdStages * 2 * 8 + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// ~10 s (a protocol fault, not a slow load) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// box (c0 = column, c1 = row) of `map` into shared memory, completing on
// `bar`; columns and rows outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// shared memory into box (c0, c1) of `map` (what lies outside the tensor
// is not written); returns once the copy has read shared memory
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the shared-memory matrix descriptor of a 128-byte-swizzled operand:
// lbo = bytes between 64-wide atoms along M/N (MN-major operands only),
// sbo = bytes between groups of 8 rows (K-major) or 8 k (MN-major)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_commit_wait(float (&acc)[kN / 2]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// m64nNk16, bf16 operands from shared memory, float32 accumulators; kTA /
// kTB: A / B is MN-major (else K-major). Accumulator i of a thread (lane l
// of warp w of the warpgroup) is element (16w + l/4 + 8((i/2) % 2),
// 8(i/4) + 2(l % 4) + i % 2) of the 64 x N tile.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n200(float (&d)[100], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99"
      "}, %100, %101, p, 1, 1, %103, %104;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n208(float (&d)[104], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, %107, %108;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kN, int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t a,
                                      uint64_t b, int scale_d) {
  static_assert(kN == 64 || kN == 128 || kN == 200 || kN == 208 ||
                    kN == 256,
                "no wgmma wrapper of this width");
  if constexpr (kN == 64) wgmma_n64<kTA, kTB>(d, a, b, scale_d);
  else if constexpr (kN == 128) wgmma_n128<kTA, kTB>(d, a, b, scale_d);
  else if constexpr (kN == 200) wgmma_n200<kTA, kTB>(d, a, b, scale_d);
  else if constexpr (kN == 208) wgmma_n208<kTA, kTB>(d, a, b, scale_d);
  else wgmma_n256<kTA, kTB>(d, a, b, scale_d);
}

struct WgParams {
  const void* rows;  // float32, or bf16 (the forward's kRowsB16)
  const float* bias;
  const float* row_mask;
  const float* col_mask;
  __nv_bfloat16* rows_b;  // forward: the bf16 rows copy, or null
  float* partials;
  const float* g;
  float* out;  // drows [W, d], or the dh partials [nsplit, B, d]
  int out_b16;  // drows in bf16 (bf16 parameter storage), else float32
  float* dbias;
  int B, W, d;
  float confidence;
  int write_e0;
  int chunks_per_split;  // dh: 64-item chunks per split
};

// hb [B, dp] = [bf16(h) | 1 | 0 ...], the A operand of the forward and the
// B operand of drows (its ones column sums E0 for dbias). 8 elements a
// thread.
__global__ void __launch_bounds__(kThreads)
    cast_operands_bf16_kernel(const float* __restrict__ h, int B, int d,
                              int dp, __nv_bfloat16* __restrict__ hb) {
  const long long n = (long long)B * dp / 8;
  for (long long q = blockIdx.x * (long long)kThreads + threadIdx.x; q < n;
       q += (long long)gridDim.x * kThreads) {
    float v[8];
    const long long r = q * 8 / dp;
    const int k = (int)(q * 8 - r * dp);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = k + i < d ? h[r * d + k + i] : (k + i == d ? 1.f : 0.f);
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(hb + q * 8) = packed;
  }
}

// The forward, persistent. The work is 2 x ceil(W / 64) units, a unit
// being one 64-item tile and one half of the batch's 64-row tiles; block
// b takes the units [b U / grid, (b + 1) U / grid), so that no block has
// more than one unit above another's. A tile's rows come into registers
// while the block works on the tile before it and are rounded to bf16
// once into the swizzled K-major layout (and copied to rows_b when
// asked), where they stay for the tile's units. The two consumers take a
// unit's row tiles in turn, each with a producer warp of its own that
// keeps its hb tiles (2 slots) and target blocks (3 slots) coming by TMA.
// The epilogue turns the accumulators into the loss and E0 in registers,
// reading the target from and writing E0 over its shared-memory tile,
// which one TMA store then writes out.
constexpr int kFwdThreads = 2 * 128 + 2 * 32;
constexpr int kHSlots = 2, kTSlots = 3;
// the rows tile (4 K atoms), hb slots [consumer][slot] (4 K atoms each),
// target / E0 tiles [consumer][slot], the tile's bias and column mask,
// the barriers, 8 warp sums
constexpr size_t kFwdSmem =
    (4 + 2 * kHSlots * 4 + 2 * kTSlots) * kBoxBytes + 2 * kBox * 4 +
    4 * (kHSlots + kTSlots) * 8 + 8 * 4 + 1024;

__host__ __device__ constexpr int fwd_units(int W) {
  return 2 * ceil_div(W, kBox);
}

// kRowsB16: the rows are a bf16 table (bf16 parameter storage), read 16
// bytes (8 features) a thread as they are stored, and never copied (the
// backward takes the table itself). kK: the K rung that holds d (64, 128,
// 208 or 256 features: 1, 2, 4, 4 atoms of hb and the rows tile, and
// kK / 16 wgmma k steps unrolled, as wgmma's accumulators want them);
// past d the rows tile is zero, so hb's ones column adds nothing here.
template <int kKind, bool kRowsB16, int kK>
__global__ void __launch_bounds__(kFwdThreads, 1)
    decode_loss_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                                      const __grid_constant__ CUtensorMap tmap,
                                      const __grid_constant__ CUtensorMap emap,
                                      const WgParams p) {
  constexpr int kConsumerThreads = 256;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* const rt = align1024(wg_smem);   // rows tile
  unsigned char* const hs = rt + 4 * kBoxBytes;    // [c][slot] x 4 atoms
  unsigned char* const ts = hs + 2 * kHSlots * 4 * kBoxBytes;  // [c][slot]
  float* const bias_s = reinterpret_cast<float*>(ts + 2 * kTSlots * kBoxBytes);
  float* const cm_s = bias_s + kBox;
  uint64_t* const h_full = reinterpret_cast<uint64_t*>(cm_s + kBox);
  uint64_t* const h_empty = h_full + 2 * kHSlots;
  uint64_t* const t_full = h_empty + 2 * kHSlots;
  uint64_t* const t_empty = t_full + 2 * kTSlots;
  float* const warp_loss = reinterpret_cast<float*>(t_empty + 2 * kTSlots);

  const int tid = threadIdx.x;
  const int nb = ceil_div(p.B, kBox), half = ceil_div(nb, 2);
  const int units = fwd_units(p.W);
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  constexpr int atoms = ceil_div(kK, kBox);
  if (tid == 0) {
    for (int i = 0; i < 2 * kHSlots; ++i) {
      mbar_init(h_full + i, 1);
      mbar_init(h_empty + i, 128);
    }
    for (int i = 0; i < 2 * kTSlots; ++i) {
      mbar_init(t_full + i, 1);
      mbar_init(t_empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // lane 0 of producer warp c feeds consumer c its k-th row tile
    // (counted over the block's units) in slots k % kHSlots, k % kTSlots
    const int c = (tid - kConsumerThreads) >> 5;
    if ((tid & 31) == 0) {
      int k = 0;
      for (int u = u0; u < u1; ++u) {
        const int i1 = min(nb, (u % 2 + 1) * half);
        for (int i = (u % 2) * half + c; i < i1; i += 2, ++k) {
          const int hslot = c * kHSlots + k % kHSlots, huse = k / kHSlots;
          if (huse > 0) mbar_wait(h_empty + hslot, (huse - 1) & 1);
          mbar_expect_tx(h_full + hslot, atoms * kBoxBytes);
          for (int a = 0; a < atoms; ++a)
            tma_load(hs + (hslot * 4 + a) * kBoxBytes, &hmap, h_full + hslot,
                     a * kBox, i * kBox);
          const int tslot = c * kTSlots + k % kTSlots, tuse = k / kTSlots;
          if (tuse > 0) mbar_wait(t_empty + tslot, (tuse - 1) & 1);
          mbar_expect_tx(t_full + tslot, kBoxBytes);
          tma_load(ts + tslot * kBoxBytes, &tmap, t_full + tslot,
                   (u / 2) * kBox, i * kBox);
        }
      }
    }
    return;
  }

  // Thread tid holds features 8kc..8kc+7 (kc = tid % 32, of K atom kc / 8)
  // of the tile's items n = tid / 32 + 8r, r < 8, and one bias (tid < 64)
  // or column-mask (64 <= tid < 128) entry. Features past d (the ones
  // column's among them) and items past W are zero.
  const int kc = tid & 31, kf = kc * 8;
  float4 pre[8][2];
  float pre_bc = 0.f;
  auto prefetch = [&](int n0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = (tid >> 5) + 8 * r;
      if (n0 + n < p.W && kf < p.d) {
        if constexpr (kRowsB16) {
          *reinterpret_cast<uint4*>(&pre[r][0]) =
              *reinterpret_cast<const uint4*>(
                  static_cast<const __nv_bfloat16*>(p.rows) +
                  (size_t)(n0 + n) * p.d + kf);
        } else {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(p.rows) + (size_t)(n0 + n) * p.d +
              kf);
          pre[r][0] = src[0];
          pre[r][1] = src[1];
        }
      } else {
        pre[r][0] = pre[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const int col = n0 + (tid & (kBox - 1));
    pre_bc = tid < 2 * kBox && col < p.W
                 ? (tid < kBox ? p.bias[col] : p.col_mask[col])
                 : 0.f;
  };
  if (u0 < u1) prefetch(u0 / 2 * kBox);

  const int c = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int k16 = kK / 16;
  float loss = 0.f;
  float bias_r[16], cm_r[16];  // this thread's 16 columns: 8jj + 2t + cc
  int k = 0;                   // this consumer's row tiles so far
  for (int u = u0; u < u1; ++u) {
    const int n0 = (u / 2) * kBox;
    if (u == u0 || u % 2 == 0) {  // a new item tile
      bar_sync(1, kConsumerThreads);  // both consumers are done with rt
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = (tid >> 5) + 8 * r;
        uint4 packed;
        if constexpr (kRowsB16) {
          packed = *reinterpret_cast<const uint4*>(&pre[r][0]);
        } else {
          const float4 a = pre[r][0], b = pre[r][1];
          const __nv_bfloat162 v0 = __floats2bfloat162_rn(a.x, a.y);
          const __nv_bfloat162 v1 = __floats2bfloat162_rn(a.z, a.w);
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(b.x, b.y);
          const __nv_bfloat162 v3 = __floats2bfloat162_rn(b.z, b.w);
          packed = make_uint4(*reinterpret_cast<const uint32_t*>(&v0),
                              *reinterpret_cast<const uint32_t*>(&v1),
                              *reinterpret_cast<const uint32_t*>(&v2),
                              *reinterpret_cast<const uint32_t*>(&v3));
        }
        *reinterpret_cast<uint4*>(rt + (kc >> 3) * kBoxBytes + n * 128 +
                                  (((kc & 7) ^ (n & 7)) << 4)) = packed;
        // (the copy: from the block holding the tile's first unit only)
        if (!kRowsB16 && p.rows_b != nullptr && u % 2 == 0 &&
            n0 + n < p.W && kf < p.d)
          *reinterpret_cast<uint4*>(p.rows_b + (size_t)(n0 + n) * p.d + kf) =
              packed;
      }
      if (tid < 2 * kBox)
        (tid < kBox ? bias_s : cm_s)[tid & (kBox - 1)] = pre_bc;
      fence_async_smem();
      bar_sync(1, kConsumerThreads);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        bias_r[q] = bias_s[8 * (q >> 1) + 2 * t + (q & 1)];
        cm_r[q] = cm_s[8 * (q >> 1) + 2 * t + (q & 1)];
      }
      const int next = (u / 2 + 1) * 2;  // the next tile's first unit
      if (next < u1) prefetch(next / 2 * kBox);
    }

    const int i1 = min(nb, (u % 2 + 1) * half);
    for (int i = (u % 2) * half + c; i < i1; i += 2, ++k) {
      const int hslot = c * kHSlots + k % kHSlots;
      const int tslot = c * kTSlots + k % kTSlots;
      const unsigned char* const a_tile = hs + hslot * 4 * kBoxBytes;
      float acc[32];
      mbar_wait(h_full + hslot, (k / kHSlots) & 1);
      wgmma_fence();
      wgmma<64, 0, 0>(acc, sw128_desc(a_tile, 16, 1024),
                      sw128_desc(rt, 16, 1024), 0);
      for (int kk = 1; kk < k16; ++kk) {
        const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma<64, 0, 0>(acc, sw128_desc(a_tile + off, 16, 1024),
                        sw128_desc(rt + off, 16, 1024), 1);
      }
      wgmma_commit_wait<64>(acc);
      mbar_arrive(h_empty + hslot);

      mbar_wait(t_full + tslot, (k / kTSlots) & 1);
      unsigned char* const tile_s = ts + tslot * kBoxBytes;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 16 + g + 8 * hf;  // r % 8 == g
        const int row = i * kBox + r;
        const float rm = row < p.B ? p.row_mask[row] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          __nv_bfloat162* const at = reinterpret_cast<__nv_bfloat162*>(
              tile_s + r * 128 + ((jj ^ g) << 4) + t * 4);
          const float2 tv = __bfloat1622float2(*at);
          float e[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float s = round_bf16(acc[4 * jj + 2 * hf + cc] +
                                       bias_r[2 * jj + cc]);
            const float tg = cc ? tv.y : tv.x;
            const float w = rm * cm_r[2 * jj + cc];
            loss += elem_loss(s, tg, kKind, p.confidence) * w;
            e[cc] = elem_dloss(s, tg, kKind, p.confidence) * w;
          }
          if (p.write_e0) *at = __floats2bfloat162_rn(e[0], e[1]);
        }
      }
      if (p.write_e0) fence_async_smem();
      bar_sync(2 + c, 128);
      if ((tid & 127) == 0) {
        if (p.write_e0) tma_store(&emap, tile_s, n0, i * kBox);
        mbar_arrive(t_empty + tslot);
      }
    }
  }
  if ((tid & 127) == 0 && p.write_e0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  loss = warp_sum(loss);
  if (lane == 0) warp_loss[tid >> 5] = loss;
  bar_sync(1, kConsumerThreads);
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kConsumerThreads / 32; ++w) total += warp_loss[w];
    p.partials[blockIdx.x] = total;
  }
}

// The backward's main loop: acc += sum over this block's 64-wide K chunks
// [k0, k1) of A_c B, where each stage brings consumer c's A box (at
// a_coord(c, chunk)) and the B operand's ceil(kN / 64) boxes (at
// b_coord(atom, chunk)) by TMA into a ring of kBwdStages.
template <int kN, int kTA, int kTB, typename ACoord, typename BCoord>
__device__ __forceinline__ void bwd_mainloop(
    const CUtensorMap* amap, const CUtensorMap* bmap, int k0, int k1,
    ACoord a_coord, BCoord b_coord, float (&acc)[kN / 2]) {
  constexpr int kStages = kBwdStages, kConsumers = 2;
  constexpr int kAtoms = ceil_div(kN, kBox);
  constexpr int kStage = (kConsumers + kAtoms) * kBoxBytes;
  constexpr int kConsumerThreads = kConsumers * 128;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* const ring = align1024(wg_smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* const empty = full + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kN / 2; ++q) acc[q] = 0.f;
  if (tid >= kConsumerThreads) {
    if (tid == kConsumerThreads) {
      for (int k = k0; k < k1; ++k) {
        const int s = (k - k0) % kStages, use = (k - k0) / kStages;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* const st = ring + s * kStage;
        mbar_expect_tx(full + s, kStage);
        for (int c = 0; c < kConsumers; ++c) {
          const int2 at = a_coord(c, k);
          tma_load(st + c * kBoxBytes, amap, full + s, at.x, at.y);
        }
        for (int a = 0; a < kAtoms; ++a) {
          const int2 at = b_coord(a, k);
          tma_load(st + (kConsumers + a) * kBoxBytes, bmap, full + s, at.x,
                   at.y);
        }
      }
    }
    return;
  }
  const int c = tid >> 7;
  for (int k = k0; k < k1; ++k) {
    const int s = (k - k0) % kStages;
    const unsigned char* const st = ring + s * kStage;
    mbar_wait(full + s, ((k - k0) / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) {
      // K-major: 16 k are 32 bytes along the row; MN-major: 16 rows of
      // 128 bytes
      const int a_off = kTA ? kk * 2048 : kk * 32;
      const int b_off = kTB ? kk * 2048 : kk * 32;
      wgmma<kN, kTA, kTB>(
          acc, sw128_desc(st + c * kBoxBytes + a_off, kTA ? kBoxBytes : 16,
                          1024),
          sw128_desc(st + kConsumers * kBoxBytes + b_off,
                     kTB ? kBoxBytes : 16, 1024),
          1);
    }
    wgmma_commit_wait<kN>(acc);
    mbar_arrive(empty + s);
  }
}

// [drows | dbias] for 128 items (64 a consumer): M = items, A = E0^T
// (MN-major, E0 as stored), B = hb (MN-major, N = the rung of dp: its
// ones column at d makes accumulator column d the column sums of E0), K
// = the batch.
template <int kN>
__global__ void __launch_bounds__(kBwdThreads, 1)
    drows_dbias_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap emap,
                                  const __grid_constant__ CUtensorMap hmap,
                                  const WgParams p) {
  const int m0 = blockIdx.x * 2 * kBox;
  float acc[kN / 2];
  bwd_mainloop<kN, 1, 1>(
      &emap, &hmap, 0, ceil_div(p.B, kBox),
      [&](int c, int k) { return make_int2(m0 + c * kBox, k * kBox); },
      [&](int a, int k) { return make_int2(a * kBox, k * kBox); }, acc);
  if (threadIdx.x >= 256) return;
  const int c = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale = *p.g;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int item = m0 + c * kBox + warp * 16 + g + 8 * hf;
    if (item >= p.W) continue;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      const float v0 = scale * acc[4 * jj + 2 * hf];
      const float v1 = scale * acc[4 * jj + 2 * hf + 1];
      if (col < p.d) {  // (d % 8 == 0: the pair lies on one side of d)
        if (p.out_b16)
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<__nv_bfloat16*>(p.out) + (size_t)item * p.d +
              col) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(p.out + (size_t)item * p.d + col) =
              make_float2(round_bf16(v0), round_bf16(v1));
      } else if (col == p.d)
        p.dbias[item] = v0;
    }
  }
}

// One split of dh for 128 batch rows (64 a consumer): M = the batch, A =
// E0 (K-major), B = rows_b (MN-major, N = the rung of d), K = this
// split's items; the partial [B, d] of the split goes to out + split * B
// * d, unscaled.
template <int kN>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dh_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap emap,
                         const __grid_constant__ CUtensorMap rmap,
                         const WgParams p) {
  const int r0 = blockIdx.x * 2 * kBox;
  const int k0 = blockIdx.y * p.chunks_per_split;
  const int k1 = min(k0 + p.chunks_per_split, ceil_div(p.W, kBox));
  float acc[kN / 2];
  bwd_mainloop<kN, 0, 1>(
      &emap, &rmap, k0, k1,
      [&](int c, int k) { return make_int2(k * kBox, r0 + c * kBox); },
      [&](int a, int k) { return make_int2(a * kBox, k * kBox); }, acc);
  if (threadIdx.x >= 256) return;
  const int c = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* const out = p.out + (size_t)blockIdx.y * p.B * p.d;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + c * kBox + warp * 16 + g + 8 * hf;
    if (row >= p.B) continue;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj)
      if (8 * jj + 2 * t < p.d)  // (d % 8 == 0: a pair lies on one side)
        *reinterpret_cast<float2*>(out + (size_t)row * p.d + 8 * jj +
                                   2 * t) =
            make_float2(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA descriptor of a [rows, cols] bf16 matrix with row stride ld
// elements (ld * 2 a multiple of 16, a 16-byte aligned base): 64 x 64
// boxes, 128-byte swizzle, zeros outside the matrix.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// what the wgmma route needs beyond bad_args: TMA-describable operands
bool bad_wgmma_args(int B, int W, int d,
                    std::initializer_list<const void*> ptrs) {
  if (bad_args(B, W, d) || d % 8 != 0 || d > kWgMaxD) return true;
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return true;
  return false;
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
    err = allow_smem(decode_loss_fwd_bf16_kernel<true, false>,
                     smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_bf16_kernel<false, false>,
                     smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_bf16_kernel<true, true>,
                     smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(decode_loss_fwd_bf16_kernel<false, true>,
                     smem_bytes_bf16(kFwd));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_bf16_kernel<true>, smem_bytes_bf16(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(drows_dbias_bf16_kernel<false>, smem_bytes_bf16(kDrows));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<true, false>, smem_bytes_bf16(kDh));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<false, false>, smem_bytes_bf16(kDh));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<true, true>, smem_bytes_bf16(kDh));
  if (err == cudaSuccess)
    err = allow_smem(dh_splitk_bf16_kernel<false, true>, smem_bytes_bf16(kDh));
  each_rung(KRungs{}, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    if (err == cudaSuccess)
      err = allow_smem(decode_loss_fwd_bf16_wgmma_kernel<kMse, false, kN>,
                       kFwdSmem);
    if (err == cudaSuccess)
      err = allow_smem(decode_loss_fwd_bf16_wgmma_kernel<kLogistic, false, kN>,
                       kFwdSmem);
    if (err == cudaSuccess)
      err = allow_smem(decode_loss_fwd_bf16_wgmma_kernel<kMse, true, kN>,
                       kFwdSmem);
    if (err == cudaSuccess)
      err = allow_smem(decode_loss_fwd_bf16_wgmma_kernel<kLogistic, true, kN>,
                       kFwdSmem);
    if (err == cudaSuccess)
      err = allow_smem(drows_dbias_bf16_wgmma_kernel<kN>, bwd_smem(kN));
  });
  each_rung(DhRungs{}, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    if (err == cudaSuccess)
      err = allow_smem(dh_bf16_wgmma_kernel<kN>, bwd_smem(kN));
  });
  return err;
}

// Forward: out[0] = masked sum loss; with e0 non-null also E0 [B, lde]
// (float32, or bf16 when bf16 is set: the bf16 variant). target_bf16:
// target holds bfloat16, else float32; ldt: its row stride (>= W). rows_bf16 (the bf16 variant only):
// rows is a bf16 table, else float32. partials: float[out[0] of
// fdl_plan].
int fdl_forward(const float* h, const void* rows, const float* bias,
                const void* target, int target_bf16, int ldt,
                const float* row_mask, const float* col_mask, int B, int W,
                int d, int kind, float confidence, int bf16, int rows_bf16,
                void* e0, int lde, float* partials, float* out, int device,
                void* stream) {
  if (bad_args(B, W, d) || (kind != kMse && kind != kLogistic) ||
      (rows_bf16 && !bf16) || ldt < W ||
      (e0 != nullptr && lde != (bf16 ? round8(W) : round4(W))) ||
      (bf16 && e0 != nullptr && !aligned16(e0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.a = h;
  if (rows_bf16)
    p.bb = static_cast<const __nv_bfloat16*>(rows);
  else
    p.b = static_cast<const float*>(rows);
  p.lda = p.ldb = d;
  p.M = B;
  p.N = W;
  p.K = d;
  p.ktiles = cdiv(d, kBK);
  p.bias = bias;
  p.target = target;
  p.target_bf16 = target_bf16;
  p.ldt = ldt;
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
  // (bf16 rows come 8 elements a copy: whole rows need d % 8 == 0)
  const bool vec = d % (rows_bf16 ? 8 : 4) == 0 && aligned16(h) &&
                   aligned16(rows);
  if (bf16) {
    const size_t smem = smem_bytes_bf16(kFwd);
    if (vec && rows_bf16)
      decode_loss_fwd_bf16_kernel<true, true><<<grid, kThreads, smem, s>>>(p);
    else if (rows_bf16)
      decode_loss_fwd_bf16_kernel<false, true><<<grid, kThreads, smem, s>>>(
          p);
    else if (vec)
      decode_loss_fwd_bf16_kernel<true, false><<<grid, kThreads, smem, s>>>(
          p);
    else
      decode_loss_fwd_bf16_kernel<false, false><<<grid, kThreads, smem, s>>>(
          p);
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
// scalar). rows_bf16 (the bf16 variant only): rows is a bf16 table.
// drows_bf16: drows is written in bf16 (rounded once), else float32.
// ktiles, nsplit: out[1], out[2] of fdl_plan. dh_partials: float[nsplit *
// B * d].
int fdl_backward(const float* g, const void* e0, int lde, const float* h,
                 const void* rows, int rows_bf16, int B, int W, int d,
                 int ktiles, int nsplit, int bf16, float* dh_partials,
                 float* dh, void* drows, int drows_bf16, float* dbias,
                 int device, void* stream) {
  if (bad_args(B, W, d) || lde != (bf16 ? round8(W) : round4(W)) ||
      (rows_bf16 && !bf16) ||
      ktiles < 1 || nsplit < 1 ||
      (long long)ktiles * nsplit < cdiv(W, kBK) ||
      (long long)ktiles * (nsplit - 1) >= cdiv(W, kBK) ||
      (bf16 && !aligned16(e0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bf16 E0 is always copied 16 bytes at a time (lde % 8 == 0); bf16
  // rows 8 elements a copy
  const bool vec = d % (rows_bf16 ? 8 : 4) == 0 &&
                   (bf16 || aligned16(e0)) && aligned16(h) &&
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
  p.out = static_cast<float*>(drows);
  p.out_b16 = drows_bf16;
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

  if (rows_bf16)
    p.bb = static_cast<const __nv_bfloat16*>(rows);
  else
    p.b = static_cast<const float*>(rows);
  p.M = B;
  p.N = d;
  p.K = W;
  p.ktiles = ktiles;
  p.g = nullptr;
  p.out = dh_partials;
  p.out_b16 = 0;
  p.dbias = nullptr;
  const dim3 grid_dh(cdiv(B, kBM), cdiv(d, kBN), nsplit);
  if (bf16) {
    const size_t smem = smem_bytes_bf16(kDh);
    if (vec && rows_bf16)
      dh_splitk_bf16_kernel<true, true><<<grid_dh, kThreads, smem, s>>>(p);
    else if (rows_bf16)
      dh_splitk_bf16_kernel<false, true><<<grid_dh, kThreads, smem, s>>>(p);
    else if (vec)
      dh_splitk_bf16_kernel<true, false><<<grid_dh, kThreads, smem, s>>>(p);
    else
      dh_splitk_bf16_kernel<false, false><<<grid_dh, kThreads, smem, s>>>(p);
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


// The wgmma route's launch plan: out[0] forward blocks (= partials: one an
// SM, each a persistent walk over its units), out[1]
// 64-item chunks per dh split, out[2] dh splits (about one block an SM),
// out[3] lde (W rounded up to 8), out[4] dp (hb's row length: d rounded up
// to 8 past its ones column). Fails where the route does not take the shape.
int fdl_plan_wgmma(int B, int W, int d, int sms, int* out) {
  if (bad_wgmma_args(B, W, d, {}) || sms < 1) return cudaErrorInvalidValue;
  const int chunks = cdiv(W, kBox);
  int splits =
      std::max(1, std::min(chunks, sms / cdiv(B, 2 * kBox)));
  const int per = cdiv(chunks, splits);
  out[0] = std::min(fwd_units(W), sms);
  out[1] = per;
  out[2] = cdiv(chunks, per);
  out[3] = round8(W);
  out[4] = pad_ones(d);
  return cudaSuccess;
}

// The forward of the wgmma route. rows: float32 [W, d], or a bf16 table
// when rows_bf16 is set; target: bf16 [B, W] with row stride ldt (a
// multiple of 8, >= W: TMA reads whole 16-byte runs of a row and fills
// the columns past W with zeros); hb: bf16 [B, dp] scratch
// that this call fills (the backward's B operand of drows); rows_b (bf16
// [W, d]; null with bf16 rows, which the backward reads as they are) and
// e0 (bf16 [B, lde]) may be null: then no copy of rows / no E0 is
// written; E0's columns in [W, lde) are written, as zeros (their item
// rows, bias, column mask and target are all zero there). blocks,
// partials: out[0] of fdl_plan_wgmma and float[blocks].
int fdl_forward_wgmma(const float* h, const void* rows, int rows_bf16,
                      const float* bias, const void* target, int ldt,
                      const float* row_mask, const float* col_mask, int B,
                      int W, int d, int kind, float confidence, void* hb,
                      void* rows_b, void* e0, int blocks, float* partials,
                      float* out, int device, void* stream) {
  if (bad_wgmma_args(B, W, d, {rows, target, hb}) || blocks < 1 ||
      blocks > fwd_units(W) || ldt < W || ldt % 8 != 0 ||
      (kind != kMse && kind != kLogistic) ||
      (rows_b != nullptr && (rows_bf16 || !aligned16(rows_b))) ||
      (e0 != nullptr && !aligned16(e0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = pad_ones(d), lde = round8(W);
  const long long n = (long long)B * dp / 8;
  const int cast_blocks =
      (int)std::min<long long>((n + kThreads - 1) / kThreads, 4096);
  cast_operands_bf16_kernel<<<cast_blocks, kThreads, 0, s>>>(
      h, B, d, dp, static_cast<__nv_bfloat16*>(hb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap hmap, tmap, emap;
  err = bf16_map(&hmap, hb, B, dp, dp);
  if (err == cudaSuccess) err = bf16_map(&tmap, target, B, W, ldt);
  // (without E0 the kernel never reads emap: any valid map will do)
  if (err == cudaSuccess)
    err = e0 ? bf16_map(&emap, e0, B, lde, lde) : bf16_map(&emap, target, B,
                                                             W, ldt);
  if (err != cudaSuccess) return err;
  WgParams p = {};
  p.rows = rows;
  p.bias = bias;
  p.row_mask = row_mask;
  p.col_mask = col_mask;
  p.rows_b = static_cast<__nv_bfloat16*>(rows_b);
  p.partials = partials;
  p.B = B;
  p.W = W;
  p.d = d;
  p.confidence = confidence;
  p.write_e0 = e0 != nullptr;
  on_rung(KRungs{}, d, [&](auto n) {
    constexpr int kK = decltype(n)::value;
    if (kind == kMse && rows_bf16)
      decode_loss_fwd_bf16_wgmma_kernel<kMse, true, kK>
          <<<blocks, kFwdThreads, kFwdSmem, s>>>(hmap, tmap, emap, p);
    else if (kind == kMse)
      decode_loss_fwd_bf16_wgmma_kernel<kMse, false, kK>
          <<<blocks, kFwdThreads, kFwdSmem, s>>>(hmap, tmap, emap, p);
    else if (rows_bf16)
      decode_loss_fwd_bf16_wgmma_kernel<kLogistic, true, kK>
          <<<blocks, kFwdThreads, kFwdSmem, s>>>(hmap, tmap, emap, p);
    else
      decode_loss_fwd_bf16_wgmma_kernel<kLogistic, false, kK>
          <<<blocks, kFwdThreads, kFwdSmem, s>>>(hmap, tmap, emap, p);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return cudaGetLastError();
}

// The backward of the wgmma route from the bf16 E0 [B, lde] and the
// forward's bf16 operands hb [B, dp] and rows_b [W, d] (its copy of the
// rows, or a bf16 table itself). E0 is read through a map of its W
// columns, so that its pad columns are never read (TMA fills zeros past
// W). drows_bf16: drows is written in bf16, else float32 (holding bf16
// values). per, nsplit: out[1], out[2] of fdl_plan_wgmma; dh_partials:
// float[nsplit * B * d].
int fdl_backward_wgmma(const float* g, const void* e0, const void* hb,
                       const void* rows_b, int B, int W, int d, int per,
                       int nsplit, float* dh_partials, float* dh,
                       void* drows, int drows_bf16, float* dbias, int device,
                       void* stream) {
  const int chunks = cdiv(W, kBox);
  if (bad_wgmma_args(B, W, d, {e0, hb, rows_b}) || per < 1 ||
      nsplit < 1 || (long long)per * nsplit < chunks ||
      (long long)per * (nsplit - 1) >= chunks)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = pad_ones(d), lde = round8(W);
  CUtensorMap emap, hmap, rmap;
  err = bf16_map(&emap, e0, B, W, lde);
  if (err == cudaSuccess) err = bf16_map(&hmap, hb, B, dp, dp);
  if (err == cudaSuccess) err = bf16_map(&rmap, rows_b, W, d, d);
  if (err != cudaSuccess) return err;
  WgParams p = {};
  p.g = g;
  p.B = B;
  p.W = W;
  p.d = d;
  p.chunks_per_split = per;
  const dim3 grid_rows(cdiv(W, 2 * kBox)), grid_dh(cdiv(B, 2 * kBox), nsplit);
  p.out = static_cast<float*>(drows);
  p.out_b16 = drows_bf16;
  p.dbias = dbias;
  on_rung(KRungs{}, dp, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    drows_dbias_bf16_wgmma_kernel<kN>
        <<<grid_rows, kBwdThreads, bwd_smem(kN), s>>>(emap, hmap, p);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.out = dh_partials;
  p.out_b16 = 0;
  p.dbias = nullptr;
  on_rung(DhRungs{}, d, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    dh_bf16_wgmma_kernel<kN>
        <<<grid_dh, kBwdThreads, bwd_smem(kN), s>>>(emap, rmap, p);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)B * d;
  const int sum_blocks = (int)std::min<long long>((n + kThreads - 1) / kThreads,
                                                  4096);
  sum_splits_bf16_kernel<<<sum_blocks, kThreads, 0, s>>>(dh_partials, nsplit,
                                                         n, g, dh);
  return cudaGetLastError();
}

}  // extern "C"
