// Batched SPD solve -- a panel-blocked Cholesky factorization with the
// forward substitution folded in, then a panel-blocked back substitution --
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of recoder_tpu/ops/spd.py:
// _chol_solve_kernel (spd.py:122), reached through _spd_solve_pallas's
// pl.pallas_call (spd.py:235), with the defaults spd_solve calls it with
// (no _PANEL, no _REFINE). For B systems A [B, d, d] (symmetric positive
// definite, float32, row-major, contiguous; only the lower triangle is
// used) and right-hand sides b [B, d], it writes x [B, d] with A x = b.
// The right-hand side is carried as row d of the bordered matrix
//
//   [ A   . ]   [ L    0 ] [ L^T  y ]
//   [ b^T . ] = [ y^T  . ] [ 0    . ]      A = L L^T,  L y = b,
//
// so the factorization's own updates leave y in that row; then L^T x = y.
// The TPU kernel factors A = U^T U with U = L^T; the arithmetic is the same
// up to float32 rounding order. A matrix that is not positive definite meets
// a pivot <= 0 (or NaN); the whole x of that system is then written as NaN,
// as jnp.linalg.cholesky gives NaN. Nothing clamps the pivot and nothing
// exits early; other systems of the batch are unaffected.
//
// Work per system: the factorization's trailing updates are
// sum_k (d - k)^2 / 2 ~ d^3/6 multiply-adds, the bordered row and the back
// substitution d^2/2 each: d^3/3 + 2 d^2 operations. At the iALS shape
// (B = 16,384, d = 128) that is 12.0 GFLOP, 179 us at the card's 67 TFLOP/s
// float32 FMA rate, while the bytes -- each lower triangle, b and x once,
// 558 MB -- take 167 us at 3.35 TB/s. Bytes set the bound (0.1665 ms), with
// the FMA floor right beside it; all arithmetic is float32 FMA.
//
// What held a column-at-a-time kernel back, and what this design does:
//   * d serial column steps, each ending in a block barrier -> panels of
//     kNB = 16 columns, two block barriers a panel (16 at d = 128, plus two
//     a panel in the back substitution). Per panel: (a) one warp factors
//     the 16 x 16 diagonal block in registers, rows on lanes, by shuffles,
//     while its other half-warp inverts it with the same instructions;
//     (b) every thread takes whole rows below it (the bordered row
//     included) and multiplies them by the block's inverse transpose, read
//     as shared-memory broadcasts; (c) the trailing update
//     A22 -= L21 L21^T (and b2 -= L21 y1 in the bordered row).
//   * 1/sqrt of each pivot in every thread -> in one warp, whose next pivot
//     is sent ahead of the rest of its update.
//   * Three shared-memory accesses per multiply-add, on ragged packed rows
//     -> 8 x 4 register tiles of the lower triangle, 12 16-byte loads feeding
//     128 multiply-adds (0.375 words each), the bordered row in 1 x 4 tiles.
//     While the other warps update, warp 0 updates the next panel's
//     diagonal block (2 x 4 tiles) and factors it: a look-ahead of one panel.
//   * 2d serial substitution steps in one warp -> the forward substitution
//     rides in the bordered row; the back substitution goes by panels, each
//     a 16-wide product with the stored inverse and an update of the rest.
//   * Storage: the lower triangle in blocks of 16 rows, row r holding
//     columns 0 .. 16 (r / 16 + 1) - 1, rows padded to an odd number of
//     16-byte units, blocks offset by two units and the units of rows 8..15
//     of a block swapped in pairs, so a warp's tile loads spread over the
//     banks; the swizzle depends on r mod 16 alone, so the panels' addresses
//     are constants. 39.7 KB at d = 128 (at most 128 registers a thread keep
//     four blocks resident an SM); 144.9 KB at d = 256. Warp 0 loads the
//     first diagonal block and factors it while the others load the rest.
//   * d is padded up to a multiple of 16 inside shared memory only: an
//     identity diagonal and a zero right-hand side. Pad terms are products
//     with exact zeros, so the real entries' arithmetic is unchanged.
// One block per system, and every loop's order depends only on d (which
// thread computes an entry never changes its arithmetic), so a system's x
// depends only on its own A, b and d -- not on B nor on its position in the
// batch -- bit for bit. tools/torch_spd_variants.py builds variants of this
// file, checks and times them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;   // resident blocks an SM at d = 128
constexpr int kMaxD = 256;
constexpr int kNB = 16;         // panel width, and the rows of a storage block
constexpr unsigned kFull = 0xffffffffu;

// d padded to whole panels
__host__ __device__ __forceinline__ int padded(int d) {
  return (d + kNB - 1) / kNB * kNB;
}

// Offset in floats of row r. Block I holds rows 16 I .. 16 I + 15, each
// stride(r) = 16 (I + 1) + 4 floats long, of which the first 16 (I + 1) are
// columns, and 8 floats of padding follow it; row n, after the padded
// matrix, holds the bordered right-hand side and is row 0 of block n / 16.
__host__ __device__ __forceinline__ int row_at(int r) {
  const int blk = r >> 4;
  return 64 * blk * (2 * blk + 3) + 8 * blk + (r & 15) * (16 * blk + 20);
}

__host__ __device__ __forceinline__ int stride(int r) {
  return 16 * (r >> 4) + 20;
}

// The column swizzle of row r: rows 8 .. 15 of a block swap the 16-byte
// units of each group of 16 columns in pairs. With the odd stride in units
// and the blocks' padding, the 16-byte loads of lanes on rows 4 apart (the
// trailing update's tiles) spread over the banks. It depends on r mod 16
// alone, so row c0 + j of a panel (c0 a multiple of 16) has the swizzle of
// row j, known at compile time, and row n has none.
__host__ __device__ __forceinline__ int swz(int r) { return (r & 8) >> 1; }

__host__ __device__ __forceinline__ int at(int r, int k) {
  return row_at(r) + (k ^ swz(r));
}

// columns row r stores
__device__ __forceinline__ int row_len(int r, int n) {
  return r < n ? 16 * ((r >> 4) + 1) : n;
}

// the factor, the bordered row and a failure flag
size_t smem_bytes(int d) {
  const int n = padded(d);
  return sizeof(float) * ((size_t)row_at(n) + n + 1);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned dst_s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst_s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s - a . b, the products taken in order
__device__ __forceinline__ float sub_dot4(float s, float4 a, float4 b) {
  s = fmaf(-a.x, b.x, s);
  s = fmaf(-a.y, b.y, s);
  s = fmaf(-a.z, b.z, s);
  return fmaf(-a.w, b.w, s);
}

// Columns k .. k + 3 of row r of the padded, bordered system into shared
// memory: A's lower triangle (zero above the diagonal), the identity in the
// pad, b in row n. A unit wholly inside the matrix goes by cp.async when
// rows are 16-byte aligned (a unit across the diagonal brings A's upper
// entries along, which are never read); the rest is fetched and stored by
// the thread.
__device__ __forceinline__ void load_unit(float* l, const float* as,
                                          const float* bs, int r, int k,
                                          int d, int n, bool vec) {
  float* dst = l + at(r, k);
  if (vec && r < d && k <= r && k + 3 < d) {
    cp_async16(dst, as + (long long)r * d + k);
    return;
  }
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < d) {
    const float* row = as + (long long)r * d;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (k + c <= r) e[c] = __ldg(row + k + c);
  } else if (r < n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = k + c == r ? 1.f : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (k + c < d) e[c] = __ldg(bs + k + c);
  }
  st4(dst, make_float4(e[0], e[1], e[2], e[3]));
}

// (a) The diagonal block of the panel at column c0, in one warp: lane i
// holds row c0 + i of the block in v, and lane i + kNB holds column z of
// its inverse there, starting from e_i. Step k takes pivot k's 1/sqrt r,
// sends the next pivot ahead, and each lane scales v[k] by r: L[i][k] in
// the lower lanes, z_k = (e_i[k] - sum_{m<k} L[k][m] z_m) / L[k][k] in the
// upper ones.
// Column k of L is shuffled from the lower lanes, and one multiply-add a
// lane applies it to both halves: the rank-1 update of the rows and the
// forward substitution of the inverse. No shared memory and no block
// barrier inside; only L_pp^-1 is stored, over L_pp's lower triangle:
// nothing reads L_pp.
__device__ __forceinline__ void factor_diagonal(float* l, int c0, int lane,
                                                bool& bad) {
  const int i = lane % kNB;
  const bool inverse = lane >= kNB;
  float* blk = l + row_at(c0) + c0;  // the block's row 0, column c0
  const int w = stride(c0);
  const float* row = blk + i * w;
  float v[kNB];
#pragma unroll
  for (int u = 0; u < kNB / 4; ++u) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!inverse && 4 * u <= i) t = ld4(row + ((4 * u) ^ swz(i)));
    v[4 * u] = t.x; v[4 * u + 1] = t.y; v[4 * u + 2] = t.z;
    v[4 * u + 3] = t.w;
  }
  if (inverse) {
#pragma unroll
    for (int j = 0; j < kNB; ++j) v[j] = j == i ? 1.f : 0.f;
  }
  float piv = __shfl_sync(kFull, v[0], 0);
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    bad |= !(piv > 0.f);
    const float r = rsqrtf(piv);
    const float c = v[k] * r;  // L[row][k], or z_k; lane k's is pivot * r
    v[k] = c;
    if (k + 1 < kNB) {
      // the next pivot, as lane k + 1's update below will leave it: sent
      // ahead of that update, it shortens the chain from pivot to pivot
      piv = __shfl_sync(kFull, fmaf(-c, c, v[k + 1]), k + 1);
    }
#pragma unroll
    for (int j = k + 1; j < kNB; ++j)
      v[j] = fmaf(-c, __shfl_sync(kFull, c, j), v[j]);  // L[j][k]
  }
  if (inverse) {
#pragma unroll
    for (int j = 0; j < kNB; ++j)
      if (j >= i) blk[j * w + (i ^ swz(j))] = v[j];
  }
}

// (b) Rows below the diagonal block, and the bordered row n: row i's panel
// entries a become a L_pp^-T, L[i][c0 ..] (y[c0 ..] in row n). One thread a
// row, sixteen independent dot products with the rows of L_pp^-1, read as
// broadcasts.
__device__ __forceinline__ void panel_solve(float* l, int c0, int n,
                                            int tid) {
  const float* blk = l + row_at(c0) + c0;
  const int w = stride(c0);
  for (int i = c0 + kNB + tid; i <= n; i += kThreads) {
    float* row = l + row_at(i) + c0;
    const int sw = swz(i);
    float a[kNB];
#pragma unroll
    for (int u = 0; u < kNB / 4; ++u) {
      const float4 t = ld4(row + ((4 * u) ^ sw));
      a[4 * u] = t.x; a[4 * u + 1] = t.y; a[4 * u + 2] = t.z;
      a[4 * u + 3] = t.w;
    }
    float v[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u <= j / 4; ++u) {
        const float4 t = ld4(blk + j * w + ((4 * u) ^ swz(j)));
        const float inv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * u + c <= j) s = fmaf(a[4 * u + c], inv[c], s);
      }
      v[j] = s;
    }
#pragma unroll
    for (int u = 0; u < kNB / 4; ++u)
      st4(row + ((4 * u) ^ sw),
          make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]));
  }
}

// (c) One R x 4 tile of the trailing update by the panel at c0: rows
// i0 .. i0 + R - 1, columns j0 .. j0 + 3, A[i][j] -= sum_k L[i][k] L[j][k]
// over the panel's kNB columns, in column order. Each row group lies in one
// storage block and shares a swizzle (i0 a multiple of R, R in {1, 2, 8};
// j0 a multiple of 4). Each group of four panel columns reads R + 4
// 16-byte units for 16 R multiply-adds.
template <int R>
__device__ __forceinline__ void update_tile(float* l, int c0, int i0,
                                            int j0) {
  const int wi = stride(i0), wj = stride(j0);
  const int si = swz(i0), sj = swz(j0);
  float* xi = l + row_at(i0);
  const float* yj = l + row_at(j0);
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = ld4(xi + r * wi + (j0 ^ si));
#pragma unroll
  for (int u = 0; u < kNB / 4; ++u) {
    const int ki = c0 + ((4 * u) ^ si), kj = c0 + ((4 * u) ^ sj);
    float4 y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = ld4(yj + c * wj + kj);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = ld4(xi + r * wi + ki);
      acc[r].x = sub_dot4(acc[r].x, x, y[0]);
      acc[r].y = sub_dot4(acc[r].y, x, y[1]);
      acc[r].z = sub_dot4(acc[r].z, x, y[2]);
      acc[r].w = sub_dot4(acc[r].w, x, y[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) st4(xi + r * wi + (j0 ^ si), acc[r]);
}

// (c) Warp 0's share of the trailing update by the panel at c0: the next
// panel's diagonal block, in 20 tiles of 2 x 4, ahead of the rest (row pair
// p holds tiles C(p) .. C(p + 1) - 1, with C(2a) = a (a + 1) and
// C(2a + 1) = (a + 1)^2); warp 0 goes on to factor it.
__device__ __forceinline__ void update_diagonal(float* l, int c0, int lane) {
  if (lane >= 20) return;
  int p = 0;
#pragma unroll
  for (int q = 1; q < 8; ++q)
    if (lane >= (q & 1 ? (q / 2 + 1) * (q / 2 + 1) : q / 2 * (q / 2 + 1)))
      p = q;
  const int first = p & 1 ? (p / 2 + 1) * (p / 2 + 1) : p / 2 * (p / 2 + 1);
  update_tile<2>(l, c0, c0 + kNB + 2 * p, c0 + kNB + 4 * (lane - first));
}

// (c) The other warps' share: the rest of the lower triangle in tiles of
// 8 x 4, numbered row by row (the diagonal block's own six come first and
// are skipped), then the bordered row in tiles of 1 x 4.
__device__ __forceinline__ void update_trailing(float* l, int c0, int n,
                                                int t) {
  const int t0 = c0 + kNB;
  const int m = (n - t0) / 8;  // tile rows of 8; row ti has 2 ti + 2 tiles
  const int main_tiles = m * (m + 1);
  const int tiles = main_tiles + (n - t0) / 4;
  for (t += 6; t < tiles; t += kThreads - 32) {
    if (t < main_tiles) {
      int ti = (int)((sqrtf(4.f * t + 1.f) - 1.f) * 0.5f);
      if (ti * (ti + 1) > t) --ti;
      if ((ti + 1) * (ti + 2) <= t) ++ti;
      update_tile<8>(l, c0, t0 + 8 * ti, t0 + 4 * (t - ti * (ti + 1)));
    } else {
      update_tile<1>(l, c0, n, t0 + 4 * (t - main_tiles));
    }
  }
}

// L^T x = y, y in row n, by panels from the last: sixteen threads take
// x_i = sum_m L_pp^-1[m][i] y_m over the panel, then every thread takes one
// remaining entry of y and subtracts the panel rows' products, in a fixed
// order.
__device__ __forceinline__ void back_substitute(float* l, int n, int tid) {
  float* yrow = l + row_at(n);  // n is a multiple of 16: no swizzle
  for (int c0 = n - kNB; c0 >= 0; c0 -= kNB) {
    const float* blk = l + row_at(c0);  // the panel's rows, from column 0
    const int w = stride(c0);
    if (tid < 32) {
      const int i = tid % kNB;
      float y[kNB];
#pragma unroll
      for (int u = 0; u < kNB / 4; ++u) {
        const float4 t = ld4(yrow + c0 + 4 * u);
        y[4 * u] = t.x; y[4 * u + 1] = t.y; y[4 * u + 2] = t.z;
        y[4 * u + 3] = t.w;
      }
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kNB; ++m) {
        const float inv = blk[m * w + ((c0 + i) ^ swz(m))];
        s = fmaf(m >= i ? inv : 0.f, y[m], s);
      }
      __syncwarp();
      if (tid < kNB) yrow[c0 + i] = s;
    }
    __syncthreads();
    for (int j = tid; j < c0; j += kThreads) {
      float s = yrow[j];
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        s = fmaf(-blk[k * w + (j ^ swz(k))], yrow[c0 + k], s);
      yrow[j] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, int d, int vec_loads) {
  extern __shared__ __align__(16) float smem[];
  const int n = padded(d);
  float* l = smem;
  int* failed = reinterpret_cast<int*>(l + row_at(n) + n);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long sys = blockIdx.x;
  const float* as = a + sys * d * d;
  const float* bs = b + sys * d;
  const bool vec = vec_loads != 0;

  // Step c0 = -kNB loads the system: warp 0 the first diagonal block, which
  // it factors at once, the other warps rows kNB .. n. Each later step
  // solves the panel at c0 (b), then updates the trailing matrix (c) while
  // warp 0 updates and factors the next diagonal block (a).
  bool bad = false;  // kept by warp 0, which sees every pivot
  for (int c0 = -kNB; c0 < n; c0 += kNB) {
    if (c0 >= 0) {
      panel_solve(l, c0, n, tid);
      __syncthreads();
      if (c0 + kNB == n) break;
    }
    if (warp == 0) {
      if (c0 < 0) {
        for (int q = lane; q < kNB * kNB / 4; q += 32)
          load_unit(l, as, bs, q / (kNB / 4), 4 * (q % (kNB / 4)), d, n, vec);
        cp_async_wait_all();
      } else {
        update_diagonal(l, c0, lane);
      }
      __syncwarp();
      factor_diagonal(l, c0 + kNB, lane, bad);
    } else if (c0 < 0) {
      for (int r = kNB + warp - 1; r <= n; r += kWarps - 1)
        for (int k = 4 * lane; k < row_len(r, n); k += 128)
          load_unit(l, as, bs, r, k, d, n, vec);
      cp_async_wait_all();
    } else {
      update_trailing(l, c0, n, tid - 32);
    }
    __syncthreads();
  }
  if (tid == 0) *failed = bad;
  back_substitute(l, n, tid);

  const bool fail = *failed != 0;
  for (int j = tid; j < d; j += kThreads)
    x[sys * d + j] = fail ? __int_as_float(0x7fffffff) : l[at(n, j)];
}

cudaError_t prepare(int d, int device, size_t* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *smem = smem_bytes(d);
  return cudaFuncSetAttribute(spd_solve_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

int spd_max_d() { return kMaxD; }

const char* spd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dynamic shared memory a block takes at width d, and how many blocks
// of kThreads threads an SM keeps resident.
int spd_occupancy(int d, int device, int* smem_bytes_out, int* blocks_per_sm) {
  if (d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = prepare(d, device, &smem);
  if (err != cudaSuccess) return err;
  *smem_bytes_out = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, spd_solve_kernel, kThreads, smem);
}

// x [B, d] = solve(a [B, d, d], b [B, d]) on `stream` of `device`.
int spd_solve_batched(const float* a, const float* b, float* x, int B, int d,
                      int device, void* stream) {
  if (B < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = prepare(d, device, &smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  spd_solve_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, x, d, vec);
  return cudaGetLastError();
}

}  // extern "C"
