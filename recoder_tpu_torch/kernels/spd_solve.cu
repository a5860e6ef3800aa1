// Batched SPD solve -- Cholesky factor, forward and back substitution -- for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of recoder_tpu/ops/spd.py:
// _chol_solve_kernel, reached through _spd_solve_pallas's pl.pallas_call,
// with the defaults spd_solve calls it with (no panel update, no iterative
// refinement). For B systems A [B, d, d] (symmetric positive definite,
// float32, row-major, contiguous; only the lower triangle is read) and
// right-hand sides b [B, d], it writes x [B, d] with A x = b:
//
//   A = L L^T          right-looking Cholesky, one column per step
//   L y = b            forward substitution
//   L^T x = y          back substitution
//
// The TPU kernel factors A = U^T U with U = L^T; the arithmetic is the same
// up to float32 rounding order. A matrix that is not positive definite
// meets a pivot <= 0, whose 1/sqrt is NaN or inf, and the whole x of that
// system comes out NaN, as jnp.linalg.cholesky gives NaN; nothing clamps it.
//
// What bounds it on this card: at the iALS shape (B = 16,384, d = 128) the
// factorization is d^3/3 = 0.7M multiply-adds per system, 11.5 G in all, and
// the kernel reads half of each 64 KiB matrix once (0.5 GiB). Each
// multiply-add of the trailing update reads and writes one shared-memory
// word and reads two words of a shared column buffer, so the kernel is
// bound by shared-memory bandwidth and by the d block-wide barriers of the
// column loop, well below the card's float32 rate.
//
// Design (one block per system; nothing carries between blocks, so every
// system's result depends only on its own A and b and on d -- not on B, nor
// on its neighbours in the batch, bit for bit):
//   * The lower triangle lives in dynamic shared memory, packed by rows
//     (row i at offset i(i+1)/2): 32.25 KiB at d = 128, 128.5 KiB at
//     d = 256. A full 256 x 256 float32 matrix (256 KiB) would not fit the
//     227 KiB a block may have; the packed triangle does, so every
//     d in 1..256 takes the same path.
//   * Step k reads column k of the current Schur complement from a double
//     buffer, writes the finished column k of L, and applies the rank-1
//     update to the trailing triangle; the updated column k + 1 goes to the
//     other buffer. One __syncthreads per step. Warps take rows, lanes take
//     columns, so each warp touches consecutive words of a packed row.
//   * The substitutions run in one warp: forward as a dot product with row k
//     of L (contiguous), backward as an update of y with row k of L
//     (contiguous), both in a fixed order.
// The TPU kernel's R = 32 row blocks, identity-padded batch and lane masks
// are artefacts of its (8, 128) tiling and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// packed triangle + two column buffers + the right-hand side
size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)tri(d) + 3 * (size_t)d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, int d) {
  extern __shared__ float smem[];
  float* l = smem;           // packed lower triangle: A, then L
  float* col = l + tri(d);   // [2][d] Schur column of the current step
  float* y = col + 2 * d;    // [d] b, then y, then x
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long sys = blockIdx.x;
  const float* as = a + sys * d * d;

  for (int i = warp; i < d; i += kWarps) {
    const float* row = as + (long long)i * d;
    for (int j = lane; j <= i; j += 32) l[tri(i) + j] = row[j];
    if (lane == 0) col[i] = row[0];
  }
  for (int i = threadIdx.x; i < d; i += kThreads) y[i] = b[sys * d + i];
  __syncthreads();

  for (int k = 0; k < d; ++k) {
    const float* ck = col + (k & 1) * d;     // column k, read this step
    float* cn = col + ((k + 1) & 1) * d;     // column k + 1, written
    const float r = 1.f / sqrtf(ck[k]);
    // column k of L (the diagonal entry is pivot * r, as the TPU kernel
    // scales its row k)
    for (int i = k + threadIdx.x; i < d; i += kThreads)
      l[tri(i) + k] = ck[i] * r;
    // rank-1 update of the trailing triangle k < j <= i < d
    for (int i = k + 1 + warp; i < d; i += kWarps) {
      const float li = ck[i] * r;
      float* row = l + tri(i);
      for (int j = k + 1 + lane; j <= i; j += 32) {
        const float v = fmaf(-li, ck[j] * r, row[j]);
        row[j] = v;
        if (j == k + 1) cn[i] = v;
      }
    }
    __syncthreads();
  }

  if (warp != 0) return;
  // L y = b: y_k = (b_k - L[k, :k] . y[:k]) / L_kk
  for (int k = 0; k < d; ++k) {
    const float* row = l + tri(k);
    float s = 0.f;
    for (int j = lane; j < k; j += 32) s = fmaf(row[j], y[j], s);
    s = warp_sum(s);
    if (lane == 0) y[k] = (y[k] - s) / row[k];
    __syncwarp();
  }
  // L^T x = y: x_k = y_k / L_kk, then y[:k] -= L[k, :k] * x_k
  for (int k = d - 1; k >= 0; --k) {
    const float* row = l + tri(k);
    const float xk = y[k] / row[k];
    __syncwarp();
    for (int j = lane; j < k; j += 32) y[j] = fmaf(-row[j], xk, y[j]);
    if (lane == 0) y[k] = xk;
    __syncwarp();
  }
  for (int i = lane; i < d; i += 32) x[sys * d + i] = y[i];
}

}  // namespace

extern "C" {

int spd_max_d() { return kMaxD; }

const char* spd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, d] = solve(a [B, d, d], b [B, d]) on `stream` of `device`.
int spd_solve_batched(const float* a, const float* b, float* x, int B, int d,
                      int device, void* stream) {
  if (B < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(d);
  err = cudaFuncSetAttribute(spd_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  spd_solve_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, x, d);
  return cudaGetLastError();
}

}  // extern "C"
