// The encoder's noised input in one pass, bf16 -- for Hopper (sm_90a).
//
// No Pallas ancestor: the JAX package leaves this chain to XLA's fusion
// (recoder_tpu/models/base.py l2_normalize_rows, then dropout). It computes
// what the port's plain chain computes over a step's rows x [B, W] bf16
// (ops/noised_input.py noised_input_plain), rounding where it rounds:
//
//   s    = sum over the row of float(x)^2           (float32)
//   norm = bf16(max(sqrt(s), 1e-12))
//   z1   = bf16(float(x) / float(norm))             (true division)
//   z    = keep ? bf16(float(z1) * scale) : 0       (scale = 1 / keep prob)
//
// The scale is a multiply by the reciprocal because that is how PyTorch
// divides a CUDA tensor by a host scalar (x / keep): the wrapper computes
// the reciprocal in float32, as PyTorch does. Without a mask (no noise, or
// not training) z = z1. The keep mask is the caller's, one byte an element
// (bool / uint8); any non-zero byte keeps. The sum of
// squares takes another order than PyTorch's reduction, so a row's norm can
// differ from the plain chain's by a float32 rounding before its bf16
// rounding (z within one bf16 ulp); a row of zeros and ones sums exactly.
//
// What bounds it on this card: bytes. It reads x once, the mask once and
// writes z once: (4 + mask bytes) x B x W bytes. At the ML-20M step ([500,
// 20,224], a one-byte mask) that is 50.6 MB, 15.1 us at 3.35 TB/s; at MSD's
// [500, 41,216] 103.0 MB, 30.8 us. The plain chain it replaces makes about
// ten passes over [B, W] (a float32 copy, square, sum, divide, the mask's
// cast, a second divide, zeros, select).
//
// Design: one block of kThreads a row, nothing held between the two
// passes. The first pass reads the row in 16-byte vectors, kUnroll of them
// in flight a thread, and sums their squares (warp shuffles, then the warps
// in a fixed order); the second reads the row again -- from L2, where the
// first pass has just put it (the rows in flight at once, two blocks an SM,
// are 11 or 22 MB, well under L2's 50 MB) -- with its mask bytes, and writes
// z in 16-byte stores. Reading x twice costs L2 bandwidth, not HBM's, and
// spares the block shared memory and any wait on other blocks, so one row's
// writes overlap another's reads: x and the mask are read once from device
// memory and z written once. (Holding the row in shared memory, or splitting
// it over a cluster whose blocks add their sums, measured slower.) The
// division takes the IEEE route only for non-zero elements (a zero dividend
// sends it down its slow path), the bulk of a row of interactions being
// zeros. A row whose width or stride is not a multiple of 8, or an operand
// not aligned for the vector loads, takes noised_input_bf16_scalar_kernel,
// one element a thread at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread

enum MaskKind { kNoMask = 0, kByteMask = 1 };

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_bits_to_float(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float add_square(float acc, float v) {
  return __fadd_rn(acc, __fmul_rn(v, v));
}

__device__ __forceinline__ float square_sum8(float acc, uint4 v) {
  acc = add_square(acc, bf16_lo(v.x));
  acc = add_square(acc, bf16_hi(v.x));
  acc = add_square(acc, bf16_lo(v.y));
  acc = add_square(acc, bf16_hi(v.y));
  acc = add_square(acc, bf16_lo(v.z));
  acc = add_square(acc, bf16_hi(v.z));
  acc = add_square(acc, bf16_lo(v.w));
  acc = add_square(acc, bf16_hi(v.w));
  return acc;
}

// The row's sum of the threads' partial sums, in a fixed order, in every
// thread of the block.
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, warp_sums[w]);
  return total;
}

// float(bf16(max(sqrt(s), 1e-12))), NaN kept as torch.clamp keeps it.
__device__ __forceinline__ float row_norm(float s) {
  const float r = __fsqrt_rn(s);
  const float n = (r != r) ? r : fmaxf(r, 1e-12f);
  return __bfloat162float(__float2bfloat16_rn(n));
}

// One element of z. A zero quotient is the zero itself (its sign kept)
// unless the norm is NaN: most of a row of interactions is zeros, and the
// IEEE division sends a zero dividend down its slow path.
__device__ __forceinline__ unsigned short noised(float v, float norm,
                                                 bool keep, float scale) {
  if (!keep) return 0;
  const float q = (v == 0.0f && norm == norm) ? v : __fdiv_rn(v, norm);
  const float z1 = __bfloat162float(__float2bfloat16_rn(q));
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(z1, scale)));
}

__device__ __forceinline__ uint32_t pack(unsigned short lo,
                                         unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// A vector's 8 mask bytes (none without a mask).
template <int kMask>
__device__ __forceinline__ uint2 load_mask(const unsigned char* mask_row,
                                           int i) {
  if (kMask == kNoMask) return make_uint2(0u, 0u);
  return __ldcs(reinterpret_cast<const uint2*>(mask_row) + i);
}

// Bit j set: element j of the 8 is kept.
template <int kMask>
__device__ __forceinline__ uint32_t keep_bits(uint2 m) {
  if (kMask == kNoMask) return 0xffu;
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bits |= ((m.x >> (8 * j)) & 0xffu) ? (1u << j) : 0u;
    bits |= ((m.y >> (8 * j)) & 0xffu) ? (1u << (j + 4)) : 0u;
  }
  return bits;
}

__device__ __forceinline__ uint4 noised8(uint4 v, uint32_t keep, float norm,
                                         float scale) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = pack(noised(bf16_lo(w[j]), norm, (keep >> (2 * j)) & 1u, scale),
                noised(bf16_hi(w[j]), norm, (keep >> (2 * j + 1)) & 1u,
                       scale));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// W % 8 == 0, ldx % 8 == 0, x and z 16-byte aligned, the mask 8-byte
// aligned: one block a row.
template <int kMask>
__global__ void __launch_bounds__(kThreads)
noised_input_bf16_kernel(const uint4* __restrict__ x, long long ldx, int W,
                         const unsigned char* __restrict__ mask, float scale,
                         uint4* __restrict__ z) {
  const long long row = blockIdx.x;
  const int nv = W >> 3;
  const uint4* xr = x + row * (ldx >> 3);
  uint4* zr = z + row * nv;
  const unsigned char* mr = kMask == kNoMask ? nullptr : mask + row * W;
  float acc = 0.0f;
  for (int base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < nv ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = square_sum8(acc, v[u]);
  }
  const float norm = row_norm(block_sum(acc));
  for (int base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
    uint2 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < nv) {
        m[u] = load_mask<kMask>(mr, i);
        v[u] = __ldg(xr + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < nv)
        zr[i] = noised8(v[u], keep_bits<kMask>(m[u]), norm, scale);
    }
  }
}

// Any width, stride and alignment: one element a thread at a time, the row
// read twice.
template <int kMask>
__global__ void __launch_bounds__(kThreads)
noised_input_bf16_scalar_kernel(const unsigned short* __restrict__ x,
                                long long ldx, int W,
                                const unsigned char* __restrict__ mask,
                                float scale, unsigned short* __restrict__ z) {
  const long long row = blockIdx.x;
  const unsigned short* xr = x + row * ldx;
  unsigned short* zr = z + row * W;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < W; c += kThreads)
    acc = add_square(acc, bf16_bits_to_float(xr[c]));
  const float norm = row_norm(block_sum(acc));
  for (int c = threadIdx.x; c < W; c += kThreads) {
    const bool keep = kMask == kNoMask || mask[row * W + c] != 0;
    zr[c] = noised(bf16_bits_to_float(xr[c]), norm, keep, scale);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int kMask>
cudaError_t launch(const void* x, long long ldx, int B, int W,
                   const unsigned char* mask, float scale, void* z,
                   cudaStream_t s) {
  const bool vec = W % 8 == 0 && ldx % 8 == 0 && aligned(x, 16) &&
                   aligned(z, 16) && (kMask == kNoMask || aligned(mask, 8));
  if (!vec) {
    noised_input_bf16_scalar_kernel<kMask><<<B, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(x), ldx, W, mask, scale,
        static_cast<unsigned short*>(z));
    return cudaGetLastError();
  }
  noised_input_bf16_kernel<kMask><<<B, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), ldx, W, mask, scale,
      static_cast<uint4*>(z));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ni_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z [B, W] bf16 (rows contiguous) from x [B, W] bf16 (row stride ldx
// elements): each row L2-normalized, then, with a mask ([B, W] contiguous,
// one byte an element), the kept elements scaled by `scale` and the others
// zero; a null mask: z is the normalized rows (pass scale 1). Runs on
// `stream` of `device`. Returns a CUDA error code (0 on success); a request
// the kernels do not take is refused before anything is launched.
int ni_noised_input(const void* x, long long ldx, int B, int W,
                    const void* mask, float scale, void* z, int device,
                    void* stream) {
  if (x == nullptr || z == nullptr || B < 0 || W < 1 || ldx < W)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  if (m == nullptr) return launch<kNoMask>(x, ldx, B, W, m, scale, z, s);
  return launch<kByteMask>(x, ldx, B, W, m, scale, z, s);
}

}  // extern "C"
