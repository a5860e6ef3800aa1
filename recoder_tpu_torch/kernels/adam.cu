// Fused Adam step with bfloat16 moments, for Hopper (sm_90a).
//
// No Pallas ancestor: this is how the JAX package's
// Optimizer('adam', state_dtype='bfloat16') (recoder_tpu/optim.py,
// update) runs on this card. For every dense parameter tensor, in one
// launch, elementwise in float32 and in JAX's order of operations:
//
//   g  = g + wd * p                     (wd = 0 for biases)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p  = p - (lr / bc1 * m') / (sqrt(v') / sqrt(bc2) + eps)
//   m  = bf16_rn(m'),  v = bf16_rn(v')
//
// with the UNROUNDED m' and v' in the parameter update and bc1 = 1 - b1^t,
// bc2 = 1 - b2^t computed in float32 on the host (ops/adam.py). Built
// with -fmad=false (kernels/__init__.py), so no multiply-add is
// contracted and the plain version (the same operations as separate
// PyTorch ops) gives the same bits.
//
// The step's scalars come from device memory, so that a captured CUDA
// graph replays every step with its own: the host writes a table of
// them, one row of kTableCols floats per step (lr / bc1, b1, 1 - b1, b2,
// 1 - b2, sqrt(bc2), eps, unused), and a control pair ctl = [steps
// taken, the step before the table's first row] says which row this
// launch reads: ctl[0] - ctl[1]. A second one-thread kernel then adds
// one to ctl[0]. bc1 and bc2 stay host arithmetic: a device powf may
// differ from numpy's by an ulp. A row outside the table traps.
//
// Bound: bytes. One pass reads p and g (float32) and m and v (bf16) and
// writes p, m and v: 20 B a parameter against 28 B of float32 state for
// torch.optim.Adam (8.11 M parameters at the ML-20M shape: 162 MB, 0.048
// ms at 3.35 TB/s). Design: every tensor of the parameter set in one
// launch; a block takes a chunk of kChunk elements of one tensor, found
// by a binary search over a descriptor table that lives in device memory
// (built once per parameter set by the wrapper; a kernel-parameter array
// indexed by blockIdx would be copied to local memory in every thread),
// and moves 16 bytes of p and g and 8 bytes of m and v a thread a step
// where the tensor allows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements a block
constexpr int kTableCols = 8;  // floats a row of the step-scalar table

// One parameter tensor. ops/adam.py packs this layout (56 bytes).
struct Desc {
  float* p;
  const float* g;
  __nv_bfloat16* m;
  __nv_bfloat16* v;
  long long n;       // elements
  long long chunk0;  // the tensor's first chunk (block) in the launch
  float wd;          // weight decay
  int vec;           // n % 4 == 0, p and g 16-byte and m, v 8-byte aligned
};
static_assert(sizeof(Desc) == 56, "ops/adam.py packs this layout");

struct Consts {
  float lr_bc1, b1, omb1, b2, omb2, sqrt_bc2, eps;
};

__device__ __forceinline__ void adam_elem(float& p, float g,
                                          __nv_bfloat16& m, __nv_bfloat16& v,
                                          float wd, const Consts& c) {
  g = g + wd * p;
  const float m1 = c.b1 * __bfloat162float(m) + c.omb1 * g;
  const float v1 = c.b2 * __bfloat162float(v) + (c.omb2 * g) * g;
  const float denom = sqrtf(v1) / c.sqrt_bc2 + c.eps;
  p = p - (c.lr_bc1 * m1) / denom;
  m = __float2bfloat16_rn(m1);
  v = __float2bfloat16_rn(v1);
}

__global__ void __launch_bounds__(kThreads)
    adam_bf16_kernel(const Desc* __restrict__ descs, int ntensors,
                     const float* __restrict__ table, int nrows,
                     const long long* __restrict__ ctl) {
  __shared__ int which;
  __shared__ float row_vals[kTableCols];
  if (threadIdx.x < kTableCols) {
    const long long row = ctl[0] - ctl[1];
    if (row < 0 || row >= nrows) __trap();  // the host did not cover it
    row_vals[threadIdx.x] = table[row * kTableCols + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    // the last tensor whose first chunk is at or before this block
    int lo = 0, hi = ntensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (descs[mid].chunk0 <= (long long)blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    which = lo;
  }
  __syncthreads();
  const Consts c = {row_vals[0], row_vals[1], row_vals[2], row_vals[3],
                    row_vals[4], row_vals[5], row_vals[6]};
  const Desc d = descs[which];
  const long long base = ((long long)blockIdx.x - d.chunk0) * kChunk;
  const long long end = min(base + (long long)kChunk, d.n);
  if (d.vec) {
    for (long long i = base + 4 * threadIdx.x; i < end;
         i += 4 * kThreads) {
      float4 p = *reinterpret_cast<const float4*>(d.p + i);
      const float4 g = __ldg(reinterpret_cast<const float4*>(d.g + i));
      uint2 mb = *reinterpret_cast<const uint2*>(d.m + i);
      uint2 vb = *reinterpret_cast<const uint2*>(d.v + i);
      __nv_bfloat16* m = reinterpret_cast<__nv_bfloat16*>(&mb);
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&vb);
      adam_elem(p.x, g.x, m[0], v[0], d.wd, c);
      adam_elem(p.y, g.y, m[1], v[1], d.wd, c);
      adam_elem(p.z, g.z, m[2], v[2], d.wd, c);
      adam_elem(p.w, g.w, m[3], v[3], d.wd, c);
      *reinterpret_cast<float4*>(d.p + i) = p;
      *reinterpret_cast<uint2*>(d.m + i) = mb;
      *reinterpret_cast<uint2*>(d.v + i) = vb;
    }
  } else {
    for (long long i = base + threadIdx.x; i < end; i += kThreads) {
      float p = d.p[i];
      adam_elem(p, d.g[i], d.m[i], d.v[i], d.wd, c);
      d.p[i] = p;
    }
  }
}

__global__ void adam_advance_kernel(long long* ctl) { ctl[0] += 1; }

}  // namespace

extern "C" {

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int adam_chunk() { return kChunk; }

int adam_table_cols() { return kTableCols; }

// One step over the ntensors descriptors at `descs` (device memory),
// nchunks blocks in all (the sum of each tensor's ceil(n / kChunk)), with
// the scalars of row ctl[0] - ctl[1] of `table` ([nrows, kTableCols]
// float32, device memory); then ctl[0] += 1, on the same stream.
int adam_bf16_step(const void* descs, int ntensors, int nchunks,
                   const float* table, int nrows, long long* ctl, int device,
                   void* stream) {
  if (descs == nullptr || ntensors < 1 || nchunks < 1 || table == nullptr ||
      nrows < 1 || ctl == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adam_bf16_kernel<<<nchunks, kThreads, 0, s>>>(
      static_cast<const Desc*>(descs), ntensors, table, nrows, ctl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adam_advance_kernel<<<1, 1, 0, s>>>(ctl);
  return cudaGetLastError();
}

}  // extern "C"
