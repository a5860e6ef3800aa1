// Fused Adam step with bfloat16 storage, for Hopper (sm_90a).
//
// No Pallas ancestor: this is how the JAX package's Optimizer('adam')
// over bf16 storage (recoder_tpu/optim.py, update: state_dtype='bfloat16'
// moments and/or params_dtype='bfloat16' parameters, whose gradients are
// bf16 too) runs on this card. For every dense parameter tensor, in one
// launch, elementwise in float32 and in JAX's order of operations, each
// stored value upcast first:
//
//   g  = g + wd * p                     (wd = 0 for biases; p upcast)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - (lr / bc1 * m') / (sqrt(v') / sqrt(bc2) + eps)
//   p = store(p'),  m = store(m'),  v = store(v')
//
// with the UNROUNDED m' and v' in the parameter update, store() the
// round to nearest even of a bf16 buffer (a float32 one keeps the value),
// and bc1 = 1 - b1^t, bc2 = 1 - b2^t computed in float32 on the host
// (ops/adam.py). Built with -fmad=false (kernels/__init__.py), so no
// multiply-add is contracted and the plain version (the same operations
// as separate PyTorch ops) gives the same bits.
//
// adam_bf16_kernel<P, M> is built for the three storage pairs the JAX
// package's modes reach: float32 parameters with bf16 moments
// (opt_state_dtype='bfloat16', bench.py's ML-20M default), bf16
// parameters with bf16 moments, and bf16 parameters with float32 moments
// (params_dtype='bfloat16' alone). P is the parameters' type (a bf16
// parameter's gradient is bf16), M the moments'. float32 throughout is
// torch.optim.Adam's.
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
// A float32 parameter that a bf16 product reads whole keeps a bf16 working
// copy beside it (optim.Bf16Adam): its descriptor names the copy w, and the
// kernel stores w = store_bf16(p') from the float32 p' it stores to p, the
// round to nearest even that p.to(bf16) does, so the copy is bitwise
// p.to(bf16) after every step. The product's backward leaves that
// parameter's gradient in bf16 (what p.to(bf16)'s backward upcast to
// float32): a descriptor says its gradient's type, and a bf16 gradient is
// upcast in registers, which gives the float32 value exactly.
//
// Bound: bytes. One pass reads p, g, m and v and writes p, m and v: 20 B
// a parameter for float32 p / bf16 m (with a working copy, a 2-byte
// gradient read and the 2-byte copy written: the same 20 B), 14 B for bf16
// p / bf16 m, 22 B for bf16 p / float32 m, against 28 B of float32 state
// for torch.optim.Adam (8.11 M parameters at the ML-20M shape: 162 MB,
// 0.048 ms at 3.35 TB/s, at float32 p / bf16 m). Design: every tensor of the
// parameter set in one launch; a block takes a chunk of kChunk elements of
// one tensor, found by a binary search over a descriptor table that lives
// in device memory (built once per parameter set by the wrapper; a
// kernel-parameter array indexed by blockIdx would be copied to local
// memory in every thread), and moves 8 elements of each buffer a thread a
// step (16-byte words: one for a bf16 buffer, two for a float32 one) where
// the tensor allows it. Each descriptor names its storage types; one that
// disagrees with the launch's instantiation traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements a block
constexpr int kVec = 8;  // elements a thread moves a step (16-byte words)
constexpr int kTableCols = 8;  // floats a row of the step-scalar table

// One parameter tensor. ops/adam.py packs this layout (80 bytes).
struct Desc {
  void* p;
  const void* g;
  void* m;
  void* v;
  void* w;           // the bf16 working copy of a float32 p, or null
  long long n;       // elements
  long long chunk0;  // the tensor's first chunk (block) in the launch
  float wd;          // weight decay
  int vec;           // n % kVec == 0 and every buffer 16-byte aligned
  int p_bf16;        // p is bf16, else float32
  int m_bf16;        // m and v are bf16, else float32
  int g_bf16;        // g is bf16, else float32 (a bf16 p's is bf16)
  int unused;
};
static_assert(sizeof(Desc) == 80, "ops/adam.py packs this layout");

struct Consts {
  float lr_bc1, b1, omb1, b2, omb2, sqrt_bc2, eps;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float up(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T store(float x);
template <>
__device__ __forceinline__ float store<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 store<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec consecutive elements, as one (bf16) or two (float) 16-byte words
template <typename T>
struct alignas(16) Pack {
  T x[kVec];
};

// the element's step; returns the new parameter in float32 (what is
// stored to a float32 p, and rounded into its working copy)
template <typename P, typename G, typename M>
__device__ __forceinline__ float adam_elem(P& p, G g, M& m, M& v, float wd,
                                           const Consts& c) {
  const float p32 = up(p);
  const float g32 = up(g) + wd * p32;
  const float m1 = c.b1 * up(m) + c.omb1 * g32;
  const float v1 = c.b2 * up(v) + (c.omb2 * g32) * g32;
  const float denom = sqrtf(v1) / c.sqrt_bc2 + c.eps;
  const float p1 = p32 - (c.lr_bc1 * m1) / denom;
  p = store<P>(p1);
  m = store<M>(m1);
  v = store<M>(v1);
  return p1;
}

// elements [base, end) of the tensor ``d``: P, G, M its parameter,
// gradient and moment types, kCopy whether it has a working copy
template <typename P, typename G, typename M, bool kCopy>
__device__ __forceinline__ void adam_range(const Desc& d, const Consts& c,
                                           long long base, long long end) {
  P* const pp = static_cast<P*>(d.p);
  const G* const gp = static_cast<const G*>(d.g);
  M* const mp = static_cast<M*>(d.m);
  M* const vp = static_cast<M*>(d.v);
  bf16* const wp = static_cast<bf16*>(d.w);
  if (d.vec) {
    for (long long i = base + kVec * threadIdx.x; i < end;
         i += kVec * kThreads) {
      Pack<P> p = *reinterpret_cast<const Pack<P>*>(pp + i);
      const Pack<G> g = *reinterpret_cast<const Pack<G>*>(gp + i);
      Pack<M> m = *reinterpret_cast<const Pack<M>*>(mp + i);
      Pack<M> v = *reinterpret_cast<const Pack<M>*>(vp + i);
      Pack<bf16> w;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float p1 = adam_elem(p.x[q], g.x[q], m.x[q], v.x[q], d.wd, c);
        if (kCopy) w.x[q] = __float2bfloat16_rn(p1);
      }
      *reinterpret_cast<Pack<P>*>(pp + i) = p;
      *reinterpret_cast<Pack<M>*>(mp + i) = m;
      *reinterpret_cast<Pack<M>*>(vp + i) = v;
      if (kCopy) *reinterpret_cast<Pack<bf16>*>(wp + i) = w;
    }
  } else {
    for (long long i = base + threadIdx.x; i < end; i += kThreads) {
      const float p1 = adam_elem(pp[i], gp[i], mp[i], vp[i], d.wd, c);
      if (kCopy) wp[i] = __float2bfloat16_rn(p1);
    }
  }
}

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    adam_bf16_kernel(const Desc* __restrict__ descs, int ntensors,
                     const float* __restrict__ table, int nrows,
                     const long long* __restrict__ ctl) {
  constexpr int kPBf16 = sizeof(P) == 2, kMBf16 = sizeof(M) == 2;
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
  if (d.p_bf16 != kPBf16 || d.m_bf16 != kMBf16) __trap();  // another launch's
  const long long base = ((long long)blockIdx.x - d.chunk0) * kChunk;
  const long long end = min(base + (long long)kChunk, d.n);
  if constexpr (kPBf16) {
    // a bf16 parameter: its gradient is bf16 and it has no working copy
    if (!d.g_bf16 || d.w != nullptr) __trap();
    adam_range<P, P, M, false>(d, c, base, end);
  } else if (d.g_bf16) {
    if (d.w != nullptr)
      adam_range<float, bf16, M, true>(d, c, base, end);
    else
      adam_range<float, bf16, M, false>(d, c, base, end);
  } else {
    if (d.w != nullptr)
      adam_range<float, float, M, true>(d, c, base, end);
    else
      adam_range<float, float, M, false>(d, c, base, end);
  }
}

__global__ void adam_advance_kernel(long long* ctl) { ctl[0] += 1; }

}  // namespace

extern "C" {

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int adam_chunk() { return kChunk; }

int adam_vec() { return kVec; }

int adam_desc_bytes() { return (int)sizeof(Desc); }

int adam_table_cols() { return kTableCols; }

// One step over the ntensors descriptors at `descs` (device memory),
// nchunks blocks in all (the sum of each tensor's ceil(n / kChunk)), with
// the scalars of row ctl[0] - ctl[1] of `table` ([nrows, kTableCols]
// float32, device memory); then ctl[0] += 1, on the same stream. p_bf16,
// m_bf16: the storage pair of every descriptor (float32 / float32 is
// refused: torch.optim.Adam's); each descriptor says its gradient's type
// and whether it has a working copy, so one launch steps a mixed set.
int adam_bf16_step(const void* descs, int ntensors, int nchunks,
                   const float* table, int nrows, long long* ctl, int p_bf16,
                   int m_bf16, int device, void* stream) {
  if (descs == nullptr || ntensors < 1 || nchunks < 1 || table == nullptr ||
      nrows < 1 || ctl == nullptr || !(p_bf16 || m_bf16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Desc* d = static_cast<const Desc*>(descs);
  if (!p_bf16)
    adam_bf16_kernel<float, bf16>
        <<<nchunks, kThreads, 0, s>>>(d, ntensors, table, nrows, ctl);
  else if (m_bf16)
    adam_bf16_kernel<bf16, bf16>
        <<<nchunks, kThreads, 0, s>>>(d, ntensors, table, nrows, ctl);
  else
    adam_bf16_kernel<bf16, float>
        <<<nchunks, kThreads, 0, s>>>(d, ntensors, table, nrows, ctl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adam_advance_kernel<<<1, 1, 0, s>>>(ctl);
  return cudaGetLastError();
}

}  // extern "C"
