// The multinomial loss (the softmax NLL over the item axis) and its
// gradient in two passes, bf16 or float32 -- for Hopper (sm_90a).
//
// No Pallas ancestor: the JAX package leaves this loss to XLA, which fuses
// recoder_tpu/ops/losses.py multinomial_nll_loss and its gradient; no TPU
// kernel is replaced. It computes what the port's plain chain computes
// (ops/losses.py multinomial_nll_loss, summed: ops/multinomial_loss.py
// multinomial_nll_plain) over the scores s [B, W] and the target t [B, W]
// (each bf16 or float32, read as float32), the column mask cm [W] and the
// row mask rm [B] (float32; none: ones). Over a row's valid columns (cm != 0):
//
//   m  = max s            z = sum exp(s - m)          lz = log z
//   T  = sum cm t         A = sum cm t (s - m)
//   loss = sum over rows of rm (T lz - A)
//   g  = go rm (T exp(s - m - lz) - cm t) at valid columns, 0 elsewhere
//
// go the upstream gradient of the sum (read from device memory: no host
// read, so a captured step replays it). Every sum is float32, as the chain's;
// the gradient is the float32 value rounded once to the scores' dtype, as the
// chain's `input.float()` backward rounds it. The sums take another order
// than PyTorch's reductions (the loss agrees to float32 rounding, a bf16
// gradient within a bf16 ulp but where the float32 difference of its two
// terms cancels). A masked row or column gets an exact 0; a row without a
// valid column has loss 0.
//
// What bounds it on this card: bytes. The forward reads s and t, the
// backward reads them again and writes g: 2 x (s + t) + g bytes, 5 x 2 B W in
// bf16 -- at Mult-VAE's ML-20M step ([500, 20,224]) 101.1 MB, 30.2 us at
// 3.35 TB/s. The plain chain makes some sixty passes over [B, W] in float32
// (casts, the mask's select, max, exp, sums, log, the masks' products, and
// their backward).
//
// Design: nothing of size [B, W] but g reaches device memory. The forward
// (mnll_fwd_kernel) gives each block of 128 threads a segment of one row: a
// thread keeps a running (m, z, A, T) over 8 columns at a time (16-byte
// loads of bf16, two of float32), rebased when the maximum grows, so the row
// is read once; the block combines its threads' in a fixed order and writes
// one float4. A row is cut into as many segments as fill the card's thread
// slots once (5 for Mult-VAE's 500 rows of 20,224 on 132 SMs; hundreds for
// a few rows of a 1M-item catalog). One block (mnll_finish_kernel) combines
// each row's segments, over up to 32 lanes in a fixed tree, into (m, lz, T)
// and sums the row losses in a fixed order: no float atomics, so two runs,
// and a captured step and an eager one, give the same bits. The backward
// (mnll_bwd_kernel) re-reads s and t -- s often from L2, which the product
// that wrote it and the forward have just filled -- and writes g in one
// pass, over the forward's segments. (One group of 8 columns at a time a
// thread, in blocks of 128, measured faster than 2 or 4 groups in flight or
// blocks of 64, 256 or 512: fewer registers, more blocks resident.) A width
// or a row stride that is not a multiple of 8, an operand not 16-byte
// aligned, or scores and target of two dtypes take the same kernels with
// one element a load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;
// the blocks of a pass: at least what the card's SMs hold at once (by
// threads), so that few rows are split into segments
constexpr int kBlocksPerSM = 2048 / kThreads;
constexpr int kMaxSegments = 65535;  // gridDim.y

typedef unsigned short bf16_t;  // bf16 bits

// A [B, W] operand: bf16 or float32, row stride ld elements.
struct Operand {
  const void* p;
  long long ld;
  bool bf16;
};

__device__ __forceinline__ const void* row_of(Operand x, long long row) {
  return static_cast<const char*>(x.p) + row * x.ld * (x.bf16 ? 2 : 4);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load8(const bf16_t* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
  v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
  v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// Element c of a row of either dtype.
__device__ __forceinline__ float load1(const void* row, bool bf16, int c) {
  if (bf16)
    return __uint_as_float(
        static_cast<uint32_t>(__ldg(static_cast<const bf16_t*>(row) + c))
        << 16);
  return __ldg(static_cast<const float*>(row) + c);
}

__device__ __forceinline__ bf16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store8(bf16_t* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = static_cast<uint32_t>(to_bf16(v[2 * j])) |
           (static_cast<uint32_t>(to_bf16(v[2 * j + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The 8 columns from column c of a row: s, t and the column mask's weight w
// (0 past the row's end; the column is valid where w != 0). T:
// the element type of both operands, 8 of them a 16-byte load (W % 8 == 0,
// aligned rows); void: either dtype, one element a load.
template <typename T>
__device__ __forceinline__ void load_group(const void* sr, bool s_bf16,
                                           const void* tr, bool t_bf16,
                                           const float* cm, int c, int W,
                                           float (&s)[8], float (&t)[8],
                                           float (&w)[8]) {
  if constexpr (std::is_void<T>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = c + j < W;
      s[j] = in ? load1(sr, s_bf16, c + j) : 0.0f;
      t[j] = in ? load1(tr, t_bf16, c + j) : 0.0f;
      w[j] = in ? (cm != nullptr ? __ldg(cm + c + j) : 1.0f) : 0.0f;
    }
  } else {
    load8(static_cast<const T*>(sr) + c, s);
    load8(static_cast<const T*>(tr) + c, t);
    if (cm != nullptr) {
      load8(cm + c, w);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = 1.0f;
    }
  }
}

// The 8 gradient elements from column c of a row (g's dtype the scores').
template <typename T>
__device__ __forceinline__ void store_group(void* gr, bool bf16, int c, int W,
                                            const float (&o)[8]) {
  if constexpr (std::is_void<T>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c + j >= W) break;
      if (bf16)
        static_cast<bf16_t*>(gr)[c + j] = to_bf16(o[j]);
      else
        static_cast<float*>(gr)[c + j] = o[j];
    }
  } else {
    store8(static_cast<T*>(gr) + c, o);
  }
}

// A running (m, z, A, T) over some of a row's valid columns; z == 0: none
// yet (a valid column adds exp(0) = 1 at its maximum).
struct Stats {
  float m, z, a, tw;
};

__device__ __forceinline__ Stats no_columns() {
  return {-CUDART_INF_F, 0.0f, 0.0f, 0.0f};
}

// The same sums about a larger maximum m.
__device__ __forceinline__ void rebase(Stats& st, float m) {
  if (st.z != 0.0f) {
    st.z *= expf(st.m - m);
    st.a -= st.tw * (m - st.m);
  }
  st.m = m;
}

__device__ __forceinline__ Stats combine(Stats x, Stats y) {
  if (y.z == 0.0f) return x;
  if (x.z == 0.0f) return y;
  const float m = fmaxf(x.m, y.m);
  rebase(x, m);
  rebase(y, m);
  return {m, x.z + y.z, x.a + y.a, x.tw + y.tw};
}

__device__ __forceinline__ void add_group(Stats& st, const float (&s)[8],
                                          const float (&t)[8],
                                          const float (&w)[8]) {
  float gm = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (w[j] != 0.0f) gm = fmaxf(gm, s[j]);
  if (gm > st.m) rebase(st, gm);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (w[j] != 0.0f) {
      const float d = s[j] - st.m;
      const float wt = w[j] * t[j];
      st.z += expf(d);
      st.tw += wt;
      st.a += wt * d;
    }
  }
}

__device__ __forceinline__ Stats shfl_xor(Stats st, int o) {
  return {__shfl_xor_sync(0xffffffffu, st.m, o),
          __shfl_xor_sync(0xffffffffu, st.z, o),
          __shfl_xor_sync(0xffffffffu, st.a, o),
          __shfl_xor_sync(0xffffffffu, st.tw, o)};
}

// The block's stats, combined in a fixed order, in thread 0.
__device__ __forceinline__ Stats block_combine(Stats st) {
  __shared__ Stats warp_stats[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) st = combine(st, shfl_xor(st, o));
  if ((threadIdx.x & 31) == 0) warp_stats[threadIdx.x >> 5] = st;
  __syncthreads();
  Stats total = no_columns();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = combine(total, warp_stats[w]);
  }
  return total;
}

// grid (B, S): block (row, segment) reduces the row's column groups [seg x
// gps, (seg + 1) x gps) to part[row x S + seg] = (m, z, A, T).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mnll_fwd_kernel(Operand s, Operand t, int W, int gps,
                const float* __restrict__ cm, float4* __restrict__ part) {
  const long long row = blockIdx.x;
  const int ng = (W + 7) >> 3;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(g0 + gps, ng);
  const void* sr = row_of(s, row);
  const void* tr = row_of(t, row);
  Stats st = no_columns();
  for (int g = g0 + threadIdx.x; g < g1; g += kThreads) {
    float sv[8], tv[8], wv[8];
    load_group<T>(sr, s.bf16, tr, t.bf16, cm, g << 3, W, sv, tv, wv);
    add_group(st, sv, tv, wv);
  }
  st = block_combine(st);
  if (threadIdx.x == 0)
    part[row * gridDim.y + blockIdx.y] = make_float4(st.m, st.z, st.a, st.tw);
}

// One block: each row's S segments combined into stats[row] = (m, lz, T)
// (0, 0, 0 for a row without a valid column), and the sum over rows of rm
// (T lz - A) in a fixed order into out[0]. A row takes 2^lg neighbouring
// lanes (lg <= 5; more where S is large and B small): lane k of them
// combines segments k, k + 2^lg, ... in order, then the lanes' stats
// combine in a fixed tree.
__global__ void __launch_bounds__(kFinishThreads)
mnll_finish_kernel(const float4* __restrict__ part, int S, int B, int lg,
                   const float* __restrict__ rm, float* __restrict__ stats,
                   float* __restrict__ out) {
  __shared__ float warp_sums[kFinishThreads / 32];
  const int lanes = 1 << lg;
  const int sub = threadIdx.x & (lanes - 1);
  float acc = 0.0f;
  // (every lane runs every pass, for the shuffles)
  for (long long b0 = 0; b0 < B; b0 += kFinishThreads >> lg) {
    const long long b = b0 + (threadIdx.x >> lg);
    Stats st = no_columns();
    if (b < B) {
      for (int k = sub; k < S; k += lanes) {
        const float4 p = part[b * S + k];
        st = combine(st, {p.x, p.y, p.z, p.w});
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) st = combine(st, shfl_xor(st, o));
    if (b < B && sub == 0) {
      float m = 0.0f, lz = 0.0f, tw = 0.0f, loss = 0.0f;
      if (st.z != 0.0f) {
        m = st.m;
        lz = logf(st.z);
        tw = st.tw;
        loss = tw * lz - st.a;
      }
      stats[3 * b] = m;
      stats[3 * b + 1] = lz;
      stats[3 * b + 2] = tw;
      acc += (rm != nullptr ? rm[b] : 1.0f) * loss;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kFinishThreads / 32; ++w) total += warp_sums[w];
    out[0] = total;
  }
}

// grid (B, S): g [B, W] (rows contiguous, the scores' dtype) over the
// forward's segments.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mnll_bwd_kernel(Operand s, Operand t, int W, int gps,
                const float* __restrict__ cm, const float* __restrict__ rm,
                const float* __restrict__ stats, const float* __restrict__ go,
                void* __restrict__ g) {
  const long long row = blockIdx.x;
  const int ng = (W + 7) >> 3;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(g0 + gps, ng);
  const void* sr = row_of(s, row);
  const void* tr = row_of(t, row);
  void* gr = static_cast<char*>(g) + row * W * (s.bf16 ? 2 : 4);
  const float m = stats[3 * row], lz = stats[3 * row + 1];
  const float c = __ldg(go) * (rm != nullptr ? rm[row] : 1.0f);
  const float ct = c * stats[3 * row + 2];
  for (int gi = g0 + threadIdx.x; gi < g1; gi += kThreads) {
    float sv[8], tv[8], wv[8], o[8];
    load_group<T>(sr, s.bf16, tr, t.bf16, cm, gi << 3, W, sv, tv, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = wv[j] != 0.0f ? ct * expf(sv[j] - m - lz) - c * (wv[j] * tv[j])
                           : 0.0f;
    store_group<T>(gr, s.bf16, gi << 3, W, o);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The column groups of a segment for S segments of a row of W columns.
int groups_per_segment(int W, int S) {
  const int ng = (W + 7) / 8;
  return (ng + S - 1) / S;
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess)
      return 0;
    counts[device] = n;
  }
  return counts[device];
}

// Whether the vector kernels take the operands: one dtype, W and the row
// strides multiples of 8, every pointer 16-byte aligned.
bool vec_ok(Operand s, Operand t, int W, const void* cm, const void* g) {
  return s.bf16 == t.bf16 && W % 8 == 0 && s.ld % 8 == 0 && t.ld % 8 == 0 &&
         aligned16(s.p) && aligned16(t.p) &&
         (cm == nullptr || aligned16(cm)) && (g == nullptr || aligned16(g));
}

bool sizes_ok(Operand s, Operand t, int B, int W, int S) {
  return s.p != nullptr && t.p != nullptr && B >= 1 && W >= 1 && s.ld >= W &&
         t.ld >= W && S >= 1 && S <= kMaxSegments &&
         S <= groups_per_segment(W, 1);
}

template <typename T>
void launch_fwd(dim3 grid, cudaStream_t st, Operand s, Operand t, int W,
                int gps, const float* cm, float4* part) {
  mnll_fwd_kernel<T><<<grid, kThreads, 0, st>>>(s, t, W, gps, cm, part);
}

template <typename T>
void launch_bwd(dim3 grid, cudaStream_t st, Operand s, Operand t, int W,
                int gps, const float* cm, const float* rm,
                const float* stats, const float* go, void* g) {
  mnll_bwd_kernel<T><<<grid, kThreads, 0, st>>>(s, t, W, gps, cm, rm, stats,
                                                go, g);
}

}  // namespace

extern "C" {

const char* mnll_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The segments a row is split into for B rows of W columns on `device`
// (0 where B or W is 0 or the device cannot be read): enough blocks to
// fill the card, each thread at least one group of 8 columns.
int mnll_segments(int B, int W, int device) {
  if (B < 1 || W < 1) return 0;
  const int sms = sm_count(device);
  if (sms == 0) return 0;
  const long long want = static_cast<long long>(sms) * kBlocksPerSM;
  const int ng = groups_per_segment(W, 1);
  long long S = (want + B - 1) / B;
  const long long most = (ng + kThreads - 1) / kThreads;
  if (S > most) S = most;
  if (S > kMaxSegments) S = kMaxSegments;
  if (S < 1) S = 1;
  // no empty segment
  const int gps = groups_per_segment(W, static_cast<int>(S));
  return (ng + gps - 1) / gps;
}

// The forward: stats [B, 3] float32 = (m, lz, T) a row and out[0] the
// loss's sum, from s [B, W] (row stride lds elements; bf16 where s_bf16,
// else float32) and t [B, W] (ldt, t_bf16), the masks cm [W] and rm [B]
// (float32, or null: ones), over S segments a row (mnll_segments), with
// part [B x S] float4 of scratch. Runs on `stream` of `device`; returns a
// CUDA error code (0 on success); a request the kernels do not take is
// refused before anything is launched.
int mnll_forward(const void* s, int s_bf16, long long lds, const void* t,
                 int t_bf16, long long ldt, int B, int W, int S,
                 const void* cm, const void* rm, void* part, void* stats,
                 void* out, int device, void* stream) {
  const Operand so{s, lds, s_bf16 != 0}, to{t, ldt, t_bf16 != 0};
  if (!sizes_ok(so, to, B, W, S) || part == nullptr || stats == nullptr ||
      out == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, S);
  const int gps = groups_per_segment(W, S);
  const float* cmf = static_cast<const float*>(cm);
  float4* p = static_cast<float4*>(part);
  if (!vec_ok(so, to, W, cm, nullptr))
    launch_fwd<void>(grid, st, so, to, W, gps, cmf, p);
  else if (so.bf16)
    launch_fwd<bf16_t>(grid, st, so, to, W, gps, cmf, p);
  else
    launch_fwd<float>(grid, st, so, to, W, gps, cmf, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the finish's lanes a row: as many as S's tree takes (up to 32), while
  // every row still fits in one pass of the block
  int lg = 0;
  while (lg < 5 && (1 << lg) < S &&
         (static_cast<long long>(B) << (lg + 1)) <= kFinishThreads)
    ++lg;
  mnll_finish_kernel<<<1, kFinishThreads, 0, st>>>(
      p, S, B, lg, static_cast<const float*>(rm), static_cast<float*>(stats),
      static_cast<float*>(out));
  return cudaGetLastError();
}

// The backward: g [B, W] (rows contiguous, the scores' dtype) from the
// forward's operands, its stats and go[0] (float32), the upstream gradient
// of the sum.
int mnll_backward(const void* s, int s_bf16, long long lds, const void* t,
                  int t_bf16, long long ldt, int B, int W, int S,
                  const void* cm, const void* rm, const void* stats,
                  const void* go, void* g, int device, void* stream) {
  const Operand so{s, lds, s_bf16 != 0}, to{t, ldt, t_bf16 != 0};
  if (!sizes_ok(so, to, B, W, S) || stats == nullptr || go == nullptr ||
      g == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, S);
  const int gps = groups_per_segment(W, S);
  const float* cmf = static_cast<const float*>(cm);
  const float* rmf = static_cast<const float*>(rm);
  const float* sf = static_cast<const float*>(stats);
  const float* gof = static_cast<const float*>(go);
  if (!vec_ok(so, to, W, cm, g))
    launch_bwd<void>(grid, st, so, to, W, gps, cmf, rmf, sf, gof, g);
  else if (so.bf16)
    launch_bwd<bf16_t>(grid, st, so, to, W, gps, cmf, rmf, sf, gof, g);
  else
    launch_bwd<float>(grid, st, so, to, W, gps, cmf, rmf, sf, gof, g);
  return cudaGetLastError();
}

}  // extern "C"
