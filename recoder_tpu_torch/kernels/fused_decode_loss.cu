// Fused decode-score + masked loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of recoder_tpu/experiments/pallas_loss.py:
// _fwd_kernel (reached through _fwd_call's pl.pallas_call) and _bwd_kernel
// (through _bwd_call). It computes, for h [B, d], rows [W, d], bias [W],
// target [B, W], row_mask [B] and col_mask [W] (all float32, row-major,
// contiguous):
//
//   S      = h @ rows^T + bias                          (never stored)
//   loss   = sum_ij  l(S_ij, T_ij) * row_mask_i * col_mask_j
//   E_ij   = l'(S_ij, T_ij) * g * row_mask_i * col_mask_j  (never stored)
//   dh     = E @ rows,   drows = E^T @ h,   dbias = sum_i E_ij
//
// with l the confidence-weighted MSE (1 + c*[t>0]) * (s - t)^2 or the
// BCE-with-logits max(s,0) - s*t + log1p(exp(-|s|)).
//
// What bounds it on this card: at the training shape (B=500, d=200,
// W=20,224) the three products are 4 GFLOP each and the [B, W] score and
// cotangent matrices are 40 MB each in float32. The Pallas kernel's point
// -- and this one's -- is that neither matrix reaches device memory: each
// score tile is recomputed where it is consumed. This first version is
// plain SIMT float32 (FMA from shared-memory tiles, no tensor cores), so
// it is bound by shared-memory bandwidth in its inner loops, well below
// the card's float32 rate.
//
// Design, given that blocks run in parallel in no order (the TPU kernel
// carried its sums across a sequential grid):
//   * forward: grid (B tiles x W splits); each block walks its W range,
//     accumulates its share of the loss, and writes ONE partial; a second
//     single-block kernel sums the partials in a fixed order, so the loss
//     is deterministic.
//   * backward, dh: the same grid; each block keeps its [32, d] slice of
//     dh in registers while it walks its W range, and writes it to a
//     [splits, B, d] scratch; a second kernel sums the splits in a fixed
//     order. No atomics.
//   * backward, drows/dbias: grid over W tiles; each block keeps its
//     [32, d] slice of drows in registers and walks all of B.
// Any B, W >= 1 and 1 <= d <= 256 (the register accumulators are sized for
// d <= 256); the ragged edges of both axes are masked here.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

// 8 warps; the tile kernels' ~85-107 KB of shared memory fit two blocks on
// an SM, so they are compiled for two (up to 128 registers a thread)
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / 32;   // feature columns per lane

// forward / dh tiles: 32 batch rows x 64 item columns per step
constexpr int kRowTileB = 32;
constexpr int kRowTileW = 64;
// drows / dbias tiles: 32 item columns x 64 batch rows per step
constexpr int kColTileW = 32;
constexpr int kColTileB = 64;

constexpr int kMse = 0;
constexpr int kLogistic = 1;

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

// Copy rows [row0, row0 + tile_rows) of a row-major [n_rows, d] matrix into
// shared memory with row stride ld; rows past n_rows are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows, int d, int ld,
                                          int tile_rows) {
  for (int idx = threadIdx.x; idx < tile_rows * d; idx += kThreads) {
    const int r = idx / d;
    const int k = idx - r * d;
    const int gr = row0 + r;
    dst[r * ld + k] = gr < n_rows ? src[(long long)gr * d + k] : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per (32-row batch tile, W split). Shared memory:
// hs [kRowTileB][ld], rs [kRowTileW][ld], es [kRowTileB][kRowTileW].
// kGrad=false: writes the block's loss partial.
// kGrad=true:  writes the block's partial dh rows to dh_partials[split].
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 2)
rowtile_kernel(const float* __restrict__ h, const float* __restrict__ rows,
               const float* __restrict__ bias,
               const float* __restrict__ target,
               const float* __restrict__ row_mask,
               const float* __restrict__ col_mask,
               const float* __restrict__ g, int B, int W, int d, int ld,
               int kind, float confidence,
               float* __restrict__ loss_partials,
               float* __restrict__ dh_partials) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* rs = hs + kRowTileB * ld;
  float* es = rs + kRowTileW * ld;

  const int tid = threadIdx.x;
  const int ty = tid >> 5;  // warp: batch rows ty + 8*i
  const int tx = tid & 31;  // lane: item columns tx + 32*j, features tx + 32*q
  const int i0 = blockIdx.x * kRowTileB;
  const int n_wtiles = (W + kRowTileW - 1) / kRowTileW;
  const int per_split = (n_wtiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(t_begin + per_split, n_wtiles);
  const float gscale = kGrad ? *g : 1.f;

  load_tile(hs, h, i0, B, d, ld, kRowTileB);
  float rmask[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 8 * i;
    rmask[i] = gi < B ? row_mask[gi] : 0.f;
  }

  float loss_acc = 0.f;
  float dh_acc[4][kDPerLane];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < kDPerLane; ++q) dh_acc[i][q] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kRowTileW;
    __syncthreads();  // previous step's readers of rs / es are done
    load_tile(rs, rows, j0, W, d, ld, kRowTileW);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int k = 0; k < d; ++k) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[(ty + 8 * i) * ld + k];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = rs[(tx + 32 * j) * ld + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gj = j0 + tx + 32 * j;
        float e = 0.f;
        if (gi < B && gj < W) {
          const float sv = s[i][j] + bias[gj];
          const float tv = target[(long long)gi * W + gj];
          if (kGrad) {
            e = elem_dloss(sv, tv, kind, confidence) *
                (gscale * rmask[i] * col_mask[gj]);
          } else {
            loss_acc += elem_loss(sv, tv, kind, confidence) * rmask[i] *
                        col_mask[gj];
          }
        }
        if (kGrad) es[(ty + 8 * i) * kRowTileW + tx + 32 * j] = e;
      }
    }

    if (kGrad) {
      __syncthreads();
      for (int k = 0; k < kRowTileW; ++k) {
        float r[kDPerLane];
#pragma unroll
        for (int q = 0; q < kDPerLane; ++q) {
          const int dd = tx + 32 * q;
          r[q] = dd < d ? rs[k * ld + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = es[(ty + 8 * i) * kRowTileW + k];
#pragma unroll
          for (int q = 0; q < kDPerLane; ++q)
            dh_acc[i][q] = fmaf(e, r[q], dh_acc[i][q]);
        }
      }
    }
  }

  if (kGrad) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty + 8 * i;
      if (gi >= B) continue;
      float* out = dh_partials + ((long long)blockIdx.y * B + gi) * d;
#pragma unroll
      for (int q = 0; q < kDPerLane; ++q) {
        const int dd = tx + 32 * q;
        if (dd < d) out[dd] = dh_acc[i][q];
      }
    }
  } else {
    __shared__ float warp_partials[kThreads / 32];
    const float v = warp_sum(loss_acc);
    if (tx == 0) warp_partials[ty] = v;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_partials[w];
      loss_partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
  }
}

// One block per 32-column item tile; walks all of B in 64-row steps.
// Shared memory: rs [kColTileW][ld], hs [kColTileB][ld],
// es [kColTileB][kColTileW].
__global__ void __launch_bounds__(kThreads, 2)
coltile_grad_kernel(const float* __restrict__ h,
                    const float* __restrict__ rows,
                    const float* __restrict__ bias,
                    const float* __restrict__ target,
                    const float* __restrict__ row_mask,
                    const float* __restrict__ col_mask,
                    const float* __restrict__ g, int B, int W, int d, int ld,
                    int kind, float confidence, float* __restrict__ drows,
                    float* __restrict__ dbias) {
  extern __shared__ float smem[];
  float* rs = smem;
  float* hs = rs + kColTileW * ld;
  float* es = hs + kColTileB * ld;

  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  const int j0 = blockIdx.x * kColTileW;
  const int gj = j0 + tx;  // this lane's score column
  const bool col_ok = gj < W;
  const float bj = col_ok ? bias[gj] : 0.f;
  const float cm = col_ok ? col_mask[gj] : 0.f;
  const float gscale = *g;

  load_tile(rs, rows, j0, W, d, ld, kColTileW);

  // drows accumulators: item columns ty + 8*i, features tx + 32*q
  float acc[4][kDPerLane];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < kDPerLane; ++q) acc[i][q] = 0.f;
  float db = 0.f;

  for (int i0 = 0; i0 < B; i0 += kColTileB) {
    __syncthreads();
    load_tile(hs, h, i0, B, d, ld, kColTileB);
    __syncthreads();

    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float b = rs[tx * ld + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s[i] = fmaf(hs[(ty + 8 * i) * ld + k], b, s[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gi = i0 + ty + 8 * i;
      float e = 0.f;
      if (gi < B && col_ok) {
        const float tv = target[(long long)gi * W + gj];
        e = elem_dloss(s[i] + bj, tv, kind, confidence) *
            (gscale * row_mask[gi] * cm);
      }
      es[(ty + 8 * i) * kColTileW + tx] = e;
    }
    __syncthreads();

    for (int r = 0; r < kColTileB; ++r) {
      float hv[kDPerLane];
#pragma unroll
      for (int q = 0; q < kDPerLane; ++q) {
        const int dd = tx + 32 * q;
        hv[q] = dd < d ? hs[r * ld + dd] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = es[r * kColTileW + ty + 8 * i];
#pragma unroll
        for (int q = 0; q < kDPerLane; ++q) acc[i][q] = fmaf(e, hv[q], acc[i][q]);
      }
    }
    if (ty == 0) {
      for (int r = 0; r < kColTileB; ++r) db += es[r * kColTileW + tx];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = j0 + ty + 8 * i;
    if (c >= W) continue;
#pragma unroll
    for (int q = 0; q < kDPerLane; ++q) {
      const int dd = tx + 32 * q;
      if (dd < d) drows[(long long)c * d + dd] = acc[i][q];
    }
  }
  if (ty == 0 && col_ok) dbias[gj] = db;
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

// out[i] = sum_s parts[s * n + i], s in order.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ parts, int nsplit, long long n,
                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += parts[s * n + i];
    out[i] = v;
  }
}

// Row stride of the shared-memory tiles: odd, so that the 32 lanes of a
// warp reading one feature of 32 consecutive rows hit 32 distinct banks.
int tile_ld(int d) { return d | 1; }

size_t smem_bytes(int ld) {
  // both tile kernels hold 96 rows of width ld plus a 32 x 64 cotangent tile
  return ((size_t)(kRowTileB + kRowTileW) * ld + kRowTileB * kRowTileW) *
         sizeof(float);
}

bool bad_args(int B, int W, int d, int nsplit, int kind) {
  return B < 1 || W < 1 || d < 1 || d > kMaxD || nsplit < 1 ||
         (kind != kMse && kind != kLogistic);
}

}  // namespace

extern "C" {

int fdl_max_d() { return kMaxD; }

int fdl_row_tile() { return kRowTileB; }

// W splits for the forward and dh grids: about two blocks per SM.
int fdl_num_splits(int B, int W, int device, int* nsplit) {
  if (B < 1 || W < 1) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_btiles = (B + kRowTileB - 1) / kRowTileB;
  const int n_wtiles = (W + kRowTileW - 1) / kRowTileW;
  *nsplit = std::max(1, std::min(n_wtiles,
                                 (2 * sms + n_btiles - 1) / n_btiles));
  return cudaSuccess;
}

const char* fdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward: out[0] = masked sum loss. partials: float[ceil(B/32) * nsplit].
int fdl_forward(const float* h, const float* rows, const float* bias,
                const float* target, const float* row_mask,
                const float* col_mask, int B, int W, int d, int kind,
                float confidence, int nsplit, float* partials, float* out,
                int device, void* stream) {
  if (bad_args(B, W, d, nsplit, kind)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int ld = tile_ld(d);
  const size_t smem = smem_bytes(ld);
  err = cudaFuncSetAttribute(rowtile_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kRowTileB - 1) / kRowTileB, nsplit);
  rowtile_kernel<false><<<grid, kThreads, smem, s>>>(
      h, rows, bias, target, row_mask, col_mask, nullptr, B, W, d, ld, kind,
      confidence, partials, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, out);
  return cudaGetLastError();
}

// Backward: dh [B, d], drows [W, d], dbias [W] for upstream gradient *g
// (a device scalar). dh_partials: float[nsplit * B * d].
int fdl_backward(const float* g, const float* h, const float* rows,
                 const float* bias, const float* target,
                 const float* row_mask, const float* col_mask, int B, int W,
                 int d, int kind, float confidence, int nsplit,
                 float* dh_partials, float* dh, float* drows, float* dbias,
                 int device, void* stream) {
  if (bad_args(B, W, d, nsplit, kind)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int ld = tile_ld(d);
  const size_t smem = smem_bytes(ld);
  err = cudaFuncSetAttribute(rowtile_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(coltile_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 grid_rows((B + kRowTileB - 1) / kRowTileB, nsplit);
  rowtile_kernel<true><<<grid_rows, kThreads, smem, s>>>(
      h, rows, bias, target, row_mask, col_mask, g, B, W, d, ld, kind,
      confidence, nullptr, dh_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)B * d;
  const int sum_blocks = (int)((n + kThreads - 1) / kThreads);
  sum_splits_kernel<<<sum_blocks, kThreads, 0, s>>>(dh_partials, nsplit, n,
                                                     dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_cols((W + kColTileW - 1) / kColTileW);
  coltile_grad_kernel<<<grid_cols, kThreads, smem, s>>>(
      h, rows, bias, target, row_mask, col_mask, g, B, W, d, ld, kind,
      confidence, drows, dbias);
  return cudaGetLastError();
}

}  // extern "C"
