// Row scatter -- table[ids] = rows, in place, for up to three tables that
// share one id vector -- for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of recoder_tpu/experiments/block_scatter.py:
// _write_kernel, reached through apply_block_scatter's pl.pallas_call and
// planned by plan_block_scatter. Both compute table.at[ids].set(new_rows)
// in place, touching only the rows that ids names; the row-sparse Adam of
// the sparse embedding tables writes its parameter and both moment tables
// this way each step (recoder_tpu/optim.py SparseRowAdam.update_rows).
//
// Contract, as the TPU kernel's:
//   * ids are in bounds (the data pipeline guarantees it; nothing is
//     checked here);
//   * a repeated id carries the same payload in every slot that names it,
//     so the racing writes store the same bytes and no atomics are needed;
//   * the source rows are copies, not views of the table they go into.
// Tables and rows are float32 with unit column stride and any row stride;
// ids are int64 (torch's index type). Untouched rows are never read or
// written.
//
// What bounds it on this card: it moves 2 * 4 * d bytes per (table, id) and
// does no arithmetic, so it is bound by device-memory bandwidth. At the MSD
// shape (W ~ 18k union ids, d = 200, three tables) one launch moves ~87 MB.
//
// Design: the TPU kernel DMA-ed whole 8-row blocks, gathered and merged
// first (Mosaic cannot DMA single rows of an (8, 128)-tiled table); Hopper
// stores single rows natively, so the block plan, the merge and
// BLOCKS_PER_STEP are gone. Each thread copies one 16-byte unit (or one
// float where the rows or base pointers are not 16-byte aligned) of one
// (id, column) pair; a grid-stride loop walks the flat (id, column unit)
// space, and the grid's y axis picks the table. Neighbouring threads take
// neighbouring columns of one row, so loads and stores coalesce. The table
// is picked by a branch that is uniform across the block, not by indexing
// a parameter array with blockIdx.y: that indexing made every thread copy
// the parameter block to a 96-byte stack frame in local memory (2.2x
// slower than index_copy_ at the MSD shape on an H100). The flat index is 32-bit
// where W * units fits, so the division that splits it is cheap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 3;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;  // per table; grid-stride beyond

// One pointer pair and row strides (in floats) per table, as scalars: the
// kernel never indexes the parameter block at run time.
struct Tables {
  float* dst0;
  float* dst1;
  float* dst2;
  const float* src0;
  const float* src1;
  const float* src2;
  long long dld0, dld1, dld2;
  long long sld0, sld1, sld2;
};

// T is float4 (the 16-byte path) or float (the scalar path); `units` is the
// row width in T and the strides are in T. I is the flat index type.
template <typename T, typename I>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long dld, long long sld,
                                          const long long* __restrict__ ids,
                                          I total, I units) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const I w = i / units;
    const I c = i - w * units;
    dst[__ldg(ids + w) * dld + c] = src[(long long)w * sld + c];
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(Tables t, const long long* __restrict__ ids, I total,
                   I units, int scale) {
  if (blockIdx.y == 0)
    copy_rows<T, I>(reinterpret_cast<T*>(t.dst0),
                    reinterpret_cast<const T*>(t.src0), t.dld0 / scale,
                    t.sld0 / scale, ids, total, units);
  else if (blockIdx.y == 1)
    copy_rows<T, I>(reinterpret_cast<T*>(t.dst1),
                    reinterpret_cast<const T*>(t.src1), t.dld1 / scale,
                    t.sld1 / scale, ids, total, units);
  else
    copy_rows<T, I>(reinterpret_cast<T*>(t.dst2),
                    reinterpret_cast<const T*>(t.src2), t.dld2 / scale,
                    t.sld2 / scale, ids, total, units);
}

template <typename T>
cudaError_t launch(const Tables& t, const long long* ids, long long W,
                   long long units, int scale, int ntables,
                   cudaStream_t s) {
  const long long total = W * units;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks, (unsigned)ntables);
  if (total < (1LL << 31))
    row_scatter_kernel<T, unsigned><<<grid, kThreads, 0, s>>>(
        t, ids, (unsigned)total, (unsigned)units, scale);
  else
    row_scatter_kernel<T, long long><<<grid, kThreads, 0, s>>>(
        t, ids, total, units, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int rs_max_tables() { return kMaxTables; }

const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// For table k < ntables: dst_k[ids[w], :d] = src_k[w, :d] for w < W, on
// `stream` of `device`. vec = 1 asks for the 16-byte path, which needs
// d % 4 == 0, every row stride % 4 == 0 and every base pointer 16-byte
// aligned; a vec request that does not meet them is refused (nothing is
// written).
int rs_row_scatter(int ntables, float* dst0, float* dst1, float* dst2,
                   long long dld0, long long dld1, long long dld2,
                   const float* src0, const float* src1, const float* src2,
                   long long sld0, long long sld1, long long sld2,
                   const long long* ids, long long W, long long d, int vec,
                   int device, void* stream) {
  if (ntables < 1 || ntables > kMaxTables || W < 0 || d < 1)
    return cudaErrorInvalidValue;
  if (W == 0) return cudaSuccess;
  float* dst[kMaxTables] = {dst0, dst1, dst2};
  const float* src[kMaxTables] = {src0, src1, src2};
  const long long dld[kMaxTables] = {dld0, dld1, dld2};
  const long long sld[kMaxTables] = {sld0, sld1, sld2};
  for (int k = 0; k < ntables; ++k) {
    if (dst[k] == nullptr || src[k] == nullptr || dld[k] < d || sld[k] < d)
      return cudaErrorInvalidValue;
    if (vec && (d % 4 != 0 || dld[k] % 4 != 0 || sld[k] % 4 != 0 ||
                !aligned16(dst[k]) || !aligned16(src[k])))
      return cudaErrorMisalignedAddress;
  }
  const Tables t = {dst[0], dst[1], dst[2], src[0], src[1], src[2],
                    dld[0], dld[1], dld[2], sld[0], sld[1], sld[2]};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch<float4>(t, ids, W, d / 4, 4, ntables, s);
  return launch<float>(t, ids, W, d, 1, ntables, s);
}

}  // extern "C"
