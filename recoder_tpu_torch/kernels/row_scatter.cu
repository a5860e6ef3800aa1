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
//     checked here), but for -1, which marks a slot to skip (a row that
//     another rank of a mesh holds; the TPU kernel has no such slot);
//   * a repeated id carries the same payload in every slot that names it,
//     so the racing writes store the same bytes and no atomics are needed;
//   * the source rows are copies, not views of the table they go into.
// Each table and its rows have one element size, 4 bytes (float32) or 2
// (bf16: bf16 parameter storage or bf16 moments), which may differ from
// one table to the next (the TPU kernel writes table.dtype, as here): a
// bf16 table beside float32 moments, or all bf16. Unit column stride and
// any row stride; ids are int64 (torch's index type). Untouched rows are
// never read or written.
//
// What bounds it on this card: it moves 2 * es * d bytes per (table, id)
// and does no arithmetic, so it is bound by device-memory bandwidth. At
// the MSD shape (W ~ 18k union ids, d = 200, three float32 tables) one
// launch moves ~87 MB.
//
// Design: the TPU kernel DMA-ed whole 8-row blocks, gathered and merged
// first (Mosaic cannot DMA single rows of an (8, 128)-tiled table); Hopper
// stores single rows natively, so the block plan, the merge and
// BLOCKS_PER_STEP are gone. Each thread copies one 16-byte unit of one
// (id, column) pair, or one element where the table's rows or base
// pointers are not 16-byte aligned (each table has its own row width in
// units and its own choice); a grid-stride loop walks the flat (id, unit)
// space, and the grid's y axis picks the table. Neighbouring threads take
// neighbouring columns of one row, so loads and stores coalesce. The table
// is picked by a branch that is uniform across the block, not by indexing
// a parameter array with blockIdx.y: that indexing made every thread copy
// the parameter block to a 96-byte stack frame in local memory (2.2x
// slower than index_copy_ at the MSD shape on an H100). The flat index is
// 32-bit where W * units fits, so the division that splits it is cheap.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTables = 3;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;  // per table; grid-stride beyond

// One table: its pointer pair, row strides in elements, element size in
// bytes, and whether it takes the 16-byte path.
struct Table {
  void* dst;
  const void* src;
  long long dld, sld;
  int es;
  int vec;
};

// As scalars: the kernel never indexes the parameter block at run time.
struct Tables {
  Table t0, t1, t2;
};

// T is the unit the thread copies (uint4: 16 bytes; else one element);
// `units` is the row width in T and the strides are in T. I is the flat
// index type.
template <typename T, typename I>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long dld, long long sld,
                                          const long long* __restrict__ ids,
                                          I W, I units) {
  const I total = W * units;
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const I w = i / units;
    const I c = i - w * units;
    const long long id = __ldg(ids + w);
    if (id >= 0) dst[id * dld + c] = src[(long long)w * sld + c];
  }
}

// One table's copy, its unit chosen by the table (uniform in the block).
template <typename I>
__device__ __forceinline__ void copy_table(const Table& t,
                                           const long long* ids, I W, I d) {
  if (t.vec) {
    const int per = 16 / t.es;  // elements a unit
    copy_rows<uint4, I>(static_cast<uint4*>(t.dst),
                        static_cast<const uint4*>(t.src), t.dld / per,
                        t.sld / per, ids, W, d / per);
  } else if (t.es == 4) {
    copy_rows<uint32_t, I>(static_cast<uint32_t*>(t.dst),
                           static_cast<const uint32_t*>(t.src), t.dld, t.sld,
                           ids, W, d);
  } else {
    copy_rows<uint16_t, I>(static_cast<uint16_t*>(t.dst),
                           static_cast<const uint16_t*>(t.src), t.dld, t.sld,
                           ids, W, d);
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(Tables t, const long long* __restrict__ ids, I W, I d) {
  if (blockIdx.y == 0)
    copy_table<I>(t.t0, ids, W, d);
  else if (blockIdx.y == 1)
    copy_table<I>(t.t1, ids, W, d);
  else
    copy_table<I>(t.t2, ids, W, d);
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

// For table k < ntables: dst_k[ids[w], :d] = src_k[w, :d] for w < W with
// ids[w] >= 0 (a slot of id -1 is skipped), on
// `stream` of `device`; es_k is table k's element size (4 or 2 bytes),
// the strides are in its elements. vec_k = 1 asks for the 16-byte path
// for table k, which needs d * es_k, every row stride * es_k a multiple
// of 16 and both base pointers 16-byte aligned; a vec request that does
// not meet them is refused (nothing is written).
int rs_row_scatter(int ntables, void* dst0, void* dst1, void* dst2,
                   long long dld0, long long dld1, long long dld2,
                   const void* src0, const void* src1, const void* src2,
                   long long sld0, long long sld1, long long sld2, int es0,
                   int es1, int es2, int vec0, int vec1, int vec2,
                   const long long* ids, long long W, long long d,
                   int device, void* stream) {
  if (ntables < 1 || ntables > kMaxTables || W < 0 || d < 1)
    return cudaErrorInvalidValue;
  if (W == 0) return cudaSuccess;
  Table t[kMaxTables] = {{dst0, src0, dld0, sld0, es0, vec0},
                         {dst1, src1, dld1, sld1, es1, vec1},
                         {dst2, src2, dld2, sld2, es2, vec2}};
  long long units = 0;  // the widest table's units a row: the grid
  for (int k = 0; k < ntables; ++k) {
    const Table& x = t[k];
    if (x.dst == nullptr || x.src == nullptr || x.dld < d || x.sld < d ||
        (x.es != 2 && x.es != 4))
      return cudaErrorInvalidValue;
    if (x.vec && ((d * x.es) % 16 != 0 || (x.dld * x.es) % 16 != 0 ||
                  (x.sld * x.es) % 16 != 0 || !aligned16(x.dst) ||
                  !aligned16(x.src)))
      return cudaErrorMisalignedAddress;
    units = std::max(units, x.vec ? d * x.es / 16 : d);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = W * units;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks, (unsigned)ntables);
  const Tables ts = {t[0], t[1], t[2]};
  // (W * d bounds every table's flat index: units <= d)
  if (W * d < (1LL << 31))
    row_scatter_kernel<unsigned><<<grid, kThreads, 0, s>>>(
        ts, ids, (unsigned)W, (unsigned)d);
  else
    row_scatter_kernel<long long><<<grid, kThreads, 0, s>>>(ts, ids, W, d);
  return cudaGetLastError();
}

}  // extern "C"
