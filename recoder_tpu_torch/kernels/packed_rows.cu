// Packed-slab row fetch with bit unpack -- for Hopper (sm_90a).
//
// No Pallas ancestor: it computes what the JAX package's full-decode step
// computes with XLA over its bit-packed slab (recoder_tpu/data/
// device_pipeline.py): the step's rows fetched by a contiguous slice
// ('blocks') or a row gather ('users', _build_fd_from_cache), unpacked to
// exact bf16 zeros and ones (_unpack_rows), and the loss columns the trainer
// reads off them (any(slab != 0) & in-catalog, model.py _forward_loss with
// fd_mask_from_slab).
//
// Layout: the packed slab is [n_rows, n_words] int32, row-major; column c of
// a row is bit c & 31 of its word c >> 5 (bit 31 is the sign bit, the same
// bits as the JAX package's uint32 words). Outputs:
//   rows      [batch, 32 * n_words] bf16, exactly 0 or 1;
//   mask_words [n_words] the OR of each word column over the batch's rows;
//   col_mask  [32 * n_words] float32, 1 where the column's mask bit is set and
//             the column is below num_items.
// 'users' mode clamps each row index into [0, n_rows - 1], as the JAX fetch
// sends pad users to the slab's last (zero) row.
//
// What bounds it on this card: it does no arithmetic worth counting and moves
// bytes -- 4 B a word read, 64 B of bf16 written for each word. At the MSD
// shape (500 rows x 1,288 words) that is 2.58 MB read and 41.2 MB written:
// 13.1 us at 3.35 TB/s.
//
// Design: each thread owns one quarter (8 columns) of one word column and a
// chunk of kRowsPerBlock rows. The four threads of a word read the same word
// (one broadcast load), and each writes its 8 bf16 as one 16-byte store, so a
// warp's stores cover 512 contiguous bytes of a row. The grid's x axis walks
// the word strips and its y axis the row chunks: MSD has only 1,288 word
// columns, so one thread per column alone would leave most of the card idle.
// A thread loads its chunk's words before it stores any row, so the loads are
// in flight together. The quarter-0 thread of each word ORs its words and
// atomicOr's them into mask_words (zeroed by a memset on the stream first); a
// second small kernel expands mask_words into col_mask, so no pass over the
// [batch, W] rows is needed for the mask.
//
// Mask only (rows == nullptr): the loss columns of a mega-batch wider than
// the step's rows (model.py _forward_loss over the mega's columns). Only the
// quarter-0 thread of each word runs: it reads its rows' words, ORs them and
// writes no row -- 4 B a word read, at [2,000 rows x 632 words] 5.1 MB:
// 1.5 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kQuarters = 4;        // 8-column quarters of a 32-column word
constexpr int kMaskThreads = 256;
constexpr unsigned kMaxGridY = 65535;

// bf16 1.0 is 0x3F80. Element j of the 8 (low half of .x first) is bit j.
__device__ __forceinline__ uint4 expand8(uint32_t b) {
  uint4 out;
  out.x = (b & 1u) * 0x3F80u | ((b >> 1) & 1u) * 0x3F800000u;
  out.y = ((b >> 2) & 1u) * 0x3F80u | ((b >> 3) & 1u) * 0x3F800000u;
  out.z = ((b >> 4) & 1u) * 0x3F80u | ((b >> 5) & 1u) * 0x3F800000u;
  out.w = ((b >> 6) & 1u) * 0x3F80u | ((b >> 7) & 1u) * 0x3F800000u;
  return out;
}

template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
packed_rows_kernel(const uint32_t* __restrict__ packed, long long n_rows,
                   int n_words, long long start,
                   const long long* __restrict__ index, int batch,
                   uint4* __restrict__ rows,
                   unsigned int* __restrict__ mask_words) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;  // word * 4 + quarter
  const int word = slot >> 2;
  const int quarter = slot & 3;
  if (word >= n_words || (rows == nullptr && quarter != 0)) return;
  const int r0 = blockIdx.y * kRowsPerBlock;
  uint32_t w[kRowsPerBlock];
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const int r = r0 + i;
    w[i] = 0u;
    if (r < batch) {
      long long src;
      if (kIndexed) {
        src = __ldg(index + r);
        src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
      } else {
        src = start + r;
      }
      w[i] = __ldg(packed + src * n_words + word);
    }
  }
  const long long row_units = (long long)n_words * kQuarters;
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const int r = r0 + i;
    if (r < batch) {
      if (rows != nullptr)
        rows[(long long)r * row_units + slot] = expand8(w[i] >> (8 * quarter));
      acc |= w[i];
    }
  }
  if (quarter == 0 && acc != 0u) atomicOr(mask_words + word, acc);
}

__global__ void __launch_bounds__(kMaskThreads)
col_mask_kernel(const unsigned int* __restrict__ mask_words, int width,
                long long num_items, float* __restrict__ col_mask) {
  const int c = blockIdx.x * kMaskThreads + threadIdx.x;
  if (c >= width) return;
  const unsigned int bit = (mask_words[c >> 5] >> (c & 31)) & 1u;
  col_mask[c] = (bit && c < num_items) ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

const char* pr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fetch `batch` rows of the packed slab [n_rows, n_words] and unpack them:
// rows start, start + 1, ... when index is null, else rows index[0..batch)
// clamped into [0, n_rows - 1]. Writes rows_out [batch, 32 * n_words] bf16
// (16-byte aligned; null: the mask alone, no row written), mask_words [n_words] and
// col_mask [32 * n_words] float32 on `stream` of `device`. Returns a CUDA
// error code (0 on success); a request the kernels do not take is refused
// before anything is written.
int pr_unpack_rows(const void* packed, long long n_rows, int n_words,
                   long long start, const long long* index, int batch,
                   long long num_items, void* rows_out, void* mask_words,
                   float* col_mask, int device, void* stream) {
  if (packed == nullptr || n_rows < 1 || n_words < 1 || batch < 0 ||
      mask_words == nullptr || col_mask == nullptr)
    return cudaErrorInvalidValue;
  if (n_words > (1 << 25)) return cudaErrorInvalidValue;  // 32 * n_words fits
  if (index == nullptr && (start < 0 || start + batch > n_rows))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(rows_out) & 15u) != 0)
    return cudaErrorMisalignedAddress;
  const unsigned grid_y = (unsigned)((batch + kRowsPerBlock - 1) /
                                     kRowsPerBlock);
  if (grid_y > kMaxGridY) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* words = static_cast<unsigned int*>(mask_words);
  err = cudaMemsetAsync(words, 0, sizeof(unsigned int) * n_words, s);
  if (err != cudaSuccess) return err;
  if (batch > 0) {
    const dim3 grid((unsigned)(((long long)n_words * kQuarters + kThreads - 1) /
                               kThreads),
                    grid_y);
    const uint32_t* p = static_cast<const uint32_t*>(packed);
    uint4* out = static_cast<uint4*>(rows_out);
    if (index != nullptr)
      packed_rows_kernel<true><<<grid, kThreads, 0, s>>>(
          p, n_rows, n_words, 0, index, batch, out, words);
    else
      packed_rows_kernel<false><<<grid, kThreads, 0, s>>>(
          p, n_rows, n_words, start, nullptr, batch, out, words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int width = 32 * n_words;
  col_mask_kernel<<<(width + kMaskThreads - 1) / kMaskThreads, kMaskThreads,
                    0, s>>>(words, width, num_items, col_mask);
  return cudaGetLastError();
}

}  // extern "C"
