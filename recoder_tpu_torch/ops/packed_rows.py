"""Row fetch with bit unpack from the packed 1-bit slab: the CUDA kernel
and its plain twin.

The packed tier of ``data/device_pipeline.py`` stores a binary
interaction matrix as ``[n_rows, W / 32]`` int32 words: column ``c`` is
bit ``c & 31`` of word ``c >> 5`` (bit 31 is the sign bit: the same bits
as the JAX package's uint32 words). A full-decode step fetches its
``B`` rows -- a contiguous slice from ``start`` ('blocks' shuffle) or
the rows ``index`` names, clamped into the slab ('users' shuffle) --
and unpacks them to the dense tier's bf16 zeros and ones, with the
step's loss columns: a column is one when any of the rows has its bit
and it lies below ``num_items`` (the JAX ``_build_fd_from_cache`` with
``_unpack_rows``, and the ``any(slab != 0) & in_catalog`` mask of
``_forward_loss``).

A step whose loss columns span a mega-batch wider than its rows
(``num_sampling_users > batch_size``) also takes the mega's mask alone:
:func:`unpack_mask` ORs the bits of the mega's rows and writes no row,
through the same kernel (a null row output).

The trainer fetches in index mode in both shuffles ('blocks' passes
``perm[step] * batch + arange(batch)``, computed on the device), so no
row offset is a host value that a captured CUDA graph would bake in.
The mask words are zeroed by a memset on the launch's stream.

Routing is by the tensors' device and nothing else: CUDA tensors launch
the kernel of ``kernels/packed_rows.cu`` (or raise), CPU tensors take
:func:`unpack_rows_plain`.
"""

import ctypes
import threading

import torch

from recoder_tpu_torch.kernels import count_launch

#: kernel launches since the last reset
LAUNCHES = {'packed_rows': 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def _check_args(packed, num_items, start, index, count):
  """The fetch's row count ``B``, after checking what both routes take."""
  if packed.dim() != 2 or packed.dtype != torch.int32:
    raise ValueError(f'packed must be a 2-D int32 tensor, got {packed.dtype} '
                     f'{tuple(packed.shape)}')
  if packed.shape[0] < 1 or packed.shape[1] < 1:
    raise ValueError(f'packed slab {tuple(packed.shape)} is empty')
  if (start is None) == (index is None):
    raise ValueError('give exactly one of start (a contiguous fetch) and '
                     'index (a row gather)')
  if int(num_items) < 0:
    raise ValueError(f'num_items={num_items} is negative')
  if index is not None:
    if index.dim() != 1 or index.dtype != torch.int64:
      raise ValueError(f'index must be a 1-D int64 tensor, got {index.dtype} '
                       f'{tuple(index.shape)}')
    if index.device != packed.device:
      raise ValueError(f'index is on {index.device}, packed on '
                       f'{packed.device}')
    return index.shape[0]
  if count is None or int(count) < 0:
    raise ValueError(f'a contiguous fetch needs count >= 0, got {count}')
  if int(start) < 0 or int(start) + int(count) > packed.shape[0]:
    raise ValueError(f'rows {start}..{int(start) + int(count)} outside the '
                     f'slab of {packed.shape[0]} rows')
  return int(count)


def unpack_rows_plain(packed, num_items, start=None, index=None, count=None):
  """Plain PyTorch version: a slice or ``index_select`` of the words,
  ``(words[:, :, None] >> arange(32)) & 1`` (an arithmetic shift of a
  negative word still yields bit 31), and the column mask over the
  fetched bits."""
  B = _check_args(packed, num_items, start, index, count)
  if index is None:
    words = packed[int(start):int(start) + B]
  else:
    words = packed.index_select(
        0, torch.clamp(index, min=0, max=packed.shape[0] - 1))
  W = 32 * packed.shape[1]
  shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
  bits = (words[:, :, None] >> shifts) & 1
  rows = bits.to(torch.bfloat16).reshape(B, W)
  present = torch.any(bits != 0, dim=0).reshape(W)
  in_catalog = torch.arange(W, device=packed.device) < int(num_items)
  return rows, (present & in_catalog).float()


def unpack_mask_plain(packed, num_items, start=None, index=None,
                      count=None):
  """Plain PyTorch version of :func:`unpack_mask`: the mask of
  :func:`unpack_rows_plain`."""
  return unpack_rows_plain(packed, num_items, start, index, count)[1]


def _lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      from recoder_tpu_torch.kernels import load_library
      lib = load_library('packed_rows')
      ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
      lib.pr_unpack_rows.argtypes = [ptr, i64, i32, i64, ptr, i32, i64, ptr,
                                     ptr, ptr, i32, ptr]
      lib.pr_unpack_rows.restype = i32
      lib.pr_error_string.argtypes = [i32]
      lib.pr_error_string.restype = ctypes.c_char_p
      _LIB = lib
    return _LIB


def _launch(packed, num_items, start, index, count, write_rows):
  """One launch of the kernel (a memset of the mask words, the fetch
  with unpack -- or, without ``write_rows``, with no row written -- and
  the column-mask expansion) on the current stream."""
  B = _check_args(packed, num_items, start, index, count)
  if packed.device.type != 'cuda':
    raise ValueError(f'the packed_rows kernel needs CUDA tensors, packed is '
                     f'on {packed.device}')
  if not packed.is_contiguous():
    raise ValueError('packed must be contiguous')
  if index is not None and not index.is_contiguous():
    raise ValueError('index must be contiguous')
  n_rows, n_words = packed.shape
  W = 32 * n_words
  dev = packed.device
  rows = (torch.empty((B, W), dtype=torch.bfloat16, device=dev)
          if write_rows else None)
  mask_words = torch.empty(n_words, dtype=torch.int32, device=dev)
  col_mask = torch.empty(W, dtype=torch.float32, device=dev)
  lib = _lib()
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.pr_unpack_rows(
      packed.data_ptr(), n_rows, n_words, 0 if start is None else int(start),
      None if index is None else index.data_ptr(), B, int(num_items),
      None if rows is None else rows.data_ptr(), mask_words.data_ptr(),
      col_mask.data_ptr(), dev.index or 0, stream)
  if err != 0:
    raise RuntimeError(f'packed_rows launch failed: CUDA error {err} '
                       f'({lib.pr_error_string(err).decode()})')
  count_launch(LAUNCHES, 'packed_rows')
  return rows, col_mask


def unpack_rows_kernel(packed, num_items, start=None, index=None, count=None):
  """The CUDA kernel: one launch (a memset of the mask words, the fetch
  with unpack, the column-mask expansion) on the current stream."""
  return _launch(packed, num_items, start, index, count, True)


def unpack_mask_kernel(packed, num_items, start=None, index=None,
                       count=None):
  """The CUDA kernel, mask only: one launch that ORs the rows' words and
  writes no row."""
  return _launch(packed, num_items, start, index, count, False)[1]


def unpack_rows(packed, num_items, start=None, index=None, count=None):
  """A step's rows of the packed slab, unpacked, and its loss columns.

  Args:
    packed: [n_rows, n_words] int32 words (column c: bit c & 31 of word
      c >> 5).
    num_items: the logical catalog; columns at or above it are no loss
      column.
    start, count: fetch rows ``start .. start + count - 1``; or
    index: int64 [B] rows to gather, clamped into ``[0, n_rows - 1]``.

  Returns ``(rows [B, 32 * n_words] bf16 zeros and ones, col_mask
  [32 * n_words] float32)``.
  """
  device = packed.device
  if device.type == 'cuda':
    return unpack_rows_kernel(packed, num_items, start, index, count)
  if device.type == 'cpu':
    return unpack_rows_plain(packed, num_items, start, index, count)
  raise ValueError(f'unpack_rows runs on cuda or cpu, not {device}')


def unpack_mask(packed, num_items, start=None, index=None, count=None):
  """The loss columns of some rows of the packed slab, without the rows:
  ``[32 * n_words]`` float32, 1 where any of the rows has its bit and the
  column lies below ``num_items`` (arguments as :func:`unpack_rows`)."""
  device = packed.device
  if device.type == 'cuda':
    return unpack_mask_kernel(packed, num_items, start, index, count)
  if device.type == 'cpu':
    return unpack_mask_plain(packed, num_items, start, index, count)
  raise ValueError(f'unpack_mask runs on cuda or cpu, not {device}')
