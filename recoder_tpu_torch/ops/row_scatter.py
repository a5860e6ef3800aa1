"""In-place row scatter into up to three tables: the CUDA kernel and its
plain twin.

Port of ``recoder_tpu/experiments/block_scatter.py``
(``apply_block_scatter`` over the Pallas kernel ``_write_kernel``, planned
by ``plan_block_scatter``): ``table[ids] = rows`` in place, for tables
that share one id vector, so one launch writes a row-sparse Adam step's
parameter and both moment tables. Only the touched rows are read or
written; untouched rows stay bitwise unchanged.

Contract, as the TPU kernel's: ids are in bounds (the data pipeline
guarantees it; the plain twin checks it), and a repeated id carries the
same payload in every slot, so the racing writes need no atomics. Beyond
the TPU kernel's, an id of -1 marks a slot that is skipped: on a mesh, a
union row that another rank holds (``parallel/sharding.Partition``).
Each table is float32 or bf16 (bf16 parameter storage, bf16 moments),
its rows in the same dtype, and the tables of one call may differ (a bf16
table beside float32 moments): the kernel copies each table's rows in its
own element size. Unit column stride (any row stride), ids int64. The
rows are copies, never views of the tables.

Routing is by the tensors' device and nothing else: CUDA tensors launch
the kernel of ``kernels/row_scatter.cu`` (or raise), CPU tensors take
:func:`row_scatter_plain` (``index_copy_`` per table).

The kernel writes through raw pointers, which does not bump a tensor's
autograd version counter: call it under ``torch.no_grad()`` on tables no
pending graph has saved. Nothing in the wrapper reads the host, so a
captured CUDA graph may record the launch (the captured sparse step);
the launch counter counts only launches made outside a capture.
"""

import torch

from recoder_tpu_torch.kernels import I32, I64, PTR, Library, count_launch

MAX_TABLES = 3
#: the tables' dtypes the kernel copies
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last reset
LAUNCHES = {'row_scatter': 0}


def _constants(lib):
  if lib.rs_max_tables() != MAX_TABLES:
    raise RuntimeError(f'row_scatter.cu takes {lib.rs_max_tables()} '
                       f'tables, the wrapper expects {MAX_TABLES}')


LIBRARY = Library('row_scatter', 'rs', {
    'rs_row_scatter': ([I32] + [PTR] * 3 + [I64] * 3 + [PTR] * 3 + [I64] * 3
                       + [I32] * 6 + [PTR, I64, I64, I32, PTR],
                       'row_scatter launch'),
    'rs_max_tables': ([], None)}, constants=_constants)


def _check_args(tables, ids, rows):
  tables, rows = tuple(tables), tuple(rows)
  if not 1 <= len(tables) <= MAX_TABLES or len(rows) != len(tables):
    raise ValueError(f'row_scatter takes 1..{MAX_TABLES} tables and one row '
                     f'block each, got {len(tables)} tables and {len(rows)} '
                     'row blocks')
  if ids.dim() != 1 or ids.dtype != torch.int64:
    raise ValueError(f'ids must be a 1-D int64 tensor, got {ids.dtype} '
                     f'{tuple(ids.shape)}')
  shape = tuple(tables[0].shape)
  if len(shape) != 2:
    raise ValueError(f'tables must be 2-D, got {shape}')
  W = ids.shape[0]
  for i, (t, r) in enumerate(zip(tables, rows)):
    if tuple(t.shape) != shape:
      raise ValueError(f'table {i} has shape {tuple(t.shape)}, table 0 '
                       f'{shape}')
    if tuple(r.shape) != (W, shape[1]):
      raise ValueError(f'rows {i} has shape {tuple(r.shape)}, expected '
                       f'{(W, shape[1])}')
    if t.dtype not in DTYPES or r.dtype != t.dtype:
      raise ValueError(f'table {i} ({t.dtype}) and its rows ({r.dtype}) '
                       f'must share one dtype of {DTYPES}')
    for name, x in (('table', t), ('rows', r)):
      if x.device != ids.device:
        raise ValueError(f'{name} {i} is on {x.device}, ids on {ids.device}')
  return tables, rows


def row_scatter_plain(tables, ids, rows):
  """Plain PyTorch version: ``index_copy_`` per table of the slots whose
  id is not -1, after a bounds check."""
  tables, rows = _check_args(tables, ids, rows)
  n = tables[0].shape[0]
  if ids.numel() and (int(ids.min()) < -1 or int(ids.max()) >= n):
    raise IndexError(f'row ids outside -1..{n - 1}')
  keep = ids >= 0
  if not bool(keep.all()):
    ids, rows = ids[keep], [r[keep] for r in rows]
  for t, r in zip(tables, rows):
    t.index_copy_(0, ids, r)


def _unit_columns(x):
  return x.shape[1] == 1 or x.stride(1) == 1


def _vector_path(table, rows):
  """Whether the kernel takes its 16-byte path for one table and its
  rows: a row of d elements, both row strides and both base pointers
  whole 16-byte units (d % 4 == 0 in float32, d % 8 == 0 in bf16)."""
  es = table.element_size()
  return (table.shape[1] * es) % 16 == 0 and all(
      x.data_ptr() % 16 == 0 and (x.stride(0) * es) % 16 == 0
      for x in (table, rows))


def vector_path(tables, rows):
  """Whether the kernel takes its 16-byte path for every table of a call
  (each table chooses its own)."""
  return all(_vector_path(t, r) for t, r in zip(tables, rows))


def row_scatter_kernel(tables, ids, rows):
  """The CUDA kernel: ``t[ids] = r`` for each table ``t`` and its rows
  ``r``, in one launch; nothing is launched for an empty ``ids``."""
  tables, rows = _check_args(tables, ids, rows)
  if ids.device.type != 'cuda':
    raise ValueError(f'the row_scatter kernel needs CUDA tensors, ids are '
                     f'on {ids.device}')
  W, d = rows[0].shape
  if W == 0:
    return
  if not ids.is_contiguous():
    raise ValueError('ids must be contiguous')
  for i, x in enumerate((*tables, *rows)):
    if not _unit_columns(x):
      raise ValueError(f'tensor {i} must have contiguous rows (column '
                       f'stride 1), got strides {x.stride()}')
  k = len(tables)
  pad = MAX_TABLES - k
  dst = [t.data_ptr() for t in tables] + [None] * pad
  dld = [t.stride(0) for t in tables] + [0] * pad
  src = [r.data_ptr() for r in rows] + [None] * pad
  sld = [r.stride(0) for r in rows] + [0] * pad
  es = [t.element_size() for t in tables] + [4] * pad
  vec = [int(_vector_path(t, r)) for t, r in zip(tables, rows)] + [0] * pad
  stream = torch.cuda.current_stream(ids.device).cuda_stream
  LIBRARY().rs_row_scatter(k, *dst, *dld, *src, *sld, *es, *vec,
                           ids.data_ptr(), W, d, ids.device.index or 0,
                           stream)
  count_launch(LAUNCHES, 'row_scatter')


def row_scatter_(tables, ids, rows):
  """``table[ids] = rows`` in place for each of up to three tables.

  Args:
    tables: sequence of [N, d] tables (same shape), each float32 or bf16.
    ids: int64 [W] row ids, in bounds, or -1 for a slot to skip; a
      repeated id must carry the same payload in every slot.
    rows: sequence of [W, d] rows, one per table, in its dtype.
  """
  device = ids.device
  if device.type == 'cuda':
    return row_scatter_kernel(tables, ids, rows)
  if device.type == 'cpu':
    return row_scatter_plain(tables, ids, rows)
  raise ValueError(f'row_scatter runs on cuda or cpu, not {device}')
