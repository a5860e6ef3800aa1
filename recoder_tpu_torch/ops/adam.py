"""Fused Adam step over bfloat16 storage: the CUDA kernel and its plain
twin.

The JAX package's ``Optimizer('adam')`` over bf16 storage
(``recoder_tpu/optim.py``): moments stored in bf16
(``state_dtype='bfloat16'``) and/or parameters and their gradients stored
in bf16 (``params_dtype='bfloat16'``), the update math in float32 -- the
weight decay added to the upcast gradient from the upcast parameter, the
new moments, the parameter step with the unrounded new moments -- and one
round-to-nearest-even of each bf16 buffer on store. It has no Pallas
ancestor; on the card it is ``kernels/adam.cu``, one launch for every
tensor of a parameter set, for the storage pairs (parameters, moments)
of :data:`STORAGE`.

Routing is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors take :func:`adam_bf16_plain`, which does the same
float32 operations in the same order (the kernel is built without
multiply-add contraction), so the two agree bit for bit.

The host computes the step's scalars in float32 as the JAX package does
(:func:`step_scalars`) and hands them over in device memory: a table
with one row a step (:func:`scalar_table`) and a control pair ``ctl =
[steps taken, the step before the table's first row]``; a launch reads
row ``ctl[0] - ctl[1]`` and adds one to ``ctl[0]`` (:func:`table_step`).
So a captured CUDA graph, which bakes in every launch argument, replays
each step with that step's scalars. The plain twin reads the same row.

A launch recorded under stream capture cannot upload its descriptor
table (the tensors' pointers; a gradient is allocated during the
capture): it takes its table from a :class:`CapturedDescriptors`,
memory set aside before the capture, which writes the tables after it,
before the first replay. The memory must not come from the graph's own
pool: a block the capture freed and handed out again is written by the
graph's earlier nodes on every replay, which would overwrite a table
written once from outside.
"""

import ctypes
import functools
import threading
from collections import namedtuple

import numpy as np
import torch

from recoder_tpu_torch.kernels import capturing, count_launch

BF16 = torch.bfloat16
#: kernel launches since the last reset
LAUNCHES = {'adam_bf16': 0}

#: the (parameter and gradient, moment) storage dtypes the kernel is
#: built for; float32 throughout is ``torch.optim.Adam``'s
STORAGE = ((torch.float32, BF16), (BF16, BF16), (BF16, torch.float32))

#: one tensor's descriptor, as ``struct Desc`` in kernels/adam.cu
DESC = np.dtype({'names': ['p', 'g', 'm', 'v', 'n', 'chunk0', 'wd', 'vec',
                           'p_bf16', 'm_bf16'],
                 'formats': ['<u8', '<u8', '<u8', '<u8', '<i8', '<i8', '<f4',
                             '<i4', '<i4', '<i4'],
                 'offsets': [0, 8, 16, 24, 32, 40, 48, 52, 56, 60],
                 'itemsize': 64})

Scalars = namedtuple('Scalars',
                     'lr_bc1 b1 omb1 b2 omb2 sqrt_bc2 eps')
#: floats a row of the step-scalar table (kernels/adam.cu kTableCols)
TABLE_COLS = 8

_LIB = None
_LIB_LOCK = threading.Lock()


def step_scalars(lr, step, betas, eps):
  """The float32 scalars of step ``step`` (1-based), as Python floats
  holding float32 values: ``lr / bc1``, the betas, ``1 - beta``,
  ``sqrt(bc2)`` and eps, with ``bc = 1 - beta ** step`` in float32."""
  f32 = np.float32
  b1, b2 = betas
  bc1 = f32(1.0) - f32(b1) ** f32(step)
  bc2 = f32(1.0) - f32(b2) ** f32(step)
  return Scalars(float(f32(lr) / bc1), float(f32(b1)), float(f32(1 - b1)),
                 float(f32(b2)), float(f32(1 - b2)), float(np.sqrt(bc2)),
                 float(f32(eps)))


def scalar_table(lr, first_step, n, betas=(0.9, 0.999), eps=1e-8):
  """float32 ``[n, TABLE_COLS]``: row ``k`` holds the :func:`step_scalars`
  of the 1-based step ``first_step + k`` (the last column unused)."""
  table = np.zeros((n, TABLE_COLS), np.float32)
  for k in range(n):
    table[k, :len(Scalars._fields)] = step_scalars(lr, first_step + k,
                                                   betas, eps)
  return table


def scalars_at(table, ctl):
  """The :class:`Scalars` of row ``ctl[0] - ctl[1]`` of ``table`` (a host
  read: the plain twin's)."""
  taken, base = (int(x) for x in ctl.tolist())
  row = taken - base
  if not 0 <= row < table.shape[0]:
    raise IndexError(f'step {taken + 1} is outside the scalar table (steps '
                     f'{base + 1}..{base + table.shape[0]})')
  return Scalars(*table[row, :len(Scalars._fields)].tolist())


def adam_bf16_plain(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                    scalars):
  """The kernel's plain version, in place: each operation of
  kernels/adam.cu as one PyTorch op on the upcast buffers, divisions by
  tensors (CUDA divides by a host scalar as a multiply by its
  reciprocal), each buffer stored back once (``copy_`` rounds to nearest
  even)."""
  c = scalars
  for p, g, m, v, wd in zip(params, grads, exp_avgs, exp_avg_sqs,
                            weight_decays):
    sqrt_bc2 = torch.tensor(c.sqrt_bc2, device=p.device)
    p32 = p.float()
    g = g.float() + wd * p32
    m1 = c.b1 * m.float() + c.omb1 * g
    v1 = c.b2 * v.float() + (c.omb2 * g) * g
    denom = torch.sqrt(v1) / sqrt_bc2 + c.eps
    p.copy_(p32 - (c.lr_bc1 * m1) / denom)
    m.copy_(m1)
    v.copy_(v1)


def _lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      from recoder_tpu_torch.kernels import load_library
      lib = load_library('adam')
      ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
      lib.adam_bf16_step.argtypes = [ptr, i32, i32, ptr, i32, ptr, i32, i32,
                                     i32, ptr]
      lib.adam_bf16_step.restype = i32
      lib.adam_chunk.restype = i32
      lib.chunk = lib.adam_chunk()
      lib.adam_table_cols.restype = i32
      if lib.adam_table_cols() != TABLE_COLS:
        raise RuntimeError('kernels/adam.cu and ops/adam.py disagree on '
                           'the scalar table')
      lib.adam_error_string.argtypes = [i32]
      lib.adam_error_string.restype = ctypes.c_char_p
      _LIB = lib
    return _LIB


def _pack(entries, chunk):
  """The descriptors of ``entries`` ((p, g, m, v pointers, n, wd, vec,
  p_bf16, m_bf16) per tensor) as bytes, and the launch's chunk count."""
  desc = np.zeros(len(entries), DESC)
  chunk0 = 0
  for i, (p, g, m, v, n, wd, vec, p_bf16, m_bf16) in enumerate(entries):
    desc[i] = (p, g, m, v, n, chunk0, wd, vec, p_bf16, m_bf16)
    chunk0 += -(-n // chunk)
  return desc.view(np.uint8), chunk0


@functools.lru_cache(maxsize=16)
def _table(device_index, entries, chunk):
  """The descriptor table of ``entries`` in device memory and the chunk
  count. Built once per parameter set: the key is every pointer, so a
  table is reused only for the same tensors."""
  desc, nchunks = _pack(entries, chunk)
  return torch.from_numpy(desc).to(torch.device('cuda', device_index)), \
      nchunks


class CapturedDescriptors:
  """The descriptor tables of the launches one CUDA graph capture
  records: memory reserved before the capture for up to ``launches``
  launches over ``tensors`` tensors each, handed out as the launches are
  recorded and written by :meth:`fill` after the capture. It must live
  as long as the graph."""

  ALIGN = 64

  def __init__(self, device, launches, tensors):
    self._size = -(-tensors * DESC.itemsize // self.ALIGN) * self.ALIGN
    self.memory = torch.empty(launches * self._size, dtype=torch.uint8,
                              device=device)
    self._used = 0
    self._pending = []

  def table(self, desc):
    """Memory for one launch's descriptors ``desc`` (bytes)."""
    if desc.size > self._size or self._used + desc.size > self.memory.numel():
      raise RuntimeError('more bf16-moment Adam launches or tensors were '
                         'recorded than the capture reserved')
    table = self.memory[self._used:self._used + desc.size]
    self._used += self._size
    self._pending.append((table, desc))
    return table

  def fill(self):
    """Write the recorded launches' descriptors (after the capture)."""
    for table, desc in self._pending:
      table.copy_(torch.from_numpy(desc))
    self._pending = []


def _descriptor_table(device, entries, chunk, captured):
  if not capturing():
    return _table(device.index, entries, chunk)
  if captured is None:
    raise RuntimeError('a captured bf16-moment Adam launch needs the '
                       'CapturedDescriptors reserved before the capture')
  desc, nchunks = _pack(entries, chunk)
  return captured.table(desc), nchunks


def storage(params, exp_avgs):
  """The (parameter, moment) storage dtypes of a parameter set: one of
  :data:`STORAGE`, shared by every tensor (one launch, one
  instantiation)."""
  pairs = {(p.dtype, m.dtype) for p, m in zip(params, exp_avgs)}
  if len(pairs) != 1 or next(iter(pairs)) not in STORAGE:
    raise ValueError(f'the Adam kernel takes one of the storage pairs '
                     f'{STORAGE} for every tensor, got {sorted(map(str, pairs))}')
  return pairs.pop()


def _check_tensors(params, grads, exp_avgs, exp_avg_sqs):
  p_dtype, m_dtype = storage(params, exp_avgs)
  for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
    for name, x, dtype in (('param', p, p_dtype), ('grad', g, p_dtype),
                           ('exp_avg', m, m_dtype),
                           ('exp_avg_sq', v, m_dtype)):
      if x.device != p.device:
        raise ValueError(f'{name} is on {x.device}, the param on {p.device}')
      if x.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {x.dtype}')
      if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
      if x.shape != p.shape:
        raise ValueError(f'{name} has shape {tuple(x.shape)}, the param '
                         f'{tuple(p.shape)}')


def _check_table(table, ctl, device):
  if (table.dtype != torch.float32 or table.dim() != 2
      or table.shape[1] != TABLE_COLS or table.shape[0] < 1
      or not table.is_contiguous()):
    raise ValueError(f'the scalar table must be contiguous float32 [n, '
                     f'{TABLE_COLS}], got {table.dtype} {tuple(table.shape)}')
  if ctl.dtype != torch.int64 or ctl.shape != (2,) or not ctl.is_contiguous():
    raise ValueError(f'ctl must be contiguous int64 [2], got {ctl.dtype} '
                     f'{tuple(ctl.shape)}')
  for name, x in (('table', table), ('ctl', ctl)):
    if x.device != device:
      raise ValueError(f'{name} is on {x.device}, the params on {device}')


def adam_bf16_plain_table(params, grads, exp_avgs, exp_avg_sqs,
                          weight_decays, table, ctl):
  """The table launch's plain version: :func:`adam_bf16_plain` with the
  scalars of row ``ctl[0] - ctl[1]``, then ``ctl[0] += 1``."""
  _check_table(table, ctl, params[0].device)
  adam_bf16_plain(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                  scalars_at(table, ctl))
  ctl[0] += 1


def adam_bf16_kernel_table(params, grads, exp_avgs, exp_avg_sqs,
                           weight_decays, table, ctl, captured=None):
  """One launch of kernels/adam.cu over every tensor (on one card) with
  the scalars of row ``ctl[0] - ctl[1]`` of ``table``, then ``ctl[0] +=
  1`` on the device; no host read, so a capture may record it (with
  ``captured``, the :class:`CapturedDescriptors` of that capture)."""
  _check_tensors(params, grads, exp_avgs, exp_avg_sqs)
  device = params[0].device
  if any(p.device != device for p in params) or device.type != 'cuda':
    raise ValueError('the bf16-moment Adam kernel takes CUDA tensors on '
                     'one device')
  lib = _lib()
  p_dtype, m_dtype = storage(params, exp_avgs)
  p_bf16, m_bf16 = int(p_dtype == BF16), int(m_dtype == BF16)
  entries = []
  for p, g, m, v, wd in zip(params, grads, exp_avgs, exp_avg_sqs,
                            weight_decays):
    if p.numel() == 0:
      continue
    # (4 elements a thread: each buffer aligned to 4 of its elements)
    vec = int(p.numel() % 4 == 0 and all(
        x.data_ptr() % (4 * x.element_size()) == 0 for x in (p, g, m, v)))
    entries.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    p.numel(), float(np.float32(wd)), vec, p_bf16, m_bf16))
  if not entries:
    return
  _check_table(table, ctl, device)
  descs, nchunks = _descriptor_table(device, tuple(entries), lib.chunk,
                                     captured)
  err = lib.adam_bf16_step(
      descs.data_ptr(), len(entries), nchunks, table.data_ptr(),
      table.shape[0], ctl.data_ptr(), p_bf16, m_bf16, device.index,
      torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'bf16-storage Adam launch failed: CUDA error {err} '
                       f'({lib.adam_error_string(err).decode()})')
  count_launch(LAUNCHES, 'adam_bf16')


def adam_bf16_kernel(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                     scalars):
  """The kernel with host ``scalars``: a one-row table and its control
  pair uploaded for this launch alone."""
  device = params[0].device
  table = torch.tensor([list(scalars) + [0.0] * (TABLE_COLS - len(scalars))],
                       dtype=torch.float32).to(device)
  ctl = torch.zeros(2, dtype=torch.int64, device=device)
  adam_bf16_kernel_table(params, grads, exp_avgs, exp_avg_sqs,
                         weight_decays, table, ctl)


def table_step(params, grads, exp_avgs, exp_avg_sqs, weight_decays, table,
               ctl, captured=None):
  """One Adam step with bf16 moments whose scalars are row ``ctl[0] -
  ctl[1]`` of ``table``, then ``ctl[0] += 1``: the kernel on CUDA
  tensors (``captured``: see :func:`adam_bf16_kernel_table`), its plain
  twin on CPU tensors."""
  device = params[0].device
  if device.type == 'cuda':
    adam_bf16_kernel_table(params, grads, exp_avgs, exp_avg_sqs,
                           weight_decays, table, ctl, captured)
  elif device.type == 'cpu':
    _check_tensors(params, grads, exp_avgs, exp_avg_sqs)
    adam_bf16_plain_table(params, grads, exp_avgs, exp_avg_sqs,
                          weight_decays, table, ctl)
  else:
    raise ValueError(f'bf16-moment Adam runs on cuda or cpu, not {device}')


def adam_bf16_step(params, grads, exp_avgs, exp_avg_sqs, weight_decays, lr,
                   step, betas=(0.9, 0.999), eps=1e-8):
  """One Adam step over bf16 storage, in place on ``params``,
  ``exp_avgs`` and ``exp_avg_sqs``.

  Args:
    params: parameter tensors (contiguous), float32 or bf16.
    grads: their gradients, in the parameters' dtype.
    exp_avgs, exp_avg_sqs: first and second moments, bf16 or float32 (one
      of the pairs of :data:`STORAGE`).
    weight_decays: one float per tensor (0 for biases).
    lr: learning rate of this step.
    step: the step's 1-based count (for the bias corrections).
  """
  scalars = step_scalars(lr, step, betas, eps)
  device = params[0].device if params else torch.device('cpu')
  if device.type == 'cuda':
    adam_bf16_kernel(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                     scalars)
  elif device.type == 'cpu':
    _check_tensors(params, grads, exp_avgs, exp_avg_sqs)
    adam_bf16_plain(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                    scalars)
  else:
    raise ValueError(f'bf16-moment Adam runs on cuda or cpu, not {device}')
