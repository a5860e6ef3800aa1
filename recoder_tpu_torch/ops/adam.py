"""Fused Adam step with bfloat16 moments: the CUDA kernel and its plain
twin.

The JAX package's ``Optimizer('adam', state_dtype='bfloat16')``
(``recoder_tpu/optim.py``): moments stored in bf16, the update math in
float32 -- the weight decay added to the gradient, the new moments, the
parameter step with the unrounded new moments -- and one
round-to-nearest-even on store. It has no Pallas ancestor; on the card it
is ``kernels/adam.cu``, one launch for every tensor of a parameter set.

Routing is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors take :func:`adam_bf16_plain`, which does the same
float32 operations in the same order (the kernel is built without
multiply-add contraction), so the two agree bit for bit.

The host computes the step's scalars in float32 as the JAX package does
(:func:`step_scalars`).
"""

import ctypes
import functools
import threading
from collections import namedtuple

import numpy as np
import torch

BF16 = torch.bfloat16
#: kernel launches since the last reset
LAUNCHES = {'adam_bf16': 0}

#: one tensor's descriptor, as ``struct Desc`` in kernels/adam.cu
DESC = np.dtype({'names': ['p', 'g', 'm', 'v', 'n', 'chunk0', 'wd', 'vec'],
                 'formats': ['<u8', '<u8', '<u8', '<u8', '<i8', '<i8', '<f4',
                             '<i4'],
                 'offsets': [0, 8, 16, 24, 32, 40, 48, 52],
                 'itemsize': 56})

Scalars = namedtuple('Scalars',
                     'lr_bc1 b1 omb1 b2 omb2 sqrt_bc2 eps')

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


def adam_bf16_plain(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                    scalars):
  """The kernel's plain version, in place: each operation of
  kernels/adam.cu as one PyTorch op, divisions by tensors (CUDA divides
  by a host scalar as a multiply by its reciprocal)."""
  c = scalars
  for p, g, m, v, wd in zip(params, grads, exp_avgs, exp_avg_sqs,
                            weight_decays):
    sqrt_bc2 = torch.tensor(c.sqrt_bc2, device=p.device)
    g = g + wd * p
    m1 = c.b1 * m.float() + c.omb1 * g
    v1 = c.b2 * v.float() + (c.omb2 * g) * g
    denom = torch.sqrt(v1) / sqrt_bc2 + c.eps
    p.sub_((c.lr_bc1 * m1) / denom)
    m.copy_(m1)
    v.copy_(v1)


def _lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      from recoder_tpu_torch.kernels import load_library
      lib = load_library('adam')
      ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
      lib.adam_bf16_step.argtypes = [ptr, i32, i32] + [f32] * 7 + [i32, ptr]
      lib.adam_bf16_step.restype = i32
      lib.adam_chunk.restype = i32
      lib.chunk = lib.adam_chunk()
      lib.adam_error_string.argtypes = [i32]
      lib.adam_error_string.restype = ctypes.c_char_p
      _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=16)
def _table(device_index, entries, chunk):
  """The descriptor table of ``entries`` ((p, g, m, v pointers, n, wd,
  vec) per tensor) in device memory, and the launch's chunk count. Built
  once per parameter set: the key is every pointer, so a table is reused
  only for the same tensors."""
  desc = np.zeros(len(entries), DESC)
  chunk0 = 0
  for i, (p, g, m, v, n, wd, vec) in enumerate(entries):
    desc[i] = (p, g, m, v, n, chunk0, wd, vec)
    chunk0 += -(-n // chunk)
  table = torch.from_numpy(desc.view(np.uint8)).to(
      torch.device('cuda', device_index))
  return table, chunk0


def _check_tensors(params, grads, exp_avgs, exp_avg_sqs):
  for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
    for name, x, dtype in (('param', p, torch.float32),
                           ('grad', g, torch.float32),
                           ('exp_avg', m, BF16), ('exp_avg_sq', v, BF16)):
      if x.device != p.device:
        raise ValueError(f'{name} is on {x.device}, the param on {p.device}')
      if x.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {x.dtype}')
      if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
      if x.shape != p.shape:
        raise ValueError(f'{name} has shape {tuple(x.shape)}, the param '
                         f'{tuple(p.shape)}')


def adam_bf16_kernel(params, grads, exp_avgs, exp_avg_sqs, weight_decays,
                     scalars):
  """One launch of kernels/adam.cu over every tensor (on one card)."""
  _check_tensors(params, grads, exp_avgs, exp_avg_sqs)
  device = params[0].device
  if any(p.device != device for p in params) or device.type != 'cuda':
    raise ValueError('the bf16-moment Adam kernel takes CUDA tensors on '
                     'one device')
  lib = _lib()
  entries = []
  for p, g, m, v, wd in zip(params, grads, exp_avgs, exp_avg_sqs,
                            weight_decays):
    if p.numel() == 0:
      continue
    ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
    vec = int(p.numel() % 4 == 0 and ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0
              and ptrs[2] % 8 == 0 and ptrs[3] % 8 == 0)
    entries.append((*ptrs, p.numel(), float(np.float32(wd)), vec))
  if not entries:
    return
  table, nchunks = _table(device.index, tuple(entries), lib.chunk)
  err = lib.adam_bf16_step(
      table.data_ptr(), len(entries), nchunks, *scalars, device.index,
      torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'bf16-moment Adam launch failed: CUDA error {err} '
                       f'({lib.adam_error_string(err).decode()})')
  LAUNCHES['adam_bf16'] += 1


def adam_bf16_step(params, grads, exp_avgs, exp_avg_sqs, weight_decays, lr,
                   step, betas=(0.9, 0.999), eps=1e-8):
  """One Adam step with bf16 moments, in place on ``params``,
  ``exp_avgs`` and ``exp_avg_sqs``.

  Args:
    params: float32 parameter tensors (contiguous).
    grads: their float32 gradients.
    exp_avgs, exp_avg_sqs: bf16 first and second moments.
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
