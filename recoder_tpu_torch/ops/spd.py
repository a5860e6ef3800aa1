"""Batched SPD solves: the blocked recursion and the CUDA kernel.

Port of ``recoder_tpu/ops/spd.py``. :func:`spd_solve` solves
``a @ x = b`` for a batch of symmetric positive definite matrices by a
Cholesky factorization and two triangular solves. It has two routes:

- the **blocked recursion** (:func:`cholesky_blocked`, the plain
  version): a recursive 2x2 right-looking Cholesky whose cross-block
  work is batched matmuls and whose diagonal blocks of width ``base``
  or less go to ``torch.linalg.cholesky_ex`` and
  ``torch.linalg.solve_triangular``; d is padded to ``base * 2**k``
  with an identity diagonal. The same recursion as the JAX package's.
- the **kernel** (``kernels/spd_solve.cu``, the port of the Pallas
  ``_chol_solve_kernel``): one CUDA block per system, a panel-blocked
  Cholesky with the forward substitution folded in and a panel-blocked
  back substitution, for a 3-D batch with a vector right-hand side and
  1 <= d <= 256. :func:`kernel_resources` reports its shared memory
  and resident blocks an SM.

Routing is by the tensors' device and shape and nothing else. CUDA
tensors with a 3-D vector right-hand side and d <= 256 launch the
kernel, or raise; a matrix right-hand side or d > 256 takes the
blocked recursion on the card (a shape rule, as ``_pallas_eligible``
is one in the JAX package, and not a fallback on failure). CPU tensors
take the blocked recursion. ``impl='kernel'`` forces the kernel and
raises on anything it does not take, CPU tensors included.

A matrix that is not positive definite gives NaN on both routes, as
``jnp.linalg.cholesky`` does (``torch.linalg.cholesky`` would raise).
"""

import ctypes

import torch
import torch.nn.functional as F

from recoder_tpu_torch.kernels import I32, PTR, Library, count_launch

IMPLS = ('auto', 'blocked', 'kernel')
#: widest system the kernel takes (its packed triangle in shared memory)
KERNEL_MAX_D = 256

#: kernel launches since the last reset
LAUNCHES = {'spd_solve': 0}


def _constants(lib):
  if lib.spd_max_d() != KERNEL_MAX_D:
    raise RuntimeError(f'spd_solve.cu takes d <= {lib.spd_max_d()}, '
                       f'the wrapper expects {KERNEL_MAX_D}')


LIBRARY = Library('spd_solve', 'spd', {
    'spd_solve_batched': ([PTR, PTR, PTR, I32, I32, I32, PTR],
                          'spd_solve launch'),
    'spd_occupancy': ([I32, I32, PTR, PTR], 'spd_occupancy'),
    'spd_max_d': ([], None)}, constants=_constants)


def _t(x):
  return x.transpose(-1, -2)


def _cholesky_base(a):
  l, info = torch.linalg.cholesky_ex(a)
  return l.masked_fill((info != 0)[..., None, None], float('nan'))


def _chol(a, base):
  d = a.shape[-1]
  if d <= base:
    return _cholesky_base(a)
  h = d // 2
  a11 = a[..., :h, :h]
  a21 = a[..., h:, :h]
  a22 = a[..., h:, h:]
  l11 = _chol(a11, base)
  # L21 solves L21 @ L11^T = A21 (a RIGHT lower-transposed system)
  l21 = _solve_right_lt(l11, a21, base)
  s = a22 - torch.matmul(l21, _t(l21))  # Schur complement
  l22 = _chol(s, base)
  top = torch.cat([l11, l11.new_zeros(l11.shape[:-2] + (h, d - h))], dim=-1)
  bot = torch.cat([l21, l22], dim=-1)
  return torch.cat([top, bot], dim=-2)


def _solve_right_lt(l, b, base):
  """X @ L^T = B for X, with L lower-triangular [..., h, h] and
  B [..., m, h]."""
  h = l.shape[-1]
  if h <= base:
    return torch.linalg.solve_triangular(_t(l), b, upper=True, left=False)
  k = h // 2
  l11 = l[..., :k, :k]
  l21 = l[..., k:, :k]
  l22 = l[..., k:, k:]
  x1 = _solve_right_lt(l11, b[..., :k], base)
  x2 = _solve_right_lt(l22, b[..., k:] - torch.matmul(x1, _t(l21)), base)
  return torch.cat([x1, x2], dim=-1)


def _solve_lower(l, b, base, transpose):
  """L y = b (transpose=False) or L^T x = b (True); b [..., d, k]."""
  d = l.shape[-1]
  if d <= base:
    if transpose:
      return torch.linalg.solve_triangular(_t(l), b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)
  h = d // 2
  l11 = l[..., :h, :h]
  l21 = l[..., h:, :h]
  l22 = l[..., h:, h:]
  b1, b2 = b[..., :h, :], b[..., h:, :]
  if not transpose:
    y1 = _solve_lower(l11, b1, base, False)
    y2 = _solve_lower(l22, b2 - torch.matmul(l21, y1), base, False)
    return torch.cat([y1, y2], dim=-2)
  x2 = _solve_lower(l22, b2, base, True)
  x1 = _solve_lower(l11, b1 - torch.matmul(_t(l21), x2), base, True)
  return torch.cat([x1, x2], dim=-2)


def _pad_pow2(d, base):
  """Smallest base * 2^k >= d (the recursion halves down to base)."""
  p = base
  while p < d:
    p *= 2
  return p


def _pad_identity(a, p):
  """[..., d, d] -> [..., p, p] with an identity diagonal in the pad."""
  d = a.shape[-1]
  diag = torch.cat([a.new_zeros(d), a.new_ones(p - d)])
  return F.pad(a, (0, p - d, 0, p - d)) + torch.diag(diag)


def cholesky_blocked(a, base=16):
  """Batched lower Cholesky of SPD ``a`` [..., d, d].

  Pads d up to base * 2^k with an identity diagonal (the padded
  factor is block-diagonal [L, I], sliced away), so any d is legal.
  """
  d = a.shape[-1]
  p = _pad_pow2(d, base)
  if p != d:
    a = _pad_identity(a, p)
  l = _chol(a, base)
  return l[..., :d, :d] if p != d else l


def spd_solve_blocked(a, b, base=16):
  """The plain version: the blocked recursion for ``b`` [..., d] or
  [..., d, k]."""
  vec = b.dim() == a.dim() - 1
  if vec:
    b = b[..., None]
  d = a.shape[-1]
  p = _pad_pow2(d, base)
  if p != d:
    a = _pad_identity(a, p)
    b = F.pad(b, (0, 0, 0, p - d))
  l = _chol(a, base)
  y = _solve_lower(l, b, base, transpose=False)
  x = _solve_lower(l, y, base, transpose=True)
  if p != d:
    x = x[..., :d, :]
  return x[..., 0] if vec else x


def _validate(a, b):
  if a.device.type != 'cuda':
    raise ValueError(f'the spd_solve kernel needs CUDA tensors, a is on '
                     f'{a.device}')
  if b.device != a.device:
    raise ValueError(f'b is on {b.device}, a on {a.device}')
  for name, x in (('a', a), ('b', b)):
    if x.dtype != torch.float32:
      raise ValueError(f'{name} must be float32, got {x.dtype}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  if a.dim() != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
    raise ValueError(f'the kernel takes a [B, d, d] and b [B, d], got '
                     f'a {tuple(a.shape)} b {tuple(b.shape)}')
  d = a.shape[-1]
  if not 1 <= d <= KERNEL_MAX_D:
    raise ValueError(f'system width {d} outside 1..{KERNEL_MAX_D}')


def spd_solve_kernel(a, b):
  """The CUDA kernel: x [B, d] with a [B, d, d] @ x = b [B, d]."""
  _validate(a, b)
  B, d = b.shape
  x = torch.empty_like(b)
  if B == 0:
    return x
  stream = torch.cuda.current_stream(a.device).cuda_stream
  LIBRARY().spd_solve_batched(a.data_ptr(), b.data_ptr(), x.data_ptr(), B, d,
                              a.device.index or 0, stream)
  count_launch(LAUNCHES, 'spd_solve')
  return x


def kernel_resources(d):
  """What the kernel takes at width ``d`` on the current card: the dynamic
  shared memory of one block in bytes, and the blocks an SM keeps
  resident."""
  if not 1 <= d <= KERNEL_MAX_D:
    raise ValueError(f'system width {d} outside 1..{KERNEL_MAX_D}')
  smem, blocks = I32(0), I32(0)
  LIBRARY().spd_occupancy(d, torch.cuda.current_device(), ctypes.byref(smem),
                          ctypes.byref(blocks))
  return {'smem_bytes': smem.value, 'blocks_per_sm': blocks.value}


def _kernel_route(a, b):
  if a.device.type == 'cpu':
    return False
  if a.device.type != 'cuda':
    raise ValueError(f'spd_solve runs on cuda or cpu, not {a.device}')
  return b.dim() == 2 and a.dim() == 3 and a.shape[-1] <= KERNEL_MAX_D


def spd_solve(a, b, base=16, impl='auto'):
  """Solve ``a @ x = b`` for batched SPD ``a`` [..., d, d].

  ``b`` is [..., d] or [..., d, k]; returns x with b's shape.

  ``impl``: 'auto' launches the CUDA kernel for CUDA tensors with a 3-D
  vector right-hand side and d <= 256 and takes the blocked recursion
  otherwise; 'blocked' or 'kernel' force a route.
  """
  if impl not in IMPLS:
    raise ValueError(f'unknown impl {impl!r}')
  if impl == 'kernel' or (impl == 'auto' and _kernel_route(a, b)):
    return spd_solve_kernel(a, b)
  return spd_solve_blocked(a, b, base)
