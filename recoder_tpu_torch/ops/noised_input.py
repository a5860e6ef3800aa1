"""The encoder's input: the dense rows L2-normalized, then the noise mask
(inverted dropout): the CUDA kernel and its plain twin.

The plain chain is the JAX package's ``l2_normalize_rows`` and
``dropout`` (``recoder_tpu/models/base.py``), which XLA fuses: the sum of
squares in float32, the norm clamped at 1e-12 and rounded to the input's
dtype, the rows divided by it, then the kept elements divided by the keep
probability and the others zero. On the card it is about ten passes over
the ``[B, W]`` rows; ``kernels/noised_input.cu`` makes one, with the same
roundings (the row's sum of squares in another order: a bf16 ulp at most,
and none for rows of zeros and ones).

The kernel takes bf16 rows (row stride >= W, unit column stride) and a
keep mask of one byte an element (bool / uint8); it draws no random
number: the caller draws the mask with ``bernoulli_``, so
that the Philox stream, its offset and every bit stay those of the plain
chain (``models/base.noised_input`` routes between the two).
"""

import numpy as np
import torch

from recoder_tpu_torch.kernels import F32, I32, I64, PTR, Library, count_launch

#: kernel launches since the last reset
LAUNCHES = {'noised_input': 0}
#: the mask's dtype as the kernel's route draws it: one byte an element
#: gives the bf16 draw's bits and Philox offset (``bernoulli_`` draws one
#: float32 uniform an element whatever the output's dtype)
MASK_DTYPE = torch.bool

LIBRARY = Library('noised_input', 'ni', {
    'ni_noised_input': ([PTR, I64, I32, I32, PTR, F32, PTR, I32, PTR],
                        'noised_input launch')})


def l2_normalize_rows(x, eps=1e-12):
  """Row-wise L2 normalize, as ``torch.nn.functional.normalize(p=2,
  dim=1)``; the squared sum accumulates in float32."""
  sq = torch.sum(torch.square(x.float()), dim=1, keepdim=True)
  norm = torch.clamp(torch.sqrt(sq), min=eps)
  return x / norm.to(x.dtype)


def dropout(x, rate, generator=None, keep_mask=None, rows=None):
  """Inverted dropout (``torch.nn.Dropout`` train-mode scaling).

  The keep mask is drawn from ``generator`` (on ``x``'s device) unless
  ``keep_mask`` is given; tests pass one to feed both frameworks the
  same mask. ``rows = (lo, hi, n)``: ``x`` is rows ``[lo, hi)`` of an
  ``n``-row batch (a mesh rank's users), and the mask is those rows of
  the whole batch's draw, the mask a single device draws.
  """
  keep = 1.0 - rate
  if keep_mask is None and rows is not None:
    lo, hi, n = rows
    keep_mask = torch.empty((n, *x.shape[1:]), dtype=x.dtype,
                            device=x.device).bernoulli_(
                                keep, generator=generator)[lo:hi]
  elif keep_mask is None:
    keep_mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
  return torch.where(keep_mask.bool(), x / keep, torch.zeros_like(x))


def noised_input_plain(x, rate, generator=None, keep_mask=None, rows=None):
  """Plain PyTorch version: ``dropout(l2_normalize_rows(x), rate, ...)``,
  the normalization alone at ``rate`` 0 (no noise, or not training)."""
  z = l2_normalize_rows(x)
  if rate > 0:
    z = dropout(z, rate, generator, keep_mask, rows)
  return z


def takes(x):
  """Whether the kernel takes ``x``: bf16 rows on the card, unit column
  stride."""
  return (x.device.type == 'cuda' and x.dtype == torch.bfloat16
          and x.dim() == 2 and x.stride(1) == 1
          and x.stride(0) >= x.shape[1])


def noised_input_kernel(x, rate, keep_mask=None):
  """The CUDA kernel: one launch on the current stream.

  Args:
    x: [B, W] bf16 on the card, unit column stride (a row stride >= W).
    rate: the noise rate; 0 normalizes alone and takes no mask.
    keep_mask: [B, W] contiguous, bool or uint8, on ``x``'s device (any
      non-zero byte keeps); needed when ``rate > 0``.

  Returns z [B, W] bf16, contiguous (an empty z without a launch).
  """
  if x.device.type != 'cuda':
    raise ValueError(f'the noised_input kernel needs a CUDA tensor, x is on '
                     f'{x.device}')
  if x.dim() != 2 or x.dtype != torch.bfloat16:
    raise ValueError(f'x must be a 2-D bfloat16 tensor, got {x.dtype} '
                     f'{tuple(x.shape)}')
  if not takes(x):
    raise ValueError(f'x must have unit column stride and a row stride of '
                     f'at least its width, got strides {x.stride()}')
  B, W = x.shape
  if W > 2 ** 31 - 1 or B > 2 ** 31 - 1:
    raise ValueError(f'x of shape {tuple(x.shape)} is outside the kernel\'s '
                     'sizes')
  if not 0.0 <= rate <= 1.0:
    raise ValueError(f'rate={rate} is outside [0, 1]')
  scale = 1.0
  if rate > 0:
    if keep_mask is None:
      raise ValueError('a noise rate above 0 needs a keep mask')
    if tuple(keep_mask.shape) != (B, W):
      raise ValueError(f'keep_mask of shape {tuple(keep_mask.shape)} does not '
                       f'fit x {tuple(x.shape)}')
    if keep_mask.dtype not in (torch.bool, torch.uint8):
      raise ValueError(f'keep_mask must be bool or uint8, got '
                       f'{keep_mask.dtype}')
    if keep_mask.device != x.device or not keep_mask.is_contiguous():
      raise ValueError('keep_mask must be contiguous, on x\'s device')
    # PyTorch divides a CUDA tensor by a host scalar as a multiply by its
    # float32 reciprocal
    keep = np.float32(1.0 - rate)
    scale = float(np.float32(1.0) / keep) if keep else float('inf')
  z = torch.empty((B, W), dtype=torch.bfloat16, device=x.device)
  if z.numel() == 0:
    return z
  stream = torch.cuda.current_stream(x.device).cuda_stream
  LIBRARY().ni_noised_input(
      x.data_ptr(), x.stride(0), B, W,
      keep_mask.data_ptr() if rate > 0 else None, scale, z.data_ptr(),
      x.device.index or 0, stream)
  count_launch(LAUNCHES, 'noised_input')
  return z
