"""The multinomial loss summed (the 'logloss' of Mult-VAE and of logloss
autoencoders): the CUDA kernel pair and its plain twin.

The plain version is ``ops/losses.multinomial_nll_loss`` summed: a float32
chain over ``[B, W]`` (the scores and the target cast to float32, the
column mask's select, the row's maximum, ``exp``, the row sums, ``log``, the
masks' products) whose autograd backward is as long again; on the card some
sixty passes over a float32 ``[B, W]``. ``kernels/multinomial_loss.cu``
computes the same sum and gradient in two passes over the scores and the
target as they are stored (bf16 or float32), in float32 arithmetic: the
forward keeps each row's ``(m, log z, T)`` (its maximum over the valid
columns, the log of its sum of ``exp(s - m)``, its target's weight) and the
sum of the row losses ``rm (T log z - sum cm t (s - m))``; the backward
writes ``go rm (T exp(s - m - log z) - cm t)`` at the valid columns and 0
elsewhere, in the scores' dtype.

``MultinomialNLLLoss`` (``ops/losses.py``) routes its 'sum' and
'elementwise_mean' reductions here for what :func:`takes` accepts; the
CPU, 'none' and a catalog split over a mesh's 'model' axis (``group``)
keep the plain chain.
"""

import torch

from recoder_tpu_torch.kernels import I32, I64, PTR, Library, count_launch

#: kernel launches since the last reset ('mnll_fwd': the forward pass with
#: its one-block combine; 'mnll_bwd': the gradient's pass)
LAUNCHES = {'mnll_fwd': 0, 'mnll_bwd': 0}
#: the storage dtypes the kernels read (and the gradient's: the scores')
DTYPES = (torch.bfloat16, torch.float32)

#: a launch's operands (:func:`_operands`)
_OPERANDS = [PTR, I32, I64, PTR, I32, I64, I32, I32, I32, PTR, PTR]
LIBRARY = Library('multinomial_loss', 'mnll', {
    'mnll_segments': ([I32, I32, I32], None),
    'mnll_forward': (_OPERANDS + [PTR, PTR, PTR, I32, PTR],
                     'multinomial_loss forward launch'),
    'mnll_backward': (_OPERANDS + [PTR, PTR, PTR, I32, PTR],
                      'multinomial_loss backward launch')})


def multinomial_nll_plain(scores, target, row_mask=None, col_mask=None):
  """Plain PyTorch version: the elementwise chain
  (``ops/losses.multinomial_nll_loss``) summed."""
  from recoder_tpu_torch.ops.losses import multinomial_nll_loss
  return torch.sum(multinomial_nll_loss(scores, target, row_mask=row_mask,
                                        col_mask=col_mask))


def _rows_ok(x):
  return (x.dim() == 2 and x.dtype in DTYPES and x.stride(1) == 1
          and x.stride(0) >= x.shape[1])


def takes(scores, target, group=None):
  """Whether the kernels take the loss: scores and target of one shape on
  the card, each bf16 or float32 with unit column stride (a row stride >=
  W), the target needing no gradient, and no mesh ``group``."""
  return (group is None and scores.device.type == 'cuda'
          and target.device == scores.device
          and scores.shape == target.shape and _rows_ok(scores)
          and _rows_ok(target) and not target.requires_grad)


def _segments(B, W, device):
  """The blocks a row is split over (the kernels' choice for B rows of W
  columns on this card)."""
  S = LIBRARY().mnll_segments(B, W, device)
  if S < 1:
    raise RuntimeError(f'multinomial_loss: no launch shape for [{B}, {W}] on '
                       f'cuda:{device}')
  return S


def _mask(mask, n, scores, name):
  """A mask as the kernels read it: float32, contiguous, [n], on the
  scores' device (None: no mask)."""
  if mask is None:
    return None
  if tuple(mask.shape) != (n,):
    raise ValueError(f'{name} of shape {tuple(mask.shape)} does not fit the '
                     f'scores {tuple(scores.shape)}')
  if mask.device != scores.device:
    raise ValueError(f'{name} must be on the scores\' device {scores.device}, '
                     f'not {mask.device}')
  if mask.requires_grad:
    raise ValueError(f'the kernels give {name} no gradient')
  return mask.to(torch.float32).contiguous()


def _operands(scores, target, B, W, S, cm, rm):
  return (scores.data_ptr(), int(scores.dtype == torch.bfloat16),
          scores.stride(0), target.data_ptr(),
          int(target.dtype == torch.bfloat16), target.stride(0), B, W, S,
          None if cm is None else cm.data_ptr(),
          None if rm is None else rm.data_ptr())


class _MultinomialNLLSum(torch.autograd.Function):
  """The kernel pair as an autograd function of the scores."""

  @staticmethod
  def forward(ctx, scores, target, rm, cm):
    B, W = scores.shape
    ctx.empty = B == 0 or W == 0
    if ctx.empty:
      ctx.save_for_backward(scores)
      return torch.zeros((), dtype=torch.float32, device=scores.device)
    device = scores.device.index or 0
    S = _segments(B, W, device)
    part = torch.empty((B * S, 4), dtype=torch.float32, device=scores.device)
    stats = torch.empty((B, 3), dtype=torch.float32, device=scores.device)
    out = torch.empty((), dtype=torch.float32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    LIBRARY().mnll_forward(*_operands(scores, target, B, W, S, cm, rm),
                           part.data_ptr(), stats.data_ptr(), out.data_ptr(),
                           device, stream)
    count_launch(LAUNCHES, 'mnll_fwd')
    ctx.S = S
    ctx.save_for_backward(scores, target, rm, cm, stats)
    return out

  @staticmethod
  def backward(ctx, go):
    if not ctx.needs_input_grad[0]:
      return None, None, None, None
    if ctx.empty:
      scores, = ctx.saved_tensors
      return torch.zeros_like(scores), None, None, None
    scores, target, rm, cm, stats = ctx.saved_tensors
    B, W = scores.shape
    device = scores.device.index or 0
    go = go.to(torch.float32).contiguous()
    g = torch.empty((B, W), dtype=scores.dtype, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    LIBRARY().mnll_backward(
        *_operands(scores, target, B, W, ctx.S, cm, rm), stats.data_ptr(),
        go.data_ptr(), g.data_ptr(), device, stream)
    count_launch(LAUNCHES, 'mnll_bwd')
    return g, None, None, None


def multinomial_nll_sum(scores, target, row_mask=None, col_mask=None):
  """The kernels' loss: ``multinomial_nll_plain`` of the same arguments, a
  float32 0-dim tensor, differentiable in ``scores`` (its gradient in the
  scores' dtype, contiguous). Launches the forward now and the backward
  when autograd asks; an empty ``[B, W]`` launches nothing and gives 0.

  Args:
    scores: [B, W] bf16 or float32 on the card, unit column stride (a row
      stride >= W).
    target: [B, W] bf16 or float32 on the scores' device, as ``scores``.
    row_mask: [B] or None (ones).
    col_mask: [W] or None (ones): the valid columns (non-zero) and their
      weights in the loss.
  """
  if scores.device.type != 'cuda':
    raise ValueError(f'the multinomial_loss kernels need CUDA tensors, the '
                     f'scores are on {scores.device}')
  for name, x in (('scores', scores), ('target', target)):
    if x.dim() != 2 or x.dtype not in DTYPES:
      raise ValueError(f'{name} must be a 2-D bfloat16 or float32 tensor, got '
                       f'{x.dtype} {tuple(x.shape)}')
    if not _rows_ok(x):
      raise ValueError(f'{name} must have unit column stride and a row '
                       f'stride of at least its width, got strides '
                       f'{x.stride()}')
  if target.shape != scores.shape or target.device != scores.device:
    raise ValueError(f'target {tuple(target.shape)} on {target.device} does '
                     f'not fit the scores {tuple(scores.shape)} on '
                     f'{scores.device}')
  if target.requires_grad:
    raise ValueError('the kernels give the target no gradient')
  B, W = scores.shape
  if W > 2 ** 31 - 8 or B > 2 ** 31 - 1:
    raise ValueError(f'scores of shape {tuple(scores.shape)} are outside the '
                     'kernels\' sizes')
  rm = _mask(row_mask, B, scores, 'row_mask')
  cm = _mask(col_mask, W, scores, 'col_mask')
  return _MultinomialNLLSum.apply(scores, target, rm, cm)
