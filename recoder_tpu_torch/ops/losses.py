"""Padding-aware losses.

Port of ``recoder_tpu/ops/losses.py``: confidence-weighted MSE, the
BCE-with-logits 'logistic' loss and the multinomial NLL 'logloss', each
with optional row and column validity masks so that padded users and
padded or unsampled item columns contribute exactly zero.

Functions return the elementwise ``[B, W]`` loss; the classes apply a
reduction ('none' | 'elementwise_mean' | 'sum'). ``MultinomialNLLLoss``
takes its sums from the CUDA kernel pair (``ops/multinomial_loss.py``)
where the kernels take the operands.
"""

import torch

from recoder_tpu_torch.ops import multinomial_loss
from recoder_tpu_torch.parallel import collectives


_NEG_INF = -1e30


def _apply_masks(loss, row_mask=None, col_mask=None):
  if row_mask is not None:
    loss = loss * row_mask[:, None]
  if col_mask is not None:
    loss = loss * col_mask[None, :]
  return loss


def _mean_count(shape, row_mask=None, col_mask=None):
  """The number of valid elements 'elementwise_mean' divides by."""
  rows = torch.sum(row_mask) if row_mask is not None else shape[0]
  cols = torch.sum(col_mask) if col_mask is not None else shape[1]
  return rows * cols


def _reduce(loss, reduction, row_mask=None, col_mask=None):
  if reduction == 'none':
    return loss
  if reduction == 'sum':
    return torch.sum(loss)
  if reduction == 'elementwise_mean':
    if row_mask is None and col_mask is None:
      return torch.mean(loss)
    return torch.sum(loss) / _mean_count(loss.shape, row_mask, col_mask)
  raise ValueError(f'No such reduction {reduction} defined')


def mse_loss(input, target, confidence=0.0, row_mask=None, col_mask=None):
  """Confidence-weighted squared error ``(1 + c*[t>0]) * (t - x)^2``,
  computed in float32."""
  input = input.float()
  target = target.float()
  weights = 1.0 + confidence * (target > 0).float()
  loss = weights * torch.square(input - target)
  return _apply_masks(loss, row_mask, col_mask)


def logistic_loss(input, target, row_mask=None, col_mask=None):
  """BCE with logits in the stable form
  ``max(x, 0) - x*y + log(1 + exp(-|x|))``."""
  input = input.float()
  target = target.float()
  loss = (torch.clamp(input, min=0.0) - input * target
          + torch.log1p(torch.exp(-torch.abs(input))))
  return _apply_masks(loss, row_mask, col_mask)


def multinomial_nll_loss(input, target, row_mask=None, col_mask=None,
                         group=None):
  """Multinomial NLL ``-y * log_softmax(x)`` over the valid columns;
  masked columns are left out of the softmax normalizer.

  ``group``: the columns are this rank's share of a catalog split over a
  mesh's 'model' axis; each row's maximum and sum of exponentials are
  taken over the group's columns (two ``[B, 1]`` collectives)."""
  input = input.float()
  target = target.float()
  if col_mask is not None:
    logits = torch.where(col_mask[None, :].bool(), input,
                         torch.full_like(input, _NEG_INF))
  else:
    logits = input
  if group is None:
    shifted = logits - torch.amax(logits, dim=1, keepdim=True)
    log_z = torch.log(torch.sum(torch.exp(shifted), dim=1, keepdim=True))
  else:
    shifted = logits - collectives.max_over(
        torch.amax(logits, dim=1, keepdim=True), group)
    log_z = torch.log(collectives.sum_both(
        torch.sum(torch.exp(shifted), dim=1, keepdim=True), group))
  loss = -target * (shifted - log_z)
  return _apply_masks(loss, row_mask, col_mask)


class Loss:
  """Base loss (callable)."""

  reduction = 'sum'

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    raise NotImplementedError

  def __call__(self, input, target, row_mask=None, col_mask=None):
    loss = self.elementwise(input, target, row_mask=row_mask,
                            col_mask=col_mask)
    return _reduce(loss, self.reduction, row_mask=row_mask,
                   col_mask=col_mask)


class MSELoss(Loss):
  """Weighted MSE, ``w = 1 + confidence * 1[target > 0]``."""

  def __init__(self, confidence=0, reduction='elementwise_mean'):
    self.confidence = confidence
    self.reduction = reduction

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    return mse_loss(input, target, confidence=self.confidence,
                    row_mask=row_mask, col_mask=col_mask)


class LogisticLoss(Loss):
  """BCE-with-logits (``loss='logistic'``)."""

  def __init__(self, reduction='elementwise_mean'):
    self.reduction = reduction

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    return logistic_loss(input, target, row_mask=row_mask, col_mask=col_mask)


class MultinomialNLLLoss(Loss):
  """Negative log-likelihood of a multinomial over the item axis.

  Its 'sum' and 'elementwise_mean' take the kernels' sum
  (``multinomial_loss.multinomial_nll_sum``) where
  ``multinomial_loss.takes`` the operands (the card, bf16 or float32 rows);
  'none' and the CPU take the elementwise chain."""

  def __init__(self, reduction='elementwise_mean'):
    self.reduction = reduction

  def __call__(self, input, target, row_mask=None, col_mask=None):
    if (self.reduction in ('sum', 'elementwise_mean')
        and multinomial_loss.takes(input, target)):
      total = multinomial_loss.multinomial_nll_sum(input, target, row_mask,
                                                   col_mask)
      if self.reduction == 'sum':
        return total
      return total / _mean_count(input.shape, row_mask, col_mask)
    return super().__call__(input, target, row_mask=row_mask,
                            col_mask=col_mask)

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    return multinomial_nll_loss(input, target, row_mask=row_mask,
                                col_mask=col_mask)
