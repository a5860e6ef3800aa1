"""Padding-aware losses.

Port of ``recoder_tpu/ops/losses.py``: confidence-weighted MSE, the
BCE-with-logits 'logistic' loss and the multinomial NLL 'logloss', each
with optional row and column validity masks so that padded users and
padded or unsampled item columns contribute exactly zero.

Functions return the elementwise ``[B, W]`` loss; the classes apply a
reduction ('none' | 'elementwise_mean' | 'sum').
"""

import torch


_NEG_INF = -1e30


def _apply_masks(loss, row_mask=None, col_mask=None):
  if row_mask is not None:
    loss = loss * row_mask[:, None]
  if col_mask is not None:
    loss = loss * col_mask[None, :]
  return loss


def _reduce(loss, reduction, row_mask=None, col_mask=None):
  if reduction == 'none':
    return loss
  if reduction == 'sum':
    return torch.sum(loss)
  if reduction == 'elementwise_mean':
    if row_mask is None and col_mask is None:
      return torch.mean(loss)
    rows = torch.sum(row_mask) if row_mask is not None else loss.shape[0]
    cols = torch.sum(col_mask) if col_mask is not None else loss.shape[1]
    return torch.sum(loss) / (rows * cols)
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


def multinomial_nll_loss(input, target, row_mask=None, col_mask=None):
  """Multinomial NLL ``-y * log_softmax(x)`` over the valid columns;
  masked columns are left out of the softmax normalizer."""
  input = input.float()
  target = target.float()
  if col_mask is not None:
    logits = torch.where(col_mask[None, :].bool(), input,
                         torch.full_like(input, _NEG_INF))
  else:
    logits = input
  shifted = logits - torch.amax(logits, dim=1, keepdim=True)
  log_z = torch.log(torch.sum(torch.exp(shifted), dim=1, keepdim=True))
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
  """Negative log-likelihood of a multinomial over the item axis."""

  def __init__(self, reduction='elementwise_mean'):
    self.reduction = reduction

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    return multinomial_nll_loss(input, target, row_mask=row_mask,
                                col_mask=col_mask)
