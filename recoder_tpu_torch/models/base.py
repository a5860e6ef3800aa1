"""Base factorization-model interface and init/shape helpers.

Port of ``recoder_tpu/models/base.py``. Every model pads its item axis
to a multiple of ``LANE_ALIGN`` with at least one extra sentinel row
(index ``num_items``). The port keeps that layout, although Hopper has
no 128-lane tiling, so that parameters and checkpoints have the JAX
shapes; the sentinel and pad rows are initialized like real rows and
masked out of every loss and every recommendation.
"""

import math

import torch
from torch import nn


LANE_ALIGN = 256


def pad_dim(n, align=LANE_ALIGN):
  """Smallest multiple of ``align`` strictly greater than ``n``.

  Strictly greater so index ``n`` is always a valid sentinel row.
  """
  return ((int(n) + 1 + align - 1) // align) * align


def activation(x, act):
  """Apply an activation by name ('none' or a torch function name such
  as 'tanh', 'relu', 'sigmoid')."""
  if act == 'none':
    return x
  fn = getattr(torch.nn.functional, act, None)
  if fn is None:
    fn = getattr(torch, act)
  return fn(x)


def xavier_uniform(shape, fan_in, fan_out, generator=None):
  """torch-style xavier_uniform_ (gain=1) with explicit fans:
  U(-a, a), a = sqrt(6 / (fan_in + fan_out)).

  Padded tables pass their *logical* fans, so the init scale matches an
  unpadded table's.
  """
  limit = math.sqrt(6.0 / (fan_in + fan_out))
  return torch.empty(shape, dtype=torch.float32).uniform_(
      -limit, limit, generator=generator)


def l2_normalize_rows(x, eps=1e-12):
  """Row-wise L2 normalize, as ``torch.nn.functional.normalize(p=2,
  dim=1)``; the squared sum accumulates in float32."""
  sq = torch.sum(torch.square(x.float()), dim=1, keepdim=True)
  norm = torch.clamp(torch.sqrt(sq), min=eps)
  return x / norm.to(x.dtype)


def dropout(x, rate, generator=None, keep_mask=None):
  """Inverted dropout (``torch.nn.Dropout`` train-mode scaling).

  The keep mask is drawn from ``generator`` (on ``x``'s device) unless
  ``keep_mask`` is given; tests pass one to feed both frameworks the
  same mask.
  """
  keep = 1.0 - rate
  if keep_mask is None:
    keep_mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
  return torch.where(keep_mask.bool(), x / keep, torch.zeros_like(x))


class FactorizationModel(nn.Module):
  """Base class for factorization models.

  Subclasses implement ``init_model`` (creating the parameters under
  their JAX names), ``model_params``, ``load_model_params`` and
  ``forward``.
  """

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters for a catalog of ``num_items``/``num_users``."""
    raise NotImplementedError

  def model_params(self):
    """Hyper-parameters dict, stored in checkpoints."""
    raise NotImplementedError

  def load_model_params(self, model_params):
    """Restore hyper-parameters from a checkpoint dict."""
    raise NotImplementedError

  def params(self):
    """``{jax_name: parameter}`` -- the names the checkpoint uses."""
    return dict(self.named_parameters())
