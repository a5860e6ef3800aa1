"""The port's fused decode-loss (autograd Function; on CPU tensors it
runs the plain version and its explicit backward) against the JAX
package's Pallas kernel in interpret mode and against the plain
composition of ``recoder_tpu/ops/losses.py``.

Tolerances: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 -- float32
on both sides, the sums taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recoder_tpu.experiments.pallas_loss import TILE_U
from recoder_tpu.experiments.pallas_loss import \
    fused_decode_loss as jax_fused_decode_loss
from recoder_tpu.ops import losses as jax_losses
from recoder_tpu_torch.ops import fused_decode_loss as fdl

CASES = [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]


def _problem(B, d, W, seed=0):
  rng = np.random.default_rng(seed)
  return dict(
      h=rng.normal(size=(B, d)).astype(np.float32),
      rows=rng.normal(size=(W, d)).astype(np.float32),
      bias=rng.normal(size=(W,)).astype(np.float32),
      target=(rng.random((B, W)) < 0.1).astype(np.float32),
      row_mask=(np.arange(B) < B - 2).astype(np.float32),
      col_mask=(rng.random(W) < 0.8).astype(np.float32))


def _port(p, kind, confidence, fn=fdl.fused_decode_loss):
  t = {k: torch.from_numpy(v) for k, v in p.items()}
  leaves = [t[k].clone().requires_grad_(True) for k in ('h', 'rows', 'bias')]
  loss = fn(*leaves, t['target'], t['row_mask'], t['col_mask'], kind,
            confidence)
  loss.backward()
  return loss.item(), [x.grad.numpy() for x in leaves]


def _jax_composed(p, kind, confidence):
  def composed(h, rows, bias):
    s = h @ rows.T + bias[None, :]
    if kind == 'mse':
      e = jax_losses.mse_loss(s, p['target'], confidence=confidence,
                              row_mask=p['row_mask'], col_mask=p['col_mask'])
    else:
      e = jax_losses.logistic_loss(s, p['target'], row_mask=p['row_mask'],
                                   col_mask=p['col_mask'])
    return jnp.sum(e)
  loss, grads = jax.value_and_grad(composed, argnums=(0, 1, 2))(
      p['h'], p['rows'], p['bias'])
  return float(loss), [np.asarray(g) for g in grads]


def _assert_match(got, ref):
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
  for a, b in zip(got[1], ref[1]):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('kind,confidence', CASES)
def test_matches_jax_pallas_kernel(kind, confidence):
  p = _problem(16, 24, 2 * TILE_U)

  def pallas(h, rows, bias):
    return jax_fused_decode_loss(h, rows, bias, p['target'], p['row_mask'],
                                 p['col_mask'], kind, confidence, True)
  loss, grads = jax.value_and_grad(pallas, argnums=(0, 1, 2))(
      p['h'], p['rows'], p['bias'])
  _assert_match(_port(p, kind, confidence),
                (float(loss), [np.asarray(g) for g in grads]))


@pytest.mark.parametrize('kind,confidence', CASES)
def test_matches_jax_composition(kind, confidence):
  p = _problem(16, 24, 2 * TILE_U, seed=1)
  _assert_match(_port(p, kind, confidence),
                _jax_composed(p, kind, confidence))


@pytest.mark.parametrize('kind,confidence', CASES)
def test_ragged_width_matches_plain(kind, confidence):
  """A width that is not a tile multiple: the Function (explicit
  backward) against autograd through the plain version, and the plain
  version against the JAX composition."""
  p = _problem(37, 24, 1000, seed=2)
  plain = _port(p, kind, confidence, fn=fdl.fused_decode_loss_plain)
  _assert_match(_port(p, kind, confidence), plain)
  _assert_match(plain, _jax_composed(p, kind, confidence))


def test_supported_and_routing():
  assert fdl.supported('mse') and fdl.supported('logistic')
  assert not fdl.supported('logloss')
  p = {k: torch.from_numpy(v) for k, v in _problem(4, 3, 8).items()}
  with pytest.raises(ValueError):
    fdl.fused_decode_loss(*p.values(), 'logloss', 0.0)
  meta = {k: v.to('meta') for k, v in p.items()}
  with pytest.raises(ValueError):
    fdl.fused_decode_loss(*meta.values(), 'mse', 0.0)

