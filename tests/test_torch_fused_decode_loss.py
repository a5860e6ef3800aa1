"""The port's fused decode-loss (autograd Function; on CPU tensors it
runs the plain versions of the kernels' two steps, the forward that
stashes the cotangent and the backward from it) against the JAX
package's Pallas kernel in interpret mode and against the plain
composition of ``recoder_tpu/ops/losses.py``; the wrapper's control
flow: bfloat16 targets, the upstream gradient, when the cotangent is
stashed.

Tolerances: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 -- float32
on both sides, the sums taken in different orders.
"""

from unittest import mock

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



def _as_torch(p, target_dtype=torch.float32):
  t = {k: torch.from_numpy(v) for k, v in p.items()}
  t['target'] = t['target'].to(target_dtype)
  return t


@pytest.mark.parametrize('kind,confidence', CASES)
def test_bfloat16_target_matches_float32(kind, confidence):
  """The target may be bfloat16 (the slab's storage type): the same loss
  and gradients as the float32 target, which holds the same values."""
  p = _problem(37, 24, 1000, seed=3)
  got = {}
  for dtype in (torch.float32, torch.bfloat16):
    t = _as_torch(p, dtype)
    leaves = [t[k].clone().requires_grad_(True)
              for k in ('h', 'rows', 'bias')]
    loss = fdl.fused_decode_loss(*leaves, t['target'], t['row_mask'],
                                 t['col_mask'], kind, confidence)
    loss.backward()
    got[dtype] = [loss.detach()] + [x.grad for x in leaves]
  for a, b in zip(got[torch.float32], got[torch.bfloat16]):
    assert torch.equal(a, b)


@pytest.mark.parametrize('kind,confidence', CASES)
def test_upstream_gradient_scales_the_gradients(kind, confidence):
  """The backward applies the upstream gradient g (here 1 / 7, as the
  trainer divides by the valid users): against jax.grad of the scaled
  JAX composition."""
  p = _problem(16, 24, 2 * TILE_U, seed=4)
  t = _as_torch(p)
  leaves = [t[k].clone().requires_grad_(True)
            for k in ('h', 'rows', 'bias')]
  loss = fdl.fused_decode_loss(*leaves, t['target'], t['row_mask'],
                               t['col_mask'], kind, confidence) / 7.0
  loss.backward()
  ref_loss, ref_grads = _jax_composed(p, kind, confidence)
  _assert_match((loss.item(), [x.grad.numpy() for x in leaves]),
                (ref_loss / 7.0, [g / 7.0 for g in ref_grads]))


def test_cotangent_is_stashed_only_when_a_backward_can_follow():
  """The forward writes E0 ([B, W], no upstream gradient in it) when the
  graph records the call, and not under no_grad, inference_mode or when
  no input needs a gradient."""
  p = _problem(5, 3, 7, seed=5)
  t = _as_torch(p)
  args = (t['target'], t['row_mask'], t['col_mask'], 'mse', 3.0)
  calls = []
  real = fdl._plain_forward

  def spy(*a):
    calls.append(a[-1])
    return real(*a)

  h = t['h'].clone().requires_grad_(True)
  with mock.patch.object(fdl, '_plain_forward', spy):
    loss = fdl.fused_decode_loss(h, t['rows'], t['bias'], *args)
    (e0, saved_h, saved_rows) = loss.grad_fn.saved_tensors
    assert e0.shape == (5, 7) and e0.dtype == torch.float32
    np.testing.assert_allclose(
        e0.numpy(), fdl._cotangent(t['h'] @ t['rows'].t() + t['bias'],
                                   *args).numpy())
    with torch.no_grad():
      assert fdl.fused_decode_loss(h, t['rows'], t['bias'],
                                   *args).grad_fn is None
    with torch.inference_mode():
      fdl.fused_decode_loss(h, t['rows'], t['bias'], *args)
    fdl.fused_decode_loss(t['h'], t['rows'], t['bias'], *args)
  assert calls == [True, False, False, False]
