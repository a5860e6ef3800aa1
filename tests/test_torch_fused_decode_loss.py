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


def _aligned(shape, dtype, offset=0):
  """A contiguous tensor of ``shape`` starting ``offset`` elements into a
  16-byte aligned buffer."""
  n = int(np.prod(shape))
  buf = torch.zeros(n + 64, dtype=dtype)
  skip = (-buf.data_ptr() % 16) // buf.element_size() + offset
  return buf[skip:skip + n].view(shape)


#: (B, d, W, target dtype, element offsets of h / rows / target, route)
ROUTE_CASES = [
    (500, 200, 20224, torch.bfloat16, (0, 0, 0), 'wgmma'),   # bench ML-20M
    (480, 200, 18120, torch.bfloat16, (0, 0, 0), 'wgmma'),   # aligned, not 2^k
    (37, 200, 1000, torch.bfloat16, (0, 0, 0), 'wgmma'),     # B < one tile
    (500, 200, 20224, torch.bfloat16, (0, 0, 8), 'wgmma'),   # 16-byte offset
    (500, 200, 18117, torch.bfloat16, (0, 0, 0), 'mma'),     # MSD union width
    (500, 200, 20220, torch.bfloat16, (0, 0, 0), 'mma'),     # W % 8 == 4
    (500, 200, 20224, torch.float32, (0, 0, 0), 'mma'),      # float32 target
    (37, 24, 1000, torch.bfloat16, (0, 0, 0), 'mma'),        # d not compiled
    (480, 104, 18120, torch.bfloat16, (0, 0, 0), 'mma'),     # d not compiled
    (64, 256, 2048, torch.bfloat16, (0, 0, 0), 'mma'),       # no room for 1s
    (500, 200, 20224, torch.bfloat16, (0, 0, 1), 'mma'),     # target 2 B off
    (500, 200, 20224, torch.bfloat16, (0, 2, 0), 'mma'),     # rows 8 B off
    (500, 200, 20224, torch.bfloat16, (1, 0, 0), 'wgmma'),   # h: cast
]


@pytest.mark.parametrize('B,d,W,tdtype,offsets,route', ROUTE_CASES)
def test_bf16_route(B, d, W, tdtype, offsets, route):
  """The shape rule between the two bf16 kernel sets: the wgmma kernels
  where TMA can describe every operand (a bf16 target with W % 8 == 0, a
  compiled feature width, 16-byte aligned rows and target; h goes
  through a bf16 copy), the mma.sync kernels elsewhere."""
  h = _aligned((B, d), torch.float32, offsets[0])
  rows = _aligned((W, d), torch.float32, offsets[1])
  target = _aligned((B, W), tdtype, offsets[2])
  assert fdl.bf16_route(h, rows, target) == route
  if route == 'wgmma':
    assert d in fdl.WGMMA_WIDTHS and W % 8 == 0


def test_bf16_route_on_the_cpu_runs_the_plain_twin():
  """A shape the wgmma kernels take still runs the plain versions on
  CPU tensors: no counter of either route moves."""
  p = _as_torch(_problem(16, 200, 64), torch.bfloat16)
  assert fdl.bf16_route(p['h'], p['rows'], p['target']) == 'wgmma'
  before = dict(fdl.LAUNCHES)
  leaves = [p[k].clone().requires_grad_(True) for k in ('h', 'rows', 'bias')]
  fdl.fused_decode_loss(*leaves, p['target'], p['row_mask'], p['col_mask'],
                        'mse', 3.0, 'bfloat16').backward()
  assert fdl.LAUNCHES == before
  assert all(x.grad is not None for x in leaves)



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
