"""The port's DynamicAutoencoder against the JAX package's, from the
same parameters (carried over with ``convert.py``) and the same input:
the eval-mode forward, and the training loss with every gradient
(noise off), through the JAX ``Recoder._forward_loss`` full-decode
branch. Tolerance rtol 1e-5 with an absolute floor of 1e-5 times the
largest reference value: float32 on both sides with sums in different
orders, and gradient entries near zero (softmax minus target cancels)
carry an absolute error on the scale of the largest entries. Dropout
is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.models.base import dropout, pad_dim

NUM_ITEMS = 300
B = 12

MODELS = [([16], False), ([16, 8], False), ([16, 8], True)]


def _close(got, ref, rtol=1e-5):
  ref = np.asarray(ref)
  np.testing.assert_allclose(got, ref, rtol=rtol,
                             atol=1e-5 * max(np.abs(ref).max(), 1e-30))


def _pair(hidden, constrained, activation='tanh', **kw):
  jm = JaxDynAE(hidden_layers=hidden, activation_type=activation,
                is_constrained=constrained, **kw)
  jparams = jm.init_model(NUM_ITEMS, seed=5)
  pm = DynamicAutoencoder(hidden_layers=hidden, activation_type=activation,
                          is_constrained=constrained, **kw)
  pm.init_model(NUM_ITEMS)
  theirs = convert.params_from_numpy(
      {k: np.asarray(v) for k, v in jparams.items()})
  assert set(theirs) == set(pm.params())
  with torch.no_grad():
    for name, p in pm.params().items():
      assert tuple(p.shape) == tuple(theirs[name].shape), name
      p.copy_(theirs[name])
  return jm, jparams, pm


def _input(width, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.random((B, width)) < 0.08).astype(np.float32)
  x[-1] = 0.0  # an empty row: the l2 normalization's eps path
  return x


@pytest.mark.parametrize('hidden,constrained', MODELS)
def test_forward_eval_matches_jax(hidden, constrained):
  jm, jparams, pm = _pair(hidden, constrained)
  x = _input(NUM_ITEMS)  # logical width: both pad to the table
  ref = jm.apply(jparams, jnp.asarray(x), training=False)
  with torch.no_grad():
    got = pm(torch.from_numpy(x))
  assert got.shape == (B, pad_dim(NUM_ITEMS))
  _close(got.numpy(), ref)


def _jax_fd_batch(slab, n_valid):
  return {'in_slab': jnp.asarray(slab), 'in_users': jnp.arange(B),
          'in_items': None, 'in_valid_users': jnp.float32(n_valid),
          'in_valid_width': jnp.int32(0), 'fd': True,
          'fd_mask_from_slab': True}


@pytest.mark.parametrize('loss,loss_params', [
    ('mse', {'confidence': 3}), ('logistic', {}), ('logloss', {})])
@pytest.mark.parametrize('hidden,constrained', MODELS)
def test_loss_and_gradients_match_jax(hidden, constrained, loss,
                                      loss_params):
  """Full-decode training loss (noise off) and the gradient of every
  parameter; 'mse' and 'logistic' go through the fused decode-loss
  Function, 'logloss' through decode + log-softmax."""
  jm, jparams, pm = _pair(hidden, constrained, noise_prob=0.0)
  slab = _input(pad_dim(NUM_ITEMS), seed=1)
  slab[:, NUM_ITEMS:] = 0.0
  n_valid = B - 3
  slab[n_valid:] = 0.0

  jtr = JaxRecoder(jm, optimizer_type='adam', loss=loss,
                   loss_params=dict(loss_params))
  jtr._init_loss_module()
  batch = _jax_fd_batch(slab, n_valid)
  ref_loss, ref_grads = jax.value_and_grad(
      lambda p: jtr._forward_loss(p, batch, rng=None, training=True))(
          jparams)

  ptr = Recoder(pm, optimizer_type='adam', loss=loss,
                loss_params=dict(loss_params), device='cpu')
  ptr._init_loss_module()
  got = ptr._forward_loss({'slab': torch.from_numpy(slab),
                           'num_users': float(n_valid)}, training=True)
  got.backward()
  _close(got.item(), float(ref_loss))
  for name, p in pm.params().items():
    _close(p.grad.numpy(), ref_grads[name])


def test_dropout_scaling_and_injected_mask():
  x = torch.arange(1.0, 9.0).reshape(2, 4)
  keep = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 0]], dtype=torch.float32)
  out = dropout(x, 0.5, keep_mask=keep)
  np.testing.assert_array_equal(out.numpy(), (x * keep / 0.5).numpy())


@pytest.mark.parametrize('rate', [0.2, 0.5])
def test_dropout_draw_rate(rate):
  """Kept fraction within 5 sigma of 1 - rate over 200k draws; kept
  values scaled by 1 / (1 - rate); the generator makes it repeatable."""
  n = 200_000
  x = torch.ones(n)
  a = dropout(x, rate, torch.Generator().manual_seed(0))
  b = dropout(x, rate, torch.Generator().manual_seed(0))
  assert torch.equal(a, b)
  kept = (a != 0).float().mean().item()
  sigma = np.sqrt(rate * (1 - rate) / n)
  assert abs(kept - (1 - rate)) < 5 * sigma
  np.testing.assert_allclose(a[a != 0].numpy(), 1.0 / (1 - rate), rtol=1e-6)


def test_noise_applies_only_in_training():
  pm = DynamicAutoencoder([8], noise_prob=0.5)
  pm.init_model(50)
  x = torch.from_numpy(_input(50))
  with torch.no_grad():
    h_eval = pm.encode(x)
    h_train = pm.encode(x, training=True,
                        generator=torch.Generator().manual_seed(1))
  assert torch.equal(h_eval, pm.encode(x).detach())
  assert not torch.allclose(h_eval, h_train)


def test_unported_configurations_raise():
  """bf16 compute is ported (it constructs, names its dtype in the
  checkpoint's model params and computes in it), and so is bf16
  parameter storage: every parameter bf16, compute_dtype defaulted to
  it, the scores bf16; an unknown storage dtype raises."""
  model = DynamicAutoencoder([8], compute_dtype='bfloat16')
  assert model.compute_dtype == torch.bfloat16
  assert model.model_params()['compute_dtype'] == 'bfloat16'
  model.init_model(50)
  with torch.no_grad():
    assert model(torch.from_numpy(_input(50))).dtype == torch.bfloat16
  stored = DynamicAutoencoder([8, 4], params_dtype='bfloat16')
  assert stored.compute_dtype == torch.bfloat16
  stored.init_model(50)
  assert all(p.dtype == torch.bfloat16 for p in stored.parameters())
  # the same float32 draws as a float32 model's, rounded once
  for name, p in stored.params().items():
    assert torch.equal(p, model_f32_params(name).to(torch.bfloat16)), name
  with torch.no_grad():
    assert stored(torch.from_numpy(_input(50))).dtype == torch.bfloat16
  with pytest.raises(ValueError, match='params_dtype'):
    DynamicAutoencoder([8], params_dtype='int8')


def model_f32_params(name):
  model = DynamicAutoencoder([8, 4])
  model.init_model(50)
  return model.params()[name].detach()
