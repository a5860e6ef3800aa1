"""The port's optimizers (``torch.optim`` with two parameter groups,
biases exempt from weight decay) against the JAX package's
``Optimizer`` with ``make_weight_decay_tree``, over five steps of the
same gradients; and the optimizer-state bridge of ``convert.py``.
Tolerance atol 1e-6 (float32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recoder_tpu.optim import Optimizer, make_weight_decay_tree
from recoder_tpu_torch import convert
from recoder_tpu_torch.optim import make_optimizer, make_param_groups


def _params(seed=0):
  rng = np.random.default_rng(seed)
  return {'en_embedding': rng.normal(size=(12, 4)).astype(np.float32),
          'en_bias': rng.normal(size=(4,)).astype(np.float32),
          'encode_w_1': rng.normal(size=(4, 3)).astype(np.float32),
          'decode_bias_1': rng.normal(size=(4,)).astype(np.float32),
          'de_bias': rng.normal(size=(12,)).astype(np.float32)}


def _grads(params, step):
  rng = np.random.default_rng(100 + step)
  return {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in params.items()}


@pytest.mark.parametrize('kind', ['adam', 'sgd', 'adagrad', 'rmsprop'])
def test_steps_match_jax_optimizer(kind):
  init = _params()
  lr, wd, steps = 1e-2, 0.1, 5

  jopt = Optimizer(kind, weight_decay=make_weight_decay_tree(init, wd))
  jparams = {k: jnp.asarray(v) for k, v in init.items()}
  jstate = jopt.init(jparams)

  named = {k: torch.nn.Parameter(v) for k, v in
           convert.params_from_numpy(init).items()}
  popt = make_optimizer(kind, named, lr=lr, weight_decay=wd)

  for step in range(steps):
    grads = _grads(init, step)
    jparams, jstate = jopt.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
        jnp.float32(lr))
    for k, p in named.items():
      p.grad = torch.from_numpy(grads[k])
    popt.step()

  for k, p in named.items():
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                               atol=1e-6, err_msg=k)
  # the moments carry across the bridge in the JAX tree layout
  tree = convert.opt_state_to_numpy(popt, named, kind, sgd_step=steps)
  assert int(tree['step']) == int(jstate['step'])
  for jax_key in convert.STATE_KEYS[kind]:
    for k in named:
      np.testing.assert_allclose(tree[jax_key][k],
                                 np.asarray(jstate[jax_key][k]), atol=1e-6,
                                 err_msg=f'{jax_key}/{k}')


def test_biases_are_exempt_from_decay():
  named = {k: torch.nn.Parameter(torch.zeros(2)) for k in
           ('en_embedding', 'en_bias', 'decode_bias_1', 'encode_w_1')}
  groups = make_param_groups(named, 0.5)
  decayed = {id(p) for g in groups if g['weight_decay'] == 0.5
             for p in g['params']}
  assert decayed == {id(named['en_embedding']), id(named['encode_w_1'])}
  assert sum(len(g['params']) for g in groups) == len(named)


@pytest.mark.parametrize('kind', ['adam', 'rmsprop'])
def test_opt_state_round_trip(kind):
  """torch state -> JAX tree -> a fresh torch optimizer: the next step
  lands where the original optimizer's does."""
  init = _params(1)

  def fresh():
    named = {k: torch.nn.Parameter(v) for k, v in
             convert.params_from_numpy(init).items()}
    return named, make_optimizer(kind, named, lr=1e-2, weight_decay=0.1)

  a_named, a_opt = fresh()
  for step in range(3):
    for k, p in a_named.items():
      p.grad = torch.from_numpy(_grads(init, step)[k])
    a_opt.step()
  b_named, b_opt = fresh()
  with torch.no_grad():
    for k in b_named:
      b_named[k].copy_(a_named[k])
  convert.opt_state_into_torch(
      b_opt, b_named, convert.opt_state_to_numpy(a_opt, a_named, kind), kind)
  for named, opt in ((a_named, a_opt), (b_named, b_opt)):
    for k, p in named.items():
      p.grad = torch.from_numpy(_grads(init, 9)[k])
    opt.step()
  for k in a_named:
    torch.testing.assert_close(b_named[k], a_named[k], rtol=0, atol=0)
