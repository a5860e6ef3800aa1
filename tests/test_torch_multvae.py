"""Mult-VAE in the port against the JAX package's, on the CPU, from the
same numpy parameters (``convert.load_params``) and the same draws: the
JAX dropout and ``jax.random.normal`` are replaced by the test's mask and
eps, the port's ``forward`` is fed the same ``keep_mask`` and ``eps``
(tests never compare random draws).

* ``forward`` / ``apply_gathered`` against the JAX ``apply`` /
  ``apply_gathered``: evaluation (scores alone) and training (scores and
  the annealed KL), over the catalog and over a union, float32 and bf16;
  ``_beta`` along the schedule.
* ``_forward_loss`` with the aux term, and its gradients, against
  ``jax.grad`` of the JAX ``_forward_loss`` on a batch with pad users
  (nonzero biases, so that a pad row's KL is not zero by accident).
* Three steps, full softmax (``negative_sampling=False``), dense union
  and sparse, against the JAX step math at the same global steps.
* The trainer hands the model the global step on every route; the
  biases are exempt from weight decay; checkpoints both ways.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-5 of the
largest value (sums in another order); parameters after Adam steps an
absolute floor of 1e-5; bf16 scores within 2^-7 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import MultVAE as JaxMultVAE
from recoder_tpu.models import multvae as jax_multvae_module
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import MultVAE
from recoder_tpu_torch.optim import make_param_groups

N_USERS, N_ITEMS, BATCH, HIDDEN, LATENT = 40, 120, 16, 24, 8
LR, WD, RTOL, PARAM_ATOL = 1e-2, 1e-3, 1e-5, 1e-5
BF = 'bfloat16'
#: the draws both sides are fed: a keep mask over the widest input and eps
DRAWS = np.random.default_rng(11)
KEEP = DRAWS.random((BATCH, 256)) < 0.5
EPS = DRAWS.standard_normal((BATCH, LATENT)).astype(np.float32)


def _matrix(seed=0):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix(
      (rng.random((N_USERS, N_ITEMS)) < 0.1).astype(np.float32))


def _kw(**kw):
  return dict(dict(hidden_dim=HIDDEN, latent_dim=LATENT,
                   dropout_prob=0.5, anneal_cap=0.2, total_anneal_steps=10),
              **kw)


def _params(jm, seed=5):
  """The JAX init with random biases (a zero input row then has a
  nonzero KL)."""
  params = {k: np.asarray(v) for k, v in
            jm.init_model(N_ITEMS, seed=seed).items()}
  rng = np.random.default_rng(seed)
  for name in params:
    if 'bias' in name:
      params[name] = 0.3 * rng.standard_normal(params[name].shape) \
          .astype(np.float32)
  jm.params = {k: jnp.asarray(v) for k, v in params.items()}
  return params


def _models(**kw):
  jm = JaxMultVAE(**_kw(**kw))
  params = _params(jm)
  pm = MultVAE(**_kw(**kw))
  pm.init_model(N_ITEMS)
  convert.load_params(pm, params)
  return jm, pm


@pytest.fixture
def jax_draws(monkeypatch):
  """The JAX Mult-VAE draws the test's mask and eps."""
  monkeypatch.setattr(
      jax_multvae_module, 'dropout',
      lambda z, rate, rng: jnp.where(KEEP[:z.shape[0], :z.shape[1]],
                                     z / (1 - rate), 0.0))
  monkeypatch.setattr(jax.random, 'normal',
                      lambda key, shape, dtype: jnp.asarray(
                          EPS[:shape[0]], dtype))


def _port_draws(pm, monkeypatch, width):
  """The port model fed the same mask and eps through its trainer."""
  keep = torch.from_numpy(KEEP[:, :width])
  for name in ('forward', 'apply_gathered'):
    fn = getattr(MultVAE, name)

    def fed(*a, _fn=fn, **k):
      n = (a[1] if _fn is MultVAE.apply_gathered else a[0]).shape[0]
      return _fn(pm, *a, keep_mask=keep[:n], eps=torch.from_numpy(EPS[:n]),
                 **k)
    monkeypatch.setattr(pm, name, fed)


def _close(got, want, rtol=RTOL, floor=1e-5, err_msg=''):
  got = got.detach().float().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=floor * np.abs(want).max(),
                             err_msg=err_msg)


@pytest.mark.parametrize('cd', [None, BF])
@pytest.mark.parametrize('union', [False, True])
def test_forward_matches_jax(union, cd, jax_draws):
  jm, pm = _models(compute_dtype=cd)
  x = (np.random.default_rng(1).random((BATCH, 50)) < 0.2).astype(
      np.float32)
  x[0] = 0.0  # a user without interactions (a pad row)
  items = np.sort(np.random.default_rng(2).choice(N_ITEMS, 50, False))
  ids = dict(input_items=items, target_items=items) if union else {}
  floor = 1e-5 if cd is None else 2.0 ** -7
  for training in (False, True):
    for step in (0, 3, 40):
      want = jm.apply(jm.params, jnp.asarray(x), rng=jax.random.PRNGKey(0),
                      training=training, step=jnp.int32(step),
                      **{k: jnp.asarray(v, jnp.int32) for k, v in
                         ids.items()})
      with torch.no_grad():
        got = pm(torch.from_numpy(x), training=training,
                 step=torch.tensor(step),
                 keep_mask=torch.from_numpy(
                     KEEP[:, :x.shape[1] if union else 256]),
                 eps=torch.from_numpy(EPS),
                 **{k: torch.from_numpy(v) for k, v in ids.items()})
      if not training:
        assert not isinstance(got, tuple)
        _close(got, want, floor=floor, rtol=0 if cd else RTOL)
        break
      (scores, aux), (jscores, jaux) = got, want
      _close(scores, jscores, floor=floor, rtol=0 if cd else RTOL)
      if cd is None:
        _close(aux, jaux, err_msg=f'aux at step {step}')
      else:  # (the heads' products are rounded to bf16 on both sides)
        np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=2e-2,
                                   atol=1e-3)
      assert aux[0] > 0 or step == 0


def test_beta_matches_jax():
  jm, pm = _models(total_anneal_steps=100)
  for step in (0, 5, 10, 20, 500):
    assert float(pm._beta(torch.tensor(step))) == float(
        jm._beta(jnp.int32(step)))
  assert pm._beta(None) == pytest.approx(0.2)
  assert MultVAE(total_anneal_steps=0)._beta(torch.tensor(7)) == 0.2


def test_apply_gathered_matches_jax(jax_draws):
  jm, pm = _models(sparse=True)
  items = np.array([3, 7, 20, 41, 88, 120])
  x = (np.random.default_rng(3).random((BATCH, 6)) < 0.5).astype(np.float32)
  jitems = jnp.asarray(items, jnp.int32)
  jg = {name: jm.params[path][ids] for name, path, ids in
        jm.sparse_entries(input_items=jitems, target_items=jitems)}
  titems = torch.from_numpy(items)
  pg = {name: pm.params()[path].index_select(0, ids) for name, path, ids in
        pm.sparse_entries(input_items=titems, target_items=titems)}
  assert sorted(pg) == sorted(jg) == ['de_rows', 'en_rows']
  want = jm.apply_gathered(jm.params, jg, jnp.asarray(x),
                           target_items=jitems, rng=jax.random.PRNGKey(0),
                           training=True, step=jnp.int32(4))
  with torch.no_grad():
    got = pm.apply_gathered(pg, torch.from_numpy(x), target_items=titems,
                            training=True, step=torch.tensor(4),
                            keep_mask=torch.from_numpy(KEEP[:, :6]),
                            eps=torch.from_numpy(EPS))
  _close(got[0], want[0])
  _close(got[1], want[1])


# -- the trainer ---------------------------------------------------------------

def _pair(m, sparse=False, dropout_prob=0.5):
  kw = _kw(sparse=sparse, dropout_prob=dropout_prob)
  jtr = JaxRecoder(JaxMultVAE(**kw), optimizer_type='adam', loss='logloss',
                   seed=3)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  params = _params(jtr.model)
  ptr = Recoder(MultVAE(**kw), optimizer_type='adam', loss='logloss', seed=3,
                device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  convert.load_params(ptr.model, params)
  ptr._init_training(RecommendationDataset(m), LR, WD)
  return jtr, ptr


def _source(m):
  return DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users', seed=1,
                          device='cpu')


def _union_batches(m, steps):
  src = _source(m)
  perm = src.epoch_permutation(1)
  return [src.build_union_batch(perm, s % src.steps_per_epoch)
          for s in range(steps)]


def _jax_union_batch(batch, width=128):
  items = batch['items'].numpy()
  pad = np.full(width - len(items), N_ITEMS)
  return {'in_rows': jnp.asarray(batch['rows'].numpy(), jnp.int32),
          'in_cols': jnp.asarray(batch['cols'].numpy(), jnp.int32),
          'in_vals': jnp.asarray(batch['vals'].numpy()),
          'in_users': jnp.asarray(batch['users'].numpy(), jnp.int32),
          'in_items': jnp.asarray(np.concatenate([items, pad]), jnp.int32),
          'in_valid_users': jnp.float32(batch['num_users']),
          'in_valid_width': jnp.int32(len(items))}


def _fd_batches(m, ptr):
  """The epoch's full-softmax batches (the whole catalog is the loss's)."""
  src = _source(m)
  src.maybe_cache_slabs(ptr.model.num_items_padded, request=True)
  perm = src.epoch_permutation(1)
  out = []
  for s in range(src.steps_per_epoch):
    b = src.build_fd_batch(perm, s)
    out.append((b, {
        'in_slab': jnp.asarray(b['slab'].float().numpy()),
        'in_users': jnp.asarray(b['users'].numpy(), jnp.int32),
        'in_items': None, 'in_valid_users': jnp.float32(b['num_users']),
        'in_valid_width': jnp.int32(0)}))
  return out


@pytest.mark.parametrize('path', ['full_softmax', 'union'])
def test_forward_loss_and_gradients_match_jax(path, jax_draws, monkeypatch):
  """The logloss plus the annealed KL of the epoch's last batch (8 pad
  users, whose KL the row mask must drop), and its gradients."""
  m = _matrix(seed=1)
  jtr, ptr = _pair(m)
  if path == 'full_softmax':
    b, staged = _fd_batches(m, ptr)[-1]
    width, ns = ptr.model.num_items_padded, False
  else:
    b = _union_batches(m, 3)[-1]
    staged, width, ns = _jax_union_batch(b), len(b['items']), True
  assert b['num_users'] < BATCH
  _port_draws(ptr.model, monkeypatch, width)
  step = 7
  want, grads = jax.value_and_grad(
      lambda p: jtr._forward_loss(p, staged, jax.random.PRNGKey(0), True,
                                  step=jnp.int32(step)))(jtr.model.params)
  got = ptr._forward_loss(b, training=True, negative_sampling=ns,
                          step=torch.tensor(step))
  got.backward()
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
  for name, p in ptr.model.params().items():
    _close(p.grad, grads[name], floor=1e-6, err_msg=name)
  # the pad rows' KL is not zero: the row mask is what drops it
  dense = torch.zeros(BATCH, width)
  _, aux = ptr.model(dense, training=True, step=torch.tensor(step),
                     input_items=None if path == 'full_softmax'
                     else b['items'], target_items=None
                     if path == 'full_softmax' else b['items'])
  assert float(aux[int(b['num_users']):].sum().detach()) > 1e-4


@pytest.mark.parametrize('path', ['full_softmax', 'union', 'sparse'])
def test_three_steps_match_jax(path, jax_draws, monkeypatch):
  """Three steps at global steps 0, 1, 2 (beta 0, 0.1, 0.2): losses and
  parameters (and the sparse tables' moments) against the JAX step
  math."""
  m = _matrix(seed=2)
  jtr, ptr = _pair(m, sparse=path == 'sparse', dropout_prob=0.0)
  params, opt_state = jtr.model.params, jtr.opt_state
  sparse_states = jtr.sparse_states
  if path == 'full_softmax':
    batches = _fd_batches(m, ptr)
  else:
    batches = [(b, _jax_union_batch(b)) for b in _union_batches(m, 3)]
  _port_draws(ptr.model, monkeypatch, 256)
  rng = jax.random.PRNGKey(0)
  for step, (b, staged) in enumerate(batches):
    ptr._global_step = step
    if path == 'sparse':
      params, opt_state, sparse_states, jloss = jtr._sparse_step_math(
          params, opt_state, sparse_states, staged, jnp.float32(LR), rng,
          step=jnp.int32(step))
      got = ptr._sparse_step_math(b)
    else:
      params, opt_state, jloss = jtr._dense_step_math(
          params, opt_state, staged, jnp.float32(LR), rng,
          step=jnp.int32(step))
      got = ptr._dense_step_math(b, negative_sampling=path == 'union')
    np.testing.assert_allclose(float(got), float(jloss), rtol=RTOL)
  for name, p in ptr.model.params().items():
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                               rtol=1e-4, atol=PARAM_ATOL, err_msg=name)
  if path == 'sparse':
    for table, st in ptr.sparse_states.items():
      assert st['step'] == int(sparse_states[table]['step']) == 3
      for k in ('m', 'v'):
        np.testing.assert_allclose(st[k].numpy(),
                                   np.asarray(sparse_states[table][k]),
                                   rtol=1e-4, atol=1e-7,
                                   err_msg=f'{table}/{k}')


@pytest.mark.parametrize('route', [
    dict(negative_sampling=False),
    dict(negative_sampling=True, full_decode=False),
    dict(negative_sampling=True, sparse=True),
    dict(negative_sampling=True, target=True)])
def test_the_model_gets_the_global_step(route, monkeypatch):
  """Every route passes the global step (a tensor) to ``forward``: the
  full softmax (a device counter), the union and sparse steps and the
  host loader; a resumed trainer continues it."""
  seen = []
  beta = MultVAE._beta
  monkeypatch.setattr(MultVAE, '_beta', lambda self, step: seen.append(
      int(step)) or beta(self, step))
  m = _matrix(seed=3)
  route = dict(route)
  sparse = route.pop('sparse', False)
  target = route.pop('target', False)
  ds = RecommendationDataset(m, m if target else None)
  tr = Recoder(MultVAE(**_kw(sparse=sparse)), optimizer_type='adam',
               loss='logloss', device='cpu')
  tr.train(ds, batch_size=BATCH, num_epochs=2, **route)
  assert seen == list(range(6))


def test_bias_params_exempt_from_weight_decay():
  pm = MultVAE(**_kw())
  pm.init_model(N_ITEMS)
  decay, no_decay = make_param_groups(pm.params(), 0.01)
  names = {id(p): n for n, p in pm.params().items()}
  assert decay['weight_decay'] == 0.01 and no_decay['weight_decay'] == 0.0
  assert sorted(names[id(p)] for p in no_decay['params']) == sorted(
      ['en_bias', 'de_bias', 'mu_bias', 'logvar_bias', 'dec_bias'])
  assert sorted(names[id(p)] for p in decay['params']) == sorted(
      ['en_embedding', 'de_embedding', 'w_mu', 'w_logvar', 'w_dec'])


def test_checkpoints_both_ways(tmp_path):
  m = _matrix(seed=5)
  kw = dict(batch_size=BATCH, lr=LR, negative_sampling=True)
  ptr = Recoder(MultVAE(**_kw(compute_dtype=BF)), optimizer_type='adam',
                loss='logloss', device='cpu')
  ptr.train(RecommendationDataset(m), num_epochs=1, **kw)
  path = ptr.save_state(str(tmp_path / 'port'))
  jtr = JaxRecoder(JaxMultVAE(), optimizer_type='adam', loss='logloss')
  jtr.init_from_model_file(path)
  assert jtr.model.hidden_dim == HIDDEN and jtr.model.total_anneal_steps == 10
  assert jtr.model.compute_dtype == jnp.bfloat16
  assert jtr._global_step == ptr._global_step == 3
  users, _ = RecommendationDataset(m)[np.arange(N_USERS)]
  jusers, _ = JaxDataset(m)[np.arange(N_USERS)]
  np.testing.assert_allclose(jtr.predict(jusers), ptr.predict(users),
                             atol=2.0 ** -7 * np.abs(ptr.predict(users)).max())

  jtr.train(JaxDataset(m), num_epochs=2, **kw)
  jpath = jtr.save_state(str(tmp_path / 'jax'))
  for built, dtype in ((None, torch.bfloat16), ('float32', torch.float32)):
    back = Recoder(MultVAE(compute_dtype=built), device='cpu')
    back.init_from_model_file(jpath)
    assert back.model.compute_dtype == dtype
    assert back.model.latent_dim == LATENT
    assert back._global_step == jtr._global_step
  back = Recoder(MultVAE(compute_dtype=BF), device='cpu')
  back.init_from_model_file(jpath)
  np.testing.assert_allclose(back.predict(users), np.asarray(
      jtr.predict(jusers)), atol=2.0 ** -7 * np.abs(back.predict(users)).max())


def test_eval_is_deterministic_and_ignores_the_generator():
  _, pm = _models()
  x = torch.from_numpy((np.random.default_rng(4).random((4, N_ITEMS))
                        < 0.2).astype(np.float32))
  with torch.no_grad():
    a = pm(x)
    b = pm(x, generator=torch.Generator().manual_seed(9))
  assert not isinstance(a, tuple) and torch.equal(a, b)
  assert a.shape == (4, pm.num_items_padded)
