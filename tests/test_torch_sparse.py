"""The port's sparse-table path against the JAX package's, on the CPU.

* ``SparseRowAdam.update_rows`` against JAX ``SparseRowAdam`` over 5
  steps (rtol 1e-6: the same float32 formula, one pow per step on each
  side) and against ``torch.optim.SparseAdam`` on an
  ``nn.Embedding(sparse=True)`` (rtol 1e-5 with an absolute floor of
  1e-6 on unit-scale tables, as ``tests/test_optim.py`` holds the JAX
  version: SparseAdam forms the moment update as ``m + (g - m)(1 - b1)``,
  another rounding; the moments with floors of 1e-7 and 1e-9, their
  scales times 1e-5).
* One and three ``_sparse_step_math`` steps against JAX's from converted
  JAX parameters, noise off, for 'logloss' and 'mse', tied and untied:
  the losses, the tables, their moments and the dense parameters (rtol
  1e-5; absolute floors of 1e-6 on the moments and 1e-5 on the
  parameters, the floor ``tests/test_torch_slice.py`` holds the dense
  path to: Adam divides by sqrt(v), so a gradient entry that float32
  sums in another order leave near zero moves its parameter by up to lr
  times its relative error). The JAX tables carry a zero feature pad to
  128 lanes, which must stay zero.
* The dense union step against JAX ``_dense_step_math`` on the same
  union batch (same tolerances).
* A users-mode training epoch of a sparse model from the JAX trainer's
  initial parameters: both draw the same epoch order, so the epoch loss
  and the final tables match (rtol 1e-4, the same absolute floor).
* Checkpoints both ways, sparse <-> sparse and sparse <-> dense.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.optim import SparseRowAdam as JaxSparseRowAdam
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.optim import SparseRowAdam

N_USERS, N_ITEMS, BATCH, HIDDEN = 40, 120, 16, [16]
LR, WD = 1e-2, 1e-3
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5


def _matrix(seed=0):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix(
      (rng.random((N_USERS, N_ITEMS)) < 0.1).astype(np.float32))


# -- row-sparse Adam ------------------------------------------------------

def _adam_case(seed=0, N=30, d=6, R=9, steps=5):
  rng = np.random.default_rng(seed)
  table = rng.normal(size=(N, d)).astype(np.float32)
  ids = [np.sort(rng.choice(N, R, replace=False)) for _ in range(steps)]
  grads = [rng.normal(size=(R, d)).astype(np.float32) for _ in range(steps)]
  return table, ids, grads


def test_sparse_row_adam_matches_jax():
  table, ids, grads = _adam_case()
  jopt = JaxSparseRowAdam()
  jt = jnp.asarray(table)
  js = jopt.init(jt)
  opt = SparseRowAdam()
  t = torch.from_numpy(table.copy())
  st = opt.init(t)
  for i, g in zip(ids, grads):
    jt, js = jopt.update_rows(jt, js, jnp.asarray(i, jnp.int32),
                              jnp.asarray(g), jnp.float32(LR))
    opt.update_rows(t, st, torch.from_numpy(i.astype(np.int64)),
                    torch.from_numpy(g), LR)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(st['m'].numpy(), np.asarray(js['m']),
                               rtol=1e-6)
    np.testing.assert_allclose(st['v'].numpy(), np.asarray(js['v']),
                               rtol=1e-6)
  assert st['step'] == int(js['step']) == len(ids)
  untouched = np.setdiff1d(np.arange(len(table)), np.concatenate(ids))
  np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_sparse_row_adam_matches_torch_sparse_adam():
  table, ids, grads = _adam_case(seed=1)
  emb = torch.nn.Embedding(*table.shape, sparse=True)
  with torch.no_grad():
    emb.weight.copy_(torch.from_numpy(table))
  ref = torch.optim.SparseAdam(emb.parameters(), lr=LR, betas=(0.9, 0.999),
                               eps=1e-8)
  opt = SparseRowAdam()
  t = torch.from_numpy(table.copy())
  st = opt.init(t)
  for i, g in zip(ids, grads):
    i = torch.from_numpy(i.astype(np.int64))
    g = torch.from_numpy(g)
    ref.zero_grad()
    emb.weight.grad = torch.sparse_coo_tensor(i[None], g, emb.weight.shape)
    ref.step()
    opt.update_rows(t, st, i, g, LR)
    np.testing.assert_allclose(t.numpy(), emb.weight.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
  state = ref.state[emb.weight]
  np.testing.assert_allclose(st['m'].numpy(), state['exp_avg'].numpy(),
                             rtol=1e-5, atol=1e-7)
  np.testing.assert_allclose(st['v'].numpy(), state['exp_avg_sq'].numpy(),
                             rtol=1e-5, atol=1e-9)


# -- training steps against JAX ---------------------------------------------

def _pair(loss, constrained, sparse, m):
  """A JAX trainer ready to step and a port trainer holding its
  parameters."""
  kw = dict(hidden_layers=HIDDEN, activation_type='tanh',
            is_constrained=constrained, noise_prob=0.0, sparse=sparse)
  jtr = JaxRecoder(JaxDynAE(**kw), optimizer_type='adam', loss=loss,
                   seed=3)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  ptr = Recoder(DynamicAutoencoder(**kw), optimizer_type='adam', loss=loss,
                seed=3, device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  _load_jax_params(ptr, jtr.model.params)
  ptr._init_training(RecommendationDataset(m), LR, WD)
  return jtr, ptr


def _load_jax_params(ptr, params):
  with torch.no_grad():
    for name, p in ptr.model.params().items():
      p.copy_(torch.from_numpy(convert.fit_table(name, tuple(p.shape),
                                                 np.asarray(params[name]))))


def _jax_batch(batch, width):
  """The port's union batch in the JAX trainer's staged form: the union
  padded with the sentinel item to a static width."""
  items = batch['items'].numpy()
  pad = np.full(width - len(items), N_ITEMS)
  return {'in_rows': jnp.asarray(batch['rows'].numpy(), jnp.int32),
          'in_cols': jnp.asarray(batch['cols'].numpy(), jnp.int32),
          'in_vals': jnp.asarray(batch['vals'].numpy()),
          'in_users': jnp.asarray(batch['users'].numpy(), jnp.int32),
          'in_items': jnp.asarray(np.concatenate([items, pad]), jnp.int32),
          'in_valid_users': jnp.float32(batch['num_users']),
          'in_valid_width': jnp.int32(len(items))}


def _close(got, want, name, atol=ATOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  if want.ndim == 2 and want.shape[1] > got.shape[1]:
    assert not np.any(want[:, got.shape[1]:]), f'{name}: pad not zero'
    want = want[:, :got.shape[1]]
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def _batches(m, steps):
  src = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users', seed=1,
                         device='cpu')
  perm = src.epoch_permutation(1)
  return [src.build_union_batch(perm, s % src.steps_per_epoch)
          for s in range(steps)]


@pytest.mark.parametrize('hidden,constrained', [([16], False),
                                                ([16, 8], False),
                                                ([16, 8], True)])
def test_union_forward_matches_jax(hidden, constrained):
  """``apply`` over a union's columns and ``apply_gathered`` on its
  pre-gathered rows, eval mode, against the JAX functions (rtol 1e-5,
  absolute floor 1e-5 of the largest score: float32 sums in another
  order)."""
  m = _matrix()
  kw = dict(hidden_layers=hidden, activation_type='tanh',
            is_constrained=constrained, sparse=True)
  jm = JaxDynAE(**kw)
  jparams = jm.init_model(N_ITEMS, seed=5)
  pm = DynamicAutoencoder(**kw)
  pm.init_model(N_ITEMS)
  with torch.no_grad():
    for name, p in pm.params().items():
      p.copy_(torch.from_numpy(convert.fit_table(
          name, tuple(p.shape), np.asarray(jparams[name]))))
  batch = _batches(m, 1)[0]
  items = batch['items']
  x = Recoder._densify_union(batch, BATCH, len(items))
  jitems = jnp.asarray(items.numpy(), jnp.int32)
  ref = np.asarray(jm.apply(jparams, jnp.asarray(x.numpy()),
                            input_items=jitems, target_items=jitems))
  jgathered = {name: jparams[path][jitems]
               for name, path, _ in jm.sparse_entries(
                   input_items=jitems, target_items=jitems)}
  ref_g = np.asarray(jm.apply_gathered(jparams, jgathered,
                                       jnp.asarray(x.numpy()),
                                       target_items=jitems))
  gathered = {name: pm.params()[path].index_select(0, ids)
              for name, path, ids in pm.sparse_entries(input_items=items,
                                                       target_items=items)}
  assert sorted(gathered) == sorted(jgathered)
  with torch.no_grad():
    got = pm.apply(x, items, items).numpy()
    got_g = pm.apply_gathered(gathered, x, target_items=items).numpy()
  for a, b in ((got, ref), (got_g, ref_g)):
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('constrained', [False, True])
@pytest.mark.parametrize('loss', ['logloss', 'mse'])
def test_sparse_steps_match_jax(loss, constrained, steps):
  m = _matrix()
  jtr, ptr = _pair(loss, constrained, True, m)
  params, opt_state, sparse_states = (jtr.model.params, jtr.opt_state,
                                      jtr.sparse_states)
  for batch in _batches(m, steps):
    params, opt_state, sparse_states, jloss = jtr._sparse_step_math(
        params, opt_state, sparse_states, _jax_batch(batch, 128),
        jnp.float32(LR), None)
    loss_value = ptr._sparse_step_math(batch)
    np.testing.assert_allclose(float(loss_value), float(jloss), rtol=RTOL)
  for name, p in ptr.model.params().items():
    _close(p, params[name], name, PARAM_ATOL)
  assert set(ptr.sparse_states) == set(sparse_states)
  for path, st in ptr.sparse_states.items():
    assert st['step'] == int(sparse_states[path]['step']) == steps
    for k in ('m', 'v'):
      _close(st[k], sparse_states[path][k], f'{path}/{k}')
  dense, _ = ptr._split_params()
  for name, p in dense.items():
    state = ptr.optimizer.state[p]
    _close(state['exp_avg'], opt_state['m'][name], f'm/{name}')
    _close(state['exp_avg_sq'], opt_state['v'][name], f'v/{name}')


@pytest.mark.parametrize('constrained', [False, True])
@pytest.mark.parametrize('loss', ['logloss', 'mse'])
def test_dense_union_step_matches_jax(loss, constrained):
  """``full_decode=False`` on a dense model: the union's rows gathered
  with index_select, every parameter stepped by Adam ('mse' through the
  fused decode-loss Function on the union's rows)."""
  m = _matrix(seed=2)
  jtr, ptr = _pair(loss, constrained, False, m)
  params, opt_state = jtr.model.params, jtr.opt_state
  for batch in _batches(m, 2):
    params, opt_state, jloss = jtr._dense_step_math(
        params, opt_state, _jax_batch(batch, 128), jnp.float32(LR), None)
    got = ptr._dense_step_math(batch)
    np.testing.assert_allclose(float(got), float(jloss), rtol=RTOL)
  for name, p in ptr.model.params().items():
    _close(p, params[name], name, PARAM_ATOL)


def test_a_step_reads_the_rows_the_last_step_wrote():
  """The kernel writes behind autograd's back; the next step's gather
  must see the new rows, and rows outside the union stay as they were."""
  m = _matrix()
  _, ptr = _pair('logloss', False, True, m)
  batch = _batches(m, 1)[0]
  before = {k: v.clone() for k, v in ptr.model.params().items()}
  ptr._sparse_step_math(batch)
  items = batch['items']
  out = np.setdiff1d(np.arange(before['en_embedding'].shape[0]),
                     items.numpy())
  for path in ('en_embedding', 'de_embedding'):
    table = ptr.model.params()[path]
    assert not torch.equal(table[items], before[path][items])
    assert torch.equal(table[out], before[path][out])
    assert not ptr.sparse_states[path]['m'][out].any()
  with torch.no_grad():
    gathered = {name: ptr.model.params()[path].index_select(0, ids)
                for name, path, ids in ptr.model.sparse_entries(
                    input_items=items, target_items=items)}
    want = ptr._forward_loss(batch, training=True, gathered=gathered)
    again = ptr._forward_loss(batch, training=True)
  got = ptr._sparse_step_math(batch)
  assert float(got) == float(want) == float(again)


def test_sparse_configurations_that_raise():
  m = RecommendationDataset(_matrix())
  with pytest.raises(ValueError, match='adam'):
    Recoder(DynamicAutoencoder(HIDDEN, sparse=True),
            optimizer_type='sgd', device='cpu').train(
                m, negative_sampling=True)
  # (the full-catalog sparse step is ported: it trains)
  tr = Recoder(DynamicAutoencoder(HIDDEN, sparse=True),
               optimizer_type='adam', device='cpu')
  tr.train(m, negative_sampling=False)
  assert np.all(np.isfinite(tr.last_epoch_losses))


# -- whole trainings --------------------------------------------------------

def _jax_epoch_loss(caplog):
  msgs = [r.getMessage() for r in caplog.records
          if r.name == 'recoder_tpu' and 'loss=' in r.getMessage()]
  return float(re.search(r'loss=([-0-9.]+)', msgs[-1]).group(1))


@pytest.mark.parametrize('loss', ['logloss', 'mse'])
def test_users_mode_training_matches_jax_trainer(loss, caplog):
  """One users-mode epoch, noise off, from the JAX trainer's initial
  parameters: the same epoch order on both sides (numpy, seed 3), so the
  same batches, epoch loss and final tables."""
  caplog.set_level(logging.INFO, logger='recoder_tpu')
  m = _matrix(seed=4)
  kw = dict(hidden_layers=HIDDEN, activation_type='tanh', noise_prob=0.0,
            sparse=True)
  jtr = JaxRecoder(JaxDynAE(**kw), optimizer_type='adam', loss=loss, seed=3)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  ptr = Recoder(DynamicAutoencoder(**kw), optimizer_type='adam', loss=loss,
                seed=3, device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  _load_jax_params(ptr, jtr.model.params)
  train_kw = dict(batch_size=BATCH, lr=LR, weight_decay=WD, num_epochs=1,
                  negative_sampling=True, shuffle='users')
  jtr.train(JaxDataset(m), **train_kw)
  assert jtr.fused_data_source.users_precompute
  ptr.train(RecommendationDataset(m), **train_kw)
  assert len(ptr.last_epoch_losses) == 3
  np.testing.assert_allclose(np.mean(ptr.last_epoch_losses),
                             _jax_epoch_loss(caplog), rtol=1e-4)
  for name, p in ptr.model.params().items():
    want = np.asarray(jtr.model.params[name])[:, :p.shape[1]] \
        if p.dim() == 2 else np.asarray(jtr.model.params[name])
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                               atol=PARAM_ATOL, err_msg=name)


def _topk(trainer, m, k=10):
  users, _ = RecommendationDataset(m)[np.arange(N_USERS)]
  return np.asarray(trainer.recommend(users, k))


def test_checkpoints_both_ways(tmp_path, caplog):
  m = _matrix(seed=5)
  kw = dict(hidden_layers=HIDDEN, activation_type='tanh', noise_prob=0.0)
  train_kw = dict(batch_size=BATCH, lr=LR, weight_decay=WD,
                  negative_sampling=True, shuffle='users')
  jtr = JaxRecoder(JaxDynAE(sparse=True, **kw), optimizer_type='adam',
                   loss='logloss', seed=3)
  jtr.train(JaxDataset(m), num_epochs=2, **train_kw)
  jax_top = _topk(jtr, m)
  jax_file = jtr.save_state(str(tmp_path / 'jax'))

  # JAX sparse -> port sparse: weights, both optimizers; then one more
  # epoch on both sides from there
  from_jax = Recoder(DynamicAutoencoder(sparse=True), device='cpu', seed=3)
  from_jax.init_from_model_file(jax_file)
  assert from_jax.current_epoch == 2
  np.testing.assert_array_equal(_topk(from_jax, m), jax_top)
  from_jax.train(RecommendationDataset(m), num_epochs=3, **train_kw)
  jtr.train(JaxDataset(m), num_epochs=3, **train_kw)
  for path, st in from_jax.sparse_states.items():
    assert st['step'] == int(jtr.sparse_states[path]['step']) == 12
  for name, p in from_jax.model.params().items():
    want = np.asarray(jtr.model.params[name])
    if p.dim() == 2:
      want = want[:, :p.shape[1]]
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                               atol=PARAM_ATOL, err_msg=name)

  # JAX sparse -> port dense: the weights serve the same top-k; the
  # moments restart (the other split), as in JAX
  dense = Recoder(DynamicAutoencoder(), device='cpu')
  dense.init_from_model_file(jtr.save_state(str(tmp_path / 'jax2')))
  np.testing.assert_array_equal(_topk(dense, m), _topk(jtr, m))
  caplog.set_level(logging.WARNING, logger='recoder_tpu_torch')
  dense.train(RecommendationDataset(m), num_epochs=4, **train_kw)
  assert any('optimizer state reset' in r.getMessage()
             for r in caplog.records)

  # port sparse -> JAX sparse (re-padded) and JAX dense
  port_file = from_jax.save_state(str(tmp_path / 'port'))
  to_jax = JaxRecoder(JaxDynAE(sparse=True), optimizer_type='adam')
  to_jax.init_from_model_file(port_file)
  to_jax._init_training(JaxDataset(m), weight_decay=WD)
  assert to_jax.model.params['en_embedding'].shape[1] == 128
  for path, st in from_jax.sparse_states.items():
    js = to_jax.sparse_states[path]
    assert int(js['step']) == st['step']
    np.testing.assert_array_equal(np.asarray(js['m'])[:, :HIDDEN[0]],
                                  st['m'].numpy())
    assert not np.asarray(js['v'])[:, HIDDEN[0]:].any()
  np.testing.assert_array_equal(_topk(to_jax, m), _topk(from_jax, m))
  to_jax_dense = JaxRecoder(JaxDynAE(), optimizer_type='adam')
  to_jax_dense.init_from_model_file(port_file)
  np.testing.assert_array_equal(_topk(to_jax_dense, m), _topk(from_jax, m))

  # port dense -> port sparse
  sparse_again = Recoder(DynamicAutoencoder(sparse=True), device='cpu')
  sparse_again.init_from_model_file(dense.save_state(str(tmp_path / 'pd')))
  np.testing.assert_array_equal(_topk(sparse_again, m), _topk(dense, m))


def test_fit_table_refuses_a_nonzero_pad():
  arr = np.zeros((4, 8), np.float32)
  arr[:, :5] = 1.0
  assert convert.fit_table('t', (4, 5), arr).shape == (4, 5)
  arr[2, 6] = 1e-3
  with pytest.raises(ValueError, match='pad'):
    convert.fit_table('t', (4, 5), arr)
  with pytest.raises(ValueError, match='shape'):
    convert.fit_table('t', (4, 9), arr)
