"""The port's static 'blocks' union batches and the steps that read them
against the JAX package, on the CPU.

The JAX trainer runs its 'blocks' union and sparse steps as one
``lax.scan`` over on-device batches of static shapes; the port captures
the same steps as CUDA graphs, which needs the same static shapes
(``DeviceDataSource.union_batch``). Here, on the same numpy-seeded CSRs
and block orders:

* each step's static batch against the JAX ``build_batch`` in 'blocks'
  mode, exactly, for four sources (plain, megas of two slices; R random
  negatives with the JAX ids passed in; a target matrix; a non-binary
  matrix): the union with its sentinel tail, ``width_valid``, the users,
  the valid-user count, and the rows, compressed columns and values of
  the slice's interactions. The two windows differ in length (the JAX
  window is the mega's nnz budget, the port's the largest slice nnz)
  and in where they start (the mega's first entry, the slice's), so the
  entries are compared where both hold the slice's; the port's other
  entries must hold row B (the row the densify drops) and value 0;
* 4 steps of the dense union step, the sparse union step
  (DynamicAutoencoder and MatrixFactorization), the tied sparse step
  against a target matrix and the full-catalog sparse step, through
  ``train(shuffle='blocks', fused_steps_per_call=4)``, against the JAX
  ``_get_fused_step_fn(steps=4)``, noise off: the losses within 1e-5
  relative (float32 sums in another order), the parameters and moments
  within 1e-4 relative with the absolute floors of
  ``tests/test_torch_target.py``;
* ``SparseRowAdam`` reading its step size from the device table against
  the host-scalar update it replaced, bitwise, across an lr milestone;
* the sentinel row and its moments unchanged after 5 sparse steps whose
  unions carry sentinel tails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
from recoder_tpu_torch.optim import SparseRowAdam

N_USERS, N_ITEMS, BATCH, R, SEED = 74, 120, 8, 5, 3  # 10 blocks of 8
LR, WD, STEPS = 1e-2, 1e-3, 4
RTOL, PARAM_RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6, 1e-5


def _matrix(values='binary', seed=0, density=0.1):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < density).astype(np.float32)
  dense[3] = 0.0  # a user without interactions
  dense[:, 7] = 0.0  # an item nobody touched
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  return sp.csr_matrix(dense)


def _order(n_blocks, seed=11):
  """A block order with the partial tail block last (both sources pin it
  there)."""
  return np.concatenate([np.random.default_rng(seed).permutation(
      n_blocks - 1), [n_blocks - 1]]).astype(np.int64)


def _jax_ids(theirs, neg_step):
  return np.asarray(jax.random.randint(
      jax.random.fold_in(theirs._d_negkey, neg_step), (R,), 0, N_ITEMS,
      jnp.int32)).astype(np.int64)


def _block_unions(m):
  """The union width of each block of BATCH users."""
  edges = np.minimum(np.arange(0, N_USERS + BATCH, BATCH), N_USERS)
  return [len(np.unique(m.indices[m.indptr[a]:m.indptr[b]]))
          for a, b in zip(edges[:-1], edges[1:])]


# -- the static batches ------------------------------------------------------

SOURCES = {
    'plain, megas of two slices': dict(mega=2 * BATCH),
    'random negatives': dict(negatives=R),
    'target matrix': dict(target=True),
    'ratings': dict(values='ratings'),
}


def _assert_side(ours, theirs, prefix=''):
  """One side's union and triplets, exactly (module docstring)."""
  items = ours[prefix + 'items'].numpy()
  np.testing.assert_array_equal(items, np.asarray(theirs[prefix + 'items']))
  wv = int(theirs[prefix + 'width_valid'])
  assert int(ours[prefix + 'width_valid']) == wv
  assert np.all(items[wv:] == N_ITEMS)  # the sentinel tail
  mine = ours[prefix + 'rows'].numpy() < BATCH
  jax_keep = np.asarray(theirs[prefix + 'rows']) < BATCH
  for k in ('rows', 'cols', 'vals'):
    np.testing.assert_array_equal(
        ours[prefix + k].numpy()[mine],
        np.asarray(theirs[prefix + k])[jax_keep], err_msg=prefix + k)
  assert not ours[prefix + 'vals'].numpy()[~mine].any()


@pytest.mark.parametrize('name', list(SOURCES))
def test_static_batches_match_jax_build_batch(name):
  cfg = SOURCES[name]
  m = _matrix(cfg.get('values', 'binary'))
  t = _matrix('ratings', seed=9, density=0.05) if cfg.get('target') else None
  mega, negatives = cfg.get('mega', BATCH), cfg.get('negatives', 0)
  ours = DeviceDataSource(m, BATCH, mega, N_ITEMS, shuffle='blocks',
                          seed=SEED, device='cpu', target_matrix=t,
                          num_random_negatives=negatives)
  widths = ours.static_widths()
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=mega,
                               num_items=N_ITEMS, union_width=widths['W'],
                               shuffle='blocks', seed=SEED, target_matrix=t,
                               num_random_negatives=negatives)
  if not negatives:  # the JAX block tables' width is the port's
    assert theirs.union_width == widths['W'] == ours.union_width()
  order = _order(ours.n_blocks)
  perm = torch.from_numpy(order)
  for step in range(ours.steps_per_epoch):
    neg_step = 50 + step
    rand = _jax_ids(theirs, neg_step) if negatives else None
    got = ours.union_batch(perm, torch.tensor(step), rand_ids=rand)
    want = theirs.build_batch(jnp.asarray(order, jnp.int32), jnp.int32(step),
                              negative_sampling=True,
                              neg_step=jnp.int32(neg_step))
    assert got['items'].shape == (widths['W'],)
    assert got['rows'].shape == (widths['M'],)
    _assert_side(got, want)
    if t is not None:
      assert got['tg_items'].shape == (widths['tg_W'],)
      _assert_side(got, want, 'tg_')
    np.testing.assert_array_equal(got['users'].numpy(),
                                  np.asarray(want['users']))
    assert float(got['num_users']) == float(want['num_users'])
    if negatives:
      assert np.isin(rand, got['items'].numpy()).all()


def test_static_widths_are_exact_maxima():
  """W is the largest block union aligned up to 128 (with R ids, the
  largest union plus R), M the largest slice nnz: a step's union and
  its interactions always fit, and the widest ones exactly."""
  m = _matrix(density=0.3)
  for negatives in (0, R):
    src = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='blocks',
                           device='cpu', num_random_negatives=negatives)
    widths = src.static_widths()
    assert widths['W'] == (max(_block_unions(m)) + negatives
                           + 127) // 128 * 128
    nnz = np.diff(m.indptr[np.minimum(np.arange(0, src.n_pad + 1, BATCH),
                                      N_USERS)])
    assert widths['M'] == nnz.max()


# -- 4 steps against the JAX scan ---------------------------------------------

def _models(family, sparse, constrained=False):
  if family == 'mf':
    kw = dict(embedding_size=12, activation_type='tanh', sparse=sparse)
    return JaxMF(**kw), MatrixFactorization(**kw)
  kw = dict(hidden_layers=[16], activation_type='tanh', noise_prob=0.0,
            is_constrained=constrained, sparse=sparse)
  return JaxDynAE(**kw), DynamicAutoencoder(**kw)


def _pair(family, sparse, loss, m, t=None, constrained=False):
  """A JAX trainer ready to step and a port trainer holding its
  parameters."""
  jm, pm = _models(family, sparse, constrained)
  jtr = JaxRecoder(jm, optimizer_type='adam', loss=loss, seed=SEED)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m, t), weight_decay=WD)
  ptr = Recoder(pm, optimizer_type='adam', loss=loss, seed=SEED,
                device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  convert.load_params(ptr.model, {k: np.asarray(v) for k, v in
                                  jtr.model.params.items()})
  return jtr, ptr


def _jax_scan(jtr, m, t, order, sparse, negative_sampling):
  """The JAX trainer's 4-step scan from step 0 of the order: losses, and
  the trainer's state advanced."""
  src = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                            num_items=N_ITEMS, union_width=128,
                            shuffle='blocks', seed=SEED, target_matrix=t)
  fn = jtr._get_fused_step_fn(src, negative_sampling, sparse, steps=STEPS)
  args = (jnp.zeros(6, jnp.int32), jnp.asarray(order, jnp.int32),
          jnp.float32(LR), src.device_arrays())
  if sparse:
    (jtr.model.params, jtr.opt_state, jtr.sparse_states, losses,
     _) = fn(jtr.model.params, jtr.opt_state, jtr.sparse_states, *args)
  else:
    dense, _ = jtr._split_params()
    params, jtr.opt_state, losses, _ = fn(dense, jtr.opt_state, *args)
    jtr.model.params = {**jtr.model.params, **params}
  return np.asarray(losses)


def _close(got, want, name, rtol=PARAM_RTOL, atol=ATOL):
  got = got.detach().float().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want, np.float32)
  if want.ndim == 2 and want.shape[1] > got.shape[1]:
    assert not np.any(want[:, got.shape[1]:]), f'{name}: pad not zero'
    want = want[:, :got.shape[1]]
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _assert_same_state(ptr, jtr):
  for name, p in ptr.model.params().items():
    _close(p, jtr.model.params[name], name, atol=PARAM_ATOL)
  assert set(ptr.sparse_states) == set(jtr.sparse_states or {})
  for path, st in ptr.sparse_states.items():
    assert int(st['step']) == int(jtr.sparse_states[path]['step']) == STEPS
    for k in ('m', 'v'):
      _close(st[k], jtr.sparse_states[path][k], f'{path}/{k}')
  dense, _ = ptr._split_params()
  for name, p in dense.items():
    state = ptr.optimizer.state[p]
    _close(state['exp_avg'], jtr.opt_state['m'][name], f'm/{name}')
    _close(state['exp_avg_sq'], jtr.opt_state['v'][name], f'v/{name}')


STEP_CASES = {
    # name: (family, sparse, loss, target, constrained, negative_sampling)
    'dense union': ('ae', False, 'mse', False, False, True),
    'dense union, logloss': ('ae', False, 'logloss', False, False, True),
    'sparse union': ('ae', True, 'logloss', False, False, True),
    'sparse union, MF': ('mf', True, 'mse', False, False, True),
    'tied sparse target': ('ae', True, 'mse', True, True, True),
    'full-catalog sparse': ('ae', True, 'logloss', False, False, False),
}


@pytest.mark.parametrize('name', list(STEP_CASES))
def test_four_steps_match_the_jax_scan(name, monkeypatch):
  family, sparse, loss, target, constrained, ns = STEP_CASES[name]
  m = _matrix(seed=1)
  t = _matrix('ratings', seed=2, density=0.05) if target else None
  jtr, ptr = _pair(family, sparse, loss, m, t, constrained)
  order = _order(-(-N_USERS // BATCH))
  monkeypatch.setattr(DeviceDataSource, 'epoch_permutation',
                      lambda self, epoch: torch.from_numpy(order))
  ptr.train(RecommendationDataset(m, t), batch_size=BATCH, lr=LR,
            weight_decay=WD, num_epochs=1, iters_per_epoch=STEPS,
            negative_sampling=ns, shuffle='blocks', full_decode=False,
            fused_steps_per_call=STEPS)
  source = ptr.fused_data_source
  assert (source.d_slab is not None) == (not ns)  # full catalog: the slab
  assert ptr._device_loop is not None and ptr._train_iterator is None
  want = _jax_scan(jtr, m, t, order, sparse, ns)
  np.testing.assert_allclose(ptr.last_epoch_losses, want, rtol=RTOL)
  _assert_same_state(ptr, jtr)


# -- SparseRowAdam's device scalars ---------------------------------------------

def _host_update(table, state, ids, g, lr, betas=(0.9, 0.999), eps=1e-8):
  """The row-sparse Adam step with its step size computed on the host (the
  update before the step size moved to a device table)."""
  b1, b2 = betas
  step = state['step'] + 1
  f32 = np.float32
  bc1 = f32(1.0) - f32(b1) ** f32(step)
  bc2 = f32(1.0) - f32(b2) ** f32(step)
  step_size = float(f32(lr) * np.sqrt(bc2) / bc1)
  new_m = b1 * state['m'][ids] + (1 - b1) * g
  new_v = b2 * state['v'][ids] + (1 - b2) * g * g
  new_p = table[ids] - step_size * new_m / (torch.sqrt(new_v) + eps)
  for dst, src in ((table, new_p), (state['m'], new_m), (state['v'], new_v)):
    dst.index_copy_(0, ids, src)
  state['step'] = step


@pytest.mark.parametrize('scheduled', [True, False])
def test_sparse_row_adam_device_scalars_are_the_host_scalars(scheduled):
  """Scheduled per epoch (as the trainer does: 3 steps at lr, then 4 at
  lr / 10 after a milestone) or scheduling each step itself (a direct
  caller), the device-scalar update is the host-scalar one bit for bit,
  on two tables whose step counts differ."""
  rng = np.random.default_rng(0)
  tables = [torch.from_numpy(rng.normal(size=(30, 6)).astype(np.float32))
            for _ in range(2)]
  opt = SparseRowAdam()
  states = [opt.init(t) for t in tables]
  ref_tables = [t.clone() for t in tables]
  ref_states = [{'step': 0, 'm': s['m'].clone(), 'v': s['v'].clone()}
                for s in states]
  # the second table starts two steps ahead
  for _ in range(2):
    ids = torch.from_numpy(np.sort(rng.choice(30, 9, replace=False)))
    g = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    opt.update_rows(tables[1], states[1], ids, g, LR)
    _host_update(ref_tables[1], ref_states[1], ids, g, LR)
  for lr, n in ((LR, 3), (LR / 10, 4)):
    if scheduled:
      opt.schedule(states, lr, n, capacity=8)
    for _ in range(n):
      for i in range(2):
        ids = torch.from_numpy(np.sort(rng.choice(30, 9, replace=False)))
        g = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
        opt.update_rows(tables[i], states[i], ids, g, lr)
        _host_update(ref_tables[i], ref_states[i], ids, g, lr)
  for i in range(2):
    assert torch.equal(tables[i], ref_tables[i])
    assert torch.equal(states[i]['m'], ref_states[i]['m'])
    assert torch.equal(states[i]['v'], ref_states[i]['v'])
    assert int(states[i]['step']) == ref_states[i]['step'] == 7 + 2 * i


@pytest.mark.parametrize('target', [False, True])
def test_sentinel_rows_stay_put_over_sparse_steps(target):
  """5 sparse 'blocks' steps over unions with sentinel tails (and, with a
  target matrix, a tied table over two such unions folded into one
  update): the sentinel item's rows and every pad row of each table stay
  bitwise as they were, their moments zero."""
  m = _matrix(seed=4)
  t = _matrix('ratings', seed=5, density=0.05) if target else None
  tr = Recoder(DynamicAutoencoder([16], noise_prob=0.5, sparse=True,
                                  is_constrained=target),
               optimizer_type='adam', loss='mse', seed=SEED, device='cpu')
  tr.num_items = N_ITEMS
  tr._init_model()
  before = {k: v.clone() for k, v in tr.model.params().items()}
  tr.train(RecommendationDataset(m, t), batch_size=BATCH, lr=LR,
           num_epochs=1, iters_per_epoch=5, negative_sampling=True,
           shuffle='blocks')
  widths = tr.fused_data_source.static_widths()
  assert max(_block_unions(m)) < widths['W']  # every union has a tail
  pad = slice(N_ITEMS, None)  # the sentinel row N_ITEMS and the pad rows
  for path, st in tr.sparse_states.items():
    assert int(st['step']) == 5
    table = tr.model.params()[path]
    assert torch.equal(table[pad], before[path][pad]), path
    assert not st['m'][pad].any() and not st['v'][pad].any()
    touched = torch.any(st['v'][:N_ITEMS] != 0, dim=1)
    assert touched.any()
    assert torch.equal(table[:N_ITEMS][~touched],
                       before[path][:N_ITEMS][~touched])
