"""The port's 'users'-mode epoch tables and the steps that read them
against the JAX package, on the CPU.

Where its source precomputes (``users_precompute``), the JAX trainer
builds each epoch's tables on the device once the epoch's order is drawn
and scans its 'users' union, sparse and triplet-scatter steps over them.
The port builds the same tables and serves the steps through its static
'blocks' batches, which a CUDA graph can record. Here, on the same
numpy-seeded CSRs (74 users in batches of 8, 200 items, an empty user,
an item nobody touched) and the same epoch orders (both draw them with
numpy):

* each mega's union, its width and each entry's compressed column and
  value against the JAX ``epoch_state``, exactly, binary and ratings,
  megas of one and two slices, two epochs;
* each step's static batch against the JAX ``build_batch`` given the
  epoch state, exactly, where both windows hold the slice's entries (the
  JAX window is the mega's nnz budget, the port's the slice's); the
  port's other entries hold row B and value 0;
* each step's static batch against the port's exact
  ``build_union_batch`` cut to its valid parts, exactly;
* 4 steps of the dense union step, the sparse union step
  (DynamicAutoencoder, megas of one and two slices, and
  MatrixFactorization) and the triplet scatter, through
  ``train(shuffle='users', fused_steps_per_call=4)``, against the JAX
  ``_get_fused_step_fn(steps=4)`` fed the epoch state, noise off: losses
  within 1e-5 relative (float32 sums in another order), parameters and
  moments within 1e-4 relative;
* the gate against the JAX ``users_precompute`` (plain data, random
  negatives, a target matrix, the byte budget patched to either side of
  the tables' bytes), and the trainer's route on each side of it: no
  step inside the gate builds an exact batch;
* the width ladder, and the width signature a function of the epoch
  alone;
* a training resumed from a checkpoint inside epoch 1 or at its end,
  across an epoch boundary where the signature changes, bitwise the
  uninterrupted one with the noise on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataLoader as JaxLoader
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data import device_pipeline
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization

N_USERS, N_ITEMS, BATCH, SEED = 74, 200, 8, 3  # 10 steps an epoch
LR, WD, STEPS = 1e-2, 1e-3, 4
RTOL, PARAM_RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6, 1e-5
#: the JAX source's static widths: past every union and mega nnz here
JAX_WIDTH, JAX_BUDGET = 256, 4096
#: (seed, density) of CSRs whose signature changes from epoch 1 to 2 in
#: megas of two slices: the union width's ('union'), the windows' ('full
#: decode')
CHANGING = {False: (2, 0.06), True: (0, 0.07)}


def _matrix(values='binary', seed=0, density=0.06):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < density).astype(np.float32)
  dense[3] = 0.0  # a user without interactions
  dense[:, 7] = 0.0  # an item nobody touched
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  return sp.csr_matrix(dense)


def _sources(m, mega, negatives=0):
  ours = DeviceDataSource(m, BATCH, mega, N_ITEMS, shuffle='users',
                          seed=SEED, device='cpu',
                          num_random_negatives=negatives)
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=mega,
                               num_items=N_ITEMS, union_width=JAX_WIDTH,
                               mega_nnz_budget=JAX_BUDGET, shuffle='users',
                               seed=SEED, num_random_negatives=negatives)
  return ours, theirs


TABLE_CASES = [(values, mega) for values in ('binary', 'ratings')
               for mega in (BATCH, 2 * BATCH)]


# -- the epoch tables ----------------------------------------------------------

@pytest.mark.parametrize('values,mega', TABLE_CASES)
def test_epoch_tables_match_jax_epoch_state(values, mega):
  ours, theirs = _sources(_matrix(values), mega)
  assert ours.users_precompute and theirs.users_precompute
  for epoch in (1, 2):
    got, want = ours.epoch_state(epoch), theirs.epoch_state(epoch)
    np.testing.assert_array_equal(got['perm'].numpy(),
                                  np.asarray(want['perm']))
    widths = np.asarray(want['widths'])
    np.testing.assert_array_equal(got['widths'].numpy(), widths)
    unions, W = got['unions'].numpy(), got['signature'][1]
    assert unions.shape == (ours.n_blocks, W) and W % 128 == 0
    assert W >= widths.max()
    indptr = got['indptr'].numpy()
    for b, w in enumerate(widths):
      np.testing.assert_array_equal(unions[b, :w],
                                    np.asarray(want['unions'])[b, :w])
      assert np.all(unions[b, w:] == N_ITEMS)  # the sentinel tail
      a, e = indptr[b * mega], indptr[(b + 1) * mega]
      np.testing.assert_array_equal(got['cols'][a:e].numpy(),
                                    np.asarray(want['cmp'])[b, :e - a])
      if values == 'ratings':
        np.testing.assert_array_equal(got['vals'][a:e].numpy(),
                                      np.asarray(want['vals'])[b, :e - a])
      else:
        assert 'vals' not in got


@pytest.mark.parametrize('values,mega', TABLE_CASES)
def test_static_batches_match_jax_build_batch(values, mega):
  ours, theirs = _sources(_matrix(values), mega)
  state = theirs.epoch_state(1)
  perm = ours.epoch_state(1)['perm']
  for step in range(ours.steps_per_epoch):
    got = ours.union_batch(perm, torch.tensor(step))
    want = theirs.build_batch(state, jnp.int32(step), negative_sampling=True)
    wv = int(want['width_valid'])
    assert int(got['width_valid']) == wv
    np.testing.assert_array_equal(got['items'].numpy()[:wv],
                                  np.asarray(want['items'])[:wv])
    assert np.all(got['items'].numpy()[wv:] == N_ITEMS)
    mine = got['rows'].numpy() < BATCH
    jax_keep = np.asarray(want['rows']) < BATCH
    for k in ('rows', 'cols', 'vals'):
      np.testing.assert_array_equal(got[k].numpy()[mine],
                                    np.asarray(want[k])[jax_keep], err_msg=k)
    assert not got['vals'].numpy()[~mine].any()
    np.testing.assert_array_equal(got['users'].numpy(),
                                  np.asarray(want['users']))
    assert float(got['num_users']) == float(want['num_users'])


@pytest.mark.parametrize('values,mega', TABLE_CASES)
def test_static_batches_are_the_exact_batches(values, mega):
  """The static batch cut to its valid parts is the exact-width batch the
  port builds outside the gate, bit for bit, in two epochs."""
  ours, _ = _sources(_matrix(values), mega)
  for epoch in (1, 2):
    perm = ours.epoch_state(epoch)['perm']
    for step in range(ours.steps_per_epoch):
      got = ours.union_batch(perm, torch.tensor(step))
      want = ours.build_union_batch(perm, step)
      wv = int(got['width_valid'])
      assert torch.equal(got['items'][:wv], want['items'])
      keep = got['rows'] < BATCH
      for k in ('rows', 'cols', 'vals'):
        assert torch.equal(got[k][keep], want[k].to(got[k].dtype)), k
      assert torch.equal(got['users'], want['users'])
      assert float(got['num_users']) == want['num_users']


def test_triplet_scatter_tables_give_the_exact_batches():
  """The triplet scatter over the epoch tables gives the slab, the loss
  columns and the users of the scatter the port runs outside the gate,
  bit for bit (ratings, megas of two slices, two epochs)."""
  ours, _ = _sources(_matrix('ratings'), 2 * BATCH)
  ours.maybe_cache_slabs(256, request=False)  # (the scatter's width)
  for epoch in (1, 2):
    perm = ours.epoch_state(epoch, full_decode=True)['perm']
    for step in range(ours.steps_per_epoch):
      got = ours.fd_batch(perm, torch.tensor(step), epoch_tables=True)
      want = ours.build_fd_batch(perm, step)
      for k in ('slab', 'col_mask'):
        assert torch.equal(got[k], want[k]), k
      assert torch.equal(got['users'], want['users'])
      assert float(got['num_users']) == want['num_users']


# -- 4 steps against the JAX scan ----------------------------------------------

def _models(family, sparse):
  if family == 'mf':
    kw = dict(embedding_size=12, activation_type='tanh', sparse=sparse)
    return JaxMF(**kw), MatrixFactorization(**kw)
  kw = dict(hidden_layers=[16], activation_type='tanh', noise_prob=0.0,
            sparse=sparse)
  return JaxDynAE(**kw), DynamicAutoencoder(**kw)


def _pair(family, sparse, loss, m):
  """A JAX trainer ready to step and a port trainer holding its
  parameters."""
  jm, pm = _models(family, sparse)
  jtr = JaxRecoder(jm, optimizer_type='adam', loss=loss, seed=SEED)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  ptr = Recoder(pm, optimizer_type='adam', loss=loss, seed=SEED,
                device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  convert.load_params(ptr.model, {k: np.asarray(v) for k, v in
                                  jtr.model.params.items()})
  return jtr, ptr


def _jax_scan(jtr, m, mega, sparse, full_decode):
  """The JAX trainer's 4-step scan from step 0 of epoch 1's tables:
  losses, and the trainer's state advanced."""
  _, src = _sources(m, mega)
  state = src.epoch_state(1, full_decode=full_decode)
  fn = jtr._get_fused_step_fn(src, True, sparse, steps=STEPS,
                              full_decode=full_decode)
  args = (jnp.zeros(6, jnp.int32), state, jnp.float32(LR),
          src.device_arrays())
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
    # name: (family, sparse, loss, mega, full decode)
    'dense union': ('ae', False, 'mse', BATCH, False),
    'sparse union': ('ae', True, 'logloss', BATCH, False),
    'sparse union, megas of two slices': ('ae', True, 'mse', 2 * BATCH,
                                          False),
    'sparse union, MF': ('mf', True, 'mse', BATCH, False),
    'triplet scatter': ('ae', False, 'mse', BATCH, True),
}


@pytest.mark.parametrize('name', list(STEP_CASES))
def test_four_steps_match_the_jax_scan(name):
  family, sparse, loss, mega, fd = STEP_CASES[name]
  m = _matrix(seed=1)
  jtr, ptr = _pair(family, sparse, loss, m)
  ptr.train(RecommendationDataset(m), batch_size=BATCH, lr=LR,
            weight_decay=WD, num_epochs=1, iters_per_epoch=STEPS,
            negative_sampling=True, shuffle='users',
            num_sampling_users=mega, full_decode=fd,
            slab_cache=False, fused_steps_per_call=STEPS)
  source = ptr.fused_data_source
  assert source.users_precompute and source.d_slab is None
  assert source._epoch['key'] == (1, fd)
  assert ptr._device_loop is not None
  want = _jax_scan(jtr, m, mega, sparse, fd)
  np.testing.assert_allclose(ptr.last_epoch_losses, want, rtol=RTOL)
  _assert_same_state(ptr, jtr)


# -- the gate -------------------------------------------------------------------

def _jax_gate(m, mega, negatives=0):
  """The JAX trainer's source: the union width its loader estimates."""
  width = JaxLoader(JaxDataset(m), batch_size=BATCH, negative_sampling=True,
                    num_sampling_users=mega,
                    num_random_negatives=negatives)._estimate_widths()[0]
  return JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=mega,
                             num_items=N_ITEMS, union_width=width,
                             shuffle='users', seed=SEED,
                             num_random_negatives=negatives)


@pytest.mark.parametrize('values', ['binary', 'ratings'])
@pytest.mark.parametrize('budget', ['default', 'at the bytes',
                                    'a byte under', 'small'])
def test_gate_matches_jax(values, budget, monkeypatch):
  """Plain data: the gate of both packages, at the default budget and
  patched to the two epochs' bytes, a byte under them and far under."""
  m, mega = _matrix(values), 2 * BATCH
  theirs = _jax_gate(m, mega)
  nbytes = theirs.n_blocks * (2 * theirs.mega_nnz_budget
                              + theirs.union_width + 3) * 4
  if values == 'ratings':
    nbytes += theirs.n_blocks * theirs.mega_nnz_budget * 4
  patched = {'at the bytes': 2 * nbytes, 'a byte under': 2 * nbytes - 1,
             'small': 1024}.get(budget)
  if patched is not None:
    for cls in (DeviceDataSource, JaxDeviceDataSource):
      monkeypatch.setattr(cls, 'PRECOMPUTE_BYTE_BUDGET', patched)
    theirs = _jax_gate(m, mega)
  ours = DeviceDataSource(m, BATCH, mega, N_ITEMS, shuffle='users',
                          seed=SEED, device='cpu')
  assert ours.users_precompute == theirs.users_precompute
  assert ours.users_precompute == (budget in ('default', 'at the bytes'))
  assert (ours.precompute_reason is None) == ours.users_precompute
  assert ours._jax_epoch_table_bytes() == nbytes


def test_gate_declines_random_negatives_and_target_matrices():
  m = _matrix()
  ours, theirs = _sources(m, BATCH, negatives=5)
  assert not ours.users_precompute and not theirs.users_precompute
  assert ours.precompute_reason == 'random negatives'
  assert ours.epoch_state(1) is None and theirs.epoch_state(1) is None
  target = _matrix('ratings', seed=9, density=0.05)
  for cls, kw in ((DeviceDataSource, dict(device='cpu')),
                  (JaxDeviceDataSource, dict(union_width=JAX_WIDTH))):
    with pytest.raises(ValueError, match='target_matrix'):
      cls(m, batch_size=BATCH, num_sampling_users=BATCH, num_items=N_ITEMS,
          shuffle='users', target_matrix=target, **kw)


def _refuse(*args, **kwargs):
  raise AssertionError('an exact-width batch was built inside the gate')


@pytest.mark.parametrize('fd', [False, True])
def test_steps_inside_the_gate_build_no_exact_batch(fd, monkeypatch, caplog):
  """Inside the gate no step builds an exact batch ('auto': 16 steps a
  dispatch, the JAX ``table_step``); with random negatives the steps run
  one a dispatch at exact widths, and one log line says why."""
  m = _matrix()
  kw = dict(batch_size=BATCH, lr=LR, num_epochs=2, negative_sampling=True,
            shuffle='users', full_decode=fd, slab_cache=False)
  with monkeypatch.context() as patch:
    patch.setattr(DeviceDataSource, 'build_union_batch', _refuse)
    patch.setattr(DeviceDataSource, '_scatter_fd_batch', _refuse)
    tr = Recoder(DynamicAutoencoder([16]), optimizer_type='adam',
                 device='cpu')
    tr.train(RecommendationDataset(m), **kw)
  assert tr.last_epoch_dispatch == 'eager'  # (off the card)
  assert tr.fused_data_source._epoch['key'] == (2, fd)
  tr = Recoder(DynamicAutoencoder([16]), optimizer_type='adam', device='cpu')
  with caplog.at_level('INFO', logger='recoder_tpu_torch'):
    tr.train(RecommendationDataset(m), num_random_negatives=5, **kw)
  assert tr.fused_data_source._epoch is None
  assert tr.last_epoch_dispatches == tr.fused_data_source.steps_per_epoch
  assert any('run eagerly at their exact widths' in r.message
             and 'random negatives' in r.message for r in caplog.records)


# -- widths ---------------------------------------------------------------------

def test_width_ladder():
  """Rungs are multiples of 128, at most 4% (and 128) above a width, the
  same for every width between two rungs, and every multiple of 128 up
  to 3,200 is one."""
  rungs = sorted({device_pipeline._rung(w) for w in range(1, 200_000, 7)})
  for w in range(1, 200_000, 97):
    r = device_pipeline._rung(w)
    assert r % 128 == 0 and w <= r <= max(w * 26 // 25 + 128, 128)
    assert r == min(x for x in rungs if x >= w)
  assert [r for r in rungs if r <= 3200] == list(range(128, 3201, 128))


def test_signature_is_a_function_of_the_epoch():
  """A fresh source, one that placed other epochs first, and one that
  had them prefetched give each epoch the same signature and tables."""
  for fd in (False, True):
    m = _matrix(seed=CHANGING[fd][0], density=CHANGING[fd][1])
    first, _ = _sources(m, 2 * BATCH)
    sigs = {e: first.epoch_state(e, fd)['signature'] for e in (1, 2, 3)}
    assert sigs[1] != sigs[2]
    again, _ = _sources(m, 2 * BATCH)
    again.prefetch_epoch(3, fd)
    for e in (3, 1, 2):
      got = again.epoch_state(e, fd)
      assert got['signature'] == sigs[e]
      want = _sources(m, 2 * BATCH)[0].epoch_state(e, fd)
      for k, v in want.items():
        if torch.is_tensor(v):
          assert torch.equal(got[k], v), k
    assert len(again._signatures) == len(set(sigs.values()))


RESUME_CASES = {
    'dense union': (dict(), False),
    'sparse union': (dict(sparse=True), False),
    'triplet scatter': (dict(), True),
}


@pytest.mark.parametrize('at', [6, 'the end'])
@pytest.mark.parametrize('case', list(RESUME_CASES))
def test_resume_across_a_signature_change_is_bitwise(case, at, tmp_path):
  """Noise 0.5: a training checkpointed ``at`` 6 steps into epoch 1 or
  at its end and resumed through epoch 2, whose tables have another
  signature, ends bitwise where the uninterrupted training does: 2
  epochs, or (a resume starts at the checkpoint's epoch, inclusive, as
  in JAX) 1 epoch and then ``train(num_epochs=2)`` on the same
  trainer."""
  model_kw, fd = RESUME_CASES[case]
  seed, density = CHANGING[fd]
  data = RecommendationDataset(_matrix(seed=seed, density=density))
  kw = dict(batch_size=BATCH, lr=LR, weight_decay=WD,
            negative_sampling=True, shuffle='users', full_decode=fd,
            slab_cache=False, num_sampling_users=2 * BATCH)

  def trainer():
    return Recoder(DynamicAutoencoder([16], noise_prob=0.5, **model_kw),
                   optimizer_type='adam', loss='mse', seed=SEED,
                   device='cpu')

  whole = trainer()
  if at == 'the end':
    whole.train(data, num_epochs=1, **kw)
  whole.train(data, num_epochs=2, **kw)
  source = whole.fused_data_source
  assert (source.epoch_state(1, fd)['signature']
          != source.epoch_state(2, fd)['signature'])
  part = trainer()
  part.train(data, num_epochs=1, model_checkpoint_prefix=str(tmp_path / 'c'),
             **dict(kw, iters_per_epoch=None if at == 'the end' else at))
  resumed = Recoder(DynamicAutoencoder(sparse=model_kw.get('sparse', False)),
                    optimizer_type='adam', seed=SEED, device='cpu')
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  resumed.train(data, num_epochs=2, **kw)
  assert resumed.last_epoch_losses == whole.last_epoch_losses
  theirs = whole.model.params()
  for name, p in resumed.model.params().items():
    assert torch.equal(p, theirs[name]), name
  for path, st in resumed.sparse_states.items():
    for k, v in st.items():
      assert torch.equal(v, whole.sparse_states[path][k]), (path, k)
