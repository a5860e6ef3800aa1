"""The port's negative-sampling knobs against the JAX package's, on the CPU:
mega-batches (``num_sampling_users`` = 2x and 3x ``batch_size``), random
extra negatives (``num_random_negatives``) and the per-step triplet
scatter of full decode where no slab is resident.

On the same numpy-seeded CSRs (40 users x 60 items, batch 8, an empty
user, an item nobody touched; binary, ratings and explicitly stored
zeros) and the same epoch orders (the 'users' order is drawn as JAX
draws it; the 'blocks' order is handed to both), every check is exact
unless it says otherwise:

* union batches of every slice of every mega: the items equal the JAX
  ``build_batch``'s ``items[:width_valid]``, and the rows, compressed
  columns and values its slots inside the slice, with and without the
  JAX random ids injected (``rand_ids``);
* scatter full-decode batches: the densified input equals the JAX
  ``_densify`` of the JAX batch, and the loss mask the JAX
  ``_forward_loss``'s ``present`` mask (explicit zeros included);
* the slab route's mega mask (dense and packed tier) equals the scatter
  route's, and so do the rows;
* the host loader's batches with random negatives are bitwise the JAX
  loader's at 0 workers, target side included;
* the port's and the JAX trainer's per-step losses, float32, noise off,
  megas of 2x the batch, both shuffles, full decode and union path, with
  the JAX ids injected into the port's draws: rtol 1e-5 (the float32
  reduction order differs);
* the draws differ between global steps, and a resumed training draws
  the ids (and gives the losses) of the uninterrupted one;
* ``num_random_negatives`` without negative sampling raises the JAX
  ``ValueError``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recoder_tpu.progress as jax_progress
from recoder_tpu.data import RecommendationDataLoader as JaxLoader
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import (RecommendationDataLoader,
                                    RecommendationDataset)
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

N_USERS, N_ITEMS, BATCH, R, SEED = 40, 60, 8, 5, 3
W = 128  # the full-decode width: a multiple of 32 past the catalog
MEGAS = (16, 24)  # 2 and 3 slices a mega; 48 padded users either way


def _matrix(values='binary', seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < 0.15).astype(np.float32)
  dense[3] = 0.0  # a user with no interactions
  dense[:, 7] = 0.0  # an item nobody touched
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  m = sp.csr_matrix(dense)
  if values == 'zeros':
    m.data[::7] = 0.0  # explicitly stored zeros
  return m


def _sources(m, mega, shuffle, negatives=0):
  ours = DeviceDataSource(m, BATCH, mega, N_ITEMS, shuffle=shuffle,
                          seed=SEED, device='cpu',
                          num_random_negatives=negatives)
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=mega,
                               num_items=N_ITEMS, union_width=128,
                               shuffle=shuffle, seed=SEED,
                               num_random_negatives=negatives)
  return ours, theirs


def _jax_ids(theirs, neg_step):
  return np.asarray(jax.random.randint(
      jax.random.fold_in(theirs._d_negkey, neg_step), (R,), 0, N_ITEMS,
      jnp.int32)).astype(np.int64)


def _in_slice(theirs):
  """The JAX slots of the batch's own interactions (the others hold row
  B and drop out of its scatter)."""
  return np.asarray(theirs['rows']) < BATCH


@pytest.mark.parametrize('negatives', [0, R])
@pytest.mark.parametrize('values', ['binary', 'ratings'])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('mega', MEGAS)
def test_union_batches_of_every_slice_match_jax(mega, shuffle, values,
                                                negatives):
  m = _matrix(values)
  ours, theirs = _sources(m, mega, shuffle, negatives)
  assert ours.steps_per_epoch == theirs.steps_per_epoch == 5
  assert ours.slices_per_mega == theirs.slices_per_mega == mega // BATCH
  perm = ours.epoch_permutation(2)
  jperm = jnp.asarray(perm.numpy(), jnp.int32)
  for step in range(ours.steps_per_epoch):
    neg_step = 100 + step  # a global step other than the epoch's
    rand = _jax_ids(theirs, neg_step) if negatives else None
    got = ours.build_union_batch(perm, step, neg_step=neg_step,
                                 rand_ids=rand)
    want = theirs.build_batch(jperm, jnp.int32(step), negative_sampling=True,
                              neg_step=jnp.int32(neg_step))
    wv = int(want['width_valid'])
    np.testing.assert_array_equal(got['items'].numpy(),
                                  np.asarray(want['items'])[:wv])
    keep = _in_slice(want)
    for k in ('rows', 'cols', 'vals'):
      np.testing.assert_array_equal(got[k].numpy(),
                                    np.asarray(want[k])[keep], err_msg=k)
    np.testing.assert_array_equal(got['users'].numpy(),
                                  np.asarray(want['users']))
    assert got['num_users'] == float(want['num_users'])
    if negatives:
      assert np.isin(rand, got['items'].numpy()).all()


def _jax_present(batch, width):
  """The JAX ``_forward_loss`` full-decode mask of a scatter batch."""
  present = jnp.zeros((width,), bool).at[batch['cols']].set(True,
                                                             mode='drop')
  if 'fd_rand_ids' in batch:
    present = present.at[batch['fd_rand_ids']].set(True, mode='drop')
  return np.asarray(jnp.logical_and(present, jnp.arange(width) < N_ITEMS))


@pytest.mark.parametrize('negatives', [0, R])
@pytest.mark.parametrize('values', ['binary', 'zeros'])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('mega', MEGAS)
def test_scatter_batches_match_jax(mega, shuffle, values, negatives):
  m = _matrix(values, seed=1)
  ours, theirs = _sources(m, mega, shuffle, negatives)
  assert not ours.maybe_cache_slabs(W, request=False)
  if values == 'zeros':  # the JAX decline, and its reason
    assert not ours.maybe_cache_slabs(W, request=True)
    assert not theirs.maybe_cache_slabs(W, request=True)
    assert ours.decline_reason == 'matrix stores explicit zero values'
  perm = ours.epoch_permutation(1)
  jperm = jnp.asarray(perm.numpy(), jnp.int32)
  jtr = JaxRecoder(JaxDynAE([4]))
  for step in range(ours.steps_per_epoch):
    want = theirs.build_batch(jperm, jnp.int32(step), negative_sampling=True,
                              neg_step=jnp.int32(7 + step),
                              full_decode=True)
    rand = (np.asarray(want['fd_rand_ids']).astype(np.int64) if negatives
            else None)
    got = ours.build_fd_batch(perm, step, rand_ids=rand)
    dense = jtr._densify(want['rows'], want['cols'], want['vals'], BATCH, W)
    np.testing.assert_array_equal(got['slab'].float().numpy(),
                                  np.asarray(dense))
    np.testing.assert_array_equal(got['col_mask'].numpy(),
                                  _jax_present(want, W).astype(np.float32))
    np.testing.assert_array_equal(got['users'].numpy(),
                                  np.asarray(want['users']))
    assert got['num_users'] == float(want['num_users'])


@pytest.mark.parametrize('tier', [True, 'packed'])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('mega', MEGAS)
def test_slab_mega_mask_equals_the_scatter_mask(mega, shuffle, tier):
  m = _matrix(seed=2)
  slab, _ = _sources(m, mega, shuffle, R)
  scatter, _ = _sources(m, mega, shuffle, R)
  assert slab.maybe_cache_slabs(W, request=tier)
  assert slab._slab_packed == (tier == 'packed')
  assert not scatter.maybe_cache_slabs(W, request=False)
  perm = slab.epoch_permutation(3)
  rng = np.random.default_rng(0)
  for step in range(slab.steps_per_epoch):
    rand = rng.integers(0, N_ITEMS, R)
    a = slab.build_fd_batch(perm, step, rand_ids=rand)
    b = scatter.build_fd_batch(perm, step, rand_ids=rand)
    assert a['col_mask'][rand].all()
    for k in ('col_mask', 'users'):
      assert torch.equal(a[k], b[k]), k
    assert torch.equal(a['slab'].float(), b['slab'].float())
    assert a['num_users'] == b['num_users']


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('target', [False, True])
def test_loader_random_negatives_match_jax(target, workers):
  """At 0 workers bitwise the JAX loader's batches over two epochs; with
  2 workers the order of the draws follows the scheduling (as in JAX),
  so only the batches' own columns are compared."""
  rng = np.random.default_rng(4)
  m = sp.csr_matrix((rng.random((N_USERS, N_ITEMS)) < 0.12)
                    .astype(np.float32) * rng.integers(1, 5, (N_USERS,
                                                              N_ITEMS)))
  tg = (sp.csr_matrix((rng.random((N_USERS, N_ITEMS)) < 0.05)
                      .astype(np.float32)) if target else None)
  kw = dict(batch_size=BATCH, negative_sampling=True, num_sampling_users=16,
            num_workers=workers, seed=SEED, num_random_negatives=R)
  ours = RecommendationDataLoader(RecommendationDataset(m, tg), **kw)
  theirs = JaxLoader(JaxDataset(m, tg), **kw)
  assert len(ours) == len(theirs) == 5
  for _ in range(2):
    for (a, a_tg), (b, b_tg) in zip(ours, theirs, strict=True):
      for x, y in ((a, b), (a_tg, b_tg)):
        if y is None:
          assert x is None
          continue
        nnz = y.nnz
        np.testing.assert_array_equal(x.users, y.users[:y.num_users])
        np.testing.assert_array_equal(x.rows, y.rows[:nnz])
        np.testing.assert_array_equal(x.vals, y.vals[:nnz])
        items = y.items[:y.num_items_in_batch]
        if workers == 0:
          np.testing.assert_array_equal(x.items, items)
          np.testing.assert_array_equal(x.cols, y.cols[:nnz])
        np.testing.assert_array_equal(x.items[x.cols], items[y.cols[:nnz]])


# -- trainers ---------------------------------------------------------------

class _LossRecorder:
  """Stands in for the JAX ProgressReporter: keeps every block's losses."""

  last = None

  def __init__(self, total, desc):
    self.losses = []
    _LossRecorder.last = self

  def put(self, num_steps, loss):
    self.losses.append(np.atleast_1d(np.asarray(loss, np.float32)))

  def reset(self, total, desc):
    pass

  def close(self, wait=False):
    pass


def _inject(monkeypatch, m, mega, shuffle):
  """The port's epoch order := the JAX trainer's draw (with random
  negatives the JAX source builds no epoch tables, and its 'users' order
  too comes from ``jax.random``), and the port's random ids := the JAX
  ids of each global step (every draw on the CPU follows a
  seed_negatives for its global step). Returns the ids the port drew, by
  global step."""
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=mega,
                               num_items=N_ITEMS, union_width=128,
                               shuffle=shuffle, seed=SEED,
                               num_random_negatives=R)
  assert not theirs.users_precompute
  drawn = {}

  def perm(self, epoch):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), epoch)
    return torch.from_numpy(
        np.asarray(theirs.epoch_permutation(key)).astype(np.int64))

  def seed(self, global_step):
    self._step = int(global_step)

  def draw(self, generator):
    drawn[self._step] = _jax_ids(theirs, self._step)
    return torch.from_numpy(drawn[self._step])

  monkeypatch.setattr(DeviceDataSource, 'epoch_permutation', perm)
  monkeypatch.setattr(DeviceDataSource, 'seed_negatives', seed)
  monkeypatch.setattr(DeviceDataSource, '_draw_negatives', draw)
  return drawn


def _train_kw(shuffle, route, mega, num_epochs=2, **kw):
  return dict(batch_size=BATCH, lr=1e-2, weight_decay=2e-5,
              num_epochs=num_epochs, negative_sampling=True,
              num_sampling_users=mega, num_random_negatives=R,
              shuffle=shuffle, full_decode=route == 'full decode',
              slab_cache=True, **kw)


def _kw():
  return dict(hidden_layers=[16], activation_type='tanh', noise_prob=0.0)


def _common():
  return dict(optimizer_type='adam', loss='mse',
              loss_params={'confidence': 3}, seed=SEED)


@pytest.mark.parametrize('route', ['full decode', 'union'])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_trainer_matches_jax_trainer(shuffle, route, monkeypatch):
  """Two epochs of 5 steps, megas of 16 (2 slices) with 5 random ids a
  step: the per-step losses. On full decode the JAX source declines its
  slab for the mega and scatters; the port keeps the slab."""
  m = _matrix('ratings', seed=5)
  mega = 2 * BATCH
  drawn = _inject(monkeypatch, m, mega, shuffle)
  monkeypatch.setattr(jax_progress, 'ProgressReporter', _LossRecorder)
  jtr = JaxRecoder(JaxDynAE(**_kw()), **_common())
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  jtr_init = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  jtr.train(JaxDataset(m), progress=True, **_train_kw(shuffle, route, mega))
  ref = np.concatenate(_LossRecorder.last.losses)
  assert ref.shape == (10,)
  losses = []
  for epochs in (1, 2):  # the port's epoch 1, then a two-epoch run's 2
    ptr = Recoder(DynamicAutoencoder(**_kw()), device='cpu', **_common())
    ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
    ptr._init_model()
    with torch.no_grad():
      for name, t in convert.params_from_numpy(
          {k: np.asarray(v) for k, v in jtr_init.items()}).items():
        ptr.model.params()[name].copy_(t)
    ptr.train(RecommendationDataset(m), **_train_kw(shuffle, route, mega,
                                                    num_epochs=epochs))
    losses += ptr.last_epoch_losses
  source = ptr.fused_data_source
  assert source.slices_per_mega == 2
  assert (source.d_slab is not None) == (route == 'full decode')
  assert sorted(drawn) == list(range(10))  # (epoch 1 drawn twice)
  np.testing.assert_allclose(losses, ref, rtol=1e-5)


def test_draws_follow_the_global_step():
  src = DeviceDataSource(_matrix(), BATCH, 16, N_ITEMS, device='cpu',
                         num_random_negatives=R)
  draws = [src._negatives(None, step) for step in (0, 1, 2, 0)]
  assert not torch.equal(draws[0], draws[1])
  assert not torch.equal(draws[1], draws[2])
  assert torch.equal(draws[0], draws[3])
  assert all(((d >= 0) & (d < N_ITEMS)).all() for d in draws)
  sparse = sp.csr_matrix(_matrix().toarray() * (np.arange(N_ITEMS) < 20))
  src = DeviceDataSource(sparse, BATCH, 16, N_ITEMS, device='cpu',
                         num_random_negatives=R)
  perm = src.epoch_permutation(1)
  a = src.build_union_batch(perm, 1, neg_step=1)
  b = src.build_union_batch(perm, 1, neg_step=6)
  assert not torch.equal(a['items'], b['items'])  # (past item 19: drawn)


def _recording(monkeypatch):
  drawn = []
  real = DeviceDataSource._draw_negatives

  def draw(self, generator):
    ids = real(self, generator)
    drawn.append(ids.clone())
    return ids

  monkeypatch.setattr(DeviceDataSource, '_draw_negatives', draw)
  return drawn


@pytest.mark.parametrize('route', ['full decode', 'union'])
def test_resume_draws_what_the_uninterrupted_run_drew(route, monkeypatch,
                                                      tmp_path):
  m = _matrix(seed=6)
  drawn = _recording(monkeypatch)
  kw = dict(_train_kw('users', route, 16), lr_milestones=None)

  def trainer():
    return Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=0.5),
                   device='cpu', **_common())

  whole = trainer()
  whole.train(RecommendationDataset(m), **kw)
  uninterrupted = list(drawn)
  assert len(uninterrupted) == 10
  drawn.clear()
  trainer().train(RecommendationDataset(m), **dict(
      kw, num_epochs=1, iters_per_epoch=3,
      model_checkpoint_prefix=str(tmp_path / 'c')))
  resumed = Recoder(DynamicAutoencoder(), device='cpu', **_common())
  resumed.init_from_model_file(os.path.join(tmp_path, 'c_epoch_1.model'))
  resumed.train(RecommendationDataset(m), **kw)
  assert len(drawn) == 10  # 3, then the 7 after the checkpoint
  for a, b in zip(drawn, uninterrupted, strict=True):
    assert torch.equal(a, b)
  assert resumed.last_epoch_losses == whole.last_epoch_losses


def test_random_negatives_require_negative_sampling():
  m = _matrix()
  with pytest.raises(ValueError, match='requires negative_sampling'):
    Recoder(DynamicAutoencoder([4]), optimizer_type='adam',
            device='cpu').train(RecommendationDataset(m), batch_size=BATCH,
                                num_random_negatives=R)
  with pytest.raises(ValueError, match='requires negative_sampling'):
    JaxRecoder(JaxDynAE([4]), optimizer_type='adam').train(
        JaxDataset(m), batch_size=BATCH, num_random_negatives=R)
