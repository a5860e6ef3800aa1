"""The port's host loader against the JAX package's, and the trainer's
staging of its batches.

``recoder_tpu_torch.data.loader`` is a numpy port of
``recoder_tpu/data/loader.py`` that does not pad: the same dataset,
arguments and seed must yield, in the same order over two epochs, the
valid part of each JAX ``Batch`` (users, union ids, rows, columns,
values), with and without negative sampling, with mega-batches of twice
the batch, a target matrix and two collation workers; and ``len`` must
agree.

The trainer's ``_device_batch_iter`` (on the CPU here) must yield each
batch's arrays (int64 indices, float32 values), release its producer
thread when the
consumer abandons it (the twin of the JAX
``test_abandoned_device_iter_releases_producer_thread``) and raise a
producer's exception in the consumer.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataLoader as JaxLoader
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu_torch.data import (RecommendationDataLoader,
                                    RecommendationDataset)
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

N_USERS, N_ITEMS, BATCH = 45, 70, 8


def _matrices(seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < 0.12).astype(np.float32)
  dense *= rng.integers(1, 5, size=dense.shape)
  dense[4] = 0.0  # a user with no interactions
  target = (rng.random((N_USERS, N_ITEMS)) < 0.05).astype(np.float32)
  return sp.csr_matrix(dense), sp.csr_matrix(target)


def _assert_same(ours, theirs):
  """``ours`` holds the valid part of each of ``theirs``' arrays."""
  if theirs is None:
    assert ours is None
    return
  valid = {'users': theirs.num_users, 'items': theirs.num_items_in_batch,
           'rows': theirs.nnz, 'cols': theirs.nnz, 'vals': theirs.nnz}
  for f, n in valid.items():
    a, b = getattr(ours, f), getattr(theirs, f)
    if b is None:
      assert a is None, f
      continue
    assert a.dtype == (np.float32 if f == 'vals' else np.int64), f
    np.testing.assert_array_equal(a, b[:n], err_msg=f)


CASES = {
    'full-catalog': dict(negative_sampling=False),
    'union': dict(negative_sampling=True),
    'mega-2x': dict(negative_sampling=True, num_sampling_users=2 * BATCH),
    'target': dict(negative_sampling=True, target=True),
    'target-full-catalog': dict(negative_sampling=False, target=True),
    'workers-2': dict(negative_sampling=True, num_workers=2, target=True,
                      num_sampling_users=2 * BATCH),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_batches_match_jax(case):
  kw = dict(CASES[case])
  m, t = _matrices()
  target = t if kw.pop('target', False) else None
  ours = RecommendationDataLoader(RecommendationDataset(m, target),
                                  batch_size=BATCH, seed=3, **kw)
  theirs = JaxLoader(JaxDataset(m, target), batch_size=BATCH, seed=3, **kw)
  assert len(ours) == len(theirs)
  for _ in range(2):  # two epochs: the shuffles follow one generator
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours)
    for (a_in, a_tg), (b_in, b_tg) in zip(got, want):
      _assert_same(a_in, b_in)
      _assert_same(a_tg, b_tg)


@pytest.mark.parametrize('target', [False, True], ids=['input', 'target'])
@pytest.mark.parametrize('num_workers', [0, 2])
def test_collate_fn_yields_the_jax_megas(num_workers, target):
  """``collate_fn=lambda x: x`` (the JAX evaluator's) yields each mega-batch
  once, as the JAX loader does: the same users in the same order, the
  same interactions, over two epochs."""
  m, t = _matrices(2)
  kw = dict(batch_size=BATCH, num_sampling_users=2 * BATCH, seed=4,
            num_workers=num_workers, collate_fn=lambda x: x)
  t = t if target else None
  ours = RecommendationDataLoader(RecommendationDataset(m, t), **kw)
  theirs = JaxLoader(JaxDataset(m, t), **kw)
  for _ in range(2):
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == -(-N_USERS // (2 * BATCH))
    for (a_in, a_tg), (b_in, b_tg) in zip(got, want):
      for a, b in ((a_in, b_in), (a_tg, b_tg)):
        if b is None:
          assert a is None
          continue
        np.testing.assert_array_equal(a.users, b.users)
        assert (a.interactions_matrix != b.interactions_matrix).nnz == 0
        assert a.interactions_matrix.shape == b.interactions_matrix.shape


@pytest.mark.parametrize('users,mega', [(45, 8), (48, 16), (50, 24), (7, 8)])
def test_len_matches_jax(users, mega):
  m = sp.csr_matrix(np.ones((users, 5), np.float32))
  kw = dict(batch_size=BATCH, num_sampling_users=mega)
  ours = RecommendationDataLoader(RecommendationDataset(m), **kw)
  assert len(ours) == len(JaxLoader(JaxDataset(m), **kw))
  assert len(ours) == sum(1 for _ in ours)


def _trainer():
  tr = Recoder(DynamicAutoencoder([4]), optimizer_type='adam', loss='mse',
               device='cpu')
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  return tr


@pytest.mark.parametrize('case', ['union', 'target', 'target-full-catalog'])
def test_staged_batches_hold_the_loaders_arrays(case):
  kw = dict(CASES[case])
  m, t = _matrices(1)
  dataset = RecommendationDataset(m, t if kw.pop('target', False) else None)
  loader = RecommendationDataLoader(dataset, batch_size=BATCH, seed=2, **kw)
  want = list(RecommendationDataLoader(dataset, batch_size=BATCH, seed=2,
                                       **kw))
  got = list(_trainer()._device_batch_iter(loader))
  assert len(got) == len(want)
  for batch, (b_in, b_tg) in zip(got, want):
    for side, b in (('', b_in), ('tg_', b_tg)):
      if b is None:
        assert side + 'rows' not in batch
        continue
      for f in ('rows', 'cols', 'vals', 'items'):
        if getattr(b, f) is None:
          assert batch[side + f] is None
        else:
          np.testing.assert_array_equal(batch[side + f].numpy(),
                                        getattr(b, f))
      assert batch[side + 'rows'].dtype == torch.int64
      assert batch[side + 'vals'].dtype == torch.float32
    np.testing.assert_array_equal(batch['users'].numpy(), b_in.users)
    assert batch['num_users'] == len(b_in.users)


def _wait_for(count, timeout=5.0):
  deadline = time.time() + timeout
  while threading.active_count() > count and time.time() < deadline:
    time.sleep(0.05)
  return threading.active_count()


@pytest.mark.parametrize('workers', [0, 2])
def test_abandoned_device_iter_releases_producer_thread(workers):
  m = sp.csr_matrix(np.eye(120, 30, dtype=np.float32))
  loader = RecommendationDataLoader(RecommendationDataset(m), batch_size=4,
                                    negative_sampling=True,
                                    num_workers=workers)
  before = threading.active_count()
  it = _trainer()._device_batch_iter(loader, depth=2)
  next(it)  # the producer is alive and filling the queue
  assert threading.active_count() > before
  it.close()
  assert _wait_for(before) <= before


def test_producer_exception_is_raised_in_the_consumer():
  class Broken:
    def __iter__(self):
      yield from []
      raise RuntimeError('collation failed')

  before = threading.active_count()
  with pytest.raises(RuntimeError, match='collation failed'):
    list(_trainer()._device_batch_iter(Broken()))
  assert _wait_for(before) <= before
