"""The port's preprocessing against the JAX package's: the same frames
(from numpy seeds) give equal counts, filters and splits, and
``strong_generalization_split`` writes the same CSVs (train, and the
fold-in and held-out parts of validation and test), byte for byte.
tests/test_preprocessing.py's checks run against the port as well."""

import os

import numpy as np
import pandas as pd
import pytest

import recoder_tpu.preprocessing as jax_pre
import recoder_tpu_torch.preprocessing as pre

FILES = ('train.csv', 'validation_tr.csv', 'validation_te.csv',
         'test_tr.csv', 'test_te.csv')


@pytest.fixture
def raw():
  rng = np.random.default_rng(0)
  n = 20000
  return pd.DataFrame({
      'userId': rng.integers(0, 400, n),
      'movieId': rng.zipf(1.6, n) % 300,
  }).drop_duplicates()


@pytest.mark.parametrize('col', ['userId', 'movieId'])
def test_get_count_equals_jax(raw, col):
  pd.testing.assert_series_equal(pre.get_count(raw, col),
                                 jax_pre.get_count(raw, col))


@pytest.mark.parametrize('min_uc,min_sc', [(5, 0), (10, 15), (0, 3), (0, 0)])
def test_filter_triplets_equals_jax(raw, min_uc, min_sc):
  got = pre.filter_triplets(raw, min_uc=min_uc, min_sc=min_sc)
  want = jax_pre.filter_triplets(raw, min_uc=min_uc, min_sc=min_sc)
  pd.testing.assert_frame_equal(got[0], want[0])
  pd.testing.assert_series_equal(got[1], want[1])
  pd.testing.assert_series_equal(got[2], want[2])


@pytest.mark.parametrize('test_prop,seed,min_items', [(0.2, 98765, 5),
                                                      (0.5, 1, 2)])
def test_split_train_test_proportion_equals_jax(raw, test_prop, seed,
                                                min_items):
  got = pre.split_train_test_proportion(raw, test_prop=test_prop, seed=seed,
                                        min_items=min_items)
  want = jax_pre.split_train_test_proportion(
      raw, test_prop=test_prop, seed=seed, min_items=min_items)
  for g, w in zip(got, want):
    pd.testing.assert_frame_equal(g, w)


@pytest.mark.parametrize('kw', [dict(n_heldout_users=50),
                                dict(n_heldout_users=30, min_uc=10,
                                     min_sc=5, seed=3, test_prop=0.3)])
def test_strong_generalization_split_writes_the_jax_csvs(raw, kw, tmp_path):
  got = pre.strong_generalization_split(raw, str(tmp_path / 'port'), **kw)
  want = jax_pre.strong_generalization_split(raw, str(tmp_path / 'jax'),
                                             **kw)
  np.testing.assert_array_equal(got[0], want[0])
  np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
  assert (sorted(os.listdir(tmp_path / 'port'))
          == sorted(os.listdir(tmp_path / 'jax')) == sorted(FILES))
  for name in FILES:
    port_csv = (tmp_path / 'port' / name).read_bytes()
    assert port_csv == (tmp_path / 'jax' / name).read_bytes(), name
    assert len(port_csv.splitlines()) > 1


def test_other_column_names(tmp_path):
  rng = np.random.default_rng(5)
  frame = pd.DataFrame({'u': rng.integers(0, 200, 5000),
                        'i': rng.integers(0, 80, 5000)}).drop_duplicates()
  for mod, name in ((pre, 'port'), (jax_pre, 'jax')):
    mod.strong_generalization_split(frame, str(tmp_path / name),
                                    user_col='u', item_col='i',
                                    n_heldout_users=20)
  for name in FILES:
    assert ((tmp_path / 'port' / name).read_bytes()
            == (tmp_path / 'jax' / name).read_bytes())


# -- tests/test_preprocessing.py's checks against the port ---------------

def test_filter_triplets(raw):
  tp, usercount, itemcount = pre.filter_triplets(raw, min_uc=10, min_sc=15)
  assert usercount.min() >= 10
  assert set(tp.userId) == set(usercount.index)
  assert set(tp.movieId) == set(itemcount.index)


def test_split_proportion(raw):
  tr, te = pre.split_train_test_proportion(raw, test_prop=0.2, min_items=5)
  assert len(pd.concat([tr, te])) == len(raw)
  assert len(pd.merge(tr, te, on=['userId', 'movieId'])) == 0
  sizes = raw.groupby('userId').size()
  te_sizes = te.groupby('userId').size()
  for uid, n in sizes.items():
    if n >= 5:
      assert te_sizes.get(uid, 0) == int(0.2 * n)


def test_strong_generalization_split(raw, tmp_path):
  out = str(tmp_path)
  pre.strong_generalization_split(raw, out, n_heldout_users=50,
                                  min_uc=5, min_sc=0)
  frames = {name: pd.read_csv(os.path.join(out, name)) for name in FILES}
  train = frames['train.csv']
  vtr, vte = frames['validation_tr.csv'], frames['validation_te.csv']
  ttr, tte = frames['test_tr.csv'], frames['test_te.csv']
  tr_u, v_u, t_u = set(train.uid), set(vtr.uid) | set(vte.uid), \
      set(ttr.uid) | set(tte.uid)
  assert not (tr_u & v_u) and not (tr_u & t_u) and not (v_u & t_u)
  assert len(v_u) <= 50 and len(t_u) <= 50
  sids = set(train.sid)
  for df in (vtr, vte, ttr, tte):
    assert set(df.sid) <= sids
    assert (df.watched == 1).all()
  assert len(pd.merge(vtr, vte, on=['uid', 'sid'])) == 0
