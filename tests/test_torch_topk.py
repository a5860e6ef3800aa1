"""The port's top-k (``recoder_tpu_torch/ops/topk.py``) against
``lax.top_k``, and the recommendations built on it, on the CPU.

* ``top_k`` equals ``lax.top_k`` -- values and indices, bitwise -- on
  random rows, tie-heavy quantized rows, constant rows, rows that are
  -inf but for a few entries, rows with NaN and signed zeros, bf16 rows
  and a 3-D input, each kind drawn from three seeds; ``Recoder`` refuses
  an ``eval_topk`` mode outside ``MODES`` (all of which are exact).
* The tie-order fault that ``torch.topk`` had: a user who has seen all
  but 5 of 300 items gets ``lax.top_k``'s ids from ``Recoder.recommend``
  -- the 5 unseen items, then the lowest seen ids -- and never a pad
  column (an id >= ``num_items``), at float32 and at bf16.
* iALS and EASE ``recommend`` equal the JAX package's where their scores
  tie (users without history, duplicated item factors, integer EASE
  weights).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import lax

from recoder_tpu.data import UsersInteractions as JaxUsers
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import EASE as JaxEASE
from recoder_tpu.models import IALS as JaxIALS
from recoder_tpu.models import DynamicAutoencoder as JaxAE
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import UsersInteractions
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import EASE, IALS, DynamicAutoencoder
from recoder_tpu_torch.ops.topk import MODES, top_k


def _rows(kind, shape=(6, 1000), seed=0):
  rng = np.random.default_rng(seed)
  if kind == 'random':
    return rng.standard_normal(shape).astype(np.float32)
  if kind == 'quantized':  # a handful of values: ties everywhere
    return (rng.integers(0, 4, shape) / 4.0).astype(np.float32)
  if kind == 'constant':
    return np.full(shape, 0.5, np.float32)
  if kind == 'mostly_inf':  # fewer finite entries than k
    x = np.full((int(np.prod(shape[:-1])), shape[-1]), -np.inf, np.float32)
    for r in range(x.shape[0]):
      x[r, rng.choice(shape[-1], 3, replace=False)] = rng.standard_normal(3)
    return x.reshape(shape)
  if kind == 'nan':  # NaN ranks first; +0.0 above -0.0
    x = rng.standard_normal(shape).astype(np.float32)
    x[1, ::7] = np.nan
    x[3, :] = np.nan
    x[4, :] = np.where(np.arange(shape[1]) % 2, 0.0, -0.0)
    x[5, ::3] = -np.nan
    return x
  raise ValueError(kind)


def _check(x, k):
  v, i = top_k(torch.from_numpy(x), k)
  jv, ji = lax.top_k(jnp.asarray(x), k)
  np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
  # (bitwise, NaN payloads and the sign of zero included)
  np.testing.assert_array_equal(v.numpy().view(np.int32),
                                np.asarray(jv).view(np.int32))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('kind', ['random', 'quantized', 'constant',
                                  'mostly_inf', 'nan'])
@pytest.mark.parametrize('k', [1, 10, 100])
def test_top_k_equals_lax_top_k(kind, k, seed):
  _check(_rows(kind, seed=seed), k)


@pytest.mark.parametrize('kind', ['random', 'quantized', 'mostly_inf'])
def test_top_k_bf16_and_leading_dims(kind):
  x = _rows(kind, shape=(2, 3, 700), seed=3)
  xb = torch.from_numpy(x).to(torch.bfloat16)
  v, i = top_k(xb, 25)
  jv, ji = lax.top_k(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), 25)
  assert v.dtype == torch.bfloat16 and i.shape == (2, 3, 25)
  np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
  np.testing.assert_array_equal(v.float().numpy(),
                                np.asarray(jv.astype(jnp.float32)))


def test_top_k_edges_and_mode_refusal():
  x = _rows('random', shape=(3, 5))
  _check(x, 5)
  v, i = top_k(torch.from_numpy(x), 0)
  assert v.shape == (3, 0) and i.shape == (3, 0)
  with pytest.raises(ValueError, match='exceeds'):
    top_k(torch.from_numpy(x), 6)
  for mode in MODES:
    Recoder(DynamicAutoencoder([4]), eval_topk=mode, device='cpu')
  with pytest.raises(ValueError, match='unknown top-k mode'):
    Recoder(DynamicAutoencoder([4]), eval_topk='certified', device='cpu')


def _five_unseen(n_items=300):
  seen = np.setdiff1d(np.arange(n_items), [3, 50, 142, 260, 299])
  return sp.csr_matrix((np.ones(len(seen), np.float32),
                        (np.zeros(len(seen), np.int64), seen)),
                       shape=(4, n_items))


def _trainers(n_items, cd=None, hidden=(32,), seed=3):
  jtr = JaxRecoder(JaxAE(list(hidden), 'tanh', compute_dtype=cd),
                   num_items=n_items, num_users=4)
  jtr._init_model()
  rng = np.random.default_rng(seed)
  params = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  params['de_bias'] = rng.standard_normal(
      params['de_bias'].shape).astype(np.float32)
  jtr.model.params = {k: jnp.asarray(v) for k, v in params.items()}
  ptr = Recoder(DynamicAutoencoder(list(hidden), 'tanh', compute_dtype=cd),
                num_items=n_items, num_users=4, device='cpu')
  ptr._init_model()
  convert.load_params(ptr.model, params)
  return jtr, ptr


@pytest.mark.parametrize('cd', [None, 'bfloat16'])
def test_recommend_takes_lax_top_k_ties(cd):
  """The fault: with 5 unseen items and k = 10, the other 5 slots are
  -inf ties; ``torch.topk`` filled them with pad columns (>= 300)."""
  m = _five_unseen()
  jtr, ptr = _trainers(300, cd)
  want = np.asarray(jtr.recommend(JaxUsers(np.array([0]), m[[0]]), 10))
  got = ptr.recommend(UsersInteractions(np.array([0]), m[[0]]), 10)
  assert got == want.tolist()
  assert max(got[0]) < 300
  assert sorted(got[0][:5]) == [3, 50, 142, 260, 299]
  assert got[0][5:] == [0, 1, 2, 4, 5]


def test_recommend_ties_of_a_zero_decoder():
  """Equal finite scores rank by the lowest item id, as in JAX."""
  m = _five_unseen()
  jtr, ptr = _trainers(300)
  jtr.model.params = {**jtr.model.params,
                      'de_bias': jnp.zeros_like(jtr.model.params['de_bias'])}
  with torch.no_grad():
    ptr.model.de_bias.zero_()
  rows = np.arange(4)
  want = np.asarray(jtr.recommend(JaxUsers(rows, m), 12)).tolist()
  got = ptr.recommend(UsersInteractions(rows, m), 12)
  assert got == want
  assert all(max(r) < 300 for r in got)


def test_ease_recommend_equals_jax_on_ties():
  rng = np.random.default_rng(4)
  x = (rng.random((12, 30)) < 0.2).astype(np.float32)
  x[0] = 0  # no history: every score 0
  m = sp.csr_matrix(x)
  weights = rng.integers(-2, 3, (30, 30)).astype(np.float32)
  np.fill_diagonal(weights, 0.0)
  jmodel = JaxEASE(lam=1.0)
  jmodel.item_weights, jmodel.num_items = jnp.asarray(weights), 30
  model = convert.ease_weights_from_numpy(EASE(lam=1.0, device='cpu'),
                                          {'item_weights': weights})
  rows = np.arange(12)
  got = model.recommend(UsersInteractions(rows, m), 8)
  want = jmodel.recommend(JaxUsers(rows, m), 8)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, np.asarray(w))
  np.testing.assert_array_equal(got[0], np.arange(8))


def test_ials_recommend_equals_jax_on_ties():
  rng = np.random.default_rng(5)
  x = (rng.random((10, 24)) < 0.25).astype(np.float32)
  x[[0, 7]] = 0  # no history: every score 0
  m = sp.csr_matrix(x)
  ref = JaxIALS(embedding_size=4, alpha=10.0, lam=0.05, sweeps=2,
                seed=1).fit(m, chunk_elems=4096)
  items = np.asarray(ref.item_factors).copy()
  items[1::2] = items[0::2]  # item pairs with equal scores
  ref.item_factors = jnp.asarray(items)
  got = convert.ials_factors_from_numpy(
      IALS(alpha=10.0, lam=0.05, device='cpu'),
      {'user_factors': np.asarray(ref.user_factors), 'item_factors': items})
  rows = np.arange(10)
  recs = got.recommend(UsersInteractions(rows, m), 6)
  want = ref.recommend(JaxUsers(rows, m), 6)
  for g, w in zip(recs, want):
    np.testing.assert_array_equal(g, np.asarray(w))
  np.testing.assert_array_equal(recs[0], np.arange(6))
