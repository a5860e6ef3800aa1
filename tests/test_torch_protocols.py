"""The port's Mult-VAE protocol helpers (``recoder_tpu_torch.protocols``)
against the JAX package's, on the CPU: a JAX trainer's weights carried
into a port trainer (``convert.load_params``) give the same held-out
multinomial NLL per user and the same protocol summary (within 1e-5:
float32 scores summed in another order, the log-sum-exp in float64 on
both sides)."""

import numpy as np
import pytest
import scipy.sparse as sp

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MultVAE as JaxMultVAE
from recoder_tpu.protocols import evaluate_vae_protocol as jax_protocol
from recoder_tpu.protocols import heldout_multinomial_nll as jax_nll
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MultVAE
from recoder_tpu_torch.protocols import (evaluate_vae_protocol,
                                         heldout_multinomial_nll)

N_USERS, N_ITEMS = 50, 80


def _matrix(per_user, seed):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N_USERS), per_user)
  cols = rng.integers(0, N_ITEMS, len(rows))
  m = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                    shape=(N_USERS, N_ITEMS))
  m.data[:] = 1.0  # (repeated draws sum: binarize)
  return m


MODELS = {
    'multvae': (lambda: JaxMultVAE(16, 4, total_anneal_steps=20),
                lambda: MultVAE(16, 4, total_anneal_steps=20)),
    'autoencoder': (lambda: JaxDynAE([16], noise_prob=0.0),
                    lambda: DynamicAutoencoder([16], noise_prob=0.0)),
}


@pytest.fixture(params=sorted(MODELS))
def carried(request):
  """A JAX trainer trained for 3 epochs and a port trainer holding its
  weights, with a fold-in / fold-out evaluation set."""
  jax_model, port_model = MODELS[request.param]
  train = _matrix(8, 0)
  jtr = JaxRecoder(jax_model(), optimizer_type='adam', loss='logloss')
  jtr.train(JaxDataset(train), batch_size=25, num_epochs=3,
            negative_sampling=True)
  ptr = Recoder(port_model(), optimizer_type='adam', loss='logloss',
                device='cpu')
  ptr.num_items, ptr.num_users = jtr.num_items, jtr.num_users
  ptr.model.load_model_params(jtr.model.model_params())
  ptr._init_model()
  convert.load_params(ptr.model, {k: np.asarray(v)
                                  for k, v in jtr.model.params.items()})
  fold_in, fold_out = _matrix(5, 1), _matrix(4, 2)
  return jtr, ptr, (fold_in, fold_out)


def test_heldout_nll_matches_jax(carried):
  jtr, ptr, (fold_in, fold_out) = carried
  want = jax_nll(jtr, JaxDataset(fold_in, fold_out), batch_size=17)
  got = heldout_multinomial_nll(ptr, RecommendationDataset(fold_in,
                                                           fold_out),
                                batch_size=17)
  assert len(got) == len(want) > 0 and np.all(got > 0)
  np.testing.assert_allclose(got, want, rtol=1e-5)
  # the first user by hand: -mean log_softmax over the held-out items
  scores = ptr.predict(UsersInteractions(np.arange(1), fold_in[:1]))[0]
  scores = scores.astype(np.float64)
  log_p = scores - scores.max() - np.log(np.exp(scores - scores.max()).sum())
  held = fold_out.indices[fold_out.indptr[0]:fold_out.indptr[1]]
  np.testing.assert_allclose(got[0], -log_p[held].mean(), rtol=1e-5)


def test_protocol_summary_matches_jax(carried):
  jtr, ptr, (fold_in, fold_out) = carried
  kw = dict(recall_ks=(10, 20), ndcg_ks=(20,), batch_size=25)
  want = jax_protocol(jtr, JaxDataset(fold_in, fold_out), **kw)
  got = evaluate_vae_protocol(ptr, RecommendationDataset(fold_in, fold_out),
                              **kw)
  assert set(got) == set(want) == {'Recall@10', 'Recall@20', 'NDCG@20',
                                   'HeldoutMultinomialNLL'}
  for k, v in want.items():
    np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_a_fold_out_is_required():
  ptr = Recoder(MultVAE(8, 2), device='cpu')
  with pytest.raises(ValueError, match='fold-out'):
    heldout_multinomial_nll(ptr, RecommendationDataset(_matrix(2, 3)))
