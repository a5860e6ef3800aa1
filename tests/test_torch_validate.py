"""The validation loss and the ``eval_freq`` hooks of ``train``, the port
against the JAX package, on a subset of the tests/data fixture (its first
400 users, ``RecommendationDataset(val, train)`` as tests/test_model.py
builds the validation set).

* ``_validate`` from the same parameters over loaders with the same
  seed, for 'mse' (confidence 3), 'logistic' and 'logloss', over item
  unions (negative sampling) and the full catalog: rtol 1e-5 at float32,
  1e-2 at bf16 compute.
* ``train(..., val_dataset=..., eval_freq=1, metrics=...)``: the
  ``val_loss`` and the metrics the epoch's log line carries equal the
  JAX trainer's (its users-mode union steps draw the JAX epoch order, so
  both train the same steps from the same parameters).
* Validation does not change training: with one seed, ``eval_freq=1``
  and ``eval_freq=0`` give bitwise equal losses, parameters and moments,
  with noise on, from the full-decode slab and from the host loader.
"""

import logging
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from recoder_tpu.data import RecommendationDataLoader as JaxLoader
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.metrics import NDCG as JaxNDCG
from recoder_tpu.metrics import Recall as JaxRecall
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import (RecommendationDataLoader,
                                    RecommendationDataset)
from recoder_tpu_torch.metrics import NDCG, Recall
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.utils import dataframe_to_csr_matrix

N_USERS, BATCH, HIDDEN, SEED = 400, 100, [16], 5
LOSSES = {'mse': {'confidence': 3}, 'logistic': {}, 'logloss': {}}
RTOL = {None: 1e-5, 'bfloat16': 1e-2}


@pytest.fixture(scope='module')
def fixture_subset():
  data = os.path.join(os.path.dirname(__file__), 'data')
  train_df = pd.read_csv(os.path.join(data, 'train.csv.gz'))
  val_df = pd.read_csv(os.path.join(data, 'val.csv.gz'))
  val_df = val_df[val_df.sid.isin(train_df.sid.unique())]
  train_m, item_map, user_map = dataframe_to_csr_matrix(
      train_df, user_col='uid', item_col='sid', inter_col='watched')
  val_m, _, _ = dataframe_to_csr_matrix(
      val_df, user_col='uid', item_col='sid', inter_col='watched',
      item_id_map=item_map, user_id_map=user_map)
  return train_m[:N_USERS].tocsr(), val_m[:N_USERS].tocsr()


def _pair(loss, train_m, compute_dtype=None, noise=0.0):
  """A JAX trainer and a port trainer with its parameters."""
  kw = dict(hidden_layers=HIDDEN, activation_type='tanh', noise_prob=noise,
            compute_dtype=compute_dtype)
  jtr = JaxRecoder(JaxDynAE(**kw), optimizer_type='adam', loss=loss,
                   loss_params=LOSSES[loss], seed=SEED)
  jtr.num_items, jtr.num_users = train_m.shape[1], train_m.shape[0]
  jtr._init_training(JaxDataset(train_m), weight_decay=0)
  ptr = Recoder(DynamicAutoencoder(**kw), optimizer_type='adam', loss=loss,
                loss_params=LOSSES[loss], seed=SEED, device='cpu')
  ptr.num_items, ptr.num_users = train_m.shape[1], train_m.shape[0]
  ptr._init_training(RecommendationDataset(train_m), 1e-3, 0)
  with torch.no_grad():
    for name, p in ptr.model.params().items():
      p.copy_(torch.from_numpy(convert.fit_table(
          name, tuple(p.shape), np.asarray(jtr.model.params[name]))))
  return jtr, ptr


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('negative_sampling', [True, False])
@pytest.mark.parametrize('loss', sorted(LOSSES))
def test_validate_matches_jax(fixture_subset, loss, negative_sampling,
                              compute_dtype):
  train_m, val_m = fixture_subset
  jtr, ptr = _pair(loss, train_m, compute_dtype)
  kw = dict(batch_size=BATCH, negative_sampling=negative_sampling, seed=9)
  want = jtr._validate(JaxLoader(JaxDataset(val_m, train_m), **kw))
  got = ptr._validate(RecommendationDataLoader(
      RecommendationDataset(val_m, train_m), **kw))
  assert np.isfinite(got)
  np.testing.assert_allclose(got, want, rtol=RTOL[compute_dtype])


def _hook_values(records, logger):
  """The numbers the last epoch log line of ``logger`` carries after its
  loss: ``{'val_loss': x, 'Recall@20': y, ...}``."""
  lines = [r.getMessage() for r in records
           if r.name == logger and 'val_loss=' in r.getMessage()]
  assert lines, f'no validation in the {logger} log'
  tail = lines[-1].split('val_loss=', 1)[1]
  values = dict(re.findall(r'(\S+)=([-0-9.naif]+)', 'val_loss=' + tail))
  return {k: float(v) for k, v in values.items()}


def test_eval_freq_hook_logs_what_jax_logs(fixture_subset, caplog):
  train_m, val_m = fixture_subset
  jtr, ptr = _pair('mse', train_m)
  kw = dict(batch_size=BATCH, lr=1e-2, num_epochs=1, iters_per_epoch=3,
            negative_sampling=True, shuffle='users', full_decode=False,
            eval_freq=1, eval_num_recommendations=20, eval_num_users=200,
            eval_batch_size=50)
  with caplog.at_level(logging.INFO):
    jtr.train(JaxDataset(train_m), JaxDataset(val_m, train_m),
              metrics=[JaxRecall(20), JaxNDCG(20)], **kw)
    ptr.train(RecommendationDataset(train_m),
              RecommendationDataset(val_m, train_m),
              metrics=[Recall(20), NDCG(20)], **kw)
  want = _hook_values(caplog.records, 'recoder_tpu')
  got = _hook_values(caplog.records, 'recoder_tpu_torch')
  assert set(got) == set(want) == {'val_loss', 'Recall@20', 'NDCG@20'}
  # (the log rounds the loss to 5 decimals and the metrics to 4)
  np.testing.assert_allclose(got['val_loss'], want['val_loss'], rtol=1e-4)
  for k in ('Recall@20', 'NDCG@20'):
    assert abs(got[k] - want[k]) <= 1.5e-4, (k, got[k], want[k])


def _state(trainer):
  params = {k: v.detach().clone() for k, v in trainer.model.params().items()}
  moments = [{k: torch.as_tensor(v).clone() for k, v in st.items()}
             for st in trainer.optimizer.state.values()]
  return trainer.last_epoch_losses, params, moments


@pytest.mark.parametrize('route', ['full-decode', 'host-loader', 'bf16'])
def test_validation_does_not_change_training(fixture_subset, route):
  train_m, val_m = fixture_subset
  cd = 'bfloat16' if route == 'bf16' else None
  if route == 'host-loader':
    dataset = RecommendationDataset(train_m, val_m)
    kw = dict(shuffle='users')
  else:
    dataset = RecommendationDataset(train_m)
    kw = dict(shuffle='blocks', full_decode=True)
  runs = []
  for eval_freq in (1, 0):
    tr = Recoder(DynamicAutoencoder(HIDDEN, 'tanh', noise_prob=0.5,
                                    compute_dtype=cd),
                 optimizer_type='adam', loss='mse', seed=SEED, device='cpu',
                 opt_state_dtype=cd)
    tr.train(dataset, RecommendationDataset(val_m, train_m), batch_size=BATCH,
             num_epochs=2, negative_sampling=True, eval_freq=eval_freq,
             metrics=[Recall(20)], eval_num_recommendations=20, **kw)
    runs.append(_state(tr))
  (l1, p1, m1), (l0, p0, m0) = runs
  assert l1 == l0 and len(l1) == N_USERS // BATCH
  assert all(torch.equal(p1[k], p0[k]) for k in p0)
  assert len(m1) == len(m0) > 0
  for a, b in zip(m1, m0):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k].float(), b[k].float()) for k in a)
