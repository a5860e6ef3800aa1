"""The port's whole training slice against the JAX package's, from the
same parameters, noise off, on a single-block dataset (users <= batch,
so neither side draws a permutation that matters): the per-step losses
(rtol 1e-4), the parameters after ``train`` (atol 1e-5), and the npz
checkpoints in both directions -- a JAX checkpoint serves the same
top-k from the port and trains on with its Adam moments, and a port
checkpoint serves the same top-k from JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu import metrics as jax_metrics
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch import metrics as port_metrics
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

N_USERS, N_ITEMS, BATCH, HIDDEN = 40, 120, 64, [16]
LR, WD, STEPS, K = 1e-2, 1e-3, 4, 10

# (loss, loss_params, negative_sampling): without negative sampling the
# loss covers the whole catalog instead of the batch's columns
CASES = [('mse', {'confidence': 3}, True), ('logistic', {}, True),
         ('logloss', {}, True), ('mse', {'confidence': 3}, False)]


def _matrix():
  rng = np.random.default_rng(0)
  return sp.csr_matrix(
      (rng.random((N_USERS, N_ITEMS)) < 0.1).astype(np.float32))


def _jax_trainer(loss, loss_params):
  tr = JaxRecoder(JaxDynAE(HIDDEN, 'tanh', noise_prob=0.0),
                  optimizer_type='adam', loss=loss,
                  loss_params=dict(loss_params), seed=3)
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  return tr


def _port_trainer(loss, loss_params, params):
  tr = Recoder(DynamicAutoencoder(HIDDEN, 'tanh', noise_prob=0.0),
               optimizer_type='adam', loss=loss,
               loss_params=dict(loss_params), seed=3, device='cpu')
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  with torch.no_grad():
    for name, t in convert.params_from_numpy(params).items():
      tr.model.params()[name].copy_(t)
  return tr


def _slab(matrix, width):
  slab = np.zeros((BATCH, width), np.float32)
  slab[:N_USERS, :N_ITEMS] = matrix.toarray()
  return slab


def _train_kw(negative_sampling=True):
  return dict(batch_size=BATCH, lr=LR, weight_decay=WD,
              negative_sampling=negative_sampling, shuffle='blocks')


def _assert_params(port_trainer, jax_params, atol=1e-5):
  for name, p in port_trainer.model.params().items():
    np.testing.assert_allclose(p.detach().numpy(),
                               np.asarray(jax_params[name]), atol=atol,
                               err_msg=name)


@pytest.mark.parametrize('loss,loss_params,negative_sampling', CASES)
def test_steps_and_training_match_jax(loss, loss_params, negative_sampling):
  m = _matrix()
  jtr = _jax_trainer(loss, loss_params)
  init = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  W = jtr.model.num_items_padded
  slab = _slab(m, W)

  # reference trajectory: the JAX step math on the epoch's one batch
  ref = _jax_trainer(loss, loss_params)
  ref.model.params = {k: jnp.asarray(v) for k, v in init.items()}
  ref._init_training(JaxDataset(m), weight_decay=WD)
  batch = {'in_slab': jnp.asarray(slab), 'in_users': jnp.arange(BATCH),
           'in_items': None, 'in_valid_users': jnp.float32(N_USERS),
           'in_valid_width': jnp.int32(0)}
  if negative_sampling:
    batch.update(fd=True, fd_mask_from_slab=True)
  params, opt_state, ref_losses = ref.model.params, ref.opt_state, []
  for _ in range(STEPS):
    params, opt_state, l = ref._dense_step_math(params, opt_state, batch,
                                                jnp.float32(LR), None)
    ref_losses.append(float(l))

  # the port's step math on the same batch
  ptr = _port_trainer(loss, loss_params, init)
  ptr._init_training(RecommendationDataset(m), LR, WD)
  pbatch = {'slab': torch.from_numpy(slab), 'num_users': float(N_USERS)}
  got = [ptr._dense_step_math(pbatch, negative_sampling).item()
         for _ in range(STEPS)]
  np.testing.assert_allclose(got, ref_losses, rtol=1e-4)
  _assert_params(ptr, params)

  # train() on both sides: one step per epoch
  jtr.train(JaxDataset(m), num_epochs=STEPS, full_decode=True,
            slab_cache=True, **_train_kw(negative_sampling))
  _assert_params(ptr, jtr.model.params)  # JAX train == its step math
  ptr2 = _port_trainer(loss, loss_params, init)
  ptr2.train(RecommendationDataset(m), num_epochs=STEPS,
             **_train_kw(negative_sampling))
  assert ptr2.current_epoch == STEPS and ptr2._global_step == STEPS
  np.testing.assert_allclose(ptr2.last_epoch_losses, ref_losses[-1:],
                             rtol=1e-4)
  _assert_params(ptr2, jtr.model.params)


def _topk(trainer, matrix):
  users, _ = RecommendationDataset(matrix)[np.arange(N_USERS)]
  return np.asarray(trainer.recommend(users, K))


def test_checkpoints_cross_load(tmp_path):
  m = _matrix()
  jtr = _jax_trainer('mse', {'confidence': 3})
  init = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  jtr.train(JaxDataset(m), num_epochs=STEPS, full_decode=True,
            slab_cache=True, **_train_kw())
  ptr = _port_trainer('mse', {'confidence': 3}, init)
  ptr.train(RecommendationDataset(m), num_epochs=STEPS, **_train_kw())
  jax_top = _topk(jtr, m)

  # JAX checkpoint -> port
  jax_file = jtr.save_state(str(tmp_path / 'jax'))
  from_jax = Recoder(DynamicAutoencoder(), device='cpu')
  from_jax.init_from_model_file(jax_file)
  assert from_jax.current_epoch == STEPS
  assert from_jax.model.model_params() == jtr.model.model_params()
  np.testing.assert_array_equal(_topk(from_jax, m), jax_top)
  users, _ = RecommendationDataset(m)[np.arange(N_USERS)]
  scores, dense = from_jax.predict(users, return_input=True)
  np.testing.assert_allclose(scores, jtr.predict(users), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_array_equal(dense, m.toarray())
  # evaluation on a fold-in split: the same per-user metrics
  fold_in = m.multiply(sp.csr_matrix(
      np.random.default_rng(1).random(m.shape) < 0.5)).tocsr()
  held_out = (m - fold_in).tocsr()
  got = from_jax.evaluate(RecommendationDataset(fold_in, held_out), K,
                          [port_metrics.Recall(K), port_metrics.NDCG(K)],
                          batch_size=16)
  ref = jtr.evaluate(JaxDataset(fold_in, held_out), K,
                     [jax_metrics.Recall(K), jax_metrics.NDCG(K)],
                     batch_size=16)
  for metric in got:
    np.testing.assert_allclose(got[metric], ref[str(metric)], rtol=1e-12)

  # port checkpoint -> JAX
  port_file = ptr.save_state(str(tmp_path / 'port'))
  to_jax = JaxRecoder(JaxDynAE(), optimizer_type='adam')
  to_jax.init_from_model_file(port_file)
  assert to_jax.current_epoch == STEPS
  np.testing.assert_array_equal(_topk(to_jax, m), _topk(ptr, m))
  np.testing.assert_array_equal(_topk(ptr, m), jax_top)

  # resume from the JAX checkpoint's Adam state: epochs STEPS..STEPS+1
  # re-run on both sides (resume is inclusive of current_epoch)
  jtr.train(JaxDataset(m), num_epochs=STEPS + 1, full_decode=True,
            slab_cache=True, **_train_kw())
  from_jax.train(RecommendationDataset(m), num_epochs=STEPS + 1,
                 **_train_kw())
  _assert_params(from_jax, jtr.model.params)


def test_multistep_lr_quirk():
  from recoder_tpu.model import _multistep_lr as jax_lr
  from recoder_tpu_torch.model import _multistep_lr
  for epoch in range(1, 8):
    assert _multistep_lr(0.1, [2, 4], epoch) == jax_lr(0.1, [2, 4], epoch)
  assert _multistep_lr(0.1, None, 5) == 0.1
  # the trainer applies it per epoch: milestone 1 decays epoch 2
  tr = Recoder(DynamicAutoencoder([8]), optimizer_type='adam', loss='mse',
               device='cpu')
  tr.train(RecommendationDataset(_matrix()), batch_size=BATCH, lr=0.1,
           num_epochs=2, lr_milestones=[1], negative_sampling=True)
  assert [g['lr'] for g in tr.optimizer.param_groups] == \
      pytest.approx([0.01, 0.01])
