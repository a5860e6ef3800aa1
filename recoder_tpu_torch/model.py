"""The Recoder trainer: train / evaluate / predict / recommend / checkpoint.

Port of ``recoder_tpu/model.py``'s dense full-decode training path and
the serving path it needs:

  * each step fetches ``batch_size`` rows of the resident dense slab
    (``data/device_pipeline.py``), encodes them with one matmul, and
    decodes against the WHOLE decoder table; the loss is masked to the
    columns the batch touched (``any(slab != 0)``, mini-batch negative
    sampling) and to the logical catalog, summed, and divided by the
    number of valid users (JAX ``_forward_loss``, full-decode branch);
  * for 'mse' and 'logistic' the decode and the loss are one fused
    CUDA kernel (``ops/fused_decode_loss.py``); 'logloss' and custom
    ``Loss`` instances decode with a matmul and take the loss from
    ``ops/losses.py``, as in JAX;
  * Adam and the other optimizers are ``torch.optim`` with the JAX
    package's rules (``optim.py``);
  * MultiStepLR(gamma=0.1) with the reference's epoch-start quirk, and
    ``train`` resuming from ``current_epoch`` inclusive;
  * ``recommend``: full-catalog scores, seen items and pad columns set
    to -inf, then ``torch.topk``;
  * npz checkpoints in the JAX package's format.

Randomness comes from explicit generators: the init from a CPU
generator seeded with ``seed``, each epoch's permutation from a CPU
generator seeded with ``(seed, epoch)``, each step's dropout from a
generator on the device seeded with ``(seed, global step)``.

Not ported yet: the union (gathered) batches and their overflow
rebuilds, sparse tables and row-sparse Adam, bf16 compute, moments and
parameters, the validation loss, random extra negatives, the packed
slab, dual (target) training matrices, chunked evaluation, the orbax
backend, meshes and profiling.
"""

import logging
import os
import time

import numpy as np
import torch

from recoder_tpu_torch import __version__, convert
from recoder_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.metrics import RecommenderEvaluator
from recoder_tpu_torch.models.base import FactorizationModel
from recoder_tpu_torch.ops import losses as losses_lib
from recoder_tpu_torch.ops.fused_decode_loss import (fused_decode_loss,
                                                     supported)
from recoder_tpu_torch.optim import KINDS, make_optimizer
from recoder_tpu_torch.recommender import InferenceRecommender

log = logging.getLogger('recoder_tpu_torch')
if not log.handlers:
  _h = logging.StreamHandler()
  _h.setFormatter(logging.Formatter('%(asctime)s %(levelname)s %(message)s'))
  log.addHandler(_h)
  log.setLevel(logging.INFO)


def _multistep_lr(base_lr, milestones, epoch, gamma=0.1):
  """LR for 1-based ``epoch`` under the reference's scheduler stepping:
  during epoch ``e`` the decay counts milestones <= e - 1."""
  if not milestones:
    return base_lr
  count = sum(1 for m in milestones if m <= epoch - 1)
  return base_lr * (gamma ** count)


def _checked_array(name, ref, arr):
  """A float32 checkpoint array for the parameter ``ref``, shape-checked."""
  arr = np.asarray(arr, np.float32)
  if arr.shape != tuple(ref.shape):
    raise ValueError(f'checkpoint array {name} has shape {arr.shape}, '
                     f'the model expects {tuple(ref.shape)}')
  return arr


class Recoder:
  """Trains and evaluates a :class:`FactorizationModel`.

  Args:
    model (FactorizationModel): the model to train.
    num_items (int, optional): catalog size; inferred from the first
      training dataset if None.
    num_users (int, optional): user count; inferred if None.
    optimizer_type (str): 'sgd' | 'adam' | 'adagrad' | 'rmsprop'.
    loss (str or ops.losses.Loss): 'mse' | 'logistic' | 'logloss', or a
      sum-reduced Loss instance that accepts row/col masks. 'mse' and
      'logistic' train through the fused decode-loss kernel; a Loss
      instance (e.g. ``MSELoss(confidence=3, reduction='sum')``, the
      same value and gradients) through the decode matmul and the
      [B, W] score matrix.
    loss_params (dict, optional): extra loss params when ``loss`` is str.
    user_based / item_based (bool): consistency checks between the model
      and datasets.
    seed (int): seed of the init, permutation and dropout generators.
    device: where the model, the slab and every step live ('cuda' on
      the GPU).
  """

  def __init__(self, model: FactorizationModel, num_items=None,
               num_users=None, optimizer_type='sgd', loss='mse',
               loss_params=None, user_based=True, item_based=True,
               seed=42, device='cpu'):
    if optimizer_type not in KINDS:
      raise ValueError(f'Unknown optimizer kind {optimizer_type}')
    self.model = model
    self.num_items = num_items
    self.num_users = num_users
    self.optimizer_type = optimizer_type
    self.loss = loss
    self.loss_params = loss_params if loss_params else {}
    self.user_based = user_based
    self.item_based = item_based
    self.seed = seed
    self.device = torch.device(device)

    self.optimizer = None
    self.current_epoch = 1
    self.items = None
    self.users = None
    self.loss_module = None
    #: per-step training losses of the last epoch, fetched at its end
    self.last_epoch_losses = []
    #: wall seconds of the last epoch's steps, up to that fetch
    self.last_epoch_seconds = 0.0

    self._model_initialized = False
    self._pending_opt_arrays = None
    self._global_step = 0
    self._source_cache = None
    self._epoch_perm = None
    self._iters_consumed = 0
    self._train_iterator_key = None
    self._dropout_gen = torch.Generator(device=self.device)

  # ------------------------------------------------------------------
  # initialization
  # ------------------------------------------------------------------

  def _init_model(self):
    if self._model_initialized:
      return
    self.model.init_model(self.num_items, self.num_users, seed=self.seed)
    self.model.to(self.device)
    self._model_initialized = True

  def _init_loss_module(self):
    if isinstance(self.loss, losses_lib.Loss):
      self.loss_module = self.loss
    elif self.loss == 'logistic':
      self.loss_module = losses_lib.LogisticLoss(reduction='sum',
                                                 **self.loss_params)
    elif self.loss == 'mse':
      self.loss_module = losses_lib.MSELoss(reduction='sum',
                                            **self.loss_params)
    elif self.loss == 'logloss':
      self.loss_module = losses_lib.MultinomialNLLLoss(reduction='sum')
    elif self.loss is None:
      raise ValueError('No loss function defined')
    else:
      raise ValueError(f'Unknown loss function {self.loss}')

  def _init_optimizer(self, lr, weight_decay):
    named = self.model.params()
    prev = self.optimizer
    self.optimizer = make_optimizer(self.optimizer_type, named, lr,
                                    weight_decay)
    if prev is not None:
      if type(prev) is type(self.optimizer):
        # continued training on the same instance keeps the moments
        self.optimizer.state.update(prev.state)
      else:
        log.warning('optimizer type changed; optimizer state reset')
    if self._pending_opt_arrays is not None:
      tree = self._pending_opt_arrays
      self._pending_opt_arrays = None
      tree = {k: ({n: _checked_array(f'optimizer/{k}/{n}', named[n], a)
                   for n, a in v.items()} if isinstance(v, dict) else v)
              for k, v in tree.items()}
      convert.opt_state_into_torch(self.optimizer, named, tree,
                                   self.optimizer_type)

  def _init_training(self, train_dataset, lr, weight_decay):
    if self.items is None:
      self.items = np.asarray(train_dataset.items)
    else:
      self.items = np.unique(np.append(self.items, train_dataset.items))
    if self.users is None:
      self.users = np.asarray(train_dataset.users)
    else:
      self.users = np.unique(np.append(self.users, train_dataset.users))

    if self.item_based and self.num_items is None:
      self.num_items = int(np.max(self.items)) + 1
    elif self.item_based and self.num_items < int(np.max(self.items)) + 1:
      raise ValueError('The largest item id should be smaller than number '
                       'of items. If your model is not item based, set '
                       'item_based=False.')
    if self.user_based and self.num_users is None:
      self.num_users = int(np.max(self.users)) + 1
    elif self.user_based and self.num_users < int(np.max(self.users)) + 1:
      raise ValueError('The largest user id should be smaller than number '
                       'of users. If your model is not user based, set '
                       'user_based=False.')

    self._init_model()
    self._init_optimizer(lr, weight_decay)
    self._init_loss_module()

  # ------------------------------------------------------------------
  # training step
  # ------------------------------------------------------------------

  def _fused_kind(self):
    """The fused kernel's loss kind for this trainer, or None."""
    if isinstance(self.loss, str) and supported(self.loss):
      return self.loss
    return None

  def _forward_loss(self, batch, training, negative_sampling=True,
                    generator=None):
    """Loss of one full-decode batch (the JAX ``_forward_loss`` with a
    pre-built slab): masked sum over the batch's columns, divided by
    the number of valid users."""
    model = self.model
    slab = batch['slab']
    # the slab's storage dtype holds every value exactly
    input_dense = slab.float()
    B, W = input_dense.shape
    valid_users = batch['num_users']
    row_mask = (torch.arange(B, device=slab.device) < valid_users).float()
    in_catalog = torch.arange(W, device=slab.device) < model.num_items
    if negative_sampling:
      # the loss columns: items any user of the batch touched
      col_mask = (torch.any(slab != 0, dim=0) & in_catalog).float()
    else:
      col_mask = in_catalog.float()

    h = model.encode(input_dense, training=training, generator=generator)
    kind = self._fused_kind()
    if kind is not None:
      loss = fused_decode_loss(
          h, model.decoder_table(), model.de_bias, input_dense, row_mask,
          col_mask, kind, getattr(self.loss_module, 'confidence', 0.0))
    else:
      loss = self.loss_module(model.decode(h), input_dense,
                              row_mask=row_mask, col_mask=col_mask)
    return loss / valid_users

  def _dense_step_math(self, batch, negative_sampling=True):
    """One optimizer update; returns the step's loss (on the device)."""
    self._dropout_gen.manual_seed((self.seed << 32) + self._global_step)
    self.optimizer.zero_grad(set_to_none=True)
    loss = self._forward_loss(batch, training=True,
                              negative_sampling=negative_sampling,
                              generator=self._dropout_gen)
    loss.backward()
    self.optimizer.step()
    return loss.detach()

  # ------------------------------------------------------------------
  # training loop
  # ------------------------------------------------------------------

  def _data_source(self, matrix, batch_size, num_sampling_users, shuffle):
    cfg = (batch_size, num_sampling_users, shuffle, self.num_items)
    cached = self._source_cache
    if cached is not None and cached[0] is matrix and cached[1] == cfg:
      return cached[2]
    self._source_cache = None  # free the old slab before the new build
    source = DeviceDataSource(matrix, batch_size=batch_size,
                              num_sampling_users=num_sampling_users,
                              num_items=self.num_items, shuffle=shuffle,
                              device=self.device)
    self._source_cache = (matrix, cfg, source)
    return source

  def train(self, train_dataset, val_dataset=None, lr=0.001,
            weight_decay=0, num_epochs=1, iters_per_epoch=None,
            batch_size=64, lr_milestones=None, negative_sampling=False,
            num_sampling_users=0, shuffle='users', slab_cache='auto'):
    """Train the model (argument semantics follow the JAX package's
    ``Recoder.train``).

    Every step decodes the full catalog from the resident slab
    (``slab_cache``: 'auto' checks the slab against half the device's
    free memory and raises when it does not fit; True skips the check).
    With ``negative_sampling`` the loss covers the columns the batch
    touched, without it the whole catalog. ``shuffle``: 'users' or
    'blocks'. ``val_dataset`` must be None: the validation loss is not
    ported yet.
    """
    if val_dataset is not None:
      raise NotImplementedError('the validation loss is not ported yet')
    if train_dataset.target_interactions_matrix is not None:
      raise NotImplementedError('training against a target matrix is not '
                                'ported yet')
    if slab_cache is False:
      raise ValueError('the port trains from the resident slab only')
    if num_sampling_users == 0:
      num_sampling_users = batch_size
    log.info('device %s; model %s; lr %s; weight decay %s; batch %s; '
             'optimizer %s; loss %s; lr milestones %s', self.device,
             self.model.model_params(), lr, weight_decay, batch_size,
             self.optimizer_type, self.loss, lr_milestones)

    self._init_training(train_dataset, lr, weight_decay)
    source = self._data_source(train_dataset.interactions_matrix,
                               batch_size, num_sampling_users, shuffle)
    source.maybe_cache_slabs(self.model.num_items_padded, request=slab_cache)

    num_batches = source.steps_per_epoch
    if iters_per_epoch is None:
      iters_per_epoch = num_batches
    # a partly consumed epoch carries over only into a call with the
    # same dataset and batching
    iter_key = (train_dataset, batch_size, num_sampling_users,
                negative_sampling, shuffle)
    if self._train_iterator_key != iter_key:
      self._epoch_perm = None
      self._iters_consumed = 0
      self._train_iterator_key = iter_key

    for epoch in range(self.current_epoch, num_epochs + 1):
      self.current_epoch = epoch
      epoch_lr = _multistep_lr(lr, lr_milestones, epoch)
      for group in self.optimizer.param_groups:
        group['lr'] = epoch_lr
      if self._epoch_perm is None or self._iters_consumed >= num_batches:
        gen = torch.Generator().manual_seed(((self.seed + 1) << 32) + epoch)
        self._epoch_perm = source.epoch_permutation(gen)
        self._iters_consumed = 0
      n_steps = min(iters_per_epoch, num_batches - self._iters_consumed)

      t0 = time.time()
      losses = []
      for _ in range(n_steps):
        batch = source.build_fd_batch(self._epoch_perm, self._iters_consumed)
        self._iters_consumed += 1
        losses.append(self._dense_step_math(batch, negative_sampling))
        self._global_step += 1
      # one device sync per epoch
      self.last_epoch_losses = (torch.stack(losses).tolist()
                                if losses else [])
      dt = self.last_epoch_seconds = time.time() - t0
      mean_loss = (float(np.mean(self.last_epoch_losses))
                   if losses else float('nan'))
      log.info('Epoch %d/%d (lr=%g) [%d it, %.2fs, %.1f it/s] loss=%.5f',
               epoch, num_epochs, epoch_lr, n_steps, dt,
               n_steps / max(dt, 1e-9), mean_loss)

  # ------------------------------------------------------------------
  # inference / evaluation
  # ------------------------------------------------------------------

  def _densify(self, users_interactions):
    """Dense ``[B, num_items_padded]`` float32 input on the device."""
    m = users_interactions.interactions_matrix.tocsr()
    B = m.shape[0]
    if B == 0:
      raise ValueError('cannot score an empty user batch')
    rows = np.repeat(np.arange(B, dtype=np.int64), np.diff(m.indptr))
    dense = torch.zeros((B, self.model.num_items_padded), device=self.device)
    dense.index_put_(
        (torch.from_numpy(rows).to(self.device),
         torch.from_numpy(m.indices.astype(np.int64)).to(self.device)),
        torch.from_numpy(m.data.astype(np.float32)).to(self.device),
        accumulate=True)
    return dense

  def predict(self, users_interactions, return_input=False):
    """Full-catalog scores for a batch of users, as numpy trimmed to
    the logical ``num_items`` columns; ``(scores, input)`` when
    ``return_input``."""
    if not self._model_initialized:
      raise RuntimeError('Model not initialized.')
    with torch.no_grad():
      dense = self._densify(users_interactions)
      out = self.model(dense)
    out = out[:, :self.num_items].cpu().numpy()
    if return_input:
      return out, dense[:, :self.num_items].cpu().numpy()
    return out

  def recommend(self, users_interactions, num_recommendations):
    """Top-k item ids per user, excluding each user's seen items."""
    if not self._model_initialized:
      raise RuntimeError('Model not initialized.')
    with torch.no_grad():
      dense = self._densify(users_interactions)
      out = self.model(dense)
      out = out.masked_fill(dense > 0, float('-inf'))
      out[:, self.model.num_items:] = float('-inf')
      _, top_idx = torch.topk(out, num_recommendations, dim=1)
    return top_idx.cpu().numpy().tolist()

  def _evaluate(self, eval_dataset, num_recommendations, metrics,
                batch_size=1, num_users=None):
    if not self._model_initialized:
      raise RuntimeError('Model not initialized')
    recommender = InferenceRecommender(self, num_recommendations)
    evaluator = RecommenderEvaluator(recommender, metrics)
    return evaluator.evaluate(eval_dataset, batch_size=batch_size,
                              num_users=num_users)

  def evaluate(self, eval_dataset, num_recommendations, metrics,
               batch_size=1, num_users=None):
    """Evaluate on a dataset; logs the mean of each metric."""
    results = self._evaluate(eval_dataset, num_recommendations, metrics,
                             batch_size=batch_size, num_users=num_users)
    for metric in results:
      log.info('%s: %s', metric, np.mean(results[metric]))
    return results

  # ------------------------------------------------------------------
  # checkpointing
  # ------------------------------------------------------------------

  def save_state(self, model_checkpoint_prefix):
    """Write ``{prefix}_epoch_{N}.model`` in the JAX package's npz
    format; returns its path."""
    checkpoint_file = (f'{model_checkpoint_prefix}_epoch_'
                       f'{self.current_epoch}.model')
    log.info('Saving model to %s', checkpoint_file)
    meta = {
        'recoder_version': __version__,
        'model_class': type(self.model).__name__,
        'model_params': self.model.model_params(),
        'model_sparse': False,
        'last_epoch': self.current_epoch,
        'optimizer_type': self.optimizer_type,
        'num_items': self.num_items,
        'num_users': self.num_users,
        'global_step': self._global_step,
    }
    if isinstance(self.loss, str):
      meta['loss'] = self.loss
      meta['loss_params'] = self.loss_params

    named = self.model.params()
    arrays = {'model': convert.params_to_numpy(named)}
    if self.optimizer is not None:
      arrays['optimizer'] = convert.opt_state_to_numpy(
          self.optimizer, named, self.optimizer_type,
          sgd_step=self._global_step)
    if self.items is not None:
      arrays['items'] = np.asarray(self.items)
    if self.users is not None:
      arrays['users'] = np.asarray(self.users)
    save_checkpoint(checkpoint_file, arrays, meta)
    return checkpoint_file

  def init_from_model_file(self, model_file):
    """Restore model, optimizer and training state from an npz
    checkpoint written by this package or by the JAX package."""
    log.info('Loading model from: %s', model_file)
    if not os.path.isfile(model_file):
      raise FileNotFoundError(f'No state file found in {model_file}')
    arrays, meta = load_checkpoint(model_file)
    if meta.get('model_sparse'):
      raise NotImplementedError('sparse-table checkpoints are not ported '
                                'yet')

    self.current_epoch = meta['last_epoch']
    self._global_step = meta.get('global_step', 0)
    self.loss = meta.get('loss', self.loss)
    self.loss_params = meta.get('loss_params', self.loss_params)
    self.optimizer_type = meta['optimizer_type']
    self.num_items = meta.get('num_items')
    self.num_users = meta.get('num_users')
    self.items = arrays.get('items')
    self.users = arrays.get('users')
    self._pending_opt_arrays = arrays.get('optimizer')

    self.model.load_model_params(meta['model_params'])
    self._init_model()
    with torch.no_grad():
      for name, p in self.model.params().items():
        p.copy_(torch.from_numpy(
            _checked_array(f'model/{name}', p, arrays['model'][name])))
