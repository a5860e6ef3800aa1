"""The Recoder trainer: train / evaluate / predict / recommend / checkpoint.

Port of ``recoder_tpu/model.py``'s training paths for the autoencoder
and the serving path they need. A negative-sampling step takes one of
three paths (``train(full_decode=...)``, the JAX rule):

  * **full decode**: the step fetches ``batch_size`` rows of the
    resident dense slab (``data/device_pipeline.py``) -- or, where no
    slab is resident, scatters its triplets at the catalog width --
    encodes them with one matmul and decodes against the WHOLE decoder
    table; the loss is masked to the columns the mega-batch touched
    (``any(slab != 0)`` over its rows) and the random negatives, and to
    the logical catalog, summed, and divided by the number of valid
    users (JAX ``_forward_loss``, full-decode branch);
  * **dense union**: the step densifies its interactions over the
    mega-batch's item union, gathers the union's table rows with
    ``index_select`` (whose backward scatters into the whole tables) and
    every parameter takes a ``torch.optim`` step;
  * **sparse** (``DynamicAutoencoder(sparse=True)``): the union rows of
    the embedding tables are gathered as leaves, the dense optimizer
    steps the other parameters, and row-sparse Adam (``optim.py``
    ``SparseRowAdam``) updates the touched rows of each table and its
    moments, written back in place through the row-scatter kernel
    (JAX ``_sparse_step_math``). Without negative sampling the sparse
    step takes the full-decode batch: the whole tables are the leaves,
    and row-sparse Adam updates every row in place (``ids=None``, no
    row scatter), as the JAX step does with ``in_items`` None.

For 'mse' and 'logistic' the decode and the loss are one fused CUDA
kernel (``ops/fused_decode_loss.py``), over the whole table or the
union's rows; 'logloss' and custom ``Loss`` instances decode with a
matmul and take the loss from ``ops/losses.py``, as in JAX. Adam and the
other optimizers are ``torch.optim`` with the JAX package's rules
(``optim.py``); MultiStepLR(gamma=0.1) keeps the reference's epoch-start
quirk, and ``train`` resumes from ``current_epoch`` inclusive.
``recommend`` scores the full catalog, sets seen items and pad columns
to -inf and takes the top-k in ``lax.top_k``'s order (``ops/topk.py``:
values descending, ties by lowest index). With ``eval_item_chunk`` (or
past ``AUTO_CHUNK_ITEMS`` items) it encodes the batch once from its COO
interactions and scores the catalog one slice of ``chunk`` items at a
time, merging a running top-k, in ``O(B x chunk)`` memory; the
validation loss of a full-catalog batch streams the same slices.
``recommend_async`` returns the device tensor of ids without waiting for
the card, and the evaluator keeps a few batches in flight through it. Checkpoints are npz files in
the JAX package's format, sparse ones included.

bench.py's ML-20M default runs here too: a model with
``compute_dtype='bfloat16'`` densifies its batches in bf16, hands the
slab to the encoder as stored and trains through the bf16 variant of
the fused kernel; ``opt_state_dtype='bfloat16'`` stores Adam's moments
in bf16 (``optim.Bf16Adam``, the fused kernel ``kernels/adam.cu``).
``eval_compute_dtype`` sets the dtype of ``predict`` / ``recommend``
alone.

Any model written to the :class:`FactorizationModel` contract trains
and scores here: a model with ``fused_decode`` (``DynamicAutoencoder``,
``MatrixFactorization``) trains through its ``decode_operands`` and
takes the routes above; every other model (``MultVAE``) is called as ``model(input,
input_users=..., input_items=..., target_items=..., generator=...,
training=...)`` -- with sparse tables, ``model.apply_gathered(gathered,
input, ...)`` -- and its scores go through the trainer's loss with the
same row and column masks (JAX ``_forward_loss``). A model with
``has_aux`` also gets the global step and returns a per-user aux loss in
training (Mult-VAE's annealed KL). The batch's user ids reach the model
in training, ``predict`` and ``recommend``.

``train(fused_steps_per_call=N)`` is the port's form of the JAX scan
over consecutive fused steps: on the card, N steps are one captured CUDA
graph, replayed once per N steps, with the same arithmetic as N eager
steps (bitwise). The steps are those the JAX ``table_step`` scans: every
'blocks' step of the on-device source (full decode, the dense and the
sparse union steps over static-width unions, target training on the dual
CSRs, random negatives, the triplet scatter, the full-catalog sparse
step), full decode off the resident slab, and the 'users' union, sparse
and triplet-scatter steps where the source builds per-epoch tables (the
JAX ``users_precompute`` gate: no random negatives, the tables within
its budget). Such a step reads nothing from the host: its batch comes
from device tables at a device step counter, its valid-user count and
valid union width are device scalars, the optimizers' scalars and step
counts live on the device, and its losses go to a device buffer fetched
once an epoch. The other 'users' steps and the host loader's run
eagerly: they read the host, and the JAX trainer runs them one step a
call too. ``train`` also writes checkpoints
every ``checkpoint_freq`` epochs, paints a progress bar and records a
profiler window, as the JAX ``train`` does, and
``reset_training_state`` restarts a trainer in place.

Randomness comes from explicit generators: the init from a CPU
generator seeded with ``seed``, each epoch's order from the data source
(numpy ``default_rng([seed + 1, epoch])`` in 'users' mode, as the JAX
package; a CPU ``torch.Generator`` in 'blocks' mode), the dropout from a
generator on the device: seeded with ``(seed, global step)`` before each
step, except in the device-counter steps on the card, which draw from
one stream that each epoch places at the global step's offset in the
step's layout (graph replays advance it as eager steps do).

A training dataset with a target matrix trains against it: in 'blocks'
mode with negative sampling from the dual CSRs of the on-device source
(union batches with a target union beside the input's), otherwise, and
where that source declines the target matrix, from the host loader
(``data/loader.py``), as in JAX. Host-loader batches are collated and
copied to the card on a side stream by a background thread
(:meth:`Recoder._device_batch_iter`).
``train(val_dataset=..., eval_freq=N)`` computes the validation loss
every N epochs (the no-grad forward over the host loader's batches of
the validation set) and, with ``metrics``, the ranking metrics.

Every path takes the reference's negative-sampling knobs:
``num_sampling_users`` (a mega-batch of users sharing one item union,
sliced into compute batches) and ``num_random_negatives`` (uniform-random
extra negative items a step, drawn for the global step: a resumed run
draws what the uninterrupted one drew).

bf16 parameter storage (a model built with ``params_dtype='bfloat16'``)
trains on every path -- the captured full-decode step, the union,
sparse, triplet-scatter and full-catalog sparse steps -- with the
optimizer's math in float32 and each stored buffer rounded once
(``optim.py``); ``opt_state_dtype='bfloat16'`` gives the sparse tables
bf16 moments too. ``train`` refuses other float parameter dtypes, as the
JAX package does. A float32 checkpoint loads into a bf16 model rounded to
nearest even (``init_from_model_file``), which then serves from bf16
tables.

``Recoder(mesh=...)`` trains DynamicAutoencoder, MatrixFactorization and
MultVAE on a ('data', 'model') mesh of processes
(``recoder_tpu_torch.parallel``): each rank builds the whole batch,
computes its users' rows against its rows of the item (and user)
tables, and the shares are added over the mesh's process groups
(:meth:`Recoder._forward_loss`); scoring and checkpoints gather the
shares. ``train(table_sharding=...)`` splits the 'blocks' tables and the
CSR of the on-device source over 'data' (``data/device_pipeline.py``).

``save_state(backend='orbax')`` writes the JAX package's async, atomic
directory checkpoint in PyTorch's DCP format
(``recoder_tpu_torch.checkpoint_orbax``). The JAX
package's count-certified top-k (``eval_topk='exact'``) is a TPU
workaround and is not ported: every ``eval_topk`` mode is exact here.
"""

import collections
import contextlib
import gc
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from recoder_tpu_torch import __version__, convert, trace
from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.checkpoint import (flatten_tree, load_checkpoint,
                                          save_checkpoint, unflatten_tree)
from recoder_tpu_torch.checkpoint_orbax import (is_orbax_checkpoint,
                                                load_checkpoint_orbax,
                                                save_checkpoint_orbax,
                                                wait_for_pending_saves)
from recoder_tpu_torch.data.dataset import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import (
    DeviceDataSource, FusedPipelineUnavailable, canonical_csr)
from recoder_tpu_torch.data.loader import RecommendationDataLoader
from recoder_tpu_torch.metrics import RecommenderEvaluator
from recoder_tpu_torch.models.base import FactorizationModel
from recoder_tpu_torch.ops import losses as losses_lib
from recoder_tpu_torch.ops.fused_decode_loss import (fused_decode_loss,
                                                     supported)
from recoder_tpu_torch.ops.gather_matmul import as_dtype, working_copies
from recoder_tpu_torch.ops.topk import MODES as topk_modes
from recoder_tpu_torch.ops.topk import merge_top_k, top_k
from recoder_tpu_torch.optim import (KINDS, Bf16Adam, SparseRowAdam,
                                     fold_dual_union, make_optimizer,
                                     resolve_state_dtype, set_lr)
from recoder_tpu_torch.parallel import collectives
from recoder_tpu_torch.parallel import sharding as sharding_lib
from recoder_tpu_torch.progress import ProgressReporter, loss_handle
from recoder_tpu_torch.recommender import InferenceRecommender

log = logging.getLogger('recoder_tpu_torch')
if not log.handlers:
  _h = logging.StreamHandler()
  _h.setFormatter(logging.Formatter('%(asctime)s %(levelname)s %(message)s'))
  log.addHandler(_h)
  log.setLevel(logging.INFO)


#: full-decode steps a dispatch under fused_steps_per_call='auto' when the
#: step fetches from the resident slab or runs in 'blocks' mode (the JAX
#: rule)
AUTO_STEPS_PER_CALL = 16
#: real training steps run eagerly on the capture stream before the first
#: graph of a configuration is recorded (lazy state, plans, workspaces)
WARMUP_STEPS = 3
#: width signatures of the 'users' epoch tables whose graphs are kept
GRAPH_SETS = 4
#: ``_train_iterator_key`` after a checkpoint load: the next ``train``
#: continues the checkpoint's epoch at its recorded step
_RESUMED = object()
#: the losses a 'model'-split catalog computes column by column
#: (logloss's normalizer is reduced over the mesh); any other ``Loss``
#: sees the whole score matrix, gathered over 'model'
SPLIT_LOSSES = (losses_lib.MSELoss, losses_lib.LogisticLoss,
                losses_lib.MultinomialNLLLoss)


class _DeviceLoop:
  """The device state an epoch of device-counter steps (full decode, or
  the static 'blocks' union batches) reads and writes: the epoch
  order, the step within the epoch and the global step (device counters
  that each step advances, so that a graph replays the next steps: the
  global step is the aux hook's ``step``), and one loss a step."""

  def __init__(self, source, perm_len, num_batches):
    dev = source.device
    self.source = source
    self.perm = torch.zeros(perm_len, dtype=torch.int64, device=dev)
    self.step = torch.zeros((), dtype=torch.int64, device=dev)
    self.global_step = torch.zeros((), dtype=torch.int64, device=dev)
    self.losses = torch.zeros(num_batches, dtype=torch.float32, device=dev)
    #: Philox offset one step's noise draws take (on the card), by layout
    #: (full decode's; a static union's, by the width signature of the
    #: source's 'users' tables)
    self.noise_inc = {}


def _canonical_dataset(dataset):
  """``dataset``, or a copy whose matrices have no repeated entries (each
  repeat summed into one, as the JAX ``_densify`` adds them): the host
  loader's batches then densify without accumulation."""
  matrices = (dataset.interactions_matrix,
              dataset.target_interactions_matrix)
  if all(m is None or m.has_canonical_format for m in matrices):
    return dataset
  return RecommendationDataset(*(m if m is None else canonical_csr(m)
                                 for m in matrices))


def _multistep_lr(base_lr, milestones, epoch, gamma=0.1):
  """LR for 1-based ``epoch`` under the reference's scheduler stepping:
  during epoch ``e`` the decay counts milestones <= e - 1."""
  if not milestones:
    return base_lr
  count = sum(1 for m in milestones if m <= epoch - 1)
  return base_lr * (gamma ** count)


def _merge_ids(known, new):
  """``np.unique(np.append(known, new))``, the JAX ``_init_training``'s
  union of the item (user) ids seen. Each ``train`` call of one dataset
  passes the ids already known: where ``known`` is sorted and unique and
  ``new`` equals it, the union is ``known`` itself and the sort (~1.1 s
  at a 10,000,000-item catalog, every call) is skipped."""
  new = np.asarray(new)
  if np.array_equal(known, new) and np.all(known[1:] > known[:-1]):
    return known
  return np.unique(np.append(known, new))


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
    use_cuda (bool): the reference's switch, accepted and ignored (as
      in the JAX package): ``device`` places the trainer.
    user_based / item_based (bool): consistency checks between the model
      and datasets.
    seed (int): seed of the init, permutation and dropout generators.
    mesh (parallel.mesh.Mesh, optional): a ('data', 'model') mesh from
      :func:`recoder_tpu_torch.parallel.make_mesh`, one process a rank.
      Every rank runs the same program over the same data and builds the
      same global batch; each computes the step for its 'data' slice of
      the batch's users against its 'model' share of the item (and user)
      tables' rows, and the shares are added over the mesh (NCCL on the
      card, gloo on the CPU). The result is the single-device run's: a
      (1, 1) mesh gives it bitwise. DynamicAutoencoder,
      MatrixFactorization and MultVAE train on a mesh (a model whose
      ``supports_mesh`` is False, which takes no ``shard``, raises
      ValueError); a ``Loss`` instance other than the built-in ones sees
      the whole ``[B, W]`` scores, gathered over 'model'. The trainer
      runs on the mesh's device.
    eval_item_chunk (int, optional): score the catalog in contiguous
      slices of this many items in ``recommend`` / evaluation (and the
      validation loss of full-catalog batches) instead of one ``[B,
      num_items]`` matrix, carrying a running top-k: memory ``O(B x
      chunk)``. Chunks of ``AUTO_CHUNK_WIDTH`` are taken by default
      past ``AUTO_CHUNK_ITEMS`` padded items; 0 forces one matrix.
    eval_compute_dtype (str, optional): the products' dtype of
      ``predict`` / ``recommend`` / evaluation alone (None: the model's).
    eval_topk (str): the JAX package's top-k mode, 'exact' | 'sort' |
      'approx'. Every mode is the exact ``lax.top_k`` here
      (``ops/topk.py``): the JAX 'exact' path is a TPU workaround, and
      'approx' is exact on every backend but the TPU.
    opt_state_dtype (str, optional): storage dtype of the optimizer's
      moments; 'bfloat16' (adam only: the other kinds raise ValueError)
      stores them in bf16 with float32 math. None keeps float32 state
      (``torch.optim``). It wins over a checkpoint's moments on load.
    device (keyword only; the port's): where the model, the slab and
      every step live: the card ('cuda') unless the caller asks for
      'cpu'.
  """

  #: padded catalog width past which ``recommend`` and the validation
  #: loss score in chunks of ``AUTO_CHUNK_WIDTH`` items by default (the
  #: JAX package's threshold)
  AUTO_CHUNK_ITEMS = 2 ** 21
  AUTO_CHUNK_WIDTH = 2 ** 18

  def __init__(self, model: FactorizationModel, num_items=None,
               num_users=None, optimizer_type='sgd', loss='mse',
               loss_params=None, use_cuda=False, user_based=True,
               item_based=True, seed=42, mesh=None, eval_item_chunk=None,
               eval_compute_dtype=None, eval_topk='exact',
               opt_state_dtype=None, *, device=device_lib.DEFAULT):
    del use_cuda
    if mesh is not None and not model.supports_mesh:
      raise ValueError(
          f'{type(model).__name__} cannot train on a mesh: a mesh rank '
          'computes its share through the model (supports_mesh, shard=)')
    if optimizer_type not in KINDS:
      raise ValueError(f'Unknown optimizer kind {optimizer_type}')
    resolve_state_dtype(optimizer_type, opt_state_dtype)
    self.opt_state_dtype = opt_state_dtype
    self.eval_item_chunk = eval_item_chunk
    self.eval_compute_dtype = as_dtype(eval_compute_dtype)
    if eval_topk not in topk_modes:
      raise ValueError(f"unknown top-k mode {eval_topk!r}; "
                       "choose 'exact' | 'sort' | 'approx'")
    self.eval_topk = eval_topk
    self.model = model
    self.num_items = num_items
    self.num_users = num_users
    self.optimizer_type = optimizer_type
    self.loss = loss
    self.loss_params = loss_params if loss_params else {}
    self.user_based = user_based
    self.item_based = item_based
    self.seed = seed
    self.mesh = mesh
    self.device = device_lib.resolve(device if mesh is None else mesh.device)
    if mesh is not None and torch.device(device).type != self.device.type:
      raise ValueError(f'device {device!r} differs from the mesh\'s '
                       f'{mesh.device}')

    self.optimizer = None
    self.sparse_adam = SparseRowAdam()
    #: {table name: {'step', 'm', 'v'}} of the row-sparse Adam
    self.sparse_states = {}
    self.current_epoch = 1
    self.items = None
    self.users = None
    self.loss_module = None
    #: per-step training losses of the last epoch, fetched at its end
    self.last_epoch_losses = []
    #: wall seconds of the last epoch's steps, up to that fetch
    self.last_epoch_seconds = 0.0

    self._model_initialized = False
    #: on a mesh: the whole row count of each 'model'-split parameter
    self._whole_rows = {}
    self._pending_opt_arrays = None
    self._global_step = 0
    self._source_cache = None
    self._epoch_perm = None
    self._iters_consumed = 0
    self._train_iterator_key = None
    #: the host loader's persistent batch iterator (``_device_batch_iter``)
    self._train_iterator = None
    self._copy_stream = None
    self._dropout_gen = torch.Generator(device=self.device)
    self._lr = None  # this epoch's learning rate
    self._opt_config = None
    self._device_loop = None
    #: captured steps: {steps a graph: (graph, tensors it keeps)}, of the
    #: current width signature of the source's tables
    self._graphs = {}
    self._graph_sig = None
    self._warm_steps = 0
    self._graph_widths = None  # that signature
    #: the other signatures' (graphs, warm-up steps), oldest first
    self._parked = collections.OrderedDict()
    self._warm_key = None  # (loop, path) of the warm-up steps
    self._capture_stream = None
    #: CUDA graphs captured over the trainer's life
    self.captures = 0
    self._profiler = None
    self._progress_reporter = None
    #: how the last epoch's steps were dispatched, and how many
    #: dispatches (graph replays and eager steps) it took
    self.last_epoch_dispatch = None
    self.last_epoch_dispatches = 0

  # ------------------------------------------------------------------
  # initialization
  # ------------------------------------------------------------------

  def _init_model(self):
    if self._model_initialized:
      return
    self.model.init_model(self.num_items, self.num_users, seed=self.seed)
    self._shard_model()
    self.model.to(self.device)
    self._model_initialized = True

  def _shard_model(self):
    """On a mesh: keep this rank's rows of each 'model'-split parameter
    of the freshly initialized (whole, host) model; the init is the
    single-device one, drawn whole on the host."""
    if self.mesh is None:
      return
    whole = self.model.params()
    self._whole_rows = {path: whole[path].shape[0]
                        for path in sharding_lib.sharded_paths(self.model)}
    self.model.register_params(
        {k: v.detach().clone() if k in self._whole_rows else v.detach()
         for k, v in sharding_lib.shard_params(whole, self.model,
                                               self.mesh).items()})

  def _partition(self, num_rows):
    """This rank's share of a batch of ``num_rows`` users (a mesh's)."""
    return sharding_lib.Partition(self.mesh, self.model, num_rows)

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

  def _split_params(self):
    """``({name: parameter} the dense optimizer steps, sparse table
    names)``."""
    sparse = tuple(sorted(self.model.sparse_param_paths()))
    dense = {k: v for k, v in self.model.params().items() if k not in sparse}
    return dense, sparse

  def _state_dtype(self):
    return resolve_state_dtype(self.optimizer_type, self.opt_state_dtype)

  def _init_optimizer(self, lr, weight_decay):
    named, sparse_paths = self._split_params()
    if sparse_paths and self.optimizer_type != 'adam':
      raise ValueError('Sparse gradients optimization only supported '
                       'with adam (sparse row-wise Adam)')
    if self.sparse_adam.state_dtype != self._state_dtype():
      # (the same dtype keeps it: its device table is what graphs read)
      self.sparse_adam = SparseRowAdam(state_dtype=self.opt_state_dtype)
    prev = self.optimizer
    config = (self.optimizer_type, self._state_dtype(), float(weight_decay),
              tuple(named.values()))
    same = (prev is not None and self._pending_opt_arrays is None
            and self._opt_config is not None
            and self._opt_config[:3] == config[:3]
            and len(self._opt_config[3]) == len(config[3])
            and all(a is b for a, b in zip(self._opt_config[3], config[3])))
    if not same:
      # (the same parameters and hyper-parameters keep the optimizer, its
      # device scalars and the graphs that recorded its step)
      self._drop_graphs()
      self.optimizer = self._make_optimizer(named, lr, weight_decay)
      self._opt_config = config
      if prev is not None:
        if type(prev) is type(self.optimizer):
          # continued training on the same instance keeps the moments,
          # cast to the new optimizer's state dtype (the JAX package's
          # cast of carried moments: a no-op unless opt_state_dtype
          # changed)
          self.optimizer.state.update(prev.state)
          self._cast_moments(self.optimizer)
        else:
          log.warning('optimizer type changed; optimizer state reset')
    tables = self.model.params()
    dtype = self.sparse_adam.state_dtype
    carried, self.sparse_states = self.sparse_states, {}
    for p in sparse_paths:
      st = carried.get(p)
      self.sparse_states[p] = (
          self.sparse_adam.init(tables[p]) if st is None else
          {**st, 'm': st['m'].to(dtype), 'v': st['v'].to(dtype)})
    if self._pending_opt_arrays is not None:
      tree, sparse = self._pending_opt_arrays
      self._pending_opt_arrays = None
      if not self._load_opt_arrays(named, tree, sparse, sparse_paths):
        # a checkpoint saved under the other sparse / dense split (as
        # the JAX package): the weights load, the moments restart
        self.optimizer = self._make_optimizer(named, lr, weight_decay)
        self.sparse_states = {p: self.sparse_adam.init(tables[p])
                              for p in sparse_paths}
        log.warning('checkpoint optimizer state does not match this '
                    "model's sparse/dense split; optimizer state reset")

  @staticmethod
  def _cast_moments(optimizer):
    """Cast carried Adam moments to ``optimizer``'s state dtype (bf16 or
    float32 for :class:`Bf16Adam`, float32 for ``torch.optim.Adam``)."""
    dtype = getattr(optimizer, 'state_dtype', torch.float32)
    for state in optimizer.state.values():
      for key in ('exp_avg', 'exp_avg_sq'):
        if key in state and state[key].dtype != dtype:
          state[key] = state[key].to(dtype)

  def _make_optimizer(self, named, lr, weight_decay):
    return make_optimizer(self.optimizer_type, named, lr, weight_decay,
                          self.opt_state_dtype,
                          capturable=self.device.type == 'cuda')

  def _load_opt_arrays(self, named, tree, sparse, sparse_paths):
    """Load checkpoint optimizer arrays; False when they belong to the
    other sparse / dense split of the model's parameters."""
    if tree is not None:
      keys = convert.STATE_KEYS[self.optimizer_type]
      if any(set(tree.get(k, {})) != set(named) for k in keys):
        return False
      tree = {k: ({n: convert.fit_table(f'optimizer/{k}/{n}',
                                        tuple(named[n].shape), a)
                   for n, a in v.items()} if isinstance(v, dict) else v)
              for k, v in tree.items()}
      convert.opt_state_into_torch(self.optimizer, named, tree,
                                   self.optimizer_type, self._state_dtype())
    tables = self.model.params()
    for p in sparse_paths:
      if p in sparse:
        self.sparse_states[p] = convert.sparse_state_from_numpy(
            sparse[p], tables[p], self.sparse_adam.state_dtype)
    return True

  def _init_training(self, train_dataset, lr, weight_decay):
    if self.items is None:
      self.items = np.asarray(train_dataset.items)
    else:
      self.items = _merge_ids(self.items, train_dataset.items)
    if self.users is None:
      self.users = np.asarray(train_dataset.users)
    else:
      self.users = _merge_ids(self.users, train_dataset.users)

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
    # float32 is the reference trajectory and bf16 storage a
    # quality-gated training mode (the optimizer's math stays float32);
    # anything else (float16 would need loss scaling) is refused, with
    # the JAX package's message
    params = self.model.params()
    bad = [p for p, v in params.items() if v.is_floating_point()
           and v.dtype not in (torch.float32, torch.bfloat16)]
    if bad:
      raise ValueError(
          f'training requires float32 or bfloat16 params; {bad[:3]} are '
          f'{str(params[bad[0]].dtype).removeprefix("torch.")}')
    self._lr = lr
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
                    generator=None, gathered=None, step=None):
    """Loss of one batch: the masked sum over its loss columns, divided
    by the number of valid users (the JAX ``_forward_loss``).

    A full-decode batch (``'slab'``) decodes the whole catalog and masks
    the loss to the columns the mega-batch touched (all of the logical
    catalog without ``negative_sampling``): its ``'col_mask'`` when it
    carries one (the packed tier's, a mega's wider than the batch, one
    with random negatives, the scatter's), else read off the rows. A COO batch
    (``'rows'``, ``'cols'``, ``'vals'``) densifies over its union
    (``'items'``), or over the padded catalog where ``'items'`` is None
    (a host-loader batch without negative sampling). It decodes against
    the target side (``'tg_*'``, densified the same way) when it has one,
    else against its input. Every column of a union is a loss column --
    of a static union, those before its ``'width_valid'`` -- and of the
    padded catalog, the logical items. ``gathered``: the sparse
    step's table rows (``sparse_entries`` names). The batch's user ids
    (``'users'``) reach the model as ``input_users``. A model without
    ``fused_decode`` scores through its ``forward`` (or, with
    ``gathered``, its ``apply_gathered``) and ``loss_module``.

    The aux-loss hook (the JAX ``has_aux``): in training, a model with
    ``has_aux`` is called with ``step`` (the global step, a 0-dim tensor)
    and returns ``(scores, aux [B])``; ``sum(aux * row_mask)`` joins the
    loss before the division by the valid users.

    On a mesh the batch is the whole one (every rank built it), and so
    are the operands and the column mask built from it (the mega's
    columns read off every user's row). The rank then takes its share
    -- its users' rows, and of a split catalog its columns (a union: the
    columns whose rows it holds; the whole catalog: its column range) --
    scores through the model with ``shard``, and adds its loss sum over
    the mesh. The aux loss (the KL of Mult-VAE, every 'model' rank's for
    its users) is added over 'data' alone, so that it counts once, while
    each rank's backward still reads it. A custom ``Loss`` over a split
    catalog sees the whole scores: the rank's columns gathered over
    'model' (a union's, whose other columns are zero, added), its
    backward taking the rank's columns' gradient; its sum, the same on
    every 'model' rank, is added over 'data'."""
    model, mesh = self.model, self.mesh
    cd = getattr(model, 'compute_dtype', None)
    valid_users = batch['num_users']
    if 'slab' in batch:
      # the slab's storage dtype holds every value exactly: the encoder
      # takes it in the compute dtype (as stored when that is bf16), the
      # fused kernel reads it as it is
      slab = target = batch['slab']
      input_dense = slab.to(cd or torch.float32)
      B, W = input_dense.shape
      in_catalog = torch.arange(W, device=slab.device) < model.num_items
      if not negative_sampling:
        col_mask = in_catalog.float()
      elif 'col_mask' in batch:
        col_mask = batch['col_mask']
      else:
        # the loss columns: items any user of the batch touched
        col_mask = (torch.any(slab != 0, dim=0) & in_catalog).float()
      items = tg_items = None
    else:
      items = batch['items']
      B = batch['users'].shape[0]
      W = model.num_items_padded if items is None else items.shape[0]
      input_dense = target = self._densify_union(batch, B, W, cd)
      tg_items, side = items, ''
      if 'tg_rows' in batch:
        tg_items, side = batch['tg_items'], 'tg_'
        W = model.num_items_padded if tg_items is None else tg_items.shape[0]
        target = self._densify_union(batch, B, W, cd, side='tg_')
      # (a static union's columns at or past its valid width are the
      # sentinel's: masked, as the JAX ``in_valid_width``)
      logical = (model.num_items if tg_items is None
                 else batch.get(side + 'width_valid', W))
      col_mask = (torch.arange(W, device=target.device) < logical).float()
    if mesh is None:
      part, shard, add = None, {}, lambda x, group: x
      row_mask = (torch.arange(B, device=input_dense.device)
                  < valid_users).float()
    else:
      part = self._partition(B)
      shard, add = {'shard': part}, collectives.sum_forward
      input_dense, target = part.rows(input_dense), part.rows(target)
      whole_target, whole_mask = target, col_mask
      if tg_items is None:
        # (the rank's column range of the catalog)
        target, col_mask = part.columns(target), part.columns(col_mask)
      elif part.split:
        col_mask = col_mask * part.owned('item', tg_items).float()
      row_mask = part.row_mask(valid_users, input_dense.device)
    users = batch.get('users')
    if users is not None:
      users = users.to(input_dense.device)

    aux = None
    if getattr(model, 'fused_decode', False):
      h, rows, bias = model.decode_operands(
          input_dense, items, tg_items, gathered=gathered, training=training,
          generator=generator, input_users=users, **shard)
      kind = self._fused_kind()
      if kind is not None and W > 0:
        loss = fused_decode_loss(
            h, rows, bias, target, row_mask, col_mask, kind,
            getattr(self.loss_module, 'confidence', 0.0), cd)
        return add(loss, None) / valid_users
      # (an empty union has no column for the kernel: its loss is 0)
      scores = model.decode(h, rows, bias)
    else:
      has_aux = training and getattr(model, 'has_aux', False)
      kw = dict(input_users=users, input_items=items, target_items=tg_items,
                generator=generator, training=training, **shard,
                **({'step': step} if has_aux else {}))
      scores = (model(input_dense, **kw) if gathered is None
                else model.apply_gathered(gathered, input_dense, **kw))
      if has_aux:
        scores, aux = scores
    split = part is not None and part.split
    if split and not isinstance(self.loss_module, SPLIT_LOSSES):
      # (a custom loss: every 'model' rank computes it whole)
      group = mesh.model_group
      scores = (collectives.gather_columns_grad(
          scores, group, sharding_lib.split_sizes(W, mesh))
                if tg_items is None else collectives.sum_forward(scores, group))
      loss = add(self.loss_module(scores, whole_target, row_mask=row_mask,
                                  col_mask=whole_mask), mesh.data_group)
    elif split and isinstance(self.loss_module,
                              losses_lib.MultinomialNLLLoss):
      loss = add(torch.sum(losses_lib.multinomial_nll_loss(
          scores, target, row_mask, col_mask, group=mesh.model_group)), None)
    else:
      loss = add(self.loss_module(scores, target, row_mask=row_mask,
                                  col_mask=col_mask), None)
    if aux is not None:
      loss = loss + add(torch.sum(aux * row_mask),
                        None if mesh is None else mesh.data_group)
    return loss / valid_users

  @staticmethod
  def _densify_union(batch, B, W, dtype=None, side=''):
    """A COO batch's interactions (``side``: '' the input's, 'tg_' the
    target's) as a dense ``[B, W]`` matrix in ``dtype`` (float32 by
    default; the JAX ``_densify`` builds in the model's compute dtype).
    Each (row, column) pair occurs once: the batches come from canonical
    CSRs (the on-device source's, or the host loader's over
    :func:`_canonical_dataset`). A static batch's entries past its
    slice's nnz hold row ``B``: they land in a spare row that is cut
    off (the JAX ``mode='drop'``).

    The matrix is the ``[:B, :W]`` view of one whose rows are W rounded
    up to 8 elements long (the extra columns zero): a bf16 target of any
    W then has 16-byte rows, which the TMA-fed decode-loss kernels read
    where they stand (``ops/fused_decode_loss.bf16_route``)."""
    dtype = dtype or torch.float32
    rows = batch[side + 'rows']
    spare = int(side + 'width_valid' in batch)
    dense = torch.zeros((B + spare, -(-W // 8) * 8), device=rows.device,
                        dtype=dtype)
    dense.index_put_((rows, batch[side + 'cols']),
                     batch[side + 'vals'].to(dtype))
    return dense[:B, :W]

  def _step_tensor(self):
    """The global step as a 0-dim int64 tensor on the device: the aux
    hook's ``step`` of an eager union, sparse or host-loader step (None
    for a model without the hook)."""
    if not getattr(self.model, 'has_aux', False):
      return None
    return torch.tensor(self._global_step, device=self.device)

  def _working_copies(self):
    """The training step's bf16 products read the dense optimizer's
    working copies (``Bf16Adam.working_copy``), off a mesh: a mesh adds
    the gradients over 'data' in the parameters' dtype, float32."""
    if self.mesh is None and isinstance(self.optimizer, Bf16Adam):
      return working_copies(self.optimizer.working_copy)
    return contextlib.nullcontext()

  def _dense_step_math(self, batch, negative_sampling=True, reseed=True,
                       step=None):
    """One optimizer update; returns the step's loss (on the device).

    ``reseed`` seeds the dropout generator with ``(seed, global step)``
    first; a full-decode step on the card does not (see
    :meth:`_position_noise`), so that a captured graph can run it.
    ``step``: the global step as a device tensor (by default
    :meth:`_step_tensor`'s)."""
    if reseed:
      self._dropout_gen.manual_seed((self.seed << 32) + self._global_step)
    step = self._step_tensor() if step is None else step
    self.optimizer.zero_grad(set_to_none=True)
    with self._working_copies():
      loss = self._forward_loss(batch, training=True,
                                negative_sampling=negative_sampling,
                                generator=self._dropout_gen, step=step)
    loss.backward()
    if self.mesh is not None:
      collectives.all_reduce_grads(self.model.parameters(),
                                   self.mesh.data_group)
    self.optimizer.step()
    return loss.detach()

  def _sparse_step_math(self, batch, negative_sampling=True, reseed=True,
                        step=None):
    """One sparse-path update (the JAX ``_sparse_step_math``): gradients
    w.r.t. the gathered table rows, the dense optimizer on every other
    parameter, then row-sparse Adam writes the touched rows of each
    table and its moments in place. Returns the step's loss (on the
    device).

    A union batch gathers its union's rows. A full-decode batch (no
    ``'items'``: the full-catalog step, without negative sampling) takes
    each whole item table as its leaf, and row-sparse Adam then updates
    every row (``ids=None``: no row scatter). The user rows of a
    user-indexed table are the batch's users, its pad slots pointing at
    the sentinel row ``num_users``, whose moments then stay zero (the
    JAX redirect): a pad slot must not decay row 0's. A static union's
    sentinel slots gather the sentinel item's row, take zero gradients
    and leave it and its zero moments as they were. ``reseed`` and
    ``step`` as in :meth:`_dense_step_math`.

    On a mesh each rank gathers the rows it holds of the (whole batch's)
    ids, the other slots zeroed in the forward pass; the gradients of the
    leaves and of the dense parameters are added over 'data', and the
    rank's rows take the update (a slot another rank holds is skipped:
    ``Partition.localize``)."""
    model = self.model
    if reseed:
      self._dropout_gen.manual_seed((self.seed << 32) + self._global_step)
    step = self._step_tensor() if step is None else step
    items = batch.get('items')
    users = batch['users'].to(self.device)
    if getattr(model, 'num_users', None):
      valid = torch.arange(users.shape[0], device=self.device) \
          < batch['num_users']
      users = torch.where(valid, users, model.num_users)
    entries = model.sparse_entries(
        input_users=users, input_items=items,
        target_items=batch.get('tg_items', items))
    tables = model.params()
    part = None if self.mesh is None else self._partition(users.shape[0])
    with torch.no_grad():
      # (a whole table's leaf shares its storage: the backward pass is
      # over before the update writes it)
      gathered = {name: tables[path].detach() if ids is None
                  else tables[path].index_select(0, ids) if part is None
                  else tables[path].index_select(
                      0, part.localize(path, ids).clamp(min=0))
                  for name, path, ids in entries}
    for rows in gathered.values():
      rows.requires_grad_(True)
    used = gathered if part is None else {
        name: gathered[name] if ids is None
        else part.mask(gathered[name], part.owned(path, ids))
        for name, path, ids in entries}
    self.optimizer.zero_grad(set_to_none=True)
    with self._working_copies():
      loss = self._forward_loss(batch, training=True,
                                negative_sampling=negative_sampling,
                                generator=self._dropout_gen,
                                gathered=used, step=step)
    loss.backward()
    if part is not None:
      collectives.all_reduce_grads(
          [*self.model.parameters(), *gathered.values()],
          self.mesh.data_group)
    self.optimizer.step()
    uses = {}
    for name, path, ids in entries:
      grad = gathered[name].grad  # (None: no loss term reached the rows)
      uses.setdefault(path, []).append(
          (ids, grad if grad is not None else torch.zeros_like(
              gathered[name])))
    with torch.no_grad():
      # after the backward pass: no graph holds the tables
      for path, rows in uses.items():
        if len(rows) == 2:
          # a tied table over the input and the target union: one step
          # over the folded id set, the spare row the table's last pad row
          last = (tables[path].shape[0] if part is None
                  else part.total(path)) - 1
          ids, grads = fold_dual_union(*rows[0], *rows[1], last)
        else:
          (ids, grads), = rows
        if part is not None and ids is not None:
          ids = part.localize(path, ids)
        self.sparse_adam.update_rows(tables[path], self.sparse_states[path],
                                     ids, grads, self._lr)
    return loss.detach()

  # ------------------------------------------------------------------
  # training loop
  # ------------------------------------------------------------------

  def _data_source(self, matrix, batch_size, num_sampling_users, shuffle,
                   target=None, num_random_negatives=0,
                   table_sharding='auto'):
    cfg = (batch_size, num_sampling_users, shuffle, self.num_items,
           self.seed, num_random_negatives, table_sharding)
    cached = self._source_cache
    if (cached is not None and cached[0] is matrix and cached[1] == cfg
        and cached[3] is target):
      return cached[2]
    self._source_cache = None  # free the old slab before the new build
    source = DeviceDataSource(matrix, batch_size=batch_size,
                              num_sampling_users=num_sampling_users,
                              num_items=self.num_items, shuffle=shuffle,
                              device=self.device, seed=self.seed,
                              target_matrix=target,
                              num_random_negatives=num_random_negatives,
                              mesh=self.mesh, table_sharding=table_sharding)
    self._source_cache = (matrix, cfg, source, target)
    return source

  @trace.span('recoder.train')
  def train(self, train_dataset, val_dataset=None, lr=0.001,
            weight_decay=0, num_epochs=1, iters_per_epoch=None,
            batch_size=64, lr_milestones=None, negative_sampling=False,
            num_sampling_users=0, num_data_workers=0,
            model_checkpoint_prefix=None, checkpoint_freq=0, eval_freq=0,
            eval_num_recommendations=None, eval_num_users=None,
            metrics=None, eval_batch_size=None, profile_dir=None,
            profile_steps=(10, 30), shuffle='users', num_random_negatives=0,
            fused_steps_per_call='auto', progress=False, full_decode='auto',
            slab_cache='auto', table_sharding='auto'):
    """Train the model (argument semantics follow the JAX package's
    ``Recoder.train``).

    With ``negative_sampling`` a step's loss covers the items its
    mega-batch touched -- the ``num_sampling_users`` users (a multiple
    of ``batch_size``; 0: ``batch_size``) whose slices the next steps
    take -- and ``num_random_negatives`` uniform-random items drawn for
    the global step (they widen the union: zero input, zero target);
    without it the whole catalog (and random negatives raise
    ValueError, as in JAX). ``full_decode`` ('auto' | True | False),
    with negative sampling: decode against the whole item tables, or
    over the mega's item union (``DeviceDataSource.build_union_batch``);
    'auto' takes full decode when the padded catalog is at most 4x the
    union width (the JAX rule; the width counts the random negatives). A
    sparse model takes the union path with negative sampling. Without
    negative sampling every model decodes the full catalog (a sparse
    one eagerly, every table row a leaf). ``slab_cache`` picks the
    full-decode slab's tier
    (``DeviceDataSource.maybe_cache_slabs``): 'auto' takes the dense
    slab within half the device's free memory, else the bit-packed
    slab for binary data; True forces the dense tier, 'packed' the 1-bit
    tier, False none. Where no slab is resident (False, or where the
    JAX source declines both tiers: explicit zero values, over the
    budget) each full-decode step scatters its triplets at the catalog
    width, eagerly; a log line names the route and the reason.
    ``shuffle``: 'users' or 'blocks'.

    A ``train_dataset`` with a target matrix trains its input against
    its target (full decode stays off, as in JAX): with
    ``shuffle='blocks'`` and negative sampling from the dual CSRs of the
    on-device source (without random negatives), otherwise from the host
    loader (``RecommendationDataLoader``, seeded with ``seed``; its
    collation runs on ``num_data_workers`` threads), one eager step a
    batch.

    ``fused_steps_per_call`` ('auto' | int | None): consecutive steps a
    host dispatch. 'auto' and None take 16 for the steps that read only
    the device, else 1 (the JAX ``table_step`` rule). Those steps are
    every 'blocks' step of the on-device source (full decode, union,
    sparse, target, random-negative, triplet-scatter and full-catalog
    sparse), full decode off the resident slab, and with negative
    sampling the 'users' steps of a source that builds per-epoch tables
    (``DeviceDataSource.users_precompute``, the JAX gate: no random
    negatives, two epochs' tables within its byte budget): union, sparse
    and triplet-scatter steps over each epoch's tables, built on the
    device at the epoch's start. On the card, with Adam, a block of N >=
    2 of them is one captured CUDA graph, replayed once per N steps; the
    epoch's last steps, fewer than N, run as one-step graphs. The first
    steps of a configuration run eagerly on the capture stream before its
    first capture (they are real steps; a capture records and does not
    execute); each width signature of the 'users' tables keeps its own
    graphs (the last ``GRAPH_SETS``), so an epoch whose signature was
    seen replays without a capture. The arithmetic is the same as N =
    1's, one eager dispatch a step: the trajectories are bitwise equal.
    On the CPU the blocks run the same steps eagerly. The other 'users'
    steps and the host loader's read the host and run eagerly whatever N
    says, as do optimizers other than Adam (one log line says so). A
    build, capture or replay that fails raises; nothing falls back.

    ``model_checkpoint_prefix`` / ``checkpoint_freq``: ``save_state``
    after every ``checkpoint_freq``-th epoch and after the last.
    ``progress`` paints a per-step bar with the running loss from a
    background thread that never waits on the training stream
    (``progress.py``). ``profile_dir``: a torch.profiler trace (CPU and,
    on the card, CUDA activity) of global steps ``profile_steps =
    (start, stop)``, written there as a Chrome trace; profiling
    dispatches one step at a time.

    ``val_dataset`` with ``eval_freq > 0``: every ``eval_freq``-th epoch
    the epoch's log line gets the validation loss (:meth:`_validate`
    over a host loader of ``val_dataset`` with this call's batching and
    seed ``seed + 1``) and, with ``metrics`` and
    ``eval_num_recommendations``, the mean of each metric over
    ``eval_num_users`` users of ``val_dataset`` in batches of
    ``eval_batch_size`` (default ``batch_size``). Validation reads the
    parameters and nothing else of the training state: a run with it
    trains bitwise as one without.

    On a mesh every rank calls ``train`` with the same arguments and
    data: each builds the same batches (the resident CSR and slab are
    replicated) and trains its share of each step. The steps that are
    captured without a mesh are captured on an NCCL mesh too, the
    collectives inside the graphs; over gloo (which a graph cannot
    record) they run eagerly, and a log line says so.

    ``table_sharding`` ('auto' | 'data' | None), on a mesh in 'blocks'
    mode: 'data' splits the on-device source's block tables and CSR over
    the mesh's 'data' axis (each step's rows fetched by owner slice and
    one sum over 'data'; the slab then declines, and full decode
    scatters its triplets), 'auto' does so past the JAX byte budget on a
    mesh of more than one 'data' rank, and None (or any other value)
    keeps them replicated (``DeviceDataSource``).
    """
    with trace.span('recoder.prepare'):
      if full_decode not in ('auto', True, False):
        raise ValueError(f"full_decode={full_decode!r}: expected 'auto', "
                         'True or False')
      if num_sampling_users == 0:
        num_sampling_users = batch_size
      if num_sampling_users < batch_size or num_sampling_users % batch_size:
        raise ValueError('number of sampling users should be a multiple of '
                         'the batch size')
      if num_random_negatives and not negative_sampling:
        raise ValueError('num_random_negatives requires negative_sampling')
      if eval_batch_size is None:
        eval_batch_size = batch_size
      log.info('device %s; model %s; lr %s; weight decay %s; batch %s; '
               'optimizer %s; loss %s; lr milestones %s', self.device,
               self.model.model_params(), lr, weight_decay, batch_size,
               self.optimizer_type, self.loss, lr_milestones)

      self._init_training(train_dataset, lr, weight_decay)
      sparse = bool(self.model.sparse_param_paths())
      target = train_dataset.target_interactions_matrix
      loader_kw = dict(batch_size=batch_size,
                       negative_sampling=negative_sampling,
                       num_sampling_users=num_sampling_users,
                       num_workers=num_data_workers,
                       num_random_negatives=num_random_negatives)
      # the JAX rule: a target matrix rides the on-device source's dual
      # CSRs in 'blocks' mode with negative sampling and no random
      # negatives, else (and where the source declines it) the host loader
      loader = source = None
      fd = False
      if target is None or (shuffle == 'blocks' and negative_sampling
                            and not num_random_negatives):
        try:
          source = self._data_source(train_dataset.interactions_matrix,
                                     batch_size, num_sampling_users, shuffle,
                                     target, num_random_negatives,
                                     table_sharding)
        except FusedPipelineUnavailable as e:
          log.info('fused pipeline unavailable (%s); using host loader', e)
      if source is None:
        loader = RecommendationDataLoader(_canonical_dataset(train_dataset),
                                          seed=self.seed, **loader_kw)
        num_batches = len(loader)
      else:
        num_batches = source.steps_per_epoch
        if not negative_sampling:
          fd = True
        elif sparse or full_decode is False or target is not None:
          fd = False
        elif full_decode is True:
          fd = True
        else:
          fd = self.model.num_items_padded <= 4 * source.union_width()
        if fd:
          if source.maybe_cache_slabs(self.model.num_items_padded,
                                      request=slab_cache):
            log.info('full decode from the resident %s slab',
                     'packed' if source._slab_packed else 'dense')
          else:
            log.info('full decode through the per-step triplet scatter (%s)',
                     source.decline_reason or 'slab_cache=False')
        else:
          source.maybe_cache_slabs(0, request=False)
          source.prepare_union()
      validation = None
      if val_dataset is not None and eval_freq > 0:
        validation = (RecommendationDataLoader(_canonical_dataset(val_dataset),
                                               seed=self.seed + 1, **loader_kw),
                      eval_freq, metrics, eval_num_recommendations,
                      eval_num_users, eval_batch_size)

      # the steps that read nothing on the host (the JAX ``table_step``):
      # every 'blocks' step of the on-device source, full decode off the
      # resident slab, and the 'users' steps over per-epoch tables
      tables = (source is not None and shuffle == 'users' and negative_sampling
                and source.users_precompute)
      device_steps = source is not None and (
          shuffle == 'blocks' or (fd and source.d_slab is not None) or tables)
      if fused_steps_per_call in (None, 'auto'):
        spc = AUTO_STEPS_PER_CALL if device_steps else 1
      else:
        spc = max(1, int(fused_steps_per_call))
      if profile_dir is not None:
        spc = 1
      on_card = self.device.type == 'cuda'
      gloo = (self.mesh is not None
              and torch.distributed.get_backend() != 'nccl')
      captured = (device_steps and spc >= 2 and on_card
                  and self.optimizer_type == 'adam' and not gloo)
      if source is not None and negative_sampling and not device_steps:
        log.info("the 'users' %s steps run eagerly at their exact widths, one "
                 'dispatch a step: the JAX source builds no epoch tables for '
                 'them (%s), and its trainer does not scan them',
                 'triplet-scatter' if fd else 'union', source.precompute_reason)
      elif spc >= 2 and not device_steps:
        log.info('fused_steps_per_call=%d: the host-loader step runs eagerly, '
                 'one dispatch a step (it reads the host; the JAX trainer '
                 'runs it one step a call too)', spc)
      elif spc >= 2 and not on_card:
        log.info('fused_steps_per_call=%d: off the card the steps of a '
                 'dispatch run eagerly, one after another', spc)
      elif spc >= 2 and gloo:
        log.info('fused_steps_per_call=%d: the mesh runs over gloo, whose '
                 'collectives a CUDA graph cannot record; the steps run '
                 'eagerly, one dispatch a step', spc)
      elif spc >= 2 and not captured:
        log.info("fused_steps_per_call=%d: '%s' has no capturable step; the "
                 'steps run eagerly, one dispatch a step', spc,
                 self.optimizer_type)

      if iters_per_epoch is None:
        iters_per_epoch = num_batches
      # a partly consumed epoch carries over only into a call with the
      # same dataset, batching and path (or the first call after a
      # checkpoint load, which continues the checkpoint's epoch on the
      # on-device source; the host loader's restarts, as in JAX)
      iter_key = (train_dataset, batch_size, num_sampling_users,
                  negative_sampling, shuffle, num_random_negatives, fd,
                  loader is not None)
      if self._train_iterator_key != iter_key:
        if self._train_iterator_key is not _RESUMED:
          self._iters_consumed = 0
        self._epoch_perm = None
        self._drop_train_iterator()
        self._train_iterator_key = iter_key

    try:
      self._train_epochs(source, loader, fd, sparse, negative_sampling,
                         num_epochs, lr, lr_milestones, iters_per_epoch,
                         num_batches, spc, captured, profile_dir,
                         profile_steps, progress, model_checkpoint_prefix,
                         checkpoint_freq, validation, fd or device_steps,
                         tables)
    finally:
      if self._progress_reporter is not None:
        self._progress_reporter.close()
        self._progress_reporter = None
      if self._profiler is not None:  # the window reached past the end
        self._stop_profile()

  def _train_epochs(self, source, loader, fd, sparse, negative_sampling,
                    num_epochs, lr, lr_milestones, iters_per_epoch,
                    num_batches, spc, captured, profile_dir, profile_steps,
                    progress, model_checkpoint_prefix, checkpoint_freq,
                    validation, device_loop, tables):
    """The epochs of ``train``: ``device_loop``, the steps read the device
    step counter (:meth:`_device_epoch`); ``tables``, they read the
    source's 'users' epoch tables, built at each epoch's start."""
    for epoch in range(self.current_epoch, num_epochs + 1):
      with trace.span('recoder.epoch_start'):
        self.current_epoch = epoch
        epoch_lr = self._lr = _multistep_lr(lr, lr_milestones, epoch)
        set_lr(self.optimizer, epoch_lr)
        if loader is not None:
          if (self._train_iterator is None
              or self._iters_consumed >= num_batches):
            self._drop_train_iterator()
            self._train_iterator = self._device_batch_iter(loader)
            self._iters_consumed = 0
        else:
          if self._iters_consumed >= num_batches:
            self._epoch_perm = None
            self._iters_consumed = 0
          if self._epoch_perm is None:
            self._epoch_perm = source.epoch_permutation(epoch)
          if tables:  # (a no-op where the epoch's tables are placed)
            source.epoch_state(epoch, full_decode=fd)
        n_steps = min(iters_per_epoch, num_batches - self._iters_consumed)
        # (the steps read their scalars off the device: no host read)
        if isinstance(self.optimizer, Bf16Adam):
          self.optimizer.schedule(n_steps, capacity=num_batches)
          # (the parameters may have changed since: a load, a user)
          self.optimizer.refresh_copies()
        if self.sparse_states:
          self.sparse_adam.schedule(self.sparse_states.values(), epoch_lr,
                                    n_steps, capacity=num_batches)
        reporter = None
        if progress:
          desc = f'Epoch {epoch}/{num_epochs}'
          if self._progress_reporter is None:
            self._progress_reporter = ProgressReporter(n_steps, desc)
          else:
            self._progress_reporter.reset(n_steps, desc)
          reporter = self._progress_reporter

        t0 = time.time()
        path = (not fd, sparse, negative_sampling)
        if device_loop:
          loop = self._start_device_epoch(source, num_batches, captured,
                                          path)
      if device_loop:
        losses = self._device_epoch(loop, n_steps, spc, captured, path,
                                    profile_dir, profile_steps, reporter)
      elif loader is not None:
        losses = self._union_epoch(
            lambda: next(self._train_iterator, None), n_steps, sparse,
            profile_dir, profile_steps, reporter)
      else:
        losses = self._union_epoch(
            lambda: source.build_union_batch(self._epoch_perm,
                                             self._iters_consumed,
                                             neg_step=self._global_step),
            n_steps, sparse, profile_dir, profile_steps, reporter)
      # (one device sync per epoch)
      self.last_epoch_losses = losses
      dt = self.last_epoch_seconds = time.time() - t0
      mean_loss = float(np.mean(losses)) if losses else float('nan')
      msg = (f'Epoch {epoch}/{num_epochs} (lr={epoch_lr:g}) '
             f'[{len(losses)} it, {dt:.2f}s, '
             f'{len(losses) / max(dt, 1e-9):.1f} it/s, '
             f'{self.last_epoch_dispatch}, {self.last_epoch_dispatches} '
             f'dispatches] loss={mean_loss:.5f}')
      if validation is not None and epoch % validation[1] == 0:
        msg += self._validation_log(*validation)
      log.info(msg)
      if model_checkpoint_prefix and (
          (checkpoint_freq > 0 and epoch % checkpoint_freq == 0)
          or epoch == num_epochs):
        self.save_state(model_checkpoint_prefix)

  def _validation_log(self, val_loader, eval_freq, metrics, k, num_users,
                      batch_size):
    """The epoch log's validation part (the JAX ``eval_freq`` hook): the
    validation loss and, with ``metrics`` and ``k``, each metric's mean
    over the validation set's recommendations."""
    msg = f' val_loss={self._validate(val_loader):.5f}'
    if metrics is not None and k is not None:
      results = self._evaluate(val_loader.dataset, num_recommendations=k,
                               metrics=metrics, batch_size=batch_size,
                               num_users=num_users)
      for metric in results:
        msg += f' {metric}={np.mean(results[metric]):.4f}'
    return msg

  def _validate(self, val_dataloader):
    """The mean loss over the loader's batches (the JAX ``_validate``):
    the forward without noise or dropout (``training=False``; the
    dropout generator is not touched), under ``torch.no_grad()``, so the
    fused kernel writes no E0. The losses gather in one device buffer,
    read once. A full-catalog batch (no item union on either side) is
    scored in chunks when an eval chunk applies
    (:meth:`_resolve_eval_chunk`) and the loss is one of the named ones
    (the JAX ``_get_val_loss_fn`` dispatch): a custom ``Loss`` stays on
    the dense path, its meaning over part of the item axis unknown."""
    chunk = self._resolve_eval_chunk()
    if not isinstance(self.loss, str) or self.mesh is not None:
      # (a mesh rank's share of a batch is its users x its columns)
      chunk = None
    losses = torch.zeros(len(val_dataloader), device=self.device)
    count = 0
    with torch.no_grad():
      for batch in self._device_batch_iter(val_dataloader):
        full_catalog = (batch.get('items') is None
                        and batch.get('tg_items') is None)
        if chunk is not None and full_catalog:
          losses[count] = self._chunked_val_loss(batch, chunk)
        else:
          losses[count] = self._forward_loss(batch, training=False)
        count += 1
    if not count:
      return float('nan')
    return float(losses[:count].mean())

  def _chunked_val_loss(self, batch, chunk):
    """The validation loss of a full-catalog COO batch in ``O(B x
    chunk)`` memory (the JAX ``_chunked_val_loss``): the batch is
    encoded once from its COO (``encode_coo``, the model's compute
    dtype) and ``decode_slice`` streams the catalog's chunks, summing
    the same masked loss as the dense path. 'mse' and 'logistic' take
    one pass; 'logloss' two: a streaming log-sum-exp over the logical
    catalog, then the NLL. The target is the batch's ``tg_*`` COO when
    it has one, else its input."""
    model = self.model
    users = batch['users']
    B = users.shape[0]
    side = 'tg_' if 'tg_rows' in batch else ''
    h = model.encode_coo(batch['rows'], batch['cols'], batch['vals'], B,
                         input_users=users)
    row_mask = (torch.arange(B, device=self.device)
                < batch['num_users']).float()[:, None]
    chunks = self._chunks(chunk)

    def target(start):
      return self._chunk_dense(batch[side + 'rows'], batch[side + 'cols'],
                               batch[side + 'vals'], B, start, chunk)

    def scores(i, start):
      out = model.decode_slice(h, start, chunk).float()
      return out, self._chunk_valid(i, start, chunk)

    total = torch.zeros((), device=self.device)
    if self.loss == 'logloss':
      m = torch.full((B, 1), losses_lib._NEG_INF, device=self.device)
      z = torch.zeros((B, 1), device=self.device)
      for i, start in chunks:
        out, valid = scores(i, start)
        logits = torch.where(valid, out, losses_lib._NEG_INF)
        new_m = torch.maximum(m, logits.amax(1, keepdim=True))
        z = (z * torch.exp(m - new_m)
             + torch.exp(logits - new_m).sum(1, keepdim=True))
        m = new_m
      log_denom = m + torch.log(z)
      for i, start in chunks:
        out, valid = scores(i, start)
        logits = torch.where(valid, out, losses_lib._NEG_INF)
        loss = -target(start) * (logits - log_denom)
        total = total + torch.sum(loss * row_mask * valid)
    else:
      confidence = getattr(self.loss_module, 'confidence', 0.0)
      for i, start in chunks:
        out, valid = scores(i, start)
        tgt = target(start)
        if self.loss == 'mse':
          loss = (1.0 + confidence * (tgt > 0).float()) * (out - tgt) ** 2
        else:  # 'logistic'
          loss = (torch.clamp(out, min=0.0) - out * tgt
                  + torch.log1p(torch.exp(-torch.abs(out))))
        total = total + torch.sum(loss * row_mask * valid)
    return total / batch['num_users']

  # -- host-loader batches: staged on a background thread --------------------

  @staticmethod
  def _stage_batch(input_batch, target_batch):
    """A host :class:`Batch` (and its target) as the step's numpy
    arrays."""
    staged = {'users': input_batch.users,
              'num_users': float(len(input_batch.users))}
    for side, b in (('', input_batch), ('tg_', target_batch)):
      if b is not None:
        staged.update({side + 'rows': b.rows, side + 'cols': b.cols,
                       side + 'vals': b.vals, side + 'items': b.items})
    return staged

  @staticmethod
  def _to_device(staged, device, stream):
    """Send a staged batch's arrays to ``device``: ``(batch, event)``.
    On the card the arrays are packed into one pinned host buffer, at
    8-byte aligned offsets, and sent with one non-blocking copy on
    ``stream``; each array arrives as a view of the device buffer, and
    ``event`` marks the copy's end on ``stream`` (the pinned block
    returns to PyTorch's host allocator only after the copy, which
    records its stream's use of it). Off the card the arrays become
    tensors in place and ``event`` is None."""
    arrays = {k: np.ascontiguousarray(v) for k, v in staged.items()
              if isinstance(v, np.ndarray)}
    if device.type != 'cuda':
      return {**staged, **{k: torch.from_numpy(v)
                           for k, v in arrays.items()}}, None
    offsets, total = {}, 0
    for k, v in arrays.items():
      offsets[k] = total
      total += -(-v.nbytes // 8) * 8
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    packed = host.numpy()
    for k, v in arrays.items():
      packed[offsets[k]:offsets[k] + v.nbytes] = v.view(np.uint8)
    with torch.cuda.stream(stream):
      buffer = host.to(device, non_blocking=True)
      event = torch.cuda.Event()
      event.record(stream)
    sent = {k: buffer[offsets[k]:offsets[k] + v.nbytes].view(
        torch.from_numpy(v[:0]).dtype) for k, v in arrays.items()}
    return {**staged, **sent}, event

  def _arrived(self, batch, event):
    """Make the current stream wait for a batch's copies; its device
    tensors, allocated on the copy stream, are marked as used by the
    current stream, so that their memory is not reused under the step."""
    if event is not None:
      current = torch.cuda.current_stream(self.device)
      current.wait_event(event)
      for v in batch.values():
        if torch.is_tensor(v):
          v.record_stream(current)
    return batch

  def _device_batch_iter(self, dataloader, depth=6):
    """The loader's batches, staged and sent to the device on a
    background thread (the JAX ``_device_batch_iter``): at most ``depth``
    wait in the queue. Closing the iterator (or dropping it) stops the
    producer and the loader's workers; an exception of the producer is
    raised here, in the consumer. The producer holds no reference to the
    trainer, so that a dropped trainer's iterator is collected (and its
    producer stopped) with it."""
    device = self.device
    if device.type == 'cuda' and self._copy_stream is None:
      self._copy_stream = torch.cuda.Stream(device=device)
    stream, stage, send = self._copy_stream, self._stage_batch, self._to_device
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
      while not stop.is_set():
        try:
          q.put(item, timeout=0.2)
          return True
        except queue.Full:
          continue
      return False

    def producer():
      batches = iter(dataloader)
      try:
        for input_batch, target_batch in batches:
          if stop.is_set():
            return
          staged = stage(input_batch, target_batch)
          if not put(('ok', send(staged, device, stream))):
            return
        put(('done', None))
      except BaseException as e:  # raised again in the consumer
        put(('err', e))
      finally:
        batches.close()  # (stops the loader's collation threads)

    threading.Thread(target=producer, daemon=True,
                     name='recoder-batch-staging').start()
    try:
      while True:
        kind, payload = q.get()
        if kind == 'done':
          return
        if kind == 'err':
          raise payload
        yield self._arrived(*payload)
    finally:
      stop.set()  # runs on close() and when the generator is collected

  def _drop_train_iterator(self):
    """Stop the host loader's persistent iterator, if any."""
    if self._train_iterator is not None:
      self._train_iterator.close()
      self._train_iterator = None

  # -- device-counter epochs: eager steps or captured blocks of them --------

  def _start_device_epoch(self, source, num_batches, captured, path):
    """The host work before an epoch's first device-counter step: the
    loop's order and counters, the noise generators positioned, and on
    the captured path the graphs of the epoch's width signature made
    current; returns the loop. ``path``: ``(union, sparse,
    negative_sampling)``."""
    loop = self._device_loop
    if (loop is None or loop.source is not source
        or loop.perm.numel() != self._epoch_perm.numel()
        or loop.losses.numel() != num_batches):
      loop = self._device_loop = _DeviceLoop(
          source, self._epoch_perm.numel(), num_batches)
    loop.perm.copy_(self._epoch_perm)
    loop.step.fill_(self._iters_consumed)
    loop.global_step.fill_(self._global_step)
    if self.device.type == 'cuda':
      self._position_noise(loop, path[0])
    if captured:
      key, widths = self._graph_key(loop, path)
      if ((self._graph_sig is not None and key != self._graph_sig)
          or self._warm_key != (loop, path)):
        # (a tensor a graph recorded was replaced, or the warm-up steps
        # were another path's)
        self._drop_graphs()
        self._warm_key = (loop, path)
      if widths != self._graph_widths:
        self._switch_graphs(widths)
    return loop

  def _device_epoch(self, loop, n_steps, spc, captured, path, profile_dir,
                    profile_steps, reporter):
    """``n_steps`` steps that read the device step counter -- full decode,
    or the static 'blocks' union batches -- from ``_iters_consumed`` on,
    in dispatches of ``spc`` (then single) steps, over ``loop``
    (:meth:`_start_device_epoch`); returns their losses."""
    on_card = self.device.type == 'cuda'
    first = self._iters_consumed
    dispatches = 0
    remaining = n_steps
    while remaining > 0:
      block = spc if remaining >= spc else 1
      self._maybe_profile(profile_dir, profile_steps)
      if captured and self._warm_steps < WARMUP_STEPS:
        block = min(WARMUP_STEPS - self._warm_steps, remaining)
        self._warm_up(loop, path, block)
        dispatches += block
      elif captured:
        graph = self._graph(block, loop, path)
        with trace.span('recoder.replay'):
          graph.replay()
          if isinstance(self.optimizer, Bf16Adam):
            self.optimizer.note_steps(block)
          self.sparse_adam.note_steps(block)
        dispatches += 1
      else:
        for i in range(block):
          with trace.span('recoder.eager'):
            self._device_step(loop, path,
                              None if on_card else self._global_step + i)
        dispatches += block
      s = self._iters_consumed
      self._iters_consumed += block
      self._global_step += block
      remaining -= block
      if reporter is not None:
        reporter.put(block, loss_handle(loop.losses[s:s + block]))
    self.last_epoch_dispatch = (f'captured, {spc} steps a graph' if captured
                                else 'eager')
    self.last_epoch_dispatches = dispatches
    with trace.span('recoder.losses'):
      return loop.losses[first:first + n_steps].tolist()

  def _device_step(self, loop, path, reseed_step=None):
    """One step whose batch, loss slot and step all come from the device
    counter ``loop.step`` (it advances it): a full-decode batch
    (``fd_batch``) or a static union batch (``union_batch``), through the
    dense or the sparse step math (``path = (union, sparse,
    negative_sampling)``). Nothing is read on the host (but by the
    'users' triplet scatter outside the JAX gate), so a graph can record
    it. ``reseed_step``
    (off the card): seed the dropout generator and the random negatives'
    for that global step first."""
    union, sparse, negative_sampling = path
    source = loop.source
    if reseed_step is not None:
      self._dropout_gen.manual_seed((self.seed << 32) + reseed_step)
      if source.neg_gen is not None:
        source.seed_negatives(reseed_step)
    if union:
      batch = source.union_batch(loop.perm, loop.step)
    else:  # (with negative sampling a 'users' source's epoch tables)
      batch = source.fd_batch(loop.perm, loop.step, epoch_tables=(
          negative_sampling and source.users_precompute))
    math = self._sparse_step_math if sparse else self._dense_step_math
    loss = math(batch, negative_sampling, reseed=False,
                step=loop.global_step)
    loop.losses.index_copy_(0, loop.step.view(1), loss.view(1).float())
    loop.step.add_(1)
    loop.global_step.add_(1)

  def _position_noise(self, loop, union):
    """Put the card's dropout generator where the global step puts it:
    seed ``seed << 32``, Philox offset ``global step x the offset one
    step takes`` (in the step's layout: full decode, or ``union`` at the
    width of the placed tables), and
    the source's random-negative generator likewise
    (``position_negatives``). The steps then draw their masks and ids
    from the generators as they advance -- eager steps and graph replays
    alike (the graphs register them) -- and a training resumed from a
    checkpoint draws what the uninterrupted one would have drawn."""
    # (a 'users' union step's width is its epoch's: probed per signature)
    layout = (union, loop.source.graph_signature() if union else None)
    if layout not in loop.noise_inc:
      loop.noise_inc[layout] = self._noise_increment(loop, union)
    self._dropout_gen.manual_seed(self.seed << 32)
    self._dropout_gen.set_offset(self._global_step * loop.noise_inc[layout])
    if loop.source.neg_gen is not None:
      loop.source.position_negatives(self._global_step)

  def _noise_increment(self, loop, union):
    """The Philox offset one step's noise draws take: a training forward
    of the step's shapes from a scratch generator, down the step's own
    routes (the input's mask is drawn where the ``noised_input`` kernel's
    route draws it; every draw of the step -- a dropout mask, a Mult-VAE's
    eps -- is in it). A union step's input spans the static union's width,
    a full-decode step's the padded catalog: each layout is probed."""
    probe = torch.Generator(device=self.device)
    probe.manual_seed(0)
    B = loop.source.batch_size
    W, items, tg_items = self.model.num_items_padded, None, None
    if union:
      widths = loop.source.static_widths()
      W = widths['W']
      items = torch.zeros(W, dtype=torch.int64, device=self.device)
      tg_items = (torch.zeros(widths['tg_W'], dtype=torch.int64,
                              device=self.device)
                  if 'tg_W' in widths else items)
    x = torch.zeros((B, W), device=self.device,
                    dtype=getattr(self.model, 'compute_dtype', None)
                    or torch.float32)
    users = torch.zeros(B, dtype=torch.int64, device=self.device)
    kw = dict(input_items=items, target_items=tg_items, training=True,
              generator=probe, input_users=users)
    if self.mesh is not None:
      # (a rank draws the whole batch's masks: the same offset)
      part = self._partition(B)
      x = part.rows(x)
      kw['shard'] = part
    with torch.no_grad():
      if getattr(self.model, 'fused_decode', False):
        self.model.decode_operands(x, **kw)
      else:
        self.model(x, **kw)
    return probe.get_offset()

  def _side_stream(self):
    if self._capture_stream is None:
      self._capture_stream = torch.cuda.Stream(device=self.device)
    return self._capture_stream

  @trace.span('recoder.warm_up')
  def _warm_up(self, loop, path, n):
    """``n`` real steps, eager, on the capture stream: they create what a
    step creates lazily (optimizer state, launch plans, library
    workspaces) before a capture may record it."""
    stream = self._side_stream()
    stream.wait_stream(torch.cuda.current_stream(self.device))
    with torch.cuda.stream(stream):
      for _ in range(n):
        self._device_step(loop, path)
    torch.cuda.current_stream(self.device).wait_stream(stream)
    self._warm_steps += n

  def _graph_key(self, loop, path):
    """What a captured step baked in: every tensor it reads or writes in
    place (by address) and the choices its Python made; and apart, the
    width signature of the source's 'users' tables with the addresses of
    that signature's buffers (``DeviceDataSource.graph_signature``)."""
    tensors = list(self.model.params().values())
    for state in self.optimizer.state.values():
      tensors += [v for v in state.values() if torch.is_tensor(v)]
    tensors += [g['lr'] for g in self.optimizer.param_groups
                if torch.is_tensor(g['lr'])]
    if isinstance(self.optimizer, Bf16Adam):
      tensors += [self.optimizer._ctl, self.optimizer._table]
      tensors += self.optimizer.copies()
    for state in self.sparse_states.values():
      tensors += [state['step'], state['m'], state['v']]
    if self.sparse_states:
      tensors += [self.sparse_adam._table, self.sparse_adam._base]
    tensors += loop.source.resident_tensors()
    tensors += [loop.perm, loop.step, loop.global_step, loop.losses]
    return ((id(self.optimizer), id(self.sparse_adam), id(loop), path,
             id(self.loss), self._dropout_gen, loop.source.neg_gen,
             tuple(t.data_ptr() for t in tensors)),
            loop.source.graph_signature())

  def _graph(self, block, loop, path):
    """The graph of ``block`` consecutive steps, captured at first use on
    the capture stream (after the warm-up)."""
    entry = self._graphs.get(block)
    if entry is None:
      with trace.span('recoder.capture'):
        if self._graph_sig is None:
          self._graph_sig = self._graph_key(loop, path)[0]
        bf16_adam = isinstance(self.optimizer, Bf16Adam)
        if bf16_adam:
          self.optimizer.begin_capture(block)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._dropout_gen)
        if loop.source.neg_gen is not None:
          graph.register_generator_state(loop.source.neg_gen)
        # ('thread_local': the progress thread may wait on an event
        # meanwhile; the capture checks this thread's calls. No cyclic
        # collection meanwhile: a dead cycle that holds CUDA graphs -- a
        # dropped trainer's -- would destroy them inside the capture, which
        # invalidates it)
        collecting = gc.isenabled()
        gc.disable()
        try:
          with torch.cuda.graph(graph, stream=self._side_stream(),
                                capture_error_mode='thread_local'):
            for _ in range(block):
              self._device_step(loop, path)
        finally:
          if collecting:
            gc.enable()
        entry = self._graphs[block] = (
            graph, self.optimizer.end_capture() if bf16_adam else None)
        self.captures += 1
        log.info('captured a CUDA graph of %d %s step(s)', block,
                 ('sparse ' if path[1] else '')
                 + ('union' if path[0] else 'full-decode'))
    return entry[0]

  def _drop_graphs(self):
    """Forget the captured steps (a tensor they recorded is replaced):
    the next epoch on the card warms up and captures anew."""
    self._graphs = {}
    self._graph_sig = None
    self._warm_steps = 0
    self._warm_key = None
    self._graph_widths = None
    self._parked.clear()

  def _switch_graphs(self, widths):
    """Make ``widths``' graphs the current ones (an epoch of 'users'
    tables of another width signature): the current set is parked, a
    parked one for ``widths`` taken back -- its steps replay without a
    capture -- or a new set started, which warms up and captures. The
    last ``GRAPH_SETS`` sets are kept."""
    if self._graphs or self._warm_steps:
      self._parked[self._graph_widths] = (self._graphs, self._warm_steps)
    self._graphs, self._warm_steps = self._parked.pop(widths, ({}, 0))
    self._graph_widths = widths
    while len(self._parked) >= GRAPH_SETS:
      self._parked.popitem(last=False)

  # -- host-read epochs: one eager dispatch a step --------------------------

  def _union_epoch(self, next_batch, n_steps, sparse, profile_dir,
                   profile_steps, reporter):
    """Up to ``n_steps`` eager steps on the COO batches ``next_batch()``
    gives (None: the iterator ran out): the host loader's, or the
    'users' union batches; returns their losses."""
    losses = []
    for _ in range(n_steps):
      self._maybe_profile(profile_dir, profile_steps)
      with trace.span('recoder.eager'):  # (the batch's host work too)
        batch = next_batch()
        if batch is None:
          break
        self._iters_consumed += 1
        if sparse:
          loss = self._sparse_step_math(batch)
        else:
          loss = self._dense_step_math(batch)
      self._global_step += 1
      losses.append(loss)
      if reporter is not None:
        reporter.put(1, loss_handle(loss.view(1)))
    self.last_epoch_dispatch = 'eager'
    self.last_epoch_dispatches = len(losses)
    with trace.span('recoder.losses'):
      return torch.stack(losses).tolist() if losses else []

  # -- profile window ---------------------------------------------------------

  def _maybe_profile(self, profile_dir, profile_steps):
    """Start or stop a torch.profiler window around global steps
    ``profile_steps = (start, stop)`` (the JAX ``_maybe_profile``)."""
    if profile_dir is None:
      return
    start, stop = profile_steps
    if self._profiler is None and self._global_step == start:
      from torch.profiler import ProfilerActivity, profile
      activities = [ProfilerActivity.CPU]
      if self.device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
      prof = profile(activities=activities)
      prof.start()
      self._profiler = (prof, profile_dir, start)
      log.info('profiler trace started (step %d) -> %s', self._global_step,
               profile_dir)
    elif self._profiler is not None and self._global_step >= stop:
      self._stop_profile()

  def _stop_profile(self):
    prof, profile_dir, start = self._profiler
    self._profiler = None
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f'trace_steps_{start}_'
                        f'{self._global_step}.json')
    prof.export_chrome_trace(path)
    log.info('profiler trace stopped (step %d) -> %s', self._global_step,
             path)

  # -- restarts ---------------------------------------------------------------

  def reset_training_state(self):
    """Re-initialize the parameters and the optimizer state in place (the
    JAX ``reset_training_state``): a later ``train`` gives the trajectory
    of a fresh trainer with the same seed. The tensors keep their
    storage, so the captured step graphs stay valid and are replayed:
    the port's form of JAX keeping its compiled step functions. Used for
    warm-started benchmarking (bench_quality.py) and restarts."""
    if not self._model_initialized:
      self._init_model()
    params = self.model.params()
    self.model.init_model(self.num_items, self.num_users, seed=self.seed)
    self._shard_model()
    fresh = self.model.params()
    if fresh.keys() == params.keys() and all(
        fresh[k].shape == params[k].shape for k in params):
      with torch.no_grad():
        for name, p in params.items():
          p.copy_(fresh[name])
      self.model._parameters.clear()
      for name, p in params.items():
        self.model.register_parameter(name, p)
    else:
      self.model.to(self.device)
      self.optimizer = None
      self._drop_graphs()
    if isinstance(self.optimizer, Bf16Adam):
      self.optimizer.reset_state()
    elif self.optimizer is not None and self.optimizer_type == 'adam':
      with torch.no_grad():
        for state in self.optimizer.state.values():
          for value in state.values():
            if torch.is_tensor(value):
              value.zero_()
    elif self.optimizer is not None:
      self.optimizer.state.clear()
    self.sparse_states = {}
    self._pending_opt_arrays = None
    self.current_epoch = 1
    self._global_step = 0
    self._epoch_perm = None
    self._iters_consumed = 0
    self._drop_train_iterator()
    self._train_iterator_key = None

  @property
  def fused_data_source(self):
    """The live on-device data source of the last ``train`` call, or
    None (which slab tier served it: ``_slab_packed``)."""
    cached = self._source_cache
    return cached[2] if cached is not None else None

  # ------------------------------------------------------------------
  # inference / evaluation
  # ------------------------------------------------------------------

  def _inference_coo(self, users_interactions):
    """A batch's interactions on the device: ``(rows, cols, vals,
    users)``, the COO in CSR order (float32 values) and the user ids. On
    the card they go in one non-blocking copy on the current stream
    (:meth:`_to_device`), so that the caller is not held until the work
    queued before it is done."""
    m = users_interactions.interactions_matrix.tocsr()
    B = m.shape[0]
    if B == 0:
      raise ValueError('cannot score an empty user batch')
    dev = self.device
    staged = {
        'rows': np.repeat(np.arange(B, dtype=np.int64), np.diff(m.indptr)),
        'cols': m.indices.astype(np.int64),
        'vals': m.data.astype(np.float32),
        'users': np.asarray(users_interactions.users, dtype=np.int64)}
    stream = torch.cuda.current_stream(dev) if dev.type == 'cuda' else None
    batch, _ = self._to_device(staged, dev, stream)
    return batch['rows'], batch['cols'], batch['vals'], batch['users']

  def _densify(self, rows, cols, vals, B):
    """Dense ``[B, num_items_padded]`` input of a COO batch, in the
    model's compute dtype (float32 by default), as the JAX ``_densify``."""
    dtype = getattr(self.model, 'compute_dtype', None) or torch.float32
    dense = torch.zeros((B, self.model.num_items_padded), device=self.device,
                        dtype=dtype)
    dense.index_put_((rows, cols), vals.to(dtype), accumulate=True)
    return dense

  def _score(self, dense, users):
    """Full-catalog scores of a dense input, in ``eval_compute_dtype`` or
    else the model's compute dtype; the batch's user ids go to the
    model as ``input_users``."""
    kw = ({} if self.eval_compute_dtype is None
          else {'compute_dtype': self.eval_compute_dtype})
    return self.model(dense, input_users=users, training=False, **kw)

  def _mesh_operands(self, dense, users):
    """On a mesh: this rank's ``(h, rows, bias, part)`` of a scoring
    batch (its users' bottleneck, its rows of the catalog), in
    ``eval_compute_dtype``: the model's ``decode_operands``."""
    part = self._partition(users.shape[0])
    h, rows, bias = self.model.decode_operands(
        part.rows(dense), input_users=users, training=False, shard=part,
        compute_dtype=self.eval_compute_dtype)
    return h, rows, bias, part

  def _mesh_score(self, dense, users):
    """:meth:`_score` on a mesh: each rank scores its users against its
    columns, and the blocks are gathered, so that every rank returns the
    whole ``[B, num_items_padded]`` scores."""
    h, rows, bias, part = self._mesh_operands(dense, users)
    out = self.model.decode(h, rows, bias, self.eval_compute_dtype)
    out = collectives.gather_columns(
        out, self.mesh.model_group,
        sharding_lib.split_sizes(self.model.num_items_padded, self.mesh))
    return collectives.gather_rows(
        out, self.mesh.data_group,
        sharding_lib.split_sizes(users.shape[0], self.mesh, 'data'))

  def _mesh_top_k(self, dense, users, k, chunk):
    """:meth:`recommend_async`'s ids on a mesh: each rank takes the
    top-k of its users over its columns (seen items and pad columns at
    -inf; in slices of ``chunk`` columns when one is set), the ranks'
    candidates merge over 'model' in ``lax.top_k``'s order, and the
    users' rows are gathered over 'data'."""
    h, _, _, part = self._mesh_operands(dense, users)
    lo, hi = part.ranges['item'] if part.split else (
        0, self.model.num_items_padded)
    seen = part.columns(part.rows(dense)) > 0
    B, W = h.shape[0], self.model.num_items_padded
    best_vals = torch.full((B, k), float('-inf'), device=self.device)
    best_idx = torch.full((B, k), W, dtype=torch.int64, device=self.device)
    width = hi - lo if chunk is None else min(chunk, hi - lo)
    for start in range(0, hi - lo, width):
      w = min(width, hi - lo - start)
      s = self.model.decode_slice(h, start, w,
                                  compute_dtype=self.eval_compute_dtype)
      s = s.float().masked_fill(seen[:, start:start + w], float('-inf'))
      ids = lo + start + torch.arange(w, device=self.device)
      s = s.masked_fill(ids[None, :] >= self.model.num_items, float('-inf'))
      c_vals, c_idx = top_k(s, min(k, w))
      best_vals, best_idx = merge_top_k(best_vals, best_idx, c_vals,
                                        c_idx + lo + start, k)
    group = self.mesh.model_group
    sizes = [k] * self.mesh.shape['model']
    vals = collectives.gather_columns(best_vals, group, sizes)
    idx = collectives.gather_columns(best_idx, group, sizes)
    _, idx = merge_top_k(vals[:, :k], idx[:, :k], vals[:, k:], idx[:, k:], k)
    return collectives.gather_rows(
        idx, self.mesh.data_group,
        sharding_lib.split_sizes(users.shape[0], self.mesh, 'data'))

  def predict(self, users_interactions, return_input=False):
    """Full-catalog scores for a batch of users, as float32 numpy trimmed
    to the logical ``num_items`` columns; ``(scores, input)`` when
    ``return_input``. On a mesh every rank returns the whole batch's."""
    if not self._model_initialized:
      raise RuntimeError('Model not initialized.')
    with torch.no_grad():
      rows, cols, vals, users = self._inference_coo(users_interactions)
      dense = self._densify(rows, cols, vals, users.shape[0])
      out = (self._score(dense, users) if self.mesh is None
             else self._mesh_score(dense, users))
    out = out[:, :self.num_items].float().cpu().numpy()
    if return_input:
      return out, dense[:, :self.num_items].float().cpu().numpy()
    return out

  def _resolve_eval_chunk(self):
    """The chunk width of inference (None: one ``[B, W]`` matrix), as
    the JAX package resolves it: ``eval_item_chunk``, or
    ``AUTO_CHUNK_WIDTH`` past ``AUTO_CHUNK_ITEMS`` padded items when it
    is None; 0 or None means one matrix; capped at the padded width."""
    chunk = self.eval_item_chunk
    W = self.model.num_items_padded
    if chunk is None and W is not None and W > self.AUTO_CHUNK_ITEMS:
      chunk = self.AUTO_CHUNK_WIDTH
    if not chunk:
      return None
    return min(int(chunk), W)

  def _chunks(self, chunk):
    """The chunks of the logical catalog: ``(i, start)``, the last one
    clamped to end at the padded width (the columns it shares with the
    one before are masked off: :meth:`_chunk_valid`)."""
    W = self.model.num_items_padded
    return [(i, min(i * chunk, W - chunk))
            for i in range(-(-self.model.num_items // chunk))]

  def _chunk_valid(self, i, start, chunk):
    """``[1, chunk]``: the chunk's columns inside the logical catalog and
    not already covered by the chunk before it."""
    ids = start + torch.arange(chunk, device=self.device)
    return ((ids < self.model.num_items) & (ids >= i * chunk))[None, :]

  @staticmethod
  def _chunk_dense(rows, cols, vals, B, start, chunk):
    """The COO's entries in the columns ``[start, start + chunk)`` as a
    float32 ``[B, chunk]`` matrix (repeated entries summed, as the JAX
    scatter-add). The other entries land in a spare column that is cut
    off, so that no host read has to find the chunk's entries."""
    local = cols - start
    local = torch.where((local >= 0) & (local < chunk), local, chunk)
    dense = torch.zeros((B, chunk + 1), device=rows.device)
    dense.index_put_((rows, local), vals.float(), accumulate=True)
    return dense[:, :chunk]

  def _chunked_top_k(self, rows, cols, vals, users, k, chunk):
    """Top-k ids ``[B, k]`` of chunked scoring (the JAX
    ``_get_recommend_fn``'s chunked branch): the batch is encoded once
    from its COO (``encode_coo``); each chunk's scores come from
    ``decode_slice`` (float32, in ``eval_compute_dtype``), its seen items
    and its invalid columns go to -inf, and its top-k merges into a
    running one by (value desc, index asc) -- ``lax.top_k``'s order over
    the whole catalog. The running top-k starts from sentinels of index
    ``W`` that lose every tie, so a user with fewer than k unseen items
    still gets k distinct real ids. Peak memory is ``O(B x chunk)``."""
    model = self.model
    B = users.shape[0]
    W = model.num_items_padded
    cd = self.eval_compute_dtype
    h = model.encode_coo(rows, cols, vals, B, input_users=users,
                         compute_dtype=cd)
    best_vals = torch.full((B, k), float('-inf'), device=self.device)
    best_idx = torch.full((B, k), W, dtype=torch.int64, device=self.device)
    for i, start in self._chunks(chunk):
      s = model.decode_slice(h, start, chunk, compute_dtype=cd).float()
      seen = self._chunk_dense(rows, cols, vals, B, start, chunk) > 0
      s = s.masked_fill(seen, float('-inf'))
      s = s.masked_fill(~self._chunk_valid(i, start, chunk), float('-inf'))
      c_vals, c_idx = top_k(s, k)
      best_vals, best_idx = merge_top_k(best_vals, best_idx, c_vals,
                                        c_idx + start, k)
    return best_idx

  def recommend_async(self, users_interactions, num_recommendations):
    """Dispatch the top-k of a batch on the device and return its ids,
    the device tensor ``[B, k]`` (int64; ``.cpu()`` fetches it), as the
    JAX ``recommend_async`` returns its device array. Seen items and the
    pad columns are excluded; the top-k is ``lax.top_k``'s, ties to the
    lowest item id (``ops/topk.py``), through one ``[B, W]`` score
    matrix or, with an eval chunk (:meth:`_resolve_eval_chunk`), chunk
    by chunk (:meth:`_chunked_top_k`). On a mesh every rank returns the
    whole batch's ids (:meth:`_mesh_top_k`)."""
    if not self._model_initialized:
      raise RuntimeError('Model not initialized.')
    k = int(num_recommendations)
    chunk = self._resolve_eval_chunk()
    if chunk is not None and chunk < k:
      raise ValueError(f'eval_item_chunk ({chunk}) must be >= '
                       f'num_recommendations ({k})')
    with torch.no_grad():
      rows, cols, vals, users = self._inference_coo(users_interactions)
      if self.mesh is not None:
        return self._mesh_top_k(self._densify(rows, cols, vals,
                                              users.shape[0]),
                                users, k, chunk)
      if chunk is not None:
        return self._chunked_top_k(rows, cols, vals, users, k, chunk)
      dense = self._densify(rows, cols, vals, users.shape[0])
      out = self._score(dense, users)
      out = out.masked_fill(dense > 0, float('-inf'))
      out[:, self.model.num_items:] = float('-inf')
      return top_k(out, k)[1]

  def recommend(self, users_interactions, num_recommendations):
    """Top-k item ids per user, excluding each user's seen items
    (:meth:`recommend_async`, fetched as lists)."""
    return self.recommend_async(users_interactions,
                                num_recommendations).cpu().tolist()

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

  def save_state(self, model_checkpoint_prefix, backend='npz',
                 async_save=True):
    """Save a checkpoint; returns its path.

    ``backend='npz'`` (default) writes ``{prefix}_epoch_{N}.model`` in
    the JAX package's npz format, before this returns. ``backend='orbax'``
    writes the directory ``{prefix}_epoch_{N}.orbax/`` in PyTorch's DCP
    format (``recoder_tpu_torch.checkpoint_orbax``): with ``async_save``
    this returns once the arrays are on the host, and the write and its
    atomic swap go on in the background. Both hold the same float32
    arrays (bf16 upcast, exactly).

    On a mesh every rank calls it: the ranks' rows of each split
    parameter and of its optimizer moments are gathered, and rank 0
    writes the checkpoint a single device writes (the other ranks
    return the same path: after the write, or with ``async_save`` after
    rank 0's snapshot)."""
    suffixes = {'npz': '.model', 'orbax': '.orbax'}
    if backend not in suffixes:
      raise ValueError(f'unknown checkpoint backend {backend!r}')
    checkpoint_file = (f'{model_checkpoint_prefix}_epoch_'
                       f'{self.current_epoch}{suffixes[backend]}')
    log.info('Saving model to %s', checkpoint_file)
    meta = {
        'recoder_version': __version__,
        'model_class': type(self.model).__name__,
        'model_params': self.model.model_params(),
        'model_sparse': bool(self.model.sparse_param_paths()),
        'last_epoch': self.current_epoch,
        'optimizer_type': self.optimizer_type,
        'num_items': self.num_items,
        'num_users': self.num_users,
        'global_step': self._global_step,
        # the step within the epoch: a resume continues the epoch there
        # (the JAX package's loader ignores it and restarts the epoch)
        'epoch_step': self._iters_consumed,
    }
    if isinstance(self.loss, str):
      meta['loss'] = self.loss
      meta['loss_params'] = self.loss_params

    named, _ = self._split_params()
    arrays = {'model': convert.params_to_numpy(self.model.params())}
    if self.optimizer is not None:
      arrays['optimizer'] = convert.opt_state_to_numpy(
          self.optimizer, named, self.optimizer_type,
          sgd_step=self._global_step)
    if self.sparse_states:
      arrays['sparse_optimizer'] = convert.sparse_state_to_numpy(
          self.sparse_states)
    if self.mesh is not None:
      arrays = self._mesh_arrays(arrays, self._gather_rows)
    if self.items is not None:
      arrays['items'] = np.asarray(self.items)
    if self.users is not None:
      arrays['users'] = np.asarray(self.users)
    if self.mesh is None or torch.distributed.get_rank() == 0:
      if backend == 'orbax':
        if async_save and self.device.type == 'cpu':
          # on the CPU the arrays alias the live parameters and moments,
          # which the next steps change under the background write
          arrays = unflatten_tree({k: np.array(v) for k, v in
                                   flatten_tree(arrays).items()})
        save_checkpoint_orbax(checkpoint_file, arrays, meta,
                              async_save=async_save)
      else:
        save_checkpoint(checkpoint_file, arrays, meta)
    if self.mesh is not None:
      torch.distributed.barrier()
    return checkpoint_file

  def _gather_rows(self, name, array):
    """The whole ``array`` of split parameter ``name`` (or of one of its
    moments) from the ranks' rows, gathered over 'model'."""
    part = torch.from_numpy(np.ascontiguousarray(array)).to(self.device)
    return collectives.gather_rows(
        part, self.mesh.model_group,
        sharding_lib.split_sizes(self._whole_rows[name], self.mesh)
    ).cpu().numpy()

  def _shard_rows(self, name, array):
    """This rank's rows of the whole ``array`` of split parameter
    ``name`` (or of one of its moments)."""
    return sharding_lib.shard_params({name: np.asarray(array)}, self.model,
                                     self.mesh)[name]

  def _mesh_arrays(self, arrays, fn):
    """A checkpoint's trees with ``fn(name, array)`` applied to every
    array of a 'model'-split parameter: the parameters, the dense
    optimizer's moments and the row-sparse Adam's."""
    split = self._whole_rows
    out = dict(arrays)
    out['model'] = {k: fn(k, v) if k in split else v
                    for k, v in arrays['model'].items()}
    if arrays.get('optimizer') is not None:
      out['optimizer'] = {
          key: ({k: fn(k, v) if k in split else v for k, v in tree.items()}
                if isinstance(tree, dict) else tree)
          for key, tree in arrays['optimizer'].items()}
    if arrays.get('sparse_optimizer'):
      out['sparse_optimizer'] = {
          path: {k: fn(path, v) if k in ('m', 'v') else v
                 for k, v in st.items()}
          for path, st in arrays['sparse_optimizer'].items()}
    return out

  def init_from_model_file(self, model_file):
    """Restore model, optimizer and training state from a checkpoint:
    an npz file written by this package or by the JAX package, or a
    directory of :meth:`save_state`'s 'orbax' backend (the format is
    auto-detected; a pending background save is waited for first).

    Sparse and dense checkpoints load into sparse and dense models alike
    (a JAX sparse checkpoint's feature-padded tables are cut to the
    model's width, ``convert.fit_table``); optimizer state saved under
    the other sparse / dense split restarts fresh, as in JAX. On a mesh
    every rank reads the file and keeps its rows of each split parameter
    and of its moments."""
    log.info('Loading model from: %s', model_file)
    wait_for_pending_saves()
    if self.mesh is not None:
      torch.distributed.barrier()  # rank 0's save has committed
    if is_orbax_checkpoint(model_file):
      arrays, meta = load_checkpoint_orbax(model_file)
    elif os.path.isfile(model_file):
      arrays, meta = load_checkpoint(model_file)
    else:
      raise FileNotFoundError(f'No state file found in {model_file}')

    self.current_epoch = meta['last_epoch']
    self._global_step = meta.get('global_step', 0)
    self.loss = meta.get('loss', self.loss)
    self.loss_params = meta.get('loss_params', self.loss_params)
    self.optimizer_type = meta['optimizer_type']
    self.num_items = meta.get('num_items')
    self.num_users = meta.get('num_users')
    self.items = arrays.get('items')
    self.users = arrays.get('users')
    self.sparse_states = {}
    self._iters_consumed = int(meta.get('epoch_step', 0))
    self._epoch_perm = None
    self._train_iterator_key = _RESUMED
    self._drop_graphs()

    self.model.load_model_params(meta['model_params'])
    self._init_model()
    if self.mesh is not None:
      arrays = self._mesh_arrays(arrays, self._shard_rows)
    self._pending_opt_arrays = (arrays.get('optimizer'),
                                arrays.get('sparse_optimizer') or {})
    convert.load_params(self.model, arrays['model'])
