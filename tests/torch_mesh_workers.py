"""Mesh cases of ``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_fits.py``, run in spawned gloo ranks on the CPU
(and, without a mesh, in the test process).

It imports no jax: each spawned rank imports only this module and the
port. A rank joins a gloo group through a file store, builds the mesh,
runs the cases in order -- every rank the same program on the same data,
as a torchrun launch does -- and writes each case's result where the
test reads it: the npz checkpoint that ``Recoder.save_state`` (or a fit
model's ``save``) writes on rank 0 (the whole parameters and moments,
gathered), and every rank's shard shapes. Any exception is written to
``error_<rank>.txt``. :func:`spawn` starts the ranks of one mesh shape.
"""

import json
import multiprocessing
import os
import time
import traceback

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from recoder_tpu_torch import convert
from recoder_tpu_torch import cli
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.data.loader import RecommendationDataLoader
from recoder_tpu_torch.metrics import Recall
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import (EASE, IALS, DynamicAutoencoder,
                                      MatrixFactorization, MultVAE)
from recoder_tpu_torch.models import ials as ials_lib
from recoder_tpu_torch.ops import losses
from recoder_tpu_torch.parallel import MeshConfig, make_mesh
from recoder_tpu_torch.parallel import sharding

#: seconds a spawn of one mesh shape may take before its ranks are killed
TIMEOUT = 120

#: the JAX slice fixture (tests/test_torch_slice.py): users <= batch
SLICE = dict(users=40, items=120, batch=64, hidden=[16], lr=1e-2, wd=1e-3,
             steps=4)
#: the slice fixture's Mult-VAE (no dropout; the KL weight grows a step)
VAE_SLICE = dict(hidden_dim=16, latent_dim=8, dropout_prob=0.0,
                 total_anneal_steps=10)


class NoNoiseMultVAE(MultVAE):
  """Mult-VAE whose reparameterization draws eps = 0 in training (z =
  mu): the JAX package's Mult-VAE gives the same steps with
  ``jax.random.normal`` set to zeros, as no torch draw reproduces
  ``jax.random``'s."""

  def _hidden(self, input, en_rows, training, generator, cd, keep_mask,
              eps, shard=None, catalog=False):
    if training:
      eps = torch.zeros((input.shape[0], self.latent_dim),
                        device=input.device)
    return super()._hidden(input, en_rows, training, generator, cd,
                           keep_mask, eps, shard, catalog)


def dataset(seed=0, users=64, items=300, target=False):
  """The JAX mesh tests' random binary matrix (``tests/test_sharding.py``
  ``_dataset``); with ``target`` a held-out split as the target."""
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, users, users * 12)
  cols = rng.integers(0, items, users * 12)
  m = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                    shape=(users, items))
  m.sum_duplicates()
  m.data[:] = 1.0
  if not target:
    return RecommendationDataset(m)
  held = (rng.random(m.nnz) < 0.3).astype(np.float32)
  tg = m.copy()
  tg.data = held
  tg.eliminate_zeros()
  m.data = 1.0 - held
  m.eliminate_zeros()
  return RecommendationDataset(m, tg)


def slice_matrix():
  rng = np.random.default_rng(0)
  return sp.csr_matrix(
      (rng.random((SLICE['users'], SLICE['items'])) < 0.1).astype(np.float32))


class HuberLoss(losses.Loss):
  """A custom sum-reduced ``Loss``: the Huber loss of the scores against
  the target (not one of the built-in losses: on a split catalog the
  trainer gives it the whole score matrix)."""

  reduction = 'sum'

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    d = torch.abs(input.float() - target.float())
    return losses._apply_masks(torch.where(d < 1, 0.5 * d * d, d - 0.5),
                               row_mask, col_mask)


#: name -> (model, trainer kwargs, train kwargs, dataset kwargs)
CASES = {
    'ae_users': (lambda: DynamicAutoencoder([16], 'tanh', noise_prob=0.3,
                                            dropout_prob=0.2),
                 dict(loss='mse'), dict(shuffle='users'), {}),
    'ae_blocks': (lambda: DynamicAutoencoder([16, 8], 'tanh', noise_prob=0.3),
                  dict(loss='mse'), dict(shuffle='blocks'), {}),
    'ae_full_decode': (lambda: DynamicAutoencoder([16], 'tanh'),
                       dict(loss='logistic'),
                       dict(shuffle='blocks', full_decode=True), {}),
    'mf_users': (lambda: MatrixFactorization(8, 'tanh', dropout_prob=0.2),
                 dict(loss='mse'), dict(shuffle='users'), {}),
    'mf_sparse': (lambda: MatrixFactorization(8, 'tanh', sparse=True),
                  dict(loss='mse'), dict(shuffle='users'), {}),
    'ae_logloss': (lambda: DynamicAutoencoder([12]), dict(loss='logloss'),
                   dict(shuffle='users'), dict(seed=9)),
    'ae_sparse_logloss': (lambda: DynamicAutoencoder([12], sparse=True),
                          dict(loss='logloss'), dict(shuffle='users'),
                          dict(seed=9)),
    'ae_target': (lambda: DynamicAutoencoder([16], 'tanh'),
                  dict(loss='mse'), dict(shuffle='users'),
                  dict(seed=5, target=True)),
    'vae_users': (lambda: MultVAE(16, 8, dropout_prob=0.3,
                                  total_anneal_steps=10),
                  dict(loss='logloss'), dict(shuffle='users'), {}),
    'vae_full_catalog': (lambda: MultVAE(16, 8, dropout_prob=0.3),
                         dict(loss='logloss'),
                         dict(shuffle='blocks', negative_sampling=False),
                         dict(seed=3)),
    'vae_sparse': (lambda: MultVAE(12, 8, sparse=True), dict(loss='logloss'),
                   dict(shuffle='users'), dict(seed=4)),
    'custom_loss': (lambda: DynamicAutoencoder([16], 'tanh', noise_prob=0.3),
                    dict(loss=HuberLoss()), dict(shuffle='users'), {}),
    'custom_loss_full': (lambda: MultVAE(16, 8), dict(loss=HuberLoss()),
                         dict(shuffle='blocks', full_decode=True),
                         dict(seed=6)),
    'tables_union': (lambda: DynamicAutoencoder([16], 'tanh', noise_prob=0.3),
                     dict(loss='mse'),
                     dict(shuffle='blocks', full_decode=False,
                          table_sharding='data'), dict(seed=8)),
    'tables_full_decode': (lambda: DynamicAutoencoder([16], 'tanh'),
                           dict(loss='logistic'),
                           dict(shuffle='blocks', full_decode=True,
                                table_sharding='data'), dict(seed=10)),
    'tables_target': (lambda: DynamicAutoencoder([16], 'tanh'),
                      dict(loss='mse'),
                      dict(shuffle='blocks', table_sharding='data'),
                      dict(seed=12, target=True)),
    # (5 blocks: a multiple of no 'data' ways but one)
    'tables_odd_blocks': (lambda: DynamicAutoencoder([16], 'tanh'),
                          dict(loss='mse'),
                          dict(shuffle='blocks', full_decode=False,
                               num_sampling_users=16,
                               table_sharding='data'),
                          dict(seed=14, users=80)),
}


def train_case(name, mesh, prefix, epochs=2):
  """Train case ``name`` (on ``mesh``, or on one device for None) and
  save it under ``prefix``; returns ``(trainer, checkpoint path)``."""
  make, tr_kw, train_kw, data_kw = CASES[name]
  tr = Recoder(make(), optimizer_type='adam', seed=7, mesh=mesh,
               device='cpu', **tr_kw)
  tr.train(dataset(**data_kw), batch_size=16, lr=1e-3, weight_decay=1e-4,
           num_epochs=epochs, **{'negative_sampling': True,
                                 'num_sampling_users': 32, **train_kw})
  return tr, tr.save_state(prefix)


def table_record(tr):
  """The on-device source's layout: ``table_sharding``, the shapes of the
  'blocks' tables and CSR arrays this rank holds beside their whole
  shapes, each side's mega window (the halo of a split CSR array), and
  why the slab declined."""
  source = tr._source_cache[2]
  return {'sharding': source.table_sharding,
          'shapes': source.table_shapes(),
          'halo': {prefix: side['M_mega']
                   for prefix, side in source._static.items()},
          'decline': source.decline_reason}


def shard_shapes(tr):
  """This rank's parameter and moment shapes, by name."""
  shapes = {f'param/{k}': list(v.shape) for k, v in tr.model.params().items()}
  named, _ = tr._split_params()
  for k, p in named.items():
    state = {} if tr.optimizer is None else tr.optimizer.state.get(p, {})
    if 'exp_avg' in state:
      shapes[f'm/{k}'] = list(state['exp_avg'].shape)
  for k, st in tr.sparse_states.items():
    shapes[f'sparse_m/{k}'] = list(st['m'].shape)
  return shapes


def predict_users(n=12, seed=3):
  ds = dataset(seed=seed)
  return UsersInteractions(users=np.arange(n),
                           interactions_matrix=ds.interactions_matrix[:n])


def scoring(tr):
  """``predict`` and ``recommend`` of :func:`predict_users` (the top-k
  through one matrix and in chunks of 64 columns), the validation loss
  and the mean Recall@5 of a held-out set."""
  users = predict_users()
  top = np.asarray(tr.recommend(users, 7))
  tr.eval_item_chunk = 64
  chunked = np.asarray(tr.recommend(users, 7))
  tr.eval_item_chunk = None
  val = dataset(seed=11, target=True)
  loss = tr._validate(RecommendationDataLoader(val, batch_size=16,
                                               negative_sampling=True))
  recall = tr._evaluate(val, 5, [Recall(k=5)], batch_size=16)
  return {'scores': tr.predict(users), 'top': top, 'top_chunked': chunked,
          'val_loss': np.float64(loss),
          'recall': np.float64(np.mean(recall[Recall(k=5)]))}


def slice_trainer(init, mesh=None, vae=False):
  """The slice fixture's port trainer from the JAX init ``init``
  (``{name: array}``, whole), on ``mesh``: the autoencoder, or with
  ``vae`` the Mult-VAE without noise under logloss."""
  if vae:
    tr = Recoder(NoNoiseMultVAE(**VAE_SLICE), optimizer_type='adam',
                 loss='logloss', seed=3, mesh=mesh, device='cpu')
  else:
    tr = Recoder(DynamicAutoencoder(SLICE['hidden'], 'tanh', noise_prob=0.0),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, seed=3, mesh=mesh,
                 device='cpu')
  tr.num_items, tr.num_users = SLICE['items'], SLICE['users']
  tr._init_model()
  if mesh is not None:
    init = sharding.shard_params(init, tr.model, mesh)
  convert.load_params(tr.model, init)
  return tr


def slice_losses(tr):
  """The slice fixture trained one step an epoch; the per-step losses."""
  losses = []
  for epoch in range(1, SLICE['steps'] + 1):
    tr.train(RecommendationDataset(slice_matrix()), num_epochs=epoch,
             batch_size=SLICE['batch'], lr=SLICE['lr'],
             weight_decay=SLICE['wd'], negative_sampling=True,
             shuffle='blocks')
    losses += tr.last_epoch_losses
    # (a later call resumes at current_epoch inclusive, the reference's
    # rule: step past the epoch just trained)
    tr.current_epoch = epoch + 1
  return losses


def run(rank, out, mesh, cases):
  for case in cases:
    if case in ('slice', 'vae_slice'):
      init = dict(np.load(os.path.join(out, f'{case}_init.npz')))
      tr = slice_trainer(init, mesh, vae=case == 'vae_slice')
      losses = slice_losses(tr)
      path = tr.save_state(os.path.join(out, case))
      if rank == 0:
        np.save(os.path.join(out, f'{case}_losses.npy'), np.asarray(losses))
        os.replace(path, os.path.join(out, f'{case}.npz'))
      continue
    if case == 'cli':
      # trainer.mesh_model inside the launch's group
      tr = cli._build_trainer({'trainer': {'device': 'cpu',
                                           'mesh_model': 2}},
                              DynamicAutoencoder([4]))
      with open(os.path.join(out, f'cli_{rank}.json'), 'w') as f:
        json.dump(tr.mesh.shape, f)
      continue
    if case == 'resume':
      # a checkpoint written on the mesh, read back onto it, trained on
      _, path = train_case('ae_users', mesh, os.path.join(out, 'first'))
      back = Recoder(DynamicAutoencoder(), optimizer_type='adam', seed=7,
                     mesh=mesh, device='cpu')
      back.init_from_model_file(path)
      loaded = shard_shapes(back)
      back.train(dataset(), batch_size=16, lr=1e-3, weight_decay=1e-4,
                 num_epochs=3, negative_sampling=True,
                 num_sampling_users=32, shuffle='users')
      shapes = shard_shapes(back)
      done = back.save_state(os.path.join(out, 'resumed'))
      with open(os.path.join(out, f'resume_shapes_{rank}.json'), 'w') as f:
        json.dump({'loaded': loaded, 'trained': shapes, 'first': path,
                   'done': done}, f)
      continue
    if case == 'orbax':
      # the directory checkpoint of a sparse case, written by rank 0 in
      # the background, read back onto the mesh by every rank at once
      tr, npz = train_case('ae_sparse_logloss', mesh,
                           os.path.join(out, 'orbax'))
      directory = tr.save_state(os.path.join(out, 'orbax'), backend='orbax',
                                async_save=True)
      back = Recoder(DynamicAutoencoder(sparse=True), optimizer_type='adam',
                     seed=7, mesh=mesh, device='cpu')
      back.init_from_model_file(directory)
      again = back.save_state(os.path.join(out, 'orbax_reloaded'))
      with open(os.path.join(out, f'orbax_{rank}.json'), 'w') as f:
        json.dump({'npz': npz, 'directory': directory, 'reloaded': again,
                   'shapes': shard_shapes(back)}, f)
      continue
    if case in FIT_CASES:
      FIT_CASES[case](rank, out, mesh)
      continue
    tr, path = train_case(case, mesh, os.path.join(out, case))
    scored = scoring(tr)
    with open(os.path.join(out, f'{case}_shapes_{rank}.json'), 'w') as f:
      json.dump(shard_shapes(tr), f)
    if case.startswith('tables_'):
      with open(os.path.join(out, f'{case}_tables_{rank}.json'), 'w') as f:
        json.dump(table_record(tr), f)
    if rank == 0:
      np.savez(os.path.join(out, f'{case}_scoring.npz'), **scored)


# -- the fits: iALS and EASE on a mesh, and the CLI's mesh_model -----------

#: the iALS fits: tests/test_ials.py's mesh fixture, at a chunk budget
#: whose chunks are smaller than the mesh (2 rows at L = 32)
IALS_KW = dict(embedding_size=6, alpha=8.0, lam=0.05, sweeps=3, seed=4)
IALS_CHUNK = 64
#: tests/test_ease.py's sharded-solve fixture, at an item count that the
#: 'model' ranks split unevenly
EASE_LAM = 25.0


def ials_matrix():
  """tests/test_ials.py's ``_binary_matrix(users=50, items=30, seed=5)``."""
  rng = np.random.default_rng(5)
  return sp.csr_matrix((rng.random((50, 30)) < 0.2).astype(np.float32))


def ease_matrix():
  rng = np.random.default_rng(7)
  return sp.csr_matrix((rng.random((96, 67)) < 0.2).astype(np.float32))


def ials_fit(sharding_mode, mesh=None):
  """The iALS fixture fitted (on ``mesh`` with ``sharding_mode``, or on
  one device)."""
  return IALS(device='cpu', **IALS_KW).fit(
      ials_matrix(), chunk_elems=IALS_CHUNK, mesh=mesh,
      factor_sharding=sharding_mode)


def ials_half_sweeps(model, factors, mesh, sharding_mode):
  """One user and one item half-sweep on ``mesh`` from ``factors`` (whole
  ``{'user_factors', 'item_factors'}``, put in by
  ``convert.ials_factors_from_numpy``): ``(users, items)``, whole."""
  m = ials_matrix()
  convert.ials_factors_from_numpy(model, factors)
  model.mesh, model.factor_sharding = mesh, sharding_mode
  user_half, item_half = model._half_sweeps(m, IALS_CHUNK)
  users = model.user_factors
  if sharding_mode == 'users':
    shards = ials_lib._UserShards(m.shape[0], mesh)
    local = users.new_zeros((shards.per, users.shape[1]))
    local[:shards.valid] = users[shards.lo:shards.lo + shards.valid]
    users = local
  new_users = user_half(model.item_factors)
  new_items = item_half(users)
  if sharding_mode == 'users':
    model.user_factors = new_users
    new_users = model._whole_user_factors()
  return new_users, new_items


def _fit_ials(rank, out, mesh):
  for mode in (None, 'users'):
    name = f'ials_{mode or "rows"}'
    model = ials_fit(mode, mesh)
    objective = model.objective(ials_matrix())
    model.save(os.path.join(out, f'{name}.model'))
    with open(os.path.join(out, f'{name}_{rank}.json'), 'w') as f:
      json.dump({'objective': objective,
                 'user_factors': list(model.user_factors.shape)}, f)
    given = dict(np.load(os.path.join(out, 'ials_given.npz')))
    users, items = ials_half_sweeps(IALS(device='cpu', **IALS_KW), given,
                                    mesh, mode)
    if rank == 0:
      np.savez(os.path.join(out, f'{name}_halves.npz'),
               user_factors=users.numpy(), item_factors=items.numpy())


class LargestTensor(TorchDispatchMode):
  """Records ``rows``: the most rows of a tensor that any torch operation
  (a collective's too) made or filled while the mode was on."""

  rows = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    for t in tree_flatten(out)[0]:
      if torch.is_tensor(t) and t.dim():
        self.rows = max(self.rows, t.shape[0])
    return out


def _fit_ease(rank, out, mesh):
  # (the Gram's rows in user chunks, as on the card)
  model = EASE(lam=EASE_LAM, device='cpu').fit(ease_matrix(), gram='device',
                                               mesh=mesh)
  ui = UsersInteractions(users=np.arange(12),
                         interactions_matrix=ease_matrix()[:12])
  top = model.recommend(ui, 5)
  with LargestTensor() as saved:
    model.save(os.path.join(out, 'ease.model'))
  info = dict(model.fit_info, weights=list(model.item_weights.shape),
              save_rows=saved.rows)
  with open(os.path.join(out, f'ease_{rank}.json'), 'w') as f:
    json.dump(info, f)
  if rank == 0:
    np.save(os.path.join(out, 'ease_top.npy'),
            np.asarray([list(r) for r in top]))


def cli_data(out):
  """A CSV of the iALS fixture's interactions (uid, sid, watched), with
  every item seen."""
  m = ials_matrix().tocoo()
  path = os.path.join(out, 'fit_train.csv')
  pd.DataFrame({'uid': m.row, 'sid': m.col, 'watched': m.data}).to_csv(
      path, index=False)
  return path


def _fit_cli(rank, out, mesh):
  """``cli train`` of ials (both factor shardings), ease and multvae with
  ``trainer.mesh_model`` inside the spawned launch."""
  del rank
  model_ways = mesh.shape['model']
  data = {'train': os.path.join(out, 'fit_train.csv')}
  configs = {
      'cli_ials': {'type': 'ials', 'device': 'cpu', 'chunk_elems': IALS_CHUNK,
                   **IALS_KW},
      'cli_ials_users': {'type': 'ials', 'device': 'cpu',
                         'chunk_elems': IALS_CHUNK,
                         'factor_sharding': 'users', **IALS_KW},
      'cli_ease': {'type': 'ease', 'device': 'cpu', 'lam': EASE_LAM}}
  for name, model_cfg in configs.items():
    cli.cmd_train({'data': data, 'model': model_cfg,
                   'trainer': {'mesh_model': model_ways},
                   'train': {'model_checkpoint_prefix':
                             os.path.join(out, name)}})
  cli.cmd_train({'data': data, 'model': {'type': 'multvae', 'hidden_dim': 8,
                                         'latent_dim': 4},
                 'trainer': {'device': 'cpu', 'mesh_model': model_ways,
                             'optimizer_type': 'adam', 'loss': 'logloss'},
                 'train': {'batch_size': 16, 'num_epochs': 1,
                           'model_checkpoint_prefix':
                               os.path.join(out, 'cli_multvae')}})


FIT_CASES = {'ials': _fit_ials, 'ease': _fit_ease, 'cli_fits': _fit_cli}


def spawn(out, shape, cases, timeout=TIMEOUT):
  """Run ``cases`` on a ``shape`` mesh of spawned gloo ranks; raise with
  the ranks' tracebacks if one fails, and kill them all past
  ``timeout`` seconds."""
  os.makedirs(out, exist_ok=True)
  ctx = multiprocessing.get_context('spawn')
  world = shape[0] * shape[1]
  procs = [ctx.Process(target=main, args=(rank, world, out, shape, cases))
           for rank in range(world)]
  for p in procs:
    p.start()
  deadline = time.time() + timeout
  for p in procs:
    p.join(max(0.0, deadline - time.time()))
  hung = [p for p in procs if p.is_alive()]
  for p in procs:
    if p.is_alive():
      p.kill()
      p.join()
  errors = [open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out)) if f.startswith('error_')]
  assert not hung, f'{shape} mesh: {len(hung)} rank(s) hung past {timeout} s'
  assert all(p.exitcode == 0 for p in procs), '\n'.join(errors)


def main(rank, world, out, shape, cases):
  """One spawned rank: join the gloo group of ``world`` ranks, build the
  ``shape`` mesh and run ``cases`` (see :func:`run`)."""
  try:
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        'gloo', init_method=f'file://{os.path.join(out, "store")}',
        rank=rank, world_size=world)
    mesh = make_mesh(MeshConfig(*shape), devices='cpu')
    run(rank, out, mesh, cases)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
  except BaseException:
    with open(os.path.join(out, f'error_{rank}.txt'), 'w') as f:
      f.write(traceback.format_exc())
    raise
