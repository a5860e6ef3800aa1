"""Mesh training cases of ``tests/test_torch_mesh.py``, run in spawned gloo
ranks on the CPU (and, without a mesh, in the test process).

It imports no jax: each spawned rank imports only this module and the
port. A rank joins a gloo group through a file store, builds the mesh,
runs the cases in order -- every rank the same program on the same data,
as a torchrun launch does -- and writes each case's result where the
test reads it: the npz checkpoint that ``Recoder.save_state`` writes on
rank 0 (the whole parameters and moments, gathered), and every rank's
shard shapes. Any exception is written to ``error_<rank>.txt``.
"""

import json
import os
import traceback

import numpy as np
import scipy.sparse as sp
import torch

from recoder_tpu_torch import convert
from recoder_tpu_torch import cli
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.data.loader import RecommendationDataLoader
from recoder_tpu_torch.metrics import Recall
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
from recoder_tpu_torch.parallel import MeshConfig, make_mesh
from recoder_tpu_torch.parallel import sharding

#: the JAX slice fixture (tests/test_torch_slice.py): users <= batch
SLICE = dict(users=40, items=120, batch=64, hidden=[16], lr=1e-2, wd=1e-3,
             steps=4)


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
}


def train_case(name, mesh, prefix, epochs=2):
  """Train case ``name`` (on ``mesh``, or on one device for None) and
  save it under ``prefix``; returns ``(trainer, checkpoint path)``."""
  make, tr_kw, train_kw, data_kw = CASES[name]
  tr = Recoder(make(), optimizer_type='adam', seed=7, mesh=mesh,
               device='cpu', **tr_kw)
  tr.train(dataset(**data_kw), batch_size=16, lr=1e-3, weight_decay=1e-4,
           num_epochs=epochs, negative_sampling=True, num_sampling_users=32,
           **train_kw)
  return tr, tr.save_state(prefix)


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


def slice_trainer(init, mesh=None):
  """The slice fixture's port trainer from the JAX init ``init``
  (``{name: array}``, whole), on ``mesh``."""
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
    if case == 'slice':
      init = dict(np.load(os.path.join(out, 'slice_init.npz')))
      tr = slice_trainer(init, mesh)
      losses = slice_losses(tr)
      path = tr.save_state(os.path.join(out, 'slice'))
      if rank == 0:
        np.save(os.path.join(out, 'slice_losses.npy'), np.asarray(losses))
        os.replace(path, os.path.join(out, 'slice.npz'))
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
    tr, path = train_case(case, mesh, os.path.join(out, case))
    scored = scoring(tr)
    with open(os.path.join(out, f'{case}_shapes_{rank}.json'), 'w') as f:
      json.dump(shard_shapes(tr), f)
    if rank == 0:
      np.savez(os.path.join(out, f'{case}_scoring.npz'), **scored)


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
