"""Scale stress with the PyTorch port (the port of scripts/stress_scale.py):
a synthetic multi-million-item catalog, sparse row-wise Adam updates, and
an ANN index build over the trained item embeddings.

At its defaults (10M items x 128, float32 tables, sparse Adam) the two
tables (2 x 4.77 GiB), their Adam moments (19.07 GiB) and the bias and
its moments take about 28.7 GiB: one 80 GB H100 holds them.

  python scripts/torch_stress_scale.py

The mesh flags run under torchrun, one process a card (a mesh turns the
sparse tables off, as the JAX script does):

  torchrun --nproc_per_node=4 scripts/torch_stress_scale.py \\
      --items 10000000 --mesh-model 4

On the CPU, at small shapes (two gloo ranks splitting the 'blocks'
tables over 'data'):

  python scripts/torch_stress_scale.py --items 2000 --dim 16 --users 200 --cpu
  torchrun --nproc_per_node=2 scripts/torch_stress_scale.py --cpu \\
      --items 2000 --dim 16 --users 200 --mesh-data 2 --shuffle blocks \\
      --table-sharding data --verify-replicated
"""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse
import time

import numpy as np
from scipy.sparse import csr_matrix


def parser():
  p = argparse.ArgumentParser(
      description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
  p.add_argument('--items', type=int, default=10_000_000)
  p.add_argument('--users', type=int, default=20_000)
  p.add_argument('--items-per-user', type=int, default=50)
  p.add_argument('--dim', type=int, default=128)
  p.add_argument('--mesh-model', type=int, default=0)
  p.add_argument('--epochs', type=int, default=2)
  p.add_argument('--batch-size', type=int, default=500)
  p.add_argument('--sparse', action='store_true', default=True)
  p.add_argument('--constrained', action='store_true',
                 help='tie the decoder to the encoder (one table '
                      'instead of two: halves the table and moment '
                      'bytes)')
  p.add_argument('--optimizer', default='adam',
                 help='optimizer (the sparse path requires adam: '
                      'row-sparse Adam keeps two moments a table row, so '
                      'a table takes three times its bytes)')
  p.add_argument('--cpu', action='store_true',
                 help="run on the CPU (device='cpu'; a mesh over gloo)")
  p.add_argument('--ann-items', type=int, default=200_000,
                 help='items to index with the C++ ANN forest')
  p.add_argument('--mesh-data', type=int, default=0,
                 help="mesh 'data' axis size (enables blocks-mode "
                      "sharded table storage)")
  p.add_argument('--shuffle', choices=['users', 'blocks'],
                 default='users',
                 help="sampling mode; 'blocks' is required for "
                      "'data'-sharded table storage")
  p.add_argument('--table-sharding', choices=['auto', 'data', 'none'],
                 default='auto',
                 help="storage layout of the blocks-mode resident "
                      "CSR/tables on the mesh (see DeviceDataSource)")
  p.add_argument('--params-dtype', choices=['float32', 'bfloat16'],
                 default='float32',
                 help="parameter STORAGE dtype. With --opt-state-dtype "
                      "bfloat16 the resident optimizer bytes drop "
                      "from 12 to 6 per parameter (p+m+v)")
  p.add_argument('--opt-state-dtype', choices=['float32', 'bfloat16'],
                 default='float32',
                 help="Adam moment storage dtype (see Recoder)")
  p.add_argument('--compute-dtype',
                 choices=['auto', 'float32', 'bfloat16'], default='auto',
                 help="matmul compute dtype. 'auto' follows the model "
                      "default: params_dtype when that is set, else "
                      "float32")
  p.add_argument('--verify-replicated', action='store_true',
                 help="train a second, identically-seeded run with "
                      "replicated tables and assert the final params "
                      "match the sharded run within atol=2e-5 (the "
                      "'data'-split fetch adds one owner's rows to "
                      "zeros, so they are expected to be equal)")
  return p


def synthetic_matrix(users, items, items_per_user, rng):
  """The stress catalog: ``items_per_user`` uniform item draws a user
  from ``rng`` (duplicates summed), as the JAX script draws it."""
  rows = np.repeat(np.arange(users), items_per_user)
  cols = rng.integers(0, items, len(rows))
  m = csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                 shape=(users, items))
  m.sum_duplicates()
  return m


def check_shard_bytes(source):
  """Every 'data'-split array of ``source`` holds 1/ways of its bytes
  (within one padded block row, or a flat chunk's halo); the replicated
  remainder counts in full. Returns ``(total, held, sharded total)``."""
  ways = source.mesh.shape['data']
  total = held = sharded_total = 0
  for name, (mine, whole, slack) in source.shard_bytes().items():
    total += whole
    held += mine
    if slack:
      sharded_total += whole
      if not whole / ways <= mine <= whole / ways + slack:
        raise AssertionError(f'{name}: {mine} bytes held of {whole} '
                             f'split {ways} ways (slack {slack})')
    elif mine != whole:
      raise AssertionError(f'{name}: replicated, {mine} of {whole} bytes')
  if sharded_total == 0:
    raise AssertionError('table_sharding engaged but nothing sharded')
  return total, held, sharded_total


def item_table(trainer, key, n):
  """The first ``n`` rows of table ``key`` as float32 numpy (gathered
  over 'model' where a mesh splits it)."""
  table = trainer.model.params()[key].detach()
  if trainer.mesh is not None and key in trainer._whole_rows:
    return trainer._gather_rows(key, table.float().cpu().numpy())[:n]
  return table[:n].float().cpu().numpy()


def main(argv=None):
  args = parser().parse_args(argv)
  device = 'cpu' if args.cpu else 'cuda'

  import torch

  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.embedding import AnnEmbeddingsIndex
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  rng = np.random.default_rng(0)
  m = synthetic_matrix(args.users, args.items, args.items_per_user, rng)
  ds = RecommendationDataset(m)
  print(f'{args.users:,} users x {args.items:,} items, nnz={m.nnz:,}')

  mesh = None
  if args.mesh_model > 0 or args.mesh_data > 0:
    from recoder_tpu_torch import parallel
    parallel.initialize(device=device)  # torchrun's group, if it made one
    # data=None puts the ranks left over on the data axis (e.g.
    # --mesh-model 4 on 8 ranks -> data=2)
    mesh = parallel.make_mesh(parallel.MeshConfig(
        data=args.mesh_data or None, model=max(args.mesh_model, 1)),
        devices=device)
    print('mesh:', mesh.shape)

  table_sharding = (None if args.table_sharding == 'none'
                    else args.table_sharding)
  train_kw = dict(batch_size=args.batch_size, negative_sampling=True,
                  shuffle=args.shuffle, table_sharding=table_sharding)

  pd = None if args.params_dtype == 'float32' else args.params_dtype
  osd = (None if args.opt_state_dtype == 'float32'
         else args.opt_state_dtype)
  cd = None if args.compute_dtype == 'auto' else args.compute_dtype
  model = DynamicAutoencoder(hidden_layers=[args.dim],
                             activation_type='tanh',
                             is_constrained=args.constrained,
                             sparse=args.sparse and mesh is None,
                             params_dtype=pd, compute_dtype=cd)
  trainer = Recoder(model=model, optimizer_type=args.optimizer,
                    loss='logistic', mesh=mesh, opt_state_dtype=osd,
                    device=device)
  on_card = trainer.device.type == 'cuda'

  def synced_train(num_epochs):
    """train(), then wait for the card to finish the queued steps."""
    t0 = time.time()
    trainer.train(train_dataset=ds, num_epochs=num_epochs, **train_kw)
    if on_card:
      torch.cuda.synchronize(trainer.device)
    return time.time() - t0

  if on_card:
    torch.cuda.reset_peak_memory_stats(trainer.device)
  steps_per_epoch = -(-args.users // args.batch_size)
  dt = synced_train(args.epochs)
  print(f'warm train to epoch {args.epochs} in {dt:.1f}s '
        f'(includes the kernel builds and graph captures; table '
        f'{model.num_items_padded:,} x {args.dim})')
  # steady state: resume re-runs the last epoch, then runs new ones
  timed = 3
  dt = synced_train(args.epochs + timed - 1)
  print(f'steady state: {timed} epochs x {steps_per_epoch} steps in '
        f'{dt:.1f}s = {1000 * dt / (timed * steps_per_epoch):.1f} '
        f'ms/step')
  if on_card:
    peak = torch.cuda.max_memory_allocated(trainer.device)
    print(f'peak device memory allocated: {peak / 2**30:.2f} GiB')

  # per-rank byte arithmetic of the 'data'-sharded resident arrays
  source = trainer.fused_data_source
  if source is not None and source.table_sharding is not None:
    ways = source.mesh.shape['data']
    total, held, sharded_total = check_shard_bytes(source)
    print(f'resident source arrays: {total / 2**20:.1f} MiB total, '
          f'{held / 2**20:.1f} MiB on this rank '
          f'({sharded_total / 2**20:.1f} MiB sharded {ways}-way)')
    print(f'per-rank byte arithmetic OK: replicated '
          f'{(total - sharded_total) / 2**20:.1f} MiB + sharded/'
          f'{ways} {(sharded_total / ways) / 2**20:.1f} MiB')

  if args.verify_replicated:
    print('verify: re-training with replicated tables (same seed)...')
    model_r = DynamicAutoencoder(hidden_layers=[args.dim],
                                 activation_type='tanh',
                                 is_constrained=args.constrained,
                                 sparse=False)
    trainer_r = Recoder(model=model_r, optimizer_type=args.optimizer,
                        loss='logistic', mesh=mesh, device=device)
    kw = dict(train_kw, table_sharding=None)
    # the sharded run's two-call schedule: a resume re-runs the last
    # completed epoch, so one train() to the same epoch takes fewer steps
    trainer_r.train(train_dataset=ds, num_epochs=args.epochs, **kw)
    trainer_r.train(train_dataset=ds, num_epochs=args.epochs + 2, **kw)
    assert trainer_r.fused_data_source.table_sharding is None
    worst = 0.0
    params_r = model_r.params()
    for k, v in model.params().items():
      a = v.detach().float().cpu().numpy()
      b = params_r[k].detach().float().cpu().numpy()
      worst = max(worst, float(np.max(np.abs(a - b))))
      np.testing.assert_allclose(a, b, rtol=0, atol=2e-5, err_msg=k)
    print(f'verify OK: sharded-table params == replicated params '
          f'(max |diff| = {worst:.2e})')

  n_index = min(args.ann_items, args.items)
  if n_index <= 0:
    return trainer
  de_key = ('en_embedding' if args.constrained else 'de_embedding')
  table = item_table(trainer, de_key, n_index)
  t0 = time.time()
  index = AnnEmbeddingsIndex(embeddings=table, n_trees=10)
  index.build()
  print(f'ANN forest over {n_index:,} items built in '
        f'{time.time() - t0:.1f}s')
  q = int(rng.integers(n_index))
  print('sample neighbors of item', q, '->', index.get_nns_by_id(q, 5))
  return trainer


if __name__ == '__main__':
  main()
