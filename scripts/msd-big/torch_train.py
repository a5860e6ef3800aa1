"""Train the msd-big autoencoder with the PyTorch port (the port of
scripts/msd-big/train.py: logloss, 80 epochs, milestones [60, 70], bf16
compute), with optional multi-GPU item-axis sharding: under
``torchrun --nproc_per_node=N``, ``--mesh-model M`` row-splits the
embedding tables over M ranks of the mesh's 'model' axis and the other
ranks form its 'data' axis. ``--device cpu`` trains on the CPU (a mesh
then runs over gloo)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/msd-big/pro_sg/')
  p.add_argument('--model-dir', default='models/msd-big/')
  p.add_argument('--loss', default='logloss')
  p.add_argument('--epochs', type=int, default=80)
  p.add_argument('--batch-size', type=int, default=500)
  p.add_argument('--lr', type=float, default=1e-3)
  p.add_argument('--weight-decay', type=float, default=2e-5)
  p.add_argument('--sparse', action='store_true', default=True,
                 help='sparse row-wise embedding updates (recommended '
                      'at ~1M-item catalogs)')
  p.add_argument('--mesh-model', type=int, default=0,
                 help='item-axis model-parallel ways (0 = one process, '
                      'no mesh); the remaining ranks become the data '
                      'axis')
  p.add_argument('--compute-dtype', default='bfloat16')
  p.add_argument('--random-negatives', type=int, default=0,
                 help='extra uniform-random negative items per step '
                      '(union-coverage knob for this catalog scale; '
                      'see docs/tutorial.md section 3)')
  p.add_argument('--resume', default=None)
  p.add_argument('--device', default='cuda',
                 help="where the model runs: 'cuda' (the card) or 'cpu'")
  args = p.parse_args()

  mesh = None
  if args.mesh_model > 0:
    mesh = pipelines.make_mesh(args.device, model=args.mesh_model)

  from recoder_tpu_torch.models import DynamicAutoencoder
  model = DynamicAutoencoder(hidden_layers=[200], activation_type='tanh',
                             noise_prob=0.5, sparse=args.sparse,
                             compute_dtype=args.compute_dtype)
  return pipelines.train(args, model, lr_milestones=[60, 70], mesh=mesh,
                         num_random_negatives=args.random_negatives)


if __name__ == '__main__':
  main()
