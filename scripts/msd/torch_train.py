"""Train the MSD autoencoder with the PyTorch port (the port of
scripts/msd/train.py; config: DynamicAutoencoder[200] tanh, noise 0.5,
logistic loss, sparse row-wise updates, adam, bs 500, 100 epochs,
milestones [60, 80]; ``--device cpu`` trains on the CPU)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/msd/pro_sg/')
  p.add_argument('--model-dir', default='models/msd/')
  p.add_argument('--loss', default='logistic')
  p.add_argument('--epochs', type=int, default=100)
  p.add_argument('--batch-size', type=int, default=500)
  p.add_argument('--lr', type=float, default=1e-3)
  p.add_argument('--weight-decay', type=float, default=2e-5)
  p.add_argument('--no-sparse', action='store_true',
                 help='disable sparse row-wise embedding updates')
  p.add_argument('--compute-dtype', default=None)
  p.add_argument('--resume', default=None)
  p.add_argument('--device', default='cuda',
                 help="where the model runs: 'cuda' (the card) or 'cpu'")
  args = p.parse_args()

  from recoder_tpu_torch.models import DynamicAutoencoder
  model = DynamicAutoencoder(hidden_layers=[200], activation_type='tanh',
                             noise_prob=0.5, sparse=not args.no_sparse,
                             compute_dtype=args.compute_dtype)
  return pipelines.train(args, model, lr_milestones=[60, 80])


if __name__ == '__main__':
  main()
