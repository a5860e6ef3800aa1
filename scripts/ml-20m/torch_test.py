"""Evaluate an ML-20M checkpoint on the test split with the PyTorch port,
via model inference or ANN item-item similarity (the port of
scripts/ml-20m/test.py; ``--device cpu`` runs the model on the CPU)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/ml-20m/pro_sg/')
  p.add_argument('--model-file', required=True)
  p.add_argument('--method', choices=['inference', 'similarity'],
                 default='inference')
  p.add_argument('--index-file', default=None,
                 help='ANN index file (similarity method); default '
                      '<model-file>.index')
  p.add_argument('--num-recommendations', type=int, default=100)
  p.add_argument('--batch-size', type=int, default=500)
  p.add_argument('--device', default='cuda',
                 help="where the model runs: 'cuda' (the card) or 'cpu'")
  args = p.parse_args()

  return pipelines.test(args)


if __name__ == '__main__':
  main()
