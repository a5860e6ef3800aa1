"""Extract item embeddings from a trained checkpoint with the PyTorch
port and build an index for the SimilarityRecommender.

The port's counterpart of scripts/build_embeddings.py: the checkpoint
(an npz written by either package) is restored into the port's Recoder
on ``--device`` (the card by default), the item table is read off it
(float32, padding trimmed) and the index is written:

  python scripts/torch_build_embeddings.py --model-file run_epoch_10.model \
      [--index-type ann|brute] [--n-trees 10] [--device cuda|cpu]

An ANN index is the C++ forest (host); a brute-force index keeps its
normalized table on ``--device`` when it is loaded for queries.
"""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

from recoder_tpu_torch.embedding import (AnnEmbeddingsIndex,
                                         BruteForceEmbeddingsIndex,
                                         build_embeddings_index)
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--model-file', required=True)
  p.add_argument('--model', choices=['autoencoder', 'mf'],
                 default='autoencoder')
  p.add_argument('--index-file', default=None,
                 help='output path (default: <model-file>.index)')
  p.add_argument('--index-type', choices=['ann', 'brute'], default='ann')
  p.add_argument('--n-trees', type=int, default=10)
  p.add_argument('--device', default='cuda',
                 help="where the checkpoint is restored (and a brute-force "
                      "index's table placed): 'cuda' or 'cpu'")
  args = p.parse_args()

  model = (DynamicAutoencoder() if args.model == 'autoencoder'
           else MatrixFactorization(embedding_size=1))
  recoder = Recoder(model, device=args.device)
  recoder.init_from_model_file(args.model_file)

  if args.index_type == 'ann':
    index_cls, kw = AnnEmbeddingsIndex, {'n_trees': args.n_trees}
  else:
    index_cls, kw = BruteForceEmbeddingsIndex, {'device': args.device}
  index = build_embeddings_index(recoder, index_class=index_cls, **kw)

  out = args.index_file or args.model_file + '.index'
  # rebuild with persistence (build_embeddings_index built in memory)
  index.build(index_file=out)
  print(f'index for {index.embeddings.shape[0]} items written to {out}')
  return index


if __name__ == '__main__':
  main()
