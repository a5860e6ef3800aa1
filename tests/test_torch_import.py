"""The port stands without JAX: with ``jax`` blocked from import, every
module of ``recoder_tpu_torch`` imports, a tiny training step (float32,
and bf16 compute with bf16 moments), the synthetic data, a tiny
iALS fit, fold-in and recommend, a sparse-table and a dense union
training, target training with validation through the host loader and
the dual CSRs, a row scatter, a training from the bit-packed slab and its
row unpack run on the CPU, MatrixFactorization (dense and sparse) and
Mult-VAE train, EASE fits and recommends, the Mult-VAE protocol runs, a
brute-force index answers a query, the C++ ANN forest builds (from the
port's own source) and serves the similarity recommender, every
``scripts/**/torch_*.py`` imports, the ML-20M pipeline (preprocess, 10
epochs, a directory checkpoint, test) and the stress script run at a
tiny size, and afterwards neither JAX nor the JAX package is loaded."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent('''
    import importlib, pkgutil, sys
    sys.modules['jax'] = None
    sys.modules['jaxlib'] = None
    import numpy as np, scipy.sparse as sp
    import recoder_tpu_torch
    for info in pkgutil.walk_packages(recoder_tpu_torch.__path__,
                                      'recoder_tpu_torch.'):
        importlib.import_module(info.name)
    from recoder_tpu_torch.data import RecommendationDataset
    from recoder_tpu_torch.model import Recoder
    from recoder_tpu_torch.models import DynamicAutoencoder
    m = sp.csr_matrix((np.random.default_rng(0).random((20, 30)) < 0.2)
                      .astype(np.float32))
    tr = Recoder(DynamicAutoencoder([8], noise_prob=0.5),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device='cpu')
    tr.train(RecommendationDataset(m), batch_size=8, num_epochs=1,
             negative_sampling=True)
    assert len(tr.last_epoch_losses) == 3
    assert all(np.isfinite(tr.last_epoch_losses))
    tr = Recoder(DynamicAutoencoder([8], noise_prob=0.5,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='mse', device='cpu',
                 opt_state_dtype='bfloat16')
    tr.train(RecommendationDataset(m), batch_size=8, num_epochs=1,
             negative_sampling=True)
    assert all(np.isfinite(tr.last_epoch_losses))
    from recoder_tpu_torch.data import synthetic
    assert synthetic.synthesize(50, 20, 6).shape == (50, 20)
    from recoder_tpu_torch.data import UsersInteractions
    from recoder_tpu_torch.models import IALS
    ials = IALS(embedding_size=4, sweeps=2, device='cpu').fit(
        m, chunk_elems=1 << 10)
    ui = UsersInteractions(np.arange(20), m)
    assert (ials.fold_in(ui) == ials.user_factors).all()
    assert all(len(r) == 3 for r in ials.recommend(ui, 3))
    for sparse in (True, False):
        tr = Recoder(DynamicAutoencoder([8], noise_prob=0.5, sparse=sparse),
                     optimizer_type='adam', loss='logloss', device='cpu')
        tr.train(RecommendationDataset(m), batch_size=8, num_epochs=2,
                 negative_sampling=True, shuffle='users', full_decode=False)
        assert all(np.isfinite(tr.last_epoch_losses))
        assert len(tr.sparse_states) == (2 if sparse else 0)
    from recoder_tpu_torch.ops.row_scatter import row_scatter_
    import torch
    t = torch.zeros(4, 3)
    row_scatter_([t], torch.tensor([2]), [torch.ones(1, 3)])
    assert t.sum() == 3
    tr = Recoder(DynamicAutoencoder([8], noise_prob=0.5,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logloss', device='cpu',
                 opt_state_dtype='bfloat16')
    tr.train(RecommendationDataset(m), batch_size=8, num_epochs=1,
             negative_sampling=True, slab_cache='packed', full_decode=True)
    assert tr.fused_data_source._slab_packed
    assert all(np.isfinite(tr.last_epoch_losses))
    from recoder_tpu_torch.metrics import Recall
    t = sp.csr_matrix((np.random.default_rng(1).random((20, 30)) < 0.1)
                      .astype(np.float32))
    for shuffle in ('users', 'blocks'):
        tr = Recoder(DynamicAutoencoder([8], noise_prob=0.5),
                     optimizer_type='adam', loss='mse', device='cpu')
        tr.train(RecommendationDataset(m, t), batch_size=8, num_epochs=2,
                 negative_sampling=True, shuffle=shuffle,
                 val_dataset=RecommendationDataset(t, m), eval_freq=1,
                 metrics=[Recall(5)], eval_num_recommendations=5)
        assert all(np.isfinite(tr.last_epoch_losses))
    from recoder_tpu_torch.ops.packed_rows import unpack_rows
    rows, col_mask = unpack_rows(torch.tensor([[-1]], dtype=torch.int32), 31,
                                 start=0, count=1)
    assert rows.sum() == 32 and col_mask.sum() == 31
    from recoder_tpu_torch.models import EASE, MatrixFactorization, MultVAE
    from recoder_tpu_torch.protocols import evaluate_vae_protocol
    for model, loss in ((MatrixFactorization(8, 'tanh', 0.2), 'mse'),
                        (MatrixFactorization(8, sparse=True), 'mse'),
                        (MultVAE(16, 4, total_anneal_steps=5), 'logloss')):
        tr = Recoder(model, optimizer_type='adam', loss=loss, device='cpu')
        tr.train(RecommendationDataset(m), batch_size=8, num_epochs=1,
                 negative_sampling=True)
        assert all(np.isfinite(tr.last_epoch_losses))
    summary = evaluate_vae_protocol(tr, RecommendationDataset(t, m),
                                    batch_size=8)
    assert np.isfinite(summary['HeldoutMultinomialNLL'])
    ease = EASE(lam=5.0, device='cpu').fit(m)
    assert all(len(r) == 3 for r in ease.recommend(ui, 3))
    from recoder_tpu_torch.embedding import (AnnEmbeddingsIndex,
                                             BruteForceEmbeddingsIndex)
    from recoder_tpu_torch.recommender import SimilarityRecommender
    emb = np.random.default_rng(2).normal(size=(30, 8)).astype(np.float32)
    brute = BruteForceEmbeddingsIndex(emb, device='cpu')
    brute.build()
    assert brute.get_nns_by_ids([4, 9], 3)[1][0] == 9
    index = AnnEmbeddingsIndex(emb, n_trees=3)
    index.build()
    assert index.get_nns_by_id(4, 3)[0] == 4
    recs = SimilarityRecommender(index, 3, n=5).recommend(ui)
    assert len(recs) == 20 and all(len(r) <= 3 for r in recs)
    import glob, os, runpy, tempfile
    import pandas as pd
    from recoder_tpu_torch.checkpoint_orbax import wait_for_pending_saves
    scripts = sorted(glob.glob('scripts/**/torch_*.py', recursive=True))
    assert len(scripts) == 12, scripts
    for path in scripts:
        runpy.run_path(path)
    def script(path, *argv):
        old = sys.argv
        sys.argv = [path, *argv]
        try:
            return runpy.run_path(path)['main']()
        finally:
            sys.argv = old
    work = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    pd.DataFrame({'userId': rng.integers(1, 200, 6000),
                  'movieId': rng.integers(1, 80, 6000),
                  'rating': 5.0, 'timestamp': 0}).drop_duplicates(
        ['userId', 'movieId']).to_csv(os.path.join(work, 'ratings.csv'),
                                      index=False)
    script('scripts/ml-20m/torch_preprocess.py', '--data-dir', work,
           '--heldout-users', '20')
    data = os.path.join(work, 'pro_sg') + '/'
    tr = script('scripts/ml-20m/torch_train.py', '--data-dir', data,
                '--model-dir', work, '--epochs', '10', '--device', 'cpu')
    ckpt = tr.save_state(os.path.join(work, 'dir'), backend='orbax')
    wait_for_pending_saves()
    results = script('scripts/ml-20m/torch_test.py', '--data-dir', data,
                     '--model-file', ckpt, '--device', 'cpu')
    assert len(results) == 3
    script('scripts/torch_stress_scale.py', '--cpu', '--items', '500',
           '--dim', '8', '--users', '100', '--ann-items', '50')
    loaded = [k for k, v in sys.modules.items() if v is not None and (
        k in ('jax', 'jaxlib', 'recoder_tpu') or k.startswith(
            ('jax.', 'jaxlib.', 'recoder_tpu.')))]
    assert not loaded, loaded
    print('OK')
''')


def test_port_imports_and_trains_without_jax():
  env = dict(os.environ)
  env['PYTHONPATH'] = os.pathsep.join(
      [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep) if p])
  proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert proc.stdout.strip().endswith('OK')
