"""The port stands without JAX: with ``jax`` blocked from import, every
module of ``recoder_tpu_torch`` imports, a tiny training step and a tiny
iALS fit, fold-in and recommend run on the CPU, and afterwards neither
JAX nor the JAX package is loaded."""

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
                 loss_params={'confidence': 3})
    tr.train(RecommendationDataset(m), batch_size=8, num_epochs=1,
             negative_sampling=True)
    assert len(tr.last_epoch_losses) == 3
    assert all(np.isfinite(tr.last_epoch_losses))
    from recoder_tpu_torch.data import UsersInteractions
    from recoder_tpu_torch.models import IALS
    ials = IALS(embedding_size=4, sweeps=2).fit(m, chunk_elems=1 << 10)
    ui = UsersInteractions(np.arange(20), m)
    assert (ials.fold_in(ui) == ials.user_factors).all()
    assert all(len(r) == 3 for r in ials.recommend(ui, 3))
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
