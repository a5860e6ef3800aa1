"""The port's scripts against their JAX twins under ``scripts/``.

Each JAX script has a ``torch_`` twin beside it (loaded here by path:
the directory names have hyphens):

* flags -- each twin's parser has the JAX script's actions (names,
  types, defaults, choices); the only addition allowed is ``--device``
  on the scripts that run a model (``PORT_FLAGS``);
* preprocess -- on a small synthetic ``ratings.csv`` (ML-20M) and
  ``train_triplets.txt`` (MSD, msd-big) the port writes CSVs byte-equal
  to the JAX script's;
* ML-20M train and test -- ``torch_train.py --device cpu`` trains 10
  epochs on a small split, writes ``_epoch_10.model`` and logs the
  validation; the JAX ``test.py`` and the port's ``torch_test.py`` on
  that checkpoint print the same metrics within 1e-5, by inference and
  by similarity over the port's ANN index;
* msd-big's ``--mesh-model 1`` (a one-rank gloo group) trains bitwise
  the run without a mesh;
* stress -- ``torch_stress_scale.py --cpu`` runs at 2,000 items x 16,
  and on 2 gloo ranks with ``--mesh-data 2 --shuffle blocks
  --table-sharding data --verify-replicated``, the per-rank byte check
  passing; its synthetic CSR is bitwise the JAX script's.
"""

import argparse
import contextlib
import glob
import io
import logging
import os
import runpy
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'scripts')
#: every JAX script and its twin
TWINS = sorted(p for p in glob.glob(os.path.join(SCRIPTS, '**', '*.py'),
                                    recursive=True)
               if not os.path.basename(p).startswith('torch_'))
#: flags only the port has, by the twin's name
PORT_FLAGS = {'train.py': {'--device'}, 'test.py': {'--device'},
              'build_embeddings.py': {'--device'}}


def _twin(path):
  return os.path.join(os.path.dirname(path),
                      'torch_' + os.path.basename(path))


class _Parsed(Exception):
  def __init__(self, parser):
    super().__init__()
    self.parser = parser


def _parser(path):
  """The argparse parser ``path``'s ``main`` builds (stopped at
  ``parse_args``)."""
  def stop(self, *args, **kwargs):
    raise _Parsed(self)
  main = runpy.run_path(path)['main']
  with mock.patch.object(argparse.ArgumentParser, 'parse_args', stop):
    try:
      main()
    except _Parsed as parsed:
      return parsed.parser
  raise AssertionError(f'{path} parsed no arguments')


def _actions(parser):
  return {a.option_strings[0]: (a.dest, type(a).__name__, a.type, a.default,
                                a.choices, a.nargs, a.const, a.required)
          for a in parser._actions if a.option_strings[0] != '-h'}


def _main(path, argv):
  """``path``'s ``main()`` under ``argv``; ``(what it returned, its
  standard output)``."""
  main = runpy.run_path(path)['main']
  out = io.StringIO()
  with mock.patch.object(sys, 'argv', [path] + argv), \
      contextlib.redirect_stdout(out):
    returned = main()
  return returned, out.getvalue()


def _metrics(text):
  return {name: float(value) for name, _, value in
          (line.rpartition(': ') for line in text.splitlines()) if '@' in name}


def test_every_jax_script_has_a_twin():
  assert len(TWINS) == 11
  for path in TWINS:
    assert os.path.isfile(_twin(path)), path


@pytest.mark.parametrize('path', TWINS,
                         ids=lambda p: os.path.relpath(p, SCRIPTS))
def test_flags_match_the_jax_script(path):
  want = _actions(_parser(path))
  got = _actions(_parser(_twin(path)))
  extra = PORT_FLAGS.get(os.path.basename(path), set())
  assert set(got) - set(want) == extra
  assert {k: v for k, v in got.items() if k not in extra} == want


def _ratings(directory, users=600, items=300, n=30000, seed=0):
  rng = np.random.default_rng(seed)
  frame = pd.DataFrame({
      'userId': rng.integers(1, users + 1, n),
      'movieId': np.floor(items * rng.random(n) ** 2).astype(int) + 1,
      'rating': rng.choice([1.0, 2.5, 3.5, 4.0, 5.0], n),
      'timestamp': rng.integers(0, 10 ** 9, n)})
  frame.drop_duplicates(['userId', 'movieId']).to_csv(
      os.path.join(directory, 'ratings.csv'), index=False)


def _triplets(directory, users=400, items=200, n=20000, seed=1):
  rng = np.random.default_rng(seed)
  frame = pd.DataFrame({
      'user': [f'u{u:05d}' for u in rng.integers(0, users, n)],
      'song': [f's{i:04d}' for i in
               np.floor(items * rng.random(n) ** 2).astype(int)],
      'count': rng.integers(1, 9, n)}).drop_duplicates(['user', 'song'])
  frame.to_csv(os.path.join(directory, 'train_triplets.txt'), sep='\t',
               header=False, index=False)


def _split(directory, dataset, heldout=50, extra=()):
  """Write the raw file of ``dataset`` and run both packages' preprocess
  scripts on it; returns the two ``pro_sg`` directories."""
  outs = []
  for name in ('preprocess.py', 'torch_preprocess.py'):
    raw = os.path.join(directory, name.split('.')[0])
    os.makedirs(raw)
    (_ratings if dataset == 'ml-20m' else _triplets)(raw)
    _main(os.path.join(SCRIPTS, dataset, name),
          ['--data-dir', raw, '--heldout-users', str(heldout), *extra])
    outs.append(os.path.join(raw, 'pro_sg'))
  return outs


@pytest.mark.parametrize('dataset,extra', [
    ('ml-20m', ()), ('msd', ('--min-uc', '3', '--min-sc', '5')),
    ('msd-big', ('--min-uc', '3', '--min-sc', '2'))])
def test_preprocess_writes_the_jax_csvs(tmp_path, dataset, extra):
  want, got = _split(str(tmp_path), dataset, extra=extra)
  names = sorted(os.listdir(want))
  assert names == sorted(os.listdir(got))
  assert {'train.csv', 'test_te.csv', 'validation_tr.csv'} <= set(names)
  for name in names:
    with open(os.path.join(want, name), 'rb') as a, \
        open(os.path.join(got, name), 'rb') as b:
      assert a.read() == b.read(), name


def test_ml20m_train_and_test_match_jax(tmp_path, caplog):
  _, data = _split(str(tmp_path), 'ml-20m')
  data += '/'
  models = str(tmp_path / 'models')
  with caplog.at_level(logging.INFO, logger='recoder_tpu_torch'):
    trainer, _ = _main(os.path.join(SCRIPTS, 'ml-20m', 'torch_train.py'),
                       ['--data-dir', data, '--model-dir', models,
                        '--epochs', '10', '--device', 'cpu'])
  assert trainer.current_epoch == 10
  ckpt = os.path.join(models, 'logistic_ns_d_0.0_n_0.5_200_epoch_10.model')
  assert os.path.isfile(ckpt)
  assert any('Epoch 10/10' in r.message and 'val_loss=' in r.message
             and 'NDCG@100=' in r.message for r in caplog.records)

  _main(os.path.join(SCRIPTS, 'torch_build_embeddings.py'),
        ['--model-file', ckpt, '--device', 'cpu'])
  for method in ('inference', 'similarity'):
    argv = ['--data-dir', data, '--model-file', ckpt, '--method', method]
    _, jax_text = _main(os.path.join(SCRIPTS, 'ml-20m', 'test.py'), argv)
    results, text = _main(os.path.join(SCRIPTS, 'ml-20m', 'torch_test.py'),
                          argv + ['--device', 'cpu'])
    want, got = _metrics(jax_text), _metrics(text)
    assert set(want) == set(got) == {'Recall@20', 'Recall@50', 'NDCG@100'}
    for k in want:
      assert abs(got[k] - want[k]) <= 1e-5, (method, k, got[k], want[k])
    assert {str(m): float(np.mean(v)) for m, v in results.items()} == got


def test_msd_big_mesh_model_one_trains_bitwise_the_run_without(tmp_path):
  _, data = _split(str(tmp_path), 'msd-big', extra=('--min-uc', '3',
                                                    '--min-sc', '2'))
  params = {}
  for mesh in (False, True):
    argv = ['--data-dir', data + '/', '--model-dir', str(tmp_path / 'm'),
            '--epochs', '2', '--device', 'cpu']
    try:
      trainer, text = _main(os.path.join(SCRIPTS, 'msd-big', 'torch_train.py'),
                            argv + (['--mesh-model', '1'] if mesh else []))
    finally:
      if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    assert ("mesh: {'data': 1, 'model': 1}" in text) == mesh
    assert (trainer.mesh is not None) == mesh and trainer.model.sparse
    params[mesh] = {k: v.detach().clone()
                    for k, v in trainer.model.params().items()}
  for k, v in params[False].items():
    assert torch.equal(v, params[True][k]), k


STRESS = os.path.join(SCRIPTS, 'torch_stress_scale.py')


def test_stress_runs_on_the_cpu():
  trainer, text = _main(STRESS, ['--cpu', '--items', '2000', '--dim', '16',
                                 '--users', '300', '--ann-items', '500'])
  assert '300 users x 2,000 items' in text
  assert 'steady state: 3 epochs x 1 steps' in text
  assert 'ANN forest over 500 items' in text
  assert trainer.model.sparse and trainer.current_epoch == 4


def _free_port():
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def test_stress_splits_the_tables_over_two_gloo_ranks(tmp_path):
  """Two ranks launched as torchrun launches them (its environment)."""
  port = str(_free_port())
  procs = []
  for rank in range(2):
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
               WORLD_SIZE='2', MASTER_ADDR='127.0.0.1', MASTER_PORT=port,
               OMP_NUM_THREADS='1')
    procs.append(subprocess.Popen(
        [sys.executable, STRESS, '--cpu', '--items', '2000', '--dim', '16',
         '--users', '400', '--batch-size', '50', '--ann-items', '300',
         '--mesh-data', '2', '--shuffle', 'blocks', '--table-sharding',
         'data', '--verify-replicated'],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=240)[0])
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
  for p, text in zip(procs, outs):
    assert p.returncode == 0, text[-3000:]
    assert "mesh: {'data': 2, 'model': 1}" in text
    assert 'per-rank byte arithmetic OK' in text
    assert 'sharded 2-way' in text
    assert 'verify OK' in text


class _Matrix(Exception):
  def __init__(self, matrix):
    super().__init__()
    self.matrix = matrix


def test_stress_synthetic_matrix_is_the_jax_scripts():
  import recoder_tpu.data

  def stop(matrix, *args, **kwargs):
    raise _Matrix(matrix)
  main = runpy.run_path(os.path.join(SCRIPTS, 'stress_scale.py'))['main']
  argv = ['--items', '5000', '--users', '300', '--items-per-user', '40']
  with mock.patch.object(sys, 'argv', ['stress_scale.py', '--cpu'] + argv), \
      mock.patch.object(recoder_tpu.data, 'RecommendationDataset', stop):
    with pytest.raises(_Matrix) as caught:
      main()
  want = caught.value.matrix
  stress = runpy.run_path(STRESS)
  got = stress['synthetic_matrix'](300, 5000, 40, np.random.default_rng(0))
  assert got.shape == want.shape and got.dtype == want.dtype
  for f in ('indptr', 'indices', 'data'):
    np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize('known,new', [
    (np.arange(6), np.arange(6)), (np.arange(6), np.arange(8)),
    (np.arange(6), np.array([2, 9])), (np.array([3, 1, 2]), np.array([3, 1, 2])),
    (np.array([1, 1, 2]), np.array([1, 1, 2]))],
    ids=['same', 'wider', 'other', 'unsorted', 'repeated'])
def test_merge_ids_is_the_jax_union(known, new):
  """The trainer's union of the ids seen (a call with the ids it knows
  skips the sort) is ``np.unique(np.append(known, new))``."""
  from recoder_tpu_torch.model import _merge_ids
  got = _merge_ids(known, new)
  want = np.unique(np.append(known, new))
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
