"""The port's CLI against the JAX package's, on tests/test_cli.py's
workspace with ``"device": "cpu"``.

* ``parse_metrics`` gives the same metrics;
* a checkpoint of the JAX CLI's ``train`` gives the same ``evaluate``
  means (within ``METRIC_ATOL``) and ``recommend`` CSVs (ids equal up to
  near-ties: two items whose scores differ by at most ``NEAR_TIE``);
* a port ``serve`` and a JAX ``serve`` of that checkpoint answer the same
  requests: ``/recommend`` as ``recommend``, ``/recommend_similar`` over
  an index that ``scripts/torch_build_embeddings.py`` wrote exactly,
  ``/healthz`` and the 400s / 404s equally;
* a port ``train`` writes a checkpoint that the JAX package loads;
* EASE and iALS go through train, evaluate, recommend and serve, against
  the JAX CLI on the same checkpoint;
* ``trainer.mesh_model`` for ials and ease fits on a (1, 1) mesh as the
  JAX CLI fits on its mesh; iALS ``factor_sharding='users'`` without a
  mesh and a mesh of more processes than the launch has raise
  ValueError; EASE ``solve='newton'`` without a mesh (a TPU workaround)
  raises NotImplementedError; and a config without ``device`` asks for
  the card.
"""

import contextlib
import io
import json
import os
import runpy
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import recoder_tpu.cli as jax_cli
import recoder_tpu_torch.cli as cli
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch.checkpoint import load_checkpoint
from recoder_tpu_torch.data import UsersInteractions
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 1e-6
NEAR_TIE = 1e-6
N_ITEMS = 80


def _frame(rng, users, per_user):
  rows = np.repeat(users, per_user)
  cols = rng.integers(0, N_ITEMS, len(rows))
  return pd.DataFrame({'uid': rows, 'sid': cols,
                       'watched': 1.0}).drop_duplicates(['uid', 'sid'])


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
  """tests/test_cli.py's workspace; the JAX CLI trains its checkpoint."""
  tmp_path = tmp_path_factory.mktemp('cli')
  rng = np.random.default_rng(0)
  _frame(rng, np.arange(60), 10).to_csv(tmp_path / 'train.csv', index=False)
  _frame(rng, np.arange(20), 6).to_csv(tmp_path / 'val_tr.csv', index=False)
  _frame(rng, np.arange(20), 6).to_csv(tmp_path / 'val_te.csv', index=False)
  cfg = {
      'data': {'train': str(tmp_path / 'train.csv'),
               'val_tr': str(tmp_path / 'val_tr.csv'),
               'val_te': str(tmp_path / 'val_te.csv')},
      'model': {'type': 'autoencoder', 'hidden_layers': [16],
                'noise_prob': 0.0},
      'trainer': {'optimizer_type': 'adam', 'loss': 'mse', 'seed': 1},
      'train': {'batch_size': 20, 'num_epochs': 2,
                'negative_sampling': True,
                'model_checkpoint_prefix': str(tmp_path / 'ck')},
      'evaluate': {'metrics': ['recall@10', ['ndcg', 10], 'map@10']},
  }
  jax_path = _write(tmp_path / 'jax.json', cfg)
  run(jax_cli, ['train', '--config', jax_path])
  ckpt = str(tmp_path / 'ck_epoch_2.model')
  assert os.path.exists(ckpt)
  port_cfg = _port_cfg(cfg)
  return tmp_path, cfg, jax_path, port_cfg, _write(tmp_path / 'port.json',
                                                   port_cfg), ckpt


def _write(path, cfg):
  path.write_text(json.dumps(cfg))
  return str(path)


def _port_cfg(cfg):
  """The same config, run on the CPU."""
  cfg = json.loads(json.dumps(cfg))
  if cfg['model'].get('type') in ('ease', 'ials'):
    cfg['model']['device'] = 'cpu'
  else:
    cfg.setdefault('trainer', {})['device'] = 'cpu'
  return cfg


def run(module, argv):
  """``module.main()`` with ``argv``; returns its standard output."""
  old, out = sys.argv, io.StringIO()
  sys.argv = [module.__name__] + argv
  try:
    with contextlib.redirect_stdout(out):
      module.main()
  finally:
    sys.argv = old
  return out.getvalue()


def means(output):
  """``{metric: mean}`` of an evaluate's printed lines."""
  out = {}
  for line in output.splitlines():
    name, sep, value = line.rpartition(': ')
    if sep and '@' in name:
      out[name] = float(value)
  return out


def port_scores(cfg, ckpt, histories):
  """The port's float32 scores of users given as item-id lists."""
  from scipy.sparse import csr_matrix
  scorer = cli._load_scorer(cfg, ckpt)
  rows = np.repeat(np.arange(len(histories)), [len(h) for h in histories])
  cols = np.concatenate([np.asarray(h, np.int64) for h in histories])
  m = csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                 shape=(len(histories), scorer.num_items))
  scores = scorer.predict(UsersInteractions(np.arange(len(histories)), m))
  return np.asarray(scores.cpu() if torch.is_tensor(scores) else scores,
                    np.float64)


def assert_same_up_to_near_ties(got, want, scores):
  """Per user: the same number of ids, and at each rank the same id or
  two ids whose scores differ by at most NEAR_TIE."""
  assert len(got) == len(want)
  for g, w, s in zip(got, want, scores):
    g, w = np.asarray(g, np.int64), np.asarray(w, np.int64)
    assert g.shape == w.shape
    differ = g != w
    np.testing.assert_array_less(np.abs(s[g[differ]] - s[w[differ]]),
                                 NEAR_TIE * (1 + 1e-9))


def compare_recommend_csvs(port_csv, jax_csv, cfg, ckpt, train_csv):
  got, want = pd.read_csv(port_csv), pd.read_csv(jax_csv)
  assert list(got.columns) == list(want.columns) == ['uid', 'rank', 'sid']
  assert (got[['uid', 'rank']].to_numpy()
          == want[['uid', 'rank']].to_numpy()).all()
  # scores by internal index: the CSV speaks the original ids, which the
  # fixture's train.csv maps in order of first appearance
  train = pd.read_csv(train_csv)
  uids = list(dict.fromkeys(train.uid))
  sid_index = {s: i for i, s in enumerate(dict.fromkeys(train.sid))}
  histories = [[sid_index[s] for s in train.sid[train.uid == u]]
               for u in uids]
  scores = port_scores(cfg, ckpt, histories)
  g = [[sid_index[s] for s in got.sid[got.uid == u]] for u in uids]
  w = [[sid_index[s] for s in want.sid[want.uid == u]] for u in uids]
  assert_same_up_to_near_ties(g, w, scores)


@contextlib.contextmanager
def serving(module, cfg, ckpt):
  server = module.make_server(cfg, ckpt, port=0)
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  try:
    yield f'http://127.0.0.1:{server.server_address[1]}'
  finally:
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def request(base, path, payload=None):
  """``(status, json)`` of a GET (no payload) or a POST."""
  data = None if payload is None else json.dumps(payload).encode()
  req = urllib.request.Request(base + path, data=data,
                               headers={'Content-Type': 'application/json'})
  try:
    with urllib.request.urlopen(req, timeout=60) as r:
      return r.status, json.loads(r.read())
  except urllib.error.HTTPError as e:
    return e.code, json.loads(e.read())


#: requests both servers must answer alike (status and body)
REFUSED = [
    ('/recommend', {'interactions': [[1, 2]], 'k': 0}),
    ('/recommend', {'interactions': [[1, 2]], 'k': N_ITEMS + 1}),
    ('/recommend', {'interactions': [[999]], 'k': 5}),
    ('/recommend', {'interactions': [[3, -1]], 'k': 5}),
    ('/recommend', {'k': 5}),
    ('/recommend', {'interactions': [], 'k': 5}),
    ('/recommend_similar', {'interactions': [[1, 2]], 'k': 0}),
    ('/recommend_similar', {'interactions': [[80]], 'k': 5}),
    ('/unknown', {'interactions': [[1]]}),
]
HISTORIES = [[1, 2, 3], [10, 11], [5], list(range(0, 70, 3)),
             list(range(N_ITEMS - 1))]


def test_parse_metrics_matches_jax():
  specs = ['recall@20', ['ndcg', 100], {'name': 'map', 'k': 5,
                                        'normalize': False},
           'ap@3', 'NDCG', ('recall', 7)]
  got, want = cli.parse_metrics(specs), jax_cli.parse_metrics(specs)
  assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want]
  assert [str(m) for m in got] == [str(m) for m in want]
  assert [(m.k, getattr(m, 'normalize', None)) for m in got] == \
         [(m.k, getattr(m, 'normalize', None)) for m in want]
  with pytest.raises(ValueError, match='unknown metric'):
    cli.parse_metrics(['bogus@1'])


@pytest.mark.parametrize('flags', [[], ['--metrics', 'recall@5', 'ndcg@20'],
                                   ['--num-recommendations', '10',
                                    '--batch-size', '7']])
def test_evaluate_a_jax_checkpoint(workspace, flags):
  _, _, jax_path, _, port_path, ckpt = workspace
  argv = ['evaluate', '--model-file', ckpt] + flags
  got = means(run(cli, argv + ['--config', port_path]))
  want = means(run(jax_cli, argv + ['--config', jax_path]))
  assert got.keys() == want.keys() and got
  for name in want:
    assert got[name] == pytest.approx(want[name], abs=METRIC_ATOL), name


@pytest.mark.parametrize('k,batch', [(5, 30), (100, 25)])
def test_recommend_a_jax_checkpoint(workspace, k, batch):
  tmp_path, _, jax_path, port_cfg, port_path, ckpt = workspace
  paths = {}
  for module, config, name in ((cli, port_path, 'port'),
                               (jax_cli, jax_path, 'jax')):
    paths[name] = str(tmp_path / f'recs_{name}_{k}.csv')
    run(module, ['recommend', '--config', config, '--model-file', ckpt,
                 '--num-recommendations', str(k), '--batch-size', str(batch),
                 '--out', paths[name]])
  compare_recommend_csvs(paths['port'], paths['jax'], port_cfg, ckpt,
                         tmp_path / 'train.csv')
  recs = pd.read_csv(paths['port'])
  assert recs.uid.nunique() == 60
  assert recs.sid.between(0, N_ITEMS - 1).all()


def test_serve_answers_as_jax(workspace):
  tmp_path, cfg, _, port_cfg, _, ckpt = workspace
  index = str(tmp_path / 'items.ann')
  old = sys.argv
  sys.argv = ['torch_build_embeddings.py', '--model-file', ckpt,
              '--index-file', index, '--n-trees', '4', '--device', 'cpu']
  try:
    with contextlib.redirect_stdout(io.StringIO()):
      runpy.run_path(os.path.join(REPO, 'scripts',
                                  'torch_build_embeddings.py'),
                     run_name='__main__')
  finally:
    sys.argv = old
  serve = {'serve': {'ann_index': index, 'num_neighbors': 10}}
  answers = {}
  for name, module, config in (('port', cli, port_cfg), ('jax', jax_cli, cfg)):
    with serving(module, {**config, **serve}, ckpt) as base:
      answers[name] = [request(base, '/healthz'), request(base, '/nope')]
      for route in ('/recommend', '/recommend_similar'):
        for k in (1, 5, N_ITEMS):
          answers[name].append(request(base, route, {'interactions':
                                                     HISTORIES, 'k': k}))
      answers[name] += [request(base, path, body) for path, body in REFUSED]
    with serving(module, config, ckpt) as base:
      answers[name].append(request(base, '/recommend_similar',
                                   {'interactions': [[1, 2]], 'k': 5}))
  got, want = answers['port'], answers['jax']
  assert got[0] == want[0] == (200, {'status': 'ok', 'num_items': N_ITEMS})
  scores = port_scores(port_cfg, ckpt, HISTORIES)
  for g, w in zip(got[2:5], want[2:5]):  # /recommend
    assert g[0] == w[0] == 200
    assert_same_up_to_near_ties(g[1]['recommendations'],
                                w[1]['recommendations'], scores)
  for g, w in zip(got[5:8], want[5:8]):  # /recommend_similar
    assert g == w and g[0] == 200
  for g, w in zip(got[8:], want[8:]):
    assert g == w
  assert [g[0] for g in got[8:]] == [400] * 5 + [200, 400, 400, 404, 400]
  assert got[1] == want[1] == (404, {'error': 'unknown path'})
  assert 'ann_index' in got[-1][1]['error']


def test_port_train_writes_a_checkpoint_jax_loads(workspace):
  tmp_path, _, _, port_cfg, _, _ = workspace
  cfg = json.loads(json.dumps(port_cfg))
  cfg['train']['model_checkpoint_prefix'] = str(tmp_path / 'port_ck')
  run(cli, ['train', '--config', _write(tmp_path / 'port_train.json', cfg)])
  ckpt = str(tmp_path / 'port_ck_epoch_2.model')
  jax_tr = JaxRecoder(JaxDynAE())
  jax_tr.init_from_model_file(ckpt)
  tr = Recoder(DynamicAutoencoder(), device='cpu')
  tr.init_from_model_file(ckpt)
  for name, table in tr.model.params().items():
    want = np.asarray(jax_tr.model.params[name])
    np.testing.assert_array_equal(
        table.detach().numpy(), want[tuple(slice(n) for n in table.shape)])
  assert jax_tr.current_epoch == tr.current_epoch == 2
  out = means(run(cli, ['evaluate', '--config', _write(
      tmp_path / 'port_train.json', cfg), '--model-file', ckpt]))
  assert set(out) == {'Recall@10', 'NDCG@10', 'AveragePrecision@10'}


@pytest.mark.parametrize('model', [
    {'type': 'ease', 'lam': 50.0},
    {'type': 'ials', 'embedding_size': 8, 'alpha': 10.0, 'lam': 0.01,
     'sweeps': 3, 'chunk_elems': 1024}])
def test_fit_models_go_through_every_command(workspace, model):
  tmp_path, cfg, _, _, _, _ = workspace
  kind = model['type']
  cfg = json.loads(json.dumps(cfg))
  cfg['model'] = model
  cfg['train'] = {'model_checkpoint_prefix': str(tmp_path / kind),
                  'metrics': ['recall@10', 'ndcg@20']}
  port_cfg = _port_cfg(cfg)
  jax_path = _write(tmp_path / f'{kind}_jax.json', cfg)
  port_path = _write(tmp_path / f'{kind}_port.json', port_cfg)
  trained = means(run(cli, ['train', '--config', port_path]))
  ckpt = str(tmp_path / f'{kind}.model')
  assert os.path.exists(ckpt)
  assert set(trained) == {'Recall@10', 'NDCG@20'}
  argv = ['evaluate', '--model-file', ckpt, '--num-recommendations', '10',
          '--batch-size', '20']
  got = means(run(cli, argv + ['--config', port_path]))
  want = means(run(jax_cli, argv + ['--config', jax_path]))
  assert got.keys() == want.keys() and got
  for name in want:
    assert got[name] == pytest.approx(want[name], abs=METRIC_ATOL), name
  paths = {}
  for module, config, name in ((cli, port_path, 'port'),
                               (jax_cli, jax_path, 'jax')):
    paths[name] = str(tmp_path / f'{kind}_recs_{name}.csv')
    run(module, ['recommend', '--config', config, '--model-file', ckpt,
                 '--num-recommendations', '5', '--batch-size', '60',
                 '--out', paths[name]])
  compare_recommend_csvs(paths['port'], paths['jax'], port_cfg, ckpt,
                         tmp_path / 'train.csv')
  assert pd.read_csv(paths['port']).groupby('uid')['rank'].max().eq(5).all()
  answers = []
  for module, config in ((cli, port_cfg), (jax_cli, cfg)):
    with serving(module, config, ckpt) as base:
      answers.append([request(base, '/recommend', {'interactions': HISTORIES,
                                                   'k': 5}),
                      request(base, '/healthz')]
                     + [request(base, p, b) for p, b in REFUSED])
  got, want = answers
  assert got[0][0] == want[0][0] == 200
  assert_same_up_to_near_ties(got[0][1]['recommendations'],
                              want[0][1]['recommendations'],
                              port_scores(port_cfg, ckpt, HISTORIES))
  assert got[1:] == want[1:]


@pytest.mark.parametrize('change,error,match', [
    # (a mesh of 2 needs a launch of 2 processes: torchrun)
    (lambda c: c['trainer'].update(mesh_model=2), ValueError,
     'torchrun --nproc_per_node=2'),
    # (the JAX fit's own ValueError)
    (lambda c: c.update(model={'type': 'ials', 'embedding_size': 4,
                               'factor_sharding': 'users', 'device': 'cpu'}),
     ValueError, 'requires a mesh'),
    # (a (1, 1) mesh in this process: the fit runs, as the JAX CLI's on its
    # mesh)
    (lambda c: c.update(model={'type': 'ials', 'embedding_size': 4,
                               'device': 'cpu'},
                        trainer={'mesh_model': 1}),
     None, 'user_factors'),
    (lambda c: c.update(model={'type': 'ease', 'lam': 5.0, 'device': 'cpu'},
                        trainer={'mesh_model': 1}),
     None, 'item_weights'),
    (lambda c: c.update(model={'type': 'ease', 'solve': 'newton',
                               'device': 'cpu'}),
     NotImplementedError, 'newton')])
def test_settings_not_ported_raise(workspace, change, error, match):
  tmp_path, _, _, port_cfg, _, _ = workspace
  cfg = json.loads(json.dumps(port_cfg))
  change(cfg)
  if error is not None:
    path = _write(tmp_path / 'refused.json', cfg)
    with pytest.raises(error, match=match):
      run(cli, ['train', '--config', path])
    return
  # the fit on the mesh against the JAX CLI's on its mesh of the 8
  # virtual devices, each saved under its own prefix
  saved = {}
  for name, module in (('port', cli), ('jax', jax_cli)):
    c = json.loads(json.dumps(cfg))
    c['train'] = {'model_checkpoint_prefix': str(tmp_path / f'mesh_{name}')}
    if name == 'jax':
      del c['model']['device']
    try:
      run(module, ['train', '--config',
                   _write(tmp_path / f'mesh_{name}.json', c)])
    finally:
      if name == 'port' and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    saved[name] = load_checkpoint(str(tmp_path / f'mesh_{name}.model'))[0][
        match]
  if match == 'item_weights':
    np.testing.assert_allclose(saved['port'], saved['jax'], rtol=5e-4,
                               atol=5e-5)
  else:  # (the packages' fits: tests/test_torch_ials.py's bound)
    assert (np.max(np.abs(saved['port'] - saved['jax']))
            <= 5e-5 * np.max(np.abs(saved['jax'])))


def test_a_config_without_device_asks_for_the_card(workspace):
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  _, _, jax_path, _, _, ckpt = workspace
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    run(cli, ['evaluate', '--config', jax_path, '--model-file', ckpt])
