"""Thin command-line interface: train / evaluate / recommend / serve from
a JSON config.

Port of ``recoder_tpu/cli.py``, with the same commands and config
schema:

  python -m recoder_tpu_torch.cli train --config run.json
  python -m recoder_tpu_torch.cli evaluate --config run.json \
      --model-file models/run_epoch_100.model

Config schema (JSON):
{
  "data": {"train": "pro_sg/train.csv", "val_tr": "...", "val_te": "...",
           "user_col": "uid", "item_col": "sid", "inter_col": "watched"},
  "model": {"type": "autoencoder" | "mf" | "multvae" | "ease" | "ials", ...kwargs...},
  "trainer": {"optimizer_type": "adam", "loss": "logistic",
              "loss_params": {}, "seed": 42,
              "mesh_model": 0,
              "eval_item_chunk": null, "eval_compute_dtype": null,
              "eval_topk": "exact", "opt_state_dtype": null},
  "train": { ...Recoder.train kwargs... }
}

The port adds one key, ``device``, where its constructors take it:
``"trainer": {"device": "cpu"}`` for the Recoder models and ``"model":
{"device": "cpu"}`` for ``ease`` / ``ials``. Without it every command
runs on the card, and raises where there is none. EASE
``solve='newton'`` without a mesh, a TPU workaround that is not ported,
raises NotImplementedError.

``trainer.mesh_model=M`` runs the command on a mesh of the launch's
processes (one process a card): the Recoder models (autoencoder, mf,
multvae) train with their item tables split over M of them; ``ials``
splits each chunk's row solves over every rank (``"model":
{"factor_sharding": "users"}`` row-shards its user factors too); and
``ease`` row-shards its solve over M:

  torchrun --nproc_per_node=N -m recoder_tpu_torch.cli train --config ...

Every rank runs the command; outside a launch of a multiple of M
processes it raises ValueError.
"""

import argparse
import json

import numpy as np
import pandas as pd

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.metrics import NDCG, AveragePrecision, Recall
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
from recoder_tpu_torch.utils import dataframe_to_csr_matrix

_METRIC_KINDS = {'recall': Recall, 'ndcg': NDCG,
                 'map': AveragePrecision, 'ap': AveragePrecision}


def parse_metrics(specs):
  """Metric specs -> metric objects.

  Each spec is either ``[name, k]`` or ``{"name": ..., "k": ...,
  "normalize": ...}``; names: recall | ndcg | map (AveragePrecision).
  Also accepts compact strings like ``"recall@20"``.
  """
  out = []
  for spec in specs:
    if isinstance(spec, str):
      name, _, k = spec.partition('@')
      spec = {'name': name, 'k': int(k or 10)}
    elif isinstance(spec, (list, tuple)):
      spec = {'name': spec[0], 'k': int(spec[1])}
    else:
      spec = dict(spec)
    name = spec.pop('name').lower()
    if name not in _METRIC_KINDS:
      raise ValueError(f'unknown metric {name!r}; '
                       f'choose from {sorted(_METRIC_KINDS)}')
    out.append(_METRIC_KINDS[name](**spec))
  return out


def _load_datasets(data_cfg, load_val=True):
  """Returns (train_dataset, val_dataset, item_id_map, user_id_map).

  The id maps translate the CSVs' original ids to internal indices;
  outputs that leave the process (cmd_recommend's CSV) must translate
  back through their inverses. ``load_val=False`` skips reading the
  validation CSVs for commands that never use them.
  """
  cols = dict(user_col=data_cfg.get('user_col', 'uid'),
              item_col=data_cfg.get('item_col', 'sid'),
              inter_col=data_cfg.get('inter_col', 'watched'))
  train_df = pd.read_csv(data_cfg['train'])
  train_matrix, item_id_map, user_id_map = dataframe_to_csr_matrix(
      train_df, **cols)
  train_dataset = RecommendationDataset(train_matrix)

  val_dataset = None
  if load_val and data_cfg.get('val_tr') and data_cfg.get('val_te'):
    val_tr = pd.read_csv(data_cfg['val_tr'])
    val_te = pd.read_csv(data_cfg['val_te'])
    val_tr_m, _, val_user_map = dataframe_to_csr_matrix(
        val_tr, item_id_map=item_id_map, **cols)
    val_te_m, _, _ = dataframe_to_csr_matrix(
        val_te, item_id_map=item_id_map, user_id_map=val_user_map,
        **cols)
    val_dataset = RecommendationDataset(val_tr_m, val_te_m)
  return train_dataset, val_dataset, item_id_map, user_id_map


def _build_model(model_cfg):
  cfg = dict(model_cfg)
  kind = cfg.pop('type', 'autoencoder')
  if kind == 'autoencoder':
    return DynamicAutoencoder(**cfg)
  if kind == 'mf':
    return MatrixFactorization(**cfg)
  if kind == 'multvae':
    from recoder_tpu_torch.models import MultVAE
    return MultVAE(**cfg)
  raise ValueError(f'unknown model type {kind}')


# models trained by one closed-form/ALS fit() instead of the Recoder
# epoch loop; they expose the same recommend() contract
_FIT_MODEL_KINDS = ('ease', 'ials')


def _fit_model_kind(cfg):
  kind = cfg.get('model', {}).get('type')
  return kind if kind in _FIT_MODEL_KINDS else None


def _is_fit_model(cfg):
  return _fit_model_kind(cfg) is not None


def _fit_model_class(kind):
  from recoder_tpu_torch.models import EASE, IALS
  return IALS if kind == 'ials' else EASE


def _load_fit_model(cfg, model_file):
  device = cfg.get('model', {}).get('device', device_lib.DEFAULT)
  return _fit_model_class(_fit_model_kind(cfg))(device=device).load(
      model_file)


def _launch_mesh(mesh_model, device):
  """The ('data', 'model') mesh of ``mesh_model`` 'model' ways over the
  launch's processes (it joins a torchrun launch's group first); None for
  0."""
  if not mesh_model:
    return None
  from recoder_tpu_torch.parallel import MeshConfig, initialize, make_mesh
  from recoder_tpu_torch.parallel.distributed import process_count
  initialize(device=device)  # (joins a torchrun launch's group)
  if process_count() % mesh_model:
    raise ValueError(
        f'trainer.mesh_model={mesh_model} splits the tables over '
        f'{mesh_model} processes, and this launch has {process_count()}; '
        f'launch with torchrun --nproc_per_node={mesh_model} (or a '
        'multiple of it)')
  return make_mesh(MeshConfig(model=mesh_model), devices=device)


def _build_trainer(cfg, model):
  tr_cfg = dict(cfg.get('trainer', {}))
  mesh = _launch_mesh(tr_cfg.pop('mesh_model', 0),
                      tr_cfg.get('device', device_lib.DEFAULT))
  return Recoder(model=model, mesh=mesh, **tr_cfg)


def cmd_train(cfg):
  train_dataset, val_dataset, _, _ = _load_datasets(cfg['data'])
  if _is_fit_model(cfg):
    # fit-style models train in one closed-form/ALS fit: fit, save,
    # report
    kind = _fit_model_kind(cfg)
    model_cfg = dict(cfg.get('model', {})); model_cfg.pop('type')
    if kind == 'ials':
      fit_keys = ('sweeps', 'chunk_elems', 'factor_sharding')
    else:
      fit_keys = ('gram', 'max_items', 'solve')
    fit_kw = {k: model_cfg.pop(k) for k in fit_keys if k in model_cfg}
    # mesh_model lives in the trainer block (the documented schema); a
    # model-block value is honored too, as in the JAX package
    mesh_model = (cfg.get('trainer', {}).get('mesh_model', 0)
                  or model_cfg.pop('mesh_model', 0))
    model_cfg.pop('mesh_model', None)
    mesh = _launch_mesh(mesh_model,
                        model_cfg.get('device', device_lib.DEFAULT))
    if mesh is not None:
      # ease: the solve row-sharded over 'model'; ials: the row solves
      # split over every rank
      fit_kw['mesh'] = mesh
    train_cfg = dict(cfg.get('train', {}))
    prefix = train_cfg.get('model_checkpoint_prefix')
    model = _fit_model_class(kind)(**model_cfg)
    model.fit(train_dataset.interactions_matrix, **fit_kw)
    if prefix:
      print(f'saved {kind.upper()} model to '
            f'{model.save(prefix + ".model")}')
    if val_dataset is not None:
      _evaluate_fit_model(
          model, val_dataset,
          parse_metrics(train_cfg.get('metrics')
                        or ['recall@20', 'ndcg@100']),
          batch_size=train_cfg.get('eval_batch_size', 500))
    return
  model = _build_model(cfg.get('model', {}))
  trainer = _build_trainer(cfg, model)
  train_kwargs = dict(cfg.get('train', {}))
  if 'metrics' in train_kwargs:
    train_kwargs['metrics'] = parse_metrics(train_kwargs['metrics'])
  trainer.train(train_dataset=train_dataset, val_dataset=val_dataset,
                **train_kwargs)


def _evaluate_fit_model(model, val_dataset, metrics, batch_size=500,
                        num_recommendations=100):
  from recoder_tpu_torch.metrics import RecommenderEvaluator
  from recoder_tpu_torch.recommender import InferenceRecommender
  ev = RecommenderEvaluator(
      InferenceRecommender(model, num_recommendations), metrics)
  results = ev.evaluate(val_dataset, batch_size=batch_size)
  for m in results:
    print(f'{m}: {np.mean(results[m])}')


def _load_scorer(cfg, model_file):
  """The model a command scores with: a fit model, or a Recoder restored
  from ``model_file`` (the same ``recommend()`` contract)."""
  if _is_fit_model(cfg):
    return _load_fit_model(cfg, model_file)
  trainer = _build_trainer(cfg, _build_model(cfg.get('model', {})))
  trainer.init_from_model_file(model_file)
  return trainer


def cmd_evaluate(cfg, model_file, num_recommendations, batch_size,
                 metric_specs=None):
  _, val_dataset, _, _ = _load_datasets(cfg['data'])
  assert val_dataset is not None, 'config needs val_tr/val_te for evaluate'
  specs = (metric_specs
           or cfg.get('evaluate', {}).get('metrics')
           or ['recall@20', 'recall@50', 'ndcg@100'])
  metrics = parse_metrics(specs)
  trainer = _load_scorer(cfg, model_file)
  if _is_fit_model(cfg):
    _evaluate_fit_model(trainer, val_dataset, metrics,
                        batch_size=batch_size,
                        num_recommendations=num_recommendations)
    return
  results = trainer.evaluate(val_dataset,
                             num_recommendations=num_recommendations,
                             metrics=metrics, batch_size=batch_size)
  for m in results:
    print(f'{m}: {np.mean(results[m])}')


def cmd_recommend(cfg, model_file, num_recommendations, batch_size, out):
  """Batch-score every user in the training matrix and write top-k
  recommendations as CSV (uid, rank, sid) in the ORIGINAL id space of
  the input CSVs (internal indices are translated back through the
  dataframe_to_csr_matrix id maps)."""
  import sys

  from recoder_tpu_torch.data import UsersInteractions

  train_dataset, _, item_id_map, user_id_map = _load_datasets(
      cfg['data'], load_val=False)
  inv_user = {v: k for k, v in user_id_map.items()}
  inv_item = {v: k for k, v in item_id_map.items()}
  trainer = _load_scorer(cfg, model_file)

  matrix = train_dataset.interactions_matrix
  fh = open(out, 'w') if out else sys.stdout
  print('uid,rank,sid', file=fh)
  for lo in range(0, matrix.shape[0], batch_size):
    hi = min(lo + batch_size, matrix.shape[0])
    ui = UsersInteractions(users=np.arange(lo, hi),
                           interactions_matrix=matrix[lo:hi])
    recs = trainer.recommend(ui, num_recommendations)
    num_items = len(item_id_map)
    for u, items in zip(range(lo, hi), recs):
      rank = 1
      for sid in items:
        # users with < k unseen items may get pad columns (id >=
        # num_items) in their top-k tail; skip, don't crash
        if int(sid) >= num_items:
          continue
        print(f'{inv_user[u]},{rank},{inv_item[int(sid)]}', file=fh)
        rank += 1
  if out:
    fh.close()
    print(f'wrote recommendations for {matrix.shape[0]} users to {out}')


def make_server(cfg, model_file, host='127.0.0.1', port=8321):
  """Build (without starting) the scoring HTTP server.

  Endpoints:
    GET  /healthz             -> {"status": "ok", ...}
    POST /recommend           -> {"recommendations": [[sid, ...], ...]}
         body: {"interactions": [[sid, ...] per user], "k": 10}
    POST /recommend_similar   -> same contract, served by the ANN
         item-item SimilarityRecommender instead of the model forward
         (requires a ``serve.ann_index`` config entry; built with
         scripts/torch_build_embeddings.py). Host + C++ forest, no
         device work, so it takes no lock.

  Interactions are item ids in the training id space. Model scoring
  runs the same full-catalog top-k on the device as batch recommend;
  requests that score on the device serialize on a lock.

  Config (optional)::

    "serve": {"ann_index": "path/to/index.ann",   // enables the route
              "num_neighbors": 20,                 // NNs per hist item
              "scale": 1, "search_k": -1}
  """
  import http.server
  import threading

  from scipy.sparse import csr_matrix

  from recoder_tpu_torch.data import UsersInteractions

  trainer = _load_scorer(cfg, model_file)
  num_items = trainer.num_items
  lock = threading.Lock()

  serve_cfg = cfg.get('serve', {})
  ann_index = None
  if serve_cfg.get('ann_index'):
    from recoder_tpu_torch.embedding import AnnEmbeddingsIndex
    ann_index = AnnEmbeddingsIndex(
        search_k=serve_cfg.get('search_k', -1))
    ann_index.load(serve_cfg['ann_index'])

  def _similarity_recommender(k):
    from recoder_tpu_torch.recommender import SimilarityRecommender
    return SimilarityRecommender(
        ann_index, num_recommendations=k,
        n=serve_cfg.get('num_neighbors', 20),
        scale=serve_cfg.get('scale', 1))

  class Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
      pass

    def _reply(self, code, payload):
      body = json.dumps(payload).encode()
      self.send_response(code)
      self.send_header('Content-Type', 'application/json')
      self.send_header('Content-Length', str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def do_GET(self):
      if self.path == '/healthz':
        self._reply(200, {'status': 'ok', 'num_items': num_items})
      else:
        self._reply(404, {'error': 'unknown path'})

    def do_POST(self):
      if self.path not in ('/recommend', '/recommend_similar'):
        self._reply(404, {'error': 'unknown path'})
        return
      if self.path == '/recommend_similar' and ann_index is None:
        self._reply(400, {'error': "no 'serve.ann_index' configured"})
        return
      try:
        length = int(self.headers.get('Content-Length', 0))
        req = json.loads(self.rfile.read(length))
        histories = req['interactions']
        k = int(req.get('k', 10))
        # bound k: the top-k cannot take more than the catalog
        if not 1 <= k <= num_items:
          raise ValueError(f'k must be in [1, {num_items}]')
        if not histories:
          self._reply(200, {'recommendations': []})
          return
        rows, cols = [], []
        for u, items in enumerate(histories):
          for i in items:
            if not 0 <= int(i) < num_items:
              raise ValueError(f'item id {i} out of range')
            rows.append(u)
            cols.append(int(i))
        m = csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                       shape=(len(histories), num_items))
        ui = UsersInteractions(users=np.arange(len(histories)),
                               interactions_matrix=m)
        if self.path == '/recommend_similar':
          # host + C++ only: no device work, no lock
          recs = _similarity_recommender(k).recommend(ui)
        else:
          with lock:
            recs = trainer.recommend(ui, k)
        self._reply(200, {'recommendations': [[int(i) for i in r]
                                              for r in recs]})
      except Exception as e:  # surface the error to the client
        self._reply(400, {'error': str(e)})

  return http.server.ThreadingHTTPServer((host, port), Handler)


def cmd_serve(cfg, model_file, host, port):
  server = make_server(cfg, model_file, host, port)
  print(f'serving on http://{host}:{server.server_address[1]} '
        f'(POST /recommend, GET /healthz)')
  server.serve_forever()


def main():
  p = argparse.ArgumentParser(prog='recoder_tpu_torch', description=__doc__)
  sub = p.add_subparsers(dest='cmd', required=True)
  pt = sub.add_parser('train')
  pt.add_argument('--config', required=True)
  pe = sub.add_parser('evaluate')
  pe.add_argument('--config', required=True)
  pe.add_argument('--model-file', required=True)
  pe.add_argument('--num-recommendations', type=int, default=100)
  pe.add_argument('--batch-size', type=int, default=500)
  pe.add_argument('--metrics', nargs='*', default=None,
                  help="metric specs like recall@20 ndcg@100 map@10 "
                       "(default: config 'evaluate.metrics' or "
                       "recall@20 recall@50 ndcg@100)")
  ps = sub.add_parser('serve')
  ps.add_argument('--config', required=True)
  ps.add_argument('--model-file', required=True)
  ps.add_argument('--host', default='127.0.0.1')
  ps.add_argument('--port', type=int, default=8321)
  pr = sub.add_parser('recommend')
  pr.add_argument('--config', required=True)
  pr.add_argument('--model-file', required=True)
  pr.add_argument('--num-recommendations', type=int, default=10)
  pr.add_argument('--batch-size', type=int, default=500)
  pr.add_argument('--out', default=None, help='output CSV (default stdout)')
  args = p.parse_args()

  with open(args.config) as f:
    cfg = json.load(f)

  if args.cmd == 'train':
    cmd_train(cfg)
  elif args.cmd == 'evaluate':
    cmd_evaluate(cfg, args.model_file, args.num_recommendations,
                 args.batch_size, metric_specs=args.metrics)
  elif args.cmd == 'serve':
    cmd_serve(cfg, args.model_file, args.host, args.port)
  else:
    cmd_recommend(cfg, args.model_file, args.num_recommendations,
                  args.batch_size, args.out)


if __name__ == '__main__':
  main()
