"""The port's public signatures against the JAX package's.

For each public callable of the port -- every public ``Recoder`` method,
the model classes (their constructors, hyper-parameter and sparse-plan
methods, and ``forward`` / ``apply_gathered`` against the JAX ``apply``
/ ``apply_gathered``), ``EASE``, ``IALS``,
``RecommenderEvaluator.evaluate``, the ``utils`` functions, and the
serving surface (the CLI's functions, the embeddings indexes and the
native ``AnnIndex``, ``SimilarityRecommender``, ``preprocessing``), the
host loader (``RecommendationDataLoader``, ``BatchCollator``) and the
directory checkpoint (``checkpoint_orbax``) -- the parameter names in
order and their defaults must equal the JAX original's. The only
differences allowed are named below:

* port-only parameters: ``device`` (where a trainer, a fitted model or
  a brute-force index lives), the test draws ``keep_mask`` / ``eps`` of a
  model's forward, and its ``shard`` (a mesh rank's share of a step,
  which JAX leaves to the compiler);
* the forward's translation of the JAX functional form: no ``params``
  (the module holds them), ``generator`` for ``rng``, and no
  ``items_sorted_unique`` (an XLA promise with no PyTorch counterpart);
* the JAX loader's static-shape padding, which the port's unpadded
  batches do not need (``data/buckets.py`` is not ported): the
  parameters in ``JAX_PADDING``;
* JAX-only methods whose modules are still in ROADMAP Queue 1 (none
  since ``Recoder.recommend_async`` was ported).

The arguments whose modules Queue 1 still holds are taken at their JAX
positions and raise NotImplementedError when set; that is checked too,
and that the ones since ported (``mesh``, ``eval_item_chunk``,
``eval_topk``, ``table_sharding``) construct or train.
"""

import inspect
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recoder_tpu.checkpoint_orbax as jax_checkpoint_orbax
import recoder_tpu.cli as jax_cli
import recoder_tpu.data.loader as jax_loader
import recoder_tpu.embedding as jax_embedding
import recoder_tpu.metrics as jax_metrics
import recoder_tpu.model as jax_model
import recoder_tpu.models as jax_models
import recoder_tpu.native.ann as jax_ann
import recoder_tpu.parallel as jax_parallel
import recoder_tpu.preprocessing as jax_preprocessing
import recoder_tpu.recommender as jax_recommender
import recoder_tpu.utils as jax_utils
import recoder_tpu_torch.checkpoint_orbax as checkpoint_orbax
import recoder_tpu_torch.cli as cli
import recoder_tpu_torch.data.loader as loader
import recoder_tpu_torch.embedding as embedding
import recoder_tpu_torch.metrics as metrics
import recoder_tpu_torch.model as model
import recoder_tpu_torch.models as models
import recoder_tpu_torch.native.ann as ann
import recoder_tpu_torch.parallel as parallel
import recoder_tpu_torch.preprocessing as preprocessing
import recoder_tpu_torch.recommender as recommender
import recoder_tpu_torch.utils as utils
from recoder_tpu_torch.data import RecommendationDataset

#: parameters only the port has
PORT_ONLY = {'device', 'keep_mask', 'eps', 'shard'}
#: the JAX functional form's parameters a module's forward drops
JAX_FUNCTIONAL = {'params', 'items_sorted_unique'}
RENAMED = {'rng': 'generator'}
#: the JAX loader's padding parameters (ladders, fixed widths, stable
#: shapes): the port's batches are not padded
JAX_PADDING = {'item_ladder', 'nnz_ladder', 'stable_shapes',
               'pad_users_to_batch_size', 'fixed_union_width',
               'fixed_nnz_width'}
#: public JAX methods the port does not have yet, with their ROADMAP item
JAX_ONLY_METHODS = {}
#: Queue 1 items ported since their arguments were added: they construct
PORTED = {'Queue 1 item 5', 'Queue 1 item 7'}
#: the trainer's mesh argument: a (1, 1) mesh, built in the test (a one-rank
#: gloo group, destroyed after)
ONE_RANK_MESH = 'a (1, 1) mesh'

MODEL_METHODS = ('__init__', 'init_model', 'model_params',
                 'load_model_params', 'sparse_param_paths', 'sparse_entries',
                 'param_axes')


def _params(fn, drop=(), rename=None):
  out = []
  for p in inspect.signature(fn).parameters.values():
    if p.name == 'self' or p.name in drop:
      continue
    name = (rename or {}).get(p.name, p.name)
    default = None if p.default is inspect.Parameter.empty else p.default
    if inspect.isclass(default):  # each package's own class of that name
      default = default.__qualname__
    out.append((name, p.default is inspect.Parameter.empty, default))
  return out


def _public(cls):
  return sorted(n for n, f in vars(cls).items()
                if callable(f) and (not n.startswith('_') or n == '__init__'))


def _cases():
  cases = []
  for name in _public(jax_model.Recoder):
    cases.append(('Recoder', jax_model.Recoder, model.Recoder, name, name))
  for cls in ('MatrixFactorization', 'MultVAE', 'DynamicAutoencoder'):
    for name in MODEL_METHODS:
      cases.append((cls, getattr(jax_models, cls), getattr(models, cls),
                    name, name))
    cases.append((cls, getattr(jax_models, cls), getattr(models, cls),
                  'apply', 'forward'))
    cases.append((cls, getattr(jax_models, cls), getattr(models, cls),
                  'apply_gathered', 'apply_gathered'))
  for cls in ('EASE', 'IALS'):
    for name in _public(getattr(jax_models, cls)):
      cases.append((cls, getattr(jax_models, cls), getattr(models, cls),
                    name, name))
  cases.append(('RecommenderEvaluator', jax_metrics.RecommenderEvaluator,
                metrics.RecommenderEvaluator, 'evaluate', 'evaluate'))
  for name in ('unzip', 'normalize', 'dataframe_to_csr_matrix'):
    cases.append(('utils', jax_utils, utils, name, name))
  # the serving surface: the CLI's functions, the embeddings indexes and
  # their native forest, the similarity recommender, the preprocessing
  # the mesh package
  for name in jax_parallel.__all__:
    if name == 'MeshConfig':
      cases.append(('MeshConfig', jax_parallel.MeshConfig,
                    parallel.MeshConfig, '__init__', '__init__'))
    else:
      cases.append(('parallel', jax_parallel, parallel, name, name))
  for name in ('parse_metrics', '_load_datasets', '_build_model',
               '_fit_model_kind', '_is_fit_model', '_load_fit_model',
               '_build_trainer', 'cmd_train', '_evaluate_fit_model',
               'cmd_evaluate', 'cmd_recommend', 'make_server', 'cmd_serve',
               'main'):
    cases.append(('cli', jax_cli, cli, name, name))
  for cls in ('EmbeddingsIndex', 'BruteForceEmbeddingsIndex',
              'AnnEmbeddingsIndex', 'MemCacheEmbeddingsIndex'):
    for name in _public(getattr(jax_embedding, cls)):
      cases.append((cls, getattr(jax_embedding, cls),
                    getattr(embedding, cls), name, name))
  cases.append(('embedding', jax_embedding, embedding,
                'build_embeddings_index', 'build_embeddings_index'))
  for name in _public(jax_ann.AnnIndex):
    cases.append(('AnnIndex', jax_ann.AnnIndex, ann.AnnIndex, name, name))
  for name in _public(jax_recommender.SimilarityRecommender):
    cases.append(('SimilarityRecommender',
                  jax_recommender.SimilarityRecommender,
                  recommender.SimilarityRecommender, name, name))
  for name in ('get_count', 'filter_triplets', 'split_train_test_proportion',
               'strong_generalization_split'):
    cases.append(('preprocessing', jax_preprocessing, preprocessing, name,
                  name))
  # the host loader and the directory checkpoint
  for cls in ('RecommendationDataLoader', 'BatchCollator'):
    for name in _public(getattr(jax_loader, cls)):
      cases.append((cls, getattr(jax_loader, cls), getattr(loader, cls),
                    name, name))
  for name in ('save_checkpoint_orbax', 'load_checkpoint_orbax',
               'wait_for_pending_saves', 'is_orbax_checkpoint'):
    cases.append(('checkpoint_orbax', jax_checkpoint_orbax, checkpoint_orbax,
                  name, name))
  return cases


@pytest.mark.parametrize('owner,jax_cls,port_cls,jax_name,port_name',
                         _cases(), ids=lambda v: v if isinstance(v, str)
                         else '')
def test_signature_matches_jax(owner, jax_cls, port_cls, jax_name,
                               port_name):
  if (owner, jax_name) in JAX_ONLY_METHODS:
    # (an allowed difference: the method comes with its Queue 1 item)
    assert not hasattr(port_cls, port_name)
    return
  # (the mesh package's functions take real parameter dicts: nothing of
  # the functional form to drop)
  functional = () if owner == 'parallel' else JAX_FUNCTIONAL
  if owner in ('RecommendationDataLoader', 'BatchCollator'):
    functional = JAX_PADDING
  want = _params(getattr(jax_cls, jax_name), drop=functional,
                 rename=RENAMED)
  got = _params(getattr(port_cls, port_name), drop=PORT_ONLY)
  assert got == want, f'{owner}.{port_name}: {got} != {want}'


def test_device_is_keyword_only_on_the_trainer():
  param = inspect.signature(model.Recoder).parameters['device']
  assert param.kind is inspect.Parameter.KEYWORD_ONLY
  assert param.default == 'cuda'


def test_reference_positional_call_binds_use_cuda():
  m = models.DynamicAutoencoder([4])
  tr = model.Recoder(m, None, None, 'adam', 'mse', None, False,
                     device='cpu')
  assert tr.user_based is True and tr.item_based is True
  tr = model.Recoder(model=m, use_cuda=True, optimizer_type='adam',
                     device='cpu')
  assert tr.optimizer_type == 'adam'


def _matrix():
  rng = np.random.default_rng(0)
  return sp.csr_matrix((rng.random((20, 30)) < 0.2).astype(np.float32))


@pytest.mark.parametrize('kw,where', [
    (dict(mesh=ONE_RANK_MESH), 'Queue 1 item 7'),
    (dict(eval_item_chunk=1024), 'Queue 1 item 5'),
    (dict(eval_topk='approx'), 'Queue 1 item 5')])
def test_queue_one_arguments_of_the_trainer_raise(kw, where):
  if where in PORTED:
    made = kw.get('mesh') == ONE_RANK_MESH
    if made:
      kw = dict(kw, mesh=parallel.make_mesh(parallel.MeshConfig(1, 1),
                                            devices='cpu'))
    try:
      tr = model.Recoder(models.DynamicAutoencoder([4]), device='cpu', **kw)
      for name, value in kw.items():
        assert getattr(tr, name) is value or getattr(tr, name) == value
    finally:
      if made:
        torch.distributed.destroy_process_group()
    return
  with pytest.raises(NotImplementedError, match=where):
    model.Recoder(models.DynamicAutoencoder([4]), device='cpu', **kw)


@pytest.mark.parametrize('kw,where', [
    (dict(num_random_negatives=4), None),  # ported: it trains
    # (ported: without a mesh the JAX trainer ignores it, and trains)
    (dict(table_sharding=True), None)])
def test_queue_one_arguments_of_train_raise(kw, where):
  tr = model.Recoder(models.DynamicAutoencoder([4]), optimizer_type='adam',
                     device='cpu')
  if where is None:
    tr.train(RecommendationDataset(_matrix()), batch_size=8,
             negative_sampling=True, **kw)
    assert len(tr.last_epoch_losses) == 3
    assert np.all(np.isfinite(tr.last_epoch_losses))
    return
  with pytest.raises(NotImplementedError, match=where):
    tr.train(RecommendationDataset(_matrix()), batch_size=8,
             negative_sampling=True, **kw)


def test_save_state_backends(tmp_path):
  tr = model.Recoder(models.DynamicAutoencoder([4]), optimizer_type='adam',
                     device='cpu')
  tr.train(RecommendationDataset(_matrix()), batch_size=8,
           negative_sampling=True, table_sharding=False)
  path = tr.save_state(str(tmp_path / 'a'), backend='npz', async_save=True)
  back = model.Recoder(models.DynamicAutoencoder(), device='cpu')
  back.init_from_model_file(path)
  # (ported: the directory checkpoint constructs and writes)
  for async_save in (True, False):
    directory = tr.save_state(str(tmp_path / f'b{async_save}'),
                              backend='orbax', async_save=async_save)
    assert directory.endswith('_epoch_1.orbax')
    back = model.Recoder(models.DynamicAutoencoder(), device='cpu')
    back.init_from_model_file(directory)
    assert os.path.isfile(os.path.join(directory, '.metadata'))
  with pytest.raises(ValueError, match='backend'):
    tr.save_state(str(tmp_path / 'c'), backend='zarr')


def test_utils_match_jax():
  pairs = [(1, 'a'), (2, 'b'), (3, 'c')]
  assert utils.unzip(pairs) == jax_utils.unzip(pairs) == [[1, 2, 3],
                                                          ['a', 'b', 'c']]
  x = np.random.default_rng(1).random((4, 3))
  for axis in (None, 0, 1):
    np.testing.assert_array_equal(utils.normalize(x, axis),
                                  jax_utils.normalize(x, axis))
  np.testing.assert_array_equal(utils.normalize(x[0]),
                                jax_utils.normalize(x[0]))
