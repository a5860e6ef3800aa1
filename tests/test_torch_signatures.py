"""The port's public signatures against the JAX package's.

For each public callable of the port -- every public ``Recoder`` method,
the model classes (their constructors, hyper-parameter and sparse-plan
methods, and ``forward`` / ``apply_gathered`` against the JAX ``apply``
/ ``apply_gathered``), ``EASE``, ``IALS``,
``RecommenderEvaluator.evaluate`` and the ``utils`` functions -- the
parameter names in order and their defaults must equal the JAX
original's. The only differences allowed are named below:

* port-only parameters: ``device`` (where a trainer or a fitted model
  lives), and the test draws ``keep_mask`` / ``eps`` of a model's
  forward;
* the forward's translation of the JAX functional form: no ``params``
  (the module holds them), ``generator`` for ``rng``, and no
  ``items_sorted_unique`` (an XLA promise with no PyTorch counterpart);
* JAX-only methods whose modules are still in ROADMAP Queue 1 (none
  since ``Recoder.recommend_async`` was ported).

The arguments whose modules Queue 1 still holds are taken at their JAX
positions and raise NotImplementedError when set; that is checked too,
and that the ones since ported (``eval_item_chunk``, ``eval_topk``)
construct.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp

import recoder_tpu.metrics as jax_metrics
import recoder_tpu.model as jax_model
import recoder_tpu.models as jax_models
import recoder_tpu.utils as jax_utils
import recoder_tpu_torch.metrics as metrics
import recoder_tpu_torch.model as model
import recoder_tpu_torch.models as models
import recoder_tpu_torch.utils as utils
from recoder_tpu_torch.data import RecommendationDataset

#: parameters only the port has
PORT_ONLY = {'device', 'keep_mask', 'eps'}
#: the JAX functional form's parameters a module's forward drops
JAX_FUNCTIONAL = {'params', 'items_sorted_unique'}
RENAMED = {'rng': 'generator'}
#: public JAX methods the port does not have yet, with their ROADMAP item
JAX_ONLY_METHODS = {}
#: Queue 1 items ported since their arguments were added: they construct
PORTED = {'Queue 1 item 5'}

MODEL_METHODS = ('__init__', 'init_model', 'model_params',
                 'load_model_params', 'sparse_param_paths', 'sparse_entries')


def _params(fn, drop=(), rename=None):
  out = []
  for p in inspect.signature(fn).parameters.values():
    if p.name == 'self' or p.name in drop:
      continue
    name = (rename or {}).get(p.name, p.name)
    default = None if p.default is inspect.Parameter.empty else p.default
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
  want = _params(getattr(jax_cls, jax_name), drop=JAX_FUNCTIONAL,
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
    (dict(mesh=object()), 'Queue 1 item 7'),
    (dict(eval_item_chunk=1024), 'Queue 1 item 5'),
    (dict(eval_topk='approx'), 'Queue 1 item 5')])
def test_queue_one_arguments_of_the_trainer_raise(kw, where):
  if where in PORTED:
    tr = model.Recoder(models.DynamicAutoencoder([4]), device='cpu', **kw)
    for name, value in kw.items():
      assert getattr(tr, name) == value
    return
  with pytest.raises(NotImplementedError, match=where):
    model.Recoder(models.DynamicAutoencoder([4]), device='cpu', **kw)


@pytest.mark.parametrize('kw,where', [
    (dict(num_random_negatives=4), None),  # ported: it trains
    (dict(table_sharding=True), 'Queue 1 item 7')])
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
  with pytest.raises(NotImplementedError, match='Queue 1 item 5'):
    tr.save_state(str(tmp_path / 'b'), backend='orbax')
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
