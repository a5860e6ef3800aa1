"""The port's iALS and EASE fits on a ('data', 'model') mesh of gloo ranks
on the CPU, and the CLI's ``mesh_model`` for them.

Each mesh shape is one spawn of 1, 2 or 4 processes
(``torch_mesh_workers.spawn``) that fits iALS with both factor shardings
(the JAX test's fixture, ``tests/test_ials.py``, at a chunk budget whose
chunks are smaller than the mesh), runs one user and one item half-sweep
of each layout from the JAX mesh fit's factors, and fits EASE
(``tests/test_ease.py``'s sharded-solve fixture at 67 items, which the
'model' ranks split unevenly); the (2, 2) spawn also runs ``cli train``
of ials, ease and multvae with ``trainer.mesh_model=2``. The test holds
them

* against the port's one-device fits at the JAX mesh tests' tolerances:
  iALS batch-sharded rtol 1e-6 / atol 1e-6, ``factor_sharding='users'``
  rtol 1e-5 / atol 5e-6 and its objective rtol 1e-6
  (``tests/test_ials.py``), a (1, 1) mesh bitwise; the EASE mesh B
  against the one-device Cholesky B at rtol 5e-4 / atol 5e-5
  (``tests/test_ease.py``);
* against the JAX package's mesh fits on the conftest's 8 virtual CPU
  devices (``MeshConfig(data=4, model=2)`` for iALS; ``(8, 1)`` for
  EASE, since a JAX mesh splits rows evenly only and 67 is prime): each
  half-sweep from the same factors (carried over by
  ``convert.ials_factors_from_numpy``) at the iALS tolerances above, the
  EASE B at rtol 5e-4 / atol 5e-5. The whole iALS fits differ between
  the packages by their libraries' summation orders, which grow through
  the sweeps (the one-device fits do too: ``tests/test_torch_ials.py``
  holds them within 5e-5 of max |factor|), so they are held at that
  bound.

A spawn that does not end within ``workers.TIMEOUT`` seconds is killed
and fails its tests.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

import torch_mesh_workers as workers
from recoder_tpu.models import EASE as JaxEASE
from recoder_tpu.models import IALS as JaxIALS
from recoder_tpu.parallel import MeshConfig as JaxMeshConfig
from recoder_tpu.parallel import make_mesh as jax_make_mesh
from recoder_tpu_torch import cli
from recoder_tpu_torch.checkpoint import load_checkpoint
from recoder_tpu_torch.data import UsersInteractions
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import EASE, IALS, MultVAE

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IDS = [f'{d}x{m}' for d, m in SHAPES]
MODES = {'rows': None, 'users': 'users'}
#: (rtol, atol) of the mesh fits, by factor sharding (tests/test_ials.py)
IALS_TOL = {'rows': (1e-6, 1e-6), 'users': (1e-5, 5e-6)}
#: the package-to-package bound of a whole fit, of max |factor|
#: (tests/test_torch_ials.py)
PACKAGES_ATOL = 5e-5
EASE_TOL = dict(rtol=5e-4, atol=5e-5)


@functools.lru_cache(maxsize=None)
def _jax_ials(mode, sweeps=workers.IALS_KW['sweeps']):
  kw = dict(workers.IALS_KW, sweeps=sweeps)
  return JaxIALS(**kw).fit(workers.ials_matrix(),
                           chunk_elems=workers.IALS_CHUNK,
                           mesh=jax_make_mesh(JaxMeshConfig(data=4, model=2)),
                           factor_sharding=MODES[mode])


def _given():
  """The factors the half-sweeps start from: the JAX mesh fit's after 2
  sweeps."""
  ref = _jax_ials('rows', sweeps=2)
  return {'user_factors': np.asarray(ref.user_factors),
          'item_factors': np.asarray(ref.item_factors)}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """``{shape: directory}`` of the spawned fits, each made at first
  use."""
  root = tmp_path_factory.mktemp('mesh_fits')
  done = {}

  def get(shape):
    if shape not in done:
      out = str(root / f'mesh_{shape[0]}x{shape[1]}')
      os.makedirs(out)
      np.savez(os.path.join(out, 'ials_given.npz'), **_given())
      cases = ['ials', 'ease']
      if shape == (2, 2):
        workers.cli_data(out)
        cases.append('cli_fits')
      workers.spawn(out, shape, cases)
      done[shape] = out
    return done[shape]
  return get


@functools.lru_cache(maxsize=None)
def _one_device_ials():
  return workers.ials_fit(None)


def _factors(path):
  arrays, _ = load_checkpoint(path)
  return arrays['user_factors'], arrays['item_factors']


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_ials_mesh_fit_matches_one_device(runs, shape, mode):
  out = runs(shape)
  ref = _one_device_ials()
  users, items = _factors(os.path.join(out, f'ials_{mode}.model'))
  want_u, want_i = ref.user_factors.numpy(), ref.item_factors.numpy()
  assert users.shape == want_u.shape
  if shape == (1, 1):
    np.testing.assert_array_equal(users, want_u)
    np.testing.assert_array_equal(items, want_i)
  else:
    rtol, atol = IALS_TOL[mode]
    np.testing.assert_allclose(users, want_u, rtol=rtol, atol=atol)
    np.testing.assert_allclose(items, want_i, rtol=rtol, atol=atol)
  with open(os.path.join(out, f'ials_{mode}_0.json')) as f:
    objective = json.load(f)['objective']
  np.testing.assert_allclose(objective,
                             ref.objective(workers.ials_matrix()), rtol=1e-6)
  # the saved model serves the one-device fit's recommendations
  m = workers.ials_matrix()
  ui = UsersInteractions(users=np.arange(m.shape[0]), interactions_matrix=m)
  back = IALS(device='cpu').load(os.path.join(out, f'ials_{mode}.model'))
  np.testing.assert_array_equal(np.asarray(back.recommend(ui, 5)),
                                np.asarray(ref.recommend(ui, 5)))


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_ials_mesh_half_sweeps_match_the_jax_mesh(runs, shape, mode):
  """One user and one item half-sweep from the same factors: the port's
  mesh layout against the JAX package's on its (4, 2) mesh."""
  import jax.numpy as jnp
  out = runs(shape)
  given = _given()
  jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
  m = workers.ials_matrix()
  model = JaxIALS(**workers.IALS_KW)
  if mode == 'rows':
    users = model._solve_side(m, jnp.asarray(given['item_factors']),
                              chunk_elems=workers.IALS_CHUNK, mesh=jmesh)
    items = model._solve_side(m.T.tocsr(), jnp.asarray(given['user_factors']),
                              chunk_elems=workers.IALS_CHUNK, mesh=jmesh)
  else:
    users, items = _jax_users_half_sweeps(model, m, given, jmesh)
  got = np.load(os.path.join(out, f'ials_{mode}_halves.npz'))
  rtol, atol = IALS_TOL[mode]
  np.testing.assert_allclose(got['user_factors'], np.asarray(users),
                             rtol=rtol, atol=atol)
  np.testing.assert_allclose(got['item_factors'], np.asarray(items),
                             rtol=rtol, atol=atol)


def _jax_users_half_sweeps(model, m, given, mesh):
  """The JAX ``factor_sharding='users'`` half-sweeps
  (``_user_sharded_fns``) from ``given``: ``(users [n_users, d], items)``."""
  import jax.numpy as jnp
  from recoder_tpu.models.ials import _user_sharded_fns
  fns = _user_sharded_fns(mesh)
  n_users, d = given['user_factors'].shape
  n_pad = -(-(n_users + 1) // mesh.size) * mesh.size
  user_plan = model._chunk_plan(m, workers.IALS_CHUNK, mesh=mesh)
  item_plan = model._chunk_plan(m.T.tocsr(), workers.IALS_CHUNK, mesh=mesh)
  alpha = jnp.float32(model.alpha)
  item_f = jax.device_put(jnp.asarray(given['item_factors']), fns['rep'])
  item_pad = jax.device_put(
      jnp.concatenate([item_f, jnp.zeros((1, d), jnp.float32)]), fns['rep'])
  gram_i = jnp.matmul(item_f.T, item_f, precision=jax.lax.Precision.HIGHEST)
  users = fns['zeros'](n_pad, d)
  for c in user_plan['chunks']:
    users = fns['user_solve'](users, item_pad, gram_i, c['rows'], c['cols'],
                              c['vals'], alpha, c['reg'])
  user_f = np.zeros((n_pad, d), np.float32)
  user_f[:n_users] = given['user_factors']
  user_f = jax.device_put(jnp.asarray(user_f), fns['rows_sharding'])
  gram_u = fns['gram'](user_f)
  items = jax.device_put(jnp.zeros(given['item_factors'].shape, jnp.float32),
                         fns['rep'])
  for c in item_plan['chunks']:
    items = fns['item_solve'](items, user_f, gram_u, c['rows'], c['cols'],
                              c['vals'], alpha, c['reg'], jnp.int32(n_users))
  return np.asarray(users)[:n_users], items


@pytest.mark.parametrize('mode', list(MODES))
def test_ials_mesh_fit_against_the_jax_mesh_fit(runs, mode):
  out = runs((2, 2))
  ref = _jax_ials(mode)
  users, items = _factors(os.path.join(out, f'ials_{mode}.model'))
  for got, want in ((users, np.asarray(ref.user_factors)[:users.shape[0]]),
                    (items, np.asarray(ref.item_factors))):
    assert np.max(np.abs(got - want)) <= PACKAGES_ATOL * np.max(np.abs(want))


@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_ials_users_shards_hold_their_rows(runs, shape):
  """``factor_sharding='users'``: each rank holds ``ceil((50 + 1) /
  ranks)`` user rows; the batch-sharded fit holds all 50 everywhere."""
  out = runs(shape)
  world = shape[0] * shape[1]
  for rank in range(world):
    with open(os.path.join(out, f'ials_users_{rank}.json')) as f:
      assert json.load(f)['user_factors'] == [-(-51 // world), 6]
    with open(os.path.join(out, f'ials_rows_{rank}.json')) as f:
      assert json.load(f)['user_factors'] == [50, 6]


@functools.lru_cache(maxsize=None)
def _one_device_ease():
  return EASE(lam=workers.EASE_LAM, device='cpu').fit(workers.ease_matrix())


@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_ease_mesh_matches_cholesky_and_the_jax_mesh(runs, shape):
  out = runs(shape)
  arrays, _ = load_checkpoint(os.path.join(out, 'ease.model'))
  got = arrays['item_weights']
  ref = _one_device_ease()
  np.testing.assert_allclose(got, ref.item_weights.numpy(), **EASE_TOL)
  assert np.all(np.diag(got) == 0)
  # (JAX splits rows evenly only: its mesh of one 'model' way takes the
  # 67 items, through the same sharded Newton-Schulz solve)
  jax_b = JaxEASE(lam=workers.EASE_LAM).fit(
      workers.ease_matrix(), mesh=jax_make_mesh(JaxMeshConfig(data=8,
                                                              model=1)))
  np.testing.assert_allclose(got, np.asarray(jax_b.item_weights),
                             **EASE_TOL)
  m = workers.ease_matrix()
  ui = UsersInteractions(users=np.arange(12), interactions_matrix=m[:12])
  np.testing.assert_array_equal(
      np.load(os.path.join(out, 'ease_top.npy')),
      np.asarray([list(r) for r in ref.recommend(ui, 5)]))


@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_ease_no_rank_holds_a_whole_buffer(runs, shape):
  """Each rank's Gram, Newton-Schulz iterate and B hold at most
  ``ceil(n / model)`` of the n = 67 rows, and so does every tensor that
  ``save`` makes (B goes to rank 0's host a row block at a time); the
  iteration converged below the JAX acceptance bound."""
  out = runs(shape)
  n, ways = 67, shape[1]
  sizes = [len(r) for r in np.array_split(np.arange(n), ways)]
  for rank in range(shape[0] * shape[1]):
    with open(os.path.join(out, f'ease_{rank}.json')) as f:
      info = json.load(f)
    rows = sizes[rank % ways]
    assert rows <= -(-n // ways)
    for key in ('gram_shape', 'iterate_shape', 'weights'):
      assert info[key] == [rows, n], (key, info[key])
    assert info['save_rows'] <= -(-n // ways), info['save_rows']
    if ways > 1 and rank < ways:  # (the first 'data' row gathers)
      assert info['save_rows'] > 0
    assert info['residual'] < 1e-4
    assert sum(info['iterations']) > 0


def _cli_one_device(tmp_path, name, model_cfg):
  cli.cmd_train({'data': {'train': os.path.join(tmp_path, 'fit_train.csv')},
                 'model': model_cfg,
                 'train': {'model_checkpoint_prefix':
                           os.path.join(tmp_path, name)}})
  return load_checkpoint(os.path.join(tmp_path, f'{name}.model'))[0]


def test_cli_mesh_model_fits_ials_ease_and_multvae(runs, tmp_path):
  out = runs((2, 2))
  workers.cli_data(str(tmp_path))
  ials = {'type': 'ials', 'device': 'cpu', 'chunk_elems': workers.IALS_CHUNK,
          **workers.IALS_KW}
  ref = _cli_one_device(str(tmp_path), 'ials', ials)
  for name, (rtol, atol) in (('cli_ials', IALS_TOL['rows']),
                             ('cli_ials_users', IALS_TOL['users'])):
    got, _ = load_checkpoint(os.path.join(out, f'{name}.model'))
    for key in ('user_factors', 'item_factors'):
      np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol)
  ref = _cli_one_device(str(tmp_path), 'ease',
                        {'type': 'ease', 'device': 'cpu',
                         'lam': workers.EASE_LAM})
  got, _ = load_checkpoint(os.path.join(out, 'cli_ease.model'))
  np.testing.assert_allclose(got['item_weights'], ref['item_weights'],
                             **EASE_TOL)
  # the Mult-VAE trainer's checkpoint, gathered on the mesh, loads on one
  # device
  back = Recoder(MultVAE(), device='cpu')
  back.init_from_model_file(os.path.join(out, 'cli_multvae_epoch_1.model'))
  assert back.model.de_embedding.shape[0] == back.model.num_items_padded
