"""The port's trainer on a ('data', 'model') mesh of gloo ranks on the CPU.

Each mesh shape is one spawn of 1, 2 or 4 processes (a file store, one
thread each) that runs every case of ``torch_mesh_workers.CASES`` --
DynamicAutoencoder with 'users' and 'blocks', full decode, logloss dense
and sparse, a target matrix through the host loader, MatrixFactorization
dense and sparse, Mult-VAE over unions, over the full catalog and with
sparse tables, a custom ``Loss`` over a union and over the full catalog,
and the 'blocks' tables split over 'data' (``table_sharding='data'``:
unions, full decode, dual CSRs, five blocks; their parameters also at the
JAX ``tests/test_sharding.py``'s atol 2e-5, and on a (3, 1) mesh too) --
and writes what rank 0's ``save_state`` gathers. The
test holds them against the port's single-device runs: (1, 1) bitwise,
(2, 1), (1, 2) and (2, 2) at the JAX mesh tests' tolerances (rtol 5e-4,
atol 1e-5: ``tests/test_sharding.py``), the parameters and every Adam
moment, ``predict``, ``recommend`` (one matrix and chunked), the
validation loss and an evaluation too. Under 'data'-sharded tables each
rank's tables and CSR arrays are its share. On (2, 2) it also checks
that no rank holds a whole table or its moments, that a checkpoint written on
the mesh loads into the single-device port and into the JAX ``Recoder``
and trains on back on the mesh, that a directory checkpoint
(``backend='orbax'``) written on it loads back bitwise like its npz,
that the CLI's ``mesh_model`` builds
the mesh inside the launch, and that the slice fixture of
``tests/test_torch_slice.py`` trains on the port's (2, 2) mesh to the
JAX package's (4, 2) mesh (the conftest's 8 virtual CPU devices), the
autoencoder and a Mult-VAE (eps = 0 in both packages).

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
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MultVAE as JaxMultVAE
from recoder_tpu.parallel import MeshConfig as JaxMeshConfig
from recoder_tpu.parallel import make_mesh as jax_make_mesh
from recoder_tpu_torch.checkpoint import load_checkpoint
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
CASES = list(workers.CASES)
TABLE_CASES = [c for c in CASES if c.startswith('tables_')]
RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """``{shape: directory}`` of the spawned runs, each made at first
  use."""
  root = tmp_path_factory.mktemp('mesh')
  slice_init = _jax_slice_init()
  vae_init = _jax_slice_init(vae=True)
  done = {}

  def get(shape):
    if shape not in done:
      out = str(root / f'mesh_{shape[0]}x{shape[1]}')
      os.makedirs(out)
      cases = CASES if shape in SHAPES else TABLE_CASES
      if shape == (2, 2):
        np.savez(os.path.join(out, 'slice_init.npz'), **slice_init)
        np.savez(os.path.join(out, 'vae_slice_init.npz'), **vae_init)
        cases = CASES + ['resume', 'slice', 'vae_slice', 'cli', 'orbax']
      workers.spawn(out, shape, cases)
      done[shape] = out
    return done[shape]
  return get


@functools.lru_cache(maxsize=None)
def _single_device(case, root):
  tr, path = workers.train_case(case, None, os.path.join(root, case))
  return load_checkpoint(path)[0], workers.scoring(tr)


def _flat(tree, prefix=''):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flat(v, f'{prefix}{k}/')
    else:
      yield prefix + k, np.asarray(v)


def _arrays(ckpt):
  """Every parameter and moment of a checkpoint's trees, by path."""
  return {k: v for tree in ('model', 'optimizer', 'sparse_optimizer')
          if tree in ckpt for k, v in _flat(ckpt[tree], tree + '/')}


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_mesh_training_matches_single_device(runs, tmp_path_factory, shape,
                                             case):
  _held_to_single_device(runs, tmp_path_factory, shape, case)


@pytest.mark.parametrize('case', TABLE_CASES)
def test_data_sharded_tables_on_three_data_ranks(runs, tmp_path_factory,
                                                 case):
  """The table cases on a (3, 1) mesh, whose 'data' ways divide neither
  the two blocks of most cases nor the five of ``tables_odd_blocks``,
  against the single device's replicated tables."""
  _held_to_single_device(runs, tmp_path_factory, (3, 1), case)


def _held_to_single_device(runs, tmp_path_factory, shape, case):
  out = runs(shape)
  ref_root = str(tmp_path_factory.getbasetemp() / 'single')
  os.makedirs(ref_root, exist_ok=True)
  ref_ckpt, ref_scoring = _single_device(case, ref_root)
  got_ckpt, _ = load_checkpoint(os.path.join(out, f'{case}_epoch_2.model'))
  ref, got = _arrays(ref_ckpt), _arrays(got_ckpt)
  assert ref.keys() == got.keys()
  scoring = np.load(os.path.join(out, f'{case}_scoring.npz'))
  # (predict's scores, the validation loss and the mean Recall@5)
  measures = ('scores', 'val_loss', 'recall')
  if shape == (1, 1):
    for k in ref:
      np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in measures:
      np.testing.assert_array_equal(scoring[k], ref_scoring[k], err_msg=k)
  else:
    for k in ref:
      np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                 err_msg=k)
      if case in TABLE_CASES and k.startswith('model/'):
        # (tests/test_sharding.py's bound on parameters trained over
        # 'data'-sharded tables against replicated ones)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    for k in measures:
      np.testing.assert_allclose(scoring[k], ref_scoring[k], rtol=RTOL,
                                 atol=ATOL, err_msg=k)
  np.testing.assert_array_equal(scoring['top'], ref_scoring['top'])
  np.testing.assert_array_equal(scoring['top_chunked'], ref_scoring['top'])


@pytest.mark.parametrize('case', TABLE_CASES)
@pytest.mark.parametrize('shape', SHAPES + [(3, 1)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
def test_data_sharded_tables_hold_the_ranks_share(runs, shape, case):
  """Under ``table_sharding='data'`` on more than one 'data' rank each
  rank holds its rows of the block union table (``ceil(n_blocks / D)``,
  the table padded to a multiple of D) and its chunk of each flat CSR
  array (``ceil((len - halo) / D)`` entries and the halo); the per-user
  ``indptr`` and the widths stay whole, as in JAX. Full decode's slab
  declines with the JAX reason. On one 'data' rank the tables stay
  replicated, as JAX keeps them."""
  out = runs(shape)
  ways = shape[0]
  for rank in range(shape[0] * shape[1]):
    with open(os.path.join(out, f'{case}_tables_{rank}.json')) as f:
      got = json.load(f)
    if ways == 1:
      assert got['sharding'] is None
      assert got['decline'] != "'data'-sharded CSR storage"
      assert all(held == whole for held, whole in got['shapes'].values())
      continue
    assert got['sharding'] == 'data'
    split = 0
    for key, (held, whole) in got['shapes'].items():
      prefix = 'tg_' if key.startswith('tg_') else ''
      name = key[len(prefix):]
      want = list(whole)
      if name == 'unions':
        want[0] = -(-whole[0] // ways)
      elif name in ('cols', 'raw', 'vals'):
        halo = got['halo'][prefix]
        want[0] = -(-(whole[0] - halo) // ways) + halo
      split += want != whole
      assert held == want, (case, rank, key, held, want)
    assert split
    if case == 'tables_full_decode':
      assert got['decline'] == "'data'-sharded CSR storage"
      assert 'raw' in got['shapes']


@pytest.mark.parametrize('shape', [(1, 2), (2, 2)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
def test_no_rank_holds_a_whole_table(runs, shape):
  out = runs(shape)
  model_ways = shape[1]
  for case in CASES:
    ckpt, _ = load_checkpoint(os.path.join(out, f'{case}_epoch_2.model'))
    whole = {k: v.shape for k, v in ckpt['model'].items()}
    split = [k for k in whole
             if k.endswith('embedding') or k in ('de_bias', 'bias')]
    assert split
    for rank in range(shape[0] * shape[1]):
      with open(os.path.join(out, f'{case}_shapes_{rank}.json')) as f:
        shapes = json.load(f)
      for k, v in shapes.items():
        name = k.split('/')[1]
        want = list(whole[name])
        if name in split:
          want[0] //= model_ways
        assert v == want, (case, rank, k, v, want)


def test_cli_mesh_model_builds_the_mesh_inside_a_launch(runs):
  out = runs((2, 2))
  for rank in range(4):
    with open(os.path.join(out, f'cli_{rank}.json')) as f:
      assert json.load(f) == {'data': 2, 'model': 2}


def test_mesh_checkpoint_loads_into_one_device_and_jax_and_resumes(
    runs, tmp_path):
  out = runs((2, 2))
  with open(os.path.join(out, 'resume_shapes_0.json')) as f:
    record = json.load(f)
  first, resumed = record['first'], record['done']
  # (the tables and the moments loaded and trained on as the rank's rows)
  assert record['loaded']['param/en_embedding'] == [256, 16]
  assert record['trained']['m/en_embedding'] == [256, 16]
  assert {k: v for k, v in record['trained'].items()
          if k.startswith('param/')} == record['loaded']
  arrays, _ = load_checkpoint(first)
  # into one device of the port
  port = Recoder(DynamicAutoencoder(), optimizer_type='adam', seed=7,
                 device='cpu')
  port.init_from_model_file(first)
  for k, p in port.model.params().items():
    np.testing.assert_array_equal(p.detach().numpy(), arrays['model'][k])
  # into the JAX package
  jtr = JaxRecoder(JaxDynAE(), optimizer_type='adam', seed=7)
  jtr.init_from_model_file(first)
  for k, v in arrays['model'].items():
    np.testing.assert_array_equal(np.asarray(jtr.model.params[k]), v,
                                  err_msg=k)
  # the mesh's resumed epoch against the single device's
  port.train(workers.dataset(), batch_size=16, lr=1e-3, weight_decay=1e-4,
             num_epochs=3, negative_sampling=True, num_sampling_users=32,
             shuffle='users')
  ref = _arrays(load_checkpoint(port.save_state(str(tmp_path / 'r')))[0])
  got = _arrays(load_checkpoint(resumed)[0])
  assert ref.keys() == got.keys()
  for k in ref:
    np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                               err_msg=k)


def test_mesh_directory_checkpoint_loads_bitwise_like_its_npz(runs):
  """On (2, 2), save_state(backend='orbax', async_save=True) gathers as
  the npz path does and rank 0 writes in the background; every rank
  reads it back (its rows), and the state written again is the npz."""
  from recoder_tpu_torch.checkpoint_orbax import load_checkpoint_orbax
  out = runs((2, 2))
  records = []
  for rank in range(4):
    with open(os.path.join(out, f'orbax_{rank}.json')) as f:
      records.append(json.load(f))
  assert len({(r['npz'], r['directory'], r['reloaded'])
              for r in records}) == 1
  record = records[0]
  assert record['directory'].endswith('orbax_epoch_2.orbax')
  npz, meta = load_checkpoint(record['npz'])
  # (each rank read back its half of the whole table's rows)
  whole = list(npz['model']['en_embedding'].shape)
  assert record['shapes']['param/en_embedding'] == [whole[0] // 2, whole[1]]
  arrays, got_meta = load_checkpoint_orbax(record['directory'])
  assert got_meta == meta
  want, got = _arrays(npz), _arrays(arrays)
  assert want.keys() == got.keys() and 'sparse_optimizer' in ''.join(got)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  # (the moments wait, as in JAX, for the next train() to be placed)
  reloaded = load_checkpoint(record['reloaded'])[0]['model']
  assert reloaded.keys() == npz['model'].keys()
  for k, v in npz['model'].items():
    np.testing.assert_array_equal(reloaded[k], v, err_msg=k)


def _jax_slice_trainer(vae=False, mesh=None):
  """The slice fixture's JAX trainer (the autoencoder, or the Mult-VAE
  under logloss)."""
  if vae:
    return JaxRecoder(JaxMultVAE(**workers.VAE_SLICE), optimizer_type='adam',
                      loss='logloss', seed=3, mesh=mesh)
  return JaxRecoder(JaxDynAE(workers.SLICE['hidden'], 'tanh', noise_prob=0.0),
                    optimizer_type='adam', loss='mse',
                    loss_params={'confidence': 3}, seed=3, mesh=mesh)


def _jax_slice_init(vae=False):
  tr = _jax_slice_trainer(vae)
  tr.num_items, tr.num_users = workers.SLICE['items'], workers.SLICE['users']
  tr._init_model()
  return {k: np.asarray(v) for k, v in tr.model.params.items()}


def test_port_mesh_matches_the_jax_mesh_on_the_slice_fixture(runs):
  out = runs((2, 2))
  init = _jax_slice_init()
  s = workers.SLICE
  jtr = JaxRecoder(JaxDynAE(s['hidden'], 'tanh', noise_prob=0.0),
                   optimizer_type='adam', loss='mse',
                   loss_params={'confidence': 3}, seed=3,
                   mesh=jax_make_mesh(JaxMeshConfig(data=4, model=2)))
  jtr.num_items, jtr.num_users = s['items'], s['users']
  jtr._init_model()
  jtr.model.params = {k: jax.device_put(v, jtr.model.params[k].sharding)
                      for k, v in init.items()}
  jtr.train(JaxDataset(workers.slice_matrix()), num_epochs=s['steps'],
            batch_size=s['batch'], lr=s['lr'], weight_decay=s['wd'],
            negative_sampling=True, shuffle='blocks', full_decode=True,
            slab_cache=True)
  got, _ = load_checkpoint(os.path.join(out, 'slice.npz'))
  for k, v in jtr.model.params.items():
    np.testing.assert_allclose(got['model'][k], np.asarray(v), atol=1e-5,
                               err_msg=k)
  # the per-step losses against the JAX step math on the epoch's batch
  # (the JAX trainer keeps no per-step record)
  ref = workers.slice_trainer(init)
  np.testing.assert_allclose(np.load(os.path.join(out, 'slice_losses.npy')),
                             workers.slice_losses(ref), rtol=1e-4)
  jax_losses = _jax_slice_step_losses(init)
  np.testing.assert_allclose(np.load(os.path.join(out, 'slice_losses.npy')),
                             jax_losses, rtol=1e-4)


def test_port_mesh_multvae_matches_the_jax_mesh_on_the_slice_fixture(
    runs, monkeypatch):
  """The slice fixture's Mult-VAE (no dropout, eps = 0 in both packages:
  ``jax.random.normal`` set to zeros) trained 4 steps on the port's (2, 2)
  mesh against the JAX package's (4, 2) mesh (atol 1e-5)."""
  import jax.numpy as jnp
  out = runs((2, 2))
  s = workers.SLICE
  init = _jax_slice_init(vae=True)
  monkeypatch.setattr(jax.random, 'normal',
                      lambda key, shape, dtype=jnp.float32:
                      jnp.zeros(shape, dtype))
  jtr = _jax_slice_trainer(vae=True,
                           mesh=jax_make_mesh(JaxMeshConfig(data=4, model=2)))
  jtr.num_items, jtr.num_users = s['items'], s['users']
  jtr._init_model()
  jtr.model.params = {k: jax.device_put(v, jtr.model.params[k].sharding)
                      for k, v in init.items()}
  jtr.train(JaxDataset(workers.slice_matrix()), num_epochs=s['steps'],
            batch_size=s['batch'], lr=s['lr'], weight_decay=s['wd'],
            negative_sampling=True, shuffle='blocks', full_decode=True,
            slab_cache=True)
  got, _ = load_checkpoint(os.path.join(out, 'vae_slice.npz'))
  for k, v in jtr.model.params.items():
    np.testing.assert_allclose(got['model'][k], np.asarray(v), atol=1e-5,
                               err_msg=k)
  assert len(np.load(os.path.join(out, 'vae_slice_losses.npy'))) == s['steps']


def _jax_slice_step_losses(init):
  """The JAX ``_dense_step_math`` losses of the slice fixture's steps
  (its one full-decode batch, as ``tests/test_torch_slice.py`` runs
  them)."""
  import jax.numpy as jnp
  s = workers.SLICE
  m = workers.slice_matrix()
  tr = JaxRecoder(JaxDynAE(s['hidden'], 'tanh', noise_prob=0.0),
                  optimizer_type='adam', loss='mse',
                  loss_params={'confidence': 3}, seed=3)
  tr.num_items, tr.num_users = s['items'], s['users']
  tr._init_model()
  tr.model.params = {k: jnp.asarray(v) for k, v in init.items()}
  tr._init_training(JaxDataset(m), weight_decay=s['wd'])
  slab = np.zeros((s['batch'], tr.model.num_items_padded), np.float32)
  slab[:s['users'], :s['items']] = m.toarray()
  batch = {'in_slab': jnp.asarray(slab), 'in_users': jnp.arange(s['batch']),
           'in_items': None, 'in_valid_users': jnp.float32(s['users']),
           'in_valid_width': jnp.int32(0), 'fd': True,
           'fd_mask_from_slab': True}
  params, opt_state, losses = tr.model.params, tr.opt_state, []
  for _ in range(s['steps']):
    params, opt_state, loss = tr._dense_step_math(
        params, opt_state, batch, jnp.float32(s['lr']), None)
    losses.append(float(loss))
  return losses

