"""The port's directory checkpoint (``recoder_tpu_torch.checkpoint_orbax``,
PyTorch's DCP format) against the contract of the JAX package's Orbax
backend: one counterpart of each JAX test in ``tests/test_checkpoint.py``
(but the legacy sidecar format, which the port never wrote) -- the round
trip against npz, a crash while writing keeps the old checkpoint (sync
and async), both windows of an interrupted swap recover, a save after
an interrupted swap keeps the recovered checkpoint, a failed async save
fails the process exit (rc 1), bf16 optimizer state round trips bit for
bit -- and, across packages: a tree the JAX package's Orbax backend wrote
is refused with a ValueError naming the npz route, and a port directory
re-saved as npz loads in the JAX ``Recoder`` and predicts as the port
does (1e-6). The (2, 2) mesh's directory checkpoint is in
``tests/test_torch_mesh.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch import checkpoint_orbax as co
from recoder_tpu_torch.checkpoint import flatten_tree, load_checkpoint
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(seed=0):
  rng = np.random.default_rng(seed)
  dense = np.zeros((30, 50), np.float32)
  dense[rng.integers(0, 30, 300), rng.integers(0, 50, 300)] = 1.0
  return RecommendationDataset(sp.csr_matrix(dense))


def _dying_write(path, state_dict):
  raise OSError('simulated crash mid-save')


def _same_arrays(a, b):
  fa, fb = flatten_tree(a), flatten_tree(b)
  assert fa.keys() == fb.keys()
  for k in fa:
    assert fa[k].dtype == fb[k].dtype, k
    np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize('opt_state_dtype', [None, 'bfloat16'],
                         ids=['float32', 'bf16_moments'])
@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'sparse'])
def test_orbax_backend_roundtrip(tmp_path, sparse, opt_state_dtype):
  """backend='orbax' writes a DCP directory that holds exactly what the
  npz of the same moment holds, restores through the same
  auto-detecting loader and resumes like it."""
  ds = _dataset()
  tr = Recoder(DynamicAutoencoder([8], sparse=sparse), optimizer_type='adam',
               loss='mse', opt_state_dtype=opt_state_dtype, device='cpu')
  tr.train(ds, batch_size=10, num_epochs=2, negative_sampling=True)
  orbax_path = tr.save_state(str(tmp_path / 'ck'), backend='orbax')
  npz_path = tr.save_state(str(tmp_path / 'ck'))
  assert orbax_path == str(tmp_path / 'ck_epoch_2.orbax')
  co.wait_for_pending_saves()
  assert co.is_orbax_checkpoint(orbax_path)
  assert {'.metadata', '__0_0.distcp'} <= set(os.listdir(orbax_path))
  arrays, meta = co.load_checkpoint_orbax(orbax_path)
  want, want_meta = load_checkpoint(npz_path)
  assert meta == want_meta
  _same_arrays(arrays, want)

  resumed = {}
  for path in (npz_path, orbax_path):
    back = Recoder(DynamicAutoencoder(sparse=sparse), optimizer_type='adam',
                   loss='mse', opt_state_dtype=opt_state_dtype, device='cpu')
    back.init_from_model_file(path)
    assert back.current_epoch == 2
    back.train(ds, batch_size=10, num_epochs=3, negative_sampling=True)
    resumed[path] = load_checkpoint(back.save_state(str(tmp_path / 'r')))[0]
  _same_arrays(resumed[orbax_path], resumed[npz_path])


def test_orbax_overwrite_crash_preserves_old(tmp_path, monkeypatch):
  """A crash during the DCP write leaves the old checkpoint directory
  untouched (written to .partial, committed to .tmp-save, swapped after
  -- never the old tree removed first); an async save's error surfaces
  on the next wait, once."""
  path = str(tmp_path / 'ck.orbax')
  co.save_checkpoint_orbax(path, {'x': np.arange(4)}, {'epoch': 1},
                           async_save=False)

  monkeypatch.setattr(co, '_write_tree', _dying_write)
  with pytest.raises(OSError, match='simulated crash'):
    co.save_checkpoint_orbax(path, {'x': np.arange(9)}, {'epoch': 2},
                             async_save=False)
  monkeypatch.undo()
  arrays, meta = co.load_checkpoint_orbax(path)
  assert meta == {'epoch': 1}
  np.testing.assert_array_equal(arrays['x'], np.arange(4))

  # a write that dies half way leaves a .partial that nothing recovers
  def half_write(p, state_dict):
    os.makedirs(p)
    open(os.path.join(p, '__0_0.distcp'), 'wb').close()
    raise OSError('simulated crash mid-save')
  monkeypatch.setattr(co, '_write_tree', half_write)
  with pytest.raises(OSError, match='simulated crash'):
    co.save_checkpoint_orbax(path, {'x': np.arange(9)}, {'epoch': 2},
                             async_save=False)
  monkeypatch.undo()
  assert os.path.isdir(path + '.partial')
  assert co.load_checkpoint_orbax(path)[1] == {'epoch': 1}

  monkeypatch.setattr(co, '_write_tree', _dying_write)
  co.save_checkpoint_orbax(path, {'x': np.arange(9)}, {'epoch': 2},
                           async_save=True)
  with pytest.raises(OSError, match='simulated crash'):
    co.wait_for_pending_saves()
  co.wait_for_pending_saves()  # raised once
  monkeypatch.undo()
  arrays, meta = co.load_checkpoint_orbax(path)
  assert meta == {'epoch': 1}
  # the next good save clears the debris
  co.save_checkpoint_orbax(path, {'x': np.arange(2)}, {'epoch': 3},
                           async_save=False)
  assert sorted(os.listdir(tmp_path)) == ['ck.orbax']
  assert co.load_checkpoint_orbax(path)[1] == {'epoch': 3}


def test_orbax_interrupted_swap_recovery(tmp_path):
  """The two mid-swap crash windows both recover on load: a committed
  .tmp-save wins (new checkpoint), else .old restores (previous)."""
  import shutil

  # window A: crash between rename(path, old) and rename(tmp, path)
  path = str(tmp_path / 'a.orbax')
  co.save_checkpoint_orbax(path, {'x': np.arange(3)}, {'epoch': 1},
                           async_save=False)
  co.save_checkpoint_orbax(path + '.stage', {'x': np.arange(7)},
                           {'epoch': 2}, async_save=False)
  os.rename(path, path + '.old')
  os.rename(path + '.stage', path + '.tmp-save')
  assert co.is_orbax_checkpoint(path)
  arrays, meta = co.load_checkpoint_orbax(path)
  assert meta == {'epoch': 2}
  np.testing.assert_array_equal(arrays['x'], np.arange(7))
  assert os.path.isdir(path) and not os.path.isdir(path + '.old')

  # window B: only .old exists; the OLD one restores
  path_b = str(tmp_path / 'b.orbax')
  co.save_checkpoint_orbax(path_b, {'x': np.arange(5)}, {'epoch': 9},
                           async_save=False)
  os.rename(path_b, path_b + '.old')
  assert co.is_orbax_checkpoint(path_b)
  arrays, meta = co.load_checkpoint_orbax(path_b)
  assert meta == {'epoch': 9}
  np.testing.assert_array_equal(arrays['x'], np.arange(5))
  shutil.rmtree(path_b)
  assert not co.is_orbax_checkpoint(path_b)
  with pytest.raises(FileNotFoundError):
    co.load_checkpoint_orbax(path_b)


def test_orbax_save_after_interrupted_swap_preserves_checkpoint(
    tmp_path, monkeypatch):
  """A save that starts while an interrupted swap's tree is the ONLY
  checkpoint must not destroy it when the save itself crashes."""
  path = str(tmp_path / 'a.orbax')
  co.save_checkpoint_orbax(path, {'x': np.arange(3)}, {'epoch': 1},
                           async_save=False)
  os.rename(path, path + '.old')
  monkeypatch.setattr(co, '_write_tree', _dying_write)
  with pytest.raises(OSError, match='simulated crash'):
    co.save_checkpoint_orbax(path, {'x': np.arange(9)}, {'epoch': 2},
                             async_save=False)
  monkeypatch.undo()
  assert co.load_checkpoint_orbax(path)[1] == {'epoch': 1}

  path_b = str(tmp_path / 'b.orbax')
  co.save_checkpoint_orbax(path_b + '.stage', {'x': np.arange(7)},
                           {'epoch': 5}, async_save=False)
  os.rename(path_b + '.stage', path_b + '.tmp-save')
  monkeypatch.setattr(co, '_write_tree', _dying_write)
  with pytest.raises(OSError, match='simulated crash'):
    co.save_checkpoint_orbax(path_b, {'x': np.arange(9)}, {'epoch': 6},
                             async_save=False)
  monkeypatch.undo()
  arrays, meta = co.load_checkpoint_orbax(path_b)
  assert meta == {'epoch': 5}
  np.testing.assert_array_equal(arrays['x'], np.arange(7))


def test_failed_async_save_fails_the_process_exit(tmp_path):
  """A run whose last async save failed exits with status 1, after the
  main program finished."""
  prog = (
      "import sys; sys.modules['jax'] = None\n"
      "import numpy as np\n"
      "from recoder_tpu_torch import checkpoint_orbax as co\n"
      "def dying(p, sd): raise OSError('simulated save crash')\n"
      "co._write_tree = dying\n"
      f"co.save_checkpoint_orbax({str(tmp_path / 'ck')!r},"
      " {'x': np.arange(3)}, {'epoch': 1}, async_save=True)\n"
      "print('MAIN DONE')\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run([sys.executable, '-c', prog], capture_output=True,
                       text=True, timeout=180, env=env)
  assert 'MAIN DONE' in res.stdout
  assert res.returncode == 1, (res.returncode, res.stderr[-2000:])
  assert 'checkpoint save FAILED' in res.stderr
  assert 'simulated save crash' in res.stderr


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'sparse'])
def test_async_save_holds_the_state_of_the_call(tmp_path, monkeypatch,
                                                sparse):
  """On the CPU the arrays alias the live parameters and moments: an
  async save whose write starts only after two more epochs still holds
  what the npz of the call's moment holds."""
  import threading
  ds = _dataset(3)
  tr = Recoder(DynamicAutoencoder([8], sparse=sparse), optimizer_type='adam',
               loss='mse', device='cpu')
  tr.train(ds, batch_size=10, num_epochs=2, negative_sampling=True)
  trained = threading.Event()
  write = co._write_tree

  def late_write(path, state_dict):
    trained.wait(60)
    write(path, state_dict)
  monkeypatch.setattr(co, '_write_tree', late_write)
  orbax_path = tr.save_state(str(tmp_path / 'ck'), backend='orbax',
                             async_save=True)
  npz_path = tr.save_state(str(tmp_path / 'ck'))
  tr.train(ds, batch_size=10, num_epochs=4, negative_sampling=True)
  trained.set()
  co.wait_for_pending_saves()
  _same_arrays(co.load_checkpoint_orbax(orbax_path)[0],
               load_checkpoint(npz_path)[0])


def test_orbax_bf16_opt_state_roundtrip(tmp_path):
  """bf16 moments come back bit for bit (stored upcast, as the npz
  stores them) and stay bf16 in a trainer built with the same argument;
  one built without it gets float32 state."""
  ds = _dataset(7)
  tr = Recoder(DynamicAutoencoder([8]), optimizer_type='adam', loss='mse',
               opt_state_dtype='bfloat16', device='cpu')
  tr.train(ds, batch_size=10, num_epochs=2, negative_sampling=True)
  path = tr.save_state(str(tmp_path / 'obf'), backend='orbax')
  npz = tr.save_state(str(tmp_path / 'nbf'))
  pending = {}
  for name, ckpt in (('orbax', path), ('npz', npz)):
    back = Recoder(DynamicAutoencoder(), optimizer_type='adam', loss='mse',
                   opt_state_dtype='bfloat16', device='cpu')
    back.init_from_model_file(ckpt)
    pending[name] = back._pending_opt_arrays[0]
    back.train(ds, batch_size=10, num_epochs=3, negative_sampling=True)
    states = [s for s in back.optimizer.state.values() if 'exp_avg' in s]
    assert states and all(s['exp_avg'].dtype == torch.bfloat16
                          for s in states)
  _same_arrays(pending['orbax'], pending['npz'])
  f32 = Recoder(DynamicAutoencoder(), optimizer_type='adam', loss='mse',
                device='cpu')
  f32.init_from_model_file(path)
  f32.train(ds, batch_size=10, num_epochs=3, negative_sampling=True)
  assert all(s['exp_avg'].dtype == torch.float32
             for s in f32.optimizer.state.values() if 'exp_avg' in s)


def test_reserved_key_and_non_checkpoint_directory(tmp_path):
  with pytest.raises(ValueError, match='reserved'):
    co.save_checkpoint_orbax(str(tmp_path / 'r'),
                             {co._META_KEY: np.zeros(1)}, {})
  os.makedirs(tmp_path / 'empty')
  assert not co.is_orbax_checkpoint(str(tmp_path / 'empty'))
  with pytest.raises(ValueError, match='not a checkpoint'):
    co.load_checkpoint_orbax(str(tmp_path / 'empty'))


def test_jax_orbax_tree_is_refused_with_the_npz_route(tmp_path):
  """A tree the JAX package's Orbax backend committed cannot be read
  without tensorstore: the loader names the route through npz and
  never falls back."""
  from recoder_tpu.checkpoint_orbax import wait_for_pending_saves
  from recoder_tpu.data import RecommendationDataset as JaxDataset
  from recoder_tpu.model import Recoder as JaxRecoder
  from recoder_tpu.models import DynamicAutoencoder as JaxDynAE

  jtr = JaxRecoder(JaxDynAE(hidden_layers=[8]), optimizer_type='adam',
                   loss='mse')
  jtr.train(JaxDataset(_dataset().interactions_matrix), batch_size=10,
            num_epochs=1, negative_sampling=True)
  path = jtr.save_state(str(tmp_path / 'jax'), backend='orbax')
  wait_for_pending_saves()
  assert co.is_orbax_checkpoint(path)
  tr = Recoder(DynamicAutoencoder(), device='cpu')
  with pytest.raises(ValueError, match="backend='npz'"):
    tr.init_from_model_file(path)


def test_port_directory_resaved_as_npz_predicts_in_jax(tmp_path):
  """A port directory checkpoint, loaded and written again as npz, loads
  in the JAX Recoder, whose predictions are the port's within 1e-6."""
  from recoder_tpu.data import UsersInteractions as JaxUsers
  from recoder_tpu.model import Recoder as JaxRecoder
  from recoder_tpu.models import DynamicAutoencoder as JaxDynAE

  ds = _dataset(3)
  tr = Recoder(DynamicAutoencoder([8], 'tanh'), optimizer_type='adam',
               loss='mse', device='cpu')
  tr.train(ds, batch_size=10, num_epochs=2, negative_sampling=True)
  path = tr.save_state(str(tmp_path / 'port'), backend='orbax')
  back = Recoder(DynamicAutoencoder(), optimizer_type='adam', device='cpu')
  back.init_from_model_file(path)
  npz = back.save_state(str(tmp_path / 'again'))
  jtr = JaxRecoder(JaxDynAE(), optimizer_type='adam')
  jtr.init_from_model_file(npz)
  m = ds.interactions_matrix[:12]
  users = np.arange(12)
  got = back.predict(UsersInteractions(users, m))
  want = jtr.predict(JaxUsers(users, m))
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                             atol=1e-6)

