"""The port's epoch loop against the JAX package's ``Recoder.train`` on the
CPU: ``fused_steps_per_call``, partial epochs and resumes, the
checkpoint hooks, ``reset_training_state``, the validation arguments,
``progress``, the profile window and the Adam scalar table.

On the CPU a block of N full-decode steps runs the step function N times
eagerly; on the card it is one CUDA graph (``tests/test_torch_cuda.py``
holds those against eager steps bitwise). Here the same numpy data and
the JAX init (through ``convert.py``) go to both packages, noise off
where they are compared (JAX's dropout draws cannot be reproduced), the
'blocks' order injected from the JAX source. 37 users in batches of 8
give 5 steps an epoch, which N = 4 does not divide: the remainder runs
one step a dispatch, as in JAX.

Tolerances: float32 losses and parameters within 1e-5 relative (an
absolute floor of 1e-5 of the largest reference entry, for entries near
zero); bf16 as tests/test_torch_bf16.py: losses rtol 1e-2, parameters
within 3 lr and within 0.1 lr on average. Port against port: bitwise.
"""

import json
import logging
import os
import re
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import recoder_tpu.progress as jax_progress
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch import progress as port_progress
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.ops import adam as adam_ops
from recoder_tpu_torch.optim import Bf16Adam
from recoder_tpu_torch.utils import dataframe_to_csr_matrix

N_USERS, N_ITEMS, BATCH, SEED = 37, 120, 8, 3
LR, WD = 1e-2, 2e-5
BF = 'bfloat16'


def _matrix(seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < 0.12).astype(np.float32)
  dense[[4, 30]] = 0.0  # users without interactions
  return sp.csr_matrix(dense)


def _kw(dtype):
  return dict(hidden_layers=[16], activation_type='tanh', noise_prob=0.0,
              compute_dtype=dtype)


def _common(dtype):
  return dict(optimizer_type='adam', loss='mse',
              loss_params={'confidence': 3}, seed=SEED,
              opt_state_dtype=dtype)


def _train_kw(spc, tier, shuffle, num_epochs=2):
  return dict(batch_size=BATCH, lr=LR, weight_decay=WD,
              num_epochs=num_epochs, lr_milestones=[2],
              negative_sampling=True, shuffle=shuffle, full_decode=True,
              slab_cache=tier, fused_steps_per_call=spc)


class _LossRecorder:
  """Stands in for the JAX ProgressReporter: keeps every block's device
  losses, in order, as numpy."""

  last = None

  def __init__(self, total, desc):
    self.losses = []
    _LossRecorder.last = self

  def put(self, num_steps, loss):
    self.losses.append(np.atleast_1d(np.asarray(loss, np.float32)))

  def reset(self, total, desc):
    pass

  def close(self, wait=False):
    pass


def _inject_jax_blocks_order(monkeypatch, m):
  """The port's 'blocks' epoch order := the JAX trainer's draw."""
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                               num_items=N_ITEMS, union_width=128,
                               shuffle='blocks')
  real = DeviceDataSource.epoch_permutation

  def perm(self, epoch):
    if self.shuffle != 'blocks':
      return real(self, epoch)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), epoch)
    return torch.from_numpy(
        np.asarray(theirs.epoch_permutation(key)).astype(np.int64))

  monkeypatch.setattr(DeviceDataSource, 'epoch_permutation', perm)


def _close(got, ref, dtype, what):
  got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
  if dtype is None:
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max(), err_msg=what)
  else:
    np.testing.assert_allclose(got, ref, rtol=0, atol=3 * LR, err_msg=what)
    assert np.abs(got - ref).mean() <= 0.1 * LR, what


def _port_from(jtr, dtype):
  """A port trainer (CPU) from the JAX trainer's init."""
  ptr = Recoder(DynamicAutoencoder(**_kw(dtype)), device='cpu',
                **_common(dtype))
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  with torch.no_grad():
    for name, t in convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jtr.model.params.items()}).items():
      ptr.model.params()[name].copy_(t)
  return ptr


@pytest.mark.parametrize('dtype', [None, BF])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('tier', [True, 'packed'])
@pytest.mark.parametrize('spc', [1, 4])
def test_steps_per_call_matches_jax_trainer(spc, tier, shuffle, dtype,
                                            monkeypatch):
  """Two epochs of 5 steps (4 + 1 at N = 4), an lr milestone between
  them: the per-step losses and the parameters of both packages."""
  m = _matrix()
  _inject_jax_blocks_order(monkeypatch, m)
  monkeypatch.setattr(jax_progress, 'ProgressReporter', _LossRecorder)
  jtr = JaxRecoder(JaxDynAE(**_kw(dtype)), **_common(dtype))
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  one, two = _port_from(jtr, dtype), _port_from(jtr, dtype)
  jtr.train(JaxDataset(m), progress=True, **_train_kw(spc, tier, shuffle))
  ref_losses = np.concatenate(_LossRecorder.last.losses)
  assert ref_losses.shape == (10,)
  # the port's epoch 1 (a one-epoch run) and epoch 2 (a two-epoch run)
  one.train(RecommendationDataset(m), **_train_kw(spc, tier, shuffle,
                                                  num_epochs=1))
  two.train(RecommendationDataset(m), **_train_kw(spc, tier, shuffle))
  losses = one.last_epoch_losses + two.last_epoch_losses
  assert two.fused_data_source._slab_packed == (tier == 'packed')
  assert two.last_epoch_dispatches == 5  # eager on the CPU
  np.testing.assert_allclose(losses, ref_losses,
                             rtol=1e-5 if dtype is None else 1e-2)
  for name, p in two.model.params().items():
    _close(p.detach().numpy(), jtr.model.params[name], dtype, name)


def _port_run(spc, tier, shuffle, dtype, m=None, noise=0.5, **kw):
  tr = Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=noise,
                                  compute_dtype=dtype),
               device='cpu', **_common(dtype))
  tr.train(RecommendationDataset(_matrix() if m is None else m),
           **{**_train_kw(spc, tier, shuffle), **kw})
  return tr


def _same_trainers(a, b):
  """The same last-epoch losses, parameters and optimizer state, bit for
  bit."""
  assert a.last_epoch_losses == b.last_epoch_losses
  theirs = b.model.params()
  for name, p in a.model.params().items():
    assert torch.equal(p, theirs[name]), name
    sa, sb = a.optimizer.state[p], b.optimizer.state[theirs[name]]
    assert sa.keys() == sb.keys(), name
    for key in sa:
      assert torch.equal(torch.as_tensor(sa[key]).float(),
                         torch.as_tensor(sb[key]).float()), (name, key)


@pytest.mark.parametrize('dtype', [None, BF])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('tier', [True, 'packed'])
def test_one_and_four_steps_a_call_are_bitwise_equal(tier, shuffle, dtype):
  """Noise 0.5, an lr milestone, a tail block with pad users: N = 1 and
  N = 4 give the same losses, parameters and moments, bit for bit."""
  a = _port_run(1, tier, shuffle, dtype)
  b = _port_run(4, tier, shuffle, dtype)
  assert len(a.last_epoch_losses) == 5 and a.last_epoch_dispatches == 5
  assert b.last_epoch_dispatch == 'eager'
  _same_trainers(a, b)


@pytest.mark.parametrize('dtype', [None, BF])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_partial_epochs_and_resume_follow_the_uninterrupted_run(
    shuffle, dtype, tmp_path):
  """Epoch 1 in calls of 2, 2 and 1 steps (``iters_per_epoch=2``), and a
  resume from a checkpoint written after 2 of its steps, walk the same
  steps as one call of the whole epoch; then ``num_epochs=2`` (which
  runs epoch 1 again, the reference's resume quirk, and epoch 2 with the
  lr milestone) ends in the same state. Noise 0.5."""
  data = RecommendationDataset(_matrix())

  def trainer():
    return Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=0.5,
                                      compute_dtype=dtype),
                   device='cpu', **_common(dtype))

  def run(tr, num_epochs, **kw):
    tr.train(data, **_train_kw(4, 'packed', shuffle, num_epochs=num_epochs),
             **kw)
    return tr.last_epoch_losses

  whole = trainer()
  ref = run(whole, 1)
  run(whole, 2)

  parts = trainer()
  got = run(parts, 1, iters_per_epoch=2) + run(parts, 1, iters_per_epoch=2)
  got += run(parts, 1, iters_per_epoch=2)
  assert got == ref and len(ref) == 5
  run(parts, 2)
  _same_trainers(parts, whole)

  first = trainer()
  run(first, 1, iters_per_epoch=2,
      model_checkpoint_prefix=str(tmp_path / 'p'))
  resumed = Recoder(DynamicAutoencoder(), device='cpu', **_common(dtype))
  resumed.init_from_model_file(str(tmp_path / 'p_epoch_1.model'))
  assert resumed._iters_consumed == 2
  assert run(resumed, 1) == ref[2:]
  run(resumed, 2)
  _same_trainers(resumed, whole)
  if dtype == BF:
    assert isinstance(resumed.optimizer, Bf16Adam)
    assert int(next(iter(resumed.optimizer.state.values()))['step']) == 15


def test_checkpoint_hooks_match_jax(tmp_path):
  """checkpoint_freq=2 over 5 epochs: both packages write epochs 2, 4
  and 5 (the last), with the same names."""
  m = _matrix()
  kw = dict(batch_size=64, lr=LR, num_epochs=5, negative_sampling=True,
            checkpoint_freq=2)
  written = {}
  for side, (trainer, data) in {
      'jax': (JaxRecoder(JaxDynAE([8]), optimizer_type='adam', seed=SEED),
              JaxDataset(m)),
      'port': (Recoder(DynamicAutoencoder([8]), optimizer_type='adam',
                       seed=SEED, device='cpu'),
               RecommendationDataset(m))}.items():
    os.makedirs(tmp_path / side)
    trainer.train(data, model_checkpoint_prefix=str(tmp_path / side / 'ck'),
                  **kw)
    written[side] = sorted(os.listdir(tmp_path / side))
  assert written['port'] == written['jax'] == [
      'ck_epoch_2.model', 'ck_epoch_4.model', 'ck_epoch_5.model']


@pytest.mark.parametrize('dtype', [None, BF])
def test_reset_training_state_reproduces_a_fresh_trainer(dtype):
  """After an epoch and reset_training_state, the next epoch is a fresh
  trainer's first, bit for bit, on the same parameter and moment
  tensors; the reset parameters are the seed's init."""
  fresh = _port_run(4, True, 'users', dtype, num_epochs=1)
  tr = _port_run(4, True, 'users', dtype, num_epochs=1)
  tensors = {k: v for k, v in tr.model.params().items()}
  moments = [v for st in tr.optimizer.state.values() for v in st.values()
             if torch.is_tensor(v)]
  optimizer = tr.optimizer
  tr.reset_training_state()
  init = Recoder(DynamicAutoencoder([16], 'tanh', compute_dtype=dtype),
                 device='cpu', **_common(dtype))
  init.num_items, init.num_users = tr.num_items, tr.num_users
  init._init_model()
  for name, p in tr.model.params().items():
    assert p is tensors[name]
    assert torch.equal(p, init.model.params()[name]), name
  assert all(not v.any() for v in moments)
  assert tr.current_epoch == 1 and tr._global_step == 0
  tr.train(RecommendationDataset(_matrix()), **_train_kw(4, True, 'users',
                                                         num_epochs=1))
  assert tr.optimizer is optimizer
  _same_trainers(tr, fresh)


def test_reset_training_state_against_jax():
  """JAX's reset_training_state gives its seed's init back, the port's
  its own: the two inits come from different generators (jax.random and
  torch's), so across the packages they agree in names, shapes, zero
  biases and the xavier range of every table."""
  m = _matrix()
  jtr = JaxRecoder(JaxDynAE(**_kw(None)), **_common(None))
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  ptr = _port_from(jtr, None)
  jinit = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  kw = _train_kw(1, True, 'users', num_epochs=1)
  jtr.train(JaxDataset(m), **kw)
  ptr.train(RecommendationDataset(m), **kw)
  jtr.reset_training_state()
  ptr.reset_training_state()
  theirs = convert.params_from_numpy(
      {k: np.asarray(v) for k, v in jtr.model.params.items()})
  ours = ptr.model.params()
  assert theirs.keys() == ours.keys()
  for name, t in theirs.items():
    np.testing.assert_array_equal(t.numpy(), jinit[name])
    assert t.shape == ours[name].shape, name
    if 'bias' in name:
      assert not t.any() and not ours[name].any(), name
    else:
      fan_in, fan_out = 16, N_ITEMS  # the tables' logical fans
      limit = np.sqrt(6.0 / (fan_in + fan_out))
      for x in (t, ours[name].detach()):
        assert float(x.abs().max()) <= limit, name


def _fixture_datasets():
  """tests/test_model.py's ``_load_datasets``, into the port's datasets."""
  data = os.path.join(os.path.dirname(__file__), 'data')
  train_df = pd.read_csv(os.path.join(data, 'train.csv.gz'))
  val_df = pd.read_csv(os.path.join(data, 'val.csv.gz'))
  val_df = val_df[val_df.sid.isin(train_df.sid.unique())]
  train_m, item_map, user_map = dataframe_to_csr_matrix(
      train_df, user_col='uid', item_col='sid', inter_col='watched')
  val_m, _, _ = dataframe_to_csr_matrix(
      val_df, user_col='uid', item_col='sid', inter_col='watched',
      item_id_map=item_map, user_id_map=user_map)
  return RecommendationDataset(train_m), RecommendationDataset(val_m,
                                                               train_m)


def test_val_dataset_is_accepted_without_eval_freq(caplog):
  """The pinned call of tests/test_model.py (val_dataset given,
  eval_freq 0) runs on the port, cut to one epoch of 2 steps; with
  eval_freq=1 the same call validates and logs a finite val_loss."""
  train_dataset, val_dataset = _fixture_datasets()
  trainer = Recoder(DynamicAutoencoder(hidden_layers=[200],
                                       activation_type='tanh',
                                       noise_prob=0.5),
                    optimizer_type='adam', loss='logloss', device='cpu')
  kw = dict(train_dataset=train_dataset, val_dataset=val_dataset,
            batch_size=500, lr=1e-3, weight_decay=2e-5, iters_per_epoch=2,
            negative_sampling=True)
  with caplog.at_level(logging.INFO, logger='recoder_tpu_torch'):
    trainer.train(num_epochs=1, **kw)
    assert 'val_loss=' not in caplog.text
    assert len(trainer.last_epoch_losses) == 2
    assert np.all(np.isfinite(trainer.last_epoch_losses))
    trainer.train(num_epochs=2, eval_freq=1, **kw)
  assert len(trainer.last_epoch_losses) == 2
  found = re.findall(r'Epoch 2/2 .* val_loss=(\S+)', caplog.text)
  assert len(found) == 1 and np.isfinite(float(found[0])), caplog.text


def test_progress_prints_through_the_fallback_printer(monkeypatch, capsys):
  """Without tqdm the bar is one stderr line with the running loss."""
  monkeypatch.setitem(sys.modules, 'tqdm', None)  # import raises
  close = port_progress.ProgressReporter.close
  monkeypatch.setattr(port_progress.ProgressReporter, 'close',
                      lambda self, wait=False: close(self, wait=True))
  tr = _port_run(4, True, 'users', None, num_epochs=1, progress=True)
  err = capsys.readouterr().err
  assert re.search(r'Epoch 1/1: 5/5 loss=[0-9.]+', err), err
  assert f'loss={np.mean(tr.last_epoch_losses[-1:]):.5f}' in err


def test_profile_dir_writes_a_trace_and_dispatches_single_steps(tmp_path):
  """The trace of steps 1-2 holds their ``recoder.eager`` ranges (the
  spans opened while the profiler ran: the call's own ``recoder.train``
  opened before the window, and has no range there)."""
  tr = _port_run(4, True, 'users', None, num_epochs=1,
                 profile_dir=str(tmp_path), profile_steps=(1, 3))
  traces = os.listdir(tmp_path)
  assert traces == ['trace_steps_1_3.json']
  assert os.path.getsize(tmp_path / traces[0]) > 0
  assert tr.last_epoch_dispatch == 'eager'
  assert tr.last_epoch_dispatches == 5  # one a step, N = 1
  with open(tmp_path / traces[0]) as f:
    names = [ev.get('name') for ev in json.load(f)['traceEvents']]
  assert names.count('recoder.eager') == 2


def test_union_steps_run_eagerly_whatever_n(caplog):
  """Off the card the static 'blocks' union steps of a dispatch run
  eagerly: N = 4 logs so and runs the steps of N = 1 (on the card a
  block of N is one CUDA graph, ``tests/test_torch_cuda.py``)."""
  caplog.set_level(logging.INFO, logger='recoder_tpu_torch')
  a = _port_run(1, True, 'blocks', None, full_decode=False)
  b = _port_run(4, True, 'blocks', None, full_decode=False)
  assert 'off the card the steps of a dispatch run eagerly' in caplog.text
  assert b.last_epoch_dispatches == 5
  _same_trainers(a, b)


def test_adam_scalar_table_twin_matches_host_scalars():
  """The plain twin reading row ctl[0] - ctl[1] of the scalar table is
  today's host-scalar step, bit for bit, over 6 steps and an lr change;
  a step outside the table raises."""
  rng = np.random.default_rng(0)

  def tensors():
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((33, 7), (5,))]
    return p, [torch.zeros_like(x, dtype=torch.bfloat16) for x in p]

  params, ms = tensors()
  vs = [m.clone() for m in ms]
  grads = [torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
           for x in params]
  twin = ([p.clone() for p in params], [m.clone() for m in ms],
          [v.clone() for v in vs])
  table = torch.from_numpy(np.concatenate([
      adam_ops.scalar_table(1e-2, 3, 3), adam_ops.scalar_table(1e-3, 6, 3)]))
  ctl = torch.tensor([2, 2])
  for step in range(3, 9):
    lr = 1e-2 if step < 6 else 1e-3
    adam_ops.adam_bf16_step(params, grads, ms, vs, [2e-5, 0.0], lr, step)
    adam_ops.table_step(twin[0], grads, twin[1], twin[2], [2e-5, 0.0], table,
                        ctl)
  assert ctl.tolist() == [8, 2]
  for a, b in zip(params + ms + vs, twin[0] + twin[1] + twin[2]):
    assert torch.equal(a, b)
  with pytest.raises(IndexError, match='outside the scalar table'):
    adam_ops.table_step(twin[0], grads, twin[1], twin[2], [2e-5, 0.0], table,
                        ctl)


def test_bf16_adam_takes_over_a_loaded_step_count():
  """A step count put into Bf16Adam's state from outside (as a checkpoint
  load does) becomes its device count at the next step, which takes
  that step's scalars."""
  p = torch.nn.Parameter(torch.linspace(-1, 1, 12))
  grad = torch.linspace(0.5, -0.7, 12)
  opt = Bf16Adam([p], lr=1e-3)
  p.grad = grad.clone()
  opt.step()
  assert int(opt.state[p]['step']) == 1
  ref = [p.detach().clone(), opt.state[p]['exp_avg'].clone(),
         opt.state[p]['exp_avg_sq'].clone()]
  opt.state[p]['step'] = torch.tensor(41.0)
  opt.step()
  assert opt.state[p]['step'] is opt._step and int(opt._step) == 42
  adam_ops.adam_bf16_step([ref[0]], [grad], [ref[1]], [ref[2]], [0.0], 1e-3,
                          42)
  assert torch.equal(p.detach(), ref[0])
  assert torch.equal(opt.state[p]['exp_avg'], ref[1])
  assert torch.equal(opt.state[p]['exp_avg_sq'], ref[2])
