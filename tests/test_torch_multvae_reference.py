"""Mult-VAE's benchmark reference (``perfbench/reference/multvae.py``)
against the program on the CPU at a small size: ``Recoder.train`` over
``MultVAE`` as the harness drives it ('users', full decode off the
slab, bf16 and float32), on the start's losses, first gradient and
change and on the later block; the reference's draws against the
model's own; the KL weight at a global step; and the control and the
faults that the cell's limits must refuse."""

import copy

import numpy as np
import pytest
import torch

from perfbench import check, harness, synth
from perfbench.calibrate import readings
from perfbench.reference import multvae as ref_lib
from recoder_tpu_torch.models import MultVAE

CELL = 'multvae-ml20m.softmax-users'
SEED = 2 ** 31 + 77
#: the program's largest readings at this size over a few seeds, times
#: about ten: float32 reads round-off alone (1e-7), bf16 its products'
#: rounding
FLOAT32 = {'loss': 1e-5, 'grad': 1e-5, 'grad_diff': 2e-5, 'change': 1e-5,
           'loss_later': 1e-5, 'change_later': 1e-5}
BF16 = {'loss': 3e-4, 'grad': 4e-3, 'grad_diff': 6e-2, 'change': 8e-3,
        'loss_later': 4e-4, 'change_later': 2e-2}


def small(dtype='bfloat16', users=1500, items=700, batch=50):
  """The cell at a size a CPU test holds: its model at its published
  widths, trainer, sampling and precision; fewer users and items and a
  smaller batch (30 steps an epoch)."""
  cell = copy.deepcopy(harness.load_cell(CELL))
  cell['config']['data'].update(num_users=users, num_items=items,
                                mean_items=20)
  cell['traffic']['train']['batch_size'] = batch
  cell['traffic']['model'].update(compute_dtype=dtype, opt_state_dtype=dtype)
  return cell


@pytest.mark.parametrize('dtype, tol', [('bfloat16', BF16),
                                        (None, FLOAT32)])
def test_reference_follows_the_program(dtype, tol):
  got, _ = readings(small(dtype), SEED, 'cpu', 0.0)['program']
  for name, limit in tol.items():
    assert got[name] < limit, (name, got[name])
  if dtype is None:
    assert got['loss1'] == 0.0  # (the first step: the same arithmetic)


def _reference(seed=3, **kw):
  cell = small()
  matrix = synth.synthesize(cell['config']['data'], seed, 'cpu')
  return ref_lib.Reference(matrix, cell['config'], cell['traffic'], seed,
                           'cpu', **kw), cell


@pytest.mark.parametrize('step', [0, 1, 29, 40001])
def test_draws_are_the_programs(step):
  """The reference's keep mask and ``eps`` at a global step are the
  draws the model makes from the trainer's generator there (seeded with
  ``(seed << 32) + step`` on the CPU): the model's training forward from
  the generator equals, bit for bit, the forward fed the reference's
  draws."""
  ref, cell = _reference()
  model = MultVAE(**cell['config']['model'], compute_dtype='bfloat16')
  model.init_model(num_items=ref.num_items, seed=3)
  keep, eps = ref.draws(step)
  assert keep.shape == (ref.batch, ref.rows) and keep.dtype == torch.bool
  assert eps.shape == (ref.batch, 200) and eps.dtype == torch.float32
  dense, _ = ref._batch(0)
  x = dense.to(torch.bfloat16)
  t = torch.tensor(step)
  gen = torch.Generator().manual_seed((3 << 32) + step)
  with torch.no_grad():
    drawn = model(x, generator=gen, training=True, step=t)
    fed = model(x, training=True, step=t, keep_mask=keep, eps=eps)
  for a, b in zip(drawn, fed):
    assert torch.equal(a, b)
  assert 0.4 < keep.float().mean() < 0.6


@pytest.mark.parametrize('step', [0, 1, 1000, 39999, 40000, 40001, 10 ** 6])
def test_kl_weight_at_a_global_step(step):
  want = min(0.2, step / 200000)
  ref, cell = _reference()
  assert ref.beta(step) == pytest.approx(want, rel=1e-12, abs=0)
  model = MultVAE(**cell['config']['model'])
  got = float(model._beta(torch.tensor(step)))
  assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_the_trainer_anneals_on_the_global_step(monkeypatch):
  """The trainer hands the model's KL weight the global step: 0, 1, ...
  across the epoch's steps, and on from there in the next call."""
  cell = small(users=300, batch=50)
  seen = []
  beta = MultVAE._beta

  def record(self, step):
    seen.append(int(step))
    return beta(self, step)
  monkeypatch.setattr(MultVAE, '_beta', record)
  matrix = synth.synthesize(cell['config']['data'], 5, 'cpu')
  prog = harness.Program(cell, matrix, 5, torch.device('cpu'))
  prog.train(4)
  prog.train(2)
  assert seen == list(range(6))


def _limits():
  return harness.load_cell(CELL)['limits']


def test_control_and_half_batch_read_above_the_limits():
  out = readings(small(), SEED, 'cpu', 0.0, upper=True)
  for what in ('control', 'half'):
    got, _ = out[what]
    assert check.decide(got, _limits())[0] is False, what
  sound, _ = out['program']
  assert out['half'][0]['loss'] > 100 * sound['loss']
  assert out['control'][0]['grad_diff'] > 5 * sound['grad_diff']


def test_the_kl_term_left_out_reads_above_the_limits():
  """At a global step past the KL weight's cap (a later block's, after
  the window), the reference with its KL term left out, read as the
  program is against the sound reference, fails the later block's
  limits; at the start (beta ~ 0) it reads the round-off alone."""
  ref, cell = _reference()
  trained = ref.run(30)
  start = {'epoch': 2, 'global_step': 50000,
           'params': {k: v.clone() for k, v in ref.params.items()},
           'moments': {k: (v['m'].clone(), v['v'].clone())
                       for k, v in ref.state.items()}}
  args = (ref.matrix, cell['config'], cell['traffic'], 3, 'cpu')
  sound = ref_lib.Reference(*args, start=start).run(harness.LATER_STEPS)
  no_kl = ref_lib.Reference(*args, fault='no_kl',
                            start=start).run(harness.LATER_STEPS)
  first = ref_lib.Reference(*args, fault='no_kl').run(3)
  head = ref_lib.Reference(*args).run(3)
  got = check.readings(check.as_program(first), head,
                       check.as_program(no_kl), sound)
  limits = _limits()
  assert got['loss_later'] > limits['loss_later']
  assert check.decide(got, limits)[0] is False
  assert got['loss'] < 1e-2 * limits['loss']
  assert np.isfinite(trained['losses']).all()


def test_a_fault_the_reference_lacks_is_refused():
  with pytest.raises(ValueError, match='no fault'):
    _reference(fault='no_decoder')
