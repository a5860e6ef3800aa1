"""The plain reference against the program's CPU path at a small size,
and the control and faults that the comparison must refuse."""

import copy

import pytest
import torch

from perfbench import check, harness, synth
from perfbench.calibrate import readings
from perfbench.reference.autoencoder import Reference

CELLS = ['ae-ml20m.full-blocks', 'ae-msd.full-blocks', 'ae-msd.sparse-users']
SEED = 2 ** 31 + 77


def small(name, users=1500, items=700, batch=50):
  """The cell at a size a CPU test holds: its model, trainer, sampling
  and precision; fewer users and items, smaller batches (30 steps an
  epoch: the start's 20 and the later block's 20 fit one)."""
  cell = copy.deepcopy(harness.load_cell(name))
  cell['config']['data'].update(num_users=users, num_items=items,
                                mean_items=20)
  cell['traffic']['train']['batch_size'] = batch
  return cell


@pytest.mark.parametrize('name', CELLS)
def test_reference_follows_the_program(name):
  cell = small(name)
  got, _ = readings(cell, SEED, 'cpu', 0.0)['program']
  # (the CPU's bf16 path multiplies bf16-rounded operands in float32; its
  # gap grows with the scores as the model learns the tiny matrix)
  bf16 = cell['traffic']['model']['compute_dtype'] == 'bfloat16'
  tol = 1.0 if bf16 else 0.01
  assert got['loss'] < 1e-4 * tol and got['grad'] < 5e-3 * tol
  assert got['change'] < 1e-3 * tol
  assert got['loss_later'] < 1e-3 * tol and got['change_later'] < 5e-3 * tol


@pytest.mark.parametrize('name', CELLS)
def test_half_the_batch_reads_far_off(name):
  out = readings(small(name), SEED, 'cpu', 0.0, upper=True)
  sound, half = out['program'][0], out['half'][0]
  assert half['grad'] > 10 * sound['grad'] and half['loss'] > 0.01
  assert half['loss_later'] > 0.01


@pytest.mark.parametrize('name,items,mean,ratio', [
    ('ae-ml20m.full-blocks', 20108, 86, 5),
    ('ae-msd.full-blocks', 41140, 59, 5),
    ('ae-msd.sparse-users', 41140, 59, 100)])
def test_control_reads_above_the_program(monkeypatch, name, items, mean,
                                         ratio):
  """At the real widths (d 200, batch 500, the catalog) and 1,500 users,
  the control (fp8 under bf16, TF32 under float32) reads further from
  the reference than the program on the number that separates them, the
  first gradient's difference (the start cut to its three eager steps
  and the later block to two, which the first gradient does not see)."""
  monkeypatch.setattr(harness, 'WARM_STEPS', 0)
  monkeypatch.setattr(harness, 'LATER_STEPS', 2)
  cell = small(name, users=1500, items=items, batch=500)
  cell['config']['data']['mean_items'] = mean
  out = readings(cell, SEED, 'cpu', 0.0, upper=True)
  sound, control = out['program'][0], out['control'][0]
  assert control['grad_diff'] > ratio * sound['grad_diff']


def test_quiet_leaves_are_left_out_of_the_change():
  matrix = synth.synthesize(small(CELLS[0])['config']['data'], 3, 'cpu')
  cell = small(CELLS[0])
  out = Reference(matrix, cell['config'], cell['traffic'], 3, 'cpu').run(3)
  program = check.as_program(out)
  program['change'] = dict(program['change'])
  out['grads'] = dict(out['grads'], en_bias=out['grads']['en_bias'] * 0)
  program['change']['en_bias'] = program['change']['en_bias'] * 0
  assert check.readings(program, out)['change'] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_at_the_cells_size(card, name):
  """The control, put in the program's place at the cell's own size,
  comes out not correct under the cell's limits."""
  cell = harness.load_cell(name)
  got, _ = readings(cell, 3100000201, 'cuda', 1.0, upper=True)['control']
  assert check.decide(got, cell['limits'])[0] is False


@pytest.mark.cuda
def test_noise_offsets_on_the_card(card):
  """On the card each global step's keep mask is the draw at Philox offset
  ``step x`` the offset one draw takes, from the seed ``seed << 32``."""
  cell = small(CELLS[0])
  matrix = synth.synthesize(cell['config']['data'], 3, card)
  ref = Reference(matrix, cell['config'], cell['traffic'], 3, card)
  columns = torch.arange(ref.mask_width, device=card)
  shape = (ref.batch, ref.mask_width)
  gen = torch.Generator(device=card)
  gen.manual_seed(3 << 32)
  draws = [torch.empty(shape, dtype=ref.dtype, device=card).bernoulli_(
      1 - ref.noise, generator=gen).bool() for _ in range(3)]
  for step, want in enumerate(draws):
    assert torch.equal(ref._keep(step, columns), want)
