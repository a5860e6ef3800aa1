"""Whole runs on the CPU at a small size: the result line's shape, the
faults the check must refuse, and the modules a run loads. These drive
``harness.run_cell`` past the look for a card (the card's run is
``perfbench/run.py``)."""

import json
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_reference import CELLS, small
from recoder_tpu_torch import optim as port_optim
from recoder_tpu_torch.model import Recoder

SEED = 2 ** 31 + 4242


def run_small(name, seconds=0.3):
  cell = small(name)
  return harness.run_cell(cell, SEED, seconds, 0, 'cpu', time.perf_counter())


def test_result_line_shape():
  result = run_small(CELLS[0])
  assert list(result) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'compared']
  assert result['attempted'] > 0 and result['failed'] == 0
  assert set(result['metrics']) == {'train_batches_per_s', 'setup_s'}
  for metric in result['metrics'].values():
    assert set(metric) == {'value', 'unit'} and metric['value'] > 0
  assert set(result['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
  for number in result['compared'].values():
    assert set(number) == {'value', 'limit'}
  json.dumps(result)


def _frozen(monkeypatch):
  """Every optimizer step leaves the state as it was."""
  monkeypatch.setattr(port_optim.Bf16Adam, 'step', lambda self, c=None: None)
  monkeypatch.setattr(port_optim.torch.optim.Adam, 'step',
                      lambda self, c=None: None)
  monkeypatch.setattr(port_optim.SparseRowAdam, 'update_rows',
                      lambda self, *a, **k: None)


def _half_batch(monkeypatch):
  """Each step's loss leaves out the second half of its users and takes
  the mean over the rest."""
  forward = Recoder._forward_loss

  def half(self, batch, *args, **kw):
    batch = dict(batch)
    batch['num_users'] = batch['num_users'] // 2
    return forward(self, batch, *args, **kw)
  monkeypatch.setattr(Recoder, '_forward_loss', half)


@pytest.mark.parametrize('fault', [_frozen, _half_batch],
                         ids=['state-unchanged', 'half-batch'])
@pytest.mark.parametrize('name', CELLS)
def test_broken_step_is_not_correct(monkeypatch, fault, name):
  fault(monkeypatch)
  result = run_small(name)
  assert result['correct'] is False


def test_a_run_loads_no_jax():
  code = ('import sys, time; sys.path.insert(0, %r); '
          'from perfbench import harness; '
          'from perfbench.tests.test_perfbench_reference import small; '
          'harness.run_cell(small("ae-msd.sparse-users"), 5, 0.1, 0, "cpu", '
          'time.perf_counter()); print(harness.forbidden_modules())'
          % harness.ROOT)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True, timeout=300)
  assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_are_compared_whole(monkeypatch):
  monkeypatch.setitem(sys.modules, 'recoder_tpu_torch_extra', sys)
  assert 'recoder_tpu' not in harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, 'recoder_tpu.model', sys)
  assert harness.forbidden_modules() == ['recoder_tpu']
