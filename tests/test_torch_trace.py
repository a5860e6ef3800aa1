"""The port's host spans (``recoder_tpu_torch.trace``): counts, seconds
and self seconds on a fake clock, copies of the totals and their
differences, the decorator form, no ``record_function`` without a
profiler and the ranges in a CPU profile, exact counts from many
threads; and the ``recoder.*`` spans of ``Recoder.train`` on the CPU
(one ``recoder.train`` a call, one ``recoder.epoch_start`` and one
``recoder.losses`` an epoch, one ``recoder.eager`` a dispatch, one
``recoder.epoch_tables`` an epoch that builds tables) and the nvcc
branch of ``kernels.load_library`` as ``recoder.kernel_build``."""

import subprocess
import sys
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from recoder_tpu_torch import kernels, trace
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder


def _since(before):
  """``trace.totals()`` less ``before``, name by name (new names whole)."""
  out = {}
  for name, (n, s, own) in trace.totals().items():
    n0, s0, own0 = before.get(name, (0, 0.0, 0.0))
    if n > n0:
      out[name] = (n - n0, s - s0, own - own0)
  return out


@pytest.fixture
def clock(monkeypatch):
  """``time.perf_counter`` of the trace module as a list of readings."""
  readings = []
  monkeypatch.setattr(trace.time, 'perf_counter', lambda: readings.pop(0))
  return readings


def test_nesting_gives_counts_seconds_and_self_seconds(clock):
  # outer 0 -> 10; inner a 1 -> 3, inner b 4 -> 8 with c 5 -> 6 inside
  clock += [0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0]
  before = trace.totals()
  with trace.span('t.outer'):
    with trace.span('t.inner'):
      pass
    with trace.span('t.inner'):
      with trace.span('t.leaf'):
        pass
  got = _since(before)
  assert got == {'t.outer': (1, 10.0, 4.0), 't.inner': (2, 6.0, 5.0),
                 't.leaf': (1, 1.0, 1.0)}


def test_totals_are_a_copy_and_differences_count_what_ran_between():
  first = trace.totals()
  with trace.span('t.copy'):
    pass
  second = trace.totals()
  assert first.get('t.copy', (0,))[0] + 1 == second['t.copy'][0]
  with trace.span('t.copy'):
    pass
  assert _since(second)['t.copy'][0] == 1
  assert second['t.copy'] != trace.totals()['t.copy']
  count, seconds, own = second['t.copy']
  assert isinstance(count, int) and 0.0 <= own <= seconds


def test_decorator_counts_each_call_and_an_exception_closes_the_span():
  @trace.span('t.decorated')
  def twice(x):
    if x is None:
      raise KeyError('no value')
    return 2 * x

  before = trace.totals()
  assert twice(4) == 8 and twice(5) == 10
  with pytest.raises(KeyError):
    with trace.span('t.outer_of_raise'):
      twice(None)
  got = _since(before)
  assert got['t.decorated'][0] == 3 and got['t.outer_of_raise'][0] == 1
  # (the stack is whole again: a new span nests in nothing)
  assert trace._LOCAL.stack == []


def test_no_record_function_without_a_profiler(monkeypatch):
  def refuse(name):
    raise AssertionError(f'record_function({name!r}) with no profiler')
  monkeypatch.setattr(trace.torch.profiler, 'record_function', refuse)
  before = trace.totals()
  with trace.span('t.quiet'):
    pass
  assert _since(before)['t.quiet'][0] == 1


def test_the_ranges_appear_in_a_cpu_profile():
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with trace.span('t.profiled'):
      with trace.span('t.profiled_inner'):
        torch.ones(4).add_(1)
  events = {ev.name: ev for ev in prof.events()
            if ev.name.startswith('t.profiled')}
  assert set(events) == {'t.profiled', 't.profiled_inner'}
  outer, inner = events['t.profiled'], events['t.profiled_inner']
  assert outer.time_range.start <= inner.time_range.start
  assert inner.time_range.end <= outer.time_range.end


def test_many_threads_lose_no_update():
  """32 threads over 8 cores, 500 spans each, switching every
  microsecond: the count is exact, and a thread's spans nest only in
  that thread's (each leaf's self seconds equal its seconds)."""
  n_threads, n_spans = 32, 500
  before = trace.totals()
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    def work():
      for _ in range(n_spans):
        with trace.span('t.threads'):
          pass
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    with trace.span('t.main'):
      for t in threads:
        t.start()
      for t in threads:
        t.join(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in threads)
  got = _since(before)
  count, seconds, own = got['t.threads']
  assert count == n_threads * n_spans
  assert own == pytest.approx(seconds)
  assert got['t.main'][2] == pytest.approx(got['t.main'][1])


# -- the trainer's spans ----------------------------------------------------


def _matrix():
  rng = np.random.default_rng(0)
  return sp.csr_matrix((rng.random((37, 120)) < 0.12).astype(np.float32))


def _train(tr, data, **kw):
  kw = {**dict(batch_size=8, lr=1e-2, num_epochs=2, negative_sampling=True,
               shuffle='users'), **kw}
  before = trace.totals()
  tr.train(data, **kw)
  return _since(before)


@pytest.mark.parametrize('shuffle, sparse, full_decode', [
    ('users', False, 'auto'), ('blocks', False, True),
    ('blocks', False, False), ('users', True, 'auto')])
def test_train_spans_a_call_an_epoch_and_a_dispatch(shuffle, sparse,
                                                    full_decode):
  """Two epochs of 5 eager steps: one ``recoder.train`` and one
  ``recoder.prepare``, an ``recoder.epoch_start`` and a ``recoder.losses``
  an epoch, a ``recoder.eager`` a dispatch; nothing captures off the
  card. The call's self seconds are its seconds less those of the spans
  directly inside it."""
  tr = Recoder(DynamicAutoencoder(hidden_layers=[16], sparse=sparse),
               optimizer_type='adam', loss='mse', device='cpu')
  data = RecommendationDataset(_matrix())
  got = _train(tr, data, shuffle=shuffle, full_decode=full_decode)
  assert tr.last_epoch_dispatch == 'eager'
  assert got['recoder.train'][0] == got['recoder.prepare'][0] == 1
  assert got['recoder.epoch_start'][0] == got['recoder.losses'][0] == 2
  # (the last epoch's dispatches; both epochs run 5 steps)
  assert got['recoder.eager'][0] == 2 * tr.last_epoch_dispatches == 10
  for name in ('recoder.warm_up', 'recoder.capture', 'recoder.replay'):
    assert name not in got
  assert got['recoder.train'][2] == pytest.approx(
      got['recoder.train'][1] - sum(
          got[name][1] for name in ('recoder.prepare', 'recoder.epoch_start',
                                    'recoder.eager', 'recoder.losses')),
      abs=1e-9)


def test_epoch_tables_span_each_build_and_not_a_placed_epoch():
  """'users' epochs of a sparse model build their tables at the epoch's
  start: one ``recoder.epoch_tables`` an epoch, inside
  ``recoder.epoch_start``; a call that continues the epoch builds none."""
  tr = Recoder(DynamicAutoencoder(hidden_layers=[16], sparse=True),
               optimizer_type='adam', loss='mse', device='cpu')
  data = RecommendationDataset(_matrix())
  got = _train(tr, data, num_epochs=3)
  assert tr.fused_data_source.users_precompute
  assert got['recoder.epoch_tables'][0] == 3
  assert got['recoder.epoch_start'][2] <= (got['recoder.epoch_start'][1]
                                           - got['recoder.epoch_tables'][1])
  tr.current_epoch = 4
  got = _train(tr, data, num_epochs=4, iters_per_epoch=2)
  assert got['recoder.epoch_tables'][0] == 1
  got = _train(tr, data, num_epochs=4, iters_per_epoch=2)
  assert 'recoder.epoch_tables' not in got
  assert got['recoder.eager'][0] == 2


def test_train_ranges_in_a_profile_of_the_whole_call():
  """A ``torch.profiler`` around a ``train`` call holds its ranges, nested
  as the spans are: every epoch's inside the call's."""
  tr = Recoder(DynamicAutoencoder(hidden_layers=[16]), optimizer_type='adam',
               loss='mse', device='cpu')
  data = RecommendationDataset(_matrix())
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    tr.train(data, batch_size=8, num_epochs=1, negative_sampling=True)
  ranges = [ev for ev in prof.events() if ev.name.startswith('recoder.')]
  names = [ev.name for ev in ranges]
  assert names.count('recoder.train') == names.count('recoder.prepare') == 1
  assert names.count('recoder.epoch_start') == 1
  assert names.count('recoder.eager') == tr.last_epoch_dispatches == 5
  assert names.count('recoder.losses') == 1
  call, = [ev for ev in ranges if ev.name == 'recoder.train']
  for ev in ranges:
    assert call.time_range.start <= ev.time_range.start
    assert ev.time_range.end <= call.time_range.end


def test_a_kernel_build_is_a_span(monkeypatch, tmp_path):
  """``load_library``'s nvcc branch adds one ``recoder.kernel_build``; a
  second load of the built library adds none (nvcc stands in here)."""
  assert not hasattr(kernels, 'BUILD_SECONDS')
  (tmp_path / 'fake.cu').write_text('// a source')
  monkeypatch.setattr(kernels, '_HERE', str(tmp_path))
  monkeypatch.setattr(kernels, 'BUILD_DIR', str(tmp_path / 'build'))
  monkeypatch.setattr(kernels, '_nvcc', lambda: 'nvcc')
  monkeypatch.setattr(kernels, '_LIBS', {})
  monkeypatch.setattr(kernels.ctypes, 'CDLL', lambda path: ('lib', path))

  def nvcc(cmd, **kw):
    with open(cmd[cmd.index('-o') + 1], 'w') as f:
      f.write('built')
    return subprocess.CompletedProcess(cmd, 0, 'ptxas info', '')
  monkeypatch.setattr(kernels.subprocess, 'run', nvcc)
  before = trace.totals()
  lib = kernels.load_library('fake')
  assert _since(before)['recoder.kernel_build'][0] == 1
  assert kernels.BUILD_LOGS['fake'] == 'ptxas info'
  monkeypatch.setattr(kernels, '_LIBS', {})
  before = trace.totals()
  assert kernels.load_library('fake') == lib
  assert 'recoder.kernel_build' not in _since(before)
