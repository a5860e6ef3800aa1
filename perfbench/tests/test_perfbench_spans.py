"""The program's ranges in a profiled slice: their counts and self
seconds, the slice's idle time put under the innermost one, the three
readers that take them (and read nothing from a program without them);
and, on the card, that a slice whose work runs inside such ranges
counts none of their annotations as device work."""

import types

import pytest

from perfbench import devtrace, harness, spans


def _slice():
  """A call of 10 s: set-up 0-3 (prepare 0.5-2), an epoch's start 3-5
  with its tables 3.5-4.5, replays 5-6 and 6-8, the losses 8-9.5; the
  device busy 2.5-3.2, 4.6-4.8, 5.0-7.5 and 8.0-9.0."""
  ops = [('copy', 2.5, 3.2), ('sort', 4.6, 4.8), ('gemm', 5.0, 7.5),
         ('adam', 8.0, 9.0)]
  host = [('perfbench.slice', 0.0, 10.0), ('recoder.train', 0.2, 9.8),
          ('recoder.prepare', 0.5, 2.0), ('recoder.epoch_start', 3.0, 5.0),
          ('recoder.epoch_tables', 3.5, 4.5), ('cudaMemcpyAsync', 3.6, 3.7),
          ('recoder.replay', 5.0, 6.0), ('recoder.replay', 6.0, 8.0),
          ('recoder.losses', 8.0, 9.5)]
  return devtrace.Slice(ops, host, 0.0, 10.0, markers=64)


def test_slice_totals_count_and_self_seconds():
  got = spans.slice_totals(_slice())
  assert set(got) == {'recoder.train', 'recoder.prepare',
                      'recoder.epoch_start', 'recoder.epoch_tables',
                      'recoder.replay', 'recoder.losses'}
  assert got['recoder.train'] == pytest.approx((1, 9.6, 9.6 - 1.5 - 2.0
                                                - 3.0 - 1.5))
  assert got['recoder.epoch_start'] == pytest.approx((1, 2.0, 1.0))
  assert got['recoder.epoch_tables'] == pytest.approx((1, 1.0, 1.0))
  assert got['recoder.replay'] == pytest.approx((2, 3.0, 3.0))


def test_idle_time_goes_to_the_innermost_range_at_each_instant():
  # idle: 0-2.5 (0.2 under nothing, 0.3 train, 1.5 prepare, 0.5 train),
  # 3.2-4.6 (epoch_start 0.3, tables 1.0, epoch_start 0.1 from 4.5),
  # 4.8-5.0 (epoch_start), 7.5-8.0 (replay), 9.0-10 (losses 0.5, train
  # 0.3, nothing 0.2)
  got = dict(spans.idle_spans(_slice()))
  want = {'recoder.prepare': 1.5, 'recoder.train': 1.1,
          'recoder.epoch_tables': 1.0, 'recoder.epoch_start': 0.6,
          'recoder.replay': 0.5, 'recoder.losses': 0.5,
          spans.NO_SPAN: 0.4}
  assert got == pytest.approx(want)
  assert sum(got.values()) == pytest.approx(
      _slice().window_s - _slice().busy_s)
  top = spans.idle_spans(_slice(), 2)
  assert [name for name, _ in top] == ['recoder.prepare', 'recoder.train']
  assert [s for _, s in top] == pytest.approx([1.5, 1.1])


def test_a_program_without_ranges():
  piece = devtrace.Slice([('gemm', 1.0, 2.0)], [('perfbench.slice', 0.0,
                                                 3.0)], 0.0, 3.0, 64)
  assert spans.slice_totals(piece) == {}
  assert spans.idle_spans(piece) == [[spans.NO_SPAN, 2.0]]
  run = types.SimpleNamespace(slice=piece, slice_steps=943,
                              steps_per_epoch=943)
  for name in ('epoch_start_ms', 'table_build_ms', 'capture_ms_per_epoch'):
    assert harness.load_reader(name).read(run) is None, name
  run.slice = None
  for name in ('epoch_start_ms', 'table_build_ms', 'capture_ms_per_epoch'):
    assert harness.load_reader(name).read(run) is None, name


def test_the_readers_on_a_slice_with_ranges():
  run = types.SimpleNamespace(slice=_slice(), slice_steps=100,
                              steps_per_epoch=200)
  read = {name: harness.load_reader(name).read(run)
          for name in ('epoch_start_ms', 'table_build_ms',
                       'capture_ms_per_epoch')}
  assert read['epoch_start_ms'] == pytest.approx((1.5 + 1.0) * 1e3)
  assert read['table_build_ms'] == pytest.approx(1.0 * 1e3)
  assert read['capture_ms_per_epoch'] == 0.0
  host = run.slice.host + [('recoder.warm_up', 5.0, 5.5),
                           ('recoder.capture', 5.5, 5.9)]
  run.slice = devtrace.Slice(run.slice.ops, host, 0.0, 10.0, 64)
  got = harness.load_reader('capture_ms_per_epoch').read(run)
  assert got == pytest.approx(0.9 * 1e3 / 0.5)


def test_since_keeps_what_ran_between():
  before = {'recoder.train': (2, 1.0, 0.25), 'recoder.replay': (5, 1.0, 1.0)}
  after = {'recoder.train': (3, 1.5, 0.5), 'recoder.replay': (5, 1.0, 1.0),
           'recoder.capture': (1, 0.125, 0.125)}
  assert spans.since(after, before) == {'recoder.train': (1, 0.5, 0.25),
                                        'recoder.capture': (1, 0.125, 0.125)}


@pytest.mark.cuda
def test_ranges_add_no_device_work(card):
  """The same kernels profiled bare and inside ``recoder.*`` ranges (a
  range a launch): the device's busy time agrees within 10%, and no
  device operation carries a range's name."""
  import torch

  from recoder_tpu_torch import trace
  x = torch.randn(2048, 2048, device=card)

  def bare():
    for _ in range(16):
      x.matmul(x)

  def ranged():
    with trace.span('recoder.test_call'):
      for _ in range(16):
        with trace.span('recoder.test_launch'):
          x.matmul(x)

  bare()
  busy = {}
  for name, fn in (('bare', bare), ('ranged', ranged), ('bare2', bare),
                   ('ranged2', ranged)):
    piece = devtrace.profile_slice(fn)
    busy[name] = piece.busy_s
    assert not any(op.startswith('recoder.') for op, _, _ in piece.ops)
    if name.startswith('ranged'):
      assert spans.slice_totals(piece)['recoder.test_launch'][0] == 16
  plain = (busy['bare'] + busy['bare2']) / 2
  for name in ('ranged', 'ranged2'):
    assert busy[name] == pytest.approx(plain, rel=0.1), busy
