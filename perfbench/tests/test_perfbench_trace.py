"""The reduction of a profiled slice: busy time as the union of device
intervals, the idle gaps with the host operation under each, the
largest operations; and, on the card, a profiled slice of real kernels."""

import pytest

from perfbench import devtrace


def test_merge_overlapping_intervals():
  assert devtrace.merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
  assert devtrace.merge([]) == []


def _slice():
  ops = [('gemm', 1.0, 2.0), ('copy', 1.5, 3.0),   # two streams overlap
         ('adam', 5.0, 6.0), ('gemm', 8.0, 9.5),   # the last runs past
         ('early', -1.0, 0.5)]                     # before the range
  host = [('perfbench.slice', 0.0, 9.0), ('cudaMemcpyAsync', 2.5, 4.5),
          ('aten::fill_', 3.5, 4.0), ('train', 0.0, 9.0)]
  return devtrace.Slice(ops, host, 0.0, 9.0, markers=64)


def test_busy_is_the_union_clipped_to_the_range():
  s = _slice()
  assert s.window_s == 9.0
  assert s.busy == [[0.0, 0.5], [1.0, 3.0], [5.0, 6.0], [8.0, 9.0]]
  assert s.busy_s == 0.5 + 2.0 + 1.0 + 1.0


def test_operations_by_name():
  s = _slice()
  assert s.seconds(lambda n: n == 'gemm') == 2.5
  assert s.launches(lambda n: n == 'gemm') == 2
  assert s.top_ops(2) == [['gemm', 2.5], ['copy', 1.5]]


def test_idle_gaps_named_by_the_innermost_host_op():
  # gaps 3.0-5.0 (the copy is open at 3.0; the fill opens later),
  # 6.0-8.0 and 0.5-1.0 (only the whole call open)
  assert _slice().idle_gaps() == [['cudaMemcpyAsync', 2.0], ['train', 2.0],
                                  ['train', 0.5]]
  assert _slice().idle_gaps(1) == [['cudaMemcpyAsync', 2.0]]


@pytest.mark.cuda
def test_a_profiled_slice_on_the_card(card):
  import torch
  x = torch.randn(2048, 2048, device=card)

  def work():
    for _ in range(8):
      x.matmul(x)
  s = devtrace.profile_slice(work)
  assert s.markers > 0 and s.window_s > 0
  assert 0 < s.busy_s <= s.window_s
  assert s.launches(lambda n: 'spin_kernel' in n) == 0
  assert sum(count for _, count in s.top_ops()) > 0
