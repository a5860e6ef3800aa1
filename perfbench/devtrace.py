"""A profiled slice of the window, reduced to device intervals.

:func:`settle` is a frozen copy of ``chip_smoke.py``'s
``settle_profiler``: torch.profiler loses the first device events of a
window (the more, the more windows a process has opened), so every
traced slice starts with ``MARKERS`` spin kernels that absorb the loss.
:func:`profile_slice` runs one call under the profiler inside a named
range and returns what the per-layer readers take: each device
operation (kernel, copy, set) that ran inside the range, the range's
length, the union of the device intervals, and the host operation under
each idle gap.
"""

import time

#: spin kernels that open a traced slice
MARKERS = 64
RANGE = 'perfbench.slice'
_SPIN = 'spin_kernel'


def settle():
  """A pause on the host, then ``MARKERS`` spin kernels of ~10 us each,
  waited for."""
  import torch
  torch.cuda.synchronize()
  time.sleep(0.05)
  for _ in range(MARKERS):
    torch.cuda._sleep(20000)
  torch.cuda.synchronize()


def merge(intervals):
  """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
  out = []
  for start, end in sorted(intervals):
    if out and start <= out[-1][1]:
      out[-1][1] = max(out[-1][1], end)
    else:
      out.append([start, end])
  return out


class Slice:
  """The reduction of one profiled slice (times in seconds).

  ``ops``: ``(name, start, end)`` of each device operation inside the
  range; ``host``: ``(name, start, end)`` of each host operation;
  ``start``, ``end``: the range on the profiler's clock; ``markers``:
  the spin kernels the profile kept."""

  def __init__(self, ops, host, start, end, markers):
    self.ops, self.host = ops, host
    self.start, self.end, self.markers = start, end, markers
    self.window_s = end - start
    self.busy = merge([(max(s, start), min(e, end)) for _, s, e in ops
                       if e > start and s < end])
    self.busy_s = sum(e - s for s, e in self.busy)

  def seconds(self, match):
    """Device seconds of the operations whose name ``match`` accepts."""
    return sum(e - s for name, s, e in self.ops if match(name))

  def launches(self, match):
    return sum(1 for name, _, _ in self.ops if match(name))

  def top_ops(self, n=10):
    totals = {}
    for name, s, e in self.ops:
      totals[name] = totals.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:n]

  def idle_gaps(self, n=10):
    """The ``n`` longest device gaps in the range, each named by the
    innermost host operation open at the gap's start."""
    edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
      open_ops = [(he - hs, name) for name, hs, he in self.host
                  if hs <= s < he and name != RANGE]
      out.append([min(open_ops)[1] if open_ops else 'host: no profiled op',
                  e - s])
    return out


def profile_slice(fn):
  """Run ``fn()`` (then a synchronize) under torch.profiler, opened by
  :func:`settle`; returns the :class:`Slice` of the range around it."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    settle()
    with record_function(RANGE):
      fn()
      torch.cuda.synchronize()
  events = prof.events()
  host = [(ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
          for ev in events if ev.device_type == DeviceType.CPU]
  host_names = {name for name, _, _ in host}
  (start, end), = [(s, e) for name, s, e in host if name == RANGE]
  device = [(ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
            for ev in events if ev.device_type == DeviceType.CUDA
            and ev.name not in host_names]
  markers = sum(1 for name, _, _ in device if _SPIN in name)
  ops = [op for op in device if _SPIN not in op[0]
         and op[2] > start and op[1] < end]
  return Slice(ops, host, start, end, markers)
