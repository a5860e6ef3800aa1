"""Named host spans: counts and seconds kept in memory, and a
``torch.profiler`` range each while a profiler is active.

``span(name)`` wraps a boundary of the host's work, as a ``with`` block
or as a decorator. On exit it adds, under its name, one to the count,
its seconds and its self seconds (its seconds less those of the spans
opened directly inside it on the same thread), timed on
``time.perf_counter``; :func:`totals` copies the totals out, and the
difference of two copies is what ran between them. The totals are
always kept, like the kernels' launch counters: a span costs two clock
reads, a flag read and an update of a small dict under a lock.

While a ``torch.profiler`` is active on the thread, a span also opens a
``torch.profiler.record_function`` range of its name, so the profile
holds the range beside the device's events, on the profiler's clock;
with no profiler it makes no range. A span opened before the profiler
started has no range in its trace.

The port's spans are named ``recoder.*``: ``recoder.train`` (a
``Recoder.train`` call), ``recoder.prepare`` (its work before the first
epoch), ``recoder.epoch_start`` (an epoch's host work before its first
dispatch), ``recoder.epoch_tables`` (the build and placement of a
'users' epoch's tables), ``recoder.warm_up`` and ``recoder.capture``
(the eager steps before a capture, and a capture), ``recoder.replay``
and ``recoder.eager`` (one dispatch: a graph replay, or one eager step),
``recoder.losses`` (the epoch's loss read-back) and
``recoder.kernel_build`` (an ``nvcc`` build). None is finer than one
dispatch, and none opens inside a CUDA graph capture, whose replays
would not repeat it.
"""

import functools
import threading
import time

import torch

_TOTALS = {}  # name -> [count, seconds, self seconds]
_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: this thread's open spans


class span:
  """A span of ``name``: ``with span(name):`` or ``@span(name)``."""

  __slots__ = ('name', '_range', '_t0', '_inner')

  def __init__(self, name):
    self.name = name

  def __enter__(self):
    stack = getattr(_LOCAL, 'stack', None)
    if stack is None:
      stack = _LOCAL.stack = []
    stack.append(self)
    self._inner = 0.0
    self._range = None
    if torch.autograd._profiler_enabled():
      self._range = torch.profiler.record_function(self.name)
      self._range.__enter__()
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    seconds = time.perf_counter() - self._t0
    if self._range is not None:
      self._range.__exit__(*exc)
    stack = _LOCAL.stack
    stack.pop()
    if stack:
      stack[-1]._inner += seconds
    with _LOCK:
      total = _TOTALS.setdefault(self.name, [0, 0.0, 0.0])
      total[0] += 1
      total[1] += seconds
      total[2] += seconds - self._inner
    return False

  def __call__(self, fn):
    name = self.name

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
      with span(name):
        return fn(*args, **kwargs)
    return spanned


def totals():
  """A copy of the totals: ``{name: (count, seconds, self_seconds)}``."""
  with _LOCK:
    return {name: tuple(total) for name, total in _TOTALS.items()}
