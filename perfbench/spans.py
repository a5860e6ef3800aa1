"""The program's own host spans in a profiled slice, and where the
slice's idle time falls among them.

The program opens a ``torch.profiler`` range for each of its
``recoder.*`` spans (``recoder_tpu_torch.trace``) while a profiler
runs, so the slice :func:`perfbench.devtrace.profile_slice` takes holds
them among its host operations, on the device's clock.
:func:`slice_totals` counts them as the program counts its spans
(count, seconds and self seconds a name); :func:`idle_spans` puts each
idle instant of the device under the innermost program range open then.
A program without the spans gives an empty count and every idle second
under :data:`NO_SPAN`.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and window as ``perfbench/run.py`` does (no check),
with the program's span totals taken before and after the window, then
profiles the next call and prints one JSON line: the window's span
totals and the call's wall, the slice's span totals, ``idle_spans`` and
``idle_gaps``, the device's idle share, and a span's cost on this host
with no profiler and under one.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the program's span names start so
PREFIX = 'recoder.'
#: the name of idle time under no program range
NO_SPAN = '(no program span)'


def ranges(piece):
  """The slice's program ranges, ``(name, start, end)``, by start (the
  enclosing range first where two start together)."""
  return sorted(((name, s, e) for name, s, e in piece.host
                 if name.startswith(PREFIX)),
                key=lambda r: (r[1], -r[2]))


def slice_totals(piece):
  """``{name: (count, seconds, self_seconds)}`` of the slice's program
  ranges; a range's self seconds are its seconds less those of the
  ranges directly inside it."""
  totals, stack = {}, []  # stack: [name, start, end, inner seconds]

  def close(entry):
    name, s, e, inner = entry
    count, seconds, own = totals.get(name, (0, 0.0, 0.0))
    totals[name] = (count + 1, seconds + (e - s), own + (e - s) - inner)
    if stack:
      stack[-1][3] += e - s

  for name, s, e in ranges(piece):
    while stack and stack[-1][2] <= s:
      close(stack.pop())
    stack.append([name, s, e, 0.0])
  while stack:
    close(stack.pop())
  return totals


def _innermost(piece):
  """The slice's time as consecutive ``(start, end, name)`` pieces, each
  under the shortest program range open over it (``None``: none)."""
  rs = ranges(piece)
  edges = sorted({piece.start, piece.end}
                 | {t for _, s, e in rs for t in (s, e)
                    if piece.start < t < piece.end})
  out, i, open_ = [], 0, []
  for a, b in zip(edges, edges[1:]):
    while i < len(rs) and rs[i][1] <= a:
      open_.append(rs[i])
      i += 1
    open_ = [r for r in open_ if r[2] > a]
    name = min(open_, key=lambda r: r[2] - r[1])[0] if open_ else None
    out.append((a, b, name))
  return out


def idle_spans(piece, n=10):
  """The device's idle seconds in the slice summed by the innermost
  program range open at each idle instant, the ``n`` largest first, as
  ``[name, seconds]``; idle time under no program range goes to
  :data:`NO_SPAN`."""
  edges = [piece.start] + [x for iv in piece.busy for x in iv] + [piece.end]
  gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
          if edges[i + 1] > edges[i]]
  sums, j = {}, 0
  pieces = _innermost(piece)
  for gs, ge in gaps:
    while j < len(pieces) and pieces[j][1] <= gs:
      j += 1
    k = j
    while k < len(pieces) and pieces[k][0] < ge:
      a, b, name = pieces[k]
      overlap = min(b, ge) - max(a, gs)
      if overlap > 0:
        key = name or NO_SPAN
        sums[key] = sums.get(key, 0.0) + overlap
      k += 1
  return sorted(([k, v] for k, v in sums.items()), key=lambda kv: -kv[1])[:n]


def since(after, before):
  """Span totals ``after`` less ``before``, names that ran between."""
  out = {}
  for name, (count, seconds, own) in after.items():
    c0, s0, o0 = before.get(name, (0, 0.0, 0.0))
    if count > c0:
      out[name] = (count - c0, seconds - s0, own - o0)
  return out


def span_cost_us(reps=20000):
  """Microseconds an empty span takes on this host: ``(no profiler,
  under a CPU profiler)``."""
  from torch.profiler import ProfilerActivity, profile

  from recoder_tpu_torch import trace

  def timed():
    t = time.perf_counter()
    for _ in range(reps):
      with trace.span('perfbench.cost'):
        pass
    return (time.perf_counter() - t) * 1e6 / reps
  off = timed()
  with profile(activities=[ProfilerActivity.CPU]):
    on = timed()
  return off, on


def main(argv=None):
  t_start = time.perf_counter()
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  args = ap.parse_args(argv)
  sys.path[0] = ROOT
  import torch

  from perfbench import devtrace, harness
  from recoder_tpu_torch import trace
  if not torch.cuda.is_available():
    print('no CUDA device: the spans are read on the card', file=sys.stderr)
    return 1
  cell = harness.load_cell(args.workload)
  device = torch.device('cuda')
  run, prog, _, setup_s = harness.set_up(cell, args.seed, device, t_start)
  before = trace.totals()
  harness.drive_window(run, prog, args.seconds)
  window = since(trace.totals(), before)
  piece = devtrace.profile_slice(prog.next_call)
  calls = window.get('recoder.train', (0,))[0]
  off, on = span_cost_us()
  print(json.dumps({
      'workload': args.workload, 'seed': args.seed, 'setup_s': setup_s,
      'window_s': run.window_s, 'steps': run.steps, 'calls': calls,
      'window_spans': window,
      'spans_per_call': sum(c for c, _, _ in window.values()) / max(calls, 1),
      'span_us': {'off': off, 'on': on},
      'slice_s': piece.window_s, 'slice_busy_s': piece.busy_s,
      'device_idle_pct': 100.0 * (1.0 - piece.busy_s / piece.window_s),
      'slice_spans': slice_totals(piece),
      'idle_spans': idle_spans(piece), 'idle_gaps': piece.idle_gaps(),
      'device': torch.cuda.get_device_name(0)}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
