"""Opt-in per-step training progress: the reference's tqdm bar with a
running-loss postfix (reference model.py:381,412-415).

Port of ``recoder_tpu/progress.py`` (a copy of its logic; the port
imports nothing of the JAX package). The bar must never hold the
training stream back: fetching a loss to the host waits for the device.
So the train loop hands over each block of steps with its losses as
they lie on the device and a way to know when they are there
(:func:`loss_handle`: on the card a ``non_blocking`` copy into pinned
host memory and an event recorded after it), and a background thread
drains the queue to the newest handle, waits on its event alone and
paints. The epoch-end close does not join that thread either.

Without ``tqdm`` (the card's machine has none) one stderr line is
rewritten in place.
"""

import queue
import sys
import threading
import time

import torch


def loss_handle(losses):
  """``(host tensor, event or None)`` for the device tensor ``losses``,
  without a wait: a CUDA tensor is copied into pinned host memory on the
  current stream, and the event marks the copy's end."""
  if losses.device.type != 'cuda':
    return losses.detach().clone(), None
  host = torch.empty(losses.shape, dtype=losses.dtype, pin_memory=True)
  host.copy_(losses.detach(), non_blocking=True)
  event = torch.cuda.Event()
  event.record()
  return host, event


class _PlainBar:
  """Minimal fallback when tqdm is unavailable: one stderr line
  rewritten in place."""

  def __init__(self, total, desc):
    self.total, self.desc, self.n = total, desc, 0

  def update(self, n):
    self.n += n

  def set_postfix_str(self, s):
    sys.stderr.write(f'\r{self.desc}: {self.n}/{self.total} {s}')
    sys.stderr.flush()

  def close(self):
    sys.stderr.write('\r\x1b[K')
    sys.stderr.flush()


class ProgressReporter:
  """Per-epoch progress bar fed with loss handles.

  Usage::

      rep = ProgressReporter(total_steps, 'Epoch 3/30')
      rep.put(16, loss_handle(losses))  # per block; never blocks
      rep.close()                       # the thread paints and closes
  """

  #: minimum seconds between paints: each paint waits on a copy and
  #: writes to the terminal, which competes with the dispatch thread
  MIN_PAINT_INTERVAL = 0.25

  def __init__(self, total, desc):
    self._q = queue.SimpleQueue()
    self._bar = self._new_bar(total, desc)
    self._thread = threading.Thread(target=self._run,
                                    name='progress-reporter', daemon=True)
    self._thread.start()

  def put(self, num_steps, handle):
    """Record ``num_steps`` dispatched steps whose losses ``handle``
    (from :func:`loss_handle`) will hold. Returns immediately."""
    self._q.put((num_steps, handle))

  def reset(self, total, desc):
    """Start the next epoch's bar (the thread paints the old bar's final
    state, closes it and opens the new one)."""
    self._q.put(('reset', total, desc))

  def close(self, wait=False):
    """Finish the bar; the thread paints the final state and closes it.
    ``wait`` joins the thread."""
    self._q.put(None)
    if wait:
      self._thread.join(timeout=30)

  def _new_bar(self, total, desc):
    try:
      from tqdm import tqdm
      return tqdm(total=total, desc=desc, leave=False, dynamic_ncols=True,
                  file=sys.stderr)
    except ImportError:
      return _PlainBar(total, desc)

  def _paint(self, pending, handle):
    if pending and handle is not None:
      host, event = handle
      if event is not None:
        event.synchronize()  # this copy's end, not the stream's
      self._bar.update(pending)
      self._bar.set_postfix_str(f'loss={float(host.float().mean()):.5f}')

  def _run(self):
    done = False
    pending = 0
    last_paint = 0.0
    handle = None
    while not done:
      item = self._q.get()
      if item is None:
        break
      # drain to the newest handle: a slow fetch must lag further
      # behind, not backlog the queue
      while item is not None:
        if isinstance(item, tuple) and item[0] == 'reset':
          self._paint(pending, handle)  # previous epoch's final state
          pending, handle = 0, None
          self._bar.close()
          self._bar = self._new_bar(item[1], item[2])
          last_paint = 0.0
        else:
          pending += item[0]
          handle = item[1]
        try:
          item = self._q.get_nowait()
        except queue.Empty:
          item = object()  # queue drained (None means shutdown)
          break
      if item is None:
        done = True
      now = time.time()
      if not done and now - last_paint < self.MIN_PAINT_INTERVAL:
        continue  # keep accumulating; skip the fetch entirely
      last_paint = now
      self._paint(pending, handle)
      pending = 0
    self._paint(pending, handle)  # final state before close
    self._bar.close()
