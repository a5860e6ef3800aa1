"""Directory checkpoints in PyTorch's DCP format (``.metadata`` plus ``__*.distcp``).

The port of ``recoder_tpu/checkpoint_orbax.py``: the same contract over
``torch.distributed.checkpoint`` instead of Orbax's tensorstore, which
this package cannot read or write. ``Recoder.save_state(backend='orbax')``
writes it and ``Recoder.init_from_model_file`` detects it (directory ->
this backend, file -> npz).

A checkpoint is a DIRECTORY, ``{prefix}_epoch_{N}.orbax/``. Every array
is one DCP tensor under its '/'-joined tree path (the npz format's
keys); the JSON metadata rides inside the same commit as the reserved
uint8 tensor ``__recoder_meta__``.

With ``async_save`` the call returns once the arrays are in host
memory; the DCP write and the swap run on one non-daemon thread, at
most one save in flight. The thread reads host memory only: captured
CUDA graphs go on writing the parameter and moment storages the
snapshot was taken from. A tensor is copied to the host (cloned if it
is on the CPU already); a numpy array is written as it is, so the
caller leaves it unchanged until the commit. An error of a background save is raised once,
by the next save, load or :func:`wait_for_pending_saves`, and at exit it
makes the process exit with status 1.

Crash-safe overwrite: DCP writes into ``{path}.partial``, which is
renamed to ``{path}.tmp-save`` once the write has returned (so an
existing ``.tmp-save`` is always a complete checkpoint), then swapped
in: the old tree renamed to ``{path}.old``, the new one to ``path``,
``.old`` removed. A crash at any point leaves at least one complete
checkpoint on disk, and a load or the next save finishes an
interrupted swap.

DCP's collectives are never entered (``no_dist=True``): on a mesh the
caller gathers the arrays and only rank 0 writes, while the other ranks
go on with the default process group. A tree the JAX package's Orbax
backend wrote is refused with a ValueError that names the route through
npz.
"""

import atexit
import json
import os
import shutil
import sys
import threading
import traceback
import warnings

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from recoder_tpu_torch.checkpoint import flatten_tree, unflatten_tree

#: reserved entry carrying the JSON metadata inside the tree
_META_KEY = '__recoder_meta__'
#: files that mark a tree the JAX package's Orbax backend committed
_ORBAX_MARKERS = ('_CHECKPOINT_METADATA', '_METADATA')

_PENDING = None        # in-flight async save thread (at most one)
_PENDING_ERROR = None  # exception raised by the last async save
_LOCK = threading.Lock()   # guards _PENDING/_PENDING_ERROR only
_SAVE_SERIAL = threading.Lock()  # serializes save calls; never taken by
                                 # the worker thread (holding it across
                                 # join() is safe)


def wait_for_pending_saves():
  """Block until the in-flight async save (if any) has committed.

  Re-raises, once, any exception the background save hit.
  """
  global _PENDING, _PENDING_ERROR
  with _LOCK:
    pending = _PENDING
  if pending is not None:
    pending.join()
    with _LOCK:
      if _PENDING is pending:
        _PENDING = None
  with _LOCK:
    err, _PENDING_ERROR = _PENDING_ERROR, None
  if err is not None:
    raise err


# An async save's error is otherwise raised only by a later save, load or
# wait; a run whose last checkpoint failed must not exit 0, and an atexit
# re-raise only prints a traceback, so exit with os._exit(1). By atexit
# time the non-daemon save thread has been joined, so this never blocks.
def _surface_pending_error_at_exit():
  try:
    wait_for_pending_saves()
  except BaseException:
    traceback.print_exc()
    sys.stderr.write(
        'recoder_tpu_torch: a background checkpoint save FAILED (see '
        'traceback above); exiting with status 1\n')
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(1)


atexit.register(_surface_pending_error_at_exit)


def _dcp_quietly(fn, *args, **kwargs):
  # DCP warns that it assumes one process whenever no group is running;
  # no_dist=True asks for just that
  with warnings.catch_warnings():
    warnings.filterwarnings('ignore', message='torch.distributed is disabled')
    return fn(*args, no_dist=True, **kwargs)


def _write_tree(path, state_dict):
  """Write ``state_dict`` (flat, host tensors) as a DCP directory."""
  _dcp_quietly(dcp.save, state_dict,
               storage_writer=dcp.FileSystemWriter(path))


def _save_and_swap(path, state_dict):
  tmp, old, partial = path + '.tmp-save', path + '.old', path + '.partial'
  if not os.path.isdir(path):
    # a crash mid-swap can leave the ONLY complete checkpoint in tmp or
    # old with ``path`` absent: restore it rather than delete it, so a
    # failure of THIS save still leaves a checkpoint behind
    _recover_interrupted_swap(path)
  for leftover in (tmp, old, partial):   # stale debris
    if os.path.isdir(leftover):
      shutil.rmtree(leftover)
  _write_tree(partial, state_dict)
  os.rename(partial, tmp)  # the commit: tmp is complete from here on
  # the only window where ``path`` is absent is between the two renames;
  # both ``tmp`` and ``old`` exist then, and the loader recovers either
  if os.path.exists(path):
    os.rename(path, old)
  os.rename(tmp, path)
  if os.path.isdir(old):
    shutil.rmtree(old)


def _host_tensor(value):
  """``value`` as a host tensor: a tensor's own copy, a numpy array's
  memory."""
  if isinstance(value, torch.Tensor):
    return value.detach().to('cpu', copy=True).contiguous()
  return torch.from_numpy(np.asarray(value, order='C'))


def save_checkpoint_orbax(path, arrays_tree, metadata, async_save=True):
  """Write a nested dict of arrays or tensors plus JSON-able metadata to
  the directory ``path``.

  With ``async_save`` the call returns once the arrays are in host
  memory; the DCP write and the atomic swap happen on a background
  thread (call :func:`wait_for_pending_saves` before reading it back in
  the same process). Tensors are copied; numpy arrays are read by that
  thread as they are.
  """
  global _PENDING
  path = os.path.abspath(path)
  with _SAVE_SERIAL:  # concurrent savers: at most one in-flight save
    wait_for_pending_saves()
    if _META_KEY in arrays_tree:
      raise ValueError(f'{_META_KEY!r} is a reserved checkpoint key')
    state_dict = {k: _host_tensor(v)
                  for k, v in flatten_tree(arrays_tree).items()}
    state_dict[_META_KEY] = torch.frombuffer(
        bytearray(json.dumps(metadata).encode('utf-8')), dtype=torch.uint8)

    if not async_save:
      _save_and_swap(path, state_dict)
      return

    def work():
      global _PENDING_ERROR
      try:
        _save_and_swap(path, state_dict)
      except BaseException as e:  # raised by wait_for_pending_saves
        with _LOCK:
          _PENDING_ERROR = e

    thread = threading.Thread(target=work, name='dcp-save', daemon=False)
    with _LOCK:
      _PENDING = thread
    thread.start()


def _recover_interrupted_swap(path):
  """Finish a swap a crash interrupted: prefer the committed new tree
  (``.tmp-save``), else restore the displaced old one (``.old``)."""
  tmp, old = path + '.tmp-save', path + '.old'
  if os.path.isdir(tmp):
    os.rename(tmp, path)
    if os.path.isdir(old):
      shutil.rmtree(old)
    return True
  if os.path.isdir(old):
    os.rename(old, path)
    return True
  return False


def _to_numpy(tensor):
  # the npz path stores bf16 upcast to float32, which holds it exactly
  if tensor.dtype == torch.bfloat16:
    tensor = tensor.float()
  return tensor.numpy()


def load_checkpoint_orbax(path):
  """Returns ``(arrays_tree, metadata)`` from :func:`save_checkpoint_orbax`,
  with numpy arrays."""
  path = os.path.abspath(path)
  wait_for_pending_saves()
  if not os.path.isdir(path):
    if not _recover_interrupted_swap(path):
      raise FileNotFoundError(path)
  if not os.path.exists(os.path.join(path, '.metadata')):
    if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
      raise ValueError(
          f'{path} is an Orbax (tensorstore) tree written by the JAX '
          "package, which this package cannot read: load it with "
          "recoder_tpu's Recoder.init_from_model_file, write it again "
          "with save_state(prefix, backend='npz') and load that .model "
          'file here')
    raise ValueError(f'{path} is not a checkpoint directory (no DCP '
                     '.metadata)')
  entries = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
  state_dict = {}
  for key, entry in entries.items():
    if not isinstance(entry, TensorStorageMetadata):
      raise ValueError(f'{path}: entry {key!r} is not a tensor')
    state_dict[key] = torch.empty(entry.size, dtype=entry.properties.dtype)
  _dcp_quietly(dcp.load, state_dict,
               storage_reader=dcp.FileSystemReader(path))
  meta = json.loads(bytes(state_dict.pop(_META_KEY).numpy()).decode('utf-8'))
  return unflatten_tree({k: _to_numpy(v) for k, v in state_dict.items()}), meta


def is_orbax_checkpoint(path):
  """Whether ``path`` is a directory checkpoint: this backend's, a JAX
  Orbax tree (which the loader refuses by name), or the leftovers of an
  interrupted swap."""
  if os.path.isdir(path):
    return any(os.path.exists(os.path.join(path, m))
               for m in ('.metadata',) + _ORBAX_MARKERS)
  return (os.path.isdir(path + '.tmp-save')
          or os.path.isdir(path + '.old'))
