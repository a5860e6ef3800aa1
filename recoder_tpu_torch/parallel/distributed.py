"""Multi-process bootstrap: one process per GPU, over torch.distributed.

Port of ``recoder_tpu/parallel/distributed.py``. JAX drives every device
of a mesh from one process per host; the port runs one process per card
(``torchrun --nproc_per_node=N``, or ``torch.multiprocessing.spawn``),
each running the same program over the same host data, so that each
builds the same global batch from the same seed and keeps its share of
it (``parallel/sharding.py``).

:func:`initialize` joins the default process group: NCCL on the card,
gloo on the CPU. It reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and is
a no-op in a single process, as the JAX function is. Nothing here reads
a cluster's metadata: a launch that is not torchrun's passes the
coordinator's address, the process count and the rank.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from recoder_tpu_torch import device as device_lib


def _env_int(name):
  value = os.environ.get(name)
  return None if value in (None, '') else int(value)


def backend_for(device):
  """The collective backend of ``device``: 'nccl' for a card, 'gloo' for
  the CPU."""
  return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def local_rank():
  """This process's card among its host's: torchrun's ``LOCAL_RANK``,
  else the global rank modulo the host's cards."""
  lr = _env_int('LOCAL_RANK')
  if lr is not None:
    return lr
  rank = dist.get_rank() if dist.is_initialized() else 0
  return rank % max(1, torch.cuda.device_count())


def process_index():
  """This process's rank (0 outside a process group)."""
  return dist.get_rank() if dist.is_initialized() else 0


def process_count():
  """The number of processes in the default group (1 outside one)."""
  return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, device=device_lib.DEFAULT):
  """Join the default process group (no-op when single-process).

  Args:
    coordinator_address: "host:port" of process 0 (None: torchrun's
      ``MASTER_ADDR`` / ``MASTER_PORT``).
    num_processes: total process count (None: ``WORLD_SIZE``).
    process_id: this process's rank (None: ``RANK``).
    device (the port's): 'cuda' joins over NCCL and makes this process's
      card (``LOCAL_RANK``) the current one; 'cpu' joins over gloo.

  With all-default arguments the environment decides: a torchrun launch
  (``WORLD_SIZE`` above 1) joins; a plain single process returns without
  a group, as the JAX ``initialize`` does. A group that is already
  initialized is kept.
  """
  if dist.is_initialized():
    return
  num_processes = (num_processes if num_processes is not None
                   else _env_int('WORLD_SIZE'))
  process_id = process_id if process_id is not None else _env_int('RANK')
  if num_processes in (None, 1) and coordinator_address is None:
    return  # single process
  device = device_lib.resolve(device)
  if device.type == 'cuda':
    torch.cuda.set_device(local_rank())
  init_method = ('env://' if coordinator_address is None
                 else f'tcp://{coordinator_address}')
  dist.init_process_group(backend_for(device), init_method=init_method,
                          world_size=num_processes, rank=process_id)


def host_user_shard(num_users, process_id=None, num_processes=None):
  """The contiguous user-id range ``(lo, hi)`` this process should load
  and train, as the JAX function splits it (``np.linspace`` bounds)."""
  pid = process_index() if process_id is None else process_id
  n = process_count() if num_processes is None else num_processes
  bounds = np.linspace(0, num_users, n + 1).astype(int)
  return int(bounds[pid]), int(bounds[pid + 1])
