"""The ('data', 'model') mesh over the ranks of a process group.

Port of ``recoder_tpu/parallel/mesh.py``. A JAX mesh is an array of the
devices one process drives; the port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, one rank a card (or a CPU process under gloo),
with the same sizing rules: ``data=None`` takes the ranks that ``model``
leaves over, and a (1, 1) mesh in one process is valid -- where the
launch has no process group, that mesh starts a one-rank group, so that
the single-device and the multi-device code paths are the same.

:class:`Mesh` hands the trainer this rank's coordinates and the process
groups of its 'data' row and its 'model' column.
"""

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.parallel.distributed import backend_for, local_rank

AXES = ('data', 'model')


@dataclasses.dataclass
class MeshConfig:
  """Mesh sizing.

  Args:
    data: data-parallel ways (users axis). None = auto.
    model: model-parallel ways (item axis of embedding tables).
  """
  data: int | None = None
  model: int = 1


def mesh_shape(config, n):
  """``(data, model)`` of ``config`` over ``n`` ranks; AssertionError
  where the JAX ``make_mesh`` asserts."""
  model = max(1, config.model)
  if n % model:
    raise AssertionError(f'{n} devices not divisible by model={model}')
  data = config.data if config.data is not None else n // model
  if data * model != n:
    raise AssertionError(f'data({data}) x model({model}) != devices({n})')
  return data, model


class Mesh:
  """This rank's view of a ('data', 'model') mesh.

  Attributes:
    device_mesh: the ``DeviceMesh``.
    device: this rank's device (its card, or the CPU).
    shape: ``{'data': D, 'model': M}``.
    data_rank, model_rank: this rank's coordinates.
    data_group / model_group: the process groups of this rank's 'data'
      axis (the ranks that hold the same table rows and different users)
      and its 'model' axis (the ranks that hold the same users and
      different table rows).
  """

  def __init__(self, device_mesh, device):
    self.device_mesh = device_mesh
    self.device = device
    self.shape = dict(zip(AXES, device_mesh.mesh.shape))
    self.data_rank, self.model_rank = device_mesh.get_coordinate()
    self.data_group = device_mesh.get_group('data')
    self.model_group = device_mesh.get_group('model')

  def __repr__(self):
    return (f'Mesh(data={self.shape["data"]}, model={self.shape["model"]}, '
            f'rank=({self.data_rank}, {self.model_rank}), '
            f'device={self.device})')


def _one_rank_group(device):
  """A process group of this process alone (an in-process store)."""
  dist.init_process_group(backend_for(device), store=dist.HashStore(),
                          rank=0, world_size=1)


def make_mesh(config: MeshConfig | None = None, devices=None):
  """Build a 2-D ('data', 'model') mesh over the default group's ranks.

  Args:
    config: the sizing (None: every rank on 'data').
    devices (the port's reading of the JAX argument): the device this
      rank runs on, 'cuda' (its card, by default) or 'cpu'.

  Rank ``r`` sits at ``(r // model, r % model)``: the 'model' axis is
  the inner one, so its ranks (which exchange activations every step)
  are neighbours on a host, as the JAX mesh keeps 'model' within a host.
  Without a process group a mesh of one rank starts one; a larger mesh
  needs a launch that made the group (``torchrun --nproc_per_node=N``,
  or :func:`recoder_tpu_torch.parallel.initialize`).
  """
  config = config or MeshConfig()
  device = device_lib.resolve('cuda' if devices is None else devices)
  if not dist.is_initialized():
    wanted = (config.data or 1) * max(1, config.model)
    if wanted != 1:
      raise ValueError(
          f'a mesh of {wanted} ranks needs as many processes; launch with '
          f'torchrun --nproc_per_node={wanted} (or call '
          'recoder_tpu_torch.parallel.initialize) first')
    _one_rank_group(device)
  n = dist.get_world_size()
  data, model = mesh_shape(config, n)
  if device.type == 'cuda':
    if device.index is None:
      device = torch.device('cuda', local_rank())
    torch.cuda.set_device(device)
  mesh = init_device_mesh(device.type, (data, model), mesh_dim_names=AXES)
  return Mesh(mesh, device)

