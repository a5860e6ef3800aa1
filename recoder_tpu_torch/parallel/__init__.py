"""Multi-GPU execution: a ('data', 'model') mesh over torch.distributed.

Port of ``recoder_tpu/parallel``: data-parallel users over the 'data'
axis and item-axis model parallelism over 'model' -- the embedding tables
row-split, each rank holding one contiguous row range. One process runs
each card (``torchrun --nproc_per_node=N``); every rank builds the same
global batch from the same seed and computes its share of the step, and
the trainer adds the shares over the mesh's process groups (NCCL on the
card, gloo on the CPU).
"""

from recoder_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from recoder_tpu_torch.parallel.sharding import (batch_pspecs, param_pspecs,
                                                 shard_batch, shard_params)

__all__ = ['MeshConfig', 'make_mesh', 'param_pspecs', 'batch_pspecs',
           'shard_params', 'shard_batch']

from recoder_tpu_torch.parallel.distributed import host_user_shard, initialize  # noqa: E402,F401

__all__ += ['initialize', 'host_user_shard']
