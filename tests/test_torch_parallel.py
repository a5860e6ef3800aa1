"""The port's mesh package against ``recoder_tpu.parallel``, without a
process group: the mesh sizing and its assertions, ``host_user_shard``,
``initialize`` as a no-op, the partition specs of the models, the row
split of parameters and batches, a step partition's helpers, and the row
scatter's skipped slots (the mesh's sparse update).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu.models import MultVAE as JaxMultVAE
from recoder_tpu.parallel import MeshConfig as JaxMeshConfig
from recoder_tpu.parallel import host_user_shard as jax_host_user_shard
from recoder_tpu.parallel import make_mesh as jax_make_mesh
from recoder_tpu.parallel import param_pspecs as jax_param_pspecs
from recoder_tpu_torch import parallel
from recoder_tpu_torch.models import (DynamicAutoencoder, MatrixFactorization,
                                      MultVAE)
from recoder_tpu_torch.ops.row_scatter import row_scatter_plain
from recoder_tpu_torch.parallel import mesh as mesh_lib
from recoder_tpu_torch.parallel import sharding

CONFIGS = [(None, 1), (None, 2), (None, 8), (1, 1), (4, 2), (2, 4), (8, 1),
           (2, 2), (3, 2), (None, 3), (2, 3)]


@pytest.mark.parametrize('n', [1, 2, 4, 8])
@pytest.mark.parametrize('data,model', CONFIGS)
def test_mesh_sizing_matches_jax(n, data, model):
  devices = jax.devices()[:n]
  try:
    want = jax_make_mesh(JaxMeshConfig(data=data, model=model),
                         devices=devices).devices.shape
  except AssertionError:
    with pytest.raises(AssertionError):
      mesh_lib.mesh_shape(parallel.MeshConfig(data=data, model=model), n)
    return
  got = mesh_lib.mesh_shape(parallel.MeshConfig(data=data, model=model), n)
  assert got == want


def test_mesh_config_defaults_match_jax():
  assert (parallel.MeshConfig().data, parallel.MeshConfig().model) == (
      JaxMeshConfig().data, JaxMeshConfig().model)


@pytest.mark.parametrize('processes', [1, 2, 3, 4])
def test_host_user_shard_matches_jax(processes):
  for pid in range(processes):
    assert parallel.host_user_shard(103, pid, processes) == \
        jax_host_user_shard(103, pid, processes)
  bounds = [parallel.host_user_shard(103, pid, processes)
            for pid in range(processes)]
  assert bounds[0][0] == 0 and bounds[-1][1] == 103
  assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_host_user_shard_outside_a_group_is_everything():
  assert not dist.is_initialized()
  assert parallel.host_user_shard(103) == (0, 103)


def test_initialize_without_hints_is_a_no_op(monkeypatch):
  for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):
    monkeypatch.delenv(name, raising=False)
  parallel.initialize(device='cpu')
  assert not dist.is_initialized()
  monkeypatch.setenv('WORLD_SIZE', '1')
  parallel.initialize(device='cpu')
  assert not dist.is_initialized()


def test_a_mesh_of_several_ranks_needs_a_launch():
  assert not dist.is_initialized()
  with pytest.raises(ValueError, match='torchrun --nproc_per_node=2'):
    parallel.make_mesh(parallel.MeshConfig(model=2), devices='cpu')
  assert not dist.is_initialized()


def _jax_specs(model):
  return {k: tuple(v) for k, v in jax_param_pspecs(model).items()}


@pytest.mark.parametrize('make_port,make_jax,kw', [
    (DynamicAutoencoder, JaxDynAE, dict(hidden_layers=[64, 32])),
    (DynamicAutoencoder, JaxDynAE,
     dict(hidden_layers=[16, 8], is_constrained=True)),
    (MatrixFactorization, JaxMF, dict(embedding_size=8)),
    (MultVAE, JaxMultVAE, dict(hidden_dim=16, latent_dim=8))])
def test_param_pspecs_match_jax(make_port, make_jax, kw):
  port, jax_model = make_port(**kw), make_jax(**kw)
  port.init_model(num_items=300, num_users=50, seed=0)
  jax_model.init_model(num_items=300, num_users=50, seed=0)
  specs = sharding.param_pspecs(port)
  assert specs == _jax_specs(jax_model)
  assert set(specs) == set(port.params())
  if make_port is DynamicAutoencoder:
    assert specs['en_embedding'] == ('model', None)
    assert specs['de_bias'] == ('model',)
    assert specs['encode_w_1'] == (None, None)
  elif make_port is MultVAE:
    assert specs['de_embedding'] == ('model', None)
    assert specs['de_bias'] == ('model',)
    assert specs['w_mu'] == (None, None)
  else:
    assert specs['user_embedding'] == ('model', None)


@pytest.mark.parametrize('n', [1, 5, 256, 20224, 20225])
@pytest.mark.parametrize('parts', [1, 2, 3, 4])
def test_row_range_is_array_split(n, parts):
  want = [(s[0], s[-1] + 1) if len(s) else (None, None)
          for s in np.array_split(np.arange(n), parts)]
  for i in range(parts):
    lo, hi = sharding.row_range(n, parts, i)
    if want[i][0] is not None:
      assert (lo, hi) == want[i]
    else:
      assert lo == hi
  if n == 20224 and parts in (2, 4):  # ML-20M's padded catalog: even
    assert sharding.split_sizes(n, _FakeMesh(1, parts)) == [n // parts] * parts


class _FakeMesh:
  """A mesh's coordinates and sizes, without process groups."""

  def __init__(self, data, model, data_rank=0, model_rank=0):
    self.shape = {'data': data, 'model': model}
    self.data_rank, self.model_rank = data_rank, model_rank


@pytest.mark.parametrize('model_rank', [0, 1, 2])
def test_shard_params_keeps_each_ranks_rows(model_rank):
  ae = DynamicAutoencoder([8, 4])
  params = ae.init_model(num_items=600, seed=0)
  mesh = _FakeMesh(2, 3, data_rank=1, model_rank=model_rank)
  local = sharding.shard_params(params, ae, mesh)
  n = ae.num_items_padded
  lo, hi = sharding.row_range(n, 3, model_rank)
  for name, v in params.items():
    if sharding.param_pspecs(ae)[name][:1] == ('model',):
      assert local[name].shape[0] == hi - lo < n
      assert torch.equal(local[name], v[lo:hi])
    else:
      assert local[name] is v
  # the arrays of a checkpoint split the same way
  arrays = {k: v.detach().numpy() for k, v in params.items()}
  split = sharding.shard_params(arrays, ae, mesh)
  for name in arrays:
    np.testing.assert_array_equal(split[name], local[name].detach().numpy())


@pytest.mark.parametrize('data_rank', [0, 1, 2])
def test_shard_batch_keeps_the_ranks_users(data_rank):
  B, W = 10, 7
  batch = {'users': torch.arange(B), 'slab': torch.rand(B, W),
           'col_mask': torch.ones(W), 'num_users': 9.0, 'items': None}
  mesh = _FakeMesh(3, 1, data_rank=data_rank)
  specs = sharding.batch_pspecs(batch)
  assert specs == {'users': ('data',), 'slab': ('data',), 'col_mask': (),
                   'num_users': (), 'items': None}
  lo, hi = sharding.row_range(B, 3, data_rank)
  out = sharding.shard_batch(batch, mesh)
  assert out['first_row'] == lo
  assert torch.equal(out['users'], torch.arange(lo, hi))
  assert torch.equal(out['slab'], batch['slab'][lo:hi])
  assert out['col_mask'] is batch['col_mask'] and out['num_users'] == 9.0


def test_partition_takes_the_ranks_rows_of_a_union():
  mf = MatrixFactorization(4)
  mf.init_model(num_items=500, num_users=30, seed=0)
  n = mf.num_items_padded  # 512
  part = sharding.Partition(_FakeMesh(2, 2, data_rank=1, model_rank=1), mf,
                            num_rows=5)
  assert (part.lo, part.hi) == (3, 5) and part.draw_rows == (3, 5, 5)
  assert part.ranges['item'] == (n // 2, n)
  table = torch.arange(n // 2, dtype=torch.float32)[:, None].repeat(1, 3)
  ids = torch.tensor([3, 255, 256, 300, 511])
  rows = part.take('item_embedding', table, ids)
  np.testing.assert_array_equal(rows[:, 0].numpy(), [0, 0, 0, 44, 255])
  assert torch.equal(part.localize('item_embedding', ids),
                     torch.tensor([-1, -1, 0, 44, 255]))
  assert torch.equal(part.owned('item', ids),
                     torch.tensor([False, False, True, True, True]))
  assert part.total('user_embedding') == mf.num_users_padded
  x = torch.arange(2 * n).view(2, n)
  assert torch.equal(part.columns(x), x[:, n // 2:])
  assert torch.equal(part.row_mask(4, 'cpu'), torch.tensor([1.0, 0.0]))
  # one 'model' rank: the tables are whole
  whole = sharding.Partition(_FakeMesh(2, 1, data_rank=0), mf, num_rows=5)
  assert whole.owned('item_embedding', ids) is None
  assert torch.equal(whole.localize('item_embedding', ids), ids)
  assert whole.columns(x) is x


def test_row_scatter_skips_the_slots_of_id_minus_one():
  table = torch.arange(12, dtype=torch.float32).view(6, 2)
  moments = table.clone().to(torch.bfloat16)
  ids = torch.tensor([4, -1, 0, -1])
  rows = torch.full((4, 2), -1.0)
  want = table.clone()
  want[4] = want[0] = -1.0
  row_scatter_plain((table, moments), ids, (rows, rows.to(torch.bfloat16)))
  assert torch.equal(table, want)
  assert torch.equal(moments, want.to(torch.bfloat16))
  with pytest.raises(IndexError):
    row_scatter_plain((table,), torch.tensor([-2]), (rows[:1],))
