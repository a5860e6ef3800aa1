"""The bf16 working copies of ``optim.Bf16Adam`` on the CPU (the plain
twin): a float32 weight that a training step's bf16 product reads whole
takes its operand from a bf16 copy that the Adam step writes, and leaves
its bf16 gradient there. Held bitwise against the cast path (the products
of ``p.to(bf16)``, whose gradient reaches ``p`` upcast to float32) and an
Adam step written here with torch ops; the copy against ``p.to(bf16)``
after every step and after a state loaded in place; and which parameters
take the route (``ops/adam.COPY_SHARE``): a Mult-VAE's weights, an
autoencoder's encoder table, a tied autoencoder's one table (its
decoder's float32 gradient and the copy's bf16 one added as autograd
adds them), and none under float32 compute, in a sparse step, a union
step or on a mesh."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch import optim
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MultVAE
from recoder_tpu_torch.models.base import noised_input
from recoder_tpu_torch.ops import adam
from recoder_tpu_torch.ops.gather_matmul import working_copies
from recoder_tpu_torch.parallel import MeshConfig, make_mesh

BF = torch.bfloat16
STEPS = 6
LR, WD = 1e-2, 2e-5


def _matrix(seed=0, users=90, items=300):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix((rng.random((users, items)) < 0.05).astype(np.float32))


def _model(kind):
  if kind == 'multvae':
    return MultVAE(hidden_dim=24, latent_dim=8, compute_dtype='bfloat16')
  if kind == 'tied':
    return DynamicAutoencoder([24], is_constrained=True,
                              compute_dtype='bfloat16')
  return DynamicAutoencoder([24, 12], compute_dtype='bfloat16')


def _reference_adam(params, states, step):
  """One Adam step over float32 params with bf16 moments, each operation
  of kernels/adam.cu's header as a torch op (divisions by tensors, as the
  kernel divides), the gradient the float32 one on ``p.grad``."""
  b1, b2, eps = 0.9, 0.999, 1e-8
  f32 = np.float32
  bc1 = f32(1.0) - f32(b1) ** f32(step)
  bc2 = f32(1.0) - f32(b2) ** f32(step)
  lr_bc1 = float(f32(LR) / bc1)
  sqrt_bc2 = torch.tensor(float(np.sqrt(bc2)))
  with torch.no_grad():
    for name, p in params.items():
      m, v = states[name]
      wd = 0.0 if 'bias' in name else float(f32(WD))
      g = p.grad.float() + wd * p
      m1 = float(f32(b1)) * m.float() + float(f32(1 - b1)) * g
      v1 = float(f32(b2)) * v.float() + (float(f32(1 - b2)) * g) * g
      denom = torch.sqrt(v1) / sqrt_bc2 + float(f32(eps))
      p.copy_(p - (lr_bc1 * m1) / denom)
      m.copy_(m1)
      v.copy_(v1)


def _loss(kind, model, x, gen, step):
  """A training forward and a loss of it (Mult-VAE: the multinomial NLL
  plus its KL term; the autoencoder: squared error), with draws from
  ``gen`` passed in, so that two models draw the same."""
  if kind == 'multvae':
    keep = torch.rand(x.shape, generator=gen) >= 0.5
    eps = torch.randn((x.shape[0], model.latent_dim), generator=gen)
    scores, kl = model(x, training=True, keep_mask=keep, eps=eps,
                       step=torch.tensor(step))
    return -(torch.log_softmax(scores.float(), 1) * x).sum() + kl.sum()
  return ((model(x, training=True).float() - x) ** 2).sum()


@pytest.mark.parametrize('kind', ['multvae', 'autoencoder', 'tied'])
def test_steps_match_the_cast_path_and_a_torch_op_adam(kind):
  """Six steps through the route (the products read the copies, Adam's
  plain twin reads the bf16 gradients and writes the copies) and through
  the cast path with the Adam step above: every parameter, moment and
  loss bitwise, and each copy bitwise ``p.to(bf16)`` after each step. A
  tied table's second read in a step (its decoder's) takes
  ``p.to(bf16)``: its float32 gradient and the copy's are added in every
  step."""
  m = _matrix()
  models = [_model(kind) for _ in range(2)]
  for model in models:
    model.init_model(num_items=m.shape[1], seed=5)
  route, ref = models
  named = route.params()
  opt = optim.make_optimizer('adam', named, LR, WD, state_dtype='bfloat16')
  assert isinstance(opt, optim.Bf16Adam)
  states = {k: (torch.zeros_like(p, dtype=BF), torch.zeros_like(p, dtype=BF))
            for k, p in ref.params().items()}
  gens = [torch.Generator().manual_seed(11) for _ in range(2)]
  dense = torch.zeros(m.shape[0], route.num_items_padded)
  dense[:, :m.shape[1]] = torch.from_numpy(m.toarray())
  for step in range(1, STEPS + 1):
    x = dense[(step * 16) % 80:(step * 16) % 80 + 16].to(BF)
    opt.zero_grad(set_to_none=True)
    with working_copies(opt.working_copy):
      got = _loss(kind, route, x, gens[0], step)
    got.backward()
    # (the routed weights' gradients are on their copies, bf16; a tied
    # table's second read leaves its gradient on the table, float32)
    assert all((p.grad is not None) == (kind == 'tied')
               for p in opt._copies)
    assert all(c.grad.dtype == BF for c in opt.copies())
    opt.step()
    ref.zero_grad(set_to_none=True)
    want = _loss(kind, ref, x, gens[1], step)
    want.backward()
    _reference_adam(ref.params(), states, step)
    assert torch.equal(got, want)
    for name, p in route.params().items():
      q = ref.params()[name]
      assert torch.equal(p, q), name
      st = opt.state[p]
      assert torch.equal(st['exp_avg'], states[name][0]), name
      assert torch.equal(st['exp_avg_sq'], states[name][1]), name
    for p, copy in opt._copies.items():
      assert torch.equal(copy, p.to(BF))
  # every weight's product read its copy; no bias has one
  assert {id(p) for p in opt._copies} == {
      id(p) for k, p in named.items() if 'bias' not in k}


def test_a_state_loaded_between_calls_reaches_the_copies(monkeypatch):
  """A ``load_state_dict`` between two ``train`` calls writes the
  parameters in place: the next call writes the copies anew, so the
  training goes on from the loaded state as the cast path does, bit for
  bit; ``reset_training_state`` writes them anew too."""
  data = RecommendationDataset(_matrix(1))
  kw = dict(batch_size=16, lr=1e-3, negative_sampling=False,
            shuffle='users', num_epochs=1, iters_per_epoch=2)
  runs = []
  for route in (True, False):
    with monkeypatch.context() as mp:
      if not route:
        mp.setattr(optim.Bf16Adam, 'working_copy', lambda self, p: None)
      tr = Recoder(MultVAE(24, 8, compute_dtype='bfloat16'),
                   optimizer_type='adam', loss='logloss', device='cpu',
                   opt_state_dtype='bfloat16', seed=3)
      tr.train(data, **kw)
      other = MultVAE(24, 8, compute_dtype='bfloat16')
      other.init_model(num_items=tr.model.num_items, seed=9)
      tr.model.load_state_dict(other.state_dict())
      if route:
        assert len(tr.optimizer.copies()) == 5
        assert not any(torch.equal(w, p.to(BF))
                       for p, w in tr.optimizer._copies.items())
      tr.train(data, **kw)  # (the rest of the epoch's first call)
      runs.append(tr)
  a, b = runs
  assert a.last_epoch_losses == b.last_epoch_losses
  for (name, p), q in zip(a.model.params().items(), b.model.params().values()):
    assert torch.equal(p, q), name
    for key in ('exp_avg', 'exp_avg_sq'):
      assert torch.equal(a.optimizer.state[p][key],
                         b.optimizer.state[q][key]), (name, key)
  for p, w in a.optimizer._copies.items():
    assert torch.equal(w, p.to(BF))
  a.reset_training_state()
  for p, w in a.optimizer._copies.items():
    assert torch.equal(w, p.to(BF))


def _train(model, route, monkeypatch, seed=3, **train_kw):
  """One epoch of ``Recoder.train`` with bf16 moments; ``route`` False:
  no parameter gets a working copy (the cast path)."""
  with monkeypatch.context() as mp:
    if not route:
      mp.setattr(optim.Bf16Adam, 'working_copy', lambda self, p: None)
    adam.COPY_SHARE['adam_bf16'] = None
    loss = 'logloss' if isinstance(model, MultVAE) else 'mse'
    tr = Recoder(model, optimizer_type='adam', loss=loss, device='cpu',
                 opt_state_dtype='bfloat16', seed=seed)
    kw = dict(batch_size=16, lr=1e-3, weight_decay=2e-5, shuffle='users',
              negative_sampling=isinstance(model, DynamicAutoencoder),
              num_epochs=1)
    tr.train(RecommendationDataset(_matrix(2)), **{**kw, **train_kw})
  return tr, adam.COPY_SHARE['adam_bf16']


TRAINER_CASES = {
    # (model, train arguments, the share of the dense parameter elements
    # that have a copy)
    'multvae': (lambda: MultVAE(24, 8, compute_dtype='bfloat16'), {},
                (0.95, 1.0)),
    'ae_full_decode': (lambda: DynamicAutoencoder(
        [24, 12], compute_dtype='bfloat16'), {'full_decode': True},
                       (0.45, 0.55)),
    'ae_union': (lambda: DynamicAutoencoder([24], compute_dtype='bfloat16'),
                 {'full_decode': False}, (0.0, 0.0)),
    'ae_sparse': (lambda: DynamicAutoencoder([24], compute_dtype='bfloat16',
                                             sparse=True), {}, (0.0, 0.0)),
    # (the table: its encoder's read through the copy, its decoder's in
    # float32 through the fused decode-loss pair)
    'ae_tied': (lambda: DynamicAutoencoder([24], is_constrained=True,
                                           compute_dtype='bfloat16'),
                {'full_decode': True}, (0.9, 1.0)),
    'multvae_float32': (lambda: MultVAE(24, 8), {}, (0.0, 0.0)),
}


@pytest.mark.parametrize('case', sorted(TRAINER_CASES))
def test_the_trainer_takes_the_route_where_it_observes_it(case,
                                                          monkeypatch):
  """``Recoder.train`` with and without the copies: the same losses,
  parameters and moments, bit for bit; the copies equal ``p.to(bf16)``;
  ``COPY_SHARE`` says which share took the route: every weight of a
  Mult-VAE, an autoencoder's encoder table (its decoder table goes to the
  fused decode-loss pair in float32), a tied autoencoder's table (read
  both ways: the two gradients added in the step), nothing where no
  product reads a float32 weight whole."""
  make, train_kw, (lo, hi) = TRAINER_CASES[case]
  a, share = _train(make(), True, monkeypatch, **train_kw)
  b, _ = _train(make(), False, monkeypatch, **train_kw)
  assert lo <= share <= hi, share
  assert a.last_epoch_losses == b.last_epoch_losses
  for (name, p), q in zip(a.model.params().items(), b.model.params().values()):
    assert torch.equal(p, q), name
    sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
    for key in ('exp_avg', 'exp_avg_sq'):
      if key in sa:
        assert torch.equal(sa[key], sb[key]), (name, key)
  for p, copy in a.optimizer._copies.items():
    assert torch.equal(copy, p.to(BF))
  if hi == 0.0:
    assert not a.optimizer.copies()


def test_a_mesh_step_takes_no_copy(tmp_path):
  """On a mesh (one gloo rank here) the gradients are added over 'data'
  in float32: no parameter gets a copy."""
  torch.distributed.init_process_group(
      'gloo', init_method=f'file://{os.path.join(tmp_path, "store")}',
      rank=0, world_size=1)
  try:
    mesh = make_mesh(MeshConfig(1, 1), devices='cpu')
    tr = Recoder(MultVAE(16, 8, compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logloss', mesh=mesh,
                 device='cpu', opt_state_dtype='bfloat16')
    adam.COPY_SHARE['adam_bf16'] = None
    tr.train(RecommendationDataset(_matrix()), batch_size=16, lr=1e-3,
             negative_sampling=False, shuffle='users', num_epochs=1)
    assert adam.COPY_SHARE['adam_bf16'] == 0.0
    assert isinstance(tr.optimizer, optim.Bf16Adam)
    assert not tr.optimizer.copies()
  finally:
    torch.distributed.destroy_process_group()


def test_the_inference_paths_read_no_copy():
  """Outside a training step's block, and without grad inside it, the
  products read ``p.to(bf16)``: no copy is made."""
  m = _matrix()
  model = _model('multvae')
  model.init_model(num_items=m.shape[1], seed=5)
  opt = optim.make_optimizer('adam', model.params(), LR, WD,
                             state_dtype='bfloat16')
  x = torch.zeros(4, model.num_items_padded, dtype=BF)
  model(x)
  with working_copies(opt.working_copy), torch.no_grad():
    model(x, training=True, step=torch.tensor(1))
  assert not opt.copies()
  with working_copies(opt.working_copy):
    noised_input(x, 0.0)
    model(x, training=True, step=torch.tensor(1))
  assert len(opt.copies()) == 5


@pytest.mark.parametrize('before', [True, (True, True), (False, False)])
def test_weight_gradients_sum_in_float32_and_restore_the_setting(before):
  """The weight gradient's bf16-output GEMM runs with cuBLAS's
  reduced-precision (bf16) reduction of split-K parts disallowed, and the
  setting is the caller's again after, the split-K half included."""
  from recoder_tpu_torch.ops import gather_matmul as gm
  matmul = torch.backends.cuda.matmul
  old = (matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_bf16_reduced_precision_reduction_split_k)
  try:
    matmul.allow_bf16_reduced_precision_reduction = before
    want = (matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction_split_k)
    with gm._float32_sums():
      assert matmul.allow_bf16_reduced_precision_reduction is False
      assert (matmul.allow_bf16_reduced_precision_reduction_split_k
              == want[1])
    assert (matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction_split_k) == want
  finally:
    matmul.allow_bf16_reduced_precision_reduction = old
