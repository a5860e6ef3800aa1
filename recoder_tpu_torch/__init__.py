"""recoder-tpu on PyTorch and CUDA: the port of ``recoder_tpu`` to an
NVIDIA Hopper GPU.

The package keeps the module layout and names of ``recoder_tpu`` so
that each module's counterpart is easy to find, and is held against it
by the differential tests in ``tests/test_torch_*.py``. It imports
``torch`` and never ``jax``, and never imports ``recoder_tpu`` (whose
package ``__init__`` imports jax).

Ported so far -- the DynamicAutoencoder training paths (full-catalog
decode from a dense or a bit-packed slab or a per-step scatter, item
union, sparse tables; mega-batches and random extra negatives on each;
float32, bench.py's bf16 compute with bf16 Adam moments, and bf16
parameter storage with bf16 or float32 moments, sparse tables too), training
against a target matrix (the host loader, and dual CSRs in 'blocks'
mode) and the validation loss inside ``train``, the trainer for any
model written to the ``FactorizationModel`` contract (with the aux-loss
hook and sparse tables through ``apply_gathered``), MatrixFactorization
(through the fused decode-loss kernels), Mult-VAE, EASE, the Mult-VAE
protocol, the serving path they need (chunked scoring of large catalogs,
the asynchronous evaluator, the top-k in ``lax.top_k``'s order), iALS,
and the serving surface (the CLI's train, evaluate, recommend and serve,
the embeddings indexes with the C++ ANN forest, the similarity
recommender and the preprocessing split), every model on a
('data', 'model') mesh of processes, the async directory checkpoint and
the dataset and scale scripts:

  recoder_tpu/utils.py                  -> recoder_tpu_torch.utils
  recoder_tpu/data/dataset.py           -> recoder_tpu_torch.data.dataset
  recoder_tpu/data/loader.py            -> recoder_tpu_torch.data.loader
      (unpadded batches: the static-shape padding of the JAX loader and
      recoder_tpu/data/buckets.py is not ported; collate_fn: each
      mega-batch collated whole and yielded once)
  recoder_tpu/data/device_pipeline.py   -> recoder_tpu_torch.data.device_pipeline
      (build_batch's 'blocks' branch, _csr_range and _unique_union ->
      DeviceDataSource.union_batch: static widths and windows, exact
      maxima, so the overflow rebuild is not ported)
      (target_matrix: _init_target_side, _build_target_side -> the
      target side of DeviceDataSource.union_batch)
      (slices_per_mega, the random-negative draw and build_batch's
      per-step triplet scatter -> union_batch, build_union_batch ('users'
      mode), fd_batch, _static_scatter_fd_batch and _scatter_fd_batch)
      (the packed tier's _unpack_rows and row fetch)
      -> recoder_tpu_torch.ops.packed_rows
         + recoder_tpu_torch/kernels/packed_rows.cu
  recoder_tpu/checkpoint.py             -> recoder_tpu_torch.checkpoint
  recoder_tpu/checkpoint_orbax.py       -> recoder_tpu_torch.checkpoint_orbax
      (DCP format: torch.distributed.checkpoint, the same directory,
      swap and async contract)
  (new) weights bridge                  -> recoder_tpu_torch.convert
  recoder_tpu/models/base.py            -> recoder_tpu_torch.models.base
      (params_dtype, and model.py's _adapt_array cast -> adapt_array)
  recoder_tpu/models/autoencoder.py     -> recoder_tpu_torch.models.autoencoder
  recoder_tpu/models/matrix_factorization.py
      -> recoder_tpu_torch.models.matrix_factorization
  recoder_tpu/models/multvae.py         -> recoder_tpu_torch.models.multvae
  recoder_tpu/models/ease.py            -> recoder_tpu_torch.models.ease
      (the Gram on the device in user chunks, a cuSOLVER Cholesky for
      the one-device Newton-Schulz inverse, which is not ported; the
      mesh fit's row-sharded Newton-Schulz -> newton_inverse_rows)
  recoder_tpu/protocols.py              -> recoder_tpu_torch.protocols
  recoder_tpu/ops/losses.py             -> recoder_tpu_torch.ops.losses
  recoder_tpu/ops/gather_matmul.py      -> recoder_tpu_torch.ops.gather_matmul
  recoder_tpu/ops/topk.py               -> recoder_tpu_torch.ops.topk
      (by function: lax.top_k's result and order; the count-certified
      TPU fast path is not ported)
  recoder_tpu/experiments/pallas_loss.py
      -> recoder_tpu_torch.ops.fused_decode_loss
         + recoder_tpu_torch/kernels/fused_decode_loss.cu
  recoder_tpu/optim.py                  -> recoder_tpu_torch.optim
      (fold_dual_union -> recoder_tpu_torch.optim.fold_dual_union)
      (Optimizer('adam', state_dtype='bfloat16'), and 'adam' over
      params_dtype='bfloat16' parameters with either moment dtype)
      -> recoder_tpu_torch.optim.Bf16Adam + recoder_tpu_torch.ops.adam
         + recoder_tpu_torch/kernels/adam.cu
      (the other kinds over bf16 parameters: update's float32 anchoring)
      -> recoder_tpu_torch.optim.Float32AnchoredOptimizer
      (SparseRowAdam over bf16 tables and with state_dtype='bfloat16')
      -> recoder_tpu_torch.optim.SparseRowAdam + the row scatter over
         mixed element sizes
  recoder_tpu/model.py                  -> recoder_tpu_torch.model
      (fused_steps_per_call, the lax.scan of _get_fused_step_fn:
      captured CUDA graphs of the full-decode and every 'blocks' step)
      (_stage_batch, _to_device, _device_batch_iter: the host loader's
      staging; _get_val_loss_fn's dense dispatch and _validate ->
      Recoder._validate; the eval_freq hooks -> Recoder._validation_log)
      (_forward_loss's has_aux hook and input_users, _sparse_step_math's
      apply_gathered route and its pad-user redirect, and its
      full-catalog form: whole tables, update_rows(ids=None))
      (_resolve_eval_chunk, _get_recommend_fn's chunked branch,
      _get_val_loss_fn's dispatch and _chunked_val_loss ->
      Recoder._chunked_top_k and Recoder._chunked_val_loss;
      recommend_async)
  recoder_tpu/progress.py               -> recoder_tpu_torch.progress
  recoder_tpu/metrics.py                -> recoder_tpu_torch.metrics
  recoder_tpu/recommender.py            -> recoder_tpu_torch.recommender
      (SimilarityRecommender: the same host numpy code)
  recoder_tpu/embedding.py              -> recoder_tpu_torch.embedding
      (BruteForceEmbeddingsIndex: the normalized table on a device, a
      batch's [m, N] product + ops/topk.top_k, one host read)
  recoder_tpu/native/ann.py             -> recoder_tpu_torch.native.ann
  recoder_tpu/native/ann_index.cpp      -> recoder_tpu_torch/native/ann_index.cpp
      (a byte-for-byte copy: host C++, built with g++ into build/native/)
  recoder_tpu/preprocessing.py          -> recoder_tpu_torch.preprocessing
  recoder_tpu/cli.py                    -> recoder_tpu_torch.cli
      (the same commands and config schema, plus "device")
  scripts/build_embeddings.py           -> scripts/torch_build_embeddings.py
  scripts/**                            -> scripts/**/torch_*.py
      (scripts/{ml-20m,msd,msd-big}/torch_{preprocess,train,test}.py over
      scripts/torch_pipelines.py; scripts/torch_stress_scale.py)
  tools/bench_serving.py                -> tools/torch_bench_serving.py
  recoder_tpu/ops/spd.py                -> recoder_tpu_torch.ops.spd
                                           + recoder_tpu_torch/kernels/spd_solve.cu
  recoder_tpu/models/ials.py            -> recoder_tpu_torch.models.ials
      (fit(mesh=, factor_sharding=): the batch-sharded row solves and
      _user_sharded_fns' owner-slice slabs, over torch.distributed)
  recoder_tpu/parallel/{mesh,sharding,distributed}.py
      -> recoder_tpu_torch.parallel (torch.distributed: one process a
         card, a DeviceMesh of ('data', 'model'); the collectives the
         JAX SPMD partitioner places are placed by hand:
         recoder_tpu_torch.parallel.collectives and sharding.Partition)
      (model.py's mesh hooks: placement after init and load, the step's
      share and collectives, scoring gathered, checkpoints gathered on
      rank 0 -> Recoder(mesh=...), DynamicAutoencoder,
      MatrixFactorization, MultVAE and custom losses;
      device_pipeline.py's 'data'-sharded tables -> table_sharding;
      IALS.fit(mesh=) and EASE.fit(mesh=))
  (new) the entry points' device       -> recoder_tpu_torch.device
  bench.py synthesize / synthesize_ml20m -> recoder_tpu_torch.data.synthetic
"""

__version__ = '0.2.0'
