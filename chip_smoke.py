"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX, of the JAX package or of bench.py: the
benchmark's data comes from ``recoder_tpu_torch/data/synthetic.py``.
Phases, each of which raises on failure:

  1. device  -- requires CUDA; prints the card's name and power limit.
  2. build   -- compiles the port's CUDA kernels from this checkout;
                the ptxas report of each kernel, and the tensor-core
                instructions (HMMA / HGMMA) of each decode-loss kernel
                counted in the library's SASS (cuobjdump -sass): a
                decode-loss kernel without any (a wgmma kernel of the
                bf16 route without HGMMA), or with register spills,
                fails; the SPD-solve kernel's registers, shared memory
                and resident blocks an SM at d = 128 and 256, and the
                Adam kernel's registers: a spill there fails too.
  3. kernels -- the fused decode-loss kernels (forward and backward)
                against their plain PyTorch version on the card, for
                'mse' (c=0, c=3) and 'logistic', at a ragged shape, the
                training shape and an odd union width, with float32 and
                bfloat16 targets (the bfloat16 run bitwise equal to the
                float32 one); device and CUDA-event times of kernel and
                plain, taken in turns, beside each kernel's bound.
  4. slice   -- the training path at the full width of the ML-20M-shaped
                configuration (bench.py's synthetic CSR, from the port's
                copy of its generator: 116,677 users x 20,108 items):
                DynamicAutoencoder[200], MSE confidence 3, Adam, batch
                500, negative sampling, block shuffle, float32; one
                epoch through the kernel, steady epochs and a profile of
                steady steps, one eager dispatch a step
                (fused_steps_per_call=1: the launch counters count every
                step; phase 20 runs the captured form); then recommend
                and a checkpoint round trip.
  5. paths   -- 20 training steps on the fixture through the kernel and
                through the plain decode + loss, from the same init,
                permutation and noise: the losses must agree.
  6. quality -- the tests/test_model.py protocol on the fixture
                (logloss, 30 epochs, float32) must reach the pinned
                Recall@20 / Recall@50 / NDCG@100, and a checkpoint
                reload must give the same metrics; it runs captured
                (fused_steps_per_call='auto'), as do phases 16 and 19,
                and prints its dispatch.
  7. spd kernel -- the batched SPD-solve kernel against the blocked
                recursion on the card at ragged shapes (B in {1, 37},
                d in {1, 7, 15, 16, 17, 33, 64, 127, 128, 129, 130, 200,
                255, 256}: the edges of its 16-column panels among them)
                and at the iALS shape (B = 16,384, d = 128, systems built
                as iALS builds them): max abs error and residual, bitwise
                independence of batch position; one indefinite system
                among 37 is NaN and leaves the other 36 bitwise
                unchanged; median times of the kernel, the blocked
                recursion, cholesky_ex + cholesky_solve and
                torch.linalg.solve, and the kernel's time over 10
                launches back to back.
  8. ials slice -- iALS at the full width of tools/bench_ials.py on the
                same ML-20M-shaped CSR (d=128, alpha 10, lam 3e-3, 8
                sweeps, seed 0): the objective (float64, on the card)
                falls, per-sweep and fit
                seconds, one kernel launch per chunk per half-sweep,
                fold-in of 500 training users is bitwise their stored
                factors, recommend(k=100) is valid, and a save -> load
                round trip gives identical recommendations.
  9. ials quality -- the tests/test_ials.py fixture protocol (d=4, alpha
                30, lam 0.01, 8 sweeps, seed 0) through the kernel must
                reach Recall@20 > 0.080 and NDCG@100 > 0.120, with
                identical metrics after a reload; phase 8's objective
                against the library's host version (rtol 1e-9); the same
                fit through the blocked recursion on the card, for the
                distance between the two.
 10. row-scatter kernel -- the kernel against index_copy_ on the card,
                bitwise, at N in {1, 37, 41,216} x d in {1, 3, 7, 128,
                200, 256, 1000} x W in {0, 1, 37}, on a misaligned column
                slice (data drawn on the card), with a sentinel-duplicate
                tail, and at the MSD
                shape (three [41,216, 200] tables, the ids of one MSD
                block union); untouched rows and data pointers unchanged;
                device and CUDA-event times of the kernel and of
                index_copy_ x3, the device times each from a cold L2.
 11. sparse slice -- the sparse-table path at the full width of the MSD
                configuration (bench.py --dataset msd --sparse: the
                synthetic 571,355 x 41,140 CSR, DynamicAutoencoder[200]
                tanh, noise 0.5, sparse=True, logloss, Adam lr 1e-3,
                weight decay 2e-5, batch 500, negative sampling, block
                shuffle, float32): one epoch of 1,143 steps with 2
                row-scatter launches each, then a steady epoch
                (msd_user_batches_per_sec), a profile of steady steps,
                recommend and a checkpoint round trip.
 12. union paths -- 20 steps on the fixture from one init and order,
                noise off: full decode, the dense union step through the
                fused kernel on union shapes, the same through the plain
                MSELoss, and the sparse step; the fused decode-loss
                kernel timed at an MSD union shape.
 13. sparse quality -- the sparse row of tests/test_model.py on the
                fixture (logloss, 30 epochs, 'users' shuffle, float32)
                must reach the pinned metrics, identical after a reload
                into a sparse and into a dense model.
 14. bf16 kernels -- the bf16 variant of the decode-loss kernels against
                its plain version ('mse' c=0, c=3, 'logistic'; loss rtol
                1e-2, gradients within 2e-2 in relative Frobenius norm),
                each case run twice (bitwise equal): the ragged shape and
                an MSD union width [500, 200, 18,117] on the mma.sync
                kernels, the ML-20M shape and an aligned [480, 200,
                18,120] on the wgmma kernels (each route's counters
                checked); both sets timed in turns at the ML-20M shape;
                and the
                fused bf16-moment Adam kernel against its plain version for 5
                steps over the ML-20M parameter set and a ragged length
                (m and v within 1 bf16 ulp, p within 2 float32 ulps);
                device times of kernel and plain in turns, each beside its
                bound (bf16 tensor-core peak for the products), and
                torch.optim.Adam(fused=True) on float32 state (another
                function) beside the Adam kernel.
 15. bf16 slice -- phase 4 at bench.py's ML-20M default numerics
                (compute_dtype='bfloat16', opt_state_dtype='bfloat16'):
                one epoch, steady epochs, a profile of steady steps beside
                phase 4's float32 figures, recommend and a checkpoint
                round trip; the wgmma decode-loss kernels and the Adam
                kernel launched once a step. Then phase 5 at bf16: 20
                'mse' steps through the kernels and through the plain
                decode + loss (rtol 1e-2).
 16. bf16 quality -- the tests/test_model.py bf16 rows (bf16 compute;
                bf16 compute and bf16 moments; logloss, 30 epochs) must
                reach the pinned metrics, and a reload into a model built
                without compute_dtype comes back bf16 with the same
                metrics (within 1e-6).
 17. packed kernel -- the packed-slab row fetch with bit unpack against
                its plain version on the card, bitwise, at B in {1, 37,
                500} x W/32 in {1, 5, 33, 644, 1288} words, a contiguous
                fetch at the last block and a gather with pad users, bit
                31 set in every fourth word; its ptxas registers, spills
                and stack frame (a spill fails); device times of kernel
                and plain from a cold L2 at [500, 1,288 words] beside the
                bytes bound.
 18. msd dense -- bench.py's MSD default through the port at the full
                width (the synthetic 571,355 x 41,140 CSR,
                DynamicAutoencoder[200] tanh, noise 0.5, dense tables,
                logloss, bf16 compute and bf16 moments, Adam lr 1e-3,
                weight decay 2e-5, batch 500, negative sampling, block
                shuffle, slab_cache='auto', full_decode='auto'): full
                decode chosen, 'auto' on the 1-bit tier (the bf16 slab
                exceeds half the card), the unpack kernel and the Adam
                kernel once a step; one epoch, a steady epoch, a profile
                of steady steps, all eager as in phase 4. Then 20 fixture
                steps from the packed and from the dense tier with one
                seed, in both shuffles: the losses and parameters bitwise
                equal.
 19. packed quality -- the tests/test_model.py packed row (bf16 compute,
                bf16 moments, slab_cache='packed', logloss, 30 epochs)
                must reach the pinned metrics on the packed tier.
 20. captured steps -- on the fixture (batch 480: 21 steps an epoch, a
                tail block with 80 pad users), for every combination of
                {float32, bf16 compute + bf16 moments} x {dense, packed
                slab} x {'blocks', 'users'}: 3 epochs with noise 0.5 and
                an lr milestone at 16 steps a graph against one eager
                step a dispatch, and a resume from a checkpoint written
                10 steps into epoch 1: losses, parameters and moments
                bitwise equal; the float32 decode-loss kernels once a
                step in a profile of replays. Then phase 15's and phase
                18's trainers (bench.py's two full-decode cells) at
                fused_steps_per_call='auto' (captured) and 1 (eager) in
                turns (two rounds at ML-20M, one at MSD): the first
                captured epoch, steady rates, device ms
                and launches a profiled step, the device-idle share,
                host dispatches an epoch, peak device memory, and each
                hand kernel of the cell once a step, by name, in a
                profile of 64 replayed steps (the Python launch counters
                do not see inside a graph): at ML-20M the wgmma
                decode-loss kernels.
 21. validation -- on a seeded 80/20 split of each user's interactions of
                the ML-20M-shaped CSR: bench.py's ML-20M default
                (captured) trains 2 epochs on the 80% input with
                val_dataset = RecommendationDataset(held-out, input),
                eval_freq=1, Recall@20/50 and NDCG@100 at
                eval_num_recommendations=100 on 10,000 users, and 2 epochs
                without validation: bitwise equal, no graph captured
                again after a validation, one no-E0 bf16 forward launch a
                validation batch (of the route its union width takes)
                and no backward; the validation seconds
                and val batches/s an epoch, a profiled validation (the
                device-idle share, the forward kernel once a batch), the
                val loss through the kernel against the plain decode +
                loss (rtol 1e-2), and the captured training rate with and
                without eval_freq, one epoch each in turns.
 22. target training -- RecommendationDataset(input, held-out), 'mse'
                confidence 3, float32 and bf16 (with bf16 moments), through
                the host loader ('users') and the dual CSRs ('blocks'):
                one epoch with the decode-loss kernels (and Adam's at
                bf16; either bf16 route, by the union's width) once a
                step, whose first 20 losses must agree with
                20 steps of the plain path (the plain decode + loss, and
                at bf16 Adam's plain twin: each loss after the first reads
                the backward passes and optimizer steps before it); a
                steady epoch and a profile of 16 steps (the device-idle
                share, each hand kernel once a step). The float32 host
                loader's whole epochs at 0 and 4 collation threads in
                turns; the loader alone and with its staging (no step)
                at 0 and 4 threads, and the step alone over batches
                staged beforehand. Then a tied sparse model 20
                steps in each route, one row-scatter launch a step (the
                input and target unions folded into one row-sparse step),
                against the plain decode + loss and the plain row scatter:
                the 20 losses, and the en_embedding table within a
                relative Frobenius norm of 1e-3.
 23. mf     -- MatrixFactorization(200, tanh, dropout 0.2) on the
                ML-20M-shaped CSR, weighted MSE (confidence 40,
                tests/test_model.py's MF row at BASELINE.json's 200
                factors), Adam lr 1e-3, batch 500, negative sampling,
                block shuffle, full decode from the resident slab, bf16
                compute and moments: one eager epoch (the wgmma
                decode-loss pair and the Adam kernel once a step, no other
                hand kernel), then captured ('auto') and eager in turns
                (rates, device ms and launches a step, idle share, each
                hand kernel once a step by name in 64 replayed steps). The
                fixture (batch 480, a tail block of pad users) captured
                bitwise eager; 20 float32 steps through the 3xTF32 kernels
                and 20 steps of MF(sparse=True) (two row-scatter launches
                a step) against the plain path (losses PATHS_RTOL, both
                tables TABLE_RTOL); the MF gate on the fixture (Recall@20
                > 0.03, 20 epochs) and a checkpoint reload.
 24. multvae -- Mult-VAE(600, 200) with the full softmax
                (negative_sampling=False), logloss, bf16 compute and
                moments at the ML-20M shape: 2 epochs captured and eager
                bitwise equal while beta = step / 2,000 changes inside the
                graphs; an eager epoch (Adam once a step) and the captured
                cell as in phase 23; 20 steps of MultVAE(sparse=True)
                (two row-scatter launches a step) against the plain path;
                tests/test_multvae.py's fixture gate (Recall@20 > 0.135,
                NDCG@100 > 0.160) with evaluate_vae_protocol's summary, and
                a checkpoint reload.
 25. ease   -- EASE(lam=200) at the ML-20M shape: the Gram on the card
                (exact against scipy on 256 sampled columns), the cuSOLVER
                Cholesky inverse (max |(G + lam I) P - I| <= 1e-3), B's
                zero diagonal, the fit timed, recommend(k=100) valid and
                unchanged across save -> load; the fixture floors at lam
                500 (Recall@20 > 0.060, NDCG@100 > 0.095).
 26. negatives -- the reference's negative-sampling knobs at the
                tutorial's values: megas of 2,000 users (4 compute batches
                of 500) and 1,000 random negatives a step. (a) bench.py's
                ML-20M default with them ('users' shuffle, dense slab):
                20 steps against the plain path (bf16 rtol 1e-2; the wgmma
                pair and Adam once a step), then captured ('auto') and
                eager in turns (ml20m_mega2000_neg1000_user_batches_per_sec,
                device ms and launches a step, the idle share, each hand
                kernel once a step in 64 replayed steps); (b) the same
                through the per-step triplet scatter (slab_cache=False),
                eager: 20 losses bitwise (a)'s, and against the plain path;
                (c) 'blocks' captured, against the plain path; (d, run
                after phase 13 while the MSD CSR exists) bench.py's MSD
                --sparse default with them: 20 union steps, two row-scatter
                launches each, against the plain path (float32, rtol 1e-3),
                and the row scatter at a step's union width bitwise
                index_copy_; (e) the bf16 union path, 20 steps: the
                decode-loss route each takes (the mega union plus R is
                rarely a multiple of 8: the mma.sync set), against the
                plain path, and the mma.sync kernels at such a width
                against their plain version. Then the fixture captured
                bitwise eager with megas and random negatives (3 epochs,
                bf16), and the fixture quality row (float32, logloss, 30
                epochs) within 0.01 of the JAX package's pins
                (tools/jax_negatives_pins.py).
 27. large catalog -- the msd-big class (scripts/msd-big/train.py) at the
                shape docs/benchmarks.md profiled: a Zipf catalog of
                1,000,000 items (data/synthetic.synthesize at MSD's 59
                items a user), 100,000 training users and 10,000 more
                held out by phase 21's 80/20 split. (a) its step (sparse
                DynamicAutoencoder[200], tanh, noise 0.5, bf16, logloss,
                Adam, batch 500, negative sampling, 'blocks') for one
                eager epoch with a validation at its end (loss, and
                Recall@20/50, NDCG@100 at k=100 in chunks of 2^18):
                msdbig_user_batches_per_sec, union widths, two row-scatter
                launches a step and no other hand kernel, the validation's
                seconds; (b) on that model, 500 held-out users: chunked
                against monolithic recommend (ms, peak memory, scores
                within two bf16 ulps of the largest, the same id set where
                the 100th and 101st scores are further apart, metrics
                within 0.01), every eval_topk mode the same ids,
                ops/topk.top_k and torch.topk alone at [500, 1,000,192];
                (c) scripts/stress_scale.py's 10,000,000 items at d=128,
                the tables drawn on the card, scored in the chunks Recoder
                resolves: ms and peak memory for 500 users, every id in
                the catalog, unseen; (d, after phase 26 (d)) the
                full-catalog sparse step at bench.py's MSD --sparse shape,
                negative sampling off: 20 steps against the plain path
                (one packed-slab fetch a step, no row scatter), then the
                validation loss of full-catalog batches chunked (8,192)
                against dense (rtol 1e-4); (e, inside phase 6) the
                fixture model's metrics chunked (1,024) within 1e-4 of the
                monolithic ones.
 28. bf16 storage -- params_dtype='bfloat16' and bf16 moments of sparse
                tables. (e) each kernel variant over bf16 tables against
                its plain version and timed beside its bound: the wgmma
                decode-loss pair on bf16 rows at the ML-20M step (bitwise
                the float32 rows of the same values), the mma.sync pair at
                an MSD union width, the 3xTF32 pair over bf16 rows, Adam
                over bf16 parameters with bf16 and with float32 moments;
                (a) bench.py's ML-20M default with --params-dtype
                bfloat16: 20 steps against the plain path, the fixture
                captured bitwise eager, captured and eager in turns with
                the float32-parameter default (rates, device ms and
                launches a step, kernels by name in 64 replayed steps,
                peak memory, parameter and moment GiB), 20 bf16-parameter
                union steps and 20 steps of float32 compute over bf16
                storage against the plain path; (d) the fixture gate row
                at bf16 compute, moments and parameters (30 epochs,
                captured; a reload bit for bit), and, inside phase 6, the
                float32 checkpoint served from bf16 tables; (b, inside
                phase 27) msd-big with bf16 tables and moments: 20 steps
                against the plain path, the row scatter bitwise at
                [1,000,192, 200] for all-bf16 and mixed tables and timed,
                60 steps' rate, device ms, the resident GiB against
                float32; (c) the 10,000,000 x 128 scorer from bf16 tables:
                ms, peak memory, ids against the top-k of the whole
                catalog at once.
 29. union capture -- the JAX scan over 'blocks' steps as CUDA graphs
                (fused_steps_per_call='auto': 16 steps a graph over the
                static-width union batches built on the card), for (a)
                phase 28 (b)'s msd-big step (bf16 tables and moments),
                (b) bench.py's MSD --sparse step, (c) the full-catalog
                sparse step at that shape, (d) bf16 'mse' target training
                on phase 22's split (the dual CSRs), (e) the ML-20M bf16
                union path with megas of 2,000 and 1,000 random
                negatives: 20 steps captured bitwise equal to the same
                steps eager (losses, parameters, moments, step counts);
                with the noise off, 20 static-width steps against the
                exact-width batches built before (rtol 1e-3, bf16 1e-2);
                captured and eager windows of 64 steps in turns
                (user-batches/s), device ms and launches a profiled step,
                the idle share, and each hand kernel of the cell and the
                decode-loss route, by name, in 32 replayed and 32 eager
                steps (the row scatter twice a sparse step). Phases 11,
                22 and 27 (a) count their launches in eager steps
                (fused_steps_per_call=1).
 30. users capture -- phase 29 over 'users' steps inside the JAX gate
                (DeviceDataSource.users_precompute: each epoch's tables
                built on the card, the static batches over them), for (a)
                msd-big as scripts/msd-big/train.py trains it (sparse,
                logloss, bf16 tables and moments), (b) bench.py's MSD
                --sparse step (float32), (c) the ML-20M bf16 union path
                with megas of 2,000 (no random ids: they are outside the
                gate; no mma.sync launch in the replays), (d) bench.py's
                ML-20M default with slab_cache=False (the triplet
                scatter): the gate's bytes; 20 steps from 10 before the
                end of epoch 1 (as a checkpoint there) captured bitwise
                equal to the same steps eager; phase 29's static against
                exact widths, windows in turns and profiles, and the
                exact-width steps' device ms; 6 epochs captured: each
                epoch's width signature, captures and seconds, the ms of
                each capture; the ms of an epoch's table build.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without CUDA, or without the rest of the repository, it exits non-zero
before printing any of them.
"""

import csv
import functools
import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, 'tests', 'data')

SOURCES = {
    'fused_decode_loss_fwd': 'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'fused_decode_loss_bwd': 'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'spd_solve': 'recoder_tpu_torch/kernels/spd_solve.cu',
    'row_scatter': 'recoder_tpu_torch/kernels/row_scatter.cu',
    'fused_decode_loss_fwd_bf16':
        'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'fused_decode_loss_bwd_bf16':
        'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'fused_decode_loss_fwd_bf16_wgmma':
        'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'fused_decode_loss_bwd_bf16_wgmma':
        'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'adam_bf16': 'recoder_tpu_torch/kernels/adam.cu',
    'packed_rows': 'recoder_tpu_torch/kernels/packed_rows.cu',
}
REPLACES = {
    'fused_decode_loss_fwd': 'recoder_tpu/experiments/pallas_loss.py:145',
    'fused_decode_loss_bwd': 'recoder_tpu/experiments/pallas_loss.py:165',
    'spd_solve': 'recoder_tpu/ops/spd.py:235',
    'row_scatter': 'recoder_tpu/experiments/block_scatter.py:136',
    'fused_decode_loss_fwd_bf16': 'recoder_tpu/experiments/pallas_loss.py:145',
    'fused_decode_loss_bwd_bf16': 'recoder_tpu/experiments/pallas_loss.py:165',
    'fused_decode_loss_fwd_bf16_wgmma':
        'recoder_tpu/experiments/pallas_loss.py:145',
    'fused_decode_loss_bwd_bf16_wgmma':
        'recoder_tpu/experiments/pallas_loss.py:165',
    # no Pallas ancestor: the adam branch of the JAX Optimizer.update
    'adam_bf16': 'recoder_tpu/optim.py:157',
    # no Pallas ancestor: the packed tier's row fetch and _unpack_rows
    'packed_rows': 'recoder_tpu/data/device_pipeline.py:779',
}
#: reference values pinned in tests/test_model.py (atol 0.01)
PINNED = {'Recall@20': 0.1417, 'Recall@50': 0.2393, 'NDCG@100': 0.1684}

#: the decode-loss kernels of the training step (kernels/fused_decode_loss.cu)
DECODE_LOSS_KERNELS = ('decode_loss_fwd_kernel', 'drows_dbias_kernel',
                       'dh_splitk_kernel', 'decode_loss_fwd_bf16_kernel',
                       'drows_dbias_bf16_kernel', 'dh_splitk_bf16_kernel',
                       'decode_loss_fwd_bf16_wgmma_kernel',
                       'drows_dbias_bf16_wgmma_kernel', 'dh_bf16_wgmma_kernel')
#: the launch counters of each bf16 decode-loss route
BF16_ROUTE_COUNTERS = {
    'mma': ('fused_decode_loss_fwd_bf16', 'fused_decode_loss_bwd_bf16'),
    'wgmma': ('fused_decode_loss_fwd_bf16_wgmma',
              'fused_decode_loss_bwd_bf16_wgmma')}
#: published peaks of one H100 SXM: TF32 tensor cores (the fastest rate
#: at which it takes float32 operands), bf16 tensor cores (dense) and HBM3
PEAK_FLOPS = 495e12
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL_FRO = 2e-2
BF16_PATHS_RTOL = 1e-2
#: the dense parameters of DynamicAutoencoder[200] at the ML-20M shape
#: (en/de embeddings [20,224, 200], en_bias [200], de_bias [20,224])
ML20M_PARAM_SHAPES = ((20224, 200), (200,), (20224, 200), (20224,))

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_ATOL_FRACTION = 1e-4  # of max |reference|
PATHS_RTOL = 1e-3
#: a table after phase 22's tied sparse steps, kernel vs plain path:
#: relative Frobenius norm of the difference
TABLE_RTOL = 1e-3
SPD_ATOL_FRACTION = 1e-4  # of max |x| of the blocked recursion
SPD_RESIDUAL = 1e-3       # max_i |A x - b| / |b| per system
#: phase 7's ragged systems: the kernel's panel edges (16 columns) among them
SPD_BATCHES = (1, 37)
SPD_WIDTHS = (1, 7, 15, 16, 17, 33, 64, 127, 128, 129, 130, 200, 255, 256)
#: tools/bench_ials.py's configuration (and fit's default chunk budget)
IALS_FULL = dict(embedding_size=128, alpha=10.0, lam=3e-3, sweeps=8,
                 seed=0)
#: the tests/test_ials.py fixture protocol and its floors
IALS_FIXTURE = dict(embedding_size=4, alpha=30.0, lam=0.01, sweeps=8,
                    seed=0)
IALS_FLOORS = {'Recall@20': 0.080, 'NDCG@100': 0.120}
#: bench.py --dataset msd --sparse
MSD_TRAIN = dict(batch_size=500, lr=1e-3, weight_decay=2e-5,
                 negative_sampling=True, shuffle='blocks')
SCATTER_NS = (1, 37, 41216)
SCATTER_DS = (1, 3, 7, 128, 200, 256, 1000)
SCATTER_WS = (0, 1, 37)
#: phase 17's ragged fetches; 1,288 words is the MSD slab's width
PACKED_BATCHES = (1, 37, 500)
PACKED_WORDS = (1, 5, 33, 644, 1288)
#: phase 17's mask-only launches: mega-batches of rows (2,000: phase 26's)
PACKED_MEGAS = (1, 37, 2000)
#: bench.py --dataset msd (its default: dense tables, full decode, bf16)
MSD_DENSE_TRAIN = dict(MSD_TRAIN, slab_cache='auto', full_decode='auto')


def say(*args):
  print(*args, flush=True)


# -- phase 1 ---------------------------------------------------------------

def phase_device():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: CUDA is not available; this script '
                     'runs only on a GPU')
  torch.backends.cuda.matmul.allow_tf32 = False  # full float32 reference
  torch.backends.cudnn.allow_tf32 = False
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  say(f'device: {torch.cuda.get_device_name(0)} '
      f'(count {torch.cuda.device_count()}); torch {torch.__version__}, '
      f'CUDA {torch.version.cuda}; card: {card}')
  return card


# -- phase 2 ---------------------------------------------------------------

def phase_build():
  """Every source at once, one nvcc each; then the decode-loss kernels'
  spills and tensor-core instructions."""
  from concurrent.futures import ThreadPoolExecutor

  from recoder_tpu_torch.kernels import BUILD_LOGS
  from recoder_tpu_torch.ops import adam
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  from recoder_tpu_torch.ops import packed_rows as pr
  from recoder_tpu_torch.ops import row_scatter as rs
  from recoder_tpu_torch.ops import spd
  t0 = time.time()
  libs = (fdl._lib, spd._lib, rs._lib, adam._lib, pr._lib)
  with ThreadPoolExecutor(max_workers=len(libs)) as pool:
    for fut in [pool.submit(lib) for lib in libs]:
      fut.result()
  say(f'build: fused_decode_loss, spd_solve, row_scatter, adam and '
      f'packed_rows in {time.time() - t0:.1f} s')
  for name in ('fused_decode_loss', 'spd_solve', 'row_scatter', 'adam'):
    for line in BUILD_LOGS.get(name, '').splitlines():
      if 'registers' in line or 'spill' in line or 'Compiling' in line:
        say('  ' + line.strip())

  frames = ptxas_frames(BUILD_LOGS.get('fused_decode_loss', ''))
  opcodes = sass_opcodes(fdl._lib()._name)
  for kernel in DECODE_LOSS_KERNELS:
    found = {f: ops for f, ops in opcodes.items() if kernel in f}
    if not found:
      raise AssertionError(f'{kernel} is not in the library\'s SASS')
    for func, ops in sorted(found.items()):
      n = ops['HMMA'] + ops['HGMMA']
      stack, stores, loads = frames.get(func, (None, None, None))
      say(f'  {func}: {n} tensor-core instructions (HMMA/HGMMA); stack '
          f'frame {stack} B, spill stores {stores} B, spill loads {loads} '
          f'B; most frequent opcodes {dict(ops.most_common(8))}')
      if n == 0 or ('wgmma' in kernel and ops['HGMMA'] == 0):
        raise AssertionError(f'{func} has no tensor-core instruction '
                             '(a wgmma kernel: no HGMMA)')
      if stores is None or stores or loads:
        raise AssertionError(f'{func}: register spills, or no ptxas report')

  frames = ptxas_frames(BUILD_LOGS.get('adam', ''))
  if not frames or any(v[1] or v[2] for v in frames.values()):
    raise AssertionError(f'adam_bf16_kernel: register spills, or no ptxas '
                         f'report: {frames}')
  say(f'  adam_bf16_kernel (-fmad=false): '
      f'{ptxas_registers(BUILD_LOGS["adam"], "adam_bf16_kernel")} '
      f'registers, stack frame / spill stores / spill loads '
      f'{list(frames.values())[0]} B')

  log = BUILD_LOGS.get('spd_solve', '')
  frames = {f: v for f, v in ptxas_frames(log).items()
            if 'spd_solve_kernel' in f}
  if not frames or any(v[1] or v[2] for v in frames.values()):
    raise AssertionError(f'spd_solve_kernel: register spills, or no ptxas '
                         f'report: {frames}')
  for d in (128, 256):
    res = spd.kernel_resources(d)
    say(f'  spd_solve_kernel at d = {d}: {ptxas_registers(log)} registers, '
        f'stack frame / spill stores / spill loads '
        f'{list(frames.values())[0]} B, {res["smem_bytes"]} B of shared '
        f'memory, {res["blocks_per_sm"]} resident blocks an SM')


def ptxas_registers(log, kernel='spd_solve_kernel'):
  """Registers a thread of ``kernel`` uses, from a ptxas report."""
  func = None
  for line in log.splitlines():
    if 'Compiling entry function' in line:
      func = line
    elif func is not None and kernel in func and 'Used' in line:
      return int(re.search(r'Used (\d+) registers', line).group(1))
  return None


def ptxas_frames(log):
  """{function: (stack frame, spill stores, spill loads) in bytes} from
  the ptxas report of a build."""
  frames, func = {}, None
  for line in log.splitlines():
    if 'Function properties for' in line:
      func = line.split('Function properties for')[1].strip()
    elif func is not None and 'stack frame' in line:
      frames[func] = tuple(int(x) for x in re.findall(r'(\d+) bytes',
                                                       line)[:3])
      func = None
  return frames


def sass_opcodes(library):
  """{function: Counter of its SASS opcodes} in a built library, by the
  toolkit's cuobjdump -sass."""
  import collections
  from torch.utils.cpp_extension import CUDA_HOME
  sass = subprocess.run(
      [os.path.join(CUDA_HOME, 'bin', 'cuobjdump'), '-sass', library],
      capture_output=True, text=True, check=True).stdout
  counts, func = {}, None
  for line in sass.splitlines():
    if 'Function :' in line:
      func = line.split('Function :')[1].strip()
      counts[func] = collections.Counter()
    elif func is not None and re.match(r'\s+/\*[0-9a-f]{4}\*/', line):
      words = line.split('*/', 1)[1].replace(';', ' ').split()
      if words and words[0].startswith('@'):  # a predicate
        words = words[1:]
      if words:
        counts[func][words[0].split('.')[0]] += 1
  return counts


# -- phase 3 ---------------------------------------------------------------

def make_problem(B, d, W, device, seed=0):
  """Inputs at training-like magnitudes: tanh-range activations, small
  table entries, sparse binary targets, masks that hold zeros."""
  import torch
  gen = torch.Generator().manual_seed(seed)
  h = torch.tanh(torch.randn(B, d, generator=gen))
  rows = 0.1 * torch.randn(W, d, generator=gen)
  bias = 0.1 * torch.randn(W, generator=gen)
  target = (torch.rand(B, W, generator=gen) < 0.02).float()
  row_mask = (torch.arange(B) < B - max(1, B // 10)).float()
  col_mask = (torch.rand(W, generator=gen) < 0.8).float()
  return [x.to(device) for x in (h, rows, bias, target, row_mask, col_mask)]


def _close(got, ref, rtol, atol):
  err = (got - ref).abs()
  return bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def compare_kernel(B, d, W, kind, confidence, device, target_dtype=None,
                   compute_dtype=None, route=None, rows_dtype=None):
  """Kernel loss and gradients against autograd through the plain
  version; returns the largest abs errors (loss, grads) and the kernel's
  (loss, dh, drows, dbias). The bf16 variant (``compute_dtype``), and any
  call on bf16 rows and bias (``rows_dtype``: bf16 parameter storage,
  whose drows and dbias are rounded to bf16), is held to loss rtol 1e-2
  and gradients within 2e-2 in relative Frobenius norm; ``route``: the
  bf16 kernels ('wgmma' or 'mma') that must have launched, once each
  way."""
  import torch
  from recoder_tpu_torch.ops.fused_decode_loss import (
      LAUNCHES, fused_decode_loss, fused_decode_loss_plain)
  h, rows, bias, target, rm, cm = make_problem(B, d, W, device)
  if target_dtype is not None:
    target = target.to(target_dtype)
  if rows_dtype is not None:
    rows, bias = rows.to(rows_dtype), bias.to(rows_dtype)
  before = dict(LAUNCHES)
  results = {}
  for name, fn in (('kernel', fused_decode_loss),
                   ('plain', fused_decode_loss_plain)):
    hh, rr, bb = (x.clone().requires_grad_(True) for x in (h, rows, bias))
    loss = fn(hh, rr, bb, target, rm, cm, kind, confidence, compute_dtype)
    loss.backward()
    results[name] = (loss.detach(), hh.grad, rr.grad, bb.grad)
  (lk, *gk), (lp, *gp) = results['kernel'], results['plain']
  bf16 = compute_dtype is not None or rows_dtype is not None
  what = (f'{kind} c={confidence} [{B},{d},{W}] target {target.dtype}'
          f'{" bf16 compute" if compute_dtype is not None else ""}'
          f'{" bf16 rows" if rows_dtype is not None else ""}')
  if route is not None:
    ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    for r, names in BF16_ROUTE_COUNTERS.items():
      if any(ran[n] != (r == route) for n in names):
        raise AssertionError(f'{what}: launches {ran}, expected the {route} '
                             'kernels once each')
  ok, loss_err = _close(lk, lp, BF16_LOSS_RTOL if bf16 else LOSS_RTOL, 0.0)
  if not ok:
    raise AssertionError(f'{what}: loss {float(lk)} vs plain {float(lp)}')
  grad_err = 0.0
  for gname, a, b in zip(('dh', 'drows', 'dbias'), gk, gp):
    if a.dtype != b.dtype:
      raise AssertionError(f'{what}: {gname} is {a.dtype}, plain {b.dtype}')
    a, b = a.float(), b.float()
    if bf16:
      err = float((a - b).abs().max())
      rel = float(torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b).clamp(min=1e-30))
      ok = rel <= BF16_GRAD_REL_FRO
    else:
      atol = GRAD_ATOL_FRACTION * float(b.abs().max())
      ok, err = _close(a, b, GRAD_RTOL, atol)
    grad_err = max(grad_err, err)
    if not ok:
      raise AssertionError(f'{what}: {gname} max abs err {err}')
  say(f'  {kind:8s} c={confidence:<3} [{B}, {d}, {W}] {str(target.dtype)[6:]:8s}'
      f'{" bf16" if compute_dtype is not None else ""}'
      f'{" bf16 rows" if rows_dtype is not None else ""}'
      f'{f" ({route})" if route else ""}: loss '
      f'{float(lk):.6g} (plain {float(lp):.6g}), max abs err loss '
      f'{loss_err:.3g} grads '
      f'{grad_err:.3g}')
  return loss_err, grad_err, results['kernel']


def median_ms(fn, reps=30, warmup=3):
  import torch
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def per_launch_ms(fn, launches=20, reps=10):
  """Median over ``reps`` of the CUDA-event time of ``launches``
  back-to-back calls, divided by ``launches``: the device time of one
  call when the host enqueues faster than the device runs."""
  return median_ms(lambda: [fn() for _ in range(launches)], reps=reps,
                   warmup=1) / launches


def device_ms(fn, calls=20, between=None, skip=None, tries=3):
  """Device time of one call of ``fn``: the sum of the kernels it
  launches over ``calls`` calls, by torch.profiler, divided by ``calls``
  (free of the host's time, which ``per_launch_ms`` includes when the
  host enqueues slower than the device runs). ``between`` runs before
  each call, and kernels whose name holds ``skip`` are left out. A
  profile that recorded fewer kernels than calls (the profiler at times
  drops a window's first device events, the more the more windows the
  process has opened) is taken again, opened with
  :func:`settle_profiler`'s markers."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for attempt in range(tries):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      if attempt:
        settle_profiler()
      for _ in range(calls):
        if between is not None:
          between()
        fn()
      torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if 'CUDA' in str(ev.device_type)
               and 'spin_kernel' not in ev.key
               and (skip is None or skip not in ev.key)]
    if sum(ev.count for ev in kernels) >= calls:
      return sum(ev.self_device_time_total for ev in kernels) / 1e3 / calls
  raise AssertionError(f'the profiler recorded fewer than {calls} kernels '
                       f'in {tries} tries')


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
  """(least ms on the card, what sets it): operations at ``peak_flops``
  (the TF32 tensor-core peak by default) against bytes at the HBM
  peak."""
  ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
  return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms,
                                                             'bytes')


def decode_loss_bounds(B, d, W, target_bytes=4, bf16=False, param_bytes=4):
  """Bounds of each timed step, counted from what that step reads and
  writes (each input once, each output once) and the products it does:
  the forward (the loss, and E0 [B, lde] when a backward follows), the
  backward (two products over E0 to dh, drows and dbias) and the pair
  (the function itself: three products from h, rows, bias and the
  target to the loss and the three gradients). ``bf16``: the bf16
  variant -- E0 in bf16 ([B, W rounded up to 8]) and the products at the
  bf16 tensor-core peak. ``param_bytes``: the element size of rows and
  bias, read and their gradients written (2: bf16 parameter storage)."""
  product = 2.0 * B * W * d
  lde, e0_bytes = (-(-W // 8) * 8, 2.0) if bf16 else (-(-W // 4) * 4, 4.0)
  peak = PEAK_FLOPS_BF16 if bf16 else PEAK_FLOPS
  pb = float(param_bytes)
  inputs = 4.0 * (B * d + W + B) + pb * (W * d + W) + target_bytes * B * W
  grads = 4.0 * B * d + pb * (W * d + W)
  return {'fwd': bound(product, inputs + 4 + e0_bytes * B * lde, peak),
          'fwd_nograd': bound(product, inputs + 4, peak),
          'bwd': bound(2 * product, e0_bytes * B * lde
                       + 4.0 * B * d + pb * W * d + 4 + grads, peak),
          'fwd_bwd': bound(3 * product, inputs + 4 + 4 + grads, peak)}


def time_kernel(B, d, W, kind, confidence, device, compute_dtype=None,
                target_dtype=None, routes=('kernel',), rows_dtype=None):
  """Forward (writing E0, as training runs it), forward under no_grad,
  backward from E0 and forward+backward, of each kernel set in
  ``routes`` and of the plain version, at one shape: 'kernel' is the
  route the wrapper picks (forward+backward through autograd), 'wgmma'
  and 'mma' force that set of bf16 kernels (forward+backward as the two
  calls). Each is timed by its
  device time (profiler) and by the median of CUDA events, in turns
  plain, routes..., routes reversed, plain; returns {'device'|'events':
  {name: {step: mean ms}}}. ``rows_dtype``: rows and bias in that dtype
  (bf16 parameter storage)."""
  import torch
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  h, rows, bias, target, rm, cm = make_problem(B, d, W, device)
  if target_dtype is not None:
    target = target.to(target_dtype)
  if rows_dtype is not None:
    rows, bias = rows.to(rows_dtype), bias.to(rows_dtype)
  g = torch.ones((), device=device)
  args = (target, rm, cm, kind, confidence, compute_dtype)
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]

  def fwd_bwd(fn):
    def run():
      for x in leaves:
        x.grad = None
      fn(*leaves, *args).backward()
    return run

  def kernel_steps(route):
    r = None if route == 'kernel' else route

    def fwd(stash):
      return fdl._kernel_forward(h, rows, bias, *args, stash, route=r)

    _, e0, copies = fwd(True)

    def pair():
      _, e, c = fwd(True)
      return fdl._kernel_backward(g, e, h, rows, c)

    return {'fwd': lambda: fwd(True),
            'fwd_nograd': lambda: fwd(False),
            'bwd': lambda: fdl._kernel_backward(g, e0, h, rows, copies),
            'fwd_bwd': fwd_bwd(fdl.fused_decode_loss) if r is None else pair}

  _, e0_plain = fdl._plain_forward(h, rows, bias, *args, True)
  steps = {route: kernel_steps(route) for route in routes}
  steps['plain'] = {
      'fwd': lambda: fdl._plain_forward(h, rows, bias, *args, True),
      'fwd_nograd': lambda: fdl._plain_forward(h, rows, bias, *args, False),
      'bwd': lambda: fdl._plain_backward(g, e0_plain, h, rows),
      'fwd_bwd': fwd_bwd(fdl.fused_decode_loss_plain)}
  runs = {how: {name: {step: [] for step in steps[name]} for name in steps}
          for how in ('device', 'events')}
  for name in ('plain', *routes, *reversed(routes), 'plain'):
    for step, fn in steps[name].items():
      runs['device'][name][step].append(device_ms(fn))
      runs['events'][name][step].append(median_ms(fn))
  return {how: {name: {step: statistics.mean(v) for step, v in d_.items()}
                for name, d_ in r.items()} for how, r in runs.items()}


def report_times(times, shape, what, target_bytes=4, bf16=False,
                 param_bytes=4):
  """Print each kernel set's and the plain version's times, and each
  kernel set's bound and share."""
  B, d, W = shape
  bounds = decode_loss_bounds(B, d, W, target_bytes, bf16, param_bytes)
  names = [n for n in times['device'] if n != 'plain'] + ['plain']
  for how in ('device', 'events'):
    for name in names:
      t = times[how][name]
      say(f'  {how:7s} {name:6s} {what}: fwd {t["fwd"]:.4f} ms (no_grad '
          f'{t["fwd_nograd"]:.4f}), bwd {t["bwd"]:.4f} ms, fwd+bwd '
          f'{t["fwd_bwd"]:.4f} ms')
  for name in names[:-1]:
    for step in ('fwd', 'fwd_nograd', 'bwd', 'fwd_bwd'):
      ms = times['device'][name][step]
      b_ms, by = bounds[step]
      say(f'  {name} {step}: bound {b_ms:.4f} ms ({by}); at '
          f'{100 * b_ms / ms:.1f}% of it (device time)')


def phase_kernels(device='cuda', ragged=(37, 24, 1000),
                  full=(500, 200, 20224), union=(500, 200, 18117)):
  import torch
  cases = [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]
  errs = {}
  for shape in (ragged, full, union):
    for kind, c in cases:
      *errs[(shape, kind, c)], f32 = compare_kernel(*shape, kind, c, device)
      *_, bf16 = compare_kernel(*shape, kind, c, device, torch.bfloat16)
      if not all(torch.equal(a, b) for a, b in zip(f32, bf16)):
        raise AssertionError(f'{kind} c={c} {shape}: the bfloat16 target '
                             'did not give the float32 run bit for bit')
  say('  bfloat16 targets: loss and gradients bitwise those of float32')
  times = time_kernel(*full, 'mse', 3.0, device)
  report_times(times, full, f'mse c=3 {list(full)}')
  fb = {name: times['device'][name]['fwd_bwd'] for name in times['device']}
  say(f'  fwd+bwd device time: kernel {fb["kernel"]:.4f} ms vs plain '
      f'{fb["plain"]:.4f} ms')
  loss_err = max(e[0] for e in errs.values())
  grad_err = max(e[1] for e in errs.values())
  return times, (loss_err, grad_err)


# -- data ------------------------------------------------------------------

def load_fixture():
  """The fixture's train and validation matrices, mapped as
  tests/test_model.py maps them (read without pandas)."""
  from recoder_tpu_torch.utils import dataframe_to_csr_matrix

  def read(name):
    with gzip.open(os.path.join(DATA_DIR, name), 'rt') as f:
      reader = csv.reader(f)
      header = next(reader)
      cols = np.array(list(reader), dtype=np.int64).T
    return dict(zip(header, cols))

  train, val = read('train.csv.gz'), read('val.csv.gz')
  keep = np.isin(val['sid'], np.unique(train['sid']))
  val = {k: v[keep] for k, v in val.items()}
  train_m, item_map, user_map = dataframe_to_csr_matrix(
      train, 'uid', 'sid', 'watched')
  val_m, _, _ = dataframe_to_csr_matrix(
      val, 'uid', 'sid', 'watched', item_id_map=item_map,
      user_id_map=user_map)
  return train_m, val_m


# -- phase 4 ---------------------------------------------------------------

def _launch_counts():
  from recoder_tpu_torch.ops import adam
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  from recoder_tpu_torch.ops import packed_rows as pr
  from recoder_tpu_torch.ops import row_scatter as rs
  return fdl.LAUNCHES, adam.LAUNCHES, pr.LAUNCHES, rs.LAUNCHES


def reset_launches():
  for counts in _launch_counts():
    for k in counts:
      counts[k] = 0


def read_launches():
  return {k: v for counts in _launch_counts() for k, v in counts.items()}


#: phase 4's and phase 15's training arguments (bench.py's ML-20M cell)
ML20M_TRAIN = dict(batch_size=500, lr=1e-3, weight_decay=2e-5,
                   negative_sampling=True, shuffle='blocks')


def eager_epoch(trainer, dataset, kw, kernels):
  """One epoch, one eager dispatch a step, with the launch counters set
  to 0 just before it: each of ``kernels`` must be launched once a step
  and no other hand kernel at all; returns the counts and the rate."""
  import torch
  reset_launches()
  t0 = time.time()
  trainer.train(dataset, num_epochs=1, fused_steps_per_call=1, **kw)
  torch.cuda.synchronize()
  first_s = time.time() - t0
  counts = read_launches()
  steps = len(trainer.last_epoch_losses)
  launched = {k: v for k, v in counts.items() if v}
  if launched != dict.fromkeys(kernels, steps):
    raise AssertionError(f'an epoch of {steps} steps launched {launched}, '
                         f'expected each of {kernels} once a step')
  losses = np.asarray(trainer.last_epoch_losses)
  if not np.all(np.isfinite(losses)):
    raise AssertionError('non-finite training loss')
  head, tail = losses[:10].mean(), losses[-10:].mean()
  if not tail < head:
    raise AssertionError(f'loss did not fall: first 10 steps {head}, last '
                         f'10 {tail}')
  rate = steps / trainer.last_epoch_seconds
  say(f'  eager epoch: {steps} steps, {rate:.2f} user-batches/s (first call '
      f'{first_s:.1f} s with the slab build); each of {list(kernels)} '
      f'{steps} times; loss first 10 steps {head:.4f}, last 10 {tail:.4f}')
  return counts, rate


def phase_slice(matrix, device='cuda', epochs_timed=2, compute_dtype=None,
                opt_state_dtype=None):
  """One full epoch of the main path (at the given numerics), steady
  epochs and a profile, one eager dispatch a step (so that every launch
  is counted; phase 20 runs the same cell captured); returns the epoch's
  launch counts of the kernels that path runs, the rates, the profiled
  device ms a step, and the trainer and its dataset."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  dataset = RecommendationDataset(matrix)
  common = dict(ML20M_TRAIN, fused_steps_per_call=1)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                       compute_dtype=compute_dtype),
                    optimizer_type='adam', loss='mse',
                    loss_params={'confidence': 3}, device=device,
                    opt_state_dtype=opt_state_dtype)
  if compute_dtype is None:
    kernels = ('fused_decode_loss_fwd', 'fused_decode_loss_bwd')
  else:  # (the full-decode width 20,224 and a bf16 slab: the wgmma route)
    kernels = BF16_ROUTE_COUNTERS['wgmma']
  if opt_state_dtype is not None:
    kernels += ('adam_bf16',)
  counts, epoch_rate = eager_epoch(trainer, dataset, ML20M_TRAIN, kernels)
  launches = {k: counts[k] for k in kernels}
  if len(trainer.last_epoch_losses) != -(-matrix.shape[0] // 500):
    raise AssertionError(f'epoch ran {len(trainer.last_epoch_losses)} steps')

  # steady state: train() resumes at current_epoch inclusive, so this
  # call runs epochs 1..epochs_timed again
  rates = []
  for epoch in range(2, epochs_timed + 2):
    trainer.train(dataset, num_epochs=epoch, **common)
    rates.append(len(trainer.last_epoch_losses)
                 / trainer.last_epoch_seconds)
  dtypes = f'compute {compute_dtype or "float32"}, moments ' \
      f'{opt_state_dtype or "float32"}'
  say(f'  steady epochs ({dtypes}): ml20m_user_batches_per_sec '
      f'{", ".join(f"{r:.2f}" for r in rates)}')
  _, busy_ms, per_step, _ = profile_steps(trainer, dataset, ML20M_TRAIN)
  steady_ms = 1e3 / max(rates)
  say(f'  steady step {steady_ms:.3f} ms without the profiler: the device '
      f'idle ~{100 * (1 - busy_ms / steady_ms):.1f}% of it')

  users, _ = dataset[np.arange(500)]
  recs = np.asarray(trainer.recommend(users, 100))
  seen = users.interactions_matrix
  if recs.shape != (500, 100):
    raise AssertionError(f'recommend shape {recs.shape}')
  if recs.min() < 0 or recs.max() >= matrix.shape[1]:
    raise AssertionError('recommended ids outside the catalog')
  for i in range(500):
    row_seen = seen.indices[seen.indptr[i]:seen.indptr[i + 1]]
    if np.isin(recs[i], row_seen).any() or len(set(recs[i])) != 100:
      raise AssertionError(f'user {i}: seen or repeated recommendations')
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'slice'))
    restored = Recoder(DynamicAutoencoder(), device=device)
    restored.init_from_model_file(path)
    recs2 = np.asarray(restored.recommend(users, 100))
  if restored.model.compute_dtype != trainer.model.compute_dtype:
    raise AssertionError('the checkpoint did not restore the compute dtype')
  if not np.array_equal(recs, recs2):
    raise AssertionError('recommendations changed across the checkpoint')
  say('  recommend k=100 for 500 users: in range, unseen, identical after '
      'save_state -> init_from_model_file')
  return (launches, epoch_rate, rates, (busy_ms, per_step, steady_ms),
          (trainer, dataset))


# -- phase 5 ---------------------------------------------------------------

def phase_paths(train_m, device='cuda', steps=20, compute_dtype=None,
                opt_state_dtype=None, rtol=PATHS_RTOL):
  """'mse' trains through the fused kernel; an ``MSELoss`` instance
  (the same loss) through the decode matmul and ops/losses.py."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops.losses import MSELoss

  dataset = RecommendationDataset(train_m)
  trajectories = {}
  for fused in (True, False):
    loss = 'mse' if fused else MSELoss(confidence=3, reduction='sum')
    trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                         compute_dtype=compute_dtype),
                      optimizer_type='adam', loss=loss,
                      loss_params={'confidence': 3} if fused else None,
                      device=device, opt_state_dtype=opt_state_dtype)
    trainer.train(dataset, batch_size=500, lr=1e-3, weight_decay=2e-5,
                  negative_sampling=True, shuffle='blocks', num_epochs=1,
                  iters_per_epoch=steps)
    trajectories[fused] = np.asarray(trainer.last_epoch_losses)
  k, p = trajectories[True], trajectories[False]
  if len(k) != steps or len(p) != steps:
    raise AssertionError(f'ran {len(k)} and {len(p)} steps, not {steps}')
  rel = np.abs(k - p) / np.abs(p)
  if not np.all(rel <= rtol):
    raise AssertionError(f'kernel and plain trajectories differ: max rel '
                         f'{rel.max()} (kernel {k}, plain {p})')
  say(f'  {steps} steps, kernel vs plain loss: max rel diff {rel.max():.3g}'
      f' (first {k[0]:.5f} / {p[0]:.5f}, last {k[-1]:.5f} / {p[-1]:.5f})')
  return float(rel.max())


# -- phase 6 ---------------------------------------------------------------

def phase_quality(train_m, val_m, device='cuda', epochs=30, atol=0.01,
                  compute_dtype=None, opt_state_dtype=None, reload_atol=0.0,
                  slab_cache='auto', pinned=PINNED, chunked=None,
                  params_dtype=None, serve_bf16=False, **train_kw):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  train_ds = RecommendationDataset(train_m)
  val_ds = RecommendationDataset(val_m, train_m)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                       compute_dtype=compute_dtype,
                                       params_dtype=params_dtype),
                    optimizer_type='adam', loss='logloss', device=device,
                    opt_state_dtype=opt_state_dtype)
  t0 = time.time()
  trainer.train(train_ds, batch_size=500, lr=1e-3, weight_decay=2e-5,
                num_epochs=epochs, negative_sampling=True,
                slab_cache=slab_cache, **train_kw)
  train_s = time.time() - t0
  source = trainer.fused_data_source
  if slab_cache == 'packed' and not (source.d_slab is not None
                                     and source._slab_packed):
    raise AssertionError('the packed row did not train on the packed tier')
  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]
  results = trainer._evaluate(val_ds, 100, metrics, batch_size=500)
  means = {str(m): float(np.mean(v)) for m, v in results.items()}
  say(f'  compute {compute_dtype or "float32"}, moments '
      f'{opt_state_dtype or "float32"}, parameters '
      f'{params_dtype or "float32"}, slab_cache={slab_cache!r}'
      + ''.join(f', {k}={v}' for k, v in train_kw.items())
      + f': {epochs} epochs in {train_s:.1f} s, dispatch: '
      f'{trainer.last_epoch_dispatch} ({trainer.last_epoch_dispatches} '
      'dispatches an epoch); '
      + ', '.join(f'{k} {v:.4f} (pinned {pinned[k]})'
                  for k, v in means.items()))
  if not trainer.last_epoch_dispatch.startswith('captured'):
    raise AssertionError("the quality row did not run captured under "
                         "fused_steps_per_call='auto'")
  misses = {k: v for k, v in means.items() if abs(v - pinned[k]) > atol}
  if misses:
    raise AssertionError(f'quality outside atol {atol} of the pinned '
                         f'values: {misses}')
  if chunked:
    # phase 27 (e): the same evaluation scored in chunks
    trainer.eval_item_chunk = chunked
    results = trainer._evaluate(val_ds, 100, metrics, batch_size=500)
    trainer.eval_item_chunk = None
    gaps = {str(m): abs(float(np.mean(v)) - means[str(m)])
            for m, v in results.items()}
    if max(gaps.values()) > 1e-4:
      raise AssertionError(f'(27 e) chunked metrics off the monolithic ones '
                           f'by {gaps}')
    say(f'  (27 e) chunked evaluation ({chunked:,} items a chunk): the '
        f'metrics within {max(gaps.values()):.3g} of the monolithic ones')
  # built without compute_dtype: the checkpoint's comes back (the
  # storage dtype, which a checkpoint does not carry, from the constructor)
  reload_metrics(trainer, lambda: Recoder(DynamicAutoencoder(
      params_dtype=params_dtype), device=device), val_ds, metrics, means,
                 atol=reload_atol)
  if serve_bf16:
    serve_checkpoint_bf16(trainer, val_ds, metrics, means, atol, device)
  return means


def serve_checkpoint_bf16(trainer, val_ds, metrics, means, atol, device):
  """(28 d) This float32 trainer's checkpoint loaded into a
  ``params_dtype='bfloat16'`` model (every table rounded to nearest
  even, bf16 compute) and scored: the metrics within ``atol`` of the
  float32 model's."""
  import torch
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'f32'))
    served = Recoder(DynamicAutoencoder(params_dtype='bfloat16'),
                     device=device)
    served.init_from_model_file(path)
  for name, p in served.model.params().items():
    want = trainer.model.params()[name].detach().to(torch.bfloat16)
    if p.dtype != torch.bfloat16 or not torch.equal(p, want):
      raise AssertionError(f'(28 d) {name} is not the float32 table '
                           'rounded to bf16')
  results = served._evaluate(val_ds, 100, metrics, batch_size=500)
  got = {str(m): float(np.mean(v)) for m, v in results.items()}
  gaps = {k: abs(got[k] - v) for k, v in means.items()}
  say('  (28 d) the float32 checkpoint served from bf16 tables: '
      + ', '.join(f'{k} {v:.4f} (float32 {means[k]:.4f})'
                  for k, v in got.items()))
  if max(gaps.values()) > atol:
    raise AssertionError(f'(28 d) bf16 serving moved the metrics by {gaps}')
  return got


def reload_metrics(trainer, make, val_ds, metrics, means, atol=1e-6):
  """A save_state -> init_from_model_file round trip into ``make()``
  gives the same metrics (within ``atol``)."""
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'reload'))
    restored = make()
    restored.init_from_model_file(path)
    results = restored._evaluate(val_ds, 100, metrics, batch_size=500)
  again = {str(m): float(np.mean(v)) for m, v in results.items()}
  if any(abs(again[k] - v) > atol for k, v in means.items()):
    raise AssertionError(f'metrics changed across the checkpoint: {means} '
                         f'vs {again}')
  if restored.model.compute_dtype != trainer.model.compute_dtype:
    raise AssertionError('the checkpoint did not restore the compute dtype')
  say('  checkpoint reload: identical metrics')


# -- phase 7 ---------------------------------------------------------------

def ials_systems(B, d, device, seed=0, n_items=20108, L=64, alpha=10.0,
                 lam=3e-3):
  """SPD systems as an iALS user half-sweep builds them: the Gram of
  item factors at the init scale, plus confidence-weighted corrections
  from L observed items, plus the frequency-scaled ridge."""
  import torch
  gen = torch.Generator(device=device).manual_seed(seed)
  items = torch.randn(n_items, d, device=device, generator=gen) / d ** 0.5
  cols = torch.randint(0, n_items, (B, L), device=device, generator=gen)
  counts = torch.randint(1, L + 1, (B,), device=device, generator=gen)
  valid = (torch.arange(L, device=device) < counts[:, None]).float()
  f = items[cols] * valid[..., None]
  w = alpha * valid
  a = items.t() @ items + torch.einsum('bl,bld,ble->bde', w, f, f)
  a = a + (lam * (counts + 1.0))[:, None, None] * torch.eye(d, device=device)
  b = torch.einsum('bl,bld->bd', w + valid, f)
  return a.contiguous(), b.contiguous()


def check_spd(a, b, what):
  """Kernel against the blocked recursion (base 32, as iALS calls it);
  returns the max abs error."""
  import torch
  from recoder_tpu_torch.ops import spd
  x = spd.spd_solve_kernel(a, b)
  ref = spd.spd_solve_blocked(a, b, 32)
  torch.cuda.synchronize()
  err = float((x - ref).abs().max())
  scale = float(ref.abs().max())
  res = (torch.linalg.vector_norm(torch.einsum('bij,bj->bi', a, x) - b, dim=1)
         / torch.linalg.vector_norm(b, dim=1))
  rel = float(res.max())
  if not (torch.isfinite(x).all() and err <= SPD_ATOL_FRACTION * scale
          and rel <= SPD_RESIDUAL):
    raise AssertionError(f'spd_solve {what}: max abs err {err} (max |x| '
                         f'{scale}), relative residual {rel}')
  return err, scale, rel


def spd_problem(B, d, device):
  """Well-conditioned SPD systems: a Gram of d + 8 random rows plus a
  ridge, and a random right-hand side."""
  import torch
  rng = np.random.default_rng(d)
  f = rng.standard_normal((B, d + 8, d)).astype(np.float32) / np.sqrt(d)
  a = np.einsum('blk,blm->bkm', f, f) + 0.05 * np.eye(d)
  b = rng.standard_normal((B, d)).astype(np.float32)
  return (torch.from_numpy(a.astype(np.float32)).to(device),
          torch.from_numpy(b).to(device))


def check_spd_ragged(device):
  """The kernel against the blocked recursion at every (B, d) of
  SPD_BATCHES x SPD_WIDTHS; returns the worst max abs error over max |x|."""
  worst = 0.0
  for B in SPD_BATCHES:
    for d in SPD_WIDTHS:
      err, scale, _ = check_spd(*spd_problem(B, d, device), f'[{B}, {d}]')
      worst = max(worst, err / scale)
  return worst


def check_spd_indefinite(device, d):
  """One indefinite system in a batch of 37: its x is all NaN, and the
  other 36 are bitwise their solve in a batch without it."""
  import torch
  from recoder_tpu_torch.ops import spd
  a, b = spd_problem(37, d, device)
  a[11] = -a[11]
  x = spd.spd_solve_kernel(a, b)
  keep = torch.tensor([i for i in range(37) if i != 11], device=device)
  rest = spd.spd_solve_kernel(a[keep].contiguous(), b[keep].contiguous())
  if not (torch.isnan(x[11]).all() and torch.isfinite(rest).all()
          and torch.equal(x[keep], rest)):
    raise AssertionError(f'spd_solve [37, {d}] with one indefinite system: '
                         f'not NaN there, or the others changed')


def phase_spd(device='cuda', full=(16384, 128)):
  import torch
  from recoder_tpu_torch.ops import spd
  worst = check_spd_ragged(device)
  say(f'  ragged B in {SPD_BATCHES} x d in {SPD_WIDTHS}: worst max abs err '
      f'{worst:.3g} of max |x|')
  for d in (128, 200):
    check_spd_indefinite(device, d)
  say('  one indefinite system among 37 (d = 128, 200): NaN there, the other '
      '36 bitwise their solve without it')

  B, d = full
  a, b = ials_systems(B, d, device)
  err, scale, rel = check_spd(a, b, f'iALS shape [{B}, {d}]')
  say(f'  iALS shape [{B}, {d}]: max abs err {err:.3g} (max |x| '
      f'{scale:.3g}), worst relative residual {rel:.3g}')
  # bitwise: a system's x alone, in another batch position, run to run
  x = spd.spd_solve_kernel(a, b)
  idx = torch.tensor([5, 0, B - 1, 777], device=device)
  again = spd.spd_solve_kernel(a, b)
  sub = spd.spd_solve_kernel(a[idx].contiguous(), b[idx].contiguous())
  one = spd.spd_solve_kernel(a[777:778].contiguous(),
                             b[777:778].contiguous())
  if not (torch.equal(x, again) and torch.equal(sub, x[idx])
          and torch.equal(one[0], x[777])):
    raise AssertionError('spd_solve kernel is not bitwise independent of '
                         'batch position')
  say('  bitwise equal run to run, alone and at other batch positions')

  def cusolver():
    l, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[..., None], l)

  times = {'kernel': median_ms(lambda: spd.spd_solve_kernel(a, b), reps=10),
           'blocked': median_ms(lambda: spd.spd_solve_blocked(a, b, 32),
                                reps=10),
           'cholesky_ex+cholesky_solve': median_ms(cusolver, reps=10),
           'linalg.solve': median_ms(lambda: torch.linalg.solve(a, b),
                                     reps=10)}
  say('  time at the iALS shape (median of 10): '
      + ', '.join(f'{k} {v:.4f} ms' for k, v in times.items())
      + '; kernel back to back (events, 10 launches) '
      f'{per_launch_ms(lambda: spd.spd_solve_kernel(a, b), launches=10):.4f}'
      ' ms')
  return err, times


# -- phase 8 ---------------------------------------------------------------

def ials_chunks(model, matrix):
  """Chunks per user and per item half-sweep of ``model``'s plans."""
  nnz_u = np.diff(matrix.indptr).astype(np.int64)
  nnz_i = np.bincount(matrix.indices, minlength=matrix.shape[1])
  return tuple(sum(1 for _ in model._chunk_layout(n.astype(np.int64)))
               for n in (nnz_u, nnz_i))


def check_recommendations(recs, seen, k, n_items):
  if any(len(r) != k for r in recs):
    raise AssertionError('recommend returned fewer than k items')
  for i, r in enumerate(recs):
    row_seen = seen.indices[seen.indptr[i]:seen.indptr[i + 1]]
    if (r.min() < 0 or r.max() >= n_items or np.isin(r, row_seen).any()
        or len(set(r.tolist())) != k):
      raise AssertionError(f'user {i}: out of range, seen or repeated '
                           f'recommendations')


def ials_objective(model, matrix, chunk=1 << 20):
  """``IALS.objective`` (the exact iALS objective, float64), computed on
  the card: the same sums, the observed cells in chunks of ``chunk``."""
  import torch
  m = matrix.tocsr().astype(np.float64)
  m.eliminate_zeros()
  u = model.user_factors.double()[:m.shape[0]]
  v = model.item_factors.double()
  total = float(torch.sum((u.T @ u) * (v.T @ v)))
  coo = m.tocoo()
  for lo in range(0, coo.nnz, chunk):
    part = slice(lo, lo + chunk)
    rows, cols, data = (torch.from_numpy(np.ascontiguousarray(x[part]))
                        .to(u.device) for x in (coo.row, coo.col, coo.data))
    s = torch.einsum('nd,nd->n', u[rows.long()], v[cols.long()])
    c = 1.0 + model.alpha * data
    total += float(torch.sum(c * (1.0 - s) ** 2 - s ** 2))
  nnz_u = np.diff(m.indptr)
  nnz_v = np.bincount(m.indices, minlength=m.shape[1])
  if model.reg_scaling == 'frequency':
    ru, rv = model.lam * (nnz_u + 1.0), model.lam * (nnz_v + 1.0)
  else:
    ru = np.full(m.shape[0], model.lam)
    rv = np.full(m.shape[1], model.lam)
  for reg, f in ((ru, u), (rv, v)):
    total += float(torch.from_numpy(reg).to(f.device)
                   @ torch.einsum('nd,nd->n', f, f))
  return total


def phase_ials_slice(matrix, device='cuda'):
  import torch
  from recoder_tpu_torch.data import UsersInteractions
  from recoder_tpu_torch.models import IALS
  from recoder_tpu_torch.ops import spd

  model = IALS(device=device, **IALS_FULL)
  sweeps = IALS_FULL['sweeps']
  n_user_chunks, n_item_chunks = ials_chunks(model, matrix)
  objectives, sweep_s, objective_s = {}, [], [0.0]
  clock = [0.0]

  def tick(sweep):
    torch.cuda.synchronize()
    sweep_s.append(time.time() - clock[0])
    if sweep in (0, sweeps - 1):
      t0 = time.time()
      # (the library's host objective takes ~14 s at this size; phase 9
      # holds this version against it on the fixture)
      objectives[sweep] = ials_objective(model, matrix)
      objective_s[0] += time.time() - t0
    clock[0] = time.time()

  spd.LAUNCHES['spd_solve'] = 0
  t0 = clock[0] = time.time()
  model.fit(matrix, callback=tick)
  torch.cuda.synchronize()
  fit_s = time.time() - t0 - objective_s[0]
  launches = spd.LAUNCHES['spd_solve']
  expected = sweeps * (n_user_chunks + n_item_chunks) + n_user_chunks
  say(f'  fit: {fit_s:.3f} s without the objective (plan build and '
      f'final user half-sweep included); sweeps '
      + ', '.join(f'{t:.3f}' for t in sweep_s) + ' s')
  say(f'  objective after sweep 1: {objectives[0]:.6g}, after sweep '
      f'{sweeps}: {objectives[sweeps - 1]:.6g} (float64 on the card, '
      f'{objective_s[0]:.1f} s)')
  if not objectives[sweeps - 1] < objectives[0]:
    raise AssertionError(f'objective did not fall: {objectives}')
  say(f'  spd_solve launches: {launches} ({n_user_chunks} user and '
      f'{n_item_chunks} item chunks per half-sweep)')
  if launches != expected:
    raise AssertionError(f'{launches} kernel launches, expected one per '
                         f'chunk per half-sweep: {expected}')
  for name in ('user_factors', 'item_factors'):
    if not torch.isfinite(getattr(model, name)).all():
      raise AssertionError(f'non-finite {name}')

  users = np.linspace(0, matrix.shape[0] - 1, 500).astype(np.int64)
  ui = UsersInteractions(users, matrix[users])
  t0 = time.time()
  x = model.fold_in(ui)
  torch.cuda.synchronize()
  fold_s = time.time() - t0
  if not torch.equal(x, model.user_factors[torch.from_numpy(users).to(
      device)]):
    raise AssertionError('fold-in of training users is not bitwise their '
                         'stored factors')
  t0 = time.time()
  recs = model.recommend(ui, 100)
  rec_s = time.time() - t0
  check_recommendations(recs, ui.interactions_matrix, 100, matrix.shape[1])
  with tempfile.TemporaryDirectory() as tmp:
    path = model.save(os.path.join(tmp, 'ials.model'))
    restored = IALS(device=device).load(path)
  recs2 = restored.recommend(ui, 100)
  if not all(np.array_equal(p, q) for p, q in zip(recs, recs2)):
    raise AssertionError('recommendations changed across the checkpoint')
  say(f'  fold-in of 500 training users: bitwise their stored factors '
      f'({fold_s:.3f} s); recommend k=100: in range, unseen, no repeats '
      f'({rec_s:.3f} s), identical after save -> load')
  return launches, n_user_chunks + n_item_chunks, fit_s, sweep_s


# -- phase 9 ---------------------------------------------------------------

def phase_ials_quality(train_m, val_m, device='cuda'):
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
  from recoder_tpu_torch.models import IALS
  from recoder_tpu_torch.models import ials as ials_lib
  from recoder_tpu_torch.ops import spd
  from recoder_tpu_torch.recommender import InferenceRecommender

  val_ds = RecommendationDataset(val_m, train_m)
  metrics = [Recall(k=20), NDCG(k=100)]

  def evaluate(model):
    ev = RecommenderEvaluator(InferenceRecommender(model, 100), metrics)
    res = ev.evaluate(val_ds, batch_size=500)
    return {str(m): float(np.mean(v)) for m, v in res.items()}

  before = spd.LAUNCHES['spd_solve']
  t0 = time.time()
  model = IALS(device=device, **IALS_FIXTURE).fit(train_m)
  torch.cuda.synchronize()
  fit_s = time.time() - t0
  if spd.LAUNCHES['spd_solve'] == before:
    raise AssertionError('the fixture fit did not launch the kernel')
  host, card = model.objective(train_m), ials_objective(model, train_m)
  if not abs(card - host) <= 1e-9 * abs(host):
    raise AssertionError(f'objective on the card {card} vs the library\'s '
                         f'host version {host}')
  say(f'  objective {host:.10g} (host) vs {card:.10g} (phase 8\'s, on the '
      'card)')
  means = evaluate(model)
  say(f'  kernel: fit {fit_s:.2f} s; ' + ', '.join(
      f'{k} {v:.4f} (floor {IALS_FLOORS[k]})' for k, v in means.items()))
  with tempfile.TemporaryDirectory() as tmp:
    path = model.save(os.path.join(tmp, 'ials.model'))
    means2 = evaluate(IALS(device=device).load(path))
  if means2 != means:
    raise AssertionError(f'metrics changed across the checkpoint: {means} '
                         f'vs {means2}')
  short = {k: v for k, v in means.items() if not v > IALS_FLOORS[k]}
  if short:
    raise AssertionError(f'iALS fixture quality below the floors: {short}')
  say('  checkpoint reload: identical metrics')

  blocked = functools.partial(ials_lib.spd_solve, impl='blocked')
  with mock.patch.object(ials_lib, 'spd_solve', blocked):
    launches = spd.LAUNCHES['spd_solve']
    plain = IALS(device=device, **IALS_FIXTURE).fit(train_m)
    plain_means = evaluate(plain)
    if spd.LAUNCHES['spd_solve'] != launches:
      raise AssertionError('the plain-route fit launched the kernel')
  diff = {name: float((getattr(model, name) - getattr(plain, name))
                      .abs().max() / getattr(plain, name).abs().max())
          for name in ('user_factors', 'item_factors')}
  say(f'  blocked recursion on the card: ' + ', '.join(
      f'{k} {v:.4f}' for k, v in plain_means.items())
      + '; kernel vs plain factors, max abs diff / max |plain|: '
      + ', '.join(f'{k} {v:.3g}' for k, v in diff.items()))
  return means


# -- phase 10 --------------------------------------------------------------

def scatter_case(N, d, W, device, seed=0, ntables=3, dtypes=None):
  """Tables, ids and rows drawn on the card from a generator seeded with
  ``seed``; a repeated id gets the same payload (the kernel's
  contract). ``dtypes``: each table's (and its rows') dtype, float32 by
  default."""
  import torch
  gen = torch.Generator(device=device)
  gen.manual_seed(seed)
  tables = [torch.randn((N, d), generator=gen, device=device)
            for _ in range(ntables)]
  ids = torch.randint(0, N, (W,), generator=gen, device=device)
  rows = [torch.randn((N, d), generator=gen, device=device)[ids]
          for _ in range(ntables)]
  if dtypes is not None:
    tables = [t.to(dt) for t, dt in zip(tables, dtypes)]
    rows = [r.to(dt) for r, dt in zip(rows, dtypes)]
  return tables, ids, rows


def check_scatter(tables, ids, rows, what):
  """The kernel on copies of ``tables`` against index_copy_, bitwise;
  untouched rows and data pointers unchanged. Returns the max abs
  difference (0.0)."""
  import torch
  from recoder_tpu_torch.ops import row_scatter as rs
  kernel = [t.clone() for t in tables]
  plain = [t.clone() for t in tables]
  ptrs = [t.data_ptr() for t in kernel]
  rs.row_scatter_kernel(kernel, ids, rows)
  rs.row_scatter_plain(plain, ids, rows)
  torch.cuda.synchronize()
  err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
            for a, b in zip(kernel, plain))
  untouched = torch.ones(tables[0].shape[0], dtype=torch.bool,
                         device=ids.device)
  untouched[ids] = False
  same = all(torch.equal(a, b) for a, b in zip(kernel, plain))
  kept = all(torch.equal(a[untouched], t[untouched])
             for a, t in zip(kernel, tables))
  if not (same and kept and [t.data_ptr() for t in kernel] == ptrs):
    raise AssertionError(f'row_scatter {what}: differs from index_copy_ '
                         f'(max abs {err}) or touched other rows')
  return err


def phase_scatter(msd_ids, device='cuda', d=200):
  import torch
  from recoder_tpu_torch.ops import row_scatter as rs
  worst = 0.0
  for N in SCATTER_NS:
    for dd in SCATTER_DS:
      for W in SCATTER_WS:
        worst = max(worst, check_scatter(
            *scatter_case(N, dd, W, device, seed=N + dd + W),
            f'[{N}, {dd}] W={W}'))
  base, ids, rows = scatter_case(41216, 201, 37, device, seed=4, ntables=1)
  sliced = [base[0][:, 1:201]]
  rows = [rows[0][:, 1:201].contiguous()]
  if rs.vector_path(sliced, rows):
    raise AssertionError('a misaligned column slice took the 16-byte path')
  worst = max(worst, check_scatter(sliced, ids, rows, 'column slice'))
  say(f'  ragged N x d x W ({len(SCATTER_NS)} x {len(SCATTER_DS)} x '
      f'{len(SCATTER_WS)}, three tables) and a misaligned column slice: '
      'bitwise equal to index_copy_, untouched rows and pointers kept')

  # the MSD shape: three tables, the ids of one block union, and the same
  # ids with a sentinel tail of identical payloads (the JAX layout)
  rng = np.random.default_rng(11)
  N = 41216
  tables = [torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
            .to(device) for _ in range(3)]
  ids = torch.from_numpy(msd_ids.astype(np.int64)).to(device)
  rows = [torch.from_numpy(rng.standard_normal((len(msd_ids), d))
                           .astype(np.float32)).to(device) for _ in range(3)]
  if not rs.vector_path(tables, rows):
    raise AssertionError('the MSD shape did not take the 16-byte path')
  worst = max(worst, check_scatter(tables, ids, rows, 'MSD shape'))
  tail = torch.cat([ids, torch.full((64,), 41140, device=device)])
  tail_rows = [torch.cat([r, r[-1:].expand(64, d)]) for r in rows]
  worst = max(worst, check_scatter(tables, tail, tail_rows,
                                   'sentinel-duplicate tail'))

  def plain():
    for t, r in zip(tables, rows):
      t.index_copy_(0, ids, r)

  def kernel():
    rs.row_scatter_kernel(tables, ids, rows)

  # before each timed call, a read of 256 MB (five times L2) writes the
  # last call's rows back to HBM and leaves L2 clean and cold; its
  # reduction kernel is not counted
  sweep = torch.ones(2 ** 26, device=device)

  def evict():
    sweep.sum()

  times = {name: device_ms(fn, between=evict, skip='reduce_kernel')
           for name, fn in (('kernel', kernel), ('plain', plain))}
  wall = {'kernel': per_launch_ms(kernel), 'plain': per_launch_ms(plain)}
  moved = 3 * 2 * len(msd_ids) * d * 4
  say(f'  MSD shape: three [{N}, {d}] tables, {len(msd_ids)} ids: bitwise '
      f'(also with a 64-slot sentinel tail); device time a call from a '
      f'cold L2 (profiler, 20 calls) kernel {times["kernel"]:.4f} ms '
      f'({moved / times["kernel"] / 1e6:.1f} GB/s), index_copy_ x3 '
      f'{times["plain"]:.4f} ms; CUDA-event time a call (median of 10 x 20 '
      f'back to back, host included) {wall["kernel"]:.4f} / '
      f'{wall["plain"]:.4f} ms')
  return worst, times


# -- phase 11 --------------------------------------------------------------

#: spin kernels that open a counting profiler window (settle_profiler)
MARKERS = 64


def settle_profiler():
  """Opens a profiler window whose kernels are counted: a pause on the
  host, then ``MARKERS`` spin kernels of ~10 us each, waited for. The
  profiler loses the first device events of a window, the more the more
  windows the process has opened (none of 16 markers in the first window
  of a run, 12 of 16 in its last; before the markers, phase 20's first
  MSD step lost its row fetch), so what the window counts starts after
  these; :func:`markers_seen` says how many of them it kept."""
  import torch
  torch.cuda.synchronize()
  time.sleep(0.05)
  for _ in range(MARKERS):
    torch.cuda._sleep(20000)
  torch.cuda.synchronize()


def markers_seen(events):
  """How many of :func:`settle_profiler`'s spin kernels a profile kept."""
  return sum(ev.count for ev in events if 'spin_kernel' in ev.key)


def device_rows(events):
  """``(device ms, launches, name)`` of each kernel of a profile's
  ``key_averages()`` (CPU and CUDA activity), largest first, without
  settle_profiler's markers. A range annotation (e.g. Optimizer.step) is
  mirrored on the device timeline over the kernels it launched: the
  kernels alone are counted."""
  on_device = [ev for ev in events if 'CUDA' in str(ev.device_type)]
  host_keys = {ev.key for ev in events if ev not in on_device}
  return sorted(((getattr(ev, 'self_device_time_total', 0) / 1e3,
                  ev.count, ev.key) for ev in on_device
                 if ev.key not in host_keys
                 and 'spin_kernel' not in ev.key), reverse=True)


def profile_steps(trainer, dataset, train_kw, steps=16, spc=1,
                  kernels=(), routes=()):
  """torch.profiler over ``steps`` training steps dispatched as ``train``
  dispatches them (``fused_steps_per_call=spc``: one eager step a
  dispatch, or replays of captured blocks), from a fresh epoch: the top
  device kernels and the device-idle share of the window; returns the
  wall and device ms and the kernel launches a step, and the launches of
  each of ``kernels`` (expected once a step: the window's kernels are
  printed where one is not) and of ``routes`` by name."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    settle_profiler()
    t0 = time.time()
    trainer.train(dataset, num_epochs=trainer.current_epoch,
                  iters_per_epoch=steps, fused_steps_per_call=spc,
                  **train_kw)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
  if len(trainer.last_epoch_losses) != steps:
    raise AssertionError(f'the profiled window ran '
                         f'{len(trainer.last_epoch_losses)} steps')
  events = prof.key_averages()
  rows = device_rows(events)
  busy = sum(r[0] for r in rows)
  launches = sum(r[1] for r in rows) / steps
  # (a name may be a tuple of alternatives: either route's kernel)
  counts = {name: sum(count for _, count, key in rows
                      if any(n in key for n in (
                          name if isinstance(name, tuple) else (name,))))
            for name in (*kernels, *routes)}
  if any(counts[name] != steps for name in kernels):
    say(f'  (kernels of the window, by count: '
        f'{sorted((count, key[:60]) for _, count, key in rows)})')
  say(f'  profile of {steps} steps, {trainer.last_epoch_dispatch} '
      f'({trainer.last_epoch_dispatches} dispatches; {markers_seen(events)}'
      f' of {MARKERS} opening markers kept): wall {wall_ms:.3f} ms '
      f'({wall_ms / steps:.3f} ms/step under the profiler, epoch start and '
      f'end included), device kernels {busy:.3f} ms ({busy / steps:.3f} '
      f'ms/step, {launches:.1f} launches a step), device idle '
      f'{100 * (1 - busy / wall_ms):.1f}% of the profiled window')
  for ms, count, key in rows[:12]:
    say(f'    {ms:9.3f} ms  {count:5d}x  {key[:90]}')
  return wall_ms / steps, busy / steps, launches, counts


def phase_sparse_slice(matrix, device='cuda', epochs_timed=1):
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import row_scatter as rs

  dataset = RecommendationDataset(matrix)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                       sparse=True),
                    optimizer_type='adam', loss='logloss', device=device)
  torch.cuda.reset_peak_memory_stats()
  rs.LAUNCHES['row_scatter'] = 0
  t0 = time.time()
  trainer.train(dataset, num_epochs=1, fused_steps_per_call=1, **MSD_TRAIN)
  torch.cuda.synchronize()
  first_call_s = time.time() - t0
  launches = rs.LAUNCHES['row_scatter']

  steps = -(-matrix.shape[0] // 500)
  losses = np.asarray(trainer.last_epoch_losses)
  if len(losses) != steps:
    raise AssertionError(f'epoch ran {len(losses)} steps, not {steps}')
  if launches != 2 * steps:
    raise AssertionError(f'{launches} row-scatter launches in {steps} steps,'
                         ' expected 2 a step')
  if not np.all(np.isfinite(losses)):
    raise AssertionError('non-finite training loss')
  widths = np.diff(trainer.fused_data_source._block_unions()['ptr'])
  epoch_rate = steps / trainer.last_epoch_seconds
  say(f'  epoch 1: {steps} steps in {trainer.last_epoch_seconds:.3f} s = '
      f'{epoch_rate:.2f} user-batches/s (first call {first_call_s:.1f} s '
      f'with the block-union build); mean loss {losses.mean():.4f}; '
      f'{launches} row-scatter launches')
  say(f'  union widths: mean {widths.mean():.1f}, min {widths.min()}, max '
      f'{widths.max()} over {len(widths)} blocks')

  rates, means = [], [float(losses.mean())]
  for epoch in range(2, epochs_timed + 2):
    trainer.train(dataset, num_epochs=epoch, fused_steps_per_call=1,
                  **MSD_TRAIN)
    rates.append(len(trainer.last_epoch_losses)
                 / trainer.last_epoch_seconds)
    means.append(float(np.mean(trainer.last_epoch_losses)))
  if not (np.all(np.isfinite(means)) and means[-1] < means[0]):
    raise AssertionError(f'the epoch loss did not fall: {means}')
  peak = torch.cuda.max_memory_allocated() / 2**30
  say(f'  steady epochs: msd_user_batches_per_sec '
      f'{", ".join(f"{r:.2f}" for r in rates)}; epoch mean loss '
      + ' -> '.join(f'{m:.4f}' for m in means)
      + f'; peak device memory {peak:.2f} GiB')
  step_ms, busy_ms, _, _ = profile_steps(trainer, dataset, MSD_TRAIN,
                                         steps=10)
  steady_ms = 1e3 / max(rates)
  say(f'  steady step {steady_ms:.3f} ms without the profiler: the device '
      f'idle ~{100 * (1 - busy_ms / steady_ms):.1f}% of it')

  users, _ = dataset[np.arange(500)]
  recs = trainer.recommend(users, 100)
  check_recommendations([np.asarray(r) for r in recs],
                        users.interactions_matrix, 100, matrix.shape[1])
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'msd'))
    restored = Recoder(DynamicAutoencoder(sparse=True), device=device)
    restored.init_from_model_file(path)
    recs2 = restored.recommend(users, 100)
  if recs != recs2:
    raise AssertionError('recommendations changed across the checkpoint')
  say('  recommend k=100 for 500 users: in range, unseen, no repeats, '
      'identical after save_state -> init_from_model_file')
  return launches, epoch_rate, rates, step_ms, busy_ms, widths


# -- phase 12 --------------------------------------------------------------

def phase_union_paths(train_m, msd_width, device='cuda', steps=20):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  from recoder_tpu_torch.ops import row_scatter as rs
  from recoder_tpu_torch.ops.losses import MSELoss

  dataset = RecommendationDataset(train_m)
  paths = {
      'full decode': (False, 'mse', True),
      'dense union, kernel': (False, 'mse', False),
      'dense union, plain': (False, MSELoss(confidence=3, reduction='sum'),
                             False),
      'sparse': (True, 'mse', False),
  }
  losses, counts = {}, {}
  for name, (sparse, loss, fd) in paths.items():
    trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.0,
                                         sparse=sparse),
                      optimizer_type='adam', loss=loss,
                      loss_params={'confidence': 3} if loss == 'mse'
                      else None, device=device)
    for k in fdl.LAUNCHES:
      fdl.LAUNCHES[k] = 0
    rs.LAUNCHES['row_scatter'] = 0
    # (one eager step a dispatch: the counters do not see inside a graph)
    trainer.train(dataset, batch_size=500, lr=1e-3, weight_decay=2e-5,
                  negative_sampling=True, shuffle='users', num_epochs=1,
                  iters_per_epoch=steps, full_decode=fd,
                  fused_steps_per_call=1)
    counts[name] = {**fdl.LAUNCHES, **rs.LAUNCHES}
    losses[name] = np.asarray(trainer.last_epoch_losses)
    if len(losses[name]) != steps or not np.all(np.isfinite(losses[name])):
      raise AssertionError(f'{name}: {losses[name]}')
  ref = losses['full decode']
  rel = {name: np.abs(l - ref) / np.abs(ref) for name, l in losses.items()}
  for name in ('dense union, kernel', 'dense union, plain'):
    if not np.all(rel[name] <= PATHS_RTOL):
      raise AssertionError(f'{name} vs full decode: max rel '
                           f'{rel[name].max()} ({losses[name]} vs {ref})')
  sp_l = losses['sparse']
  if not (rel['sparse'][0] <= PATHS_RTOL
          and sp_l[-5:].mean() < sp_l[:5].mean()):
    raise AssertionError(f'sparse: first step rel {rel["sparse"][0]}, '
                         f'losses {sp_l}')
  want = {'dense union, kernel': ('fused_decode_loss_fwd', steps),
          'sparse': ('row_scatter', 2 * steps)}
  for name, (kernel, n) in want.items():
    if counts[name][kernel] != n:
      raise AssertionError(f'{name}: {counts[name]}')
  if counts['dense union, plain']['fused_decode_loss_fwd']:
    raise AssertionError('the plain MSELoss path launched the kernel')
  for name in paths:
    say(f'  {name:20s}: loss {losses[name][0]:.5f} -> {losses[name][-1]:.5f}'
        f', max rel vs full decode {rel[name].max():.3g} (step 1 '
        f'{rel[name][0]:.3g}); launches {counts[name]}')
  times = time_kernel(500, 200, msd_width, 'mse', 3.0, device)
  report_times(times, (500, 200, msd_width),
               f'mse c=3 [500, 200, {msd_width}] (an MSD union)')
  return rel, times


# -- phase 13 --------------------------------------------------------------

def phase_sparse_quality(train_m, val_m, device='cuda', epochs=30,
                         atol=0.01):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  train_ds = RecommendationDataset(train_m)
  val_ds = RecommendationDataset(val_m, train_m)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                       sparse=True),
                    optimizer_type='adam', loss='logloss', device=device)
  t0 = time.time()
  trainer.train(train_ds, batch_size=500, lr=1e-3, weight_decay=2e-5,
                num_epochs=epochs, negative_sampling=True, shuffle='users')
  train_s = time.time() - t0
  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]

  def evaluate(tr):
    res = tr._evaluate(val_ds, 100, metrics, batch_size=500)
    return {str(m): float(np.mean(v)) for m, v in res.items()}

  means = evaluate(trainer)
  say(f'  {epochs} epochs in {train_s:.1f} s; '
      + ', '.join(f'{k} {v:.4f} (pinned {PINNED[k]})'
                  for k, v in means.items()))
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'sparse'))
    for sparse in (True, False):
      restored = Recoder(DynamicAutoencoder(sparse=sparse), device=device)
      restored.init_from_model_file(path)
      again = evaluate(restored)
      if again != means:
        raise AssertionError(f'metrics changed across the checkpoint into '
                             f'a {"sparse" if sparse else "dense"} model: '
                             f'{means} vs {again}')
  misses = {k: v for k, v in means.items() if abs(v - PINNED[k]) > atol}
  if misses:
    raise AssertionError(f'quality outside atol {atol} of the pinned '
                         f'values: {misses}')
  say('  checkpoint reload into a sparse and a dense model: identical '
      'metrics')
  return means


# -- phase 14 --------------------------------------------------------------

def adam_problem(shapes, device, seed=0, storage=None):
  """Parameters, gradients and moments at training-like magnitudes, in
  ``storage`` = (parameter and gradient dtype, moment dtype), by default
  float32 and bf16; weight decay 2e-5 on the matrices, 0 on the biases
  (the 1-D tensors)."""
  import torch
  p_dtype, m_dtype = storage or (torch.float32, torch.bfloat16)
  gen = torch.Generator(device=device).manual_seed(seed)

  def draw(shape, scale, fn=torch.randn):
    return scale * fn(shape, device=device, generator=gen)

  params = [draw(sh, 0.05).to(p_dtype) for sh in shapes]
  grads = [draw(sh, 1e-3).to(p_dtype) for sh in shapes]
  ms = [draw(sh, 1e-4).to(m_dtype) for sh in shapes]
  vs = [draw(sh, 1e-6, torch.rand).to(m_dtype) for sh in shapes]
  wds = [0.0 if len(sh) == 1 else 2e-5 for sh in shapes]
  return params, grads, ms, vs, wds


def check_adam(shapes, device, steps=5, storage=None):
  """Five steps through the kernel and through its plain version from the
  same state and gradients (``storage``: see :func:`adam_problem`): a
  bf16 buffer within 1 bf16 ulp, a float32 one within 2 float32 ulps;
  returns the largest abs difference of p, m and v."""
  import torch
  from recoder_tpu_torch.ops import adam
  params, grads, ms, vs, wds = adam_problem(shapes, device, storage=storage)
  kernel = [[x.clone() for x in xs] for xs in (params, ms, vs)]
  for step in range(1, steps + 1):
    sc = adam.step_scalars(1e-3, step, (0.9, 0.999), 1e-8)
    adam.adam_bf16_kernel(kernel[0], grads, kernel[1], kernel[2], wds, sc)
    adam.adam_bf16_plain(params, grads, ms, vs, wds, sc)
  torch.cuda.synchronize()
  err = 0.0
  for got, ref in ((kernel[0], params), (kernel[1], ms), (kernel[2], vs)):
    for a, b in zip(got, ref):
      ulp = 'bf16' if b.dtype == torch.bfloat16 else None
      if a.dtype != b.dtype:
        raise AssertionError(f'adam kernel: {a.dtype} against {b.dtype}')
      a, b = a.float(), b.float()
      diff = (a - b).abs()
      err = max(err, float(diff.max()))
      eps = 2.0 ** -7 if ulp else 2 * torch.finfo(torch.float32).eps
      # one bf16 ulp: 2^-7 of the value's power of two; p: 2 float32 ulps
      scale = (torch.exp2(torch.floor(torch.log2(b.abs().clamp(
          min=2.0 ** -126)))) if ulp else b.abs())
      if not bool((diff <= eps * scale).all()):
        raise AssertionError(f'adam kernel {tuple(a.shape)}: differs from '
                             f'the plain version beyond tolerance (max abs '
                             f'{float(diff.max())})')
  return err


def time_adam(shapes, device, storage=None):
  """Device ms of one step over the parameter set: the kernel, its plain
  version and, as another function's yardstick, torch.optim.Adam(fused=
  True) on float32 state (two groups: decay and no decay), in turns."""
  import torch
  from recoder_tpu_torch.ops import adam
  params, grads, ms, vs, wds = adam_problem(shapes, device, seed=1,
                                            storage=storage)
  sc = adam.step_scalars(1e-3, 10, (0.9, 0.999), 1e-8)
  leaves = [torch.nn.Parameter(p.float()) for p in params]
  for leaf, g in zip(leaves, grads):
    leaf.grad = g.float()
  fused = torch.optim.Adam(
      [{'params': [x for x, w in zip(leaves, wds) if w], 'weight_decay': 2e-5},
       {'params': [x for x, w in zip(leaves, wds) if not w],
        'weight_decay': 0.0}], lr=1e-3, fused=True)
  steps = {'kernel': lambda: adam.adam_bf16_kernel(params, grads, ms, vs,
                                                   wds, sc),
           'plain': lambda: adam.adam_bf16_plain(params, grads, ms, vs, wds,
                                                 sc),
           'torch.optim.Adam(fused=True), float32 state': fused.step}
  runs = {name: [] for name in steps}
  for name in ('plain', 'kernel', 'torch.optim.Adam(fused=True), float32 '
               'state', 'kernel', 'plain'):
    runs[name].append(device_ms(steps[name]))
  return {name: statistics.mean(v) for name, v in runs.items()}


def phase_bf16_kernels(device='cuda', ragged=(37, 24, 1000),
                       full=(500, 200, 20224), union=(500, 200, 18117),
                       aligned=(480, 200, 18120), ragged_adam=1_000_003):
  import torch
  cases = [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]
  errs = {'mma': [], 'wgmma': []}
  for shape, route in ((ragged, 'mma'), (union, 'mma'), (full, 'wgmma'),
                       (aligned, 'wgmma')):
    for kind, c in cases:
      *err, first = compare_kernel(*shape, kind, c, device, torch.bfloat16,
                                   'bfloat16', route)
      *_, again = compare_kernel(*shape, kind, c, device, torch.bfloat16,
                                 'bfloat16', route)
      if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f'{kind} c={c} {shape} ({route}): two runs '
                             'differ')
      errs[route].append(err)
  say('  two runs of each case bitwise equal')
  times = time_kernel(*full, 'mse', 3.0, device, 'bfloat16', torch.bfloat16,
                      routes=('wgmma', 'mma'))
  report_times(times, full, f'bf16 mse c=3 {list(full)}', target_bytes=2,
               bf16=True)
  errs = {r: (max(e[0] for e in v), max(e[1] for e in v))
          for r, v in errs.items()}
  adam_err = max(check_adam(ML20M_PARAM_SHAPES, device),
                 check_adam(((ragged_adam,),), device))
  n = sum(int(np.prod(sh)) for sh in ML20M_PARAM_SHAPES)
  say(f'  adam kernel vs plain, 5 steps over the ML-20M parameter set ({n:,} '
      f'parameters) and a ragged length {ragged_adam:,}: max abs diff '
      f'{adam_err:.3g} (m, v within 1 bf16 ulp, p within 2 float32 ulps)')
  adam_times = time_adam(ML20M_PARAM_SHAPES, device)
  adam_bound = bound(0.0, 20.0 * n)
  say('  adam step, device time: ' + ', '.join(
      f'{k} {v:.4f} ms' for k, v in adam_times.items())
      + f'; bound {adam_bound[0]:.4f} ms ({adam_bound[1]}: 20 B a parameter);'
      f' kernel at {100 * adam_bound[0] / adam_times["kernel"]:.1f}% of it')
  return times, errs, adam_err, adam_times, adam_bound


# -- phase 17 --------------------------------------------------------------

def packed_slab(n_rows, n_words, device, seed=0):
  """Random int32 words with bit 31 set in every fourth one; the last row
  is zero (the pad users' row)."""
  import torch
  rng = np.random.default_rng(seed)
  words = rng.integers(0, 2 ** 32, (n_rows, n_words), dtype=np.uint64)
  words[:, ::4] |= np.uint64(1 << 31)
  words[-1] = 0
  return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)


def check_packed(packed, num_items, what, **fetch):
  """The kernel against its plain version, bitwise."""
  import torch
  from recoder_tpu_torch.ops import packed_rows as pr
  got = pr.unpack_rows_kernel(packed, num_items, **fetch)
  ref = pr.unpack_rows_plain(packed, num_items, **fetch)
  torch.cuda.synchronize()
  if not all(a.dtype == b.dtype and torch.equal(a, b)
             for a, b in zip(got, ref)):
    raise AssertionError(f'packed_rows {what}: differs from the plain '
                         'version')


def packed_bytes(B, n_words, indexed=False):
  """What one fetch must move: the rows' words (and the index) read once,
  the bf16 rows and the float32 column mask written once."""
  W = 32 * n_words
  return 4.0 * B * n_words + 8.0 * B * indexed + 2.0 * B * W + 4.0 * W


def phase_packed_kernel(device='cuda', shape=(500, 1288)):
  import torch
  from recoder_tpu_torch.kernels import BUILD_LOGS
  from recoder_tpu_torch.ops import packed_rows as pr
  pr._lib()
  log = BUILD_LOGS.get('packed_rows', '')
  frames = ptxas_frames(log)
  if len(frames) < 3 or any(v[1] or v[2] for v in frames.values()):
    raise AssertionError(f'packed_rows: register spills, or no ptxas report: '
                         f'{frames}')
  for func, (stack, stores, loads) in sorted(frames.items()):
    kernel = ('col_mask_kernel' if 'col_mask' in func else
              'packed_rows_kernel<indexed>' if 'ILb1' in func else
              'packed_rows_kernel<contiguous>')
    say(f'  {kernel}: {ptxas_registers(log, func)} registers, stack frame '
        f'{stack} B, spill stores {stores} B, spill loads {loads} B')

  cases = 0
  for B in PACKED_BATCHES:
    for n_words in PACKED_WORDS:
      n_rows = 2 * B + 3
      packed = packed_slab(n_rows, n_words, device, seed=B + n_words)
      rng = np.random.default_rng(n_words)
      index = rng.integers(0, n_rows + 40, B).astype(np.int64)
      index[-1] = n_rows + 100  # a pad user past the slab
      index = torch.from_numpy(index).to(device)
      for num_items in (32 * n_words - 7, 32 * n_words):
        what = f'[{B}, {n_words} words] num_items {num_items}'
        check_packed(packed, num_items, what + ' last block',
                     start=n_rows - B, count=B)
        check_packed(packed, num_items, what + ' gather', index=index)
        cases += 2
  say(f'  {cases} fetches (B in {PACKED_BATCHES} x words in {PACKED_WORDS} '
      'x 2 catalogs, the last block and a gather with pad users, bit 31 '
      'in every fourth word): bitwise equal to the plain version')
  cases = 0
  for B in PACKED_MEGAS:
    for n_words in PACKED_WORDS + (632,):
      n_rows = B + 3
      packed = packed_slab(n_rows, n_words, device, seed=B * n_words)
      rng = np.random.default_rng(B)
      index = rng.integers(0, n_rows + 40, B).astype(np.int64)
      index[-1] = n_rows + 100
      index = torch.from_numpy(index).to(device)
      for fetch in (dict(index=index), dict(start=n_rows - B, count=B)):
        got = pr.unpack_mask_kernel(packed, 32 * n_words - 7, **fetch)
        ref = pr.unpack_mask_plain(packed, 32 * n_words - 7, **fetch)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
          raise AssertionError(f'packed_rows mask-only [{B}, {n_words} words]'
                               f' {list(fetch)}: differs from the plain '
                               'version')
        cases += 1
  say(f'  {cases} mask-only launches (a mega\'s loss columns, no row '
      f'written; B in {PACKED_MEGAS} x words in {PACKED_WORDS + (632,)}, '
      'gather and contiguous): bitwise equal to the plain version')

  B, n_words = shape
  packed = packed_slab(8 * B, n_words, device, seed=7)
  num_items = 41140
  start = 3 * B
  index = torch.randperm(8 * B, device=device)[:B].contiguous()
  check_packed(packed, num_items, 'timing shape', start=start, count=B)
  # before each timed call, a read of 256 MB (five times L2) leaves L2
  # cold, as a step finds its slab rows; its reduction kernel is not
  # counted
  sweep = torch.ones(2 ** 26, device=device)
  fns = {
      'kernel': lambda: pr.unpack_rows_kernel(packed, num_items, start=start,
                                              count=B),
      'plain': lambda: pr.unpack_rows_plain(packed, num_items, start=start,
                                            count=B),
      'kernel, gather': lambda: pr.unpack_rows_kernel(packed, num_items,
                                                      index=index)}
  runs = {name: [] for name in fns}
  for name in ('plain', 'kernel', 'kernel, gather', 'kernel', 'plain'):
    runs[name].append(device_ms(fns[name], between=sweep.sum,
                                skip='reduce_kernel'))
  times = {name: statistics.mean(v) for name, v in runs.items()}
  nbytes = packed_bytes(B, n_words)
  b_ms, by = bound(0.0, nbytes)
  say(f'  [{B}, {n_words} words] from a cold L2, device time (profiler, 20 '
      f'calls, in turns): kernel {times["kernel"]:.4f} ms (gather '
      f'{times["kernel, gather"]:.4f}), plain {times["plain"]:.4f} ms; bound '
      f'{b_ms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB); kernel at '
      f'{100 * b_ms / times["kernel"]:.1f}% of it')

  # the mask-only launch at a mega of 2,000 gathered rows (phase 26's)
  M = PACKED_MEGAS[-1]
  mega = torch.randperm(8 * B, device=device)[:M].contiguous()
  mask_fns = {
      'mask kernel': lambda: pr.unpack_mask_kernel(packed, num_items,
                                                   index=mega),
      'mask plain': lambda: pr.unpack_mask_plain(packed, num_items,
                                                 index=mega)}
  runs = {name: [] for name in mask_fns}
  for name in ('mask plain', 'mask kernel', 'mask kernel', 'mask plain'):
    runs[name].append(device_ms(mask_fns[name], between=sweep.sum,
                                skip='reduce_kernel'))
  times.update({name: statistics.mean(v) for name, v in runs.items()})
  mask_bytes = 4.0 * M * n_words + 8.0 * M + 4.0 * 32 * n_words
  times['mask bound'] = bound(0.0, mask_bytes)[0]
  say(f'  mask-only [{M} gathered rows, {n_words} words] from a cold L2, '
      f'device time (in turns): kernel {times["mask kernel"]:.4f} ms, plain '
      f'{times["mask plain"]:.4f} ms; bound {times["mask bound"]:.4f} ms '
      f'(bytes: {mask_bytes / 1e6:.2f} MB); kernel at '
      f'{100 * times["mask bound"] / times["mask kernel"]:.1f}% of it')
  return times, (b_ms, by)


# -- phase 18 --------------------------------------------------------------

def phase_msd_dense(msd, train_m, device='cuda', epochs_timed=1):
  """bench.py's MSD default through the port, then the packed and dense
  tiers' trajectories on the fixture."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  dataset = RecommendationDataset(msd)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                       compute_dtype='bfloat16'),
                    optimizer_type='adam', loss='logloss', device=device,
                    opt_state_dtype='bfloat16')
  free, _ = torch.cuda.mem_get_info()
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated() / 2**30  # phase 15's cell
  reset_launches()
  t0 = time.time()
  # one eager dispatch a step, so that every launch is counted (phase 20
  # runs the cell captured)
  trainer.train(dataset, num_epochs=1, fused_steps_per_call=1,
                **MSD_DENSE_TRAIN)
  torch.cuda.synchronize()
  first_call_s = time.time() - t0
  counts = read_launches()
  steps = -(-msd.shape[0] // 500)
  kernels = ('packed_rows', 'adam_bf16')
  launches = {k: counts[k] for k in kernels}
  others = {k: v for k, v in counts.items() if k not in kernels and v}
  if any(v != steps for v in launches.values()) or others:
    raise AssertionError(f'{steps} steps launched {counts}: expected the '
                         'unpack and Adam kernels once a step, no other')

  source = trainer.fused_data_source
  W = trainer.model.num_items_padded
  union = source.union_width()
  widths = np.diff(source._block_unions()['ptr'])
  if not (W <= 4 * union and source.d_slab is not None
          and source._slab_width == W):
    raise AssertionError(f'full decode not chosen: padded catalog {W}, '
                         f'union width {union}')
  if not source._slab_packed:
    raise AssertionError("slab_cache='auto' did not choose the packed tier")
  slab_gib = source.d_slab.numel() * 4 / 2**30
  dense_gib = source.n_pad * W * 2 / 2**30
  budget_gib = source.SLAB_CACHE_MEMORY_FRACTION * free / 2**30
  losses = np.asarray(trainer.last_epoch_losses)
  if len(losses) != steps or not np.all(np.isfinite(losses)):
    raise AssertionError(f'epoch ran {len(losses)} steps, or a loss is not '
                         'finite')
  head, tail = losses[:10].mean(), losses[-10:].mean()
  if not tail < head:
    raise AssertionError(f'loss did not fall: first 10 steps {head}, last '
                         f'10 {tail}')
  epoch_rate = steps / trainer.last_epoch_seconds
  say(f'  full decode: padded catalog {W} <= 4 x union width {union} (block '
      f'unions: mean {widths.mean():.1f}, max {widths.max()}); '
      f"slab_cache='auto' chose the packed tier: {slab_gib:.2f} GiB against "
      f'a budget of {budget_gib:.2f} GiB (half the free memory before '
      f'the build), where the bf16 slab needs {dense_gib:.2f} GiB')
  say(f'  epoch 1: {steps} steps in {trainer.last_epoch_seconds:.3f} s = '
      f'{epoch_rate:.2f} user-batches/s (first call {first_call_s:.1f} s '
      f'with the block unions and the slab build); loss first 10 steps '
      f'{head:.4f}, last 10 {tail:.4f}; launches {launches}')
  rates = []
  for epoch in range(2, epochs_timed + 2):
    trainer.train(dataset, num_epochs=epoch, fused_steps_per_call=1,
                  **MSD_DENSE_TRAIN)
    rates.append(len(trainer.last_epoch_losses)
                 / trainer.last_epoch_seconds)
  peak = torch.cuda.max_memory_allocated() / 2**30
  say(f'  steady epochs (dense, packed slab, bf16, eager): '
      f'msd_user_batches_per_sec {", ".join(f"{r:.2f}" for r in rates)}; '
      f'peak device memory {peak - held:.2f} GiB (above the {held:.2f} GiB '
      "that phase 15's trainer holds for phase 20)")
  _, busy_ms, per_step, _ = profile_steps(trainer, dataset, MSD_DENSE_TRAIN)
  steady_ms = 1e3 / max(rates)
  say(f'  steady step {steady_ms:.3f} ms without the profiler: the device '
      f'idle ~{100 * (1 - busy_ms / steady_ms):.1f}% of it')
  cell = (trainer, dataset)
  del source

  # the packed and the dense tier from one seed: the same trajectory
  fixture = RecommendationDataset(train_m)
  for shuffle in ('blocks', 'users'):
    runs = {}
    for cache in ('packed', True):
      tr = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      compute_dtype='bfloat16'),
                   optimizer_type='adam', loss='logloss', device=device,
                   opt_state_dtype='bfloat16')
      tr.train(fixture, batch_size=500, lr=1e-3, weight_decay=2e-5,
               negative_sampling=True, shuffle=shuffle, num_epochs=1,
               iters_per_epoch=20, slab_cache=cache, full_decode=True)
      if tr.fused_data_source._slab_packed != (cache == 'packed'):
        raise AssertionError(f'slab_cache={cache!r} built the other tier')
      runs[cache] = (tr.last_epoch_losses, tr.model.params())
    (lp, pp), (ld, pd) = runs['packed'], runs[True]
    if len(lp) != 20 or lp != ld or not all(
        torch.equal(pp[k], pd[k]) for k in pp):
      raise AssertionError(f'{shuffle}: the packed and dense trajectories '
                           f'differ ({lp} vs {ld})')
    say(f'  fixture, 20 {shuffle} steps from the packed and the dense tier: '
        f'losses and parameters bitwise equal ({lp[0]:.5f} -> {lp[-1]:.5f})')
  return launches, epoch_rate, rates, (busy_ms, per_step, steady_ms), cell


# -- phase 19 --------------------------------------------------------------

def phase_packed_quality(train_m, val_m):
  """The tests/test_model.py packed row: bf16 compute and bf16 moments
  on the 1-bit slab."""
  return phase_quality(train_m, val_m, compute_dtype='bfloat16',
                       opt_state_dtype='bfloat16', reload_atol=1e-6,
                       slab_cache='packed')


# -- phase 20 --------------------------------------------------------------

#: the hand kernels of each captured cell, by the names in the profile
CELL_KERNELS = {
    # (each once a step, and either bf16 route's kernel once a step in
    # all: the mma.sync set never)
    'ml20m': ('decode_loss_fwd_bf16_wgmma_kernel',
              'drows_dbias_bf16_wgmma_kernel', 'dh_bf16_wgmma_kernel',
              'adam_bf16_kernel', 'decode_loss_fwd_bf16', 'drows_dbias_bf16',
              ('dh_splitk_bf16', 'dh_bf16_wgmma')),
    'msd': ('packed_rows_kernel', 'adam_bf16_kernel'),
}
#: the kernels of the float32 fixture step (dense tier, mse)
FIXTURE_F32_KERNELS = ('decode_loss_fwd_kernel', 'drows_dbias_kernel',
                       'dh_splitk_kernel')
#: the fixture's captured-vs-eager runs: batch 480 leaves a tail block
#: of 400 users and 80 pad users (21 steps an epoch: 16 + 5 singles)
CAPTURE_FIXTURE = dict(batch_size=480, lr=1e-3, weight_decay=2e-5,
                       lr_milestones=[2], negative_sampling=True,
                       full_decode=True)


def _same_state(a, b):
  """Whether two trainers ended with the same last-epoch losses,
  parameters and optimizer state, bit for bit."""
  import torch
  if a.last_epoch_losses != b.last_epoch_losses:
    return False
  theirs = b.model.params()
  for name, p in a.model.params().items():
    if not torch.equal(p, theirs[name]):
      return False
    sa, sb = a.optimizer.state[p], b.optimizer.state[theirs[name]]
    if sa.keys() != sb.keys() or not all(
        torch.equal(torch.as_tensor(sa[k]).float(),
                    torch.as_tensor(sb[k]).float()) for k in sa):
      return False
  return True


def capture_fixture(train_m, device='cuda', epochs=3):
  """Every combination of {float32, bf16 compute + bf16 moments} x {dense,
  packed slab} x {'blocks', 'users'}: 16 steps a graph against one eager
  step a dispatch over 3 epochs of 21 fixture steps (noise 0.5, an lr
  milestone after epoch 1, a tail block with pad users), and a resume
  from a checkpoint written 10 steps into epoch 1: the losses,
  parameters and moments bitwise equal. Returns the float32 kernels'
  launches a step inside replays."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  fixture = RecommendationDataset(train_m)

  def trainer(cd):
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      compute_dtype=cd),
                   optimizer_type='adam', loss='mse',
                   loss_params={'confidence': 3}, device=device,
                   opt_state_dtype=cd)

  f32_counts = None
  for cd in (None, 'bfloat16'):
    for tier in (True, 'packed'):
      for shuffle in ('blocks', 'users'):
        kw = dict(CAPTURE_FIXTURE, shuffle=shuffle, slab_cache=tier)
        runs = {}
        for spc in (16, 1):
          tr = runs[spc] = trainer(cd)
          tr.train(fixture, num_epochs=epochs, fused_steps_per_call=spc,
                   **kw)
        steps = epochs * len(runs[1].last_epoch_losses)
        if not _same_state(runs[16], runs[1]):
          raise AssertionError(f'{cd} {tier} {shuffle}: captured and eager '
                               'trajectories differ')
        with tempfile.TemporaryDirectory() as tmp:
          trainer(cd).train(fixture, num_epochs=1, iters_per_epoch=10,
                            model_checkpoint_prefix=os.path.join(tmp, 'c'),
                            fused_steps_per_call=16, **kw)
          resumed = Recoder(DynamicAutoencoder(), optimizer_type='adam',
                            device=device, opt_state_dtype=cd)
          resumed.init_from_model_file(os.path.join(tmp, 'c_epoch_1.model'))
        resumed.train(fixture, num_epochs=epochs, fused_steps_per_call=16,
                      **kw)
        if not _same_state(resumed, runs[16]):
          raise AssertionError(f'{cd} {tier} {shuffle}: the resume from a '
                               'mid-epoch checkpoint differs')
        if cd is None and tier is True and shuffle == 'blocks':
          tr = runs[16]
          for _ in range(3):  # (the profiler at times drops a device event)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
              settle_profiler()
              tr.train(fixture, num_epochs=tr.current_epoch,
                       fused_steps_per_call=16, **kw)
              torch.cuda.synchronize()
            n = len(tr.last_epoch_losses)
            f32_counts = {name: sum(ev.count for ev in prof.key_averages()
                                    if name in ev.key) / n
                          for name in FIXTURE_F32_KERNELS}
            if all(v == 1 for v in f32_counts.values()):
              break
          else:
            raise AssertionError(f'float32 replays: {f32_counts} a step')
        say(f'  {cd or "float32":8s} {str(tier):6s} {shuffle:6s}: {steps} '
            f'steps, 16 a graph vs eager: losses, parameters and moments '
            f'bitwise equal ({runs[16].last_epoch_dispatches} vs '
            f'{runs[1].last_epoch_dispatches} dispatches an epoch); resumed '
            f'10 steps into epoch 1: bitwise equal')
  say(f'  float32 replays on the fixture: {f32_counts} launches a step')
  return f32_counts


def capture_cell(name, trainer, dataset, train_kw, rate_name,
                 turns=('captured', 'eager', 'eager', 'captured')):
  """One full-width cell, captured ('auto') against eager (1) in
  ``turns``:
  the first captured epoch, the steady rates, device ms a step and the
  idle share, dispatches an epoch and peak device memory; each hand
  kernel of the cell once a step inside the replays."""
  import torch
  steps = trainer.fused_data_source.steps_per_epoch
  # (the trainer's last call was a profile window: this first captured
  # call runs the rest of that epoch, with the warm-up and the captures)
  held = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
  t0 = time.time()
  trainer.train(dataset, num_epochs=trainer.current_epoch, **train_kw)
  torch.cuda.synchronize()
  graphs_gib = [(now - was) / 2**30 for now, was in zip(
      (torch.cuda.memory_allocated(), torch.cuda.memory_reserved()), held)]
  ran = len(trainer.last_epoch_losses)
  first = (time.time() - t0, ran, ran / trainer.last_epoch_seconds,
           trainer.last_epoch_dispatch, trainer.last_epoch_dispatches)
  if not first[3].startswith('captured'):
    raise AssertionError(f"{name}: 'auto' did not capture ({first[3]})")
  say(f'  {name}: first captured call {first[0]:.3f} s for {ran} steps with '
      f'the warm-up and the captures, {first[2]:.2f} {rate_name} '
      f'({first[4]} dispatches); the graphs and their pools added '
      f'{graphs_gib[0]:.3f} GiB allocated, {graphs_gib[1]:.3f} GiB '
      'reserved')
  out = {m: {'rates': [], 'peak': 0.0} for m in ('captured', 'eager')}
  for mode in turns:
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    trainer.train(dataset, num_epochs=trainer.current_epoch,
                  fused_steps_per_call='auto' if mode == 'captured' else 1,
                  **train_kw)
    torch.cuda.synchronize()
    if len(trainer.last_epoch_losses) != steps:
      raise AssertionError(f'{name} {mode}: {len(trainer.last_epoch_losses)}'
                           f' steps, not an epoch of {steps}')
    out[mode]['rates'].append(steps / trainer.last_epoch_seconds)
    out[mode]['dispatches'] = trainer.last_epoch_dispatches
    # (above what was allocated before the epoch: both cells' slabs,
    # models, optimizer state and captured graphs)
    out[mode]['peak'] = max(out[mode]['peak'],
                            torch.cuda.max_memory_allocated() / 2**30
                            - resident)
    out[mode]['resident'] = resident
  for mode, spc in (('captured', 'auto'), ('eager', 1)):
    for _ in range(3):  # (the profiler at times drops a device event)
      _, busy, launches, counts = profile_steps(
          trainer, dataset, train_kw, steps=64, spc=spc,
          kernels=CELL_KERNELS[name])
      if all(v == 64 for v in counts.values()):
        break
    else:
      raise AssertionError(f'{name} {mode}: kernel launches in 64 steps: '
                           f'{counts}')
    steady = 1e3 / max(out[mode]['rates'])
    out[mode].update(busy=busy, launches=launches, steady_ms=steady,
                     idle=1 - busy / steady, counts=counts)
  for mode, o in out.items():
    say(f'  {name} {mode:8s}: {rate_name} '
        f'{", ".join(f"{r:.2f}" for r in o["rates"])} (steady step '
        f'{o["steady_ms"]:.3f} ms); device {o["busy"]:.3f} ms and '
        f'{o["launches"]:.1f} launches a profiled step, the device idle '
        f'~{100 * o["idle"]:.1f}%; {o["dispatches"]} host dispatches an '
        f'epoch of {steps} steps; an epoch\'s peak device memory '
        f'{o["peak"]:.3f} GiB above the {o["resident"]:.2f} GiB resident '
        f'before it; hand kernels in 64 profiled steps {o["counts"]}')
  return first, out


def phase_capture(train_m, ml20m_cell, msd_cell):
  """Captured full-decode steps: bitwise against eager on the fixture,
  then bench.py's two full-decode cells captured and eager in turns."""
  f32_counts = capture_fixture(train_m)
  cells = {}
  # (an MSD epoch takes ~3.5 s: one of each)
  for name, (trainer, dataset), kw, rate, turns in (
      ('ml20m', ml20m_cell, ML20M_TRAIN, 'ml20m_user_batches_per_sec',
       ('captured', 'eager', 'eager', 'captured')),
      ('msd', msd_cell, MSD_DENSE_TRAIN, 'msd_user_batches_per_sec',
       ('captured', 'eager'))):
    cells[name] = capture_cell(name, trainer, dataset, kw, rate, turns)
  return f32_counts, cells


# -- phases 21 and 22 ------------------------------------------------------

#: the kernels of a float32 and of a bf16 decode-loss step, by the names in
#: a profile
F32_STEP_KERNELS = ('decode_loss_fwd_kernel', 'drows_dbias_kernel',
                    'dh_splitk_kernel')
BF16_STEP_KERNELS = ('decode_loss_fwd_bf16', 'drows_dbias_bf16',
                     ('dh_splitk_bf16', 'dh_bf16_wgmma'), 'adam_bf16_kernel')


def split_held_out(matrix, fraction=0.2, seed=0):
  """A seeded split of each user's interactions: ``round(fraction x
  count)`` of them, drawn at random, go to the held-out CSR, the rest to
  the input CSR."""
  import scipy.sparse as sp
  rng = np.random.default_rng(seed)
  counts = np.diff(matrix.indptr)
  rows = np.repeat(np.arange(matrix.shape[0]), counts)
  order = np.lexsort((rng.random(matrix.nnz), rows))
  rank = np.empty(matrix.nnz, np.int64)
  rank[order] = np.arange(matrix.nnz) - matrix.indptr[rows[order]]
  held = rank < np.round(fraction * counts[rows])

  def part(mask):
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[mask], minlength=matrix.shape[0]))])
    return sp.csr_matrix((matrix.data[mask], matrix.indices[mask], indptr),
                         shape=matrix.shape)

  return part(~held), part(held)


def profile_validation(trainer, loader, kernel):
  """torch.profiler over one ``_validate`` pass: the wall time, the
  device-idle share, and the launches of ``kernel`` and of any backward
  decode-loss kernel (there must be none)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    settle_profiler()
    t0 = time.time()
    trainer._validate(loader)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
  events = prof.key_averages()
  on_device = [ev for ev in events if 'CUDA' in str(ev.device_type)]
  host_keys = {ev.key for ev in events if ev not in on_device}
  kernels = [ev for ev in on_device if ev.key not in host_keys
             and 'spin_kernel' not in ev.key]
  busy = sum(getattr(ev, 'self_device_time_total', 0) for ev in kernels) / 1e3
  count = sum(ev.count for ev in kernels if kernel in ev.key)
  backward = sum(ev.count for ev in kernels
                 if any(k in ev.key for k in ('drows_dbias', 'dh_splitk',
                                              'dh_bf16_wgmma')))
  return wall_ms, 1 - busy / wall_ms, count, backward, markers_seen(events)


def phase_validation(matrix, held_out, device='cuda'):
  """bench.py's ML-20M default, captured, trained with a validation
  every epoch and without; the validation's cost and its kernel."""
  import torch
  from recoder_tpu_torch.data import (RecommendationDataLoader,
                                      RecommendationDataset)
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  train_ds = RecommendationDataset(matrix)
  val_ds = RecommendationDataset(held_out, matrix)
  val_kw = dict(val_dataset=val_ds, eval_freq=1,
                metrics=[Recall(k=20), Recall(k=50), NDCG(k=100)],
                eval_num_recommendations=100, eval_num_users=10000)
  n_val = -(-matrix.shape[0] // 500)
  runs = {}
  for eval_freq in (1, 0):
    tr = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device,
                 opt_state_dtype='bfloat16')
    timing = {'val': [], 'metrics': [], 'captures': []}

    def timed(name, fn):
      def call(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        timing[name].append(time.time() - t0)
        if name == 'val':
          timing['captures'].append(tr.captures)
        return out
      return call

    tr._validate = timed('val', tr._validate)
    tr._evaluate = timed('metrics', tr._evaluate)
    reset_launches()
    t0 = time.time()
    tr.train(train_ds, num_epochs=2, **ML20M_TRAIN,
             **(val_kw if eval_freq else {}))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    del tr._validate, tr._evaluate
    if not tr.last_epoch_dispatch.startswith('captured'):
      raise AssertionError(f'eval_freq={eval_freq}: the training did not '
                           f'run captured ({tr.last_epoch_dispatch})')
    runs[eval_freq] = (tr, timing, counts, wall)
    rate = len(tr.last_epoch_losses) / tr.last_epoch_seconds
    say(f'  eval_freq={eval_freq}: 2 epochs in {wall:.2f} s, epoch 2 '
        f'captured at {rate:.2f} ml20m_user_batches_per_sec '
        f'({tr.last_epoch_dispatches} dispatches); {tr.captures} graphs '
        f'captured; launches {counts}')
  (tr, timing, counts, _), (plain, _, counts0, _) = runs[1], runs[0]
  if len(timing['val']) != 2:
    raise AssertionError(f'{len(timing["val"])} validations in 2 epochs')
  if not timing['captures'][0] == timing['captures'][1] == tr.captures \
      == plain.captures:
    raise AssertionError(f'the graphs were captured again after a '
                         f'validation: {timing["captures"]}, {tr.captures} vs '
                         f'{plain.captures}')
  if not _same_state(tr, plain):
    raise AssertionError('eval_freq=1 and eval_freq=0 trained differently')
  # eager launches: the warm-up steps (the wgmma kernels: full decode),
  # and one forward a validation batch (of the route its union width
  # takes)
  def total(c, i):
    return sum(c[names[i]] for names in BF16_ROUTE_COUNTERS.values())

  fwd, bwd = total(counts, 0), total(counts, 1)
  if fwd - bwd != 2 * n_val or bwd < 1 or counts['adam_bf16'] != bwd or \
      total(counts0, 0) != bwd or total(counts0, 1) != bwd:
    raise AssertionError(f'launches with validation {counts}, without '
                         f'{counts0}: expected {2 * n_val} more forwards')
  timing['forwards_per_batch'] = {
      fw: (counts[fw] - counts[bw]) / (2 * n_val)
      for fw, bw in BF16_ROUTE_COUNTERS.values()}
  say(f'  captured and eager-warm-up training bitwise equal with and without'
      f' validation; the graphs survived it ({tr.captures} captures either '
      f'way); {fwd - bwd} no-E0 forwards in 2 validations of {n_val} '
      f'batches, a batch by route {timing["forwards_per_batch"]}')
  for epoch, (v, m) in enumerate(zip(timing['val'], timing['metrics']), 1):
    say(f'  epoch {epoch} validation: val loss {v:.3f} s ({n_val / v:.1f} val '
        f'batches/s), metrics on 10,000 users {m:.3f} s')

  kw = dict(batch_size=500, negative_sampling=True)
  for _ in range(3):  # (the profiler at times drops a device event)
    wall_ms, idle, launches, backward, markers = profile_validation(
        tr, RecommendationDataLoader(val_ds, seed=3, **kw),
        'decode_loss_fwd_bf16')
    if launches == n_val:
      break
  if launches != n_val or backward:
    raise AssertionError(f'profiled validation: {launches} forwards, '
                         f'{backward} backward kernels in {n_val} batches')
  say(f'  profiled validation ({markers} of {MARKERS} opening markers kept): '
      f'{wall_ms:.1f} ms for {n_val} batches, the device idle '
      f'{100 * idle:.1f}%; bf16 forward kernels (either route) x{launches}, '
      'no backward kernel')
  loaders = [RecommendationDataLoader(val_ds, seed=5, **kw) for _ in range(2)]
  got = tr._validate(loaders[0])
  with mock.patch.object(tr, '_fused_kind', return_value=None):
    want = tr._validate(loaders[1])
  rel = abs(got - want) / abs(want)
  if not rel <= BF16_PATHS_RTOL:
    raise AssertionError(f'val loss {got} (kernel) vs {want} (plain)')
  say(f'  val loss {got:.6f} through the kernel vs {want:.6f} plain: rel '
      f'diff {rel:.3g}')
  rates = {1: [], 0: []}
  captures = (tr.captures, plain.captures)
  for eval_freq in (1, 0):  # one epoch again each, in turns
    t = runs[eval_freq][0]
    t.train(train_ds, num_epochs=t.current_epoch, **ML20M_TRAIN,
            **(val_kw if eval_freq else {}))
    rates[eval_freq].append(len(t.last_epoch_losses) / t.last_epoch_seconds)
  if (tr.captures, plain.captures) != captures:
    raise AssertionError(f'graphs were captured again: {captures} -> '
                         f'{(tr.captures, plain.captures)}')
  say('  captured epochs in turns, ml20m_user_batches_per_sec: '
      f'with eval_freq=1 {", ".join(f"{r:.2f}" for r in rates[1])}; '
      f'without {", ".join(f"{r:.2f}" for r in rates[0])}')
  return timing, rates, (wall_ms, idle, launches)


def compare_losses(kernel, plain, rtol, what):
  """Per-step losses of the kernel path against the plain path's: the
  loss of step k reads the parameters that the backward passes and the
  optimizer steps of the steps before k wrote."""
  k, p = np.asarray(kernel), np.asarray(plain)
  if len(k) != len(p) or not np.all(np.isfinite(k)):
    raise AssertionError(f'{what}: losses {k} (kernel) vs {p} (plain)')
  rel = np.abs(k - p) / np.abs(p)
  if not np.all(rel <= rtol):
    raise AssertionError(f'{what}: {len(k)} losses, kernel vs plain max rel'
                         f' {rel.max()} (kernel {k}, plain {p})')
  return float(rel.max())


def plain_trainer_run(trainer, dataset, steps, kw):
  """``steps`` steps of ``trainer`` with every kernel but the decode-loss
  ones (which a plain ``MSELoss`` bypasses) replaced by its plain twin:
  the bf16-moment Adam step, the row scatter and the packed-slab fetch."""
  from recoder_tpu_torch.ops import adam as adam_ops
  from recoder_tpu_torch.ops import packed_rows as pr
  from recoder_tpu_torch.ops import row_scatter as rs

  def plain_adam(params, grads, exp_avgs, exp_avg_sqs, weight_decays, table,
                 ctl, captured=None):
    if captured is not None:
      raise AssertionError('a plain run captured a step')
    adam_ops.adam_bf16_plain_table(params, grads, exp_avgs, exp_avg_sqs,
                                   weight_decays, table, ctl)

  reset_launches()
  with mock.patch.object(adam_ops, 'adam_bf16_kernel_table', plain_adam), \
      mock.patch.object(rs, 'row_scatter_kernel', rs.row_scatter_plain), \
      mock.patch.object(pr, 'unpack_rows_kernel', pr.unpack_rows_plain):
    trainer.train(dataset, num_epochs=1, iters_per_epoch=steps,
                  **dict(kw, fused_steps_per_call=1))
  if any(read_launches().values()):
    raise AssertionError(f'the plain run launched {read_launches()}')
  return trainer.last_epoch_losses


def loader_rates(trainer, dataset, workers, kw):
  """Batches/s of one epoch of the host loader alone (collation), and of
  the trainer's staging of it (collation, the pinned buffer, the copy to
  the card), with ``workers`` collation threads; no step runs."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataLoader
  out = []
  for staged in (False, True):
    loader = RecommendationDataLoader(dataset, num_workers=workers, seed=9,
                                      **kw)
    t0 = time.time()
    batches = trainer._device_batch_iter(loader) if staged else loader
    n = sum(1 for _ in batches)
    torch.cuda.synchronize()
    out.append(n / (time.time() - t0))
  return out


def consumer_ms(trainer, dataset, kw, n=100):
  """ms a step of ``n`` eager steps over batches staged on the card
  beforehand: the consumer's side of a host-loader step alone (the
  trainer takes ``n`` more steps)."""
  import itertools

  import torch
  from recoder_tpu_torch.data import RecommendationDataLoader
  loader = RecommendationDataLoader(dataset, seed=10, **kw)
  batches = list(itertools.islice(trainer._device_batch_iter(loader), n))
  torch.cuda.synchronize()
  t0 = time.time()
  for batch in batches:
    trainer._dense_step_math(batch)
  torch.cuda.synchronize()
  return (time.time() - t0) * 1e3 / len(batches)


def phase_target(matrix, held_out, device='cuda', compared=20):
  """Training against a target matrix at the ML-20M shape: float32 and
  bf16, through the host loader ('users') and the dual CSRs ('blocks'),
  each held for ``compared`` steps against the plain path; the host
  loader at 0 and 4 collation threads; then a tied sparse model."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops.losses import MSELoss

  dataset = RecommendationDataset(matrix, held_out)
  steps = -(-matrix.shape[0] // 500)
  out, workers, totals, epochs = {}, {}, {}, {}
  for cd in (None, 'bfloat16'):
    if cd:  # (a union width takes either bf16 route)
      names = sum(BF16_ROUTE_COUNTERS.values(), ()) + ('adam_bf16',)
    else:
      names = ('fused_decode_loss_fwd', 'fused_decode_loss_bwd')
    profiled = BF16_STEP_KERNELS if cd else F32_STEP_KERNELS
    rtol = BF16_PATHS_RTOL if cd else PATHS_RTOL
    for shuffle in ('users', 'blocks'):
      kw = dict(ML20M_TRAIN, shuffle=shuffle)

      def trainer(loss='mse'):
        return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                          compute_dtype=cd),
                       optimizer_type='adam', loss=loss,
                       loss_params={'confidence': 3} if loss == 'mse'
                       else None, device=device, opt_state_dtype=cd)

      tr = trainer()
      reset_launches()
      t0 = time.time()
      tr.train(dataset, num_epochs=1, fused_steps_per_call=1, **kw)
      torch.cuda.synchronize()
      first_s = time.time() - t0
      counts = read_launches()
      launches = {k: counts[k] for k in names}
      if cd:
        pairs = BF16_ROUTE_COUNTERS.values()
        once = (sum(counts[f] for f, _ in pairs) == steps
                and counts['adam_bf16'] == steps
                and all(counts[f] == counts[b] for f, b in pairs))
      else:
        once = all(v == steps for v in launches.values())
      if not once or any(v for k, v in counts.items() if k not in names):
        raise AssertionError(f'{cd} {shuffle}: launches in an epoch of '
                             f'{steps} steps: {counts}')
      for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
        epochs[k] = epochs.get(k, 0) + 1
      host = tr._train_iterator is not None
      dual = tr.fused_data_source is not None and \
          tr.fused_data_source.target_matrix is not None
      if (shuffle == 'users') != host or (shuffle == 'blocks') != dual:
        raise AssertionError(f'{shuffle}: the wrong route (host loader '
                             f'{host}, dual CSRs {dual})')
      losses = np.asarray(tr.last_epoch_losses)
      plain = plain_trainer_run(
          trainer(MSELoss(confidence=3, reduction='sum')), dataset,
          compared, kw)
      rel = compare_losses(losses[:compared], plain, rtol,
                           f'{cd} {shuffle}')
      tr.train(dataset, num_epochs=tr.current_epoch, fused_steps_per_call=1,
               **kw)
      rates = [steps / tr.last_epoch_seconds]
      if shuffle == 'users' and cd is None:
        # the same trainer's next whole epochs, at 4 collation threads
        # and at none in turns (a new epoch builds a new loader)
        for w in (4, 0, 4):
          tr.train(dataset, num_epochs=tr.current_epoch,
                   num_data_workers=w, fused_steps_per_call=1, **kw)
          workers.setdefault(w, []).append(steps / tr.last_epoch_seconds)
        workers[0].insert(0, rates[0])
        loader_kw = dict(batch_size=500, negative_sampling=True)
        alone = {w: loader_rates(tr, dataset, w, loader_kw) for w in (0, 4)}
        alone['consumer_ms'] = consumer_ms(tr, dataset, loader_kw)
        say(f'  float32 users (host loader), whole epochs in turns at 0 / 4'
            f' collation threads: {workers[0][0]:.2f}, {workers[4][0]:.2f}, '
            f'{workers[0][1]:.2f}, {workers[4][1]:.2f} user-batches/s; the '
            f'loader alone {alone[0][0]:.1f} / {alone[4][0]:.1f} batches/s, '
            f'collated and staged to the card (no step) {alone[0][1]:.1f} / '
            f'{alone[4][1]:.1f} batches/s; the step alone over batches '
            f'staged beforehand {alone["consumer_ms"]:.3f} ms')
        workers['alone'] = alone
      for _ in range(3):  # (the profiler at times drops a device event)
        _, busy, per_step, counted = profile_steps(tr, dataset, kw, steps=16,
                                                   kernels=profiled)
        if all(v == 16 for v in counted.values()):
          break
      else:
        raise AssertionError(f'{cd} {shuffle}: kernels in 16 profiled steps:'
                             f' {counted}')
      rate = rates[0]
      steady_ms = 1e3 / rate
      out[(cd or 'float32', shuffle)] = (rate, 1 - busy / steady_ms)
      say(f'  {cd or "float32":8s} {shuffle:6s} ('
          f'{"host loader" if host else "dual CSRs"}): first epoch '
          f'{first_s:.2f} s, mean loss {losses.mean():.4f}; steady '
          f'{rate:.2f} user-batches/s ({steady_ms:.3f} ms a step, the '
          f'device idle ~{100 * (1 - busy / steady_ms):.1f}%, {busy:.3f} ms '
          f'of device time and {per_step:.1f} launches a profiled step); '
          f'epoch launches {launches}; hand kernels in 16 profiled steps '
          f'{counted}; {compared} losses vs the plain path (plain loss, '
          f'plain Adam): max rel {rel:.3g}')

  for shuffle in ('users', 'blocks'):
    kw = dict(ML20M_TRAIN, shuffle=shuffle)
    runs = {}
    for fused in (True, False):
      tr = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      is_constrained=True, sparse=True),
                   optimizer_type='adam',
                   loss='mse' if fused else MSELoss(confidence=3,
                                                    reduction='sum'),
                   loss_params={'confidence': 3} if fused else None,
                   device=device)
      if fused:
        reset_launches()
        tr.train(dataset, num_epochs=1, iters_per_epoch=compared,
                 fused_steps_per_call=1, **kw)
        torch.cuda.synchronize()
        counts = read_launches()
        losses = tr.last_epoch_losses
      else:
        losses = plain_trainer_run(tr, dataset, compared, kw)
      runs[fused] = (losses, tr.model.params()['en_embedding'],
                     tr.sparse_states['en_embedding']['step'])
    want = {'fused_decode_loss_fwd': compared,
            'fused_decode_loss_bwd': compared, 'row_scatter': compared}
    if {k: v for k, v in counts.items() if v} != want:
      raise AssertionError(f'tied sparse {shuffle}: launches {counts}, '
                           f'expected {want}')
    if runs[True][2] != compared or runs[False][2] != compared:
      raise AssertionError(f'tied sparse {shuffle}: {runs[True][2]} and '
                           f'{runs[False][2]} row-sparse steps in {compared}')
    rel = compare_losses(runs[True][0], runs[False][0], PATHS_RTOL,
                         f'tied sparse {shuffle}')
    # the table's logical rows (the last pad row is the fold's spare)
    n = matrix.shape[1]
    a, b = runs[True][1][:n], runs[False][1][:n]
    table_rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    if not table_rel <= TABLE_RTOL:
      raise AssertionError(f'tied sparse {shuffle}: en_embedding after '
                           f'{compared} steps, kernel vs plain relative '
                           f'Frobenius {table_rel}')
    say(f'  tied sparse {shuffle}: {compared} steps, one row-sparse step '
        f'over the folded input and target unions each: launches {want}; '
        f'losses vs the plain path (plain loss, plain row scatter) max rel '
        f'{rel:.3g}; en_embedding relative Frobenius {table_rel:.3g}')
  launch_rates = {k: v / (epochs[k] * steps) for k, v in totals.items()}
  launch_rates['row_scatter'] = counts['row_scatter'] / compared
  return out, workers, launch_rates, totals


# -- phases 23-25: the other model families ----------------------------------

#: tests/test_model.py's MF row at BASELINE.json's 200 factors (weighted
#: MSE, confidence 40), on bench.py's ML-20M pipeline (block shuffle, full
#: decode from the resident slab)
MF_MODEL = dict(embedding_size=200, activation_type='tanh', dropout_prob=0.2)
MF_LOSS = dict(loss='mse', loss_params={'confidence': 40})
MF_TRAIN = dict(batch_size=500, lr=1e-3, negative_sampling=True,
                shuffle='blocks')
MF_FLOOR = 0.03  # Recall@20, tests/test_model.py:190
#: the paper's Mult-VAE shape with the full softmax; beta = step / 2,000
#: grows for the first 400 steps: inside the graphs of the first 2 epochs
MULTVAE_MODEL = dict(hidden_dim=600, latent_dim=200, dropout_prob=0.5,
                     anneal_cap=0.2, total_anneal_steps=2000)
MULTVAE_TRAIN = dict(batch_size=500, lr=1e-3, negative_sampling=False,
                     shuffle='blocks')
#: tests/test_multvae.py::test_multvae_fixture_quality
MULTVAE_FIXTURE = dict(hidden_dim=200, latent_dim=64, dropout_prob=0.5,
                       anneal_cap=0.2, total_anneal_steps=2000)
MULTVAE_FLOORS = {'Recall@20': 0.135, 'NDCG@100': 0.160}
#: tests/test_ease.py::test_ease_fixture_quality
EASE_FLOORS = {'Recall@20': 0.060, 'NDCG@100': 0.095}
EASE_RESIDUAL = 1e-3
CELL_KERNELS.update({
    'mf': ('decode_loss_fwd_bf16_wgmma_kernel',
           'drows_dbias_bf16_wgmma_kernel', 'dh_bf16_wgmma_kernel',
           'adam_bf16_kernel'),
    'multvae': ('adam_bf16_kernel',),
})


def family_fixture_bitwise(train_m, make, kw, epochs=3):
  """16 steps a graph against one eager step a dispatch on the fixture
  (3 epochs of 21 steps at batch 480, a tail block of pad users): the
  losses, parameters and moments bitwise equal."""
  from recoder_tpu_torch.data import RecommendationDataset
  fixture = RecommendationDataset(train_m)
  runs = {}
  for spc in (16, 1):
    runs[spc] = make()
    runs[spc].train(fixture, num_epochs=epochs, fused_steps_per_call=spc,
                    **kw)
  if not _same_state(runs[16], runs[1]):
    raise AssertionError('captured and eager fixture trajectories differ')
  say(f'  fixture, {epochs} epochs of {len(runs[1].last_epoch_losses)} steps'
      f': 16 a graph ({runs[16].last_epoch_dispatches} dispatches an epoch)'
      f' vs eager: losses, parameters and moments bitwise equal')


def family_paths(dataset, kernel, plain, kw, kernels, rtol, what,
                 steps=20, tables=()):
  """``steps`` steps of the trainer ``kernel`` through the hand kernels
  (``kernels``: each one's launches a step, counted from 0) against the
  same steps of the trainer ``plain`` on the plain path (a loss instance
  instead of the fused decode-loss, and the plain twins of Adam and the
  row scatter): the losses within ``rtol``, and each of ``tables`` within
  TABLE_RTOL in relative Frobenius norm; returns the launches a step.
  Both run one eager step a dispatch (the counters do not see inside a
  graph)."""
  import torch
  kw = dict(kw, fused_steps_per_call=1)
  reset_launches()
  kernel.train(dataset, num_epochs=1, iters_per_epoch=steps, **kw)
  torch.cuda.synchronize()
  counts = {k: v for k, v in read_launches().items() if v}
  if set(counts) != set(kernels) or any(
      counts[k] != n * steps for k, n in kernels.items()):
    raise AssertionError(f'{what}: {steps} steps launched {counts}, expected'
                         f' {kernels} a step')
  losses = plain_trainer_run(plain, dataset, steps, kw)
  rel = compare_losses(kernel.last_epoch_losses, losses, rtol, what)
  table_rel = {}
  for name in tables:
    a, b = (t.model.params()[name].float() for t in (kernel, plain))
    table_rel[name] = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    if not table_rel[name] <= TABLE_RTOL:
      raise AssertionError(f'{what}: {name} after {steps} steps, kernel vs '
                           f'plain relative Frobenius {table_rel[name]}')
  say(f'  {what}: {steps} steps, launches {counts}; losses vs the plain '
      f'path max rel {rel:.3g}'
      + ''.join(f'; {k} relative Frobenius {v:.3g}'
                for k, v in table_rel.items()))
  return {k: v / steps for k, v in counts.items()}


def phase_mf(matrix, train_m, val_m, device='cuda'):
  """MatrixFactorization[200] through the port: bench.py's ML-20M pipeline
  at bf16 compute and bf16 moments (the wgmma decode-loss pair and Adam
  once a step), captured against eager; the fixture captured bitwise
  eager; float32 and sparse steps against the plain path; the MF quality
  gate."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MatrixFactorization
  from recoder_tpu_torch.ops.losses import MSELoss

  def make(cd=None, sparse=False, loss='mse'):
    return Recoder(MatrixFactorization(**MF_MODEL, sparse=sparse,
                                       compute_dtype=cd),
                   optimizer_type='adam', loss=loss,
                   loss_params=MF_LOSS['loss_params'] if loss == 'mse'
                   else None, device=device, opt_state_dtype=cd)

  dataset = RecommendationDataset(matrix)
  per_step = {}
  trainer = make('bfloat16')
  kernels = BF16_ROUTE_COUNTERS['wgmma'] + ('adam_bf16',)
  counts, _ = eager_epoch(trainer, dataset, MF_TRAIN, kernels)
  per_step['mf'] = {k: counts[k] / trainer.fused_data_source.steps_per_epoch
                    for k in kernels}
  params = sum(p.numel() for p in trainer.model.params().values())
  say(f'  {params:,} parameters (user table {tuple(trainer.model.params()["user_embedding"].shape)})')
  cell = capture_cell('mf', trainer, dataset, MF_TRAIN,
                      'ml20m_mf_user_batches_per_sec',
                      ('captured', 'eager', 'eager', 'captured'))
  del trainer
  family_fixture_bitwise(train_m, lambda: make('bfloat16'),
                         dict(CAPTURE_FIXTURE, shuffle='blocks'))
  f32 = MSELoss(confidence=40, reduction='sum')
  per_step['mf_float32'] = family_paths(
      dataset, make(), make(loss=f32), MF_TRAIN,
      {'fused_decode_loss_fwd': 1, 'fused_decode_loss_bwd': 1},
      PATHS_RTOL, 'float32 full decode (3xTF32 kernels)')
  per_step['mf_sparse'] = family_paths(
      dataset, make(sparse=True), make(sparse=True, loss=f32), MF_TRAIN,
      {'fused_decode_loss_fwd': 1, 'fused_decode_loss_bwd': 1,
       'row_scatter': 2}, PATHS_RTOL, 'sparse (union, float32)',
      tables=('user_embedding', 'item_embedding'))

  # the MF gate of tests/test_model.py at the cell's numerics
  train_ds, val_ds = (RecommendationDataset(train_m),
                      RecommendationDataset(val_m, train_m))
  tr = make('bfloat16')
  t0 = time.time()
  tr.train(train_ds, batch_size=500, lr=1e-3, num_epochs=20,
           negative_sampling=True)
  train_s = time.time() - t0
  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]
  results = tr._evaluate(val_ds, 100, metrics, batch_size=500)
  means = {str(m): float(np.mean(v)) for m, v in results.items()}
  say(f'  fixture gate: 20 epochs in {train_s:.1f} s ({tr.last_epoch_dispatch}'
      f'); ' + ', '.join(f'{k} {v:.4f}' for k, v in means.items())
      + f' (Recall@20 floor {MF_FLOOR})')
  if not means['Recall@20'] > MF_FLOOR:
    raise AssertionError(f'MF Recall@20 {means["Recall@20"]} <= {MF_FLOOR}')
  reload_metrics(tr, lambda: Recoder(MatrixFactorization(1), device=device),
                 val_ds, metrics, means)
  return per_step, cell, means


def phase_multvae(matrix, train_m, val_m, device='cuda'):
  """Mult-VAE[600, 200] with the full softmax at the ML-20M shape, bf16
  compute and moments: captured bitwise eager while the KL weight
  changes inside the graphs, the rates and Adam once a step; the sparse
  tables' steps against the plain path; the fixture gate and the
  protocol summary."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MultVAE
  from recoder_tpu_torch.protocols import evaluate_vae_protocol

  def make(cd=None, sparse=False, model=MULTVAE_MODEL, seed=42):
    return Recoder(MultVAE(**model, sparse=sparse, compute_dtype=cd),
                   optimizer_type='adam', loss='logloss', device=device,
                   opt_state_dtype=cd, seed=seed)

  dataset = RecommendationDataset(matrix)
  per_step = {}
  # captured against eager from one init: 2 epochs (468 steps; beta
  # = step / 2,000 changes at every step of them)
  runs = {}
  for spc in ('auto', 1):
    runs[spc] = make('bfloat16')
    runs[spc].train(dataset, num_epochs=2, fused_steps_per_call=spc,
                    **MULTVAE_TRAIN)
  if not runs['auto'].last_epoch_dispatch.startswith('captured'):
    raise AssertionError(f"'auto' did not capture: "
                         f"{runs['auto'].last_epoch_dispatch}")
  if not _same_state(runs['auto'], runs[1]):
    raise AssertionError('Mult-VAE captured and eager trajectories differ '
                         'across a changing KL weight')
  say(f'  2 epochs of {len(runs[1].last_epoch_losses)} steps (beta 0 -> '
      f'{min(0.2, 2 * len(runs[1].last_epoch_losses) / 2000):.3f}), '
      f'{runs["auto"].last_epoch_dispatch} vs eager: losses, parameters '
      f'and moments bitwise equal')
  del runs
  trainer = make('bfloat16')
  counts, _ = eager_epoch(trainer, dataset, MULTVAE_TRAIN, ('adam_bf16',))
  per_step['multvae'] = {'adam_bf16': counts['adam_bf16']
                         / trainer.fused_data_source.steps_per_epoch}
  cell = capture_cell('multvae', trainer, dataset, MULTVAE_TRAIN,
                      'ml20m_multvae_user_batches_per_sec',
                      ('captured', 'eager', 'eager', 'captured'))
  del trainer
  per_step['multvae_sparse'] = family_paths(
      dataset, make(sparse=True), make(sparse=True),
      dict(MULTVAE_TRAIN, negative_sampling=True), {'row_scatter': 2},
      PATHS_RTOL, 'sparse tables (union, float32)',
      tables=('en_embedding', 'de_embedding'))

  train_ds, val_ds = (RecommendationDataset(train_m),
                      RecommendationDataset(val_m, train_m))
  tr = make(model=MULTVAE_FIXTURE, seed=0)
  t0 = time.time()
  tr.train(train_ds, batch_size=500, lr=1e-3, num_epochs=8,
           negative_sampling=True)
  train_s = time.time() - t0
  metrics = [Recall(k=20), NDCG(k=100)]
  results = tr._evaluate(val_ds, 100, metrics, batch_size=500)
  means = {str(m): float(np.mean(v)) for m, v in results.items()}
  summary = evaluate_vae_protocol(tr, val_ds, batch_size=500)
  say(f'  fixture gate: 8 epochs in {train_s:.1f} s ({tr.last_epoch_dispatch}'
      f'); ' + ', '.join(f'{k} {v:.4f} (floor {MULTVAE_FLOORS[k]})'
                         for k, v in means.items())
      + '; evaluate_vae_protocol: '
      + ', '.join(f'{k} {v:.4f}' for k, v in summary.items()))
  misses = {k: v for k, v in means.items() if not v > MULTVAE_FLOORS[k]}
  if misses:
    raise AssertionError(f'Mult-VAE under its floors: {misses}')
  reload_metrics(tr, lambda: Recoder(MultVAE(), device=device), val_ds,
                 metrics, means)
  return per_step, cell, {**means, **summary}


def phase_ease(matrix, train_m, val_m, device='cuda', lam=200.0):
  """EASE at the ML-20M shape: the Gram on the card (exact), the
  cuSOLVER Cholesky inverse and its residual, B, recommend and a
  checkpoint round trip; the whole fit timed; the fixture floors."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
  from recoder_tpu_torch.models import EASE
  from recoder_tpu_torch.models.ease import b_from_p_, spd_inverse
  from recoder_tpu_torch.recommender import InferenceRecommender

  model = EASE(lam=lam, device=device)
  m = matrix.tocsr().astype(np.float32)
  n = m.shape[1]
  torch.cuda.synchronize()
  t0 = time.time()
  g = model._device_gram(m)
  torch.cuda.synchronize()
  gram_s = time.time() - t0
  cols = np.sort(np.random.default_rng(0).choice(n, 256, replace=False))
  want = np.asarray((m[:, cols].T @ m).todense(), np.float32)
  if not np.array_equal(g[torch.from_numpy(cols).to(device)].cpu().numpy(),
                        want):
    raise AssertionError('the Gram differs from scipy X.T @ X')
  t0 = time.time()
  p = spd_inverse(g, lam)
  torch.cuda.synchronize()
  solve_s = time.time() - t0
  prev = torch.get_float32_matmul_precision()
  torch.set_float32_matmul_precision('highest')
  try:
    g.diagonal().add_(lam)
    resid = g @ p
    resid.diagonal().sub_(1.0)
    residual = float(resid.abs().max())
  finally:
    torch.set_float32_matmul_precision(prev)
  del g, resid
  b = b_from_p_(p)
  if not bool((b.diagonal() == 0).all()):
    raise AssertionError('a diagonal entry of B is not zero')
  say(f'  G [{n:,} x {n:,}] float32 ({4 * n * n / 1e9:.2f} GB) in '
      f'{gram_s:.3f} s, exact on 256 sampled columns; Cholesky + '
      f'cholesky_inverse {solve_s:.3f} s; max |(G + {lam:g} I) P - I| = '
      f'{residual:.3g} (limit {EASE_RESIDUAL})')
  if not residual <= EASE_RESIDUAL:
    raise AssertionError(f'residual {residual} > {EASE_RESIDUAL}')
  del b, p
  torch.cuda.synchronize()
  t0 = time.time()
  model.fit(m)
  torch.cuda.synchronize()
  fit_s = time.time() - t0
  users, _ = RecommendationDataset(m)[np.arange(500)]
  recs = model.recommend(users, 100)
  check_recommendations(recs, users.interactions_matrix, 100, n)
  with tempfile.TemporaryDirectory() as tmp:
    path = model.save(os.path.join(tmp, 'ease.model'))
    recs2 = EASE(device=device).load(path).recommend(users, 100)
  if not all(np.array_equal(a, c) for a, c in zip(recs, recs2)):
    raise AssertionError('recommendations changed across save -> load')
  say(f'  fit {fit_s:.3f} s (Gram, solve, B); recommend k=100 for 500 users '
      f'valid, identical after save -> load; peak device memory '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
  del model

  fixture = EASE(lam=500.0, device=device).fit(train_m)
  res = RecommenderEvaluator(InferenceRecommender(fixture, 100),
                             [Recall(k=20), NDCG(k=100)]).evaluate(
      RecommendationDataset(val_m, train_m), batch_size=500)
  means = {str(k): float(np.mean(v)) for k, v in res.items()}
  say('  fixture floors (lam 500): ' + ', '.join(
      f'{k} {v:.4f} (floor {EASE_FLOORS[k]})' for k, v in means.items()))
  misses = {k: v for k, v in means.items() if not v > EASE_FLOORS[k]}
  if misses:
    raise AssertionError(f'EASE under its floors: {misses}')
  return {'gram_s': gram_s, 'solve_s': solve_s, 'fit_s': fit_s,
          'residual': residual, **means}


# -- main ------------------------------------------------------------------

# -- phase 26 --------------------------------------------------------------

#: the reference's negative-sampling knobs at the tutorial's values
#: (docs/tutorial.md:107-133): megas of 2,000 users (4 compute batches of
#: 500) sharing one item union, and 1,000 uniform-random extra negatives
#: a step
NEGATIVES = dict(num_sampling_users=2000, num_random_negatives=1000)
#: phase 26 (a): bench.py's ML-20M default with them, 'users' shuffle
ML20M_NEG_TRAIN = dict(ML20M_TRAIN, shuffle='users', **NEGATIVES)
NEG_RATE = 'ml20m_mega2000_neg1000_user_batches_per_sec'
#: tools/jax_negatives_pins.py: the fixture protocol with NEGATIVES (bench
#: DynamicAutoencoder[200], logloss, batch 500, 30 epochs) through the JAX
#: package on the CPU, float32 (atol 0.01)
NEGATIVES_PINNED = {'Recall@20': 0.1435, 'Recall@50': 0.2438, 'NDCG@100': 0.1717}
#: the hand kernels of bench.py's ML-20M step, launches a step (eager)
ML20M_BF16_STEP = {'fused_decode_loss_fwd_bf16_wgmma': 1,
                   'fused_decode_loss_bwd_bf16_wgmma': 1, 'adam_bf16': 1}
CELL_KERNELS['ml20m_neg'] = CELL_KERNELS['ml20m']


def _ml20m_trainer(plain=False, device='cuda', params_dtype=None,
                   compute_dtype='bfloat16'):
  """bench.py's ML-20M model and trainer (bf16 compute and moments, 'mse'
  confidence 3; ``params_dtype``: its --params-dtype, ``compute_dtype``
  its --dtype); ``plain``: the same loss as an ``MSELoss`` instance,
  which bypasses the fused decode-loss kernel."""
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops.losses import MSELoss
  loss = MSELoss(confidence=3, reduction='sum') if plain else 'mse'
  return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                    compute_dtype=compute_dtype,
                                    params_dtype=params_dtype),
                 optimizer_type='adam', loss=loss,
                 loss_params=None if plain else {'confidence': 3},
                 device=device, opt_state_dtype='bfloat16')


def union_widths(trainer, steps=20, epoch=1):
  """The item-union widths of the first ``steps`` steps of ``epoch`` as
  the trainer's source built them (the random ids of global steps 0..)."""
  source = trainer.fused_data_source
  perm = source.epoch_permutation(epoch)
  return np.array([len(source.build_union_batch(perm, s, neg_step=s)
                       ['items']) for s in range(steps)])


def phase_negatives(matrix, train_m, val_m):
  """The paper's negative-sampling knobs (NEGATIVES) on bench.py's ML-20M
  default: (a) 'users' shuffle from the dense slab, 20 steps against the
  plain path, then captured and eager in turns; (b) the same through the
  per-step triplet scatter (slab_cache=False), eager: its 20 losses
  bitwise (a)'s, and against the plain path; (c) 'blocks' captured; (e)
  the bf16 union path, 20 steps: how many take each decode-loss route
  (the mega union plus R is rarely a multiple of 8), against the plain
  path; the fixture captured bitwise eager with megas and random
  negatives; the fixture quality row against the JAX package's pins."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  dataset = RecommendationDataset(matrix)
  per_step = {}

  kernel = _ml20m_trainer()
  per_step['ml20m_mega_users'] = family_paths(
      dataset, kernel, _ml20m_trainer(plain=True), ML20M_NEG_TRAIN,
      ML20M_BF16_STEP, BF16_PATHS_RTOL, '(a) ML-20M users, mega 2000, R 1000')
  source = kernel.fused_data_source
  if source.d_slab is None or source.slices_per_mega != 4:
    raise AssertionError('(a) did not train 4 slices a mega from the slab')

  scatter = _ml20m_trainer()
  scatter_kw = dict(ML20M_NEG_TRAIN, slab_cache=False)
  per_step['ml20m_mega_scatter'] = family_paths(
      dataset, scatter, _ml20m_trainer(plain=True), scatter_kw,
      ML20M_BF16_STEP, BF16_PATHS_RTOL, '(b) the same, triplet scatter')
  if scatter.fused_data_source.d_slab is not None:
    raise AssertionError('(b) kept a slab under slab_cache=False')
  if scatter.last_epoch_losses != kernel.last_epoch_losses:
    raise AssertionError(f'(b) scatter route losses {scatter.last_epoch_losses}'
                         f' differ from the slab route\'s '
                         f'{kernel.last_epoch_losses}')
  say('  (b) the scatter route\'s 20 losses are bitwise the slab route\'s')
  # the next 20 eager steps of each route, in turns, then a profile
  rates = {'scatter': [], 'slab': []}
  for name in ('scatter', 'slab', 'slab', 'scatter'):
    tr, kw = ((scatter, scatter_kw) if name == 'scatter'
              else (kernel, ML20M_NEG_TRAIN))
    tr.train(dataset, num_epochs=1, iters_per_epoch=20,
             fused_steps_per_call=1, **kw)
    torch.cuda.synchronize()
    rates[name].append(20 / tr.last_epoch_seconds)
  _, busy, launches, _ = profile_steps(scatter, dataset, scatter_kw)
  scatter_rate = max(rates['scatter'])
  say(f'  (b) eager user-batches/s over 20 steps, in turns: scatter '
      f'{rates["scatter"][0]:.2f} / {rates["scatter"][1]:.2f}, slab '
      f'{rates["slab"][0]:.2f} / {rates["slab"][1]:.2f}; the scatter step '
      f'{busy:.3f} ms of device time and {launches:.1f} launches, the device '
      f'idle ~{100 * (1 - busy * scatter_rate / 1e3):.1f}%')
  del scatter
  torch.cuda.empty_cache()

  first, cell = capture_cell('ml20m_neg', kernel, dataset, ML20M_NEG_TRAIN,
                             NEG_RATE)
  del kernel
  torch.cuda.empty_cache()

  blocks_kw = dict(ML20M_TRAIN, **NEGATIVES)
  blocks = _ml20m_trainer()
  per_step['ml20m_mega_blocks'] = family_paths(
      dataset, blocks, _ml20m_trainer(plain=True), blocks_kw,
      ML20M_BF16_STEP, BF16_PATHS_RTOL, '(c) ML-20M blocks, mega 2000, R 1000')
  blocks.train(dataset, num_epochs=1, **blocks_kw)  # the rest of epoch 1
  blocks.train(dataset, num_epochs=1, **blocks_kw)
  torch.cuda.synchronize()
  if not blocks.last_epoch_dispatch.startswith('captured'):
    raise AssertionError(f'(c) did not run captured: '
                         f'{blocks.last_epoch_dispatch}')
  steps = len(blocks.last_epoch_losses)
  blocks_rate = steps / blocks.last_epoch_seconds
  say(f'  (c) blocks captured: {steps} steps, {blocks_rate:.2f} user-batches/s'
      f' ({blocks.last_epoch_dispatch}, {blocks.last_epoch_dispatches} '
      'dispatches an epoch)')
  del blocks
  torch.cuda.empty_cache()

  union = _ml20m_trainer()
  union_kw = dict(ML20M_NEG_TRAIN, full_decode=False, fused_steps_per_call=1)
  reset_launches()
  union.train(dataset, num_epochs=1, iters_per_epoch=20, **union_kw)
  torch.cuda.synchronize()
  counts = {k: v for k, v in read_launches().items() if v}
  routes = {r: counts.get(names[0], 0)
            for r, names in BF16_ROUTE_COUNTERS.items()}
  if (sum(routes.values()) != 20 or counts.get('adam_bf16') != 20
      or any(counts.get(b, 0) != counts.get(f, 0)
             for f, b in BF16_ROUTE_COUNTERS.values())):
    raise AssertionError(f'(e) 20 union steps launched {counts}')
  widths = union_widths(union)
  plain = plain_trainer_run(_ml20m_trainer(plain=True), dataset, 20,
                            union_kw)
  rel = compare_losses(union.last_epoch_losses, plain, BF16_PATHS_RTOL,
                       '(e) bf16 union path')
  odd = int(np.sum(widths % 8 != 0))
  say(f'  (e) ML-20M bf16 union path, mega 2000, R 1000: 20 steps, union '
      f'widths {widths.min()}-{widths.max()} (mean {widths.mean():.1f}), '
      f'{odd} of 20 not a multiple of 8; decode-loss route by step '
      f'{routes}, launches {counts}; losses vs the plain path max rel '
      f'{rel:.3g}')
  per_step['ml20m_mega_union'] = {k: v / 20 for k, v in counts.items()}
  compare_kernel(500, 200, int(widths[widths % 8 != 0][0]) if odd
                 else int(widths[0]) + 1, 'mse', 3, 'cuda',
                 target_dtype=torch.bfloat16, compute_dtype='bfloat16',
                 route='mma')
  del union
  torch.cuda.empty_cache()

  family_fixture_bitwise(
      train_m, _ml20m_trainer,
      dict(CAPTURE_FIXTURE, shuffle='users', num_sampling_users=4 * 480,
           num_random_negatives=1000))
  quality = phase_quality(train_m, val_m, pinned=NEGATIVES_PINNED,
                          **NEGATIVES)
  return (per_step, (first, cell), blocks_rate, scatter_rate,
          (routes, widths), quality)


def phase_negatives_msd(msd):
  """(d) bench.py's MSD --sparse default with NEGATIVES: the union path
  over the mega's union and the random ids, two row-scatter launches a
  step, 20 steps against the plain path (float32); the row scatter at a
  step's union width against index_copy_."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      sparse=True),
                   optimizer_type='adam', loss='logloss', device='cuda')

  dataset = RecommendationDataset(msd)
  kw = dict(MSD_TRAIN, **NEGATIVES)
  trainer = make()
  per_step = family_paths(dataset, trainer, make(), kw, {'row_scatter': 2},
                          PATHS_RTOL, '(d) MSD sparse, mega 2000, R 1000')
  rate = 20 / trainer.last_epoch_seconds
  widths = union_widths(trainer)
  n_rows = trainer.model.params()['en_embedding'].shape[0]
  check_scatter(*scatter_case(n_rows, 200, int(widths[0]), 'cuda'),
                f'[{n_rows}, 200] at a mega union of {widths[0]}')
  say(f'  (d) union widths {widths.min()}-{widths.max()} (mean '
      f'{widths.mean():.1f}); {rate:.2f} user-batches/s over the 20 eager '
      f'steps; row_scatter at [{n_rows}, 200] x {widths[0]} ids: bitwise '
      'index_copy_')
  return {'msd_sparse_mega': per_step}, rate, widths


# -- phase 27 --------------------------------------------------------------

#: the msd-big class (scripts/msd-big/train.py) at the shape that
#: docs/benchmarks.md profiled: a Zipf catalog of 1,000,000 items, 100,000
#: training users, MSD's 59 items a user; and 10,000 users more, held out
#: with phase 21's 80/20 per-user split
MSD_BIG_ITEMS, MSD_BIG_USERS, MSD_BIG_HELD_OUT = 1_000_000, 100_000, 10_000
#: scripts/msd-big/train.py's step (sparse tables, logloss, bf16 compute,
#: Adam lr 1e-3, weight decay 2e-5, batch 500, negative sampling), 'blocks'
MSD_BIG_TRAIN = dict(MSD_TRAIN)
MSD_BIG_RATE = 'msdbig_user_batches_per_sec'
#: the eval chunk of (a) and (b): Recoder.AUTO_CHUNK_WIDTH
LARGE_CHUNK = 2 ** 18
#: scripts/stress_scale.py's default shape, scored only
STRESS_ITEMS, STRESS_DIM = 10_000_000, 128
#: monolithic against the chunked path's float32 scores at bf16 compute:
#: within this share of the largest score, two bf16 ulps of it (a
#: monolithic score is rounded to 2^-9 of itself, and the COO encode
#: rounds each product to bf16 where the GEMM does not)
SCORE_TOL = 2.0 ** -8
#: chunked recommend against the top-k of the same float32 arithmetic
#: over the whole catalog at once: scores within this share of the
#: largest (a GEMM over a chunk and over the catalog may add in another
#: order), and metrics within CHUNKED_METRIC_ATOL
SCORE_TOL_F32 = 1e-5
CHUNKED_METRIC_ATOL = 1e-4
#: monolithic against chunked metrics: their scores differ by the bf16
#: rounding above, so ids near the 100th swap; one hit more or less moves
#: a mean over 500 users by up to 2e-3 (Recall@20 of a user with one
#: held-out item), at least 1e-4
METRIC_ATOL = 1e-3


def msd_big_data():
  """The phase's CSRs: (training users, held-out input, held-out target),
  from data/synthetic.synthesize at MSD's mean."""
  from recoder_tpu_torch.data import synthetic
  t0 = time.time()
  m = synthetic.synthesize(MSD_BIG_USERS + MSD_BIG_HELD_OUT, MSD_BIG_ITEMS,
                           synthetic.MSD_MEAN_ITEMS_PER_USER, seed=0,
                           mean_factor=0.68)
  val_in, val_tg = split_held_out(m[MSD_BIG_USERS:])
  train_m = m[:MSD_BIG_USERS]
  say(f'msd-big-shaped CSR: {train_m.shape[0]:,} training users x '
      f'{MSD_BIG_ITEMS:,} items, nnz {train_m.nnz:,}; {MSD_BIG_HELD_OUT:,} '
      f'held-out users, input nnz {val_in.nnz:,}, held out {val_tg.nnz:,} '
      f'({time.time() - t0:.1f} s)')
  return train_m, val_in, val_tg


def _msd_big_metrics():
  from recoder_tpu_torch.metrics import NDCG, Recall
  return [Recall(k=20), Recall(k=50), NDCG(k=100)]


def _evaluation_s(evaluator, dataset):
  """Seconds of one ``evaluate`` of ``dataset`` in batches of 500, and
  its results."""
  import torch
  t0 = time.time()
  results = evaluator.evaluate(dataset, batch_size=500)
  torch.cuda.synchronize()
  return time.time() - t0, results


def phase_msd_big(train_m, val_in, val_tg, device='cuda'):
  """(a) scripts/msd-big/train.py's configuration: 20 steps against the
  plain path and the row scatter at the tables' shape; then 1 epoch
  eager, with a validation (loss and Recall@20/50, NDCG@100 at k=100,
  chunked by LARGE_CHUNK) at its end: two row-scatter launches a step and
  no other hand kernel; the evaluation pipelined and synchronous."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.data.loader import RecommendationDataLoader
  from recoder_tpu_torch.metrics import RecommenderEvaluator
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.recommender import InferenceRecommender

  def make():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      sparse=True, compute_dtype='bfloat16'),
                   optimizer_type='adam', loss='logloss', user_based=False,
                   eval_item_chunk=LARGE_CHUNK, device=device)

  train_ds = RecommendationDataset(train_m)
  kernel, plain = make(), make()
  family_paths(train_ds, kernel, plain, MSD_BIG_TRAIN, {'row_scatter': 2},
               BF16_PATHS_RTOL, '(a) msd-big step', tables=(
                   'en_embedding', 'de_embedding'))
  widths = union_widths(kernel)
  n_rows = kernel.model.params()['en_embedding'].shape[0]
  del kernel, plain
  check_scatter(*scatter_case(n_rows, 200, int(widths.max()), device),
                f'[{n_rows}, 200] at a union of {widths.max()}')
  say(f'  (a) row_scatter at [{n_rows:,}, 200] x {widths.max():,} ids (the '
      'widest of the 20 steps\' unions): bitwise index_copy_')
  trainer = make()
  val_ds = RecommendationDataset(val_in, val_tg)
  metrics = _msd_big_metrics()
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  t0 = time.time()
  trainer.train(train_ds, val_dataset=val_ds, num_epochs=1, eval_freq=1,
                eval_num_recommendations=100, metrics=metrics,
                fused_steps_per_call=1, **MSD_BIG_TRAIN)
  torch.cuda.synchronize()
  call_s = time.time() - t0
  counts = {k: v for k, v in read_launches().items() if v}
  steps = len(trainer.last_epoch_losses)
  if steps != -(-MSD_BIG_USERS // 500) or counts != {'row_scatter': 2 * steps}:
    raise AssertionError(f'(a) {steps} steps launched {counts}: expected '
                         'two row-scatter launches a step, nothing else')
  losses = np.asarray(trainer.last_epoch_losses)
  if not (np.all(np.isfinite(losses))
          and losses[-20:].mean() < losses[:20].mean()):
    raise AssertionError(f'(a) the loss did not fall: {losses}')
  rate = steps / trainer.last_epoch_seconds
  widths = np.diff(trainer.fused_data_source._block_unions()['ptr'])
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  say(f'  (a) 1 epoch of {steps} steps: {MSD_BIG_RATE} {rate:.2f} (the '
      f'train call with its validation {call_s:.1f} s); loss first 20 steps '
      f'{losses[:20].mean():.4f}, last 20 {losses[-20:].mean():.4f}; '
      f'row_scatter {counts["row_scatter"]} launches (2 a step); union '
      f'widths mean {widths.mean():.1f}, min {widths.min()}, max '
      f'{widths.max()} over {len(widths)} blocks; peak device memory '
      f'{peak:.2f} GiB')
  loader = RecommendationDataLoader(val_ds, batch_size=500,
                                    negative_sampling=True,
                                    seed=trainer.seed + 1)
  t0 = time.time()
  val_loss = trainer._validate(loader)
  val_s = time.time() - t0
  recommender = InferenceRecommender(trainer, 100)
  evaluators = {
      'pipelined': RecommenderEvaluator(recommender, metrics),
      'synchronous': RecommenderEvaluator(
          types.SimpleNamespace(recommend=recommender.recommend), metrics)}
  eval_s = {name: [] for name in evaluators}
  for name in [*evaluators, *evaluators]:
    seconds, got = _evaluation_s(evaluators[name], val_ds)
    eval_s[name].append(seconds)
    if name == 'pipelined':
      results = got
    elif got != results:
      raise AssertionError('(a) the pipelined evaluation differs from the '
                           'synchronous one')
  means = {str(k): float(np.mean(v)) for k, v in results.items()}
  if not np.isfinite(val_loss) or not all(0 < v < 1 for v in means.values()):
    raise AssertionError(f'(a) validation: loss {val_loss}, metrics {means}')
  say(f'  (a) validation of {MSD_BIG_HELD_OUT:,} held-out users: loss '
      f'{val_loss:.4f} in {val_s:.3f} s ({len(loader)} union batches); '
      f'metrics chunked by {LARGE_CHUNK:,}: '
      + ', '.join(f'{k} {v:.4f}' for k, v in means.items())
      + '; evaluation s in turns (the same results): '
      + ', '.join(f'{k} ' + ' / '.join(f'{t:.3f}' for t in v)
                  for k, v in eval_s.items()))
  _, busy_ms, _, _ = profile_steps(trainer, train_ds, MSD_BIG_TRAIN,
                                   steps=10)
  step_ms = 1e3 / rate
  say(f'  (a) the epoch\'s step {step_ms:.3f} ms without the profiler: the '
      f'device idle ~{100 * (1 - busy_ms / step_ms):.1f}% of it')
  return trainer, {'rate': rate, 'widths': widths, 'val_s': val_s,
                   'eval_s': {k: min(v) for k, v in eval_s.items()},
                   'metrics': means, 'busy_ms': busy_ms,
                   'per_step': {k: v / steps for k, v in counts.items()}}


def _recommend_timed(trainer, users, chunk, reps=3):
  """``recommend(users, 100)`` with ``eval_item_chunk=chunk``: the ids,
  the median ms of ``reps`` calls (host clock; the ids come back to the
  host) and the peak device memory above what was allocated before."""
  import torch
  trainer.eval_item_chunk = chunk
  trainer.recommend(users, 100)
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  times = []
  for _ in range(reps):
    t0 = time.time()
    recs = trainer.recommend(users, 100)
    times.append((time.time() - t0) * 1e3)
  peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  return recs, statistics.median(times), peak


def _reference_scores(trainer, users):
  """float32 scores ``[B, W]`` of the chunked path's arithmetic over the
  whole catalog at once, seen items and pad columns at -inf."""
  import torch
  model = trainer.model
  with torch.no_grad():
    rows, cols, vals, ids = trainer._inference_coo(users)
    h = model.encode_coo(rows, cols, vals, ids.shape[0], input_users=ids)
    s = model.decode_slice(h, 0, model.num_items_padded).float()
    s[rows, cols] = float('-inf')
    s[:, model.num_items:] = float('-inf')
  return s


def _metric_means(recs, target, metrics):
  relevant = [target.indices[target.indptr[i]:target.indptr[i + 1]]
              for i in range(target.shape[0])]
  keep = [i for i, y in enumerate(relevant) if len(y)]
  rect = np.asarray([recs[i] for i in keep])
  return {str(m): float(np.mean(m.evaluate_batch(
      rect, [relevant[i] for i in keep]))) for m in metrics}


def phase_msd_big_scoring(trainer, val_in, val_tg):
  """(b) on (a)'s model, 500 held-out users: chunked (LARGE_CHUNK)
  against monolithic recommend -- ms, peak memory, ids and metrics; every
  eval_topk mode the same ids; ops/topk.top_k and torch.topk alone at
  [500, 1,000,192], k=100."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.ops.topk import MODES, top_k
  users, target = RecommendationDataset(val_in, val_tg)[np.arange(500)]
  chunked, chunked_ms, chunked_gib = _recommend_timed(trainer, users,
                                                      LARGE_CHUNK)
  mono, mono_ms, mono_gib = _recommend_timed(trainer, users, 0)
  for name, recs in (('chunked', chunked), ('monolithic', mono)):
    check_recommendations([np.asarray(r) for r in recs],
                          users.interactions_matrix, 100, MSD_BIG_ITEMS)
  s = _reference_scores(trainer, users)
  scale = float(s[torch.isfinite(s)].abs().max())
  tol, tol32 = SCORE_TOL * scale, SCORE_TOL_F32 * scale
  ref_v, ref_i = top_k(s, 101)
  ref_v, ref_i, ref = ref_v[:, :100], ref_i[:, :100], ref_v.cpu().numpy()
  got_c = s.gather(1, torch.tensor(chunked, device=s.device))
  worst_c = float((got_c - ref_v).abs().max())
  if not worst_c <= tol32:
    raise AssertionError(f'(b) a chunked score is {worst_c} from the same '
                         f'rank of the reference top-100 (tolerance {tol32})')
  decided = ref[:, 99] - ref[:, 100] > tol32
  ref_ids = ref_i.cpu().numpy()
  differ = [u for u in np.flatnonzero(decided)
            if set(chunked[u]) != set(ref_ids[u])]
  if differ:
    raise AssertionError(f'(b) chunked and reference ids differ for users '
                         f'{differ[:10]} whose 100th and 101st scores are '
                         f'more than {tol32} apart')
  same_ids = int(sum(np.array_equal(a, b) for a, b in zip(chunked, ref_ids)))
  got_m = torch.sort(s.gather(1, torch.tensor(mono, device=s.device)), dim=1,
                     descending=True).values
  worst_m = float((got_m - ref_v).abs().max())
  if not worst_m <= tol:
    raise AssertionError(f'(b) a monolithic score is {worst_m} from the '
                         f'reference top-100 (tolerance {tol})')
  metrics = _msd_big_metrics()
  m_r = _metric_means(ref_ids.tolist(), target.interactions_matrix, metrics)
  m_c = _metric_means(chunked, target.interactions_matrix, metrics)
  m_m = _metric_means(mono, target.interactions_matrix, metrics)
  gap_c = max(abs(m_c[k] - m_r[k]) for k in m_c)
  gap_m = max(abs(m_m[k] - m_c[k]) for k in m_c)
  if not (gap_c <= CHUNKED_METRIC_ATOL and gap_m <= METRIC_ATOL):
    raise AssertionError(f'(b) metrics chunked {m_c}, reference {m_r}, '
                         f'monolithic {m_m}')
  say(f'  (b) recommend k=100 for 500 users at {MSD_BIG_ITEMS:,} items: '
      f'chunked ({LARGE_CHUNK:,}) {chunked_ms:.2f} ms, peak {chunked_gib:.3f}'
      f' GiB; monolithic {mono_ms:.2f} ms, peak {mono_gib:.3f} GiB')
  say(f'  (b) chunked against top_k of the float32 reference: scores within '
      f'{worst_c:.3g} rank by rank (tolerance {tol32:.3g}); '
      f'{int(decided.sum())} users with a decided 100th score, all with the '
      f'same id set; {same_ids} of 500 id lists identical in order; metrics '
      f'within {gap_c:.3g} (tolerance {CHUNKED_METRIC_ATOL}); monolithic '
      f'scores within {worst_m:.3g} of the reference top-100 (tolerance '
      f'{tol:.3g}), metrics within {gap_m:.3g} of chunked (tolerance '
      f'{METRIC_ATOL}); metrics chunked '
      + ', '.join(f'{k} {v:.4f}' for k, v in m_c.items())
      + ', monolithic ' + ', '.join(f'{k} {v:.4f}' for k, v in m_m.items()))
  for mode in MODES:
    trainer.eval_topk = mode
    for chunk, want in ((LARGE_CHUNK, chunked), (0, mono)):
      trainer.eval_item_chunk = chunk
      if trainer.recommend(users, 100) != want:
        raise AssertionError(f"(b) eval_topk={mode!r} changed the ids "
                             f"(chunk {chunk})")
  trainer.eval_topk = 'exact'
  say(f'  (b) eval_topk {list(MODES)}: the same ids, chunked and monolithic')
  v, i = top_k(s, 100)
  tv = torch.topk(s, 100).values
  if not torch.equal(v, tv) or not torch.equal(s.gather(1, i), v):
    raise AssertionError('(b) ops/topk.top_k values differ from torch.topk')
  ours = median_ms(lambda: top_k(s, 100), reps=10)
  theirs = median_ms(lambda: torch.topk(s, 100), reps=10)
  nbytes = s.numel() * 4 + 500 * 100 * 12
  say(f'  (b) top-k at {list(s.shape)}, k=100, float32 (CUDA events): '
      f'ops/topk.top_k {ours:.3f} ms, torch.topk {theirs:.3f} ms (bytes '
      f'bound {nbytes / PEAK_BYTES * 1e3:.3f} ms)')
  del s
  return {'chunked_ms': chunked_ms, 'mono_ms': mono_ms,
          'chunked_gib': chunked_gib, 'mono_gib': mono_gib,
          'top_k_ms': ours, 'torch_topk_ms': theirs}


def phase_stress_scoring(device='cuda'):
  """(c) scripts/stress_scale.py's default shape, scoring only: a
  DynamicAutoencoder[128] over 10,000,000 items, its tables drawn on the
  card from a seeded generator; Recoder resolves the chunk itself."""
  import torch
  from recoder_tpu_torch.data import UsersInteractions, synthetic
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.models.base import pad_dim
  model = DynamicAutoencoder([STRESS_DIM], 'tanh')
  trainer = Recoder(model, num_items=STRESS_ITEMS, device=device)
  model.num_items, model.num_items_padded = STRESS_ITEMS, pad_dim(STRESS_ITEMS)
  gen = torch.Generator(device=device).manual_seed(0)
  limit = float(np.sqrt(6.0 / (STRESS_DIM + STRESS_ITEMS)))

  def table(*shape, scale=limit):
    return torch.empty(shape, device=device).uniform_(-scale, scale,
                                                      generator=gen)
  W = model.num_items_padded
  model.register_params({
      'en_embedding': table(W, STRESS_DIM),
      'en_bias': torch.zeros(STRESS_DIM, device=device),
      'de_embedding': table(W, STRESS_DIM), 'de_bias': table(W, scale=0.1)})
  # (the tables were drawn on the card: the trainer must not draw them on
  # the host again)
  trainer._model_initialized = True
  chunk = trainer._resolve_eval_chunk()
  if chunk != Recoder.AUTO_CHUNK_WIDTH:
    raise AssertionError(f'(c) resolved chunk {chunk}')
  m = synthetic.synthesize(500, STRESS_ITEMS, 50, seed=1)
  users = UsersInteractions(np.arange(500), m)
  recs, ms, gib = _recommend_timed(trainer, users, None)
  check_recommendations([np.asarray(r) for r in recs], m, 100, STRESS_ITEMS)
  tables_gib = 2 * W * STRESS_DIM * 4 / 2 ** 30
  say(f'  (c) {STRESS_ITEMS:,} items x d={STRESS_DIM} ({tables_gib:.2f} GiB '
      f'of tables drawn on the card): chunk {chunk:,} resolved, '
      f'{-(-STRESS_ITEMS // chunk)} chunks; recommend k=100 for 500 users '
      f'{ms:.2f} ms, peak {gib:.3f} GiB over the tables; every id < '
      f'{STRESS_ITEMS:,}, unseen, distinct')
  return {'ms': ms, 'gib': gib}


def phase_full_catalog_sparse(msd, device='cuda'):
  """(d) bench.py's MSD --sparse shape with negative sampling off: the
  full-catalog sparse step (every table row a leaf and updated, no row
  scatter) 20 steps against the plain path; then the validation loss of
  full-catalog batches chunked (8,192) against dense."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.data.loader import RecommendationDataLoader
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      sparse=True),
                   optimizer_type='adam', loss='logloss', device=device)

  kw = dict(MSD_TRAIN, negative_sampling=False)
  trainer = make()
  per_step = family_paths(RecommendationDataset(msd), trainer, make(), kw,
                          {'packed_rows': 1}, PATHS_RTOL,
                          '(d) MSD full-catalog sparse step',
                          tables=('en_embedding', 'de_embedding'))
  rate = 20 / trainer.last_epoch_seconds
  _, busy_ms, _, _ = profile_steps(trainer, RecommendationDataset(msd), kw,
                                   steps=10)
  say(f'  (d) {1e3 / rate:.3f} ms a step over the 20 eager steps: the '
      f'device idle ~{100 * (1 - busy_ms * rate / 1e3):.1f}% of it')
  loader = RecommendationDataLoader(RecommendationDataset(msd[:5000]),
                                    batch_size=500)
  out = {}
  for chunk in (0, 8192):
    trainer.eval_item_chunk = chunk
    t0 = time.time()
    out[chunk] = trainer._validate(loader)
    out[f'{chunk} s'] = time.time() - t0
  rel = abs(out[8192] - out[0]) / abs(out[0])
  if not rel <= 1e-4:
    raise AssertionError(f'(d) chunked validation loss {out[8192]} vs dense '
                         f'{out[0]}')
  say(f'  (d) {rate:.2f} user-batches/s over the 20 eager steps; '
      f'validation of 5,000 users (full catalog): dense {out[0]:.6f} in '
      f'{out["0 s"]:.3f} s, chunked (8,192) {out[8192]:.6f} in '
      f'{out["8192 s"]:.3f} s, rel {rel:.3g}')
  return {'msd_full_catalog_sparse': per_step}, rate


def phase_large_catalog(card):
  """Phase 27 (a)-(c) and, on their data, phase 28 (b) and (c) and phases
  29 (a) and 30 (a); 27 (d) runs beside phase 26 (d) while the MSD CSR
  exists, (e) inside phase 6."""
  train_m, val_in, val_tg = msd_big_data()
  trainer, a = phase_msd_big(train_m, val_in, val_tg)
  b = phase_msd_big_scoring(trainer, val_in, val_tg)
  del trainer
  storage_b = run('28 bf16 storage (b): msd-big', phase_storage_msd_big,
                  train_m)
  union_a = run('29 union capture (a): msd-big', phase_union_capture_msd_big,
                train_m)
  users_a = run('30 users capture (a): msd-big', phase_users_capture_msd_big,
                train_m)
  del train_m
  c = phase_stress_scoring()
  storage_c = run('28 bf16 storage (c): 10,000,000 items',
                  phase_storage_scoring)
  say(f'  card: {card}')
  return a, b, c, storage_b, storage_c, union_a, users_a


# -- phase 28 --------------------------------------------------------------

BF16 = 'bfloat16'
#: phase 28 (a): bench.py's ML-20M default with --params-dtype bfloat16
STORAGE_RATE = 'ml20m_bf16_params_user_batches_per_sec'
CELL_KERNELS['ml20m_bf16_params'] = CELL_KERNELS['ml20m']
#: the float32 step over bf16 storage: the 3xTF32 pair, Adam
F32_OVER_BF16_STEP = {'fused_decode_loss_fwd': 1, 'fused_decode_loss_bwd': 1,
                      'adam_bf16': 1}
#: (e)'s Adam storage pairs (parameters, moments), beside phase 14's
ADAM_STORAGE = {'bf16 p / bf16 m': (BF16, BF16),
                'bf16 p / f32 m': (BF16, 'float32')}


def _dtypes(*names):
  import torch
  return tuple(getattr(torch, n) for n in names)


def phase_storage_kernels(device='cuda', full=(500, 200, 20224),
                          union=(500, 200, 18117)):
  """(e) Each kernel variant that reads or writes bf16 tables against its
  plain version, timed beside its bound: the wgmma decode-loss pair on
  bf16 rows at the ML-20M step (and bitwise the float32 rows of the same
  values), the mma.sync pair at an MSD union width, the 3xTF32 pair over
  bf16 rows (float32 compute); the Adam kernel's bf16-parameter pairs
  over the ML-20M parameter set. Returns {kernel: {variant: numbers}}."""
  import torch
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  bf = torch.bfloat16
  out = {}

  def note(name, variant, **numbers):
    out.setdefault(name, {})[variant] = numbers

  errs = {}
  for shape, route, cases in (
      (full, 'wgmma', [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]),
      (union, 'mma', [('mse', 3.0)])):
    for kind, c in cases:
      *err, got = compare_kernel(*shape, kind, c, device, bf, BF16, route,
                                 rows_dtype=bf)
      errs.setdefault(route, []).append(err)
  # bf16 rows against float32 rows holding the same values: bitwise
  h, rows, bias, target, rm, cm = make_problem(*full, device)
  target = target.to(bf)
  rows, bias = rows.to(bf), bias.to(bf)
  runs = []
  for r, b in ((rows, bias), (rows.float(), bias.float())):
    leaves = [x.clone().requires_grad_(True) for x in (h, r, b)]
    fdl.fused_decode_loss(*leaves, target, rm, cm, 'mse', 3.0,
                          BF16).backward()
    runs.append([x.grad.float() for x in leaves])
  if not all(torch.equal(a, b.to(bf).float())
             for a, b in zip(runs[0], runs[1])):
    raise AssertionError('(e) bf16 rows: the gradients are not those of '
                         'the float32 rows of the same values')
  say('  (e) bf16 rows on the wgmma route: gradients bitwise those of '
      'float32 rows holding the same values, each rounded once')
  *f32_err, _ = compare_kernel(*full, 'mse', 3.0, device, rows_dtype=bf)
  times = time_kernel(*full, 'mse', 3.0, device, BF16, bf,
                      routes=('wgmma', 'mma'), rows_dtype=bf)
  report_times(times, full, f'bf16 rows, mse c=3 {list(full)}',
               target_bytes=2, bf16=True, param_bytes=2)
  bounds = decode_loss_bounds(*full, target_bytes=2, bf16=True,
                              param_bytes=2)
  f32_times = time_kernel(*full, 'mse', 3.0, device, rows_dtype=bf)
  report_times(f32_times, full, f'float32 compute over bf16 rows {list(full)}',
               param_bytes=2)
  f32_bounds = decode_loss_bounds(*full, param_bytes=2)
  dev = times['device']
  for route, fwd, bwd in (
      ('wgmma', 'fused_decode_loss_fwd_bf16_wgmma',
       'fused_decode_loss_bwd_bf16_wgmma'),
      ('mma', 'fused_decode_loss_fwd_bf16', 'fused_decode_loss_bwd_bf16')):
    loss_e = max(e[0] for e in errs[route])
    grad_e = max(e[1] for e in errs[route])
    for name, step, e in ((fwd, 'fwd', loss_e), (bwd, 'bwd', grad_e)):
      note(name, 'bf16 rows', max_abs_err=e, ms=dev[route][step],
           plain_ms=dev['plain'][step], bound_ms=bounds[step][0],
           bound_by=bounds[step][1], shape=list(full))
  fdev = f32_times['device']
  for name, step, e in (('fused_decode_loss_fwd', 'fwd', f32_err[0]),
                        ('fused_decode_loss_bwd', 'bwd', f32_err[1])):
    note(name, 'float32 compute over bf16 rows', max_abs_err=e,
         ms=fdev['kernel'][step], plain_ms=fdev['plain'][step],
         bound_ms=f32_bounds[step][0], bound_by=f32_bounds[step][1],
         shape=list(full))

  n = sum(int(np.prod(sh)) for sh in ML20M_PARAM_SHAPES)
  for variant, names in ADAM_STORAGE.items():
    storage = _dtypes(*names)
    err = max(check_adam(ML20M_PARAM_SHAPES, device, storage=storage),
              check_adam(((1_000_003,),), device, storage=storage))
    t = time_adam(ML20M_PARAM_SHAPES, device, storage=storage)
    per = 3 * storage[0].itemsize + 4 * storage[1].itemsize
    b_ms, by = bound(0.0, float(per) * n)
    say(f'  (e) adam {variant}: 5 steps over {n:,} parameters and 1,000,003 '
        f'against the plain version, max abs diff {err:.3g} (bf16 buffers '
        f'within 1 bf16 ulp, float32 within 2 float32 ulps); device time '
        f'kernel {t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
        f'torch.optim.Adam(fused=True) on float32 state (another function) '
        f'{t["torch.optim.Adam(fused=True), float32 state"]:.4f} ms; bound '
        f'{b_ms:.4f} ms ({by}: {per} B a parameter), kernel at '
        f'{100 * b_ms / t["kernel"]:.1f}%')
    note('adam_bf16', variant, max_abs_err=err, ms=t['kernel'],
         plain_ms=t['plain'], bound_ms=b_ms, bound_by=by)
  return out


def storage_cells(dataset, trainers, kw):
  """Bench.py's ML-20M default at float32 and at bf16 parameters, each
  captured ('auto') after its first captured call, then in turns (f32,
  bf16, bf16, f32) captured and eager: rates, peak device memory above
  the resident, and a profile of 64 replayed steps (device ms, launches,
  each hand kernel by name) and of 16 eager steps."""
  import torch
  out = {}
  for name, tr in trainers.items():
    tr.train(dataset, num_epochs=tr.current_epoch, **kw)
    if not tr.last_epoch_dispatch.startswith('captured'):
      raise AssertionError(f'(a) {name}: did not capture')
    out[name] = {'captured': [], 'eager': [], 'peak': {}}
  order = list(trainers) + list(trainers)[::-1]
  for mode, spc in (('captured', 'auto'), ('eager', 1)):
    for name in order:
      tr = trainers[name]
      torch.cuda.synchronize()
      resident = torch.cuda.memory_allocated()
      torch.cuda.reset_peak_memory_stats()
      tr.train(dataset, num_epochs=tr.current_epoch,
               fused_steps_per_call=spc, **kw)
      torch.cuda.synchronize()
      out[name][mode].append(len(tr.last_epoch_losses)
                             / tr.last_epoch_seconds)
      out[name]['peak'][mode] = (torch.cuda.max_memory_allocated()
                                 - resident) / 2 ** 30
      out[name]['resident'] = resident / 2 ** 30
  for name, tr in trainers.items():
    for _ in range(3):  # (the profiler at times drops a device event)
      _, busy, launches, counts = profile_steps(
          tr, dataset, kw, steps=64, spc='auto',
          kernels=CELL_KERNELS['ml20m'])
      if all(v == 64 for v in counts.values()):
        break
    else:
      raise AssertionError(f'(a) {name} captured: kernels in 64 steps '
                           f'{counts}')
    _, ebusy, elaunches, _ = profile_steps(tr, dataset, kw, steps=16, spc=1)
    state = [v for st in tr.optimizer.state.values() for v in st.values()
             if torch.is_tensor(v) and v.dim()]
    out[name].update(busy=busy, launches=launches, counts=counts,
                     eager_busy=ebusy, eager_launches=elaunches,
                     params_gib=sum(p.numel() * p.element_size()
                                    for p in tr.model.parameters()) / 2 ** 30,
                     state_gib=sum(v.numel() * v.element_size()
                                   for v in state) / 2 ** 30)
  for name, o in out.items():
    say(f'  (a) {name}: captured {STORAGE_RATE if "bf16" in name else "ml20m_user_batches_per_sec"} '
        + ', '.join(f'{r:.2f}' for r in o['captured'])
        + ', eager ' + ', '.join(f'{r:.2f}' for r in o['eager'])
        + f'; device {o["busy"]:.3f} ms and {o["launches"]:.1f} launches a '
        f'replayed step ({o["eager_busy"]:.3f} ms, {o["eager_launches"]:.1f}'
        f' eager); hand kernels in 64 replayed steps {o["counts"]}; an '
        f'epoch\'s peak above the {o["resident"]:.2f} GiB resident: captured '
        f'{o["peak"]["captured"]:.3f}, eager {o["peak"]["eager"]:.3f} GiB; '
        f'parameters {o["params_gib"]:.4f} GiB, moments '
        f'{o["state_gib"]:.4f} GiB')
  return out


def phase_storage_ml20m(matrix, train_m):
  """(a) bench.py's ML-20M default with --params-dtype bfloat16 (bf16
  compute, moments and parameters): 20 steps against the plain path, the
  fixture captured bitwise eager, and captured and eager in turns beside
  the float32-parameter default; 20 bf16-parameter union steps (static
  'blocks' widths, multiples of 128: every step on the wgmma route) and
  20 steps of float32 compute over bf16 storage (the
  3xTF32 pair on a float32 copy of the rows), each against the plain
  path."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  dataset = RecommendationDataset(matrix)
  per_step = {}
  kernel = _ml20m_trainer(params_dtype=BF16)
  per_step['ml20m_bf16_params'] = family_paths(
      dataset, kernel, _ml20m_trainer(plain=True, params_dtype=BF16),
      ML20M_TRAIN, ML20M_BF16_STEP, BF16_PATHS_RTOL,
      '(a) ML-20M, bf16 parameters')
  if not all(p.dtype == torch.bfloat16 for p in kernel.model.parameters()):
    raise AssertionError('(a) a parameter left bf16 storage')

  def fixture_trainer():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      params_dtype=BF16),
                   optimizer_type='adam', loss='mse',
                   loss_params={'confidence': 3}, opt_state_dtype=BF16)
  family_fixture_bitwise(train_m, fixture_trainer, CAPTURE_FIXTURE)

  union_kw = dict(ML20M_TRAIN, full_decode=False)
  union = _ml20m_trainer(params_dtype=BF16)
  reset_launches()
  union.train(dataset, num_epochs=1, iters_per_epoch=20,
              fused_steps_per_call=1, **union_kw)
  torch.cuda.synchronize()
  counts = {k: v for k, v in read_launches().items() if v}
  if (counts.get('fused_decode_loss_fwd_bf16_wgmma') != 20
      or counts.get('adam_bf16') != 20):
    raise AssertionError(f'(a) the bf16-parameter union steps launched '
                         f'{counts}')
  plain = plain_trainer_run(_ml20m_trainer(plain=True, params_dtype=BF16),
                            dataset, 20, dict(union_kw,
                                              fused_steps_per_call=1))
  rel = compare_losses(union.last_epoch_losses, plain, BF16_PATHS_RTOL,
                       '(a) bf16-parameter union steps')
  per_step['ml20m_bf16_params_union'] = {k: v / 20 for k, v in
                                         counts.items()}
  say(f'  (a) 20 bf16-parameter union steps (widths '
      f'{union_widths(union).tolist()}): launches {counts}; losses vs the '
      f'plain path max rel {rel:.3g}')
  del union
  per_step['ml20m_f32_compute_bf16_params'] = family_paths(
      dataset, _ml20m_trainer(params_dtype=BF16, compute_dtype='float32'),
      _ml20m_trainer(plain=True, params_dtype=BF16, compute_dtype='float32'),
      ML20M_TRAIN, F32_OVER_BF16_STEP, BF16_PATHS_RTOL,
      '(a) ML-20M, float32 compute over bf16 parameters')

  trainers = {'float32 parameters (bench.py default)': _ml20m_trainer(),
              'bf16 parameters': kernel}
  cells = storage_cells(dataset, trainers, ML20M_TRAIN)
  per_step['ml20m_bf16_params_captured'] = {
      name: cells['bf16 parameters']['counts'][key] / 64
      for name, key in (
          ('fused_decode_loss_fwd_bf16_wgmma',
           'decode_loss_fwd_bf16_wgmma_kernel'),
          ('fused_decode_loss_bwd_bf16_wgmma',
           'drows_dbias_bf16_wgmma_kernel'),
          ('adam_bf16', 'adam_bf16_kernel'))}
  return per_step, cells


def resident_gib(trainer):
  """The bytes of the tables and their moments (the row-sparse Adam's)
  and, beside them, the same elements at float32 (phase 27 (a)'s
  configuration), in GiB."""
  tensors = [trainer.model.params()[p] for p in trainer.sparse_states]
  tensors += [st[k] for st in trainer.sparse_states.values()
              for k in ('m', 'v')]
  got = sum(t.numel() * t.element_size() for t in tensors)
  return got / 2 ** 30, sum(t.numel() * 4 for t in tensors) / 2 ** 30


def phase_storage_msd_big(train_m, device='cuda', steps=60):
  """(b) phase 27 (a)'s msd-big step with bf16 parameters and bf16
  moments: 20 steps against the plain path (two row-scatter launches
  and one Adam launch a step), the row scatter bitwise index_copy_ at
  [1,000,192, 200] x the widest union for both moment dtypes and timed
  beside its bound, ``steps`` more steps timed and profiled; the
  resident bytes of tables and moments against float32."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import row_scatter as rs

  def make():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                      sparse=True, compute_dtype=BF16,
                                      params_dtype=BF16),
                   optimizer_type='adam', loss='logloss', user_based=False,
                   eval_item_chunk=LARGE_CHUNK, opt_state_dtype=BF16,
                   device=device)

  train_ds = RecommendationDataset(train_m)
  kernel, plain = make(), make()
  per_step = family_paths(train_ds, kernel, plain, MSD_BIG_TRAIN,
                          {'row_scatter': 2, 'adam_bf16': 1},
                          BF16_PATHS_RTOL, '(b) msd-big, bf16 storage',
                          tables=('en_embedding', 'de_embedding'))
  del plain
  gib, f32_gib = resident_gib(kernel)
  for st in kernel.sparse_states.values():
    if st['m'].dtype != torch.bfloat16:
      raise AssertionError('(b) the table moments are not bf16')
  widths = union_widths(kernel)
  n_rows = kernel.model.params()['en_embedding'].shape[0]
  W, d = int(widths.max()), 200
  variants = {}
  for variant, names in (('all bf16', (BF16,) * 3),
                         ('bf16 table, f32 moments',
                          (BF16, 'float32', 'float32'))):
    dtypes = _dtypes(*names)
    tables, ids, rows = scatter_case(n_rows, d, W, device, dtypes=dtypes)
    err = check_scatter(tables, ids, rows, f'{variant} [{n_rows}, {d}]')

    def k_call():
      rs.row_scatter_kernel(tables, ids, rows)

    def p_call():
      for t, r in zip(tables, rows):
        t.index_copy_(0, ids, r)

    # from a cold L2, as phase 10 times it: before each call a read of
    # 256 MB writes the last call's rows back and leaves L2 clean
    sweep = torch.ones(2 ** 26, device=device)
    times = {name: device_ms(fn, between=sweep.sum, skip='reduce_kernel')
             for name, fn in (('kernel', k_call), ('plain', p_call))}
    del sweep
    moved = sum(2 * W * d * dt.itemsize for dt in dtypes) + 8 * W
    b_ms, by = bound(0.0, float(moved))
    variants[variant] = dict(max_abs_err=err, ms=times['kernel'],
                             plain_ms=times['plain'], bound_ms=b_ms,
                             bound_by=by, library_ms=times['plain'],
                             shape=[n_rows, d, W])
    say(f'  (b) row_scatter {variant} at [{n_rows:,}, {d}] x {W:,} ids: '
        f'bitwise index_copy_; device time a call from a cold L2 kernel '
        f'{times["kernel"]:.4f} ms, index_copy_ x3 {times["plain"]:.4f} '
        f'ms; bound {b_ms:.4f} ms '
        f'({by}: {moved / 1e6:.1f} MB)')
    del tables, rows
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  kernel.train(train_ds, num_epochs=1, iters_per_epoch=steps,
               fused_steps_per_call=1, **MSD_BIG_TRAIN)
  torch.cuda.synchronize()
  peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  rate = len(kernel.last_epoch_losses) / kernel.last_epoch_seconds
  _, busy_ms, launches, _ = profile_steps(kernel, train_ds, MSD_BIG_TRAIN,
                                          steps=10)
  say(f'  (b) msd-big with bf16 tables and moments: {MSD_BIG_RATE} '
      f'{rate:.2f} over {steps} eager steps ({1e3 / rate:.3f} ms a step), '
      f'{busy_ms:.3f} ms of device time and {launches:.1f} launches a '
      f'profiled step; tables and moments resident {gib:.3f} GiB against '
      f'{f32_gib:.3f} GiB at float32; peak {peak:.3f} GiB above the '
      f'{base / 2 ** 30:.2f} GiB allocated before the steps')
  return {'per_step': per_step, 'rate': rate, 'busy_ms': busy_ms,
          'gib': gib, 'f32_gib': f32_gib, 'peak': peak,
          'scatter': variants}


def phase_storage_scoring(device='cuda', reference_users=100):
  """(c) phase 27 (c)'s 10,000,000 x 128 scorer from bf16 tables (drawn
  on the card in float32 from the same generator, rounded once): ms and
  peak memory for 500 users in the chunks Recoder resolves; the first
  ``reference_users`` users' ids the top-k of the same arithmetic over
  the whole catalog at once, but for swaps within 1e-5 of the largest
  score."""
  import torch
  from recoder_tpu_torch.data import UsersInteractions, synthetic
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.models.base import pad_dim
  from recoder_tpu_torch.ops.topk import top_k
  model = DynamicAutoencoder([STRESS_DIM], 'tanh', params_dtype=BF16)
  trainer = Recoder(model, num_items=STRESS_ITEMS, device=device)
  model.num_items, model.num_items_padded = STRESS_ITEMS, pad_dim(STRESS_ITEMS)
  gen = torch.Generator(device=device).manual_seed(0)
  limit = float(np.sqrt(6.0 / (STRESS_DIM + STRESS_ITEMS)))
  W = model.num_items_padded

  def table(*shape, scale=limit):
    return torch.empty(shape, device=device).uniform_(
        -scale, scale, generator=gen).to(torch.bfloat16)
  model.register_params({
      'en_embedding': table(W, STRESS_DIM),
      'en_bias': torch.zeros(STRESS_DIM, device=device),
      'de_embedding': table(W, STRESS_DIM), 'de_bias': table(W, scale=0.1)})
  trainer._model_initialized = True
  if any(p.dtype != torch.bfloat16 for p in model.parameters()):
    raise AssertionError('(c) the tables are not bf16')
  tables_gib = sum(p.numel() * p.element_size()
                   for p in model.parameters()) / 2 ** 30
  m = synthetic.synthesize(500, STRESS_ITEMS, 50, seed=1)
  users = UsersInteractions(np.arange(500), m)
  recs, ms, gib = _recommend_timed(trainer, users, None)
  check_recommendations([np.asarray(r) for r in recs], m, 100, STRESS_ITEMS)
  sub = UsersInteractions(np.arange(reference_users), m[:reference_users])
  s = _reference_scores(trainer, sub)
  tol = SCORE_TOL_F32 * float(s[torch.isfinite(s)].abs().max())
  ref_v, ref_i = top_k(s, 101)
  got = s.gather(1, torch.tensor(recs[:reference_users], device=s.device))
  worst = float((got - ref_v[:, :100]).abs().max())
  ref = ref_v.cpu().numpy()
  decided = ref[:, 99] - ref[:, 100] > tol
  ids = ref_i[:, :100].cpu().numpy()
  differ = [u for u in np.flatnonzero(decided)
            if set(recs[u]) != set(ids[u])]
  if not worst <= tol or differ:
    raise AssertionError(f'(c) bf16 tables: chunked ids off the reference '
                         f'(worst {worst}, tolerance {tol}; users {differ})')
  del s
  say(f'  (c) {STRESS_ITEMS:,} x d={STRESS_DIM} from bf16 tables '
      f'({tables_gib:.2f} GiB; float32 {2 * tables_gib:.2f}): recommend '
      f'k=100 for 500 users {ms:.2f} ms, peak {gib:.3f} GiB over the tables;'
      f' {reference_users} users against the top-k of the whole catalog at '
      f'once: scores within {worst:.3g} rank by rank (tolerance {tol:.3g}), '
      f'{int(decided.sum())} decided, the same id sets')
  return {'ms': ms, 'gib': gib, 'tables_gib': tables_gib}


# -- phase 29 --------------------------------------------------------------

#: the hand kernels of each phase-29 cell and their launches a step, by the
#: names in a profile: counted inside 32 replayed steps and 32 eager ones
UNION_CELLS = {
    'msd_big_bf16': {'row_scatter_kernel': 2, 'adam_bf16_kernel': 1},
    'msd_sparse': {'row_scatter_kernel': 2},
    'msd_full_catalog_sparse': {'packed_rows_kernel': 1},
    'ml20m_target_bf16': {'decode_loss_fwd_bf16_wgmma_kernel': 1,
                          'drows_dbias_bf16_wgmma_kernel': 1,
                          'adam_bf16_kernel': 1},
    'ml20m_union_bf16': {'decode_loss_fwd_bf16_wgmma_kernel': 1,
                         'drows_dbias_bf16_wgmma_kernel': 1,
                         'adam_bf16_kernel': 1},
}
#: the decode-loss forward of each route, by its name in a profile
FWD_ROUTES = {'wgmma': 'decode_loss_fwd_bf16_wgmma_kernel',
              'mma.sync': 'decode_loss_fwd_bf16_kernel',
              '3xTF32': 'decode_loss_fwd_kernel'}
#: a profile name -> the kernel's name in the kernels record
PROFILE_NAMES = {'row_scatter_kernel': 'row_scatter',
                 'adam_bf16_kernel': 'adam_bf16',
                 'packed_rows_kernel': 'packed_rows',
                 'decode_loss_fwd_bf16_wgmma_kernel':
                     'fused_decode_loss_fwd_bf16_wgmma',
                 'drows_dbias_bf16_wgmma_kernel':
                     'fused_decode_loss_bwd_bf16_wgmma'}


def _state_tensors(trainer):
  """A trainer's parameters, dense optimizer state and sparse table
  states, by name."""
  import torch
  out = {}
  for name, p in trainer.model.params().items():
    out[name] = p
    for k, v in trainer.optimizer.state.get(p, {}).items():
      if torch.is_tensor(v):
        out[f'{name}/{k}'] = v
  for path, st in trainer.sparse_states.items():
    out.update({f'{path}/sparse_{k}': v for k, v in st.items()})
  return out


def _bitwise_same(a, b):
  """Whether two trainers ended with the same last-epoch losses and the
  same parameters, moments and step counts, bit for bit."""
  import torch
  ta, tb = _state_tensors(a), _state_tensors(b)
  return (a.last_epoch_losses == b.last_epoch_losses and ta.keys() == tb.keys()
          and all(torch.equal(ta[k], tb[k]) for k in ta))


def exact_width_losses(trainer, dataset, kw, steps, profiled=False):
  """``steps`` eager steps of ``trainer`` on the batches the port trained
  on before the static widths: each step's exact union and interactions
  (``build_union_batch``; on full decode ``build_fd_batch``, in 'users'
  mode without a slab the exact triplet scatter), with the random ids
  the static path draws for the same global step. Returns the losses,
  the union widths and, ``profiled``, the steps' device ms a step."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  trainer.train(dataset, num_epochs=1, iters_per_epoch=0,
                fused_steps_per_call=1, **kw)  # (the source, no step)
  source, perm = trainer.fused_data_source, trainer._epoch_perm
  sparse = bool(trainer.model.sparse_param_paths())
  ns = kw['negative_sampling']
  full_decode = not ns or source.fd_width is not None
  losses, widths = [], []
  torch.cuda.synchronize()
  prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if profiled else None)
  if prof is not None:
    prof.start()
    settle_profiler()
  for i in range(steps):
    if full_decode:
      batch = source.build_fd_batch(perm, i)
    else:
      ids = None
      if source.num_random_negatives:
        source.position_negatives(i)
        ids = source._draw_negatives(source.neg_gen)
      batch = source.build_union_batch(perm, i, rand_ids=ids)
      widths.append(len(batch['items']))
    step = trainer._sparse_step_math if sparse else trainer._dense_step_math
    losses.append(float(step(batch, ns)))
    trainer._global_step += 1
  busy = None
  if prof is not None:
    torch.cuda.synchronize()
    prof.stop()
    busy = sum(r[0] for r in device_rows(prof.key_averages())) / steps
  return losses, np.asarray(widths), busy


def phase_union_capture(name, make, dataset, kw, rtol, steps=20, window=64,
                        profiled=32, boundary=False):
  """Phase 29's cell ``name``: the JAX scan over 'blocks' steps as CUDA
  graphs. ``make(noise)`` builds its trainer (``noise``: the model's
  noise_prob, None its own). (1) ``steps`` steps at
  fused_steps_per_call='auto' (3 warm-up steps, a graph of 16, a graph
  of 1) against the same steps eager: losses, parameters, moments and
  step counts bitwise equal; (2) with the noise off, the same steps
  eager against the exact-width batches the port built before
  (``exact_width_losses``) within ``rtol``; (3) captured and eager
  windows of ``window`` steps in turns: user-batches/s; (4) ``profiled``
  steps of each profiled: device ms and launches a step, the idle share,
  and each hand kernel of the cell (UNION_CELLS) and the decode-loss
  forward of each route, by name, inside the replays and the eager
  steps. ``boundary`` (phase 30): (1) starts ``steps // 2`` steps before
  the end of epoch 1, as a checkpoint of that step would, and takes
  ``steps`` steps of epoch 2 after them; (2) profiles the exact-width
  steps too. Returns the numbers."""
  import torch
  from recoder_tpu_torch import model as model_lib

  def trainer(noise):
    tr = make(noise)
    if runs:  # (one data source, built once, for the cell's trainers)
      tr._source_cache = runs['auto']._source_cache
    return tr

  runs = {}
  per_epoch = -(-dataset.interactions_matrix.shape[0] // kw['batch_size'])
  for spc in ('auto', 1):
    runs[spc] = trainer(None)
    if boundary:
      runs[spc]._iters_consumed = per_epoch - steps // 2
      runs[spc]._train_iterator_key = model_lib._RESUMED
    runs[spc].train(dataset, num_epochs=2 if boundary else 1,
                    iters_per_epoch=steps, fused_steps_per_call=spc, **kw)
  cap = runs['auto']
  if not cap.last_epoch_dispatch.startswith('captured'):
    raise AssertionError(f"{name}: 'auto' did not capture "
                         f'({cap.last_epoch_dispatch})')
  if not _bitwise_same(cap, runs[1]):
    raise AssertionError(f'{name}: {steps} captured steps differ from the '
                         'same steps eager')
  compared = steps + steps // 2 if boundary else steps
  say(f'  {name}: {compared} steps captured ({cap.last_epoch_dispatch}, '
      f'{cap.last_epoch_dispatches} dispatches, {cap.captures} graphs'
      + (f'; the last {steps // 2} of epoch 1, then {steps} of epoch 2'
         if boundary else '')
      + ') and eager: losses, parameters, moments and step counts bitwise '
      'equal')
  del runs[1]
  torch.cuda.empty_cache()

  static = trainer(0.0)
  static.train(dataset, num_epochs=1, iters_per_epoch=steps,
               fused_steps_per_call=1, **kw)
  exact, widths, exact_busy = exact_width_losses(trainer(0.0), dataset, kw,
                                                 steps, profiled=boundary)
  rel = compare_losses(static.last_epoch_losses, exact, rtol,
                       f'{name}: static against exact widths')
  source = static.fused_data_source
  static_widths = (source.static_widths() if kw['negative_sampling']
                   else {})
  if source._epoch is not None:  # ('users': the epoch's signature)
    static_widths['signature'] = source._epoch['sig']
  del static
  torch.cuda.empty_cache()
  say(f'  {name}: noise off, {steps} static-width steps against the exact-'
      f'width batches: max rel {rel:.3g}; static widths {static_widths}'
      + (f', exact union widths mean {widths.mean():.1f}, max '
         f'{widths.max()}' if len(widths) else '')
      + (f'; the exact-width steps: device {exact_busy:.3f} ms a step'
         if exact_busy is not None else ''))

  out = {m: {'rates': []} for m in ('captured', 'eager')}
  for mode in ('captured', 'eager', 'eager', 'captured'):
    cap.train(dataset, num_epochs=cap.current_epoch, iters_per_epoch=window,
              fused_steps_per_call='auto' if mode == 'captured' else 1, **kw)
    torch.cuda.synchronize()
    out[mode]['rates'].append(len(cap.last_epoch_losses)
                              / cap.last_epoch_seconds)
  kernels = UNION_CELLS[name]
  routes = tuple(k for k in FWD_ROUTES.values() if k not in kernels)
  for mode, spc in (('captured', 'auto'), ('eager', 1)):
    for _ in range(3):  # (the profiler at times drops a device event)
      _, busy, launches, counts = profile_steps(
          cap, dataset, kw, steps=profiled, spc=spc,
          kernels=tuple(k for k in kernels if kernels[k] == 1),
          routes=routes + tuple(k for k in kernels if kernels[k] != 1))
      if all(counts[k] == n * profiled for k, n in kernels.items()):
        break
    else:
      raise AssertionError(f'{name} {mode}: kernel launches in {profiled} '
                           f'steps: {counts}')
    steady = 1e3 / max(out[mode]['rates'])
    out[mode].update(busy=busy, launches=launches, steady_ms=steady,
                     idle=1 - busy / steady,
                     per_step={k: v / profiled for k, v in counts.items()})
  for mode, o in out.items():
    say(f'  {name} {mode:8s}: user-batches/s over windows of {window} '
        f'steps {", ".join(f"{r:.2f}" for r in o["rates"])} (steady step '
        f'{o["steady_ms"]:.3f} ms); device {o["busy"]:.3f} ms and '
        f'{o["launches"]:.1f} launches a profiled step, the device idle '
        f'~{100 * o["idle"]:.1f}%; hand kernels and decode-loss routes a '
        f'step {o["per_step"]}')
  out.update(rel=rel, static_widths=static_widths, exact_busy=exact_busy,
             exact_widths=(float(widths.mean()), int(widths.max()))
             if len(widths) else None)
  return out


def _union_capture_record(cells):
  """Launches a step of each kernel of the record inside the replays of
  each phase-29 cell."""
  record = {}
  for cell, out in cells.items():
    for key, n in out['captured']['per_step'].items():
      if key in PROFILE_NAMES and n:
        record.setdefault(PROFILE_NAMES[key], {})[cell] = n
  return record


def phase_union_capture_msd(msd):
  """Phase 29 (b) bench.py's MSD --sparse cell and (c) its full-catalog
  sparse step, on phase 11's CSR."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make(noise):
    return Recoder(DynamicAutoencoder([200], 'tanh', sparse=True,
                                      noise_prob=0.5 if noise is None
                                      else noise),
                   optimizer_type='adam', loss='logloss', device='cuda')

  dataset = RecommendationDataset(msd)
  return {
      'msd_sparse': run('29 union capture (b): MSD --sparse',
                        phase_union_capture, 'msd_sparse', make, dataset,
                        MSD_TRAIN, PATHS_RTOL),
      'msd_full_catalog_sparse': run(
          '29 union capture (c): the full-catalog sparse step',
          phase_union_capture, 'msd_full_catalog_sparse', make, dataset,
          dict(MSD_TRAIN, negative_sampling=False), PATHS_RTOL)}


def phase_union_capture_target(matrix, held_out):
  """Phase 29 (d): bf16 'mse' target training in 'blocks' (the dual CSRs)
  on phase 22's split."""
  from recoder_tpu_torch.data import RecommendationDataset

  def make(noise):
    tr = _ml20m_trainer()
    if noise is not None:
      tr.model.noise_prob = noise
    return tr

  return phase_union_capture('ml20m_target_bf16', make,
                             RecommendationDataset(matrix, held_out),
                             ML20M_TRAIN, BF16_PATHS_RTOL)


def phase_union_capture_ml20m(matrix):
  """Phase 29 (e): the ML-20M bf16 union path in 'blocks', megas of 2,000
  and 1,000 random negatives."""
  from recoder_tpu_torch.data import RecommendationDataset

  def make(noise):
    tr = _ml20m_trainer()
    if noise is not None:
      tr.model.noise_prob = noise
    return tr

  return phase_union_capture(
      'ml20m_union_bf16', make, RecommendationDataset(matrix),
      dict(ML20M_TRAIN, full_decode=False, **NEGATIVES), BF16_PATHS_RTOL)


def phase_union_capture_msd_big(train_m, device='cuda'):
  """Phase 29 (a): phase 28 (b)'s msd-big step (bf16 tables and moments)."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make(noise):
    return Recoder(DynamicAutoencoder([200], 'tanh', sparse=True,
                                      noise_prob=0.5 if noise is None
                                      else noise,
                                      compute_dtype=BF16, params_dtype=BF16),
                   optimizer_type='adam', loss='logloss', user_based=False,
                   eval_item_chunk=LARGE_CHUNK, opt_state_dtype=BF16,
                   device=device)

  return phase_union_capture('msd_big_bf16', make,
                             RecommendationDataset(train_m), MSD_BIG_TRAIN,
                             BF16_PATHS_RTOL)


# -- phase 30 --------------------------------------------------------------

#: phase 30's cells: the hand kernels inside their replays, a step
UNION_CELLS.update({
    'msd_big_users_bf16': UNION_CELLS['msd_big_bf16'],
    'msd_sparse_users': UNION_CELLS['msd_sparse'],
    'ml20m_union_users_bf16': UNION_CELLS['ml20m_union_bf16'],
    'ml20m_scatter_users_bf16': UNION_CELLS['ml20m_union_bf16'],
})
#: bf16 cells whose replays must hold no mma.sync decode-loss launch
NO_MMA = ('ml20m_union_users_bf16', 'ml20m_scatter_users_bf16')
#: whole epochs phase 30 trains captured for the width signatures
USERS_EPOCHS = 6


def users_epochs(name, make, dataset, kw, epochs=USERS_EPOCHS, builds=3):
  """``epochs`` whole epochs of a fresh trainer of the cell, captured
  ('auto'): each epoch's width signature, the graphs captured in it, its
  seconds (the table build outside them) and rate; each capture's ms
  (host clock around it, synchronized); the gate's bytes (two epochs of
  the JAX tables); then the ms of ``builds`` more epochs' table builds
  (host clock around ``epoch_state``, synchronized: the order and
  windows on the host, the build on the card and its one read)."""
  import torch
  tr = make(None)
  capture_ms = []
  graph = tr._graph

  def timed(block, loop, path):
    if block in tr._graphs:
      return graph(block, loop, path)
    torch.cuda.synchronize()
    t0 = time.time()
    out = graph(block, loop, path)
    torch.cuda.synchronize()
    capture_ms.append((block, (time.time() - t0) * 1e3))
    return out

  tr._graph = timed
  rows = []
  for epoch in range(1, epochs + 1):
    before = tr.captures
    tr.current_epoch = epoch  # (train resumes at current_epoch inclusive)
    tr.train(dataset, num_epochs=epoch, fused_steps_per_call='auto', **kw)
    torch.cuda.synchronize()
    if tr.last_epoch_dispatch != 'captured, 16 steps a graph':
      raise AssertionError(f'{name} epoch {epoch}: {tr.last_epoch_dispatch}')
    source = tr.fused_data_source
    rows.append(dict(epoch=epoch, signature=source._epoch['sig'],
                     captures=tr.captures - before,
                     seconds=tr.last_epoch_seconds,
                     rate=len(tr.last_epoch_losses) / tr.last_epoch_seconds))
  gate = (source.users_precompute, 2 * source._jax_epoch_table_bytes())
  if not gate[0]:
    raise AssertionError(f'{name}: outside the JAX gate '
                         f'({source.precompute_reason})')
  fd = source._epoch['key'][1]
  build_ms = []
  for epoch in range(epochs + 1, epochs + 1 + builds):
    torch.cuda.synchronize()
    t0 = time.time()
    source.epoch_state(epoch, full_decode=fd)
    torch.cuda.synchronize()
    build_ms.append((time.time() - t0) * 1e3)
  del tr._graph  # (the trainer and its graphs go with the cell)
  signatures = [r['signature'] for r in rows]
  say(f'  {name}: the gate True, two epochs of the JAX tables '
      f'{gate[1] / 2**20:.1f} MiB; {epochs} epochs captured: signatures '
      f'{signatures} ({len(set(signatures))} distinct), graphs captured an '
      f'epoch {[r["captures"] for r in rows]}, each capture '
      + ', '.join(f'{b} step(s) {ms:.1f} ms' for b, ms in capture_ms)
      + '; epoch seconds ' + ', '.join(f'{r["seconds"]:.3f}' for r in rows)
      + ' (user-batches/s ' + ', '.join(f'{r["rate"]:.2f}' for r in rows)
      + '); an epoch\'s table build ' + ', '.join(f'{ms:.2f}'
                                                   for ms in build_ms)
      + ' ms')
  return dict(epochs=rows, capture_ms=capture_ms, build_ms=build_ms,
              gate_bytes=gate[1])


def phase_users_capture(name, make, dataset, kw, rtol):
  """Phase 30's cell ``name``: phase 29's checks over 'users' steps
  inside the JAX gate, from 10 steps before the end of epoch 1
  (:func:`phase_union_capture` with ``boundary``), then
  :func:`users_epochs`."""
  out = phase_union_capture(name, make, dataset, kw, rtol, boundary=True)
  mma = out['captured']['per_step'].get(FWD_ROUTES['mma.sync'], 0)
  if name in NO_MMA and mma:
    raise AssertionError(f'{name}: {mma} mma.sync launches a replayed step')
  out.update(users_epochs(name, make, dataset, kw))
  return out


def phase_users_capture_msd(msd):
  """Phase 30 (b): bench.py's MSD --sparse step in 'users' mode."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make(noise):
    return Recoder(DynamicAutoencoder([200], 'tanh', sparse=True,
                                      noise_prob=0.5 if noise is None
                                      else noise),
                   optimizer_type='adam', loss='logloss', device='cuda')

  return phase_users_capture('msd_sparse_users', make,
                             RecommendationDataset(msd),
                             dict(MSD_TRAIN, shuffle='users'), PATHS_RTOL)


def phase_users_capture_ml20m(matrix):
  """Phase 30 (c) the ML-20M bf16 union path, megas of 2,000, and (d)
  bench.py's ML-20M default without a slab (the triplet scatter), both
  in 'users' mode."""
  from recoder_tpu_torch.data import RecommendationDataset

  def make(noise):
    tr = _ml20m_trainer()
    if noise is not None:
      tr.model.noise_prob = noise
    return tr

  dataset = RecommendationDataset(matrix)
  users = dict(ML20M_TRAIN, shuffle='users')
  return {
      'ml20m_union_users_bf16': run(
          '30 users capture (c): the ML-20M bf16 union path',
          phase_users_capture, 'ml20m_union_users_bf16', make, dataset,
          dict(users, full_decode=False, num_sampling_users=2000),
          BF16_PATHS_RTOL),
      'ml20m_scatter_users_bf16': run(
          '30 users capture (d): the ML-20M default, the triplet scatter',
          phase_users_capture, 'ml20m_scatter_users_bf16', make, dataset,
          dict(users, full_decode=True, slab_cache=False),
          BF16_PATHS_RTOL)}


def phase_users_capture_msd_big(train_m, device='cuda'):
  """Phase 30 (a): msd-big as scripts/msd-big/train.py trains it ('users',
  sparse, logloss; bf16 tables and moments as phase 28 (b))."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  def make(noise):
    return Recoder(DynamicAutoencoder([200], 'tanh', sparse=True,
                                      noise_prob=0.5 if noise is None
                                      else noise,
                                      compute_dtype=BF16, params_dtype=BF16),
                   optimizer_type='adam', loss='logloss', user_based=False,
                   eval_item_chunk=LARGE_CHUNK, opt_state_dtype=BF16,
                   device=device)

  return phase_users_capture('msd_big_users_bf16', make,
                             RecommendationDataset(train_m),
                             dict(MSD_BIG_TRAIN, shuffle='users'),
                             BF16_PATHS_RTOL)


def run(name, fn, *args, **kwargs):
  say(f'== phase {name}')
  t0 = time.time()
  out = fn(*args, **kwargs)
  say(f'== phase {name}: ok ({time.time() - t0:.1f} s)')
  return out


def phase_bf16_slice(matrix, train_m, f32_profile, f32_rates):
  """Phase 4 at bench.py's ML-20M numerics, then phase 5 at bf16."""
  steps = -(-matrix.shape[0] // 500)
  launches, epoch_rate, rates, profile, cell = phase_slice(
      matrix, compute_dtype='bfloat16', opt_state_dtype='bfloat16')
  say(f'  kernel launches in the epoch of {steps} steps: {launches}')
  if any(v != steps for v in launches.values()):
    raise AssertionError(f'a kernel of the bf16 path was not launched once a '
                         f'step: {launches}')
  for name, (busy, per_step, steady_ms), r in (
      ('bf16', profile, rates), ('float32 (phase 4)', f32_profile,
                                 f32_rates)):
    say(f'  {name:17s}: device {busy:.3f} ms and {per_step:.1f} kernel '
        f'launches a profiled step; steady ml20m_user_batches_per_sec '
        f'{max(r):.2f} ({steady_ms:.3f} ms a step: the device idle '
        f'~{100 * (1 - busy / steady_ms):.1f}%)')
  phase_paths(train_m, compute_dtype='bfloat16',
              opt_state_dtype='bfloat16', rtol=BF16_PATHS_RTOL)
  return launches, epoch_rate, rates, profile[0], cell


def phase_bf16_quality(train_m, val_m):
  """The two bf16 rows of tests/test_model.py."""
  return [phase_quality(train_m, val_m, compute_dtype='bfloat16',
                        opt_state_dtype=osd, reload_atol=1e-6)
          for osd in (None, 'bfloat16')]


def main():
  import torch
  card = run('1 device', phase_device)
  sys.path.insert(0, HERE)
  from recoder_tpu_torch.data import synthetic

  run('2 build', phase_build)
  times, (loss_err, grad_err) = run('3 kernels', phase_kernels)
  t0 = time.time()
  matrix = synthetic.synthesize_ml20m()
  say(f'ML-20M-shaped CSR {matrix.shape}, nnz {matrix.nnz:,} '
      f'({time.time() - t0:.1f} s)')
  launches, epoch_rate, steady, f32_profile, _ = run('4 slice', phase_slice,
                                                     matrix)
  ml20m_steps = -(-matrix.shape[0] // 500)
  say(f'  kernel launches in the epoch: {launches}')
  if any(v < 1 for v in launches.values()):
    raise AssertionError(f'the main path did not launch every kernel: '
                         f'{launches}')
  train_m, val_m = load_fixture()
  run('5 paths', phase_paths, train_m)
  # (phase 28 (d)'s float32 checkpoint served from bf16 tables runs here)
  run('6 quality', phase_quality, train_m, val_m, chunked=1024,
      serve_bf16=True)
  spd_err, spd_times = run('7 spd kernel', phase_spd)
  (launches['spd_solve'], ials_launches_per_sweep, ials_fit_s,
   ials_sweeps) = run('8 ials slice', phase_ials_slice, matrix)
  del matrix
  run('9 ials quality', phase_ials_quality, train_m, val_m)

  t0 = time.time()
  msd = synthetic.synthesize_msd()
  msd_ids = np.unique(msd.indices[msd.indptr[0]:msd.indptr[500]])
  say(f'MSD-shaped CSR {msd.shape}, nnz {msd.nnz:,} '
      f'({time.time() - t0:.1f} s)')
  scatter_err, scatter_times = run('10 row-scatter kernel', phase_scatter,
                                   msd_ids)
  (launches['row_scatter'], msd_first, msd_rates, msd_step_ms, msd_busy_ms,
   widths) = run('11 sparse slice', phase_sparse_slice, msd)
  msd_steps = -(-msd.shape[0] // 500)
  _, union_times = run('12 union paths', phase_union_paths, train_m,
                       int(round(widths.mean())))
  run('13 sparse quality', phase_sparse_quality, train_m, val_m)
  # (phase 26's MSD cell runs here, while the MSD-shaped CSR is built)
  msd_neg_per_step, msd_neg_rate, msd_neg_widths = run(
      '26 negatives (d): MSD sparse', phase_negatives_msd, msd)
  full_catalog_per_step, full_catalog_rate = run(
      '27 large catalog (d): the full-catalog sparse step',
      phase_full_catalog_sparse, msd)
  # (phase 29's MSD cells (b) and (c) and phase 30's (b) run here too)
  union_cells = phase_union_capture_msd(msd)
  users_cells = {'msd_sparse_users': run('30 users capture (b): MSD --sparse',
                                         phase_users_capture_msd, msd)}
  (bf16_times, bf16_errs, adam_err, adam_times,
   adam_bound) = run('14 bf16 kernels', phase_bf16_kernels)
  matrix = synthetic.synthesize_ml20m()
  bf16_launches, bf16_first, bf16_rates, bf16_busy_ms, ml20m_cell = run(
      '15 bf16 slice', phase_bf16_slice, matrix, train_m, f32_profile,
      steady)
  launches.update(bf16_launches)
  del matrix
  bf16_quality = run('16 bf16 quality', phase_bf16_quality, train_m, val_m)
  packed_times, packed_bound = run('17 packed kernel', phase_packed_kernel)
  (msd_dense_launches, msd_dense_first, msd_dense_rates,
   msd_dense_profile, msd_cell) = run('18 msd dense', phase_msd_dense, msd,
                                      train_m)
  launches['packed_rows'] = msd_dense_launches['packed_rows']
  del msd
  packed_quality = run('19 packed quality', phase_packed_quality, train_m,
                       val_m)
  f32_replays, cells = run('20 captured steps', phase_capture, train_m,
                           ml20m_cell, msd_cell)
  del ml20m_cell, msd_cell
  t0 = time.time()
  matrix, held_out = split_held_out(synthetic.synthesize_ml20m())
  say(f'ML-20M-shaped CSR split 80/20 per user: input nnz {matrix.nnz:,}, '
      f'held out {held_out.nnz:,} ({time.time() - t0:.1f} s)')
  val_timing, val_rates, val_profile = run('21 validation', phase_validation,
                                           matrix, held_out)
  target_rates, workers, target_per_step, target_launches = run(
      '22 target training', phase_target, matrix, held_out)
  union_cells['ml20m_target_bf16'] = run(
      '29 union capture (d): bf16 target training', phase_union_capture_target,
      matrix, held_out)
  # the mma.sync bf16 kernels' path: the union widths of bf16 target
  # training
  launches.update({k: target_launches[k]
                   for k in BF16_ROUTE_COUNTERS['mma']})
  del matrix, held_out
  t0 = time.time()
  matrix = synthetic.synthesize_ml20m()
  say(f'ML-20M-shaped CSR again ({time.time() - t0:.1f} s)')
  mf_per_step, (_, mf_cell), mf_quality = run('23 mf', phase_mf, matrix,
                                              train_m, val_m)
  vae_per_step, (_, vae_cell), vae_quality = run(
      '24 multvae', phase_multvae, matrix, train_m, val_m)
  ease = run('25 ease', phase_ease, matrix, train_m, val_m)
  (neg_per_step, (_, neg_cell), neg_blocks_rate, neg_scatter_rate,
   (neg_routes, neg_widths), neg_quality) = run(
       '26 negatives', phase_negatives, matrix, train_m, val_m)
  union_cells['ml20m_union_bf16'] = run(
      '29 union capture (e): the ML-20M bf16 union path',
      phase_union_capture_ml20m, matrix)
  users_cells.update(phase_users_capture_ml20m(matrix))
  storage_kernels = run('28 bf16 storage (e): kernel variants',
                        phase_storage_kernels)
  storage_per_step, storage_cells_out = run(
      '28 bf16 storage (a): ML-20M', phase_storage_ml20m, matrix, train_m)
  del matrix
  storage_quality = run('28 bf16 storage (d): fixture gate', phase_quality,
                        train_m, val_m, compute_dtype=BF16,
                        opt_state_dtype=BF16, params_dtype=BF16)
  (big, big_scoring, stress, storage_msd, storage_scoring, union_a,
   users_a) = run('27 large catalog (a)-(c)', phase_large_catalog, card)
  union_cells['msd_big_bf16'] = union_a
  users_cells['msd_big_users_bf16'] = users_a
  union_record = _union_capture_record(union_cells)
  users_record = _union_capture_record(users_cells)
  # launches a step of each kernel on the MF / Mult-VAE paths: eager
  # epochs and compared steps by the counters, captured replays by the
  # profiles' names
  family = {}
  for path, counts in {**mf_per_step, **vae_per_step}.items():
    for name, n in counts.items():
      family.setdefault(name, {})[path] = n
  for path, cell, names in (
      ('mf_captured', mf_cell, {
          'fused_decode_loss_fwd_bf16_wgmma':
              'decode_loss_fwd_bf16_wgmma_kernel',
          'fused_decode_loss_bwd_bf16_wgmma': 'drows_dbias_bf16_wgmma_kernel',
          'adam_bf16': 'adam_bf16_kernel'}),
      ('multvae_captured', vae_cell, {'adam_bf16': 'adam_bf16_kernel'})):
    for name, key in names.items():
      family.setdefault(name, {})[path] = cell['captured']['counts'][key] / 64
  # launches a step on the paths of megas and random negatives (phase
  # 26): eager steps by the counters, the captured cell by its profile
  negatives = {}
  for path, counts in {**neg_per_step, **msd_neg_per_step}.items():
    for name, n in counts.items():
      negatives.setdefault(name, {})[path] = n
  for name, key in (
      ('fused_decode_loss_fwd_bf16_wgmma', 'decode_loss_fwd_bf16_wgmma_kernel'),
      ('fused_decode_loss_bwd_bf16_wgmma', 'drows_dbias_bf16_wgmma_kernel'),
      ('adam_bf16', 'adam_bf16_kernel')):
    negatives.setdefault(name, {})['ml20m_mega_users_captured'] = (
        neg_cell['captured']['counts'][key] / 64)
  # launches a step inside captured replays, by the profiles' names
  replayed = {
      'fused_decode_loss_fwd': f32_replays['decode_loss_fwd_kernel'],
      'fused_decode_loss_bwd': f32_replays['drows_dbias_kernel'],
      'fused_decode_loss_fwd_bf16_wgmma':
          cells['ml20m'][1]['captured']['counts'][
              'decode_loss_fwd_bf16_wgmma_kernel'] / 64,
      'fused_decode_loss_bwd_bf16_wgmma':
          cells['ml20m'][1]['captured']['counts'][
              'drows_dbias_bf16_wgmma_kernel'] / 64,
      'adam_bf16': cells['ml20m'][1]['captured']['counts'][
          'adam_bf16_kernel'] / 64,
      'packed_rows': cells['msd'][1]['captured']['counts'][
          'packed_rows_kernel'] / 64,
  }

  # device times at the training shape (phase 3); the others are the
  # phases' own measures (CUDA-event medians for the SPD solve, device
  # times for the row scatter)
  dev = times['device']
  fdl_bounds = decode_loss_bounds(500, 200, 20224)
  bdev = bf16_times['device']
  bf16_bounds = decode_loss_bounds(500, 200, 20224, target_bytes=2,
                                   bf16=True)
  B_spd, d_spd = 16384, 128
  n_ids, d_msd = len(msd_ids), 200
  measured = {
      'fused_decode_loss_fwd': (
          loss_err, dev['kernel']['fwd'], dev['plain']['fwd'], None,
          fdl_bounds['fwd'], launches['fused_decode_loss_fwd'] / ml20m_steps),
      'fused_decode_loss_bwd': (
          grad_err, dev['kernel']['bwd'], dev['plain']['bwd'], None,
          fdl_bounds['bwd'], launches['fused_decode_loss_bwd'] / ml20m_steps),
      'spd_solve': (
          spd_err, spd_times['kernel'], spd_times['blocked'],
          spd_times['linalg.solve'],
          bound(B_spd * (d_spd ** 3 / 3 + 2 * d_spd ** 2),
                4.0 * B_spd * (d_spd * (d_spd + 1) / 2 + 2 * d_spd)),
          ials_launches_per_sweep),
      'row_scatter': (
          scatter_err, scatter_times['kernel'], scatter_times['plain'],
          scatter_times['plain'],
          bound(0.0, 3 * 2 * n_ids * d_msd * 4.0 + 8 * n_ids),
          launches['row_scatter'] / msd_steps),
      # the mma.sync set timed at the full-decode shape (forced there)
      # beside the wgmma set; its launches are those of phase 22's bf16
      # target training, whose union widths it takes
      'fused_decode_loss_fwd_bf16': (
          bf16_errs['mma'][0], bdev['mma']['fwd'], bdev['plain']['fwd'],
          None, bf16_bounds['fwd'],
          target_per_step['fused_decode_loss_fwd_bf16']),
      'fused_decode_loss_bwd_bf16': (
          bf16_errs['mma'][1], bdev['mma']['bwd'], bdev['plain']['bwd'],
          None, bf16_bounds['bwd'],
          target_per_step['fused_decode_loss_bwd_bf16']),
      'fused_decode_loss_fwd_bf16_wgmma': (
          bf16_errs['wgmma'][0], bdev['wgmma']['fwd'], bdev['plain']['fwd'],
          None, bf16_bounds['fwd'],
          launches['fused_decode_loss_fwd_bf16_wgmma'] / ml20m_steps),
      'fused_decode_loss_bwd_bf16_wgmma': (
          bf16_errs['wgmma'][1], bdev['wgmma']['bwd'], bdev['plain']['bwd'],
          None, bf16_bounds['bwd'],
          launches['fused_decode_loss_bwd_bf16_wgmma'] / ml20m_steps),
      # no PyTorch call computes bf16-moment Adam (torch.optim.Adam on
      # float32 state, another function, is printed in phase 14)
      'adam_bf16': (
          adam_err, adam_times['kernel'], adam_times['plain'], None,
          adam_bound, launches['adam_bf16'] / ml20m_steps),
      # bitwise (phase 17 fails otherwise); no PyTorch call computes it
      'packed_rows': (
          0.0, packed_times['kernel'], packed_times['plain'], None,
          packed_bound, launches['packed_rows'] / msd_steps),
  }
  # launches a step on the large-catalog paths (phase 27): (a) msd-big's
  # sparse step, (d) the full-catalog sparse step
  large = {}
  for path, counts in {'msd_big_sparse': big['per_step'],
                       **full_catalog_per_step}.items():
    for name in SOURCES:
      large.setdefault(name, {})[path] = counts.get(name, 0.0)
  # launches a step on the bf16-storage paths (phase 28), and each
  # kernel's variants over bf16 tables (28 (e), the row scatter's in (b))
  storage = {}
  for path, counts in {**storage_per_step,
                       'msd_big_bf16_storage': storage_msd['per_step']}.items():
    for name in SOURCES:
      storage.setdefault(name, {})[path] = counts.get(name, 0.0)
  storage_kernels['row_scatter'] = storage_msd['scatter']
  kernels = [{'name': name, 'route': 'cuda', 'source': SOURCES[name],
              'replaces': REPLACES[name], 'launches': launches[name],
              'launches_per_step': per_step, 'max_abs_err': err, 'ms': ms,
              'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': by,
              'library_ms': library_ms,
              # whether it runs inside the captured step (phase 20), and
              # its launches a step in the replays' profile
              'captured': name in replayed,
              'captured_launches_per_step': replayed.get(name),
              # launches a step of training against a target matrix
              # (phase 22), and a validation batch (phase 21)
              'target_launches_per_step': target_per_step.get(name),
              'validation_launches_per_batch': val_timing[
                  'forwards_per_batch'].get(name),
              # launches a step on the MatrixFactorization and Mult-VAE
              # paths (phases 23-24; EASE runs no hand kernel)
              'family_launches_per_step': family.get(name),
              # launches a step with megas of 2,000 and 1,000 random
              # negatives (phase 26)
              'negatives_launches_per_step': negatives.get(name),
              # launches a step on the large-catalog paths (phase 27)
              'large_catalog_launches_per_step': large[name],
              # launches a step on the bf16-storage paths (phase 28), and
              # the variants over bf16 tables (max_abs_err, ms, plain_ms,
              # bound_ms, bound_by, library_ms where one exists)
              'bf16_storage_launches_per_step': storage[name],
              'bf16_storage_variants': storage_kernels.get(name),
              # launches a step inside the replays of the captured
              # 'blocks' union, sparse and target steps (phase 29)
              'union_capture_launches_per_step': union_record.get(name),
              # and of the captured 'users' steps over epoch tables
              # (phase 30)
              'users_capture_launches_per_step': users_record.get(name)}
             for name, (err, ms, plain_ms, library_ms, (bound_ms, by),
                        per_step) in measured.items()]
  # the packed kernel's mask-only launch (phase 17), beside its bound
  for k in kernels:
    if k['name'] == 'packed_rows':
      k.update(mask_only_ms=packed_times['mask kernel'],
               mask_only_plain_ms=packed_times['mask plain'],
               mask_only_bound_ms=packed_times['mask bound'])
  idle = [k['name'] for k in kernels if not k['launches']]
  if idle:
    raise AssertionError(f'kernels no path launched: {idle}')
  say(f'slice: {epoch_rate:.2f} user-batches/s first epoch, steady '
      f'{max(steady):.2f}; fused fwd+bwd {dev["kernel"]["fwd_bwd"]:.4f} '
      f'ms vs plain {dev["plain"]["fwd_bwd"]:.4f} ms (device; the pair\'s '
      f'bound {fdl_bounds["fwd_bwd"][0]:.4f} ms); iALS fit '
      f'{ials_fit_s:.3f} s, median sweep '
      f'{statistics.median(ials_sweeps):.3f} s; MSD sparse first epoch '
      f'{msd_first:.2f}, steady msd_user_batches_per_sec '
      f'{max(msd_rates):.2f} ({msd_step_ms:.3f} ms a profiled step, '
      f'{msd_busy_ms:.3f} ms of it on the device); row_scatter '
      f'{scatter_times["kernel"]:.4f} vs index_copy_ x3 '
      f'{scatter_times["plain"]:.4f} ms; fused fwd+bwd at an MSD union '
      f'{union_times["device"]["kernel"]["fwd_bwd"]:.4f} vs plain '
      f'{union_times["device"]["plain"]["fwd_bwd"]:.4f} ms; bf16 ML-20M '
      f'(bench.py default numerics) first epoch {bf16_first:.2f}, steady '
      f'ml20m_user_batches_per_sec {max(bf16_rates):.2f} '
      f'({bf16_busy_ms:.3f} ms of device time a profiled step), bf16 fused '
      f'fwd+bwd {bdev["wgmma"]["fwd_bwd"]:.4f} (wgmma) and '
      f'{bdev["mma"]["fwd_bwd"]:.4f} (mma.sync) vs plain '
      f'{bdev["plain"]["fwd_bwd"]:.4f} ms, adam kernel '
      f'{adam_times["kernel"]:.4f} ms; bf16 quality '
      + '; '.join(', '.join(f'{k} {v:.4f}' for k, v in q.items())
                  for q in bf16_quality)
      + f'; MSD dense (bench.py default, packed slab, bf16) first epoch '
      f'{msd_dense_first:.2f}, steady msd_user_batches_per_sec '
      f'{max(msd_dense_rates):.2f} ({msd_dense_profile[0]:.3f} ms of device '
      f'time a profiled step); packed_rows {packed_times["kernel"]:.4f} vs '
      f'plain {packed_times["plain"]:.4f} ms (bound {packed_bound[0]:.4f}); '
      'packed quality '
      + ', '.join(f'{k} {v:.4f}' for k, v in packed_quality.items())
      + '; captured vs eager steady: '
      + '; '.join(f'{name} {max(out["captured"]["rates"]):.2f} vs '
                  f'{max(out["eager"]["rates"]):.2f} (device idle '
                  f'{100 * out["captured"]["idle"]:.1f}% vs '
                  f'{100 * out["eager"]["idle"]:.1f}%)'
                  for name, (_, out) in cells.items())
      + '; validation an epoch (val loss, metrics) '
      + ', '.join(f'{v:.3f} s + {m:.3f} s' for v, m in zip(
          val_timing['val'], val_timing['metrics']))
      + f', the device idle {100 * val_profile[1]:.1f}% of a profiled '
      f'validation; captured ML-20M with eval_freq=1 '
      f'{max(val_rates[1]):.2f} vs without {max(val_rates[0]):.2f}; target '
      'training user-batches/s '
      + ', '.join(f'{cd} {sh} {r:.2f} (idle {100 * idle:.1f}%)'
                  for (cd, sh), (r, idle) in target_rates.items())
      + ', host loader (float32) in turns at 0 threads '
      + ', '.join(f'{r:.2f}' for r in workers[0]) + ' and at 4 threads '
      + ', '.join(f'{r:.2f}' for r in workers[4])
      + '; captured vs eager steady: '
      + '; '.join(f'{name} {max(out["captured"]["rates"]):.2f} vs '
                  f'{max(out["eager"]["rates"]):.2f} (device '
                  f'{out["captured"]["busy"]:.3f} ms a step, idle '
                  f'{100 * out["captured"]["idle"]:.1f}% vs '
                  f'{100 * out["eager"]["idle"]:.1f}%)'
                  for name, out in (('MF[200] bf16', mf_cell),
                                    ('Mult-VAE[600, 200] bf16', vae_cell)))
      + '; MF gate ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                 mf_quality.items())
      + '; Mult-VAE gate ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                       vae_quality.items())
      + f'; EASE lam 200 at ML-20M: Gram {ease["gram_s"]:.3f} s, Cholesky '
      f'inverse {ease["solve_s"]:.3f} s, fit {ease["fit_s"]:.3f} s, residual '
      f'{ease["residual"]:.3g}; EASE fixture Recall@20 '
      f'{ease["Recall@20"]:.4f}, NDCG@100 {ease["NDCG@100"]:.4f}; megas of '
      f'2,000 with 1,000 random negatives: captured vs eager steady '
      f'{NEG_RATE} {max(neg_cell["captured"]["rates"]):.2f} vs '
      f'{max(neg_cell["eager"]["rates"]):.2f} (device '
      f'{neg_cell["captured"]["busy"]:.3f} ms a step, idle '
      f'{100 * neg_cell["captured"]["idle"]:.1f}% vs '
      f'{100 * neg_cell["eager"]["idle"]:.1f}%), blocks captured '
      f'{neg_blocks_rate:.2f}, triplet scatter eager {neg_scatter_rate:.2f}, '
      f'bf16 union routes {neg_routes} (widths mean '
      f'{neg_widths.mean():.1f}), MSD sparse {msd_neg_rate:.2f} (widths mean '
      f'{msd_neg_widths.mean():.1f}), fixture '
      + ', '.join(f'{k} {v:.4f}' for k, v in neg_quality.items())
      + f'; msd-big sparse (1,000,000 items) {MSD_BIG_RATE} '
      f'{big["rate"]:.2f} ({big["busy_ms"]:.3f} ms of device time a '
      f'profiled step), union widths mean {big["widths"].mean():.1f}, '
      f'validation {big["val_s"]:.3f} s + metrics pipelined '
      f'{big["eval_s"]["pipelined"]:.3f} s (synchronous '
      f'{big["eval_s"]["synchronous"]:.3f} s; '
      + ', '.join(f'{k} {v:.4f}' for k, v in big['metrics'].items())
      + f'); recommend 500 users chunked {big_scoring["chunked_ms"]:.2f} ms '
      f'({big_scoring["chunked_gib"]:.3f} GiB) vs monolithic '
      f'{big_scoring["mono_ms"]:.2f} ms ({big_scoring["mono_gib"]:.3f} GiB); '
      f'top-k at [500, 1,000,192] ops/topk {big_scoring["top_k_ms"]:.3f} ms, '
      f'torch.topk {big_scoring["torch_topk_ms"]:.3f} ms; 10,000,000 items '
      f'{stress["ms"]:.2f} ms ({stress["gib"]:.3f} GiB); full-catalog sparse '
      f'MSD {full_catalog_rate:.2f}; bf16 storage: ML-20M captured '
      + '; '.join(f'{name} {max(o["captured"]):.2f} ({o["busy"]:.3f} ms a '
                  f'step, peak {o["peak"]["captured"]:.3f} GiB)'
                  for name, o in storage_cells_out.items())
      + f', msd-big {storage_msd["rate"]:.2f} ({storage_msd["gib"]:.3f} '
      f'against {storage_msd["f32_gib"]:.3f} GiB of tables and moments), '
      f'10,000,000 items from bf16 tables {storage_scoring["ms"]:.2f} ms '
      f'({storage_scoring["gib"]:.3f} GiB over '
      f'{storage_scoring["tables_gib"]:.2f} GiB), fixture '
      + ', '.join(f'{k} {v:.4f}' for k, v in storage_quality.items())
      + '; captured vs eager union, sparse and target steps (phase 29): '
      + '; '.join(f'{name} {max(o["captured"]["rates"]):.2f} vs '
                  f'{max(o["eager"]["rates"]):.2f} (device '
                  f'{o["captured"]["busy"]:.3f} vs {o["eager"]["busy"]:.3f} '
                  f'ms a step, idle {100 * o["captured"]["idle"]:.1f}% vs '
                  f'{100 * o["eager"]["idle"]:.1f}%)'
                  for name, o in union_cells.items())
      + "; captured vs eager 'users' steps over epoch tables (phase 30): "
      + '; '.join(f'{name} {max(o["captured"]["rates"]):.2f} vs '
                  f'{max(o["eager"]["rates"]):.2f} (device '
                  f'{o["captured"]["busy"]:.3f} vs {o["eager"]["busy"]:.3f} '
                  f'ms a step, exact widths {o["exact_busy"]:.3f}, idle '
                  f'{100 * o["captured"]["idle"]:.1f}% vs '
                  f'{100 * o["eager"]["idle"]:.1f}%; '
                  f'{len({r["signature"] for r in o["epochs"]})} signatures '
                  f'in {len(o["epochs"])} epochs, '
                  f'{sum(r["captures"] for r in o["epochs"])} graphs; table '
                  f'build {min(o["build_ms"]):.2f} ms)'
                  for name, o in users_cells.items())
      + f'; card {card}')
  say(json.dumps({'kernels': kernels}))
  say(card)
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
