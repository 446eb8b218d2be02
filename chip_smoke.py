#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pfn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the checkout

Phases, each printing one JSON line:
  1. card: the device, and its name and power limit from nvidia-smi (also
     printed raw on a line of its own). TF32 must be off for matmuls.
  2. build: compiles the CUDA sources of the checkout, one nvcc each, all at
     once, and reports ptxas's registers and spills of every kernel, by name,
     and nvcc's warnings; fails if a kernel named by SPILL_CHECKED spills
     (the *_sm90 bodies, the flash f32 bodies fwd_f32, dq_f32 and dkv_f32,
     and every kernel of the fused chains: gemm_f32, attn_f32, attn_bwd_f32,
     both LayerNorms, the bf16 cast, the ordered sums) or if a kernel is
     neither checked nor exempt (SPILL_EXEMPT), and names the kernels it
     checked.
  3. kernel: the PFN flash-attention forward kernel, both variants, against
     its plain dense f32 version over FLASH_CASES: T in {127, 128, 129, 2010}
     with sep in {0, 1, T//2, T-1}, and T in {255, 256, 257} with sep in {0,
     1, 127, 128, 129, T-1} (the sm_90a body's 128-row tile edges), and the
     f32 bodies' edges F32_EDGES (T and sep around 64, T around 384 with sep
     around 256); head dim in {32, 64, 128}, f32 and bf16, plus Tq != Tk for
     the prefix variant (with Tq 255/256/257 against Tk 385).
     Then kernel_timing: its time beside the plain version's at the
     main-path shape (B*H = 32, T = 2010, D = 128, bf16), held to the bf16
     budget at every sep of TIMING_SEPS, with TFLOP/s and the share of the
     bound; and the prefix variant at sep 1000.
  4. kernel_bwd: the dq and dk/dv kernels of the backward, both variants,
     against their plain dense f32 version over the same grid and the dk/dv
     kernel's own edges, DKV_EDGES (the prefix variant with a nonzero dlse,
     and Tq 63/64/65 against Tk 257), and the f32 edges with Tq 255/256/257
     against Tk 385; f32 at atol = rtol = 1e-4, bf16 by
     experiments/flash_equivalence.py's rule against the dense bf16 path's
     own error; a repeat backward bitwise equal; then autograd through
     pfn_attention(impl="flash") and impl="prefix" on the card against the
     dense path, under the same rule. Then item_attention: both prefix calls
     of the per-feature model's item attention at the tabpfn2 cell's shapes
     (ITEM_ATTENTION: the train rows, B*H 1 836, Tq sep; the test rows
     folded, B*H 306, Tq 6 (T - sep) against Tk 1 024), bf16 at head dim 32,
     at every sep of ITEM_ATTENTION_SEPS: the forward by the kernel phase's
     bf16 rule, dq and dk/dv by this phase's, a repeat backward bitwise
     equal, o and the gradients exactly zero at sep 0.
  5. kernel_bwd_timing: both backward kernels beside the plain backward and
     the dense bf16 backward at the training microbatch (B*H = 16, T = 2010,
     D = 128, bf16) at each sep of BWD_TIMING_SEPS, held to the bf16 rule
     with repeat dq and dk/dv calls bitwise equal, with TFLOP/s and the share
     of the bound; and the prefix variant at sep 1000, its repeat calls
     bitwise equal too.
  6. slice: GP-regression inference at the Fig-3a width (emsize 512, 4 heads,
     nhid 1024, 6 layers, bf16, seeded random weights through the weight
     bridge) at T = 2010: positional logits for 8 datasets, a PFNRegressor
     predict and predict_quantiles, the f64 exact-GP oracle and the analytic
     KL; the kernel path's logits against the dense path's, max-abs and
     relative L2 (logits_vs_dense), each within 2x the dense bf16 path's own
     distance from an f32 model + 1e-3, and each check must see a probe:
     the f32 model with the attention output scaled by 1 + FUSED_BF16_PROBE
     moves the logits past both budgets; a device profile of one
     positional-logits request.
  7. train: the round-5 Fig-3a recipe at full width through train(...): 2
     epochs of 2 updates (100 datasets each) with a checkpoint after epoch 1
     and a second train(...) call that resumes it; every kernel launched
     exactly 6 layers x 25 microbatches x 4 updates times; one update on the
     kernel path against the dense path (bf16_update_vs_dense: loss, grad
     norm and the whole clipped gradient vector, with a probe of
     FUSED_BF16_PROBE that must move the vector past its budget); update
     time, datasets/s, peak memory and a device profile of one update; a
     PFNRegressor from the result predicts a held-out dataset.
  8. fused_kernel: the fused encoder-layer forward kernel against its plain
     version (y, r and lse) over T in {1, 16, 100, 127, 128, 129, 512}, sep
     in {0, 1, T//2, T-1, T}, B in {1, 3} (and 64 at T = 100), (D, H, F) in
     {(512, 4, 1024), (64, 2, 96), (32, 2, 48)}, at the bf16 kernels'
     tile edges FUSED_FWD_EDGES, and in f32 at the f32 GEMM's tile edges
     FUSED_F32_EDGES; f32 at atol = rtol = 3e-5, bf16 by the rule
     err <= 2 * plain_bf16_err + 1e-3 against an f32 gold; a repeat call
     bitwise equal.
  9. fused_timing: one layer at the bench.py flagship shape (B 64, T 100,
     D 512, H 4, F 1024, bf16): the kernel, its plain version and the port's
     unfused PFNEncoderLayer forward by CUDA events, the kernel's and the
     unfused layer's device time, beside the bound; at the flagship sep a
     device profile of one kernel call (every device kernel: only the wgmma
     GEMM, the wgmma attention, the LayerNorm and the cast may appear), its
     device kernels per layer counted from it, and its host time per call.
 10. fused_bwd_kernel: the fused layer's two backward kernels (FFN, then
     attention) against fused_layer_bwd_plain on fused_kernel's grid, the
     bf16 GEMM's tile edges FUSED_BWD_EDGES and, in f32, FUSED_F32_EDGES, r
     and lse from the forward kernel: dx
     and all 12 gradients, f32 at atol = rtol = 3e-4, bf16 by the
     kernel_bwd rule against the plain bf16 backward's own error and an f32
     gold; a repeat call bitwise equal.
 11. fused_bwd_timing: both backward kernels at the flagship shape beside
     their plain versions, the unfused PFNEncoderLayer's backward (events
     and device time) and the bound; a device profile of one call of each
     (every device kernel), its host time per call and its device kernels
     per layer. Then fused_f32_timing: the three fused kernels' f32 bodies
     at the flagship shape and sep, held to their plain versions, repeat
     calls bitwise equal, and timed beside them and beside their yardsticks
     in the unfused f32 PFNEncoderLayer (dense attention at T 100), events
     and device time: the forward against its forward, the FFN backward
     against the FFN block's backward alone, the attention backward against
     the attention block's, both together against the whole backward; the
     f32 bound (67 TFLOP/s, 3.35 TB/s); a device profile of each chain by
     sub-kernel.
 12. fused_path: fused_forward at the bench.py flagship model (6 layers, 100
     buckets, bf16, seeded weights, 64 GP datasets of T = 100): logits
     against the unfused forward in bf16 and f32, the kernel launched once
     per layer per forward, the median of 5 forwards fused against unfused,
     and one backward through it on the card (each backward kernel launched
     once per layer, no flash kernel).
 13. fused_train: train(...) with attention_impl="fused" at the bench.py
     config (B 64, T 100, the flagship model, 100 buckets on (-4, 4), lr
     1e-4, the uniform sampler, grid-2048 GP prior), seeded weights: 2
     epochs of 2 updates with a checkpoint and a resume; each fused kernel
     launched 6 layers x 4 updates times and no flash kernel; one update
     fused against unfused (bf16 budget, f32 1e-4 relative); no host sync
     inside a fused update; update times fused and unfused, peak memory, a
     profile of one fused update. Then fused_f32_train: the same at
     TrainConfig's default dtype, f32, so the fused layer's f32 bodies run
     on a user's path: each launched 6 layers x 4 updates times, one update
     against the unfused f32 one within FUSED_TRAIN_F32_TOL, update times,
     datasets/s, peak memory and the idle share of a profiled update. Both
     hold loss, grad norm and the whole clipped gradient vector (relative
     L2), and each check must see a probe: the unfused f32 update with the
     attention output scaled by 1 + F32_PATH_PROBE moves the vector past
     the f32 tolerance, and scaled by 1 + FUSED_BF16_PROBE past the bf16
     budget.
 14. library_timing: F.scaled_dot_product_attention with the boolean PFN
     mask, forward and backward, at the flash kernels' timing shapes (the
     library yardstick of the kernels line; the port never calls it), and
     with the prefix rule's mask (the prefix variants' yardstick).
 15. tabular: the tabular classification slice at the TabularEvalSimple
     scale (TABULAR: the MLP prior at 60 features, BCE, emsize 512, 6
     layers, bptt 100, batch 256, f32, attention_impl "auto"): the prior
     alone (device ms of one batch, peak memory); train(...) for 2 epochs of
     2 updates with a checkpoint and a resume (bitwise equal to an
     uninterrupted run); at T = 100 the attention runs dense (flash_supported
     needs T >= 256, as the JAX package's rule): no flash kernel launches and
     the dense path runs once per layer per forward; update time,
     datasets/s, the prior's share of an update's device time, a device
     profile of one update without a flash body; PFNClassifier
     .from_checkpoint on held-out datasets (30 context rows, 70 queries):
     predict_proba latency, a profile of one request, auto-path logits
     against impl="dense" within TABULAR_F32_PATH_TOL; evaluate_position_pfn
     over 20 windows with ensembles 1 and 8 (the AUC is reported, not gated:
     the weights are trained a few steps). Then tabular_kernel_timing: the
     flash kernels' f32 bodies at B*H = 1024, T = 100, D = 128, sep 30,
     against their plain versions, their f32 bounds and SDPA with the PFN
     mask; then in the prefix variant against SDPA with the prefix mask;
     repeat calls of each body bitwise equal in both variants.
 16. dispatch: impl="dense" against impl="flash" at T 100 and 256, forward
     and forward + backward, bf16 at the bench.py flagship (B 64, H 4, D 128,
     sep 50) and f32 at the tabular shape (B*H 1024, sep 30), each flash
     output held to the dense f32 path; the auto rule on the card: dense at
     T 100 and 255, the kernels at T 256 and 2010.
 17. f32_long_timing: the f32 bodies at T 2010, D 128, sep 1000 (forward at
     B*H 32, backward at B*H 16), both variants, as tabular_kernel_timing.
     Then f32_path: the f32 bodies on a user's path, F32_PATH: gp_fitting's
     full configuration at the Fig-3a width in f32 (TrainConfig's default
     dtype) at T 2010, trained through train(...) for 2 epochs of 2 updates
     of 4 microbatches, served through PFNRegressor at context 1000 on 8
     datasets; each f32 body launched exactly once per layer per microbatch
     (and the forward once per layer per request); one update against the
     dense f32 path (relative F32_PATH_TOL; its reach at F32_PATH_PROBE);
     update time, datasets/s and a
     profile of one update (its idle share; the f32 bodies in it).
 18. fig3a: the ported Fig-3a experiments (pfn_tpu_torch.experiments) at the
     full width on the round-5 recipe (FIG3A_EXPERIMENTS), seeded weights:
     fig3a_longrun 1 epoch on the grid-8192 sampler, a resume to 2 with its
     scoring and f64 oracle (profiled: fwd_sm90, dq_sm90 and dkv_sm90 must
     run), bitwise equal to an uninterrupted 2-epoch run, 2 epochs on the
     exact sampler (s/epoch of both); fig3a_analytic_gap (f64 moments on the
     card, KL finite and >= -1e-6) and fig3a_robust_eval on 2 chunks of 8
     datasets; on that analytic gap's files the two gap analyses,
     bar_resolution_floor (the floor at 1000 and 10 000 buckets on borders
     rebuilt at cap 128, finite and >= 0, the out-of-support mass, the
     rebuilt 10 000 borders' shift against the run's) and
     analytic_gap_decompose (KL_total in f64 equal to the analytic gap's
     mean within 1e-6, the tail's share at ctx 1 and 2000), each timed;
     the oracle pass alone (its throughput); grid_fidelity with
     both methods at G 8192, T 2010, batch 64 (effective noise, the prior's
     moments); gp_fitting --quick cut to 2 epochs (finite, decreasing
     losses). The flash kernels' launches are counted over the phase.
 19. front_door: python -m pfn_tpu_torch.train's main in process at the
     Fig-3a width in f32 (FRONT_DOOR): (a) the README's quick-start command
     at bptt 1024, saved and warm-started (the f32 flash bodies at least
     once per layer per update, finite losses, the warm start bitwise; one
     update from seeded weights against the dense f32 path within
     F32_PATH_TOL, beside its reach at F32_PATH_PROBE); (b) the model
     options (normalized-uniform encoder, learned positions, SeqBN, dropout
     0.1) on the ridge prior with adaptive buckets, a resume bitwise equal
     to the uninterrupted run; (c) the stroke prior at 784 features with CE
     and the prior's device time; each run's update times, datasets/s and
     peak memory.
 20. comparison: the Bayesian comparison at its driver's reference config
     (COMPARISON: the BNN prior default_model_spec("small"), emsize 256, nhid
     512, 5 layers, 4 heads of 64, bptt 300, batch 256, f32, seeded bridge
     weights): train(...) for 2 epochs of 2 updates with a checkpoint and a
     resume bitwise equal to an uninterrupted run, each flash f32 body at D
     64 once per layer per update; update time and a profile of one update;
     one update against the dense f32 path (F32_PATH_TOL on the whole
     gradient vector, its reach at F32_PATH_PROBE); the fixed eval set of
     100 datasets, eval_transformer (the forward once per layer) against the
     dense path within 2e-5 x (1 + max) and its time by events; eval_svi
     (1024 steps and draws) and eval_mcmc (512 + 512, 15 leapfrog steps)
     batched over the datasets on the card: mean accuracy and NLL, seconds,
     HMC's acceptance rate, both above chance; the idle share of 8 SVI steps
     and of 2 HMC trajectories. Then f32_comparison_timing: the f32 bodies at
     the comparison's training shape (B*H 1024, T 300, D 64, sep 150; the
     44-row edge tile of 128-row tiles), as tabular_kernel_timing.
 21. tabular_baselines: bayes_net_metric (the BNN baseline, fitted by SVI on
     the card) through evaluate(...) over one synthetic dataset of 400 rows,
     4 windows at position 30: seconds per window and the AUC; the sklearn
     baselines raise an ImportError naming sklearn (the card's machine has
     none) without breaking the module's import.
 22. fewshot: pfn_tpu_torch.experiments.fewshot_omniglot's full config
     (FEWSHOT: emsize 1024, nhid 2048, 6 layers, 8 heads, bptt 26, batch
     64, 5-way 5-shot, 28 x 28 images): stroke pretraining through train(...)
     cut to 2 epochs of 2 updates, the weights saved and loaded back bitwise,
     the synthetic class bank (40 x 20, 30 classes for training) and its
     episodes on the card, zero-shot accuracy on 4 x 32 test episodes, 2
     finetune updates warm-started from the saved weights, their accuracy
     (reported, not gated); dense attention (T 26), no flash launch; update
     times, datasets/s, peak memory, a profile of one update, the episode
     prior's device ms per batch.
 23. bayesopt: pfn_tpu_torch.experiments.bayesopt_eval's full config
     (BAYESOPT), training cut to 2 epochs of 2 steps, the BO loop uncut (32
     functions x 25 iterations x EI and UCB over 128 candidates, random
     search): the regret table, ms per BO iteration, one iteration by events
     and its idle share; then one scoring request at 2048 candidates (T
     2076) on the auto path: the flash forward's f32 body at head dim 32,
     launched once per layer, its scores against the dense f32 path within
     2e-5 x (1 + max); the body alone at B*H 4, T 2076, D 32, sep 28 against
     its plain version, a repeat call bitwise equal, its ms, bound and SDPA
     f32's ms (the kernels line's f32_bayesopt row).
 24. gp_mix_oracles: GPMixPrior(num_features=1), 16 datasets at T 100
     (GP_MIX_ORACLES): gp_map_evaluate at every position 1-99 (150 Adam
     steps, 1 584 fits in one batch) and gp_hyper_mcmc_predictive (64 draws
     after 128, context 50, 50 queries, the 16 datasets batched): seconds,
     idle shares, HMC's acceptance; every MAP fit finite and their mean NLL
     falling from the first ten positions to the last ten, and the mixture
     predictive beating fixed bad hyperparameters.
 25. compat: pfn_tpu_torch.compat's docstring workflow through compat.train
     at its widths (bptt 2010, batch 4, 25 microbatches, f32; COMPAT), cut to
     2 updates: each flash f32 body launched 6 x 25 x 2 times; one update on
     the kernel path against the dense f32 path (one_update_vs_dense, its
     probe).
 26. native_cache: the C++ batch cache built with g++, 50 stroke-prior
     batches at the few-shot shape written, and read back through
     training_iter(prefetch=2) with each batch dropped once read (GB/s), 2 few-shot
     updates on the card from CachedPrior.training_iter(prefetch=2) equal
     bitwise to the same batches fed from memory (NATIVE_CACHE).
 27. debug_checks: one update at the Fig-3a width of a prior whose targets
     leave the bar support: a finite loss without the checks,
     FloatingPointError under pfn_debug_checks(), and with the flag off no
     host sync, where an update under the checks makes some.
 28. mesh: the parallel layer (pfn_tpu_torch.parallel) at the Fig-3a width
     (MESH: T 2010, 1000 buckets, seeded weights, a global batch of 4, 8 on
     the pipeline, sep 1000) on four ranks started with spawn that share the
     one card through a gloo group carrying CUDA tensors (their times are
     not a collective's speed): dp2 x sp2, dp2 x tp2, fsdp over dp4, dp2 x
     ep2 (4 experts) and pp2 x dp2 (4 microbatches, attention_impl
     "prefix"), one f32 update each, the whole clipped gradient vector and
     the parameter vector within MESH_TOL of the one-rank update on the
     card, the probe (F32_PATH_PROBE) moving the gradient vector past it;
     dp2 x sp2 in bf16 under the bf16 rule against the f32 gold; every
     rank's flash launches by variant (sp and pp: only the prefix variant,
     6 layers a microbatch, 3 a pp stage), the update's host and event
     times, peak memory per rank, rank 0's profile and idle share. Then
     mesh_nccl: world size 1 on NCCL from torchrun's environment variables,
     the dp path's update bitwise equal to the one-rank update, NCCL's
     all_gather and all_to_all on the card. Then moe: 4 experts at the
     Fig-3a width in bf16 through train(...) (MOE), 2 epochs of 2 updates,
     a checkpoint resumed bitwise, the flash kernels 6 a update, the
     load-balancing loss finite, a forward against the dense path by the
     bf16 rule, update time, datasets/s, peak memory.
 29. The measurement drivers (pfn_tpu_torch.experiments) at the full width,
     cut only in repeats and epochs (PROFILE_STEP_CONFIGS, MEASURE):
     profile_step at the Fig-3a microbatch (B 4, T 2010, grid 8192, 10 000
     buckets) and the flagship: stage times, the JAX formula's roofline
     share, 23.394064 M parameters at the Fig-3a microbatch, the flash
     launches of its stages exactly. batch_sweep: first the bf16 flash
     kernels at B*H 40 and 400, T 2010, sep 1000 and 1595 against their
     plain f32 versions (the forward by kernel_timing's budget, dq and
     dk/dv by kernel_bwd's rule, repeat calls bitwise equal), their ms
     beside their bounds (SWEEP_HOLD); then batch_shape_sweep's main, all
     six shapes 4x25 to 100x1 at T 2010 (every one must time), s/epoch and
     peak memory a shape. anomaly: anomaly_10x10's main, the step at 4x25,
     10x10, 20x5, the flash attention alone and the exact prior alone at B
     4, 10, 20, 25. fused_ab: fused_ab's main (auto, fused, auto at grid
     2048; the speedup), then flagship_throughput's main once (the exact
     sampler, and the stock-torch baseline on the card). Each phase's
     flash and fused launches are held to their expected counts and join
     the kernels line's.
 30. dkv_against_library: the dk/dv kernel at sep 1000, both variants,
     beside SDPA's backward less the dq kernel, from this run.
Then the kernels line (each kernel's launches on its path, error, time,
plain time, bound and library time, for the fused kernels also the library
call's device time, for the flash kernels also their f32 rows at T 100 and
T 2010 (and the prefix variant's at T 2010), the f32 rows at T 2010 with
their launches on f32_path and front_door's run (a), and the f32 rows at D
64, T 300 (f32_comparison) with their launches on the comparison's path
(both of which the kernels' launches on the main paths count too, as
they count the mesh and moe phases'; the flash entries' launches_prefix are
the mesh phase's prefix-variant launches; the
f32_long launches also the compat workflow's), the forward's f32 row at the
BO scoring shape (f32_bayesopt: D 32, T 2076, with its launches there), for
the fused kernels their f32 rows with their launches on fused_f32_train; its
route, and the design of its bf16 body), the run's seconds, and last {"ok":
true, "device": {...}}.

Any failure raises, so the script exits nonzero and prints no result line.
It also fails when there is no CUDA device, and when the package beside it
is missing. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TOL = 2e-5  # atol and rtol for f32, as tests/test_flash_attention.py uses
BF16_LSE_TOL = 1e-4  # lse from the same bf16 inputs: only the f32 summation order differs
F32_GRAD_TOL = 1e-4  # atol and rtol of f32 gradients, as tests/test_flash_attention.py uses
BF16_GRAD_FLOOR = 0.02  # bf16 gradient error floor of experiments/flash_equivalence.py
# The slice at the Fig-3a width (experiments/fig3a_longrun.py:173-179), depth
# and widths uncut; the weights are random.
FIG3A = dict(T=2010, datasets=8, n_ctx=1000, positions=[1, 10, 100, 1000, 2000], emsize=512, nhead=4,
             nhid=1024, nlayers=6, buckets=1000, grid=8192)
# Training at the round-5 Fig-3a recipe (ROUND5.md:27-28,
# experiments/fig3a_longrun.py:168-182): widths uncut, 100 datasets per
# update (4 x 25 microbatches), 2 epochs of 2 updates.
FIG3A_TRAIN = dict(T=2010, emsize=512, nhead=4, nhid=1024, nlayers=6, batch_size=4, agg=25, updates=2,
                   buckets=10_000, bucket_seq_cap=128, grid=8192, lr=1e-4, timed_updates=4)
# The tabular classification slice at the TabularEvalSimple scale, the
# non-quick config of experiments/tabular_eval.py (:98-111, 159-170): the MLP
# prior at 60 features (binary labels, categoricals, num_features_used ~
# UniformInt(1, 61), groups of 32 datasets), BCE, emsize 512, nhid 1024, 6
# layers, 4 heads, bptt 100, batch 256, lr 1e-4, warmup 25 epochs, f32,
# attention_impl "auto". Cut: 2 epochs of 2 updates (tabular_eval.py runs 300 of
# 100). Serving: 30 context rows and 70 queries of held-out datasets, and
# evaluate_position_pfn over 20 windows of a 119-row dataset at position 30.
TABULAR = dict(num_features=60, emsize=512, nhid=1024, nlayers=6, nhead=4, bptt=100, batch_size=256, lr=1e-4,
               warmup_epochs=25, updates=2, timed_updates=4, n_ctx=30, held_out=8, windows=20, ensembles=[1, 8])
# f32 logits on the kernel path against the dense path: 6 layers of f32
# summation-order differences (PERF.md section 2, as FUSED_PATH_F32_TOL).
TABULAR_F32_PATH_TOL = 1e-3
# The f32 bodies of the flash kernels at the tabular shape: B*H = 256 x 4,
# T = 100, D = 128, at sep 30 (the serving context).
TABULAR_KERNEL_SHAPE = dict(fwd_BH=1024, bwd_BH=1024, T=100, D=128, sep=30)
# The dispatch phase: dense against flash at these (B, H, D, sep) and T, and
# the auto rule at DISPATCH_AUTO_SEQS.
DISPATCH_SHAPES = {"bf16_flagship": (64, 4, 128, 50), "f32_tabular": (256, 4, 128, 30)}
DISPATCH_SEQS = [100, 256]
DISPATCH_AUTO_SEQS = [100, 255, 256, 2010]
# The Fig-3a experiments at the full width on the round-5 recipe (ROUND5.md:25-29:
# grid 8192, mixture sampler, 10 000 buckets, cap 128, 4 x 25 microbatches);
# cut in the schedule: 1 + 1 epochs and 2 straight on the grid sampler, 2 on
# the exact one; scoring on 2 chunks of 8 datasets (longrun: 8); gp_fitting's
# quick config cut to 2 epochs.
FIG3A_EXPERIMENTS = dict(T=2010, buckets=10_000, bucket_seq_cap=128, grid=8192, batch_size=4, agg=25, eval_batch=8,
                     chunks=2, chunk_batch=8, quick_epochs=2)
# The f32 bodies at the bf16 rows' shapes: T = 2010, D = 128, sep 1000, the
# forward at B*H 32 and the backward at B*H 16.
F32_LONG_SHAPE = dict(fwd_BH=32, bwd_BH=16, T=2010, D=128, sep=1000)
# The f32 path at the Fig-3a width: gp_fitting's full configuration
# (pfn_tpu_torch/experiments/gp_fitting.py:59-64: emsize 512, 4 heads of 128,
# nhid 1024, 6 layers, bptt 2010, batch 4, lr 1e-4, warmup 20 epochs, the
# weighted sampler capped at 2000, 1000 buckets, the exact GP prior with
# noise 1e-4, outputscale 1, lengthscale 0.6) at TrainConfig's default dtype,
# f32, in place of its bf16. Cut in the schedule only: 4 microbatches an
# update in place of 25, 2 epochs of 2 updates; served through PFNRegressor
# at context 1000 on 8 datasets.
F32_PATH = dict(T=2010, emsize=512, nhead=4, nhid=1024, nlayers=6, batch_size=4, agg=4, updates=2, buckets=1000,
                lr=1e-4, warmup_epochs=20, timed_updates=4, n_ctx=1000, datasets=8)
# One f32 update on the kernel path against the dense f32 path: loss,
# gradient norm and the gradient vector (L2), relative (f32 summation-order differences through 6 layers
# and back, as FUSED_TRAIN_F32_TOL).
F32_PATH_TOL = 1e-4
# The yardstick of that comparison's reach: the dense path again with every
# layer's value projection scaled by 1 + F32_PATH_PROBE, which scales the
# attention output by as much; the relative change it makes is reported.
F32_PATH_PROBE = 1e-3
# fused_train's bf16 budget (2x the unfused path's own bf16 difference of
# the gradient vector + 1e-3, 1.49e-2 on an H100 at the flagship) lies above
# what F32_PATH_PROBE moves (1.48e-3), so that budget has a probe of its own:
# an attention output off by 2 %, which moves the vector ~1.5x as much
# (~3e-2, about twice the budget). Should the budget grow past its reach,
# the check is blind, and the phase fails.
# The same probe backs the main path's bf16 checks. train's one update of
# the round-5 recipe (T 2010, 10 000 buckets): the gradient vector within 2x
# the dense path's own bf16 distance + 1e-3, 2.05e-2 on an H100, where the
# probe reached 3.77e-2. slice's positional logits at T 2010, each within
# 2x the dense bf16 model's distance from an f32 one + 1e-3: max-abs 4.74e-2
# (the probe 7.42e-2), relative L2 1.63e-2 (the probe 2.60e-2).
FUSED_BF16_PROBE = 2e-2
# The Bayesian comparison at the reference config
# (experiments/bayesian_models_custom_priors.py:97-107, the port's driver's
# REFERENCE): the BNN prior default_model_spec("small") (3 features, embed
# 5), emsize 256, nhid 512, 5 layers, 4 heads of 64, bptt 300, batch 256, lr
# 2.006434e-5, TrainConfig's default f32 (the flash f32 bodies at D 64, T
# 300), seeded weights through the weight bridge. Cut: 2 epochs of 2 updates
# (the driver runs 160 of 100). The eval set: 100 datasets of T 300, 100 in
# context; SVI 1024 steps and draws, HMC 512 warm-up and 512 draws of 15
# leapfrog steps: the driver's non-quick settings, batched over the 100
# datasets on the card.
COMPARISON = dict(size="small", updates=2, timed_updates=4, eval_sets=100, n_train=100, svi_steps=1024,
                  mcmc_steps=512)
# The flash f32 bodies at the comparison's training shape: B*H = 256 x 4, T
# 300, D 64, at sep T // 2.
COMPARISON_KERNEL_SHAPE = dict(fwd_BH=1024, bwd_BH=1024, T=300, D=64, sep=150)
# The tabular baselines on the card: bayes_net_metric (the one baseline
# without sklearn) over one synthetic dataset of 400 rows and 5 features,
# bptt 100, eval position 30, 4 windows.
TABULAR_BASELINES = dict(rows=400, features=5, bptt=100, eval_position=30, windows=4)
# The front door (python -m pfn_tpu_torch.train, called in process through
# pfn_tpu_torch.train.cli.main) at the Fig-3a width (emsize 512, 4 heads of
# 128, nhid 1024, 6 layers), fresh seeded init, TrainConfig's default f32:
# (a) the README's quick-start command (README.md:82-84: the GP prior at
# lengthscale 0.6, noise 1e-4, outputscale 1, the 100-bucket bar head) at
# bptt 1024, batch 8, 2 epochs of 2 updates, saved, then warm-started for 1
# epoch; (b) the model options (a normalized-uniform encoder, a learned
# positional table, SeqBN, dropout 0.1) on the ridge prior with the adaptive
# bar head at bptt 512, batch 8, 2 epochs of 2 updates, and again stopped
# after epoch 1 and resumed; (c) the stroke prior at 784 features with CE at
# bptt 512, batch 8, 2 updates.
FRONT_DOOR_WIDTH = ["--emsize", "512", "--nhead", "4", "--nhid", "1024", "--nlayers", "6"]
FRONT_DOOR = {
    "quickstart": ["gp", "--loss_function", "barnll", "--set", "prior.kwargs.lengthscale=0.6", "--set",
                   "prior.kwargs.noise=1e-4", "--set", "prior.kwargs.outputscale=1.0", "--bptt", "1024",
                   "--batch_size", "8", "--epochs", "2", "--steps_per_epoch", "2"],
    "options": ["ridge", "--loss_function", "adaptivebarnll", "--set", "encoder=normalized_uniform", "--set",
                "pos_encoder=learned", "--set", "train.input_normalization=true", "--set", "train.dropout=0.1",
                "--bptt", "512", "--batch_size", "8", "--epochs", "2", "--steps_per_epoch", "2"],
    "stroke": ["stroke", "--loss_function", "ce", "--set", "prior.kwargs.num_features=784", "--bptt", "512",
               "--batch_size", "8", "--epochs", "1", "--steps_per_epoch", "2"],
}
FRONT_DOOR_TIMED_UPDATES = 4
# The few-shot path (pfn_tpu_torch/experiments/fewshot_omniglot.py FULL, the
# notebook's config: emsize 1024, nhid 2048, 6 layers, 8 heads, bptt 26,
# batch 64, 28 x 28 images, 5-way 5-shot; the synthetic bank of 40 classes x
# 20 images, 30 for training). Cut: 2 epochs of 2 stroke-pretraining
# updates, 2 finetune updates; accuracy on 4 x 32 test episodes.
FEWSHOT = dict(epochs=2, updates=2, finetune_updates=2, timed_updates=4)
# Bayesian optimisation (pfn_tpu_torch/experiments/bayesopt_eval.py's full
# config: emsize 128, nhid 256, 4 layers, 4 heads, bptt 64, 256 buckets on
# (-4, 4), the GP prior at noise 1e-2, outputscale 1, lengthscale 0.3).
# Training cut to 2 epochs of 2 steps; the BO loop uncut: 32 functions x 25
# iterations x (EI, UCB) over 128 candidates, 3 initial points. Then one
# scoring request at 2048 candidates (T 2076: the flash forward, f32, head
# dim 32).
BAYESOPT = dict(epochs=2, steps=2, functions=32, wide_candidates=2048)
# The GP-mix oracles: GPMixPrior(num_features=1) with the JAX defaults, 16
# datasets at T 100; the MAP fit at every position 1-99 (150 Adam steps, lr
# 0.05; a 10-step run profiled); HMC with 64 draws after 128 of warm-up,
# context 50 and 50 queries.
GP_MIX_ORACLES = dict(datasets=16, T=100, map_steps=150, map_lr=0.05, profile_steps=10, context=50,
                      mcmc_samples=64, mcmc_warmup=128)
# The reference-API workflow of pfn_tpu_torch/compat.py's docstring (the
# GP-fitting notebook's hyperparameters), cut to 2 updates of 25 microbatches.
COMPAT = dict(emsize=512, nhead=4, nhid=1024, nlayers=6, bptt=2010, batch_size=4, agg=25, max_sep=2000, updates=2,
              buckets=1000, bucket_draws=100_000,
              hyperparameters={"noise": 1e-4, "outputscale": 1.0, "lengthscale": 0.6,
                               "fast_computations": (False, False, False)})
# The batch cache: 50 stroke-prior batches at the few-shot shape (64 x 26 x
# 784 f32), then 2 updates of the few-shot model fed from it.
NATIVE_CACHE = dict(batches=50, updates=2)
# The debug checks: a prior whose targets leave the support of 10 buckets on
# (-3, 3), one update at the Fig-3a width, f32, T 100, batch 8.
DEBUG_CHECKS = dict(buckets=10, T=100, batch_size=8)
# The parallel layer at the Fig-3a width (emsize 512, 4 heads of 128, nhid
# 1024, 6 layers), T 2010, 1000 buckets (gp_fitting's), seeded weights
# through the bridge, a global batch of 4 datasets from the parent (8 on the
# pipeline, whose 4 microbatches split each dp rank's rows), sep 1000, one
# update in f32 (and dp2 x sp2 also in bf16). Four ranks share the one card
# through a gloo group that carries CUDA tensors; their times are not a
# collective's speed. MESH_LAYOUTS: name -> (mesh axes, num_experts, dtype).
MESH = dict(T=2010, emsize=512, nhead=4, nhid=1024, nlayers=6, buckets=1000, batch_size=4, pp_batch=8, pp_micro=4,
            sep=1000, lr=1e-4, experts=4, world=4)
MESH_LAYOUTS = {
    "dp2_sp2": ({"dp": 2, "sp": 2}, 0, "f32"),
    "dp2_tp2": ({"dp": 2, "tp": 2}, 0, "f32"),
    "fsdp_dp4": ({"dp": 4}, 0, "f32"),
    "dp2_ep2": ({"dp": 2, "ep": 2}, 4, "f32"),
    "pp2_dp2": ({"dp": 2, "pp": 2}, 0, "f32"),
    "dp2_sp2_bf16": ({"dp": 2, "sp": 2}, 0, "bf16"),
}
# A mesh update against the one-rank update of the same weights and batch on
# the card: the whole clipped gradient vector and the parameter vector,
# relative L2 (f32 summation order through 6 layers, as F32_PATH_TOL); the
# probe (F32_PATH_PROBE on the one-rank update) must move the gradient
# vector past it.
MESH_TOL = 1e-4
# Seconds the mesh phase's ranks may take in all before they are killed.
MESH_TIMEOUT_S = 300
# MoE at the Fig-3a width on one card through train(...): 4 experts, bf16,
# T 2010, batch 4, the exact GP prior, 1000 buckets, 2 epochs of 2 updates.
MOE = dict(T=2010, emsize=512, nhead=4, nhid=1024, nlayers=6, buckets=1000, batch_size=4, experts=4, updates=2,
           lr=1e-4, timed_updates=4)
# The measurement drivers (pfn_tpu_torch/experiments: profile_step,
# batch_shape_sweep, anomaly_10x10, fused_ab, flagship_throughput) at the
# full width, cut only in repeats and epochs: one timed epoch-equivalent a
# sweep or step shape (the scripts time 2), 4 timed calls of 25 updates a
# flagship measurement (20). The attention and the prior alone keep the
# script's 3 timed 100-dataset repeats, the stock-torch baseline takes 10
# steps (3), and profile_step runs uncut at the Fig-3a microbatch and at
# the flagship (its defaults).
PROFILE_STEP_CONFIGS = {
    "fig3a_microbatch": ["--bptt", "2010", "--batch_size", "4", "--grid", "8192", "--num_buckets", "10000"],
    "flagship": [],
}
MEASURE = dict(bptt=2010, epochs_timed=1, reps_timed=3, ab_steps=4, baseline_steps=10)
# The bf16 flash kernels at two of the sweep's microbatches, 10x10's and
# 100x1's: B 10 and 100 datasets of 4 heads (B*H 40 and 400), T 2010, D 128,
# at sep 1000 and at the mixture sampler's mean sep 1595; the plain f32
# versions run ``chunk`` datasets at a time.
SWEEP_HOLD = dict(batches=[10, 100], seps=[1000, 1595], H=4, T=2010, D=128, chunk=25)
# Device kernels of the flash f32 bodies, as the profiler names them.
FLASH_F32_KERNELS = {"pfn_flash_fwd": "fwd_f32", "pfn_flash_bwd_dq": "dq_f32", "pfn_flash_bwd_dkv": "dkv_f32"}
TIMING_SEPS = [400, 1000, 2000]
# The flash kernels' agreement grid: (T, sep) over the edges of the 64-row
# tiles at T in {127, 128, 129, 2010}, of the 128-row query and 128-key tiles
# of the sm_90a bodies at T in {255, 256, 257}, and F32_EDGES.
# Edges of the f32 bodies (fwd_f32: 64-row query tiles below T 256, 128-row
# ones from there on, 64-key KV tiles; dkv_f32: 64-key units, 64-row query
# steps) that the rest of the grid does not straddle: T and sep one short
# of, at and one past 64, and T around three 128-row tiles with sep around
# four 64-key tiles; in the prefix variant also Tq across 256, where the
# forward's tile height changes, against F32_PREFIX_EDGE
# (tests/test_torch_port_flash_f32_edges.py holds the plain versions to the
# JAX package at these edges).
F32_EDGES = [(63, 62), (64, 63), (65, 64), (383, 255), (384, 256), (385, 257)]
F32_PREFIX_EDGE, F32_PREFIX_TQ = (385, 257), [255, 256, 257]
FLASH_CASES = ([(T, sep) for T in (127, 128, 129, 2010) for sep in sorted({0, 1, T // 2, T - 1})]
               + [(T, sep) for T in (255, 256, 257) for sep in sorted({0, 1, 127, 128, 129, T - 1})] + F32_EDGES)
# Edges of the bf16 dk/dv kernel that FLASH_CASES does not straddle, added to
# the backward's grid: sep one past the first 64-key half of its 128-key
# tile, and at the second tile's halves; in the prefix variant also Tq one
# short of, at and one past a 64-row query tile against Tk = 257.
DKV_EDGES = [(257, 65), (257, 192)]
DKV_PREFIX_TQ = [63, 64, 65]
# The backward's timing seps: the forward's, and the mean sep of the train
# phase's mixture sampler, where 208 heavy units of the dk/dv kernel (B*H 16)
# take two rounds of 132 SMs.
BWD_TIMING_SEPS = [400, 1000, 1595, 2000]
# The per-feature model's item attention (models/per_feature.item_attention)
# at the tabpfn2 cell's shapes: 6 datasets x 51 token columns, 6 heads of
# 32, T 1024, bf16. Two prefix calls a layer: the train rows, (columns x H,
# sep, 32) against (columns x H, T, 32), and the test rows folded into one
# head, (columns, H (T - sep), 32) against head 0's keys, Tq above Tk for
# every sep below 5/6 T. ITEM_CHUNK heads at a time for the dense versions.
ITEM_ATTENTION = dict(columns=6 * 51, H=6, T=1024, D=32)
ITEM_ATTENTION_SEPS = [0, 1, 512, 1023]
ITEM_CHUNK = 32
REPEATS = 5  # slice requests after the first call; their median is reported
# The bench.py flagship (bench.py:22-30): emsize 512, 4 heads, nhid 1024, 6
# layers, 100 buckets, B 64 datasets of T 100 from the grid-2048 GP prior.
FLAGSHIP = dict(B=64, T=100, emsize=512, nhead=4, nhid=1024, nlayers=6, buckets=100, grid=2048, sep=50)
FUSED_TIMING_SEPS = [10, 50, 90]
FUSED_F32_TOL = 3e-5  # atol and rtol, as tests/test_fused_layer.py uses
FUSED_BWD_F32_TOL = 3e-4  # atol and rtol of f32 gradients, as tests/test_fused_layer.py uses
# Edges of the fused backward's bf16 GEMM (pfn_gemm_sm90.cuh: 128-row output
# tiles, 128 or 64 columns, 64-deep K tiles) that fused_bwd_kernel's grid
# does not straddle, as (D, H, F, T, B): K = D or F at 80 and 128, N at 128
# and 144 (head dims 16 and 64), M = B*T at 2 * 128 +- 1, and T = 63 / 65
# against the attention products' 64-deep K tiles.
FUSED_BWD_EDGES = [(D, H, F, T, B) for D, H, F in ((80, 5, 144), (128, 2, 128))
                   for T, B in ((63, 1), (65, 2), (255, 1), (257, 1))]
# Edges of the fused forward's bf16 kernels that fused_kernel's grid does not
# straddle, as (D, H, F, T, B), each at sep in {0, T//2, T-1, T} (sep inside
# a diagonal key tile, and sep = T): K and N crossing 64 (D 64, F 96), head
# dim 16 (D 32, H 2) against the attention's 64-column panel, T 63/64/65
# against its 64-row query and key tiles, and M = B*T = 2 * 128 +- 1 against
# the GEMM's 128-row tiles.
FUSED_FWD_EDGES = [(D, H, F, T, B) for D, H, F in ((64, 2, 96), (32, 2, 48))
                   for T, B in ((63, 1), (64, 2), (65, 1), (85, 3), (257, 1))]
# Edges of the f32 GEMM (pfn_fused_common.cuh: 128 x 128 output tiles over
# 16-deep K tiles, column sums over 128-row tiles) that the grids above do
# not straddle, as (D, H, F, T, B), in f32 only, each at sep in {0, T//2,
# T-1, T}: M = B*T at 127, 128 and 129; N = D, F, 3D past 128-column tiles
# (D 144, F 272), short of them (D 112, F 240) and on them (D 128, F 128,
# head dim 128); T 15, 16 and 17 against the K step of the attention
# products (tests/test_torch_port_fused_f32_edges.py holds the plain
# versions to the JAX package at these shapes).
FUSED_F32_EDGES = [(144, 9, 272, 127, 1), (144, 9, 272, 64, 2), (112, 7, 240, 129, 1), (128, 1, 128, 17, 3),
                   (128, 1, 128, 16, 1), (112, 7, 240, 15, 2)]
# f32 fused path against the f32 unfused forward: 6 layers of f32
# summation-order differences (each within FUSED_F32_TOL), then the decoder.
FUSED_PATH_F32_TOL = 1e-3
# One f32 update fused against unfused: loss and grad norm, relative (f32
# summation-order differences through 6 layers and back).
FUSED_TRAIN_F32_TOL = 1e-4
# The card's peaks for the bound (H100 SXM data sheet, dense, at the 700 W
# limit): bf16 tensor cores, f32 outside them, and HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# Name fragments of the kernels whose registers must not spill, as ptxas
# names them once demangled: the Hopper bodies (bf16 flash, fused GEMM and
# attention), the flash kernels' f32 bodies, and the fused chains' f32 and
# shared kernels (the f32 GEMM, the f32 attention forward and recompute and
# its softmax backward, both LayerNorms, the bf16 cast, the ordered sums).
SPILL_CHECKED = ("_sm90<", "fwd_f32<", "dq_f32<", "dkv_f32<", "gemm_f32<", "attn_f32<", "attn_bwd_f32<",
                 "layernorm_kernel<", "layernorm_bwd_kernel<", "cast_bf16_kernel", "colsum_final_kernel",
                 "split_sum_kernel")
# Kernels (by name, as declared in pfn_tpu_torch/ops/csrc/) left out of the
# spill check, each with its reason. None: every kernel builds with 0 bytes
# of spill. phase_build refuses a kernel in neither, and so does
# tests/test_torch_port_hygiene.py, reading the sources.
SPILL_EXEMPT: dict[str, str] = {}
# The design of each kernel's bf16 body, beside its route in the kernels line.
SM90_DESIGN = "sm90-wgmma-tma"  # wgmma fed by TMA through an mbarrier ring (pfn_flash_sm90.cuh, pfn_gemm_sm90.cuh)
# The device kernels a bf16 call of the fused forward may launch (name
# fragments as the profiler shows them): anything else is a fallback.
FUSED_FWD_BF16_KERNELS = ("gemm_sm90", "attn_fwd_sm90", "layernorm_kernel", "cast_bf16_kernel")
# torch.profiler keeps only the device kernels whose timestamps, converted
# to the host's clock, fall inside its recording window: the window is padded
# on both sides so that a skew between the two clocks drops none of a short
# call's kernels. A session that saw no kernel is tried again.
PROFILE_PAD_S = 0.02
PROFILE_TRIES = 3
# Profiler sessions of this run that saw no device kernel.
profile_misses = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_kernels(fn, calls: int = 1, cpu: bool = False):
    """([name, ms, launches] of each device kernel, wall ms, busy ms) of
    ``calls`` calls of fn() in one recorded profiler step, busy ms being the
    union of the kernels' intervals (kernels that overlap on two streams
    count once), after a warm-up call and a
    profiler warm-up step (the tracer can miss the first kernels of a
    session). The step is padded by PROFILE_PAD_S on both sides, and a
    session that saw no kernel is tried again, up to PROFILE_TRIES in all.
    Annotated ranges such as the optimizer step's are left out, their
    kernels count; ``cpu`` records the host's operators as well."""
    global profile_misses
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
            prof.step()
        kernels, busy_ms = _kernel_table(prof)
        if kernels:
            break
        profile_misses += 1
    return kernels, wall_ms, busy_ms


def device_ms(fn, calls: int = 20):
    """Mean device time of one fn() call: the time the card spends in the
    kernels it launches (the union of their intervals), by torch.profiler
    over ``calls`` calls (profiled_kernels). Unlike cuda_ms it does not grow
    when the host enqueues slower than the card runs. "not measured" if the
    profiler saw no kernel."""
    kernels, _, busy = profiled_kernels(fn, calls)
    return busy / calls if kernels else "not measured"


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the products over the peak of their type (bf16 tensor cores
    unless ``peak_flops`` says otherwise)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def pfn_pairs(T: int, sep: int) -> int:
    """(query, key) pairs the PFN rule allows in one (b, h): every query sees
    the keys below sep, and a query at or past sep also itself."""
    s = min(max(sep, 0), T)
    return T * s + (T - s)


def flash_flops(kind: str, BH: int, T: int, D: int, sep: int, include_diag: bool = True) -> float:
    """Operations of a flash kernel on this run's sep: 2 FLOPs per allowed
    (query, key) pair and head-dim entry for each product (fwd: QK^T, PV; dq:
    QK^T, dO V^T, dS K; dk/dv: those two and dS^T Q, P^T dO). The pairs are
    the PFN rule's, or without the diagonal the prefix rule's (Tq = Tk)."""
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    pairs = pfn_pairs(T, sep) if include_diag else T * min(max(sep, 0), T)
    return 2 * products * D * BH * pairs


def flash_bound(kind: str, BH: int, T: int, D: int, sep: int, include_diag: bool = True, dtype: str = "bf16") -> dict:
    """Bound of a flash kernel: :func:`flash_flops` over the peak of
    ``dtype`` ("bf16": the tensor cores; "f32": the f32 FMA units, where the
    kernels' f32 bodies run), and the bytes of each input read once and each
    output written once."""
    tensor = BH * T * D * (2 if dtype == "bf16" else 4)
    rows = BH * T * 4
    nbytes = {"fwd": 4 * tensor + rows, "dq": 5 * tensor + 2 * rows, "dkv": 6 * tensor + 2 * rows}[kind]
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    return bound(flash_flops(kind, BH, T, D, sep, include_diag), nbytes, peak)


def rate(kind: str, BH: int, T: int, D: int, sep: int, ms: float, include_diag: bool = True) -> dict:
    """Achieved TFLOP/s of a kernel time and its share of the bound, in %."""
    flops = flash_flops(kind, BH, T, D, sep, include_diag)
    return {"tflops": flops / (ms * 1e-3) / 1e12,
            "pct_of_bound": 100.0 * flash_bound(kind, BH, T, D, sep, include_diag)["bound_ms"] / ms}


def fused_layer_bound(B: int, T: int, D: int, H: int, F: int, sep: int, dtype: str = "bf16") -> dict:
    """Bound of the fused layer forward in ``dtype`` ("bf16": the tensor
    cores; "f32": the FMA units): the four GEMMs and the attention's allowed
    pairs; x read and y, r, lse written in f32, the weights in the compute
    dtype, the biases and LayerNorm parameters in f32."""
    M, c = B * T, 2 if dtype == "bf16" else 4
    flops = 2 * M * D * 3 * D + 2 * M * D * D + 4 * M * D * F + 4 * (D // H) * B * H * pfn_pairs(T, sep)
    nbytes = 3 * M * D * 4 + M * H * 4 + c * (4 * D * D + 2 * D * F) + 4 * (9 * D + F)
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6, **bound(flops, nbytes, peak)}


def fused_layer_bwd_bound(kind: str, B: int, T: int, D: int, H: int, F: int, sep: int, dtype: str = "bf16") -> dict:
    """Bound of one of the fused layer's backward kernels in ``dtype`` (as
    :func:`fused_layer_bound`), counting the products of the TPU kernel's
    body with its recompute. ffn: h1, f and their three gradients' products,
    six of 2 M D F; reads r and dy, writes dr (f32), the FFN weights in the
    compute dtype and their gradients in f32. attn: qkv, ao, dWout, dO,
    dWqkv, dx, 24 M D^2 in all, and six products (s, o, dp, dq, dk, dv) over
    the allowed pairs; reads x, dr, lse, writes dx, the attention weights in
    the compute dtype and their gradients in f32."""
    M, c = B * T, 2 if dtype == "bf16" else 4
    if kind == "ffn":
        flops = 12 * M * D * F
        nbytes = 3 * M * D * 4 + 2 * D * F * c + 2 * D * F * 4 + 4 * (2 * F + 5 * D)
    else:
        flops = 24 * M * D * D + 12 * (D // H) * B * H * pfn_pairs(T, sep)
        nbytes = 3 * M * D * 4 + M * H * 4 + 4 * D * D * c + 4 * D * D * 4 + 4 * (11 * D)
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6, **bound(flops, nbytes, peak)}


def device_profile(fn, top: int = 8) -> dict:
    """One call of fn() under torch.profiler (profiled_kernels): the wall
    time from a synchronize to a synchronize, the device time of its kernels
    (the union of their intervals: the fused f32 backward overlaps its
    weight gradients with other products on a second stream), the idle
    share of the card in between, and the kernels that took most of it:
    [name, ms, launches], each kernel's time its own."""
    kernels, wall_ms, device_ms = profiled_kernels(fn, cpu=True)
    kernels.sort(key=lambda k: -k[1])
    return {"wall_ms": wall_ms, "device_ms": device_ms if kernels else "not measured",
            "idle_share": 1.0 - device_ms / wall_ms if kernels else "not measured", "kernels": kernels[:top]}


def timed_request(fn):
    """(ms by CUDA events, wall ms, result) of one request."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, out


def timed_updates(prior, criterion, cfg, model, device, n: int):
    """A new optimizer state for ``model`` under ``cfg`` and 1 + n updates,
    each timed on the host clock up to a sync: (step, state, the times in
    ms, the median of all but the first)."""
    import numpy as np
    import torch

    from pfn_tpu_torch.train import TrainState
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step

    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1))
    step = make_train_step(prior, criterion, cfg, schedule)
    update_ms = []
    for _ in range(1 + n):
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        float(step(state)["loss"])
        torch.cuda.synchronize(device)
        update_ms.append((time.perf_counter() - t1) * 1e3)
    return step, state, update_ms, float(np.median(update_ms[1:]))


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Count the calls of ``module.<name>`` while the block runs (the
    module's own functions look it up at call time). Yields a one-element
    list that holds the count."""
    real = getattr(module, name)
    count = [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield count
    finally:
        setattr(module, name, real)


def phase_card():
    import torch

    from pfn_tpu_torch.device import require_cuda
    from pfn_tpu_torch.experiments.common import card

    device = require_cuda()
    smi = card(device)
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True; the port's f32 numerics need it off")
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "card", "name": torch.cuda.get_device_name(device), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    return device, smi


def ptxas_report(log: str) -> list:
    """ptxas's -v lines per kernel: [{"kernel", "registers", "spills"}],
    names demangled by c++filt where the machine has it."""
    import re
    import shutil

    kernels, current = [], None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            current = {"kernel": m.group(1)}
            kernels.append(current)
        elif current is not None and "spill" in line:
            current["spills"] = line.strip()
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and kernels:
        names = subprocess.run([cxxfilt], input="\n".join(k["kernel"] for k in kernels), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
        for k, name in zip(kernels, names):
            k["kernel"] = name.replace("(anonymous namespace)::", "")
    return kernels


def _spill_checked(kernel: str) -> bool:
    """Whether phase_build refuses a spill in ``kernel`` (a demangled name):
    it holds a fragment of SPILL_CHECKED."""
    return any(tag in kernel for tag in SPILL_CHECKED)


def _kernel_name(kernel: str) -> str:
    """The declared name of a demangled kernel: no return type, template
    arguments or parameters."""
    return kernel.split("(")[0].removeprefix("void ").split("<")[0]


def phase_build():
    import re

    from pfn_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    libraries = _ext.build()
    seconds = time.perf_counter() - t0
    report = {name: {"seconds": info["seconds"], "built": info["built"],
                     "library": str(Path(info["path"]).relative_to(ROOT)), "ptxas": ptxas_report(info["log"]),
                     "warnings": [line.strip() for line in info["log"].splitlines() if "warning" in line.lower()]}
              for name, info in libraries.items()}
    # Every kernel keeps its tiles and sums in registers: a spill is a
    # regression, and a kernel outside the check must be exempt by name. (Only
    # a fresh build carries ptxas's report.)
    checked = {name: sorted({k["kernel"].split("(")[0].removeprefix("void ") for k in lib["ptxas"]
                             if _spill_checked(k["kernel"])}) for name, lib in report.items()}
    unlisted = sorted({k["kernel"] for lib in report.values() for k in lib["ptxas"]
                       if not _spill_checked(k["kernel"]) and _kernel_name(k["kernel"]) not in SPILL_EXEMPT})
    # No fallback in the fused forward: every kernel of its library that
    # takes bf16 is one of the Hopper chain's.
    fwd_bf16 = sorted({k["kernel"] for k in report["pfn_fused_layer_fwd"]["ptxas"]
                       if "bfloat16" in k["kernel"] or "_sm90" in k["kernel"]})
    emit({"phase": "build", "seconds": seconds, "libraries": report, "spill_checked": checked,
          "spill_exempt": SPILL_EXEMPT, "fused_fwd_bf16_kernels": fwd_bf16})
    if unlisted:
        raise AssertionError(f"kernels neither spill-checked nor exempt: {unlisted}")
    for k in (k for lib in report.values() for k in lib["ptxas"] if _spill_checked(k["kernel"])):
        spilled = [int(n) for n in re.findall(r"(\d+) bytes spill", k.get("spills", ""))]
        if any(spilled):
            raise AssertionError(f"{k['kernel']} spills: {k['spills']}")
    other = [k for k in fwd_bf16 if not any(name in k for name in FUSED_FWD_BF16_KERNELS)]
    if other:
        raise AssertionError(f"the fused forward's library holds bf16 kernels outside its Hopper chain: {other}")


def phase_kernel_cases(device):
    """Kernel against its plain version on the grid of flash_equivalence."""
    import torch

    from pfn_tpu_torch.ops.attention import (
        pfn_attention,
        pfn_attention_reference,
        pfn_prefix_attention_reference,
    )
    from pfn_tpu_torch.ops.flash_attention import _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(0)
    B, H = 2, 2
    worst = {}
    n = 0
    for include_diag in (True, False):
        variant = "diag" if include_diag else "prefix"
        for T, sep in FLASH_CASES:
            tqs = [T] if include_diag else [T, T // 2 + 1] + (F32_PREFIX_TQ if (T, sep) == F32_PREFIX_EDGE else [])
            for Tq in tqs:
                for D in (32, 64, 128):
                    for dtype in (torch.float32, torch.bfloat16):
                        q = torch.randn(B, H, Tq, D, generator=g, device=device).to(dtype)
                        k = torch.randn(B, H, T, D, generator=g, device=device).to(dtype)
                        v = torch.randn(B, H, T, D, generator=g, device=device).to(dtype)
                        qs = (q * D**-0.5).reshape(B * H, Tq, D)
                        kf, vf = k.reshape(B * H, T, D), v.reshape(B * H, T, D)
                        o, lse = _flash_fwd(qs, kf, vf, sep, include_diag)
                        torch.cuda.synchronize()
                        o_plain, lse_plain = _flash_fwd_plain(qs.float(), kf.float(), vf.float(), sep, T,
                                                              include_diag)
                        case = dict(variant=variant, T=T, Tq=Tq, sep=sep, D=D, dtype=str(dtype))
                        tol = F32_TOL if dtype == torch.float32 else BF16_LSE_TOL
                        if not torch.allclose(lse, lse_plain, atol=tol, rtol=tol):
                            raise AssertionError(f"lse mismatch {case}: {max_abs(lse, lse_plain)}")
                        if sep == 0 and not include_diag:
                            if not (bool((lse <= -1e29).all()) and bool((o == 0).all())):
                                raise AssertionError(f"empty prefix must give o=0, lse<=-1e29: {case}")
                        if dtype == torch.float32:
                            if not torch.allclose(o, o_plain, atol=F32_TOL, rtol=F32_TOL):
                                raise AssertionError(f"o mismatch {case}: {max_abs(o, o_plain)}")
                            err, budget = max_abs(o, o_plain), None
                        else:
                            # bf16: the kernel's error and the dense bf16 path's, each
                            # against the f32 result for the same bf16 inputs.
                            if include_diag:
                                gold = pfn_attention_reference(q.float(), k.float(), v.float(), sep)
                                dense = pfn_attention_reference(q, k, v, sep)
                            else:
                                gold = pfn_prefix_attention_reference(q.float(), k.float(), v.float(), sep)[0]
                                dense = pfn_prefix_attention_reference(q, k, v, sep)[0]
                            err = max_abs(o.reshape(B, H, Tq, D), gold)
                            budget = 2 * max_abs(dense, gold) + 1e-3
                            if err > budget:
                                raise AssertionError(f"bf16 error {err} over budget {budget}: {case}")
                        torch.cuda.synchronize()
                        key = f"{variant}/{case['dtype']}"
                        w = worst.setdefault(key, {"cases": 0, "max_err": 0.0, "max_lse_err": 0.0})
                        w["cases"] += 1
                        w["max_err"] = max(w["max_err"], err)
                        w["max_lse_err"] = max(w["max_lse_err"], max_abs(lse, lse_plain))
                        n += 1
    # The prefix + exact-merge dispatch on the card, against the dense path.
    q, k, v = (torch.randn(2, 4, 2010, 128, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    gold = pfn_attention_reference(q.float(), k.float(), v.float(), 1000)
    merge_err = max_abs(pfn_attention(q, k, v, 1000, impl="prefix"), gold)
    merge_budget = 2 * max_abs(pfn_attention(q, k, v, 1000, impl="dense"), gold) + 1e-3
    if merge_err > merge_budget:
        raise AssertionError(f"impl='prefix' bf16 error {merge_err} over budget {merge_budget}")
    torch.cuda.synchronize()
    emit({"phase": "kernel", "cases": n, "worst": worst, "tol_f32": F32_TOL, "tol_bf16_lse": BF16_LSE_TOL,
          "bf16_rule": "err <= 2 * dense_bf16_err + 1e-3", "prefix_merge_err": merge_err,
          "prefix_merge_budget": merge_budget})


def phase_kernel_timing(device, smi: str):
    """Kernel and plain-version times at the main-path shape (B*H = 32, T =
    2010, D = 128, bf16), the kernel held to the bf16 budget at every sep of
    TIMING_SEPS; then the prefix variant (include_diag=False) at sep 1000."""
    import torch

    from pfn_tpu_torch.ops.attention import pfn_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(1)
    B, H, T, D = 8, 4, 2010, 128
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    qs = (q * D**-0.5).reshape(B * H, T, D)
    kf, vf = k.reshape(B * H, T, D), v.reshape(B * H, T, D)
    rows = []
    for sep in TIMING_SEPS:
        sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
        o, _ = _flash_fwd(qs, kf, vf, sep_t, True)
        o_plain, _ = _flash_fwd_plain(qs.float(), kf.float(), vf.float(), sep, T, True)
        gold = pfn_attention_reference(q.float(), k.float(), v.float(), sep)
        budget = 2 * max_abs(pfn_attention_reference(q, k, v, sep), gold) + 1e-3
        bf16_err = max_abs(o.reshape(B, H, T, D), gold)
        if bf16_err > budget:
            raise AssertionError(f"kernel_timing: bf16 error {bf16_err} over budget {budget} at sep {sep}")
        ms = cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, True))
        rows.append({
            "sep": sep,
            "kernel_ms": ms,
            "plain_ms": cuda_ms(lambda: _flash_fwd_plain(qs, kf, vf, sep_t, T, True)),
            "dense_bf16_ms": cuda_ms(lambda: pfn_attention_reference(q, k, v, sep_t)),
            "kernel_ms_again": cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, True)),
            "max_abs_err": max_abs(o, o_plain), "bf16_err": bf16_err, "bf16_budget": budget,
            "gflop": flash_flops("fwd", B * H, T, D, sep) / 1e9, **flash_bound("fwd", B * H, T, D, sep),
            **rate("fwd", B * H, T, D, sep, ms),
        })
    # The prefix variant (include_diag=False, Tq = Tk): keys below sep only.
    sep = 1000
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
    o, _ = _flash_fwd(qs, kf, vf, sep_t, False)
    o_plain, _ = _flash_fwd_plain(qs.float(), kf.float(), vf.float(), sep, T, False)
    ms = cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, False))
    prefix = {"sep": sep, "kernel_ms": ms, "plain_ms": cuda_ms(lambda: _flash_fwd_plain(qs, kf, vf, sep_t, T, False)),
              "max_abs_err": max_abs(o, o_plain), **flash_bound("fwd", B * H, T, D, sep, False),
              **rate("fwd", B * H, T, D, sep, ms, False)}
    emit({"phase": "kernel_timing", "shape": {"BH": B * H, "T": T, "D": D, "dtype": "bf16"},
          "card": smi, "rows": rows, "prefix": prefix,
          "bf16_rule": "err <= 2 * dense_bf16_err + 1e-3 against the f32 dense path on the bf16 inputs"})
    return rows, prefix


def _rel_errors(got: dict, gold: dict, dense: dict | None = None) -> dict:
    """bf16 rule of experiments/flash_equivalence.py: each gradient's max
    error over the gold gradient's max |.|, beside the dense bf16 path's. A
    gradient that vanishes in exact arithmetic (dq and dk of a diagonal-only
    row set) is normalised by 1e-3 of the largest gold gradient instead."""
    floor = 1e-3 * max(float(g.abs().max()) for g in gold.values())
    out = {}
    for name, g in gold.items():
        den = max(float(g.abs().max()), floor)
        out[name] = max_abs(got[name], g) / den if den > 0 else max_abs(got[name], g)
        if dense is not None:
            out[f"{name}_dense"] = max_abs(dense[name], g) / den if den > 0 else max_abs(dense[name], g)
    return out


def _grad_errors(got, gold, dense=None) -> dict:
    """:func:`_rel_errors` of the (dq, dk, dv) triples."""
    names = ("dq", "dk", "dv")
    return _rel_errors(dict(zip(names, got)), dict(zip(names, gold)), dense and dict(zip(names, dense)))


def _bf16_ok(errs: dict, names=("dq", "dk", "dv")) -> bool:
    return all(errs[n] <= max(BF16_GRAD_FLOOR, 3 * errs[f"{n}_dense"]) for n in names)


def phase_kernel_bwd_cases(device):
    """The dq and dk/dv kernels against their plain version over the forward's
    grid and DKV_EDGES; bf16 also against the dense bf16 path's own error."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.attention import pfn_attention, pfn_attention_reference, pfn_prefix_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd, _flash_bwd_plain, _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(2)
    B, H = 2, 2
    worst, n = {}, 0
    for include_diag in (True, False):
        variant = "diag" if include_diag else "prefix"
        for T, sep in FLASH_CASES + DKV_EDGES:
            tqs = [T] if include_diag else [T, T // 2 + 1] + (DKV_PREFIX_TQ if (T, sep) in DKV_EDGES else []) + (
                F32_PREFIX_TQ if (T, sep) == F32_PREFIX_EDGE else [])
            for Tq in tqs:
                for D in (32, 64, 128):
                    for dtype in (torch.float32, torch.bfloat16):
                        def rand(*shape):
                            return torch.randn(*shape, generator=g, device=device)

                        qs = (rand(B * H, Tq, D) * D**-0.5).to(dtype)
                        k, v = rand(B * H, T, D).to(dtype), rand(B * H, T, D).to(dtype)
                        do = rand(B * H, Tq, D).to(dtype)
                        dlse = None if include_diag else rand(B * H, Tq)
                        o, lse = _flash_fwd(qs, k, v, sep, include_diag)
                        got = _flash_bwd(qs, k, v, o, lse, do, dlse, sep, include_diag)
                        again = _flash_bwd(qs, k, v, o, lse, do, dlse, sep, include_diag)
                        torch.cuda.synchronize()
                        f32 = [t.float() for t in (qs, k, v)]
                        o32, lse32 = _flash_fwd_plain(*f32, sep, T, include_diag)
                        gold = _flash_bwd_plain(*f32, o32, lse32, do.float(), dlse, sep, T, include_diag)
                        case = dict(variant=variant, T=T, Tq=Tq, sep=sep, D=D, dtype=str(dtype))
                        if not all(bool(torch.isfinite(t).all()) for t in got):
                            raise AssertionError(f"non-finite gradient {case}")
                        if not all(torch.equal(a, b) for a, b in zip(got, again)):
                            raise AssertionError(f"a repeat backward differs {case}")
                        if all(float(t.abs().max()) == 0.0 for t in gold):
                            if any(float(t.abs().max()) != 0.0 for t in got):
                                raise AssertionError(f"gradients must be exactly zero: {case}")
                        if dtype == torch.float32:
                            for name, a, b in zip("qkv", got, gold):
                                if not torch.allclose(a, b, atol=F32_GRAD_TOL, rtol=F32_GRAD_TOL):
                                    raise AssertionError(f"d{name} mismatch {case}: {max_abs(a, b)}")
                            errs = {f"d{name}": max_abs(a, b) for name, a, b in zip("qkv", got, gold)}
                        else:
                            # The dense bf16 path's gradient on the same inputs (scale
                            # already in qs), by autograd.
                            leaves = [t.reshape(B, H, -1, D).detach().requires_grad_() for t in (qs, k, v)]
                            if include_diag:
                                out = pfn_attention_reference(*leaves, sep, scale=1.0)
                                loss = (out.float() * do.reshape(B, H, Tq, D).float()).sum()
                            else:
                                out, lse_d = pfn_prefix_attention_reference(*leaves, sep, scale=1.0)
                                loss = ((out.float() * do.reshape(B, H, Tq, D).float()).sum()
                                        + (lse_d * dlse.reshape(B, H, Tq)).sum())
                            dense = [t.reshape(B * H, -1, D) for t in torch.autograd.grad(loss, leaves)]
                            errs = _grad_errors(got, gold, dense)
                            if not _bf16_ok(errs):
                                raise AssertionError(f"bf16 gradient error over budget {case}: {errs}")
                        key = f"{variant}/{case['dtype']}"
                        w = worst.setdefault(key, {"cases": 0})
                        w["cases"] += 1
                        for name, e in errs.items():
                            w[name] = max(w.get(name, 0.0), e)
                        n += 1
    # Autograd through the dispatch on the card, against the dense path.
    B, H, T, D, sep = 2, 4, 2010, 128, 1000
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    w_out = torch.randn(B, H, T, D, generator=g, device=device)

    def grads(impl, dtype):
        leaves = [t.to(dtype).detach().requires_grad_() for t in (q, k, v)]
        loss = (pfn_attention(*leaves, sep, impl=impl).float() * w_out).sum()
        return torch.autograd.grad(loss, leaves)

    gold, dense = grads("dense", torch.float32), grads("dense", torch.bfloat16)
    dispatch = {}
    for impl in ("flash", "prefix"):
        before = dict(_ext.launch_counts)
        errs = _grad_errors(grads(impl, torch.bfloat16), gold, dense)
        launched = {name: _ext.launch_counts[name] - before[name]
                    for name in ("pfn_flash_fwd", "pfn_flash_bwd_dq", "pfn_flash_bwd_dkv")}
        if not _bf16_ok(errs):
            raise AssertionError(f"impl={impl!r} bf16 gradient error over budget: {errs}")
        if min(launched.values()) < 1:
            raise AssertionError(f"impl={impl!r} did not launch every kernel: {launched}")
        dispatch[impl] = errs
    torch.cuda.synchronize()
    emit({"phase": "kernel_bwd", "cases": n, "worst": worst, "tol_f32": F32_GRAD_TOL,
          "bf16_rule": f"err/max|gold| <= max({BF16_GRAD_FLOOR}, 3 * dense_bf16_err/max|gold|) per gradient",
          "repeat_bitwise_equal": True, "dispatch_autograd": dispatch})
    return worst


def _item_dense(qs, k, v, do, sep: int) -> tuple:
    """(o, lse, dq, dk, dv) of one prefix call by the dense versions, ITEM_CHUNK
    heads at a time: the plain float32 functions on float32 copies of the
    inputs (the gold), and the port's dense prefix path on the bf16 inputs
    (scale already in qs) with autograd."""
    import torch

    from pfn_tpu_torch.ops.attention import pfn_prefix_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd_plain

    gold, dense = [], []
    for a in range(0, qs.shape[0], ITEM_CHUNK):
        part = [t[a:a + ITEM_CHUNK] for t in (qs, k, v, do)]
        f32 = [t.float() for t in part[:3]]
        o32, lse32 = _flash_fwd_plain(*f32, sep, k.shape[1], False)
        gold.append((o32, lse32, *_flash_bwd_plain(*f32, o32, lse32, part[3].float(), None, sep, k.shape[1], False)))
        leaves = [t[:, None].detach().requires_grad_() for t in part[:3]]
        o, lse = pfn_prefix_attention_reference(*leaves, sep, scale=1.0)
        grads = torch.autograd.grad((o.float() * part[3][:, None].float()).sum(), leaves)
        dense.append((o[:, 0].detach(), lse[:, 0].detach(), *(t[:, 0] for t in grads)))
    return tuple(torch.cat(ts) for ts in zip(*gold)), tuple(torch.cat(ts) for ts in zip(*dense))


def phase_item_attention(device):
    """Both flash calls of the per-feature model's item attention at the
    tabpfn2 cell's shapes (ITEM_ATTENTION), bf16 at head dim 32, forward and
    backward, at each sep of ITEM_ATTENTION_SEPS, against the plain float32
    prefix path and the dense bf16 one: the forward by the kernel phase's
    rule (o within 2x the dense path's error + 1e-3, lse within
    BF16_LSE_TOL), dq and dk/dv by the kernel_bwd phase's; a repeat backward
    bitwise equal; at sep 0 o and every gradient exactly zero."""
    import torch

    from pfn_tpu_torch.ops.flash_attention import _flash_bwd, _flash_fwd

    N, H, T, D = (ITEM_ATTENTION[k] for k in ("columns", "H", "T", "D"))
    g = torch.Generator(device=device).manual_seed(28)
    worst, n = {}, 0
    for sep in ITEM_ATTENTION_SEPS:
        for call, BH, Tq in (("train_rows", N * H, sep), ("test_rows", N, H * (T - sep))):
            if Tq == 0:
                continue
            case = dict(call=call, BH=BH, Tq=Tq, Tk=T, sep=sep, D=D)
            qs = (torch.randn(BH, Tq, D, generator=g, device=device) * D**-0.5).to(torch.bfloat16)
            k, v, do = (torch.randn(BH, L, D, generator=g, device=device).to(torch.bfloat16) for L in (T, T, Tq))
            o, lse = _flash_fwd(qs, k, v, sep, False)
            got = _flash_bwd(qs, k, v, o, lse, do, None, sep, False)
            again = _flash_bwd(qs, k, v, o, lse, do, None, sep, False)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"a repeat backward differs {case}")
            if not all(bool(torch.isfinite(t).all()) for t in (o, *got)):
                raise AssertionError(f"non-finite output or gradient {case}")
            (o32, lse32, *gold), (o_d, _, *dense) = _item_dense(qs, k, v, do, sep)
            lse_err = max_abs(lse, lse32)
            if not torch.allclose(lse, lse32, atol=BF16_LSE_TOL, rtol=BF16_LSE_TOL):
                raise AssertionError(f"lse mismatch {case}: {lse_err}")
            err, budget = max_abs(o, o32), 2 * max_abs(o_d, o32) + 1e-3
            if err > budget:
                raise AssertionError(f"bf16 error {err} over budget {budget}: {case}")
            if sep == 0:
                if o.any() or any(t.any() for t in got) or bool((lse > -1e29).any()):
                    raise AssertionError(f"an empty prefix must give o = 0, zero gradients, lse <= -1e29: {case}")
                errs = {}
            else:
                errs = _grad_errors(got, gold, dense)
                if not _bf16_ok(errs):
                    raise AssertionError(f"bf16 gradient error over budget {case}: {errs}")
            w = worst.setdefault(call, {"cases": 0, "o": 0.0, "o_budget": 0.0, "lse": 0.0})
            w["cases"] += 1
            w["o"], w["o_budget"], w["lse"] = max(w["o"], err), max(w["o_budget"], budget), max(w["lse"], lse_err)
            for name, e in errs.items():
                w[name] = max(w.get(name, 0.0), e)
            n += 1
            del qs, k, v, do, o, lse, got, again, gold, dense
            torch.cuda.empty_cache()
    emit({"phase": "item_attention", "cases": n, "shape": ITEM_ATTENTION, "seps": ITEM_ATTENTION_SEPS, "worst": worst,
          "bf16_rule": "o: err <= 2 * dense_bf16_err + 1e-3; dq, dk, dv: err/max|gold| <= "
                       f"max({BF16_GRAD_FLOOR}, 3 * dense_bf16_err/max|gold|)"})
    return worst


def _repeat_bitwise(qs, k, v, do, lse, delta, sep_t, include_diag: bool, where: str):
    """(dq, dk, dv) from the two backward kernels, bf16 or f32, each called
    twice: a repeat call must give the same bits (no atomics; resume stays
    bitwise). ``where`` names the phase and case in the error."""
    import torch

    from pfn_tpu_torch.ops import _ext

    dq = _ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag)
    if not torch.equal(dq, _ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag)):
        raise AssertionError(f"{where}: a repeat dq call differs")
    dk, dv = _ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag)
    dk2, dv2 = _ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{where}: a repeat dk/dv call differs")
    return dq, dk, dv


def phase_kernel_bwd_timing(device, smi: str):
    """Backward kernels, plain backward and dense bf16 backward at the
    training microbatch (B 4 x H 4, T = 2010, D = 128, bf16); at every sep of
    BWD_TIMING_SEPS the three gradients held to the bf16 rule and repeat dq
    and dk/dv calls bitwise equal; then the prefix variant (include_diag=False,
    a nonzero dlse) at sep 1000, its repeat calls bitwise equal too."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.attention import pfn_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(3)
    B, H, T, D = 4, 4, 2010, 128
    q, k, v, do4 = (torch.randn(B, H, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(4))
    qs = (q * D**-0.5).reshape(B * H, T, D)
    kf, vf, do = k.reshape(B * H, T, D), v.reshape(B * H, T, D), do4.reshape(B * H, T, D)
    f32 = [t.float() for t in (qs, kf, vf)]
    rows = []
    for sep in BWD_TIMING_SEPS:
        sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
        o, lse = _flash_fwd(qs, kf, vf, sep_t, True)
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = _repeat_bitwise(qs, kf, vf, do, lse, delta, sep_t, True, f"kernel_bwd_timing, sep {sep}")
        plain = _flash_bwd_plain(qs, kf, vf, o, lse, do, None, sep_t, T, True)
        o32, lse32 = _flash_fwd_plain(*f32, sep, T, True)
        gold = _flash_bwd_plain(*f32, o32, lse32, do.float(), None, sep, T, True)
        scaled = [t.reshape(B, H, T, D).detach().requires_grad_() for t in (qs, kf, vf)]
        loss = (pfn_attention_reference(*scaled, sep, scale=1.0).float() * do4.float()).sum()
        errs = _grad_errors((dq, dk, dv), gold, [t.reshape(B * H, T, D) for t in torch.autograd.grad(loss, scaled)])
        if not _bf16_ok(errs):
            raise AssertionError(f"kernel_bwd_timing: bf16 gradient error over budget at sep {sep}: {errs}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        dense_out = pfn_attention_reference(*leaves, sep_t)
        dq_ms = cuda_ms(lambda: _ext.flash_bwd_dq(qs, kf, vf, do, lse, delta, sep_t, True))
        dkv_ms = cuda_ms(lambda: _ext.flash_bwd_dkv(qs, kf, vf, do, lse, delta, sep_t, True))
        rows.append({
            "sep": sep,
            "dq_ms": dq_ms,
            "dkv_ms": dkv_ms,
            "plain_ms": cuda_ms(lambda: _flash_bwd_plain(qs, kf, vf, o, lse, do, None, sep_t, T, True)),
            "dense_bf16_bwd_ms": cuda_ms(
                lambda: torch.autograd.grad(dense_out, leaves, do4, retain_graph=True)),
            "dq_ms_again": cuda_ms(lambda: _ext.flash_bwd_dq(qs, kf, vf, do, lse, delta, sep_t, True)),
            "dkv_ms_again": cuda_ms(lambda: _ext.flash_bwd_dkv(qs, kf, vf, do, lse, delta, sep_t, True)),
            "max_abs_err": {f"d{n}": max_abs(a, b) for n, a, b in zip("qkv", (dq, dk, dv), plain)},
            "bf16_rel_err": errs, "repeat_bitwise_equal": True,
            "dq": {**flash_bound("dq", B * H, T, D, sep), **rate("dq", B * H, T, D, sep, dq_ms)},
            "dkv": {**flash_bound("dkv", B * H, T, D, sep), **rate("dkv", B * H, T, D, sep, dkv_ms)},
        })
    # The prefix variant (include_diag=False, Tq = Tk) with a nonzero dlse.
    sep = 1000
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
    dlse = torch.randn(B * H, T, generator=g, device=device)
    o, lse = _flash_fwd(qs, kf, vf, sep_t, False)
    delta = (do.float() * o.float()).sum(-1) - dlse
    dq, dk, dv = _repeat_bitwise(qs, kf, vf, do, lse, delta, sep_t, False, "kernel_bwd_timing, the prefix variant")
    plain = _flash_bwd_plain(qs, kf, vf, o, lse, do, dlse, sep_t, T, False)
    dq_ms = cuda_ms(lambda: _ext.flash_bwd_dq(qs, kf, vf, do, lse, delta, sep_t, False))
    dkv_ms = cuda_ms(lambda: _ext.flash_bwd_dkv(qs, kf, vf, do, lse, delta, sep_t, False))
    prefix = {
        "sep": sep, "dq_ms": dq_ms, "dkv_ms": dkv_ms, "repeat_bitwise_equal": True,
        "plain_ms": cuda_ms(lambda: _flash_bwd_plain(qs, kf, vf, o, lse, do, dlse, sep_t, T, False)),
        "max_abs_err": {f"d{n}": max_abs(a, b) for n, a, b in zip("qkv", (dq, dk, dv), plain)},
        "dq": {**flash_bound("dq", B * H, T, D, sep, False), **rate("dq", B * H, T, D, sep, dq_ms, False)},
        "dkv": {**flash_bound("dkv", B * H, T, D, sep, False), **rate("dkv", B * H, T, D, sep, dkv_ms, False)},
    }
    emit({"phase": "kernel_bwd_timing", "shape": {"BH": B * H, "T": T, "D": D, "dtype": "bf16"},
          "card": smi, "rows": rows, "prefix": prefix})
    return rows, prefix


def phase_slice(device, smi: str, size: dict = FIG3A):
    import numpy as np
    import torch

    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.evals import eval_positional_logits_per_dataset, gp_exact_posterior_moments
    from pfn_tpu_torch.inference import PFNRegressor
    from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
    from pfn_tpu_torch.train import full_support_bar_criterion, seeded_flax_params, state_dict_from_flax_params

    T, n_ctx, positions = size["T"], size["n_ctx"], size["positions"]
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6, grid=size["grid"])
    ys = sample_y_for_buckets(prior, 100_000, T, seed=7, device=device)
    criterion = full_support_bar_criterion(get_bucket_limits(size["buckets"], ys=ys)).to(device)
    cfg = TransformerConfig(num_features=1, n_out=size["buckets"], emsize=size["emsize"], nhead=size["nhead"],
                            nhid=size["nhid"], nlayers=size["nlayers"], dtype=torch.bfloat16)
    state_dict = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, cfg.n_out, seed=0), cfg.nlayers)
    for name in ("self_attn.out_proj.weight", "linear2.weight"):
        if not bool(state_dict[f"transformer_encoder.layers.0.{name}"].abs().sum() > 0):
            raise AssertionError(f"{name} is zero: attention would not reach the output")

    model = PFNTransformer(cfg).to(device).eval()
    model.load_state_dict(state_dict, strict=True)
    g = torch.Generator(device=device).manual_seed(991)
    x, y, _ = prior.sample(size["datasets"], T, generator=g, device=device)
    x_np, y_np = x[0].cpu().numpy(), y[0].cpu().numpy()
    regressor = PFNRegressor(model, criterion).fit(x_np[:n_ctx], y_np[:n_ctx])
    hp = prior.hyperparameters()
    requests = {
        "positional_logits": lambda: eval_positional_logits_per_dataset(model, x, y, positions),
        "predict_return_std": lambda: regressor.predict(x_np[n_ctx:], return_std=True),
        "predict_quantiles": lambda: regressor.predict_quantiles(x_np[n_ctx:], (0.05, 0.5, 0.95)),
        "oracle_f64": lambda: gp_exact_posterior_moments(x, y, hp, positions=positions, dtype=torch.float64),
        "gaussian_kl_f64": lambda: criterion.bar.gaussian_kl(out["positional_logits"].double(), *out["oracle_f64"]),
    }
    # The first call in the process pays for lazy CUDA module loading and
    # library handles; the median of the repeats that follow is the steady
    # state.
    forwards = (1 + REPEATS) * (len(positions) + 2)
    runs = {name: [] for name in requests}
    out = {}
    _ext.reset_launch_counts()
    for _ in range(1 + REPEATS):
        for name, fn in requests.items():
            ms, wall_ms, out[name] = timed_request(fn)
            runs[name].append((ms, wall_ms))
    launches = _ext.launch_counts["pfn_flash_fwd"]
    latency = {f"{name}/first": r[0][0] for name, r in runs.items()}
    latency.update({f"{name}/median_of_{REPEATS}": float(np.median([ms for ms, _ in r[1:]]))
                    for name, r in runs.items()})
    wall = {f"{name}/first": r[0][1] for name, r in runs.items()}
    wall.update({f"{name}/median_of_{REPEATS}": float(np.median([w for _, w in r[1:]])) for name, r in runs.items()})
    if launches != cfg.nlayers * forwards:
        raise AssertionError(f"{launches} kernel launches, expected {cfg.nlayers} layers x {forwards} forwards")
    profile = device_profile(requests["positional_logits"], top=10)
    logits, (mean, std), quants = out["positional_logits"], out["predict_return_std"], out["predict_quantiles"]
    (mu, var), kl = out["oracle_f64"], out["gaussian_kl_f64"]

    agreement, agreement_checks = logits_vs_dense(cfg, state_dict, x, y, positions, logits, device)
    checks = {
        "logits_shape": tuple(logits.shape) == (len(positions), size["datasets"], cfg.n_out),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "predict_finite": bool(np.isfinite(mean).all() and np.isfinite(std).all() and (std > 0).all()),
        "quantiles_ordered": bool(np.isfinite(quants).all() and (np.diff(quants, axis=0) >= 0).all()),
        "oracle_finite": bool(torch.isfinite(mu).all() and torch.isfinite(var).all() and (var > 0).all()),
        "kl_finite": bool(torch.isfinite(kl).all()),
        "kl_nonnegative": bool(kl.min() >= -1e-6),
        **agreement_checks,
    }
    emit({
        "phase": "slice", "card": smi, "size": size, "dtype": "bf16",
        "latency_ms": latency, "wall_ms": wall,
        "kl_mean_per_position": kl.mean(dim=1).tolist(),
        **agreement, "launches": launches, "positional_logits_profile": profile,
        "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return launches


def logits_vs_dense(cfg, state_dict: dict, x, y, positions, logits, device) -> tuple[dict, dict]:
    """The kernel path's positional ``logits`` (a bf16 model of ``cfg`` with
    ``state_dict``, on datasets ``x``, ``y`` at ``positions``) against the
    same model on the dense path, in max-abs and in relative L2 (|kernel -
    dense| / |f32|). bf16 rounds at other places on the two paths, so each
    is held to 2x the dense bf16 model's own distance from a dense f32 model
    + 1e-3. The reach: the f32 model with the attention output scaled by 1
    + FUSED_BF16_PROBE; its change of the logits, in each measure, must
    exceed that measure's budget, or the check is blind. Returns (readings,
    checks)."""
    import torch

    from pfn_tpu_torch.evals import eval_positional_logits_per_dataset
    from pfn_tpu_torch.models import PFNTransformer

    def dense_logits(weights: dict, dtype):
        model = PFNTransformer(dataclasses.replace(cfg, attention_impl="dense", dtype=dtype)).to(device).eval()
        model.load_state_dict(weights, strict=True)
        return eval_positional_logits_per_dataset(model, x, y, positions).float()

    logits = logits.float()
    dense = dense_logits(state_dict, torch.bfloat16)
    f32 = dense_logits(state_dict, torch.float32)
    probe = dense_logits(_value_probe(state_dict, cfg.emsize, FUSED_BF16_PROBE), torch.float32)
    err_dense_f32 = max_abs(dense, f32)
    budget = {"max_abs": 2 * err_dense_f32 + 1e-3, "rel_l2": 2 * _rel_l2(dense, f32) + 1e-3}
    diff = {"max_abs": max_abs(logits, dense), "rel_l2": float((logits - dense).norm() / f32.norm())}
    reach = {"max_abs": max_abs(probe, f32), "rel_l2": _rel_l2(probe, f32)}
    readings = {
        "err_kernel_vs_dense": diff["max_abs"], "err_dense_vs_f32": err_dense_f32,
        "err_kernel_vs_f32": max_abs(logits, f32), "rel_l2_kernel_vs_dense": diff["rel_l2"],
        "logits_budget": budget, "probe_scale": FUSED_BF16_PROBE, "probe_change": reach,
    }
    checks = {
        "kernel_vs_dense": diff["max_abs"] <= budget["max_abs"],
        "kernel_vs_dense_rel_l2": diff["rel_l2"] <= budget["rel_l2"],
        "max_abs_check_sees_the_probe": reach["max_abs"] > budget["max_abs"],
        "rel_l2_check_sees_the_probe": reach["rel_l2"] > budget["rel_l2"],
    }
    return readings, checks


def bf16_update_vs_dense(prior, criterion, cfg, weights: dict, device, kernel_weights: dict | None = None) -> dict:
    """One bf16 update of ``cfg`` from ``weights`` on the kernel path
    (attention_impl "auto": the flash kernels at T >= 256 on the card) and on
    the dense path, with the dense f32 update as the yardstick, on the same 2
    microbatches of a seeded batch at sep T // 2; ``kernel_weights``, where
    given, start the kernel path in place of ``weights``. Held: the loss and
    the grad norm within 2x the dense path's own bf16 difference + 1e-3 of
    the f32 value, and the whole clipped gradient vector within 2x the dense
    bf16 path's relative L2 distance + 1e-3 (|kernel - dense| / |f32|). The
    reach: the dense f32 update with the attention output scaled by 1 +
    FUSED_BF16_PROBE; its relative change of the gradient vector must
    exceed the vector's budget, or the check is blind. Returns {one, diff,
    budget, probe_rel_change, checks}."""
    import torch

    batch = _two_microbatches(prior, cfg, device)
    bf16, f32 = {"dtype": torch.bfloat16}, {"attention_impl": "dense", "dtype": torch.float32}
    variants = (("kernel_bf16", bf16, weights if kernel_weights is None else kernel_weights),
                ("dense_bf16", {**bf16, "attention_impl": "dense"}, weights), ("dense_f32", f32, weights),
                ("dense_f32_probe", f32, _value_probe(weights, cfg.emsize, FUSED_BF16_PROBE)))
    one, grads = {}, {}
    for name, over, w in variants:
        pcfg = dataclasses.replace(cfg, aggregate_k_gradients=2, steps_per_epoch=2, eval_pos_sampler="fixed",
                                   fixed_eval_pos=cfg.bptt // 2, checkpoint_dir=None, **over)
        one[name], grads[name] = _one_update(prior, criterion, pcfg, w, batch, device)
    ref = grads["dense_f32"]
    keys = ("loss", "grad_norm")
    budget = {**{key: 2 * abs(one["dense_bf16"][key] - one["dense_f32"][key]) + 1e-3 * abs(one["dense_f32"][key])
                 for key in keys},
              "grads": 2 * _rel_l2(grads["dense_bf16"], ref) + 1e-3}
    diff = {**{key: abs(one["kernel_bf16"][key] - one["dense_bf16"][key]) for key in keys},
            "grads": float((grads["kernel_bf16"] - grads["dense_bf16"]).norm() / ref.norm())}
    reach = _rel_l2(grads["dense_f32_probe"], ref)
    return {"one": one, "diff": diff, "budget": budget, "probe_rel_change": reach, "checks": {
        "kernel_vs_dense_update": all(diff[key] <= budget[key] for key in budget),
        # A check that cannot see an attention error of known size is blind.
        "bf16_check_sees_the_probe": reach > budget["grads"]}}


def _param_vector(state_dict):
    """All entries of a state_dict, by sorted name, as one f32 vector."""
    import torch

    return torch.cat([state_dict[name].detach().float().reshape(-1) for name in sorted(state_dict)])


def phase_train(device, smi: str, size: dict = FIG3A_TRAIN):
    """The round-5 Fig-3a recipe at full width through ``train(...)``: epoch 1
    into a checkpoint, a second call that resumes it and runs epoch 2."""
    import io
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.inference import PFNRegressor
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
    from pfn_tpu_torch.train import (
        TrainConfig,
        full_support_bar_criterion,
        seeded_flax_params,
        state_dict_from_flax_params,
        train,
    )

    T, k = size["T"], size["agg"]
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6, grid=size["grid"])
    ys = sample_y_for_buckets(prior, 100_000, T, seed=7, max_seq_len=size["bucket_seq_cap"], device=device)
    criterion = full_support_bar_criterion(get_bucket_limits(size["buckets"], ys=ys)).to(device)
    ckdir = tempfile.mkdtemp(prefix="pfn_train_")
    cfg = TrainConfig(
        emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"], bptt=T,
        batch_size=size["batch_size"], aggregate_k_gradients=k, epochs=2, steps_per_epoch=size["updates"] * k,
        lr=size["lr"], warmup_epochs=2, eval_pos_sampler="mixture", eval_pos_max=min(2000, T),
        dtype=torch.bfloat16, checkpoint_dir=ckdir, checkpoint_every=1, device=device, seed=0,
    )
    # Seeded random weights through the weight bridge, not the fresh init:
    # at the fresh init an eval token at the grid's x = 0.0 is an exact zero
    # row (zero encoder bias), whose gradient 12 LayerNorms amplify past the
    # f32 range, so the clipped update is zero (the JAX package does the
    # same; ROADMAP.md queue 3). Nonzero out_proj also lets attention reach
    # the loss, so the kernel and dense paths below differ.
    init = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, size["buckets"], seed=0), cfg.nlayers)
    initial = _param_vector(init).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    first = train(prior, criterion, dataclasses.replace(cfg, epochs=1), init_params=init)
    after_epoch1 = _param_vector(first.model.state_dict())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = train(prior, criterion, cfg, init_params=init)
    train_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    launches = {name: _ext.launch_counts[name] for name in ("pfn_flash_fwd", "pfn_flash_bwd_dq", "pfn_flash_bwd_dkv")}
    expected = cfg.nlayers * k * 2 * size["updates"]
    stats = first.epoch_stats + result.epoch_stats
    after_epoch2 = _param_vector(result.model.state_dict())

    # One update on the kernel path and on the dense path (and an f32 dense
    # model as the yardstick, and a probe), from the same params, batch and sep.
    one = bf16_update_vs_dense(prior, criterion, cfg, result.model.state_dict(), device)

    # Update time, continuing from the trained weights: the first update of a
    # new optimizer state, then the median of the rest.
    step, state, update_ms, median_ms = timed_updates(prior, criterion, cfg, result.model, device,
                                                      size["timed_updates"])
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    profile = device_profile(lambda: float(step(state)["loss"]), top=10)
    # sep, the prior's draws and the clip stay on the device: an update
    # enqueues its work without waiting for the card.
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    no_host_sync = bool(np.isfinite(float(metrics["loss"])))

    # Held-out prediction from the trained model.
    x, y, _ = prior.sample(1, T, generator=torch.Generator(device=device).manual_seed(11), device=device)
    x_np, y_np = x[0].cpu().numpy(), y[0].cpu().numpy()
    mean, std = PFNRegressor.from_train_result(result).fit(x_np[:1000], y_np[:1000]).predict(
        x_np[1000:], return_std=True)

    checks = {
        "resumed": "resumed from" in log.getvalue(),
        "epochs": [s["epoch"] for s in stats] == [1, 2],
        "lr": [s["lr"] for s in stats] == [0.0, cfg.lr / 2],
        "losses_finite": all(np.isfinite(s["mean_loss"]) and np.isfinite(s["grad_norm"]) for s in stats),
        "lr0_epoch_keeps_params": bool(torch.equal(after_epoch1, initial)),
        "params_changed_in_epoch2": bool((after_epoch2 != after_epoch1).any()),
        "launches": all(n == expected for n in launches.values()),
        **one["checks"],
        "predict_finite": bool(np.isfinite(mean).all() and np.isfinite(std).all() and (std > 0).all()),
        "update_without_host_sync": no_host_sync,
    }
    emit({
        "phase": "train", "card": smi, "size": size, "dtype": "bf16", "epoch_stats": stats,
        "train_calls_s": train_s, "launches": launches, "expected_launches": expected,
        "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
        "datasets_per_s": size["batch_size"] * k / (median_ms / 1e3), "peak_memory_gb": peak_gb,
        "one_update": one["one"], "one_update_diff": one["diff"], "one_update_budget": one["budget"],
        "probe_scale": FUSED_BF16_PROBE, "probe_rel_change": one["probe_rel_change"], "update_profile": profile,
        "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    return launches


def _fused_params(D: int, F: int, g, device) -> dict:
    """Random fused-layer weights in the JAX layout, f32: matrices
    N(0, 1/fan_in), biases N(0, 0.3^2), LayerNorm scales 1 + N(0, 0.3^2)."""
    import torch

    from pfn_tpu_torch.ops import _ext

    p = {}
    for k, shape in _ext.fused_param_shapes(D, F).items():
        a = torch.randn(*shape, generator=g, device=device)
        p[k] = a / shape[0] ** 0.5 if a.dim() == 2 else 0.3 * a + (1.0 if k.endswith("_g") else 0.0)
    return p


def phase_fused_kernel(device):
    """The fused layer kernel against its plain version: y, r and lse, on the
    grid and at FUSED_FWD_EDGES; a repeat call bitwise equal."""
    import torch

    from pfn_tpu_torch.ops.fused_layer import fused_layer_fwd, fused_layer_fwd_plain

    g = torch.Generator(device=device).manual_seed(4)
    worst, n = {}, 0

    def check(D, H, F, p, T, B, sep, dtypes=(torch.float32, torch.bfloat16)):
        x = torch.randn(B, T, D, generator=g, device=device)
        gold = fused_layer_fwd_plain(x, p, sep, H, torch.float32)
        for dtype in dtypes:
            got = fused_layer_fwd(x, p, sep, H, dtype)
            again = fused_layer_fwd(x, p, sep, H, dtype)
            torch.cuda.synchronize()
            case = dict(D=D, H=H, F=F, T=T, B=B, sep=sep, dtype=str(dtype))
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise AssertionError(f"fused kernel: non-finite output {case}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"fused kernel: a repeat call differs {case}")
            errs = {name: max_abs(a, b) for name, a, b in zip(("y", "r", "lse"), got, gold)}
            if dtype == torch.float32:
                for name, a, b in zip(("y", "r", "lse"), got, gold):
                    if not torch.allclose(a, b, atol=FUSED_F32_TOL, rtol=FUSED_F32_TOL):
                        raise AssertionError(f"fused kernel: {name} mismatch {case}: {errs[name]}")
            else:
                plain = fused_layer_fwd_plain(x, p, sep, H, torch.bfloat16)
                for name, a, b in zip(("y", "r", "lse"), plain, gold):
                    budget = 2 * max_abs(a, b) + 1e-3
                    errs[f"{name}_budget"] = budget
                    if errs[name] > budget:
                        raise AssertionError(
                            f"fused kernel: bf16 {name} error {errs[name]} over budget {budget}: {case}")
            w = worst.setdefault(case["dtype"], {"cases": 0})
            w["cases"] += 1
            for name in ("y", "r", "lse"):
                w[name] = max(w.get(name, 0.0), errs[name])
                if f"{name}_budget" in errs:
                    w[f"{name}_worst_share_of_budget"] = max(
                        w.get(f"{name}_worst_share_of_budget", 0.0), errs[name] / errs[f"{name}_budget"])

    for D, H, F in ((512, 4, 1024), (64, 2, 96), (32, 2, 48)):
        p = _fused_params(D, F, g, device)
        for T in (1, 16, 100, 127, 128, 129, 512):
            for B in ((1, 3, 64) if T == 100 else (1, 3)):
                for sep in sorted({0, 1, T // 2, T - 1, T}):
                    check(D, H, F, p, T, B, sep)
                    n += 2
    grid = n
    for D, H, F, T, B in FUSED_FWD_EDGES:
        p = _fused_params(D, F, g, device)
        for sep in sorted({0, T // 2, T - 1, T}):
            check(D, H, F, p, T, B, sep)
            n += 2
    f32_edges = 0
    for D, H, F, T, B in FUSED_F32_EDGES:
        p = _fused_params(D, F, g, device)
        for sep in sorted({0, T // 2, T - 1, T}):
            check(D, H, F, p, T, B, sep, dtypes=(torch.float32,))
            f32_edges += 1
    n += f32_edges
    emit({"phase": "fused_kernel", "cases": n, "grid_cases": grid, "edge_cases": n - grid - f32_edges,
          "f32_edge_cases": f32_edges, "worst": worst,
          "tol_f32": FUSED_F32_TOL,
          "bf16_rule": "err <= 2 * plain_bf16_err + 1e-3 against the plain f32 gold, for y, r and lse",
          "repeat_bitwise_equal": True})


def _load_layer(layer, p: dict) -> None:
    """Copy fused-layer weights in the JAX layout into a PFNEncoderLayer."""
    import torch

    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(p["wqkv"].t())
        layer.self_attn.in_proj_bias.copy_(p["bqkv"])
        for name, w, b in (("self_attn.out_proj", "wout", "bout"), ("linear1", "w1", "b1"), ("linear2", "w2", "b2")):
            layer.get_submodule(name).weight.copy_(p[w].t())
            layer.get_submodule(name).bias.copy_(p[b])
        for i in (1, 2):
            layer.get_submodule(f"norm{i}").weight.copy_(p[f"ln{i}_g"])
            layer.get_submodule(f"norm{i}").bias.copy_(p[f"ln{i}_b"])


def _chain_kernels(profile: dict) -> list:
    """The kernels of a fused entry point's own chain in a device_profile
    (PyTorch's kernels, the wrappers' allocations and fills, are named
    at::...)."""
    return [k for k in profile["kernels"] if "at::" not in k[0]]


def _kernel_count(chain: list):
    """Device kernels launched in a profiled call, or "not measured"."""
    return sum(k[2] for k in chain) if chain else "not measured"


def phase_fused_timing(device, smi: str, size: dict = FLAGSHIP):
    """One fused layer at the flagship shape, bf16: the kernel, its plain
    version and the unfused PFNEncoderLayer forward (cuBLAS and the flash
    forward kernel), by CUDA events, and the kernel's and the unfused
    layer's device time (the unfused layer's events time is bound by its
    host), beside the bound; at the flagship sep a device profile of one
    kernel call, its device kernels per layer and its host time per call."""
    import torch

    from pfn_tpu_torch.models import PFNEncoderLayer
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.fused_layer import _kernel_params, fused_layer_fwd_plain

    B, T, D, H, F = size["B"], size["T"], size["emsize"], size["nhead"], size["nhid"]
    g = torch.Generator(device=device).manual_seed(6)
    p = _fused_params(D, F, g, device)
    kp = _kernel_params(p, torch.bfloat16)
    x = torch.randn(B, T, D, generator=g, device=device)
    layer = PFNEncoderLayer(D, H, F, dtype=torch.bfloat16).to(device).eval()
    _load_layer(layer, p)
    rows = []
    with torch.no_grad():
        for sep in FUSED_TIMING_SEPS:
            sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
            y, _, _ = _ext.fused_layer_fwd(x, kp, sep_t, H)
            y_plain, _, _ = fused_layer_fwd_plain(x, p, sep_t, H, torch.bfloat16)
            rows.append({
                "sep": sep,
                "kernel_ms": cuda_ms(lambda: _ext.fused_layer_fwd(x, kp, sep_t, H)),
                "plain_ms": cuda_ms(lambda: fused_layer_fwd_plain(x, p, sep_t, H, torch.bfloat16)),
                "unfused_layer_ms": cuda_ms(lambda: layer(x, sep_t)),
                "kernel_ms_again": cuda_ms(lambda: _ext.fused_layer_fwd(x, kp, sep_t, H)),
                "kernel_dev_ms": device_ms(lambda: _ext.fused_layer_fwd(x, kp, sep_t, H)),
                "unfused_layer_dev_ms": device_ms(lambda: layer(x, sep_t)),
                "max_abs_err": max_abs(y, y_plain),
                **fused_layer_bound(B, T, D, H, F, sep),
            })
        sep_t = torch.full((1,), size["sep"], dtype=torch.int32, device=device)

        def call():
            return _ext.fused_layer_fwd(x, kp, sep_t, H)

        profile = device_profile(call, top=64)
        host = host_us(call)
    chain = _chain_kernels(profile)
    emit({"phase": "fused_timing", "shape": {"B": B, "T": T, "D": D, "H": H, "F": F, "dtype": "bf16"},
          "card": smi, "device_kernels_per_layer": _kernel_count(chain), "rows": rows,
          "sep_profiled": size["sep"], "profile": profile, "host_us_per_call": host})
    # No fallback: a bf16 call launches only the Hopper kernels, the
    # LayerNorm and the cast. (Where the profiler saw no kernel, phase_build's
    # check of the library's kernels stands alone.)
    other = [k[0] for k in chain if not any(name in k[0] for name in FUSED_FWD_BF16_KERNELS)]
    if other:
        raise AssertionError(f"fused_timing: the bf16 forward launched {other}")
    return rows


def phase_fused_bwd_kernel(device):
    """Both fused backward kernels against fused_layer_bwd_plain on the grid
    of phase_fused_kernel and on FUSED_BWD_EDGES: dx and all 12 gradients; r
    and lse from the forward kernel; a repeat call bitwise equal."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.fused_layer import fused_layer_bwd, fused_layer_bwd_plain, fused_layer_fwd, \
        fused_layer_fwd_plain

    names = ("dx", *_ext.FUSED_PARAM_ORDER)
    g = torch.Generator(device=device).manual_seed(9)
    worst, n = {}, 0

    def check(D, H, F, p, T, B, sep, dtypes=(torch.float32, torch.bfloat16)):
        x = torch.randn(B, T, D, generator=g, device=device)
        dy = torch.randn(B, T, D, generator=g, device=device)

        def grads(bwd, dtype, r, lse):
            dx, dp = bwd(x, p, sep, r, lse, dy, H, dtype)
            return {"dx": dx, **dp}

        gold = grads(fused_layer_bwd_plain, torch.float32, *fused_layer_fwd_plain(x, p, sep, H, torch.float32)[1:])
        for dtype in dtypes:
            _, r, lse = fused_layer_fwd(x, p, sep, H, dtype)
            got = grads(fused_layer_bwd, dtype, r, lse)
            again = grads(fused_layer_bwd, dtype, r, lse)
            torch.cuda.synchronize()
            case = dict(D=D, H=H, F=F, T=T, B=B, sep=sep, dtype=str(dtype))
            if not all(bool(torch.isfinite(t).all()) for t in got.values()):
                raise AssertionError(f"fused backward: non-finite gradient {case}")
            if not all(torch.equal(got[k], again[k]) for k in names):
                raise AssertionError(f"fused backward: a repeat call differs {case}")
            if dtype == torch.float32:
                plain = grads(fused_layer_bwd_plain, dtype, r, lse)
                errs = {k: max_abs(got[k], plain[k]) for k in names}
                for k in names:
                    if not torch.allclose(got[k], plain[k], atol=FUSED_BWD_F32_TOL, rtol=FUSED_BWD_F32_TOL):
                        raise AssertionError(f"fused backward: {k} mismatch {case}: {errs[k]}")
            else:
                dense = grads(fused_layer_bwd_plain, dtype, *fused_layer_fwd_plain(x, p, sep, H, dtype)[1:])
                errs = _rel_errors(got, gold, dense)
                if not _bf16_ok(errs, names):
                    raise AssertionError(f"fused backward: bf16 error over budget {case}: {errs}")
            w = worst.setdefault(case["dtype"], {"cases": 0})
            w["cases"] += 1
            for k, e in errs.items():
                w[k] = max(w.get(k, 0.0), e)

    for D, H, F in ((512, 4, 1024), (64, 2, 96), (32, 2, 48)):
        p = _fused_params(D, F, g, device)
        for T in (1, 16, 100, 127, 128, 129, 512):
            for B in ((1, 3, 64) if T == 100 else (1, 3)):
                for sep in sorted({0, 1, T // 2, T - 1, T}):
                    check(D, H, F, p, T, B, sep)
                    n += 2
    for D, H, F, T, B in FUSED_BWD_EDGES:
        p = _fused_params(D, F, g, device)
        for sep in sorted({0, T // 2, T}):
            check(D, H, F, p, T, B, sep)
            n += 2
    f32_edges = 0
    for D, H, F, T, B in FUSED_F32_EDGES:
        p = _fused_params(D, F, g, device)
        for sep in sorted({0, T // 2, T - 1, T}):
            check(D, H, F, p, T, B, sep, dtypes=(torch.float32,))
            f32_edges += 1
    n += f32_edges
    emit({"phase": "fused_bwd_kernel", "cases": n, "f32_edge_cases": f32_edges, "worst": worst,
          "tol_f32": FUSED_BWD_F32_TOL,
          "bf16_rule": f"err/max|gold| <= max({BF16_GRAD_FLOOR}, 3 * plain_bf16_err/max|gold|) per gradient, "
                       "against the plain f32 backward of the plain f32 forward",
          "repeat_bitwise_equal": True})


def host_us(fn, calls: int = 50) -> float:
    """Mean host time of one fn() call over ``calls`` calls without a
    synchronize in between (the enqueue), in us."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_fused_bwd_timing(device, smi: str, size: dict = FLAGSHIP):
    """The fused layer's two backward kernels at the flagship shape, bf16,
    beside their plain versions, the unfused PFNEncoderLayer's backward
    (autograd through cuBLAS and the flash backward kernels; by events and
    by device time) and the bound;
    at the flagship sep a device profile of one call of each entry point
    (every device kernel with its time), its host time per call, and its
    device kernels per layer counted from that profile."""
    import torch

    from pfn_tpu_torch.models import PFNEncoderLayer
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.fused_layer import _bwd_attn_plain, _bwd_ffn_plain, _kernel_params, \
        fused_layer_bwd_plain

    B, T, D, H, F = size["B"], size["T"], size["emsize"], size["nhead"], size["nhid"]
    g = torch.Generator(device=device).manual_seed(10)
    p = _fused_params(D, F, g, device)
    kp = _kernel_params(p, torch.bfloat16)
    x = torch.randn(B, T, D, generator=g, device=device)
    dy = torch.randn(B, T, D, generator=g, device=device)
    layer = PFNEncoderLayer(D, H, F, dtype=torch.bfloat16).to(device)
    _load_layer(layer, p)
    rows = []
    for sep in FUSED_TIMING_SEPS:
        sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
        _, r, lse = _ext.fused_layer_fwd(x, kp, sep_t, H)
        dr, dp_ffn = _ext.fused_layer_bwd_ffn(r, kp, dy)
        dx, dp_attn = _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)
        dx_plain, dp_plain = fused_layer_bwd_plain(x, p, sep_t, r, lse, dy, H, torch.bfloat16)
        dr_plain, _ = _bwd_ffn_plain(r, p, dy, torch.bfloat16)
        leaves = [x.detach().requires_grad_(), *layer.parameters()]
        out = layer(leaves[0], sep_t)
        ffn_err = max([max_abs(dr, dr_plain)] + [max_abs(v, dp_plain[k]) for k, v in dp_ffn.items()])
        attn_err = max([max_abs(dx, dx_plain)] + [max_abs(v, dp_plain[k]) for k, v in dp_attn.items()])
        rows.append({
            "sep": sep,
            "ffn_kernel_ms": cuda_ms(lambda: _ext.fused_layer_bwd_ffn(r, kp, dy)),
            "attn_kernel_ms": cuda_ms(lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)),
            "ffn_plain_ms": cuda_ms(lambda: _bwd_ffn_plain(r, p, dy, torch.bfloat16)),
            "attn_plain_ms": cuda_ms(lambda: _bwd_attn_plain(x, p, sep_t, lse, dr, H, torch.bfloat16)),
            "unfused_layer_bwd_ms": cuda_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)),
            "unfused_layer_bwd_dev_ms": device_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)),
            "ffn_kernel_ms_again": cuda_ms(lambda: _ext.fused_layer_bwd_ffn(r, kp, dy)),
            "attn_kernel_ms_again": cuda_ms(lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)),
            "ffn_kernel_dev_ms": device_ms(lambda: _ext.fused_layer_bwd_ffn(r, kp, dy)),
            "attn_kernel_dev_ms": device_ms(lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)),
            "ffn_max_abs_err": ffn_err,
            "attn_max_abs_err": attn_err,
            "ffn_bound": fused_layer_bwd_bound("ffn", B, T, D, H, F, sep),
            "attn_bound": fused_layer_bwd_bound("attn", B, T, D, H, F, sep),
        })
    sep_t = torch.full((1,), size["sep"], dtype=torch.int32, device=device)
    _, r, lse = _ext.fused_layer_fwd(x, kp, sep_t, H)
    dr, _ = _ext.fused_layer_bwd_ffn(r, kp, dy)
    calls = {"ffn": lambda: _ext.fused_layer_bwd_ffn(r, kp, dy),
             "attn": lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)}
    profiles = {part: device_profile(fn, top=64) for part, fn in calls.items()}
    per_layer = {part: _kernel_count(_chain_kernels(prof)) for part, prof in profiles.items()}
    emit({"phase": "fused_bwd_timing", "shape": {"B": B, "T": T, "D": D, "H": H, "F": F, "dtype": "bf16"},
          "card": smi, "device_kernels_per_layer": per_layer, "rows": rows, "sep_profiled": size["sep"],
          "profiles": profiles, "host_us_per_call": {part: host_us(fn) for part, fn in calls.items()}})
    return rows


def _unfused_block_grads(layer, x, sep_t, dy, dr):
    """Autograd calls of the unfused f32 PFNEncoderLayer's two blocks alone,
    the per-block yardsticks of the fused backward kernels: the FFN block
    (LN1's output r back through linear1, GELU, linear2 and LN2 to dy) and
    the attention block (x through the qkv projection, the dense PFN
    attention, out_proj and LN1 to dr). Each retains its graph."""
    import torch
    import torch.nn.functional as F

    from pfn_tpu_torch.models.transformer import _linear

    f32 = torch.float32
    with torch.no_grad():
        r_in = layer.norm1(x + layer.self_attn(x, sep_t))
    r_leaf = r_in.detach().requires_grad_()
    h = F.gelu(_linear(r_leaf, layer.linear1, f32), approximate=layer.gelu_approximate)
    y = layer.norm2(r_leaf + _linear(h, layer.linear2, f32))
    ffn_leaves = [r_leaf, *layer.linear1.parameters(), *layer.linear2.parameters(), *layer.norm2.parameters()]
    x_leaf = x.detach().requires_grad_()
    r_out = layer.norm1(x_leaf + layer.self_attn(x_leaf, sep_t))
    attn_leaves = [x_leaf, *layer.self_attn.parameters(), *layer.norm1.parameters()]
    return {"ffn": lambda: torch.autograd.grad(y, ffn_leaves, dy, retain_graph=True),
            "attn": lambda: torch.autograd.grad(r_out, attn_leaves, dr, retain_graph=True)}


def phase_fused_f32_timing(device, smi: str, size: dict = FLAGSHIP):
    """The fused layer's f32 bodies (forward, FFN backward, attention
    backward) at the flagship shape and sep, each held to its plain version
    (FUSED_F32_TOL, FUSED_BWD_F32_TOL), a repeat call of each bitwise equal,
    and each timed beside its plain version and its yardstick in the unfused
    f32 PFNEncoderLayer (dense attention at T 100), by CUDA events and by
    device time, with the ratio of each: the forward against the layer's
    forward, the FFN backward against the FFN block's backward alone, the
    attention backward against the attention block's backward alone, and
    both backward kernels together against the layer's whole backward;
    beside the bound at 67 TFLOP/s and 3.35 TB/s. A device profile of one call of each chain lists every device
    kernel (the split by sub-kernel; the backward's weight gradients overlap
    other products on a second stream, so its kernel times sum past its
    device time)."""
    import torch

    from pfn_tpu_torch.models import PFNEncoderLayer
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.fused_layer import _bwd_attn_plain, _bwd_ffn_plain, _kernel_params, \
        fused_layer_bwd_plain, fused_layer_fwd_plain

    B, T, D, H, F, sep = size["B"], size["T"], size["emsize"], size["nhead"], size["nhid"], size["sep"]
    g = torch.Generator(device=device).manual_seed(12)
    p = _fused_params(D, F, g, device)
    kp = _kernel_params(p, torch.float32)
    x = torch.randn(B, T, D, generator=g, device=device)
    dy = torch.randn(B, T, D, generator=g, device=device)
    layer = PFNEncoderLayer(D, H, F, dtype=torch.float32).to(device)
    _load_layer(layer, p)
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)

    y, r, lse = _ext.fused_layer_fwd(x, kp, sep_t, H)
    y_plain, r_plain, lse_plain = fused_layer_fwd_plain(x, p, sep_t, H, torch.float32)
    dr, dp_ffn = _ext.fused_layer_bwd_ffn(r, kp, dy)
    dx, dp_attn = _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)
    dx_plain, dp_plain = fused_layer_bwd_plain(x, p, sep_t, r, lse, dy, H, torch.float32)
    dr_plain, _ = _bwd_ffn_plain(r, p, dy, torch.float32)
    pairs = {"fwd": [(y, y_plain), (r, r_plain), (lse, lse_plain)],
             "ffn": [(dr, dr_plain)] + [(v, dp_plain[k]) for k, v in dp_ffn.items()],
             "attn": [(dx, dx_plain)] + [(v, dp_plain[k]) for k, v in dp_attn.items()]}
    errs = {part: max(max_abs(a, b) for a, b in ab) for part, ab in pairs.items()}
    for part, ab in pairs.items():
        tol = FUSED_F32_TOL if part == "fwd" else FUSED_BWD_F32_TOL
        if not all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in ab):
            raise AssertionError(f"fused_f32_timing: the f32 {part} body disagrees with its plain version: {errs}")
    # A repeat call of each body, bitwise equal (no atomics on the chains).
    again = {"fwd": _ext.fused_layer_fwd(x, kp, sep_t, H), "ffn": _ext.fused_layer_bwd_ffn(r, kp, dy),
             "attn": _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)}
    for part, out in again.items():
        first = pairs[part]
        tensors = list(out) if part == "fwd" else [out[0], *out[1].values()]
        if not all(torch.equal(a, b) for a, (b, _) in zip(tensors, first)):
            raise AssertionError(f"fused_f32_timing: a repeat call of the f32 {part} body differs")

    with torch.no_grad():
        unfused_fwd = (cuda_ms(lambda: layer(x, sep_t)), device_ms(lambda: layer(x, sep_t)))
    leaves = [x.detach().requires_grad_(), *layer.parameters()]
    out = layer(leaves[0], sep_t)
    whole = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)  # noqa: E731
    unfused_bwd = (cuda_ms(whole), device_ms(whole))
    blocks = _unfused_block_grads(layer, x, sep_t, dy, dr)
    unfused_block = {part: (cuda_ms(fn), device_ms(fn)) for part, fn in blocks.items()}
    calls = {"fwd": (lambda: _ext.fused_layer_fwd(x, kp, sep_t, H),
                     lambda: fused_layer_fwd_plain(x, p, sep_t, H, torch.float32), unfused_fwd,
                     fused_layer_bound(B, T, D, H, F, sep, "f32")),
             "ffn": (lambda: _ext.fused_layer_bwd_ffn(r, kp, dy),
                     lambda: _bwd_ffn_plain(r, p, dy, torch.float32), unfused_block["ffn"],
                     fused_layer_bwd_bound("ffn", B, T, D, H, F, sep, "f32")),
             "attn": (lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H),
                      lambda: _bwd_attn_plain(x, p, sep_t, lse, dr, H, torch.float32), unfused_block["attn"],
                      fused_layer_bwd_bound("attn", B, T, D, H, F, sep, "f32"))}
    rows, profiles = {}, {}
    for part, (kernel, plain, (lib_ms, lib_dev_ms), b) in calls.items():
        ms, dev = cuda_ms(kernel), device_ms(kernel)
        rows[part] = {"ms": ms, "dev_ms": dev, "plain_ms": cuda_ms(plain), "library_ms": lib_ms,
                      "library_dev_ms": lib_dev_ms, "max_abs_err": errs[part], **b,
                      "pct_of_bound": 100.0 * b["bound_ms"] / ms, "against_library": ms / lib_ms,
                      "against_library_dev": dev / lib_dev_ms}
        profiles[part] = device_profile(kernel, top=64)
    # The backward's two kernels together against the unfused layer's whole backward.
    both = rows["ffn"]["ms"] + rows["attn"]["ms"]
    both_dev = rows["ffn"]["dev_ms"] + rows["attn"]["dev_ms"]
    emit({"phase": "fused_f32_timing", "card": smi,
          "shape": {"B": B, "T": T, "D": D, "H": H, "F": F, "sep": sep, "dtype": "f32"}, "rows": rows,
          "bwd_both_ms": both, "bwd_both_dev_ms": both_dev, "unfused_bwd_ms": unfused_bwd[0],
          "unfused_bwd_dev_ms": unfused_bwd[1], "bwd_both_against_library": both / unfused_bwd[0],
          "bwd_both_against_library_dev": both_dev / unfused_bwd[1], "repeat_bitwise_equal": True,
          "device_kernels_per_call": {part: _kernel_count(_chain_kernels(prof)) for part, prof in profiles.items()},
          "profiles": profiles,
          "library_note": "the unfused f32 PFNEncoderLayer (dense attention at T 100): the forward against its "
                          "forward, each backward kernel against its block's backward alone, both together "
                          "against its whole backward; against_library by events, against_library_dev by "
                          "device time (the autograd yardsticks are many small launches, so their event "
                          "times carry the host's)",
          "dev_ms_note": "the union of a call's kernel intervals; the f32 backward runs its weight gradients on "
                         "a second stream beside other products, so its profile's kernel times sum past it"})
    return rows


def phase_fused_path(device, smi: str, size: dict = FLAGSHIP):
    """fused_forward at the bench.py flagship model against the unfused
    forward; the kernel's launches on the fused path; one backward through
    it on the card."""
    import numpy as np
    import torch

    from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
    from pfn_tpu_torch.models.fused_apply import fused_forward
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior
    from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

    B, T = size["B"], size["T"]
    cfg = TransformerConfig(num_features=1, n_out=size["buckets"], emsize=size["emsize"], nhead=size["nhead"],
                            nhid=size["nhid"], nlayers=size["nlayers"], dtype=torch.bfloat16)
    state_dict = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, cfg.n_out, seed=0), cfg.nlayers)
    for name in ("self_attn.out_proj.weight", "linear2.weight"):
        if not bool(state_dict[f"transformer_encoder.layers.0.{name}"].abs().sum() > 0):
            raise AssertionError(f"{name} is zero: attention would not reach the output")

    def build(**over):
        model = PFNTransformer(dataclasses.replace(cfg, **over)).to(device).eval()
        model.load_state_dict(state_dict, strict=True)
        return model

    model = build()
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6, grid=size["grid"])
    x, y, _ = prior.sample(B, T, generator=torch.Generator(device=device).manual_seed(13), device=device)
    sep = torch.full((1,), size["sep"], dtype=torch.int32, device=device)
    with torch.no_grad():
        _ext.reset_launch_counts()
        fused_runs = [timed_request(lambda: fused_forward(model, x, y, sep)) for _ in range(1 + REPEATS)]
        launched = dict(_ext.launch_counts)
        unfused_runs = [timed_request(lambda: model(x, y, sep)) for _ in range(1 + REPEATS)]
        logits = fused_runs[-1][2]
        unfused = unfused_runs[-1][2]
        model_f32 = build(dtype=torch.float32)
        unfused_f32 = model_f32(x, y, sep)
        fused_f32 = fused_forward(model_f32, x, y, sep)
        profiles = {"fused": device_profile(lambda: fused_forward(model, x, y, sep)),
                    "unfused": device_profile(lambda: model(x, y, sep))}
    expected = cfg.nlayers * (1 + REPEATS)
    err_fused_vs_f32 = max_abs(logits, unfused_f32)
    err_unfused_vs_f32 = max_abs(unfused, unfused_f32)
    budget = 2 * err_unfused_vs_f32 + 1e-3
    err_f32 = max_abs(fused_f32, unfused_f32)

    # The backward on the card: each backward kernel launched once per layer,
    # finite gradients for every parameter.
    before = dict(_ext.launch_counts)
    model.zero_grad(set_to_none=True)
    fused_forward(model, x, y, sep).sum().backward()
    bwd_launched = {k: _ext.launch_counts[k] - before[k] for k in _ext.launch_counts}
    grads_finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    model.zero_grad(set_to_none=True)

    latency = {name: {"first": runs[0][0], f"median_of_{REPEATS}": float(np.median([r[0] for r in runs[1:]]))}
               for name, runs in (("fused", fused_runs), ("unfused", unfused_runs))}
    wall = {name: {"first": runs[0][1], f"median_of_{REPEATS}": float(np.median([r[1] for r in runs[1:]]))}
            for name, runs in (("fused", fused_runs), ("unfused", unfused_runs))}
    checks = {
        "logits_shape": tuple(logits.shape) == (B, T, cfg.n_out),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "fused_vs_unfused_bf16_budget": err_fused_vs_f32 <= budget,
        "fused_vs_unfused_f32": err_f32 <= FUSED_PATH_F32_TOL,
        "launches": launched["pfn_fused_layer_fwd"] == expected,
        "no_flash_launch_on_fused_path": launched["pfn_flash_fwd"] == 0,
        "backward_launches": all(bwd_launched[k] == cfg.nlayers for k in (
            "pfn_fused_layer_fwd", "pfn_fused_layer_bwd_ffn", "pfn_fused_layer_bwd_attn")),
        "backward_no_flash_launch": all(bwd_launched[k] == 0 for k in (
            "pfn_flash_fwd", "pfn_flash_bwd_dq", "pfn_flash_bwd_dkv")),
        "backward_grads_finite": grads_finite,
    }
    emit({
        "phase": "fused_path", "card": smi, "size": size, "dtype": "bf16", "latency_ms": latency, "wall_ms": wall,
        "err_fused_bf16_vs_unfused_f32": err_fused_vs_f32, "err_unfused_bf16_vs_f32": err_unfused_vs_f32,
        "budget": budget, "err_fused_vs_unfused_bf16": max_abs(logits, unfused),
        "err_fused_f32_vs_unfused_f32": err_f32, "tol_f32": FUSED_PATH_F32_TOL, "launches": launched,
        "expected_launches": expected, "backward_launches": bwd_launched, "profiles": profiles, "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fused_path checks failed: {failed}")
    return launched["pfn_fused_layer_fwd"], latency


def phase_fused_train(device, smi: str, size: dict = FLAGSHIP, updates: int = 2, timed_updates: int = 4,
                      f32: bool = False):
    """train(...) with attention_impl="fused" at the bench.py config
    (bench.py:27-31, 73-87): epoch 1 into a checkpoint, a second call that
    resumes it and runs epoch 2; then one update fused against unfused, and
    the update times of both. In bf16 (phase fused_train), or with ``f32``
    at TrainConfig's default dtype, f32 (phase fused_f32_train: the fused
    layer's f32 bodies), where the one update is held to the unfused f32
    update alone. The one update compares loss, grad norm and the whole
    clipped gradient vector, and reports the reach of a probe of known size
    (a check that sees none fails)."""
    import io
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior
    from pfn_tpu_torch.train import (
        TrainConfig,
        TrainState,
        bar_criterion,
        build_model,
        seeded_flax_params,
        state_dict_from_flax_params,
        train,
    )
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step

    B, T = size["B"], size["T"]
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6, grid=size["grid"])
    criterion = bar_criterion(get_bucket_limits(size["buckets"], full_range=(-4.0, 4.0))).to(device)
    phase = "fused_f32_train" if f32 else "fused_train"
    cfg = TrainConfig(
        emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"], batch_size=B,
        bptt=T, lr=1e-4, warmup_epochs=1, epochs=2, steps_per_epoch=updates, attention_impl="fused",
        checkpoint_dir=tempfile.mkdtemp(prefix=f"pfn_{phase}_"), checkpoint_every=1, device=device, seed=0,
    )
    if f32 and cfg.dtype != torch.float32:
        raise AssertionError(f"TrainConfig's default dtype is {cfg.dtype}, not float32")
    if not f32:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    # Seeded random weights through the weight bridge, as phase_train starts
    # (the fresh init's zero rows: ROADMAP.md queue 3).
    init = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, size["buckets"], seed=0), cfg.nlayers)
    initial = _param_vector(init).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    first = train(prior, criterion, dataclasses.replace(cfg, epochs=1), init_params=init)
    after_epoch1 = _param_vector(first.model.state_dict())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = train(prior, criterion, cfg, init_params=init)
    train_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    launches = dict(_ext.launch_counts)
    expected = cfg.nlayers * 2 * updates
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = first.epoch_stats + result.epoch_stats
    after_epoch2 = _param_vector(result.model.state_dict())

    # One update fused and unfused (bf16), and both in f32, from the same
    # params, batch and sep (the f32 phase: the f32 pair alone): loss, grad
    # norm and the whole clipped gradient vector.
    g = torch.Generator(device=device).manual_seed(15)
    xs, ys, tys = (t[None] for t in prior.sample(B, T, generator=g, device=device))
    weights = result.model.state_dict()
    one, grads = {}, {}

    def one_update(name, over, w):
        pcfg = dataclasses.replace(cfg, eval_pos_sampler="fixed", fixed_eval_pos=size["sep"], checkpoint_dir=None,
                                   **over)
        one[name], vector = _one_update(prior, criterion, pcfg, w, (xs, ys, tys), device)
        return vector

    variants = {"fused_bf16": {}, "unfused_bf16": {"attention_impl": "auto"},
                "fused_f32": {"dtype": torch.float32},
                "unfused_f32": {"attention_impl": "auto", "dtype": torch.float32}}
    for name, over in variants.items():
        if not (f32 and name.endswith("bf16")):
            grads[name] = one_update(name, over, weights)
    keys = ("loss", "grad_norm")
    ref = grads["unfused_f32"]
    # bf16: within 2x the unfused path's own bf16 error + 1e-3, the vector's
    # relative to |unfused f32|.
    budget = {} if f32 else {
        **{key: 2 * abs(one["unfused_bf16"][key] - one["unfused_f32"][key]) + 1e-3 * abs(one["unfused_f32"][key])
           for key in keys},
        "grads": 2 * _rel_l2(grads["unfused_bf16"], ref) + 1e-3}
    diff = {} if f32 else {**{key: abs(one["fused_bf16"][key] - one["unfused_bf16"][key]) for key in keys},
                           "grads": float((grads["fused_bf16"] - grads["unfused_bf16"]).norm() / ref.norm())}
    rel_f32 = {**{key: abs(one["fused_f32"][key] - one["unfused_f32"][key]) / abs(one["unfused_f32"][key])
                  for key in keys}, "grads": _rel_l2(grads["fused_f32"], ref)}

    # The checks' reach: the unfused f32 update again with the attention
    # output scaled by 1 + scale; its relative change of the gradient vector.
    # F32_PATH_PROBE backs the f32 tolerance, FUSED_BF16_PROBE the bf16
    # budget.
    def reach(scale: float) -> float:
        probed = one_update(f"unfused_f32_probe_{scale:g}", variants["unfused_f32"],
                            _value_probe(weights, cfg.emsize, scale))
        return _rel_l2(probed, ref)

    probes = (F32_PATH_PROBE,) if f32 else (F32_PATH_PROBE, FUSED_BF16_PROBE)
    probe_reach = {scale: reach(scale) for scale in probes}
    del grads

    # Update time from the trained weights, fused and unfused in turns: the
    # first update of each, then the median of the rest.
    steps = {}
    for name, impl in (("fused", "fused"), ("unfused", "auto")):
        pcfg = dataclasses.replace(cfg, attention_impl=impl, checkpoint_dir=None)
        model = build_model(prior, criterion, pcfg)
        model.load_state_dict(result.model.state_dict())
        optimizer, _, schedule = _make_optimizer(pcfg, model)
        state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1))
        steps[name] = (make_train_step(prior, criterion, pcfg, schedule), state)
    update_ms = {name: [] for name in steps}
    for _ in range(1 + timed_updates):
        for name, (step, state) in steps.items():
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            float(step(state)["loss"])
            torch.cuda.synchronize(device)
            update_ms[name].append((time.perf_counter() - t1) * 1e3)
    step, state = steps["fused"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    no_host_sync = bool(np.isfinite(float(metrics["loss"])))
    profile = device_profile(lambda: float(step(state)["loss"]))

    fused_names = ("pfn_fused_layer_fwd", "pfn_fused_layer_bwd_ffn", "pfn_fused_layer_bwd_attn")
    checks = {
        "resumed": "resumed from" in log.getvalue(),
        "epochs": [s["epoch"] for s in stats] == [1, 2],
        "lr": [s["lr"] for s in stats] == [0.0, cfg.lr],
        "losses_finite": all(np.isfinite(s["mean_loss"]) and np.isfinite(s["grad_norm"]) for s in stats),
        "lr0_epoch_keeps_params": bool(torch.equal(after_epoch1, initial)),
        "params_changed_in_epoch2": bool((after_epoch2 != after_epoch1).any()),
        "fused_launches": all(launches[k] == expected for k in fused_names),
        "no_flash_launch": all(launches[k] == 0 for k in launches if k not in fused_names),
        "fused_vs_unfused_update": all(diff[key] <= budget[key] for key in budget),
        "fused_vs_unfused_f32": all(rel_f32[key] <= FUSED_TRAIN_F32_TOL for key in rel_f32),
        # A check that cannot see an attention error of known size is blind.
        "f32_check_sees_the_probe": probe_reach[F32_PATH_PROBE] > FUSED_TRAIN_F32_TOL,
        "update_without_host_sync": no_host_sync,
    }
    if not f32:
        checks["bf16_check_sees_the_probe"] = probe_reach[FUSED_BF16_PROBE] > budget["grads"]
    emit({
        "phase": phase, "card": smi, "size": size, "dtype": "f32" if f32 else "bf16", "updates_per_epoch": updates,
        "epoch_stats": stats, "train_calls_s": train_s, "launches": launches, "expected_launches": expected,
        "update_ms": {name: {"first": ms[0], f"median_of_{timed_updates}": float(np.median(ms[1:]))}
                      for name, ms in update_ms.items()},
        "datasets_per_s": {name: B / (float(np.median(ms[1:])) / 1e3) for name, ms in update_ms.items()},
        "peak_memory_gb": peak_gb, "one_update": one, "one_update_diff": diff, "one_update_budget": budget,
        "f32_rel_diff": rel_f32, "tol_f32": FUSED_TRAIN_F32_TOL,
        "probe_rel_change": {f"{k:g}": v for k, v in probe_reach.items()},
        "fused_update_profile": profile, "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return launches


def phase_library_timing(device, smi: str):
    """F.scaled_dot_product_attention with the boolean PFN mask at the flash
    kernels' timing shapes: the forward at B*H = 32, the backward (dq, dk, dv
    together) and forward + backward at B*H = 16; T = 2010, D = 128, bf16,
    sep = 1000; and the forward and backward with the prefix rule's mask. A
    yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    from pfn_tpu_torch.ops.attention import pfn_attention_reference, pfn_mask

    g = torch.Generator(device=device).manual_seed(8)
    T, D, sep = 2010, 128, 1000
    mask = pfn_mask(T, sep, device=device)
    q, k, v = (torch.randn(8, 4, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        err = max_abs(F.scaled_dot_product_attention(q, k, v, attn_mask=mask), pfn_attention_reference(q, k, v, sep))
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    leaves = [t[:4].detach().requires_grad_() for t in (q, k, v)]
    do = torch.randn(4, 4, T, D, generator=g, device=device).to(torch.bfloat16)
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves, attn_mask=mask),
                                                     leaves, do))
    # The prefix rule's mask (keys below sep for every query): the yardstick
    # of the prefix variants.
    prefix_mask = (torch.arange(T, device=device) < sep)[None, :].expand(T, T)
    with torch.no_grad():
        prefix_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=prefix_mask))
    out_prefix = F.scaled_dot_product_attention(*leaves, attn_mask=prefix_mask)
    prefix_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_prefix, leaves, do, retain_graph=True))
    result = {"sdpa_fwd_ms": fwd_ms, "sdpa_bwd_ms": bwd_ms, "sdpa_fwd_bwd_ms": fwd_bwd_ms,
              "sdpa_prefix_fwd_ms": prefix_fwd_ms, "sdpa_prefix_bwd_ms": prefix_bwd_ms,
              "sdpa_vs_dense_bf16_max_abs": err}
    emit({"phase": "library_timing", "card": smi, "shape": {"T": T, "D": D, "sep": sep, "dtype": "bf16",
          "fwd_BH": 32, "bwd_BH": 16}, **result})
    return result


def _kernel_launches(kernels: list) -> dict:
    """Launches of each flash f32 body in a profiler's kernel list."""
    return {name: sum(k[2] for k in kernels if frag in k[0]) for name, frag in FLASH_F32_KERNELS.items()}


def phase_tabular(device, smi: str, size: dict = TABULAR):
    """The tabular classification slice at the TabularEvalSimple scale: the
    MLP prior alone, train(...) with a checkpoint and a resume, update time
    and a device profile of one update, PFNClassifier.from_checkpoint serving
    held-out datasets, the auto path against the dense path, and
    evaluate_position_pfn with ensembles 1 and 8. At T = 100 the attention
    runs dense (the T >= 256 rule of flash_supported, as the JAX package):
    no flash kernel launches, and the dense path runs once per layer per
    forward. Returns the dense path's calls (training and serving)."""
    import io
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.evals import evaluate_position_pfn, pfn_predict
    from pfn_tpu_torch.inference import PFNClassifier
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops import attention as attention_ops
    from pfn_tpu_torch.priors import MLPPrior
    from pfn_tpu_torch.priors.hyper import UniformInt
    from pfn_tpu_torch.train import (
        TrainConfig,
        bce_criterion,
        build_model,
        seeded_flax_params,
        state_dict_from_flax_params,
        train,
    )

    F, T, B = size["num_features"], size["bptt"], size["batch_size"]
    prior = MLPPrior(num_features=F, is_binary_classification=True, is_causal=False, categorical_x=True,
                     num_features_used=UniformInt(1, F + 1))
    criterion = bce_criterion()

    # 1. The prior alone: one batch of B datasets.
    g = torch.Generator(device=device).manual_seed(0)
    x, y, _ = prior.sample(B, T, generator=g, device=device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    prior.sample(B, T, generator=g, device=device)
    torch.cuda.synchronize(device)
    prior_peak_mb = (torch.cuda.max_memory_allocated(device) - base) / 1e6
    prior_ms = cuda_ms(lambda: prior.sample(B, T, generator=g, device=device), iters=10, warmup=2)
    prior_dev_ms = device_ms(lambda: prior.sample(B, T, generator=g, device=device), calls=5)
    prior_ok = (tuple(x.shape) == (B, T, F) and bool(torch.isfinite(x).all())
                and set(y.unique().tolist()) == {0.0, 1.0})

    # 2. Training through train(...): epoch 1 into a checkpoint, then a second
    # call that resumes it. Seeded random weights, as the train phase's.
    ckdir = tempfile.mkdtemp(prefix="pfn_tabular_")
    cfg = TrainConfig(emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"],
                      bptt=T, batch_size=B, epochs=2, steps_per_epoch=size["updates"], lr=size["lr"],
                      warmup_epochs=size["warmup_epochs"], attention_impl="auto", dtype=torch.float32,
                      checkpoint_dir=ckdir, checkpoint_every=1, device=device, seed=0)
    init = state_dict_from_flax_params(seeded_flax_params(F, cfg.emsize, cfg.nhid, cfg.nlayers, 1, seed=0),
                                       cfg.nlayers)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_calls(attention_ops, "pfn_attention_reference") as dense_train:
        first = train(prior, criterion, dataclasses.replace(cfg, epochs=1), init_params=init)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            result = train(prior, criterion, cfg, init_params=init)
    train_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    train_launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    expected = cfg.nlayers * 2 * size["updates"]
    peak_train_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = first.epoch_stats + result.epoch_stats
    uninterrupted = train(prior, criterion, dataclasses.replace(cfg, checkpoint_dir=None, verbose=False),
                          init_params=init)
    resume_bitwise = all(torch.equal(a, b) for a, b in zip(uninterrupted.model.state_dict().values(),
                                                           result.model.state_dict().values()))

    # 3. Update time and a device profile of one update, from the trained
    # weights: the first update of a new optimizer state, then the median.
    step, state, update_ms, median_ms = timed_updates(prior, criterion, cfg, result.model, device,
                                                      size["timed_updates"])
    kernels, wall_ms, _ = profiled_kernels(lambda: float(step(state)["loss"]), cpu=True)
    update_dev_ms = sum(k[1] for k in kernels)
    update_flash = _kernel_launches(kernels)
    kernels.sort(key=lambda k: -k[1])
    update_profile = {"wall_ms": wall_ms, "device_ms": update_dev_ms if kernels else "not measured",
                      "idle_share": 1.0 - update_dev_ms / wall_ms if kernels else "not measured",
                      "kernels": kernels[:10], "flash_launches": update_flash}

    # 4. Serving: PFNClassifier from the checkpoint, held-out datasets from
    # another seed, 30 context rows and 70 queries each.
    clf = PFNClassifier.from_checkpoint(ckdir, prior, criterion, cfg)
    xh, yh, _ = prior.sample(size["held_out"], T, generator=torch.Generator(device=device).manual_seed(1234),
                             device=device)
    xh_np, yh_np = xh.cpu().numpy(), yh.cpu().numpy()
    n_ctx = size["n_ctx"]
    _ext.reset_launch_counts()
    runs, probs = [], []
    with counting_calls(attention_ops, "pfn_attention_reference") as dense_serve:
        for i in range(1 + REPEATS):
            clf.fit(xh_np[i % len(xh_np), :n_ctx], yh_np[i % len(xh_np), :n_ctx])
            ms, wall, p = timed_request(lambda: clf.predict_proba(xh_np[i % len(xh_np), n_ctx:]))
            runs.append((ms, wall))
            probs.append(p)
    serve_launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    request_kernels, _, _ = profiled_kernels(lambda: clf.predict_proba(xh_np[0, n_ctx:]))
    request_flash = _kernel_launches(request_kernels)
    acc = float(np.mean([(p.argmax(-1) == yh_np[i % len(xh_np), n_ctx:]).mean() for i, p in enumerate(probs)]))

    # The auto path against impl="dense": the held-out datasets' logits.
    dense = build_model(prior, criterion, dataclasses.replace(cfg, attention_impl="dense"))
    dense.load_state_dict(clf.model.state_dict())
    dense.eval()
    with torch.no_grad():
        logits = pfn_predict(clf.model, xh, yh, n_ctx)
        logits_dense = pfn_predict(dense, xh, yh, n_ctx)
    err_kernel_dense = max_abs(logits, logits_dense)

    # evaluate_position_pfn over 20 windows of one 119-row dataset.
    xw, yw, _ = prior.sample(1, T + size["windows"] - 1, generator=torch.Generator(device=device).manual_seed(77),
                             device=device)
    evals = {}
    for ensemble in size["ensembles"]:
        aucs, wprobs, _ = evaluate_position_pfn(clf.model, xw[0].cpu().numpy(), yw[0].cpu().numpy(), T, n_ctx,
                                                max_samples=size["windows"], num_features=F, ensemble=ensemble)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        evaluate_position_pfn(clf.model, xw[0].cpu().numpy(), yw[0].cpu().numpy(), T, n_ctx,
                              max_samples=size["windows"], num_features=F, ensemble=ensemble)
        evals[f"ensemble_{ensemble}"] = {"ms": (time.perf_counter() - t1) * 1e3, "windows_scored": len(aucs),
                                         "auc_mean": float(np.mean(aucs)) if len(aucs) else "no window",
                                         "probs_finite": bool(np.isfinite(wprobs).all())}

    checks = {
        "prior_batch": prior_ok,
        "resumed": "resumed from" in log.getvalue(),
        "epochs": [s["epoch"] for s in stats] == [1, 2],
        "losses_finite": all(np.isfinite(s["mean_loss"]) and np.isfinite(s["grad_norm"]) for s in stats),
        # The prior draws from the training generator alone, and no kernel
        # of the update sums with atomics: the resumed run is the same run.
        "resume_bitwise_equal": resume_bitwise,
        # T = 100 < 256: every layer of every update and request on the dense
        # path, no flash kernel.
        "train_no_flash_launch": all(n == 0 for n in train_launches.values()),
        "train_dense_path": dense_train[0] == expected,
        "update_profile_no_flash": all(n == 0 for n in update_flash.values()),
        "serve_no_flash_launch": all(n == 0 for n in serve_launches.values()),
        "serve_dense_path": dense_serve[0] == cfg.nlayers * (1 + REPEATS),
        "request_profile_no_flash": all(n == 0 for n in request_flash.values()),
        "probs": all(p.shape == (T - n_ctx, 2) and np.isfinite(p).all() and np.allclose(p.sum(-1), 1.0, atol=1e-5)
                     for p in probs),
        "kernel_vs_dense": err_kernel_dense <= TABULAR_F32_PATH_TOL,
        "evaluate_finite": all(e["probs_finite"] for e in evals.values()),
    }
    latency = {"predict_proba/first": runs[0][0], f"predict_proba/median_of_{REPEATS}":
               float(np.median([ms for ms, _ in runs[1:]])), "predict_proba_wall/first": runs[0][1],
               f"predict_proba_wall/median_of_{REPEATS}": float(np.median([w for _, w in runs[1:]]))}
    emit({
        "phase": "tabular", "card": smi, "size": size, "dtype": "f32",
        "prior": {"ms": prior_ms, "device_ms": prior_dev_ms, "peak_mb": prior_peak_mb},
        "epoch_stats": stats, "train_calls_s": train_s, "launches": train_launches,
        "dense_calls": {"train": dense_train[0], "serve": dense_serve[0]}, "expected_dense_train_calls": expected,
        "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
        "datasets_per_s": B / (median_ms / 1e3), "peak_memory_gb": peak_train_gb,
        "prior_share_of_update_device_time": (prior_dev_ms / update_dev_ms
                                              if kernels and prior_dev_ms != "not measured" else "not measured"),
        "update_profile": update_profile, "serve_launches": serve_launches, "request_flash": request_flash,
        "latency_ms": latency, "held_out_accuracy": acc, "err_kernel_vs_dense": err_kernel_dense,
        "tol_kernel_vs_dense": TABULAR_F32_PATH_TOL, "evaluate_position_pfn": evals, "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tabular checks failed: {failed}")
    return {"train": dense_train[0], "serve": dense_serve[0]}


def f32_kernel_timing(device, smi: str, phase: str, shape: dict):
    """The f32 bodies of the flash kernels, each against its plain version,
    its f32 bound and SDPA with the boolean PFN mask (forward; backward with
    dq, dk and dv together): the forward at B*H = shape["fwd_BH"], the
    backward at shape["bwd_BH"] (the leading rows of the same inputs); then
    the prefix variant (include_diag=False, a nonzero dlse) against SDPA with
    the prefix rule's mask. Repeat calls of each body are bitwise equal in
    both variants. The phases tabular_kernel_timing (TABULAR_KERNEL_SHAPE,
    where the tabular path ran them before the T >= 256 rule) and
    f32_long_timing (F32_LONG_SHAPE: the f32 path's attention shape)."""
    import torch
    import torch.nn.functional as F

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.attention import pfn_mask
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd, _flash_fwd_plain

    T, D, sep = shape["T"], shape["D"], shape["sep"]
    H = 4
    g = torch.Generator(device=device).manual_seed(9)
    BH = max(shape["fwd_BH"], shape["bwd_BH"])
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=device) for _ in range(4))
    dlse_all = torch.randn(BH, T, generator=g, device=device)
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
    masks = {True: pfn_mask(T, sep, device=device),
             False: (torch.arange(T, device=device) < sep)[None, :].expand(T, T)}

    rows, sdpa_errs = {}, {}
    for include_diag in (True, False):
        mask, tag = masks[include_diag], "" if include_diag else "_prefix"
        where = f"{phase}, {'diag' if include_diag else 'prefix'}"
        # The forward at fwd_BH.
        n = shape["fwd_BH"]
        qs, kn, vn = q[:n] * D**-0.5, k[:n], v[:n]
        o, lse = _flash_fwd(qs, kn, vn, sep_t, include_diag)
        o_plain, lse_plain = _flash_fwd_plain(qs, kn, vn, sep, T, include_diag)
        errs = {"fwd": max(max_abs(o, o_plain), max_abs(lse, lse_plain))}
        if not (torch.allclose(o, o_plain, atol=F32_TOL, rtol=F32_TOL)
                and torch.allclose(lse, lse_plain, atol=F32_TOL, rtol=F32_TOL)):
            raise AssertionError(f"{where}: the f32 forward disagrees with its plain version: {errs}")
        o2, lse2 = _flash_fwd(qs, kn, vn, sep_t, include_diag)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{where}: a repeat f32 forward call differs")
        q4, k4, v4 = (t[:n].reshape(n // H, H, T, D) for t in (q, k, v))
        with torch.no_grad():
            sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask).reshape(n, T, D)
            # SDPA gives a row with no allowed key NaN; the kernel gives 0.
            sdpa_errs["fwd" + tag] = max_abs(torch.nan_to_num(sdpa), o)
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask))
        times = {"fwd": (n, cuda_ms(lambda: _flash_fwd(qs, kn, vn, sep_t, include_diag)),
                         cuda_ms(lambda: _flash_fwd_plain(qs, kn, vn, sep_t, T, include_diag)), sdpa_fwd_ms)}

        # The backward at bwd_BH.
        n = shape["bwd_BH"]
        qs, kn, vn, don = q[:n] * D**-0.5, k[:n], v[:n], do[:n]
        dlse = None if include_diag else dlse_all[:n]
        o, lse = _flash_fwd(qs, kn, vn, sep_t, include_diag)
        delta = (don * o).sum(-1) - (0.0 if dlse is None else dlse)
        dq, dk, dv = _repeat_bitwise(qs, kn, vn, don, lse, delta, sep_t, include_diag, where)
        plain = _flash_bwd_plain(qs, kn, vn, o, lse, don, dlse, sep_t, T, include_diag)
        errs.update({"dq": max_abs(dq, plain[0]), "dkv": max(max_abs(dk, plain[1]), max_abs(dv, plain[2]))})
        if not all(torch.allclose(a, b, atol=F32_GRAD_TOL, rtol=F32_GRAD_TOL) for a, b in zip((dq, dk, dv), plain)):
            raise AssertionError(f"{where}: the f32 backward kernels disagree with their plain version: {errs}")
        leaves = [t[:n].reshape(n // H, H, T, D).detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do[:n].reshape(n // H, H, T, D),
                                                          retain_graph=True))
        bwd_plain_ms = cuda_ms(lambda: _flash_bwd_plain(qs, kn, vn, o, lse, don, dlse, sep_t, T, include_diag))
        times["dq"] = (n, cuda_ms(lambda: _ext.flash_bwd_dq(qs, kn, vn, don, lse, delta, sep_t, include_diag)),
                       bwd_plain_ms, sdpa_bwd_ms)
        times["dkv"] = (n, cuda_ms(lambda: _ext.flash_bwd_dkv(qs, kn, vn, don, lse, delta, sep_t, include_diag)),
                        bwd_plain_ms, sdpa_bwd_ms)

        for kind, (n, ms, plain_ms, lib_ms) in times.items():
            b = flash_bound(kind, n, T, D, sep, include_diag, dtype="f32")
            rows[kind + tag] = {"BH": n, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                "max_abs_err": errs[kind], **b, "pct_of_bound": 100.0 * b["bound_ms"] / ms,
                                "gflop": flash_flops(kind, n, T, D, sep, include_diag) / 1e9}
    emit({"phase": phase, "card": smi, "shape": {**shape, "dtype": "f32", "H": H}, "rows": rows,
          "against_library": {f"{kind}{tag}": rows[f"{kind}{tag}"]["ms"] / rows[f"{kind}{tag}"]["library_ms"]
                              for kind in ("fwd", "dq", "dkv") for tag in ("", "_prefix")}
          | {f"dq_plus_dkv{tag}": (rows[f"dq{tag}"]["ms"] + rows[f"dkv{tag}"]["ms"]) / rows[f"dq{tag}"]["library_ms"]
             for tag in ("", "_prefix")},
          "sdpa_vs_kernel_max_abs": sdpa_errs, "repeat_bitwise_equal": True,
          "plain_note": "the bwd plain time is dq, dk and dv together",
          "library_note": "SDPA in f32 with the boolean PFN mask (_prefix: the prefix rule's mask); its backward "
                          "computes dq, dk and dv together"})
    return rows


def _value_probe(weights: dict, emsize: int, scale: float) -> dict:
    """A copy of a state_dict with every layer's value rows of in_proj
    (weight and bias) scaled by 1 + scale: the attention output scaled by as
    much."""
    probe = {key: t.clone() for key, t in weights.items()}
    for key, t in probe.items():
        if key.endswith(("self_attn.in_proj_weight", "self_attn.in_proj_bias")):
            t[2 * emsize:] *= 1 + scale
    return probe


def _grad_vector(model):
    """Every parameter's .grad after an update (clipped, as applied), as one
    vector."""
    import torch

    return torch.cat([p.grad.flatten() for p in model.parameters()])


def _rel_l2(a, b) -> float:
    """|a - b| / |b| in the L2 norm."""
    return float((a - b).norm() / b.norm())


def _two_microbatches(prior, cfg, device):
    """Two microbatches of ``cfg.batch_size`` datasets of ``cfg.bptt`` from a
    generator seeded with 5, stacked: (xs, ys, target ys)."""
    import torch

    g = torch.Generator(device=device).manual_seed(5)
    batch = [prior.sample(cfg.batch_size, cfg.bptt, generator=g, device=device) for _ in range(2)]
    return tuple(torch.stack([b[i] for b in batch]) for i in range(3))


def _one_update(prior, criterion, pcfg, weights: dict, batch, device):
    """One update of a new model of ``pcfg`` from ``weights`` on ``batch``
    (xs, ys, target ys; a leading microbatch axis): ({loss, grad_norm}, the
    clipped gradient vector)."""
    import torch

    from pfn_tpu_torch.train import TrainState, build_model
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step_from_batch

    model = build_model(prior, criterion, pcfg)
    model.load_state_dict(weights)
    optimizer, _, schedule = _make_optimizer(pcfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(0))
    m = make_train_step_from_batch(criterion, pcfg, schedule)(state, *batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}, _grad_vector(model)


def one_update_vs_dense(prior, criterion, cfg, weights: dict, device):
    """One update of ``cfg`` from ``weights`` through the flash f32 kernels
    (attention_impl "auto", T >= 256) and through the dense f32 path, on the
    same 2 microbatches of a seeded batch at sep T // 2. Returns ({path:
    loss, grad norm, flash launches}; the relative difference of the loss,
    the grad norm and the whole clipped gradient vector (L2); whether each
    microbatch went through the kernels once per layer and the dense path
    through none; the relative change of the same three on the dense path
    when the attention output is scaled by 1 + F32_PATH_PROBE, which says
    how large an error of the attention the comparison would see)."""
    from pfn_tpu_torch.ops import _ext

    batch = _two_microbatches(prior, cfg, device)
    probe = _value_probe(weights, cfg.emsize, F32_PATH_PROBE)
    one, grads = {}, {}
    for name, impl, w in (("kernel_f32", "auto", weights), ("dense_f32", "dense", weights),
                          ("dense_f32_probe", "dense", probe)):
        pcfg = dataclasses.replace(cfg, aggregate_k_gradients=2, steps_per_epoch=2, eval_pos_sampler="fixed",
                                   fixed_eval_pos=cfg.bptt // 2, attention_impl=impl)
        _ext.reset_launch_counts()
        one[name], grads[name] = _one_update(prior, criterion, pcfg, w, batch, device)
        one[name]["launches"] = {k: _ext.launch_counts[k] for k in FLASH_F32_KERNELS}

    def rel_to_dense(other: str) -> dict:
        ref = one["dense_f32"]
        return {"loss": abs(one[other]["loss"] - ref["loss"]) / abs(ref["loss"]),
                "grad_norm": abs(one[other]["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]),
                "grads": _rel_l2(grads[other], grads["dense_f32"])}

    rel, reach = rel_to_dense("kernel_f32"), rel_to_dense("dense_f32_probe")
    paths = (all(n == 2 * cfg.nlayers for n in one["kernel_f32"]["launches"].values())
             and not any(one["dense_f32"]["launches"].values()))
    return one, rel, paths, reach


def phase_f32_path(device, smi: str, size: dict = F32_PATH):
    """The flash kernels' f32 bodies on a path a user runs: train(...) at the
    Fig-3a width in f32 (F32_PATH) for 2 epochs of 2 updates, then
    PFNRegressor serving held-out datasets at context 1000. Every f32 body
    must launch on it, once per layer per microbatch (dq, dk/dv) and once per
    layer per forward (the forward); one update on the kernel path against
    the dense f32 path; update time, datasets/s and the idle share of one
    profiled update. Returns the launches of each kernel."""
    import numpy as np
    import torch

    from pfn_tpu_torch.experiments.common import GP_HP, bucket_criterion
    from pfn_tpu_torch.inference import PFNRegressor
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior
    from pfn_tpu_torch.train import TrainConfig, seeded_flax_params, state_dict_from_flax_params, train

    T, k, B = size["T"], size["agg"], size["batch_size"]
    prior = GPPrior(num_features=1, **GP_HP)
    criterion = bucket_criterion(prior, size["buckets"], T, device)
    cfg = TrainConfig(emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"],
                      bptt=T, batch_size=B, aggregate_k_gradients=k, epochs=2, steps_per_epoch=size["updates"] * k,
                      lr=size["lr"], warmup_epochs=size["warmup_epochs"], eval_pos_sampler="weighted",
                      eval_pos_max=min(2000, T), device=device, seed=0)
    if cfg.dtype != torch.float32:
        raise AssertionError(f"TrainConfig's default dtype is {cfg.dtype}, not float32")
    # Seeded random weights through the weight bridge (nonzero out_proj and
    # linear2), as the train phase starts.
    init = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, size["buckets"], seed=0), cfg.nlayers)
    names = list(FLASH_F32_KERNELS)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    result, _ = _quietly(lambda: train(prior, criterion, cfg, init_params=init))
    train_s = time.perf_counter() - t0
    train_launches = {name: _ext.launch_counts[name] for name in names}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    # Serving: held-out datasets, 1000 context points and 1010 queries each.
    x, y, _ = prior.sample(size["datasets"], T, generator=torch.Generator(device=device).manual_seed(17),
                           device=device)
    x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
    regressor = PFNRegressor.from_train_result(result)
    n_ctx = size["n_ctx"]
    _ext.reset_launch_counts()
    served, serve_ms = [], []
    for i in range(size["datasets"]):
        regressor.fit(x_np[i, :n_ctx], y_np[i, :n_ctx])
        ms, _, out = timed_request(lambda: regressor.predict(x_np[i, n_ctx:], return_std=True))
        served.append(out)
        serve_ms.append(ms)
    serve_launches = {name: _ext.launch_counts[name] for name in names}
    launches = {name: train_launches[name] + serve_launches[name] for name in names}

    # One update on the kernel path and on the dense f32 path, from the
    # trained weights.
    one, rel, one_paths, reach = one_update_vs_dense(prior, criterion, cfg, result.model.state_dict(), device)

    # Update time from the trained weights: the first update of a new
    # optimizer state, then the median of the rest; a profile of one more.
    step, state, update_ms, median_ms = timed_updates(prior, criterion, cfg, result.model, device,
                                                      size["timed_updates"])
    kernels, wall_ms, _ = profiled_kernels(lambda: float(step(state)["loss"]), cpu=True)
    update_dev_ms = sum(kn[1] for kn in kernels)
    profiled = _kernel_launches(kernels)
    kernels.sort(key=lambda kn: -kn[1])
    profile = {"wall_ms": wall_ms, "device_ms": update_dev_ms if kernels else "not measured",
               "idle_share": 1.0 - update_dev_ms / wall_ms if kernels else "not measured",
               "kernels": kernels[:10], "flash_f32_launches": profiled}

    per_update = cfg.nlayers * k
    expected = {"pfn_flash_fwd": 2 * size["updates"] * per_update + cfg.nlayers * size["datasets"],
                "pfn_flash_bwd_dq": 2 * size["updates"] * per_update,
                "pfn_flash_bwd_dkv": 2 * size["updates"] * per_update}
    stats = result.epoch_stats
    checks = {
        "epochs": [st["epoch"] for st in stats] == [1, 2],
        "losses_finite": all(np.isfinite(st["mean_loss"]) and np.isfinite(st["grad_norm"]) for st in stats),
        "launches": launches == expected,
        "every_f32_body_launched": all(n > 0 for n in launches.values()),
        # Where the profiler saw kernels, the f32 bodies are among them.
        "profile_f32_bodies": not kernels or all(n == per_update for n in profiled.values()),
        "predict_finite": all(np.isfinite(mu).all() and np.isfinite(sd).all() and (sd > 0).all()
                              for mu, sd in served),
        "kernel_vs_dense_f32_update": all(r <= F32_PATH_TOL for r in rel.values()),
        "one_update_paths": one_paths,
    }
    emit({
        "phase": "f32_path", "card": smi, "size": size, "dtype": "f32", "epoch_stats": stats,
        "train_s": train_s, "launches": launches, "expected_launches": expected, "train_launches": train_launches,
        "serve_launches": serve_launches,
        "serve_ms": {"first": serve_ms[0], f"median_of_{len(serve_ms) - 1}": float(np.median(serve_ms[1:]))},
        "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
        "datasets_per_s": B * k / (median_ms / 1e3), "peak_memory_gb": peak_gb, "one_update": one,
        "one_update_rel_diff": rel, "tol": F32_PATH_TOL, "probe": F32_PATH_PROBE, "probe_rel_change": reach,
        "update_profile": profile, "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"f32_path checks failed: {failed}")
    return launches


def _front_door_run(argv: list, device):
    """cli.main(argv) with its printing kept: (result, seconds, peak GB, the
    flash launches of the run, the printed text)."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.train import cli

    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    result, text = _quietly(cli.main, argv)
    seconds = time.perf_counter() - t0
    launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    return result, seconds, torch.cuda.max_memory_allocated(device) / 1e9, launches, text


def _front_door_prior(argv: list):
    """The prior that cli.main builds from ``argv`` (cheap to build again;
    the criterion, which may estimate its buckets, comes from the run's
    TrainResult)."""
    from pfn_tpu_torch import registries
    from pfn_tpu_torch.train import cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    return registries.PRIORS.get(cfg.prior.name)(**cfg.prior.kwargs)


def phase_front_door(device, smi: str):
    """The front door on the card: python -m pfn_tpu_torch.train's main,
    in process, at the Fig-3a width (FRONT_DOOR). (a) the README's
    quick-start command, saved with --checkpoint and warm-started with
    --warm_start: the f32 flash bodies launch at least once per layer per
    update, the losses are finite, the warm start (one epoch, warmup epoch 0
    at LR 0) ends on the saved weights bitwise; one update of its config
    from seeded bridge weights (nonzero out_proj and linear2, so attention
    reaches the loss) through the kernels against the dense f32 path within
    F32_PATH_TOL. (b) the model options: the kernels launch, the losses are
    finite, a run stopped after epoch 1 and resumed equals the
    uninterrupted one bitwise (the dropout masks come from the training
    generator). (c) the stroke prior: finite losses, the prior's device
    time. Each run's median update time, datasets/s and peak memory.
    Returns run (a)'s flash launches."""
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.train import restore_checkpoint, seeded_flax_params, state_dict_from_flax_params

    tmp = Path(tempfile.mkdtemp(prefix="pfn_front_door_"))
    runs, checks = {}, {}

    def finite(result):
        return all(np.isfinite(st["mean_loss"]) and np.isfinite(st["grad_norm"]) for st in result.epoch_stats)

    def same_weights(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    def record(name, argv, result, sec, peak, launches, **more):
        prior = _front_door_prior(argv)
        _, _, update_ms, median_ms = timed_updates(prior, result.criterion, result.config, result.model, device,
                                                   FRONT_DOOR_TIMED_UPDATES)
        cfg = result.config
        runs[name] = {"argv": argv, "seconds": sec, "peak_memory_gb": peak, "launches": launches,
                      "epoch_stats": result.epoch_stats, **more,
                      "update_ms": {"first": update_ms[0], f"median_of_{FRONT_DOOR_TIMED_UPDATES}": median_ms},
                      "datasets_per_s": cfg.batch_size * cfg.aggregate_k_gradients / (median_ms / 1e3)}
        return prior

    # (a) The quick start, saved, then warm-started.
    argv_a = FRONT_DOOR["quickstart"] + FRONT_DOOR_WIDTH
    ckpt = str(tmp / "quickstart")
    res_a, sec, peak, launches_a, _ = _front_door_run(argv_a + ["--checkpoint", ckpt], device)
    cfg_a = res_a.config
    updates_a = cfg_a.epochs * cfg_a.steps_per_epoch // cfg_a.aggregate_k_gradients
    saved = restore_checkpoint(ckpt, map_location="cpu")
    res_w, sec_w, _, _, text_w = _front_door_run(argv_a + ["--warm_start", ckpt, "--epochs", "1"], device)
    checks.update({
        "quickstart_losses_finite": finite(res_a) and finite(res_w),
        "quickstart_flash_every_layer_every_update": all(n >= cfg_a.nlayers * updates_a
                                                         for n in launches_a.values()),
        "quickstart_saved_is_the_model": same_weights(saved, res_a.model.state_dict()),
        # At LR 0 the run ends where it starts: on the loaded weights.
        "warm_start_at_lr_0_ends_on_the_saved_weights": (res_w.epoch_stats[0]["lr"] == 0.0
                                                         and same_weights(res_w.model.state_dict(), saved)),
        "warm_start_printed": "warm-started params from" in text_w,
    })
    prior_a = record("quickstart", argv_a, res_a, sec, peak, launches_a, warm_start_seconds=sec_w)

    # One update of (a)'s config through the kernels and through the dense
    # f32 path, from seeded bridge weights: the run's own weights are barely
    # past a zero-initialised out_proj and linear2, through which attention
    # would hardly reach the loss or the gradient norm.
    seeded = state_dict_from_flax_params(
        seeded_flax_params(prior_a.num_features, cfg_a.emsize, cfg_a.nhid, cfg_a.nlayers,
                           res_a.criterion.n_out(prior_a.num_outputs), seed=0), cfg_a.nlayers)
    one, rel, one_paths, reach = one_update_vs_dense(prior_a, res_a.criterion, cfg_a, seeded, device)
    checks["quickstart_kernel_vs_dense_f32_update"] = all(r <= F32_PATH_TOL for r in rel.values())
    checks["one_update_paths"] = one_paths

    # (b) The model options: straight, then stopped after epoch 1 and resumed.
    argv_b = FRONT_DOOR["options"] + FRONT_DOOR_WIDTH
    res_b, sec, peak, launches_b, _ = _front_door_run(argv_b, device)
    resumable = argv_b + ["--set", f"train.checkpoint_dir={tmp / 'options'}", "--set", "train.checkpoint_every=1"]
    _front_door_run(resumable + ["--epochs", "1"], device)
    res_r, _, _, _, text_r = _front_door_run(resumable, device)
    checks.update({
        "options_losses_finite": finite(res_b) and finite(res_r),
        "options_flash_launched": all(n > 0 for n in launches_b.values()),
        "options_resumed": "resumed from" in text_r and [st["epoch"] for st in res_r.epoch_stats] == [2],
        "options_resume_bitwise": (res_r.final_loss == res_b.final_loss
                                   and same_weights(res_r.model.state_dict(), res_b.model.state_dict())),
    })
    record("options", argv_b, res_b, sec, peak, launches_b)

    # (c) The stroke prior, and its device time for one batch.
    argv_c = FRONT_DOOR["stroke"] + FRONT_DOOR_WIDTH
    res_c, sec, peak, launches_c, _ = _front_door_run(argv_c, device)
    checks["stroke_losses_finite"] = finite(res_c)
    stroke = record("stroke", argv_c, res_c, sec, peak, launches_c)
    gs = torch.Generator(device=device).manual_seed(2)
    runs["stroke"]["prior_ms"] = cuda_ms(lambda: stroke.sample(res_c.config.batch_size, res_c.config.bptt,
                                                               generator=gs, device=device), iters=10)

    emit({"phase": "front_door", "card": smi, "dtype": "f32", "runs": runs, "one_update": one,
          "one_update_weights": "seeded_flax_params(seed=0) through state_dict_from_flax_params",
          "one_update_rel_diff": rel, "tol": F32_PATH_TOL, "probe": F32_PATH_PROBE, "probe_rel_change": reach,
          "checks": checks})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"front_door checks failed: {failed}")
    return launches_a


def phase_comparison(device, smi: str, size: dict = COMPARISON):
    """The Bayesian comparison (the PFN against SVI and HMC) at the reference
    config of its driver (COMPARISON): the PFN trained through train(...)
    for 2 epochs of 2 updates with a checkpoint and a resume bitwise equal to
    an uninterrupted run, the flash f32 bodies at D 64 once per layer per
    update; update time and a profile of one update; one update through the
    kernels against the dense f32 path (F32_PATH_TOL, its reach at
    F32_PATH_PROBE); the fixed eval set of 100 datasets; eval_transformer
    (the forward kernel once per layer) against the dense path within the
    f32 rule 2e-5 x (1 + max); eval_svi and eval_mcmc at the driver's
    non-quick settings, batched over the datasets on the card, each timed on
    the host clock up to a sync; the idle share of 8 SVI steps and of 2 HMC
    trajectories (both loops launch-bound). Returns the flash launches of
    the path (training and the eval's forward)."""
    import argparse
    import io
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.evals import comparison
    from pfn_tpu_torch.experiments import bayesian_models_custom_priors as driver
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.train import bce_criterion, build_model, seeded_flax_params, state_dict_from_flax_params, train

    spec = comparison.default_model_spec(size["size"])
    prior, criterion = spec.as_prior(), bce_criterion()
    args = argparse.Namespace(quick=False, bptt=None, epochs=None, training_samples=size["n_train"])
    ref_cfg, n_train, _ = driver.train_config(args, device)
    cfg = dataclasses.replace(ref_cfg, epochs=2, steps_per_epoch=size["updates"], seed=0, checkpoint_every=1,
                              checkpoint_dir=tempfile.mkdtemp(prefix="pfn_comparison_"))
    if cfg.dtype != torch.float32 or cfg.bptt != 300 or cfg.emsize // cfg.nhead != 64:
        raise AssertionError(f"the reference config is not f32 at T 300 and head dim 64: {cfg}")
    init = state_dict_from_flax_params(seeded_flax_params(spec.num_features, cfg.emsize, cfg.nhid, cfg.nlayers, 1,
                                                          seed=0), cfg.nlayers)

    # 1. Training: epoch 1 into a checkpoint, then a resumed call for epoch 2.
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    first = train(prior, criterion, dataclasses.replace(cfg, epochs=1), init_params=init)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = train(prior, criterion, cfg, init_params=init)
    train_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    train_launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = first.epoch_stats + result.epoch_stats

    # 2. The eval set and the amortized eval on the kernel path.
    X, y = comparison.generate_toy_data(spec, cfg.bptt, torch.Generator(device=device).manual_seed(0),
                                        n_samples=size["eval_sets"])
    _ext.reset_launch_counts()
    pfn_acc, pfn_nll, pfn_s = comparison.eval_transformer(X, y, result.model, n_train)
    eval_launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    launches = {name: train_launches[name] + eval_launches[name] for name in FLASH_F32_KERNELS}

    uninterrupted = train(prior, criterion, dataclasses.replace(cfg, checkpoint_dir=None, verbose=False),
                          init_params=init)
    resume_bitwise = all(torch.equal(a, b) for a, b in zip(uninterrupted.model.state_dict().values(),
                                                           result.model.state_dict().values()))
    step, state, update_ms, median_ms = timed_updates(prior, criterion, cfg, result.model, device,
                                                      size["timed_updates"])
    kernels, wall_ms, busy_ms = profiled_kernels(lambda: float(step(state)["loss"]), cpu=True)
    profiled = _kernel_launches(kernels)
    kernels.sort(key=lambda kn: -kn[1])
    update_profile = {"wall_ms": wall_ms, "device_ms": busy_ms if kernels else "not measured",
                      "idle_share": 1.0 - busy_ms / wall_ms if kernels else "not measured",
                      "kernels": kernels[:10], "flash_f32_launches": profiled}

    # 3. One update through the kernels against the dense f32 path.
    one, rel, one_paths, reach = one_update_vs_dense(prior, criterion, cfg, init, device)

    # 4. The eval's probabilities, kernel path against dense, and its time.
    dense = build_model(prior, criterion, dataclasses.replace(cfg, attention_impl="dense"))
    dense.load_state_dict(result.model.state_dict())
    dense.eval()
    probs, _ = comparison.transformer_probs(X, y, result.model, n_train)
    probs_dense, _ = comparison.transformer_probs(X, y, dense, n_train)
    err_probs = max_abs(probs, probs_dense)
    tol_probs = F32_TOL * (1 + float(probs_dense.abs().max()))
    eval_ms = cuda_ms(lambda: comparison.transformer_probs(X, y, result.model, n_train), iters=10)

    # 5. The fits, batched over the datasets on the card.
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    svi_nll, svi_acc = comparison.eval_svi(X, y, spec, n_train, size["svi_steps"], size["svi_steps"])
    torch.cuda.synchronize(device)
    svi_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    mcmc_nll, mcmc_acc, accept = comparison._mcmc_scores(X, y, spec, n_train, size["mcmc_steps"],
                                                          size["mcmc_steps"])
    torch.cuda.synchronize(device)
    mcmc_s = time.perf_counter() - t1
    idle = {"svi_8_steps": device_profile(lambda: comparison.eval_svi(X, y, spec, n_train, 8, 8)),
            "hmc_2_trajectories": device_profile(lambda: comparison._mcmc_scores(X, y, spec, n_train, 1, 1))}

    methods = {
        "transformer": {"acc": float(np.mean(pfn_acc)), "nll": float(np.mean(pfn_nll)), "seconds": pfn_s,
                        "eval_ms": eval_ms},
        "svi": {"acc": float(np.mean(svi_acc)), "nll": float(np.mean(svi_nll)), "seconds": svi_s,
                "steps": size["svi_steps"]},
        "mcmc": {"acc": float(np.mean(mcmc_acc)), "nll": float(np.mean(mcmc_nll)), "seconds": mcmc_s,
                 "steps": size["mcmc_steps"], "accept_rate": float(np.mean(accept))},
    }
    updates = 2 * size["updates"]
    checks = {
        "resumed": "resumed from" in log.getvalue(),
        "epochs": [st["epoch"] for st in stats] == [1, 2],
        "losses_finite": all(np.isfinite(st["mean_loss"]) and np.isfinite(st["grad_norm"]) for st in stats),
        "resume_bitwise_equal": resume_bitwise,
        # T 300 >= 256: every f32 body once per layer per update, the forward
        # once per layer in the eval.
        "train_launches": all(n == cfg.nlayers * updates for n in train_launches.values()),
        "eval_launches": eval_launches == {"pfn_flash_fwd": cfg.nlayers, "pfn_flash_bwd_dq": 0,
                                           "pfn_flash_bwd_dkv": 0},
        "profile_f32_bodies": not kernels or all(n == cfg.nlayers for n in profiled.values()),
        "kernel_vs_dense_f32_update": all(r <= F32_PATH_TOL for r in rel.values()),
        "one_update_paths": one_paths,
        "update_check_sees_the_probe": reach["grads"] > F32_PATH_TOL,
        "eval_probs_kernel_vs_dense": err_probs <= tol_probs,
        "pfn_finite": bool(np.isfinite(pfn_acc).all() and np.isfinite(pfn_nll).all()),
        "fits_finite": bool(np.isfinite(np.concatenate([svi_nll, svi_acc, mcmc_nll, mcmc_acc, accept])).all()),
        "svi_above_chance": methods["svi"]["acc"] > 0.5,
        "mcmc_above_chance": methods["mcmc"]["acc"] > 0.5,
    }
    emit({
        "phase": "comparison", "card": smi, "size": size, "dtype": "f32",
        "config": {k: getattr(cfg, k) for k in ("emsize", "nhid", "nlayers", "nhead", "bptt", "batch_size", "lr")},
        "epoch_stats": stats, "train_calls_s": train_s, "launches": launches, "train_launches": train_launches,
        "eval_launches": eval_launches, "peak_memory_gb": peak_gb,
        "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
        "datasets_per_s": cfg.batch_size / (median_ms / 1e3), "update_profile": update_profile,
        "one_update": one, "one_update_rel_diff": rel, "tol": F32_PATH_TOL, "probe": F32_PATH_PROBE,
        "probe_rel_change": reach, "eval_probs_max_abs": err_probs, "eval_probs_tol": tol_probs,
        "methods": methods, "loop_profiles": idle, "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"comparison checks failed: {failed}")
    return launches


def phase_tabular_baselines(device, smi: str, size: dict = TABULAR_BASELINES):
    """The tabular baselines on the card's machine, which has no sklearn:
    bayes_net_metric (the BNN fitted by SVI, on the card) through
    evaluate(...) over one synthetic dataset (TABULAR_BASELINES, numpy from a
    seed): seconds per window and the AUC. The sklearn baselines raise an
    ImportError naming sklearn when called, and the module imported without
    it (where sklearn is present, they score the window instead)."""
    import functools
    import importlib.util

    import numpy as np

    from pfn_tpu_torch.evals import tabular

    rng = np.random.default_rng(0)
    X = rng.standard_normal((size["rows"], size["features"])).astype(np.float32)
    y = (X @ rng.standard_normal(size["features"]) + 0.5 * rng.standard_normal(size["rows"]) > 0).astype(np.float32)
    t0 = time.perf_counter()
    res = tabular.evaluate([("synthetic", X, y, [])], functools.partial(tabular.bayes_net_metric, device=device),
                           "bayes_net", size["bptt"], [size["eval_position"]], max_samples=size["windows"])
    seconds = time.perf_counter() - t0
    windows = res[f"synthetic_num_windows_at_{size['eval_position']}"]

    wx, wy = tabular.build_windows(X, y, size["bptt"], 1)
    args = (wx[0, :size["eval_position"]], wy[0, :size["eval_position"]], wx[0, size["eval_position"]:],
            wy[0, size["eval_position"]:], [])
    sklearn_present = importlib.util.find_spec("sklearn") is not None
    others = {}
    for name in ("logistic", "knn", "gp", "hgb", "xgb", "catboost"):
        try:
            others[name] = {"auc": float(tabular.BASELINES[name](*args)[0])}
        except ImportError as e:
            others[name] = {"import_error": str(e)}
    checks = {
        "windows_scored": windows == size["windows"],
        "auc_finite": bool(np.isfinite(res["mean_metric"])),
        "sklearn_baselines": all(("auc" in others[n]) if sklearn_present
                                 else ("sklearn" in others[n].get("import_error", ""))
                                 for n in ("logistic", "knn", "gp", "hgb")),
    }
    emit({"phase": "tabular_baselines", "card": smi, "size": size, "seconds": seconds,
          "seconds_per_window": res["synthetic_time"] / max(windows, 1), "auc": res["mean_metric"],
          "per_window_auc": res[f"synthetic_per_ds_metric_at_{size['eval_position']}"].tolist(),
          "sklearn_present": sklearn_present, "other_baselines": others, "checks": checks})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tabular_baselines checks failed: {failed}")
    return res


def phase_dispatch(device, smi: str):
    """impl="dense" against impl="flash" at T 100 and 256, forward and
    forward + backward, in bf16 at the bench.py flagship (B 64, H 4, D 128,
    sep 50) and in f32 at the tabular shape (B*H 1024, D 128, sep 30): which
    way each goes. Then the auto rule on the card: dense at T 100 and 255,
    the kernels at T 256 and 2010 (flash_supported's T >= 256)."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.attention import pfn_attention
    from pfn_tpu_torch.ops.flash_attention import FLASH_MIN_SEQ

    g = torch.Generator(device=device).manual_seed(21)
    rows = []
    for name, dtype, (B, H, D, sep) in (("bf16_flagship", torch.bfloat16, DISPATCH_SHAPES["bf16_flagship"]),
                                        ("f32_tabular", torch.float32, DISPATCH_SHAPES["f32_tabular"])):
        for T in DISPATCH_SEQS:
            q, k, v, do = (torch.randn(B, H, T, D, generator=g, device=device).to(dtype) for _ in range(4))
            row = {"shape": name, "dtype": str(dtype).removeprefix("torch."), "B": B, "H": H, "T": T, "D": D,
                   "sep": sep}
            with torch.no_grad():
                outs = {impl: pfn_attention(q, k, v, sep, impl=impl) for impl in ("dense", "flash")}
                for impl in ("dense", "flash"):
                    row[f"{impl}_fwd_ms"] = cuda_ms(lambda: pfn_attention(q, k, v, sep, impl=impl))
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            for impl in ("dense", "flash"):
                row[f"{impl}_fwd_bwd_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(pfn_attention(*leaves, sep, impl=impl), leaves, do))
            gold = pfn_attention(q.float(), k.float(), v.float(), sep, impl="dense")
            row["flash_vs_dense_max_abs"] = max_abs(outs["flash"], outs["dense"])
            budget = F32_TOL * (1 + float(gold.abs().max())) if dtype == torch.float32 else (
                2 * max_abs(outs["dense"], gold) + 1e-3)
            if max_abs(outs["flash"], gold) > budget:
                raise AssertionError(f"dispatch: flash {name} T {T} error {max_abs(outs['flash'], gold)} over {budget}")
            row["faster_fwd"] = "flash" if row["flash_fwd_ms"] < row["dense_fwd_ms"] else "dense"
            row["faster_fwd_bwd"] = "flash" if row["flash_fwd_bwd_ms"] < row["dense_fwd_bwd_ms"] else "dense"
            rows.append(row)
    auto = {}
    for T in DISPATCH_AUTO_SEQS:
        q = torch.randn(2, 4, T, 128, generator=g, device=device).to(torch.bfloat16)
        _ext.reset_launch_counts()
        with torch.no_grad():
            pfn_attention(q, q, q, T // 2, impl="auto")
        auto[T] = "flash" if _ext.launch_counts["pfn_flash_fwd"] == 1 else "dense"
    _ext.reset_launch_counts()
    want = {T: "flash" if T >= FLASH_MIN_SEQ else "dense" for T in DISPATCH_AUTO_SEQS}
    emit({"phase": "dispatch", "card": smi, "rows": rows, "auto_picks": auto, "auto_expected": want,
          "min_seq": FLASH_MIN_SEQ})
    if auto != want:
        raise AssertionError(f"dispatch: auto picked {auto}, expected {want}")
    return rows


def _quietly(fn, *args):
    """fn(*args) with its printing kept in a buffer: (result, text). The
    text is printed when fn raises."""
    import io

    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            out = fn(*args)
    except BaseException:
        print(log.getvalue(), flush=True)
        raise
    return out, log.getvalue()


def phase_fig3a(device, smi: str, size: dict = FIG3A_EXPERIMENTS):
    """The ported Fig-3a experiments at the full Fig-3a width (emsize 512, 4
    heads of 128, nhid 1024, 6 layers, bf16, T 2010) on the round-5 recipe
    (mixture sampler, 10 000 buckets, cap 128, 4 x 25 microbatches), seeded
    weights through --init_from; cut in the depth of the schedule only:
    fig3a_longrun 1 epoch on the grid-8192 sampler, then a resume to 2 with
    the scoring (profiled: the bf16 flash bodies must run), bitwise equal to
    an uninterrupted 2-epoch run, and 2 epochs on the exact sampler (s/epoch
    of both samplers); fig3a_analytic_gap (f64 moments on the card) and
    fig3a_robust_eval on the checkpoint, 2 chunks of 8 datasets at the 14
    positions; bar_resolution_floor and analytic_gap_decompose on the
    analytic gap's files; grid_fidelity with both methods at G 8192, T 2010,
    batch 64;
    gp_fitting --quick cut to 2 epochs. Returns the flash kernels' launches
    over the whole phase."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pfn_tpu_torch.experiments import (
        analytic_gap_decompose,
        bar_resolution_floor,
        fig3a_analytic_gap,
        fig3a_longrun,
        fig3a_robust_eval,
        gp_fitting,
        grid_fidelity,
    )
    from pfn_tpu_torch.experiments.common import FIG3A_MODEL, POSITIONS
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.train import restore_checkpoint, save_checkpoint, seeded_flax_params, state_dict_from_flax_params

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="pfn_fig3a_"))
    buckets, T = size["buckets"], size["T"]
    dev = ["--device", str(device)]
    save_checkpoint(str(tmp / "init" / "epoch_0"), {"model": state_dict_from_flax_params(
        seeded_flax_params(1, FIG3A_MODEL["emsize"], FIG3A_MODEL["nhid"], FIG3A_MODEL["nlayers"], buckets, seed=0),
        FIG3A_MODEL["nlayers"])})
    recipe = dev + ["--bptt", str(T), "--num_buckets", str(buckets), "--bucket_seq_cap", str(size["bucket_seq_cap"]),
                    "--eval_pos_sampler", "mixture", "--batch_size", str(size["batch_size"]), "--agg",
                    str(size["agg"]), "--checkpoint_every", "1", "--init_from", str(tmp / "init")]
    grid = ["--grid", str(size["grid"])]
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out, text = _quietly(fn, *args)
        seconds[name] = time.perf_counter() - t0
        return out, text

    _ext.reset_launch_counts()
    first, _ = timed("longrun_epoch1", fig3a_longrun.main,
                     recipe + grid + ["--out", str(tmp / "run"), "--epochs", "1", "--skip_eval"])
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        resumed, resume_log = timed("longrun_resume_and_score", fig3a_longrun.main,
                                    recipe + grid + ["--out", str(tmp / "run"), "--epochs", "2", "--eval_batch",
                                                     str(size["eval_batch"])])
        torch.cuda.synchronize(device)
        time.sleep(PROFILE_PAD_S)
    bf16_kernels = {frag: sum(e.count for e in prof.key_averages() if frag in e.key)
                    for frag in ("fwd_sm90", "dq_sm90", "dkv_sm90")}
    straight, _ = timed("longrun_straight", fig3a_longrun.main,
                        recipe + grid + ["--out", str(tmp / "straight"), "--epochs", "2", "--skip_eval"])
    exact, _ = timed("longrun_exact", fig3a_longrun.main,
                     recipe + ["--out", str(tmp / "exact"), "--epochs", "2", "--skip_eval"])
    a = restore_checkpoint(str(tmp / "run" / "ck" / "epoch_2"), map_location="cpu")
    b = restore_checkpoint(str(tmp / "straight" / "ck" / "epoch_2"), map_location="cpu")
    resume_bitwise = (a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
                      and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
                      and all(torch.equal(sa[k], sb[k]) for sa, sb in zip(a["optimizer"]["state"].values(),
                                                                           b["optimizer"]["state"].values())
                              for k in ("exp_avg", "exp_avg_sq")))
    ck = str(tmp / "run" / "ck")
    score = dev + ["--ck", ck, "--bptt", str(T), "--num_buckets", str(buckets), "--chunks", str(size["chunks"]),
                   "--chunk_batch", str(size["chunk_batch"])]
    gap, _ = timed("analytic_gap", fig3a_analytic_gap.main,
                   score + grid + ["--bucket_seq_cap", str(size["bucket_seq_cap"]), "--out", str(tmp / "agap")])
    robust, _ = timed("robust_eval", fig3a_robust_eval.main, score + ["--out", str(tmp / "robust")])
    agap = tmp / "agap"
    floor, _ = timed("bar_resolution_floor", bar_resolution_floor.main, dev + [
        "--moments", str(agap / "oracle_moments.npz"), "--analytic", str(agap / "analytic_gap.json"),
        "--check_borders", str(agap / "borders.npy"), "--bptt", str(T), "--seq_cap", str(size["bucket_seq_cap"]),
        "--buckets", "1000", str(buckets), "--out", str(tmp / "floor.json")])
    decomp, _ = timed("analytic_gap_decompose", analytic_gap_decompose.main, dev + [
        "--dir", str(agap), "--label", "chip_smoke", "--out", str(tmp / "decompose.json")])
    launches = dict(_ext.launch_counts)
    oracle, _ = timed("oracle_pass", fig3a_longrun.main, dev + grid + ["--out", str(tmp / "run"), "--oracle_pass"])
    fidelity = {}
    for method in ("fft", "chol"):
        fidelity[method], _ = timed(f"grid_fidelity_{method}", grid_fidelity.main, dev + [
            "--grid", str(size["grid"]), "--bptt", str(T), "--batch", "64", "--method", method,
            "--out", str(tmp / f"grid_fidelity_{method}.json")])
    fit, _ = timed("gp_fitting_quick", gp_fitting.main, dev + ["--quick", "--epochs", str(size["quick_epochs"]),
                                                              "--out", str(tmp / "gp_fitting")])
    launches_after = dict(_ext.launch_counts)

    P = len([t for t in POSITIONS if t < T])
    n_gap = size["chunks"] * size["chunk_batch"]
    kl = np.stack([gap["kl"]["nominal"], gap["kl"]["effective"]])
    updates = 6 * 4  # six epochs of 4 updates: 1 + 1 (resumed) + 2 (straight) + 2 (exact)
    per_update = FIG3A_MODEL["nlayers"] * size["agg"]
    expected = {"pfn_flash_bwd_dq": updates * per_update, "pfn_flash_bwd_dkv": updates * per_update,
                "pfn_flash_fwd": updates * per_update + FIG3A_MODEL["nlayers"] * P * (1 + 2 * size["chunks"])}
    stats = {name: [s["epoch_time"] for s in run["epoch_stats"]] for name, run in (
        ("grid_run", first), ("grid_resumed", resumed), ("grid_straight", straight), ("exact", exact))}
    oracle_pairs = 2 * size["eval_batch"] * P  # dataset-positions at two noises
    floors = np.asarray([floor[f"floor_mean_{nb}b"] for nb in (1000, buckets)])
    tail_share = [t / max(tot, 1e-300) for t, tot in zip(decomp["kl_tail_mean"], decomp["kl_total_mean"])]
    at = {gap["positions"][0]: 0, gap["positions"][-1]: P - 1}  # ctx 1 and 2000
    fit_losses = [s["mean_loss"] for s in fit["epoch_stats"]]
    checks = {
        "resumed": "resumed from" in resume_log,
        "resume_bitwise_equal": resume_bitwise,
        "epochs": [len(stats[k]) for k in ("grid_run", "grid_resumed", "grid_straight", "exact")] == [1, 1, 2, 2],
        "longrun_losses_finite": all(np.isfinite(s["mean_loss"]) for r in (first, resumed, straight, exact)
                                     for s in r["epoch_stats"]),
        "longrun_curves_finite": bool(np.isfinite(resumed["pfn_nll"] + resumed["oracle_nll"]
                                                  + resumed["oracle_nll_noise1e-3"]).all()),
        "flash_bf16_bodies_profiled": all(n > 0 for n in bf16_kernels.values()),
        "flash_launches": all(launches[k] == v for k, v in expected.items()),
        "no_flash_in_oracle_fidelity_and_quick": launches_after == launches,
        "oracle_pass_repeats": oracle["oracle_nll"] == resumed["oracle_nll"],
        "kl_shape": kl.shape == (2, P, n_gap),
        "kl_finite": bool(np.isfinite(kl).all()),
        "kl_nonnegative": bool(kl.min() >= -1e-6),
        "floor_finite_nonnegative": floors.shape == (2, P) and bool(np.isfinite(floors).all() and floors.min() >= 0),
        "floor_borders_checked_against_the_run": bool(np.isfinite(
            floor.get(f"borders_{buckets}b_max_shift_vs_run", np.nan))),
        "decompose_total_equals_gap": bool(np.abs(np.asarray(decomp["kl_total_mean"])
                                                  - np.asarray(gap["kl_mean_effective"])).max() < 1e-6),
        "decompose_finite": bool(np.isfinite(decomp["kl_interior_mean"] + decomp["kl_tail_mean"]).all()),
        "robust_finite": bool(np.isfinite(np.asarray(robust["gap_ci95_effective"])).all()),
        "grid_fidelity_finite": all(np.isfinite(f["effective_noise"]) and np.isfinite(f["latent_err_rms"])
                                    for f in fidelity.values()),
        "gp_fitting_losses_finite_and_decreasing": (len(fit_losses) == size["quick_epochs"]
                                                    and bool(np.isfinite(fit_losses).all())
                                                    and all(b < a for a, b in zip(fit_losses, fit_losses[1:]))),
        "gp_fitting_curves_finite": bool(np.isfinite(fit["pfn_nll"] + fit["oracle_nll"]).all()),
    }
    emit({
        "phase": "fig3a", "card": smi, "size": size, "model": FIG3A_MODEL, "dtype": "bf16",
        "s_per_epoch": {"grid_8192": stats["grid_straight"][-1], "exact": stats["exact"][-1]},
        "epoch_seconds": stats, "seconds": seconds, "phase_s": time.perf_counter() - t_phase,
        "launches": launches, "expected_launches": expected, "bf16_kernels_in_profile": bf16_kernels,
        "longrun": {k: resumed[k] for k in ("positions", "pfn_nll", "oracle_nll", "oracle_nll_noise1e-3",
                                            "oracle_seconds", "final_train_loss")},
        "oracle_f64": {"dataset_positions": oracle_pairs, "pass_s": seconds["oracle_pass"],
                       "dataset_positions_per_s": oracle_pairs / seconds["oracle_pass"],
                       "timer_s": oracle["seconds"]},
        "analytic_gap": {k: gap[k] for k in ("kl_mean_effective", "kl_median_effective", "kl_ci95_effective",
                                             "verdict_effective", "kl_mean_nominal")},
        "robust_eval": {k: robust[k] for k in ("gap_mean_effective", "gap_ci95_effective")},
        "bar_resolution_floor": {
            "s": seconds["bar_resolution_floor"], f"floor_mean_{buckets}b": floor[f"floor_mean_{buckets}b"],
            f"out_of_support_mass_mean_{buckets}b": floor[f"out_of_support_mass_mean_{buckets}b"],
            f"borders_{buckets}b_max_shift_vs_run": floor.get(f"borders_{buckets}b_max_shift_vs_run")},
        "analytic_gap_decompose": {
            "s": seconds["analytic_gap_decompose"],
            "kl_tail_over_total": {f"ctx{ctx}": tail_share[i] for ctx, i in at.items()},
            "kl_total_mean": {f"ctx{ctx}": decomp["kl_total_mean"][i] for ctx, i in at.items()}},
        "grid_fidelity": {m: {k: f[k] for k in ("duplicate_pairs", "effective_noise", "effective_noise_ci95",
                                                "latent_err_rms_over_noise_sd", "verdict", "prior_moments")}
                          for m, f in fidelity.items()},
        "gp_fitting_quick": {"epoch_losses": fit_losses, "mean_gap": fit["mean_gap"],
                             "epoch_seconds": [s["epoch_time"] for s in fit["epoch_stats"]]},
        "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fig3a checks failed: {failed}")
    return launches


def _timed_s(fn):
    """(seconds on the host clock from a sync to a sync, fn())."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _update_profile(step, state) -> dict:
    """A profile of one update: wall and device ms, idle share, the top
    kernels."""
    kernels, wall_ms, busy_ms = profiled_kernels(lambda: float(step(state)["loss"]), cpu=True)
    kernels.sort(key=lambda kn: -kn[1])
    return {"wall_ms": wall_ms, "device_ms": busy_ms if kernels else "not measured",
            "idle_share": 1.0 - busy_ms / wall_ms if kernels else "not measured", "kernels": kernels[:8]}


def phase_fewshot(device, smi: str, size: dict = FEWSHOT):
    """The few-shot path of experiments/fewshot_omniglot at its full
    configuration (FEWSHOT): stroke pretraining through train(...), the
    weights saved and loaded back bitwise, the synthetic class bank and its
    episodes on the card, zero-shot accuracy, a warm-started finetune on
    the bank's train classes and its accuracy (reported, not gated); T 26:
    dense attention, no flash launch. Update time, datasets/s, peak memory,
    a profile of one update, the episode prior's device ms per batch."""
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.experiments import fewshot_omniglot as driver
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import OmniglotPrior, StrokePrior, omniglot_accuracy
    from pfn_tpu_torch.train import build_model, ce_criterion, restore_checkpoint, save_checkpoint, train

    scratch = tempfile.TemporaryDirectory(prefix="pfn_fewshot_")
    # No Omniglot files under the root: the synthetic bank stands in.
    args = driver.build_parser().parse_args(["--omniglot_root", scratch.name])
    imgsz, n_way, T = 28, args.n_way, args.n_way * args.k_shot + 1
    cfg = dataclasses.replace(driver.pretrain_config(args, device), epochs=size["epochs"],
                              steps_per_epoch=size["updates"], seed=0)
    crit = ce_criterion(n_way)
    stroke = StrokePrior(num_features=imgsz * imgsz, num_outputs=n_way, only_train_for_last_idx=True)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    pre_s, (result, _) = _timed_s(lambda: _quietly(lambda: train(stroke, crit, cfg)))
    pre_launches = dict(_ext.launch_counts)

    # The weights saved and loaded back, bitwise.
    ck = Path(scratch.name) / "pretrained"
    save_checkpoint(str(ck), {"model": result.model.state_dict()})
    loaded = restore_checkpoint(str(ck), map_location=device)["model"]
    scratch.cleanup()
    reloaded = build_model(stroke, crit, cfg)
    reloaded.load_state_dict(loaded)
    load_bitwise = all(torch.equal(a, b) for a, b in zip(result.model.state_dict().values(),
                                                         reloaded.state_dict().values()))

    train_bank, test_bank, source = driver.episode_banks(args, imgsz, device)
    test_prior = OmniglotPrior(test_bank, num_outputs=n_way)
    acc = dict(seq_len=T, **driver.ACCURACY)
    acc_zero = omniglot_accuracy(reloaded, test_prior, **acc)
    ft_prior = OmniglotPrior(train_bank, num_outputs=n_way)
    ft_cfg = dataclasses.replace(driver.finetune_config(cfg, args), epochs=1, steps_per_epoch=size["finetune_updates"])
    _ext.reset_launch_counts()
    ft_s, (ft, _) = _timed_s(lambda: _quietly(lambda: train(ft_prior, crit, ft_cfg, init_params=loaded)))
    ft_launches = dict(_ext.launch_counts)
    acc_ft = omniglot_accuracy(ft.model, test_prior, **acc)

    g = torch.Generator(device=device).manual_seed(3)
    x, y, t = ft_prior.sample(cfg.batch_size, T, generator=g, device=device)
    prior_ms = cuda_ms(lambda: ft_prior.sample(cfg.batch_size, T, generator=g, device=device))
    stroke_ms = cuda_ms(lambda: stroke.sample(cfg.batch_size, T, generator=g, device=device))
    step, state, update_ms, median_ms = timed_updates(ft_prior, crit, ft_cfg, ft.model, device,
                                                      size["timed_updates"])
    profile = _update_profile(step, state)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = result.epoch_stats + ft.epoch_stats
    checks = {
        "losses_finite": all(np.isfinite(s["mean_loss"]) for s in stats),
        "weights_load_bitwise": load_bitwise,
        "synthetic_bank": source == "synthetic",
        "bank_on_card": train_bank.images.is_cuda and test_bank.images.is_cuda,
        "episodes_on_card": x.is_cuda and y.is_cuda and t.is_cuda,
        "episode_shape": tuple(x.shape) == (cfg.batch_size, T, imgsz * imgsz),
        "targets": bool((t[:, :-1] == -100).all()) and torch.equal(t[:, -1], y[:, -1]),
        "dense_at_T26": not any(pre_launches.values()) and not any(ft_launches.values()),
        "accuracies_in_range": 0.0 <= acc_zero <= 1.0 and 0.0 <= acc_ft <= 1.0,
    }
    emit({
        "phase": "fewshot", "card": smi, "size": size, "source": source,
        "config": {k: getattr(cfg, k) for k in ("emsize", "nhid", "nlayers", "nhead", "bptt", "batch_size", "lr")},
        "bank": {"train_classes": train_bank.num_classes, "test_classes": test_bank.num_classes,
                 "per_class": int(train_bank.images.shape[1]), "imgsz": imgsz},
        "epoch_stats": stats, "pretrain_s": pre_s, "finetune_s": ft_s,
        "zero_shot_acc": acc_zero, "finetuned_acc": acc_ft, "chance": 1 / n_way,
        "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
        "datasets_per_s": cfg.batch_size / (median_ms / 1e3), "peak_memory_gb": peak_gb,
        "update_profile": profile, "omniglot_prior_ms_per_batch": prior_ms, "stroke_prior_ms_per_batch": stroke_ms,
        "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fewshot checks failed: {failed}")


def f32_fwd_timing(device, shape: dict) -> dict:
    """The flash forward's f32 body alone at ``shape`` (B*H, T, D, sep),
    against its plain version (F32_TOL), a repeat call bitwise equal; its
    ms, the plain version's, SDPA f32's with the PFN mask, and its f32
    bound."""
    import torch
    import torch.nn.functional as F

    from pfn_tpu_torch.ops.attention import pfn_mask
    from pfn_tpu_torch.ops.flash_attention import _flash_fwd, _flash_fwd_plain

    BH, T, D, sep = shape["BH"], shape["T"], shape["D"], shape["sep"]
    g = torch.Generator(device=device).manual_seed(11)
    q, k, v = (torch.randn(BH, T, D, generator=g, device=device) for _ in range(3))
    q = q * D ** -0.5
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
    o, lse = _flash_fwd(q, k, v, sep_t, True)
    o_plain, lse_plain = _flash_fwd_plain(q, k, v, sep, T, True)
    err = max(max_abs(o, o_plain), max_abs(lse, lse_plain))
    ok = (torch.allclose(o, o_plain, atol=F32_TOL, rtol=F32_TOL)
          and torch.allclose(lse, lse_plain, atol=F32_TOL, rtol=F32_TOL))
    o2, lse2 = _flash_fwd(q, k, v, sep_t, True)
    repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
    mask = pfn_mask(T, sep, device=device)
    q4, k4, v4 = (t.reshape(BH // 4, 4, T, D) for t in (q, k, v))
    with torch.no_grad():
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0))
    ms = cuda_ms(lambda: _flash_fwd(q, k, v, sep_t, True))
    plain_ms = cuda_ms(lambda: _flash_fwd_plain(q, k, v, sep_t, T, True))
    b = flash_bound("fwd", BH, T, D, sep, dtype="f32")
    return {"shape": shape, "max_abs_err": err, "agrees": ok, "repeat_bitwise_equal": repeat, "ms": ms,
            "plain_ms": plain_ms, "library_ms": sdpa_ms, **b, "pct_of_bound": 100.0 * b["bound_ms"] / ms,
            "gflop": flash_flops("fwd", BH, T, D, sep) / 1e9}


def phase_bayesopt(device, smi: str, size: dict = BAYESOPT):
    """experiments/bayesopt_eval at its full configuration (BAYESOPT): the
    surrogate trained through train(...) (cut to 2 epochs of 2 steps), then
    the BO loop uncut: 32 GP-prior functions x 25 iterations x (EI, UCB)
    over 128 candidates, and random search; the regret table; ms per BO
    iteration on the host clock, one iteration's time by CUDA events and its
    idle share. Then one scoring request at 2048 candidates (T 2076) on the
    auto path, which runs the flash forward's f32 body at head dim 32: its
    scores against the dense f32 path (F32_TOL x (1 + max)), launched once
    per layer; and the body alone at that shape against its plain version
    (f32_fwd_timing). Returns (the body's row, its launches on the path)."""
    import numpy as np
    import torch

    from pfn_tpu_torch.bayesopt import PFNOptimizer
    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.experiments import bayesopt_eval as driver
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior
    from pfn_tpu_torch.train import bar_criterion, build_model, train

    args = driver.build_parser().parse_args([])
    cfg = dataclasses.replace(driver.train_config(args, device), epochs=size["epochs"],
                              steps_per_epoch=size["steps"], updates_per_call=1, seed=0)
    prior = GPPrior(num_features=1, **driver.GP_HP)
    crit = bar_criterion(get_bucket_limits(driver.NUM_BUCKETS, full_range=driver.BUCKET_RANGE))
    train_s, (result, _) = _timed_s(lambda: _quietly(lambda: train(prior, crit, cfg)))
    model, bar = result.model, result.criterion.bar
    optimizers = {"ei": PFNOptimizer(model, bar, acquisition="ei"),
                  "ucb": PFNOptimizer(model, bar, acquisition="ucb", beta=driver.UCB_BETA)}

    # The BO loop, uncut.
    M, iters, fns = args.num_candidates, args.num_iterations, size["functions"]
    regrets = {"ei": [], "ucb": [], "random": []}
    _ext.reset_launch_counts()
    loop_s = 0.0
    for f in range(fns):
        seconds, r = _timed_s(lambda: driver.run_function(f, optimizers, M, iters, device))
        loop_s += seconds
        for name, row in r.items():
            regrets[name].append(row)
    loop_launches = dict(_ext.launch_counts)
    summary = driver.summarize(regrets)
    table = driver.regret_table(summary, iters)

    # One iteration (score every candidate, the argmax on the host) by
    # events, and its idle share.
    xs, ys, _ = driver.objective_table(0, M, device)
    N = driver.NUM_INIT + iters
    x_obs, y_obs = xs[:N].clone(), ys[:N].clone()

    def iteration():
        return int(torch.argmax(optimizers["ei"].scores(x_obs, y_obs, xs, num_obs=N - 1)))

    iter_ms = [timed_request(iteration)[0] for _ in range(10)]
    iter_profile = device_profile(iteration)

    # Scoring 2048 candidates: T = 28 + 2048 >= 256, the flash forward.
    wide = torch.linspace(0.0, 1.0, size["wide_candidates"], device=device)[:, None]
    dense = build_model(prior, crit, dataclasses.replace(cfg, attention_impl="dense"))
    dense.load_state_dict(model.state_dict())
    dense.eval()
    scores, dense_scores, launches = {}, {}, {}
    for name, opt in optimizers.items():
        _ext.reset_launch_counts()
        scores[name] = opt.scores(x_obs, y_obs, wide, num_obs=N)
        launches[name] = dict(_ext.launch_counts)
        dense_scores[name] = PFNOptimizer(dense, bar, opt.acquisition, opt.maximize, opt.beta).scores(
            x_obs, y_obs, wide, num_obs=N)
    errs = {name: max_abs(scores[name], dense_scores[name]) for name in scores}
    tols = {name: F32_TOL * (1 + float(dense_scores[name].abs().max())) for name in scores}
    wide_ms = cuda_ms(lambda: optimizers["ei"].scores(x_obs, y_obs, wide, num_obs=N), iters=10)
    body = f32_fwd_timing(device, {"BH": cfg.nhead, "T": N + size["wide_candidates"], "D": cfg.emsize // cfg.nhead,
                                   "sep": N})
    wide_launches = sum(launches[name]["pfn_flash_fwd"] for name in launches)
    checks = {
        "losses_finite": all(np.isfinite(s["mean_loss"]) for s in result.epoch_stats),
        "regrets_finite": all(np.isfinite(np.stack(r)).all() for r in regrets.values()),
        "loop_dense_at_T156": not any(loop_launches.values()),
        "wide_auto_is_flash": all(launches[n] == {**dict.fromkeys(launches[n], 0), "pfn_flash_fwd": cfg.nlayers}
                                  for n in launches),
        "wide_scores_vs_dense": all(errs[n] <= tols[n] for n in errs),
        "fwd_f32_vs_plain": body["agrees"],
        "fwd_f32_repeat_bitwise": body["repeat_bitwise_equal"],
    }
    emit({
        "phase": "bayesopt", "card": smi, "size": size,
        "config": {k: getattr(cfg, k) for k in ("emsize", "nhid", "nlayers", "nhead", "bptt", "batch_size", "lr")},
        "train_s": train_s, "epoch_stats": result.epoch_stats,
        "bo": {"functions": fns, "iterations": iters, "candidates": M, "acquisitions": list(optimizers),
               "loop_s": loop_s, "ms_per_iteration": 1e3 * loop_s / (fns * len(optimizers) * iters),
               "iteration_event_ms": {"first": iter_ms[0], "median_of_9": float(np.median(iter_ms[1:]))},
               "iteration_profile": iter_profile},
        "summary": summary, "regret_table": table.splitlines(),
        "wide": {"candidates": size["wide_candidates"], "T": N + size["wide_candidates"], "launches": launches,
                 "max_abs_vs_dense": errs, "tol": tols, "ms": wide_ms},
        "fwd_f32_bayesopt": body, "checks": checks,
    })
    print(table, flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bayesopt checks failed: {failed}")
    return body, wide_launches


def phase_gp_mix_oracles(device, smi: str, size: dict = GP_MIX_ORACLES):
    """The GP-mix oracles on the card (GP_MIX_ORACLES): GPMixPrior(num_features
    =1) with the JAX defaults, 16 datasets at T 100; gp_map_evaluate over
    every position 1-99 (150 Adam steps, lr 0.05: 1 584 fits in one batch)
    and gp_hyper_mcmc_predictive (64 draws after 128 of warm-up, context 50
    and 50 queries, the 16 datasets batched), each timed on the host clock
    up to a sync with the idle share of a short run; HMC's acceptance. Every
    MAP fit is finite (the oracles' f64 marginal likelihood), and their mean
    NLL falls from the first ten positions to the last ten; the mixture
    predictive's NLL is at or below that of fixed bad hyperparameters (JAX's
    test_hyper_mcmc_predictive_beats_bad_hypers)."""
    import math

    import numpy as np
    import torch

    from pfn_tpu_torch.evals import gp_mix_oracles as oracles
    from pfn_tpu_torch.ops.gp_sample import gp_posterior
    from pfn_tpu_torch.priors import GPMixPrior

    prior = GPMixPrior(num_features=1)
    B, T, ctx = size["datasets"], size["T"], size["context"]
    draws = prior.draw(B, T, generator=torch.Generator(device=device).manual_seed(0), device=device)
    x, y = prior.from_draws(draws)
    true_hp = [h.reshape(B, -1)[:, 0].tolist() for h in prior.hypers(draws, B)]
    map_s, (all_losses, _) = _timed_s(lambda: oracles.gp_map_evaluate(x, y, prior, steps=size["map_steps"],
                                                                                 lr=size["map_lr"]))
    map_profile = device_profile(lambda: oracles.gp_map_evaluate(x, y, prior, steps=size["profile_steps"]))
    mask = torch.arange(T, device=device) < ctx
    g = torch.Generator(device=device).manual_seed(1)
    mcmc_s, (nll, accept) = _timed_s(lambda: oracles.gp_hyper_mcmc_predictive(
        x[:, :ctx], y[:, :ctx], x[:, ctx:], y[:, ctx:], prior, g, num_samples=size["mcmc_samples"],
        num_warmup=size["mcmc_warmup"]))
    mcmc_profile = device_profile(lambda: oracles.gp_hyper_mcmc_predictive(
        x[:, :ctx], y[:, :ctx], x[:, ctx:], y[:, ctx:], prior, g, num_samples=1, num_warmup=1))
    mean, var = gp_posterior(x, y, x, lengthscale=5.0, outputscale=0.01, noise=1.0, kernel=oracles.matern52_kernel,
                             context_mask=mask)
    bad = 0.5 * (math.log(2 * math.pi) + torch.log(var) + (y - mean) ** 2 / var)[:, ctx:]
    losses = all_losses.cpu().numpy()
    finite = np.isfinite(losses)
    curve = losses.mean(axis=1)
    checks = {
        "map_shape": tuple(all_losses.shape) == (T - 1, B),
        "map_all_finite": bool(finite.all()),
        "map_nll_falls": float(curve[:10].mean()) > float(curve[-10:].mean()),
        "mcmc_finite": bool(torch.isfinite(nll).all()),
        "mcmc_accepts": bool(((accept > 0.05) & (accept <= 1.0)).all()),
        "mcmc_beats_bad_hypers": float(nll.mean()) <= float(bad.mean()),
    }
    emit({
        "phase": "gp_mix_oracles", "card": smi, "size": size,
        "map": {"fits": (T - 1) * B, "nonfinite_fits": int((~finite).sum()), "seconds": map_s,
                "nll_first_10": float(curve[:10].mean()), "nll_last_10": float(curve[-10:].mean()),
                "nll_mean": float(curve.mean()), "nll_median_first_10": float(np.median(losses[:10])),
                "nll_median_last_10": float(np.median(losses[-10:])),
                f"profile_{size['profile_steps']}_steps": map_profile},
        "datasets_hypers": dict(zip(("noise", "lengthscale", "outputscale"), true_hp)),
        "mcmc": {"seconds": mcmc_s, "nll": float(nll.mean()), "bad_hypers_nll": float(bad.mean()),
                 "nll_per_dataset": nll.mean(1).tolist(), "bad_hypers_nll_per_dataset": bad.mean(1).tolist(),
                 "accept_per_dataset": accept.tolist(),
                 "accept_mean": float(accept.mean()), "accept_min": float(accept.min()),
                 "profile_2_trajectories": mcmc_profile},
        "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gp_mix_oracles checks failed: {failed}")


def phase_compat(device, smi: str, size: dict = COMPAT):
    """The reference-API shim's workflow (pfn_tpu_torch/compat.py's
    docstring) through compat.train on the card at its widths (emsize 512,
    4 heads, nhid 1024, 6 layers, bptt 2010, batch 4, 25 microbatches, the
    weighted sampler up to 2000, 1000 buckets from 100 000 get_batch draws,
    f32; COMPAT), cut to 2 updates: the flash f32 bodies launched 6 layers x
    25 microbatches x 2 updates times each; one update from seeded weights on
    the kernel path against the dense f32 path (one_update_vs_dense,
    F32_PATH_TOL, its reach at F32_PATH_PROBE). Returns the launches."""
    import numpy as np
    import torch

    from pfn_tpu_torch import compat as ref
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

    hps = size["hyperparameters"]
    ys_s, ys = _timed_s(lambda: ref.priors.fast_gp.get_batch(size["bucket_draws"], 20, 1, hyperparameters=hps,
                                                                     device=device)[1])
    criterion = ref.bar_distribution.FullSupportBarDistribution(
        ref.bar_distribution.get_bucket_limits(size["buckets"], ys=ys))
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    train_s, (total_loss, pos_losses, result) = _timed_s(lambda: ref.train(
        ref.priors.fast_gp.DataLoader, criterion, ref.encoders.Linear,
        emsize=size["emsize"], nhead=size["nhead"], nhid=size["nhid"], nlayers=size["nlayers"],
        y_encoder_generator=ref.encoders.Linear,
        pos_encoder_generator=ref.positional_encodings.NoPositionalEncoding,
        extra_prior_kwargs_dict={"num_features": 1, "fuse_x_y": False, "hyperparameters": hps},
        single_eval_pos_gen=ref.utils.get_weighted_single_eval_pos_sampler(size["max_sep"]),
        bptt=size["bptt"], batch_size=size["batch_size"], aggregate_k_gradients=size["agg"], epochs=1,
        steps_per_epoch=size["agg"] * size["updates"], lr=1e-4, scheduler=ref.utils.get_cosine_schedule_with_warmup,
        gpu_device=device, verbose=False))
    launches = {name: _ext.launch_counts[name] for name in FLASH_F32_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cfg = result.config
    prior = ref.priors.fast_gp.DataLoader.make(num_features=1, hyperparameters=hps)
    init = state_dict_from_flax_params(seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, size["buckets"],
                                                          seed=0), cfg.nlayers)
    one, rel, one_paths, reach = one_update_vs_dense(prior, result.criterion, cfg, init, device)
    expected = cfg.nlayers * cfg.aggregate_k_gradients * size["updates"]
    checks = {
        "f32": cfg.dtype == torch.float32,
        "loss_finite": bool(np.isfinite(total_loss)),
        "launches": all(n == expected for n in launches.values()),
        "kernel_vs_dense_f32_update": all(r <= F32_PATH_TOL for r in rel.values()),
        "one_update_paths": one_paths,
        "update_check_sees_the_probe": reach["grads"] > F32_PATH_TOL,
    }
    emit({
        "phase": "compat", "card": smi, "size": {k: v for k, v in size.items() if k != "hyperparameters"},
        "hyperparameters": {k: v for k, v in hps.items() if k != "fast_computations"},
        "get_batch_s": ys_s, "train_s": train_s, "total_loss": total_loss,
        "step_ms": 1e3 * result.epoch_stats[0]["step_time"], "peak_memory_gb": peak_gb,
        "launches": launches, "expected_launches": expected, "one_update": one, "one_update_rel_diff": rel,
        "tol": F32_PATH_TOL, "probe": F32_PATH_PROBE, "probe_rel_change": reach, "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"compat checks failed: {failed}")
    return launches


def phase_native_cache(device, smi: str, size: dict = NATIVE_CACHE):
    """The C++ mmap batch cache on the card's machine (NATIVE_CACHE): the
    library built with g++, 50 stroke-prior batches at the few-shot shape
    (64 x 26 x 784 f32, ~260 MB) written under a temporary directory (write
    GB/s) and read back through CachedPrior.training_iter(prefetch=2) into
    pinned host tensors, each batch dropped once read, as the train loop
    drops it (read GB/s); then 2 updates of the few-shot model on the card
    from that stream, equal bitwise in loss and parameters to the same
    batches fed from memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.experiments import fewshot_omniglot as fewshot
    from pfn_tpu_torch.native import cache
    from pfn_tpu_torch.priors import StrokePrior
    from pfn_tpu_torch.train import build_model, ce_criterion, train

    build_s, available = _timed_s(cache.native_available)
    n_way, T, imgsz = 5, 26, 28
    prior = StrokePrior(num_features=imgsz * imgsz, num_outputs=n_way, only_train_for_last_idx=True)
    B, n = fewshot.FULL["batch_size"], size["batches"]
    tmp = Path(tempfile.mkdtemp(prefix="pfn_cache_"))
    try:
        path = str(tmp / "stroke")
        write_s, written = _timed_s(lambda: cache.write_prior_cache(path, prior, n, B, T,
                                                                    torch.Generator(device=device).manual_seed(0)))
        nbytes = Path(path).stat().st_size
        cached = cache.CachedPrior(path, num_outputs=n_way)
        stream = cached.training_iter(seed=1, prefetch=2)
        pinned = True
        t0 = time.perf_counter()
        for _ in range(n):
            pinned &= all(a.is_pinned() for a in next(stream))
        read_s = time.perf_counter() - t0
        stream.close()

        args = fewshot.build_parser().parse_args([])
        cfg = dataclasses.replace(fewshot.pretrain_config(args, device), epochs=1, steps_per_epoch=size["updates"],
                                  warmup_epochs=0, seed=0, verbose=False)
        crit = ce_criterion(n_way)
        fed_stream = cached.training_iter(seed=2, prefetch=2)
        fed = train(cached, crit, cfg, data_iter=fed_stream)
        fed_stream.close()
        rng = np.random.RandomState(2)
        picks = [rng.randint(len(cached.reader)) for _ in range(size["updates"])]
        memory = iter([tuple(torch.from_numpy(cached.reader.record(i, copy=True)[k]).to(device)
                             for k in ("x", "y", "target_y")) for i in picks])
        ref = train(cached, crit, cfg, data_iter=memory)
        cached.reader.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bitwise = ([s["mean_loss"] for s in fed.epoch_stats] == [s["mean_loss"] for s in ref.epoch_stats]
               and all(torch.equal(a, b) for a, b in zip(fed.model.state_dict().values(),
                                                         ref.model.state_dict().values())))
    init = build_model(cached, crit, cfg).state_dict()
    moved = not all(torch.equal(a, init[k]) for k, a in fed.model.state_dict().items())
    checks = {"library": available, "records": written == n, "pinned": pinned,
              "loss_finite": bool(np.isfinite(fed.final_loss)), "cache_fed_equals_memory_fed_bitwise": bitwise,
              "updates_moved_the_weights": moved}
    emit({
        "phase": "native_cache", "card": smi, "size": size, "record_shape": {"x": [B, T, imgsz * imgsz]},
        "build_s": build_s, "bytes": nbytes, "write_s": write_s, "write_gb_per_s": nbytes / write_s / 1e9,
        "read_s": read_s, "read_gb_per_s": nbytes / read_s / 1e9, "final_loss": fed.final_loss, "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"native_cache checks failed: {failed}")


@dataclasses.dataclass
class _MisScaledPrior:
    """A prior whose targets lie far outside the bar head's support (y ~ 100
    + N(0, 1)): what pfn_debug_checks exists to catch."""

    num_features: int = 1
    num_outputs: int = 1

    def sample(self, batch_size, seq_len, generator=None, device=None):
        import torch

        x = torch.rand((batch_size, seq_len, 1), generator=generator, device=device)
        y = 100.0 + torch.randn((batch_size, seq_len), generator=generator, device=device)
        return x, y, y


def _host_syncs(fn) -> list:
    """The host syncs fn() makes, caught by CUDA's sync debug mode: their
    warnings' first lines."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught if "called a synchronizing" in str(w.message)]


def phase_debug_checks(device, smi: str, size: dict = DEBUG_CHECKS):
    """The debug checks on the card (DEBUG_CHECKS): one update of a prior
    whose targets leave the bar support, at the Fig-3a width in f32 at T 100.
    Without the checks the loss is finite (the targets clamp); under
    pfn_debug_checks() train(...) raises FloatingPointError; with the flag
    off an update makes no host sync, while one under the checks makes some
    (the anomaly mode's NaN tests): CUDA's sync debug mode counts them."""
    import numpy as np
    import torch

    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model, train
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step
    from pfn_tpu_torch.utils.profiling import pfn_debug_checks

    prior = _MisScaledPrior()
    crit = bar_criterion(get_bucket_limits(size["buckets"], full_range=(-3.0, 3.0)))
    cfg = TrainConfig(emsize=512, nhid=1024, nlayers=6, nhead=4, bptt=size["T"], batch_size=size["batch_size"],
                      epochs=1, steps_per_epoch=1, lr=1e-4, warmup_epochs=0, verbose=False, device=device)
    plain = train(prior, crit, cfg).final_loss
    raised = ""
    try:
        with pfn_debug_checks():
            train(prior, crit, cfg)
    except FloatingPointError as e:
        raised = str(e)

    model = build_model(prior, crit, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1))
    step = make_train_step(prior, crit.to(device), cfg, schedule)
    for _ in range(3):  # the optimizer's state and the allocator's blocks in place
        float(step(state)["loss"])

    def flag_off():
        with pfn_debug_checks(False):
            step(state)

    def checks_on():  # last: the update raises before the optimizer steps
        with pfn_debug_checks():
            try:
                step(state)
            except FloatingPointError:
                pass

    syncs = {"flag_off": _host_syncs(flag_off), "checks_on": _host_syncs(checks_on)}
    torch.cuda.synchronize(device)
    checks = {"loss_finite_without_checks": bool(np.isfinite(plain)), "raises_under_checks": bool(raised),
              "update_without_host_sync": not syncs["flag_off"],
              "counter_sees_the_checks_syncs": bool(syncs["checks_on"])}
    emit({"phase": "debug_checks", "card": smi, "size": size, "loss_without_checks": plain,
          "raised": raised[:200],
          "host_syncs": {k: {"count": len(v), "first": v[:3]} for k, v in syncs.items()}, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"debug_checks checks failed: {failed}")


class _BatchPrior:
    """A prior whose every draw is one given global batch (the pipeline's
    train step draws from its prior)."""

    num_features, num_outputs = 1, 1

    def __init__(self, x, y, ty):
        self.batch = (x, y, ty)

    def sample(self, batch_size, seq_len, generator=None, device=None):
        return self.batch


def _mesh_weights(size: dict, experts: int) -> dict:
    from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

    flax = seeded_flax_params(1, size["emsize"], size["nhid"], size["nlayers"], size["buckets"], seed=0,
                              num_experts=experts)
    return state_dict_from_flax_params(flax, size["nlayers"])


def _mesh_criterion(size: dict, device):
    import torch

    from pfn_tpu_torch.train import bar_criterion

    return bar_criterion(torch.linspace(-4.0, 4.0, size["buckets"] + 1)).to(device)


def _mesh_cfg(size: dict, experts: int, dtype: str, fsdp: bool = False, impl: str = "auto"):
    import torch

    from pfn_tpu_torch.train import TrainConfig

    return TrainConfig(emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"],
                       bptt=size["T"], batch_size=size["batch_size"], epochs=2, steps_per_epoch=1, lr=size["lr"],
                       warmup_epochs=0, eval_pos_sampler="fixed", fixed_eval_pos=size["sep"], num_experts=experts,
                       dtype=torch.bfloat16 if dtype == "bf16" else torch.float32, fsdp=fsdp,
                       attention_impl=impl, verbose=False)


def _vector(named: dict, names) -> "torch.Tensor":
    import torch

    return torch.cat([named[n].detach().float().flatten().cpu() for n in names])


def _kernel_table(prof):
    """([name, ms, launches] of each device kernel, busy ms: the union of
    their intervals) of a finished torch.profiler session."""
    import torch

    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0 and not getattr(e, "is_user_annotation", False):
            kernels.append([e.key[:120], us / 1e3, e.count])
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    busy_us, reached = 0.0, float("-inf")
    for start, end in spans:
        if end > reached:
            busy_us += end - max(start, reached)
            reached = end
    return kernels, busy_us / 1e3


def _one_rank_update(size: dict, experts: int, dtype: str, weights: dict, batch, device, impl: str = "auto"):
    """The one-rank update the mesh layouts are held to: the clipped
    gradients and the parameters after it, by name."""
    import torch

    from pfn_tpu_torch.train import TrainState, build_model
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step_from_batch

    cfg = _mesh_cfg(size, experts, dtype, impl=impl)
    cfg.device = device
    crit = _mesh_criterion(size, device)
    model = build_model(_BatchPrior, crit, cfg)
    model.load_state_dict(weights)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(0))
    m = make_train_step_from_batch(crit, cfg, schedule)(state, *batch)
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(m["loss"]), "names": names,
            "grads": _vector({n: p.grad for n, p in model.named_parameters()}, names),
            "params": _vector(dict(model.named_parameters()), names)}


def _one_rank_pp_update(size: dict, weights: dict, batch, device):
    """The pipeline's yardstick: the unpipelined model, the same masked loss
    and Adam without a clip (make_pp_train_step's update)."""
    import torch

    from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
    from pfn_tpu_torch.train.loop import _loss_terms

    model = PFNTransformer(TransformerConfig(num_features=1, n_out=size["buckets"], emsize=size["emsize"],
                                             nhead=size["nhead"], nhid=size["nhid"], nlayers=size["nlayers"]))
    model.load_state_dict(weights)
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=size["lr"])
    x, y, ty = (t.to(device) for t in batch)
    sep = torch.full((1,), size["sep"], dtype=torch.int32, device=device)
    num, den = _loss_terms(_mesh_criterion(size, device), model(x, y, sep), ty, sep, None)
    (num / den).backward()
    names = [n for n, _ in model.named_parameters()]
    grads = _vector({n: p.grad for n, p in model.named_parameters()}, names)
    optimizer.step()
    return {"loss": float(num / den), "names": names, "grads": grads,
            "params": _vector(dict(model.named_parameters()), names)}


def _mesh_layout(name: str, payload: dict, device, out_dir: str) -> dict:
    """One layout on this rank: the compared update (its flash launches by
    variant; its gathered gradients and parameters written by the ranks that
    hold them), one more timed by the host clock and CUDA events, and one
    more profiled on rank 0."""
    import os

    import torch
    import torch.distributed as dist

    from pfn_tpu_torch.models import TransformerConfig
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.parallel import PipelinedPFN, make_mesh, make_pp_mesh, make_pp_train_step, to_pipeline_params
    from pfn_tpu_torch.parallel.mesh import blocks_of, gathered_state_dict, load_full_state_dict_, unshard
    from pfn_tpu_torch.parallel.pipeline import from_pipeline_params
    from pfn_tpu_torch.train import TrainConfig, TrainState, build_model
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step_from_batch

    size = payload["size"]
    axes, experts, dtype = MESH_LAYOUTS[name]
    weights = _mesh_weights(size, experts)
    crit = _mesh_criterion(size, device)
    if "pp" in axes:
        mesh = make_pp_mesh(dp=axes["dp"], pp=axes["pp"], device=device)
        mcfg = TransformerConfig(num_features=1, n_out=size["buckets"], emsize=size["emsize"], nhead=size["nhead"],
                                 nhid=size["nhid"], nlayers=size["nlayers"], attention_impl="prefix")
        model = PipelinedPFN(mcfg, mesh, size["pp_micro"]).to(device)
        model.load_state_dict(to_pipeline_params(weights, model), strict=True)
        optimizer = torch.optim.Adam(model.parameters(), lr=size["lr"])
        tcfg = TrainConfig(batch_size=size["pp_batch"], bptt=size["T"], eval_pos_sampler="fixed",
                           fixed_eval_pos=size["sep"], device=device)
        prior = _BatchPrior(*(t.to(device) for t in payload["pp_batch"]))
        step = make_pp_train_step(model, prior, crit, tcfg, optimizer)
        generator = torch.Generator(device=device).manual_seed(0)

        def run():
            return step(generator)

        def gathered():
            holds = mesh.axis_index("dp") == 0
            return (holds, from_pipeline_params({n: p.grad for n, p in model.named_parameters()}, model),
                    from_pipeline_params(dict(model.named_parameters()), model))
    else:
        mesh = make_mesh(**axes, device=device)
        cfg = _mesh_cfg(size, experts, dtype, fsdp=name.startswith("fsdp"))
        cfg.device = device
        model = build_model(_BatchPrior, crit, cfg, mesh=mesh)
        load_full_state_dict_(model, weights)
        optimizer, _, schedule = _make_optimizer(cfg, model)
        state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(0))
        step = make_train_step_from_batch(crit, cfg, schedule)

        def run():
            return step(state, *payload["batch"])

        def gathered():
            specs = model.param_specs
            grads = {n: (unshard(p.grad, mesh, specs[n], blocks_of(n)) if n in specs else p.grad)
                     for n, p in model.named_parameters()}
            return dist.get_rank() == 0, grads, gathered_state_dict(model)

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    loss = float(run()["loss"])
    torch.cuda.synchronize(device)
    launches = {k: _ext.launch_counts[k] for k in FLASH_F32_KERNELS}
    prefix = dict(_ext.prefix_launch_counts)
    holds, grads, params = gathered()
    if holds:
        torch.save({part: {n: t.detach().float().cpu() for n, t in named.items()}
                    for part, named in (("grads", grads), ("params", params))},
                   os.path.join(out_dir, f"{name}.{dist.get_rank()}.pt"))
    del grads, params

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dist.barrier()
    t0 = time.perf_counter()
    start.record()
    float(run()["loss"])
    end.record()
    torch.cuda.synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    profile = None
    dist.barrier()
    if dist.get_rank() == 0:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(run()["loss"])
            torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels, busy_ms = _kernel_table(prof)
        kernels.sort(key=lambda kn: -kn[1])
        profile = {"wall_ms": wall_ms, "device_ms": busy_ms if kernels else "not measured",
                   "idle_share": 1.0 - busy_ms / wall_ms if kernels else "not measured",
                   "flash_kernels": [kn for kn in kernels if "f32<" in kn[0] or "sm90<" in kn[0]][:6],
                   "kernels": kernels[:8]}
    else:
        float(run()["loss"])
    return {"rank": dist.get_rank(), "coords": dict(mesh.coords), "loss": loss, "launches": launches,
            "launches_prefix": prefix, "host_ms": host_ms, "event_ms": event_ms, "peak_memory_gb": peak_gb,
            "profile": profile}


def _mesh_rank(rank: int, world: int, port: int, payload: dict, out_dir: str) -> None:
    """A rank of the mesh phase: a gloo group on the one card, every layout
    in turn; its results to ``out_dir``."""
    import os

    import torch
    import torch.distributed as dist

    from pfn_tpu_torch.parallel import init_distributed

    device = init_distributed(backend="gloo", device=payload["device_type"], init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        results = {name: _mesh_layout(name, payload, device, out_dir) for name in MESH_LAYOUTS}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh(device, smi: str, size: dict = MESH):
    """Every layout of MESH_LAYOUTS on four ranks that share the one card (a
    gloo group carrying CUDA tensors, the ranks started with spawn, one
    spawn for all layouts), each update held against the one-rank update of
    the same weights and batch on the card. Returns (the one-rank f32
    reference of the dense layouts, the flash launches of all ranks by
    kernel, the prefix variant's of them)."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from pfn_tpu_torch.experiments.common import GP_HP
    from pfn_tpu_torch.priors import GPPrior

    T, B = size["T"], size["batch_size"]
    prior = GPPrior(num_features=1, **GP_HP)
    g = torch.Generator(device=device).manual_seed(23)
    x, y, ty = prior.sample(B, T, generator=g, device=device)
    batch = tuple(t[None].cpu() for t in (x, y, ty))  # one microbatch
    pp_batch = tuple(t.cpu() for t in prior.sample(size["pp_batch"], T, generator=g, device=device))

    dense, moe = _mesh_weights(size, 0), _mesh_weights(size, size["experts"])
    t0 = time.perf_counter()
    refs = {"dense": _one_rank_update(size, 0, "f32", dense, batch, device),
            "moe": _one_rank_update(size, size["experts"], "f32", moe, batch, device),
            "pp": _one_rank_pp_update(size, dense, pp_batch, device),
            "probe": _one_rank_update(size, 0, "f32", _value_probe(dense, size["emsize"], F32_PATH_PROBE), batch,
                                      device),
            "dense_bf16": _one_rank_update(size, 0, "bf16", dense, batch, device, impl="dense")}
    refs_s = time.perf_counter() - t0
    del dense, moe

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pfn_mesh_") as out_dir:
        payload = {"size": size, "batch": batch, "pp_batch": pp_batch, "device_type": device.type}
        ctx = mp.start_processes(_mesh_rank, args=(size["world"], _free_port(), payload, out_dir),
                                 nprocs=size["world"], join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while not ctx.join(timeout=1):  # a failing rank raises here, with its traceback
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"mesh ranks ran past {MESH_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(size["world"])]
        vectors = {}
        for name in MESH_LAYOUTS:  # the gathered state, merged over the ranks that wrote a part (pp: each stage)
            merged = {"grads": {}, "params": {}}
            for f in sorted(f for f in os.listdir(out_dir) if f.startswith(name + ".")):
                for part, named in torch.load(os.path.join(out_dir, f), weights_only=True).items():
                    merged[part].update(named)
            vectors[name] = merged
    spawn_s = time.perf_counter() - t0

    def rel(a, b) -> float:
        return float((a.double() - b.double()).norm() / b.double().norm())

    def layout_vectors(name: str, ref: dict):
        """(grads, params) of a layout in the reference's name order."""
        return tuple(_vector(vectors[name][part], ref["names"]) for part in ("grads", "params"))

    reach = rel(refs["probe"]["grads"], refs["dense"]["grads"])
    gold = refs["dense"]["grads"]
    dense_bf16_err = rel(refs["dense_bf16"]["grads"], gold)
    per_layer = size["nlayers"]
    layouts, checks = {}, {"probe_shows": reach > MESH_TOL}
    for name, (axes, experts, dtype) in MESH_LAYOUTS.items():
        ref = refs["pp" if "pp" in axes else "moe" if experts else "dense"]
        grads, params = layout_vectors(name, ref)
        rows = [r[name] for r in ranks]
        if "pp" in axes:
            want = {k: per_layer // axes["pp"] * size["pp_micro"] for k in FLASH_F32_KERNELS}
            want_prefix = want
        else:
            want = {k: per_layer for k in FLASH_F32_KERNELS}
            want_prefix = want if "sp" in axes else {k: 0 for k in FLASH_F32_KERNELS}
        entry = {"axes": axes, "experts": experts, "dtype": dtype, "loss": [r["loss"] for r in rows],
                 "launches_per_rank": rows[0]["launches"], "launches_prefix_per_rank": rows[0]["launches_prefix"],
                 "host_ms": [r["host_ms"] for r in rows], "event_ms": [r["event_ms"] for r in rows],
                 "peak_memory_gb": [r["peak_memory_gb"] for r in rows], "profile_rank0": rows[0]["profile"]}
        if dtype == "f32":
            entry.update(grads_rel=rel(grads, ref["grads"]), params_rel=rel(params, ref["params"]),
                         one_rank_loss=ref["loss"])
            ok = entry["grads_rel"] <= MESH_TOL and entry["params_rel"] <= MESH_TOL
        else:
            entry.update(grads_err=rel(grads, gold), dense_bf16_err=dense_bf16_err,
                         budget=2 * dense_bf16_err + 1e-3)
            ok = entry["grads_err"] <= entry["budget"]
        checks[f"{name}_matches_one_rank"] = ok
        checks[f"{name}_launches"] = all(r["launches"] == want and r["launches_prefix"] == want_prefix for r in rows)
        checks[f"{name}_loss_replicated"] = len({r["loss"] for r in rows}) == 1
        layouts[name] = entry
    launches = {k: sum(r[name]["launches"][k] for r in ranks for name in MESH_LAYOUTS) for k in FLASH_F32_KERNELS}
    prefix = {k: sum(r[name]["launches_prefix"][k] for r in ranks for name in MESH_LAYOUTS) for k in FLASH_F32_KERNELS}
    emit({"phase": "mesh", "card": smi, "size": size, "ranks_share_one_card": True, "backend": "gloo",
          "note": "four ranks on one card: times are not a collective's speed", "tol": MESH_TOL,
          "probe": F32_PATH_PROBE, "probe_rel_change": reach, "one_rank_s": refs_s, "spawn_s": spawn_s,
          "layouts": layouts, "launches_compared_updates": launches, "launches_prefix": prefix, "checks": checks})
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh checks failed: {failed}")
    return refs["dense"], batch, launches, prefix


def phase_mesh_nccl(device, smi: str, reference: dict, batch, size: dict = MESH):
    """World size 1 on NCCL, started from torchrun's environment variables:
    the dp path's update at the mesh phase's dense f32 config, against the
    one-rank update the mesh phase made; NCCL's all_gather and all_to_all on
    the card. The process group ends with the phase, and the environment is
    restored."""
    import os

    import torch
    import torch.distributed as dist

    from pfn_tpu_torch.parallel import init_distributed, make_mesh
    from pfn_tpu_torch.parallel.mesh import gathered_state_dict, load_full_state_dict_
    from pfn_tpu_torch.train import TrainState, build_model
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step_from_batch

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rank_device = init_distributed()
        try:
            mesh = make_mesh()
            cfg = _mesh_cfg(size, 0, "f32")
            cfg.device = rank_device
            crit = _mesh_criterion(size, rank_device)
            model = build_model(_BatchPrior, crit, cfg, mesh=mesh)
            load_full_state_dict_(model, _mesh_weights(size, 0))
            optimizer, _, schedule = _make_optimizer(cfg, model)
            state = TrainState(model, optimizer, torch.Generator(device=rank_device).manual_seed(0))
            t0 = time.perf_counter()
            loss = float(make_train_step_from_batch(crit, cfg, schedule)(state, *batch)["loss"])
            update_ms = (time.perf_counter() - t0) * 1e3
            names = reference["names"]
            grads = _vector({n: p.grad for n, p in model.named_parameters()}, names)
            params = _vector(gathered_state_dict(model), names)
            t = torch.arange(4.0, device=rank_device)
            out = [torch.empty_like(t)]
            dist.all_gather(out, t)
            a2a = torch.empty_like(t)
            dist.all_to_all_single(a2a, t)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    checks = {
        "backend_nccl": backend == "nccl",
        "mesh_shape": mesh.shape == {"dp": 1, "sp": 1, "tp": 1, "ep": 1},
        "device": rank_device.type == "cuda",
        "grads_equal": bool(torch.equal(grads, reference["grads"])),
        "params_equal": bool(torch.equal(params, reference["params"])),
        "loss_equal": loss == reference["loss"],
        "nccl_all_gather": bool(torch.equal(out[0], t)),
        "nccl_all_to_all": bool(torch.equal(a2a, t)),
    }
    emit({"phase": "mesh_nccl", "card": smi, "backend": backend, "world_size": 1, "update_ms": update_ms,
          "loss": loss, "checks": checks})
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh_nccl checks failed: {failed}")


def phase_moe(device, smi: str, size: dict = MOE):
    """MoE at the Fig-3a width on one card, bf16, no mesh, through
    train(...): 2 epochs of 2 updates straight (no warmup: epoch 1 trains),
    and epoch 1 into a checkpoint then a resumed epoch 2, bitwise equal; the flash kernels
    launched once per layer per update; the load-balancing loss finite; a
    forward on the kernel path against the dense path (the bf16 rule
    against an f32 gold); update time, datasets/s, peak memory. Returns the
    flash launches of the straight run."""
    import tempfile

    import numpy as np
    import torch

    from pfn_tpu_torch.experiments.common import GP_HP, bucket_criterion
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior
    from pfn_tpu_torch.train import TrainConfig, build_model, train

    T, B = size["T"], size["batch_size"]
    prior = GPPrior(num_features=1, **GP_HP)
    criterion = bucket_criterion(prior, size["buckets"], T, device)
    cfg = TrainConfig(emsize=size["emsize"], nhid=size["nhid"], nlayers=size["nlayers"], nhead=size["nhead"], bptt=T,
                      batch_size=B, epochs=2, steps_per_epoch=size["updates"], lr=size["lr"], warmup_epochs=0,
                      eval_pos_sampler="weighted", eval_pos_max=min(2000, T), dtype=torch.bfloat16,
                      num_experts=size["experts"], device=device, seed=0)
    init = _mesh_weights(size, size["experts"])
    torch.cuda.reset_peak_memory_stats(device)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    straight, _ = _quietly(lambda: train(prior, criterion, cfg, init_params=init))
    train_s = time.perf_counter() - t0
    launches = {k: _ext.launch_counts[k] for k in FLASH_F32_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    ckdir = tempfile.mkdtemp(prefix="pfn_moe_")
    ck = dataclasses.replace(cfg, checkpoint_dir=ckdir, checkpoint_every=1)
    _quietly(lambda: train(prior, criterion, dataclasses.replace(ck, epochs=1), init_params=init))
    resumed, log = _quietly(lambda: train(prior, criterion, ck, init_params=init))
    bitwise = all(torch.equal(a, b) for a, b in zip(straight.model.state_dict().values(),
                                                   resumed.model.state_dict().values()))

    # The load-balancing loss and a forward, kernel path against dense.
    x, y, _ = prior.sample(B, T, generator=torch.Generator(device=device).manual_seed(3), device=device)
    sep = torch.full((1,), T // 2, dtype=torch.int32, device=device)
    outs = {}
    for name, over in (("kernel_bf16", {}), ("dense_bf16", {"attention_impl": "dense"}),
                       ("dense_f32", {"attention_impl": "dense", "dtype": torch.float32})):
        model = build_model(prior, criterion, dataclasses.replace(cfg, **over))
        model.load_state_dict(straight.model.state_dict())
        with torch.no_grad():
            outs[name] = model.eval()(x, y, sep, return_aux=True)
    aux = float(outs["kernel_bf16"][1])
    err = {name: float((outs[name][0].float() - outs["dense_f32"][0]).norm() / outs["dense_f32"][0].norm())
           for name in ("kernel_bf16", "dense_bf16")}

    step, state, update_ms, median_ms = timed_updates(prior, criterion, cfg, straight.model, device,
                                                      size["timed_updates"])
    expected = cfg.nlayers * 2 * size["updates"]
    stats = straight.epoch_stats
    checks = {
        "epochs": [st["epoch"] for st in stats] == [1, 2],
        "losses_finite": all(np.isfinite(st["mean_loss"]) and np.isfinite(st["grad_norm"]) for st in stats),
        "launches": all(n == expected for n in launches.values()),
        # Epoch 1 trains at a nonzero lr, so the checkpoint holds moved weights and Adam moments.
        "epoch_1_lr_nonzero": stats[0]["lr"] > 0,
        "resumed": "resumed from" in log,
        "resume_bitwise": bitwise,
        "aux_finite": bool(np.isfinite(aux)) and aux > 0,
        "kernel_vs_dense_forward": err["kernel_bf16"] <= 2 * err["dense_bf16"] + 1e-3,
    }
    emit({"phase": "moe", "card": smi, "size": size, "dtype": "bf16", "epoch_stats": stats, "train_s": train_s,
          "launches": launches, "expected_launches": expected, "aux_loss": aux, "forward_rel_err_vs_f32": err,
          "update_ms": {"first": update_ms[0], f"median_of_{size['timed_updates']}": median_ms},
          "datasets_per_s": B / (median_ms / 1e3), "peak_memory_gb": peak_gb, "checks": checks})
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"moe checks failed: {failed}")
    return launches


def _launch_delta(before: dict) -> dict:
    """Launches of every kernel since the ``before`` reading of the counts."""
    from pfn_tpu_torch.ops import _ext

    return {k: _ext.launch_counts[k] - before[k] for k in _ext.launch_counts}


def _finite_positive(values) -> bool:
    import math

    return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values)


def phase_profile_step(device, smi: str, configs: dict = PROFILE_STEP_CONFIGS):
    """pfn_tpu_torch.experiments.profile_step at each of PROFILE_STEP_CONFIGS
    (the Fig-3a microbatch, the flagship): its stage times, the JAX
    formula's roofline share at 989 TFLOP/s, the card it read; the flash
    kernels launched once per layer per forward and per backward of its
    stages (the dense path at T 100). Returns the phase's launches."""
    import tempfile

    from pfn_tpu_torch.experiments import profile_step
    from pfn_tpu_torch.experiments.common import FIG3A_MODEL
    from pfn_tpu_torch.ops import _ext

    tmp = Path(tempfile.mkdtemp(prefix="pfn_profile_"))
    readings, launches, expected, seconds = {}, {}, {}, {}
    _ext.reset_launch_counts()
    for name, argv in configs.items():
        before = dict(_ext.launch_counts)
        t0 = time.perf_counter()
        readings[name], _ = _quietly(profile_step.main, ["--device", str(device), *argv,
                                                          "--out", str(tmp / f"{name}.json")])
        seconds[name] = time.perf_counter() - t0
        launches[name] = _launch_delta(before)
        # Forward: its own stage, the forward + backward stage and the extra
        # call that gives the optimizer stage its gradients, the full step;
        # backward: the last three.
        n, L, flash = profile_step.WARMUP + profile_step.REPS, FIG3A_MODEL["nlayers"], readings[name]["bptt"] >= 256
        expected[name] = {k: 0 for k in _ext.launch_counts}
        if flash:
            expected[name].update({"pfn_flash_fwd": L * (3 * n + 1), "pfn_flash_bwd_dq": L * (2 * n + 1),
                                   "pfn_flash_bwd_dkv": L * (2 * n + 1)})
    stages = ("prior_sample_ms", "forward_ms", "fwd_bwd_ms", "optimizer_ms", "full_step_ms")
    checks = {
        "stages_finite_positive": all(_finite_positive([r[k] for k in stages]) for r in readings.values()),
        "roofline_finite_positive": all(_finite_positive(list(r["roofline"].values())) for r in readings.values()),
        "fig3a_params": readings["fig3a_microbatch"]["params_m"] == 23.394064,
        "card_read": all(r["card"] == smi for r in readings.values()),
        "launches": launches == expected,
    }
    emit({"phase": "profile_step", "card": smi, "readings": readings, "seconds": seconds, "launches": launches,
          "expected_launches": expected, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"profile_step checks failed: {failed}")
    return {k: sum(run[k] for run in launches.values()) for k in _ext.launch_counts}


def _by_chunks(fn, chunk: int, *tensors):
    """fn over ``chunk`` rows at a time of the leading dim of ``tensors``,
    each output (a tensor or a tuple of tensors) joined along it: the plain
    f32 versions at B*H 400 without the whole (B*H, T, T) scores at once."""
    import torch

    parts = [fn(*(t[i:i + chunk] for t in tensors)) for i in range(0, tensors[0].shape[0], chunk)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _hold_flash_bf16(device, B: int, sep: int, size: dict, g) -> dict:
    """bf16 kernels 1-3 at B datasets of ``size``'s heads, T and D, at sep:
    the forward by the bf16 budget (kernel_timing's rule), dq and dk/dv by
    kernel_bwd's rule against the plain dense f32 version (run by chunks
    of datasets), repeat calls bitwise equal; each kernel's ms by events
    beside its bound."""
    import torch

    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.attention import pfn_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd, _flash_fwd_plain

    H, T, D, chunk = size["H"], size["T"], size["D"], size["chunk"]
    BH, where = B * H, f"batch_sweep hold, B*H {B * H}, sep {sep}"
    q, k, v, do4 = (torch.randn(B, H, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(4))
    qs = (q * D**-0.5).reshape(BH, T, D)
    kf, vf, do = k.reshape(BH, T, D), v.reshape(BH, T, D), do4.reshape(BH, T, D)
    sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
    o, lse = _flash_fwd(qs, kf, vf, sep_t, True)
    o2, lse2 = _flash_fwd(qs, kf, vf, sep_t, True)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{where}: a repeat forward call differs")
    with torch.no_grad():
        gold = _by_chunks(lambda a, b, c: pfn_attention_reference(a.float(), b.float(), c.float(), sep), chunk, q, k, v)
        dense = _by_chunks(lambda a, b, c: pfn_attention_reference(a, b, c, sep), chunk, q, k, v)
    fwd_err = max_abs(o.reshape(B, H, T, D), gold)
    fwd_budget = 2 * max_abs(dense, gold) + 1e-3
    del gold, dense
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = _repeat_bitwise(qs, kf, vf, do, lse, delta, sep_t, True, where)

    def gold_bwd(a, b, c, d):
        f32 = [t.float() for t in (a, b, c)]
        o32, lse32 = _flash_fwd_plain(*f32, sep, T, True)
        return _flash_bwd_plain(*f32, o32, lse32, d.float(), None, sep, T, True)

    def dense_bwd(a, b, c, d):
        leaves = [t.detach().requires_grad_() for t in (a, b, c)]
        loss = (pfn_attention_reference(*leaves, sep, scale=1.0).float() * d.float()).sum()
        return torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        gold_g = _by_chunks(gold_bwd, chunk * H, qs, kf, vf, do)
    dense_g = _by_chunks(dense_bwd, chunk, *(t.reshape(B, H, T, D) for t in (qs, kf, vf)), do4)
    errs = _grad_errors((dq, dk, dv), gold_g, [t.reshape(BH, T, D) for t in dense_g])
    del gold_g, dense_g
    if fwd_err > fwd_budget or not _bf16_ok(errs):
        raise AssertionError(f"{where}: bf16 error over budget: forward {fwd_err} (budget {fwd_budget}), {errs}")
    ms = {"fwd": cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, True)),
          "dq": cuda_ms(lambda: _ext.flash_bwd_dq(qs, kf, vf, do, lse, delta, sep_t, True)),
          "dkv": cuda_ms(lambda: _ext.flash_bwd_dkv(qs, kf, vf, do, lse, delta, sep_t, True))}
    return {"BH": BH, "sep": sep, "fwd_bf16_err": fwd_err, "fwd_bf16_budget": fwd_budget, "bwd_bf16_rel_err": errs,
            "repeat_bitwise_equal": True,
            **{kind: {"ms": ms[kind], **flash_bound(kind, BH, T, D, sep), **rate(kind, BH, T, D, sep, ms[kind])}
               for kind in ("fwd", "dq", "dkv")}}


def phase_batch_sweep(device, smi: str, hold: dict = SWEEP_HOLD, size: dict = MEASURE):
    """First the bf16 flash kernels at the sweep's largest and smallest
    microbatch (``_hold_flash_bf16`` at SWEEP_HOLD); then
    pfn_tpu_torch.experiments.batch_shape_sweep's main, all six shapes at
    the full width and T 2010 (exact GP prior, 1000 buckets, bf16),
    ``size["epochs_timed"]`` epoch-equivalents each: every shape must time (a
    "failed: ..." entry fails the phase), s/epoch and peak memory a shape,
    the flash kernels once per layer per microbatch. Returns the sweep's
    launches."""
    import tempfile

    import torch

    from pfn_tpu_torch.experiments import batch_shape_sweep
    from pfn_tpu_torch.experiments.common import FIG3A_MODEL
    from pfn_tpu_torch.ops import _ext

    g = torch.Generator(device=device).manual_seed(5)
    t0 = time.perf_counter()
    holds = [_hold_flash_bf16(device, B, sep, hold, g) for B in hold["batches"] for sep in hold["seps"]]
    hold_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    peak_gib = {}
    real = batch_shape_sweep.time_config

    def time_config(batch_size, agg, bptt, epochs, dev):
        torch.cuda.reset_peak_memory_stats(dev)
        s = real(batch_size, agg, bptt, epochs, dev)
        peak_gib[f"{batch_size}x{agg}"] = torch.cuda.max_memory_allocated(dev) / 2**30
        return s

    out = Path(tempfile.mkdtemp(prefix="pfn_sweep_")) / "batch_sweep.json"
    _ext.reset_launch_counts()
    batch_shape_sweep.time_config = time_config
    t0 = time.perf_counter()
    try:
        payload, log = _quietly(batch_shape_sweep.main, ["--device", str(device), "--bptt", str(size["bptt"]),
                                                         "--epochs_timed", str(size["epochs_timed"]),
                                                         "--out", str(out)])
    finally:
        batch_shape_sweep.time_config = real
    sweep_s = time.perf_counter() - t0
    launches = dict(_ext.launch_counts)
    per_shape = FIG3A_MODEL["nlayers"] * (2 + 4 * size["epochs_timed"])  # 2 warm-up updates
    microbatches = sum(agg for _, agg in batch_shape_sweep.SHAPES)
    expected = {k: per_shape * microbatches if k in FLASH_F32_KERNELS else 0 for k in launches}
    shapes = [f"{b}x{agg}" for b, agg in batch_shape_sweep.SHAPES]
    checks = {
        "every_shape_timed": set(payload["s_per_epoch"]) == set(shapes)
        and _finite_positive([payload["s_per_epoch"][s] for s in shapes]),
        "launches": launches == expected,
    }
    emit({"phase": "batch_sweep", "card": smi, "holds": holds, "hold_s": hold_s,
          "s_per_epoch": payload["s_per_epoch"], "winner": payload["winner"], "peak_memory_gib": peak_gib,
          "epochs_timed": size["epochs_timed"], "sweep_s": sweep_s, "launches": launches, "expected_launches": expected,
          "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print(log, flush=True)
        raise AssertionError(f"batch_sweep checks failed: {failed}")
    return launches


def phase_anomaly(device, smi: str, size: dict = MEASURE):
    """pfn_tpu_torch.experiments.anomaly_10x10's main at the full width, T
    2010: the step shapes 4x25, 10x10, 20x5 (``size["epochs_timed"]``
    each), then the flash attention alone and the exact GP prior alone at B
    4, 10, 20 and 25 (``size["reps_timed"]`` repeats of 100 datasets); every entry timed; the
    flash kernels once per layer per microbatch of the steps and once per
    attention call. Returns the phase's launches."""
    import tempfile

    from pfn_tpu_torch.experiments import anomaly_10x10
    from pfn_tpu_torch.experiments.common import FIG3A_MODEL
    from pfn_tpu_torch.ops import _ext

    out = Path(tempfile.mkdtemp(prefix="pfn_anomaly_")) / "anomaly_10x10.json"
    epochs_timed, reps_timed = size["epochs_timed"], size["reps_timed"]
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    res, log = _quietly(anomaly_10x10.main, ["--device", str(device), "--bptt", str(size["bptt"]), "--epochs_timed",
                                             str(epochs_timed), "--reps_timed", str(reps_timed), "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = dict(_ext.launch_counts)
    steps = FIG3A_MODEL["nlayers"] * (2 + 4 * epochs_timed) * sum(agg for _, agg in anomaly_10x10.STEP_SHAPES)
    attn = sum(1 + reps_timed * (100 // b) for b in anomaly_10x10.ATTN_BATCHES)  # a warm-up call each
    expected = {k: steps + attn if k in FLASH_F32_KERNELS else 0 for k in launches}
    tables = ("step_s_per_epoch", "attn_s_per_100ds", "prior_s_per_100ds")
    checks = {
        "every_entry_timed": all(_finite_positive(list(res[t].values())) for t in tables)
        and [len(res[t]) for t in tables] == [3, 4, 4],
        "launches": launches == expected,
    }
    emit({"phase": "anomaly", "card": smi, **{t: res[t] for t in tables}, "epochs_timed": epochs_timed,
          "reps_timed": reps_timed, "seconds": seconds, "launches": launches, "expected_launches": expected,
          "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print(log, flush=True)
        raise AssertionError(f"anomaly checks failed: {failed}")
    return launches


def phase_fused_ab(device, smi: str, size: dict = MEASURE):
    """pfn_tpu_torch.experiments.fused_ab's main at the flagship (grid 2048,
    ``size["ab_steps"]`` timed calls of 25 updates after 3): auto (dense at T 100),
    fused (kernels 4-6), auto again and the speedup; then
    flagship_throughput's main once: the flagship on the exact sampler
    (grid 0) and the reference-style stock-torch pipeline on the card. The
    fused kernels once per layer per update of the fused run, no flash
    kernel. Returns the phase's launches."""
    import tempfile

    from pfn_tpu_torch.experiments import flagship_throughput, fused_ab
    from pfn_tpu_torch.experiments.common import FIG3A_MODEL
    from pfn_tpu_torch.ops import _ext

    steps, baseline_steps = size["ab_steps"], size["baseline_steps"]
    out = Path(tempfile.mkdtemp(prefix="pfn_fused_ab_")) / "fused_ab.json"
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    ab, _ = _quietly(fused_ab.main, ["--device", str(device), "--steps", str(steps), "--out", str(out)])
    ab_s = time.perf_counter() - t0
    launches = dict(_ext.launch_counts)
    t0 = time.perf_counter()
    flagship, _ = _quietly(flagship_throughput.main, ["--device", str(device), "--grid", "0", "--steps", str(steps),
                                                      "--baseline_steps", str(baseline_steps),
                                                      "--attention_impl", "auto"])
    flagship_s = time.perf_counter() - t0
    # measure_pfn_torch's 3 warm-up calls, then ``steps``, of 25 updates.
    fused_calls = FIG3A_MODEL["nlayers"] * (3 + steps) * ab["config"]["updates_per_call"]
    expected = {k: fused_calls if k.startswith("pfn_fused") else 0 for k in launches}
    checks = {
        "readings_finite_positive": _finite_positive([ab[k] for k in ("baseline_a", "fused", "baseline_b", "speedup")]
                                                     + [flagship[k] for k in ("prior_batches_per_sec",
                                                                              "torch_baseline_prior_batches_per_sec")]),
        "speedup_formula": ab["speedup"] == ab["fused"] / (0.5 * (ab["baseline_a"] + ab["baseline_b"])),
        "launches": launches == expected,
        "no_launch_outside_the_fused_run": _launch_delta(launches) == {k: 0 for k in launches},
    }
    emit({"phase": "fused_ab", "card": smi, "prior_batches_per_s": {k: ab[k] for k in ("baseline_a", "fused",
                                                                                          "baseline_b")},
          "speedup": ab["speedup"], "config": ab["config"], "ab_s": ab_s,
          "flagship_exact_prior_batches_per_s": flagship["prior_batches_per_sec"],
          "torch_baseline_prior_batches_per_s": flagship["torch_baseline_prior_batches_per_sec"],
          "torch_baseline_steps": baseline_steps, "flagship_s": flagship_s, "launches": launches,
          "expected_launches": expected, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fused_ab checks failed: {failed}")
    return launches


def main() -> int:
    import torch

    import pfn_tpu_torch

    t_run = time.perf_counter()
    if Path(pfn_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"pfn_tpu_torch at {pfn_tpu_torch.__file__} is not the checkout beside this script")
    device, smi = phase_card()
    phase_build()
    phase_kernel_cases(device)
    timing, _ = phase_kernel_timing(device, smi)
    phase_kernel_bwd_cases(device)
    phase_item_attention(device)
    bwd_timing, bwd_prefix = phase_kernel_bwd_timing(device, smi)
    phase_slice(device, smi)
    launches = phase_train(device, smi)
    phase_fused_kernel(device)
    fused_timing = phase_fused_timing(device, smi)
    phase_fused_bwd_kernel(device)
    fused_bwd_timing = phase_fused_bwd_timing(device, smi)
    fused_f32 = phase_fused_f32_timing(device, smi)
    fused_launches, _ = phase_fused_path(device, smi)
    fused_train_launches = phase_fused_train(device, smi)
    # The fused layer's f32 bodies on their path: the f32 rows' launches.
    fused_f32_launches = phase_fused_train(device, smi, f32=True)
    for part, name in (("fwd", "pfn_fused_layer_fwd"), ("ffn", "pfn_fused_layer_bwd_ffn"),
                       ("attn", "pfn_fused_layer_bwd_attn")):
        fused_f32[part]["launches"] = fused_f32_launches[name]
    library = phase_library_timing(device, smi)
    phase_tabular(device, smi)
    tabular_timing = f32_kernel_timing(device, smi, "tabular_kernel_timing", TABULAR_KERNEL_SHAPE)
    phase_dispatch(device, smi)
    f32_long = f32_kernel_timing(device, smi, "f32_long_timing", F32_LONG_SHAPE)
    # The f32 bodies' launches on their path: the f32 rows of the kernels line.
    f32_launches = phase_f32_path(device, smi)
    # The front door's run (a) launches the f32 bodies too: its launches join
    # both the f32 rows and the kernels' launches on the main paths.
    front_launches = phase_front_door(device, smi)
    for name, kind in zip(FLASH_F32_KERNELS, ("fwd", "dq", "dkv")):
        f32_long[kind]["launches"] = f32_launches[name] + front_launches[name]
    # The Bayesian comparison's path runs the f32 bodies at D 64, T 300: its
    # launches are the f32_comparison rows'.
    comparison_launches = phase_comparison(device, smi)
    comparison_timing = f32_kernel_timing(device, smi, "f32_comparison_timing", COMPARISON_KERNEL_SHAPE)
    for name, kind in zip(FLASH_F32_KERNELS, ("fwd", "dq", "dkv")):
        comparison_timing[kind]["launches"] = comparison_launches[name]
    phase_tabular_baselines(device, smi)
    fig3a_launches = phase_fig3a(device, smi)
    phase_fewshot(device, smi)
    # Scoring 2048 candidates runs the flash forward's f32 body at head dim
    # 32: the f32_bayesopt row of the kernels line.
    bayesopt_row, bayesopt_launches = phase_bayesopt(device, smi)
    phase_gp_mix_oracles(device, smi)
    # The compat workflow trains at T 2010 in f32: its launches join the
    # f32_long rows and the kernels' launches on the main paths.
    compat_launches = phase_compat(device, smi)
    for name, kind in zip(FLASH_F32_KERNELS, ("fwd", "dq", "dkv")):
        f32_long[kind]["launches"] += compat_launches[name]
    phase_native_cache(device, smi)
    phase_debug_checks(device, smi)
    # The parallel layer: four ranks sharing the card (the prefix variants'
    # first path launches), NCCL at world size 1, and MoE on one card.
    mesh_reference, mesh_batch, mesh_launches, mesh_prefix = phase_mesh(device, smi)
    phase_mesh_nccl(device, smi, mesh_reference, mesh_batch)
    moe_launches = phase_moe(device, smi)
    # The measurement drivers: their flash and fused launches join the
    # kernels' launches on the main paths.
    measure_launches = [phase_profile_step(device, smi), phase_batch_sweep(device, smi), phase_anomaly(device, smi),
                        phase_fused_ab(device, smi)]
    measured = {k: sum(m[k] for m in measure_launches) for k in measure_launches[0]}
    # The flash kernels' launches on the main paths: the train phase's, the
    # fig3a phase's, the front door's run (a), the comparison's, the compat
    # workflow's, the mesh layouts' compared updates (all ranks), the MoE
    # run's, the measurement drivers' and the forward's in the BO scoring at
    # 2048 candidates (the tabular, few-shot and BO-loop paths run dense at T
    # < 256). The prefix
    # variant's launches (launches_prefix) come from the mesh phase's sp and
    # pp layouts.
    flash_launches = {name: launches[name] + fig3a_launches[name] + front_launches[name] + comparison_launches[name]
                      + compat_launches[name] + mesh_launches[name] + moe_launches[name] + measured[name]
                      for name in FLASH_F32_KERNELS}
    flash_launches["pfn_flash_fwd"] += bayesopt_launches
    fwd = next(r for r in timing if r["sep"] == 1000)
    bwd = next(r for r in bwd_timing if r["sep"] == 1000)
    fused = next(r for r in fused_timing if r["sep"] == FLAGSHIP["sep"])
    fused_bwd = next(r for r in fused_bwd_timing if r["sep"] == FLAGSHIP["sep"])
    bwd_source = "pfn_tpu_torch/ops/csrc/pfn_flash_bwd.cu"
    fused_bwd_source = "pfn_tpu_torch/ops/csrc/pfn_fused_layer_bwd.cu"
    # The dk/dv kernel against SDPA's backward with the same mask (dq, dk and
    # dv in one call) less the dq kernel, all from this run.
    emit({"phase": "dkv_against_library", "card": smi, "sep": 1000, **{
        variant: {"dkv_ms": row["dkv_ms"], "sdpa_bwd_minus_dq_ms": library[key] - row["dq_ms"],
                  "held": row["dkv_ms"] <= library[key] - row["dq_ms"]}
        for variant, row, key in (("diag", bwd, "sdpa_bwd_ms"), ("prefix", bwd_prefix, "sdpa_prefix_bwd_ms"))}})
    emit({"phase": "profiler", "sessions_without_kernels": profile_misses, "pad_s": PROFILE_PAD_S})
    emit({"phase": "run", "seconds": time.perf_counter() - t_run})
    emit({"kernels": [
        {"name": "pfn_flash_fwd", "route": "cuda", "design": SM90_DESIGN,
         "source": "pfn_tpu_torch/ops/csrc/pfn_flash_fwd.cu",
         "replaces": "pfn_tpu/ops/flash_attention.py:255", "launches": flash_launches["pfn_flash_fwd"],
         "launches_prefix": mesh_prefix["pfn_flash_fwd"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["kernel_ms"], "plain_ms": fwd["plain_ms"],
         **flash_bound("fwd", 32, 2010, 128, 1000), "library_ms": library["sdpa_fwd_ms"],
         "f32_tabular": tabular_timing["fwd"], "f32_long": f32_long["fwd"], "f32_long_prefix": f32_long["fwd_prefix"],
         "f32_comparison": comparison_timing["fwd"],
         "f32_bayesopt": {**{k: bayesopt_row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms", "pct_of_bound", "gflop")},
                          "launches": bayesopt_launches}},
        {"name": "pfn_flash_bwd_dq", "route": "cuda", "design": SM90_DESIGN, "source": bwd_source,
         "replaces": "pfn_tpu/ops/flash_attention.py:315", "launches": flash_launches["pfn_flash_bwd_dq"],
         "launches_prefix": mesh_prefix["pfn_flash_bwd_dq"],
         "max_abs_err": bwd["max_abs_err"]["dq"], "ms": bwd["dq_ms"], "plain_ms": bwd["plain_ms"],
         **flash_bound("dq", 16, 2010, 128, 1000), "library_ms": library["sdpa_bwd_ms"],
         "f32_tabular": tabular_timing["dq"], "f32_long": f32_long["dq"], "f32_long_prefix": f32_long["dq_prefix"],
         "f32_comparison": comparison_timing["dq"]},
        {"name": "pfn_flash_bwd_dkv", "route": "cuda", "design": SM90_DESIGN, "source": bwd_source,
         "replaces": "pfn_tpu/ops/flash_attention.py:340", "launches": flash_launches["pfn_flash_bwd_dkv"],
         "launches_prefix": mesh_prefix["pfn_flash_bwd_dkv"],
         "max_abs_err": max(bwd["max_abs_err"]["dk"], bwd["max_abs_err"]["dv"]), "ms": bwd["dkv_ms"],
         "plain_ms": bwd["plain_ms"], **flash_bound("dkv", 16, 2010, 128, 1000),
         "library_ms": library["sdpa_bwd_ms"], "f32_tabular": tabular_timing["dkv"], "f32_long": f32_long["dkv"],
         "f32_long_prefix": f32_long["dkv_prefix"], "f32_comparison": comparison_timing["dkv"]},
        {"name": "pfn_fused_layer_fwd", "route": "cuda", "design": SM90_DESIGN,
         "source": "pfn_tpu_torch/ops/csrc/pfn_fused_layer_fwd.cu",
         "replaces": "pfn_tpu/ops/fused_layer.py:324", "launches": fused_launches + measured["pfn_fused_layer_fwd"],
         "max_abs_err": fused["max_abs_err"], "ms": fused["kernel_ms"], "dev_ms": fused["kernel_dev_ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": fused["unfused_layer_ms"], "library_dev_ms": fused["unfused_layer_dev_ms"],
         "f32": fused_f32["fwd"]},
        *({"name": f"pfn_fused_layer_bwd_{part}", "route": "cuda", "design": SM90_DESIGN, "source": fused_bwd_source,
           "replaces": f"pfn_tpu/ops/fused_layer.py:{line}",
           "launches": fused_train_launches[f"pfn_fused_layer_bwd_{part}"] + measured[f"pfn_fused_layer_bwd_{part}"],
           "max_abs_err": fused_bwd[f"{part}_max_abs_err"], "ms": fused_bwd[f"{part}_kernel_ms"],
           "dev_ms": fused_bwd[f"{part}_kernel_dev_ms"],
           "plain_ms": fused_bwd[f"{part}_plain_ms"], "bound_ms": fused_bwd[f"{part}_bound"]["bound_ms"],
           "bound_by": fused_bwd[f"{part}_bound"]["bound_by"], "library_ms": fused_bwd["unfused_layer_bwd_ms"],
           "library_dev_ms": fused_bwd["unfused_layer_bwd_dev_ms"], "f32": fused_f32[part]}
          for part, line in (("ffn", 358), ("attn", 387))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
