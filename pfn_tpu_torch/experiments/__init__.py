"""The Fig-3a experiments: training, resuming and scoring the GP-regression PFN.

Port of the JAX package's ``experiments/`` scripts of the paper's Fig. 3a,
each runnable as ``python -m pfn_tpu_torch.experiments.<name>``:

  * ``gp_fitting``: train, then the NLL-vs-context curve against the exact-GP
    oracle (``--quick``: the small config).
  * ``fig3a_longrun``: the resumable bptt=2010 run, its oracle pass.
  * ``fig3a_analytic_gap``: the analytic KL(exact GP posterior || PFN bar)
    of a checkpoint, with bootstrap CIs and a verdict per context size.
  * ``fig3a_robust_eval``: the single-draw NLL gap of a checkpoint.
  * ``grid_fidelity``: the grid sampler's effective-noise and prior-moment
    audits.

Each runs on the current CUDA device and raises without one, unless
``--device cpu`` is given. The f64 oracles run on the same device, in
process (the JAX scripts need a CPU subprocess with x64 enabled).
"""
