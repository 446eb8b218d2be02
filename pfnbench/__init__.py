"""The benchmark of ``pfn_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 -m pfnbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (README.md)."""
