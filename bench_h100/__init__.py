"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python bench_h100/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``BENCHMARK.json`` and ``PERF.md``."""
