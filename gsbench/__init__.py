"""gsbench: the benchmark of ex4dgs_tpu_torch on one NVIDIA H100.

`python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json (see README.md)."""
