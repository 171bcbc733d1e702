"""The benchmark of mq3d_tpu_torch: `python -m benchmark.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
