"""The benchmark of fbstab_tpu_torch on one H100: `python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see benchmark/README.md). Nothing here imports JAX or the JAX package."""
