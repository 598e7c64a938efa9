"""The benchmark of flate_tpu_torch on one NVIDIA H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout, with the cells, configurations and
metrics listed in BENCHMARK.json there.  Everything a cell is made of is
found by name in this folder: configurations in `configs/`, traffic mixes
in `mixes/`, the corpora a mix names in `corpora/`, the calls a mix makes
in `ops/`, and one reader a metric in `e2e_metrics/` and `layer_metrics/`.
`reference/` is the plain decoder and checksums that judge the program's
answers; it imports nothing of the program.
"""
