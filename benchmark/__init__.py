"""The benchmark of vs_seg_tpu_torch on the NVIDIA H100: `python3 -m
benchmark.run` (one run of one cell), `python3 -m benchmark.readings` (the
readings its limits are set from). See BENCHMARK.json and PERF.md."""
