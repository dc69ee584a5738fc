"""The benchmark of the PyTorch/CUDA receiver `gps_sdr_tpu_torch`.

`python3 sdrbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on a CUDA card and
prints one JSON line.  Configurations (`configs/*.json`), traffic mixes
(`traffic/*.json`) and metric readers (`metrics/*.py`) are found by the
names `BENCHMARK.json` gives them.
"""
