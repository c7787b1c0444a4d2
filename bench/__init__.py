"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once and prints one JSON line.
Cells, configurations (configs/), the model module each configuration
names (models/, with its plain reference in reference/), traffic mixes
(traffic/ with their generators in generators/), per-cell settings
(cells/) and per-layer metrics (metrics/) are found by name."""
