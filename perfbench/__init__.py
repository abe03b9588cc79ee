"""The benchmark of the PyTorch/H100 port (`src/repro_torch`): one command
runs one cell of `BENCHMARK.json` once. See README.md."""
