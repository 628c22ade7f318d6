"""The benchmark harness of the PyTorch and CUDA port: one cell of
`BENCHMARK.json` run once (`run.py`)."""
