"""The benchmark of the PyTorch and CUDA port (`tony_tpu_torch`): a
harness driven by data. `run.py` is the entry; `BENCHMARK.json` at the
root of the repository names its cells and metrics."""
