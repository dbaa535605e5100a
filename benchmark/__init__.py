"""The benchmark of the PyTorch/CUDA port (`dl_ofdm_tpu_torch`): cells of a
model configuration under a traffic mix, run by `benchmark/run.py` as
`BENCHMARK.json` lists them, each checked against the plain reference in
`benchmark/reference/`."""
