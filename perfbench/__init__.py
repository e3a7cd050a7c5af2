"""The benchmark of the PyTorch/CUDA port (`pytorch_distributed_example_tpu_torch`).

`python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on the card and prints its result as the
last line of standard output. See `run.py`.
"""
