"""The benchmark of the PyTorch and CUDA port (`sitewhere_tpu_torch`).

`python -m swxbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once on the CUDA card and prints
its result line (`run.py`). The harness is driven by data: configurations,
traffic mixes, metrics and limits are files found by name (`spec.py`).
`python -m swxbench.sweep` finds a gateway mix's knee; `python -m
swxbench.control` reads the lower-precision control that the score limit
is set against. Nothing here imports JAX or the JAX package, and the
plain reference (`reference/`) imports nothing of the port.
"""
