"""Plain references, one module a configuration's `reference` key names.

A module gives `make_params(widths, seed, device)` (the model's weights
from the seed, in the program's layout), `scores(params, widths, values,
n_warm, rdt)` (every score the served path owes for the readings sent)
and `flops_per_event(widths)`. They are plain PyTorch and import nothing
of the port and neither JAX nor the JAX package.
"""
