"""PyTorch + CUDA port of the dedicated windowed-LSTM scoring session.

The JAX package `sitewhere_tpu` is the reference; this package mirrors
its module layout (`sitewhere_tpu_torch/models/lstm.py` ↔
`sitewhere_tpu/models/lstm.py`) so each counterpart is easy to find. It
imports `torch` and numpy only — never `jax`, and nothing of
`sitewhere_tpu` (it keeps its own copies of the host modules it needs).

Entry points (`ScoringSession`, `DeviceRing`, `build_model`) run on the
CUDA card unless the caller passes `device="cpu"`; with no card and no
device they raise instead of quietly running on the CPU.
"""
