"""PyTorch/CUDA port of `pytorch_distributed_example_tpu`, for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Module names mirror the reference's. Each Pallas kernel
of the reference becomes a CUDA C++ kernel for sm_90a (`csrc/`), built at
first use by `ops/_build.py`.

Ported so far: the single-chip TransformerLM train step
(`examples/lm.py`), with flash attention's forward, dK/dV and dQ as Hopper
kernels (`ops/flash_attention.py`). ROADMAP.md lists what is still to come.
"""

__all__ = ["ops", "models"]
