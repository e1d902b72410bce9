"""sres_tpu_torch — the PyTorch / NVIDIA Hopper port of sres_tpu.

The JAX package ``sres_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``yaml``. Activations are NCHW at
module boundaries; the Winograd trunk keeps them in channels_last memory
format, which the hand-written CUDA kernels read as NHWC.

Slice ported so far: the serving/eval path of RCAN (direct convs or
``model.winograd: 2|4`` through the CUDA Winograd kernels).

  device      — device and compute-dtype resolution
  ops         — resize, Winograd math, kernel wrappers + plain twins, CUDA
  models      — RCAN, its layers and the Winograd trunk blocks, registry
  trainer     — losses and the eval step
  util        — weight transfer from the JAX package
"""

__version__ = "0.1.0"
