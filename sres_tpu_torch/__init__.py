"""sres_tpu_torch — the PyTorch / NVIDIA Hopper port of sres_tpu.

The JAX package ``sres_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax``, ``optax``, ``yaml`` or any module of ``sres_tpu``.
Activations are NCHW at module boundaries; the Winograd trunk keeps them in
channels_last memory format, which the hand-written CUDA kernels read as
NHWC.

Slices ported so far: RCAN's serving/eval path and its train step (direct
convs, or ``model.winograd: 2|4`` with the forward and backward of every
trunk conv on the CUDA Winograd kernels), and SwinIR's serving and train
step with every window attention, forward and backward, on the CUDA
window-attention kernels.

  device      — device and compute-dtype resolution
  ops         — resize, Winograd math, window attention, kernel wrappers +
                plain twins and their autograd Functions, CUDA
  models      — RCAN, SwinIR, their layers and the Winograd trunk blocks,
                registry
  trainer     — losses, the train and eval steps, the optimizer
  util        — weight transfer from JAX variable trees (RCAN, SwinIR)

CPU tests: ``tests/test_torch_*.py`` (plain twins against the JAX package);
card: ``python3 chip_smoke.py`` (phases 10-13 are SwinIR's).
"""

__version__ = "0.1.0"
