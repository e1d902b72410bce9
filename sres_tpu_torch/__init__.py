"""sres_tpu_torch — the PyTorch / NVIDIA Hopper port of sres_tpu.

The JAX package ``sres_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax``, ``optax``, ``yaml`` or any module of ``sres_tpu``.
Activations are NCHW at module boundaries; the Winograd and fused trunks
keep them in channels_last memory format, which the hand-written CUDA
kernels read as NHWC.

Slices ported so far: RCAN's serving/eval path and its train step (direct
convs, ``model.winograd: 2|4`` with the forward and backward of every trunk
conv on the CUDA Winograd kernels, or ``model.fused: true`` with every
residual group, forward and backward, on the CUDA direct-conv group
kernels), and SwinIR's serving and train step with every window
attention, forward and backward, on the CUDA window-attention kernels.

  device      — device and compute-dtype resolution
  ops         — resize, Winograd math, window attention, the fused group,
                kernel wrappers + plain twins and their autograd
                Functions, CUDA
  models      — RCAN, SwinIR, their layers, the Winograd trunk blocks and
                the fused residual group, registry
  trainer     — losses, the train and eval steps, the optimizer
  util        — weight transfer from JAX variable trees (RCAN, SwinIR)

CPU tests: ``tests/test_torch_*.py`` (plain twins against the JAX package);
card: ``python3 chip_smoke.py`` (phases 10-13 are SwinIR's, 14-17 RCAN's
with ``model.fused``).
"""

__version__ = "0.1.0"
