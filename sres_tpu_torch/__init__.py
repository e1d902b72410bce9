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
kernels), SwinIR's serving and train step with every window attention,
forward and backward, on the CUDA window-attention kernels, and EDSR's
(``model.winograd: 2|4`` running its whole trunk as one ungated group on
the Winograd kernels). ``ops.winograd_conv.wino_chain_fwd`` runs K conv +
ReLU layers in one cooperative launch (a probe; no model calls it). The
training workflow runs through the port's own launcher on the synthetic
task: config compose, tiles, ModelTrainer, checkpoints and the loss CSV.

  train       — the training launcher (``python -m sres_tpu_torch.train``)
  config      — config compose from the repo's ``config/`` (own YAML reader)
  controller  — WorkflowController (train)
  data        — the synthetic source, tiles, normalization, batches, the
                host input pipeline
  device      — device and compute-dtype resolution
  ops         — resize, Winograd math, window attention, the fused group,
                kernel wrappers + plain twins and their autograd
                Functions, CUDA
  models      — RCAN, SwinIR, EDSR, their layers, the Winograd trunk
                blocks and the fused residual group, registry
  trainer     — losses, the train and eval steps and their multi-step and
                accumulation variants, the optimizer, ModelTrainer,
                checkpoints, the loss CSV
  util        — weight transfer from JAX variable trees (RCAN, SwinIR,
                EDSR), the YAML-subset reader, logging, labeled arrays
  probes      — card-only measurements of kernel variants and of the
                trainer's host

CPU tests: ``tests/test_torch_*.py`` (plain twins against the JAX package);
card: ``python3 chip_smoke.py`` (phases 10-13 are SwinIR's, 14-17 RCAN's
with ``model.fused``, 18 the chain's, 19-21 EDSR's, 22-24 SwinIR-w16's, 25
the trainer's).
"""

__version__ = "0.1.0"
