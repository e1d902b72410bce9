"""Dynamically quantized int8 convolutions (``model.quantization``): the
CUDA kernels' wrappers, their plain twins, and the three modes as the
models call them.

Counterpart of sres_tpu/ops/int8_conv.py (``int8_fused``: :60-115,
``int8_full``: :147-243) and of AQT's conv as sres_tpu/models/layers.py
:67-101 builds it (``int8``; aqt/jax/v2/aqt_conv_general.py,
numerics/int_numerics.py, calibration.py's AbsMaxCalibration). None of
them is a Pallas kernel: XLA runs their s8 convolutions on the TPU's int8
MXU. PyTorch has no int8 convolution on CUDA, so the port runs them on
three hand-written kernels (``ops/cuda/int8_conv.cu``): ``q8_quantize``,
``s8_conv_fprop`` and ``s8_conv_wgrad``.

Scale groups. Activations (and cotangents) share one scale per group of
``group`` consecutive samples: JAX quantizes the lane-packed image, in
which tiles 2j and 2j+1 sit side by side (sres_tpu/models/layers.py
:125-131), so under ``lane_pack: 2`` a pair shares its scale; the port
keeps the tiles apart and the groups instead (an odd batch's last group
holds one tile, as JAX's zero padding tile adds nothing to the absmax).
Weights are scaled per output channel (per input channel for int8_full's
dx), which packing leaves alone. Weight gradients are summed per pack slot
(the tiles b ≡ j mod ``group``), each slot rounded as JAX rounds a block
of the block-diagonal kernel's gradient, and the slots added in f32.

Rounding, kernels and twins alike:
- int8_fused's grid: scale = max(amax, 1e-30)·f32(1/127), q = clip(
  rint(t·(1/scale)), ±127), in f32 whatever the input's dtype; the conv's
  exact integer sum is rounded to bf16 (JAX's conv has bf16 operands and a
  bf16 output), then ·(sx·sw) in f32, then the model's dtype, then + bias
  in that dtype.
- AQT's grid (``int8``): scale = (amax or 1)/127.5 and its reciprocal (1
  where infinite) in the input's dtype, q = rint(clip(t·s_inv, ±127)), the
  product rounded to bf16 for a bf16 input; the dequantisation (sum·sx)·sw
  in the scales' dtype, each step rounded in bf16.
- int8_full's backward: dx = conv(q(g) per sample group, q(flipᵀ(w)) per
  input channel)·(sg·swt) with the forward's epilogue, in f32; dw per tap
  Σ x·q(g·sx) over one scale for the whole tensor, per slot f32 → bf16 →
  ·sgp → the weights' dtype, slots added in f32.
- int8_fused's backward (native, as XLA differentiates it): the two bf16
  convolutions of the unquantized cotangent bf16(g·sx·sw) against the other
  quantized operand (cuDNN on the card; in f32 rounded to bf16 on the CPU,
  as XLA's CPU backend computes a bf16 conv), then ·(1/scale).

The twins quantize in f32 (AQT's bf16 grid in bf16) and run the integer
convolutions in f64 on either device (exact: the sums stay far below 2⁵³),
so the kernels are held to their twins bit for bit.

Dispatch: a CUDA tensor goes to the kernels unless ``plain`` asks for the
twins (``models.layers.set_plain_twins``); a CPU tensor always takes the
twins. A CUDA call that the kernels do not take (a stride, groups, k ≠ 3,
64 output channels or cin ∉ {1, 64}) raises. ``LAUNCHES`` counts one per
wrapper call that launches its kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sres_tpu_torch.ops.winograd_conv import _stream

LAUNCHES: Dict[str, int] = {"q8_quantize": 0, "s8_conv_fprop": 0, "s8_conv_wgrad": 0}

MODES = ("int8", "int8_fused", "int8_full")
GRID_FUSED, GRID_AQT = 0, 1
# the conv epilogues: int8_fused's, AQT's in f32, AQT's in bf16
EPI_FUSED, EPI_AQT32, EPI_AQT16 = 0, 1, 2
KERNEL_COUT, KERNEL_CIN, KERNEL_K = 64, (1, 64), 3
# pixels a weight-gradient block sums in int32 (16384·127² < 2³¹)
WGRAD_MAX_CHUNK = 16384

AQT_SERVING_ONLY_MSG = (
    "model.quantization: 'int8' (AQT) is SERVING-ONLY: AQT's "
    "conv_general_dilated_make returns the raw forward building block, whose "
    "round/clip has zero gradient — trunk weight gradients silently vanish "
    "(discovered round 3; the round-2 'int8 train' throughput never computed "
    "a trunk backward). Use 'int8_fused' or 'int8_full' for quantized "
    "training (ops/int8_conv.py — straight-through estimator, converges "
    "like f32 per PERF.md).")

_INV127 = 1.0 / 127.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_mode(quant: Optional[str]) -> Optional[str]:
    """``quant`` if it is a quantization mode or None; else ValueError, as
    sres_tpu/models/layers.py:quant_conv_fn raises."""
    if quant and quant not in MODES:
        raise ValueError(f"Unknown quantization mode {quant!r}")
    return quant or None


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.is_cuda and not plain


def _rows(scale: torch.Tensor, group: int, n: int) -> torch.Tensor:
    """A per-group scale as one value a row (sample or channel)."""
    return scale.repeat_interleave(group)[:n]


# ------------------------------------------------------------------ twins
def _absmax_groups(t: torch.Tensor, group: Optional[int]) -> torch.Tensor:
    a = t.abs().amax(dim=(1, 2, 3))
    if group is None:
        return a.amax().reshape(1)
    pad = (-a.shape[0]) % group
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    return a.reshape(-1, group).amax(1)


def quantize_plain(t: torch.Tensor, group: Optional[int], grid: int = GRID_FUSED,
                   pre: Optional[torch.Tensor] = None, flip: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of ``quantize``: (q as integer-valued f32 of t's logical
    shape, f32 scale a group)."""
    if flip:
        t = t.flip(2, 3)
    aqt16 = grid == GRID_AQT and t.dtype == torch.bfloat16
    tf = t if aqt16 else t.float()
    if pre is not None:
        tf = tf * pre.reshape(-1, 1, 1, 1)
    amax = _absmax_groups(tf, group)
    g = group or t.shape[0]
    if grid == GRID_FUSED:
        scale = amax.clamp_min(1e-30) * torch.tensor(_INV127, dtype=torch.float32)
        inv = 1.0 / scale
        q = torch.round(tf * _rows(inv, g, t.shape[0]).reshape(-1, 1, 1, 1)).clamp(-127, 127)
    else:
        amax = torch.where(amax == 0, torch.ones_like(amax), amax)
        # a tensor divisor: by a scalar, PyTorch's CUDA kernel multiplies by
        # its reciprocal, which rounds otherwise than AQT's division
        scale = amax / torch.full_like(amax, 127.5)
        inv = torch.reciprocal(scale)
        inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
        q = (tf * _rows(inv, g, t.shape[0]).reshape(-1, 1, 1, 1)).clamp(-127, 127).round()
    return q.float(), scale.float()


def _int_conv(a: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
    """Exact stride-1 conv of integer-valued operands in [-127, 127], as f32
    (NCHW): in f64, where every partial sum of the integer products is
    exact, so the summation order does not matter; rounding to the nearest
    integer leaves an exact sum alone."""
    return F.conv2d(a.double(), b.double(), padding=pad).round().float()


def conv_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                  mode: int) -> torch.Tensor:
    """The integer sum (f32, exact) → the conv's output: ``sx`` one a
    sample, ``sw`` one an output channel, ``bias`` in ``out_dtype``."""
    sx, sw = sx.reshape(-1, 1, 1, 1), sw.reshape(1, -1, 1, 1)
    if mode == EPI_FUSED:
        y = acc.bfloat16().float() * (sx * sw)
    elif mode == EPI_AQT32:
        y = (acc * sx) * sw
    else:
        y = (acc.bfloat16() * sx.bfloat16()) * sw.bfloat16()
    y = y.to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype).reshape(1, -1, 1, 1)


def conv_fprop_plain(xq, wq, sx, sw, bias, out_dtype, mode, pad: int = 1):
    """The twin of ``conv_fprop`` (integer-valued f32 operands), channels_last
    as the kernel's output: the layout picks cuDNN's algorithms for the
    convs downstream, so the two paths' gradients stay bit-equal."""
    acc = _int_conv(xq, wq, pad).contiguous(memory_format=torch.channels_last)
    return conv_epilogue(acc, sx, sw, bias, out_dtype, mode)


def conv_wgrad_plain(xq, gq, w_shape, pk: int, sgp: torch.Tensor, wdt: torch.dtype,
                     pad: int = 1) -> torch.Tensor:
    """The twin of ``conv_wgrad``: per pack slot the exact Σ x·g (f64),
    f32 → bf16 → ·sgp → ``wdt``, the slots added in f32."""
    out = None
    for j in range(min(pk, xq.shape[0])):
        s = torch.nn.grad.conv2d_weight(xq[j::pk].double(), w_shape, gq[j::pk].double(),
                                        padding=pad).round()
        v = (s.float().bfloat16().float() * sgp).to(wdt).float()
        out = v if out is None else out + v
    return out


# ---------------------------------------------------------------- kernels
def _lib():
    from sres_tpu_torch.ops import cuda
    return cuda, cuda.load()


def _dev(t: torch.Tensor) -> Tuple[int, int]:
    """The C entries' device index and stream for t."""
    return t.device.index or 0, _stream(t.device)


def quantize(t: torch.Tensor, group: Optional[int], grid: int = GRID_FUSED,
             pre: Optional[torch.Tensor] = None, flip: bool = False,
             plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax-quantize the 4-D ``t`` (f32 or bf16) to s8: one scale per
    group of ``group`` consecutive rows along dim 0, or for the whole
    tensor (``group`` None); ``pre`` (one f32 a row) multiplies t first;
    ``flip`` quantizes t flipped in dims 2 and 3. Returns (q, scale): on the
    kernel path q is s8 in channels_last memory (the conv kernels'
    layout), on the twin path integer-valued f32."""
    if not _use_kernel(t, plain):
        return quantize_plain(t, group, grid, pre, flip)
    if t.dtype not in (torch.float32, torch.bfloat16) or t.dim() != 4:
        raise TypeError(f"q8_quantize takes 4-D f32 or bf16, got {t.dtype} {tuple(t.shape)}")
    cuda, lib = _lib()
    d0, d1, d2, d3 = t.shape
    s0, s1, s2, s3 = t.stride()
    base = t.storage_offset()
    if flip:
        base += (d2 - 1) * s2 + (d3 - 1) * s3
        s2, s3 = -s2, -s3
    gdiv = d0 if group is None else group
    ngroups = -(-d0 // gdiv)
    amax = torch.empty(ngroups, dtype=torch.int32, device=t.device)
    scale = torch.empty(ngroups, dtype=torch.float32, device=t.device)
    q = torch.empty((d0, d1, d2, d3), dtype=torch.int8, device=t.device,
                    memory_format=torch.channels_last)
    if pre is not None:
        pre = pre.float().contiguous()
    # the kernel reads from the storage's start, offsets in elements
    ptr = t.data_ptr() - t.storage_offset() * t.element_size()
    err = lib.sres_q8_quantize(ptr, int(t.dtype == torch.bfloat16), base, s0, s1, s2, s3,
                               d0, d1, d2, d3, gdiv,
                               pre.data_ptr() if pre is not None else None, grid,
                               amax.data_ptr(), scale.data_ptr(), q.data_ptr(), *_dev(t))
    cuda.check(err, "q8_quantize")
    LAUNCHES["q8_quantize"] += 1
    return q, scale


def _check_conv(cin: int, cout: int, k: int, what: str) -> None:
    if cout != KERNEL_COUT or cin not in KERNEL_CIN or k != KERNEL_K:
        raise ValueError(f"{what}: the s8 kernels take 3×3 convs of cin ∈ {KERNEL_CIN} "
                         f"→ {KERNEL_COUT} channels, got {cin} → {cout}, k {k}")


def conv_fprop(xq, wq, sx, sdiv: int, sw, bias, out_dtype, mode, plain: bool = False):
    """y = epilogue(conv(xq, wq)): 3×3 stride-1 'same'; ``sx`` one a group of
    ``sdiv`` samples, ``sw`` one an output channel, ``bias`` (O,) in
    ``out_dtype`` or None. On the kernel path xq, wq are the s8
    channels_last tensors of ``quantize`` and y is channels_last."""
    if not _use_kernel(xq, plain):
        return conv_fprop_plain(xq, wq, _rows(sx, sdiv, xq.shape[0]), sw, bias, out_dtype,
                                mode, wq.shape[-1] // 2)
    b, cin, h, w = xq.shape
    _check_conv(cin, wq.shape[0], wq.shape[-1], "s8_conv_fprop")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("s8_conv_fprop takes s8 operands")
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq = wq.contiguous(memory_format=torch.channels_last)
    y = torch.empty((b, KERNEL_COUT, h, w), dtype=out_dtype, device=xq.device,
                    memory_format=torch.channels_last)
    bias = bias.to(out_dtype).float().contiguous() if bias is not None else None
    cuda, lib = _lib()
    err = lib.sres_s8_conv_fprop(xq.data_ptr(), wq.data_ptr(), sx.contiguous().data_ptr(),
                                 sw.contiguous().data_ptr(),
                                 bias.data_ptr() if bias is not None else None, y.data_ptr(),
                                 b, h, w, cin, sdiv, mode, int(out_dtype == torch.bfloat16),
                                 *_dev(xq))
    cuda.check(err, "s8_conv_fprop")
    LAUNCHES["s8_conv_fprop"] += 1
    return y


def wgrad_chunk(npx_slot: int, ntaps_blocks: int, nsm: int) -> int:
    """Pixels a weight-gradient block sums: about four blocks an SM over
    the slots' streams (``ntaps_blocks`` blocks a chunk), a multiple of 64
    in [1024, WGRAD_MAX_CHUNK]."""
    want = -(-npx_slot * ntaps_blocks // (4 * nsm))
    return max(1024, min(WGRAD_MAX_CHUNK, -(-want // 64) * 64))


def conv_wgrad(xq, gq, w_shape, pk: int, sgp: torch.Tensor, wdt: torch.dtype,
               plain: bool = False) -> torch.Tensor:
    """dw (O, I, 3, 3) f32 = Σ over pack slots j of wdt(bf16(Σ_{b ≡ j}
    x_tap·g)·sgp), the slots added in f32; ``sgp`` a one-element f32
    tensor."""
    if not _use_kernel(xq, plain):
        return conv_wgrad_plain(xq, gq, w_shape, pk, sgp, wdt, w_shape[-1] // 2)
    b, cin, h, w = xq.shape
    _check_conv(cin, gq.shape[1], w_shape[-1], "s8_conv_wgrad")
    xq = xq.contiguous(memory_format=torch.channels_last)
    gq = gq.contiguous(memory_format=torch.channels_last)
    acc = torch.empty((pk, 9, cin, KERNEL_COUT), dtype=torch.int64, device=xq.device)
    dw = torch.empty(tuple(w_shape), dtype=torch.float32, device=xq.device)
    nslot = -(-b // pk)
    chunk = wgrad_chunk(nslot * h * w, pk * (9 if cin > 1 else 1),
                        torch.cuda.get_device_properties(xq.device).multi_processor_count)
    cuda, lib = _lib()
    err = lib.sres_s8_conv_wgrad(xq.data_ptr(), gq.data_ptr(), acc.data_ptr(),
                                 sgp.float().contiguous().data_ptr(), dw.data_ptr(), b, h, w,
                                 cin, pk, chunk, int(wdt == torch.bfloat16), *_dev(xq))
    cuda.check(err, "s8_conv_wgrad")
    LAUNCHES["s8_conv_wgrad"] += 1
    return dw


# ------------------------------------------------------------ the modes
def _bwd_convs_bf16(x_shape, wq, xq, gc, pad: int, need_x: bool, pk: int):
    """int8_fused's native backward: dq_x = conv_input(gc, wq), per slot
    dq_w[j] = conv_weight(xq[j], gc[j]), every result bf16 (cuDNN's bf16
    convs on the card; on the CPU in f32, rounded to bf16)."""
    dt = torch.bfloat16 if gc.is_cuda else torch.float32
    # channels_last operands on the kernels' and the twins' path alike, so
    # that cuDNN runs the same algorithms on both
    cl = lambda t: t.to(dt).contiguous(memory_format=torch.channels_last)
    g = cl(gc)
    dqx = None
    if need_x:
        dqx = torch.nn.grad.conv2d_input(x_shape, cl(wq), g, padding=pad).bfloat16()
    dqw = [torch.nn.grad.conv2d_weight(cl(xq[j::pk]), wq.shape, cl(g[j::pk]),
                                       padding=pad).bfloat16()
           for j in range(min(pk, xq.shape[0]))]
    return dqx, dqw


def _fused_forward(x, weight, bias, group, wdt, plain):
    """int8_fused's and int8_full's forward: the weights rounded to ``wdt``,
    both operands on int8_fused's grid, the conv with its epilogue.
    Returns (y, w32, xq, sx, wq, sw)."""
    w32 = weight.detach().to(wdt).float()
    xq, sx = quantize(x.detach(), group, GRID_FUSED, plain=plain)
    wq, sw = quantize(w32, 1, GRID_FUSED, plain=plain)
    b = bias.detach() if bias is not None else None
    y = conv_fprop(xq, wq, sx, group, sw, b, x.dtype, EPI_FUSED, plain=plain)
    return y, w32, xq, sx, wq, sw


class Int8ConvFn(torch.autograd.Function):
    """``int8_fused``: the forward on the s8 kernels, the straight-through
    backward as XLA differentiates sres_tpu/ops/int8_conv.py:int8_conv
    (two native bf16 convs of the unquantized cotangent)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group: int, wdt: torch.dtype, plain: bool):
        y, _, xq, sx, wq, sw = _fused_forward(x, weight, bias, group, wdt, plain)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.meta = (tuple(x.shape), x.dtype, group, wdt, bias is not None)
        return y

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        x_shape, xdt, group, wdt, has_bias = ctx.meta
        n = x_shape[0]
        sxr = _rows(sx, group, n).reshape(-1, 1, 1, 1)
        gc = (g.float() * (sxr * sw.reshape(1, -1, 1, 1))).bfloat16()
        pad = wq.shape[-1] // 2
        dqx, dqw = _bwd_convs_bf16(x_shape, wq, xq, gc, pad, ctx.needs_input_grad[0], group)
        dx = (dqx.float() * (1.0 / sxr)).to(xdt) if dqx is not None else None
        invw = (1.0 / sw).reshape(-1, 1, 1, 1)
        dw = None
        for d in dqw:
            v = (d.float() * invw).to(wdt).float()
            dw = v if dw is None else dw + v
        db = g.sum((0, 2, 3)) if has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


class Int8ConvFullFn(torch.autograd.Function):
    """``int8_full``: forward, dx and dw on the s8 kernels
    (sres_tpu/ops/int8_conv.py:_full_fwd, _full_bwd)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group: int, wdt: torch.dtype, plain: bool):
        y, w32, xq, sx, _, _ = _fused_forward(x, weight, bias, group, wdt, plain)
        ctx.save_for_backward(xq, sx, w32)
        ctx.meta = (x.dtype, group, wdt, bias is not None, plain)
        return y

    @staticmethod
    def backward(ctx, g):
        xq, sx, w32 = ctx.saved_tensors
        xdt, group, wdt, has_bias, plain = ctx.meta
        gf = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # O contracted: the weights flipped, transposed, scaled per input channel
            gq, sg = quantize(gf, group, GRID_FUSED, plain=plain)
            wtq, swt = quantize(w32.transpose(0, 1), 1, GRID_FUSED, flip=True, plain=plain)
            dx = conv_fprop(gq, wtq, sg, group, swt, None, torch.float32, EPI_FUSED,
                            plain=plain).to(xdt)
        if ctx.needs_input_grad[1]:
            # B contracted: the activation scale folded into the cotangent
            sxr = _rows(sx, group, gf.shape[0])
            gpq, sgp = quantize(gf, None, GRID_FUSED, pre=sxr, plain=plain)
            dw = conv_wgrad(xq, gpq, w32.shape, group, sgp, wdt, plain=plain)
        db = g.sum((0, 2, 3)) if has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def aqt_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             group: int, plain: bool = False) -> torch.Tensor:
    """``int8`` (AQT), serving only: both operands quantized on AQT's grid
    in x's dtype, (sum·sx)·sw, + bias. Raises where autograd would need its
    gradient (AQT's round has none)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise NotImplementedError(AQT_SERVING_ONLY_MSG)
    dt = x.dtype
    xq, sx = quantize(x, group, GRID_AQT, plain=plain)
    wq, sw = quantize(weight.to(dt), 1, GRID_AQT, plain=plain)
    mode = EPI_AQT16 if dt == torch.bfloat16 else EPI_AQT32
    return conv_fprop(xq, wq, sx, group, sw, bias, dt, mode, plain=plain)


def quant_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               quant: str, group: int, plain: bool = False) -> torch.Tensor:
    """One quantized 'same' stride-1 conv of x (the model's dtype) with the
    f32 ``weight`` and ``bias`` rounded to x's dtype, activation scales over
    groups of ``group`` samples."""
    b = bias.to(x.dtype) if bias is not None else None
    if quant == "int8":
        return aqt_conv(x, weight, b, group, plain)
    fn = Int8ConvFullFn if quant == "int8_full" else Int8ConvFn
    return fn.apply(x, weight, b, group, x.dtype, plain)
