"""Winograd conv and RCAB-group entry points: CUDA kernels and plain twins.

Counterparts of sres_tpu/ops/pallas/winograd_conv.py (``wino_conv_quad``
forward :661-674, ``wino_group_fwd`` :569-612) and of the forward of
sres_tpu/ops/pallas/wino_group_grad.py:wino_group_trail (:584-597).

Dispatch is by the device of the input tensor: a CPU tensor goes to the
``*_plain`` twin, a CUDA tensor to the hand-written kernel in
``ops/cuda/winograd.cu``, and a kernel that fails to build or launch raises.
The twins are plain torch with the kernels' rounding points: both
input-transform stages round to the activation dtype, the tap products use
activation-dtype operands with f32 accumulation, and the inverse transform,
bias, ReLU and channel attention run in f32; every conv output and every
skip sum is rounded to the activation dtype.

Activations are NCHW (the kernels take them in channels_last memory format
and return channels_last). Weights ``w`` are either the torch-layout
(Cout, Cin, 3, 3) kernel or its precomputed transform (n², Cin, Cout) from
``ops.winograd.transform_weights``. Channel-attention weights are the
squeezed 1×1 conv weights: caw1 (hidden, C), cab1 (hidden,), caw2 (C,
hidden), cab2 (C,).

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call that
reached its kernel), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sres_tpu_torch.ops.winograd import check_geometry, transform_weights

LAUNCHES: Dict[str, int] = {"wino_conv": 0, "ca_skip": 0}

# channel-attention launch geometry: spatial chunks of the pooling pass and
# of the gate+skip pass, per sample
_CA_POOL_SPLIT = 8
_CA_GATE_SPLIT = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ helpers
def _bt_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[i] = Σ_q BT[i, q]·f[q] (sres_tpu/ops/winograd.py:bt_apply)."""
    if m == 4:
        p = f[4] - 4.0 * f[2]
        q = 4.0 * f[1] - f[3]
        s = f[4] - f[2]
        t = 2.0 * (f[1] - f[3])
        return [4.0 * f[0] - 5.0 * f[2] + f[4], p - q, p + q, s - t, s + t,
                4.0 * f[1] - 5.0 * f[3] + f[5]]
    return [f[0] - f[2], f[1] + f[2], f[2] - f[1], f[1] - f[3]]


def _at_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[u] = Σ_i AT[u, i]·f[i] (sres_tpu/ops/winograd.py:at_apply)."""
    if m == 4:
        s1, d1 = f[1] + f[2], f[1] - f[2]
        s2, d2 = f[3] + f[4], f[3] - f[4]
        return [f[0] + s1 + s2, d1 + 2.0 * d2, s1 + 4.0 * s2,
                d1 + 8.0 * d2 + f[5]]
    return [f[0] + f[1] + f[2], f[1] - f[2] - f[3]]


def _as_u(w: torch.Tensor, m: int, dtype: torch.dtype) -> torch.Tensor:
    """Spatial (Cout, Cin, 3, 3) or transformed (n², Cin, Cout) → U in the
    activation dtype (the TPU kernel's U operand, :593)."""
    n = m + 2
    if w.dim() == 4:
        w = transform_weights(w, m)
    if w.dim() != 3 or w.shape[0] != n * n:
        raise ValueError(f"weights must be (Cout, Cin, 3, 3) or ({n * n}, Cin, "
                         f"Cout) for m={m}, got {tuple(w.shape)}")
    return w.to(dtype)


def mma_fragment_order(u: torch.Tensor) -> torch.Tensor:
    """(n², 64, 64) U → the bf16 conv kernel's B-fragment order: element
    U[t][16·ks + 8·hh + 2·q + e][8·nb + g] goes to [t][nb][ks][g][q][hh][e],
    so each lane (g, q) of an mma.m16n8k16 reads its two B registers of one
    (tap, n8 block, k-step) as one coalesced 8-byte load."""
    n2 = u.shape[0]
    return (u.reshape(n2, 4, 2, 4, 2, 8, 8).permute(0, 5, 1, 6, 3, 2, 4)
            .contiguous())


def _bias(b: Optional[torch.Tensor], c: int, like: torch.Tensor) -> torch.Tensor:
    if b is None:
        return torch.zeros(c, dtype=torch.float32, device=like.device)
    return b.float()


# ------------------------------------------------------------- plain twins
def wino_conv_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                    m: int, relu: bool = False,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch twin of the Winograd conv kernel: NCHW in, NCHW out, in
    x.dtype, with the kernel's rounding points."""
    t, c, h, wd = x.shape
    check_geometry(m, h, wd)
    n = m + 2
    xdt = x.dtype
    rnd = lambda a: a.to(xdt).float()
    u = _as_u(w, m, xdt).float()
    cout = u.shape[2]
    d = F.pad(x.float(), (1, 1, 1, 1)).unfold(2, n, m).unfold(3, n, m)
    # stage 1 over q (columns of the patch), stage 2 over p (rows)
    w1 = rnd(torch.stack(_bt_apply(m, list(d.unbind(-1))), -1))    # [..., p, tj]
    v = rnd(torch.stack(_bt_apply(m, list(w1.unbind(-2))), -2))    # [..., ti, tj]
    th, tw = h // m, wd // m
    v = v.permute(4, 5, 0, 2, 3, 1).reshape(n * n, t * th * tw, c)
    mm = torch.bmm(v, u).reshape(n, n, t * th * tw, cout)
    z = torch.stack(_at_apply(m, list(mm.unbind(0))), 0)           # (u, tj, P, co)
    y = torch.stack(_at_apply(m, list(z.unbind(1))), 1)            # (u, v, P, co)
    y = y + _bias(b, cout, x)
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = rnd(y).reshape(m, m, t, th, tw, cout).permute(2, 5, 3, 0, 4, 1)
    y = y.reshape(t, cout, h, wd)
    if residual is not None:
        y = residual.float() + y
    return y.to(xdt)


def ca_skip_plain(q: torch.Tensor, r: torch.Tensor, caw1: torch.Tensor,
                  cab1: torch.Tensor, caw2: torch.Tensor,
                  cab2: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the channel-attention kernel: q + r·gate with
    gate = sigmoid(W2 relu(W1 mean(r) + b1) + b2), f32 math, q.dtype out."""
    npix = r.shape[2] * r.shape[3]
    mean = r.float().sum((2, 3)) * np.float32(1.0 / npix)
    hid = torch.clamp_min(mean @ caw1.float().T + cab1.float(), 0.0)
    gate = torch.sigmoid(hid @ caw2.float().T + cab2.float())
    return (q.float() + r.float() * gate[:, :, None, None]).to(q.dtype)


# ----------------------------------------------------------- CUDA wrappers
def _channels_last(a: torch.Tensor) -> torch.Tensor:
    a = a.contiguous(memory_format=torch.channels_last)
    if a.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return a


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_act(x: torch.Tensor, name: str, c: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != c:
        raise ValueError(f"{name}: kernel takes (T, {c}, H, W), got {tuple(x.shape)}")


def _wino_conv_cuda(x, w, b, m, relu, residual):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    t, _, h, wd = x.shape
    check_geometry(m, h, wd)
    u = _as_u(w, m, x.dtype)
    if tuple(u.shape) != ((m + 2) ** 2, c, c) or u.device != x.device:
        raise ValueError(f"U must be ({(m + 2) ** 2}, {c}, {c}) on {x.device}, "
                         f"got {tuple(u.shape)} on {u.device}")
    u = mma_fragment_order(u) if x.dtype == torch.bfloat16 else u.contiguous()
    bias = _bias(b, c, x).contiguous()
    x = _channels_last(x)
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")
        residual = _channels_last(residual)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    err = lib.sres_wino_conv(
        x.data_ptr(), u.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        t, h, wd, m, int(x.dtype == torch.bfloat16), int(relu),
        x.device.index or 0, _stream(x.device))
    cuda.check(err, "wino_conv kernel")
    LAUNCHES["wino_conv"] += 1
    return y


def _ca_skip_cuda(q, r, caw1, cab1, caw2, cab2):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(q, "q", c)
    if r.shape != q.shape or r.dtype != q.dtype or r.device != q.device:
        raise ValueError("r must match q in shape, dtype and device")
    hidden = caw1.shape[0]
    if not 1 <= hidden <= lib.sres_max_hidden():
        raise ValueError(f"channel-attention width {hidden} outside "
                         f"[1, {lib.sres_max_hidden()}]")
    ws = [a.float().contiguous() for a in (caw1, cab1, caw2, cab2)]
    shapes = [(hidden, c), (hidden,), (c, hidden), (c,)]
    for a, s in zip(ws, shapes):
        if tuple(a.shape) != s or a.device != q.device:
            raise ValueError(f"channel-attention weights must be {shapes} on "
                             f"{q.device}")
    t, _, h, wd = q.shape
    q, r = _channels_last(q), _channels_last(r)
    partial = torch.empty((t, _CA_POOL_SPLIT, c), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q, memory_format=torch.channels_last)
    err = lib.sres_ca_skip(
        q.data_ptr(), r.data_ptr(), *(a.data_ptr() for a in ws),
        partial.data_ptr(), out.data_ptr(), t, h * wd, hidden, _CA_POOL_SPLIT,
        _CA_GATE_SPLIT, int(q.dtype == torch.bfloat16), q.device.index or 0,
        _stream(q.device))
    cuda.check(err, "ca_skip kernel")
    LAUNCHES["ca_skip"] += 1
    return out


# ----------------------------------------------------------------- entries
def wino_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              m: int, relu: bool = False,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3×3 SAME conv by Winograd F(m, 3) (+ bias, optional ReLU, optional
    ``residual + y`` epilogue). CUDA tensor → kernel; CPU tensor → twin."""
    if x.device.type == "cpu":
        return wino_conv_plain(x, w, b, m, relu, residual)
    return _wino_conv_cuda(x, w, b, m, relu, residual)


def ca_skip(q: torch.Tensor, r: torch.Tensor, caw1: torch.Tensor,
            cab1: torch.Tensor, caw2: torch.Tensor,
            cab2: torch.Tensor) -> torch.Tensor:
    """RCAB channel attention + block skip: q + r·gate(r). CUDA tensor →
    kernel (a pooling launch, then a gate+skip launch); CPU → twin."""
    if q.device.type == "cpu":
        return ca_skip_plain(q, r, caw1, cab1, caw2, cab2)
    return _ca_skip_cuda(q, r, caw1, cab1, caw2, cab2)


def _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
           conv: Callable, ca: Callable) -> torch.Tensor:
    q = x
    for i in range(ws.shape[0]):
        r = conv(q, ws[i, 0], bvec[i, 0], m, relu=True)
        r = conv(r, ws[i, 1], bvec[i, 1], m)
        q = ca(q, r, caw1[i], cab1[i], caw2[i], cab2[i])
    if wt is not None:
        q = conv(q, wt, bt, m, residual=x)
    return q


def wino_group_fwd(x: torch.Tensor, ws: torch.Tensor, bvec: torch.Tensor,
                   caw1: torch.Tensor, cab1: torch.Tensor, caw2: torch.Tensor,
                   cab2: torch.Tensor, m: int, wt: Optional[torch.Tensor] = None,
                   bt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A residual group's RCAB stack (gated mode), forward only: per block
    conv+ReLU → conv → channel attention → skip; with ``wt``/``bt`` also the
    trailing conv and the group skip (``x + conv(q)``).

    ws: (nb, 2, Cout, Cin, 3, 3) or (nb, 2, n², Cin, Cout); bvec (nb, 2, C);
    caw1 (nb, hidden, C); cab1 (nb, hidden); caw2 (nb, C, hidden); cab2
    (nb, C); wt (Cout, Cin, 3, 3) or (n², Cin, Cout); bt (C,)."""
    return _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
                  wino_conv, ca_skip)


def wino_group_fwd_plain(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt=None,
                         bt=None) -> torch.Tensor:
    """Plain-torch twin of ``wino_group_fwd`` on any device."""
    return _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
                  wino_conv_plain, ca_skip_plain)

