"""Winograd conv, conv-chain and residual-group entry points: CUDA kernels,
plain twins and their autograd Functions.

Counterparts of sres_tpu/ops/pallas/winograd_conv.py (``wino_conv_quad``
:661-696 with its VJP, ``wino_chain_fwd`` :414, ``wino_group_fwd``
:569-612 gated and ungated, the backward kernel ``_bwd_kernel`` :212) and
of sres_tpu/ops/pallas/wino_group_grad.py (``wino_group_trail`` and its
VJP :583-649, ``wino_resgroup_trail`` and its VJP :719-770: the stash, the
trailing conv's adjoint, the reversed block backward of
``_bwd_chunk_kernel`` :324 and ``_conv_adj`` :258).

Dispatch is by the device of the input tensor: a CPU tensor goes to the
``*_plain`` twin, a CUDA tensor to the hand-written kernel in
``ops/cuda/``, and a kernel that fails to build or launch raises.
The twins are plain torch with the kernels' rounding points: both
input-transform stages round to the activation dtype, the tap products use
activation-dtype operands with f32 accumulation, and the inverse transform,
bias, ReLU and channel attention run in f32; every conv output and every
skip sum is rounded to the activation dtype. The backward keeps the TPU
kernels' points too: both stages of the cotangent's A-adjoint (dM), dV and
the first stage of its B-adjoint round to the activation dtype; dx is
accumulated in f32 and rounded once; the cotangent carried across RCABs
and every weight-gradient sum stay f32.

Activations are NCHW (the kernels take them in channels_last memory format
and return channels_last). Weights ``w`` are either the torch-layout
(Cout, Cin, 3, 3) kernel or its precomputed transform (n², Cin, Cout) from
``ops.winograd.transform_weights``, which a CUDA call reorders into its
kernel's order on every call, or a ``WinoU``: U already in the kernels'
orders, as the module caches keep it, so that a conv call is one launch
and the adjoint one wrapper call. Channel-attention weights are the
squeezed 1×1 conv weights: caw1 (hidden, C), cab1 (hidden,), caw2 (C,
hidden), cab2 (C,).

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call that
reached its kernel), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sres_tpu_torch.ops.winograd import (at_apply, at_t_apply, bt_apply,
                                         bt_t_apply, check_geometry,
                                         transform_weights,
                                         untransform_weight_grad)

LAUNCHES: Dict[str, int] = {"wino_conv": 0, "ca_skip": 0, "wino_conv_bwd": 0,
                            "ca_skip_bwd": 0, "wino_chain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ helpers
class WinoU:
    """A Winograd conv's U in the orders its kernels read, built once per
    weight version by the module caches (``models/wino_blocks.py``): ``u``
    natural (n², Cin, Cout) in the activation dtype (the plain twins'
    operand), ``fwd`` the conv kernel's (``conv_order`` in bf16, ``u`` in
    f32), ``bwd`` the adjoint's Uᵀ (``bwd_order`` in bf16, (n², Cout, Cin)
    in f32). Leading dimensions (a stack of convs) index the three alike.
    ``wino_conv`` and ``wino_conv_bwd`` take it in place of a spatial or
    natural U, which they reorder on every call."""

    __slots__ = ("u", "fwd", "bwd")

    def __init__(self, u: torch.Tensor, fwd: torch.Tensor, bwd: torch.Tensor):
        self.u, self.fwd, self.bwd = u, fwd, bwd

    def __getitem__(self, idx) -> "WinoU":
        return WinoU(self.u[idx], self.fwd[idx], self.bwd[idx])

    @property
    def shape(self) -> torch.Size:
        return self.u.shape


def kernel_u(u: torch.Tensor) -> WinoU:
    """Natural U (..., n², Cin, Cout) in the activation dtype → ``WinoU``."""
    if u.dtype == torch.bfloat16:
        return WinoU(u, conv_order(u), bwd_order(u))
    return WinoU(u, u.contiguous(), u.transpose(-1, -2).contiguous())


def conv_order(u: torch.Tensor) -> torch.Tensor:
    """(..., n², Cin, Cout) U → the bf16 conv kernel's order: element
    U[ti·n + tj][ci][co] at [tj][ti][ci // 8][co][ci % 8], a column of taps
    after another (the order the kernel streams and folds them), each tap
    Uᵀ in wgmma's K-major core-matrix layout (8 output channels × 8 input
    channels a 128-byte core matrix). A permutation: any dtype."""
    *lead, n2, ci, co = u.shape
    n, b = math.isqrt(n2), len(lead)
    v = u.reshape(*lead, n, n, ci // 8, 8, co)
    return v.permute(*range(b), b + 1, b, b + 2, b + 4, b + 3).contiguous()


def bwd_order(u: torch.Tensor) -> torch.Tensor:
    """(..., n², Cin, Cout) U → the bf16 adjoint kernels' Uᵀ (the B operand
    of dV = dM·Uᵀ) in mma fragment order: element Uᵀ[t][16·ks + 8·hh + 2·q +
    e][8·nb + g] at [t][nb][ks][g][q][hh][e], so each lane (g, q) of an
    mma.m16n8k16 reads its two B registers of one (tap, n8 block, k-step)
    as one coalesced 8-byte load. A permutation: any dtype."""
    ut = u.transpose(-1, -2)
    *lead, n2, k, n = ut.shape
    b = len(lead) + 1
    v = ut.reshape(*lead, n2, 4, 2, 4, 2, 8, 8)
    return v.permute(*range(b), b + 4, b, b + 5, b + 2, b + 1, b + 3).contiguous()


def _as_u(w, m: int, dtype: torch.dtype) -> torch.Tensor:
    """Spatial (Cout, Cin, 3, 3), transformed (n², Cin, Cout) or ``WinoU``
    → natural U in the activation dtype (the TPU kernel's U operand, :593)."""
    n = m + 2
    if isinstance(w, WinoU):
        w = w.u
    if w.dim() == 4:
        w = transform_weights(w, m)
    if w.dim() != 3 or w.shape[0] != n * n:
        raise ValueError(f"weights must be (Cout, Cin, 3, 3) or ({n * n}, Cin, "
                         f"Cout) for m={m}, got {tuple(w.shape)}")
    return w.to(dtype)


def _bias(b: Optional[torch.Tensor], c: int, like: torch.Tensor) -> torch.Tensor:
    if b is None:
        return torch.zeros(c, dtype=torch.float32, device=like.device)
    return b.float()


# ------------------------------------------------------------- plain twins
def _input_transform(x: torch.Tensor, m: int) -> torch.Tensor:
    """V = Bᵀ·d·B of every (tile, channel), both stages rounded to x.dtype,
    as f32 (n², P, C) with P = (sample, tile row, tile column)."""
    t, c, h, wd = x.shape
    n, xdt = m + 2, x.dtype
    rnd = lambda a: a.to(xdt).float()
    d = F.pad(x.float(), (1, 1, 1, 1)).unfold(2, n, m).unfold(3, n, m)
    # stage 1 over q (columns of the patch), stage 2 over p (rows)
    w1 = rnd(torch.stack(bt_apply(m, list(d.unbind(-1))), -1))    # [..., p, tj]
    v = rnd(torch.stack(bt_apply(m, list(w1.unbind(-2))), -2))    # [..., ti, tj]
    return v.permute(4, 5, 0, 2, 3, 1).reshape(n * n, -1, c)


def wino_conv_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                    m: int, relu: bool = False,
                    residual: Optional[torch.Tensor] = None,
                    res_scale: float = 1.0) -> torch.Tensor:
    """Plain-torch twin of the Winograd conv kernel: NCHW in, NCHW out, in
    x.dtype, with the kernel's rounding points."""
    t, c, h, wd = x.shape
    check_geometry(m, h, wd)
    n = m + 2
    xdt = x.dtype
    rnd = lambda a: a.to(xdt).float()
    u = _as_u(w, m, xdt).float()
    cout = u.shape[2]
    th, tw = h // m, wd // m
    mm = torch.bmm(_input_transform(x, m), u).reshape(n, n, t * th * tw, cout)
    z = torch.stack(at_apply(m, list(mm.unbind(0))), 0)           # (u, tj, P, co)
    y = torch.stack(at_apply(m, list(z.unbind(1))), 1)            # (u, v, P, co)
    y = y + _bias(b, cout, x)
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = rnd(y).reshape(m, m, t, th, tw, cout).permute(2, 5, 3, 0, 4, 1)
    y = y.reshape(t, cout, h, wd)
    if residual is not None:
        if res_scale != 1.0:                   # the product, then the sum
            y = y * np.float32(res_scale)
        y = residual.float() + y
    return y.to(xdt)


def ca_skip_plain(q: torch.Tensor, r: torch.Tensor, caw1: torch.Tensor,
                  cab1: torch.Tensor, caw2: torch.Tensor,
                  cab2: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the channel-attention kernel: q + r·gate with
    gate = sigmoid(W2 relu(W1 mean(r) + b1) + b2), f32 math, q.dtype out."""
    _, hid, gate = _ca_gate(r, caw1, cab1, caw2, cab2)
    return (q.float() + r.float() * gate[:, :, None, None]).to(q.dtype)


def _ca_gate(r, caw1, cab1, caw2, cab2):
    """(mean, hidden, gate) of channel attention on r, in f32 (the JAX
    ``_ca_fwd``, wino_group_grad.py:108)."""
    npix = r.shape[2] * r.shape[3]
    mean = r.float().sum((2, 3)) * np.float32(1.0 / npix)
    hid = torch.clamp_min(mean @ caw1.float().T + cab1.float(), 0.0)
    gate = torch.sigmoid(hid @ caw2.float().T + cab2.float())
    return mean, hid, gate


def wino_conv_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        m: int, y: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None,
                        ds: Optional[torch.Tensor] = None,
                        dprev: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the conv backward kernel (the exact adjoint of
    ``wino_conv_plain``). Returns (dx, dU (n², Cin, Cout) f32, db (Cout,)
    f32); see ``wino_conv_bwd`` for the arguments."""
    t, c, h, wd = x.shape
    check_geometry(m, h, wd)
    n, xdt = m + 2, x.dtype
    rnd = lambda a: a.to(xdt).float()
    u = _as_u(w, m, xdt).float()
    cout = u.shape[2]
    th, tw = h // m, wd // m
    gf = g.float()
    if gate is not None:
        gf = gf * gate.float()[:, :, None, None] + ds.float()[:, :, None, None]
    if y is not None:
        gf = torch.where(y > 0, gf, 0.0)
    db = gf.sum((0, 2, 3))
    gt = gf.reshape(t, cout, th, m, tw, m).permute(3, 5, 0, 2, 4, 1)
    gt = gt.reshape(m, m, -1, cout)                                # (u, v, P, co)
    zz = rnd(torch.stack(at_t_apply(m, list(gt.unbind(1))), 1))     # (u, tj, ..)
    dm = rnd(torch.stack(at_t_apply(m, list(zz.unbind(0))), 0))     # (ti, tj, ..)
    dm = dm.reshape(n * n, -1, cout)
    du = torch.bmm(_input_transform(x, m).transpose(1, 2), dm)
    dv = rnd(torch.bmm(dm, u.transpose(1, 2))).reshape(n, n, -1, c)
    s2 = rnd(torch.stack(bt_t_apply(m, list(dv.unbind(1))), 1))     # (ti, q, ..)
    dd = torch.stack(bt_t_apply(m, list(s2.unbind(0))), 0)          # (p, q, ..)
    dd = dd.reshape(n, n, t, th * tw, c).permute(2, 4, 0, 1, 3)
    dx = F.fold(dd.reshape(t, c * n * n, th * tw), (h, wd), n, padding=1,
                stride=m)
    if dprev is not None:
        return dprev.add_(dx), du, db
    return dx.to(g.dtype), du, db


def ca_skip_bwd_plain(da: torch.Tensor, c2: torch.Tensor, caw1: torch.Tensor,
                      cab1: torch.Tensor, caw2: torch.Tensor,
                      cab2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain-torch twin of the channel-attention backward kernel; see
    ``ca_skip_bwd``."""
    npix = c2.shape[2] * c2.shape[3]
    s, h, gate = _ca_gate(c2, caw1, cab1, caw2, cab2)
    dg = (da.float() * c2.float()).sum((2, 3))
    dz2 = dg * gate * (1.0 - gate)
    dz1 = torch.where(h > 0, dz2 @ caw2.float(), 0.0)
    ds = (dz1 @ caw1.float()) * np.float32(1.0 / npix)
    return gate, ds, dz1.T @ s, dz1.sum(0), dz2.T @ h, dz2.sum(0)


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


def _operand(w, m: int, x: torch.Tensor, c: int, bwd: bool = False) -> torch.Tensor:
    """The conv kernel's U (or, with ``bwd``, the adjoint's Uᵀ) for x: taken
    from a ``WinoU`` as it is, or reordered from a spatial or natural U."""
    n2 = (m + 2) ** 2
    if isinstance(w, WinoU):
        k = w.bwd if bwd else w.fwd
        if (tuple(w.u.shape) != (n2, c, c) or k.dtype != x.dtype
                or k.device != x.device or not k.is_contiguous()):
            raise ValueError(f"WinoU must hold ({n2}, {c}, {c}) in {x.dtype} on "
                             f"{x.device}, got {tuple(w.u.shape)} in {k.dtype} on "
                             f"{k.device}")
        return k
    u = _as_u(w, m, x.dtype)
    if tuple(u.shape) != (n2, c, c) or u.device != x.device:
        raise ValueError(f"U must be ({n2}, {c}, {c}) on {x.device}, "
                         f"got {tuple(u.shape)} on {u.device}")
    return getattr(kernel_u(u), "bwd" if bwd else "fwd")


def _wino_conv_cuda(x, w, b, m, relu, residual, res_scale):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    t, _, h, wd = x.shape
    check_geometry(m, h, wd)
    u = _operand(w, m, x, c)
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
        t, h, wd, m, int(x.dtype == torch.bfloat16), int(relu), float(res_scale),
        x.device.index or 0, _stream(x.device))
    cuda.check(err, "wino_conv kernel")
    LAUNCHES["wino_conv"] += 1
    return y


def _wino_chain_cuda(x, ws, bvec, m, relu):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    t, _, h, wd = x.shape
    check_geometry(m, h, wd)
    k = ws.shape[0]
    if k < 1 or tuple(bvec.shape) != (k, c) or bvec.device != x.device:
        raise ValueError(f"bvec must be ({k}, {c}) on {x.device} for {k} convs, "
                         f"got {tuple(bvec.shape)} on {bvec.device}")
    u = torch.stack([_operand(ws[i], m, x, c) for i in range(k)])
    bias = bvec.float().contiguous()
    x = _channels_last(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    buf = torch.empty_like(y) if k > 1 else y          # unused for one conv
    err = lib.sres_wino_chain(
        x.data_ptr(), u.data_ptr(), bias.data_ptr(), buf.data_ptr(), y.data_ptr(),
        k, t, h, wd, m, int(x.dtype == torch.bfloat16), int(relu),
        x.device.index or 0, _stream(x.device))
    cuda.check(err, "wino_chain kernel")
    LAUNCHES["wino_chain"] += 1
    return y


def _ca_weights(lib, c: int, dev: torch.device, *ws: torch.Tensor
                ) -> Tuple[int, List[torch.Tensor]]:
    """(hidden, [caw1, cab1, caw2, cab2] as contiguous f32), checked against
    what the channel-attention kernels take."""
    hidden = ws[0].shape[0]
    if not 1 <= hidden <= lib.sres_max_hidden():
        raise ValueError(f"channel-attention width {hidden} outside "
                         f"[1, {lib.sres_max_hidden()}]")
    ws = [a.float().contiguous() for a in ws]
    shapes = [(hidden, c), (hidden,), (c, hidden), (c,)]
    for a, s in zip(ws, shapes):
        if tuple(a.shape) != s or a.device != dev:
            raise ValueError(f"channel-attention weights must be {shapes} on {dev}")
    return hidden, ws


def _ca_skip_cuda(q, r, caw1, cab1, caw2, cab2):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(q, "q", c)
    if r.shape != q.shape or r.dtype != q.dtype or r.device != q.device:
        raise ValueError("r must match q in shape, dtype and device")
    hidden, ws = _ca_weights(lib, c, q.device, caw1, cab1, caw2, cab2)
    t, _, h, wd = q.shape
    q, r = _channels_last(q), _channels_last(r)
    bf, dev = int(q.dtype == torch.bfloat16), q.device.index or 0
    n = lib.sres_ca_skip_scratch(t, h * wd, bf, dev)
    if n < 0:
        cuda.check(-n, "ca_skip scratch")
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty_like(q, memory_format=torch.channels_last)
    err = lib.sres_ca_skip(
        q.data_ptr(), r.data_ptr(), *(a.data_ptr() for a in ws),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), t, h * wd,
        hidden, bf, dev, _stream(q.device))
    cuda.check(err, "ca_skip kernel")
    LAUNCHES["ca_skip"] += 1
    return out


def _wino_conv_bwd_cuda(g, x, w, m, y, gate, ds, dprev):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    t, _, h, wd = x.shape
    check_geometry(m, h, wd)
    xdt, f32 = x.dtype, torch.float32
    if g.shape != x.shape or g.device != x.device or g.dtype not in (xdt, f32):
        raise ValueError(f"g must match x in shape and device, in {xdt} or "
                         f"float32; got {tuple(g.shape)} {g.dtype} on {g.device}")
    ut = _operand(w, m, x, c, bwd=True)
    g, x = _channels_last(g), _channels_last(x)
    if y is not None:
        if y.shape != x.shape or y.dtype != xdt or y.device != x.device:
            raise ValueError("y must match x in shape, dtype and device")
        y = _channels_last(y)
    if (gate is None) != (ds is None):
        raise ValueError("gate and ds go together")
    if gate is not None:
        gate, ds = gate.float().contiguous(), ds.float().contiguous()
        if gate.shape != (t, c) or ds.shape != (t, c) or gate.device != x.device:
            raise ValueError(f"gate and ds must be ({t}, {c}) on {x.device}")
    if dprev is not None:
        if (dprev.shape != x.shape or dprev.dtype != f32 or dprev.device != x.device
                or not dprev.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("dprev must be a channels_last float32 tensor "
                             "shaped like x")
        out, mode = dprev, 2
    else:
        out = torch.empty_like(x, dtype=g.dtype, memory_format=torch.channels_last)
        mode = 1 if g.dtype == f32 else 0
    bf = int(xdt == torch.bfloat16)
    # the kernels' per-CTA partials of db and dU: no tensor of tiles × n²
    n = lib.sres_wino_bwd_scratch(t, h, wd, m, bf)
    if n < 0:
        raise ValueError(f"conv backward takes no ({t}, {c}, {h}, {wd}) at m={m}")
    emp = lambda *s: torch.empty(s, dtype=f32, device=x.device)
    scratch, du, db = emp(n), emp((m + 2) ** 2, c, c), emp(c)
    ptr = lambda a: a.data_ptr() if a is not None else None
    err = lib.sres_wino_conv_bwd(
        g.data_ptr(), x.data_ptr(), ptr(y), ut.data_ptr(), ptr(gate), ptr(ds),
        scratch.data_ptr(), out.data_ptr(), du.data_ptr(), db.data_ptr(),
        t, h, wd, m, bf, int(g.dtype == f32), mode, x.device.index or 0,
        _stream(x.device))
    cuda.check(err, "wino_conv_bwd kernel")
    LAUNCHES["wino_conv_bwd"] += 1
    return out, du, db


_SCRATCH: Dict[tuple, int] = {}


def _scratch(query: Callable[..., int], nimg: int, hw: int, bf: int, dev: int) -> int:
    """Floats of scratch a channel-attention backward kernel takes for this
    shape (``query``: its library's ``*_scratch`` entry), asked once per
    shape and device."""
    key = (query.__name__, nimg, hw, bf, dev)
    n = _SCRATCH.get(key)
    if n is None:
        from sres_tpu_torch.ops import cuda
        n = query(nimg, hw, bf, dev)
        if n < 0:
            cuda.check(-n, f"{query.__name__}({nimg}, {hw})")
        _SCRATCH[key] = n
    return n


def _ca_skip_bwd_cuda(da, c2, caw1, cab1, caw2, cab2):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(c2, "c2", c)
    if da.shape != c2.shape or da.dtype != torch.float32 or da.device != c2.device:
        raise ValueError("da must be a float32 tensor shaped like c2")
    hidden, ws = _ca_weights(lib, c, c2.device, caw1, cab1, caw2, cab2)
    t, _, h, wd = c2.shape
    da, c2 = _channels_last(da), _channels_last(c2)
    bf, dev = int(c2.dtype == torch.bfloat16), c2.device.index or 0
    nscratch = _scratch(lib.sres_ca_skip_bwd_scratch, t, h * wd, bf, dev)
    emp = lambda *s: torch.empty(s, dtype=torch.float32, device=c2.device)
    scratch, gate, ds = emp(nscratch), emp(t, c), emp(t, c)
    dw1, db1, dw2, db2 = emp(hidden, c), emp(hidden), emp(c, hidden), emp(c)
    err = lib.sres_ca_skip_bwd(
        da.data_ptr(), c2.data_ptr(), *(a.data_ptr() for a in ws),
        scratch.data_ptr(), gate.data_ptr(), ds.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
        t, h * wd, hidden, bf, dev, _stream(c2.device))
    cuda.check(err, "ca_skip_bwd kernel")
    LAUNCHES["ca_skip_bwd"] += 1
    return gate, ds, dw1, db1, dw2, db2


# ----------------------------------------------------------------- entries
def wino_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              m: int, relu: bool = False,
              residual: Optional[torch.Tensor] = None,
              res_scale: float = 1.0) -> torch.Tensor:
    """3×3 SAME conv by Winograd F(m, 3) (+ bias, optional ReLU, optional
    ``residual + res_scale·y`` epilogue: the product rounded to f32, then
    the sum, rounded once to x.dtype). CUDA tensor → kernel; CPU tensor →
    twin."""
    if x.device.type == "cpu":
        return wino_conv_plain(x, w, b, m, relu, residual, res_scale)
    return _wino_conv_cuda(x, w, b, m, relu, residual, res_scale)


def wino_chain_fwd_plain(x: torch.Tensor, ws: torch.Tensor, bvec: torch.Tensor,
                         m: int, relu: bool = True) -> torch.Tensor:
    """Plain-torch twin of the chain kernel: K calls of ``wino_conv_plain``,
    each output rounded to x.dtype."""
    for i in range(ws.shape[0]):
        x = wino_conv_plain(x, ws[i], bvec[i], m, relu)
    return x


def wino_chain_fwd(x: torch.Tensor, ws: torch.Tensor, bvec: torch.Tensor,
                   m: int, relu: bool = True) -> torch.Tensor:
    """K chained 3×3 SAME Winograd convs (+ bias, + ReLU) in one launch, the
    counterpart of the JAX probe ``wino_chain_fwd`` (forward only; no model
    calls it). ws: (K, Cout, Cin, 3, 3), (K, n², Cin, Cout) or a stacked
    ``WinoU``; bvec (K, C).
    CUDA tensor → one cooperative launch of the chain kernel (which equals
    K ``wino_conv`` launches bit for bit); CPU tensor → twin."""
    if x.device.type == "cpu":
        return wino_chain_fwd_plain(x, ws, bvec, m, relu)
    return _wino_chain_cuda(x, ws, bvec, m, relu)


def ca_skip(q: torch.Tensor, r: torch.Tensor, caw1: torch.Tensor,
            cab1: torch.Tensor, caw2: torch.Tensor,
            cab2: torch.Tensor) -> torch.Tensor:
    """RCAB channel attention + block skip: q + r·gate(r). CUDA tensor →
    one kernel launch (``ops/cuda/winograd.cu`` kernel (b)); CPU → twin.
    Which kernel is the C library's choice by shape
    (``sres_ca_skip_cluster``): when a sample's r fits the shared memory of
    a cluster of 1, 2, 4 or 8 blocks (up to 580 pixels a block in bf16,
    290 in f32: 48×48 LR tiles in either dtype), ``ca_cluster_kernel``,
    which reads r from device memory once; for larger samples (above 4640
    pixels in bf16, as 96×96 LR; above 2320 in f32) ``ca_two_pass_kernel``,
    one cooperative launch that reads r twice."""
    if q.device.type == "cpu":
        return ca_skip_plain(q, r, caw1, cab1, caw2, cab2)
    return _ca_skip_cuda(q, r, caw1, cab1, caw2, cab2)


def wino_conv_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, m: int,
                  y: Optional[torch.Tensor] = None,
                  gate: Optional[torch.Tensor] = None,
                  ds: Optional[torch.Tensor] = None,
                  dprev: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact adjoint of ``wino_conv`` (no residual): returns (dx, dU, db).

    g: output cotangent (T, C, H, W) in x.dtype or float32; x: the conv
    input; w: (Cout, Cin, 3, 3) or U (n², Cin, Cout). Prologue options: ``y``
    (the output of a fused ReLU) gates g by y > 0; ``gate``/``ds`` ((T, C)
    f32) make it g·gate + ds, the channel-attention cotangent. dx is summed
    in f32: added in place into ``dprev`` (an f32 buffer shaped like x,
    returned), or else rounded once to g.dtype. dU (n², Cin, Cout) and db
    (Cout,) are f32 sums over the batch. CUDA tensor → kernel; CPU → twin."""
    if x.device.type == "cpu":
        return wino_conv_bwd_plain(g, x, w, m, y, gate, ds, dprev)
    return _wino_conv_bwd_cuda(g, x, w, m, y, gate, ds, dprev)


def ca_skip_bwd(da: torch.Tensor, c2: torch.Tensor, caw1: torch.Tensor,
                cab1: torch.Tensor, caw2: torch.Tensor,
                cab2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Backward of channel attention on c2, given the f32 cotangent ``da``
    of the RCAB output q + c2·gate(c2): returns (gate, ds, dcaw1, dcab1,
    dcaw2, dcab2), all f32, where the cotangent of c2 is da·gate + ds
    (``wino_conv_bwd``'s CA prologue). CUDA tensor → kernel; CPU → twin."""
    if c2.device.type == "cpu":
        return ca_skip_bwd_plain(da, c2, caw1, cab1, caw2, cab2)
    return _ca_skip_bwd_cuda(da, c2, caw1, cab1, caw2, cab2)


def _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
           conv: Callable, ca: Callable,
           stash: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    q = x
    for i in range(ws.shape[0]):
        if stash is not None:
            stash.append(q)                    # RCAB input a_i
        r = conv(q, ws[i, 0], bvec[i, 0], m, relu=True)
        r = conv(r, ws[i, 1], bvec[i, 1], m)
        q = ca(q, r, caw1[i], cab1[i], caw2[i], cab2[i])
    if wt is not None:
        if stash is not None:
            stash.append(q)                    # chain output z
        q = conv(q, wt, bt, m, residual=x)
    return q


def wino_group_fwd(x: torch.Tensor, ws: torch.Tensor, bvec: torch.Tensor,
                   caw1: torch.Tensor, cab1: torch.Tensor, caw2: torch.Tensor,
                   cab2: torch.Tensor, m: int, wt: Optional[torch.Tensor] = None,
                   bt: Optional[torch.Tensor] = None,
                   stash: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """A residual group's RCAB stack (gated mode): per block conv+ReLU →
    conv → channel attention → skip; with ``wt``/``bt`` also the trailing
    conv and the group skip (``x + conv(q)``). With a ``stash`` list, each
    RCAB input and the chain output are appended to it as the chain runs
    (the backward's residuals: the JAX stash-in-primal mode,
    wino_group_grad.py:54-63, whose gradients equal the replay's).

    ws: (nb, 2, Cout, Cin, 3, 3) or (nb, 2, n², Cin, Cout); bvec (nb, 2, C);
    caw1 (nb, hidden, C); cab1 (nb, hidden); caw2 (nb, C, hidden); cab2
    (nb, C); wt (Cout, Cin, 3, 3) or (n², Cin, Cout); bt (C,)."""
    return _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
                  wino_conv, ca_skip, stash)


def wino_group_fwd_plain(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt=None,
                         bt=None, stash=None) -> torch.Tensor:
    """Plain-torch twin of ``wino_group_fwd`` on any device."""
    return _group(x, ws, bvec, caw1, cab1, caw2, cab2, m, wt, bt,
                  wino_conv_plain, ca_skip_plain, stash)


def _group_bwd(dy, stash, ws, bvec, caw1, cab1, caw2, cab2, m, wt,
               conv: Callable, conv_bwd: Callable, ca_bwd: Callable):
    nb, xdt = ws.shape[0], stash[0].dtype
    # the trailing conv's adjoint takes dy in the activation dtype (:631)
    dz, dut, dbt = conv_bwd(dy.to(xdt), stash[nb], wt, m)
    da = dz.float()                            # fresh: accumulated in place
    grads = []
    for k in reversed(range(nb)):
        a = stash[k]
        # recompute the RCAB's convs from its stashed input (:358-366)
        c1 = conv(a, ws[k, 0], bvec[k, 0], m, relu=True)
        c2 = conv(c1, ws[k, 1], bvec[k, 1], m)
        gate, ds, dcw1, dcb1, dcw2, dcb2 = ca_bwd(da, c2, caw1[k], cab1[k],
                                                  caw2[k], cab2[k])
        dc, du2, db2 = conv_bwd(da, c1, ws[k, 1], m, gate=gate, ds=ds)
        # da (the skip's cotangent) += conv1's adjoint, ReLU-gated by c1
        _, du1, db1 = conv_bwd(dc, a, ws[k, 0], m, y=c1, dprev=da)
        grads.append((torch.stack([du1, du2]), torch.stack([db1, db2]),
                      dcw1, dcb1, dcw2, dcb2))
    st = lambda i: torch.stack([gr[i] for gr in reversed(grads)])
    dx = (da + dy.float()).to(xdt)             # the group skip, in f32
    return (dx, st(0), st(1), st(2), st(3), st(4), st(5), dut, dbt)


def wino_group_bwd(dy, stash, ws, bvec, caw1, cab1, caw2, cab2, m, wt):
    """Backward of ``wino_group_fwd`` with the trailing conv, from the stash
    it wrote: the trailing conv's adjoint, then RCAB nb-1 … 0 (recompute c1
    and c2; CA backward; conv2's adjoint with the CA prologue into an f32
    dc; conv1's adjoint gated by c1 > 0, accumulated into the f32 skip
    cotangent da), then the group skip da + dy. Returns (dx, dU (nb, 2, n²,
    Cin, Cout), db (nb, 2, C), dcaw1, dcab1, dcaw2, dcab2, dUt, dbt), the
    gradients f32 and dx in the activation dtype."""
    return _group_bwd(dy, stash, ws, bvec, caw1, cab1, caw2, cab2, m, wt,
                      wino_conv, wino_conv_bwd, ca_skip_bwd)


def wino_group_bwd_plain(dy, stash, ws, bvec, caw1, cab1, caw2, cab2, m, wt,
                         conv: Callable = wino_conv_plain):
    """Plain-torch twin of ``wino_group_bwd`` on any device. ``conv``
    recomputes each RCAB's convs; ``wino_conv`` gives the twin the kernel
    path's forward values, so that no ReLU gate whose input sits within
    rounding of zero opens on one side and not the other."""
    return _group_bwd(dy, stash, ws, bvec, caw1, cab1, caw2, cab2, m, wt,
                      conv, wino_conv_bwd_plain, ca_skip_bwd_plain)


def _resgroup(x, ws, bvec, m, wt, bt, res_scale, conv: Callable,
              stash: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    q = x
    for i in range(ws.shape[0]):
        if stash is not None:
            stash.append(q)                    # ResBlock input a_i
        r = conv(q, ws[i, 0], bvec[i, 0], m, relu=True)
        q = conv(r, ws[i, 1], bvec[i, 1], m, residual=q, res_scale=res_scale)
    if stash is not None:
        stash.append(q)                        # chain output z
    return conv(q, wt, bt, m, residual=x)


def wino_resgroup_fwd(x: torch.Tensor, ws: torch.Tensor, bvec: torch.Tensor,
                      m: int, wt: torch.Tensor, bt: torch.Tensor,
                      res_scale: float = 1.0,
                      stash: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """A stack of plain ResBlocks with the trailing conv and the skip (the
    ungated group, JAX ``wino_resgroup_trail``, wino_group_grad.py:719; the
    EDSR trunk): per block conv+ReLU, then conv with the scaled residual
    epilogue ``q + res_scale·c2`` (winograd_conv.py:545); then the
    trailing conv with ``x + conv(q)``. With a ``stash`` list each block
    input and the chain output are appended to it as the chain runs.

    ws: (nb, 2, Cout, Cin, 3, 3) or (nb, 2, n², Cin, Cout); bvec (nb, 2, C);
    wt (Cout, Cin, 3, 3) or (n², Cin, Cout); bt (C,)."""
    return _resgroup(x, ws, bvec, m, wt, bt, res_scale, wino_conv, stash)


def wino_resgroup_fwd_plain(x, ws, bvec, m, wt, bt, res_scale=1.0,
                            stash=None) -> torch.Tensor:
    """Plain-torch twin of ``wino_resgroup_fwd`` on any device."""
    return _resgroup(x, ws, bvec, m, wt, bt, res_scale, wino_conv_plain, stash)


def _resgroup_bwd(dy, stash, ws, bvec, m, wt, res_scale,
                  conv: Callable, conv_bwd: Callable):
    nb, xdt = ws.shape[0], stash[0].dtype
    dz, dut, dbt = conv_bwd(dy.to(xdt), stash[nb], wt, m)
    da = dz.float()                            # fresh: accumulated in place
    # conv2's cotangent da·res_scale through the conv adjoint's channel-
    # attention prologue (g·gate + ds) with a constant gate and ds = 0,
    # which is exact; at res_scale 1 da goes in as it is
    scale = {}
    if res_scale != 1.0:
        t, c = da.shape[:2]
        scale = dict(gate=torch.full((t, c), res_scale, device=da.device),
                     ds=torch.zeros((t, c), device=da.device))
    dus, dbs = [], []
    for k in reversed(range(nb)):
        a = stash[k]
        # recompute c1 only: the ungated backward never reads c2 (JAX
        # recomputes it, wino_group_grad.py:364-366)
        c1 = conv(a, ws[k, 0], bvec[k, 0], m, relu=True)
        dc, du2, db2 = conv_bwd(da, c1, ws[k, 1], m, **scale)
        # da (the skip's cotangent) += conv1's adjoint, ReLU-gated by c1
        _, du1, db1 = conv_bwd(dc, a, ws[k, 0], m, y=c1, dprev=da)
        dus.append(torch.stack([du1, du2]))
        dbs.append(torch.stack([db1, db2]))
    dx = (da + dy.float()).to(xdt)             # the skip, in f32
    return dx, torch.stack(dus[::-1]), torch.stack(dbs[::-1]), dut, dbt


def wino_resgroup_bwd(dy, stash, ws, bvec, m, wt, res_scale=1.0):
    """Backward of ``wino_resgroup_fwd`` from the stash it wrote: the
    trailing conv's adjoint, then blocks nb-1 … 0 (recompute c1; conv2's
    adjoint on da·res_scale into an f32 dc; conv1's adjoint gated by c1 > 0,
    accumulated into the f32 skip cotangent da), then dx = da + dy.
    Returns (dx, dU (nb, 2, n², Cin, Cout), db (nb, 2, C), dUt, dbt), the
    gradients f32 and dx in the activation dtype."""
    return _resgroup_bwd(dy, stash, ws, bvec, m, wt, res_scale, wino_conv,
                         wino_conv_bwd)


def wino_resgroup_bwd_plain(dy, stash, ws, bvec, m, wt, res_scale=1.0,
                            conv: Callable = wino_conv_plain):
    """Plain-torch twin of ``wino_resgroup_bwd`` on any device; ``conv``
    recomputes c1 (``wino_conv`` gives it the kernel path's values, as in
    ``wino_group_bwd_plain``)."""
    return _resgroup_bwd(dy, stash, ws, bvec, m, wt, res_scale, conv,
                         wino_conv_bwd_plain)


# ------------------------------------------------------- autograd Functions
class WinoConvFn(torch.autograd.Function):
    """y = conv(x, weight) + bias [+ residual] through ``wino_conv``, with
    ``wino_conv_bwd`` as its backward (the ``wino_conv_quad`` VJP,
    winograd_conv.py:677-696). ``u`` is the caller's transform of
    ``weight`` in x.dtype (a tensor or a ``WinoU``, kept on ``ctx``: a cache,
    never an inference tensor); the weight gradient is
    untransform_weight_grad(dU), in the weight's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, u, m, plain=False):
        y = (wino_conv_plain if plain else wino_conv)(x, u, bias, m,
                                                      residual=residual)
        ctx.save_for_backward(x)
        ctx.u, ctx.m, ctx.plain = u, m, plain
        ctx.dtypes = (weight.dtype, None if bias is None else bias.dtype,
                      None if residual is None else residual.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        bwd = wino_conv_bwd_plain if ctx.plain else wino_conv_bwd
        dx, du, db = bwd(dy.to(x.dtype), x, ctx.u, ctx.m)
        wdt, bdt, rdt = ctx.dtypes
        return (dx, untransform_weight_grad(du, ctx.m).to(wdt),
                None if bdt is None else db.to(bdt),
                None if rdt is None else dy.to(rdt), None, None, None)


class WinoGroupTrailFn(torch.autograd.Function):
    """A residual group with its trailing conv and group skip (the JAX
    ``wino_group_trail``, wino_group_grad.py:583-649): the forward is
    ``wino_group_fwd`` writing the stash, the backward ``wino_group_bwd``.

    ``ops`` = (ws, bvec, caw1, cab1, caw2, cab2, wt, bt) as
    ``wino_group_fwd`` takes them (the caller's transforms of its
    parameters); ``params`` are the group's parameters in module order,
    per RCAB (conv1 w, b, conv2 w, b, CA conv 1 w, b, CA conv 2 w, b), then
    the trailing conv's w, b (every one present: a group's convs always
    have a bias). Each gets its gradient in its own dtype and shape."""

    @staticmethod
    def forward(ctx, x, ops, m, plain, *params):
        stash: List[torch.Tensor] = []
        fwd = wino_group_fwd_plain if plain else wino_group_fwd
        y = fwd(x, *ops[:6], m, ops[6], ops[7], stash)
        ctx.save_for_backward(*stash)
        ctx.ops, ctx.m, ctx.plain = ops, m, plain
        ctx.metas = [(p.shape, p.dtype) for p in params]
        return y

    @staticmethod
    def backward(ctx, dy):
        ws, bvec, caw1, cab1, caw2, cab2, wt, _ = ctx.ops
        bwd = wino_group_bwd_plain if ctx.plain else wino_group_bwd
        dx, du, db, dcw1, dcb1, dcw2, dcb2, dut, dbt = bwd(
            dy, list(ctx.saved_tensors), ws, bvec, caw1, cab1, caw2, cab2,
            ctx.m, wt)
        dws = untransform_weight_grad(du, ctx.m)          # (nb, 2, Co, Ci, 3, 3)
        flat = []
        for k in range(ws.shape[0]):
            flat += [dws[k, 0], db[k, 0], dws[k, 1], db[k, 1],
                     dcw1[k], dcb1[k], dcw2[k], dcb2[k]]
        flat += [untransform_weight_grad(dut, ctx.m), dbt]
        grads = [gr.reshape(shape).to(dt) for gr, (shape, dt) in zip(flat, ctx.metas)]
        return (dx, None, None, None, *grads)


class WinoResGroupTrailFn(torch.autograd.Function):
    """The ungated group with its trailing conv and skip (the JAX
    ``wino_resgroup_trail`` and its VJP, wino_group_grad.py:719-770): the
    forward is ``wino_resgroup_fwd`` writing the stash, the backward
    ``wino_resgroup_bwd``.

    ``ops`` = (ws, bvec, wt, bt) as ``wino_resgroup_fwd`` takes them;
    ``params`` are the parameters in module order, per ResBlock (conv1 w,
    b, conv2 w, b), then the trailing conv's w, b, with None for an absent
    bias. Each gets its gradient in its own dtype and shape."""

    @staticmethod
    def forward(ctx, x, ops, m, res_scale, plain, *params):
        stash: List[torch.Tensor] = []
        fwd = wino_resgroup_fwd_plain if plain else wino_resgroup_fwd
        ws, bvec, wt, bt = ops
        y = fwd(x, ws, bvec, m, wt, bt, res_scale, stash)
        ctx.save_for_backward(*stash)
        ctx.ops, ctx.m, ctx.res_scale, ctx.plain = ops, m, res_scale, plain
        ctx.metas = [None if p is None else (p.shape, p.dtype) for p in params]
        return y

    @staticmethod
    def backward(ctx, dy):
        ws, bvec, wt, _ = ctx.ops
        bwd = wino_resgroup_bwd_plain if ctx.plain else wino_resgroup_bwd
        dx, du, db, dut, dbt = bwd(dy, list(ctx.saved_tensors), ws, bvec, ctx.m,
                                   wt, ctx.res_scale)
        dws = untransform_weight_grad(du, ctx.m)          # (nb, 2, Co, Ci, 3, 3)
        flat = []
        for k in range(ws.shape[0]):
            flat += [dws[k, 0], db[k, 0], dws[k, 1], db[k, 1]]
        flat += [untransform_weight_grad(dut, ctx.m), dbt]
        grads = [None if meta is None else gr.reshape(meta[0]).to(meta[1])
                 for gr, meta in zip(flat, ctx.metas)]
        return (dx, None, None, None, None, *grads)
