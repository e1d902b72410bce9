"""The direct-conv residual group (``model.fused: true``): CUDA kernels,
plain twins, the group's forward and backward, and its autograd Function.

Counterpart of sres_tpu/ops/pallas/attic/residual_group.py: the forward
kernel ``_fwd_kernel`` (:80, via ``_fwd_call`` :136) runs nb × RCAB and the
trailing conv of a group with every conv a direct 3×3 conv (9 accumulated
(M, C)·(C, C) products on shifted rows, :91-96), writing stashes of each
RCAB's input x, ReLU output a, conv2 output c and gate; the backward kernel
``_bwd_kernel`` (:194, via ``_bwd_call`` :339) walks the group in reverse
from those stashes. On the TPU one kernel keeps a whole 48×48 tile resident
in VMEM; a tile is 288 KiB in bf16, more than an SM's shared memory, and
channel attention needs the mean of the whole conv2 output before its gate
applies. So here a group is a sequence of launches of four kernels
(``ops/cuda/fused_group.cu``), two passes per RCAB around channel
attention:

- ``fgroup_conv``: direct 3×3 SAME conv, 64 → 64, with an input prologue
  (x·gate + ds, the CA cotangent) and an epilogue (+ bias, ReLU, a mask
  ``m > 0``, per-tile channel sums of the f32 output, ``(res + v) + res2``,
  output in the activation dtype or f32). With flipped, transposed
  weights it is also the adjoint (dgrad) of a conv.
- ``fgroup_ca``: sums the conv's per-tile partials in a fixed order →
  mean → 1×1 → ReLU → 1×1 → sigmoid gate, once per sample, then x +
  c·gate (one cooperative launch, ``fg_ca_stream_kernel``).
- ``fgroup_wgrad``: dW[tap] = Σ_pixels x_shift(tap)ᵀ · g and db = Σ g; in
  bf16 one launch whose clusters reduce on chip in a fixed order (in f32
  per-block partials and a fixed-order sum).
- ``fgroup_ca_bwd``: the channel-attention backward (ds = dm/npix and the
  CA weight gradients).

Rounding points (kernels and twins alike; every product accumulates in
f32), those of the TPU kernel (:105-133, :260-336): conv weights and CA
weights are in the activation dtype T (``group_ops`` rounds the CA weights,
which the kernels take as f32; the entries use them as given), biases f32;
r1 = conv(x, w1) + b1 in f32, a = T(relu(r1)); c = conv(a, w2) + b2 in f32,
stashed as T; the CA mean is over the f32 c and rounded to T, as is the
hidden vector; the gate is f32; x_next = T(x + c·gate); y = T(skip +
conv(x_nb, wg) + bg). Backward:
the cotangent is rounded to T; the CA recompute reads the T-stashed c; dc =
g·gate + dm/npix and dr1 are rounded to T for their dgrad and wgrad (db2,
db1 sum the f32 values); da is f32; the ReLU mask comes from the T stash of
a; the running cotangent is T between RCABs; the group skip's cotangent is
added at the first RCAB. The weight gradients stay f32 (the JAX VJP casts
them to the weights' dtype, :446-449).

Layouts: activations NCHW (the kernels take channels_last memory and return
channels_last). A conv's weights ``wk`` are (9, Cout, Cin) in T, tap t =
3·ky + kx: ``conv_weights(w)`` for a conv, ``dgrad_weights(w)`` for its
adjoint. CA weights are the squeezed 1×1 conv weights (hidden, C) and (C,
hidden). Dispatch is by the device of the activation: a CPU tensor goes to
the ``*_plain`` twin, a CUDA tensor to the kernel, which raises if it does
not build or launch. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sres_tpu_torch.ops.winograd_conv import (_channels_last, _check_act, _scratch,
                                             _stream)

LAUNCHES: Dict[str, int] = {"fgroup_conv": 0, "fgroup_ca": 0, "fgroup_wgrad": 0,
                            "fgroup_ca_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def conv_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., Cout, Cin, 3, 3) → the kernel's (..., 9, Cout, Cin) in ``dtype``."""
    *lead, co, ci, _, _ = w.shape
    w = w.detach().movedim((-2, -1), (-4, -3))
    return w.reshape(*lead, 9, co, ci).to(dtype).contiguous()


def dgrad_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weights of a conv's adjoint: w'[ky, kx][ci][co] = w[co][ci][2-ky][2-kx],
    as (..., 9, Cin, Cout) in ``dtype``."""
    return conv_weights(w.detach().flip(-2, -1).transpose(-4, -3), dtype)


def torch_weight_grad(dw: torch.Tensor) -> torch.Tensor:
    """The wgrad's (9, Cin, Cout) → a conv weight's (Cout, Cin, 3, 3)."""
    _, ci, co = dw.shape
    return dw.reshape(3, 3, ci, co).permute(3, 2, 0, 1)


def _rnd(a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return a.to(dt).float()


def _chan(v: torch.Tensor) -> torch.Tensor:
    """(N, C) → (N, C, 1, 1)."""
    return v[:, :, None, None]


# ------------------------------------------------------------- plain twins
def fgroup_conv_plain(x, wk, bias=None, *, relu=False, out_dtype=None, gate=None,
                      ds=None, mask=None, res=None, res2=None, partials=False):
    """Plain-torch twin of ``fgroup_conv`` (f32 math on the T-rounded
    operands, the kernel's rounding points). Its partials are one sum per
    sample, (N, 1, C)."""
    dt = x.dtype
    xf = x.float()
    if gate is not None:
        xf = _rnd(xf * _chan(gate) + _chan(ds), dt)
    co, ci = wk.shape[1:]
    v = F.conv2d(xf, wk.float().reshape(3, 3, co, ci).permute(2, 3, 0, 1), padding=1)
    if bias is not None:
        v = v + _chan(bias.float()[None])
    if relu:
        v = torch.clamp_min(v, 0.0)
    if mask is not None:
        v = torch.where(mask > 0, v, 0.0)
    part = v.sum((2, 3))[:, None] if partials else None
    if res is not None:
        v = res.float() + v
    if res2 is not None:
        v = v + res2.float()
    y = v.to(out_dtype or dt)
    return (y, part) if partials else y


def _ca_hidden(mean_r, cw1, cb1):
    """v = T(mean)·W1ᵀ + b1 (f32) of channel attention."""
    return mean_r @ cw1.float().T + cb1.float()


def fgroup_ca_plain(x, c, part, cw1, cb1, cw2, cb2, stash_c=False):
    """Plain-torch twin of ``fgroup_ca``."""
    dt = x.dtype
    mean = part.sum(1) / float(c.shape[2] * c.shape[3])
    hid = _rnd(torch.clamp_min(_ca_hidden(_rnd(mean, dt), cw1, cb1), 0.0), dt)
    gate = torch.sigmoid(hid @ cw2.float().T + cb2.float())
    xn = (x.float() + c.float() * _chan(gate)).to(dt)
    return xn, gate, (c.to(dt) if stash_c else None)


def fgroup_wgrad_plain(x, g, gate=None, ds=None, db_part=None):
    """Plain-torch twin of ``fgroup_wgrad``."""
    dt, (_, _, h, w) = x.dtype, x.shape
    gf = g.float()
    if gate is not None:
        gf = gf * _chan(gate) + _chan(ds)
    db = db_part.sum((0, 1)) if db_part is not None else gf.sum((0, 2, 3))
    gr = _rnd(gf, dt)
    xp = F.pad(x.float(), (1, 1, 1, 1))
    dw = torch.stack([torch.einsum("nihw,nohw->io", xp[:, :, ky:ky + h, kx:kx + w], gr)
                      for ky in range(3) for kx in range(3)])
    return dw, db


def fgroup_ca_bwd_plain(g, c, gate, cw1, cb1, cw2, cb2):
    """Plain-torch twin of ``fgroup_ca_bwd``."""
    dt = c.dtype
    npix = float(c.shape[2] * c.shape[3])
    gf, cf = g.float(), c.float()
    dsg = (gf * cf).sum((2, 3))
    m_r = _rnd(cf.sum((2, 3)) / npix, dt)
    v = _ca_hidden(m_r, cw1, cb1)
    du = dsg * gate * (1.0 - gate)
    du_r, h_r = _rnd(du, dt), _rnd(torch.clamp_min(v, 0.0), dt)
    dv = torch.where(v > 0, du_r @ cw2.float(), 0.0)
    dv_r = _rnd(dv, dt)
    ds = (dv_r @ cw1.float()) / npix
    return ds, dv_r.T @ m_r, dv.sum(0), du_r.T @ h_r, du.sum(0)


# ----------------------------------------------------------- CUDA wrappers
def _ptr(a: Optional[torch.Tensor]) -> Optional[int]:
    return a.data_ptr() if a is not None else None


def _like(a: Optional[torch.Tensor], x: torch.Tensor, name: str
          ) -> Optional[torch.Tensor]:
    """``a`` checked to match x in shape, dtype and device, channels_last."""
    if a is None:
        return None
    if a.shape != x.shape or a.dtype != x.dtype or a.device != x.device:
        raise ValueError(f"{name} must match x in shape, dtype and device")
    return _channels_last(a)


def _vec(a: Optional[torch.Tensor], shape: Tuple[int, ...], dev: torch.device,
         name: str) -> Optional[torch.Tensor]:
    """``a`` as a contiguous, 16-byte aligned f32 tensor of ``shape`` on ``dev``."""
    if a is None:
        return None
    if tuple(a.shape) != shape or a.device != dev:
        raise ValueError(f"{name} must be {shape} on {dev}, got "
                         f"{tuple(a.shape)} on {a.device}")
    a = a.float().contiguous()
    return a.clone() if a.data_ptr() % 16 else a


def _gate_ds(gate, ds, n: int, c: int, dev: torch.device):
    if (gate is None) != (ds is None):
        raise ValueError("gate and ds go together")
    return _vec(gate, (n, c), dev, "gate"), _vec(ds, (n, c), dev, "ds")


def _conv_cuda(x, wk, bias, relu, out_dtype, gate, ds, mask, res, res2, partials):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    n, _, h, w = x.shape
    xdt, f32 = x.dtype, torch.float32
    out_dtype = out_dtype or xdt
    if out_dtype not in (xdt, f32):
        raise TypeError(f"output dtype must be {xdt} or float32, got {out_dtype}")
    if tuple(wk.shape) != (9, c, c) or wk.dtype != xdt or wk.device != x.device:
        raise ValueError(f"weights must be (9, {c}, {c}) {xdt} on {x.device}, got "
                         f"{tuple(wk.shape)} {wk.dtype} on {wk.device}")
    wk = wk.contiguous()
    if wk.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    bias = _vec(bias, (c,), x.device, "bias")
    gate, ds = _gate_ds(gate, ds, n, c, x.device)
    x = _channels_last(x)
    mask, res, res2 = (_like(a, x, nm) for a, nm in ((mask, "mask"), (res, "res"),
                                                      (res2, "res2")))
    y = torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)
    bf = int(xdt == torch.bfloat16)
    part = (torch.empty((n, lib.sres_fg_tiles(h, w, bf), c), dtype=f32, device=x.device)
            if partials else None)
    err = lib.sres_fg_conv(
        x.data_ptr(), wk.data_ptr(), _ptr(bias), _ptr(gate), _ptr(ds), _ptr(mask),
        _ptr(res), _ptr(res2), y.data_ptr(), _ptr(part), n, h, w, bf,
        int(out_dtype == f32), int(relu),
        x.device.index or 0, _stream(x.device))
    cuda.check(err, "fgroup_conv kernel")
    LAUNCHES["fgroup_conv"] += 1
    return (y, part) if partials else y


def _ca_weights(lib, c: int, dev: torch.device, cw1, cb1, cw2, cb2):
    """The CA weights as the kernels take them: contiguous f32."""
    hidden = cw1.shape[0]
    if not 1 <= hidden <= lib.sres_max_hidden():
        raise ValueError(f"channel-attention width {hidden} outside "
                         f"[1, {lib.sres_max_hidden()}]")
    shapes = ((hidden, c), (hidden,), (c, hidden), (c,))
    return hidden, [_vec(a, s, dev, "channel-attention weights")
                    for a, s in zip((cw1, cb1, cw2, cb2), shapes)]


def _ca_cuda(x, c, part, cw1, cb1, cw2, cb2, stash_c):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ch = lib.sres_channels()
    _check_act(x, "x", ch)
    n, _, h, w = x.shape
    f32 = torch.float32
    if c.shape != x.shape or c.dtype != f32 or c.device != x.device:
        raise ValueError("c must be a float32 tensor shaped like x")
    if part.dim() != 3 or part.shape[0] != n or part.shape[2] != ch or part.dtype != f32:
        raise ValueError(f"part must be ({n}, P, {ch}) float32")
    hidden, ws = _ca_weights(lib, ch, x.device, cw1, cb1, cw2, cb2)
    x, c, part = _channels_last(x), _channels_last(c), part.contiguous()
    if part.data_ptr() % 16:                   # the kernel reads its rows in float4
        part = part.clone()
    xn = torch.empty_like(x, memory_format=torch.channels_last)
    gate = torch.empty((n, ch), dtype=f32, device=x.device)
    bf = x.dtype == torch.bfloat16
    cst = torch.empty_like(xn) if stash_c and bf else None
    err = lib.sres_fg_ca(
        x.data_ptr(), c.data_ptr(), part.data_ptr(), part.shape[1],
        *(a.data_ptr() for a in ws), xn.data_ptr(), gate.data_ptr(), _ptr(cst),
        n, h * w, hidden, int(bf), x.device.index or 0,
        _stream(x.device))
    cuda.check(err, "fgroup_ca kernel")
    LAUNCHES["fgroup_ca"] += 1
    if stash_c and not bf:
        cst = c                                # in f32 the stash is c itself
    return xn, gate, cst


def _wgrad_cuda(x, g, gate, ds, db_part):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    c = lib.sres_channels()
    _check_act(x, "x", c)
    n, _, h, w = x.shape
    f32 = torch.float32
    x, g = _channels_last(x), _like(g, x, "g")
    gate, ds = _gate_ds(gate, ds, n, c, x.device)
    if db_part is not None:
        if (db_part.dim() != 3 or db_part.shape[2] != c or db_part.dtype != f32
                or db_part.device != x.device):
            raise ValueError(f"db_part must be (N, P, {c}) float32 on {x.device}")
        db_part = db_part.contiguous()
    bf, dev = int(x.dtype == torch.bfloat16), x.device.index or 0
    nscratch = lib.sres_fg_wgrad_scratch(n, h, w, bf, dev)
    if nscratch < 0:
        cuda.check(-nscratch, "fgroup_wgrad grid")
    emp = lambda *s: torch.empty(s, dtype=f32, device=x.device)
    scratch, dw, db = emp(nscratch), emp(9, c, c), emp(c)
    err = lib.sres_fg_wgrad(
        x.data_ptr(), g.data_ptr(), _ptr(gate), _ptr(ds), _ptr(db_part),
        db_part.shape[0] * db_part.shape[1] if db_part is not None else 0,
        scratch.data_ptr(), dw.data_ptr(), db.data_ptr(), n, h, w, bf, dev,
        _stream(x.device))
    cuda.check(err, "fgroup_wgrad kernel")
    LAUNCHES["fgroup_wgrad"] += 1
    return dw, db


def _ca_bwd_cuda(g, c, gate, cw1, cb1, cw2, cb2):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ch = lib.sres_channels()
    _check_act(c, "c", ch)
    n, _, h, w = c.shape
    c, g = _channels_last(c), _like(g, c, "g")
    gate = _vec(gate, (n, ch), c.device, "gate")
    hidden, ws = _ca_weights(lib, ch, c.device, cw1, cb1, cw2, cb2)
    bf, dev = int(c.dtype == torch.bfloat16), c.device.index or 0
    nscratch = _scratch(lib.sres_fg_ca_bwd_scratch, n, h * w, bf, dev)
    emp = lambda *s: torch.empty(s, dtype=torch.float32, device=c.device)
    scratch, ds = emp(nscratch), emp(n, ch)
    dw1, db1, dw2, db2 = emp(hidden, ch), emp(hidden), emp(ch, hidden), emp(ch)
    err = lib.sres_fg_ca_bwd(                  # the gate is the stash's: no b2
        g.data_ptr(), c.data_ptr(), gate.data_ptr(), *(a.data_ptr() for a in ws[:3]),
        scratch.data_ptr(), ds.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), n, h * w, hidden, bf, dev, _stream(c.device))
    cuda.check(err, "fgroup_ca_bwd kernel")
    LAUNCHES["fgroup_ca_bwd"] += 1
    return ds, dw1, db1, dw2, db2


# ----------------------------------------------------------------- entries
def fgroup_conv(x: torch.Tensor, wk: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, relu: bool = False, out_dtype: Optional[torch.dtype] = None,
                gate: Optional[torch.Tensor] = None, ds: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, res: Optional[torch.Tensor] = None,
                res2: Optional[torch.Tensor] = None, partials: bool = False):
    """Direct 3×3 SAME conv of x (N, C, H, W) in T with ``wk`` (9, Cout, Cin)
    in T. Prologue: with ``gate``/``ds`` ((N, C) f32) the input is
    T(x·gate + ds) inside the image. Epilogue, in f32: v = acc (+ bias), ReLU,
    zeroed where ``mask`` (like x) is not > 0; ``partials`` also returns
    per-tile channel sums of that v, (N, P, C) f32 (the twin: P = 1); then
    (res + v) + res2, rounded to ``out_dtype`` (T or float32). CUDA tensor
    → kernel; CPU → twin."""
    if x.device.type == "cpu":
        return fgroup_conv_plain(x, wk, bias, relu=relu, out_dtype=out_dtype, gate=gate,
                                 ds=ds, mask=mask, res=res, res2=res2, partials=partials)
    return _conv_cuda(x, wk, bias, relu, out_dtype, gate, ds, mask, res, res2, partials)


def fgroup_ca(x: torch.Tensor, c: torch.Tensor, part: torch.Tensor, cw1, cb1, cw2,
              cb2, stash_c: bool = False):
    """Channel attention and block skip of an RCAB: the gate from the
    per-tile sums ``part`` of c (the conv's partials, summed in order), then
    x + c·gate. x in T, c f32. Returns (x_next in T, gate (N, C) f32, and
    with ``stash_c`` c in T, else None). CUDA tensor → kernel; CPU → twin."""
    if x.device.type == "cpu":
        return fgroup_ca_plain(x, c, part, cw1, cb1, cw2, cb2, stash_c)
    return _ca_cuda(x, c, part, cw1, cb1, cw2, cb2, stash_c)


def fgroup_wgrad(x: torch.Tensor, g: torch.Tensor, gate: Optional[torch.Tensor] = None,
                 ds: Optional[torch.Tensor] = None,
                 db_part: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight gradient of a 3×3 SAME conv whose input was x and whose output
    cotangent is g (both T): dW (9, Cin, Cout) f32 with dW[t] = Σ x_shift(t)ᵀ ·
    T(g'), and db = Σ g' in f32, where g' = g·gate + ds with ``gate``/``ds``,
    else g. With ``db_part`` (a conv's partials) db is their sum instead.
    CUDA tensor → kernel; CPU → twin."""
    if x.device.type == "cpu":
        return fgroup_wgrad_plain(x, g, gate, ds, db_part)
    return _wgrad_cuda(x, g, gate, ds, db_part)


def fgroup_ca_bwd(g: torch.Tensor, c: torch.Tensor, gate: torch.Tensor, cw1, cb1,
                  cw2, cb2) -> Tuple[torch.Tensor, ...]:
    """Backward of channel attention, given the cotangent g (T) of the RCAB
    output x + c·gate, the T stash of c and the f32 gate: returns (ds, dcw1,
    dcb1, dcw2, dcb2), f32, where the cotangent of c is g·gate + ds. CUDA
    tensor → kernel; CPU → twin."""
    if c.device.type == "cpu":
        return fgroup_ca_bwd_plain(g, c, gate, cw1, cb1, cw2, cb2)
    return _ca_bwd_cuda(g, c, gate, cw1, cb1, cw2, cb2)


# ------------------------------------------------------------ the group
class GroupOps(NamedTuple):
    """A group's operands as the kernels take them: per RCAB conv weights
    wk (nb, 2, 9, C, C) and their adjoints' wt, in T; biases bv (nb, 2, C)
    f32; CA weights cw1 (nb, hid, C), cw2 (nb, C, hid) as f32 holding T
    values, and their f32 biases cb1, cb2; the trailing conv's wgk, wgt (9,
    C, C) and bg (C,)."""
    wk: torch.Tensor
    wt: torch.Tensor
    bv: torch.Tensor
    cw1: torch.Tensor
    cb1: torch.Tensor
    cw2: torch.Tensor
    cb2: torch.Tensor
    wgk: torch.Tensor
    wgt: torch.Tensor
    bg: torch.Tensor


class Stash(NamedTuple):
    """What the forward keeps for the backward: each RCAB's input x and the
    trailing conv's input (nb + 1), the ReLU outputs a and conv2 outputs c in
    T, the gates (N, C) f32."""
    x: List[torch.Tensor]
    a: List[torch.Tensor]
    c: List[torch.Tensor]
    gate: List[torch.Tensor]


class _Impl(NamedTuple):
    conv: Callable
    ca: Callable
    wgrad: Callable
    ca_bwd: Callable


_KERNELS = _Impl(fgroup_conv, fgroup_ca, fgroup_wgrad, fgroup_ca_bwd)
_TWINS = _Impl(fgroup_conv_plain, fgroup_ca_plain, fgroup_wgrad_plain,
               fgroup_ca_bwd_plain)


def _group_fwd(x, ops: GroupOps, f: _Impl, stash: Optional[Stash]) -> torch.Tensor:
    q = x
    for i in range(ops.wk.shape[0]):
        a = f.conv(q, ops.wk[i, 0], ops.bv[i, 0], relu=True)
        c, part = f.conv(a, ops.wk[i, 1], ops.bv[i, 1], out_dtype=torch.float32,
                         partials=True)
        qn, gate, cst = f.ca(q, c, part, ops.cw1[i], ops.cb1[i], ops.cw2[i],
                             ops.cb2[i], stash_c=stash is not None)
        if stash is not None:
            stash.x.append(q)
            stash.a.append(a)
            stash.c.append(cst)
            stash.gate.append(gate)
        q = qn
    if stash is not None:
        stash.x.append(q)
    return f.conv(q, ops.wgk, ops.bg, res=x)


def _group_bwd(dy, st: Stash, ops: GroupOps, f: _Impl):
    gy = dy.to(st.x[0].dtype)                  # the group skip's cotangent
    dwg, dbg = f.wgrad(st.x[-1], gy)
    g = f.conv(gy, ops.wgt)
    grads = []
    for i in reversed(range(ops.wk.shape[0])):
        ca = (ops.cw1[i], ops.cb1[i], ops.cw2[i], ops.cb2[i])
        ds, dcw1, dcb1, dcw2, dcb2 = f.ca_bwd(g, st.c[i], st.gate[i], *ca)
        dw2, db2 = f.wgrad(st.a[i], g, gate=st.gate[i], ds=ds)
        dr1, part = f.conv(g, ops.wt[i, 1], gate=st.gate[i], ds=ds, mask=st.a[i],
                           partials=True)
        dw1, db1 = f.wgrad(st.x[i], dr1, db_part=part)
        g = f.conv(dr1, ops.wt[i, 0], res=g, res2=gy if i == 0 else None)
        grads.append((dw1, db1, dw2, db2, dcw1, dcb1, dcw2, dcb2))
    return g, grads[::-1], dwg, dbg


def fused_group_fwd(x: torch.Tensor, ops: GroupOps,
                    stash: Optional[Stash] = None) -> torch.Tensor:
    """A residual group: nb × (conv+ReLU → conv → channel attention → skip),
    the trailing conv and the group skip. With a ``stash`` (empty lists), the
    backward's residuals are appended to it as the chain runs; without, none
    is written."""
    return _group_fwd(x, ops, _KERNELS, stash)


def fused_group_fwd_plain(x, ops, stash=None) -> torch.Tensor:
    """Plain-torch twin of ``fused_group_fwd`` on any device."""
    return _group_fwd(x, ops, _TWINS, stash)


def fused_group_bwd(dy: torch.Tensor, stash: Stash, ops: GroupOps):
    """Backward of ``fused_group_fwd`` from its stash: the trailing conv's
    weight gradient and adjoint, then RCAB nb-1 … 0 (CA backward; conv2's
    wgrad and adjoint from g·gate + ds, masked by a > 0; conv1's wgrad and
    adjoint plus the carried cotangent, and at RCAB 0 the group skip's).
    Returns (dx in T, per RCAB (dw1, db1, dw2, db2, dcw1, dcb1, dcw2, dcb2)
    with conv weight gradients (9, Cin, Cout), dwg, dbg), gradients f32."""
    return _group_bwd(dy, stash, ops, _KERNELS)


def fused_group_bwd_plain(dy, stash, ops):
    """Plain-torch twin of ``fused_group_bwd`` on any device."""
    return _group_bwd(dy, stash, ops, _TWINS)


def new_stash() -> Stash:
    return Stash([], [], [], [])


class FusedGroupFn(torch.autograd.Function):
    """A residual group through ``fused_group_fwd``, keeping its stash, with
    ``fused_group_bwd`` as its backward (the ``fused_residual_group`` VJP,
    residual_group.py:433-449). ``params`` are the group's parameters in
    module order (per RCAB conv1 w, b, conv2 w, b, CA conv 1 w, b, CA conv 2
    w, b; then the trailing conv's w, b: a group's convs always have a
    bias); each gets its gradient in its own dtype and shape."""

    @staticmethod
    def forward(ctx, x, ops, plain, *params):
        st = new_stash()
        y = (fused_group_fwd_plain if plain else fused_group_fwd)(x, ops, st)
        ctx.nb = len(st.a)
        ctx.save_for_backward(*st.x, *st.a, *st.c, *st.gate)
        ctx.ops, ctx.plain = ops, plain
        ctx.metas = [(p.shape, p.dtype) for p in params]
        return y

    @staticmethod
    def backward(ctx, dy):
        nb, saved = ctx.nb, ctx.saved_tensors
        st = Stash(list(saved[:nb + 1]), list(saved[nb + 1:2 * nb + 1]),
                   list(saved[2 * nb + 1:3 * nb + 1]), list(saved[3 * nb + 1:]))
        bwd = fused_group_bwd_plain if ctx.plain else fused_group_bwd
        dx, grads, dwg, dbg = bwd(dy, st, ctx.ops)
        flat: List[torch.Tensor] = []
        for dw1, db1, dw2, db2, dcw1, dcb1, dcw2, dcb2 in grads:
            flat += [torch_weight_grad(dw1), db1, torch_weight_grad(dw2), db2,
                     dcw1, dcb1, dcw2, dcb2]
        flat += [torch_weight_grad(dwg), dbg]
        out = [gr.reshape(shape).to(dt) for gr, (shape, dt) in zip(flat, ctx.metas)]
        return (dx, None, None, *out)


def group_ops(blocks: Sequence, trail, dtype: torch.dtype) -> GroupOps:
    """GroupOps from a ResidualGroup's RCABs and trailing conv (layers.py
    modules), in the activation dtype ``dtype``: a few batched ops per
    group."""
    bias = lambda conv: conv.bias.detach().float()
    nb = len(blocks)
    convs = [c for blk in blocks for c in (blk.body[0], blk.body[2])] + [trail]
    w = torch.stack([c.weight.detach() for c in convs])
    wk, wt = conv_weights(w, dtype), dgrad_weights(w, dtype)
    bv = torch.stack([bias(c) for c in convs])
    ca = [blk.body[3].conv_du for blk in blocks]
    st = lambda mods: torch.stack([m.weight.detach()[:, :, 0, 0] for m in mods])
    return GroupOps(wk[:-1].unflatten(0, (nb, 2)), wt[:-1].unflatten(0, (nb, 2)),
                    bv[:-1].unflatten(0, (nb, 2)), _rnd(st(m[0] for m in ca), dtype),
                    torch.stack([bias(m[0]) for m in ca]),
                    _rnd(st(m[2] for m in ca), dtype),
                    torch.stack([bias(m[2]) for m in ca]), wk[-1], wt[-1], bv[-1])
