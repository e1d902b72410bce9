"""Fused window multi-head attention for SwinIR: CUDA kernels, plain twins
and their autograd Function.

Counterpart of sres_tpu/ops/pallas/window_attention.py
(``fused_window_attention`` :215 with its VJP :222-235; the forward kernel
``_fwd_kernel`` :74 and the recomputing backward ``_bwd_kernel`` :84). One
call computes, per window of T tokens: the QKV projection, per head the
scores q·kᵀ·hd^-½ + relative-position bias (+ the shifted-window mask), the
softmax and p·v, then the output projection.

Operands, in the JAX layout: x (NW, T, C) in the activation dtype; wqkv
(C, 3C) and wo (C, C), cast to the activation dtype at the call (the
module's parameters stay f32); bqkv (3C,) and bo (C,) in f32 (any shape of
that many elements); bias (h, T, T) f32, gathered from the table outside;
mask None (unshifted blocks) or the (nm, T, T) f32 group mask, which window
w reads as mask[w % nm] (``window_partition`` orders windows (b, i, j), so
this is the JAX module's tiled (NW, T, T) mask, swinir.py:124-127). The
columns of qkv hold q, k, v in turn, head hh at [hh·hd, (hh+1)·hd) of each.

Dispatch is by the device of ``x``: a CPU tensor goes to the ``*_plain``
twin, a CUDA tensor to a hand-written kernel in ``ops/cuda/
window_attention.cu``, and anything else raises; a kernel that fails to
build or launch raises. On the card the kernel is picked by T: T = 64 (8×8
windows) runs the whole-window kernels (``wattn_fwd_kernel``,
``wattn_bwd_kernel``); any other multiple of 16 up to 256 (4×4, 12×12,
16×16 windows) the tiled ones (``wattn_tiled_fwd_kernel``; backward
``wattn_tiled_bwd_kernel`` + ``wattn_tiled_dbias_kernel``), which walk
query tiles because a 16×16 window does not fit an SM; any other T raises
``NotImplementedError``.

Rounding points (kernel and twin alike; every product accumulates in f32):
the JAX kernel keeps qkv, p and the backward's do, ds in f32, but the
tensor cores take activation-dtype operands, so q, k, v, p (for p·v), o, do
and ds·hd^-½ are rounded to the activation dtype; the scores, the softmax,
dp and ds stay f32. As in JAX, o is rounded before the output projection,
y after it, and dqkv before dwqkv and dx; dbqkv sums the unrounded dqkv.
In f32 nothing rounds. The weight gradients stay f32 (the JAX VJP casts
them to the weights' dtype, :229-232).

``LAUNCHES`` counts kernel launches per wrapper and mode (one per wrapper
call that reached its kernel: ``window_attention`` and
``window_attention_bwd`` at T = 64, the ``*_tiled`` keys at the other T),
so a run can show that its main path went through the kernels, and which.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"window_attention": 0, "window_attention_bwd": 0,
                            "window_attention_tiled": 0,
                            "window_attention_bwd_tiled": 0}

# persistent blocks of the backward kernels: one per SM of an H100; each
# owns one f32 partial of the weight gradients (at T = 64 of dbias too)
_BWD_BLOCKS = 132


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- plain twins
def _scale(c: int, heads: int) -> float:
    """hd^-½, the score scale (rounded to f32 where it meets f32 data)."""
    return float((c // heads) ** -0.5)


def _heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    """(NW, T, C) → (NW, h, T, hd)."""
    nw, t, c = a.shape
    return a.reshape(nw, t, heads, c // heads).transpose(1, 2)


def _merge(a: torch.Tensor) -> torch.Tensor:
    """(NW, h, T, hd) → (NW, T, C)."""
    nw, h, t, hd = a.shape
    return a.transpose(1, 2).reshape(nw, t, h * hd)


def _forward_parts(x, wqkv, bqkv, bias, mask, heads):
    """(q, k, v, p, o) of the forward, f32 tensors holding the kernel's
    rounded values: q, k, v (NW, h, T, hd), p (NW, h, T, T) unrounded, o
    (NW, T, C)."""
    nw, t, c = x.shape
    dt = x.dtype
    rnd = lambda a: a.to(dt).float()
    qkv = rnd(x.float() @ wqkv.to(dt).float() + bqkv.float().reshape(-1))
    q, k, v = (_heads(a, heads) for a in qkv.split(c, dim=-1))
    s = (q @ k.transpose(-1, -2)) * _scale(c, heads) + bias.float()
    if mask is not None:
        nm = mask.shape[0]
        s = (s.reshape(nw // nm, nm, heads, t, t) + mask.float()[None, :, None]
             ).reshape(nw, heads, t, t)
    p = torch.softmax(s, dim=-1)
    o = rnd(_merge(rnd(p) @ v))
    return q, k, v, p, o


def window_attention_plain(x: torch.Tensor, wqkv: torch.Tensor,
                           bqkv: torch.Tensor, wo: torch.Tensor,
                           bo: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           heads: int) -> torch.Tensor:
    """Plain-torch twin of the forward kernel: (NW, T, C) in x.dtype."""
    dt = x.dtype
    o = _forward_parts(x, wqkv, bqkv, bias, mask, heads)[4]
    return (o @ wo.to(dt).float() + bo.float().reshape(-1)).to(dt)


def window_attention_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                               wqkv: torch.Tensor, bqkv: torch.Tensor,
                               wo: torch.Tensor, bo: torch.Tensor,
                               bias: torch.Tensor, mask: Optional[torch.Tensor],
                               heads: int) -> Tuple[torch.Tensor, ...]:
    """Plain-torch twin of the backward kernel; see
    ``window_attention_bwd``."""
    nw, t, c = x.shape
    dt = x.dtype
    rnd = lambda a: a.to(dt).float()
    q, k, v, p, o = _forward_parts(x, wqkv, bqkv, bias, mask, heads)
    gf = g.to(dt).float()
    dwo = o.reshape(-1, c).T @ gf.reshape(-1, c)
    dbo = gf.sum((0, 1))
    do = _heads(rnd(gf @ wo.to(dt).float().T), heads)
    dv = rnd(p).transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dsb = rnd(ds * _scale(c, heads))
    dq, dk = dsb @ k, dsb.transpose(-1, -2) @ q
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    dbqkv = dqkv.sum((0, 1))
    dqb = rnd(dqkv)
    dwqkv = x.float().reshape(-1, c).T @ dqb.reshape(-1, 3 * c)
    dx = (dqb @ wqkv.to(dt).float().T).to(dt)
    return dx, dwqkv, dbqkv, dwo, dbo, dbias


# ----------------------------------------------------------- CUDA wrappers
def _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads):
    """Everything the kernels take, checked, contiguous, on x's device:
    weights in x.dtype, the rest f32; returns (ops, nm, tiled), ``tiled``
    whether T goes to the tiled kernels."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (NW, T, C), got {tuple(x.shape)}")
    nw, t, c = x.shape
    tile, tmax = lib.sres_wattn_tile(), lib.sres_wattn_max_tokens()
    if t % tile or not 0 < t <= tmax:
        raise NotImplementedError(
            f"the window-attention kernels take T = {lib.sres_wattn_tokens()} or "
            f"a multiple of {tile} up to {tmax} tokens a window, got T = {t}: "
            "not ported (ROADMAP Queue 2 rows 7, 8)")
    if c != lib.sres_channels():
        raise ValueError(f"x: kernel takes (NW, {t}, {lib.sres_channels()}), "
                         f"got {tuple(x.shape)}")
    if heads < 1 or c % heads or c // heads not in (16, 32):
        raise ValueError(f"{heads} heads: the kernel takes head widths C/h "
                         "of 16 and 32")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    want = [(wqkv, (c, 3 * c), dt), (bqkv, (3 * c,), f32), (wo, (c, c), dt),
            (bo, (c,), f32), (bias, (heads, t, t), f32)]
    ops = [x.contiguous()]
    for a, shape, adt in want:
        # the bias vectors in any shape of their size, the rest exactly
        fits = (a.numel() == shape[0] if len(shape) == 1
                else tuple(a.shape) == shape)
        if a.device != dev or not fits:
            raise ValueError(f"operand shaped {tuple(a.shape)} on {a.device}: "
                             f"kernel takes {shape} on {dev}")
        ops.append(a.detach().to(adt).reshape(shape).contiguous())
    nm = 0
    if mask is not None:
        if mask.dim() != 3 or mask.shape[1:] != (t, t) or nw % mask.shape[0] \
                or mask.device != dev:
            raise ValueError(f"mask must be (nm, {t}, {t}) on {dev} with nm "
                             f"dividing {nw}, got {tuple(mask.shape)}")
        mask = mask.to(f32).contiguous()
        nm = mask.shape[0]
    ops.append(mask)
    return ops, nm, t != lib.sres_wattn_tokens()


def _ptr(a: Optional[torch.Tensor]) -> Optional[int]:
    return a.data_ptr() if a is not None else None


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_cuda(x, wqkv, bqkv, wo, bo, bias, mask, heads):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ops, nm, tiled = _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads)
    x = ops[0]
    nw, t, c = x.shape
    y = torch.empty_like(x)
    ptrs = [_ptr(a) for a in ops] + [y.data_ptr()]
    tail = (heads, _scale(c, heads), int(x.dtype == torch.bfloat16),
            x.device.index or 0, _stream(x.device))
    if tiled:
        err, key = lib.sres_wattn_tiled_fwd(*ptrs, nw, t, nm, *tail), "window_attention_tiled"
    else:
        err, key = lib.sres_wattn_fwd(*ptrs, nw, nm, *tail), "window_attention"
    cuda.check(err, f"{key} kernel")
    LAUNCHES[key] += 1
    return y


def _bwd_cuda(x, g, wqkv, bqkv, wo, bo, bias, mask, heads):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ops, nm, tiled = _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads)
    x = ops[0]
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be shaped like x on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.to(x.dtype).contiguous()
    nw, t, c = x.shape
    nblk = min(nw, _BWD_BLOCKS)
    sizes = [3 * c * c, 3 * c, c * c, c, heads * t * t]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    empty = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=x.device)
    ptrs = [_ptr(a) for a in ops] + [g.data_ptr(), dx.data_ptr()]
    tail = (int(x.dtype == torch.bfloat16), x.device.index or 0, _stream(x.device))
    if tiled:
        # the weight partials without dbias; dbias summed per (16 query rows,
        # head) by its own kernel over nsplit window splits, so that the
        # card's SMs are about full
        nsplit = max(1, min(nw, _BWD_BLOCKS // (heads * t // lib.sres_wattn_tile())))
        stash, scratch = empty(nw, t, 4 * c, dt=x.dtype), empty(nblk, t, 3 * c, dt=x.dtype)
        part, dbpart = empty(nblk, sum(sizes[:4])), empty(nsplit, heads, t, t)
        err = lib.sres_wattn_tiled_bwd(
            *ptrs, stash.data_ptr(), scratch.data_ptr(), part.data_ptr(),
            dbpart.data_ptr(), grads.data_ptr(), nw, t, nm, heads, _scale(c, heads),
            nblk, nsplit, *tail)
        key = "window_attention_bwd_tiled"
    else:
        part = empty(nblk, sum(sizes))
        err = lib.sres_wattn_bwd(*ptrs, part.data_ptr(), grads.data_ptr(), nw, nm,
                                 heads, _scale(c, heads), nblk, *tail)
        key = "window_attention_bwd"
    cuda.check(err, f"{key} kernel")
    LAUNCHES[key] += 1
    dwqkv, dbqkv, dwo, dbo, dbias = grads.split(sizes)
    return (dx, dwqkv.view(c, 3 * c), dbqkv, dwo.view(c, c), dbo,
            dbias.view(heads, t, t))


# ----------------------------------------------------------------- entries
def window_attention(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                     wo: torch.Tensor, bo: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """(NW, T, C) window tokens → attended tokens, in x.dtype. CUDA tensor →
    kernel; CPU tensor → twin; any other device raises."""
    if x.device.type == "cpu":
        return window_attention_plain(x, wqkv, bqkv, wo, bo, bias, mask, heads)
    if x.device.type == "cuda":
        return _fwd_cuda(x, wqkv, bqkv, wo, bo, bias, mask, heads)
    raise ValueError(f"window_attention runs on cuda or cpu, not {x.device}")


def window_attention_bwd(x: torch.Tensor, g: torch.Tensor, wqkv: torch.Tensor,
                         bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         heads: int) -> Tuple[torch.Tensor, ...]:
    """Backward of ``window_attention`` given the output cotangent g (read
    in x.dtype), recomputing the forward: returns (dx in x.dtype, dwqkv
    (C, 3C), dbqkv (3C,), dwo (C, C), dbo (C,), dbias (h, T, T)), the
    weight gradients f32 sums over the windows. CUDA tensor → kernel; CPU
    tensor → twin; any other device raises."""
    if x.device.type == "cpu":
        return window_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, bias, mask,
                                          heads)
    if x.device.type == "cuda":
        return _bwd_cuda(x, g, wqkv, bqkv, wo, bo, bias, mask, heads)
    raise ValueError(f"window_attention_bwd runs on cuda or cpu, not {x.device}")


class WindowAttentionFn(torch.autograd.Function):
    """y = window_attention(...) whose backward is ``window_attention_bwd``
    (the ``fused_window_attention`` VJP, window_attention.py:222-235). The
    forward saves only its inputs; the backward recomputes. Each input gets
    its gradient in its own dtype and shape (the mask none)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, bias, mask, heads, plain=False):
        fn = window_attention_plain if plain else window_attention
        y = fn(x, wqkv, bqkv, wo, bo, bias, mask, heads)
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, bias, mask)
        ctx.heads, ctx.plain = heads, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *ws, mask = ctx.saved_tensors
        bwd = window_attention_bwd_plain if ctx.plain else window_attention_bwd
        dx, *dws = bwd(x, dy, *ws, mask, ctx.heads)
        return (dx, *(d.to(w.dtype).reshape(w.shape) for d, w in zip(dws, ws)),
                None, None, None)
