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
build or launch raises. T is any multiple of 16 up to 256 (4×4 ... 16×16
windows); any other T raises ``NotImplementedError``. Each direction is one
design at every T, built on one thread-block cluster per head and window
range that shares the window's K and V through distributed shared memory
and keeps the scores in registers: the forward ``wattn_fwd_core_kernel``
(o for each head, the head's bias rows resident) then
``wattn_fwd_proj_kernel`` (y = o·Wo + bo); the backward
``wattn_bwd_core_kernel`` then ``wattn_bwd_proj_kernel`` (dx and dWqkv)
and fixed-order partial sums.

Rounding points (kernel and twin alike; every product accumulates in f32):
the JAX kernel keeps qkv, p and the backward's do, ds in f32, but the
tensor cores take activation-dtype operands, so q, k, v, p (for p·v), o, do
and ds·hd^-½ are rounded to the activation dtype; the scores, the softmax,
dp and ds stay f32. As in JAX, o is rounded before the output projection,
y after it, and dqkv before dwqkv and dx; dbqkv sums the unrounded dqkv.
In f32 nothing rounds. The weight gradients stay f32 (the JAX VJP casts
them to the weights' dtype, :229-232).

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call that
reached its kernels: ``window_attention`` and ``window_attention_bwd``, at
every T), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"window_attention": 0, "window_attention_bwd": 0}

# The core kernels' grid, a function of the shape alone (never of the card,
# so that the bits do not depend on it): about this many CTAs, one per SM
# (each kernel fills one), a cluster of nq = ceil(T / rows) per (head,
# window range). A cluster wants nq SMs of one GPC: an H100 holds at most 30
# clusters of 4 such CTAs at once, so clusters take fewer CTAs, which keeps
# SwinIR-w16's grid to one wave (28 clusters; 32 took two, 1.64x the time).
# At most this many backward projection blocks, each owning one f32 partial
# of dWqkv.
_CORE_CTAS, _CORE_CLUSTER_CTAS = 128, 120
_PROJ_BLOCKS = 256


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
def _core_grid(rows: int, nw: int, t: int, heads: int) -> Tuple[int, int]:
    """(nq, nsplit) of the core kernels' grid for ``nw`` windows of ``t``
    tokens when a CTA owns ``rows`` query rows: clusters of nq CTAs, one per
    (head, window range), nsplit ranges (1 ≤ nsplit ≤ nw): range s takes
    the positions from ⌊s·nw / nsplit⌋ up to ⌊(s + 1)·nw / nsplit⌋ of the
    kernel's window order (the backward's is w, the forward's w sorted by
    (w % nm, w // nm))."""
    nq = -(-t // rows)
    ctas = _CORE_CTAS if nq == 1 else _CORE_CLUSTER_CTAS
    return nq, max(1, min(nw, ctas // (heads * nq)))


def _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads):
    """Everything the kernels take, checked, contiguous, on x's device:
    weights in x.dtype, the rest f32, each 16-byte aligned (the kernels
    copy rows 16 bytes at a time); returns (ops, nm)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (NW, T, C), got {tuple(x.shape)}")
    nw, t, c = x.shape
    tile, tmax = lib.sres_wattn_tile(), lib.sres_wattn_max_tokens()
    if t % tile or not 0 < t <= tmax:
        raise NotImplementedError(
            f"the window-attention kernels take a multiple of {tile} up to "
            f"{tmax} tokens a window, got T = {t}: "
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
    ops = [_aligned(x.contiguous())]
    for a, shape, adt in want:
        # the bias vectors in any shape of their size, the rest exactly
        fits = (a.numel() == shape[0] if len(shape) == 1
                else tuple(a.shape) == shape)
        if a.device != dev or not fits:
            raise ValueError(f"operand shaped {tuple(a.shape)} on {a.device}: "
                             f"kernel takes {shape} on {dev}")
        ops.append(_aligned(a.detach().to(adt).reshape(shape).contiguous()))
    nm = 0
    if mask is not None:
        if mask.dim() != 3 or mask.shape[1:] != (t, t) or nw % mask.shape[0] \
                or mask.device != dev:
            raise ValueError(f"mask must be (nm, {t}, {t}) on {dev} with nm "
                             f"dividing {nw}, got {tuple(mask.shape)}")
        mask = _aligned(mask.to(f32).contiguous())
        nm = mask.shape[0]
    ops.append(mask)
    return ops, nm


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` (contiguous), copied if its storage offset breaks 16-byte
    alignment."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _ptr(a: Optional[torch.Tensor]) -> Optional[int]:
    return a.data_ptr() if a is not None else None


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_cuda(x, wqkv, bqkv, wo, bo, bias, mask, heads):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ops, nm = _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads)
    x = ops[0]
    nw, t, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    _, nsplit = _core_grid(lib.sres_wattn_rows(bf16), nw, t, heads)
    y, o = torch.empty_like(x), torch.empty_like(x)   # o: every head's p·v
    err = lib.sres_wattn_fwd(
        *[_ptr(a) for a in ops], y.data_ptr(), o.data_ptr(), nw, t, nm, heads,
        _scale(c, heads), nsplit, bf16, x.device.index or 0, _stream(x.device))
    cuda.check(err, "window_attention kernels")
    LAUNCHES["window_attention"] += 1
    return y


def _bwd_cuda(x, g, wqkv, bqkv, wo, bo, bias, mask, heads):
    from sres_tpu_torch.ops import cuda
    lib = cuda.load()
    ops, nm = _operands(lib, x, wqkv, bqkv, wo, bo, bias, mask, heads)
    x = ops[0]
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be shaped like x on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    g = _aligned(g.to(x.dtype).contiguous())
    nw, t, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    nq, nsplit = _core_grid(lib.sres_wattn_rows(bf16), nw, t, heads)
    nproj = min(-(-nw * t // lib.sres_wattn_bwd_proj_rows()), _PROJ_BLOCKS)
    sizes = [3 * c * c, 3 * c, c * c, c, heads * t * t]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dqkv = torch.empty(nw, t, 3 * c, dtype=x.dtype, device=x.device)
    # f32 partials: dWqkv per projection block, [dbqkv | dWo | dbo] per
    # (query tile, window range), dbias per window range
    psizes = [nproj * sizes[0], nq * nsplit * sum(sizes[1:4]), nsplit * sizes[4]]
    part_w, part_c, part_b = torch.empty(sum(psizes), dtype=torch.float32,
                                         device=x.device).split(psizes)
    err = lib.sres_wattn_bwd(
        *[_ptr(a) for a in ops], g.data_ptr(), dx.data_ptr(), dqkv.data_ptr(),
        part_w.data_ptr(), part_c.data_ptr(), part_b.data_ptr(), grads.data_ptr(),
        nw, t, nm, heads, _scale(c, heads), nsplit, nproj, bf16,
        x.device.index or 0, _stream(x.device))
    cuda.check(err, "window_attention_bwd kernels")
    LAUNCHES["window_attention_bwd"] += 1
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
