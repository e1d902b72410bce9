"""The port's window attention (sres_tpu_torch.ops.window_attention) against
the JAX fused Pallas kernel in interpret mode, the way
tests/test_window_attention.py runs it, at NW = 8, T = 16 (4×4 windows),
C = 16, h = 2. On the CPU the wrappers run the plain twins, inside the same
autograd Function as on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu.ops.pallas.window_attention import fused_window_attention
from sres_tpu_torch.ops import window_attention as twa

NW, T, C, H, NM = 8, 16, 16, 2, 4


def _inputs(seed, masked):
    """x, wqkv, bqkv, wo, bo, bias and the (NM, T, T) group mask (or None),
    as numpy f32."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(scale=0.1, size=s).astype(np.float32)
    mask = (np.where(mk(NM, T, T) > 0.1, -100.0, 0.0).astype(np.float32)
            if masked else None)
    return (mk(NW, T, C), mk(C, 3 * C), mk(1, 3 * C), mk(C, C), mk(1, C),
            mk(H, T, T), mask)


def _jax_args(args):
    *rest, mask = args
    full = (np.tile(mask, (NW // NM, 1, 1)) if mask is not None
            else np.zeros((NW, T, T), np.float32))
    return [jnp.asarray(a) for a in rest] + [jnp.asarray(full)]


def _torch_args(args, grad=False):
    *rest, mask = args
    ts = [torch.from_numpy(a.copy()).requires_grad_(grad) for a in rest]
    return ts + [None if mask is None else torch.from_numpy(mask)]


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax_kernel(masked):
    args = _inputs(0, masked)
    want = np.asarray(jax.jit(fused_window_attention, static_argnums=7)(
        *_jax_args(args), H))
    got = twa.window_attention(*_torch_args(args), H)
    assert got.dtype == torch.float32 and tuple(got.shape) == (NW, T, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_kernel(masked):
    """Every gradient through WindowAttentionFn against jax.grad of the
    kernel's custom VJP, under the bars of tests/test_window_attention.py."""
    args = _inputs(1, masked)
    lf = lambda *a: jnp.sum(jnp.cos(fused_window_attention(*a, H)))
    want = jax.jit(jax.grad(lf, argnums=tuple(range(6))))(*_jax_args(args))
    ts = _torch_args(args, grad=True)
    torch.cos(twa.WindowAttentionFn.apply(*ts, H)).sum().backward()
    for name, t, w in zip(("x", "wqkv", "bqkv", "wo", "bo", "bias"), ts, want):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_backward_twin_is_the_adjoint_of_the_forward_twin():
    """In f32 the explicit backward twin equals autograd through the
    forward twin (masked), to f32 roundoff."""
    ts = _torch_args(_inputs(2, True), grad=True)
    x, wqkv, bqkv, wo, bo, bias, mask = ts
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(NW, T, C))
                         .astype(np.float32))
    want = torch.autograd.grad((twa.window_attention_plain(*ts, H) * g).sum(),
                               [x, wqkv, bqkv, wo, bo, bias])
    got = twa.window_attention_bwd_plain(x.detach(), g, wqkv.detach(),
                                         bqkv.detach(), wo.detach(), bo.detach(),
                                         bias.detach(), mask, H)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_rounding_points_and_gradient_dtypes():
    """bf16 activations: y and dx in bf16, the weight gradients in the f32
    parameters' dtype (kept f32, unlike the JAX VJP); the bf16 output
    differs from the f32 one, by less than 2 % of its max."""
    x, wqkv, bqkv, wo, bo, bias, mask = _torch_args(_inputs(4, True), grad=True)
    xb = x.detach().bfloat16().requires_grad_()
    y = twa.WindowAttentionFn.apply(xb, wqkv, bqkv, wo, bo, bias, mask, H)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in (wqkv, bqkv, wo, bo, bias))
    with torch.no_grad():
        y32 = twa.window_attention(x, wqkv, bqkv, wo, bo, bias, mask, H)
        err = float((y.float() - y32).abs().max() / y32.abs().max())
    assert 0 < err < 2e-2


def test_wrappers_route_by_device():
    """CPU → twin; a device that is neither the CPU nor a card raises."""
    x, wqkv, bqkv, wo, bo, bias, mask = _torch_args(_inputs(5, False))
    launches = dict(twa.LAUNCHES)
    twa.window_attention(x, wqkv, bqkv, wo, bo, bias, mask, H)
    twa.window_attention_bwd(x, x, wqkv, bqkv, wo, bo, bias, mask, H)
    assert twa.LAUNCHES == launches            # the twins launch nothing
    meta = [a.to("meta") for a in (x, wqkv, bqkv, wo, bo, bias)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        twa.window_attention(*meta, None, H)
    with pytest.raises(ValueError, match="cuda or cpu"):
        twa.window_attention_bwd(meta[0], *meta, None, H)


def test_t256_twins_match_jax_kernel():
    """16×16 windows (T = 256, the port's tiled kernels on the card), C = 64,
    4 heads: the two windows of a 16×32 tile with its shifted-window mask.
    The twins' forward and all six gradients through WindowAttentionFn
    against the interpret-mode kernel and its VJP (one jitted call), under
    the bars of the tests above."""
    from sres_tpu_torch.models.swinir import shift_attn_mask
    t, c, h = 256, 64, 4
    rng = np.random.default_rng(6)
    mk = lambda *s: rng.normal(scale=0.1, size=s).astype(np.float32)
    args = (rng.normal(size=(2, t, c)).astype(np.float32), mk(c, 3 * c),
            mk(1, 3 * c), mk(c, c), mk(1, c), mk(h, t, t))
    mask = shift_attn_mask(16, 32, 16, 8)

    @jax.jit
    def jax_fwd_vjp(*a):
        y, vjp = jax.vjp(lambda *p: fused_window_attention(*p, jnp.asarray(mask), h), *a)
        return y, vjp(-jnp.sin(y))

    want_y, want_g = jax_fwd_vjp(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y = twa.WindowAttentionFn.apply(*ts, torch.from_numpy(mask), h)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=3e-5, atol=3e-5)
    torch.cos(y).sum().backward()
    for name, a, w in zip(("x", "wqkv", "bqkv", "wo", "bo", "bias"), ts, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("rows", [64, 32])
def test_core_grid_covers_every_window_once(rows):
    """The core kernels' window ranges (range s from ⌊s·nw / nsplit⌋ to
    ⌊(s + 1)·nw / nsplit⌋, nsplit from ``_core_grid``): every window lands
    in exactly one range and no range is empty, at SwinIR's and
    SwinIR-w16's window counts and at counts the ranges do not divide."""
    for t in (16, 64, 144, 256):
        for heads in (2, 4):
            for nw in (1, 6, 7, 432, 433, 1728):
                nq, nsplit = twa._core_grid(rows, nw, t, heads)
                assert nq == -(-t // rows) and 1 <= nsplit <= nw
                cuts = [s * nw // nsplit for s in range(nsplit + 1)]
                assert cuts[0] == 0 and cuts[-1] == nw
                assert all(a < b for a, b in zip(cuts, cuts[1:]))
