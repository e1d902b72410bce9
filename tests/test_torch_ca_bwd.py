"""The channel-attention backward twins, the oracles of the CUDA kernels on
the card, against the JAX package's channel attention.

``ca_skip_bwd_plain`` (the Winograd trunk's) and ``fgroup_ca_bwd_plain`` (the
fused trunk's, in f32, where its bf16 rounding points are the identity) are
held against ``jax.vjp`` of y = c2·gate(c2), with the gate from
``sres_tpu/ops/pallas/wino_group_grad.py:_ca_fwd`` (a plain ``jnp``
function): the four weight gradients (transposed to the port's layout) and
ds, the per-channel pixel mean of dc − da·gate. Both at every hidden width
the kernels take, from 1 to 64, within 1e-5·max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu.ops.pallas.wino_group_grad import _ca_fwd
from sres_tpu_torch.ops import fused_group as fg
from sres_tpu_torch.ops import winograd_conv as twc

SHAPE = (3, 64, 9, 13)          # (N, C, H, W): an odd pixel count, 117
TOL = 1e-5


def _close(a, ref, name):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    err, bound = np.abs(a - ref).max(), TOL * np.abs(ref).max()
    assert err <= bound, (name, err, bound)


@jax.jit
def _reference(c2, da, w1, b1, w2, b2):
    """JAX: (gate, ds, dW1, db1, dW2, db2) in the port's layout, from the
    VJP of y = c2·gate(c2) at the cotangent da. c2, da NHWC; w1 (C, h), w2
    (h, C) as the JAX kernel takes them. Jitted: one compile a width."""
    npix = c2.shape[1] * c2.shape[2]

    def y(c2_, w1_, b1_, w2_, b2_):
        _, _, g = _ca_fwd(c2_, w1_, b1_, w2_, b2_, npix=npix)
        return c2_ * g[:, None, None, :]

    _, vjp = jax.vjp(y, c2, w1, b1, w2, b2)
    dc, dw1, db1, dw2, db2 = vjp(da)
    gate = _ca_fwd(c2, w1, b1, w2, b2, npix=npix)[2]
    ds = jnp.mean(dc - da * gate[:, None, None, :], axis=(1, 2))
    return gate, ds, dw1.T, db1, dw2.T, db2


@pytest.mark.parametrize("trunk", ["winograd", "fused"])
@pytest.mark.parametrize("hidden", [1, 4, 32, 64])
def test_ca_bwd_twin_matches_jax_vjp(trunk, hidden):
    rng = np.random.default_rng(hidden)
    n, c, h, w = SHAPE
    c2 = (rng.normal(size=(n, h, w, c)) + 0.3).astype(np.float32)
    # da with a mean, so that each sample's dz1 has one sign and a bias
    # gradient (a sum over 3 samples) does not cancel to its rounding
    da = (rng.normal(size=(n, h, w, c)) + 0.5).astype(np.float32)
    w1, b1, w2, b2 = (rng.normal(size=s).astype(np.float32) * 0.1
                      for s in ((c, hidden), (hidden,), (hidden, c), (c,)))
    b1[: (hidden + 1) // 2] += 0.5      # half the units open: dz1 and ds not all zero
    gate, ds, dw1, db1, dw2, db2 = _reference(*map(jnp.asarray, (c2, da, w1, b1, w2, b2)))
    assert float(jnp.abs(dw1).max()) > 0.0      # some unit open in some sample

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    ws = [torch.from_numpy(np.ascontiguousarray(a)) for a in (w1.T, b1, w2.T, b2)]
    if trunk == "winograd":
        out = twc.ca_skip_bwd_plain(nchw(da), nchw(c2), *ws)
        _close(out[0], gate, "gate")
        out = out[1:]
    else:
        out = fg.fgroup_ca_bwd_plain(nchw(da), nchw(c2), torch.from_numpy(np.array(gate)),
                                     *ws)
    for name, a, ref in zip(("ds", "dW1", "db1", "dW2", "db2"), out,
                            (ds, dw1, db1, dw2, db2)):
        assert tuple(a.shape) == tuple(ref.shape), name
        _close(a.numpy(), ref, name)
