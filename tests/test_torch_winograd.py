"""The port's Winograd math, plain kernel twins and small ops against the JAX
package (sres_tpu_torch ↔ sres_tpu), on seeded numpy inputs.

On the CPU every wrapper runs its plain twin; the Pallas kernels run in
interpret mode, as tests/test_winograd.py runs them. The CUDA kernels are
held against their twins on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sres_tpu.ops.resize import downsample as j_downsample
from sres_tpu.ops.resize import resize_matrix as j_resize_matrix
from sres_tpu.ops.resize import upsample as j_upsample
from sres_tpu.ops import winograd as jw
from sres_tpu.ops.shuffle import pixel_shuffle as jshuffle
from sres_tpu_torch.ops import resize as tresize
from sres_tpu_torch.ops import winograd as tw
from sres_tpu_torch.ops import winograd_conv as twc


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _oihw(w):
    """(3, 3, Cin, Cout) HWIO numpy → torch (Cout, Cin, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _data(seed, t=2, h=8, c=8, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, h, h, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, c)) * scale).astype(np.float32)
    b = (rng.normal(size=(c,)) * scale).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m", [2, 4])
def test_transform_matrices_and_weights(m):
    for a, b in zip(tw.MATS[m], jw._MATS[m]):
        np.testing.assert_array_equal(a, b)
    _, w, _ = _data(1, c=16)
    want = np.asarray(jw.transform_weights(jnp.asarray(w), m))
    got = tw.transform_weights(_oihw(w), m).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_wino_conv_plain_vs_jax_ref(m):
    x, w, b = _data(2, h=12)
    want = np.asarray(jw.wino_conv_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), m))
    tol = 2e-5 * float(np.abs(want).max())
    got = twc.wino_conv_plain(_nchw(x), _oihw(w), torch.from_numpy(b), m)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=tol)
    ref = tw.wino_conv_ref(_nchw(x), _oihw(w), torch.from_numpy(b), m)
    np.testing.assert_allclose(_nhwc(ref), want, rtol=0, atol=tol)


def test_wino_conv_plain_vs_pallas_quad():
    """One interpret-mode wino_conv_quad call (m=2, 1×8×8×128, ReLU)."""
    from sres_tpu.ops.pallas.winograd_conv import wino_conv_quad
    m = 2
    x, w, b = _data(3, t=1, c=128, scale=0.05)
    spec = jw.wino_spec(m, 8, 8)
    want = np.asarray(jw.from_quad(wino_conv_quad(
        jw.to_quad(jnp.asarray(x), spec), jnp.asarray(w), jnp.asarray(b), m,
        (8, 8), True, 1), spec))
    got = twc.wino_conv(_nchw(x), _oihw(w), torch.from_numpy(b), m, relu=True)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=3e-5 * float(np.abs(want).max()))


def test_group_plain_vs_pallas_trail():
    """One interpret-mode wino_group_trail call (m=2, nb=1, 1×8×8×128):
    RCAB chain + trailing conv + group skip, ≤ 3e-5·max (the bar of
    tests/test_winograd.py:test_group_trail_vjp_gradcheck)."""
    from sres_tpu.ops.pallas.wino_group_grad import wino_group_trail
    rng = np.random.default_rng(11)
    t, hh, nb, cah, m = 1, 8, 1, 64, 2
    f = lambda *s, k=0.05: (rng.normal(size=s) * k).astype(np.float32)
    x = rng.normal(size=(t, hh, hh, 128)).astype(np.float32)
    ws, bv = f(nb, 2, 3, 3, 128, 128), f(nb, 2, 128)
    cw1, cb1 = f(nb, 128, cah, k=0.1), f(nb, cah, k=0.1)
    cw2, cb2 = f(nb, cah, 128, k=0.1), f(nb, 128, k=0.1)
    wt, bt = f(3, 3, 128, 128), f(128)
    spec = jw.wino_spec(m, hh, hh)
    want = np.asarray(jw.from_quad(wino_group_trail(
        jw.to_quad(jnp.asarray(x), spec), *map(jnp.asarray, (
            ws, bv, cw1, cb1, cw2, cb2, wt, bt)), m, (hh, hh), 1), spec))
    T = torch.from_numpy
    ws_t = T(np.ascontiguousarray(ws.transpose(0, 1, 5, 4, 2, 3)))
    got = twc.wino_group_fwd(
        _nchw(x), ws_t, T(bv), T(np.ascontiguousarray(cw1.transpose(0, 2, 1))),
        T(cb1), T(np.ascontiguousarray(cw2.transpose(0, 2, 1))), T(cb2), m,
        _oihw(wt), T(bt))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=3e-5 * float(np.abs(want).max()))


def test_cpu_wrappers_take_the_plain_twins():
    """A CPU tensor goes to the twin (no kernel launch counted), with the
    same result as calling the twin; precomputed U equals spatial w."""
    x, w, b = _data(4, h=8)
    rng = np.random.default_rng(5)
    ca = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((4, 8), (4,), (8, 4), (8,))]
    X, W, B = _nchw(x), _oihw(w), torch.from_numpy(b)
    twc.reset_launches()
    y = twc.wino_conv(X, W, B, 4, relu=True, residual=X)
    assert torch.equal(y, twc.wino_conv_plain(X, tw.transform_weights(W, 4), B, 4,
                                              True, X))
    direct = X + F.relu(F.conv2d(X, W, B, padding=1))
    assert float((y - direct).abs().max()) <= 2e-5 * float(y.abs().max())
    q = twc.ca_skip(X, y, *ca)
    assert torch.equal(q, twc.ca_skip_plain(X, y, *ca))
    assert twc.LAUNCHES == dict.fromkeys(
        ("wino_conv", "ca_skip", "wino_conv_bwd", "ca_skip_bwd", "wino_chain"), 0)


def test_wino_conv_rejects_bad_geometry():
    x, w, b = _data(6, h=10)
    with pytest.raises(ValueError, match="multiples of the tile size"):
        twc.wino_conv(_nchw(x), _oihw(w), torch.from_numpy(b), 4)
    with pytest.raises(ValueError, match="must be one of"):
        tw.transform_weights(_oihw(w), 3)


def test_pixel_shuffle_matches_jax_nhwc():
    x = np.random.default_rng(7).normal(size=(2, 3, 5, 4 * 3)).astype(np.float32)
    want = np.asarray(jshuffle(jnp.asarray(x), 2))
    got = F.pixel_shuffle(_nchw(x), 2)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_resize_matches_jax(mode):
    x = np.random.default_rng(8).normal(size=(2, 32, 24, 1)).astype(np.float32)
    for jfn, tfn in ((j_downsample, tresize.downsample),
                     (j_upsample, tresize.upsample)):
        want = np.asarray(jfn(jnp.asarray(x), 4.0, mode))
        got = tfn(_nchw(x), 4.0, mode)
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tresize.resize_matrix(37, 9, "bicubic", 0.25),
                                  j_resize_matrix(37, 9, "bicubic", 0.25))
