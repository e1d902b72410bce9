"""The port's Winograd backward (plain twins and autograd Functions) against
the JAX package, on seeded numpy inputs.

On the CPU the wrappers run their plain twins; the one Pallas call here,
the per-conv backward kernel, runs in interpret mode, as
tests/test_winograd.py runs it. The CUDA kernels are held against the twins
on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu.ops import winograd as jw
from sres_tpu.ops.pallas.winograd_conv import _bwd_call
from sres_tpu_torch.models.layers import init_torch_default
from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
from sres_tpu_torch.ops import winograd as tw
from sres_tpu_torch.ops import winograd_conv as twc


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def _direct(x, w, b, relu=False):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     precision=jax.lax.Precision.HIGHEST) + b
    return jnp.maximum(y, 0.0) if relu else y


@pytest.fixture(scope="module")
def conv_case():
    """Seeded conv inputs, and the VJP of the JAX direct-conv reference (the
    oracle of tests/test_winograd.py:test_kernel_gradients)."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 8)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(8,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    y, vjp = jax.vjp(_direct, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return x, w, b, g, y, vjp


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_bwd_plain_vs_jax_grad(conv_case, m, relu):
    """dx, dU → dw and db of the twin against jax.grad of the JAX reference
    (relu∘conv's VJP is the conv's VJP of the gated cotangent), with the
    tolerance of tests/test_winograd.py:test_kernel_gradients."""
    x, w, b, g, y, vjp = conv_case
    want = vjp(jnp.where(y > 0, g, 0.0) if relu else jnp.asarray(g))
    yt = twc.wino_conv_plain(_nchw(x), _oihw(w), torch.from_numpy(b), m,
                             relu=True) if relu else None
    dx, du, db = twc.wino_conv_bwd(_nchw(g), _nchw(x), _oihw(w), m, y=yt)
    got = (_nhwc(dx), _hwio(tw.untransform_weight_grad(du, m)), db.numpy())
    for a, e, name in zip(got, want, ("dx", "dw", "db")):
        e = np.asarray(e)
        np.testing.assert_allclose(a, e, rtol=2e-3, atol=2e-3 * float(np.abs(e).max()),
                                   err_msg=f"m={m} relu={relu} {name}")


def test_conv_bwd_plain_vs_pallas_bwd():
    """One interpret-mode call of the JAX backward kernel (_bwd_call, m=2,
    1×8×8×128, ReLU, on quad planes) against the twin: dx, dU, db within
    3e-5·max. Both take the port's U (transform_weights is held against
    JAX's in tests/test_torch_winograd.py)."""
    m, rng = 2, np.random.default_rng(41)
    x = rng.normal(size=(1, 8, 8, 128)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 128, 128)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(128,)) * 0.05).astype(np.float32)
    g = rng.normal(size=(1, 8, 8, 128)).astype(np.float32)
    y = twc.wino_conv_plain(_nchw(x), _oihw(w), torch.from_numpy(b), m, relu=True)
    spec = jw.wino_spec(m, 8, 8)
    q = lambda a: np.asarray(jw.to_quad(jnp.asarray(a), spec))
    dxq, du, db = _bwd_call(q(g), q(x), q(_nhwc(y)),
                            jnp.asarray(tw.transform_weights(_oihw(w), m).numpy()),
                            spec, 1, True)
    dx_t, du_t, db_t = twc.wino_conv_bwd(_nchw(g), _nchw(x), _oihw(w), m, y=y)
    for a, e, name in ((_nhwc(dx_t), jw.from_quad(dxq, spec), "dx"),
                       (du_t.numpy(), du, "dU"), (db_t.numpy(), db[0], "db")):
        e = np.asarray(e)
        np.testing.assert_allclose(a, e, rtol=0, atol=3e-5 * float(np.abs(e).max()),
                                   err_msg=name)


def test_group_fn_vs_jax_grad_of_direct_reference():
    """WinoGroupTrailFn (nb=5, m=4, 8×8, trailing conv): the gradients of
    x and of every parameter against jax.grad of the composed direct-conv
    reference (tests/test_winograd.py:test_group_vjp_gradcheck's bar,
    3e-5·max)."""
    nb, c, m = 5, 8, 4
    grp = init_torch_default(WinoResidualGroup(c, 2, nb, m), 42)
    x = np.random.default_rng(42).normal(size=(2, c, 8, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (grp(xt) ** 2).sum().backward()
    params = list(grp.parameters())

    def rcab(q, ps):
        w1, b1, w2, b2, cw1, cb1, cw2, cb2 = ps
        r = _direct(_direct(q, w1, b1, True), w2, b2)
        h = jnp.maximum(jnp.mean(r, axis=(1, 2)) @ cw1 + cb1, 0.0)
        return q + r * jax.nn.sigmoid(h @ cw2 + cb2)[:, None, None, :], None

    def ref(x_, blocks, wt, bt):                 # scanned, so one RCAB compiles
        q, _ = jax.lax.scan(rcab, x_, blocks)
        return x_ + _direct(q, wt, bt)

    # spatial convs to HWIO; the 1×1 CA convs to (in, out) matrices; the
    # RCABs' parameters stacked along a leading axis of nb
    jps = [p.detach().numpy().transpose(2, 3, 1, 0) if p.shape[-1] == 3
           else p.detach().numpy()[:, :, 0, 0].T if p.dim() == 4
           else p.detach().numpy() for p in params]
    blocks = tuple(jnp.asarray(np.stack(jps[i:8 * nb:8])) for i in range(8))
    gx, gblocks, gwt, gbt = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) ** 2),
                                             argnums=(0, 1, 2, 3)))(
        jnp.asarray(x.transpose(0, 2, 3, 1)), blocks, *map(jnp.asarray, jps[8 * nb:]))
    want = [gx] + [gblocks[i % 8][i // 8] for i in range(8 * nb)] + [gwt, gbt]
    got = [xt.grad.numpy().transpose(0, 2, 3, 1)]
    for p in params:
        gr = p.grad.numpy()
        got.append(gr.transpose(2, 3, 1, 0) if p.shape[-1] == 3
                   else gr[:, :, 0, 0].T if p.dim() == 4 else gr)
    for i, (a, e) in enumerate(zip(got, want)):
        e = np.asarray(e)
        np.testing.assert_allclose(a, e, rtol=0, atol=3e-5 * float(np.abs(e).max()),
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("m", [2, 4])
def test_untransform_weight_grad_vs_jax(m):
    """Against the JAX function, and against autograd through the port's
    own transform_weights (whose adjoint it is)."""
    du = np.random.default_rng(43).normal(size=((m + 2) ** 2, 6, 5)).astype(np.float32)
    want = np.asarray(jw.untransform_weight_grad(jnp.asarray(du), m))
    got = tw.untransform_weight_grad(torch.from_numpy(du), m)
    assert got.dtype == torch.float32 and got.shape == (5, 6, 3, 3)
    tol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(_hwio(got), want, rtol=0, atol=tol)
    w = torch.zeros(5, 6, 3, 3, requires_grad=True)
    tw.transform_weights(w, m).backward(torch.from_numpy(du))
    np.testing.assert_allclose(got.numpy(), w.grad.numpy(), rtol=0, atol=tol)
