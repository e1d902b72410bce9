"""The port's EDSR and its ungated Winograd group, and the conv chain,
against the JAX package, on seeded numpy inputs.

On the CPU the wrappers run their plain twins. The Pallas kernels run in
interpret mode, as tests/test_winograd.py runs them: one
``wino_resgroup_trail`` forward and one ``wino_chain_fwd``. The ungated
group's gradients are held against jax.grad of the direct-conv reference;
``test_resgroup_twins_vs_pallas_trail_vjp`` (slow: its three interpret-mode
calls take about 27 s on a CPU) holds them against the Pallas VJP too. The
CUDA kernels are held against the twins on the card by
tests/test_torch_cuda.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.ops import winograd as jw
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.layers import init_torch_default
from sres_tpu_torch.models.wino_blocks import WinoResTrunk
from sres_tpu_torch.ops import winograd as tw
from sres_tpu_torch.ops import winograd_conv as twc
from sres_tpu_torch.util.weights import state_dict_from_jax

CFG = dict(name="edsr", nfeatures=8, nlayers=2, res_scale=0.8, kernel_size=3,
           downscale_factors=[2, 2], loss_fn="l2")
T = torch.from_numpy


def _nchw(a):
    return T(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _oihw(w):
    """(..., 3, 3, Cin, Cout) HWIO → torch (..., Cout, Cin, 3, 3)."""
    w = np.asarray(w)
    return T(np.ascontiguousarray(np.moveaxis(w, (-1, -2), (-4, -3))))


def _direct(x, w, b, relu=False, dtype=jnp.float32):
    y = jax.lax.conv_general_dilated(x.astype(dtype), w.astype(dtype), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    y = y + b.astype(dtype)
    return jnp.maximum(y, 0) if relu else y


def _trunk_ref(x, ws, bv, wt, bt, res_scale, dtype=jnp.float32):
    """The ungated group on direct convs: ResBlocks (x + s·conv(relu(conv
    x))), the trailing conv and the skip, every op in ``dtype`` (the JAX
    EDSR's direct trunk, sres_tpu/models/edsr.py:111-117)."""
    q = x.astype(dtype)
    for i in range(ws.shape[0]):
        r = _direct(_direct(q, ws[i, 0], bv[i, 0], True, dtype), ws[i, 1], bv[i, 1],
                    dtype=dtype)
        q = q + r * res_scale
    return x.astype(dtype) + _direct(q, wt, bt, dtype=dtype)


def _pallas_case(seed):
    """Seeded inputs of the interpret-mode group checks: m=2, nb=2,
    1×8×8×128, res_scale 0.7; the JAX kernel takes 128 channels."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, k=0.05: (rng.normal(size=sh) * k).astype(np.float32)
    x, g = f(1, 8, 8, 128, k=1.0), f(1, 8, 8, 128, k=1.0)
    return (x, g, f(2, 2, 3, 3, 128, 128), f(2, 2, 128), f(3, 3, 128, 128), f(128),
            2, 0.7)


def _port_resgroup(x, g, ws, bv, wt, bt, m, s):
    """The twins' forward (writing the stash) and backward, as JAX arrays'
    layouts: y, dx NHWC; dws, dwt HWIO."""
    stash = []
    y = twc.wino_resgroup_fwd(_nchw(x), _oihw(ws), T(bv), m, _oihw(wt), T(bt), s,
                              stash)
    assert len(stash) == ws.shape[0] + 1
    dx, du, db, dut, dbt = twc.wino_resgroup_bwd(_nchw(g), stash, _oihw(ws), T(bv), m,
                                                 _oihw(wt), s)
    hwio = lambda a: a.numpy().transpose(*range(a.dim() - 4), -2, -1, -3, -4)
    return dict(y=_nhwc(y), dx=_nhwc(dx), dws=hwio(tw.untransform_weight_grad(du, m)),
                dbv=db.numpy(), dwt=hwio(tw.untransform_weight_grad(dut, m)),
                dbt=dbt.numpy())


def test_resgroup_plain_vs_pallas_trail():
    """One interpret-mode wino_resgroup_trail forward (the ungated group
    kernel with the trailing conv and skip) against wino_resgroup_fwd_plain,
    within 3e-5·max (the bar of tests/test_torch_winograd.py's group test)."""
    from sres_tpu.ops.pallas.wino_group_grad import wino_resgroup_trail
    x, g, ws, bv, wt, bt, m, s = _pallas_case(60)
    spec = jw.wino_spec(m, 8, 8)
    want = np.asarray(jw.from_quad(wino_resgroup_trail(
        jw.to_quad(jnp.asarray(x), spec), *map(jnp.asarray, (ws, bv, wt, bt)), m,
        (8, 8), 1, s), spec))
    got = twc.wino_resgroup_fwd(_nchw(x), _oihw(ws), T(bv), m, _oihw(wt), T(bt), s)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=3e-5 * float(np.abs(want).max()))


@pytest.mark.slow
def test_resgroup_twins_vs_pallas_trail_vjp():
    """wino_resgroup_fwd_plain and wino_resgroup_bwd_plain against one
    interpret-mode wino_resgroup_trail forward and its VJP, in the JAX
    stash-in-primal mode that the port's forward mirrors (three Pallas
    calls): y, dx, dws, dbv, dwt and dbt within 3e-5·max (the bar of
    tests/test_torch_winograd_grad.py's Pallas-backward and group-gradient
    tests)."""
    from sres_tpu.ops.pallas.wino_group_grad import wino_resgroup_trail
    x, g, ws, bv, wt, bt, m, s = case = _pallas_case(60)
    spec = jw.wino_spec(m, 8, 8)
    q = lambda a: jw.to_quad(jnp.asarray(a), spec)
    fn = lambda *a: wino_resgroup_trail(*a, m, (8, 8), 1, s)
    old = os.environ.get("SRES_WINO_STASH_PRIMAL")
    os.environ["SRES_WINO_STASH_PRIMAL"] = "1"       # read at trace time
    try:
        yq, vjp = jax.vjp(fn, q(x), *map(jnp.asarray, (ws, bv, wt, bt)))
        dxq, dws, dbv, dwt, dbt = vjp(q(g))
    finally:
        if old is None:
            del os.environ["SRES_WINO_STASH_PRIMAL"]
        else:
            os.environ["SRES_WINO_STASH_PRIMAL"] = old
    want = dict(y=jw.from_quad(yq, spec), dx=jw.from_quad(dxq, spec), dws=dws,
                dbv=dbv, dwt=dwt, dbt=dbt)
    got = _port_resgroup(*case)
    for k, e in want.items():
        e = np.asarray(e)
        assert got[k].shape == e.shape, k
        np.testing.assert_allclose(got[k], e, rtol=0,
                                   atol=3e-5 * float(np.abs(e).max()), err_msg=k)


def test_chain_plain_vs_pallas_chain():
    """One interpret-mode wino_chain_fwd (m=2, K=2, 1×8×8×128, ReLU) against
    the twin, within 3e-5·max; the CPU wrapper takes the twin."""
    from sres_tpu.ops.pallas.winograd_conv import wino_chain_fwd
    rng = np.random.default_rng(61)
    m, k = 2, 2
    x = rng.normal(size=(1, 8, 8, 128)).astype(np.float32)
    ws = (rng.normal(size=(k, 3, 3, 128, 128)) * 0.05).astype(np.float32)
    bv = (rng.normal(size=(k, 128)) * 0.05).astype(np.float32)
    spec = jw.wino_spec(m, 8, 8)
    want = np.asarray(jw.from_quad(wino_chain_fwd(
        jw.to_quad(jnp.asarray(x), spec), jnp.asarray(ws), jnp.asarray(bv), m,
        (8, 8), 1), spec))
    twc.reset_launches()
    got = twc.wino_chain_fwd(_nchw(x), _oihw(ws), T(bv), m)
    assert twc.LAUNCHES["wino_chain"] == 0
    assert torch.equal(got, twc.wino_chain_fwd_plain(_nchw(x), _oihw(ws), T(bv), m))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=3e-5 * float(np.abs(want).max()))


def test_resgroup_fn_vs_jax_grad_of_direct_reference():
    """WinoResGroupTrailFn through WinoResTrunk (nb=3, m=4, 8×8, res_scale
    0.7): the output, dx and every parameter's gradient against jax.grad of
    the direct-conv reference (3e-5·max, the bar of
    tests/test_torch_winograd_grad.py:test_group_fn_vs_jax_grad_of_direct_reference)."""
    nb, c, m, s = 3, 8, 4, 0.7
    trunk = init_torch_default(WinoResTrunk(c, nb, m, s), 62)
    x = np.random.default_rng(62).normal(size=(2, c, 8, 8)).astype(np.float32)
    xt = T(x).requires_grad_()
    y = trunk(xt)
    (y ** 2).sum().backward()
    convs = trunk._convs()
    hwio = lambda cv: cv.weight.detach().numpy().transpose(2, 3, 1, 0)
    ws = np.stack([hwio(cv) for cv in convs[:-1]]).reshape(nb, 2, 3, 3, c, c)
    bv = np.stack([cv.bias.detach().numpy() for cv in convs[:-1]]).reshape(nb, 2, c)
    args = [jnp.asarray(a) for a in (x.transpose(0, 2, 3, 1), ws, bv, hwio(convs[-1]),
                                     convs[-1].bias.detach().numpy())]
    loss = lambda *a: jnp.sum(_trunk_ref(*a, s) ** 2)
    gx, gws, gbv, gwt, gbt = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    want_y = np.asarray(jax.jit(lambda *a: _trunk_ref(*a, s))(*args))
    np.testing.assert_allclose(_nhwc(y), want_y, rtol=0,
                               atol=3e-5 * float(np.abs(want_y).max()))
    gws, gbv = np.asarray(gws).reshape(2 * nb, 3, 3, c, c), np.asarray(gbv).reshape(2 * nb, c)
    want = [gx] + [w for i in range(2 * nb) for w in (gws[i], gbv[i])] + [gwt, gbt]
    got = [xt.grad.numpy().transpose(0, 2, 3, 1)]
    for cv in convs:
        got += [cv.weight.grad.numpy().transpose(2, 3, 1, 0), cv.bias.grad.numpy()]
    for i, (a, e) in enumerate(zip(got, want)):
        e = np.asarray(e)
        np.testing.assert_allclose(a, e, rtol=0, atol=3e-5 * float(np.abs(e).max()),
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("m,mult", [(2, 4.0), (4, 12.0)])
def test_resgroup_bf16_envelope(m, mult):
    """The ungated group's bf16 twin (nb=3, 16 channels, 2×16×16, res_scale
    0.7, torch-default weight scale) within the JAX package's own envelope
    for Winograd in bf16 (tests/test_winograd.py:598-601: the forward's
    error against f32 within 4× (m=2) or 12× (m=4) the direct bf16 path's,
    + 1e-4), the direct bf16 path and the f32 truth being the JAX direct
    trunk in bf16 and in f32. (On the card the kernels are held to the
    twins' own envelope, tests/test_torch_cuda.py.)"""
    rng = np.random.default_rng(0)
    c, nb, s = 16, 3, 0.7
    k = 1 / np.sqrt(9 * c)
    f = lambda *sh: rng.uniform(-k, k, size=sh).astype(np.float32)
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    ws, bv, wt, bt = f(nb, 2, 3, 3, c, c), f(nb, 2, c), f(3, 3, c, c), f(c)
    truth = np.asarray(jax.jit(lambda *a: _trunk_ref(*a, s))(x, ws, bv, wt, bt))
    jax_bf16 = np.asarray(jax.jit(lambda *a: _trunk_ref(*a, s, jnp.bfloat16))(
        x, ws, bv, wt, bt).astype(jnp.float32))
    got = twc.wino_resgroup_fwd(_nchw(x).bfloat16(), _oihw(ws), T(bv), m, _oihw(wt),
                                T(bt), s)
    assert got.dtype == torch.bfloat16
    rel = lambda a: float(np.abs(a - truth).max() / np.abs(truth).max())
    e_port, e_jax = rel(_nhwc(got)), rel(jax_bf16)
    assert 0 < e_port <= mult * e_jax + 1e-4, (e_port, e_jax)


def jax_variables(cfg, seed):
    """A JAX EDSR variable tree holding the port's seeded torch-default
    weights (built by sres_tpu.util.torch_import, so no flax init)."""
    sd = build_model(cfg, 1, 1, "f32", seed=seed, device="cpu").state_dict()
    return import_variables(cfg["name"], {k: v.numpy() for k, v in sd.items()}, cfg)


@pytest.fixture(scope="module")
def jax_edsr():
    x = np.random.default_rng(64).normal(size=(2, 8, 8, 1)).astype(np.float32)
    model = jax_build_model(dict(CFG), 1, 1, precision="f32")
    v = jax_variables(CFG, 3)
    y = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    return x, v, y


@pytest.mark.parametrize("winograd", [None, 2, 4])
def test_edsr_matches_jax(jax_edsr, winograd):
    """The JAX EDSR's variables load strictly into the direct and the
    Winograd EDSR, whose forwards match the JAX forward within 2e-5·max
    (3e-5 under winograd, as tests/test_torch_rcan.py)."""
    x, variables, want = jax_edsr
    cfg = dict(CFG, winograd=winograd)
    model = build_model(cfg, 1, 1, precision="f32", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    assert isinstance(model.body, WinoResTrunk) == bool(winograd)
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 32, 32)
    tol = (3e-5 if winograd else 2e-5) * float(np.abs(want).max())
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=tol)


def test_edsr_export_copy_matches_jax_exporter(jax_edsr):
    """The port's copy of the EDSR exporter against
    sres_tpu.util.torch_export.export_variables: the same keys in the same
    order, bit for bit."""
    from sres_tpu.util.torch_export import export_variables as jax_export
    from sres_tpu_torch.util import weights
    variables = jax_edsr[1]
    want = jax_export("edsr", variables, CFG)
    got = weights.export_variables("edsr", variables, CFG)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_edsr_winograd_state_dict_names_match_direct():
    direct = build_model(CFG, 1, 1, "f32", device="cpu").state_dict()
    wino = build_model(dict(CFG, winograd=4), 1, 1, "f32", device="cpu").state_dict()
    assert list(direct) == list(wino)
    assert {"head.0.weight", "body.0.body.0.weight", "body.1.body.2.bias",
            "body.2.weight", "tail.0.0.weight", "tail.0.2.bias",
            "tail.1.weight"} <= set(direct)
    assert len(direct) == 2 * (1 + 2 * CFG["nlayers"] + 1 + 2 + 1)


def test_edsr_knobs_geometry_and_unported_options():
    """TPU knobs are accepted with no effect; quantization builds (ported:
    the same parameter names, the Winograd trunk switched off, as in JAX)
    and an unknown mode raises; under winograd a tile that m does not
    divide raises (the JAX model falls back to the direct path instead,
    ROADMAP Queue 3)."""
    ref = build_model(CFG, 1, 1, "f32", device="cpu").state_dict()
    knobs = build_model(dict(CFG, lane_pack=2, winograd_bs=4, scan_groups=True,
                             remat_trunk=True), 1, 1, "f32", device="cpu")
    assert list(knobs.state_dict()) == list(ref)
    quant = build_model(dict(CFG, quantization="int8_fused", winograd=4), 1, 1, "f32",
                        device="cpu")
    assert quant.quant == "int8_fused" and not quant.winograd
    assert list(quant.state_dict()) == list(ref)
    with pytest.raises(ValueError, match="Unknown quantization mode"):
        build_model(dict(CFG, quantization="int4"), 1, 1, "f32", device="cpu")
    model = build_model(dict(CFG, winograd=4), 1, 1, "f32", device="cpu")
    with pytest.raises(ValueError, match="multiples of the tile size"), torch.no_grad():
        model(torch.zeros(1, 1, 6, 6))
    with torch.no_grad():
        assert model(torch.zeros(1, 1, 8, 8)).grad_fn is None
    model(torch.zeros(1, 1, 8, 8)).sum().backward()
    assert all(p.grad is not None for p in model.parameters())
