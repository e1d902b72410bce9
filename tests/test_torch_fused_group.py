"""The port's direct-conv residual group (``model.fused: true``) against the
JAX package's fused residual-group kernel
(sres_tpu/ops/pallas/attic/residual_group.py), which runs in interpret mode
on the CPU as tests/test_residual_group_kernel.py runs it.

On the CPU the port's wrappers run their plain twins; the CUDA kernels are
held against the twins on the card by tests/test_torch_cuda.py. The JAX
kernel needs lane-packed C = 128, so the group runs at 64 features with two
tiles packed into one (the port runs each tile at C = 64); 2 RCABs on a
rectangular 6×10 field. The JAX trees come from the port's seeded init
through sres_tpu.util.torch_import and rcan_params_to_fused (no flax init).
Every JAX run is shared through module fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.models.fused import FusedResidualGroup as JaxFusedGroup
from sres_tpu.models.fused import rcan_params_to_fused
from sres_tpu.models.layers import pack_tiles, unpack_tiles
from sres_tpu.trainer import step as jstep
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.fused import FusedResidualGroup
from sres_tpu_torch.trainer import step as tstep
from sres_tpu_torch.util import weights

NF, RED, NB, H, W = 64, 2, 2, 6, 10
CFG = dict(name="rcan", nfeatures=NF, nlayers=1, nblocks=NB, cbottleneck=RED,
           kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")
# the tiny RCAN of the eval-step and trajectory cases
TINY = dict(CFG, nblocks=1, fused=True)
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-3)
STEPS = 3


class _Cfg(dict):
    """A mapping with attribute access, as the JAX package reads configs."""
    __getattr__ = dict.__getitem__


def jax_fused_params(cfg, seed):
    """(port state dict, JAX fused params) of seeded torch-default weights."""
    sd = build_model(dict(cfg, fused=False), 1, 1, "f32", seed=seed,
                     device="cpu").state_dict()
    v = import_variables("rcan", {k: t.numpy() for k, t in sd.items()}, cfg)
    return sd, rcan_params_to_fused(v["params"], cfg["nlayers"], cfg["nblocks"])


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def group_state(f, nb):
    """A JAX FusedResidualGroup tree (or its gradients) → the port group's
    parameter names, through the port's copy of rcan_params_from_fused."""
    g = weights.rcan_params_from_fused({"FusedResidualGroup_0": _np(f)}, 1,
                                       nb)["ResidualGroup_0"]
    tw = {}
    conv = lambda name, node: tw.update({
        f"{name}.weight": node["Conv_0"]["kernel"].transpose(3, 2, 0, 1),
        f"{name}.bias": node["Conv_0"]["bias"]})
    for b in range(nb):
        r = g[f"RCAB_{b}"]
        conv(f"body.{b}.body.0", r["Conv_0"])
        conv(f"body.{b}.body.2", r["Conv_1"])
        conv(f"body.{b}.body.3.conv_du.0", r["CALayer_0"]["Conv_0"])
        conv(f"body.{b}.body.3.conv_du.2", r["CALayer_0"]["Conv_1"])
    conv(f"body.{nb}", g["Conv_0"])
    return tw


@pytest.fixture(scope="module")
def group_case():
    """The JAX group's f32 output and VJP, and its bf16 output, on two
    seeded 6×10 tiles; the port's group holding the same weights."""
    sd, pf = jax_fused_params(CFG, 7)
    params = pf["FusedResidualGroup_0"]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, H, W, NF)) * 0.5).astype(np.float32)
    gy = rng.normal(size=(2, H, W, NF)).astype(np.float32)

    def apply(dtype, p, x_):
        mod = JaxFusedGroup(NF, RED, NB, dtype=dtype)
        return unpack_tiles(mod.apply({"params": p}, pack_tiles(x_.astype(dtype), 2)), 2)

    def value_and_vjp(p, x_, g):
        y_, vjp = jax.vjp(lambda p_, xx: apply(jnp.float32, p_, xx), p, x_)
        return y_, vjp(g)

    # jitted: one compile of the interpret-mode kernels instead of op by op
    y, (dparams, dx) = jax.jit(value_and_vjp)(params, jnp.asarray(x), jnp.asarray(gy))
    yb = jax.jit(apply, static_argnums=0)(jnp.bfloat16, params, jnp.asarray(x))
    grp = FusedResidualGroup(NF, RED, NB)
    grp.load_state_dict({k[len("body.0."):]: v for k, v in sd.items()
                         if k.startswith("body.0.")}, strict=True)
    return dict(grp=grp, x=x, gy=gy, y=np.asarray(y), yb=np.asarray(yb, np.float32),
                dx=np.asarray(dx), dparams=group_state(dparams, NB))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def test_group_forward_matches_jax(group_case):
    """The twin's f32 group forward against the interpret-mode JAX kernel,
    with the tolerance of tests/test_residual_group_kernel.py:33-34."""
    with torch.no_grad():
        got = group_case["grp"](_nchw(group_case["x"]))
    np.testing.assert_allclose(_nhwc(got), group_case["y"], rtol=2e-5, atol=2e-5)


def test_group_gradients_match_jax_vjp(group_case):
    """dx and every weight gradient through FusedGroupFn (the twins' group
    backward) against the JAX kernel's custom VJP, with the tolerance of
    tests/test_residual_group_kernel.py:51-57."""
    grp = group_case["grp"]
    xx = _nchw(group_case["x"]).requires_grad_()
    names = [n for n, _ in grp.named_parameters()]
    gs = torch.autograd.grad(grp(xx), [xx, *grp.parameters()], _nchw(group_case["gy"]))
    assert set(names) == set(group_case["dparams"])
    np.testing.assert_allclose(_nhwc(gs[0]), group_case["dx"], rtol=5e-4, atol=5e-4)
    for name, gr in zip(names, gs[1:]):
        np.testing.assert_allclose(gr.numpy(), group_case["dparams"][name],
                                   rtol=5e-4, atol=5e-4, err_msg=name)


def test_group_bf16_within_jax_bf16_envelope(group_case):
    """The twin in bf16 against the JAX kernel in bf16: rel_err(port_bf16,
    jax_f32) ≤ 2·rel_err(jax_bf16, jax_f32) + 1e-4."""
    with torch.no_grad():
        got = _nhwc(group_case["grp"](_nchw(group_case["x"]).bfloat16()))
    ref = group_case["y"]
    rel = lambda a: float(np.abs(a - ref).max() / np.abs(ref).max())
    assert 0 < rel(got) <= 2 * rel(group_case["yb"]) + 1e-4


@pytest.fixture(scope="module")
def tiny_rcan():
    """The JAX fused RCAN (1 group of 1 RCAB, 64 features): its eval step on
    one batch, and three Adam steps from the same weights."""
    _, pf = jax_fused_params(TINY, 11)
    pf = _np(pf)                     # the train step donates its state's arrays
    rng = np.random.default_rng(11)
    hr = rng.normal(size=(STEPS, 2, 1, 32, 32)).astype(np.float32)
    weight = np.array([1.0, 1.0], np.float32)
    model = jax_build_model(dict(TINY), 1, 1, precision="f32")
    sc = jstep.make_step_config(_Cfg(TASK), _Cfg(TINY), has_bn=False)
    opt = optax.adam(TASK["lr"])
    params = jax.tree.map(jnp.asarray, pf)
    state = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={}, opt_state=opt.init(params))
    _, outs = jstep.build_eval_step(model, sc)(state, jnp.asarray(hr[0]),
                                               jnp.asarray(weight))
    step = jstep.build_train_step(model, opt, sc)
    metrics = []
    for i in range(STEPS):
        state, met = step(state, jnp.asarray(hr[i]), jnp.asarray(weight))
        metrics.append({k: float(v) for k, v in met.items()})
    return dict(pf=pf, hr=hr, weight=weight, out=np.asarray(outs[1]),
                metrics=metrics, final=_np(state.params))


def test_fused_rcan_eval_step_matches_jax(tiny_rcan):
    """A JAX fused tree, moved by state_dict_from_jax, loads into the port's
    fused RCAN with strict=True, and the eval step's output matches the
    JAX eval step's within 2e-5·max."""
    model = build_model(TINY, 1, 1, "f32", device="cpu")
    model.load_state_dict(weights.state_dict_from_jax({"params": tiny_rcan["pf"]}, TINY),
                          strict=True)
    sc = tstep.make_step_config(TASK, TINY)
    _, outs = tstep.build_eval_step(model, sc)(torch.from_numpy(tiny_rcan["hr"][0]),
                                               torch.from_numpy(tiny_rcan["weight"]))
    want = tiny_rcan["out"]
    np.testing.assert_allclose(outs[1].numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))


def test_fused_rcan_train_steps_match_jax(tiny_rcan):
    """Three Adam steps (lr 1e-3) of the port's fused RCAN against
    sres_tpu's train step on the same weights, with the bar of
    tests/test_torch_train.py:85-95 for a trunk that sums in another order
    than JAX's (there the Winograd trunk; here the direct convs against the
    JAX kernel's packed block-diagonal products): losses within rtol 1e-5,
    parameters within rtol 5e-4, atol 5e-6, but for at most max(1, 1e-4 of
    them) whose Adam update sign the roundoff flips, which stay within
    1.5·steps·lr."""
    model = build_model(TINY, 1, 1, "f32", device="cpu")
    model.load_state_dict(weights.state_dict_from_jax({"params": tiny_rcan["pf"]}, TINY))
    step = tstep.build_train_step(model, tstep.build_optimizer(model, TASK),
                                  tstep.make_step_config(TASK, TINY))
    for i in range(STEPS):
        met = step(torch.from_numpy(tiny_rcan["hr"][i]),
                   torch.from_numpy(tiny_rcan["weight"]))
        for k, v in met.items():
            np.testing.assert_allclose(float(v), tiny_rcan["metrics"][i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    final = weights.state_dict_from_jax({"params": tiny_rcan["final"]}, TINY)
    nviol, ntot, maxabs = 0, 0, 0.0
    for k, p in model.state_dict().items():
        a, b = p.numpy(), final[k].numpy()
        nviol += int((~np.isclose(a, b, rtol=5e-4, atol=5e-6)).sum())
        ntot += a.size
        maxabs = max(maxabs, float(np.abs(a - b).max()))
    assert nviol <= max(1, 1e-4 * ntot), f"{nviol}/{ntot} violations"
    assert maxabs < STEPS * TASK["lr"] * 1.5, maxabs


def test_fused_export_matches_unfused_export():
    """export_variables on a fused tree gives the unfused tree's state dict,
    key for key and bit for bit."""
    cfg = dict(CFG, nblocks=2)
    sd, pf = jax_fused_params(cfg, 3)
    got = weights.export_variables("rcan", {"params": _np(pf)}, cfg)
    assert list(got) == list(sd)
    for k, v in sd.items():
        assert np.array_equal(got[k], v.numpy()), k
