"""The port's train step, optimizer and lr schedule against the JAX package
(build_train_step + optax.adam, lr_at_epoch, set_learning_rate), on tiny
RCANs and EDSRs from numpy seeds. On the CPU the Winograd trunk trains through the
plain twins of its kernels, inside the same autograd Functions as on the
card.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.trainer import step as jstep
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.wino_blocks import WinoConv
from sres_tpu_torch.ops.winograd import transform_weights
from sres_tpu_torch.ops.winograd_conv import bwd_order, conv_order
from sres_tpu_torch.trainer import step as tstep
from sres_tpu_torch.util.weights import state_dict_from_jax

CFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=2, cbottleneck=2,
           kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")
CFGS = {"rcan": CFG,
        "edsr": dict(name="edsr", nfeatures=8, nlayers=2, res_scale=0.8,
                     kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")}
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-3)
STEPS, SEED = 3, 5


class _Cfg(dict):
    """A mapping with attribute access, as the JAX package reads configs."""
    __getattr__ = dict.__getitem__


def _batches():
    rng = np.random.default_rng(SEED)
    hr = rng.normal(size=(STEPS, 3, 1, 16, 16)).astype(np.float32)
    return hr, np.array([1.0, 1.0, 0.0], np.float32)       # one padding tile


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps from the port's seeded init, per model name
    (run once each): per-step metrics and the final parameters as a torch
    state dict."""
    runs = {}

    def run(name):
        if name not in runs:
            runs[name] = _jax_run(CFGS[name])
        return runs[name]
    return run


def _jax_run(cfg):
    sd0 = build_model(cfg, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    v = import_variables(cfg["name"], {k: t.numpy() for k, t in sd0.items()}, cfg)
    model = jax_build_model(dict(cfg), 1, 1, precision="f32")
    opt = optax.adam(TASK["lr"])
    state = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats={}, opt_state=opt.init(v["params"]))
    sc = jstep.make_step_config(_Cfg(TASK), _Cfg(cfg), has_bn=False)
    step = jstep.build_train_step(model, opt, sc)
    hr, weight = _batches()
    metrics = []
    for i in range(STEPS):
        state, met = step(state, jnp.asarray(hr[i]), jnp.asarray(weight))
        metrics.append({k: float(x) for k, x in met.items()})
    final = {"params": jax_to_numpy(state.params)}
    return sd0, metrics, state_dict_from_jax(final, cfg)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("name,winograd", [("rcan", None), ("rcan", 4),
                                           ("edsr", None), ("edsr", 4)],
                         ids=["None", "4", "edsr-None", "edsr-4"])
def test_train_steps_match_jax(jax_run, name, winograd):
    """Three Adam steps (lr 1e-3, a 0-weight padding tile) on the direct
    trunk and on ``winograd: 4`` (the JAX side runs its direct trunk, since
    its Winograd path needs 128 packed lanes), for RCAN and for EDSR
    (res_scale 0.8; its Winograd trunk is the ungated group): losses within
    rtol 1e-5, parameters within the bar of tests/test_train_parity.py
    (rtol 5e-4, atol 5e-6), with its straggler bound for elements whose
    Adam update sign Winograd's f32 roundoff flips."""
    cfg = CFGS[name]
    sd0, jmetrics, jfinal = jax_run(name)
    model = build_model(dict(cfg, winograd=winograd), 1, 1, "f32", device="cpu")
    model.load_state_dict(sd0)
    opt = tstep.build_optimizer(model, TASK)
    step = tstep.build_train_step(model, opt, tstep.make_step_config(TASK, cfg))
    hr, weight = _batches()
    for i in range(STEPS):
        met = step(torch.from_numpy(hr[i]), torch.from_numpy(weight))
        assert set(met) == set(jmetrics[i]) == {"mloss", "sloss", "interp_sloss"}
        for k, x in met.items():
            assert x.dim() == 0 and x.dtype == torch.float32
            np.testing.assert_allclose(float(x), jmetrics[i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    nviol, ntot, maxabs = 0, 0, 0.0
    for k, p in model.state_dict().items():
        a, b = p.numpy(), jfinal[k].numpy()
        if winograd:
            nviol += int((~np.isclose(a, b, rtol=5e-4, atol=5e-6)).sum())
            ntot += a.size
            maxabs = max(maxabs, float(np.abs(a - b).max()))
        else:
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6, err_msg=k)
    if winograd:
        assert nviol <= max(1, 1e-4 * ntot), f"{nviol}/{ntot} violations"
        assert maxabs < STEPS * TASK["lr"] * 1.5, maxabs


def test_optimizer_step_refreshes_the_winograd_cache():
    """After an optimizer step the next forward uses the new weights: the
    foreach Adam update bumps the parameters' version counters, the fused
    one (as on the card) does not, and the count of optimizer steps in the
    cache key covers both."""
    for fused in (True, False):
        conv = WinoConv(8, 8, 4)
        u0 = conv._u(torch.float32)
        opt = torch.optim.Adam(conv.parameters(), lr=1e-2, fused=fused)
        conv(torch.ones(1, 8, 4, 4)).sum().backward()
        opt.step()
        u1 = conv._u(torch.float32)
        assert u1 is not u0 and not torch.equal(u1, u0)
        assert torch.equal(u1, transform_weights(conv.weight, 4))


def test_build_optimizer_kinds_and_device():
    model = build_model(CFG, 1, 1, "f32", device="cpu")
    adam = tstep.build_optimizer(model, TASK, packed=True)
    assert type(adam) is torch.optim.Adam and adam.defaults["fused"] is False
    assert adam.defaults["eps"] == 1e-8 and adam.defaults["betas"] == (0.9, 0.999)
    adamw = tstep.build_optimizer(model, dict(TASK, weight_decay=0.01))
    assert type(adamw) is torch.optim.AdamW and adamw.defaults["weight_decay"] == 0.01
    assert all(p.device.type == "cpu" for g in adam.param_groups for p in g["params"])


@pytest.mark.parametrize("sched", [
    None,
    dict(type="step", step_size=2, gamma=0.5),
    dict(type="multistep", milestones=[1, 3], gamma=0.1),
    dict(type="exponential", gamma=0.9),
    dict(type="cosine", t_max=5, eta_min=1e-5),
])
def test_lr_schedule_matches_jax(sched):
    task = dict(TASK, scheduler=sched)
    for e in range(7):
        np.testing.assert_allclose(tstep.lr_at_epoch(task, e),
                                   jstep.lr_at_epoch(_Cfg(task), e), rtol=1e-12)
    # set_learning_rate: the injected lr with a scheduler, a no-op without
    params = {"w": jnp.zeros(3)}
    jopt = jstep.build_optimizer(_Cfg(task))
    jstate = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats={}, opt_state=jopt.init(params))
    jstate = jstep.set_learning_rate(jstate, 0.25)
    opt = tstep.build_optimizer(torch.nn.Linear(3, 1), task)
    tstep.set_learning_rate(opt, 0.25)
    want = (float(jstate.opt_state.hyperparams["learning_rate"]) if sched
            else TASK["lr"])
    assert all(g["lr"] == pytest.approx(want) for g in opt.param_groups)


@pytest.mark.slow
def test_flagship_winograd_trajectory_full_size():
    """RCAN-10-20-64 ×4 at ``winograd: 4``, full width and depth: three
    Adam steps (lr 1e-4, batch 2, 48×48 LR) against the JAX direct trunk
    of the same weights, with the bar of test_train_steps_match_jax."""
    cfg = dict(CFG, nlayers=10, nblocks=20, nfeatures=64)
    task = dict(TASK, lr=1e-4)
    sd0 = build_model(cfg, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    v = import_variables("rcan", {k: t.numpy() for k, t in sd0.items()}, cfg)
    jmodel = jax_build_model(dict(cfg), 1, 1, precision="f32")
    jopt = optax.adam(task["lr"])
    state = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats={}, opt_state=jopt.init(v["params"]))
    jtrain = jstep.build_train_step(jmodel, jopt, jstep.make_step_config(
        _Cfg(task), _Cfg(cfg), has_bn=False))
    model = build_model(dict(cfg, winograd=4), 1, 1, "f32", device="cpu")
    model.load_state_dict(sd0)
    train = tstep.build_train_step(model, tstep.build_optimizer(model, task),
                                   tstep.make_step_config(task, cfg))
    hr = np.random.default_rng(SEED).normal(size=(STEPS, 2, 1, 192, 192)).astype(np.float32)
    weight = np.ones(2, np.float32)
    for i in range(STEPS):
        state, jmet = jtrain(state, jnp.asarray(hr[i]), jnp.asarray(weight))
        met = train(torch.from_numpy(hr[i]), torch.from_numpy(weight))
        np.testing.assert_allclose(float(met["mloss"]), float(jmet["mloss"]), rtol=1e-5)
    final = state_dict_from_jax({"params": jax_to_numpy(state.params)}, cfg)
    nviol, ntot, maxabs = 0, 0, 0.0
    for k, p in model.state_dict().items():
        a, b = p.numpy(), final[k].numpy()
        nviol += int((~np.isclose(a, b, rtol=5e-4, atol=5e-6)).sum())
        ntot += a.size
        maxabs = max(maxabs, float(np.abs(a - b).max()))
    assert nviol <= 1e-4 * ntot, f"{nviol}/{ntot} violations"
    assert maxabs < STEPS * task["lr"] * 1.5, maxabs


def test_optimizer_step_refreshes_the_kernel_order_u():
    """The kernels' cached U (a ``WinoU``: U in the conv kernel's order and
    Uᵀ in the adjoint's) is rebuilt after a fused Adam step, like the
    natural U above, and holds the new weights' transform."""
    conv = WinoConv(64, 64, 4)
    ku0 = conv._u(torch.bfloat16, kernel=True)
    assert conv._u(torch.bfloat16, kernel=True) is ku0
    opt = torch.optim.Adam(conv.parameters(), lr=1e-2, fused=True)
    conv(torch.ones(1, 64, 4, 4)).sum().backward()
    opt.step()
    ku1 = conv._u(torch.bfloat16, kernel=True)
    u = transform_weights(conv.weight, 4).to(torch.bfloat16)
    assert ku1 is not ku0 and not torch.equal(ku1.fwd, ku0.fwd)
    assert torch.equal(ku1.u, u)
    assert torch.equal(ku1.fwd, conv_order(u)) and torch.equal(ku1.bwd, bwd_order(u))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("order", ["conv", "bwd"])
def test_kernel_order_u_is_a_permutation_and_back(m, order):
    """The conv kernel's and the adjoint's orders of U (bf16) move every
    element once: applied to the flat indices they give a permutation,
    which carries a U there and, inverted, back. Spot checks of the layouts
    the kernels read: U[ti·n + tj][ci][co] at [tj][ti][ci // 8][co][ci % 8],
    Uᵀ[t][16·ks + 8·hh + 2·q + e][8·nb + g] at [t][nb][ks][g][q][hh][e]."""
    n, fn = m + 2, {"conv": conv_order, "bwd": bwd_order}[order]
    idx = fn(torch.arange(n * n * 64 * 64).reshape(n * n, 64, 64)).flatten()
    assert torch.equal(idx.sort().values, torch.arange(idx.numel()))
    u = torch.from_numpy(np.random.default_rng(m).normal(
        size=(n * n, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    k = fn(u)
    assert torch.equal(k.flatten(), u.flatten()[idx])
    back = torch.empty_like(u).flatten()
    back[idx] = k.flatten()
    assert torch.equal(back.reshape(u.shape), u)
    ti, tj, ci, co = n - 1, 1, 37, 22
    if order == "conv":
        assert k[tj, ti, ci // 8, co, ci % 8] == u[ti * n + tj, ci, co]
    else:   # Uᵀ[t][k][nn] = U[t][nn][k], k = 16·ks + 8·hh + 2·q + e, nn = 8·nb + g
        ks, hh, q, e, nb, g = 2, 1, 3, 0, 5, 6
        kk, nn = 16 * ks + 8 * hh + 2 * q + e, 8 * nb + g
        assert k[ti * n + tj, nb, ks, g, q, hh, e] == u[ti * n + tj, nn, kk]
    # and a stack of convs orders conv by conv (the group caches' operands)
    assert torch.equal(fn(torch.stack([u, u + 1]))[1], fn(u + 1))


SERVE_TRAIN = {"rcan-direct": ("rcan", {}), "rcan-winograd-2": ("rcan", {"winograd": 2}),
               "rcan-winograd-4": ("rcan", {"winograd": 4}),
               "rcan-fused": ("rcan", {"fused": True}),
               "edsr-winograd-4": ("edsr", {"winograd": 4}),
               "rcan-int8_full": ("rcan", {"quantization": "int8_full", "lane_pack": 2}),
               "edsr-int8_fused": ("edsr", {"quantization": "int8_fused", "lane_pack": 2})}


@pytest.mark.parametrize("trunk", list(SERVE_TRAIN))
def test_serve_then_train_matches_a_model_that_did_not_serve(trunk):
    """Serving (``build_eval_step``, under ``torch.inference_mode``) fills
    the operand caches; the training steps after it must neither fail on
    inference tensors nor differ: serve, train, serve, train on one model,
    train, train on a twin of the same seed that never served, the same
    losses and gradients bit for bit (the JAX trainer validates after every
    epoch, trainer.py:435)."""
    name, opts = SERVE_TRAIN[trunk]
    cfg = dict(CFGS[name], **opts)
    hr, weight = (torch.from_numpy(a) for a in _batches())
    sc = tstep.make_step_config(TASK, cfg)
    runs = []
    for serve in (True, False):
        model = build_model(cfg, 1, 1, "f32", seed=SEED, device="cpu")
        step = tstep.build_train_step(model, tstep.build_optimizer(model, TASK), sc)
        serve_step = tstep.build_eval_step(model, sc)
        out = []
        for i in range(2):
            if serve:
                metrics, outs = serve_step(hr[i], weight)
                assert all(torch.isfinite(o).all() for o in outs)
            met = step(hr[i], weight)
            out.append((met, {k: p.grad.clone() for k, p in model.named_parameters()}))
        runs.append(out)
    for (met_a, g_a), (met_b, g_b) in zip(*runs):
        assert {k: float(v) for k, v in met_a.items()} == {k: float(v) for k, v in met_b.items()}
        assert g_a.keys() == g_b.keys()
        for k in g_a:
            assert torch.equal(g_a[k], g_b[k]), k
