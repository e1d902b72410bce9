"""Shared harness of tests/test_torch_zoo.py and tests/test_torch_zoo_bn.py:
one tiny model of each zoo architecture (the configs of
tests/test_train_parity.py:20-53), seeded in the port and carried into JAX
by ``sres_tpu.util.torch_import``; the JAX model's f32 eval forward, three
steps of ``sres_tpu``'s ``build_train_step`` (optax Adam at the synthetic
and SST tasks' lr, 1e-4) and the
eval forward after them, against the port's ``build_train_step`` on the same
padded batches (one zero-weight tile a batch, so BatchNorm statistics run
padding-aware on both sides). Each architecture's run is made once a
process and shared by its tests."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.trainer import step as jstep
from sres_tpu.util.torch_export import export_variables as jax_export
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.layers import has_batch_norm
from sres_tpu_torch.trainer import step as tstep
from sres_tpu_torch.util.weights import export_variables, state_dict_from_jax

CFGS = {
    "vdsr": dict(name="vdsr", nfeatures=8, nlayers=4, kernel_size=3,
                 downscale_factors=[2, 2]),
    "dbpn": dict(name="dbpn", nfeatures=8, nprojectionfeatures=4, depth=2,
                 kernel_size=3, downscale_factors=[2, 2]),
    "latticenet": dict(name="latticenet", nfeatures=16, ndiff=4, kernel_size=3,
                       downscale_factors=[2, 2]),
    "esrt": dict(name="esrt", nfeatures=32, nlayers=1, kernel_size=3,
                 downscale_factors=[2, 2]),
    "srdn": dict(name="srdn", nfeatures={"hidden": 8, "upscale": 4}, nlayers=2,
                 kernel_size={"features": 5, "hidden": 3, "output": 1},
                 downscale_factors=[2, 2]),
    "unet": dict(name="unet", nfeatures=8, nlayers=2, kernel_size=3,
                 downscale_factors=[2, 2]),
    "mscnn": dict(name="mscnn", nfeatures=8, nlayers=2, kernel_size=3,
                  downscale_factors=[2, 2], ups_mode="bicubic"),
    "lapsrn": dict(name="lapsrn", nfeatures=8, kernel_size=3,
                   downscale_factors=[2, 2], ups_mode="bicubic"),
}
# the UNet with 4 temporal features (the trainer's sin/cos day and year rows)
CFGS["unet-temporal"] = dict(CFGS["unet"], use_temporal_features=True)
# config/task/synthetic-tiles-48.yaml's lr. At 1e-3 the tiny UNet's running
# means drift to 1.25x the bar by step 3 though step 1 agrees within 7e-8:
# Adam's first updates are lr·g/(|g| + 1e-8), and a few of its gradients
# are 1e-8 to 1e-7, where f32 summation order moves the update by ~1 %
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-4)
STEPS, B, HR, SEED, NTF = 3, 4, 48, 5, 4
WEIGHT = np.array([1, 1, 1, 0], np.float32)


class Cfg(dict):
    """A mapping with attribute access, as the JAX package reads configs."""
    __getattr__ = dict.__getitem__


def arch_of(case: str) -> str:
    return case.split("-")[0]


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _levels(out):
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else (out,))]


def _run(case: str) -> dict:
    torch.set_num_threads(1)
    arch, cfg = arch_of(case), CFGS[case]
    ntf = NTF if case.endswith("temporal") else 0
    model = build_model(cfg, 1, 1, "f32", seed=SEED, device="cpu",
                        temporal_features=ntf or None)
    sd0 = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    variables = import_variables(arch, sd0, cfg)
    jmodel = jax_build_model(cfg, 1, 1, "f32",
                             temporal_features=np.zeros((1, NTF), np.float32) if ntf else None)
    rng = np.random.default_rng(SEED)
    hr = rng.normal(size=(STEPS, B, 1, HR, HR)).astype(np.float32)
    hr[:, WEIGHT == 0] = 0.0                      # the trainer's zero padding tiles
    temporal = rng.normal(size=(STEPS, B, NTF)).astype(np.float32)
    x_eval = rng.normal(size=(2, 1, HR // 4, HR // 4)).astype(np.float32)
    t_eval = temporal[0, :2]

    # JAX: the eval forward, three steps of its train step, the eval forward
    has_bn = bool(variables.get("batch_stats"))
    ev = jax.jit(lambda v, x, t=None: jmodel.apply(v, x, train=False,
                                                   **({"temporal": t} if ntf else {})))
    xj = jnp.asarray(x_eval.transpose(0, 2, 3, 1))
    evargs = (jnp.asarray(t_eval),) if ntf else ()
    jout0 = _levels(ev(variables, xj, *evargs))
    opt = optax.adam(TASK["lr"])
    sc_j = jstep.make_step_config(Cfg(TASK), Cfg(cfg), has_bn, ntf)
    state = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables.get("batch_stats", {}),
                               opt_state=opt.init(variables["params"]))
    jtrain = jstep.build_train_step(jmodel, opt, sc_j)
    jlosses = []
    for i in range(STEPS):
        args = (jnp.asarray(hr[i]), jnp.asarray(WEIGHT)) + ((jnp.asarray(temporal[i]),)
                                                             if ntf else ())
        state, met = jtrain(state, *args)
        jlosses.append(float(met["mloss"]))
    jvars = {"params": numpy_tree(state.params)}
    if has_bn:
        jvars["batch_stats"] = numpy_tree(state.batch_stats)
    jout3 = _levels(ev(jvars, xj, *evargs))

    # the port: the same forward and steps
    targ = (lambda t: (torch.from_numpy(t),)) if ntf else (lambda t: ())
    model.eval()
    with torch.no_grad():
        tout0 = _levels(model(torch.from_numpy(x_eval), *targ(t_eval)))
    sc = tstep.make_step_config(TASK, cfg, has_batch_norm(model), ntf)
    step = tstep.build_train_step(model, tstep.build_optimizer(model, TASK), sc)
    tlosses = [float(step(torch.from_numpy(hr[i]), torch.from_numpy(WEIGHT),
                          *targ(temporal[i]))["mloss"]) for i in range(STEPS)]
    model.eval()
    with torch.no_grad():
        tout3 = _levels(model(torch.from_numpy(x_eval), *targ(t_eval)))
    return dict(cfg=cfg, arch=arch, has_bn=has_bn, variables0=numpy_tree(variables),
                jvars=jvars, jout0=jout0, jout3=jout3, jlosses=jlosses, tout0=tout0,
                tout3=tout3, tlosses=tlosses, model=model)


_RUNS: dict = {}


def run(case: str) -> dict:
    if case not in _RUNS:
        _RUNS[case] = _run(case)
    return _RUNS[case]


def check_forward(case: str) -> None:
    """Every level of the f32 eval forward within 2e-5·max of JAX's
    (PARITY.md's golden bar), NCHW against NHWC."""
    r = run(case)
    assert len(r["tout0"]) == len(r["jout0"])
    for j, t in zip(r["jout0"], r["tout0"]):
        j = j.transpose(0, 3, 1, 2)
        assert t.shape == j.shape
        assert np.abs(t - j).max() <= 2e-5 * np.abs(j).max()


def check_export(case: str) -> None:
    """The port's exporter equals sres_tpu's key for key and bit for bit,
    on the seeded tree and on the trained one (with its batch statistics),
    and the trained tree loads into the port's model with strict=True."""
    r = run(case)
    for variables in (r["variables0"], r["jvars"]):
        want = jax_export(r["arch"], variables, r["cfg"])
        got = export_variables(r["arch"], variables, r["cfg"])
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    fresh = build_model(r["cfg"], 1, 1, "f32", device="cpu",
                        temporal_features=NTF if case.endswith("temporal") else None)
    fresh.load_state_dict(state_dict_from_jax(r["jvars"], r["cfg"]), strict=True)


def check_trajectory(case: str) -> None:
    """Three Adam steps: the losses within rtol 2e-5 + 2e-6; for BatchNorm
    models the running statistics (rtol 5e-4 + 1e-5; SRDN 5e-3 + 3e-4) and
    the eval forward after the steps (1e-4; SRDN 1e-3), the bars of
    tests/test_train_parity.py:229-248."""
    r = run(case)
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=2e-5, atol=2e-6)
    assert np.isfinite(r["tlosses"]).all()
    if not r["has_bn"]:
        return
    srdn = r["arch"] == "srdn"
    srtol, satol = (5e-3, 3e-4) if srdn else (5e-4, 1e-5)
    want = state_dict_from_jax(r["jvars"], r["cfg"])
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    got = r["model"].state_dict()
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=srtol, atol=satol,
                                   err_msg=k)
    ftol = 1e-3 if srdn else 1e-4
    for j, t in zip(r["jout3"], r["tout3"]):
        np.testing.assert_allclose(t, j.transpose(0, 3, 1, 2), rtol=ftol, atol=ftol)
