"""The port's multi-step and gradient-accumulation steps, its trainer and its
launcher against the JAX package, on tiny RCANs from numpy seeds: the step
variants against ``sres_tpu``'s (K = 2, from the same weights), the
accumulation invariants, the synthetic task's loss CSV against the JAX
trainer's from the same initial weights, resume from the train checkpoint,
and the resize matrices kept on the device."""
import csv
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sres_tpu import config as jconfig
from sres_tpu.models import build_model as jax_build_model
from sres_tpu.trainer import step as jstep
from sres_tpu.util.logging import LogManager as JLogManager
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch import config as tconfig
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.models import build_model
from sres_tpu_torch.ops import resize as tresize
from sres_tpu_torch.ops import winograd as twino
from sres_tpu_torch.train import main as launch
from sres_tpu_torch.trainer import step as tstep
from sres_tpu_torch.trainer.trainer import ModelTrainer
from sres_tpu_torch.util.weights import state_dict_from_jax

CFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=2, cbottleneck=2,
           kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-3)
K, SEED = 2, 7


class _Cfg(dict):
    """A mapping with attribute access, as the JAX package reads configs."""
    __getattr__ = dict.__getitem__


def _stack():
    """(K, 3, 1, 16, 16) HR batches and (K, 3) weights: one padding tile in
    the first micro-batch, two in the second."""
    hr = np.random.default_rng(SEED).normal(size=(K, 3, 1, 16, 16)).astype(np.float32)
    return hr, np.array([[1, 1, 0], [1, 0, 0]], np.float32)


def _jax_state(sd0, opt):
    v = import_variables("rcan", {k: t.numpy() for k, t in sd0.items()}, CFG)
    return jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                              batch_stats={}, opt_state=opt.init(v["params"]))


def _params_close(model, jparams):
    want = state_dict_from_jax({"params": jax_to_numpy(jparams)}, CFG)
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=k)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------- the trainer, end to end
GROUPS = dict(platform="local", task="synthetic-tiles-48", dataset="synthetic",
              pipeline="sres")
MODEL = "rcan-10-10-64"
TINY = {"dataset.image_size": {"y": 96, "x": 96}, "dataset.ntimes": 4,
        "dataset.nan_fraction": 0.1, "task.tile_size": {"x": 8, "y": 8},
        "task.batch_size": 3, "task.ttsplit": {"train": 0.5, "valid": 0.25, "test": 0.25},
        "task.nepochs": 2, "task.lr": 3e-3, "model.nfeatures": 8, "model.nlayers": 1,
        "model.nblocks": 1, "model.lane_pack": 1, "pipeline.precision": "f32",
        "pipeline.mesh": {"data": 1}}
TCFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=1, cbottleneck=2, kernel_size=3,
            res_scale=1.0, batch_norm=False, bias=True, downscale_factors=[2, 2],
            ups_mode="bicubic", loss_fn="l2", lane_pack=1)
TRAIN_SEED = 11


def _csv(root: Path):
    (path,) = root.glob("processed/*_result_recs/*_losses.csv")
    with open(path, newline="") as f:
        return [row for row in csv.reader(f, delimiter=",", quotechar="|")]


@pytest.fixture(scope="module")
def jax_csv(tmp_path_factory):
    """One JAX trainer run (sres_tpu.trainer.ModelTrainer, as its launcher
    drives it) from the port's seeded initial weights: its loss CSV rows."""
    from sres_tpu.trainer import trainer as jtrainer
    root = tmp_path_factory.mktemp("jax_run")
    sd0 = build_model(TCFG, 1, 1, "f32", seed=TRAIN_SEED, device="cpu").state_dict()

    def init_state(model, optimizer, sample_lr, seed, temporal=None):
        v = import_variables("rcan", {k: t.numpy() for k, t in sd0.items()}, TCFG)
        return jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                  batch_stats={}, opt_state=optimizer.init(v["params"])), False

    jconfig.ConfigContext.set_defaults(**GROUPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_state", init_state)
        with jconfig.ConfigContext("sres", model=MODEL,
                                   **dict(TINY, **{"platform.root": str(root)})) as cc:
            JLogManager.reset()
            tr = jtrainer.ModelTrainer(cc, seed=TRAIN_SEED)
            tr.train(jconfig.cfg().task.nepochs, False, seed=TRAIN_SEED, interp_loss=True)
    JLogManager.reset()
    return _csv(root)


def _launch(root: Path, *extra):
    args = ["--model", MODEL, "--task", GROUPS["task"], "--dataset", "synthetic",
            "--platform", "local", "--seed", str(TRAIN_SEED), f"platform.root={root}",
            "pipeline.device=cpu"]
    args += [f"{k}={v}" for k, v in TINY.items() if k != "pipeline.mesh"]
    return launch(args + list(extra))


def test_launcher_csv_matches_jax_trainer(jax_csv, tmp_path):
    """The port's launcher (WorkflowController.train, pipeline.device=cpu,
    f32) writes the JAX trainer's loss CSV: the same rows (tset, epoch) in
    the same order, losses and baselines within rtol 1e-4 + 2e-6 (the CSV
    keeps 6 decimals; the trajectories differ by f32 summation order), both
    checkpoint slots written."""
    ctl = _launch(tmp_path)
    rows = _csv(tmp_path)
    assert [r[:2] for r in rows] == [r[:2] for r in jax_csv]
    assert [r[0] for r in rows] == ["train"] * 2 + ["valid"] + ["train"] * 2 + ["valid", "test"]
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    want = np.array([[float(x) for x in r[2:]] for r in jax_csv])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-6)
    assert np.isfinite(got).all()
    slots = {p.name.split(".", 1)[1] for p in (tmp_path / "results/checkpoints").iterdir()}
    assert {"train.ckpt", "train.ckpt.backup", "valid.ckpt"} <= slots
    # 2 epochs × 2 train timeslices × 2 batches (4 land-free tiles, batch 3)
    assert ctl.trainer.timers["steps"] == 8 and ctl.trainer.device.type == "cpu"


def _trainer(root, seed, **over):
    tconfig.ConfigContext.set_defaults(**GROUPS)
    ov = {k: v for k, v in TINY.items() if k != "pipeline.mesh"}
    ov.update({"platform.root": str(root), "pipeline.device": "cpu"}, **over)
    return tconfig.ConfigContext("sres", model=MODEL, **ov)


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """A run resumed from the train checkpoint in a new trainer (another
    init seed) continues as the trainer that wrote it: after the load its
    parameters and Adam state are the writer's bit for bit, and a further
    epoch gives the same loss CSV and parameters bit for bit."""
    with _trainer(tmp_path / "a", TRAIN_SEED) as cc:
        a = ModelTrainer(cc, seed=TRAIN_SEED)
        a.train(1, seed=TRAIN_SEED)
        model0 = {k: v.clone() for k, v in a.model.state_dict().items()}
        opt0 = a.optimizer.state_dict()["state"]
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        a.train(1, seed=TRAIN_SEED)
    with _trainer(tmp_path / "b", TRAIN_SEED) as cc:
        b = ModelTrainer(cc, seed=TRAIN_SEED + 1)
        assert not torch.equal(b.model.head[0].weight, model0["head.0.weight"])
        meta = b.checkpoint_manager.load_checkpoint(TSet.Train)
        assert meta["epoch"] == 1 and meta["itime"] == 1
        assert all(torch.equal(v, model0[k]) for k, v in b.model.state_dict().items())
        for i, st in b.optimizer.state_dict()["state"].items():
            assert all(torch.equal(st[k], opt0[i][k]) for k in st)
        b.train(1, seed=TRAIN_SEED)
    assert _csv(tmp_path / "b") == _csv(tmp_path / "a")
    assert all(torch.equal(v, a.model.state_dict()[k]) for k, v in b.model.state_dict().items())


def test_checkpoint_slots_backup_and_a_corrupt_primary(tmp_path):
    """Each save keeps the file it replaces as ``.backup``; a primary that
    does not read falls back to the backup, whose tensors come back bit for
    bit; the metadata reads without the tensors."""
    from sres_tpu_torch.trainer.checkpoints import read_checkpoint
    with _trainer(tmp_path, TRAIN_SEED, **{"pipeline.async_checkpoint": False}) as cc:
        tr = ModelTrainer(cc, seed=TRAIN_SEED)
        cm = tr.checkpoint_manager
        first = {k: v.clone() for k, v in tr.model.state_dict().items()}
        cm.save_checkpoint(1, 0, TSet.Train, 0.5, 0.25)
        with torch.no_grad():
            for p in tr.model.parameters():
                p.add_(1.0)
        cm.save_checkpoint(1, 1, TSet.Train, 0.4, 0.25)
        path = cm.checkpoint_path(TSet.Train)
        assert read_checkpoint(path, tensors=False) == {"epoch": 1, "itime": 1, "loss": 0.4,
                                                        "interp_loss": 0.25}
        with open(path, "r+b") as f:
            f.write(b"garbage")
        assert cm.load_checkpoint(TSet.Train)["itime"] == 0
        assert all(torch.equal(v, first[k]) for k, v in tr.model.state_dict().items())


def test_staging_modes_and_their_exclusivity(tmp_path):
    """``pipeline.grad_accum`` and ``pipeline.steps_per_dispatch`` are
    exclusive (trainer.py:137); with K = 3 over 4 batches a timeslice,
    steps_per_dispatch trains the per-batch trajectory (bit for bit on the
    CPU; the fourth batch a step of its own) and grad_accum takes 2 updates
    a timeslice (the ragged tail padded with two zero-weight micro-batches),
    with finite losses."""
    with _trainer(tmp_path / "x", TRAIN_SEED, **{"pipeline.grad_accum": 3,
                                                 "pipeline.steps_per_dispatch": 3}) as cc:
        with pytest.raises(AssertionError, match="exclusive"):
            ModelTrainer(cc, seed=TRAIN_SEED)
    rows, steps = {}, {}
    for name, over in (("one", {}), ("multi", {"pipeline.steps_per_dispatch": 3}),
                       ("accum", {"pipeline.grad_accum": 3})):
        with _trainer(tmp_path / name, TRAIN_SEED, **{"task.ttsplit": {"train": 0.5},
                                                       "task.batch_size": 1, **over}) as cc:
            tr = ModelTrainer(cc, seed=TRAIN_SEED)
            tr.train(1, seed=TRAIN_SEED)
            rows[name] = _csv(tmp_path / name)
            steps[name] = {int(s["step"]) for st in [tr.optimizer.state_dict()["state"]]
                           for s in st.values()}
    assert rows["multi"] == rows["one"]
    assert steps == {"one": {8}, "multi": {8}, "accum": {4}}
    assert all(np.isfinite(float(r[2])) for r in rows["accum"])


# ------------------------------------------------------ the step variants
@pytest.mark.parametrize("kind", ["multi", "accum"])
def test_step_variants_match_jax(kind):
    """``build_multi_train_step`` (K Adam steps) and
    ``build_accum_train_step`` (one update from K micro-batches) against
    the JAX builders (step.py:202, :239) from the same weights: the (K,)
    metrics within rtol 1e-5, the parameters within tests/test_torch_train.
    py's bar (rtol 5e-4, atol 5e-6)."""
    sd0 = build_model(CFG, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    jopt = optax.adam(TASK["lr"])
    jbuild = {"multi": jstep.build_multi_train_step,
              "accum": jstep.build_accum_train_step}[kind]
    jmodel = jax_build_model(dict(CFG), 1, 1, precision="f32")
    jsc = jstep.make_step_config(_Cfg(TASK), _Cfg(CFG), has_bn=False)
    hr, w = _stack()
    jstate, jmet = jbuild(jmodel, jopt, jsc)(_jax_state(sd0, jopt), jnp.asarray(hr),
                                             jnp.asarray(w))
    model = build_model(CFG, 1, 1, "f32", device="cpu")
    model.load_state_dict(sd0)
    tbuild = {"multi": tstep.build_multi_train_step,
              "accum": tstep.build_accum_train_step}[kind]
    met = tbuild(model, tstep.build_optimizer(model, TASK),
                 tstep.make_step_config(TASK, CFG))(torch.from_numpy(hr), torch.from_numpy(w))
    assert set(met) == set(jmet) == {"mloss", "sloss", "interp_sloss"}
    for k in met:
        assert met[k].shape == (K,) and met[k].dtype == torch.float32
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-5, err_msg=k)
    _params_close(model, jstate.params)


def _fresh(sd0):
    model = build_model(CFG, 1, 1, "f32", device="cpu")
    model.load_state_dict(sd0)
    return model, tstep.build_optimizer(model, TASK)


def test_accum_invariants():
    """(a) K identical micro-batches reproduce the single step (the bar of
    tests/test_multi_step.py:83: loss rtol 1e-6, parameters rtol 2e-5,
    atol 2e-6); (b) an all-padding micro-batch is inert and finite: [hr,
    junk at weight 0] gives [hr] alone's update bit for bit; (c) the
    multi step is the single steps in order, bit for bit."""
    sd0 = build_model(CFG, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    sc = tstep.make_step_config(TASK, CFG)
    hr, w = (torch.from_numpy(a) for a in _stack())
    w1 = torch.ones(3)
    single, opt = _fresh(sd0)
    m1 = tstep.build_train_step(single, opt, sc)(hr[0], w1)
    accum, opt = _fresh(sd0)
    m2 = tstep.build_accum_train_step(accum, opt, sc)(torch.stack([hr[0]] * 3),
                                                      torch.stack([w1] * 3))
    np.testing.assert_allclose(float(m2["mloss"][0]), float(m1["mloss"]), rtol=1e-6)
    for (k, a), b in zip(single.state_dict().items(), accum.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6, err_msg=k)

    junk = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 1, 16, 16))
                            .astype(np.float32))
    runs = []
    for stack, ws in (((hr[0], junk), (w1, torch.zeros(3))), ((hr[0],), (w1,))):
        model, opt = _fresh(sd0)
        met = tstep.build_accum_train_step(model, opt, sc)(torch.stack(stack), torch.stack(ws))
        runs.append((met, model.state_dict()))
    assert not torch.isfinite(runs[0][0]["mloss"][1]) or float(runs[0][0]["mloss"][1]) == 0.0
    for k, a in runs[0][1].items():
        assert torch.isfinite(a).all() and torch.equal(a, runs[1][1][k]), k

    multi, opt = _fresh(sd0)
    mm = tstep.build_multi_train_step(multi, opt, sc)(hr, torch.from_numpy(_stack()[1]))
    seq, opt = _fresh(sd0)
    step = tstep.build_train_step(seq, opt, sc)
    for i in range(K):
        ms = step(hr[i], torch.from_numpy(_stack()[1][i]))
        assert all(torch.equal(mm[k][i], ms[k]) for k in ms)
    assert all(torch.equal(a, b) for a, b in zip(multi.state_dict().values(),
                                                 seq.state_dict().values()))


def test_constant_matrices_stay_on_the_device():
    """The resize matrices and the Winograd G are made once per device:
    the second call reuses the cached tensor, whose values are the host
    matrix's bits, and a matrix made under inference mode serves
    training."""
    with torch.inference_mode():
        a = tresize.device_matrix(20, 5, "bicubic", 0.25, torch.device("cpu"))
    b = tresize.device_matrix(20, 5, "bicubic", 0.25, torch.device("cpu"))
    assert a is b and not a.is_inference()
    assert a.numpy().tobytes() == tresize.resize_matrix(20, 5, "bicubic", 0.25).tobytes()
    x = torch.randn(2, 1, 20, 20)
    want = (torch.from_numpy(tresize.resize_matrix(20, 5, "bicubic", 0.25)) @ x
            @ torch.from_numpy(tresize.resize_matrix(20, 5, "bicubic", 0.25)).T)
    assert torch.equal(tresize.downsample(x, 4.0), want)
    with torch.inference_mode():
        g = twino.device_g(4, torch.device("cpu"))
    assert g is twino.device_g(4, torch.device("cpu")) and not g.is_inference()
    assert g.dtype == torch.float64 and g.numpy().tobytes() == twino.MATS[4][1].tobytes()
