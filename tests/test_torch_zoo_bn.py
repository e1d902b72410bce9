"""The port's BatchNorm and pyramid models, SRDN, UNet (also with 4
temporal features), LapSRN and MSCNN, against ``sres_tpu`` on the CPU, on
tiny seeded models (tests/torch_zoo_common.py): the f32 forward on every
pyramid level, the weight export, three Adam steps with their running
statistics and the eval forward after them; the padding-aware BatchNorm
against ``sres_tpu``'s ``bn_sample_weight``, an all-padding batch included;
and a tiny UNet epoch (temporal features, a ragged last batch) and a tiny
LapSRN epoch through the port's launcher against the JAX trainer's loss
CSV."""
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu import config as jconfig
from sres_tpu.models import build_model as jax_build_model
from sres_tpu.models.layers import bn_sample_weight as jax_bn_sample_weight
from sres_tpu.trainer import step as jstep
from sres_tpu.util.logging import LogManager as JLogManager
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch import config as tconfig
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.layers import BatchNorm, bn_sample_weight
from sres_tpu_torch.train import main as launch
from sres_tpu_torch.trainer.checkpoints import read_checkpoint
from sres_tpu_torch.util.weights import state_dict_from_jax
from torch_zoo_common import CFGS, check_export, check_forward, check_trajectory

CASES = ["srdn", "unet", "unet-temporal", "lapsrn", "mscnn"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", CASES)
def test_export_matches_jax_exporter(case):
    check_export(case)


@pytest.mark.parametrize("case", CASES)
def test_adam_trajectory_matches_optax(case):
    check_trajectory(case)


def test_batch_norm_is_torch_batch_norm_when_every_weight_is_one():
    """Training mode, all weights 1 (and no scope): F.batch_norm's output
    and running statistics (momentum 0.5), within f32 rounding."""
    x = torch.from_numpy(np.random.default_rng(3).normal(2.0, 3.0, (5, 6, 7, 9))
                         .astype(np.float32))
    ours, ref = BatchNorm(6, momentum=0.5).train(), torch.nn.BatchNorm2d(6, momentum=0.5)
    with torch.no_grad():
        ours.weight.uniform_(0.5, 1.5)
        ours.bias.uniform_(-1, 1)
    ref.load_state_dict(ours.state_dict())
    for scope in (None, torch.ones(5)):
        with bn_sample_weight(scope):
            y = ours(x)
        torch.testing.assert_close(y, ref(x), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ours.running_mean, ref.running_mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(ours.running_var, ref.running_var, rtol=1e-5, atol=1e-6)
    assert int(ours.num_batches_tracked) == int(ref.num_batches_tracked) == 2


@pytest.mark.parametrize("arch", ["srdn", "unet"])
def test_padded_batch_statistics_match_jax(arch):
    """3 valid tiles and 5 zero-weight padding tiles, train mode: the valid
    tiles' outputs and the running statistics are sres_tpu's under its
    ``bn_sample_weight`` (and torch's on the 3 tiles alone); a batch of
    padding only gives finite outputs and leaves the statistics as they
    were, on both sides."""
    cfg = CFGS[arch]
    model = build_model(cfg, 1, 1, "f32", seed=9, device="cpu").train()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    variables = import_variables(arch, {k: v.numpy() for k, v in sd0.items()}, cfg)
    jmodel = jax_build_model(cfg, 1, 1, precision="f32")
    x = np.random.default_rng(5).normal(size=(3, 1, 12, 12)).astype(np.float32)
    xp = np.concatenate([x, np.zeros((5, 1, 12, 12), np.float32)])
    w = np.array([1.0] * 3 + [0.0] * 5, np.float32)
    with jax_bn_sample_weight(jnp.asarray(w)):
        yj, mut = jmodel.apply(variables, jnp.asarray(xp.transpose(0, 2, 3, 1)), train=True,
                               mutable=["batch_stats"])
    with torch.no_grad(), bn_sample_weight(torch.from_numpy(w)):
        yt = model(torch.from_numpy(xp))
    np.testing.assert_allclose(yt[:3].numpy(), np.asarray(yj)[:3].transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": mut["batch_stats"]}, cfg)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    alone = build_model(cfg, 1, 1, "f32", device="cpu").train()
    alone.load_state_dict(sd0)
    with torch.no_grad():
        torch.testing.assert_close(alone(torch.from_numpy(x)), yt[:3], rtol=1e-5, atol=1e-5)
    for k in stats:
        torch.testing.assert_close(alone.state_dict()[k], got[k], rtol=1e-5, atol=1e-6)

    # all padding: finite, the statistics untouched (JAX's too)
    after = {k: got[k].clone() for k in stats}
    w0 = np.zeros(8, np.float32)
    with torch.no_grad(), bn_sample_weight(torch.from_numpy(w0)):
        y0 = model(torch.zeros(8, 1, 12, 12))
    assert torch.isfinite(y0).all()
    assert all(torch.equal(model.state_dict()[k], after[k]) for k in stats)
    with jax_bn_sample_weight(jnp.asarray(w0)):
        yj0, mut0 = jmodel.apply({"params": variables["params"],
                                  "batch_stats": mut["batch_stats"]},
                                 jnp.zeros((8, 12, 12, 1)), train=True, mutable=["batch_stats"])
    assert np.isfinite(np.asarray(yj0)).all()
    for a, b in zip(jax.tree_util.tree_leaves(mut0["batch_stats"]),
                    jax.tree_util.tree_leaves(mut["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------- through the launcher
GROUPS = dict(platform="local", task="synthetic-tiles-48", dataset="synthetic",
              pipeline="sres")
TINY = {"dataset.image_size": {"y": 96, "x": 96}, "dataset.ntimes": 4,
        "dataset.nan_fraction": 0.1, "task.tile_size": {"x": 8, "y": 8},
        "task.batch_size": 3, "task.ttsplit": {"train": 0.5, "valid": 0.25, "test": 0.25},
        "task.nepochs": 1, "task.lr": 3e-3, "model.nfeatures": 8,
        "pipeline.precision": "f32"}
EPOCHS = {
    # unet.yaml keeps use_temporal_features: the synthetic times give 4 rows
    "unet": ({"model.nlayers": 2},
             dict(name="unet", nfeatures=8, nlayers=2, loss_fn="l2", downscale_factors=[2, 2],
                  ups_mode="bicubic", use_temporal_features=True), 4),
    "lapsrn": ({}, dict(name="lapsrn", nfeatures=8, loss_fn="l2", multiscale_loss=True,
                        downscale_factors=[2, 2], ups_mode="bicubic"), None),
}
TRAIN_SEED = 11


def _csv(root: Path):
    (path,) = root.glob("processed/*_result_recs/*_losses.csv")
    with open(path, newline="") as f:
        return [row for row in csv.reader(f, delimiter=",", quotechar="|")]


def _jax_csv(root: Path, model: str, over: dict, cfg: dict, ntf):
    """One JAX trainer epoch (sres_tpu.trainer.ModelTrainer, as its
    launcher drives it) from the port's seeded initial weights."""
    from sres_tpu.trainer import trainer as jtrainer
    sd0 = build_model(cfg, 1, 1, "f32", seed=TRAIN_SEED, device="cpu",
                      temporal_features=ntf).state_dict()

    def init_state(jmodel, optimizer, sample_lr, seed, temporal=None):
        assert (temporal is None) == (ntf is None)
        v = import_variables(model, {k: t.numpy() for k, t in sd0.items()}, cfg)
        return jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  opt_state=optimizer.init(v["params"])), True

    jconfig.ConfigContext.set_defaults(**GROUPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_state", init_state)
        with jconfig.ConfigContext("sres", model=model, **TINY, **over,
                                   **{"platform.root": str(root),
                                      "pipeline.mesh": {"data": 1}}) as cc:
            JLogManager.reset()
            tr = jtrainer.ModelTrainer(cc, seed=TRAIN_SEED)
            tr.train(1, False, seed=TRAIN_SEED, interp_loss=True)
    JLogManager.reset()
    return _csv(root)


@pytest.mark.parametrize("model", sorted(EPOCHS))
def test_launcher_epoch_matches_jax_trainer(model, tmp_path):
    """A tiny epoch through ``python -m sres_tpu_torch.train``'s main
    (pipeline.device=cpu, f32; 4 land-free tiles a timeslice at batch 3, so
    the second batch holds 1 valid tile of 3) writes the JAX trainer's loss
    CSV: the same rows, losses within rtol 1e-4 + 2e-6. The UNet takes each
    timeslice's temporal row and runs its padding-aware BatchNorm; LapSRN
    trains on the pyramid loss. The checkpoint carries the BN buffers: a
    model restored from the train slot has the trained model's bit for
    bit. Its checkpoint serves through ``infer_region``; the whole-region
    mode refuses both models."""
    over, cfg, ntf = EPOCHS[model]
    want = _jax_csv(tmp_path / "jax", model, over, cfg, ntf)
    args = ["--model", model, "--task", GROUPS["task"], "--dataset", "synthetic",
            "--platform", "local", "--seed", str(TRAIN_SEED),
            f"platform.root={tmp_path / 'port'}", "pipeline.device=cpu"]
    ctl = launch(args + [f"{k}={v}" for k, v in {**TINY, **over}.items()])
    rows = _csv(tmp_path / "port")
    assert [r[:2] for r in rows] == [r[:2] for r in want]
    assert [r[0] for r in rows] == ["train", "train", "valid", "test"]
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    np.testing.assert_allclose(got, np.array([[float(x) for x in r[2:]] for r in want]),
                               rtol=1e-4, atol=2e-6)
    tr = ctl.trainer
    assert tr.step_config.has_bn and tr.step_config.ntemporal == (ntf or 0)
    restored = build_model(cfg, 1, 1, "f32", device="cpu", temporal_features=ntf)
    tr.checkpoint_manager.flush()
    (path,) = (tmp_path / "port/results/checkpoints").glob("*.train.ckpt")
    restored.load_state_dict(read_checkpoint(str(path))["model"], strict=True)
    trained = tr.model.state_dict()
    buffers = [k for k in trained if "running_" in k or "num_batches" in k]
    assert buffers and all(torch.equal(restored.state_dict()[k], trained[k]) for k in buffers)

    # served: infer_region takes the final level and the timeslice's
    # temporal row; the whole-region mode refuses pyramid and temporal
    # models, as sres_tpu's fails on them
    tconfig.ConfigContext.set_defaults(**GROUPS)
    with tconfig.ConfigContext("sres", model=model, **TINY, **over, **{
            "platform.root": str(tmp_path / "port"), "pipeline.device": "cpu"}):
        cv = tr.data_timestamps[TSet.Validation][0]
        panels = tr.infer_region(cv, update_model=True)["SST"]
        finite = np.isfinite(panels["target"].data)
        assert finite.any() and np.isfinite(panels["model"].data[finite]).all()
        with pytest.raises(NotImplementedError, match="pyramid or temporal"):
            tr.infer_region_spatial(cv)
