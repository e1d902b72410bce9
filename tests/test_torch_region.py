"""The port's serving — ``process_image``, ``infer_region`` (one padded batch
of every grid slot, assembled on the device), ``infer_region_stream``,
``infer_region_seamless``, ``infer_region_spatial``, the NetCDF artifacts of
``WorkflowController.inference`` and the ``python -m sres_tpu_torch.infer``
launcher — against ``sres_tpu`` on the CPU.

One JAX ``ModelTrainer`` and one port trainer share a tiny f32 EDSR (8
features, 1 ResBlock, the direct path: no Pallas kernel runs), its weights
the port's seeded init carried across with ``import_variables``; both sides
serve with ``update_model=False`` (or with no checkpoint to load), so they
serve the same weights. Every panel is held within 2e-5·max|panel|, with
the NaN holes in the same places.

Region heights are multiples of 32: JAX's spatial mode pads H to a multiple
of its mesh size (8 CPU devices, tests/conftest.py) times the scale, the
port's to a multiple of the scale, and neither may pad for the panels to
match. JAX pads the region batch to a multiple of 8; its pads go to the
trash slot and change no value.

Two checks are the port's own: target ⊂ input gives the raw target back in
every image mode, the tiled ones included (``sres_tpu`` denormalizes those
with every input channel's stats, ROADMAP Queue 3), and serving, then
training, gives the weights of a trainer that never served.
"""
import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from sres_tpu import config as jconfig
from sres_tpu.controller import WorkflowController as JController
from sres_tpu.data.inference_io import TSet as JTSet
from sres_tpu.data.inference_io import ResultStructure as JStructure
from sres_tpu.data.inference_io import results_path as jresults_path
from sres_tpu.trainer import step as jstep
from sres_tpu.trainer import trainer as jtrainer
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch import config as tconfig
from sres_tpu_torch.controller import ResultStructure, TSet, WorkflowController
from sres_tpu_torch.data.inference_io import results_path
from sres_tpu_torch.infer import main as infer_main
from sres_tpu_torch.ops.assemble import assemble_tiles
from sres_tpu_torch.trainer.trainer import ModelTrainer

GROUPS = dict(task="synthetic-tiles-48", dataset="synthetic", pipeline="sres",
              platform="local")
MODEL = "edsr"
BASE = {"dataset.image_size": {"y": 192, "x": 144}, "dataset.ntimes": 4,
        "dataset.nan_fraction": 0.15, "task.tile_size": {"x": 12, "y": 12},
        "task.batch_size": 4, "task.xyflip": False,
        "task.ttsplit": {"train": 0.5, "valid": 0.25, "test": 0.25},
        "model.nfeatures": 8, "model.nlayers": 1, "model.lane_pack": 1,
        "pipeline.precision": "f32", "pipeline.device": "cpu"}
TWO_VARS = {"task.input_variables": {"SSS": "sea_surface_salinity",
                                     "SST": "sea_surface_temperature"}}
SETUPS = {"lnorm": {},
          "tnorm_2var": dict(TWO_VARS, **{"task.target_variables": ["SSS", "SST"],
                                          "task.norm": "tnorm"})}
SEED = 5
REL_TOL = 2e-5


@contextlib.contextmanager
def active(pkg, over):
    """``pkg``'s config (the JAX package's or the port's) active for a call:
    tests/conftest.py deactivates the JAX one around every test."""
    pkg.ConfigContext.set_defaults(**GROUPS)
    cc = pkg.ConfigContext("sres", model=MODEL, **over)
    cc.activate()
    try:
        yield cc
    finally:
        pkg.ConfigContext.deactivate()


class Pair:
    """A JAX trainer and a port trainer on the same config and weights."""

    def __init__(self, root, extra):
        self.jover = dict(BASE, **extra, **{"platform.root": str(root / "jax")})
        self.tover = dict(BASE, **extra, **{"platform.root": str(root / "port")})
        with active(tconfig, self.tover) as cc:
            self.port = ModelTrainer(cc, seed=SEED)
            mcfg = tconfig.cfg().model.to_dict()
        sd = {k: t.numpy() for k, t in self.port.model.state_dict().items()}

        def init_state(model, optimizer, sample_lr, seed, temporal=None):
            v = import_variables("edsr", sd, mcfg)
            return jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                      batch_stats={},
                                      opt_state=optimizer.init(v["params"])), False

        with pytest.MonkeyPatch.context() as mp, active(jconfig, self.jover) as cc:
            mp.setattr(jtrainer, "init_state", init_state)
            self.jax = jtrainer.ModelTrainer(cc, seed=SEED)

    def both(self, jfn, tfn):
        with active(jconfig, self.jover):
            want = jfn(self.jax)
        with active(tconfig, self.tover):
            got = tfn(self.port)
        return got, want


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = Pair(tmp_path_factory.mktemp(name), SETUPS[name])
        return made[name]
    return get


def close(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    fin = np.isfinite(w)
    assert fin.any(), what
    err, tol = np.abs(g[fin] - w[fin]).max(), REL_TOL * np.abs(w[fin]).max()
    assert err <= tol, f"{what}: {err} > {tol}"


def close_images(got, want, what):
    assert set(got) == set(want), what
    for var in want:
        assert set(got[var]) == set(want[var]), (what, var)
        for panel, arr in want[var].items():
            close(got[var][panel].data, arr.data, f"{what}/{var}/{panel}")


def test_assemble_tiles_scatters_with_nan_holes_and_trash_padding():
    """Tiles land at their grid slot, missing slots are NaN, and padding
    (weight 0, whatever id it carries) is dropped."""
    tiles = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
    ids = torch.tensor([5, 0, 3, 0])
    img = assemble_tiles(tiles, ids, {"y": 2, "x": 3}, torch.tensor([1.0, 1.0, 1.0, 0.0]))
    want = np.full((4, 9), np.nan, np.float32)
    for t, sid in zip(tiles[:3].numpy(), (5, 0, 3)):
        want[2 * (sid // 3):2 * (sid // 3) + 2, 3 * (sid % 3):3 * (sid % 3) + 3] = t
    np.testing.assert_array_equal(img.numpy(), want)


def test_process_image_matches_jax(pairs):
    p = pairs("lnorm")
    (got, gl), (want, wl) = p.both(
        lambda tr: tr.process_image(JTSet.Validation, 0, update_model=False),
        lambda tr: tr.process_image(TSet.Validation, 0, update_model=False))
    close_images(got, want, "process_image")
    assert got["SST"]["model"].shape == (192, 144)
    assert np.isnan(got["SST"]["model"].data).any()
    for k in ("model", "interpolated"):
        np.testing.assert_allclose(gl["SST"][k], wl["SST"][k], rtol=1e-5)


@pytest.mark.parametrize("mode", ["region", "stream", "stream_overlap", "stream_inline"])
def test_infer_region_matches_jax(pairs, mode):
    """infer_region at one timeslice; the stream over every timeslice (one
    prep thread, 2 ahead), with overlap_fetch (1 ahead), and with no prep
    thread (prefetch=0; JAX's least is 1)."""
    p = pairs("lnorm")
    if mode == "region":
        got, want = p.both(lambda tr: [(1, tr.infer_region(1))],
                           lambda tr: [(1, tr.infer_region(1))])
    else:
        kw = dict(stream=dict(prefetch=2), stream_overlap=dict(prefetch=1, overlap_fetch=True),
                  stream_inline=dict(prefetch=0))[mode]
        jkw = dict(kw, prefetch=max(1, kw["prefetch"]))
        got, want = p.both(lambda tr: list(tr.infer_region_stream(range(4), **jkw)),
                           lambda tr: list(tr.infer_region_stream(range(4), **kw)))
    assert [t for t, _ in got] == [t for t, _ in want]
    for (t, g), (_, w) in zip(got, want):
        close_images(g, w, f"{mode} t={t}")
        assert g["SST"]["input"].shape == (48, 36)


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("mode", ["seamless", "spatial"])
def test_region_modes_match_jax(pairs, setup, mode):
    """Seamless (margin 8) and whole-region inference, lnorm on SST, and
    tnorm on SSS + SST (the per-pixel stats maps of the spatial mode)."""
    p = pairs(setup)
    fn = {"seamless": lambda tr: tr.infer_region_seamless(2, margin=8, update_model=False),
          "spatial": lambda tr: tr.infer_region_spatial(2, update_model=False)}[mode]
    got, want = p.both(fn, fn)
    close_images(got, want, f"{mode}/{setup}")


def _nc(path):
    with netcdf_file(path, "r", mmap=False) as f:
        dims = dict(f.dimensions)
        vars_ = {k: (v.dimensions, np.array(v[:])) for k, v in f.variables.items()}
        return dims, vars_, f.loss_keys, np.array(f.loss_values)


def test_workflow_inference_netcdf_matches_jax(pairs):
    """WorkflowController.inference(…, save=True), Tiles at timestep 0 and
    Image at 0, on both packages (no checkpoint in either root, so both
    serve the weights they hold): the NetCDF files agree dimension by
    dimension and variable by variable."""
    p = pairs("lnorm")

    def run(ctl_cls, structure, trainer, rpath):
        ctl = ctl_cls("sres", GROUPS, seed=SEED)
        ctl.trainer = trainer
        paths = []
        for s in ("Tiles", "Image"):
            ctl.inference(0, getattr(structure, s), save=True)
            paths.append(rpath("SST", 0, getattr(structure, s)))
        return paths

    got, want = p.both(lambda tr: run(JController, JStructure, tr, jresults_path),
                       lambda tr: run(WorkflowController, ResultStructure, tr, results_path))
    for g, w in zip(got, want):
        gd, gv, gk, gl = _nc(g)
        wd, wv, wk, wl = _nc(w)
        assert gd == wd and gk == wk and set(gv) == set(wv), g
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        for name, (dims, data) in wv.items():
            assert gv[name][0] == dims, (g, name)
            close(gv[name][1], data, f"{g}:{name}")


def _raw_target(tr, ctime, var):
    region = tr.dataset.load_region_data(ctime)
    grid = tr.dataset.tile_grid
    ishape = dict(c=region.shape[0], y=region.shape[1], x=region.shape[2])
    roi = grid.get_active_region(image_shape=ishape)
    raw = region.data[tr.input_variables.index(var), roi["y"][0]:roi["y"][1],
                      roi["x"][0]:roi["x"][1]]
    # a tile is served when every channel of it is finite
    ts = grid.get_full_tile_size()
    gs = grid.get_grid_shape(image_shape=ishape)
    act = region.data[:, roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]
    ok = np.isfinite(act.reshape(act.shape[0], gs["y"], ts["y"], gs["x"], ts["x"])
                     ).all(axis=(0, 2, 4))
    tile_mask = np.repeat(np.repeat(~ok, ts["y"], 0), ts["x"], 1)
    return raw, tile_mask


def test_target_subset_round_trips_in_every_mode(tmp_path):
    """Input [SSS, SST], target [SST]: every image mode's target panel is
    the raw SST region (rtol 2e-4, as tests/test_workflow.py holds the
    seamless and spatial modes), with NaN holes on the dropped tiles (on
    the land itself in the spatial mode); the interpolated and model
    panels carry SST's scale, not SSS's (35 against 15)."""
    over = dict(BASE, **TWO_VARS, **{"task.target_variables": ["SST"],
                                     "platform.root": str(tmp_path)})
    with active(tconfig, over) as cc:
        tr = ModelTrainer(cc, seed=SEED)
        tr.init_data_timestamps()
        ct0 = tr.data_timestamps[TSet.Train][0]
        runs = {"tiled": (ct0, tr.process_image(TSet.Validation, 0, update_model=False)[0]),
                "region": (1, tr.infer_region(1)),
                "stream": list(tr.infer_region_stream([2], prefetch=0))[0],
                "seamless": (1, tr.infer_region_seamless(1, margin=8)),
                "spatial": (1, tr.infer_region_spatial(1))}
        for mode, (ctime, images) in runs.items():
            assert list(images) == ["SST"], mode
            raw, tile_mask = _raw_target(tr, ctime, "SST")
            tgt = images["SST"]["target"].data
            holes = ~np.isfinite(raw) if mode == "spatial" else tile_mask
            np.testing.assert_array_equal(np.isnan(tgt), holes, err_msg=mode)
            np.testing.assert_allclose(tgt[~holes], raw[~holes], rtol=2e-4, atol=2e-4,
                                       err_msg=mode)
            for k in ("model", "interpolated"):
                assert np.array_equal(np.isnan(images["SST"][k].data), holes), (mode, k)
                assert abs(np.nanmean(images["SST"][k].data) - np.nanmean(raw)) < 5.0, (mode, k)
            assert abs(np.nanmean(images["SST"]["input"].data) - np.nanmean(raw)) < 5.0, mode


def test_served_tiles_are_not_flipped(tmp_path):
    """With the task's xyflip on, inference(…, Tiles) serves each tile as
    it lies (its lnorm'd raw values), on every call: JAX's evaluate flips
    them at random there."""
    over = dict(BASE, **{"task.xyflip": True, "platform.root": str(tmp_path)})
    with active(tconfig, over) as cc:
        ctl = WorkflowController("sres", GROUPS, seed=SEED)
        ctl.trainer = ModelTrainer(cc, seed=SEED)
        ctl.trainer.init_data_timestamps()
        raw = ctl.trainer.dataset.load_timeslice(
            ctl.trainer.data_timestamps[TSet.Validation][0]).data[:, 0].astype(np.float64)
        want = (raw - raw.mean(axis=(1, 2), keepdims=True)) / raw.std(axis=(1, 2), keepdims=True)
        for _ in range(2):
            got = ctl.inference(0, ResultStructure.Tiles, save=False)[0]["SST"]["target"]
            np.testing.assert_allclose(got.data, want, rtol=1e-5, atol=1e-5)


def _serve_all(tr):
    tr.infer_region(1)
    list(tr.infer_region_stream([2, 3], prefetch=1, overlap_fetch=True))
    tr.infer_region_seamless(1, margin=8)
    tr.infer_region_spatial(1)
    tr.process_image(TSet.Validation, 0, update_model=False)


def test_serve_then_train_matches_a_trainer_that_never_served(tmp_path):
    """A Winograd EDSR (m = 4; on the CPU the plain twins with their cached
    U) serves in every mode, then trains an epoch: its weights equal those
    of a trainer built alike that only trained."""
    weights = []
    for served in (True, False):
        over = dict(BASE, **{"model.winograd": 4, "task.lr": 3e-3,
                             "platform.root": str(tmp_path / str(served))})
        with active(tconfig, over) as cc:
            tr = ModelTrainer(cc, seed=SEED)
            if served:
                _serve_all(tr)
            tr.train(2, refresh_state=True, seed=SEED)
            assert tr.timers["steps"] > 0
            weights.append({k: v.clone() for k, v in tr.model.state_dict().items()})
    for k, v in weights[0].items():
        assert torch.equal(v, weights[1][k]), k


def test_infer_launcher_writes_the_jax_launchers_files(tmp_path, monkeypatch):
    """python -m sres_tpu_torch.infer at scripts/inference/inference-
    synthetic.py's model (EDSR, 4 layers, 32 features), cut to a 192×192
    region of 48-pixel tiles (20 timesteps, so that validation holds
    timesteps 0 and 1), on the CPU: the files that script's sequence
    writes, Tiles at 0 and 1 and Image at 0, and nothing else."""
    monkeypatch.setattr(sys, "argv", ["infer"])
    args = ["--model", "edsr", "--task", "synthetic-tiles-48", "--dataset", "synthetic",
            "--platform", "local", "--seed", "3", f"platform.root={tmp_path}",
            "pipeline.device=cpu", "pipeline.precision=f32", "model.nlayers=4",
            "model.nfeatures=32", "dataset.image_size={y: 192, x: 192}",
            "dataset.ntimes=20", "task.tile_size={x: 12, y: 12}"]
    try:
        infer_main(args)
        out = tmp_path / "results/inference/synthetic/synthetic-tiles-48"
        assert sorted(p.name for p in out.iterdir()) == \
            ["SST-0.image.nc", "SST-0.tiles.nc", "SST-1.tiles.nc"]
        dims, vars_, _, _ = _nc(out / "SST-0.image.nc")
        assert dims == {"y": 192, "x": 192, "ys": 48, "xs": 48}
        assert set(vars_) == {"input", "target", "model", "interpolated"}
    finally:
        tconfig.ConfigContext.deactivate()


def test_infer_launcher_asks_for_the_card(tmp_path):
    """Without pipeline.device=cpu the launcher asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            infer_main(["--model", "edsr", "--task", "synthetic-tiles-48", "--dataset",
                        "synthetic", "--platform", "local", f"platform.root={tmp_path}"])
    finally:
        tconfig.ConfigContext.deactivate()
