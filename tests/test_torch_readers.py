"""The port's readers of the repo's real data formats against ``sres_tpu`` on
the CPU, on fixtures written here from seeds: the compiled SWOT decoder
(``sres_tpu_torch.native``) and its numpy twin against ``sres_tpu.native``,
the LLC grid's panels, ``write_swot_fixture``'s files, the SWOT reader
(``data/swot.py``: time indices, regions, tiles, batches with their norm
stats, lnorm and tnorm, with and without a ROI), the LLC4320 Cape Basin
reader (``data/s3export.py``: time-domain batches, the domain, the scaling),
one tiny epoch of the two-variable SWOT task and of ``cape_basin_1x1``
through the port's launcher against the JAX trainer's loss CSV (from the
same initial weights), the SWOT task's regions served with each variable's
own stats, and the zarr export against ``sres_tpu``'s.
"""
import contextlib
import csv
import filecmp
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu import config as jconfig
from sres_tpu import native as jnative
from sres_tpu.data import swot as jswot
from sres_tpu.data.s3export import S3ExportDataLoader as JS3
from sres_tpu.data.synthetic import write_swot_fixture as jwrite_swot_fixture
from sres_tpu.trainer import step as jstep
from sres_tpu.trainer import trainer as jtrainer
from sres_tpu.util.logging import LogManager as JLogManager
from sres_tpu.util.torch_import import import_variables
from sres_tpu.util.zarrlite import read_zarr as jread_zarr
from sres_tpu_torch import config as tconfig
from sres_tpu_torch import native
from sres_tpu_torch.controller import TSet, WorkflowController
from sres_tpu_torch.data import swot
from sres_tpu_torch.data.batch import get_loader
from sres_tpu_torch.data.s3export import S3ExportDataLoader
from sres_tpu_torch.data.synthetic import write_swot_fixture
from sres_tpu_torch.models import build_model
from sres_tpu_torch.to_zarr import main as to_zarr_main
from sres_tpu_torch.train import main as launch
from sres_tpu_torch.util.zarrlite import read_zarr

NX, NTIMES = 16, 3
SEED = 11
TINY_MODEL = {"model.nfeatures": 8, "model.nlayers": 1, "model.nblocks": 1,
              "model.lane_pack": 1, "pipeline.precision": "f32"}
TCFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=1, cbottleneck=2, kernel_size=3,
            res_scale=1.0, batch_norm=False, bias=True, downscale_factors=[2, 2],
            ups_mode="bicubic", loss_fn="l2", lane_pack=1)
# 4-pixel LR tiles: 16-pixel HR tiles on the 48×64 panel of NX = 16
SWOT_TASK = {"task.tile_size": {"x": 4, "y": 4}, "task.batch_size": 4,
             "task.ttsplit": {"train": 0.67, "valid": 0.34, "test": 0.0}}
ROI = {"x0": 8, "y0": 4, "xs": 48, "ys": 40}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.dtype.itemsize == 4
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


@contextlib.contextmanager
def active(pkg, groups, over, model="rcan-10-10-64"):
    """``pkg``'s config (the JAX package's or the port's) active for a call."""
    pkg.ConfigContext.set_defaults(**groups)
    cc = pkg.ConfigContext("sres", **dict({"model": model}, **over))
    cc.activate()
    try:
        yield cc
    finally:
        pkg.ConfigContext.deactivate()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny steps take milliseconds on one, and up
    to a second on eight, spinning up the pool on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def swot_root(tmp_path_factory):
    """A SWOT-format dataset of SSS and SST, 3 timesteps, at NX = 16."""
    root = str(tmp_path_factory.mktemp("swot") / "data")
    write_swot_fixture(root, nx=NX, ntimes=NTIMES, varnames=("SSS", "SST"))
    return root


# ------------------------------------------------------------ the decoder
def test_decoder_and_twin_match_sres_tpu_bit_for_bit():
    """The compiled decoder and its numpy twin give ``sres_tpu.native``'s
    scatter map and grid, bit for bit, NaN pattern and payload included;
    the build is the port's own (it fails here if g++ does)."""
    rng = np.random.default_rng(SEED)
    mask = rng.uniform(size=13 * 37 * 37) > 0.3
    vals = rng.normal(15.0, 2.0, int(mask.sum())).astype(">f4").view(np.uint32)
    smap = native.build_scatter_map(mask)
    assert np.array_equal(smap, native.build_scatter_map_plain(mask))
    assert np.array_equal(smap, jnative.build_scatter_map(mask))
    got = native.decode_timestep(vals, smap)
    assert same_bits(got, native.decode_timestep_plain(vals, smap))
    assert same_bits(got, jnative.decode_timestep(vals, smap))
    assert np.isnan(got).sum() == (~mask).sum() and native._lib is not None


def test_failed_decoder_build_raises(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's output; nothing falls
    back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no-such-flag"):
        native.decode_timestep(np.zeros(4, np.uint32), np.arange(4))


@pytest.mark.parametrize("nx", [1, 3, 16])
def test_llc_panels_match_sres_tpu(nx):
    """mds2d and assemble_hemispheres give ``sres_tpu``'s panels."""
    d = np.random.default_rng(nx).normal(size=13 * nx * nx).astype(np.float32)
    (e, w), (je, jw) = swot.mds2d(d), jswot.mds2d(d)
    assert same_bits(e, je) and same_bits(w, jw)
    assert e.shape == (3 * nx, 2 * nx) and w.shape == (2 * nx, 3 * nx)
    panel = swot.assemble_hemispheres(e, w)
    assert panel.shape == (3 * nx, 4 * nx) and same_bits(panel, jswot.assemble_hemispheres(je, jw))


@pytest.mark.parametrize("template,name", [
    ("SST.000*.shrunk", "SST.0007.shrunk"), ("SST.000*.shrunk", "SSS.0007.shrunk"),
    ("hr_sst_*.npy", "hr_sst_0720.npy"), ("SSS.000*.shrunk", "SSS.000.shrunk")])
def test_invert_template_matches_sres_tpu(template, name):
    assert swot.invert_template(template, name) == jswot.invert_template(template, name)


def test_swot_fixture_writes_sres_tpus_bytes(tmp_path, swot_root):
    """The same arguments write the same files, byte for byte."""
    ref = str(tmp_path / "jax")
    want = jwrite_swot_fixture(ref, nx=NX, ntimes=NTIMES, varnames=("SSS", "SST"))
    got = write_swot_fixture(str(tmp_path / "port"), nx=NX, ntimes=NTIMES,
                             varnames=("SSS", "SST"))
    assert dict(got, root=ref) == want
    files = sorted(str(p.relative_to(ref)) for p in Path(ref).rglob("*") if p.is_file())
    assert len(files) == 1 + 2 * NTIMES
    for f in files:
        assert filecmp.cmp(f"{ref}/{f}", f"{swot_root}/{f}", shallow=False), f


# ------------------------------------------------------------ the SWOT reader
@pytest.mark.parametrize("task,roi", [("SST-tiles-48", None), ("SSS_SST-tiles-48", None),
                                      ("SSS_SST-tiles-48", ROI), ("swot-tnorm", ROI)])
def test_swot_reader_matches_sres_tpu(tmp_path, swot_root, task, roi):
    """Time indices, a region, the timeslice's tiles and a batch with its
    stats attrs equal ``sres_tpu``'s bit for bit (lnorm; tnorm from the
    sidecar each side builds over the reader's timeslices)."""
    groups = dict(platform="local", task=task, dataset="swot", pipeline="sres")
    over = dict(SWOT_TASK, **{"dataset.dataset_root": swot_root})
    if roi is not None:
        over["dataset.roi"] = roi
    out = {}
    for name, pkg, mod in (("jax", jconfig, jswot), ("port", tconfig, swot)):
        with active(pkg, groups, dict(over, **{"platform.root": str(tmp_path / name)})) as cc:
            loader = mod.SWOTRawDataLoader(pkg.cfg().task)
            times = loader.get_dset_time_indices()
            region = loader.load_region(list(loader.varnames)[-1], 1)
            tiles = loader.load_timeslice(2)
            out[name] = times, region, tiles, loader.select_batch((1, 5)), \
                loader.load_region_data(0)
    (jt, jr, jtiles, jb, jrd), (tt, tr, ttiles, tb, trd) = out["jax"], out["port"]
    assert tt == jt == list(range(NTIMES))
    assert tr.shape == ((40, 48) if roi else (3 * NX, 4 * NX)) and same_bits(tr, jr)
    assert same_bits(trd.data, jrd.data) and trd.dims == jrd.dims
    assert same_bits(ttiles.data, jtiles.data) and ttiles.dims == jtiles.dims
    assert np.array_equal(ttiles.coords["tiles"], jtiles.coords["tiles"])
    assert ttiles.attrs["grid_shape"] == jtiles.attrs["grid_shape"]
    assert ttiles.shape[1] == (1 if task == "SST-tiles-48" else 2)
    assert ttiles.shape[0] >= 3 and tb.shape[0] == min(4, ttiles.shape[0] - 1)
    assert same_bits(tb.data, jb.data)
    assert sorted(tb.attrs) == sorted(jb.attrs) and "mean" in tb.attrs
    for k, v in jb.attrs.items():
        assert np.array_equal(np.asarray(tb.attrs[k]), np.asarray(v)), k


def test_get_loader_raises_for_merra2_only(tmp_path, swot_root):
    groups = dict(platform="local", task="SST-tiles-48", dataset="swot", pipeline="sres")
    with active(tconfig, groups, {"dataset.dataset_root": swot_root,
                                  "platform.root": str(tmp_path)}):
        task = tconfig.cfg().task
        assert isinstance(get_loader(task, {"x": 16, "y": 16}), swot.SWOTRawDataLoader)
        for name, kind in (("LLC4320", S3ExportDataLoader), ("merra2", None)):
            task["dataset"] = name
            if kind is None:
                with pytest.raises(NotImplementedError, match="MERRA2"):
                    get_loader(task, {"x": 16, "y": 16})
            else:
                assert isinstance(get_loader(task, {"x": 16, "y": 16}), kind)


# ------------------------------------------------------ the Cape Basin reader
def _llc_fixture(root, n=24, size=32):
    """``n`` hourly HR SST fields, 1-based files, the LLC4320 layout."""
    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/sst_192x192", exist_ok=True)
    base = rng.normal(size=(size, size)).astype(np.float32)
    for i in range(1, n + 1):
        arr = (12.0 + 4.0 * (base + 0.1 * rng.normal(size=(size, size)))).astype(np.float32)
        np.save(f"{root}/sst_192x192/hr_sst_{i:04d}.npy", arr)
    return root


@pytest.fixture(scope="module")
def llc_root(tmp_path_factory):
    return _llc_fixture(str(tmp_path_factory.mktemp("llc") / "data"))


CAPE = dict(platform="local", task="cape_basin_1x1", dataset="LLC4320", pipeline="sres")
# the tile's origin in LR pixels: the time domain scales it to HR (8, 4)
CAPE_TASK = {"task.tile_size": {"x": 4, "y": 4}, "task.batch_size": 4,
             "task.origin": {"x": 2, "y": 1},
             "task.ttsplit": {"train": 0.5, "valid": 0.25, "test": 0.25}}


def test_s3export_reader_matches_sres_tpu(tmp_path, llc_root):
    """A time-domain batch (consecutive time indices at one HR origin), the
    task's domain of a time index and the min-max scaling equal
    ``sres_tpu``'s bit for bit."""
    over = dict(CAPE_TASK, **{"dataset.dataset_root": llc_root, "task.origin": {"x": 8, "y": 4}})
    out = {}
    for name, pkg, cls in (("jax", jconfig, JS3), ("port", tconfig, S3ExportDataLoader)):
        with active(pkg, CAPE, dict(over, **{"platform.root": str(tmp_path / name)})):
            loader = cls(pkg.cfg().task, {"x": 16, "y": 16})
            x = np.random.default_rng(1).normal(10.0, 5.0, (7, 5)).astype(np.float32)
            out[name] = (loader.get_dset_time_indices(),
                         loader.load_index_batch({"x": 16, "y": 8}, (5, 9)),
                         loader.load_region_data(3), loader.scale("sst", x))
    (jt, jb, jr, js), (tt, tb, trd, ts) = out["jax"], out["port"]
    assert tt == jt == list(range(24))
    assert tb.shape == (4, 1, 16, 16) and same_bits(tb.data, jb.data)
    assert np.array_equal(tb.coords["tiles"], jb.coords["tiles"]) and tb.dims == jb.dims
    assert trd.shape == (1, 16, 16) and same_bits(trd.data, jr.data)
    assert ts.dtype == js.dtype and np.array_equal(ts, js)


# --------------------------------------------------------- one tiny epoch each
def _csv(root: Path):
    (path,) = Path(root).glob("processed/*_result_recs/*_losses.csv")
    with open(path, newline="") as f:
        return [row for row in csv.reader(f, delimiter=",", quotechar="|")]


def _jax_run(root, groups, over, nch, zarr=False):
    """The JAX trainer (as its launcher drives it) from the port's seeded
    initial weights: its loss CSV rows, and its zarr export's array."""
    sd0 = build_model(TCFG, nch, nch, "f32", seed=SEED, device="cpu").state_dict()

    def init_state(model, optimizer, sample_lr, seed, temporal=None):
        v = import_variables("rcan", {k: t.numpy() for k, t in sd0.items()}, TCFG)
        return jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                  batch_stats={}, opt_state=optimizer.init(v["params"])), False

    with pytest.MonkeyPatch.context() as mp, \
            active(jconfig, groups, dict(over, **{"platform.root": str(root)})) as cc:
        mp.setattr(jtrainer, "init_state", init_state)
        JLogManager.reset()
        tr = jtrainer.ModelTrainer(cc, seed=SEED)
        tr.train(jconfig.cfg().task.nepochs, False, seed=SEED, interp_loss=True)
        store = tr.to_zarr() if zarr else None
    JLogManager.reset()
    return _csv(root), store


def _args(groups, over):
    args = ["--model", "rcan-10-10-64", "--task", groups["task"], "--dataset",
            groups["dataset"], "--platform", "local", "--seed", str(SEED),
            "pipeline.device=cpu"]
    return args + [f"{k}={v}" for k, v in over.items()]


SWOT_GROUPS = dict(platform="local", task="SSS_SST-tiles-48", dataset="swot", pipeline="sres")


@pytest.fixture(scope="module")
def swot_epochs(tmp_path_factory, swot_root):
    """The two-variable SWOT task, 2 epochs: the JAX trainer's CSV and zarr
    store, and the port's launcher's controller."""
    over = dict(SWOT_TASK, **TINY_MODEL, **{"dataset.dataset_root": swot_root,
                                            "task.nepochs": 2, "task.lr": 3e-3})
    root = tmp_path_factory.mktemp("swot_runs")
    jrows, jstore = _jax_run(root / "jax", SWOT_GROUPS, over, 2, zarr=True)
    ctl = launch(_args(SWOT_GROUPS, dict(over, **{"platform.root": root / "port"})))
    return jrows, jstore, ctl, root, over, dict(tconfig.ConfigContext.configuration)


@pytest.fixture(scope="module")
def cape_epochs(tmp_path_factory, llc_root):
    over = dict(CAPE_TASK, **TINY_MODEL, **{"dataset.dataset_root": llc_root,
                                            "task.nepochs": 2, "task.lr": 3e-3})
    root = tmp_path_factory.mktemp("cape_runs")
    jrows, _ = _jax_run(root / "jax", CAPE, over, 1)
    ctl = launch(_args(CAPE, dict(over, **{"platform.root": root / "port"})))
    return jrows, ctl, root, dict(tconfig.ConfigContext.configuration)


def _rows_close(rows, want):
    """tests/test_torch_trainer.py's bar: the same (tset, epoch) rows in
    order, losses within rtol 1e-4 + 2e-6."""
    assert [r[:2] for r in rows] == [r[:2] for r in want]
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    np.testing.assert_allclose(got, np.array([[float(x) for x in r[2:]] for r in want]),
                               rtol=1e-4, atol=2e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("task", ["swot_sss_sst", "cape_basin_1x1"])
def test_epoch_csv_matches_jax_trainer(request, task):
    """One tiny epoch pair through the port's launcher (f32, CPU) writes the
    JAX trainer's loss CSV: SWOT SSS+SST (2 train timeslices, 1 validation)
    and Cape Basin's time domain (batches of 4 consecutive hours; 3 train
    starts, 1 validation, 1 test)."""
    if task == "swot_sss_sst":
        jrows, _, ctl, root, _, _ = request.getfixturevalue("swot_epochs")
        tsets = ["train"] * 2 + ["valid"]
    else:
        jrows, ctl, root, _ = request.getfixturevalue("cape_epochs")
        tsets = ["train"] * 3 + ["valid"]
    rows = _csv(root / "port")
    _rows_close(rows, jrows)
    assert [r[0] for r in rows] == tsets * 2 + (["test"] if task != "swot_sss_sst" else [])
    assert ctl.trainer.device.type == "cpu"


def test_time_domain_trainer_path(cape_epochs):
    """Cape Basin's time domain: the batch starts are batch-size strides
    split by ttsplit_times, a batch is consecutive hours at the task's
    origin scaled to HR (``get_batch_array``'s ``scale_coords``), min-max
    scaled from ``task.variable_ranges``, evaluate on the validation
    starts returns finite losses, and the region modes raise as
    ``sres_tpu``'s do."""
    from sres_tpu_torch.trainer.trainer import ttsplit_times
    _, ctl, _, conf = cape_epochs
    tr = ctl.trainer
    with active(tconfig, CAPE, conf):
        starts = tr.dataset.get_batch_time_coords(shuffle=False)
        assert starts == [0, 4, 8, 12, 16, 20]
        split = ttsplit_times(starts)
        assert [len(split[t]) for t in (TSet.Train, TSet.Validation, TSet.Test)] == [3, 1, 1]
        ctile = next(iter(tr._tile_iterator(starts[1])))
        batch = tr.dataset.get_batch_array(ctile, starts[1])
        assert batch.shape == (4, 1, 16, 16) and list(batch.coords["tiles"]) == [4, 5, 6, 7]
        hours = np.stack([np.load(f"{conf['dataset.dataset_root']}/sst_192x192/"
                                  f"hr_sst_{i + 1:04d}.npy") for i in range(4, 8)])
        want = (hours[:, 4:20, 8:24] - 2.9963) / (23.4310 - 2.9963)
        np.testing.assert_array_equal(batch.data[:, 0], want.astype(np.float32))
        tr.tile_index = 0  # the time domain selects a tile location by its index
        assert tr._tile_in_batch(0, ctile) and not tr._tile_in_batch(1, ctile)
        tr.tile_index = -1
        _, losses = tr.evaluate(TSet.Validation, update_model=False, update_checkpoint=False)
        assert losses and all(np.isfinite(v) for v in losses.values())
        for mode in ("infer_region", "infer_region_seamless", "infer_region_spatial"):
            with pytest.raises(NotImplementedError, match="tiles-domain"):
                getattr(tr, mode)(starts[0])
        with pytest.raises(NotImplementedError, match="tiles-domain"):
            list(tr.infer_region_stream([starts[0]]))


def test_two_variable_regions_denormalize_each_variable(swot_epochs):
    """The trained SSS+SST model served from its best-validation checkpoint:
    each variable's target panel is its own raw region (rtol 2e-4), in the
    padded-batch, whole-region and tiled modes; model panels finite there."""
    _, _, ctl, _, _, conf = swot_epochs
    tr = ctl.trainer
    with active(tconfig, SWOT_GROUPS, conf):
        cv, ct = tr.data_timestamps[TSet.Validation][0], tr.data_timestamps[TSet.Train][0]
        runs = {"region": (cv, tr.infer_region(cv)), "spatial": (cv, tr.infer_region_spatial(cv)),
                "tiled": (ct, tr.process_image(TSet.Validation, 0, update_model=False)[0])}
        for mode, (ctime, images) in runs.items():
            region = tr.dataset.load_region_data(ctime).data
            assert list(images) == ["SSS", "SST"], mode
            for iv, var in enumerate(images):
                tgt = images[var]["target"].data
                assert tgt.shape == region.shape[1:], (mode, var)
                raw, holes = region[iv], np.isnan(tgt)
                assert holes.sum() < tgt.size // 2 and np.isfinite(images[var]["model"].data[~holes]).all()
                np.testing.assert_allclose(tgt[~holes], raw[~holes], rtol=2e-4, err_msg=(mode, var))


def test_to_zarr_matches_sres_tpu(tmp_path, swot_epochs):
    """``python -m sres_tpu_torch.to_zarr`` writes ``sres_tpu``'s store:
    the same metadata and, per time index, the raw region, bit for bit."""
    _, jstore, _, _, over, _ = swot_epochs
    store = to_zarr_main(_args(SWOT_GROUPS, dict(over, **{"platform.root": tmp_path})))
    tconfig.ConfigContext.deactivate()
    assert Path(store).name == Path(jstore).name == "swot.zarr"
    got, want = read_zarr(store), jread_zarr(jstore)
    assert got.shape == (NTIMES, 2, 3 * NX, 4 * NX) and same_bits(got, want)
    for meta in ("data/.zarray", "data/.zattrs", ".zgroup"):
        assert json.load(open(f"{store}/{meta}")) == json.load(open(f"{jstore}/{meta}"))


@pytest.mark.parametrize("setup", ["swot", "LLC4320"])
def test_controller_load_raw_dataset(tmp_path, swot_root, llc_root, setup):
    """``WorkflowController.test(model, "load_raw_dataset")`` loads the first
    time index on a SWOT and an LLC4320 configuration (``sres_tpu``'s
    raises on the latter: its S3 export reader has no timeslices)."""
    if setup == "swot":
        groups, over = SWOT_GROUPS, dict(SWOT_TASK, **{"dataset.dataset_root": swot_root})
    else:
        groups, over = CAPE, dict(CAPE_TASK, **{"dataset.dataset_root": llc_root})
    ctl = WorkflowController("sres", groups, seed=SEED)
    ctl.test("rcan-10-10-64", "load_raw_dataset",
             **dict(over, **TINY_MODEL, **{"platform.root": str(tmp_path),
                                           "pipeline.device": "cpu"}))
    loader = ctl.trainer.dataset.srbatch.data_loader
    if setup == "swot":
        assert loader.time_index == 0 and loader.timeslice.shape[1:] == (2, 16, 16)
        assert set(loader.timers) == {"map", "read", "decode", "assemble", "crop"}
    else:
        assert loader.shape == [32, 32]
