"""The port's config reader and synthetic data pipeline against the JAX
package: ``util/yamlite`` against ``yaml.safe_load`` on every file of
``config/``, the composed config against ``sres_tpu.config.compose``, and
the trainer's padded batch stream (HR arrays, 0/1 weights, tile order) of a
tiny synthetic task, bit for bit, with xyflip and lnorm on."""
import math
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from sres_tpu import config as jconfig
from sres_tpu.data.batch import BatchDataset as JBatchDataset
from sres_tpu.data.inference_io import TSet as JTSet
from sres_tpu.data.tiles import batchDomain as JDomain
from sres_tpu.trainer.trainer import ModelTrainer as JTrainer
from sres_tpu.trainer.trainer import ttsplit_times as jttsplit
from sres_tpu_torch import config as tconfig
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.trainer.trainer import ModelTrainer
from sres_tpu_torch.util import yamlite

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "config").rglob("*.yaml"))
GROUPS = dict(platform="local", task="synthetic-tiles-48", dataset="synthetic",
              pipeline="sres", model="rcan-10-20-64")


def typed(v):
    """A value with every leaf's type beside it (1, 1.0 and True differ)."""
    if isinstance(v, dict):
        return ("dict", tuple((typed(k), typed(x)) for k, x in v.items()))
    if isinstance(v, list):
        return ("list", tuple(typed(x) for x in v))
    if isinstance(v, float) and math.isnan(v):
        return ("float", "nan")
    return (type(v).__name__, v)


@pytest.mark.parametrize("path", CONFIGS)
def test_yamlite_equals_yaml_safe_load(path):
    text = (ROOT / path).read_text()
    assert typed(yamlite.load(text)) == typed(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "lr: 1e-4", "lr: 3.0e-3", "x: 1.0e5", "x: .5", "x: 0x1F", "x: 017", "x: 08",
    "x: 1_000", "x: 1:30", "x: -.inf", "x: yes", "x: Off", "x: ~", "x:",
    "x: 'it''s'", 'x: "a\\tb"', "x: a#b", "x: b c  # d", "2m: 3",
    "x: { a: 1,\n  b: [2,\n 3] }", "x:\n- 1\n- y: 2\n  z: [ SST ]", "x: {}"])
def test_yamlite_scalars_and_collections(text):
    """PyYAML's YAML 1.1 resolution: ``1e-4`` (no dot) is a string and
    ``3.0e-3`` a float, leading-zero octal, base 60, the bool words."""
    assert typed(yamlite.load(text)) == typed(yaml.safe_load(text))


OVERRIDES = {"platform.root": "/data/run", "task.nepochs": 1, "model.winograd": 4,
             "dataset.image_size": {"y": 1920, "x": 1920}, "pipeline.device": "cpu"}


def test_compose_equals_jax_compose():
    """config/sres.yaml with the synthetic task's groups, dot-key overrides
    and ``${.root}`` interpolation (platform.results = /data/run/results)."""
    ov = dict(GROUPS, **OVERRIDES)
    got = tconfig.compose("sres", ov).to_dict()
    assert typed(got) == typed(jconfig.compose("sres", ov).to_dict())
    assert got["platform"]["results"] == "/data/run/results"
    assert got["task"]["lr"] == "1e-4" and got["model"]["winograd"] == 4


def test_context_activation_matches_jax():
    """ConfigContext fills task.name/dataset/training_version as the JAX
    one does; the launcher's override values parse as written."""
    from sres_tpu_torch.train import parse_overrides
    ov = parse_overrides(["task.nepochs=1", "dataset.image_size={y: 1920, x: 1920}",
                          "pipeline.device=cpu", "task.lr=1e-3"])
    assert ov == {"task.nepochs": 1, "dataset.image_size": {"y": 1920, "x": 1920},
                  "pipeline.device": "cpu", "task.lr": 1e-3}
    tconfig.ConfigContext.set_defaults(**GROUPS)
    jconfig.ConfigContext.set_defaults(**GROUPS)
    with tconfig.ConfigContext("sres", **OVERRIDES):
        got = tconfig.cfg().to_dict()
    with jconfig.ConfigContext("sres", **{k: v for k, v in OVERRIDES.items()
                                          if k != "pipeline.device"}):
        want = jconfig.cfg().to_dict()
    want["pipeline"]["device"] = "cpu"
    assert typed(got) == typed(want)
    assert got["task"]["training_version"] == "sres-rcan-10-20-64-synthetic-synthetic-tiles-48"


def test_device_auto_is_the_card():
    pipe = {"device": "auto", "gpu": 0}
    assert tconfig.trainer_device(pipe) == "cuda:0"
    assert tconfig.trainer_device({"device": "cpu"}) == "cpu"


TINY = {"dataset.image_size": {"y": 96, "x": 96}, "dataset.ntimes": 4,
        "dataset.nan_fraction": 0.1, "task.tile_size": {"x": 8, "y": 8},
        "task.batch_size": 3, "task.ttsplit": {"train": 0.5, "valid": 0.25, "test": 0.25},
        "model.nfeatures": 4, "model.nlayers": 1, "model.nblocks": 1,
        "model.lane_pack": 1, "pipeline.precision": "f32"}
SEED = 3


def _jax_stream(tmp_path):
    """The JAX trainer's padded train batches of one epoch, driven through
    its own producer, tile-iterator and padding methods (no model built)."""
    jconfig.ConfigContext.set_defaults(**GROUPS)
    with jconfig.ConfigContext("sres", **dict(TINY, **{"platform.root": str(tmp_path)})):
        task = jconfig.cfg().task
        fake = SimpleNamespace(domain=JDomain.Tiles, dataset=JBatchDataset(task, seed=SEED),
                               pad_size=int(task.batch_size), input_backend="sync")
        fake.dataset.reseed(SEED)
        fake._shuffle_rng = random.Random(SEED)
        times = jttsplit(fake.dataset.get_batch_time_coords())[JTSet.Train]
        out = []
        for ctime in times:
            tiles = JTrainer._tile_iterator(fake, ctime, randomize=True)
            produce = JTrainer._make_batch_producer(
                SimpleNamespace(input_backend="sync", dataset=fake.dataset,
                                _pad_batch=lambda b: JTrainer._pad_batch(fake, b)), ctime)
            out.append((ctime, [(dict(c), produce(c),
                                 fake.dataset.get_current_batch_array().attrs["xyflip"])
                                for c in tiles]))
        return out


def test_batch_stream_matches_jax_bit_for_bit(tmp_path):
    want = _jax_stream(tmp_path / "jax")
    tconfig.ConfigContext.set_defaults(**GROUPS)
    with tconfig.ConfigContext("sres", **dict(TINY, **{"platform.root": str(tmp_path / "t"),
                                                       "pipeline.device": "cpu"})) as cc:
        tr = ModelTrainer(cc, seed=SEED)
        tr.dataset.reseed(SEED)
        tr._shuffle_rng = random.Random(SEED)
        tr.init_data_timestamps()
        got = []
        for ctime in tr.data_timestamps[TSet.Train]:
            tiles = tr._tile_iterator(ctime, randomize=True)
            produce = tr._make_batch_producer(ctime)
            got.append((ctime, [(dict(c), produce(c),
                                 tr.dataset.get_current_batch_array().attrs["xyflip"])
                                for c in tiles]))
    assert [t for t, _ in got] == [t for t, _ in want]
    flips, npad = [], 0
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w) and [b[0] for b in g] == [b[0] for b in w]   # tile order
        for (_, (hr, weight, nvalid), flip), (_, (jhr, jweight, jnvalid), jflip) in zip(g, w):
            assert hr.dtype == jhr.dtype == np.float32 and nvalid == jnvalid
            assert hr.tobytes() == jhr.tobytes()
            assert weight.tobytes() == jweight.tobytes()
            assert flip == jflip
            flips.append(flip)
            npad += int((weight == 0).sum())
    assert npad > 0, "no ragged batch: the padding is not exercised"
    assert len(set(flips)) > 1, "xyflip drew one index only"
