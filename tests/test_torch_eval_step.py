"""The port's eval step against the JAX eval step, the smoke script's model
config against the YAML, and the port's import hygiene (no JAX, no YAML,
nothing of the JAX package)."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.trainer import losses as jlosses
from sres_tpu.trainer.step import SRTrainState, StepConfig as JStepConfig
from sres_tpu.trainer.step import build_eval_step as jax_build_eval_step
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.trainer import losses as tlosses
from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
from sres_tpu_torch.util.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=1, cbottleneck=2,
           kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")
TASK = dict(input_variables=["SST"], target_variables=["SST"])


def jax_variables(cfg, seed):
    """A JAX RCAN variable tree holding seeded torch-default weights (built
    by sres_tpu.util.torch_import, so no flax init has to compile)."""
    sd = build_model(cfg, 1, 1, "f32", seed=seed, device="cpu").state_dict()
    return import_variables(cfg["name"], {k: v.numpy() for k, v in sd.items()}, cfg)


def test_eval_step_matches_jax():
    rng = np.random.default_rng(0)
    hr = rng.normal(size=(3, 1, 32, 32)).astype(np.float32)
    weight = np.array([1.0, 1.0, 0.0], np.float32)      # one padding tile
    jmodel = jax_build_model(dict(CFG), 1, 1, precision="f32")
    v = jax_variables(CFG, 1)
    sc = make_step_config(TASK, CFG)
    jsc = JStepConfig(**{k: getattr(sc, k) for k in JStepConfig._fields})
    state = SRTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats={}, opt_state=None)
    jmet, jouts = jax_build_eval_step(jmodel, jsc)(state, jnp.asarray(hr),
                                                   jnp.asarray(weight))
    model = build_model(CFG, 1, 1, precision="f32", device="cpu")
    model.load_state_dict(state_dict_from_jax(v, CFG), strict=True)
    met, outs = build_eval_step(model, sc)(torch.from_numpy(hr), torch.from_numpy(weight))
    assert set(met) == set(jmet) == {"mloss", "sloss", "interp_sloss"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    for name, a, b in zip(("lr", "out", "target", "interp"), outs, jouts):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * float(np.abs(b).max()), err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    prd = rng.normal(size=(4, 1, 8, 8)).astype(np.float32)
    tar = rng.normal(size=(4, 1, 10, 10)).astype(np.float32)   # cropped to prd
    w = np.array([1, 0, 1, 1], np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    for fn in ("l2loss", "charbonnier"):
        want = float(getattr(jlosses, fn)(nhwc(prd), nhwc(tar), jnp.asarray(w)))
        got = float(getattr(tlosses, fn)(torch.from_numpy(prd), torch.from_numpy(tar),
                                         torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
    np.testing.assert_allclose(float(tlosses.psnr(0.1, 2.0)),
                               float(jlosses.psnr(0.1, 2.0)), rtol=1e-6)


def test_l2loss_gradient_matches_jax():
    """The gradient of the masked RMSE against jax.grad of the JAX l2loss,
    with a 0-weight padding tile (whose gradient is 0)."""
    rng = np.random.default_rng(3)
    prd = rng.normal(size=(4, 1, 8, 8)).astype(np.float32)
    tar = rng.normal(size=(4, 1, 8, 8)).astype(np.float32)
    w = np.array([1, 1, 0, 1], np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    want = jax.jit(jax.grad(jlosses.l2loss))(nhwc(prd), nhwc(tar), jnp.asarray(w))
    p = torch.from_numpy(prd).requires_grad_()
    tlosses.l2loss(p, torch.from_numpy(tar), torch.from_numpy(w)).backward()
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    assert not p.grad[2].any()


def test_chip_smoke_config_is_the_flagship_yaml():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = yaml.safe_load((ROOT / "config/model/rcan-10-20-64.yaml").read_text())
    got = dict(chip_smoke.MODEL_CFG)
    assert got.pop("winograd") == 4
    assert got == want


def test_chip_smoke_edsr_config_is_the_yaml():
    """Phases 19-21 run config/model/edsr.yaml as written, with the
    Winograd trunk set in code (the YAML keeps it commented out)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = yaml.safe_load((ROOT / "config/model/edsr.yaml").read_text())
    got = dict(chip_smoke.EDSR_CFG)
    assert got.pop("winograd") == 4
    assert got == want


_FRESH_PROCESS = """
import contextlib, io, json, sys
sys.path.insert(0, %r)
sys.argv = ["chip_smoke.py"]
import chip_smoke, sres_tpu_torch.device, sres_tpu_torch.models
import sres_tpu_torch.models.rcan, sres_tpu_torch.models.swinir
import sres_tpu_torch.models.edsr, sres_tpu_torch.models.wino_blocks
import sres_tpu_torch.models.fused, sres_tpu_torch.ops.fused_group
import sres_tpu_torch.ops.cuda, sres_tpu_torch.ops.window_attention
import sres_tpu_torch.ops.resize, sres_tpu_torch.ops.winograd_conv
import sres_tpu_torch.trainer.step, sres_tpu_torch.util.weights
import numpy as np, torch
from sres_tpu_torch.models import build_model
from sres_tpu_torch.util.weights import state_dict_from_jax
conv = lambda k, ci, co: {"kernel": np.zeros((k, k, ci, co), np.float32),
                          "bias": np.zeros(co, np.float32)}
rcab = {"Conv_0": conv(3, 4, 4), "Conv_1": conv(3, 4, 4),
        "CALayer_0": {"Conv_0": conv(1, 4, 2), "Conv_1": conv(1, 2, 4)}}
params = {"Conv_0": conv(3, 1, 4), "Conv_1": conv(3, 4, 4),
          "ResidualGroup_0": {"RCAB_0": rcab, "Conv_0": conv(3, 4, 4)},
          "SPUpsample_0": {"Conv_0": conv(3, 4, 16), "Conv_1": conv(3, 4, 16)},
          "Conv_2": conv(3, 4, 1)}
sd = state_dict_from_jax({"params": params}, dict(name="rcan", nlayers=1, nblocks=1))
z = lambda *s: np.zeros(s, np.float32)
dense = lambda i, o: {"kernel": z(i, o), "bias": z(o)}
ln = {"scale": z(4), "bias": z(4)}
attn = {"wqkv": z(4, 12), "bqkv": z(1, 12), "wo": z(4, 4), "bo": z(1, 4),
        "rel_bias": z(49, 2)}
swin = {"Conv_0": conv(3, 1, 4), "Conv_1": conv(3, 4, 4), "Conv_2": conv(3, 4, 4),
        "SwinBlock_0": {"LayerNorm_0": ln, "LayerNorm_1": ln, "Dense_0": dense(4, 8),
                        "Dense_1": dense(8, 4), "FusedWindowAttention_0": attn},
        "SPUpsample_0": params["SPUpsample_0"], "Conv_3": conv(3, 4, 1)}
scfg = dict(name="swinir", nfeatures=4, nlayers=1, nblocks=1, window_size=4,
            num_heads=2)
swin_sd = state_dict_from_jax({"params": swin}, scfg)
swin_model = build_model(scfg, 1, 1, "f32", device="cpu")
swin_model.load_state_dict(swin_sd, strict=True)
swin_out = tuple(swin_model(torch.zeros(1, 1, 8, 8)).shape)
swin16 = build_model(dict(scfg, window_size=16), 1, 1, "f32", device="cpu")
swin16_out = tuple(swin16(torch.zeros(1, 1, 16, 16)).shape)
from sres_tpu_torch.ops import window_attention as twa
z = torch.zeros
t256_out = tuple(twa.window_attention(z(2, 256, 64), z(64, 192), z(192), z(64, 64), z(64),
                                      z(4, 256, 256), None, 4).shape)
ecfg = dict(name="edsr", nfeatures=4, nlayers=1, winograd=2)
edsr_sd = state_dict_from_jax({"params": {
    "Conv_0": conv(3, 1, 4), "ResBlock_0": {"Conv_0": conv(3, 4, 4), "Conv_1": conv(3, 4, 4)},
    "Conv_1": conv(3, 4, 4), "SPUpsample_0": params["SPUpsample_0"],
    "Conv_2": conv(3, 4, 1)}}, ecfg)
edsr_model = build_model(ecfg, 1, 1, "f32", device="cpu")
edsr_model.load_state_dict(edsr_sd, strict=True)
from sres_tpu_torch.ops.winograd_conv import wino_chain_fwd
chain_out = tuple(wino_chain_fwd(torch.zeros(1, 4, 4, 4), torch.zeros(2, 4, 4, 3, 3),
                                 torch.zeros(2, 4), 2).shape)
edsr_out = tuple(edsr_model(torch.zeros(1, 1, 8, 8)).shape)
import tempfile
import sres_tpu_torch.config, sres_tpu_torch.train, sres_tpu_torch.controller
import sres_tpu_torch.controller.workflow, sres_tpu_torch.trainer.trainer
import sres_tpu_torch.trainer.checkpoints, sres_tpu_torch.trainer.results
import sres_tpu_torch.data.batch, sres_tpu_torch.data.input_pipeline
import sres_tpu_torch.data.inference_io, sres_tpu_torch.data.norm
import sres_tpu_torch.data.region_loader, sres_tpu_torch.data.synthetic
import sres_tpu_torch.data.tiles, sres_tpu_torch.util.larray
import sres_tpu_torch.util.logging, sres_tpu_torch.util.yamlite
root = tempfile.mkdtemp()
ctl = sres_tpu_torch.train.main([
    "--model", "rcan-10-10-64", "--task", "synthetic-tiles-48", "--dataset", "synthetic",
    "--platform", "local", "--seed", "1", "platform.root=" + root, "pipeline.device=cpu",
    "pipeline.precision=f32", "task.nepochs=1", "task.batch_size=3", "model.nfeatures=4",
    "model.nlayers=1", "model.nblocks=1", "dataset.ntimes=4", "dataset.image_size={y: 96, x: 96}",
    "task.tile_size={x: 8, y: 8}", "task.ttsplit={train: 0.5, valid: 0.25, test: 0.25}"])
csv_rows = [l.split(",")[0] for l in open(ctl.trainer.results_accum.result_file_path())]
import sres_tpu_torch.infer, sres_tpu_torch.ops.assemble, sres_tpu_torch.data.overlap
import sres_tpu_torch.parallel.spatial
served = sres_tpu_torch.infer.main([
    "--model", "rcan-10-10-64", "--task", "synthetic-tiles-48", "--dataset", "synthetic",
    "--platform", "local", "--seed", "1", "platform.root=" + root, "pipeline.device=cpu",
    "pipeline.precision=f32", "task.batch_size=3", "model.nfeatures=4",
    "model.nlayers=1", "model.nblocks=1", "dataset.ntimes=4", "dataset.image_size={y: 96, x: 96}",
    "task.tile_size={x: 8, y: 8}", "task.ttsplit={train: 0.5, valid: 0.25, test: 0.25}"])
sres_tpu_torch.config.ConfigContext.deactivate()
import os
nc_files = sorted(os.listdir(root + "/results/inference/synthetic/synthetic-tiles-48"))
import shutil
shutil.rmtree(root)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "yaml", "sres_tpu"))
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    rc = chip_smoke.main()
print(json.dumps(dict(bad=bad, rc=rc, stdout=out.getvalue(), sd_keys=len(sd),
                      swin_keys=len(swin_sd), swin_out=swin_out,
                      swin16_out=swin16_out, t256_out=t256_out,
                      edsr_keys=len(edsr_sd), edsr_out=edsr_out, chain_out=chain_out,
                      csv_rows=csv_rows, nc_files=nc_files)))
"""


@pytest.fixture(scope="module")
def fresh_process():
    """One new interpreter: import the port and chip_smoke, then run
    chip_smoke.main() as the script would be run."""
    proc = subprocess.run([sys.executable, "-c", _FRESH_PROCESS % str(ROOT)],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_yaml(fresh_process):
    """Nothing of JAX, YAML or the JAX package is loaded, even after calls
    of state_dict_from_jax (20 tensors for a 1-group, 1-RCAB RCAN; 25 for a
    1-group, 1-block SwinIR and 14 for a 1-ResBlock EDSR with ``winograd:
    2``, which then load strictly and run), of the conv chain, of a window-16
    SwinIR and of window attention at T = 256 (its CPU twin), and after
    one tiny epoch on the CPU through the launcher (config reader, data
    pipeline, trainer, checkpoints, loss CSV), and after serving that
    epoch's checkpoint through the inference launcher in every region mode
    (one validation timestep: Tiles at 0, the image at 0)."""
    assert fresh_process["bad"] == []
    assert fresh_process["sd_keys"] == 20
    assert fresh_process["swin_keys"] == 25
    assert fresh_process["swin_out"] == [1, 1, 32, 32]
    assert fresh_process["swin16_out"] == [1, 1, 64, 64]
    assert fresh_process["t256_out"] == [2, 256, 64]
    assert fresh_process["edsr_keys"] == 14
    assert fresh_process["edsr_out"] == [1, 1, 32, 32]
    assert fresh_process["chain_out"] == [1, 4, 4, 4]
    assert fresh_process["csv_rows"] == ["train", "train", "valid", "test"]
    assert fresh_process["nc_files"] == ["SST-0.image.nc", "SST-0.tiles.nc"]


def test_chip_smoke_refuses_to_run_without_a_card(fresh_process):
    """No card here: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert fresh_process["rc"] != 0
    assert '"ok"' not in fresh_process["stdout"]
