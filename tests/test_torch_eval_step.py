"""The port's eval step against the JAX eval step, the smoke script's model
config against the YAML, and the port's import hygiene (no JAX, no YAML)."""
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
    sd = build_model(cfg, 1, 1, "f32", seed=seed).state_dict()
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
    model = build_model(CFG, 1, 1, precision="f32")
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


_FRESH_PROCESS = """
import contextlib, io, json, sys
sys.path.insert(0, %r)
sys.argv = ["chip_smoke.py"]
import chip_smoke, sres_tpu_torch.device, sres_tpu_torch.models
import sres_tpu_torch.models.rcan, sres_tpu_torch.ops.cuda
import sres_tpu_torch.ops.resize, sres_tpu_torch.ops.winograd_conv
import sres_tpu_torch.trainer.step, sres_tpu_torch.util.weights
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "yaml", "sres_tpu"))
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    rc = chip_smoke.main()
print(json.dumps(dict(bad=bad, rc=rc, stdout=out.getvalue())))
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
    assert fresh_process["bad"] == []


def test_chip_smoke_refuses_to_run_without_a_card(fresh_process):
    """No card here: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert fresh_process["rc"] != 0
    assert '"ok"' not in fresh_process["stdout"]
