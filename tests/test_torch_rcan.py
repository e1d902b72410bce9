"""The port's RCAN against the JAX RCAN: a JAX variable tree, exported by
sres_tpu.util.torch_export, loads into the port with strict=True, and both the direct and the Winograd
trunk match the JAX forward (nfeatures 8, 1 group, 2 blocks, 8×8 LR).
On the CPU the Winograd trunk runs the kernels' plain twins."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.device import compute_dtype, resolve_device
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.wino_blocks import WinoConv, WinoResidualGroup
from sres_tpu_torch.util.weights import state_dict_from_jax

CFG = dict(name="rcan", nfeatures=8, nlayers=1, nblocks=2, cbottleneck=2,
           kernel_size=3, downscale_factors=[2, 2], loss_fn="l2")


def jax_variables(cfg, seed):
    """A JAX RCAN variable tree holding seeded torch-default weights (built
    by sres_tpu.util.torch_import, so no flax init has to compile)."""
    sd = build_model(cfg, 1, 1, "f32", seed=seed).state_dict()
    return import_variables(cfg["name"], {k: v.numpy() for k, v in sd.items()}, cfg)


@pytest.fixture(scope="module")
def jax_rcan():
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 1)).astype(np.float32)
    model = jax_build_model(dict(CFG), 1, 1, precision="f32")
    v = jax_variables(CFG, 1)
    y = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    return x, v, y


def _port(cfg, variables):
    model = build_model(cfg, 1, 1, precision="f32")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model.eval()


@pytest.mark.parametrize("winograd", [None, 2, 4])
def test_rcan_matches_jax(jax_rcan, winograd):
    x, variables, want = jax_rcan
    cfg = dict(CFG, winograd=winograd)
    model = _port(cfg, variables)
    assert any(isinstance(m, WinoResidualGroup) for m in model.modules()) == bool(winograd)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 32, 32)
    tol = (3e-5 if winograd else 2e-5) * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=tol)


def test_winograd_state_dict_names_match_direct():
    direct = build_model(CFG, 1, 1, "f32").state_dict()
    wino = build_model(dict(CFG, winograd=4), 1, 1, "f32").state_dict()
    assert list(direct) == list(wino)
    assert "body.0.body.1.body.3.conv_du.2.weight" in direct
    assert {"head.0.weight", "body.0.body.2.weight", "body.1.bias",
            "tail.0.0.weight", "tail.0.2.weight", "tail.1.bias"} <= set(direct)


def test_winograd_u_cache_follows_weight_loads():
    """U is computed once per weight load, and again after the weights
    change in place."""
    conv = WinoConv(8, 8, 4)
    u1 = conv._u(torch.float32)
    assert conv._u(torch.float32) is u1
    with torch.no_grad():
        conv.weight.mul_(2.0)
    u2 = conv._u(torch.float32)
    assert u2 is not u1
    assert torch.equal(u2, 2.0 * u1)


def test_seeded_init_is_reproducible_and_torch_default():
    a = build_model(CFG, 1, 1, "f32", seed=3).state_dict()
    b = build_model(CFG, 1, 1, "f32", seed=3).state_dict()
    c = build_model(CFG, 1, 1, "f32", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.0.weight"], c["head.0.weight"])
    w = a["body.0.body.0.body.0.weight"]          # fan_in = 8 * 9
    assert float(w.abs().max()) <= 1 / np.sqrt(72)


def test_unported_knobs_raise_and_tpu_knobs_are_ignored():
    for extra in (dict(fused=True), dict(quantization="int8_fused"),
                  dict(pervar_heads=True), dict(name="edsr")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dict(CFG, **extra), 1, 1, "f32")
    ref = build_model(CFG, 1, 1, "f32").state_dict()
    knobs = build_model(dict(CFG, lane_pack=2, winograd_bs=4, scan_groups=True,
                             remat_trunk=True), 1, 1, "f32").state_dict()
    assert list(ref) == list(knobs)


def test_winograd_is_forward_only():
    model = build_model(dict(CFG, winograd=2), 1, 1, "f32")
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(NotImplementedError, match="forward-only"):
        model(x)
    with pytest.raises(ValueError, match="multiples of the tile size"), torch.no_grad():
        model(torch.zeros(1, 1, 7, 7))


def test_bf16_compute_over_f32_params(jax_rcan):
    x, variables, want = jax_rcan
    model = build_model(dict(CFG, winograd=4), 1, 1, precision="bf16")
    model.load_state_dict(state_dict_from_jax(variables, CFG), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max() / np.abs(want).max()
    assert 0 < err < 0.05


def test_device_and_precision_resolution(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("auto")
    assert compute_dtype("bf16") is torch.bfloat16
    assert compute_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        compute_dtype("f16")
