"""The port's SwinIR against the JAX SwinIR (sres_tpu/models/swinir.py) at
nfeatures 16, 1 group of 2 blocks (one shifted), window 4, 2 heads, 8×8 LR
tiles, batch 2: the window helpers, weight transfer from both attention
trees, the f32 forward, a bf16 forward and a 3-step Adam trajectory. The
JAX trees are built from the port's seeded init (no flax init has to
compile); the JAX model runs its fused Pallas attention in interpret mode.
On the CPU the port's attention runs the kernels' plain twins."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.models import swinir as jswin
from sres_tpu.trainer import step as jstep
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models import swinir as tswin
from sres_tpu_torch.trainer import step as tstep
from sres_tpu_torch.util.weights import state_dict_from_jax

CFG = dict(name="swinir", nfeatures=16, nlayers=1, nblocks=2, window_size=4,
           num_heads=2, mlp_ratio=2.0, downscale_factors=[2, 2], loss_fn="l2",
           fused_attention=True)
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-3)
STEPS, SEED = 3, 7


class _Cfg(dict):
    """A mapping with attribute access, as the JAX package reads configs."""
    __getattr__ = dict.__getitem__


def jax_params(sd, cfg, fused):
    """The port's state dict as a JAX SwinIR param tree, with the fused
    (FusedWindowAttention_0) or the unfused (WindowAttention_0) attention."""
    n = lambda k: sd[k].detach().numpy()
    conv = lambda k: {"Conv_0": {"kernel": n(f"{k}.weight").transpose(2, 3, 1, 0),
                                 "bias": n(f"{k}.bias")}}
    dense = lambda k: {"kernel": n(f"{k}.weight").T, "bias": n(f"{k}.bias")}
    nl, nb = cfg["nlayers"], cfg["nblocks"]
    p = {"Conv_0": conv("conv_first")}
    for g in range(nl):
        for b in range(nb):
            base = f"layers.{g}.residual_group.blocks.{b}"
            a = f"{base}.attn"
            blk = {f"LayerNorm_{i}": {"scale": n(f"{base}.{ln}.weight"),
                                      "bias": n(f"{base}.{ln}.bias")}
                   for i, ln in enumerate(("norm1", "norm2"))}
            blk.update(Dense_0=dense(f"{base}.mlp.fc1"), Dense_1=dense(f"{base}.mlp.fc2"))
            table = n(f"{a}.relative_position_bias_table")
            if fused:
                blk["FusedWindowAttention_0"] = dict(
                    wqkv=n(f"{a}.qkv.weight").T, bqkv=n(f"{a}.qkv.bias")[None],
                    wo=n(f"{a}.proj.weight").T, bo=n(f"{a}.proj.bias")[None],
                    rel_bias=table)
            else:
                blk["WindowAttention_0"] = dict(Dense_0=dense(f"{a}.qkv"),
                                                Dense_1=dense(f"{a}.proj"),
                                                rel_bias=table)
            p[f"SwinBlock_{g * nb + b}"] = blk
        p[f"Conv_{1 + g}"] = conv(f"layers.{g}.conv")
    p[f"Conv_{nl + 1}"] = conv("conv_after_body")
    p["SPUpsample_0"] = {"Conv_0": conv("upsample.0"), "Conv_1": conv("upsample.2")}
    p[f"Conv_{nl + 2}"] = conv("conv_last")
    return p


@pytest.fixture(scope="module")
def jax_ref():
    """Seeded port weights, their fused JAX tree, an LR batch and the JAX f32
    forward of it."""
    sd = build_model(CFG, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    params = jax_params(sd, CFG, fused=True)
    x = np.random.default_rng(SEED).normal(size=(2, 8, 8, 1)).astype(np.float32)
    model = jax_build_model(dict(CFG), 1, 1, precision="f32")
    y = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    return sd, params, x, y


def _port(cfg, params, precision="f32"):
    model = build_model(cfg, 1, 1, precision, device="cpu")
    model.load_state_dict(state_dict_from_jax({"params": params}, cfg), strict=True)
    return model.eval()


def _run(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy() \
            .transpose(0, 2, 3, 1)


def test_window_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    win = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jswin.window_partition(x, 4)))
    back = tswin.window_merge(win, 4, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tswin.relative_position_index(4),
                                  jswin.relative_position_index(4))
    for h, w, ws, sh in ((8, 8, 4, 2), (16, 24, 8, 4)):
        np.testing.assert_array_equal(tswin.shift_attn_mask(h, w, ws, sh),
                                      jswin.shift_attn_mask(h, w, ws, sh))


def test_fused_tree_loads_and_matches_jax_forward(jax_ref):
    """Weights carried from the fused tree load strictly, give back the
    port's own weights bit for bit, and the f32 forward is within
    2e-5·max of the JAX model's."""
    sd, params, x, want = jax_ref
    model = _port(CFG, params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    got = _run(model, x)
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * float(np.abs(want).max()))


def test_unfused_tree_loads_and_matches_jax_forward(jax_ref):
    """The unfused JAX attention (WindowAttention_0: Dense_0, Dense_1) loads
    strictly into the same module, and the port's output matches both JAX
    models (``fused_attention`` has no effect on the port)."""
    sd, _, x, want_fused = jax_ref
    params = jax_params(sd, CFG, fused=False)
    cfg = dict(CFG, fused_attention=False)
    jmodel = jax_build_model(dict(cfg), 1, 1, precision="f32")
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    got = _run(_port(cfg, params), x)
    tol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want_fused, rtol=0, atol=tol)


def test_bf16_forward_inside_the_envelope(jax_ref):
    """bf16 compute: rel_err(port_bf16, jax_f32) ≤ 2·rel_err(jax_bf16,
    jax_f32) + 1e-4 (the envelope of tests/test_winograd.py:
    test_winograd_bf16_noise_envelope), with the JAX model's own bf16 noise
    from its fused attention."""
    _, params, x, want = jax_ref
    jmodel = jax_build_model(dict(CFG), 1, 1, precision="bf16")
    jbf = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    got = _run(_port(CFG, params, "bf16"), x)
    assert got.dtype == np.float32
    rel = lambda a: float(np.abs(a - want).max() / np.abs(want).max())
    assert 0 < rel(got) <= 2 * rel(jbf) + 1e-4, (rel(got), rel(jbf))


def test_train_steps_match_jax(jax_ref):
    """Three Adam steps (lr 1e-3) through build_optimizer → build_train_step
    against the JAX train step on the fused tree: losses within rtol 1e-5,
    parameters within the bar of tests/test_torch_train.py (rtol 5e-4,
    atol 5e-6), with its straggler bound for elements where Adam's
    normalised update amplifies f32 summation-order drift (one element of
    28149 here, at 1.1× the tolerance; the JAX package bounds its own
    transformer, ESRT, the same way in tests/test_train_parity.py)."""
    sd, params, _, _ = jax_ref
    rng = np.random.default_rng(SEED + 1)
    hr = rng.normal(size=(STEPS, 2, 1, 32, 32)).astype(np.float32)
    weight = np.ones(2, np.float32)
    jmodel = jax_build_model(dict(CFG), 1, 1, precision="f32")
    opt = optax.adam(TASK["lr"])
    state = jstep.SRTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={}, opt_state=opt.init(params))
    jtrain = jstep.build_train_step(jmodel, opt, jstep.make_step_config(
        _Cfg(TASK), _Cfg(CFG), has_bn=False))
    model = build_model(CFG, 1, 1, "f32", device="cpu")
    model.load_state_dict(sd)
    train = tstep.build_train_step(model, tstep.build_optimizer(model, TASK),
                                   tstep.make_step_config(TASK, CFG))
    for i in range(STEPS):
        state, jmet = jtrain(state, jnp.asarray(hr[i]), jnp.asarray(weight))
        met = train(torch.from_numpy(hr[i]), torch.from_numpy(weight))
        for k in ("mloss", "sloss", "interp_sloss"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    final = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, state.params)}, CFG)
    nviol, ntot, maxabs = 0, 0, 0.0
    for k, p in model.state_dict().items():
        a, b = p.numpy(), final[k].numpy()
        nviol += int((~np.isclose(a, b, rtol=5e-4, atol=5e-6)).sum())
        ntot += a.size
        maxabs = max(maxabs, float(np.abs(a - b).max()))
    assert nviol <= max(1, 1e-4 * ntot), f"{nviol}/{ntot} violations"
    assert maxabs < STEPS * TASK["lr"] * 1.5, maxabs


def test_window16_matches_jax_forward_and_step_gradients():
    """16×16 windows (T = 256; on the card the tiled kernels): nfeatures 16,
    1 group of 2 blocks (the second shifted by 8), 2 heads, a 32×32 LR tile.
    An unfused JAX tree (``fused_attention: false``: the JAX SwinIR runs its
    plain attention, no Pallas) loads strictly; the f32 forward is within
    2e-5·max of the JAX model's, and one step's loss (rtol 1e-5) and every
    parameter's gradient (rtol 5e-4, atol 5e-6, the trajectory test's bar)
    match jax.value_and_grad of the JAX step's loss. The module serves (in
    inference mode) before it trains, so its cached shifted-window masks
    must be ones autograd can save."""
    from sres_tpu.trainer.losses import sr_loss as jax_sr_loss
    from sres_tpu_torch.trainer.losses import sr_loss
    cfg = dict(CFG, window_size=16, fused_attention=False)
    sd = build_model(cfg, 1, 1, "f32", seed=SEED, device="cpu").state_dict()
    params = jax_params(sd, cfg, fused=False)
    model = _port(cfg, params)
    blocks = model.layers[0].residual_group.blocks
    assert [(b.attn.window_size, b.shift) for b in blocks] == [(16, 0), (16, 8)]
    rng = np.random.default_rng(SEED + 2)
    x = rng.normal(size=(1, 32, 32, 1)).astype(np.float32)
    jmodel = jax_build_model(dict(cfg), 1, 1, precision="f32")
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_run(model, x), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))

    hr, weight = rng.normal(size=(1, 1, 128, 128)).astype(np.float32), np.ones(1, np.float32)
    jsc = jstep.make_step_config(_Cfg(TASK), _Cfg(cfg), has_bn=False)

    def jax_loss(p):
        lr, target = jstep.prepare_inputs(jnp.asarray(hr), jsc)
        return jax_sr_loss(jmodel.apply({"params": p}, lr), target, jnp.asarray(weight),
                           jsc.loss_fn)[1]

    jl, jg = jax.jit(jax.value_and_grad(jax_loss))(params)
    sc = tstep.make_step_config(TASK, cfg)
    lr, target = tstep.prepare_inputs(torch.from_numpy(hr), sc)
    loss = sr_loss(model(lr), target, torch.from_numpy(weight), sc.loss_fn)[1]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want_g = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg)}, cfg)
    for k, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_g[k].numpy(), rtol=5e-4,
                                   atol=5e-6, err_msg=k)


def test_build_model_defaults_and_device(monkeypatch):
    """The JAX defaults (window 8, 4 heads, mlp_ratio 2, 2 blocks) and the
    card as the default device."""
    model = build_model(dict(name="swinir", nfeatures=64, nlayers=1), 1, 1,
                        "bf16", device="cpu")
    blocks = model.layers[0].residual_group.blocks
    assert len(blocks) == 2 and [b.shift for b in blocks] == [0, 4]
    attn = blocks[0].attn
    assert (attn.window_size, attn.num_heads) == (8, 4)
    assert blocks[0].mlp.fc1.out_features == 128
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build_model(CFG, 1, 1, "f32")
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 1, 12, 12))


def test_chip_smoke_swinir_config_is_the_yaml():
    """chip_smoke's SwinIR phases run config/model/swinir.yaml on
    config/task/SST-tiles-96.yaml's tile, batch and lr."""
    import sys
    from pathlib import Path
    import yaml
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    assert chip_smoke.SWIN_CFG == yaml.safe_load((root / "config/model/swinir.yaml").read_text())
    task = yaml.safe_load((root / "config/task/SST-tiles-96.yaml").read_text())
    assert chip_smoke.SWIN_BATCH == task["batch_size"]
    assert chip_smoke.TILE96 == task["tile_size"]["x"] == task["tile_size"]["y"]
    assert chip_smoke.SWIN_TRAIN_TASK["lr"] == float(task["lr"])
    assert chip_smoke.SWIN_NW == 1728


def test_chip_smoke_swinir_w16_config_is_the_yaml_but_its_window():
    """chip_smoke's phases 22-24 run config/model/swinir.yaml with only
    ``window_size`` changed, to 16 (set in code): 432 windows of 256 tokens
    at SST-tiles-96's batch of 12."""
    import sys
    from pathlib import Path
    import yaml
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    want = yaml.safe_load((root / "config/model/swinir.yaml").read_text())
    got = dict(chip_smoke.SWIN16_CFG)
    assert (got.pop("window_size"), want.pop("window_size")) == (16, 8)
    assert got == want
    assert chip_smoke.SWIN16_NW == 432
