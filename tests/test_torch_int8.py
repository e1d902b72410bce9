"""The port's quantized convs and models (``model.quantization``: int8,
int8_fused, int8_full) against sres_tpu on the CPU, where the port runs its
kernels' plain twins.

Per conv, on the same numpy inputs: the forward and both gradients of
int8_fused and int8_full, and AQT's forward. On lossless integer data
(tests/test_int8_conv.py's recipe: every scale group's absmax is 127, so
every scale is 1) all of them are bit-equal. On Gaussian data the forward
and int8_full's dx and dw are bit-equal too (the integer sums are exact on
both sides and every rounding step is the same); int8_fused's backward runs
two native bf16 convs whose f32 sums are taken in another order than XLA's,
so its gradients may differ by one bf16 ulp. Lane packing: JAX quantizes
the packed image (pairs of tiles share a scale), the port scale groups of
two tiles; batches 3 and 4. Tiny RCAN, EDSR and VDSR: the f32 forward
within 1e-5 relative L2 of JAX's in every mode (measured 2e-8 to 1.4e-7:
the models' full-precision convs sum in another order; one conv left
unquantized moves it by 0.9e-3 to 3.1e-3, scale groups of one tile by
2.1e-3), the quantized convs named as JAX quantizes them (a quantized CA
conv would move the tiny RCAN's forward by less than 1e-7), and 3-step Adam
trajectories (RCAN under int8_fused and int8_full, VDSR under int8_full)
within 1e-4 relative (measured at most 1.9e-5, RCAN int8_full: a
cotangent's quantization step flips on the f32 roundoff, and Adam's first
updates are ±lr whatever a gradient's size). A tiny RCAN with ``fused:
true`` (groups unquantized, the body conv quantized over pairs of tiles,
JAX's interpret-mode group kernel) within 1e-5 too (measured 7.9e-7;
scale groups of one tile: 3.6e-3). remat on and off give the same bits;
AQT serves and refuses to train.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from sres_tpu.models import build_model as jax_build_model
from sres_tpu.models.fused import rcan_params_to_fused
from sres_tpu.models.layers import aqt_conv_fn, pack_tiles, unpack_tiles
from sres_tpu.ops.int8_conv import int8_conv, int8_conv_full
from sres_tpu.util.torch_import import import_variables
from sres_tpu_torch.models import build_model
from sres_tpu_torch.models.layers import Conv
from sres_tpu_torch.ops import int8_conv as q8
from sres_tpu_torch.util.weights import state_dict_from_jax

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative, at most


def _int_data(rng, shape, per_channel=False):
    """Integers in [-100, 100) with |max| exactly 127 on every scale group:
    per sample (dim 0), or per output and input channel of a (O, I, k, k)
    weight (tests/test_int8_conv.py:_int_data)."""
    a = rng.integers(-100, 100, size=shape).astype(np.float32)
    if per_channel:
        a[:, 0, 0, 0] = 127.0
        a[0, :, 0, 0] = 127.0
    else:
        a[:, 0, 0, 0] = 127.0
    return a


def _nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _hwio(w):
    return jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 1, 0)))


# JAX's references are compiled as the source reads: by default XLA's CPU
# compiler drops the bf16 rounding of the int8 conv's output (``.astype(
# f32)`` of a bf16 conv: the tiny RCAN's int8_fused forward then moves
# 2.9e-3 relative L2 from its op-by-op run), and its algebraic simplifier
# reassociates products (AQT's (sum·sx)·sw, int8_full's per-slot S_j·sgp)
# within an f32 ulp. With excess precision and the simplifier off the
# compiled convs give the op-by-op run's bits, and compile far faster than
# op-by-op runs the ops; the models' int8_fused and int8_full references
# need only the rounding (their forwards then agree with the op-by-op runs
# within 2e-7); AQT's needs both (with the simplifier on, the tiny RCAN's
# forward moves 2.9e-4 from the port's, one rounding flipped).
NO_EXCESS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
STRICT = dict(NO_EXCESS, xla_disable_hlo_passes="algsimp")
_COMPILED = {}


def _strict_jit(key, fn, *args, options=STRICT):
    """``fn`` jitted and compiled once per key and argument shapes."""
    k = (key,) + tuple((a.shape, a.dtype) for a in jax.tree_util.tree_leaves(args))
    if k not in _COMPILED:
        _COMPILED[k] = jax.jit(fn).lower(*args).compile(compiler_options=options)
    return _COMPILED[k](*args)


def _jax_conv_fn(mode, b, pack, dtype):
    k, pad = 3, ((1, 1), (1, 1))

    def f(xh, wh):
        if pack > 1:
            bpad = (-b) % pack
            xh = jnp.concatenate([xh, jnp.zeros((bpad,) + xh.shape[1:], xh.dtype)])
            xh = pack_tiles(xh, pack)
            zero = jnp.zeros_like(wh)
            wh = jnp.concatenate([jnp.concatenate([wh if i == j else zero for j in range(pack)],
                                                  axis=3) for i in range(pack)], axis=2)
        xh, wh = xh.astype(dtype), wh.astype(dtype)
        if mode == "int8_fused":
            y = int8_conv(xh, wh.astype(jnp.float32), pad)
        elif mode == "int8_full":
            y = int8_conv_full(xh.astype(jnp.float32), wh.astype(jnp.float32), pad)
        else:
            dn = lax.conv_dimension_numbers(xh.shape, wh.shape, ("NHWC", "HWIO", "NHWC"))
            y = aqt_conv_fn()(xh, wh, (1, 1), pad, dimension_numbers=dn)
        y = y.astype(dtype)
        if pack > 1:
            y = unpack_tiles(y, pack)[:b]
        return y.astype(jnp.float32)

    if mode == "int8":
        return f

    def fwd_bwd(xh, wh, gh):
        y, vjp = jax.vjp(f, xh, wh)
        return (y,) + vjp(gh)
    return fwd_bwd


def _jax_conv(mode, x, w, g, pack=1, dtype=jnp.float32):
    """sres_tpu's quantized 3×3 conv of NCHW x, OIHW w, as the models call
    it (lane-packed when ``pack`` > 1); returns NCHW (y, dx, dw) in f32
    (dx, dw None for AQT)."""
    fn = _jax_conv_fn(mode, x.shape[0], pack, dtype)
    args = (_nhwc(x), _hwio(w)) + ((_nhwc(g),) if mode != "int8" else ())
    out = _strict_jit(("conv", mode, pack, str(dtype)), fn, *args)
    if mode == "int8":
        return np.asarray(out).transpose(0, 3, 1, 2), None, None
    y, dx, dw = out
    return (np.asarray(y).transpose(0, 3, 1, 2), np.asarray(dx).transpose(0, 3, 1, 2),
            np.asarray(dw).transpose(3, 2, 0, 1))


def _port_conv(mode, x, w, g, pack=1, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(mode != "int8")
    wt = torch.from_numpy(w).requires_grad_(mode != "int8")
    if mode == "int8":
        with torch.no_grad():
            return q8.quant_conv(xt, wt, None, mode, pack).float().numpy(), None, None
    y = q8.quant_conv(xt, wt, None, mode, pack)
    y.backward(torch.from_numpy(g).to(dtype))
    return y.detach().float().numpy(), xt.grad.float().numpy(), wt.grad.numpy()


def _within_ulp(got, want):
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-30), \
        float(np.max(np.abs(got - want) / (np.abs(want) + 1e-30)))


# the lane-packed convs' shapes, so that the op-by-op references share
# their compiled ops with the lane-packing cases
SHAPE, WSHAPE = (2, 16, 6, 6), (16, 16, 3, 3)


@pytest.mark.parametrize("mode", ["int8_fused", "int8_full", "int8"])
def test_conv_bit_equal_on_lossless_integer_data(mode):
    rng = np.random.default_rng(0)
    x = _int_data(rng, SHAPE)
    w = _int_data(rng, WSHAPE, per_channel=True)
    g = _int_data(rng, SHAPE)
    for got, want in zip(_port_conv(mode, x, w, g), _jax_conv(mode, x, w, g)):
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["int8_fused", "int8_full"])
def test_conv_gaussian(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=SHAPE).astype(np.float32)
    w = (rng.normal(size=WSHAPE) * 0.1).astype(np.float32)
    g = rng.normal(size=SHAPE).astype(np.float32)
    (y, dx, dw), (yj, dxj, dwj) = _port_conv(mode, x, w, g), _jax_conv(mode, x, w, g)
    np.testing.assert_array_equal(y, yj)
    if mode == "int8_full":
        np.testing.assert_array_equal(dx, dxj)
        np.testing.assert_array_equal(dw, dwj)
    else:
        _within_ulp(dx, dxj)
        _within_ulp(dw, dwj)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aqt_conv_gaussian(dtype):
    """AQT's forward, bit-equal: both sides round the exact integer sum to
    the conv's dtype and dequantise in the scales' dtype, step by step."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=SHAPE).astype(np.float32)
    w = (rng.normal(size=WSHAPE) * 0.1).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = _port_conv("int8", x, w, None, dtype=tdt)[0]
    want = _jax_conv("int8", x, w, None, dtype=jdt)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["int8_fused", "int8_full", "int8"])
@pytest.mark.parametrize("batch", [3, 4])
def test_lane_pack_scale_groups(mode, batch):
    """lane_pack: 2 — JAX quantizes the packed image (a pair of tiles, an odd
    batch's last tile with a zero tile), the port groups of two tiles; the
    weight gradient rounds per pack slot. Tiles of very different sizes, so
    that a per-tile scale would differ."""
    rng = np.random.default_rng(3 + batch)
    x = (rng.normal(size=(batch, 8, 6, 6))
         * rng.uniform(0.1, 3.0, size=(batch, 1, 1, 1))).astype(np.float32)
    w = (rng.normal(size=(8, 8, 3, 3)) * 0.2).astype(np.float32)
    g = rng.normal(size=(batch, 8, 6, 6)).astype(np.float32)
    got, want = _port_conv(mode, x, w, g, pack=2), _jax_conv(mode, x, w, g, pack=2)
    np.testing.assert_array_equal(got[0], want[0])
    if mode == "int8_full":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    elif mode == "int8_fused":
        _within_ulp(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=2 * BF16_ULP * float(np.abs(want[2]).max()))


def test_quantize_twin_scale_kinds():
    """``quantize``'s twin at every scale-group kind: the scale and q
    reproduce the amax recipe, q·scale stays within half a scale of t."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.normal(size=(5, 4, 3, 3)).astype(np.float32))
    pre = torch.from_numpy(rng.uniform(0.5, 2, size=5).astype(np.float32))
    for group, flip, p in ((2, False, None), (1, False, None), (1, True, None),
                           (None, False, pre)):
        q, s = q8.quantize(t, group, flip=flip, pre=p)
        ref = t.flip(2, 3) if flip else t
        ref = ref * p.reshape(-1, 1, 1, 1) if p is not None else ref
        n = s.numel()
        assert n == {2: 3, 1: 5, None: 1}[group]
        rows = q8._rows(s, group or 5, 5).reshape(-1, 1, 1, 1)
        assert float(q.abs().max()) == 127.0 and torch.equal(q, q.round())
        assert float(((q * rows - ref).abs() / rows).max()) <= 0.5 + 1e-6


# ------------------------------------------------------------ tiny models
MODEL_CFGS = {
    "rcan": dict(name="rcan", nfeatures=8, nlayers=1, nblocks=2, cbottleneck=2,
                 kernel_size=3, downscale_factors=[2, 2], lane_pack=2),
    "edsr": dict(name="edsr", nfeatures=8, nlayers=2, kernel_size=3,
                 downscale_factors=[2, 2], lane_pack=2),
    "vdsr": dict(name="vdsr", nfeatures=8, nlayers=3, kernel_size=3,
                 downscale_factors=[2, 2]),
}
NSTEP, LR = 3, 1e-3


def _quantized_convs(name):
    """The convs that JAX quantizes (sres_tpu/models/rcan.py:147-161,
    edsr.py:110-119, vdsr.py:28-35), by the port's parameter names."""
    c = MODEL_CFGS[name]
    if name == "rcan":
        nb = c["nblocks"]
        return ({f"body.{g}.body.{b}.body.{i}" for g in range(c["nlayers"])
                 for b in range(nb) for i in (0, 2)}
                | {f"body.{g}.body.{nb}" for g in range(c["nlayers"])}
                | {f"body.{c['nlayers']}"})
    if name == "edsr":
        return ({f"body.{b}.body.{i}" for b in range(c["nlayers"]) for i in (0, 2)}
                | {f"body.{c['nlayers']}"})
    return {f"body.{i}.0" for i in range(c["nlayers"] - 1)}


def _data():
    rng = np.random.default_rng(11)
    lr = rng.normal(size=(3, 1, 8, 8)).astype(np.float32)
    hr = rng.normal(size=(3, 1, 32, 32)).astype(np.float32)
    return lr, hr


# the trajectories: RCAN's two trainable modes (the native bf16 backward,
# and the s8 dx and dw with remat by default), VDSR's int8_full (the cin-1
# weight gradient, a first conv with no dx); EDSR's blocks are RCAN's
# convs, so its pairs and VDSR's int8_fused hold the forward only (the
# per-conv cases above hold every gradient bit for bit)
TRAJECTORIES = {("rcan", "int8_fused"), ("rcan", "int8_full"), ("vdsr", "int8_full")}


@pytest.fixture(scope="module")
def jax_runs():
    """Per model and mode, JAX's f32 forward of the seeded weights and, for
    the TRAJECTORIES pairs, the losses of 3 Adam steps on the l2 loss (one
    strictly compiled step a pair: with XLA's default excess precision the
    tiny RCAN's int8_fused forward moves 2.9e-3 relative L2 from the
    op-by-op run, which the port's matches within 2e-7)."""
    lr, hr = _data()
    lrh, hrh = _nhwc(lr), _nhwc(hr)
    out = {}
    for name, base in MODEL_CFGS.items():
        sd = build_model(base, 1, 1, "f32", seed=7, device="cpu").state_dict()
        variables = import_variables(name, {k: v.numpy() for k, v in sd.items()}, base)
        for mode in q8.MODES:
            cfg = dict(base, quantization=mode)
            model = jax_build_model(dict(cfg), 1, 1, precision="f32")
            if (name, mode) not in TRAJECTORIES:
                y = _strict_jit((name, mode), model.apply, variables, lrh,
                                options=STRICT if mode == "int8" else NO_EXCESS)
                out[name, mode] = (variables, np.asarray(y), None)
                continue
            opt = optax.adam(LR)

            def loss_fn(p, v=variables, model=model):
                y = model.apply({**v, "params": p}, lrh)
                return jnp.mean(jnp.square(y - hrh)), y

            def step(p, s):
                (loss, y), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
                upd, s = opt.update(grads, s, p)
                return optax.apply_updates(p, upd), s, loss, y

            p, s, losses, y0 = variables["params"], opt.init(variables["params"]), [], None
            for i in range(NSTEP):
                p, s, loss, y = _strict_jit((name, mode), step, p, s, options=NO_EXCESS)
                losses.append(float(loss))
                y0 = np.asarray(y) if i == 0 else y0
            out[name, mode] = (variables, y0, losses)
    return out


def _port_model(cfg, variables):
    m = build_model(cfg, 1, 1, "f32", device="cpu")
    m.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return m


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", q8.MODES)
@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_tiny_model_matches_jax(jax_runs, name, mode):
    variables, want, losses = jax_runs[name, mode]
    cfg = dict(MODEL_CFGS[name], quantization=mode)
    model = _port_model(cfg, variables)
    assert {n for n, m in model.named_modules()
            if isinstance(m, Conv) and m.quant == mode} == _quantized_convs(name)
    lr, hr = _data()
    x = torch.from_numpy(lr)
    if losses is None:
        with torch.no_grad():
            got = model(x).numpy().transpose(0, 2, 3, 1)
        assert _rel_l2(got, want) < 1e-5
        return
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    got_losses = []
    for i in range(NSTEP):
        opt.zero_grad()
        y = model(x)
        loss = (y - torch.from_numpy(hr)).square().mean()
        loss.backward()
        opt.step()
        got_losses.append(loss.item())
        if i == 0:
            assert _rel_l2(y.detach().numpy().transpose(0, 2, 3, 1), want) < 1e-5
    np.testing.assert_allclose(got_losses, losses, rtol=1e-4)


def test_fused_rcan_quantizes_the_body_conv_over_pairs():
    """``fused: true`` with int8_fused: the groups run unquantized (JAX's
    interpret-mode group kernel against the port's twins) and only the body
    conv is quantized, over the pairs JAX packs (batch 3: the last pair is
    one tile and JAX's zero tile). Tiles of very different sizes, so that
    a per-tile scale would differ. The f32 forward within 1e-5 relative L2
    of JAX's."""
    cfg = dict(MODEL_CFGS["rcan"], nfeatures=64, nblocks=1, fused=True,
               quantization="int8_fused")
    sd = build_model(dict(cfg, fused=False, quantization=None), 1, 1, "f32", seed=7,
                     device="cpu").state_dict()
    variables = import_variables("rcan", {k: v.numpy() for k, v in sd.items()}, cfg)
    params = {"params": rcan_params_to_fused(variables["params"], 1, 1)}
    rng = np.random.default_rng(13)
    lr = (rng.normal(size=(3, 1, 8, 8))
          * rng.uniform(0.2, 3.0, size=(3, 1, 1, 1))).astype(np.float32)
    model = jax_build_model(dict(cfg), 1, 1, precision="f32")
    want = np.asarray(_strict_jit(("fused",), model.apply, params, _nhwc(lr),
                                  options=NO_EXCESS))
    port = _port_model(cfg, params)
    assert port.fused and port.body[-1].quant == "int8_fused" and port.body[-1].pack == 2
    with torch.no_grad():
        got = port(torch.from_numpy(lr)).numpy().transpose(0, 2, 3, 1)
    assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("mode", ["int8_fused", "int8_full"])
def test_remat_trunk_bit_identical(mode):
    """remat_trunk (each residual group checkpointed) gives the same loss
    and gradients, bit for bit, as the same step without it."""
    lr, hr = _data()
    res = []
    for remat in (True, False):
        cfg = dict(MODEL_CFGS["rcan"], nlayers=2, quantization=mode, remat_trunk=remat)
        model = build_model(cfg, 1, 1, "f32", seed=3, device="cpu")
        assert model.remat == remat
        loss = (model(torch.from_numpy(lr)) - torch.from_numpy(hr)).square().mean()
        loss.backward()
        res.append((loss.detach(), [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
    # int8_full turns it on by default, int8_fused leaves it off
    dflt = build_model(dict(MODEL_CFGS["rcan"], quantization=mode), 1, 1, "f32", device="cpu")
    assert dflt.remat == (mode == "int8_full")


def test_aqt_serves_and_refuses_to_train(monkeypatch):
    """int8 serves through the eval step (inference mode); a forward that
    records gradients raises JAX's serving-only error, and so does
    ModelTrainer.train, as a ValueError, before its first step."""
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
    cfg = dict(MODEL_CFGS["edsr"], quantization="int8")
    model = build_model(cfg, 1, 1, "f32", seed=0, device="cpu")
    sc = make_step_config(dict(input_variables=["SST"], target_variables=["SST"],
                               downsample_mode="cubic", upsample_mode="cubic"), cfg)
    hr = torch.from_numpy(_data()[1])
    met, (lr, out, tar, interp) = build_eval_step(model, sc)(hr, torch.ones(3))
    assert out.shape == (3, 1, 32, 32) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="SERVING-ONLY"):
        model(lr.clone())
    from types import SimpleNamespace
    from sres_tpu_torch.trainer import trainer as tmod
    monkeypatch.setattr(tmod, "cfg", lambda: SimpleNamespace(model=cfg))
    with pytest.raises(ValueError, match="SERVING-ONLY"):
        tmod.ModelTrainer.__new__(tmod.ModelTrainer).train(1)


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_unknown_mode_raises(name):
    with pytest.raises(ValueError, match="Unknown quantization mode"):
        build_model(dict(MODEL_CFGS[name], quantization="int4"), 1, 1, "f32", device="cpu")
