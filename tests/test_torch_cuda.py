"""The port's CUDA kernels (forward and backward: the Winograd conv with its
scaled residual epilogue, the conv chain, channel attention, the ungated
group of EDSR's trunk, the window attention, the direct-conv group kernels
of ``model.fused``, the int8 kernels of ``model.quantization``) against
their plain twins, on the card.

Imports no JAX, so it runs on a machine that has only torch and a card;
tests/conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a card. Tolerances: f32 max|kernel − twin| ≤
3e-5·max|twin|; bf16 rel_err(kernel, f32 twin) ≤ 2·rel_err(bf16 twin, f32
twin) + 1e-4 (the envelope of tests/test_winograd.py:
test_winograd_bf16_noise_envelope). The int8 kernels are bit-equal to
their twins (exact integer sums, the same rounding steps).
"""
import numpy as np
import pytest
import torch

from sres_tpu_torch.ops import winograd_conv as twc
from sres_tpu_torch.ops.winograd import transform_weights


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False       # the direct-conv twins' F.conv2d
    return torch.device("cuda")


def _t(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)


def _rel(a, ref):
    return float((a.float() - ref).abs().max() / ref.abs().max())


def _check(kernel, plain, args32, argsbf):
    k32, p32 = kernel(*args32), plain(*args32)
    torch.cuda.synchronize()
    assert float((k32 - p32).abs().max()) <= 3e-5 * float(p32.abs().max())
    kbf, pbf = kernel(*argsbf), plain(*argsbf)
    torch.cuda.synchronize()
    assert kbf.dtype == torch.bfloat16
    assert _rel(kbf, p32) <= 2 * _rel(pbf, p32) + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("relu,res", [(False, False), (True, True)])
def test_wino_conv_matches_twin(dev, m, relu, res):
    rng = np.random.default_rng(m)
    x, r = _t(rng, (5, 64, 16, 24), dev), _t(rng, (5, 64, 16, 24), dev)
    w, b = _t(rng, (64, 64, 3, 3), dev, 0.04), _t(rng, (64,), dev, 0.04)
    launches = twc.LAUNCHES["wino_conv"]
    _check(lambda x_, r_: twc.wino_conv(x_, w, b, m, relu, r_ if res else None),
           lambda x_, r_: twc.wino_conv_plain(x_, w, b, m, relu, r_ if res else None),
           (x, r), (x.bfloat16(), r.bfloat16()))
    assert twc.LAUNCHES["wino_conv"] == launches + 2


_MODES = {"bias": (False, None), "relu": (True, None), "res1": (False, 1.0),
          "res01": (False, 0.1), "relu_res07": (True, 0.7)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 64, 16, 24), (1, 64, 8, 8), (72, 64, 48, 48)])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mode", list(_MODES))
def test_wino_conv_every_mode_matches_twin(dev, shape, m, mode):
    """The bf16 conv (clusters of two blocks, each with half of U resident,
    a partial unit at the end of each cluster's range) and the f32 kernel
    against the twin in every epilogue mode: bias only, ReLU, the residual
    at res_scale 1.0 and 0.1, ReLU with the residual; at the card tests'
    shape, at (1, 64, 8, 8) (4 tiles at m=4) and at the flagship's."""
    relu, res_scale = _MODES[mode]
    rng = np.random.default_rng(80 + m)
    x, r = _t(rng, shape, dev), _t(rng, shape, dev)
    w, b = _t(rng, (64, 64, 3, 3), dev, 0.04), _t(rng, (64,), dev, 0.04)
    res = res_scale is not None
    sc = res_scale if res else 1.0
    _check(lambda x_, r_: twc.wino_conv(x_, w, b, m, relu, r_ if res else None, sc),
           lambda x_, r_: twc.wino_conv_plain(x_, w, b, m, relu, r_ if res else None, sc),
           (x, r), (x.bfloat16(), r.bfloat16()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_wino_conv_is_deterministic_and_order_blind(dev, m):
    """Two calls give the same bits; U spatial, natural or already in the
    kernels' orders (a ``WinoU``, as the module caches keep it) gives the
    same bits, forward and adjoint."""
    rng = np.random.default_rng(90 + m)
    x, g = _t(rng, (72, 64, 48, 48), dev), _t(rng, (72, 64, 48, 48), dev)
    w, b = _t(rng, (64, 64, 3, 3), dev, 0.04), _t(rng, (64,), dev, 0.04)
    for dt in (torch.float32, torch.bfloat16):
        xx, gg = x.to(dt), g.to(dt)
        u = transform_weights(w, m).to(dt)
        ku = twc.kernel_u(u)
        ys = [twc.wino_conv(xx, op, b, m, True) for op in (w, u, ku, ku)]
        dxs = [twc.wino_conv_bwd(gg, xx, op, m) for op in (w, u, ku)]
        torch.cuda.synchronize()
        assert all(torch.equal(y, ys[0]) for y in ys[1:])
        for dx in dxs[1:]:
            assert all(torch.equal(a, c) for a, c in zip(dx, dxs[0]))


@pytest.mark.cuda
def test_cached_wino_conv_is_one_launch(dev):
    """A cached module's conv call is one kernel launch, with no reorder or
    copy of U (the profiler's device kernels of one forward); the adjoint
    takes the cached Uᵀ as it is."""
    from sres_tpu_torch.models.wino_blocks import WinoConv
    conv = WinoConv(64, 64, 4).to(dev)
    x = torch.randn(8, 64, 16, 16, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        conv(x)                                       # builds the cache
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launches = twc.LAUNCHES["wino_conv"]
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        conv(x)
        torch.cuda.synchronize()
    assert twc.LAUNCHES["wino_conv"] == launches + 1
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "wino_conv_wgmma_kernel" in kernels[0], kernels
    ku = conv._u(torch.bfloat16, kernel=True)
    assert isinstance(ku, twc.WinoU)
    assert twc._operand(ku, 4, x, 64) is ku.fwd
    assert twc._operand(ku, 4, x, 64, bwd=True) is ku.bwd


# (T, C, H, W) of the channel-attention cases: the flagship's batch, one
# sample of it, samples too large for a cluster's shared memory, an odd hw
# (117 pixels), and a small batch
_CA_SHAPES = {"b72": (72, 64, 48, 48), "n1": (1, 64, 48, 48), "large": (2, 64, 192, 192),
              "odd": (3, 64, 9, 13), "small": (3, 64, 16, 32)}
# the cluster size ca_skip's kernel takes for each, (bf16, f32); 0: the
# two-pass kernel
_CA_CLUSTER = {"b72": (4, 8), "n1": (4, 8), "large": (0, 0), "odd": (1, 1), "small": (1, 2)}


def _ca_weights(rng, dev, hidden):
    return [_t(rng, s, dev, 0.1) for s in ((hidden, 64), (hidden,), (64, hidden), (64,))]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [4, 32, 64])
@pytest.mark.parametrize("case", list(_CA_SHAPES))
def test_ca_skip_matches_twin(dev, case, hidden):
    """ca_skip on the cluster kernel (r read once) and on the two-pass
    kernel, at the cluster size each shape takes: against the twin in f32
    and bf16, one launch a call, the same bits on two calls."""
    from sres_tpu_torch.ops import cuda
    shape = _CA_SHAPES[case]
    rng = np.random.default_rng(10 + hidden)
    q, r = _t(rng, shape, dev), _t(rng, shape, dev) + 0.3
    ca = _ca_weights(rng, dev, hidden)
    lib = cuda.load()
    hw = shape[2] * shape[3]
    assert tuple(lib.sres_ca_skip_cluster(shape[0], hw, bf, 0) for bf in (1, 0)) == \
        _CA_CLUSTER[case]
    launches = twc.LAUNCHES["ca_skip"]
    _check(lambda q_, r_: twc.ca_skip(q_, r_, *ca),
           lambda q_, r_: twc.ca_skip_plain(q_, r_, *ca),
           (q, r), (q.bfloat16(), r.bfloat16()))
    assert twc.LAUNCHES["ca_skip"] == launches + 2
    for dt in (torch.float32, torch.bfloat16):
        qq, rr = q.to(dt), r.to(dt)
        first, second = twc.ca_skip(qq, rr, *ca), twc.ca_skip(qq, rr, *ca)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_channel_attention_is_one_kernel_launch(dev):
    """At the flagship's shape in bf16, ca_skip is one ca_cluster_kernel
    launch, fgroup_ca one fg_ca_stream_kernel launch, and the backwards
    ca_skip_bwd and fgroup_ca_bwd one ca_skip_bwd_kernel and one
    fg_ca_bwd_kernel launch (the profiler's device kernels of one call,
    operands already channels_last)."""
    from sres_tpu_torch.ops import fused_group as fg
    rng = np.random.default_rng(12)
    cl = dict(memory_format=torch.channels_last)
    q, r = (_t(rng, _CA_SHAPES["b72"], dev).bfloat16().contiguous(**cl) for _ in range(2))
    c = _t(rng, _CA_SHAPES["b72"], dev).contiguous(**cl)
    part = _t(rng, (72, 18, 64), dev)
    ca = _ca_weights(rng, dev, 32)
    gate = _t(rng, (72, 64), dev).sigmoid()
    calls = {"ca_cluster_kernel": lambda: twc.ca_skip(q, r, *ca),
             "fg_ca_stream_kernel": lambda: fg.fgroup_ca(q, c, part, *ca, stash_c=True),
             "ca_skip_bwd_kernel": lambda: twc.ca_skip_bwd(c, r, *ca),
             "fg_ca_bwd_kernel": lambda: fg.fgroup_ca_bwd(q, r, gate, *ca)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0], kernels


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    w = torch.zeros(32, 32, 3, 3, device=dev)
    with pytest.raises(ValueError):
        twc.wino_conv(torch.zeros(1, 32, 8, 8, device=dev), w, None, 4)
    with pytest.raises(TypeError):
        twc.wino_conv(torch.zeros(1, 64, 8, 8, device=dev, dtype=torch.float16),
                      torch.zeros(64, 64, 3, 3, device=dev), None, 4)


def _check_many(name, k32, p32, kbf, pbf):
    """Output by output: the f32 bound and the bf16 envelope. An output that
    is zero in f32 (a channel-attention gradient whose hidden units are all
    shut) must be zero in the f32 kernel, and in bf16 within twice the bf16
    twin's distance from zero (the envelope in absolute terms)."""
    torch.cuda.synchronize()
    for i, (a, b, c, d) in enumerate(zip(k32, p32, kbf, pbf)):
        assert float((a - b).abs().max()) <= 3e-5 * float(b.abs().max()), (name, i)
        if float(b.abs().max()) == 0.0:
            assert float(c.abs().max()) <= 2 * float(d.abs().max()), (name, i)
            continue
        assert _rel(c, b) <= 2 * _rel(d, b) + 1e-4, (name, i, _rel(c, b), _rel(d, b))


# (T, C, H, W) per m: "even" fills every band; "ragged" leaves the last
# band of tile rows short (m=4: 5 x 11 tiles; m=2: 11 x 23); "wide" cuts
# the image into column strips (25 and 50 tiles a row)
_BWD_SHAPES = {"even": {2: (5, 64, 16, 24), 4: (5, 64, 16, 24)},
               "ragged": {2: (3, 64, 22, 46), 4: (3, 64, 20, 44)},
               "wide": {2: (2, 64, 12, 100), 4: (2, 64, 12, 100)}}


def _bwd_operands(rng, shape, dev, m):
    cl = dict(memory_format=torch.channels_last)
    x, g = _t(rng, shape, dev), _t(rng, shape, dev)
    w = _t(rng, (64, 64, 3, 3), dev, 0.04)
    y = twc.wino_conv_plain(x, w, _t(rng, (64,), dev, 0.04), m, relu=True)
    gate = _t(rng, (shape[0], 64), dev).sigmoid()
    ds = _t(rng, (shape[0], 64), dev, 1e-3)
    prev = _t(rng, shape, dev).contiguous(**cl)
    return x, g, w, y, gate, ds, prev


def _bwd_run(fn, dt, mode, m, x, g, w, y, gate, ds, prev):
    """One call in a mode: plain (g in the activation dtype, or in f32 as
    EDSR's conv2 passes it), ReLU gate, CA prologue into an f32 dx, ReLU
    gate accumulated into an f32 buffer."""
    kw = {}
    if mode in ("relu", "accum"):
        kw["y"] = y.to(dt)
    if mode == "ca":
        kw.update(gate=gate, ds=ds)
    if mode == "accum":
        kw["dprev"] = prev.clone(memory_format=torch.channels_last)
    gg = g if mode in ("ca", "accum", "plain_f32g") else g.to(dt)
    return fn(gg, x.to(dt), w, m, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mode", ["plain", "plain_f32g", "relu", "ca", "accum"])
@pytest.mark.parametrize("shape", list(_BWD_SHAPES))
def test_wino_conv_bwd_matches_twin(dev, m, mode, shape):
    """The conv adjoint in each of its modes and layouts (bands, a short
    last band, column strips) against its twin."""
    rng = np.random.default_rng(20 + m)
    ops = _bwd_operands(rng, _BWD_SHAPES[shape][m], dev, m)
    launches = twc.LAUNCHES["wino_conv_bwd"]
    _check_many(f"m{m} {mode} {shape}",
                *(_bwd_run(fn, dt, mode, m, *ops)
                  for fn, dt in ((twc.wino_conv_bwd, torch.float32),
                                 (twc.wino_conv_bwd_plain, torch.float32),
                                 (twc.wino_conv_bwd, torch.bfloat16),
                                 (twc.wino_conv_bwd_plain, torch.bfloat16))))
    assert twc.LAUNCHES["wino_conv_bwd"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_wino_conv_bwd_is_deterministic(dev, dt):
    """Two calls in the accum mode at the flagship shape (72, 64, 48, 48),
    m=4, give the same bits: fixed-order sums, no atomics."""
    rng = np.random.default_rng(24)
    ops = _bwd_operands(rng, (72, 64, 48, 48), dev, 4)
    a = _bwd_run(twc.wino_conv_bwd, dt, "accum", 4, *ops)
    b = _bwd_run(twc.wino_conv_bwd, dt, "accum", 4, *ops)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [1, 4, 32, 64])
@pytest.mark.parametrize("case", list(_CA_SHAPES))
def test_ca_skip_bwd_matches_twin(dev, case, hidden):
    """The Winograd trunk's channel-attention backward (one cooperative
    launch) against its twin with c2 in f32 and bf16, at the channel-
    attention shapes and widths from 1 to the kernels' bound: the gate, ds
    and the four weight gradients; one launch a call; the same bits on two
    calls."""
    shape = _CA_SHAPES[case]
    rng = np.random.default_rng(30 + hidden)
    da, c2 = _t(rng, shape, dev), _t(rng, shape, dev) + 0.3
    ca = _ca_weights(rng, dev, hidden)
    launches = twc.LAUNCHES["ca_skip_bwd"]
    _check_many(f"ca_skip_bwd {case} {hidden}", twc.ca_skip_bwd(da, c2, *ca),
                twc.ca_skip_bwd_plain(da, c2, *ca),
                twc.ca_skip_bwd(da, c2.bfloat16(), *ca),
                twc.ca_skip_bwd_plain(da, c2.bfloat16(), *ca))
    assert twc.LAUNCHES["ca_skip_bwd"] == launches + 2
    for cc in (c2, c2.bfloat16()):
        first, second = twc.ca_skip_bwd(da, cc, *ca), twc.ca_skip_bwd(da, cc, *ca)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_group_gradients_match_twin(dev):
    """A 2-RCAB group with its trailing conv under autograd: every gradient
    through the kernels against the plain twins (f32 bound 1e-4·max)."""
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
    grp = init_torch_default(WinoResidualGroup(64, 2, 2, 4), 5).to(dev)
    rng = np.random.default_rng(31)
    x = _t(rng, (3, 64, 16, 16), dev).contiguous(memory_format=torch.channels_last)
    gy = _t(rng, (3, 64, 16, 16), dev)
    grads = {}
    for plain in (False, True):
        grp.plain = plain
        xx = x.clone().requires_grad_()
        gs = torch.autograd.grad((grp(xx) * gy).sum(), [xx, *grp.parameters()])
        grads[plain] = gs
    torch.cuda.synchronize()
    for a, b in zip(grads[False], grads[True]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_bwd_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 64, 8, 8, device=dev)
    w = torch.zeros(64, 64, 3, 3, device=dev)
    with pytest.raises(ValueError):            # cotangent in float16
        twc.wino_conv_bwd(x.half(), x, w, 4)
    with pytest.raises(ValueError):            # dprev not float32
        twc.wino_conv_bwd(x, x, w, 4, dprev=x.bfloat16())
    with pytest.raises(ValueError):            # gate without ds
        twc.wino_conv_bwd(x, x, w, 4, gate=torch.zeros(1, 64, device=dev))
    ca = [torch.zeros(s, device=dev) for s in ((32, 64), (32,), (64, 32), (64,))]
    with pytest.raises(ValueError):            # da not float32
        twc.ca_skip_bwd(x.bfloat16(), x.bfloat16(), *ca)
    with pytest.raises(ValueError):            # 32 channels
        twc.ca_skip_bwd(x[:, :32], x[:, :32], *ca)


def _wattn_inputs(dev, nw, masked, seed):
    """Window-attention operands at C = 64, T = 64, h = 4: x (nw, 64, 64),
    the JAX-layout weights and the shifted-window group mask of 96×96 tiles
    (144 windows) or of 16×16 tiles (4 windows)."""
    from sres_tpu_torch.models.swinir import shift_attn_mask
    rng = np.random.default_rng(seed)
    ops = [_t(rng, (nw, 64, 64), dev), _t(rng, (64, 192), dev, 0.1),
           _t(rng, (192,), dev, 0.1), _t(rng, (64, 64), dev, 0.1),
           _t(rng, (64,), dev, 0.1), _t(rng, (4, 64, 64), dev, 0.02)]
    side = 96 if nw % 144 == 0 else 16
    mask = torch.from_numpy(shift_attn_mask(side, side, 8, 4)).to(dev) if masked else None
    return ops, mask


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [8, 1728])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_twin(dev, nw, masked):
    """The forward kernel, f32 and bf16, at a small and at the flagship
    window count (SwinIR ×4 at batch 12 of 96×96 LR tiles)."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _wattn_inputs(dev, nw, masked, 40)
    launches = twa.LAUNCHES["window_attention"]
    _check(lambda x_: twa.window_attention(x_, *ws, mask, 4),
           lambda x_: twa.window_attention_plain(x_, *ws, mask, 4),
           (x,), (x.bfloat16(),))
    assert twa.LAUNCHES["window_attention"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [8, 1728])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_bwd_matches_twin(dev, nw, masked):
    """The backward kernel: dx and the five weight gradients, f32 and bf16."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _wattn_inputs(dev, nw, masked, 41)
    g = _t(np.random.default_rng(42), tuple(x.shape), dev)
    launches = twa.LAUNCHES["window_attention_bwd"]
    run = lambda fn, dt: fn(x.to(dt), g.to(dt), *ws, mask, 4)
    _check_many(f"window_attention_bwd nw={nw} masked={masked}",
                run(twa.window_attention_bwd, torch.float32),
                run(twa.window_attention_bwd_plain, torch.float32),
                run(twa.window_attention_bwd, torch.bfloat16),
                run(twa.window_attention_bwd_plain, torch.bfloat16))
    assert twa.LAUNCHES["window_attention_bwd"] == launches + 2


@pytest.mark.cuda
def test_window_attention_wrappers_reject_what_the_kernels_do_not_take(dev):
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), _ = _wattn_inputs(dev, 8, False, 43)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 rows 7, 8"):
        twa.window_attention(torch.zeros(2, 49, 64, device=dev), *ws[:4],
                             torch.zeros(4, 49, 49, device=dev), None, 4)
    with pytest.raises(ValueError):            # head width 64
        twa.window_attention(x, *ws[:4], ws[4][:1], None, 1)
    with pytest.raises(ValueError):            # torch-layout (3C, C) weight
        twa.window_attention(x, ws[0].T, *ws[1:], None, 4)
    with pytest.raises(ValueError):            # 5 windows per mask group of 4
        twa.window_attention(x[:5], *ws, torch.zeros(4, 64, 64, device=dev), 4)


def _tiled_inputs(dev, t, nw, tile, heads, seed):
    """Window-attention operands at T = t tokens (ws × ws windows), C = 64:
    x (nw, t, 64), the JAX-layout weights, an (h, t, t) bias, and the
    shifted-window group mask of a ``tile`` = (H, W) image (None for no
    tile); nw a multiple of the mask's windows."""
    from sres_tpu_torch.models.swinir import shift_attn_mask
    rng = np.random.default_rng(seed)
    ws = int(round(t ** 0.5))
    ops = [_t(rng, (nw, t, 64), dev), _t(rng, (64, 192), dev, 0.1),
           _t(rng, (192,), dev, 0.1), _t(rng, (64, 64), dev, 0.1),
           _t(rng, (64,), dev, 0.1), _t(rng, (heads, t, t), dev, 0.02)]
    mask = (torch.from_numpy(shift_attn_mask(*tile, ws, ws // 2)).to(dev)
            if tile else None)
    return ops, mask


def _tiled_check(dev, t, nw, tile, heads, seed):
    """The forward and backward kernels against their twins, f32 and bf16,
    each launched twice on its key."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, nw, tile, heads, seed)
    g = _t(np.random.default_rng(seed + 1), tuple(x.shape), dev)
    before = dict(twa.LAUNCHES)
    _check(lambda x_: twa.window_attention(x_, *ws, mask, heads),
           lambda x_: twa.window_attention_plain(x_, *ws, mask, heads),
           (x,), (x.bfloat16(),))
    run = lambda fn, dt: fn(x.to(dt), g.to(dt), *ws, mask, heads)
    _check_many(f"bwd t={t} nw={nw} tile={tile}",
                run(twa.window_attention_bwd, torch.float32),
                run(twa.window_attention_bwd_plain, torch.float32),
                run(twa.window_attention_bwd, torch.bfloat16),
                run(twa.window_attention_bwd_plain, torch.bfloat16))
    want = dict(window_attention=before["window_attention"] + 2,
                window_attention_bwd=before["window_attention_bwd"] + 2)
    assert twa.LAUNCHES == want


@pytest.mark.cuda
@pytest.mark.parametrize("nw,tile", [(8, None), (8, (32, 32)), (432, None),
                                     (432, (96, 96))])
def test_window_attention_t256_matches_twin(dev, nw, tile):
    """16×16 windows (T = 256, 4 heads): 8 windows, and SwinIR ×4's 432 at
    batch 12 of 96×96 LR tiles, unshifted and with the shifted-window mask
    (4 and 36 windows a group)."""
    _tiled_check(dev, 256, nw, tile, 4, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("t,nw,tile,heads", [(16, 8, (8, 16), 4), (144, 6, (24, 36), 2)])
def test_window_attention_other_tiled_t_matches_twin(dev, t, nw, tile, heads):
    """4×4 (T = 16) and 12×12 (T = 144, a query tile cut short; head width
    32) windows, shifted."""
    _tiled_check(dev, t, nw, tile, heads, 51)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,nw,tile", [
    (64, 4, 1, (8, 8)), (64, 4, 7, (8, 56)), (64, 4, 433, (8, 8)),
    (256, 4, 1, (16, 16)), (256, 4, 7, (16, 112)), (256, 4, 433, (16, 16)),
    (64, 2, 6, None), (256, 2, 36, (96, 96)), (144, 2, 433, (12, 12)), (16, 2, 6, None)])
def test_window_attention_every_t_matches_twin(dev, t, heads, nw, tile):
    """The forward (one cluster design at every T) against its twin, f32
    and bf16: one window; seven under a seven-window mask (nm = 7); 433
    under a one-window mask (nm = 1), which the window ranges do not divide
    evenly; head width 32 (the largest shared-memory map at T = 256); T =
    144, whose cluster's last CTA holds 16 query rows (48 in f32)."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, nw, tile, heads, 58 + t)
    launches = twa.LAUNCHES["window_attention"]
    _check(lambda x_: twa.window_attention(x_, *ws, mask, heads),
           lambda x_: twa.window_attention_plain(x_, *ws, mask, heads),
           (x,), (x.bfloat16(),))
    assert twa.LAUNCHES["window_attention"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("t,nw,tile", [(64, 1728, (96, 96)), (256, 432, (96, 96))])
def test_window_attention_is_deterministic(dev, t, nw, tile):
    """Two forward runs give the same bits, at SwinIR's T = 64 and
    SwinIR-w16's T = 256 shapes, shifted."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, nw, tile, 4, 59)
    a = twa.window_attention(x.bfloat16(), *ws, mask, 4)
    b = twa.window_attention(x.bfloat16(), *ws, mask, 4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,nw,tile", [
    (16, 4, 8, (8, 16)), (16, 2, 6, None),
    (64, 4, 433, (8, 8)), (64, 2, 6, None), (64, 2, 144, (96, 96)),
    (144, 2, 6, (24, 36)), (144, 4, 433, (12, 12)), (144, 4, 6, None),
    (256, 2, 6, None), (256, 4, 433, (16, 16)), (256, 2, 36, (96, 96))])
def test_window_attention_bwd_every_t_matches_twin(dev, t, heads, nw, tile):
    """The backward (one cluster design at every T) against its twin, f32
    and bf16: head widths 16 and 32, shifted and not, window counts that the
    window ranges do not divide evenly (6, and 433 windows under a
    one-window mask, nm = 1), and T = 144, whose cluster's last CTA holds
    16 query rows (48 in f32)."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, nw, tile, heads, 56 + t)
    g = _t(np.random.default_rng(57 + t), tuple(x.shape), dev)
    launches = twa.LAUNCHES["window_attention_bwd"]
    run = lambda fn, dt: fn(x.to(dt), g.to(dt), *ws, mask, heads)
    _check_many(f"bwd t={t} heads={heads} nw={nw} tile={tile}",
                run(twa.window_attention_bwd, torch.float32),
                run(twa.window_attention_bwd_plain, torch.float32),
                run(twa.window_attention_bwd, torch.bfloat16),
                run(twa.window_attention_bwd_plain, torch.bfloat16))
    assert twa.LAUNCHES["window_attention_bwd"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("t,nw,tile", [(64, 1728, (96, 96)), (256, 432, (96, 96))])
def test_window_attention_t256_bwd_is_deterministic(dev, t, nw, tile):
    """Two backward runs give the same bits, at SwinIR's T = 64 and
    SwinIR-w16's T = 256 shapes: fixed-order partial sums, no atomics."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, nw, tile, 4, 52)
    g = _t(np.random.default_rng(53), tuple(x.shape), dev).bfloat16()
    a = twa.window_attention_bwd(x.bfloat16(), g, *ws, mask, 4)
    b = twa.window_attention_bwd(x.bfloat16(), g, *ws, mask, 4)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("t,tile", [(64, (16, 16)), (256, (32, 32))])
def test_window_attention_t256_fn_gradients_match_twin(dev, t, tile):
    """WindowAttentionFn on the kernels against the same Function on the
    twins (f32), at T = 64 and T = 256: every gradient within 1e-4·max."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), mask = _tiled_inputs(dev, t, 8, tile, 4, 54)
    grads = []
    for plain in (False, True):
        leaves = [a.detach().clone().requires_grad_() for a in (x, *ws)]
        y = twa.WindowAttentionFn.apply(*leaves, mask, 4, plain)
        torch.cos(y).sum().backward()
        grads.append([a.grad for a in leaves])
    torch.cuda.synchronize()
    for k, p in zip(*grads):
        assert float((k - p).abs().max()) <= 1e-4 * float(p.abs().max())


@pytest.mark.cuda
def test_tiled_wrappers_reject_what_the_kernels_do_not_take(dev):
    """T = 49 (7×7 windows) and T = 272 are not ported; C = 32 at T = 256
    raises as at T = 64."""
    from sres_tpu_torch.ops import window_attention as twa
    (x, *ws), _ = _tiled_inputs(dev, 256, 2, None, 4, 55)
    for t in (49, 272):
        xt, bt = torch.zeros(2, t, 64, device=dev), torch.zeros(4, t, t, device=dev)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 rows 7, 8"):
            twa.window_attention(xt, *ws[:4], bt, None, 4)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 rows 7, 8"):
            twa.window_attention_bwd(xt, xt, *ws[:4], bt, None, 4)
    with pytest.raises(ValueError):            # 32 channels
        twa.window_attention(x[:, :, :32].contiguous(), *ws, None, 4)


def _fg_operands(dev, shape, seed):
    """Direct-conv group operands: x, a second activation, a ReLU output to
    mask by, conv weights (9, 64, 64) f32, a bias, gate and ds."""
    from sres_tpu_torch.ops import fused_group as fg
    rng = np.random.default_rng(seed)
    n = shape[0]
    x, r = _t(rng, shape, dev), _t(rng, shape, dev)
    m = torch.relu(_t(rng, shape, dev))
    wk = fg.conv_weights(_t(rng, (64, 64, 3, 3), dev, 0.04), torch.float32)
    return (x, r, m, wk, _t(rng, (64,), dev, 0.04), _t(rng, (n, 64), dev).sigmoid(),
            _t(rng, (n, 64), dev, 1e-2))


def _dt(args, dt):
    return [a.to(dt) if a is not None and a.dim() == 4 else a for a in args]


# (3, 64, 16, 32) a full tile grid, (2, 64, 13, 21) a ragged one, (1, 64, 8,
# 8) fewer tiles than blocks, (5, 64, 40, 56) block ranges across images
FG_SHAPES = [(3, 64, 16, 32), (2, 64, 13, 21), (1, 64, 8, 8), (5, 64, 40, 56)]


def _fg_conv_call(fn, mode, x, r, m, wk, b, gate, ds):
    """One fgroup_conv call of ``mode``; partials summed per sample."""
    if mode == "relu":                         # conv1
        return (fn(x, wk, b, relu=True),)
    if mode == "partials":                     # conv2
        y, p = fn(x, wk, b, out_dtype=torch.float32, partials=True)
        return y, p.sum(1)
    if mode == "residual":                     # bias and two residuals
        return (fn(x, wk, b, res=r, res2=m),)
    if mode == "dgrad":                        # conv2's dgrad
        y, p = fn(x, wk, gate=gate, ds=ds, mask=m, partials=True)
        return y, p.sum(1)
    if mode == "carry":                        # conv1's dgrad
        return (fn(x, wk, res=r),)
    if mode == "carry_skip":                   # conv1's dgrad at RCAB 0
        return (fn(x, wk, res=r, res2=m),)
    return (fn(x, wk),)                        # the trailing conv's dgrad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FG_SHAPES)
@pytest.mark.parametrize("mode", ["relu", "partials", "residual", "dgrad", "carry",
                                  "carry_skip", "plain"])
def test_fgroup_conv_matches_twin(dev, shape, mode):
    """Kernel (a) in each epilogue: bias + ReLU; f32 output with the per-tile
    sums (compared summed per sample); bias and two residuals; the CA
    prologue with the mask and partials (the dgrad of conv2); the carried
    cotangent (conv1's dgrad), with the group skip; none (the trailing
    conv's dgrad)."""
    from sres_tpu_torch.ops import fused_group as fg
    x, r, m, wk, b, gate, ds = _fg_operands(dev, shape, 50)

    def run(fn, dt):
        xx, rr, mm = _dt((x, r, m), dt)
        return _fg_conv_call(fn, mode, xx, rr, mm, wk.to(dt), b, gate, ds)

    launches = fg.LAUNCHES["fgroup_conv"]
    _check_many(f"fgroup_conv {mode} {shape}", run(fg.fgroup_conv, torch.float32),
                run(fg.fgroup_conv_plain, torch.float32),
                run(fg.fgroup_conv, torch.bfloat16),
                run(fg.fgroup_conv_plain, torch.bfloat16))
    assert fg.LAUNCHES["fgroup_conv"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FG_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "prologue", "db_part"])
def test_fgroup_wgrad_matches_twin(dev, shape, mode):
    """Kernel (c): dW and db, with the CA prologue, and db from a conv's
    partials."""
    from sres_tpu_torch.ops import fused_group as fg
    x, g, _, _, _, gate, ds = _fg_operands(dev, shape, 51)
    part = _t(np.random.default_rng(52), (shape[0], 5, 64), dev)

    def run(fn, dt):
        xx, gg = _dt((x, g), dt)
        if mode == "prologue":
            return fn(xx, gg, gate=gate, ds=ds)
        return fn(xx, gg, db_part=part if mode == "db_part" else None)

    launches = fg.LAUNCHES["fgroup_wgrad"]
    _check_many(f"fgroup_wgrad {mode} {shape}", run(fg.fgroup_wgrad, torch.float32),
                run(fg.fgroup_wgrad_plain, torch.float32),
                run(fg.fgroup_wgrad, torch.bfloat16),
                run(fg.fgroup_wgrad_plain, torch.bfloat16))
    assert fg.LAUNCHES["fgroup_wgrad"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 64, 40, 56), (1, 64, 8, 8)])
def test_fgroup_conv_and_wgrad_are_deterministic(dev, shape):
    """The conv's output and partials, and dw, db in every wgrad mode, are
    the same bits on two calls (fixed-order sums, no float atomics)."""
    from sres_tpu_torch.ops import fused_group as fg
    x, r, m, wk, b, gate, ds = _fg_operands(dev, shape, 56)
    xb, rb, mb, wb = x.bfloat16(), r.bfloat16(), m.bfloat16(), wk.bfloat16()
    part = _t(np.random.default_rng(57), (shape[0], 7, 64), dev)
    calls = [lambda: fg.fgroup_conv(xb, wb, gate=gate, ds=ds, mask=mb, partials=True),
             lambda: fg.fgroup_conv(xb, wb, b, out_dtype=torch.float32, partials=True),
             lambda: fg.fgroup_wgrad(xb, rb),
             lambda: fg.fgroup_wgrad(xb, rb, gate=gate, ds=ds),
             lambda: fg.fgroup_wgrad(xb, rb, db_part=part)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [False, True])
@pytest.mark.parametrize("hidden", [1, 4, 32, 64])
@pytest.mark.parametrize("case", list(_CA_SHAPES))
def test_fgroup_ca_and_ca_bwd_match_twin(dev, case, hidden, stash):
    """Kernels (b) and (d): gate + skip from conv partials (the gate, and
    the c stash when asked), the same bits on two calls, one launch a call;
    and the channel-attention backward, one launch a call, the same bits on
    two calls."""
    from sres_tpu_torch.ops import fused_group as fg
    shape = _CA_SHAPES[case]
    x, c, g, wk, b, gate, _ = _fg_operands(dev, shape, 53)
    c = c + 0.3
    ca = _ca_weights(np.random.default_rng(54), dev, hidden)
    part = c.sum((2, 3))[:, None] / 3
    part = torch.cat([part, part, part], 1)

    def fwd(fn, dt):
        xn, gt, cst = fn(x.to(dt), c, part, *ca, stash_c=stash)
        assert (cst is None) != stash
        return (xn, gt, cst) if stash else (xn, gt)

    launches = fg.LAUNCHES["fgroup_ca"]
    _check_many("fgroup_ca", fwd(fg.fgroup_ca, torch.float32),
                fwd(fg.fgroup_ca_plain, torch.float32),
                fwd(fg.fgroup_ca, torch.bfloat16), fwd(fg.fgroup_ca_plain, torch.bfloat16))
    assert fg.LAUNCHES["fgroup_ca"] == launches + 2
    for dt in (torch.float32, torch.bfloat16):
        first, second = fwd(fg.fgroup_ca, dt), fwd(fg.fgroup_ca, dt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    bwd = lambda fn, dt: fn(g.to(dt), c.to(dt), gate, *ca)
    launches = fg.LAUNCHES["fgroup_ca_bwd"]
    _check_many("fgroup_ca_bwd", bwd(fg.fgroup_ca_bwd, torch.float32),
                bwd(fg.fgroup_ca_bwd_plain, torch.float32),
                bwd(fg.fgroup_ca_bwd, torch.bfloat16),
                bwd(fg.fgroup_ca_bwd_plain, torch.bfloat16))
    assert fg.LAUNCHES["fgroup_ca_bwd"] == launches + 2
    for dt in (torch.float32, torch.bfloat16):
        first, second = bwd(fg.fgroup_ca_bwd, dt), bwd(fg.fgroup_ca_bwd, dt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
def test_fused_group_gradients_match_twin(dev):
    """FusedGroupFn (2 RCABs + trailing conv, f32) under autograd on the
    card: the output, dx and every parameter's gradient through the kernels
    against the plain twins (1e-4·max)."""
    from sres_tpu_torch.models.fused import FusedResidualGroup
    from sres_tpu_torch.models.layers import init_torch_default
    grp = init_torch_default(FusedResidualGroup(64, 2, 2), 6).to(dev)
    rng = np.random.default_rng(55)
    x = _t(rng, (3, 64, 16, 24), dev).contiguous(memory_format=torch.channels_last)
    gy = _t(rng, (3, 64, 16, 24), dev)
    res = {}
    for plain in (False, True):
        grp.plain = plain
        xx = x.clone().requires_grad_()
        y = grp(xx)
        res[plain] = (y.detach(), *torch.autograd.grad((y * gy).sum(),
                                                        [xx, *grp.parameters()]))
    grp.plain = False
    torch.cuda.synchronize()
    for a, b in zip(res[False], res[True]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("res_scale", [1.0, 0.1])
def test_wino_conv_scaled_residual_matches_twin(dev, m, res_scale):
    """The epilogue res + res_scale·conv (EDSR's ResBlock skip); at 1.0 the
    same bits as the unscaled epilogue."""
    rng = np.random.default_rng(60 + m)
    x, r = _t(rng, (5, 64, 16, 24), dev), _t(rng, (5, 64, 16, 24), dev)
    w, b = _t(rng, (64, 64, 3, 3), dev, 0.04), _t(rng, (64,), dev, 0.04)
    _check(lambda x_, r_: twc.wino_conv(x_, w, b, m, False, r_, res_scale),
           lambda x_, r_: twc.wino_conv_plain(x_, w, b, m, False, r_, res_scale),
           (x, r), (x.bfloat16(), r.bfloat16()))
    if res_scale == 1.0:
        for dt in (torch.float32, torch.bfloat16):
            xx, rr = x.to(dt), r.to(dt)
            assert torch.equal(twc.wino_conv(xx, w, b, m, residual=rr, res_scale=1.0),
                               twc.wino_conv(xx, w, b, m, residual=rr))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_wino_chain_matches_twin_and_separate_launches(dev, m):
    """The chain (K = 3, + ReLU) in one launch against its twin (f32 bound,
    bf16 envelope) and bit for bit against K ``wino_conv`` launches."""
    rng = np.random.default_rng(70 + m)
    x = _t(rng, (5, 64, 16, 24), dev)
    ws, bv = _t(rng, (3, 64, 64, 3, 3), dev, 0.04), _t(rng, (3, 64), dev, 0.04)
    launches = dict(twc.LAUNCHES)
    _check(lambda x_: twc.wino_chain_fwd(x_, ws, bv, m),
           lambda x_: twc.wino_chain_fwd_plain(x_, ws, bv, m), (x,), (x.bfloat16(),))
    assert twc.LAUNCHES["wino_chain"] == launches["wino_chain"] + 2
    for dt in (torch.float32, torch.bfloat16):
        y = x.to(dt)
        for i in range(3):
            y = twc.wino_conv(y, ws[i], bv[i], m, relu=True)
        assert torch.equal(twc.wino_chain_fwd(x.to(dt), ws, bv, m), y)
    assert twc.LAUNCHES["wino_conv"] == launches["wino_conv"] + 6
    one = twc.wino_chain_fwd(x, ws[:1], bv[:1], m, relu=False)
    assert torch.equal(one, twc.wino_conv(x, ws[0], bv[0], m))


@pytest.mark.cuda
@pytest.mark.parametrize("res_scale", [1.0, 0.7])
def test_resgroup_fwd_bwd_match_twins(dev, res_scale):
    """The ungated group (3 ResBlocks + trailing conv, m=4): the forward and
    its stash against the twins (f32 1e-4·max, bf16 envelope); the backward
    kernels against the twin on one shared stash, recomputing c1 with the
    same conv kernel (1e-4·max in f32; a ReLU gate within rounding of zero
    would otherwise open on one side only)."""
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResTrunk
    trunk = init_torch_default(WinoResTrunk(64, 3, 4, res_scale), 7).to(dev)
    rng = np.random.default_rng(80)
    x, gy = _t(rng, (3, 64, 16, 24), dev), _t(rng, (3, 64, 16, 24), dev)
    outs = {}
    for plain in (False, True):
        fwd = twc.wino_resgroup_fwd_plain if plain else twc.wino_resgroup_fwd
        for dt in (torch.float32, torch.bfloat16):
            ws, bv, wt, bt = trunk._operands(dt)
            st = []
            y = fwd(x.to(dt), ws, bv, 4, wt, bt, res_scale, st)
            outs[(plain, dt)] = torch.cat([a.float().flatten() for a in [y, *st]])
    torch.cuda.synchronize()
    f32, bf16 = torch.float32, torch.bfloat16
    a, b = outs[(False, f32)], outs[(True, f32)]
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert _rel(outs[(False, bf16)], b) <= 2 * _rel(outs[(True, bf16)], b) + 1e-4
    ws, bv, wt, bt = trunk._operands(f32)
    st = []
    twc.wino_resgroup_fwd(x, ws, bv, 4, wt, bt, res_scale, st)
    launches = twc.LAUNCHES["wino_conv_bwd"]
    rk = twc.wino_resgroup_bwd(gy, st, ws, bv, 4, wt, res_scale)
    rp = twc.wino_resgroup_bwd_plain(gy, st, ws, bv, 4, wt, res_scale, conv=twc.wino_conv)
    torch.cuda.synchronize()
    assert twc.LAUNCHES["wino_conv_bwd"] == launches + 2 * 3 + 1
    for a, b in zip(rk, rp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_resgroup_fn_gradients_match_twin(dev):
    """WinoResGroupTrailFn (EDSR's trunk: 2 ResBlocks + trailing conv,
    res_scale 0.5, f32) under autograd: the output, dx and every parameter's
    gradient through the kernels against the plain twins (1e-4·max)."""
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResTrunk
    trunk = init_torch_default(WinoResTrunk(64, 2, 4, 0.5), 8).to(dev)
    rng = np.random.default_rng(81)
    x = _t(rng, (3, 64, 16, 16), dev).contiguous(memory_format=torch.channels_last)
    gy = _t(rng, (3, 64, 16, 16), dev)
    res = {}
    for plain in (False, True):
        trunk.plain = plain
        xx = x.clone().requires_grad_()
        y = trunk(xx)
        res[plain] = (y.detach(), *torch.autograd.grad((y * gy).sum(),
                                                        [xx, *trunk.parameters()]))
    trunk.plain = False
    torch.cuda.synchronize()
    for a, b in zip(res[False], res[True]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())



@pytest.mark.cuda
def test_assemble_tiles_on_the_card_matches_its_cpu_run(dev):
    """The region mosaic scattered on the card equals the same call on the
    CPU, bit for bit: tiles at their slots, NaN holes, padding (weight 0,
    any id) dropped through the trash slot."""
    from sres_tpu_torch.ops.assemble import assemble_tiles
    rng = np.random.default_rng(90)
    grid = {"y": 5, "x": 7}
    ids = torch.from_numpy(rng.permutation(35)[:24])
    ids = torch.cat([ids, torch.tensor([0, 3, 34, 0])])          # 4 pads
    weight = torch.cat([torch.ones(24), torch.zeros(4)])
    tiles = torch.from_numpy(rng.normal(size=(28, 12, 8)).astype(np.float32))
    want = assemble_tiles(tiles, ids, grid, weight)
    got = assemble_tiles(tiles.to(dev), ids.to(dev), grid, weight.to(dev))
    assert got.is_cuda and got.shape == (60, 56)
    assert torch.equal(torch.isnan(got).cpu(), torch.isnan(want))
    assert int(torch.isnan(want).sum()) == 11 * 12 * 8
    assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_whole_region_sample_matches_twin(dev):
    """One 960×960 HR region's LR trunk input, (1, 64, 480, 480): ca_skip
    (the two-pass kernel) and a 2-RCAB group with its trailing conv
    (``wino_group_fwd``, m = 4) against their twins, f32 bound and bf16
    envelope."""
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
    from sres_tpu_torch.ops import cuda
    shape = (1, 64, 480, 480)
    rng = np.random.default_rng(91)
    assert cuda.load().sres_ca_skip_cluster(1, 480 * 480, 1, 0) == 0
    q, r = _t(rng, shape, dev), _t(rng, shape, dev) + 0.3
    ca = _ca_weights(rng, dev, 32)
    _check(lambda q_, r_: twc.ca_skip(q_, r_, *ca),
           lambda q_, r_: twc.ca_skip_plain(q_, r_, *ca),
           (q, r), (q.bfloat16(), r.bfloat16()))
    grp = init_torch_default(WinoResidualGroup(64, 2, 2, 4), 9).to(dev)
    x = _t(rng, shape, dev).contiguous(memory_format=torch.channels_last)
    outs = {}
    with torch.no_grad():
        for plain in (False, True):
            grp.plain = plain
            outs[plain] = (grp(x), grp(x.bfloat16()))
    grp.plain = False
    torch.cuda.synchronize()
    (k32, kbf), (p32, pbf) = outs[False], outs[True]
    assert float((k32 - p32).abs().max()) <= 1e-4 * float(p32.abs().max())
    assert _rel(kbf, p32) <= 2 * _rel(pbf, p32) + 1e-4


@pytest.mark.cuda
def test_served_after_loading_weights_equals_a_fresh_model(dev):
    """A Winograd RCAN (2 groups of 2 RCABs, bf16) serves, so its U caches
    hold its weights; then other weights are loaded in place, as
    ``CheckpointManager.load_checkpoint`` loads them. It then serves what a
    model built from those weights serves, bit for bit: no stale U."""
    from sres_tpu_torch.models import build_model
    cfg = dict(name="rcan", nfeatures=64, nlayers=2, nblocks=2, cbottleneck=2,
               kernel_size=3, downscale_factors=[2, 2], winograd=4)
    lr = _t(np.random.default_rng(92), (3, 1, 24, 24), dev)
    served = build_model(cfg, 1, 1, "bf16", seed=1, device=dev).eval()
    other = build_model(cfg, 1, 1, "bf16", seed=2, device=dev).eval()
    with torch.inference_mode():
        before = served(lr)
    served.load_state_dict(other.state_dict())
    fresh = build_model(cfg, 1, 1, "bf16", seed=3, device=dev).eval()
    fresh.load_state_dict(other.state_dict())
    with torch.inference_mode():
        after, want = served(lr), fresh(lr)
    torch.cuda.synchronize()
    assert not torch.equal(before, want)
    assert torch.equal(after, want)


# ------------------------------------------------------------- int8 kernels
def _q8():
    from sres_tpu_torch.ops import int8_conv as q8
    return q8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", [0, 1])
@pytest.mark.parametrize("kind", ["act1", "act2", "wout", "win_flip", "whole_pre"])
def test_q8_quantize_matches_twin(dev, dtype, grid, kind):
    """q8_quantize at every scale-group kind, both grids, f32 and bf16
    input (NCHW and channels_last activations): q and the scales bit-equal
    to the twin."""
    q8 = _q8()
    if kind == "whole_pre" and grid == 1:
        pytest.skip("AQT scales no tensor by a prefactor")
    rng = np.random.default_rng(7)
    if kind.startswith("act") or kind == "whole_pre":
        t = _t(rng, (5, 64, 7, 9), dev).to(dtype)
        if kind == "act2":
            t = t.contiguous(memory_format=torch.channels_last)
    else:
        t = _t(rng, (64, 64, 3, 3), dev, 0.05).to(dtype)
    group = {"act1": 1, "act2": 2, "wout": 1, "win_flip": 1, "whole_pre": None}[kind]
    flip = kind == "win_flip"
    if flip:
        t = t.transpose(0, 1)
    pre = _t(rng, (5,), dev).abs() + 0.5 if kind == "whole_pre" else None
    launches = q8.LAUNCHES["q8_quantize"]
    q, s = q8.quantize(t, group, grid, pre=pre, flip=flip)
    qp, sp = q8.quantize_plain(t, group, grid, pre=pre, flip=flip)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(q.float(), qp) and torch.equal(s, sp)
    assert q8.LAUNCHES["q8_quantize"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [64, 1])
@pytest.mark.parametrize("mode,dtype", [(0, torch.bfloat16), (0, torch.float32),
                                        (1, torch.float32), (2, torch.bfloat16)])
@pytest.mark.parametrize("pk", [1, 2])
def test_s8_conv_fprop_matches_twin(dev, cin, mode, dtype, pk):
    """s8_conv_fprop against its twin, bit for bit: an odd batch, ragged
    pixel tiles (5·7·9 pixels), bias or none, each epilogue."""
    q8 = _q8()
    rng = np.random.default_rng(cin + mode)
    x = _t(rng, (5, cin, 7, 9), dev).contiguous(memory_format=torch.channels_last)
    w = _t(rng, (64, cin, 3, 3), dev, 0.05)
    b = _t(rng, (64,), dev, 0.1).to(dtype) if mode != 1 else None
    grid = 0 if mode == 0 else 1
    xq, sx = q8.quantize(x.to(dtype) if grid else x, pk, grid)
    wq, sw = q8.quantize(w.to(dtype) if grid else w, 1, grid)
    launches = q8.LAUNCHES["s8_conv_fprop"]
    y = q8.conv_fprop(xq, wq, sx, pk, sw, b, dtype, mode)
    yp = q8.conv_fprop(xq.float(), wq.float(), sx, pk, sw, b, dtype, mode, plain=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert torch.equal(y, yp)
    assert q8.LAUNCHES["s8_conv_fprop"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [64, 1])
@pytest.mark.parametrize("pk,batch", [(1, 4), (2, 5), (2, 1)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_s8_conv_wgrad_matches_twin(dev, cin, pk, batch, wdt):
    """s8_conv_wgrad against its twin, bit for bit: per-slot sums, an odd
    batch and a batch smaller than the pack, chunks of the slots' pixel
    streams that cross samples (a 1024-pixel chunk over 40·30 pixels)."""
    q8 = _q8()
    rng = np.random.default_rng(cin + pk + batch)
    x = _t(rng, (batch, cin, 40, 30), dev)
    g = _t(rng, (batch, 64, 40, 30), dev)
    xq, sx = q8.quantize(x, pk)
    gq, sgp = q8.quantize(g, None, pre=q8._rows(sx, pk, batch))
    launches = q8.LAUNCHES["s8_conv_wgrad"]
    dw = q8.conv_wgrad(xq, gq, (64, cin, 3, 3), pk, sgp, wdt)
    dwp = q8.conv_wgrad(xq.float(), gq.float(), (64, cin, 3, 3), pk, sgp, wdt, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(dw, dwp)
    assert q8.LAUNCHES["s8_conv_wgrad"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int8_fused", "int8_full"])
@pytest.mark.parametrize("name", ["rcan", "edsr", "vdsr"])
def test_quantized_models_match_twins(dev, quant, name):
    """A 64-feature RCAN (1 group, 2 blocks), EDSR (2 blocks) and VDSR (3
    layers) under each mode, f32: the forward on the kernels equals the
    twins' bit for bit; so do one step's int8_full gradients (cuDNN made
    deterministic for the unquantized convs); int8_fused's backward convs
    are cuDNN's bf16 convs on both paths, within a bf16 ulp."""
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    q8 = _q8()
    cfgs = dict(rcan=dict(nlayers=1, nblocks=2, cbottleneck=2, lane_pack=2),
                edsr=dict(nlayers=2, lane_pack=2), vdsr=dict(nlayers=3))
    cfg = dict(name=name, nfeatures=64, kernel_size=3, downscale_factors=[2, 2],
               quantization=quant, **cfgs[name])
    model = build_model(cfg, 1, 1, "f32", seed=0, device=dev)
    lr = _t(np.random.default_rng(3), (3, 1, 12, 12), dev)
    outs = []
    # deterministic cuDNN: an f32 difference in a cotangent can flip one
    # int8_full quantization step downstream
    torch.backends.cudnn.deterministic = True
    for plain in (False, True):
        set_plain_twins(model, plain)
        model.zero_grad()
        q8.reset_launches()
        if quant == "int8":
            with torch.no_grad():
                y = model(lr)
            outs.append((y, None))
        else:
            y = model(lr)
            y.square().mean().backward()
            outs.append((y.detach(), [p.grad.clone() for p in model.parameters()]))
        torch.cuda.synchronize()
        assert (q8.LAUNCHES["s8_conv_fprop"] > 0) != plain
    torch.backends.cudnn.deterministic = False
    assert torch.equal(outs[0][0], outs[1][0])
    if quant != "int8":
        tol = 0.0 if quant == "int8_full" else 2.0 ** -7
        for (n, _), a, b in zip(model.named_parameters(), outs[0][1], outs[1][1]):
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            assert err <= tol, (n, err)
