"""The port's CUDA kernels (forward and backward: the Winograd conv with its
scaled residual epilogue, the conv chain, channel attention, the ungated
group of EDSR's trunk, the window attention, the direct-conv group kernels
of ``model.fused``) against their plain twins, on the card.

Imports no JAX, so it runs on a machine that has only torch and a card;
tests/conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a card. Tolerances: f32 max|kernel − twin| ≤
3e-5·max|twin|; bf16 rel_err(kernel, f32 twin) ≤ 2·rel_err(bf16 twin, f32
twin) + 1e-4 (the envelope of tests/test_winograd.py:
test_winograd_bf16_noise_envelope).
"""
import numpy as np
import pytest
import torch

from sres_tpu_torch.ops import winograd_conv as twc


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


@pytest.mark.cuda
def test_ca_skip_matches_twin(dev):
    rng = np.random.default_rng(10)
    q, r = _t(rng, (3, 64, 16, 16), dev), _t(rng, (3, 64, 16, 16), dev)
    ca = [_t(rng, s, dev, 0.1) for s in ((32, 64), (32,), (64, 32), (64,))]
    _check(lambda q_, r_: twc.ca_skip(q_, r_, *ca),
           lambda q_, r_: twc.ca_skip_plain(q_, r_, *ca),
           (q, r), (q.bfloat16(), r.bfloat16()))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    w = torch.zeros(32, 32, 3, 3, device=dev)
    with pytest.raises(ValueError):
        twc.wino_conv(torch.zeros(1, 32, 8, 8, device=dev), w, None, 4)
    with pytest.raises(TypeError):
        twc.wino_conv(torch.zeros(1, 64, 8, 8, device=dev, dtype=torch.float16),
                      torch.zeros(64, 64, 3, 3, device=dev), None, 4)


def _check_many(name, k32, p32, kbf, pbf):
    """Output by output: the f32 bound and the bf16 envelope."""
    torch.cuda.synchronize()
    for i, (a, b, c, d) in enumerate(zip(k32, p32, kbf, pbf)):
        assert float((a - b).abs().max()) <= 3e-5 * float(b.abs().max()), (name, i)
        assert _rel(c, b) <= 2 * _rel(d, b) + 1e-4, (name, i, _rel(c, b), _rel(d, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mode", ["plain", "relu", "ca", "accum"])
def test_wino_conv_bwd_matches_twin(dev, m, mode):
    """K1 in each of its modes: per-conv adjoint (g in the activation
    dtype), ReLU gate, CA prologue into an f32 dx, ReLU gate accumulated
    into an f32 buffer."""
    rng = np.random.default_rng(20 + m)
    cl = dict(memory_format=torch.channels_last)
    shape = (5, 64, 16, 24)
    x, g = _t(rng, shape, dev), _t(rng, shape, dev)
    w = _t(rng, (64, 64, 3, 3), dev, 0.04)
    y = twc.wino_conv_plain(x, w, _t(rng, (64,), dev, 0.04), m, relu=True)
    gate, ds = _t(rng, (5, 64), dev).sigmoid(), _t(rng, (5, 64), dev, 1e-3)
    prev = _t(rng, shape, dev).contiguous(**cl)

    def run(fn, dt):
        kw = {}
        if mode in ("relu", "accum"):
            kw["y"] = y.to(dt)
        if mode == "ca":
            kw.update(gate=gate, ds=ds)
        if mode == "accum":
            kw["dprev"] = prev.clone(memory_format=torch.channels_last)
        gg = g if mode in ("ca", "accum") else g.to(dt)
        return fn(gg, x.to(dt), w, m, **kw)

    launches = twc.LAUNCHES["wino_conv_bwd"]
    _check_many(f"m{m} {mode}", run(twc.wino_conv_bwd, torch.float32),
                run(twc.wino_conv_bwd_plain, torch.float32),
                run(twc.wino_conv_bwd, torch.bfloat16),
                run(twc.wino_conv_bwd_plain, torch.bfloat16))
    assert twc.LAUNCHES["wino_conv_bwd"] == launches + 2


@pytest.mark.cuda
def test_ca_skip_bwd_matches_twin(dev):
    rng = np.random.default_rng(30)
    da, c2 = _t(rng, (3, 64, 16, 16), dev), _t(rng, (3, 64, 16, 16), dev)
    ca = [_t(rng, s, dev, 0.1) for s in ((32, 64), (32,), (64, 32), (64,))]
    _check_many("ca_skip_bwd", twc.ca_skip_bwd(da, c2, *ca),
                twc.ca_skip_bwd_plain(da, c2, *ca),
                twc.ca_skip_bwd(da, c2.bfloat16(), *ca),
                twc.ca_skip_bwd_plain(da, c2.bfloat16(), *ca))


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
    with pytest.raises(NotImplementedError, match="T = 256"):
        twa.window_attention(torch.zeros(2, 256, 64, device=dev), *ws[:4],
                             torch.zeros(4, 256, 256, device=dev), None, 4)
    with pytest.raises(ValueError):            # head width 64
        twa.window_attention(x, *ws[:4], ws[4][:1], None, 1)
    with pytest.raises(ValueError):            # torch-layout (3C, C) weight
        twa.window_attention(x, ws[0].T, *ws[1:], None, 4)
    with pytest.raises(ValueError):            # 5 windows per mask group of 4
        twa.window_attention(x[:5], *ws, torch.zeros(4, 64, 64, device=dev), 4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 16, 32), (2, 64, 13, 21)])
@pytest.mark.parametrize("mode", ["relu", "partials", "residual", "dgrad"])
def test_fgroup_conv_matches_twin(dev, shape, mode):
    """Kernel (a) in each epilogue: bias + ReLU; f32 output with the per-tile
    sums (compared summed per sample); two residuals; the CA prologue with
    the mask and partials (the dgrad of conv2). A full and a ragged tile
    grid."""
    from sres_tpu_torch.ops import fused_group as fg
    x, r, m, wk, b, gate, ds = _fg_operands(dev, shape, 50)

    def run(fn, dt):
        xx, rr, mm = _dt((x, r, m), dt)
        w = wk.to(dt)
        if mode == "relu":
            return (fn(xx, w, b, relu=True),)
        if mode == "partials":
            y, p = fn(xx, w, b, out_dtype=torch.float32, partials=True)
            return y, p.sum(1)
        if mode == "residual":
            return (fn(xx, w, b, res=rr, res2=mm),)
        y, p = fn(xx, w, gate=gate, ds=ds, mask=mm, partials=True)
        return y, p.sum(1)

    launches = fg.LAUNCHES["fgroup_conv"]
    _check_many(f"fgroup_conv {mode} {shape}", run(fg.fgroup_conv, torch.float32),
                run(fg.fgroup_conv_plain, torch.float32),
                run(fg.fgroup_conv, torch.bfloat16),
                run(fg.fgroup_conv_plain, torch.bfloat16))
    assert fg.LAUNCHES["fgroup_conv"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 16, 32), (2, 64, 13, 21)])
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
def test_fgroup_ca_and_ca_bwd_match_twin(dev):
    """Kernels (b) and (d): gate + skip from conv partials (and the c
    stash), and the channel-attention backward."""
    from sres_tpu_torch.ops import fused_group as fg
    shape = (3, 64, 16, 32)
    x, c, g, wk, b, gate, _ = _fg_operands(dev, shape, 53)
    c = c + 0.3
    ca = [_t(np.random.default_rng(54), s, dev, 0.1)
          for s in ((32, 64), (32,), (64, 32), (64,))]
    part = c.sum((2, 3))[:, None] / 2
    part = torch.cat([part, part], 1)

    def fwd(fn, dt):
        xn, gt, cst = fn(x.to(dt), c, part, *ca, stash_c=True)
        return xn, gt, cst

    _check_many("fgroup_ca", fwd(fg.fgroup_ca, torch.float32),
                fwd(fg.fgroup_ca_plain, torch.float32),
                fwd(fg.fgroup_ca, torch.bfloat16), fwd(fg.fgroup_ca_plain, torch.bfloat16))
    bwd = lambda fn, dt: fn(g.to(dt), c.to(dt), gate, *ca)
    _check_many("fgroup_ca_bwd", bwd(fg.fgroup_ca_bwd, torch.float32),
                bwd(fg.fgroup_ca_bwd_plain, torch.float32),
                bwd(fg.fgroup_ca_bwd, torch.bfloat16),
                bwd(fg.fgroup_ca_bwd_plain, torch.bfloat16))


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

