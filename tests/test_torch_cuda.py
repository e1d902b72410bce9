"""The port's CUDA kernels (forward and backward) against their plain
twins, on the card.

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
