"""The port's CUDA kernels against their plain twins, on the card.

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
