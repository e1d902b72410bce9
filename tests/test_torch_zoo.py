"""The port's VDSR, DBPN, LatticeNet and ESRT against ``sres_tpu`` on the
CPU, on tiny seeded models (tests/torch_zoo_common.py): the f32 forward,
the weight export, and three Adam steps of the train step. BatchNorm-free
models; tests/test_torch_zoo_bn.py holds SRDN, UNet, LapSRN and MSCNN."""
import pytest
import torch

from torch_zoo_common import check_export, check_forward, check_trajectory

ARCHS = ["vdsr", "dbpn", "latticenet", "esrt"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_matches_jax_exporter(arch):
    check_export(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adam_trajectory_matches_optax(arch):
    check_trajectory(arch)


def test_every_model_yaml_builds():
    """``build_model`` builds every name of sres_tpu's registry, each from
    its config/model YAML at the published widths (the UNet with 4 temporal
    features), and raises KeyError for any other name; VDSR builds under
    AQT's ``quantization`` (ported) with its parameter names, and an
    unknown mode raises ValueError, as in JAX."""
    from pathlib import Path

    import yaml
    from sres_tpu.models.registry import model_names as jax_model_names
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.registry import model_names

    assert set(model_names()) == set(jax_model_names())
    built = set()
    for path in sorted((Path(__file__).resolve().parents[1] / "config/model").glob("*.yaml")):
        cfg = yaml.safe_load(path.read_text())
        model = build_model(cfg, 1, 1, "bf16", device="cpu", temporal_features=4)
        assert sum(p.numel() for p in model.parameters()) > 0
        built.add(cfg["name"])
    assert built == set(model_names())
    with pytest.raises(KeyError, match="available"):
        build_model(dict(name="nosuch"), 1, 1, device="cpu")
    vdsr = build_model(dict(name="vdsr"), 1, 1, device="cpu").state_dict()
    quant = build_model(dict(name="vdsr", quantization="int8"), 1, 1, device="cpu")
    assert list(quant.state_dict()) == list(vdsr)
    with pytest.raises(ValueError, match="Unknown quantization mode"):
        build_model(dict(name="vdsr", quantization="int4"), 1, 1, device="cpu")
