"""Every module of the JAX package has its counterpart in the port, at the
same dotted path under tfhe_tpu_torch (its native sources too), except the
named few whose work has no meaning on the card: the four-step NTT and the
Pallas kernels (the port's kernels are CUDA, `tfhe_tpu_torch/csrc/`), and
the TPU switches of `config.py` (Pallas on/off, interpret mode, batch
bucketing).  Both packages are walked by file, without importing them."""
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "tfhe_tpu", REPO / "tfhe_tpu_torch"

# modules of tfhe_tpu with no counterpart, and why
NO_COUNTERPART = {
    "core/poly/fourstep.py": "the four-step NTT layout of the MXU kernels; no card kernel "
                             "takes it",
    "core/poly/pallas_ntt.py": "the Pallas kernels; their counterparts are CUDA "
                               "(tfhe_tpu_torch/csrc/*.cu)",
}
# config.py switches of the TPU with no counterpart
TPU_SWITCHES = ("use_pallas_pbs", "set_use_pallas_pbs", "pallas_interpret",
                "set_pallas_interpret", "bucket_pbs_batch", "set_bucket_pbs_batch")


def _sources(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")
            if p.suffix in (".py", ".cpp", ".h") and "__pycache__" not in p.parts
            and "build" not in p.relative_to(root).parts}


def test_every_module_has_a_counterpart():
    jax_mods, port_mods = _sources(JAX_PKG), _sources(PORT_PKG)
    assert set(NO_COUNTERPART) <= jax_mods, "a listed module left the JAX package"
    missing = sorted(jax_mods - port_mods - set(NO_COUNTERPART))
    assert not missing, f"JAX modules without a counterpart in the port: {missing}"
    assert not set(NO_COUNTERPART) & port_mods, "a listed module has a counterpart after all"


@pytest.mark.parametrize("name", ["parallel/mesh.py", "native/csprng.cpp", "native/capi.cpp",
                                  "native/include/tfhe_tpu.h", "capi.py",
                                  "utils/keycache.py", "utils/seeding.py"])
def test_last_modules_ported(name):
    assert (PORT_PKG / name).is_file()


def test_tpu_switches_have_no_counterpart():
    jax_cfg = (JAX_PKG / "config.py").read_text()
    port_cfg = (PORT_PKG / "config.py").read_text()
    for name in TPU_SWITCHES:
        assert f"def {name}(" in jax_cfg
        assert f"def {name}(" not in port_cfg
    for name in ("use_mxu_ntt", "use_mxu_lanes", "use_fused_rotation"):
        assert f"def {name}(" in jax_cfg and f"def {name}(" in port_cfg
