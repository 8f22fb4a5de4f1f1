"""tfhe_tpu_torch imports without jax and starts no process (builds
nothing) at import, carries the JAX package's parameter
tables unchanged, and gives its exported random-source functions no CPU
default device."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

import tfhe_tpu.core.params as jp
import tfhe_tpu_torch.core.params as tp

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "flax", "jaxlib"):
    sys.modules[name] = None          # any import of them now raises
import importlib, pkgutil, subprocess
def _no_build(*args, **kwargs):
    raise AssertionError(f"a module started a process at import: {args}")
subprocess.run = subprocess.Popen = _no_build     # nothing builds at import
import tfhe_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(tfhe_tpu_torch.__path__, "tfhe_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k == "tfhe_tpu" or k.startswith("tfhe_tpu.") for k in sys.modules)
print(" ".join(mods))
"""


def test_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = set(proc.stdout.split())
    assert len(mods) >= 27
    assert {"tfhe_tpu_torch.config", "tfhe_tpu_torch.smem_probe",
            "tfhe_tpu_torch.core.poly.rotation", "tfhe_tpu_torch.interop",
            "tfhe_tpu_torch.integer", "tfhe_tpu_torch.integer.ciphertext",
            "tfhe_tpu_torch.integer.client_key", "tfhe_tpu_torch.integer.server_key",
            "tfhe_tpu_torch.boolean", "tfhe_tpu_torch.apps", "tfhe_tpu_torch.apps.trivium",
            "tfhe_tpu_torch.examples", "tfhe_tpu_torch.examples.sha256_bool",
            "tfhe_tpu_torch.examples.dark_market",
            "tfhe_tpu_torch.examples.regex_engine",
            "tfhe_tpu_torch.core.threefry", "tfhe_tpu_torch.core.algorithms.seeded",
            "tfhe_tpu_torch.core.algorithms.public_key", "tfhe_tpu_torch.utils",
            "tfhe_tpu_torch.utils.serialization", "tfhe_tpu_torch.hlapi",
            "tfhe_tpu_torch.shortint.key_switching_key", "tfhe_tpu_torch.shortint.wopbs",
            "tfhe_tpu_torch.core.algorithms.wopbs", "tfhe_tpu_torch.core.algorithms.linear",
            "tfhe_tpu_torch.core.poly.external_product", "tfhe_tpu_torch.gadget",
            "tfhe_tpu_torch.gadget.encoding", "tfhe_tpu_torch.gadget.engine",
            "tfhe_tpu_torch.gadget.instrument", "tfhe_tpu_torch.core.algorithms.glwe_mult",
            "tfhe_tpu_torch.core.algorithms.gsw", "tfhe_tpu_torch.integer.shift_key",
            "tfhe_tpu_torch.integer.wopbs", "tfhe_tpu_torch.core.u128",
            "tfhe_tpu_torch.core.algorithms.pbs128",
            "tfhe_tpu_torch.core.algorithms.nonnative", "tfhe_tpu_torch.parallel",
            "tfhe_tpu_torch.parallel.mesh", "tfhe_tpu_torch.native", "tfhe_tpu_torch.capi",
            "tfhe_tpu_torch.utils.keycache", "tfhe_tpu_torch.utils.seeding"} <= mods


def test_shift_key_constants_match_jax():
    """The port keeps its own copies of the shift key's decompositions."""
    import tfhe_tpu.integer.shift_key as JSK
    from tfhe_tpu_torch.integer import shift_key as TSK
    for name in ("SHIFT_CBS_DECOMP", "SHIFT_CAST_KS_DECOMP"):
        a, b = getattr(JSK, name), getattr(TSK, name)
        assert (a.base_log, a.level) == (b.base_log, b.level)


def _named_sets():
    names = sorted(jp.ALL_NAMED_PARAMS)
    return names + ["TEST_PARAMS_SHORTINT", "TEST_PARAMS_WOPBS",
                    "TEST_PARAMS_TRIVIUM", "TEST_PARAMS_BOOLEAN",
                    "TEST_PARAMS_BOOLEAN_U32", "TEST_PARAMS_GADGET"]


def _lookup(mod, name):
    return getattr(mod, name) if name.startswith("TEST_") else mod.ALL_NAMED_PARAMS[name]


@pytest.mark.parametrize("name", _named_sets())
def test_param_table_matches_jax(name):
    a, b = _lookup(jp, name), _lookup(tp, name)
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("glwe_size", "big_lwe_dimension", "pbs_order",
                 "lwe_noise_std", "glwe_noise_std"):
        if hasattr(a, prop):
            assert getattr(a, prop) == getattr(b, prop)


def test_named_set_lookup():
    assert set(tp.ALL_NAMED_PARAMS) == set(jp.ALL_NAMED_PARAMS)
    p = tp.shortint_params("PARAM_MESSAGE_2_CARRY_2_KS_PBS")
    assert (p.lwe_dimension, p.glwe_dimension, p.polynomial_size) == (742, 1, 2048)
    assert (p.pbs_base_log, p.pbs_level, p.ks_base_log, p.ks_level) == (23, 1, 3, 5)
    assert tp.shortint_params("TEST_PARAMS_SHORTINT") is tp.TEST_PARAMS_SHORTINT


def test_random_sources_take_no_default_device():
    """`rng.generator` and `seeded.bsk_masks_from_seed` name their device:
    called without one, they raise (no silent CPU default)."""
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import seeded
    with pytest.raises(TypeError, match="device"):
        rng.generator(1, 2)
    with pytest.raises(TypeError, match="device"):
        seeded.bsk_masks_from_seed(1, 2, 1, 2, 8)
    assert rng.generator(1, 2, device="cpu").device.type == "cpu"
    assert tuple(seeded.bsk_masks_from_seed(1, 2, 1, 2, 8, "cpu").shape) == (2, 1, 2, 1, 8)


def test_u128_constructors_take_no_default_device():
    """`u128.from_python_int`, `from_python_ints` and `zeros128` name their
    device: called without one, they raise (no silent CPU default)."""
    from tfhe_tpu_torch.core import u128
    with pytest.raises(TypeError, match="device"):
        u128.from_python_int(3, (2,))
    with pytest.raises(TypeError, match="device"):
        u128.from_python_ints([3, 4])
    with pytest.raises(TypeError, match="device"):
        u128.zeros128((2,))
    assert u128.from_python_int(3, (2,), "cpu").device.type == "cpu"
    assert u128.from_python_ints([3, 4], "cpu").shape == (2, 2)
    assert u128.zeros128((2,), "cpu").shape == (2, 2)
