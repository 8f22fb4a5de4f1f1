"""The port's C API: the flat Python surface (`tfhe_tpu_torch.capi`) against
the JAX package's (`tfhe_tpu.capi`) on the same numpy key at
TEST_PARAMS_SHORTINT, every handle decrypted to the same value in both
packages and to the clear result; the boolean and shortint surfaces of the
port; the device the surface reads from TFHE_TPU_TORCH_DEVICE (the card by
default, refused with a clear error without one); and the unchanged C
client (tests/c_api/test_high_level_integers.c) built against
libtfhe_tpu_torch_capi.so and run on the CPU, printing PASS.

The JAX side's PBS is tests/torch_jax_pbs.py `interpreted_pbs()`; never
JAX keygen here."""
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import tfhe_tpu.capi as JC
import tfhe_tpu.hlapi as JH
import tfhe_tpu.integer as JI
import tfhe_tpu.shortint.client_key as JSC
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu_torch import capi as TC
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from torch_jax_pbs import interpreted_pbs, jax_server, port_keys
from torch_keys import real_keys

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cpu_surface(monkeypatch):
    monkeypatch.setenv(TC.DEVICE_ENV, "cpu")
    monkeypatch.setattr(TC, "_DEVICE", None)
    assert TC.init() == TC.OK
    yield TC
    TC.hlapi.unset_server_key()


def _handles(mod, ck, sk):
    return mod._new(ck), mod._new(sk)


def test_surface_decrypts_as_the_jax_surface(cpu_surface):
    torch.set_num_threads(1)
    k = real_keys(P, seed=61)
    tck, tsk = port_keys(k, P)
    jck = JSC.ClientKey(glwe_sk=JGlweSk(bits=k["glwe_bits"]), lwe_sk=JLweSk(bits=k["lwe_bits"]),
                        params=JP)
    tcl, tsv = interop.hlapi_keys(tck, tsk)
    sides = {"port": (TC, *_handles(TC, tcl, tsv)),
             "jax": (JC, *_handles(JC, JH.ClientKey(jck),
                                   JH.ServerKey(JI.ServerKey(key=jax_server(k, JP)))))}
    got = {}
    with interpreted_pbs():
        for name, (mod, ck, sk) in sides.items():
            assert mod.set_server_key(sk) == mod.OK
            st, a = mod.fheuint8_try_encrypt_with_client_key(57, ck, seed=1)
            st2, b = mod.fheuint8_try_encrypt_with_client_key(13, ck, seed=2)
            assert st == st2 == mod.OK
            handles = {"add": mod.fheuint8_add(a, b), "bitand": mod.fheuint8_bitand(a, b),
                       "bitxor": mod.fheuint8_bitxor(a, b),
                       "scalar_add": mod.fheuint8_scalar_add(a, 250),
                       "eq": mod.fheuint8_eq(a, a)}
            st, blob = mod.serialize(a)
            assert st == mod.OK and blob
            handles["round_trip"] = mod.deserialize_fheuint8(blob)
            values = {}
            for op, (st, h) in handles.items():
                assert st == mod.OK, (name, op)
                st, values[op] = mod.fheuint8_decrypt(h, ck)
                assert st == mod.OK, (name, op)
            assert mod.destroy(a) == mod.OK and mod.destroy(a) == mod.ERR
            got[name] = values
            mod.hlapi.unset_server_key()
    assert got["port"] == got["jax"] == {"add": 70, "bitand": 57 & 13, "bitxor": 57 ^ 13,
                                         "scalar_add": (57 + 250) % 256, "eq": 1,
                                         "round_trip": 57}


def test_boolean_and_shortint_surfaces(cpu_surface):
    st, ck, sk = TC.boolean_gen_keys("TEST_PARAMS_BOOLEAN", seed=3)
    assert st == TC.OK
    cts = [TC.boolean_encrypt(v, ck, seed=i)[1] for i, v in enumerate((1, 0, 1))]
    for gate, want in (("and", 0), ("or", 1), ("xor", 1), ("nand", 1), ("nor", 0),
                       ("xnor", 0)):
        st, h = getattr(TC, f"boolean_{gate}")(sk, cts[0], cts[1])
        assert st == TC.OK and TC.boolean_decrypt(h, ck) == (TC.OK, want), gate
    st, h = TC.boolean_mux(sk, cts[1], cts[0], cts[2])
    assert TC.boolean_decrypt(h, ck) == (TC.OK, 1)
    assert TC.boolean_decrypt(TC.boolean_not(sk, cts[0])[1], ck) == (TC.OK, 0)
    st, ck, sk = TC.shortint_gen_keys("TEST_PARAMS_SHORTINT", seed=4)
    a, b = TC.shortint_encrypt(3, ck, seed=1)[1], TC.shortint_encrypt(2, ck, seed=2)[1]
    for op, want in (("add", (3 + 2) % 4), ("bitand", 2), ("greater", 1), ("mul", 6 % 4)):
        st, h = getattr(TC, f"shortint_{op}")(sk, a, b)
        assert TC.shortint_decrypt(h, ck) == (TC.OK, want), op
    st, blob = TC.serialize(a)
    st, a2 = TC.deserialize_shortint(blob)
    assert TC.shortint_decrypt(a2, ck) == (TC.OK, 3)
    assert TC.config_builder_custom("NO_SUCH_SET") == (TC.ERR, 0)


def test_device_from_the_environment(monkeypatch):
    monkeypatch.setattr(TC, "_DEVICE", None)
    monkeypatch.delenv(TC.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="TFHE_TPU_TORCH_DEVICE=cpu"):
        TC.init()
    assert TC.generate_keys(TC.config_builder_default()[1]) == (TC.ERR, 0, 0)
    monkeypatch.setenv(TC.DEVICE_ENV, "cpu")
    assert TC.init() == TC.OK and TC._device() == torch.device("cpu")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_c_client_against_the_port_library(tmp_path):
    from tfhe_tpu_torch import native
    so = native.build_capi()
    binary = tmp_path / "test_high_level_integers"
    subprocess.run(["g++", "-O2", str(REPO / "tests" / "c_api" / "test_high_level_integers.c"),
                    f"-I{native.INCLUDE}", f"-L{so.parent}", f"-Wl,-rpath,{so.parent}",
                    "-ltfhe_tpu_torch_capi", "-o", str(binary)], check=True, capture_output=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), TFHE_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="2")
    res = subprocess.run([str(binary)], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "PASS" in res.stdout
    if not torch.cuda.is_available():
        env.pop("TFHE_TPU_TORCH_DEVICE")
        res = subprocess.run([str(binary)], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0 and "PASS" not in res.stdout
        assert "TFHE_TPU_TORCH_DEVICE=cpu" in res.stderr
