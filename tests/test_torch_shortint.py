"""The slice as a whole: the port's shortint keyswitch + PBS against
tfhe_tpu's (fused kernel in interpret mode) on the same numpy keys and
ciphertexts, bit for bit; and the port's own keygen → encrypt →
apply_lookup_table → decrypt round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import cuda_lib, interop, shortint
from tfhe_tpu_torch.core.algorithms import decrypt_lwe, keyswitch
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import rotation
from torch_keys import decrypt_big, encrypt_big, real_keys

SPACE = P.message_modulus * P.carry_modulus


def f_uni(x):
    return (3 * x + 1) % SPACE


def f_bi(a, b):
    return (a * b + a) % P.message_modulus


@pytest.fixture(scope="module")
def keys():
    k = real_keys(P, seed=31)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, 4))(
        jnp.asarray(k["bsk"]))
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=JP.ks_decomp),
                     bsk=jbsk, params=JP)
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(k["ksk"], P.ks_decomp, device="cpu"),
        bsk=interop.bootstrap_key_from_standard(k["bsk"], P.pbs_decomp, 4, device="cpu"),
        params=P)
    return dict(k, jsk=jsk, tsk=tsk)


@pytest.fixture
def pallas_interpret():
    """The JAX package's fused-kernel path in interpret mode, as
    tests/test_parallel.py runs it; both switches restored afterwards."""
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    yield
    config.set_use_pallas_pbs(old[0])
    config.set_pallas_interpret(old[1])


@jax.jit
def _jax_apply(sk, data, acc):
    ct = JCt(lwe=JLwe(data=data), degree=SPACE - 1, message_modulus=4, carry_modulus=4)
    return sk.apply_lookup_table(ct, JLut(acc=JGlwe(data=acc), degree=0)).lwe.data


def _port_ct(data, degree):
    return shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)),
                               degree=degree)


def test_apply_lookup_table_matches_jax(keys, pallas_interpret):
    msgs = np.arange(SPACE)
    data = encrypt_big(P, keys["big_bits"], msgs, seed=1)
    jlut = keys["jsk"].generate_lookup_table(f_uni)
    ref = np.asarray(_jax_apply(keys["jsk"], jnp.asarray(data), jlut.acc.data))

    tlut = keys["tsk"].generate_lookup_table(f_uni)
    np.testing.assert_array_equal(to_numpy_u64(tlut.acc.data), np.asarray(jlut.acc.data))
    assert tlut.degree == jlut.degree
    out = keys["tsk"].apply_lookup_table(_port_ct(data, SPACE - 1), tlut)
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)
    np.testing.assert_array_equal(decrypt_big(P, keys["big_bits"], ref), f_uni(msgs))
    assert out.degree == tlut.degree
    ck = shortint.ClientKey(glwe_sk=interop.glwe_secret_key(keys["glwe_bits"], device="cpu"),
                            lwe_sk=interop.lwe_secret_key(keys["lwe_bits"], device="cpu"),
                            params=P)
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out).numpy(), f_uni(msgs))


def test_bivariate_lookup_table_matches_jax(keys, pallas_interpret):
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 4, 16), rng.integers(0, 4, 16)
    left = encrypt_big(P, keys["big_bits"], a, seed=2)
    right = encrypt_big(P, keys["big_bits"], b, seed=3)
    jsk = keys["jsk"]
    jct = lambda d: JCt(lwe=JLwe(data=jnp.asarray(d)), degree=3)
    packed = jsk.unchecked_bivariate_pack(jct(left), jct(right))
    jlut = jsk.generate_bivariate_lookup_table(f_bi)
    ref = np.asarray(_jax_apply(jsk, packed.lwe.data, jlut.acc.data))

    tsk = keys["tsk"]
    tlut = tsk.generate_bivariate_lookup_table(f_bi)
    out = tsk.unchecked_apply_lookup_table_bivariate(_port_ct(left, 3), _port_ct(right, 3),
                                                     tlut)
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)
    np.testing.assert_array_equal(decrypt_big(P, keys["big_bits"], ref), f_bi(a, b))


@pytest.fixture(scope="module")
def port_keys():
    return shortint.gen_keys(P, seed=5, device="cpu")


def test_port_round_trip_all_inputs(port_keys):
    ck, sk = port_keys
    msgs = torch.arange(SPACE)
    ct = ck.encrypt(msgs, seed=1)
    assert torch.equal(ck.decrypt_message_and_carry(ct), msgs)
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(f_uni))
    assert torch.equal(ck.decrypt_message_and_carry(out), f_uni(msgs))
    # chained, as bench.py chains: the second LUT reads the first's output
    out2 = sk.apply_lookup_table(out, sk.generate_lookup_table(lambda x: (x + 5) % SPACE))
    assert torch.equal(ck.decrypt_message_and_carry(out2), (f_uni(msgs) + 5) % SPACE)
    a, b = msgs % 4, msgs // 4
    biv = sk.unchecked_apply_lookup_table_bivariate(
        ck.encrypt(a, seed=2), ck.encrypt(b, seed=3),
        sk.generate_bivariate_lookup_table(f_bi))
    assert torch.equal(ck.decrypt(biv), f_bi(a, b))


def test_port_encryption_noise_std(port_keys):
    """Fresh-encryption noise (generator-made, so held statistically): its
    empirical std over 4096 samples lies within 10% of the parameter's."""
    ck, _ = port_keys
    ct = ck.encrypt(torch.zeros(4096, dtype=torch.int64), seed=9)
    noise = decrypt_lwe(ct.lwe, ck.encryption_key).to(torch.float64)
    assert abs(noise.mean().item()) < 0.1 * P.glwe_noise_std
    assert abs(noise.std().item() / P.glwe_noise_std - 1.0) < 0.10


def test_cpu_path_launches_no_kernel(port_keys):
    ck, sk = port_keys
    before = (rotation.launches, keyswitch.launches)
    sk.apply_lookup_table(ck.encrypt([1, 2], seed=4), sk.generate_lookup_table(f_uni))
    assert (rotation.launches, keyswitch.launches) == before == (0, 0)


def test_cuda_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(cuda_lib.BuildError, match="nvcc"):
        cuda_lib.library()
