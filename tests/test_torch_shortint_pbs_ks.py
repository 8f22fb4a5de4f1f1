"""ROADMAP C11: the PBS → KS order of the port's shortint `apply_lookup_table`
(36 of the 240 named sets with a PBS have key choice `small`: the bootstrap
runs on the small-key ciphertext, the keyswitch after it), held bit for bit
against tfhe_tpu's on the same numpy keys and ciphertexts, at
TEST_PARAMS_SHORTINT switched to key choice `small` in both packages
(tolerance 0).  The JAX side runs its fused PBS in interpret mode, one
jitted call on 16 rows.  Then the port's own keys of that set, decrypted."""
import dataclasses

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
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JBASE
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as BASE
from tfhe_tpu_torch.core.params import PBSOrder
from torch_keys import _noise, real_keys

U64 = np.uint64
P = dataclasses.replace(BASE, name="TEST_PARAMS_SHORTINT_PBS_KS", encryption_key_choice="small")
JP = dataclasses.replace(JBASE, name="TEST_PARAMS_SHORTINT_PBS_KS",
                         encryption_key_choice="small")
SPACE = P.message_modulus * P.carry_modulus
DELTA = (1 << 64) // (2 * SPACE)


def f_uni(x):
    return (3 * x + 1) % SPACE


@pytest.fixture(scope="module")
def keys():
    k = real_keys(P, seed=41)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, 4))(
        jnp.asarray(k["bsk"]))
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=JP.ks_decomp),
                     bsk=jbsk, params=JP)
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(k["ksk"], P.ks_decomp, device="cpu"),
        bsk=interop.bootstrap_key_from_standard(k["bsk"], P.pbs_decomp, 4, device="cpu"),
        params=P)
    return dict(k, jsk=jsk, tsk=tsk)


@pytest.fixture(scope="module")
def pallas_interpret():
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


def encrypt_small(lwe_bits, msgs, seed):
    """Shortint encryptions [B, n+1] of msgs under the small LWE key."""
    rng = np.random.default_rng(seed)
    msgs = np.asarray(msgs, dtype=U64)
    mask = rng.integers(0, 2 ** 64, msgs.shape + lwe_bits.shape, dtype=U64)
    body = ((mask * lwe_bits.astype(U64)).sum(axis=-1, dtype=U64) + msgs * U64(DELTA)
            + _noise(rng, msgs.shape, P.lwe_noise_std))
    return np.concatenate([mask, body[..., None]], axis=-1)


def decrypt_small(lwe_bits, data):
    phase = data[..., -1] - (data[..., :-1] * lwe_bits.astype(U64)).sum(axis=-1, dtype=U64)
    return ((phase + U64(DELTA >> 1)) // U64(DELTA)) % U64(2 * SPACE)


def test_the_variant_takes_the_pbs_ks_branch():
    assert P.pbs_order == JP.pbs_order == PBSOrder.BOOTSTRAP_KEYSWITCH


def test_apply_lookup_table_pbs_ks_matches_jax(keys, pallas_interpret):
    msgs = np.arange(SPACE)
    data = encrypt_small(keys["lwe_bits"], msgs, seed=1)
    assert (data[:, -1] >> U64(63)).any()          # hazard C1: bodies with the top bit
    jlut = keys["jsk"].generate_lookup_table(f_uni)
    ref = np.asarray(_jax_apply(keys["jsk"], jnp.asarray(data), jlut.acc.data))
    tlut = keys["tsk"].generate_lookup_table(f_uni)
    ct = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=SPACE - 1)
    out = keys["tsk"].apply_lookup_table(ct, tlut)
    assert out.lwe.data.shape == (SPACE, P.lwe_dimension + 1)
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)
    np.testing.assert_array_equal(decrypt_small(keys["lwe_bits"], ref), f_uni(msgs))


def test_chained_pbs_ks_matches_jax(keys, pallas_interpret):
    """The output (small key again) feeds a second LUT, as a circuit chains."""
    msgs = np.arange(SPACE)
    data = encrypt_small(keys["lwe_bits"], msgs, seed=2)
    g = lambda x: (x * x + 5) % SPACE
    jsk, tsk = keys["jsk"], keys["tsk"]
    ref = _jax_apply(jsk, jnp.asarray(data), jsk.generate_lookup_table(f_uni).acc.data)
    ref = np.asarray(_jax_apply(jsk, ref, jsk.generate_lookup_table(g).acc.data))
    ct = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=SPACE - 1)
    out = tsk.apply_lookup_table(tsk.apply_lookup_table(ct, tsk.generate_lookup_table(f_uni)),
                                 tsk.generate_lookup_table(g))
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)
    np.testing.assert_array_equal(decrypt_small(keys["lwe_bits"], ref), g(f_uni(msgs)))


def test_port_keys_pbs_ks_round_trip():
    ck, sk = shortint.gen_keys(P, seed=5, device="cpu")
    assert ck.encryption_key is ck.lwe_sk
    msgs = torch.arange(SPACE)
    out = sk.apply_lookup_table(ck.encrypt(msgs, seed=1), sk.generate_lookup_table(f_uni))
    assert out.lwe.data.shape == (SPACE, P.lwe_dimension + 1)
    assert torch.equal(ck.decrypt_message_and_carry(out), f_uni(msgs))
    a, b = msgs % 4, msgs // 4
    assert torch.equal(ck.decrypt(sk.mul(ck.encrypt(a, seed=2), ck.encrypt(b, seed=3))),
                       (a * b) % 4)
