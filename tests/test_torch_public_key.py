"""The port's public keys (`tfhe_tpu_torch.core.algorithms.public_key`,
`tfhe_tpu_torch.boolean`'s) against the JAX package's, at
TEST_PARAMS_SHORTINT and TEST_PARAMS_BOOLEAN on numpy secret keys:
encryption under the same public key and threefry key is bit-identical
(the subset is `binary_key`; the sum exact), also through the boolean
scheme's seeds and forks; the subset sum (K2′'s plain version on the CPU)
equals a plain numpy masked sum; the port's public keys have the JAX
package's masks, and bodies within 8 sigma of its; the compact key's r is
the JAX package's (its ciphertexts differ from the JAX package's by noise
alone) and they decrypt right."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.boolean as JB
from tfhe_tpu.core import rng as J
from tfhe_tpu.core.algorithms import public_key as JPK
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN as JPB
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch.core import threefry as T
from tfhe_tpu_torch.core.algorithms import public_key as PK
from tfhe_tpu_torch.core.algorithms.encryption import decrypt_lwe
from tfhe_tpu_torch.core.entities import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN as PB
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from torch_seeded_jax import jax_made, plaintexts, torch_keys

SEEDS = (4, 2 ** 31 + 3)


def _jax_pk():
    return JPK.LwePublicKey(data=jnp.asarray(jax_made("public_key", 17)[0]), log_q=64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (2, 3), (1,)])
def test_encryption_bit_identical_to_jax(seed, shape):
    jpk = _jax_pk()
    pts = plaintexts(shape, seed=seed % 97)
    want = jax.jit(lambda k, p: JPK.encrypt_lwe_with_public_key(k, jpk, p).data)(
        J.fork(J.key_from_seed(seed), 0xB0C), jnp.asarray(pts))
    pk = PK.LwePublicKey(data=from_numpy_u64(np.asarray(jpk.data)))
    got = PK.encrypt_lwe_with_public_key(T.fork(T.key_from_seed(seed, "cpu"), 0xB0C), pk,
                                         from_numpy_u64(pts))
    np.testing.assert_array_equal(to_numpy_u64(got.data), np.asarray(want))
    lwe, _ = torch_keys()
    phase = to_numpy_u64(decrypt_lwe(got, lwe))
    err = (phase - pts).view(np.int64).astype(np.float64)
    assert np.abs(err).max() < 2 ** 50                                  # m = 2^59 steps


def test_subset_sum_is_the_masked_sum():
    pk = PK.LwePublicKey(data=from_numpy_u64(jax_made("public_key", 17)[0]))
    key = T.key_from_seed(77, "cpu")
    pts = from_numpy_u64(plaintexts((9,)))
    got = to_numpy_u64(PK.encrypt_lwe_with_public_key(key, pk, pts).data)
    sel = T.binary_key(key, (9, pk.zero_encryption_count)).numpy().astype(bool)
    data = to_numpy_u64(pk.data)
    want = np.stack([data[s].sum(axis=0, dtype=np.uint64) for s in sel])
    want[:, -1] += to_numpy_u64(pts)
    np.testing.assert_array_equal(got, want)
    assert pk.limbs is None                              # built on the card only


def _bool_keys():
    rng = np.random.default_rng(21)
    lwe = rng.integers(0, 2, PB.lwe_dimension).astype(np.int8)
    glwe = rng.integers(0, 2, (PB.glwe_dimension, PB.polynomial_size)).astype(np.int8)
    jck = JB.ClientKey(lwe_sk=JLweSk(bits=jnp.asarray(lwe)),
                       glwe_sk=JGlweSk(bits=jnp.asarray(glwe)), params=JPB)
    tck = B.ClientKey(lwe_sk=LweSecretKey(bits=torch.as_tensor(lwe.astype(np.int64))),
                      glwe_sk=GlweSecretKey(bits=torch.as_tensor(glwe.astype(np.int64))),
                      params=PB)
    return jck, tck


def test_boolean_public_key_against_jax():
    jck, tck = _bool_keys()
    jpk = jax.jit(lambda: JB.gen_public_key(jck, seed=5))()
    pk = B.gen_public_key(tck, seed=5)
    theirs, mine = np.asarray(jpk.pk.data), to_numpy_u64(pk.pk.data)
    assert mine.shape == theirs.shape == (2 * PB.lwe_dimension, PB.lwe_dimension + 1)
    np.testing.assert_array_equal(mine[:, :-1], theirs[:, :-1])
    diff = (mine[:, -1] - theirs[:, -1]).view(np.int64).astype(np.float64)
    assert np.abs(diff).max() <= 8 * PB.lwe_noise_std and (diff != 0).any()
    # the JAX package's key, encrypted with by both packages
    carried = B.PublicKey(pk=PK.LwePublicKey(data=from_numpy_u64(theirs)), params=PB)
    m = np.array([True, False, True, True, False, False])
    want = jax.jit(lambda: JB.encrypt_with_public_key(jpk, jnp.asarray(m), seed=8).lwe.data)()
    got = B.encrypt_with_public_key(carried, m, seed=8)
    np.testing.assert_array_equal(to_numpy_u64(got.lwe.data), np.asarray(want))
    assert B.decrypt(tck, got).tolist() == m.tolist()
    assert B.decrypt(tck, B.encrypt_with_public_key(pk, m, seed=8)).tolist() == m.tolist()
    cpk = B.gen_compressed_public_key(tck, seed=2)
    assert B.decrypt(tck, B.encrypt_with_public_key(cpk.decompress(), m, seed=1)).tolist() \
        == m.tolist()


@pytest.mark.parametrize("order", ["pbs_ks", "ks_pbs"])
def test_boolean_public_key_against_jax_u32(order):
    """The 32-bit torus (held lifted): the port's public key has the JAX
    package's uint32 masks and bodies within 8 sigma; encryption under the
    JAX package's key is bit-identical to its own, and decrypts."""
    from tfhe_tpu_torch.core.numeric import from_numpy_torus, to_numpy_torus
    from torch_boolean_u32_jax import client_keys, keys
    tck, jck = client_keys(keys(), order)
    std = (tck.params.lwe_noise_std if order == "pbs_ks" else tck.params.glwe_noise_std)
    jpk = jax.jit(lambda: JB.gen_public_key(jck, seed=5))()
    pk = B.gen_public_key(tck, seed=5)
    theirs, mine = np.asarray(jpk.pk.data), to_numpy_torus(pk.pk.data, 32)
    assert theirs.dtype == np.uint32 and pk.pk.log_q == 32
    np.testing.assert_array_equal(mine[:, :-1], theirs[:, :-1])
    diff = (mine[:, -1] - theirs[:, -1]).view(np.int32).astype(np.float64)
    assert np.abs(diff).max() <= 8 * std and (diff != 0).any()
    carried = B.PublicKey(pk=PK.LwePublicKey(data=from_numpy_torus(theirs), log_q=32),
                          params=tck.params)
    m = np.array([True, False, True, True, False, False])
    want = jax.jit(lambda: JB.encrypt_with_public_key(jpk, jnp.asarray(m), seed=8).lwe.data)()
    got = B.encrypt_with_public_key(carried, m, seed=8)
    assert got.log_q == 32
    np.testing.assert_array_equal(to_numpy_torus(got.lwe.data, 32), np.asarray(want))
    assert B.decrypt(tck, got).tolist() == m.tolist()
    assert B.decrypt(tck, B.encrypt_with_public_key(pk, m, seed=8)).tolist() == m.tolist()


def test_compact_encryption_against_jax():
    full, _ = jax_made("compact_public_key", 23)
    jpk = JPK.LweCompactPublicKey(data=jnp.asarray(full), log_q=64)
    pk = PK.LweCompactPublicKey(data=from_numpy_u64(full))
    pts = plaintexts((2, 11), seed=5)
    want = np.asarray(jax.jit(lambda: JPK.encrypt_lwe_compact_batch(
        J.key_from_seed(31), jpk, jnp.asarray(pts), P.lwe_noise_std).data)())
    got = PK.encrypt_lwe_compact_batch(T.key_from_seed(31, "cpu"),
                                       torch.Generator().manual_seed(3), pk,
                                       from_numpy_u64(pts), P.lwe_noise_std)
    mine = to_numpy_u64(got.data)
    assert mine.shape == want.shape == (2, 11, P.lwe_dimension + 1)
    # the same r: masks (a*r + e1) and bodies (b*r + e2 + m) differ by noise alone
    diff = (mine - want).view(np.int64).astype(np.float64)
    assert np.abs(diff).max() <= 8 * P.lwe_noise_std
    lwe, _ = torch_keys()
    phase = to_numpy_u64(decrypt_lwe(got, lwe))
    dec = ((phase + np.uint64(1 << 58)) >> np.uint64(59)) % np.uint64(16)
    np.testing.assert_array_equal(dec, pts >> np.uint64(59))
    with pytest.raises(ValueError, match="slots"):
        PK.encrypt_lwe_compact_batch(T.key_from_seed(1, "cpu"), torch.Generator(), pk,
                                     torch.zeros((P.lwe_dimension + 1,), dtype=torch.int64),
                                     P.lwe_noise_std)


def test_compact_key_needs_a_power_of_two():
    sk = LweSecretKey(bits=torch.ones(12, dtype=torch.int64))
    with pytest.raises(ValueError, match="power-of-two"):
        PK.generate_lwe_compact_public_key(T.key_from_seed(1, "cpu"), torch.Generator(), sk, 1.0)
