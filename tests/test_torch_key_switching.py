"""Shortint's casting key (`tfhe_tpu_torch/shortint/key_switching_key.py`)
and the rest of shortint's server key, against tfhe_tpu on the same numpy
keys and ciphertexts (tolerance 0):

* `KeySwitchingKey.cast` in its three branches: between two key sets of one
  plaintext space (a keyswitch), from TEST_PARAMS_TRIVIUM's 8 values into
  TEST_PARAMS_SHORTINT's 16 (a keyswitch, then n >> 1 under the wider set)
  and back (n << 1 under the wider set, then a keyswitch), on the 15 x 1
  decomposition of PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS; decrypted;
* `generate_key_switching_key`: masks bit for bit JAX's under the same seed,
  bodies within 8 sigma (the noise is each package's own, ROADMAP C5);
* `generate_lookup_table_raw`, the deterministic-execution flags, the key
  sizes (the port's in its int32 spectra) and the parameter accessors;
* `gen_compressed_server_key` on a multi-bit set: a classic key, as the JAX
  package makes it; the JAX package's decompression of the port's seeded
  key bit-identical to the port's, and KS+PBS on both equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.algorithms.seeded as JS
import tfhe_tpu.shortint.key_switching_key as JKS
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import MultiBitPBSParameters as JMultiBit
from tfhe_tpu.core.params import ShortintKeySwitchingParameters as JKsParams
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.params import TEST_PARAMS_TRIVIUM as JPT
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core.algorithms import seeded as TS
from tfhe_tpu_torch.core.entities import LweCiphertext, NttBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters, ShortintKeySwitchingParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import TEST_PARAMS_TRIVIUM as PT
from tfhe_tpu_torch.core.params import DecompParams
from torch_jax_pbs import interpreted_pbs, jax_server, num_primes, port_keys
from torch_keys import decrypt_big, encrypt_big, multi_bit_params, real_keys

U64 = np.uint64
CAST = DecompParams(1, 15)        # PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS's 15 x 1
F = lambda x: (5 * x + 2) % 16


def cast_ksk(rng, in_bits, out_bits, std):
    """A keyswitching key [n_in, 15, n_out+1] from in_bits to out_bits on
    the 15 x 1 decomposition."""
    g = np.array([1 << (64 - CAST.base_log * (l + 1)) for l in range(CAST.level)], dtype=U64)
    pts = in_bits.astype(U64)[:, None] * g
    mask = rng.integers(0, 2 ** 64, pts.shape + (out_bits.size,), dtype=U64)
    noise = np.round(rng.normal(0.0, std, pts.shape)).astype(np.int64).view(U64)
    body = (mask * out_bits.astype(U64)).sum(axis=-1, dtype=U64) + pts + noise
    return np.concatenate([mask, body[..., None]], axis=-1)


@pytest.fixture(scope="module")
def sides():
    """Key sets 1 (TEST_PARAMS_TRIVIUM), 2 and 3 (TEST_PARAMS_SHORTINT, two
    keys) on numpy keys, in both packages."""
    torch.set_num_threads(1)
    keys = {"triv": (real_keys(PT, seed=31), PT, JPT), "a": (real_keys(P, seed=32), P, JP),
            "b": (real_keys(P, seed=33), P, JP)}
    out = {}
    for name, (k, p, jp) in keys.items():
        tck, tsk = port_keys(k, p)
        out[name] = dict(k=k, p=p, jp=jp, tsk=tsk, tck=tck, jsk=jax_server(k, jp))
    with interpreted_pbs():
        yield out


@pytest.mark.parametrize("src, dst, rshift", [("a", "b", 0), ("triv", "a", 1),
                                              ("a", "triv", -1)])
def test_cast_equals_jax(sides, src, dst, rshift):
    s, d = sides[src], sides[dst]
    rng = np.random.default_rng(34 + rshift)
    ksk = cast_ksk(rng, s["k"]["big_bits"], d["k"]["big_bits"], d["p"].glwe_noise_std)
    tkey = interop.casting_key(ksk, CAST, d["p"], rshift, dest_server_key=d["tsk"],
                               src_server_key=s["tsk"], device="cpu")
    jkey = JKS.KeySwitchingKey(ksk=JKsk(data=jnp.asarray(ksk), decomp=JDecomp(1, 15)),
                               dest_params=d["jp"], cast_rshift=rshift,
                               dest_server_key=d["jsk"], src_server_key=s["jsk"])
    space = s["p"].message_modulus * s["p"].carry_modulus
    msgs = [0, 1, space // 2 - 1, 3] if rshift < 0 else [0, 1, space - 1, 3]
    data = encrypt_big(s["p"], s["k"]["big_bits"], msgs, seed=35)
    m, c = s["p"].message_modulus, s["p"].carry_modulus
    tct = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=max(msgs),
                              message_modulus=m, carry_modulus=c)
    jct = JCt(lwe=JLwe(data=jnp.asarray(data)), degree=max(msgs), message_modulus=m,
              carry_modulus=c)
    out, jout = tkey.cast(tct), jkey.cast(jct)
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), np.asarray(jout.lwe.data))
    assert (out.degree, out.noise_level, out.message_modulus, out.carry_modulus) == \
        (jout.degree, jout.noise_level, jout.message_modulus, jout.carry_modulus)
    np.testing.assert_array_equal(decrypt_big(d["p"], d["k"]["big_bits"],
                                              to_numpy_u64(out.lwe.data)), msgs)


def test_generate_key_switching_key_matches_jax(sides):
    """Masks bit for bit JAX's under fork(key_from_seed(seed), 0xC5); the
    bodies differ only by each package's noise (within 8 sigma)."""
    s, d = sides["triv"], sides["a"]
    params = ShortintKeySwitchingParameters(ks_base_log=1, ks_level=15)

    def jck(side):
        return JClientKey(glwe_sk=JGlweSk(bits=jnp.asarray(side["k"]["glwe_bits"])),
                          lwe_sk=JLweSk(bits=jnp.asarray(side["k"]["lwe_bits"])),
                          params=side["jp"])
    jkey = jax.jit(lambda: JKS.generate_key_switching_key(
        jck(s), jck(d), JKsParams(ks_base_log=1, ks_level=15), seed=36,
        dest_server_key=d["jsk"]).ksk.data)()
    tkey = shortint.generate_key_switching_key(s["tck"], d["tck"], params, seed=36,
                                               dest_server_key=d["tsk"])
    got, want = to_numpy_u64(tkey.ksk.data), np.asarray(jkey)
    np.testing.assert_array_equal(got[..., :-1], want[..., :-1])
    diff = (got[..., -1] - want[..., -1]).view(np.int64).astype(np.float64)
    assert np.abs(diff).max() <= 8 * np.sqrt(2) * d["p"].glwe_noise_std
    assert tkey.cast_rshift == 1
    with pytest.raises(ValueError, match="dest_server_key"):
        shortint.generate_key_switching_key(s["tck"], d["tck"], params)
    with pytest.raises(ValueError, match="src_server_key"):
        shortint.generate_key_switching_key(d["tck"], s["tck"], params)


def test_server_key_leftovers_equal_jax(sides):
    a = sides["a"]
    tsk, jsk = a["tsk"], a["jsk"]
    raw = np.array([(1 << 64) - 1 - 5 * i for i in range(16)], dtype=U64)
    np.testing.assert_array_equal(to_numpy_u64(tsk.generate_lookup_table_raw(raw).acc.data),
                                  np.asarray(jsk.generate_lookup_table_raw(raw).acc.data))
    assert tsk.generate_lookup_table_raw(raw).degree == jsk.generate_lookup_table_raw(raw).degree
    with pytest.raises(ValueError):
        tsk.generate_lookup_table_raw(raw[:4])
    assert tsk.deterministic_pbs_execution() is jsk.deterministic_pbs_execution() is True
    tsk.set_deterministic_pbs_execution(True)
    for sk in (tsk, jsk):
        with pytest.raises(ValueError):
            sk.set_deterministic_pbs_execution(False)
    for name in ("input_lwe_dimension", "output_lwe_dimension", "glwe_size", "polynomial_size",
                 "decomposition_base_log", "decomposition_level_count",
                 "key_switching_key_size_elements", "key_switching_key_size_bytes"):
        assert getattr(tsk, name)() == getattr(jsk, name)(), name
    n, k, N, L = P.lwe_dimension, P.glwe_dimension, P.polynomial_size, P.pbs_level
    spectra = n * num_primes(P) * L * (k + 1) * (k + 1) * N
    assert tsk.bootstrapping_key_size_elements() == spectra
    assert tsk.bootstrapping_key_size_bytes() == 4 * spectra


def test_compressed_server_key_on_a_multi_bit_set():
    """The compressed key on multi-bit parameters is classic (both
    packages); its decompression in JAX bit-identical to the port's, and
    KS+PBS on both keys equal and right."""
    params = multi_bit_params(MultiBitPBSParameters, P, 2, 16)
    jparams = multi_bit_params(JMultiBit, JP, 2, 16)
    ck = shortint.gen_client_key(params, seed=37, device="cpu")
    csk = shortint.gen_compressed_server_key(ck, seed=38)
    sk = csk.decompress()
    assert isinstance(sk.bsk, NttBootstrapKey)
    sb, sksk = csk.seeded_bsk, csk.seeded_ksk
    jb = JS.SeededLweBootstrapKey(bodies=jnp.asarray(to_numpy_u64(sb.bodies)), seed=sb.seed,
                                  decomp=JDecomp(sb.decomp.base_log, sb.decomp.level))
    jk = JS.SeededLweKeyswitchKey(bodies=jnp.asarray(to_numpy_u64(sksk.bodies)), seed=sksk.seed,
                                  decomp=JDecomp(sksk.decomp.base_log, sksk.decomp.level),
                                  output_lwe_dimension=sksk.output_lwe_dimension)
    jstd = jax.jit(lambda s: JS.decompress_bootstrap_key(s).data)(jb)
    jksk = jax.jit(lambda s: JS.decompress_keyswitch_key(s).data)(jk)
    np.testing.assert_array_equal(to_numpy_u64(TS.decompress_bootstrap_key(sb).data),
                                  np.asarray(jstd))
    np.testing.assert_array_equal(to_numpy_u64(sk.ksk.data), np.asarray(jksk))
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=jparams.pbs_decomp), 64,
                                        num_primes(jparams)))(jstd)
    jsk = JServerKey(ksk=JKsk(data=jksk, decomp=jparams.ks_decomp), bsk=jbsk, params=jparams)
    ct = ck.encrypt(torch.tensor([0, 3, 7, 12]), seed=39)
    with interpreted_pbs():
        out = sk.apply_lookup_table(ct, sk.generate_lookup_table(F))
        jout = jsk.apply_lookup_table(
            JCt(lwe=JLwe(data=jnp.asarray(to_numpy_u64(ct.lwe.data))), degree=3,
                message_modulus=4, carry_modulus=4), jsk.generate_lookup_table(F))
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), np.asarray(jout.lwe.data))
    assert ck.decrypt(out).tolist() == [F(m) % 4 for m in (0, 3, 7, 12)]
