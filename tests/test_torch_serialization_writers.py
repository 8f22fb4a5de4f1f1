"""The rest of the port's write side and the 32-bit torus in files
(`tfhe_tpu_torch.utils.serialization` against `tfhe_tpu.utils.serialization`):
every type the JAX registry names has a reader and a writer in the port;
the standard-domain `LweBootstrapKey`, the multi-bit NTT key, the boolean
`ClientKey` and `ServerKey` and the shortint `LookupTable` cross both ways
word for word (the keys' residues and Shoup quotients those of the JAX
conversions); at TEST_PARAMS_BOOLEAN_U32, in both PBS orders, every boolean
type the port writes reads in the JAX package as its uint32 words, the
JAX package's files read into the port's lifted words, and a gate on keys
and ciphertexts that crossed both ways equals the JAX package's bit for
bit.  Every JAX call is jitted (never JAX keygen)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.boolean as JB
import tfhe_tpu.utils.serialization as JSer
from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN as JPB
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_torus, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN as PB
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.utils import serialization as Ser
from torch_keys import real_keys

F = lambda x: (3 * x + 1) % 4


def test_every_registered_type_read_and_written():
    """Every type the JAX registry names has a reader and a writer here."""
    JSer._register_known_types()
    Ser._register()
    names = set(JSer._REGISTRY)
    assert names <= set(Ser._READERS)
    assert names <= set(Ser._WRITERS.values())


def test_standard_and_multi_bit_keys_both_ways(tmp_path):
    """The standard-domain LweBootstrapKey and the multi-bit NTT key: the
    port's file reads in the JAX package word for word (the multi-bit key's
    residues and Shoup quotients as the JAX conversion makes them, in DIF
    order), and the JAX package's reads back into the port's key."""
    import dataclasses
    from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb
    from tfhe_tpu_torch.core.entities import LweBootstrapKey
    from tfhe_tpu_torch.core.params import MultiBitPBSParameters
    from torch_keys import real_multi_bit_keys
    std = LweBootstrapKey(data=from_numpy_u64(real_keys(P, seed=3)["bsk"]), decomp=P.pbs_decomp)
    Ser.safe_save(std, tmp_path / "std.npz")
    jstd = JSer.safe_load(tmp_path / "std.npz", expected_type="LweBootstrapKey")
    np.testing.assert_array_equal(np.asarray(jstd.data), to_numpy_u64(std.data))
    back = Ser.safe_load(tmp_path / "std.npz", device="cpu")
    assert torch.equal(back.data, std.data) and back.decomp == std.decomp
    mp = MultiBitPBSParameters(**{**dataclasses.asdict(P), "lwe_dimension": 16,
                                  "grouping_factor": 2})
    k = real_multi_bit_keys(mp, seed=4)
    npr = external_product_num_primes(mp.polynomial_size, mp.glwe_size, mp.pbs_decomp)
    tkey = interop.multi_bit_bootstrap_key_from_standard(k["bsk"], mp.pbs_decomp, 2, npr,
                                                         device="cpu")
    Ser.save(tkey, tmp_path / "mb.npz")
    jkey = JSer.safe_load(tmp_path / "mb.npz", expected_type="NttMultiBitBootstrapKey")
    want = jax.jit(lambda d: jax_mb(d, JP.pbs_decomp, 2, 64))(jnp.asarray(k["bsk"]))
    np.testing.assert_array_equal(np.asarray(jkey.data), np.asarray(want.data))
    np.testing.assert_array_equal(np.asarray(jkey.shoup), np.asarray(want.shoup))
    assert jkey.data_u32 is None and jkey.grouping_factor == 2
    JSer.save(want, tmp_path / "jmb.npz", compress=False)
    got = Ser.load(tmp_path / "jmb.npz", device="cpu")
    assert torch.equal(got.spectra, tkey.spectra) and got.primes == tkey.primes


def test_boolean_keys_and_lookup_table_both_ways(tmp_path):
    """The boolean ClientKey and ServerKey (64-bit) and a shortint
    LookupTable: the port's files read in the JAX package with the same
    words (the BSK's residues those of the JAX conversion), and back."""
    from torch_boolean_jax import numpy_keys, servers
    keys = numpy_keys(61)
    tsk, jsk = servers(keys, "pbs_ks")
    Ser.save(tsk, tmp_path / "bsk.npz")
    back = JSer.safe_load(tmp_path / "bsk.npz", expected_type="boolean.ServerKey")
    np.testing.assert_array_equal(np.asarray(back.bsk.data), np.asarray(jsk.bsk.data))
    np.testing.assert_array_equal(np.asarray(back.bsk.shoup), np.asarray(jsk.bsk.shoup))
    np.testing.assert_array_equal(np.asarray(back.ksk.data), np.asarray(jsk.ksk.data))
    assert back.params == jsk.params and back.bsk.log_q == 64
    again = Ser.load(tmp_path / "bsk.npz", device="cpu")
    assert torch.equal(again.bsk.spectra, tsk.bsk.spectra)
    tck = B.ClientKey(lwe_sk=interop.lwe_secret_key(keys["lwe_bits"], device="cpu"),
                      glwe_sk=interop.glwe_secret_key(keys["glwe_bits"], device="cpu"),
                      params=PB)
    Ser.save(tck, tmp_path / "bck.npz")
    jck = JSer.safe_load(tmp_path / "bck.npz", expected_type="boolean.ClientKey")
    np.testing.assert_array_equal(np.asarray(jck.glwe_sk.bits), keys["glwe_bits"])
    assert jck.params == JPB
    ck, sk = shortint.gen_keys(P, seed=2, device="cpu")
    lut = sk.generate_lookup_table(F)
    Ser.save(lut, tmp_path / "lut.npz")
    jlut = JSer.safe_load(tmp_path / "lut.npz", expected_type="LookupTable")
    np.testing.assert_array_equal(np.asarray(jlut.acc.data), to_numpy_u64(lut.acc.data))
    assert jlut.degree == lut.degree
    JSer.save(jlut, tmp_path / "jlut.npz")
    got = Ser.load(tmp_path / "jlut.npz", device="cpu")
    assert torch.equal(got.acc.data, lut.acc.data) and got.degree == lut.degree


@pytest.mark.parametrize("order", ["pbs_ks", "ks_pbs"])
def test_u32_boolean_files_both_ways(order, tmp_path):
    """The 32-bit torus: every boolean type the port writes reads in the JAX
    package as uint32 words equal to the JAX package's on the same keys
    (the server key's BSK residues over the 32-bit prime count, word for
    word), and the JAX package's files read into the port's lifted words;
    a gate on keys and ciphertexts that crossed both ways equals the JAX
    package's gate bit for bit, and decrypts."""
    from torch_boolean_u32_jax import (both, client_keys, encrypt_bool, jitted_boolean, keys,
                                       servers, words)
    k = keys()
    tck, jck = client_keys(k, order)
    tsk, jsk = servers(k, order)
    Ser.save(tsk, tmp_path / "sk.npz")
    jsk2 = JSer.safe_load(tmp_path / "sk.npz", expected_type="boolean.ServerKey")
    assert jsk2.bsk.log_q == 32 and jsk2.bsk.paired is None
    np.testing.assert_array_equal(np.asarray(jsk2.bsk.data), np.asarray(jsk.bsk.data))
    np.testing.assert_array_equal(np.asarray(jsk2.bsk.shoup), np.asarray(jsk.bsk.shoup))
    assert np.asarray(jsk2.ksk.data).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(jsk2.ksk.data), np.asarray(jsk.ksk.data))
    JSer.save(jsk, tmp_path / "jsk.npz", compress=False)
    tsk2 = Ser.load(tmp_path / "jsk.npz", device="cpu")
    assert tsk2.bsk.route == "rotate" and torch.equal(tsk2.bsk.spectra, tsk.bsk.spectra)
    assert torch.equal(tsk2.ksk.data, tsk.ksk.data)
    Ser.save(tck, tmp_path / "ck.npz")
    assert JSer.safe_load(tmp_path / "ck.npz").params == jck.params
    m = np.array([True, False, True, False])
    ta, ja = both(encrypt_bool(k, order, m, seed=3))
    tb, jb = both(encrypt_bool(k, order, ~m, seed=4))
    Ser.save(ta, tmp_path / "a.npz")
    ja2 = JSer.safe_load(tmp_path / "a.npz", expected_type="BoolCiphertext")
    assert np.asarray(ja2.lwe.data).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(ja2.lwe.data), np.asarray(ja.lwe.data))
    JSer.save(jb, tmp_path / "b.npz")
    tb2 = Ser.load(tmp_path / "b.npz", device="cpu")
    assert tb2.log_q == 32 and torch.equal(tb2.lwe.data, tb.lwe.data)
    with jitted_boolean():
        want = np.asarray(JB.nand(jsk2, ja2, jb).lwe.data)
    got = B.nand(tsk2, ta, tb2)
    np.testing.assert_array_equal(words(got), want)
    assert B.decrypt(tck, got).tolist() == (~(m & ~m)).tolist()
    for name, obj in (("pk", B.gen_public_key(tck, seed=3)),
                      ("cpk", B.gen_compressed_public_key(tck, seed=4)),
                      ("csk", B.gen_compressed_server_key(tck, seed=5))):
        Ser.save(obj, tmp_path / f"{name}.npz")
        jobj = JSer.safe_load(tmp_path / f"{name}.npz")
        arrays = [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]
        assert arrays and all(a.dtype == np.uint32 for a in arrays), name
        again = Ser.load(tmp_path / f"{name}.npz", device="cpu")
        if name == "pk":
            np.testing.assert_array_equal(np.asarray(jobj.pk.data), words_of(obj.pk.data))
            assert torch.equal(again.pk.data, obj.pk.data) and again.pk.log_q == 32
        elif name == "cpk":
            assert jobj.seeded.log_q == 32
            assert torch.equal(again.seeded.bodies, obj.seeded.bodies)
        else:
            assert (jobj.seeded_bsk.log_q, jobj.seeded_ksk.log_q) == (32, 32)
            assert torch.equal(again.decompress().bsk.spectra, obj.decompress().bsk.spectra)


def words_of(x):
    return to_numpy_torus(x, 32)
