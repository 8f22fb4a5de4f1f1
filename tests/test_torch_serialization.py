"""The port's tfhe_tpu-v1 reader and writer (`tfhe_tpu_torch.utils.serialization`)
against the JAX package's (`tfhe_tpu.utils.serialization`), at
TEST_PARAMS_SHORTINT and TEST_PARAMS_BOOLEAN on numpy secret keys:

* JAX `save` → port `safe_load`: the nine seeded entities, shortint and
  boolean compressed server keys (KS+PBS, or an AND, on the port's
  decompression bit-identical to the port's call on the JAX package's
  decompression carried across through interop, and decrypted right),
  compressed ciphertexts, a full shortint server key through its DIF
  residues;
* port `save` → JAX `safe_load`: the nine seeded entities, decompressed by
  the JAX package bit-identically to the port; compressed ciphertexts and
  server keys, public keys and ciphertexts, decrypted right on the JAX side;
* the WoP-PBS keys: a JAX `CombinedWopbsKey` (its `WopbsKey`, server keys,
  `CbsPfpkskList` and casting KSK) read by the port and serving a WoP-PBS;
  the port's `CbsPfpkskList` read by the JAX package;
* the gadget fork's `Ciphertext` (with its encoding), `ClientKey` and
  `ServerKey` both ways (numpy keys at TEST_PARAMS_GADGET,
  `torch_gadget_jax`): read into the port's types equal to the port's keys
  on the same arrays, and written back equal to the JAX package's (the
  BSK's residues and Shoup quotients word for word);
* every refusal: unported types by ROADMAP item, a version, a type, a size
  limit, a key on another prime pool (C2), a key with no DIF residues, and
  a card asked for without one.

Every JAX call is jitted (never JAX keygen: minutes of eager compiles)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.boolean as JB
import tfhe_tpu.core.algorithms.seeded as JS
import tfhe_tpu.shortint.client_key as JSC
import tfhe_tpu.shortint.server_key as JSS
import tfhe_tpu.utils.serialization as JSer
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms import decrypt_lwe as jax_decrypt_lwe
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN as JPB
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch import integer, interop, shortint
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.algorithms import seeded as TS
from tfhe_tpu_torch.core.entities import GlweSecretKey, LweCiphertext, LweSecretKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_torus, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN as PB
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.utils import serialization as Ser
from torch_keys import decrypt_big, encrypt_big, real_keys
from torch_seeded_jax import (KINDS, jax_decompressed, jax_made, port_decompressed, port_made,
                              secret_bits)

SEED = 0xFFFFFFFF
F = lambda x: (3 * x + 1) % 4


def _bool_bits():
    rng = np.random.default_rng(21)
    return (rng.integers(0, 2, PB.lwe_dimension).astype(np.int8),
            rng.integers(0, 2, (PB.glwe_dimension, PB.polynomial_size)).astype(np.int8))


def _keys(lwe, glwe, jparams, tparams, jcls, tcls, order):
    """(JAX client key, port client key on the CPU) over the same bits."""
    jk = {"lwe_sk": JLweSk(bits=jnp.asarray(lwe)), "glwe_sk": JGlweSk(bits=jnp.asarray(glwe))}
    tk = {"lwe_sk": LweSecretKey(bits=torch.as_tensor(lwe.astype(np.int64))),
          "glwe_sk": GlweSecretKey(bits=torch.as_tensor(glwe.astype(np.int64)))}
    return (jcls(**{k: jk[k] for k in order}, params=jparams),
            tcls(**{k: tk[k] for k in order}, params=tparams))


@pytest.fixture(scope="module")
def shortint_keys():
    lwe, glwe = secret_bits()
    return _keys(lwe, glwe, JP, P, JSC.ClientKey, shortint.ClientKey, ("glwe_sk", "lwe_sk"))


@pytest.fixture(scope="module")
def boolean_keys():
    lwe, glwe = _bool_bits()
    return _keys(lwe, glwe, JPB, PB, JB.ClientKey, B.ClientKey, ("lwe_sk", "glwe_sk"))


def _carried(seeded_bsk, seeded_ksk, params):
    """The JAX package's decompression of a compressed server key (standard
    BSK and KSK, jitted), carried across through interop."""
    bsk = np.asarray(jax.jit(lambda s: JS.decompress_bootstrap_key(s).data)(seeded_bsk))
    ksk = np.asarray(jax.jit(lambda s: JS.decompress_keyswitch_key(s).data)(seeded_ksk))
    npr = external_product_num_primes(params.polynomial_size, params.glwe_size,
                                      params.pbs_decomp)
    return (interop.bootstrap_key_from_standard(bsk, params.pbs_decomp, npr, device="cpu"),
            interop.keyswitch_key(ksk, params.ks_decomp, device="cpu"), bsk, ksk)


# ---------------------------------------------------------------------------
# JAX save → port safe_load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_jax_seeded_entity_read_by_the_port(kind, tmp_path):
    _, sjax = jax_made(kind, SEED)
    JSer.save(sjax, tmp_path / "s.npz")
    s = Ser.safe_load(tmp_path / "s.npz", expected_type=type(sjax).__name__, device="cpu")
    assert type(s) is getattr(TS, type(sjax).__name__) and s.seed == SEED
    np.testing.assert_array_equal(to_numpy_u64(port_decompressed(s)),
                                  jax_decompressed(kind, SEED))


def test_jax_compressed_server_key_serves_in_the_port(shortint_keys, tmp_path):
    jck, tck = shortint_keys
    jcsk = jax.jit(lambda: JSS.gen_compressed_server_key(jck, 5))()
    JSer.save(jcsk, tmp_path / "csk.npz")
    csk = Ser.safe_load(tmp_path / "csk.npz", expected_type="CompressedServerKey", device="cpu")
    assert isinstance(csk, shortint.CompressedServerKey)
    assert (csk.seeded_bsk.seed, csk.seeded_ksk.seed) == (11, 12)
    sk = csk.decompress()
    bsk, ksk, _, ksk_data = _carried(jcsk.seeded_bsk, jcsk.seeded_ksk, P)
    carried = shortint.ServerKey(ksk=ksk, bsk=bsk, params=P)
    assert torch.equal(sk.ksk.data, carried.ksk.data)
    assert torch.equal(sk.bsk.spectra, carried.bsk.spectra)
    msgs = torch.arange(16) % 4
    ct = tck.encrypt(msgs, seed=3)
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(F))
    ref = carried.apply_lookup_table(ct, carried.generate_lookup_table(F))
    assert torch.equal(out.lwe.data, ref.lwe.data)
    assert torch.equal(tck.decrypt(out), F(msgs))
    # a JAX compressed ciphertext, decompressed in the port, through the same key
    jcct = jax.jit(lambda: jck.encrypt_compressed(jnp.asarray(np.arange(8) % 4), seed=9))()
    JSer.save(jcct, tmp_path / "cct.npz")
    cct = Ser.safe_load(tmp_path / "cct.npz", device="cpu")
    assert isinstance(cct, shortint.CompressedCiphertext)
    assert torch.equal(tck.decrypt_compressed(cct), torch.arange(8) % 4)
    out = sk.apply_lookup_table(cct.decompress(), sk.generate_lookup_table(F))
    assert torch.equal(tck.decrypt(out), F(torch.arange(8) % 4))


def test_jax_boolean_compressed_server_key_serves_in_the_port(boolean_keys, tmp_path):
    jck, tck = boolean_keys
    jcsk = jax.jit(lambda: JB.gen_compressed_server_key(jck, 2))()
    JSer.save(jcsk, tmp_path / "bcsk.npz")
    csk = Ser.safe_load(tmp_path / "bcsk.npz", expected_type="tfhe_tpu.boolean.CompressedServerKey",
                        device="cpu")
    assert isinstance(csk, B.CompressedServerKey)
    sk = csk.decompress()
    bsk, ksk, _, _ = _carried(jcsk.seeded_bsk, jcsk.seeded_ksk, PB)
    carried = B.ServerKey(bsk=bsk, ksk=ksk, params=PB)
    a = B.encrypt(tck, [False, False, True, True], seed=1)
    b = B.encrypt(tck, [False, True, False, True], seed=2)
    out, ref = B.and_(sk, a, b), B.and_(carried, a, b)
    assert torch.equal(out.lwe.data, ref.lwe.data)
    assert B.decrypt(tck, out).tolist() == [False, False, False, True]


def test_jax_full_server_key_read_through_its_dif_residues(tmp_path):
    keys = real_keys(P, seed=8)
    npr = external_product_num_primes(P.polynomial_size, P.glwe_size, P.pbs_decomp)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, npr))(
        jnp.asarray(keys["bsk"]))
    jsk = JSS.ServerKey(ksk=JKsk(data=jnp.asarray(keys["ksk"]), decomp=JP.ks_decomp), bsk=jbsk,
                        params=JP)
    JSer.save(jsk, tmp_path / "sk.npz", compress=False)
    meta = json.loads(bytes(np.load(tmp_path / "sk.npz")["__meta__"]).decode())
    assert meta["tree"]["fields"]["bsk"]["fields"]["mono"] == {"t": "derived"}
    sk = Ser.safe_load(tmp_path / "sk.npz", expected_type="ServerKey", device="cpu")
    direct = interop.bootstrap_key_from_standard(keys["bsk"], P.pbs_decomp, npr, device="cpu")
    assert torch.equal(sk.bsk.spectra, direct.spectra) and sk.bsk.primes == direct.primes
    msgs = np.arange(8) % 4
    ct = shortint.Ciphertext(lwe=LweCiphertext(
        data=from_numpy_u64(encrypt_big(P, keys["big_bits"], msgs, seed=2))))
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(F))
    assert decrypt_big(P, keys["big_bits"], to_numpy_u64(out.lwe.data)).tolist() == \
        F(msgs).tolist()


def test_wopbs_keys_cross_both_ways(tmp_path):
    """JAX save → port safe_load of a CombinedWopbsKey on numpy keys (the
    compute set TEST_PARAMS_SHORTINT, the WoP-PBS set TEST_PARAMS_WOPBS):
    every key word equal to the arrays it was made of, and the port's copy
    serves a WoP-PBS that decrypts right; the port's PFPKSK list read back
    by the JAX package word for word."""
    import tfhe_tpu.core.algorithms.wopbs as JW
    import tfhe_tpu.shortint.wopbs as JSW
    from tfhe_tpu.core.params import TEST_PARAMS_WOPBS as JPW
    from tfhe_tpu_torch.core.algorithms import wopbs as TW
    from tfhe_tpu_torch.core.params import TEST_PARAMS_WOPBS as PW
    from tfhe_tpu_torch.shortint import wopbs as SW
    from torch_jax_pbs import jax_server, port_keys
    from torch_keys import _ksk
    k, kw = real_keys(P, seed=40), real_keys(PW, seed=41)
    rng = np.random.default_rng(42)
    ksk_in, ksk_out = _ksk(rng, P, k["big_bits"], kw["big_bits"]), \
        _ksk(rng, P, kw["big_bits"], k["lwe_bits"])
    tck, tsk = port_keys(k, P)
    wck, wsk = port_keys(kw, PW)
    pf = SW.new_wopbs_key_only_for_wopbs(wck, wsk, cbs_decomp=PW.cbs_decomp,
                                         pfks_decomp=PW.pfks_decomp, seed=43).pfpksk
    jpf = JW.CbsPfpkskList(data=jnp.asarray(to_numpy_u64(pf.data)), decomp=JPW.pfks_decomp)
    jsk = jax_server(k, JP)
    jcomb = JSW.CombinedWopbsKey(
        wopbs_key=JSW.WopbsKey(server_key=jax_server(kw, JPW), pfpksk=jpf,
                               cbs_decomp=JPW.cbs_decomp),
        pbs_server_key=JSS.ServerKey(ksk=JKsk(data=jnp.asarray(ksk_out), decomp=JP.ks_decomp),
                                     bsk=jsk.bsk, params=JP),
        ksk_pbs_to_wopbs=JKsk(data=jnp.asarray(ksk_in), decomp=JP.ks_decomp))
    JSer.save(jcomb, tmp_path / "w.npz", compress=False)
    comb = Ser.safe_load(tmp_path / "w.npz", expected_type="CombinedWopbsKey", device="cpu")
    assert isinstance(comb, SW.CombinedWopbsKey) and isinstance(comb.wopbs_key, SW.WopbsKey)
    assert isinstance(comb.wopbs_key.pfpksk, TW.CbsPfpkskList)
    assert torch.equal(comb.wopbs_key.pfpksk.data, pf.data)
    assert comb.wopbs_key.cbs_decomp == PW.cbs_decomp and comb.params == PW
    assert torch.equal(comb.wopbs_key.server_key.bsk.spectra, wsk.bsk.spectra)
    assert torch.equal(comb.wopbs_key.server_key.ksk.data, wsk.ksk.data)
    assert torch.equal(comb.pbs_server_key.bsk.spectra, tsk.bsk.spectra)
    np.testing.assert_array_equal(to_numpy_u64(comb.pbs_server_key.ksk.data), ksk_out)
    np.testing.assert_array_equal(to_numpy_u64(comb.ksk_pbs_to_wopbs.data), ksk_in)
    g = lambda x: (3 * x + 1) % 4
    ct = tck.encrypt(torch.arange(4), seed=44)
    out = comb.wopbs(tsk, ct, comb.generate_lut(g))
    assert tck.decrypt(out).tolist() == [g(v) for v in range(4)]
    Ser.save(pf, tmp_path / "pf.npz")
    back = JSer.safe_load(tmp_path / "pf.npz", expected_type="CbsPfpkskList")
    np.testing.assert_array_equal(np.asarray(back.data), to_numpy_u64(pf.data))
    assert (back.decomp.base_log, back.decomp.level) == (PW.pfks_base_log, PW.pfks_level)


def _jax_entities():
    """JAX entities of every plain registered type, on numpy words: (JAX
    object, the properties both packages' classes have)."""
    import tfhe_tpu.core.entities as JE
    import tfhe_tpu.integer.ciphertext as JI
    import tfhe_tpu.shortint.ciphertext as JSCt
    from tfhe_tpu.core.algorithms.public_key import LweCompactPublicKey as JCpk
    from tfhe_tpu.core.algorithms.public_key import LwePublicKey as JPk
    from tfhe_tpu.core.params import DecompParams as JD
    rng = np.random.default_rng(4)
    w = lambda *shape: jnp.asarray(rng.integers(0, 2 ** 64, shape, dtype=np.uint64))
    lwe = JLwe(data=w(3, 5))
    block = JSCt.Ciphertext(lwe=lwe, degree=3, noise_level=2)
    return [
        (lwe, ("mask", "body")), (JE.GlweCiphertext(data=w(2, 3, 8)), ("mask", "body")),
        (JE.GgswCiphertext(data=w(2, 3, 3, 8), decomp=JD(7, 2)),
         ("level_count", "glwe_size", "polynomial_size")),
        (JBsk(data=w(4, 1, 2, 2, 8), decomp=JD(23, 1)), ()),
        (JKsk(data=w(8, 3, 5), decomp=JD(3, 3)), ()),
        (JE.LwePackingKeyswitchKey(data=w(4, 2, 3, 8), decomp=JD(15, 2)),
         ("input_lwe_dimension", "glwe_size", "polynomial_size")),
        (JE.GlweRelinearizationKey(data=w(3, 2, 3, 8), decomp=JD(15, 2)),
         ("glwe_size", "polynomial_size")),
        (JLweSk(bits=jnp.asarray(rng.integers(0, 2, 6).astype(np.int8))), ("lwe_dimension",)),
        (JGlweSk(bits=jnp.asarray(rng.integers(0, 2, (2, 8)).astype(np.int8))),
         ("glwe_dimension", "polynomial_size")),
        (JPk(data=w(6, 4), log_q=64), ("zero_encryption_count", "lwe_dimension")),
        (JCpk(data=w(2, 8), log_q=64), ("lwe_dimension",)),
        (block, ("batch_shape", "carry_is_empty")),
        (JSS.LookupTable(acc=JE.GlweCiphertext(data=w(2, 8)), degree=3), ()),
        (JB.BoolCiphertext(lwe=lwe), ("batch_shape",)),
        (JI.SignedRadixCiphertext(blocks=[block, block]), ()),
    ]


def _same(j, t):
    """The JAX object and the port's hold the same words and fields."""
    if isinstance(j, jax.Array):
        a = np.asarray(j)
        b = t.numpy()
        return np.array_equal(a.view(np.int64) if a.dtype == np.uint64 else a, b)
    if isinstance(j, (list, tuple)):
        return len(j) == len(t) and all(_same(x, y) for x, y in zip(j, t))
    if hasattr(j, "__dataclass_fields__"):
        return all(_same(getattr(j, f), getattr(t, f)) for f in j.__dataclass_fields__
                   if hasattr(t, f))
    return j == t


def test_jax_entities_read_by_the_port(tmp_path):
    for i, (obj, props) in enumerate(_jax_entities()):
        JSer.save(obj, tmp_path / f"{i}.npz")
        got = Ser.safe_load(tmp_path / f"{i}.npz", expected_type=type(obj).__name__,
                            device="cpu")
        assert type(got).__name__ == type(obj).__name__ and _same(obj, got), type(obj)
        for prop in props:
            assert _same(getattr(obj, prop), getattr(got, prop)), (type(obj), prop)


def test_gsw_and_plaintext_entities():
    import tfhe_tpu.core.entities as JE
    from tfhe_tpu_torch.core import entities as TE
    data = np.arange(2 * 5 * 5, dtype=np.uint64).reshape(2, 5, 5)
    j = JE.GswCiphertext(data=jnp.asarray(data), decomp=JP.pbs_decomp)
    t = TE.GswCiphertext(data=from_numpy_u64(data), decomp=P.pbs_decomp)
    assert (t.level_count, t.lwe_size) == (j.level_count, j.lwe_size) == (2, 5)
    assert torch.equal(TE.Plaintext(data=from_numpy_u64(data[0, 0])).data,
                       from_numpy_u64(np.asarray(JE.Plaintext(data=jnp.asarray(data[0, 0])).data)))


# ---------------------------------------------------------------------------
# port save → JAX safe_load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_port_seeded_entity_read_by_jax(kind, tmp_path):
    _, s = port_made(kind, SEED)
    Ser.save(s, tmp_path / "s.npz")
    sjax = JSer.safe_load(tmp_path / "s.npz", expected_type=type(s).__name__)
    assert type(sjax) is getattr(JS, type(s).__name__)
    fn = {"lwe": JS.decompress_lwe, "glwe": JS.decompress_glwe,
          "bsk": JS.decompress_bootstrap_key, "ksk": JS.decompress_keyswitch_key,
          "ggsw_list": lambda x: jnp.stack([g.data for g in JS.decompress_ggsw_list(x)]),
          "multi_bit_bsk": JS.decompress_multi_bit_bootstrap_key,
          "packing_ksk": JS.decompress_packing_keyswitch_key,
          "public_key": JS.decompress_lwe_public_key,
          "compact_public_key": JS.decompress_compact_public_key}[kind]
    out = jax.jit(fn)(sjax)
    np.testing.assert_array_equal(np.asarray(getattr(out, "data", out)),
                                  to_numpy_u64(port_decompressed(s)))


def test_port_compressed_shortint_read_by_jax(shortint_keys, tmp_path):
    jck, tck = shortint_keys
    csk = shortint.gen_compressed_server_key(tck, seed=6)
    Ser.save(csk, tmp_path / "csk.npz")
    jcsk = JSer.safe_load(tmp_path / "csk.npz", expected_type="CompressedServerKey")
    assert isinstance(jcsk, JSS.CompressedServerKey) and jcsk.params == JP
    _, _, bsk, ksk = _carried(jcsk.seeded_bsk, jcsk.seeded_ksk, P)
    np.testing.assert_array_equal(bsk, to_numpy_u64(TS.decompress_bootstrap_key(
        csk.seeded_bsk).data))
    # the JAX package decrypts the keyswitching key's rows: row (i, l) under
    # the small key is big_bits[i] * q/B^(l+1) + noise
    phase = jax.jit(lambda d: jax_decrypt_lwe(JLwe(data=d), jck.lwe_sk, 64))(jnp.asarray(ksk))
    g = np.array([1 << (64 - 3 * (l + 1)) for l in range(5)], dtype=np.uint64)
    want = secret_bits()[1].reshape(-1).astype(np.uint64)[:, None] * g
    err = (np.asarray(phase) - want).view(np.int64).astype(np.float64)
    assert np.abs(err).max() < 8 * P.lwe_noise_std
    cct = tck.encrypt_compressed(torch.arange(16) % 4, seed=13)
    Ser.save(cct, tmp_path / "cct.npz")
    jcct = JSer.safe_load(tmp_path / "cct.npz", expected_type="CompressedCiphertext")
    got = jax.jit(lambda c: jck.decrypt_compressed(c))(jcct)
    np.testing.assert_array_equal(np.asarray(got), np.arange(16) % 4)


def test_port_boolean_keys_read_by_jax(boolean_keys, tmp_path):
    jck, tck = boolean_keys
    m = np.array([True, False, False, True, True])
    for name, pk in (("pk", B.gen_public_key(tck, seed=3)),
                     ("cpk", B.gen_compressed_public_key(tck, seed=4))):
        Ser.save(pk, tmp_path / f"{name}.npz")
        jpk = JSer.safe_load(tmp_path / f"{name}.npz")
        if name == "cpk":
            assert isinstance(jpk, JB.CompressedPublicKey)
            jpk, pk = jpk.decompress(), pk.decompress()
        assert isinstance(jpk, JB.PublicKey)
        jct = jax.jit(lambda k: JB.encrypt_with_public_key(k, jnp.asarray(m), seed=7).lwe.data)(jpk)
        ct = B.encrypt_with_public_key(pk, m, seed=7)
        np.testing.assert_array_equal(np.asarray(jct), to_numpy_u64(ct.lwe.data))
        assert B.decrypt(tck, ct).tolist() == m.tolist()
    csk = B.gen_compressed_server_key(tck, seed=1)
    Ser.save(csk, tmp_path / "bcsk.npz")
    jcsk = JSer.safe_load(tmp_path / "bcsk.npz", expected_type="CompressedServerKey")
    assert isinstance(jcsk, JB.CompressedServerKey) and jcsk.params == JPB
    _, _, bsk, _ = _carried(jcsk.seeded_bsk, jcsk.seeded_ksk, PB)
    np.testing.assert_array_equal(bsk, to_numpy_u64(TS.decompress_bootstrap_key(
        csk.seeded_bsk).data))


def test_port_ciphertexts_read_by_jax(shortint_keys, boolean_keys, tmp_path):
    jck, tck = shortint_keys
    ct = tck.encrypt(torch.arange(6) % 4, seed=2)
    radix = integer.RadixCiphertext(blocks=[ct, tck.encrypt(torch.arange(6) % 3, seed=4)])
    crt = integer.CrtCiphertext(blocks=radix.blocks, moduli=(2, 3))
    for name, obj, blocks in (("ct", ct, [ct]), ("radix", radix, radix.blocks),
                              ("crt", crt, crt.blocks)):
        Ser.save(obj, tmp_path / f"{name}.npz")
        back = JSer.safe_load(tmp_path / f"{name}.npz", expected_type=type(obj).__name__)
        for jb, tb in zip([back] if name == "ct" else back.blocks, blocks):
            assert (jb.degree, jb.message_modulus, jb.noise_level) == (
                tb.degree, tb.message_modulus, tb.noise_level)
            np.testing.assert_array_equal(np.asarray(jck.decrypt(jb)),
                                          tck.decrypt(tb).numpy())
    assert back.moduli == (2, 3)
    bjck, btck = boolean_keys
    bct = B.encrypt(btck, [True, False, True], seed=5)
    Ser.save(bct, tmp_path / "b.npz")
    jb = JSer.safe_load(tmp_path / "b.npz", expected_type="BoolCiphertext")
    assert np.asarray(JB.decrypt(bjck, jb)).tolist() == [True, False, True]
    # and back: the port reads what it wrote
    assert torch.equal(Ser.load(tmp_path / "b.npz", device="cpu").lwe.data, bct.lwe.data)


def test_port_compact_public_key_read_by_jax(shortint_keys, tmp_path):
    from tfhe_tpu.core.algorithms.public_key import encrypt_lwe_compact_batch
    _, s = port_made("compact_public_key", SEED)
    pk = TS.decompress_compact_public_key(s)
    Ser.save(pk, tmp_path / "cpk.npz")
    jpk = JSer.safe_load(tmp_path / "cpk.npz", expected_type="LweCompactPublicKey")
    pts = jnp.asarray(np.arange(10, dtype=np.uint64) % 16 << np.uint64(59))
    data = jax.jit(lambda k: encrypt_lwe_compact_batch(
        jax.random.key(4), k, pts, P.lwe_noise_std).data)(jpk)
    phase = np.asarray(jax_decrypt_lwe(JLwe(data=data), shortint_keys[0].lwe_sk, 64))
    got = ((phase + np.uint64(1 << 58)) >> np.uint64(59)) % np.uint64(16)
    np.testing.assert_array_equal(got, np.arange(10) % 16)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _write(path, cls, fields=None, version=JSer.SERIALIZATION_VERSION):
    tree = {"t": "obj", "cls": cls, "fields": fields or {}}
    meta = json.dumps({"version": version, "type": cls, "tree": tree})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8))


@pytest.fixture(scope="module")
def gadget_objects():
    """JAX and port gadget keys and a ciphertext on the same numpy arrays."""
    from torch_gadget_jax import both, encodings, encrypt, jax_keys, numpy_gadget_keys, port_keys
    keys = numpy_gadget_keys(23)
    jenc, _ = encodings(5, [[0], [1], [2], [3], [4]], 11)
    (jck, jsk), (tck, tsk) = jax_keys(keys, "ks_pbs"), port_keys(keys, "ks_pbs")
    jct, tct = both(encrypt(keys, "ks_pbs", [0, 1, 2, 3, 4], jenc, seed=3), jenc)
    return {"Ciphertext": (jct, tct), "ClientKey": (jck, tck), "ServerKey": (jsk, tsk)}


def _same_gadget(kind, jobj, tobj):
    """A JAX gadget object and a port one hold the same words."""
    def u64(t):
        return to_numpy_u64(t)
    if kind == "Ciphertext":
        np.testing.assert_array_equal(np.asarray(jobj.lwe.data), u64(tobj.lwe.data))
        assert (jobj.encoding.origin_modulus, jobj.encoding.modulus_p, jobj.encoding.parts,
                jobj.encoding.wopbs) == (tobj.encoding.origin_modulus, tobj.encoding.modulus_p,
                                         tobj.encoding.parts, tobj.encoding.wopbs)
        return
    assert jobj.params.name == tobj.params.name
    if kind == "ClientKey":
        for f in ("lwe_sk", "glwe_sk"):
            np.testing.assert_array_equal(np.asarray(getattr(jobj, f).bits),
                                          getattr(tobj, f).bits.numpy())
        return
    for f in ("ksk", "pksk", "rlk"):
        np.testing.assert_array_equal(np.asarray(getattr(jobj, f).data),
                                      u64(getattr(tobj, f).data))
        assert getattr(jobj, f).decomp.base_log == getattr(tobj, f).decomp.base_log


def _gadget_round_trip(kind, objs, tmp_path):
    """The JAX package's file read by the port, the port's read by the JAX
    package, each equal to the other package's object on the same arrays;
    the BSK written by the port equals the JAX key's residues and Shoup
    quotients."""
    jobj, tobj = objs[kind]
    JSer.safe_save(jobj, tmp_path / "j.npz")
    got = Ser.safe_load(tmp_path / "j.npz", expected_type=kind, device="cpu")
    assert type(got) is type(tobj)
    _same_gadget(kind, jobj, got)
    if kind == "ServerKey":
        assert torch.equal(got.bsk.spectra, tobj.bsk.spectra)
    Ser.save(tobj, tmp_path / "t.npz")
    back = JSer.safe_load(tmp_path / "t.npz", expected_type="gadget.engine." + kind)
    assert type(back) is type(jobj)
    _same_gadget(kind, back, tobj)
    if kind == "ClientKey":
        assert np.asarray(back.lwe_sk.bits).dtype == np.int8
    if kind == "ServerKey":
        np.testing.assert_array_equal(np.asarray(back.bsk.data), np.asarray(jobj.bsk.data))
        np.testing.assert_array_equal(np.asarray(back.bsk.shoup), np.asarray(jobj.bsk.shoup))
        assert back.bsk.paired is None and back.params == jobj.params
        again = Ser.safe_load(tmp_path / "t.npz", device="cpu")
        assert torch.equal(again.bsk.spectra, tobj.bsk.spectra)


@pytest.mark.parametrize("cls, item", [
    ("tfhe_tpu.gadget.engine.Ciphertext", "A14"), ("tfhe_tpu.gadget.engine.ClientKey", "A14"),
    ("tfhe_tpu.gadget.engine.ServerKey", "A14"),
    ("tfhe_tpu.integer.shift_key.ShiftKey", "A10b")])
def test_unported_types_refused_by_roadmap_item(cls, item, tmp_path, request):
    """A10b's and A14's types are ported: the three gadget types round-trip
    both ways; a ShiftKey node without its fields is refused as malformed
    (its round trip is tests/test_torch_shift_key.py)."""
    if item == "A14":
        _gadget_round_trip(cls.rsplit(".", 1)[1], request.getfixturevalue("gadget_objects"),
                           tmp_path)
        return
    _write(tmp_path / "x.npz", cls)
    with pytest.raises(Ser.DeserializationError, match="ShiftKey"):
        Ser.safe_load(tmp_path / "x.npz", device="cpu")


def test_gadget_encoding_and_shift_key_refused(tmp_path):
    """A gadget ciphertext (an "encoding" node) reads as the port's; an
    integer server key whose shift key node lacks its fields, and an
    unknown type, are refused."""
    from tfhe_tpu.gadget.encoding import Encoding
    from tfhe_tpu.gadget.engine import Ciphertext as GadgetCiphertext
    enc = Encoding(2, [[0], [1]], 3)
    words = jnp.asarray(np.array([[1, 2, 2 ** 63], [3, 2 ** 64 - 1, 0]], dtype=np.uint64))
    JSer.save(GadgetCiphertext(lwe=JLwe(data=words), encoding=enc), tmp_path / "g.npz")
    got = Ser.load(tmp_path / "g.npz", device="cpu")
    np.testing.assert_array_equal(to_numpy_u64(got.lwe.data), np.asarray(words))
    assert (got.encoding.origin_modulus, got.encoding.modulus_p, got.encoding.parts) == (
        2, 3, enc.parts)
    Ser.save(got, tmp_path / "g2.npz")
    back = JSer.load(tmp_path / "g2.npz")
    assert back.encoding == enc
    np.testing.assert_array_equal(np.asarray(back.lwe.data), np.asarray(words))
    node = {"t": "lit", "v": None}
    _write(tmp_path / "i.npz", "tfhe_tpu.integer.server_key.ServerKey",
           {"key": node, "shift_key": {"t": "obj", "cls": "tfhe_tpu.integer.shift_key.ShiftKey",
                                       "fields": {}}})
    with pytest.raises(Ser.DeserializationError, match="ShiftKey"):
        Ser.load(tmp_path / "i.npz", device="cpu")
    _write(tmp_path / "u.npz", "tfhe_tpu.core.entities.SomethingNew")
    with pytest.raises(Ser.DeserializationError, match="unknown type"):
        Ser.load(tmp_path / "u.npz", device="cpu")


def test_version_type_and_size_refused(tmp_path):
    _, s = port_made("lwe", SEED)
    Ser.save(s, tmp_path / "s.npz")
    path = tmp_path / "s.npz"
    assert Ser.safe_load(str(path), expected_type="SeededLweCiphertext",
                         size_limit=path.stat().st_size, device="cpu").seed == SEED
    with pytest.raises(Ser.DeserializationError, match="type mismatch"):
        Ser.safe_load(path, expected_type="LweKeyswitchKey", device="cpu")
    with pytest.raises(Ser.DeserializationError, match="exceeds limit"):
        Ser.safe_load(path, size_limit=path.stat().st_size - 1, device="cpu")
    with pytest.raises(Ser.DeserializationError, match="exceeds limit"):
        Ser.safe_load(str(path), size_limit=100, device="cpu")
    _write(tmp_path / "v.npz", "tfhe_tpu.core.params.DecompParams",
           {"base_log": {"t": "lit", "v": 3}, "level": {"t": "lit", "v": 5}},
           version="tfhe_tpu-v0")
    with pytest.raises(Ser.DeserializationError, match="version mismatch"):
        Ser.safe_load(tmp_path / "v.npz", device="cpu")
    # the shortint ClientKey, once refused here, round-trips (A17); a type no
    # JAX registry entry reads (the boolean CompressedCiphertext) is refused
    ck = shortint.ClientKey(glwe_sk=GlweSecretKey(bits=torch.ones(1, 8, dtype=torch.int64)),
                            lwe_sk=LweSecretKey(bits=torch.zeros(4, dtype=torch.int64)),
                            params=P)
    Ser.safe_save(ck, tmp_path / "w.npz")
    back = JSer.safe_load(tmp_path / "w.npz", expected_type="ClientKey")
    assert back.params == JP and np.asarray(back.glwe_sk.bits).tolist() == [[1] * 8]
    again = Ser.safe_load(tmp_path / "w.npz", expected_type="ClientKey", device="cpu")
    assert torch.equal(again.lwe_sk.bits, ck.lwe_sk.bits) and again.params == P
    with pytest.raises(Ser.DeserializationError, match="does not write"):
        Ser.save(B.CompressedCiphertext(seeded=s), tmp_path / "c.npz")
    # a 32-bit seeded entity, once refused (A9c), decompresses to the JAX
    # package's words, lifted
    js = JS.SeededLweCiphertext(body=jnp.arange(3, dtype=jnp.uint32) << 30, seed=1,
                                lwe_dimension=4, log_q=32)
    JSer.save(js, tmp_path / "q.npz")
    lifted = TS.decompress_lwe(Ser.load(tmp_path / "q.npz", device="cpu"))
    want = np.asarray(jax.jit(lambda x: JS.decompress_lwe(x).data)(js))
    np.testing.assert_array_equal(to_numpy_torus(lifted.data, 32), want)


def test_key_on_another_prime_pool_refused(tmp_path, monkeypatch):
    """ROADMAP C2: a JAX NttLweBootstrapKey whose residues are over the
    high-N pool at an N whose pool is PRIMES_31 (the file does not say which
    pool) is refused, where the key on the right pool reads; so is the slim
    key, which keeps only fourstep-order spectra."""
    import tfhe_tpu.core.poly.ntt as jntt
    from tfhe_tpu.core.entities import NttLweBootstrapKey as JNtt
    keys = real_keys(P, seed=8)
    npr = external_product_num_primes(P.polynomial_size, P.glwe_size, P.pbs_decomp)
    right = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, npr))(
        jnp.asarray(keys["bsk"]))
    JSer.save(right, tmp_path / "right.npz", compress=False)
    assert Ser.load(tmp_path / "right.npz", device="cpu").primes == jntt.primes_for(256)[:npr]
    JSer.save(right.slim(), tmp_path / "slim.npz", compress=False)
    with pytest.raises(Ser.DeserializationError, match="fourstep"):
        Ser.load(tmp_path / "slim.npz", device="cpu")
    with monkeypatch.context() as m:
        m.setattr(jntt, "primes_for", lambda n: jntt.PRIMES_HIGH_N)
        plan = jntt.NttPlan(P.polynomial_size, npr)              # not the cached plan
    assert plan.primes != jntt.get_plan(P.polynomial_size, npr).primes
    hat = jax.jit(lambda d: jntt.ntt_forward(plan, d))(jnp.asarray(keys["bsk"]))
    n, L, R = P.lwe_dimension, P.pbs_level, P.glwe_size
    hat = jnp.moveaxis(hat, -2, 1).reshape(n, npr, L * R, R, P.polynomial_size)
    JSer.save(JNtt(data=hat, decomp=JP.pbs_decomp, log_q=64), tmp_path / "wrong.npz",
              compress=False)
    with pytest.raises(Ser.DeserializationError, match="C2"):
        Ser.load(tmp_path / "wrong.npz", device="cpu")


def test_reader_on_a_card_by_name_raises_without_one(tmp_path, monkeypatch):
    _, s = port_made("lwe", SEED)
    Ser.save(s, tmp_path / "s.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ser.safe_load(tmp_path / "s.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ser.load(tmp_path / "s.npz", device="cuda")
