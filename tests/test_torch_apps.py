"""The port's apps and examples.  Bit for bit against tfhe_tpu on the same
numpy keys and ciphertexts (tolerance 0): two clocks of the boolean
`TriviumStream` and one of `KreyviumStream` (2 streams on the batch axis),
one `step_64` round of `TriviumStreamShortint` (msg 2, carry 4, the
TEST_PARAMS_TRIVIUM set), and SHA-256's batched `add_words_b`, sigma0 and
`maj_b` at TEST_PARAMS_BOOLEAN.  Decrypted against clear models: the
keystreams, the boolean transciphering round trip, the transciphering of
the shortint stream (against JAX too) and of the byte stream into an
FheUint64 (its assembly against JAX on fixed keystream bytes),
the dark market and the regex engine on 4-block integers at
TEST_PARAMS_SHORTINT.  The clear models on the official eSTREAM vectors,
the SHA-256 padding on the reference vector.

The JAX boolean side is tests/torch_boolean_jax.py's (interpret mode, its
primitives jitted once on 32 rows); the JAX shortint side jits
`apply_lookup_table` once on 192 rows."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.apps.trivium as JT
import tfhe_tpu.examples.sha256_bool as JSHA
from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP_SHORTINT
from tfhe_tpu.core.params import TEST_PARAMS_TRIVIUM as JPT
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.ciphertext import NoiseLevel as JNoiseLevel
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch import integer, interop, shortint
from tfhe_tpu_torch.apps import (KreyviumStream, KreyviumStreamByte, KreyviumStreamShortint,
                                 TriviumStream, TriviumStreamByte, TriviumStreamShortint,
                                 clear_kreyvium_keystream, clear_trivium_keystream,
                                 trans_decrypt_u64_bits, trans_encrypt_u64)
from tfhe_tpu_torch.apps.trivium import _lsb_bits_of_bytes
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT, DecompParams
from tfhe_tpu_torch.core.params import TEST_PARAMS_TRIVIUM as PT
from tfhe_tpu_torch.examples import dark_market, regex_engine, sha256_bool
from torch_boolean_jax import (JP, P, both, decrypt_bool, encrypt_bool, interpret_boolean,
                               numpy_keys, servers)
from torch_keys import decrypt_big, encrypt_big, real_keys

ORDER = "pbs_ks"          # TEST_PARAMS_BOOLEAN itself
STREAMS = 2
SHORT_ROWS = 192          # step_64's widest call: three registers' 64 steps


def _hex_stream(bits):
    """eSTREAM presentation: bytes assembled LSB first, printed %02X."""
    return "".join("%02X" % sum(bits[i + j] << j for j in range(8))
                   for i in range(0, len(bits), 8))


def _bits_from_hex(h, n):
    return _lsb_bits_of_bytes(bytes.fromhex(h))[:n]


# ---------------------------------------------------------------------------
# clear models
# ---------------------------------------------------------------------------


def test_trivium_official_vectors():
    """The official Trivium vectors (reference apps/trivium/src/trivium/
    test.rs), full 1152-clock warm-up, as tests/test_trivium.py holds JAX's."""
    assert _hex_stream(clear_trivium_keystream([0] * 80, [0] * 80, 512)).startswith(
        "FBE0BF265859051B517A2E4E239FC97F563203161907CF2DE7A8790FA1B2E9CD")
    key = [0] * 80
    key[7] = 1
    assert _hex_stream(clear_trivium_keystream(key, [0] * 80, 512)).startswith(
        "38EB86FF730D7A9CAF8DF13A4420540DBB7B651464C87501552041C249F29A64")
    key = _bits_from_hex("0053A6F94C9FF24598EB", 80)
    iv = _bits_from_hex("0D74DB42A91077DE45AC", 80)
    assert _hex_stream(clear_trivium_keystream(key, iv, 512)).startswith(
        "F4CD954A717F26A7D6930830C4E7CF0819F80E03F25F342C64ADC66ABA7F8A8E")


def test_kreyvium_official_vectors():
    assert _hex_stream(clear_kreyvium_keystream([0] * 128, [0] * 128, 64)) == \
        "26DCF1F4BC0F1922"
    key = [0] * 128
    key[0] = 1
    assert _hex_stream(clear_kreyvium_keystream(key, [0] * 128, 64)) == "4FD421D4DA3D2C8A"
    iv = [0] * 128
    iv[0] = 1
    assert _hex_stream(clear_kreyvium_keystream([0] * 128, iv, 64)) == "C9217BA0D762ACA1"


def test_byte_streams_clear_models():
    """The byte representation in clear mode: Trivium against the official
    vectors, Kreyvium against the bit model."""
    st = TriviumStreamByte([0] * 10, [0] * 10)
    out = []
    for _ in range(8):
        out += st.next_64()
    assert "".join("%02X" % b for b in out).startswith("FBE0BF265859051B517A2E4E239FC97F")
    st = TriviumStreamByte(list(bytes.fromhex("0053A6F94C9FF24598EB")),
                           list(bytes.fromhex("0D74DB42A91077DE45AC")))
    assert "".join("%02X" % b for b in st.next_64()) == "F4CD954A717F26A7"
    kb = list(bytes.fromhex("0053A6F94C9FF24598EB0D74DB42A910"))
    ib = list(bytes.fromhex("0D74DB42A91077DE45AC0053A6F94C9F"))
    st = KreyviumStreamByte(kb, ib)
    ks = clear_kreyvium_keystream(_lsb_bits_of_bytes(kb), _lsb_bits_of_bytes(ib), 128)
    assert st.next_64() + st.next_64() == \
        [sum(ks[8 * i + j] << j for j in range(8)) for i in range(16)]


def test_sha256_padding_reference_vector():
    """The reference padding.rs vector, and hex input parsed as bytes."""
    s = "abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq"
    assert sha256_bool.bools_to_hex(sha256_bool.pad_sha256_input(s)) == (
        "6162636462636465636465666465666765666768666768696768696a68696a"
        "6b696a6b6c6a6b6c6d6b6c6d6e6c6d6e6f6d6e6f706e6f707180" + "0" * 139 + "1c0")
    assert sha256_bool.pad_sha256_input("0x6162") == sha256_bool.pad_sha256_data(b"ab")
    assert sha256_bool.pad_sha256_input("abc") == JSHA.pad_sha256_input("abc")
    assert len(sha256_bool.pad_sha256_data(b"abc")) == 512


# ---------------------------------------------------------------------------
# boolean streams and SHA-256 words against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bool_side():
    with interpret_boolean():
        keys = numpy_keys(81)
        yield keys, servers(keys, ORDER)


def _same(port_ct, jax_ct):
    np.testing.assert_array_equal(to_numpy_u64(port_ct.lwe.data), np.asarray(jax_ct.lwe.data))
    return to_numpy_u64(port_ct.lwe.data)


def _stream_keys(keys, bits_per_stream, seed):
    """Bit i of each stream's key, encrypted as one [STREAMS, n+1] batch."""
    return [both(encrypt_bool(keys, ORDER, [s[i] for s in bits_per_stream], seed=seed + i))
            for i in range(len(bits_per_stream[0]))]


@pytest.mark.parametrize("cipher", ["trivium", "kreyvium"])
def test_boolean_stream_matches_jax(bool_side, cipher):
    keys, (tsk, jsk) = bool_side
    width, warmup, n = (80, 0, 2) if cipher == "trivium" else (128, 0, 1)
    rng = np.random.default_rng(82 if cipher == "trivium" else 83)
    key_bits = rng.integers(0, 2, (STREAMS, width)).tolist()
    iv = rng.integers(0, 2, width).tolist()
    enc = _stream_keys(keys, key_bits, seed=1000)
    cls, jcls = ((TriviumStream, JT.TriviumStream) if cipher == "trivium"
                 else (KreyviumStream, JT.KreyviumStream))
    port = cls(tsk, [t for t, _ in enc], iv, warmup_rounds=warmup)
    ref = jcls(jsk, [j for _, j in enc], iv, warmup_rounds=warmup)
    clear = clear_trivium_keystream if cipher == "trivium" else clear_kreyvium_keystream
    want = [clear(k, iv, n, warmup_rounds=warmup) for k in key_bits]
    for i, (z, jz) in enumerate(zip(port.next_bits(n), ref.next_bits(n))):
        out = _same(z, jz)
        assert out.shape == (STREAMS, P.lwe_dimension + 1)
        np.testing.assert_array_equal(decrypt_bool(keys["lwe_bits"], out),
                                      [w[i] for w in want])
    for t, j in zip(port.state, ref.state):
        _same(t, j)


def _word_data(keys, value, seed):
    return encrypt_bool(keys, ORDER, [bool((value >> i) & 1) for i in range(32)], seed)


def _word(keys, data):
    return sum(int(b) << i for i, b in enumerate(decrypt_bool(keys["lwe_bits"], data)))


def test_sha256_words_match_jax(bool_side):
    """`add_words_b` (the Kogge–Stone adder: 18 dependent calls), sigma0 (a
    rotation, a rotation and a shift: 2 calls) and `maj_b` (xor + mux)."""
    keys, (tsk, jsk) = bool_side
    av, bv, cv = 0xDEADBEEF, 0x9ABCDEF0, 0x0F1E2D3C
    (ta, ja), (tb, jb), (tc, jc) = (both(_word_data(keys, v, s))
                                    for v, s in ((av, 11), (bv, 12), (cv, 13)))
    out = _same(sha256_bool.add_words_b(tsk, ta, tb, P), JSHA.add_words_b(jsk, ja, jb, JP))
    assert _word(keys, out) == (av + bv) & 0xFFFFFFFF
    out = _same(sha256_bool._sigma_b(tsk, ta, 7, 18, 3, P, True),
                JSHA._sigma_b(jsk, ja, 7, 18, 3, JP, True))
    rotr = lambda v, r: ((v >> r) | (v << (32 - r))) & 0xFFFFFFFF
    assert _word(keys, out) == rotr(av, 7) ^ rotr(av, 18) ^ (av >> 3)
    out = _same(sha256_bool.maj_b(tsk, ta, tb, tc), JSHA.maj_b(jsk, ja, jb, jc))
    assert _word(keys, out) == (av & bv) ^ (av & cv) ^ (bv & cv)


# ---------------------------------------------------------------------------
# the shortint stream against JAX
# ---------------------------------------------------------------------------


@jax.jit
def _jax_rows(sk, data, acc):
    return _JAX_APPLY(sk, JCt(lwe=JLwe(data=data)), JLut(acc=JGlwe(data=acc))).lwe.data


_JAX_APPLY = JServerKey.apply_lookup_table


def _jax_apply_padded(self, ct, lut):
    """JAX `apply_lookup_table` on rows padded to SHORT_ROWS, one compile."""
    data = ct.lwe.data
    rows = math.prod(data.shape[:-1])
    assert rows <= SHORT_ROWS
    flat = jnp.pad(data.reshape(rows, data.shape[-1]), ((0, SHORT_ROWS - rows), (0, 0)))
    out = _jax_rows(self, flat, lut.acc.data)[:rows]
    return ct.with_(lwe=JLwe(data=out.reshape(data.shape)), degree=lut.degree,
                    noise_level=JNoiseLevel.NOMINAL)


@pytest.fixture(scope="module")
def trivium_keys():
    k = real_keys(PT, seed=84)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JPT.pbs_decomp), 64, 4))(
        jnp.asarray(k["bsk"]))
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=JPT.ks_decomp), bsk=jbsk,
                     params=JPT)
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(k["ksk"], PT.ks_decomp, device="cpu"),
        bsk=interop.bootstrap_key_from_standard(k["bsk"], PT.pbs_decomp, 4, device="cpu"),
        params=PT)
    return k, tsk, jsk


def test_trivium_shortint_step_matches_jax(trivium_keys, monkeypatch):
    k, tsk, jsk = trivium_keys
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    monkeypatch.setattr(JServerKey, "apply_lookup_table", _jax_apply_padded)
    try:
        rng = np.random.default_rng(85)
        key_bits = rng.integers(0, 2, 80).tolist()
        iv = rng.integers(0, 2, 80).tolist()
        data = encrypt_big(PT, k["big_bits"], key_bits, seed=86)
        mm, cm = PT.message_modulus, PT.carry_modulus
        tkey = [shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(d)), degree=1,
                                    message_modulus=mm, carry_modulus=cm) for d in data]
        jkey = [JCt(lwe=JLwe(data=jnp.asarray(d)), degree=1, message_modulus=mm,
                    carry_modulus=cm) for d in data]
        port = TriviumStreamShortint(tkey, iv, tsk, warmup_rounds=0)
        ref = JT.TriviumStreamShortint(jkey, iv, jsk, warmup_rounds=0)
        out, jout = port.next_64(), ref.next_64()
    finally:
        config.set_use_pallas_pbs(old[0])
        config.set_pallas_interpret(old[1])
    for t, j in zip(out + port.a + port.b + port.c, jout + ref.a + ref.b + ref.c):
        _same(t, j)
        assert (t.degree, t.noise_level) == (j.degree, j.noise_level)
    got = decrypt_big(PT, k["big_bits"], np.stack([to_numpy_u64(z.lwe.data) for z in out]))
    np.testing.assert_array_equal(got % mm, clear_trivium_keystream(key_bits, iv, 64,
                                                                     warmup_rounds=0))


def test_kreyvium_shortint_decrypts(trivium_keys):
    """Port alone: one round of 64 against the clear model."""
    k, tsk, _ = trivium_keys
    rng = np.random.default_rng(87)
    key_bits = rng.integers(0, 2, 128).tolist()
    iv = rng.integers(0, 2, 128).tolist()
    data = encrypt_big(PT, k["big_bits"], key_bits, seed=88)
    key = [shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(d)), degree=1,
                               message_modulus=2, carry_modulus=4) for d in data]
    out = KreyviumStreamShortint(key, iv, tsk, warmup_rounds=0).next_64()
    got = decrypt_big(PT, k["big_bits"], np.stack([to_numpy_u64(z.lwe.data) for z in out]))
    np.testing.assert_array_equal(got % 2, clear_kreyvium_keystream(key_bits, iv, 64,
                                                                    warmup_rounds=0))


def test_transciphering_into_fheuint64_is_queued(trivium_keys):
    """Transciphering into an FheUint64 needs its keys: a shortint stream
    without the casting key or the hlapi server key, and a clear byte
    stream, refuse it."""
    _, tsk, _ = trivium_keys
    stream = TriviumStreamShortint([0] * 80, [0] * 80, tsk, warmup_rounds=0)
    with pytest.raises(ValueError, match="casting key"):
        stream.trans_encrypt_64(None)
    with pytest.raises(ValueError, match="encrypted"):
        TriviumStreamByte([0] * 10, [0] * 10, warmup_rounds=0).trans_decrypt_64(None)


CAST = (1, 15)            # PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS's base_log x level
VALUE = 0xDEADBEEFCAFEF00D


def _cast_ksk(rng, in_bits, out_bits, std):
    """A keyswitching key [n_in, 15, n_out+1] on the 15 x 1 decomposition."""
    g = np.array([1 << (64 - (l + 1)) for l in range(CAST[1])], dtype=np.uint64)
    pts = in_bits.astype(np.uint64)[:, None] * g
    mask = rng.integers(0, 2 ** 64, pts.shape + (out_bits.size,), dtype=np.uint64)
    noise = np.round(rng.normal(0.0, std, pts.shape)).astype(np.int64).view(np.uint64)
    body = (mask * out_bits.astype(np.uint64)).sum(axis=-1, dtype=np.uint64) + pts + noise
    return np.concatenate([mask, body[..., None]], axis=-1)


@pytest.fixture(scope="module")
def hl_keys():
    """The high-level API's keys at TEST_PARAMS_SHORTINT in both packages, on
    one numpy key, and an FheUint64 of VALUE (32 blocks) in both."""
    from tfhe_tpu import hlapi as JH
    from tfhe_tpu import integer as JI
    from tfhe_tpu_torch import hlapi as TH
    from torch_jax_pbs import jax_server, port_keys
    torch.set_num_threads(1)
    k = real_keys(TEST_PARAMS_SHORTINT, seed=92)
    tck, tsk = port_keys(k, TEST_PARAMS_SHORTINT)
    jsk = jax_server(k, JP_SHORTINT)
    digits = [(VALUE >> (2 * i)) & 3 for i in range(32)]
    blocks = [encrypt_big(TEST_PARAMS_SHORTINT, k["big_bits"], [d], seed=93 + i)
              for i, d in enumerate(digits)]
    tct = TH.FheUint64(interop.radix_ciphertext(blocks, [3] * 32, [1] * 32, 4, 4,
                                                device="cpu"))
    jct = JH.FheUint64(JI.RadixCiphertext(blocks=[
        JCt(lwe=JLwe(data=jnp.asarray(b)), degree=3, message_modulus=4, carry_modulus=4)
        for b in blocks]))
    tcl, tsv = interop.hlapi_keys(tck, tsk)
    return dict(k=k, tck=tck, tsk=tsk, jsk=jsk, tcl=tcl, tsv=tsv,
                jsv=JH.ServerKey(JI.ServerKey(key=jsk)), tct=tct, jct=jct)


def test_trivium_shortint_transciphering_matches_jax(trivium_keys, hl_keys):
    """`TriviumStreamShortint.trans_encrypt_64` (warm-up 0): the keystream
    bit pairs cast from TEST_PARAMS_TRIVIUM into TEST_PARAMS_SHORTINT (the
    wider space: a keyswitch on the 15 x 1 decomposition, then n >> 1) and
    XORed into an FheUint64, block for block JAX's; it decrypts to VALUE
    XOR the clear keystream (`trans_encrypt_u64`), and a second stream of
    the same key and IV takes it back to VALUE."""
    from tfhe_tpu.shortint.key_switching_key import KeySwitchingKey as JKeySwitchingKey
    from torch_jax_pbs import interpreted_pbs
    k, tsk, jsk = trivium_keys
    h = hl_keys
    rng = np.random.default_rng(94)
    key_bits = rng.integers(0, 2, 80).tolist()
    iv = rng.integers(0, 2, 80).tolist()
    ksk = _cast_ksk(rng, k["big_bits"], h["k"]["big_bits"], TEST_PARAMS_SHORTINT.glwe_noise_std)
    tcast = interop.casting_key(ksk, DecompParams(*CAST), TEST_PARAMS_SHORTINT, 1,
                                dest_server_key=h["tsk"], device="cpu")
    jcast = JKeySwitchingKey(ksk=JKsk(data=jnp.asarray(ksk), decomp=JDecomp(*CAST)),
                             dest_params=JP_SHORTINT, cast_rshift=1,
                             dest_server_key=h["jsk"])
    data = encrypt_big(PT, k["big_bits"], key_bits, seed=95)
    tkey = [shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(d)), degree=1,
                                message_modulus=2, carry_modulus=4) for d in data]
    jkey = [JCt(lwe=JLwe(data=jnp.asarray(d)), degree=1, message_modulus=2, carry_modulus=4)
            for d in data]
    with interpreted_pbs():
        got = TriviumStreamShortint(tkey, iv, tsk, cast_ksk=tcast, hl_server_key=h["tsv"],
                                    warmup_rounds=0).trans_encrypt_64(h["tct"])
        want = JT.TriviumStreamShortint(jkey, iv, jsk, cast_ksk=jcast, hl_server_key=h["jsv"],
                                        warmup_rounds=0).trans_encrypt_64(h["jct"])
    for a, b in zip(got.ct.blocks, want.ct.blocks):
        _same(a, b)
        assert (a.degree, a.noise_level) == (b.degree, b.noise_level)
    ks = clear_trivium_keystream(key_bits, iv, 64, warmup_rounds=0)
    assert int(got.decrypt(h["tcl"])[0]) == trans_encrypt_u64(VALUE, ks)
    back = TriviumStreamShortint(tkey, iv, tsk, cast_ksk=tcast, hl_server_key=h["tsv"],
                                 warmup_rounds=0).trans_decrypt_64(got)
    assert int(back.decrypt(h["tcl"])[0]) == VALUE


def test_byte_stream_transciphering_matches_jax(hl_keys):
    """`TriviumStreamByte.trans_encrypt_64` on 8 keystream bytes (encrypted
    FheUint8 of fixed bytes, the same in both packages): each widened to
    32 blocks, shifted to its byte, ORed and XORed into the FheUint64,
    block for block JAX's and decrypted."""
    from tfhe_tpu import integer as JI
    from torch_jax_pbs import interpreted_pbs
    h = hl_keys
    ks_bytes = [0x3C, 0x00, 0xFF, 0x81, 0x5A, 0x01, 0x80, 0x77]
    arrays = [[encrypt_big(TEST_PARAMS_SHORTINT, h["k"]["big_bits"], [(b >> (2 * i)) & 3],
                           seed=200 + 4 * j + i) for i in range(4)]
              for j, b in enumerate(ks_bytes)]
    tbytes = [interop.radix_ciphertext(a, [3] * 4, [1] * 4, 4, 4, device="cpu") for a in arrays]
    jbytes = [JI.RadixCiphertext(blocks=[JCt(lwe=JLwe(data=jnp.asarray(b)), degree=3,
                                             message_modulus=4, carry_modulus=4) for b in a])
              for a in arrays]
    tstream = TriviumStreamByte([0] * 10, [0] * 10, warmup_rounds=0)
    tstream.isk, tstream.next_64 = h["tsv"].radix, lambda: tbytes
    jstream = JT.TriviumStreamByte([0] * 10, [0] * 10, warmup_rounds=0)
    jstream.isk, jstream.next_64 = h["jsv"].radix, lambda: jbytes
    with interpreted_pbs():
        got, want = tstream.trans_encrypt_64(h["tct"]), jstream.trans_encrypt_64(h["jct"])
    for a, b in zip(got.ct.blocks, want.ct.blocks):
        _same(a, b)
    mask = sum(b << (8 * j) for j, b in enumerate(ks_bytes))
    assert int(got.decrypt(h["tcl"])[0]) == VALUE ^ mask


def test_byte_stream_transciphering_round_trip(hl_keys):
    """The port alone: an FheUint8 Trivium byte stream (warm-up 0) on the
    hlapi key masks an FheUint64 with its first 64 keystream bits, those of
    the clear byte model."""
    h = hl_keys
    isk = h["tsv"].radix
    rck = integer.RadixClientKey(key=h["tck"], num_blocks=4)
    key = list(bytes.fromhex("0053A6F94C9FF24598EB"))
    iv = list(bytes.fromhex("0D74DB42A91077DE45AC"))
    enc_key = [rck.encrypt(b, seed=300 + i) for i, b in enumerate(key)]
    cipher = type(h["tct"]).encrypt(VALUE, h["tcl"], seed=310)
    got = TriviumStreamByte(enc_key, iv, isk, warmup_rounds=0).trans_encrypt_64(cipher)
    clear = TriviumStreamByte(key, iv, warmup_rounds=0).next_64()
    mask = sum(b << (8 * j) for j, b in enumerate(clear))
    assert int(got.decrypt(h["tcl"])) == VALUE ^ mask


# ---------------------------------------------------------------------------
# the port alone, decrypted: boolean transciphering, the byte stream on
# integers, the dark market, the regex engine
# ---------------------------------------------------------------------------


def test_boolean_transciphering_round_trip():
    """trans_decrypt_u64_bits XORs the masked clear value into 64 encrypted
    keystream bits (a NOT where its bit is 1); the stream here hands out
    fresh encryptions of a clear keystream (the stream itself is held
    above)."""
    ck, _ = B.gen_keys(P, seed=89, device="cpu")
    rng = np.random.default_rng(90)
    ks = clear_trivium_keystream(rng.integers(0, 2, 80).tolist(),
                                 rng.integers(0, 2, 80).tolist(), 64, warmup_rounds=1)
    value = 0xDEADBEEFCAFEF00D
    masked = trans_encrypt_u64(value, ks)
    assert masked == value ^ sum(b << i for i, b in enumerate(ks))

    class Stream:
        def next_bits(self, n):
            return [B.encrypt(ck, bool(b), seed=i) for i, b in enumerate(ks[:n])]
    bits = trans_decrypt_u64_bits(masked, Stream())
    assert sum(int(B.decrypt(ck, b)) << i for i, b in enumerate(bits)) == value


def test_sha256_bit_list_words_decrypt():
    """The list-of-bits word form (a BoolCiphertext a bit): rotations and
    shifts reindex, `xor_words` and the ripple-carry `add_words` (63 gate
    calls) decrypt to the clear values."""
    ck, sk = B.gen_keys(P, seed=91, device="cpu")
    av, bv = 0x12345678, 0x9ABCDEF0
    a = sha256_bool.encrypt_word(ck, av, seed=1)
    b = sha256_bool.trivial_word(P, bv, device="cpu")
    assert sha256_bool.decrypt_word(ck, sha256_bool.rotr(a, 7)) == \
        ((av >> 7) | (av << 25)) & 0xFFFFFFFF
    assert sha256_bool.decrypt_word(ck, sha256_bool.shr(a, 3, P)) == av >> 3
    assert sha256_bool.decrypt_word(ck, sha256_bool.xor_words(sk, a, b)) == av ^ bv
    assert sha256_bool.decrypt_word(ck, sha256_bool.add_words(sk, a, b, P)) == \
        (av + bv) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def int_keys():
    torch.set_num_threads(1)
    return integer.gen_keys(TEST_PARAMS_SHORTINT, num_blocks=4, seed=71, device="cpu")


def _clear_fill(orders, other_total):
    pre, out = 0, []
    for o in orders:
        out.append(min(o, max(0, other_total - pre)))
        pre += o
    return out


def test_dark_market(int_keys):
    ck, sk = int_keys
    buys, sells = [10, 4, 6], [5, 9]
    fb, fs = dark_market.volume_match(sk, [ck.encrypt(v, seed=100 + i)
                                           for i, v in enumerate(buys)],
                                      [ck.encrypt(v, seed=200 + i) for i, v in enumerate(sells)])
    assert [int(ck.decrypt(x)) for x in fb] == _clear_fill(buys, sum(sells)) == [10, 4, 0]
    assert [int(ck.decrypt(x)) for x in fs] == _clear_fill(sells, sum(buys))
    sells = [5, 9, 2, 7]
    fb, fs = dark_market.volume_match_parallel(sk, ck.encrypt(buys, seed=110),
                                               ck.encrypt(sells, seed=111))
    assert ck.decrypt(fb).tolist() == _clear_fill(buys, sum(sells))
    assert ck.decrypt(fs).tolist() == _clear_fill(sells, sum(buys)) == [5, 9, 2, 4]


@pytest.mark.parametrize("pattern, text, want", [
    ("ab", "ac", False), ("a[bc]", "ac", True), ("a|b?", "b", True), ("/b/", "abc", True),
    ("/^b/", "abc", False), ("/c$/", "abc", True), ("/^aB$/i", "Ab", True),
    ("/^a{2,}$/", "a", False)])
def test_regex_engine(int_keys, pattern, text, want):
    ck, sk = int_keys
    enc = [ck.encrypt(ord(c), seed=300 + i) for i, c in enumerate(text)]
    out = regex_engine.regex_match_radix(sk, pattern, enc)
    assert out.lwe.data.device == torch.device("cpu")
    assert bool(int(ck.key.decrypt(out)) & 1) is want

