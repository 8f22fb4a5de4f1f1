"""The port's WoP-PBS (`tfhe_tpu_torch/core/algorithms/wopbs.py`,
`tfhe_tpu_torch/shortint/wopbs.py`) bit for bit against tfhe_tpu's on the
same numpy keys and ciphertexts (tolerance 0), at TEST_PARAMS_SHORTINT (the
only-for-wopbs regime, the JAX tests' default cbs 6 x 2 and pfks 4 x 8)
and TEST_PARAMS_WOPBS (the combined regime: pfks 15 x 2, the wide form):

* the PFPKSK list's generation (noise 0: every word equal) and the private
  functional keyswitch on both contraction forms;
* `extract_bits`, `circuit_bootstrap_boolean` and `WopbsKey.wopbs` with a
  LUT of one polynomial (no CMux tree) and of four (a tree of two CMux
  layers over the two most significant bits, then two rotation steps);
* `CombinedWopbsKey.wopbs` on keys carried across (`interop`);
* decrypted: every bit and every LUT output, and the port's own
  `new_wopbs_key_only_for_wopbs` and `new_wopbs_key`; the WoP-PBS client
  key's bits equal JAX's for the same seed (threefry).

The JAX PBS runs on its fused route in interpret mode, padded
(tests/torch_jax_pbs.py); its keyswitch, private functional keyswitch,
GGSW conversion and vertical packing each jitted once a shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.algorithms.wopbs as JW
import tfhe_tpu.shortint.wopbs as JSW
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.params import TEST_PARAMS_WOPBS as JPW
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core import threefry
from tfhe_tpu_torch.core.algorithms import wopbs as TW
from tfhe_tpu_torch.core.algorithms.encryption import decrypt_lwe
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import TEST_PARAMS_WOPBS as PW
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.shortint import wopbs as SW
from torch_jax_pbs import interpreted_pbs, jax_server, port_keys
from torch_keys import _ksk, encrypt_big, real_keys

U64 = np.uint64
CBS, PFKS = DecompParams(6, 2), DecompParams(4, 8)     # new_wopbs_key_only_for_wopbs's
MSGS = [0, 5, 10, 15]
F = lambda x: (x * x + 3) % 16


def _same(t, j):
    np.testing.assert_array_equal(to_numpy_u64(t), np.asarray(j))


def _ct_pair(data, degree=15):
    """One shortint ciphertext array as both packages' ciphertexts."""
    return (shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=degree,
                                message_modulus=4, carry_modulus=4),
            JCt(lwe=JLwe(data=jnp.asarray(data)), degree=degree, message_modulus=4,
                carry_modulus=4))


def _jitted(fn, *static):
    return jax.jit(fn, static_argnums=static)


@pytest.fixture(scope="module")
def sides():
    """Both packages' only-for-wopbs keys on the same numpy keys; the
    PFPKSK list made by the port (threefry masks, seeded noise) and carried
    to JAX."""
    torch.set_num_threads(1)
    k = real_keys(P, seed=51)
    tck, tsk = port_keys(k, P)
    jsk = jax_server(k, JP)
    twk = SW.new_wopbs_key_only_for_wopbs(tck, tsk, seed=52)
    jpf = JW.CbsPfpkskList(data=jnp.asarray(to_numpy_u64(twk.pfpksk.data)),
                           decomp=JDecomp(PFKS.base_log, PFKS.level))
    jwk = JSW.WopbsKey(server_key=jsk, pfpksk=jpf, cbs_decomp=JDecomp(CBS.base_log, CBS.level))
    ct = encrypt_big(P, k["big_bits"], MSGS, seed=53)
    with interpreted_pbs(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JW, "keyswitch_lwe", _jitted(JW.keyswitch_lwe, 2))
        mp.setattr(JW, "private_functional_keyswitch",
                   _jitted(JW.private_functional_keyswitch, 2, 3))
        mp.setattr(JSW, "ggsw_to_ntt", _jitted(JSW.ggsw_to_ntt, 1))
        mp.setattr(JSW, "vertical_packing", _jitted(JSW.vertical_packing, 3, 4, 5))
        yield k, tck, twk, jwk, ct


def test_pfpksk_generation_equals_jax():
    """With noise 0 the PFPKSK list is its masks and plaintexts: every word
    of the port's equals JAX's under the same threefry key."""
    rng = np.random.default_rng(54)
    big = rng.integers(0, 2, 32).astype(np.int8)
    glwe = rng.integers(0, 2, (1, 64)).astype(np.int8)
    decomp = DecompParams(5, 3)
    want = jax.jit(lambda: JW.generate_cbs_pfpksk(
        jax.random.fold_in(jax.random.key(np.uint32(7)), 3), JLweSk(bits=jnp.asarray(big)),
        JGlweSk(bits=jnp.asarray(glwe)), JDecomp(5, 3), 0.0, 64).data)()
    got = TW.generate_cbs_pfpksk(
        threefry.fork(threefry.key_from_seed(7, "cpu"), 3), torch.Generator(),
        interop.lwe_secret_key(big, device="cpu"), interop.glwe_secret_key(glwe, device="cpu"),
        decomp, 0.0)
    _same(got.data, want)


@pytest.mark.parametrize("base_log, level", [(4, 8), (15, 2)])
def test_private_functional_keyswitch_equals_jax(base_log, level):
    """Both rows of a uniform PFPKSK list [2, n_in+1, l, 2, N], on the
    tensor-core form's shape (4 x 8) and the wide form's (15 x 2), top-bit
    words in the input."""
    rng = np.random.default_rng(55 + base_log)
    n_in = 64
    data = rng.integers(0, 2 ** 64, (2, n_in + 1, level, 2, 64), dtype=U64)
    cts = rng.integers(0, 2 ** 64, (3, n_in + 1), dtype=U64)
    cts[0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    pf = TW.CbsPfpkskList(data=from_numpy_u64(data), decomp=DecompParams(base_log, level))
    jd = JDecomp(base_log, level)
    fn = jax.jit(lambda c, row: JW.private_functional_keyswitch(JLwe(data=c), row, jd, 64).data)
    for r in range(2):
        _same(TW.private_functional_keyswitch(LweCiphertext(data=from_numpy_u64(cts)), pf, r)
              .data, fn(cts, jnp.asarray(data[r])))


def test_extract_bits_and_circuit_bootstrap_equal_jax(sides):
    """The 4 bits of 0, 5, 10, 15 (MSB first) and the GGSW of the first,
    each word equal to JAX's; every bit decrypts right."""
    k, tck, twk, jwk, ct = sides
    tct, jct = _ct_pair(ct)
    bits, jbits = twk.extract_bits(tct), jwk.extract_bits(jct)
    _same(bits.data, jbits.data)
    phase = to_numpy_u64(decrypt_lwe(bits, tck.lwe_sk))
    got = ((phase + U64(1 << 62)) >> U64(63)) % U64(2)
    np.testing.assert_array_equal(got, [[(m >> (3 - i)) & 1 for i in range(4)] for m in MSGS])
    one = LweCiphertext(data=bits.data[..., 0, :])
    ggsw = TW.circuit_bootstrap_boolean(twk.server_key.bsk, one, twk.pfpksk, CBS, 63)
    jggsw = JW.circuit_bootstrap_boolean(jwk.server_key.bsk, JLwe(data=jbits.data[..., 0, :]),
                                         jwk.pfpksk, jwk.cbs_decomp, 63, 64)
    _same(ggsw.data, jggsw.data)


def _four_poly_lut(wk, f):
    """A LUT of 4 polynomials over 16 values: value v at polynomial v >> 2,
    coefficient v & 3 (the tree takes the 2 MSBs, the rotation the 2 LSBs)."""
    delta = (1 << 64) // 32
    polys = np.zeros((4, P.polynomial_size), dtype=U64)
    for v in range(16):
        polys[v >> 2, v & 3] = U64(f(v) * delta)
    return (SW.WopbsLut(polys=from_numpy_u64(polys), degree=15),
            JSW.WopbsLut(polys=jnp.asarray(polys), degree=15))


@pytest.mark.parametrize("tree", [False, True])
def test_wopbs_equals_jax(sides, tree):
    """`WopbsKey.wopbs` of f(x) = x^2 + 3 mod 16: equal to JAX's word for
    word and decrypted right, without and with the CMux tree."""
    k, tck, twk, jwk, ct = sides
    tct, jct = _ct_pair(ct)
    if tree:
        tlut, jlut = _four_poly_lut(twk, F)
    else:
        tlut, jlut = twk.generate_lut(F), jwk.generate_lut(F)
        _same(tlut.polys, jlut.polys)
    out, jout = twk.wopbs(tct, tlut), jwk.wopbs(jct, jlut)
    _same(out.lwe.data, jout.lwe.data)
    assert (out.degree, out.noise_level) == (jout.degree, jout.noise_level)
    np.testing.assert_array_equal(tck.decrypt_message_and_carry(out).numpy(),
                                  [F(m) for m in MSGS])


def test_combined_wopbs_equals_jax(sides):
    """The combined regime on keys carried across: the compute keys at
    TEST_PARAMS_SHORTINT, the WoP-PBS keys at TEST_PARAMS_WOPBS, the casting
    keys into (compute KS decomposition, WoP-PBS noise) and out of it; the
    identity and f, decrypted right."""
    k, tck, twk, jwk, ct = sides
    jsk = jwk.server_key
    kw = real_keys(PW, seed=57)
    rng = np.random.default_rng(58)
    ksk_in = _ksk(rng, P, k["big_bits"], kw["big_bits"])
    ksk_out = _ksk(rng, P, kw["big_bits"], k["lwe_bits"])
    _, twsk = port_keys(kw, PW)
    jwsk = jax_server(kw, JPW)
    pf = SW.new_wopbs_key_only_for_wopbs(*port_keys(kw, PW), cbs_decomp=PW.cbs_decomp,
                                         pfks_decomp=PW.pfks_decomp, seed=59).pfpksk
    pf_data = to_numpy_u64(pf.data)
    tcomb = interop.combined_wopbs_key(
        interop.wopbs_key(twsk, pf_data, PW.pfks_decomp, PW.cbs_decomp, device="cpu"),
        shortint.ServerKey(ksk=interop.keyswitch_key(ksk_out, P.ks_decomp, device="cpu"),
                           bsk=twk.server_key.bsk, params=P),
        ksk_in, P.ks_decomp, device="cpu")
    jcomb = JSW.CombinedWopbsKey(
        wopbs_key=JSW.WopbsKey(server_key=jwsk, pfpksk=JW.CbsPfpkskList(
            data=jnp.asarray(pf_data), decomp=JPW.pfks_decomp), cbs_decomp=JPW.cbs_decomp),
        pbs_server_key=JServerKey(ksk=JKsk(data=jnp.asarray(ksk_out), decomp=JP.ks_decomp),
                                  bsk=jsk.bsk, params=JP),
        ksk_pbs_to_wopbs=JKsk(data=jnp.asarray(ksk_in), decomp=JP.ks_decomp))
    data = encrypt_big(P, k["big_bits"], [0, 1, 2, 3], seed=60)
    tct, jct = _ct_pair(data, degree=3)
    g = lambda x: (3 * x + 1) % 4
    for f in (lambda x: x, g):
        out = tcomb.wopbs(twk.server_key, tct, tcomb.generate_lut(f))
        jout = jcomb.wopbs(jsk, jct, jcomb.generate_lut(f))
        _same(out.lwe.data, jout.lwe.data)
        np.testing.assert_array_equal(tck.decrypt(out).numpy(), [f(m) for m in range(4)])


def test_wopbs_client_key_equals_jax():
    """The combined regime's client key: the port's bits are JAX's for the
    same seed."""
    jck = JSW._wopbs_client_key(None, JPW, 61)
    tck = SW._wopbs_client_key(shortint.ClientKey(
        glwe_sk=interop.glwe_secret_key(np.zeros((1, 4)), device="cpu"),
        lwe_sk=interop.lwe_secret_key(np.zeros(4), device="cpu"), params=P), PW, 61)
    np.testing.assert_array_equal(tck.glwe_sk.bits.numpy(), np.asarray(jck.glwe_sk.bits))
    np.testing.assert_array_equal(tck.lwe_sk.bits.numpy(), np.asarray(jck.lwe_sk.bits))


def test_port_wopbs_keys_decrypt():
    """The port alone: `new_wopbs_key_only_for_wopbs` on its own keys (all
    16 values through an arbitrary LUT) and `new_wopbs_key` at
    TEST_PARAMS_WOPBS, decrypted."""
    ck, sk = shortint.gen_keys(P, seed=62, device="cpu")
    wk = SW.new_wopbs_key_only_for_wopbs(ck, sk, seed=63)
    ct = ck.unchecked_encrypt(torch.arange(16), seed=64)
    out = wk.wopbs(ct, wk.generate_lut(F))
    assert ck.decrypt_message_and_carry(out).tolist() == [F(v) for v in range(16)]
    comb = SW.new_wopbs_key(ck, sk, PW, seed=65)
    assert comb.params == PW
    g = lambda x: (x * 3 + 2) % 4
    out = comb.wopbs(sk, ck.encrypt(torch.arange(4), seed=66), comb.generate_lut(g))
    assert ck.decrypt(out).tolist() == [g(v) for v in range(4)]
