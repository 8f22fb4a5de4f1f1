"""The port's boolean scheme on the 32-bit torus (TEST_PARAMS_BOOLEAN_U32,
log_q = 32, held lifted by 2^32) against tfhe_tpu.boolean, bit for bit
(tolerance 0), in both PBS orders: PBS → KS (key choice `small`) and its
KS → PBS twin made by `dataclasses.replace(..., encryption_key_choice=
"big")`.  Every gate on all four operand pairs, a trivial operand, `not_`
and `mux` on all eight triples; the port's words, dropped to 32 bits, equal
the JAX package's uint32 words, and their low 32 bits are zero.  Then the
port alone at 32 bits: its own keys, the compressed ciphertext and server
key, the key-switching cast, the route each key takes and the calls a gate
makes (one keyswitch, and one rotate-subtract rotation of n K7 steps).

The JAX side (tests/torch_boolean_u32_jax.py) runs its XLA PBS (a 32-bit
key has no paired form) with `programmable_bootstrap` and `keyswitch_lwe`
jitted once on rows padded to 32."""
import dataclasses

import numpy as np
import pytest

import tfhe_tpu.boolean as JB
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch.core.algorithms import bootstrap as TB
from tfhe_tpu_torch.core.poly import external_product as EP
from torch_boolean_u32_jax import (ORDERS, U32, both, decrypt_bool, enc_bits, encrypt_bool,
                                   jitted_boolean, keys, servers, words)

GATES = ["and_", "nand", "or_", "nor", "xor_", "xnor"]
TRUTH = {"and_": lambda a, b: a & b, "nand": lambda a, b: ~(a & b),
         "or_": lambda a, b: a | b, "nor": lambda a, b: ~(a | b),
         "xor_": lambda a, b: a ^ b, "xnor": lambda a, b: ~(a ^ b)}
A = np.array([False, False, True, True])
Bv = np.array([False, True, False, True])


@pytest.fixture(scope="module")
def jax_side():
    with jitted_boolean():
        yield


def _operands(k, order, *msgs):
    datas = [encrypt_bool(k, order, m, seed=70 + i) for i, m in enumerate(msgs)]
    # hazard C1 at this width: some bodies have bit 31 set
    assert any((d[..., -1] >> U32(31)).any() for d in datas)
    return [both(d) for d in datas]


def _same(port_ct, jax_ct):
    assert port_ct.log_q == 32
    assert not (port_ct.lwe.data & 0xFFFFFFFF).any(), "a lifted word has low bits set"
    got = words(port_ct)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(jax_ct.lwe.data))
    return got


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("gate", GATES)
def test_gate_matches_jax(jax_side, order, gate):
    k = keys()
    tsk, jsk = servers(k, order)
    (ta, ja), (tb, jb) = _operands(k, order, A, Bv)
    out = _same(getattr(B, gate)(tsk, ta, tb), getattr(JB, gate)(jsk, ja, jb))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(k, order), out), TRUTH[gate](A, Bv))


@pytest.mark.parametrize("order", list(ORDERS))
def test_trivial_operand_and_not_match_jax(jax_side, order):
    k = keys()
    tsk, jsk = servers(k, order)
    p, jp = ORDERS[order]
    (ta, ja), = _operands(k, order, A)
    tt, jt = B.trivial_encrypt(p, Bv, device="cpu"), JB.trivial_encrypt(jp, Bv)
    np.testing.assert_array_equal(words(tt), np.asarray(jt.lwe.data))
    out = _same(B.or_(tsk, ta, tt), JB.or_(jsk, ja, jt))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(k, order), out), A | Bv)
    _same(B.not_(ta), JB.not_(ja))


@pytest.mark.parametrize("order", list(ORDERS))
def test_mux_matches_jax(jax_side, order):
    k = keys()
    tsk, jsk = servers(k, order)
    c = np.array([0, 0, 0, 0, 1, 1, 1, 1], bool)
    t = np.array([0, 0, 1, 1, 0, 0, 1, 1], bool)
    e = np.array([0, 1, 0, 1, 0, 1, 0, 1], bool)
    (tc, jc), (tt, jt), (te, je) = _operands(k, order, c, t, e)
    out = _same(B.mux(tsk, tc, tt, te), JB.mux(jsk, jc, jt, je))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(k, order), out), np.where(c, t, e))


@pytest.mark.parametrize("order", list(ORDERS))
def test_port_keys_serve_gates(order):
    """The port's own 32-bit keys: encrypt (plain and compressed), gates
    and mux, the compressed server key, every output decrypted; the key's
    route is "rotate" and the ciphertexts carry log_q = 32."""
    p = ORDERS[order][0]
    ck, sk = B.gen_keys(p, seed=3, device="cpu")
    assert sk.bsk.route == "rotate" and sk.bsk.spectra.shape[1] == 3
    r = np.random.default_rng(4)
    m = r.integers(0, 2, (3, 24)).astype(bool)
    a = B.encrypt(ck, m[0], seed=1)
    b = B.encrypt_compressed(ck, m[1], seed=2).decompress()
    c = B.encrypt(ck, m[2], seed=3)
    assert a.log_q == b.log_q == 32
    assert not (a.lwe.data & 0xFFFFFFFF).any() and not (b.lwe.data & 0xFFFFFFFF).any()
    for gate in GATES:
        out = getattr(B, gate)(sk, a, b)
        assert B.decrypt(ck, out).tolist() == TRUTH[gate](m[0], m[1]).tolist(), gate
    assert B.decrypt(ck, B.mux(sk, a, b, c)).tolist() == np.where(m[0], m[1], m[2]).tolist()
    csk = B.gen_compressed_server_key(ck, seed=4).decompress()
    assert csk.bsk.route == "rotate"
    assert B.decrypt(ck, B.xnor(csk, a, c)).tolist() == (~(m[0] ^ m[2])).tolist()


def test_key_switching_cast():
    ck1 = B.gen_client_key(ORDERS["pbs_ks"][0], seed=5, device="cpu")
    ck2 = B.gen_client_key(ORDERS["pbs_ks"][0], seed=6, device="cpu")
    m = [True, False, False, True]
    ksk = B.gen_key_switching_key(ck1, ck2, seed=7)
    out = ksk.cast(B.encrypt(ck1, m, seed=8))
    assert out.log_q == 32 and not (out.lwe.data & 0xFFFFFFFF).any()
    assert B.decrypt(ck2, out).tolist() == m


@pytest.mark.parametrize("order", list(ORDERS))
def test_gate_runs_the_rotate_subtract_form(monkeypatch, order):
    """A 32-bit gate is one keyswitch and one PBS whose rotation is n
    external products (one K7 launch a step on the card), never the delta
    form's rotation (K1)."""
    p = ORDERS[order][0]
    ck, sk = B.gen_keys(p, seed=3, device="cpu")
    calls = {"ep": 0, "delta": 0}
    ep = EP.external_product

    def counted(*args, **kw):
        calls["ep"] += 1
        return ep(*args, **kw)

    def refused(*args, **kw):
        calls["delta"] += 1
        raise AssertionError("the delta rotation ran on a 32-bit key")
    monkeypatch.setattr(TB, "external_product", counted)
    monkeypatch.setattr(TB, "blind_rotate_fused", refused)
    monkeypatch.setattr(TB, "blind_rotate_steps", refused)
    a = B.encrypt(ck, [True, False], seed=1)
    B.and_(sk, a, a)
    assert calls == {"ep": p.lwe_dimension, "delta": 0}
    B.mux(sk, a, a, a)
    assert calls == {"ep": 3 * p.lwe_dimension, "delta": 0}


def test_plaintexts_are_lifted():
    """±1/8 built at 32 bits and lifted: the 64-bit words of a 64-bit set."""
    p = ORDERS["ks_pbs"][0]
    assert B.plaintext_true(p) == 1 << 61 and B.plaintext_false(p) == (7 << 61) - (1 << 64)
    assert B.plaintext_true(p) == B.plaintext_true(dataclasses.replace(p, log_q=64))
    ct = B.trivial_encrypt(p, [True, False], device="cpu")
    assert ct.log_q == 32 and tuple(ct.lwe.data.shape) == (2, p.big_lwe_dimension + 1)
    assert words(ct)[:, -1].tolist() == [1 << 29, 7 << 29]
