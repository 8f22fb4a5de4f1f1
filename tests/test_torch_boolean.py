"""The port's boolean scheme against tfhe_tpu.boolean on the same numpy keys
and ciphertexts, bit for bit (tolerance 0: the pipeline is exact), at
TEST_PARAMS_BOOLEAN (key choice `small`: PBS → KS) and at its KS → PBS twin
(key choice `big`, the same widths): every gate on all four operand pairs,
a trivial operand, `not_`, `mux` on all eight triples, the key-switching
cast.  Then the port alone: its own gen_keys → encrypt → gate → decrypt on
the CPU, the calls each gate makes, the 32-bit torus taken and other widths
refused, the card as the default device and operands off the key's device refused.

The JAX side (tests/torch_boolean_jax.py) runs its fused-kernel PBS in
interpret mode; its gates run eagerly, with `programmable_bootstrap` and
`keyswitch_lwe` jitted once on rows padded to 32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.boolean as JB
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN_U32, DecompParams
from torch_boolean_jax import (JP, ORDERS, U64, P, both, decrypt_bool, enc_bits,
                               encrypt_bool, interpret_boolean, servers)
from torch_boolean_jax import numpy_keys as make_numpy_keys
from torch_keys import _ksk, real_keys

GATES = ["and_", "nand", "or_", "nor", "xor_", "xnor"]
TRUTH = {"and_": lambda a, b: a & b, "nand": lambda a, b: ~(a & b),
         "or_": lambda a, b: a | b, "nor": lambda a, b: ~(a | b),
         "xor_": lambda a, b: a ^ b, "xnor": lambda a, b: ~(a ^ b)}
A = np.array([False, False, True, True])
Bv = np.array([False, True, False, True])


@pytest.fixture(scope="module")
def jax_side():
    with interpret_boolean():
        yield


@pytest.fixture(scope="module")
def numpy_keys():
    return make_numpy_keys(61)


def _operands(keys, order, *msgs):
    datas = [encrypt_bool(keys, order, m, seed=70 + i) for i, m in enumerate(msgs)]
    # hazard C1: some bodies have the top bit set
    assert any((d[..., -1] >> U64(63)).any() for d in datas)
    return [both(d) for d in datas]


def _same(port_ct, jax_ct):
    np.testing.assert_array_equal(to_numpy_u64(port_ct.lwe.data), np.asarray(jax_ct.lwe.data))
    return to_numpy_u64(port_ct.lwe.data)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("gate", GATES)
def test_gate_matches_jax(numpy_keys, jax_side, order, gate):
    tsk, jsk = servers(numpy_keys, order)
    (ta, ja), (tb, jb) = _operands(numpy_keys, order, A, Bv)
    out = _same(getattr(B, gate)(tsk, ta, tb), getattr(JB, gate)(jsk, ja, jb))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(numpy_keys, order), out),
                                  TRUTH[gate](A, Bv))


def test_xor_alias():
    assert B.xor is B.xor_


@pytest.mark.parametrize("order", list(ORDERS))
def test_trivial_operand_matches_jax(numpy_keys, jax_side, order):
    """A trivial operand (zero mask, ±1/8 body) broadcast against a batch."""
    p, jp = ORDERS[order]
    tsk, jsk = servers(numpy_keys, order)
    (ta, ja), = _operands(numpy_keys, order, A)
    tt, jt = B.trivial_encrypt(p, True, device="cpu"), JB.trivial_encrypt(jp, jnp.asarray(True))
    _same(tt, jt)
    for gate in ("and_", "xnor"):
        out = _same(getattr(B, gate)(tsk, ta, tt), getattr(JB, gate)(jsk, ja, jt))
        np.testing.assert_array_equal(decrypt_bool(enc_bits(numpy_keys, order), out),
                                      TRUTH[gate](A, np.ones(4, bool)))


@pytest.mark.parametrize("order", list(ORDERS))
def test_not_matches_jax(numpy_keys, order):
    (ta, ja), = _operands(numpy_keys, order, A)
    out = _same(B.not_(ta), JB.not_(ja))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(numpy_keys, order), out), ~A)


@pytest.mark.parametrize("order", list(ORDERS))
def test_mux_matches_jax(numpy_keys, jax_side, order):
    tsk, jsk = servers(numpy_keys, order)
    c, t, e = (np.array([(i >> s) & 1 for i in range(8)], bool) for s in (0, 1, 2))
    (tc, jc), (tt, jt), (te, je) = _operands(numpy_keys, order, c, t, e)
    out = _same(B.mux(tsk, tc, tt, te), JB.mux(jsk, jc, jt, je))
    np.testing.assert_array_equal(decrypt_bool(enc_bits(numpy_keys, order), out),
                                  np.where(c, t, e))


def test_key_switching_cast_matches_jax(numpy_keys, jax_side):
    """From the `small` set's key to a second key of the same set, base 2,
    8 levels (the reference's default), on a numpy KSK."""
    second = real_keys(P, seed=62)
    decomp = DecompParams(2, 8)
    ksk = _ksk(np.random.default_rng(63), dataclasses.replace(P, ks_base_log=2, ks_level=8),
               numpy_keys["lwe_bits"], second["lwe_bits"])
    tcast = B.BooleanKeySwitchingKey(ksk=interop.keyswitch_key(ksk, decomp, device="cpu"),
                                     dest_params=P)
    jcast = JB.BooleanKeySwitchingKey(ksk=JKsk(data=jnp.asarray(ksk), decomp=JDecomp(2, 8)),
                                      dest_params=JP)
    (ta, ja), = _operands(numpy_keys, "pbs_ks", A)
    out = _same(tcast.cast(ta), jcast.cast(ja))
    np.testing.assert_array_equal(decrypt_bool(second["lwe_bits"], out), A)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(ORDERS))
def port_keys(request):
    return request.param, B.gen_keys(ORDERS[request.param][0], seed=5, device="cpu")


def test_port_round_trip(port_keys):
    """gen_keys → encrypt → every gate, not_, mux → decrypt, on the CPU."""
    order, (ck, sk) = port_keys
    assert ck.params.pbs_order == ORDERS[order][0].pbs_order
    a, b = B.encrypt(ck, A.tolist(), seed=1), B.encrypt(ck, Bv.tolist(), seed=2)
    assert torch.equal(B.decrypt(ck, a), torch.as_tensor(A))
    for gate in GATES:
        got = B.decrypt(ck, getattr(B, gate)(sk, a, b)).numpy()
        np.testing.assert_array_equal(got, TRUTH[gate](A, Bv), err_msg=gate)
    np.testing.assert_array_equal(B.decrypt(ck, B.not_(a)).numpy(), ~A)
    c = B.encrypt(ck, [True, False, False, True], seed=3)
    np.testing.assert_array_equal(B.decrypt(ck, B.mux(sk, c, a, b)).numpy(),
                                  np.where([True, False, False, True], A, Bv))
    # a chain: the output of a gate feeds the next
    chained = B.xor_(sk, B.and_(sk, a, b), B.or_(sk, a, b))
    np.testing.assert_array_equal(B.decrypt(ck, chained).numpy(), (A & Bv) ^ (A | Bv))


def test_port_key_switching_round_trip():
    p = ORDERS["pbs_ks"][0]
    ck1, _ = B.gen_keys(p, seed=7, device="cpu")
    ck2, _ = B.gen_keys(p, seed=8, device="cpu")
    cast = B.gen_key_switching_key(ck1, ck2, seed=9)
    ct = B.encrypt(ck1, A.tolist(), seed=4)
    np.testing.assert_array_equal(B.decrypt(ck2, cast.cast(ct)).numpy(), A)


@pytest.mark.parametrize("order", list(ORDERS))
def test_calls_per_gate(monkeypatch, order):
    """One keyswitch and one bootstrap a gate; mux two bootstraps and, under
    KS → PBS two keyswitches, under PBS → KS one: the launches the card's
    phase 4f counts."""
    ck, sk = B.gen_keys(ORDERS[order][0], seed=6, device="cpu")
    calls = {"ks": 0, "pbs": 0}
    ks, pbs = B.keyswitch_lwe, B.programmable_bootstrap

    def count(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call
    monkeypatch.setattr(B, "keyswitch_lwe", count("ks", ks))
    monkeypatch.setattr(B, "programmable_bootstrap", count("pbs", pbs))
    a = B.encrypt(ck, A.tolist(), seed=1)
    for gate in GATES:
        getattr(B, gate)(sk, a, a)
    assert calls == {"ks": 6, "pbs": 6}
    B.mux(sk, a, a, a)
    assert calls == {"ks": 8 if order == "ks_pbs" else 7, "pbs": 8}
    B.not_(a)
    assert calls["pbs"] == 8


def test_32_bit_torus_refused():
    """The 32-bit torus, once refused (ROADMAP A9c), is served now (its
    parity with JAX is tests/test_torch_boolean_u32.py): keys, the key
    classes and trivial encryption take it.  A width the port does not hold
    is still refused, by every entry point."""
    ck, sk = B.gen_keys(TEST_PARAMS_BOOLEAN_U32, seed=5, device="cpu")
    assert sk.bsk.route == "rotate"
    B.ServerKey(bsk=sk.bsk, ksk=sk.ksk, params=TEST_PARAMS_BOOLEAN_U32)
    B.ClientKey(lwe_sk=ck.lwe_sk, glwe_sk=ck.glwe_sk, params=TEST_PARAMS_BOOLEAN_U32)
    assert B.trivial_encrypt(TEST_PARAMS_BOOLEAN_U32, True, device="cpu").log_q == 32
    p16 = dataclasses.replace(TEST_PARAMS_BOOLEAN_U32, log_q=16)
    with pytest.raises(ValueError, match="torus width 16"):
        B.gen_keys(p16, device="cpu")
    with pytest.raises(ValueError, match="torus width 16"):
        B.ServerKey(bsk=sk.bsk, ksk=sk.ksk, params=p16)
    with pytest.raises(ValueError, match="torus width 16"):
        B.ClientKey(lwe_sk=ck.lwe_sk, glwe_sk=ck.glwe_sk, params=p16)
    with pytest.raises(ValueError, match="torus width 16"):
        B.trivial_encrypt(p16, True, device="cpu")


def test_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.gen_keys(P, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.trivial_encrypt(P, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.bool_ciphertext(np.zeros((2, P.lwe_dimension + 1), U64))


def test_operand_off_the_key_device_refused():
    """A ciphertext on another device than the server key raises (here a
    key on the meta device against CPU operands): nothing is moved."""
    ck, sk = B.gen_keys(P, seed=5, device="cpu")
    meta = dataclasses.replace(sk, bsk=dataclasses.replace(
        sk.bsk, spectra=torch.empty(sk.bsk.spectra.shape, dtype=torch.int32, device="meta")))
    a = B.encrypt(ck, [True], seed=1)
    with pytest.raises(ValueError, match="device"):
        B.and_(meta, a, a)
    with pytest.raises(ValueError, match="device"):
        B.mux(meta, a, a, a)
