"""The port's signed radix and CRT integer ops against tfhe_tpu's integer
`ServerKey`, as test_torch_integer.py holds the unsigned ones (and on its
fixtures): every output block bit for bit with its degree and noise level,
the same errors, the same KS+PBS calls and rows; then a crt_mul fault of the
reference that the port refuses, and the port alone decrypted against the
clear model."""
import numpy as np
import pytest

from tfhe_tpu.integer import ciphertext as jct
from tfhe_tpu.integer.server_key import ServerKey as JIntegerServerKey
from tfhe_tpu_torch import integer
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.integer import CrtCiphertext
from test_torch_integer import (A, B, CRT_VALUES, MODULI, NB, SA, SA2, SB, SB2,  # noqa: F401
                                assert_same, integer_sides, port_keys, run_both)
from torch_keys import decrypt_big, encrypt_big, real_keys

OPS = {
    # signed comparisons, min and max, abs, the overflowing add and sub
    "lt_signed": lambda s, x: s.lt_signed(x["sa"], x["sb"]),
    "le_signed": lambda s, x: s.le_signed(x["sa"], x["sb"]),
    "gt_signed": lambda s, x: s.gt_signed(x["sa"], x["sb"]),
    "ge_signed": lambda s, x: s.ge_signed(x["sa"], x["sb"]),
    "min_signed": lambda s, x: s.min_signed(x["sa"], x["sb"]),
    "max_signed": lambda s, x: s.max_signed(x["sa"], x["sb"]),
    "abs_signed": lambda s, x: s.abs_signed(x["sa"]),
    "signed_overflowing_add": lambda s, x: s.signed_overflowing_add(x["sa"], x["sb"]),
    "signed_overflowing_sub": lambda s, x: s.signed_overflowing_sub(x["sa"], x["sb"]),
    "signed_overflowing_scalar_add": lambda s, x: (
        s.signed_overflowing_scalar_add(x["sa"], -100)),
    "signed_overflowing_scalar_sub": lambda s, x: (
        s.signed_overflowing_scalar_sub(x["sa"], 100)),
    # signed division (the unrolled divider at 4 bits), signed scalar ops
    "signed_div_rem": lambda s, x: s.signed_div_rem(x["sa2"], x["sb2"]),
    "div_rem dispatches signed": lambda s, x: s.div_rem(x["sa2"], x["sb2"]),
    "signed_div_rem_floor": lambda s, x: s.signed_div_rem_floor(x["sa2"], x["sb2"]),
    "signed_scalar_div_rem": lambda s, x: s.signed_scalar_div_rem(x["sa2"], -3),
    "signed_scalar_div by zero": lambda s, x: s.signed_scalar_div(x["sa"], 0),
    "scalar_lt_signed": lambda s, x: s.scalar_lt_signed(x["sa"], -5),
    "scalar_ge_signed": lambda s, x: s.scalar_ge_signed(x["sa"], 5),
    "scalar_right_shift_arithmetic": lambda s, x: s.scalar_right_shift_arithmetic(x["sa"], 3),
    "right_shift_arithmetic": lambda s, x: s.right_shift_arithmetic(x["sa2"], x["b2"]),
    # CRT
    "crt_add": lambda s, x: s.crt_add(x["ca"], x["cb"]),
    "crt_sub": lambda s, x: s.crt_sub(x["ca"], x["cb"]),
    "crt_mul": lambda s, x: s.crt_mul(x["ca"], x["cb"]),
    "crt_neg": lambda s, x: s.crt_neg(x["ca"]),
    "crt_scalar_add": lambda s, x: s.crt_scalar_add(x["ca"], 5),
    "crt_scalar_sub": lambda s, x: s.crt_scalar_sub(x["ca"], 4),
    "crt_scalar_mul": lambda s, x: s.crt_scalar_mul(x["ca"], 7),
    "pbs_crt_compliant_function": lambda s, x: s.pbs_crt_compliant_function(
        x["ca"], lambda v: v * v + 1),
    "full_extract_message": lambda s, x: s.full_extract_message(x["ca"]),
}

RAISES = {"signed_scalar_div by zero"}
_CACHE: dict = {}


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax(integer_sides, name):
    (t, _), (j, _) = run_both(integer_sides, OPS[name], _CACHE, name)
    assert_same(t, j, integer_sides["port"].sk.device)
    assert isinstance(t, type) == (name in RAISES)


@pytest.mark.parametrize("name", list(OPS))
def test_same_layering(integer_sides, name):
    """The same KS+PBS calls, with the same rows, in the same order."""
    (_, t_calls), (_, j_calls) = run_both(integer_sides, OPS[name], _CACHE, name)
    assert t_calls == j_calls


def test_crt_mul_beyond_the_message_modulus(integer_sides):
    """crt_mul packs residues as x * m + y, so a modulus above m (5 > 4 here)
    lets y = 4 carry into x's digit: the JAX package returns a wrong product
    (2 * 4 mod 5 comes out 0, not 3); the port refuses the moduli."""
    jside, tside = integer_sides["jax"], integer_sides["port"]
    k = real_keys(P, seed=41)                 # the fixtures' key
    data = [encrypt_big(P, k["big_bits"], np.array([v]), seed=70 + v) for v in (2, 4)]
    jx, jy = (jct.CrtCiphertext(blocks=[jside.x["ca"].blocks[0].with_(
        lwe=type(jside.x["ca"].blocks[0].lwe)(data=d), degree=4)], moduli=(5,)) for d in data)
    got = decrypt_big(P, k["big_bits"], np.asarray(jside.sk.crt_mul(jx, jy).blocks[0].lwe.data))
    assert int(got[0]) % 5 == 0 != (2 * 4) % 5
    tx = CrtCiphertext(blocks=tside.x["ca"].blocks[:1], moduli=(5,))
    with pytest.raises(ValueError, match="every modulus"):
        tside.sk.crt_mul(tx, tx)


def test_signed_and_crt_decrypt(port_keys):
    """Signed ops at 8 bits and CRT ops on the moduli (2, 3, 5) for the add
    and (3, 4) for the mul, decrypted against the clear model."""
    tck, sk = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=NB)
    sa, sb = ck.encrypt_signed(SA, seed=11), ck.encrypt_signed(SB, seed=12)

    def wrap(v):
        return (v + 128) % 256 - 128

    assert list(ck.decrypt_signed(sk.abs_signed(sa))) == [wrap(abs(v)) for v in SA]
    assert list(ck.decrypt_bool(sk.lt_signed(sa, sb))) == [x < y for x, y in zip(SA, SB)]
    s, ov = sk.signed_overflowing_add(sa, sb)
    assert list(ck.decrypt_signed(s)) == [wrap(x + y) for x, y in zip(SA, SB)]
    assert list(ck.decrypt_bool(ov)) == [not -128 <= x + y < 128 for x, y in zip(SA, SB)]
    s, ov = sk.unsigned_overflowing_add(ck.encrypt(A, seed=13), ck.encrypt(B, seed=14))
    assert [int(v) for v in ck.decrypt(s)] == [(x + y) % 256 for x, y in zip(A, B)]
    assert list(ck.decrypt_bool(ov)) == [x + y >= 256 for x, y in zip(A, B)]
    ck2 = integer.RadixClientKey(key=tck, num_blocks=2)
    q, r = sk.signed_div_rem(ck2.encrypt_signed(SA2, seed=15), ck2.encrypt_signed(SB2, seed=16))
    trunc = [int(x / y) if y else (-1 if x >= 0 else 1) for x, y in zip(SA2, SB2)]
    assert list(ck2.decrypt_signed(q)) == [(v + 8) % 16 - 8 for v in trunc]
    assert list(ck2.decrypt_signed(r)) == [x - t * y if y else x
                                           for x, y, t in zip(SA2, SB2, trunc)]
    for moduli, op, clear in (((2, 3, 5), sk.crt_add, lambda x, y: x + y),
                              ((3, 4), sk.crt_mul, lambda x, y: x * y)):
        cck = integer.CrtClientKey(key=tck, moduli=moduli)
        mod = int(np.prod(moduli))
        got = cck.decrypt(op(cck.encrypt(CRT_VALUES[0], seed=17),
                             cck.encrypt(CRT_VALUES[1], seed=18)))
        assert [int(v) for v in got] == [clear(x, y) % mod for x, y in zip(*CRT_VALUES)]
