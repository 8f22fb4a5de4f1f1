"""The port's radix integer layer against tfhe_tpu's integer `ServerKey` on the
same numpy keys and ciphertexts, at TEST_PARAMS_SHORTINT widths with 4
blocks of 2 bits (FheUint8-shaped; 2 blocks where a case is costly): every
output block's LWE words bit for bit, `degree` and `noise_level` equal, the
same errors raised, and the same KS+PBS calls with the same rows in the same
order (the layering the card's launch counts are checked against).  Then the
port alone, decrypted against the clear model at 2, 4, 8 and 64 blocks.

The JAX side runs its fused-kernel PBS in interpret mode, jitted once per
padded row count (rows are independent, so zero rows pad a call to 16 or
64 rows, or a multiple of 64).  Inside the scan divider's `lax.scan` the
jitted call is reached through `jax.pure_callback`, so the scan compiles
no kernel of its own.  The signed and CRT families are in
test_torch_integer_signed_crt.py, on this file's fixtures."""
import math

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
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.integer import ciphertext as jct
from tfhe_tpu.integer.server_key import ServerKey as JIntegerServerKey
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.ciphertext import NoiseLevel as JNoiseLevel
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import integer, interop, shortint
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.integer import (BooleanBlock, CrtCiphertext, RadixCiphertext,
                                    SignedRadixCiphertext)
from torch_keys import encrypt_big, real_keys

M = P.message_modulus                     # 4: 2 bits a block
NB = 4                                    # FheUint8-shaped
A = [7, 200, 255, 123]                    # a batch of 4
B = [0, 100, 255, 9]                      # b = 0, a < b, a == b, a > b
AMOUNT = [1, 3, 6, 0]
COND = [1, 0, 1, 0]
SA = [-7, 100, -128, 5]                   # signed, 8 bits
SB = [3, -100, -1, 0]
A2, B2 = [7, 13, 15, 6], [0, 5, 15, 9]    # 2 blocks: 4 bits
SA2, SB2 = [-7, 5, -8, 6], [3, -3, -1, 0]
CRT_VALUES = ([7, 11, 0, 5], [5, 3, 17, 8])
MODULI = (3, 4)                           # crt_mul needs every modulus <= M

_JAX_APPLY = JServerKey.apply_lookup_table
_BUCKETS = (16, 64)


@jax.jit
def _jax_rows(sk, data, acc):
    """The JAX KS+PBS on rows [R, n+1] with one LUT a row [R, k+1, N]."""
    return _JAX_APPLY(sk, JCt(lwe=JLwe(data=data)), JLut(acc=JGlwe(data=acc))).lwe.data


def _jax_rows_padded(sk, data, acc, calls):
    rows = data.shape[0]
    size = next((b for b in _BUCKETS if rows <= b), -(-rows // 64) * 64)
    data = jnp.pad(jnp.asarray(data), ((0, size - rows), (0, 0)))
    acc = jnp.pad(jnp.asarray(acc), ((0, size - rows), (0, 0), (0, 0)))
    calls.append(rows)
    return _jax_rows(sk, data, acc)[:rows]


def _jax_apply(calls):
    """JAX `apply_lookup_table` with the metadata set as the original sets it;
    each call's row count is appended to `calls` when it runs."""
    def apply(self, ct, lut):
        data = ct.lwe.data
        batch, rows = data.shape[:-1], math.prod(data.shape[:-1])
        acc = jnp.broadcast_to(lut.acc.data, batch + lut.acc.data.shape[-2:])
        acc = acc.reshape((rows,) + lut.acc.data.shape[-2:])
        flat = data.reshape(rows, data.shape[-1])
        if isinstance(flat, jax.core.Tracer):        # inside lax.scan
            out = jax.pure_callback(
                lambda d, a: np.asarray(_jax_rows_padded(self, d, a, calls)),
                jax.ShapeDtypeStruct(flat.shape, flat.dtype), flat, acc)
        else:
            out = _jax_rows_padded(self, flat, acc, calls)
        return ct.with_(lwe=JLwe(data=out.reshape(data.shape)), degree=lut.degree,
                        noise_level=JNoiseLevel.NOMINAL)
    return apply


def _port_apply(calls):
    orig = shortint.ServerKey.apply_lookup_table

    def apply(self, ct, lut):
        calls.append(math.prod(ct.lwe.data.shape[:-1]))
        return orig(self, ct, lut)
    return apply


def _digits(values, nb):
    """Little-endian base-M digits [nb, batch] of values (negative ones in
    two's complement)."""
    v = np.asarray(values, dtype=object) % M ** nb
    return np.stack([((v // M ** i) % M).astype(np.int64) for i in range(nb)])


class _Side:
    """One package's integer server and operands; calls: rows per KS+PBS."""

    def __init__(self, sk, x, calls):
        self.sk, self.x, self.calls = sk, x, calls


def _operands(kind, sk, blocks):
    """Both packages' operands from the same block arrays `blocks`
    ({name: (class, [nb, batch, n+1] u64 or CRT moduli, ...)})."""
    x = {}
    for name, (cls, data, moduli) in blocks.items():
        if kind == "jax":
            bl = [JCt(lwe=JLwe(data=jnp.asarray(d)), degree=M - 1 if not moduli else mi - 1,
                      message_modulus=M, carry_modulus=P.carry_modulus)
                  for d, mi in zip(data, moduli or [0] * len(data))]
            x[name] = {"radix": jct.RadixCiphertext, "signed": jct.SignedRadixCiphertext}[
                cls](blocks=bl) if cls != "crt" else jct.CrtCiphertext(blocks=bl,
                                                                       moduli=moduli)
        else:
            degrees = [M - 1] * len(data) if not moduli else [mi - 1 for mi in moduli]
            x[name] = interop.radix_ciphertext(list(data), degrees, [1] * len(data), M,
                                               P.carry_modulus, kind=cls, moduli=moduli or (),
                                               device="cpu")
    x["cond"] = (jct.BooleanBlock if kind == "jax" else BooleanBlock)(
        block=x.pop("cond_radix").blocks[0].with_(degree=1))
    # from each package's own linear ops: wide = a + b (degree 6, noise 2),
    # full = 5a blockwise (degree 15, noise 5)
    cls = type(x["a"])
    x["wide"] = sk.unchecked_add(x["a"], x["b"])
    x["full"] = cls(blocks=[sk.key.unchecked_scalar_mul(b, 5) for b in x["a"].blocks])
    return x


def _block_arrays(big_bits):
    """{operand: (kind, block data, CRT moduli)}, every block its own seed."""
    seed = iter(range(100, 1000))

    def enc(values, nb):
        return [encrypt_big(P, big_bits, d, seed=next(seed)) for d in _digits(values, nb)]

    def crt(values):
        return [encrypt_big(P, big_bits, np.asarray(values) % mi, seed=next(seed))
                for mi in MODULI]

    return {"a": ("radix", enc(A, NB), None), "b": ("radix", enc(B, NB), None),
            "amount": ("radix", enc(AMOUNT, NB), None),
            "cond_radix": ("radix", enc(COND, 1), None),
            "a2": ("radix", enc(A2, 2), None), "b2": ("radix", enc(B2, 2), None),
            "sa": ("signed", enc(SA, NB), None), "sb": ("signed", enc(SB, NB), None),
            "sa2": ("signed", enc(SA2, 2), None), "sb2": ("signed", enc(SB2, 2), None),
            "ca": ("crt", crt(CRT_VALUES[0]), MODULI), "cb": ("crt", crt(CRT_VALUES[1]), MODULI)}


def jax_server(k):
    """The JAX shortint ServerKey on the numpy key k (TEST_PARAMS_SHORTINT)."""
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, 4))(
        jnp.asarray(k["bsk"]))
    return JServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=JP.ks_decomp), bsk=jbsk,
                      params=JP)


def port_keys_of(k):
    """The port's shortint (ClientKey, ServerKey) on the CPU, on the numpy key k."""
    tsk = shortint.ServerKey(ksk=interop.keyswitch_key(k["ksk"], P.ks_decomp, device="cpu"),
                             bsk=interop.bootstrap_key_from_standard(k["bsk"], P.pbs_decomp, 4,
                                                                     device="cpu"),
                             params=P)
    tck = shortint.ClientKey(glwe_sk=interop.glwe_secret_key(k["glwe_bits"], device="cpu"),
                             lwe_sk=interop.lwe_secret_key(k["lwe_bits"], device="cpu"),
                             params=P)
    return tck, tsk


@pytest.fixture(scope="module")
def integer_sides():
    """Both packages' integer servers and operands, the JAX PBS in
    interpret mode and both `apply_lookup_table`s counting their rows."""
    k = real_keys(P, seed=41)
    arrays = _block_arrays(k["big_bits"])
    jint = JIntegerServerKey(key=jax_server(k))
    tint = integer.ServerKey(key=port_keys_of(k)[1])
    sides = {"jax": _Side(jint, _operands("jax", jint, arrays), []),
             "port": _Side(tint, _operands("port", tint, arrays), [])}
    old = (config.use_pallas_pbs(), config.pallas_interpret(), torch.get_num_threads())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    # the port's calls here are a few rows: more threads only contend with
    # the other test workers
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JServerKey, "apply_lookup_table", _jax_apply(sides["jax"].calls))
        mp.setattr(shortint.ServerKey, "apply_lookup_table", _port_apply(sides["port"].calls))
        yield sides
    config.set_use_pallas_pbs(old[0])
    config.set_pallas_interpret(old[1])
    torch.set_num_threads(old[2])


@pytest.fixture(scope="module")
def port_keys():
    tck, tsk = port_keys_of(real_keys(P, seed=43))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tck, integer.ServerKey(key=tsk)
    torch.set_num_threads(threads)


def run_both(sides, op, cache, name):
    """op on both packages, once per name: → ((result, rows per call) of the
    port, of JAX); a raised error is its class."""
    if name not in cache:
        out = []
        for side in (sides["port"], sides["jax"]):
            side.calls.clear()
            try:
                res = op(side.sk, side.x)
            except (ValueError, ZeroDivisionError) as e:
                res = type(e)
            out.append((res, list(side.calls)))
        cache[name] = tuple(out)
    return cache[name]


def assert_same(t, j, device):
    """Port result t equals JAX result j: every block's words, degree, noise
    level and moduli, the containers' kinds; every port block on `device`."""
    if isinstance(t, tuple):
        assert isinstance(j, tuple) and len(t) == len(j)
        for a, b in zip(t, j):
            assert_same(a, b, device)
    elif isinstance(t, type):                 # the class each package raised
        assert isinstance(j, type) and t.__name__ == j.__name__
    elif isinstance(t, BooleanBlock):
        assert type(j).__name__ == "BooleanBlock"
        assert_same(t.block, j.block, device)
    elif isinstance(t, (RadixCiphertext, CrtCiphertext)):
        assert type(t).__name__ == type(j).__name__
        assert len(t.blocks) == len(j.blocks)
        if isinstance(t, CrtCiphertext):
            assert tuple(t.moduli) == tuple(j.moduli)
        for a, b in zip(t.blocks, j.blocks):
            assert_same(a, b, device)
    else:
        assert t.lwe.data.device == device
        np.testing.assert_array_equal(to_numpy_u64(t.lwe.data), np.asarray(j.lwe.data))
        assert (t.degree, t.noise_level, t.message_modulus, t.carry_modulus) == \
            (j.degree, j.noise_level, j.message_modulus, j.carry_modulus)


# name → op(integer server, operands), run on both packages
OPS = {
    # the stacking plumbing and the carry machinery
    "full_propagate(wide)": lambda s, x: s.full_propagate(x["wide"]),
    "full_propagate(full)": lambda s, x: s.full_propagate(x["full"]),
    "full_propagate_parallelized(wide)": lambda s, x: s.full_propagate_parallelized(x["wide"]),
    "full_propagate_parallelized(full) ripples": lambda s, x: (
        s.full_propagate_parallelized(x["full"])),
    # add, neg, sub; scalar add, sub, mul
    "add": lambda s, x: s.add(x["a"], x["b"]),
    "add(full, full)": lambda s, x: s.add(x["full"], x["full"]),
    "add_parallelized": lambda s, x: s.add_parallelized(x["a"], x["b"]),
    "add_parallelized(wide)": lambda s, x: s.add_parallelized(x["wide"], x["a"]),
    "sub": lambda s, x: s.sub(x["a"], x["b"]),
    "neg": lambda s, x: s.neg(x["a"]),
    "neg(full)": lambda s, x: s.neg(x["full"]),
    "unchecked_neg(full)": lambda s, x: s.unchecked_neg(x["full"]),
    "scalar_add": lambda s, x: s.scalar_add(x["a"], 100),
    "scalar_sub": lambda s, x: s.scalar_sub(x["a"], 77),
    "scalar_mul": lambda s, x: s.scalar_mul(x["a"], 5),
    "scalar_mul(wide, 0)": lambda s, x: s.scalar_mul(x["wide"], 0),
    "small_scalar_mul": lambda s, x: s.small_scalar_mul(x["a"], 3),
    "small_scalar_mul out of range": lambda s, x: s.small_scalar_mul(x["a"], 7),
    "unsigned_overflowing_add": lambda s, x: s.unsigned_overflowing_add(x["a"], x["b"]),
    "unsigned_overflowing_sub": lambda s, x: s.unsigned_overflowing_sub(x["a"], x["b"]),
    "unsigned_overflowing_scalar_add": lambda s, x: (
        s.unsigned_overflowing_scalar_add(x["a"], 200)),
    "unsigned_overflowing_scalar_sub": lambda s, x: (
        s.unsigned_overflowing_scalar_sub(x["a"], 100)),
    # mul and the carry-save sum
    "mul": lambda s, x: s.mul(x["a"], x["b"]),
    "mul(wide, a)": lambda s, x: s.mul(x["wide"], x["a"]),
    "mul 2 blocks": lambda s, x: s.mul(x["a2"], x["b2"]),
    "block_mul": lambda s, x: s.block_mul(x["a"], x["b"].blocks[1], 1),
    "sum_ciphertexts": lambda s, x: s.sum_ciphertexts([x["a"], x["b"], x["wide"], x["a"]]),
    "sum_ciphertexts(empty)": lambda s, x: s.sum_ciphertexts([]),
    "create_trivial_radix": lambda s, x: s.create_trivial_radix(300, NB, (4,)),
    "blockshift": lambda s, x: s.blockshift(x["a"], 2),
    # bitwise, comparisons, cmux, min and max
    "bitand": lambda s, x: s.bitand(x["a"], x["b"]),
    "bitor(wide)": lambda s, x: s.bitor(x["wide"], x["b"]),
    "bitxor": lambda s, x: s.bitxor(x["a"], x["b"]),
    "bitnot": lambda s, x: s.bitnot(x["a"]),
    "eq": lambda s, x: s.eq(x["a"], x["b"]),
    "ne": lambda s, x: s.ne(x["a"], x["b"]),
    "lt": lambda s, x: s.lt(x["a"], x["b"]),
    "le(wide)": lambda s, x: s.le(x["wide"], x["b"]),
    "gt": lambda s, x: s.gt(x["a"], x["b"]),
    "ge": lambda s, x: s.ge(x["a"], x["b"]),
    "scalar_eq": lambda s, x: s.scalar_eq(x["a"], 255),
    "scalar_ne": lambda s, x: s.scalar_ne(x["a"], 7),
    "scalar_lt": lambda s, x: s.scalar_lt(x["a"], 150),
    "scalar_ge": lambda s, x: s.scalar_ge(x["a"], 123),
    "cmux": lambda s, x: s.cmux(x["cond"], x["a"], x["b"]),
    "min": lambda s, x: s.min(x["a"], x["b"]),
    "max": lambda s, x: s.max(x["a"], x["b"]),
    "scalar_min": lambda s, x: s.scalar_min(x["a"], 150),
    "scalar_max": lambda s, x: s.scalar_max(x["a"], 150),
    # shifts and rotates by an encrypted amount (layered path)
    "left_shift": lambda s, x: s.left_shift(x["a"], x["amount"]),
    "right_shift": lambda s, x: s.right_shift(x["a"], x["amount"]),
    "rotate_left": lambda s, x: s.rotate_left(x["a"], x["amount"]),
    "rotate_right 2 blocks": lambda s, x: s.rotate_right(x["a2"], x["b2"]),
    # division
    "div_rem (scan, 8 bits)": lambda s, x: s.div_rem(x["a"], x["b"]),
    "div_rem (unrolled, 4 bits)": lambda s, x: s.div_rem(x["a2"], x["b2"]),
    # clear-amount shifts, casts, scalar bitwise, scalar div
    "scalar_left_shift": lambda s, x: s.scalar_left_shift(x["a"], 3),
    "scalar_right_shift": lambda s, x: s.scalar_right_shift(x["a"], 5),
    "scalar_rotate_left": lambda s, x: s.scalar_rotate_left(x["a"], 3),
    "scalar_rotate_right(blocks)": lambda s, x: s.scalar_rotate_right(x["a"], 2),
    "cast_to_size(6)": lambda s, x: s.cast_to_size(x["wide"], 6),
    "cast_to_size(2)": lambda s, x: s.cast_to_size(x["a"], 2),
    "scalar_bitand": lambda s, x: s.scalar_bitand(x["a"], 0xA5),
    "scalar_bitor": lambda s, x: s.scalar_bitor(x["a"], 0x3C),
    "scalar_bitxor": lambda s, x: s.scalar_bitxor(x["a"], 0xFF),
    "scalar_div_rem": lambda s, x: s.scalar_div_rem(x["a2"], 3),
    "scalar_div(pow2)": lambda s, x: s.scalar_div(x["a"], 4),
    "scalar_div by zero": lambda s, x: s.scalar_div(x["a"], 0),
}

# cases in which both packages must raise (the error's class name is compared)
RAISES = {"small_scalar_mul out of range", "sum_ciphertexts(empty)", "scalar_div by zero"}
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


def test_layering_counts(port_keys):
    """A few of the layers the JAX package documents, as row counts at
    batch 4 (the card's launch checks rest on them): add ripples one 2-row
    call a block (1 row at the top), mul is one call for every lsb/msb
    partial (10 + 6 pairs at 4 blocks), eq is one call and a fold."""
    tck, sk = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=NB)
    ca, cb = ck.encrypt(A, seed=1), ck.encrypt(B, seed=2)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shortint.ServerKey, "apply_lookup_table", _port_apply(calls))
        for op, want in ((sk.add, [8, 8, 8, 4]), (sk.mul, [64]), (sk.eq, [16, 4])):
            calls.clear()
            op(ca, cb)
            assert calls[:len(want)] == want, op.__name__


# ---------------------------------------------------------------------------
# the port alone, decrypted against the clear model
# ---------------------------------------------------------------------------


def _clear_values(bits, rng):
    """Top and bottom of the range, the top bit set, and random values."""
    top = (1 << bits) - 1
    return [0, top, 1 << (bits - 1), top - 1] + [int(v) for v in
                                                 rng.integers(0, 1 << min(bits, 62), 2)]


@pytest.mark.parametrize("nb", [2, 4, 8, 32, 64])
def test_add_and_scalar_add_decrypt(port_keys, nb):
    """add and scalar_add at 4 to 128 bits (64 blocks: Python-int values),
    against the clear model; every block on the key's device.  At 32 blocks
    the values are a list that mixes ints below and above 2^63, which numpy
    alone would turn into float64."""
    tck, sk = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=nb)
    bits = 2 * nb
    rng = np.random.default_rng(nb)
    a = _clear_values(bits, rng)
    b = a[::-1]
    ca, cb = ck.encrypt(a, seed=1), ck.encrypt(b, seed=2)
    scalar = (1 << bits) - 3 if nb < 64 else (1 << 127) + 12345
    for got, want in ((sk.add(ca, cb), [(x + y) % (1 << bits) for x, y in zip(a, b)]),
                      (sk.scalar_add(ca, scalar), [(x + scalar) % (1 << bits) for x in a])):
        assert all(blk.lwe.data.device == tck.device for blk in got.blocks)
        assert [int(v) for v in ck.decrypt(got)] == want


def test_neg_of_full_degree_blocks_decrypts(port_keys):
    """unchecked_neg of blocks at degree 15 adds w·Δ with w = 16 to block 0,
    16·Δ = 2^63 (hazard C1: the constant must wrap to int64), and w = 12 to
    the others: each block decrypts, padding bit included, to w - 5·digit."""
    tck, sk = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=NB)
    ca = ck.encrypt(A, seed=5)
    full = RadixCiphertext(blocks=[sk.key.unchecked_scalar_mul(b, 5) for b in ca.blocks])
    neg = sk.unchecked_neg(full)
    assert [b.degree for b in neg.blocks] == [16, 12, 12, 12]
    for blk, w, digits in zip(neg.blocks, (16, 12, 12, 12), _digits(A, NB)):
        assert tck.decrypt_message_and_carry(blk).tolist() == [(w - 5 * d) % 32 for d in digits]


def test_mul_div_and_shift_decrypt(port_keys):
    """mul, div_rem (x / 0 included) and an encrypted-amount shift at 8 bits
    against the clear model."""
    tck, sk = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=NB)
    ca, cb, amt = ck.encrypt(A, seed=6), ck.encrypt(B, seed=7), ck.encrypt(AMOUNT, seed=8)
    assert [int(v) for v in ck.decrypt(sk.mul(ca, cb))] == [x * y % 256 for x, y in zip(A, B)]
    q, r = sk.div_rem(ca, cb)
    assert [int(v) for v in ck.decrypt(q)] == [x // y if y else 255 for x, y in zip(A, B)]
    assert [int(v) for v in ck.decrypt(r)] == [x % y if y else x for x, y in zip(A, B)]
    assert [int(v) for v in ck.decrypt(sk.left_shift(ca, amt))] == \
        [(x << s) % 256 for x, s in zip(A, AMOUNT)]


def test_client_key_round_trip(port_keys):
    """Encrypt / decrypt, trivial and signed forms, a 0-d value and FheUint256
    widths, with the JAX key's block seeds (seed * 1009 + i)."""
    tck, _ = port_keys
    ck = integer.RadixClientKey(key=tck, num_blocks=128)
    big = [(1 << 256) - 1, 1 << 255, 12345678901234567890123456789]
    assert [int(v) for v in ck.decrypt(ck.encrypt(big, seed=3))] == big
    assert [int(v) for v in ck.decrypt(ck.trivial_encrypt(big))] == big
    ck8 = integer.RadixClientKey(key=tck, num_blocks=NB)
    assert ck8.decrypt(ck8.encrypt(200, seed=1)) == 200
    assert list(ck8.decrypt_signed(ck8.encrypt_signed(SA, seed=2))) == SA
    ct = ck8.encrypt(A, seed=9)
    assert torch.equal(ct.blocks[2].lwe.data, tck.encrypt(_digits(A, NB)[2], seed=9 * 1009 + 2)
                       .lwe.data)
    assert ct.batch_shape == (4,) and ct.block_carries_are_empty()
    assert ck8.total_bits == 8 and ck8.bits_per_block == 2


def test_shortint_pieces(port_keys):
    """The shortint pieces the integer layer needs: unchecked_encrypt's
    degree, trivial_encrypt's zero mask and noise level, batch_shape and
    carry_is_empty."""
    tck, sk = port_keys
    u = tck.unchecked_encrypt([9, 15, 0], seed=4)
    assert u.degree == 15 and not u.carry_is_empty and u.batch_shape == (3,)
    assert tck.decrypt_message_and_carry(u).tolist() == [9, 15, 0]
    t = tck.trivial_encrypt([1, 3])
    assert t.noise_level == shortint.NoiseLevel.ZERO and t.degree == M - 1 and t.carry_is_empty
    assert not t.lwe.data[:, :-1].any() and tck.decrypt(t).tolist() == [1, 3]
    assert tck.trivial_encrypt([2], degree=7).degree == 7


ENTRY_POINTS = {
    "integer.gen_keys": lambda: integer.gen_keys(P, num_blocks=2)[1].device,
    "interop.radix_ciphertext": lambda: interop.radix_ciphertext(
        [np.zeros((2, 5), np.uint64)], [3], [1], 4, 4).blocks[0].lwe.data.device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(name):
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()


def test_shift_key_not_ported():
    """The shift key is ported: `gen_keys(shift_key=...)` builds it (its
    parity is tests/test_torch_shift_key.py)."""
    from tfhe_tpu_torch.core.params import TEST_PARAMS_WOPBS
    from tfhe_tpu_torch.integer.shift_key import ShiftKey, ggsw_shift_supported
    _, sk = integer.gen_keys(P, num_blocks=2, shift_key=TEST_PARAMS_WOPBS, device="cpu")
    assert isinstance(sk.shift_key, ShiftKey)
    assert ggsw_shift_supported(sk.shift_key, M, 2, 2)


def test_interop_kinds():
    z = [np.zeros((2, 5), np.uint64)] * 2
    assert type(interop.radix_ciphertext(z, [3, 3], [1, 1], 4, 4, kind="signed",
                                         device="cpu")) is SignedRadixCiphertext
    crt = interop.radix_ciphertext(z, [2, 3], [1, 1], 4, 4, kind="crt", moduli=(3, 4),
                                   device="cpu")
    assert crt.moduli == (3, 4) and [b.degree for b in crt.blocks] == [2, 3]
    for bad in (dict(kind="crt", moduli=(3,)), dict(kind="other")):
        with pytest.raises(ValueError):
            interop.radix_ciphertext(z, [3, 3], [1, 1], 4, 4, device="cpu", **bad)
