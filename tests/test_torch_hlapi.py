"""The port's high-level API (`tfhe_tpu_torch.hlapi`) against tfhe_tpu's on
the same numpy keys and ciphertexts (tolerance 0), at TEST_PARAMS_SHORTINT
(2 bits a block): every operator of `_FheUintBase` on FheUint4 (2 blocks)
and, where the signedness changes the op, on FheInt8 (4 blocks), FheUint128
(64 blocks, one row) on `^` and `==`, and every `FheBool` op; each result's blocks
word for word, its degrees and noise levels, and its decryption against the
clear model.  Then the encryptions: `PublicKey` (the JAX key carried over:
bit-identical; the port's own: masks bit for bit, bodies within 8 sigma),
`CompactPublicKey` (r bit for bit, so masks and bodies within the two
packages' noise), `CompressedFheUint` and `CompressedServerKey`, each
decrypted; `generate_keys` and the module's server-key state.

The JAX PBS runs on its fused route in interpret mode, padded
(tests/torch_jax_pbs.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import hlapi as JH
from tfhe_tpu import integer as JI
from tfhe_tpu.core.algorithms import public_key as JPK
from tfhe_tpu.core.algorithms import seeded as JS
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.integer.ciphertext import BooleanBlock as JBooleanBlock
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu_torch import hlapi as TH
from tfhe_tpu_torch import integer, interop
from tfhe_tpu_torch.core.algorithms import public_key as TPK
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from torch_jax_pbs import interpreted_pbs, jax_server, port_keys
from torch_keys import encrypt_big, real_keys

M = P.message_modulus
A4, B4 = [7, 13, 15, 6], [0, 5, 15, 9]
SA, SB = [-7, 100, -128, 5], [3, -100, -1, 0]
W128, W128B = [2 ** 127 + 99], [2 ** 128 - 1]    # one row: 64 blocks
BA, BB = [1, 0, 1, 0], [1, 1, 0, 0]


def _digits(values, nb):
    v = np.asarray(values, dtype=object) % M ** nb
    return [((v // M ** i) % M).astype(np.int64) for i in range(nb)]


class _Side:
    def __init__(self, hl, ck, sk, values):
        self.hl, self.ck, self.sk, self.x = hl, ck, sk, values


@pytest.fixture(scope="module")
def sides():
    """Both packages' hlapi keys on one numpy key, and the operands a, b
    (FheUint4), sa, sb (FheInt8), w (FheUint128), ba, bb (FheBool), each
    block its own encryption, in both."""
    torch.set_num_threads(1)
    k = real_keys(P, seed=71)
    tck, tsk = port_keys(k, P)
    jsk = jax_server(k, JP)
    seeds = iter(range(500, 5000))
    arrays = {}
    for name, (cls, vals, nb) in {"a": ("FheUint4", A4, 2), "b": ("FheUint4", B4, 2),
                                  "sa": ("FheInt8", SA, 4), "sb": ("FheInt8", SB, 4),
                                  "w": ("FheUint128", W128, 64), "w2": ("FheUint128", W128B, 64),
                                  "ba": ("FheBool", BA, 1), "bb": ("FheBool", BB, 1)}.items():
        arrays[name] = (cls, [encrypt_big(P, k["big_bits"], d, seed=next(seeds))
                              for d in _digits(vals, nb)])
    tx, jx = {}, {}
    for name, (cls, blocks) in arrays.items():
        degree = 1 if cls == "FheBool" else M - 1
        t_blocks = interop.radix_ciphertext(blocks, [degree] * len(blocks), [1] * len(blocks),
                                            M, P.carry_modulus, device="cpu")
        j_blocks = JI.RadixCiphertext(blocks=[
            JCt(lwe=JLwe(data=jnp.asarray(b)), degree=degree, message_modulus=M,
                carry_modulus=P.carry_modulus) for b in blocks])
        if cls == "FheBool":
            tx[name] = TH.FheBool(integer.BooleanBlock(block=t_blocks.blocks[0]))
            jx[name] = JH.FheBool(JBooleanBlock(block=j_blocks.blocks[0]))
        else:
            tx[name] = getattr(TH, cls)(t_blocks)
            jx[name] = getattr(JH, cls)(j_blocks)
    tcl, tsv = interop.hlapi_keys(tck, tsk)
    jcl, jsv = JH.ClientKey(None), JH.ServerKey(JI.ServerKey(key=jsk))
    with interpreted_pbs():
        yield {"port": _Side(TH, tcl, tsv, tx), "jax": _Side(JH, jcl, jsv, jx), "k": k}
    TH.unset_server_key()
    JH.unset_server_key()


def _run(sides, op):
    out = []
    for name in ("port", "jax"):
        side = sides[name]
        side.hl.set_server_key(side.sk)
        out.append(op(side.x))
    return out


def _blocks(v):
    if isinstance(v, (TH.FheBool, JH.FheBool)):
        return [v.block.block]
    return list(v.ct.blocks)


def _same(t, j):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _same(a, b)
        return
    assert type(t).__name__ == type(j).__name__
    tb, jb = _blocks(t), _blocks(j)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(to_numpy_u64(a.lwe.data), np.asarray(b.lwe.data))
        assert (a.degree, a.noise_level) == (b.degree, b.noise_level)


def _clear(sides, v):
    """The port value decrypted with the numpy key's client key."""
    if isinstance(v, tuple):
        return tuple(_clear(sides, x) for x in v)
    return v.decrypt(sides["port"].ck).tolist()


U4 = lambda x: x % 16
S8 = lambda x: (x + 128) % 256 - 128
trunc_div = lambda a, b: int(a / b) if b else None

OPS = {
    "add": (lambda x: x["a"] + x["b"], lambda: [U4(a + b) for a, b in zip(A4, B4)]),
    "add_scalar": (lambda x: x["a"] + 3, lambda: [U4(a + 3) for a in A4]),
    "radd": (lambda x: 3 + x["a"], lambda: [U4(a + 3) for a in A4]),
    "sub": (lambda x: x["a"] - x["b"], lambda: [U4(a - b) for a, b in zip(A4, B4)]),
    "sub_scalar": (lambda x: x["a"] - 2, lambda: [U4(a - 2) for a in A4]),
    "rsub": (lambda x: 9 - x["a"], lambda: [U4(9 - a) for a in A4]),
    "mul": (lambda x: x["a"] * x["b"], lambda: [U4(a * b) for a, b in zip(A4, B4)]),
    "mul_scalar": (lambda x: 3 * x["a"], lambda: [U4(3 * a) for a in A4]),
    "neg": (lambda x: -x["a"], lambda: [U4(-a) for a in A4]),
    "and": (lambda x: x["a"] & x["b"], lambda: [a & b for a, b in zip(A4, B4)]),
    "and_scalar": (lambda x: x["a"] & 6, lambda: [a & 6 for a in A4]),
    "or": (lambda x: x["a"] | x["b"], lambda: [a | b for a, b in zip(A4, B4)]),
    "or_scalar": (lambda x: 9 | x["a"], lambda: [a | 9 for a in A4]),
    "xor": (lambda x: x["a"] ^ x["b"], lambda: [a ^ b for a, b in zip(A4, B4)]),
    "xor_scalar": (lambda x: x["a"] ^ 5, lambda: [a ^ 5 for a in A4]),
    "not": (lambda x: ~x["a"], lambda: [U4(~a) for a in A4]),
    "shl": (lambda x: x["a"] << x["b"], lambda: [U4(a << (b % 4)) for a, b in zip(A4, B4)]),
    "shl_scalar": (lambda x: x["a"] << 1, lambda: [U4(a << 1) for a in A4]),
    "shr": (lambda x: x["a"] >> x["b"], lambda: [a >> (b % 4) for a, b in zip(A4, B4)]),
    "shr_scalar": (lambda x: x["a"] >> 2, lambda: [a >> 2 for a in A4]),
    "rotl": (lambda x: x["a"].rotate_left(x["b"]),
             lambda: [U4((a << (b % 4)) | (a >> (4 - b % 4))) for a, b in zip(A4, B4)]),
    "rotr_scalar": (lambda x: x["a"].rotate_right(1), lambda: [U4((a >> 1) | (a << 3))
                                                              for a in A4]),
    "div": (lambda x: x["a"] // x["b"], lambda: [a // b if b else 15
                                                 for a, b in zip(A4, B4)]),
    "div_scalar": (lambda x: x["a"] // 3, lambda: [a // 3 for a in A4]),
    "rem": (lambda x: x["a"] % x["b"], lambda: [a % b if b else a for a, b in zip(A4, B4)]),
    "rem_scalar": (lambda x: x["a"] % 4, lambda: [a % 4 for a in A4]),
    "abs_unsigned": (lambda x: x["a"].abs(), lambda: A4),
    "eq": (lambda x: x["a"] == x["b"], lambda: [a == b for a, b in zip(A4, B4)]),
    "ne_scalar": (lambda x: x["a"] != 15, lambda: [a != 15 for a in A4]),
    "lt": (lambda x: x["a"] < x["b"], lambda: [a < b for a, b in zip(A4, B4)]),
    "le_scalar": (lambda x: x["a"] <= 7, lambda: [a <= 7 for a in A4]),
    "gt_scalar": (lambda x: x["a"] > 6, lambda: [a > 6 for a in A4]),
    "ge": (lambda x: x["a"] >= x["b"], lambda: [a >= b for a, b in zip(A4, B4)]),
    "min": (lambda x: x["a"].min(x["b"]), lambda: [min(a, b) for a, b in zip(A4, B4)]),
    "max_scalar": (lambda x: x["a"].max(8), lambda: [max(a, 8) for a in A4]),
    "overflowing_add": (lambda x: x["a"].overflowing_add(x["b"]),
                        lambda: ([U4(a + b) for a, b in zip(A4, B4)],
                                 [a + b > 15 for a, b in zip(A4, B4)])),
    "overflowing_sub": (lambda x: x["a"].overflowing_sub(x["b"]),
                        lambda: ([U4(a - b) for a, b in zip(A4, B4)],
                                 [a < b for a, b in zip(A4, B4)])),
    "select": (lambda x: (x["a"] > x["b"]).select(x["a"], x["b"]),
               lambda: [max(a, b) for a, b in zip(A4, B4)]),
    # signed: the ops whose form depends on SIGNED
    "s_add": (lambda x: x["sa"] + x["sb"], lambda: [S8(a + b) for a, b in zip(SA, SB)]),
    "s_shr_scalar": (lambda x: x["sa"] >> 2, lambda: [a >> 2 for a in SA]),
    "s_div_scalar": (lambda x: x["sa"] // 4, lambda: [S8(trunc_div(a, 4)) for a in SA]),
    "s_rem_scalar": (lambda x: x["sa"] % 4, lambda: [a - 4 * trunc_div(a, 4) for a in SA]),
    "s_abs": (lambda x: x["sa"].abs(), lambda: [S8(abs(a)) for a in SA]),
    "s_lt": (lambda x: x["sa"] < x["sb"], lambda: [a < b for a, b in zip(SA, SB)]),
    "s_ge_scalar": (lambda x: x["sa"] >= -7, lambda: [a >= -7 for a in SA]),
    "s_max": (lambda x: x["sa"].max(x["sb"]), lambda: [max(a, b) for a, b in zip(SA, SB)]),
    "s_overflowing_add": (lambda x: x["sa"].overflowing_add(x["sb"]),
                          lambda: ([S8(a + b) for a, b in zip(SA, SB)],
                                   [not -128 <= a + b < 128 for a, b in zip(SA, SB)])),
    # 128 bits
    "w_xor": (lambda x: x["w"] ^ x["w2"], lambda: [a ^ b for a, b in zip(W128, W128B)]),
    "w_eq": (lambda x: x["w"] == x["w2"], lambda: [a == b for a, b in zip(W128, W128B)]),
    # FheBool
    "b_and": (lambda x: x["ba"] & x["bb"], lambda: [bool(a & b) for a, b in zip(BA, BB)]),
    "b_or": (lambda x: x["ba"] | x["bb"], lambda: [bool(a | b) for a, b in zip(BA, BB)]),
    "b_xor": (lambda x: x["ba"] ^ x["bb"], lambda: [bool(a ^ b) for a, b in zip(BA, BB)]),
    "b_not": (lambda x: ~x["ba"], lambda: [not a for a in BA]),
    "b_eq": (lambda x: x["ba"].eq(x["bb"]), lambda: [a == b for a, b in zip(BA, BB)]),
    "b_ne": (lambda x: x["ba"].ne(x["bb"]), lambda: [a != b for a, b in zip(BA, BB)]),
    "b_select": (lambda x: x["ba"].if_then_else(x["a"], x["b"]),
                 lambda: [a if c else b for a, b, c in zip(A4, B4, BA)]),
}
OPS["cast_up"] = (lambda x: x["a"].cast_into(
    (TH if isinstance(x["a"], TH.FheUint4) else JH).FheUint8), lambda: A4)
OPS["cast_down"] = (lambda x: x["a"].cast_into(
    (TH if isinstance(x["a"], TH.FheUint4) else JH).FheUint2), lambda: [a % 4 for a in A4])


@pytest.mark.parametrize("name", list(OPS))
def test_operator_equals_jax(sides, name):
    op, clear = OPS[name]
    t, j = _run(sides, op)
    _same(t, j)
    want = clear()
    got = _clear(sides, t)
    if isinstance(want, tuple):
        assert [list(g) for g in got] == [list(w) for w in want]
    else:
        assert list(got) == list(want)


def test_public_key_encryption_equals_jax(sides):
    """The JAX PublicKey's zero encryptions carried over: FheUint4 and
    FheInt8 encryptions bit-identical (threefry subsets); the port's own
    key: its masks JAX's, its bodies within 8 sigma; both decrypt."""
    tcl = TH.ClientKey(port_keys(sides["k"], P)[0])
    jk = JH.PublicKey.__new__(JH.PublicKey)
    jk.params = P
    jk.pk = JPK.LwePublicKey(data=jnp.asarray(np.random.default_rng(72).integers(
        0, 2 ** 64, (2 * tcl.shortint_ck.encryption_key.lwe_dimension,
                     tcl.shortint_ck.encryption_key.lwe_dimension + 1), dtype=np.uint64)))
    tk = TH.PublicKey.__new__(TH.PublicKey)
    tk.params, tk.pk = P, TPK.LwePublicKey(data=from_numpy_u64(np.asarray(jk.pk.data)))
    for cls, vals in (("FheUint4", A4), ("FheInt8", SA)):
        got = getattr(TH, cls).encrypt_with_public_key(vals, tk, seed=5)
        want = getattr(JH, cls).encrypt_with_public_key(np.asarray(vals), jk, seed=5)
        _same(got, want)
    own = TH.PublicKey(tcl, seed=6)
    jown = jax.jit(lambda: JPK.generate_lwe_public_key(
        jax.random.fold_in(jax.random.key(np.uint32(6)), 0xA11),
        JLweSk(bits=jnp.asarray(sides["k"]["glwe_bits"].reshape(-1))),
        2 * P.polynomial_size, 0.0, 64).data)()
    got, want = to_numpy_u64(own.pk.data), np.asarray(jown)
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    diff = (got[:, -1] - want[:, -1]).view(np.int64).astype(np.float64)
    assert np.abs(diff).max() <= 8 * P.glwe_noise_std
    assert TH.FheUint4.encrypt_with_public_key(A4, own, seed=7).decrypt(tcl).tolist() == A4


def test_compact_public_key_encryption(sides):
    """The JAX compact key carried over: the port's encryption under the
    same seed differs from JAX's only by each package's noise (r is
    bit-identical); both decrypt."""
    tcl = TH.ClientKey(port_keys(sides["k"], P)[0])
    own = TH.CompactPublicKey(tcl, seed=8)
    jk = JH.CompactPublicKey.__new__(JH.CompactPublicKey)
    jk.params, jk.pk = P, JPK.LweCompactPublicKey(data=jnp.asarray(to_numpy_u64(own.pk.data)))
    got = TH.FheUint4.encrypt_with_compact_public_key(A4, own, seed=9)
    want = jax.jit(lambda: JH.FheUint4.encrypt_with_compact_public_key(
        np.asarray(A4), jk, seed=9).ct.blocks)()
    for a, b in zip(got.ct.blocks, want):
        diff = (to_numpy_u64(a.lwe.data) - np.asarray(b.lwe.data)).view(np.int64)
        assert np.abs(diff.astype(np.float64)).max() <= 8 * np.sqrt(2) * P.glwe_noise_std
    assert got.decrypt(tcl).tolist() == A4
    assert TH.FheInt8.encrypt_with_compact_public_key(SA, own, seed=10).decrypt(tcl).tolist() \
        == SA


def test_compressed_encryptions_and_server_key(sides):
    """`CompressedFheUint`: each block's masks JAX's for seed * 4099 + i;
    decompressed, it decrypts; `CompressedServerKey` decompressed serves
    an add that decrypts right."""
    tck = port_keys(sides["k"], P)[0]
    tcl = TH.ClientKey(tck)
    c = TH.FheUint4.encrypt_compressed(A4, tcl, seed=11)
    for i, s in enumerate(c.seeded_blocks):
        assert s.seed == 11 * 4099 + i
        want = jax.jit(lambda: JS.decompress_lwe(JS.SeededLweCiphertext(
            body=jnp.zeros(4, jnp.uint64), seed=11 * 4099 + i,
            lwe_dimension=s.lwe_dimension)).data)()
        np.testing.assert_array_equal(to_numpy_u64(c.decompress().ct.blocks[i].lwe.data)[:, :-1],
                                      np.asarray(want)[:, :-1])
    assert c.decompress().decrypt(tcl).tolist() == A4
    server = TH.CompressedServerKey(tcl, seed=12).decompress()
    TH.set_server_key(server)
    x = TH.FheUint4.encrypt(A4, tcl, seed=13)
    assert (x + 3).decrypt(tcl).tolist() == [U4(a + 3) for a in A4]
    TH.unset_server_key()


def test_generate_keys_and_server_key_state(monkeypatch):
    cfg = TH.ConfigBuilder().use_custom_parameters("TEST_PARAMS_SHORTINT").build()
    assert TH.ConfigBuilder.default().params_name == "PARAM_MESSAGE_2_CARRY_2_KS_PBS"
    ck, sk = TH.generate_keys(cfg, seed=14, device="cpu")
    TH.unset_server_key()
    x = TH.FheUint2.encrypt([1, 3], ck, seed=15)
    with pytest.raises(RuntimeError, match="set_server_key"):
        x + x
    TH.set_server_key(sk)
    assert (x + 1).decrypt(ck).tolist() == [2, 0]
    assert TH.FheUint2.encrypt_trivial([2, 1], ck).decrypt(ck).tolist() == [2, 1]
    TH.unset_server_key()
    # the GGSW shift key is built on request (a WoP-PBS set by name)
    _, sk2 = TH.generate_keys(cfg, seed=14, shift_key="TEST_PARAMS_WOPBS", device="cpu")
    assert sk2.radix.shift_key.wopbs.params.name == "TEST_PARAMS_WOPBS"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TH.generate_keys(cfg)
