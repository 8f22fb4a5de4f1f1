"""The port's shortint op families against tfhe_tpu's `ServerKey` on the same
numpy keys and ciphertexts, with a classic key and a multi-bit key
(grouping 2) at TEST_PARAMS_SHORTINT widths: every output LWE bit for bit,
`degree` and `noise_level` equal, and `CheckError` (or the reference's other
errors) raised in the same cases.

The JAX side runs its fused-kernel PBS in interpret mode.  Its
`apply_lookup_table` is jitted once per key and batch (its LWE path; the
metadata it sets, the LUT's degree and NOMINAL noise, is set beside the
jitted call as the original sets it), so the ops' linear glue runs eagerly
and no op pays a compile of its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import MultiBitPBSParameters as JMultiBit
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.ciphertext import NoiseLevel as JNoiseLevel
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.shortint import CheckError
from torch_keys import encrypt_big, multi_bit_params, real_keys, real_multi_bit_keys

_JAX_APPLY = JServerKey.apply_lookup_table


@jax.jit
def _jax_apply_data(sk, data, acc):
    return _JAX_APPLY(sk, JCt(lwe=JLwe(data=data)), JLut(acc=JGlwe(data=acc))).lwe.data


def _jitted_apply(self, ct, lut):
    return ct.with_(lwe=JLwe(data=_jax_apply_data(self, ct.lwe.data, lut.acc.data)),
                    degree=lut.degree, noise_level=JNoiseLevel.NOMINAL)


def _servers(kind):
    """(JAX ServerKey, port ServerKey, the big key bits, params) on one key."""
    if kind == "classic":
        k = real_keys(P, seed=31)
        jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, 4))(
            jnp.asarray(k["bsk"]))
        tbsk = interop.bootstrap_key_from_standard(k["bsk"], P.pbs_decomp, 4, device="cpu")
        tp, jp = P, JP
    else:
        tp, jp = multi_bit_params(MultiBitPBSParameters, P, 2, 16), \
            multi_bit_params(JMultiBit, JP, 2, 16)
        k = real_multi_bit_keys(tp, seed=32)
        jbsk = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, 2, 64))(jnp.asarray(k["bsk"]))
        tbsk = interop.multi_bit_bootstrap_key_from_standard(k["bsk"], tp.pbs_decomp, 2, 4,
                                                             device="cpu")
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=JP.ks_decomp), bsk=jbsk,
                     params=jp)
    tsk = shortint.ServerKey(ksk=interop.keyswitch_key(k["ksk"], tp.ks_decomp, device="cpu"),
                             bsk=tbsk, params=tp)
    return jsk, tsk, k["big_bits"], tp


MSGS = {"a": ([0, 1, 2, 3, 3, 2, 1, 0], 3), "b": ([1, 3, 0, 2, 3, 1, 2, 0], 3),
        "cond": ([1, 0, 1, 0, 0, 1, 1, 0], 1)}


@pytest.fixture(scope="module", params=["classic", "multibit"])
def sides(request):
    """Both packages' servers and operands: a, b (degree 3), cond (a boolean,
    degree 1), and from each package's own linear ops wide = a + b (degree
    6, noise 2), full = 5a (degree 15, noise 5), x3 = 3 cond (degree 3,
    noise 3)."""
    jsk, tsk, big_bits, tp = _servers(request.param)
    jx, tx = {}, {}
    for i, (name, (msgs, degree)) in enumerate(MSGS.items()):
        data = encrypt_big(tp, big_bits, np.array(msgs), seed=60 + i)
        jx[name] = JCt(lwe=JLwe(data=jnp.asarray(data)), degree=degree)
        tx[name] = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)),
                                       degree=degree)
    for sk, x in ((jsk, jx), (tsk, tx)):
        x["wide"] = sk.unchecked_add(x["a"], x["b"])
        x["full"] = sk.unchecked_scalar_mul(x["a"], 5)
        x["x3"] = sk.unchecked_scalar_mul(x["cond"], 3)
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JServerKey, "apply_lookup_table", _jitted_apply)
        yield dict(jax=(jsk, jx), port=(tsk, tx))
    config.set_use_pallas_pbs(old[0])
    config.set_pallas_interpret(old[1])


def _bivariate_with_factor(s, x):
    """a * 2 + cond through the factor-2 packing and its LUT."""
    lut = s.generate_lookup_table_bivariate_with_factor(lambda u, v: (u + 3 * v) % 4, 2)
    return s.apply_lookup_table(s.unchecked_bivariate_pack_with_factor(x["a"], x["cond"], 2),
                                lut)


# name → op(server, operands); every name mentioned is run on both packages
OPS = {
    "carry_extract(wide)": lambda s, x: s.carry_extract(x["wide"]),
    "message_extract(wide)": lambda s, x: s.message_extract(x["wide"]),
    "evaluate_msg_univariate": lambda s, x: s.evaluate_msg_univariate(x["a"],
                                                                      lambda v: v * v + 1),
    "bivariate_with_factor": _bivariate_with_factor,
    "unchecked_add": lambda s, x: s.unchecked_add(x["a"], x["b"]),
    "checked_add": lambda s, x: s.checked_add(x["wide"], x["wide"]),
    "checked_add carry full": lambda s, x: s.checked_add(x["full"], x["a"]),
    "checked_add noise too big": lambda s, x: s.checked_add(x["x3"], x["x3"]),
    "smart_add": lambda s, x: s.smart_add(x["wide"], x["wide"]),
    "smart_add extracts": lambda s, x: s.smart_add(x["full"], x["a"]),
    "add": lambda s, x: s.add(x["a"], x["b"]),
    "unchecked_neg": lambda s, x: s.unchecked_neg(x["a"]),
    "smart_neg": lambda s, x: s.smart_neg(x["wide"]),
    "smart_neg extracts": lambda s, x: s.smart_neg(x["full"]),
    "neg": lambda s, x: s.neg(x["a"]),
    "unchecked_sub": lambda s, x: s.unchecked_sub(x["a"], x["b"]),
    "smart_sub": lambda s, x: s.smart_sub(x["wide"], x["b"]),
    "smart_sub extracts": lambda s, x: s.smart_sub(x["full"], x["wide"]),
    "sub": lambda s, x: s.sub(x["a"], x["b"]),
    "unchecked_neg_with_correcting_term": lambda s, x: s.unchecked_neg_with_correcting_term(
        x["wide"]),
    "unchecked_sub_with_correcting_term": lambda s, x: s.unchecked_sub_with_correcting_term(
        x["a"], x["b"]),
    "smart_sub_with_correcting_term": lambda s, x: s.smart_sub_with_correcting_term(
        x["full"], x["wide"]),
    "unchecked_scalar_add": lambda s, x: s.unchecked_scalar_add(x["a"], 2),
    "smart_scalar_add extracts": lambda s, x: s.smart_scalar_add(x["full"], 3),
    "scalar_add": lambda s, x: s.scalar_add(x["a"], 5),
    "unchecked_scalar_mul": lambda s, x: s.unchecked_scalar_mul(x["a"], 3),
    "smart_scalar_mul extracts": lambda s, x: s.smart_scalar_mul(x["wide"], 3),
    "smart_scalar_mul by LUT": lambda s, x: s.smart_scalar_mul(x["a"], 7),
    "scalar_mul": lambda s, x: s.scalar_mul(x["a"], 3),
    "scalar_sub": lambda s, x: s.scalar_sub(x["a"], 1),
    "scalar_div": lambda s, x: s.scalar_div(x["a"], 2),
    "scalar_mod": lambda s, x: s.scalar_mod(x["a"], 3),
    "unchecked_scalar_div by zero": lambda s, x: s.unchecked_scalar_div(x["a"], 0),
    "unchecked_scalar_mod": lambda s, x: s.unchecked_scalar_mod(x["wide"], 3),
    "mul": lambda s, x: s.mul(x["a"], x["b"]),
    "unchecked_mul_msb(wide)": lambda s, x: s.unchecked_mul_msb(x["wide"], x["b"]),
    "checked_mul_lsb": lambda s, x: s.checked_mul_lsb(x["a"], x["b"]),
    "checked_mul_lsb carry full": lambda s, x: s.checked_mul_lsb(x["wide"], x["b"]),
    "checked_mul_msb": lambda s, x: s.checked_mul_msb(x["a"], x["b"]),
    "unchecked_mul_lsb_small_carry": lambda s, x: s.unchecked_mul_lsb_small_carry(x["a"],
                                                                                  x["b"]),
    "checked_mul_lsb_with_small_carry full": lambda s, x: (
        s.checked_mul_lsb_with_small_carry(x["full"], x["b"])),
    "div": lambda s, x: s.div(x["a"], x["b"]),
    "unchecked_div": lambda s, x: s.unchecked_div(x["a"], x["b"]),
    "bitand": lambda s, x: s.bitand(x["a"], x["b"]),
    "bitor(wide)": lambda s, x: s.bitor(x["wide"], x["b"]),
    "bitxor": lambda s, x: s.bitxor(x["a"], x["b"]),
    "unchecked_bitand": lambda s, x: s.unchecked_bitand(x["a"], x["b"]),
    "unchecked_bitor": lambda s, x: s.unchecked_bitor(x["a"], x["b"]),
    "unchecked_bitxor": lambda s, x: s.unchecked_bitxor(x["a"], x["b"]),
    "checked_bitand carry full": lambda s, x: s.checked_bitand(x["wide"], x["b"]),
    "checked_bitxor": lambda s, x: s.checked_bitxor(x["a"], x["b"]),
    "scalar_bitand": lambda s, x: s.scalar_bitand(x["a"], 2),
    "scalar_bitor": lambda s, x: s.scalar_bitor(x["a"], 1),
    "scalar_bitxor": lambda s, x: s.scalar_bitxor(x["a"], 3),
    "equal": lambda s, x: s.equal(x["a"], x["b"]),
    "not_equal": lambda s, x: s.not_equal(x["a"], x["b"]),
    "greater(wide)": lambda s, x: s.greater(x["wide"], x["b"]),
    "greater_or_equal": lambda s, x: s.greater_or_equal(x["a"], x["b"]),
    "less": lambda s, x: s.less(x["a"], x["b"]),
    "less_or_equal": lambda s, x: s.less_or_equal(x["a"], x["b"]),
    "unchecked_greater": lambda s, x: s.unchecked_greater(x["a"], x["b"]),
    "unchecked_less_or_equal": lambda s, x: s.unchecked_less_or_equal(x["a"], x["b"]),
    "checked_equal": lambda s, x: s.checked_equal(x["a"], x["b"]),
    "checked_less carry full": lambda s, x: s.checked_less(x["wide"], x["b"]),
    "scalar_equal": lambda s, x: s.scalar_equal(x["a"], 2),
    "scalar_not_equal": lambda s, x: s.scalar_not_equal(x["a"], 2),
    "scalar_greater": lambda s, x: s.scalar_greater(x["a"], 1),
    "scalar_greater_or_equal": lambda s, x: s.scalar_greater_or_equal(x["a"], 1),
    "scalar_less": lambda s, x: s.scalar_less(x["a"], 2),
    "scalar_less_or_equal": lambda s, x: s.scalar_less_or_equal(x["a"], 2),
    "scalar_left_shift": lambda s, x: s.scalar_left_shift(x["a"], 1),
    "scalar_right_shift": lambda s, x: s.scalar_right_shift(x["a"], 1),
    "unchecked_scalar_left_shift": lambda s, x: s.unchecked_scalar_left_shift(x["a"], 2),
    "checked_scalar_left_shift overflow": lambda s, x: s.checked_scalar_left_shift(x["wide"],
                                                                                   2),
    "smart_scalar_left_shift extracts": lambda s, x: s.smart_scalar_left_shift(x["wide"], 2),
    "smart_scalar_left_shift by LUT": lambda s, x: s.smart_scalar_left_shift(x["a"], 3),
    "unchecked_scalar_right_shift": lambda s, x: s.unchecked_scalar_right_shift(x["wide"], 1),
    "cmux": lambda s, x: s.cmux(x["cond"], x["a"], x["b"]),
    "create_trivial": lambda s, x: s.create_trivial(MSGS["a"][0]),
    "unchecked_create_trivial": lambda s, x: s.unchecked_create_trivial([5, 9, 15, 0]),
}

# cases in which both packages must raise (the error's class name is compared)
RAISES = {"checked_add carry full", "checked_add noise too big",
          "unchecked_scalar_div by zero", "checked_mul_lsb carry full",
          "checked_mul_lsb_with_small_carry full", "checked_bitand carry full",
          "checked_less carry full", "checked_scalar_left_shift overflow"}


def _run(side, op):
    sk, x = side
    try:
        return op(sk, x)
    except (ValueError, ZeroDivisionError) as e:
        return type(e)


def _assert_same(t, j):
    if isinstance(t, tuple):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_same(a, b)
    elif isinstance(t, type):                 # the class each package raised
        assert t.__name__ == j.__name__
    elif isinstance(t, int):                  # a correcting term
        assert t == j
    else:
        np.testing.assert_array_equal(to_numpy_u64(t.lwe.data), np.asarray(j.lwe.data))
        assert (t.degree, t.noise_level, t.message_modulus, t.carry_modulus) == \
            (j.degree, j.noise_level, j.message_modulus, j.carry_modulus)


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax(sides, name):
    t, j = _run(sides["port"], OPS[name]), _run(sides["jax"], OPS[name])
    _assert_same(t, j)
    assert isinstance(t, type) == (name in RAISES)
    assert t is CheckError or "carry full" not in name     # the port's own class


PREDICATES = ["is_add_possible", "is_sub_possible", "is_bivariate_pbs_possible",
              "is_mul_possible", "is_mul_small_carry_possible"]
UNARY_PREDICATES = {"is_neg_possible": (), "is_scalar_add_possible": (7,),
                    "is_scalar_sub_possible": (2,), "is_scalar_mul_possible": (3,),
                    "is_scalar_left_shift_possible": (2,)}


@pytest.mark.parametrize("name", PREDICATES + list(UNARY_PREDICATES))
def test_precondition_matches_jax(sides, name):
    (tsk, tx), (jsk, jx) = sides["port"], sides["jax"]
    names = sorted(tx)
    for u in names:
        if name in UNARY_PREDICATES:
            args = UNARY_PREDICATES[name]
            assert getattr(tsk, name)(tx[u], *args) == getattr(jsk, name)(jx[u], *args), u
            continue
        for v in names:
            assert getattr(tsk, name)(tx[u], tx[v]) == getattr(jsk, name)(jx[u], jx[v]), (u, v)
    assert tsk.max_noise_level == shortint.ciphertext.MaxNoiseLevel(jsk.max_noise_level.value)
    assert tsk.max_degree == jsk.max_degree
