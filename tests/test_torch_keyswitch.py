"""The port's keyswitch on CPU tensors bit-exact against tfhe_tpu
keyswitch_lwe at TEST_PARAMS_SHORTINT, batch 8; the card path's arithmetic
(each digit as its signed byte limbs, the key's byte-limb layout, digit
limb i against key byte slot s - i, the slot dots recombined with wrapping
shifts), written in torch, against the same at b <= 8 and against JAX's
u64 form `_neg_digit_mac_chunked` at b = 11, 17 and 25; the plain path at a
base_log above 8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.algorithms.keyswitch import _neg_digit_mac as jax_neg_digit_mac
from tfhe_tpu.core.algorithms.keyswitch import _neg_digit_mac_chunked as jax_neg_digit_mac_u64
from tfhe_tpu.core.decomposition import signed_decompose as jax_signed_decompose
from tfhe_tpu.core.algorithms.keyswitch import keyswitch_lwe as jax_keyswitch
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import keyswitch
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import DecompParams

U64 = np.uint64


def launch_counts():
    return keyswitch.launches, keyswitch.decompose_launches


def jax_keyswitch_of(ct, ksk_data, decomp):
    return np.asarray(jax.jit(lambda c, k: jax_keyswitch(
        JLwe(data=c), JKsk(data=k, decomp=decomp), 64).data)(jnp.asarray(ct),
                                                             jnp.asarray(ksk_data)))


def limb_composition(ct, ksk_data, decomp):
    """The card's arithmetic in torch: the digits' D signed byte limbs from
    `decompose_digits_plain` ([B, D * Kp] int8), the [M, 8, Kp] byte layout
    from `limb_layout`, the slot dots S_s = sum_i sum_k e_{i,k} *
    byte_{s-i} for s >= i (exact int64 products; slots past 7 dropped),
    then -sum_s S_s * 2^(8s) mod 2^64 and the body."""
    n_in, levels, M = ksk_data.shape
    c = from_numpy_u64(ct.reshape(-1, n_in + 1))
    digits = keyswitch.decompose_digits_plain(c[:, :-1], decomp)
    limbs = keyswitch.limb_layout(from_numpy_u64(ksk_data).reshape(n_in * levels, M))
    D, Kp = keyswitch.digit_limbs(decomp.base_log), limbs.shape[-1]
    assert digits.dtype == torch.int8 and limbs.dtype == torch.uint8
    assert tuple(limbs.shape) == (M, 8, Kp) and digits.shape[1] == D * Kp
    e = digits.reshape(-1, D, Kp).to(torch.int64)
    key_bytes = limbs.to(torch.int64)                                        # [M, 8, Kp]
    sums = torch.zeros((e.shape[0], M, 8), dtype=torch.int64)
    for i in range(D):
        sums[:, :, i:] += torch.einsum("bk,mjk->bmj", e[:, i], key_bytes[:, :8 - i])
    weights = torch.tensor([1 << (8 * j) for j in range(8)], dtype=torch.int64)
    words = (sums * weights).sum(dim=-1)                                     # wraps mod 2^64
    out = -words
    out[:, -1] += c[:, -1]
    return to_numpy_u64(out).reshape(ct.shape[:-1] + (M,))


@pytest.fixture(scope="module")
def ksk_data():
    rng = np.random.default_rng(11)
    return rng.integers(0, 2 ** 64, (P.big_lwe_dimension, P.ks_level,
                                     P.lwe_dimension + 1), dtype=U64)


@pytest.mark.parametrize("batch", [(8,), (2, 3)])
def test_keyswitch_matches_jax(ksk_data, batch):
    rng = np.random.default_rng(sum(batch))
    ct = rng.integers(0, 2 ** 64, batch + (P.big_lwe_dimension + 1,), dtype=U64)
    ct.reshape(-1, ct.shape[-1])[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    ref = jax.jit(lambda c, k: jax_keyswitch(JLwe(data=c), JKsk(data=k, decomp=JP.ks_decomp),
                                              64).data)(jnp.asarray(ct), jnp.asarray(ksk_data))
    ksk = interop.keyswitch_key(ksk_data, P.ks_decomp, device="cpu")
    assert ksk.limbs is None                  # only a key on the card gets the limb layout
    before = launch_counts()
    out = keyswitch.keyswitch_lwe(LweCiphertext(data=from_numpy_u64(ct)), ksk)
    assert launch_counts() == before          # CPU tensors take the plain path
    assert out.data.shape == batch + (P.lwe_dimension + 1,)
    np.testing.assert_array_equal(to_numpy_u64(out.data), np.asarray(ref))


def test_neg_digit_mac_plain_matches_jax_int8_dot():
    """The plain contraction equals the JAX package's int8-limb XLA dot."""
    rng = np.random.default_rng(5)
    K, M, B = 96, 17, 8
    digits = rng.integers(-4, 5, (B, K // 4, 4)).astype(np.int64)
    key = rng.integers(0, 2 ** 64, (K // 4, 4, M), dtype=U64)
    ref = np.asarray(jax.jit(jax_neg_digit_mac, static_argnums=(2, 3))(
        jnp.asarray(digits), jnp.asarray(key), 64, 3))
    body = np.zeros(B, dtype=U64)
    ours = keyswitch.neg_digit_mac_plain(torch.from_numpy(digits.reshape(B, K)),
                                         from_numpy_u64(key.reshape(K, M)),
                                         from_numpy_u64(body))
    np.testing.assert_array_equal(to_numpy_u64(-ours), ref)


def test_keyswitch_kernel_wrapper_refuses_other_devices():
    """Each of the two wrappers: the plain version only for CPU tensors,
    a kernel or an error for any other device."""
    d = torch.zeros((2, 16), dtype=torch.int8, device="meta")
    k = torch.zeros((16, 3), dtype=torch.int64, device="meta")
    limbs = torch.zeros((3, 8, 16), dtype=torch.uint8, device="meta")
    b = torch.zeros((2,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        keyswitch.neg_digit_mac_tensor_core(d, k, limbs, b, 3)
    with pytest.raises(ValueError):
        keyswitch.decompose_digits(k[:2], P.ks_decomp)


@pytest.mark.parametrize("batch", [(8,), (2, 3)])
def test_the_card_paths_limb_arithmetic_matches_jax(ksk_data, batch):
    rng = np.random.default_rng(40 + sum(batch))
    ct = rng.integers(0, 2 ** 64, batch + (P.big_lwe_dimension + 1,), dtype=U64)
    ct.reshape(-1, ct.shape[-1])[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    assert keyswitch.tensor_core_form(P.ks_base_log)
    np.testing.assert_array_equal(limb_composition(ct, ksk_data, P.ks_decomp),
                                  jax_keyswitch_of(ct, ksk_data, JP.ks_decomp))


def test_the_limb_arithmetic_at_b_8_with_a_ragged_depth_matches_jax():
    """b = 8 (digits down to -128), K = 37 * 3 rows padded to 112."""
    decomp = DecompParams(base_log=8, level=3)
    rng = np.random.default_rng(8)
    ksk = rng.integers(0, 2 ** 64, (37, 3, 6), dtype=U64)
    ct = rng.integers(0, 2 ** 64, (5, 38), dtype=U64)
    ct[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    ct[1, :-1] = 2 ** 63 + 2 ** 39        # every top digit -128 with the rounding
    np.testing.assert_array_equal(limb_composition(ct, ksk, decomp),
                                  jax_keyswitch_of(ct, ksk, decomp))


def test_the_wide_forms_plain_path_matches_jax():
    """base_log 11 (WOPBS_PARAM_MESSAGE_4_CARRY_4_KS_PBS's): digits of two
    byte limbs on the card; on CPU tensors the plain path, JAX's u64 form
    on its side."""
    decomp = DecompParams(base_log=11, level=1)
    assert keyswitch.tensor_core_form(11) and keyswitch.digit_limbs(11) == 2
    rng = np.random.default_rng(11)
    ksk = rng.integers(0, 2 ** 64, (64, 1, 9), dtype=U64)
    ct = rng.integers(0, 2 ** 64, (4, 65), dtype=U64)
    ct[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    before = launch_counts()
    out = keyswitch.keyswitch_lwe(LweCiphertext(data=from_numpy_u64(ct)),
                                  interop.keyswitch_key(ksk, decomp, device="cpu"))
    assert launch_counts() == before
    np.testing.assert_array_equal(to_numpy_u64(out.data), jax_keyswitch_of(ct, ksk, decomp))


# (base_log, levels, n_in, M): the WoP-PBS 4_4 set's keyswitch (b = 11), the
# COMPACT_PK sets' (17 x 2, 25 x 1), the private functional keyswitch's
# 15 x 2 and 23 bits, the widest three-limb digit; K ragged
WIDE_DECOMPS = [(11, 1, 37, 9), (17, 2, 29, 6), (25, 1, 41, 5), (15, 2, 19, 4), (23, 2, 13, 3)]


@pytest.mark.parametrize("base_log, levels, n_in, M", WIDE_DECOMPS)
def test_the_limb_arithmetic_of_wide_digits_matches_jax_u64(base_log, levels, n_in, M):
    """Digits of 2, 3 and 4 signed byte limbs against JAX's u64 form on the
    same digits, with the top-bit words and digits at -2^(b-1) and
    2^(b-1) - 1."""
    decomp = DecompParams(base_log=base_log, level=levels)
    rng = np.random.default_rng(base_log)
    ksk = rng.integers(0, 2 ** 64, (n_in, levels, M), dtype=U64)
    ct = rng.integers(0, 2 ** 64, (6, n_in + 1), dtype=U64)
    ct[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    half, shift = 1 << (base_log - 1), 64 - base_log * levels
    ct[1, :4] = [half << shift, (half - 1) << shift, half << (64 - base_log),
                 (half - 1) << (64 - base_log)]
    jd = jax.jit(lambda c: jax_signed_decompose(c, decomp, 64))(jnp.asarray(ct[:, :-1]))
    assert (np.asarray(jd) == -half).any() and (np.asarray(jd) == half - 1).any()
    acc = jax.jit(lambda d, k: jax_neg_digit_mac_u64(d, k, 64))(jd, jnp.asarray(ksk))
    ref = (-np.asarray(acc)).astype(U64)
    ref[:, -1] += ct[:, -1]
    np.testing.assert_array_equal(limb_composition(ct, ksk, decomp), ref)
    np.testing.assert_array_equal(ref, jax_keyswitch_of(ct, ksk, decomp))
