"""The port's keyswitch on CPU tensors bit-exact against tfhe_tpu
keyswitch_lwe at TEST_PARAMS_SHORTINT, batch 8; the card path's arithmetic
(int8 digits, the key's byte-limb layout, the limb dots recombined with
wrapping shifts), written in torch, against the same; the wide form's plain
path at a base_log above 8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.algorithms.keyswitch import _neg_digit_mac as jax_neg_digit_mac
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
    return keyswitch.launches, keyswitch.decompose_launches, keyswitch.wide_launches


def jax_keyswitch_of(ct, ksk_data, decomp):
    return np.asarray(jax.jit(lambda c, k: jax_keyswitch(
        JLwe(data=c), JKsk(data=k, decomp=decomp), 64).data)(jnp.asarray(ct),
                                                             jnp.asarray(ksk_data)))


def limb_composition(ct, ksk_data, decomp):
    """The tensor-core form's arithmetic in torch: int8 digits from
    `decompose_digits_plain`, the [M, 8, Kp] byte layout from
    `limb_layout`, the 8 limb dots S_l = sum_k d * byte_l (exact int64
    products), then -sum_l S_l * 2^(8l) mod 2^64 and the body."""
    n_in, levels, M = ksk_data.shape
    c = from_numpy_u64(ct.reshape(-1, n_in + 1))
    digits = keyswitch.decompose_digits_plain(c[:, :-1], decomp)              # [B, Kp] int8
    limbs = keyswitch.limb_layout(from_numpy_u64(ksk_data).reshape(n_in * levels, M))
    assert digits.dtype == torch.int8 and limbs.dtype == torch.uint8
    assert tuple(limbs.shape) == (M, 8, digits.shape[1])
    sums = digits.to(torch.int64) @ limbs.reshape(8 * M, -1).to(torch.int64).T   # [B, 8M]
    weights = torch.tensor([1 << (8 * j) for j in range(8)], dtype=torch.int64)
    words = (sums.reshape(-1, M, 8) * weights).sum(dim=-1)                      # wraps mod 2^64
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
    """Each of the three wrappers: the plain version only for CPU tensors,
    a kernel or an error for any other device."""
    d = torch.zeros((2, 16), dtype=torch.int8, device="meta")
    k = torch.zeros((16, 3), dtype=torch.int64, device="meta")
    limbs = torch.zeros((3, 8, 16), dtype=torch.uint8, device="meta")
    b = torch.zeros((2,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        keyswitch.neg_digit_mac(d.to(torch.int32), k, b)
    with pytest.raises(ValueError):
        keyswitch.neg_digit_mac_tensor_core(d, k, limbs, b)
    with pytest.raises(ValueError):
        keyswitch.decompose_digits(k[:2], P.ks_decomp)


@pytest.mark.parametrize("batch", [(8,), (2, 3)])
def test_the_card_paths_limb_arithmetic_matches_jax(ksk_data, batch):
    rng = np.random.default_rng(40 + sum(batch))
    ct = rng.integers(0, 2 ** 64, batch + (P.big_lwe_dimension + 1,), dtype=U64)
    ct.reshape(-1, ct.shape[-1])[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    assert keyswitch.tensor_core_form(P.big_lwe_dimension * P.ks_level, P.ks_base_log)
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
    """base_log 11 (WOPBS_PARAM_MESSAGE_4_CARRY_4_KS_PBS's): the wide form,
    JAX's u64 form on its side."""
    decomp = DecompParams(base_log=11, level=1)
    assert not keyswitch.tensor_core_form(64, 11)
    rng = np.random.default_rng(11)
    ksk = rng.integers(0, 2 ** 64, (64, 1, 9), dtype=U64)
    ct = rng.integers(0, 2 ** 64, (4, 65), dtype=U64)
    ct[0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]
    before = launch_counts()
    out = keyswitch.keyswitch_lwe(LweCiphertext(data=from_numpy_u64(ct)),
                                  interop.keyswitch_key(ksk, decomp, device="cpu"))
    assert launch_counts() == before
    np.testing.assert_array_equal(to_numpy_u64(out.data), jax_keyswitch_of(ct, ksk, decomp))
