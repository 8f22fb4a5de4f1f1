"""The port's keyswitch (K2's plain path on CPU) bit-exact against
tfhe_tpu keyswitch_lwe at TEST_PARAMS_SHORTINT, batch 8."""
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

U64 = np.uint64


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
    before = keyswitch.launches
    out = keyswitch.keyswitch_lwe(LweCiphertext(data=from_numpy_u64(ct)), ksk)
    assert keyswitch.launches == before       # CPU tensors take the plain path
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
    d = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    k = torch.zeros((4, 3), dtype=torch.int64, device="meta")
    b = torch.zeros((2,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        keyswitch.neg_digit_mac(d, k, b)
