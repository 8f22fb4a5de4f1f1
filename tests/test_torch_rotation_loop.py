"""The port's blind rotation against the in-kernel step loop of tfhe_tpu's
fused Pallas kernel (`blind_rotate_fused` with TFHE_TPU_ROTATION_LOOP=1,
the `kernel_loop` body: B3) in interpret mode, at TEST_PARAMS_SHORTINT
(n=16, N=256) and its multi-bit copy with g=2.  B3's counterpart on the card
is K1/K3's own step loop; the port's fused and per-step forms must both
match it bit for bit (tolerance 0: the arithmetic is exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb_to_ntt
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly.pallas_ntt import blind_rotate_fused as jax_fused
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import rotation
from torch_keys import multi_bit_params, random_bsk, random_multi_bit_bsk

U64 = np.uint64
N, R, NPR, G = P.polynomial_size, P.glwe_size, 4, 2


def _classic():
    std = random_bsk(P, 21)
    jk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, NPR))(
        jnp.asarray(std))
    port = interop.bootstrap_key_from_standard(std, P.pbs_decomp, NPR, device="cpu")
    return (P.lwe_dimension, (jk.paired, jk.paired_shoup, None, None), port,
            (rotation.blind_rotate_fused, rotation.blind_rotate_steps))


def _multi_bit():
    tp = multi_bit_params(MultiBitPBSParameters, P, G, 16)
    std = random_multi_bit_bsk(tp, 42)
    jk = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, G, 64))(jnp.asarray(std))
    port = interop.multi_bit_bootstrap_key_from_standard(std, P.pbs_decomp, G, NPR,
                                                         device="cpu")
    return (tp.lwe_dimension, (jk.data_u32, jk.shoup_u32, jk.mono, jk.mono_shoup), port,
            (rotation.blind_rotate_fused_multi_bit, rotation.multi_bit_blind_rotate_steps))


@pytest.mark.parametrize("mode", ["delta", "multibit"])
def test_rotation_matches_jax_step_loop(mode, monkeypatch):
    monkeypatch.setenv("TFHE_TPU_ROTATION_LOOP", "1")
    n_in, jax_key, port_key, port_fns = _classic() if mode == "delta" else _multi_bit()
    rng = np.random.default_rng(12)
    lwe = rng.integers(0, 2 ** 64, (8, n_in + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut = rng.integers(0, 2 ** 64, (8, R, N), dtype=U64)
    ref = np.asarray(jax.jit(lambda lt, lw, *k: jax_fused(
        lt, lw, *k, JP.pbs_decomp, block_b=8, interpret=True, mode=mode, grouping=G))(
        jnp.asarray(lut), jnp.asarray(lwe), *jax_key))
    for fn in port_fns:
        out = fn(from_numpy_u64(lut), from_numpy_u64(lwe), port_key)
        np.testing.assert_array_equal(to_numpy_u64(out), ref, err_msg=fn.__name__)
