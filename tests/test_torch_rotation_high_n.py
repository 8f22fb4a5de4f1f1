"""The port's plain blind rotation at N = 16384 bit-exact against tfhe_tpu
`blind_rotate_fused(..., mode="delta")` in interpret mode: the high-N
prime pool (`PRIMES_HIGH_N`, hazard C2) and, on the JAX side, the factored
phase stack that the fused kernel takes at N >= 16384.  One step, one
ciphertext, L = 2 (base log 15, as 3_3 and 4_4), 4 primes: the shapes that
the port's staged kernel (K6) serves on the card."""
import jax
import jax.numpy as jnp
import numpy as np

from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu.core.poly.pallas_ntt import blind_rotate_fused as jax_rotate
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation

U64 = np.uint64
N, R, L, BASE_LOG, STEPS = 16384, 2, 2, 15, 1


def test_plain_rotation_matches_jax_at_n_16384():
    decomp = DecompParams(base_log=BASE_LOG, level=L)
    P = external_product_num_primes(N, R, decomp)
    assert P == 4
    rng = np.random.default_rng(16384)
    std = rng.integers(0, 2 ** 64, (STEPS, L, R, R, N), dtype=U64)
    lwe = rng.integers(0, 2 ** 64, (1, STEPS + 1), dtype=U64)
    lut = rng.integers(0, 2 ** 64, (R, N), dtype=U64)
    lut[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]

    jdecomp = JDecomp(base_log=BASE_LOG, level=L)
    jkey = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=jdecomp), 64, P))(
        jnp.asarray(std))
    ref = np.asarray(jax.jit(lambda lt, lw, k, sh: jax_rotate(
        lt, lw, k, sh, None, None, jdecomp, block_b=8, interpret=True, mode="delta"))(
            jnp.asarray(lut), jnp.asarray(lwe), jkey.paired, jkey.paired_shoup))

    key = interop.bootstrap_key_from_standard(std, decomp, P, device="cpu")
    assert key.primes == ntt.PRIMES_HIGH_N[:P]
    assert rotation._rotation_route(N, R, L * R, P) == "staged"
    out = rotation.blind_rotate_fused(from_numpy_u64(lut), from_numpy_u64(lwe), key)
    np.testing.assert_array_equal(to_numpy_u64(out), ref)
