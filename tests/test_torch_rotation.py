"""The port's blind rotation (K1's plain path on CPU) bit-exact against
tfhe_tpu `blind_rotate_fused(..., mode="delta")` in interpret mode, at
TEST_PARAMS_SHORTINT, with keys carried across both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly.pallas_ntt import blind_rotate_fused as jax_rotate
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.entities import NttBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import ntt, rotation
from torch_keys import int_external_product, int_monomial, int_polymul, random_bsk

U64 = np.uint64
N, R = P.polynomial_size, P.glwe_size


@pytest.fixture(scope="module")
def keys():
    std = random_bsk(P, 21)
    jkey = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, 4))(
        jnp.asarray(std))
    assert jkey.paired_order == "fourstep"
    npr = external_product_num_primes(N, R, P.pbs_decomp)
    assert npr == 4
    from_std = interop.bootstrap_key_from_standard(std, P.pbs_decomp, npr, device="cpu")
    from_dif = interop.bootstrap_key_from_dif(np.asarray(jkey.data),
                                              ntt.primes_for(N)[:npr], P.pbs_decomp,
                                              device="cpu")
    return dict(std=std, jkey=jkey, from_std=from_std, from_dif=from_dif)


_jax_rotate = jax.jit(lambda lut, lwe, bsk, sh: jax_rotate(
    lut, lwe, bsk, sh, None, None, JP.pbs_decomp, block_b=8, interpret=True,
    mode="delta"))


def _inputs(batch, per_element, seed):
    rng = np.random.default_rng(seed)
    lwe = rng.integers(0, 2 ** 64, (batch, P.lwe_dimension + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut_shape = (batch, R, N) if per_element else (R, N)
    return lwe, rng.integers(0, 2 ** 64, lut_shape, dtype=U64)


@pytest.mark.parametrize("batch,per_element", [(8, False), (6, True), (3, False)])
def test_rotation_matches_jax(keys, batch, per_element):
    lwe, lut = _inputs(batch, per_element, seed=batch)
    ref = np.asarray(_jax_rotate(jnp.asarray(lut), jnp.asarray(lwe),
                                 keys["jkey"].paired, keys["jkey"].paired_shoup))
    before = rotation.launches
    for route in ("from_std", "from_dif"):
        out = rotation.blind_rotate_fused(from_numpy_u64(lut), from_numpy_u64(lwe),
                                          keys[route])
        assert out.shape == (batch, R, N)
        np.testing.assert_array_equal(to_numpy_u64(out), ref, err_msg=route)
    assert rotation.launches == before       # CPU tensors take the plain path


def test_key_routes_agree(keys):
    np.testing.assert_array_equal(keys["from_std"].spectra.numpy(),
                                  keys["from_dif"].spectra.numpy())
    std = interop.standard_from_dif(np.asarray(keys["jkey"].data), ntt.primes_for(N)[:4])
    np.testing.assert_array_equal(std, keys["std"].reshape(std.shape))


def test_dif_conversion_checks_primes(keys):
    with pytest.raises(ValueError, match="primes"):
        interop.bootstrap_key_from_dif(np.asarray(keys["jkey"].data),
                                       ntt.PRIMES_HIGH_N[:4], P.pbs_decomp, device="cpu")


def _naive_step(acc, e, ggsw, decomp):
    """One delta step in Python integers: acc + (X^e - 1) * sum_{l,r}
    decomp_l(acc_r) * ggsw[l, r] mod (X^N + 1, 2^64)."""
    n = len(acc[0])
    total = int_external_product(acc, ggsw, decomp)
    mono = int_monomial(e, n)
    mono[0] -= 1
    return [[(a + v) % 2 ** 64 for a, v in zip(acc[c], int_polymul(mono, total[c]))]
            for c in range(len(acc))]


def test_plain_rotation_is_the_step_formula():
    """K1's contract, checked in Python integers at n=3, N=16, L=2."""
    n_poly, steps = 16, 3
    decomp = DecompParams(base_log=7, level=2)
    rng = np.random.default_rng(9)
    std = rng.integers(0, 2 ** 64, (steps, 2, R, R, n_poly), dtype=U64)
    key = interop.bootstrap_key_from_standard(std, decomp, 4, device="cpu")
    acc = rng.integers(0, 2 ** 64, (2, R, n_poly), dtype=U64)
    exps = np.array([[0, 5, 31], [16, 1, 17]])
    out = rotation.rotate_accumulator(from_numpy_u64(acc), torch.from_numpy(exps), key)
    for b in range(2):
        ref = [[int(x) for x in row] for row in acc[b]]
        for j in range(steps):
            ggsw = [[[[int(x) for x in std[j, l, r, c]] for c in range(R)]
                     for r in range(R)] for l in range(2)]
            ref = _naive_step(ref, int(exps[b, j]), ggsw, decomp)
        np.testing.assert_array_equal(to_numpy_u64(out[b]), np.array(ref, dtype=U64))


def test_rotation_wrapper_refuses_other_devices(keys):
    acc = torch.zeros((1, R, N), dtype=torch.int64, device="meta")
    exps = torch.zeros((1, P.lwe_dimension), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rotation.rotate_accumulator(acc, exps, keys["from_std"])
    assert isinstance(keys["from_std"], NttBootstrapKey)
