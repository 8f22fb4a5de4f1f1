"""The port's multi-bit per-step rotation (K5's plain path on CPU) against
tfhe_tpu's `multi_bit_blind_rotate_pallas` in interpret mode with mxu=True
(the per-step MXU kernel, B4) and lanes=True (its lanes layout, B5), at the
multi-bit copies of TEST_PARAMS_SHORTINT (g=2, n=16; g=3, n=18), with the
key carried across both ways.  B6 (mxu=False, the DIF key) is in
test_torch_paired.py.  One JAX call per route, batch 8; the port is held
at batch 8, 6 (per-element LUTs) and 3 (a shared LUT) against slices of it,
tolerance 0 (the arithmetic is exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb_to_ntt
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly.pallas_ntt import multi_bit_blind_rotate_pallas
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import ntt, rotation
from torch_keys import multi_bit_params, random_multi_bit_bsk

U64 = np.uint64
N, R, NPR = P.polynomial_size, P.glwe_size, 4
CASES = {8: (slice(0, 8), True), 6: (slice(2, 8), True), 3: (slice(0, 3), False)}


@pytest.fixture(scope="module", params=[(2, 16), (3, 18)], ids=["g2", "g3"])
def mb(request):
    g, n_in = request.param
    tp = multi_bit_params(MultiBitPBSParameters, P, g, n_in)
    std = random_multi_bit_bsk(tp, 40 + g)
    jkey = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, g, 64))(jnp.asarray(std))
    assert jkey.u32_order == "fourstep"
    rng = np.random.default_rng(30 + g)
    lwe = rng.integers(0, 2 ** 64, (8, n_in + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut = rng.integers(0, 2 ** 64, (8, R, N), dtype=U64)
    lut[1:3] = lut[0]
    keys = (interop.multi_bit_bootstrap_key_from_standard(std, P.pbs_decomp, g, NPR,
                                                          device="cpu"),
            interop.multi_bit_bootstrap_key_from_dif(np.asarray(jkey.data), ntt.primes_for(N)[:NPR],
                                                     P.pbs_decomp, g, device="cpu"))
    return dict(g=g, jkey=jkey, lwe=lwe, lut=lut, keys=keys)


@pytest.mark.parametrize("lanes", [False, True], ids=["B4", "B5"])
def test_multi_bit_steps_match_jax(mb, lanes):
    fn = lambda lt, lw, b, s: multi_bit_blind_rotate_pallas(
        lt, lw, b, s, JP.pbs_decomp, mb["g"], block_b=8, interpret=True, mxu=True, lanes=lanes)
    if not lanes:           # XLA:CPU cannot compile the lanes layout under jit; run it eagerly
        fn = jax.jit(fn)
    ref = np.asarray(fn(jnp.asarray(mb["lut"]), jnp.asarray(mb["lwe"]), mb["jkey"].data_u32,
                        mb["jkey"].shoup_u32))
    before = rotation.step_variant_launches
    for key in mb["keys"]:
        for batch, (rows, per_element) in CASES.items():
            lut = mb["lut"][rows] if per_element else mb["lut"][0]
            out = rotation.multi_bit_blind_rotate_steps(from_numpy_u64(lut),
                                                        from_numpy_u64(mb["lwe"][rows]), key)
            np.testing.assert_array_equal(to_numpy_u64(out), ref[rows], err_msg=f"batch {batch}")
    assert rotation.step_variant_launches == before      # CPU tensors take the plain path
