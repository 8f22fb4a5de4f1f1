"""The port's plain CRT-NTT against tfhe_tpu: negacyclic products bit-exact,
JAX DIF spectra inverted exactly, and the high-N prime pool (hazard C2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.poly import ntt as jntt
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.poly import monomial_mul, ntt

U64 = np.uint64


def _u64(rng, shape):
    return rng.integers(0, 2 ** 64, shape, dtype=U64)


def test_prime_pools_match_jax():
    assert ntt.PRIMES_31 == jntt.PRIMES_31
    assert ntt.PRIMES_HIGH_N == jntt.PRIMES_HIGH_N
    for n in (256, 2048, 8192, 16384, 32768, 65536):
        assert ntt.primes_for(n) == jntt.primes_for(n)
    for bound in (75.0, 97.0, 139.0):
        assert ntt.required_num_primes(bound, 2048) == jntt.required_num_primes(bound)


def _pbs_sets():
    import tfhe_tpu_torch.core.params as tp
    return sorted(name for name, p in tp.ALL_NAMED_PARAMS.items() if hasattr(p, "pbs_level"))


def test_prime_count_sized_on_the_sets_own_pool():
    """ROADMAP C2b: the port sizes the CRT width over primes_for(N), the JAX
    package over PRIMES_31 whatever N.  Every named set with a PBS (240)
    gets the same count from both, so the two packages' keys agree."""
    import tfhe_tpu.core.params as jp
    import tfhe_tpu_torch.core.params as tp
    from tfhe_tpu.core.algorithms.bootstrap import external_product_num_primes as jcount
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes as tcount
    names = _pbs_sets()
    assert len(names) == 240
    high = 0
    for name in names:
        p, q = tp.ALL_NAMED_PARAMS[name], jp.ALL_NAMED_PARAMS[name]
        assert tcount(p.polynomial_size, p.glwe_size, p.pbs_decomp) == \
            jcount(q.polynomial_size, q.glwe_size, q.pbs_decomp, 64), name
        high += p.polynomial_size > 8192
    assert high > 0
    # the pool read is the set's own: five of PRIMES_31's primes meet this
    # bound, five of PRIMES_HIGH_N's (slightly smaller) do not
    bound = sum(np.log2(q) for q in ntt.PRIMES_31[:5]) - 1.0
    assert ntt.required_num_primes(bound, 2048) == jntt.required_num_primes(bound) == 5
    assert ntt.required_num_primes(bound, 32768) == 6


def test_plan_garner_constants_match_jax():
    a, b = ntt.get_plan(2048, 4), jntt.get_plan(2048, 4)
    assert a.primes == tuple(b.primes)
    assert a.garner_inv == b.garner_inv and a.garner_weights == b.garner_weights
    assert a.half_digits == b.half_digits and a.prefix_mod == b.prefix_mod
    assert a.M_mod == b.M_mod


@pytest.mark.parametrize("n", [256, 2048])
def test_negacyclic_polymul_matches_jax(n):
    rng = np.random.default_rng(n)
    a, b = _u64(rng, (2, n)), _u64(rng, (2, n))
    ours = to_numpy_u64(ntt.negacyclic_polymul(from_numpy_u64(a), from_numpy_u64(b)))
    ref = np.asarray(jax.jit(jntt.negacyclic_polymul, static_argnums=2)(
        jnp.asarray(a), jnp.asarray(b), 64))
    np.testing.assert_array_equal(ours, ref)


def test_spectral_slot_order():
    """Slot k of the forward transform evaluates at psi^(2 brv(k) + 1)."""
    plan = ntt.get_plan(256, 4)
    x = torch.zeros(256, dtype=torch.int64)
    x[1] = 1
    spec = ntt.ntt_forward(plan, ntt.reduce(plan, x)).numpy()
    np.testing.assert_array_equal(spec, plan.psi_pow[:, plan.slot_odd])


def test_dif_inverse_inverts_jax_forward():
    n = 256
    plan, jplan = ntt.get_plan(n, 4), jntt.get_plan(n, 4)
    rng = np.random.default_rng(7)
    x = _u64(rng, (3, n))
    spec = np.asarray(jax.jit(lambda v: jntt.ntt_forward(jplan, v))(jnp.asarray(x)))
    res = ntt.dif_inverse(plan, torch.from_numpy(spec.astype(np.int64)))
    np.testing.assert_array_equal(to_numpy_u64(ntt.garner_to_torus(plan, res)), x)


@pytest.mark.parametrize("n", [16384, 32768])
def test_high_n_round_trip(n):
    plan = ntt.get_plan(n, 4)
    assert plan.primes == ntt.PRIMES_HIGH_N[:4]
    for p, psi in zip(plan.primes, plan.psi):
        assert pow(psi, n, p) == p - 1              # psi is a primitive 2N-th root
    rng = np.random.default_rng(n)
    digits = torch.from_numpy(rng.integers(-2 ** 22, 2 ** 22, (2, n)))
    res = ntt.reduce(plan, digits)
    np.testing.assert_array_equal(ntt.ntt_inverse(plan, ntt.ntt_forward(plan, res)), res)
    # the exact product of a torus poly with X^5 is the monomial rotation
    x = from_numpy_u64(_u64(rng, n))
    mono = torch.zeros(n, dtype=torch.int64)
    mono[5] = 1
    got = ntt.negacyclic_polymul(x, mono, log_bound=64 + 1)
    want = monomial_mul(x, torch.tensor(5))
    np.testing.assert_array_equal(to_numpy_u64(got), to_numpy_u64(want))


def test_monomial_mul_matches_jax():
    from tfhe_tpu.core.poly import monomial_mul as jax_monomial_mul
    rng = np.random.default_rng(3)
    poly = _u64(rng, (5, 2, 256))
    t = np.array([0, 1, 255, 256, 511])
    ours = to_numpy_u64(monomial_mul(from_numpy_u64(poly), torch.from_numpy(t)[:, None]))
    ref = np.asarray(jax.jit(jax_monomial_mul)(jnp.asarray(poly), jnp.asarray(t)[:, None]))
    np.testing.assert_array_equal(ours, ref)
