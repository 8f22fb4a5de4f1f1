"""int64 torus helpers, signed decomposition and modulus switch of
tfhe_tpu_torch, bit-exact against tfhe_tpu on u64 values with the top bit
set (hazard C1: int64 shifts are arithmetic, compares signed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.params as jp
from tfhe_tpu.core.algorithms.bootstrap import modulus_switch as jax_modulus_switch
from tfhe_tpu.core.decomposition import signed_decompose as jax_decompose
from tfhe_tpu_torch.core.decomposition import signed_decompose
from tfhe_tpu_torch.core.numeric import (as_i64, from_numpy_u64, shr, to_numpy_u64,
                                         udiv, uge, ult)
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly.rotation import modulus_switch

U64 = np.uint64


def _values(seed=0, count=512):
    """Random u64 values plus the edges: 0, 1, near 2^63 and near 2^64."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1,
                      2 ** 64 - 2, 2 ** 64 - 2 ** 40, 2 ** 62, 3 << 62],
                     dtype=U64)
    return np.concatenate([edges, rng.integers(0, 2 ** 64, count, dtype=U64)])


def _decomp_pairs():
    pairs = set()
    for p in list(jp.ALL_NAMED_PARAMS.values()) + [jp.TEST_PARAMS_SHORTINT,
                                                   jp.TEST_PARAMS_WOPBS]:
        for attr in ("pbs_decomp", "ks_decomp", "pfks_decomp", "cbs_decomp"):
            if hasattr(p, attr):
                d = getattr(p, attr)
                pairs.add((d.base_log, d.level))
    return sorted(pairs)


def test_numpy_round_trip_keeps_bits():
    v = _values()
    assert np.array_equal(to_numpy_u64(from_numpy_u64(v)), v)


@pytest.mark.parametrize("s", [1, 3, 23, 41, 52, 63])
def test_shr_is_logical(s):
    v = _values(1)
    assert np.array_equal(to_numpy_u64(shr(from_numpy_u64(v), s)), v >> U64(s))


def test_unsigned_compares():
    a, b = _values(2), _values(3)
    ta, tb = from_numpy_u64(a), from_numpy_u64(b)
    assert np.array_equal(ult(ta, tb).numpy(), a < b)
    assert np.array_equal(uge(ta, tb).numpy(), a >= b)


@pytest.mark.parametrize("d", [1, 3, 7, 2 ** 59, 2 ** 63, 2 ** 63 + 5, 2 ** 64 - 1,
                               (1 << 64) // 32, (1 << 64) // 12])
def test_udiv(d):
    v = _values(4)
    assert np.array_equal(to_numpy_u64(udiv(from_numpy_u64(v), d)), v // U64(d))


def test_as_i64():
    for x in (0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, 2 ** 64 + 3):
        assert np.int64(as_i64(x)).view(U64) == U64(x % 2 ** 64)


@pytest.mark.parametrize("base_log,level", _decomp_pairs())
def test_signed_decompose_matches_jax(base_log, level):
    v = _values(base_log * 100 + level)
    d = DecompParams(base_log, level)
    ours = signed_decompose(from_numpy_u64(v), d).numpy()
    ref = np.asarray(jax.jit(jax_decompose, static_argnums=(1, 2))(
        jnp.asarray(v), jp.DecompParams(base_log, level), 64))
    assert ours.dtype == np.int64 and ref.dtype == np.int64
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 8192, 32768])
def test_modulus_switch_matches_jax(n):
    v = _values(n)
    ours = modulus_switch(from_numpy_u64(v), n).numpy()
    ref = np.asarray(jax.jit(jax_modulus_switch, static_argnums=(1, 2))(
        jnp.asarray(v), 64, n))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))
    assert ours.min() >= 0 and ours.max() <= 2 * n


def test_signed_decompose_recomposes():
    """sum_l d_l * q/B^(l+1) equals x rounded to the top B*L bits."""
    v = _values(5)
    d = DecompParams(3, 5)
    digits = signed_decompose(from_numpy_u64(v), d)
    w = torch.tensor([1 << (64 - 3 * (l + 1)) for l in range(5)], dtype=torch.int64)
    rec = to_numpy_u64((digits * w).sum(-1))
    shift = U64(64 - 15)
    rounded = ((v + (U64(1) << (shift - U64(1)))) >> shift) << shift
    np.testing.assert_array_equal(rec, rounded)
    assert digits.abs().max() <= 4
