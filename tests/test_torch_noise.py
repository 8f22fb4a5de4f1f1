"""The port's noise held statistically (ROADMAP C10): the phase of encryptions
of zero, drawn from the port's own generators (`core/rng.py`), passes the
gates of tests/test_noise_distribution.py for LWE and for GLWE.  No JAX:
Gaussian noise is never compared bit for bit across packages (hazard C5).

Gates (tolerances as in the JAX package's noise tests): the sample std
within 10% of the asked std; |mean| < 5 std / sqrt(samples); kurtosis in
(2.6, 3.4); zero noise gives a phase exactly zero; one seed gives the same
bits twice.  chip_smoke.py runs the same gates on encryptions made on the
card.
"""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch.core import rng
from tfhe_tpu_torch.core.algorithms import (decrypt_lwe, encrypt_glwe, encrypt_lwe,
                                            generate_glwe_secret_key,
                                            generate_lwe_secret_key)
from tfhe_tpu_torch.core.algorithms.encryption import _glwe_mask_dot_key
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P

SAMPLES = 4096
STD = 2.0 ** 40


def phase_of_zeros(kind: str, std: float, seed: int) -> torch.Tensor:
    """The phases (message 0 + noise) of SAMPLES encryptions of zero, int64:
    LWE at n = 16, or GLWE polynomials at k = 1, N = 256 (16 of them)."""
    if kind == "lwe":
        sk = generate_lwe_secret_key(rng.generator(seed, 0, device="cpu"), P.lwe_dimension)
        ct = encrypt_lwe(rng.generator(seed, 1, device="cpu"), sk,
                         torch.zeros(SAMPLES, dtype=torch.int64), std)
        return decrypt_lwe(ct, sk)
    sk = generate_glwe_secret_key(rng.generator(seed, 0, device="cpu"), P.glwe_dimension,
                                  P.polynomial_size)
    zeros = torch.zeros((SAMPLES // P.polynomial_size, P.polynomial_size),
                        dtype=torch.int64)
    ct = encrypt_glwe(rng.generator(seed, 1, device="cpu"), sk, zeros, std)
    return (ct.body - _glwe_mask_dot_key(ct.mask, sk.bits)).reshape(-1)


def gates(phase: torch.Tensor, std: float) -> dict:
    """The three statistical gates' values for phases drawn at `std`."""
    x = phase.to(torch.float64)
    z = (x - x.mean()) / x.std()
    return {"std_ratio": (x.std() / std).item(), "mean": x.mean().item(),
            "mean_limit": 5 * std / np.sqrt(x.numel()), "kurtosis": (z ** 4).mean().item()}


@pytest.mark.parametrize("kind", ["lwe", "glwe"])
def test_noise_std_within_ten_percent(kind):
    g = gates(phase_of_zeros(kind, STD, seed=91), STD)
    assert abs(g["std_ratio"] - 1.0) < 0.10, g


@pytest.mark.parametrize("kind", ["lwe", "glwe"])
def test_noise_mean_is_zero(kind):
    g = gates(phase_of_zeros(kind, STD, seed=92), STD)
    assert abs(g["mean"]) < g["mean_limit"], g


@pytest.mark.parametrize("kind", ["lwe", "glwe"])
def test_noise_is_gaussian_shaped(kind):
    """The fourth standardised moment of a Gaussian is 3; a uniform draw
    gives 1.8, a rounded-to-zero sampler no spread at all."""
    g = gates(phase_of_zeros(kind, STD, seed=93), STD)
    assert 2.6 < g["kurtosis"] < 3.4, g


@pytest.mark.parametrize("kind", ["lwe", "glwe"])
def test_zero_noise_is_exact(kind):
    assert torch.equal(phase_of_zeros(kind, 0.0, seed=94),
                       torch.zeros(SAMPLES, dtype=torch.int64))


@pytest.mark.parametrize("kind", ["lwe", "glwe"])
def test_one_seed_gives_the_same_bits(kind):
    a, b = phase_of_zeros(kind, 2.0 ** 30, seed=95), phase_of_zeros(kind, 2.0 ** 30, seed=95)
    assert torch.equal(a, b)
    assert not torch.equal(a, phase_of_zeros(kind, 2.0 ** 30, seed=96))
