"""Randomness for keys, masks and noise from explicit `torch.Generator`s.

Counterpart of `tfhe_tpu/core/rng.py`.  The JAX package derives substreams
with threefry `fold_in`; here `generator(seed, *stream, device=...)` seeds a
fresh torch generator from (seed, stream) through numpy's SeedSequence, so
every substream is reproducible on its own.  The bits differ from the JAX
package's (and between CPU and CUDA generators): tests feed both packages
the same numpy-made randomness, and hold the port's own noise
statistically.  Like the JAX package's threefry, torch's generators are not
a vetted CSPRNG.
"""
from __future__ import annotations

import numpy as np
import torch

from .numeric import LOG_Q, check_log_q, float_round_to_torus, lift32


def generator(seed: int, *stream: int, device) -> torch.Generator:
    """A generator on `device` (no default: a caller names the CPU or the
    card) seeded from (seed, *stream)."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, *stream]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def uniform_torus(gen: torch.Generator, shape, device=None, log_q: int = LOG_Q) -> torch.Tensor:
    """Uniform torus elements: at 64 bits two 32-bit draws joined (randint
    cannot span 2^64), at 32 bits one draw, lifted."""
    device = gen.device if device is None else device
    if check_log_q(log_q) == 32:
        return lift32(torch.randint(0, 1 << 32, tuple(shape), generator=gen,
                                    dtype=torch.int64, device=device))
    hi_lo = torch.randint(0, 1 << 32, (2,) + tuple(shape), generator=gen,
                          dtype=torch.int64, device=device)
    return (hi_lo[0] << 32) | hi_lo[1]


def binary_key(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform binary secret key bits (int64 0/1)."""
    device = gen.device if device is None else device
    return torch.randint(0, 2, tuple(shape), generator=gen, dtype=torch.int64,
                         device=device)


def gaussian_noise(gen: torch.Generator, shape, std: float,
                   device=None, log_q: int = LOG_Q) -> torch.Tensor:
    """Rounded gaussian on the torus with absolute std-dev `std` (in units
    of the 2^log_q torus's least word), sampled in float64; at 32 bits
    rounded to a 32-bit word, then lifted."""
    device = gen.device if device is None else device
    if std == 0.0:
        return torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    n = torch.randn(tuple(shape), generator=gen, dtype=torch.float64,
                    device=device)
    noise = float_round_to_torus(n * std)
    return noise if check_log_q(log_q) == 64 else lift32(noise)
