"""Ciphertext and key containers: plain dataclasses around int64 tensors.

Counterpart of `tfhe_tpu/core/entities.py`, with the same layouts (leading
axes are free batch axes; torus values are int64 bit patterns of u64):

  LweCiphertext.data      [..., n+1]             mask a_0..a_{n-1}, body last
  GlweCiphertext.data     [..., k+1, N]          k mask polys, then the body
  LweKeyswitchKey.data    [n_in, l, n_out+1]
  LweBootstrapKey.data    [n, l, k+1, k+1, N]    one GGSW per input key bit
  NttBootstrapKey.spectra [n, P, l*(k+1), k+1, N] the port's own spectra

Nothing here is trained, so there is no nn.Module.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .params import DecompParams


@dataclass(frozen=True)
class LweCiphertext:
    """(a, b) with b = <a, s> + m + e; data [..., n+1], body last."""

    data: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.data[..., :-1]

    @property
    def body(self) -> torch.Tensor:
        return self.data[..., -1]


@dataclass(frozen=True)
class LweSecretKey:
    """Binary key bits, int64 [n]."""

    bits: torch.Tensor

    @property
    def lwe_dimension(self) -> int:
        return self.bits.shape[-1]


@dataclass(frozen=True)
class GlweCiphertext:
    """data [..., k+1, N]: k uniform mask polynomials, then the body."""

    data: torch.Tensor

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        return self.data[..., :-1, :]

    @property
    def body(self) -> torch.Tensor:
        return self.data[..., -1, :]


@dataclass(frozen=True)
class GlweSecretKey:
    """k binary polynomials, int64 [k, N].  Flattened row-major it is the
    'big' LWE key of dimension k*N."""

    bits: torch.Tensor

    @property
    def glwe_dimension(self) -> int:
        return self.bits.shape[-2]

    @property
    def polynomial_size(self) -> int:
        return self.bits.shape[-1]

    def as_lwe_secret_key(self) -> LweSecretKey:
        return LweSecretKey(bits=self.bits.reshape(-1))


@dataclass(frozen=True)
class LweKeyswitchKey:
    """data [n_in, l, n_out+1]: LWE encryptions of s_in[i] * q/B^(l+1)."""

    data: torch.Tensor
    decomp: DecompParams


@dataclass(frozen=True)
class LweBootstrapKey:
    """Standard (coefficient-domain) BSK, data [n, l, k+1, k+1, N]."""

    data: torch.Tensor
    decomp: DecompParams


@dataclass(frozen=True)
class NttBootstrapKey:
    """The BSK in the port's spectral form, read by the blind rotation.

    spectra [n, P, J, R, N] int32 residues (< p < 2^30) of the GGSW(s_i)
    polynomials: J = l*(k+1) is the (level, input row) contraction axis,
    level-major; R = k+1 the output component.  `order` names the spectral
    order ("ct-bitrev": the Cooley-Tukey forward transform of
    `poly/ntt.py`, slot k at psi^(2 brv(k) + 1)), and `primes` the CRT
    primes, the first P of `primes_for(N)`.  Counterpart of the JAX
    `NttLweBootstrapKey` (whose `paired_order` records its own order)."""

    spectra: torch.Tensor
    decomp: DecompParams
    primes: tuple
    order: str = "ct-bitrev"

    @property
    def polynomial_size(self) -> int:
        return self.spectra.shape[4]
