"""Ciphertext and key containers: plain dataclasses around int64 tensors.

Counterpart of `tfhe_tpu/core/entities.py`, with the same layouts (leading
axes are free batch axes; torus values are int64 bit patterns of u64):

  LweCiphertext.data      [..., n+1]             mask a_0..a_{n-1}, body last
  GlweCiphertext.data     [..., k+1, N]          k mask polys, then the body
  GgswCiphertext.data     [..., l, k+1, k+1, N]  level-major rows, each a GLWE
  GswCiphertext.data      [..., l, n+1, n+1]     level-major rows, each an LWE
  LweKeyswitchKey.data    [n_in, l, n_out+1]   (.limbs [n_out+1, 8, Kp] uint8)
  LwePackingKeyswitchKey.data [n_in, l, k+1, N]
  GlweRelinearizationKey.data [pairs, l, k+1, N]
  LweBootstrapKey.data    [n, l, k+1, k+1, N]    one GGSW per input key bit
  NttBootstrapKey.spectra [n, P, l*(k+1), k+1, N] the port's own spectra
                          ([n, 2, P, l*(k+1), k+1, N] in the paired form)
  LweMultiBitBootstrapKey.data [n/g, 2^g, l, k+1, k+1, N]
  NttMultiBitBootstrapKey.spectra [n/g, 2^g, P, l*(k+1), k+1, N]

Nothing here is trained, so there is no nn.Module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .params import DecompParams

ROUTES = ("fused", "steps", "paired", "rotate")


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
class GgswCiphertext:
    """data [..., l, k+1, k+1, N]: level-major; row r of level j encrypts
    -m * s_r * q/B^(j+1), the last row +m * q/B^(j+1)."""

    data: torch.Tensor
    decomp: DecompParams

    @property
    def level_count(self) -> int:
        return self.data.shape[-4]

    @property
    def glwe_size(self) -> int:
        return self.data.shape[-3]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class GswCiphertext:
    """data [..., l, n+1, n+1]: the N = 1 case of a GGSW; row r of level j
    is an LWE of -m * s_r * q/B^(j+1), the last row of +m * q/B^(j+1)."""

    data: torch.Tensor
    decomp: DecompParams

    @property
    def level_count(self) -> int:
        return self.data.shape[-3]

    @property
    def lwe_size(self) -> int:
        return self.data.shape[-2]


@dataclass(frozen=True)
class LweKeyswitchKey:
    """data [n_in, l, n_out+1]: LWE encryptions of s_in[i] * q/B^(l+1).

    limbs: the same words as bytes for the tensor-core keyswitch (K2′),
    [n_out+1, 8, Kp] uint8 with K = n_in*l contiguous (padded with zeros to
    Kp, a multiple of 16): byte j of word [k, m] at [m, j, k].  Built once
    where a key on the card is made or carried in
    (`keyswitch.keyswitch_key`), for the sets that take that form; None
    otherwise.  `data` stays the layout the plain path and interop read."""

    data: torch.Tensor
    decomp: DecompParams
    limbs: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class LwePackingKeyswitchKey:
    """data [n_in, l, k+1, N]: GLWE encryptions of the constant polynomial
    s_in[i] * q/B^(j+1)."""

    data: torch.Tensor
    decomp: DecompParams

    @property
    def input_lwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def glwe_size(self) -> int:
        return self.data.shape[-2]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class GlweRelinearizationKey:
    """For each unordered pair (i <= j) of GLWE key polynomials, in
    row-major order, l GLWE encryptions of s_i*s_j * q/B^(lvl+1): data
    [pairs, l, k+1, N]."""

    data: torch.Tensor
    decomp: DecompParams

    @property
    def glwe_size(self) -> int:
        return self.data.shape[-2]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor


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
    primes, the first P of `primes_for(N)`.

    `route` records the rotation the key was converted for (`config.py`):
    "fused" (the whole rotation in one launch, K1, unless
    `use_fused_rotation()` is off at PBS time), "steps" (one launch per
    step, K4) or "paired" (spectra [n, 2, P, J, R, N] of [GGSW(1 - s_i),
    GGSW(s_i)], one K5 launch per step) or "rotate" (the lifted 32-bit torus:
    the rotate-subtract rotation of `blind_rotate_only`, one K7 launch a
    step, as the JAX package runs that torus on XLA).  Counterpart of the JAX
    `NttLweBootstrapKey`, whose `paired_order` ("fourstep",
    "fourstep-lanes", "dif") records the same choice."""

    spectra: torch.Tensor
    decomp: DecompParams
    primes: tuple
    order: str = "ct-bitrev"
    route: str = "fused"

    def __post_init__(self):
        if self.route not in ROUTES:
            raise ValueError(f"route {self.route!r} is not one of {ROUTES}")
        if self.spectra.ndim != (6 if self.paired else 5):
            raise ValueError(f"a {self.route!r} key has {6 if self.paired else 5}-axis "
                             f"spectra, not {tuple(self.spectra.shape)}")

    @property
    def paired(self) -> bool:
        return self.route == "paired"

    @property
    def polynomial_size(self) -> int:
        return self.spectra.shape[-1]


@dataclass(frozen=True)
class LweMultiBitBootstrapKey:
    """Standard multi-bit BSK, data [n/g, 2^g, l, k+1, k+1, N]: for group j
    and variant v, GGSW_{j,v} encrypts the indicator prod_i (s_i if bit i of
    v else 1 - s_i), the MSB of v standing for the group's first key bit."""

    data: torch.Tensor
    decomp: DecompParams
    grouping_factor: int


@dataclass(frozen=True)
class NttMultiBitBootstrapKey:
    """The multi-bit BSK in the port's spectral form (counterpart of the
    JAX `NttMultiBitBootstrapKey`, tfhe_tpu/core/algorithms/multi_bit.py:46).

    spectra [n/g, 2^g, P, J, R, N] int32 residues, each [P, J, R, N] slice
    laid out as `NttBootstrapKey.spectra[i]`; `order` and `primes` as there.
    No Shoup twins and no phase tables: the kernel builds its own tables.
    `route` is "fused" (K3, unless `use_fused_rotation()` is off at PBS
    time) or "steps" (one K5 launch per step), the counterpart of the JAX
    key's `u32_order`."""

    spectra: torch.Tensor
    decomp: DecompParams
    primes: tuple
    grouping_factor: int
    order: str = "ct-bitrev"
    route: str = "fused"

    def __post_init__(self):
        if self.route not in ("fused", "steps"):
            raise ValueError(f"a multi-bit key's route is 'fused' or 'steps', "
                             f"not {self.route!r}")

    @property
    def polynomial_size(self) -> int:
        return self.spectra.shape[5]

    @property
    def num_groups(self) -> int:
        return self.spectra.shape[0]

    @property
    def input_lwe_dimension(self) -> int:
        return self.num_groups * self.grouping_factor

    @property
    def glwe_size(self) -> int:
        return self.spectra.shape[4]
