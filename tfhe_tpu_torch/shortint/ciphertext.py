"""Shortint ciphertext with degree and noise bookkeeping (counterpart of
`tfhe_tpu/shortint/ciphertext.py`)."""
from __future__ import annotations

from dataclasses import dataclass, replace

from ..core.entities import LweCiphertext


class NoiseLevel:
    """NOMINAL after a PBS, ZERO for trivial, grows additively with linear
    ops (reference shortint/ciphertext/mod.rs:64)."""

    ZERO = 0
    NOMINAL = 1


@dataclass(frozen=True)
class Ciphertext:
    """LWE + metadata.  `degree` bounds the value held (carry overflow
    checks); `noise_level` counts accumulated linear operations."""

    lwe: LweCiphertext
    degree: int = 0
    message_modulus: int = 4
    carry_modulus: int = 4
    noise_level: int = NoiseLevel.NOMINAL

    def with_(self, lwe=None, degree=None, noise_level=None) -> "Ciphertext":
        return replace(
            self,
            lwe=self.lwe if lwe is None else lwe,
            degree=self.degree if degree is None else degree,
            noise_level=self.noise_level if noise_level is None else noise_level)
