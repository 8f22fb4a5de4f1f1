"""Shortint ciphertext with degree and noise bookkeeping, and the checks the
server's ops enforce (counterpart of `tfhe_tpu/shortint/ciphertext.py`)."""
from __future__ import annotations

from dataclasses import dataclass, replace

from ..core.algorithms.seeded import SeededLweCiphertext, decompress_lwe
from ..core.entities import LweCiphertext


class CheckError(ValueError):
    """An op's precondition failed (reference `CheckError`,
    shortint/ciphertext/mod.rs): CarryFull (degree overflow) or NoiseTooBig
    (noise level above the parameter set's maximum)."""


class NoiseLevel:
    """NOMINAL after a PBS, ZERO for trivial, grows additively with linear
    ops (reference shortint/ciphertext/mod.rs:64)."""

    ZERO = 0
    NOMINAL = 1
    UNKNOWN = 1 << 30       # the cast's keyswitched value before its shift LUT


class MaxNoiseLevel:
    """The largest noise level a parameter set tolerates (reference
    `MaxNoiseLevel`, shortint/ciphertext/mod.rs:28-60): its p-fail holds for
    a norm2 noise bound of this value, derived from the carry space."""

    def __init__(self, value: int):
        self.value = int(value)

    @classmethod
    def from_msg_carry_modulus(cls, msg_modulus: int,
                               carry_modulus: int) -> "MaxNoiseLevel":
        return cls((carry_modulus * msg_modulus - 1) // (msg_modulus - 1))

    def validate(self, noise_level: int) -> None:
        if noise_level > self.value:
            raise CheckError(
                f"NoiseTooBig: noise level {noise_level} exceeds the "
                f"parameter set's maximum {self.value}")

    def __eq__(self, other):
        return isinstance(other, MaxNoiseLevel) and other.value == self.value

    def __repr__(self):
        return f"MaxNoiseLevel({self.value})"


@dataclass(frozen=True)
class Ciphertext:
    """LWE + metadata.  `degree` bounds the value held (carry overflow
    checks); `noise_level` counts accumulated linear operations."""

    lwe: LweCiphertext
    degree: int = 0
    message_modulus: int = 4
    carry_modulus: int = 4
    noise_level: int = NoiseLevel.NOMINAL

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.lwe.data.shape[:-1])

    @property
    def carry_is_empty(self) -> bool:
        return self.degree < self.message_modulus

    def with_(self, lwe=None, degree=None, noise_level=None) -> "Ciphertext":
        return replace(
            self,
            lwe=self.lwe if lwe is None else lwe,
            degree=self.degree if degree is None else degree,
            noise_level=self.noise_level if noise_level is None else noise_level)


@dataclass(frozen=True)
class CompressedCiphertext:
    """A seeded shortint ciphertext: the body, the 32-bit mask seed and the
    metadata of `Ciphertext`, (n+1)x smaller on the wire (reference
    shortint/ciphertext/mod.rs:471-494; tfhe_tpu
    shortint/ciphertext.py:84-103).  Made by ClientKey.encrypt_compressed;
    `decompress()` replays the mask stream on the body's device (or
    `device`)."""

    ct: SeededLweCiphertext
    degree: int = 0
    message_modulus: int = 4
    carry_modulus: int = 4
    noise_level: int = NoiseLevel.NOMINAL

    def decompress(self, device=None) -> Ciphertext:
        return Ciphertext(lwe=decompress_lwe(self.ct, device), degree=self.degree,
                          message_modulus=self.message_modulus,
                          carry_modulus=self.carry_modulus, noise_level=self.noise_level)
