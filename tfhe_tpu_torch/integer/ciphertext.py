"""Radix, signed radix and CRT ciphertexts over shortint blocks
(counterpart of `tfhe_tpu/integer/ciphertext.py`; reference
integer/ciphertext/mod.rs)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..shortint.ciphertext import Ciphertext as ShortintCiphertext


@dataclass(frozen=True)
class RadixCiphertext:
    """Little-endian list of shortint blocks; value = Σ_i m_i * msg_mod^i
    (reference RadixCiphertext, integer/ciphertext/mod.rs:18)."""

    blocks: List[ShortintCiphertext]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def message_modulus(self) -> int:
        return self.blocks[0].message_modulus

    @property
    def batch_shape(self) -> tuple:
        return self.blocks[0].batch_shape

    def block_carries_are_empty(self) -> bool:
        return all(b.carry_is_empty for b in self.blocks)


@dataclass(frozen=True)
class SignedRadixCiphertext(RadixCiphertext):
    """Two's-complement reading of the same block layout (reference
    SignedRadixCiphertext, integer/ciphertext/mod.rs:203)."""


@dataclass(frozen=True)
class BooleanBlock:
    """One block holding 0 or 1 (reference BooleanBlock)."""

    block: ShortintCiphertext


@dataclass(frozen=True)
class CrtCiphertext:
    """Residues of the value modulo pairwise-coprime block moduli (reference
    CrtCiphertext, integer/ciphertext/mod.rs:431)."""

    blocks: List[ShortintCiphertext]
    moduli: Sequence[int] = ()
