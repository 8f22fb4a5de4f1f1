"""Radix and CRT client keys: block decomposition on the host and one shortint
encryption per block (counterpart of `tfhe_tpu/integer/client_key.py`;
reference integer/client_key/, integer/encryption.rs)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import shortint
from .ciphertext import CrtCiphertext, RadixCiphertext, SignedRadixCiphertext


def _host_values(values) -> np.ndarray:
    """Clear values as a numpy array (a tensor is copied to the host).  A
    list or a Python int becomes an object array: numpy would turn a list
    that mixes ints below and above 2^63 into float64 and round them."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    if isinstance(values, np.ndarray):
        return values
    return np.array(values, dtype=object)


@dataclass(frozen=True)
class RadixClientKey:
    key: shortint.ClientKey
    num_blocks: int = 4

    @property
    def message_modulus(self) -> int:
        return self.key.params.message_modulus

    @property
    def bits_per_block(self) -> int:
        return int(math.log2(self.message_modulus))

    @property
    def total_bits(self) -> int:
        return self.num_blocks * self.bits_per_block

    def _block_values(self, values) -> list:
        """Little-endian base-m digits of values, one int64 tensor [...] per
        block on the key's device.  Python-int (object) arithmetic, so widths
        beyond 64 bits (FheUint128/256) encrypt exactly
        (integer/block_decomposition.rs)."""
        arr = _host_values(values)
        shape = arr.shape
        # >= 1-d object arrays: numpy ops on 0-d object arrays decay to ints
        arr = arr.reshape(-1).astype(object)
        m = int(self.message_modulus)
        arr = arr % m ** self.num_blocks
        out = []
        for _ in range(self.num_blocks):
            digits = (arr % m).astype(np.int64).reshape(shape)
            out.append(torch.as_tensor(digits, device=self.key.device))
            arr = arr // m
        return out

    def encrypt(self, values, seed: int = 0) -> RadixCiphertext:
        """values [...] of any width (Python ints beyond 64 bits) → blocks
        [..., n+1]; block i is encrypted with seed * 1009 + i."""
        return RadixCiphertext(blocks=[self.key.encrypt(bv, seed=seed * 1009 + i)
                                       for i, bv in enumerate(self._block_values(values))])

    def encrypt_signed(self, values, seed: int = 0) -> SignedRadixCiphertext:
        # _block_values wraps negative values mod m^num_blocks
        return SignedRadixCiphertext(blocks=self.encrypt(values, seed).blocks)

    def decrypt(self, ct: RadixCiphertext) -> np.ndarray:
        """→ uint64 [...], or Python ints (object) beyond 64 bits."""
        m = int(self.message_modulus)
        total, weight = None, 1
        for b in ct.blocks:
            d = self.key.decrypt(b).cpu().numpy().astype(object)
            total = d * weight if total is None else total + d * weight
            weight *= m
        mod = m ** ct.num_blocks
        total = np.asarray(total % mod, dtype=object)
        return total.astype(np.uint64) if mod <= 1 << 64 else total

    def decrypt_signed(self, ct: SignedRadixCiphertext) -> np.ndarray:
        space = int(self.message_modulus) ** ct.num_blocks
        u = self.decrypt(ct).astype(object)
        signed = np.where(u >= space // 2, u - space, u)
        return signed.astype(np.int64) if space <= 1 << 64 else signed

    def trivial_encrypt(self, values) -> RadixCiphertext:
        return RadixCiphertext(blocks=[self.key.trivial_encrypt(bv)
                                       for bv in self._block_values(values)])

    def decrypt_bool(self, ct) -> np.ndarray:
        """A BooleanBlock (or a bare block) → bool [...] (reference
        ClientKey::decrypt_bool, integer/client_key/mod.rs)."""
        block = ct.block if hasattr(ct, "block") else ct
        return self.key.decrypt(block).cpu().numpy().astype(bool)


@dataclass(frozen=True)
class CrtClientKey:
    key: shortint.ClientKey
    moduli: Sequence[int] = (2, 3, 5)

    def encrypt(self, values, seed: int = 0) -> CrtCiphertext:
        """Residue i of values, encrypted with seed * 31 + i over the whole
        message+carry space, at its true degree m_i - 1 (the CRT WoP-PBS
        sizes its extracted bits by it)."""
        vals = _host_values(values).astype(np.uint64)
        blocks = [self.key.unchecked_encrypt((vals % np.uint64(mi)).astype(np.int64),
                                             seed=seed * 31 + i).with_(degree=mi - 1)
                  for i, mi in enumerate(self.moduli)]
        return CrtCiphertext(blocks=blocks, moduli=tuple(self.moduli))

    def decrypt(self, ct: CrtCiphertext) -> np.ndarray:
        """CRT reconstruction of the residues → uint64 [...]."""
        M = math.prod(ct.moduli)
        total = None
        for b, mi in zip(ct.blocks, ct.moduli):
            d = self.key.decrypt_message_and_carry(b).cpu().numpy() % mi
            Mi = M // mi
            term = d * (Mi * pow(Mi, -1, mi))
            total = term if total is None else total + term
        return (total % M).astype(np.uint64)
