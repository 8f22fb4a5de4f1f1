"""Integer WoP-PBS: an arbitrary function over a whole radix or CRT integer.

Counterpart of `tfhe_tpu/integer/wopbs.py` (reference
tfhe/src/integer/wopbs/mod.rs:216-487, 716-780): the message bits of every
block are extracted and circuit-bootstrapped into GGSWs once, then each
output block is one vertical packing of its own LUT over that shared GGSW
list.  A LUT over t bits is max(1, 2^t / N) polynomials, built on the host
as int64 bit patterns; where there are several, vertical packing runs its
CMux tree over the most significant GGSWs first.  On the card: K1 for the
extraction's and circuit bootstrap's PBS, the pass and K2′ for their
keyswitches and the private functional keyswitches, and K7 for every CMux
and rotation step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from ..core.algorithms.wopbs import vertical_packing
from ..core.numeric import from_numpy_u64
from ..shortint.ciphertext import Ciphertext as Block
from ..shortint.ciphertext import NoiseLevel
from ..shortint.client_key import delta_for
from ..shortint.wopbs import WopbsKey
from .ciphertext import CrtCiphertext, RadixCiphertext


@dataclass(frozen=True)
class IntegerWopbsKey:
    wopbs_key: WopbsKey

    @property
    def params(self):
        return self.wopbs_key.params

    def _bits_per_block(self) -> int:
        return int(math.log2(self.params.message_modulus))

    def _ggsws(self, blocks, widths) -> list:
        """The GGSW spectra of the low `widths[i]` bits of each block, MSB
        first over the blocks taken last to first."""
        wk = self.wopbs_key
        ggsws = []
        for blk, w in zip(reversed(blocks), reversed(widths)):
            ggsws.extend(wk.circuit_bootstrap(wk.extract_bits_of(blk, w)))
        return ggsws

    def extract_radix_bits(self, ct: RadixCiphertext) -> list:
        """MSB-first GGSWs over all message bits of all blocks (the most
        significant block first, so the LUT index is the integer's value)."""
        return self._ggsws(ct.blocks, [self._bits_per_block()] * ct.num_blocks)

    def _pack(self, vals: np.ndarray):
        """LUT values [2^t] → polynomials [max(1, 2^t/N), N] int64 times Δ."""
        n = self.params.polynomial_size
        polys = np.zeros((max(1, vals.size // n), n), dtype=np.uint64)
        polys.reshape(-1)[:vals.size] = vals.astype(np.uint64) * np.uint64(delta_for(self.params))
        return from_numpy_u64(polys, self.wopbs_key.server_key.device)

    def wopbs(self, ct: RadixCiphertext, f: Callable[[int], int]) -> RadixCiphertext:
        """f over the radix value (reference WopbsKey::wopbs on a
        RadixCiphertext): output block i is (f(x) / m^i) mod m."""
        m = self.params.message_modulus
        nb = ct.num_blocks
        ggsws = self.extract_radix_bits(ct)
        fx = [f(x) for x in range(1 << (nb * self._bits_per_block()))]
        out: List[Block] = []
        for i in range(nb):
            vals = np.array([(v // m ** i) % m for v in fx], dtype=np.uint64)
            lwe = vertical_packing(self._pack(vals), ggsws, self.wopbs_key.cbs_decomp,
                                   self.params.glwe_dimension)
            out.append(Block(lwe=lwe, degree=m - 1, message_modulus=m,
                             carry_modulus=self.params.carry_modulus,
                             noise_level=NoiseLevel.NOMINAL))
        return RadixCiphertext(blocks=out)

    # ------------------------------------------------------------------
    # CRT ciphertexts (reference generate_lut_crt, integer/wopbs/mod.rs:716-780)
    # ------------------------------------------------------------------

    @staticmethod
    def _crt_widths(ct: CrtCiphertext) -> list:
        """Bits per CRT block from its degree: ceil(log2(degree + 1))."""
        return [max(1, int(math.ceil(math.log2(int(b.degree) + 1)))) for b in ct.blocks]

    def extract_crt_bits(self, ct: CrtCiphertext) -> list:
        """MSB-first GGSWs over the residue bits of every CRT block, the
        last block's first (block j holds LUT-index bits [sum(widths[:j]),
        sum(widths[:j+1])) from the LSB)."""
        return self._ggsws(ct.blocks, self._crt_widths(ct))

    def wopbs_crt(self, ct: CrtCiphertext, f: Callable[[int], int]) -> CrtCiphertext:
        """Each output residue block j is f(x_j) mod m_j, every block over
        the one shared GGSW list (the entry at index v is f((v >> offset_j
        mod 2^w_j) mod m_j) mod m_j)."""
        widths = self._crt_widths(ct)
        ggsws = self.extract_crt_bits(ct)
        idx = np.arange(1 << sum(widths), dtype=np.uint64)
        out: List[Block] = []
        offset = 0
        for blk, mj, bj in zip(ct.blocks, ct.moduli, widths):
            vj = ((idx >> np.uint64(offset)) & np.uint64((1 << bj) - 1)) % np.uint64(mj)
            vals = np.array([int(f(int(v))) % mj for v in vj], dtype=np.uint64)
            lwe = vertical_packing(self._pack(vals), ggsws, self.wopbs_key.cbs_decomp,
                                   self.params.glwe_dimension)
            out.append(Block(lwe=lwe, degree=mj - 1, message_modulus=blk.message_modulus,
                             carry_modulus=blk.carry_modulus, noise_level=NoiseLevel.NOMINAL))
            offset += bj
        return CrtCiphertext(blocks=out, moduli=tuple(ct.moduli))


def new_integer_wopbs_key(wopbs_key: WopbsKey) -> IntegerWopbsKey:
    return IntegerWopbsKey(wopbs_key=wopbs_key)


__all__ = ["IntegerWopbsKey", "new_integer_wopbs_key"]
