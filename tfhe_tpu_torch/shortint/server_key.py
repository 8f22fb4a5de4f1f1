"""Shortint server key: lookup tables and the keyswitch + PBS atomic pattern
(counterpart of the slice of `tfhe_tpu/shortint/server_key.py` that the
main path runs: :81-198 and gen_server_key :808, classic keys only)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import rng
from ..core.algorithms import (bootstrap_key_to_ntt, external_product_num_primes,
                               generate_bootstrap_key, generate_keyswitch_key,
                               keyswitch_lwe, programmable_bootstrap, trivial_glwe)
from ..core.entities import (GlweCiphertext, LweCiphertext, LweKeyswitchKey,
                             NttBootstrapKey)
from ..core.numeric import from_numpy_u64
from ..core.params import PBSOrder
from .ciphertext import Ciphertext, NoiseLevel
from .client_key import ClientKey, delta_for


@dataclass(frozen=True)
class LookupTable:
    """An accumulator GLWE and the output degree bound
    (reference `LookupTableOwned`, shortint/server_key/mod.rs:383)."""

    acc: GlweCiphertext
    degree: int = 0


@dataclass(frozen=True)
class ServerKey:
    ksk: LweKeyswitchKey
    bsk: NttBootstrapKey
    params: object

    @property
    def device(self) -> torch.device:
        return self.bsk.spectra.device

    @property
    def message_modulus(self) -> int:
        return self.params.message_modulus

    @property
    def carry_modulus(self) -> int:
        return self.params.carry_modulus

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """Accumulator for x ↦ f(x) over the message+carry space: a box of
        N/p coefficients per input value, rotated by half a box so the
        rounding window centres on each message; the negacyclic wrap
        negates the tail."""
        p = self.message_modulus * self.carry_modulus
        n_poly = self.params.polynomial_size
        box = n_poly // p
        vals = np.array([f(i) % (2 * p) for i in range(p)], dtype=np.uint64)
        poly = np.repeat(vals * np.uint64(delta_for(self.params)), box)
        poly = np.roll(poly, -(box // 2))
        poly[-(box // 2):] = np.uint64(0) - poly[-(box // 2):]
        acc = trivial_glwe(from_numpy_u64(poly, self.device),
                           self.params.glwe_dimension)
        return LookupTable(acc=acc, degree=int(vals.max()))

    def generate_bivariate_lookup_table(self, f: Callable[[int, int], int]) -> LookupTable:
        """LUT over the packed value left * msg_mod + right."""
        m = self.message_modulus
        return self.generate_lookup_table(lambda x: f(x // m, x % m))

    def _pbs(self, lwe: LweCiphertext, acc: GlweCiphertext) -> LweCiphertext:
        return programmable_bootstrap(lwe, acc, self.bsk)

    def apply_lookup_table(self, ct: Ciphertext, lut: LookupTable) -> Ciphertext:
        """KS → PBS (KEYSWITCH_BOOTSTRAP) or PBS → KS, per the parameters."""
        if self.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
            out = self._pbs(keyswitch_lwe(ct.lwe, self.ksk), lut.acc)
        else:
            out = keyswitch_lwe(self._pbs(ct.lwe, lut.acc), self.ksk)
        return ct.with_(lwe=out, degree=lut.degree, noise_level=NoiseLevel.NOMINAL)

    def unchecked_bivariate_pack(self, left: Ciphertext, right: Ciphertext) -> Ciphertext:
        """left * msg_mod + right (requires right.degree < msg_mod)."""
        m = self.message_modulus
        data = left.lwe.data * m + right.lwe.data
        return left.with_(lwe=LweCiphertext(data=data),
                          degree=left.degree * m + right.degree,
                          noise_level=left.noise_level * m + right.noise_level)

    def unchecked_apply_lookup_table_bivariate(self, left: Ciphertext,
                                               right: Ciphertext,
                                               lut: LookupTable) -> Ciphertext:
        return self.apply_lookup_table(self.unchecked_bivariate_pack(left, right), lut)


def gen_server_key(ck: ClientKey, seed: int) -> ServerKey:
    """BSK (small LWE key → GLWE key, in the port's spectra) and KSK (big →
    small), on the client key's device."""
    p = ck.params
    device = ck.device
    bsk_std = generate_bootstrap_key(rng.generator(seed, 3, device=device),
                                     ck.lwe_sk, ck.glwe_sk, p.pbs_decomp,
                                     p.glwe_noise_std)
    npr = external_product_num_primes(p.polynomial_size, p.glwe_size, p.pbs_decomp)
    bsk = bootstrap_key_to_ntt(bsk_std, npr)
    del bsk_std
    ksk = generate_keyswitch_key(rng.generator(seed, 4, device=device),
                                 ck.big_sk, ck.lwe_sk, p.ks_decomp, p.lwe_noise_std)
    return ServerKey(ksk=ksk, bsk=bsk, params=p)
