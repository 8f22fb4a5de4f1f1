"""Shortint WoP-PBS: a LUT over the whole message+carry space by bit
extraction, circuit bootstrap and vertical packing (counterpart of
`tfhe_tpu/shortint/wopbs.py`; reference tfhe/src/shortint/wopbs/mod.rs).

Two regimes, as in the JAX package: `new_wopbs_key_only_for_wopbs` (one
parameter set for the PBS and the WoP-PBS) and `new_wopbs_key` (a dedicated
WoP-PBS set with its own client key, and casting keyswitching keys into and
out of the compute set).  On the card a `wopbs` call at
WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS runs K1 for every PBS, the pass and
K2′ for every keyswitch and every private functional keyswitch (its
digits of 15 bits as two byte limbs) and K7 for every CMux and rotation
step of vertical packing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..core import rng, threefry
from ..core.algorithms.encryption import generate_keyswitch_key_from_key
from ..core.algorithms.keyswitch import keyswitch_lwe
from ..core.algorithms.wopbs import (CbsPfpkskList, circuit_bootstrap_boolean, extract_bits,
                                     generate_cbs_pfpksk, ggsw_to_ntt, vertical_packing)
from ..core.entities import GlweSecretKey, LweCiphertext, LweSecretKey
from ..core.numeric import LOG_Q, from_numpy_u64
from ..core.params import DecompParams, wopbs_params
from .ciphertext import Ciphertext, NoiseLevel
from .client_key import ClientKey, delta_for
from .server_key import ServerKey, gen_server_key


@dataclass(frozen=True)
class WopbsLut:
    """Clear LUT polynomials [2^t, N] int64 for vertical packing."""

    polys: torch.Tensor
    degree: int = 0


@dataclass(frozen=True)
class WopbsKey:
    """Reference shortint WopbsKey (wopbs/mod.rs:44), the only-for-wopbs
    regime: the server key whose KSK and BSK extract the bits and bootstrap
    the circuit, and the PFPKSK list."""

    server_key: ServerKey
    pfpksk: CbsPfpkskList
    cbs_decomp: DecompParams

    @property
    def params(self):
        return self.server_key.params

    @property
    def message_bits(self) -> int:
        return int(math.log2(self.params.message_modulus * self.params.carry_modulus))

    @property
    def delta_log(self) -> int:
        return LOG_Q - 1 - self.message_bits

    def generate_lut(self, f: Callable[[int], int]) -> WopbsLut:
        """The LUT over the message+carry space (reference generate_lut_*):
        f(v) * Δ at slot v of the packed polynomials."""
        p = 1 << self.message_bits
        n = self.params.polynomial_size
        vals = np.array([f(i) % (2 * p) for i in range(p)], dtype=np.uint64) \
            * np.uint64(delta_for(self.params))
        polys = np.zeros((max(1, p // n), n), dtype=np.uint64)
        for v in range(p):
            polys[v // n, v % n] = vals[v]
        return WopbsLut(polys=from_numpy_u64(polys, self.server_key.device),
                        degree=int(max(f(i) % p for i in range(p))))

    def extract_bits(self, ct: Ciphertext) -> LweCiphertext:
        return extract_bits(ct.lwe, self.server_key.ksk, self.server_key.bsk, self.delta_log,
                            self.message_bits)

    def extract_bits_of(self, ct: Ciphertext, num_bits: int) -> LweCiphertext:
        """Only the `num_bits` low bits of the block value (the message bits,
        which the integer-level WoP-PBS uses)."""
        return extract_bits(ct.lwe, self.server_key.ksk, self.server_key.bsk, self.delta_log,
                            num_bits)

    def circuit_bootstrap(self, bits: LweCiphertext) -> list:
        """Per extracted bit (MSB first) its GGSW, as the port's spectra."""
        return [ggsw_to_ntt(circuit_bootstrap_boolean(
            self.server_key.bsk, LweCiphertext(data=bits.data[..., i, :]), self.pfpksk,
            self.cbs_decomp, LOG_Q - 1)) for i in range(bits.data.shape[-2])]

    def wopbs(self, ct: Ciphertext, lut: WopbsLut) -> Ciphertext:
        """The function over message+carry (reference WopbsKey::wopbs)."""
        ggsws = self.circuit_bootstrap(self.extract_bits(ct))
        out = vertical_packing(lut.polys, ggsws, self.cbs_decomp, self.params.glwe_dimension)
        return ct.with_(lwe=out, degree=lut.degree, noise_level=NoiseLevel.NOMINAL)


def new_wopbs_key_only_for_wopbs(ck: ClientKey, sk: ServerKey,
                                 cbs_decomp: DecompParams = None,
                                 pfks_decomp: DecompParams = None,
                                 seed: int = 0) -> WopbsKey:
    """Reference WopbsKey::new_wopbs_key_only_for_wopbs, on the client key's
    device: the PFPKSK's masks those of tfhe_tpu's under
    fork(key_from_seed(seed), 0xCB5), its noise from a generator of the
    seed."""
    p = ck.params
    cbs_decomp = cbs_decomp or DecompParams(6, 2)
    pfks_decomp = pfks_decomp or DecompParams(4, 8)
    dev = ck.device
    key = threefry.fork(threefry.key_from_seed(seed, dev), 0xCB5)
    pfpksk = generate_cbs_pfpksk(key, rng.generator(seed, 0xCB5, device=dev), ck.big_sk,
                                 ck.glwe_sk, pfks_decomp, p.glwe_noise_std)
    return WopbsKey(server_key=sk, pfpksk=pfpksk, cbs_decomp=cbs_decomp)


# ---------------------------------------------------------------------------
# the combined regime: a dedicated WoP-PBS set and casting keys
# (reference WopbsKey::new_wopbs_key, shortint/engine/wopbs/mod.rs:50-140)
# ---------------------------------------------------------------------------


def _wopbs_client_key(ck: ClientKey, wparams, seed: int) -> ClientKey:
    """The WoP-PBS regime's own client key (reference
    engine/wopbs/mod.rs:56-68), on ck's device: its bits are tfhe_tpu
    _wopbs_client_key's for the same seed, bit for bit (threefry)."""
    dev = ck.device
    k_glwe, k_lwe = threefry.split(threefry.fork(threefry.key_from_seed(seed, dev), 0xA0B5))
    glwe_sk = GlweSecretKey(bits=threefry.binary_key(
        k_glwe, (wparams.glwe_dimension, wparams.polynomial_size)))
    lwe_sk = LweSecretKey(bits=threefry.binary_key(k_lwe, (wparams.lwe_dimension,)))
    return ClientKey(glwe_sk=glwe_sk, lwe_sk=lwe_sk, params=wparams)


@dataclass(frozen=True)
class CombinedWopbsKey:
    """Reference shortint WopbsKey in the combined regime (wopbs/mod.rs:46-49):
      wopbs_key        the only-for-wopbs key at the WoP-PBS set;
      pbs_server_key   the compute ServerKey with its KSK replaced by the
                       WoP-PBS big key → compute small key cast, so one
                       apply_lookup_table is the reference's
                       keyswitch_to_pbs_params KS+PBS pair;
      ksk_pbs_to_wopbs the compute big key → WoP-PBS big key cast."""

    wopbs_key: WopbsKey
    pbs_server_key: ServerKey
    ksk_pbs_to_wopbs: Any

    @property
    def params(self):
        return self.wopbs_key.params

    def keyswitch_to_wopbs_params(self, sks: ServerKey, ct: Ciphertext) -> Ciphertext:
        """A clean PBS on the compute key, then the cast into the WoP-PBS
        set (reference keyswitch_to_wopbs_params, wopbs/mod.rs:724)."""
        clean = sks.apply_lookup_table(ct, sks.generate_lookup_table(lambda x: x))
        return ct.with_(lwe=keyswitch_lwe(clean.lwe, self.ksk_pbs_to_wopbs), degree=ct.degree,
                        noise_level=NoiseLevel.NOMINAL)

    def keyswitch_to_pbs_params(self, ct: Ciphertext) -> Ciphertext:
        """The cast back to the compute small key and a clean PBS (reference
        keyswitch_to_pbs_params, wopbs/mod.rs:660)."""
        sk = self.pbs_server_key
        return sk.apply_lookup_table(ct, sk.generate_lookup_table(lambda x: x)).with_(
            degree=ct.degree)

    def generate_lut(self, f) -> WopbsLut:
        return self.wopbs_key.generate_lut(f)

    def wopbs(self, sks: ServerKey, ct: Ciphertext, lut: WopbsLut) -> Ciphertext:
        """The function through the WoP-PBS set (reference WopbsKey::wopbs,
        wopbs/mod.rs:404)."""
        res = self.wopbs_key.wopbs(self.keyswitch_to_wopbs_params(sks, ct), lut)
        return self.keyswitch_to_pbs_params(res)


def new_wopbs_key(ck: ClientKey, sk: ServerKey, wparams="auto",
                  seed: int = 0) -> CombinedWopbsKey:
    """Reference WopbsKey::new_wopbs_key (the combined regime,
    engine/wopbs/mod.rs:50), on the client key's device: the WoP-PBS
    client key (`_wopbs_client_key`), its server key and PFPKSK list, and
    the two casting keys.  wparams: a WopbsParameters, a named set, or
    "auto" for WOPBS_PARAM_MESSAGE_{m}_CARRY_{c}_KS_PBS of the compute set.
    Masks follow tfhe_tpu's key tree (split(fork(key_from_seed(seed),
    0xC0B5), 4)) where the port has a threefry form; the noise comes from
    generators of the seed."""
    p = ck.params
    if wparams == "auto":
        wparams = wopbs_params(f"WOPBS_PARAM_MESSAGE_{int(math.log2(p.message_modulus))}"
                               f"_CARRY_{int(math.log2(p.carry_modulus))}_KS_PBS")
    elif isinstance(wparams, str):
        wparams = wopbs_params(wparams)
    dev = ck.device
    wck = _wopbs_client_key(ck, wparams, seed)
    _, k_pf, k_in, k_out = threefry.split(
        threefry.fork(threefry.key_from_seed(seed, dev), 0xC0B5), 4)
    wsk = gen_server_key(wck, seed ^ 0xC0B50000)
    pfpksk = generate_cbs_pfpksk(k_pf, rng.generator(seed, 0xC0B5, 1, device=dev), wck.big_sk,
                                 wck.glwe_sk, wparams.pfks_decomp, wparams.pfks_noise_std)
    inner = WopbsKey(server_key=wsk, pfpksk=pfpksk, cbs_decomp=wparams.cbs_decomp)
    # compute big → WoP-PBS big: the compute KS decomposition, the WoP-PBS
    # set's LWE noise (reference engine/wopbs/mod.rs:106-115)
    ksk_in = generate_keyswitch_key_from_key(k_in, rng.generator(seed, 0xC0B5, 2, device=dev),
                                             ck.big_sk, wck.big_sk, p.ks_decomp,
                                             wparams.lwe_noise_std)
    # WoP-PBS big → compute small: the compute set's decomposition and noise (:118-127)
    ksk_out = generate_keyswitch_key_from_key(k_out, rng.generator(seed, 0xC0B5, 3, device=dev),
                                              wck.big_sk, ck.lwe_sk, p.ks_decomp,
                                              p.lwe_noise_std)
    return CombinedWopbsKey(wopbs_key=inner,
                            pbs_server_key=ServerKey(ksk=ksk_out, bsk=sk.bsk, params=p),
                            ksk_pbs_to_wopbs=ksk_in)


__all__ = ["WopbsLut", "WopbsKey", "CombinedWopbsKey", "new_wopbs_key_only_for_wopbs",
           "new_wopbs_key"]
