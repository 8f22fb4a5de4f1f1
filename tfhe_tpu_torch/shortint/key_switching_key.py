"""Casting ciphertexts between shortint key sets (counterpart of
`tfhe_tpu/shortint/key_switching_key.py`; reference
tfhe/src/shortint/key_switching_key/): a keyswitching key from key set 1's
encryption key to key set 2's, which the Trivium transciphering uses to move
keystream bits into the high-level API's parameters
(apps/trivium/src/trivium/trivium_shortint.rs:10-27).

Where the two sets' plaintext spaces differ, Δ_src = 2^r Δ_dst, and `cast`
compensates with a shift LUT as the reference's `cast_rshift` branches do
(shortint/key_switching_key/mod.rs:113-145).  The keyswitch is
`keyswitch_lwe` (the pass and K2′ on the card where `tensor_core_form`
holds, as at PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS's 15 x 1); the shift
LUTs are one KS+PBS call each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core import rng, threefry
from ..core.algorithms import keyswitch_lwe
from ..core.algorithms.encryption import generate_keyswitch_key_from_key
from ..core.entities import LweKeyswitchKey
from ..core.params import ShortintKeySwitchingParameters
from .ciphertext import Ciphertext, NoiseLevel
from .client_key import ClientKey


@dataclass(frozen=True)
class KeySwitchingKey:
    """ksk from set 1's encryption key to set 2's; cast_rshift = log2 of set
    2's plaintext space minus log2 of set 1's (a message v under set 1
    reads as v << cast_rshift under set 2); the server keys of the shift
    LUTs (needed where cast_rshift is not 0)."""

    ksk: LweKeyswitchKey
    dest_params: Any
    cast_rshift: int = 0
    dest_server_key: Any = None
    src_server_key: Any = None

    def _dest(self, lwe, degree: int, noise_level: int) -> Ciphertext:
        return Ciphertext(lwe=lwe, degree=degree,
                          message_modulus=self.dest_params.message_modulus,
                          carry_modulus=self.dest_params.carry_modulus, noise_level=noise_level)

    def cast(self, ct: Ciphertext) -> Ciphertext:
        """The ciphertext under key set 2 (reference cast_into,
        shortint/key_switching_key/mod.rs:113)."""
        r = self.cast_rshift
        if r == 0:
            return self._dest(keyswitch_lwe(ct.lwe, self.ksk), ct.degree, NoiseLevel.NOMINAL)
        if r > 0:
            # into a wider space: keyswitch, then n >> r under set 2's key
            mid = self._dest(keyswitch_lwe(ct.lwe, self.ksk), ct.degree << r,
                             NoiseLevel.UNKNOWN)
            sk = self.dest_server_key
            res = sk.apply_lookup_table(mid, sk.generate_lookup_table(lambda n: n >> r))
            return res.with_(degree=ct.degree)
        # into a narrower space: (n << -r) mod set 1's space under set 1's
        # key, then keyswitch
        sk = self.src_server_key
        total = ct.message_modulus * ct.carry_modulus
        shifted = sk.apply_lookup_table(
            ct, sk.generate_lookup_table(lambda n: (n << -r) % total))
        return self._dest(keyswitch_lwe(shifted.lwe, self.ksk), ct.degree, NoiseLevel.NOMINAL)


def generate_key_switching_key(ck1: ClientKey, ck2: ClientKey,
                               params: ShortintKeySwitchingParameters, seed: int = 0,
                               src_server_key=None, dest_server_key=None) -> KeySwitchingKey:
    """Reference KeySwitchingKey::new((ck1, sk1), (ck2, sk2), params), on
    ck2's device: the key's masks those of tfhe_tpu
    generate_key_switching_key under fork(key_from_seed(seed), 0xC5), its
    noise from a generator of the seed.  The server keys are needed only
    where the plaintext spaces differ."""
    dev = ck2.device
    key = threefry.fork(threefry.key_from_seed(seed, dev), 0xC5)
    ksk = generate_keyswitch_key_from_key(key, rng.generator(seed, 0xC5, device=dev),
                                          ck1.encryption_key, ck2.encryption_key,
                                          params.ks_decomp, ck2.encryption_noise_std)
    src_total = ck1.params.message_modulus * ck1.params.carry_modulus
    dst_total = ck2.params.message_modulus * ck2.params.carry_modulus
    rshift = dst_total.bit_length() - src_total.bit_length()
    if rshift > 0 and dest_server_key is None:
        raise ValueError("casting into a wider set needs dest_server_key")
    if rshift < 0 and src_server_key is None:
        raise ValueError("casting into a narrower set needs src_server_key")
    return KeySwitchingKey(ksk=ksk, dest_params=ck2.params, cast_rshift=rshift,
                           dest_server_key=dest_server_key, src_server_key=src_server_key)


__all__ = ["KeySwitchingKey", "generate_key_switching_key"]
