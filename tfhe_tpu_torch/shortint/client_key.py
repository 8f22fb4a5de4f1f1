"""Shortint client key: encrypt and decrypt under the big (GLWE-as-LWE) key
(counterpart of `tfhe_tpu/shortint/client_key.py`)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng
from ..core.algorithms import (decrypt_lwe, encrypt_lwe, generate_glwe_secret_key,
                               generate_lwe_secret_key, trivial_lwe)
from ..core.algorithms.seeded import encrypt_lwe_seeded
from ..core.entities import GlweSecretKey, LweSecretKey
from ..core.numeric import LOG_Q, as_i64, udiv
from ..core.params import (ClassicPBSParameters, EncryptionKeyChoice,
                           MultiBitPBSParameters, shortint_params)
from ..cuda_lib import resolve_device
from .ciphertext import Ciphertext, CompressedCiphertext, NoiseLevel


def delta_for(params) -> int:
    """Δ = q / (2 * msg_mod * carry_mod): one bit of padding."""
    return (1 << LOG_Q) // (2 * params.message_modulus * params.carry_modulus)


@dataclass(frozen=True)
class ClientKey:
    glwe_sk: GlweSecretKey
    lwe_sk: LweSecretKey
    params: ClassicPBSParameters | MultiBitPBSParameters

    @property
    def device(self) -> torch.device:
        return self.lwe_sk.bits.device

    @property
    def big_sk(self) -> LweSecretKey:
        return self.glwe_sk.as_lwe_secret_key()

    @property
    def encryption_key(self) -> LweSecretKey:
        if self.params.encryption_key_choice == EncryptionKeyChoice.BIG:
            return self.big_sk
        return self.lwe_sk

    @property
    def encryption_noise_std(self) -> float:
        if self.params.encryption_key_choice == EncryptionKeyChoice.BIG:
            return self.params.glwe_noise_std
        return self.params.lwe_noise_std

    def _plaintexts(self, messages) -> torch.Tensor:
        p = self.params
        msgs = torch.as_tensor(messages, dtype=torch.int64, device=self.device)
        return torch.remainder(msgs, p.message_modulus * p.carry_modulus) \
            * as_i64(delta_for(p))

    def encrypt(self, messages, seed: int = 0) -> Ciphertext:
        """messages: integers [...] in [0, message_modulus)."""
        p = self.params
        pts = self._plaintexts(messages)
        gen = rng.generator(seed, 0x5C, device=self.device)
        ct = encrypt_lwe(gen, self.encryption_key, pts, self.encryption_noise_std)
        return Ciphertext(lwe=ct, degree=p.message_modulus - 1,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus,
                          noise_level=NoiseLevel.NOMINAL)

    def encrypt_compressed(self, messages, seed: int = 1) -> CompressedCiphertext:
        """A seeded encryption: the bodies and a 32-bit seed travel, the mask
        is the seed's stream (tfhe_tpu client_key.py:81-95, masks bit for bit
        the JAX package's for the same seed); the noise comes from a
        generator of the seed."""
        p = self.params
        sct = encrypt_lwe_seeded(seed, rng.generator(seed, 0x3E, device=self.device),
                                 self.encryption_key, self._plaintexts(messages),
                                 self.encryption_noise_std)
        return CompressedCiphertext(ct=sct, degree=p.message_modulus - 1,
                                    message_modulus=p.message_modulus,
                                    carry_modulus=p.carry_modulus,
                                    noise_level=NoiseLevel.NOMINAL)

    def decrypt_compressed(self, cct: CompressedCiphertext) -> torch.Tensor:
        return self.decrypt(cct.decompress())

    def unchecked_encrypt(self, messages, seed: int = 0) -> Ciphertext:
        """Encrypt into the full message+carry space (degree = p*c - 1)."""
        p = self.params
        return self.encrypt(messages, seed).with_(
            degree=p.message_modulus * p.carry_modulus - 1)

    def trivial_encrypt(self, messages, degree=None) -> Ciphertext:
        """Noiseless encryption: a zero mask and messages * Δ as the body."""
        p = self.params
        msgs = torch.as_tensor(messages, dtype=torch.int64, device=self.device)
        n = (p.big_lwe_dimension if p.encryption_key_choice == EncryptionKeyChoice.BIG
             else p.lwe_dimension)
        return Ciphertext(lwe=trivial_lwe(msgs * as_i64(delta_for(p)), n),
                          degree=p.message_modulus - 1 if degree is None else degree,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus, noise_level=NoiseLevel.ZERO)

    def decrypt_message_and_carry(self, ct: Ciphertext) -> torch.Tensor:
        """→ int64 [...] in [0, 2 * msg_mod * carry_mod): the rounded phase,
        divided by Δ as an unsigned value."""
        phase = decrypt_lwe(ct.lwe, self.encryption_key)
        d = delta_for(self.params)
        space = 2 * self.params.message_modulus * self.params.carry_modulus
        return torch.remainder(udiv(phase + (d >> 1), d), space)

    def decrypt(self, ct: Ciphertext) -> torch.Tensor:
        """→ message tensor [...] (mod message_modulus)."""
        return torch.remainder(self.decrypt_message_and_carry(ct), ct.message_modulus)


def gen_client_key(params: str | ClassicPBSParameters | MultiBitPBSParameters
                   = "PARAM_MESSAGE_2_CARRY_2_KS_PBS", seed: int = 0,
                   device="cuda") -> ClientKey:
    """The client key of gen_keys alone, on `device`: what a client keeps
    when the server key it ships is compressed.  Runs on the card unless
    given device="cpu"; without a card that raises."""
    device = resolve_device(device)
    if isinstance(params, str):
        params = shortint_params(params)
    glwe_sk = generate_glwe_secret_key(rng.generator(seed, 1, device=device),
                                       params.glwe_dimension, params.polynomial_size)
    lwe_sk = generate_lwe_secret_key(rng.generator(seed, 2, device=device),
                                     params.lwe_dimension)
    return ClientKey(glwe_sk=glwe_sk, lwe_sk=lwe_sk, params=params)


def gen_keys(params: str | ClassicPBSParameters | MultiBitPBSParameters
             = "PARAM_MESSAGE_2_CARRY_2_KS_PBS", seed: int = 0, device="cuda"):
    """→ (ClientKey, ServerKey) on `device` (reference shortint::gen_keys):
    a classic or a multi-bit server key, as the parameters say.  Runs on
    the card unless given device="cpu"; without a card that raises."""
    from .server_key import gen_server_key
    ck = gen_client_key(params, seed, device)
    return ck, gen_server_key(ck, seed)
