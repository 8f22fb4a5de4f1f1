"""Core algorithms of the port's slices: encryption, keyswitch, bootstrap,
multi-bit bootstrap."""
from .bootstrap import (external_product_num_primes, modulus_switch,
                        programmable_bootstrap, sample_extract)
from .encryption import (bootstrap_key_to_ntt, bootstrap_key_to_ntt_paired, decrypt_lwe,
                         encrypt_constant_ggsw, encrypt_glwe, encrypt_glwe_deterministic_mask,
                         encrypt_lwe, encrypt_lwe_deterministic_mask, generate_bootstrap_key,
                         generate_glwe_secret_key, generate_keyswitch_key,
                         generate_lwe_secret_key, ggsw_plaintexts, trivial_ggsw_one_ntt,
                         trivial_glwe, trivial_lwe)
from .keyswitch import keyswitch_lwe
from .multi_bit import (generate_multi_bit_bootstrap_key, multi_bit_blind_rotate,
                        multi_bit_bootstrap_key_to_ntt)

__all__ = [
    "external_product_num_primes", "modulus_switch", "programmable_bootstrap",
    "sample_extract", "bootstrap_key_to_ntt", "bootstrap_key_to_ntt_paired", "decrypt_lwe",
    "encrypt_constant_ggsw", "encrypt_glwe", "encrypt_glwe_deterministic_mask", "encrypt_lwe",
    "encrypt_lwe_deterministic_mask", "generate_bootstrap_key",
    "generate_glwe_secret_key", "generate_keyswitch_key", "generate_lwe_secret_key",
    "ggsw_plaintexts", "trivial_ggsw_one_ntt", "trivial_glwe", "trivial_lwe",
    "keyswitch_lwe", "generate_multi_bit_bootstrap_key", "multi_bit_blind_rotate",
    "multi_bit_bootstrap_key_to_ntt",
]
