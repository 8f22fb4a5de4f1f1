"""Core algorithms of the port's slices: encryption, keyswitch, bootstrap,
multi-bit bootstrap, linear algebra, the 2^128 torus's PBS and keyswitch
(the WoP-PBS is `wopbs.py`, the custom moduli `nonnative.py`)."""
from .bootstrap import (blind_rotate_only, cmux, external_product_accumulate,
                        external_product_num_primes, modulus_switch,
                        programmable_bootstrap, sample_extract)
from .encryption import (bootstrap_key_to_ntt, bootstrap_key_to_ntt_paired, decrypt_lwe,
                         encrypt_constant_ggsw, encrypt_glwe, encrypt_glwe_deterministic_mask,
                         encrypt_lwe, encrypt_lwe_deterministic_mask, generate_bootstrap_key,
                         generate_glwe_secret_key, generate_keyswitch_key,
                         generate_lwe_secret_key, ggsw_plaintexts, trivial_ggsw_one_ntt,
                         trivial_glwe, trivial_lwe)
from .keyswitch import (keyswitch_lwe, packing_keyswitch_lwe_list_to_glwe,
                        packing_keyswitch_lwe_to_glwe)
from .linear import (glwe_add, glwe_add_plaintext_poly, glwe_sub, lwe_add, lwe_add_plaintext,
                     lwe_mul_cleartext, lwe_neg, lwe_sub, lwe_sub_plaintext)
from .multi_bit import (generate_multi_bit_bootstrap_key, multi_bit_blind_rotate,
                        multi_bit_bootstrap_key_to_ntt)
from .pbs128 import (Glwe128, KeyswitchKey128, Lwe128, NttBootstrapKey128, blind_rotate128,
                     bootstrap_key128_to_ntt, decrypt_glwe128, decrypt_lwe128, encrypt_glwe128,
                     encrypt_lwe128, generate_bootstrap_key128, generate_keyswitch_key128,
                     keyswitch128, programmable_bootstrap128, sample_extract128,
                     trivial_glwe128)

__all__ = [
    "blind_rotate_only", "cmux", "external_product_accumulate",
    "packing_keyswitch_lwe_list_to_glwe", "packing_keyswitch_lwe_to_glwe", "glwe_add",
    "glwe_add_plaintext_poly", "glwe_sub", "lwe_add", "lwe_add_plaintext", "lwe_mul_cleartext",
    "lwe_neg", "lwe_sub", "lwe_sub_plaintext", "external_product_num_primes", "modulus_switch",
    "programmable_bootstrap", "sample_extract", "bootstrap_key_to_ntt", "bootstrap_key_to_ntt_paired", "decrypt_lwe",
    "encrypt_constant_ggsw", "encrypt_glwe", "encrypt_glwe_deterministic_mask", "encrypt_lwe",
    "encrypt_lwe_deterministic_mask", "generate_bootstrap_key",
    "generate_glwe_secret_key", "generate_keyswitch_key", "generate_lwe_secret_key",
    "ggsw_plaintexts", "trivial_ggsw_one_ntt", "trivial_glwe", "trivial_lwe",
    "keyswitch_lwe", "generate_multi_bit_bootstrap_key", "multi_bit_blind_rotate",
    "multi_bit_bootstrap_key_to_ntt", "Glwe128", "KeyswitchKey128", "Lwe128",
    "NttBootstrapKey128", "blind_rotate128", "bootstrap_key128_to_ntt", "decrypt_glwe128",
    "decrypt_lwe128", "encrypt_glwe128", "encrypt_lwe128", "generate_bootstrap_key128",
    "generate_keyswitch_key128", "keyswitch128", "programmable_bootstrap128",
    "sample_extract128", "trivial_glwe128",
]
