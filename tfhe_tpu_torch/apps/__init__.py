"""Application layer (counterpart of `tfhe_tpu/apps/`; reference apps/): the
Trivium and Kreyvium stream ciphers over the boolean, shortint and integer
schemes, and the client side of transciphering."""
from .trivium import (KreyviumStream, KreyviumStreamByte, KreyviumStreamShortint,
                      TriviumStream, TriviumStreamByte, TriviumStreamShortint,
                      clear_kreyvium_keystream, clear_trivium_keystream,
                      trans_decrypt_u64_bits, trans_encrypt_u64)

__all__ = ["TriviumStream", "KreyviumStream", "TriviumStreamShortint",
           "KreyviumStreamShortint", "TriviumStreamByte", "KreyviumStreamByte",
           "clear_trivium_keystream", "clear_kreyvium_keystream", "trans_encrypt_u64",
           "trans_decrypt_u64_bits"]
