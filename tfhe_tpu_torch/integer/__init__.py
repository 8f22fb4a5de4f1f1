"""Integer: radix, signed radix and CRT integers over shortint blocks
(counterpart of `tfhe_tpu/integer/`; reference tfhe/src/integer/).

A `RadixCiphertext` is a little-endian list of shortint blocks
(integer/ciphertext/mod.rs:18); the server's ops are blockwise shortint
LUTs, and the independent block PBS of each layer are stacked onto the
batch axis of one keyswitch + PBS call.  `shift_key.py` holds the GGSW
shift key and `wopbs.py` the integer WoP-PBS.
"""
from .ciphertext import BooleanBlock, CrtCiphertext, RadixCiphertext, SignedRadixCiphertext
from .client_key import CrtClientKey, RadixClientKey
from .server_key import ServerKey, gen_keys

__all__ = ["RadixCiphertext", "SignedRadixCiphertext", "BooleanBlock", "CrtCiphertext",
           "RadixClientKey", "CrtClientKey", "ServerKey", "gen_keys"]
