"""gadget — the odd-plaintext-modulus "p-encodings" Boolean engine (BPR24).

Counterpart of `tfhe_tpu/gadget/` (reference tfhe/src/gadget/): Boolean and
small-arithmetic functions evaluated with a single PBS by encoding Z_o
values into subsets of Z_p for odd p; odd-p accumulators, gadget
execution, LUTs, encoding switching, multi-value bootstrap (MVB), tree
bootstrap, LWE multiplication by GLWE tensor product and the WoP-PBS on
it, on the port's kernels (`engine.py`).
"""
from .encoding import Encoding
from .engine import (Ciphertext, ClientKey, Gadget, ServerKey, decrypt,
                     encrypt_arithmetic, gen_keys)
from .instrument import SerializableCiphertext, load_dumps, measure_noise

__all__ = ["Encoding", "Ciphertext", "ClientKey", "ServerKey", "Gadget",
           "gen_keys", "encrypt_arithmetic", "decrypt",
           "measure_noise", "SerializableCiphertext", "load_dumps"]
