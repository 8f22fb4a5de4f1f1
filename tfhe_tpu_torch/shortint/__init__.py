"""Shortint: message+carry LWE words with lookup-table bootstrapping, on
classic or multi-bit keys; the casting key between two key sets
(`key_switching_key.py`) and the WoP-PBS (`wopbs.py`)."""
from .ciphertext import CheckError, Ciphertext, CompressedCiphertext, MaxNoiseLevel, NoiseLevel
from .client_key import ClientKey, delta_for, gen_client_key, gen_keys
from .key_switching_key import KeySwitchingKey, generate_key_switching_key
from .server_key import (CompressedServerKey, LookupTable, MaxDegree, ServerKey,
                         gen_compressed_server_key, gen_server_key)

__all__ = ["CheckError", "Ciphertext", "CompressedCiphertext", "MaxNoiseLevel", "NoiseLevel",
           "ClientKey", "delta_for", "gen_client_key", "gen_keys", "KeySwitchingKey",
           "generate_key_switching_key", "CompressedServerKey",
           "LookupTable", "MaxDegree", "ServerKey", "gen_compressed_server_key",
           "gen_server_key"]
