"""Shortint: message+carry LWE words with lookup-table bootstrapping, on
classic or multi-bit keys."""
from .ciphertext import CheckError, Ciphertext, CompressedCiphertext, MaxNoiseLevel, NoiseLevel
from .client_key import ClientKey, delta_for, gen_client_key, gen_keys
from .server_key import (CompressedServerKey, LookupTable, MaxDegree, ServerKey,
                         gen_compressed_server_key, gen_server_key)

__all__ = ["CheckError", "Ciphertext", "CompressedCiphertext", "MaxNoiseLevel", "NoiseLevel",
           "ClientKey", "delta_for", "gen_client_key", "gen_keys", "CompressedServerKey",
           "LookupTable", "MaxDegree", "ServerKey", "gen_compressed_server_key",
           "gen_server_key"]
