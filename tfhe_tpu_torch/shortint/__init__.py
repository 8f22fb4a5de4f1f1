"""Shortint: message+carry LWE words with lookup-table bootstrapping, on
classic or multi-bit keys."""
from .ciphertext import CheckError, Ciphertext, MaxNoiseLevel, NoiseLevel
from .client_key import ClientKey, delta_for, gen_keys
from .server_key import LookupTable, MaxDegree, ServerKey, gen_server_key

__all__ = ["CheckError", "Ciphertext", "MaxNoiseLevel", "NoiseLevel", "ClientKey",
           "delta_for", "gen_keys", "LookupTable", "MaxDegree", "ServerKey",
           "gen_server_key"]
