"""Shortint: message+carry LWE words with lookup-table bootstrapping."""
from .ciphertext import Ciphertext, NoiseLevel
from .client_key import ClientKey, delta_for, gen_keys
from .server_key import LookupTable, ServerKey, gen_server_key

__all__ = ["Ciphertext", "NoiseLevel", "ClientKey", "delta_for", "gen_keys",
           "LookupTable", "ServerKey", "gen_server_key"]
