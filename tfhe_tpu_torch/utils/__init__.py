"""Utilities: the tfhe_tpu-v1 file format (counterpart of
`tfhe_tpu/utils/`; its key cache and secure seeding are ROADMAP A17)."""
from .serialization import SERIALIZATION_VERSION, DeserializationError, load, safe_load, save

__all__ = ["SERIALIZATION_VERSION", "DeserializationError", "save", "load", "safe_load"]
