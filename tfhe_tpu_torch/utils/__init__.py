"""Utilities: the tfhe_tpu-v1 file format, the key cache and secure
seeding (counterpart of `tfhe_tpu/utils/`)."""
from .keycache import KeyCache
from .seeding import secure_seed
from .serialization import (SERIALIZATION_VERSION, DeserializationError, load, safe_load,
                            safe_save, save)

__all__ = ["SERIALIZATION_VERSION", "DeserializationError", "save", "load", "safe_save",
           "safe_load", "KeyCache", "secure_seed"]
