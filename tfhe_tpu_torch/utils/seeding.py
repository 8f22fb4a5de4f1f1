"""Secure seeding from OS entropy (counterpart of
`tfhe_tpu/utils/seeding.py`).

The reference pulls seeds from rdseed / /dev/random / SecureEnclave
(concrete-csprng/src/seeders/).  Portable equivalent: `os.urandom`, the
kernel CSPRNG.  The native AES-CTR stream generator
(`tfhe_tpu_torch.native`) can be layered on top where AES-grade expansion
is required.
"""
from __future__ import annotations

import os


def secure_seed(bits: int = 32) -> int:
    """A fresh seed of `bits` bits from OS entropy (reference Seeder::seed)."""
    return int.from_bytes(os.urandom((bits + 7) // 8), "little") & ((1 << bits) - 1)
