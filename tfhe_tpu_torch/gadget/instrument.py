"""Noise measurement and ciphertext dumps for the gadget module.

Counterpart of `tfhe_tpu/gadget/instrument.py`:

- ``measure_noise``: the signed distance of each phase from its nearest
  Z_p slot, in torus units x p (reference ``GadgetEngine::measure_noise``,
  gadget/engine/mod.rs:194-232), exact in Python ints on the host;
- the dump hook: when the ``PATTERN`` environment variable equals the
  pattern's name, a record is appended to ``<name>.pkl`` under
  ``TFHE_TPU_DUMP_DIR`` (default
  ``data_generation/noise_measurements/serializations``), one
  ``pickle.dump`` of a plain dict a record whose ``values`` are the LWE's
  uint64 words as a numpy array (reference
  ``SerializableCiphertext::append_to_file``, gadget/ciphertext/mod.rs:283-301).
  The records are the JAX package's, so each package's ``load_dumps``
  reads the other's files.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from ..core.algorithms import decrypt_lwe
from ..core.numeric import LOG_Q, to_numpy_u64
from .engine import Ciphertext, ClientKey

DUMP_DIR_ENV = "TFHE_TPU_DUMP_DIR"
PATTERN_ENV = "PATTERN"
_DEFAULT_DUMP_DIR = os.path.join("data_generation", "noise_measurements", "serializations")


def measure_noise(ck: ClientKey, ct: Ciphertext) -> np.ndarray:
    """Signed noise of every ciphertext in the batch, in torus units x p
    (the reference's scale: ``round((closest - phase*p/2^64) * 2^64)``):
    int64 numpy [...] of the batch's shape.  A fresh encryption at noise
    std sigma measures ~ sigma * p * 2^64 here."""
    phase = to_numpy_u64(decrypt_lwe(ct.lwe, ck.encryption_key))
    p = int(ct.encoding.modulus_p)
    q = 1 << LOG_Q
    flat = phase.reshape(-1)
    out = np.empty(flat.shape, dtype=np.int64)
    for i, ph in enumerate(flat):
        centered = ((int(ph) * p + (q >> 1)) % q) - (q >> 1)
        out[i] = -centered       # k*2^64 - phase*p for k = round(phase*p/2^64)
    return out.reshape(phase.shape)


@dataclass
class SerializableCiphertext:
    """Dump record (reference SerializableCiphertext,
    gadget/ciphertext/mod.rs:270-277): the raw torus words, the expected
    message and the encoding's modulus."""

    values: np.ndarray            # uint64 [..., n+1] raw LWE words
    expected_msg: int
    modulus: int                  # the encoding's Z_p modulus (0 if unknown)
    log_ciphertext_modulus: int = LOG_Q

    @classmethod
    def from_ciphertext(cls, ct: Ciphertext, expected_msg: int) -> "SerializableCiphertext":
        return cls(values=to_numpy_u64(ct.lwe.data), expected_msg=int(expected_msg),
                   modulus=int(ct.encoding.modulus_p))

    def append_to_file(self, pattern_name: str, dump_dir: Optional[str] = None) -> bool:
        """Append this record iff PATTERN == pattern_name.  An unset PATTERN
        is a no-op, not a panic as in the reference.  True when a record was
        written."""
        pattern = os.environ.get(PATTERN_ENV)
        if pattern is None or pattern != pattern_name:
            return False
        base = dump_dir or os.environ.get(DUMP_DIR_ENV, _DEFAULT_DUMP_DIR)
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, f"{pattern_name}.pkl"), "ab") as f:
            pickle.dump({"values": self.values, "expected_msg": self.expected_msg,
                         "modulus": self.modulus,
                         "log_ciphertext_modulus": self.log_ciphertext_modulus}, f)
        return True


def iter_dumps(path: str) -> Iterator[dict]:
    """Read back a pickle-framed dump stream (one dict per record)."""
    with open(path, "rb") as f:
        while True:
            try:
                yield pickle.load(f)
            except EOFError:
                return


def load_dumps(path: str) -> List[dict]:
    return list(iter_dumps(path))
