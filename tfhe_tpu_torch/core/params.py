"""Typed cryptographic parameter sets.

A copy of `tfhe_tpu/core/params.py` (pure Python, no array library): the
port cannot import it through `tfhe_tpu`, whose package import loads jax.
Frozen dataclasses of plain ints and floats, which fix the shapes of every
tensor and kernel launch.

All named sets from the reference are re-exported with identical names and
values (see generated_params.py, produced by tools/extract_params.py);
tests/test_torch_import.py holds the two tables equal field by field.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

from . import generated_params as _gen

__all__ = [
    "EncryptionKeyChoice",
    "PBSOrder",
    "DecompParams",
    "ClassicPBSParameters",
    "MultiBitPBSParameters",
    "WopbsParameters",
    "BooleanParameters",
    "GadgetParameters",
    "ShortintKeySwitchingParameters",
    "ShortintParameterSet",
    "boolean_params",
    "shortint_params",
    "wopbs_params",
    "gadget_params",
    "ALL_NAMED_PARAMS",
]


class EncryptionKeyChoice:
    """Which key encrypts fresh/intermediate ciphertexts.

    Mirrors reference `EncryptionKeyChoice` (commons/parameters.rs) — `BIG` is
    the GLWE key viewed as an LWE key of size k*N (PBSOrder Keyswitch→PBS),
    `SMALL` is the LWE key (PBSOrder PBS→Keyswitch).
    """

    BIG = "big"
    SMALL = "small"


class PBSOrder:
    KEYSWITCH_BOOTSTRAP = "keyswitch_bootstrap"  # ct under big key: KS then PBS
    BOOTSTRAP_KEYSWITCH = "bootstrap_keyswitch"  # ct under small key: PBS then KS


@dataclass(frozen=True)
class DecompParams:
    """Gadget (signed) decomposition parameters: base 2^base_log, `level` levels."""

    base_log: int
    level: int

    @property
    def base(self) -> int:
        return 1 << self.base_log


def _std_to_modular(std: float, log_q: int) -> float:
    """Std-dev given relative to the torus → absolute in units of q."""
    return std * float(1 << log_q) if log_q < 64 else std * math.ldexp(1.0, 64)


@dataclass(frozen=True)
class CommonPBSParams:
    """Shared fields of every PBS-capable parameter set."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float
    glwe_modular_std_dev: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    encryption_key_choice: str = EncryptionKeyChoice.BIG
    log_q: int = 64  # torus bit-width (boolean scheme uses 32)
    name: str = ""

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def pbs_decomp(self) -> DecompParams:
        return DecompParams(self.pbs_base_log, self.pbs_level)

    @property
    def ks_decomp(self) -> DecompParams:
        return DecompParams(self.ks_base_log, self.ks_level)

    @property
    def pbs_order(self) -> str:
        if self.encryption_key_choice == EncryptionKeyChoice.BIG:
            return PBSOrder.KEYSWITCH_BOOTSTRAP
        return PBSOrder.BOOTSTRAP_KEYSWITCH

    @property
    def lwe_noise_std(self) -> float:
        """Absolute std-dev of LWE encryption noise (units of q)."""
        return _std_to_modular(self.lwe_modular_std_dev, self.log_q)

    @property
    def glwe_noise_std(self) -> float:
        return _std_to_modular(self.glwe_modular_std_dev, self.log_q)


@dataclass(frozen=True)
class ClassicPBSParameters(CommonPBSParams):
    """Shortint classic-PBS parameters (reference shortint/parameters/mod.rs)."""

    message_modulus: int = 4
    carry_modulus: int = 4
    ciphertext_modulus: str = "native"


@dataclass(frozen=True)
class MultiBitPBSParameters(CommonPBSParams):
    message_modulus: int = 4
    carry_modulus: int = 4
    ciphertext_modulus: str = "native"
    grouping_factor: int = 2
    deterministic_execution: bool = False


@dataclass(frozen=True)
class WopbsParameters(CommonPBSParams):
    """WoP-PBS parameters (reference shortint/parameters/parameters_wopbs*.rs)."""

    message_modulus: int = 4
    carry_modulus: int = 4
    ciphertext_modulus: str = "native"
    pfks_level: int = 1
    pfks_base_log: int = 23
    pfks_modular_std_dev: float = 0.0
    cbs_level: int = 1
    cbs_base_log: int = 10

    @property
    def pfks_decomp(self) -> DecompParams:
        return DecompParams(self.pfks_base_log, self.pfks_level)

    @property
    def cbs_decomp(self) -> DecompParams:
        return DecompParams(self.cbs_base_log, self.cbs_level)

    @property
    def pfks_noise_std(self) -> float:
        return _std_to_modular(self.pfks_modular_std_dev, self.log_q)


@dataclass(frozen=True)
class BooleanParameters(CommonPBSParams):
    """Boolean-scheme parameters (reference boolean/parameters/mod.rs:123-136).

    The reference fixes the u32 torus; here the named sets default to the
    64-bit torus so boolean gates ride the fused Pallas blind-rotation
    kernel (64-bit only).  Noise is specified *relative* to q and the ±q/8
    encoding is scale-free, so security and correctness are unchanged by
    the width.  log_q=32 stays fully supported on the XLA path
    (TEST_PARAMS_BOOLEAN_U32 pins it to cover the reference width)."""

    log_q: int = 64


@dataclass(frozen=True)
class GadgetParameters(CommonPBSParams):
    """p-encodings gadget parameters (fork; reference gadget/parameters/mod.rs:84-235).
    Torus is 64-bit like shortint (gadget ciphertexts are LweCiphertextOwned<u64>)."""

    log_q: int = 64


@dataclass(frozen=True)
class ShortintKeySwitchingParameters:
    """Parameters for casting between two shortint key sets
    (reference shortint/parameters/key_switching.rs)."""

    ks_base_log: int
    ks_level: int
    name: str = ""

    @property
    def ks_decomp(self) -> DecompParams:
        return DecompParams(self.ks_base_log, self.ks_level)


@dataclass(frozen=True)
class ShortintParameterSet:
    """Unifies PBS and WoP-PBS parameters like the reference
    `ShortintParameterSet` (shortint/parameters/mod.rs:340)."""

    pbs_params: Optional[ClassicPBSParameters | MultiBitPBSParameters] = None
    wopbs_params: Optional[WopbsParameters] = None

    @classmethod
    def new_pbs_param_set(cls, p):
        return cls(pbs_params=p)

    @classmethod
    def new_wopbs_param_set(cls, p):
        return cls(wopbs_params=p)

    @property
    def ap_params(self) -> CommonPBSParams:
        """Parameters used for the atomic pattern (KS+PBS)."""
        if self.pbs_params is not None:
            return self.pbs_params
        return self.wopbs_params

    @property
    def message_modulus(self) -> int:
        return self.ap_params.message_modulus

    @property
    def carry_modulus(self) -> int:
        return self.ap_params.carry_modulus


_STRUCT_MAP = {
    "BooleanParameters": BooleanParameters,
    "ClassicPBSParameters": ClassicPBSParameters,
    "MultiBitPBSParameters": MultiBitPBSParameters,
    "WopbsParameters": WopbsParameters,
    "GadgetParameters": GadgetParameters,
    "ShortintKeySwitchingParameters": ShortintKeySwitchingParameters,
}


def _materialize(table):
    out = {}
    for name, (struct, fields) in table.items():
        cls = _STRUCT_MAP[struct]
        kwargs = dict(fields)
        kwargs.pop("ciphertext_modulus", None) if "ciphertext_modulus" not in {
            f.name for f in dataclasses.fields(cls)
        } else None
        valid = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in kwargs.items() if k in valid}
        out[name] = cls(name=name, **kwargs)
    return out


BOOLEAN = _materialize(_gen.BOOLEAN_PARAMS)
SHORTINT_CLASSIC = _materialize(_gen.SHORTINT_CLASSIC_PARAMS)
SHORTINT_MULTIBIT = _materialize(_gen.SHORTINT_MULTIBIT_PARAMS)
SHORTINT_COMPACT_PK = _materialize(_gen.SHORTINT_COMPACT_PK_PARAMS)
SHORTINT_WOPBS = _materialize(
    {**_gen.SHORTINT_WOPBS_PARAMS,
     **_gen.SHORTINT_WOPBS_MESSAGE_CARRY_PARAMS,
     **_gen.SHORTINT_WOPBS_PRIME_MODULI_PARAMS}
)
SHORTINT_KS = _materialize(_gen.SHORTINT_KS_PARAMS)
GADGET = _materialize(_gen.GADGET_PARAMS)

ALL_NAMED_PARAMS = {}
for _t in (BOOLEAN, SHORTINT_CLASSIC, SHORTINT_MULTIBIT, SHORTINT_COMPACT_PK,
           SHORTINT_WOPBS, SHORTINT_KS, GADGET):
    ALL_NAMED_PARAMS.update(_t)


def boolean_params(name: str) -> BooleanParameters:
    if name == "TEST_PARAMS_BOOLEAN":    # tiny insecure set (CI/doc tests)
        return TEST_PARAMS_BOOLEAN
    return BOOLEAN[name]


def shortint_params(name: str):
    for t in (SHORTINT_CLASSIC, SHORTINT_MULTIBIT, SHORTINT_COMPACT_PK):
        if name in t:
            return t[name]
    if name == "TEST_PARAMS_SHORTINT":   # tiny insecure set for FFI/CI smoke
        return TEST_PARAMS_SHORTINT
    raise KeyError(name)


def wopbs_params(name: str) -> WopbsParameters:
    if name == "TEST_PARAMS_WOPBS":      # tiny insecure set (CI tests)
        return TEST_PARAMS_WOPBS
    return SHORTINT_WOPBS[name]


def gadget_params(name: str) -> GadgetParameters:
    if name == "TEST_PARAMS_GADGET":     # tiny insecure set (CI/doc tests)
        return TEST_PARAMS_GADGET
    return GADGET[name]


# ---------------------------------------------------------------------------
# Small insecure parameter sets for fast unit tests (tiny lattice dims, tiny
# noise).  The reference uses real parameters + a disk key cache; on a 2-vCPU
# test host we instead shrink the lattice.  NOT SECURE — tests only.
# ---------------------------------------------------------------------------

TEST_PARAMS_SHORTINT = ClassicPBSParameters(
    name="TEST_PARAMS_SHORTINT",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=4.0e-8,
    glwe_modular_std_dev=3.0e-16,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
)

# combined-regime WoP-PBS twin of TEST_PARAMS_SHORTINT (the reference pairs
# PARAM_MESSAGE_2_CARRY_2_KS_PBS with WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS);
# small noise so circuit-bootstrap + vertical-packing chains decode exactly
TEST_PARAMS_WOPBS = WopbsParameters(
    name="TEST_PARAMS_WOPBS",
    lwe_dimension=20,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=4.0e-8,
    glwe_modular_std_dev=3.0e-16,
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=3,
    ks_level=5,
    pfks_base_log=15,
    pfks_level=2,
    pfks_modular_std_dev=3.0e-16,
    cbs_base_log=5,
    cbs_level=3,
    message_modulus=4,
    carry_modulus=4,
)

# 1-bit message + 4x carry: the internal representation for the shortint
# Trivium/Kreyvium streams (the reference uses PARAM_MESSAGE_1_CARRY_1 and
# tolerates degree overflow through the parity LUT's anti-periodicity; with
# exact degree tracking a 2-bit carry headroom keeps every sum in range)
TEST_PARAMS_TRIVIUM = dataclasses.replace(
    TEST_PARAMS_SHORTINT, name="TEST_PARAMS_TRIVIUM",
    message_modulus=2, carry_modulus=4)

TEST_PARAMS_BOOLEAN = BooleanParameters(
    name="TEST_PARAMS_BOOLEAN",
    lwe_dimension=16,
    glwe_dimension=2,
    polynomial_size=64,
    lwe_modular_std_dev=2.0e-6,
    glwe_modular_std_dev=1.0e-8,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

# the reference-width (u32 torus) twin — keeps the 32-bit LWE/PBS path
# covered now that boolean named sets default to log_q=64
TEST_PARAMS_BOOLEAN_U32 = dataclasses.replace(
    TEST_PARAMS_BOOLEAN, name="TEST_PARAMS_BOOLEAN_U32", log_q=32)

# ks decomp is deliberately fine (32 bits): the packing-keyswitch →
# GLWE-tensor-product path (lwe_mult/WoP-PBS) amplifies phase-coefficient
# noise by ~2^(34+log2 N), so the packed GLWE needs ≲2^38 keyswitch noise.
TEST_PARAMS_GADGET = GadgetParameters(
    name="TEST_PARAMS_GADGET",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=4.0e-8,
    glwe_modular_std_dev=3.0e-16,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=8,
)
