"""Flat C-style API surface over the port's hlapi, boolean and shortint
(counterpart of `tfhe_tpu/capi.py`).

The reference exposes C (tfhe/src/c_api/) bindings around the HLAPI.  Here
the host language is Python, so the binding inverts: this module is the
flat opaque-handle surface (create/destroy/op functions returning status
codes) that a ctypes consumer binds against, and that the C ABI
(`native/capi.cpp`, `libtfhe_tpu_torch_capi.so`) reaches by embedding
CPython.  Handles are integers; every function returns (status, result)
with status 0 on success (the reference's opaque pointer + destroy_*
pattern).

Keys and ciphertexts live on the card unless the caller asks for the CPU:
`init()` (which `tfhe_tpu_init` calls) reads TFHE_TPU_TORCH_DEVICE
("cuda" unless set; "cpu" for the CPU) and fails with a clear error when it
names a card and there is none.  A function called before `init` reads it
then.
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Dict

from . import hlapi, shortint
from .core.params import shortint_params
from .cuda_lib import resolve_device

DEVICE_ENV = "TFHE_TPU_TORCH_DEVICE"
_DEVICE = None

_HANDLES: Dict[int, Any] = {}
_NEXT = itertools.count(1)

OK = 0
ERR = 1


def init() -> int:
    """Resolve the device the surface works on from TFHE_TPU_TORCH_DEVICE;
    raises, naming the variable, where it names a card and none exists."""
    global _DEVICE
    name = os.environ.get(DEVICE_ENV, "cuda")
    try:
        _DEVICE = resolve_device(name)
    except RuntimeError as e:
        raise RuntimeError(f"tfhe_tpu_torch C API: {DEVICE_ENV} is {name!r}, but no CUDA "
                           f"device is available; set {DEVICE_ENV}=cpu to run on the "
                           f"CPU") from e
    return OK


def _device():
    if _DEVICE is None:
        init()
    return _DEVICE


def _new(obj) -> int:
    h = next(_NEXT)
    _HANDLES[h] = obj
    return h


def _get(h):
    return _HANDLES[h]


def destroy(handle: int) -> int:
    """reference destroy_* functions."""
    return OK if _HANDLES.pop(handle, None) is not None else ERR


# -- config / keygen --------------------------------------------------------


def config_builder_default() -> tuple[int, int]:
    return OK, _new(hlapi.ConfigBuilder.default())


def config_builder_custom(name: str) -> tuple[int, int]:
    """reference ConfigBuilder::use_custom_parameters; also takes
    TEST_PARAMS_SHORTINT (tiny insecure set) for FFI smoke tests.
    Validates the parameter-set name eagerly so an unknown name returns ERR
    here rather than surfacing later at tfhe_generate_keys."""
    try:
        shortint_params(name)  # raises on an unknown name
        cfg = hlapi.ConfigBuilder().use_custom_parameters(name).build()
        return OK, _new(cfg)
    except Exception:
        return ERR, 0


def generate_keys(config_handle: int, seed: int = 0) -> tuple[int, int, int]:
    try:
        ck, sk = hlapi.generate_keys(_get(config_handle), seed=seed, device=_device())
        return OK, _new(ck), _new(sk)
    except Exception:
        return ERR, 0, 0


def set_server_key(sk_handle: int) -> int:
    hlapi.set_server_key(_get(sk_handle))
    return OK


# -- FheUint widths (reference c_api covers u8..u256; stamped per width) -----

_BINOPS = {"add": "__add__", "sub": "__sub__", "mul": "__mul__",
           "bitand": "__and__", "bitor": "__or__", "bitxor": "__xor__",
           "eq": "eq", "le": "le"}


def _binop(name):
    def op(lhs: int, rhs: int) -> tuple[int, int]:
        try:
            a, b = _get(lhs), _get(rhs)
            return OK, _new(getattr(a, name)(b))
        except Exception:
            return ERR, 0
    return op


def _register_width(bits: int):
    """Stamp the fheuint{bits}_* function family (the Python analogue of the
    reference's per-type c_api macro expansion)."""
    cls = getattr(hlapi, f"FheUint{bits}")
    g = globals()
    pre = f"fheuint{bits}_"

    def encrypt(value: int, ck_handle: int, seed: int = 0) -> tuple[int, int]:
        try:
            ct = cls.encrypt(int(value) & ((1 << 64) - 1), _get(ck_handle), seed=seed)
            return OK, _new(ct)
        except Exception:
            return ERR, 0

    def decrypt(ct_handle: int, ck_handle: int) -> tuple[int, int]:
        try:
            return OK, int(_get(ct_handle).decrypt(_get(ck_handle)))
        except Exception:
            return ERR, 0

    def scalar_add(lhs: int, scalar: int) -> tuple[int, int]:
        try:
            return OK, _new(_get(lhs) + int(scalar))
        except Exception:
            return ERR, 0

    def deserialize(data: bytes) -> tuple[int, int]:
        import io
        from .utils import load
        try:
            return OK, _new(cls(load(io.BytesIO(data), device=_device())))
        except Exception:
            return ERR, 0

    g[pre + "try_encrypt_with_client_key"] = encrypt
    g[pre + "decrypt"] = decrypt
    g[pre + "scalar_add"] = scalar_add
    g[f"deserialize_fheuint{bits}"] = deserialize
    for cname, pyname in _BINOPS.items():
        g[pre + cname] = _binop(pyname)


for _bits in (8, 16, 32, 64):
    _register_width(_bits)


def _register_signed_width(bits: int):
    """fheint{bits}_* family (reference c_api signed integer types).
    Values cross the ABI as two's-complement u64."""
    cls = getattr(hlapi, f"FheInt{bits}")
    g = globals()
    pre = f"fheint{bits}_"
    mask = (1 << bits) - 1

    def encrypt(value: int, ck_handle: int, seed: int = 0) -> tuple[int, int]:
        try:
            v = int(value) & mask                  # two's complement in
            if v >= 1 << (bits - 1):
                v -= 1 << bits
            ct = cls.encrypt(v, _get(ck_handle), seed=seed)
            return OK, _new(ct)
        except Exception:
            return ERR, 0

    def decrypt(ct_handle: int, ck_handle: int) -> tuple[int, int]:
        try:
            v = int(_get(ct_handle).decrypt(_get(ck_handle)))
            return OK, v & ((1 << 64) - 1)         # two's complement out
        except Exception:
            return ERR, 0

    g[pre + "try_encrypt_with_client_key"] = encrypt
    g[pre + "decrypt"] = decrypt
    for cname, pyname in (("add", "__add__"), ("sub", "__sub__"),
                          ("mul", "__mul__"), ("neg", "__neg__")):
        if cname == "neg":
            def neg(ct_handle: int) -> tuple[int, int]:
                try:
                    return OK, _new(-_get(ct_handle))
                except Exception:
                    return ERR, 0
            g[pre + "neg"] = neg
        else:
            g[pre + cname] = _binop(pyname)


for _bits in (32, 64):
    _register_signed_width(_bits)


def _register_wide_width(bits: int):
    """fheuint{128,256}_* family: values cross the ABI as little-endian
    u64 words (the reference's U128/U256 c_api structs)."""
    cls = getattr(hlapi, f"FheUint{bits}")
    g = globals()
    pre = f"fheuint{bits}_"
    words = bits // 64

    def encrypt(*args) -> tuple[int, int]:
        # args = (w0, ..., w_{words-1}, ck_handle[, seed])
        try:
            ws = [int(a) for a in args[:words]]
            ck_handle = args[words]
            seed = int(args[words + 1]) if len(args) > words + 1 else 0
            value = sum(w << (64 * i) for i, w in enumerate(ws))
            ct = cls.encrypt(value, _get(ck_handle), seed=seed)
            return OK, _new(ct)
        except Exception:
            return ERR, 0

    def decrypt(ct_handle: int, ck_handle: int) -> tuple:
        try:
            v = int(_get(ct_handle).decrypt(_get(ck_handle)))
            return (OK,) + tuple((v >> (64 * i)) & ((1 << 64) - 1)
                                 for i in range(words))
        except Exception:
            return (ERR,) + (0,) * words

    g[pre + "try_encrypt_with_client_key"] = encrypt
    g[pre + "decrypt"] = decrypt
    for cname, pyname in (("add", "__add__"), ("sub", "__sub__"),
                          ("bitxor", "__xor__"), ("bitand", "__and__")):
        g[pre + cname] = _binop(pyname)


for _bits in (128, 256):
    _register_wide_width(_bits)


# -- boolean surface (reference c_api/boolean/) ------------------------------


def boolean_gen_keys(name: str, seed: int = 0) -> tuple[int, int, int]:
    try:
        from . import boolean as B
        from .core.params import TEST_PARAMS_BOOLEAN
        params = TEST_PARAMS_BOOLEAN if name == "TEST_PARAMS_BOOLEAN" else name
        ck, sk = B.gen_keys(params, seed=seed, device=_device())
        return OK, _new(ck), _new(sk)
    except Exception:
        return ERR, 0, 0


def boolean_encrypt(value: int, ck_handle: int, seed: int = 0) -> tuple[int, int]:
    try:
        from . import boolean as B
        ct = B.encrypt(_get(ck_handle), bool(value), seed=seed)
        return OK, _new(ct)
    except Exception:
        return ERR, 0


def boolean_decrypt(ct_handle: int, ck_handle: int) -> tuple[int, int]:
    try:
        from . import boolean as B
        return OK, int(bool(B.decrypt(_get(ck_handle), _get(ct_handle))))
    except Exception:
        return ERR, 0


def _boolean_gate(gate: str):
    def op(sk_handle: int, lhs: int, rhs: int) -> tuple[int, int]:
        try:
            from . import boolean as B
            fn = getattr(B, gate)
            return OK, _new(fn(_get(sk_handle), _get(lhs), _get(rhs)))
        except Exception:
            return ERR, 0
    return op


boolean_and = _boolean_gate("and_")
boolean_or = _boolean_gate("or_")
boolean_xor = _boolean_gate("xor")
boolean_nand = _boolean_gate("nand")
boolean_nor = _boolean_gate("nor")
boolean_xnor = _boolean_gate("xnor")


def boolean_not(sk_handle: int, ct: int) -> tuple[int, int]:
    try:
        from . import boolean as B
        return OK, _new(B.not_(_get(ct)))
    except Exception:
        return ERR, 0


def boolean_mux(sk_handle: int, cond: int, then_ct: int,
                else_ct: int) -> tuple[int, int]:
    try:
        from . import boolean as B
        return OK, _new(B.mux(_get(sk_handle), _get(cond), _get(then_ct),
                              _get(else_ct)))
    except Exception:
        return ERR, 0


# -- shortint surface (reference c_api/shortint/) ----------------------------


def shortint_gen_keys(name: str, seed: int = 0) -> tuple[int, int, int]:
    try:
        from .core.params import TEST_PARAMS_SHORTINT
        params = (TEST_PARAMS_SHORTINT if name == "TEST_PARAMS_SHORTINT"
                  else shortint_params(name))
        ck, sk = shortint.gen_keys(params, seed=seed, device=_device())
        return OK, _new(ck), _new(sk)
    except Exception:
        return ERR, 0, 0


def shortint_encrypt(value: int, ck_handle: int, seed: int = 0) -> tuple[int, int]:
    try:
        ct = _get(ck_handle).encrypt(int(value), seed=seed)
        return OK, _new(ct)
    except Exception:
        return ERR, 0


def shortint_decrypt(ct_handle: int, ck_handle: int) -> tuple[int, int]:
    try:
        return OK, int(_get(ck_handle).decrypt(_get(ct_handle)))
    except Exception:
        return ERR, 0


def _shortint_op(opname: str):
    def op(sk_handle: int, lhs: int, rhs: int) -> tuple[int, int]:
        try:
            sk = _get(sk_handle)
            return OK, _new(getattr(sk, opname)(_get(lhs), _get(rhs)))
        except Exception:
            return ERR, 0
    return op


shortint_add = _shortint_op("add")
shortint_sub = _shortint_op("sub")
shortint_mul = _shortint_op("mul_lsb")
shortint_bitand = _shortint_op("bitand")
shortint_bitxor = _shortint_op("bitxor")
shortint_greater = _shortint_op("greater")


def shortint_scalar_add(sk_handle: int, lhs: int, scalar: int) -> tuple[int, int]:
    try:
        return OK, _new(_get(sk_handle).scalar_add(_get(lhs), int(scalar)))
    except Exception:
        return ERR, 0


# -- serialization -----------------------------------------------------------


def serialize(handle: int) -> tuple[int, bytes]:
    import io
    from .utils import save
    try:
        buf = io.BytesIO()
        obj = _get(handle)
        save(obj.ct if hasattr(obj, "ct") else obj, buf)
        return OK, buf.getvalue()
    except Exception:
        return ERR, b""


def deserialize_shortint(data: bytes) -> tuple[int, int]:
    import io
    from .utils import load
    try:
        return OK, _new(load(io.BytesIO(data), device=_device()))
    except Exception:
        return ERR, 0

# -- compressed / compact keys and ciphertexts over the ABI ------------------
# (reference c_api: compressed_server_key.rs, compact_public_key ops in
#  high_level_api/keys, compressed integers in high_level_api/integers/)


def compressed_server_key_new(ck_handle: int, seed: int = 3) -> tuple[int, int]:
    try:
        return OK, _new(hlapi.CompressedServerKey(_get(ck_handle),
                                                  seed=int(seed)))
    except Exception:
        return ERR, 0


def compressed_server_key_decompress(h: int) -> tuple[int, int]:
    try:
        return OK, _new(_get(h).decompress())
    except Exception:
        return ERR, 0


def compact_public_key_new(ck_handle: int, seed: int = 2) -> tuple[int, int]:
    try:
        return OK, _new(hlapi.CompactPublicKey(_get(ck_handle), seed=int(seed)))
    except Exception:
        return ERR, 0


def _register_compressed_width(bits: int):
    import math as _math
    cls = getattr(hlapi, f"FheUint{bits}")
    g = globals()

    def enc_compressed(value: int, ck_handle: int, seed: int = 1) -> tuple[int, int]:
        try:
            return OK, _new(hlapi.CompressedFheUint.encrypt(
                int(value), _get(ck_handle), cls, seed=int(seed)))
        except Exception:
            return ERR, 0

    def decompress(h: int) -> tuple[int, int]:
        try:
            return OK, _new(_get(h).decompress())
        except Exception:
            return ERR, 0

    def enc_compact(value: int, pk_handle: int, seed: int = 0) -> tuple[int, int]:
        try:
            pk = _get(pk_handle)
            nb = bits // int(_math.log2(pk.params.message_modulus))
            return OK, _new(cls(pk.encrypt_radix(int(value), nb,
                                                 seed=int(seed))))
        except Exception:
            return ERR, 0

    g[f"compressed_fheuint{bits}_try_encrypt_with_client_key"] = enc_compressed
    g[f"compressed_fheuint{bits}_decompress"] = decompress
    g[f"fheuint{bits}_try_encrypt_with_compact_public_key"] = enc_compact


for _bits in (8, 32):
    _register_compressed_width(_bits)
