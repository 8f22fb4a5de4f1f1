"""The `tfhe_tpu-v1` file format, read and written without jax.

Counterpart of `tfhe_tpu/utils/serialization.py`: an .npz archive of numpy
arrays plus a `__meta__` entry, the JSON of {"version", "type", "tree"}.
The tree's nodes are literals ("lit"), arrays by key ("arr"), lists and
tuples, objects ("obj": the JAX package's type name and its fields) and
"derived" fields (an NTT key's phase tables, regenerated by the reader;
the port builds its own spectra, so it drops them).  No pickle anywhere.

Reading maps each JAX type name to the port's type (`_READERS`), on the
device asked for (the card unless given device="cpu"; without a card that
raises).  Torus words cross as uint64 ↔ int64 bit patterns and secret-key
bits as int8 ↔ int64; the 32-bit torus's words as uint32 ↔ lifted int64
(`core/numeric.py`): a reader lifts every uint32 array, and a writer drops
the words of an object whose width (its `log_q`, or its parameters') is
32, and of everything inside it.  A JAX `NttLweBootstrapKey` or
`NttMultiBitBootstrapKey` crosses through its DIF-order residues
(`interop`), which must be residues over primes_for(N) whose lift is a
64-bit word: the file does not name its prime pool (ROADMAP C2), so a key
made on another pool is refused here, not decrypted as garbage.  A key
with no DIF residues (the JAX "fourstep" slim form) is refused by name.  A
gadget encoding (an "encoding" node) becomes the port's `Encoding`.

Writing covers every type the JAX registry names (`_WRITERS`):
ciphertexts, seeded entities, compressed ciphertexts and keys, public keys
and the WoP-PBS's PFPKSK list, under the JAX package's type names, so
`tfhe_tpu.utils.safe_load` reads them (the boolean `CompressedCiphertext`
is left out: the JAX package's registry has no entry for it, so neither
package can read it); and the gadget fork's `Ciphertext` (with its
encoding), `ClientKey` (secret-key bits as int8) and `ServerKey`, whose
BSK is written as a JAX `NttLweBootstrapKey` of its residues and their
Shoup quotients (`_ntt_key_fields`: the port's spectral order is the JAX
package's DIF order, which tests/test_torch_serialization.py holds) with
no paired form, so the JAX package runs it on its XLA route; the shortint
and integer `ServerKey`s, the WoP-PBS keys and the GGSW shift
key (`ShiftKey`) in the same way, an object met twice written once (the shift
key shares its two BSKs); the standard-domain `LweBootstrapKey`, the
multi-bit NTT key (its residues and Shoup quotients, no 32-bit copies, so
the JAX package runs it on XLA), the boolean and shortint `ClientKey`s, the
boolean `ServerKey` and the `LookupTable`.  A 32-bit boolean server key's
BSK is written as the JAX package holds it: the residues of its dropped
words over the 32-bit prime count.  `safe_save` is `save`, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..core.numeric import drop32, from_numpy_torus, to_numpy_torus

SERIALIZATION_VERSION = "tfhe_tpu-v1"


class DeserializationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# the types: JAX names → readers, port classes → JAX names
# ---------------------------------------------------------------------------

_READERS: Dict[str, Callable] = {}
_WRITERS: Dict[type, str] = {}
# types written with fields of their own making: type → obj → {field: value}
_WRITE_FIELDS: Dict[type, Callable] = {}


def _words(a, device) -> torch.Tensor:
    """Torus words (uint64 numpy, or uint32 lifted) → int64 bit patterns on
    `device`."""
    return from_numpy_torus(a, device)


def _bits(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def _dif_key(f: dict, device):
    """A JAX NttLweBootstrapKey → the port's, through its DIF residues (of
    32-bit words at log_q = 32: the key is lifted, `interop`)."""
    from .. import interop
    from ..core.poly import ntt
    decomp = f["decomp"]
    if f.get("data") is not None:
        data = np.asarray(f["data"])
        primes = ntt.primes_for(data.shape[-1])[:data.shape[1]]
        return _check_pool(lambda: interop.bootstrap_key_from_dif(
            data, primes, decomp, device, f.get("log_q", 64)))
    order = f.get("paired_order", "dif")
    if order == "dif" and f.get("paired") is not None:
        paired = np.asarray(f["paired"])
        primes = ntt.primes_for(paired.shape[-1])[:paired.shape[2]]
        return _check_pool(lambda: interop.paired_bootstrap_key_from_dif(paired, primes,
                                                                         decomp, device))
    raise DeserializationError(f"an NttLweBootstrapKey in {order!r} order without its DIF "
                               f"residues: the port converts only the DIF order")


def _multi_bit_dif_key(f: dict, device):
    from .. import interop
    from ..core.poly import ntt
    if f.get("data") is None:
        raise DeserializationError(f"an NttMultiBitBootstrapKey in {f.get('u32_order')!r} "
                                   f"order without its DIF residues: the port converts only "
                                   f"the DIF order")
    data = np.asarray(f["data"])
    primes = ntt.primes_for(data.shape[-1])[:data.shape[2]]
    return _check_pool(lambda: interop.multi_bit_bootstrap_key_from_dif(
        data, primes, f["decomp"], f["grouping_factor"], device))


def _check_pool(convert):
    try:
        return convert()
    except ValueError as e:
        raise DeserializationError(f"the key's residues are not those of primes_for(N) "
                                   f"(ROADMAP C2: the file does not name its prime pool): "
                                   f"{e}") from e


def _with_shoup(spectra: torch.Tensor, prime_axis: int) -> tuple:
    """Spectra (int32 residues) → (u64 residues, their Shoup quotients
    floor(v * 2^32 / p)), as the JAX keys hold them."""
    from ..core.poly import ntt
    data = spectra.detach().cpu().numpy().astype(np.uint64)
    P = data.shape[prime_axis]
    primes = np.asarray(ntt.get_plan(data.shape[-1], P).primes, dtype=np.uint64)
    shape = [1] * data.ndim
    shape[prime_axis] = P
    return data, (data << np.uint64(32)) // primes.reshape(shape)


def _spectra_32(key) -> torch.Tensor:
    """A lifted 32-bit key's spectra → those of its dropped words over the
    JAX package's 32-bit prime count (the words inverted from the spectra,
    exact: the port's prime count covers the 64-bit lift)."""
    from ..core.algorithms.bootstrap import external_product_num_primes
    from ..core.algorithms.encryption import ggsw_spectra
    from ..core.poly import ntt
    n_in, P, J, R, N = key.spectra.shape
    plan = ntt.get_plan(N, P)
    res = key.spectra.to(torch.int64).permute(0, 2, 3, 1, 4)         # [n, J, R, P, N]
    words = ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, res))     # [n, J, R, N]
    words = drop32(words).reshape(n_in, J // R, R, R, N)
    return ggsw_spectra(words, external_product_num_primes(N, R, key.decomp, 32))


def _ntt_key_fields(key) -> dict:
    """A port NttBootstrapKey → the fields of a JAX NttLweBootstrapKey: the
    residues [n, P, J, R, N] u64 (pair1, GGSW(s_i), of a paired key; those
    of the dropped words for a lifted 32-bit key) and their Shoup quotients
    floor(v * 2^32 / p), no paired form."""
    log_q = 32 if key.route == "rotate" else 64
    spectra = (_spectra_32(key) if log_q == 32 else
               key.spectra[:, 1] if key.paired else key.spectra)
    data, shoup = _with_shoup(spectra, 1)
    return {"data": data, "shoup": shoup, "paired": None, "paired_shoup": None, "mono": None,
            "mono_shoup": None, "decomp": key.decomp, "log_q": log_q, "paired_order": "dif"}


def _multi_bit_key_fields(key) -> dict:
    """A port NttMultiBitBootstrapKey → the fields of a JAX one: residues
    [n/g, 2^g, P, J, R, N] u64 and their Shoup quotients, no u32 copies."""
    data, shoup = _with_shoup(key.spectra, 2)
    return {"data": data, "shoup": shoup, "data_u32": None, "shoup_u32": None, "mono": None,
            "mono_shoup": None, "decomp": key.decomp, "grouping_factor": key.grouping_factor,
            "log_q": 64, "u32_order": "dif"}


def _secret_key_fields(key) -> dict:
    return {"bits": key.bits.detach().cpu().numpy().astype(np.int8)}


def _register():
    """Fill _READERS, _WRITERS and _WRITE_FIELDS (once, at first use: the
    scheme modules import this package's core)."""
    if _READERS:
        return
    from .. import boolean, integer, shortint
    from ..gadget import engine as GE
    from ..integer import shift_key as SK
    from ..core import entities as E
    from ..core import params as Pm
    from ..core.algorithms import keyswitch, public_key as PK, seeded as S, wopbs as W
    from ..shortint import ciphertext as SC, server_key as SS, wopbs as SW

    def plain(cls, words=(), bits=()):
        """A reader that builds cls from its fields, words and bits
        converted to tensors on the device."""
        def read(f, device):
            f = dict(f)
            for k in words:
                if f.get(k) is not None:
                    f[k] = _words(f[k], device)
            for k in bits:
                f[k] = _bits(f[k], device)
            return cls(**f)
        return read

    core = "tfhe_tpu.core.entities."
    seeded = "tfhe_tpu.core.algorithms.seeded."
    _READERS.update({
        core + "LweCiphertext": plain(E.LweCiphertext, words=("data",)),
        core + "LweSecretKey": plain(E.LweSecretKey, bits=("bits",)),
        core + "GlweCiphertext": plain(E.GlweCiphertext, words=("data",)),
        core + "GlweSecretKey": plain(E.GlweSecretKey, bits=("bits",)),
        core + "GgswCiphertext": plain(E.GgswCiphertext, words=("data",)),
        core + "LweBootstrapKey": plain(E.LweBootstrapKey, words=("data",)),
        core + "NttLweBootstrapKey": _dif_key,
        core + "LweKeyswitchKey": lambda f, device: keyswitch.keyswitch_key(
            _words(f["data"], device), f["decomp"]),
        core + "LwePackingKeyswitchKey": plain(E.LwePackingKeyswitchKey, words=("data",)),
        core + "GlweRelinearizationKey": plain(E.GlweRelinearizationKey, words=("data",)),
        "tfhe_tpu.core.algorithms.multi_bit.NttMultiBitBootstrapKey": _multi_bit_dif_key,
        "tfhe_tpu.core.algorithms.public_key.LwePublicKey": plain(PK.LwePublicKey,
                                                                  words=("data",)),
        "tfhe_tpu.core.algorithms.public_key.LweCompactPublicKey": plain(
            PK.LweCompactPublicKey, words=("data",)),
        "tfhe_tpu.boolean.BoolCiphertext": lambda f, device: boolean.BoolCiphertext(
            lwe=f["lwe"], log_q=f.get("log_q", 64)),
        "tfhe_tpu.boolean.ClientKey": plain(boolean.ClientKey),
        "tfhe_tpu.boolean.ServerKey": plain(boolean.ServerKey),
        "tfhe_tpu.boolean.CompressedServerKey": plain(boolean.CompressedServerKey),
        "tfhe_tpu.boolean.CompressedPublicKey": plain(boolean.CompressedPublicKey),
        "tfhe_tpu.boolean.PublicKey": plain(boolean.PublicKey),
        "tfhe_tpu.shortint.ciphertext.Ciphertext": plain(SC.Ciphertext),
        "tfhe_tpu.shortint.ciphertext.CompressedCiphertext": plain(SC.CompressedCiphertext),
        "tfhe_tpu.shortint.client_key.ClientKey": plain(shortint.ClientKey),
        "tfhe_tpu.shortint.server_key.ServerKey": plain(SS.ServerKey),
        "tfhe_tpu.shortint.server_key.CompressedServerKey": plain(SS.CompressedServerKey),
        "tfhe_tpu.shortint.server_key.LookupTable": plain(SS.LookupTable),
        "tfhe_tpu.integer.ciphertext.RadixCiphertext": plain(integer.RadixCiphertext),
        "tfhe_tpu.integer.ciphertext.SignedRadixCiphertext": plain(
            integer.SignedRadixCiphertext),
        "tfhe_tpu.integer.ciphertext.CrtCiphertext": lambda f, device: integer.CrtCiphertext(
            blocks=f["blocks"], moduli=tuple(f["moduli"])),
        "tfhe_tpu.integer.server_key.ServerKey": plain(integer.ServerKey),
        "tfhe_tpu.integer.shift_key.ShiftKey": plain(SK.ShiftKey),
        "tfhe_tpu.core.algorithms.wopbs.CbsPfpkskList": plain(W.CbsPfpkskList,
                                                              words=("data",)),
        "tfhe_tpu.shortint.wopbs.WopbsKey": plain(SW.WopbsKey),
        "tfhe_tpu.shortint.wopbs.CombinedWopbsKey": plain(SW.CombinedWopbsKey),
        "tfhe_tpu.gadget.engine.Ciphertext": plain(GE.Ciphertext),
        "tfhe_tpu.gadget.engine.ClientKey": plain(GE.ClientKey),
        "tfhe_tpu.gadget.engine.ServerKey": plain(GE.ServerKey),
    })
    for name in ("SeededLweCiphertext", "SeededGlweCiphertext", "SeededLweCompactPublicKey"):
        _READERS[seeded + name] = plain(getattr(S, name), words=("body",))
    for name in ("SeededLweBootstrapKey", "SeededLweKeyswitchKey", "SeededGgswCiphertextList",
                 "SeededLweMultiBitBootstrapKey", "SeededLwePackingKeyswitchKey",
                 "SeededLwePublicKey"):
        _READERS[seeded + name] = plain(getattr(S, name), words=("bodies",))
    for name in ("DecompParams", "ClassicPBSParameters", "MultiBitPBSParameters",
                 "WopbsParameters", "BooleanParameters", "GadgetParameters"):
        _READERS["tfhe_tpu.core.params." + name] = plain(getattr(Pm, name))

    _WRITERS.update({
        E.LweCiphertext: core + "LweCiphertext", E.GlweCiphertext: core + "GlweCiphertext",
        E.GgswCiphertext: core + "GgswCiphertext", E.LweBootstrapKey: core + "LweBootstrapKey",
        E.NttMultiBitBootstrapKey: "tfhe_tpu.core.algorithms.multi_bit.NttMultiBitBootstrapKey",
        boolean.ClientKey: "tfhe_tpu.boolean.ClientKey",
        boolean.ServerKey: "tfhe_tpu.boolean.ServerKey",
        shortint.ClientKey: "tfhe_tpu.shortint.client_key.ClientKey",
        SS.LookupTable: "tfhe_tpu.shortint.server_key.LookupTable",
        PK.LwePublicKey: "tfhe_tpu.core.algorithms.public_key.LwePublicKey",
        PK.LweCompactPublicKey: "tfhe_tpu.core.algorithms.public_key.LweCompactPublicKey",
        boolean.BoolCiphertext: "tfhe_tpu.boolean.BoolCiphertext",
        boolean.PublicKey: "tfhe_tpu.boolean.PublicKey",
        boolean.CompressedServerKey: "tfhe_tpu.boolean.CompressedServerKey",
        boolean.CompressedPublicKey: "tfhe_tpu.boolean.CompressedPublicKey",
        SC.Ciphertext: "tfhe_tpu.shortint.ciphertext.Ciphertext",
        SC.CompressedCiphertext: "tfhe_tpu.shortint.ciphertext.CompressedCiphertext",
        SS.CompressedServerKey: "tfhe_tpu.shortint.server_key.CompressedServerKey",
        integer.RadixCiphertext: "tfhe_tpu.integer.ciphertext.RadixCiphertext",
        integer.SignedRadixCiphertext: "tfhe_tpu.integer.ciphertext.SignedRadixCiphertext",
        integer.CrtCiphertext: "tfhe_tpu.integer.ciphertext.CrtCiphertext",
        W.CbsPfpkskList: "tfhe_tpu.core.algorithms.wopbs.CbsPfpkskList",
        SS.ServerKey: "tfhe_tpu.shortint.server_key.ServerKey",
        SW.WopbsKey: "tfhe_tpu.shortint.wopbs.WopbsKey",
        SW.CombinedWopbsKey: "tfhe_tpu.shortint.wopbs.CombinedWopbsKey",
        SK.ShiftKey: "tfhe_tpu.integer.shift_key.ShiftKey",
        integer.ServerKey: "tfhe_tpu.integer.server_key.ServerKey",
        GE.Ciphertext: "tfhe_tpu.gadget.engine.Ciphertext",
        GE.ClientKey: "tfhe_tpu.gadget.engine.ClientKey",
        GE.ServerKey: "tfhe_tpu.gadget.engine.ServerKey",
        E.LweSecretKey: core + "LweSecretKey", E.GlweSecretKey: core + "GlweSecretKey",
        E.LweKeyswitchKey: core + "LweKeyswitchKey",
        E.LwePackingKeyswitchKey: core + "LwePackingKeyswitchKey",
        E.GlweRelinearizationKey: core + "GlweRelinearizationKey",
        E.NttBootstrapKey: core + "NttLweBootstrapKey",
    })
    _WRITE_FIELDS.update({
        E.LweSecretKey: _secret_key_fields, E.GlweSecretKey: _secret_key_fields,
        E.LweKeyswitchKey: lambda k: {"data": k.data, "decomp": k.decomp},
        E.NttBootstrapKey: _ntt_key_fields, E.NttMultiBitBootstrapKey: _multi_bit_key_fields,
        boolean.BoolCiphertext: lambda c: {"lwe": c.lwe},
    })
    for name in S.__all__:
        if name.startswith("Seeded"):
            _WRITERS[getattr(S, name)] = seeded + name
    for name in ("DecompParams", "ClassicPBSParameters", "MultiBitPBSParameters",
                 "WopbsParameters", "BooleanParameters", "GadgetParameters"):
        _WRITERS[getattr(Pm, name)] = "tfhe_tpu.core.params." + name


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def _holds_uint32(node, arrays) -> bool:
    """Whether an array under this tree node holds uint32 words."""
    if node["t"] == "arr":
        return arrays[node["k"]].dtype == np.uint32
    children = (node["fields"].values() if node["t"] == "obj" else
                node["v"] if node["t"] in ("list", "tuple") else ())
    return any(_holds_uint32(c, arrays) for c in children)


def _decode(node, arrays, device):
    t = node["t"]
    if t == "lit":
        return node["v"]
    if t == "arr":
        return arrays[node["k"]]
    if t in ("list", "tuple"):
        vals = [_decode(x, arrays, device) for x in node["v"]]
        return vals if t == "list" else tuple(vals)
    if t == "derived":
        return None
    if t == "encoding":
        from ..gadget.encoding import Encoding
        return Encoding(node["o"], node["parts"], node["p"], wopbs=node["wopbs"],
                        _validate=False)
    if t == "obj":
        name = node["cls"]
        _register()
        read = _READERS.get(name)
        if read is None:
            raise DeserializationError(f"unknown type {name}")
        fields = {k: _decode(v, arrays, device) for k, v in node["fields"].items()}
        if name == "tfhe_tpu.boolean.BoolCiphertext":
            # the JAX type has no width field: its words' dtype is the width
            fields["log_q"] = 32 if _holds_uint32(node, arrays) else 64
        try:
            return read(fields, device)
        except (NotImplementedError, TypeError) as e:
            raise DeserializationError(f"{name}: {e}") from e
    raise DeserializationError(f"bad node {t}")


def _width(obj, inherited: int) -> int:
    """The torus width an object's words are written at: its own `log_q`,
    else its parameters', else its container's."""
    w = getattr(obj, "log_q", None)
    if w is None:
        w = getattr(getattr(obj, "params", None), "log_q", None)
    return w if w in (32, 64) else inherited


def _encode(obj, arrays: Dict[str, np.ndarray], seen: dict, width: int = 64):
    from ..gadget.encoding import Encoding
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"t": "arr", "k": key}
    if isinstance(obj, Encoding):
        return {"t": "encoding", "o": obj.origin_modulus, "p": obj.modulus_p,
                "wopbs": obj.wopbs, "parts": [sorted(part) for part in obj.parts]}
    if isinstance(obj, torch.Tensor):
        key = seen.get(id(obj))
        if key is None:
            if obj.dtype != torch.int64:
                raise DeserializationError(f"only torus words (int64) are written, not "
                                           f"{obj.dtype}")
            key = f"a{len(arrays)}"
            arrays[key] = to_numpy_torus(obj, width)
            seen[id(obj)] = key
        return {"t": "arr", "k": key}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, arrays, seen, width) for x in obj]}
    if dataclasses.is_dataclass(obj):
        # an object met twice (the shift key's shared BSKs) is one node,
        # so its arrays are written once
        node = seen.get(("obj", id(obj)))
        if node is not None:
            return node
        _register()
        name = _WRITERS.get(type(obj))
        if name is None:
            raise DeserializationError(f"the port does not write {type(obj).__name__}: "
                                       f"no JAX type of that name reads it")
        width = _width(obj, width)
        fields = _WRITE_FIELDS.get(type(obj))
        fields = (fields(obj) if fields else
                  {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})
        node = {"t": "obj", "cls": name,
                "fields": {k: _encode(v, arrays, seen, width) for k, v in fields.items()}}
        seen[("obj", id(obj))] = node
        return node
    raise DeserializationError(f"cannot serialize {type(obj)}")


def save(obj, path_or_buf, compress: bool = True) -> None:
    """Write `obj` in the tfhe_tpu-v1 format (compress=False skips zlib:
    key material is incompressible and large)."""
    arrays: Dict[str, np.ndarray] = {}
    tree = _encode(obj, arrays, {})
    meta = json.dumps({"version": SERIALIZATION_VERSION, "type": tree["cls"], "tree": tree})
    writer = np.savez_compressed if compress else np.savez
    writer(path_or_buf, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)


def safe_save(obj, path_or_buf) -> None:
    """`save` (tfhe_tpu serialization.py:219): the version and the type name
    are in every file; `safe_load` checks them."""
    save(obj, path_or_buf)


def _read(path_or_buf) -> tuple:
    with np.load(path_or_buf, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def _decode_on(meta: dict, arrays: dict, device):
    from ..cuda_lib import resolve_device
    return _decode(meta["tree"], arrays, resolve_device(device))


def load(path_or_buf, device="cuda") -> Any:
    """Read a tfhe_tpu-v1 file into the port's types, on `device`."""
    meta, arrays = _read(path_or_buf)
    return _decode_on(meta, arrays, device)


def safe_load(path_or_buf, expected_type: str | None = None, size_limit: int | None = None,
              conformance=None, device="cuda") -> Any:
    """Versioned, type-named, size-limited read (tfhe_tpu
    serialization.py:223-247; reference safe_deserialization.rs:16-60):
    the size limit is checked before anything is read (for a path; the JAX
    package checks it for path objects only, not for a str), then the
    version, the type (its JAX name or a dotted suffix of it) and the
    conformance predicate, each refusal a DeserializationError."""
    if size_limit is not None and isinstance(path_or_buf, (str, os.PathLike)):
        actual = os.path.getsize(path_or_buf)
        if actual > size_limit:
            raise DeserializationError(f"serialized size {actual} exceeds limit {size_limit}")
    meta, arrays = _read(path_or_buf)
    if meta.get("version") != SERIALIZATION_VERSION:
        raise DeserializationError(f"version mismatch: {meta.get('version')} != "
                                   f"{SERIALIZATION_VERSION}")
    if expected_type is not None and not (meta["type"] == expected_type
                                          or meta["type"].endswith("." + expected_type)):
        raise DeserializationError(f"type mismatch: expected {expected_type}, got "
                                   f"{meta['type']}")
    obj = _decode_on(meta, arrays, device)
    if conformance is not None and not conformance(obj):
        raise DeserializationError("parameter conformance check failed")
    return obj


__all__ = ["SERIALIZATION_VERSION", "DeserializationError", "save", "load", "safe_save",
           "safe_load"]
