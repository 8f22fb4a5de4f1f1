"""The JAX side of the gadget parity tests (tests/test_torch_gadget.py,
tests/test_torch_glwe_mult.py): numpy key arrays for both packages at
TEST_PARAMS_GADGET (key choice `big`, KS → PBS) and its PBS → KS twin, and
`tfhe_tpu.gadget.engine` with its primitives jitted once on padded rows.

The keys are numpy-made (`tests/torch_keys.py`, plus the packing KSK and
the relinearization key here): a JAX `gadget.gen_keys` at TEST_PARAMS_GADGET
runs for minutes of eager compiles on a CPU.  The same arrays build both
packages' keys: the JAX NTT key through one jitted `bootstrap_key_to_ntt`,
the port's through `interop.gadget_keys` from that key's DIF data.

`interpreted_engine()` replaces the names the JAX engine calls:
`programmable_bootstrap` by its fused route in interpret mode
(`torch_jax_pbs.padded_pbs`, the delta form the port's K1 computes),
`blind_rotate` (the XLA rotate-subtract form `blind_rotate_only` ports),
`keyswitch_lwe`, `packing_keyswitch_lwe_to_glwe`, `glwe_mult` (on words
offset by its rounding constant: the port rounds, ROADMAP C12) and
`negacyclic_polymul` by jitted calls on rows padded to 16, so each shape
compiles once a module."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_tpu.gadget.engine as JE
from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms.bootstrap import blind_rotate as jax_blind_rotate
from tfhe_tpu.core.algorithms.glwe_mult import glwe_mult as jax_glwe_mult
from tfhe_tpu.core.algorithms.keyswitch import keyswitch_lwe as jax_keyswitch
from tfhe_tpu.core.algorithms.keyswitch import (
    packing_keyswitch_lwe_to_glwe as jax_packing_keyswitch)
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import GlweRelinearizationKey as JRlk
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LwePackingKeyswitchKey as JPksk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_GADGET as JP
from tfhe_tpu.core.poly import negacyclic_polymul as jax_polymul
from tfhe_tpu.core.poly.ntt import get_plan as jax_plan
from tfhe_tpu.gadget.encoding import Encoding as JEncoding
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_GADGET as P
from torch_jax_pbs import padded_pbs
from torch_keys import _negacyclic_matrix, _noise, glwe_body, real_keys

U64 = np.uint64
ROWS = 16
ORDERS = {"ks_pbs": (P, JP),
          "pbs_ks": (dataclasses.replace(P, name="TEST_PARAMS_GADGET_PBS_KS",
                                         encryption_key_choice="small"),
                     dataclasses.replace(JP, name="TEST_PARAMS_GADGET_PBS_KS",
                                         encryption_key_choice="small"))}


def _gadget_rows(decomp) -> np.ndarray:
    return np.array([1 << (64 - decomp.base_log * (l + 1)) for l in range(decomp.level)],
                    dtype=U64)


def _glwe_encrypt(rng, glwe_bits, pts, std) -> np.ndarray:
    """GLWE encryptions [..., k+1, N] u64 of plaintext polynomials [..., N]."""
    k, n = glwe_bits.shape
    mask = rng.integers(0, 2 ** 64, pts.shape[:-1] + (k, n), dtype=U64)
    body = glwe_body(mask, glwe_bits, pts, _noise(rng, pts.shape, std))
    return np.concatenate([mask, body[..., None, :]], axis=-2)


def numpy_gadget_keys(seed: int) -> dict:
    """real_keys at TEST_PARAMS_GADGET plus the packing KSK [kN, l, k+1, N]
    (GLWEs of the constant s_big[i] * q/B^(l+1)) and the relinearization key
    [pairs, l, k+1, N] (GLWEs of s_i*s_j * q/B^(l+1)), the JAX NTT key made
    from the BSK and its primes."""
    k = real_keys(P, seed=seed)
    rng = np.random.default_rng(seed + 1)
    glwe_bits = k["glwe_bits"]
    kk, n = glwe_bits.shape
    pts = np.zeros((k["big_bits"].size, P.ks_level, n), dtype=U64)
    pts[..., 0] = k["big_bits"].astype(U64)[:, None] * _gadget_rows(P.ks_decomp)
    pksk = _glwe_encrypt(rng, glwe_bits, pts, P.glwe_noise_std)
    blocks = []
    for i in range(kk):
        for j in range(i + 1):
            sij = _negacyclic_matrix(glwe_bits[i]) @ glwe_bits[j].astype(U64)
            rows = sij[None, :] * _gadget_rows(P.pbs_decomp)[:, None]
            blocks.append(_glwe_encrypt(rng, glwe_bits, rows, P.glwe_noise_std))
    npr = external_product_num_primes(P.polynomial_size, P.glwe_size, P.pbs_decomp)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, npr))(
        jnp.asarray(k["bsk"]))
    return dict(k, pksk=pksk, rlk=np.stack(blocks), jbsk=jbsk,
                primes=jax_plan(P.polynomial_size, npr).primes)


def jax_keys(keys, order):
    """(JAX gadget ClientKey, ServerKey) of one order on the numpy keys."""
    jp = ORDERS[order][1]
    jck = JE.ClientKey(lwe_sk=JLweSk(bits=jnp.asarray(keys["lwe_bits"])),
                       glwe_sk=JGlweSk(bits=jnp.asarray(keys["glwe_bits"])), params=jp)
    jsk = JE.ServerKey(bsk=keys["jbsk"], ksk=JKsk(data=jnp.asarray(keys["ksk"]),
                                                  decomp=jp.ks_decomp),
                       pksk=JPksk(data=jnp.asarray(keys["pksk"]), decomp=jp.ks_decomp),
                       rlk=JRlk(data=jnp.asarray(keys["rlk"]), decomp=jp.pbs_decomp),
                       params=jp)
    return jck, jsk


def port_keys(keys, order):
    """The port's (ClientKey, ServerKey) of one order on the CPU, from the
    same arrays (the BSK from the JAX key's DIF data)."""
    return interop.gadget_keys(keys["lwe_bits"], keys["glwe_bits"],
                               np.asarray(keys["jbsk"].data), keys["primes"], keys["ksk"],
                               keys["pksk"], keys["rlk"], ORDERS[order][0], device="cpu")


def encodings(*args, **kw):
    """(JAX Encoding, port Encoding) from the same arguments."""
    from tfhe_tpu_torch.gadget import Encoding
    return JEncoding(*args, **kw), Encoding(*args, **kw)


def port_encoding(jenc):
    from tfhe_tpu_torch.gadget import Encoding
    return Encoding(jenc.origin_modulus, [sorted(p) for p in jenc.parts], jenc.modulus_p,
                    wopbs=jenc.wopbs, _validate=False)


def encrypt(keys, order, msgs, jenc, seed):
    """Gadget encryptions [B, n+1] u64 of Z_o msgs under the order's key,
    canonical encoding jenc."""
    p = ORDERS[order][0]
    bits = keys["big_bits"] if p.encryption_key_choice == "big" else keys["lwe_bits"]
    std = p.glwe_noise_std if p.encryption_key_choice == "big" else p.lwe_noise_std
    rng = np.random.default_rng(seed)
    delta = (1 << 64) // jenc.modulus_p
    pts = np.array([jenc.get_part_single_value_if_canonical(int(m)) * delta % (1 << 64)
                    for m in msgs], dtype=U64)
    mask = rng.integers(0, 2 ** 64, pts.shape + bits.shape, dtype=U64)
    body = (mask * bits.astype(U64)).sum(axis=-1, dtype=U64) + pts + _noise(rng, pts.shape, std)
    return np.concatenate([mask, body[..., None]], axis=-1)


def both(data, jenc):
    """(JAX Ciphertext, port Ciphertext on the CPU) of the same words."""
    return (JE.Ciphertext(lwe=JLwe(data=jnp.asarray(data)), encoding=jenc),
            interop.gadget_ciphertext(data, port_encoding(jenc), device="cpu"))


def jw(ct) -> np.ndarray:
    """A JAX ciphertext's (or GLWE's) words, u64 numpy."""
    return np.asarray(ct.lwe.data if hasattr(ct, "lwe") else ct.data)


def tw(ct) -> np.ndarray:
    """A port ciphertext's (or GLWE's) words, u64 numpy."""
    return to_numpy_u64(ct.lwe.data if hasattr(ct, "lwe") else ct.data)


# ---------------------------------------------------------------------------
# the JAX engine on jitted, padded primitives
# ---------------------------------------------------------------------------


def _rows(x):
    """[..., w] → ([ROWS, w] padded, rows, lead)."""
    lead, w = x.shape[:-1], x.shape[-1]
    flat = jnp.reshape(x, (-1, w))
    rows = flat.shape[0]
    assert rows <= ROWS, f"{rows} rows: the parity tests pad to {ROWS}"
    return jnp.pad(flat, ((0, ROWS - rows), (0, 0))), rows, lead


@jax.jit
def _ks(data, ksk):
    return jax_keyswitch(JLwe(data=data), ksk, 64).data


@jax.jit
def _br(acc, data, bsk):
    return jax_blind_rotate(JGlwe(data=acc), JLwe(data=data), bsk, 64).data


@jax.jit
def _pks(data, pksk):
    return jax_packing_keyswitch(JLwe(data=data), pksk, 64).data


@functools.partial(jax.jit, static_argnums=(2,))
def _polymul(a, b, log_bound):
    return jax_polymul(a, b, 64, log_bound=log_bound)


@functools.partial(jax.jit, static_argnums=(3,))
def _glwe_mult(a, b, rlk, log_p):
    return jax_glwe_mult(JGlwe(data=a), JGlwe(data=b), rlk, log_p, 64).data


def keyswitch_rows(lwe, ksk, log_q):
    flat, rows, lead = _rows(lwe.data)
    out = _ks(flat, ksk)[:rows]
    return JLwe(data=out.reshape(lead + out.shape[-1:]))


def blind_rotate_rows(lut, lwe, bsk, log_q):
    flat, rows, lead = _rows(lwe.data)
    out = _br(lut.data, flat, bsk)[:rows]
    return JGlwe(data=out.reshape(lead + out.shape[-2:]))


def packing_keyswitch_rows(lwe, pksk, log_q):
    flat, rows, lead = _rows(lwe.data)
    out = _pks(flat, pksk)[:rows]
    return JGlwe(data=out.reshape(lead + out.shape[-2:]))


def polymul_rows(a, b, log_q, log_bound=None):
    """The engine's products: a [B, k+1, N] padded along B, b [N]."""
    pad = ROWS - a.shape[0]
    out = _polymul(jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)), b, float(log_bound))
    return out[:a.shape[0]]


def glwe_mult_rows(lhs, rhs, rlk, log_p, log_q):
    """JAX's glwe_mult on the operands offset by 2^(shift-1): the port's
    rounding switch (ROADMAP C12) on the words themselves, bit for bit."""
    pad = ((0, ROWS - lhs.data.shape[0]), (0, 0), (0, 0))
    half = jnp.uint64(1 << (32 - log_p // 2 - 1))
    out = _glwe_mult(jnp.pad(lhs.data + half, pad), jnp.pad(rhs.data + half, pad), rlk, log_p)
    return JGlwe(data=out[:lhs.data.shape[0]])


@contextlib.contextmanager
def interpreted_engine():
    """tfhe_tpu.gadget.engine with its primitives jitted on padded rows and
    its PBS on the fused route in interpret mode; restored afterwards."""
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JE, "programmable_bootstrap", padded_pbs)
            mp.setattr(JE, "keyswitch_lwe", keyswitch_rows)
            mp.setattr(JE, "blind_rotate", blind_rotate_rows)
            mp.setattr(JE, "packing_keyswitch_lwe_to_glwe", packing_keyswitch_rows)
            mp.setattr(JE, "negacyclic_polymul", polymul_rows)
            mp.setattr(JE, "glwe_mult", glwe_mult_rows)
            yield
    finally:
        config.set_use_pallas_pbs(old[0])
        config.set_pallas_interpret(old[1])
