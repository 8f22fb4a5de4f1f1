"""Both packages' GGSW shift keys and integer WoP-PBS keys on the same numpy
keys, and the JAX package's integer layer run fast enough for the parity
tests (tests/test_torch_shift_key.py, tests/test_torch_integer_wopbs.py).

`shift_sides()` builds, from numpy arrays only (never JAX `gen_keys`):
the compute keys at TEST_PARAMS_SHORTINT, the WoP-PBS keys at
TEST_PARAMS_WOPBS, the PFPKSK list (made by the port, carried to JAX), the
combined regime's two casting keys (compute KS decomposition), the shift
key's packing key (WoP-PBS pfks decomposition) and its two one-hop casting
keys at SHIFT_CAST_KS_DECOMP, then each package's integer `ServerKey` with
its `ShiftKey`.

`fast_jax()` runs the JAX side as the other integer parity tests do: its
`apply_lookup_table` one jitted call on rows padded to 16, 64 or a multiple
of 64 and the WoP-PBS's PBS `torch_jax_pbs.padded_pbs` (the fused PBS in
interpret mode), and the shift's and WoP-PBS's private functional keyswitch, GGSW
conversion, CMux, packing keyswitch and vertical packing jitted once a
shape."""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.algorithms.wopbs as JW
import tfhe_tpu.integer.shift_key as JSK
import tfhe_tpu.integer.wopbs as JIW
import tfhe_tpu.shortint.wopbs as JSW
from tfhe_tpu import config
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LwePackingKeyswitchKey as JPksk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.params import TEST_PARAMS_WOPBS as JPW
from tfhe_tpu.core.params import DecompParams as JD
from tfhe_tpu.integer import ciphertext as jct
from tfhe_tpu.integer.server_key import ServerKey as JIntegerServerKey
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.ciphertext import NoiseLevel as JNoiseLevel
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import integer, interop, shortint
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import TEST_PARAMS_WOPBS as PW
from tfhe_tpu_torch.integer.shift_key import SHIFT_CAST_KS_DECOMP, SHIFT_CBS_DECOMP
from tfhe_tpu_torch.shortint import wopbs as SW
from torch_jax_pbs import jax_server, padded_pbs, port_keys
from torch_keys import _ksk, _noise, encrypt_big, glwe_body, real_keys

U64 = np.uint64
M = P.message_modulus
_JAX_APPLY = JServerKey.apply_lookup_table


def packing_ksk(rng, big_bits, glwe_bits, decomp, std) -> np.ndarray:
    """[kN, l, k_w+1, N_w] u64: GLWE encryptions of s_in[i] q/B^(l+1) as a
    constant polynomial."""
    k, n = glwe_bits.shape
    g = np.array([1 << (64 - decomp.base_log * (l + 1)) for l in range(decomp.level)],
                 dtype=U64)
    pts = np.zeros((big_bits.size, decomp.level, n), dtype=U64)
    pts[..., 0] = big_bits.astype(U64)[:, None] * g
    mask = rng.integers(0, 2 ** 64, pts.shape[:2] + (k, n), dtype=U64)
    body = glwe_body(mask, glwe_bits, pts, _noise(rng, pts.shape, std))
    return np.concatenate([mask, body[..., None, :]], axis=-2)


def shift_sides(seed: int) -> dict:
    """Both packages' integer server keys with a shift key, on one set of
    numpy keys; and the arrays they were made of."""
    k = real_keys(P, seed=seed)
    kw = real_keys(PW, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    tck, tsk = port_keys(k, P)
    _, twsk = port_keys(kw, PW)
    jsk, jwsk = jax_server(k, JP), jax_server(kw, JPW)
    pf = SW.new_wopbs_key_only_for_wopbs(*port_keys(kw, PW), cbs_decomp=PW.cbs_decomp,
                                         pfks_decomp=PW.pfks_decomp, seed=seed + 3).pfpksk
    arr = dict(pf=to_numpy_u64(pf.data),
               ksk_in=_ksk(rng, P, k["big_bits"], kw["big_bits"]),
               ksk_out=_ksk(rng, P, kw["big_bits"], k["lwe_bits"]),
               pksk=packing_ksk(rng, k["big_bits"], kw["glwe_bits"], PW.pfks_decomp,
                                PW.pfks_noise_std))
    cast = dataclasses.replace(P, ks_base_log=SHIFT_CAST_KS_DECOMP.base_log,
                               ks_level=SHIFT_CAST_KS_DECOMP.level)
    arr["cast_in"] = _ksk(rng, cast, k["big_bits"], kw["lwe_bits"])
    arr["cast_out"] = _ksk(rng, cast, kw["big_bits"], k["lwe_bits"])

    def tk(data, decomp):
        return interop.keyswitch_key(data, decomp, device="cpu")

    inner = interop.wopbs_key(twsk, arr["pf"], PW.pfks_decomp, PW.cbs_decomp, device="cpu")
    tcomb = interop.combined_wopbs_key(
        inner, shortint.ServerKey(ksk=tk(arr["ksk_out"], P.ks_decomp), bsk=tsk.bsk, params=P),
        arr["ksk_in"], P.ks_decomp, device="cpu")
    tshift = interop.shift_key(
        tcomb, arr["pksk"], PW.pfks_decomp,
        shortint.ServerKey(ksk=tk(arr["cast_in"], SHIFT_CAST_KS_DECOMP), bsk=twsk.bsk,
                           params=PW),
        shortint.ServerKey(ksk=tk(arr["cast_out"], SHIFT_CAST_KS_DECOMP), bsk=tsk.bsk,
                           params=P),
        SHIFT_CBS_DECOMP, device="cpu")

    def jk(data, decomp):
        return JKsk(data=jnp.asarray(data), decomp=JD(decomp.base_log, decomp.level))

    jinner = JSW.WopbsKey(server_key=jwsk, pfpksk=JW.CbsPfpkskList(
        data=jnp.asarray(arr["pf"]), decomp=JPW.pfks_decomp), cbs_decomp=JPW.cbs_decomp)
    jcomb = JSW.CombinedWopbsKey(
        wopbs_key=jinner,
        pbs_server_key=JServerKey(ksk=jk(arr["ksk_out"], P.ks_decomp), bsk=jsk.bsk, params=JP),
        ksk_pbs_to_wopbs=jk(arr["ksk_in"], P.ks_decomp))
    jshift = JSK.ShiftKey(
        wopbs=jcomb, pksk=JPksk(data=jnp.asarray(arr["pksk"]), decomp=JPW.pfks_decomp),
        cbs_server_key=JServerKey(ksk=jk(arr["cast_in"], SHIFT_CAST_KS_DECOMP),
                                  bsk=jwsk.bsk, params=JPW),
        refresh_server_key=JServerKey(ksk=jk(arr["cast_out"], SHIFT_CAST_KS_DECOMP),
                                      bsk=jsk.bsk, params=JP),
        cbs_decomp=JD(SHIFT_CBS_DECOMP.base_log, SHIFT_CBS_DECOMP.level))
    return dict(k=k, kw=kw, arr=arr, tck=tck, tsk=tsk, twsk=twsk, jsk=jsk, jwsk=jwsk,
                tinner=inner, jinner=jinner,
                port=integer.ServerKey(key=tsk, shift_key=tshift),
                jax=JIntegerServerKey(key=jsk, shift_key=jshift))


def digits(values, nb: int) -> np.ndarray:
    """Little-endian base-M digits [nb, batch] (negative values in two's
    complement)."""
    v = np.asarray(values, dtype=object) % M ** nb
    return np.stack([((v // M ** i) % M).astype(np.int64) for i in range(nb)])


def radix_pair(big_bits, values, nb: int, seed: int, signed: bool = False) -> tuple:
    """The same encryptions of values as both packages' radix ciphertexts."""
    data = [encrypt_big(P, big_bits, d, seed=seed + i) for i, d in enumerate(digits(values, nb))]
    jblocks = [JCt(lwe=JLwe(data=jnp.asarray(d)), degree=M - 1, message_modulus=M,
                   carry_modulus=P.carry_modulus) for d in data]
    jcls = jct.SignedRadixCiphertext if signed else jct.RadixCiphertext
    port = interop.radix_ciphertext(data, [M - 1] * nb, [1] * nb, M, P.carry_modulus,
                                    kind="signed" if signed else "radix", device="cpu")
    return port, jcls(blocks=jblocks)


def same_radix(t, j):
    """Every block's words, degree and noise level equal."""
    assert len(t.blocks) == len(j.blocks)
    for tb, jb in zip(t.blocks, j.blocks):
        np.testing.assert_array_equal(to_numpy_u64(tb.lwe.data), np.asarray(jb.lwe.data))
        assert (tb.degree, tb.noise_level) == (int(jb.degree), int(jb.noise_level))


@jax.jit
def _rows(sk, data, acc):
    return _JAX_APPLY(sk, JCt(lwe=JLwe(data=data)), JLut(acc=JGlwe(data=acc))).lwe.data


def _apply(self, ct, lut):
    """JAX `apply_lookup_table`, one jitted call on rows padded to 16, 64
    or a multiple of 64."""
    data = ct.lwe.data
    lead, rows = data.shape[:-1], math.prod(data.shape[:-1])
    acc = jnp.broadcast_to(lut.acc.data, lead + lut.acc.data.shape[-2:]).reshape(
        (rows,) + lut.acc.data.shape[-2:])
    size = next((b for b in (16, 64) if rows <= b), -(-rows // 64) * 64)
    flat = jnp.pad(data.reshape(rows, data.shape[-1]), ((0, size - rows), (0, 0)))
    acc = jnp.pad(acc, ((0, size - rows), (0, 0), (0, 0)))
    out = _rows(self, flat, acc)[:rows]
    return ct.with_(lwe=JLwe(data=out.reshape(data.shape)), degree=lut.degree,
                    noise_level=JNoiseLevel.NOMINAL)


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


@contextlib.contextmanager
def fast_jax():
    """The JAX integer layer's shift and WoP-PBS paths, jitted (module doc)."""
    torch.set_num_threads(1)
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JServerKey, "apply_lookup_table", _apply)
        mp.setattr(JW, "programmable_bootstrap", padded_pbs)
        mp.setattr(JSK, "private_functional_keyswitch",
                   _jit(JSK.private_functional_keyswitch, 2, 3))
        mp.setattr(JSK, "ggsw_to_ntt", _jit(JSK.ggsw_to_ntt, 1))
        mp.setattr(JSK, "cmux_ntt", _jit(JSK.cmux_ntt, 4, 5))
        mp.setattr(JSK, "packing_keyswitch_lwe_list_to_glwe",
                   _jit(JSK.packing_keyswitch_lwe_list_to_glwe, 2))
        mp.setattr(JSK, "sample_extract", _jit(JSK.sample_extract, 1))
        mp.setattr(JW, "keyswitch_lwe", _jit(JW.keyswitch_lwe, 2))
        mp.setattr(JW, "private_functional_keyswitch",
                   _jit(JW.private_functional_keyswitch, 2, 3))
        mp.setattr(JSW, "ggsw_to_ntt", _jit(JSW.ggsw_to_ntt, 1))
        mp.setattr(JIW, "vertical_packing", _jit(JIW.vertical_packing, 3, 4, 5))
        try:
            yield
        finally:
            config.set_use_pallas_pbs(old[0])
            config.set_pallas_interpret(old[1])
