"""The port's GGSW-selector shifts (`tfhe_tpu_torch/integer/shift_key.py`)
bit for bit against tfhe_tpu's (tolerance 0) on the same numpy keys
(tests/torch_shift_jax.py: TEST_PARAMS_SHORTINT's compute keys,
TEST_PARAMS_WOPBS's WoP-PBS keys, the shift key's packing and one-hop
casting keys), as tests/test_shift_key.py builds its keys:

* every kind, shl, shr, rotl, rotr and the arithmetic shr, at 4 blocks:
  each output block's words, degree and noise level equal to JAX's, and
  decrypted against the clear model;
* the 8-block width; 3 blocks, where rotates and the arithmetic shift
  take the layered path in both packages and shl the GGSW path; a shift
  followed by an add;
* the gate `ggsw_shift_supported` against JAX's over a grid;
* a `ShiftKey` through a tfhe_tpu-v1 file both ways (JAX writes, the port
  reads and computes the same; the port writes, JAX's `safe_load` reads
  the same words);
* the port's own `integer.gen_keys(..., shift_key=TEST_PARAMS_WOPBS)`,
  decrypted.

The JAX side runs as `torch_shift_jax.fast_jax()` runs it."""
import math

import numpy as np
import pytest
import torch

import tfhe_tpu.integer.shift_key as JSK
from tfhe_tpu.integer import ciphertext as jct
from tfhe_tpu.integer.server_key import ServerKey as JIntegerServerKey
from tfhe_tpu.utils import serialization as JSer
from tfhe_tpu_torch import integer
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import TEST_PARAMS_WOPBS as PW
from tfhe_tpu_torch.integer import RadixClientKey, SignedRadixCiphertext
from tfhe_tpu_torch.integer import shift_key as SK
from tfhe_tpu_torch.utils import serialization as Ser
from torch_shift_jax import fast_jax, radix_pair, same_radix, shift_sides

OPS = {"shl": "left_shift", "shr": "right_shift", "rotl": "rotate_left",
       "rotr": "rotate_right", "ashr": "right_shift_arithmetic"}


def clear(kind, v, s, bits):
    """The clear model (tests/test_shift_key.py `_clear`, and >> on signed
    values for ashr, the amount taken mod the next power of two)."""
    s %= 1 << max(1, math.ceil(math.log2(bits)))
    if kind == "ashr":
        return v >> min(s, bits - 1)
    if kind == "shl":
        return (v << s) & ((1 << bits) - 1) if s < bits else 0
    if kind == "shr":
        return v >> s if s < bits else 0
    s %= bits
    if kind == "rotl":
        return ((v << s) | (v >> (bits - s))) & ((1 << bits) - 1) if s else v
    return ((v >> s) | (v << (bits - s))) & ((1 << bits) - 1) if s else v


@pytest.fixture(scope="module")
def sides():
    with fast_jax():
        yield shift_sides(seed=71)


def run(sides, kind, vals, amts, nb, seed):
    """The op on both packages' encryptions → (port out, JAX out, port
    client key)."""
    big = sides["k"]["big_bits"]
    signed = kind == "ashr"
    a, ja = radix_pair(big, vals, nb, seed, signed=signed)
    s, js = radix_pair(big, amts, nb, seed + 50)
    out = getattr(sides["port"], OPS[kind])(a, s)
    jout = getattr(sides["jax"], OPS[kind])(ja, js)
    return out, jout, RadixClientKey(key=sides["tck"], num_blocks=nb)


def decrypt(ck, out, signed):
    if signed:
        return ck.decrypt_signed(SignedRadixCiphertext(blocks=out.blocks)).tolist()
    return [int(v) for v in ck.decrypt(out)]


@pytest.mark.parametrize("kind", list(OPS))
def test_ggsw_shift_equals_jax(sides, kind):
    """4 blocks (8 bits) at batch 4, amounts within and past the width."""
    vals = [-100, -1, 57, -128] if kind == "ashr" else [0x5A, 0x01, 0xFF, 0x80]
    amts = [2, 7, 3, 1] if kind == "ashr" else [0, 3, 7, 6]
    out, jout, ck = run(sides, kind, vals, amts, 4, seed=300)
    same_radix(out, jout)
    assert decrypt(ck, out, kind == "ashr") == [clear(kind, v, s, 8) for v, s in zip(vals, amts)]


def test_ggsw_shift_wider_width_equals_jax(sides):
    """8 blocks (16 bits: 4 selector bits, 3 CMuxes), shl and rotr."""
    vals, amts = [0xBEEF, 0x8001], [9, 15]
    for kind in ("shl", "rotr"):
        out, jout, ck = run(sides, kind, vals, amts, 8, seed=400)
        same_radix(out, jout)
        assert decrypt(ck, out, False) == [clear(kind, v, s, 16) for v, s in zip(vals, amts)]


@pytest.mark.parametrize("kind", ["rotl", "ashr", "shl"])
def test_non_power_of_two_width_gate(sides, kind, monkeypatch):
    """3 blocks (6 bits): rotates and the arithmetic shift take the layered
    path in both packages (the GGSW path is never entered), shl the GGSW
    path; equal to JAX's and decrypted right."""
    called = []
    orig = SK._shift_rotate_ggsw
    monkeypatch.setattr(SK, "_shift_rotate_ggsw",
                        lambda *a: called.append(a[-1]) or orig(*a))
    vals = [-32, -1, 20] if kind == "ashr" else [0x2D, 0x3F, 0x01]
    amts = [7, 5, 2]
    out, jout, ck = run(sides, kind, vals, amts, 3, seed=500)
    same_radix(out, jout)
    assert called == ([] if kind != "shl" else ["shl"])
    if kind == "ashr":
        want = [v >> min(s, 5) for v, s in zip(vals, amts)]
    elif kind == "rotl":
        want = [((v << (s % 6)) | (v >> (6 - s % 6))) & 63 for v, s in zip(vals, amts)]
    else:
        want = [(v << s) & 63 if s < 6 else 0 for v, s in zip(vals, amts)]
    assert decrypt(ck, out, kind == "ashr") == want


def test_ggsw_shift_then_add_equals_jax(sides):
    """The shift's blocks are fresh: an add after it equals JAX's and
    decrypts right."""
    out, jout, ck = run(sides, "shl", [0x0F, 0x21], [2, 1], 4, seed=600)
    out2 = sides["port"].add_parallelized(out, out)
    jout2 = sides["jax"].add_parallelized(jout, jout)
    same_radix(out2, jout2)
    assert decrypt(ck, out2, False) == [0x78, 0x84]


def test_gate_equals_jax(sides):
    """`ggsw_shift_supported` over message moduli, widths and amount
    widths, with and without a key, equal to JAX's."""
    tkey, jkey = sides["port"].shift_key, sides["jax"].shift_key
    for msg in (1, 2, 4, 8, 16):
        for nb in (1, 2, 3, 4, 8, 16, 64, 85, 86, 128):
            for ab in (1, 4):
                for t, j in ((tkey, jkey), (None, None)):
                    assert SK.ggsw_shift_supported(t, msg, nb, ab) == \
                        JSK.ggsw_shift_supported(j, msg, nb, ab), (msg, nb, ab)


def test_shift_key_file_both_ways(sides, tmp_path):
    """JAX writes its ShiftKey: the port reads it and rotates as with its
    own key.  The port writes its integer ServerKey: JAX's safe_load reads
    a ShiftKey of the same words (the BSKs shared, each written once)."""
    JSer.save(sides["jax"].shift_key, tmp_path / "j.npz", compress=False)
    loaded = Ser.safe_load(tmp_path / "j.npz", expected_type="ShiftKey", device="cpu")
    assert isinstance(loaded, SK.ShiftKey) and loaded.cbs_decomp == SK.SHIFT_CBS_DECOMP
    isk = integer.ServerKey(key=sides["tsk"], shift_key=loaded)
    big = sides["k"]["big_bits"]
    a, _ = radix_pair(big, [0x2D], 4, seed=700)
    s, _ = radix_pair(big, [4], 4, seed=701)
    got = isk.rotate_left(a, s)
    same_radix(got, _as_jax(sides["port"].rotate_left(a, s)))
    Ser.save(sides["port"], tmp_path / "t.npz", compress=False)
    back = JSer.safe_load(tmp_path / "t.npz", expected_type="integer.server_key.ServerKey")
    assert isinstance(back, JIntegerServerKey) and isinstance(back.shift_key, JSK.ShiftKey)
    theirs, ours = back.shift_key, sides["port"].shift_key
    np.testing.assert_array_equal(np.asarray(theirs.pksk.data), to_numpy_u64(ours.pksk.data))
    np.testing.assert_array_equal(np.asarray(theirs.cbs_server_key.ksk.data),
                                  to_numpy_u64(ours.cbs_server_key.ksk.data))
    np.testing.assert_array_equal(np.asarray(theirs.wopbs.wopbs_key.pfpksk.data),
                                  to_numpy_u64(ours.wopbs.wopbs_key.pfpksk.data))
    np.testing.assert_array_equal(np.asarray(theirs.refresh_server_key.bsk.data),
                                  np.asarray(sides["jax"].key.bsk.data))
    with np.load(tmp_path / "t.npz") as z:
        sizes = sorted(z[k].size for k in z.files if k != "__meta__")
    bsk_words = ours.refresh_server_key.bsk.spectra.numel()
    assert sizes.count(bsk_words) == 2          # the compute BSK's data and Shoup twin


def _as_jax(t):
    """A port radix ciphertext's blocks as a JAX RadixCiphertext (for
    same_radix's words, degree and noise-level compare)."""
    from torch_shift_jax import JCt, JLwe, jnp
    return jct.RadixCiphertext(blocks=[
        JCt(lwe=JLwe(data=jnp.asarray(to_numpy_u64(b.lwe.data))), degree=b.degree,
            message_modulus=b.message_modulus, carry_modulus=b.carry_modulus,
            noise_level=b.noise_level) for b in t.blocks])


def test_port_gen_keys_with_shift_key_decrypts():
    """The port alone: `integer.gen_keys(TEST_PARAMS_SHORTINT, 4,
    shift_key=TEST_PARAMS_WOPBS, device="cpu")` builds the key; shl and rotr
    by encrypted amounts decrypt right."""
    torch.set_num_threads(1)
    ck, sk = integer.gen_keys(P, num_blocks=4, seed=81, shift_key=PW, device="cpu")
    assert isinstance(sk.shift_key, SK.ShiftKey) and sk.shift_key.wopbs.params == PW
    vals, amts = [0xA7, 0x12, 0xFF], [5, 2, 1]
    a, s = ck.encrypt(vals, seed=82), ck.encrypt(amts, seed=83)
    for kind in ("shl", "rotr"):
        got = [int(v) for v in ck.decrypt(getattr(sk, OPS[kind])(a, s))]
        assert got == [clear(kind, v, x, 8) for v, x in zip(vals, amts)]


def test_new_shift_key_masks_equal_jax(monkeypatch):
    """`integer.gen_keys(..., shift_key=TEST_PARAMS_WOPBS)` draws the shift
    key's masks as the JAX package's `new_shift_key` does on the same
    secret keys and seed: the packing KSK's under fork(key_from_seed(seed),
    0x5F1F) and the two casting KSKs' under split(fork(key_from_seed(seed),
    0x5F20)), word for word (the noise, and so the bodies, come from each
    package's own sampler).  JAX's combined WoP-PBS key, whose masks this
    test does not read, is stood in for by its parameters, and the packing
    KSK's generation is jitted, as their eager runs take minutes on the
    CPU."""
    import types

    import jax
    import jax.numpy as jnp

    from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
    from tfhe_tpu.core.entities import LweSecretKey as JLweSk
    from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
    from tfhe_tpu.core.params import TEST_PARAMS_WOPBS as JPW
    from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
    torch.set_num_threads(1)
    ck, sk = integer.gen_keys(P, num_blocks=4, seed=81, shift_key=PW, device="cpu")
    jck = JClientKey(glwe_sk=JGlweSk(bits=jnp.asarray(ck.key.glwe_sk.bits.numpy())),
                     lwe_sk=JLweSk(bits=jnp.asarray(ck.key.lwe_sk.bits.numpy())), params=JP)
    stand_in = types.SimpleNamespace(
        params=JPW, wopbs_key=types.SimpleNamespace(server_key=types.SimpleNamespace(bsk=None)))
    monkeypatch.setattr(JSK, "new_wopbs_key", lambda *a, **kw: stand_in)
    monkeypatch.setattr(JSK, "generate_packing_keyswitch_key",
                        jax.jit(JSK.generate_packing_keyswitch_key, static_argnums=(3, 4, 5)))
    jax = JSK.new_shift_key(jck, types.SimpleNamespace(bsk=None), JPW, seed=81)
    port = sk.shift_key
    k_w = PW.glwe_dimension
    pairs = [(port.pksk.data[..., :k_w, :], jax.pksk.data[..., :k_w, :]),
             (port.cbs_server_key.ksk.data[..., :-1], jax.cbs_server_key.ksk.data[..., :-1]),
             (port.refresh_server_key.ksk.data[..., :-1],
              jax.refresh_server_key.ksk.data[..., :-1])]
    for got, want in pairs:
        assert np.array_equal(to_numpy_u64(got), np.asarray(want).astype(np.uint64))
        assert (got != 0).any()
