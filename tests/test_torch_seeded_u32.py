"""The port's seeded entities on the 32-bit torus (log_q = 32, held lifted
by 2^32) against the JAX package's, at TEST_PARAMS_BOOLEAN_U32 widths on
the same secret bits (tests/torch_boolean_u32_jax.py): a JAX-made entity
decompresses in the port to the JAX package's uint32 words, lifted, bit for
bit; one the port makes from the same bits and seed has the JAX package's
masks bit for bit and bodies within 8 sigma (each package's own Gaussian
noise); the boolean compressed server and public keys likewise, and the
port's decompressed server key equals the one built from the JAX package's
decompression."""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch import boolean
from tfhe_tpu_torch.core.algorithms import seeded as TS
from test_torch_seeded import SEED, _bodies, _masks
from torch_seeded_jax import port_decompressed

KINDS32 = ("lwe", "glwe", "bsk", "ksk", "public_key")


def _u32_made(kind: str, seed: int):
    """(JAX seeded entity, port seeded entity, port full data or None, noise
    std) at 32 bits, on the same secret bits (tests/torch_boolean_u32_jax.py)."""
    import jax
    import jax.numpy as jnp
    import tfhe_tpu.core.algorithms.seeded as JS
    from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk, LweSecretKey as JLweSk
    from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN_U32 as JP32
    from tfhe_tpu_torch import interop
    from tfhe_tpu_torch.core.numeric import from_numpy_torus
    from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN_U32 as P32
    from torch_boolean_u32_jax import keys
    k = keys()
    jl, jg = JLweSk(bits=jnp.asarray(k["lwe_bits"])), JGlweSk(bits=jnp.asarray(k["glwe_bits"]))
    tl = interop.lwe_secret_key(k["lwe_bits"], device="cpu")
    tg = interop.glwe_secret_key(k["glwe_bits"], device="cpu")
    gen = torch.Generator().manual_seed(9)
    pts = np.random.default_rng(3).integers(0, 8, (5, 3) if kind == "lwe" else
                                            (2, P32.polynomial_size)).astype(np.uint32) << 29
    lstd, gstd = P32.lwe_noise_std, P32.glwe_noise_std
    full = None
    if kind == "lwe":
        j = jax.jit(lambda: JS.encrypt_lwe_seeded(seed, jl, jnp.asarray(pts), lstd, 32))()
        t = TS.encrypt_lwe_seeded(seed, gen, tl, from_numpy_torus(pts), lstd, 32)
        std = lstd
    elif kind == "glwe":
        j = jax.jit(lambda: JS.encrypt_glwe_seeded(seed, jg, jnp.asarray(pts), gstd, 32))()
        t = TS.encrypt_glwe_seeded(seed, gen, tg, from_numpy_torus(pts), gstd, 32)
        std = gstd
    elif kind == "bsk":
        j = jax.jit(lambda: JS.generate_seeded_bootstrap_key(seed, jl, jg, JP32.pbs_decomp,
                                                              gstd, 32))()[1]
        full, t = TS.generate_seeded_bootstrap_key(seed, gen, tl, tg, P32.pbs_decomp, gstd, 32)
        full, std = full.data, gstd
    elif kind == "ksk":
        j = jax.jit(lambda: JS.generate_seeded_keyswitch_key(
            seed, jg.as_lwe_secret_key(), jl, JP32.ks_decomp, lstd, 32))()[1]
        full, t = TS.generate_seeded_keyswitch_key(seed, gen, tg.as_lwe_secret_key(), tl,
                                                   P32.ks_decomp, lstd, 32)
        full, std = full.data, lstd
    else:
        j = jax.jit(lambda: JS.generate_seeded_lwe_public_key(seed, jl, 32, lstd, 32))()[1]
        full, t = TS.generate_seeded_lwe_public_key(seed, gen, tl, 32, lstd, 32)
        full, std = full.data, lstd
    return j, t, full, std


def _jax_decompressed32(sjax) -> np.ndarray:
    import jax
    import tfhe_tpu.core.algorithms.seeded as JS
    fn = {"SeededLweCiphertext": JS.decompress_lwe, "SeededGlweCiphertext": JS.decompress_glwe,
          "SeededLweBootstrapKey": JS.decompress_bootstrap_key,
          "SeededLweKeyswitchKey": JS.decompress_keyswitch_key,
          "SeededLwePublicKey": JS.decompress_lwe_public_key}[type(sjax).__name__]
    out = jax.jit(fn)(sjax)
    return np.asarray(getattr(out, "data", out))


def _to_port32(sjax):
    """A JAX seeded entity at 32 bits → the port's (uint32 arrays lifted)."""
    import dataclasses as dc
    from tfhe_tpu.core.params import DecompParams as JDecomp
    from tfhe_tpu_torch.core.numeric import from_numpy_torus
    from tfhe_tpu_torch.core.params import DecompParams
    fields = {}
    for f in dc.fields(sjax):
        v = getattr(sjax, f.name)
        if isinstance(v, JDecomp):
            v = DecompParams(v.base_log, v.level)
        elif hasattr(v, "dtype"):
            v = from_numpy_torus(np.asarray(v))
        fields[f.name] = v
    return getattr(TS, type(sjax).__name__)(**fields)


@pytest.mark.parametrize("kind", KINDS32)
def test_u32_jax_made_decompresses_in_the_port(kind):
    from tfhe_tpu_torch.core.numeric import to_numpy_torus
    sjax = _u32_made(kind, SEED)[0]
    assert sjax.log_q == 32
    got = port_decompressed(_to_port32(sjax))
    want = _jax_decompressed32(sjax)
    assert want.dtype == np.uint32 and not (got & 0xFFFFFFFF).any()
    np.testing.assert_array_equal(to_numpy_torus(got, 32), want)


@pytest.mark.parametrize("kind", KINDS32)
def test_u32_port_made_matches_jax_masks_and_noise(kind):
    from tfhe_tpu_torch.core.numeric import to_numpy_torus
    sjax, s, full, std = _u32_made(kind, SEED)
    assert s.log_q == 32
    mine = port_decompressed(s)
    if full is not None:
        assert torch.equal(mine, full), "the port's decompression differs from its full key"
    mine, theirs = to_numpy_torus(mine, 32), _jax_decompressed32(sjax)
    np.testing.assert_array_equal(_masks(mine, kind), _masks(theirs, kind))
    diff = (_bodies(mine, kind) - _bodies(theirs, kind)).view(np.int32)
    assert np.abs(diff.astype(np.float64)).max() <= 8 * std, kind
    assert (diff != 0).any(), "the bodies carry no noise"


def test_u32_compressed_boolean_keys_match_jax():
    """The boolean compressed server and public keys at 32 bits: the port's
    seeds lay out the JAX package's streams (masks bit for bit, bodies
    within 8 sigma), and the port's decompressed server key equals the one
    interop builds from the JAX package's decompression."""
    import jax
    import tfhe_tpu.boolean as JB
    from tfhe_tpu_torch import interop
    from tfhe_tpu_torch.core.numeric import to_numpy_torus
    from torch_boolean_u32_jax import client_keys, keys
    k = keys()
    tck, jck = client_keys(k, "pbs_ks")
    jcsk = jax.jit(lambda: JB.gen_compressed_server_key(jck, seed=4))()
    tcsk = boolean.gen_compressed_server_key(tck, seed=4)
    for jx, tx, std in ((jcsk.seeded_bsk, tcsk.seeded_bsk, tck.params.glwe_noise_std),
                        (jcsk.seeded_ksk, tcsk.seeded_ksk, tck.params.lwe_noise_std)):
        kind = "bsk" if "Bootstrap" in type(jx).__name__ else "ksk"
        mine, theirs = to_numpy_torus(port_decompressed(tx), 32), _jax_decompressed32(jx)
        np.testing.assert_array_equal(_masks(mine, kind), _masks(theirs, kind))
        diff = (_bodies(mine, kind) - _bodies(theirs, kind)).view(np.int32)
        assert np.abs(diff.astype(np.float64)).max() <= 8 * std
    carried = boolean.CompressedServerKey(seeded_bsk=_to_port32(jcsk.seeded_bsk),
                                          seeded_ksk=_to_port32(jcsk.seeded_ksk),
                                          params=tck.params).decompress()
    jsk = jax.jit(lambda: jcsk.decompress())()
    want = interop.boolean_server_key(np.asarray(jsk.ksk.data), np.asarray(jsk.bsk.data),
                                      tuple(int(p) for p in _primes(jsk)), tck.params,
                                      device="cpu")
    assert carried.bsk.route == want.bsk.route == "rotate"
    assert torch.equal(carried.bsk.spectra, want.bsk.spectra)
    assert torch.equal(carried.ksk.data, want.ksk.data)
    jcpk = jax.jit(lambda: JB.gen_compressed_public_key(jck, seed=6))()
    tcpk = boolean.gen_compressed_public_key(tck, seed=6)
    mine = to_numpy_torus(port_decompressed(tcpk.seeded), 32)
    theirs = _jax_decompressed32(jcpk.seeded)
    np.testing.assert_array_equal(mine[:, :-1], theirs[:, :-1])


def _primes(jsk):
    from tfhe_tpu.core.poly.ntt import get_plan
    data = np.asarray(jsk.bsk.data)
    return get_plan(data.shape[-1], data.shape[1]).primes
