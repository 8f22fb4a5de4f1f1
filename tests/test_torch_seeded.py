"""The port's seeded entities (`tfhe_tpu_torch.core.algorithms.seeded`)
against the JAX package's (`tfhe_tpu.core.algorithms.seeded`), all nine, at
TEST_PARAMS_SHORTINT widths on numpy secret keys: a JAX-made entity
decompresses in the port bit-identically to the JAX package's own
decompression; one the port makes from the same secret bits and seed has
the JAX package's masks bit for bit, and bodies that differ from the JAX
package's by noise alone, within 8 sigma (the Gaussian noise comes from
each package's own generator); slices decompress as the whole does; a
compressed server key decompresses into the server key's spectra and KSK;
`gen_client_key` is the client key of `gen_keys`."""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch import boolean, cuda_lib, shortint
from tfhe_tpu_torch.core.algorithms import (bootstrap_key_to_ntt, external_product_num_primes,
                                            seeded as TS)
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN, TEST_PARAMS_SHORTINT
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from torch_seeded_jax import (KINDS, jax_decompressed, jax_made, noise_std, port_decompressed,
                              port_made, to_port)

SEED = 0x9E3779B9            # bit 31 set


@pytest.mark.parametrize("kind", KINDS)
def test_jax_made_decompresses_in_the_port(kind):
    full, sjax = jax_made(kind, SEED)
    got = to_numpy_u64(port_decompressed(to_port(sjax)))
    want = jax_decompressed(kind, SEED)
    np.testing.assert_array_equal(got, want)
    if full is not None:
        np.testing.assert_array_equal(got, full)


def _bodies(data: np.ndarray, kind: str) -> np.ndarray:
    """The body words of full data (the rest is mask)."""
    if kind in ("lwe", "ksk", "public_key"):
        return data[..., -1]
    if kind == "compact_public_key":
        return data[1]
    return data[..., -1, :]


def _masks(data: np.ndarray, kind: str) -> np.ndarray:
    if kind in ("lwe", "ksk", "public_key"):
        return data[..., :-1]
    if kind == "compact_public_key":
        return data[0]
    return data[..., :-1, :]


@pytest.mark.parametrize("kind", KINDS)
def test_port_made_matches_jax_masks_and_noise(kind):
    full, s = port_made(kind, SEED)
    mine = port_decompressed(s)
    if full is not None:
        assert torch.equal(mine, full), "the port's decompression differs from its full key"
    mine = to_numpy_u64(mine)
    theirs = jax_decompressed(kind, SEED)
    np.testing.assert_array_equal(_masks(mine, kind), _masks(theirs, kind))
    diff = (_bodies(mine, kind) - _bodies(theirs, kind)).view(np.int64)
    bound = 8 * noise_std(kind)
    assert np.abs(diff.astype(np.float64)).max() <= bound, kind
    assert (diff != 0).any(), "the bodies carry no noise"


def test_slices_decompress_as_the_whole():
    _, bsk = port_made("bsk", SEED)
    whole = TS.decompress_bootstrap_key(bsk).data
    n = whole.shape[0]
    bits = torch.tensor([0, 1, n - 2, n - 1])
    assert torch.equal(TS.decompress_bootstrap_key(bsk, bits=bits).data, whole[bits])
    assert torch.equal(TS.decompress_bootstrap_key(bsk, bits=slice(3, 7)).data, whole[3:7])
    _, ksk = port_made("ksk", SEED)
    whole = TS.decompress_keyswitch_key(ksk).data
    for rows in ((0, 3), (whole.shape[0] - 5, whole.shape[0]), (7, 7)):
        part = TS.decompress_keyswitch_key(ksk, rows=rows).data
        assert torch.equal(part, whole[rows[0]:rows[1]])


def test_server_key_decompresses_into_spectra_and_ksk():
    _, bsk = port_made("bsk", SEED)
    _, ksk = port_made("ksk", SEED)
    ntt_bsk, got_ksk = TS.decompress_server_key(bsk, ksk)
    std = TS.decompress_bootstrap_key(bsk)
    _, _, R, _, N = std.data.shape
    want = bootstrap_key_to_ntt(std, external_product_num_primes(N, R, bsk.decomp))
    assert torch.equal(ntt_bsk.spectra, want.spectra)
    assert (ntt_bsk.primes, ntt_bsk.route) == (want.primes, want.route)
    assert torch.equal(got_ksk.data, TS.decompress_keyswitch_key(ksk).data)


@pytest.mark.parametrize("scheme,params", [(shortint, TEST_PARAMS_SHORTINT),
                                           (boolean, TEST_PARAMS_BOOLEAN)])
def test_gen_client_key_is_the_client_key_of_gen_keys(scheme, params, monkeypatch):
    ck = scheme.gen_client_key(params, seed=5, device="cpu")
    want, _ = scheme.gen_keys(params, seed=5, device="cpu")
    assert torch.equal(ck.glwe_sk.bits, want.glwe_sk.bits)
    assert torch.equal(ck.lwe_sk.bits, want.lwe_sk.bits)
    assert ck.params == want.params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheme.gen_client_key(params, seed=5)


def test_decompress_on_a_card_by_name_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, bsk = port_made("bsk", SEED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.decompress_bootstrap_key(bsk, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_lib.resolve_device("cuda:0")


def test_32_bit_torus_refused():
    """The 32-bit torus, once refused here (ROADMAP A9c), decompresses now:
    the 32-bit words of the seed's stream, lifted (its parity with JAX is
    tests/test_torch_seeded_u32.py).  A width the port does not hold is still refused."""
    _, s = port_made("lwe", SEED)
    lifted = TS.decompress_lwe(TS.SeededLweCiphertext(body=s.body, seed=s.seed,
                                                      lwe_dimension=s.lwe_dimension, log_q=32))
    assert not (lifted.data[..., :-1] & 0xFFFFFFFF).any()
    with pytest.raises(ValueError, match="torus width 16"):
        TS.decompress_lwe(TS.SeededLweCiphertext(body=s.body, seed=s.seed,
                                                 lwe_dimension=s.lwe_dimension, log_q=16))
