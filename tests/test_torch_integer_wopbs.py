"""The port's integer WoP-PBS (`tfhe_tpu_torch/integer/wopbs.py`) bit for bit
against tfhe_tpu's (tolerance 0) on the same numpy keys, the only-for-wopbs
regime at TEST_PARAMS_SHORTINT as tests/test_wopbs.py builds it (cbs 6 x
2, pfks 4 x 8; the PFPKSK list made by the port and carried to JAX):

* the radix WoP-PBS over 2 blocks (4 bits: one LUT polynomial) and over 5
  blocks (10 bits: 4 LUT polynomials, so vertical packing runs its CMux
  tree over the two most significant GGSWs), every output block's words,
  degree and noise level equal, decrypted right;
* `wopbs_crt` at moduli (2, 3, 5) with f(x) = x^2 + 1 and at (3, 4) with
  the non-ring f(x) = 2x + 3 (each residue sees only its own value);
* the port's own keys (`new_wopbs_key_only_for_wopbs`) decrypted.

The JAX side runs as `torch_shift_jax.fast_jax()` runs it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.algorithms.wopbs as JW
import tfhe_tpu.shortint.wopbs as JSW
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.integer import ciphertext as jct
from tfhe_tpu.integer.wopbs import new_integer_wopbs_key as jax_integer_wopbs_key
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.params import DecompParams as JD
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.integer import CrtClientKey, RadixClientKey
from tfhe_tpu_torch.integer.wopbs import IntegerWopbsKey, new_integer_wopbs_key
from tfhe_tpu_torch.shortint import wopbs as SW
from torch_jax_pbs import jax_server, port_keys
from torch_keys import encrypt_big, real_keys
from torch_shift_jax import fast_jax, radix_pair, same_radix

CBS, PFKS = DecompParams(6, 2), DecompParams(4, 8)
M = P.message_modulus


@pytest.fixture(scope="module")
def sides():
    """Both packages' integer WoP-PBS keys on one numpy key."""
    with fast_jax():
        k = real_keys(P, seed=91)
        tck, tsk = port_keys(k, P)
        twk = SW.new_wopbs_key_only_for_wopbs(tck, tsk, seed=92)
        jwk = JSW.WopbsKey(server_key=jax_server(k, JP), pfpksk=JW.CbsPfpkskList(
            data=jnp.asarray(to_numpy_u64(twk.pfpksk.data)), decomp=JD(PFKS.base_log,
                                                                       PFKS.level)),
            cbs_decomp=JD(CBS.base_log, CBS.level))
        yield dict(k=k, tck=tck, port=new_integer_wopbs_key(twk),
                   jax=jax_integer_wopbs_key(jwk))


@pytest.mark.parametrize("nb, f, vals", [
    (2, lambda x: (x * 3 + 5) % 16, [0, 7, 11, 15]),
    (5, lambda x: (x * 7 + 13) % 1024, [0, 1023, 600])])
def test_radix_wopbs_equals_jax(sides, nb, f, vals):
    """f over the whole radix value: one LUT polynomial (2 blocks) and four
    with the CMux tree (5 blocks)."""
    a, ja = radix_pair(sides["k"]["big_bits"], vals, nb, seed=100 + nb)
    out, jout = sides["port"].wopbs(a, f), sides["jax"].wopbs(ja, f)
    same_radix(out, jout)
    got = RadixClientKey(key=sides["tck"], num_blocks=nb).decrypt(out)
    assert [int(v) for v in got] == [f(v) for v in vals]


def crt_pair(big_bits, vals, moduli, seed):
    """The same CRT encryptions (block j: x mod m_j) in both packages."""
    data = [encrypt_big(P, big_bits, np.asarray(vals) % mj, seed=seed + j)
            for j, mj in enumerate(moduli)]
    port = interop.radix_ciphertext(data, [mj - 1 for mj in moduli], [1] * len(moduli), M,
                                    P.carry_modulus, kind="crt", moduli=moduli, device="cpu")
    jblocks = [JCt(lwe=JLwe(data=jnp.asarray(d)), degree=mj - 1, message_modulus=M,
                   carry_modulus=P.carry_modulus) for d, mj in zip(data, moduli)]
    return port, jct.CrtCiphertext(blocks=jblocks, moduli=tuple(moduli))


@pytest.mark.parametrize("moduli, f, vals", [
    ((2, 3, 5), lambda x: x * x + 1, [0, 7, 19, 29]),
    ((3, 4), lambda x: 2 * x + 3, [5, 11])])
def test_wopbs_crt_equals_jax(sides, moduli, f, vals):
    """Each residue block j is f(x mod m_j) mod m_j over the one shared GGSW
    list: a ring function (the CRT evaluation of f) and a non-ring one."""
    c, jc = crt_pair(sides["k"]["big_bits"], vals, moduli, seed=200 + len(moduli))
    out, jout = sides["port"].wopbs_crt(c, f), sides["jax"].wopbs_crt(jc, f)
    assert out.moduli == tuple(moduli)
    same_radix(out, jout)
    for j, mj in enumerate(moduli):
        got = sides["tck"].decrypt_message_and_carry(out.blocks[j]) % mj
        assert got.tolist() == [f(v % mj) % mj for v in vals]
    if moduli == (2, 3, 5):
        assert CrtClientKey(key=sides["tck"], moduli=moduli).decrypt(out).tolist() == \
            [f(v) % 30 for v in vals]


def test_port_integer_wopbs_decrypts():
    """The port alone on its own keys: a 3-block radix (6 bits) through an
    arbitrary LUT."""
    torch.set_num_threads(1)
    ck, sk = shortint.gen_keys(P, seed=93, device="cpu")
    iwk = new_integer_wopbs_key(SW.new_wopbs_key_only_for_wopbs(ck, sk, seed=94))
    assert isinstance(iwk, IntegerWopbsKey)
    rck = RadixClientKey(key=ck, num_blocks=3)
    f = lambda x: (x * x + 9) % 64
    vals = [0, 5, 33, 63]
    out = iwk.wopbs(rck.encrypt(vals, seed=95), f)
    assert [int(v) for v in rck.decrypt(out)] == [f(v) for v in vals]
