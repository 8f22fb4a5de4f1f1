"""K7, the external product outside a rotation (`tfhe_tpu_torch/core/poly/
external_product.py`, `csrc/external_product.cu`), and the functions on it,
bit for bit against tfhe_tpu on the same numpy inputs (tolerance 0):

* K7's plain version against JAX `external_product_accumulate` with one
  GGSW for the batch, and `cmux_ntt` with a GGSW per row; words with the
  top bit set (hazard C1);
* `cmux`, `vertical_packing` with and without its CMux tree (the rotation
  K7's rotated operand), `blind_rotate_only` (JAX's XLA `blind_rotate`: the
  rotate-subtract form, one K7 launch a step), the packing keyswitch (one
  LWE and a list), and `linear.py`;
* K7's CUDA source built for the host (`tests/cuda_host_stub.h`, as the
  delta and keyswitch host tests) at N = 512 on two rows, explicit and
  rotated operands, a shared and a per-row GGSW, against its plain version.

The GGSWs are uniform words (exactness needs no encryption): the JAX side
takes them through its `ggsw_to_ntt` (DIF order, Shoup twins), the port
through its own (`ggsw_spectra`).  Every JAX call is jitted."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_host import build_external_product_host
from tfhe_tpu.core.algorithms import bootstrap as JBoot
from tfhe_tpu.core.algorithms import keyswitch as JKs
from tfhe_tpu.core.algorithms import linear as JLin
from tfhe_tpu.core.algorithms import wopbs as JW
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import GgswCiphertext as JGgsw
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LwePackingKeyswitchKey as JPksk
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import bootstrap, keyswitch, linear, wopbs
from tfhe_tpu_torch.core.entities import (GgswCiphertext, GlweCiphertext, LweCiphertext,
                                          LwePackingKeyswitchKey)
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import external_product as ep
from tfhe_tpu_torch.core.poly import ntt
from tfhe_tpu_torch.core.poly.rotation import _kernel_tables
from torch_keys import random_bsk

U64 = np.uint64
N, K = 256, 1                    # TEST_PARAMS_SHORTINT's GLWE
CBS = (5, 3)                     # WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS's cbs decomposition
TOP = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]


def words(rng, shape):
    w = rng.integers(0, 2 ** 64, shape, dtype=U64)
    w.reshape(-1)[:4] = TOP
    return w


def port_spectra(g, decomp):
    return wopbs.ggsw_to_ntt(GgswCiphertext(data=from_numpy_u64(g), decomp=decomp))


@functools.lru_cache(maxsize=None)
def _jax_ggsw_to_ntt(base_log, level):
    d = JDecomp(base_log, level)
    return jax.jit(lambda g: JW.ggsw_to_ntt(JGgsw(data=g, decomp=d), 64))


def jax_spectra(g, decomp):
    return _jax_ggsw_to_ntt(decomp.base_log, decomp.level)(jnp.asarray(g))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("per_row", [False, True])
def test_k7_plain_equals_jax_external_product(per_row):
    """Explicit operand: acc + GGSW [x] operand (`external_product_accumulate`
    with one GGSW) and ct0 + GGSW_b [x] (ct1 - ct0) (`cmux_ntt` with a GGSW
    a row), 3 rows."""
    rng = np.random.default_rng(1 + per_row)
    decomp = DecompParams(*CBS)
    acc, op = words(rng, (3, K + 1, N)), words(rng, (3, K + 1, N))
    g = words(rng, ((3,) if per_row else ()) + (CBS[1], K + 1, K + 1, N))
    hat, sh = jax_spectra(g, decomp)
    jd = JDecomp(*CBS)
    if per_row:
        want = jax.jit(lambda a, b, h, s: JW.cmux_ntt(JGlwe(data=a), JGlwe(data=b), h, s,
                                                      jd, 64).data)(acc, op, hat, sh)
        got = wopbs.cmux_ntt(GlweCiphertext(data=from_numpy_u64(acc)),
                             GlweCiphertext(data=from_numpy_u64(op)),
                             port_spectra(g, decomp), decomp).data
    else:
        want = jax.jit(lambda a, b, h, s: JBoot.external_product_accumulate(
            a, b, h, jd, 64, bsk_shoup=s))(acc, op, hat, sh)
        got = bootstrap.external_product_accumulate(from_numpy_u64(acc), from_numpy_u64(op),
                                                    port_spectra(g, decomp), decomp)
    np.testing.assert_array_equal(to_numpy_u64(got), np.asarray(want))


def test_cmux_selects_and_equals_jax():
    """`cmux` on GGSW(0) and GGSW(1) (trivial GGSWs: the gadget times the
    bit) equals JAX's and selects ct0 exactly, ct1 up to the rounding of
    the operand's decomposition."""
    decomp = DecompParams(*CBS)
    rng = np.random.default_rng(3)
    ct0, ct1 = words(rng, (2, K + 1, N)), words(rng, (2, K + 1, N))
    for bit in (0, 1):
        g = np.zeros((CBS[1], K + 1, K + 1, N), dtype=U64)
        for lvl in range(CBS[1]):
            for r in range(K + 1):
                g[lvl, r, r, 0] = U64(bit << (64 - CBS[0] * (lvl + 1)))
        hat, sh = jax_spectra(g, decomp)
        want = np.asarray(jax.jit(lambda a, b, h: JBoot.cmux(
            JGlwe(data=a), JGlwe(data=b), h, JDecomp(*CBS), 64).data)(ct0, ct1, hat))
        got = to_numpy_u64(bootstrap.cmux(GlweCiphertext(data=from_numpy_u64(ct0)),
                                          GlweCiphertext(data=from_numpy_u64(ct1)),
                                          port_spectra(g, decomp), decomp).data)
        np.testing.assert_array_equal(got, want)
        # GGSW(0) gives ct0 exactly; GGSW(1) gives ct1 up to the operand's
        # rounding to a multiple of q / B^L
        diff = (got - (ct1 if bit else ct0)).view(np.int64)
        assert np.abs(diff).max() <= (0 if bit == 0 else 1 << (63 - CBS[0] * CBS[1]))


@pytest.mark.parametrize("luts", [1, 4])
def test_vertical_packing_equals_jax(luts):
    """3 GGSWs a row, 2 rows; 1 LUT polynomial (no tree: three rotation
    steps on K7's rotated operand) or 4 (a tree of two CMux layers, then
    one rotation step)."""
    decomp = DecompParams(*CBS)
    rng = np.random.default_rng(4 + luts)
    lut = words(rng, (luts, N))
    gs = [words(rng, (2, CBS[1], K + 1, K + 1, N)) for _ in range(3)]
    hats, shoups = zip(*[jax_spectra(g, decomp) for g in gs])
    jd = JDecomp(*CBS)
    want = jax.jit(lambda l, h, s: JW.vertical_packing(l, list(h), list(s), jd, K, 64).data)(
        lut, hats, shoups)
    got = wopbs.vertical_packing(from_numpy_u64(lut), [port_spectra(g, decomp) for g in gs],
                                 decomp, K)
    np.testing.assert_array_equal(to_numpy_u64(got.data), np.asarray(want))


def test_blind_rotate_only_equals_jax_xla_rotation():
    """The PBS without its extraction: JAX's XLA `blind_rotate` (the
    rotate-subtract form) against the port's K7 steps, one K7 launch a
    step on the card; a classic and a paired key give the same output."""
    bsk = random_bsk(P, seed=6)
    rng = np.random.default_rng(7)
    lwe = words(rng, (3, P.lwe_dimension + 1))
    lut = words(rng, (K + 1, N))
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=P.pbs_decomp), 64, 4))(
        jnp.asarray(bsk))
    want = jax.jit(lambda b, c, l: JBoot.blind_rotate_only(JLwe(data=c), JGlwe(data=l), b,
                                                           64).data)(jbsk, lwe, lut)
    for key in (interop.bootstrap_key_from_standard(bsk, P.pbs_decomp, 4, device="cpu"),
                interop.paired_bootstrap_key_from_standard(bsk, P.pbs_decomp, 4,
                                                           device="cpu")):
        got = bootstrap.blind_rotate_only(LweCiphertext(data=from_numpy_u64(lwe)),
                                          GlweCiphertext(data=from_numpy_u64(lut)), key)
        np.testing.assert_array_equal(to_numpy_u64(got.data), np.asarray(want))


@pytest.mark.parametrize("base_log, level", [(4, 8), (12, 3)])
def test_packing_keyswitch_equals_jax(base_log, level):
    """One LWE into a GLWE and a list of 5 into one, on the tensor-core
    form's shape (4 x 8) and the wide form's (12 x 3)."""
    rng = np.random.default_rng(8 + base_log)
    n_in = 32
    key = words(rng, (n_in, level, K + 1, N))
    cts = words(rng, (5, n_in + 1))
    jd = JDecomp(base_log, level)
    jk = JPksk(data=jnp.asarray(key), decomp=jd)
    tk = LwePackingKeyswitchKey(data=from_numpy_u64(key), decomp=DecompParams(base_log, level))
    one = jax.jit(lambda c: JKs.packing_keyswitch_lwe_to_glwe(JLwe(data=c), jk, 64).data)
    many = jax.jit(lambda c: JKs.packing_keyswitch_lwe_list_to_glwe(JLwe(data=c), jk, 64).data)
    t = LweCiphertext(data=from_numpy_u64(cts))
    np.testing.assert_array_equal(
        to_numpy_u64(keyswitch.packing_keyswitch_lwe_to_glwe(t, tk).data), np.asarray(one(cts)))
    np.testing.assert_array_equal(
        to_numpy_u64(keyswitch.packing_keyswitch_lwe_list_to_glwe(t, tk).data),
        np.asarray(many(cts)))


def test_linear_algebra_equals_jax():
    rng = np.random.default_rng(9)
    a, b = words(rng, (3, 17)), words(rng, (3, 17))
    ga, gb = words(rng, (2, K + 1, N)), words(rng, (2, K + 1, N))
    pt, c, poly = 2 ** 63 + 5, 2 ** 64 - 3, words(rng, (N,))
    ta, tb = LweCiphertext(data=from_numpy_u64(a)), LweCiphertext(data=from_numpy_u64(b))
    ja, jb = JLwe(data=jnp.asarray(a)), JLwe(data=jnp.asarray(b))
    tga, tgb = GlweCiphertext(data=from_numpy_u64(ga)), GlweCiphertext(data=from_numpy_u64(gb))
    jga, jgb = JGlwe(data=jnp.asarray(ga)), JGlwe(data=jnp.asarray(gb))
    pairs = [
        (linear.lwe_add(ta, tb), JLin.lwe_add(ja, jb)),
        (linear.lwe_sub(ta, tb), JLin.lwe_sub(ja, jb)),
        (linear.lwe_neg(ta), JLin.lwe_neg(ja)),
        (linear.lwe_add_plaintext(ta, pt), JLin.lwe_add_plaintext(ja, U64(pt))),
        (linear.lwe_sub_plaintext(ta, pt), JLin.lwe_sub_plaintext(ja, U64(pt))),
        (linear.lwe_mul_cleartext(ta, c), JLin.lwe_mul_cleartext(ja, U64(c))),
        (linear.glwe_add(tga, tgb), JLin.glwe_add(jga, jgb)),
        (linear.glwe_sub(tga, tgb), JLin.glwe_sub(jga, jgb)),
        (linear.glwe_add_plaintext_poly(tga, from_numpy_u64(poly)),
         JLin.glwe_add_plaintext_poly(jga, jnp.asarray(poly)))]
    for got, want in pairs:
        np.testing.assert_array_equal(to_numpy_u64(got.data), np.asarray(want.data))


# ---------------------------------------------------------------------------
# K7's CUDA source on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_external_product_host(tmp_path_factory.mktemp("host_external_product"),
                                       ("tfhe_external_product",))


def host_k7(lib, plan, decomp, ct0, s0, ct1, s1, exps, se, key, sk, rows):
    """K7 through its C entry, with the tables and constants the wrapper
    passes; res and out poisoned first."""
    P, J, R, n = key.shape[-4:]
    tab, consts = _kernel_tables(plan, "cpu")
    res = torch.full((rows, P, R, n), -1, dtype=torch.int32)
    out = torch.full((rows, R, n), 12345, dtype=torch.int64)
    code = lib.tfhe_external_product(
        ct0.data_ptr(), s0, None if ct1 is None else ct1.data_ptr(), s1,
        None if exps is None else exps.data_ptr(), se, key.data_ptr(), sk, tab.data_ptr(),
        consts.data_ptr(), res.data_ptr(), out.data_ptr(), rows, n, plan.log_n, P, R,
        decomp.level, decomp.base_log, None)
    assert code == 0
    return out


@pytest.mark.parametrize("mode", ["explicit", "rotated", "shared"])
def test_k7_host_build_equals_plain(host_lib, mode):
    """N = 512, k = 1, the WoP-PBS's cbs 5 x 3 (J = 6) over 3 primes, two
    rows: explicit operands with a GGSW a row; the rotated operand
    (exponents 5 and 1000: the wrap) with a GGSW a row; the rotated operand
    of one shared ct0 row and one shared GGSW (both stride 0)."""
    n, R, decomp = 512, 2, DecompParams(*CBS)
    plan = ntt.get_plan(n, 3)
    rng = np.random.default_rng(10)
    ct0 = from_numpy_u64(words(rng, (2, R, n)))
    ct1 = from_numpy_u64(words(rng, (2, R, n)))
    key = torch.stack([torch.from_numpy(rng.integers(0, p, (2, 3 * R, R, n)))
                       for p in plan.primes], dim=1).to(torch.int32)     # [2, P, J, R, N]
    exps = torch.tensor([5, 1000], dtype=torch.int32)
    if mode == "explicit":
        got = host_k7(host_lib, plan, decomp, ct0, R * n, ct1, R * n, None, 0, key,
                      key[0].numel(), 2)
        want = ep.external_product_plain(ct0, key, decomp, ct1=ct1)
    elif mode == "rotated":
        got = host_k7(host_lib, plan, decomp, ct0, R * n, None, 0, exps, 1, key,
                      key[0].numel(), 2)
        want = ep.external_product_plain(ct0, key, decomp, exps=exps)
    else:
        got = host_k7(host_lib, plan, decomp, ct0[0].contiguous(), 0, None, 0, exps, 1,
                      key[0].contiguous(), 0, 2)
        want = ep.external_product_plain(ct0[0], key[0], decomp, exps=exps)
    assert torch.equal(got, want)


def test_k7_wrapper_refuses_bad_operands():
    decomp = DecompParams(*CBS)
    key = torch.zeros((3, 6, 2, 64), dtype=torch.int32)
    ct = torch.zeros((2, 2, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="not both"):
        ep.external_product(ct, key, decomp)
    with pytest.raises(ValueError, match="not both"):
        ep.external_product(ct, key, decomp, ct1=ct, exps=torch.zeros(2))
    with pytest.raises(ValueError, match="disagree"):
        ep.external_product(ct, key, DecompParams(5, 2), ct1=ct)
    with pytest.raises(ValueError, match="no external-product kernel"):
        ep.external_product(ct.to("meta"), key.to("meta"), decomp, ct1=ct.to("meta"))


def test_k8_wrapper_refuses_bad_operands():
    """K8's wrapper: more primes than PRIMES_31's 7, base_log * level above
    64, shapes that disagree, and a device that is neither the CPU nor the
    card."""
    acc = torch.zeros((2, 2, 64, 2), dtype=torch.int64)
    exps = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="7 primes"):
        ep.external_product128(acc, torch.zeros((8, 2, 2, 64), dtype=torch.int32),
                               DecompParams(23, 1), exps)
    with pytest.raises(ValueError, match="base_log 1..30"):
        ep.external_product128(acc, torch.zeros((6, 10, 2, 64), dtype=torch.int32),
                               DecompParams(13, 5), exps)
    with pytest.raises(ValueError, match="disagree"):
        ep.external_product128(acc, torch.zeros((6, 4, 2, 64), dtype=torch.int32),
                               DecompParams(23, 1), exps)
    with pytest.raises(ValueError, match="no external-product kernel"):
        ep.external_product128(acc.to("meta"), torch.zeros((6, 2, 2, 64), dtype=torch.int32,
                                                           device="meta"),
                               DecompParams(23, 1), exps.to("meta"))
