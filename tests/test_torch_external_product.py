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
  delta and keyswitch host tests), in both forms `_ep_layout` gives (one
  block a row, a cluster of blocks a row) and the rule's, against its plain
  version: explicit and rotated operands, a shared and a per-row GGSW and
  ct0, the gadget MVB's J = 16 at k+1 = 4, the gadget DEFAULT's k+1 = 3,
  J = 18, N = 16 to 2048, batch 1 and batches that are not a multiple of
  the cluster;
* `_ep_layout`'s plan for every named set whose path reaches K7 or K8.

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
from tfhe_tpu_torch.core.poly.rotation import _delta_tables
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


def host_k7(lib, plan, decomp, ct0, s0, ct1, s1, exps, se, key, sk, rows, form=None):
    """K7 through its C entry, with the tables, constants and layout the
    wrapper passes (`form` = (cluster, stage) forces the layout's); out
    poisoned first."""
    P, J, R, n = key.shape[-4:]
    lay = ep._ep_layout(rows, n, R, J, P, form)
    out = torch.full((rows, R, n), 12345, dtype=torch.int64)
    code = lib.tfhe_external_product(
        ct0.data_ptr(), s0, None if ct1 is None else ct1.data_ptr(), s1,
        None if exps is None else exps.data_ptr(), se, key.data_ptr(), sk,
        _delta_tables(plan, "cpu", variants=True).data_ptr(), ep._ep_consts(plan).ctypes.data,
        out.data_ptr(), rows, plan.log_n, P, R, decomp.level, decomp.base_log,
        *ep._ep_launch_args(lay), None)
    assert code == 0
    return out


# case -> (N, k+1, base_log, level, P, rows, operand, the GGSW shared, ct0 shared)
K7_HOST_CASES = {
    "explicit": (512, 2, *CBS, 3, 2, "explicit", False, False),
    "rotated": (512, 2, *CBS, 3, 2, "rotated", False, False),
    "shared": (512, 2, *CBS, 3, 2, "rotated", True, True),
    "mvb": (512, 4, 6, 4, 3, 2, "rotated", True, False),          # AES_PARAMETERS_40: J = 16
    "gadget_default": (512, 3, 6, 3, 3, 1, "rotated", True, False),   # k = 2: R odd, rt = 1
    "wide_j": (64, 2, 7, 9, 3, 5, "explicit", False, False),      # J = 18: reduced every 16
    "small": (16, 2, 11, 2, 2, 3, "rotated", False, False),
    "regions": (2048, 2, *CBS, 3, 2, "explicit", False, False),   # one warp a 256-slot region
    "shared_ct0": (256, 2, 10, 2, 4, 3, "explicit", False, True),
}


# the forms each case runs in: (cluster, stage), "P" a cluster of P, None the rule's
K7_FORMS = {"block": (1, False), "block staged": (1, True), "cluster": ("P", False),
            "rule": None}


@pytest.mark.parametrize("form", list(K7_FORMS))
@pytest.mark.parametrize("case", list(K7_HOST_CASES))
def test_k7_host_build_equals_plain(host_lib, case, form):
    """K7's source on the host against its plain version, words with the
    top bit set (C1), exponents with and without the wrap (2N - 1 among
    them), in one block a row (the operand read a prime, or staged in
    shared memory), a cluster of P blocks a row and the form the rule picks
    (K7_HOST_CASES: the WoP-PBS's cbs 5 x 3, the gadget MVB's J = 16 at
    k+1 = 4, k+1 = 3, J = 18, N = 16 and 2048, one and several rows, none
    a multiple of the cluster but 1; at N = 2048 and P = 3 in one block or
    clusters of 3, and at the MVB's shape in one block, the kernels
    compiled for those shapes)."""
    n, R, base_log, level, P, rows, operand, key_shared, ct0_shared = K7_HOST_CASES[case]
    decomp = DecompParams(base_log, level)
    plan = ntt.get_plan(n, P)
    rng = np.random.default_rng(sum(map(ord, case)))
    ct0 = from_numpy_u64(words(rng, (rows, R, n)))
    ct1 = from_numpy_u64(words(rng, (rows, R, n)))
    key = torch.stack([torch.from_numpy(rng.integers(0, p, (rows, level * R, R, n)))
                       for p in plan.primes], dim=1).to(torch.int32)     # [rows, P, J, R, N]
    # the kernel takes any int64 exponent mod 2N: negative ones and ones past 2N too
    exps = torch.tensor(([5, 2 * n - 1, -n - 3, 0, 3 * n] * rows)[:rows], dtype=torch.int64)
    k_in, sk = (key[0].contiguous(), 0) if key_shared else (key, key[0].numel())
    c_in, s0 = (ct0[0].contiguous(), 0) if ct0_shared else (ct0, R * n)
    f = K7_FORMS[form]
    f = f if f is None or f[0] != "P" else (P, False)
    if operand == "explicit":
        got = host_k7(host_lib, plan, decomp, c_in, s0, ct1, R * n, None, 0, k_in, sk, rows, f)
        want = ep.external_product_plain(c_in, k_in, decomp, ct1=ct1)
    else:
        got = host_k7(host_lib, plan, decomp, c_in, s0, None, 0, exps, 1, k_in, sk, rows, f)
        want = ep.external_product_plain(c_in, k_in, decomp, exps=exps)
    assert torch.equal(got, want.reshape(rows, R, n))


def _ep_shapes(family: str) -> list:
    """(name, N, k+1, decomposition, P) of every named set's K7 or K8 shape
    in a family: "wopbs", the WoP sets' circuit bootstrap (the CMux tree
    and the vertical packing); "shift key", the GGSW shift key's cbs 4 x 4
    on them; "gadget", the gadget sets' PBS (MVB's blind_rotate_only);
    "2^128", 2_2 on the 2^128 torus (K8)."""
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes as primes
    from tfhe_tpu_torch.core.algorithms.pbs128 import external_product_num_primes128
    from tfhe_tpu_torch.core.params import (GADGET, SHORTINT_WOPBS, TEST_PARAMS_GADGET,
                                            TEST_PARAMS_WOPBS, shortint_params)
    from tfhe_tpu_torch.integer.shift_key import SHIFT_CBS_DECOMP
    wop = {**SHORTINT_WOPBS, "TEST_PARAMS_WOPBS": TEST_PARAMS_WOPBS}
    if family in ("wopbs", "shift key"):
        return [(name, p.polynomial_size, p.glwe_size, d, primes(p.polynomial_size, p.glwe_size, d))
                for name, p in wop.items()
                for d in [p.cbs_decomp if family == "wopbs" else SHIFT_CBS_DECOMP]]
    if family == "gadget":
        return [(name, p.polynomial_size, p.glwe_size, p.pbs_decomp,
                 primes(p.polynomial_size, p.glwe_size, p.pbs_decomp))
                for name, p in {**GADGET, "TEST_PARAMS_GADGET": TEST_PARAMS_GADGET}.items()]
    p = shortint_params("PARAM_MESSAGE_2_CARRY_2_KS_PBS")
    return [(p.name, p.polynomial_size, p.glwe_size, p.pbs_decomp,
             external_product_num_primes128(p.polynomial_size, p.glwe_size, p.pbs_decomp))]


@pytest.mark.parametrize("batch", [1, 64, 512])
@pytest.mark.parametrize("family", ["wopbs", "shift key", "gadget", "2^128"])
def test_ep_layout_plans_every_named_shape(family, batch):
    """`_ep_layout` gives every named set's K7/K8 shape (`_ep_shapes`) a
    launch plan the kernel takes: a cluster dividing P (at most 8; K8 at
    most 7 primes), the passes
    covering log2 N stages (the head, the tails and the MAC's two), the
    MAC's outputs in whole chunks, shared memory 4 (J + R P / C) N within
    one block's, 8 R N more staged (only where a block runs several
    primes); the rule's form among those that leave two blocks a SM their
    shared memory (if any): the largest cluster where none fills the card,
    else the smallest filling cluster with a staged form, else the smallest
    filling one."""
    shapes = _ep_shapes(family)
    assert shapes
    for name, n, R, decomp, P in shapes:
        J = decomp.level * R
        assert 1 <= decomp.base_log <= 30 and decomp.base_log * decomp.level <= 64, name
        assert P <= (7 if family == "2^128" else 8), name
        lay = ep._ep_layout(batch, n, R, J, P)
        smem = {(c, st): 4 * (J + R * P // c) * n + (8 * R * n if st else 0)
                for c in range(1, min(P, 8) + 1) if P % c == 0
                for st in (False, True) if not st or P // c > 1}
        fits = {f: b for f, b in smem.items() if b <= 232448}
        two = {f: b for f, b in fits.items() if b <= 232448 // 2} or fits
        filled = sorted({c for c, _ in two if batch * c >= ep._EP_FILL})
        staged = [c for c in filled if (c, True) in two]
        c = staged[0] if staged else filled[0] if filled else max(c for c, _ in two)
        assert (lay.cluster, lay.stage) == (c, (c, True) in two), name
        assert P % lay.cluster == 0 and lay.cluster <= 8, name
        assert sum(lay.head) + sum(lay.tail) + 2 == n.bit_length() - 1, name
        assert lay.log_w == n.bit_length() - 1 - sum(lay.head) and R % lay.rt == 0, name
        assert lay.smem == smem[(lay.cluster, lay.stage)] <= 232448, name


def test_k7_wrapper_refuses_bad_operands():
    """Neither or both operands, shapes that disagree, a device that is
    neither the CPU nor the card, and a layout no cluster takes (a cluster
    that does not divide P, shared memory beyond one block's)."""
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
    with pytest.raises(ValueError, match="cluster dividing P"):
        ep._ep_layout(2, 64, 2, 6, 3, form=(2, False))
    with pytest.raises(ValueError, match="cluster dividing P"):
        ep._ep_layout(2, 64, 2, 6, 3, form=(3, True))      # one prime a block: nothing to stage
    with pytest.raises(ValueError, match="no cluster"):
        ep._ep_layout(2, 65536, 2, 6, 1)


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
