"""K6 (the staged blind rotation) and the J > 15 bodies of K1, K3, K4 and
K5, all from `tfhe_tpu_torch/csrc/rotation.cu` built for the host against
`tests/cuda_host_stub.h` and run on the CPU, held bit for bit against the
plain rotation.  No JAX.

K6 runs at the shapes it takes on the card (N = 4096 with L = 2, N = 8192,
delta and variant steps with g = 1 and 3) and, forced (`_staged=True` on
the card), at small N with one or two head passes; each over 2 steps at
batch 1 or 2, through the layout and tables the wrapper passes.  K1/K4 run
at `AES_PARAMETERS_40`'s shape (J = 16) and the WoP-PBS shape (J = 18), K3
and K5 at J = 16 and 18 (a cluster of 1: the stub does not model
clusters).  `chip_smoke.py` holds the same kernels on the card.
"""
import numpy as np
import pytest
import torch

from cuda_host import build_rotation_host
from tfhe_tpu_torch.core.entities import NttBootstrapKey, NttMultiBitBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation

ENTRIES = ("tfhe_staged_rotate", "tfhe_blind_rotate", "tfhe_blind_rotate_step",
           "tfhe_blind_rotate_multi_bit", "tfhe_blind_rotate_step_variants")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_rotation_host(tmp_path_factory.mktemp("host_staged"), ENTRIES)


def inputs(n, R, L, P, g, batch, steps, seed, base_log=None):
    """Key residues [steps, (2^g,) P, J, R, N] int32, acc [batch, R, N] u64
    with the top bit set in places, exponents [batch, steps(, 2^g - 1)].
    With `base_log`, the first step is the MAC's worst case instead: acc
    zero but for coefficient 0, whose balanced digits are all -1, so that
    every digit spectrum is p - 1 in every slot, and the key residues p - 1
    in a random half of the slots, 0 in the others: each MAC sum there
    gathers J products of (p - 1)^2.  (Were they p - 1 in every slot, a
    64-bit sum that wraps would wrap alike in every slot and prime, and its
    error, a multiple of 2^64, would vanish in the lift.)"""
    rng = np.random.default_rng(seed)
    plan = ntt.get_plan(n, P)
    lead = (steps, 1 << g) if g else (steps,)
    key = np.stack([rng.integers(0, p, lead + (L * R, R, n)) for p in plan.primes],
                   axis=len(lead)).astype(np.int32)
    acc = rng.integers(0, 2 ** 64, (batch, R, n), dtype=np.uint64)
    acc[0, 0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    if base_log is not None:
        key[0] = (np.array(plan.primes, dtype=np.int64).reshape(
            (-1,) + (1,) * (key.ndim - 2 - (1 if g else 0))) - 1) * rng.integers(0, 2, n)
        ones = sum(1 << (base_log * l) for l in range(L))        # digits all 1
        acc[:] = 0
        acc[:, :, 0] = np.uint64((-ones << (64 - base_log * L)) % 2 ** 64)
    exps = rng.integers(0, 2 * n, (batch, steps) + (((1 << g) - 1,) if g else ())
                        ).astype(np.int32)
    return plan, key, acc, exps


def plain(acc, exps, key, L, base_log, plan, g):
    decomp = DecompParams(base_log=base_log, level=L)
    spectra = torch.from_numpy(key)
    k = (NttMultiBitBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes,
                                 grouping_factor=g) if g else
         NttBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes))
    return to_numpy_u64(rotation.blind_rotate_plain(
        from_numpy_u64(acc), torch.from_numpy(exps.astype(np.int64)), k))


def staged(lib, out, exps, e_stride, e_step, key, n, R, L, base_log, P, g, steps):
    """One tfhe_staged_rotate call on numpy arrays, as `rotation._staged_rotate`
    makes it; → its return code."""
    plan = ntt.get_plan(n, P)
    lay = rotation._staged_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu", bool(g)).numpy()
    spec = np.empty((out.shape[0], P, L * R, n), dtype=np.int32)
    res = np.empty((out.shape[0], P, R, n), dtype=np.int32)
    return lib.tfhe_staged_rotate(
        out.ctypes.data, exps.ctypes.data, e_stride, e_step, key.ctypes.data, tab.ctypes.data,
        rotation._host_consts(plan).ctypes.data, spec.ctypes.data, res.ctypes.data,
        out.shape[0], steps, n, plan.log_n, P, R, L, base_log, g,
        *rotation._staged_args(lay), None)


# (N, R, L, base_log, P, g, batch): K6's shapes on the card (N = 4096 at L = 2,
# 3_3, and the 3_3 multi-bit and paired steps), and forced at small N (one
# head pass of radix 1, 2 or 3; a region of 32 slots at N = 64)
STAGED = [(4096, 2, 2, 15, 4, 0, 1), (8192, 2, 2, 15, 4, 0, 2), (8192, 2, 2, 14, 4, 1, 1),
          (8192, 2, 2, 14, 4, 3, 1), (64, 2, 2, 10, 2, 0, 2), (512, 2, 1, 23, 4, 0, 2),
          (1024, 3, 2, 10, 3, 0, 2), (2048, 2, 1, 23, 4, 0, 2), (64, 2, 2, 10, 2, 2, 2),
          (512, 2, 1, 20, 4, 3, 2)]


@pytest.mark.parametrize("n, R, L, base_log, P, g, batch", STAGED)
def test_k6_source_on_the_host_equals_the_plain_rotation(host_lib, n, R, L, base_log, P, g,
                                                         batch):
    plan, key, acc, exps = inputs(n, R, L, P, g, batch, 2, seed=n + g)
    out = acc.copy()
    e_step = (1 << g) - 1 if g else 1
    assert staged(host_lib, out, exps, exps.strides[0] // 4, e_step, key, n, R, L, base_log,
                  P, g, 2) == 0
    assert np.array_equal(out, plain(acc, exps, key, L, base_log, plan, g))


@pytest.mark.parametrize("g", [0, 1])
def test_k6_mac_takes_18_digit_rows_at_their_worst(host_lib, g):
    """K6 forced at the WoP-PBS shape (J = 18), the first step every MAC
    sum's largest: 18 products of (p - 1)^2 pass 2^64 unless reduced."""
    n, R, L, base_log, P = 1024, 3, 6, 7, 3
    plan, key, acc, exps = inputs(n, R, L, P, g, 2, 2, seed=18 + g, base_log=base_log)
    out = acc.copy()
    assert staged(host_lib, out, exps, exps.strides[0] // 4, (1 << g) - 1 if g else 1, key,
                  n, R, L, base_log, P, g, 2) == 0
    assert np.array_equal(out, plain(acc, exps, key, L, base_log, plan, g))


@pytest.mark.parametrize("g", [0, 1])
def test_k6_one_step_launches_read_the_exponents_through_their_stride(host_lib, g):
    """The per-step route at a staged shape: one K6 step a call, the
    step's exponent column read in place."""
    n, R, L, base_log, P = 8192, 2, 2, 15, 4
    plan, key, acc, exps = inputs(n, R, L, P, g, 2, 2, seed=5 + g)
    out = acc.copy()
    for j in range(2):
        assert staged(host_lib, out, exps[:, j:], exps.strides[0] // 4, 0, key[j:], n, R, L,
                      base_log, P, g, 1) == 0
    assert np.array_equal(out, plain(acc, exps, key, L, base_log, plan, g))


def test_k6_refuses_a_layout_that_does_not_cover_the_stages(host_lib):
    n, R, L, base_log, P = 2048, 2, 1, 23, 4
    plan, key, acc, exps = inputs(n, R, L, P, 0, 1, 1, seed=1)
    lay = rotation._staged_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    spec = np.empty((1, P, L * R, n), dtype=np.int32)
    res = np.empty((1, P, R, n), dtype=np.int32)
    rt, head, tail, log_w, warps, smem = rotation._staged_args(lay)
    for bad in ((rt, head, rotation._pack((3,)), log_w, warps, smem),   # a stage short
                (rt, head, tail, log_w, warps, smem + 16),              # not the regions' smem
                (rt, head, tail, log_w, 16, 16 * smem // warps),        # more than 8 warps
                (3, head, tail, log_w, warps, smem)):                   # rt does not divide R
        assert host_lib.tfhe_staged_rotate(
            acc.ctypes.data, exps.ctypes.data, 1, 1, key.ctypes.data, tab.ctypes.data,
            rotation._host_consts(plan).ctypes.data, spec.ctypes.data, res.ctypes.data, 1, 1,
            n, plan.log_n, P, R, L, base_log, 0, *bad, None) != 0


# ---- J > 15: K1/K4 (the delta MAC) and K3/K5 (the variant MAC) ---------------

# AES_PARAMETERS_40 (N = 512, k = 3, L = 4: J = 16) and the WoP-PBS sets
# (N = 1024, k = 2, L = 6: J = 18)
WIDE = [(512, 4, 4, 6, 3), (1024, 3, 6, 7, 3)]


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("n, R, L, base_log, P", WIDE)
def test_k1_and_k4_bodies_take_more_than_15_digit_rows(host_lib, n, R, L, base_log, P, worst):
    plan, key, acc, exps = inputs(n, R, L, P, 0, 2, 2, seed=L * R,
                                  base_log=base_log if worst else None)
    lay = rotation._delta_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    hc = rotation._host_consts(plan)
    want = plain(acc, exps, key, L, base_log, plan, 0)
    out = acc.copy()
    assert host_lib.tfhe_blind_rotate(out.ctypes.data, exps.ctypes.data, key.ctypes.data,
                                      tab.ctypes.data, hc.ctypes.data, 2, 2, n, plan.log_n, P,
                                      R, L, base_log, *rotation._delta_args(lay), None) == 0
    assert np.array_equal(out, want)
    out = acc.copy()
    for j in range(2):
        assert host_lib.tfhe_blind_rotate_step(
            out.ctypes.data, exps[:, j:].ctypes.data, exps.shape[1], key[j].ctypes.data,
            tab.ctypes.data, hc.ctypes.data, 2, n, plan.log_n, P, R, L, base_log,
            *rotation._delta_args(lay), None) == 0
    assert np.array_equal(out, want)


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("n, R, L, base_log, P, g", [(512, 4, 4, 6, 3, 2),
                                                     (1024, 3, 6, 7, 3, 1)])
def test_k3_and_k5_bodies_take_more_than_15_digit_rows(host_lib, n, R, L, base_log, P, g,
                                                       worst):
    """K3 over 2 steps and K5 one step a call; g = 1 is the paired key's
    step (K5 on the MXU=0 route)."""
    plan, key, acc, exps = inputs(n, R, L, P, g, 2, 2, seed=g + L,
                                  base_log=base_log if worst else None)
    tab, cs = rotation._kernel_tables(plan, "cpu")
    launch = rotation._variant_launch_plan(2, n, R, L * R, P, 1)
    want = plain(acc, exps, key, L, base_log, plan, g)
    out = acc.copy()
    assert host_lib.tfhe_blind_rotate_multi_bit(
        out.ctypes.data, exps.ctypes.data, key.ctypes.data, tab.data_ptr(), cs.data_ptr(), 2,
        2, n, plan.log_n, P, R, L, base_log, g, launch.grid, 1, launch.smem, None) == 0
    assert np.array_equal(out, want)
    out = acc.copy()
    for j in range(2):
        step_e = np.ascontiguousarray(exps[:, j])
        assert host_lib.tfhe_blind_rotate_step_variants(
            out.ctypes.data, step_e.ctypes.data, step_e.strides[0] // 4, key[j].ctypes.data,
            tab.data_ptr(), cs.data_ptr(), 2, n, plan.log_n, P, R, L, base_log, g,
            launch.grid, 1, launch.smem, None) == 0
    assert np.array_equal(out, want)
