"""The keyswitch kernels' CUDA source (`tfhe_tpu_torch/csrc/keyswitch.cu`:
the decomposition pass, K2′ on the int8 tensor cores and the wide form K2)
built for the host and run on the CPU, held bit for bit against the plain
versions.  No JAX.

`tests/cuda_host_stub.h` stands in for the CUDA runtime: each CUDA thread is
a std::thread, the barriers are std::barriers, mma.sync m16n8k32 s8 x u8 is
computed for the warp in the PTX ISA's fragment layout, cp.async is a copy
that zero-fills past its source size.  So this runs the kernels' own tiling,
ring of stages, fragment loads, quad recombination, split-K atomics and
masks of the ragged edges; `chip_smoke.py` holds the same kernels on the
card.  Skips where no C++20 host compiler is found.
"""
import math

import numpy as np
import pytest
import torch

from cuda_host import build_keyswitch_host
from tfhe_tpu_torch.core.algorithms import keyswitch
from tfhe_tpu_torch.core.decomposition import signed_decompose
from tfhe_tpu_torch.core.numeric import from_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams

U64 = np.uint64
TOP_BITS = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_keyswitch_host(tmp_path_factory.mktemp("host_keyswitch"),
                                ("tfhe_keyswitch_decompose", "tfhe_keyswitch_tc",
                                 "tfhe_keyswitch_mac"))


def ciphertexts(batch, n_in, seed):
    """[batch, n_in + 1] torus words, the top-bit cases at the front."""
    rng = np.random.default_rng(seed)
    ct = rng.integers(0, 2 ** 64, (batch, n_in + 1), dtype=U64)
    ct.reshape(-1)[:4] = TOP_BITS
    return from_numpy_u64(ct)


def host_decompose(lib, ct, decomp):
    """The pass on the mask inside ct, read through its row stride."""
    B, n_in = ct.shape[0], ct.shape[1] - 1
    Kp = keyswitch.padded_depth(n_in * decomp.level)
    out = torch.full((B, Kp), 99, dtype=torch.int8)      # the padding must be written
    assert lib.tfhe_keyswitch_decompose(ct.data_ptr(), n_in + 1, out.data_ptr(), B, n_in, Kp,
                                        decomp.base_log, decomp.level, None) == 0
    return out


def host_tensor_core(lib, digits, key, body, splits=None):
    """K2′ through the limb layout, K split as `_tc_plan` gives it for one
    SM (or into `splits`); the output zeroed where K is split."""
    (B, Kp), M = digits.shape, key.shape[1]
    if splits is None:
        per, splits = keyswitch._tc_plan(B, M, Kp, 1)
    else:
        per = math.ceil(math.ceil(Kp / 64) / splits)
        assert math.ceil(math.ceil(Kp / 64) / per) == splits
    out = torch.zeros((B, M), dtype=torch.int64) if splits > 1 else \
        torch.full((B, M), 12345, dtype=torch.int64)
    limbs = keyswitch.limb_layout(key)
    assert lib.tfhe_keyswitch_tc(digits.data_ptr(), limbs.data_ptr(), body.data_ptr(),
                                 out.data_ptr(), B, M, Kp, per, splits, None) == 0
    return out


# (base_log, levels): the main path's (2_2 3 x 5, GROUP_2 5 x 3, GROUP_3
# 7 x 2, 3_3 3 x 6, 3_3 GROUP_3 6 x 3, 4_4 3 x 7), the b = 8 edge, 64 bits
# of digits (no rounding shift) and one bit
DECOMPS = [(3, 5), (5, 3), (7, 2), (3, 6), (6, 3), (3, 7), (8, 2), (8, 8), (1, 10)]


@pytest.mark.parametrize("base_log, levels", DECOMPS)
def test_the_decomposition_pass_equals_signed_decompose(host_lib, base_log, levels):
    decomp = DecompParams(base_log=base_log, level=levels)
    ct = ciphertexts(9, 37, seed=base_log * 16 + levels)
    got = host_decompose(host_lib, ct, decomp)
    assert torch.equal(got, keyswitch.decompose_digits_plain(ct[:, :-1], decomp))
    K = 37 * levels
    want = signed_decompose(ct[:, :-1], decomp).reshape(9, K)
    assert torch.equal(got[:, :K].to(torch.int64), want)            # fits s8 exactly
    assert not got[:, K:].any()


# (B, n_in, levels, base_log, M): ragged batch (past 128 rows), columns
# (8M past 128) and K (Kp past a 64-byte step), and the main path's widths
# cut to a few words
SHAPES = [(150, 67, 3, 5, 20), (37, 41, 5, 3, 9), (1, 100, 5, 3, 17), (129, 64, 2, 8, 16),
          (8, 3, 1, 4, 1)]


@pytest.mark.parametrize("B, n_in, levels, base_log, M", SHAPES)
def test_k2_prime_equals_the_plain_contraction(host_lib, B, n_in, levels, base_log, M):
    decomp = DecompParams(base_log=base_log, level=levels)
    rng = np.random.default_rng(B + M)
    ct = ciphertexts(B, n_in, seed=B)
    key = from_numpy_u64(rng.integers(0, 2 ** 64, (n_in * levels, M), dtype=U64))
    digits = host_decompose(host_lib, ct, decomp)
    want = keyswitch.neg_digit_mac_plain(digits[:, :n_in * levels], key, ct[:, -1])
    assert torch.equal(host_tensor_core(host_lib, digits, key, ct[:, -1].contiguous()), want)


@pytest.mark.parametrize("splits", [2, 3, 6])
def test_k2_prime_split_over_k_equals_the_plain_contraction(host_lib, splits):
    """K split into partial words added with atomics: the body added once."""
    B, n_in, levels, M = 150, 67, 5, 20
    decomp = DecompParams(base_log=3, level=levels)
    rng = np.random.default_rng(splits)
    ct = ciphertexts(B, n_in, seed=splits)
    key = from_numpy_u64(rng.integers(0, 2 ** 64, (n_in * levels, M), dtype=U64))
    digits = host_decompose(host_lib, ct, decomp)
    want = keyswitch.neg_digit_mac_plain(digits[:, :n_in * levels], key, ct[:, -1])
    got = host_tensor_core(host_lib, digits, key, ct[:, -1].contiguous(), splits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("digit, splits", [(-128, 4), (127, 1)])
def test_k2_prime_worst_case_limb_sums(host_lib, digit, splits):
    """Every digit at -2^(b-1) (then 2^(b-1) - 1), b = 8, against key bytes
    all 0xFF at K = 65792, the largest depth (in rows of 16 bytes) the
    tensor-core form takes at b = 8: each limb sum is -2147450880 (or
    2130744960), 2^31 - 32768 in magnitude.  A kernel that sums in fewer bits, saturates or drops the
    sign fails here."""
    B, K, M = 16, 65792, 1
    assert keyswitch.tensor_core_form(K, 8) and not keyswitch.tensor_core_form(K + 16, 8)
    digits = torch.full((B, K), digit, dtype=torch.int8)
    key = torch.full((K, M), -1, dtype=torch.int64)
    body = from_numpy_u64(np.arange(B, dtype=U64) * U64(2 ** 60 + 3))
    want = keyswitch.neg_digit_mac_plain(digits, key, body)
    assert torch.equal(host_tensor_core(host_lib, digits, key, body, splits), want)


@pytest.mark.parametrize("B, K, M", [(37, 50, 9), (65, 33, 70)])
def test_the_wide_form_equals_the_plain_contraction(host_lib, B, K, M):
    """K2 as it is (64-bit multiply-adds), with digits of b = 25 and b = 11."""
    rng = np.random.default_rng(K)
    half = 1 << (24 if K == 50 else 10)
    digits = torch.from_numpy(rng.integers(-half, half, (B, K)).astype(np.int32))
    digits[0, :2] = torch.tensor([-half, half - 1], dtype=torch.int32)
    key = from_numpy_u64(rng.integers(0, 2 ** 64, (K, M), dtype=U64))
    body = from_numpy_u64(rng.integers(0, 2 ** 64, (B,), dtype=U64))
    out = torch.zeros((B, M), dtype=torch.int64)
    assert host_lib.tfhe_keyswitch_mac(digits.data_ptr(), key.data_ptr(), body.data_ptr(),
                                       out.data_ptr(), B, K, M, None) == 0
    assert torch.equal(out, keyswitch.neg_digit_mac_plain(digits, key, body))


def test_the_entry_points_refuse_what_the_kernels_do_not_take(host_lib):
    d = torch.zeros((2, 16), dtype=torch.int8)
    limbs = torch.zeros((1, 8, 16), dtype=torch.uint8)
    words = torch.zeros(4, dtype=torch.int64)
    tc = host_lib.tfhe_keyswitch_tc
    for B, M, Kp, per, splits in ((2, 1, 24, 1, 1), (2, 1, 16, 1, 2), (0, 1, 16, 1, 1),
                                  (2, 1, 128, 1, 1)):
        assert tc(d.data_ptr(), limbs.data_ptr(), words.data_ptr(), words.data_ptr(), B, M, Kp,
                  per, splits, None) != 0
    dec = host_lib.tfhe_keyswitch_decompose
    for n_in, Kp, b, L in ((4, 16, 9, 1), (4, 16, 3, 5), (4, 24, 3, 1), (4, 16, 8, 9)):
        assert dec(words.data_ptr(), n_in, d.data_ptr(), 1, n_in, Kp, b, L, None) != 0


# (B, M, Kp) of the main path's keyswitch shapes at batch 512 (2_2, GROUP_3,
# GROUP_2, 3_3, 3_3 GROUP_3, 4_4) and the K split the plan gives each on 132
# SMs (K steps a split, splits)
PLANS = [((512, 743, 10240), (80, 2)), ((512, 889, 4096), (64, 1)), ((512, 819, 6144), (32, 3)),
         ((512, 865, 49152), (256, 3)), ((512, 973, 24576), (384, 1)),
         ((512, 997, 229376), (3584, 1))]


@pytest.mark.parametrize("shape, plan", PLANS)
def test_the_k_split_at_the_main_shapes(shape, plan):
    assert keyswitch._tc_plan(*shape, 132) == plan


@pytest.mark.parametrize("B, M, Kp", [(1, 743, 10240), (513, 1, 16), (7, 3, 65792),
                                      (4096, 2049, 16384), (300, 100, 1040)])
def test_every_k_split_covers_the_steps_once(B, M, Kp):
    """What the entry point requires: every split has steps, together all."""
    k_steps = math.ceil(Kp / 64)
    for sms in (1, 8, 132):
        per, splits = keyswitch._tc_plan(B, M, Kp, sms)
        assert per * splits >= k_steps > per * (splits - 1)
        assert splits == 1 or per >= keyswitch._MIN_SPLIT_STEPS
