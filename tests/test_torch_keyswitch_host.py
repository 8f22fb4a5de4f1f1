"""The keyswitch kernels' CUDA source (`tfhe_tpu_torch/csrc/keyswitch.cu`:
the decomposition pass and K2′ on the int8 tensor cores, at one digit limb
and at the 2, 3 and 4 signed byte limbs of digits wider than 8 bits) built
for the host and run on the CPU, held bit for bit against the plain
versions.  No JAX.

`tests/cuda_host_stub.h` stands in for the CUDA runtime: each CUDA thread is
a std::thread, the barriers are std::barriers, mma.sync m16n8k32 s8 x u8 is
computed for the warp in the PTX ISA's fragment layout, cp.async is a copy
that zero-fills past its source size.  So this runs the kernels' own tiling,
ring of stages, fragment loads, digit limbs against shifted key slots, quad
recombination, split-K atomics and masks of the ragged edges;
`chip_smoke.py` holds the same kernels on the card.  Skips where no C++20
host compiler is found.
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
                                ("tfhe_keyswitch_decompose", "tfhe_keyswitch_tc"))


def ciphertexts(batch, n_in, seed, decomp=None):
    """[batch, n_in + 1] torus words, the top-bit cases at the front; with
    decomp (and batch >= 2), row 1 starts with words whose lowest and
    highest digits are -2^(b-1) and 2^(b-1) - 1."""
    rng = np.random.default_rng(seed)
    ct = rng.integers(0, 2 ** 64, (batch, n_in + 1), dtype=U64)
    ct.reshape(-1)[:4] = TOP_BITS
    if decomp is not None:
        b, shift = decomp.base_log, 64 - decomp.base_log * decomp.level
        half = 1 << (b - 1)
        ct[1, :4] = [half << shift, (half - 1) << shift, half << (64 - b),
                     (half - 1) << (64 - b)]
    return from_numpy_u64(ct)


def host_decompose(lib, ct, decomp):
    """The pass on the mask inside ct, read through its row stride."""
    B, n_in = ct.shape[0], ct.shape[1] - 1
    limbs = keyswitch.digit_limbs(decomp.base_log)
    Kp = keyswitch.padded_depth(n_in * decomp.level)
    out = torch.full((B, limbs * Kp), 99, dtype=torch.int8)   # the padding must be written
    assert lib.tfhe_keyswitch_decompose(ct.data_ptr(), n_in + 1, out.data_ptr(), B, n_in, Kp,
                                        decomp.base_log, decomp.level, limbs, None) == 0
    return out


def host_tensor_core(lib, digits, key, body, base_log, plan=None):
    """K2′ through the limb layout, K split as `_tc_plan` gives it for one
    SM under the int32 limit (or as `plan`, (K steps a split, splits)); the
    output zeroed where K is split."""
    (B, width), (K, M) = digits.shape, key.shape
    Kp, limbs = keyswitch.padded_depth(K), keyswitch.digit_limbs(base_log)
    assert width == limbs * Kp
    per, splits = plan or keyswitch._tc_plan(B, M, Kp, 1, keyswitch.max_depth(base_log) // 64)
    out = torch.zeros((B, M), dtype=torch.int64) if splits > 1 else \
        torch.full((B, M), 12345, dtype=torch.int64)
    assert lib.tfhe_keyswitch_tc(digits.data_ptr(), keyswitch.limb_layout(key).data_ptr(),
                                 body.data_ptr(), out.data_ptr(), B, M, Kp, limbs, per, splits,
                                 None) == 0
    return out


def plain(digits, key, body, base_log):
    """The plain contraction on the digits the limbs recombine to."""
    d = keyswitch.join_limbs(digits, key.shape[0], keyswitch.digit_limbs(base_log))
    return keyswitch.neg_digit_mac_plain(d, key, body)


# (base_log, levels): the main path's (2_2 3 x 5, GROUP_2 5 x 3, GROUP_3
# 7 x 2, 3_3 3 x 6, 3_3 GROUP_3 6 x 3, 4_4 3 x 7), the b = 8 edge, 64 bits
# of digits (no rounding shift) and one bit; then the digits of 2, 3 and 4
# byte limbs: the WoP-PBS sets' keyswitches (10 x 3, 11 x 2) and private
# functional keyswitch (15 x 2), the COMPACT_PK sets' (17 x 2, 25 x 1), and
# the widest digits each limb count takes (15, 23, 31 bits)
DECOMPS = [(3, 5), (5, 3), (7, 2), (3, 6), (6, 3), (3, 7), (8, 2), (8, 8), (1, 10),
           (10, 3), (11, 2), (15, 2), (17, 2), (25, 1), (23, 2), (31, 2), (16, 4)]


@pytest.mark.parametrize("base_log, levels", DECOMPS)
def test_the_decomposition_pass_equals_signed_decompose(host_lib, base_log, levels):
    decomp = DecompParams(base_log=base_log, level=levels)
    ct = ciphertexts(9, 37, seed=base_log * 16 + levels, decomp=decomp)
    got = host_decompose(host_lib, ct, decomp)
    assert torch.equal(got, keyswitch.decompose_digits_plain(ct[:, :-1], decomp))
    K, limbs = 37 * levels, keyswitch.digit_limbs(base_log)
    want = signed_decompose(ct[:, :-1], decomp).reshape(9, K)
    half = 1 << (base_log - 1)
    assert (want == -half).any() and (want == half - 1).any()
    assert torch.equal(keyswitch.join_limbs(got, K, limbs), want)     # fits the limbs exactly
    assert not got.reshape(9, limbs, -1)[:, :, K:].any()


# (B, n_in, levels, base_log, M): ragged batch (past 128 rows), columns
# (8M past 128) and K (Kp past a 64-byte step), and the main path's widths
# cut to a few words; then 2, 3 and 4 digit limbs
SHAPES = [(150, 67, 3, 5, 20), (37, 41, 5, 3, 9), (1, 100, 5, 3, 17), (129, 64, 2, 8, 16),
          (8, 3, 1, 4, 1), (37, 41, 3, 10, 9), (130, 29, 2, 11, 17), (5, 67, 2, 15, 3),
          (70, 33, 2, 17, 20), (9, 50, 1, 25, 33), (129, 21, 2, 24, 2)]


@pytest.mark.parametrize("B, n_in, levels, base_log, M", SHAPES)
def test_k2_prime_equals_the_plain_contraction(host_lib, B, n_in, levels, base_log, M):
    decomp = DecompParams(base_log=base_log, level=levels)
    rng = np.random.default_rng(B + M)
    ct = ciphertexts(B, n_in, seed=B, decomp=decomp if B > 1 else None)
    key = from_numpy_u64(rng.integers(0, 2 ** 64, (n_in * levels, M), dtype=U64))
    digits = host_decompose(host_lib, ct, decomp)
    want = keyswitch.neg_digit_mac_plain(signed_decompose(ct[:, :-1], decomp).reshape(B, -1),
                                         key, ct[:, -1])
    assert torch.equal(plain(digits, key, ct[:, -1], base_log), want)
    got = host_tensor_core(host_lib, digits, key, ct[:, -1].contiguous(), base_log)
    assert torch.equal(got, want)


@pytest.mark.parametrize("splits, base_log", [(2, 3), (3, 3), (6, 3), (2, 11), (4, 25)])
def test_k2_prime_split_over_k_equals_the_plain_contraction(host_lib, splits, base_log):
    """K split into partial words added with atomics: the body added once;
    at 2 and 4 digit limbs the last split ragged (16 of 64 bytes)."""
    B, n_in, levels, M = (150, 67, 5, 20) if base_log < 8 else (150, 100, 2, 20)
    decomp = DecompParams(base_log=base_log, level=levels)
    rng = np.random.default_rng(splits)
    ct = ciphertexts(B, n_in, seed=splits, decomp=decomp)
    key = from_numpy_u64(rng.integers(0, 2 ** 64, (n_in * levels, M), dtype=U64))
    digits = host_decompose(host_lib, ct, decomp)
    k_steps = math.ceil(keyswitch.padded_depth(n_in * levels) / 64)
    per = math.ceil(k_steps / splits)
    assert math.ceil(k_steps / per) == splits
    got = host_tensor_core(host_lib, digits, key, ct[:, -1].contiguous(), base_log,
                           (per, splits))
    assert torch.equal(got, plain(digits, key, ct[:, -1], base_log))


@pytest.mark.parametrize("digit, splits", [(-128, 4), (127, 1)])
def test_k2_prime_worst_case_limb_sums(host_lib, digit, splits):
    """Every digit at -2^(b-1) (then 2^(b-1) - 1), b = 8, against key bytes
    all 0xFF at K = 65792, the largest depth (in rows of 16 bytes) one
    split takes at b = 8: each limb sum is -2147450880 (or 2130744960),
    2^31 - 32768 in magnitude.  A kernel that sums in fewer bits,
    saturates or drops the sign fails here."""
    B, K, M = 16, 65792, 1
    assert K <= keyswitch.max_depth(8) < K + 16
    digits = torch.full((B, K), digit, dtype=torch.int8)
    key = torch.full((K, M), -1, dtype=torch.int64)
    body = from_numpy_u64(np.arange(B, dtype=U64) * U64(2 ** 60 + 3))
    want = keyswitch.neg_digit_mac_plain(digits, key, body)
    per = math.ceil(K // 64 / splits)
    assert torch.equal(host_tensor_core(host_lib, digits, key, body, 8, (per, splits)), want)


@pytest.mark.parametrize("base_log, limb", [(15, -128), (25, 127)])
def test_k2_prime_worst_case_at_the_int32_chunk(host_lib, base_log, limb):
    """Every limb of every digit at -128 (then 127) against key bytes all
    0xFF, K one 64-byte step past `max_depth` rows: the first split takes
    the deepest run of whole steps the int32 limit allows (at 2 limbs
    32896 rows, each slot sum -2147450880, 2^31 - 32768 in magnitude), the
    second the ragged 16 rows left.  Unsplit, the depth would pass the
    limit (and at -128 the sums 2^31)."""
    limbs = keyswitch.digit_limbs(base_log)
    per = keyswitch.max_depth(base_log) // 64
    B, K, M = 16, per * 64 + 16, 1
    assert limbs * K * 255 * 128 >= 2 ** 31 > limbs * per * 64 * 255 * 128
    assert keyswitch._tc_plan(B, M, K, 1, per)[0] <= per
    digits = torch.full((B, limbs * K), limb, dtype=torch.int8)
    key = torch.full((K, M), -1, dtype=torch.int64)
    body = from_numpy_u64(np.arange(B, dtype=U64) * U64(2 ** 60 + 3))
    got = host_tensor_core(host_lib, digits, key, body, base_log, (per, 2))
    assert torch.equal(got, plain(digits, key, body, base_log))


def test_the_entry_points_refuse_what_the_kernels_do_not_take(host_lib):
    d = torch.zeros((2, 64), dtype=torch.int8)
    limbs = torch.zeros((1, 8, 16), dtype=torch.uint8)
    words = torch.zeros(4, dtype=torch.int64)
    tc = host_lib.tfhe_keyswitch_tc
    for B, M, Kp, D, per, splits in ((2, 1, 24, 1, 1, 1), (2, 1, 16, 1, 1, 2),
                                     (0, 1, 16, 1, 1, 1), (2, 1, 128, 1, 1, 1),
                                     (2, 1, 16, 0, 1, 1), (2, 1, 16, 5, 1, 1)):
        assert tc(d.data_ptr(), limbs.data_ptr(), words.data_ptr(), words.data_ptr(), B, M, Kp,
                  D, per, splits, None) != 0
    dec = host_lib.tfhe_keyswitch_decompose
    # b = 9 takes two limbs, not one; b = 16 three; b = 32 none; one limb
    # short of b's; the levels past 64 bits; a ragged Kp; more levels than Kp
    for n_in, Kp, b, L, D in ((4, 16, 9, 1, 1), (4, 16, 16, 1, 2), (4, 16, 32, 1, 4),
                              (4, 16, 24, 1, 3), (4, 16, 3, 5, 1), (4, 24, 3, 1, 1),
                              (4, 16, 8, 9, 1)):
        assert dec(words.data_ptr(), n_in, d.data_ptr(), 1, n_in, Kp, b, L, D, None) != 0
    for n_in, Kp, b, L, D in ((4, 16, 9, 1, 2), (4, 16, 16, 1, 3), (4, 16, 31, 1, 4)):
        assert dec(words.data_ptr(), n_in, d.data_ptr(), 1, n_in, Kp, b, L, D, None) == 0


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
    """What the entry point requires: every split has steps, together all;
    and no split deeper than the int32 limit of each digit width."""
    k_steps = math.ceil(Kp / 64)
    for sms in (1, 8, 132):
        for base_log in (None, 8, 11, 17, 25):
            top = None if base_log is None else keyswitch.max_depth(base_log) // 64
            per, splits = keyswitch._tc_plan(B, M, Kp, sms, top)
            assert per * splits >= k_steps > per * (splits - 1)
            assert top is None or per <= top
            assert splits == 1 or per >= keyswitch._MIN_SPLIT_STEPS or \
                splits == math.ceil(k_steps / top)
