"""Which rotation kernel the port's wrappers take for every named parameter
set, from the shape functions alone (no launch, no JAX, no card).

The pins (ROADMAP C6): the fused route (K1/K3 where a ciphertext's working
set fits one block, K6 where it does not) takes every named set with a PBS
(it refused 68 before K6 and the J > 15 MACs); the per-step routes (K4/K5,
K6 for one step) refuse exactly the sets with N >= 16384, as the JAX
per-step routes do (tfhe_tpu/core/poly/pallas_ntt.py:1809).  A change that
makes a wrapper refuse a named set fails here.  Also K6's layout and batch
tiles, and that the private `_staged=True` leaves the CPU (plain) result
unchanged.  And the keyswitch's form for every named set with a
keyswitching key: 228 take the tensor-core form (K2′, whose int32 limb sums
must stay below 2^31), 12 the wide form.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.core.algorithms import external_product_num_primes, keyswitch
from tfhe_tpu_torch.core.entities import NttBootstrapKey, NttMultiBitBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import ALL_NAMED_PARAMS, DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    n: int           # N
    R: int           # k + 1
    L: int
    base_log: int
    P: int
    variants: int    # 2^g for a multi-bit set, 0 for a classic one

    @property
    def J(self):
        return self.L * self.R


def _pbs_shapes():
    out = []
    for name, p in sorted(ALL_NAMED_PARAMS.items()):
        if not hasattr(p, "pbs_decomp"):
            continue                     # keyswitching-key parameters: no PBS
        R = p.glwe_dimension + 1
        g = getattr(p, "grouping_factor", None)
        out.append(Shape(name, p.polynomial_size, R, p.pbs_decomp.level, p.pbs_decomp.base_log,
                         external_product_num_primes(p.polynomial_size, R, p.pbs_decomp),
                         1 << g if g else 0))
    return out


SHAPES = _pbs_shapes()


def test_the_named_sets_with_a_pbs():
    assert len(ALL_NAMED_PARAMS) == 241
    assert len(SHAPES) == 240
    assert sum(1 for s in SHAPES if s.variants) == 6


def test_the_fused_route_takes_every_named_set():
    refused = []
    for s in SHAPES:
        try:
            rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)
        except (ValueError, NotImplementedError) as e:
            refused.append((s.name, str(e)))
    assert refused == []


def test_the_fused_route_runs_k6_exactly_where_one_block_cannot_hold_a_ciphertext():
    staged = {s.name for s in SHAPES
              if rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)[0] == "staged"}
    beyond = {s.name for s in SHAPES
              if 8 * s.R * s.n + 4 * s.J * s.n + 4 * s.P * s.R * s.n > 232448}
    assert staged == beyond
    assert len(staged) == 65
    assert {"PARAM_MESSAGE_3_CARRY_3_KS_PBS", "PARAM_MESSAGE_4_CARRY_4_KS_PBS",
            "PARAM_MESSAGE_1_CARRY_4_KS_PBS",
            "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_2_KS_PBS",
            "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS",
            "PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS"} <= staged
    # the J > 15 sets fit one block: K1's MAC reduces inside its j loop
    for name in ("WOPBS_PARAM_MESSAGE_1_CARRY_8_KS_PBS", "PARAM_4_BITS_5_BLOCKS",
                 "AES_PARAMETERS_40"):
        s = next(s for s in SHAPES if s.name == name)
        assert s.J > 15
        route, lay = rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)
        assert route == "block" and isinstance(lay, rotation.DeltaLayout)


def test_the_per_step_route_refuses_exactly_the_sets_above_n_8192():
    refused = set()
    for s in SHAPES:
        try:
            rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants, per_step=True)
        except NotImplementedError as e:
            assert "pallas_ntt.py:1809" in str(e)
            refused.add(s.name)
    assert refused == {s.name for s in SHAPES if s.n >= 16384}
    assert len(refused) == 43


@pytest.mark.parametrize("n, count, launches", [(4096, 2, 5), (8192, 2, 5), (16384, 2, 5),
                                                (32768, 3, 7), (65536, 3, 7)])
def test_staged_layout_covers_the_stages(n, count, launches):
    lay = rotation._staged_layout(n, 2, 4, 4)
    log_n = n.bit_length() - 1
    assert len(lay.head) == count and lay.launches == launches
    assert all(1 <= r <= 3 for r in lay.head + lay.tail)
    assert sum(lay.head) + sum(lay.tail) + 2 == log_n
    assert lay.log_w == log_n - sum(lay.head) == 8 and lay.tail == (3, 3)
    assert lay.smem == lay.warps * 4 * (4 + 2) * 256 <= rotation._SMEM_LIMIT


def test_staged_layout_refuses_regions_below_32_slots():
    with pytest.raises(ValueError, match="N >= 64"):
        rotation._staged_layout(32, 2, 2, 2)


@pytest.mark.parametrize("batch, n, J, tiles", [(512, 32768, 4, 1), (512, 65536, 8, 3),
                                                (513, 8192, 4, 1), (1, 65536, 8, 1)])
def test_staged_batch_tiles_cover_the_batch_within_the_scratch(batch, n, J, tiles):
    got = rotation._staged_tiles(batch, n, 2, J, 4)
    assert len(got) == tiles
    assert got[0][0] == 0 and got[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all((hi - lo) * 4 * 4 * (J + 2) * n <= rotation._STAGED_SCRATCH for lo, hi in got)


def test_staged_route_is_chosen_by_shape_or_asked_for():
    assert rotation._rotation_route(2048, 2, 2, 4) == "block"
    assert rotation._rotation_route(2048, 2, 2, 4, staged=True) == "staged"
    assert rotation._rotation_route(4096, 2, 4, 4) == "staged"
    assert rotation._rotation_route(8192, 2, 4, 4, per_step=True) == "staged"
    with pytest.raises(NotImplementedError, match="pallas_ntt.py:1809"):
        rotation._rotation_route(16384, 2, 4, 4, per_step=True)


def test_per_step_wrapper_refuses_n_above_8192_on_the_cpu_too():
    acc = torch.zeros((1, 2, 16384), dtype=torch.int64)
    key_slice = torch.zeros((4, 4, 2, 16384), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="pallas_ntt.py:1809"):
        rotation.blind_rotate_step(acc, torch.zeros(1, dtype=torch.int32), key_slice, "delta",
                                   DecompParams(base_log=15, level=2))


@pytest.mark.parametrize("g", [0, 2])
def test_staged_argument_leaves_the_cpu_result_unchanged(g):
    n, R, L, P, steps = 64, 2, 2, 2, 3
    rng = np.random.default_rng(g)
    plan = ntt.get_plan(n, P)
    decomp = DecompParams(base_log=10, level=L)
    lead = (steps, 1 << g) if g else (steps,)
    spectra = torch.from_numpy(np.stack([rng.integers(0, p, lead + (L * R, R, n))
                                         for p in plan.primes], axis=len(lead)).astype(np.int32))
    acc = from_numpy_u64(rng.integers(0, 2 ** 64, (2, R, n), dtype=np.uint64))
    if g:
        key = NttMultiBitBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes,
                                      grouping_factor=g)
        exps = torch.from_numpy(rng.integers(0, 2 * n, (2, steps, (1 << g) - 1)))
        rot = rotation.rotate_accumulator_multi_bit
    else:
        key = NttBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes)
        exps = torch.from_numpy(rng.integers(0, 2 * n, (2, steps)))
        rot = rotation.rotate_accumulator
    np.testing.assert_array_equal(to_numpy_u64(rot(acc, exps, key, _staged=True)),
                                  to_numpy_u64(rot(acc, exps, key)))


def _keyswitch_shapes():
    """(name, K = n_in * levels, base_log, log_q) of every named set with a
    keyswitching key (the keyswitch reads the big LWE dimension)."""
    return [(name, p.big_lwe_dimension * p.ks_level, p.ks_base_log, p.log_q)
            for name, p in sorted(ALL_NAMED_PARAMS.items()) if hasattr(p, "big_lwe_dimension")]


def test_the_keyswitch_forms_over_the_named_sets():
    """Every named set's keyswitch takes the tensor-core form: 228 with
    digits of one byte (b <= 8), 12 with digits of 2, 3 or 4 signed byte
    limbs (the COMPACT_PK sets at b = 17 and 25, the WoP-PBS sets at b =
    10 and 11)."""
    shapes = _keyswitch_shapes()
    assert len(shapes) == 240 and all(keyswitch.tensor_core_form(b, q) for _, _, b, q in shapes)
    wide = {name: (b, keyswitch.digit_limbs(b)) for name, K, b, q in shapes
            if keyswitch.digit_limbs(b) > 1}
    assert len(wide) == 12
    assert wide == {**{f"PARAM_MESSAGE_{m}_CARRY_{c}_COMPACT_PK_PBS_KS": (25, 4)
                       for m, c in ((2, 6), (3, 5), (4, 3), (4, 4), (5, 1), (5, 2), (5, 3),
                                    (6, 1))},
                    "PARAM_MESSAGE_6_CARRY_2_COMPACT_PK_PBS_KS": (17, 3),
                    "PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS": (17, 3),
                    "WOPBS_PARAM_MESSAGE_3_CARRY_3_KS_PBS": (10, 2),
                    "WOPBS_PARAM_MESSAGE_4_CARRY_4_KS_PBS": (11, 2)}


def test_every_tensor_core_keyswitch_sums_below_2_31():
    """Every digit limb in [-128, 127] (a one-limb digit in [-2^(b-1),
    2^(b-1))), every key byte <= 255: at batch 512 on 132 SMs K2′'s K
    split keeps each split's slot sums inside int32 at every named set
    (7_1 COMPACT at K = 131072, b = 17, in 6 splits; every one-limb set
    would fit unsplit, the largest, 4_4 PBS_KS at K = 196608, b = 4, at
    0.19 * 2^31), and every K is a whole row of 16 bytes."""
    worst, splits = 0, {}
    for name, K, b, q in _keyswitch_shapes():
        limbs = keyswitch.digit_limbs(b)
        reach = 2 ** (b - 1) if limbs == 1 else 128 * limbs
        assert keyswitch.padded_depth(K) == K, name
        M = ALL_NAMED_PARAMS[name].lwe_dimension + 1
        per, splits[name] = keyswitch._tc_plan(512, M, K, 132, keyswitch.max_depth(b) // 64)
        depth = min(K, per * 64)
        assert depth * reach * 255 < 2 ** 31, name
        if limbs == 1:
            worst = max(worst, K * reach * 255)
    assert worst == 196608 * 8 * 255
    assert splits["PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS"] == 6
    assert keyswitch.max_depth(8) == 65793 and [keyswitch.max_depth(b) for b in (11, 17, 25)] \
        == [32896, 21931, 16448]
    assert not keyswitch.tensor_core_form(32) and keyswitch.tensor_core_form(31)
    assert not keyswitch.tensor_core_form(8, log_q=32)
