#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA card.

Drives the port's shortint keyswitch + PBS paths, its integer path, its
boolean scheme (64- and 32-bit tori), its apps, its client-server key flow,
its high-level API, its WoP-PBS, its gadget fork, its GGSW shifts, its
integer WoP-PBS, its 2^128 torus, its dp mesh, its CSPRNG and its C API
once each, through the entry points a user
calls, and checks them: the classic
path at the full PARAM_MESSAGE_2_CARRY_2_KS_PBS widths (n=742, N=2048), the
multi-bit path at PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS (n=888 in
296 groups of 3, N=2048), the per-step routes the rotation switches select
(`tfhe_tpu_torch/config.py`), and the large-N paths through K6 (3_3 at
N=8192, its GROUP_3 multi-bit set, 4_4 at N=32768), batch 512 each:

  1. card, power limit, SM clock, torch and CUDA versions;
  2. builds the CUDA kernels (csrc/*.cu: K1, K3, K4, K5, K6 in rotation.cu,
     the keyswitch's decomposition pass and K2' (digits of 1 to 4 byte
     limbs) in keyswitch.cu, K7 and K8 in external_product.cu, the shared-memory probe in
     probe.cu; one nvcc per source, in parallel) and prints ptxas's
     register, shared-memory and
     spill lines (K1/K4 once for each MAC chunk rt and once for the kernel
     compiled for N = 2048 and P = 4, K3/K5 once for each cluster size C
     and output count R, K6's cluster step once for each C, R and delta or
     variants, K6's passes form once for each radix and its region kernel
     for each rt);
  3. holds K1 and the keyswitch bit for bit (tolerance 0: the arithmetic is
     exact) against their plain PyTorch versions on the card at the classic
     path's shapes (K1 at batch 1, 6, 8, 512 and 513 over all 742 steps; the
     decomposition pass against the torch decomposition, masks with the top
     bit set included, and K2' against the plain contraction at batch 1, 8,
     512 and 513, and at a worst case: every digit -2^(b-1), then
     2^(b-1) - 1, against key bytes all 0xFF, at 2_2 and at b = 8 with the
     deepest K the tensor-core form takes), and K1 at batch 8 at the other
     delta shapes
     (PARAM_MESSAGE_2_CARRY_1_KS_PBS, PARAM_MESSAGE_1_CARRY_1_KS_PBS, the
     boolean DEFAULT_PARAMETERS_KS_PBS with J = 9, and
     PARAM_MESSAGE_2_CARRY_3_KS_PBS at N = 4096; random keys) and times
     K1 at batch 512 at each of them; times K1, K2', the decomposition pass
     and their plain versions at batch 512 with CUDA events beside their
     bounds (and, at the same shape, torch._int_mm on
     the same [B, K] x [K, 8M] int8 shape as a yardstick of the card's int8
     GEMM rate: signed bytes with no recombination, not K2's function), and
     K1 on one round of blocks (the batch the device holds at once) and on
     16;
  3b. holds K3 the same way at the GROUP_2 and GROUP_3 widths (batch 1, 6,
     8, 512 and 513, all steps, random keys; 1, 6 and 513 leave padding
     blocks in the last cluster) at the default cluster size and times it
     and its plain version at batch 512; holds and times the decomposition
     pass and K2' as in phase 3 at both multi-bit keyswitch shapes;
  3b'. the cluster sweep: K3 at GROUP_3, batch 512, for each cluster size
     the device can schedule, in turns (C = 1, 4, 2, 8, 1; C = 1 is the
     design with one ciphertext per block, the in-call baseline), 3 reps
     each by CUDA events, every output held bit for bit against the plain
     version; prints C, ms, ms per step and the model's key bytes per step,
     and checks that the default C is the fastest (within the spread) and
     never slower than C = 1; times K3 for each C at the batch the device
     holds at once (one round of blocks, no partial last round); then the
     same turns for K5's GROUP_3 and paired per-step rotations;
  3c. holds the step kernels at full widths: K4 (one delta step) at batch
     1, 6, 8, 512 and 513 (and 8 at the 1_1 shape) and K5 (one variant
     step) on a paired 2_2 key and a GROUP_3 key at the same batches; then
     the whole per-step
     rotations at batch 512 (K4 over 742 steps against the plain version
     and against K1's output on the same inputs; K5 over the 742 steps of a
     paired key, built as GGSW_trivial(1) - pair1, against the plain paired
     rotation; K5 over the 296 GROUP_3 steps against the plain version and
     K3's output), each timed with CUDA events;
  3d. holds K6 bit for bit against the plain rotation at full widths with
     random keys, in the form the shape rule gives (the cluster step, one
     launch a step, or the passes form where no cluster holds a
     ciphertext's step): PARAM_MESSAGE_1_CARRY_4_KS_PBS (N = 4096, L = 2;
     batch 1, 6, 8, 512), 3_3 (N = 8192; 1, 6, 8, 512, 513),
     PARAM_MESSAGE_2_CARRY_5_KS_PBS (N = 16384; 8), 4_4 (N = 32768; 1, 8),
     PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_PBS_KS (N = 65536, J = 4: clusters
     of 16; 1, 8, over 16 steps),
     PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS (N = 65536, J = 8: the
     passes form; 1, 8, over 16 steps: its full key is 34 GB) and the 3_3
     multi-bit sets (GROUP_3: 1, 6, 8, 512, 513; GROUP_2: 8); batch 8 runs
     every step, the others 32, each with K6's exact launch count; K6 for
     one step on the per-step routes at 3_3 (delta, paired; batch 8 and
     513), held, then timed at batch 512 (32 launches) beside its bound;
     K6 forced (`_staged=True`) at 2_2, batch 8, against K1 on the same
     inputs; times K6 at batch 512 over every step at 3_3, 3_3 GROUP_3 and
     4_4, and K6 against its plain version over 32 steps at 3_3 and 3_3
     GROUP_3;
  3d'. the cluster sweep of K6: at 3_3 (32 steps), 3_3 GROUP_3 (16), 4_4
     (8), PARAM_MESSAGE_2_CARRY_6_KS_PBS (N = 32768, J = 6; 8 steps),
     PARAM_MESSAGE_4_CARRY_4_COMPACT_PK_PBS_KS (N = 65536, J = 6; 4) and
     PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_PBS_KS (N = 65536, J = 4; 4),
     batch 512, cluster sizes and prime groups that fit and the passes form
     (delta), in turns there and back (SWEEP_REPS runs a turn), the first
     output held bit for bit against the plain rotation and every other
     against it; prints each form's time and where the rule's form ranks
     (a timing, not a hold: it fails nothing);
  3e. more than 15 digit rows: K1 (every step at batch 8, 32 at batch
     512), K4 and the paired K5 (one step) at AES_PARAMETERS_40 (J = 16) and
     WOPBS_PARAM_MESSAGE_1_CARRY_8_KS_PBS (J = 18), K1 timed at batch 512;
  3f. the keyswitch at the large shapes: the pass and K2' held (batch 8 and
     512) and timed at 3_3, 3_3 GROUP_3 and 4_4; the pass and K2' on digits
     of several byte limbs held and timed at
     WOPBS_PARAM_MESSAGE_4_CARRY_4_KS_PBS (b = 11, 2 limbs),
     PARAM_MESSAGE_5_CARRY_1_COMPACT_PK_PBS_KS (b = 25, 4 limbs; batch 1,
     8, 512, 513) and PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS (b = 17,
     3 limbs, K = 131072 in 6 splits; held at batch 1 and 8, timed at 512),
     each beside its tensor-core bound, the CUDA-core bound the retired
     wide form K2 was held to, its plain version and torch._int_mm at
     [B, D*Kp] x [D*Kp, 8M];
  4. classic path: counts to 0, gen_keys on the card, encrypts 512
     messages, serves three requests (a LUT, a second LUT on its output, a
     bivariate LUT), reads the counts, decrypts all 3 x 512 results against
     the clear model, and holds the first results bit for bit against the
     plain path on CPU tensors;
  4b. multi-bit path, GROUP_3: the same with four requests (a LUT, add,
     mul, greater); then one KS+PBS call under torch.profiler (device time
     by kernel and the device's idle share);
  4c. the per-step routes: for each of TFHE_TPU_FUSED=0 (classic and
     GROUP_3), TFHE_TPU_MXU_LANES=1 (classic) and TFHE_TPU_MXU=0 (paired
     classic and GROUP_3) it sets the port's switches, runs gen_keys on the
     card, encrypts 512 messages, serves one LUT request with the counts
     set to 0 just before and read just after (K4 742 per classic call, K5
     742 per paired and 296 per GROUP_3 call, K1 and K3 none), decrypts
     512/512 and holds the first results against the plain CPU path; it
     times KS+PBS on the FUSED=0 classic and the paired routes, and traces
     one FUSED=0 classic call under torch.profiler (the device's idle share
     and the mean gap between K4 launches);
  4d. the large-N paths: for 3_3, 3_3 GROUP_3 and 4_4, gen_keys on the
     card, 512 messages encrypted, one LUT request with the counts set to 0
     just before and read just after (one cluster-step launch a step, one
     decomposition pass and one K2', no K1/K3 and no passes
     form), 512/512 decrypted against the clear
     model, the 3_3 results held against the plain CPU path (one
     ciphertext), KS+PBS timed, one call traced under torch.profiler (idle
     share, device time by kernel, K6's launches and their cadence);
  4e. the integer path (FheUint8 to FheUint64 radix, signed and CRT, on
     the ported KS+PBS): integer.gen_keys on the card at 2_2 for 4, 8, 16
     and 32 blocks and on the GROUP_3 key at 16; BENCH_SUITE.json's radix
     ops at its batch sizes (add, add_parallelized, mul, bitand, eq, gt,
     max, neg, left_shift and rotate_left on the layered path, div; mul
     also on the GROUP_3 key) and lt_signed, signed_div_rem,
     unsigned_overflowing_add, crt_add and crt_mul at batch 8, each on
     random values from the seed, with the counts set to 0 just before and
     read just after (K1, or K3 on the GROUP_3 key, the pass and K2' once
     per KS+PBS call, nothing else), its KS+PBS calls and rows counted,
     timed by CUDA events (ms per op: the op over its batch), its peak
     device memory read, every output block on the card and decrypted
     against the clear model; the first and last 8 rows of the largest
     call of FheUint64 mul (16,384 partial products: K1) and of FheUint32
     mul on the GROUP_3 key (8,192: K3 and the GROUP_3 keyswitch) held
     against the plain CPU path on those rows alone; one FheUint8 mul (batch 4) held block
     for block against the plain path on the same keys and ciphertexts (the
     CPU path's code, every wrapper taking its plain version, on the card's
     tensors: on CPU tensors its 8 calls took 304 s of the 8-core host of
     an H100 machine, PERF.md section 4);
     one FheUint32 add and one div traced under torch.profiler (idle
     share, device time by kernel); a JSON line of the ops;
  4f. the PBS -> KS order (ROADMAP C11): shortint.gen_keys at
     PARAM_MESSAGE_1_CARRY_1_PBS_KS, 512 messages, one LUT request with its
     launches counted (one K1, one pass, one K2'), 512/512 decrypted, the
     first and last 8 rows against the plain CPU path; then the boolean
     scheme at its five named sets (DEFAULT_PARAMETERS_KS_PBS and
     PARAMETERS_ERROR_PROB_2_POW_MINUS_165_KS_PBS: KS -> PBS;
     DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS and
     PARAMETERS_ERROR_PROB_2_POW_MINUS_165: PBS -> KS): boolean.gen_keys on
     the card, the six gates, mux and not_ at batch 512 on random operands,
     each with its launches counted (a gate: one K1, one pass, one K2'; mux:
     two K1 and two keyswitches, or one under PBS -> KS; not_: none) and
     decrypted against its truth table; the AND gate timed at batch 1, 32
     and 512 (ms a call, gates/s) beside tfhe-rs's CPU figures
     (BASELINE.md:12-14); the first and last 8 rows of one AND call at batch
     512 against the plain CPU path at DEFAULT_PARAMETERS_KS_PBS and
     TFHE_LIB_PARAMETERS; 8 dependent ANDs traced (idle share);
  4g. the apps, each with its launches counted against the KS+PBS calls it
     made and decrypted against its clear model: TriviumStreamShortint at
     PARAM_MESSAGE_1_CARRY_2_KS_PBS (32 streams, the full 1152-clock
     warm-up in 18 rounds, round 19 checked for every stream; keystream
     bits/s); the boolean TriviumStream and KreyviumStream at
     DEFAULT_PARAMETERS_KS_PBS (32 streams; the warm-up cut to what fits 10 s
     at phase 4f's gate latency, held against the clear model at the same
     warm-up; one clock traced); SHA-256's primitives on 32-row words
     (add_words_b, the four sigmas, ch_b, maj_b) against clear values, and
     the whole digest of "abc" against hashlib if its projected time fits
     120 s; TriviumStreamByte on FheUint8 at 2_2; the dark market
     (volume_match, volume_match_parallel) and the regex engine on 4-block
     integers at 2_2; transciphering: round 20 of the shortint streams
     masks an FheUint64 batch of 32 at 2_2 (`trans_encrypt_64`: the bit
     pairs cast through PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS's 15 x 1
     key, then n >> 1), and the kept state unmasks it (`trans_decrypt_64`),
     each against `trans_encrypt_u64` on the clear keystream; the same
     round trip for one FheUint64 through the byte stream's round 20;
  4h. the noise of encryptions made on the card (ROADMAP C10): 4096 LWE
     and GLWE phases of zero through tests/test_torch_noise.py's five gates;
     a JSON line of phases 4f to 4h;
  4i. the client-server key flow (key_flow_path): at 2_2, a client key on
     the card, gen_compressed_server_key (bytes on the wire against the
     standard-domain key), save to a tfhe_tpu-v1 file, safe_load onto the
     card, decompress() timed by CUDA events with its peak memory; the
     decompressed standard BSK and KSK bit-identical to the full keys the
     same threefry streams generate, and the first and last 8 input bits
     and 64 keyswitching-key rows, decompressed on the CPU from the same
     file, bit-identical to the card's; 512 encrypt_compressed ciphertexts
     decompressed on the card through one KS+PBS (one pass, one K2', one
     K1), 512/512 right and bit-identical to the call on the full key; at
     the boolean DEFAULT_PARAMETERS_KS_PBS the same for its compressed
     server key, then a public key through a file, 2 x 512 public-key
     encryptions (one K2' each: the subset sum), one AND at batch 512 (one
     pass, one K2', one K1), 512/512 right, the encryptions' first and last
     8 rows against the plain CPU path; at 4_4 the compressed key made and
     decompressed on the card (time, peak memory; its first and last input
     bits against the CPU) and one KS+PBS at batch 8 (K6 once a step), right;
     a JSON line of the phase;
  4j. the high-level API at PARAM_MESSAGE_2_CARRY_2_KS_PBS (hlapi_path):
     generate_keys on the card; FheUint8 through every operator at batch
     64, the FheBool gates, select, cast_into and overflowing_add/sub;
     FheUint32 add, mul, gt, scalar shl and //, FheUint64 add and mul,
     FheInt32 <, scalar // and %, abs, FheUint128 add and == at batch 8;
     each decrypted, its launches one K1, pass and K2' a KS+PBS call, five
     ops timed beside the same op on the integer layer with equal
     launches; PublicKey, CompactPublicKey, CompressedFheUint and
     CompressedServerKey, each held on 4 rows against the CPU and
     decrypted;
  4k. the WoP-PBS (wopbs_path): new_wopbs_key(ck, sk, "auto") on 2_2 keys
     (WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS), 512 ciphertexts over all 16
     values through the identity and x^2 + 3 mod 16, launches exactly as
     reckoned from the parameters (17 K1, 7 + 24 passes and K2' for the
     keyswitches and the private functional keyswitches, 4 K7 a call),
     512/512 right, ms a call and peak memory; K7 held on the first call's
     own operands against its plain version and timed alone, the pass and
     K2' timed at the private functional keyswitch's shape (two digit
     limbs), a private functional keyswitch held against the CPU and one
     circuit-bootstrapped GGSW against the plain kernels on the card's
     tensors; new_wopbs_key_only_for_wopbs on keys of the WoP-PBS set,
     512/512 right, and on the 2_2 keys, its rate recorded (a finding:
     2_2's one-level PBS is too noisy for the circuit bootstrap);
  4l. the gadget fork (gadget_path), on keys from gadget.gen_keys on the
     card: at the gadget DEFAULT_PARAMETERS (PBS -> KS) the AND, OR, XOR,
     NAND and 3-input majority gadgets at batch 1, 32 and 512, one K1, pass
     and K2' a call, every row decrypted, timed beside phase 4f's boolean
     AND; at AES_PARAMETERS_40 (J = 16, KS -> PBS) apply_lut, a 3-output
     MVB (K7 once a rotation step), simple and full tree bootstrapping,
     lwe_mult and woppbs_lut at batch 512, launches checked against the
     reckoning, timed, decrypted rows counted (an op short of 512 is
     printed as a finding); K7 over the MVB's first steps and K1 on the
     tree's packed accumulator held bit for bit against their plain
     versions; K7 timed at the MVB's shape; one MVB call traced;
  4m. shifts by an encrypted amount through GGSW selectors (shift_path):
     integer.gen_keys(..., shift_key="auto") at 2_2 (the shift key at
     WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS); FheUint32 shl, shr, rotl, rotr
     and the arithmetic shr, and FheUint64 shl, at batch 64, each with its
     launches held equal to the reckoning from the code (two K1 calls, the
     pass and K2' each, a GGSW row and the packing keyswitch,
     K7 a CMux), timed, peak memory read, decrypted, beside the same op on
     the layered path in the same run; the hlapi's FheUint32 << on
     generate_keys(shift_key="auto"); 40 dependent rotl at batch 64 (the
     2,560 values of ROADMAP C3), every one right;
  4n. the integer WoP-PBS (integer_wopbs_path) on
     new_wopbs_key_only_for_wopbs over keys of the WoP set: an 8-block
     radix (16 bits: 32 LUT polynomials, 31 CMuxes an output block before
     the rotation) through (7x + 13) mod 2^16 and wopbs_crt at (2, 3, 5)
     with x^2 + 1, batch 64, launches against the reckoning, timed, peak
     memory, every row decrypted; K7 held and timed at the CMux tree;
  4o. the 2^128 torus (pbs128_path): 2_2's shapes with its noise scaled to
     2^128, keys made on the card, keyswitch128 (one pass, one K2' on the
     key's four 32-bit words) then programmable_bootstrap128 (K8 once a
     step, 742) at batch 512 with a 4-bit LUT, 512/512 decrypted; K8 held
     bit for bit on the first and last 8 rows of the last step and timed
     there; the word
     form held against the plain 128-bit sum; the custom moduli of
     tests/test_nonnative.py (encrypt, add, scalar-multiply, decrypt, the
     decomposition) at n = 742, batch 512, against Python-int models;
  4q. the boolean scheme on the reference's 32-bit torus (bool32_path):
     DEFAULT_PARAMETERS_KS_PBS's widths with log_q = 32, held lifted by
     2^32, keys made on the card (the "rotate" route: one K7 launch a
     step); AND, XOR and MUX at batch 1, 32 and 512, each with the counts
     at 0 just before and read just after (664 K7 launches a gate, 1,328 a
     MUX, one pass and one K2' a keyswitch), every row decrypted, every
     word's low 32 bits zero, the first AND call (batch 1) bit-identical to
     the plain CPU path, ms a call;
     K7 (a GGSW of the key shared, rotated operand) at batch 1, 32, 512 and
     the pass + K2' at one digit limb on the key's KSK, held bit for bit
     against their plain versions and timed beside their bounds;
  4r. the dp mesh (mesh_path): the card named twice, the 2_2 KS+PBS at
     batch 512 split in two streams by shard_map_kspbs, bit-identical to
     the unsplit call and decrypted; with one card, scaling is not
     measured;
  4s. the periphery (periphery_path): the AES-CTR CSPRNG built by g++,
     FIPS-197 on both backends, its stream's SHA-256 equal to the one the
     port writes on the CPU; libtfhe_tpu_torch_capi.so built against this
     machine's libpython and the unchanged C client
     tests/c_api/test_high_level_integers.c run on the card (PASS);
  5. the shared-memory probe: with its count at 0, finds the largest
     dynamic shared memory one block launches with and reads back right,
     and holds it equal to the device's opt-in attribute and to the limit
     the rotation kernels size against;
  6. checks each kernel's launch count on its path (on every path the
     decomposition pass and K2' once per KS+PBS call),
     measures KS+PBS PBS/s at batch 512 for 2_2, GROUP_3 and GROUP_2, and
     prints the kernels line: each kernel's time beside its bound (the
     larger of its 32-bit integer multiplies, or for K2' its int8
     tensor-core operations, over the card's rate and its bytes over 3.35
     TB/s) and its plain version's time; K3 and K5 also per shape
     (GROUP_3 and GROUP_2; paired and GROUP_3), K6's cluster step (delta
     and variants) at 3_3 and 3_3 GROUP_3 over 32 steps against its plain
     version, and per shape over every step (3_3, 4_4; 3_3 GROUP_3; no
     plain time there) and one step a launch on the per-step routes; K6's
     passes form at the shape it serves (no path serves that set, so its
     launches on the paths are 0); the keyswitch's two kernels per shape
     (digits of 1 to 4 byte limbs, the WoP-PBS's private functional
     keyswitch among them); K7 at the WoP-PBS's vertical packing, the
     MVB and the integer WoP-PBS's CMux tree; K8 at a step of the 128-bit
     PBS.

Every failure raises; nothing falls back to a plain version or the CPU.
The last line is {"ok": true, "device": {...}}.  Needs one CUDA card:

    python3 chip_smoke.py [--seed S]

With --against DIR it runs no smoke: it times this checkout against the
one at DIR (for example the parent commit, unpacked with `git archive`)
on the same card, in turns other, this, this, other (--turns, 4), each
turn a process of its own that imports and builds its tree's port.  Each
turn measures at batch 512, by CUDA events, with the same seeded random
keys and inputs: the whole rotation at PARAM_MESSAGE_2_CARRY_2_KS_PBS (K1)
and, through K6, at 3_3, 3_3 GROUP_3 and 4_4; `keyswitch_lwe` alone at the
2_2, 3_3 and 4_4 keyswitch shapes and at WIDE_KS_SETS' (the key built by
`interop.keyswitch_key`); K7 and K8 alone at EP_SHAPES (random operands);
and KS+PBS at 2_2 and those three sets
(gen_keys on the card, 512 messages, one LUT request decrypted against
the clear function).  Every output's checksum must agree across
all turns (the pipeline is exact) and every KS+PBS output must decrypt
right; it raises otherwise.  It prints each turn, then each tree's mean:

    python3 chip_smoke.py --against DIR [--turns 4] [--seed S]

With --ks it builds and runs only the keyswitch's holds and times of phases
3, 3b and 3f (the first check of a keyswitch change); with --ep only phase
4p and 4o (K7 and K8); with --bool32 only phase 4q."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES_PER_SM = 64          # Hopper: INT32 multiply issue per SM per clock
INT8_MACS_PER_SM = 4096          # Hopper: dense int8 tensor-core multiply-adds per SM per clock
CLASSIC = "PARAM_MESSAGE_2_CARRY_2_KS_PBS"
GROUP_2 = "PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS"
GROUP_3 = "PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS"
B = 512
STEP_BATCHES = (1, 6, 8, B)
K5_BATCHES = STEP_BATCHES + (B + 1,)   # 513: one cluster holds a single real ciphertext
SWEEP_TURNS = (1, 4, 2, 8, 1)          # cluster sizes, in the order they are timed
SWEEP_REPS = 3
# the other delta shapes K1 is held at (batch 8) and timed at (batch 512)
K1_SHAPES = ("PARAM_MESSAGE_2_CARRY_1_KS_PBS", "PARAM_MESSAGE_1_CARRY_1_KS_PBS",
             "DEFAULT_PARAMETERS_KS_PBS", "PARAM_MESSAGE_2_CARRY_3_KS_PBS")
# K1 and K4 at 2_2, batch 512, with the earlier radix-2 delta body (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md), printed beside this run's
EARLIER_K1_MS, EARLIER_K4_MS = 233.376, 258.335
# K6, the staged step: the classic sets it is held at (batch sizes; batch 8
# runs every step, the others CUT_STEPS), the multi-bit ones, the cut of
# 7_1's 34 GB key, and the large-N paths served end to end (name, batch,
# held against the plain CPU path)
CLASSIC_33 = "PARAM_MESSAGE_3_CARRY_3_KS_PBS"
CLASSIC_44 = "PARAM_MESSAGE_4_CARRY_4_KS_PBS"
GROUP_3_33 = "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS"
GROUP_2_33 = "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_2_KS_PBS"
SET_2_6 = "PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_PBS_KS"
K6_SETS = (("PARAM_MESSAGE_1_CARRY_4_KS_PBS", (1, 6, 8, B)), (CLASSIC_33, (1, 6, 8, B, B + 1)),
           ("PARAM_MESSAGE_2_CARRY_5_KS_PBS", (8,)), (CLASSIC_44, (1, 8)), (SET_2_6, (1, 8)),
           ("PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS", (1, 8)))
K6_MB_SETS = ((GROUP_3_33, (1, 6, 8, B, B + 1)), (GROUP_2_33, (8,)))
CUT_STEPS = 32
STEPS_65536 = 16                       # of the N = 65536 sets' 2048
LARGE_PATHS = ((CLASSIC_33, B, True), (GROUP_3_33, B, True), (CLASSIC_44, B, False))
# K6's cluster sweep: (set, steps, forms in the order timed: the rule's
# first, then back); "passes" is the passes form
K6_SWEEP = ((CLASSIC_33, 32, ((8, 4), (4, 4), (2, 1), (16, 4), "passes")),
            (GROUP_3_33, 16, ((8, 4), (4, 4), (16, 4))),
            (CLASSIC_44, 8, ((16, 4), (16, 2), (8, 1), "passes")),
            ("PARAM_MESSAGE_2_CARRY_6_KS_PBS", 8, ((16, 2), (16, 1), "passes")),
            ("PARAM_MESSAGE_4_CARRY_4_COMPACT_PK_PBS_KS", 4, ((16, 1), "passes")),
            (SET_2_6, 4, ((16, 1), "passes")))
# the J > 15 shapes: AES_PARAMETERS_40 (J = 16), the WoP-PBS sets (J = 18)
WIDE_SETS = ("AES_PARAMETERS_40", "WOPBS_PARAM_MESSAGE_1_CARRY_8_KS_PBS")
# the keyswitch at the digits of 2, 3 and 4 byte limbs (phase 3f): (set,
# batches held, batch the plain version is timed at): base_log 11, 25 and
# 17 (7_1's K = 131072 crosses the int32 chunk; its plain version at batch
# 512 is too slow to hold there); and the large one-limb shapes
WIDE_KS_SETS = (("WOPBS_PARAM_MESSAGE_4_CARRY_4_KS_PBS", (1, 8, B, B + 1), B),
                ("PARAM_MESSAGE_5_CARRY_1_COMPACT_PK_PBS_KS", (1, 8, B, B + 1), B),
                ("PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS", (1, 8), 8))
LARGE_KS_SETS = ("PARAM_MESSAGE_3_CARRY_3_KS_PBS",
                 "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS",
                 "PARAM_MESSAGE_4_CARRY_4_KS_PBS")
# the integer path (phase 4e): BENCH_SUITE.json's radix ops at its batch
# sizes (tools/bench_suite.py:296-370), (label, op, blocks, batch); the
# "_mb" row runs on the GROUP_3 key; then signed, overflowing and CRT ops at
# small batches.  uint64_div (about 2,300 dependent calls) is left out.
INT_OPS = (("uint32_add", "add", 16, 256), ("uint64_add", "add", 32, 128),
           ("uint32_add_parallelized", "add_parallelized", 16, 256),
           ("uint8_mul", "mul", 4, 64), ("uint32_mul", "mul", 16, 32),
           ("uint64_mul", "mul", 32, 16), ("uint32_mul_mb", "mul", 16, 32),
           ("uint32_bitand", "bitand", 16, 32), ("uint32_eq", "eq", 16, 32),
           ("uint32_gt", "gt", 16, 32), ("uint32_max", "max", 16, 32),
           ("uint32_neg", "neg", 16, 32), ("uint32_shl", "left_shift", 16, 64),
           ("uint32_rotl", "rotate_left", 16, 64), ("uint64_shl", "left_shift", 32, 64),
           ("uint8_div", "div", 4, 64), ("uint16_div", "div", 8, 16),
           ("uint32_div", "div", 16, 8),
           ("int32_lt_signed", "lt_signed", 16, 8), ("int8_signed_div_rem", "signed_div_rem", 4, 8),
           ("uint32_overflowing_add", "unsigned_overflowing_add", 16, 8),
           ("crt_add", "crt_add", 3, 8), ("crt_mul", "crt_mul", 2, 8))
# CRT moduli: crt_add on (2, 3, 5); crt_mul packs two residues as x * 4 + y,
# so its moduli must not exceed the message modulus 4 at 2_2
INT_CRT_MODULI = {"crt_add": (2, 3, 5), "crt_mul": (3, 4)}
# the ops whose largest KS+PBS call is held, first and last 8 rows, against
# the plain CPU path: the classic key's widest call (K1) and the GROUP_3 key's
# (K3, the GROUP_3 keyswitch)
INT_SPIED = ("uint64_mul", "uint32_mul_mb")
# tfhe-rs on an m6i.metal CPU, ms per op (BASELINE.md:24-35).  BASELINE.md
# has no multi-bit, signed or overflowing rows: those ops stand beside the
# figure of the row named in INT_BASELINE_OF, a stand-in, not their own
INT_BASELINE_MS = {"uint32_add": 132.0, "uint64_add": 186.0, "uint32_add_parallelized": 132.0,
                   "uint8_mul": 144.0, "uint32_mul": 333.0, "uint64_mul": 832.0,
                   "uint32_mul_mb": 333.0, "uint32_bitand": 21.0, "uint32_eq": 57.4,
                   "uint32_gt": 98.8, "uint32_max": 135.0, "uint32_neg": 129.0,
                   "uint32_shl": 180.0, "uint32_rotl": 182.0, "uint64_shl": 243.0,
                   "uint8_div": 729.0, "uint16_div": 1930.0, "uint32_div": 4810.0,
                   "int32_lt_signed": 98.8, "int8_signed_div_rem": 729.0,
                   "uint32_overflowing_add": 132.0}
INT_BASELINE_OF = {"uint32_mul_mb": "classic Mul", "int32_lt_signed": "unsigned Cmp",
                   "int8_signed_div_rem": "unsigned Div/Rem",
                   "uint32_overflowing_add": "Add/Sub"}
# ROADMAP C11, the PBS -> KS order: a named shortint set of key choice small
# whose N one block holds (1_1, K1 at R = 4: its rows cost the plain CPU
# path a fraction of what 2_2's twin's do)
PBS_KS_SET = "PARAM_MESSAGE_1_CARRY_1_PBS_KS"
# the boolean path (phase 4f): the five named sets, KS -> PBS then PBS -> KS;
# the AND gate timed at BOOL_BATCHES; one set of each order held against the
# plain CPU path; tfhe-rs's ms a gate on an m6i.metal CPU (BASELINE.md:12-14),
# printed beside, not against
BOOL_SETS = ("DEFAULT_PARAMETERS_KS_PBS", "PARAMETERS_ERROR_PROB_2_POW_MINUS_165_KS_PBS",
             "DEFAULT_PARAMETERS", "TFHE_LIB_PARAMETERS", "PARAMETERS_ERROR_PROB_2_POW_MINUS_165")
BOOL_HELD = ("DEFAULT_PARAMETERS_KS_PBS", "TFHE_LIB_PARAMETERS")
BOOL_BATCHES = (1, 32, B)
BOOL_BASELINE_MS = {"DEFAULT_PARAMETERS_KS_PBS": 9.19,
                    "PARAMETERS_ERROR_PROB_2_POW_MINUS_165_KS_PBS": 14.1,
                    "TFHE_LIB_PARAMETERS": 10.0}
BOOL_TRUTH = {"and_": lambda x, y: x & y, "nand": lambda x, y: ~(x & y),
              "or_": lambda x, y: x | y, "nor": lambda x, y: ~(x | y),
              "xor_": lambda x, y: x ^ y, "xnor": lambda x, y: ~(x ^ y)}
# the apps (phase 4g): Trivium on shortint bits as tools/bench_suite.py:204
# runs it (32 streams, 18 rounds of 64 clocks, round 19 checked); the boolean
# streams at DEFAULT_PARAMETERS_KS_PBS, their warm-up cut to what fits
# STREAM_BUDGET_S at the measured gate latency; SHA-256 whole if its
# projected time fits SHA_BUDGET_S; the byte stream with its full warm-up
TRIVIUM_SET = "PARAM_MESSAGE_1_CARRY_2_KS_PBS"
APP_BOOL_SET = "DEFAULT_PARAMETERS_KS_PBS"
STREAMS = 32
STREAM_BUDGET_S = 10.0     # keeps the whole script well inside its 1,200 s limit
SHA_BUDGET_S = 120.0
BYTE_WARMUP = 18
# transciphering in phase 4g: the shortint stream's bit pairs cast into the
# high-level API's set on this decomposition
CAST_SET = "PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS"
# the high-level API (phase 4j): FheUint8 at HL_BATCH, the wider types at
# HL_WIDE_BATCH, public-key holds on HL_HELD rows
HL_SET = CLASSIC
HL_BATCH = 64
HL_WIDE_BATCH = 8
HL_HELD = 4
# the WoP-PBS (phase 4k): new_wopbs_key(ck, sk, "auto") on keys of
# WOPBS_COMPUTE_SET, WOPBS_BATCH ciphertexts a call, holds on WOPBS_HELD rows
WOPBS_COMPUTE_SET = CLASSIC
WOPBS_BATCH = 512
WOPBS_HELD = 4
# the gadget fork (phase 4l): the gates at GADGET_GATE_SET at GADGET_GATE_BATCHES,
# beside phase 4f's boolean AND at the boolean set of the same name and shapes;
# the LUT, MVB, tree, LWE-multiplication and WoP-PBS ops at GADGET_OP_SET on
# GADGET_BATCH ciphertexts; K7 held over GADGET_K7_STEPS rotation steps and K1
# on the tree's packed accumulator, each on GADGET_HELD rows
GADGET_GATE_SET = "DEFAULT_PARAMETERS"
GADGET_GATE_BATCHES = (1, 32, B)
GADGET_OP_SET = "AES_PARAMETERS_40"
GADGET_BATCH = B
GADGET_HELD = 8
GADGET_K7_STEPS = 3
# lwe_mult's and woppbs_lut's rows right at GADGET_OP_SET before the port's
# glwe_mult rounded its modulus switch (ROADMAP C12; PERF.md §5), beside today's
C12_TRUNCATING_RIGHT = {"lwe_mult": 44, "woppbs_lut": 33}
GADGET_GATES = {"and": (lambda a, b: a & b, 2, [1, 2], 5),
                "or": (lambda a, b: a | b, 2, [1, 2], 5),
                "xor": (lambda a, b: a ^ b, 2, [1, 2], 5),
                "nand": (lambda a, b: 1 - (a & b), 2, [1, 2], 5),
                "maj3": (lambda a, b, c: (a + b + c >= 2) * 1, 3, [1, 1, 1], 7)}
# the key flow (phase 4i): a compressed shortint server key at 2_2 and a
# compressed boolean server key and public key at the boolean
# DEFAULT_PARAMETERS_KS_PBS, each through a tfhe_tpu-v1 file, then the 4_4
# compressed key decompressed on the card with a KS+PBS at KEY_FLOW_44_BATCH;
# the CPU holds take KEY_FLOW_ENDS input bits and KEY_FLOW_KSK_ROWS
# keyswitching-key rows at each end of the key
# phase 4m: the GGSW shift (BENCH_SUITE.json's uint32_shl / uint32_rotl /
# uint64_shl rows); tfhe-rs's CPU times of those rows (tools/bench_suite.py:45-54)
SHIFT_SET = CLASSIC
SHIFT_BATCH = 64
SHIFT_OPS = (("uint32_shl", "shl", 16), ("uint32_shr", "shr", 16), ("uint32_rotl", "rotl", 16),
             ("uint32_rotr", "rotr", 16), ("int32_ashr", "ashr", 16), ("uint64_shl", "shl", 32))
SHIFT_BASELINE_MS = {"uint32_shl": 180.0, "uint32_rotl": 182.0, "uint64_shl": 243.0}
SHIFT_CHAIN = 40
# phase 4n: the integer WoP-PBS
IWOPBS_SET = "WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS"
IWOPBS_BLOCKS = 8
IWOPBS_BATCH = 64
IWOPBS_MODULI = (2, 3, 5)
# phase 4o: the 2^128 torus at 2_2's shapes, and the custom moduli of
# tests/test_nonnative.py
PBS128_SET = CLASSIC
PBS128_BATCH = B
KS128_REPS = 7
CUSTOM_MODULI = ((1 << 64) - (1 << 32) + 1, (1 << 48) - 59, 1 << 63)

KEY_FLOW_SHORTINT = CLASSIC
KEY_FLOW_BOOL = "DEFAULT_PARAMETERS_KS_PBS"
KEY_FLOW_44 = CLASSIC_44
KEY_FLOW_44_BATCH = 8
KEY_FLOW_ENDS = 8
KEY_FLOW_KSK_ROWS = 64


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms_reps(fn, reps: int) -> list:
    """Milliseconds of each of reps runs of fn(), by CUDA events."""
    return [cuda_ms(fn, 1) for _ in range(reps)]


def profile_window(fn, warm: bool = True, cpu: bool = True) -> tuple:
    """One call of fn() under torch.profiler (after a warm call, unless
    warm=False; host-side events too, unless cpu=False) → (wall ms on the
    host clock, synchronised; {kernel name: device ms} from key_averages();
    the device kernels [(name, start us, length us)] in start order, from
    the exported trace)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timeline = sorted((e["name"], e["ts"], e["dur"]) for e in events
                      if e.get("cat") == "kernel" and "ts" in e and "dur" in e)
    return wall_ms, kernels, sorted(timeline, key=lambda e: e[1])


def profile_launches(fn, name_part: str, launches: int, label: str) -> tuple:
    """profile_window(fn), traced once more where the trace holds fewer
    kernels named `name_part` than the launch counters saw in the same call
    (the profiler can drop the records of a window's first kernels: one
    trace of a 3_3 call held 860 of its 864 K6 launches, its keyswitch's
    records missing too).  → profile_window's tuple and the kernels'
    timeline entries; the caller still holds their count exact."""
    for attempt in (1, 2):
        wall_ms, by_kernel, timeline = profile_window(fn)
        events = [e for e in timeline if name_part in e[0]]
        if len(events) == launches or attempt == 2:
            return wall_ms, by_kernel, timeline, events
        print(f"{label}: the trace recorded {len(events)} of the {launches} {name_part} "
              f"launches the counters saw; traced again", flush=True)


def busy_ms(timeline: list) -> float:
    """Device time covered by at least one kernel: the union of the
    kernels' intervals.  K4 launches overlap (programmatic dependent
    launch: the next one starts and waits while this one ends), so their
    lengths overstate it."""
    total, end = 0.0, -math.inf
    for _, ts, dur in timeline:
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total / 1e3


def exclusive_ms(timeline: list) -> dict:
    """{kernel name: device ms} where each kernel is charged only the part of
    its interval after every earlier kernel has ended (the union of the
    intervals, split by kernel): a launch that waits for the previous one
    under programmatic dependent launch is not charged for the wait."""
    out, end = {}, -math.inf
    for name, ts, dur in timeline:
        if ts + dur > end:
            out[name] = out.get(name, 0.0) + (ts + dur - max(ts, end)) / 1e3
            end = ts + dur
    return out


def device_gaps(timeline: list, top: int = 3) -> tuple:
    """The stretches between a trace's first and last kernel with none
    running: (their sum in ms, the `top` longest as (ms, the kernel that
    starts after it))."""
    gaps, end = [], None
    for name, ts, dur in timeline:
        if end is not None and ts > end:
            gaps.append(((ts - end) / 1e3, name))
        end = ts + dur if end is None else max(end, ts + dur)
    return sum(g for g, _ in gaps), sorted(gaps, reverse=True)[:top]


def print_profile(label: str, wall_ms: float, by_kernel: dict, timeline: list) -> float:
    """Print a profiled call's device busy time (the union of its kernels'
    intervals), idle share and top kernels by summed length; → the busy ms."""
    busy = busy_ms(timeline)
    print(f"{label}: {wall_ms:.3f} ms on the host clock, device busy {busy:.3f} ms "
          + (f"(idle share {1 - busy / wall_ms:.2%}; kernel lengths sum to "
             f"{sum(by_kernel.values()):.3f} ms)" if busy else
             "(the trace shows no device time)"))
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:10.3f} ms  {name[:100]}")
    return busy


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int64 torus words (0 iff bit-identical)."""
    return int((a - b).abs().max().item())


def hold(name: str, got: torch.Tensor, ref: torch.Tensor, what: str = "plain") -> int:
    """Print and check bit-identity; → max_abs_err."""
    same = torch.equal(got, ref)
    print(f"{name}: {'bit-identical' if same else 'MISMATCH'} to {what}")
    if not same:
        raise AssertionError(f"{name} disagrees with {what}")
    return max_abs_err(got, ref)


# ---- bounds: 32-bit integer multiplies counted from csrc/, and bytes --------
# mul_shoup = 3 (__umulhi, a*w, q*p); barrett = 7 (__umul64hi of two u64: 4,
# q*p low 64 bits: 3); a 32x32->64 MAC product = 1; a u64 x u64 low product
# = 3; the phase index e*odd = 1.

def ntt_mults(n: int) -> int:
    return 3 * (n // 2) * (n.bit_length() - 1)


def garner_mults(P: int) -> int:
    return sum(3 * a + 3 + 3 for a in range(1, P))


def k1_mults(batch, steps, P, J, R, n, chunks) -> int:
    """K1/K4 (and K6's delta steps): the NTTs; per output J products, a
    Barrett reduction per 16 and the phase's Shoup multiply; one phase
    index per slot and MAC chunk; the last two forward stages again for
    each chunk after the first; Garner."""
    mac = R * n * (J + 7 * math.ceil(J / 16) + 3) + chunks * n + (chunks - 1) * J * 3 * n
    per_prime = J * ntt_mults(n) + mac + R * ntt_mults(n)
    return batch * steps * (P * per_prime + R * n * garner_mults(P))


def variant_reductions(V, J) -> int:
    """Barrett reductions of one variant MAC sum (csrc/rotation.cu): before
    a run of at most 16 products that would take it past 16, and the last."""
    count = reductions = 0
    for _ in range(V):
        for j0 in range(0, J, 16):
            run = min(J, j0 + 16) - j0
            if count + run > 16:
                reductions, count = reductions + 1, 0
            count += run
    return reductions + 1


def k3_mults(batch, steps, V, P, J, R, n) -> int:
    """K3/K5 (and K6's variant steps)."""
    mac = n * ((V - 1) * (1 + 3 * J) + R * V * J + R * 7 * variant_reductions(V, J) + R * 3)
    per_prime = J * ntt_mults(n) + mac + R * ntt_mults(n)
    return batch * steps * (P * per_prime + R * n * garner_mults(P))


def k2_mults(batch, K, M) -> int:
    """The same contraction on the CUDA cores, as the retired wide form K2
    ran it: a u64 x u64 low product (3) a multiply-add."""
    return 3 * batch * K * M


def decompose_ops(batch, n_in, levels, limbs=1) -> int:
    """The decomposition pass's 32-bit integer operations, counted from
    csrc/keyswitch.cu: the rounding add and shift of a 64-bit word (4),
    then an and, add, shift, subtract and shift-add of 64 bits a digit (10),
    and a signed byte, subtract and shift of 64 bits a limb below the top
    (6)."""
    return batch * n_in * (4 + (10 + 6 * (limbs - 1)) * levels)


def pair_products(limbs: int) -> int:
    """K2's useful limb-pair products a word at `limbs` digit limbs: digit
    limb i against key byte slots i..7 (8, 15, 21, 26)."""
    return 8 * limbs - limbs * (limbs - 1) // 2


def tc_bound(batch, K, M, Kp, sm_clock_hz, sms, limbs=1) -> tuple:
    """K2': (bound_ms, bound_by), the larger of its useful limb-pair
    products (`pair_products`), 2·B·K·M operations each, over the int8
    tensor-core rate (INT8_MACS_PER_SM multiply-adds a clock, 2 operations
    each) and its bytes (the digit limbs and the key bytes read, the body
    read and the words written, once) over the memory rate."""
    ops_ms = (2 * pair_products(limbs) * batch * K * M
              / (2 * INT8_MACS_PER_SM * sms * sm_clock_hz) * 1e3)
    bytes_ms = ((batch * limbs * Kp + 8 * M * Kp + batch * 8 + batch * M * 8)
                / HBM_BYTES_PER_S * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cuda_core_bound(batch, K, M, sm_clock_hz, sms) -> tuple:
    """The bound the retired wide form K2 was held to (64-bit multiply-adds
    on the CUDA cores, int32 digits and the u64 key read once), printed
    beside tc_bound at the shapes of several digit limbs, so that their
    rows read against both yardsticks."""
    return bound(k2_mults(batch, K, M), batch * K * 4 + K * M * 8 + batch * 8 + batch * M * 8,
                 sm_clock_hz, sms)


def int_mm_ms(m, k, n, dev):
    """torch._int_mm on [m, k] x [k, n] int8 (the second column-major):
    the card's int8 GEMM rate as PyTorch's library call gives it, a
    yardstick only (signed bytes and no recombination: not K2's
    function); None where it refuses the shape."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k * 3 + n)
    a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f"torch._int_mm [{m}, {k}] x [{k}, {n}]: not measured ({str(e)[:200]})")
        return None
    return cuda_ms(lambda: torch._int_mm(a, b), 10)


def step_bytes(steps, V, P, J, R, n, e_per_step) -> int:
    """Bytes of a per-step rotation: every launch reads its key slice and
    exponents and reads and writes the whole accumulator."""
    return steps * (V * P * J * R * n * 4 + 2 * B * R * n * 8 + B * e_per_step * 4)


def bound(mults: int, nbytes: int, sm_clock_hz: float, sms: int) -> tuple:
    """(bound_ms, bound_by): the larger of operations over the INT32 issue
    rate and bytes over the memory rate."""
    ops_ms = mults / (INT32_LANES_PER_SM * sms * sm_clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


COMPARED = ("PARAM_MESSAGE_3_CARRY_3_KS_PBS", "PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS",
            "PARAM_MESSAGE_4_CARRY_4_KS_PBS")
# --against's external products, label -> (batch, N, k+1, base_log, level, P,
# the GGSW shared, the rotated operand): K7 at the WoP-PBS's vertical packing,
# the gadget MVB and the integer WoP-PBS's CMux tree; K8 at the 128-bit PBS
EP_SHAPES = {
    "K7 WoP-PBS vertical packing": (512, 2048, 2, 5, 3, 3, False, False),
    "K7 gadget MVB": (512, 512, 4, 6, 4, 3, True, True),
    "K7 CMux tree": (64, 2048, 2, 5, 3, 3, False, False),
    "K8 128-bit PBS step": (512, 2048, 2, 23, 1, 6, True, True),
}


def ep_case(label: str, g, dev) -> dict:
    """EP_SHAPES[label] with random operands from g on dev: {"run": the
    wrapper's call (keywords passed on), "plain": the plain version's,
    "bytes": each input read once and the output written once, "mults":
    the bound's count (k7_mults, k8_mults), "shape", "batch", "P"}."""
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.params import DecompParams
    from tfhe_tpu_torch.core.poly import external_product, ntt

    b, N, R, base_log, L, P, shared, rotated = EP_SHAPES[label]
    plan = ntt.get_plan(N, P)
    lead = () if shared else (b,)
    spectra = torch.stack([torch.randint(0, q, lead + (L * R, R, N), generator=g, device=dev,
                                         dtype=torch.int32) for q in plan.primes],
                          dim=len(lead))
    exps = torch.randint(0, 2 * N, (b,), generator=g, device=dev)
    decomp = DecompParams(base_log, L)
    J = L * R
    if label.startswith("K8"):
        acc = rng.uniform_torus(g, (b, R, N, 2))
        run = lambda **kw: external_product.external_product128(acc, spectra, decomp, exps, **kw)
        plain = lambda: external_product.external_product128_plain(acc, spectra, decomp, exps)
        nbytes, mults = _nbytes(acc, spectra, exps) + acc.numel() * 8, k8_mults(b, P, J, R, N)
    else:
        acc, ct1 = rng.uniform_torus(g, (b, R, N)), rng.uniform_torus(g, (b, R, N))
        op = {"exps": exps} if rotated else {"ct1": ct1}
        run = lambda **kw: external_product.external_product(acc, spectra, decomp, **op, **kw)
        plain = lambda: external_product.external_product_plain(acc, spectra, decomp, **op)
        nbytes = _nbytes(acc, spectra, *op.values()) + acc.numel() * 8
        mults = k7_mults(b, P, J, R, N)
    shape = (f"{label}: batch {b}, N={N}, k+1={R}, {base_log}x{L} (J={J}), P={P}, "
             f"{'a GGSW shared' if shared else 'a GGSW a row'}, "
             f"{'rotated' if rotated else 'explicit'} operand")
    return {"run": run, "plain": plain, "bytes": nbytes, "mults": mults, "shape": shape,
            "batch": b, "n": N, "R": R, "J": J, "P": P}


def measure_turn(seed: int, only: tuple = ()) -> dict:
    """One turn of --against in the port first on sys.path: {label: {"ms",
    "check", ...}}; with `only`, the measurements whose labels start with
    one of its prefixes."""
    import numpy as np

    from tfhe_tpu_torch import interop, shortint
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes
    from tfhe_tpu_torch.core.algorithms.keyswitch import keyswitch_lwe
    from tfhe_tpu_torch.core.entities import (LweCiphertext, NttBootstrapKey,
                                              NttMultiBitBootstrapKey)
    from tfhe_tpu_torch.core.params import shortint_params, wopbs_params
    from tfhe_tpu_torch.core.poly import ntt, rotation

    dev = torch.device("cuda", 0)

    def wanted(label):
        return not only or label.startswith(tuple(only))

    def checksum(t):
        w = t.to(torch.int64).reshape(-1)
        idx = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
        return int(((w * (2 * idx + 1)).sum()).item())

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        return cuda_ms(fn, reps)

    out = {}
    g = rng.generator(seed, 7, device=dev)
    for name in (CLASSIC,) + COMPARED:
        if not wanted(f"rotation {name}"):
            continue
        p = shortint_params(name)
        n, N, R = p.lwe_dimension, p.polynomial_size, p.glwe_dimension + 1
        J, gf = p.pbs_level * R, getattr(p, "grouping_factor", None)
        P = external_product_num_primes(N, R, p.pbs_decomp)
        plan = ntt.get_plan(N, P)
        steps = n // gf if gf else n
        shape = (steps, 1 << gf, J, R, N) if gf else (steps, J, R, N)
        spectra = torch.stack([torch.randint(0, q, shape, generator=g, device=dev,
                                             dtype=torch.int32) for q in plan.primes],
                              dim=2 if gf else 1)
        acc = rng.uniform_torus(g, (B, R, N))
        exps = torch.randint(0, 2 * N, (B, n), generator=g, device=dev)
        res = {}
        if gf:
            key = NttMultiBitBootstrapKey(spectra=spectra, decomp=p.pbs_decomp,
                                          primes=plan.primes, grouping_factor=gf)
            cexp = rotation.variant_exponents(exps, gf, N)
            run = lambda: res.update(o=rotation.rotate_accumulator_multi_bit(acc, cexp, key))
        else:
            key = NttBootstrapKey(spectra=spectra, decomp=p.pbs_decomp, primes=plan.primes)
            run = lambda: res.update(o=rotation.rotate_accumulator(acc, exps, key))
        ms = timed(run, 2 if N >= 32768 else 3)
        out[f"rotation {name}"] = {"ms": ms, "steps": steps, "check": checksum(res["o"])}
        del spectra, key, acc, exps, res
        torch.cuda.empty_cache()
    for label in EP_SHAPES:
        # K7 and K8 at the main path's shapes, random operands
        if not wanted(label):
            continue
        case = ep_case(label, g, dev)
        res = {}
        ms = timed(lambda: res.update(o=case["run"]()), 20)
        out[label] = {"ms": ms, "check": checksum(res["o"])}
        del case, res
        torch.cuda.empty_cache()
    for name in (CLASSIC, CLASSIC_33, CLASSIC_44) + tuple(w[0] for w in WIDE_KS_SETS):
        # the keyswitch alone, the key carried in as a u64 array
        if not wanted(f"keyswitch {name}"):
            continue
        p = wopbs_params(name) if name.startswith("WOPBS") else shortint_params(name)
        n_in, M = p.big_lwe_dimension, p.lwe_dimension + 1
        data = rng.uniform_torus(g, (n_in, p.ks_level, M)).cpu().numpy().view(np.uint64)
        ksk = interop.keyswitch_key(data, p.ks_decomp, device=dev)
        ct = LweCiphertext(data=rng.uniform_torus(g, (B, n_in + 1)))
        res = {}
        ms = timed(lambda: res.update(o=keyswitch_lwe(ct, ksk)), 10)
        out[f"keyswitch {name}"] = {"ms": ms, "check": checksum(res["o"].data)}
        del data, ksk, ct, res
        torch.cuda.empty_cache()
    for name in (CLASSIC,) + COMPARED:
        if not wanted(f"KS+PBS {name}"):
            continue
        p = shortint_params(name)
        t0 = time.perf_counter()
        ck, sk = shortint.gen_keys(p, seed=seed, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        q = p.message_modulus
        m = torch.randint(0, q, (B,), generator=rng.generator(seed, 11, device="cpu"),
                          dtype=torch.int64)
        ct = ck.encrypt(m.to(dev), seed=seed + 6)
        lut = sk.generate_lookup_table(lambda x: (3 * x + 1) % q)
        res = {}
        ms = timed(lambda: res.update(o=sk.apply_lookup_table(ct, lut)),
                   2 if p.polynomial_size >= 32768 else 3)
        right = int((ck.decrypt(res["o"]).cpu() == (3 * m + 1) % q).sum())
        out[f"KS+PBS {name}"] = {"ms": ms, "pbs_per_s": B / ms * 1e3, "right": right,
                                 "gen_keys_s": gen_s, "check": checksum(res["o"].lwe.data)}
        del ck, sk, ct, lut, res
        torch.cuda.empty_cache()
    return out


def compare(other: str, turns: int, seed: int, only: tuple = ()) -> int:
    """--against: this checkout and `other` in turns on one card (with
    `only`, the measurements whose labels start with one of its prefixes)."""
    this = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    card = smi("name,power.limit")
    print(f"card: {card}; this tree {this}, other {other}")
    pattern = [("other", other), ("this", this), ("this", this), ("other", other)]
    runs = {"other": [], "this": []}
    for i in range(turns):
        label, tree = pattern[i % 4]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn-in", tree,
                               "--seed", str(seed)] + (["--only", ",".join(only)] if only else []),
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"turn {i + 1} ({label}) failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(got)
        print(f"turn {i + 1} ({label}, {time.perf_counter() - t0:.1f} s): {json.dumps(got)}",
              flush=True)
    first = runs["other"][0] if runs["other"] else runs["this"][0]
    for label, done in runs.items():
        for got in done:
            for k, v in got.items():
                if v["check"] != first[k]["check"]:
                    raise AssertionError(f"{k}: the {label} tree's output differs")
                if "right" in v and v["right"] != B:
                    raise AssertionError(f"{k}: {v['right']}/{B} decrypt right ({label})")
    print(f"every output agrees across the {turns} turns; every KS+PBS output decrypts "
          f"{B}/{B} right")
    print(f"[{card}] means over the turns, batch {B} (other -> this):")
    for k in first:
        mean = {lab: sum(t[k]["ms"] for t in done) / len(done)
                for lab, done in runs.items() if done}
        each = {lab: [round(t[k]["ms"], 3) for t in done] for lab, done in runs.items()}
        line = f"    {k}: " + " -> ".join(f"{mean[lab]:.3f} ms" for lab in mean)
        if len(mean) == 2:
            line += f" ({mean['this'] / mean['other'] - 1:+.2%})"
            if k.startswith("KS+PBS"):
                line += (f"; {B / mean['other'] * 1e3:.2f} -> {B / mean['this'] * 1e3:.2f} "
                         f"PBS/s")
        print(line + f"; runs {json.dumps(each)}")
    return 0


@contextlib.contextmanager
def plain_kernels():
    """Within: the kernel wrappers of the classic KS+PBS path and of the
    WoP-PBS (K1, the decomposition pass, K2', K7) take their plain PyTorch
    versions, the code CPU tensors take, on CUDA tensors too."""
    from tfhe_tpu_torch.core.algorithms import bootstrap, keyswitch, wopbs
    from tfhe_tpu_torch.core.poly import external_product as ep
    from tfhe_tpu_torch.core.poly import rotation
    saved = (rotation.rotate_accumulator, keyswitch.decompose_digits,
             keyswitch.neg_digit_mac_tensor_core, wopbs.external_product,
             bootstrap.external_product)
    rotation.rotate_accumulator = lambda acc, exps, key: rotation.blind_rotate_plain(acc, exps,
                                                                                     key)
    keyswitch.decompose_digits = keyswitch.decompose_digits_plain
    keyswitch.neg_digit_mac_tensor_core = lambda digits, key, limbs, body, base_log: (
        keyswitch.neg_digit_mac_plain(keyswitch.join_limbs(
            digits, key.shape[0], keyswitch.digit_limbs(base_log)), key, body))
    wopbs.external_product = bootstrap.external_product = ep.external_product_plain
    try:
        yield
    finally:
        (rotation.rotate_accumulator, keyswitch.decompose_digits,
         keyswitch.neg_digit_mac_tensor_core, wopbs.external_product,
         bootstrap.external_product) = saved


def _blocks(out) -> list:
    """Every shortint block of an integer op's result."""
    if isinstance(out, tuple):
        return [b for o in out for b in _blocks(o)]
    if hasattr(out, "blocks"):
        return list(out.blocks)
    return [out.block]


def integer_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4e: the integer path on the card.  integer.gen_keys at 2_2 for
    4, 8, 16 and 32 blocks and on the GROUP_3 key at 16; each op of INT_OPS
    once on random clear values from the seed, with the kernels' counts set
    to 0 just before and read just after (K1, or K3 on the GROUP_3 key, the
    decomposition pass and K2' once per KS+PBS call, nothing else), timed by
    CUDA events (ms per op: the op's time over its batch), its KS+PBS calls
    and rows counted, its peak device memory read, every output block on
    the card and decrypted against the clear model.  Then one FheUint8 mul
    (batch 4) held bit for bit against the plain path on the same keys and
    ciphertexts (`plain_kernels`: the CPU path's code on the card's
    tensors), the first and last 8 rows of the largest call of each op in
    INT_SPIED against the plain CPU path on those rows alone, and one FheUint32 add and one div traced under
    torch.profiler.  → {"launches": {kernel: launches over every op},
    "ops": [one dict per op]}."""
    import numpy as np

    from tfhe_tpu_torch import integer, shortint
    from tfhe_tpu_torch.core.entities import GlweCiphertext, LweCiphertext
    from tfhe_tpu_torch.shortint.server_key import LookupTable

    calls, spy, spied = [], {"on": False, "rows": 0}, {}
    orig_apply = shortint.ServerKey.apply_lookup_table

    def counted(self, ct, lut):
        out = orig_apply(self, ct, lut)
        rows = math.prod(ct.lwe.data.shape[:-1])
        calls.append(rows)
        if spy["on"] and rows > spy["rows"]:
            spy.update(rows=rows, data=ct.lwe.data, acc=lut.acc.data, out=out.lwe.data,
                       key=self)
        return out

    def keep_ends():
        """The spied call's first and last 8 rows, inputs, LUTs and outputs,
        on the host; the call's full tensors are let go."""
        n1, (R, N) = spy["data"].shape[-1], spy["acc"].shape[-2:]
        flat = spy["data"].reshape(-1, n1)
        idx = torch.cat([torch.arange(8), torch.arange(flat.shape[0] - 8, flat.shape[0])])
        idx = idx.to(flat.device)
        luts = spy["acc"].expand(tuple(spy["data"].shape[:-1]) + (R, N)).reshape(-1, R, N)
        ends = {"rows": spy["rows"], "key": spy["key"], "data": flat[idx].cpu(),
                "luts": luts[idx].cpu(), "out": spy["out"].reshape(-1, n1)[idx].cpu()}
        spy.clear()
        spy.update(on=False, rows=0)
        return ends

    keys = {}
    for name, nb in ((CLASSIC, 4), (CLASSIC, 8), (CLASSIC, 16), (CLASSIC, 32), (GROUP_3, 16)):
        t0 = time.perf_counter()
        keys[(name, nb)] = integer.gen_keys(name, num_blocks=nb, seed=seed, device=dev)
        torch.cuda.synchronize()
        print(f"{tag} integer.gen_keys {name}, {nb} blocks, on the card: "
              f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)

    def ints(hi, n):
        return [int(v) for v in rng.integers(0, hi, n, dtype=np.uint64)]

    def case(op, nb, batch, ck):
        """(operands, expected clear results, decrypt) for one op."""
        w = 2 * nb
        mod, half = 1 << w, 1 << (w - 1)
        if op.startswith("crt_"):
            moduli = INT_CRT_MODULI[op]
            M = math.prod(moduli)
            cck = integer.CrtClientKey(key=ck.key, moduli=moduli)
            a, b = ints(M, batch), ints(M, batch)
            f = (lambda x, y: (x + y) % M) if op == "crt_add" else (lambda x, y: x * y % M)
            return ((cck.encrypt(a, seed=seed + 40), cck.encrypt(b, seed=seed + 41)),
                    [f(x, y) for x, y in zip(a, b)], lambda o: [int(v) for v in cck.decrypt(o)])
        if op in ("lt_signed", "signed_div_rem"):
            a = [v - half for v in ints(mod, batch)]
            b = [v - half for v in ints(mod, batch)]
            if op == "signed_div_rem":
                b = [v or 1 for v in b]
            args = (ck.encrypt_signed(a, seed=seed + 42), ck.encrypt_signed(b, seed=seed + 43))
            if op == "lt_signed":
                return args, [x < y for x, y in zip(a, b)], lambda o: list(ck.decrypt_bool(o))
            wrap = lambda v: (v + half) % mod - half
            q = [wrap(int(x / y)) for x, y in zip(a, b)]
            return args, [(qq, x - int(x / y) * y) for qq, x, y in zip(q, a, b)], \
                lambda o: list(zip(ck.decrypt_signed(o[0]).tolist(),
                                   ck.decrypt_signed(o[1]).tolist()))
        a = ints(mod, batch)
        if op in ("left_shift", "rotate_left"):
            b = ints(w, batch)
        elif op == "div":
            b = [v + 1 for v in ints(mod - 1, batch)]
        else:
            b = ints(mod, batch)
        ca, cb = ck.encrypt(a, seed=seed + 44), ck.encrypt(b, seed=seed + 45)
        dec = lambda o: [int(v) for v in ck.decrypt(o)]
        clear = {"add": lambda x, y: (x + y) % mod, "add_parallelized": lambda x, y: (x + y) % mod,
                 "mul": lambda x, y: x * y % mod, "bitand": lambda x, y: x & y,
                 "max": max, "neg": lambda x, y: -x % mod,
                 "left_shift": lambda x, y: (x << y) % mod,
                 "rotate_left": lambda x, y: ((x << y) | (x >> (w - y))) % mod,
                 "div": lambda x, y: x // y}
        if op in ("eq", "gt"):
            f = (lambda x, y: x == y) if op == "eq" else (lambda x, y: x > y)
            return (ca, cb), [f(x, y) for x, y in zip(a, b)], lambda o: list(ck.decrypt_bool(o))
        if op == "unsigned_overflowing_add":
            return (ca, cb), [((x + y) % mod, x + y >= mod) for x, y in zip(a, b)], \
                lambda o: list(zip(dec(o[0]), ck.decrypt_bool(o[1]).tolist()))
        want = [clear[op](x, y) for x, y in zip(a, b)]
        return ((ca,) if op == "neg" else (ca, cb)), want, dec

    totals, ops, kept = {}, [], {}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # one small add and mul first, untimed and uncounted: the first call of a
    # process pays one-off costs (tables, lazily loaded modules) that are no
    # op's
    ck, sk = keys[(CLASSIC, 4)]
    warm = (ck.encrypt([1, 2], seed=seed + 48), ck.encrypt([3, 4], seed=seed + 49))
    sk.add(*warm), sk.mul(*warm)
    torch.cuda.synchronize()
    shortint.ServerKey.apply_lookup_table = counted
    try:
        for label, op, nb, batch in INT_OPS:
            multi_bit = label.endswith("_mb")
            ck, sk = keys[(GROUP_3 if multi_bit else CLASSIC, 4 if op.startswith("crt_") else nb)]
            args, want, decrypt = case(op, nb, batch, ck)
            fn = getattr(sk, op)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held_mb = torch.cuda.memory_allocated(dev) / 1e6
            zero_counts()
            calls.clear()
            spy["on"] = label in INT_SPIED
            start.record()
            t0 = time.perf_counter()
            out = fn(*args)
            stop.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            spy["on"] = False
            ms = start.elapsed_time(stop)
            counts = read_counts()
            peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
            rot = "blind_rotate_multibit" if multi_bit else "blind_rotate"
            expect = {k: 0 for k in counts}
            expect.update({rot: len(calls), "keyswitch_tc": len(calls),
                           "keyswitch_decompose": len(calls)})
            if counts != expect or not calls:
                raise AssertionError(f"{label}: launches {counts} over {len(calls)} KS+PBS "
                                     f"calls, expected {expect}")
            if label in INT_SPIED:
                spied[label] = keep_ends()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            if any(b.lwe.data.device != dev for b in _blocks(out)):
                raise AssertionError(f"{label}: an output block is off the card")
            got = decrypt(out)
            right = int(sum(g == w_ for g, w_ in zip(got, want)))
            row = {"op": label, "blocks": nb, "batch": batch, "calls": len(calls),
                   "rows": sum(calls), "largest_call": max(calls),
                   "pbs_per_op": sum(calls) / batch, "ms_per_op": ms / batch, "ms": ms,
                   "host_s": host_s, "peak_mb": peak_mb, "held_mb": held_mb,
                   "right": right, "baseline_cpu_ms": INT_BASELINE_MS.get(label),
                   "baseline_cpu_of": INT_BASELINE_OF.get(label)}
            ops.append(row)
            print(f"{tag} integer {label} ({nb} blocks, batch {batch}): {right}/{batch} decrypt "
                  f"right; {len(calls)} KS+PBS calls, {sum(calls)} rows ({row['pbs_per_op']:.1f} "
                  f"PBS per op, largest call {max(calls)} rows); {ms:.3f} ms by CUDA events, "
                  f"{ms / batch:.3f} ms per op; host {host_s:.3f} s; peak device memory "
                  f"{peak_mb:.1f} MB ({held_mb:.1f} MB held before); launches "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
            if right != batch:
                raise AssertionError(f"{label}: {right}/{batch} decrypt right")
            if label in ("uint32_add", "uint32_div"):
                kept[label] = (fn, args)
            del out, args
    finally:
        shortint.ServerKey.apply_lookup_table = orig_apply

    # each spied op's largest call, its first and last 8 rows against the
    # plain CPU path on those rows alone (rows are independent): K1 on the
    # classic key, K3 and the GROUP_3 keyswitch on the multi-bit one
    for label, ends in spied.items():
        t0 = time.perf_counter()
        small = shortint.Ciphertext(lwe=LweCiphertext(data=ends["data"]), degree=15)
        ref = _cpu_server(ends["key"]).apply_lookup_table(
            small, LookupTable(acc=GlweCiphertext(data=ends["luts"])))
        same = torch.equal(ref.lwe.data, ends["out"])
        print(f"{tag} integer {label}'s largest call ({ends['rows']} rows), its first and last "
              f"8 rows: card path {'bit-identical' if same else 'MISMATCH'} to the plain CPU "
              f"path on those rows alone ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not same:
            raise AssertionError(f"{label}'s largest call disagrees with the plain CPU path")
    del spied

    # one FheUint8 mul, batch 4, against the plain path on the same keys and
    # ciphertexts: the CPU path's code, every wrapper taking its plain
    # version, on the card's tensors (on CPU tensors its 8 calls took 304 s
    # of an H100 machine's 8-core host, PERF.md section 4)
    t0 = time.perf_counter()
    ck, sk = keys[(CLASSIC, 4)]
    vals = ints(256, 8)
    ca, cb = ck.encrypt(vals[:4], seed=seed + 46), ck.encrypt(vals[4:], seed=seed + 47)
    card = sk.mul(ca, cb)
    zero_counts()
    with plain_kernels():
        ref = sk.mul(ca, cb)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"the plain path launched kernels: {read_counts()}")
    same = all(torch.equal(r.lwe.data, c.lwe.data) and
               (r.degree, r.noise_level) == (c.degree, c.noise_level)
               for r, c in zip(ref.blocks, card.blocks))
    print(f"integer uint8_mul, batch 4: every block of the card path "
          f"{'bit-identical' if same else 'MISMATCH'} to the plain path (no kernel launched), "
          f"degrees and noise levels equal ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("the FheUint8 mul disagrees with the plain path")

    # one FheUint32 add and one FheUint32 div under the profiler: the idle
    # share and device time by kernel
    traces = {}
    for label, (fn, args) in kept.items():
        wall_ms, by_kernel, timeline = profile_window(lambda: fn(*args), warm=False, cpu=False)
        busy = print_profile(f"{tag} profiler, one integer {label} call "
                             f"(batch {args[0].batch_shape[0]})", wall_ms, by_kernel, timeline)
        if not busy:
            raise AssertionError(f"the {label} trace shows no device time")
        excl = exclusive_ms(timeline)
        k1 = sum(v for k, v in excl.items() if "delta_kernel" in k)
        ks = sum(v for k, v in excl.items() if "tensor_core_kernel" in k or "decompose" in k)
        traces[label] = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                         "k1_ms": k1, "keyswitch_ms": ks, "kernels": len(timeline)}
        print(f"{tag} integer {label} trace: {len(timeline)} kernels, K1 {k1:.3f} ms "
              f"({k1 / busy:.1%} of busy), the pass and K2' {ks:.3f} ms, the rest "
              f"{busy - k1 - ks:.3f} ms")
    del kept, keys
    torch.cuda.empty_cache()
    print(f"{tag} integer path, per op: op | blocks | batch | KS+PBS calls | PBS per op | "
          f"ms per op | peak MB | tfhe-rs CPU ms per op (BASELINE.md)")
    for r in ops:
        of = f" ({r['baseline_cpu_of']}, a stand-in)" if r["baseline_cpu_of"] else ""
        print(f"    {r['op']} | {r['blocks']} | {r['batch']} | {r['calls']} | "
              f"{r['pbs_per_op']:.1f} | {r['ms_per_op']:.3f} | {r['peak_mb']:.1f} | "
              f"{r['baseline_cpu_ms']}{of}")
    print(json.dumps({"integer": ops, "traces": traces}))
    return {"launches": totals, "ops": ops}


def k7_mults(batch, P, J, R, n) -> int:
    """K7 (csrc/external_product.cu): per row and prime the J forward and R
    inverse transforms (Shoup, 3 a butterfly), the J R N products with a
    Barrett reduction (7: the 64-bit product, the high multiply, the
    quotient's product), R N sum reductions and the N^-1 multiply (3); then
    Garner."""
    per_prime = J * ntt_mults(n) + R * ntt_mults(n) + 7 * J * R * n + 7 * R * n + 3 * R * n
    return batch * (P * per_prime + R * n * garner_mults(P))


def kspbs_launches(params, counts: dict) -> dict:
    """The launches of one classic KS+PBS call at `params`: one decomposition
    pass and one K2', then K1 where a ciphertext's rotation fits one block,
    else K6's cluster step once a step (the shape rule, `rotation._rotation_route`)."""
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes
    from tfhe_tpu_torch.core.poly import rotation
    N, R = params.polynomial_size, params.glwe_dimension + 1
    P = external_product_num_primes(N, R, params.pbs_decomp)
    want = {k: 0 for k in counts}
    want.update({"keyswitch_tc": 1, "keyswitch_decompose": 1})
    if rotation._rotation_route(N, R, params.pbs_level * R, P) == "block":
        want["blind_rotate"] = 1
    else:
        want["blind_rotate_cluster_step"] = params.lwe_dimension
    return want


def _timed(fn, dev) -> tuple:
    """(fn's result, its milliseconds by CUDA events, the peak device memory
    it allocated above what was held before it, in MB)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), (torch.cuda.max_memory_allocated(dev) - held) / 1e6


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def key_flow_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4i: the client-server key flow on the card.  At KEY_FLOW_SHORTINT:
    a client key on the card, gen_compressed_server_key (bytes on the wire
    against the standard-domain key), save to a tfhe_tpu-v1 file, safe_load
    on the card, decompress() timed by CUDA events; the decompressed
    standard BSK and KSK bit-identical to the full keys the same streams
    generate, and their first and last KEY_FLOW_ENDS input bits and
    KEY_FLOW_KSK_ROWS rows, decompressed on the CPU from the same file,
    bit-identical to the card's; 512 encrypt_compressed ciphertexts
    decompressed on the card through one KS+PBS (launches counted: one
    pass, one K2', one K1), decrypted 512/512 and bit-identical to the call
    on the full key.  At KEY_FLOW_BOOL: the compressed boolean server key
    through the same file round trip and holds, a public key, 2 x 512
    public-key encryptions (one K2' each, the subset sum), one AND at batch
    512 (one pass, one K2', one K1) decrypted 512/512, and the encryptions'
    first and last 8 rows against the plain CPU path.  At KEY_FLOW_44: the
    compressed key decompressed on the card (time and peak memory); the
    first and last input bits and KEY_FLOW_KSK_ROWS KSK rows, decompressed
    on the CPU, bit-identical to the key in service (its spectra there, its
    KSK rows), to the standard BSK decompressed again and to the bits
    decompressed alone; one KS+PBS at KEY_FLOW_44_BATCH decrypted right.  → {"launches": {kernel: n},
    "sets": [one dict a set]}."""
    from tfhe_tpu_torch import boolean as Bo
    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.core import rng, threefry
    from tfhe_tpu_torch.core.algorithms import (bootstrap_key_to_ntt,
                                                external_product_num_primes, seeded)
    from tfhe_tpu_torch.core.algorithms.encryption import (generate_bootstrap_key_from_key,
                                                           generate_keyswitch_key_from_key)
    from tfhe_tpu_torch.core.algorithms.public_key import LwePublicKey
    from tfhe_tpu_torch.core.params import boolean_params, shortint_params
    from tfhe_tpu_torch.utils import serialization

    totals, rows = {}, []

    def count(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def ends(n, k):
        return torch.cat([torch.arange(k), torch.arange(n - k, n)])

    def compressed_holds(label, csk, p, full_gens, tmp):
        """The file round trip of a compressed server key, decompress() on
        the card, and the holds against the full keys and the CPU."""
        bsk_b, ksk_b = csk.seeded_bsk.bodies, csk.seeded_ksk.bodies
        n, L, R, N = bsk_b.shape
        n_in, Lk = ksk_b.shape
        wire = _nbytes(bsk_b, ksk_b)
        standard = (n * L * R * R * N + n_in * Lk * (csk.seeded_ksk.output_lwe_dimension + 1)) * 8
        path = os.path.join(tmp, f"{label}.npz")
        t0 = time.perf_counter()
        serialization.save(csk, path, compress=False)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = serialization.safe_load(path, expected_type="CompressedServerKey",
                                         size_limit=wire + (1 << 20), device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        sk, ms, peak = _timed(loaded.decompress, dev)
        bsk_std, masks_ms, _ = _timed(lambda: seeded.decompress_bootstrap_key(loaded.seeded_bsk),
                                      dev)
        ksk, ksk_ms, _ = _timed(lambda: seeded.decompress_keyswitch_key(loaded.seeded_ksk), dev)
        full_bsk, full_ksk = full_gens()
        exact = (torch.equal(bsk_std.data, full_bsk.data) and torch.equal(ksk.data, full_ksk.data)
                 and torch.equal(sk.ksk.data, full_ksk.data))
        t0 = time.perf_counter()
        cpu = serialization.safe_load(path, device="cpu")
        bits = ends(n, KEY_FLOW_ENDS)
        cpu_bits = seeded.decompress_bootstrap_key(cpu.seeded_bsk, bits=bits).data
        held = torch.equal(cpu_bits, bsk_std.data[bits.to(dev)].cpu())
        for r0 in (0, n_in - KEY_FLOW_KSK_ROWS):
            part = seeded.decompress_keyswitch_key(cpu.seeded_ksk,
                                                   rows=(r0, r0 + KEY_FLOW_KSK_ROWS))
            held = held and torch.equal(part.data, ksk.data[r0:r0 + KEY_FLOW_KSK_ROWS].cpu())
        cpu_s = time.perf_counter() - t0
        print(f"{tag} key flow {label}: compressed server key {wire / 1e6:.1f} MB on the wire "
              f"against {standard / 1e6:.1f} MB of standard-domain key "
              f"({standard / wire:.2f}x); file {os.path.getsize(path) / 1e6:.1f} MB, save "
              f"{save_s:.2f} s, safe_load onto the card {load_s:.2f} s; decompress() "
              f"{ms:.3f} ms by CUDA events (peak {peak:.1f} MB above what was held), of which "
              f"the BSK's masks and standard key {masks_ms:.3f} ms and the KSK with its limbs "
              f"{ksk_ms:.3f} ms (timed again alone); the decompressed BSK and KSK "
              f"{'bit-identical' if exact else 'MISMATCH'} to the full keys of the same "
              f"streams; input bits {bits.tolist()[:2]}..{bits.tolist()[-2:]} and "
              f"{KEY_FLOW_KSK_ROWS} KSK rows at each end decompressed on the CPU from the file "
              f"{'bit-identical' if held else 'MISMATCH'} to the card's ({cpu_s:.1f} s)",
              flush=True)
        if not (exact and held):
            raise AssertionError(f"{label}: decompression exact {exact}, CPU slices held {held}")
        del bsk_std, ksk, full_bsk, full_ksk
        return sk, {"wire_mb": wire / 1e6, "standard_mb": standard / 1e6,
                    "file_mb": os.path.getsize(path) / 1e6, "save_s": save_s,
                    "load_s": load_s, "decompress_ms": ms, "decompress_peak_mb": peak,
                    "bsk_std_ms": masks_ms, "ksk_ms": ksk_ms, "cpu_hold_s": cpu_s}

    with tempfile.TemporaryDirectory() as tmp:
        # ---- shortint at KEY_FLOW_SHORTINT ----------------------------------
        p = shortint_params(KEY_FLOW_SHORTINT)
        ck = shortint.gen_client_key(p, seed, dev)
        csk, gen_ms, _ = _timed(lambda: shortint.gen_compressed_server_key(ck, seed), dev)

        def shortint_full():
            # the streams of gen_compressed_server_key (shortint/server_key.py)
            return (generate_bootstrap_key_from_key(
                threefry.key_from_seed(2 * seed + 1, dev), rng.generator(seed, 5, device=dev),
                ck.lwe_sk, ck.glwe_sk, p.pbs_decomp, p.glwe_noise_std),
                generate_keyswitch_key_from_key(
                    threefry.key_from_seed(2 * seed + 2, dev), rng.generator(seed, 6, device=dev),
                    ck.big_sk, ck.lwe_sk, p.ks_decomp, p.lwe_noise_std))
        sk, row = compressed_holds("2_2", csk, p, shortint_full, tmp)
        del csk
        mm = p.message_modulus
        m = torch.randint(0, mm, (B,), generator=torch.Generator().manual_seed(seed))
        cct = ck.encrypt_compressed(m.to(dev), seed=seed + 40)
        ct, enc_ms, _ = _timed(cct.decompress, dev)
        f = lambda x: (3 * x + 1) % mm
        lut = sk.generate_lookup_table(f)
        zero_counts()
        out = sk.apply_lookup_table(ct, lut)
        torch.cuda.synchronize()
        counts = read_counts()
        want = kspbs_launches(p, counts)
        if counts != want:
            raise AssertionError(f"key flow 2_2: launches {counts}, expected {want}")
        count(counts)
        right = int((ck.decrypt(out).cpu() == f(m)).sum())
        fb, fk = shortint_full()
        npr = external_product_num_primes(p.polynomial_size, p.glwe_size, p.pbs_decomp)
        full_sk = shortint.ServerKey(ksk=fk, bsk=bootstrap_key_to_ntt(fb, npr), params=p)
        del fb
        same = torch.equal(out.lwe.data, full_sk.apply_lookup_table(ct, lut).lwe.data)
        kspbs_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 3)
        print(f"{tag} key flow 2_2: gen_compressed_server_key on the card {gen_ms:.1f} ms; "
              f"{B} encrypt_compressed ciphertexts ({_nbytes(cct.ct.body)} B of bodies) "
              f"decompressed on the card in {enc_ms:.3f} ms; one KS+PBS on the decompressed "
              f"key: {right}/{B} decrypt right, launches {json.dumps(counts)}, output "
              f"{'bit-identical' if same else 'MISMATCH'} to the same call on the full key; "
              f"KS+PBS {kspbs_ms:.3f} ms at batch {B} (decompress() "
              f"{row['decompress_ms'] / kspbs_ms:.2f}x of it)", flush=True)
        if right != B or not same:
            raise AssertionError(f"key flow 2_2: {right}/{B} right, same as the full key {same}")
        rows.append({"set": KEY_FLOW_SHORTINT, "gen_ms": gen_ms, **row,
                     "ct_decompress_ms": enc_ms, "right": right, "kspbs_ms": kspbs_ms,
                     "launches": counts})
        del ck, sk, full_sk, cct, ct, out, lut
        torch.cuda.empty_cache()

        # ---- boolean at KEY_FLOW_BOOL ---------------------------------------
        bp = boolean_params(KEY_FLOW_BOOL)
        bck = Bo.gen_client_key(bp, seed, dev)
        bcsk, gen_ms, _ = _timed(lambda: Bo.gen_compressed_server_key(bck, seed), dev)

        def boolean_full():
            # the streams of boolean.gen_compressed_server_key
            return (generate_bootstrap_key_from_key(
                threefry.key_from_seed(2 * seed + 0xB001, dev),
                rng.generator(seed, 0xB0, 5, device=dev), bck.lwe_sk, bck.glwe_sk,
                bp.pbs_decomp, bp.glwe_noise_std),
                generate_keyswitch_key_from_key(
                    threefry.key_from_seed(2 * seed + 0xB002, dev),
                    rng.generator(seed, 0xB0, 6, device=dev), bck.glwe_sk.as_lwe_secret_key(),
                    bck.lwe_sk, bp.ks_decomp, bp.lwe_noise_std))
        bsk, brow = compressed_holds("boolean", bcsk, bp, boolean_full, tmp)
        del bcsk
        pk, pk_ms, _ = _timed(lambda: Bo.gen_public_key(bck, seed=seed), dev)
        path = os.path.join(tmp, "pk.npz")
        serialization.save(pk, path, compress=False)
        pk = serialization.safe_load(path, expected_type="PublicKey", device=dev)
        mb = torch.randint(0, 2, (2, B), generator=torch.Generator().manual_seed(seed)).bool()
        encs, enc_ms = [], []
        for i in range(2):
            zero_counts()
            ct, ms, _ = _timed(lambda: Bo.encrypt_with_public_key(pk, mb[i].to(dev),
                                                                  seed=seed + 50 + i), dev)
            counts = read_counts()
            want = {k: 0 for k in counts}
            want["keyswitch_tc"] = 1
            if counts != want:
                raise AssertionError(f"public-key encryption: launches {counts}, expected {want}")
            count(counts)
            encs.append(ct)
            enc_ms.append(ms)
        enc_right = sum(int((Bo.decrypt(bck, c).cpu() == mb[i]).sum())
                        for i, c in enumerate(encs))
        zero_counts()
        out = Bo.and_(bsk, encs[0], encs[1])
        torch.cuda.synchronize()
        counts = read_counts()
        want = kspbs_launches(bp, counts)
        if counts != want:
            raise AssertionError(f"key flow AND: launches {counts}, expected {want}")
        count(counts)
        and_right = int((Bo.decrypt(bck, out).cpu() == (mb[0] & mb[1])).sum())
        t0 = time.perf_counter()
        cpu_pk = Bo.PublicKey(pk=LwePublicKey(data=pk.pk.data.cpu()), params=bp)
        ref = Bo.encrypt_with_public_key(cpu_pk, mb[0], seed=seed + 50)
        pk_held = torch.equal(_ends(ref.lwe.data), _ends(encs[0].lwe.data))
        cpu_s = time.perf_counter() - t0
        print(f"{tag} key flow boolean {KEY_FLOW_BOOL}: gen_compressed_server_key on the card "
              f"{gen_ms:.1f} ms; public key ({pk.pk.zero_encryption_count} encryptions of zero, "
              f"{_nbytes(pk.pk.data) / 1e6:.1f} MB) {pk_ms:.1f} ms, through a file; {B} "
              f"public-key encryptions {enc_ms[0]:.3f} and {enc_ms[1]:.3f} ms (one K2' each), "
              f"{enc_right}/{2 * B} decrypt right; AND at batch {B} on the decompressed key: "
              f"{and_right}/{B} right, launches {json.dumps(counts)}; the first and last 8 rows "
              f"of the encryptions {'bit-identical' if pk_held else 'MISMATCH'} to the plain CPU "
              f"path ({cpu_s:.1f} s)", flush=True)
        if enc_right != 2 * B or and_right != B or not pk_held:
            raise AssertionError(f"key flow boolean: encryptions {enc_right}/{2 * B}, AND "
                                 f"{and_right}/{B}, rows held {pk_held}")
        rows.append({"set": KEY_FLOW_BOOL, "gen_ms": gen_ms, **brow, "pk_ms": pk_ms,
                     "pk_encrypt_ms": enc_ms, "right": enc_right + and_right,
                     "launches": counts})
        del bck, bsk, pk, encs, out
        torch.cuda.empty_cache()

    # ---- the 4_4 compressed key decompressed on the card --------------------
    p = shortint_params(KEY_FLOW_44)
    ck = shortint.gen_client_key(p, seed, dev)
    csk, gen_ms, gen_peak = _timed(lambda: shortint.gen_compressed_server_key(ck, seed), dev)
    wire = _nbytes(csk.seeded_bsk.bodies, csk.seeded_ksk.bodies)
    n_in = csk.seeded_ksk.bodies.shape[0]
    bits, dbits = ends(p.lwe_dimension, 1), ends(p.lwe_dimension, 1).to(dev)
    part, part_ms, _ = _timed(lambda: seeded.decompress_bootstrap_key(csk.seeded_bsk,
                                                                     bits=dbits), dev)
    # the CPU's slices of the same bodies: the end bits' GGSWs, the end KSK rows
    t0 = time.perf_counter()
    cpu_part = seeded.decompress_bootstrap_key(
        dataclasses.replace(csk.seeded_bsk, bodies=csk.seeded_bsk.bodies.cpu()), bits=bits)
    cpu_ksk = dataclasses.replace(csk.seeded_ksk, bodies=csk.seeded_ksk.bodies.cpu())
    ksk_ends = [(r0, seeded.decompress_keyswitch_key(
        cpu_ksk, rows=(r0, r0 + KEY_FLOW_KSK_ROWS)).data)
        for r0 in (0, n_in - KEY_FLOW_KSK_ROWS)]
    cpu_s = time.perf_counter() - t0
    held = {"bits alone": torch.equal(cpu_part.data, part.data.cpu())}
    del part
    sk, ms, peak = _timed(csk.decompress, dev)
    # the key in service: its spectra at the end bits and its end KSK rows
    npr = external_product_num_primes(p.polynomial_size, p.glwe_size, p.pbs_decomp)
    spectra = bootstrap_key_to_ntt(dataclasses.replace(cpu_part, data=cpu_part.data.to(dev)),
                                   npr).spectra
    held["BSK spectra in service"] = torch.equal(spectra, sk.bsk.spectra[dbits])
    held["KSK rows in service"] = all(
        torch.equal(rows_, sk.ksk.data[r0:r0 + KEY_FLOW_KSK_ROWS].cpu())
        for r0, rows_ in ksk_ends)
    del spectra
    # the mask regeneration alone, timed again: the standard BSK, the KSK with its limbs
    bsk_std, bsk_ms, _ = _timed(lambda: seeded.decompress_bootstrap_key(csk.seeded_bsk), dev)
    held["standard BSK bits"] = torch.equal(bsk_std.data[dbits].cpu(), cpu_part.data)
    del bsk_std, cpu_part
    ksk, ksk_ms, _ = _timed(lambda: seeded.decompress_keyswitch_key(csk.seeded_ksk), dev)
    held["KSK alone"] = torch.equal(ksk.data, sk.ksk.data)
    del ksk
    m = torch.randint(0, p.message_modulus, (KEY_FLOW_44_BATCH,),
                      generator=torch.Generator().manual_seed(seed))
    ct = ck.encrypt_compressed(m.to(dev), seed=seed + 44).decompress()
    f = lambda x: (3 * x + 1) % p.message_modulus
    lut = sk.generate_lookup_table(f)
    zero_counts()
    out, kspbs_ms, _ = _timed(lambda: sk.apply_lookup_table(ct, lut), dev)
    counts = read_counts()
    want = kspbs_launches(p, counts)
    if counts != want:
        raise AssertionError(f"key flow 4_4: launches {counts}, expected {want}")
    count(counts)
    right = int((ck.decrypt(out).cpu() == f(m)).sum())
    print(f"{tag} key flow 4_4: gen_compressed_server_key on the card {gen_ms:.1f} ms (peak "
          f"{gen_peak:.1f} MB); {wire / 1e6:.1f} MB on the wire; decompress() on the card "
          f"{ms:.3f} ms by CUDA events, peak {peak:.1f} MB above what was held (spectra "
          f"{_nbytes(sk.bsk.spectra) / 1e9:.2f} GB, keyswitching key and limbs "
          f"{_nbytes(sk.ksk.data, sk.ksk.limbs) / 1e9:.2f} GB); timed again alone, the "
          f"BSK's masks and standard key {bsk_ms:.3f} ms, the KSK with its limbs "
          f"{ksk_ms:.3f} ms (the same words as decompress()'s); input bits {bits.tolist()} "
          f"decompressed alone on the card in {part_ms:.3f} ms; against the CPU's input bits "
          f"{bits.tolist()} and {KEY_FLOW_KSK_ROWS} KSK rows at each end ({cpu_s:.1f} s): "
          f"{json.dumps(held)}; one KS+PBS at batch {KEY_FLOW_44_BATCH}: "
          f"{right}/{KEY_FLOW_44_BATCH} right, {kspbs_ms:.1f} ms, launches "
          f"{json.dumps(counts)}", flush=True)
    if not all(held.values()) or right != KEY_FLOW_44_BATCH:
        raise AssertionError(f"key flow 4_4: held {held}, {right}/{KEY_FLOW_44_BATCH} right")
    rows.append({"set": KEY_FLOW_44, "gen_ms": gen_ms, "gen_peak_mb": gen_peak,
                 "wire_mb": wire / 1e6, "decompress_ms": ms, "decompress_peak_mb": peak,
                 "bsk_std_ms": bsk_ms, "ksk_ms": ksk_ms, "bits_ms": part_ms,
                 "cpu_hold_s": cpu_s, "kspbs_ms": kspbs_ms, "batch": KEY_FLOW_44_BATCH,
                 "right": right, "launches": counts})
    del ck, csk, sk, ct, out, lut
    torch.cuda.empty_cache()
    return {"launches": totals, "sets": rows}


def _launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def hlapi_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4j: the high-level API at HL_SET on the card.  generate_keys;
    FheUint8 at HL_BATCH through every operator of `_FheUintBase` (a clear
    operand where the operator takes one), the FheBool gates, `select`,
    `cast_into`, `overflowing_add` / `overflowing_sub`; FheUint32 add, mul,
    gt, scalar shl and //, FheUint64 add and mul, FheInt32 <, scalar // and
    %, abs, FheUint128 add and == at HL_WIDE_BATCH.  Each with the counts at
    0 just before and read just after (K1, the pass and K2' once per KS+PBS
    call, nothing else), timed by CUDA events, decrypted against its clear
    model; five ops also on the integer layer (`ServerKey.radix`) just
    after, timed, their launches held equal.  Then PublicKey and
    CompactPublicKey encryptions (HL_HELD rows against the plain CPU path
    on the same key and seed: the public key's bit for bit, the compact
    key's within the two generators' noise), a CompressedFheUint
    decompressed (against the CPU's decompression of the same blocks) and
    a CompressedServerKey decompressed and serving an add.
    → {"launches": {...}, "ops": [...], "encryptions": {...}}."""
    import numpy as np

    from tfhe_tpu_torch import hlapi as H
    from tfhe_tpu_torch.core.algorithms import public_key as PK
    from tfhe_tpu_torch.core.algorithms import seeded

    rng = np.random.default_rng(seed + 4)
    totals, ops = {}, []
    ev = lambda: torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ck, sk = H.generate_keys(H.ConfigBuilder().use_custom_parameters(HL_SET).build(),
                             seed=seed, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    H.set_server_key(sk)
    isk = sk.radix

    def timed_counts(fn):
        zero_counts()
        start, stop = ev(), ev()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop), read_counts()

    def measured(label, batch, fn, clear, twin=None):
        """fn's result decrypted against clear, its launches one K1, pass and
        K2' a KS+PBS call (none for a whole-block shift or an FheUint's
        abs); with twin, the same op on the integer layer beside it."""
        out, ms, counts = timed_counts(fn)
        got = [bool(v) if isinstance(v, (bool, np.bool_)) else int(v)
               for v in np.asarray(out.decrypt(ck)).reshape(-1)] if not isinstance(out, tuple) \
            else [tuple(bool(x) if isinstance(x, (bool, np.bool_)) else int(x) for x in row)
                  for row in zip(*(np.asarray(o.decrypt(ck)).reshape(-1) for o in out))]
        if got != clear:
            raise AssertionError(f"hlapi {label}: {got[:4]} ..., expected {clear[:4]} ...")
        kspbs = counts["blind_rotate"]
        want = {k: 0 for k in counts}
        want.update(blind_rotate=kspbs, keyswitch_tc=kspbs, keyswitch_decompose=kspbs)
        if counts != want:
            raise AssertionError(f"hlapi {label}: launches {counts}, expected one K1, pass and "
                                 f"K2' a KS+PBS call")
        row = {"op": label, "batch": batch, "ms": ms, "ms_per_op": ms / batch,
               "kspbs_calls": kspbs}
        if twin is not None:
            _, tms, tcounts = timed_counts(twin)
            if tcounts != counts:
                raise AssertionError(f"hlapi {label}: launches {counts}, the integer layer's "
                                     f"{tcounts}")
            row.update(integer_ms=tms, integer_ms_per_op=tms / batch, ratio=ms / tms)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        ops.append(row)
        print(f"{tag} hlapi {label} batch {batch}: {ms:.3f} ms ({ms / batch:.4f} ms per op), "
              f"{kspbs} KS+PBS calls" + (f"; integer layer {row['integer_ms']:.3f} ms "
                                         f"(ratio {row['ratio']:.3f})" if twin else ""),
              flush=True)
        return out

    # ---- FheUint8 at HL_BATCH: every operator --------------------------------
    B8 = HL_BATCH
    a = [int(v) for v in rng.integers(0, 256, B8)]
    b = [int(v) for v in rng.integers(0, 256, B8)]
    s = [int(v) for v in rng.integers(0, 8, B8)]
    x, y = H.FheUint8.encrypt(a, ck, seed=seed + 1), H.FheUint8.encrypt(b, ck, seed=seed + 2)
    z = H.FheUint8.encrypt(s, ck, seed=seed + 3)
    u8 = lambda v: v % 256
    rotl = lambda v, r: u8((v << r) | (v >> (8 - r))) if r else v
    rotr = lambda v, r: u8((v >> r) | (v << (8 - r))) if r else v
    pairs = list(zip(a, b))
    cases = [
        ("+", lambda: x + y, [u8(p + q) for p, q in pairs], lambda: isk.add(x.ct, y.ct)),
        ("+ 7", lambda: x + 7, [u8(p + 7) for p in a], None),
        ("-", lambda: x - y, [u8(p - q) for p, q in pairs], None),
        ("200 -", lambda: 200 - x, [u8(200 - p) for p in a], None),
        ("*", lambda: x * y, [u8(p * q) for p, q in pairs], lambda: isk.mul(x.ct, y.ct)),
        ("* 3", lambda: x * 3, [u8(3 * p) for p in a], None),
        ("neg", lambda: -x, [u8(-p) for p in a], None),
        ("&", lambda: x & y, [p & q for p, q in pairs], None),
        ("| 0x5A", lambda: x | 0x5A, [p | 0x5A for p in a], None),
        ("^", lambda: x ^ y, [p ^ q for p, q in pairs], None),
        ("~", lambda: ~x, [u8(~p) for p in a], None),
        ("<<", lambda: x << z, [u8(p << r) for p, r in zip(a, s)], None),
        (">>", lambda: x >> z, [p >> r for p, r in zip(a, s)], None),
        ("<< 3", lambda: x << 3, [u8(p << 3) for p in a], None),
        (">> 2", lambda: x >> 2, [p >> 2 for p in a], None),
        ("rotate_left", lambda: x.rotate_left(z), [rotl(p, r) for p, r in zip(a, s)], None),
        ("rotate_right 3", lambda: x.rotate_right(3), [rotr(p, 3) for p in a], None),
        ("//", lambda: x // y, [p // q if q else 255 for p, q in pairs],
         lambda: isk.div(x.ct, y.ct)),
        ("%", lambda: x % y, [p % q if q else p for p, q in pairs], None),
        ("// 7", lambda: x // 7, [p // 7 for p in a], None),
        ("% 7", lambda: x % 7, [p % 7 for p in a], None),
        ("==", lambda: x == y, [p == q for p, q in pairs], lambda: isk.eq(x.ct, y.ct)),
        ("!= 9", lambda: x != 9, [p != 9 for p in a], None),
        ("<", lambda: x < y, [p < q for p, q in pairs], None),
        ("<=", lambda: x <= y, [p <= q for p, q in pairs], None),
        (">", lambda: x > y, [p > q for p, q in pairs], lambda: isk.gt(x.ct, y.ct)),
        (">= 100", lambda: x >= 100, [p >= 100 for p in a], None),
        ("min", lambda: x.min(y), [min(p, q) for p, q in pairs], None),
        ("max 128", lambda: x.max(128), [max(p, 128) for p in a], None),
        ("overflowing_add", lambda: x.overflowing_add(y),
         [(u8(p + q), p + q > 255) for p, q in pairs], None),
        ("overflowing_sub", lambda: x.overflowing_sub(y),
         [(u8(p - q), p < q) for p, q in pairs], None),
        ("cast_into FheUint16", lambda: x.cast_into(H.FheUint16), a, None),
        ("select", lambda: (x > y).select(x, y), [max(p, q) for p, q in pairs], None),
    ]
    x + y            # a warm call: the first KS+PBS calls of a key pay set-up
    torch.cuda.synchronize()
    for label, fn, clear, twin in cases:
        measured(f"FheUint8 {label}", B8, fn, clear, twin)
    measured("FheUint8 abs", B8, lambda: x.abs(), a)
    p_, q_ = x < y, x == y
    bp = [p < q for p, q in pairs]
    bq = [p == q for p, q in pairs]
    for label, fn, clear in (("FheBool &", lambda: p_ & q_, [i and j for i, j in zip(bp, bq)]),
                             ("FheBool |", lambda: p_ | q_, [i or j for i, j in zip(bp, bq)]),
                             ("FheBool ^", lambda: p_ ^ q_, [i != j for i, j in zip(bp, bq)]),
                             ("FheBool ~", lambda: ~p_, [not i for i in bp]),
                             ("FheBool eq", lambda: p_.eq(q_), [i == j for i, j in zip(bp, bq)])):
        measured(label, B8, fn, clear)
    del x, y, z, p_, q_

    # ---- the wider types at HL_WIDE_BATCH -----------------------------------
    Bw = HL_WIDE_BATCH
    wide = lambda bits: [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(Bw)]
    m32, m64, m128 = (1 << 32), (1 << 64), (1 << 128)
    a32, b32 = wide(32), [v or 1 for v in wide(32)]
    x32, y32 = H.FheUint32.encrypt(a32, ck, seed=seed + 10), H.FheUint32.encrypt(b32, ck,
                                                                                 seed=seed + 11)
    x32 + y32        # a warm call: the first op at a new width allocates its buffers
    torch.cuda.synchronize()
    measured("FheUint32 +", Bw, lambda: x32 + y32, [(p + q) % m32 for p, q in zip(a32, b32)],
             lambda: isk.add(x32.ct, y32.ct))
    measured("FheUint32 *", Bw, lambda: x32 * y32, [(p * q) % m32 for p, q in zip(a32, b32)])
    measured("FheUint32 >", Bw, lambda: x32 > y32, [p > q for p, q in zip(a32, b32)])
    measured("FheUint32 << 5", Bw, lambda: x32 << 5, [(p << 5) % m32 for p in a32])
    measured("FheUint32 //", Bw, lambda: x32 // y32, [p // q for p, q in zip(a32, b32)])
    del x32, y32
    a64, b64 = wide(64), wide(64)
    x64, y64 = H.FheUint64.encrypt(a64, ck, seed=seed + 12), H.FheUint64.encrypt(b64, ck,
                                                                                 seed=seed + 13)
    measured("FheUint64 +", Bw, lambda: x64 + y64, [(p + q) % m64 for p, q in zip(a64, b64)])
    measured("FheUint64 *", Bw, lambda: x64 * y64, [(p * q) % m64 for p, q in zip(a64, b64)])
    del x64, y64
    sa = [v - (1 << 31) for v in wide(32)]
    sb = [v - (1 << 31) for v in wide(32)]
    xs, ys = H.FheInt32.encrypt(sa, ck, seed=seed + 14), H.FheInt32.encrypt(sb, ck,
                                                                            seed=seed + 15)
    s32 = lambda v: (v + (1 << 31)) % m32 - (1 << 31)
    measured("FheInt32 <", Bw, lambda: xs < ys, [p < q for p, q in zip(sa, sb)])
    measured("FheInt32 // 7", Bw, lambda: xs // 7, [s32(int(p / 7)) for p in sa])
    measured("FheInt32 % 7", Bw, lambda: xs % 7, [p - 7 * int(p / 7) for p in sa])
    measured("FheInt32 abs", Bw, lambda: xs.abs(), [s32(abs(p)) for p in sa])
    del xs, ys
    a128, b128 = wide(128), wide(128)
    b128[0] = a128[0]
    x128 = H.FheUint128.encrypt(a128, ck, seed=seed + 16)
    y128 = H.FheUint128.encrypt(b128, ck, seed=seed + 17)
    measured("FheUint128 +", Bw, lambda: x128 + y128,
             [(p + q) % m128 for p, q in zip(a128, b128)])
    measured("FheUint128 ==", Bw, lambda: x128 == y128, [p == q for p, q in zip(a128, b128)])
    del x128, y128

    # ---- the encryptions ------------------------------------------------------
    cpu = torch.device("cpu")
    enc = {}
    pk = H.PublicKey(ck, seed=seed)
    vals = [int(v) for v in rng.integers(0, 256, B8)]
    zero_counts()
    ct, ms, counts = timed_counts(lambda: H.FheUint8.encrypt_with_public_key(vals, pk,
                                                                              seed=seed + 20))
    pk_cpu = H.PublicKey.__new__(H.PublicKey)
    pk_cpu.params, pk_cpu.pk = pk.params, PK.LwePublicKey(data=pk.pk.data.cpu())
    ref = H.FheUint8.encrypt_with_public_key(vals[:HL_HELD], pk_cpu, seed=seed + 20)
    held = all(torch.equal(t.lwe.data[:HL_HELD].cpu(), r.lwe.data)
               for t, r in zip(ct.ct.blocks, ref.ct.blocks))
    right = [int(v) for v in ct.decrypt(ck)] == vals
    enc["public_key"] = {"encrypt_ms": ms, "batch": B8, "launches": _launched(counts),
                         "cpu_rows_bit_identical": held, "right": right}
    if not (held and right and counts["keyswitch_tc"] == ct.ct.num_blocks):
        raise AssertionError(f"hlapi PublicKey: {enc['public_key']}")
    cpk = H.CompactPublicKey(ck, seed=seed)
    ct, ms, counts = timed_counts(lambda: H.FheUint8.encrypt_with_compact_public_key(
        vals, cpk, seed=seed + 21))
    cpk_cpu = H.CompactPublicKey.__new__(H.CompactPublicKey)
    cpk_cpu.params, cpk_cpu.pk = cpk.params, PK.LweCompactPublicKey(data=cpk.pk.data.cpu())
    ref = H.FheUint8.encrypt_with_compact_public_key(vals[:HL_HELD], cpk_cpu, seed=seed + 21)
    bound = 8 * math.sqrt(2) * cpk.params.glwe_noise_std
    worst = max(float((t.lwe.data[:HL_HELD].cpu() - r.lwe.data).abs().max())
                for t, r in zip(ct.ct.blocks, ref.ct.blocks))
    right = [int(v) for v in ct.decrypt(ck)] == vals
    enc["compact_public_key"] = {"encrypt_ms": ms, "batch": B8, "launches": _launched(counts),
                                 "cpu_rows_max_diff": worst, "noise_bound": bound,
                                 "right": right}
    if not (worst <= bound and right):
        raise AssertionError(f"hlapi CompactPublicKey: {enc['compact_public_key']}")
    cct = H.FheUint8.encrypt_compressed(vals, ck, seed=seed + 22)
    dec, ms, _ = timed_counts(cct.decompress)
    held = all(torch.equal(seeded.decompress_lwe(sb, cpu).data[:HL_HELD],
                           d.lwe.data[:HL_HELD].cpu())
               for sb, d in zip(cct.seeded_blocks, dec.ct.blocks))
    right = [int(v) for v in dec.decrypt(ck)] == vals
    enc["compressed_fheuint"] = {"decompress_ms": ms, "cpu_rows_bit_identical": held,
                                 "right": right}
    if not (held and right):
        raise AssertionError(f"hlapi CompressedFheUint: {enc['compressed_fheuint']}")
    csk = H.CompressedServerKey(ck, seed=seed)
    served, ms, _ = timed_counts(csk.decompress)
    H.set_server_key(served)
    xa, xb = H.FheUint8.encrypt(vals, ck, seed=seed + 23), H.FheUint8.encrypt(a, ck,
                                                                            seed=seed + 24)
    right = [int(v) for v in (xa + xb).decrypt(ck)] == [u8(p + q) for p, q in zip(vals, a)]
    enc["compressed_server_key"] = {"decompress_ms": ms, "add_right": right}
    H.set_server_key(sk)
    if not right:
        raise AssertionError("hlapi CompressedServerKey: the add on it decrypts wrong")
    print(f"{tag} hlapi encryptions: {json.dumps(enc)}; generate_keys {keygen_s:.2f} s")
    H.unset_server_key()
    del ck, sk, served, csk, pk, cpk
    torch.cuda.empty_cache()
    return {"launches": totals, "ops": ops, "encryptions": enc, "generate_keys_s": keygen_s}


def wopbs_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4k: the WoP-PBS on the card.  new_wopbs_key(ck, sk, "auto") on
    WOPBS_COMPUTE_SET keys (WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS at its
    published widths), WOPBS_BATCH ciphertexts over all 16 values through
    the identity and a non-linear LUT, each call with the counts at 0 just
    before and read just after (the launches reckoned from the parameters:
    K1 a PBS, the pass and K2' a keyswitch or a private functional
    keyswitch, K7 a CMux or rotation step, nothing else), timed
    by CUDA events, its peak device memory read, every output decrypted.
    From the first call, on WOPBS_HELD rows: K7 against its plain version
    on the call's own operands; a private functional keyswitch against the
    CPU (its row key and input rows copied there); one circuit-bootstrapped
    GGSW against the plain kernels on the card's tensors (`plain_kernels`).
    K7 timed alone on the call's operands beside its plain version, the
    pass and K2' alone at the private functional keyswitch's shape (digits
    of two byte limbs) beside their plain versions and bounds, and one call
    traced under torch.profiler.  Then
    new_wopbs_key_only_for_wopbs (the WoP-PBS set's cbs and pfks
    decompositions) through the non-linear LUT on keys of the WoP-PBS set,
    decrypted, and on the compute keys, where its decryption rate is
    recorded as a finding (the compute set's one-level PBS is too noisy for
    the circuit bootstrap), not held.
    → {"launches", "calls", "k7"}."""
    import numpy as np

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.core.algorithms import wopbs as W
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.poly import external_product as ep
    from tfhe_tpu_torch.shortint import wopbs as SW

    rng = np.random.default_rng(seed + 5)
    ck, sk = shortint.gen_keys(WOPBS_COMPUTE_SET, seed=seed, device=dev)
    t0 = time.perf_counter()
    comb = SW.new_wopbs_key(ck, sk, "auto", seed=seed)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    wp = comb.params
    bits = int(math.log2(wp.message_modulus * wp.carry_modulus))
    levels, rows = wp.cbs_level, wp.glwe_dimension + 1
    luts = max(1, (1 << bits) // wp.polynomial_size)
    tree = min(luts.bit_length() - 1, bits)
    want_calls = {"blind_rotate": 1 + (bits - 1) + bits * levels + 1,
                  "keyswitch": 1 + 1 + bits + 1, "pfks": bits * levels * rows,
                  "external_product": (luts - 1) + (bits - tree)}
    print(f"{tag} WoP-PBS: {wp.name} (n={wp.lwe_dimension}, N={wp.polynomial_size}, PBS "
          f"{wp.pbs_base_log}x{wp.pbs_level}, cbs {wp.cbs_base_log}x{wp.cbs_level}, pfks "
          f"{wp.pfks_base_log}x{wp.pfks_level}) keys in {keygen_s:.2f} s; a call reckoned: "
          f"{json.dumps(want_calls)}", flush=True)
    msgs = torch.as_tensor(rng.integers(0, 16, WOPBS_BATCH))
    ct = ck.unchecked_encrypt(msgs.to(dev), seed=seed + 1)
    spy = {}
    saved = (W.external_product, W.private_functional_keyswitch, SW.circuit_bootstrap_boolean)

    def first(name, fn, keep):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name not in spy:
                spy[name] = keep(args, kw, out)
            return out
        return call

    W.external_product = first("k7", saved[0], lambda a, kw, out: (a, kw, out))
    W.private_functional_keyswitch = first(
        "pfks", saved[1], lambda a, kw, out: (a[0].data.clone(), a[1], a[2],
                                              out.data[:WOPBS_HELD].clone()))
    SW.circuit_bootstrap_boolean = first(
        "cbs", saved[2], lambda a, kw, out: (a[1].data[:2].clone(), out.data[:2].clone()))
    calls = []
    try:
        for label, f in (("identity", lambda v: v), ("x^2 + 3 mod 16", lambda v: (v * v + 3) % 16)):
            lut = comb.generate_lut(f)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = comb.wopbs(sk, ct, lut)
            stop.record()
            torch.cuda.synchronize()
            counts = read_counts()
            peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e6
            want = {k: 0 for k in counts}
            want.update(blind_rotate=want_calls["blind_rotate"],
                        keyswitch_tc=want_calls["keyswitch"] + want_calls["pfks"],
                        keyswitch_decompose=want_calls["keyswitch"] + want_calls["pfks"],
                        external_product=want_calls["external_product"])
            if counts != want:
                raise AssertionError(f"WoP-PBS {label}: launches {counts}, reckoned {want}")
            got = ck.decrypt_message_and_carry(out).cpu()
            right = int((got == f(msgs)).sum())
            row = {"lut": label, "batch": WOPBS_BATCH, "ms": start.elapsed_time(stop),
                   "peak_mb": peak, "held_mb": held / 1e6, "right": right,
                   "launches": _launched(counts)}
            calls.append(row)
            print(f"{tag} WoP-PBS {label}: {row['ms']:.3f} ms a call at batch {WOPBS_BATCH} "
                  f"({row['ms'] / WOPBS_BATCH:.4f} ms a ciphertext), {right}/{WOPBS_BATCH} "
                  f"right, peak {peak:.1f} MB above {held / 1e6:.1f} MB held, launches "
                  f"{json.dumps(row['launches'])}", flush=True)
            if right != WOPBS_BATCH:
                raise AssertionError(f"WoP-PBS {label}: {right}/{WOPBS_BATCH} right")
    finally:
        W.external_product, W.private_functional_keyswitch, SW.circuit_bootstrap_boolean = saved

    # ---- the holds, on the first call's own operands -----------------------
    args, kw, k7_out = spy["k7"]
    ct0, spectra, decomp = args
    exps = kw.get("exps")
    ct1 = kw.get("ct1")
    sel = slice(0, WOPBS_HELD)
    plain = ep.external_product_plain(ct0, spectra[sel], decomp,
                                      ct1=None if ct1 is None else ct1[sel],
                                      exps=None if exps is None else exps[sel])
    k7_err = max_abs_err(k7_out[sel], plain)
    if k7_err:
        raise AssertionError(f"K7 differs from its plain version by {k7_err}")
    x_all, pf, row, pf_out = spy["pfks"]
    cpu_pf = W.CbsPfpkskList(data=pf.data[row:row + 1].cpu(), decomp=pf.decomp)
    pf_cpu = W.private_functional_keyswitch(LweCiphertext(data=x_all[sel].cpu()), cpu_pf, 0)
    pf_err = max_abs_err(pf_out.cpu(), pf_cpu.data)
    lwe_rows, ggsw_rows = spy["cbs"]
    inner = comb.wopbs_key
    with plain_kernels():
        ggsw_plain = W.circuit_bootstrap_boolean(inner.server_key.bsk,
                                                 LweCiphertext(data=lwe_rows), inner.pfpksk,
                                                 inner.cbs_decomp, 63)
    cbs_err = max_abs_err(ggsw_rows, ggsw_plain.data)
    print(f"{tag} WoP-PBS holds: K7 on {WOPBS_HELD} rows of the first call's operands "
          f"{k7_err}, the PFPKS (row key {row}) on {WOPBS_HELD} rows against the "
          f"CPU {pf_err}, one circuit-bootstrapped GGSW (2 rows) against the plain kernels "
          f"{cbs_err} (max abs err; 0 is bit-identical)", flush=True)
    if pf_err or cbs_err:
        raise AssertionError(f"WoP-PBS holds: PFPKS {pf_err}, GGSW {cbs_err}")

    # ---- K7 alone on the call's operands ------------------------------------
    launch = lambda: ep.external_product(ct0, spectra, decomp, ct1=ct1, exps=exps)
    launch()
    k7_ms = cuda_ms(launch, 10)
    k7_plain_ms = cuda_ms(lambda: ep.external_product_plain(ct0, spectra, decomp, ct1=ct1,
                                                            exps=exps), 2)
    Bk, (P, J, R, n) = spectra.shape[0], spectra.shape[-4:]
    k7_bytes = _nbytes(ct0, spectra, ct1, exps) + Bk * R * n * 8
    k7_shape = (f"WoP-PBS vertical packing at {wp.name}: batch {Bk}, N={n}, k+1={R}, "
                f"cbs {decomp.base_log}x{decomp.level} (J={J}), P={P}, a GGSW a row")
    print(f"{tag} K7 {k7_shape}: {k7_ms:.4f} ms, plain {k7_plain_ms:.3f} ms", flush=True)

    # ---- the pass and K2' alone at the private functional keyswitch's shape --
    from tfhe_tpu_torch.core.algorithms import keyswitch
    from tfhe_tpu_torch.core.decomposition import signed_decompose
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    Bp, base_log = x_all.shape[0], pf.decomp.base_log
    flat = pf.data[row].reshape(-1, pf.data.shape[-2] * pf.data.shape[-1])
    limbs, D = pf.limbs[row], keyswitch.digit_limbs(base_log)
    digits = keyswitch.decompose_digits(x_all, pf.decomp)
    zero = torch.zeros(Bp, dtype=torch.int64, device=dev)
    (K, Mp), Kp = flat.shape, limbs.shape[-1]
    res = {}
    pf_ms = cuda_ms(lambda: res.update(tc=keyswitch.neg_digit_mac_tensor_core(
        digits, flat, limbs, zero, base_log)), 10)
    pf_dec_ms = cuda_ms(lambda: keyswitch.decompose_digits(x_all, pf.decomp), 10)
    d64 = signed_decompose(x_all, pf.decomp).reshape(Bp, -1)
    pf_plain_ms = cuda_ms(lambda: res.update(plain=keyswitch.neg_digit_mac_plain(
        d64, flat, zero, chunk=16)), 1)
    pf_tc_err = hold(f"K2' at the PFPKS shape, batch {Bp}, {D} digit limbs", res["tc"],
                     res["plain"])
    pfks = {"shape": f"WoP-PBS private functional keyswitch at {wp.name} batch {Bp}, "
                     f"K={K}, M={Mp} (pfks {base_log}x{pf.decomp.level}, {D} digit limbs)",
            "ms": pf_ms, "plain_ms": pf_plain_ms, "dec_ms": pf_dec_ms, "err": pf_tc_err,
            "bound": tc_bound(Bp, K, Mp, Kp, clock_hz, sms, D),
            "cuda_core_bound": cuda_core_bound(Bp, K, Mp, clock_hz, sms),
            "int_mm_ms": int_mm_ms(Bp, D * Kp, 8 * Mp, dev)}
    mm = pfks["int_mm_ms"]
    print(f"{tag} K2' {pfks['shape']}: {pf_ms:.4f} ms (bound {pfks['bound'][0]:.4f} ms by "
          f"{pfks['bound'][1]}; the CUDA-core bound {pfks['cuda_core_bound'][0]:.4f}), pass "
          f"{pf_dec_ms:.4f} ms, plain {pf_plain_ms:.3f} ms; torch._int_mm [{Bp}, {D * Kp}] x "
          f"[{D * Kp}, {8 * Mp}] " + (f"{mm:.4f} ms" if mm is not None else "not measured"),
          flush=True)
    del digits, d64, flat, x_all, res

    # ---- one call traced: device time by kernel, the idle share --------------
    lut = comb.generate_lut(lambda v: v)
    wall_ms, by_kernel, timeline = profile_window(lambda: comb.wopbs(sk, ct, lut))
    busy = print_profile(f"{tag} profiler, one WoP-PBS call at batch {WOPBS_BATCH}", wall_ms,
                         by_kernel, timeline)
    if not busy:
        raise AssertionError("the WoP-PBS trace shows no device time")
    trace = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
             "by_kernel_ms": {k[:60]: v for k, v in sorted(
                 exclusive_ms(timeline).items(), key=lambda kv: -kv[1])[:6]}}
    print(f"{tag} WoP-PBS trace by kernel (exclusive ms): {json.dumps(trace['by_kernel_ms'])}",
          flush=True)

    # ---- the only-for-wopbs regime: one set for the PBS and the WoP-PBS -----
    # on keys of the WoP-PBS set, checked; on the compute keys, a finding:
    # there the PBS (one level of 23 bits) leaves its output noise above
    # the circuit bootstrap's finest levels, and it is recorded, not held
    f = lambda v: (v * v + 3) % 16
    only = {}
    for label, keys in (("WoP-PBS set keys", None), ("compute keys", (ck, sk))):
        if keys is None:
            keys = shortint.gen_keys(wp, seed=seed + 2, device=dev)
        kck, ksk_ = keys
        kct = ct if keys[0] is ck else kck.unchecked_encrypt(msgs.to(dev), seed=seed + 3)
        t0 = time.perf_counter()
        wk = SW.new_wopbs_key_only_for_wopbs(kck, ksk_, cbs_decomp=wp.cbs_decomp,
                                             pfks_decomp=wp.pfks_decomp, seed=seed)
        torch.cuda.synchronize()
        only_keygen_s = time.perf_counter() - t0
        zero_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = wk.wopbs(kct, wk.generate_lut(f))
        stop.record()
        torch.cuda.synchronize()
        counts = read_counts()
        right = int((kck.decrypt_message_and_carry(out).cpu() == f(msgs)).sum())
        only[label] = right
        calls.append({"lut": f"x^2 + 3 mod 16, new_wopbs_key_only_for_wopbs on {label} "
                      f"({kck.params.name})", "batch": WOPBS_BATCH,
                      "ms": start.elapsed_time(stop), "keygen_s": only_keygen_s, "right": right,
                      "launches": _launched(counts)})
        print(f"{tag} WoP-PBS only-for-wopbs on {label} ({kck.params.name}): "
              f"{calls[-1]['ms']:.3f} ms, {right}/{WOPBS_BATCH} right, launches "
              f"{json.dumps(calls[-1]['launches'])}", flush=True)
        del kck, ksk_, kct, wk, out
    if only["WoP-PBS set keys"] != WOPBS_BATCH:
        raise AssertionError(f"new_wopbs_key_only_for_wopbs on the WoP-PBS set's keys: "
                             f"{only['WoP-PBS set keys']}/{WOPBS_BATCH} right")
    print(f"{tag} finding: new_wopbs_key_only_for_wopbs on the {WOPBS_COMPUTE_SET} keys "
          f"decrypts {only['compute keys']}/{WOPBS_BATCH} right (not held: that regime needs "
          f"a WoP-PBS set's PBS)", flush=True)
    totals = {k: sum(c["launches"].get(k, 0) for c in calls) for k in read_counts()}
    del ck, sk, comb, ct, spy
    torch.cuda.empty_cache()
    return {"launches": totals, "calls": calls, "keygen_s": keygen_s, "trace": trace,
            "pfks": pfks,
            "k7": {"err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms, "bytes": k7_bytes,
                   "shape": k7_shape, "mults": k7_mults(Bk, P, J, R, n)}}


def gadget_path(seed: int, dev, tag: str, zero_counts, read_counts, bool_and_ms: dict) -> dict:
    """Phase 4l: the gadget fork on the card, on the port's own keys
    (`gadget.gen_keys` on the card) at two named gadget sets.

    At GADGET_GATE_SET (PBS -> KS; the boolean DEFAULT_PARAMETERS' shapes):
    the four 2-input gates and the 3-input majority (`Gadget.new_canonical`,
    p = 5 and 7) at each of GADGET_GATE_BATCHES on random bits, each call
    with the counts at 0 just before and read just after (one K1, one pass,
    one K2', nothing else), every row decrypted against the clear model, then
    timed by CUDA events beside phase 4f's boolean AND (`bool_and_ms`).

    At GADGET_OP_SET (KS -> PBS, J = 16) on GADGET_BATCH ciphertexts:
    `apply_lut`, `mvb` with three outputs, `simple_tree_bootstrapping` and
    `full_tree_bootstrapping` (o = 3, p = 7), `lwe_mult` (p = 16) and
    `woppbs_lut` (o = 16 in Z_17), each called once to time its first call
    (host tables for new shapes), then once with its launches counted
    against the reckoning (K7 once a rotation step for MVB's common factor,
    the pass and K2' once a keyswitch or packing keyswitch call, K1 once a
    PBS), timed by CUDA events, its decrypted rows counted.  An op that
    decrypts fewer than all its rows is printed as a finding, not held.

    Holds, bit for bit against the plain versions on the card's tensors:
    K7 over the first GADGET_K7_STEPS steps of the MVB's common factor
    (GADGET_HELD rows each), and K1 on GADGET_HELD rows of the tree's last
    PBS, whose accumulator is a packed GLWE a row with a nonzero mask.  K7
    timed alone at the MVB's shape (a GGSW shared by the batch) beside its
    plain version, and one MVB call traced (device time by kernel, K7's
    share).  → {"launches", "gates", "ops", "k7", "trace"}."""
    from tfhe_tpu_torch import gadget as TG
    from tfhe_tpu_torch.core.algorithms import bootstrap
    from tfhe_tpu_torch.core.entities import GlweCiphertext, LweCiphertext
    from tfhe_tpu_torch.core.params import gadget_params
    from tfhe_tpu_torch.core.poly import external_product as ep
    from tfhe_tpu_torch.core.poly.rotation import _switch_and_prerotate
    from tfhe_tpu_torch.gadget import engine as TE

    gen = torch.Generator().manual_seed(seed + 14)
    totals, gates, ops = {}, [], []

    def counted(label, fn, want):
        zero_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        counts = read_counts()
        expect = {k: 0 for k in counts}
        expect.update(want)
        if counts != expect:
            raise AssertionError(f"gadget {label}: launches {counts}, reckoned {expect}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, start.elapsed_time(stop), counts

    # ---- the gates at GADGET_GATE_SET --------------------------------------------
    gp = gadget_params(GADGET_GATE_SET)
    t0 = time.perf_counter()
    ck, sk = TG.gen_keys(gp, seed=seed, device=dev)
    torch.cuda.synchronize()
    gate_keygen_s = time.perf_counter() - t0
    for name, (fn, arity, vals, p) in GADGET_GATES.items():
        g = TE.Gadget.new_canonical(fn, arity, vals, 1, p, p)
        bits = torch.randint(0, 2, (arity, B), generator=gen)
        cts = [TG.encrypt_arithmetic(ck, bits[i].to(dev), g.enc_in[i], seed=seed + 70 + i)
               for i in range(arity)]
        clear = fn(*bits)
        row = {"gate": name, "p": p, "ms": {}, "right": {}}
        for bt in GADGET_GATE_BATCHES:
            sub = [TE.Ciphertext(lwe=LweCiphertext(data=c.lwe.data[:bt]), encoding=c.encoding)
                   for c in cts]
            out, _, _ = counted(f"{name} batch {bt}", lambda: g.exec(sk, sub),
                                {"blind_rotate": 1, "keyswitch_tc": 1, "keyswitch_decompose": 1})
            right = int((TG.decrypt(ck, out).cpu() == clear[:bt]).sum())
            if right != bt or tuple(out.lwe.data.shape) != (bt, gp.lwe_dimension + 1):
                raise AssertionError(f"gadget {name} at batch {bt}: {right}/{bt} right, output "
                                     f"{tuple(out.lwe.data.shape)}")
            row["right"][str(bt)] = right
            row["ms"][str(bt)] = cuda_ms(lambda: g.exec(sk, sub), 3 if bt == B else 5)
        gates.append(row)
        print(f"{tag} gadget {name} at {GADGET_GATE_SET} (p = {p}, one K1, pass and K2' a "
              f"call): ms a call " + ", ".join(
                  f"batch {bt} {row['ms'][str(bt)]:.3f} ({row['right'][str(bt)]}/{bt} right; "
                  f"boolean AND {bool_and_ms.get(str(bt), float('nan')):.3f})"
                  for bt in GADGET_GATE_BATCHES), flush=True)
        del cts, out
    print(f"{tag} gadget {GADGET_GATE_SET} (n={gp.lwe_dimension}, k={gp.glwe_dimension}, "
          f"N={gp.polynomial_size}, PBS {gp.pbs_base_log}x{gp.pbs_level}, KS "
          f"{gp.ks_base_log}x{gp.ks_level}, PBS -> KS) keys in {gate_keygen_s:.2f} s", flush=True)
    del ck, sk

    # ---- the ops at GADGET_OP_SET ------------------------------------------------------
    op = gadget_params(GADGET_OP_SET)
    t0 = time.perf_counter()
    ck, sk = TG.gen_keys(op, seed=seed, device=dev)
    torch.cuda.synchronize()
    op_keygen_s = time.perf_counter() - t0
    n = op.lwe_dimension
    enc5 = TE.Encoding.new_canonical(5, list(range(5)), 11)
    enc3 = TE.Encoding.new_canonical(3, [0, 1, 2], 7)
    w16 = TE.Encoding.new_trivial_wopbs(16)
    in17 = TE.Encoding.new_canonical(16, list(range(16)), 17)
    m5 = torch.randint(0, 5, (GADGET_BATCH,), generator=gen)
    x0, x1 = torch.randint(0, 3, (2, GADGET_BATCH), generator=gen)
    ma, mb = torch.randint(0, 16, (2, GADGET_BATCH), generator=gen)
    c5 = TG.encrypt_arithmetic(ck, m5.to(dev), enc5, seed=seed + 80)
    c0 = TG.encrypt_arithmetic(ck, x0.to(dev), enc3, seed=seed + 81)
    c1 = TG.encrypt_arithmetic(ck, x1.to(dev), enc3, seed=seed + 82)
    ca = TG.encrypt_arithmetic(ck, ma.to(dev), w16, seed=seed + 83)
    cb = TG.encrypt_arithmetic(ck, mb.to(dev), w16, seed=seed + 84)
    c17 = TG.encrypt_arithmetic(ck, ma.to(dev), in17, seed=seed + 85)
    luts = [[(2 * x) % 5 for x in range(5)], [(x * x) % 5 for x in range(5)],
            [(x + 3) % 5 for x in range(5)]]
    tree_lut = [(2 * i + 1) % 3 for i in range(9)]
    f9 = lambda x: (x * x + 2) % 9
    v9 = (x0 + 3 * x1) ** 2 + 2
    f16 = lambda x: (3 * x + 1) % 16
    pass_tc = lambda c: {"keyswitch_tc": c, "keyswitch_decompose": c}
    plan = [
        ("apply_lut", lambda: [TE.apply_lut(sk, c5, enc5, lambda x: (4 * x + 1) % 5)],
         [(4 * m5 + 1) % 5], {"blind_rotate": 1, **pass_tc(1)}),
        ("mvb, 3 outputs", lambda: TE.mvb(sk, c5, [enc5] * 3, luts),
         [torch.tensor(l)[m5] for l in luts], {"external_product": n, **pass_tc(1)}),
        ("simple_tree_bootstrapping", lambda: [TE.simple_tree_bootstrapping(
            sk, [c1, c0], enc3, 9, tree_lut)], [torch.tensor(tree_lut)[x0 + 3 * x1]],
         {"external_product": n, "blind_rotate": 1, **pass_tc(3)}),
        ("full_tree_bootstrapping", lambda: TE.full_tree_bootstrapping(
            sk, [c1, c0], [enc3, enc3], 9, f9), [(v9 % 9) // 3, v9 % 3],
         {"external_product": n, "blind_rotate": 2, **pass_tc(5)}),
        ("lwe_mult", lambda: [TE.lwe_mult(sk, ca, cb, w16)], [(ma * mb) % 16], pass_tc(1)),
        ("woppbs_lut", lambda: [TE.woppbs_lut(sk, c17, w16, f16)], [f16(ma)],
         {"blind_rotate": 2, **pass_tc(3)}),
    ]
    spy = {"k7": [], "k1": None}
    saved = (bootstrap.external_product, TE.programmable_bootstrap)

    def k7_spy(acc, spectra, decomp, **kw):
        out = saved[0](acc, spectra, decomp, **kw)
        if len(spy["k7"]) < GADGET_K7_STEPS:
            sel = slice(0, GADGET_HELD)
            spy["k7"].append((acc[sel].clone(), spectra, decomp, kw["exps"][sel].clone(),
                              out[sel].clone()))
        return out

    def k1_spy(lwe, lut, bsk):
        out = saved[1](lwe, lut, bsk)
        if lut.data.dim() > 2 and spy["k1"] is None:
            sel = slice(0, GADGET_HELD)
            spy["k1"] = (lwe.data[sel].clone(), lut.data[sel].clone(), bsk, out.data[sel].clone())
        return out

    for label, fn, wants, launches in plan:
        _, first_ms, _ = _timed(fn, dev)          # the first call: host tables for new shapes
        try:
            bootstrap.external_product, TE.programmable_bootstrap = k7_spy, k1_spy
            outs, ms, counts = counted(label, fn, launches)
        finally:
            bootstrap.external_product, TE.programmable_bootstrap = saved
        right = [int((TG.decrypt(ck, o).cpu() == w).sum()) for o, w in zip(outs, wants)]
        row = {"op": label, "batch": GADGET_BATCH, "ms": ms, "first_ms": first_ms,
               "right": right, "launches": _launched(counts)}
        ops.append(row)
        before = C12_TRUNCATING_RIGHT.get(label)
        print(f"{tag} gadget {label} at {GADGET_OP_SET}, batch {GADGET_BATCH}: {ms:.3f} ms a "
              f"call (the first call {first_ms:.3f}), right "
              + ", ".join(f"{r}/{GADGET_BATCH}" for r in right)
              + (f" (with the truncating switch, ROADMAP C12: {before}/{GADGET_BATCH})"
                 if before is not None else "")
              + f", launches {json.dumps(row['launches'])}", flush=True)
        if min(right) < GADGET_BATCH:
            print(f"{tag} finding: gadget {label} at {GADGET_OP_SET} decrypts "
                  + ", ".join(f"{r}/{GADGET_BATCH}" for r in right) + " (not held)", flush=True)
        del outs
    print(f"{tag} gadget {GADGET_OP_SET} (n={n}, k={op.glwe_dimension}, N={op.polynomial_size}, "
          f"PBS {op.pbs_base_log}x{op.pbs_level}, KS {op.ks_base_log}x{op.ks_level}, KS -> PBS) "
          f"keys in {op_keygen_s:.2f} s", flush=True)

    # ---- the holds: K7 over the common factor's first steps, K1 on a packed accumulator
    k7_err = 0
    for acc, spectra, decomp, exps, out in spy["k7"]:
        k7_err = max(k7_err, max_abs_err(
            out, ep.external_product_plain(acc, spectra, decomp, exps=exps)))
    lwe, lut, bsk, k1_out = spy["k1"]
    masked = bool(lut[:, :-1, :].any())
    with plain_kernels():
        k1_plain = TE.programmable_bootstrap(LweCiphertext(data=lwe), GlweCiphertext(data=lut),
                                             bsk)
    k1_err = max_abs_err(k1_out, k1_plain.data)
    print(f"{tag} gadget holds: K7 over the MVB's first {len(spy['k7'])} steps on "
          f"{GADGET_HELD} rows {k7_err}; K1 on {GADGET_HELD} rows of the tree's packed "
          f"accumulator (mask nonzero: {masked}) {k1_err} (max abs err; 0 is bit-identical)",
          flush=True)
    if k7_err or k1_err or not masked or len(spy["k7"]) != GADGET_K7_STEPS:
        raise AssertionError(f"gadget holds: K7 {k7_err}, K1 {k1_err}, mask nonzero {masked}")

    # ---- K7 alone at the MVB's shape; one MVB call traced --------------------------
    acc0 = TE.build_common_factor_accumulator(op, enc5, dev)
    small = TE.keyswitch_lwe(c5.lwe, sk.ksk)
    _, exps, acc = _switch_and_prerotate(acc0.data, small.data, op.polynomial_size)
    spectra = sk.bsk.spectra[:, 1] if sk.bsk.paired else sk.bsk.spectra
    spec0, decomp = spectra[0], sk.bsk.decomp
    launch = lambda: ep.external_product(acc, spec0, decomp, exps=exps[:, 0])
    launch()
    k7_ms = cuda_ms(launch, 20)
    k7_plain_ms = cuda_ms(lambda: ep.external_product_plain(acc, spec0, decomp, exps=exps[:, 0]),
                          2)
    P, J, R, N = spec0.shape
    k7_bytes = _nbytes(acc, spec0, exps[:, 0]) + acc.numel() * 8
    k7_shape = (f"gadget MVB common factor at {GADGET_OP_SET}: batch {GADGET_BATCH}, N={N}, "
                f"k+1={R}, PBS {decomp.base_log}x{decomp.level} (J={J}), P={P}, a GGSW shared "
                f"by the batch")
    print(f"{tag} K7 {k7_shape}: {k7_ms:.4f} ms, plain {k7_plain_ms:.3f} ms", flush=True)
    wall_ms, by_kernel, timeline = profile_window(lambda: TE.mvb(sk, c5, [enc5] * 3, luts))
    busy = print_profile(f"{tag} profiler, one gadget MVB call at batch {GADGET_BATCH}",
                         wall_ms, by_kernel, timeline)
    if not busy:
        raise AssertionError("the gadget MVB trace shows no device time")
    excl = exclusive_ms(timeline)
    k7_busy = sum(v for k, v in excl.items() if "external_product" in k)
    trace = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
             "k7_ms": k7_busy, "k7_share_of_busy": k7_busy / busy,
             "by_kernel_ms": {k[:60]: v for k, v in sorted(excl.items(),
                                                           key=lambda kv: -kv[1])[:6]}}
    print(f"{tag} gadget MVB trace: K7 {k7_busy:.3f} ms of {busy:.3f} busy "
          f"({k7_busy / busy:.1%}); by kernel (exclusive ms) {json.dumps(trace['by_kernel_ms'])}",
          flush=True)
    del ck, sk, c5, c0, c1, ca, cb, c17, spy, acc, small, spectra
    torch.cuda.empty_cache()
    return {"launches": totals, "gates": gates, "ops": ops, "trace": trace,
            "gate_keygen_s": gate_keygen_s, "op_keygen_s": op_keygen_s,
            "k7": {"err": k7_err, "k1_err": k1_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
                   "bytes": k7_bytes, "shape": k7_shape,
                   "mults": k7_mults(GADGET_BATCH, P, J, R, N)}}


def shift_reckoning(nb: int, bp: int, amount_nb: int, kind: str, glwe_size: int, lc: int,
                    batch: int) -> dict:
    """The GGSW shift's launches and PBS rows, reckoned from
    `integer/shift_key.py`: one CBS call (a K1 launch, its pass and K2'), a
    private functional keyswitch (a pass and K2') per selector bit and GGSW
    row, one packing keyswitch (a pass and K2' at the pfks decomposition),
    a K7 CMux per selector bit, one refresh call; the arithmetic shift's
    sign bit one more KS+PBS call."""
    n_sel = max(1, math.ceil(math.log2(nb * bp)))
    sb = int(math.log2(bp)) if bp > 1 else 0
    bits = [j for j in range(sb, n_sel) if j // bp < amount_nb]
    subs = [t for t in range(sb) if t // bp < amount_nb]
    refresh = 2 * nb - (kind in ("shl", "shr"))   # logical shifts have no edge neighbour
    calls = 2 + (kind == "ashr")
    pfks = len(bits) * glwe_size + 1
    return {"launches": {"blind_rotate": calls, "keyswitch_tc": calls + pfks,
                         "keyswitch_decompose": calls + pfks,
                         "external_product": len(bits)},
            "pbs_rows": batch * (len(bits) * lc + len(subs) + refresh + (kind == "ashr"))}


def shift_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4m: shifts and rotates by an encrypted amount through GGSW
    selectors (`integer/shift_key.py`).  integer.gen_keys at SHIFT_SET with
    shift_key="auto" (WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS) for 16 blocks;
    FheUint32 shl, shr, rotl, rotr and the arithmetic shr by encrypted
    amounts at SHIFT_BATCH (BENCH_SUITE.json's uint32_shl and uint32_rotl
    rows), and uint64 shl (32 blocks), each with the counts at 0 just
    before and read just after (held equal to `shift_reckoning`), timed by
    CUDA events, its peak device memory read, decrypted against the clear
    model, and the same op on the layered path (the same keys without the
    shift key) timed in the same run and decrypted.  The hlapi's FheUint32
    << on generate_keys(shift_key="auto") beside the integer layer's.  C3's
    hold: SHIFT_CHAIN dependent rotl at SHIFT_BATCH, every value right.
    → {"launches", "ops", "chain"}."""
    import numpy as np

    from tfhe_tpu_torch import hlapi as H
    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.integer import shift_key as SK

    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    rck, isk = integer.gen_keys(SHIFT_SET, num_blocks=16, seed=seed, shift_key="auto",
                                device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    shk = isk.shift_key
    wp = shk.wopbs.params
    layered = integer.ServerKey(key=isk.key)
    m = isk.msg_mod
    bp = int(math.log2(m))
    print(f"{tag} shift key: {wp.name} (N={wp.polynomial_size}, n={wp.lwe_dimension}), cbs "
          f"{shk.cbs_decomp.base_log}x{shk.cbs_decomp.level}, casts "
          f"{SK.SHIFT_CAST_KS_DECOMP.base_log}x{SK.SHIFT_CAST_KS_DECOMP.level}, packing "
          f"{shk.pksk.decomp.base_log}x{shk.pksk.decomp.level}; keys in {keygen_s:.2f} s",
          flush=True)
    ops, totals = [], {}

    def clear(kind, v, s, bits):
        s %= 1 << max(1, math.ceil(math.log2(bits)))
        mask = (1 << bits) - 1
        if kind == "shl":
            return (v << s) & mask if s < bits else 0
        if kind == "shr":
            return v >> s if s < bits else 0
        if kind == "ashr":
            sv = v - (1 << bits) if v >> (bits - 1) else v
            return (sv >> min(s, bits - 1)) & mask
        s %= bits
        if kind == "rotl":
            return ((v << s) | (v >> (bits - s))) & mask if s else v
        return ((v >> s) | (v << (bits - s))) & mask if s else v

    names = {"shl": "left_shift", "shr": "right_shift", "rotl": "rotate_left",
             "rotr": "rotate_right", "ashr": "right_shift_arithmetic"}
    def draw(bits):
        """SHIFT_BATCH uniform values below 2^bits (bits <= 64)."""
        return [((int(h) << 32) | int(lo)) % (1 << bits) for h, lo in
                zip(rng.integers(0, 1 << 32, SHIFT_BATCH), rng.integers(0, 1 << 32, SHIFT_BATCH))]

    for label, kind, nb in SHIFT_OPS:
        bits = nb * bp
        ck = integer.RadixClientKey(key=rck.key, num_blocks=nb)
        vals, amts = draw(bits), draw(bits)
        a = ck.encrypt(vals, seed=seed + 10)
        s = ck.encrypt(amts, seed=seed + 11)
        want = [clear(kind, v, x, bits) for v, x in zip(vals, amts)]
        row = {"op": label, "blocks": nb, "batch": SHIFT_BATCH}
        for path, key in (("ggsw", isk), ("layered", layered)):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = getattr(key, names[kind])(a, s)
            stop.record()
            torch.cuda.synchronize()
            counts = read_counts()
            peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e6
            got = [int(v) for v in ck.decrypt(out)]
            right = sum(g == w for g, w in zip(got, want))
            row[path] = {"ms": start.elapsed_time(stop), "peak_mb": peak, "right": right,
                         "launches": _launched(counts)}
            if path == "ggsw":
                reck = shift_reckoning(nb, bp, nb, kind, wp.glwe_dimension + 1,
                                       shk.cbs_decomp.level, SHIFT_BATCH)
                want_counts = {k: 0 for k in counts}
                want_counts.update(reck["launches"])
                if counts != want_counts:
                    raise AssertionError(f"GGSW {label}: launches {counts}, reckoned "
                                         f"{want_counts}")
                row["pbs_rows"] = reck["pbs_rows"]
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            if right != SHIFT_BATCH:
                raise AssertionError(f"{path} {label}: {right}/{SHIFT_BATCH} right")
        row["ms_per_op"] = row["ggsw"]["ms"] / SHIFT_BATCH
        row["layered_ms_per_op"] = row["layered"]["ms"] / SHIFT_BATCH
        ops.append(row)
        print(f"{tag} {label} ({nb} blocks, batch {SHIFT_BATCH}): GGSW {row['ggsw']['ms']:.3f} ms "
              f"({row['ms_per_op']:.4f} ms an op; {row['pbs_rows'] // SHIFT_BATCH} PBS an op; "
              f"peak {row['ggsw']['peak_mb']:.1f} MB; launches "
              f"{json.dumps(row['ggsw']['launches'])}), layered {row['layered']['ms']:.3f} ms "
              f"({row['layered_ms_per_op']:.4f} ms an op; launches "
              f"{json.dumps(row['layered']['launches'])}); {SHIFT_BATCH}/{SHIFT_BATCH} right on "
              f"both; tfhe-rs on a CPU {SHIFT_BASELINE_MS.get(label, 'n/a')} ms an op",
              flush=True)

    # ---- the hlapi's << on a key with the shift key --------------------------
    hck, hsk = H.generate_keys(H.ConfigBuilder().use_custom_parameters(SHIFT_SET).build(),
                               seed=seed + 1, shift_key="auto", device=dev)
    H.set_server_key(hsk)
    vals = [int(v) for v in rng.integers(0, 1 << 32, SHIFT_BATCH)]
    amts = [int(v) for v in rng.integers(0, 32, SHIFT_BATCH)]
    x, y = H.FheUint32.encrypt(vals, hck, seed=seed + 12), H.FheUint32.encrypt(amts, hck,
                                                                               seed=seed + 13)
    zero_counts()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    z = x << y
    stop.record()
    torch.cuda.synchronize()
    h_counts = read_counts()
    got = [int(v) for v in z.decrypt(hck)]
    h_right = sum(g == clear("shl", v, s, 32) for g, v, s in zip(got, vals, amts))
    hl = {"op": "hlapi FheUint32 << FheUint32", "batch": SHIFT_BATCH,
          "ms": start.elapsed_time(stop), "right": h_right, "launches": _launched(h_counts),
          "integer_layer_ms": ops[0]["ggsw"]["ms"]}
    if h_counts != {**{k: 0 for k in h_counts}, **shift_reckoning(
            16, bp, 16, "shl", wp.glwe_dimension + 1, shk.cbs_decomp.level,
            SHIFT_BATCH)["launches"]} or h_right != SHIFT_BATCH:
        raise AssertionError(f"hlapi <<: launches {h_counts}, {h_right}/{SHIFT_BATCH} right")
    for k, v in h_counts.items():
        totals[k] = totals.get(k, 0) + v
    print(f"{tag} hlapi FheUint32 << FheUint32 at batch {SHIFT_BATCH}: {hl['ms']:.3f} ms "
          f"(the integer layer's: {hl['integer_layer_ms']:.3f} ms), {h_right}/{SHIFT_BATCH} "
          f"right, launches {json.dumps(hl['launches'])}", flush=True)
    H.unset_server_key()
    del hck, hsk, x, y, z

    # ---- C3: dependent rotations, every value right -------------------------
    ck = integer.RadixClientKey(key=rck.key, num_blocks=16)
    vals = [int(v) for v in rng.integers(0, 1 << 32, SHIFT_BATCH)]
    cur = ck.encrypt(vals, seed=seed + 14)
    expect = list(vals)
    wrong = 0
    t0 = time.perf_counter()
    for i in range(SHIFT_CHAIN):
        amts = [int(v) for v in rng.integers(0, 32, SHIFT_BATCH)]
        cur = isk.rotate_left(cur, ck.encrypt(amts, seed=seed + 100 + i))
        expect = [clear("rotl", v, s, 32) for v, s in zip(expect, amts)]
        wrong += sum(int(g) != w for g, w in zip(ck.decrypt(cur), expect))
    chain_s = time.perf_counter() - t0
    chain = {"rotations": SHIFT_CHAIN, "batch": SHIFT_BATCH,
             "values": SHIFT_CHAIN * SHIFT_BATCH, "wrong": wrong, "seconds": chain_s}
    print(f"{tag} C3 hold: {SHIFT_CHAIN} dependent rotl at batch {SHIFT_BATCH}: {wrong} wrong "
          f"in {SHIFT_CHAIN * SHIFT_BATCH} values ({chain_s:.1f} s)", flush=True)
    if wrong:
        raise AssertionError(f"C3: {wrong} of {SHIFT_CHAIN * SHIFT_BATCH} chained rotations "
                             f"decrypt wrong")
    del rck, isk, layered, shk, cur
    torch.cuda.empty_cache()
    return {"launches": totals, "ops": ops + [hl], "chain": chain, "keygen_s": keygen_s}


def integer_wopbs_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4n: the integer WoP-PBS (`integer/wopbs.py`) on the card, on
    new_wopbs_key_only_for_wopbs over keys of WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS
    (its own cbs and pfks decompositions).  An IWOPBS_BLOCKS-block radix
    (16 bits: 32 LUT polynomials, so each output block runs 31 CMuxes on
    K7 before the GGSW-driven rotation) through f(x) = (7x + 13) mod 2^16
    at IWOPBS_BATCH, and wopbs_crt at moduli (2, 3, 5) with x^2 + 1; each
    with the counts at 0 just before and read just after (held equal to
    the reckoning: K1 an extracted bit's PBS and a CBS level, the pass and
    K2' a keyswitch or a private functional keyswitch, K7 a CMux or
    rotation step), timed, its peak memory read, every row decrypted.
    K7 held and timed alone at the CMux tree's shape (a first-layer CMux,
    a GGSW a row).  → {"launches", "calls", "k7"}."""
    import numpy as np

    from tfhe_tpu_torch import integer, shortint
    from tfhe_tpu_torch.core.algorithms import wopbs as W
    from tfhe_tpu_torch.core.params import wopbs_params
    from tfhe_tpu_torch.core.poly import external_product as ep
    from tfhe_tpu_torch.integer.wopbs import new_integer_wopbs_key
    from tfhe_tpu_torch.shortint import wopbs as SW

    wp = wopbs_params(IWOPBS_SET)
    rng = np.random.default_rng(seed + 13)
    t0 = time.perf_counter()
    ck, sk = shortint.gen_keys(wp, seed=seed + 6, device=dev)
    iwk = new_integer_wopbs_key(SW.new_wopbs_key_only_for_wopbs(
        ck, sk, cbs_decomp=wp.cbs_decomp, pfks_decomp=wp.pfks_decomp, seed=seed))
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    levels, rows, n = wp.cbs_level, wp.glwe_dimension + 1, wp.polynomial_size
    calls, totals = [], {}
    spy = {}
    saved = W.external_product

    def tree_cmux(*a, **kw):
        """Keeps the operands of the latest CMux of the tree whose operands
        have a batch of their own (the tree's first layer shares them)."""
        out = saved(*a, **kw)
        if kw.get("ct1") is not None and a[0].dim() > 2:
            spy["k7"] = (a, kw, out)
        return out

    def reckon(widths, outputs):
        bits = sum(widths)
        luts = max(1, (1 << bits) // n)
        tree = min(luts.bit_length() - 1, bits)
        return {"blind_rotate": sum(w - 1 for w in widths) + bits * levels,
                "keyswitch_tc": sum(widths) + bits * levels * rows,
                "keyswitch_decompose": sum(widths) + bits * levels * rows,
                "external_product": outputs * ((luts - 1) + (bits - tree))}

    nb = IWOPBS_BLOCKS
    m = wp.message_modulus
    f = lambda x: (7 * x + 13) % (1 << (2 * nb))
    vals = [int(v) for v in rng.integers(0, 1 << (2 * nb), IWOPBS_BATCH)]
    rck = integer.RadixClientKey(key=ck, num_blocks=nb)
    cck = integer.CrtClientKey(key=ck, moduli=IWOPBS_MODULI)
    g = lambda x: x * x + 1
    space = math.prod(IWOPBS_MODULI)
    cvals = [int(v) for v in rng.integers(0, space, IWOPBS_BATCH)]
    cases = (("radix", f"{nb}-block radix, (7x + 13) mod 2^{2 * nb}",
              lambda: iwk.wopbs(rck.encrypt(vals, seed=seed + 7), f),
              lambda out: [int(v) for v in rck.decrypt(out)], [f(v) for v in vals],
              reckon([int(math.log2(m))] * nb, nb)),
             ("crt", f"CRT {IWOPBS_MODULI}, x^2 + 1",
              lambda: iwk.wopbs_crt(cck.encrypt(cvals, seed=seed + 8), g),
              lambda out: [int(v) for v in cck.decrypt(out)], [g(v) % space for v in cvals],
              reckon([max(1, math.ceil(math.log2(mj))) for mj in IWOPBS_MODULI],
                     len(IWOPBS_MODULI))))
    W.external_product = tree_cmux
    try:
        for kind, label, run, dec, want, reck in cases:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            stop.record()
            torch.cuda.synchronize()
            counts = read_counts()
            peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e6
            want_counts = {k: 0 for k in counts}
            want_counts.update(reck)
            if counts != want_counts:
                raise AssertionError(f"integer WoP-PBS {label}: launches {counts}, reckoned "
                                     f"{want_counts}")
            right = sum(a == b for a, b in zip(dec(out), want))
            row = {"case": label, "batch": IWOPBS_BATCH, "ms": start.elapsed_time(stop),
                   "peak_mb": peak, "right": right, "launches": _launched(counts),
                   "k7_per_call": counts["external_product"]}
            calls.append(row)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            print(f"{tag} integer WoP-PBS {label} at batch {IWOPBS_BATCH}: {row['ms']:.3f} ms, "
                  f"{right}/{IWOPBS_BATCH} right, peak {peak:.1f} MB above {held / 1e6:.1f} MB "
                  f"held, launches {json.dumps(row['launches'])}", flush=True)
            if right != IWOPBS_BATCH:
                raise AssertionError(f"integer WoP-PBS {label}: {right}/{IWOPBS_BATCH} right")
    finally:
        W.external_product = saved

    # ---- K7 at the CMux tree's shape ------------------------------------------
    (ct0, spectra, decomp), kw, k7_out = spy["k7"]
    ct1 = kw["ct1"]
    held = slice(0, 8)
    plain = ep.external_product_plain(ct0[held], spectra[held], decomp, ct1=ct1[held])
    k7_err = max_abs_err(k7_out[held], plain)
    if k7_err:
        raise AssertionError(f"K7 at the CMux tree differs from its plain version by {k7_err}")
    k7_ms = cuda_ms(lambda: ep.external_product(ct0, spectra, decomp, ct1=ct1), 10)
    k7_plain_ms = cuda_ms(lambda: ep.external_product_plain(ct0, spectra, decomp, ct1=ct1), 2)
    Bk, (P, J, R, nn) = spectra.shape[0], spectra.shape[-4:]
    k7 = {"err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
          "bytes": _nbytes(ct0, spectra, ct1) + Bk * R * nn * 8,
          "mults": k7_mults(Bk, P, J, R, nn),
          "shape": f"integer WoP-PBS CMux tree at {wp.name}: batch {Bk}, N={nn}, k+1={R}, "
                   f"cbs {decomp.base_log}x{decomp.level} (J={J}), P={P}, a GGSW a row"}
    print(f"{tag} K7 {k7['shape']}: {k7_ms:.4f} ms, plain {k7_plain_ms:.3f} ms, held on 8 "
          f"rows: {k7_err}", flush=True)
    del ck, sk, iwk, spy, ct0, spectra, ct1
    torch.cuda.empty_cache()
    return {"launches": totals, "calls": calls, "k7": k7, "keygen_s": keygen_s}


def k8_mults(batch, P, J, R, n) -> int:
    """K8 (csrc/external_product.cu): K7's count, plus per coefficient and
    prime the 64 x 128-bit lift product (three u64 products, 3 each)."""
    return k7_mults(batch, P, J, R, n) + batch * R * n * 9 * P


def pbs128_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4o: the 2^128 torus on the card (`core/algorithms/pbs128.py`).
    PBS128_SET's shapes (n = 742, k = 1, N = 2048, PBS 23 x 1, KS 3 x 5)
    with its noise std-devs scaled to 2^128; the BSK and KSK made on the
    card (threefry masks); PBS128_BATCH messages of 4 bits at Delta =
    2^123 under the GLWE key, keyswitch128 then programmable_bootstrap128
    with a 4-bit LUT, the counts at 0 just before and read just after (one
    pass and one K2' for the keyswitch, K8 once a step), timed, decrypted.
    K8 held bit for bit against its plain version on the first and last 8
    rows of the last step's operands, where both GLWE components carry
    random masks (at the first the mask is the trivial LUT's zeros), and
    timed alone there (a launch);
    the keyswitch's word form held against the plain 128-bit sum on 4
    rows; the keyswitch timed again after a warm-up (the median of
    KS128_REPS calls) and one PBS call traced under torch.profiler (idle
    share, device time by kernel, K8's start-to-start cadence).  Then the
    custom moduli (`nonnative.py`) at tests/test_nonnative.py's
    three moduli, an n = 742 key, PBS128_BATCH rows: encrypt, add,
    scalar-multiply, decrypt and the decomposition, against Python-int
    models.  → {"launches", "pbs", "k8", "custom", "trace"}."""
    import numpy as np

    from tfhe_tpu_torch.core import rng as trng
    from tfhe_tpu_torch.core import threefry, u128
    from tfhe_tpu_torch.core.algorithms import nonnative as NN
    from tfhe_tpu_torch.core.algorithms import pbs128 as M
    from tfhe_tpu_torch.core.entities import GlweSecretKey, LweSecretKey
    from tfhe_tpu_torch.core.params import shortint_params
    from tfhe_tpu_torch.core.poly import external_product as ep

    p = shortint_params(PBS128_SET)
    n_in, k, N = p.lwe_dimension, p.glwe_dimension, p.polynomial_size
    gen = trng.generator(seed, 0x128, device=dev)
    lwe_sk = LweSecretKey(bits=trng.binary_key(gen, (n_in,)))
    glwe_sk = GlweSecretKey(bits=trng.binary_key(gen, (k, N)))
    big = glwe_sk.as_lwe_secret_key()
    ks = threefry.split(threefry.key_from_seed(seed, dev), 4)
    glwe_std, lwe_std = p.glwe_modular_std_dev * 2.0 ** 128, p.lwe_modular_std_dev * 2.0 ** 128
    t0 = time.perf_counter()
    bsk = M.bootstrap_key128_to_ntt(M.generate_bootstrap_key128(
        ks[0], gen, lwe_sk, glwe_sk, p.pbs_decomp, glwe_std), p.pbs_decomp)
    ksk = M.generate_keyswitch_key128(ks[1], gen, big, lwe_sk, p.ks_decomp, lwe_std)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    P = bsk.spectra.shape[1]
    print(f"{tag} 128-bit keys at {PBS128_SET}'s shapes (P = {P} primes for the external "
          f"product) in {keygen_s:.2f} s", flush=True)

    delta, space = 1 << 123, 16
    fn = lambda x: (5 * x + 3) % space
    box = N // space
    lut_vals = [(fn(i // box) * delta) % (1 << 128) for i in range(N)]
    lut_vals = lut_vals[box // 2:] + [(-x) % (1 << 128) for x in lut_vals[:box // 2]]
    lut = M.trivial_glwe128(u128.from_python_ints(lut_vals, dev), k)
    rng = np.random.default_rng(seed + 17)
    msgs = [int(v) for v in rng.integers(0, space, PBS128_BATCH)]
    ct = M.encrypt_lwe128(ks[2], gen, big, u128.from_python_ints([v * delta for v in msgs], dev),
                          glwe_std)
    spy = {}
    saved = M.external_product128

    def keep_last(*a):
        out = saved(*a)
        spy["k8"] = (a, out)
        return out

    M.external_product128 = keep_last
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        start, mid, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        small = M.keyswitch128(ct, ksk)
        mid.record()
        out = M.programmable_bootstrap128(small, lut, bsk)
        stop.record()
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        M.external_product128 = saved
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e6
    want = {c: 0 for c in counts}
    want.update(keyswitch_tc=1, keyswitch_decompose=1, external_product128=n_in)
    if counts != want:
        raise AssertionError(f"128-bit KS+PBS: launches {counts}, reckoned {want}")
    phase = u128.to_python_ints(M.decrypt_lwe128(out, big))
    got = [int((int(v) + delta // 2) // delta) % space for v in phase]
    right = sum(g == fn(v) for g, v in zip(got, msgs))
    pbs = {"batch": PBS128_BATCH, "keyswitch_ms": start.elapsed_time(mid),
           "pbs_ms": mid.elapsed_time(stop), "peak_mb": peak, "right": right,
           "launches": _launched(counts), "keygen_s": keygen_s}
    print(f"{tag} 128-bit keyswitch {pbs['keyswitch_ms']:.3f} ms, PBS {pbs['pbs_ms']:.3f} ms at "
          f"batch {PBS128_BATCH} ({n_in} K8 launches), {right}/{PBS128_BATCH} right, peak "
          f"{peak:.1f} MB, launches {json.dumps(pbs['launches'])}", flush=True)
    if right != PBS128_BATCH:
        raise AssertionError(f"128-bit KS+PBS: {right}/{PBS128_BATCH} right")

    # ---- the keyswitch warm, the median of KS128_REPS calls; one PBS call traced ----
    M.keyswitch128(ct, ksk)
    torch.cuda.synchronize()
    ks_runs = sorted(cuda_ms_reps(lambda: M.keyswitch128(ct, ksk), KS128_REPS))
    pbs["keyswitch_median_ms"] = ks_runs[len(ks_runs) // 2]
    pbs["keyswitch_runs_ms"] = ks_runs
    print(f"{tag} 128-bit keyswitch after a warm-up: median {pbs['keyswitch_median_ms']:.3f} ms "
          f"of {KS128_REPS} calls {[round(t, 3) for t in ks_runs]} (the counted cold call "
          f"{pbs['keyswitch_ms']:.3f})", flush=True)
    wall_ms, by_kernel, timeline = profile_window(
        lambda: M.programmable_bootstrap128(small, lut, bsk))
    busy = print_profile(f"{tag} profiler, one 128-bit PBS call at batch {PBS128_BATCH}",
                         wall_ms, by_kernel, timeline)
    if not busy:
        raise AssertionError("the 128-bit PBS trace shows no device time")
    excl = exclusive_ms(timeline)
    k8_runs = [e for e in timeline if "external_product" in e[0]]
    starts = [e[1] for e in k8_runs]
    cadence = sorted(b - a for a, b in zip(starts, starts[1:]))
    trace = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
             "k8_launches": len(k8_runs),
             "k8_ms": sum(v for k, v in excl.items() if "external_product" in k),
             "k8_start_to_start_median_us": cadence[len(cadence) // 2] if cadence else None,
             "gaps_ms": device_gaps(timeline)[0],
             "by_kernel_ms": {k[:60]: v for k, v in sorted(excl.items(),
                                                           key=lambda kv: -kv[1])[:6]}}
    print(f"{tag} 128-bit PBS trace: idle share {trace['idle_share']:.2%}, K8 {trace['k8_ms']:.3f}"
          f" ms of {busy:.3f} busy over {len(k8_runs)} launches (start to start, median "
          f"{trace['k8_start_to_start_median_us']} us); by kernel (exclusive ms) "
          f"{json.dumps(trace['by_kernel_ms'])}", flush=True)

    # ---- K8 held and timed on the last step's operands ------------------------
    (acc, spectra, decomp, exps), k8_out = spy["k8"]
    ends = torch.cat([torch.arange(8), torch.arange(PBS128_BATCH - 8, PBS128_BATCH)]).to(dev)
    if not bool((acc[ends, :k] != 0).any(dim=(1, 2, 3)).all()):
        raise AssertionError("K8's held rows have a zero GLWE mask at the last step")
    plain = ep.external_product128_plain(acc[ends], spectra, decomp, exps[ends])
    k8_err = max_abs_err(k8_out[ends], plain)
    if k8_err:
        raise AssertionError(f"K8 differs from its plain version by {k8_err}")
    k8_ms = cuda_ms(lambda: ep.external_product128(acc, spectra, decomp, exps), 20)
    k8_plain_ms = cuda_ms(lambda: ep.external_product128_plain(acc, spectra, decomp, exps), 2)
    Pk, J, R, nn = spectra.shape
    Bk = acc.shape[0]
    k8 = {"err": k8_err, "ms": k8_ms, "plain_ms": k8_plain_ms,
          "bytes": 2 * _nbytes(acc) + _nbytes(spectra) + Bk * 4,
          "mults": k8_mults(Bk, Pk, J, R, nn),
          "shape": f"the last step of the 128-bit PBS at {PBS128_SET}'s shapes: batch {Bk}, "
                   f"N={nn}, k+1={R}, PBS {decomp.base_log}x{decomp.level} (J={J}), P={Pk}, the "
                   f"GGSW shared"}
    print(f"{tag} K8 {k8['shape']}: {k8_ms:.4f} ms a launch, plain {k8_plain_ms:.3f} ms; first "
          f"and last 8 rows of the last step against the plain version: {k8_err}", flush=True)
    four = slice(0, 4)
    ks_err = max_abs_err(M.keyswitch128(M.Lwe128(data=ct.data[four]), ksk).data,
                         M.keyswitch128_plain(M.Lwe128(data=ct.data[four]), ksk).data)
    if ks_err:
        raise AssertionError(f"keyswitch128's word form differs from the plain sum by {ks_err}")
    print(f"{tag} keyswitch128's four-word form against the plain 128-bit sum on 4 rows: "
          f"{ks_err}", flush=True)
    del bsk, ksk, spy, acc, spectra, k8_out, ct, small, out
    torch.cuda.empty_cache()

    # ---- the custom moduli -----------------------------------------------------
    custom = []
    for q in CUSTOM_MODULI:
        t0 = time.perf_counter()
        key = threefry.fork(threefry.key_from_seed(seed, dev), q % (1 << 31))
        qd = q // 64
        a_m = [int(v) for v in rng.integers(0, 8, PBS128_BATCH)]
        b_m = [int(v) for v in rng.integers(0, 8, PBS128_BATCH)]
        ca = NN.encrypt_lwe_custom_mod(threefry.fold_in(key, 1), gen, lwe_sk,
                                       [v * qd for v in a_m], 2.0 ** -30, q)
        cb = NN.encrypt_lwe_custom_mod(threefry.fold_in(key, 2), gen, lwe_sk,
                                       [v * qd for v in b_m], 2.0 ** -30, q)
        c3 = NN.lwe_cleartext_mul_custom_mod(NN.lwe_add_custom_mod(ca, cb, q), 3, q)
        phase = NN.decrypt_lwe_custom_mod(c3, lwe_sk, q).cpu().numpy().view(np.uint64)
        dec = [((int(v) + qd // 2) // qd) % 64 for v in phase]
        right = sum(d == 3 * (x + y) for d, x, y in zip(dec, a_m, b_m))
        words = ca.data.reshape(-1)
        wi = words.cpu().numpy().view(np.uint64).astype(object)
        sr = q // (1 << 12)
        closest = NN.closest_representable_custom_mod(words, 4, 3, q).cpu().numpy().view(
            np.uint64).astype(object)
        model = (((wi + sr // 2) % (1 << 64)) % q // sr * sr) % (1 << 64)
        terms = NN.decompose_custom_mod(words, 4, 3, q)
        t = terms.cpu().numpy().view(np.uint64).astype(object)
        centered = np.where(t > q // 2, t - q, t)
        rec = NN.recomposition_summands_custom_mod(terms, 4, 3, q).cpu().numpy().view(
            np.uint64).astype(object).sum(axis=-1) % q
        diff = (rec - closest) % q
        diff = np.where(diff > q // 2, q - diff, diff)
        dec_ok = bool((closest == model).all() and (abs(centered) <= 8).all()
                      and (diff <= 2 * (1 << 12)).all())
        row = {"q": str(q), "n": n_in, "batch": PBS128_BATCH, "right": right,
               "decomposition_words": len(wi), "decomposition_ok": dec_ok,
               "seconds": time.perf_counter() - t0}
        custom.append(row)
        print(f"{tag} custom modulus q = {q}: 3 (a + b) decrypted {right}/{PBS128_BATCH} right, "
              f"the decomposition of {len(wi)} words against the Python-int model "
              f"{'right' if dec_ok else 'WRONG'} ({row['seconds']:.1f} s)", flush=True)
        if right != PBS128_BATCH or not dec_ok:
            raise AssertionError(f"custom modulus {q}: {right}/{PBS128_BATCH}, decomposition "
                                 f"{dec_ok}")
    return {"launches": counts, "pbs": pbs, "k8": k8, "custom": custom, "trace": trace}


def kernel_ms(fn, launches: int):
    """Device ms a launch of the external-product kernels over `launches`
    calls of fn under torch.profiler (exclusive time, so a PDL launch's wait
    is not charged), over the launches the trace recorded; traced again
    where it recorded fewer than were made (the profiler can drop a
    window's records: phase 4o's trace of 742 K8 launches once held 721);
    None where it recorded none."""
    for attempt in (1, 2):
        _, _, timeline = profile_window(lambda: [fn() for _ in range(launches)], cpu=False)
        events = [e for e in timeline if "external_product" in e[0]]
        if len(events) == launches or attempt == 2:
            break
    if not events:
        return None
    return sum(v for k, v in exclusive_ms(timeline).items()
               if "external_product" in k) / len(events)


def ep_forms(seed: int, dev, tag: str, clock_hz: float, sms: int) -> dict:
    """Phase 4p: K7 and K8 at each of EP_SHAPES (full batches, random
    operands, `ep_case`) in every form `external_product._ep_forms` gives
    (one block a row or a cluster of C blocks a row, C dividing P; staged
    or not), each held bit for bit against the plain version on the same
    inputs, then timed in turns (the forms in order, then in reverse; 20
    launches a turn by CUDA events, which count the wrapper's host time
    where it exceeds the kernel's) and once under torch.profiler (10
    launches: the kernel's device time a launch, `kernel_ms`), beside the
    plain version's time and the bound; prints where the rule's form ranks
    by device time (by the events where a trace recorded no kernel).  → {label: {"shape", "rule", "ms":
    {form: mean event ms}, "device_ms": {form: ms}, "runs", "plain_ms",
    "bound", "err"}}, forms as "C" or "C staged"."""
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.poly import external_product as ep

    g = rng.generator(seed, 0x4B7, device=dev)
    out = {}
    name = lambda f: f"{f[0]}{' staged' if f[1] else ''}"
    for label in EP_SHAPES:
        case = ep_case(label, g, dev)
        b, n, R, J, P = (case[k] for k in ("batch", "n", "R", "J", "P"))
        lay = ep._ep_layout(b, n, R, J, P)
        rule = (lay.cluster, lay.stage)
        forms = ep._ep_forms(n, R, J, P)
        ref = case["plain"]()
        plain_ms = cuda_ms(case["plain"], 2)
        for f in forms:
            err = max_abs_err(case["run"](_form=f), ref)
            if err:
                raise AssertionError(f"{label} in form {name(f)} differs from its plain "
                                     f"version by {err}")
        runs = {f: [] for f in forms}
        for f in forms + forms[::-1]:
            case["run"](_form=f)
            runs[f].append(cuda_ms(lambda: case["run"](_form=f), 20))
        mean = {f: sum(t) / len(t) for f, t in runs.items()}
        device = {f: kernel_ms(lambda: case["run"](_form=f), 10) for f in forms}
        timed_by = "device time" if None not in device.values() else "CUDA events"
        key = device if timed_by == "device time" else mean
        bnd = bound(case["mults"], case["bytes"], clock_hz, sms)
        rank = sorted(forms, key=key.get).index(rule) + 1
        print(f"{tag} {case['shape']}: bit-identical to the plain version in every form; "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}", flush=True)
        for f in forms:
            dev_ms = ("not measured (no kernel in the trace)" if device[f] is None else
                      f"{device[f]:.4f} ms a launch ({bnd[0] / device[f]:.1%} of bound)")
            print(f"    {'one block a row' if f[0] == 1 else f'clusters of {f[0]}'}"
                  f"{', staged' if f[1] else ''} ({ep._ep_smem(n, R, J, P, *f)} B): device "
                  f"{dev_ms}, events {mean[f]:.4f} ms, runs {[round(t, 4) for t in runs[f]]}"
                  f"{'  <- the rule' if f == rule else ''}", flush=True)
        print(f"    the rule's form ({name(rule)}) ranks {rank} of {len(forms)} by {timed_by}",
              flush=True)
        out[label] = {"shape": case["shape"], "rule": name(rule),
                      "ms": {name(f): v for f, v in mean.items()},
                      "device_ms": {name(f): v for f, v in device.items()},
                      "runs": {name(f): v for f, v in runs.items()},
                      "plain_ms": plain_ms, "bound": bnd, "err": 0}
        del case, ref
        torch.cuda.empty_cache()
    return out


def noise_hold(seed: int, dev, tag: str) -> dict:
    """ROADMAP C10 on the card: the phases of 4096 encryptions of zero, LWE
    (n = 742) and GLWE (k = 1, N = 2048: 2 polynomials), drawn from the card's
    generators (`rng.gaussian_noise`), through the gates of
    tests/test_torch_noise.py: std within 10%, |mean| < 5 std / sqrt(n),
    kurtosis in (2.6, 3.4), zero noise exactly zero, one seed the same bits."""
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import (decrypt_lwe, encrypt_glwe, encrypt_lwe,
                                                generate_glwe_secret_key,
                                                generate_lwe_secret_key)
    from tfhe_tpu_torch.core.algorithms.encryption import _glwe_mask_dot_key

    std, samples = 2.0 ** 40, 4096

    def phases(kind, sigma, s):
        if kind == "lwe":
            sk = generate_lwe_secret_key(rng.generator(s, 0, device=dev), 742)
            ct = encrypt_lwe(rng.generator(s, 1, device=dev), sk,
                             torch.zeros(samples, dtype=torch.int64, device=dev), sigma)
            return decrypt_lwe(ct, sk)
        sk = generate_glwe_secret_key(rng.generator(s, 0, device=dev), 1, 2048)
        ct = encrypt_glwe(rng.generator(s, 1, device=dev), sk,
                          torch.zeros((samples // 2048, 2048), dtype=torch.int64, device=dev),
                          sigma)
        return (ct.body - _glwe_mask_dot_key(ct.mask, sk.bits)).reshape(-1)

    out = {}
    for kind in ("lwe", "glwe"):
        ph = phases(kind, std, seed)
        if ph.device != dev:
            raise AssertionError(f"{kind} noise was not drawn on the card")
        x = ph.to(torch.float64)
        z = (x - x.mean()) / x.std()
        g = {"std_ratio": (x.std() / std).item(), "mean_over_limit":
             abs(x.mean().item()) / (5 * std / math.sqrt(samples)),
             "kurtosis": (z ** 4).mean().item(),
             "zero_exact": bool((phases(kind, 0.0, seed + 1) == 0).all()),
             "same_bits": bool(torch.equal(phases(kind, 2.0 ** 30, seed + 2),
                                           phases(kind, 2.0 ** 30, seed + 2)))}
        ok = (abs(g["std_ratio"] - 1) < 0.10 and g["mean_over_limit"] < 1
              and 2.6 < g["kurtosis"] < 3.4 and g["zero_exact"] and g["same_bits"])
        print(f"{tag} noise on the card, {kind}, {samples} samples at std 2^40: std / asked "
              f"{g['std_ratio']:.4f}, |mean| / (5 std / sqrt(n)) {g['mean_over_limit']:.4f}, "
              f"kurtosis {g['kurtosis']:.4f}, zero noise exact {g['zero_exact']}, one seed the "
              f"same bits {g['same_bits']}: {'passes' if ok else 'FAILS'} the five gates")
        if not ok:
            raise AssertionError(f"the card's {kind} noise fails a gate: {g}")
        out[kind] = g
    return out


def _cpu_server(sk):
    """A server key's copy on the CPU, for the plain path (no limb layout:
    the CPU keyswitch reads `data`)."""
    from tfhe_tpu_torch.core.entities import LweKeyswitchKey
    return dataclasses.replace(
        sk, ksk=LweKeyswitchKey(data=sk.ksk.data.cpu(), decomp=sk.ksk.decomp),
        bsk=dataclasses.replace(sk.bsk, spectra=sk.bsk.spectra.cpu()))


def _ends(t: torch.Tensor) -> torch.Tensor:
    """The first and last 8 rows of a [rows, ...] tensor, on the host."""
    return torch.cat([t[:8], t[-8:]]).cpu()


def pbs_ks_hold(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """ROADMAP C11 on the card: shortint.gen_keys at PBS_KS_SET (key choice
    small: the PBS runs first, the keyswitch reads its k*N outputs), 512
    messages, one LUT request with the counts set to 0 just before and read
    just after (one K1, one pass, one K2'), 512/512 decrypted, and the first
    and last 8 rows held bit for bit against the plain CPU path."""
    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.params import PBSOrder, shortint_params

    p = shortint_params(PBS_KS_SET)
    if p.pbs_order != PBSOrder.BOOTSTRAP_KEYSWITCH:
        raise AssertionError(f"{PBS_KS_SET} does not take the PBS -> KS order")
    ck, sk = shortint.gen_keys(p, seed=seed, device=dev)
    mm = p.message_modulus
    m = torch.randint(0, mm, (B,), generator=torch.Generator().manual_seed(seed))
    ct = ck.encrypt(m.to(dev), seed=seed + 7)
    f = lambda x: (3 * x + 1) % mm
    lut = sk.generate_lookup_table(f)
    zero_counts()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in counts}
    want.update({"blind_rotate": 1, "keyswitch_tc": 1, "keyswitch_decompose": 1})
    if counts != want:
        raise AssertionError(f"{PBS_KS_SET}: launches {counts}, expected {want}")
    if tuple(out.lwe.data.shape) != (B, p.lwe_dimension + 1):
        raise AssertionError(f"{PBS_KS_SET}: output shape {tuple(out.lwe.data.shape)}")
    right = int((ck.decrypt(out).cpu() == f(m)).sum())
    ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 3)
    t0 = time.perf_counter()
    cpu = _cpu_server(sk)
    ref = cpu.apply_lookup_table(ct.with_(lwe=LweCiphertext(data=_ends(ct.lwe.data))),
                                 cpu.generate_lookup_table(f))
    same = torch.equal(ref.lwe.data, _ends(out.lwe.data))
    cpu_s = time.perf_counter() - t0
    print(f"{tag} C11, {PBS_KS_SET} (n={p.lwe_dimension}, N={p.polynomial_size}, KS "
          f"{p.ks_base_log}x{p.ks_level}: PBS first, then the keyswitch over "
          f"{p.glwe_dimension * p.polynomial_size} inputs): {right}/{B} decrypt right; one K1, "
          f"one pass, one K2'; KS+PBS {ms:.3f} ms at batch {B}; the first and last 8 rows "
          f"{'bit-identical' if same else 'MISMATCH'} to the plain CPU path ({cpu_s:.1f} s)",
          flush=True)
    if right != B or not same:
        raise AssertionError(f"{PBS_KS_SET}: {right}/{B} right, rows held: {same}")
    return {"set": PBS_KS_SET, "right": right, "ms": ms, "launches": counts}


def boolean_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4f: the boolean scheme on the card at the five named sets.  At
    each: boolean.gen_keys on the card; the six gates, mux and not_ at batch
    512 on random operands, each with the counts set to 0 just before and
    read just after (a gate: one K1, one pass, one K2'; mux: two K1, and two
    keyswitches under KS -> PBS, one under PBS -> KS; not_: none) and
    decrypted against its truth table; the AND gate timed at batch 1, 32 and
    512 by CUDA events (ms a call, gates/s); at BOOL_HELD, the first and last
    8 rows of one AND call at batch 512 against the plain CPU path.  Then 8
    dependent ANDs at batch 32 traced under torch.profiler.  → {"launches":
    {kernel: launches}, "sets": [one dict a set], "trace": {...}}."""
    from tfhe_tpu_torch import boolean as Bo
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.params import PBSOrder, boolean_params

    gen = torch.Generator().manual_seed(seed)
    totals, rows, trace = {}, [], {}
    sub = lambda ct, n: Bo.BoolCiphertext(lwe=LweCiphertext(data=ct.lwe.data[:n]))
    for name in BOOL_SETS:
        p = boolean_params(name)
        ks_first = p.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP
        t0 = time.perf_counter()
        ck, sk = Bo.gen_keys(p, seed=seed, device=dev)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        n_out = p.big_lwe_dimension if ks_first else p.lwe_dimension
        m = torch.randint(0, 2, (3, B), generator=gen).bool()
        a, b, c = (Bo.encrypt(ck, m[i].to(dev), seed=seed + 60 + i) for i in range(3))
        ops = [(g, lambda g=g: getattr(Bo, g)(sk, a, b), f(m[0], m[1]))
               for g, f in BOOL_TRUTH.items()]
        ops += [("mux", lambda: Bo.mux(sk, a, b, c), torch.where(m[0], m[1], m[2])),
                ("not_", lambda: Bo.not_(a), ~m[0])]
        right = 0
        for gname, fn, want in ops:
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            counts = read_counts()
            k1 = {"mux": 2, "not_": 0}.get(gname, 1)
            ks = {"mux": 2 if ks_first else 1, "not_": 0}.get(gname, 1)
            expect = {k: 0 for k in counts}
            expect.update({"blind_rotate": k1, "keyswitch_tc": ks, "keyswitch_decompose": ks})
            if counts != expect:
                raise AssertionError(f"{name} {gname}: launches {counts}, expected {expect}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            if out.device != dev or tuple(out.lwe.data.shape) != (B, n_out + 1):
                raise AssertionError(f"{name} {gname}: output {tuple(out.lwe.data.shape)} on "
                                     f"{out.device}")
            ok = int((Bo.decrypt(ck, out).cpu() == want).sum())
            if ok != B:
                raise AssertionError(f"{name} {gname}: {ok}/{B} decrypt right")
            right += ok
        held = None
        if name in BOOL_HELD:
            out = Bo.and_(sk, a, b)
            t0 = time.perf_counter()
            ref = Bo.and_(_cpu_server(sk), Bo.BoolCiphertext(lwe=LweCiphertext(
                data=_ends(a.lwe.data))), Bo.BoolCiphertext(lwe=LweCiphertext(
                    data=_ends(b.lwe.data))))
            held = torch.equal(ref.lwe.data, _ends(out.lwe.data))
            print(f"{name} and_ at batch {B}, its first and last 8 rows: card path "
                  f"{'bit-identical' if held else 'MISMATCH'} to the plain CPU path "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not held:
                raise AssertionError(f"{name}: the AND call disagrees with the plain CPU path")
        lat = {}
        for bt in BOOL_BATCHES:
            x, y = sub(a, bt), sub(b, bt)
            Bo.and_(sk, x, y)
            lat[bt] = cuda_ms(lambda: Bo.and_(sk, x, y), 3 if bt == B else 5)
        mux_ms = cuda_ms(lambda: Bo.mux(sk, a, b, c), 2)
        base = BOOL_BASELINE_MS.get(name)
        row = {"set": name, "order": p.pbs_order, "n": p.lwe_dimension,
               "k": p.glwe_dimension, "N": p.polynomial_size,
               "pbs": f"{p.pbs_base_log}x{p.pbs_level}", "ks": f"{p.ks_base_log}x{p.ks_level}",
               "keygen_s": keygen_s, "right": right,
               "gate_ms": {str(k): v for k, v in lat.items()},
               "gates_per_s": {str(k): k / (v / 1e3) for k, v in lat.items()},
               "mux_ms_512": mux_ms, "held": held, "baseline_cpu_ms": base}
        rows.append(row)
        print(f"{tag} boolean {name} (n={p.lwe_dimension}, k={p.glwe_dimension}, "
              f"N={p.polynomial_size}, PBS {row['pbs']}, KS {row['ks']}, "
              f"{'KS -> PBS' if ks_first else 'PBS -> KS'}): gen_keys {keygen_s:.2f} s; "
              f"{right}/{len(ops) * B} right over six gates, mux and not_; AND ms a call "
              + ", ".join(f"batch {k} {v:.3f} ({k / (v / 1e3):.1f} gates/s)"
                          for k, v in lat.items())
              + f"; mux {mux_ms:.3f} ms at {B}; tfhe-rs CPU, one gate: "
              + (f"{base} ms (BASELINE.md:12-14, beside, not against)" if base
                 else "not listed"), flush=True)
        if name == APP_BOOL_SET:
            x, y = sub(a, 32), sub(b, 32)

            def chain():
                z = x
                for _ in range(8):
                    z = Bo.and_(sk, z, y)
                return z
            wall_ms, by_kernel, timeline = profile_window(chain, cpu=False)
            busy = print_profile(f"{tag} profiler, 8 dependent ANDs at batch 32, {name}",
                                 wall_ms, by_kernel, timeline)
            if not busy:
                raise AssertionError("the boolean trace shows no device time")
            gap_ms, longest = device_gaps(timeline)
            print(f"{tag} the 8 ANDs' trace: {gap_ms:.3f} ms between kernels, the longest "
                  + ", ".join(f"{g:.3f} ms before {k[:40]}" for g, k in longest))
            trace = {"set": name, "wall_ms": wall_ms, "busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms, "gap_ms": gap_ms,
                     "kernels": len(timeline)}
        del ck, sk, a, b, c
    torch.cuda.empty_cache()
    return {"launches": totals, "sets": rows, "trace": trace}


@contextlib.contextmanager
def counted_calls():
    """Within: the KS+PBS calls the apps make, counted where they are made
    (the boolean module's bootstrap and keyswitch, shortint's
    apply_lookup_table, the casting key's keyswitch, each one pass + K2'
    and/or one K1 on the card):
    yields {"pbs": n, "ks": n, "lut": n}."""
    from tfhe_tpu_torch import boolean as Bo
    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.shortint import key_switching_key as KS
    calls = {"pbs": 0, "ks": 0, "lut": 0}
    saved = (Bo.programmable_bootstrap, Bo.keyswitch_lwe, shortint.ServerKey.apply_lookup_table,
             KS.keyswitch_lwe)

    def wrap(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call
    Bo.programmable_bootstrap = wrap("pbs", saved[0])
    Bo.keyswitch_lwe = wrap("ks", saved[1])
    shortint.ServerKey.apply_lookup_table = wrap("lut", saved[2])
    KS.keyswitch_lwe = wrap("ks", saved[3])
    try:
        yield calls
    finally:
        (Bo.programmable_bootstrap, Bo.keyswitch_lwe, shortint.ServerKey.apply_lookup_table,
         KS.keyswitch_lwe) = saved


def apps_path(seed: int, dev, tag: str, zero_counts, read_counts, bool_sets: list) -> dict:
    """Phase 4g: the apps and examples on the card, each run with the counts
    set to 0 just before and read just after (K1 once a bootstrap, the pass
    and K2' once a keyswitch, nothing else) and decrypted against its clear
    model: TriviumStreamShortint (32 streams, the full warm-up); the boolean
    Trivium and Kreyvium streams (32 streams, the warm-up that fits
    STREAM_BUDGET_S at the gate latency phase 4f measured); the byte stream
    on FheUint8 at 2_2; SHA-256 (whole, or its primitives and a projection);
    the dark market and the regex engine on 4-block integers at 2_2.
    → {"launches": {...}, "apps": [one dict an app]}."""
    import numpy as np

    from tfhe_tpu_torch import boolean as Bo
    from tfhe_tpu_torch import hlapi as H
    from tfhe_tpu_torch import integer, shortint
    from tfhe_tpu_torch.apps import (KreyviumStream, TriviumStream, TriviumStreamByte,
                                     TriviumStreamShortint, clear_kreyvium_keystream,
                                     clear_trivium_keystream, trans_encrypt_u64)
    from tfhe_tpu_torch.core.params import SHORTINT_KS
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.params import boolean_params
    from tfhe_tpu_torch.examples import dark_market, regex_engine, sha256_bool

    rng = np.random.default_rng(seed)
    totals, apps = {}, []

    @contextlib.contextmanager
    def window(label):
        """Counts at 0, the calls counted, then launches checked against them."""
        zero_counts()
        with counted_calls() as calls:
            yield calls
        torch.cuda.synchronize()
        counts = read_counts()
        expect = {k: 0 for k in counts}
        expect.update({"blind_rotate": calls["pbs"] + calls["lut"],
                       "keyswitch_tc": calls["ks"] + calls["lut"],
                       "keyswitch_decompose": calls["ks"] + calls["lut"]})
        if counts != expect or not counts["blind_rotate"]:
            raise AssertionError(f"{label}: launches {counts} over calls {calls}, "
                                 f"expected {expect}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        calls["launches"] = {k: v for k, v in counts.items() if v}

    def report(row):
        apps.append(row)
        print(f"{tag} app {row['app']}: " + "; ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "app"), flush=True)

    ev = lambda: torch.cuda.Event(enable_timing=True)

    # ---- Trivium on shortint bits: 32 streams, 18 warm-up rounds, round 19 --
    ck, sk = shortint.gen_keys(TRIVIUM_SET, seed=seed, device=dev)
    key_bits = rng.integers(0, 2, (80, STREAMS))
    iv = rng.integers(0, 2, 80).tolist()
    enc_key = [ck.encrypt(torch.as_tensor(key_bits[i]), seed=seed + 200 + i) for i in range(80)]
    stream = TriviumStreamShortint(enc_key, iv, sk, warmup_rounds=0)
    widen = lambda reg: [c if c.lwe.data.dim() == 2 else c.with_(lwe=LweCiphertext(
        data=c.lwe.data.expand(STREAMS, -1))) for c in reg]
    stream.a, stream.b, stream.c = widen(stream.a), widen(stream.b), widen(stream.c)
    marks = [ev() for _ in range(20)]
    t0 = time.perf_counter()
    with window("TriviumStreamShortint") as calls:
        marks[0].record()
        for r in range(19):
            out = stream.next_64()
            marks[r + 1].record()
    host_s = time.perf_counter() - t0
    round_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(19)]
    got = torch.stack([ck.decrypt(z) for z in out]).cpu().numpy()        # [64, S]
    want = np.array([clear_trivium_keystream(key_bits[:, s].tolist(), iv, 64)
                     for s in range(STREAMS)]).T
    right = int((got == want).all(axis=0).sum())
    steady = sum(round_ms[1:]) / 18
    report({"app": "TriviumStreamShortint", "set": TRIVIUM_SET, "streams": STREAMS,
            "warmup_clocks": 1152, "streams_right": right, "calls": calls["lut"],
            "round_ms": steady, "first_round_ms": round_ms[0], "round_19_ms": round_ms[18],
            "keystream_bits_per_s": 64 * STREAMS / (steady / 1e3), "host_s": host_s,
            "launches": calls["launches"]})
    if right != STREAMS:
        raise AssertionError(f"TriviumStreamShortint: {right}/{STREAMS} streams right")

    # ---- transciphering from the shortint stream into an FheUint64 at 2_2 -
    # round 20's keystream masks a batch of STREAMS values (one a stream);
    # the stream's state, kept, gives the same keystream again to unmask it
    hl_ck, hl_sk = H.generate_keys(H.ConfigBuilder().use_custom_parameters(HL_SET).build(),
                                   seed=seed + 1, device=dev)
    cast = shortint.generate_key_switching_key(ck, hl_ck.shortint_ck, SHORTINT_KS[CAST_SET],
                                               seed=seed, dest_server_key=hl_sk.radix.key)
    values = [int(v) for v in rng.integers(0, 1 << 64, STREAMS, dtype=np.uint64)]
    cipher = H.FheUint64.encrypt(values, hl_ck, seed=seed + 250)
    stream.cast_ksk, stream.hl_server_key = cast, hl_sk
    kept = (stream.a, stream.b, stream.c)
    with window("TriviumStreamShortint.trans_encrypt_64") as calls:
        start_ev, stop_ev = ev(), ev()
        start_ev.record()
        masked = stream.trans_encrypt_64(cipher)
        stop_ev.record()
    enc_ms = start_ev.elapsed_time(stop_ev)
    ks20 = [clear_trivium_keystream(key_bits[:, s].tolist(), iv, 128)[64:]
            for s in range(STREAMS)]
    got = [int(v) for v in masked.decrypt(hl_ck)]
    right_enc = sum(g == trans_encrypt_u64(v, k) for g, v, k in zip(got, values, ks20))
    stream.a, stream.b, stream.c = kept
    with window("TriviumStreamShortint.trans_decrypt_64") as calls_dec:
        unmasked = stream.trans_decrypt_64(masked)
    right_dec = sum(int(g) == v for g, v in zip(unmasked.decrypt(hl_ck), values))
    report({"app": "TriviumStreamShortint transciphering", "set": f"{TRIVIUM_SET} -> {HL_SET}",
            "cast": CAST_SET, "values": STREAMS, "trans_encrypt_ms": enc_ms,
            "calls": calls["lut"], "casts": calls["ks"], "encrypt_right": right_enc,
            "round_trip_right": right_dec, "launches": calls["launches"]})
    if right_enc != STREAMS or right_dec != STREAMS:
        raise AssertionError(f"transciphering through {CAST_SET}: {right_enc}/{STREAMS} "
                             f"masked right, {right_dec}/{STREAMS} unmasked right")
    del ck, sk, enc_key, stream, out, cast, cipher, masked, unmasked

    # ---- the boolean streams: 32 streams, the warm-up that fits the budget --
    bp = boolean_params(APP_BOOL_SET)
    at = min(b for b in BOOL_BATCHES if b >= STREAMS)
    gate_ms = next(r for r in bool_sets if r["set"] == APP_BOOL_SET)["gate_ms"][str(at)]
    ck, sk = Bo.gen_keys(bp, seed=seed, device=dev)
    for cls, clear, width, per_clock in ((TriviumStream, clear_trivium_keystream, 80, 14),
                                         (KreyviumStream, clear_kreyvium_keystream, 128, 16)):
        n_out = 8
        fit = int(STREAM_BUDGET_S * 1e3 / (per_clock * gate_ms)) - n_out
        warm = max(0, min(1152, fit))
        key_bits = rng.integers(0, 2, (width, STREAMS))
        iv = rng.integers(0, 2, width).tolist()
        enc_key = [Bo.encrypt(ck, torch.as_tensor(key_bits[i]).bool(), seed=seed + 300 + i)
                   for i in range(width)]
        start, mid, stop = ev(), ev(), ev()
        t0 = time.perf_counter()
        with window(cls.__name__) as calls:
            start.record()
            stream = cls(sk, enc_key, iv, warmup_rounds=warm)
            mid.record()
            outs = stream.next_bits(n_out)
            stop.record()
        host_s = time.perf_counter() - t0
        got = torch.stack([Bo.decrypt(ck, z) for z in outs]).cpu().numpy()    # [n_out, S]
        want = np.array([clear(key_bits[:, s].tolist(), iv, n_out, warmup_rounds=warm)
                         for s in range(STREAMS)]).T
        right = int((got == want).all(axis=0).sum())
        out_ms = mid.elapsed_time(stop)
        report({"app": cls.__name__, "set": APP_BOOL_SET, "streams": STREAMS,
                "warmup_clocks": warm, "cut": warm < 1152,
                f"gate_ms_at_{at}": gate_ms, "gate_calls": calls["pbs"],
                "warmup_ms": start.elapsed_time(mid), "clock_ms": out_ms / n_out,
                "ms_per_gate_call": start.elapsed_time(stop) / calls["pbs"],
                "keystream_bits_per_s": STREAMS * n_out / (out_ms / 1e3),
                "full_warmup_projected_s": 1152 * out_ms / n_out / 1e3,
                "streams_right": right, "host_s": host_s, "launches": calls["launches"]})
        if right != STREAMS:
            raise AssertionError(f"{cls.__name__}: {right}/{STREAMS} streams right")
        del enc_key, stream, outs
    # one boolean Trivium clock traced: the idle share of a chain of gates
    stream = TriviumStream(sk, [Bo.encrypt(ck, torch.ones(STREAMS, dtype=torch.bool),
                                           seed=seed + 400)] * 80, [0] * 80, warmup_rounds=0)
    wall_ms, by_kernel, timeline = profile_window(stream.next_bit, cpu=False)
    busy = print_profile(f"{tag} profiler, one boolean Trivium clock, {STREAMS} streams",
                         wall_ms, by_kernel, timeline)
    if not busy:
        raise AssertionError("the Trivium trace shows no device time")
    gap_ms, longest = device_gaps(timeline)
    print(f"{tag} the Trivium clock's trace: {gap_ms:.3f} ms between kernels, the longest "
          + ", ".join(f"{g:.3f} ms before {k[:40]}" for g, k in longest))
    apps.append({"app": "trace: one boolean Trivium clock", "wall_ms": wall_ms,
                 "busy_ms": busy, "idle_share": 1 - busy / wall_ms, "gap_ms": gap_ms,
                 "kernels": len(timeline)})

    # ---- SHA-256: the primitives on 32-row words, then whole or projected ---
    word = lambda v: Bo.encrypt(ck, [bool((v >> i) & 1) for i in range(32)], seed=seed + v % 997)
    val = lambda w: sum(int(x) << i for i, x in enumerate(Bo.decrypt(ck, w).tolist()))
    av, bv, cv = (int(x) for x in rng.integers(0, 1 << 32, 3, dtype=np.uint64))
    wa, wb, wc = word(av), word(bv), word(cv)
    rotr = lambda v, r: ((v >> r) | (v << (32 - r))) & 0xFFFFFFFF
    prims = [("add_words_b", lambda: sha256_bool.add_words_b(sk, wa, wb, bp),
              (av + bv) & 0xFFFFFFFF),
             ("small sigma0", lambda: sha256_bool._sigma_b(sk, wa, 7, 18, 3, bp, True),
              rotr(av, 7) ^ rotr(av, 18) ^ (av >> 3)),
             ("small sigma1", lambda: sha256_bool._sigma_b(sk, wa, 17, 19, 10, bp, True),
              rotr(av, 17) ^ rotr(av, 19) ^ (av >> 10)),
             ("big sigma0", lambda: sha256_bool._sigma_b(sk, wa, 2, 13, 22, bp, False),
              rotr(av, 2) ^ rotr(av, 13) ^ rotr(av, 22)),
             ("big sigma1", lambda: sha256_bool._sigma_b(sk, wa, 6, 11, 25, bp, False),
              rotr(av, 6) ^ rotr(av, 11) ^ rotr(av, 25)),
             ("ch_b", lambda: sha256_bool.ch_b(sk, wa, wb, wc), (av & bv) ^ (~av & cv)),
             ("maj_b", lambda: sha256_bool.maj_b(sk, wa, wb, wc),
              (av & bv) ^ (av & cv) ^ (bv & cv))]
    per_call, n_calls = {}, {}
    start, stop = ev(), ev()
    for label, fn, want in prims:
        with window(f"sha256 {label}") as calls:
            start.record()
            out = fn()
            stop.record()
        if val(out) != want & 0xFFFFFFFF:
            raise AssertionError(f"sha256 {label}: {val(out):#x}, expected {want:#x}")
        n_calls[label], per_call[label] = calls["pbs"], start.elapsed_time(stop) / calls["pbs"]
    add, sig = n_calls["add_words_b"], n_calls["small sigma0"]
    total = (48 * (2 * sig + 3 * add) + 64 * (7 * add + 2 * sig + n_calls["ch_b"]
                                              + n_calls["maj_b"]) + 8 * add)
    ms_call = sum(per_call[k] * n_calls[k] for k in n_calls) / sum(n_calls.values())
    projected_s = total * ms_call / 1e3
    row = {"app": "sha256", "set": APP_BOOL_SET, "calls_per_primitive": n_calls,
           "ms_per_call": ms_call, "digest_calls": total, "digest_projected_s": projected_s,
           "whole": projected_s <= SHA_BUDGET_S}
    if row["whole"]:
        import hashlib
        bits = Bo.encrypt(ck, sha256_bool.pad_sha256_input("abc"), seed=seed + 500)
        with window("sha256_fhe") as calls:
            start.record()
            digest = sha256_bool.sha256_fhe(sk, bp, bits)
            stop.record()
        hexd = sha256_bool.bools_to_hex(Bo.decrypt(ck, digest).tolist())
        row.update(digest_s=start.elapsed_time(stop) / 1e3, digest_calls=calls["pbs"],
                   digest_right=hexd == hashlib.sha256(b"abc").hexdigest())
        if not row["digest_right"]:
            raise AssertionError(f"sha256_fhe('abc') = {hexd}")
    report(row)
    del ck, sk, wa, wb, wc

    # ---- the byte stream, the dark market and the regex engine at 2_2 -------
    ck, isk = integer.gen_keys(CLASSIC, num_blocks=4, seed=seed, device=dev)
    key = [int(x) for x in rng.integers(0, 256, 10)]
    iv = [int(x) for x in rng.integers(0, 256, 10)]
    enc = [ck.encrypt(v, seed=seed + 600 + i) for i, v in enumerate(key)]
    with window("TriviumStreamByte") as calls:
        start.record()
        st = TriviumStreamByte(enc, iv, server_key=isk, warmup_rounds=BYTE_WARMUP)
        got = st.next_64()
        stop.record()
    got = [int(ck.decrypt(v)) for v in got]
    clear_st = TriviumStreamByte(key, iv, warmup_rounds=BYTE_WARMUP)
    want = clear_st.next_64()
    report({"app": "TriviumStreamByte", "set": CLASSIC, "warmup_rounds": BYTE_WARMUP,
            "rounds": BYTE_WARMUP + 1, "ms_per_round": start.elapsed_time(stop)
            / (BYTE_WARMUP + 1), "calls": calls["lut"], "right": got == want})
    if got != want:
        raise AssertionError(f"TriviumStreamByte: {got} != {want}")
    # transciphering: round 20's 8 bytes mask one FheUint64 on the stream's
    # key; the state, kept, unmasks it
    value = int(rng.integers(0, 1 << 64, dtype=np.uint64))
    cipher = H.FheUint64(integer.RadixClientKey(key=ck.key, num_blocks=32).encrypt(
        value, seed=seed + 650))
    kept = (st.a, st.b, st.c)
    with window("TriviumStreamByte.trans_encrypt_64") as calls:
        start.record()
        masked = st.trans_encrypt_64(cipher)
        stop.record()
    bits = [(b >> j) & 1 for b in clear_st.next_64() for j in range(8)]   # LSB first
    rck64 = integer.RadixClientKey(key=ck.key, num_blocks=32)
    right_enc = int(rck64.decrypt(masked.ct)) == trans_encrypt_u64(value, bits)
    st.a, st.b, st.c = kept
    with window("TriviumStreamByte.trans_decrypt_64"):
        unmasked = st.trans_decrypt_64(masked)
    right_dec = int(rck64.decrypt(unmasked.ct)) == value
    report({"app": "TriviumStreamByte transciphering", "set": CLASSIC,
            "trans_encrypt_ms": start.elapsed_time(stop), "calls": calls["lut"],
            "encrypt_right": right_enc, "round_trip_right": right_dec})
    if not (right_enc and right_dec):
        raise AssertionError(f"byte-stream transciphering: masked right {right_enc}, "
                             f"unmasked right {right_dec}")

    def fill(orders, other_total):
        pre, out = 0, []
        for o in orders:
            out.append(min(o, max(0, other_total - pre)))
            pre += o
        return out
    buys, sells = [int(x) for x in rng.integers(0, 60, 3)], [int(x) for x in rng.integers(0, 60, 2)]
    eb = [ck.encrypt(v, seed=seed + 700 + i) for i, v in enumerate(buys)]
    es = [ck.encrypt(v, seed=seed + 710 + i) for i, v in enumerate(sells)]
    with window("volume_match") as calls:
        start.record()
        fb, fs = dark_market.volume_match(isk, eb, es)
        stop.record()
    matched = min(sum(buys), sum(sells))
    ok = ([int(ck.decrypt(x)) for x in fb] == fill(buys, matched)
          and [int(ck.decrypt(x)) for x in fs] == fill(sells, matched))
    report({"app": "dark market volume_match", "set": CLASSIC, "orders": [3, 2],
            "ms": start.elapsed_time(stop), "calls": calls["lut"], "right": ok})
    buys, sells = rng.integers(0, 30, 8).tolist(), rng.integers(0, 30, 8).tolist()
    with window("volume_match_parallel") as calls:
        start.record()
        fb, fs = dark_market.volume_match_parallel(isk, ck.encrypt(buys, seed=seed + 720),
                                                   ck.encrypt(sells, seed=seed + 721))
        stop.record()
    ok2 = (ck.decrypt(fb).tolist() == fill(buys, sum(sells))
           and ck.decrypt(fs).tolist() == fill(sells, sum(buys)))
    report({"app": "dark market volume_match_parallel", "set": CLASSIC, "orders": [8, 8],
            "ms": start.elapsed_time(stop), "calls": calls["lut"], "right": ok2})
    if not (ok and ok2):
        raise AssertionError("the dark market disagrees with its clear model")
    for pattern, text, want in (("/^ab/", "abc", True), ("/bc$/", "abc", True),
                                ("/b/", "xyz", False), ("a[bc]d", "acd", True)):
        enc = [ck.encrypt(ord(ch), seed=seed + 800 + i) for i, ch in enumerate(text)]
        with window(f"regex {pattern}") as calls:
            start.record()
            out = regex_engine.regex_match_radix(isk, pattern, enc)
            stop.record()
        got = bool(int(ck.key.decrypt(out)) & 1)
        report({"app": f"regex {pattern} on {text!r}", "set": CLASSIC,
                "ms": start.elapsed_time(stop), "calls": calls["lut"], "right": got == want})
        if got != want:
            raise AssertionError(f"regex {pattern} on {text!r}: {got}, expected {want}")
    del ck, isk
    torch.cuda.empty_cache()
    return {"launches": totals, "apps": apps}


BOOL32_SET = "DEFAULT_PARAMETERS_KS_PBS"     # phase 4q, replaced to log_q = 32
BOOL32_BATCHES = (1, 32, B)
BOOL32_TRUTH = {"and_": lambda x, y, z: x & y, "xor_": lambda x, y, z: x ^ y,
                "mux": lambda x, y, z: torch.where(x, y, z)}
MESH_SET = CLASSIC                           # phase 4r
# phase 4s: SHA-256 of the port's AES-CTR stream under bytes 0..15 (1 MiB,
# then 64 KiB of fork 5's fork 2), written by the port on the CPU and equal
# to the JAX package's generator's (tests/test_torch_native.py)
CSPRNG_SEED = bytes(range(16))
CSPRNG_DIGEST = "aeb1ebaea4d454da43b296fda0bd9df1d4d619f07915bb9a11a59425e320ad73"


def csprng_digest(native) -> str:
    import hashlib
    g = native.AesCtrGenerator(CSPRNG_SEED)
    h = hashlib.sha256(g.generate(1 << 20))
    h.update(g.fork(5).fork(2).generate(1 << 16))
    return h.hexdigest()


def bool32_path(seed: int, dev, tag: str, zero_counts, read_counts, clock_hz: float,
                sms: int) -> dict:
    """Phase 4q: the boolean scheme on the reference's own 32-bit torus,
    BOOL32_SET's published widths with log_q = 32, held lifted by 2^32.
    boolean.gen_keys on the card (the key's route must be "rotate": the
    rotate-subtract PBS, one K7 launch a step, at the 64-bit prime count);
    AND, XOR and MUX at each of BOOL32_BATCHES on random operands, each
    call with the counts set to 0 just before and read just after (a gate:
    n K7 launches, one pass, one K2'; MUX: 2n K7 and, under KS -> PBS, two
    keyswitches), every row decrypted against the truth table and every
    word's low 32 bits zero; the first AND call (batch 1) bit-identical to
    the plain CPU path; ms a call by CUDA events.  Then the kernels at this path's
    shapes, held bit for bit against their plain versions on the same card
    inputs and timed beside their bounds: K7 (one GGSW of the key shared,
    rotated operand) at each batch, and the pass + K2' at one digit limb
    on the key's KSK and the gate's ciphertexts.  → {"rows", "k7", "ks",
    "launches", "keygen_s"}."""
    from tfhe_tpu_torch import boolean as Bo
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import keyswitch
    from tfhe_tpu_torch.core.decomposition import signed_decompose
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.params import PBSOrder, boolean_params
    from tfhe_tpu_torch.core.poly import external_product as ep

    p = dataclasses.replace(boolean_params(BOOL32_SET), log_q=32, name=f"{BOOL32_SET} u32")
    t0 = time.perf_counter()
    ck, sk = Bo.gen_keys(p, seed=seed, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    n, N, R = p.lwe_dimension, p.polynomial_size, p.glwe_size
    P, J = sk.bsk.spectra.shape[1], p.pbs_level * R
    if sk.bsk.route != "rotate" or sk.bsk.spectra.device != dev:
        raise AssertionError(f"the 32-bit key took route {sk.bsk.route!r} on "
                             f"{sk.bsk.spectra.device}, not 'rotate' on the card")
    ks_first = p.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP
    print(f"{tag} boolean {p.name} (n={n}, k={p.glwe_dimension}, N={N}, PBS "
          f"{p.pbs_base_log}x{p.pbs_level}, KS {p.ks_base_log}x{p.ks_level}, "
          f"{'KS -> PBS' if ks_first else 'PBS -> KS'}, P={P}): gen_keys on the card "
          f"{keygen_s:.2f} s", flush=True)
    gen = torch.Generator().manual_seed(seed + 32)
    m = torch.randint(0, 2, (3, B), generator=gen).bool()
    cts = [Bo.encrypt(ck, m[i].to(dev), seed=seed + 320 + i) for i in range(3)]
    sub = lambda ct, k: Bo.BoolCiphertext(lwe=LweCiphertext(data=ct.lwe.data[:k]), log_q=32)
    cpu_sk = _cpu_server(sk)
    per_gate = {"external_product": n, "keyswitch_tc": 1, "keyswitch_decompose": 1}
    per_mux = {"external_product": 2 * n, "keyswitch_tc": 2 if ks_first else 1,
               "keyswitch_decompose": 2 if ks_first else 1}
    rows, totals, held = [], {}, []
    for bt in BOOL32_BATCHES:
        x, y, z = (sub(ct, bt) for ct in cts)
        ops = {"and_": lambda: Bo.and_(sk, x, y), "xor_": lambda: Bo.xor_(sk, x, y),
               "mux": lambda: Bo.mux(sk, x, y, z)}
        row = {"batch": bt}
        for name, fn in ops.items():
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            counts = read_counts()
            expect = {k: 0 for k in counts}
            expect.update(per_mux if name == "mux" else per_gate)
            if counts != expect:
                raise AssertionError(f"{p.name} {name} batch {bt}: launches {counts}, "
                                     f"expected {expect}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            if out.log_q != 32 or bool((out.lwe.data & 0xFFFFFFFF).any()):
                raise AssertionError(f"{p.name} {name}: a word is not a lifted 32-bit word")
            want = BOOL32_TRUTH[name](m[0, :bt], m[1, :bt], m[2, :bt])
            ok = int((Bo.decrypt(ck, out).cpu() == want).sum())
            if ok != bt:
                raise AssertionError(f"{p.name} {name} batch {bt}: {ok}/{bt} decrypt right")
            if not held:
                t1 = time.perf_counter()
                ref = Bo.and_(cpu_sk, *(Bo.BoolCiphertext(
                    lwe=LweCiphertext(data=v.lwe.data.cpu()), log_q=32) for v in (x, y)))
                same = torch.equal(ref.lwe.data, out.lwe.data.cpu())
                print(f"{p.name} and_ at batch {bt}, the first call: card path "
                      f"{'bit-identical' if same else 'MISMATCH'} to the plain CPU path "
                      f"({time.perf_counter() - t1:.1f} s)", flush=True)
                if not same:
                    raise AssertionError(f"{p.name}: the first AND call disagrees with the "
                                         f"plain CPU path")
                held.append(bt)
            op = name.rstrip("_")
            row[f"{op}_ms"] = cuda_ms(fn, 2 if name == "mux" or bt == B else 5)
            row[f"{op}_k7_launches"] = counts["external_product"]
            row[f"{op}_right"] = ok
        rows.append(row)
        print(f"{tag} boolean {p.name} batch {bt}: AND {row['and_ms']:.3f} ms a call "
              f"({bt / (row['and_ms'] / 1e3):.1f} gates/s, {row['and_k7_launches']} K7 "
              f"launches), XOR {row['xor_ms']:.3f} ms, MUX {row['mux_ms']:.3f} ms "
              f"({row['mux_k7_launches']} K7 launches); every row decrypts right", flush=True)

    g = rng.generator(seed, 0x32, device=dev)
    spectra = sk.bsk.spectra[0]
    k7 = {"err": 0, "shapes": []}
    for bt in BOOL32_BATCHES:
        acc = rng.uniform_torus(g, (bt, R, N), log_q=32)
        exps = torch.randint(0, 2 * N, (bt,), generator=g, device=dev)
        run = lambda: ep.external_product(acc, spectra, p.pbs_decomp, exps=exps)
        plain = lambda: ep.external_product_plain(acc, spectra, p.pbs_decomp, exps=exps)
        k7["err"] = max(k7["err"], hold(f"K7 at {p.name}, batch {bt}, N={N}, k+1={R}, J={J}, "
                                        f"P={P}, a GGSW shared", run(), plain()))
        ms = cuda_ms(run, 20)
        device_ms = kernel_ms(run, 10)
        plain_ms = cuda_ms(plain, 2)
        bnd = bound(k7_mults(bt, P, J, R, N), _nbytes(acc, spectra, exps) + acc.numel() * 8,
                    clock_hz, sms)
        shape = (f"K7 boolean u32 step: batch {bt}, N={N}, k+1={R}, "
                 f"{p.pbs_base_log}x{p.pbs_level} (J={J}), P={P}, a GGSW shared, rotated "
                 f"operand")
        k7["shapes"].append({"shape": shape, "ms": device_ms or ms, "events_ms": ms,
                             "plain_ms": plain_ms, "bound": bnd, "batch": bt})
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
        print(f"{tag} {shape}: device {dev_txt} a launch, events {ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms by {bnd[1]}, plain {plain_ms:.3f} ms", flush=True)

    decomp = p.ks_decomp
    n_in, L, M = sk.ksk.data.shape
    K, key, limbs = n_in * L, sk.ksk.data.reshape(n_in * L, M), sk.ksk.limbs
    Kp = keyswitch.padded_depth(K)
    ks = {"err": {"tc": 0, "dec": 0}}
    for bt in BOOL32_BATCHES:
        mask, body = cts[0].lwe.data[:bt, :-1], cts[0].lwe.data[:bt, -1]
        d = keyswitch.decompose_digits(mask, decomp)
        torch.cuda.synchronize()
        ks["err"]["dec"] = max(ks["err"]["dec"], hold(
            f"decomposition pass {p.name}, batch {bt}, n_in {n_in}, {L} levels", d,
            keyswitch.decompose_digits_plain(mask, decomp)))
        got = keyswitch.neg_digit_mac_tensor_core(d, key, limbs, body, decomp.base_log)
        torch.cuda.synchronize()
        ks["err"]["tc"] = max(ks["err"]["tc"], hold(
            f"K2' {p.name}, batch {bt}, K={K}, M={M}, one digit limb", got,
            keyswitch.neg_digit_mac_plain(d[:, :K], key, body)))
    mask, body = cts[0].lwe.data[:, :-1], cts[0].lwe.data[:, -1]
    d = keyswitch.decompose_digits(mask, decomp)
    d32 = signed_decompose(mask, decomp).reshape(B, K).to(torch.int32)
    ks.update(tc_ms=cuda_ms(lambda: keyswitch.neg_digit_mac_tensor_core(
        d, key, limbs, body, decomp.base_log), 10),
        dec_ms=cuda_ms(lambda: keyswitch.decompose_digits(mask, decomp), 10),
        tc_plain_ms=cuda_ms(lambda: keyswitch.neg_digit_mac_plain(d32, key, body), 1),
        dec_plain_ms=cuda_ms(lambda: keyswitch.decompose_digits_plain(mask, decomp), 3),
        int_mm_ms=int_mm_ms(B, Kp, 8 * M, dev), tc_bound=tc_bound(B, K, M, Kp, clock_hz, sms),
        dec_bound=bound(decompose_ops(B, n_in, L), B * n_in * 8 + B * Kp, clock_hz, sms),
        shape=f"{p.name} batch {B}, K={K}, M={M}", limbs=1)
    mm = "not measured" if ks["int_mm_ms"] is None else f"{ks['int_mm_ms']:.4f} ms"
    print(f"{tag} keyswitch {p.name} batch {B} (K={K}, M={M}): K2' {ks['tc_ms']:.4f} ms "
          f"(bound {ks['tc_bound'][0]:.4f} ms by {ks['tc_bound'][1]}), plain "
          f"{ks['tc_plain_ms']:.3f} ms; pass {ks['dec_ms']:.4f} ms (bound "
          f"{ks['dec_bound'][0]:.4f} ms by {ks['dec_bound'][1]}), plain "
          f"{ks['dec_plain_ms']:.3f} ms; torch._int_mm {mm}", flush=True)
    del ck, sk, cpu_sk, cts
    torch.cuda.empty_cache()
    return {"set": p.name, "keygen_s": keygen_s, "rows": rows, "held": held, "k7": k7,
            "ks": ks, "launches": totals}


def mesh_path(seed: int, dev, tag: str, zero_counts, read_counts) -> dict:
    """Phase 4r: the dp mesh (`tfhe_tpu_torch.parallel`) with the card named
    twice, on MESH_SET's KS+PBS at batch B: `shard_map_kspbs` runs each
    half on its own stream of the card; with the counts set to 0 just before
    and read just after, the split call makes two K1 launches and two of
    each keyswitch kernel, and its output is bit-identical to the unsplit
    call's and decrypts right.  Both timed by CUDA events.  The machine
    has one card, so scaling across cards is not measured."""
    from tfhe_tpu_torch import parallel, shortint
    from tfhe_tpu_torch.core.entities import LweCiphertext
    from tfhe_tpu_torch.core.params import shortint_params

    p = shortint_params(MESH_SET)
    ck, sk = shortint.gen_keys(p, seed=seed, device=dev)
    msgs = torch.arange(B) % p.message_modulus
    ct = ck.encrypt(msgs.to(dev), seed=seed + 41)
    f = lambda x: (3 * x + 1) % p.message_modulus
    lut = sk.generate_lookup_table(f)

    def step(data, key, table):
        c = dataclasses.replace(ct, lwe=LweCiphertext(data=data))
        return key.apply_lookup_table(c, table).lwe.data

    whole = step(ct.lwe.data, sk, lut)
    mesh = parallel.make_mesh(devices=[dev, dev])
    run = parallel.shard_map_kspbs(step, mesh)
    keys, luts = parallel.replicate_tree(sk, mesh), parallel.replicate_tree(lut, mesh)
    zero_counts()
    out = run(ct.lwe.data, keys, luts)
    torch.cuda.synchronize()
    counts = read_counts()
    expect = {k: 0 for k in counts}
    expect.update({"blind_rotate": 2, "keyswitch_tc": 2, "keyswitch_decompose": 2})
    if counts != expect:
        raise AssertionError(f"mesh KS+PBS: launches {counts}, expected {expect}")
    same = torch.equal(out, whole)
    right = int((ck.decrypt(dataclasses.replace(ct, lwe=LweCiphertext(data=out))).cpu()
                 == f(msgs)).sum())
    print(f"{tag} mesh of {mesh.size} entries ({', '.join(map(str, mesh.devices))}), "
          f"{MESH_SET} KS+PBS batch {B}: {'bit-identical' if same else 'MISMATCH'} to the "
          f"unsplit call, {right}/{B} decrypt right", flush=True)
    if not same or right != B:
        raise AssertionError("the mesh's KS+PBS differs from the unsplit call or decrypts "
                             "wrong")
    split_ms = cuda_ms(lambda: run(ct.lwe.data, keys, luts), 3)
    whole_ms = cuda_ms(lambda: step(ct.lwe.data, sk, lut), 3)
    cards = torch.cuda.device_count()
    print(f"{tag} mesh KS+PBS batch {B}: split in two on one card {split_ms:.3f} ms, unsplit "
          f"{whole_ms:.3f} ms; cards on this machine: {cards}, so scaling across cards is "
          f"not measured", flush=True)
    del ck, sk, keys, luts
    torch.cuda.empty_cache()
    return {"set": MESH_SET, "entries": mesh.size, "split_ms": split_ms, "whole_ms": whole_ms,
            "cards": cards, "launches": counts}


def periphery_path(tag: str) -> dict:
    """Phase 4s: the AES-CTR CSPRNG (`tfhe_tpu_torch.native`, built by g++
    here) on the FIPS-197 vectors, both backends, and its stream against
    CSPRNG_DIGEST (written by the port on the CPU, equal to the JAX
    package's); then the C ABI: libtfhe_tpu_torch_capi.so built against
    this machine's libpython, the unchanged C client
    (tests/c_api/test_high_level_integers.c) built against it and run with
    no device variable set, so on the card: it must print PASS."""
    import sysconfig

    from tfhe_tpu_torch import native

    t0 = time.perf_counter()
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    vectors = {enc.__name__: enc(key, block).hex()
               for enc in (native.aes128_encrypt_block, native.aes128_encrypt_block_soft)}
    if set(vectors.values()) != {"69c4e0d86a7b0430d8cdb78070b4c55a"}:
        raise AssertionError(f"AES-128 misses FIPS-197 C.1: {vectors}")
    digest = csprng_digest(native)
    if digest != CSPRNG_DIGEST:
        raise AssertionError(f"the CSPRNG stream's digest {digest} is not {CSPRNG_DIGEST}")
    print(f"{tag} CSPRNG ({native.backend()} backend, built in "
          f"{time.perf_counter() - t0:.2f} s): FIPS-197 C.1 on both backends; the stream "
          f"equals the one the port writes on the CPU (SHA-256 {digest[:16]}...)", flush=True)
    libdir = sysconfig.get_config_var("LIBDIR")
    ldlib = sysconfig.get_config_var("LDLIBRARY")
    print(f"embedding CPython: {sysconfig.get_config_var('LDVERSION')}, {ldlib} in {libdir}, "
          f"Py_ENABLE_SHARED={sysconfig.get_config_var('Py_ENABLE_SHARED')}", flush=True)
    t0 = time.perf_counter()
    so = native.build_capi()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        binary = os.path.join(tmp, "test_high_level_integers")
        subprocess.run(["g++", "-O2", os.path.join(repo, "tests", "c_api",
                                                   "test_high_level_integers.c"),
                        f"-I{native.INCLUDE}", f"-L{so.parent}", f"-Wl,-rpath,{so.parent}",
                        "-ltfhe_tpu_torch_capi", "-o", binary], check=True, capture_output=True)
        build_s = time.perf_counter() - t0
        env = {k: v for k, v in os.environ.items() if k != "TFHE_TPU_TORCH_DEVICE"}
        env["PYTHONPATH"] = repo
        t0 = time.perf_counter()
        res = subprocess.run([binary], cwd=repo, env=env, capture_output=True, text=True,
                             timeout=600)
    run_s = time.perf_counter() - t0
    print(f"{tag} C client against libtfhe_tpu_torch_capi.so on the card: exit "
          f"{res.returncode}, {res.stdout.strip()[-60:]!r} (library and client built in "
          f"{build_s:.1f} s, run {run_s:.1f} s)", flush=True)
    if res.returncode != 0 or "PASS" not in res.stdout:
        raise AssertionError(f"the C client failed: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    return {"csprng_backend": native.backend(), "digest": digest, "capi_build_s": build_s,
            "c_client_s": run_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--against", metavar="DIR", help="time this checkout against DIR's")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--only", default="", help="with --against: the measurements whose labels "
                    "start with one of these comma-separated prefixes (e.g. K7,K8)")
    ap.add_argument("--ep", action="store_true", help="build, then only phase 4p: K7 and K8 "
                    "at EP_SHAPES in every form, held and timed")
    ap.add_argument("--ks", action="store_true", help="build, then only the keyswitch's holds "
                    "and times of phases 3, 3b and 3f")
    ap.add_argument("--bool32", action="store_true", help="build, then only phase 4q: the "
                    "boolean gates on the 32-bit torus, K7 and the pass + K2' at its shapes")
    ap.add_argument("--turn-in", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = tuple(x for x in args.only.split(",") if x)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    if args.turn_in:
        sys.path.insert(0, args.turn_in)
        print(json.dumps(measure_turn(args.seed, only)))
        return 0
    if args.against:
        return compare(args.against, args.turns, args.seed, only)

    from tfhe_tpu_torch import config, cuda_lib, shortint, smem_probe
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes, keyswitch
    from tfhe_tpu_torch.core.algorithms.encryption import bootstrap_key_to_ntt_paired
    from tfhe_tpu_torch.core.decomposition import signed_decompose
    from tfhe_tpu_torch.core.entities import (LweCiphertext, NttBootstrapKey,
                                              NttMultiBitBootstrapKey)
    from tfhe_tpu_torch.core.params import (boolean_params, gadget_params, shortint_params,
                                            wopbs_params)
    from tfhe_tpu_torch.core.poly import external_product, ntt, rotation

    # ---- 1. the card ---------------------------------------------------------
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {card}; max SM clock {clock_mhz:.0f} MHz, {sms} SMs")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}, {torch.cuda.get_device_name(0)}")
    tag = f"[{card}]"
    clock_hz = clock_mhz * 1e6
    t_start = time.perf_counter()

    def lap(phase):
        print(f"{tag} phase {phase} starts at {time.perf_counter() - t_start:.1f} s", flush=True)

    def zero_counts():
        rotation.launches = rotation.multi_bit_launches = 0
        keyswitch.launches = keyswitch.decompose_launches = 0
        rotation.step_launches = rotation.step_variant_launches = 0
        rotation.cluster_launches = rotation.cluster_variant_launches = 0
        rotation.staged_launches = 0
        external_product.launches = external_product.launches128 = 0

    def read_counts():
        return {"blind_rotate": rotation.launches,
                "blind_rotate_multibit": rotation.multi_bit_launches,
                "blind_rotate_step": rotation.step_launches,
                "blind_rotate_step_variants": rotation.step_variant_launches,
                "blind_rotate_cluster_step": rotation.cluster_launches,
                "blind_rotate_cluster_step_variants": rotation.cluster_variant_launches,
                "blind_rotate_staged": rotation.staged_launches,
                "keyswitch_tc": keyswitch.launches,
                "keyswitch_decompose": keyswitch.decompose_launches,
                "external_product": external_product.launches,
                "external_product128": external_product.launches128}

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.library()
    info = cuda_lib.build_info
    print(f"{tag} build: {time.perf_counter() - t0:.2f} s (nvcc {info.get('seconds', 0):.2f} s, "
          f"cached={info.get('cached')})")
    for line in info.get("log", "").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
            print(f"ptxas: {line.strip()}")
    if args.bool32:
        lap("4q")
        b32 = bool32_path(args.seed, dev, tag, zero_counts, read_counts, clock_hz, sms)
        print(json.dumps({"bool32": {k: v for k, v in b32.items() if k != "ks"}}))
        return 0
    if args.ep:
        lap("4p")
        forms = ep_forms(args.seed, dev, tag, clock_hz, sms)
        lap("4o")
        p128 = pbs128_path(args.seed, dev, tag, zero_counts, read_counts)
        print(json.dumps({"ep_forms": forms, "pbs128": p128["pbs"], "k8": p128["k8"]}))
        return 0

    g = rng.generator(args.seed, 7, device=dev)

    def widths(params):
        n, N, R = params.lwe_dimension, params.polynomial_size, params.glwe_dimension + 1
        J = params.pbs_level * R
        P = external_product_num_primes(N, R, params.pbs_decomp)
        return n, N, R, J, P, ntt.get_plan(N, P)

    def steps_at(acc, exps, key, cluster):
        """The per-step rotation of `rotation.rotate_steps` (K5 on a paired
        or multi-bit key), each launch at the given cluster size."""
        mode, exps = rotation._step_mode(key, exps)
        out, e32 = acc.clone(), exps.to(torch.int32).contiguous()
        for j in range(key.spectra.shape[0]):
            rotation.blind_rotate_step(out, e32[:, j], key.spectra[j], mode, key.decomp,
                                       _cluster=cluster)
        return out

    def sweep(label, run, ref, steps, R, J, P, N, key_words_per_step, check_default,
              one_round=None):
        """Times run(C) for each cluster size the device schedules, in the
        turns SWEEP_TURNS, SWEEP_REPS runs each, holding every output
        against ref; prints the table and → {C: [ms of each run]}.  With
        one_round, also times one_round(C, rows) on the first `rows`
        ciphertexts, as many as the device holds at once in clusters of C
        (one round of blocks, so no partial last round), against ref[:rows]."""
        times, fit = {}, {}
        for c in dict.fromkeys(SWEEP_TURNS):
            active = rotation._active_clusters(rotation._variant_launch_plan(B, N, R, J, P, c),
                                               R, dev)
            print(f"{label}: clusters of {c} blocks at {rotation._working_set(N, R, J, P)} B "
                  f"each: {active} fit on the device at once")
            if active >= 1:
                times[c], fit[c] = [], min(active * c, B)
        for c in SWEEP_TURNS:
            if c not in times:
                continue
            out = {}
            times[c] += cuda_ms_reps(lambda: out.update(got=run(c)), SWEEP_REPS)
            hold(f"{label}, cluster {c}, batch {B}", out["got"], ref)
        mean = {c: sum(t) / len(t) for c, t in times.items()}
        spread = {c: max(t) - min(t) for c, t in times.items()}
        print(f"{tag} {label} cluster sweep, batch {B} ({SWEEP_REPS} runs per turn, turns "
              f"{SWEEP_TURNS}):")
        print("    C | ms (mean) | spread ms | ms per step | key MB per step (model)")
        for c in sorted(times):
            print(f"  {c:3d} | {mean[c]:9.3f} | {spread[c]:9.3f} | {mean[c] / steps:11.4f} | "
                  f"{key_words_per_step * 4 * B / c / 1e6:10.1f}")
        print(f"{label} runs (ms): {json.dumps(times)}")
        if one_round:
            rounds = {c: [] for c in times}
            for c in SWEEP_TURNS:
                if c not in times:
                    continue
                out = {}
                rounds[c] += cuda_ms_reps(lambda: out.update(got=one_round(c, fit[c])),
                                          SWEEP_REPS)
                hold(f"{label}, cluster {c}, batch {fit[c]} (one round)", out["got"],
                     ref[:fit[c]])
            print(f"{tag} {label}, one round of blocks per cluster size (the batch the "
                  f"device holds at once):")
            print("    C | batch | ms (mean) | spread ms | us per ciphertext and step")
            for c in sorted(rounds):
                t = rounds[c]
                m = sum(t) / len(t)
                print(f"  {c:3d} | {fit[c]:5d} | {m:9.3f} | {max(t) - min(t):9.3f} | "
                      f"{m * 1e3 / fit[c] / steps:10.5f}")
            print(f"{label} one-round runs (ms): {json.dumps(rounds)}")
        if check_default:
            d, best = rotation._CLUSTER, min(mean, key=mean.get)
            if d not in mean:
                raise AssertionError(f"the default cluster {d} cannot be scheduled")
            if mean[d] > mean[best] + max(spread[d], spread[best]):
                raise AssertionError(f"the default cluster {d} ({mean[d]:.3f} ms) is slower "
                                     f"than cluster {best} ({mean[best]:.3f} ms)")
            if mean[d] > mean[1] + spread[1]:
                raise AssertionError(f"the default cluster {d} is slower than C = 1")
            print(f"{label}: the default cluster {d} is the fastest measured, within the "
                  f"spread ({mean[d]:.3f} ms against C = {best}'s {mean[best]:.3f} ms; "
                  f"C = 1 {mean[1]:.3f} ms)")
        return times

    def random_spectra(plan, shape, axis):
        return torch.stack([torch.randint(0, p, shape, generator=g, device=dev,
                                          dtype=torch.int32) for p in plan.primes], dim=axis)

    def hold_steps(label, acc, exps, key_slice, mode, decomp):
        """One step kernel launch (K4 or K5, at the default cluster size)
        against the plain step on the same inputs; the exponent table is
        read through its batch stride."""
        e32 = exps.to(torch.int32)
        got = rotation.blind_rotate_step(acc.clone(), e32, key_slice, mode, decomp)
        torch.cuda.synchronize()
        return hold(label, got, rotation.blind_rotate_step_plain(acc.clone(), exps, key_slice,
                                                                 mode, decomp))

    top_bits = torch.tensor([-1, -(1 << 63), (1 << 63) - 1, 0], dtype=torch.int64, device=dev)

    def ks_ciphertexts(n_in, batch):
        """batch ciphertexts of n_in + 1 random words, the top-bit cases first."""
        ct = rng.uniform_torus(g, (batch, n_in + 1))
        ct.view(-1)[:4] = top_bits
        return ct

    def hold_keyswitch(label, sp, batches, worst=False, reps=10):
        """The decomposition pass and K2' at set sp's keyswitch shape (a
        random key made by `keyswitch.keyswitch_key`, as keygen makes it):
        held bit for bit at each batch (with worst, also every digit
        -2^(b-1), then 2^(b-1) - 1, against key bytes all 0xFF), then timed
        at batch B beside their bounds, with their plain versions and
        torch._int_mm; → the numbers."""
        n_in, L, M = sp.big_lwe_dimension, sp.ks_level, sp.lwe_dimension + 1
        K, decomp = n_in * L, sp.ks_decomp
        if keyswitch.digit_limbs(decomp.base_log) != 1:
            raise AssertionError(f"{label} does not take one-byte digits")
        ksk = keyswitch.keyswitch_key(rng.uniform_torus(g, (n_in, L, M)), decomp)
        key, Kp = ksk.data.reshape(K, M), ksk.limbs.shape[-1]
        err = {"tc": 0, "dec": 0}
        for batch in batches:
            ct = ks_ciphertexts(n_in, batch)
            mask, body = ct[:, :-1], ct[:, -1]
            d = keyswitch.decompose_digits(mask, decomp)
            torch.cuda.synchronize()
            err["dec"] = max(err["dec"], hold(
                f"decomposition pass {label}, batch {batch}, n_in {n_in}, base_log "
                f"{decomp.base_log}, {L} levels", d, keyswitch.decompose_digits_plain(mask, decomp)))
            per, splits = keyswitch._tc_plan(batch, M, Kp, sms,
                                             keyswitch.max_depth(decomp.base_log) // 64)
            got = keyswitch.neg_digit_mac_tensor_core(d, key, ksk.limbs, body, decomp.base_log)
            torch.cuda.synchronize()
            err["tc"] = max(err["tc"], hold(
                f"K2' {label}, batch {batch}, K={K}, M={M} (K in {splits} splits of {per} "
                f"steps)", got, keyswitch.neg_digit_mac_plain(d[:, :K], key, body)))
        if worst:
            ones = keyswitch.keyswitch_key(torch.full_like(ksk.data, -1), decomp)
            half, body = 1 << (decomp.base_log - 1), rng.uniform_torus(g, (B,))
            for v in (-half, half - 1):
                d = torch.full((B, Kp), v, dtype=torch.int8, device=dev)
                d[:, K:] = 0
                got = keyswitch.neg_digit_mac_tensor_core(d, ones.data.reshape(K, M), ones.limbs,
                                                          body, decomp.base_log)
                torch.cuda.synchronize()
                err["tc"] = max(err["tc"], hold(
                    f"K2' {label} worst case: every digit {v}, key bytes all 0xFF, batch {B}",
                    got, keyswitch.neg_digit_mac_plain(d[:, :K], ones.data.reshape(K, M), body)))
            del ones
        ct = ks_ciphertexts(n_in, B)
        mask, body = ct[:, :-1], ct[:, -1]
        d = keyswitch.decompose_digits(mask, decomp)
        d32 = signed_decompose(mask, decomp).reshape(B, K).to(torch.int32)
        res = {}
        tc_ms = cuda_ms(lambda: res.update(
            tc=keyswitch.neg_digit_mac_tensor_core(d, key, ksk.limbs, body, decomp.base_log)),
            reps)
        dec_ms = cuda_ms(lambda: keyswitch.decompose_digits(mask, decomp), reps)
        tc_plain_ms = cuda_ms(lambda: res.update(
            plain=keyswitch.neg_digit_mac_plain(d32, key, body)), 1)
        dec_plain_ms = cuda_ms(lambda: keyswitch.decompose_digits_plain(mask, decomp), 3)
        err["tc"] = max(err["tc"], hold(f"K2' {label}, batch {B} (timed)", res["tc"],
                                        res["plain"]))
        out = dict(err=err, tc_ms=tc_ms, tc_plain_ms=tc_plain_ms, dec_ms=dec_ms,
                   dec_plain_ms=dec_plain_ms, int_mm_ms=int_mm_ms(B, Kp, 8 * M, dev),
                   tc_bound=tc_bound(B, K, M, Kp, clock_hz, sms),
                   dec_bound=bound(decompose_ops(B, n_in, L), B * n_in * 8 + B * Kp, clock_hz,
                                   sms),
                   shape=f"{label} batch {B}, K={K}, M={M}", limbs=1)
        mm = out["int_mm_ms"]
        print(f"{tag} keyswitch {label} batch {B} (K={K}, M={M}, base_log {decomp.base_log}): "
              f"K2' {tc_ms:.4f} ms (bound {out['tc_bound'][0]:.4f} ms by "
              f"{out['tc_bound'][1]}), plain {tc_plain_ms:.3f} ms; decomposition pass "
              f"{dec_ms:.4f} ms (bound {out['dec_bound'][0]:.4f} ms by {out['dec_bound'][1]}), "
              f"plain {dec_plain_ms:.3f} ms; torch._int_mm [{B}, {Kp}] x "
              f"[{Kp}, {8 * M}] int8 " + (f"{mm:.4f} ms" if mm is not None else "not measured"))
        return out

    def hold_wide_keyswitch(label, sp, batches, plain_batch, reps=3):
        """The pass and K2' at set sp's keyswitch shape, base_log > 8 (digits
        of 2, 3 or 4 byte limbs; a random key made by
        `keyswitch.keyswitch_key`): held bit for bit at each batch against
        the torch decomposition and the plain contraction, `keyswitch_lwe`
        once (one pass and one K2' launch), then timed at batch B beside
        the tensor-core bound and the CUDA-core bound the retired wide form
        was held to, the plain contraction timed (and held) at plain_batch,
        torch._int_mm at [B, D*Kp] x [D*Kp, 8M]; → the numbers."""
        n_in, L, M = sp.big_lwe_dimension, sp.ks_level, sp.lwe_dimension + 1
        K, decomp = n_in * L, sp.ks_decomp
        D = keyswitch.digit_limbs(decomp.base_log)
        if D == 1 or not keyswitch.tensor_core_form(decomp.base_log):
            raise AssertionError(f"{label} does not take digits of several byte limbs")
        ksk = keyswitch.keyswitch_key(rng.uniform_torus(g, (n_in, L, M)), decomp)
        key, Kp = ksk.data.reshape(K, M), ksk.limbs.shape[-1]
        err = {"tc": 0, "dec": 0}
        for batch in batches:
            ct = ks_ciphertexts(n_in, batch)
            mask, body = ct[:, :-1], ct[:, -1]
            d = keyswitch.decompose_digits(mask, decomp)
            torch.cuda.synchronize()
            err["dec"] = max(err["dec"], hold(
                f"decomposition pass {label}, batch {batch}, n_in {n_in}, base_log "
                f"{decomp.base_log}, {L} levels, {D} digit limbs", d,
                keyswitch.decompose_digits_plain(mask, decomp)))
            per, splits = keyswitch._tc_plan(batch, M, Kp, sms,
                                             keyswitch.max_depth(decomp.base_log) // 64)
            got = keyswitch.neg_digit_mac_tensor_core(d, key, ksk.limbs, body, decomp.base_log)
            want = keyswitch.neg_digit_mac_plain(
                signed_decompose(mask, decomp).reshape(batch, K), key, body)
            torch.cuda.synchronize()
            err["tc"] = max(err["tc"], hold(
                f"K2' {label}, batch {batch}, K={K}, M={M}, {D} digit limbs (K in {splits} "
                f"splits of {per} steps)", got, want))
        before = (keyswitch.launches, keyswitch.decompose_launches)
        got = keyswitch.keyswitch_lwe(LweCiphertext(data=ct), ksk)
        ran = [a - b for a, b in zip((keyswitch.launches, keyswitch.decompose_launches), before)]
        if ran != [1, 1]:
            raise AssertionError(f"{label}: keyswitch_lwe launched {ran} (K2', pass)")
        err["tc"] = max(err["tc"], hold(f"keyswitch_lwe {label}, batch {ct.shape[0]}", got.data,
                                        want))
        del d, got, want
        ct = ks_ciphertexts(n_in, B)
        mask, body = ct[:, :-1], ct[:, -1]
        d = keyswitch.decompose_digits(mask, decomp)
        res = {}
        tc_ms = cuda_ms(lambda: res.update(tc=keyswitch.neg_digit_mac_tensor_core(
            d, key, ksk.limbs, body, decomp.base_log)), reps)
        dec_ms = cuda_ms(lambda: keyswitch.decompose_digits(mask, decomp), reps)
        pb = min(plain_batch, B)
        d64 = signed_decompose(mask[:pb], decomp).reshape(pb, K)
        tc_plain_ms = cuda_ms(lambda: res.update(
            plain=keyswitch.neg_digit_mac_plain(d64, key, body[:pb])), 1)
        dec_plain_ms = cuda_ms(lambda: keyswitch.decompose_digits_plain(mask, decomp), 1)
        err["tc"] = max(err["tc"], hold(f"K2' {label}, batch {B} (timed; the first {pb} rows)",
                                        res["tc"][:pb], res["plain"]))
        out = dict(err=err, tc_ms=tc_ms, tc_plain_ms=tc_plain_ms, plain_batch=pb, dec_ms=dec_ms,
                   dec_plain_ms=dec_plain_ms, int_mm_ms=int_mm_ms(B, D * Kp, 8 * M, dev),
                   tc_bound=tc_bound(B, K, M, Kp, clock_hz, sms, D),
                   cuda_core_bound=cuda_core_bound(B, K, M, clock_hz, sms),
                   dec_bound=bound(decompose_ops(B, n_in, L, D), B * n_in * 8 + B * D * Kp,
                                   clock_hz, sms),
                   shape=f"{label} batch {B}, K={K}, M={M}, base_log {decomp.base_log}",
                   limbs=D)
        mm = out["int_mm_ms"]
        print(f"{tag} keyswitch {label} batch {B} (K={K}, M={M}, base_log {decomp.base_log}, "
              f"{D} digit limbs): K2' {tc_ms:.4f} ms (bound {out['tc_bound'][0]:.4f} ms by "
              f"{out['tc_bound'][1]}, {out['tc_bound'][0] / tc_ms:.1%}; the CUDA-core bound "
              f"{out['cuda_core_bound'][0]:.4f} ms), plain {tc_plain_ms:.3f} ms at batch {pb}; "
              f"decomposition pass {dec_ms:.4f} ms (bound {out['dec_bound'][0]:.4f} ms by "
              f"{out['dec_bound'][1]}), plain {dec_plain_ms:.3f} ms; torch._int_mm "
              f"[{B}, {D * Kp}] x [{D * Kp}, {8 * M}] int8 "
              + (f"{mm:.4f} ms" if mm is not None else "not measured"), flush=True)
        del ksk, key, ct, mask, body, d, d64, res
        return out

    if args.ks:
        # the first check of a keyswitch change: phases 3, 3b and 3f's holds
        lap("3, 3b and 3f: the keyswitch alone")
        ks = {CLASSIC: hold_keyswitch(CLASSIC, shortint_params(CLASSIC), (1, 8, B, B + 1),
                                      worst=True)}
        for name in (GROUP_3, GROUP_2):
            ks[name] = hold_keyswitch(name, shortint_params(name), (1, 8, B, B + 1))
        for name in LARGE_KS_SETS:
            ks[name] = hold_keyswitch(name, shortint_params(name), (8, B), reps=3)
            torch.cuda.empty_cache()
        for name, batches, plain_batch in WIDE_KS_SETS:
            ks[name] = hold_wide_keyswitch(
                name, wopbs_params(name) if name.startswith("WOPBS") else shortint_params(name),
                batches, plain_batch)
            torch.cuda.empty_cache()
        print(json.dumps({"keyswitch": {k: {f: v for f, v in r.items() if f != "err"}
                                        for k, r in ks.items()}}))
        return 0

    lap("3")
    # ---- 3. K1 and the keyswitch against their plain versions, 2_2 widths ---
    params = shortint_params(CLASSIC)
    n, N, R, J, P, plan = widths(params)
    key = NttBootstrapKey(spectra=random_spectra(plan, (n, J, R, N), 1),
                          decomp=params.pbs_decomp, primes=plan.primes)

    def rot_inputs(batch):
        return (rng.uniform_torus(g, (batch, R, N)),
                torch.randint(0, 2 * N, (batch, n), generator=g, device=dev))

    k1_err = 0
    for batch in (1, 6, 8, B + 1):
        acc, exps = rot_inputs(batch)
        got = rotation.rotate_accumulator(acc, exps, key)
        torch.cuda.synchronize()
        k1_err = max(k1_err, hold(f"K1 blind rotation, batch {batch}, {n} steps", got,
                                  rotation.blind_rotate_plain(acc, exps, key)))
    for name in K1_SHAPES:
        sp = boolean_params(name) if name.startswith("DEFAULT") else shortint_params(name)
        sn, sN, sR, sJ, sP, splan = widths(sp)
        skey = NttBootstrapKey(spectra=random_spectra(splan, (sn, sJ, sR, sN), 1),
                               decomp=sp.pbs_decomp, primes=splan.primes)
        sacc = rng.uniform_torus(g, (8, sR, sN))
        sexps = torch.randint(0, 2 * sN, (8, sn), generator=g, device=dev)
        lay = rotation._delta_layout(sN, sR, sJ, sP)
        got = rotation.rotate_accumulator(sacc, sexps, skey)
        torch.cuda.synchronize()
        k1_err = max(k1_err, hold(
            f"K1 blind rotation {name} (N={sN}, R={sR}, J={sJ}, P={sP}; head {lay.head}, "
            f"tail {lay.tail}, rt {lay.rt}), batch 8, {sn} steps", got,
            rotation.blind_rotate_plain(sacc, sexps, skey)))
        if name == "PARAM_MESSAGE_1_CARRY_1_KS_PBS":
            k4_1_1 = (f"K4 delta step {name}, batch 8", sacc, sexps[:, 5], skey.spectra[5],
                      skey.decomp)
        bacc = rng.uniform_torus(g, (B, sR, sN))
        bexps = torch.randint(0, 2 * sN, (B, sn), generator=g, device=dev)
        t = cuda_ms(lambda: rotation.rotate_accumulator(bacc, bexps, skey), 3)
        print(f"K1 {name} batch {B}: kernel {t:.3f} ms, {t / sn:.5f} ms a step")
        del skey, sacc, sexps, got, bacc, bexps

    ks = {CLASSIC: hold_keyswitch(CLASSIC, params, (1, 8, B, B + 1), worst=True)}
    # the b = 8 edge: the deepest K (in rows of 16 bytes) the tensor-core
    # form takes, every limb sum 2^31 - 32768 in magnitude
    K8, M8 = 65792, 65
    if not K8 <= keyswitch.max_depth(8) < K8 + 16:
        raise AssertionError(f"K = {K8} is not the deepest unsplit shape at b = 8")
    key8 = torch.full((K8, M8), -1, dtype=torch.int64, device=dev)
    limbs8, body8 = keyswitch.limb_layout(key8), rng.uniform_torus(g, (B + 1,))
    for v in (-128, 127):
        d8 = torch.full((B + 1, K8), v, dtype=torch.int8, device=dev)
        got = keyswitch.neg_digit_mac_tensor_core(d8, key8, limbs8, body8, 8)
        torch.cuda.synchronize()
        ks[CLASSIC]["err"]["tc"] = max(ks[CLASSIC]["err"]["tc"], hold(
            f"K2' worst case at b = 8: every digit {v}, key bytes all 0xFF, K={K8}, M={M8}, "
            f"batch {B + 1}", got, keyswitch.neg_digit_mac_plain(d8, key8, body8)))
    del key8, limbs8, body8, d8

    acc, exps = rot_inputs(B)
    outs = {}
    k1_ms = cuda_ms(lambda: outs.update(kernel=rotation.rotate_accumulator(acc, exps, key)), 3)
    k1_plain_ms = cuda_ms(lambda: outs.update(plain=rotation.blind_rotate_plain(acc, exps, key)),
                          1)
    k1_err = max(k1_err, hold(f"K1 blind rotation, batch {B}, {n} steps", outs["kernel"],
                              outs["plain"]))
    print(f"{tag} K1 batch {B}: kernel {k1_ms:.3f} ms ({k1_ms / n:.5f} ms per step), plain "
          f"{k1_plain_ms:.3f} ms (the earlier radix-2 body: {EARLIER_K1_MS} ms)")
    lay = rotation._delta_layout(N, R, J, P)
    held = rotation._delta_active_blocks(lay, dev)
    print(f"{tag} K1, one round of blocks ({held} blocks of {lay.smem} B fit on the device "
          f"at once; K3's rows are in phase 3b'):")
    print("    batch | ms (mean) | spread ms | us per ciphertext and step")
    for rows in (min(held, B), 16):
        t = cuda_ms_reps(lambda: outs.update(round=rotation.rotate_accumulator(
            acc[:rows], exps[:rows], key)), SWEEP_REPS)
        hold(f"K1 one round, batch {rows}", outs["round"], outs["plain"][:rows])
        m = sum(t) / len(t)
        print(f"    {rows:5d} | {m:9.3f} | {max(t) - min(t):9.3f} | {m * 1e3 / rows / n:10.5f}")
    k1_bound = bound(k1_mults(B, n, P, J, R, N, lay.chunks),
                     key.spectra.numel() * 4 + 2 * B * R * N * 8 + B * n * 4 + 8 * P * N * 4,
                     clock_hz, sms)

    lap("3c classic")
    # ---- 3c (classic). K4 and the paired K5 at full 2_2 widths --------------
    k4_err = k5_err = 0
    pkey = bootstrap_key_to_ntt_paired(key)
    for batch in K5_BATCHES:
        a1, e1 = rot_inputs(batch)
        k4_err = max(k4_err, hold_steps(f"K4 delta step, batch {batch}", a1, e1[:, 5],
                                        key.spectra[5], "delta", key.decomp))
        k5_err = max(k5_err, hold_steps(f"K5 paired step, batch {batch}", a1, e1[:, 5:6],
                                        pkey.spectra[5], "variants", key.decomp))
    label, a1, e1, kslice, kdecomp = k4_1_1
    k4_err = max(k4_err, hold_steps(label, a1, e1, kslice, "delta", kdecomp))
    del k4_1_1, a1, e1, kslice
    k4_ms = cuda_ms(lambda: outs.update(steps=rotation.rotate_steps(acc.clone(), exps, key)), 3)
    k4_err = max(k4_err, hold(f"K4 per-step rotation, batch {B}, {n} launches", outs["steps"],
                              outs["plain"]))
    hold(f"K4 per-step rotation, batch {B}, {n} launches", outs["steps"], outs["kernel"],
         "K1 on the same inputs")
    k5p_ms = cuda_ms(lambda: outs.update(paired=rotation.rotate_steps(acc.clone(), exps, pkey)),
                     3)
    k5p_plain_ms = cuda_ms(lambda: outs.update(
        paired_plain=rotation.blind_rotate_plain(acc, exps, pkey)), 1)
    k5_err = max(k5_err, hold(f"K5 paired per-step rotation, batch {B}, {n} launches",
                              outs["paired"], outs["paired_plain"]))
    print(f"{tag} K4 per-step rotation batch {B}: {k4_ms:.3f} ms ({k4_ms / n:.5f} ms per "
          f"launch; the earlier radix-2 body: {EARLIER_K4_MS} ms), plain {k1_plain_ms:.3f} ms (the "
          f"plain rotation, timed above)")
    print(f"{tag} K5 paired per-step rotation batch {B}: {k5p_ms:.3f} ms "
          f"({k5p_ms / n:.4f} ms per launch), plain {k5p_plain_ms:.3f} ms")
    k4_bound = bound(k1_mults(B, n, P, J, R, N, lay.chunks),
                     step_bytes(n, 1, P, J, R, N, 1) + 8 * P * N * 4, clock_hz, sms)
    k5p_bound = bound(k3_mults(B, n, 2, P, J, R, N),
                      step_bytes(n, 2, P, J, R, N, 1) + 12 * P * N * 4, clock_hz, sms)
    sweep("K5 paired per-step rotation", lambda c: steps_at(acc, exps, pkey, c),
          outs["paired_plain"], n, R, J, P, N, 2 * P * J * R * N, False)
    del key, pkey, acc, exps, got, outs

    lap("3b")
    # ---- 3b. K3 against its plain version, GROUP_2 and GROUP_3 widths -------
    # ---- 3c (GROUP_3). K5 over a multi-bit key; the keyswitch at the multi-bit shapes
    k3 = {}
    for name in (GROUP_2, GROUP_3):
        mp = shortint_params(name)
        n, N, R, J, P, plan = widths(mp)
        gf, V = mp.grouping_factor, 1 << mp.grouping_factor
        mkey = NttMultiBitBootstrapKey(spectra=random_spectra(plan, (n // gf, V, J, R, N), 2),
                                       decomp=mp.pbs_decomp, primes=plan.primes,
                                       grouping_factor=gf)
        label = f"K3 multi-bit rotation GROUP_{gf}"
        err = 0

        def mb_inputs(batch):
            exps = torch.randint(0, 2 * N, (batch, n), generator=g, device=dev)
            return (rng.uniform_torus(g, (batch, R, N)),
                    rotation.variant_exponents(exps, gf, N))

        for batch in (1, 6, 8, B + 1):
            acc, cexp = mb_inputs(batch)
            got = rotation.rotate_accumulator_multi_bit(acc, cexp, mkey)
            torch.cuda.synchronize()
            err = max(err, hold(f"{label}, batch {batch}, {n // gf} steps", got,
                                rotation.blind_rotate_multi_bit_plain(acc, cexp, mkey)))
        acc, cexp = mb_inputs(B)
        outs = {}
        ms = cuda_ms(lambda: outs.update(
            kernel=rotation.rotate_accumulator_multi_bit(acc, cexp, mkey)), 3)
        plain_ms = cuda_ms(lambda: outs.update(
            plain=rotation.blind_rotate_multi_bit_plain(acc, cexp, mkey)), 1)
        err = max(err, hold(f"{label}, batch {B}, {n // gf} steps", outs["kernel"],
                            outs["plain"]))
        print(f"{tag} K3 GROUP_{gf} batch {B}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        k3[gf] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound(
            k3_mults(B, n // gf, V, P, J, R, N),
            mkey.spectra.numel() * 4 + 2 * B * R * N * 8 + B * (n // gf) * (V - 1) * 4
            + 12 * P * N * 4, clock_hz, sms))
        if gf == 3:
            # ---- 3b'. the cluster sweep ------------------------------------
            sweep("K3 GROUP_3", lambda c: rotation.rotate_accumulator_multi_bit(
                acc, cexp, mkey, _cluster=c), outs["plain"], n // gf, R, J, P, N,
                  V * P * J * R * N, True,
                  lambda c, rows: rotation.rotate_accumulator_multi_bit(
                      acc[:rows], cexp[:rows], mkey, _cluster=c))
            sweep("K5 GROUP_3 per-step rotation", lambda c: steps_at(acc, cexp, mkey, c),
                  outs["plain"], n // gf, R, J, P, N, V * P * J * R * N, False)
            for batch in K5_BATCHES:
                a1, c1 = mb_inputs(batch)
                k5_err = max(k5_err, hold_steps(f"K5 GROUP_3 step, batch {batch}", a1,
                                                c1[:, 7], mkey.spectra[7], "variants",
                                                mkey.decomp))
            k5m_ms = cuda_ms(lambda: outs.update(
                steps=rotation.rotate_steps(acc.clone(), cexp, mkey)), 3)
            k5_err = max(k5_err, hold(f"K5 GROUP_3 per-step rotation, batch {B}, "
                                      f"{n // gf} launches", outs["steps"], outs["plain"]))
            hold(f"K5 GROUP_3 per-step rotation, batch {B}, {n // gf} launches", outs["steps"],
                 outs["kernel"], "K3 on the same inputs")
            print(f"{tag} K5 GROUP_3 per-step rotation batch {B}: {k5m_ms:.3f} ms "
                  f"({k5m_ms / (n // gf):.4f} ms per launch), plain {plain_ms:.3f} ms "
                  f"(K3's plain version, timed above)")
            k5m_bound = bound(k3_mults(B, n // gf, V, P, J, R, N),
                              step_bytes(n // gf, V, P, J, R, N, V - 1) + 12 * P * N * 4,
                              clock_hz, sms)
            k5m_plain_ms = plain_ms
        # the pass and K2' at this set's keyswitch shape
        ks[name] = hold_keyswitch(name, mp, (1, 8, B, B + 1))
        del mkey, acc, cexp, got, outs

    lap("3d")
    # ---- 3d. K6, the staged step, at the shapes beyond one block ------------
    def staged_key(sp, steps):
        """A random key of `steps` steps at the widths of set sp (classic or
        multi-bit)."""
        sn, sN, sR, sJ, sP, splan = widths(sp)
        gf = getattr(sp, "grouping_factor", None)
        if gf:
            return NttMultiBitBootstrapKey(
                spectra=random_spectra(splan, (steps, 1 << gf, sJ, sR, sN), 2),
                decomp=sp.pbs_decomp, primes=splan.primes, grouping_factor=gf)
        return NttBootstrapKey(spectra=random_spectra(splan, (steps, sJ, sR, sN), 1),
                               decomp=sp.pbs_decomp, primes=splan.primes)

    def rotation_inputs(key, batch, steps):
        """(acc, exponents) for `steps` steps of key (variant exponents for a
        multi-bit key)."""
        sR, sN = key.spectra.shape[-2], key.spectra.shape[-1]
        acc = rng.uniform_torus(g, (batch, sR, sN))
        if isinstance(key, NttMultiBitBootstrapKey):
            gf = key.grouping_factor
            e = torch.randint(0, 2 * sN, (batch, steps * gf), generator=g, device=dev)
            return acc, rotation.variant_exponents(e, gf, sN)
        return acc, torch.randint(0, 2 * sN, (batch, steps), generator=g, device=dev)

    def rotate(key, acc, exps, **kw):
        """The whole-rotation wrapper for key's type (K1/K3, or K6 by shape)."""
        if isinstance(key, NttMultiBitBootstrapKey):
            return rotation.rotate_accumulator_multi_bit(acc, exps, key, **kw)
        return rotation.rotate_accumulator(acc, exps, key, **kw)

    def first_steps(key, steps):
        return dataclasses.replace(key, spectra=key.spectra[:steps])

    def rotate_form(key, acc, exps, form):
        """K6 over every step of key in the form asked for ("passes", or
        (C, group) for the cluster step), through `_staged_rotate` as the
        wrappers call it; → a new accumulator."""
        gf = getattr(key, "grouping_factor", None)
        P, J, R, N = key.spectra.shape[-4:]
        lay = rotation._k6_layout(N, R, J, P, 1 << gf if gf else 0, form)
        plan = ntt.get_plan(N, P)
        out = acc.contiguous().clone()
        rotation._staged_rotate(out, exps.to(torch.int32).contiguous(),
                                (1 << gf) - 1 if gf else 1, key.spectra.contiguous(),
                                key.decomp, gf or 0, key.spectra.shape[0], lay, plan,
                                rotation._delta_tables(plan, acc.device, bool(gf)),
                                rotation._host_consts(plan))
        return out

    def hold_rotation(label, key, batch, steps, **kw):
        """The wrapper over the key's first `steps` steps against the plain
        rotation on the same inputs; → max_abs_err."""
        sub = first_steps(key, steps)
        acc, exps = rotation_inputs(sub, batch, steps)
        got = rotate(sub, acc, exps, **kw)
        torch.cuda.synchronize()
        return hold(f"{label}, batch {batch}, {steps} steps", got,
                    rotation.blind_rotate_plain(acc, exps, sub))

    def k6_counts():
        return (rotation.cluster_launches, rotation.cluster_variant_launches,
                rotation.staged_launches)

    def k6_layout(sp):
        """K6's form for set sp, by the shape rule: its layout and its name."""
        sn, sN, sR, sJ, sP, splan = widths(sp)
        gf = getattr(sp, "grouping_factor", None)
        lay = rotation._k6_layout(sN, sR, sJ, sP, 1 << gf if gf else 0)
        if isinstance(lay, rotation.ClusterLayout):
            return lay, (f"the cluster step: clusters of {lay.cluster}, primes in groups of "
                         f"{lay.group}, region head {lay.head}, tail {lay.tail}, {lay.smem} B "
                         f"a block")
        return lay, (f"the passes form: head {lay.head}, tail {lay.tail}, {lay.launches} "
                     f"launches a step, {lay.warps} regions a block, {lay.smem} B")

    def k6_bound(batch, steps, gf, sP, sJ, sR, sN, key_words, e_words):
        """K6's bound over `steps` steps, the same for both forms: the key
        once, the accumulator in and out once, the exponents, the tables."""
        return bound((k3_mults(batch, steps, 1 << gf, sP, sJ, sR, sN) if gf else
                      k1_mults(batch, steps, sP, sJ, sR, sN, 1)),
                     key_words * 4 + 2 * batch * sR * sN * 8 + e_words * 4 + 8 * sP * sN * 4,
                     clock_hz, sms)

    # kinds: the cluster step's delta and variant steps, the passes form
    k6 = {kind: {"err": 0, "shapes": []} for kind in ("delta", "variants", "passes")}
    for name, batches in K6_SETS + K6_MB_SETS:
        sp = shortint_params(name)
        sn, sN, sR, sJ, sP, splan = widths(sp)
        gf = getattr(sp, "grouping_factor", None)
        steps = sn // gf if gf else sn
        full = STEPS_65536 if sN == 65536 else steps
        cut = min(CUT_STEPS, full)
        if rotation._rotation_route(sN, sR, sJ, sP) != "staged":
            raise AssertionError(f"{name} does not take K6")
        lay, form = k6_layout(sp)
        cluster = isinstance(lay, rotation.ClusterLayout)
        kind = ("variants" if gf else "delta") if cluster else "passes"
        key = staged_key(sp, full)
        print(f"{tag} K6 {kind} {name} (N={sN}, R={sR}, J={sJ}, P={sP}; {form}), key "
              f"{key.spectra.numel() * 4 / 1e9:.2f} GB for {full} of {steps} steps"
              + (f" (cut: the full key is {steps * key.spectra[0].numel() * 4 / 1e9:.2f} GB)"
                 if full < steps else ""))
        for batch in batches:
            before = k6_counts()
            depth = full if batch == 8 else cut
            k6[kind]["err"] = max(k6[kind]["err"], hold_rotation(
                f"K6 {kind} {name}", key, batch, depth))
            ran = [a - b for a, b in zip(k6_counts(), before)]
            if cluster:
                want = [0, depth, 0] if gf else [depth, 0, 0]
            else:
                want = [0, 0, depth * lay.launches
                        * len(rotation._staged_tiles(batch, sN, sR, sJ, sP))]
            if ran != want:
                raise AssertionError(f"K6 launches {ran}, expected {want}")
        if not cluster:
            # the passes form at the one set it serves: batch 8, every step held above
            acc, exps = rotation_inputs(key, 8, full)
            out = {}
            ms = cuda_ms(lambda: out.update(kernel=rotate(key, acc, exps)), 3)
            plain_ms = cuda_ms(lambda: out.update(
                plain=rotation.blind_rotate_plain(acc, exps, key)), 1)
            k6[kind]["err"] = max(k6[kind]["err"], hold(
                f"K6 passes {name}, batch 8, {full} steps (timed)", out["kernel"], out["plain"]))
            bnd = k6_bound(8, full, 0, sP, sJ, sR, sN, key.spectra.numel(), exps.numel())
            print(f"{tag} K6 passes {name} batch 8, {full} steps: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms by {bnd[1]}")
            k6[kind].update(ms=ms, plain_ms=plain_ms, bound=bnd)
            k6[kind]["shapes"].append((f"{name} batch 8, {full} steps", ms, plain_ms, bnd))
            del acc, exps, out
        if name in (CLASSIC_33, GROUP_3_33, CLASSIC_44):
            acc, exps = rotation_inputs(key, B, full)
            rotate(key, acc, exps)
            t = cuda_ms(lambda: rotate(key, acc, exps), 2 if name == CLASSIC_44 else 3)
            sub = first_steps(key, cut)
            bnd = k6_bound(B, full, gf, sP, sJ, sR, sN, key.spectra.numel(), exps.numel())
            print(f"{tag} K6 {kind} {name} batch {B}: {t:.3f} ms over {full} steps "
                  f"({t / full:.4f} ms a step), bound {bnd[0]:.3f} ms by {bnd[1]}")
            k6[kind]["shapes"].append((f"{name} batch {B}, {full} steps", t, None, bnd))
            if name != CLASSIC_44:
                # the kernels line's numbers: K6 and plain on the same inputs, cut
                acc, exps = acc, exps[:, :cut]
                out = {}
                ms = cuda_ms(lambda: out.update(kernel=rotate(sub, acc, exps)), 3)
                plain_ms = cuda_ms(lambda: out.update(
                    plain=rotation.blind_rotate_plain(acc, exps, sub)), 1)
                k6[kind]["err"] = max(k6[kind]["err"], hold(
                    f"K6 {kind} {name}, batch {B}, {cut} steps (timed)", out["kernel"],
                    out["plain"]))
                bnd = k6_bound(B, cut, gf, sP, sJ, sR, sN, sub.spectra.numel(), exps.numel())
                print(f"{tag} K6 {kind} {name} batch {B}, {cut} steps: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms")
                k6[kind].update(ms=ms, plain_ms=plain_ms, bound=bnd, label=(
                    f"{name} batch {B}, {cut} steps (plain timed on the same cut)"))
                k6[kind]["shapes"].append((k6[kind]["label"], ms, plain_ms, bnd))
            del acc, exps, sub
        if name == CLASSIC_33:
            # K6 one step on the per-step routes: delta (K4's) and paired (K5's),
            # held, then timed over `cut` launches beside its bound
            pk = bootstrap_key_to_ntt_paired(first_steps(key, cut))
            for batch in (8, B + 1):
                a1, e1 = rotation_inputs(key, batch, 1)
                k6["delta"]["err"] = max(k6["delta"]["err"], hold_steps(
                    f"K6 delta one step {name}, batch {batch}", a1, e1[:, 0],
                    key.spectra[0], "delta", key.decomp))
                k6["variants"]["err"] = max(k6["variants"]["err"], hold_steps(
                    f"K6 paired one step {name}, batch {batch}", a1, e1[:, :1],
                    pk.spectra[0], "variants", key.decomp))
            acc, exps = rotation_inputs(key, B, cut)
            for kk, label, skey, V in (("delta", "delta", first_steps(key, cut), 1),
                                        ("variants", "paired", pk, 2)):
                out = {}
                before = k6_counts()
                ms = cuda_ms(lambda: out.update(got=rotation.rotate_steps(acc.clone(), exps,
                                                                          skey)), 3)
                ran = [a - b for a, b in zip(k6_counts(), before)]
                if ran != ([0, 3 * cut, 0] if V == 2 else [3 * cut, 0, 0]):
                    raise AssertionError(f"K6 one step {label}: launches {ran}")
                plain_ms = cuda_ms(lambda: out.update(
                    plain=rotation.blind_rotate_plain(acc, exps, skey)), 1)
                k6[kk]["err"] = max(k6[kk]["err"], hold(
                    f"K6 {label} one step a launch {name}, batch {B}, {cut} launches (timed)",
                    out["got"], out["plain"]))
                bnd = bound((k3_mults(B, cut, V, sP, sJ, sR, sN) if V == 2 else
                             k1_mults(B, cut, sP, sJ, sR, sN, 1)),
                            step_bytes(cut, V, sP, sJ, sR, sN, 1) + 8 * sP * sN * 4, clock_hz,
                            sms)
                print(f"{tag} K6 {label} one step a launch (per-step route) {name} batch {B}: "
                      f"{ms:.3f} ms over {cut} launches ({ms / cut:.4f} ms a launch), plain "
                      f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms by {bnd[1]}")
                k6[kk]["shapes"].append((f"{name} {label}, one step a launch (per-step "
                                         f"route), batch {B}, {cut} launches", ms, plain_ms,
                                         bnd))
            del pk, a1, e1, acc, exps, out
        del key
    torch.cuda.empty_cache()

    # K6 forced at 2_2 against block-resident K1 on the same inputs
    key = staged_key(params, params.lwe_dimension)
    acc, exps = rotation_inputs(key, 8, params.lwe_dimension)
    hold(f"K6 forced (_staged=True) at {CLASSIC}, batch 8, {params.lwe_dimension} steps",
         rotation.rotate_accumulator(acc, exps, key, _staged=True),
         rotation.rotate_accumulator(acc, exps, key), "K1 on the same inputs")
    del key, acc, exps

    lap("3d'")
    # ---- 3d'. K6's cluster sweep ----------------------------------------------
    k6_sweep = {}
    for name, steps, forms in K6_SWEEP:
        sp = shortint_params(name)
        sn, sN, sR, sJ, sP, splan = widths(sp)
        gf = getattr(sp, "grouping_factor", None)
        lay, _ = k6_layout(sp)
        rule = (lay.cluster, lay.group) if isinstance(lay, rotation.ClusterLayout) else "passes"
        if rule != forms[0]:
            raise AssertionError(f"{name}: the rule gives {rule}, the sweep starts at {forms[0]}")
        key = staged_key(sp, steps)
        acc, exps = rotation_inputs(key, B, steps)
        rows = 8 if sN == 65536 else B   # the plain rotation's memory at N = 65536
        ref = rotation.blind_rotate_plain(acc[:rows], exps[:rows], key)
        times, first = {f: [] for f in forms}, {}
        for f in list(forms) + list(forms[::-1]):
            out = {}
            times[f] += cuda_ms_reps(lambda: out.update(got=rotate_form(key, acc, exps, f)),
                                     SWEEP_REPS)
            hold(f"K6 {name} form {f}, batch {B}, {steps} steps", out["got"][:rows], ref)
            if "got" in first:
                hold(f"K6 {name} form {f}, batch {B}, {steps} steps", out["got"],
                     first["got"], f"form {forms[0]}")
            else:
                first["got"] = out["got"]
        mean = {f: sum(t) / len(t) for f, t in times.items()}
        spread = {f: max(t) - min(t) for f, t in times.items()}
        print(f"{tag} K6 {name} forms, batch {B}, {steps} steps ({SWEEP_REPS} runs a turn, "
              f"turns there and back; the rule gives {rule}):")
        print("    form      | smem B a block | ms (mean) | spread ms | ms a step")
        for f in forms:
            smem = rotation._k6_layout(sN, sR, sJ, sP, 1 << gf if gf else 0, f).smem
            print(f"    {str(f):9s} | {smem:14d} | {mean[f]:9.3f} | {spread[f]:9.3f} | "
                  f"{mean[f] / steps:9.4f}")
        ranked = sorted(mean, key=mean.get)
        print(f"    fastest first: {', '.join(str(f) for f in ranked)}; the rule's form "
              f"{rule} ranks {ranked.index(rule) + 1} of {len(ranked)}")
        k6_sweep[name] = {str(f): t for f, t in times.items()}
        print(f"K6 {name} sweep runs (ms): {json.dumps(k6_sweep[name])}")
        del key, acc, exps, ref, first, out
    torch.cuda.empty_cache()

    lap("3e")
    # ---- 3e. more than 15 digit rows: K1, K4 and the paired K5 --------------
    for name in WIDE_SETS:
        sp = gadget_params(name) if name.startswith("AES") else wopbs_params(name)
        sn, sN, sR, sJ, sP, splan = widths(sp)
        if sJ <= 15:
            raise AssertionError(f"{name} has J = {sJ}")
        key = staged_key(sp, sn)
        pk = bootstrap_key_to_ntt_paired(first_steps(key, 1))
        lay = rotation._delta_layout(sN, sR, sJ, sP)
        for batch in (8, B):
            k1_err = max(k1_err, hold_rotation(f"K1 J={sJ} {name}", key, batch,
                                               sn if batch == 8 else CUT_STEPS))
            a1, e1 = rotation_inputs(key, batch, 1)
            k4_err = max(k4_err, hold_steps(f"K4 J={sJ} {name}, batch {batch}", a1, e1[:, 0],
                                            key.spectra[0], "delta", key.decomp))
            k5_err = max(k5_err, hold_steps(f"K5 paired J={sJ} {name}, batch {batch}", a1,
                                            e1[:, :1], pk.spectra[0], "variants", key.decomp))
        acc, exps = rotation_inputs(key, B, sn)
        t = cuda_ms(lambda: rotation.rotate_accumulator(acc, exps, key), 3)
        print(f"{tag} K1 J={sJ} {name} (N={sN}, R={sR}, P={sP}, rt {lay.rt}) batch {B}: "
              f"{t:.3f} ms over {sn} steps ({t / sn:.5f} ms a step)")
        del key, pk, acc, exps, a1, e1
    torch.cuda.empty_cache()

    lap("3f")
    # ---- 3f. the keyswitch at the large shapes; digits of several limbs -----
    for name in LARGE_KS_SETS:
        ks[name] = hold_keyswitch(name, shortint_params(name), (8, B), reps=3)
        torch.cuda.empty_cache()
    ks_wide = {}
    for name, batches, plain_batch in WIDE_KS_SETS:
        ks_wide[name] = hold_wide_keyswitch(
            name, wopbs_params(name) if name.startswith("WOPBS") else shortint_params(name),
            batches, plain_batch)
        torch.cuda.empty_cache()

    def check_requests(ck, outs, expect, path, seconds, batch=B):
        right = 0
        for i, (out, want) in enumerate(zip(outs, expect)):
            if tuple(out.lwe.data.shape) != (batch, ck.params.big_lwe_dimension + 1):
                raise AssertionError(f"{path} request {i + 1}: shape "
                                     f"{tuple(out.lwe.data.shape)}")
            ok = int((ck.decrypt(out).cpu() == want).sum())
            right += ok
            print(f"{path} request {i + 1}: {ok}/{batch} decrypt right")
        print(f"{tag} {path} path: {right}/{len(outs) * batch} right, {len(outs)} requests in "
              f"{seconds:.3f} s (first-call costs included)")
        if right != len(outs) * batch:
            raise AssertionError(f"decryption mismatch on the {path} path")

    def hold_cpu_path(sk, ct, lut_fn, out, path, small=4):
        """The first request on `small` ciphertexts through the plain path on
        CPU tensors (what the CPU tests hold against tfhe_tpu), with the same
        key on its recorded route and the same switches."""
        sk_cpu = _cpu_server(sk)
        ct_small = ct.with_(lwe=LweCiphertext(data=ct.lwe.data[:small].cpu()))
        ref = sk_cpu.apply_lookup_table(ct_small, sk_cpu.generate_lookup_table(lut_fn))
        same = torch.equal(ref.lwe.data, out.lwe.data[:small].cpu())
        print(f"{path} request 1 on {small} ciphertexts: card path "
              f"{'bit-identical' if same else 'MISMATCH'} to the plain CPU path")
        if not same:
            raise AssertionError(f"{path} card path disagrees with the plain CPU path")

    lap("4")
    # ---- 4. the classic path: keygen, encrypt, three requests, decrypt ------
    zero_counts()
    t0 = time.perf_counter()
    ck, sk = shortint.gen_keys(params, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"{tag} gen_keys {CLASSIC} on the card: {time.perf_counter() - t0:.2f} s")
    mm = params.message_modulus
    msgs = torch.randint(0, mm, (B,), generator=rng.generator(args.seed, 8, device="cpu"),
                         dtype=torch.int64)
    ct = ck.encrypt(msgs.to(dev), seed=args.seed + 1)

    f1 = lambda x: (3 * x + 1) % mm
    f2 = lambda x: (x * x + 3) % mm
    fb = lambda a, b: (a * b + a) % mm
    lut1, lut2 = sk.generate_lookup_table(f1), sk.generate_lookup_table(f2)
    lut3 = sk.generate_bivariate_lookup_table(fb)
    t0 = time.perf_counter()
    out1 = sk.apply_lookup_table(ct, lut1)
    out2 = sk.apply_lookup_table(out1, lut2)
    out3 = sk.unchecked_apply_lookup_table_bivariate(out1, out2, lut3)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    classic_launches = read_counts()
    m1, m2 = f1(msgs), f2(f1(msgs))
    check_requests(ck, (out1, out2, out3), [m1, m2, fb(m1, m2)], "classic", serve_s)
    hold_cpu_path(sk, ct, f1, out1, "classic")
    kspbs = {CLASSIC: cuda_ms(lambda: sk.apply_lookup_table(ct, lut1), 3)}
    del ck, sk, ct, out1, out2, out3

    lap("4b")
    # ---- 4b. the multi-bit path, GROUP_3: four requests ----------------------
    zero_counts()
    mp3 = shortint_params(GROUP_3)
    t0 = time.perf_counter()
    ck, sk = shortint.gen_keys(mp3, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"{tag} gen_keys {GROUP_3} on the card: {time.perf_counter() - t0:.2f} s "
          f"(key {sk.bsk.spectra.numel() * 4 / 1e6:.1f} MB)")
    mm = mp3.message_modulus
    gen = rng.generator(args.seed, 9, device="cpu")
    a = torch.randint(0, mm, (B,), generator=gen, dtype=torch.int64)
    b = torch.randint(0, mm, (B,), generator=gen, dtype=torch.int64)
    ca, cb = ck.encrypt(a.to(dev), seed=args.seed + 2), ck.encrypt(b.to(dev), seed=args.seed + 3)
    lut_mb = sk.generate_lookup_table(f1)
    t0 = time.perf_counter()
    outs = (sk.apply_lookup_table(ca, lut_mb), sk.add(ca, cb), sk.mul(ca, cb),
            sk.greater(ca, cb))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    multi_bit_launches = read_counts()
    check_requests(ck, outs, [f1(a), (a + b) % mm, (a * b) % mm, (a > b).long()],
                   "multi-bit GROUP_3", serve_s)
    hold_cpu_path(sk, ca, f1, outs[0], "multi-bit GROUP_3")
    kspbs[GROUP_3] = cuda_ms(lambda: sk.apply_lookup_table(ca, lut_mb), 3)
    # one KS+PBS call under the profiler: device time by kernel, idle share
    wall_ms, by_kernel, timeline = profile_window(lambda: sk.apply_lookup_table(ca, lut_mb))
    print_profile(f"{tag} profiler, one GROUP_3 KS+PBS call at batch {B}", wall_ms, by_kernel,
                  timeline)
    del ck, sk, ca, cb, outs

    lap("4c")
    # ---- 4c. the per-step routes, one LUT request each -----------------------
    steps_per_call = {CLASSIC: params.lwe_dimension,
                      GROUP_3: mp3.lwe_dimension // mp3.grouping_factor}
    routes = [  # (label, parameter set, switches, kernel expected, time KS+PBS)
        ("FUSED=0 classic", CLASSIC, {"fused": False}, "blind_rotate_step", True),
        ("FUSED=0 GROUP_3", GROUP_3, {"fused": False}, "blind_rotate_step_variants", False),
        ("MXU_LANES=1 classic", CLASSIC, {"lanes": True}, "blind_rotate_step", False),
        ("MXU=0 paired classic", CLASSIC, {"mxu": False}, "blind_rotate_step_variants", True),
        ("MXU=0 GROUP_3", GROUP_3, {"mxu": False}, "blind_rotate_step_variants", False),
    ]
    route_launches, route_kspbs = {}, {}
    for label, pname, sw, kernel, timed in routes:
        config.set_use_mxu_ntt(sw.get("mxu", True))
        config.set_use_mxu_lanes(sw.get("lanes", False))
        config.set_use_fused_rotation(sw.get("fused", True))
        rp = shortint_params(pname)
        t0 = time.perf_counter()
        ck, sk = shortint.gen_keys(rp, seed=args.seed, device=dev)
        torch.cuda.synchronize()
        route = sk.bsk.route
        print(f"{tag} {label}: gen_keys on the card {time.perf_counter() - t0:.2f} s, key "
              f"route {route!r}, spectra {tuple(sk.bsk.spectra.shape)}")
        mm = rp.message_modulus
        m = torch.randint(0, mm, (B,), generator=rng.generator(args.seed, 10, device="cpu"),
                          dtype=torch.int64)
        ct = ck.encrypt(m.to(dev), seed=args.seed + 5)
        lut = sk.generate_lookup_table(f1)
        zero_counts()
        t0 = time.perf_counter()
        out = sk.apply_lookup_table(ct, lut)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        print(f"{label} kernel launches: {json.dumps(counts)}")
        want = {k: 0 for k in counts}
        want.update({kernel: steps_per_call[pname], "keyswitch_tc": 1, "keyswitch_decompose": 1})
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        route_launches[label] = counts
        check_requests(ck, [out], [f1(m)], label, serve_s)
        hold_cpu_path(sk, ct, f1, out, label)
        if timed:
            route_kspbs[label] = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 3)
        if label == "FUSED=0 classic":
            wall_ms, by_kernel, timeline, k4_events = profile_launches(
                lambda: sk.apply_lookup_table(ct, lut), "delta_kernel",
                steps_per_call[CLASSIC], label)
            print_profile(f"{tag} profiler, one {label} KS+PBS call at batch {B}", wall_ms,
                          by_kernel, timeline)
            gaps = [b[1] - (a[1] + a[2]) for a, b in zip(k4_events, k4_events[1:])]
            ends = [b[1] + b[2] - (a[1] + a[2]) for a, b in zip(k4_events, k4_events[1:])]
            if len(k4_events) != steps_per_call[CLASSIC] or not gaps:
                raise AssertionError(f"the trace shows {len(k4_events)} K4 launches")
            print(f"{tag} {label} trace: {len(k4_events)} K4 launches; one ends every "
                  f"{sum(ends) / len(ends) / 1e3:.5f} ms; K4 covers "
                  f"{busy_ms(k4_events):.3f} ms of the device; a launch's traced length "
                  f"{sum(e[2] for e in k4_events) / len(k4_events) / 1e3:.5f} ms (with its "
                  f"wait for the previous one); the next starts {-sum(gaps) / len(gaps):.3f} us "
                  f"before it ends (mean; min {-max(gaps):.3f}, max {-min(gaps):.3f}; "
                  f"negative: a gap)")
        del ck, sk, ct, out
    config.set_use_mxu_ntt(True)
    config.set_use_mxu_lanes(False)
    config.set_use_fused_rotation(True)

    lap("4d")
    # ---- 4d. the large-N paths through K6: 3_3, 3_3 GROUP_3, 4_4 ------------
    large_launches, large_kspbs = {}, {}
    for pname, batch, cpu_hold in LARGE_PATHS:
        rp = shortint_params(pname)
        t0 = time.perf_counter()
        ck, sk = shortint.gen_keys(rp, seed=args.seed, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gf = getattr(rp, "grouping_factor", None)
        steps = rp.lwe_dimension // gf if gf else rp.lwe_dimension
        lay, form = k6_layout(rp)
        if not isinstance(lay, rotation.ClusterLayout):
            raise AssertionError(f"{pname} does not take the cluster step")
        print(f"{tag} {pname}: gen_keys on the card {gen_s:.2f} s (key "
              f"{sk.bsk.spectra.numel() * 4 / 1e9:.2f} GB, keyswitching key "
              f"{sk.ksk.data.numel() * 8 / 1e9:.2f} GB), batch {batch}; K6: {form}")
        m = torch.randint(0, rp.message_modulus, (batch,),
                          generator=rng.generator(args.seed, 11, device="cpu"), dtype=torch.int64)
        ct = ck.encrypt(m.to(dev), seed=args.seed + 6)
        f33 = lambda x, q=rp.message_modulus: (3 * x + 1) % q
        lut = sk.generate_lookup_table(f33)
        zero_counts()
        t0 = time.perf_counter()
        out = sk.apply_lookup_table(ct, lut)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        print(f"{pname} kernel launches: {json.dumps(counts)}")
        want = {k: 0 for k in counts}
        want.update({"blind_rotate_cluster_step_variants" if gf else "blind_rotate_cluster_step":
                     steps, "keyswitch_tc": 1, "keyswitch_decompose": 1})
        if counts != want:
            raise AssertionError(f"{pname}: launches {counts}, expected {want}")
        large_launches[pname] = counts
        check_requests(ck, [out], [f33(m)], pname, serve_s, batch)
        if cpu_hold:
            t0 = time.perf_counter()
            hold_cpu_path(sk, ct, f33, out, pname, small=1)
            print(f"{pname} plain CPU path: {time.perf_counter() - t0:.1f} s")
        large_kspbs[pname] = (cuda_ms(lambda: sk.apply_lookup_table(ct, lut),
                                      2 if pname == CLASSIC_44 else 3), batch)
        # one call under the profiler: the idle share, device time by kernel, and
        # K6's launches and their cadence
        wall_ms, by_kernel, timeline, k6_events = profile_launches(
            lambda: sk.apply_lookup_table(ct, lut), "cluster_step", steps, pname)
        busy = print_profile(f"{tag} profiler, one {pname} KS+PBS call at batch {batch}",
                             wall_ms, by_kernel, timeline)
        if not busy or len(k6_events) != steps:
            raise AssertionError(f"the {pname} trace shows {len(k6_events)} K6 launches, "
                                 f"not {steps}")
        k6_busy = busy_ms(k6_events)
        ends = [b[1] + b[2] - (a[1] + a[2]) for a, b in zip(k6_events, k6_events[1:])]
        excl = exclusive_ms(timeline)
        others = sorted(((v, k) for k, v in excl.items() if "cluster_step" not in k),
                        reverse=True)[:3]
        print(f"{tag} {pname} trace by kernel (each charged after the one before it ended): "
              f"K6 {len(k6_events)} launches cover {k6_busy:.3f} ms ({k6_busy / busy:.1%} of "
              f"busy), one ends every {sum(ends) / len(ends) / 1e3:.5f} ms, a launch's traced "
              f"length {sum(e[2] for e in k6_events) / len(k6_events) / 1e3:.5f} ms; then "
              + ", ".join(f"{k[:60]} {v:.3f} ms" for v, k in others))
        del ck, sk, ct, out, lut
        torch.cuda.empty_cache()

    lap("4e")
    # ---- 4e. the integer path: FheUint8-64, signed and CRT -------------------
    int_path = integer_path(args.seed, dev, tag, zero_counts, read_counts)
    int_launches = {k: int_path["launches"].get(k, 0) for k in read_counts()}

    lap("4f")
    # ---- 4f. the PBS -> KS order (C11), then the boolean scheme ---------------
    c11 = pbs_ks_hold(args.seed, dev, tag, zero_counts, read_counts)
    bool_path = boolean_path(args.seed, dev, tag, zero_counts, read_counts)

    lap("4g")
    # ---- 4g. the apps and examples --------------------------------------------
    app_path = apps_path(args.seed, dev, tag, zero_counts, read_counts, bool_path["sets"])
    slice_launches = {k: c11["launches"].get(k, 0) + bool_path["launches"].get(k, 0)
                      + app_path["launches"].get(k, 0) for k in read_counts()}

    lap("4h")
    # ---- 4h. the noise of encryptions made on the card (C10) -----------------
    noise = noise_hold(args.seed, dev, tag)
    print(json.dumps({"pbs_ks": c11, "boolean": bool_path["sets"],
                      "boolean_trace": bool_path["trace"], "apps": app_path["apps"],
                      "noise": noise}))

    lap("4i")
    # ---- 4i. the client-server key flow ----------------------------------------
    key_flow = key_flow_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"key_flow": key_flow["sets"]}))
    slice_launches = {k: v + key_flow["launches"].get(k, 0) for k, v in slice_launches.items()}

    lap("4j")
    # ---- 4j. the high-level API ----------------------------------------------------
    hl = hlapi_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"hlapi": hl["ops"], "hlapi_encryptions": hl["encryptions"]}))

    lap("4k")
    # ---- 4k. the WoP-PBS ------------------------------------------------------------
    wop = wopbs_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"wopbs": wop["calls"], "wopbs_trace": wop["trace"]}))
    slice_launches = {k: v + hl["launches"].get(k, 0) + wop["launches"].get(k, 0)
                      for k, v in slice_launches.items()}

    lap("4l")
    # ---- 4l. the gadget fork ----------------------------------------------------------
    bool_and = next(r["gate_ms"] for r in bool_path["sets"] if r["set"] == GADGET_GATE_SET)
    gad = gadget_path(args.seed, dev, tag, zero_counts, read_counts, bool_and)
    print(json.dumps({"gadget_gates": gad["gates"], "gadget_ops": gad["ops"],
                      "gadget_trace": gad["trace"]}))
    slice_launches = {k: v + gad["launches"].get(k, 0) for k, v in slice_launches.items()}

    lap("4m")
    # ---- 4m. shifts by an encrypted amount through GGSW selectors --------------------
    shift = shift_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"shift": shift["ops"], "shift_chain": shift["chain"]}))

    lap("4n")
    # ---- 4n. the integer WoP-PBS -------------------------------------------------------
    iwop = integer_wopbs_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"integer_wopbs": iwop["calls"]}))

    lap("4o")
    # ---- 4o. the 2^128 torus and the custom moduli ----------------------------------
    p128 = pbs128_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"pbs128": p128["pbs"], "pbs128_trace": p128["trace"],
                      "custom_moduli": p128["custom"]}))

    lap("4p")
    # ---- 4p. K7 and K8 at EP_SHAPES in every form ------------------------------------
    forms = ep_forms(args.seed, dev, tag, clock_hz, sms)
    slice_launches = {k: v + shift["launches"].get(k, 0) + iwop["launches"].get(k, 0)
                      + p128["launches"].get(k, 0) for k, v in slice_launches.items()}

    lap("4q")
    # ---- 4q. the boolean scheme on the 32-bit torus ------------------------------------
    b32 = bool32_path(args.seed, dev, tag, zero_counts, read_counts, clock_hz, sms)
    print(json.dumps({"bool32": {k: v for k, v in b32.items() if k != "ks"}}))

    lap("4r")
    # ---- 4r. the dp mesh, the card named twice ------------------------------------------
    mesh = mesh_path(args.seed, dev, tag, zero_counts, read_counts)
    print(json.dumps({"mesh": mesh}))
    slice_launches = {k: v + b32["launches"].get(k, 0) + mesh["launches"].get(k, 0)
                      for k, v in slice_launches.items()}

    lap("4s")
    # ---- 4s. the CSPRNG and the C ABI -----------------------------------------------------
    periphery = periphery_path(tag)
    print(json.dumps({"periphery": periphery}))

    lap("5")
    # ---- 5. the shared-memory probe ------------------------------------------
    smem_probe.launches = 0
    largest = smem_probe.largest(dev)
    probe_launches = smem_probe.launches
    t0 = time.perf_counter()
    optin = smem_probe.optin_limit(dev)
    optin_ms = (time.perf_counter() - t0) * 1e3
    torch_optin = getattr(torch.cuda.get_device_properties(dev),
                          "shared_memory_per_block_optin", None)
    print(f"{tag} shared-memory probe: largest that launched and read back {largest} B "
          f"({probe_launches} launches); the device's opt-in attribute {optin} B; "
          f"torch's {torch_optin}; the rotation kernels' limit {rotation._SMEM_LIMIT} B")
    if not largest == optin == rotation._SMEM_LIMIT or torch_optin not in (None, optin):
        raise AssertionError("the probe, the device attribute and the kernels' limit "
                             "disagree")
    probe_ms = cuda_ms(lambda: smem_probe.probe(largest, dev), 10)

    lap("6")
    # ---- 6. launch counts, throughput, the kernels line -----------------------
    print(f"classic path kernel launches: {json.dumps(classic_launches)}")
    print(f"multi-bit GROUP_3 path kernel launches: {json.dumps(multi_bit_launches)}")
    for pname, counts in large_launches.items():
        print(f"{pname} path kernel launches: {json.dumps(counts)}")
    print(f"integer path kernel launches (every op): {json.dumps(int_launches)}")
    print(f"boolean, apps, PBS -> KS, key-flow, hlapi, WoP-PBS and gadget paths kernel "
          f"launches: {json.dumps(slice_launches)}")
    print(f"gadget path kernel launches: {json.dumps(gad['launches'])}")
    for name in ("external_product", "keyswitch_tc", "keyswitch_decompose"):
        if wop["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the WoP-PBS path")
    for label, path, names in (
            ("GGSW shift", shift, ("blind_rotate", "keyswitch_tc", "keyswitch_decompose",
                                   "external_product")),
            ("integer WoP-PBS", iwop, ("blind_rotate", "keyswitch_tc", "keyswitch_decompose",
                                       "external_product")),
            ("128-bit PBS", p128, ("external_product128", "keyswitch_tc",
                                   "keyswitch_decompose"))):
        for name in names:
            if path["launches"].get(name, 0) <= 0:
                raise AssertionError(f"kernel {name} was not launched by the {label} path")
    for name in ("blind_rotate", "external_product", "keyswitch_tc", "keyswitch_decompose"):
        if gad["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the gadget path")
    for name in ("blind_rotate", "keyswitch_tc", "keyswitch_decompose"):
        if min(bool_path["launches"][name], app_path["launches"][name],
               key_flow["launches"][name]) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the boolean, app or key-flow "
                                 f"path")
    for label, path, names in (
            ("32-bit boolean", b32, ("external_product", "keyswitch_tc", "keyswitch_decompose")),
            ("mesh", mesh, ("blind_rotate", "keyswitch_tc", "keyswitch_decompose"))):
        for name in names:
            if path["launches"].get(name, 0) <= 0:
                raise AssertionError(f"kernel {name} was not launched by the {label} path")
    if key_flow["launches"]["blind_rotate_cluster_step"] <= 0:
        raise AssertionError("the key flow's 4_4 KS+PBS did not launch K6's cluster step")
    for name, count in (("blind_rotate", classic_launches["blind_rotate"]),
                        ("keyswitch_tc", classic_launches["keyswitch_tc"]),
                        ("keyswitch_decompose", classic_launches["keyswitch_decompose"]),
                        ("blind_rotate_multibit", multi_bit_launches["blind_rotate_multibit"]),
                        ("keyswitch_tc", multi_bit_launches["keyswitch_tc"]),
                        ("keyswitch_decompose", multi_bit_launches["keyswitch_decompose"]),
                        ("blind_rotate_cluster_step",
                         large_launches[CLASSIC_33]["blind_rotate_cluster_step"]),
                        ("blind_rotate_cluster_step_variants",
                         large_launches[GROUP_3_33]["blind_rotate_cluster_step_variants"]),
                        ("smem_probe", probe_launches)):
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by its path")
    # the keyswitch on the classic and multi-bit paths: one pass and one K2'
    # per KS+PBS call (one rotation launch a call there)
    for label, counts, rot in (("classic", classic_launches, "blind_rotate"),
                               ("multi-bit GROUP_3", multi_bit_launches,
                                "blind_rotate_multibit")):
        if not counts["keyswitch_tc"] == counts["keyswitch_decompose"] == counts[rot]:
            raise AssertionError(f"{label} path: keyswitch launches {counts}, not one pass "
                                 f"and one K2' a KS+PBS call")

    mp2 = shortint_params(GROUP_2)
    ck, sk = shortint.gen_keys(mp2, seed=args.seed, device=dev)
    ct = ck.encrypt(a.to(dev), seed=args.seed + 4)
    lut = sk.generate_lookup_table(f1)
    zero_counts()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    group_2_launches = read_counts()
    print(f"multi-bit GROUP_2 path kernel launches: {json.dumps(group_2_launches)}")
    want = {k: 0 for k in group_2_launches}
    want.update({"blind_rotate_multibit": 1, "keyswitch_tc": 1, "keyswitch_decompose": 1})
    if group_2_launches != want:
        raise AssertionError(f"GROUP_2: launches {group_2_launches}, expected {want}")
    if not torch.equal(ck.decrypt(out).cpu(), f1(a)):
        raise AssertionError("GROUP_2 KS+PBS decrypts wrong")
    kspbs[GROUP_2] = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 3)
    del ck, sk, ct, out
    for name, ms in list(kspbs.items()) + list(route_kspbs.items()):
        print(f"{tag} KS+PBS {name} batch {B}: {ms:.3f} ms per call, "
              f"{B / (ms / 1e3):.2f} PBS/s")
    for name, (ms, batch) in large_kspbs.items():
        print(f"{tag} KS+PBS {name} batch {batch} (K6): {ms:.3f} ms per call, "
              f"{batch / (ms / 1e3):.2f} PBS/s")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, shapes=None,
              cluster=None):
        print(f"{tag} {name}: {ms:.3f} ms, bound {bnd[0]:.6f} ms by {bnd[1]} "
              f"(bound / time = {bnd[0] / ms:.1%}), plain {plain_ms:.3f} ms")
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        if cluster:
            out["cluster"] = cluster
        if shapes:
            out["shapes"] = [{"shape": sh, "ms": t, "plain_ms": pt, "bound_ms": b[0],
                              "bound_by": b[1], **(more[0] if more else {})}
                             for sh, t, pt, b, *more in shapes]
        return out

    def route_total(kernel):
        return sum(c[kernel] for c in route_launches.values())

    def path_total(kernel):
        """Launches over every main path's counted window."""
        return (classic_launches[kernel] + multi_bit_launches[kernel] + route_total(kernel)
                + sum(c[kernel] for c in large_launches.values()) + group_2_launches[kernel]
                + int_launches[kernel] + slice_launches[kernel])

    ks_src = "tfhe_tpu_torch/csrc/keyswitch.cu"
    ks22, ks_names = ks[CLASSIC], [CLASSIC, GROUP_3, GROUP_2] + list(LARGE_KS_SETS)
    ks_rows = [ks[k] for k in ks_names] + list(ks_wide.values())
    pf = wop["pfks"]
    tc_rows = [(r["shape"], r["tc_ms"], r["tc_plain_ms"], r["tc_bound"],
                {"int_mm_ms": r["int_mm_ms"], "digit_limbs": r["limbs"],
                 **({"plain_batch": r["plain_batch"],
                     "cuda_core_bound_ms": r["cuda_core_bound"][0]} if r["limbs"] > 1 else {})})
               for r in ks_rows]
    tc_rows.append((pf["shape"], pf["ms"], pf["plain_ms"], pf["bound"],
                    {"int_mm_ms": pf["int_mm_ms"], "digit_limbs": 2,
                     "cuda_core_bound_ms": pf["cuda_core_bound"][0]}))
    ks32 = b32["ks"]
    tc_rows.append((ks32["shape"], ks32["tc_ms"], ks32["tc_plain_ms"], ks32["tc_bound"],
                    {"int_mm_ms": ks32["int_mm_ms"], "digit_limbs": 1}))

    rot_src = "tfhe_tpu_torch/csrc/rotation.cu"
    kernels = [
        entry("blind_rotate", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:1073",
              classic_launches["blind_rotate"] + int_launches["blind_rotate"]
              + slice_launches["blind_rotate"], max(k1_err, gad["k7"]["k1_err"]), k1_ms,
              k1_plain_ms, k1_bound),
        entry("keyswitch_tc", ks_src, "tfhe_tpu/core/algorithms/keyswitch.py:41",
              path_total("keyswitch_tc"),
              max([r["err"]["tc"] for r in ks_rows + [ks32]] + [pf["err"]]),
              ks22["tc_ms"], ks22["tc_plain_ms"], ks22["tc_bound"], tc_rows),
        entry("keyswitch_decompose", ks_src, "tfhe_tpu/core/decomposition.py:19",
              path_total("keyswitch_decompose"), max(r["err"]["dec"] for r in ks_rows + [ks32]),
              ks22["dec_ms"], ks22["dec_plain_ms"], ks22["dec_bound"],
              [(r["shape"], r["dec_ms"], r["dec_plain_ms"], r["dec_bound"])
               for r in ks_rows + [ks32]]),
        entry("blind_rotate_multibit", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:1073",
              multi_bit_launches["blind_rotate_multibit"] + int_launches["blind_rotate_multibit"],
              max(k3[2]["err"], k3[3]["err"]),
              k3[3]["ms"], k3[3]["plain_ms"], k3[3]["bound"],
              [(f"GROUP_{gf} batch {B}, one launch", k3[gf]["ms"], k3[gf]["plain_ms"],
                k3[gf]["bound"]) for gf in (3, 2)], rotation._CLUSTER),
        entry("blind_rotate_step", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:601",
              route_total("blind_rotate_step"), k4_err, k4_ms, k1_plain_ms, k4_bound),
        entry("blind_rotate_step_variants", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:221",
              route_total("blind_rotate_step_variants"), k5_err, k5p_ms, k5p_plain_ms,
              k5p_bound,
              [(f"paired 2_2 batch {B}, {steps_per_call[CLASSIC]} launches", k5p_ms,
                k5p_plain_ms, k5p_bound),
               (f"GROUP_3 batch {B}, {steps_per_call[GROUP_3]} launches", k5m_ms,
                k5m_plain_ms, k5m_bound)], rotation._CLUSTER),
        entry("blind_rotate_cluster_step", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:1073",
              sum(c["blind_rotate_cluster_step"] for c in large_launches.values())
              + slice_launches["blind_rotate_cluster_step"],
              k6["delta"]["err"], k6["delta"]["ms"], k6["delta"]["plain_ms"],
              k6["delta"]["bound"], k6["delta"]["shapes"]),
        entry("blind_rotate_cluster_step_variants", rot_src,
              "tfhe_tpu/core/poly/pallas_ntt.py:1073",
              sum(c["blind_rotate_cluster_step_variants"] for c in large_launches.values()),
              k6["variants"]["err"], k6["variants"]["ms"], k6["variants"]["plain_ms"],
              k6["variants"]["bound"], k6["variants"]["shapes"]),
        entry("blind_rotate_staged", rot_src, "tfhe_tpu/core/poly/pallas_ntt.py:1073",
              sum(c["blind_rotate_staged"] for c in large_launches.values()),
              k6["passes"]["err"], k6["passes"]["ms"], k6["passes"]["plain_ms"],
              k6["passes"]["bound"], k6["passes"]["shapes"]),
        entry("smem_probe", "tfhe_tpu_torch/csrc/probe.cu", "tools/vmem_probe.py:19",
              probe_launches, abs(largest - optin), probe_ms, optin_ms,
              bound(largest, 8, clock_hz, sms)),
        entry("external_product", "tfhe_tpu_torch/csrc/external_product.cu",
              "tfhe_tpu/core/algorithms/bootstrap.py:50", path_total("external_product"),
              max(wop["k7"]["err"], gad["k7"]["err"], iwop["k7"]["err"], b32["k7"]["err"]),
              wop["k7"]["ms"],
              wop["k7"]["plain_ms"], bound(wop["k7"]["mults"], wop["k7"]["bytes"], clock_hz, sms),
              [(k7["shape"], k7["ms"], k7["plain_ms"],
                bound(k7["mults"], k7["bytes"], clock_hz, sms))
               for k7 in (wop["k7"], gad["k7"], iwop["k7"])]
              + [(f["shape"], f["device_ms"][f["rule"]] or f["ms"][f["rule"]], f["plain_ms"],
                  f["bound"], {"form": f["rule"], "events_ms": f["ms"][f["rule"]],
                               "forms_device_ms": f["device_ms"]})
                 for label, f in forms.items() if label.startswith("K7")]
              + [(r["shape"], r["ms"], r["plain_ms"], r["bound"], {"events_ms": r["events_ms"]})
                 for r in b32["k7"]["shapes"]]),
        entry("external_product128", "tfhe_tpu_torch/csrc/external_product.cu",
              "tfhe_tpu/core/algorithms/pbs128.py:244", path_total("external_product128"),
              p128["k8"]["err"], p128["k8"]["ms"], p128["k8"]["plain_ms"],
              bound(p128["k8"]["mults"], p128["k8"]["bytes"], clock_hz, sms),
              [(p128["k8"]["shape"], p128["k8"]["ms"], p128["k8"]["plain_ms"],
                bound(p128["k8"]["mults"], p128["k8"]["bytes"], clock_hz, sms))]
              + [(f["shape"], f["device_ms"][f["rule"]] or f["ms"][f["rule"]], f["plain_ms"],
                  f["bound"], {"form": f["rule"], "events_ms": f["ms"][f["rule"]],
                               "forms_device_ms": f["device_ms"]})
                 for label, f in forms.items() if label.startswith("K8")]),
    ]
    print(f"{tag} K3 GROUP_2 batch {B}: {k3[2]['ms']:.3f} ms, bound {k3[2]['bound'][0]:.3f} ms "
          f"by {k3[2]['bound'][1]}, plain {k3[2]['plain_ms']:.3f} ms")
    print(f"{tag} K5 GROUP_3 per-step rotation batch {B}: {k5m_ms:.3f} ms, bound "
          f"{k5m_bound[0]:.3f} ms by {k5m_bound[1]}, plain {k3[3]['plain_ms']:.3f} ms")
    print(f"{tag} keyswitch at batch {B}: shape | digit limbs | K2' ms | bound ms | bound / "
          f"time | CUDA-core bound ms | plain ms | pass ms | pass bound ms | torch._int_mm ms")
    for r in ks_rows + [dict(pf, tc_ms=pf["ms"], tc_bound=pf["bound"], tc_plain_ms=pf["plain_ms"],
                             limbs=2, dec_bound=(float("nan"), ""))]:
        mm = "not measured" if r["int_mm_ms"] is None else f"{r['int_mm_ms']:.4f}"
        cc = f"{r['cuda_core_bound'][0]:.4f}" if "cuda_core_bound" in r else "-"
        print(f"    {r['shape']} | {r['limbs']} | {r['tc_ms']:.4f} | {r['tc_bound'][0]:.4f} | "
              f"{r['tc_bound'][0] / r['tc_ms']:.1%} | {cc} | {r['tc_plain_ms']:.3f} | "
              f"{r['dec_ms']:.4f} | {r['dec_bound'][0]:.4f} | {mm}")
    print(f"{tag} chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
