#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA card.

Drives the port's shortint keyswitch + PBS main path once at the full
PARAM_MESSAGE_2_CARRY_2_KS_PBS widths (n=742, N=2048, batch 512), through
the entry points a user calls, and checks it:

  1. card, power limit, torch and CUDA versions;
  2. builds both CUDA kernels (csrc/*.cu) with nvcc and prints ptxas's
     register, shared-memory and spill lines;
  3. holds each kernel bit for bit (tolerance 0: the arithmetic is exact)
     against its plain PyTorch version on the card at the main path's
     shapes (K1 blind rotation at batch 1, 6, 8 and 512 over all 742 steps,
     K2 keyswitch contraction at batch 512), and times both versions at
     batch 512 with CUDA events;
  4. gen_keys on the card, encrypts 512 messages, serves three requests
     (a LUT, a second LUT chained on its output, a bivariate LUT), decrypts
     all 3 x 512 results against the clear model, and holds the first
     results bit for bit against the plain path on CPU tensors;
  5. reports each kernel's launch count in the main path (each must be > 0)
     and PBS/s at batch 512.

Every failure raises; nothing falls back to a plain version or the CPU.
The last line is {"ok": true, "device": {...}}.  Needs one CUDA card:

    python3 chip_smoke.py [--seed S]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int64 torus words (0 iff bit-identical)."""
    return int((a - b).abs().max().item())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2

    from tfhe_tpu_torch import cuda_lib, shortint
    from tfhe_tpu_torch.core import rng
    from tfhe_tpu_torch.core.algorithms import external_product_num_primes, keyswitch
    from tfhe_tpu_torch.core.entities import (LweCiphertext, LweKeyswitchKey,
                                              NttBootstrapKey)
    from tfhe_tpu_torch.core.params import shortint_params
    from tfhe_tpu_torch.core.poly import ntt, rotation
    from tfhe_tpu_torch.core.poly.rotation import blind_rotate_plain

    # ---- 1. the card ---------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}, {torch.cuda.get_device_name(0)}")
    tag = f"[{card}]"

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.library()
    info = cuda_lib.build_info
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info.get('seconds', 0):.2f} s, "
          f"cached={info.get('cached')})")
    for line in info.get("log", "").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
            print(f"ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions, full 2_2 widths ----------
    params = shortint_params("PARAM_MESSAGE_2_CARRY_2_KS_PBS")
    n, N, R = params.lwe_dimension, params.polynomial_size, params.glwe_size
    J = params.pbs_level * R
    P = external_product_num_primes(N, R, params.pbs_decomp)
    plan = ntt.get_plan(N, P)
    g = rng.generator(args.seed, 7, device=dev)
    spectra = torch.stack([torch.randint(0, p, (n, J, R, N), generator=g, device=dev,
                                         dtype=torch.int32) for p in plan.primes], dim=1)
    key = NttBootstrapKey(spectra=spectra, decomp=params.pbs_decomp, primes=plan.primes)

    def rot_inputs(batch):
        return (rng.uniform_torus(g, (batch, R, N)),
                torch.randint(0, 2 * N, (batch, n), generator=g, device=dev))

    k1_err = 0
    for batch in (1, 6, 8):
        acc, exps = rot_inputs(batch)
        got = rotation.rotate_accumulator(acc, exps, key)
        torch.cuda.synchronize()
        ref = blind_rotate_plain(acc, exps, key)
        torch.cuda.synchronize()
        k1_err = max(k1_err, max_abs_err(got, ref))
        print(f"K1 blind rotation, batch {batch}, {n} steps: "
              f"{'bit-identical' if torch.equal(got, ref) else 'MISMATCH'} to plain")
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 disagrees with its plain version at batch {batch}")

    K, M, B = params.big_lwe_dimension * params.ks_level, n + 1, 512
    digits = torch.randint(-(1 << (params.ks_base_log - 1)), (1 << (params.ks_base_log - 1)) + 1,
                           (B, K), generator=g, device=dev, dtype=torch.int32)
    kmat, body = rng.uniform_torus(g, (K, M)), rng.uniform_torus(g, (B,))
    got = keyswitch.neg_digit_mac(digits, kmat, body)
    torch.cuda.synchronize()
    ref = keyswitch.neg_digit_mac_plain(digits, kmat, body)
    k2_err = max_abs_err(got, ref)
    print(f"K2 keyswitch contraction, batch {B}, K={K}, M={M}: "
          f"{'bit-identical' if torch.equal(got, ref) else 'MISMATCH'} to plain")
    if not torch.equal(got, ref):
        raise AssertionError("K2 disagrees with its plain version")

    acc, exps = rot_inputs(B)
    outs = {}
    k1_ms = cuda_ms(lambda: outs.update(kernel=rotation.rotate_accumulator(acc, exps, key)), 3)
    k1_plain_ms = cuda_ms(lambda: outs.update(plain=blind_rotate_plain(acc, exps, key)), 1)
    k1_err = max(k1_err, max_abs_err(outs["kernel"], outs["plain"]))
    same = torch.equal(outs["kernel"], outs["plain"])
    print(f"K1 blind rotation, batch {B}, {n} steps: "
          f"{'bit-identical' if same else 'MISMATCH'} to plain")
    if not same:
        raise AssertionError(f"K1 disagrees with its plain version at batch {B}")
    k2_ms = cuda_ms(lambda: keyswitch.neg_digit_mac(digits, kmat, body), 10)
    k2_plain_ms = cuda_ms(lambda: keyswitch.neg_digit_mac_plain(digits, kmat, body), 3)
    print(f"{tag} K1 batch {B}: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")
    print(f"{tag} K2 batch {B}: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")
    del spectra, key, acc, exps, digits, kmat, body, got, ref, outs

    # ---- 4. the main path: keygen, encrypt, three requests, decrypt ---------
    rotation.launches = keyswitch.launches = 0
    t0 = time.perf_counter()
    ck, sk = shortint.gen_keys(params, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"gen_keys on the card: {time.perf_counter() - t0:.2f} s")
    mm = params.message_modulus
    msgs = torch.randint(0, mm, (B,), generator=rng.generator(args.seed, 8), dtype=torch.int64)
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
    launches = {"blind_rotate": rotation.launches, "keyswitch_mac": keyswitch.launches}

    m1, m2 = f1(msgs), f2(f1(msgs))
    expect = [m1, m2, fb(m1, m2)]
    right = 0
    for i, (out, want) in enumerate(zip((out1, out2, out3), expect)):
        if tuple(out.lwe.data.shape) != (B, params.big_lwe_dimension + 1):
            raise AssertionError(f"request {i + 1}: shape {tuple(out.lwe.data.shape)}")
        got = ck.decrypt(out).cpu()
        ok = int((got == want).sum())
        right += ok
        print(f"request {i + 1}: {ok}/{B} decrypt right")
    print(f"main path: {right}/{3 * B} right, three requests in {serve_s:.3f} s "
          f"(first-call costs included)")
    if right != 3 * B:
        raise AssertionError("decryption mismatch on the main path")

    # the same first request on CPU tensors (the plain path the CPU tests
    # hold against tfhe_tpu), bit for bit on a small input
    small = 4
    sk_cpu = shortint.ServerKey(
        ksk=LweKeyswitchKey(data=sk.ksk.data.cpu(), decomp=sk.ksk.decomp),
        bsk=NttBootstrapKey(spectra=sk.bsk.spectra.cpu(), decomp=sk.bsk.decomp,
                            primes=sk.bsk.primes), params=params)
    ct_small = ct.with_(lwe=LweCiphertext(data=ct.lwe.data[:small].cpu()))
    ref = sk_cpu.apply_lookup_table(ct_small, sk_cpu.generate_lookup_table(f1))
    same = torch.equal(ref.lwe.data, out1.lwe.data[:small].cpu())
    print(f"request 1 on {small} ciphertexts: card path {'bit-identical' if same else 'MISMATCH'}"
          f" to the plain CPU path")
    if not same:
        raise AssertionError("card path disagrees with the plain CPU path")

    # ---- 5. launch counts and throughput -------------------------------------
    print(f"main-path kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    kspbs_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut1), 3)
    print(f"{tag} KS+PBS 2_2 batch {B}: {kspbs_ms:.3f} ms per call, "
          f"{B / (kspbs_ms / 1e3):.2f} PBS/s; plain rotation alone at batch {B}: "
          f"{k1_plain_ms:.3f} ms")

    kernels = [
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/rotation.cu",
         "replaces": "tfhe_tpu/core/poly/pallas_ntt.py:1073",
         "launches": launches["blind_rotate"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "keyswitch_mac", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
         "replaces": "tfhe_tpu/core/algorithms/keyswitch.py:41",
         "launches": launches["keyswitch_mac"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
