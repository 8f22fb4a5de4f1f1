// The blind rotation for a batch of LWE ciphertexts, in two kernel bodies:
// the delta body (classic keys) and the variant body (multi-bit keys, and
// paired classic keys as g = 1), each launched two ways, and K6 for
// ciphertexts whose working set exceeds one block's shared memory:
//
//   whole rotation, the step loop inside the block:
//     K1 tfhe_blind_rotate            delta steps, classic keys
//     K3 tfhe_blind_rotate_multi_bit  variant steps, multi-bit keys
//   one step per launch, the accumulator in global memory between launches:
//     K4 tfhe_blind_rotate_step           one delta step
//     K5 tfhe_blind_rotate_step_variants  one variant step (g = 1..4; g = 1
//                                         is a paired classic key)
//   K6, the step loop on the host: the whole rotation (K1's and K3's route)
//   or one step (K4's, K5's):
//     tfhe_cluster_step    the cluster step: a cluster of C blocks owns a
//                          ciphertext's step, one launch a step; delta or
//                          variant steps
//     tfhe_staged_rotate   the passes form, where no cluster holds a step:
//                          the working set in global memory, 2 launches per
//                          head pass + 1 a step; delta steps
//
// K1 replaces the TPU kernel `_make_rotation_kernel_mxu` run through
// `blind_rotate_fused(mode="delta")` (tfhe_tpu/core/poly/pallas_ntt.py:1073,
// :1537), and its step loop is also the counterpart of that kernel's
// `kernel_loop` (:1462, TFHE_TPU_ROTATION_LOOP=1).  For each of the n_steps
// mask elements, with e_j = a~_j mod 2N:
//
//   acc += (X^e_j - 1) * sum_{l,r} decomp_l(acc_r) * GGSW(s_j)[l, r]
//
// K3 replaces the same TPU kernel in multibit mode
// (`blind_rotate_fused(mode="multibit")`, pallas_ntt.py:1073, the MAC at
// :1329-1356 and the replacing write-back at :1442-1444).  Each step takes a
// group of g mask elements and the 2^g GGSWs of that group's key bits, and
// replaces the accumulator:
//
//   acc = sum_{v < 2^g} X^{c_v} * sum_{l,r} decomp_l(acc_r) * GGSW_{j,v}[l, r]
//
// with c_0 = 0 and c_v = sum of the a~ of the group selected by v's bits
// (the MSB of v is the group's first element; the wrapper computes c_v).
//
// K4 replaces the per-step TPU kernels in delta mode: `_make_step_kernel_mxu`
// (pallas_ntt.py:601, via `blind_rotate_step_pallas_mxu` :1018, the
// TFHE_TPU_FUSED=0 route) and `_make_step_kernel_mxu_lanes` (:778, via :955,
// the same step with the batch folded into the TPU's lanes, a layout with no
// meaning here).  K5 replaces the same two in multibit mode and
// `_make_step_kernel` (:221, via `blind_rotate_step_pallas` :494, the
// TFHE_TPU_MXU=0 route): the DIF-butterfly step over a multi-bit key or over
// the paired classic key [GGSW(1 - s), GGSW(s)], which is the variant step
// with g = 1 (c_1 = e_j).  K4 is K1's body run for one step, K5 K3's; the
// exponents are read through a batch stride, so a column of the [B, n]
// table needs no copy.
//
// The delta body's passes, MAC and lift (K1/K4, K6) live in ntt_passes.cuh,
// which external_product.cu's K7/K8 share.
//
// All compute mod (X^N + 1, 2^64), exactly, over P NTT primes below 2^30 and
// lift back with Garner (signed lift, then mod 2^64), so every result is
// bit-identical to the JAX kernel it replaces whatever the transform's order.
//
// Common design of K1-K5.  Each block owns one ciphertext and keeps its
// accumulator [R][N] u64, its J digit spectra and its R products (all P
// primes) in shared memory: 8RN + 4JN + 4PRN bytes (114,688 B at N = 2048,
// R = J = 2, P = 4: two blocks per SM).  K1/K3 run the step loop inside the
// block (it takes the place of the TPU's sequential grid axis); K4/K5 load
// the accumulator from global memory, run one step and store it back in
// place.  Where the working set exceeds one block's 232,448 B (N = 4096 at
// L = 2, every N >= 8192: 3_3, 4_4, the 3_3 multi-bit sets) K6 runs instead.
// Per step and prime: balanced digits of acc -> forward Cooley-Tukey NTT
// (psi merged, bit-reversed out) of the J digit polys -> MAC against the
// step's key spectra with the phase -> Gentleman-Sande inverse of the R
// products.  Then Garner adds the delta into acc (delta) or replaces acc
// (variants).  Modular products of residues use 32-bit Shoup multiplies
// with the native __umulhi (twiddles, phases, Garner constants).
//
// K1/K4, the delta body, and what bounded its first design.  That design
// (radix-2 stages, one thread per butterfly, the tables read with scalar
// __ldg) took 0.316 ms a step at 2_2, batch 512.  Probes on the H100
// (PERF.md, Findings) split it: the twiddle loads (two per
// butterfly) 20%, the phase gathers (two per output) 11%, the key loads 8%,
// the 88 stage barriers only 4%, and 60% the rest: 22 shared-memory round
// trips per transform and the index arithmetic around each.  A block alone
// on an SM took 0.106 ms a step however empty the card was, so one block's
// chain of dependent work, not a resource the blocks share, set the pace.
//
// This body does, per step and prime (at N = 2048; the schedule is
// rotation.py _delta_layout's, the same code takes every N from 4 to what
// one block's shared memory holds):
//  - passes of radix 8: a thread holds 8 coefficients of one polynomial in
//    registers for 3 stages.  One head pass over the whole polynomial (a
//    block barrier after it), then two tail passes in regions of 256 that
//    one warp owns; the MAC runs the last two stages; the inverse mirrors
//    it.  Where every warp has a region of its own (N >= 2048), one warp
//    runs a region's tails in every polynomial and its MAC between them
//    with warp barriers only: 2 block barriers a prime, 8 a step (97 before).
//  - the digits fused into the first pass: a thread reads its accumulator
//    words and splits each into its L digits there.  The Garner lift fused
//    into the last inverse pass of the last prime: the thread that lifts a
//    coefficient wrote its residues for every prime and reads it for the next
//    step's digits, so neither needs a barrier.
//  - the MAC fused between the transforms: a thread owns 4 slots of every
//    digit polynomial, runs the last two forward stages, the J products of
//    each output (key words as 16-byte loads), one Barrett reduction, the
//    phase (X^e - 1)/N (one 8-byte gather per slot for all outputs), and the
//    first two inverse stages, in registers.
//  - twiddles beside their Shoup twins in heap order (rotation.py
//    _delta_tables): a radix-8 item's 7 are one 8-byte and two 16-byte loads.
//  - lazy reduction (Harvey): residues in [0, 4p) forward, [0, 2p) inverse.
//  - a shared-memory swizzle (bits 2-4 XOR bits 5-7) under which every
//    pass's warp access hits 32 banks, folded into each lane's addresses.
//  - the primes' constants (p, the Barrett factor, Garner's) as one kernel
//    parameter (operands, not loads), and for N = 2048 at P = 4 under the
//    layout of one head pass and the 256-coefficient tail a kernel with N
//    and P fixed at compile time (timed against the general kernel at 2_2
//    only, where it was faster: PERF.md's design steps); every other shape
//    runs the general kernel.
//  - K4 launched with programmatic stream serialization, so a step's blocks
//    are scheduled while the previous step drains.
// 256 threads a block (128 registers at most: 2_2's kernel does not spill,
// the general ones at rt 3 and 4 spill a few bytes, PERF.md); two blocks
// per SM, as shared memory allows at 2_2.  What bounds it now is again one block's
// chain of dependent work: see PERF.md for the rounds.
//
// K3/K5, the variant MAC, and what bounds it.  Per slot k and prime it
// reads 2^g * J * R key words (32 at GROUP_3): one 4-byte __ldg each, and
// with one ciphertext per block every ciphertext pulls the whole step
// slice (1 MB at GROUP_3) through L2, about 159 GB per K3 call at batch
// 512.  A fit over the first design's K1, GROUP_2 and GROUP_3 times gave
// 0.248 ms + 0.0168 ms per step for each key load per slot and prime: the
// loads' latency, not HBM bytes, bounded the MAC (about 1 TB/s from L2).
// This design issues a thread's R key words per (v, j) side by side, ahead
// of the digit read and the phase multiply (R is a template parameter), and
// shares each word among a cluster of C ciphertexts (below).  On the H100
// at batch 512 (PERF.md, Findings) the first took K3 GROUP_3 from 234.6 to
// about 186 ms with one ciphertext per block; the cluster shortens a full
// round of blocks by 3.4% at C = 2 and no more at C = 4, so the key loads
// no longer bound it.  What bounds it is shared by all blocks of a round
// (a near-empty card runs a rotation about 5x faster): integer issue at two
// blocks per SM, or L1/L2 traffic of the twiddle and phase tables, which do
// not fit L1 beside the shared memory.  C = 4 also needs a third, short
// round at batch 512 (62 clusters of 4 fit at once), so C = 2 is faster.
//
// The cluster.  The variant body is templated on a cluster size C (1, 2, 4,
// 8; the default, 2, is the fastest of chip_smoke.py's sweep) and launched
// as clusters of C blocks (cudaLaunchKernelEx with a cluster dimension; the
// grid is ceil(B/C)*C, and blocks b >= B are padding: a zero accumulator,
// no global load or store, a full share of the MAC).
// Decomposition, forward NTT, inverse NTT and Garner stay per block, on its
// own ciphertext.  In the MAC the block of rank c computes the slots
// [c*N/C, (c+1)*N/C) for all C ciphertexts of its cluster: one thread per
// slot loads each key word (v, j, r, k) once and multiplies it into C
// ciphertexts' 64-bit sums, reading their digit residues and writing their
// R output residues through distributed shared memory (map_shared_rank).
// Two cluster barriers per step and prime replace the block barriers around
// the MAC: the first publishes every block's digit spectra, the second
// every block's products (and keeps a block's shared memory alive while its
// peers still read it).  Per block and prime the key loads drop from
// N*V*J*R to N*V*J*R/C; the MAC reads V*J*C digit residues per slot through
// the cluster and, per ciphertext, still gathers its 2(V-1) phase words.
// Each sum is reduced with Barrett before its 17th product (16 products
// below p^2 < 2^60 fit, and so do 16 more beside a reduced residue); 1/N is
// one Shoup multiply per output.  R is a template parameter, so a thread
// holds C*R sums (8 registers at C = 2, R = 2).  A thread owns one slot at
// a time, so the key loads stay 4-byte loads, coalesced across the warp: a
// 16-byte load would need four slots per thread, 4*C*R sums.
//
// The MACs take any J = L*R: a 64-bit sum holds 16 products of reduced
// residues (< p < 2^30, so 16 p^2 < 2^64) and is reduced before the 17th,
// inside the j loop where J > 16 (J = 16 at AES_PARAMETERS_40, 18 at the
// WoP-PBS sets).  K1/K4 take delta_kernel with WIDE false for J <= 16 (no
// reduction in the loop: its code is kept from growing) and WIDE for J > 16.
//
// K6 replaces the same TPU kernels at the shapes where they raise the VMEM
// limit (pallas_ntt.py:1717-1724) or take the factored phase stack (N >=
// 16384, :1135-1168): one block cannot hold a ciphertext (4_4's
// accumulator alone is 512 KB).  It has two forms; rotation.py _k6_layout
// chooses one from the shape alone (_cluster_rule).
//
// The cluster step (cluster_step, rotation.py _cluster_layout).  A cluster
// of C = 2, 4, 8 or 16 blocks (16 with the non-portable attribute) owns one
// (ciphertext, step); the grid is B clusters, one launch a step, with
// programmatic dependent launch.  Block q keeps the region [q*W, (q+1)*W),
// W = N/C, of every polynomial: the slots the top log2 C forward stages
// give it, in the delta body's swizzled layout.  Per group of ps primes
// (ps divides P <= 4):
//  - the exchange: for its share of the columns (W/C offsets), a block
//    reads the accumulator words off + k*W (k < C) from device memory,
//    splits them into digits (next_digits), runs the top log2 C stages in
//    registers (heap node 1, radix up to 16) and writes output k into
//    block k's shared memory (map_shared_rank), after the wait of a
//    cluster barrier that each block arrives at as it starts (no block
//    writes a peer that has not started); a cluster barrier;
//  - the region, with K1's machinery on a region of the large transform
//    (heap-node twiddles of the whole transform): head passes over the
//    block, each item's twiddles taken through every polynomial of its
//    prime; then one warp per (prime, 256-slot tail region): the forward
//    tails (twiddles once for the J polynomials), the MAC (delta:
//    mac_group; variants: finish_group, then mac_variants), the inverse
//    tails; the inverse head passes.
// After the last group a cluster barrier, then the gather: for its column
// share a block reads every prime's products at slot off of every block,
// runs the bottom log2 C inverse stages in registers and lifts with Garner
// (garner_from) into acc (delta: adds; variants: replaces); a last cluster
// barrier keeps a block's shared memory alive while its peers read it.  At
// C = 16 a block has more threads than column items, and several share an
// item: in the exchange each takes a share of the primes; in the gather
// each takes a share of the primes through the inverse stages into the
// block's spectra buffer, free by then, and after a block barrier lifts a
// share of the coefficients (4_4: 4.0 to 3.4 ms a step on the H100, PERF.md).
// Device memory per step: the accumulator read (once per group) and
// written once, the exponents, the key slice, the tables: no scratch.
// Shared memory 4 (ps J + P R) W bytes.  256 threads a block, two blocks
// a SM where shared memory allows (C <= 8); 512 at C = 16 (cluster_threads).
// The kernel is compiled per C and delta or variants; R is a parameter,
// the MAC compiled for R = 2 and run in chunks of one output otherwise
// (region_mac).  On the H100 (PERF.md) every prime in one group (3
// cluster barriers a step) beat one prime a group, and two blocks a SM of
// half the region beat one: 3_3 runs at C = 8 (98,304 B), 4_4 at C = 16
// (196,608 B).  What bounds it (timed with phases left out of a scratch
// build): most of a step is the per-warp region work (tails, MAC), a
// chain of dependent L2 loads (twiddles, key words, phases) with too few
// warps a SM to hide them, then the exchange and the gather at C = 16.
//
// The passes form (rotation.py _staged_layout), for the shapes no cluster
// holds (PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS: N = 65536, J = 8;
// P > 4; R > 4): the digit spectra [P][J][N] and products [P][R][N] (u32)
// live in device memory, swizzled in 256-word blocks as the delta body
// keeps a polynomial in shared memory.  Per step (h = log2 N - 8 head
// stages): the head passes run over device memory, radix 8 at most, one
// launch each (the first reads acc and splits it into digits for every
// prime, next_digits); one launch, a warp per (prime, 256-slot region,
// ciphertext), runs K1's region pipeline (mac_group) on a copy of the
// region in shared memory; the inverse head passes mirror the forward
// ones, the last lifting with Garner into acc.  2 ceil(h/3) + 1 launches a
// step.  Bound by the scratch round trips through device memory; the batch
// is tiled where the scratch would exceed 2 GB (rotation.py _staged_tiles).
//
// Left to later work: for K1/K4, more independent work per SM than two
// blocks of 256 threads give (shared memory holds two ciphertexts at 2_2);
// for K3/K5, this body's NTT (they keep the radix-2 ntt_forward and
// ntt_inverse below) and what bounds a full round; K5's per-launch cost;
// the variant phase gathers (2(V-1) per slot and ciphertext, one
// interleaved 8-byte gather would halve them); for K6's cluster step, the
// L2 latency of its region work (more warps a SM, or the next task's
// loads issued early), the exchange and gather at C = 16, and each key
// word shared by two ciphertexts of a cluster for the variant MAC (its
// key slice, 8.4 MB a step at 3_3 GROUP_3, is read from L2 by every
// ciphertext).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;        // a variant block
constexpr int DELTA_THREADS = 256;  // a delta block

// In-place forward negacyclic NTT of `npoly` polynomials of size n = 2^log_n
// (Cooley-Tukey, psi merged; natural order in, bit-reversed order out).
__device__ void ntt_forward(uint32_t* a, int npoly, int log_n,
                            const uint32_t* __restrict__ w,
                            const uint32_t* __restrict__ ws, uint32_t p) {
  const int n = 1 << log_n, half = n >> 1, total = npoly * half;
  for (int m = 1, lt = log_n - 1; m < n; m <<= 1, --lt) {
    const int t = 1 << lt;
    for (int x = threadIdx.x; x < total; x += blockDim.x) {
      const int q = x & (half - 1);
      const int i = q >> lt;
      const int j = (i << (lt + 1)) + (q & (t - 1));
      uint32_t* v = a + (x >> (log_n - 1)) * n;
      const uint32_t u = v[j];
      const uint32_t y = mul_shoup(v[j + t], __ldg(w + m + i), __ldg(ws + m + i), p);
      v[j] = add_mod(u, y, p);
      v[j + t] = sub_mod(u, y, p);
    }
    __syncthreads();
  }
}

// In-place inverse (Gentleman-Sande, psi^-1 merged; bit-reversed in, natural
// out), without the 1/N factor: the caller folds it into the phase table.
__device__ void ntt_inverse(uint32_t* a, int npoly, int log_n,
                            const uint32_t* __restrict__ w,
                            const uint32_t* __restrict__ ws, uint32_t p) {
  const int n = 1 << log_n, half = n >> 1, total = npoly * half;
  for (int h = half, lt = 0; h >= 1; h >>= 1, ++lt) {
    const int t = 1 << lt;
    for (int x = threadIdx.x; x < total; x += blockDim.x) {
      const int q = x & (half - 1);
      const int i = q >> lt;
      const int j = (i << (lt + 1)) + (q & (t - 1));
      uint32_t* v = a + (x >> (log_n - 1)) * n;
      const uint32_t u = v[j], y = v[j + t];
      v[j] = add_mod(u, y, p);
      v[j + t] = mul_shoup(sub_mod(u, y, p), __ldg(w + h + i), __ldg(ws + h + i), p);
    }
    __syncthreads();
  }
}

// Balanced digits of acc [R][N] (signed_decompose), reduced mod p, into
// spec [J][N]: digit (l, r) goes to row j = l*R + r.
__device__ __forceinline__ void decompose(const uint64_t* acc, uint32_t* spec, int R,
                                          int log_n, int L, int base_log, uint32_t p) {
  const int n = 1 << log_n, RN = R * n;
  const int shift = 64 - base_log * L;
  const uint64_t round = shift > 0 ? (1ull << (shift - 1)) : 0ull;
  const uint64_t dmask = (1ull << base_log) - 1, dhalf = 1ull << (base_log - 1);
  for (int i = threadIdx.x; i < RN; i += blockDim.x) {
    const int r = i >> log_n, k = i & (n - 1);
    uint64_t s = shift > 0 ? (acc[i] + round) >> shift : acc[i];
    for (int l = L - 1; l >= 0; --l) {
      const uint64_t raw = s & dmask;
      const uint64_t carry = (raw + dhalf) >> base_log;
      const int64_t d = (int64_t)raw - (int64_t)(carry << base_log);
      s = (s >> base_log) + carry;
      spec[(l * R + r) * n + k] = d < 0 ? (uint32_t)(d + p) : (uint32_t)d;
    }
  }
}

// Residues res[a * stride + i] (a < P) -> signed-lifted integer mod 2^64.
__device__ __forceinline__ uint64_t garner(const uint32_t* res, int i, int stride,
                                           int P, const u64* __restrict__ cs) {
  uint32_t t[MAXP];
  t[0] = res[i];
  uint64_t c = t[0];
#pragma unroll
  for (int a = 1; a < MAXP; ++a) {
    if (a >= P) break;
    const uint32_t pa = (uint32_t)__ldg(cs + C_P + a);
    uint32_t acc = 0;
#pragma unroll
    for (int b = 0; b < a; ++b)
      acc = add_mod(acc, mul_shoup(t[b], (uint32_t)__ldg(cs + C_GW + a * 8 + b),
                                   (uint32_t)__ldg(cs + C_GW_SH + a * 8 + b), pa), pa);
    t[a] = mul_shoup(sub_mod(res[a * stride + i], acc, pa),
                     (uint32_t)__ldg(cs + C_GINV + a),
                     (uint32_t)__ldg(cs + C_GINV_SH + a), pa);
    c += (uint64_t)t[a] * __ldg(cs + C_PREFIX + a);
  }
  bool ge = false, eq = true;
#pragma unroll
  for (int a = MAXP - 1; a >= 0; --a) {
    if (a >= P) continue;
    const uint32_t h = (uint32_t)__ldg(cs + C_HALF + a);
    ge = ge || (eq && t[a] > h);
    eq = eq && (t[a] == h);
  }
  return (ge || eq) ? c - __ldg(cs + C_MMOD) : c;
}

// tab (u32), the variant body's tables: psi_rev [P][N], its Shoup twin,
// psi_inv_rev [P][N], its twin, [P][2N] rows it does not read, pw [P][2N] =
// psi^m, its twin.

// The words a decomposition starts from: a torus word rounded to the top
// base_log * L bits (signed_decompose's closest representable value).
__device__ __forceinline__ uint64_t round_word(uint64_t a, int shift) {
  return shift > 0 ? (a + (1ull << (shift - 1))) >> shift : a;
}

// The next balanced digit (least significant first) of each of 2^RL
// rounded words: s[k] loses it, v[k] gets it, in (-B/2, B/2].  With
// shift >= 33 the rounded value and its carries fit 32 bits.  K6's first
// pass splits once for all primes; K1's decompose_pass keeps its own copy
// of the split, which reduces for its prime in the same loop: calling this
// one made K1 0.9% slower at 2_2 (same-call turns on the card, PERF.md).
template <int RL>
__device__ __forceinline__ void next_digits(uint64_t (&s)[1 << RL], int32_t (&v)[1 << RL],
                                            int base_log, int shift) {
  if (shift >= 33) {
    const uint32_t dmask = (1u << base_log) - 1, dhalf = 1u << (base_log - 1);
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) {
      const uint32_t raw = (uint32_t)s[k] & dmask;
      const uint32_t carry = (raw + dhalf) >> base_log;
      v[k] = (int32_t)raw - (int32_t)(carry << base_log);
      s[k] = ((uint32_t)s[k] >> base_log) + carry;
    }
  } else {
    const uint64_t dmask = (1ull << base_log) - 1, dhalf = 1ull << (base_log - 1);
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) {
      const uint64_t raw = s[k] & dmask;
      const uint64_t carry = (raw + dhalf) >> base_log;
      v[k] = (int32_t)((int64_t)raw - (int64_t)(carry << base_log));
      s[k] = (s[k] >> base_log) + carry;
    }
  }
}

// K1/K4.  bsk [steps][P][J][R][N], exps [B][steps] (row stride e_stride);
// acc [B][R][N] is updated in place.  Per step and prime: the head passes
// (the first decomposes acc), a block barrier after each; the tail passes,
// the MAC and the inverse tail, either one warp per 256-slot region with
// warp barriers only (`regions`: 2 block barriers a prime) or with a block
// barrier after the tail and after the MAC (4 a prime); a block barrier;
// the inverse head passes (a block barrier between two), the top one
// lifting into acc on the last prime.  RT outputs per MAC item, R/RT items
// per 4-slot group; WIDE for J > 16 digit rows (the MAC reduces inside its
// j loop; the kernels for J <= 16 keep the loop without it).  When launched
// with programmatic stream serialization (K4) the next launch may be
// scheduled as soon as every block has started, and waits for this one's
// results.
template <int RT, int LN, int PT, bool WIDE>
__global__ void __launch_bounds__(DELTA_THREADS, 2)
delta_kernel(int64_t* __restrict__ acc_g, const int32_t* __restrict__ exps,
             long long e_stride, const uint32_t* __restrict__ bsk,
             const uint32_t* __restrict__ dtab, const __grid_constant__ DeltaConsts g,
             int n_steps, int log_n, int P, int R, int L, int base_log, unsigned head,
             unsigned tail, int log_w) {
  // LN > 0: a kernel for N = 2^LN and P = PT under the layout of one head
  // pass of radix log LN - 8 and the 256-coefficient tail, its shifts and
  // the prime loop's counts constants
  constexpr int TOP = LN > 0 ? LN - 8 : 0;
  // every warp a 256-slot region of its own: steps 2-4 without block barriers
  const bool regions = LN > 0 ? (1 << (LN - 8)) >= DELTA_THREADS / 32
                              : log_w == 8 && tail == TAIL256 &&
                                    (1 << (log_n - 8)) >= DELTA_THREADS / 32;
  if constexpr (LN > 0) {
    log_n = LN;
    P = PT;
  }
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n, J = L * R, RN = R * n;
  uint64_t* acc = reinterpret_cast<uint64_t*>(smem);            // [R][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(acc + RN);       // [J][N], swizzled
  uint32_t* res = spec + J * n;                                 // [P][R][N], swizzled
  const uint2* fwd = reinterpret_cast<const uint2*>(dtab);      // [P][N]
  const uint2* inv = fwd + P * n;                               // [P][N]
  const uint2* phase = inv + P * n;                             // [P][2N]

  int64_t* acc_b = acc_g + (size_t)blockIdx.x * RN;
  const int32_t* e_b = exps + (long long)blockIdx.x * e_stride;
  for (int i = threadIdx.x; i < RN; i += blockDim.x) acc[i] = (uint64_t)acc_b[i];
  __syncthreads();

  const int nhead = pass_count(head), top = pass_radix(head, 0);
  const int groups = n >> 2, items = (R / RT) * groups;
  const size_t step_stride = (size_t)P * J * RN;
  for (int step = 0; step < n_steps; ++step) {
    const uint32_t* key = bsk + step * step_stride;
    const uint32_t e = (uint32_t)__ldg(e_b + step);
#pragma unroll 1
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = g.p[pi];
      const u64 mu = g.mu[pi];
      const uint2* fwd_p = fwd + pi * n;
      const uint2* inv_p = inv + pi * n;
      uint32_t* res_p = res + pi * RN;
      const uint32_t* key_p = key + (size_t)pi * J * RN;
      const uint2* phase_p = phase + pi * 2 * n;
      // 1. digits, in the first forward pass, and the other head passes
      if constexpr (TOP > 0) {
        decompose_pass<TOP>([acc](int i) { return acc[i]; }, spec, R, L, log_n, base_log, fwd_p,
                            p);
      } else {
        decompose_pass_r(top, [acc](int i) { return acc[i]; }, spec, R, L, log_n, base_log,
                         fwd_p, p);
        for (int i = 1, lo = log_n - top; i < nhead; ++i) {
          const int r = pass_radix(head, i);
          lo -= r;
          __syncthreads();
          block_pass_r<true>(r, spec, J, log_n, lo, fwd_p, p);
        }
      }
      __syncthreads();
      if (regions) {
        region_pipeline<RT, WIDE>(key_p, spec, res_p, J, R, log_n, fwd_p, inv_p, phase_p, e, p,
                                  mu);
      } else {
        // 2. the forward tail; 3. the MAC, between the last two forward and
        // the first two inverse stages; 4. the inverse tail
        if constexpr (TOP > 0) tail256_passes<true>(spec, J, log_n, fwd_p, p);
        else tail_passes<true>(spec, J, log_n, log_w, tail, fwd_p, p);
        __syncthreads();
        for (int f = threadIdx.x; f < items; f += blockDim.x)
          mac_group<RT, WIDE>(spec, res_p, key_p, f & (groups - 1), (f >> (log_n - 2)) * RT, J, R,
                        log_n, log_n, swz(4 * (f & (groups - 1))), fwd_p, inv_p, phase_p, e,
                        p, mu);
        __syncthreads();
        if constexpr (TOP > 0) tail256_passes<false>(res_p, R, log_n, inv_p, p);
        else tail_passes<false>(res_p, R, log_n, log_w, tail, inv_p, p);
      }
      __syncthreads();
      // 5. the other inverse head passes, then the top one; on the last
      // prime it lifts with Garner into acc
      int64_t* acc_out = step == n_steps - 1 ? acc_b : nullptr;
      if constexpr (TOP > 0) {
        top_inverse_pass<TOP, PT>(res, pi, P, R, log_n, inv_p, p, pi == P - 1, acc, acc_out,
                                  g);
      } else {
        for (int i = nhead - 1, lo = log_w; i >= 1; --i) {
          const int r = pass_radix(head, i);
          block_pass_r<false>(r, res_p, R, log_n, lo, inv_p, p);
          lo += r;
          __syncthreads();
        }
        top_inverse_pass_r(top, res, pi, P, R, log_n, inv_p, p, pi == P - 1, acc, acc_out, g);
      }
    }
  }
}

// Block c's dynamic shared memory, as this block sees it through the
// cluster (its own for C = 1).  All blocks share one layout, so one mapped
// base per peer serves its spectra and its products.
template <int C>
__device__ __forceinline__ unsigned char* peer(unsigned char* base, int c) {
  if constexpr (C == 1) {
    return base;
  } else {
    return cg::this_cluster().map_shared_rank(base, (unsigned)c);
  }
}

// K3/K5.  bsk [steps][V][P][J][R][N]; exps [B][steps][V-1] (c_v for v =
// 1..V-1, row stride e_stride); acc [B][R][N] is updated in place.  The grid
// is ceil(batch/C)*C blocks in clusters of C; block b owns ciphertext b.
template <int C, int R>
__global__ void __launch_bounds__(THREADS, 2)
variant_kernel(int64_t* __restrict__ acc_g, const int32_t* __restrict__ exps,
               long long e_stride, const uint32_t* __restrict__ bsk,
               const uint32_t* __restrict__ tab, const u64* __restrict__ cs,
               int batch, int n_steps, int log_n, int P, int L, int base_log, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n, J = L * R, RN = R * n;
  uint64_t* acc = reinterpret_cast<uint64_t*>(smem);            // [R][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(acc + RN);       // [J][N]
  uint32_t* res = spec + J * n;                                 // [P][R][N]

  const uint32_t* psi = tab;
  const uint32_t* psi_sh = tab + P * n;
  const uint32_t* ipsi = tab + 2 * P * n;
  const uint32_t* ipsi_sh = tab + 3 * P * n;
  const uint32_t* pw = tab + 8 * P * n;
  const uint32_t* pw_sh = tab + 10 * P * n;

  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int first = blockIdx.x - rank;           // the cluster's first ciphertext
  const int span = n / C, lo = rank * span;      // this block's slots in the MAC
  const bool real = blockIdx.x < batch;          // not a padding block
  int64_t* acc_b = acc_g + (size_t)blockIdx.x * RN;
  for (int i = threadIdx.x; i < RN; i += blockDim.x)
    acc[i] = real ? (uint64_t)acc_b[i] : 0ull;
  __syncthreads();

  const uint32_t two_n_mask = 2u * n - 1;
  const size_t var_stride = (size_t)P * J * RN;   // one GGSW's spectra
  const size_t step_stride = V * var_stride;

  for (int step = 0; step < n_steps; ++step) {
    const uint32_t* key = bsk + step * step_stride;
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = (uint32_t)__ldg(cs + C_P + pi);
      // 1. balanced digits of acc, 2. forward NTT of the J digit polynomials
      decompose(acc, spec, R, log_n, L, base_log, p);
      __syncthreads();
      ntt_forward(spec, J, log_n, psi + pi * n, psi_sh + pi * n, p);
      if constexpr (C > 1) cg::this_cluster().sync();   // every peer's spectra ready
      // 3. MAC over this block's slots for the C ciphertexts of the cluster
      const uint32_t* key_p = key + (size_t)pi * J * RN;
      const u64 mu = __ldg(cs + C_MU + pi);
      const uint32_t* pw_p = pw + pi * 2 * n;
      const uint32_t* pw_sh_p = pw_sh + pi * 2 * n;
      const uint32_t ninv = (uint32_t)__ldg(cs + C_NINV + pi);
      const uint32_t ninv_sh = (uint32_t)__ldg(cs + C_NINV_SH + pi);
      // byte offsets of spec and of res[pi] in any block's shared memory
      const size_t spec_at = (size_t)8 * RN, res_at = spec_at + (size_t)4 * (J * n + pi * RN);
      for (int k = lo + threadIdx.x; k < lo + span; k += blockDim.x) {
        const uint32_t odd = 2u * (__brev((unsigned)k) >> (32 - log_n)) + 1u;
        uint64_t s[C][R];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int r = 0; r < R; ++r) s[c][r] = 0;
        int count = 0;   // products in each sum since its last reduction
        for (int v = 0; v < V; ++v) {
          uint32_t ph[C], ph_sh[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            ph[c] = 1;
            ph_sh[c] = 0;
            if (v > 0) {
              const int b = first + c;
              const uint32_t e = b < batch
                  ? (uint32_t)__ldg(exps + (long long)b * e_stride + step * (V - 1) + v - 1)
                  : 0u;
              const uint32_t m = (e * odd) & two_n_mask;
              ph[c] = __ldg(pw_p + m);
              ph_sh[c] = __ldg(pw_sh_p + m);
            }
          }
          const uint32_t* key_v = key_p + v * var_stride;
          // the J products in runs of at most 16 (J > 16: several runs),
          // each sum reduced before the product that would pass 16
          for (int j0 = 0; j0 < J; j0 += MAX_PRODUCTS) {
            const int j1 = min(J, j0 + MAX_PRODUCTS);
            if (count + (j1 - j0) > MAX_PRODUCTS) {
#pragma unroll
              for (int c = 0; c < C; ++c)
#pragma unroll
                for (int r = 0; r < R; ++r) s[c][r] = barrett(s[c][r], p, mu);
              count = 0;
            }
            for (int j = j0; j < j1; ++j) {
              uint32_t w[R];
#pragma unroll
              for (int r = 0; r < R; ++r) w[r] = __ldg(key_v + (size_t)(j * R + r) * n + k);
#pragma unroll
              for (int c = 0; c < C; ++c) {
                uint32_t d =
                    reinterpret_cast<const uint32_t*>(peer<C>(smem, c) + spec_at)[j * n + k];
                if (v > 0) d = mul_shoup(d, ph[c], ph_sh[c], p);
#pragma unroll
                for (int r = 0; r < R; ++r) s[c][r] += (uint64_t)d * w[r];
              }
            }
            count += j1 - j0;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          uint32_t* out = reinterpret_cast<uint32_t*>(peer<C>(smem, c) + res_at) + k;
#pragma unroll
          for (int r = 0; r < R; ++r)
            out[r * n] = mul_shoup(barrett(s[c][r], p, mu), ninv, ninv_sh, p);
        }
      }
      // every peer's products written (and no peer reads this block's spec)
      if constexpr (C > 1) cg::this_cluster().sync(); else __syncthreads();
      // 4. inverse NTT of the R products
      ntt_inverse(res + pi * RN, R, log_n, ipsi + pi * n, ipsi_sh + pi * n, p);
    }
    // 5. CRT back to the torus: the step replaces acc
    for (int i = threadIdx.x; i < RN; i += blockDim.x) acc[i] = garner(res, i, RN, P, cs);
    __syncthreads();
  }
  if (real)
    for (int i = threadIdx.x; i < RN; i += blockDim.x) acc_b[i] = (int64_t)acc[i];
}

// ---- K6's passes form (rotation.py _staged_layout) ------------------------
//
// The working set of a ciphertext stays in device memory: spec [B][P][J][N]
// and res [B][P][R][N] u32 scratch, each polynomial swizzled in 256-word
// blocks as the delta body keeps one in shared memory, so that a head pass
// is pass_item over device memory and a region is one contiguous run of
// words.  Per step: the first forward pass (digits fused, all primes), the
// other forward head passes, the region kernel (K1's region pipeline on
// one warp's region), the inverse head passes, the last inverse pass with
// Garner over the primes.  Each kernel waits for the one before it
// (programmatic dependent launch: it is scheduled while that one drains).

constexpr int STAGED_THREADS = 256;   // a head-pass block

__device__ __forceinline__ long long global_thread() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// Let the next launch be scheduled, then wait for the previous one's results.
__device__ __forceinline__ void wait_for_previous_launch() {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The cluster barrier in two halves.  A block arrives as it starts
// (relaxed: the arrival orders no memory) and waits before it first
// writes a peer's shared memory: after the wait every block of the
// cluster has started, which distributed shared memory requires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The first forward pass: item (b, r, off) reads acc[b][r][off + k*N/2^RL]
// (k < 2^RL), splits each word into its L balanced digits and, for every
// prime, takes them through the top RL stages into spec[b][pi][l*R + r].
template <int RL>
__global__ void __launch_bounds__(STAGED_THREADS, 2)
staged_first_pass(const int64_t* __restrict__ acc, uint32_t* __restrict__ spec,
                  const uint2* __restrict__ fwd, const __grid_constant__ DeltaConsts g,
                  int batch, int log_n, int P, int R, int L, int base_log) {
  wait_for_previous_launch();
  const int lo = log_n - RL, J = L * R, shift = 64 - base_log * L;
  const long long f = global_thread();
  if (f >= ((long long)batch * R << lo)) return;
  const long long br = f >> lo;   // b * R + r
  const int off = (int)(f & ((1 << lo) - 1)), r = (int)(br % R);
  const long long b = br / R;
  uint64_t s[1 << RL];
#pragma unroll
  for (int k = 0; k < (1 << RL); ++k)
    s[k] = round_word((uint64_t)acc[(br << log_n) + off + (k << lo)], shift);
  for (int l = L - 1; l >= 0; --l) {
    int32_t v[1 << RL];
    next_digits<RL>(s, v, base_log, shift);
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = g.p[pi];
      uint2 tw[8];
      load_twiddles<RL>(tw, fwd + ((size_t)pi << log_n), 1);
      uint32_t d[1 << RL];
#pragma unroll
      for (int k = 0; k < (1 << RL); ++k)
        d[k] = v[k] < 0 ? (uint32_t)(v[k] + (int32_t)p) : (uint32_t)v[k];
      ct_stages<RL>(d, tw, p);
      uint32_t* poly = spec + ((((size_t)b * P + pi) * J + l * R + r) << log_n);
#pragma unroll
      for (int k = 0; k < (1 << RL); ++k) poly[swz_at(off, k, lo)] = d[k];
    }
  }
}

// A head pass between the first and the last: item (b, pi, poly, it) takes
// 2^RL coefficients at stride 2^lo of arr[b][pi][poly] through RL stages
// (block_pass's items, spread over the grid).
template <int RL, bool FWD>
__global__ void __launch_bounds__(STAGED_THREADS, 4)
staged_head_pass(uint32_t* __restrict__ arr, const uint2* __restrict__ tw,
                 const __grid_constant__ DeltaConsts g, int batch, int log_n, int P, int npoly,
                 int lo) {
  wait_for_previous_launch();
  const int lg = log_n - RL;
  const long long f = global_thread();
  if (f >= ((long long)batch * P * npoly << lg)) return;
  const long long poly = f >> lg;
  const int pi = (int)((poly / npoly) % P);
  const int it = (int)(f & ((1 << lg) - 1)), blk = it >> lo;
  pass_item<RL, FWD>(arr + (poly << log_n), (1 << (lg - lo)) + blk,
                     (blk << (lo + RL)) + (it & ((1 << lo) - 1)), lo,
                     tw + ((size_t)pi << log_n), g.p[pi]);
}

// The last two forward stages of slots [4x, 4x+4) of `npoly` digit
// polynomials (their words at row + at, `stride` apart), fully reduced, in
// place; the twiddles loaded once for all of them.
__device__ __forceinline__ void finish_group(uint32_t* row, int stride, int npoly, int x, int at,
                                             int log_n, const uint2* __restrict__ fwd,
                                             uint32_t p) {
  uint2 fw[8];
  load_twiddles<2>(fw, fwd, (1 << (log_n - 2)) + x);
#pragma unroll 2
  for (int j = 0; j < npoly; ++j) {
    uint32_t* v4 = row + j * stride + at;
    const uint4 v = *reinterpret_cast<const uint4*>(v4);
    uint32_t a[4] = {v.x, v.y, v.z, v.w};
    ct_stages<2>(a, fw, p);
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = csub(csub(a[c], 2 * p), p);
    *reinterpret_cast<uint4*>(v4) = make_uint4(a[0], a[1], a[2], a[3]);
  }
}

// The variant MAC of slots [4x, 4x+4) for outputs r0..r0+RT-1 on fully
// transformed digit spectra (rows 2^log_s words apart, the group's words at
// `at`): the sum over v < V and j < J of digit_j * X^{c_v}/N * key[v][j][r],
// the phase psi^(c_v (2 brv(k) + 1))/N gathered once per slot and variant
// (c_0 = 0; e_b holds c_1..c_{V-1}), each sum reduced before its 17th
// product; then one Barrett reduction and the first two inverse stages.
template <int RT>
__device__ __forceinline__ void mac_variants(const uint32_t* spec, uint32_t* res,
                                             const uint32_t* __restrict__ key_p,
                                             size_t var_stride, int x, int r0, int J, int R,
                                             int V, int log_n, int log_s, int at,
                                             const uint2* __restrict__ inv,
                                             const uint2* __restrict__ phase,
                                             const int32_t* __restrict__ e_b, uint32_t p,
                                             u64 mu) {
  const int q = (1 << (log_n - 2)) + x, k0 = 4 * x;
  const uint32_t two_n_mask = (2u << log_n) - 1;
  uint32_t odd[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) odd[c] = 2u * (__brev((unsigned)(k0 + c)) >> (32 - log_n)) + 1u;
  uint2 iw[8];
  load_twiddles<2>(iw, inv, q);
  uint64_t s[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0;
  // the phases of variant v + 1 are loaded while variant v's products run
  uint2 ph[4], next[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ph[c] = __ldg(phase);   // c_0 = 0: psi^0 / N
  int count = 0;   // products in each sum since its last reduction
  for (int v = 0; v < V; ++v) {
    if (v + 1 < V) {
      const uint32_t e = (uint32_t)__ldg(e_b + v);
#pragma unroll
      for (int c = 0; c < 4; ++c) next[c] = __ldg(phase + ((e * odd[c]) & two_n_mask));
    }
    const uint32_t* key_v = key_p + v * var_stride;
    for (int j0 = 0; j0 < J; j0 += MAX_PRODUCTS) {
      const int j1 = min(J, j0 + MAX_PRODUCTS);
      if (count + (j1 - j0) > MAX_PRODUCTS) {
        reduce_sums<RT>(s, p, mu);
        count = 0;
      }
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        uint4 w[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          w[r] = __ldg(reinterpret_cast<const uint4*>(
              key_v + (((j * R + r0 + r) << log_n) + k0)));
        const uint4 d = *reinterpret_cast<const uint4*>(spec + (j << log_s) + at);
        const uint32_t a[4] = {mul_shoup(d.x, ph[0].x, ph[0].y, p),
                               mul_shoup(d.y, ph[1].x, ph[1].y, p),
                               mul_shoup(d.z, ph[2].x, ph[2].y, p),
                               mul_shoup(d.w, ph[3].x, ph[3].y, p)};
        mac4<RT>(s, a, w);
      }
      count += j1 - j0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) ph[c] = next[c];
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    uint32_t a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = barrett(s[r][c], p, mu);
    gs_stages<2>(a, iw, p);
    *reinterpret_cast<uint4*>(res + ((r0 + r) << log_s) + at) =
        make_uint4(a[0], a[1], a[2], a[3]);
  }
}

// The region kernel: one warp per task (pi, region, b), b fastest, so that
// neighbouring warps read the same key words.  The warp copies the region's
// J digit polynomials into its shared memory, runs their forward tail, the
// MAC (mac_group) and the inverse tail of the R products, and copies those
// out: K1's region pipeline on one region of 2^log_w slots.  tab is
// _delta_tables' layout: fwd [P][N], inv [P][N], phase [P][2N] (value, twin).
template <int RT>
__global__ void __launch_bounds__(256, 2)
staged_region(const uint32_t* __restrict__ spec_g, uint32_t* __restrict__ res_g,
              const uint32_t* __restrict__ bsk, const int32_t* __restrict__ exps,
              long long e_stride, const uint2* __restrict__ tab,
              const __grid_constant__ DeltaConsts g, int batch, int log_n, int P, int R, int J,
              unsigned tail, int log_w) {
  wait_for_previous_launch();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, log_r = log_n - log_w;
  const long long task = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (task >= ((long long)batch * P << log_r)) return;
  const long long b = task % batch, rest = task / batch;
  const int gi = (int)(rest & ((1 << log_r) - 1)), pi = (int)(rest >> log_r);
  const int W = 1 << log_w, base = gi << log_w, groups = W >> 2, x0 = base >> 2;
  uint32_t* spec = reinterpret_cast<uint32_t*>(smem) + (size_t)warp * (J + R) * W;   // [J][W]
  uint32_t* res = spec + (size_t)J * W;                                              // [R][W]
  const uint32_t p = g.p[pi];
  const u64 mu = g.mu[pi];
  const uint2* fwd = tab + ((size_t)pi << log_n);
  const uint2* inv = tab + ((size_t)(P + pi) << log_n);
  const uint2* phase = tab + ((size_t)(2 * P + 2 * pi) << log_n);
  const uint32_t* key_p = bsk + ((size_t)pi * J * R << log_n);
  const uint32_t* src = spec_g + ((((size_t)b * P + pi) * J) << log_n) + base;
  for (int j = 0; j < J; ++j)
    for (int i = 4 * lane; i < W; i += 128)
      *reinterpret_cast<uint4*>(spec + j * W + i) =
          *reinterpret_cast<const uint4*>(src + ((size_t)j << log_n) + i);
  __syncwarp();
  for (int j = 0; j < J; ++j) region_tails<true>(spec + j * W, base, log_n, log_w, tail, fwd, p);
  const uint32_t e = (uint32_t)__ldg(exps + b * e_stride);
  for (int f = lane; f < (R / RT) * groups; f += 32) {
    const int x = x0 + f % groups;
    mac_group<RT, true>(spec, res, key_p, x, (f / groups) * RT, J, R, log_n, log_w,
                        swz(4 * x) - base, fwd, inv, phase, e, p, mu);
  }
  __syncwarp();
  for (int r = 0; r < R; ++r) region_tails<false>(res + r * W, base, log_n, log_w, tail, inv, p);
  uint32_t* dst = res_g + ((((size_t)b * P + pi) * R) << log_n) + base;
  for (int r = 0; r < R; ++r)
    for (int i = 4 * lane; i < W; i += 128)
      *reinterpret_cast<uint4*>(dst + ((size_t)r << log_n) + i) =
          *reinterpret_cast<const uint4*>(res + r * W + i);
}

// The last inverse pass: the top RL stages of item (b, r, off) for every
// prime, then Garner over the primes; acc[b][r][off + k*N/2^RL] gains the
// lifted value.
template <int RL>
__global__ void __launch_bounds__(STAGED_THREADS, 2)
staged_last_pass(int64_t* __restrict__ acc, const uint32_t* __restrict__ res,
                 const uint2* __restrict__ inv, const __grid_constant__ DeltaConsts g,
                 int batch, int log_n, int P, int R) {
  wait_for_previous_launch();
  const int lo = log_n - RL;
  const long long f = global_thread();
  if (f >= ((long long)batch * R << lo)) return;
  const long long br = f >> lo;   // b * R + r
  const int off = (int)(f & ((1 << lo) - 1)), r = (int)(br % R);
  const long long b = br / R;
  uint32_t a[MAXP][1 << RL];
#pragma unroll
  for (int pi = 0; pi < MAXP; ++pi) {
    if (pi >= P) break;
    const uint32_t p = g.p[pi];
    uint2 tw[8];
    load_twiddles<RL>(tw, inv + ((size_t)pi << log_n), 1);
    const uint32_t* poly = res + ((((size_t)b * P + pi) * R + r) << log_n);
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) a[pi][k] = poly[swz_at(off, k, lo)];
    gs_stages<RL>(a[pi], tw, p);
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) a[pi][k] = csub(a[pi][k], p);
  }
#pragma unroll
  for (int k = 0; k < (1 << RL); ++k) {
    const uint64_t v = garner_from<0>([&](int i) { return a[i][k]; }, P, g);
    int64_t* w = acc + (br << log_n) + off + (k << lo);
    *w = (int64_t)((uint64_t)*w + v);
  }
}

// ---- K6, the cluster step (rotation.py _cluster_layout) --------------------
//
// A cluster of C = 2^CL blocks owns one ciphertext's step, one cluster per
// ciphertext, one launch a step.  Block q keeps the region [q*W, (q+1)*W),
// W = N/C, of every polynomial of the transform: the slots the top CL
// forward stages give it.  Its shared memory holds a group of ps primes'
// J digit spectra [ps][J][W] and every prime's R products [P][R][W] of its
// region; the accumulator stays in device memory and is read for the
// digits and written by the lift, each word by the one block whose column
// share holds it.  Per group of primes: the exchange (the top CL stages
// across the cluster, the digits fused), a cluster barrier, K1's passes on
// the region (in-block head passes, then one warp per (prime, tail region):
// the forward tails, the MAC, the inverse tails; the inverse head passes),
// a cluster barrier; then the gather (the bottom CL inverse stages across
// the cluster) with Garner into acc, and a last cluster barrier that keeps
// a block's shared memory alive while its peers read it.

// The threads of a cluster-step block, for clusters of 2^cl blocks: 256
// (two blocks a SM where shared memory allows), 512 at 16 blocks, whose
// radix-16 exchange and gather hold one block to a SM: on the H100, 16
// warps at 128 registers (a few hundred bytes of spills) ran 4_4 faster
// than 8 warps without spills.
__host__ __device__ constexpr int cluster_threads(int cl) { return cl >= 4 ? 512 : 256; }
constexpr int CLUSTER_MAXP = 4;   // primes the lift holds in registers

// Where block k keeps slot `off` of its region of a polynomial: the delta
// body's swizzle of the slot's place in the whole transform, relative to
// the region (a region of 32 slots or more keeps its words).
__device__ __forceinline__ int region_word(int off, int k, int log_w) {
  return swz(off + (k << log_w)) - (k << log_w);
}

// A head pass at stride 2^lo over the block's region [base, base + 2^log_w)
// of a transform of 2^log_n, for `ps` primes from p0 with `npoly`
// polynomials each (prime p0 + i's polynomial j at arr + (i * npoly + j) *
// 2^log_w): item (i, it) loads its twiddles once and takes them through
// every polynomial of its prime.
template <int RL, bool FWD>
__device__ void region_pass(uint32_t* arr, int ps, int npoly, int log_n, int log_w, int base,
                            int lo, const uint2* __restrict__ t, int p0, const DeltaConsts& g) {
  const int lg = log_w - RL;   // log2 of the items per polynomial
  for (int f = threadIdx.x; f < (ps << lg); f += blockDim.x) {
    const int i = f >> lg, it = f & ((1 << lg) - 1), blk = (base >> (lo + RL)) + (it >> lo);
    const int b0 = (blk << (lo + RL)) + (it & ((1 << lo) - 1));
    const uint32_t p = g.p[p0 + i];
    uint2 tw[8];
    load_twiddles<RL>(tw, t + ((size_t)(p0 + i) << log_n), (1 << (log_n - lo - RL)) + blk);
    uint32_t* poly = arr + ((size_t)i * npoly << log_w);
#pragma unroll 2
    for (int j = 0; j < npoly; ++j) {
      uint32_t* v = poly + ((size_t)j << log_w);
      uint32_t a[1 << RL];
#pragma unroll
      for (int s = 0; s < (1 << RL); ++s) a[s] = v[swz_at(b0, s, lo) - base];
      if constexpr (FWD) ct_stages<RL>(a, tw, p); else gs_stages<RL>(a, tw, p);
#pragma unroll
      for (int s = 0; s < (1 << RL); ++s) v[swz_at(b0, s, lo) - base] = a[s];
    }
  }
}

template <bool FWD>
__device__ void region_pass_r(int r, uint32_t* arr, int ps, int npoly, int log_n, int log_w,
                              int base, int lo, const uint2* __restrict__ t, int p0,
                              const DeltaConsts& g) {
  switch (r) {
    case 1: region_pass<1, FWD>(arr, ps, npoly, log_n, log_w, base, lo, t, p0, g); break;
    case 2: region_pass<2, FWD>(arr, ps, npoly, log_n, log_w, base, lo, t, p0, g); break;
    default: region_pass<3, FWD>(arr, ps, npoly, log_n, log_w, base, lo, t, p0, g); break;
  }
}

// Both tail passes of the 256-slot region blk in `npoly` polynomials (their
// region words `stride` apart from `region`), by one warp, each pass's
// twiddles loaded once for all of them; the lanes' items as
// tail256_stride32 and tail256_stride4 take them.
template <bool FWD>
__device__ __forceinline__ void tail256_polys(uint32_t* region, int stride, int npoly, int blk,
                                              int log_n, const uint2* __restrict__ t,
                                              uint32_t p) {
  const int lane = threadIdx.x & 31, x = lane & 28;
  uint2 t32[8], t4[8];
  load_twiddles<3>(t32, t, (1 << (log_n - 8)) + blk);
  load_twiddles<3>(t4, t, (1 << (log_n - 5)) + 8 * blk + (lane >> 2));
  const auto wide = [&](uint32_t* r) {   // stride 32: lane holds r[lane + 32s]
    uint32_t a[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] = r[32 * s + (lane ^ (4 * s))];
    if constexpr (FWD) ct_stages<3>(a, t32, p); else gs_stages<3>(a, t32, p);
#pragma unroll
    for (int s = 0; s < 8; ++s) r[32 * s + (lane ^ (4 * s))] = a[s];
  };
  const auto narrow = [&](uint32_t* r) {   // stride 4
    uint32_t* b = r + 8 * x + (lane & 3);
    uint32_t a[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] = b[(4 * s) ^ x];
    if constexpr (FWD) ct_stages<3>(a, t4, p); else gs_stages<3>(a, t4, p);
#pragma unroll
    for (int s = 0; s < 8; ++s) b[(4 * s) ^ x] = a[s];
  };
#pragma unroll 2
  for (int j = 0; j < npoly; ++j) {
    if constexpr (FWD) wide(region + j * stride); else narrow(region + j * stride);
  }
  __syncwarp();
#pragma unroll 2
  for (int j = 0; j < npoly; ++j) {
    if constexpr (FWD) narrow(region + j * stride); else wide(region + j * stride);
  }
  __syncwarp();
}

// The tail passes of one warp's tail region (2^log_t slots from tb, its
// words at `region` in each of `npoly` polynomials `stride` apart).
template <bool FWD>
__device__ __forceinline__ void tail_polys(uint32_t* region, int stride, int npoly, int tb,
                                           int log_n, int log_t, unsigned tail,
                                           const uint2* __restrict__ t, uint32_t p) {
  if (log_t == 8 && tail == TAIL256) {
    tail256_polys<FWD>(region, stride, npoly, tb >> 8, log_n, t, p);
    return;
  }
  for (int j = 0; j < npoly; ++j)
    region_tails<FWD>(region + j * stride, tb, log_n, log_t, tail, t, p);
}

// The exchange: the top CL forward stages, across the cluster.  Item (r,
// off), off in block q's column share [q*W/C, (q+1)*W/C), reads acc[r][off
// + k*W] (k < C), splits each word into its L balanced digits and, for
// each prime of the group from p0, takes them through the CL stages in
// registers (heap node 1) and writes output k into block k's spectra, row
// (prime - p0, l*R + r), slot off.  Where the block has `split` threads
// for each item (at C = 16), thread s of an item takes every split-th
// prime from s.
template <int CL, class Cluster>
__device__ void cluster_exchange(Cluster& cluster, const int64_t* acc, unsigned char* smem,
                                 int q, int p0, int ps, int split, int J, int R, int L,
                                 int log_n, int base_log, const uint2* __restrict__ fwd,
                                 const DeltaConsts& g) {
  constexpr int C = 1 << CL;
  const int log_w = log_n - CL, log_s = log_w - CL, shift = 64 - base_log * L;
  const int items = R << log_s;
  if constexpr (CL < 4) split = 1;   // the kernels for C <= 8 keep one thread an item
  for (int f = threadIdx.x; f < items * split; f += blockDim.x) {
    const int first = split > 1 ? f / items : 0, it = split > 1 ? f % items : f;
    const int r = it >> log_s, off = (q << log_s) + (it & ((1 << log_s) - 1));
    uint64_t s[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      s[k] = round_word((uint64_t)acc[(r << log_n) + off + (k << log_w)], shift);
    for (int l = L - 1; l >= 0; --l) {
      int32_t v[C];
      next_digits<CL>(s, v, base_log, shift);
      for (int i = first; i < ps; i += split) {
        const uint32_t p = g.p[p0 + i];
        uint2 tw[C];
        load_twiddles<CL>(tw, fwd + ((size_t)(p0 + i) << log_n), 1);
        uint32_t d[C];
#pragma unroll
        for (int k = 0; k < C; ++k)
          d[k] = v[k] < 0 ? (uint32_t)(v[k] + (int32_t)p) : (uint32_t)v[k];
        ct_stages<CL>(d, tw, p);
        const int row = (i * J + l * R + r) << log_w;
#pragma unroll
        for (int k = 0; k < C; ++k)
          reinterpret_cast<uint32_t*>(cluster.map_shared_rank(smem, (unsigned)k))
              [row + region_word(off, k, log_w)] = d[k];
      }
    }
  }
}

// The gather: the bottom CL inverse stages, across the cluster, and the
// lift.  Item (r, off) of block q's column share reads, for each of the PT
// primes, slot off of every block k's products (the residues of
// coefficient off + k*W), takes them through the CL stages (heap node 1),
// and lifts the residues of each coefficient with Garner into acc (delta:
// adds; VAR: replaces).  res_at: the products' byte offset in a block's
// shared memory.
template <int CL, int PT, bool VAR, class Cluster>
__device__ void cluster_gather(Cluster& cluster, int64_t* acc, unsigned char* smem,
                               size_t res_at, int q, int R, int log_n,
                               const uint2* __restrict__ inv, const DeltaConsts& g) {
  constexpr int C = 1 << CL;
  const int log_w = log_n - CL, log_s = log_w - CL;
  for (int f = threadIdx.x; f < (R << log_s); f += blockDim.x) {
    const int r = f >> log_s, off = (q << log_s) + (f & ((1 << log_s) - 1));
    uint32_t a[PT][C];
#pragma unroll
    for (int pi = 0; pi < PT; ++pi) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        a[pi][k] = reinterpret_cast<const uint32_t*>(
            cluster.map_shared_rank(smem, (unsigned)k) + res_at)
            [((pi * R + r) << log_w) + region_word(off, k, log_w)];
    }
#pragma unroll
    for (int pi = 0; pi < PT; ++pi) {
      const uint32_t p = g.p[pi];
      uint2 tw[C];
      load_twiddles<CL>(tw, inv + ((size_t)pi << log_n), 1);
      gs_stages<CL>(a[pi], tw, p);
#pragma unroll
      for (int k = 0; k < C; ++k) a[pi][k] = csub(a[pi][k], p);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const uint64_t v = garner_from<PT>([&](int i) { return a[i][k]; }, PT, g);
      int64_t* w = acc + (r << log_n) + off + (k << log_w);
      *w = VAR ? (int64_t)v : (int64_t)((uint64_t)*w + v);
    }
  }
}

// The MAC of one warp's tail region (groups 4-slot groups from x0) for
// outputs r0..r0+RT-1 of R: mac_group (delta; e_b[0] the exponent) or
// mac_variants (VAR; e_b holds c_1..c_{V-1}, the digits already through
// their last two stages).  The kernel runs R = 2 (every named set) as one
// chunk and any other R as R chunks of one output, so that it carries two
// widths of the MAC and not four: on the H100 a kernel with all four ran
// 4_4 slower at 128 registers, and a kernel per R more than doubled the
// build.
template <int RT, bool VAR>
__device__ __forceinline__ void region_mac(const uint32_t* sp, uint32_t* rp,
                                           const uint32_t* __restrict__ key_p,
                                           size_t var_stride, int x0, int groups, int r0, int J,
                                           int R, int V, int log_n, int log_w, int base,
                                           const uint2* __restrict__ fwd,
                                           const uint2* __restrict__ inv,
                                           const uint2* __restrict__ phase,
                                           const int32_t* __restrict__ e_b, uint32_t p, u64 mu) {
  const int lane = threadIdx.x & 31;
  if constexpr (VAR) {
    for (int f = lane; f < groups; f += 32)
      mac_variants<RT>(sp, rp, key_p, var_stride, x0 + f, r0, J, R, V, log_n, log_w,
                       swz(4 * (x0 + f)) - base, inv, phase, e_b, p, mu);
  } else {
    const uint32_t e = (uint32_t)__ldg(e_b);
    for (int f = lane; f < groups; f += 32)
      mac_group<RT, true>(sp, rp, key_p, x0 + f, r0, J, R, log_n, log_w,
                          swz(4 * (x0 + f)) - base, fwd, inv, phase, e, p, mu);
  }
}

// The gather in two rounds, where the block has `split` threads for each
// item (at C = 16) and its own spectra buffer, unused by then, holds every
// prime's residues of its column share (`scratch`, [P][C][items] words).
// Round one: thread s of item (r, off) takes every split-th prime from s
// through the bottom CL inverse stages into scratch; after a block barrier,
// round two: it lifts coefficients off + k*W, k in its C/split, from the
// PT residues (Garner) into acc.  It halves each thread's chain of remote
// loads and its registers against cluster_gather (PERF.md).
template <int CL, int PT, bool VAR, class Cluster>
__device__ void cluster_gather_split(Cluster& cluster, int64_t* acc, unsigned char* smem,
                                     size_t res_at, uint32_t* scratch, int split, int q, int R,
                                     int log_n, const uint2* __restrict__ inv,
                                     const DeltaConsts& g) {
  constexpr int C = 1 << CL;
  const int log_w = log_n - CL, log_s = log_w - CL, items = R << log_s;
  for (int f = threadIdx.x; f < items * split; f += blockDim.x) {
    const int first = f / items, it = f % items;
    const int r = it >> log_s, off = (q << log_s) + (it & ((1 << log_s) - 1));
    for (int pi = first; pi < PT; pi += split) {
      uint32_t a[C];
#pragma unroll
      for (int k = 0; k < C; ++k)
        a[k] = reinterpret_cast<const uint32_t*>(
            cluster.map_shared_rank(smem, (unsigned)k) + res_at)
            [((pi * R + r) << log_w) + region_word(off, k, log_w)];
      uint2 tw[C];
      load_twiddles<CL>(tw, inv + ((size_t)pi << log_n), 1);
      gs_stages<CL>(a, tw, g.p[pi]);
#pragma unroll
      for (int k = 0; k < C; ++k) scratch[(pi * C + k) * items + it] = csub(a[k], g.p[pi]);
    }
  }
  __syncthreads();
  const int per = C / split;
  for (int f = threadIdx.x; f < items * split; f += blockDim.x) {
    const int first = f / items, it = f % items;
    const int r = it >> log_s, off = (q << log_s) + (it & ((1 << log_s) - 1));
    for (int k = first * per; k < (first + 1) * per; ++k) {
      const uint64_t v = garner_from<PT>(
          [&](int i) { return scratch[(i * C + k) * items + it]; }, PT, g);
      int64_t* w = acc + (r << log_n) + off + (k << log_w);
      *w = VAR ? (int64_t)v : (int64_t)((uint64_t)*w + v);
    }
  }
}

// K6's cluster step, one step: the grid is B clusters of C = 2^CL blocks,
// cluster b owning ciphertext b.  exps points at the step's exponents
// (ciphertext b's at exps[b * e_stride]: e for a delta step, c_1..c_{V-1}
// for VAR), key at the step's [V][P][J][R][N] (V = 1 for delta), tab is
// _delta_tables' (the variant phase psi^m/N for VAR).  head and tail are
// the region's pass lists (rotation.py _cluster_layout), tail regions of
// 2^log_t slots, the primes in groups of ps.
template <int CL, bool VAR>
__global__ void __launch_bounds__(cluster_threads(CL), CL <= 3 ? 2 : 1)
cluster_step(int64_t* __restrict__ acc_g, const int32_t* __restrict__ exps, long long e_stride,
             const uint32_t* __restrict__ key, const uint2* __restrict__ tab,
             const __grid_constant__ DeltaConsts g, int log_n, int P, int R, int L, int base_log,
             int V, int ps, unsigned head, unsigned tail, int log_t) {
  cluster_arrive_relaxed();   // this block has started (waited for below)
  wait_for_previous_launch();
  extern __shared__ __align__(16) unsigned char smem[];
  auto cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank(), b = blockIdx.x >> CL;
  const int J = L * R, log_w = log_n - CL, base = q << log_w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nhead = pass_count(head), log_nreg = log_w - log_t, groups = 1 << (log_t - 2);
  uint32_t* spec = reinterpret_cast<uint32_t*>(smem);         // [ps][J][W]
  uint32_t* res = spec + ((size_t)ps * J << log_w);           // [P][R][W]
  const uint2* fwd = tab;                                     // [P][N]
  const uint2* inv = tab + ((size_t)P << log_n);              // [P][N]
  const uint2* phase = tab + ((size_t)2 * P << log_n);        // [P][2N]
  int64_t* acc = acc_g + ((size_t)b * R << log_n);
  const int32_t* e_b = exps + b * e_stride;
  const size_t key_prime = (size_t)J * R << log_n;            // one prime's key words
  // threads a column item at C = 16, where the block has more threads than
  // items: for the exchange, a share of the primes each; for the gather,
  // also where the spectra buffer holds every prime's residues (P R <= ps J)
  const int items = R << (log_w - CL), spare = (int)blockDim.x / items;
  int xsplit = 1, gsplit = 1;
  if constexpr (CL >= 4) {
    while (2 * xsplit <= spare && 2 * xsplit <= ps) xsplit *= 2;
    while (2 * gsplit <= spare && P % (2 * gsplit) == 0 && P * R <= ps * J) gsplit *= 2;
  }
  for (int p0 = 0; p0 < P; p0 += ps) {
    if (p0 == 0)
      cluster_wait();   // every block has started: its shared memory may be written
    else
      cluster.sync();   // no block reads its spectra of the last group any more
    cluster_exchange<CL>(cluster, acc, smem, q, p0, ps, xsplit, J, R, L, log_n, base_log, fwd,
                         g);
    cluster.sync();               // every block's spectra of this group written
    for (int i = 0, lo = log_w; i < nhead; ++i) {
      const int r = pass_radix(head, i);
      lo -= r;
      if (i > 0) __syncthreads();
      region_pass_r<true>(r, spec, ps, J, log_n, log_w, base, lo, fwd, p0, g);
    }
    if (nhead > 0) __syncthreads();
    // one warp per (prime, tail region): forward tails, MAC, inverse tails
    for (int task = warp; task < (ps << log_nreg); task += warps) {
      const int pl = task >> log_nreg, gi = task & ((1 << log_nreg) - 1), pi = p0 + pl;
      const uint32_t p = g.p[pi];
      const u64 mu = g.mu[pi];
      const uint2* fwd_p = fwd + ((size_t)pi << log_n);
      const uint2* inv_p = inv + ((size_t)pi << log_n);
      const uint2* phase_p = phase + ((size_t)2 * pi << log_n);
      const uint32_t* key_p = key + pi * key_prime;
      uint32_t* sp = spec + ((size_t)pl * J << log_w);
      uint32_t* rp = res + ((size_t)pi * R << log_w);
      const int tb = base + (gi << log_t), x0 = tb >> 2;
      tail_polys<true>(sp + (gi << log_t), 1 << log_w, J, tb, log_n, log_t, tail, fwd_p, p);
      if constexpr (VAR) {
        for (int f = lane; f < groups; f += 32)
          finish_group(sp, 1 << log_w, J, x0 + f, swz(4 * (x0 + f)) - base, log_n, fwd_p, p);
        __syncwarp();
      }
      if (R == 2) {
        region_mac<2, VAR>(sp, rp, key_p, (size_t)P * key_prime, x0, groups, 0, J, R, V, log_n,
                           log_w, base, fwd_p, inv_p, phase_p, e_b, p, mu);
      } else {
        for (int r0 = 0; r0 < R; ++r0)
          region_mac<1, VAR>(sp, rp, key_p, (size_t)P * key_prime, x0, groups, r0, J, R, V,
                             log_n, log_w, base, fwd_p, inv_p, phase_p, e_b, p, mu);
      }
      __syncwarp();
      tail_polys<false>(rp + (gi << log_t), 1 << log_w, R, tb, log_n, log_t, tail, inv_p, p);
    }
    for (int i = nhead - 1, lo = log_t; i >= 0; --i) {
      __syncthreads();
      const int r = pass_radix(head, i);
      region_pass_r<false>(r, res + ((size_t)p0 * R << log_w), ps, R, log_n, log_w, base, lo,
                           inv, p0, g);
      lo += r;
    }
  }
  cluster.sync();   // every block's products written
  const size_t res_at = (size_t)4 * ps * J << log_w;
  bool lifted = false;
  if constexpr (CL >= 4) {
    if (gsplit > 1) {
      if (P == 2)
        cluster_gather_split<CL, 2, VAR>(cluster, acc, smem, res_at, spec, gsplit, q, R, log_n,
                                         inv, g);
      else
        cluster_gather_split<CL, 4, VAR>(cluster, acc, smem, res_at, spec, gsplit, q, R, log_n,
                                         inv, g);
      lifted = true;
    }
  }
  if (!lifted) {
    switch (P) {
      case 1: cluster_gather<CL, 1, VAR>(cluster, acc, smem, res_at, q, R, log_n, inv, g); break;
      case 2: cluster_gather<CL, 2, VAR>(cluster, acc, smem, res_at, q, R, log_n, inv, g); break;
      case 3: cluster_gather<CL, 3, VAR>(cluster, acc, smem, res_at, q, R, log_n, inv, g); break;
      default: cluster_gather<CL, 4, VAR>(cluster, acc, smem, res_at, q, R, log_n, inv, g); break;
    }
  }
  cluster.sync();   // no block reads this one's products any more
}

// The cluster step's shared memory: a group of ps primes' J digit spectra
// and every prime's R products of a block's region of 2^log_w slots.
size_t cluster_smem(int log_w, int P, int R, int J, int ps) {
  return (size_t)4 * (ps * J + P * R) << log_w;
}

size_t working_set(int n, int R, int J, int P) {
  return (size_t)8 * R * n + (size_t)4 * J * n + (size_t)4 * P * R * n;
}

bool valid_shape(int n, int log_n, int P, int R, int L, int base_log) {
  const int J = L * R;
  return P >= 1 && P <= MAXP && R >= 1 && J >= 1 && (1 << log_n) == n &&
         log_n >= 2 && base_log >= 1 && base_log <= 24 && base_log * L <= 64;
}

typedef void (*DeltaKernel)(int64_t*, const int32_t*, long long, const uint32_t*,
                            const uint32_t*, const DeltaConsts, int, int, int, int, int,
                            int, unsigned, unsigned, int);

template <bool WIDE>
DeltaKernel delta_general(int rt) {
  switch (rt) {
    case 1: return delta_kernel<1, 0, 0, WIDE>;
    case 2: return delta_kernel<2, 0, 0, WIDE>;
    case 3: return delta_kernel<3, 0, 0, WIDE>;
    case 4: return delta_kernel<4, 0, 0, WIDE>;
    default: return nullptr;
  }
}

// The kernel for rt outputs per MAC item: at N = 2048, P = 4, rt = 2 and
// J <= 16 under the layout of one head pass and the 256-coefficient tail
// (`fast`), the one compiled for that N and P; the general one for every
// other shape, `wide` where J > 16.
DeltaKernel delta_for(int rt, bool fast, int log_n, int P, bool wide) {
  if (fast && !wide && rt == 2 && log_n == 11 && P == 4) return delta_kernel<2, 11, 4, false>;
  return wide ? delta_general<true>(rt) : delta_general<false>(rt);
}

// K1 (pdl false) and K4 (pdl true: programmatic stream serialization, so
// that a step's launch is scheduled while the previous one drains).
int launch_delta(void* acc, const void* exps, long long e_stride, const void* bsk,
                 const void* tab, const void* host_consts, int batch,
                 int n_steps, int n, int log_n, int P, int R, int L, int base_log, int rt,
                 int head, int tail, int log_w, int smem, bool pdl, void* stream) {
  const bool fast = (head & 15) == 1 && (head >> 4) == (unsigned)(log_n - 8) && log_w == 8 &&
                    (unsigned)tail == TAIL256;
  const DeltaKernel kernel = delta_for(rt, fast, log_n, P, L * R > MAX_PRODUCTS);
  if (kernel == nullptr || !valid_shape(n, log_n, P, R, L, base_log) ||
      !valid_layout(log_n, R, rt, (unsigned)head, (unsigned)tail, log_w) ||
      host_consts == nullptr || batch < 1 ||
      n_steps < 1 || (batch > 1 && e_stride < n_steps) ||
      (size_t)smem != working_set(n, R, L * R, P))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(DELTA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (int64_t*)acc, (const int32_t*)exps, e_stride,
                           (const uint32_t*)bsk, (const uint32_t*)tab,
                           delta_consts((const u64*)host_consts), n_steps, log_n, P, R, L,
                           base_log, (unsigned)head, (unsigned)tail, log_w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

typedef void (*VariantKernel)(int64_t*, const int32_t*, long long, const uint32_t*,
                              const uint32_t*, const u64*, int, int, int, int, int, int,
                              int);

template <int C>
VariantKernel variant_for_r(int R) {
  switch (R) {
    case 1: return variant_kernel<C, 1>;
    case 2: return variant_kernel<C, 2>;
    case 3: return variant_kernel<C, 3>;
    case 4: return variant_kernel<C, 4>;
    default: return nullptr;
  }
}

VariantKernel variant_for(int cluster, int R) {
  switch (cluster) {
    case 1: return variant_for_r<1>(R);
    case 2: return variant_for_r<2>(R);
    case 4: return variant_for_r<4>(R);
    case 8: return variant_for_r<8>(R);
    default: return nullptr;
  }
}

// The launch configuration of the variant body: `grid` blocks of THREADS
// in clusters of `cluster` (no cluster attribute for 1), `smem` bytes each.
cudaLaunchConfig_t variant_config(int grid, int cluster, size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// The plan (grid, cluster, smem) comes from rotation.py
// `_variant_launch_plan`; it is checked against the shape here.
int launch_variants(void* acc, const void* exps, long long e_stride, const void* bsk,
                    const void* tab, const void* consts, int batch, int n_steps, int n,
                    int log_n, int P, int R, int L, int base_log, int grouping, int grid,
                    int cluster, int smem, void* stream) {
  const int V = 1 << grouping;
  const VariantKernel kernel = variant_for(cluster, R);
  if (kernel == nullptr || grouping < 1 || grouping > 4 ||
      !valid_shape(n, log_n, P, R, L, base_log) || batch < 1 || n_steps < 1 ||
      (batch > 1 && e_stride < (long long)n_steps * (V - 1)) || n % cluster != 0 ||
      grid % cluster != 0 || grid < batch || grid >= batch + cluster ||
      (size_t)smem != working_set(n, R, L * R, P))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = variant_config(grid, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, (int64_t*)acc, (const int32_t*)exps, e_stride,
                           (const uint32_t*)bsk, (const uint32_t*)tab, (const u64*)consts,
                           batch, n_steps, log_n, P, L, base_log, V);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// K6's layout (rotation.py _staged_layout) covers the log_n stages: head
// passes of radix logs 1..3 (one at least), tail passes of 1..3 within
// regions of 2^log_w (5 <= log_w <= 8: the swizzle keeps a region's words
// together) and the MAC's two; R outputs in chunks of rt; `warps` regions a
// region block, each with (J + R) 2^log_w words of shared memory.
bool valid_staged_layout(int log_n, int R, int J, int rt, unsigned head, unsigned tail,
                         int log_w, int warps, int smem) {
  const int h = pass_sum(head, 1), t = pass_sum(tail, 1);
  return rt >= 1 && rt <= 4 && R % rt == 0 && (head & 15u) >= 1 && h >= 1 && t >= 1 &&
         log_w >= 5 && log_w <= 8 && log_w == log_n - h && h + t + 2 == log_n && warps >= 1 &&
         warps <= 8 && (size_t)smem == ((size_t)warps * 4 * (J + R) << log_w);
}

typedef void (*StagedFirst)(const int64_t*, uint32_t*, const uint2*, const DeltaConsts, int, int,
                            int, int, int, int);
typedef void (*StagedHead)(uint32_t*, const uint2*, const DeltaConsts, int, int, int, int, int);
typedef void (*StagedRegion)(const uint32_t*, uint32_t*, const uint32_t*, const int32_t*,
                             long long, const uint2*, const DeltaConsts, int, int, int, int, int,
                             unsigned, int);
typedef void (*StagedLast)(int64_t*, const uint32_t*, const uint2*, const DeltaConsts, int, int,
                           int, int);

StagedFirst staged_first_for(int rl) {
  switch (rl) {
    case 1: return staged_first_pass<1>;
    case 2: return staged_first_pass<2>;
    case 3: return staged_first_pass<3>;
    default: return nullptr;
  }
}

StagedHead staged_head_for(int rl, bool fwd) {
  switch (rl) {
    case 1: return fwd ? staged_head_pass<1, true> : staged_head_pass<1, false>;
    case 2: return fwd ? staged_head_pass<2, true> : staged_head_pass<2, false>;
    case 3: return fwd ? staged_head_pass<3, true> : staged_head_pass<3, false>;
    default: return nullptr;
  }
}

StagedRegion staged_region_for(int rt) {
  switch (rt) {
    case 1: return staged_region<1>;
    case 2: return staged_region<2>;
    case 3: return staged_region<3>;
    case 4: return staged_region<4>;
    default: return nullptr;
  }
}

StagedLast staged_last_for(int rl) {
  switch (rl) {
    case 1: return staged_last_pass<1>;
    case 2: return staged_last_pass<2>;
    case 3: return staged_last_pass<3>;
    default: return nullptr;
  }
}

// One K6 launch over `threads` threads in blocks of `block`, with
// programmatic stream serialization.
template <class... Params, class... Args>
cudaError_t launch_staged_kernel(void (*kernel)(Params...), long long threads, int block,
                                 int smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + block - 1) / block));
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K6's passes form: n_steps delta steps over acc [B][R][N], 2 * (head
// passes) + 1 launches a step; bsk [steps][P][J][R][N], exponent e of
// ciphertext b and step s at exps[b * e_stride + s * e_step].  spec
// [B][P][J][N] and res [B][P][R][N] are the scratch.
int launch_staged(void* acc, const void* exps, long long e_stride, int e_step, const void* bsk,
                  const void* tab, const void* host_consts, void* spec, void* res, int batch,
                  int n_steps, int n, int log_n, int P, int R, int L, int base_log, int rt,
                  int head, int tail, int log_w, int warps, int smem, void* stream) {
  const int J = L * R;
  const int nhead = head & 15, top = pass_radix((unsigned)head, 0);
  const StagedFirst first = staged_first_for(top);
  const StagedLast last = staged_last_for(top);
  const StagedRegion region = staged_region_for(rt);
  if (first == nullptr || last == nullptr || region == nullptr ||
      !valid_shape(n, log_n, P, R, L, base_log) ||
      !valid_staged_layout(log_n, R, J, rt, (unsigned)head, (unsigned)tail, log_w, warps,
                           smem) ||
      host_consts == nullptr || spec == nullptr || res == nullptr || batch < 1 ||
      n_steps < 1 || e_step < 0 ||
      (batch > 1 && e_stride < (long long)(n_steps - 1) * e_step + 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)region, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const DeltaConsts g = delta_consts((const u64*)host_consts);
  const uint2* fwd = reinterpret_cast<const uint2*>(tab);
  const uint2* inv = fwd + ((size_t)P << log_n);
  const size_t step_words = ((size_t)P * J * R) << log_n;
  const long long items = (long long)batch * R << (log_n - top);
  const long long tasks = (long long)batch * P << (log_n - log_w);
  for (int step = 0; step < n_steps; ++step) {
    const uint32_t* key = reinterpret_cast<const uint32_t*>(bsk) + step * step_words;
    const int32_t* e = reinterpret_cast<const int32_t*>(exps) + (long long)step * e_step;
    err = launch_staged_kernel(first, items, STAGED_THREADS, 0, stream, (const int64_t*)acc,
                               (uint32_t*)spec, fwd, g, batch, log_n, P, R, L, base_log);
    int lo = log_n - top;
    for (int i = 1; i < nhead && err == cudaSuccess; ++i) {
      const int r = pass_radix((unsigned)head, i);
      lo -= r;
      err = launch_staged_kernel(staged_head_for(r, true), (long long)batch * P * J << (log_n - r),
                                 STAGED_THREADS, 0, stream, (uint32_t*)spec, fwd, g, batch,
                                 log_n, P, J, lo);
    }
    if (err == cudaSuccess)
      err = launch_staged_kernel(region, tasks * 32, warps * 32, smem, stream,
                                 (const uint32_t*)spec, (uint32_t*)res, key, e, e_stride,
                                 fwd, g, batch, log_n, P, R, J, (unsigned)tail, log_w);
    for (int i = nhead - 1; i >= 1 && err == cudaSuccess; --i) {
      const int r = pass_radix((unsigned)head, i);
      err = launch_staged_kernel(staged_head_for(r, false), (long long)batch * P * R << (log_n - r),
                                 STAGED_THREADS, 0, stream, (uint32_t*)res, inv, g, batch,
                                 log_n, P, R, lo);
      lo += r;
    }
    if (err == cudaSuccess)
      err = launch_staged_kernel(last, items, STAGED_THREADS, 0, stream, (int64_t*)acc,
                                 (const uint32_t*)res, inv, g, batch, log_n, P, R);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

typedef void (*ClusterKernel)(int64_t*, const int32_t*, long long, const uint32_t*,
                              const uint2*, const DeltaConsts, int, int, int, int, int, int,
                              int, unsigned, unsigned, int);

template <bool VAR>
ClusterKernel cluster_for_c(int cluster) {
  switch (cluster) {
    case 2: return cluster_step<1, VAR>;
    case 4: return cluster_step<2, VAR>;
    case 8: return cluster_step<3, VAR>;
    case 16: return cluster_step<4, VAR>;
    default: return nullptr;
  }
}

ClusterKernel cluster_for(int cluster, bool var) {
  return var ? cluster_for_c<true>(cluster) : cluster_for_c<false>(cluster);
}

int log2_of(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The cluster step's layout (rotation.py _cluster_layout): a block's region
// of 2^log_w = N/C slots is 32 or more; its head passes (radix logs 1..3,
// none or more) take it to tail regions of 2^log_t (5..8) slots, the tail
// passes and the MAC's two stages cover those; the primes in groups of ps
// (ps divides P <= 4); the shared memory holds a group's J digit spectra
// and every prime's R products of the block's region.
bool valid_cluster_layout(int log_n, int cluster, int P, int R, int J, int ps, unsigned head,
                          unsigned tail, int log_t, int smem) {
  const int log_w = log_n - log2_of(cluster);
  const int h = pass_sum(head, 1), t = pass_sum(tail, 1);
  return P >= 1 && P <= CLUSTER_MAXP && R <= 4 && ps >= 1 && P % ps == 0 && log_t >= 5 &&
         log_t <= 8 &&
         log_w >= log_t && h == log_w - log_t && t >= 1 && t + 2 == log_t &&
         (size_t)smem == cluster_smem(log_w, P, R, J, ps) && smem <= 232448;
}

// The cluster step's launch: `grid` blocks in clusters of `cluster`, with
// programmatic stream serialization where `pdl`.
cudaLaunchConfig_t cluster_config(int grid, int cluster, int smem, void* stream, bool pdl,
                                  cudaLaunchAttribute (&attrs)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(cluster_threads(log2_of(cluster)));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = pdl ? 2 : 1;
  return cfg;
}

// Lets the kernel take `smem` bytes and, for 16 blocks, a cluster beyond
// the portable 8.
cudaError_t prepare_cluster(ClusterKernel kernel, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// K6's cluster step: n_steps steps over acc [B][R][N], one launch a step
// of B clusters of C blocks.  grouping 0: delta steps, bsk
// [steps][P][J][R][N], exponent e of ciphertext b and step s at exps[b *
// e_stride + s * e_step]; grouping g = 1..4: variant steps, bsk
// [steps][2^g][P][J][R][N], c_1..c_{2^g-1} from there on.
int launch_cluster(void* acc, const void* exps, long long e_stride, int e_step, const void* bsk,
                   const void* tab, const void* host_consts, int batch, int n_steps, int n,
                   int log_n, int P, int R, int L, int base_log, int grouping, int cluster,
                   int ps, int head, int tail, int log_t, int smem, void* stream) {
  const int J = L * R, V = grouping > 0 ? 1 << grouping : 0, per_e = V > 0 ? V - 1 : 1;
  const ClusterKernel kernel = cluster_for(cluster, grouping > 0);
  if (kernel == nullptr || grouping < 0 || grouping > 4 ||
      !valid_shape(n, log_n, P, R, L, base_log) ||
      !valid_cluster_layout(log_n, cluster, P, R, J, ps, (unsigned)head, (unsigned)tail, log_t,
                            smem) ||
      host_consts == nullptr || batch < 1 || (long long)batch * cluster > 0x7fffffffLL ||
      n_steps < 1 || e_step < 0 ||
      (batch > 1 && e_stride < (long long)(n_steps - 1) * e_step + per_e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  const DeltaConsts g = delta_consts((const u64*)host_consts);
  const size_t step_words = ((size_t)(V > 0 ? V : 1) * P * J * R) << log_n;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = cluster_config(batch * cluster, cluster, smem, stream, true,
                                                attrs);
  for (int step = 0; step < n_steps; ++step) {
    err = cudaLaunchKernelEx(&cfg, kernel, (int64_t*)acc,
                             reinterpret_cast<const int32_t*>(exps) + (long long)step * e_step,
                             e_stride, reinterpret_cast<const uint32_t*>(bsk) + step * step_words,
                             reinterpret_cast<const uint2*>(tab), g, log_n, P, R, L, base_log,
                             V, ps, (unsigned)head, (unsigned)tail, log_t);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* tfhe_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1: the whole delta rotation; exps [B][n_steps].  tab is rotation.py
// _delta_tables' (on the device), host_consts the constants buffer in host
// memory; rt, head, tail, log_w and smem are rotation.py _delta_layout's.
extern "C" int tfhe_blind_rotate(void* acc, const void* exps, const void* bsk,
                                 const void* tab, const void* host_consts, int batch,
                                 int n_steps, int n, int log_n, int P, int R, int L,
                                 int base_log, int rt, int head, int tail, int log_w,
                                 int smem, void* stream) {
  return launch_delta(acc, exps, n_steps, bsk, tab, host_consts, batch, n_steps, n,
                      log_n, P, R, L, base_log, rt, head, tail, log_w, smem, false, stream);
}

// K3: the whole multi-bit rotation; exps [B][n_steps][V-1].
extern "C" int tfhe_blind_rotate_multi_bit(void* acc, const void* exps, const void* bsk,
                                           const void* tab, const void* consts,
                                           int batch, int n_steps, int n, int log_n,
                                           int P, int R, int L, int base_log,
                                           int grouping, int grid, int cluster, int smem,
                                           void* stream) {
  return launch_variants(acc, exps, (long long)n_steps * ((1 << grouping) - 1), bsk, tab,
                         consts, batch, n_steps, n, log_n, P, R, L, base_log, grouping,
                         grid, cluster, smem, stream);
}

// K4: one delta step.  exps points at the step's exponent of ciphertext 0;
// ciphertext b's is exps[b * e_stride].  bsk is the step's [P][J][R][N].
extern "C" int tfhe_blind_rotate_step(void* acc, const void* exps, long long e_stride,
                                      const void* bsk, const void* tab,
                                      const void* host_consts, int batch, int n, int log_n,
                                      int P, int R, int L, int base_log, int rt, int head,
                                      int tail, int log_w, int smem, void* stream) {
  return launch_delta(acc, exps, e_stride, bsk, tab, host_consts, batch, 1, n,
                      log_n, P, R, L, base_log, rt, head, tail, log_w, smem, true, stream);
}

// K5: one variant step.  exps points at c_1 of ciphertext 0, ciphertext b's
// c_1..c_{V-1} are exps[b * e_stride + v - 1].  bsk is the step's
// [V][P][J][R][N].
extern "C" int tfhe_blind_rotate_step_variants(void* acc, const void* exps,
                                               long long e_stride, const void* bsk,
                                               const void* tab, const void* consts,
                                               int batch, int n, int log_n, int P, int R,
                                               int L, int base_log, int grouping, int grid,
                                               int cluster, int smem, void* stream) {
  return launch_variants(acc, exps, e_stride, bsk, tab, consts, batch, 1, n, log_n, P, R,
                         L, base_log, grouping, grid, cluster, smem, stream);
}

// How many clusters of `cluster` variant blocks (R outputs, `smem` bytes
// each) the device can hold at once (blocks for cluster = 1); 0 means they
// cannot be scheduled.
extern "C" int tfhe_variant_active_clusters(int cluster, int R, int smem, int* out) {
  const VariantKernel kernel = variant_for(cluster, R);
  if (kernel == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    *out = per_sm * sms;
    return (int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = variant_config(cluster, cluster, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// How many delta blocks (rt outputs per MAC item, `smem` bytes each) the
// device holds at once.
extern "C" int tfhe_delta_active_blocks(int rt, int smem, int* out) {
  const DeltaKernel kernel = delta_for(rt, false, 0, 0, false);
  if (kernel == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DELTA_THREADS, smem);
  *out = per_sm * sms;
  return (int)err;
}

// K6's passes form: n_steps delta steps (the whole rotation, or one step
// on the per-step route); see launch_staged.  tab is rotation.py
// _delta_tables', host_consts the constants buffer in host memory; rt,
// head, tail, log_w, warps and smem are rotation.py _staged_layout's.
extern "C" int tfhe_staged_rotate(void* acc, const void* exps, long long e_stride, int e_step,
                                  const void* bsk, const void* tab, const void* host_consts,
                                  void* spec, void* res, int batch, int n_steps, int n,
                                  int log_n, int P, int R, int L, int base_log, int rt, int head,
                                  int tail, int log_w, int warps, int smem, void* stream) {
  return launch_staged(acc, exps, e_stride, e_step, bsk, tab, host_consts, spec, res, batch,
                       n_steps, n, log_n, P, R, L, base_log, rt, head, tail, log_w, warps,
                       smem, stream);
}

// K6's cluster step: n_steps steps, one launch each (the whole rotation, or
// one step on the per-step route); see launch_cluster.  tab is rotation.py
// _delta_tables' (the delta or the variant phase), host_consts the
// constants buffer in host memory; cluster, ps, head, tail, log_t and smem
// are rotation.py _cluster_layout's.
extern "C" int tfhe_cluster_step(void* acc, const void* exps, long long e_stride, int e_step,
                                 const void* bsk, const void* tab, const void* host_consts,
                                 int batch, int n_steps, int n, int log_n, int P, int R, int L,
                                 int base_log, int grouping, int cluster, int ps, int head,
                                 int tail, int log_t, int smem, void* stream) {
  return launch_cluster(acc, exps, e_stride, e_step, bsk, tab, host_consts, batch, n_steps, n,
                        log_n, P, R, L, base_log, grouping, cluster, ps, head, tail, log_t,
                        smem, stream);
}

// How many clusters of the cluster step (C blocks, delta or variants,
// `smem` bytes a block) the device holds at once; 0 means they cannot be
// scheduled.
extern "C" int tfhe_cluster_step_active(int cluster, int variants, int smem, int* out) {
  const ClusterKernel kernel = cluster_for(cluster, variants != 0);
  if (kernel == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, smem, nullptr, false, attrs);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}
