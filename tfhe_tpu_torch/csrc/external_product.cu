// K7: the external product outside a blind rotation, with a GGSW per
// ciphertext.  For each row b of a batch of GLWE ciphertexts [R][N] u64:
//
//   out[b] = ct0[b] + GGSW[b] [x] op[b],   op[b] = ct1[b] - ct0[b]        (explicit)
//                                       or op[b] = X^e_b * ct0[b] - ct0[b] (rotated)
//
// where GGSW [x] op = sum_{l,r} decomp_l(op_r) * GGSW[l, r] mod (X^N + 1, 2^64)
// (decomp the balanced base-2^b digits, level-major: digit row j = l*R + r).
// The GGSW is given as the port's spectra [P][J][R][N] u32 (J = L*R), one
// per row `key_stride` words apart (0: one GGSW for the whole batch);
// ct0's and ct1's rows `*_stride` words apart (0: one shared row).
//
// Replaces the XLA external product of `external_product_accumulate`
// (tfhe_tpu/core/algorithms/bootstrap.py:50-77), which the JAX package's
// `cmux_ntt` (tfhe_tpu/core/algorithms/wopbs.py:190: the WoP-PBS's CMux
// tree and its GGSW-driven rotation in `vertical_packing`), `cmux` (:80)
// and `blind_rotate` (:89, `blind_rotate_only`) run; the TPU kernel's step
// body `_make_step_kernel_mxu` (tfhe_tpu/core/poly/pallas_ntt.py:601)
// computes the same product inside a rotation.  Unlike K4 (the delta step,
// csrc/rotation.cu), the operand is decomposed as a torus difference (the
// JAX functions' form, bit for bit) and each row may bring its own GGSW.
//
// K8: K7's form on the 2^128 torus, the step of a 128-bit blind rotation.
//
//   acc[b] += GGSW [x] (X^e_b * acc[b] - acc[b])     (mod X^N + 1, 2^128)
//
// acc [B][R][N][2] u64 (limb 0 the high word, limb 1 the low), one GGSW
// [P][J][R][N] u32 of spectra for the batch (`key_stride` 0) or one a row.
// Replaces the XLA `external_product_accumulate128`
// (tfhe_tpu/core/algorithms/pbs128.py:244-261), which `blind_rotate128`
// (:264-289) runs once a step.  The operand is a 128-bit difference (a
// borrow between the limbs), its digits come from the high limb (with lo's
// top bit as the rounding bit where base_log * L = 64,
// tfhe_tpu/core/decomposition.py:47), and the lift is mod 2^128 (each
// Garner term a 64 x 128-bit product; M, the product of 6 or 7 primes,
// exceeds 2^128, so only the prefixes and M mod 2^128 are needed).
//
// One kernel template, external_product_kernel<T128, RT, JW>, computes both.
// The arithmetic is exact (NTTs over P primes below 2^30, Garner), so the
// result is bit-identical to the plain versions (core/poly/external_product.py)
// and to the JAX functions.
//
// What bounded the first design (one block a row, radix-2 stages
// with a block barrier each, two scalar twiddle loads a butterfly, a 64-bit
// Barrett reduction per MAC term, each prime's residues out to a scratch
// res[B][P][R][N] in device memory and back for the lift; 0.6534 ms a K8
// launch on the H100 against a 0.0591 ms bound, 9%): the block barriers and
// shared-memory round trips of ~25 stages a prime, and one block's chain of
// P primes.
//
// This design is K1's delta body (csrc/ntt_passes.cuh, shared with
// rotation.cu) run once, with the pass schedule of rotation.py
// _delta_layout:
//  - radix-8 passes in registers: one head pass over the polynomial (block
//    barrier), tail passes in 256-coefficient regions one warp owns (warp
//    barriers); where every warp has a region (N >= 2048) one warp runs a
//    region's forward tails, its MAC and its inverse tails;
//  - the digits fused into the first forward pass: a thread reads its
//    operand words (the torus difference, the rotate-subtract form or the
//    128-bit high limb) straight from device memory and splits each into
//    its L digits;
//  - the MAC fused between the last two forward and the first two inverse
//    stages: the digit residues reduced to [0, p) first (16 products of
//    p^2 < 2^60 fit a 64-bit sum; past 16 digit rows the sum is reduced
//    every 16), key words as 16-byte loads, one Barrett reduction and the
//    1/N factor per output;
//  - twiddles beside their Shoup twins in heap order, Harvey lazy
//    reduction, the bank swizzle, the primes' constants a kernel parameter;
//  - the Garner lift (mod 2^64, or 2^128) fused into the last inverse pass
//    and added to ct0 (acc) on its way to `out`: no residue leaves shared
//    memory, and the wrapper allocates no scratch;
//  - primes across a thread block cluster (core/poly/external_product.py
//    _ep_layout picks the form by shape): a cluster of C blocks (C divides
//    P, C <= 8) owns a row, block c runs primes c, c + C, ...; after a cluster
//    barrier each block lifts a share of the coefficients, reading its peers'
//    residues through distributed shared memory (map_shared_rank), and a last
//    cluster barrier keeps its own alive for them.  C = 1 is one block a row
//    with the primes in series, the lift in the last prime's top pass;
//  - programmatic stream serialization, so that a launch's blocks are
//    scheduled while the previous launch (the previous rotation step) drains.
//  - the operand staged: where a block runs several primes and shared
//    memory leaves room (_ep_layout's `stage`), the first prime's pass keeps
//    each source word in shared memory for the others, so the operand (the
//    rotated gather of two 16-byte limbs for K8) is read from device memory
//    once a block, not once a prime;
// Shared memory 4 (J + R P / C) N bytes, plus 8 R N staged; 256 threads a
// block.  What bounds it now (the H100, PERF.md): K8 at 2_2's shapes takes
// 0.194 ms a launch, 30% of its operations bound, one block's (or
// cluster's) chain of dependent work as K1's; at the gadget MVB and the
// CMux tree the host's launches set the pace.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EP_THREADS = 256;
constexpr int EP_MAXCL = 8;        // blocks of a cluster, the portable limit
constexpr int EP_SMEM = 232448;    // dynamic shared memory one block may use on sm_90

struct EpArgs {
  const uint64_t* ct0;       // K7 rows [R][N]; K8 acc rows [R][N][2]
  long long ct0_stride;
  const uint64_t* ct1;       // K7's explicit operand; null: the rotated operand
  long long ct1_stride;
  const long long* exps;     // rotated: e_b = exps[b * e_stride] mod 2N
  long long e_stride;
  const uint32_t* ggsw;      // row b's spectra at ggsw + b * key_stride
  long long key_stride;
  const uint2* dtab;         // rotation.py _delta_tables(variants=True): phase[0] = 1/N
  uint64_t* out;             // K7 [B][R][N]; K8 [B][R][N][2]
  int log_n, P, R, L, base_log, cluster, stage;
  unsigned head, tail;
  int log_w;
};

// Word (r, i) of the operand of row c0 / c1.
__device__ __forceinline__ uint64_t operand(const uint64_t* c0, const uint64_t* c1, int e,
                                            int r, int i, int n) {
  const uint64_t x = c0[(size_t)r * n + i];
  if (c1 != nullptr) return c1[(size_t)r * n + i] - x;
  // X^e * c0 at i: +-c0[(i - e) mod N], negated where the rotation wraps
  const bool flip = e >= n;
  const int rot = flip ? e - n : e;
  const uint64_t y = c0[(size_t)r * n + ((i - rot) & (n - 1))];
  return ((i < rot) != flip ? 0 - y : y) - x;
}

// Word (r, i) of X^e * row - row on the 2^128 torus, as (hi, lo).
__device__ __forceinline__ void operand128(const uint64_t* c0, int e, int r, int i, int n,
                                           uint64_t& hi, uint64_t& lo) {
  const uint64_t* row = c0 + (size_t)r * n * 2;
  const uint64_t xh = row[2 * i], xl = row[2 * i + 1];
  const bool flip = e >= n;
  const int rot = flip ? e - n : e;
  const int src = (i - rot) & (n - 1);
  uint64_t yh = row[2 * src], yl = row[2 * src + 1];
  if ((i < rot) != flip) {   // negated where the rotation wraps
    yh = ~yh + (yl == 0 ? 1ull : 0ull);
    yl = 0 - yl;
  }
  lo = yl - xl;
  hi = yh - xh - (yl < xl ? 1ull : 0ull);
}

// The word whose top base_log * L bits (rounded) decompose_pass splits, at
// coefficient idx = r*N + i: K7's operand; K8's high limb, which holds
// every digit, or at base_log * L = 64 (no rounding shift) the high limb
// plus lo's top bit, the rounding bit.
template <bool T128>
__device__ __forceinline__ uint64_t source_word(const uint64_t* c0, const uint64_t* c1, int e,
                                                int idx, int log_n, int shift) {
  const int n = 1 << log_n, r = idx >> log_n, i = idx & (n - 1);
  if constexpr (T128) {
    uint64_t hi, lo;
    operand128(c0, e, r, i, n, hi, lo);
    return shift > 0 ? hi : hi + (lo >> 63);
  } else {
    return operand(c0, c1, e, r, i, n);
  }
}

// K7 (T128 false) and K8 (T128 true).  A cluster of a.cluster blocks owns
// row blockIdx.x / cluster.  Per prime of the block: the head passes (the
// first decomposes the operand), a block barrier after each; the tails, the
// MAC and the inverse tails (one warp a region, or with block barriers);
// a block barrier; the inverse head passes, the top one storing the
// residues or, on the last prime of a block that owns its row alone,
// lifting them into `out`.  RT outputs per MAC item; JW for J > 16 digit
// rows (the MAC reduces inside its j loop).  LN > 0: a kernel for N = 2^LN,
// P = PT primes in clusters of CL under the layout of one head pass and the
// 256-coefficient tail (`ep_fast`: the main paths' shapes), its shifts, loop
// counts and the lift's unrolling constants.
template <bool T128, int RT, bool JW, int LN = 0, int PT = 0, int CL = 0>
__global__ void __launch_bounds__(EP_THREADS, 2)
external_product_kernel(const __grid_constant__ EpArgs a, const __grid_constant__ DeltaConsts g,
                        const __grid_constant__ Wide128 w) {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TOP = LN > 0 ? LN - 8 : 0;
  const int log_n = LN > 0 ? LN : a.log_n, n = 1 << log_n, R = a.R, L = a.L, J = L * R;
  const int RN = R << log_n, P = PT > 0 ? PT : a.P, cl = CL > 0 ? CL : a.cluster;
  const int rank = cl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / cl;
  const int ps = P / cl;
  uint32_t* spec = reinterpret_cast<uint32_t*>(smem);   // [J][N], swizzled
  uint32_t* res = spec + J * n;                          // [ps][R][N], swizzled
  // with a.stage, the operand's source words [R][N] (the first prime reads
  // them from device memory, the others from here)
  uint64_t* staged = a.stage ? reinterpret_cast<uint64_t*>(res + ps * RN) : nullptr;
  const uint2* fwd = a.dtab;                             // [P][N]
  const uint2* inv = fwd + P * n;                        // [P][N]
  const uint2* phase = inv + P * n;                      // [P][2N]: entry 0 is 1/N

  const uint64_t* c0 = a.ct0 + b * a.ct0_stride;
  const uint64_t* c1 = a.ct1 == nullptr ? nullptr : a.ct1 + b * a.ct1_stride;
  const int e = a.ct1 == nullptr ? (int)(__ldg(a.exps + b * a.e_stride) & (2 * n - 1)) : 0;
  const uint32_t* key = a.ggsw + b * a.key_stride;
  uint64_t* out = a.out + (size_t)b * RN * (T128 ? 2 : 1);
  const int shift = 64 - a.base_log * L;
  // coefficient i's lift from its residues get(q), q < P, added into out
  const auto lift = [&](int i, auto get) {
    if constexpr (T128) {
      uint64_t hi;
      const uint64_t lo = garner_from<PT, true>(get, P, g, &w, &hi);
      const uint64_t xh = c0[2 * i], xl = c0[2 * i + 1], sum = xl + lo;
      out[2 * i] = xh + hi + (sum < xl ? 1ull : 0ull);
      out[2 * i + 1] = sum;
    } else {
      out[i] = c0[i] + garner_from<PT>(get, P, g);
    }
  };

  const int log_w = LN > 0 ? 8 : a.log_w;
  const unsigned tail = LN > 0 ? TAIL256 : a.tail;
  const bool regions = log_w == 8 && tail == TAIL256 && (1 << (log_n - 8)) >= EP_THREADS / 32;
  const int nhead = LN > 0 ? 1 : pass_count(a.head), top = LN > 0 ? TOP : pass_radix(a.head, 0);
  const int groups = n >> 2, items = (R / RT) * groups;
#pragma unroll 1
  for (int s = 0; s < ps; ++s) {
    const int pi = rank + s * cl;
    const uint32_t p = g.p[pi];
    const u64 mu = g.mu[pi];
    const uint2* fwd_p = fwd + pi * n;
    const uint2* inv_p = inv + pi * n;
    const uint2* phase_p = phase + pi * 2 * n;
    uint32_t* res_p = res + s * RN;
    const uint32_t* key_p = key + (size_t)pi * J * RN;
    // 1. digits, in the first forward pass, and the other head passes; a
    // thread reads the same source words for every prime, so the staged
    // words need no barrier
    const bool fetch = s == 0 || staged == nullptr;
    const auto src = [&](int idx) -> uint64_t {
      if (!fetch) return staged[idx];
      const uint64_t x = source_word<T128>(c0, c1, e, idx, log_n, shift);
      if (staged != nullptr) staged[idx] = x;
      return x;
    };
    if constexpr (LN > 0) decompose_pass<TOP>(src, spec, R, L, log_n, a.base_log, fwd_p, p);
    else decompose_pass_r(top, src, spec, R, L, log_n, a.base_log, fwd_p, p);
    for (int i = 1, lo = log_n - top; i < nhead; ++i) {
      const int r = pass_radix(a.head, i);
      lo -= r;
      __syncthreads();
      block_pass_r<true>(r, spec, J, log_n, lo, fwd_p, p);
    }
    __syncthreads();
    // 2.-4. the forward tails, the MAC times 1/N, the inverse tails
    if (regions) {
      region_pipeline<RT, JW, false>(key_p, spec, res_p, J, R, log_n, fwd_p, inv_p, phase_p, 0u,
                                     p, mu);
    } else {
      tail_passes<true>(spec, J, log_n, log_w, tail, fwd_p, p);
      __syncthreads();
      for (int f = threadIdx.x; f < items; f += blockDim.x)
        mac_group<RT, JW, false>(spec, res_p, key_p, f & (groups - 1), (f >> (log_n - 2)) * RT,
                                 J, R, log_n, log_n, swz(4 * (f & (groups - 1))), fwd_p, inv_p,
                                 phase_p, 0u, p, mu);
      __syncthreads();
      tail_passes<false>(res_p, R, log_n, log_w, tail, inv_p, p);
    }
    __syncthreads();
    // 5. the other inverse head passes, then the top one
    for (int i = nhead - 1, lo = log_w; i >= 1; --i) {
      const int r = pass_radix(a.head, i);
      block_pass_r<false>(r, res_p, R, log_n, lo, inv_p, p);
      lo += r;
      __syncthreads();
    }
    const auto emit = [&](int i, int at, uint32_t v) {
      lift(i, [&](int q) { return q == P - 1 ? v : res[q * RN + at]; });
    };
    const bool last = cl == 1 && s == ps - 1;
    if constexpr (LN > 0) inverse_top<TOP>(res_p, R, log_n, inv_p, p, last, emit);
    else inverse_top_r(top, res_p, R, log_n, inv_p, p, last, emit);
  }
  if (cl > 1) {
    // 6. the lift of a share of the coefficients, prime q's residue in the
    // shared memory of block q % cl, slot q / cl
    const auto cluster = cg::this_cluster();
    cluster.sync();
    for (int i = rank * blockDim.x + threadIdx.x; i < RN; i += cl * blockDim.x) {
      const int at = ((i >> log_n) << log_n) + swz(i & (n - 1));
      lift(i, [&](int q) {
        return cluster.map_shared_rank(res, (unsigned)(q % cl))[(q / cl) * RN + at];
      });
    }
    cluster.sync();   // this block's residues stay until every peer has read them
  }
}

typedef void (*EpKernel)(EpArgs, DeltaConsts, Wide128);

// The kernels compiled for a shape of the main paths (one head pass of
// radix LN - 8, rt = 2, J <= 16): K8 at the 128-bit PBS (N = 2048, P = 6,
// clusters of 2); K7 at the WoP-PBS's vertical packing (N = 2048, P = 3,
// one block a row), its CMux tree (clusters of 3) and the gadget MVB
// (N = 512, P = 3, one block a row); null for any other.
template <bool T128>
EpKernel ep_fast(int log_n, int P, int cl) {
  if constexpr (T128) {
    if (log_n == 11 && P == 6 && cl == 2) return external_product_kernel<T128, 2, false, 11, 6, 2>;
  } else {
    if (log_n == 11 && P == 3 && cl == 1) return external_product_kernel<T128, 2, false, 11, 3, 1>;
    if (log_n == 11 && P == 3 && cl == 3) return external_product_kernel<T128, 2, false, 11, 3, 3>;
    if (log_n == 9 && P == 3 && cl == 1) return external_product_kernel<T128, 2, false, 9, 3, 1>;
  }
  return nullptr;
}

template <bool T128, bool JW>
EpKernel ep_kernel(int rt) {
  switch (rt) {
    case 1: return external_product_kernel<T128, 1, JW>;
    case 2: return external_product_kernel<T128, 2, JW>;
    case 3: return external_product_kernel<T128, 3, JW>;
    case 4: return external_product_kernel<T128, 4, JW>;
    default: return nullptr;
  }
}

// Checks the shape and the layout (external_product.py _ep_layout), sets
// the shared memory and launches K7 (T128 false) or K8 in clusters of
// a.cluster blocks, with programmatic stream serialization.
template <bool T128>
int launch(const EpArgs& a, const void* host_consts, int batch, int rt, int smem, int max_p,
           void* stream) {
  const int n = 1 << a.log_n, R = a.R, L = a.L, J = L * R, cl = a.cluster;
  if (batch < 1 || a.log_n < 2 || a.log_n > 16 || a.P < 1 || a.P > max_p || R < 1 || L < 1 ||
      a.base_log < 1 || a.base_log > 30 || a.base_log * L > 64 || cl < 1 || cl > EP_MAXCL ||
      a.P % cl != 0 || host_consts == nullptr || (a.ct1 == nullptr && a.exps == nullptr) ||
      !valid_layout(a.log_n, R, rt, a.head, a.tail, a.log_w) || smem > EP_SMEM ||
      (a.stage != 0 && a.stage != 1) ||
      (long long)smem != 4ll * (J + (long long)R * (a.P / cl)) * n + 8ll * a.stage * R * n)
    return (int)cudaErrorInvalidValue;
  const u64* cs = static_cast<const u64*>(host_consts);
  const DeltaConsts g = delta_consts(cs);
  Wide128 w = {};
  for (int q = 0; q < MAXP; ++q) {
    w.prefix[q][0] = cs[C_SIZE + 2 * q];
    w.prefix[q][1] = cs[C_SIZE + 2 * q + 1];
  }
  w.mmod[0] = cs[C_SIZE + 2 * MAXP];
  w.mmod[1] = cs[C_SIZE + 2 * MAXP + 1];
  const bool one_head = a.log_n >= 9 && a.head == (1u | ((unsigned)(a.log_n - 8) << 4)) &&
                        a.tail == TAIL256 && a.log_w == 8;
  EpKernel kernel = one_head && rt == 2 && J <= MAX_PRODUCTS ? ep_fast<T128>(a.log_n, a.P, cl)
                                                            : nullptr;
  if (kernel == nullptr)
    kernel = J > MAX_PRODUCTS ? ep_kernel<T128, true>(rt) : ep_kernel<T128, false>(rt);
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cl;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cl);
  cfg.blockDim = dim3(EP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = cl > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, g, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  ct0 [.][R][N] u64 rows ct0_stride words apart; ct1 likewise, or null
// for the rotated operand with exps int64 rows e_stride apart (any value,
// taken mod 2N); ggsw u32
// spectra [P][J][R][N] a row, key_stride words apart; dtab the u32 pairs of
// rotation.py _delta_tables(plan, variants=True); host_consts, in host
// memory, external_product.py _ep_consts; out [B][R][N] u64, apart from
// every input.  cluster, stage, rt, head, tail, log_w and smem are
// external_product.py _ep_layout's.
extern "C" int tfhe_external_product(const void* ct0, long long ct0_stride, const void* ct1,
                                     long long ct1_stride, const void* exps, long long e_stride,
                                     const void* ggsw, long long key_stride, const void* dtab,
                                     const void* host_consts, void* out, int batch, int log_n,
                                     int P, int R, int L, int base_log, int cluster, int stage,
                                     int rt, int head, int tail, int log_w, int smem,
                                     void* stream) {
  const EpArgs args = {(const uint64_t*)ct0, ct0_stride, (const uint64_t*)ct1, ct1_stride,
                       (const long long*)exps, e_stride, (const uint32_t*)ggsw, key_stride,
                       (const uint2*)dtab, (uint64_t*)out, log_n, P, R, L, base_log, cluster,
                       stage, (unsigned)head, (unsigned)tail, log_w};
  return launch<false>(args, host_consts, batch, rt, smem, MAXP, stream);
}

// K8.  acc [.][R][N][2] u64 rows acc_stride words apart; exps int64 rows
// e_stride apart, taken mod 2N; ggsw u32 spectra [P][J][R][N] a row,
// key_stride words apart (0: one GGSW for the batch); dtab, host_consts and
// the layout as K7 takes them; out [B][R][N][2] u64, apart from every input.
extern "C" int tfhe_external_product128(const void* acc, long long acc_stride, const void* exps,
                                        long long e_stride, const void* ggsw,
                                        long long key_stride, const void* dtab,
                                        const void* host_consts, void* out, int batch,
                                        int log_n, int P, int R, int L, int base_log,
                                        int cluster, int stage, int rt, int head, int tail,
                                        int log_w, int smem, void* stream) {
  const EpArgs args = {(const uint64_t*)acc, acc_stride, nullptr, 0, (const long long*)exps,
                       e_stride, (const uint32_t*)ggsw, key_stride, (const uint2*)dtab,
                       (uint64_t*)out, log_n, P, R, L, base_log, cluster, stage,
                       (unsigned)head, (unsigned)tail, log_w};
  return exps == nullptr ? (int)cudaErrorInvalidValue
                         : launch<true>(args, host_consts, batch, rt, smem, 7, stream);
}
