// The blind rotation for a batch of LWE ciphertexts, in two kernel bodies:
// the delta body (classic keys) and the variant body (multi-bit keys, and
// paired classic keys as g = 1), each launched two ways:
//
//   whole rotation, the step loop inside the block:
//     K1 tfhe_blind_rotate            delta steps, classic keys
//     K3 tfhe_blind_rotate_multi_bit  variant steps, multi-bit keys
//   one step per launch, the accumulator in global memory between launches:
//     K4 tfhe_blind_rotate_step           one delta step
//     K5 tfhe_blind_rotate_step_variants  one variant step (g = 1..4; g = 1
//                                         is a paired classic key)
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
// All compute mod (X^N + 1, 2^64), exactly, over P NTT primes below 2^30 and
// lift back with Garner (signed lift, then mod 2^64), so every result is
// bit-identical to the JAX kernel it replaces whatever the transform's order.
//
// Common design.  Each block owns one ciphertext and keeps its accumulator
// [R][N] u64, its J digit spectra and its R products (all P primes) in
// shared memory: 8RN + 4JN + 4PRN bytes (114,688 B at N = 2048, R = J = 2,
// P = 4: two blocks per SM).  K1/K3 run the step loop inside the block (it
// takes the place of the TPU's sequential grid axis); K4/K5 load the
// accumulator from global memory, run one step and store it back in place.
// Per step and prime: balanced digits of acc -> forward Cooley-Tukey NTT
// (psi merged, bit-reversed out) of the J digit polys -> MAC against the
// step's key spectra with the phase -> Gentleman-Sande inverse of the R
// products.  Then Garner adds the delta into acc (delta) or replaces acc
// (variants).  Modular products of residues use 32-bit Shoup multiplies
// with the native __umulhi (twiddles, phases, Garner constants).
//
// K1/K4, the delta MAC: one thread per output (r, k); J 60-bit products in
// 64 bits, one Barrett reduction, then (X^e - 1)/N from a 2N-entry table per
// prime.  Their time sits in the NTTs and the ~97 __syncthreads of a step,
// not in the 4 key loads per slot and prime.
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
// Left to later work: what bounds a full round (above), for all four
// kernels; K1/K4's intercept (a faster NTT, fewer barriers); K4/K5's
// per-launch cost (a CUDA graph, or the fused route); the phase gathers
// (2(V-1) per slot and ciphertext, one interleaved 8-byte gather would halve
// them); and N >= 8192, whose working set exceeds one block's shared memory
// (the same cluster machinery, with a ciphertext spread over C blocks).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 512;
constexpr int MAXP = 8;
constexpr int MAX_PRODUCTS = 16;  // 60-bit products one 64-bit sum can hold

// Layout of the u64 constants buffer; mirrored by rotation.py _kernel_tables.
enum {
  C_P = 0, C_MU = 8, C_GINV = 16, C_GINV_SH = 24, C_GW = 32, C_GW_SH = 96,
  C_HALF = 160, C_PREFIX = 168, C_MMOD = 176, C_NINV = 177, C_NINV_SH = 185,
  C_SIZE = 193
};

__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t p) {
  // a < 2^32, w < p < 2^31, ws = floor(w * 2^32 / p): a*w - q*p in [0, 2p)
  const uint32_t q = __umulhi(a, ws);
  const uint32_t r = a * w - q * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

__device__ __forceinline__ uint32_t barrett(uint64_t x, uint64_t p, uint64_t mu) {
  // mu = floor(2^64 / p): x - q*p in [0, 2p) for any x < 2^64
  const uint64_t q = __umul64hi(x, mu);
  const uint64_t r = x - q * p;
  return (uint32_t)(r >= p ? r - p : r);
}

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

// tab (u32): psi_rev [P][N], its Shoup twin, psi_inv_rev [P][N], its twin,
// phase [P][2N] = (psi^m - 1) / N mod p, its twin, pw [P][2N] = psi^m, its
// twin.

// K1/K4.  bsk [steps][P][J][R][N], exps [B][steps] (row stride e_stride);
// acc [B][R][N] is updated in place.
__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_kernel(int64_t* __restrict__ acc_g, const int32_t* __restrict__ exps,
                    long long e_stride, const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tab, const u64* __restrict__ cs,
                    int n_steps, int log_n, int P, int R, int L, int base_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n, J = L * R, RN = R * n;
  uint64_t* acc = reinterpret_cast<uint64_t*>(smem);            // [R][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(acc + RN);       // [J][N]
  uint32_t* res = spec + J * n;                                 // [P][R][N]

  const uint32_t* psi = tab;
  const uint32_t* psi_sh = tab + P * n;
  const uint32_t* ipsi = tab + 2 * P * n;
  const uint32_t* ipsi_sh = tab + 3 * P * n;
  const uint32_t* phase = tab + 4 * P * n;
  const uint32_t* phase_sh = tab + 6 * P * n;

  int64_t* acc_b = acc_g + (size_t)blockIdx.x * RN;
  const int32_t* e_b = exps + (long long)blockIdx.x * e_stride;
  for (int i = threadIdx.x; i < RN; i += blockDim.x) acc[i] = (uint64_t)acc_b[i];
  __syncthreads();

  const uint32_t two_n_mask = 2u * n - 1;
  const size_t step_stride = (size_t)P * J * RN;

  for (int step = 0; step < n_steps; ++step) {
    const uint32_t* key = bsk + step * step_stride;
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = (uint32_t)__ldg(cs + C_P + pi);
      // 1. balanced digits of acc, 2. forward NTT of the J digit polynomials
      decompose(acc, spec, R, log_n, L, base_log, p);
      __syncthreads();
      ntt_forward(spec, J, log_n, psi + pi * n, psi_sh + pi * n, p);
      // 3. MAC with the key slice, times (X^e - 1)/N
      const uint32_t* key_p = key + (size_t)pi * J * RN;
      const u64 mu = __ldg(cs + C_MU + pi);
      const uint32_t e = (uint32_t)__ldg(e_b + step);
      for (int i = threadIdx.x; i < RN; i += blockDim.x) {
        const int r = i >> log_n, k = i & (n - 1);
        uint64_t s = 0;
        for (int j = 0; j < J; ++j)
          s += (uint64_t)spec[j * n + k] * __ldg(key_p + (size_t)(j * R + r) * n + k);
        const uint32_t odd = 2u * (__brev((unsigned)k) >> (32 - log_n)) + 1u;
        const uint32_t m = (e * odd) & two_n_mask;
        res[pi * RN + i] = mul_shoup(barrett(s, p, mu), __ldg(phase + pi * 2 * n + m),
                                     __ldg(phase_sh + pi * 2 * n + m), p);
      }
      __syncthreads();
      // 4. inverse NTT of the R products
      ntt_inverse(res + pi * RN, R, log_n, ipsi + pi * n, ipsi_sh + pi * n, p);
    }
    // 5. CRT back to the torus: accumulate the delta
    for (int i = threadIdx.x; i < RN; i += blockDim.x) acc[i] += garner(res, i, RN, P, cs);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < RN; i += blockDim.x) acc_b[i] = (int64_t)acc[i];
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
          if (count + J > MAX_PRODUCTS) {
#pragma unroll
            for (int c = 0; c < C; ++c)
#pragma unroll
              for (int r = 0; r < R; ++r) s[c][r] = barrett(s[c][r], p, mu);
            count = 0;
          }
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
          for (int j = 0; j < J; ++j) {
            uint32_t w[R];
#pragma unroll
            for (int r = 0; r < R; ++r) w[r] = __ldg(key_v + (size_t)(j * R + r) * n + k);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              uint32_t d = reinterpret_cast<const uint32_t*>(peer<C>(smem, c) + spec_at)[j * n + k];
              if (v > 0) d = mul_shoup(d, ph[c], ph_sh[c], p);
#pragma unroll
              for (int r = 0; r < R; ++r) s[c][r] += (uint64_t)d * w[r];
            }
          }
          count += J;
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

size_t working_set(int n, int R, int J, int P) {
  return (size_t)8 * R * n + (size_t)4 * J * n + (size_t)4 * P * R * n;
}

bool valid_shape(int n, int log_n, int P, int R, int L, int base_log) {
  const int J = L * R;
  return P >= 1 && P <= MAXP && R >= 1 && J >= 1 && J <= 15 && (1 << log_n) == n &&
         log_n >= 2 && base_log >= 1 && base_log <= 24 && base_log * L <= 64;
}

int launch_delta(void* acc, const void* exps, long long e_stride, const void* bsk,
                 const void* tab, const void* consts, int batch, int n_steps, int n,
                 int log_n, int P, int R, int L, int base_log, void* stream) {
  if (!valid_shape(n, log_n, P, R, L, base_log) || batch < 1 || n_steps < 1 ||
      (batch > 1 && e_stride < n_steps))
    return (int)cudaErrorInvalidValue;
  const size_t smem = working_set(n, R, L * R, P);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  blind_rotate_kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      (int64_t*)acc, (const int32_t*)exps, e_stride, (const uint32_t*)bsk,
      (const uint32_t*)tab, (const u64*)consts, n_steps, log_n, P, R, L, base_log);
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

}  // namespace

extern "C" const char* tfhe_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tfhe_blind_rotate(void* acc, const void* exps, const void* bsk,
                                 const void* tab, const void* consts, int batch,
                                 int n_steps, int n, int log_n, int P, int R, int L,
                                 int base_log, void* stream) {
  return launch_delta(acc, exps, n_steps, bsk, tab, consts, batch, n_steps, n, log_n, P,
                      R, L, base_log, stream);
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
                                      const void* bsk, const void* tab, const void* consts,
                                      int batch, int n, int log_n, int P, int R, int L,
                                      int base_log, void* stream) {
  return launch_delta(acc, exps, e_stride, bsk, tab, consts, batch, 1, n, log_n, P, R, L,
                      base_log, stream);
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
