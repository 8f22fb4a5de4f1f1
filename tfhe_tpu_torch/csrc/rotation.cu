// The blind rotation for a batch of LWE ciphertexts, one kernel body with
// the step's form as a template parameter, launched two ways:
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
// Design.  One block per ciphertext.  K1/K3 run the step loop inside the
// block (it takes the place of the TPU's sequential grid axis) and keep the
// accumulator in shared memory for the whole rotation; K4/K5 load it from
// global memory, run one step and store it back in place.  Per step and
// prime: balanced digits of acc -> forward Cooley-Tukey NTT (psi merged,
// bit-reversed out) of the J digit polys -> MAC against the step's key
// spectra with the phase -> Gentleman-Sande inverse of the R products.
// Then Garner adds the delta into acc (delta) or replaces acc (variants).
// Modular products of residues use 32-bit Shoup multiplies with the native
// __umulhi (twiddles, phases, Garner constants).
//   The delta MAC sums J 60-bit products in 64 bits and reduces once
//   (Barrett), then multiplies by (X^e - 1)/N from a 2N-entry table per prime.
//   The variant MAC runs one thread per spectral slot k: for each variant
//   v >= 1 it turns the J digit residues into d_j * psi^(c_v (2 brv(k) + 1))
//   (a 2N-entry psi-power table, one Shoup multiply per (v, j), shared by
//   the R outputs), sums the products with the key in 64 bits, and reduces
//   with Barrett after at most 16 products (each is below p^2 < 2^60, so 16
//   fit in 64 bits: at g = 3, J = 2 that is one reduction per output).  The
//   v = 0 term has no phase, so 1/N is one Shoup multiply per output.
//
// Bounds on the card.  At PARAM_MESSAGE_2_CARRY_2 (N=2048, P=4, J=R=2) a
// delta step is ~2.5e5 modular multiplies per ciphertext, so K1 is bound by
// 32-bit integer multiply throughput; and each block reads the step's key
// slice (P*J*R*N*4 B = 128 KB; 97 MB for all 742 steps, more than the 50 MB
// L2) once per ciphertext.  K3 at GROUP_3 (296 steps of 8 variants) does
// about 0.7x K1's multiplies per ciphertext, with fewer steps and barriers,
// but reads 2^g times the key per step (1 MB; 310 MB in all): its time
// tracks the key loads per slot.  K4/K5 add, per step, the accumulator's
// round trip through global memory (2*B*R*N*8 B: 33.5 MB at batch 512,
// inside the 50 MB L2) and one launch with its gap, 742 of each per classic
// rotation; the multiplies are K1's/K3's.  Shared memory per block, for all
// four, is 8RN + 4JN + 4PRN bytes (112 KB at 2_2: two blocks per SM).
//
// Left to later work: sharing a key slice among several ciphertexts of a
// block (the TPU tile was 8), staging it in shared memory (TMA or cp.async),
// a faster NTT, N >= 8192 (a thread-block cluster or global staging), and
// for K4/K5 the launch gaps (a CUDA graph, or the fused route).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 512;
constexpr int MAXP = 8;
constexpr int MAXR = 4;        // K3 keeps R 64-bit sums per thread in registers
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
// twin.  Delta: bsk [steps][P][J][R][N], exps [B][steps] (row stride
// e_stride).  Variants: bsk [steps][V][P][J][R][N], exps [B][steps][V-1] (c_v
// for v = 1..V-1; row stride e_stride).  acc [B][R][N] is updated in place.
template <bool kMultiBit>
__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_kernel(int64_t* __restrict__ acc_g, const int32_t* __restrict__ exps,
                    long long e_stride, const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tab, const u64* __restrict__ cs,
                    int n_steps, int log_n, int P, int R, int L, int base_log, int V) {
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
  const uint32_t* pw = tab + 8 * P * n;
  const uint32_t* pw_sh = tab + 10 * P * n;

  const int e_per_step = kMultiBit ? V - 1 : 1;
  int64_t* acc_b = acc_g + (size_t)blockIdx.x * RN;
  const int32_t* e_b = exps + (long long)blockIdx.x * e_stride;
  for (int i = threadIdx.x; i < RN; i += blockDim.x) acc[i] = (uint64_t)acc_b[i];
  __syncthreads();

  const int shift = 64 - base_log * L;
  const uint64_t round = shift > 0 ? (1ull << (shift - 1)) : 0ull;
  const uint64_t dmask = (1ull << base_log) - 1, dhalf = 1ull << (base_log - 1);
  const uint32_t two_n_mask = 2u * n - 1;
  const size_t var_stride = (size_t)P * J * RN;   // one GGSW's spectra
  const size_t step_stride = (kMultiBit ? V : 1) * var_stride;

  for (int step = 0; step < n_steps; ++step) {
    const int32_t* e_s = e_b + step * e_per_step;
    const uint32_t* key = bsk + step * step_stride;
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = (uint32_t)__ldg(cs + C_P + pi);
      // 1. balanced digits of acc (signed_decompose), reduced mod p;
      //    digit (l, r) goes to row j = l*R + r
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
      __syncthreads();
      // 2. forward NTT of the J digit polynomials
      ntt_forward(spec, J, log_n, psi + pi * n, psi_sh + pi * n, p);
      // 3. MAC with the key slice, with the phase
      const uint32_t* key_p = key + (size_t)pi * J * RN;
      const u64 mu = __ldg(cs + C_MU + pi);
      if (!kMultiBit) {
        const uint32_t e = (uint32_t)__ldg(e_s);
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
      } else {
        const uint32_t* pw_p = pw + pi * 2 * n;
        const uint32_t* pw_sh_p = pw_sh + pi * 2 * n;
        const uint32_t ninv = (uint32_t)__ldg(cs + C_NINV + pi);
        const uint32_t ninv_sh = (uint32_t)__ldg(cs + C_NINV_SH + pi);
        for (int k = threadIdx.x; k < n; k += blockDim.x) {
          const uint32_t odd = 2u * (__brev((unsigned)k) >> (32 - log_n)) + 1u;
          uint64_t s[MAXR];
          uint32_t tot[MAXR];
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            s[r] = 0;
            tot[r] = 0;
          }
          int count = 0;   // products in s[r] since its last reduction
          for (int v = 0; v < V; ++v) {
            if (count + J > MAX_PRODUCTS) {
#pragma unroll
              for (int r = 0; r < MAXR; ++r)
                if (r < R) {
                  tot[r] = add_mod(tot[r], barrett(s[r], p, mu), p);
                  s[r] = 0;
                }
              count = 0;
            }
            uint32_t ph = 1, ph_sh = 0;
            if (v > 0) {
              const uint32_t m = ((uint32_t)__ldg(e_s + v - 1) * odd) & two_n_mask;
              ph = __ldg(pw_p + m);
              ph_sh = __ldg(pw_sh_p + m);
            }
            const uint32_t* key_v = key_p + v * var_stride;
            for (int j = 0; j < J; ++j) {
              uint32_t d = spec[j * n + k];
              if (v > 0) d = mul_shoup(d, ph, ph_sh, p);
#pragma unroll
              for (int r = 0; r < MAXR; ++r)
                if (r < R)
                  s[r] += (uint64_t)d * __ldg(key_v + (size_t)(j * R + r) * n + k);
            }
            count += J;
          }
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < R)
              res[pi * RN + r * n + k] =
                  mul_shoup(add_mod(tot[r], barrett(s[r], p, mu), p), ninv, ninv_sh, p);
        }
      }
      __syncthreads();
      // 4. inverse NTT of the R products
      ntt_inverse(res + pi * RN, R, log_n, ipsi + pi * n, ipsi_sh + pi * n, p);
    }
    // 5. CRT back to the torus: accumulate the delta (K1) or replace (K3)
    for (int i = threadIdx.x; i < RN; i += blockDim.x) {
      if (kMultiBit)
        acc[i] = garner(res, i, RN, P, cs);
      else
        acc[i] += garner(res, i, RN, P, cs);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < RN; i += blockDim.x) acc_b[i] = (int64_t)acc[i];
}

template <bool kMultiBit>
int launch(void* acc, const void* exps, long long e_stride, const void* bsk,
           const void* tab, const void* consts, int batch, int n_steps, int n, int log_n,
           int P, int R, int L, int base_log, int V, void* stream) {
  const int J = L * R;
  if (P < 1 || P > MAXP || J < 1 || J > 15 || (1 << log_n) != n || log_n < 2 ||
      base_log < 1 || base_log > 24 || base_log * L > 64 || batch < 1 || n_steps < 1 ||
      (batch > 1 && e_stride < (long long)n_steps * (kMultiBit ? V - 1 : 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * R * n + (size_t)4 * J * n + (size_t)4 * P * R * n;
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<kMultiBit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blind_rotate_kernel<kMultiBit><<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      (int64_t*)acc, (const int32_t*)exps, e_stride, (const uint32_t*)bsk,
      (const uint32_t*)tab, (const u64*)consts, n_steps, log_n, P, R, L,
      base_log, V);
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
  return launch<false>(acc, exps, n_steps, bsk, tab, consts, batch, n_steps, n, log_n, P,
                       R, L, base_log, 1, stream);
}

extern "C" int tfhe_blind_rotate_multi_bit(void* acc, const void* exps, const void* bsk,
                                           const void* tab, const void* consts,
                                           int batch, int n_steps, int n, int log_n,
                                           int P, int R, int L, int base_log,
                                           int grouping, void* stream) {
  if (grouping < 1 || grouping > 4 || R > MAXR) return (int)cudaErrorInvalidValue;
  const int V = 1 << grouping;
  return launch<true>(acc, exps, (long long)n_steps * (V - 1), bsk, tab, consts, batch,
                      n_steps, n, log_n, P, R, L, base_log, V, stream);
}

// K4: one delta step.  exps points at the step's exponent of ciphertext 0;
// ciphertext b's is exps[b * e_stride].  bsk is the step's [P][J][R][N].
extern "C" int tfhe_blind_rotate_step(void* acc, const void* exps, long long e_stride,
                                      const void* bsk, const void* tab, const void* consts,
                                      int batch, int n, int log_n, int P, int R, int L,
                                      int base_log, void* stream) {
  return launch<false>(acc, exps, e_stride, bsk, tab, consts, batch, 1, n, log_n, P, R, L,
                       base_log, 1, stream);
}

// K5: one variant step.  exps points at c_1 of ciphertext 0, ciphertext b's
// c_1..c_{V-1} are exps[b * e_stride + v - 1].  bsk is the step's
// [V][P][J][R][N].
extern "C" int tfhe_blind_rotate_step_variants(void* acc, const void* exps,
                                               long long e_stride, const void* bsk,
                                               const void* tab, const void* consts,
                                               int batch, int n, int log_n, int P, int R,
                                               int L, int base_log, int grouping,
                                               void* stream) {
  if (grouping < 1 || grouping > 4 || R > MAXR) return (int)cudaErrorInvalidValue;
  return launch<true>(acc, exps, e_stride, bsk, tab, consts, batch, 1, n, log_n, P, R, L,
                      base_log, 1 << grouping, stream);
}
