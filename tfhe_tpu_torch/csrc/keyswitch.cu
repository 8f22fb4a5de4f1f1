// Keyswitch contraction: out[b, m] = -sum_k d[b, k] * ksk[k, m] mod 2^64,
// plus the input body at m = M - 1.
//
// Replaces the XLA int8-limb dot of `_neg_digit_mac`
// (tfhe_tpu/core/algorithms/keyswitch.py:41), which the JAX package runs
// outside Pallas.  d holds the signed decomposition digits [B, K] (int32,
// K = n_in * levels), ksk the keyswitch key [K, M] as u64 torus words.
//
// Design.  A plain tiled product with exact 64-bit wrapping multiply-adds:
// each 256-thread block stages a 32 x 32 digit tile and a 32 x 64 key tile
// in shared memory and each thread keeps 2 x 4 accumulators in registers.
// No byte limbs, no padding of K.
//
// Bounds on the card.  At PARAM_MESSAGE_2_CARRY_2 (B=512, K=10240, M=743)
// it is 3.9e9 multiply-adds of 64 bits (a few 32-bit IMADs each), and it
// streams the 61 MB key from device memory once per 32 rows of the batch:
// bound by integer multiply throughput, then by key bytes.  Larger batch
// tiles or an int8 tensor-core form are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32, TM = 64, TK = 32, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
keyswitch_mac_kernel(const int32_t* __restrict__ d, const int64_t* __restrict__ ksk,
                     const int64_t* __restrict__ body, int64_t* __restrict__ out,
                     int B, int K, int M) {
  __shared__ int32_t ds[TK][TB + 1];
  __shared__ uint64_t ks[TK][TM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.y * TB, m0 = blockIdx.x * TM;
  uint64_t acc[2][4] = {};

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TB * TK; i += THREADS) {
      const int bb = i / TK, kk = i % TK, gb = b0 + bb, gk = k0 + kk;
      ds[kk][bb] = (gb < B && gk < K) ? d[(size_t)gb * K + gk] : 0;
    }
    for (int i = threadIdx.x; i < TK * TM; i += THREADS) {
      const int kk = i / TM, mm = i % TM, gk = k0 + kk, gm = m0 + mm;
      ks[kk][mm] = (gk < K && gm < M) ? (uint64_t)ksk[(size_t)gk * M + gm] : 0ull;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      uint64_t kv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[kk][tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const uint64_t dv = (uint64_t)(int64_t)ds[kk][ty + 16 * ii];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += dv * kv[jj];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int gb = b0 + ty + 16 * ii;
    if (gb >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gm = m0 + tx + 16 * jj;
      if (gm >= M) continue;
      uint64_t v = 0ull - acc[ii][jj];
      if (gm == M - 1) v += (uint64_t)body[gb];
      out[(size_t)gb * M + gm] = (int64_t)v;
    }
  }
}

}  // namespace

extern "C" int tfhe_keyswitch_mac(const void* digits, const void* ksk,
                                  const void* body, void* out, int B, int K, int M,
                                  void* stream) {
  if (B < 1 || K < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + TM - 1) / TM, (B + TB - 1) / TB);
  keyswitch_mac_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)digits, (const int64_t*)ksk, (const int64_t*)body,
      (int64_t*)out, B, K, M);
  return (int)cudaGetLastError();
}
