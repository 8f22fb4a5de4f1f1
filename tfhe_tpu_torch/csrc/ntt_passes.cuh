// The delta body's shared machinery: the passes, the MAC and the Garner
// lift that K1/K4 and K6 (csrc/rotation.cu) and K7/K8
// (csrc/external_product.cu) run, each body calling these device
// functions.  rotation.cu's header says what the design does and why
// (radix-8 passes in registers, twiddles beside their Shoup twins in heap
// order, Harvey lazy reduction, the bank swizzle, the primes' constants as
// a kernel parameter); external_product.cu's says how K7/K8 use it.
// Included after <cstdint> and the CUDA runtime (or tests/cuda_host_stub.h).
#pragma once

namespace {

typedef unsigned long long u64;
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

// ---- the delta body (K1/K4) ------------------------------------------------
//
// dtab (u32 pairs: a value and its Shoup twin), from rotation.py
// _delta_tables: psi_rev [P][N], psi_inv_rev [P][N] and the phase [P][2N]
// = (psi^m - 1)/N, so that a pass's twiddles at heap node q (q, 2q..2q+1,
// 4q..4q+3) are one 8-byte and one or two 16-byte loads, and a slot's phase
// one 8-byte gather.  The pass lists (`head`, `tail`) are rotation.py
// _delta_layout's: the count in bits 0-3, one radix log per 4 bits above.

// Where a polynomial keeps coefficient or slot `pos` in shared memory (bits
// 2-4 XOR bits 5-7): a 4-slot group stays whole and aligned, and each
// pass's warp access (strides 32 and 4 in the tail, 1 in the head, the
// MAC's 16-byte groups) falls in 32 banks.
__device__ __forceinline__ int swz(int pos) { return pos ^ (((pos >> 5) & 7) << 2); }

__host__ __device__ __forceinline__ int pass_count(unsigned code) { return (int)(code & 15u); }
__host__ __device__ __forceinline__ int pass_radix(unsigned code, int i) {
  return (int)((code >> (4 + 4 * i)) & 15u);
}

// The 2^RL - 1 twiddles of heap node q, at heap-relative index 1 (q), 2-3
// (2q, 2q+1), 4-7 (4q..4q+3) and, for RL = 4 (the cluster step's exchange
// at 16 blocks), 8-15 (8q..8q+7).
template <int RL, int NT>
__device__ __forceinline__ void load_twiddles(uint2 (&tw)[NT], const uint2* __restrict__ t,
                                              int q) {
  static_assert(NT >= (1 << RL) && RL <= 4, "a twiddle array of 2^RL entries");
  if constexpr (RL >= 1) tw[1] = __ldg(t + q);
  if constexpr (RL >= 2) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(t + 2 * q));
    tw[2] = make_uint2(a.x, a.y);
    tw[3] = make_uint2(a.z, a.w);
  }
  if constexpr (RL >= 3) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(t + 4 * q));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(t + 4 * q + 2));
    tw[4] = make_uint2(a.x, a.y);
    tw[5] = make_uint2(a.z, a.w);
    tw[6] = make_uint2(b.x, b.y);
    tw[7] = make_uint2(b.z, b.w);
  }
  if constexpr (RL >= 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(t + 8 * q + 2 * i));
      tw[8 + 2 * i] = make_uint2(a.x, a.y);
      tw[9 + 2 * i] = make_uint2(a.z, a.w);
    }
  }
}

// The delta body's butterflies reduce lazily (Harvey): the forward
// transform keeps residues in [0, 4p), the inverse in [0, 2p), which p <
// 2^30 lets a u32 hold; the MAC and the last inverse pass reduce fully.
// x - m if x >= m, for x < 2^32 - m: one subtraction and an unsigned min.
__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) { return min(x, x - m); }

// a * w mod p plus 0 or p, for any a < 2^32 (Shoup, without the correction).
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t w, uint32_t ws,
                                             uint32_t p) {
  return a * w - __umulhi(a, ws) * p;
}

// RL forward (Cooley-Tukey) stages on a thread's 2^RL coefficients at
// base + s*2^lo, the widest stride first: [0, 4p) in and out.
template <int RL, int NT>
__device__ __forceinline__ void ct_stages(uint32_t (&a)[1 << RL], const uint2 (&tw)[NT],
                                          uint32_t p) {
#pragma unroll
  for (int i = RL - 1; i >= 0; --i) {
#pragma unroll
    for (int s = 0; s < (1 << RL); ++s) {
      if (s & (1 << i)) continue;
      const uint2 w = tw[(1 << (RL - 1 - i)) + (s >> (i + 1))];
      const uint32_t u = csub(a[s], 2 * p), v = mul_lazy(a[s + (1 << i)], w.x, w.y, p);
      a[s] = u + v;
      a[s + (1 << i)] = u - v + 2 * p;
    }
  }
}

// RL inverse (Gentleman-Sande) stages, the narrowest stride first: [0, 2p)
// in and out.
template <int RL, int NT>
__device__ __forceinline__ void gs_stages(uint32_t (&a)[1 << RL], const uint2 (&tw)[NT],
                                          uint32_t p) {
#pragma unroll
  for (int i = 0; i < RL; ++i) {
#pragma unroll
    for (int s = 0; s < (1 << RL); ++s) {
      if (s & (1 << i)) continue;
      const uint2 w = tw[(1 << (RL - 1 - i)) + (s >> (i + 1))];
      const uint32_t u = a[s], v = a[s + (1 << i)];
      a[s] = csub(u + v, 2 * p);
      a[s + (1 << i)] = mul_lazy(u - v + 2 * p, w.x, w.y, p);
    }
  }
}

// The word of coefficient base + k*2^lo in a swizzled polynomial.  A
// stride of 256 or more leaves bits 0-7, and so the swizzle, alone: where
// lo is a constant that makes one swizzle per item and a constant step per
// coefficient.
__device__ __forceinline__ int swz_at(int base, int k, int lo) {
  return lo >= 8 ? swz(base) + (k << lo) : swz(base + (k << lo));
}

// One item of a pass: heap node q, coefficients base + s*2^lo of a
// polynomial whose swizzled words from `org` on are at `poly` (org = 0:
// the whole polynomial; a region's first coefficient: that region).
template <int RL, bool FWD>
__device__ __forceinline__ void pass_item(uint32_t* poly, int q, int base, int lo,
                                          const uint2* __restrict__ t, uint32_t p,
                                          int org = 0) {
  uint2 tw[8];
  load_twiddles<RL>(tw, t, q);
  uint32_t a[1 << RL];
#pragma unroll
  for (int s = 0; s < (1 << RL); ++s) a[s] = poly[swz_at(base, s, lo) - org];
  if constexpr (FWD) ct_stages<RL>(a, tw, p); else gs_stages<RL>(a, tw, p);
#pragma unroll
  for (int s = 0; s < (1 << RL); ++s) poly[swz_at(base, s, lo) - org] = a[s];
}

// A head pass at stride 2^lo over `npoly` polynomials, items spread over
// the block.
template <int RL, bool FWD>
__device__ void block_pass(uint32_t* arr, int npoly, int log_n, int lo,
                           const uint2* __restrict__ t, uint32_t p) {
  const int lg = log_n - RL;   // log2 of the items per polynomial
  for (int f = threadIdx.x; f < (npoly << lg); f += blockDim.x) {
    const int it = f & ((1 << lg) - 1), blk = it >> lo;
    pass_item<RL, FWD>(arr + ((f >> lg) << log_n), (1 << (lg - lo)) + blk,
                       (blk << (lo + RL)) + (it & ((1 << lo) - 1)), lo, t, p);
  }
}

template <bool FWD>
__device__ void block_pass_r(int r, uint32_t* arr, int npoly, int log_n, int lo,
                             const uint2* __restrict__ t, uint32_t p) {
  switch (r) {
    case 1: block_pass<1, FWD>(arr, npoly, log_n, lo, t, p); break;
    case 2: block_pass<2, FWD>(arr, npoly, log_n, lo, t, p); break;
    default: block_pass<3, FWD>(arr, npoly, log_n, lo, t, p); break;
  }
}

// A tail pass on one warp's region [base, base + 2^log_w) of a polynomial,
// whose words are at `region` (the swizzle keeps a region of 32 or more
// coefficients within its words).
template <int RL, bool FWD>
__device__ __forceinline__ void tail_pass(uint32_t* region, int base, int log_n, int log_w,
                                          int lo, const uint2* __restrict__ t, uint32_t p) {
  for (int it = threadIdx.x & 31; it < (1 << (log_w - RL)); it += 32) {
    const int blk = (base >> (lo + RL)) + (it >> lo);
    pass_item<RL, FWD>(region, (1 << (log_n - lo - RL)) + blk,
                       (blk << (lo + RL)) + (it & ((1 << lo) - 1)), lo, t, p, base);
  }
}

// The tail of N >= 512 (regions of 256, passes of radix 8 at strides 32 and
// 4), one item per lane, the swizzle folded into each lane's addresses.
// Stride 32: lane holds region[lane + 32s], row s, so its word is 32s +
// (lane ^ 4s).  Stride 4: lane holds region[32(lane/4) + lane%4 + 4s], row
// lane/4, so its word is 32(lane/4) + lane%4 + (4s ^ (lane & 28)).
template <bool FWD>
__device__ __forceinline__ void tail256_stride32(uint32_t* region, int q,
                                                 const uint2* __restrict__ t, uint32_t p) {
  const int lane = threadIdx.x & 31;
  uint2 tw[8];
  load_twiddles<3>(tw, t, q);
  uint32_t a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = region[32 * s + (lane ^ (4 * s))];
  if constexpr (FWD) ct_stages<3>(a, tw, p); else gs_stages<3>(a, tw, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) region[32 * s + (lane ^ (4 * s))] = a[s];
}

template <bool FWD>
__device__ __forceinline__ void tail256_stride4(uint32_t* region, int q,
                                                const uint2* __restrict__ t, uint32_t p) {
  const int lane = threadIdx.x & 31, x = lane & 28;
  uint32_t* b = region + 8 * x + (lane & 3);
  uint2 tw[8];
  load_twiddles<3>(tw, t, q);
  uint32_t a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = b[(4 * s) ^ x];
  if constexpr (FWD) ct_stages<3>(a, tw, p); else gs_stages<3>(a, tw, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) b[(4 * s) ^ x] = a[s];
}

// The tail's pass list at N >= 512 (rotation.py _delta_layout): radix 8, 8.
constexpr unsigned TAIL256 = 2u | (3u << 4) | (3u << 8);

// Both tail passes on region blk (256 coefficients, its words at
// `region`), by one warp.
template <bool FWD>
__device__ __forceinline__ void tail256_region(uint32_t* region, int blk, int log_n,
                                               const uint2* __restrict__ t, uint32_t p) {
  const int q32 = (1 << (log_n - 8)) + blk;
  const int q4 = (1 << (log_n - 5)) + 8 * blk + ((threadIdx.x & 31) >> 2);
  if constexpr (FWD) tail256_stride32<FWD>(region, q32, t, p);
  else tail256_stride4<FWD>(region, q4, t, p);
  __syncwarp();
  if constexpr (FWD) tail256_stride4<FWD>(region, q4, t, p);
  else tail256_stride32<FWD>(region, q32, t, p);
  __syncwarp();
}

// The tail of N >= 512 over `npoly` polynomials, one warp per region.
template <bool FWD>
__device__ void tail256_passes(uint32_t* arr, int npoly, int log_n,
                               const uint2* __restrict__ t, uint32_t p) {
  const int shift = log_n - 8;
  for (int g = threadIdx.x >> 5; g < (npoly << shift); g += blockDim.x >> 5)
    tail256_region<FWD>(arr + ((g >> shift) << log_n) + ((g & ((1 << shift) - 1)) << 8),
                        g & ((1 << shift) - 1), log_n, t, p);
}

// The tail passes (top down forward, bottom up inverse) on one warp's
// region [base, base + 2^log_w) of a polynomial, its words at `region`,
// warp barriers between passes.
template <bool FWD>
__device__ __forceinline__ void region_tails(uint32_t* region, int base, int log_n, int log_w,
                                             unsigned code, const uint2* __restrict__ t,
                                             uint32_t p) {
  if (log_w == 8 && code == TAIL256) {
    tail256_region<FWD>(region, base >> 8, log_n, t, p);
    return;
  }
  const int count = pass_count(code);
  int lo = FWD ? log_w : 2;
  for (int i = 0; i < count; ++i) {
    const int r = pass_radix(code, FWD ? i : count - 1 - i);
    if (FWD) lo -= r;
    switch (r) {
      case 1: tail_pass<1, FWD>(region, base, log_n, log_w, lo, t, p); break;
      case 2: tail_pass<2, FWD>(region, base, log_n, log_w, lo, t, p); break;
      default: tail_pass<3, FWD>(region, base, log_n, log_w, lo, t, p); break;
    }
    if (!FWD) lo += r;
    __syncwarp();
  }
}

// The tail passes over `npoly` polynomials, one warp per region.
template <bool FWD>
__device__ void tail_passes(uint32_t* arr, int npoly, int log_n, int log_w, unsigned code,
                            const uint2* __restrict__ t, uint32_t p) {
  const int shift = log_n - log_w;
  if (log_w == 8 && code == TAIL256) {
    tail256_passes<FWD>(arr, npoly, log_n, t, p);
    return;
  }
  for (int g = threadIdx.x >> 5; g < (npoly << shift); g += blockDim.x >> 5) {
    const int base = (g & ((1 << shift) - 1)) << log_w;
    region_tails<FWD>(arr + ((g >> shift) << log_n) + base, base, log_n, log_w, code, t, p);
  }
}

// The first forward pass (the top RL stages, heap node 1 for every item):
// each item (r, off) reads the words src(r*N + off + s*N/2^RL) (K1: its
// accumulator in shared memory; K7/K8: the operand, from device memory),
// splits each into its L balanced digits, reduces them mod p and
// transforms each level in registers into spec row j = l*R + r.
template <int RL, class Src>
__device__ void decompose_pass(Src src, uint32_t* spec, int R, int L, int log_n,
                               int base_log, const uint2* __restrict__ t, uint32_t p) {
  const int lo = log_n - RL, shift = 64 - base_log * L;
  const uint64_t round = shift > 0 ? (1ull << (shift - 1)) : 0ull;
  const uint64_t dmask = (1ull << base_log) - 1, dhalf = 1ull << (base_log - 1);
  uint2 tw[8];
  load_twiddles<RL>(tw, t, 1);
  for (int f = threadIdx.x; f < (R << lo); f += blockDim.x) {
    const int r = f >> lo, off = f & ((1 << lo) - 1);
    uint64_t s[1 << RL];
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) {
      const uint64_t a = src((r << log_n) + off + (k << lo));
      s[k] = shift > 0 ? (a + round) >> shift : a;
    }
    for (int l = L - 1; l >= 0; --l) {
      uint32_t d[1 << RL];
      if (shift >= 33) {   // the rounded value and its carries fit 32 bits
#pragma unroll
        for (int k = 0; k < (1 << RL); ++k) {
          const uint32_t raw = (uint32_t)s[k] & (uint32_t)dmask;
          const uint32_t carry = (raw + (uint32_t)dhalf) >> base_log;
          const int32_t v = (int32_t)raw - (int32_t)(carry << base_log);
          s[k] = ((uint32_t)s[k] >> base_log) + carry;
          d[k] = v < 0 ? (uint32_t)(v + (int32_t)p) : (uint32_t)v;
        }
      } else {
#pragma unroll
        for (int k = 0; k < (1 << RL); ++k) {
          const uint64_t raw = s[k] & dmask;
          const uint64_t carry = (raw + dhalf) >> base_log;
          const int64_t v = (int64_t)raw - (int64_t)(carry << base_log);
          s[k] = (s[k] >> base_log) + carry;
          d[k] = v < 0 ? (uint32_t)(v + p) : (uint32_t)v;
        }
      }
      ct_stages<RL>(d, tw, p);
      uint32_t* poly = spec + ((l * R + r) << log_n);
#pragma unroll
      for (int k = 0; k < (1 << RL); ++k) poly[swz_at(off, k, lo)] = d[k];
    }
  }
}

template <class Src>
__device__ void decompose_pass_r(int r, Src src, uint32_t* spec, int R, int L, int log_n,
                                 int base_log, const uint2* __restrict__ t, uint32_t p) {
  switch (r) {
    case 0: decompose_pass<0>(src, spec, R, L, log_n, base_log, t, p); break;
    case 1: decompose_pass<1>(src, spec, R, L, log_n, base_log, t, p); break;
    case 2: decompose_pass<2>(src, spec, R, L, log_n, base_log, t, p); break;
    default: decompose_pass<3>(src, spec, R, L, log_n, base_log, t, p); break;
  }
}

// The primes' constants the delta kernel reads (the C_* entries of the
// constants buffer: p and mu for the MAC, the rest for Garner), passed by
// value as one __grid_constant__ parameter: Garner's indices are constants
// once the loops unroll, so the lift reads them as operands from the
// kernel's parameter bank, not through loads.
struct DeltaConsts {
  uint32_t p[MAXP], gw[MAXP][MAXP], gw_sh[MAXP][MAXP], ginv[MAXP], ginv_sh[MAXP], half[MAXP];
  u64 mu[MAXP], prefix[MAXP], mmod;
};

// K8's lift mod 2^128: (hi, lo) of each prefix prod_{j<a} p_j and of M
// (the product of 6 or 7 primes exceeds 2^128), both mod 2^128.
struct Wide128 {
  u64 prefix[MAXP][2], mmod[2];
};

// The signed lift of the residues get(a), a < P, each in [0, p_a): mod 2^64,
// or with W128 mod 2^128, its high word in *hi (each term a 64 x 128-bit
// product from __umul64hi).  PT > 0 fixes P = PT at compile time.
template <int PT, bool W128 = false, class Get>
__device__ __forceinline__ uint64_t garner_from(Get get, int P, const DeltaConsts& g,
                                                const Wide128* w = nullptr,
                                                uint64_t* hi = nullptr) {
  if constexpr (PT > 0) P = PT;
  uint32_t t[MAXP];
  t[0] = get(0);
  uint64_t c = t[0], ch = 0;
#pragma unroll
  for (int a = 1; a < (PT > 0 ? PT : MAXP); ++a) {
    if (a >= P) break;
    const uint32_t pa = g.p[a];
    uint32_t acc = 0;
#pragma unroll
    for (int b = 0; b < a; ++b)
      acc = add_mod(acc, mul_shoup(t[b], g.gw[a][b], g.gw_sh[a][b], pa), pa);
    t[a] = mul_shoup(sub_mod(get(a), acc, pa), g.ginv[a], g.ginv_sh[a], pa);
    if constexpr (W128) {
      const uint64_t plo = (uint64_t)t[a] * w->prefix[a][1];
      c += plo;
      ch += __umul64hi((uint64_t)t[a], w->prefix[a][1]) + (uint64_t)t[a] * w->prefix[a][0] +
            (c < plo ? 1ull : 0ull);
    } else {
      c += (uint64_t)t[a] * g.prefix[a];
    }
  }
  bool ge = false, eq = true;
#pragma unroll
  for (int a = (PT > 0 ? PT : MAXP) - 1; a >= 0; --a) {
    if (a >= P) continue;
    ge = ge || (eq && t[a] > g.half[a]);
    eq = eq && (t[a] == g.half[a]);
  }
  if constexpr (W128) {
    if (ge || eq) {   // negative: less M mod 2^128
      ch -= w->mmod[0] + (c < w->mmod[1] ? 1ull : 0ull);
      c -= w->mmod[1];
    }
    *hi = ch;
    return c;
  } else {
    return (ge || eq) ? c - g.mmod : c;
  }
}

// garner_from with the last prime's residue given: res[a * stride + i] for
// a < P - 1, `last` for a = P - 1.
template <int PT>
__device__ __forceinline__ uint64_t garner_last(const uint32_t* res, int i, int stride,
                                                uint32_t last, int P, const DeltaConsts& g) {
  const int np = PT > 0 ? PT : P;
  return garner_from<PT>([&](int a) { return a == np - 1 ? last : res[a * stride + i]; }, np,
                         g);
}

// The last inverse pass (the top RL stages) of one prime's R products
// (words from res_p on), item (r, off) as decompose_pass maps it: the
// residues in [0, p) stored, or with `lift` handed to emit(i, at, v), i =
// r*N + the coefficient, at = r*N + its swizzled word, v its residue.  A
// lift on the last prime reads the earlier primes' residues at `at`: the
// thread that lifts a coefficient is the one that wrote them, so it needs
// no block barrier.
template <int RL, class Emit>
__device__ void inverse_top(uint32_t* res_p, int R, int log_n, const uint2* __restrict__ t,
                            uint32_t p, bool lift, Emit emit) {
  const int lo = log_n - RL;
  uint2 tw[8];
  load_twiddles<RL>(tw, t, 1);
  for (int f = threadIdx.x; f < (R << lo); f += blockDim.x) {
    const int r = f >> lo, off = f & ((1 << lo) - 1);
    uint32_t* poly = res_p + (r << log_n);
    uint32_t a[1 << RL];
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) a[k] = poly[swz_at(off, k, lo)];
    gs_stages<RL>(a, tw, p);
#pragma unroll
    for (int k = 0; k < (1 << RL); ++k) {
      a[k] = csub(a[k], p);
      const int at = swz_at(off, k, lo);
      if (lift) emit((r << log_n) + off + (k << lo), (r << log_n) + at, a[k]);
      else poly[at] = a[k];
    }
  }
}

template <class Emit>
__device__ void inverse_top_r(int r, uint32_t* res_p, int R, int log_n,
                              const uint2* __restrict__ t, uint32_t p, bool lift, Emit emit) {
  switch (r) {
    case 0: inverse_top<0>(res_p, R, log_n, t, p, lift, emit); break;
    case 1: inverse_top<1>(res_p, R, log_n, t, p, lift, emit); break;
    case 2: inverse_top<2>(res_p, R, log_n, t, p, lift, emit); break;
    default: inverse_top<3>(res_p, R, log_n, t, p, lift, emit); break;
  }
}

// K1's last inverse pass of prime pi: on the last prime (`lift`) it adds
// the Garner lift of each coefficient into acc, in shared memory or, on the
// last step, straight to `acc_out` in device memory; the thread that lifts
// a coefficient also reads it for the next step's digits.
template <int RL, int PT = 0>
__device__ void top_inverse_pass(uint32_t* res, int pi, int P, int R, int log_n,
                                 const uint2* __restrict__ t, uint32_t p, bool lift,
                                 uint64_t* acc, int64_t* acc_out, const DeltaConsts& g) {
  const int RN = R << log_n;
  inverse_top<RL>(res + pi * RN, R, log_n, t, p, lift, [&](int i, int at, uint32_t v) {
    const uint64_t x = acc[i] + garner_last<PT>(res, at, RN, v, P, g);
    if (acc_out != nullptr) acc_out[i] = (int64_t)x; else acc[i] = x;
  });
}

__device__ void top_inverse_pass_r(int r, uint32_t* res, int pi, int P, int R, int log_n,
                                   const uint2* __restrict__ t, uint32_t p, bool lift,
                                   uint64_t* acc, int64_t* acc_out,
                                   const DeltaConsts& g) {
  switch (r) {
    case 0: top_inverse_pass<0>(res, pi, P, R, log_n, t, p, lift, acc, acc_out, g); break;
    case 1: top_inverse_pass<1>(res, pi, P, R, log_n, t, p, lift, acc, acc_out, g); break;
    case 2: top_inverse_pass<2>(res, pi, P, R, log_n, t, p, lift, acc, acc_out, g); break;
    default: top_inverse_pass<3>(res, pi, P, R, log_n, t, p, lift, acc, acc_out, g); break;
  }
}

// Each 64-bit MAC sum is reduced before its 17th product: digit residues
// and key words are fully reduced (< p < 2^30), so 16 products stay below
// 16 p^2 < 2^64, and so do 16 more beside a Barrett-reduced residue (< p).

// s[r][c] <- s[r][c] mod p (Barrett), for RT outputs of 4 slots.
template <int RT>
__device__ __forceinline__ void reduce_sums(uint64_t (&s)[RT][4], uint32_t p, u64 mu) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = barrett(s[r][c], p, mu);
}

// s[r][c] += a[c] * w[r][c] for RT outputs of 4 slots.
template <int RT>
__device__ __forceinline__ void mac4(uint64_t (&s)[RT][4], const uint32_t (&a)[4],
                                     const uint4 (&w)[RT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s[r][0] += (uint64_t)a[0] * w[r].x;
    s[r][1] += (uint64_t)a[1] * w[r].y;
    s[r][2] += (uint64_t)a[2] * w[r].z;
    s[r][3] += (uint64_t)a[3] * w[r].w;
  }
}

// The MAC of slots [4x, 4x+4) for outputs r0..r0+RT-1, fused between the
// transforms: the last two forward stages of each digit polynomial in
// registers, the J products of each output in a 64-bit sum (the key words
// as 16-byte loads; WIDE, for J > 16, reduces it after every 16), one
// Barrett reduction, the phase (X^e - 1)/N gathered once per slot for all
// outputs (without PHASE, K7/K8's: the one factor phase[0], 1/N), the
// first two inverse stages, and a 16-byte store of each output's 4 slots.
// The digit and product polynomials in shared memory are 2^log_s words
// apart, and the group's words start at `at` (swz(4x) where they hold whole
// polynomials).
template <int RT, bool WIDE, bool PHASE = true>
__device__ __forceinline__ void mac_group(const uint32_t* spec, uint32_t* res_p,
                                          const uint32_t* __restrict__ key_p, int x, int r0,
                                          int J, int R, int log_n, int log_s, int at,
                                          const uint2* __restrict__ fwd,
                                          const uint2* __restrict__ inv,
                                          const uint2* __restrict__ phase, uint32_t e,
                                          uint32_t p, u64 mu) {
  const int q = (1 << (log_n - 2)) + x, k0 = 4 * x;
  uint2 fw[8], iw[8], ph[4];
  load_twiddles<2>(fw, fwd, q);
  uint64_t s[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0;
  const auto product = [&](int j) {
    uint4 w[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      w[r] = __ldg(reinterpret_cast<const uint4*>(key_p + (((j * R + r0 + r) << log_n) + k0)));
    const uint4 v = *reinterpret_cast<const uint4*>(spec + (j << log_s) + at);
    uint32_t a[4] = {v.x, v.y, v.z, v.w};
    ct_stages<2>(a, fw, p);
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = csub(csub(a[c], 2 * p), p);
    mac4<RT>(s, a, w);
  };
  if constexpr (WIDE) {
    for (int j0 = 0; j0 < J; j0 += MAX_PRODUCTS) {
      if (j0 > 0) reduce_sums<RT>(s, p, mu);
      const int j1 = min(J, j0 + MAX_PRODUCTS);
#pragma unroll 2
      for (int j = j0; j < j1; ++j) product(j);
    }
  } else {
#pragma unroll 2
    for (int j = 0; j < J; ++j) product(j);
  }
  load_twiddles<2>(iw, inv, q);
  if constexpr (PHASE) {
    const uint32_t two_n_mask = (2u << log_n) - 1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t odd = 2u * (__brev((unsigned)(k0 + c)) >> (32 - log_n)) + 1u;
      ph[c] = __ldg(phase + ((e * odd) & two_n_mask));
    }
  } else {
    ph[0] = ph[1] = ph[2] = ph[3] = __ldg(phase);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    uint32_t a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = mul_lazy(barrett(s[r][c], p, mu), ph[c].x, ph[c].y, p);
    gs_stages<2>(a, iw, p);
    *reinterpret_cast<uint4*>(res_p + ((r0 + r) << log_s) + at) =
        make_uint4(a[0], a[1], a[2], a[3]);
  }
}

// Steps 2-4 of a prime where every warp has a 256-slot region of its own
// (N >= 256 * warps): per region, one warp runs the forward tail of each
// digit polynomial, the MAC of the region's 64 groups and the inverse tail
// of each product, with warp barriers only.
template <int RT, bool WIDE, bool PHASE = true>
__device__ __forceinline__ void region_pipeline(const uint32_t* key_p, uint32_t* spec,
                                                uint32_t* res_p, int J, int R, int log_n,
                                                const uint2* __restrict__ fwd,
                                                const uint2* __restrict__ inv,
                                                const uint2* __restrict__ phase, uint32_t e,
                                                uint32_t p, u64 mu) {
  for (int g = threadIdx.x >> 5; g < (1 << (log_n - 8)); g += blockDim.x >> 5) {
    for (int j = 0; j < J; ++j)
      tail256_region<true>(spec + (j << log_n) + (g << 8), g, log_n, fwd, p);
    for (int f = threadIdx.x & 31; f < (R / RT) * 64; f += 32) {
      const int x = (g << 6) + (f & 63);
      mac_group<RT, WIDE, PHASE>(spec, res_p, key_p, x, (f >> 6) * RT, J, R, log_n, log_n,
                                 swz(4 * x), fwd, inv, phase, e, p, mu);
    }
    __syncwarp();
    for (int r = 0; r < R; ++r)
      tail256_region<false>(res_p + (r << log_n) + (g << 8), g, log_n, inv, p);
  }
}

// The sum of a pass list's radix logs, each in [min_r, 3]; -1 if it is not one.
int pass_sum(unsigned code, int min_r) {
  const int count = (int)(code & 15u);
  if (count > 7 || code >> (4 + 4 * count) != 0) return -1;
  int sum = 0;
  for (int i = 0; i < count; ++i) {
    const int r = (int)((code >> (4 + 4 * i)) & 15u);
    if (r < min_r || r > 3) return -1;
    sum += r;
  }
  return sum;
}

// The layout (rotation.py _delta_layout) covers the log_n stages: the head
// passes (at least one; radix 1 only when it is the only one), the tail
// passes and the MAC's two; R outputs in chunks of rt.
bool valid_layout(int log_n, int R, int rt, unsigned head, unsigned tail, int log_w) {
  const int h = pass_sum(head, (head & 15u) == 1 ? 0 : 1), t = pass_sum(tail, 1);
  return rt >= 1 && rt <= 4 && R % rt == 0 && (head & 15u) >= 1 && h >= 0 && t >= 0 &&
         log_w == log_n - h && h + t + 2 == log_n;
}

// The delta kernel's constants from the constants buffer in host memory.
DeltaConsts delta_consts(const u64* cs) {
  DeltaConsts g = {};
  for (int a = 0; a < MAXP; ++a) {
    g.p[a] = (uint32_t)cs[C_P + a];
    g.mu[a] = cs[C_MU + a];
    g.ginv[a] = (uint32_t)cs[C_GINV + a];
    g.ginv_sh[a] = (uint32_t)cs[C_GINV_SH + a];
    g.half[a] = (uint32_t)cs[C_HALF + a];
    g.prefix[a] = cs[C_PREFIX + a];
    for (int b = 0; b < MAXP; ++b) {
      g.gw[a][b] = (uint32_t)cs[C_GW + a * 8 + b];
      g.gw_sh[a][b] = (uint32_t)cs[C_GW_SH + a * 8 + b];
    }
  }
  g.mmod = cs[C_MMOD];
  return g;
}

}  // namespace
