// A host stand-in for the CUDA runtime and device intrinsics that
// tfhe_tpu_torch/csrc/rotation.cu uses, so that its delta kernels (K1, K4)
// compile with a C++20 host compiler and run on the CPU: every CUDA thread
// of a block is a std::thread, __syncthreads() a std::barrier over the
// block, __syncwarp() one over the warp, and dynamic shared memory one
// buffer.  Blocks run one after another.  The intrinsics compute what the
// device's do.  Clusters are not modelled (map_shared_rank returns the
// block's own memory), so the variant kernels run only at a cluster of 1.
// tests/test_torch_delta_host.py builds it; it is no part of the port.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)

struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
inline std::unique_ptr<std::barrier<>> host_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
alignas(16) inline unsigned char host_smem[232448];
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { host_warp_barriers[threadIdx.x >> 5]->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaLaunchAttributeProgrammaticStreamSerialization, cudaLaunchAttributeClusterDimension,
  cudaDevAttrMultiProcessorCount
};
struct cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}

// Runs the grid: block after block, each as blockDim.x threads (one
// std::thread per CUDA thread, started once for the whole grid and held
// between blocks by a barrier).
template <class... Params, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Params...),
                               Args&&... args) {
  if (cfg->dynamicSmemBytes > sizeof host_smem) return cudaErrorInvalidValue;
  const unsigned threads = cfg->blockDim.x;
  blockDim = dim3(threads);
  host_block_barrier = std::make_unique<std::barrier<>>(threads);
  host_warp_barriers.clear();
  for (unsigned w = 0; w < (threads + 31) / 32; ++w)
    host_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
  std::barrier<> between_blocks(threads);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < cfg->gridDim.x; ++b) {
        if (t == 0) {
          blockIdx = dim3(b);
          std::memset(host_smem, 0xA5, sizeof host_smem);   // stale data, as on the card
        }
        between_blocks.arrive_and_wait();
        kernel(args...);
        between_blocks.arrive_and_wait();
      }
    });
  for (auto& th : pool) th.join();
  return cudaSuccess;
}

namespace cooperative_groups {
struct host_cluster {
  unsigned block_rank() { return 0; }
  void sync() { __syncthreads(); }
  template <class T> T* map_shared_rank(T* p, unsigned) { return p; }
};
inline host_cluster this_cluster() { return {}; }
}  // namespace cooperative_groups
