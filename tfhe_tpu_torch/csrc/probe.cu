// Shared-memory capacity probe: the card's counterpart of the TPU's VMEM
// probe (`probe`, tools/vmem_probe.py:19, whose pallas_call at :26 asks
// Mosaic for an mb-sized VMEM scratch and reports whether it compiles and
// runs).  Here the scarce on-chip store is a block's dynamic shared memory:
// `tfhe_smem_probe` raises cudaFuncAttributeMaxDynamicSharedMemorySize to
// `nbytes` and launches one block that writes every byte of its dynamic
// shared memory, reads every byte back in another thread's order and adds
// them into `out`; the wrapper (`smem_probe.py`) checks the sum.  The
// device attribute cudaDevAttrMaxSharedMemoryPerBlockOptin, its plain
// counterpart, comes from `tfhe_smem_optin`.
//
// Bounds on the card: one block on one SM, about 2 * nbytes shared-memory
// accesses and one byte multiply per byte; microseconds.  Nothing here is
// left to later work: the probe answers one question, the largest dynamic
// shared memory a block of the rotation kernels can be given.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PROBE_THREADS = 1024;

__global__ void smem_probe_kernel(unsigned long long* out, int nbytes) {
  extern __shared__ unsigned char buf[];
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x)
    buf[i] = (unsigned char)((unsigned)i * 131u + 7u);
  __syncthreads();
  unsigned long long sum = 0;
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x) sum += buf[nbytes - 1 - i];
  atomicAdd(out, sum);
}

}  // namespace

// 0 when the block launched; cudaErrorInvalidValue when the runtime refuses
// nbytes of dynamic shared memory; any other code is a fault.
extern "C" int tfhe_smem_probe(int nbytes, void* out, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused size is an answer, not a sticky error
    return (int)err;
  }
  smem_probe_kernel<<<1, PROBE_THREADS, nbytes, (cudaStream_t)stream>>>(
      (unsigned long long*)out, nbytes);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
