// Host stand-in for <cuda_runtime.h>: enough of the CUDA runtime to compile
// meep_nl_tpu_torch/csrc/fdtd3d_t2.cu with a C++ compiler and run its kernel
// as one thread of one block (tests/test_torch_fdtd3d_t2_emul.py).  A
// cooperative launch becomes a plain call, a grid barrier a no-op, constant
// memory a static, an atomic add a plain add.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __constant__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx(0, 0, 0), blockDim, gridDim, threadIdx(0, 0, 0);
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 701,
  cudaMemcpyHostToDevice = 1,
  cudaDevAttrMultiProcessorCount = 16
};
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n, int,
                                   cudaStream_t) {
  memcpy(dst, src, n);
  return 0;
}
template <class S>
cudaError_t cudaMemcpyToSymbolAsync(S& symbol, const void* src, size_t n,
                                    size_t, int, cudaStream_t) {
  memcpy(&symbol, src, n);
  return 0;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void* fn, dim3, dim3,
                                               void**, size_t,
                                               cudaStream_t) {
  ((void (*)())fn)();
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class T>
T atomicAdd(T* p, T v) {
  T old = *p;
  *p += v;
  return old;
}
