// Host stand-in for <cuda_runtime.h>: enough of the CUDA runtime to compile
// meep_nl_tpu_torch/csrc/fdtd3d.cu, fdtd3d_t2.cu, resident.cu and fused.cu
// with a C++ compiler and run their kernels with one thread per block
// (tests/test_torch_fdtd3d_emul.py, tests/test_torch_fdtd3d_t2_emul.py,
// tests/test_torch_resident_emul.py, tests/test_torch_fused_emul.py).  A
// cooperative launch becomes a plain call (with the one pointer argument
// the resident kernel takes); a cudaLaunchKernel runs the grid's blocks
// one after another, each a call with the arguments unpacked, blockIdx set
// and its dynamic shared memory a zeroed host buffer (stub_dynamic_smem,
// which a source reads in place of its `extern __shared__` array when
// MNT_CUDA_STUB is defined), in the order stub_set_block_order chose:
// forward, reversed or a seeded shuffle.  A grid or block barrier is a
// no-op, constant and shared memory a static, an atomic add a plain add.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <numeric>
#include <random>
#include <type_traits>
#include <utility>
#include <vector>
#define MNT_CUDA_STUB
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __constant__ static
#define __shared__ static
inline void __syncthreads() {}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx(0, 0, 0), blockDim, gridDim, threadIdx(0, 0, 0);
typedef int cudaError_t;
typedef void* cudaStream_t;
typedef int cudaDeviceAttr;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 701,
  cudaMemcpyHostToDevice = 1,
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrReservedSharedMemoryPerBlock = 111,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline std::vector<unsigned char>& stub_smem_buffer() {
  static std::vector<unsigned char> buf;
  return buf;
}
inline unsigned char* stub_dynamic_smem() { return stub_smem_buffer().data(); }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// the H100's shared memory (a block's opt-in most, an SM's, the reserve
// per block); 1 for any other attribute
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin       ? 232448
       : attr == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 233472
       : attr == cudaDevAttrReservedSharedMemoryPerBlock     ? 1024
                                                             : 1;
  return 0;
}
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
                                               void** args, size_t,
                                               cudaStream_t) {
  if (args)
    ((void (*)(const void*))fn)(*(const void* const*)args[0]);
  else
    ((void (*)())fn)();
  return 0;
}
template <class... A, size_t... I>
void stub_call(void (*fn)(A...), void** args, std::index_sequence<I...>) {
  fn(*static_cast<typename std::remove_reference<A>::type*>(args[I])...);
}
// the order in which cudaLaunchKernel runs a grid's blocks: 0 forward,
// 1 reversed, else a shuffle seeded with the value
inline int& stub_block_order() {
  static int order = 0;
  return order;
}
extern "C" void stub_set_block_order(int order) {
  stub_block_order() = order;
}
template <class... A>
cudaError_t cudaLaunchKernel(void (*fn)(A...), dim3 grid, dim3, void** args,
                             size_t smem, cudaStream_t) {
  std::vector<unsigned> blocks(grid.x);
  std::iota(blocks.begin(), blocks.end(), 0u);
  const int order = stub_block_order();
  if (order == 1)
    std::reverse(blocks.begin(), blocks.end());
  else if (order != 0)
    std::shuffle(blocks.begin(), blocks.end(), std::mt19937(order));
  gridDim = dim3(grid.x);
  for (unsigned b : blocks) {
    blockIdx = dim3(b);
    stub_smem_buffer().assign(smem + 16, 0);
    stub_call(fn, args, std::index_sequence_for<A...>{});
  }
  gridDim = dim3();
  blockIdx = dim3(0, 0, 0);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class T>
T atomicAdd(T* p, T v) {
  T old = *p;
  *p += v;
  return old;
}
