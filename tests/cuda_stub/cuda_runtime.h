// Host stand-in for <cuda_runtime.h>: enough of the CUDA runtime to compile
// meep_nl_tpu_torch/csrc/fdtd3d.cu, fdtd3d_t2.cu, resident.cu and fused.cu
// with a C++ compiler and run their kernels with one thread per block
// (tests/test_torch_fdtd3d_emul.py, tests/test_torch_fdtd3d_t2_emul.py,
// tests/test_torch_resident_emul.py, tests/test_torch_fused_emul.py).  A
// cudaLaunchKernel runs the grid's blocks one after another, each a call
// with the arguments unpacked, blockIdx set and its dynamic shared memory a
// zeroed host buffer (stub_dynamic_smem, which a source reads in place of
// its `extern __shared__` array when MNT_CUDA_STUB is defined), in the
// order stub_set_block_order chose: forward, reversed or a seeded shuffle
// (a grid's rows, blockIdx.y, one after another).  A cooperative launch (the resident kernel's: one pointer argument) runs
// each block on a host thread of its own, one at a time: the blocks take
// turns in that order, and grid.sync() hands the turn to the next block
// (cooperative_groups.h), so every block reaches a barrier before any
// passes it; the grid has min(blocks asked, stub_set_sms's SM count)
// blocks.  A block barrier is a no-op, constant memory a static, shared
// memory and the block coordinates per host thread, an atomic add a plain
// add.
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
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
#define __align__(n) __attribute__((aligned(n)))
#define __constant__ static
#define __shared__ static thread_local
inline void __syncthreads() {}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 blockIdx(0, 0, 0), threadIdx(0, 0, 0);
static dim3 blockDim, gridDim;
using std::max;
using std::min;
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
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->sharedSizeBytes = 0;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline std::vector<unsigned char>& stub_smem_buffer() {
  static thread_local std::vector<unsigned char> buf;
  return buf;
}
inline unsigned char* stub_dynamic_smem() { return stub_smem_buffer().data(); }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// the SM count the stub reports (1 unless stub_set_sms chose another)
inline int& stub_sms() {
  static int sms = 1;
  return sms;
}
extern "C" void stub_set_sms(int n) { stub_sms() = n; }
// the H100's shared memory (a block's opt-in most, an SM's, the reserve
// per block), stub_sms() SMs; 1 for any other attribute
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin       ? 232448
       : attr == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 233472
       : attr == cudaDevAttrReservedSharedMemoryPerBlock     ? 1024
       : attr == cudaDevAttrMultiProcessorCount              ? stub_sms()
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
// a cooperative launch's turn-taking: the blocks' positions in the run
// order, whose turn it is, which have returned
struct StubCoop {
  std::mutex m;
  std::condition_variable cv;
  size_t n = 0, turn = 0;
  std::vector<bool> done;
};
inline StubCoop& stub_coop() {
  static StubCoop c;
  return c;
}
inline size_t& stub_coop_pos() {
  static thread_local size_t pos = 0;
  return pos;
}
// the calling block hands the turn to the next one in the order that has
// not returned (finished: it has returned), then waits for its own turn
inline void stub_coop_yield(bool finished) {
  StubCoop& c = stub_coop();
  std::unique_lock<std::mutex> lk(c.m);
  const size_t me = stub_coop_pos();
  if (finished) c.done[me] = true;
  for (size_t d = 1; d <= c.n; ++d) {
    const size_t q = (me + d) % c.n;
    if (!c.done[q]) {
      c.turn = q;
      break;
    }
  }
  c.cv.notify_all();
  if (!finished) c.cv.wait(lk, [&] { return c.turn == me; });
}
inline cudaError_t cudaLaunchCooperativeKernel(const void* fn, dim3 grid,
                                               dim3, void** args,
                                               size_t smem, cudaStream_t) {
  std::vector<unsigned> blocks(grid.x);
  std::iota(blocks.begin(), blocks.end(), 0u);
  const int order = stub_block_order();
  if (order == 1)
    std::reverse(blocks.begin(), blocks.end());
  else if (order != 0)
    std::shuffle(blocks.begin(), blocks.end(), std::mt19937(order));
  StubCoop& c = stub_coop();
  c.n = blocks.size();
  c.turn = 0;
  c.done.assign(c.n, false);
  gridDim = dim3(grid.x);
  const void* arg = *(const void* const*)args[0];
  std::vector<std::thread> threads;
  for (size_t pos = 0; pos < blocks.size(); ++pos)
    threads.emplace_back([=, &c] {
      stub_coop_pos() = pos;
      blockIdx = dim3(blocks[pos]);
      stub_smem_buffer().assign(smem + 16, 0);
      {
        std::unique_lock<std::mutex> lk(c.m);
        c.cv.wait(lk, [&] { return c.turn == pos; });
      }
      ((void (*)(const void*))fn)(arg);
      stub_coop_yield(true);
    });
  for (auto& t : threads) t.join();
  gridDim = dim3();
  return 0;
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
  gridDim = dim3(grid.x, grid.y);
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned b : blocks) {
      blockIdx = dim3(b, y);
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
