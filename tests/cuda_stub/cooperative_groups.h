// Host stand-in for <cooperative_groups.h>: the grid barrier of a
// cooperative launch hands the turn to the next block (see cuda_runtime.h
// beside it, which this needs).
#pragma once
#include <cuda_runtime.h>
namespace cooperative_groups {
struct grid_group {
  void sync() { stub_coop_yield(false); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
