// Where a lane loop's lanes take their pixels (PixelSource), and what a
// lane does next (LaneMode), shared by the fused kernels' lane loops: K3
// and K4 (quality_lanes.cuh), K1 and K2 (megakernel_lanes.cuh). A warp
// at a time, one pixel each for the lanes that want one, either
//   - from a run sequence (K4; K2 one run at a time): the frame cut into
//     runs of `run` consecutive pixels, warp w of W owning runs w, w + W,
//     w + 2W, ... (a fixed assignment: which pixels a warp runs, and in
//     which order its lanes take them, depends on the data and the sizes
//     alone; K2 sets warp to the run it took from its queue of runs and W
//     to the number of runs, so that the sequence is that run alone); or
//   - from a queue (K3, K1): one int32 counter in device memory, zeroed
//     by the wrapper, one atomic a warp (quality_queue.cuh's rule); the
//     queue reads next_pixel and n alone.

#pragma once

#include <cuda_runtime.h>

namespace spath {

// What a lane does next: take a pixel, sweep its camera ray, sweep a
// bounce's rays, or start its pixel's next sample (after a pause).
enum LaneMode : int {
  kLaneIdle = 0,
  kLaneCamera = 1,
  kLaneBounce = 2,
  kLaneSample = 3
};

struct PixelSource {
  int* next_pixel;  // the queue's counter, or nullptr for runs
  int n, run;       // pixels; pixels a run
  int warp, warps;  // this warp in the grid, and the grid's warps
  int taken;        // positions of this warp's run sequence handed out

  // The pixel at position q of this warp's run sequence, or n past its
  // end (positions map to ascending pixels).
  __device__ __forceinline__ int at(int q) const {
    const int r = q / run;
    const long long k = (static_cast<long long>(warp) +
                         static_cast<long long>(r) * warps) * run +
                        (q - r * run);
    return k < n ? static_cast<int>(k) : n;
  }

  // Called by the whole warp: a pixel for each lane that wants one, n
  // where none is left.
  __device__ __forceinline__ int take(bool wants) {
    constexpr unsigned kFull = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const unsigned takers = __ballot_sync(kFull, wants);
    if (takers == 0u) return n;
    const int rank = __popc(takers & ((1u << lane) - 1u));
    if (next_pixel == nullptr) {
      const int q = taken + rank;
      taken += __popc(takers);
      return wants ? at(q) : n;
    }
    const int leader = __ffs(takers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(next_pixel, __popc(takers));
    base = __shfl_sync(kFull, base, leader);
    return wants && base + rank < n ? base + rank : n;
  }
};

}  // namespace spath
