// The Hermes worker score (paper §4.2) and the block-wide first-index
// argmax both kernels that choose a worker use: `hermes_select.cu` (one
// choice per arrival over a given load vector) and `sim_engine.cu` (the
// choice inside the fused event loop).  Blocks are whole warps.
#pragma once

#include <climits>

namespace hermes {

constexpr int kBig = 1 << 30;

// Score of a worker with `active` running invocations, `hot` = 1 if it
// holds a warm executor of the arrival's function.  While any worker has
// a free core (`low_load`), pack: non-empty before empty, warm before
// cold, then the more loaded, among workers with a free core.  Otherwise
// the least loaded, warm breaking ties, among workers with a free slot.
__device__ __forceinline__ int score(int active, int hot, int cores,
                                     int slots, bool low_load) {
  if (low_load) {
    const int cls = active > 0 ? 2 + hot : hot;
    return active < cores ? cls * (slots + 1) + active : -kBig;
  }
  return active < slots ? -(2 * active - hot) : -kBig;
}

// (score desc, index asc) as one signed key to maximise.  The low word
// 0x7fffffff - w lies in [0, 2^31), so it never borrows from the score.
__device__ __forceinline__ long long pack_key(int score, int w) {
  return static_cast<long long>(score) * 4294967296LL +
         static_cast<long long>(0x7fffffff - w);
}

__device__ __forceinline__ int key_index(long long key) {
  return 0x7fffffff - static_cast<int>(key & 0xffffffffLL);
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, v, offset);
    v = other > v ? other : v;
  }
  return v;
}

// The largest `v` over the block, returned to every thread: warp
// shuffles, one shared-memory pass (`scratch`, 32 entries), then every
// warp reduces the warps' maxima itself.  The caller passes a barrier
// before it writes `scratch` again.
__device__ __forceinline__ long long block_max(long long v,
                                               long long* scratch) {
  const int lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane]
                                                           : LLONG_MIN);
}

}  // namespace hermes
