// Hermes hybrid dispatch (paper §4.2) as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/hermes_select/kernel.py
// (`_kernel`, launched by `hermes_select_batch`): sequential dispatch of N
// arrivals over one per-worker load vector, here batched over R
// replications.  For each arrival, per replication:
//   1. has_core = active < cores, has_slot = active < slots;
//   2. if any worker has a free core, score = cls*(slots+1) + active on the
//      workers with a free core, where cls = (active > 0 ? 2 : 0) + warm;
//   3. otherwise score = -(2*active - warm) on the workers with a free slot;
//   4. w = the LOWEST-index argmax; the choice is -1 if no worker has a free
//      slot, and active[w] += 1 otherwise.
//
// What bounds it on this card: launch latency, not bytes or operations.
// Where the simulator calls it per arrival (E/H/FCFS, E/H/SRPT; E/H/PS
// runs its choice inside sim_engine.cu) and in serving, N = 1, so one
// launch reads R*W active
// counts and R*W warm counts and writes R*(W+1) ints: a few KB, which the
// card's 3.35 TB/s moves in a few nanoseconds, while a launch costs
// microseconds.  The design keeps the launch small and never goes back
// to device memory inside the arrival loop:
//   * one block per replication; that replication's `active` vector lives
//     in shared memory for all N arrivals (the TPU kernel kept it in VMEM);
//   * each thread scores a strided subset of the W workers, so warm_cols
//     is read coalesced;
//   * the two "any worker" tests are __syncthreads_or;
//   * the argmax packs (score, -index) into one 64-bit key, so a max
//     reduction (warp shuffles, then one shared-memory pass) returns the
//     lowest index among equal scores, as jnp.argmax does; the score and
//     the reduction live in hermes_score.cuh, which sim_engine.cu's
//     in-loop choice shares;
//   * one thread applies the increment; a barrier publishes it.
// Upper bound: W <= 12288 workers (48 KB of shared memory per block).
// The wrapper (repro_torch/kernels/hermes_select/kernel.py) checks it.

#include <cuda_runtime.h>
#include <climits>

#include "hermes_score.cuh"

namespace {

constexpr int kMaxWorkers = 12288;
constexpr int kMaxThreads = 1024;

__global__ void hermes_select_kernel(const int* __restrict__ active,
                                     const int* __restrict__ warm_cols,
                                     int* __restrict__ choices,
                                     int* __restrict__ active_out,
                                     int n, int n_workers, int cores,
                                     int slots) {
  extern __shared__ int load[];            // [W] this replication's loads
  __shared__ long long warp_best[32];
  const int r = blockIdx.x;
  const int t = threadIdx.x;

  const int* active_r = active + static_cast<size_t>(r) * n_workers;
  for (int w = t; w < n_workers; w += blockDim.x) load[w] = active_r[w];
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int* warm =
        warm_cols + (static_cast<size_t>(r) * n + i) * n_workers;
    int core_free = 0;
    int slot_free = 0;
    for (int w = t; w < n_workers; w += blockDim.x) {
      const int a = load[w];
      core_free |= a < cores;
      slot_free |= a < slots;
    }
    const int low_load = __syncthreads_or(core_free);
    const int any_slot = __syncthreads_or(slot_free);

    long long best = LLONG_MIN;
    for (int w = t; w < n_workers; w += blockDim.x) {
      const long long key = hermes::pack_key(
          hermes::score(load[w], warm[w] > 0, cores, slots, low_load), w);
      best = key > best ? key : best;
    }
    best = hermes::block_max(best, warp_best);
    if (t == 0) {
      const int w = hermes::key_index(best);
      choices[static_cast<size_t>(r) * n + i] = any_slot ? w : -1;
      if (any_slot) load[w] += 1;
    }
    __syncthreads();  // publish load[w]; warp_best is free for reuse
  }

  int* out_r = active_out + static_cast<size_t>(r) * n_workers;
  for (int w = t; w < n_workers; w += blockDim.x) out_r[w] = load[w];
}

}  // namespace

// active [R, W] i32, warm_cols [R, N, W] i32 -> choices [R, N] i32,
// active_out [R, W] i32; all contiguous on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int hermes_select_launch(const int* active, const int* warm_cols,
                                    int* choices, int* active_out,
                                    int n_reps, int n, int n_workers,
                                    int cores, int slots, void* stream) {
  if (n_reps < 1 || n < 0 || n_workers < 1 || n_workers > kMaxWorkers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = ((n_workers + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(n_workers) * sizeof(int);
  hermes_select_kernel<<<n_reps, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      active, warm_cols, choices, active_out, n, n_workers, cores, slots);
  return static_cast<int>(cudaGetLastError());
}
