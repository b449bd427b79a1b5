// The policy simulator's early-binding event loop with processor sharing
// (E/<B>/PS for the nine balancers H, LL, LOC, R, JSQ2, RR, HIKU, DD and
// SWARM) as one CUDA kernel for Hopper (sm_90a): one launch runs a whole
// `simulate_many`.
//
// Redesigns the Pallas TPU kernel repro/kernels/hermes_select/kernel.py
// (`hermes_select_batch`) for this card.  On the TPU that kernel makes the
// Hermes choice inside the reference engine's compiled lax.scan over
// arrivals (repro/core/simulator.py: `advance`, `early_arrival`); the
// port's first slice launched it once per arrival from a Python loop that
// issued ~300 small launches and one host read per loop iteration around
// it.  Here the choice (hermes_score.cuh, shared with hermes_select.cu)
// sits where the TPU had it: inside a single device program that runs the
// whole loop.  It computes exactly what the port's batched engine
// (repro_torch/core/simulator.py, backend="torch") computes, plane for
// plane: per replication and per arrival,
//   1. advance to the arrival: while any slot is active and time is left
//      (or a task within EPS of done is pending), rate every active slot
//      at min(1, C / n_w), take the earliest finisher (lowest flat index
//      w*S + s on ties), move time by tau, integrate server and core
//      occupancy, subtract rate*tau from every active slot, and complete
//      the argmin slot (its response, one warm executor more);
//   2. choose a worker (-1 = rejected) and place: first empty slot, cold
//      unless a warm executor is idle (which it takes), the first-index
//      fullest warm pool evicted when a cold start finds active + idle >=
//      S, the cold-start penalty added to the service;
// then one final drain with a horizon of 1e18 s.
//
// The policy zoo (repro/policy/balancers.py, plain jnp there) chooses
// here too.  JSQ2 and RR are stateless.  HIKU (a ready-ring of idle
// workers), DD (per-function EMAs of the service, expected work per
// worker) and SWARM (median trackers of function scale and worker
// slowness) carry state, in [R, W] and [R, F] tensors the wrapper
// allocates and initialises (HIKU's head and tail in shared memory): the
// choice reads it; after the choice's barrier one thread makes the
// choice's writes (HIKU's pop, even of a slot-full candidate; DD's charge
// of the estimate; none for a rejection); each completion applies the
// balancer's on_complete with the task's nominal service and the
// worker's active count after it, by the thread that completes it.
//
// Bit-equal f64: nvcc contracts a - b*c into an FMA, torch does not, so
// every product that feeds a sum goes through __dmul_rn / __dadd_rn /
// __dsub_rn in the torch engine's order of operations.  The PS rates
// min(1, C / max(n, 1)) are the same divisions, made once into a table;
// t = rem / rate is skipped where rate is 1.0 (x / 1.0 == x exactly).
//
// What bounds it on this card: latency, not bytes or operations.  An
// advance iteration reads the occupied part of one replication's slot
// matrix and the next iteration depends on its result, so a replication
// is a chain of dependent block-wide steps; replications are independent.
// The design keeps that chain short:
//   * one block per replication, so there is no lockstep masking (the
//     batched engine's torch.where merge, scratch index N and pad column F
//     have no counterpart) and no host round trip inside the loop;
//   * the replication's state (remaining, arrival time and task of every
//     slot, the warm pools) lives in the global tensors the wrapper
//     allocates, where each block's ~200 KB stays in L1 and L2 (keeping
//     it in shared memory, which only clusters up to ~100 workers of 96
//     slots fit, was measured a few percent faster, not enough for a
//     second layout); per-worker counts n_w and high-water marks hw_w
//     (slots s >= hw_w were never occupied) are in shared memory, so a
//     scan reads only s < hw_w of the workers with n_w > 0;
//   * worker w belongs to warp w % n_warps: that warp alone reads and
//     writes w's slots, count and warm pool in the loop, and completes
//     and places w's tasks, so the only block barriers are one per advance
//     iteration (the argmin reduction: warp shuffles, then every warp
//     reduces the warps' partials from a double-buffered shared array)
//     and one per arrival (between the choice and the placement);
//   * an iteration's subtraction of rate*tau is made by the next
//     iteration's scan, which reads those slots anyway;
//   * every warp makes the arrival's choice itself from the shared
//     counts (the packed first-index argmax of hermes_score.cuh, or the
//     first free worker on the ring, or the target rank among the free
//     workers, or a (key, index) shuffle argmin of DD's or SWARM's f64
//     key), with counts of the workers that have a free core and a free
//     slot kept up to date by whoever changes n_w;
//   * the next arrival's inputs are loaded while this one is processed.
// A block has one warp per worker, up to 512 threads.  Upper bounds:
// W <= 4096 workers and S <= 2047 slots (48 KB of shared memory).  The
// wrapper (repro_torch/kernels/sim_engine/kernel.py) checks them.
//
// The container lifecycle (repro/lifecycle, the reference engine's `life`
// plane) is a second template argument.  Off, the kernel is the one
// above.  On, every replication carries idle_since [W, F] (the time of a
// pool's latest completion, -1 before the first) and the keep-alive
// windows pre, keep [F] in global tensors the wrapper allocates (the
// windows initialised from the keep-alive policy).  A pool is
// materialized at `now` iff pre[f] <= now - idle_since <= pre[f] +
// keep[f]; only materialized pools are warm, take memory and can be
// evicted:
//   * the choice (Hermes' warm bit) reads the materialized count;
//   * a placement, by the worker's warp, sums the materialized pools,
//     takes the LRU one (a (idle_since, index) argmin over count > 0) as
//     the slot-pressure victim and charges the preset's cost[f] (or the
//     scalar penalty) for a cold start; under HYBRID_HIST it then adds the
//     placed pool's idle gap to function f's 32-bin histogram and
//     recomputes f's windows alone: a 32-lane prefix sum of the counts
//     (integers in f64: exact) and the first bin at or above each
//     quantile, the same bits as the reference's windows() over all F;
//   * a completion, by the worker's warp, zeroes a stale pool before its
//     increment, refreshes its idle clock and, with a max_idle budget,
//     evicts the worker's LRU materialized executor when it holds more.
// Every sum and product of those windows and ages goes through the
// __d*_rn intrinsics, as above.
//
// The observation plane (the reference engine's `tel` and `fleet` planes:
// repro/telemetry, repro/fleet) is a third template argument.  Off, the
// kernel is the one above.  On, it carries per replication, in global
// tensors the wrapper allocates zeroed (ObsArgs):
//   * the fleet's speeds: every PS rate is min(1, C / n) * speed[w] (1.0
//     without a fleet: exact), and SWARM and DD observe service / speed;
//   * per advance iteration with tau > 0, tau and tau * n_w are added to
//     the busy and depth integrals of each worker that had a task (the
//     batched engine's pre-advance occupancy; a worker without one adds
//     0.0, which changes nothing).  Like the subtraction of rate * tau,
//     this is made by the next iteration's scan, from n_w and the
//     completion it knows of, as atomicAdd reductions that the thread
//     does not wait for; each worker's are made by one thread, so they
//     land in iteration order and the f64 sums are the batched engine's;
//   * per completion of an arrival at or past the warmup cutoff, one count
//     in the slowdown histogram (response / max(service, 1e-12)) and one
//     in the latency histogram.  The bin is the count of edges <= x less
//     one, clamped, over the 1537 edges' bits the host sends (never
//     recomputed here), found by the completing warp in two rounds of
//     ballots (every 48th edge, then the 48 after the last one <= x).
//     The increments are atomicAdd reductions, which the completing
//     thread does not wait for;
//   * the cold, warm, evicted (slot pressure and the max_idle budget) and
//     rejected counters (shared memory), and each worker's placements (a
//     reduction);
//   * TARGET_P99 (a runtime switch inside the plane; the decision is
//     rare): per arrival the provisioned-time integral over the gap at the
//     current n_on; then, when t_i >= cool_until and a completion was
//     recorded since the last snapshot (a running count makes the gate
//     O(1)), warp 0 reads the window slow_hist - snap (48 bins a lane, a
//     shuffle prefix sum), takes the first bin whose cumulative count
//     reaches k = clamp(ceil(0.99 * total), 1, total), p99 =
//     sqrt(edges[b] * edges[b + 1]), grows n_on by max(1, n_on / 2) above
//     the host's band or shrinks it by 1 below, clamps it to [min_workers,
//     W], copies the snapshot and recounts the free workers.  During the
//     choice, workers >= n_on read as slot-full (the reference's mask), so
//     the balancers are untouched; core_free and slot_free count the
//     workers below n_on.
//
// The timeline (the reference engine's `tl` plane, repro/telemetry/
// timeline.py) is the third value of that argument: observation plus
// timeline (54 instantiations; the other two values are the kernels
// above).  Inside it, telemetry's own work (the sketches, the busy and
// depth integrals, the counters, the placements per worker) is made only
// when the run asked for telemetry (TlArgs::tel_on); the speeds and
// TARGET_P99 are as above.  Per replication it keeps, in global tensors
// the wrapper allocates zeroed (TlArgs), K windows of width window_s[r]
// (computed on the host); an event's window is clip(floor(t / w), 0,
// K - 1) by one __ddiv_rn, 0 for a width that is not positive:
//   * per arrival, the provisioned core-seconds over the gap (n_on or W
//     workers, times C) in the gap start's window, by thread 0; after the
//     drain, the tail from the last arrival;
//   * per advance iteration with tau > 0, tau into the window of the
//     interval's start for each worker that had a task, made with the
//     telemetry integrals by the next scan (the thread that owns the
//     worker, in iteration order, so the f64 sums are the batched
//     engine's); the queue length is 0 under early binding;
//   * per completion (every one: no warmup cutoff), one count in each
//     coarse sketch of the completion time's window, the coarse bin being
//     the fine bin of the same edge search integer-divided by kBins / B;
//   * the window counters (arrivals, cold, warm, evicted, rejected) as
//     reductions, and the last n_on an arrival saw;
//   * the bounded decision log, by thread 0: TARGET_P99's decision where
//     it changed n_on, with the p99 warp 0 read off the window
//     (__dsqrt_rn(__dmul_rn(e[b], e[b + 1]))); under H the pack/spread
//     mode, which is the Hermes choice's own low-load read (a worker
//     below n_on with a free core: core_free > 0), where it flipped.
//
// The chunk mode (repro/core/streaming.py's chunked scan) is a runtime
// switch (StreamArgs::chunk) inside the observation plane, which a stream
// always runs; it branches only at the start, at a completion and at a
// placement, so the instantiations stay 54.  A launch runs one chunk of a
// horizon's arrivals, with global indices g0 + i, from the state the last
// chunk left in the same tensors: nothing is initialised; each worker's
// count and high-water mark are recounted from its slots (1 + the highest
// occupied slot: the ones above it are empty, so the scans read the same)
// and the free counts over the carried n_on; the per-thread scalars (now,
// the occupancy integrals, iteration counts, TARGET_P99's n_on, cooldown
// and provisioned time, the log's count and the mode) and the shared
// counters (cold, warm, evicted, rejected, recorded since the snapshot)
// are loaded from the tensors the last chunk wrote them to.  After the
// arrivals the drain runs only when asked for.  No per-arrival plane of
// the horizon exists: a placement writes the occupant's function and
// nominal service into slot mirrors (task_fn, task_svc [W, S]) and a
// completion reads them there (its task may have arrived in an earlier
// chunk) and adds to the exact counters: completions, and over the
// completions past the warmup cutoff their count and the sums of their
// responses and slowdowns, one __dadd_rn each, in completion order.  The
// cold, rejected and worker planes are the chunk's.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

#include "hermes_score.cuh"

namespace {

constexpr double kEps = 1e-9;         // simulator.py's EPS
constexpr double kBigTime = 1e18;     // the final drain's horizon
constexpr int kMaxWorkers = 4096;
constexpr int kMaxSlots = 2047;
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

enum Balancer {
  kHermes = 0,
  kLeastLoaded = 1,
  kLocality = 2,
  kRandom = 3,
  kJsq2 = 4,
  kRoundRobin = 5,
  kHiku = 6,
  kDataDriven = 7,
  kSwarm = 8,
};

// repro/policy/balancers.py's DD_ALPHA and SWARM's steps (1 ± α, and the
// f64 value of 1 / (1 + α) as Python computes it)
constexpr double kDdAlpha = 0.25;
constexpr double kSwEstUp = 1.0 + 0.25;
constexpr double kSwEstDn = 1.0 / (1.0 + 0.25);
constexpr double kSwHotUp = 1.0 + 0.125;
constexpr double kSwHotDn = 1.0 / (1.0 + 0.125);
constexpr double kSwColdUp = 1.0 + 0.0078125;
constexpr double kSwColdDn = 1.0 / (1.0 + 0.0078125);
constexpr long long kSwarmWarmN = 128;

// A replication's carried balancer state (null where the balancer has
// none): HIKU's ring and membership flags [W]; DD's and SWARM's
// per-function estimates [F]; DD's expected work or SWARM's slowness per
// worker [W]; SWARM's completions per worker [W].
struct LbState {
  int* ring;
  int* in_ring;
  double* est;
  double* per_worker;
  long long* cnt;
};

// One advance iteration's block-wide reduction: the earliest finisher
// (t, flat index; lowest index on ties), whether a task is pending, and
// the occupancy counts (active tasks, busy workers, busy cores).
struct Scan {
  double t;
  int j;
  int pending;
  int total;
  int busy;
  int cores;
};

__device__ __forceinline__ Scan warp_reduce(Scan a) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const double t = __shfl_xor_sync(kFull, a.t, offset);
    const int j = __shfl_xor_sync(kFull, a.j, offset);
    if (t < a.t || (t == a.t && j < a.j)) {
      a.t = t;
      a.j = j;
    }
    a.total += __shfl_xor_sync(kFull, a.total, offset);
    a.busy += __shfl_xor_sync(kFull, a.busy, offset);
    a.cores += __shfl_xor_sync(kFull, a.cores, offset);
  }
  a.pending = __any_sync(kFull, a.pending);
  return a;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFull, v, offset);
  }
  return v;
}

// The lifecycle state of one replication (unused when the lifecycle is
// off): idle_since [W, F]; the windows pre, keep [F]; the preset's costs
// [F] (null: the scalar penalty); HYBRID_HIST's histograms [F, 32] and
// observation counts [F] (null for the other keep-alives).
struct LifeState {
  double* idle;
  double* pre;
  double* keep;
  const double* costs;
  double* hist;
  double* n_obs;
  int max_idle;
  double bin_s;
  double ttl;
};

// The observation plane's arguments (base pointers of [R, ...] tensors,
// zeroed by the wrapper, n_on at W) and scalars: the speeds [W] f64, the
// sketch's edges [kBins + 1] f64, the histograms [R, kBins] i64, the
// counters [R, 4] i64 (cold, warm, evicted, rejected), the busy and depth
// integrals [R, W] f64, the placements [R, W] i64, the busy workers
// summed over the iterations with tau > 0 [R] i64 (the integrals' updates:
// what the bound counts); TARGET_P99's n_on [R]
// i32, cool_until and prov_time [R] f64 and snapshot [R, kBins] i64; the
// warmup cutoff, whether TARGET_P99 runs, its floor, band and cooldown.
struct ObsArgs {
  const double* speed;
  const double* edges;
  long long* slow_hist;
  long long* lat_hist;
  long long* counters;
  double* busy;
  double* depth;
  long long* decisions;
  long long* busy_iters;
  int* n_on;
  double* cool_until;
  double* prov_time;
  long long* snap;
  long long cutoff;
  int auto_on;
  int min_workers;
  double hi;
  double lo;
  double cooldown;
};

constexpr int kBins = 1536;   // repro/telemetry/sketch.py's N_BINS
enum Counter { kCold = 0, kWarm = 1, kEvicted = 2, kRejected = 3 };

// The timeline plane's arguments (base pointers of [R, ...] tensors,
// zeroed by the wrapper, ev_p99 at NaN, mode at 1): each replication's
// window width [R] f64; the window counters [R, 5, K] i64 (arrivals, cold,
// warm, evicted, rejected); the coarse sketches [R, K, B] i64; the busy
// integrals [R, K, W] f64; the provisioned core-seconds [R, K] f64; the
// last n_on [R, K] i32; the decision log [R, E] (time f64, kind i32,
// value i32, sensor p99 f64) and its count [R] i64; the final mode [R]
// i32; K, B, E, kBins / B, and whether telemetry was asked for.
struct TlArgs {
  const double* window_s;
  long long* counts;
  long long* slow_hist;
  long long* lat_hist;
  double* busy;
  double* prov;
  int* n_on;
  double* ev_t;
  int* ev_kind;
  int* ev_val;
  double* ev_p99;
  long long* ev_count;
  int* mode;
  int n_windows;
  int coarse_bins;
  int max_events;
  int group;
  int tel_on;
};
enum TlCounter { kTlArrivals = 0, kTlCold = 1, kTlWarm = 2, kTlEvicted = 3,
                 kTlRejected = 4 };

// A stream's chunk mode (chunk = 0: the whole horizon in one launch):
// the chunk's global offset g0, whether the drain follows its arrivals,
// the slot mirrors task_fn [R, W, S] i32 and task_svc [R, W, S] f64, the
// exact counters [R, 3] i64 (completions, recorded completions, and
// TARGET_P99's count recorded since the snapshot) and sums [R, 2] f64
// (responses and slowdowns of the recorded completions).
struct StreamArgs {
  int chunk;
  int drain;
  long long g0;
  int* task_fn;
  double* task_svc;
  long long* counts;
  double* sums;
};

// The window of time t: clip(floor(t / w), 0, K - 1), 0 if w <= 0 (the
// numpy side's math.floor and clip; the clip is made on the double).
__device__ __forceinline__ int window_of(double t, double w, int K) {
  if (!(w > 0.0)) return 0;
  double q = floor(__ddiv_rn(t, w));
  q = q < 0.0 ? 0.0 : q;
  q = q > static_cast<double>(K - 1) ? static_cast<double>(K - 1) : q;
  return static_cast<int>(q);
}

// One count more in the timeline's window counter `c` of window k.
__device__ __forceinline__ void tl_count(long long* counts, int K, int c,
                                         int k) {
  atomicAdd(reinterpret_cast<unsigned long long*>(counts) +
                static_cast<size_t>(c) * K + k,
            1ULL);
}

// The sketch's bin of x, by one warp: the count of the kBins + 1 sorted
// edges <= x (torch.searchsorted, right=True) less one, clamped to
// [0, kBins - 1].  The first ballot counts the edges 48 * lane <= x (a
// prefix of the lanes), the second the 48 edges after the last of them.
__device__ __forceinline__ int sketch_bin(const double* edges, double x,
                                          int lane) {
  constexpr int kStep = kBins / 32;   // 48
  const int s = __popc(__ballot_sync(kFull, edges[kStep * lane] <= x));
  if (s == 0) return 0;
  const int base = kStep * (s - 1);   // edges[base] <= x
  const bool lo = edges[base + 1 + lane] <= x;
  const bool hi = lane < kStep - 32 && edges[base + 33 + lane] <= x;
  const int b = base + __popc(__ballot_sync(kFull, lo)) +
                __popc(__ballot_sync(kFull, hi));
  return b > kBins - 1 ? kBins - 1 : b;
}

// TARGET_P99's decision, by one warp, on the window slow_hist - snap (a
// completion recorded in it), then the snapshot's copy: the new n_on
// (repro/fleet/policies.py, the sketch_percentile op sequence).  The
// histogram, which atomics update in L2, is read past L1 (__ldcg).
__device__ __forceinline__ int target_p99(const ObsArgs& obs,
                                          long long* slow_hist,
                                          long long* snap, int n_on, int W,
                                          int lane, double* p99_out) {
  constexpr int kPer = kBins / 32;
  const int b0 = lane * kPer;
  long long part = 0;
  for (int q = 0; q < kPer; ++q) {
    part += __ldcg(slow_hist + b0 + q) - snap[b0 + q];
  }
  long long incl = part;
  for (int offset = 1; offset < 32; offset <<= 1) {
    const long long below = __shfl_up_sync(kFull, incl, offset);
    if (lane >= offset) incl += below;
  }
  const long long total = __shfl_sync(kFull, incl, 31);
  long long k = static_cast<long long>(
      ceil(__dmul_rn(0.99, static_cast<double>(total))));
  k = k < 1 ? 1 : k;
  k = k > total ? total : k;
  const long long excl = incl - part;
  const int src = __ffs(__ballot_sync(kFull, excl < k && k <= incl)) - 1;
  int b = 0;
  if (lane == src) {
    long long c = excl;
    for (int q = 0; q < kPer; ++q) {
      c += __ldcg(slow_hist + b0 + q) - snap[b0 + q];
      if (c >= k) {
        b = b0 + q;
        break;
      }
    }
  }
  b = __shfl_sync(kFull, b, src);
  for (int q = 0; q < kPer; ++q) snap[b0 + q] = __ldcg(slow_hist + b0 + q);
  const double p99 = __dsqrt_rn(__dmul_rn(obs.edges[b], obs.edges[b + 1]));
  *p99_out = p99;
  int n = n_on;
  if (p99 > obs.hi) {
    n += n_on / 2 > 1 ? n_on / 2 : 1;
  } else if (p99 < obs.lo) {
    n -= 1;
  }
  n = n < obs.min_workers ? obs.min_workers : n;
  return n > W ? W : n;
}

// HYBRID_HIST's shape and quantiles (repro/lifecycle/policies.py)
constexpr int kHistBins = 32;
constexpr double kHistHeadQ = 0.05;
constexpr double kHistTailQ = 0.99;
constexpr double kHistMargin = 0.15;
constexpr double kHistMinObs = 3.0;

// Whether a pool idle since `idle` is materialized at `now` under the
// window [pre, end = pre + keep].
__device__ __forceinline__ bool materialized(double now, double idle,
                                             double pre, double end) {
  const double age = __dsub_rn(now, idle);
  return age >= pre && age <= end;
}

// The worker's materialized executors and its LRU materialized pool (the
// first index among the oldest idle_since; 0 if it has none, as torch's
// argmin of all-inf), over the worker's warp.
__device__ __forceinline__ void lru_pool(const LifeState& life,
                                         const int* warm_w,
                                         const double* idle_w, int F,
                                         double now, int lane, int* n_idle,
                                         int* victim) {
  int count = 0;
  double best = INFINITY;
  int best_g = INT_MAX;
  for (int g = lane; g < F; g += 32) {
    const double since = idle_w[g];
    const int c = materialized(now, since, life.pre[g],
                               __dadd_rn(life.pre[g], life.keep[g]))
                      ? warm_w[g]
                      : 0;
    count += c;
    if (c > 0 && since < best) {   // a lane meets its pools in order
      best = since;
      best_g = g;
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const double other = __shfl_xor_sync(kFull, best, offset);
    const int other_g = __shfl_xor_sync(kFull, best_g, offset);
    if (other < best || (other == best && other_g < best_g)) {
      best = other;
      best_g = other_g;
    }
    count += __shfl_xor_sync(kFull, count, offset);
  }
  *n_idle = count;
  *victim = best_g == INT_MAX ? 0 : best_g;
}

// HYBRID_HIST's observation of an idle gap of function f, by one warp:
// one count more in its bin and in n_obs[f], then f's windows from its
// histogram (repro/lifecycle/policies.py: windows(), observe()).
__device__ __forceinline__ void hybrid_observe(const LifeState& life, int f,
                                               double gap, int lane) {
  long long bin = static_cast<long long>(__ddiv_rn(gap, life.bin_s));
  bin = bin < kHistBins - 1 ? bin : kHistBins - 1;
  bin = bin > 0 ? bin : 0;
  double* hist_f = life.hist + static_cast<size_t>(f) * kHistBins;
  double count = hist_f[lane];
  if (lane == bin) {
    count = __dadd_rn(count, 1.0);
    hist_f[lane] = count;
  }
  const double n = __dadd_rn(life.n_obs[f], 1.0);
  double cdf = count;   // integer-valued: exact in any order
  for (int offset = 1; offset < 32; offset <<= 1) {
    const double below = __shfl_up_sync(kFull, cdf, offset);
    if (lane >= offset) cdf = __dadd_rn(cdf, below);
  }
  const int head =
      __ffs(__ballot_sync(kFull, cdf >= __dmul_rn(kHistHeadQ, n))) - 1;
  const int tail =
      __ffs(__ballot_sync(kFull, cdf >= __dmul_rn(kHistTailQ, n))) - 1;
  if (lane == 0) {
    life.n_obs[f] = n;
    if (n >= kHistMinObs) {
      const double pre = __dmul_rn(
          __dmul_rn(static_cast<double>(head), life.bin_s),
          1.0 - kHistMargin);
      const double end = __dmul_rn(
          __dmul_rn(__dadd_rn(static_cast<double>(tail), 1.0), life.bin_s),
          1.0 + kHistMargin);
      life.pre[f] = pre;
      life.keep[f] = __dsub_rn(end, pre);
    } else {
      life.pre[f] = 0.0;
      life.keep[f] = life.ttl;
    }
  }
}

// The worker the balancer picks for an arrival of function f, or -1 if
// every worker is slot-full; made by each warp on its own.  `h` is the
// ring's start (LOC: the function's home; RR: the arrival's index mod W);
// `head`, `tail` are HIKU's ring counters.  Under the lifecycle, a warm
// executor counts only if its pool is materialized at `now`; under the
// observation plane, a worker >= n_on reads as slot-full.  Writes
// nothing.
template <bool life_on, bool obs_on>
__device__ __forceinline__ int choose(int balancer, const int* n_act_s,
                                      const int* warm, int W, int F, int f,
                                      int cores, int S, int core_free,
                                      int slot_free, int h, double u,
                                      const LbState& lb, int head, int tail,
                                      const LifeState& life, double now,
                                      int n_on, int lane) {
  const auto n_act = [=](int w) {
    return obs_on && w >= n_on ? S : n_act_s[w];
  };
  if (slot_free == 0) return -1;
  if (balancer == kLocality || balancer == kRoundRobin) {
    // the first worker with a free slot on the ring from h
    for (int k0 = 0; k0 < W; k0 += 32) {
      int w = h + k0 + lane;
      w = w >= W ? w - W : w;
      const unsigned free =
          __ballot_sync(kFull, k0 + lane < W && n_act(w) < S);
      if (free) return __shfl_sync(kFull, w, __ffs(free) - 1);
    }
    return -1;
  }
  if (balancer == kRandom) {
    // the min(int(u*k), k-1)-th of the k workers with a free slot
    const int pick = static_cast<int>(
        __dmul_rn(u, static_cast<double>(slot_free)));
    const int target = pick < slot_free - 1 ? pick : slot_free - 1;
    int base = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      const bool has = w < W && n_act(w) < S;
      const unsigned free = __ballot_sync(kFull, has);
      const int rank = base + __popc(free & ((1u << lane) - 1u));
      const unsigned hit = __ballot_sync(kFull, has && rank == target);
      if (hit) return w0 + __ffs(hit) - 1;
      base += __popc(free);
    }
    return -1;
  }
  if (balancer == kJsq2) {
    // two indices from one uniform, in the reference's f64 order; the
    // shorter queue (b only if strictly shorter), else least loaded below
    const double x = __dmul_rn(u, static_cast<double>(W));
    const int a = min(static_cast<int>(x), W - 1);
    const int b = min(static_cast<int>(__dmul_rn(__dsub_rn(x, floor(x)),
                                                 static_cast<double>(W))),
                      W - 1);
    const int key_a = n_act(a) < S ? n_act(a) : hermes::kBig;
    const int key_b = n_act(b) < S ? n_act(b) : hermes::kBig;
    const int w = key_b < key_a ? b : a;
    if (n_act(w) < S) return w;
  } else if (balancer == kHiku) {
    // the ring's oldest idle worker, else least loaded below
    if (tail > head) {
      const int cand = lb.ring[head % W];
      if (n_act(cand) < S) return cand;
    }
  } else if (balancer == kDataDriven || balancer == kSwarm) {
    // first-index argmin of an f64 key over the workers with a free slot:
    // DD's expected work; SWARM's slowness, times queue depth + 1 at
    // core saturation
    double best = INFINITY;
    int best_w = INT_MAX;
    for (int w = lane; w < W; w += 32) {
      const int nw = n_act(w);
      if (nw >= S) continue;
      const double v = lb.per_worker[w];
      const double key =
          balancer == kDataDriven || nw + 1 <= cores
              ? v
              : __dmul_rn(__dadd_rn(static_cast<double>(nw), 1.0), v);
      if (key < best) {   // a lane meets its workers in order
        best = key;
        best_w = w;
      }
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      const double other = __shfl_xor_sync(kFull, best, offset);
      const int other_w = __shfl_xor_sync(kFull, best_w, offset);
      if (other < best || (other == best && other_w < best_w)) {
        best = other;
        best_w = other_w;
      }
    }
    return best_w;
  }
  // H's score, or least loaded (LL, and JSQ2's and HIKU's fallback)
  double pre_f = 0.0, end_f = 0.0;
  if (life_on && balancer == kHermes) {
    pre_f = life.pre[f];
    end_f = __dadd_rn(pre_f, life.keep[f]);
  }
  long long best = LLONG_MIN;
  for (int w = lane; w < W; w += 32) {
    const int nw = n_act(w);
    if (nw >= S) continue;
    const size_t at = static_cast<size_t>(w) * F + f;
    const int score =
        balancer == kHermes
            ? hermes::score(nw,
                            warm[at] > 0 &&
                                (!life_on ||
                                 materialized(now, life.idle[at], pre_f,
                                              end_f)),
                            cores, S, core_free > 0)
            : -nw;
    const long long key = hermes::pack_key(score, w);
    best = key > best ? key : best;
  }
  return hermes::key_index(hermes::warp_max(best));
}

// A carried-state balancer's update for a completion on worker w of a
// task of function f with nominal service svc, w left with n_after
// active tasks (repro/policy/balancers.py's on_complete, same order).
__device__ __forceinline__ void on_complete(int balancer, const LbState& lb,
                                            int* tail, int W, int w, int f,
                                            double svc, int n_after) {
  if (balancer == kHiku) {
    // an idle worker advertises itself once
    if (n_after == 0 && lb.in_ring[w] == 0) {
      lb.ring[*tail % W] = w;
      lb.in_ring[w] = 1;
      *tail += 1;
    }
  } else if (balancer == kDataDriven) {
    const double est_f = lb.est[f];   // read before its update
    const double left = __dsub_rn(lb.per_worker[w], est_f);
    lb.per_worker[w] = left > 0.0 ? left : 0.0;
    lb.est[f] = __dadd_rn(est_f, __dmul_rn(kDdAlpha, __dsub_rn(svc, est_f)));
  } else if (balancer == kSwarm) {
    const double est_f = lb.est[f];
    const double inv_w = lb.per_worker[w];
    const double sample = __ddiv_rn(svc, est_f);
    lb.est[f] = __dmul_rn(est_f, svc > est_f ? kSwEstUp : kSwEstDn);
    const bool hot = lb.cnt[w] < kSwarmWarmN;
    lb.per_worker[w] = __dmul_rn(
        inv_w, sample > inv_w ? (hot ? kSwHotUp : kSwColdUp)
                              : (hot ? kSwHotDn : kSwColdDn));
    lb.cnt[w] += 1;
  }
}

// One instantiation per balancer, lifecycle switch and observation mode
// (0 off, 1 observation, 2 observation and timeline): the choice and the
// state updates of the others compile away.  The source is compiled once
// for each lifecycle switch and mode (SIM_ENGINE_LIFE, SIM_ENGINE_OBS),
// six libraries of nine instantiations each, side by side.
template <int balancer, bool life_on, int obs_mode>
__global__ void __launch_bounds__(kMaxThreads, 1) sim_engine_kernel(
    const double* __restrict__ arrival, const int* __restrict__ func,
    const double* __restrict__ service, const double* __restrict__ u_lb,
    const int* __restrict__ home, double* __restrict__ remaining,
    double* __restrict__ task_arr, int* __restrict__ task_idx,
    int* __restrict__ warm, double* __restrict__ resp,
    unsigned char* __restrict__ cold, unsigned char* __restrict__ rejected,
    int* __restrict__ worker_of, double* __restrict__ server_time_out,
    double* __restrict__ core_time_out, double* __restrict__ now_out,
    long long* __restrict__ iters_out, long long* __restrict__ active_out,
    int* __restrict__ lb_ring, int* __restrict__ lb_in_ring,
    int* __restrict__ lb_head, int* __restrict__ lb_tail,
    double* __restrict__ lb_est, double* __restrict__ lb_per_worker,
    long long* __restrict__ lb_cnt, double* __restrict__ life_idle,
    double* __restrict__ life_pre, double* __restrict__ life_keep,
    const double* __restrict__ life_costs, double* __restrict__ life_hist,
    double* __restrict__ life_n_obs, int max_idle, double bin_s, double ttl,
    ObsArgs obs, TlArgs tla, int n, int n_functions, int n_workers,
    int cores, int slots, double penalty, StreamArgs sa) {
  constexpr bool obs_on = obs_mode >= 1;
  constexpr bool tl_on = obs_mode == 2;
  // the chunk mode of a stream (a runtime switch; only under the
  // observation plane, which a stream always runs)
  const bool chunked = obs_on && sa.chunk;
  extern __shared__ double shared[];
  __shared__ double red_t[2][32];
  __shared__ int red_j[2][32];
  __shared__ int red_pending[2][32];
  __shared__ int red_total[2][32];
  __shared__ int red_busy[2][32];
  __shared__ int red_cores[2][32];
  __shared__ int core_free;   // workers with n_w < C
  __shared__ int slot_free;   // workers with n_w < S
  __shared__ int ring_head;   // HIKU's ring counters
  __shared__ int ring_tail;
  __shared__ int on_count;              // TARGET_P99's n_on (else W)
  __shared__ long long rec_since;       // recorded since the snapshot
  __shared__ long long obs_count[4];    // Counter
  __shared__ long long s_done, s_rec;   // the stream's exact counters
  __shared__ double s_resp, s_slow;

  const int W = n_workers, S = slots, F = n_functions;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;

  // this replication's rows, and where its state lives
  const size_t WS = static_cast<size_t>(W) * S;
  const size_t WF = static_cast<size_t>(W) * F;
  arrival += static_cast<size_t>(r) * n;
  func += static_cast<size_t>(r) * n;
  service += static_cast<size_t>(r) * n;
  u_lb += static_cast<size_t>(r) * n;
  home += static_cast<size_t>(r) * F;
  if (!chunked) resp += static_cast<size_t>(r) * n;   // none in a chunk
  cold += static_cast<size_t>(r) * n;
  rejected += static_cast<size_t>(r) * n;
  worker_of += static_cast<size_t>(r) * n;
  double* rems = remaining + r * WS;                           // [W, S]
  double* arr_at = task_arr + r * WS;                          // [W, S]
  int* tix = task_idx + r * WS;                                // [W, S]
  int* pools = warm + r * WF;                                  // [W, F]
  // a chunk's slot mirrors: the occupant's function and nominal service
  int* tfn = chunked ? sa.task_fn + r * WS : nullptr;          // [W, S]
  double* tsv = chunked ? sa.task_svc + r * WS : nullptr;      // [W, S]
  double* rate_of = shared;                                    // [S + 1]
  int* n_act = reinterpret_cast<int*>(shared + S + 1);         // [W]
  int* hw = n_act + W;   // [W] 1 + the highest slot ever used
  const LbState lb{
      lb_ring ? lb_ring + static_cast<size_t>(r) * W : nullptr,
      lb_in_ring ? lb_in_ring + static_cast<size_t>(r) * W : nullptr,
      lb_est ? lb_est + static_cast<size_t>(r) * F : nullptr,
      lb_per_worker ? lb_per_worker + static_cast<size_t>(r) * W : nullptr,
      lb_cnt ? lb_cnt + static_cast<size_t>(r) * W : nullptr};
  const LifeState life{
      life_on ? life_idle + r * WF : nullptr,
      life_on ? life_pre + static_cast<size_t>(r) * F : nullptr,
      life_on ? life_keep + static_cast<size_t>(r) * F : nullptr,
      life_costs,
      life_hist ? life_hist + static_cast<size_t>(r) * F * kHistBins
                : nullptr,
      life_n_obs ? life_n_obs + static_cast<size_t>(r) * F : nullptr,
      max_idle,
      bin_s,
      ttl};
  // this replication's observation state (unused when obs_on is off)
  const size_t rb = static_cast<size_t>(r) * kBins;
  long long* slow_hist = obs_on ? obs.slow_hist + rb : nullptr;
  long long* lat_hist = obs_on ? obs.lat_hist + rb : nullptr;
  long long* snap = obs_on && obs.auto_on ? obs.snap + rb : nullptr;
  double* busy = obs_on ? obs.busy + static_cast<size_t>(r) * W : nullptr;
  double* depth = obs_on ? obs.depth + static_cast<size_t>(r) * W : nullptr;
  long long* decisions =
      obs_on ? obs.decisions + static_cast<size_t>(r) * W : nullptr;
  // telemetry's own work: always under observation alone, as asked for
  // under the timeline
  const bool tel_work = obs_mode == 1 || (tl_on && tla.tel_on);
  // this replication's timeline (unused when tl_on is off)
  const int K = tla.n_windows;
  const double tl_w = tl_on ? tla.window_s[r] : 0.0;
  const size_t rk = static_cast<size_t>(r) * K;
  long long* tl_counts = tl_on ? tla.counts + rk * 5 : nullptr;
  long long* tl_slow =
      tl_on ? tla.slow_hist + rk * tla.coarse_bins : nullptr;
  long long* tl_lat = tl_on ? tla.lat_hist + rk * tla.coarse_bins : nullptr;
  double* tl_busy = tl_on ? tla.busy + rk * W : nullptr;

  if (!chunked) {
    for (size_t k = t; k < WS; k += blockDim.x) {
      rems[k] = INFINITY;
      arr_at[k] = 0.0;
      tix[k] = -1;
    }
    for (size_t k = t; k < WF; k += blockDim.x) pools[k] = 0;
    if (life_on) {
      for (size_t k = t; k < WF; k += blockDim.x) life.idle[k] = -1.0;
    }
  }
  const double no_response = __longlong_as_double(0x7ff8000000000000LL);
  for (int k = t; k < n; k += blockDim.x) {
    if (!chunked) resp[k] = no_response;   // NaN, as torch.nan
    cold[k] = 0;
    rejected[k] = 0;
    worker_of[k] = -1;
  }
  if (chunked) {
    // resuming: each worker's count and high-water mark from its slots
    // (1 + the highest occupied one: the slots above are empty, so a scan
    // that skips them reads the same)
    for (int w = warp; w < W; w += n_warps) {
      int count = 0, high = 0;
      for (int s = lane; s < S; s += 32) {
        if (tix[static_cast<size_t>(w) * S + s] >= 0) {
          count += 1;
          high = s + 1;
        }
      }
      count = __reduce_add_sync(kFull, count);
      high = __reduce_max_sync(kFull, high);
      if (lane == 0) {
        n_act[w] = count;
        hw[w] = high;
      }
    }
  } else {
    for (int w = t; w < W; w += blockDim.x) {
      n_act[w] = 0;
      hw[w] = 0;
    }
  }
  // PS: each of n active tasks runs at min(1, C / max(n, 1))
  for (int k = t; k <= S; k += blockDim.x) {
    const double rate = static_cast<double>(cores) /
                        static_cast<double>(k > 1 ? k : 1);
    rate_of[k] = rate < 1.0 ? rate : 1.0;
  }
  if (chunked) {
    // the free counts of the workers below the carried n_on
    __syncthreads();
    if (warp == 0) {
      const int n_on0 = obs.auto_on ? obs.n_on[r] : W;
      int cf = 0, sf = 0;
      for (int w = lane; w < n_on0; w += 32) {
        cf += n_act[w] < cores;
        sf += n_act[w] < S;
      }
      cf = warp_sum(cf);
      sf = warp_sum(sf);
      if (lane == 0) {
        core_free = cf;
        slot_free = sf;
        on_count = n_on0;
        rec_since = sa.counts[r * 3 + 2];
        for (int k = 0; k < 4; ++k) obs_count[k] = obs.counters[r * 4 + k];
        s_done = sa.counts[r * 3];
        s_rec = sa.counts[r * 3 + 1];
        s_resp = sa.sums[r * 2];
        s_slow = sa.sums[r * 2 + 1];
      }
    }
  }
  if (t == 0) {
    if (!chunked) {
      core_free = W;
      slot_free = W;
      if (obs_on) {
        on_count = W;
        rec_since = 0;
        for (int k = 0; k < 4; ++k) obs_count[k] = 0;
      }
    }
    if (balancer == kHiku) {
      ring_head = lb_head[r];
      ring_tail = lb_tail[r];
    }
  }
  __syncthreads();

  // every thread carries the same copy of the replication's scalars
  double now = 0.0, server_time = 0.0, core_time = 0.0;
  long long iters = 0;
  long long active_sum = 0;   // active tasks summed over the iterations
  long long busy_iters = 0;   // busy workers summed, iterations with tau > 0
  int parity = 0;
  // The subtraction rate*tau of an iteration is made by the next
  // iteration's scan, which every iteration is followed by (the scan that
  // ends a loop makes the last one): tau_prev and the worker whose task
  // completed (its rate ran with one task more) say what to subtract.
  double tau_prev = 0.0;
  int wj_prev = -1;
  int done_prev = 0;   // meaningful in the warp that owns wj_prev
  // the timeline's scalars: the window of the last iteration's start, the
  // log's count and the mode (thread 0's are the ones written back)
  int k_prev = 0;
  long long ev_count = 0;
  int tl_mode = 1;
  // TARGET_P99's scalars, the same in every thread
  int n_on = W;
  double cool_until = 0.0, prov_time = 0.0, t_last = 0.0;
  if (chunked) {
    // the scalars the last chunk left
    now = now_out[r];
    server_time = server_time_out[r];
    core_time = core_time_out[r];
    iters = iters_out[r];
    active_sum = active_out[r];
    busy_iters = obs.busy_iters[r];
    if (obs.auto_on) {
      n_on = obs.n_on[r];
      cool_until = obs.cool_until[r];
      prov_time = obs.prov_time[r];
    }
    if (tl_on) {
      ev_count = tla.ev_count[r];
      tl_mode = tla.mode[r];
    }
  }
  // a chunk's arrivals have global indices g0 + i; the drain only where
  // asked for
  const long long g0 = chunked ? sa.g0 : 0;
  const int i_end = chunked && !sa.drain ? n - 1 : n;
  // arrival i's inputs, loaded one arrival ahead
  double t_i = n > 0 ? arrival[0] : 0.0;
  int f_i = n > 0 ? func[0] : 0;
  double svc_i = n > 0 ? service[0] : 0.0;
  double u_i = n > 0 ? u_lb[0] : 0.0;

  for (int i = 0; i <= i_end; ++i) {
    // -- advance to arrival i (after the last one: drain) ---------------
    double dt_left = i < n ? __dsub_rn(t_i, now) : kBigTime;
    if (obs_on && (obs.auto_on || tl_on)) {
      // provisioned time over the gap at the current n_on (to the drain's
      // end after the last arrival, from t_last)
      t_last = now;
      if (obs.auto_on && i < n) {
        prov_time = __dadd_rn(
            prov_time,
            __dmul_rn(__dsub_rn(t_i, now), static_cast<double>(n_on)));
      }
    }
    if (tl_on && t == 0 && i < n) {
      // the timeline's provisioned core-seconds over the gap
      double* at = tla.prov + rk + window_of(now, tl_w, K);
      *at = __dadd_rn(*at, __dmul_rn(__dmul_rn(__dsub_rn(t_i, now),
                                               static_cast<double>(n_on)),
                                     static_cast<double>(cores)));
    }
    while (true) {
      Scan a{INFINITY, INT_MAX, 0, 0, 0, 0};
      for (int w = warp; w < W; w += n_warps) {
        const int nw = n_act[w];
        if (obs_on && lane == 0 && tau_prev > 0) {
          // the last iteration's integrals over its n_w (this one's, and
          // the task it completed), as reductions the thread does not wait
          // for; one thread per worker, so they land in iteration order
          const int n_prev = nw + (w == wj_prev ? done_prev : 0);
          if (n_prev > 0) {
            if (tel_work) {
              atomicAdd(busy + w, tau_prev);   // tau * 1.0
              atomicAdd(depth + w,
                        __dmul_rn(tau_prev, static_cast<double>(n_prev)));
            }
            if (tl_on) {
              atomicAdd(tl_busy + static_cast<size_t>(k_prev) * W + w,
                        tau_prev);
            }
          }
        }
        if (nw == 0) continue;
        if (lane == 0) {
          a.total += nw;
          a.busy += 1;
          a.cores += nw < cores ? nw : cores;
        }
        const double speed = obs_on ? obs.speed[w] : 1.0;
        const double rate =
            obs_on ? __dmul_rn(rate_of[nw], speed) : rate_of[nw];
        const double rate_prev = rate_of[nw + (w == wj_prev ? done_prev : 0)];
        const double step = __dmul_rn(
            obs_on ? __dmul_rn(rate_prev, speed) : rate_prev, tau_prev);
        const int lim = hw[w];
        for (int s = lane; s < lim; s += 32) {
          const int flat = w * S + s;
          if (tix[flat] >= 0) {
            double rem = rems[flat];
            if (tau_prev > 0) {
              rem = __dsub_rn(rem, step);
              rems[flat] = rem;
            }
            a.pending |= rem <= kEps;
            const double td = rate == 1.0 ? rem : rem / rate;
            if (td < a.t) {   // a lane meets its slots in flat order
              a.t = td;
              a.j = flat;
            }
          }
        }
      }
      a = warp_reduce(a);
      if (lane == 0) {
        red_t[parity][warp] = a.t;
        red_j[parity][warp] = a.j;
        red_pending[parity][warp] = a.pending;
        red_total[parity][warp] = a.total;
        red_busy[parity][warp] = a.busy;
        red_cores[parity][warp] = a.cores;
      }
      __syncthreads();
      if (lane < n_warps) {
        a = Scan{red_t[parity][lane], red_j[parity][lane],
                 red_pending[parity][lane], red_total[parity][lane],
                 red_busy[parity][lane], red_cores[parity][lane]};
      } else {
        a = Scan{INFINITY, INT_MAX, 0, 0, 0, 0};
      }
      a = warp_reduce(a);
      parity ^= 1;   // the next iteration writes the other buffer
      tau_prev = 0.0;
      if (!(a.total > 0 && (dt_left > 0 || a.pending))) break;
      ++iters;
      active_sum += a.total;

      const double tmin = a.t;
      const int j = a.j == INT_MAX ? 0 : a.j;   // torch's argmin of all-inf
      double tau = dt_left < tmin ? dt_left : tmin;
      if (!(isfinite(tau) && tau > 0)) tau = 0.0;
      server_time = __dadd_rn(server_time,
                              __dmul_rn(tau, static_cast<double>(a.busy)));
      core_time = __dadd_rn(core_time,
                            __dmul_rn(tau, static_cast<double>(a.cores)));
      const double now_next = __dadd_rn(now, tau);
      const int wj = j / S;
      if (obs_on && tau > 0) busy_iters += a.busy;
      if (warp == wj % n_warps) {
        // the argmin slot, by its owner warp: completion reads the
        // remaining work before this iteration's subtraction
        int done = 0;
        int record = 0;   // a completion the sketch records
        double response = 0.0, slow = 0.0;
        if (lane == 0) {
          const int tid = tix[j];
          done = tid >= 0 && (tmin <= dt_left || rems[j] <= kEps);
          if (done) {
            response = __dsub_rn(now_next, arr_at[j]);
            if (!chunked) resp[tid] = response;
            // a chunk reads the slot's mirrors: the task may have arrived
            // in an earlier chunk
            const int f = chunked ? tfn[j] : func[tid];
            if (obs_on && (tl_on || (tel_work && tid >= obs.cutoff))) {
              const double sv = chunked ? tsv[j] : service[tid];
              slow = __ddiv_rn(response, sv > 1e-12 ? sv : 1e-12);
              record = tel_work && tid >= obs.cutoff;
            }
            if (chunked) {
              // the exact counters, one addition per completion in
              // completion order (a chunk's telemetry is always on)
              s_done += 1;
              if (record) {
                s_rec += 1;
                s_resp = __dadd_rn(s_resp, response);
                s_slow = __dadd_rn(s_slow, slow);
              }
            }
            const size_t at = static_cast<size_t>(wj) * F + f;
            if (life_on) {
              // a stale pool restarts from 0; its idle clock restarts now
              if (__dsub_rn(now_next, life.idle[at]) >
                  __dadd_rn(life.pre[f], life.keep[f])) {
                pools[at] = 0;
              }
              life.idle[at] = now_next;
            }
            pools[at] += 1;
            rems[j] = INFINITY;
            tix[j] = -1;
            const int nw = n_act[wj];
            n_act[wj] = nw - 1;
            if (!obs_on || wj < on_count) {   // the free counts: w < n_on
              core_free += nw == cores;
              slot_free += nw == S;
            }
            const double svc_done = chunked ? tsv[j] : service[tid];
            on_complete(balancer, lb, &ring_tail, W, wj, f,
                        obs_on ? __ddiv_rn(svc_done, obs.speed[wj])
                               : svc_done,
                        nw - 1);
          }
        }
        done_prev = __shfl_sync(kFull, done, 0);
        __syncwarp();
        const bool rec = obs_on && __shfl_sync(kFull, record, 0);
        if (rec || (tl_on && done_prev)) {
          const int b_slow =
              sketch_bin(obs.edges, __shfl_sync(kFull, slow, 0), lane);
          const int b_lat =
              sketch_bin(obs.edges, __shfl_sync(kFull, response, 0), lane);
          if (lane == 0) {   // reductions: the thread does not wait
            using u64 = unsigned long long;
            if (rec) {
              atomicAdd(reinterpret_cast<u64*>(slow_hist) + b_slow, 1ULL);
              atomicAdd(reinterpret_cast<u64*>(lat_hist) + b_lat, 1ULL);
              rec_since += 1;
            }
            if (tl_on && done_prev) {
              // every completion, in its time's window, coarse bins
              const size_t kb = static_cast<size_t>(window_of(
                                    now_next, tl_w, K)) * tla.coarse_bins;
              atomicAdd(reinterpret_cast<u64*>(tl_slow) + kb +
                            b_slow / tla.group, 1ULL);
              atomicAdd(reinterpret_cast<u64*>(tl_lat) + kb +
                            b_lat / tla.group, 1ULL);
            }
          }
        }
        if (life_on && life.max_idle > 0 && done_prev) {
          // the max_idle budget: the worker's LRU materialized executor
          // goes when it holds more
          int n_idle, victim;
          lru_pool(life, pools + static_cast<size_t>(wj) * F,
                   life.idle + static_cast<size_t>(wj) * F, F, now_next,
                   lane, &n_idle, &victim);
          if (lane == 0 && n_idle > life.max_idle) {
            pools[static_cast<size_t>(wj) * F + victim] -= 1;
            if (obs_on && tel_work) obs_count[kEvicted] += 1;
            if (tl_on) {
              tl_count(tl_counts, K, kTlEvicted,
                       window_of(now_next, tl_w, K));
            }
          }
          __syncwarp();
        }
      }
      tau_prev = tau;
      wj_prev = wj;
      if (tl_on && tau > 0) k_prev = window_of(now, tl_w, K);
      now = now_next;
      dt_left = __dsub_rn(dt_left, tau);
    }
    if (i == n) {
      if (obs_on && obs.auto_on) {
        // the fleet stays provisioned until the last completion
        prov_time = __dadd_rn(
            prov_time,
            __dmul_rn(__dsub_rn(now, t_last), static_cast<double>(n_on)));
      }
      if (tl_on && t == 0) {
        double* at = tla.prov + rk + window_of(t_last, tl_w, K);
        *at = __dadd_rn(*at, __dmul_rn(__dmul_rn(__dsub_rn(now, t_last),
                                                 static_cast<double>(n_on)),
                                       static_cast<double>(cores)));
      }
      break;
    }

    // -- choose a worker for arrival i (every warp), then place it (the
    //    worker's warp) or reject it --------------------------------------
    now = t_i;
    if (obs_on && obs.auto_on && t_i >= cool_until && rec_since >= 1) {
      // TARGET_P99's decision (the same gate in every thread): warp 0
      // decides, copies the snapshot and recounts the free workers below
      // the new n_on
      if (warp == 0) {
        double p99;
        const int n_new =
            target_p99(obs, slow_hist, snap, n_on, W, lane, &p99);
        if (tl_on && lane == 0 && n_new != n_on) {
          // the decision changed the level: log it with its sensor
          if (ev_count < tla.max_events) {
            const size_t e = static_cast<size_t>(r) * tla.max_events +
                             ev_count;
            tla.ev_t[e] = t_i;
            tla.ev_kind[e] = 0;   // EV_AUTOSCALE
            tla.ev_val[e] = n_new;
            tla.ev_p99[e] = p99;
          }
          ev_count += 1;
        }
        int cf = 0, sf = 0;
        for (int w = lane; w < n_new; w += 32) {
          cf += n_act[w] < cores;
          sf += n_act[w] < S;
        }
        cf = warp_sum(cf);
        sf = warp_sum(sf);
        if (lane == 0) {
          on_count = n_new;
          core_free = cf;
          slot_free = sf;
        }
      }
      __syncthreads();   // every thread read rec_since before it resets
      n_on = on_count;
      cool_until = __dadd_rn(t_i, obs.cooldown);
      if (t == 0) rec_since = 0;
    }
    const int f = f_i;
    const double svc = svc_i;
    const int k_arr = tl_on ? window_of(t_i, tl_w, K) : 0;
    if (tl_on && t == 0) {
      // the arrival, the level it saw and, under H, the pack/spread mode
      // (the choice's own low-load read on the masked loads)
      tl_count(tl_counts, K, kTlArrivals, k_arr);
      tla.n_on[rk + k_arr] = n_on;
      if (balancer == kHermes) {
        const int mode = core_free > 0;
        if (mode != tl_mode) {
          if (ev_count < tla.max_events) {
            const size_t e = static_cast<size_t>(r) * tla.max_events +
                             ev_count;
            tla.ev_t[e] = t_i;
            tla.ev_kind[e] = 1;   // EV_MODE_FLIP
            tla.ev_val[e] = mode;
          }
          ev_count += 1;
          tl_mode = mode;
        }
      }
    }
    const int w_sel = choose<life_on, obs_on>(
        balancer, n_act, pools, W, F, f, cores, S, core_free, slot_free,
        balancer == kLocality     ? home[f]
        : balancer == kRoundRobin ? static_cast<int>((g0 + i) % W)
                                  : 0,
        u_i, lb, ring_head, ring_tail, life, now, n_on, lane);
    if (i + 1 < n) {
      t_i = arrival[i + 1];
      f_i = func[i + 1];
      svc_i = service[i + 1];
      u_i = u_lb[i + 1];
    }
    __syncthreads();   // every warp has chosen before the state changes
    if (t == 0) {
      rejected[i] = w_sel < 0;
      if (obs_on && tel_work && w_sel < 0) obs_count[kRejected] += 1;
      if (tl_on && w_sel < 0) tl_count(tl_counts, K, kTlRejected, k_arr);
      // the choice's own writes to the balancer state
      if (w_sel >= 0 && balancer == kHiku && ring_tail > ring_head) {
        lb.in_ring[lb.ring[ring_head % W]] = 0;
        ring_head += 1;
      } else if (w_sel >= 0 && balancer == kDataDriven) {
        lb.per_worker[w_sel] = __dadd_rn(lb.per_worker[w_sel], lb.est[f]);
      }
    }
    if (w_sel >= 0 && warp == w_sel % n_warps) {
      const int w = w_sel;
      const int* task_w = tix + static_cast<size_t>(w) * S;
      int slot = -1;
      for (int s0 = 0; s0 < S && slot < 0; s0 += 32) {
        const unsigned empty =
            __ballot_sync(kFull, s0 + lane < S && task_w[s0 + lane] < 0);
        if (empty) slot = s0 + __ffs(empty) - 1;
      }
      if (slot < 0) slot = 0;   // torch's argmax of all-false
      int* warm_w = pools + static_cast<size_t>(w) * F;
      int idle = 0;
      int victim_f = 0;
      double since_f = 0.0;
      bool mat_f = true;
      if (life_on) {
        // the worker's materialized pools decide, the LRU one is the
        // victim
        const double* idle_w = life.idle + static_cast<size_t>(w) * F;
        lru_pool(life, warm_w, idle_w, F, now, lane, &idle, &victim_f);
        since_f = idle_w[f];
        mat_f = materialized(now, since_f, life.pre[f],
                             __dadd_rn(life.pre[f], life.keep[f]));
      } else {
        long long victim = LLONG_MIN;
        for (int g = lane; g < F; g += 32) {
          const int c = warm_w[g];
          idle += c;
          const long long key = hermes::pack_key(c, g);
          victim = key > victim ? key : victim;
        }
        idle = warp_sum(idle);
        victim_f = hermes::key_index(hermes::warp_max(victim));
      }
      if (lane == 0) {
        const int active_w = n_act[w];
        const int warm_cnt = warm_w[f];
        const bool is_cold = !mat_f || warm_cnt == 0;
        if (!is_cold) warm_w[f] = warm_cnt - 1;
        if (is_cold && active_w + idle >= S) warm_w[victim_f] -= 1;
        if (obs_on && tel_work) {
          obs_count[is_cold ? kCold : kWarm] += 1;
          obs_count[kEvicted] += is_cold && active_w + idle >= S;
          atomicAdd(reinterpret_cast<unsigned long long*>(decisions) + w,
                    1ULL);
        }
        if (tl_on) {
          tl_count(tl_counts, K, is_cold ? kTlCold : kTlWarm, k_arr);
          if (is_cold && active_w + idle >= S) {
            tl_count(tl_counts, K, kTlEvicted, k_arr);
          }
        }
        const double cost =
            life_on && life.costs != nullptr ? life.costs[f] : penalty;
        const size_t at = static_cast<size_t>(w) * S + slot;
        rems[at] = __dadd_rn(svc, is_cold ? cost : 0.0);
        arr_at[at] = now;
        tix[at] = static_cast<int>(g0 + i);
        if (chunked) {
          tfn[at] = f;
          tsv[at] = svc;
        }
        cold[i] = is_cold;
        worker_of[i] = w;
        n_act[w] = active_w + 1;
        core_free -= active_w == cores - 1;
        slot_free -= active_w == S - 1;
        if (slot + 1 > hw[w]) hw[w] = slot + 1;
      }
      if (life_on && life.hist != nullptr && since_f >= 0.0) {
        // HYBRID_HIST learns from the placed pool's idle gap, after the
        // warm/cold decision; a pool without a completion is no gap
        const double gap = __dsub_rn(now, since_f);
        hybrid_observe(life, f, gap > 0.0 ? gap : 0.0, lane);
      }
      __syncwarp();
    }
    // the next scan's barrier publishes the placement to the other warps
  }
  // a chunk that ends on a placement: its counts reach thread 0
  if (chunked) __syncthreads();

  if (t == 0) {
    server_time_out[r] = server_time;
    core_time_out[r] = core_time;
    now_out[r] = now;
    iters_out[r] = iters;
    active_out[r] = active_sum;
    if (balancer == kHiku) {
      lb_head[r] = ring_head;
      lb_tail[r] = ring_tail;
    }
    if (obs_on) {
      for (int k = 0; k < 4; ++k) obs.counters[r * 4 + k] = obs_count[k];
      obs.busy_iters[r] = busy_iters;
      if (obs.auto_on) {
        obs.n_on[r] = n_on;
        obs.cool_until[r] = cool_until;
        obs.prov_time[r] = prov_time;
      }
    }
    if (tl_on) {
      tla.ev_count[r] = ev_count;
      tla.mode[r] = tl_mode;
    }
    if (chunked) {
      sa.counts[r * 3] = s_done;
      sa.counts[r * 3 + 1] = s_rec;
      sa.counts[r * 3 + 2] = obs.auto_on ? rec_since : 0;
      sa.sums[r * 2] = s_resp;
      sa.sums[r * 2 + 1] = s_slow;
    }
  }
}

size_t shared_bytes(int n_workers, int slots) {
  return (slots + 1) * sizeof(double) +
         2 * static_cast<size_t>(n_workers) * sizeof(int);
}

}  // namespace

// Inputs [R, N] (arrival f64, func i32, service f64, u_lb f64) and
// home [R, F] i32; state remaining/task_arr [R, W, S] f64, task_idx
// [R, W, S] i32, warm [R, W, F] i32; outputs resp [R, N] f64, cold and
// rejected [R, N] u8, worker_of [R, N] i32, server_time/core_time/now
// [R] f64, iters and active [R] i64 (advance iterations, and the active
// tasks summed over them); all contiguous on the device, the kernel
// initialises state and outputs.  The carried balancer state, initialised
// by the caller and updated in place (null where unused): HIKU's ring and
// in_ring [R, W] i32, head and tail [R] i32; DD's and SWARM's est [R, F]
// f64; DD's expected work or SWARM's slowness [R, W] f64; SWARM's cnt
// [R, W] i64.  The lifecycle (on when `life` != 0): idle_since [R, W, F]
// f64 (the kernel initialises it), the windows pre and keep [R, F] f64
// (initialised by the caller, updated in place under HYBRID_HIST), the
// preset's costs [F] f64 (null: `penalty`), HYBRID_HIST's hist [R, F, 32]
// and n_obs [R, F] f64 (initialised by the caller; null for the other
// keep-alives), the max_idle budget (0: none), HYBRID_HIST's bin width and
// fallback window.  The observation plane (on when `obs` != 0; see
// ObsArgs, its tensors zeroed by the caller, n_on at W; the autoscaler's
// pointers null unless `auto_on`): speed, edges, slow_hist, lat_hist,
// counters, busy, depth, decisions, busy_iters, n_on, cool_until,
// prov_time, snap,
// the warmup cutoff, TARGET_P99's switch, floor, band (hi, lo) and
// cooldown.  The timeline (on when `tl` != 0, which needs `obs`; see
// TlArgs, its tensors zeroed by the caller, ev_p99 at NaN, mode at 1):
// window_s, counts, slow_hist, lat_hist, busy, prov, n_on, ev_t, ev_kind,
// ev_val, ev_p99, ev_count, mode, K, B, E, and whether telemetry was asked
// for.  The chunk mode (on when `chunk` != 0, which needs `obs`, and under
// a timeline telemetry; see StreamArgs): `resp` is unused and the state,
// the scalar outputs, the balancer, life, observation and timeline state
// are the carry, read and written in place; `drain` (must be 1 without
// `chunk`), g0, task_fn, task_svc, stream_counts, stream_sums.  Launches
// one block per replication on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int sim_engine_launch(
    const double* arrival, const int* func, const double* service,
    const double* u_lb, const int* home, double* remaining, double* task_arr,
    int* task_idx, int* warm, double* resp, unsigned char* cold,
    unsigned char* rejected, int* worker_of, double* server_time,
    double* core_time, double* now, long long* iters, long long* active,
    int* lb_ring, int* lb_in_ring, int* lb_head, int* lb_tail, double* lb_est,
    double* lb_per_worker, long long* lb_cnt, double* life_idle,
    double* life_pre, double* life_keep, const double* life_costs,
    double* life_hist, double* life_n_obs, int life, int max_idle,
    double bin_s, double ttl, const double* speed, const double* edges,
    long long* slow_hist, long long* lat_hist, long long* counters,
    double* busy, double* depth, long long* decisions,
    long long* busy_iters, int* n_on,
    double* cool_until, double* prov_time, long long* snap, int obs,
    long long cutoff, int auto_on, int min_workers, double hi, double lo,
    double cooldown, const double* tl_window_s, long long* tl_counts,
    long long* tl_slow_hist, long long* tl_lat_hist, double* tl_busy,
    double* tl_prov, int* tl_n_on, double* tl_ev_t, int* tl_ev_kind,
    int* tl_ev_val, double* tl_ev_p99, long long* tl_ev_count, int* tl_mode,
    int tl, int n_windows, int coarse_bins, int max_events, int tel_on,
    int n_reps, int n, int n_functions, int n_workers, int cores, int slots,
    int balancer, double penalty, void* stream, int chunk, int drain,
    long long g0, int* task_fn, double* task_svc, long long* stream_counts,
    double* stream_sums) {
  const bool state_given =
      balancer == kHiku
          ? lb_ring && lb_in_ring && lb_head && lb_tail
          : balancer == kDataDriven ? lb_est && lb_per_worker
          : balancer == kSwarm ? lb_est && lb_per_worker && lb_cnt : true;
  const bool life_given =
      !life || (life_idle && life_pre && life_keep &&
                (life_hist == nullptr) == (life_n_obs == nullptr) &&
                max_idle >= 0);
  const bool obs_given =
      !obs || (speed && edges && slow_hist && lat_hist && counters && busy &&
               depth && decisions && busy_iters && cutoff >= 0 &&
               (!auto_on || (n_on && cool_until && prov_time && snap &&
                             min_workers >= 1)));
  const bool tl_given =
      !tl || (obs && tl_window_s && tl_counts && tl_slow_hist &&
              tl_lat_hist && tl_busy && tl_prov && tl_n_on && tl_ev_t &&
              tl_ev_kind && tl_ev_val && tl_ev_p99 && tl_ev_count &&
              tl_mode && n_windows >= 1 && max_events >= 1 &&
              coarse_bins >= 1 && kBins % coarse_bins == 0);
  const bool chunk_given =
      !chunk || (obs && (!tl || tel_on) && task_fn && task_svc &&
                 stream_counts && stream_sums && g0 >= 0);
  if (n_reps < 1 || n < 0 || n_functions < 1 || n_workers < 1 ||
      n_workers > kMaxWorkers || cores < 1 || slots < 1 ||
      slots > kMaxSlots || balancer < 0 || balancer > kSwarm ||
      !state_given || !life_given || !obs_given || !tl_given ||
      !chunk_given || (!chunk && !drain)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Kernel = decltype(&sim_engine_kernel<kHermes, false, 0>);
#define SIM_ENGINE_ROW(LIFE, OBS)                                          \
  {sim_engine_kernel<kHermes, LIFE, OBS>,                                  \
   sim_engine_kernel<kLeastLoaded, LIFE, OBS>,                             \
   sim_engine_kernel<kLocality, LIFE, OBS>,                                \
   sim_engine_kernel<kRandom, LIFE, OBS>,                                  \
   sim_engine_kernel<kJsq2, LIFE, OBS>,                                    \
   sim_engine_kernel<kRoundRobin, LIFE, OBS>,                              \
   sim_engine_kernel<kHiku, LIFE, OBS>,                                    \
   sim_engine_kernel<kDataDriven, LIFE, OBS>,                              \
   sim_engine_kernel<kSwarm, LIFE, OBS>}
  // built in parts (kernels/_build.py): this library holds the nine
  // balancers of one lifecycle switch and observation mode
#if !defined(SIM_ENGINE_LIFE) || !defined(SIM_ENGINE_OBS)
#error "compile with -DSIM_ENGINE_LIFE=0|1 -DSIM_ENGINE_OBS=0|1|2"
#endif
  if ((life ? 1 : 0) != SIM_ENGINE_LIFE ||
      (tl ? 2 : obs ? 1 : 0) != SIM_ENGINE_OBS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel row[9] =
      SIM_ENGINE_ROW((SIM_ENGINE_LIFE != 0), SIM_ENGINE_OBS);
#undef SIM_ENGINE_ROW
  const Kernel kernel = row[balancer];
  const ObsArgs obs_args{speed,      edges,      slow_hist,  lat_hist,
                         counters,   busy,       depth,      decisions,
                         busy_iters, n_on,       cool_until, prov_time,
                         snap,       cutoff,     auto_on,    min_workers,
                         hi,         lo,         cooldown};
  const TlArgs tl_args{tl_window_s, tl_counts,  tl_slow_hist, tl_lat_hist,
                       tl_busy,     tl_prov,    tl_n_on,      tl_ev_t,
                       tl_ev_kind,  tl_ev_val,  tl_ev_p99,    tl_ev_count,
                       tl_mode,     n_windows,  coarse_bins,  max_events,
                       tl ? kBins / coarse_bins : 1,          tel_on};
  const StreamArgs stream_args{chunk,    drain,         g0,
                               task_fn,  task_svc,      stream_counts,
                               stream_sums};
  // one warp per worker, up to kMaxThreads
  const int threads =
      n_workers < kMaxThreads / 32 ? 32 * n_workers : kMaxThreads;
  const size_t smem = shared_bytes(n_workers, slots);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_reps, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, func, service, u_lb, home, remaining, task_arr, task_idx, warm,
      resp, cold, rejected, worker_of, server_time, core_time, now, iters,
      active, lb_ring, lb_in_ring, lb_head, lb_tail, lb_est, lb_per_worker,
      lb_cnt, life_idle, life_pre, life_keep, life_costs, life_hist,
      life_n_obs, max_idle, bin_s, ttl, obs_args, tl_args, n, n_functions,
      n_workers, cores, slots, penalty, stream_args);
  return static_cast<int>(cudaGetLastError());
}
