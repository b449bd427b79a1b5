// One-token decode attention against a KV cache, as a split-KV
// ("flash-decoding") CUDA kernel pair for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/decode_attention/kernel.py
// (`_kernel`, launched by `decode_attention_hm`): one query row per (b, h)
// against the cache keys t <= pos[b], with an online softmax whose m, l and
// acc are f32 and whose q, k, v and p are f32 whatever the input type; rows
// past pos[b] are never read.  NEG_INF = -1e30 and the final
// max(l, 1e-30) clamp are the reference's.
//
// Layout: q [B, H, Dh] and o [B, H, Dh]; k and v are the model's seq-major
// cache [B, S_max, KV, Dh], read in place through their (b, s, h) strides
// (no transpose copy of the cache per step); pos [B] int32 on the device,
// each in [0, S_max).
//
// What bounds it on this card: bytes.  A step reads the K and V rows
// t <= pos of every KV head once, 2*B*(pos+1)*KV*Dh*size bytes, and does
// 4*B*H*(pos+1)*Dh flops: G = H/KV flops per byte in bf16 (1 for MHA),
// far below the ~295 at which the tensor cores would be the limit.  So the
// floor is the 3.35 TB/s of device memory, and the design is about keeping
// enough bytes in flight on every SM:
//   * split-KV: the grid is (KV heads, n_split, B).  The wrapper picks
//     rows_per_split (a multiple of 64) from S_max, KV and B alone, aiming
//     at 4 x 132 blocks, so that a prefix that ends early still spreads
//     over the SMs; it never reads pos, so a launch stays capturable in a
//     CUDA graph.  A split whose first row is past pos[b] writes an empty
//     partial (m = NEG_INF, l = 0) and exits;
//   * each block copies its rows of K and V into shared memory with 16-byte
//     cp.async copies (8 bf16 or 4 f32 per copy, rows past pos zero-filled
//     and never read), in chunks of 64 bf16 or 32 f32 rows (32 KB at
//     Dh = 128).  All of a chunk's copies are in flight at once and, where a
//     split has more than one chunk, the next chunk's copies start
//     before this chunk's math (a two-stage ring).  At the served shapes a
//     split is one bf16 chunk, and the SM's several resident blocks overlap
//     each other's copies and math;
//   * each K and V row is read from device memory once for all G query
//     heads of its KV head.  Scores: Dh/8 lanes share one (head, row) pair,
//     each lane reading 8 elements (one 16-byte shared load in bf16) and
//     reducing the dot product with shuffles inside its lane group (4, 8,
//     16 or 32 lanes; at Dh = 80 the 10 lanes of a row are padded to a
//     group of 16, the last 6 idle in the dot product);
//   * one warp per query head takes the chunk's max and sum (m, l and the
//     correction stay in shared memory, f32);
//   * p.V: each thread owns 8 output elements of one head and sums every
//     rp_n-th row of the chunk into registers (rp_n = 128 / (G * Dh/8),
//     8 at olmo-1b's G = 1, Dh = 128), so all 128 threads stream V even
//     for MHA; the row parts are summed once per split through shared
//     memory;
//   * a second small kernel, one block per (b, h), merges the splits'
//     f32 (m, l, acc) partials (a scratch the wrapper allocates) and writes
//     acc / max(l, 1e-30) in q's dtype.  One call is two device launches.
// At Dh = 256 (gemma-2b: G = 8, the wide path) a bf16 or f32 chunk is 64 KB
// of K and V, and with two stages and G = 64 the block's shared memory is
// 213 KB, inside the 227 KB a block may have.
// Head dims 32, 64, 80, 128 and 256 and G <= 64 are built; the wrapper
// (repro_torch/kernels/decode_attention/kernel.py) refuses anything else,
// and a cache whose pointers or (b, s, h) strides are not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;
constexpr int kSplitQuantum = 64;  // rows_per_split is a multiple of this
constexpr int kMaxHeadDim = 256;   // threads of a combine block: one per d

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements from 16-byte aligned shared memory, as f32.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// kWide: G * Dh/8 > 128 p.V units, so a thread owns several (G = 64 at
// Dh = 128: 8 units, 64 f32 of acc); otherwise one, and the registers of
// the narrow kernel leave room for more resident blocks.
template <typename T, int DH, bool kWide>
struct Tile {
  // cache rows per chunk: 32 KB of K and V at Dh = 128 in either dtype
  static constexpr int kChunk = sizeof(T) == 2 ? 64 : 32;
  static constexpr int kSlices = DH / 8;  // 8-element slices of a row
  // lanes that share one (head, row) score: a power of two >= kSlices
  static constexpr int kLanes =
      kSlices <= 4 ? 4 : kSlices <= 8 ? 8 : kSlices <= 16 ? 16 : 32;
  static constexpr int kGroups = kThreads / kLanes;  // lane groups per block
  static constexpr int kPieces = DH * sizeof(T) / 16;  // 16-byte copies/row
  static constexpr int kPerPiece = 16 / sizeof(T);     // elements per copy
  // p.V units (head, slice) a thread may own: at G = kMaxGroup if wide
  static constexpr int kMaxUnits =
      kWide ? (kMaxGroup * kSlices + kThreads - 1) / kThreads : 1;
  static_assert(kChunk % kGroups == 0, "score pairs must fill lane groups");
  static_assert(kSplitQuantum % kChunk == 0, "splits hold whole chunks");
};

template <typename T, int DH>
size_t smem_bytes(int group, int stages) {
  using Tl = Tile<T, DH, false>;
  return static_cast<size_t>(stages) * 2 * Tl::kChunk * DH * sizeof(T)  // ring
         + static_cast<size_t>(group) * DH * sizeof(float)             // qs
         + static_cast<size_t>(group) * Tl::kChunk * sizeof(float)     // ss
         + 3 * static_cast<size_t>(group) * sizeof(float)  // m, l, corr
         + static_cast<size_t>(kThreads) * 8 * sizeof(float);  // red
}

template <typename T, int DH, bool kWide>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ pos,
        float* __restrict__ part_ml, float* __restrict__ part_acc,
        int seq_max, int group, int rows_per_split, int stages,
        long long q_sb, long long q_sh, long long k_sb, long long k_ss,
        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
        float scale) {
  using Tl = Tile<T, DH, kWide>;
  constexpr int CH = Tl::kChunk;
  constexpr int NS = Tl::kSlices;
  constexpr int LPR = Tl::kLanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [stages][K, V][CH][DH]
  float* qs = reinterpret_cast<float*>(ring + stages * 2 * CH * DH);  // [G][DH]
  float* ss = qs + group * DH;     // [G][CH]
  float* m = ss + group * CH;      // [G]
  float* l = m + group;            // [G]
  float* corr = l + group;         // [G]
  float* red = corr + group;       // [kThreads][8]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.y;
  const int n_heads = gridDim.x * group;
  const int h0 = kvh * group;
  // partial (b, h, split) lives at ((b * H + h) * n_split + split)
  const long long part0 =
      (static_cast<long long>(b) * n_heads + h0) * n_split + split;

  const int n_keys = min(pos[b] + 1, seq_max);
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, n_keys);
  if (r0 >= r1) {  // the split starts past pos[b]: an empty partial
    for (int g = tid; g < group; g += kThreads) {
      part_ml[2 * (part0 + static_cast<long long>(g) * n_split)] = kNegInf;
      part_ml[2 * (part0 + static_cast<long long>(g) * n_split) + 1] = 0.f;
    }
    return;
  }

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int n_chunks = (r1 - r0 + CH - 1) / CH;
  auto fetch = [&](int c) {
    T* ks = ring + (c % stages) * 2 * CH * DH;
    T* vs = ks + CH * DH;
    const int t0 = r0 + c * CH;
    for (int idx = tid; idx < CH * Tl::kPieces; idx += kThreads) {
      const int t = idx / Tl::kPieces;
      const int e = (idx % Tl::kPieces) * Tl::kPerPiece;
      const bool in = t0 + t < r1;
      const long long row = in ? t0 + t : r0;  // a valid address either way
      cp_async16(ks + t * DH + e, kb + row * k_ss + e, in);
      cp_async16(vs + t * DH + e, vb + row * v_ss + e, in);
    }
    cp_async_commit();
  };
  fetch(0);

  const T* qb = q + b * q_sb + h0 * q_sh;
  for (int idx = tid; idx < group * DH; idx += kThreads)
    qs[idx] = to_f32(qb[(idx / DH) * q_sh + idx % DH]);
  for (int g = tid; g < group; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // p.V units: (head g, slice s) = u / NS, u % NS.  With G * NS <= 128
  // units, rp_n threads share a unit, each summing every rp_n-th row;
  // otherwise a thread owns units tid, tid + 128, ... over all rows.
  const int units = group * NS;
  const int rp_n = units <= kThreads ? kThreads / units : 1;
  const int rp = units <= kThreads ? tid / units : 0;
  const int u0 = units <= kThreads ? tid % units : tid;
  const int nu = rp >= rp_n ? 0
                 : units <= kThreads ? 1
                                     : (units - tid + kThreads - 1) / kThreads;
  float acc[Tl::kMaxUnits][8];
#pragma unroll
  for (int i = 0; i < Tl::kMaxUnits; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int li = lane % LPR;      // lane within its lane group
  const int grp = tid / LPR;      // lane group within the block
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c (and qs, m, l) visible; chunk c-1 consumed
    if (c + 1 < n_chunks) fetch(c + 1);
    const T* ks = ring + (c % stages) * 2 * CH * DH;
    const T* vs = ks + CH * DH;
    const int n_valid = min(CH, r1 - (r0 + c * CH));

    // scores: lane group grp takes pairs (g, t) = pr / CH, pr % CH
    for (int base = 0; base < group * CH; base += Tl::kGroups) {
      const int pr = base + grp;
      const int g = pr / CH;
      const int t = pr % CH;
      float dot = 0.f;
      if (li < NS) {
        float kx[8], qx[8];
        load8(ks + t * DH + 8 * li, kx);
        load8(qs + g * DH + 8 * li, qx);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qx[j], kx[j], dot);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (li == 0) ss[g * CH + t] = t < n_valid ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      float* sg = ss + g * CH;
      float mx = kNegInf;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[g] = cr;
        l[g] = l[g] * cr + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < Tl::kMaxUnits; ++i) {
      if (i < nu) {
        const int u = u0 + i * kThreads;
        const int g = u / NS;
        const int s = u % NS;
        const float cr = corr[g];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= cr;
        const float* pg = ss + g * CH;
        for (int t = rp; t < n_valid; t += rp_n) {
          const float p = pg[t];
          float vx[8];
          load8(vs + t * DH + 8 * s, vx);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p, vx[j], acc[i][j]);
        }
      }
    }
  }

  // write the partial: (m, l) per head and the unnormalised acc
  if (rp_n > 1) {
    if (nu > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[tid * 8 + j] = acc[0][j];
    }
    __syncthreads();
    if (tid < units) {
      const int g = tid / NS;
      const int s = tid % NS;
      float* dst = part_acc + (part0 + static_cast<long long>(g) * n_split) * DH
                   + 8 * s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = 0.f;
        for (int r = 0; r < rp_n; ++r) a += red[(r * units + tid) * 8 + j];
        dst[j] = a;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < Tl::kMaxUnits; ++i) {
      if (i < nu) {
        const int u = u0 + i * kThreads;
        const int g = u / NS;
        const int s = u % NS;
        float* dst = part_acc
                     + (part0 + static_cast<long long>(g) * n_split) * DH
                     + 8 * s;
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = acc[i][j];
      }
    }
  }
  for (int g = tid; g < group; g += kThreads) {
    part_ml[2 * (part0 + static_cast<long long>(g) * n_split)] = m[g];
    part_ml[2 * (part0 + static_cast<long long>(g) * n_split) + 1] = l[g];
  }
}

// One block of DH threads per (h, b): the splits' partials merged, as the
// reference's online softmax would have carried them.  Empty partials
// (l = 0) are skipped, so their acc, never written, is never read.
template <typename T, int DH>
__global__ void __launch_bounds__(kMaxHeadDim)
    decode_attention_combine_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ o, int n_split,
                                    long long o_sb, long long o_sh) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const long long part0 =
      (static_cast<long long>(b) * gridDim.x + h) * n_split;
  const float* ml = part_ml + 2 * part0;
  const float* pa = part_acc + part0 * DH + d;
  float mx = kNegInf;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, ml[2 * i]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float li = ml[2 * i + 1];
    if (li > 0.f) {
      const float w = expf(ml[2 * i] - mx);
      lsum = fmaf(li, w, lsum);
      a = fmaf(w, pa[static_cast<long long>(i) * DH], a);
    }
  }
  store(&o[b * o_sb + h * o_sh + d], a / fmaxf(lsum, 1e-30f));
}

constexpr int kMaxDevices = 64;

// Raise `kern`'s dynamic shared-memory limit to `smem` bytes on the current
// device, once: `allowed` (one per kernel instantiation) remembers what was
// set, so that later launches, for instance inside a CUDA graph capture,
// make no attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <typename T, int DH, bool kWide>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 float* part_ml, float* part_acc, int batch, int seq_max,
                 int n_kv_heads, int group, int rows_per_split, int n_split,
                 const long long* st, float scale, cudaStream_t stream) {
  auto kern = decode_attention_split_kernel<T, DH, kWide>;
  const int stages = rows_per_split > Tile<T, DH, kWide>::kChunk ? 2 : 1;
  const size_t smem = smem_bytes<T, DH>(group, stages);
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(n_kv_heads, n_split, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, part_ml, part_acc, seq_max, group,
      rows_per_split, stages, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, float* part_ml, float* part_acc, int batch, int seq_max,
           int n_kv_heads, int group, int rows_per_split, int n_split,
           const long long* st, float scale, cudaStream_t stream) {
  const bool wide = group * (DH / 8) > kThreads;
  const int err =
      wide ? launch_split<T, DH, true>(q, k, v, pos, part_ml, part_acc, batch,
                                       seq_max, n_kv_heads, group,
                                       rows_per_split, n_split, st, scale,
                                       stream)
           : launch_split<T, DH, false>(q, k, v, pos, part_ml, part_acc,
                                        batch, seq_max, n_kv_heads, group,
                                        rows_per_split, n_split, st, scale,
                                        stream);
  if (err != 0) return err;
  decode_attention_combine_kernel<T, DH>
      <<<dim3(n_kv_heads * group, batch), DH, 0, stream>>>(
          part_ml, part_acc, static_cast<T*>(o), n_split, st[8], st[9]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, const int* pos,
                void* o, float* part_ml, float* part_acc, int batch,
                int seq_max, int n_kv_heads, int group, int head_dim,
                int rows_per_split, int n_split, const long long* st,
                float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, pos, o, part_ml, part_acc, batch,
                           seq_max, n_kv_heads, group, rows_per_split,
                           n_split, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, o, part_ml, part_acc, batch,
                           seq_max, n_kv_heads, group, rows_per_split,
                           n_split, st, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, pos, o, part_ml, part_acc, batch,
                           seq_max, n_kv_heads, group, rows_per_split,
                           n_split, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, o, part_ml, part_acc, batch,
                            seq_max, n_kv_heads, group, rows_per_split,
                            n_split, st, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, o, part_ml, part_acc, batch,
                            seq_max, n_kv_heads, group, rows_per_split,
                            n_split, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Dh], k/v [B, S_max, KV, Dh], pos [B] i32 -> o [B, H, Dh], all
// of one dtype (0 = float32, 1 = bfloat16), last dimension contiguous, the
// cache 16-byte aligned.  `strides` holds the (b, h) strides of q, the
// (b, s, h) strides of k and of v, and the (b, h) strides of o, in
// elements (10 values).  part_ml [B, H, n_split, 2] and part_acc
// [B, H, n_split, Dh] are f32 scratch; rows_per_split is a multiple of 64
// and n_split * rows_per_split >= S_max.  Launches the split kernel and the
// combine kernel on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* pos, void* o,
    void* part_ml, void* part_acc, int dtype, int batch, int seq_max,
    int n_heads, int n_kv_heads, int head_dim, int rows_per_split,
    int n_split, const long long* strides, float scale, void* stream) {
  if (batch < 1 || seq_max < 1 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup ||
      batch > 65535 || rows_per_split < kSplitQuantum ||
      rows_per_split % kSplitQuantum != 0 || n_split < 1 ||
      n_split > 65535 ||
      static_cast<long long>(n_split) * rows_per_split < seq_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  auto ml = static_cast<float*>(part_ml);
  auto pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, pos, o, ml, pa, batch, seq_max,
                              n_kv_heads, group, head_dim, rows_per_split,
                              n_split, strides, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, pos, o, ml, pa, batch,
                                      seq_max, n_kv_heads, group, head_dim,
                                      rows_per_split, n_split, strides, scale,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
