// One-token decode attention against a KV cache, as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/decode_attention/kernel.py
// (`_kernel`, launched by `decode_attention_hm`): one query row per (b, h)
// against the cache keys t <= pos[b], with an online softmax whose m, l and
// acc are f32 and whose q, k, v and p are f32 whatever the input type; key
// blocks past pos[b] are never read.  NEG_INF = -1e30 and the final
// max(l, 1e-30) clamp are the reference's.
//
// Layout: q [B, H, Dh] and o [B, H, Dh]; k and v are the model's seq-major
// cache [B, S_max, KV, Dh], read in place through their (b, s, h) strides
// (no transpose copy of the cache per step); pos [B] int32 on the device,
// each in [0, S_max).  Rows past pos[b] hold no data and are never read.
//
// What bounds it on this card: bytes.  A step reads the K and V rows
// t <= pos of every KV head once, 2*B*(pos+1)*KV*Dh*size bytes, and does
// 4*B*H*(pos+1)*Dh flops: G = H/KV flops per byte in bf16 (1 for MHA),
// far below the ~295 at which the tensor cores would be the limit.  So the
// floor is the 3.35 TB/s of device memory, and the design reads each cache
// row once for all the query heads that share it:
//   * one block of 256 threads per (b, kv head); its G query rows are
//     staged in shared memory and scored together against each K row;
//   * the cache streams in chunks of 64 rows (K rows padded by one float so
//     that the score loop's strided reads hit distinct banks); scores,
//     probabilities and acc [G, Dh] live in shared memory;
//   * one warp per query head reduces a chunk's max and sum with shuffles.
// Known limit: at B = 1 the grid is only KV blocks (16 for olmo-1b, 32 for
// musicgen-large) on 132 SMs, so one block streams a head's whole prefix;
// a split-KV pass with a combine is later work.  Head dims 32, 64, 80 and 128
// and G <= 64 are built; the wrapper
// (repro_torch/kernels/decode_attention/kernel.py) refuses anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBT = 64;        // cache rows per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH>
size_t smem_floats(int group) {
  return static_cast<size_t>(group) * DH      // qs
         + kBT * (DH + 1)                     // ks
         + kBT * DH                           // vs
         + static_cast<size_t>(group) * (kBT + 1)  // ss
         + static_cast<size_t>(group) * DH    // acc
         + 3 * static_cast<size_t>(group);    // m, l, corr
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ pos, T* __restrict__ o,
                            int seq_max, int group, long long q_sb,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long o_sb, long long o_sh,
                            float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [G][DH]
  float* ks = qs + group * DH;             // [kBT][DH + 1]
  float* vs = ks + kBT * (DH + 1);         // [kBT][DH]
  float* ss = vs + kBT * DH;               // [G][kBT + 1]
  float* acc = ss + group * (kBT + 1);     // [G][DH]
  float* m = acc + group * DH;             // [G]
  float* l = m + group;                    // [G]
  float* corr = l + group;                 // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * group;

  const T* qb = q + b * q_sb + h0 * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  for (int idx = tid; idx < group * DH; idx += kThreads) {
    const int g = idx / DH;
    const int d = idx % DH;
    qs[idx] = to_f32(qb[g * q_sh + d]);
    acc[idx] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int n_keys = min(pos[b] + 1, seq_max);
  for (int t0 = 0; t0 < n_keys; t0 += kBT) {
    const int n_valid = min(kBT, n_keys - t0);
    __syncthreads();  // the previous chunk's ks, vs and ss are consumed
    for (int idx = tid; idx < kBT * DH; idx += kThreads) {
      const int t = idx / DH;
      const int d = idx % DH;
      const bool in = t < n_valid;
      const long long row = t0 + t;
      ks[t * (DH + 1) + d] = in ? to_f32(kb[row * k_ss + d]) : 0.f;
      vs[t * DH + d] = in ? to_f32(vb[row * v_ss + d]) : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < group * kBT; idx += kThreads) {
      const int g = idx / kBT;
      const int t = idx % kBT;
      const float* qg = qs + g * DH;
      const float* kt = ks + t * (DH + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qg[d], kt[d], dot);
      ss[g * (kBT + 1) + t] = t < n_valid ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      float* sg = ss + g * (kBT + 1);
      float mx = kNegInf;
      for (int t = lane; t < kBT; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kBT; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < group * DH; idx += kThreads) {
      const int g = idx / DH;
      const int d = idx % DH;
      const float* pg = ss + g * (kBT + 1);
      float a = acc[idx] * corr[g];
      for (int t = 0; t < n_valid; ++t) a = fmaf(pg[t], vs[t * DH + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  T* ob = o + b * o_sb + h0 * o_sh;
  for (int idx = tid; idx < group * DH; idx += kThreads) {
    const int g = idx / DH;
    const int d = idx % DH;
    store(&ob[g * o_sh + d], acc[idx] / fmaxf(l[g], 1e-30f));
  }
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int batch, int seq_max, int n_kv_heads, int group,
           const long long* st, float scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH>;
  const size_t smem = smem_floats<DH>(group) * sizeof(float);
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_kv_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), seq_max, group,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, const int* pos,
                void* o, int batch, int seq_max, int n_kv_heads, int group,
                int head_dim, const long long* st, float scale,
                cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, pos, o, batch, seq_max, n_kv_heads,
                           group, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, o, batch, seq_max, n_kv_heads,
                           group, st, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, pos, o, batch, seq_max, n_kv_heads,
                           group, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, o, batch, seq_max, n_kv_heads,
                            group, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Dh], k/v [B, S_max, KV, Dh], pos [B] i32 -> o [B, H, Dh], all
// of one dtype (0 = float32, 1 = bfloat16), last dimension contiguous.
// `strides` holds the (b, h) strides of q, the (b, s, h) strides of k and
// of v, and the (b, h) strides of o, in elements (10 values).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* pos,
                                       void* o, int dtype, int batch,
                                       int seq_max, int n_heads,
                                       int n_kv_heads, int head_dim,
                                       const long long* strides, float scale,
                                       void* stream) {
  if (batch < 1 || seq_max < 1 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, pos, o, batch, seq_max, n_kv_heads,
                              group, head_dim, strides, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, pos, o, batch, seq_max,
                                      n_kv_heads, group, head_dim, strides,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
