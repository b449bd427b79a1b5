// Causal GQA flash attention (forward) as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_hm`): online softmax with f32
// running max m, sum l and accumulator acc; q, k, v and the probabilities p
// are all f32 inside the kernel whatever the input type; key tiles past the
// causal frontier are never visited; query head h reads KV head h / group.
// Keys at or past S are masked (scores NEG_INF, K/V rows read as 0), and
// rows at or past S are computed but not stored, so S need not be a
// multiple of any tile.  NEG_INF = -1e30 and the final max(l, 1e-30) clamp
// are the reference's.
//
// Layout: q [B, S, H, Dh], k and v [B, S, KV, Dh], o [B, S, H, Dh], each
// read or written through its (b, s, h) strides in elements with the last
// dimension contiguous, so the model's seq-major tensors need no transpose.
//
// What bounds it on this card: causal attention does 2*B*H*S^2*Dh flops
// (q.k and p.v over the lower triangle) on size*B*S*Dh*(2*H + 2*KV) bytes
// (q, k, v read once, o written once): H*S / (size*(H + KV)) flops per
// byte, S/4 for MHA in bf16.  Against the card's ~295 bf16 flops per byte,
// the served prompts sit on both sides of the line: device memory bounds
// S < ~1180, the tensor cores' 989 TFLOP/s bound longer prompts.  This
// first version does its math in f32 on the CUDA cores (no wgmma, no TMA;
// 67 TFLOP/s peak), so it stays far above either floor; the design keeps
// it simple and right:
//   * one block of 256 threads per (b, h, 64-row query tile); tiles are
//     issued longest first (the last query tile sees the most keys);
//   * the query tile, one K tile and one V tile (BK = 64 rows, 32 at
//     Dh = 128, to keep 3 blocks per SM) and the tile of probabilities live
//     in dynamic shared memory as f32; rows of Q and K are padded by one
//     float so that the strided reads of the score loop hit distinct banks;
//   * thread (ty, tx) owns query rows 4*ty .. 4*ty+3, score columns
//     tx + 16*j and output columns tx + 16*c; a row's max and sum are
//     reduced over its 16 threads with shuffles;
//   * m, l and acc stay in registers across the key tiles.
// Head dims 32, 64, 80 (zamba2's shared attention) and 128 are built
// (at 80, BK = 64: 19,648 floats of shared memory); the wrapper
// (repro_torch/kernels/flash_attention/kernel.py) refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH, int BK>
constexpr size_t smem_floats() {
  return kBQ * (DH + 1) + BK * (DH + 1) + BK * DH + kBQ * (BK + 1);
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int seq, int group, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, long long o_sb, long long o_ss,
                           long long o_sh, float scale) {
  constexpr int KC = BK / 16;  // score columns per thread
  constexpr int DC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][DH + 1]
  float* ks = qs + kBQ * (DH + 1);         // [BK][DH + 1]
  float* vs = ks + BK * (DH + 1);          // [BK][DH]
  float* ps = vs + BK * DH;                // [kBQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_tiles = gridDim.x;
  const int q0 = (n_tiles - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    const int qp = q0 + r;
    qs[r * (DH + 1) + d] = qp < seq ? to_f32(qb[qp * q_ss + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the last key any row of this tile may attend to
  const int last_key = min(q0 + kBQ, seq) - 1;
  const int n_kt = last_key / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int idx = tid; idx < BK * DH; idx += kThreads) {
      const int t = idx / DH;
      const int d = idx % DH;
      const int kp = k0 + t;
      const bool in = kp < seq;
      ks[t * (DH + 1) + d] = in ? to_f32(kb[kp * k_ss + d]) : 0.f;
      vs[t * DH + d] = in ? to_f32(vb[kp * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][KC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[KC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < KC; ++j) kv[j] = ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float x = (kp <= qp && kp < seq) ? s[i][j] * scale : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int n_valid = min(BK, seq - k0);
    for (int t = 0; t < n_valid; ++t) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[t * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty * kRows + i) * (BK + 1) + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * o_sb + qp * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&orow[tx + 16 * c], acc[i][c] / denom);
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

template <typename T, int DH, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int n_heads, int group, const long long* st, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH, BK>;
  const size_t smem = smem_floats<DH, BK>() * sizeof(float);
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBQ - 1) / kBQ, n_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, group, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o,
                int batch, int seq, int n_heads, int group, int head_dim,
                const long long* st, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                               scale, stream);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                               scale, stream);
    case 80:
      return launch<T, 80, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                               scale, stream);
    case 128:
      return launch<T, 128, 32>(q, k, v, o, batch, seq, n_heads, group, st,
                                scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, S, H, Dh], k/v [B, S, KV, Dh] -> o [B, S, H, Dh], all of one dtype
// (0 = float32, 1 = bfloat16), last dimension contiguous.  `strides` holds
// (b, s, h) element strides of q, k, v and o, in that order (12 values).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int seq, int n_heads,
                                      int n_kv_heads, int head_dim,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (batch < 1 || seq < 1 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      batch > 65535 || n_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, batch, seq, n_heads, group,
                              head_dim, strides, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, batch, seq, n_heads, group,
                                      head_dim, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
