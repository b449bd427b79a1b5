// RWKV-6 WKV chunked scan (forward) as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/rwkv6_wkv/kernel.py
// (`_kernel`, launched by `wkv6_hm`).  Per head, with the [K, K] state S
// carried across chunks of c rows:
//   li = inclusive cumsum of lw over the chunk, lx = li - lw;
//   A[t,s] = sum_k r[t,k] k[s,k] exp(lx[t,k] - li[s,k])   (s < t),
//   A[t,t] = sum_k r[t,k] u[k] k[t,k];
//   y = A v + (r * exp(lx)) S                                (S before update)
//   S' = diag(exp(lc)) S + (k * exp(lc - li))^T v,  lc = li[c-1].
// Every exponent is a difference that is <= 0 (lw <= 0), so nothing
// overflows over a chunk of strong decay; it is never split into
// exp(a) * exp(-b).  expf is the accurate one (no fast math).  All math is
// f32 whatever the activation type; bf16 only at load and at the store of y.
// An optional f32 carry-in state s0 is read (null means zero: then this is
// exactly the Pallas kernel's function); the final state is written to its
// own f32 output.  A ragged last chunk is masked as the model pads it
// (lw = 0, r = k = v = 0); rows at or past T are not stored.
//
// Layout: r, k, v [B, T, H, K] of the activation type and lw [B, T, H, K]
// f32, each read through its (b, t, h) strides with the last dimension
// contiguous, so the model's seq-major tensors need no transpose; u [H, K]
// f32; s0 and s_out [B, H, K, K] f32, contiguous; y [B, T, H, K] written
// through its strides.
//
// What bounds it on this card: operations, through the exponentials.  A
// call reads r, k, v, lw and writes y once (about 12*B*T*H*K bytes in bf16
// with f32 lw: 31 MB, ~9 us at T = 1024 for rwkv6-3b), but the pairwise
// decay needs c*(c-1)/2*K exps per chunk and head (~46 M in all at
// T = 1024, ~11 us on the 16 special-function units of each SM).  This first version
// is simple and right, far from either floor:
//   * one block of 256 threads per (b, h) walks the chunks in order; S
//     (16 KB) stays in shared memory across them, with the chunk's r, k, v,
//     li and lx (rows padded by one float, so that a warp reading one
//     column of 32 rows hits 32 banks) and A;
//   * the A pass gives each warp one row t and each lane one column s;
//     lanes s >= t idle, so the SFUs spend c*c*K exps' worth of slots;
//   * y and the state update give each thread one column v, so the reads of
//     A, r*exp(lx) and k*exp(lc-li) are warp-wide broadcasts.
// Known limit: at B = 1 the grid is H blocks (40 for rwkv6-3b) on 132 SMs;
// the A pass does not depend on S and could run for all chunks in parallel
// ahead of the sequential pass (later work).  K = 64 and c <= 64 are built;
// the wrapper (repro_torch/kernels/rwkv6_wkv/kernel.py) refuses the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int K>
size_t smem_floats(int c) {
  return 4 * static_cast<size_t>(c) * (K + 1)   // rs, ks, li, lx
         + static_cast<size_t>(c) * K           // vs
         + K * K                                // S
         + static_cast<size_t>(c) * (c + 1)     // A
         + K;                                   // u
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ s_out, int seq,
                int chunk, long long r_sb, long long r_st, long long r_sh,
                long long k_sb, long long k_st, long long k_sh,
                long long v_sb, long long v_st, long long v_sh,
                long long w_sb, long long w_st, long long w_sh,
                long long y_sb, long long y_st, long long y_sh) {
  constexpr int KP = K + 1;
  const int c = chunk;
  extern __shared__ float smem[];
  float* rs = smem;              // [c][KP]  r, then r * exp(lx)
  float* ks = rs + c * KP;       // [c][KP]  k, then k * exp(lc - li)
  float* li = ks + c * KP;       // [c][KP]  lw, then its inclusive cumsum
  float* lx = li + c * KP;       // [c][KP]  exclusive cumsum
  float* vs = lx + c * KP;       // [c][K]
  float* S = vs + c * K;         // [K][K]
  float* A = S + K * K;          // [c][c + 1]
  float* us = A + c * (c + 1);   // [K]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_heads = gridDim.x;

  const T* rb = r + b * r_sb + h * r_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* wb = lw + b * w_sb + h * w_sh;
  T* yb = y + b * y_sb + h * y_sh;
  const long long s_off = (static_cast<long long>(b) * n_heads + h) * K * K;

  for (int i = tid; i < K * K; i += kThreads)
    S[i] = s0 != nullptr ? s0[s_off + i] : 0.f;
  for (int i = tid; i < K; i += kThreads) us[i] = u[h * K + i];

  const int n_chunks = (seq + c - 1) / c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * c;
    __syncthreads();  // the previous chunk's buffers are consumed
    for (int idx = tid; idx < c * K; idx += kThreads) {
      const int t = idx / K;
      const int j = idx % K;
      const long long tp = t0 + t;
      const bool in = tp < seq;
      rs[t * KP + j] = in ? to_f32(rb[tp * r_st + j]) : 0.f;
      ks[t * KP + j] = in ? to_f32(kb[tp * k_st + j]) : 0.f;
      vs[t * K + j] = in ? to_f32(vb[tp * v_st + j]) : 0.f;
      li[t * KP + j] = in ? wb[tp * w_st + j] : 0.f;
    }
    __syncthreads();
    // inclusive and exclusive cumsums of lw down each column
    for (int j = tid; j < K; j += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float w = li[t * KP + j];
        lx[t * KP + j] = acc;  // li - lw, without the subtraction's rounding
        acc += w;
        li[t * KP + j] = acc;
      }
    }
    __syncthreads();
    // A: one row t per warp, one column s per lane
    for (int t = warp; t < c; t += kThreads / 32) {
      for (int s = lane; s < c; s += 32) {
        float a = 0.f;
        if (s < t) {
#pragma unroll 8
          for (int j = 0; j < K; ++j)
            a = fmaf(rs[t * KP + j] * ks[s * KP + j],
                     expf(lx[t * KP + j] - li[s * KP + j]), a);
        } else if (s == t) {
#pragma unroll 8
          for (int j = 0; j < K; ++j)
            a = fmaf(rs[t * KP + j] * us[j], ks[t * KP + j], a);
        }
        A[t * (c + 1) + s] = a;
      }
    }
    __syncthreads();
    // r * exp(lx) and k * exp(lc - li), in place
    for (int idx = tid; idx < c * K; idx += kThreads) {
      const int t = idx / K;
      const int j = idx % K;
      rs[t * KP + j] *= expf(lx[t * KP + j]);
      ks[t * KP + j] *= expf(li[(c - 1) * KP + j] - li[t * KP + j]);
    }
    __syncthreads();
    // y = A v + (r * exp(lx)) S, with S from before this chunk's update
    for (int idx = tid; idx < c * K; idx += kThreads) {
      const int t = idx / K;
      const int j = idx % K;
      if (t0 + t >= seq) continue;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s)
        acc = fmaf(A[t * (c + 1) + s], vs[s * K + j], acc);
      float carry = 0.f;
#pragma unroll 8
      for (int m = 0; m < K; ++m)
        carry = fmaf(rs[t * KP + m], S[m * K + j], carry);
      store(&yb[static_cast<long long>(t0 + t) * y_st + j], acc + carry);
    }
    __syncthreads();
    // S' = diag(exp(lc)) S + (k * exp(lc - li))^T v
    for (int idx = tid; idx < K * K; idx += kThreads) {
      const int m = idx / K;
      const int j = idx % K;
      float acc = 0.f;
      for (int s = 0; s < c; ++s)
        acc = fmaf(ks[s * KP + m], vs[s * K + j], acc);
      S[idx] = S[idx] * expf(li[(c - 1) * KP + m]) + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += kThreads) s_out[s_off + i] = S[i];
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

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* y, float* s_out, int batch,
           int seq, int n_heads, int chunk, const long long* st,
           cudaStream_t stream) {
  auto kern = wkv6_kernel<T, K>;
  const size_t smem = smem_floats<K>(chunk) * sizeof(float);
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem_floats<K>(kMaxChunk) * sizeof(float),
                               allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, s0, static_cast<T*>(y), s_out, seq,
      chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v [B, T, H, K] of one dtype (0 = float32, 1 = bfloat16), lw
// [B, T, H, K] f32, u [H, K] f32, s0 [B, H, K, K] f32 or null -> y
// [B, T, H, K] (r's dtype), s_out [B, H, K, K] f32.  `strides` holds the
// (b, t, h) element strides of r, k, v, lw and y, in that order (15
// values); the last dimension of each is contiguous.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const float* lw, const float* u,
                                const float* s0, void* y, float* s_out,
                                int dtype, int batch, int seq, int n_heads,
                                int head_size, int chunk,
                                const long long* strides, void* stream) {
  if (batch < 1 || seq < 1 || n_heads < 1 || batch > 65535 ||
      n_heads > 65535 || chunk < 1 || chunk > kMaxChunk || head_size != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 64>(r, k, v, lw, u, s0, y, s_out, batch, seq,
                             n_heads, chunk, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(r, k, v, lw, u, s0, y, s_out, batch, seq,
                                     n_heads, chunk, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
