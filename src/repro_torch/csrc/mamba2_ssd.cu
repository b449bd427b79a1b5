// Mamba-2 SSD chunked scan (forward) as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/mamba2_ssd/kernel.py
// (`_kernel`, launched by `ssd_pallas`).  Per head h, with the [P, N] state
// S carried across chunks of c rows:
//   la = inclusive cumsum of dt * a[h] over the chunk (<= 0);
//   M[t,s] = (C_t . B_s) * exp(la_t - la_s) * dt_s          (s <= t);
//   y = M x + exp(la_t) * (C_t . S)                           (S before update)
//   S' = S * exp(la_end) + sum_s exp(la_end - la_s) * dt_s * x_s (x) B_s.
// Every exponent is a difference that is <= 0 (a < 0, dt >= 0), never split
// into exp(a) * exp(-b); expf is the accurate one (no fast math).  All math
// is f32 whatever the activation type; bf16 only at load and at the store of
// y.  An optional f32 carry-in state h0 is read (null means zero: then this
// is exactly the Pallas kernel's function); the final state is written to
// its own f32 output.  A ragged last chunk is masked as the model pads it
// (dt = 0, x = B = C = 0); rows at or past T are not stored.
//
// Layout: x [B, T, H, P] and bmat, cmat [B, T, N] of the activation type,
// dt [B, T, H] f32, each read through its strides with the last dimension of
// x, bmat and cmat contiguous (the model passes views into its conv output:
// no copies); a [H] f32; h0 and h_out [B, H, P, N] f32, contiguous; y
// [B, T, H, P] written through its strides.
//
// What bounds it on this card: bytes for the served bf16 inputs.  A call
// reads x, dt, B, C and writes y and the state once (~22 MB at T = 1024 for
// zamba2-2.7b, ~6.5 us), while its products (~2.7 GFLOP at T = 1024) would
// take ~3 us on the tensor cores.  The Pallas kernel keeps all heads'
// [H, P, N] state in VMEM (1.31 MB at zamba2's width): far above the 227 KB
// of shared memory a block has.  So this first version, simple and right:
//   * one block of 256 threads per (b, h) walks the chunks in order,
//     carrying its [P, N] state (16 KB) in shared memory, with the chunk's
//     x, B, C (32 KB each at c = 128, P = N = 64) and M [c, c] (64 KB):
//     182 KB at the served shape, one block per SM;
//   * C . B is recomputed by every head (the Pallas kernel computes it once
//     per chunk for all heads): 80x redundant at zamba2's width;
//   * all products run on the CUDA cores from shared memory (no wgmma),
//     each thread one output, reads that a warp shares are broadcasts and B
//     and S rows are padded by one float to spread the banks.
// Known limits: 80 blocks on 132 SMs at B = 1; shared-memory reads, not
// device memory, set its pace.  c <= 128, P <= 64 and N <= 64 are built; the
// wrapper (repro_torch/kernels/mamba2_ssd/kernel.py) refuses the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_floats(int c, int p, int n) {
  return static_cast<size_t>(c) * p           // xs
         + static_cast<size_t>(c) * (n + 1)   // bs
         + static_cast<size_t>(c) * n         // cs
         + static_cast<size_t>(p) * (n + 1)   // S
         + static_cast<size_t>(c) * c         // M
         + 4 * static_cast<size_t>(c);        // dts, la, ela, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ h0,
               T* __restrict__ y, float* __restrict__ h_out, int seq,
               int chunk, int P, int N, long long x_sb, long long x_st,
               long long x_sh, long long d_sb, long long d_st, long long d_sh,
               long long b_sb, long long b_st, long long c_sb, long long c_st,
               long long y_sb, long long y_st, long long y_sh) {
  const int c = chunk;
  const int NP = N + 1;
  extern __shared__ float smem[];
  float* xs = smem;              // [c][P]
  float* bs = xs + c * P;        // [c][NP]
  float* cs = bs + c * NP;       // [c][N]
  float* S = cs + c * N;         // [P][NP]
  float* M = S + P * NP;         // [c][c]
  float* dts = M + c * c;        // [c]
  float* la = dts + c;           // [c]
  float* ela = la + c;           // [c]  exp(la_t)
  float* w = ela + c;            // [c]  exp(la_end - la_s) * dt_s

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_heads = gridDim.x;
  const float ah = a[h];

  const T* xb = x + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  T* yb = y + b * y_sb + h * y_sh;
  const long long s_off = (static_cast<long long>(b) * n_heads + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    S[(i / N) * NP + i % N] = h0 != nullptr ? h0[s_off + i] : 0.f;

  const int n_chunks = (seq + c - 1) / c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * c;
    __syncthreads();  // the previous chunk's buffers are consumed
    for (int idx = tid; idx < c * P; idx += kThreads) {
      const int t = idx / P;
      const int p = idx % P;
      const long long tp = t0 + t;
      xs[idx] = tp < seq ? to_f32(xb[tp * x_st + p]) : 0.f;
    }
    for (int idx = tid; idx < c * N; idx += kThreads) {
      const int t = idx / N;
      const int n = idx % N;
      const long long tp = t0 + t;
      const bool in = tp < seq;
      bs[t * NP + n] = in ? to_f32(bb[tp * b_st + n]) : 0.f;
      cs[idx] = in ? to_f32(cb[tp * c_st + n]) : 0.f;
    }
    for (int t = tid; t < c; t += kThreads) {
      const long long tp = t0 + t;
      dts[t] = tp < seq ? db[tp * d_st] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += dts[t] * ah;
        la[t] = acc;
      }
    }
    __syncthreads();
    for (int t = tid; t < c; t += kThreads) {
      ela[t] = expf(la[t]);
      w[t] = expf(la[c - 1] - la[t]) * dts[t];
    }
    // M[t,s] = (C_t . B_s) exp(la_t - la_s) dt_s for s <= t, else 0
    for (int idx = tid; idx < c * c; idx += kThreads) {
      const int t = idx / c;
      const int s = idx % c;
      float m = 0.f;
      if (s <= t) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(cs[t * N + n], bs[s * NP + n], dot);
        m = dot * expf(la[t] - la[s]) * dts[s];
      }
      M[idx] = m;
    }
    __syncthreads();
    // y = M x + exp(la_t) (C_t . S), with S from before this chunk's update
    for (int idx = tid; idx < c * P; idx += kThreads) {
      const int t = idx / P;
      const int p = idx % P;
      if (t0 + t >= seq) continue;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(M[t * c + s], xs[s * P + p], acc);
      float carry = 0.f;
      for (int n = 0; n < N; ++n)
        carry = fmaf(cs[t * N + n], S[p * NP + n], carry);
      store(&yb[static_cast<long long>(t0 + t) * y_st + p],
            acc + carry * ela[t]);
    }
    __syncthreads();
    // S' = S exp(la_end) + sum_s w_s x_s (x) B_s
    const float e_end = ela[c - 1];
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N;
      const int n = idx % N;
      float acc = 0.f;
      for (int s = 0; s < c; ++s)
        acc = fmaf(w[s] * bs[s * NP + n], xs[s * P + p], acc);
      S[p * NP + n] = S[p * NP + n] * e_end + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    h_out[s_off + i] = S[(i / N) * NP + i % N];
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

template <typename T>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* a, const float* h0, void* y, float* h_out, int batch,
           int seq, int n_heads, int P, int N, int chunk, const long long* st,
           cudaStream_t stream) {
  auto kern = ssd_kernel<T>;
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(
      kern, smem_floats(kMaxChunk, kMaxP, kMaxN) * sizeof(float), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_floats(chunk, P, N) * sizeof(float);
  const dim3 grid(n_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(bm),
      static_cast<const T*>(cm), a, h0, static_cast<T*>(y), h_out, seq, chunk,
      P, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, T, H, P], bmat and cmat [B, T, N] of one dtype (0 = float32,
// 1 = bfloat16), dt [B, T, H] f32, a [H] f32, h0 [B, H, P, N] f32 or null ->
// y [B, T, H, P] (x's dtype), h_out [B, H, P, N] f32.  `strides` holds the
// (b, t, h) element strides of x, the (b, t, h) strides of dt, the (b, t)
// strides of bmat and of cmat, and the (b, t, h) strides of y, in that order
// (13 values).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int mamba2_ssd_launch(const void* x, const float* dt,
                                 const void* bm, const void* cm,
                                 const float* a, const float* h0, void* y,
                                 float* h_out, int dtype, int batch, int seq,
                                 int n_heads, int head_dim, int d_state,
                                 int chunk, const long long* strides,
                                 void* stream) {
  if (batch < 1 || seq < 1 || n_heads < 1 || batch > 65535 ||
      n_heads > 65535 || chunk < 1 || chunk > kMaxChunk || head_dim < 1 ||
      head_dim > kMaxP || d_state < 1 || d_state > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, a, h0, y, h_out, batch, seq, n_heads,
                         head_dim, d_state, chunk, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, h0, y, h_out, batch, seq,
                                 n_heads, head_dim, d_state, chunk, strides,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
