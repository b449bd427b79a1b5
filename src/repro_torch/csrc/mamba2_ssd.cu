// Mamba-2 SSD chunked scan (forward) as CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/mamba2_ssd/kernel.py
// (`_kernel`, launched by `ssd_pallas`).  Per head h, with the [P, N] state
// S carried across chunks of c rows:
//   la = inclusive cumsum of dt * a[h] over the chunk (<= 0);
//   M[t,s] = (C_t . B_s) * exp(la_t - la_s) * dt_s          (s <= t);
//   y = M x + exp(la_t) * (C_t . S)                           (S before update)
//   S' = S * exp(la_end) + sum_s exp(la_end - la_s) * dt_s * x_s (x) B_s.
// Every exponent is a difference that is <= 0 (a < 0, dt >= 0), never split
// into exp(a) * exp(-b); expf is the accurate one (no fast math).  An
// optional f32 carry-in state h0 is read (null means zero: then this is
// exactly the Pallas kernel's function); the final state is written to its
// own f32 output.  A ragged last chunk is masked as the model pads it
// (dt = 0, x = B = C = 0); rows at or past T are not stored.
//
// Layout: x [B, T, H, P] and bmat, cmat [B, T, N] of the activation type,
// dt [B, T, H] f32, each read through its strides with the last dimension of
// x, bmat and cmat contiguous (the model passes views into its conv output:
// no copies); a [H] f32; h0 and h_out [B, H, P, N] f32, contiguous; y
// [B, T, H, P] written through its strides.
//
// What bounds it on this card: bytes.  A call at zamba2-2.7b's width (H =
// 80, P = N = 64, c = 128) reads x, dt, B, C and writes y and the state
// once: 17.7 MB at T = 777, 5.3 us at 3.35 TB/s, while its ~1.8 GFLOP of
// products would take ~2 us on the tensor cores.  What holds this design
// back from that is latency and instruction throughput: the passes' load
// bursts, the scratch's round trip, and the output pass's M build (an
// accurate expf and a hi/lo cut per element) between its products.
// The Pallas kernel walks the chunks in order with all heads' [H, P, N]
// state in VMEM (1.31 MB): on Hopper that is one block per head walking
// the chunks, 80 blocks on 132 SMs.  So the scan is cut into the chunked
// SSD decomposition's three passes, two of them parallel over chunks, each
// launched on the caller's stream with sizes that depend on the shapes
// alone (capturable in a CUDA graph); the wrapper allocates their f32
// scratch:
//   1. chunk state, grid (chunk, h, b): la by a warp-level scan; U_k =
//      (w x)^T B over the chunk's rows (w_s = exp(la_end - la_s) * dt_s),
//      one tensor-core product, written to the scratch [B, n_chunks, H,
//      P, N]; la_end to [B, n_chunks, H];
//   2. state passing, one thread per (b, h, p, n), in order over chunks:
//      S_in,k = S; S = S * exp(la_end,k) + U_k, from h0 or zero.  S_in
//      overwrites U_k in the scratch; the final S goes to h_out;
//   3. output, grid (chunk, head group, b): C . B^T once per chunk for the
//      block's heads, then per head, each warp one 16-row tile of t with
//      all of p: y = exp(la_t) (C . S_in^T) + M x, M built in registers
//      from C . B^T, stored once in x's dtype.  The next head's x, S_in
//      and dt are loaded into registers while this head computes, and a
//      bf16 block (112 KB) leaves room for a second on its SM.
// The products are warp-level `mma.sync.m16n8k16` bf16 -> f32.  Inputs are
// staged in shared memory in their own type (16-byte loads) and enter the
// products as they are in bf16 (exact) or in three bf16 pieces in f32; an
// f32-valued factor (w x, M, S_in) is cut into hi = bf16(v) and lo =
// bf16(v - hi) (three pieces beside f32 inputs): w x and M in registers
// as their fragments are built, S_in once as it is staged.  The
// piece products (i, j) with i + j < max(pieces) are summed in f32, so a
// product matches f32 to about 2^-16 relative (2^-24 with f32 inputs) and
// no rounding is added to what the reference computes.  Shapes are padded
// to the mma tiles with zeros in shared memory (c, P and N to multiples of
// 16), which is exact.  c <= 128, P <= 64 and N <= 64 are built; the
// wrapper (repro_torch/kernels/mamba2_ssd/kernel.py) refuses the rest.

#include "tile_mma.cuh"

namespace {

constexpr int kMaxChunk = 128;  // = 32 lanes x 4 rows of the la scan
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;

// 16-byte pieces a thread loads for one [kMaxChunk, 64] tile of T
template <typename T>
constexpr int kTilePieces = kMaxChunk * 64 * sizeof(T) / 16 / kThreads;

// One warp: the chunk's dt, rows 4 * lane .. 4 * lane + 3 (0 at or past nv)
__device__ __forceinline__ void load_dt(const float* dt, long long d_st,
                                        int nv, float* d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * lane + j;
    d[j] = i < nv ? dt[i * d_st] : 0.f;
  }
}

// One warp, from load_dt's d: dts[i] = dt of row i and la[i] = inclusive
// cumsum of dts * ah, for all kMaxChunk rows (so la[kMaxChunk - 1] is
// la_end: the padding adds zeros)
__device__ __forceinline__ void scan_dt(const float* d, float ah, float* dts,
                                        float* la) {
  const int lane = threadIdx.x & 31;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dts[4 * lane + j] = d[j];
    run += d[j] * ah;
    v[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) la[4 * lane + j] = excl + v[j];
}

// -- pass 1: chunk states ----------------------------------------------------

// One (chunk, head) per block of kThreads: 36 KB of shared memory in bf16,
// so that several blocks share an SM and hide each other's latencies (on
// the H100 faster than blocks of 64 or 128 threads, or than blocks that
// take a few heads in turn with the next head's loads in flight).

template <typename T>
size_t state_smem_bytes(int c, int p, int n) {
  const int ldk = round16(c) + kPad;
  return static_cast<size_t>(round16(n) + round16(p)) * ldk * sizeof(T)
         + 3 * kMaxChunk * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const T* __restrict__ bm,
                           const float* __restrict__ a,
                           float* __restrict__ u, float* __restrict__ la_end,
                           int seq, int chunk, int P, int N, long long x_sb,
                           long long x_st, long long x_sh, long long d_sb,
                           long long d_st, long long d_sh, long long b_sb,
                           long long b_st) {
  constexpr int NI = Pieces<T>::kIn;
  constexpr int NF = Pieces<T>::kF32;
  const int cp = round16(chunk);
  const int P16 = round16(P);
  const int N16 = round16(N);
  const int ldk = cp + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bt = reinterpret_cast<T*>(smem_raw);  // [N16][ldk]  B^T of the chunk
  T* xt = bt + N16 * ldk;                   // [P16][ldk]  x^T of the head
  float* dts = reinterpret_cast<float*>(xt + P16 * ldk);  // [kMaxChunk]
  float* la = dts + kMaxChunk;              // [kMaxChunk]
  float* w = la + kMaxChunk;                // [kMaxChunk] exp(la_end-la)dt

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = k * chunk;
  const int nv = min(chunk, seq - t0);
  const int h = blockIdx.y;
  const int n_heads = gridDim.y;
  {
    TileLoad<T, true, kTilePieces<T>> lb, lx;
    lb.load(bm + b * b_sb + t0 * b_st, b_st, nv, N, cp, N16);
    lx.load(x + b * x_sb + t0 * x_st + h * x_sh, x_st, nv, P, cp, P16);
    float d[4];
    if (warp == 0) load_dt(dt + b * d_sb + t0 * d_st + h * d_sh, d_st, nv, d);
    lb.commit(bt, ldk);
    lx.commit(xt, ldk);
    if (warp == 0) {
      scan_dt(d, a[h], dts, la);
      __syncwarp();
      const float end = la[kMaxChunk - 1];
      for (int i = lane; i < kMaxChunk; i += 32)
        w[i] = expf(end - la[i]) * dts[i];
      if (lane == 0)
        la_end[(static_cast<long long>(b) * n_chunks + k) * n_heads + h] = end;
    }
  }
  __syncthreads();
  const int nrt = P16 / 16;
  const int nnt = N16 / 8;
  const int ngr = (nnt + 3) / 4;
  // U [p][n] = sum_s (w_s x_s[p]) B_s[n]: each warp in turn a 16-row tile
  // of p and up to four n8 tiles of n
  float* ub = u + ((static_cast<long long>(b) * n_chunks + k) * n_heads + h)
                      * P * N;
  for (int task = warp; task < nrt * ngr; task += kThreads / 32) {
    const int rt = task % nrt;
    const int gr = task / nrt;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    for (int ks = 0; ks < cp / 16; ++ks) {
      uint32_t fa[NF][4];
      frag_a_scaled<NF>(xt, ldk, rt * 16, ks * 16, w, fa);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (gr * 4 + q < nnt) {
          uint32_t fb[NI][2];
          frag_b<NI>(bt, ldk, (gr * 4 + q) * 8, ks * 16, fb);
          mma_pieces<NF, NI>(acc[q], fa, fb);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = gr * 4 + q;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int p = rt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = nt * 8 + 2 * (lane & 3);
        if (nt < nnt && p < P && n < N)
          store_pair(ub + p * N + n, acc[q][e], acc[q][e + 1], n + 1 < N);
      }
    }
  }
}

// -- pass 2: the state, in order over chunks ---------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_state_pass_kernel(float* __restrict__ us,
                          const float* __restrict__ la_end,
                          const float* __restrict__ h0,
                          float* __restrict__ h_out, int n_chunks,
                          int n_heads, int pn) {
  const int b = blockIdx.y;
  const long long per_b = static_cast<long long>(n_heads) * pn;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= per_b) return;
  const int h = static_cast<int>(i / pn);
  float s = h0 != nullptr ? h0[b * per_b + i] : 0.f;
  float* ub = us + static_cast<long long>(b) * n_chunks * per_b + i;
  const float* le = la_end + static_cast<long long>(b) * n_chunks * n_heads
                    + h;
  constexpr int kAhead = 8;  // chunks whose U and la_end load together
  for (int k0 = 0; k0 < n_chunks; k0 += kAhead) {
    float uk[kAhead], dk[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = k0 + j < n_chunks;
      uk[j] = in ? ub[(k0 + j) * per_b] : 0.f;
      dk[j] = in ? le[(k0 + j) * n_heads] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (k0 + j >= n_chunks) break;
      ub[(k0 + j) * per_b] = s;
      // S * exp(la_end) + U, rounded as the reference rounds it (no fma)
      s = __fadd_rn(__fmul_rn(s, expf(dk[j])), uk[j]);
    }
  }
  h_out[b * per_b + i] = s;
}

// -- pass 3: outputs ---------------------------------------------------------

// C . B^T is kept for its causal 16 x 16 tiles only: row t of tile-row r =
// t / 16 holds columns 0 .. 16 (r + 1) - 1, padded by kPad (a stride of 8
// or 24 mod 32 words), tile-row r starting at 128 r (r + 2).  That and the
// bf16 tiles make a bf16 block 112 KB at the served shape, so that two
// blocks (16 warps) share an SM and hide each other's latencies.
__host__ __device__ constexpr int cb_floats(int n_tile_rows) {
  return 128 * n_tile_rows * (n_tile_rows + 2);
}
__device__ __forceinline__ int cb_index(int t, int s) {
  const int r = t >> 4;
  return 128 * r * (r + 2) + (t & 15) * (16 * r + 16 + kPad) + s;
}

template <typename T>
constexpr int kOutMinBlocks = sizeof(T) == 2 ? 2 : 1;

template <typename T>
size_t out_smem_bytes(int c, int p, int n) {
  const size_t cp = round16(c);
  const size_t ldk = cp + kPad;
  const size_t ldn = round16(n) + kPad;
  const size_t p16 = round16(p);
  return (cb_floats(cp / 16) + 2 * kMaxChunk) * sizeof(float)
         + Pieces<T>::kF32 * p16 * ldn * sizeof(__nv_bfloat16)
         + (2 * cp * ldn + p16 * ldk) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kOutMinBlocks<T>)
    ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const T* __restrict__ bm, const T* __restrict__ cm,
                         const float* __restrict__ a,
                         const float* __restrict__ s_in, T* __restrict__ y,
                         int seq, int chunk, int n_heads, int P, int N,
                         int heads_per_block, long long x_sb, long long x_st,
                         long long x_sh, long long d_sb, long long d_st,
                         long long d_sh, long long b_sb, long long b_st,
                         long long c_sb, long long c_st, long long y_sb,
                         long long y_st, long long y_sh) {
  constexpr int NI = Pieces<T>::kIn;
  constexpr int NF = Pieces<T>::kF32;
  const int cp = round16(chunk);
  const int P16 = round16(P);
  const int N16 = round16(N);
  const int ldk = cp + kPad;   // tiles whose K is the chunk's rows s
  const int ldn = N16 + kPad;  // tiles whose K is n
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cb = reinterpret_cast<float*>(smem_raw);  // C . B^T, cb_index
  float* dts = cb + cb_floats(cp / 16);  // [kMaxChunk]
  float* la = dts + kMaxChunk;    // [kMaxChunk]
  // [NF][P16][ldn]  S_in of one head in bf16 pieces
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(la + kMaxChunk);
  const int sh_piece = P16 * ldn;
  T* cs = reinterpret_cast<T*>(sh + NF * sh_piece);  // [cp][ldn]  C
  T* bs = cs + cp * ldn;          // [cp][ldn]   B
  T* xt = bs + cp * ldn;          // [P16][ldk]  x^T of one head

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int k = blockIdx.x;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = k * chunk;
  const int nv = min(chunk, seq - t0);
  const int h_first = blockIdx.y * heads_per_block;
  const int h_end = min(h_first + heads_per_block, n_heads);

  // the next head's x^T, S_in and dt, in registers until committed
  TileLoad<T, true, kTilePieces<T>> lx;
  TileLoad<float, false, kTilePieces<float> / 2> ls;  // [64][64]: half
  float d[4];
  auto prefetch = [&](int h) {
    lx.load(x + b * x_sb + t0 * x_st + h * x_sh, x_st, nv, P, cp, P16);
    ls.load(s_in + ((static_cast<long long>(b) * n_chunks + k) * n_heads + h)
                       * P * N,
            N, P, N, P16, N16);
    if (warp == 0) load_dt(dt + b * d_sb + t0 * d_st + h * d_sh, d_st, nv, d);
  };
  {
    TileLoad<T, false, kTilePieces<T>> lc, lb;
    lc.load(cm + b * c_sb + t0 * c_st, c_st, nv, N, cp, N16);
    lb.load(bm + b * b_sb + t0 * b_st, b_st, nv, N, cp, N16);
    prefetch(h_first);
    lc.commit(cs, ldn);
    lb.commit(bs, ldn);
  }
  __syncthreads();

  // C . B^T's row tiles: warps w and w + 4 share the pair (w % 4, nrt - 1 -
  // w % 4), so that every pair holds about the same number of causal key
  // tiles, and take alternate n8 tiles of them
  const int nrt = cp / 16;
  const int half = warp >> 2;
  const int tile0 = warp & 3;
  const int tile1 = nrt - 1 - tile0;
  const int n_tiles = tile0 < tile1 ? 2 : tile0 == tile1 ? 1 : 0;

  // C . B^T for the warp's row tiles, key tiles s <= t
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= n_tiles) break;
    const int r = i == 0 ? tile0 : tile1;
    for (int nt = half; nt < 2 * (r + 1); nt += 2) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < N16 / 16; ++ks) {
        uint32_t fa[NI][4];
        uint32_t fb[NI][2];
        frag_a<NI>(cs, ldn, r * 16, ks * 16, fa);
        frag_b<NI>(bs, ldn, nt * 8, ks * 16, fb);
        mma_pieces<NI, NI>(acc, fa, fb);
      }
      float* row = cb + cb_index(r * 16 + g, nt * 8 + 2 * tq);
      const int row_st = 16 * r + 16 + kPad;
      *reinterpret_cast<float2*>(row) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(row + 8 * row_st) =
          make_float2(acc[2], acc[3]);
    }
  }

  // per head, each warp one row tile of t with all p: warps 0-3 tiles
  // 0-3, warps 4-7 tiles 7-4 (those below nrt)
  const int my_tile = warp < 4 ? (warp < nrt ? warp : -1)
                      : (nrt - 1 - (warp & 3) >= 4 ? nrt - 1 - (warp & 3)
                                                   : -1);
  const int npt = P16 / 8;             // n8 tiles of p (<= 8)
  for (int h = h_first; h < h_end; ++h) {
    __syncthreads();  // C . B^T written; the previous head's tiles consumed
    lx.commit(xt, ldk);
    ls.template commit_pieces<NF>(sh, ldn, sh_piece);
    if (warp == 0) scan_dt(d, a[h], dts, la);
    if (h + 1 < h_end) prefetch(h + 1);
    __syncthreads();
    T* yb = y + b * y_sb + h * y_sh;
    if (my_tile >= 0) {
      const int r = my_tile;
      float acc[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
      // carry-in: exp(la_t) (C_t . S_in^T)
      for (int ks = 0; ks < N16 / 16; ++ks) {
        uint32_t fa[NI][4];
        frag_a<NI>(cs, ldn, r * 16, ks * 16, fa);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < npt) {
            uint32_t fb[NF][2];
            frag_b_pieces<NF>(sh, sh_piece, ldn, q * 8, ks * 16, fb);
            mma_pieces<NI, NF>(acc[q], fa, fb);
          }
        }
      }
      const int ta = r * 16 + g;
      const float lt[2] = {la[ta], la[ta + 8]};
      const float ela[2] = {expf(lt[0]), expf(lt[1])};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] *= ela[e >> 1];
      // + intra-chunk M . x over the key steps s <= t, M built in
      // registers in the A fragment's layout
      // (unrolled to the most steps, so that one step's loads and exps
      // overlap the previous step's products: 5 % faster on the H100)
#pragma unroll
      for (int ks = 0; ks < kMaxChunk / 16; ++ks) {
        if (ks > r) break;
        uint32_t fa[NF][4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int t = ta + (rr & 1) * 8;
          const int s = ks * 16 + 2 * tq + (rr >> 1) * 8;
          const float2 c2 = ld_pair(cb + cb_index(t, s));
          const float2 l2 = ld_pair(la + s);
          const float2 d2 = ld_pair(dts + s);
          const float l_t = lt[rr & 1];
          const float m0 = s <= t ? c2.x * expf(l_t - l2.x) * d2.x : 0.f;
          const float m1 = s + 1 <= t ? c2.y * expf(l_t - l2.y) * d2.y : 0.f;
          split_pair<NF>(m0, m1, fa, rr);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < npt) {
            uint32_t fb[NI][2];
            frag_b<NI>(xt, ldk, q * 8, ks * 16, fb);
            mma_pieces<NF, NI>(acc[q], fa, fb);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = ta + (e >> 1) * 8;
          const int p = q * 8 + 2 * tq;
          if (q < npt && t < nv && p < P)
            store_pair(yb + static_cast<long long>(t0 + t) * y_st + p,
                       acc[q][e], acc[q][e + 1], p + 1 < P);
        }
      }
    }
  }
}

// -- launch ------------------------------------------------------------------

template <typename T>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* a, const float* h0, void* y, float* h_out, float* us,
           float* la_end, int batch, int seq, int n_heads, int P, int N,
           int chunk, int heads_per_block, const long long* st,
           cudaStream_t stream) {
  auto k1 = ssd_chunk_state_kernel<T>;
  auto k3 = ssd_chunk_out_kernel<T>;
  static size_t allowed1[kMaxDevices] = {};  // per instantiation
  static size_t allowed3[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      k1, state_smem_bytes<T>(kMaxChunk, kMaxP, kMaxN), allowed1);
  if (err == cudaSuccess)
    err = allow_smem(k3, out_smem_bytes<T>(kMaxChunk, kMaxP, kMaxN),
                     allowed3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (seq + chunk - 1) / chunk;
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bm);
  k1<<<dim3(n_chunks, n_heads, batch), kThreads,
       state_smem_bytes<T>(chunk, P, N), stream>>>(
      xp, dt, bp, a, us, la_end, seq, chunk, P, N, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_b = static_cast<long long>(n_heads) * P * N;
  ssd_state_pass_kernel<<<dim3(static_cast<unsigned>(
                                   (per_b + kThreads - 1) / kThreads),
                               batch),
                          kThreads, 0, stream>>>(us, la_end, h0, h_out,
                                                 n_chunks, n_heads, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(n_chunks, (n_heads + heads_per_block - 1) / heads_per_block,
            batch),
       kThreads, out_smem_bytes<T>(chunk, P, N), stream>>>(
      xp, dt, bp, static_cast<const T*>(cm), a, us, static_cast<T*>(y), seq,
      chunk, n_heads, P, N, heads_per_block, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, T, H, P], bmat and cmat [B, T, N] of one dtype (0 = float32,
// 1 = bfloat16), dt [B, T, H] f32, a [H] f32, h0 [B, H, P, N] f32 or null ->
// y [B, T, H, P] (x's dtype), h_out [B, H, P, N] f32.  `strides` holds the
// (b, t, h) element strides of x, the (b, t, h) strides of dt, the (b, t)
// strides of bmat and of cmat, and the (b, t, h) strides of y, in that order
// (13 values).  us [B, n_chunks, H, P, N] and la_end [B, n_chunks, H] are f32
// scratch (n_chunks = ceil(T / chunk)); blocks of pass 3 take
// heads_per_block heads each.  Launches the three passes on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int mamba2_ssd_launch(const void* x, const float* dt,
                                 const void* bm, const void* cm,
                                 const float* a, const float* h0, void* y,
                                 float* h_out, void* us, void* la_end,
                                 int dtype, int batch, int seq, int n_heads,
                                 int head_dim, int d_state, int chunk,
                                 int heads_per_block,
                                 const long long* strides, void* stream) {
  if (batch < 1 || seq < 1 || n_heads < 1 || batch > 65535 ||
      n_heads > 65535 || chunk < 1 || chunk > kMaxChunk || head_dim < 1 ||
      head_dim > kMaxP || d_state < 1 || d_state > kMaxN ||
      heads_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto u = static_cast<float*>(us);
  auto le = static_cast<float*>(la_end);
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, a, h0, y, h_out, u, le, batch, seq,
                         n_heads, head_dim, d_state, chunk, heads_per_block,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, h0, y, h_out, u, le, batch,
                                 seq, n_heads, head_dim, d_state, chunk,
                                 heads_per_block, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
