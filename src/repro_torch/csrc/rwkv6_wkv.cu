// RWKV-6 WKV chunked scan (forward) as CUDA kernels for Hopper (sm_90a).
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
// exp(a) * exp(-b) with a > 0.  expf is the accurate one (no fast math).
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
// What bounds it on this card: bytes.  At rwkv6-3b's width (H = 40,
// K = 64, c = 32) a call reads r, k, v, lw and writes y and the state
// once: 24.5 MB at T = 777, 7.3 us at 3.35 TB/s; the 8.6 M exps this
// design takes need 2.1 us of the special-function units.  What holds it
// back from that: the f32 state scratch, which is as large as the inputs
// and makes four trips (U_k written and read, S_in written and read), and
// the output pass's phases, which are bound by latency, not by the exps.
// The Pallas kernel walks the chunks in order with the state in VMEM; on
// Hopper that is one block per head, 40 blocks on 132 SMs.  So the scan is
// cut into three passes, two of them parallel over chunks, each launched
// on the caller's stream with sizes that depend on the shapes alone
// (capturable in a CUDA graph); the wrapper allocates their f32 scratch:
//   1. chunk state, grid (chunk, h, b): li by a scan down each column (a
//      quarter of the rows per thread, then the quarters' sums);
//      U_k^T = v^T (k e^{lc - li}), one tensor-core product, staged in
//      shared memory and written to the scratch [B, n_chunks, H, K (v),
//      K (k)] with 16-byte stores; e^{lc} to [B, n_chunks, H, K];
//   2. state passing, one thread per (b, h, k, v), in order over chunks:
//      S_in,k = S; S = diag(e^{lc,k}) S + U_k, from s0 or zero.  S_in^T
//      overwrites U_k^T in the scratch (the layout pass 3 reads its
//      product operand in); the final S goes to s_out, transposed through
//      shared memory;
//   3. output, grid (chunk, h, b), three blocks an SM in bf16: A in
//      16-row tiles i.  Below tile row i, one product (r e^{lx - lx_16i})
//      (k e^{lx_16i - li})^T, where lx_16i = li at row 16 i - 1 lies
//      between lx_t (t >= 16 i) and li_s (s < 16 i) because li falls, so
//      both exponents are <= 0 and their sum is the pairwise one; in each
//      diagonal tile the same split at row 16 i + 8 gives its lower-left
//      8 x 8 block.  In its two diagonal 8 x 8 blocks the decay of a pair
//      (t, s < t) is a running product of e^{li_q - lx_q} <= 1 (s < q < t),
//      one multiply a step, over only the s < t pairs (no lane idles).
//      Then y = (r e^{lx}) S_in + A v, with r e^{lx} = (r e^{lx - lx_16i})
//      e^{lx_16i}, stored once in r's dtype; S_in is loaded into the
//      cumsums' shared memory once they are consumed.
// The products are warp-level `mma.sync.m16n8k16` bf16 -> f32
// (tile_mma.cuh).  Inputs enter them as they are in bf16 (exact) or in
// three bf16 pieces in f32; an f32-valued factor (k e^{lc - li}, the
// factors of A, A itself, r e^{lx}, S_in) is cut into three bf16 pieces
// whatever the activation type (kFactorPieces), and the piece products
// (i, j) with i + j < 3 are summed in f32, so a product matches f32 to
// about 2^-24 relative and no rounding point is added to what the
// reference computes.  Chunks are padded to 16 rows with zeros
// in shared memory, which is exact.  K = 64 and c <= 64 are built; the
// wrapper (repro_torch/kernels/rwkv6_wkv/kernel.py) refuses the rest.

#include "tile_mma.cuh"

namespace {

constexpr int kHead = 64;      // K
constexpr int kMaxChunk = 64;
constexpr int kLd = kHead + kPad;  // row stride of the [rows][K] tiles
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == 4 * kHead, "the scan takes four threads a column");

// 16-byte pieces a thread loads for one [kMaxChunk, K] tile of T
template <typename T>
constexpr int kTilePieces = kMaxChunk * kHead * sizeof(T) / 16 / kThreads;
// bf16 pieces of an f32-valued factor, whatever the activation type: with
// two (hi, lo) rwkv6-3b's bf16 logits drifted measurably further from the
// plain forward in chip_smoke.py's phase 11 (its RMS ratio), with three
// they do not; so the products add no rounding point
constexpr int kFactorPieces = 3;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// li [cp][kLd] holds lw; on return it holds the inclusive cumsum down each
// column and, where lx and ev are given, lx [cp][kLd] the exclusive one
// (li of the row before, 0 in row 0) and ev [cp][kLd] e^{li - lx}.  Each
// thread takes one column and a quarter of the rows, then adds the earlier
// quarters' sums (tot [4][kHead]) in order, so that the first row's offset
// is, bit for bit, li of the row before: li falls monotonically down a
// column, as the exponents' signs need.  The caller's barrier before it
// makes lw visible; it ends with one.
__device__ void scan_columns(float* li, float* lx, float* ev, float* tot,
                             int cp) {
  const int j = threadIdx.x % kHead;
  const int part = threadIdx.x / kHead;
  const int rows = cp / 4;
  const int r0 = part * rows;
  float acc = 0.f;
  for (int t = r0; t < r0 + rows; ++t) {
    acc += li[t * kLd + j];
    li[t * kLd + j] = acc;
  }
  tot[part * kHead + j] = acc;
  __syncthreads();
  float off = 0.f;
  for (int p = 0; p < part; ++p) off += tot[p * kHead + j];
  float prev = off;
  for (int t = r0; t < r0 + rows; ++t) {
    const float cur = li[t * kLd + j] + off;
    if (lx != nullptr) {
      lx[t * kLd + j] = prev;
      ev[t * kLd + j] = expf(cur - prev);
    }
    li[t * kLd + j] = cur;
    prev = cur;
  }
  __syncthreads();
}

// -- pass 1: chunk states ----------------------------------------------------

// li, kd^T, the scan's sums and k, v^T; then U^T [kHead][kLd] over them
template <typename T>
size_t state_smem_bytes(int cp) {
  const size_t ldc = cp + kPad;
  const size_t tiles = (cp * kLd + kHead * ldc + 4 * kHead) * sizeof(float)
                       + (cp * kLd + kHead * ldc) * sizeof(T);
  const size_t out = kHead * kLd * sizeof(float);
  return tiles > out ? tiles : out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ lw,
                           float* __restrict__ ut, float* __restrict__ dec,
                           int seq, int chunk, long long k_sb, long long k_st,
                           long long k_sh, long long v_sb, long long v_st,
                           long long v_sh, long long w_sb, long long w_st,
                           long long w_sh) {
  constexpr int NI = Pieces<T>::kIn;
  constexpr int NF = kFactorPieces;
  const int cp = round16(chunk);
  const int ldc = cp + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* li = reinterpret_cast<float*>(smem_raw);  // [cp][kLd]
  float* kd = li + cp * kLd;       // [kHead][ldc]  (k e^{lc - li})^T
  float* tot = kd + kHead * ldc;   // [4][kHead]
  T* ks = reinterpret_cast<T*>(tot + 4 * kHead);  // [cp][kLd]
  T* vt = ks + cp * kLd;           // [kHead][ldc]  v^T

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kc = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int n_heads = gridDim.y;
  const int t0 = kc * chunk;
  const int nv = min(chunk, seq - t0);
  {
    TileLoad<T, false, kTilePieces<T>> lk;
    TileLoad<T, true, kTilePieces<T>> lv;
    TileLoad<float, false, kTilePieces<float>> ll;
    lk.load(k + b * k_sb + t0 * k_st + h * k_sh, k_st, nv, kHead, cp, kHead);
    lv.load(v + b * v_sb + t0 * v_st + h * v_sh, v_st, nv, kHead, cp, kHead);
    ll.load(lw + b * w_sb + t0 * w_st + h * w_sh, w_st, nv, kHead, cp,
            kHead);
    lk.commit(ks, kLd);
    lv.commit(vt, ldc);
    ll.commit(li, kLd);
  }
  __syncthreads();
  scan_columns(li, nullptr, nullptr, tot, cp);
  const float* lc = li + (cp - 1) * kLd;  // the padding adds zeros
  const long long cbase =
      (static_cast<long long>(b) * n_chunks + kc) * n_heads + h;
  if (threadIdx.x < kHead)
    dec[cbase * kHead + threadIdx.x] = expf(lc[threadIdx.x]);
  for (int idx = threadIdx.x; idx < cp * kHead; idx += kThreads) {
    const int s = idx / kHead;
    const int m = idx % kHead;
    kd[m * ldc + s] = to_f32(ks[s * kLd + m]) * expf(lc[m] - li[s * kLd + m]);
  }
  __syncthreads();
  // U^T [j][m] = sum_s v[s][j] kd[s][m]: each warp a 16-row tile of j and
  // four n8 tiles of m
  const int rt = warp >> 1;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int ks16 = 0; ks16 < cp / 16; ++ks16) {
    uint32_t fa[NI][4];
    frag_a<NI>(vt, ldc, rt * 16, ks16 * 16, fa);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t fb[NF][2];
      frag_b<NF>(kd, ldc, ((warp & 1) * 4 + q) * 8, ks16 * 16, fb);
      mma_pieces<NI, NF>(acc[q], fa, fb);
    }
  }
  // through shared memory, so that the scratch takes whole 16-byte stores
  __syncthreads();
  float* uo = reinterpret_cast<float*>(smem_raw);  // [kHead][kLd]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int j = rt * 16 + (lane >> 2) + (e >> 1) * 8;
      const int m = ((warp & 1) * 4 + q) * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(uo + j * kLd + m) =
          make_float2(acc[q][e], acc[q][e + 1]);
    }
  }
  __syncthreads();
  float* ub = ut + cbase * kHead * kHead;
  for (int idx = threadIdx.x; idx < kHead * kHead / 4; idx += kThreads) {
    const int j = idx / (kHead / 4);
    const int m = idx % (kHead / 4) * 4;
    *reinterpret_cast<float4*>(ub + j * kHead + m) = ld4(uo + j * kLd + m);
  }
}

// -- pass 2: the state, in order over chunks ---------------------------------

// grid (16 tiles of 16 x 16, H, B): thread (a, c) carries element (j0 + a,
// m0 + c) of the transposed state through the chunks
__global__ void __launch_bounds__(kThreads)
    wkv_state_pass_kernel(float* __restrict__ ut,
                          const float* __restrict__ dec,
                          const float* __restrict__ s0,
                          float* __restrict__ s_out, int n_chunks) {
  __shared__ float tile[16][17];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_heads = gridDim.y;
  const int j0 = (blockIdx.x >> 2) * 16;
  const int m0 = (blockIdx.x & 3) * 16;
  const int a = threadIdx.x >> 4;
  const int c = threadIdx.x & 15;
  const long long bh = (static_cast<long long>(b) * n_heads + h) * kHead
                       * kHead;
  // s0 and s_out are [m][j], the scratch [j][m]
  tile[a][c] = s0 != nullptr ? s0[bh + (m0 + a) * kHead + j0 + c] : 0.f;
  __syncthreads();
  float s = tile[c][a];
  const long long first = static_cast<long long>(b) * n_chunks * n_heads + h;
  float* ub = ut + first * kHead * kHead + (j0 + a) * kHead + m0 + c;
  const float* dk = dec + first * kHead + m0 + c;
  const long long u_step = static_cast<long long>(n_heads) * kHead * kHead;
  const long long d_step = static_cast<long long>(n_heads) * kHead;
  constexpr int kAhead = 16;  // chunks whose U and e^{lc} load together
  for (int k0 = 0; k0 < n_chunks; k0 += kAhead) {
    float uk[kAhead], ek[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool in = k0 + i < n_chunks;
      uk[i] = in ? ub[(k0 + i) * u_step] : 0.f;
      ek[i] = in ? dk[(k0 + i) * d_step] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k0 + i >= n_chunks) break;
      ub[(k0 + i) * u_step] = s;
      // S * exp(lc) + U, rounded as the reference rounds it (no fma)
      s = __fadd_rn(__fmul_rn(s, ek[i]), uk[i]);
    }
  }
  __syncthreads();  // every thread has read its carry-in from the tile
  tile[c][a] = s;
  __syncthreads();
  s_out[bh + (m0 + a) * kHead + j0 + c] = tile[a][c];
}

// -- pass 3: outputs ---------------------------------------------------------

// Shared memory of pass 3: first one region that holds the cumsums until
// the factors and the diagonal blocks are done, and then S_in; then f32
// tiles, then T:
//   li, lx, ev [cp][kLd]       cumsums of lw (inclusive, exclusive), e^{li -
//                              lx}
//   sp [3][kHead][kLd] bf16    S_in^T in bf16 pieces, over li, lx and ev
//   ro [cp][kLd]               r e^{lx - lx_16i} in tile row i (lx_0 = 0)
//   ge [n][kHead]              e^{lx_16i}, which scales ro to r e^{lx}
//   ko [8 n (n - 1)][kLd]      tile row i's k e^{lx_16i - li}, rows 0 ..
//                              16 i - 1, from row 8 i (i - 1) (n = cp / 16)
//   rh, kh [8 n][kLd]          diagonal tile i's r e^{lx - lx_16i+8} (rows
//                              16 i + 8 ..) and k e^{lx_16i+8 - li} (rows
//                              16 i .. 16 i + 7), from row 8 i
//   am [cp][cp + kPad]         A (its first floats hold the scan's sums)
//   us [kHead]                 u
//   rs, ks [cp][kLd]; vt [kHead][cp + kPad]   r, k, v^T
__host__ __device__ constexpr int ko_rows(int n_tiles) {
  return 8 * n_tiles * (n_tiles - 1);
}

__host__ __device__ size_t cumsum_region_bytes(int cp) {
  const size_t cums = 3 * cp * kLd * sizeof(float);
  const size_t pieces = kFactorPieces * kHead * kLd * sizeof(__nv_bfloat16);
  return cums > pieces ? cums : pieces;
}

template <typename T>
size_t out_smem_bytes(int cp) {
  const size_t ldc = cp + kPad;
  return cumsum_region_bytes(cp)
         + ((2 * cp + ko_rows(cp / 16)) * kLd + cp * ldc
            + (cp / 16 + 1) * kHead) * sizeof(float)
         + (2 * cp * kLd + kHead * ldc) * sizeof(T);
}

// three bf16 blocks (24 warps) share an SM, at no more than 80 registers a
// thread
template <typename T>
constexpr int kOutMinBlocks = sizeof(T) == 2 ? 3 : 2;

template <typename T>
__global__ void __launch_bounds__(kThreads, kOutMinBlocks<T>)
    wkv_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ lw,
                         const float* __restrict__ u,
                         const float* __restrict__ s_in, T* __restrict__ y,
                         int seq, int chunk, long long r_sb, long long r_st,
                         long long r_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long w_sb, long long w_st,
                         long long w_sh, long long y_sb, long long y_st,
                         long long y_sh) {
  constexpr int NI = Pieces<T>::kIn;
  constexpr int NF = kFactorPieces;
  const int cp = round16(chunk);
  const int n_rt = cp / 16;
  const int ldc = cp + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* li = reinterpret_cast<float*>(smem_raw);
  float* lx = li + cp * kLd;
  float* ev = lx + cp * kLd;
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int sp_piece = kHead * kLd;
  float* ro = reinterpret_cast<float*>(smem_raw + cumsum_region_bytes(cp));
  float* ge = ro + cp * kLd;
  float* ko = ge + n_rt * kHead;
  float* rh = ko + ko_rows(n_rt) * kLd;
  float* kh = rh + 8 * n_rt * kLd;  // after rh: see the diagonal tasks
  float* am = kh + 8 * n_rt * kLd;
  float* us = am + cp * ldc;
  T* rs = reinterpret_cast<T*>(us + kHead);
  T* ks = rs + cp * kLd;
  T* vt = ks + cp * kLd;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kc = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int n_heads = gridDim.y;
  const int t0 = kc * chunk;
  const int nv = min(chunk, seq - t0);
  const long long cbase =
      (static_cast<long long>(b) * n_chunks + kc) * n_heads + h;
  {
    TileLoad<T, false, kTilePieces<T>> lr, lk;
    TileLoad<T, true, kTilePieces<T>> lv;
    TileLoad<float, false, kTilePieces<float>> ll;
    lr.load(r + b * r_sb + t0 * r_st + h * r_sh, r_st, nv, kHead, cp, kHead);
    lk.load(k + b * k_sb + t0 * k_st + h * k_sh, k_st, nv, kHead, cp, kHead);
    lv.load(v + b * v_sb + t0 * v_st + h * v_sh, v_st, nv, kHead, cp, kHead);
    ll.load(lw + b * w_sb + t0 * w_st + h * w_sh, w_st, nv, kHead, cp,
            kHead);
    if (threadIdx.x < kHead) us[threadIdx.x] = u[h * kHead + threadIdx.x];
    lr.commit(rs, kLd);
    lk.commit(ks, kLd);
    lv.commit(vt, ldc);
    ll.commit(li, kLd);
  }
  __syncthreads();
  scan_columns(li, lx, ev, am, cp);

  // the factors, each exp once: in tile row i, r e^{lx - lx_16i} and
  // e^{lx_16i}; in each diagonal tile's lower half r e^{lx - lx_16i+8} and
  // in its upper half k e^{lx_16i+8 - li}; then tile row i's k e^{lx_16i -
  // li} for s < 16 i
#pragma unroll 4
  for (int idx = threadIdx.x; idx < cp * kHead; idx += kThreads) {
    const int t = idx / kHead;
    const int m = idx % kHead;
    const int top = t & ~15;
    const float rv = to_f32(rs[t * kLd + m]);
    const float x = lx[t * kLd + m];
    const float mid = lx[(top + 8) * kLd + m];
    const int half = (top >> 1) + (t & 7);
    ro[t * kLd + m] = rv * expf(x - lx[top * kLd + m]);
    if (t == top) ge[(top >> 4) * kHead + m] = expf(x);
    if (t & 8)
      rh[half * kLd + m] = rv * expf(x - mid);
    else
      kh[half * kLd + m] =
          to_f32(ks[t * kLd + m]) * expf(mid - li[t * kLd + m]);
  }
  for (int i = 1; i < n_rt; ++i) {
    const float* ref = lx + 16 * i * kLd;
    float* dst = ko + ko_rows(i) * kLd;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < 16 * i * kHead; idx += kThreads) {
      const int s = idx / kHead;
      const int m = idx % kHead;
      dst[s * kLd + m] =
          to_f32(ks[s * kLd + m]) * expf(ref[m] - li[s * kLd + m]);
    }
  }
  // A on the diagonal 8 x 8 blocks, s < t: e^{lx_t - li_s} is the product
  // of e^{li_r - lx_r} over s < r < t (lx_r is li_{r - 1}, so the sum of
  // exponents telescopes; each factor is <= 1), one multiply a step as s
  // falls from t - 1.  A group of 16 lanes (four columns each) takes rows
  // rp and 8 - rp of a block, eight steps in all (row 4 alone: its second
  // four steps are not stored), so every warp runs the same steps.
  const int n_groups = cp / 2;  // four per 8-row block
  for (int base = 0; base < 16 * n_groups; base += kThreads) {
    const int grp = (base + threadIdx.x) >> 4;
    const bool valid = grp < n_groups;
    const int c0 = 4 * (threadIdx.x & 15);
    const int b0 = (grp >> 2) * 8;
    const int rp = (grp & 3) + 1;
    float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 d = rv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool first = j < rp;
      const int t = b0 + (first ? rp : 8 - rp);
      const int s = b0 + (first ? rp - 1 - j : 7 - j);
      float a = 0.f;
      if (valid) {
        if (j == 0 || j == rp) {
          rv = ld4(rs + t * kLd + c0);
          d = make_float4(1.f, 1.f, 1.f, 1.f);
        } else {
          const float4 e = ld4(ev + (s + 1) * kLd + c0);
          d = make_float4(d.x * e.x, d.y * e.y, d.z * e.z, d.w * e.w);
        }
        const float4 kv = ld4(ks + s * kLd + c0);
        a = fmaf(rv.x * kv.x, d.x, a);
        a = fmaf(rv.y * kv.y, d.y, a);
        a = fmaf(rv.z * kv.z, d.z, a);
        a = fmaf(rv.w * kv.w, d.w, a);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (valid && (threadIdx.x & 15) == 0 && (first || rp < 4))
        am[t * ldc + s] = a;
    }
  }
  // the diagonal, four lanes a row; zeros above the diagonal of each
  // diagonal 16 x 16 tile
  if (threadIdx.x < 4 * cp) {  // whole warps: cp is a multiple of 16
    const int t = threadIdx.x >> 2;
    const int q = threadIdx.x & 3;
    float a = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int m = 16 * c4 + 4 * q;
      const float4 rv = ld4(rs + t * kLd + m);
      const float4 kv = ld4(ks + t * kLd + m);
      const float4 uu = ld4(us + m);
      a = fmaf(rv.x * uu.x, kv.x, a);
      a = fmaf(rv.y * uu.y, kv.y, a);
      a = fmaf(rv.z * uu.z, kv.z, a);
      a = fmaf(rv.w * uu.w, kv.w, a);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if (q == 0) am[t * ldc + t] = a;
  }
  for (int idx = threadIdx.x; idx < n_rt * 256; idx += kThreads) {
    const int tile = idx >> 8;
    const int tl = (idx >> 4) & 15;
    const int sl = idx & 15;
    if (sl > tl) am[(tile * 16 + tl) * ldc + tile * 16 + sl] = 0.f;
  }
  __syncthreads();

  // S_in^T, into the cumsums' region (no longer read) while the products
  // below A's diagonal blocks run.  Task i < n_rt is diagonal tile i's
  // lower-left 8 x 8 block, (r e^{lx - lx_16i+8}) (k e^{lx_16i+8 - li})^T
  // on the fragment's rows g (its rows g + 8 read the next rows of rh, or
  // kh's first, and are not used); task n_rt + i (i - 1) + nt is tile row
  // i's n8 tile nt of s < 16 i
  {
    TileLoad<float, false, kTilePieces<float>> ls;
    ls.load(s_in + cbase * kHead * kHead, kHead, kHead, kHead, kHead, kHead);
    for (int task = warp; task < n_rt * n_rt; task += kWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (task < n_rt) {
        const int i = task;
#pragma unroll
        for (int ks16 = 0; ks16 < kHead / 16; ++ks16) {
          uint32_t fa[NF][4];
          uint32_t fb[NF][2];
          frag_a<NF>(rh, kLd, 8 * i, ks16 * 16, fa);
          frag_b<NF>(kh, kLd, 8 * i, ks16 * 16, fb);
          mma_pieces<NF, NF>(acc, fa, fb);
        }
        *reinterpret_cast<float2*>(am + (16 * i + 8 + g) * ldc + 16 * i
                                   + 2 * tq) = make_float2(acc[0], acc[1]);
        continue;
      }
      int i = 1;
      while (n_rt + (i + 1) * i <= task) ++i;
      const int nt = task - n_rt - i * (i - 1);
      const float* kot = ko + ko_rows(i) * kLd;
#pragma unroll
      for (int ks16 = 0; ks16 < kHead / 16; ++ks16) {
        uint32_t fa[NF][4];
        uint32_t fb[NF][2];
        frag_a<NF>(ro, kLd, i * 16, ks16 * 16, fa);
        frag_b<NF>(kot, kLd, nt * 8, ks16 * 16, fb);
        mma_pieces<NF, NF>(acc, fa, fb);
      }
      float* row = am + (i * 16 + g) * ldc + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(row) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(row + 8 * ldc) = make_float2(acc[2], acc[3]);
    }
    ls.template commit_pieces<NF>(sp, kLd, sp_piece);
  }
  __syncthreads();

  // y = (r e^{lx}) S_in + A v: task (tile row i, 16 columns of y), r e^{lx}
  // as ro scaled by e^{lx_16i}
  T* yb = y + b * y_sb + h * y_sh;
  for (int task = warp; task < n_rt * 4; task += kWarps) {
    const int i = task >> 2;
    const int j0 = (task & 3) * 16;
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int ks16 = 0; ks16 < kHead / 16; ++ks16) {
      uint32_t fa[NF][4];
      frag_a_scaled<NF>(ro, kLd, i * 16, ks16 * 16, ge + i * kHead, fa);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t fb[NF][2];
        frag_b_pieces<NF>(sp, sp_piece, kLd, j0 + q * 8, ks16 * 16, fb);
        mma_pieces<NF, NF>(acc[q], fa, fb);
      }
    }
    for (int ks16 = 0; ks16 <= i; ++ks16) {
      uint32_t fa[NF][4];
      frag_a<NF>(am, ldc, i * 16, ks16 * 16, fa);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t fb[NI][2];
        frag_b<NI>(vt, ldc, j0 + q * 8, ks16 * 16, fb);
        mma_pieces<NF, NI>(acc[q], fa, fb);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = i * 16 + g + (e >> 1) * 8;
        if (t < nv)
          store_pair(yb + static_cast<long long>(t0 + t) * y_st + j0 + q * 8
                         + 2 * tq,
                     acc[q][e], acc[q][e + 1], true);
      }
    }
  }
}

// -- launch ------------------------------------------------------------------

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* y, float* s_out, float* ut,
           float* dec, int batch, int seq, int n_heads, int chunk,
           const long long* st, cudaStream_t stream) {
  auto k1 = wkv_chunk_state_kernel<T>;
  auto k3 = wkv_chunk_out_kernel<T>;
  static size_t allowed1[kMaxDevices] = {};  // per instantiation
  static size_t allowed3[kMaxDevices] = {};
  cudaError_t err = allow_smem(k1, state_smem_bytes<T>(kMaxChunk), allowed1);
  if (err == cudaSuccess)
    err = allow_smem(k3, out_smem_bytes<T>(kMaxChunk), allowed3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (seq + chunk - 1) / chunk;
  const int cp = round16(chunk);
  const dim3 grid(n_chunks, n_heads, batch);
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  k1<<<grid, kThreads, state_smem_bytes<T>(cp), stream>>>(
      kp, vp, lw, ut, dec, seq, chunk, st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_state_pass_kernel<<<dim3(16, n_heads, batch), kThreads, 0, stream>>>(
      ut, dec, s0, s_out, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<grid, kThreads, out_smem_bytes<T>(cp), stream>>>(
      rp, kp, vp, lw, u, ut, static_cast<T*>(y), seq, chunk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v [B, T, H, K] of one dtype (0 = float32, 1 = bfloat16), lw
// [B, T, H, K] f32, u [H, K] f32, s0 [B, H, K, K] f32 or null -> y
// [B, T, H, K] (r's dtype), s_out [B, H, K, K] f32.  `strides` holds the
// (b, t, h) element strides of r, k, v, lw and y, in that order (15
// values); the last dimension of each is contiguous.  ut [B, n_chunks, H,
// K, K] and dec [B, n_chunks, H, K] are f32 scratch (n_chunks =
// ceil(T / chunk)).  Launches the three passes on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const float* lw, const float* u,
                                const float* s0, void* y, float* s_out,
                                void* ut, void* dec, int dtype, int batch,
                                int seq, int n_heads, int head_size,
                                int chunk, const long long* strides,
                                void* stream) {
  if (batch < 1 || seq < 1 || n_heads < 1 || batch > 65535 ||
      n_heads > 65535 || chunk < 1 || chunk > kMaxChunk ||
      head_size != kHead) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto up = static_cast<float*>(ut);
  auto dp = static_cast<float*>(dec);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, s0, y, s_out, up, dp, batch, seq,
                         n_heads, chunk, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, up, dp, batch,
                                 seq, n_heads, chunk, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
