// Causal GQA flash attention (forward) as CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_hm`): online softmax with f32
// running max m, sum l and accumulator acc; key tiles past the causal
// frontier are never visited; query head h reads KV head h / group.  Keys
// at or past S are masked (scores NEG_INF, K/V rows read as 0), and rows at
// or past S are computed but not stored, so S need not be a multiple of
// any tile.  NEG_INF = -1e30 and the final max(l, 1e-30) clamp are the
// reference's.
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
// S < ~1180, the tensor cores' 989 TFLOP/s bound longer prompts.  At the
// served shapes (B = 1, S <= 1500: 208-750 blocks of 64 query rows, a few
// key tiles each) neither floor is near: what bounds the kernel is
// occupancy and its memory pipeline (global -> shared copies, then the
// shared-memory traffic of every warp reading every K and V fragment for
// its 16 rows), not the tensor cores' rate.  So the bf16 kernel below is
// built the FlashAttention-2 way with warp-level `mma.sync`, and `wgmma`
// fed by TMA (B read from shared memory once per 64-row warpgroup) is the
// step after it.
//
// Two kernels, one per dtype:
//   * bf16 (the served path): `flash_attention_tc_kernel`.  A block of 4
//     warps owns 64 query rows, 16 per warp.  The query tile arrives by
//     16-byte `cp.async` copies and moves into registers as `ldmatrix` A
//     fragments, where it stays.  K and V tiles of 64 rows go through a
//     three-stage `cp.async` ring in shared memory (the copies of tile
//     kt + 2 start before the math of tile kt, after the one barrier per
//     tile), rows padded by 8 bf16 so that the 8 row addresses of every
//     `ldmatrix` (`.trans` for V) fall in distinct banks.  S = Q.K^T is
//     `mma.sync.m16n8k16` bf16 -> f32 into registers; the row max is
//     reduced over the 4-lane quad with shuffles, l is kept per thread and
//     reduced once at the end; p is packed to bf16 straight
//     from the S accumulators as the A operand of P.V (no trip through
//     shared memory), and acc, m and l stay f32.  Rounding p to bf16 before
//     P.V is a divergence from the Pallas kernel, which keeps p in f32; the
//     reference's own XLA model path rounds the probabilities to the
//     activation dtype at the same point.  Shared memory: 3 stages x (K, V)
//     x 64 x (Dh + 8) bf16, 104 KB at Dh = 128 (the query tile borrows the
//     last stage); with 205 registers there, two blocks per SM.  At Dh =
//     256, two stages and a query slot of their own (169 KB, see TcTile).
//   * f32 (the exactness checks): `flash_attention_simt_kernel`, the
//     CUDA-core kernel of the port's first version, unchanged in its
//     arithmetic: q, k, v and p f32 in shared memory, fmaf products, one
//     block of 256 threads per (b, h, 64-row query tile), m, l and acc in
//     registers.  It holds 1e-4 against the plain version, which TF32 or
//     bf16 tensor-core products could not.
// In both, query tiles are scheduled longest first (the last query tile
// sees the most keys); the bf16 kernel's grid is (H, tiles, B), so that
// the longest tiles of all heads go before any head's shorter ones (25 %
// faster than (tiles, H, B) at S = 1500, 14 % at S = 777, measured on the
// H100).  Head dims 32, 64, 80 (zamba2's shared attention), 128 and 256
// (gemma-2b) are built for each dtype; the wrapper
// (repro_torch/kernels/flash_attention/kernel.py) refuses any other, and
// bf16 inputs whose pointers or (b, s, h) strides are not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block (both kernels)

// -- f32: the CUDA-core kernel ---------------------------------------------

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int DH, int BK>
constexpr size_t smem_floats() {
  return kBQ * (DH + 1) + BK * (DH + 1) + BK * DH + kBQ * (BK + 1);
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_simt_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ o,
                                int seq, int group, long long q_sb,
                                long long q_ss, long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, long long o_sb,
                                long long o_ss, long long o_sh, float scale) {
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

// -- bf16: the tensor-core kernel -------------------------------------------

constexpr int kTcWarps = 4;                // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kBKV = 64;                   // key rows per K/V tile
// Two resident blocks per SM.  It sets no tighter register cap than the
// 255 a thread may have, yet it changes ptxas's choice: without it the
// compiler holds Dh = 128 to 182 registers (205 with it) and the kernel
// runs 10-25 % slower at the served shapes (measured on the H100).
constexpr int kTcMinBlocks = 2;

template <int DH>
struct TcTile {
  // Up to Dh = 128: three K/V stages (in flight or ready), the query tile
  // borrowing the last stage's K slot, its fragments kept in registers.
  // At Dh = 256 a stage is 67.6 KB and O alone takes 128 f32 registers a
  // thread: two stages, and the query tile in a slot of its own, its
  // fragments read from shared memory at each k step (169 KB, one block
  // per SM)
  static constexpr int kStages = DH <= 128 ? 3 : 2;
  static constexpr bool kQInRegs = DH <= 128;
  static constexpr int kLd = DH + 8;       // padded row, bf16 elements
  static constexpr int kKSteps = DH / 16;  // k16 steps of Q.K^T over Dh
  static constexpr int kSTiles = kBKV / 8; // n8 tiles of S per warp
  static constexpr int kOTiles = DH / 8;   // n8 tiles of O per warp
  static constexpr int kPieces = DH / 8;   // 16-byte copies per row
  static constexpr int kStage = 2 * kBKV * kLd;  // K then V, elements
  static constexpr size_t kSmemBytes =
      (kStages * kStage + (kQInRegs ? 0 : kBQ * kLd)) * sizeof(__nv_bfloat16);
  static_assert(kBQ == kBKV, "the query tile is copied as a K tile is");
  static_assert(kStages >= 2, "the ring refills one stage per tile");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flush-to-zero; relative error about
// 2^-22, far inside bf16's 2^-8)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows row0 .. row0 + 63 of a [*, DH] bf16 tensor (row stride `stride`)
// into a padded tile; rows at or past `seq` are zero-filled, not read
template <int DH>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int seq) {
  using Tl = TcTile<DH>;
  for (int idx = threadIdx.x; idx < kBKV * Tl::kPieces; idx += kTcThreads) {
    const int r = idx / Tl::kPieces;
    const int e = (idx % Tl::kPieces) * 8;
    const bool in = row0 + r < seq;
    const long long row = in ? row0 + r : 0;
    cp_async16(dst + r * Tl::kLd + e, src + row * stride + e, in);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t.  The A
// fragment holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// a C fragment holds rows g and g + 8, columns 2t and 2t + 1 of its n8
// tile; a B fragment holds column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int seq,
                              int group, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, long long o_sb, long long o_ss,
                              long long o_sh, float scale_log2) {
  using Tl = TcTile<DH>;
  constexpr int LD = Tl::kLd;
  constexpr int kStages = Tl::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // grid (H, query tiles, B): blocks are dispatched x fastest, so every
  // head's longest tile goes first, then every head's next longest
  const int n_tiles = gridDim.y;
  const int q0 = (n_tiles - 1 - blockIdx.y) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  const int last_key = min(q0 + kBQ, seq) - 1;
  const int n_kt = last_key / kBKV + 1;
  // one cp.async group per tile, committed even when empty so that "tile
  // kt has landed" is always "all but the newest kStages - 2 groups" at the
  // top of iteration kt
  auto fetch = [&](int t) {
    if (t < n_kt) {
      __nv_bfloat16* st = ring + (t % kStages) * Tl::kStage;
      copy_rows<DH>(st, kb, k_ss, t * kBKV, seq);
      copy_rows<DH>(st + kBKV * LD, vb, v_ss, t * kBKV, seq);
    }
    cp_async_commit();
  };
  // the query tile borrows the last stage's K slot until its tile is
  // fetched (or, at Dh = 256, has a slot of its own after the ring)
  __nv_bfloat16* q_slot =
      ring + (Tl::kQInRegs ? kStages - 1 : kStages) * Tl::kStage;
  copy_rows<DH>(q_slot, qb, q_ss, q0, seq);
  cp_async_commit();
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  cp_async_wait<kStages - 1>();
  __syncthreads();
  const __nv_bfloat16* q_frag =
      q_slot + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[Tl::kQInRegs ? Tl::kKSteps : 1][4];
  if constexpr (Tl::kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < Tl::kKSteps; ++ks)
      ldmatrix_x4(qf[ks], q_frag + ks * 16);
  }

  float acc[Tl::kOTiles][4];
#pragma unroll
  for (int n = 0; n < Tl::kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 domain
  float l_r[2] = {0.f, 0.f};          // this thread's columns only
  const int row_g = q0 + warp * 16 + (lane >> 2);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
    // one barrier per tile: tile kt has landed for every thread, and every
    // warp is past tile kt - 1 (and, at kt = 0, the query tile), so that
    // stage may be refilled with the tile kStages - 1 ahead
    __syncthreads();
    fetch(kt + kStages - 1);
    const __nv_bfloat16* ks = ring + (kt % kStages) * Tl::kStage;
    const __nv_bfloat16* vs = ks + kBKV * LD;

    float s[Tl::kSTiles][4];
#pragma unroll
    for (int n = 0; n < Tl::kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Tl::kKSteps; ++kk) {
      uint32_t qa[4];
      if constexpr (Tl::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_frag + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < Tl::kSTiles / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }

    // scale into the log2 domain; the diagonal (last) tile also masks keys
    // past the row and past S
    const bool diag = kt == n_kt - 1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < Tl::kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kBKV + n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row_g + (e >> 1) * 8;
        float x = s[n][e] * scale_log2;
        if (diag && (col > row || col >= seq)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < Tl::kOTiles; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < Tl::kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[n][e] - m_r[e >> 1]);
        s[n][e] = p;
        l_r[e >> 1] += p;
      }
    }

    // P.V: the S accumulators of n8 tiles 2j, 2j + 1 are the A fragment of
    // key step j
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < Tl::kOTiles / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (j * 16 + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * LD
                                  + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    denom[r] = fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + r * 8;
    if (row >= seq) continue;
    __nv_bfloat16* orow = o + b * o_sb + row * o_ss + h * o_sh
                          + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < Tl::kOTiles; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] / denom[r], acc[n][2 * r + 1] / denom[r]);
    }
  }
}

// -- launch --------------------------------------------------------------

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

template <int DH, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int seq, int n_heads, int group,
               const long long* st, float scale, cudaStream_t stream) {
  auto kern = flash_attention_simt_kernel<float, DH, BK>;
  const size_t smem = smem_floats<DH, BK>() * sizeof(float);
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBQ - 1) / kBQ, n_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq, group,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int seq, int n_heads, int group,
                const long long* st, float scale, cudaStream_t stream) {
  auto kern = flash_attention_tc_kernel<DH>;
  const size_t smem = TcTile<DH>::kSmemBytes;
  static size_t allowed[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_heads, (seq + kBQ - 1) / kBQ, batch);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      seq, group, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 int batch, int seq, int n_heads, int group, int head_dim,
                 const long long* st, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_f32<32, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                                scale, stream);
    case 64:
      return launch_f32<64, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                                scale, stream);
    case 80:
      return launch_f32<80, 64>(q, k, v, o, batch, seq, n_heads, group, st,
                                scale, stream);
    case 128:
      return launch_f32<128, 32>(q, k, v, o, batch, seq, n_heads, group, st,
                                 scale, stream);
    case 256:
      return launch_f32<256, 32>(q, k, v, o, batch, seq, n_heads, group, st,
                                 scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int batch, int seq, int n_heads, int group, int head_dim,
                  const long long* st, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_bf16<32>(q, k, v, o, batch, seq, n_heads, group, st,
                             scale, stream);
    case 64:
      return launch_bf16<64>(q, k, v, o, batch, seq, n_heads, group, st,
                             scale, stream);
    case 80:
      return launch_bf16<80>(q, k, v, o, batch, seq, n_heads, group, st,
                             scale, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, batch, seq, n_heads, group, st,
                              scale, stream);
    case 256:
      return launch_bf16<256>(q, k, v, o, batch, seq, n_heads, group, st,
                              scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, S, H, Dh], k/v [B, S, KV, Dh] -> o [B, S, H, Dh], all of one dtype
// (0 = float32, 1 = bfloat16), last dimension contiguous; bf16 data 16-byte
// aligned.  `strides` holds (b, s, h) element strides of q, k, v and o, in
// that order (12 values).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int seq, int n_heads,
                                      int n_kv_heads, int head_dim,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (batch < 1 || seq < 1 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      batch > 65535 || n_heads > 65535 || seq > 65535 * kBQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, batch, seq, n_heads, group, head_dim,
                        strides, scale, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, batch, seq, n_heads, group, head_dim,
                         strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
