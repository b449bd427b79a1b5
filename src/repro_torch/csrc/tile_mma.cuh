// Building blocks of the port's tensor-core kernels for Hopper (sm_90a),
// shared by mamba2_ssd.cu and rwkv6_wkv.cu: element conversions and
// stores, bf16 pieces of f32 values, warp-level `mma.sync.m16n8k16`
// fragments and products, tile loads from device memory into shared
// memory, and the dynamic shared-memory limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads of every block that uses TileLoad
// elements per shared-memory row beyond the tile's width: a row stride of
// 8 mod 32 words (f32) or 4 mod 32 (bf16) puts a fragment load's lanes in
// distinct banks
constexpr int kPad = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// p[0] = a and, where `second`, p[1] = b, as one 8- or 4-byte store when
// p is aligned for it
__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool second) {
  if (second && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *p = a;
    if (second) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           bool second) {
  if (second && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    store(p, a);
    if (second) store(p + 1, b);
  }
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// bf16 pieces of an input of the activation type, and of an f32-valued
// factor beside it
template <typename T>
struct Pieces {
  static constexpr int kIn = sizeof(T) == 4 ? 3 : 1;
  static constexpr int kF32 = kIn > 2 ? kIn : 2;
};

// (a, b) cut into NP bf16 pieces, largest first, packed as bf16x2 (a in the
// low half) into f[i][r]
template <int NP, int R>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (*f)[R],
                                           int r) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    f[i][r] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < NP) {
      const float2 v = __bfloat1622float2(h);
      a -= v.x;
      b -= v.y;
    }
  }
}

__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// elements p[0], p[1] as NP pieces into f[.][r]; bf16 in one piece is
// loaded as it is
template <int NP, int R, typename S>
__device__ __forceinline__ void pair_pieces(const S* p, uint32_t (*f)[R],
                                            int r) {
  if constexpr (NP == 1 && sizeof(S) == 2) {
    f[0][r] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const float2 v = ld_pair(p);
    split_pair<NP>(v.x, v.y, f, r);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t.  The A
// fragment holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9
// (registers: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)); a B
// fragment holds column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9; a C
// fragment holds rows g and g + 8, columns 2t and 2t + 1 of its n8 tile.
// Shared tiles keep K contiguous: A as [m][k], B as [n][k].

// A fragment at (m0, k0) of the row-major tile s
template <int NP, typename S>
__device__ __forceinline__ void frag_a(const S* s, int ld, int m0, int k0,
                                       uint32_t (*f)[4]) {
  const int lane = threadIdx.x & 31;
  const S* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  pair_pieces<NP>(p, f, 0);
  pair_pieces<NP>(p + 8 * ld, f, 1);
  pair_pieces<NP>(p + 8, f, 2);
  pair_pieces<NP>(p + 8 * ld + 8, f, 3);
}

// A fragment at (m0, k0) of the row-major tile s, column k scaled by
// colscale[k] in f32
template <int NP, typename S>
__device__ __forceinline__ void frag_a_scaled(const S* s, int ld, int m0,
                                              int k0, const float* colscale,
                                              uint32_t (*f)[4]) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + 2 * (lane & 3);
  const S* p = s + (m0 + (lane >> 2)) * ld + k;
  const float2 lo = ld_pair(colscale + k), hi = ld_pair(colscale + k + 8);
  const float2 v[4] = {ld_pair(p), ld_pair(p + 8 * ld), ld_pair(p + 8),
                       ld_pair(p + 8 * ld + 8)};
  split_pair<NP>(v[0].x * lo.x, v[0].y * lo.y, f, 0);
  split_pair<NP>(v[1].x * lo.x, v[1].y * lo.y, f, 1);
  split_pair<NP>(v[2].x * hi.x, v[2].y * hi.y, f, 2);
  split_pair<NP>(v[3].x * hi.x, v[3].y * hi.y, f, 3);
}

// B fragment at (n0, k0) of the tile s stored [n][k]
template <int NP, typename S>
__device__ __forceinline__ void frag_b(const S* s, int ld, int n0, int k0,
                                       uint32_t (*f)[2]) {
  const int lane = threadIdx.x & 31;
  const S* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  pair_pieces<NP>(p, f, 0);
  pair_pieces<NP>(p + 8, f, 1);
}

// B fragment at (n0, k0) of NP bf16 piece tiles s[q] stored [n][k]
template <int NP>
__device__ __forceinline__ void frag_b_pieces(const __nv_bfloat16* s,
                                              int piece_stride, int ld,
                                              int n0, int k0,
                                              uint32_t (*f)[2]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    f[q][0] = *reinterpret_cast<const uint32_t*>(p + q * piece_stride);
    f[q][1] = *reinterpret_cast<const uint32_t*>(p + q * piece_stride + 8);
  }
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

// c += a . b over the piece products (i, j) with i + j < max(NA, NB),
// the smallest first
template <int NA, int NB>
__device__ __forceinline__ void mma_pieces(float* c, uint32_t (*a)[4],
                                           uint32_t (*b)[2]) {
  constexpr int n = NA > NB ? NA : NB;
#pragma unroll
  for (int d = n - 1; d >= 0; --d)
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (d - i >= 0 && d - i < NB)
        mma_bf16(c, a[i], b[d - i][0], b[d - i][1]);
}

// Rows 0 .. rows_pad - 1, columns 0 .. cols_pad - 1 of a [*, ncols] matrix
// of T (row stride `stride`; zero at rows at or past nv and columns at or
// past ncols) on their way to a shared tile of the same type: load()
// starts 16-byte loads into registers, up to kMax a thread, and commit()
// writes them to dst [row][col] (transposed: dst [col][row]), so that the
// loads can be in flight while the block computes.  Neighbouring threads
// take neighbouring pieces of a row or, transposed, neighbouring rows, so
// that the shared-memory writes spread over the banks.  Rows that are not
// whole 16-byte aligned pieces are copied by commit(), one element a
// thread, straight from device memory.
template <typename T, bool kTranspose, int kMax>
struct TileLoad {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  const T* src;
  long long stride;
  int nv, ncols, rows_pad, cols_pad;
  bool vec;
  uint4 buf[kMax];

  __device__ __forceinline__ void coords(int idx, int& i, int& j) const {
    const int vpr = cols_pad / V;
    i = kTranspose ? idx % rows_pad : idx / vpr;
    j = (kTranspose ? idx / rows_pad : idx % vpr) * V;
  }

  __device__ __forceinline__ void load(const T* src_, long long stride_,
                                       int nv_, int ncols_, int rows_pad_,
                                       int cols_pad_) {
    src = src_;
    stride = stride_;
    nv = nv_;
    ncols = ncols_;
    rows_pad = rows_pad_;
    cols_pad = cols_pad_;
    vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && stride % V == 0 &&
          ncols % V == 0;
    if (!vec) return;
    const int total = rows_pad * (cols_pad / V);
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int idx = u * kThreads + threadIdx.x;
      int i, j;
      coords(idx, i, j);
      buf[u] = idx < total && i < nv && j < ncols
                   ? *reinterpret_cast<const uint4*>(src + i * stride + j)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // dst[q] [row][col] = piece q of the f32 element (natural layout, T =
  // float): the f32 tile cut once into the pieces its B fragments take
  template <int NP>
  __device__ __forceinline__ void commit_pieces(__nv_bfloat16* dst, int ld,
                                                int piece_stride) const {
    static_assert(sizeof(T) == 4 && !kTranspose, "f32 rows only");
    const int total = rows_pad * (cols_pad / V);
    for (int u = 0; u < (vec ? kMax : 0); ++u) {
      const int idx = u * kThreads + threadIdx.x;
      if (idx >= total) break;
      int i, j;
      coords(idx, i, j);
      uint32_t f[NP][2];
      const float4 v = *reinterpret_cast<const float4*>(&buf[u]);
      split_pair<NP>(v.x, v.y, f, 0);
      split_pair<NP>(v.z, v.w, f, 1);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        *reinterpret_cast<uint2*>(dst + q * piece_stride + i * ld + j) =
            make_uint2(f[q][0], f[q][1]);
    }
    if (vec) return;
    for (int idx = threadIdx.x; idx < rows_pad * cols_pad / 2;
         idx += kThreads) {
      const int i = idx / (cols_pad / 2);
      const int j = idx % (cols_pad / 2) * 2;
      auto at = [&](int jj) {
        return i < nv && jj < ncols ? to_f32(src[i * stride + jj]) : 0.f;
      };
      uint32_t f[NP][1];
      split_pair<NP>(at(j), at(j + 1), f, 0);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        *reinterpret_cast<uint32_t*>(dst + q * piece_stride + i * ld + j) =
            f[q][0];
    }
  }

  __device__ __forceinline__ void commit(T* dst, int ld) const {
    if (!vec) {
      for (int idx = threadIdx.x; idx < rows_pad * cols_pad;
           idx += kThreads) {
        const int i = idx / cols_pad;
        const int j = idx % cols_pad;
        store(&dst[kTranspose ? j * ld + i : i * ld + j],
              i < nv && j < ncols ? to_f32(src[i * stride + j]) : 0.f);
      }
      return;
    }
    const int total = rows_pad * (cols_pad / V);
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int idx = u * kThreads + threadIdx.x;
      if (idx >= total) break;
      int i, j;
      coords(idx, i, j);
      if constexpr (kTranspose) {
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int q = 0; q < V; ++q) dst[(j + q) * ld + i] = e[q];
      } else {
        *reinterpret_cast<uint4*>(dst + i * ld + j) = buf[u];
      }
    }
  }
};

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

}  // namespace
