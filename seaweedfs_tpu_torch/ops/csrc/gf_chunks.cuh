// Column chunks of byte rows at any alignment, shared by K1 (gf_xor.cu) and
// K3 (gf_sel.cu).
//
// Both kernels compute out[R, B] = M (x) in[C, B] column by column: a thread
// owns the W-byte column chunk t (bytes [W t, W t + W) of every row, W = 4 NW
// with NW words) and needs that chunk from each of the C input rows. The
// rows are views with any row stride, so a row's first byte sits some
// offset o (0 <= o < W) past a W-byte boundary, and o differs from row to
// row. This header gives every row W-byte vector accesses whatever its o:
//
//   * The row is cut into its aligned W-byte blocks: block k covers the
//     row-relative bytes [W k - o, W k - o + W). A block that lies wholly
//     inside the row's span [0, B) is one vector access; the two blocks at
//     the span's ends that hold only part of it are byte accesses of their
//     in-span bytes; a block with no byte of the span is never touched.
//   * Input: the thread of chunk t loads block t; chunk t is block t's
//     bytes o..W-1 followed by block t+1's bytes 0..o-1, and block t+1 is
//     what the next lane loaded (one warp shuffle per word, then a funnel
//     shift).
//   * Output: the thread of chunk t stores the output row's block t, which
//     is the last u bytes of chunk t-1 (from the previous lane) followed by
//     the first W-u bytes of chunk t.
//
// Shuffles stay inside a warp, so when any row is misaligned ("halo"
// launch) a warp computes 32 consecutive chunks but owns only the middle
// 30: lane 0 computes the chunk before (its bytes feed lane 1's output
// block) and lane 31 the chunk after (its input block feeds lane 30). The
// halo lanes store nothing; their loads hit L1 or L2, since the neighbouring
// warp loads the same blocks. When every row and the output are W-aligned
// the launch has no halo: 32 owned chunks a warp and no shuffle.
//
// All of a warp's lanes must run every shuffle (full mask): kernels return
// only whole warps, before the first load.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gfk {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kHaloOwned = 30;  // chunks a warp owns in a halo launch
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Each byte of x becomes 0xFF if its top bit is set, else 0x00 (prmt's
// sign-replicating byte select).
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(r) : "r"(x));
  return r;
}

// Offset of a row's first byte past a W-byte boundary.
template <int NW>
__device__ __forceinline__ int row_offset(const void* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & (4 * NW - 1));
}

struct ChunkMap {
  long long t;         // this thread's chunk
  long long first;     // the first chunk its warp owns
  bool owner;          // whether this thread's output block is stored
};

__device__ __forceinline__ ChunkMap chunk_map(bool halo) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (halo) {
    const long long first = warp * kHaloOwned;
    return {first + lane - 1, first, lane >= 1 && lane <= kHaloOwned};
  }
  return {warp * 32 + lane, warp * 32, true};
}

// Chunks that must be owned so that every output block touching [0, B) is
// stored: ceil(B / W), plus the block past the last chunk in a halo launch.
template <int NW>
__host__ __device__ __forceinline__ long long owned_chunks(long long B,
                                                           bool halo) {
  const long long n = (B + 4 * NW - 1) / (4 * NW);
  return halo ? n + 1 : n;
}

template <int NW>
__host__ __forceinline__ long long blocks_for(long long B, bool halo) {
  const long long per_warp = halo ? kHaloOwned : 32;
  const long long warps = (owned_chunks<NW>(B, halo) + per_warp - 1) / per_warp;
  return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// The aligned block whose row-relative start is `rel` (a multiple of W
// minus the row's offset), masked to the span [0, B).
template <int NW>
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ row,
                                           long long rel, long long B,
                                           uint32_t (&x)[NW]) {
  constexpr int W = 4 * NW;
  if (rel >= 0 && rel + W <= B) {
    if constexpr (NW == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + rel));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else if constexpr (NW == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + rel));
      x[0] = v.x;
      x[1] = v.y;
    } else {
      static_assert(NW == 1, "chunks are 16, 8 or 4 bytes");
      x[0] = __ldg(reinterpret_cast<const unsigned int*>(row + rel));
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) x[q] = 0u;
  if (rel >= B || rel + W <= 0) return;  // no byte of the span: untouched
  for (int i = 0; i < W; ++i) {
    const long long b = rel + i;
    if (b >= 0 && b < B) {
      x[i >> 2] |= static_cast<uint32_t>(__ldg(row + b)) << (8 * (i & 3));
    }
  }
}

template <int NW>
__device__ __forceinline__ void store_block(uint8_t* __restrict__ row,
                                            long long rel, long long B,
                                            const uint32_t (&y)[NW]) {
  constexpr int W = 4 * NW;
  if (rel >= 0 && rel + W <= B) {
    if constexpr (NW == 4) {
      *reinterpret_cast<uint4*>(row + rel) = make_uint4(y[0], y[1], y[2], y[3]);
    } else if constexpr (NW == 2) {
      *reinterpret_cast<uint2*>(row + rel) = make_uint2(y[0], y[1]);
    } else {
      *reinterpret_cast<unsigned int*>(row + rel) = y[0];
    }
    return;
  }
  if (rel >= B || rel + W <= 0) return;
  for (int i = 0; i < W; ++i) {
    const long long b = rel + i;
    if (b >= 0 && b < B) {
      row[b] = static_cast<uint8_t>(y[i >> 2] >> (8 * (i & 3)));
    }
  }
}

// w = the W bytes of lo || hi that start at byte `start` (0 < start < W).
template <int NW>
__device__ __forceinline__ void take(const uint32_t (&lo)[NW],
                                     const uint32_t (&hi)[NW], int start,
                                     uint32_t (&w)[NW]) {
  uint32_t z[2 * NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    z[q] = lo[q];
    z[NW + q] = hi[q];
  }
  const int s = start >> 2;
  const unsigned sh = 8u * static_cast<unsigned>(start & 3);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (s == k) {  // uniform: start is the same in every lane
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        w[q] = __funnelshift_r(z[k + q], z[k + q + 1], sh);
      }
    }
  }
}

// Chunk t of an input row with offset o, from block t (x, this lane's load)
// and block t+1 (the next lane's). Every lane of the warp calls it with the
// same o.
template <int NW>
__device__ __forceinline__ void chunk_in(const uint32_t (&x)[NW], int o,
                                         uint32_t (&w)[NW]) {
  if (o == 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = x[q];
    return;
  }
  uint32_t next[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) next[q] = __shfl_down_sync(kFullMask, x[q], 1);
  take<NW>(x, next, o, w);
}

// Store output block t of a row whose first byte sits u past a W-byte
// boundary, from chunk t (a, this lane's) and chunk t-1 (the previous
// lane's). Every lane calls it; only owners store.
template <int NW>
__device__ __forceinline__ void chunk_out(uint8_t* __restrict__ row,
                                          const ChunkMap& m, long long B,
                                          const uint32_t (&a)[NW]) {
  constexpr int W = 4 * NW;
  const int u = row_offset<NW>(row);
  if (u == 0) {
    if (m.owner) store_block<NW>(row, m.t * W, B, a);
    return;
  }
  uint32_t prev[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) prev[q] = __shfl_up_sync(kFullMask, a[q], 1);
  uint32_t y[NW];
  take<NW>(prev, a, W - u, y);
  if (m.owner) store_block<NW>(row, m.t * W - u, B, y);
}

// Whether a launch needs the halo: some input row or output row does not
// start on a W-byte boundary.
template <int NW>
__host__ __forceinline__ bool needs_halo(const void* in, long long ld_in,
                                         int rows_in, const void* out,
                                         long long ld_out, int rows_out) {
  constexpr long long mask = 4 * NW - 1;
  return ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
          mask) != 0 ||
         (rows_in > 1 && (ld_in & mask) != 0) ||
         (rows_out > 1 && (ld_out & mask) != 0);
}

}  // namespace gfk
