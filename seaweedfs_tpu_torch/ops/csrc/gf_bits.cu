// K2: bitsliced GF(2) form of the GF(2^8) matrix product on Hopper's tensor
// cores (sm_90a): a 1-bit AND-popcount MMA.
//
//   out[R, B] = M[R, C] (x) in[C, B]   over GF(2^8)/0x11D, byte columns.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py `_kernel` (launched
// by `gf_matmul_bits_pallas`), which unpacks the data into int8 bit planes,
// takes an int32 dot with the bit matrix Mb[8R, 8C] on the MXU and keeps
// `acc & 1`.
//
// What it computes. Mb (gf_matrix_to_bits) has row 8r+i, column 8c+j = bit i
// of M[r,c] * 2^j. For a byte column b let x be its 8C-bit vector, bit 8c+j
// = bit j of in[c, b]. Then bit i of out[r, b] = popc(Mb[8r+i] & x) & 1.
// Word w of x needs no gather: it is bytes 4w..4w+3 of the column, byte c at
// bits 8(c % 4). That is the b1 operand of
// `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`, whose result
// is popc(a & b) summed over K, so `acc & 1` is the output bit.
//
// Orientation. M (16 rows) = byte columns, N (8 columns) = the 8 bit rows
// of one output byte, K = 256 bits = 32 input rows a k-step (S = ceil(C/32)
// steps). One MMA gives one output row for 16 columns, so any R (odd, 1,
// 14) takes R MMAs and nothing is padded. A warp takes 32 columns as two M
// tiles, rows g and g+8 being columns 4g, 4g+2 in one and 4g+1, 4g+3 in the
// other: lane (g, t) reads one 32-bit word (columns 4g..4g+3) of each of
// its input rows and transposes the 4 x 4 bytes with byte permutes into the
// four column words of its A fragments, which serve all R rows. In the
// accumulators lane (g, t) holds bits 2t, 2t+1 of those four columns, so
// two ORs of shuffles across the lane quad give the 32-bit word of output
// columns 4g..4g+3. (With bit rows on M, bit i of a byte would sit in lane
// 4i + t and every byte would be a gather across 8 lanes.)
//
// The matrix is packed once per operand by the wrapper (ops/rs_bits.py
// `mma_words`), in fragment order: word [r][s][lane][h] = bits 32w..32w+31 of
// Mb row 8r + lane/4, w = 8s + 4h + lane%4, zero past column 8C. Each lane
// loads its two words a (r, s) with one 8-byte load; with R * S <= 8 they
// stay in registers. Since the words are zero past 8C, input rows past C
// may hold anything: they are neither zeroed nor masked.
//
// Memory. A block takes a tile of T columns [b0, b0 + T) and computes
// [b0 - 32, b0 + T): output rows start at any offset u (0..15) past a
// 16-byte boundary, and the block stores the aligned output blocks that
// start in [b0 - u, b0 + T - u), so each block of a row is stored by exactly
// one tile. A warp stages an input row: lane k loads the aligned 16-byte
// block k (gf_chunks.cuh load_block: byte loads only at a span's two ends,
// no block outside it touched), takes block k + 1 from the next lane and
// funnel-shifts, so shared [C][T + 40] holds every row realigned. Output
// words collect in shared [R][T + 48] and leave as aligned 16-byte stores
// (store_block), each realigned to its row's u from five shared words. T is
// the largest of 1024..32 whose tiles fit 48 KB of shared memory (T = 32 at
// C = R = 256, so no launch needs an opt-in) and, where B allows, give
// every SM two blocks (T = 1024 at B = 1 MiB, 64 at a 24 KiB degraded read).
//
// What bounds it. The function moves (C + R) * B bytes: 0.004382 ms for
// RS(10,4) at B = 1 MiB on an H100 SXM (3.35 TB/s). Measured on an NVIDIA
// H100 80GB HBM3 at a 700.00 W power limit (chip_smoke.py, PERF.md):
// encode [4,10] x 1 MiB 0.020864 ms, rebuild [3,10] 0.019200, [4,10] x
// (6 MiB + 4093) 0.089824, [1,10] x 24,584 B 0.008576 (an empty kernel
// 0.004896). Not the MMA (replaced by popc it is slower, k2_variants.py):
// staging and stores take about 0.007 ms and building fragments and
// packing bytes about 0.009, one after the other, since a block stages,
// computes and stores in turn and at 1 MiB all blocks run in one wave.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gf_chunks.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 8;        // k-steps: C <= 256
constexpr int kRegFrags = 8;    // R * S <= 8: B fragments in registers
constexpr int kMaxTile = 1024;
constexpr int kMinTile = 32;
constexpr size_t kSmemBudget = 48 * 1024;

// Input rows in shared memory: T + 32 columns, pitch = 8 (mod 32) words so
// that the four t of a warp, reading rows 4 apart, hit different banks.
__host__ __device__ __forceinline__ int in_pitch(int T) { return T + 40; }
// Output rows: T + 32 columns and the word past a realigned read.
__host__ __device__ __forceinline__ int out_pitch(int T) { return T + 48; }

// Input rows staged: C rounded up to 16 (a k-step half). Rows past C are
// never written: the packed matrix is zero there, so whatever they hold
// adds nothing to popc(a & b).
__host__ __device__ __forceinline__ size_t out_offset(int C, int T) {
  return static_cast<size_t>((C + 15) & ~15) * in_pitch(T);
}

size_t tile_smem(int R, int C, int T) {
  return out_offset(C, T) + static_cast<size_t>(R) * out_pitch(T);
}

// The largest tile whose shared memory fits the budget and, where B allows,
// that still gives every SM two blocks: a block's phases run one after the
// other, so a narrow product (a degraded read's interval) needs many small
// blocks rather than a few large ones.
int tile_for(int R, int C, long long B, int sms) {
  int T = kMaxTile;
  while (T > kMinTile && (tile_smem(R, C, T) > kSmemBudget ||
                          (B + T - 1) / T < 2LL * sms)) {
    T /= 2;
  }
  return T;
}

__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output row for the warp's 32 columns: d1 from the tile whose rows
// g, g+8 are columns 4g, 4g+2, d2 from the one with columns 4g+1, 4g+3.
// Lane (g, t) holds bits 2t, 2t+1 of each; two ORs across the quad make
// the word of columns 4g..4g+3, which lane t = 0 writes.
__device__ __forceinline__ void store_row(const int (&d1)[4],
                                          const int (&d2)[4], int t,
                                          uint32_t* dst) {
  auto bit = [](int x) { return static_cast<uint32_t>(x) & 1u; };
  uint32_t v = bit(d1[0]) | bit(d1[1]) << 1 | bit(d2[0]) << 8 |
               bit(d2[1]) << 9 | bit(d1[2]) << 16 | bit(d1[3]) << 17 |
               bit(d2[2]) << 24 | bit(d2[3]) << 25;
  v <<= 2 * t;
  v |= __shfl_xor_sync(gfk::kFullMask, v, 1);
  v |= __shfl_xor_sync(gfk::kFullMask, v, 2);
  if (t == 0) *dst = v;
}

template <int S, bool kRegB>
__global__ void __launch_bounds__(kThreads)
gf_bits_kernel(const uint2* __restrict__ words,  // [R][S][32] (h = .x, .y)
               const uint8_t* __restrict__ in, long long ld_in,
               uint8_t* __restrict__ out, long long ld_out, int R, int C,
               long long B, int T) {
  extern __shared__ uint4 smem[];
  uint8_t* s_in = reinterpret_cast<uint8_t*>(smem);
  const int P = in_pitch(T);
  const int Q = out_pitch(T);
  uint8_t* s_out = s_in + out_offset(C, T);
  const long long b0 = static_cast<long long>(blockIdx.x) * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // Stage, realigned: chunk k of row c (tile columns 16k - 32 .. 16k - 17)
  // lands at s_in[c][16k], so column x (-32 <= x < T) is at s_in[c][x + 32].
  // A warp takes a row; lane k loads aligned block k, which starts o bytes
  // before chunk k, and takes block k + 1 from the next lane (lane 31 loads
  // it itself).
  const int nch = T / 16 + 2;
  for (int c = warp; c < C; c += kWarps) {
    const uint8_t* row = in + c * ld_in;
    const int o = gfk::row_offset<4>(row);
    const long long rel0 = b0 - 32 - o;  // block k starts at rel0 + 16k
    for (int k0 = 0; k0 < nch; k0 += 32) {
      const int k = k0 + lane;
      uint32_t x[4] = {0u, 0u, 0u, 0u};
      if (k < nch + (o != 0)) gfk::load_block<4>(row, rel0 + 16LL * k, B, x);
      uint32_t w[4];
      if (o == 0) {  // warp-uniform
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = x[q];
      } else {
        uint32_t nx[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          nx[q] = __shfl_down_sync(gfk::kFullMask, x[q], 1);
        }
        if (lane == 31 && k < nch) {
          gfk::load_block<4>(row, rel0 + 16LL * (k + 1), B, nx);
        }
        gfk::take<4>(x, nx, o, w);
      }
      if (k < nch) {
        uint2* dst = reinterpret_cast<uint2*>(s_in + c * P + 16 * k);
        dst[0] = make_uint2(w[0], w[1]);
        dst[1] = make_uint2(w[2], w[3]);
      }
    }
  }
  uint2 breg[kRegB ? kRegFrags : 1];
  if constexpr (kRegB) {
#pragma unroll
    for (int k = 0; k < kRegFrags; ++k) {
      breg[k] = k < R * S ? __ldg(words + 32 * k + lane) : make_uint2(0u, 0u);
    }
  }
  __syncthreads();

  // A warp takes 32 columns at a time (group G: tile columns 32G - 32 ..
  // 32G - 1) as two MMA tiles. Lane (g, t) reads, for each of its input
  // rows 32s + 16h + 4t + q, the word of columns 4g..4g+3, and transposes
  // the 4 x 4 bytes into the four columns' words (byte q = row q).
  const uint8_t* lane_in = s_in + 4 * t * P + 4 * g;
  const int n_grp = T / 32 + 1;
  for (int G = warp; G < n_grp; G += kWarps) {
    uint32_t a1[S][4], a2[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t col[4] = {0u, 0u, 0u, 0u};
        if (32 * s + 16 * h < C) {  // warp-uniform
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w[q] = *reinterpret_cast<const uint32_t*>(
                lane_in + (32 * s + 16 * h + q) * P + 32 * G);
          }
          const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
          const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
          const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
          const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
          col[0] = __byte_perm(lo01, lo23, 0x5410);
          col[1] = __byte_perm(lo01, lo23, 0x7632);
          col[2] = __byte_perm(hi01, hi23, 0x5410);
          col[3] = __byte_perm(hi01, hi23, 0x7632);
        }
        a1[s][2 * h] = col[0];      // row g: column 4g
        a1[s][2 * h + 1] = col[2];  // row g + 8: column 4g + 2
        a2[s][2 * h] = col[1];      // column 4g + 1
        a2[s][2 * h + 1] = col[3];  // column 4g + 3
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_out + 32 * G + 4 * g);
    if constexpr (kRegB) {
#pragma unroll
      for (int r = 0; r < kRegFrags / S; ++r) {
        if (r < R) {
          int d1[4] = {0, 0, 0, 0}, d2[4] = {0, 0, 0, 0};
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const uint2 b = breg[r * S + s];
            mma_and_popc(d1, a1[s], b.x, b.y);
            mma_and_popc(d2, a2[s], b.x, b.y);
          }
          store_row(d1, d2, t, dst + r * (Q / 4));
        }
      }
    } else {
      for (int r = 0; r < R; ++r) {
        int d1[4] = {0, 0, 0, 0}, d2[4] = {0, 0, 0, 0};
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint2 b = __ldg(words + 32 * (r * S + s) + lane);
          mma_and_popc(d1, a1[s], b.x, b.y);
          mma_and_popc(d2, a2[s], b.x, b.y);
        }
        store_row(d1, d2, t, dst + r * (Q / 4));
      }
    }
  }
  __syncthreads();

  // Store: block j of output row r starts at row-relative b0 - u + 16j,
  // tile column 16j - u, which is s_out[r][16j - u + 32]: realigned from
  // five words by funnel shifts, then one aligned 16-byte store.
  const int oblk = T / 16;
  for (int i = threadIdx.x; i < R * oblk; i += kThreads) {
    const int r = i / oblk;
    const int j = i - r * oblk;
    uint8_t* row = out + r * ld_out;
    const int u = gfk::row_offset<4>(row);
    const int idx = 16 * j - u + 32;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(s_out + r * Q) + (idx >> 2);
    const unsigned sh = 8u * static_cast<unsigned>(idx & 3);
    uint32_t y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = __funnelshift_r(src[q], src[q + 1], sh);
    gfk::store_block<4>(row, b0 - u + 16LL * j, B, y);
  }
}

template <int S, bool kRegB>
cudaError_t launch(const void* words, const void* in, long long ld_in,
                   void* out, long long ld_out, int R, int C, long long B,
                   int T, unsigned blocks, cudaStream_t stream) {
  gf_bits_kernel<S, kRegB><<<blocks, kThreads, tile_smem(R, C, T), stream>>>(
      static_cast<const uint2*>(words), static_cast<const uint8_t*>(in),
      ld_in, static_cast<uint8_t*>(out), ld_out, R, C, B, T);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_s(const void* words, const void* in, long long ld_in,
                     void* out, long long ld_out, int R, int C, long long B,
                     int T, unsigned blocks, cudaStream_t stream) {
  if (R * S <= kRegFrags) {
    return launch<S, true>(words, in, ld_in, out, ld_out, R, C, B, T, blocks,
                           stream);
  }
  return launch<S, false>(words, in, ld_in, out, ld_out, R, C, B, T, blocks,
                          stream);
}

}  // namespace

extern "C" {

// Shared memory a block of an [R, C] product takes at most (48 KB or less;
// a narrow product takes a smaller tile).
long long gf_bits_smem_bytes(int R, int C) {
  return static_cast<long long>(tile_smem(R, C, tile_for(R, C, 0, 0)));
}

// Largest dynamic shared memory a block may opt in to on `device`.
int gf_bits_smem_limit(int device, int* limit) {
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// out[R, B] (row stride ld_out bytes) = M (x) in[C, B] (row stride ld_in),
// with M given as its packed MMA words (`words`, uint32 [R][ceil(C/32)][32]
// [2], see the header). Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not sync.
int gf_bits_launch(const void* words, const void* in, long long ld_in,
                   void* out, long long ld_out, int R, int C, long long B,
                   int device, void* stream) {
  if (R <= 0 || C <= 0 || B <= 0 || R > 256 || C > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int T = tile_for(R, C, B, sms);
  // a tile stores the output blocks starting in [b0 - u, b0 + T - u): with
  // any row off a 16-byte boundary, the last block may start past B - T
  const bool misaligned = (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
                          (R > 1 && (ld_out & 15) != 0);
  const long long tiles = (B + (misaligned ? 15 : 0) + T - 1) / T;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(tiles);
  // one instantiation per k-step count S = ceil(C / 32)
  using Launch = cudaError_t (*)(const void*, const void*, long long, void*,
                                 long long, int, int, long long, int,
                                 unsigned, cudaStream_t);
  constexpr Launch kLaunch[kMaxS] = {launch_s<1>, launch_s<2>, launch_s<3>,
                                     launch_s<4>, launch_s<5>, launch_s<6>,
                                     launch_s<7>, launch_s<8>};
  e = kLaunch[(C + 31) / 32 - 1](words, in, ld_in, out, ld_out, R, C, B, T,
                                 nb, s);
  return static_cast<int>(e);
}

const char* gf_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
