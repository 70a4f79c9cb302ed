// K3: xtime-select GF(2^8) matrix product for Hopper (sm_90a), with the
// matrix baked in when the library is compiled.
//
//   out[R, B] = M[R, C] (x) in[C, B]   over GF(2^8)/0x11D, byte columns.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_xor.py `_sel_kernel_factory`
// (:247; launched by `_sel_runner`, wrapper `apply_matrix_sel_pallas`).
//
// This file is a template. ops/_build.py compiles it once per matrix, in a
// generated unit that first defines, in namespace gf_matrix, the constants
// kRows, kCols and kMatrix[kRows * kCols] (and GF_MATRIX_SPECIALISED), then
// includes this file. The library is named by a hash of this file, the
// headers beside it (gf_chunks.cuh), the generated unit (which holds the
// matrix bytes) and the nvcc flags.
//
// What it computes. GF linearity gives M[r,c] * x = XOR_j bit_j(M[r,c]) 2^j x,
// so by Horner's rule over the bits, for four bytes packed in a word,
//   out_r = S_r0 ^ xtime(S_r1 ^ xtime(S_r2 ^ ... xtime(S_rt)))
//   S_rj  = XOR of in_c over the c with bit j of M[r,c] set
// where t is row r's highest set bit and xtime(w) = ((w << 1) & 0xFEFEFEFE)
// ^ (sign_bytes(w) & 0x1D1D1D1D) doubles each byte (sign_bytes, one prmt,
// makes each byte 0xFF where its top bit is set; gf_chunks.cuh). The set
// bits are known when the library is compiled: the selection is resolved
// by `if constexpr`, and no instruction tests a bit at run time. The TPU
// kernel runs a chain of 7 doublings per input row; Horner runs at most 7
// per output row, so RS(10,4) takes 28 doublings a word instead of 70,
// beside popcount(M) = 156 XORs that the compiler pairs into 3-input LOP3s. All arithmetic is uint32_t (the Pallas kernel
// leans on int32 wraparound and arithmetic shifts, which C++ leaves
// undefined or signed).
//
// What bounds it. The function moves (C + R) * B bytes: 14,680,064 B for
// RS(10,4) at B = 1 MiB, 0.004382 ms at the H100 SXM's 3.35 TB/s. Its
// integer work, about 28 x 4 + 156 / 2 instructions a word for RS(10,4),
// issues in about 3 us on 132 SMs at 64 lanes a clock, under the bytes
// bound; the measured times sit at 1.7-2.7x the bound, the rest being
// launch latency and the load and store waits that one wave of blocks
// cannot hide. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W):
// [4, 10] x 1 MiB 0.011776 ms (2.7x the bound), [4, 10] x (6 MiB + 4093)
// with misaligned rows 0.044192 ms (1.7x).
//
// Design. A thread owns a W-byte column chunk (W = 16; 8 or 4 for a matrix
// of more than 24 or 48 input rows, whose chunks would not fit in
// registers) and issues all C rows' loads before the first use. Every row
// takes W-byte accesses at any row offset, realigned in registers
// (gf_chunks.cuh); byte accesses remain only at a span's two ends. Any row
// stride is taken as it is; the wrapper never pads or copies.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

#include "gf_chunks.cuh"

#ifndef GF_MATRIX_SPECIALISED
#error "gf_sel.cu is a template: compile the unit ops/_build.py generates"
#endif

namespace {

using gf_matrix::kCols;
using gf_matrix::kRows;

static_assert(kRows >= 1 && kRows <= 32, "R must be 1..32");
static_assert(kCols >= 1 && kCols <= 64, "C must be 1..64");

// Words a thread owns per row: the C input chunks stay in registers.
constexpr int kNW = kCols <= 24 ? 4 : kCols <= 48 ? 2 : 1;
constexpr int kW = 4 * kNW;

// Bit j of M[r][c]. Only ever evaluated as a constant expression.
__host__ __device__ constexpr bool sel_bit(int r, int c, int j) {
  return ((gf_matrix::kMatrix[r * kCols + c] >> j) & 1u) != 0;
}

// GF(2^8)/0x11D doubling of the four bytes of w: shift each byte left, and
// where its top bit was set, reduce by 0x1D.
__device__ __forceinline__ uint32_t xtime(uint32_t w) {
  return ((w << 1) & 0xFEFEFEFEu) ^ (gfk::sign_bytes(w) & 0x1D1D1D1Du);
}

// Row r's highest set bit over all its columns (-1 for a zero row).
__host__ __device__ constexpr int top_bit(int r) {
  int top = -1;
  for (int c = 0; c < kCols; ++c) {
    for (int j = 0; j < 8; ++j) {
      if (sel_bit(r, c, j) && j > top) top = j;
    }
  }
  return top;
}

using Chunk = uint32_t[kNW];
using Chunks = uint32_t[kCols][kNW];

// h ^= in_c where bit j of M[r][c] is set; nothing is emitted elsewhere.
template <int r, int j, int c>
__device__ __forceinline__ void select_col(Chunk& h, const Chunks& w) {
  if constexpr (sel_bit(r, c, j)) {
#pragma unroll
    for (int q = 0; q < kNW; ++q) h[q] ^= w[c][q];
  }
}

// One Horner step of row r: h = xtime(h) ^ S_rj (no doubling at the top bit).
template <int r, int j, int... cs>
__device__ __forceinline__ void step(Chunk& h, const Chunks& w,
                                     std::integer_sequence<int, cs...>) {
  if constexpr (j <= top_bit(r)) {
    if constexpr (j < top_bit(r)) {
#pragma unroll
      for (int q = 0; q < kNW; ++q) h[q] = xtime(h[q]);
    }
    (select_col<r, j, cs>(h, w), ...);
  }
}

// Output row r of the chunk, stored (through the halo exchange) at once.
template <int r, int... ks>
__device__ __forceinline__ void output_row(const Chunks& w, uint8_t* out,
                                           long long ld_out,
                                           const gfk::ChunkMap& m, long long B,
                                           std::integer_sequence<int, ks...>) {
  Chunk h = {};
  (step<r, 7 - ks>(h, w, std::make_integer_sequence<int, kCols>{}), ...);
  gfk::chunk_out<kNW>(out + r * ld_out, m, B, h);
}

template <int... rs>
__device__ __forceinline__ void output_rows(const Chunks& w, uint8_t* out,
                                            long long ld_out,
                                            const gfk::ChunkMap& m,
                                            long long B,
                                            std::integer_sequence<int, rs...>) {
  (output_row<rs>(w, out, ld_out, m, B, std::make_integer_sequence<int, 8>{}),
   ...);
}

__global__ void __launch_bounds__(gfk::kThreads)
gf_sel_kernel(const uint8_t* __restrict__ in, long long ld_in,
              uint8_t* __restrict__ out, long long ld_out, long long B,
              bool halo) {
  const gfk::ChunkMap m = gfk::chunk_map(halo);
  if (m.first >= gfk::owned_chunks<kNW>(B, halo)) return;  // whole warps
  // every row's load before the first use
  Chunks x;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const uint8_t* row = in + static_cast<long long>(c) * ld_in;
    gfk::load_block<kNW>(row, m.t * kW - gfk::row_offset<kNW>(row), B, x[c]);
  }
  Chunks w;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    gfk::chunk_in<kNW>(
        x[c], gfk::row_offset<kNW>(in + static_cast<long long>(c) * ld_in),
        w[c]);
  }
  output_rows(w, out, ld_out, m, B, std::make_integer_sequence<int, kRows>{});
}

}  // namespace

extern "C" {

// The shape and bytes baked into this library, so a loader can check that
// it holds the matrix it asked for.
int gf_sel_rows() { return kRows; }
int gf_sel_cols() { return kCols; }
void gf_sel_matrix(uint8_t* out) {
  for (int i = 0; i < kRows * kCols; ++i) out[i] = gf_matrix::kMatrix[i];
}

// out[R, B] (row stride ld_out bytes) = M (x) in[C, B] (row stride ld_in).
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not sync.
int gf_sel_launch(const void* in, long long ld_in, void* out, long long ld_out,
                  long long B, int device, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gfk::DeviceGuard guard;
  const cudaError_t e = guard.set(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool halo = gfk::needs_halo<kNW>(in, ld_in, kCols, out, ld_out, kRows);
  const long long blocks = gfk::blocks_for<kNW>(B, halo);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gf_sel_kernel<<<static_cast<unsigned>(blocks), gfk::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), ld_in, static_cast<uint8_t*>(out),
      ld_out, B, halo);
  return static_cast<int>(cudaGetLastError());
}

const char* gf_sel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
