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
// generated unit (which holds the matrix bytes) and the nvcc flags.
//
// What it computes. For four bytes packed little-endian in a word y,
//   xtime(y) = ((y << 1) & 0xFEFEFEFE) ^ (((y >> 7) & 0x01010101) * 0x1D)
// doubles each byte in GF(2^8), and M[r,c] * x = XOR_{j : bit j of M[r,c]}
// 2^j * x (GF linearity). So each input row c runs a chain of seven
// doublings, and output row r XORs in the chain's link j wherever bit j of
// M[r][c] is set. The set bits are known when the library is compiled:
// the selection is resolved by `if constexpr`, and no instruction tests a
// bit at run time. The TPU kernel builds all chains first and then
// selects; here each input row's link is XORed into the R accumulators as
// soon as it exists, so R + 1 words are live per word of input instead of
// 8 * C. All arithmetic is uint32_t (the Pallas kernel leans on int32
// wraparound and arithmetic shifts, which C++ leaves undefined or signed).
//
// What bounds it. The function moves (C + R) * B bytes: 14,680,064 B for
// RS(10,4) at B = 1 MiB, 0.004382 ms at the H100 SXM's 3.35 TB/s. Per word
// column it issues 7 * C xtime steps (about 4 integer instructions each)
// and popcount(M) XORs: RS(10,4)'s generator has 156 set bits, so about
// 280 + 156 instructions for 14 words moved, against K1's (gf_xor.cu)
// 80 mask builds and 320 AND-XOR pairs. PERF.md holds the measured times.
//
// Design. One thread per 16-byte column chunk (four words) across all C
// input rows, like K1: a row whose chunk is 16-byte aligned and whole
// takes one 16-byte load and store; the ragged tail (B % 16 bytes) and rows
// that start off a 16-byte boundary take byte loads and stores masked by
// B, so the wrapper never pads. Any row stride is taken as it is.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

#ifndef GF_MATRIX_SPECIALISED
#error "gf_sel.cu is a template: compile the unit ops/_build.py generates"
#endif

namespace {

using gf_matrix::kCols;
using gf_matrix::kRows;

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // bytes per thread per row

static_assert(kRows >= 1 && kRows <= 32, "R must be 1..32");
static_assert(kCols >= 1 && kCols <= 64, "C must be 1..64");

// Bit j of M[r][c]. Only ever evaluated as a constant expression.
__host__ __device__ constexpr bool sel_bit(int r, int c, int j) {
  return ((gf_matrix::kMatrix[r * kCols + c] >> j) & 1u) != 0;
}

__device__ __forceinline__ uint32_t xtime(uint32_t w) {
  return ((w << 1) & 0xFEFEFEFEu) ^ (((w >> 7) & 0x01010101u) * 0x1Du);
}

__device__ __forceinline__ void load_chunk(const uint8_t* p, long long avail,
                                           uint32_t w[4]) {
  if (avail >= kChunk && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int t = 0; t < kChunk; ++t) {
    if (t < avail) w[t >> 2] |= static_cast<uint32_t>(p[t]) << (8 * (t & 3));
  }
}

__device__ __forceinline__ void store_chunk(uint8_t* p, long long avail,
                                            const uint32_t w[4]) {
  if (avail >= kChunk && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  for (int t = 0; t < kChunk; ++t) {
    if (t < avail) p[t] = static_cast<uint8_t>(w[t >> 2] >> (8 * (t & 3)));
  }
}

using Acc = uint32_t[kRows][4];

// acc[r] ^= y where bit j of M[r][c] is set; nothing is emitted elsewhere.
template <int c, int j, int r>
__device__ __forceinline__ void select_row(Acc& acc, const uint32_t (&y)[4]) {
  if constexpr (sel_bit(r, c, j)) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] ^= y[q];
  }
}

// Link j of input row c's chain (y = 2^j * in_c): select it into every
// output row, then double it for link j + 1.
template <int c, int j, int... rs>
__device__ __forceinline__ void link(Acc& acc, uint32_t (&y)[4],
                                     std::integer_sequence<int, rs...>) {
  (select_row<c, j, rs>(acc, y), ...);
  if constexpr (j < 7) {
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = xtime(y[q]);
  }
}

template <int c, int... js>
__device__ __forceinline__ void input_row(Acc& acc, const uint8_t* p,
                                          long long avail,
                                          std::integer_sequence<int, js...>) {
  uint32_t y[4];
  load_chunk(p, avail, y);
  (link<c, js>(acc, y, std::make_integer_sequence<int, kRows>{}), ...);
}

template <int... cs>
__device__ __forceinline__ void accumulate(Acc& acc, const uint8_t* in,
                                           long long ld_in, long long avail,
                                           std::integer_sequence<int, cs...>) {
  (input_row<cs>(acc, in + static_cast<long long>(cs) * ld_in, avail,
                 std::make_integer_sequence<int, 8>{}),
   ...);
}

__global__ void __launch_bounds__(kThreads)
gf_sel_kernel(const uint8_t* __restrict__ in, long long ld_in,
              uint8_t* __restrict__ out, long long ld_out, long long B) {
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kChunk;
  if (b0 >= B) return;
  const long long avail = B - b0;
  Acc acc;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
  }
  accumulate(acc, in + b0, ld_in, avail,
             std::make_integer_sequence<int, kCols>{});
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    store_chunk(out + r * ld_out + b0, avail, acc[r]);
  }
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
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chunks = (B + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gf_sel_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), ld_in, static_cast<uint8_t*>(out),
      ld_out, B);
  return static_cast<int>(cudaGetLastError());
}

const char* gf_sel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
