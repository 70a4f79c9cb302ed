// K1: packed-word XOR GF(2^8) matrix product for Hopper (sm_90a).
//
//   out[R, B] = M[R, C] (x) in[C, B]   over GF(2^8)/0x11D, byte columns.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_xor.py `_xor_kernel` (:115;
// launched by `gf_matmul_xor_pallas`, wrapper `apply_matrix_xor_pallas`).
//
// What it computes. For four bytes packed little-endian in a word w,
//   c * x = XOR_j bit_j(x) * gfmul(c, 2^j)              (GF linearity)
//   mask_j(w) = sign_bytes(w << (7 - j))                (0xFF where bit j set)
//   out_r = XOR_{c,j} mask_j(in_c) & (coef[r, 8c+j] * 0x01010101)
// with coef = gfmul(M[r,c], 2^j) and sign_bytes one prmt (gf_chunks.cuh):
// the shift moves bit j of each byte to its top bit, and prmt replicates
// each byte's top bit over the byte. That is two instructions a mask (one
// for j = 7), and one LOP3 (AND-XOR) per output row and mask. All
// arithmetic is uint32_t: the Pallas kernel leans on int32 wraparound,
// which is undefined for signed integers in C++.
//
// What bounds it. The function moves (C + R) * B bytes: 14,680,064 B for
// RS(10,4) encode at B = 1 MiB, 0.004382 ms at the H100 SXM's 3.35 TB/s. Per
// word of each input row a thread issues 15 mask instructions and 8 R
// AND-XORs on the SMs' integer logic pipe (64 lanes a clock): for [4, 10]
// x 1 MiB, 470 a word, about 7.4 us on 132 SMs at 1.98 GHz, above the bytes
// bound. So integer issue sets the time at the encode and rebuild shapes,
// and launch latency at a degraded read's few KB. Measured (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W): [4, 10] x 1 MiB 0.018304 ms (4.2x the
// bound), [3, 10] x 1 MiB 0.016352 ms, [1, 10] x 24,584 B 0.011200 ms beside
// an empty kernel's 0.005072 ms. Designs measured and dropped: a persistent
// grid prefetching the next chunk (registers doubled, twice as slow), IMAD
// products instead of AND masks (20% slower), and Horner's rule over the
// matrix bits (fewer instructions, but one serial chain per row: 31%
// slower at [4, 10]; K3, whose selection is compile-time, uses it).
//
// Design.
//   * All C input rows of a chunk in flight: the kernel is a template on a
//     group of CG input rows (CG = C for C in {6, 10, 12, 14}; groups of 8
//     for any other C), and a thread issues the group's CG 16-byte loads
//     before the first use. (Issuing them before the block stages its
//     coefficients, with the chunks held across the group loop, took 128
//     registers at [4, 10] instead of 110 and ran 59% slower.)
//   * 16-byte accesses at any row offset (gf_chunks.cuh): aligned blocks,
//     realigned in registers by warp shuffles and funnel shifts; byte
//     accesses only at a span's two ends. The wrapper never pads or
//     copies: any row stride is taken as it is.
//   * Exact R: the kernel is a template on RB = 1..8 output rows a pass;
//     R <= 8 is one pass of exactly R rows, a larger R is passes of 8 (one
//     per grid row) and one launch for the R % 8 rest. No accumulator row
//     carries zero coefficients: a degraded read (R = 1) does one row.
//   * The [RB, 8C] coefficients of a pass sit in shared memory, replicated
//     into all four bytes of a word, as [C][RB][8] so that one input row's
//     eight coefficients for an output row are two 16-byte loads (all
//     lanes read the same address: a broadcast). Not __constant__:
//     concurrent calls carry different decode matrices.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

#include "gf_chunks.cuh"

namespace {

constexpr int kGroup = 8;  // input rows in flight for a C with no template
constexpr int kMaxPass = 8;

template <int CG, int RB>
__global__ void __launch_bounds__(gfk::kThreads)
gf_xor_kernel(const uint32_t* __restrict__ coef,  // [R, 8C], values 0..255
              int r_base, const uint8_t* __restrict__ in, long long ld_in,
              uint8_t* __restrict__ out, long long ld_out, int C, long long B,
              bool halo) {
  extern __shared__ uint4 s_coef[];  // [C][RB][2]: 8 replicated words
  const int r0 = r_base + static_cast<int>(blockIdx.y) * RB;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_coef);
  for (int i = threadIdx.x; i < C * RB * 8; i += blockDim.x) {
    const int j = i & 7;
    const int p = (i >> 3) % RB;
    const int c = (i >> 3) / RB;
    s_words[i] = coef[static_cast<long long>(r0 + p) * 8 * C + 8 * c + j] *
                 0x01010101u;
  }
  __syncthreads();

  const gfk::ChunkMap m = gfk::chunk_map(halo);
  if (m.first >= gfk::owned_chunks<4>(B, halo)) return;  // whole warps

  uint32_t acc[RB][4];
#pragma unroll
  for (int p = 0; p < RB; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0u;
  }
  for (int c0 = 0; c0 < C; c0 += CG) {
    // every row's load before the first use
    uint32_t x[CG][4];
#pragma unroll
    for (int i = 0; i < CG; ++i) {
      if (c0 + i < C) {
        const uint8_t* row = in + (c0 + i) * ld_in;
        gfk::load_block<4>(row, m.t * 16 - gfk::row_offset<4>(row), B, x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < CG; ++i) {
      if (c0 + i < C) {  // uniform
        uint32_t w[4];
        gfk::chunk_in<4>(x[i], gfk::row_offset<4>(in + (c0 + i) * ld_in), w);
        uint32_t bm[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) bm[j][q] = gfk::sign_bytes(w[q] << (7 - j));
        }
        const uint4* k_c = s_coef + (c0 + i) * RB * 2;
#pragma unroll
        for (int p = 0; p < RB; ++p) {
          const uint4 lo = k_c[2 * p];
          const uint4 hi = k_c[2 * p + 1];
          const uint32_t kk[8] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] ^= bm[j][q] & kk[j];
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RB; ++p) {
    gfk::chunk_out<4>(out + (r0 + p) * ld_out, m, B, acc[p]);
  }
}

using KernelFn = void (*)(const uint32_t*, int, const uint8_t*, long long,
                          uint8_t*, long long, int, long long, bool);

template <int CG, int... rbs>
KernelFn pick_rb(int rb, std::integer_sequence<int, rbs...>) {
  KernelFn fn = nullptr;
  ((rb == rbs + 1 ? (fn = gf_xor_kernel<CG, rbs + 1>, 0) : 0), ...);
  return fn;
}

// The kernel for C input rows and RB output rows a pass.
KernelFn pick(int C, int rb) {
  const auto rbs = std::make_integer_sequence<int, kMaxPass>{};
  switch (C) {
    case 6: return pick_rb<6>(rb, rbs);
    case 10: return pick_rb<10>(rb, rbs);
    case 12: return pick_rb<12>(rb, rbs);
    case 14: return pick_rb<14>(rb, rbs);
    default: return pick_rb<kGroup>(rb, rbs);
  }
}

size_t smem_bytes(int R, int C) {
  const int rb = R < kMaxPass ? R : kMaxPass;
  return static_cast<size_t>(C) * rb * 8 * sizeof(uint32_t);
}

cudaError_t launch_pass(int rb, unsigned passes, int r_base, const void* coef,
                        const void* in, long long ld_in, void* out,
                        long long ld_out, int C, long long B, bool halo,
                        unsigned blocks, cudaStream_t stream) {
  const KernelFn fn = pick(C, rb);
  const size_t smem = smem_bytes(rb, C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fn<<<dim3(blocks, passes), gfk::kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(coef), r_base,
      static_cast<const uint8_t*>(in), ld_in, static_cast<uint8_t*>(out),
      ld_out, C, B, halo);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Shared memory the coefficient tile of an [R, C] matrix needs.
long long gf_xor_smem_bytes(int R, int C) {
  return static_cast<long long>(smem_bytes(R, C));
}

// Largest dynamic shared memory a block may opt in to on `device`.
int gf_xor_smem_limit(int device, int* limit) {
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// out[R, B] (row stride ld_out bytes) = M (x) in[C, B] (row stride ld_in),
// coefficients coef[R, 8C] int32 from xor_coefficients(M). Launches on
// `stream` (two kernels when R > 8 is no multiple of 8) and returns
// cudaGetLastError() (0 on success); does not sync.
int gf_xor_launch(const void* coef, const void* in, long long ld_in, void* out,
                  long long ld_out, int R, int C, long long B, int device,
                  void* stream) {
  if (R <= 0 || C <= 0 || B <= 0 || R > 256 || C > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gfk::DeviceGuard guard;
  cudaError_t e = guard.set(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes(R, C) > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool halo = gfk::needs_halo<4>(in, ld_in, C, out, ld_out, R);
  const long long blocks = gfk::blocks_for<4>(B, halo);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const int full = R / kMaxPass;
  const int rest = R % kMaxPass;
  if (R <= kMaxPass) {
    e = launch_pass(R, 1, 0, coef, in, ld_in, out, ld_out, C, B, halo, nb, s);
  } else {
    e = launch_pass(kMaxPass, static_cast<unsigned>(full), 0, coef, in, ld_in,
                    out, ld_out, C, B, halo, nb, s);
    if (e == cudaSuccess && rest > 0) {
      e = launch_pass(rest, 1, full * kMaxPass, coef, in, ld_in, out, ld_out, C,
                      B, halo, nb, s);
    }
  }
  return static_cast<int>(e);
}

// An empty kernel of one block, launched the same way: the floor under
// K1's time at small widths.
int gf_xor_empty_launch(int device, void* stream) {
  gfk::DeviceGuard guard;
  const cudaError_t e = guard.set(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  empty_kernel<<<1, gfk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gf_xor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
