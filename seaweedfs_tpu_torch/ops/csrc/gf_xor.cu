// K1: packed-word XOR GF(2^8) matrix product for Hopper (sm_90a).
//
//   out[R, B] = M[R, C] (x) in[C, B]   over GF(2^8)/0x11D, byte columns.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_xor.py `_xor_kernel`
// (launched by `gf_matmul_xor_pallas`, wrapper `apply_matrix_xor_pallas`).
//
// What it computes. For four bytes packed little-endian in a word w,
//   c * x = XOR_j bit_j(x) * gfmul(c, 2^j)              (GF linearity)
//   mask_j(w) = (w >> j) & 0x01010101                   (bit j of each byte)
//   out_r = XOR_{c,j} mask_j(in_c) * coef[r, 8c+j],     coef = gfmul(M[r,c], 2^j)
// Each product mask * coef has no carries (0x01010101 * 255 = 0xFFFFFFFF),
// so it equals (mask * 0xFF) & (coef * 0x01010101). The kernel stages the
// coefficients replicated into all four bytes of a word and combines them
// with AND, which the compiler fuses with the XOR into one LOP3 per output
// row and mask. All arithmetic is uint32_t: the Pallas kernel leans on
// int32 wraparound, which is undefined for signed integers in C++, and its
// right shifts must be logical here.
//
// What bounds it. The function moves (C + R) * B bytes: 14 MiB for RS(10,4)
// at B = 1 MiB, 4.4 us at the H100 SXM's 3.35 TB/s. The kernel issues about
// 8 * C * (3 + R) integer instructions per 4-byte word column, so at that
// shape the integer issue rate, not memory, sets its time (PERF.md holds
// the measured numbers).
//
// Design. One thread per 16-byte column chunk (four words), across all C
// input rows. The [R, 8C] coefficient tile sits in shared memory — not in
// __constant__, because concurrent calls carry different decode matrices —
// padded with zero rows to a multiple of RCH. R outputs accumulate in
// registers in passes of RCH rows; a pass past the first re-reads the input
// chunk (from L2). A row whose chunk is 16-byte aligned and whole takes one
// 16-byte load and store; the ragged tail (B % 16 bytes) and rows that start
// off a 16-byte boundary take byte loads and stores masked by B, so the
// wrapper never pads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // bytes per thread per row

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

template <int RCH>
__global__ void __launch_bounds__(kThreads)
gf_xor_kernel(const uint32_t* __restrict__ coef,  // [R, 8C], values 0..255
              const uint8_t* __restrict__ in, long long ld_in,
              uint8_t* __restrict__ out, long long ld_out, int R, int C,
              long long B) {
  extern __shared__ uint32_t s_coef[];  // [R padded to RCH, 8C], replicated
  const int row_words = 8 * C;
  const int r_pad = (R + RCH - 1) / RCH * RCH;
  for (int i = threadIdx.x; i < r_pad * row_words; i += blockDim.x) {
    s_coef[i] = i < R * row_words ? coef[i] * 0x01010101u : 0u;
  }
  __syncthreads();

  const long long b0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kChunk;
  if (b0 >= B) return;
  const long long avail = B - b0;

  for (int r0 = 0; r0 < R; r0 += RCH) {
    uint32_t acc[RCH][4];
#pragma unroll
    for (int p = 0; p < RCH; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0u;
    }
    const uint32_t* k_pass = s_coef + static_cast<size_t>(r0) * row_words;
    for (int c = 0; c < C; ++c) {
      uint32_t w[4];
      load_chunk(in + c * ld_in + b0, avail, w);
      const uint32_t* k_c = k_pass + 8 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bm[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bm[q] = ((w[q] >> j) & 0x01010101u) * 0xFFu;
#pragma unroll
        for (int p = 0; p < RCH; ++p) {
          const uint32_t kk = k_c[p * row_words + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] ^= bm[q] & kk;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < RCH; ++p) {
      if (r0 + p < R) store_chunk(out + (r0 + p) * ld_out + b0, avail, acc[p]);
    }
  }
}

size_t smem_bytes(int R, int C) {
  const int rch = R <= 4 ? 4 : 8;
  const size_t r_pad = static_cast<size_t>((R + rch - 1) / rch * rch);
  return r_pad * 8 * static_cast<size_t>(C) * sizeof(uint32_t);
}

template <int RCH>
cudaError_t launch(const void* coef, const void* in, long long ld_in, void* out,
                   long long ld_out, int R, int C, long long B, size_t smem,
                   unsigned blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_xor_kernel<RCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gf_xor_kernel<RCH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(coef), static_cast<const uint8_t*>(in), ld_in,
      static_cast<uint8_t*>(out), ld_out, R, C, B);
  return cudaGetLastError();
}

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
// `stream` and returns cudaGetLastError() (0 on success); does not sync.
int gf_xor_launch(const void* coef, const void* in, long long ld_in, void* out,
                  long long ld_out, int R, int C, long long B, int device,
                  void* stream) {
  if (R <= 0 || C <= 0 || B <= 0 || R > 256 || C > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(R, C);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (B + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  e = R <= 4 ? launch<4>(coef, in, ld_in, out, ld_out, R, C, B, smem, nb, s)
             : launch<8>(coef, in, ld_in, out, ld_out, R, C, B, smem, nb, s);
  return static_cast<int>(e);
}

const char* gf_xor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
