// K2: bitsliced GF(2) form of the GF(2^8) matrix product, for Hopper (sm_90a).
//
//   out[R, B] = M[R, C] (x) in[C, B]   over GF(2^8)/0x11D, byte columns.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py `_kernel` (launched
// by `gf_matmul_bits_pallas`).
//
// What it computes. The matrix arrives in bit form Mb[8R, 8C] (int8 0/1,
// gf_matrix_to_bits: row 8r+i, column 8c+j = bit i of M[r,c] * 2^j). For a
// byte column b, let x be the 8C-bit vector whose bit 8c+j is bit j of
// in[c, b]. The Pallas kernel unpacks x into int8 planes, takes an int32
// dot with Mb and keeps `acc & 1`. Since acc <= 8C never overflows, acc & 1
// is the parity of popcount(Mb[8r+i] & x), which this kernel computes with
// no MMA: bit i of out[r, b] = popc(XOR_w (Mb_packed[8r+i][w] & x[w])) & 1.
// The bit vector needs no gather: word w of x is simply bytes 4w..4w+3 of
// the column, byte c at bits 8(c % 4), because bit 8c+j lands in word c / 4
// at position 8(c % 4) + j.
//
// What bounds it. The function moves (C + R) * B bytes, as K1 does: 4.4 us
// for RS(10,4) at B = 1 MiB on an H100 SXM. It issues about
// 8R * (2 * ceil(C/4) + 3) instructions per byte column, so at that shape
// the instruction rate, not memory, sets its time (PERF.md). An int8
// tensor-core (mma/wgmma) version is later work.
//
// Design. Every block packs Mb into shared memory as [8R][NW] 32-bit words
// (NW = ceil(C/4)) and checks it fits before launch. One thread per byte
// column. With C <= 16 (NW <= 4) the column's bit words live in registers;
// wider matrices keep them in shared memory at [NW][threads], which each
// thread reads only at its own column (no bank conflicts, no sync). Byte
// loads and stores are masked by B, so any width and any row stride work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRegWords = 4;  // C <= 16: column bit words in registers

// Pack the int8 bit matrix [8R, 8C] into [8R][NW] words in shared memory.
__device__ __forceinline__ void stage_matrix(const int8_t* __restrict__ mbits,
                                             uint32_t* s_mat, int R, int C,
                                             int nw) {
  const int rows = 8 * R;
  const int cols = 8 * C;
  for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
    const int row = i / nw;
    const int w = i - row * nw;
    uint32_t word = 0u;
    for (int t = 0; t < 32; ++t) {
      const int col = 32 * w + t;
      if (col < cols && (mbits[static_cast<size_t>(row) * cols + col] & 1)) {
        word |= 1u << t;
      }
    }
    s_mat[i] = word;
  }
}

__device__ __forceinline__ uint32_t column_word(const uint8_t* __restrict__ in,
                                                long long ld_in, long long b,
                                                int C, int w) {
  uint32_t word = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 4 * w + q;
    if (c < C) word |= static_cast<uint32_t>(in[c * ld_in + b]) << (8 * q);
  }
  return word;
}

template <bool kInRegisters>
__global__ void __launch_bounds__(kThreads)
gf_bits_kernel(const int8_t* __restrict__ mbits,  // [8R, 8C] 0/1
               const uint8_t* __restrict__ in, long long ld_in,
               uint8_t* __restrict__ out, long long ld_out, int R, int C,
               long long B) {
  extern __shared__ uint32_t smem[];
  const int nw = (C + 3) / 4;
  uint32_t* s_mat = smem;                   // [8R][nw]
  uint32_t* s_col = smem + 8 * R * nw;      // [nw][kThreads] (wide C only)
  stage_matrix(mbits, s_mat, R, C, nw);
  __syncthreads();

  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t x[kRegWords];
  if (kInRegisters) {
#pragma unroll
    for (int w = 0; w < kRegWords; ++w) {
      x[w] = w < nw ? column_word(in, ld_in, b, C, w) : 0u;
    }
  } else {
    for (int w = 0; w < nw; ++w) {
      s_col[w * kThreads + threadIdx.x] = column_word(in, ld_in, b, C, w);
    }
  }

  for (int r = 0; r < R; ++r) {
    uint32_t byte = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t* mrow = s_mat + (8 * r + i) * nw;
      uint32_t acc = 0u;
      if (kInRegisters) {
#pragma unroll
        for (int w = 0; w < kRegWords; ++w) {
          if (w < nw) acc ^= mrow[w] & x[w];
        }
      } else {
        for (int w = 0; w < nw; ++w) {
          acc ^= mrow[w] & s_col[w * kThreads + threadIdx.x];
        }
      }
      byte |= (static_cast<uint32_t>(__popc(acc)) & 1u) << i;
    }
    out[r * ld_out + b] = static_cast<uint8_t>(byte);
  }
}

size_t smem_bytes(int R, int C) {
  const size_t nw = static_cast<size_t>((C + 3) / 4);
  size_t bytes = 8 * static_cast<size_t>(R) * nw * sizeof(uint32_t);
  if (nw > kRegWords) bytes += nw * kThreads * sizeof(uint32_t);
  return bytes;
}

template <bool kInRegisters>
cudaError_t launch(const void* mbits, const void* in, long long ld_in, void* out,
                   long long ld_out, int R, int C, long long B, size_t smem,
                   unsigned blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_bits_kernel<kInRegisters>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gf_bits_kernel<kInRegisters><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(mbits), static_cast<const uint8_t*>(in), ld_in,
      static_cast<uint8_t*>(out), ld_out, R, C, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the packed matrix (and, for C > 16, the column words) needs.
long long gf_bits_smem_bytes(int R, int C) {
  return static_cast<long long>(smem_bytes(R, C));
}

// Largest dynamic shared memory a block may opt in to on `device`.
int gf_bits_smem_limit(int device, int* limit) {
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// out[R, B] (row stride ld_out bytes) = M (x) in[C, B] (row stride ld_in),
// with M given in bit form mbits[8R, 8C] int8. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not sync.
int gf_bits_launch(const void* mbits, const void* in, long long ld_in,
                   void* out, long long ld_out, int R, int C, long long B,
                   int device, void* stream) {
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
  const long long blocks = (B + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const bool in_registers = (C + 3) / 4 <= kRegWords;
  e = in_registers
          ? launch<true>(mbits, in, ld_in, out, ld_out, R, C, B, smem, nb, s)
          : launch<false>(mbits, in, ld_in, out, ld_out, R, C, B, smem, nb, s);
  return static_cast<int>(e);
}

const char* gf_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
