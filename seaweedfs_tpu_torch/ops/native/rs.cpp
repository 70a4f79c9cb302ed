// Host GF(2^8) kernels: the native host coder's matmul and the compiled
// XOR-schedule executor. A copy of the GF half of the reference's
// ops/native/rs.cpp (its CRC-32C half is crc32c.cpp here); both sources
// build into one library (ops/rs_native.py).
//
//     out[m, B] = M[m, k] (*) data[k, B]     over GF(256)/0x11D
//
// with the hi/lo nibble-table split of klauspost/reedsolomon: for a
// coefficient c, c*x == LO_c[x & 0xF] ^ HI_c[x >> 4]; with AVX2 one
// vpshufb per nibble, 32 bytes per step.
//
// Exported C ABI (used from Python via ctypes, see ops/rs_native.py):
//   swfs_gf_matmul(matrix, m, k, data, b, out)
//   swfs_xor_sched_exec(prog, n_ops, data, n_in, b, out, n_out, n_tmp)
//   swfs_simd_level()                                // 2 = AVX2, 0 = scalar

#include <cstdint>
#include <cstring>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x11D;

struct MulTable {
    // mul[c][x] = c * x over GF(2^8)/0x11D
    uint8_t mul[256][256];
    MulTable() {
        for (int c = 0; c < 256; ++c) {
            for (int x = 0; x < 256; ++x) {
                uint32_t a = static_cast<uint32_t>(c), b = static_cast<uint32_t>(x), p = 0;
                while (b) {
                    if (b & 1) p ^= a;
                    a <<= 1;
                    if (a & 0x100) a ^= kPoly;
                    b >>= 1;
                }
                mul[c][x] = static_cast<uint8_t>(p);
            }
        }
    }
};

const MulTable kTables;

// One coefficient's nibble tables, built on the fly (32 bytes; stays in L1).
struct Nibbles {
    uint8_t lo[16];
    uint8_t hi[16];
    explicit Nibbles(uint8_t c) {
        for (int i = 0; i < 16; ++i) {
            lo[i] = kTables.mul[c][i];
            hi[i] = kTables.mul[c][i << 4];
        }
    }
};

inline void axpy_scalar(uint8_t c, const uint8_t* __restrict src,
                        uint8_t* __restrict dst, int64_t n) {
    const Nibbles t(c);
    for (int64_t j = 0; j < n; ++j) {
        const uint8_t x = src[j];
        dst[j] ^= static_cast<uint8_t>(t.lo[x & 0xF] ^ t.hi[x >> 4]);
    }
}

#if defined(__AVX2__)
inline void axpy_avx2(uint8_t c, const uint8_t* __restrict src,
                      uint8_t* __restrict dst, int64_t n) {
    const Nibbles t(c);
    const __m256i lo = _mm256_broadcastsi128_si256(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.lo)));
    const __m256i hi = _mm256_broadcastsi128_si256(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.hi)));
    const __m256i mask = _mm256_set1_epi8(0x0F);
    int64_t j = 0;
    for (; j + 32 <= n; j += 32) {
        const __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + j));
        const __m256i l = _mm256_shuffle_epi8(lo,
                                              _mm256_and_si256(x, mask));
        const __m256i h = _mm256_shuffle_epi8(
            hi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
        const __m256i d = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + j));
        _mm256_storeu_si256(
            reinterpret_cast<__m256i*>(dst + j),
            _mm256_xor_si256(d, _mm256_xor_si256(l, h)));
    }
    if (j < n) axpy_scalar(c, src + j, dst + j, n - j);
}
#endif

inline void xor_rows(const uint8_t* __restrict src, uint8_t* __restrict dst,
                     int64_t n) {
    int64_t j = 0;
#if defined(__AVX2__)
    for (; j + 32 <= n; j += 32) {
        const __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + j));
        const __m256i d = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + j));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + j),
                            _mm256_xor_si256(d, x));
    }
#endif
    for (; j < n; ++j) dst[j] ^= src[j];
}

// In place multiply by alpha (= 2) over GF(256)/0x11D: shift left, then
// fold the dropped high bit back as 0x1D (the vector form takes the high
// bit's mask from a signed compare).
inline void xtime_row(uint8_t* __restrict dst, int64_t n) {
    int64_t j = 0;
#if defined(__AVX2__)
    const __m256i zero = _mm256_setzero_si256();
    const __m256i red = _mm256_set1_epi8(0x1D);
    for (; j + 32 <= n; j += 32) {
        const __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + j));
        const __m256i hi = _mm256_cmpgt_epi8(zero, x);
        const __m256i sh = _mm256_add_epi8(x, x);
        _mm256_storeu_si256(
            reinterpret_cast<__m256i*>(dst + j),
            _mm256_xor_si256(sh, _mm256_and_si256(hi, red)));
    }
#endif
    for (; j < n; ++j) {
        const uint8_t v = dst[j];
        dst[j] = static_cast<uint8_t>((v << 1) ^ ((v >> 7) * 0x1Du));
    }
}

inline void axpy(uint8_t c, const uint8_t* __restrict src, uint8_t* __restrict dst,
                 int64_t n) {
    if (c == 0) return;
    if (c == 1) {
        xor_rows(src, dst, n);
        return;
    }
#if defined(__AVX2__)
    axpy_avx2(c, src, dst, n);
#else
    axpy_scalar(c, src, dst, n);
#endif
}

}  // namespace

extern "C" {

// out[m, b] = matrix[m, k] (*) data[k, b]; all row-major, contiguous.
void swfs_gf_matmul(const uint8_t* matrix, int m, int k, const uint8_t* data,
                    int64_t b, uint8_t* out) {
    for (int r = 0; r < m; ++r) {
        uint8_t* dst = out + static_cast<int64_t>(r) * b;
        std::memset(dst, 0, static_cast<size_t>(b));
        for (int c = 0; c < k; ++c) {
            axpy(matrix[r * k + c], data + static_cast<int64_t>(c) * b, dst, b);
        }
    }
}

// Compiled XOR-schedule executor: runs the flat (op, dst, src) int32
// program of ops/rs_sched.py over the input rows by pointer. Ops: 0 SET,
// 1 XOR, 2 XTIME (in place, src unused), 3 ZERO. Registers 0..n_out-1 are
// the output rows, the rest CSE scratch; a src operand < n_in names an
// input row, >= n_in names register (src - n_in). The slab is processed
// in 16 KiB tiles so every live register stays cache-resident across the
// whole program.
void swfs_xor_sched_exec(const int32_t* prog, int64_t n_ops,
                         const uint8_t* data, int n_in, int64_t b,
                         uint8_t* out, int n_out, int n_tmp) {
    constexpr int64_t kTile = 16384;
    uint8_t stack_tmp[4 * kTile];
    uint8_t* tmp = stack_tmp;
    uint8_t* heap_tmp = nullptr;
    if (n_tmp > 4) {
        heap_tmp = new uint8_t[static_cast<size_t>(n_tmp) * kTile];
        tmp = heap_tmp;
    }
    for (int64_t off = 0; off < b; off += kTile) {
        const int64_t n = (b - off) < kTile ? (b - off) : kTile;
        for (int64_t p = 0; p < n_ops; ++p) {
            const int32_t op = prog[p * 3];
            const int32_t dst = prog[p * 3 + 1];
            const int32_t src = prog[p * 3 + 2];
            uint8_t* d = dst < n_out
                ? out + static_cast<int64_t>(dst) * b + off
                : tmp + static_cast<int64_t>(dst - n_out) * kTile;
            if (op == 2) {
                xtime_row(d, n);
                continue;
            }
            if (op == 3) {
                std::memset(d, 0, static_cast<size_t>(n));
                continue;
            }
            const int32_t reg = src - n_in;
            const uint8_t* s = src < n_in
                ? data + static_cast<int64_t>(src) * b + off
                : (reg < n_out
                       ? out + static_cast<int64_t>(reg) * b + off
                       : tmp + static_cast<int64_t>(reg - n_out) * kTile);
            if (op == 0) {
                std::memcpy(d, s, static_cast<size_t>(n));
            } else {
                xor_rows(s, d, n);
            }
        }
    }
    delete[] heap_tmp;
}

// Which axpy variant this build runs: 2 = AVX2 vpshufb, 0 = scalar.
int swfs_simd_level() {
#if defined(__AVX2__)
    return 2;
#else
    return 0;
#endif
}

}  // extern "C"
