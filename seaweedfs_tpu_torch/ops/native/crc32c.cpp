// CRC-32C (Castagnoli), slice-by-8: the needle checksum's host kernel
// (storage/crc.py). The reference's ops/native/rs.cpp holds the same
// function beside its GF(2^8) kernels, which are rs.cpp here; the two
// sources build into one library (ops/rs_native.py).
//
// Exported C ABI (used from Python via ctypes, see ops/rs_native.py):
//   swfs_crc32c(data, n, seed)   // extend `seed` over data[0:n]

#include <cstdint>
#include <cstring>

namespace {

// t[0] is the byte table of the reflected polynomial; t[k] advances a
// byte seen k positions earlier through k more zero bytes. Filled by a
// static constructor, so the tables are ready before any call.
struct Crc32cTables {
    uint32_t t[8][256];
    Crc32cTables() {
        const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t crc = i;
            for (int j = 0; j < 8; ++j)
                crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
            t[0][i] = crc;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int k = 1; k < 8; ++k)
                t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
    }
};

const Crc32cTables kCrc;

}  // namespace

extern "C" {

uint32_t swfs_crc32c(const uint8_t* data, int64_t n, uint32_t seed) {
    const uint32_t (*t)[256] = kCrc.t;
    uint32_t crc = ~seed;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t word;
        std::memcpy(&word, data + i, 8);
        word ^= crc;  // little-endian assumed (x86/arm64)
        crc = t[7][word & 0xFF] ^ t[6][(word >> 8) & 0xFF] ^
              t[5][(word >> 16) & 0xFF] ^ t[4][(word >> 24) & 0xFF] ^
              t[3][(word >> 32) & 0xFF] ^ t[2][(word >> 40) & 0xFF] ^
              t[1][(word >> 48) & 0xFF] ^ t[0][(word >> 56) & 0xFF];
    }
    for (; i < n; ++i) crc = (crc >> 8) ^ t[0][(crc ^ data[i]) & 0xFF];
    return ~crc;
}

}  // extern "C"
