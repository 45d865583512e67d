// GF(2^8) region kernels — the native CPU erasure-code engine.
//
// Plays the role of the reference's out-of-tree SIMD GF libraries
// (gf-complete / isa-l, vendored as empty submodules in the reference
// checkout): multiply-accumulate of constant×region over GF(2^8) with the
// 0x11D polynomial, vectorized with AVX2/SSSE3 nibble-table shuffles when
// available and a 64-bit table-pair scalar path otherwise.
//
// Exposed C ABI (ctypes-friendly):
//   gf_native_simd_level()                     -> 0 scalar, 1 ssse3, 2 avx2
//   gf_native_matvec(M, m, k, data, parity, L) -> parity[m][L] = M·data
//   gf_native_mul_region(c, src, dst, L, acc)  -> dst (^)= c*src
//
// Built lazily by ceph_tpu_torch.native (g++ -O3); no external deps.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

namespace {

constexpr unsigned PRIM = 0x11D;

struct Tables {
    // full 256x256 product table
    uint8_t mul[256][256];
    // per-constant nibble tables: lo[c][x&15], hi[c][x>>4]
    uint8_t lo[256][16];
    uint8_t hi[256][16];
    Tables() {
        for (int a = 0; a < 256; a++) {
            for (int b = 0; b < 256; b++) {
                unsigned p = 0, aa = a, bb = b;
                while (bb) {
                    if (bb & 1) p ^= aa;
                    aa <<= 1;
                    if (aa & 0x100) aa ^= PRIM;
                    bb >>= 1;
                }
                mul[a][b] = (uint8_t)p;
            }
        }
        for (int c = 0; c < 256; c++) {
            for (int n = 0; n < 16; n++) {
                lo[c][n] = mul[c][n];
                hi[c][n] = mul[c][n << 4];
            }
        }
    }
};

const Tables T;

#if defined(__AVX2__)
inline void mul_region_avx2(uint8_t c, const uint8_t* src, uint8_t* dst,
                            size_t len, bool accumulate) {
    const __m256i lo =
        _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)T.lo[c]));
    const __m256i hi =
        _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)T.hi[c]));
    const __m256i mask = _mm256_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 32 <= len; i += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(src + i));
        __m256i l = _mm256_shuffle_epi8(lo, _mm256_and_si256(x, mask));
        __m256i h = _mm256_shuffle_epi8(
            hi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
        __m256i p = _mm256_xor_si256(l, h);
        if (accumulate)
            p = _mm256_xor_si256(
                p, _mm256_loadu_si256((const __m256i*)(dst + i)));
        _mm256_storeu_si256((__m256i*)(dst + i), p);
    }
    for (; i < len; i++) {
        uint8_t p = T.mul[c][src[i]];
        dst[i] = accumulate ? (uint8_t)(dst[i] ^ p) : p;
    }
}
#elif defined(__SSSE3__)
inline void mul_region_ssse3(uint8_t c, const uint8_t* src, uint8_t* dst,
                             size_t len, bool accumulate) {
    const __m128i lo = _mm_loadu_si128((const __m128i*)T.lo[c]);
    const __m128i hi = _mm_loadu_si128((const __m128i*)T.hi[c]);
    const __m128i mask = _mm_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 16 <= len; i += 16) {
        __m128i x = _mm_loadu_si128((const __m128i*)(src + i));
        __m128i l = _mm_shuffle_epi8(lo, _mm_and_si128(x, mask));
        __m128i h = _mm_shuffle_epi8(
            hi, _mm_and_si128(_mm_srli_epi64(x, 4), mask));
        __m128i p = _mm_xor_si128(l, h);
        if (accumulate)
            p = _mm_xor_si128(p, _mm_loadu_si128((const __m128i*)(dst + i)));
        _mm_storeu_si128((__m128i*)(dst + i), p);
    }
    for (; i < len; i++) {
        uint8_t p = T.mul[c][src[i]];
        dst[i] = accumulate ? (uint8_t)(dst[i] ^ p) : p;
    }
}
#endif

inline void mul_region_scalar(uint8_t c, const uint8_t* src, uint8_t* dst,
                              size_t len, bool accumulate) {
    const uint8_t* row = T.mul[c];
    if (accumulate)
        for (size_t i = 0; i < len; i++) dst[i] ^= row[src[i]];
    else
        for (size_t i = 0; i < len; i++) dst[i] = row[src[i]];
}

inline void mul_region(uint8_t c, const uint8_t* src, uint8_t* dst,
                       size_t len, bool accumulate) {
    if (c == 0) {
        if (!accumulate) std::memset(dst, 0, len);
        return;
    }
    if (c == 1) {
        if (accumulate)
            for (size_t i = 0; i < len; i++) dst[i] ^= src[i];
        else
            std::memcpy(dst, src, len);
        return;
    }
#if defined(__AVX2__)
    mul_region_avx2(c, src, dst, len, accumulate);
#elif defined(__SSSE3__)
    mul_region_ssse3(c, src, dst, len, accumulate);
#else
    mul_region_scalar(c, src, dst, len, accumulate);
#endif
}

}  // namespace

extern "C" {

int gf_native_simd_level() {
#if defined(__AVX2__)
    return 2;
#elif defined(__SSSE3__)
    return 1;
#else
    return 0;
#endif
}

// parity[m][L] = M[m][k] · data[k][L]   (rows contiguous)
void gf_native_matvec(const uint8_t* M, int m, int k, const uint8_t* data,
                      uint8_t* parity, long long L) {
    for (int i = 0; i < m; i++) {
        uint8_t* out = parity + (size_t)i * L;
        bool first = true;
        for (int j = 0; j < k; j++) {
            uint8_t c = M[i * k + j];
            if (c == 0) continue;
            mul_region(c, data + (size_t)j * L, out, (size_t)L, !first);
            first = false;
        }
        if (first) std::memset(out, 0, (size_t)L);
    }
}

void gf_native_mul_region(int c, const uint8_t* src, uint8_t* dst,
                          long long L, int accumulate) {
    mul_region((uint8_t)c, src, dst, (size_t)L, accumulate != 0);
}

}  // extern "C"
