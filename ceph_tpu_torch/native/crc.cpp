// CRC-32C (Castagnoli) region kernel — the native fast path behind
// ceph_tpu_torch.utils.crc32c (role of the reference's src/common/crc32c.cc
// with its SSE4.2 ceph_crc32c_intel_fast backend).
//
// Contract matches ceph_crc32c: caller passes the raw initial value
// (usually 0xffffffff); no pre/post inversion.
//
// Engine selection at runtime: the x86 CRC32 instruction (SSE4.2,
// 8 bytes/op) when the CPU has it, else table slicing-by-8.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

namespace {

uint32_t table[8][256];

struct TableInit {
  TableInit() {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
      for (int i = 0; i < 256; i++)
        table[t][i] = table[0][table[t - 1][i] & 0xff] ^ (table[t - 1][i] >> 8);
  }
} init_;

uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  while (n >= 8) {
    uint64_t q;
    std::memcpy(&q, p, 8);
    q ^= crc;
    crc = table[7][q & 0xff] ^ table[6][(q >> 8) & 0xff] ^
          table[5][(q >> 16) & 0xff] ^ table[4][(q >> 24) & 0xff] ^
          table[3][(q >> 32) & 0xff] ^ table[2][(q >> 40) & 0xff] ^
          table[1][(q >> 48) & 0xff] ^ table[0][(q >> 56) & 0xff];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ table[0][(crc ^ *p++) & 0xff];
  return crc;
}

#if defined(__x86_64__) || defined(_M_X64)
bool have_sse42() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return c & bit_SSE4_2;
}

__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t q;
    std::memcpy(&q, p, 8);
    c = _mm_crc32_u64(c, q);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

const bool use_hw = have_sse42();
#else
const bool use_hw = false;
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  return crc_sw(crc, p, n);
}
#endif

}  // namespace

extern "C" {

uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
  return use_hw ? crc_hw(crc, data, len) : crc_sw(crc, data, len);
}

int ceph_tpu_crc32c_hw(void) { return use_hw ? 1 : 0; }
}
