// AES-128-CTR counter-based CSPRNG with tree forking.
//
// Native equivalent of the reference's `concrete-csprng` crate
// (concrete-csprng/src/generators/aes_ctr/): a bounded pseudo-random byte
// stream over an AES-CTR keystream, fork()-able into deterministic child
// streams so parallel key generation reproduces sequential output.
//
// Two backends, mirroring the reference's aesni/soft split
// (concrete-csprng/src/generators/implem/): a hardware AES-NI pipeline
// (runtime CPUID detection, per-function target attributes so the library
// still loads on machines without AES-NI) and a portable software AES
// (FIPS-197, constant-table) fallback.  Both produce bit-identical streams.
// Set TFHE_CSPRNG_FORCE_SOFT=1 to pin the software path (tests compare the
// two).  Exposed to Python via ctypes (tfhe_tpu_torch/native/__init__.py).
// This copy belongs to tfhe_tpu_torch: its streams are byte for byte those of
// tfhe_tpu/native/csprng.cpp for the same seed and fork indices.
//
// Build (done at first use into tfhe_tpu_torch/build/):
//   g++ -O3 -shared -fPIC -o libtfhe_tpu_torch_csprng.so csprng.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__x86_64__) || defined(__i386__)
#define TFHE_X86 1
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- AES-128
const uint8_t SBOX[256] = {
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

const uint8_t RCON[11] = {0x00, 0x01, 0x02, 0x04, 0x08, 0x10,
                          0x20, 0x40, 0x80, 0x1b, 0x36};

inline uint8_t xtime(uint8_t x) {
    return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b));
}

struct AesKey {
    uint8_t round_keys[176];
};

void aes128_key_expand(const uint8_t key[16], AesKey* out) {
    uint8_t* rk = out->round_keys;
    std::memcpy(rk, key, 16);
    for (int i = 4; i < 44; ++i) {
        uint8_t t[4];
        std::memcpy(t, rk + 4 * (i - 1), 4);
        if (i % 4 == 0) {
            uint8_t tmp = t[0];
            t[0] = (uint8_t)(SBOX[t[1]] ^ RCON[i / 4]);
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[tmp];
        }
        for (int j = 0; j < 4; ++j)
            rk[4 * i + j] = (uint8_t)(rk[4 * (i - 4) + j] ^ t[j]);
    }
}

void aes128_encrypt_block_soft(const AesKey& k, const uint8_t in[16], uint8_t out[16]) {
    uint8_t s[16];
    for (int i = 0; i < 16; ++i) s[i] = in[i] ^ k.round_keys[i];
    for (int round = 1; round <= 10; ++round) {
        // SubBytes + ShiftRows
        uint8_t t[16];
        static const int SHIFT[16] = {0, 5, 10, 15, 4, 9, 14, 3,
                                      8, 13, 2, 7, 12, 1, 6, 11};
        for (int i = 0; i < 16; ++i) t[i] = SBOX[s[SHIFT[i]]];
        if (round < 10) {
            // MixColumns
            for (int c = 0; c < 4; ++c) {
                uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                        a3 = t[4 * c + 3];
                uint8_t x = (uint8_t)(a0 ^ a1 ^ a2 ^ a3);
                s[4 * c]     = (uint8_t)(a0 ^ x ^ xtime((uint8_t)(a0 ^ a1)));
                s[4 * c + 1] = (uint8_t)(a1 ^ x ^ xtime((uint8_t)(a1 ^ a2)));
                s[4 * c + 2] = (uint8_t)(a2 ^ x ^ xtime((uint8_t)(a2 ^ a3)));
                s[4 * c + 3] = (uint8_t)(a3 ^ x ^ xtime((uint8_t)(a3 ^ a0)));
            }
        } else {
            std::memcpy(s, t, 16);
        }
        for (int i = 0; i < 16; ++i) s[i] ^= k.round_keys[16 * round + i];
    }
    std::memcpy(out, s, 16);
}

#ifdef TFHE_X86
// Hardware pipeline: 10 aesenc rounds on the soft-expanded round keys (the
// schedule is backend-independent, so streams match the soft path exactly).
__attribute__((target("aes,sse2")))
void aes128_encrypt_block_ni(const AesKey& k, const uint8_t in[16], uint8_t out[16]) {
    __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in));
    s = _mm_xor_si128(s, _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(k.round_keys)));
    for (int round = 1; round < 10; ++round)
        s = _mm_aesenc_si128(s, _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(k.round_keys + 16 * round)));
    s = _mm_aesenclast_si128(s, _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(k.round_keys + 160)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out), s);
}
#endif

bool aesni_available() {
    static int cached = -1;
    if (cached < 0) {
#ifdef TFHE_X86
        const char* force = std::getenv("TFHE_CSPRNG_FORCE_SOFT");
        cached = (force && force[0] == '1') ? 0
                 : (__builtin_cpu_supports("aes") ? 1 : 0);
#else
        cached = 0;
#endif
    }
    return cached == 1;
}

void aes128_encrypt_block(const AesKey& k, const uint8_t in[16], uint8_t out[16]) {
#ifdef TFHE_X86
    if (aesni_available()) {
        aes128_encrypt_block_ni(k, in, out);
        return;
    }
#endif
    aes128_encrypt_block_soft(k, in, out);
}

struct Generator {
    AesKey key;
    uint64_t counter_hi;   // fork path component
    uint64_t counter_lo;   // block index
    uint8_t buf[16];
    int buf_used;          // bytes consumed from buf (16 = empty)
};

void refill(Generator* g) {
    uint8_t block[16];
    std::memcpy(block, &g->counter_hi, 8);
    std::memcpy(block + 8, &g->counter_lo, 8);
    aes128_encrypt_block(g->key, block, g->buf);
    g->counter_lo++;
    g->buf_used = 0;
}

}  // namespace

extern "C" {

void* csprng_new(const uint8_t seed[16], uint64_t stream_hi) {
    Generator* g = new Generator();
    aes128_key_expand(seed, &g->key);
    g->counter_hi = stream_hi;
    g->counter_lo = 0;
    g->buf_used = 16;
    return g;
}

void csprng_free(void* gen) { delete static_cast<Generator*>(gen); }

void csprng_fill(void* gen, uint8_t* out, uint64_t n) {
    Generator* g = static_cast<Generator*>(gen);
    for (uint64_t i = 0; i < n; ++i) {
        if (g->buf_used == 16) refill(g);
        out[i] = g->buf[g->buf_used++];
    }
}

// Deterministic fork: the child's 128-bit key is drawn from the parent
// stream, its stream-id is the fork index — parallel generation over forks
// reproduces any sequential order (reference aes_ctr fork-tree contract).
void* csprng_fork(void* gen, uint64_t child_index) {
    Generator* g = static_cast<Generator*>(gen);
    uint8_t child_seed[16];
    csprng_fill(g, child_seed, 16);
    return csprng_new(child_seed, child_index);
}

// one-shot AES-128 block encryption (for tests against FIPS-197 vectors)
void csprng_aes_block(const uint8_t key[16], const uint8_t in[16], uint8_t out[16]) {
    AesKey k;
    aes128_key_expand(key, &k);
    aes128_encrypt_block(k, in, out);
}

// software-path twin, so tests can assert aesni == soft on any machine
void csprng_aes_block_soft(const uint8_t key[16], const uint8_t in[16],
                           uint8_t out[16]) {
    AesKey k;
    aes128_key_expand(key, &k);
    aes128_encrypt_block_soft(k, in, out);
}

// which backend is live: 1 = AES-NI hardware, 0 = portable software
int csprng_backend() { return aesni_available() ? 1 : 0; }

}  // extern "C"
