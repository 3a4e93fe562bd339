// rrs_core — native host-side codecs of rrs_tpu_torch (a copy of the JAX
// package's csrc/rrs_core.cpp).
//
// The GGUF block codecs, the TCQ4 quantizer and the BPE merge loop that the
// reference implements in C (ggml/src/ggml-quants.c, ggml/src/ggml-cpu/rrs.c,
// src/llama-vocab.cpp), for load-time speed on the host; device compute stays
// in the CUDA kernels. Built with g++ and bound via ctypes
// (rrs_tpu_torch/native.py), with a NumPy fallback where it cannot build.
//
// Everything operates on caller-allocated buffers; no global state.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// FWHT: normalized in-place Walsh–Hadamard over rows (self-inverse).
// Semantics match ggml_fwht_impl (ggml-cpu/rrs.c:41-123): iterative
// butterflies with 1/sqrt(n) normalization.
// ---------------------------------------------------------------------------
void rrs_fwht_rows_f32(float* data, int64_t n_rows, int64_t row_len) {
    const float norm = 1.0f / std::sqrt((float)row_len);
    for (int64_t r = 0; r < n_rows; ++r) {
        float* x = data + r * row_len;
        for (int64_t h = 1; h < row_len; h <<= 1) {
            for (int64_t i = 0; i < row_len; i += h << 1) {
                for (int64_t j = i; j < i + h; ++j) {
                    float a = x[j];
                    float b = x[j + h];
                    x[j] = a + b;
                    x[j + h] = a - b;
                }
            }
        }
        for (int64_t j = 0; j < row_len; ++j) x[j] *= norm;
    }
}

// ---------------------------------------------------------------------------
// fp16 helpers (IEEE binary16 <-> f32, round-to-nearest-even)
// ---------------------------------------------------------------------------
static inline float fp16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            // subnormal: normalize
            int shift = 0;
            while (!(man & 0x400)) { man <<= 1; ++shift; }
            man &= 0x3FF;
            bits = sign | ((127 - 15 - shift + 1) << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000 | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static inline uint16_t f32_to_fp16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    uint32_t sign = (bits >> 16) & 0x8000;
    int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
    uint32_t man = bits & 0x7FFFFF;
    if (exp >= 31) return (uint16_t)(sign | 0x7C00);           // inf/overflow
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;                   // underflow
        man |= 0x800000;
        int shift = 14 - exp;
        uint32_t r = man >> shift;
        uint32_t rem = man & ((1u << shift) - 1);
        uint32_t half = 1u << (shift - 1);
        if (rem > half || (rem == half && (r & 1))) ++r;
        return (uint16_t)(sign | r);
    }
    uint32_t r = man >> 13;
    uint32_t rem = man & 0x1FFF;
    if (rem > 0x1000 || (rem == 0x1000 && (r & 1))) {
        ++r;
        if (r == 0x400) { r = 0; ++exp; if (exp >= 31) return (uint16_t)(sign | 0x7C00); }
    }
    return (uint16_t)(sign | (exp << 10) | r);
}

// ---------------------------------------------------------------------------
// TCQ4 GGUF tile decode: block_tcq4_tile bytes -> K-major (qs, eff).
// Tile layout (ggml-common.h:308-348): tiles[8][128] IMMA-fragment int4,
// fp16 S[8]/Z[8], int8 sc[8][8]/zc[8][8]; lane L owns channel L/4, k-slice
// L%4 (tcq4_pack_imma_tile, ggml-quants.c:1380-1400).
// Output: qs_out uint8 [K/2, N] (per-superblock nibble packing: byte
// (kb*128+j, n) = q[kb*256+j] | q[kb*256+128+j]<<4), eff_out f32 [K/32, N]
// with eff = fp32(S) * sc / 127.
// ---------------------------------------------------------------------------
void rrs_tcq4_decode_tiles(
    const uint8_t* tiles, int64_t n_rows, int64_t k,
    uint8_t* qs_out, float* eff_out
) {
    const int64_t kt = k / 256;
    const int64_t tile_bytes = 1184;
    // temp per-tile unpacked weights
    for (int64_t rg = 0; rg < n_rows / 8; ++rg) {
        for (int64_t t = 0; t < kt; ++t) {
            const uint8_t* tile = tiles + (rg * kt + t) * tile_bytes;
            const uint8_t* frag = tile;               // [8 groups][128B]
            const uint8_t* Sp = tile + 1024;          // fp16[8]
            const int8_t* scp = (const int8_t*)(tile + 1056);  // [8c][8g]

            for (int g = 0; g < 8; ++g) {
                const uint8_t* gf = frag + g * 128;
                for (int lane = 0; lane < 32; ++lane) {
                    int c = lane >> 2;                 // channel
                    int ks = (lane & 3) * 8;           // k-slice start
                    for (int i = 0; i < 8; ++i) {
                        int byte = gf[lane * 4 + (i >> 1)];
                        int nib = (i & 1) ? (byte >> 4) : (byte & 0xF);
                        // k within superblock
                        int kk = g * 32 + ks + i;
                        int64_t row = t * 256 + kk;    // global k
                        int64_t col = rg * 8 + c;      // global n
                        // pack into per-superblock nibble layout
                        int64_t half = (row % 256) >= 128;
                        int64_t j = (row % 256) % 128;
                        uint8_t* dst = qs_out + ((int64_t)(row / 256) * 128 + j) * n_rows + col;
                        if (half) *dst = (uint8_t)((*dst & 0x0F) | ((nib & 0xF) << 4));
                        else      *dst = (uint8_t)((*dst & 0xF0) | (nib & 0xF));
                    }
                }
                for (int c = 0; c < 8; ++c) {
                    float S = fp16_to_f32(((const uint16_t*)Sp)[c]);
                    float eff = S * (float)scp[c * 8 + g] / 127.0f;
                    int64_t grow = t * 8 + g;          // global group index
                    eff_out[grow * n_rows + rg * 8 + c] = eff;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// TCQ4 quantizer: f32 [n_rows, k] row-major -> per-8-row tiles, emitted
// directly in the K-major device layout (qs [K/2, N], sc [K/32, N] int8,
// S16 [K/256, N] fp16). Numerics match quantize_tcq4_tile
// (ggml-quants.c:1530-1640): FWHT per 256-chunk, per-(channel,group)
// absmax/7 scale floored at 1e-10, q=clamp(roundf(w/scale),-8,7),
// S=max scale (fp16), sc=clamp(roundf(scale/S*127),-127,127).
// ---------------------------------------------------------------------------
void rrs_tcq4_quantize(
    const float* w, int64_t n_rows, int64_t k,
    uint8_t* qs_out, int8_t* sc_out, uint16_t* S_out,
    float* scratch /* size >= k */
) {
    const int64_t kt = k / 256;
    for (int64_t r = 0; r < n_rows; ++r) {
        std::memcpy(scratch, w + r * k, k * sizeof(float));
        rrs_fwht_rows_f32(scratch, kt, 256);
        for (int64_t t = 0; t < kt; ++t) {
            const float* blk = scratch + t * 256;
            float scales[8];
            float maxs = 0.0f;
            for (int g = 0; g < 8; ++g) {
                float amax = 0.0f;
                for (int j = 0; j < 32; ++j) {
                    float v = std::fabs(blk[g * 32 + j]);
                    if (v > amax) amax = v;
                }
                float s = amax / 7.0f;
                if (s < 1e-10f) s = 1.0f;
                scales[g] = s;
                if (s > maxs) maxs = s;
            }
            float S = maxs > 0.0f ? maxs : 1.0f;
            S_out[t * n_rows + r] = f32_to_fp16(S);
            for (int g = 0; g < 8; ++g) {
                float scf = scales[g] / S * 127.0f;
                float scr = std::round(scf);
                scr = std::max(-127.0f, std::min(127.0f, scr));
                sc_out[(t * 8 + g) * n_rows + r] = (int8_t)scr;
                float inv = 1.0f / scales[g];
                for (int j = 0; j < 32; ++j) {
                    int kk = g * 32 + j;               // within superblock
                    float q = std::round(blk[kk] * inv);
                    q = std::max(-8.0f, std::min(7.0f, q));
                    int nib = ((int)q) & 0xF;
                    int64_t half = kk >= 128;
                    int64_t jj = kk % 128;
                    uint8_t* dst = qs_out + (t * 128 + jj) * n_rows + r;
                    if (half) *dst = (uint8_t)((*dst & 0x0F) | (nib << 4));
                    else      *dst = (uint8_t)((*dst & 0xF0) | nib);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Q8_0 / Q4_K / Q6_K dequant (load-time; semantics of dequantize_row_*
// in ggml-quants.c)
// ---------------------------------------------------------------------------
void rrs_dequant_q8_0(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 32;
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 34;
        float d = fp16_to_f32(*(const uint16_t*)b);
        const int8_t* q = (const int8_t*)(b + 2);
        for (int j = 0; j < 32; ++j) out[i * 32 + j] = d * q[j];
    }
}

static inline void q4k_scale_min(int j, const uint8_t* s, uint8_t* d, uint8_t* m) {
    if (j < 4) {
        *d = s[j] & 63;
        *m = s[j + 4] & 63;
    } else {
        *d = (uint8_t)((s[j + 4] & 0xF) | ((s[j - 4] >> 6) << 4));
        *m = (uint8_t)((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
    }
}

void rrs_dequant_q4_k(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 256;
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 144;
        float d = fp16_to_f32(*(const uint16_t*)b);
        float dmin = fp16_to_f32(*(const uint16_t*)(b + 2));
        const uint8_t* scales = b + 4;
        const uint8_t* qs = b + 16;
        float* y = out + i * 256;
        int is = 0;
        for (int c = 0; c < 4; ++c) {
            uint8_t sc, m;
            q4k_scale_min(is + 0, scales, &sc, &m);
            float d1 = d * sc, m1 = dmin * m;
            q4k_scale_min(is + 1, scales, &sc, &m);
            float d2 = d * sc, m2 = dmin * m;
            for (int l = 0; l < 32; ++l) y[c * 64 + l] = d1 * (qs[c * 32 + l] & 0xF) - m1;
            for (int l = 0; l < 32; ++l) y[c * 64 + 32 + l] = d2 * (qs[c * 32 + l] >> 4) - m2;
            is += 2;
        }
    }
}

void rrs_dequant_q6_k(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 256;
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 210;
        const uint8_t* ql = b;
        const uint8_t* qh = b + 128;
        const int8_t* sc = (const int8_t*)(b + 192);
        float d = fp16_to_f32(*(const uint16_t*)(b + 208));
        float* y = out + i * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* qlh = ql + half * 64;
            const uint8_t* qhh = qh + half * 32;
            const int8_t* sch = sc + half * 8;
            for (int l = 0; l < 32; ++l) {
                int is = l / 16;
                int q1 = (int)((qlh[l] & 0xF) | (((qhh[l] >> 0) & 3) << 4)) - 32;
                int q2 = (int)((qlh[l + 32] & 0xF) | (((qhh[l] >> 2) & 3) << 4)) - 32;
                int q3 = (int)((qlh[l] >> 4) | (((qhh[l] >> 4) & 3) << 4)) - 32;
                int q4 = (int)((qlh[l + 32] >> 4) | (((qhh[l] >> 6) & 3) << 4)) - 32;
                int base = half * 128;
                y[base + l] = d * sch[is + 0] * q1;
                y[base + l + 32] = d * sch[is + 2] * q2;
                y[base + l + 64] = d * sch[is + 4] * q3;
                y[base + l + 96] = d * sch[is + 6] * q4;
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BPE merge engine (llm_tokenizer_bpe hot loop, src/llama-vocab.cpp).
// Python keeps the pretokenizer regex + byte encoding; this runs the rank-
// driven pair merging over a UTF-8 fragment of byte-encoder symbols and
// resolves pieces to ids. Session state is built once per vocab.
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct BpeSession {
    std::unordered_map<std::string, int32_t> vocab;
    std::unordered_map<std::string, int32_t> merge_rank;  // "left\x01right"
};

std::vector<BpeSession*> g_bpe_sessions;

inline size_t utf8_len(unsigned char c) {
    if (c < 0x80) return 1;
    if ((c >> 5) == 0x6) return 2;
    if ((c >> 4) == 0xE) return 3;
    if ((c >> 3) == 0x1E) return 4;
    return 1;
}

}  // namespace

extern "C" {

// blobs: concatenated utf-8 strings; offsets: n+1 cumulative byte offsets
int64_t rrs_bpe_init(const char* vocab_blob, const int64_t* vocab_off,
                     int64_t n_vocab, const char* merge_blob,
                     const int64_t* merge_off, int64_t n_merges) {
    auto* s = new BpeSession();
    s->vocab.reserve((size_t)n_vocab * 2);
    for (int64_t i = 0; i < n_vocab; ++i) {
        // assignment, not emplace: duplicate token strings resolve to the
        // LAST id, matching token_to_id[word] = i (llama-vocab.cpp:2105) —
        // MPT's vocab has duplicate whitespace tokens
        s->vocab[std::string(vocab_blob + vocab_off[i],
                             vocab_blob + vocab_off[i + 1])] = (int32_t)i;
    }
    s->merge_rank.reserve((size_t)n_merges * 2);
    for (int64_t i = 0; i < n_merges; ++i) {
        std::string m(merge_blob + merge_off[i], merge_blob + merge_off[i + 1]);
        size_t sp = m.find(' ');
        if (sp == std::string::npos) continue;
        std::string key = m.substr(0, sp);
        key.push_back('\x01');
        key.append(m, sp + 1, std::string::npos);
        s->merge_rank.emplace(std::move(key), (int32_t)i);
    }
    g_bpe_sessions.push_back(s);
    return (int64_t)g_bpe_sessions.size() - 1;
}

// Encode one byte-encoded fragment. Returns count written to out (ids), or
// -1 if any piece has no id (caller falls back to byte tokens in Python).
int64_t rrs_bpe_encode(int64_t handle, const char* frag, int64_t frag_len,
                       int32_t* out, int64_t max_out) {
    const BpeSession* s = g_bpe_sessions[(size_t)handle];
    // initial symbols: single utf-8 codepoints
    std::vector<std::string> syms;
    syms.reserve((size_t)frag_len);
    for (int64_t i = 0; i < frag_len;) {
        size_t l = utf8_len((unsigned char)frag[i]);
        if ((int64_t)(i + l) > frag_len) l = 1;
        syms.emplace_back(frag + i, frag + i + l);
        i += (int64_t)l;
    }
    // greedy lowest-rank merges (matches the Python _bpe_merge loop)
    std::string key;
    while (syms.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < syms.size(); ++i) {
            key.assign(syms[i]);
            key.push_back('\x01');
            key.append(syms[i + 1]);
            auto it = s->merge_rank.find(key);
            if (it != s->merge_rank.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        syms[best_i].append(syms[best_i + 1]);
        syms.erase(syms.begin() + (long)best_i + 1);
    }
    int64_t n = 0;
    for (const auto& p : syms) {
        auto it = s->vocab.find(p);
        if (it == s->vocab.end()) return -1;
        if (n >= max_out) return -1;
        out[n++] = it->second;
    }
    return n;
}

}  // extern "C"
