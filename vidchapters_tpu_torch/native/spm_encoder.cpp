// Native unigram-sentencepiece Viterbi encoder.
//
// C++ twin of vidchapters_tpu_torch/data/tokenizer.SentencePieceUnigramTokenizer's
// Python Viterbi (its _viterbi) —
// the data factory tokenizes millions of ASR transcripts (reference:
// args.py max_input_tokens over HowTo100M/VidChapters-7M scale), and the
// pure-Python Viterbi is the collate bottleneck there. Exact same
// semantics: byte-level Viterbi (piece matches on valid UTF-8 can only
// start/end at code-point boundaries, so byte == char segmentation),
// strict-improvement tie-breaks in (i asc, j asc, unk last) order, and a
// one-CODEPOINT unk fallback. Normalization stays in Python; this
// receives the normalized UTF-8 string.
//
// Hot-loop design: substrings are identified by an INCREMENTAL FNV-1a
// hash (one multiply-xor per extension byte — no string construction or
// rehash per candidate). The prefix set is hash-only (a false positive
// merely delays the early exit; it can never change the output); piece
// matches verify the actual bytes against the stored piece, so hash
// collisions cannot mis-tokenize.
//
// Exposed as a plain C ABI for ctypes; built by
// vidchapters_tpu_torch/data/_native_build.py.

#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv_step(uint64_t h, unsigned char c) {
    return (h ^ c) * kFnvPrime;
}

struct Encoder {
    std::vector<std::string> pieces;
    std::vector<double> scores;
    // piece hash -> candidate ids (verified byte-exact before matching)
    std::unordered_map<uint64_t, std::vector<int32_t>> by_hash;
    std::unordered_set<uint64_t> prefix_hashes;  // proper prefixes
    int64_t max_piece_bytes = 0;
    double unk_score = 0.0;
    int32_t unk_id = 2;
};

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline bool is_continuation(unsigned char c) { return (c & 0xC0) == 0x80; }

}  // namespace

extern "C" {

void* spm_create(const char* const* pieces, const double* scores, int64_t n,
                 int32_t unk_id, double unk_score) {
    auto* e = new Encoder();
    e->scores.assign(scores, scores + n);
    e->pieces.reserve(static_cast<size_t>(n));
    e->by_hash.reserve(static_cast<size_t>(n) * 2);
    e->unk_id = unk_id;
    e->unk_score = unk_score;
    for (int64_t i = 0; i < n; ++i) {
        std::string p(pieces[i]);
        const int64_t len = static_cast<int64_t>(p.size());
        if (len > e->max_piece_bytes) e->max_piece_bytes = len;
        uint64_t h = kFnvOffset;
        for (size_t b = 0; b + 1 < p.size(); ++b) {
            h = fnv_step(h, static_cast<unsigned char>(p[b]));
            e->prefix_hashes.insert(h);  // every proper prefix
        }
        if (!p.empty()) {
            h = fnv_step(h, static_cast<unsigned char>(p.back()));
        }
        e->by_hash[h].push_back(static_cast<int32_t>(i));
        e->pieces.push_back(std::move(p));
    }
    return e;
}

void spm_destroy(void* h) { delete static_cast<Encoder*>(h); }

// Viterbi-encode one normalized UTF-8 string of explicit byte length
// (NOT NUL-terminated semantics: embedded NULs tokenize as unk, exactly
// like the Python twin). Returns the id count, or -needed when out_cap
// is too small (caller retries with a bigger buffer).
int64_t spm_encode(void* handle, const char* text, int64_t n,
                   int32_t* out_ids, int64_t out_cap) {
    const Encoder& e = *static_cast<Encoder*>(handle);
    if (n == 0) return 0;
    std::vector<double> best(n + 1, kNegInf);
    std::vector<int64_t> back_pos(n + 1, -1);
    std::vector<int32_t> back_id(n + 1, e.unk_id);
    best[0] = 0.0;
    const auto hash_end = e.by_hash.end();
    const auto pref_end = e.prefix_hashes.end();
    for (int64_t i = 0; i < n; ++i) {
        if (best[i] == kNegInf) continue;
        const int64_t j_max = std::min(n, i + e.max_piece_bytes);
        uint64_t h = kFnvOffset;
        for (int64_t j = i + 1; j <= j_max; ++j) {
            h = fnv_step(h, static_cast<unsigned char>(text[j - 1]));
            const auto it = e.by_hash.find(h);
            if (it != hash_end) {
                const size_t sub_len = static_cast<size_t>(j - i);
                for (const int32_t pid : it->second) {
                    const std::string& p = e.pieces[pid];
                    if (p.size() == sub_len
                        && std::memcmp(p.data(), text + i, sub_len) == 0) {
                        const double sc = best[i] + e.scores[pid];
                        if (sc > best[j]) {
                            best[j] = sc;
                            back_pos[j] = i;
                            back_id[j] = pid;
                        }
                        break;  // distinct pieces are unique strings
                    }
                }
            } else if (e.prefix_hashes.find(h) == pref_end) {
                break;  // no piece extends this substring
            }
        }
        // unk fallback consumes one code point
        int64_t k = i + 1;
        while (k < n && is_continuation(static_cast<unsigned char>(text[k])))
            ++k;
        const double sc = best[i] + e.unk_score;
        if (sc > best[k]) {
            best[k] = sc;
            back_pos[k] = i;
            back_id[k] = e.unk_id;
        }
    }
    // backtrace (count first, then fill reversed)
    int64_t count = 0;
    for (int64_t j = n; j > 0; j = back_pos[j]) ++count;
    if (count > out_cap) return -count;
    int64_t w = count;
    for (int64_t j = n; j > 0; j = back_pos[j]) out_ids[--w] = back_id[j];
    return count;
}

}  // extern "C"
