// Native tokenizer hot paths: SPM bigram merging and BPE rank merging.
//
// The C++ runtime analogue of the reference's llm_tokenizer_spm /
// llm_tokenizer_bpe inner loops (src/llama-vocab.cpp) — the Python side
// keeps pre-tokenization (regex) and all special-token handling, and calls
// in here per text fragment (SPM) or per pre-token batch (BPE). Semantics
// are behavior-matched to prima_tpu/tokenizer/{spm,bpe}.py, which remain
// the always-available reference implementation (tests/test_native.py
// asserts identical output on the reference vocab fixtures).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tok {
    std::unordered_map<std::string, int32_t> id;
    std::vector<float> scores;
    std::vector<int8_t> types;
    std::unordered_map<std::string, int32_t> rank;  // "left right" -> rank
    int32_t byte_tok[256];
};

inline int64_t cp_len(uint8_t b) {
    if (b < 0x80) return 1;
    if ((b & 0xE0) == 0xC0) return 2;
    if ((b & 0xF0) == 0xE0) return 3;
    if ((b & 0xF8) == 0xF0) return 4;
    return 1;  // invalid lead byte: treat as a single symbol
}

struct Sym {
    int64_t off, len;
    int32_t prev, next;
    bool alive;
};

// split [text, text+len) into codepoint symbols (doubly linked by index)
inline void split_syms(const uint8_t* text, int64_t len, std::vector<Sym>& syms) {
    for (int64_t p = 0; p < len;) {
        int64_t l = cp_len(text[p]);
        if (p + l > len) l = 1;
        int32_t i = (int32_t)syms.size();
        syms.push_back({p, l, i - 1, i + 1, true});
        p += l;
    }
}

constexpr int8_t TT_NORMAL = 1;
constexpr int8_t TT_UNUSED = 5;

}  // namespace

extern "C" {

void* prima_tok_new(const uint8_t* blob, const int64_t* offs, int64_t n,
                    const float* scores, const int8_t* types,
                    const uint8_t* mblob, const int64_t* moffs, int64_t nm,
                    const int32_t* byte_tok) {
    Tok* t = new Tok();
    t->id.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; ++i)  // later duplicates win, like dict build
        t->id[std::string((const char*)blob + offs[i],
                          (size_t)(offs[i + 1] - offs[i]))] = (int32_t)i;
    if (scores) t->scores.assign(scores, scores + n);
    if (types) t->types.assign(types, types + n);
    t->rank.reserve((size_t)nm * 2);
    for (int64_t i = 0; i < nm; ++i)
        t->rank[std::string((const char*)mblob + moffs[i],
                            (size_t)(moffs[i + 1] - moffs[i]))] = (int32_t)i;
    for (int i = 0; i < 256; ++i) t->byte_tok[i] = byte_tok ? byte_tok[i] : -1;
    return t;
}

void prima_tok_free(void* h) { delete (Tok*)h; }

// SPM greedy bigram merge over an already whitespace-escaped fragment.
// Returns the number of ids written, or -1 if `cap` is too small.
int64_t prima_spm_encode(void* h, const uint8_t* text, int64_t len,
                         int32_t* out, int64_t cap) {
    Tok& t = *(Tok*)h;
    std::vector<Sym> syms;
    split_syms(text, len, syms);
    const int32_t n = (int32_t)syms.size();
    if (n == 0) return 0;

    struct Cand {
        float score;
        int32_t i;
        int64_t mlen;
    };
    // max score first; ties -> leftmost (matches the Python heap ordering)
    auto cmp = [](const Cand& a, const Cand& b) {
        if (a.score != b.score) return a.score < b.score;
        return a.i > b.i;
    };
    std::priority_queue<Cand, std::vector<Cand>, decltype(cmp)> heap(cmp);
    std::string buf;

    auto push = [&](int32_t i) {
        int32_t j = syms[i].next;
        if (j >= n) return;
        buf.assign((const char*)text + syms[i].off,
                   (size_t)(syms[i].len + syms[j].len));
        auto it = t.id.find(buf);
        if (it != t.id.end() && t.types[it->second] == TT_NORMAL)
            heap.push({t.scores[it->second], i, syms[i].len + syms[j].len});
    };
    for (int32_t i = 0; i < n - 1; ++i) push(i);

    while (!heap.empty()) {
        Cand c = heap.top();
        heap.pop();
        if (!syms[c.i].alive) continue;
        int32_t j = syms[c.i].next;
        // a symbol is always a contiguous byte range, so equal total length
        // at the same offset means identical merged content (stale check)
        if (j >= n || !syms[j].alive || syms[c.i].len + syms[j].len != c.mlen)
            continue;
        syms[c.i].len += syms[j].len;
        syms[j].alive = false;
        syms[c.i].next = syms[j].next;
        if (syms[c.i].next < n) syms[syms[c.i].next].prev = c.i;
        push(c.i);
        if (syms[c.i].prev >= 0) push(syms[c.i].prev);
    }

    int64_t m = 0;
    for (int32_t i = 0; i < n; i = syms[i].next) {
        buf.assign((const char*)text + syms[i].off, (size_t)syms[i].len);
        auto it = t.id.find(buf);
        if (it != t.id.end() && t.types[it->second] != TT_UNUSED) {
            if (m >= cap) return -1;
            out[m++] = it->second;
        } else {
            for (int64_t b = 0; b < syms[i].len; ++b) {
                if (m >= cap) return -1;
                out[m++] = t.byte_tok[text[syms[i].off + b]];
            }
        }
        if (syms[i].next >= n) break;
    }
    return m;
}

// BPE rank merging over byte-to-unicode-mapped pre-tokens. `blob` holds
// n_words concatenated utf-8 words delimited by woffs (n_words+1 entries).
// ignore_merges: try the whole word as one vocab token first (llama-3).
int64_t prima_bpe_encode_words(void* h, const uint8_t* blob,
                               const int64_t* woffs, int64_t n_words,
                               int32_t ignore_merges, int32_t* out,
                               int64_t cap) {
    Tok& t = *(Tok*)h;
    struct Cand {
        int32_t rank, i;
        int64_t llen, rlen;
    };
    // min rank first; ties -> leftmost
    auto cmp = [](const Cand& a, const Cand& b) {
        if (a.rank != b.rank) return a.rank > b.rank;
        return a.i > b.i;
    };
    std::string buf;
    int64_t m = 0;
    std::vector<Sym> syms;

    for (int64_t w = 0; w < n_words; ++w) {
        const uint8_t* word = blob + woffs[w];
        const int64_t wlen = woffs[w + 1] - woffs[w];
        if (wlen == 0) continue;
        if (ignore_merges) {
            buf.assign((const char*)word, (size_t)wlen);
            auto it = t.id.find(buf);
            if (it != t.id.end()) {
                if (m >= cap) return -1;
                out[m++] = it->second;
                continue;
            }
        }
        syms.clear();
        split_syms(word, wlen, syms);
        const int32_t n = (int32_t)syms.size();
        std::priority_queue<Cand, std::vector<Cand>, decltype(cmp)> heap(cmp);

        auto push = [&](int32_t i) {
            int32_t j = syms[i].next;
            if (j >= n) return;
            buf.assign((const char*)word + syms[i].off, (size_t)syms[i].len);
            buf.push_back(' ');  // merge table keys are "left right"
            buf.append((const char*)word + syms[j].off, (size_t)syms[j].len);
            auto it = t.rank.find(buf);
            if (it != t.rank.end())
                heap.push({it->second, i, syms[i].len, syms[j].len});
        };
        for (int32_t i = 0; i < n - 1; ++i) push(i);

        while (!heap.empty()) {
            Cand c = heap.top();
            heap.pop();
            if (!syms[c.i].alive || syms[c.i].len != c.llen) continue;
            int32_t j = syms[c.i].next;
            if (j >= n || !syms[j].alive || syms[j].len != c.rlen) continue;
            syms[c.i].len += syms[j].len;
            syms[j].alive = false;
            syms[c.i].next = syms[j].next;
            if (syms[c.i].next < n) syms[syms[c.i].next].prev = c.i;
            push(c.i);
            if (syms[c.i].prev >= 0) push(syms[c.i].prev);
        }

        for (int32_t i = 0; i < n; i = syms[i].next) {
            buf.assign((const char*)word + syms[i].off, (size_t)syms[i].len);
            auto it = t.id.find(buf);
            if (it != t.id.end()) {
                if (m >= cap) return -1;
                out[m++] = it->second;
            } else {
                // unreachable for a complete byte-level vocab: emit the ids
                // of the piece's individual characters where present
                for (int64_t p = 0; p < syms[i].len;) {
                    int64_t l = cp_len(word[syms[i].off + p]);
                    if (p + l > syms[i].len) l = 1;
                    buf.assign((const char*)word + syms[i].off + p, (size_t)l);
                    auto ch = t.id.find(buf);
                    if (ch != t.id.end()) {
                        if (m >= cap) return -1;
                        out[m++] = ch->second;
                    }
                    p += l;
                }
            }
            if (syms[i].next >= n) break;
        }
    }
    return m;
}

}  // extern "C"
