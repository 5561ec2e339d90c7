// Fast review tokenizer: the host-side hot spot of dataset construction
// (reference src/dataset.py:21-27 runs a python tokenize+dict-lookup over
// every review; minutes-scale on the 8M-review Yelp corpus).
//
// Exact semantics contract (enforced by tests/test_torch_native.py against the
// python path): for a document in UTF-8 bytes,
//   parts = doc.strip('. ').split('.')        (sentence level)  |  [doc]
//   tokens = part.replace('.', ' ').strip().split()   (ASCII whitespace)
//   id = 2 if token is all ASCII digits else vocab.get(token, 1)
//   sentence kept iff len(ids[:max_len]) > keep_gt (5 in the reference)
// UTF-8 is safe at byte level: '.' (0x2E) and the ASCII whitespace bytes
// never occur inside a multibyte sequence, all_digits rejects any byte
// outside '0'..'9', and vocab keys are UTF-8 bytes (byte equality ==
// str equality).  The wrapper routes to the python path only documents
// containing a RISKY non-ASCII char -- unicode whitespace (str.split()
// splits there) or unicode digits (str.isdigit() accepts them) -- so
// those two python-semantics divergences never reach this code.
//
// Build: g++ -O3 -shared -fPIC (see umpr_tpu_torch/native/__init__.py); plain C
// ABI + ctypes, no pybind11.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> map;
};

inline bool is_space(unsigned char c) {
    // Python str.split() additionally treats the ASCII separators
    // \x1c-\x1f (FS/GS/RS/US) as whitespace; match it byte-exactly.
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v' || (c >= 0x1c && c <= 0x1f);
}

inline bool all_digits(const char* s, size_t n) {
    if (n == 0) return false;
    for (size_t i = 0; i < n; i++)
        if (s[i] < '0' || s[i] > '9') return false;
    return true;
}

}  // namespace

extern "C" {

// words: '\n'-separated UTF-8 word list; ids are 3 + line index (PAD/UNK/NUM
// reserved), matching Word2vec's layout.  Duplicate words replicate the
// python dict's `word2index[w] = len(word2index)` exactly: the id is
// 3 + current UNIQUE-word count and a repeat OVERWRITES its entry without
// advancing that count (vocab.py:78-79's reference-exact quirk) -- emplace
// (first-wins, always-advancing) would tokenize differently from the python
// fallback on files with duplicate/reserved words.
void* vocab_build(const char* words, int64_t len) {
    auto* v = new Vocab();
    const char* p = words;
    const char* end = words + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        size_t n = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
        int32_t id = static_cast<int32_t>(3 + v->map.size());
        v->map[std::string(p, n)] = id;
        p += n + 1;
    }
    return v;
}

void vocab_free(void* vp) { delete static_cast<Vocab*>(vp); }

// Tokenize n_docs documents stored concatenated in buf with byte offsets
// doc_offsets[0..n_docs].  Outputs:
//   out_ids           flat token ids, sentence-major
//   out_sent_starts   per-sentence start index into out_ids (n_sents + 1,
//                     the final entry is the total id count)
//   out_doc_counts    surviving-sentence count per document
// Returns total sentence count, or -1 if either capacity is exceeded.
int64_t tokenize_docs(void* vp, const char* buf, const int64_t* doc_offsets,
                      int64_t n_docs, int32_t max_len, int32_t sentence_level,
                      int32_t keep_gt, int32_t* out_ids,
                      int64_t* out_sent_starts, int64_t* out_doc_counts,
                      int64_t cap_ids, int64_t cap_sents) {
    const Vocab& vocab = *static_cast<Vocab*>(vp);
    int64_t n_ids = 0, n_sents = 0;
    std::vector<int32_t> sent;
    sent.reserve(max_len);

    for (int64_t d = 0; d < n_docs; d++) {
        const char* doc = buf + doc_offsets[d];
        const char* doc_end = buf + doc_offsets[d + 1];
        // python str.strip('. '): trim '.' and ' ' from both ends
        while (doc < doc_end && (*doc == '.' || *doc == ' ')) doc++;
        while (doc_end > doc && (doc_end[-1] == '.' || doc_end[-1] == ' ')) doc_end--;

        int64_t kept = 0;
        const char* part = doc;
        while (part <= doc_end) {
            const char* part_end;
            if (sentence_level) {
                part_end = static_cast<const char*>(
                    memchr(part, '.', doc_end - part));
                if (!part_end) part_end = doc_end;
            } else {
                part_end = doc_end;
            }

            // tokenize part: split on ASCII whitespace ('.' can't appear --
            // it's the separator; at review level a '.' acts as whitespace
            // per sent2indices' replace('.', ' '))
            sent.clear();
            const char* t = part;
            while (t < part_end && static_cast<int32_t>(sent.size()) < max_len) {
                while (t < part_end && (is_space(*t) || *t == '.')) t++;
                const char* tok = t;
                while (t < part_end && !is_space(*t) && *t != '.') t++;
                if (t == tok) continue;
                size_t n = t - tok;
                if (all_digits(tok, n)) {
                    sent.push_back(2);  // <NUM>
                } else {
                    auto it = vocab.map.find(std::string(tok, n));
                    sent.push_back(it == vocab.map.end() ? 1 : it->second);
                }
            }
            if (static_cast<int32_t>(sent.size()) > keep_gt) {
                if (n_sents + 1 >= cap_sents ||
                    n_ids + static_cast<int64_t>(sent.size()) > cap_ids)
                    return -1;
                out_sent_starts[n_sents++] = n_ids;
                memcpy(out_ids + n_ids, sent.data(), sent.size() * sizeof(int32_t));
                n_ids += sent.size();
                kept++;
            }

            if (!sentence_level || part_end == doc_end) break;
            part = part_end + 1;
        }
        out_doc_counts[d] = kept;
    }
    out_sent_starts[n_sents] = n_ids;
    return n_sents;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// History building + packing (reference src/dataset.py:50-73 fused with the
// static packing step): for each row, gather the sentences every OTHER row
// of the same lead (user or item) contributes (excluding rows whose costar
// matches this row's costar), apply the reference's min-count drop and
// keep-longest truncation (stable sort by descending length,
// dataset.py:69-71), and write the packed (max_count, max_len) token block
// directly.  This is the corpus-scale host hot spot (python: dict loops +
// per-sentence copies).

#include <algorithm>

extern "C" {

// Count-only retain pass: clears retain for rows whose history would have
// fewer than min_count sentences (no token copies, no sorting -- used to
// size the compact output before build_histories_packed fills it).
void histories_retain_pass(
    const int64_t* lead, const int64_t* costar, int64_t n_rows,
    const int64_t* doc_sent_start, uint8_t* retain, int32_t min_count) {
    // count(i) = group_total(lead_i) - sum over rows with costar == costar_i;
    // computed with per-group + per-(group,costar) sums: O(n) total instead
    // of O(sum G^2).
    std::unordered_map<int64_t, int64_t> group_total;
    std::unordered_map<uint64_t, int64_t> pair_total;
    group_total.reserve(n_rows * 2);
    pair_total.reserve(n_rows * 2);
    // EXACT composite key: group ids are pandas ngroup indices (< n_rows
    // < 2^31, non-negative), so (a << 32) | b is collision-free.
    auto pair_key = [](int64_t a, int64_t b) {
        return (static_cast<uint64_t>(a) << 32) | static_cast<uint32_t>(b);
    };
    for (int64_t i = 0; i < n_rows; i++) {
        int64_t c = doc_sent_start[i + 1] - doc_sent_start[i];
        group_total[lead[i]] += c;
        pair_total[pair_key(lead[i], costar[i])] += c;
    }
    for (int64_t i = 0; i < n_rows; i++) {
        if (!retain[i]) continue;
        int64_t total = group_total[lead[i]]
                        - pair_total[pair_key(lead[i], costar[i])];
        if (total < min_count) retain[i] = 0;
    }
}

// lead/costar: per-row group ids.  Sentences of row k are
// [doc_sent_start[k], doc_sent_start[k+1]) into sent_starts/flat_ids.
// retain is read AND written (rows failing min_count are cleared), exactly
// like the reference's retain_idx mutation.  out_tokens must be zeroed and
// out_lengths filled with 1 by the caller (pad-sentence semantics).
// rows[o] = global row index for output slot o (n_sel slots).  The group
// index is a caller-built CSR over lead ids (grp_rows = row indices sorted
// stably by lead, grp_start[g] its group offsets): built ONCE per
// direction, so the memmap-slab path does not re-hash the whole corpus on
// every slab call.
void build_histories_packed(
    const int64_t* lead, const int64_t* costar,
    const int64_t* grp_rows, const int64_t* grp_start,
    const int32_t* flat_ids, const int64_t* sent_starts,
    const int64_t* doc_sent_start,
    uint8_t* retain, const int64_t* rows, int64_t n_sel,
    int32_t min_count, int32_t max_count, int32_t max_len,
    int32_t* out_tokens, int32_t* out_lengths, int32_t* out_counts) {
    std::vector<int64_t> sents;  // flat sentence indices for the current row
    for (int64_t o = 0; o < n_sel; o++) {
        int64_t i = rows[o];
        if (!retain[i]) continue;
        out_counts[o] = 0;

        sents.clear();
        for (int64_t idx = grp_start[lead[i]]; idx < grp_start[lead[i] + 1];
             idx++) {
            int64_t j = grp_rows[idx];
            if (costar[j] == costar[i]) continue;  // exclude the u->i review(s)
            for (int64_t s = doc_sent_start[j]; s < doc_sent_start[j + 1]; s++)
                sents.push_back(s);
        }
        if (static_cast<int64_t>(sents.size()) < min_count) {
            retain[i] = 0;
            continue;
        }
        if (static_cast<int64_t>(sents.size()) > max_count) {
            // keep the LONGEST max_count sentences; stable to match
            // python's list.sort(key=lambda x: -len(x))
            std::stable_sort(sents.begin(), sents.end(),
                             [&](int64_t a, int64_t b) {
                                 return (sent_starts[a + 1] - sent_starts[a]) >
                                        (sent_starts[b + 1] - sent_starts[b]);
                             });
            sents.resize(max_count);
        }
        int32_t cnt = static_cast<int32_t>(sents.size());
        out_counts[o] = cnt;
        int32_t* tok_row = out_tokens + o * max_count * max_len;
        int32_t* len_row = out_lengths + o * max_count;
        for (int32_t s = 0; s < cnt; s++) {
            int64_t a = sent_starts[sents[s]];
            int64_t n = sent_starts[sents[s] + 1] - a;
            if (n > max_len) n = max_len;
            memcpy(tok_row + s * max_len, flat_ids + a, n * sizeof(int32_t));
            len_row[s] = n > 1 ? static_cast<int32_t>(n) : 1;
        }
    }
}

// u->i review packing (reference src/dataset.py:75-85 fused with the static
// packing step): for each requested row, take its OWN sentences, apply the
// keep-longest truncation when there are more than max_count (stable sort
// by descending length, like the histories), and write the packed block.
// rows: global row index per output slot (length n_out).  out_tokens must
// be zeroed and out_lengths filled with 1 by the caller.
void pack_ui(
    const int32_t* flat_ids, const int64_t* sent_starts,
    const int64_t* doc_sent_start,
    const int64_t* rows, int64_t n_out,
    int32_t max_count, int32_t max_len,
    int32_t* out_tokens, int32_t* out_lengths, int32_t* out_counts) {
    std::vector<int64_t> sents;
    for (int64_t o = 0; o < n_out; o++) {
        int64_t i = rows[o];
        sents.clear();
        for (int64_t s = doc_sent_start[i]; s < doc_sent_start[i + 1]; s++)
            sents.push_back(s);
        if (static_cast<int64_t>(sents.size()) > max_count) {
            std::stable_sort(sents.begin(), sents.end(),
                             [&](int64_t a, int64_t b) {
                                 return (sent_starts[a + 1] - sent_starts[a]) >
                                        (sent_starts[b + 1] - sent_starts[b]);
                             });
            sents.resize(max_count);
        }
        int32_t cnt = static_cast<int32_t>(sents.size());
        out_counts[o] = cnt;
        int32_t* tok_row = out_tokens + o * max_count * max_len;
        int32_t* len_row = out_lengths + o * max_count;
        for (int32_t s = 0; s < cnt; s++) {
            int64_t a = sent_starts[sents[s]];
            int64_t n = sent_starts[sents[s] + 1] - a;
            if (n > max_len) n = max_len;
            memcpy(tok_row + s * max_len, flat_ids + a, n * sizeof(int32_t));
            len_row[s] = n > 1 ? static_cast<int32_t>(n) : 1;
        }
    }
}

}  // extern "C"
