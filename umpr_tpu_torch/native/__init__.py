"""Native (C++) host code of the dataset build: the port's own copy of
the JAX package's tokenizer and history builder.

``fast_tokenize_reviews`` / ``tokenize_flat`` tokenize reviews in C++ with
the python path's exact semantics: the C++ side consumes UTF-8 bytes (ASCII
separators and '.' never occur inside a multibyte sequence, and vocabulary
lookups compare UTF-8 bytes, which is str equality); only documents holding
a RISKY non-ASCII char -- unicode whitespace or unicode digits, where
``str.split()`` / ``str.isdigit()`` differ from bytes -- go through the
python path (see ``_risky`` and the header of ``tokenizer.cpp``).
``fast_build_histories``, ``histories_retain_pass`` and ``fast_pack_ui``
build and pack the user/item histories and the u->i reviews.

The shared library is compiled by ``g++ -O3 -march=native`` at first use,
never at import, into ``build/native/`` at the repository root (beside the
CUDA kernels' ``build/kernels/``; git ignores ``build/``), named by a hash
of the source, the machine and the CPU's flags.  Every entry point returns
None (or False) when the compiler or the build is missing; the caller then
takes the python path and logs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib = None
_build_failed = False
_log = logging.getLogger("umpr_tpu_torch.native")


def _cpu_tag():
    """The CPU's capability in the library's name: -march=native code built
    on one host dies with SIGILL on a lesser one, and the machine name alone
    cannot tell an AVX-512 x86_64 from a plain one."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # 'flags' is the capability truth (model names on cloud VMs
                # are generic); 'model name' is only the fallback
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
                if line.startswith("model name") and not model:
                    model = line
    except OSError:
        pass
    if model:
        return hashlib.sha256(model.encode()).hexdigest()[:8]
    return "generic"


def _so_path():
    """The library's path: a hash of the C++ source plus the machine and
    the CPU's capability, under ``build/native/``.  Binaries are never
    committed; a fresh checkout builds from source."""
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(BUILD_DIR /
               f"_tokenizer-{src_hash}-{platform.machine()}-{_cpu_tag()}.so")


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = _so_path()
            if not os.path.exists(so):
                tmp = f"{so}.tmp.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", str(_SRC), "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.vocab_build.restype = ctypes.c_void_p
            lib.vocab_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.vocab_free.argtypes = [ctypes.c_void_p]
            lib.tokenize_docs.restype = ctypes.c_int64
            lib.tokenize_docs.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int64),
                np.ctypeslib.ndpointer(np.int64),
                ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
        except Exception as e:
            _build_failed = True
            # loud: a silent fall-through would turn a minutes-scale corpus
            # build into hours
            _log.warning(
                "native tokenizer unavailable (%s: %s); "
                "falling back to the pure-python host pipeline",
                type(e).__name__, e)
    return _lib


class NativeVocab:
    """Hash-map vocabulary held in C++; ids follow Word2vec layout
    (0/1/2 reserved, then word order)."""

    def __init__(self, vocab_words):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tokenizer unavailable")
        self._lib = lib
        blob = "\n".join(vocab_words).encode("utf-8")
        self._handle = lib.vocab_build(blob, len(blob))

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.vocab_free(self._handle)


def _vocab_for(word2vec, _vocab_cache={}):
    """Cache the built C++ vocab per Word2vec instance.  The entry holds a
    strong reference to the instance and verifies identity, so a recycled
    id() after GC can never alias to the wrong vocabulary."""
    entry = _vocab_cache.get("entry")
    if entry is None or entry[0] is not word2vec:
        entry = (word2vec, NativeVocab(word2vec.vocab[3:]))
        _vocab_cache["entry"] = entry
    return entry[1]


_char_risky_cache = {}


def _risky(ch):
    """True when python tokenization treats this non-ASCII char specially:
    str.split() splits on unicode whitespace and str.isdigit() accepts
    unicode digits (incl. e.g. Eastern Arabic digits and superscripts).
    Everything else -- accented letters, curly quotes, emoji, CJK -- is an
    opaque run of UTF-8 bytes to both tokenizers: '.' (0x2E) and ASCII
    whitespace bytes never occur inside a UTF-8 multibyte sequence, and
    vocab lookups compare UTF-8 bytes, which equals str equality."""
    r = _char_risky_cache.get(ch)
    if r is None:
        r = _char_risky_cache.setdefault(ch, ch.isspace() or ch.isdigit())
    return r


def _encode_corpus(docs):
    """-> (buf bytes, offsets int64 [n+1], total, native_mask bool[n]).

    Docs encode as UTF-8 for the byte-level C++ tokenizer.  Only docs
    containing a RISKY non-ASCII char (see _risky: unicode whitespace /
    unicode digits, where python semantics diverge from bytes) are
    encoded as empty and routed to the python path by the caller."""
    native_mask = np.ones(len(docs), bool)
    try:
        # fast path: the whole corpus is ASCII -> one encode, offsets from
        # char lengths (== byte lengths for ASCII)
        buf = "".join(docs).encode("ascii")
        offsets = np.zeros(len(docs) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, docs), np.int64, len(docs)),
                  out=offsets[1:])
        total = int(offsets[-1])
    except UnicodeEncodeError:
        buf_parts, offs = [], [0]
        total = 0
        for i, d in enumerate(docs):
            if d.isascii():
                b = d.encode("ascii")
            elif any(_risky(ch) for ch in set(d) if ord(ch) > 127):
                native_mask[i] = False
                b = b""
            else:
                b = d.encode("utf-8")
            buf_parts.append(b)
            total += len(b)
            offs.append(total)
        buf = b"".join(buf_parts)
        offsets = np.asarray(offs, np.int64)
    return buf, offsets, total, native_mask


def _python_sentences(doc, word2vec, max_len, sentence_level, keep_gt):
    parts = (doc.strip(". ").split(".") if sentence_level else [doc])
    sents = []
    for sent in parts:
        ids = word2vec.sent2indices(sent)[:max_len]
        if len(ids) > keep_gt:
            sents.append(np.asarray(ids, np.int32))
    return sents


def fast_tokenize_reviews(reviews, word2vec, max_len, sentence_level,
                          keep_gt=5, return_flat=False):
    """reviews: iterable of strings -> list (per doc) of lists of id
    sequences (numpy int32 views), same contents as the python
    _tokenize_reviews path.  Returns None if the native library is
    unavailable (caller falls back).

    With return_flat=True returns (results, flat) where flat is the
    (flat_ids, sent_starts, doc_sent_start) triple for the C++ history
    builder -- free when the corpus is all-ASCII (it IS the tokenizer's own
    output), None when unicode fallbacks made the layout non-contiguous."""
    if _load() is None:
        return None
    nv = _vocab_for(word2vec)

    docs = [str(x) for x in reviews]
    buf, offsets, total, native_mask = _encode_corpus(docs)

    cap_ids = max(total + 16, 1024)  # <= one id per byte
    cap_sents = max(total // 2 + len(docs) + 16, 1024)
    out_ids = np.empty(cap_ids, np.int32)
    sent_starts = np.empty(cap_sents + 1, np.int64)
    doc_counts = np.empty(len(docs), np.int64)
    n_sents = _load().tokenize_docs(
        nv._handle, buf, offsets, len(docs), max_len,
        1 if sentence_level else 0, keep_gt,
        out_ids, sent_starts, doc_counts, cap_ids, cap_sents)
    if n_sents < 0:  # capacity miss (cannot happen with the bounds above)
        return None

    flat = None
    if return_flat and bool(native_mask.all()):
        doc_sent_start = np.zeros(len(docs) + 1, np.int64)
        np.cumsum(doc_counts, out=doc_sent_start[1:])
        flat = (out_ids[:int(sent_starts[n_sents])],
                sent_starts[:n_sents + 1].copy(), doc_sent_start)

    sent_starts = sent_starts[:n_sents + 1].tolist()  # python ints: fast slicing
    doc_counts = doc_counts.tolist()
    results = []
    si = 0
    for i, cnt in enumerate(doc_counts):
        if not native_mask[i]:
            # risky-unicode document (unicode whitespace/digits): exact
            # python path
            results.append(_python_sentences(docs[i], word2vec, max_len,
                                             sentence_level, keep_gt))
            si += cnt  # native output for this doc (empty) is skipped
            continue
        # numpy views into the flat id buffer (not python lists): ~6x less
        # wrapper overhead; downstream code only needs len()/slicing/copy
        sents = [out_ids[sent_starts[si + k]:sent_starts[si + k + 1]]
                 for k in range(cnt)]
        si += cnt
        results.append(sents)
    if return_flat:
        return results, flat
    return results


def tokenize_flat(reviews, word2vec, max_len, sentence_level, keep_gt=5):
    """Low-RSS tokenizer: -> (flat_ids int32, sent_starts int64 [n_sents+1],
    doc_sent_start int64 [n_docs+1]) with the exact python-path semantics,
    or None if the native library is unavailable.

    Unlike fast_tokenize_reviews this never materializes per-doc python
    lists (the dominant host-memory cost at corpus scale); unicode documents
    are python-tokenized individually and spliced into the flat stream at
    their doc positions."""
    if _load() is None:
        return None
    nv = _vocab_for(word2vec)

    docs = [str(x) for x in reviews]
    n_docs = len(docs)
    buf, offsets, total, native_mask = _encode_corpus(docs)

    cap_ids = max(total + 16, 1024)
    cap_sents = max(total // 2 + n_docs + 16, 1024)
    out_ids = np.empty(cap_ids, np.int32)
    sent_starts = np.empty(cap_sents + 1, np.int64)
    doc_counts = np.empty(n_docs, np.int64)
    n_sents = _load().tokenize_docs(
        nv._handle, buf, offsets, n_docs, max_len,
        1 if sentence_level else 0, keep_gt,
        out_ids, sent_starts, doc_counts, cap_ids, cap_sents)
    if n_sents < 0:
        return None
    del buf
    # trim (copies release the byte-sized capacity buffers)
    flat_ids = out_ids[:int(sent_starts[n_sents])].copy()
    sent_lens = np.diff(sent_starts[:n_sents + 1])
    del out_ids, sent_starts

    if not native_mask.all():
        # splice python-tokenized unicode docs into the flat stream at
        # their doc positions (native output has 0 sentences for them)
        nat_doc_start = np.zeros(n_docs + 1, np.int64)
        np.cumsum(doc_counts, out=nat_doc_start[1:])
        nat_sent_start = np.zeros(len(sent_lens) + 1, np.int64)
        np.cumsum(sent_lens, out=nat_sent_start[1:])
        id_parts, len_parts = [], []
        prev_sent = 0
        for i in np.flatnonzero(~native_mask):
            sents = _python_sentences(docs[i], word2vec, max_len,
                                      sentence_level, keep_gt)
            doc_counts[i] = len(sents)
            s_at = int(nat_doc_start[i])  # native sentences before doc i
            id_parts.append(flat_ids[nat_sent_start[prev_sent]:nat_sent_start[s_at]])
            len_parts.append(sent_lens[prev_sent:s_at])
            for s in sents:
                id_parts.append(s)
                len_parts.append(np.array([len(s)], np.int64))
            prev_sent = s_at
        id_parts.append(flat_ids[nat_sent_start[prev_sent]:])
        len_parts.append(sent_lens[prev_sent:])
        flat_ids = np.concatenate(id_parts)
        sent_lens = np.concatenate(len_parts)

    final_sent_starts = np.zeros(len(sent_lens) + 1, np.int64)
    np.cumsum(sent_lens, out=final_sent_starts[1:])
    doc_sent_start = np.zeros(n_docs + 1, np.int64)
    np.cumsum(doc_counts, out=doc_sent_start[1:])
    return flat_ids, final_sent_starts, doc_sent_start


def fast_pack_ui(flat, rows, max_count, max_len, out=None):
    """Pack each requested row's OWN sentences (the u->i review) into static
    (n_out, max_count, max_len) arrays with the reference's keep-longest
    truncation (src/dataset.py:75-85).  Returns (tokens, lengths, counts)
    or None if the library is unavailable.  `out` optionally supplies the
    (tokens, lengths, counts) arrays (e.g. memmap slices) to fill in place
    -- tokens must arrive zeroed and lengths filled with 1."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_ui_bound"):
        lib.pack_ui.restype = None
        lib.pack_ui.argtypes = [
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
        ]
        lib._ui_bound = True
    flat_ids, sent_starts, doc_sent_start = flat
    rows = np.ascontiguousarray(rows, np.int64)
    n_out = len(rows)
    if out is None:
        tokens = np.zeros((n_out, max_count, max_len), np.int32)
        lengths = np.ones((n_out, max_count), np.int32)
        counts = np.zeros(n_out, np.int32)
    else:
        tokens, lengths, counts = out  # caller-owned (zeroed / ones / zeroed)
    lib.pack_ui(flat_ids, sent_starts, doc_sent_start, rows, n_out,
                max_count, max_len, tokens.reshape(-1), lengths.reshape(-1),
                counts)
    return tokens, lengths, counts


def _bind_histories(lib):
    if hasattr(lib, "_hist_bound"):
        return
    lib.histories_retain_pass.restype = None
    lib.histories_retain_pass.argtypes = [
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int64, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int32,
    ]
    lib.build_histories_packed.restype = None
    lib.build_histories_packed.argtypes = [
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
    ]
    lib._hist_bound = True


def histories_retain_pass(lead, costar, doc_sent_start, retain, min_count):
    """Count-only pass: clears retain for rows with < min_count history
    sentences (no output allocation).  Mutates retain.  Returns False if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    _bind_histories(lib)
    lib.histories_retain_pass(
        np.ascontiguousarray(lead, np.int64),
        np.ascontiguousarray(costar, np.int64), len(lead),
        doc_sent_start, retain, min_count)
    return True


def flatten_tokenized(reviews):
    """Per-doc lists of id sequences -> (flat_ids int32, sent_starts int64
    [n_sents+1], doc_sent_start int64 [n_docs+1]).  Used to feed the C++
    history builder regardless of which tokenizer path produced the lists."""
    n_docs = len(reviews)
    doc_counts = np.fromiter((len(d) for d in reviews), np.int64, n_docs)
    doc_sent_start = np.zeros(n_docs + 1, np.int64)
    np.cumsum(doc_counts, out=doc_sent_start[1:])
    sents = [np.asarray(s, dtype=np.int32) for d in reviews for s in d]
    lens = np.fromiter((len(s) for s in sents), np.int64, len(sents))
    sent_starts = np.zeros(len(sents) + 1, np.int64)
    np.cumsum(lens, out=sent_starts[1:])
    flat_ids = (np.concatenate(sents) if sents else np.zeros(0, np.int32))
    return flat_ids, sent_starts, doc_sent_start


def group_index(lead):
    """CSR index over group ids: (grp_rows, grp_start) with grp_rows = row
    indices sorted stably by lead (original order within each group) and
    grp_start[g]:grp_start[g+1] the rows of group g.  Build it ONCE per
    direction and pass to fast_build_histories -- the memmap-slab path
    calls the builder many times over the same corpus."""
    lead = np.ascontiguousarray(lead, np.int64)
    n_groups = int(lead.max()) + 1 if len(lead) else 0
    counts = np.bincount(lead, minlength=n_groups)
    grp_start = np.zeros(n_groups + 1, np.int64)
    np.cumsum(counts, out=grp_start[1:])
    grp_rows = np.argsort(lead, kind="stable").astype(np.int64)
    return grp_rows, grp_start


def fast_build_histories(lead, costar, flat, retain, min_count, max_count,
                         max_len, rows=None, out=None, index=None):
    """C++ history building + packing (see tokenizer.cpp).  Mutates `retain`
    (a uint8 numpy array) exactly like the reference's retain_idx.

    Without rows: outputs have one slot per input row (caller filters by
    the final retain).  With rows (int64 global row index per output slot):
    outputs are written compactly -- the low-RSS path for corpus-scale
    builds.  `out` optionally supplies the (tokens, lengths, counts) arrays
    (e.g. memmap slices; tokens zeroed, lengths ones) to fill in place.
    `index` is a precomputed group_index(lead) (computed here if absent).
    Returns (tokens, lengths, counts) or None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    _bind_histories(lib)
    flat_ids, sent_starts, doc_sent_start = flat
    n = len(lead)
    if rows is None:
        rows = np.arange(n, dtype=np.int64)
    n_out = len(rows)
    if out is None:
        tokens = np.zeros((n_out, max_count, max_len), np.int32)
        lengths = np.ones((n_out, max_count), np.int32)
        counts = np.zeros(n_out, np.int32)
    else:
        tokens, lengths, counts = out
    grp_rows, grp_start = group_index(lead) if index is None else index
    lib.build_histories_packed(
        np.ascontiguousarray(lead, np.int64),
        np.ascontiguousarray(costar, np.int64),
        grp_rows, grp_start,
        flat_ids, sent_starts, doc_sent_start, retain,
        np.ascontiguousarray(rows, np.int64), n_out,
        min_count, max_count, max_len, tokens.reshape(-1), lengths.reshape(-1),
        counts)
    return tokens, lengths, counts
