"""Load gensim ``Word2Vec.save()`` pickles WITHOUT the gensim package
(the port's copy of umpr_tpu/text/gensim_load.py).

The reference's ``Word2vec(source='gensim')`` path (src/word2vec.py:54-64)
calls ``gensim.models.Word2Vec.load(path)``; the port does not depend on
gensim, so this module reimplements the *loading* side of gensim's
``SaveLoad`` protocol:

- ``Word2Vec.save`` pickles the model object; every ``gensim.*`` class in
  the stream is materialized here as an attribute-bag stub (state applied
  via ``__dict__``), so no gensim code is needed — and unlike gensim's own
  loader, NO arbitrary class can execute during unpickling: only numpy /
  stdlib container globals resolve for real, everything else is rejected.
- arrays larger than ``sep_limit`` are stored by gensim as sidecar files
  ``<path>.<dotted.attr>.npy`` with the in-pickle attribute set to None
  (gensim utils.SaveLoad._smart_save); ``load_gensim_model`` restores them
  by walking the sidecar names back onto the object graph.

Supports both layout generations:

- gensim 3.x (the API generation the reference targets):
  ``model.wv.vocab`` = dict word -> Vocab(count=, index=),
  vectors at ``model.wv.vectors`` (or the pre-1.0 name ``syn0``);
- gensim 4.x: ``model.wv.key_to_index`` / ``index_to_key`` with counts in
  ``wv.expandos['count']``; normalized here into the 3.x shape so callers
  only ever see ``(vocab_dict, vectors)``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import types

import numpy as np

# Globals allowed to resolve for real during unpickling, by NAME — a
# module-level whitelist is not enough (builtins.eval, numpy's distutils
# helpers, and collections factories are all GLOBAL-reachable callables).
# numpy array reconstruction needs the numpy internals; everything else a
# gensim pickle legitimately contains is stdlib containers.  NOTHING else
# resolves through this loader (pickle's arbitrary-code surface is closed).
_SAFE_GLOBALS = {
    ("builtins", n) for n in
    ("set", "frozenset", "bytearray", "complex", "list", "dict", "tuple",
     "object", "range", "slice")
} | {
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("collections", "Counter"),
    ("copyreg", "_reconstructor"),
    ("_codecs", "encode"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),   # numpy >= 2 module path
    ("numpy._core.multiarray", "scalar"),
    ("numpy.random._pickle", "__randomstate_ctor"),  # model.random state
    ("numpy.random", "__RandomState_ctor"),  # pre-numpy-1.17 pickles
}


class _Stub:
    """Attribute bag standing in for a gensim class: default-constructs
    empty and takes whatever state the pickle carries."""

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            # (dict_state, slots_state) form
            d, s = state
            if d:
                self.__dict__.update(d)
            if s:
                self.__dict__.update(s)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - gensim never pickles bare values here
            self.__dict__["__state__"] = state


class _GensimUnpickler(pickle.Unpickler):
    _stub_cache: dict = {}

    def find_class(self, module, name):
        if module.split(".")[0] in ("gensim", "scipy"):
            key = f"{module}.{name}"
            cls = self._stub_cache.get(key)
            if cls is None:
                cls = type(name, (_Stub,), {"__module__": module})
                self._stub_cache[key] = cls
            return cls
        if (module, name) in _SAFE_GLOBALS:
            mod = importlib.import_module(module)
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"gensim model pickle references {module}.{name}; only "
            f"whitelisted numpy/stdlib-container globals resolve through "
            f"this loader")


def _set_dotted(obj, dotted, value):
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], value)


def _restore_sidecars(model, path):
    """gensim stores big arrays as ``<path>.<attr.path>.npy``; walk the
    directory and graft them back.  (gensim can also emit scipy-sparse
    ``.npz`` sidecars — no gensim Word2Vec/KeyedVectors attribute the
    consumers here read is ever sparse, so those are NOT restored; if one
    ever holds the vectors, ``extract_keyed_vectors`` raises.)"""
    d, base = os.path.split(path)
    prefix = base + "."
    for fname in sorted(os.listdir(d or ".")):
        if not fname.startswith(prefix):
            continue
        dotted, ext = os.path.splitext(fname[len(prefix):])
        if ext != ".npy" or not dotted:
            continue
        try:
            arr = np.load(os.path.join(d, fname), allow_pickle=False)
        except Exception:
            continue  # unrelated file that happens to share the prefix
        try:
            _set_dotted(model, dotted, arr)
        except AttributeError:
            pass  # sidecar for an attribute this model shape doesn't have


def load_gensim_model(path):
    """Unpickle a ``gensim.models.Word2Vec.save()`` (or ``KeyedVectors
    .save()``) file into stub objects and restore .npy sidecars."""
    with open(path, "rb") as f:
        model = _GensimUnpickler(f).load()
    _restore_sidecars(model, path)
    return model


def extract_keyed_vectors(model):
    """Normalize a loaded model to the reference's consumption shape:
    ``(vocab_dict, vectors)`` where ``vocab_dict`` maps word -> an object
    with ``.count`` and ``.index`` in the model's stored iteration order
    (reference word2vec.py:56 iterates ``model.wv.vocab.items()``), and
    ``vectors[vocab[w].index]`` is w's embedding (``model.wv[w]``)."""
    kv = getattr(model, "wv", model)
    vectors = getattr(kv, "vectors", None)
    if vectors is None:
        vectors = getattr(kv, "syn0", None)
    if vectors is None:
        raise ValueError("gensim model has no wv.vectors/syn0 array "
                         "(sidecar .npy missing next to the model file?)")
    vectors = np.asarray(vectors)

    vocab = getattr(kv, "vocab", None)
    if vocab:  # gensim 3.x
        return vocab, vectors

    key_to_index = getattr(kv, "key_to_index", None)
    if key_to_index:  # gensim 4.x
        expandos = getattr(kv, "expandos", None) or {}
        counts = expandos.get("count")
        out = {}
        for w, i in key_to_index.items():
            e = types.SimpleNamespace(index=i)
            e.count = int(counts[i]) if counts is not None else 0
            out[w] = e
        return out, vectors
    raise ValueError("unrecognized gensim KeyedVectors layout "
                     "(no .vocab and no .key_to_index)")


def sniff_pickle(path):
    """True when the file starts with a pickle protocol-2+ magic — i.e. a
    gensim ``.save()`` model rather than a text embedding file."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
        return head[:1] == b"\x80"
    except Exception:
        return False


__all__ = ["load_gensim_model", "extract_keyed_vectors", "sniff_pickle"]
