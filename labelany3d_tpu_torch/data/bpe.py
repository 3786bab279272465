"""CLIP byte-pair-encoding tokenizer (host-side).

Counterpart of `labelany3d_tpu/data/bpe.py`, kept as the port's own copy
(the port imports nothing of the JAX package). Standard BPE over a
byte-to-unicode alphabet with a `</w>` end-of-word marker; the vocabulary
(vocab.json + merges.txt) ships with every SD/CLIP checkpoint and loads
through `CLIPTokenizer.from_files`.

Without vocab files a deterministic hash fallback keeps the pipelines
runnable (each word hashes into the id space); it is flagged by
`is_fallback`, and its ids are stable but carry no meaning.
"""

from __future__ import annotations

import json
import os
import re


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte <-> printable-unicode alphabet."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_WORD_PAT = re.compile(
    # CLIP's pattern with \p{L}/\p{N} spelled in stdlib-re classes:
    # letters = [^\W\d_]+, single digit = \d, punctuation = any run of
    # non-space/non-letter/non-digit INCLUDING '_' (CLIP's [^\s\p{L}\p{N}]+
    # treats underscore as punctuation; a plain [^\s\w]+ would drop it).
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """BPE tokenizer over a loaded (vocab, merges) pair.

    encode(text) -> [sot, tokens..., eot]; __call__(text, length) pads to a
    fixed context length with the pad id (SD semantics: pad = eot).
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.sot = self.encoder.get("<|startoftext|>", len(self.encoder) - 2)
        self.eot = self.encoder.get("<|endoftext|>", len(self.encoder) - 1)
        self.pad = self.eot
        self._cache: dict[str, list[str]] = {}
        self.is_fallback = False

    @staticmethod
    def from_files(path: str) -> "CLIPTokenizer":
        """Load HF-format `vocab.json` + `merges.txt` from a directory (or a
        direct vocab.json path with merges.txt beside it)."""
        if os.path.isdir(path):
            vocab_path = os.path.join(path, "vocab.json")
            merges_path = os.path.join(path, "merges.txt")
        else:
            vocab_path = path
            merges_path = os.path.join(os.path.dirname(path), "merges.txt")
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return CLIPTokenizer(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(text).lower()
        ids = [self.sot]
        for tok in _WORD_PAT.findall(text):
            if tok == "<|startoftext|>":
                ids.append(self.sot)
                continue
            if tok == "<|endoftext|>":
                ids.append(self.eot)
                continue
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(btok):
                ids.append(self.encoder.get(piece, self.eot))
        ids.append(self.eot)
        return ids

    def __call__(self, text: str, length: int = 77) -> list[int]:
        ids = self.encode(text)[:length]
        if ids[-1] != self.eot:
            ids[-1] = self.eot  # truncation always keeps an EOT (HF behavior)
        return ids + [self.pad] * (length - len(ids))


class HashTokenizer:
    """Deterministic stand-in when no vocab files are installed: each word
    maps to a stable id bucket. Flagged via is_fallback so callers can warn."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1
        self.pad = self.eot
        self.is_fallback = True

    def encode(self, text: str) -> list[int]:
        import hashlib

        ids = [self.sot]
        for tok in _WORD_PAT.findall(_whitespace_clean(text).lower()):
            h = int.from_bytes(hashlib.sha256(tok.encode()).digest()[:4], "big")
            ids.append(h % (self.vocab_size - 2))
        ids.append(self.eot)
        return ids

    def __call__(self, text: str, length: int = 77) -> list[int]:
        ids = self.encode(text)[:length]
        if ids[-1] != self.eot:
            ids[-1] = self.eot
        return ids + [self.pad] * (length - len(ids))


def load_tokenizer(path: str | None = None, vocab_size: int = 49408):
    """CLIPTokenizer when vocab files exist at `path`, else HashTokenizer."""
    if path is not None:
        try:
            return CLIPTokenizer.from_files(path)
        except (OSError, json.JSONDecodeError):
            pass
    return HashTokenizer(vocab_size)
