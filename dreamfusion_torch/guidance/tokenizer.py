r"""CLIP's byte-level BPE tokenizer, read from a tokenizer directory
(``vocab.json``, ``merges.txt`` and, where present,
``tokenizer_config.json`` and ``special_tokens_map.json``).

It gives the ids of ``transformers.CLIPTokenizer`` without ``ftfy`` (the
tokenizer the JAX package's ``load_sd_params`` builds) called as
``tok(prompts, padding="max_length", max_length=77, truncation=True)``:

1. the text is split at the special tokens (``<|startoftext|>``,
   ``<|endoftext|>``, the pad token and any added token of the config),
   which map to their own ids;
2. each other piece is cleaned as transformers' BasicTokenizer
   (strip_accents=False, do_split_on_punc=False) cleans it: control
   characters dropped, whitespace to spaces, spaces around CJK ideographs,
   NFC, split on whitespace, each word lower-cased, words joined by one
   space;
3. the piece is cut into words by CLIP's pattern ``<|startoftext|>|
   <|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+``
   (case-insensitive), written here with the standard library: letters are
   the Unicode categories L*, numbers N*, whitespace ``str.isspace`` but
   for U+001C-U+001F, which the ``regex`` module's ``\s`` leaves out; and
   U+0345, which case-folds to a letter, matches no alternative;
4. each word's UTF-8 bytes map through CLIP's byte-to-unicode table, its
   last symbol gets ``</w>``, and the BPE merges (lines 1 to 48,894 of
   merges.txt, as transformers cuts them) join symbols by rank;
5. a symbol missing from the vocabulary becomes the unknown token; the
   ids are cut to 75, framed by the begin and end tokens and padded to 77
   with the pad token's id.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_MAX_MERGES = 49152 - 256 - 2


@lru_cache
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize, joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_gap(ch: str) -> bool:
    """A character no alternative of the pattern takes: the ``regex``
    module's \\s (str.isspace without U+001C-U+001F) and U+0345."""
    return (ch.isspace() and not "\x1c" <= ch <= "\x1f") or ch == "\u0345"


def _fold_eq(a: str, b: str) -> bool:
    """Case-insensitive equality of two strings of one-character pieces,
    as the pattern's IGNORECASE compares them."""
    return len(a) == len(b) and all(
        x == y or x.casefold() == y.casefold() or x.lower() == y.lower()
        for x, y in zip(a, b))


def split_words(text: str) -> List[str]:
    """re.findall of CLIP's pattern over `text` (see the module docstring):
    at each position the first alternative that matches, else the
    character is skipped."""
    words, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        for special in ("<|startoftext|>", "<|endoftext|>"):
            if _fold_eq(text[i:i + len(special)], special):
                words.append(text[i:i + len(special)])
                i += len(special)
                break
        else:
            for c in _CONTRACTIONS:
                if _fold_eq(text[i:i + len(c)], c):
                    words.append(text[i:i + len(c)])
                    i += len(c)
                    break
            else:
                if _is_letter(ch):
                    j = i + 1
                    while j < n and _is_letter(text[j]):
                        j += 1
                elif _is_number(ch):
                    j = i + 1
                elif not _is_gap(ch):
                    j = i + 1
                    while j < n and not (_is_gap(text[j])
                                         or _is_letter(text[j])
                                         or _is_number(text[j])):
                        j += 1
                else:
                    i += 1
                    continue
                words.append(text[i:j])
                i = j
    return words


def _token_content(v) -> Optional[str]:
    if v is None or isinstance(v, str):
        return v
    return v.get("content")


class CLIPBPETokenizer:
    """CLIP BPE over a tokenizer directory (see the module docstring)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[str],
                 special: Optional[Dict[str, str]] = None,
                 added: Optional[Dict[str, int]] = None,
                 model_max_length: int = 77):
        special = {"bos_token": "<|startoftext|>",
                   "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>", **(special or {})}
        self.encoder = dict(vocab)
        pairs = [tuple(m.split()) for m in merges[1:_MAX_MERGES + 1]]
        self.bpe_ranks = {p: r for r, p in enumerate(pairs)}
        self.byte_encoder = bytes_to_unicode()
        self.special = special
        # added tokens: the special ones (their vocabulary ids, or new ids
        # after the vocabulary) and those the config lists
        self.added: Dict[str, int] = dict(added or {})
        for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
            tok = special[name]
            if tok not in self.added:
                self.added[tok] = self.encoder.get(
                    tok, len(self.encoder) + len(
                        [t for t in self.added if t not in self.encoder]))
        self.model_max_length = model_max_length
        # the two markers, when the pattern cuts them out of a cleaned
        # piece, map to themselves (transformers seeds its cache so)
        self.cache: Dict[str, str] = {"<|startoftext|>": "<|startoftext|>",
                                      "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_dir(cls, path: str) -> "CLIPBPETokenizer":
        """Read vocab.json, merges.txt and the optional configs."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")
        special: Dict[str, str] = {}
        added: Dict[str, int] = {}
        max_len = 77
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            fp = os.path.join(path, name)
            if not os.path.isfile(fp):
                continue
            with open(fp, encoding="utf-8") as f:
                conf = json.load(f)
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                tok = _token_content(conf.get(key))
                if tok is not None:
                    special[key] = tok
            for idx, tok in (conf.get("added_tokens_decoder") or {}).items():
                added[_token_content(tok)] = int(idx)
            if isinstance(conf.get("model_max_length"), int):
                max_len = min(conf["model_max_length"], 77)
        return cls(vocab, merges, special, added, max_len)

    @property
    def bos_id(self) -> int:
        return self.added[self.special["bos_token"]]

    @property
    def eos_id(self) -> int:
        return self.added[self.special["eos_token"]]

    @property
    def pad_id(self) -> int:
        return self.added[self.special["pad_token"]]

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = " ".join(word)
        return list(word)

    def _split_added(self, text: str) -> List[str]:
        """Split `text` at the added tokens (leftmost, then longest)."""
        toks = sorted(self.added, key=len, reverse=True)
        pieces, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in toks if t and text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                pieces.append(text[start:i])
            pieces.append(hit)
            i += len(hit)
            start = i
        if start < len(text):
            pieces.append(text[start:])
        return pieces

    def encode(self, text: str) -> List[int]:
        """The ids of `text` without the begin / end tokens."""
        unk = self.encoder.get(self.special["unk_token"],
                               self.added.get(self.special["unk_token"]))
        ids: List[int] = []
        for piece in self._split_added(text):
            if piece in self.added:
                ids.append(self.added[piece])
                continue
            for word in split_words(basic_clean(piece)):
                sym = "".join(self.byte_encoder[b]
                              for b in word.encode("utf-8"))
                ids.extend(self.encoder.get(t, unk) for t in self.bpe(sym))
        return ids

    def __call__(self, prompts: Sequence[str],
                 max_length: Optional[int] = None) -> np.ndarray:
        """[n] prompts -> int64 ids [n, max_length]: begin, at most
        max_length - 2 tokens, end, then the pad token."""
        L = max_length or self.model_max_length
        out = np.full((len(prompts), L), self.pad_id, np.int64)
        for r, p in enumerate(prompts):
            ids = [self.bos_id] + self.encode(p)[:L - 2] + [self.eos_id]
            out[r, :len(ids)] = ids
        return out
