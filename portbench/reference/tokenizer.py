"""CLIP's byte-level BPE, written out for the reference: the ids that the
published CLIPTokenizer gives a prompt on a tokenizer dir's `vocab.json`,
`merges.txt` and `special_tokens_map.json`, with added tokens matched in the
raw text before the rest (leftmost, then longest).

Text clean-up as transformers' path without ftfy: control characters
dropped, whitespace collapsed, NFC, lower case.  The pre-tokenizer is
CLIP's pattern `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`, with the letter and number classes
taken from unicodedata (the standard `re` has no \\p{L}).
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence

import numpy as np

MAX_LENGTH = 77
LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def clean_text(text: str) -> str:
    chars = []
    for ch in text:
        cat = unicodedata.category(ch)
        if ch in "\x00�" or (ch not in "\t\n\r" and cat.startswith("C")):
            continue
        chars.append(" " if ch in " \t\n\r" or cat == "Zs" else ch)
    return " ".join(w.lower() for w in unicodedata.normalize("NFC", "".join(chars)).split())


def _kind(ch: str) -> str:
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "*"


def pre_tokenize(text: str) -> List[str]:
    words, i, n = [], 0, len(text)
    while i < n:
        lit = next((w for w in LITERALS if text[i:i + len(w)].casefold() == w), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind, j = _kind(text[i]), i + 1
        if kind == " ":
            i = j
            continue
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


class Tokenizer:
    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:]
        self.ranks = {tuple(line.split()): i for i, line in enumerate(lines)}
        with open(os.path.join(path, "special_tokens_map.json"), encoding="utf-8") as f:
            special = json.load(f)
        content = lambda v: v["content"] if isinstance(v, dict) else v  # noqa: E731
        self.bos = self.vocab[content(special["bos_token"])]
        self.eos = self.vocab[content(special["eos_token"])]
        self.pad = self.vocab[content(special["pad_token"])]
        self.byte_map = bytes_to_unicode()
        self.added: Dict[str, int] = {}

    def add(self, tokens: Sequence[str]) -> None:
        """Added tokens take the next ids, in order (a token of the vocab
        keeps its id)."""
        for tok in tokens:
            if tok not in self.added:
                self.added[tok] = self.vocab.get(tok, len(self.vocab) + sum(
                    1 for t in self.added if t not in self.vocab))

    def _bpe(self, word: str) -> List[str]:
        if word in LITERALS[:2]:
            return [word]
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == best:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        return symbols

    def _text(self, text: str) -> List[int]:
        ids = []
        for word in pre_tokenize(clean_text(text)):
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            ids += [self.vocab.get(s, self.eos) for s in self._bpe(mapped)]
        return ids

    def ids(self, text: str) -> List[int]:
        """The ids of `text` without BOS and EOS."""
        if not self.added:
            return self._text(text)
        pattern = re.compile("|".join(map(re.escape, sorted(self.added, key=len, reverse=True))))
        out, pos = [], 0
        for m in pattern.finditer(text):
            out += self._text(text[pos:m.start()]) + [self.added[m.group()]]
            pos = m.end()
        return out + self._text(text[pos:])

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        """[len(prompts), 77] int64: BOS, the ids cut to 75, EOS, padding."""
        out = np.full((len(prompts), MAX_LENGTH), self.pad, dtype=np.int64)
        for i, p in enumerate(prompts):
            row = [self.bos] + self.ids(p)[:MAX_LENGTH - 2] + [self.eos]
            out[i, :len(row)] = row
        return out
