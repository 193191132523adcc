"""CLIP tokenization: the byte-level BPE of a snapshot, or an offline fallback.

Counterpart of textboost_tpu/data/tokenizer.py, which hands snapshot dirs to
transformers' `CLIPTokenizer`.  The port needs no transformers package:

  * `load_tokenizer(path)` returns `CLIPTokenizer`, the port's own
    byte-level BPE, when a local snapshot has `vocab.json` + `merges.txt`
    (with `special_tokens_map.json` / `tokenizer_config.json` where present).
    It gives transformers' ids on the same files: the text clean-up of
    transformers' path without ftfy (`BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)`: control characters dropped, whitespace
    collapsed, spaces around CJK, NFC, lower case), CLIP's pre-tokenizer
    pattern written without the `regex` package, `</w>` on the last symbol
    of each word, and added tokens matched in the raw text before all of it;
  * otherwise a deterministic `HashTokenizer` keeps the semantics the
    framework relies on: BOS=49406, EOS=49407, pad-with-EOS to 77,
    `input_ids[:,1]==EOS` iff the prompt is empty, a stable word->id
    mapping, and a growable vocab for placeholder tokens.

Both expose the same surface: __call__ (ids and mask, padded with the
tokenizer's pad id), encode, add_tokens, convert_tokens_to_ids, __len__,
model_max_length, pad_token_id.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
BASE_VOCAB = 49408
MAX_LENGTH = 77

_WORD_RE = re.compile(r"<[^>\s]+>|[a-z0-9]+|[^\sa-z0-9]+")


class HashTokenizer:
    """Deterministic word-level tokenizer with CLIP special-token semantics.

    Real text understanding needs the true BPE vocab (use converted HF
    tokenizer files); this fallback keeps every framework mechanism —
    token surgery, null-prompt detection, caption/token pairing —
    exercisable offline with stable ids.
    """

    def __init__(self, model_max_length: int = MAX_LENGTH):
        self.model_max_length = model_max_length
        self.bos_token_id = BOS_ID
        self.eos_token_id = EOS_ID
        self.pad_token_id = EOS_ID
        self._added: dict[str, int] = {}
        self._vocab_size = BASE_VOCAB

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _hash_id(word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 1000 + h % (BOS_ID - 1000)  # stay clear of specials

    def _word_ids(self, text: str) -> List[int]:
        ids = []
        for w in _WORD_RE.findall(text.lower().strip()):
            if w in self._added:
                ids.append(self._added[w])
            else:
                ids.append(self._hash_id(w))
        return ids

    # -- HF-compatible surface --------------------------------------------
    def __len__(self) -> int:
        return self._vocab_size

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._word_ids(text)
        if add_special_tokens:
            ids = [BOS_ID] + ids[: self.model_max_length - 2] + [EOS_ID]
        return ids

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        n = 0
        for tok in tokens:
            key = tok.lower()
            if key in self._added:
                continue
            self._added[key] = self._vocab_size
            self._vocab_size += 1
            n += 1
        return n

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        out = []
        for tok in toks:
            key = tok.lower()
            out.append(self._added.get(key, self._hash_id(key)))
        return out[0] if single else out

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        truncation: bool = True,
        padding: str = "max_length",
        max_length: int = None,
        return_tensors: str = "np",
        **_,
    ):
        max_length = max_length or self.model_max_length
        prompts = [text] if isinstance(text, str) else list(text)
        ids = np.full((len(prompts), max_length), EOS_ID, dtype=np.int32)
        mask = np.zeros((len(prompts), max_length), dtype=np.int32)
        for i, p in enumerate(prompts):
            row = self.encode(p, add_special_tokens=False)
            if truncation:
                row = row[: max_length - 2]
            row = [BOS_ID] + row + [EOS_ID]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return _BatchEncoding(input_ids=ids, attention_mask=mask)


def bytes_to_unicode() -> Dict[int, str]:
    """The byte -> printable character map of byte-level BPE (GPT-2/CLIP)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\u00a1"), ord("\u00ac") + 1))
          + list(range(ord("\u00ae"), ord("\u00ff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clean_text(text: str) -> str:
    """transformers' CLIP clean-up without ftfy: drop NUL, U+FFFD and control
    characters, whitespace to spaces, spaces around CJK characters, NFC,
    then lower-cased words joined by single spaces."""
    chars = []
    for ch in text:
        if ch in "\x00\ufffd" or _is_control(ch):
            continue
        if _is_whitespace(ch):
            chars.append(" ")
        elif _is_cjk(ord(ch)):
            chars.append(f" {ch} ")
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    return " ".join(word.lower() for word in text.split())


# CLIP's pre-tokenizer, `<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|
# [\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+` (case-insensitive), tried in that
# order at each position; stdlib `re` has no \p{L}, so the classes come from
# unicodedata categories.
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "*"


def pre_tokenize(text: str) -> List[str]:
    """The words of `text` under CLIP's pre-tokenizer pattern."""
    words, i, n = [], 0, len(text)
    while i < n:
        lit = next((w for w in _LITERALS if text[i:i + len(w)].casefold() == w), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _char_class(text[i])
        j = i + 1
        if kind == " ":
            i = j
            continue
        if kind != "N":  # letters and "other" runs are greedy, digits one at a time
            while j < n and _char_class(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _special_token(value) -> str:
    """A special token's content from a config entry (a string, or an
    AddedToken dict, which must not strip or match single words)."""
    if isinstance(value, dict):
        if any(value.get(flag) for flag in ("lstrip", "rstrip", "single_word")):
            raise ValueError(f"special token {value} strips or matches single words: "
                             "not served by the port's tokenizer")
        return value["content"]
    return value


class CLIPTokenizer:
    """Byte-level BPE CLIP tokenizer over a snapshot's `vocab.json` and
    `merges.txt`, with transformers' `CLIPTokenizer` semantics (see the
    module docstring)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 unk_token: str = "<|endoftext|>", pad_token: str = "<|endoftext|>",
                 model_max_length: int = MAX_LENGTH):
        self.encoder = dict(vocab)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = model_max_length
        # The pattern's two special words map to themselves, without </w>.
        self._cache: Dict[str, List[str]] = {w: [w] for w in _LITERALS[:2]}
        self._added: Dict[str, int] = {}
        self.add_tokens([bos_token, eos_token, unk_token, pad_token])
        self.bos_token_id, self.eos_token_id, self.unk_token_id, self.pad_token_id = (
            self._added[tok] for tok in (bos_token, eos_token, unk_token, pad_token))

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        """Read `vocab.json`, `merges.txt` and, where present,
        `tokenizer_config.json` and `special_tokens_map.json` (which
        overrides the config's special tokens, as transformers' legacy
        loading does, unless the config lists its `added_tokens_decoder`)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            # transformers' slice: the version line off, at most 48894 merges.
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        config = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            file = os.path.join(path, name)
            if os.path.isfile(file) and not (name == "special_tokens_map.json"
                                             and "added_tokens_decoder" in config):
                with open(file, encoding="utf-8") as f:
                    config.update(json.load(f))
        kwargs = {key: _special_token(config[key])
                  for key in ("bos_token", "eos_token", "unk_token", "pad_token") if key in config}
        tok = cls(vocab, merges, model_max_length=config.get("model_max_length", MAX_LENGTH),
                  **kwargs)
        for tid, entry in sorted(config.get("added_tokens_decoder", {}).items(),
                                 key=lambda kv: int(kv[0])):
            tok.add_tokens(_special_token(entry))
            if tok.convert_tokens_to_ids(entry["content"]) != int(tid):
                raise ValueError(f"{path}: added token {entry['content']!r} is listed at id "
                                 f"{tid}, the vocab gives it another")
        return tok

    def __len__(self) -> int:
        return len(set(self.encoder) | set(self._added))

    def _bpe(self, word: str) -> List[str]:
        """BPE symbols of one pre-tokenized word (byte-mapped), `</w>` on the
        last one."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
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
        self._cache[word] = symbols
        return symbols

    def _text_ids(self, text: str) -> List[int]:
        """Ids of text that holds no added token."""
        ids = []
        for word in pre_tokenize(clean_text(text)):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids += [self.encoder.get(sym, self.unk_token_id) for sym in self._bpe(mapped)]
        return ids

    def _ids(self, text: str) -> List[int]:
        """Added tokens are matched in the raw text first (case-sensitive,
        leftmost, then longest), the pieces between them go through BPE."""
        ids, pos = [], 0
        for m in self._added_re.finditer(text):
            ids += self._text_ids(text[pos:m.start()]) + [self._added[m.group()]]
            pos = m.end()
        return ids + self._text_ids(text[pos:])

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._ids(text)
        return [self.bos_token_id] + ids + [self.eos_token_id] if add_special_tokens else ids

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Register added tokens; a token already in the vocab keeps its id,
        a new one takes the next id.  Returns the number of new ids."""
        if isinstance(tokens, str):
            tokens = [tokens]
        first_new, n = len(self), 0
        for tok in tokens:
            if not tok or tok in self._added:
                continue
            if tok in self.encoder:
                self._added[tok] = self.encoder[tok]
            else:
                self._added[tok] = first_new + n
                n += 1
        self._added_re = re.compile("|".join(
            map(re.escape, sorted(self._added, key=len, reverse=True))))
        return n

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        single = isinstance(tokens, str)
        out = [self._added.get(tok, self.encoder.get(tok, self.unk_token_id))
               for tok in ([tokens] if single else tokens)]
        return out[0] if single else out

    def __call__(self, text: Union[str, Sequence[str]], truncation: bool = True,
                 padding: str = "max_length", max_length: int = None,
                 return_tensors: str = "np", **_):
        if padding != "max_length":
            raise ValueError(f"padding={padding!r}: the port pads to max_length only")
        max_length = max_length or self.model_max_length
        prompts = [text] if isinstance(text, str) else list(text)
        ids = np.full((len(prompts), max_length), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(prompts), max_length), dtype=np.int64)
        for i, p in enumerate(prompts):
            row = self._ids(p)
            if truncation:
                row = row[: max_length - 2]
            row = [self.bos_token_id] + row + [self.eos_token_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return _BatchEncoding(input_ids=ids, attention_mask=mask)


class _BatchEncoding(dict):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.__dict__ = self


def load_tokenizer(model_name_or_path: str = None, subfolder: str = "tokenizer"):
    """The port's CLIP BPE tokenizer from a local snapshot's vocab files (the
    `tokenizer/` subfolder, then the directory itself), else the hash
    fallback."""
    if model_name_or_path:
        tok_dir = os.path.join(model_name_or_path, subfolder)
        for d in (tok_dir, model_name_or_path):
            if os.path.isfile(os.path.join(d, "vocab.json")):
                return CLIPTokenizer.from_dir(d)
    return HashTokenizer()


def tokenize_prompt(tokenizer, prompt, tokenizer_max_length: int = None) -> np.ndarray:
    """Pad to max length and truncate.  Returns int32 [N, 77] input_ids."""
    out = tokenizer(
        prompt,
        truncation=True,
        padding="max_length",
        max_length=tokenizer_max_length or tokenizer.model_max_length,
        return_tensors="np",
    )
    return np.asarray(out["input_ids"], dtype=np.int32)
