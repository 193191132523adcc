"""CLIP tokenization with an offline-safe fallback.

A copy of textboost_tpu/data/tokenizer.py (the port imports nothing from the
JAX package):

  * `load_tokenizer(path)` returns transformers' CLIP tokenizer when vocab
    files exist locally (transformers is imported only then);
  * otherwise a deterministic `HashTokenizer` keeps the semantics the
    framework relies on: BOS=49406, EOS=49407, pad-with-EOS to 77,
    `input_ids[:,1]==EOS` iff the prompt is empty, a stable word->id
    mapping, and a growable vocab for placeholder tokens.

Both expose the same surface: __call__, encode, add_tokens,
convert_tokens_to_ids, __len__, model_max_length.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import List, Sequence, Union

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


class _BatchEncoding(dict):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.__dict__ = self


def load_tokenizer(model_name_or_path: str = None, subfolder: str = "tokenizer"):
    """HF CLIP tokenizer from a local snapshot, else the hash fallback."""
    if model_name_or_path:
        tok_dir = os.path.join(model_name_or_path, subfolder)
        for d in (tok_dir, model_name_or_path):
            if os.path.isfile(os.path.join(d, "vocab.json")):
                from transformers import CLIPTokenizer

                return CLIPTokenizer.from_pretrained(d)
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
