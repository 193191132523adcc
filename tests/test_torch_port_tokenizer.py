"""The port's own CLIP BPE tokenizer against transformers' `CLIPTokenizer`.

Both read one tokenizer dir written by `chip_smoke.write_clip_tokenizer` (a
dense 49408-entry byte-level vocab with merges learned from the port's
templates and human prompts), with sd1's pad token (<|endoftext|>) and
sd2's ("!", id 0).  transformers runs its ftfy-free path here, as on any
machine without ftfy.  Run from the repo root (imports chip_smoke).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import regex
import torch
from transformers import CLIPTokenizer as HFCLIPTokenizer

import chip_smoke
from textboost_torch.data.human_prompts import EXTENDED_HUMAN_PROMPTS
from textboost_torch.data.templates import TEMPLATE_BANKS
from textboost_torch.data.tokenizer import (
    CLIPTokenizer,
    clean_text,
    load_tokenizer,
    pre_tokenize,
    tokenize_prompt,
)
from textboost_torch.tokens.surgery import OBJECT_AUGMENTATIONS, expand_placeholder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ODD_PROMPTS = [
    "", " ", "a photo of a dog", "Hello!! World??", "wow!!! ok!", "café naïve résumé Ångström",
    "東京タワー 北京の夜", "한국어 문장", "Привет, мир", "  lots   of\tspace\n\nand\r\nlines  ",
    "it's 12345 o'clock, you'RE 'S fine", "3.14159 and 1,000,000 and 2024-10-17",
    "a_b-c.d/e\\f|g@h#i$j%k^l&m*n(o)p[q]{r}", "ÀÉÎ İstanbul straße ﬁ ŉ", "emoji 😀👍🏽 ok",
    "x\x00y\u200bz\ufeff\x07q", "½ ² ⅻ ٣ ൬", "<|startoftext|> and <|endoftext|> inside",
    "<|STARTOFTEXT|> upper", "''s '''", "a<0>b <0> <1> <i>", "UPPER lower MiXeD",
    "tab\tand\u3000ideographic space", "l'été s'il", "don't can't won't y'all'd've",
    "naïve café" * 20,
]


def _prompts():
    words = ["dog", "teapot", "<v*>", "<teapot_0> <teapot_1>", "<0>", "sks dog",
             "<zoom-in_0> <zoom-in_1> <v*>"]
    out = [t.format(w) for bank in TEMPLATE_BANKS.values() for t in bank[:12] for w in words]
    out += list(EXTENDED_HUMAN_PROMPTS[:150]) + ODD_PROMPTS
    return out


PROMPTS = _prompts()
ADDED = (["<v*>", "<teapot_0>", "<teapot_1>"]
         + [t for p, init in OBJECT_AUGMENTATIONS.items()
            for t in expand_placeholder(p, len(init.split()))])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["sd1_pad", "sd2_pad", "saved_config"])
def tok_dir(request, tmp_path_factory):
    """sd1's pad (<|endoftext|>), sd2's ("!" in special_tokens_map.json), and
    a config as newer transformers save it: its `added_tokens_decoder` and
    pad token ("!") win over special_tokens_map.json (here <|endoftext|>)."""
    path = str(tmp_path_factory.mktemp("tokenizer") / "tokenizer")
    chip_smoke.write_clip_tokenizer(path, pad_token="!" if request.param == "sd2_pad"
                                    else "<|endoftext|>")
    if request.param == "saved_config":
        config_path = os.path.join(path, "tokenizer_config.json")
        with open(config_path) as f:
            config = json.load(f)
        entry = {"lstrip": False, "rstrip": False, "single_word": False, "normalized": False,
                 "special": True}
        config["added_tokens_decoder"] = {
            str(i): dict(entry, content=tok)
            for i, tok in ((0, "!"), (49406, "<|startoftext|>"), (49407, "<|endoftext|>"))}
        for name in ("bos_token", "eos_token", "unk_token"):  # saved as strings
            config[name] = config[name]["content"]
        config["pad_token"] = "!"
        with open(config_path, "w") as f:
            json.dump(config, f)
    return path


def _pair(tok_dir):
    return HFCLIPTokenizer.from_pretrained(tok_dir), load_tokenizer(os.path.dirname(tok_dir))


def _batch(tok, prompts):
    out = tok(prompts, truncation=True, padding="max_length", max_length=77,
              return_tensors="np")
    return np.asarray(out["input_ids"]), np.asarray(out["attention_mask"])


def test_the_written_vocab_is_dense_clip_layout(tok_dir):
    ours = CLIPTokenizer.from_dir(tok_dir)
    assert len(ours) == 49408
    assert (ours.bos_token_id, ours.eos_token_id) == (49406, 49407)
    assert ours.convert_tokens_to_ids("!") == 0 and len(ours.bpe_ranks) > 1000


def test_ids_and_mask_equal_transformers(tok_dir):
    hf, ours = _pair(tok_dir)
    assert isinstance(ours, CLIPTokenizer)
    assert ours.pad_token_id == hf.pad_token_id
    assert len(PROMPTS) > 300
    for want, got in zip(_batch(hf, PROMPTS), _batch(ours, PROMPTS)):
        np.testing.assert_array_equal(got, want)
    for p in ODD_PROMPTS:
        assert ours.encode(p, add_special_tokens=False) == hf.encode(p, add_special_tokens=False), p


def test_added_tokens_take_transformers_ids(tok_dir):
    hf, ours = _pair(tok_dir)
    # A repeat and a vocab entry ("!") add no id; "dog" is not an entry
    # ("dog</w>" is), so it takes one.
    for tok in ADDED + ["<v*>", "!", "dog"]:
        assert ours.add_tokens(tok) == hf.add_tokens(tok), tok
    assert len(ours) == len(hf) == 49408 + len(ADDED) + 1
    assert ours.convert_tokens_to_ids(ADDED) == hf.convert_tokens_to_ids(ADDED)
    assert ours.convert_tokens_to_ids("never-seen") == hf.convert_tokens_to_ids("never-seen")
    for want, got in zip(_batch(hf, PROMPTS), _batch(ours, PROMPTS)):
        np.testing.assert_array_equal(got, want)
    for init in OBJECT_AUGMENTATIONS.values():
        assert ours.encode(init, add_special_tokens=False) == hf.encode(init, add_special_tokens=False)


def test_truncation_at_77_and_the_pad_id(tok_dir):
    hf, ours = _pair(tok_dir)
    long = " ".join(["a <v*> photo of 12 dogs, in Zürich"] * 20)
    hf.add_tokens("<v*>")
    ours.add_tokens("<v*>")
    ids = tokenize_prompt(ours, [long, ""])
    np.testing.assert_array_equal(ids, tokenize_prompt(hf, [long, ""]))
    assert ids.shape == (2, 77) and ids[0, -1] == ours.eos_token_id
    # The null prompt: [BOS, EOS, pad...], so input_ids[:, 1] == EOS marks it
    # and the first EOS (the pooled position) is at 1 for either pad id.
    assert ids[1, 1] == ours.eos_token_id
    assert (ids[1, 2:] == ours.pad_token_id).all()
    assert int((ids[1] == ours.eos_token_id).argmax()) == 1


def test_pre_tokenizer_equals_the_regex_pattern():
    pat = regex.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    for p in ODD_PROMPTS + PROMPTS[:50]:
        text = clean_text(p)
        assert pre_tokenize(text) == pat.findall(text), p


def test_loads_with_transformers_blocked(tok_dir):
    """Closed: the port's tokenizer needs no transformers (a subprocess in
    which importing transformers fails loads the snapshot's tokenizer)."""
    hf, _ = _pair(tok_dir)
    prompt = "a photo of a café dog, 東京 42!"
    code = (
        "import json, sys; sys.modules['transformers'] = None\n"
        "from textboost_torch.data.tokenizer import CLIPTokenizer, load_tokenizer\n"
        f"tok = load_tokenizer({os.path.dirname(tok_dir)!r})\n"
        "assert isinstance(tok, CLIPTokenizer), type(tok)\n"
        f"print(json.dumps(tok({prompt!r})['input_ids'][0].tolist()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == _batch(hf, [prompt])[0][0].tolist()
