"""The port's auxiliary datasets and `python -m textboost_torch.tools.gen_null_emb`,
held against the JAX package.

JsonDataset / StyleDrop on a local JSON whose records name a local image
and a URL already in the image cache, and DrawBench from a cached copy of
its prompt list (nothing here touches the network), against the JAX classes
on the same files; then the null-embedding asset at `tiny` against what
tools/gen_null_emb.py writes for the same weights.
"""
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from textboost_tpu.data import aux_datasets as jax_aux
from textboost_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from textboost_tpu.models import pretrained as jax_pretrained
from textboost_torch.data import aux_datasets
from textboost_torch.data.tokenizer import load_tokenizer
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.pretrained import ModelBundle, build_models
from textboost_torch.models.textboost import load_null_embedding_asset
from textboost_torch.tools import gen_null_emb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def style_json(tmp_path):
    rng = np.random.RandomState(0)
    local = tmp_path / "local.png"
    Image.fromarray(rng.randint(0, 255, (70, 90, 3), dtype=np.uint8)).save(local)
    cache = tmp_path / "cache"
    cache.mkdir()
    Image.fromarray(rng.randint(0, 255, (96, 64, 3), dtype=np.uint8)).save(cache / "style.png")
    records = [{"image": str(local), "caption": "a watercolor painting"},
               {"url": "https://example.invalid/img/style.png?raw=1", "token": "<s1>"}]
    path = tmp_path / "styledrop.json"
    path.write_text(json.dumps(records))
    return str(path), str(cache)


@pytest.mark.parametrize("center_crop", [True, False])
def test_json_dataset_and_styledrop_match_jax(style_json, center_crop):
    path, cache = style_json
    kw = dict(cache_dir=cache, size=48, center_crop=center_crop, template="in the style of {}",
              seed=3)
    pairs = [(jax_aux.JsonDataset(path, jax_load_tokenizer(None), **kw),
              aux_datasets.JsonDataset(path, load_tokenizer(None), **kw)),
             (jax_aux.StyleDrop(jax_load_tokenizer(None), json_file=path, **kw),
              aux_datasets.StyleDrop(load_tokenizer(None), json_file=path, **kw))]
    for want_ds, got_ds in pairs:
        assert len(got_ds) == len(want_ds) == 2
        for i in range(2):
            want, got = want_ds[i], got_ds[i]
            assert got["prompt"] == want["prompt"]
            assert got["image"].dtype == want["image"].dtype == np.float32
            assert got["image"].shape == (48, 48, 3)
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert pairs[0][1][1]["prompt"] == "in the style of <s1>"


def test_drawbench_from_its_cached_list_matches_jax(tmp_path):
    rows = [("A red colored car.", "Colors"), ("A black colored banana.", "Colors"),
            ("A storefront with 'Hello' written on it.", "Text")]
    lines = ["{"]  # data_meta.json's layout: a prompt line, its category, a closing brace
    for prompt, cat in rows:
        lines += [f'  "{prompt}": {{', f'    "category": "{cat}"', "  },"]
    lines.append("}")
    cache = tmp_path / "drawbench.json"
    cache.write_text("\n".join(lines))
    want = jax_aux.DrawBench(jax_load_tokenizer(None), cache_file=str(cache))
    got = aux_datasets.DrawBench(load_tokenizer(None), cache_file=str(cache))
    assert got.data == want.data == [(p, c.lower()) for p, c in rows]
    for i in range(len(rows)):
        assert got[i]["prompt"] == want[i]["prompt"] and got[i]["class"] == want[i]["class"]
        np.testing.assert_array_equal(got[i]["input_ids"], want[i]["input_ids"])
    assert len(aux_datasets.DrawBench(load_tokenizer(None), num_samples=2,
                                      cache_file=str(cache))) == 2


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_gen_null_emb",
                                                  os.path.join(REPO, "tools", "gen_null_emb.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_pretrained.load_models("tiny", dtype=jnp.float32)


@pytest.mark.parametrize("prompt", ["", "a photo of a dog"])
def test_gen_null_emb_writes_the_jax_tools_tensor(tmp_path, monkeypatch, jax_tiny, prompt):
    """The port's tool on the JAX tool's `tiny` weights (carried over) writes
    its tensor: fp32 [77, 64] within 1e-5, and the trainer's asset reader
    takes it."""
    bundle = jax_tiny  # the JAX tool's own load_models("tiny") returns it from its memo
    want_path = str(tmp_path / "jax" / "null.pt")
    monkeypatch.setattr(sys, "argv", ["gen_null_emb.py", "--model", "tiny", "--out", want_path,
                                      "--prompt", prompt])
    _jax_tool().main()

    te, unet, vae = build_models(get_spec("tiny"), device="cpu")
    te.load_state_dict(state_dict_from_jax("text_encoder", bundle.te_params), strict=True)
    unet.load_state_dict(state_dict_from_jax("unet", bundle.unet_params), strict=True)
    vae.load_state_dict(state_dict_from_jax("vae", bundle.vae_params), strict=True)
    port_bundle = ModelBundle(get_spec("tiny"), te, unet, vae)
    seen = {}

    def load(model, **kw):
        seen.update(model=model, **kw)
        return port_bundle

    monkeypatch.setattr("textboost_torch.models.pretrained.load_models", load)
    got_path = gen_null_emb.main(["--model", "tiny", "--out", str(tmp_path / "port" / "null.pt"),
                                  "--prompt", prompt, "--device", "cpu"])
    assert seen == {"model": "tiny", "dtype": torch.float32, "device": torch.device("cpu")}
    want = torch.load(want_path, weights_only=True)
    got = torch.load(got_path, weights_only=True)
    assert got.dtype == want.dtype == torch.float32 and tuple(got.shape) == (77, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert load_null_embedding_asset(got_path, (77, 64)).shape == (77, 64)


def test_gen_null_emb_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen_null_emb.main(["--model", "tiny", "--out", str(tmp_path / "x.pt")])
