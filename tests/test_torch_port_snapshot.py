"""Diffusers snapshots loaded by the port against the JAX package's loader.

A tiny snapshot is written from seeded `tiny` weights (the port's, which
cost no JAX init program) with `chip_smoke.write_snapshot`, the port's own
safetensors writer and a BPE tokenizer, as tests/test_snapshots.py writes
one for JAX; both packages load it (the JAX package through
`load_diffusers_snapshot` without LoRA, the programs tests/test_snapshots.py
compiles) and their forwards (text encoder, UNet, VAE decode) agree in fp32
at the tolerances of tests/test_torch_port_models.py.  Variants with legacy VAE
attention names, with `.bin` files and with the text encoder's
`position_ids` buffer load to the same tensors.  Run from the repo root
(imports chip_smoke).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from textboost_tpu.models.convert import load_diffusers_snapshot
from textboost_torch.data.tokenizer import CLIPTokenizer, load_tokenizer, tokenize_prompt
from textboost_torch.lora.peft_io import save_safetensors
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import POSITION_IDS_KEY, snapshot_family
from textboost_torch.models.pretrained import PARTS, _load_part, build_models, load_models

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts():
    bundle = load_models("tiny", dtype=torch.float32, device="cpu", seed=5)
    return {part: {k: v.numpy() for k, v in getattr(bundle, part).state_dict().items()}
            for part in PARTS}


@pytest.fixture(scope="module")
def snapshot(parts, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("snap") / "sd")
    chip_smoke.write_snapshot(root, parts)
    return root


@pytest.fixture(scope="module")
def both(snapshot):
    jax_bundle = load_diffusers_snapshot(snapshot, dtype=jnp.float32, spec_name="tiny")
    port = load_models(snapshot, preset="tiny", lora_rank=4, dtype=torch.float32, device="cpu")
    return jax_bundle, port


def test_text_encoder_forward_matches_jax(both, snapshot):
    jax_bundle, port = both
    tok = load_tokenizer(snapshot)
    assert isinstance(tok, CLIPTokenizer) and tok.pad_token_id == 0  # sd2's "!"
    ids = tokenize_prompt(tok, ["a photo of a teapot", "", "painting of a dog, Monet style"])
    hidden, pooled = jax.jit(jax_bundle.text_encoder.apply)(jax_bundle.te_params,
                                                            jnp.asarray(ids))
    with torch.no_grad():
        got_hidden, got_pooled = port.text_encoder(torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), atol=1e-4, rtol=1e-4)
    q = port.text_encoder.text_model.encoder.layers[0].self_attn.q_proj
    assert torch.count_nonzero(q.lora_B.weight) == 0 and q.lora_A.weight.std() > 0.1


def test_unet_and_vae_decode_match_jax(both):
    jax_bundle, port = both
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 871], np.int32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    want = jax.jit(jax_bundle.unet.apply)(jax_bundle.unet_params, x, t, ctx)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    want_img = jax.jit(lambda p, z: jax_bundle.vae.apply(p, z, method="decode"))(
        jax_bundle.vae_params, z)
    with torch.no_grad():
        got = port.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                        torch.from_numpy(ctx))
        img = port.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), np.asarray(want_img),
                               atol=5e-4, rtol=1e-3)


def _write_variant(root, parts, variant):
    parts = {part: dict(sd) for part, sd in parts.items()}
    if variant == "legacy_vae":
        vae = {}
        for key, val in parts["vae"].items():
            for new, old in LEGACY.items():
                if f".attentions.0.{new}." in key:
                    key = key.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
                    if val.ndim == 2 and old == "proj_attn":
                        val = val[:, :, None, None]  # stored as a 1x1 conv
            vae[key] = val
        parts["vae"] = vae
    if variant == "position_ids":
        parts["text_encoder"][POSITION_IDS_KEY] = np.arange(77, dtype=np.int64)[None]
    chip_smoke.write_snapshot(root, parts)
    if variant == "bin":
        for part, name in chip_smoke.SNAPSHOT_FILES.items():
            os.remove(os.path.join(root, part, name))
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in parts[part].items()},
                       os.path.join(root, part, "pytorch_model.bin"))


@pytest.mark.parametrize("variant", ["legacy_vae", "bin", "position_ids"])
def test_snapshot_variants_load_to_the_same_tensors(both, parts, tmp_path, variant):
    _, port = both
    root = str(tmp_path / variant)
    _write_variant(root, parts, variant)
    got = load_models(root, preset="tiny", lora_rank=4, dtype=torch.float32, device="cpu")
    for name in PARTS:
        want_sd, got_sd = getattr(port, name).state_dict(), getattr(got, name).state_dict()
        assert set(want_sd) == set(got_sd)
        for key in want_sd:
            assert torch.equal(got_sd[key], want_sd[key]), (variant, key)


def test_a_wrong_or_missing_key_fails_the_load(parts, tmp_path):
    for change in ("extra", "missing"):
        bad = {part: dict(sd) for part, sd in parts.items()}
        if change == "extra":
            bad["unet"]["conv_in.extra.weight"] = np.zeros(3, np.float32)
        else:
            del bad["vae"]["decoder.conv_in.bias"]
        root = str(tmp_path / change)
        chip_smoke.write_snapshot(root, bad)
        with pytest.raises(KeyError, match="does not fit"):
            load_models(root, preset="tiny", dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("width,family", [(768, "sd15"), (1024, "sd21base")])
def test_family_is_inferred_from_the_text_encoders_header(tmp_path, width, family):
    te = tmp_path / "text_encoder"
    te.mkdir()
    save_safetensors({"text_model.embeddings.token_embedding.weight":
                      np.zeros((4, width), np.float16)}, str(te / "model.safetensors"))
    assert snapshot_family(str(tmp_path)) == family


def _manifest(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


@pytest.mark.parametrize("family,clip", [("sd15", "clip_sd15.manifest"),
                                         ("sd21base", "clip_sd21base.manifest")])
def test_published_key_sets_load_strictly_on_the_meta_device(family, clip):
    """A snapshot holding the published keys (with the position_ids buffer
    dropped) fits the port's modules built with both LoRAs."""
    manifests = {"text_encoder": clip, "unet": f"unet_{family}.manifest", "vae": "vae_sd.manifest"}
    modules = build_models(get_spec(family), lora_rank=4, unet_lora_rank=4, device="meta")
    for name, mod in zip(PARTS, modules):
        sd = {k: torch.empty(shape, device="meta")
              for k, shape in _manifest(manifests[name]).items()}
        _load_part(name, mod, sd)
        sd.popitem()
        with pytest.raises(KeyError, match="does not fit"):
            _load_part(name, mod, sd)


def test_a_native_jax_snapshot_is_refused(tmp_path):
    """Native snapshots load (tests/test_torch_port_native.py); one without
    its msgpack trees is refused, naming the missing file."""
    (tmp_path / "spec.json").write_text(json.dumps({"name": "tiny"}))
    with pytest.raises(FileNotFoundError, match="text_encoder.msgpack is missing"):
        load_models(str(tmp_path), device="cpu")


def test_the_trainer_the_pipeline_and_inference_take_the_snapshot_dir(snapshot, tmp_path,
                                                                      monkeypatch):
    """One CLI step from the snapshot dir (its BPE tokenizer and weights),
    then `inference.py --model <dir>` over its output; a tiny snapshot's
    width (64) names no family, so the test maps it to `tiny`."""
    from PIL import Image

    from textboost_torch import inference
    from textboost_torch.models import convert
    from textboost_torch.train import main as train_main

    (tmp_path / "instance").mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(
        tmp_path / "instance" / "a.png")
    out = str(tmp_path / "out")
    metrics = train_main([
        "--device", "cpu", "--pretrained_model_name_or_path", snapshot, "--model_preset", "tiny",
        "--instance_data_dir", str(tmp_path / "instance"), "--output_dir", out,
        "--placeholder_token", "<v*>", "--initializer_token", "dog", "--max_train_steps", "1",
        "--train_batch_size", "1", "--resolution", "64", "--checkpointing_steps", "0",
        "--learning_rate", "1e-2", "--report_to", "none"])
    assert metrics["steps"] == 1 and np.isfinite(metrics["loss"])
    monkeypatch.setitem(convert.FAMILY_BY_WIDTH, 64, "tiny")
    args = inference.parse_args([out, "--model", snapshot, "--prompt", "photo of a <v*>",
                                 "--seeds", "0", "--steps", "2", "--device", "cpu"])
    images = inference.generate(args)
    assert images.dtype == np.uint8 and images.shape == (1, 128, 128, 3)
