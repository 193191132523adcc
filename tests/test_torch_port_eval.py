"""The port's DreamBooth eval against the JAX package: the four scorers,
their weights, `compute_metrics`' CSV and `generate`.

Each scorer reads one checkpoint written by transformers in its published
layout (a CLIPModel, a Dinov2Model or its hub layout, a sharded
T5ForConditionalGeneration, a CLIP vision tower and a LLaVA projector);
the same state dict goes through the JAX package's `convert_*`, and the
two scorers must agree on the same inputs (fp32, CPU): features and logits
within atol 1e-4 / rtol 1e-4, P(yes) within 1e-5.  The CSV of the port's
`compute_metrics` must equal the JAX CLI's on one directory of images, with
the JAX package's tiny random-init scorers carried across
(`*_state_dict_from_jax`); `generate` at tiny must give the JAX CLI's images
(fp32, the same latent) within one uint8 level.
"""
import csv
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import eval_dreambooth as jax_eval
from textboost_tpu.eval import clip_scorer as jax_clip
from textboost_tpu.eval import dino as jax_dino
from textboost_tpu.eval import t5 as jax_t5
from textboost_tpu.eval import vqa as jax_vqa
from textboost_tpu.eval.scorer_weights import (
    convert_clip_model,
    convert_clip_vision,
    convert_dinov2,
    convert_mm_projector,
    convert_t5,
)
from textboost_torch.eval import __main__ as port_eval
from textboost_torch.eval import scorer_weights
from textboost_torch.eval.clip_scorer import TINY_CLIP, CLIPScorer
from textboost_torch.eval.dino import TINY_VIT, DINOScorer
from textboost_torch.eval.t5 import TINY_T5, T5Config, T5ForConditionalGeneration
from textboost_torch.eval.vqa import CLIPT5Model, NativeVQAScorer, tiny_vqa_config

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run many small ops; with the suite's other processes on
    every core, torch's thread pool waits on its own threads far longer
    than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, n, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------
def _hf_clip(cfg, seed):
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel as HFCLIPModel

    torch.manual_seed(seed)
    t, v = cfg.text, cfg.vision
    return HFCLIPModel(HFCLIPConfig(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         max_position_embeddings=t.max_position_embeddings,
                         hidden_act=t.hidden_act, eos_token_id=t.eos_token_id,
                         bos_token_id=t.bos_token_id),
        vision_config=dict(image_size=v.image_size, patch_size=v.patch_size,
                           hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_hidden_layers,
                           num_attention_heads=v.num_attention_heads, hidden_act=v.hidden_act),
        projection_dim=cfg.projection_dim)).eval()


def test_clip_scorer_reads_a_transformers_checkpoint_as_jax_converts_it(tmp_path):
    hf = _hf_clip(TINY_CLIP, seed=0)
    hf.save_pretrained(str(tmp_path / "clip"))  # model.safetensors + config.json
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    cfg = jax_clip.TINY_CLIP
    template = jax.eval_shape(jax_clip.CLIPModel(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 77), jnp.int32),
                              jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3)))
    jax_scorer = jax_clip.CLIPScorer(cfg, params=convert_clip_model(sd, template))
    port = CLIPScorer(TINY_CLIP, weights=scorer_weights.clip_weights(str(tmp_path / "clip")),
                      device="cpu")
    from textboost_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer(None)
    prompts = ["a dog in the jungle", "a red clock", "a cube shaped teapot"]
    imgs = _images(0, 3)
    np.testing.assert_allclose(port.text_features(tok, prompts),
                               jax_scorer.text_features(tok, prompts), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port.image_features(imgs), jax_scorer.image_features(imgs),
                               atol=ATOL, rtol=RTOL)
    assert abs(port.clip_t(tok, imgs, prompts) - jax_scorer.clip_t(tok, imgs, prompts)) < ATOL
    assert abs(port.clip_i(imgs, imgs[:2]) - jax_scorer.clip_i(imgs, imgs[:2])) < ATOL


# ---------------------------------------------------------------------------
# DINO
# ---------------------------------------------------------------------------
def _hf_dinov2(cfg, seed, image_size=None):
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    hf = Dinov2Model(Dinov2Config(
        image_size=image_size or cfg.image_size, patch_size=cfg.patch_size,
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, mlp_ratio=cfg.mlp_ratio,
        layer_norm_eps=cfg.layer_norm_eps, layerscale_value=0.5)).eval()
    with torch.no_grad():  # off their init values, so that a dropped gamma shows
        for name, p in hf.named_parameters():
            if "lambda1" in name or "cls_token" in name or "mask_token" in name:
                p.normal_(0.5, 0.2)
    return hf


def _dino_template():
    cfg = jax_dino.TINY_VIT
    return jax.eval_shape(jax_dino.ViTFeatures(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))


@pytest.mark.parametrize("layout", ["transformers", "hub"])
def test_dino_scorer_reads_both_layouts_as_jax_converts_them(tmp_path, layout):
    from textboost_tpu.eval.scorer_weights import hf_dinov2_to_fb

    hf = _hf_dinov2(TINY_VIT, seed=1)
    if layout == "transformers":
        path = str(tmp_path / "dino")
        hf.save_pretrained(path)
    else:
        path = str(tmp_path / "dino.pth")
        hub = {k: torch.from_numpy(np.asarray(v)) for k, v in hf_dinov2_to_fb(
            {k: v.numpy() for k, v in hf.state_dict().items()}).items()}
        hub["mask_token"] = torch.zeros(1, TINY_VIT.hidden_size)  # the hub model's, unused
        torch.save(hub, path)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    jax_scorer = jax_dino.DINOScorer(jax_dino.TINY_VIT,
                                     params=convert_dinov2(sd, _dino_template()))
    port = DINOScorer(TINY_VIT, weights=scorer_weights.dino_weights(path), device="cpu")
    imgs = _images(1, 3)
    np.testing.assert_allclose(port.features(imgs), jax_scorer.features(imgs),
                               atol=ATOL, rtol=RTOL)
    assert abs(port.dino_score(imgs, imgs[:2]) - jax_scorer.dino_score(imgs, imgs[:2])) < ATOL


def test_a_1370_row_position_embedding_is_refused_by_both(tmp_path):
    """DINOv2's published grid is 37 x 37 + 1 (518 px); the scorers run at
    224 px (here the tiny 4 x 4 + 1), and neither interpolates."""
    hf = _hf_dinov2(TINY_VIT, seed=2, image_size=518)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    assert sd["embeddings.position_embeddings"].shape == (1, 1370, TINY_VIT.hidden_size)
    with pytest.raises(ValueError, match="1370"):
        convert_dinov2(sd, _dino_template())
    hf.save_pretrained(str(tmp_path / "dino"))
    with pytest.raises(ValueError, match=r"pos_embed.*\(1, 1370, 64\).*\(1, 17, 64\)"):
        DINOScorer(TINY_VIT, weights=scorer_weights.dino_weights(str(tmp_path / "dino")),
                   device="cpu")


# ---------------------------------------------------------------------------
# T5 and the clip-flant5 composition
# ---------------------------------------------------------------------------
TIED_T5 = T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_decoder_layers=2, num_heads=4, tie_word_embeddings=True)


def _hf_t5(cfg, seed):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration as HFT5

    torch.manual_seed(seed)
    return HFT5(HFT5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
        num_layers=cfg.num_layers, num_decoder_layers=cfg.num_decoder_layers,
        num_heads=cfg.num_heads, relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance, dropout_rate=0.0,
        layer_norm_epsilon=cfg.layer_norm_epsilon, feed_forward_proj="gated-gelu",
        tie_word_embeddings=cfg.tie_word_embeddings, decoder_start_token_id=0,
        pad_token_id=0)).eval()


@pytest.mark.parametrize("cfg", [TINY_T5, TIED_T5], ids=["untied", "tied"])
def test_t5_logits_match_jax_on_a_sharded_checkpoint(tmp_path, cfg):
    hf = _hf_t5(cfg, seed=3)
    hf.save_pretrained(str(tmp_path / "t5"), max_shard_size="40KB")  # shards + index.json
    assert any(f.endswith(".index.json") for f in os.listdir(tmp_path / "t5"))
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(3)
    ids = rng.integers(2, cfg.vocab_size - 2, size=(2, 9)).astype(np.int32)
    dec = np.array([[0, 5, 6], [0, 7, 8]], np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    jax_cfg = jax_t5.T5Config(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(jax_t5.T5Config)})
    jax_model = jax_t5.T5ForConditionalGeneration(jax_cfg)
    params = convert_t5(sd, jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                                           jnp.asarray(ids), jnp.asarray(dec)))
    want = np.asarray(jax.jit(jax_model.apply)(params, jnp.asarray(ids), jnp.asarray(dec),
                                               attention_mask=jnp.asarray(mask, bool)))
    port = T5ForConditionalGeneration(cfg)
    from textboost_torch.eval.clip_scorer import load_strict

    load_strict(port, scorer_weights.t5_weights(str(tmp_path / "t5"), cfg.tie_word_embeddings))
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(dec.astype(np.int64)),
                   attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _hf_vqa_parts(tmp_path, seed):
    """A weights dir of the clip-flant5 parts at the tiny geometry, in the
    published torch layouts; returns it with the state dicts."""
    from transformers import CLIPVisionConfig as HFVisionConfig
    from transformers import CLIPVisionModel as HFVisionModel

    t5_cfg, vis = tiny_vqa_config()
    hf_t5 = _hf_t5(t5_cfg, seed)
    torch.manual_seed(seed + 1)
    hf_vis = HFVisionModel(HFVisionConfig(
        image_size=vis.image_size, patch_size=vis.patch_size, hidden_size=vis.hidden_size,
        intermediate_size=vis.intermediate_size, num_hidden_layers=vis.num_hidden_layers,
        num_attention_heads=vis.num_attention_heads, hidden_act=vis.hidden_act)).eval()
    proj = torch.nn.Sequential(torch.nn.Linear(vis.hidden_size, t5_cfg.d_model),
                               torch.nn.GELU(), torch.nn.Linear(t5_cfg.d_model, t5_cfg.d_model))
    wdir = tmp_path / "vqa"
    hf_t5.save_pretrained(str(wdir / "t5"))
    hf_vis.save_pretrained(str(wdir / "vision"))
    torch.save({f"model.mm_projector.{k}": v for k, v in proj.state_dict().items()},
               str(wdir / "projector.bin"))
    geom = {"yes_token_id": 7,
            "t5": {f: getattr(t5_cfg, f) for f in ("vocab_size", "d_model", "d_kv", "d_ff",
                                                   "num_layers", "num_decoder_layers",
                                                   "num_heads")},
            "vision": {f: getattr(vis, f) for f in ("image_size", "patch_size", "hidden_size",
                                                    "intermediate_size", "num_hidden_layers",
                                                    "num_attention_heads")}}
    (wdir / "config.json").write_text(json.dumps(geom))
    sds = {"t5": hf_t5.state_dict(), "vision": {f"vision_model.{k}": v for k, v in
                                                hf_vis.vision_model.state_dict().items()},
           "projector": proj.state_dict()}
    return str(wdir), {k: {n: t.numpy() for n, t in v.items()} for k, v in sds.items()}


def test_clip_flant5_yes_probability_matches_jax(tmp_path):
    wdir, sds = _hf_vqa_parts(tmp_path, seed=4)
    port = NativeVQAScorer(wdir, device="cpu")
    assert port.yes_token_id == 7 and port.dtype == torch.float32
    t5_cfg, vis = jax_vqa._tiny_vqa_config()
    model = jax_vqa.CLIPT5Model(t5_cfg, vis)
    template = model.shape_template()
    params = {"t5": convert_t5(sds["t5"], template["t5"]),
              "vision": convert_clip_vision(sds["vision"], template["vision"]),
              "projector": convert_mm_projector(sds["projector"], template["projector"])}
    imgs = _images(4, 3)
    prompts = ["a dog in the jungle", "a red clock", "a cube shaped teapot"]
    ids, mask = port.encode_questions(prompts)
    want = np.asarray(jax.jit(functools.partial(model.yes_probability, yes_token_id=7))(
        params, jnp.asarray(jax_clip.normalize_images(imgs, vis.image_size)), jnp.asarray(ids),
        jnp.asarray(mask)))
    np.testing.assert_allclose(port.score_pairs(imgs, prompts), want, atol=1e-5)
    # The offline mode's crc32 question ids are the JAX scorer's.
    jax_ids, jax_mask = jax_vqa.NativeVQAScorer._encode_questions(
        types.SimpleNamespace(_tokenizer=None, model=model), prompts)
    assert np.array_equal(ids, jax_ids) and np.array_equal(mask, jax_mask)


def test_flax_trees_converted_for_the_jax_package_are_refused(tmp_path):
    """The converted trees load (tests/test_torch_port_native.py); a tree
    that does not fit the scorer is refused, naming its file, and a
    `params/` .safetensors is never taken for a torch checkpoint."""
    (tmp_path / "clip.msgpack").write_bytes(b"\x80")  # an empty map: no params
    with pytest.raises(ValueError, match="clip: the flax tree there does not fit"):
        scorer_weights.load_scorers(str(tmp_path), device="cpu")
    from textboost_torch.lora.peft_io import save_safetensors

    save_safetensors({"params/shared/embedding": np.zeros((2, 2), np.float32)},
                     str(tmp_path / "vision.safetensors"))
    assert scorer_weights.resolve(str(tmp_path / "vision")) is None
    with pytest.raises(ValueError, match="vision: the flax tree there does not fit"):
        scorer_weights.load_vqa_parts(CLIPT5Model(*tiny_vqa_config()), str(tmp_path))


# ---------------------------------------------------------------------------
# compute_metrics and generate against the JAX CLI
# ---------------------------------------------------------------------------
def _carried(jax_clip_scorer, jax_dino_scorer, jax_vqa_scorer):
    """The JAX CLI's random-init tiny scorers, carried into the port's."""
    clip = CLIPScorer(TINY_CLIP, device="cpu", weights=scorer_weights.clip_state_dict_from_jax(
        jax_clip_scorer.params))
    dino = DINOScorer(TINY_VIT, device="cpu", weights=scorer_weights.dino_state_dict_from_jax(
        jax_dino_scorer.params))
    model = CLIPT5Model(*tiny_vqa_config())
    model.load_state_dict(scorer_weights.vqa_state_dict_from_jax(jax_vqa_scorer.params),
                          strict=True)
    vqa = NativeVQAScorer(device="cpu", model=model.eval(),
                          yes_token_id=jax_vqa_scorer.yes_token_id)
    return clip, dino, vqa


def _write_images(root, names, seed, size=64):
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(names):
        Image.fromarray(_images(seed + i, 1, size)[0]).save(os.path.join(root, name))


def test_compute_metrics_writes_the_jax_clis_csv(tmp_path, monkeypatch):
    import textboost_tpu.eval
    from textboost_torch.data.tokenizer import load_tokenizer

    outdir, sweep = str(tmp_path / "bench"), tmp_path / "sweep"
    for seed in (0, 1):
        for k, instance in enumerate(("clock", "dog")):
            _write_images(os.path.join(outdir, f"seed{seed}", instance),
                          [f"a_{instance}_in_the_snow.png", f"a_red_{instance}.png"],
                          100 * seed + 10 * k)
    for k, instance in enumerate(("clock", "dog")):
        _write_images(str(tmp_path / "train" / instance), ["0.jpg"], 50 + k)
    _write_images(str(tmp_path / "val" / "dog"), ["0.jpg", "1.jpg"], 60)  # clock has none
    argv = [str(sweep), "--seeds", "0", "1", "--metric", "clip-t", "clip-i", "dino", "vqa",
            "--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
            "--allow-random-scorers", "--device", "cpu"]
    sweep.mkdir()
    # The JAX CLI builds its random-init scorers itself; built once here, they
    # serve it and are carried into the port's.
    jax_scorers = (jax_clip.CLIPScorer(jax_clip.TINY_CLIP), jax_dino.DINOScorer(jax_dino.TINY_VIT),
                   jax_vqa.NativeVQAScorer())
    for mod, name, scorer in ((textboost_tpu.eval, "CLIPScorer", jax_scorers[0]),
                              (textboost_tpu.eval, "DINOScorer", jax_scorers[1]),
                              (jax_vqa, "NativeVQAScorer", jax_scorers[2])):
        monkeypatch.setattr(mod, name, lambda *a, _s=scorer, **k: _s)
    jax_eval.compute_metrics(port_eval.parse_args(argv), outdir)
    want = (sweep / "metric_last.csv").read_text()
    (sweep / "metric_last.csv").unlink()
    scorers = _carried(*jax_scorers)
    monkeypatch.setattr(port_eval, "build_scorers",
                        lambda args, device: (*scorers, load_tokenizer(None)))
    path = port_eval.compute_metrics(port_eval.parse_args(argv), outdir)
    got = open(path).read()
    assert got == want
    rows = list(csv.reader(got.splitlines()))
    assert rows[0] == port_eval.REFERENCE_CSV_HEADER and len(rows) == 3
    assert all(float(c) != 0.0 for r in rows[1:] for c in r[1:])  # every metric ran


def test_metric_none_builds_no_scorer_and_the_random_guard_holds(tmp_path, capsys):
    args = port_eval.parse_args([str(tmp_path), "--metric", "none", "--device", "cpu"])
    assert port_eval.compute_metrics(args, str(tmp_path)) is None
    assert "generation-only" in capsys.readouterr().out
    args = port_eval.parse_args([str(tmp_path), "--metric", "clip-t", "--device", "cpu"])
    with pytest.raises(SystemExit, match="allow-random-scorers"):
        port_eval.compute_metrics(args, str(tmp_path))
    with pytest.raises(ValueError, match="--model"):
        port_eval.detect_model(port_eval.parse_args(["runs/x", "--device", "cpu"]))
    assert port_eval.detect_model(port_eval.parse_args(["out/tb-sd21base-n1"]))[0] == "sd21base"


def test_generate_gives_the_jax_clis_images(tmp_path, monkeypatch):
    """Both CLIs at tiny in fp32 over the same base weights and model dir,
    with the JAX seed-0 latent injected into the port; 2 prompts."""
    from textboost_tpu.eval import dreambooth_bench as jax_bench
    from textboost_tpu.lora import peft_io as jax_peft
    from textboost_tpu.models.pretrained import load_models as jax_load_models
    from textboost_tpu.pipelines import loading as jax_loading
    from textboost_torch.eval import dreambooth_bench
    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.convert import state_dict_from_jax
    from textboost_torch.models.pretrained import ModelBundle, build_models
    from textboost_torch.pipelines import loading

    # Called as the JAX CLI's loader calls it, so that its preset memo serves both.
    jax_tiny = jax_load_models("tiny", lora_rank=4, dtype=jnp.float32)
    model_dir = tmp_path / "tb-tiny" / "clock"
    rng = np.random.default_rng(0)
    flat = {name: {"self_attn": {p: dict(v, lora_b=(rng.standard_normal((4, 64)) * 0.2)
                                         .astype(np.float32))
                                 for p, v in layer["self_attn"].items() if p != "out_proj"}}
            for name, layer in jax_tiny.te_params["params"].items() if name.startswith("layers_")}
    jax_peft.export_lora_adapter({"params": flat}, str(model_dir / "text_encoder"), rank=4)
    jax_peft.export_token_embeddings((rng.standard_normal((1, 64)) * 0.3).astype(np.float32),
                                     {"<clock>": 0}, str(model_dir))
    two = ["a {0} in the jungle", "a red {0}"]
    for mod in (jax_bench, dreambooth_bench):
        monkeypatch.setattr(mod, "prompts_for", lambda instance: two)
    monkeypatch.setattr(jax_loading, "load_textboost_pipeline", functools.partial(
        jax_loading.load_textboost_pipeline, dtype=jnp.float32))
    modules = build_models(get_spec("tiny"), lora_rank=4, device="cpu")
    for mod, kind, params in zip(modules, ("text_encoder", "unet", "vae"),
                                 (jax_tiny.te_params, jax_tiny.unet_params, jax_tiny.vae_params)):
        mod.load_state_dict(state_dict_from_jax(kind, params), strict=True)
    base = ModelBundle(get_spec("tiny"), *modules)
    monkeypatch.setattr(loading, "load_models", lambda *a, **k: base)
    monkeypatch.setattr(loading, "load_textboost_pipeline", functools.partial(
        loading.load_textboost_pipeline, dtype=torch.float32))
    latent = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 16, 4), dtype=np.float32))
    monkeypatch.setattr(port_eval, "seed_latent",
                        lambda seed, size, device: torch.from_numpy(latent))
    argv = [str(tmp_path / "tb-tiny"), "--instances", "clock", "--seeds", "0", "--steps", "2",
            "--batch-size", "2"]
    jax_out = jax_eval.generate(types.SimpleNamespace(**vars(port_eval.parse_args(
        argv + ["--outdir", str(tmp_path / "jax")]))))
    port_out = port_eval.generate(port_eval.parse_args(
        argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]))
    names = sorted(os.listdir(os.path.join(port_out, "seed0", "clock")))
    assert names == ["a_clock_in_the_jungle.png", "a_red_clock.png"]
    assert sorted(os.listdir(os.path.join(jax_out, "seed0", "clock"))) == names
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(d, "seed0", "clock", name)), np.int16)
                for d in (jax_out, port_out))
        assert np.abs(a - b).max() <= 1, name
