"""The sd2 family held against the JAX package, on the CPU in fp32.

sd21base differs from sd1 in three places the `tiny` tests do not reach:
a gelu CLIP text encoder, transformer blocks with linear projections
(`use_linear_projection`), and 64-wide attention heads.  A small spec of
that shape (CLIP 2 layers x 128 wide in 64-wide heads; a two-level UNet of
64 and 128 channels in 64-wide heads, transformer blocks at both levels), built the same way on
both sides by `dataclasses.replace` of `tiny`, gets seeded random weights
in the JAX init's tree (its shapes from `jax.eval_shape`, which costs a
fraction of running the init) carried to the port by `state_dict_from_jax`
(strict load): CLIP hidden states with LoRA,
a grown vocabulary and the null-embedding patch, and the UNet's epsilon,
agree at the tiny tests' tolerances.  The sd21base key sets are held
against the published manifests.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.data.tokenizer import HashTokenizer
from textboost_tpu.models import get_spec as jax_get_spec
from textboost_tpu.models.clip import CLIPTextModel as JaxCLIP
from textboost_tpu.models.textboost import apply_null_embedding_patch as jax_patch
from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.pretrained import build_models
from textboost_torch.models.textboost import apply_null_embedding_patch
from textboost_torch.models.unet import UNet2DCondition

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
HIDDEN = 128
TEXT = dict(hidden_size=HIDDEN, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, hidden_act="gelu")
UNET = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
            cross_attention_levels=(True, True), cross_attention_dim=HIDDEN,
            use_linear_projection=True, layers_per_block=1, sample_size=8)


def _specs(part, fields):
    """(JAX config, port config) of `tiny`'s `part` with `fields` replaced."""
    return (dataclasses.replace(getattr(jax_get_spec("tiny"), part), **fields),
            dataclasses.replace(getattr(get_spec("tiny"), part), **fields))


def _random_params(module, rng, *args):
    """Seeded weights in `module.init`'s tree: fan-in-scaled normal kernels
    and embeddings, norm scales near 1, small biases."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if len(leaf.shape) == 1:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name != "embedding" else 50
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_the_small_spec_has_the_sd21base_shape():
    sd2 = get_spec("sd21base")
    _, text = _specs("text_encoder", TEXT)
    _, unet = _specs("unet", UNET)
    assert text.hidden_act == sd2.text_encoder.hidden_act == "gelu"
    assert text.hidden_size // text.num_attention_heads == 64
    assert sd2.text_encoder.hidden_size // sd2.text_encoder.num_attention_heads == 64
    assert unet.use_linear_projection and sd2.unet.use_linear_projection
    for spec in (unet, sd2.unet):
        assert {c // h for c, h in zip(spec.block_out_channels, spec.num_attention_heads)} == {64}
    assert unet.cross_attention_dim == text.hidden_size


def test_gelu_clip_with_lora_grown_vocab_and_null_patch_matches_jax():
    rng = np.random.default_rng(0)
    jcfg, cfg = _specs("text_encoder", TEXT)
    params = _random_params(JaxCLIP(jcfg, lora_rank=4, dtype=jnp.float32), rng,
                            jnp.zeros((1, 77), jnp.int32))
    p = params["params"]
    emb = p["token_embedding"]
    p["token_embedding"] = np.concatenate(
        [emb, (rng.standard_normal((2, HIDDEN)) * 0.02).astype(np.float32)])
    for i in range(cfg.num_hidden_layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            leaf = p[f"layers_{i}"]["self_attn"][proj]
            leaf["lora_b"] = (rng.standard_normal(leaf["lora_b"].shape) * 0.1).astype(np.float32)
    vocab = emb.shape[0] + 2
    tok = HashTokenizer()
    tok.add_tokens(["<v*>", "<w*>"])
    ids = tok(["photo of a <v*> dog", "", "<w*> on a beach"], return_tensors="np")["input_ids"]
    null = (rng.standard_normal((77, HIDDEN)) * 0.5).astype(np.float32)

    jax_te = JaxCLIP(jcfg, lora_rank=4, dtype=jnp.float32, vocab_size_override=vocab)
    hidden, pooled = jax.jit(jax_te.apply)(params, jnp.asarray(ids))
    want = jax_patch(hidden, jnp.asarray(ids), jnp.asarray(null), 49407, True)

    te = CLIPTextModel(cfg, lora_rank=4, vocab_size_override=vocab)
    te.load_state_dict(state_dict_from_jax("text_encoder", params), strict=True)
    with torch.no_grad():
        t_ids = torch.from_numpy(ids.astype(np.int64))
        got_hidden, got_pooled = te(t_ids)
        got = apply_null_embedding_patch(got_hidden, t_ids, torch.from_numpy(null), 49407, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), atol=1e-4, rtol=1e-4)
    # The adapters matter: without them the output moves.
    with torch.no_grad():
        plain, _ = te(t_ids, use_lora=False)
    assert (plain - got_hidden).abs().max() > 1e-3


def test_linear_projection_unet_with_64_wide_heads_matches_jax():
    rng = np.random.default_rng(1)
    jcfg, cfg = _specs("unet", UNET)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 871], np.int32)
    ctx = rng.standard_normal((2, 77, HIDDEN)).astype(np.float32)
    model = JaxUNet(jcfg, dtype=jnp.float32)
    params = _random_params(model, rng, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    want = jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    unet = UNet2DCondition(cfg)
    state = state_dict_from_jax("unet", params)
    # Linear projections: proj_in/proj_out are [out, in] matrices, not 1x1 convs.
    assert state["down_blocks.0.attentions.0.proj_in.weight"].shape == (64, 64)
    unet.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = unet.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                          torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def _manifest(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


@pytest.mark.parametrize("index,manifest", [
    (0, "clip_sd21base.manifest"), (1, "unet_sd21base.manifest"), (2, "vae_sd.manifest"),
])
def test_sd21base_state_dict_keys_match_published_manifests(index, manifest):
    module = build_models(get_spec("sd21base"), device="meta")[index]
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == _manifest(manifest)
