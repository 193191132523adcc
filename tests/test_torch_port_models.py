"""textboost_torch models held against the JAX package on the same weights.

The JAX `tiny` preset's weights go through the port's `state_dict_from_jax`
into the port's modules (strict load), then both sides get the same numpy
inputs in fp32 on the CPU: UNet, VAE decode, and CLIP with LoRA, a grown
vocabulary and the null-embedding patch.  The sd15 module key sets are held
against the published manifests, built on the meta device.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.data.tokenizer import HashTokenizer
from textboost_tpu.models.clip import CLIPTextModel as JaxCLIP
from textboost_tpu.models.convert import flax_to_torch_state_dict
from textboost_tpu.models.pretrained import load_models as jax_load_models
from textboost_tpu.models.textboost import apply_null_embedding_patch as jax_patch
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import remap_legacy_vae_keys, state_dict_from_jax
from textboost_torch.models.layers import GroupNorm
from textboost_torch.models.pretrained import build_models, load_models
from textboost_torch.models.textboost import apply_null_embedding_patch

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops; with the suite's other
    processes on every core, torch's thread pool waits on its own threads
    at each op far longer than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_load_models(preset="tiny", lora_rank=4, dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    te, unet, vae = build_models(get_spec("tiny"), lora_rank=4, device="cpu")
    te.load_state_dict(state_dict_from_jax("text_encoder", jax_tiny.te_params), strict=True)
    unet.load_state_dict(state_dict_from_jax("unet", jax_tiny.unet_params), strict=True)
    vae.load_state_dict(state_dict_from_jax("vae", jax_tiny.vae_params), strict=True)
    return te.eval(), unet.eval(), vae.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("kind", ["text_encoder", "unet", "vae"])
def test_state_dict_from_jax_matches_flax_exporter(jax_tiny, kind):
    params = {"text_encoder": jax_tiny.te_params, "unet": jax_tiny.unet_params,
              "vae": jax_tiny.vae_params}[kind]
    got = state_dict_from_jax(kind, params)
    want = flax_to_torch_state_dict(params, kind)
    extra = set(got) - set(want)
    assert set(want) <= set(got)
    # The flax exporter skips LoRA leaves; the port carries them.
    assert all(k.endswith(("lora_A.weight", "lora_B.weight")) for k in extra)
    assert bool(extra) == (kind == "text_encoder")
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    lora_a = np.asarray(params["params"]["layers_0"]["self_attn"]["q_proj"]["lora_a"]) \
        if kind == "text_encoder" else None
    if lora_a is not None:
        key = "text_model.encoder.layers.0.self_attn.q_proj.lora_A.weight"
        np.testing.assert_array_equal(got[key].numpy(), lora_a.T)


def _manifest(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


@pytest.mark.parametrize("index,manifest", [
    (0, "clip_sd15.manifest"), (1, "unet_sd15.manifest"), (2, "vae_sd.manifest"),
])
def test_sd15_state_dict_keys_match_published_manifests(index, manifest):
    module = build_models(get_spec("sd15"), device="meta")[index]
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == _manifest(manifest)


def test_legacy_vae_attention_keys_are_remapped():
    sd = {"decoder.mid_block.attentions.0.query.weight": torch.zeros(8, 8),
          "decoder.mid_block.attentions.0.proj_attn.weight": torch.zeros(8, 8, 1, 1),
          "decoder.conv_in.bias": torch.zeros(8)}
    got = remap_legacy_vae_keys(sd)
    assert set(got) == {"decoder.mid_block.attentions.0.to_q.weight",
                        "decoder.mid_block.attentions.0.to_out.0.weight",
                        "decoder.conv_in.bias"}
    assert got["decoder.mid_block.attentions.0.to_out.0.weight"].shape == (8, 8)


def test_unet_matches_jax(jax_tiny, port_tiny):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 871], np.int32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    want = jax_tiny.unet.apply(jax_tiny.unet_params, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx))
    with torch.no_grad():
        got = port_tiny[1](_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    # fp32, same tolerance as the full-UNet torch oracle (tests/test_torch_oracle.py).
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def test_vae_decode_matches_jax(jax_tiny, port_tiny):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    want = jax_tiny.vae.apply(jax_tiny.vae_params, jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = port_tiny[2].decode(_nchw(z))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def test_clip_with_lora_grown_vocab_and_null_patch_matches_jax(jax_tiny):
    rng = np.random.default_rng(2)
    spec = get_spec("tiny")
    params = {"params": dict(jax_tiny.te_params["params"])}
    emb = np.asarray(params["params"]["token_embedding"])
    new_rows = (rng.standard_normal((2, emb.shape[1])) * 0.02).astype(np.float32)
    params["params"]["token_embedding"] = np.concatenate([emb, new_rows])
    for i in range(spec.text_encoder.num_hidden_layers):
        layer = dict(params["params"][f"layers_{i}"])
        attn = dict(layer["self_attn"])
        for proj in ("q_proj", "k_proj", "v_proj"):
            attn[proj] = dict(attn[proj], lora_b=(rng.standard_normal((4, 64)) * 0.1).astype(np.float32))
        layer["self_attn"] = attn
        params["params"][f"layers_{i}"] = layer
    vocab = emb.shape[0] + 2

    tok = HashTokenizer()
    tok.add_tokens(["<v*>", "<w*>"])
    ids = tok(["photo of a <v*> dog", "", "<w*> on a beach"], return_tensors="np")["input_ids"]
    null = (rng.standard_normal((77, 64)) * 0.5).astype(np.float32)

    jax_te = JaxCLIP(spec.text_encoder, lora_rank=4, dtype=jnp.float32, vocab_size_override=vocab)
    hidden, pooled = jax_te.apply(params, jnp.asarray(ids))
    want = jax_patch(hidden, jnp.asarray(ids), jnp.asarray(null), 49407, True)

    te = CLIPTextModel(spec.text_encoder, lora_rank=4, vocab_size_override=vocab)
    te.load_state_dict(state_dict_from_jax("text_encoder", params), strict=True)
    with torch.no_grad():
        t_ids = torch.from_numpy(ids.astype(np.int64))
        got_hidden, got_pooled = te(t_ids)
        got = apply_null_embedding_patch(got_hidden, t_ids, torch.from_numpy(null), 49407, True)
    # fp32 on both sides.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), atol=1e-4, rtol=1e-4)
    assert np.array_equal(got[1].numpy(), null)  # the empty prompt row is the null embedding


def test_preset_init_is_seeded_and_keeps_group_norm_affine_fp32():
    a = load_models("tiny", lora_rank=4, dtype=torch.bfloat16, device="cpu", seed=3)
    b = load_models("tiny", lora_rank=4, dtype=torch.bfloat16, device="cpu", seed=3)
    for (name, pa), pb in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(pa, pb), name
    norms = [m for m in a.unet.modules() if isinstance(m, GroupNorm)]
    assert norms and all(m.weight.dtype == torch.float32 for m in norms)
    assert a.unet.conv_in.weight.dtype == torch.bfloat16
    q = a.text_encoder.text_model.encoder.layers[0].self_attn.q_proj
    assert torch.count_nonzero(q.lora_B.weight) == 0 and q.lora_A.weight.std() > 0.1
    assert abs(q.weight.float().std().item() - 0.02) < 0.005  # normal(0.02) CLIP kernels


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_models("tiny")
