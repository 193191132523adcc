"""The port's sampling slice as a whole, held against the JAX package.

A model dir written by the JAX package's exporters (PEFT adapter with a
nonzero B, a `<v*>.bin`) is loaded by both `load_textboost_pipeline`s; the
port's base loader serves the JAX `tiny` preset's weights carried over with
`state_dict_from_jax`.  Both sample the same numpy latents (2 steps,
CFG 7.5, fp32, CPU) and the images must agree.  Also: artifacts written by
one package read by the other, the CLI's `generate`, and the device rule.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.lora import peft_io as jax_peft
from textboost_tpu.models.pretrained import load_models as jax_load_models
from textboost_tpu.pipelines.loading import load_textboost_pipeline as jax_load_pipeline
from textboost_tpu.pipelines.text_to_image import to_uint8 as jax_to_uint8
from textboost_torch import inference
from textboost_torch.lora import peft_io
from textboost_torch.lora.partition import lora_parameters
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.pretrained import ModelBundle, build_models, load_models
from textboost_torch.pipelines import loading
from textboost_torch.pipelines.text_to_image import to_uint8


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


def _carried_over(jax_bundle, lora_rank):
    te, unet, vae = build_models(get_spec("tiny"), lora_rank=lora_rank, device="cpu")
    te.load_state_dict(state_dict_from_jax("text_encoder", jax_bundle.te_params), strict=True)
    unet.load_state_dict(state_dict_from_jax("unet", jax_bundle.unet_params), strict=True)
    vae.load_state_dict(state_dict_from_jax("vae", jax_bundle.vae_params), strict=True)
    return ModelBundle(get_spec("tiny"), te, unet, vae)


@pytest.fixture()
def jax_model_dir(tmp_path, jax_tiny):
    rng = np.random.default_rng(0)
    flat = {}
    for name, layer in jax_tiny.te_params["params"].items():
        if name.startswith("layers_"):
            attn = {p: dict(v, lora_b=(rng.standard_normal((4, 64)) * 0.2).astype(np.float32))
                    for p, v in layer["self_attn"].items() if p != "out_proj"}
            flat[name] = {"self_attn": attn}
    jax_peft.export_lora_adapter({"params": flat}, str(tmp_path / "text_encoder"), rank=4)
    vec = (rng.standard_normal((1, 64)) * 0.3).astype(np.float32)
    jax_peft.export_token_embeddings(vec, {"<v*>": 0}, str(tmp_path))
    return str(tmp_path)


def test_port_and_jax_pipelines_agree_on_the_same_model_dir(jax_model_dir, jax_tiny, monkeypatch):
    base = _carried_over(jax_tiny, lora_rank=4)
    monkeypatch.setattr(loading, "load_models", lambda *a, **k: base)
    rng = np.random.default_rng(1)
    latents = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    prompts = ["photo of a <v*> dog", "a <v*> on the beach"]
    kw = dict(num_inference_steps=2, guidance_scale=7.5, latents=latents, output_type="float")

    jax_pipe = jax_load_pipeline(jax_model_dir, "tiny", lora_rank=4, dtype=jnp.float32)
    want = np.asarray(jax_pipe(prompts, **kw))
    port = loading.load_textboost_pipeline(jax_model_dir, "tiny", lora_rank=4,
                                           dtype=torch.float32, device="cpu")
    got = port(prompts, **kw)

    assert got.shape == want.shape == (2, 128, 128, 3)
    assert np.abs(want).max() > 0.05, "degenerate images"
    # fp32 on both sides through 2 CFG-doubled UNet calls and the VAE.
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    u_got = to_uint8(torch.from_numpy(got)).numpy().astype(int)
    assert np.abs(u_got - jax_to_uint8(want).astype(int)).max() <= 1
    # The adapter and the token really were loaded (the patch would hide them otherwise).
    te = port.text_encoder
    assert te.token_embedding.weight.shape[0] == 49409
    assert torch.count_nonzero(te.text_model.encoder.layers[0].self_attn.q_proj.lora_B.weight) > 0


def test_port_artifacts_read_by_the_jax_package(tmp_path, jax_tiny):
    te = load_models("tiny", lora_rank=4, dtype=torch.float32, device="cpu").text_encoder
    with torch.no_grad():
        for layer in te.text_model.encoder.layers:
            layer.self_attn.v_proj.lora_B.weight.normal_(0.0, 0.1)
    peft_io.export_lora_adapter(te, str(tmp_path / "text_encoder"), rank=4)
    merged = jax_peft.import_lora_adapter(jax_tiny.te_params, str(tmp_path / "text_encoder"))
    for i, layer in enumerate(te.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            leaf = merged["params"][f"layers_{i}"]["self_attn"][proj]
            mod = getattr(layer.self_attn, proj)
            np.testing.assert_array_equal(np.asarray(leaf["lora_a"]), mod.lora_A.weight.detach().numpy().T)
            np.testing.assert_array_equal(np.asarray(leaf["lora_b"]), mod.lora_B.weight.detach().numpy().T)
    emb = torch.randn(3, 64)
    paths = peft_io.export_token_embeddings(emb, {"<v*>": 1, "<aug>": 2}, str(tmp_path),
                                            aug_tokens=["<aug>"])
    got = jax_peft.import_token_embeddings(paths)
    np.testing.assert_array_equal(got["<v*>"], emb[1].numpy())
    np.testing.assert_array_equal(got["<aug>"], emb[2].numpy())
    assert sorted(os.path.basename(p) for p in paths) == ["aug.bin", "v*.bin"]


def test_generate_and_main_on_cpu(jax_model_dir, tmp_path):
    out = str(tmp_path / "grid.jpg")
    args = inference.parse_args([jax_model_dir, "--model", "tiny", "--prompt", "photo of a <v*>",
                                 "--seeds", "0", "5", "--steps", "2", "--device", "cpu",
                                 "--output", out])
    images = inference.generate(args)
    assert images.dtype == np.uint8 and images.shape == (2, 128, 128, 3)
    assert not np.array_equal(images[0], images[1])  # one latent per seed
    inference.main(args)
    assert os.path.getsize(out) > 0


def test_unet_adapter_dir_is_loaded(tmp_path):
    """A model dir with a `unet/` adapter (--unet_params_to_train
    crossattn_kv) loads into the UNet's cross-attention LoRA, with the
    adapter's rank, and changes the images."""
    unet = load_models("tiny", unet_lora_rank=2, dtype=torch.float32, device="cpu").unet
    with torch.no_grad():
        for p in lora_parameters(unet):
            p.normal_(0.0, 0.3)
    peft_io.export_unet_lora_adapter(unet, str(tmp_path / "model" / "unet"), rank=2)
    (tmp_path / "base").mkdir()
    pipes = [loading.load_textboost_pipeline(str(tmp_path / name), "tiny", dtype=torch.float32,
                                             device="cpu") for name in ("model", "base")]
    want, got = peft_io.unet_lora_tensors(unet), peft_io.unet_lora_tensors(pipes[0].unet)
    n_cross = sum(name.endswith(".attn2") for name, _ in unet.named_modules())
    assert len(want) == 4 * n_cross and got.keys() == want.keys()  # A/B of to_k and to_v
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert pipes[1].unet.cross_lora_rank == 0
    latents = np.random.default_rng(0).standard_normal((1, 16, 16, 4)).astype(np.float32)
    images = [pipe(["a photo of a dog"], num_inference_steps=2, latents=latents)
              for pipe in pipes]
    assert not np.array_equal(*images)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loading.load_textboost_pipeline(str(tmp_path), "tiny")
    args = inference.parse_args([str(tmp_path), "--model", "tiny"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.generate(args)
