"""The reference's consumers read the port's artifacts (ROADMAP A2).

A port run at `tiny` (with the UNet's cross-attention LoRA and a checkpoint
at each step) writes `text_encoder/`, `checkpoint-N/text_encoder/`, `unet/`
and the `<token>.bin` files.  As the reference's inference reads them
(inference.py:47-77, as tests/test_peft_cross_stack.py holds it for the JAX
package's artifacts): transformers' `CLIPTextModel` built from a
`CLIPTextConfig` of the same shape over the same base weights takes the
token rows from the bins (read with `torch.load`) and the adapter through
`load_adapter`, and its forward equals the port's own pipeline's.  The
`unet/` adapter carries the key names and `adapter_config.json` of the JAX
package's exporter.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from textboost_tpu.lora import peft_io as jax_peft
from textboost_tpu.lora.partition import split_lora
from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
from textboost_torch.lora.peft_io import load_safetensors
from textboost_torch.models.configs import get_spec
from textboost_torch.models.pretrained import load_models
from textboost_torch.pipelines.loading import load_textboost_pipeline
from textboost_torch.train import main as train_main

peft = pytest.importorskip("peft")
SPEC = get_spec("tiny")
SEED = 0  # load_textboost_pipeline seeds a preset base with 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("consumers")
    (root / "instance").mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(
        root / "instance" / "a.png")
    out = str(root / "out")
    train_main(["--device", "cpu", "--model_preset", "tiny", "--instance_data_dir",
                str(root / "instance"), "--output_dir", out, "--placeholder_token", "<v*>",
                "--initializer_token", "dog", "--max_train_steps", "2", "--train_batch_size", "1",
                "--resolution", "64", "--checkpointing_steps", "1", "--learning_rate", "5e-2",
                "--unet_params_to_train", "crossattn_kv", "--report_to", "none",
                "--seed", str(SEED)])
    return out


def _hf_text_encoder():
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = SPEC.text_encoder
    hf = CLIPTextModel(CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        max_position_embeddings=cfg.max_position_embeddings, hidden_act=cfg.hidden_act,
        layer_norm_eps=cfg.layer_norm_eps, eos_token_id=cfg.eos_token_id,
        bos_token_id=cfg.bos_token_id)).eval()
    # The run's base: the tiny preset seeded with the run's --seed and built
    # with the run's LoRA rank (a preset draws each adapter after its weight).
    base = load_models("tiny", lora_rank=4, dtype=torch.float32, device="cpu",
                       seed=SEED).text_encoder
    missing, unexpected = hf.load_state_dict(
        {k: v for k, v in base.state_dict().items() if ".lora_" not in k}, strict=False)
    assert not unexpected and set(missing) <= {"text_model.embeddings.position_ids"}
    return hf


@pytest.mark.parametrize("subdir", ["", "checkpoint-1"])
def test_transformers_reads_the_adapter_and_the_token_bins(run, subdir):
    model_dir = os.path.join(run, subdir)
    blob = torch.load(os.path.join(model_dir, "v*.bin"), map_location="cpu", weights_only=True)
    assert list(blob) == ["<v*>"] and tuple(blob["<v*>"].shape) == (SPEC.text_encoder.hidden_size,)
    hf = _hf_text_encoder()
    hf.resize_token_embeddings(SPEC.text_encoder.vocab_size + 1)
    with torch.no_grad():
        hf.get_input_embeddings().weight[-1] = blob["<v*>"]
    ids = torch.full((2, 77), SPEC.text_encoder.eos_token_id)
    ids[:, 0] = SPEC.text_encoder.bos_token_id
    ids[0, 1:4] = torch.tensor([SPEC.text_encoder.vocab_size, 2000, 3000])  # <v*> first
    ids[1, 1:3] = torch.tensor([4000, SPEC.text_encoder.vocab_size])
    with torch.no_grad():
        base = hf(ids).last_hidden_state
        hf.load_adapter(os.path.join(model_dir, "text_encoder"))
        got = hf(ids).last_hidden_state
    pipe = load_textboost_pipeline(run, "tiny", checkpoint=int(subdir[11:]) if subdir else None,
                                   dtype=torch.float32, device="cpu")
    assert pipe.tokenizer.convert_tokens_to_ids("<v*>") == SPEC.text_encoder.vocab_size
    with torch.no_grad():
        want, _ = pipe.text_encoder(ids)
    assert (got - base).abs().max() > 1e-4  # the adapter matters
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_unet_adapter_has_the_jax_exporters_keys_and_config(run, tmp_path):
    s = SPEC.unet.sample_size
    template = jax.eval_shape(JaxUNet(SPEC.unet, dtype=jnp.float32, cross_lora_rank=4).init,
                              jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))
    _, lora = split_lora(template)
    jax_peft.export_unet_lora_adapter(
        {k: np.zeros(v.shape, np.float32) for k, v in lora.items()}, str(tmp_path / "jax"),
        rank=4, base_model_name="tiny")
    for d in (run, os.path.join(run, "checkpoint-2")):
        port = load_safetensors(os.path.join(d, "unet", "adapter_model.safetensors"))
        jax_keys = load_safetensors(str(tmp_path / "jax" / "adapter_model.safetensors"))
        assert set(port) == set(jax_keys)
        assert all(port[k].shape == jax_keys[k].shape for k in port)
        assert any(np.abs(v).max() > 0 for k, v in port.items() if ".lora_B." in k)
        with open(os.path.join(d, "unet", "adapter_config.json")) as f, \
                open(tmp_path / "jax" / "adapter_config.json") as g:
            assert json.load(f) == json.load(g)
