"""The port's train step held against the JAX package's `make_train_step`.

Both packages start from the same `tiny` weights (the JAX init carried over
with `state_dict_from_jax`, with nonzero LoRA B and one added token), take
the same uint8 batch, and draw the same numbers: the port is handed the
noise, timesteps and posterior epsilon that the JAX step draws from its
threefry key.  Three fp32 steps on the CPU; loss, kpl, grad_norm and
added_embedding_norm are compared after each, the LoRA weights and the
added embedding row after the last.  A batch that carries an augmentation
mask takes the masked loss on both sides.  One JAX model and jitted step
serve every test of the file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.lora.partition import make_optimizer as jax_make_optimizer
from textboost_tpu.models import CLIPTextModel as JaxCLIP
from textboost_tpu.models.pretrained import load_models as jax_load_models
from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
from textboost_tpu.train.step import StepConfig as JaxStepConfig
from textboost_tpu.train.step import TextBoostTrainState, make_train_step as jax_make_train_step
from textboost_torch.lora.partition import lr_schedule, make_optimizer, set_trainable
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.pretrained import build_models
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.train.step import StepConfig, TrainState, forward_backward, make_train_step

SPEC = get_spec("tiny")
FIRST_ADDED = 49408
BATCH = 2


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
def jax_side():
    return _jax_side(np.random.default_rng(0))


def _batch(rng, kpl_prompt="text"):
    ids = np.full((BATCH, 77), 49407, np.int32)
    ids[:, 0] = 49406
    ids[:, 1] = [2000, 2001]
    ids[:, 2] = FIRST_ADDED  # the added token trains
    ids[:, 3] = 3000
    prior = np.full((BATCH, 77), 49407, np.int32)
    prior[:, 0] = 49406
    prior[0, 1:4] = [4000, 4001, 4002]
    if kpl_prompt == "text":
        prior[1, 1:3] = [5000, 5001]  # else row 1 is the null prompt (patched)
    return {"pixel_values": rng.integers(0, 256, (BATCH, 128, 128, 3), dtype=np.uint8),
            "input_ids": ids, "prior_input_ids": prior}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_side(rng):
    bundle = jax_load_models("tiny", lora_rank=4, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, bundle.te_params)
    # Nonzero LoRA B, so that A trains from the first step.
    for name, layer in params["params"].items():
        if name.startswith("layers_"):
            for proj in ("q_proj", "k_proj", "v_proj"):
                leaf = layer["self_attn"][proj]
                leaf["lora_b"] = (rng.standard_normal(leaf["lora_b"].shape) * 0.02).astype(np.float32)
    emb = params["params"]["token_embedding"]
    grown = np.concatenate([emb, emb[1234:1235]], axis=0)  # one added token
    te_params = {"params": {**params["params"], "token_embedding": grown}}
    frozen_te = JaxCLIP(SPEC.text_encoder, dtype=jnp.float32)
    null_ids = jnp.full((1, 77), 49407, jnp.int32).at[:, 0].set(49406)
    null_emb = np.asarray(jax.jit(frozen_te.apply)(params, null_ids)[0][0])
    target_norm = float(np.linalg.norm(grown, axis=-1).mean())
    te = JaxCLIP(SPEC.text_encoder, lora_rank=4, dtype=jnp.float32,
                 vocab_size_override=FIRST_ADDED + 1)
    optimizer = jax_make_optimizer(1e-3, 1e-2, te_params, max_grad_norm=1.0)
    step = jax.jit(jax_make_train_step(
        text_encoder_apply=te.apply,
        frozen_text_encoder_apply=frozen_te.apply,
        unet_apply=bundle.unet.apply,
        vae_encode_moments=lambda p, x: bundle.vae.apply(p, x, method="encode_moments"),
        optimizer=optimizer,
        schedule=JaxSchedule.create(),
        config=JaxStepConfig(vae_scaling=SPEC.vae.scaling_factor,
                             first_added_token_id=FIRST_ADDED, kpl_weight=0.1),
        null_embedding=None,
    ))
    te_jnp = jax.tree.map(jnp.asarray, te_params)
    state = TextBoostTrainState(step=jnp.zeros((), jnp.int32), te_params=te_jnp,
                                opt_state=optimizer.init(te_jnp), rng=jax.random.PRNGKey(0))
    frozen = {"unet": bundle.unet_params, "vae": bundle.vae_params, "te": params,
              "embedding_target_norm": jnp.float32(target_norm),
              "null_embedding": jnp.asarray(null_emb)}
    return bundle, params, te_params, null_emb, target_norm, step, state, frozen


def _port_side(bundle, base_params, te_params, null_emb, target_norm):
    te = CLIPTextModel(SPEC.text_encoder, lora_rank=4, vocab_size_override=FIRST_ADDED + 1)
    te.load_state_dict(state_dict_from_jax("text_encoder", te_params))
    frozen_te = CLIPTextModel(SPEC.text_encoder, lora_rank=4)
    frozen_te.load_state_dict(state_dict_from_jax("text_encoder", base_params))
    _, unet, vae = build_models(SPEC, device="cpu")
    unet.load_state_dict(state_dict_from_jax("unet", bundle.unet_params))
    vae.load_state_dict(state_dict_from_jax("vae", bundle.vae_params))
    for mod in (te, frozen_te, unet, vae):
        mod.requires_grad_(False)
    set_trainable(te)
    optimizer = make_optimizer(te, 1e-3, 1e-2)
    emb = te.token_embedding.weight.detach()
    state = TrainState(
        text_encoder=te, frozen_text_encoder=frozen_te, unet=unet, vae=vae,
        optimizer=optimizer, lr_scheduler=lr_schedule(optimizer, "constant", 0, 3),
        schedule=NoiseSchedule.create(), null_embedding=torch.from_numpy(null_emb.copy()),
        target_norm=torch.tensor(target_norm), original_rows=emb[:FIRST_ADDED].clone(),
    )
    return make_train_step(port_step_config()), state


def port_step_config(**kwargs):
    return StepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                      kpl_weight=0.1, max_grad_norm=1.0, **kwargs)


def _jax_draws(state):
    """The numbers the JAX step draws from state.rng (step.py:200-221)."""
    _, r_noise, r_t, r_vae = jax.random.split(state.rng, 4)
    shape = (BATCH, 16, 16, 4)
    nchw = lambda x: torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()
    return {
        "noise": nchw(jax.random.normal(r_noise, shape, jnp.float32)),
        "timesteps": torch.tensor(np.asarray(jax.random.randint(r_t, (BATCH,), 0, 1000)), dtype=torch.long),
        "vae_eps": nchw(jax.random.normal(r_vae, shape, jnp.float32)),
    }


@pytest.mark.parametrize("kpl_prompt", ["text", "null"])
def test_port_step_matches_jax_make_train_step(jax_side, kpl_prompt):
    bundle, base, te_params, null_emb, target_norm, jax_step, jstate, frozen = jax_side
    port_step, pstate = _port_side(bundle, base, te_params, null_emb, target_norm)
    batch = _batch(np.random.default_rng(1), kpl_prompt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = _to_torch(batch)

    for i in range(3):
        draws = _jax_draws(jstate)
        jstate, jm = jax_step(jstate, jbatch, frozen)
        pm = port_step(pstate, tbatch, draws)
        for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss"):
            # fp32 on both sides through a 2-layer CLIP, the tiny UNet and VAE:
            # the sums differ in order only.
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        assert float(pm["prior_loss"]) == float(jm["prior_loss"]) == 0.0

    te = pstate.text_encoder
    jp = jstate.te_params["params"]
    emb = te.token_embedding.weight.detach().numpy()
    # Original rows are pinned exactly on both sides.
    assert np.array_equal(emb[:FIRST_ADDED], np.asarray(jp["token_embedding"])[:FIRST_ADDED])
    # The added row moved (emb lr 1e-2, renormalised) and agrees.
    assert np.abs(emb[FIRST_ADDED] - te_params["params"]["token_embedding"][FIRST_ADDED]).max() > 1e-3
    np.testing.assert_allclose(emb[FIRST_ADDED], np.asarray(jp["token_embedding"])[FIRST_ADDED],
                               rtol=0, atol=2e-5)
    # LoRA after 3 AdamW steps at lr 1e-3: each step moves a weight by up to
    # ~1e-3; 2e-5 allows the first-step sign of near-zero gradients to differ.
    for i, layer in enumerate(te.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            mod = getattr(layer.self_attn, proj)
            leaf = jp[f"layers_{i}"]["self_attn"][proj]
            np.testing.assert_allclose(mod.lora_A.weight.detach().numpy(),
                                       np.asarray(leaf["lora_a"]).T, rtol=0, atol=2e-5)
            np.testing.assert_allclose(mod.lora_B.weight.detach().numpy(),
                                       np.asarray(leaf["lora_b"]).T, rtol=0, atol=2e-5)


def test_masked_loss_matches_jax(jax_side):
    """A hand-built batch with a per-sample mask [B, h, w, 1] at the latent
    resolution (what TextBoostDataset.collate stacks when the augmentation
    returns one) takes the JAX step's masked mean (step.py:159-167)."""
    bundle, base, te_params, null_emb, target_norm, jax_step, jstate, frozen = jax_side
    port_step, pstate = _port_side(bundle, base, te_params, null_emb, target_norm)
    rng = np.random.default_rng(2)
    batch = _batch(rng)
    mask = np.zeros((BATCH, 16, 16, 1), np.float32)
    mask[0, 2:12, 4:14] = 1.0
    mask[1] = rng.random((16, 16, 1)) < 0.3
    batch["mask"] = mask
    draws = _jax_draws(jstate)
    _, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, frozen)
    pm = port_step(pstate, _to_torch(batch), draws)
    for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-4, atol=1e-6,
                                   err_msg=key)
    # The mask changes the loss: the masked branch really ran.
    _, fresh = _port_side(bundle, base, te_params, null_emb, target_norm)
    unmasked, _ = forward_backward(fresh, port_step_config(), _to_torch(
        {k: v for k, v in batch.items() if k != "mask"}), draws)
    assert abs(float(pm["loss"]) - float(unmasked)) > 1e-3


def test_accumulation_averages_micro_batches(jax_side):
    """With --gradient_accumulation_steps 2, two identical micro-batches
    update the weights once, exactly as one step of accumulation 1 does
    (optax MultiSteps semantics: the mean of the micro-batch gradients)."""
    rng = np.random.default_rng(1)
    bundle, base, te_params, null_emb, _, _, _, _ = jax_side
    ids = np.full((BATCH, 77), 49407, np.int64)
    ids[:, 0], ids[:, 1] = 49406, 2000
    prior = ids.copy()
    ids[:, 2] = FIRST_ADDED
    batch = {"pixel_values": torch.from_numpy(rng.integers(0, 256, (BATCH, 128, 128, 3),
                                                           dtype=np.uint8)),
             "input_ids": torch.from_numpy(ids), "prior_input_ids": torch.from_numpy(prior)}
    gen = torch.Generator().manual_seed(0)
    draws = {"noise": torch.randn(BATCH, 4, 16, 16, generator=gen),
             "vae_eps": torch.randn(BATCH, 4, 16, 16, generator=gen),
             "timesteps": torch.tensor([100, 700])}
    results = []
    for accum in (1, 2):
        _, state = _port_side(bundle, base, te_params, null_emb, 1e3)  # renorm inactive
        step = make_train_step(port_step_config(accumulate_steps=accum))
        before = state.text_encoder.token_embedding.weight.detach().clone()
        for i in range(accum):
            step(state, batch, draws)
            if i < accum - 1:  # no update before the last micro-batch
                assert torch.equal(state.text_encoder.token_embedding.weight, before)
        results.append([p.detach().clone() for p in state.text_encoder.parameters()])
    for a, b in zip(*results):
        # The mean of two equal fp32 gradients is the gradient, up to rounding.
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
