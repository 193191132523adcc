"""The port's DDIM, DDPM and PNDM samplers, held against the JAX package.

The same numpy latents go through each JAX sampler and its port with a
closed-form fp32 model of (x, t), at both prediction types and 1, 2, 3, 5
and 25 steps; DDPM gets the JAX package's PRNGKey(0) draws injected (torch
cannot make threefry's numbers).  Then one tiny pipeline case per sampler:
the JAX `TextToImagePipeline(sampler=)` and the port's on the same weights
and latents, and the trainer's --validation_scheduler refusal of an
unknown name.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.models.pretrained import load_models as jax_load_models
from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
from textboost_tpu.pipelines.text_to_image import TextToImagePipeline as JaxPipeline
from textboost_tpu.samplers import solvers as jax_solvers
from textboost_torch.data.tokenizer import load_tokenizer
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.pretrained import build_models
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.pipelines.text_to_image import TextToImagePipeline
from textboost_torch.samplers import solvers
from textboost_torch.train import main as train_main

SAMPLERS = ("ddim", "ddpm", "pndm")
PREDICTIONS = ("epsilon", "v_prediction")
STEPS = (1, 2, 3, 5, 25)
SHAPE = (2, 4, 6, 6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_ddpm_noises(shape, steps: int):
    """The draws of the JAX ddpm_sample with its default PRNGKey(0)."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return out


def model_jax(x, t):
    s = (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.6 * x * jnp.cos(3.0 * s) + 0.2 * s + 0.3 * jnp.tanh(x)


def model_torch(x, t):
    s = (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return 0.6 * x * torch.cos(3.0 * s) + 0.2 * s + 0.3 * torch.tanh(x)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_matches_jax(name, prediction, steps):
    x = np.random.default_rng(steps).standard_normal(SHAPE).astype(np.float32)
    calls = {"jax": 0, "torch": 0}

    def counted(fn, key):
        def call(x, t):
            calls[key] += 1
            return fn(x, t)
        return call

    want = np.asarray(jax_solvers.get_sampler(name)(
        counted(model_jax, "jax"), JaxSchedule.create(prediction_type=prediction),
        jnp.asarray(x), steps))
    kw = {"noises": jax_ddpm_noises(SHAPE, steps)} if name == "ddpm" else {}
    got = solvers.get_sampler(name)(
        counted(model_torch, "torch"), NoiseSchedule.create(prediction_type=prediction),
        torch.from_numpy(x), steps, **kw).numpy()
    # The JAX scan traces its body once; the port calls the model per step.
    assert calls["jax"] == 1
    assert calls["torch"] == (steps + 1 if name == "pndm" and steps > 1 else steps)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spacing", ["linspace", "leading"])
def test_timestep_grids_and_registry_match_jax(spacing):
    for steps in (1, 2, 3, 5, 25, 50, 999):
        np.testing.assert_array_equal(solvers.make_timesteps(1000, steps, spacing),
                                      jax_solvers.make_timesteps(1000, steps, spacing))
    for steps in STEPS:  # PNDM: the grid with its warm-up point again
        ts = solvers._pndm_coeffs(NoiseSchedule.create(), steps).timesteps
        leading = jax_solvers.make_timesteps(1000, steps, "leading")
        want = np.concatenate([leading[:1], leading[1:2], leading[1:]]) if steps > 1 else leading
        np.testing.assert_array_equal(ts, want)
    assert {k: v.__name__ for k, v in solvers.SAMPLERS.items()} == {
        k: v.__name__ for k, v in jax_solvers.SAMPLERS.items()}
    with pytest.raises(ValueError, match="Unknown sampler 'euler'"):
        solvers.get_sampler("euler")
    with pytest.raises(ValueError, match="Unknown timestep spacing"):
        solvers.make_timesteps(1000, 5, "trailing")


def test_ddpm_default_noise_is_seeded():
    """Without injected noise DDPM draws from a generator seeded with 0 on
    the latents' device: two calls give the same bits, those of the draws
    of `torch.Generator().manual_seed(0)` injected."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32))
    sched = NoiseSchedule.create()
    a, b = (solvers.ddpm_sample(model_torch, sched, x, 5) for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    gen = torch.Generator().manual_seed(0)
    draws = [torch.randn(SHAPE, generator=gen) for _ in range(5)]
    assert torch.equal(solvers.ddpm_sample(model_torch, sched, x, 5, noises=draws), a)
    assert not torch.equal(solvers.ddpm_sample(model_torch, sched, x, 5, noises=draws[::-1]), a)


@pytest.fixture(scope="module")
def tiny_pipelines():
    bundle = jax_load_models(preset="tiny", dtype=jnp.float32)
    te, unet, vae = build_models(get_spec("tiny"), device="cpu")
    te.load_state_dict(state_dict_from_jax("text_encoder", bundle.te_params), strict=True)
    unet.load_state_dict(state_dict_from_jax("unet", bundle.unet_params), strict=True)
    vae.load_state_dict(state_dict_from_jax("vae", bundle.vae_params), strict=True)
    tok = load_tokenizer(None)
    jax_pipe = JaxPipeline("tiny", tok, bundle.te_params, bundle.unet_params, bundle.vae_params,
                           dtype=jnp.float32)
    port = TextToImagePipeline("tiny", tok, te, unet, vae, device="cpu")
    return jax_pipe, port


@pytest.mark.parametrize("name", SAMPLERS)
def test_tiny_pipeline_matches_jax(tiny_pipelines, monkeypatch, name):
    jax_pipe, port = tiny_pipelines
    latents = np.random.default_rng(3).standard_normal((2, 16, 16, 4)).astype(np.float32)
    prompts = ["a photo of a dog", "a cat on the beach"]
    kw = dict(num_inference_steps=2, guidance_scale=7.5, latents=latents, output_type="float",
              sampler=name)
    want = np.asarray(jax_pipe(prompts, **kw))
    if name == "ddpm":  # the JAX program's PRNGKey(0) draws, NHWC -> NCHW
        noises = [n.transpose(0, 3, 1, 2) for n in jax_ddpm_noises(latents.shape, 2)]
        monkeypatch.setitem(solvers.SAMPLERS, "ddpm",
                            functools.partial(solvers.ddpm_sample, noises=noises))
    got = port(prompts, **kw)
    assert got.shape == want.shape == (2, 128, 128, 3)
    assert np.abs(want).max() > 0.05, "degenerate images"
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_unknown_validation_scheduler_raises_at_setup(tmp_path):
    with pytest.raises(ValueError, match="Unknown sampler 'EulerDiscreteScheduler'"):
        train_main(["--device", "cpu", "--model_preset", "tiny", "--output_dir", str(tmp_path),
                    "--validation_scheduler", "EulerDiscreteScheduler",
                    "--validation_prompts", "a"])
