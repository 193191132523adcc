"""The port's CUDA graphs of the train step and the sampling trajectory
(textboost_torch/graphs.py, textboost_torch/train/graph.py), held against
the JAX package's compiled step and sampler (textboost_tpu/train/aot.py,
build_sample_program).

Capture needs CUDA, so on the CPU the same static-buffer code runs through
`EagerGraph`, a stand-in with the graph's interface that runs the recorded
function at each replay: the step from static buffers equals the plain
step bit for bit and the JAX step within tests/test_torch_port_train_step.
py's tolerance; the whole trajectory (encode -> sampler -> decode) matches
the JAX `build_sample_program` under jax.jit for the four samplers.  Then
the envelope and the validation signature against aot.py's, where the
validation rounds' sampling is captured, DDPM's noise drawn before its loop, the tensor learning rate's schedule and its
checkpoint, the launch counters' arithmetic, the schedule's device table,
and a failed capture raising.  The `cuda` cases run on the card only (this
file imports JAX inside the tests that need it, so the card, which has no
JAX, collects it): five captured steps against five eager ones, and
sampler replays against the eager call, bit for bit.
"""
import collections
import types

import numpy as np
import pytest
import torch
from PIL import Image

from textboost_torch.lora.partition import (
    LORA_LABEL,
    lora_parameters,
    lr_lambda,
    lr_schedule,
    param_labels,
    set_trainable,
)
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.ops import flash_attention as fa
from textboost_torch.ops import group_norm as gn
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.samplers import solvers
from textboost_torch import graphs
from textboost_torch.train import checkpoint, graph
from textboost_torch.train.config import TrainConfig, parse_args

FIRST_ADDED = 49408
SCHEDULERS = ("constant", "constant_with_warmup", "linear", "cosine")
# build_sample_program against the port's trajectory, as
# tests/test_torch_port_samplers.py::test_tiny_pipeline_matches_jax holds
# the whole pipeline: fp32 at tiny, two steps, images in [-1, 1].
TRAJECTORY_ATOL = 2e-3
# The step's metrics against the JAX step's, as tests/test_torch_port_train_
# step.py holds them: fp32 on both sides, sums in another order.
STEP_RTOL, STEP_ATOL = 2e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops; with the suite's other
    processes on every core, torch's thread pool waits on its own threads
    at each op far longer than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class EagerGraph:
    """graphs.Graph's interface on the CPU: `capture` records the function
    and runs nothing, `replay` runs it eagerly."""

    def __init__(self):
        self.fn, self.captures, self.replays = None, 0, 0

    def run_eager(self, fn):
        return fn()

    def capture(self, fn):
        self.fn, self.captures = fn, self.captures + 1

    def replay(self):
        self.replays += 1
        return self.fn()

    def stats(self):
        return {"replays": self.replays}


# -- the envelopes and the validation signature against aot.py ---------------
ENVELOPE_CASES = {
    # name: (config kwargs, device, world, torch.distributed backend)
    "inside": ({}, "cuda", 1, None),
    "kv_lora": ({"unet_params_to_train": "crossattn_kv"}, "cuda", 1, None),
    "image_prior": ({"with_image_prior": True, "class_data_dir": "/tmp/c",
                     "class_token": "dog"}, "cuda", 1, None),
    "tp_2": ({"mesh_tp": 2}, "cuda", 1, None),
    "accumulation_2": ({"gradient_accumulation_steps": 2}, "cuda", 1, None),
    "cpu": ({}, "cpu", 1, None),
    "world_2": ({}, "cuda", 2, "nccl"),
    "nccl_world_1": ({}, "cuda", 1, "nccl"),
    "gloo_world_1": ({}, "cuda", 1, "gloo"),
}
# Where the step is captured: where the JAX trainer jits it (every config),
# less tensor parallelism, more than one process, gloo and a device other
# than CUDA.
CAPTURED_CASES = {"inside", "kv_lora", "image_prior", "accumulation_2", "nccl_world_1"}
# Where aot.py compiles ahead of time and keeps its memo.
MEMO_CASES = {"inside", "cpu", "nccl_world_1", "gloo_world_1"}


def _config_kwargs(**kw):
    return dict(instance_data_dir="/tmp/x", instance_token="<x>", initializer_token="dog",
                output_dir="/tmp/out", model_preset="tiny", **kw)


@pytest.mark.parametrize("case", sorted(ENVELOPE_CASES))
def test_envelope_matches_launch_step_aot(case, monkeypatch):
    """The memo's envelope (`envelope_reason`) is `launch_step_aot`'s gate
    (aot.py:132-141) over tests/test_aot.py's cases and 2 processes; the
    compile itself is stubbed.  The memo serves every device (aot.py with
    allow_cpu), and a launch at world 1 is one JAX process; the port keeps
    the memo out of any torch.distributed launch besides."""
    import jax

    from textboost_tpu.models import get_spec as jax_get_spec
    from textboost_tpu.parallel.mesh import make_mesh
    from textboost_tpu.train import aot
    from textboost_tpu.train.config import TrainConfig as JaxTrainConfig

    kw, _, world, backend = ENVELOPE_CASES[case]
    monkeypatch.setattr(aot, "_AOT_MEMO", {})
    monkeypatch.setattr(aot, "_compile_step", lambda *a, **k: "compiled")
    monkeypatch.setattr(jax, "process_count", lambda: world)
    holder = aot.launch_step_aot(
        JaxTrainConfig(**_config_kwargs(**kw)), jax_get_spec("tiny"), vocab_size=1000,
        first_added_id=999, mesh=make_mesh(dp=1, tp=1, devices=jax.devices()[:1]), dtype=None,
        allow_cpu=True)
    cfg = TrainConfig(**_config_kwargs(**kw))
    reason = graph.envelope_reason(cfg, world)
    assert (reason is None) == (holder is not None)
    assert (reason is None) == (case in MEMO_CASES)
    launched = graph.envelope_reason(cfg, world, distributed=backend is not None)
    assert (launched is None) == (case in MEMO_CASES and backend is None)


@pytest.mark.parametrize("case", sorted(ENVELOPE_CASES))
def test_capture_envelope_admits_what_one_card_holds(case):
    """The step is captured where the JAX trainer jits it (trainer.py:728,
    every config: the UNet's LoRA, the image prior, accumulation, an NCCL
    launch at world 1) and refused under tp, across processes, over gloo
    and on the CPU, each with its reason."""
    kw, device, world, backend = ENVELOPE_CASES[case]
    reason = graph.eager_reason(TrainConfig(**_config_kwargs(**kw)), torch.device(device), world,
                                backend)
    assert (reason is None) == (case in CAPTURED_CASES), reason
    want = {"tp_2": "--mesh_tp 2", "cpu": "the device is cpu", "world_2": "2 processes",
            "gloo_world_1": "the gloo backend"}
    if case in want:
        assert reason.startswith(want[case])


def test_eager_reasons_name_the_cause():
    cfg = TrainConfig(**_config_kwargs())
    kv = TrainConfig(**_config_kwargs(unet_params_to_train="crossattn_kv"))
    cuda = torch.device("cuda")
    assert graph.envelope_reason(cfg, 1, distributed=True).startswith("a torch.distributed")
    assert graph.envelope_reason(kv) == "--unet_params_to_train crossattn_kv"
    assert graph.eager_reason(kv, cuda) is None
    assert graph.eager_reason(cfg, cuda, 1, backend="nccl") is None
    assert graph.eager_reason(cfg, cuda, 1, backend="gloo").startswith("the gloo backend")
    assert "check on two cards" in graph.eager_reason(cfg, cuda, 2, backend="nccl")
    # The tp reason comes first: a tp rank is in a launch of 2 processes over gloo.
    assert "--mesh_tp 2" == graph.eager_reason(TrainConfig(**_config_kwargs(mesh_tp=2)), cuda,
                                               2, backend="gloo")
    graphs.set_capture(False)
    try:
        assert "set_capture(False)" in graph.eager_reason(cfg, cuda)
        assert "set_capture(False)" in graph.eager_reason(kv, cuda, 1, backend="nccl")
    finally:
        graphs.set_capture(True)
    assert graph.eager_reason(cfg, cuda) is None


@pytest.mark.parametrize("kw", [
    {"validation_prompts": ["a", "b", "c", "d"], "validation_steps": 5},
    {"validation_prompts": ["a"], "validation_steps": 2, "num_validation_images": 1,
     "validation_scheduler": "PNDMScheduler"},
    {"validation_prompts": ["a", "b"], "validation_steps": 3, "num_validation_images": 0},
    {"validation_prompts": ["a"], "validation_steps": 0},
    {"validation_steps": 5},
])
@pytest.mark.parametrize("preset", ["tiny", "sd21base"])
def test_validation_signature_matches_jax(kw, preset):
    from textboost_tpu.models import get_spec as jax_get_spec
    from textboost_tpu.train import aot
    from textboost_tpu.train.config import TrainConfig as JaxTrainConfig

    want = aot.validation_signature(JaxTrainConfig(**_config_kwargs(**kw)), jax_get_spec(preset))
    assert graph.validation_signature(TrainConfig(**_config_kwargs(**kw)),
                                      get_spec(preset)) == want


def test_validation_rounds_left():
    """One round at every multiple of --validation_steps up to
    --max_train_steps, those past a resume's start step."""
    cfg = TrainConfig(**_config_kwargs(validation_prompts=["a"], validation_steps=50,
                                       max_train_steps=250))
    assert graph.validation_rounds(cfg) == 5
    assert graph.validation_rounds(cfg, start_step=100) == 3
    assert graph.validation_rounds(cfg, start_step=120) == 3
    assert graph.validation_rounds(TrainConfig(**_config_kwargs(validation_steps=50))) == 0


VALIDATION_CASES = {
    # name: (config kwargs, device, world, torch.distributed backend, rounds, captured)
    "inside_enough_rounds": ({}, "cuda", 1, None, 6, True),
    "inside_too_few_rounds": ({}, "cuda", 1, None, 5, False),
    "tp_2": ({"mesh_tp": 2}, "cuda", 1, None, 100, False),
    "distributed": ({}, "cuda", 1, "gloo", 100, False),
    "world_2": ({}, "cuda", 2, "nccl", 100, False),
    "cpu": ({}, "cpu", 1, None, 100, False),
    "nccl_world_1": ({}, "cuda", 1, "nccl", 100, True),
    "kv_lora_prior": ({"unet_params_to_train": "crossattn_kv", "with_image_prior": True,
                       "class_data_dir": "/tmp/c", "class_token": "dog"},
                      "cuda", 1, None, 100, True),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_capture_follows_the_step_envelope(case, monkeypatch):
    """The validation rounds' sampling is captured only inside the step's
    envelope (a tp-sharded UNet reduces over the host in its forward) and
    only over enough rounds to pay the capture back; the reason names the
    cause."""
    monkeypatch.setattr(graphs, "VALIDATION_CAPTURE_ROUNDS", 6)
    kw, device, world, backend, rounds, captured = VALIDATION_CASES[case]
    cfg = TrainConfig(**_config_kwargs(**kw))
    step_reason = graph.eager_reason(cfg, torch.device(device), world, backend)
    reason = graph.validation_eager_reason(cfg, step_reason, rounds)
    assert (reason is None) == captured
    if step_reason is not None:
        assert reason == step_reason
    elif not captured:
        assert f"{rounds} validation rounds" in reason


@pytest.mark.parametrize("case", ["tp_2", "inside_too_few_rounds", "inside_enough_rounds"])
def test_trainer_gives_its_validation_pipe_a_graph_only_where_allowed(case, monkeypatch):
    """The trainer's validation pipe holds a sampler graph over its one
    signature (aot.py's validation signature and the guidance scale) where
    `validation_eager_reason` allows, and none under tp: the pipe then
    samples eagerly at every round."""
    from textboost_torch.train import trainer as trainer_mod

    class Pipe:
        def __init__(self, *a, **k):
            self.graphs = None

    monkeypatch.setattr(trainer_mod, "TextToImagePipeline", Pipe)
    monkeypatch.setattr(graphs, "VALIDATION_CAPTURE_ROUNDS", 6)
    steps = {"inside_too_few_rounds": 10}.get(case, 30)
    cfg = TrainConfig(**_config_kwargs(validation_prompts=["a", "b"], validation_steps=5,
                                       max_train_steps=steps,
                                       mesh_tp=2 if case == "tp_2" else 1))
    stub = types.SimpleNamespace(
        config=cfg, eager_reason=graph.eager_reason(cfg, torch.device("cuda")), start_step=0,
        bundle=types.SimpleNamespace(spec=get_spec("tiny"), unet=None, vae=None),
        tokenizer=None, text_encoder=None, null_embedding=None, device=torch.device("cuda"),
        _val_pipe=None, validation_eager_reason=None)
    stub._validation_key = lambda: trainer_mod.Trainer._validation_key(stub)
    pipe = trainer_mod.Trainer._validation_pipe(stub)
    assert trainer_mod.Trainer._validation_pipe(stub) is pipe
    if case == "inside_enough_rounds":
        assert stub.validation_eager_reason is None
        assert isinstance(pipe.graphs, graphs.CapturedSampler)
        res = get_spec("tiny").resolution
        key = (2 * cfg.num_validation_images, res, res, 25, True, cfg.validation_scheduler, 7.5)
        assert stub._validation_key() == key and pipe.graphs.signatures == {key}
    else:
        assert pipe.graphs is None
        want = "--mesh_tp 2" if case == "tp_2" else "2 validation rounds"
        assert want in stub.validation_eager_reason


def test_sampler_runs_the_signatures_it_was_not_given_eagerly():
    """A CapturedSampler captures only the signatures its caller named (at
    most MAX_SIGNATURES, as aot.py's memo); any other runs the function
    eagerly and keeps nothing."""
    with pytest.raises(ValueError, match="at most"):
        graphs.CapturedSampler([(n,) for n in range(graphs.MAX_SIGNATURES + 1)])
    sampler = graphs.CapturedSampler([("validation",)])
    calls = []

    def fn(inputs):
        calls.append(inputs["x"])
        return inputs["x"] * 2

    x = torch.ones(3)
    for _ in range(3):
        assert torch.equal(sampler(("other",), None, fn, {"x": x}), x * 2)
    assert len(calls) == 3 and sampler.entries == {} and sampler.stats() == {}


# -- the step from static buffers --------------------------------------------
@pytest.fixture(scope="module")
def jax_step_side():
    import test_torch_port_train_step as ts

    return ts, ts._jax_side(np.random.default_rng(0))


def test_static_buffer_step_equals_plain_step_and_jax(jax_step_side):
    """Four steps through CapturedStep (one eager warm-up, the capture, two
    replays from the static buffers) equal four plain steps from the same
    state bit for bit, the batch and the draws changing every step, and
    hold the JAX step's metrics; the schedule and the micro-step count move
    after every replay."""
    import jax.numpy as jnp

    ts, (bundle, base, te_params, null_emb, target_norm, jax_step, jstate, frozen) = jax_step_side
    plain_step, plain = ts._port_side(bundle, base, te_params, null_emb, target_norm)
    step, state = ts._port_side(bundle, base, te_params, null_emb, target_norm)
    fake = EagerGraph()
    held = graph.CapturedStep(step, "cpu", warmup=1, new_graph=lambda: fake)
    for i in range(4):
        batch = ts._batch(np.random.default_rng(10 + i))
        draws = ts._jax_draws(jstate)
        jstate, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, frozen)
        want = plain_step(plain, ts._to_torch(batch), draws)
        got = held(state, ts._to_torch(batch), draws)
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
        for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss"):
            np.testing.assert_allclose(float(got[key]), float(jm[key]), rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=f"step {i} {key}")
        assert state.step == plain.step == i + 1
        assert state.lr_scheduler.last_epoch == plain.lr_scheduler.last_epoch == i + 1
    assert (fake.captures, fake.replays, held.eager_steps) == (1, 3, 1)
    for a, b in zip(state.text_encoder.parameters(), plain.text_encoder.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(state.optimizer.state.values(), plain.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_captured_step_refuses_other_shapes():
    class Step:
        def __call__(self, state, batch, draws):
            return {}

        def body(self, state, batch, draws):
            return {"loss": batch["x"].sum()}

        def finish(self, state):
            pass

    held = graph.CapturedStep(Step(), "cpu", warmup=0, new_graph=EagerGraph)
    held(None, {"x": torch.ones(2)}, {"n": torch.zeros(1)})
    with pytest.raises(ValueError, match="captured at"):
        held(None, {"x": torch.ones(3)}, {"n": torch.zeros(1)})
    with pytest.raises(ValueError, match="not the captured"):
        held(None, {"x": torch.ones(2), "mask": torch.ones(2)}, {"n": torch.zeros(1)})


def test_failed_capture_raises():
    """Inside the envelope nothing falls back: a capture that fails raises,
    after the warm-up steps ran eagerly."""

    class Failing(EagerGraph):
        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    calls = collections.Counter()

    class Step:
        def __call__(self, state, batch, draws):
            calls["eager"] += 1
            return {}

        def body(self, state, batch, draws):
            calls["body"] += 1
            return {}

        def finish(self, state):
            calls["finish"] += 1

    held = graph.CapturedStep(Step(), "cpu", warmup=2, new_graph=Failing)
    for _ in range(2):
        held(None, {"x": torch.ones(1)}, {})
    with pytest.raises(RuntimeError, match="does not fall back") as err:
        held(None, {"x": torch.ones(1)}, {})
    assert "operation not permitted" in str(err.value.__cause__)
    assert calls == {"eager": 2}
    assert not held.captured


# -- the sampling trajectory against build_sample_program --------------------
def _jax_ddpm_noises(shape, steps):
    """The draws of the JAX ddpm_sample with its default PRNGKey(0)."""
    import jax
    import jax.numpy as jnp

    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def tiny_trajectories():
    import jax.numpy as jnp

    from textboost_tpu.models.pretrained import load_models as jax_load_models
    from textboost_tpu.pipelines.text_to_image import TextToImagePipeline as JaxPipeline
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.models.convert import state_dict_from_jax
    from textboost_torch.models.pretrained import build_models
    from textboost_torch.pipelines.text_to_image import TextToImagePipeline

    bundle = jax_load_models(preset="tiny", dtype=jnp.float32)
    te, unet, vae = build_models(get_spec("tiny"), device="cpu")
    te.load_state_dict(state_dict_from_jax("text_encoder", bundle.te_params), strict=True)
    unet.load_state_dict(state_dict_from_jax("unet", bundle.unet_params), strict=True)
    vae.load_state_dict(state_dict_from_jax("vae", bundle.vae_params), strict=True)
    tok = load_tokenizer(None)
    port = TextToImagePipeline("tiny", tok, te, unet, vae, device="cpu")
    null = port.compute_null_embedding("")
    # The validation pipeline's configuration: the null patch, fixed BOS.
    port = TextToImagePipeline("tiny", tok, te, unet, vae, device="cpu",
                               null_embedding=null, fixed_special=True)
    jax_pipe = JaxPipeline("tiny", tok, bundle.te_params, bundle.unet_params, bundle.vae_params,
                           null_embedding=null, fixed_special=True, dtype=jnp.float32)
    return jax_pipe, port


@pytest.mark.parametrize("name", ["dpm++2m", "ddim", "pndm", "ddpm"])
def test_trajectory_matches_build_sample_program(tiny_trajectories, name):
    """encode -> sampler -> decode on the same ids, negative ids, latents and
    guidance: the port's `trajectory` (the function its sampler graph
    captures) against the JAX program under jax.jit, DDPM with the JAX
    program's PRNGKey(0) draws injected."""
    import jax
    import jax.numpy as jnp

    from textboost_tpu.pipelines.text_to_image import build_sample_program

    jax_pipe, port = tiny_trajectories
    assert port.graphs is None  # a pipeline samples eagerly unless its caller gives it graphs
    steps = 2
    prompts = ["a photo of a dog", "a cat on the beach"]
    ids = port.encode_prompts(prompts)
    neg_ids = port.encode_prompts(["", ""])
    latents = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    program = jax.jit(build_sample_program(
        jax_pipe.spec, jax_pipe.text_encoder, jax_pipe.unet, jax_pipe.vae, jax_pipe.schedule,
        steps=steps, do_cfg=True, sampler_name=name, fixed_special=True))
    want = np.asarray(program(jax_pipe.te_params, jax_pipe.unet_params, jax_pipe.vae_params,
                              jnp.asarray(ids, jnp.int32), jnp.asarray(neg_ids, jnp.int32),
                              jnp.asarray(latents), jnp.float32(7.5), jax_pipe.null_embedding))
    noises = (torch.from_numpy(_jax_ddpm_noises(latents.shape, steps)).permute(0, 1, 4, 2, 3)
              .contiguous() if name == "ddpm" else None)
    with torch.inference_mode():
        images = port.trajectory(
            torch.from_numpy(ids), torch.from_numpy(neg_ids),
            torch.from_numpy(latents).permute(0, 3, 1, 2).contiguous(), torch.tensor(7.5),
            steps=steps, sample=solvers.get_sampler(name), noises=noises)
    got = images.clamp(-1.0, 1.0).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 128, 128, 3)
    assert np.abs(want).max() > 0.05, "degenerate images"
    np.testing.assert_allclose(got, want, atol=TRAJECTORY_ATOL, rtol=0)


def test_ddpm_predrawn_noises_equal_in_loop_draws():
    """DDPM's noise drawn before the loop is the in-loop draws of a
    generator seeded with 0, in order; a trajectory given them equals one
    that draws its own, and the other samplers draw none."""
    shape = (2, 4, 6, 6)
    gen = torch.Generator().manual_seed(0)
    in_loop = [torch.randn(shape, generator=gen) for _ in range(5)]
    drawn = solvers.ddpm_noises(shape, 5, "cpu")
    assert drawn.shape == (5, *shape)
    assert all(torch.equal(a, b) for a, b in zip(drawn, in_loop))
    assert torch.equal(solvers.predrawn_noises(solvers.ddpm_sample, shape, 5, "cpu"), drawn)
    for name in ("dpm++2m", "ddim", "pndm"):
        assert solvers.predrawn_noises(solvers.get_sampler(name), shape, 5, "cpu") is None

    def model(x, t):
        return 0.3 * torch.tanh(x) + (t.float() / 1000.0).reshape(-1, 1, 1, 1)

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    sched = NoiseSchedule.create()
    own = solvers.ddpm_sample(model, sched, x, 5)
    assert torch.equal(solvers.ddpm_sample(model, sched, x, 5, noises=drawn), own)
    assert torch.equal(solvers.ddpm_sample(model, sched, x, 5, noises=in_loop), own)


# -- the tensor learning rate ---------------------------------------------------
def _tensor_lr_run(name, spec):
    """A tiny text encoder and the optimizer `make_optimizer` builds on a
    card, here on the CPU: each group's lr a 0-dim tensor, its float base
    in `initial_lr` (foreach off: a CPU AdamW takes a tensor lr only so)."""
    torch.manual_seed(0)
    te = CLIPTextModel(spec.text_encoder, lora_rank=4, vocab_size_override=FIRST_ADDED + 2)
    set_trainable(te)
    groups = [{"params": [te.token_embedding.weight], "lr": torch.tensor(1e-2),
               "initial_lr": 1e-2},
              {"params": lora_parameters(te), "lr": torch.tensor(1e-3), "initial_lr": 1e-3}]
    opt = torch.optim.AdamW(groups, weight_decay=1e-2, foreach=False)
    return te, opt, lr_schedule(opt, name, 3, 10)


def _fake_update(te, opt, sched, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in [te.token_embedding.weight] + lora_parameters(te):
        p.grad = torch.randn(p.shape, generator=gen) * 1e-2
    te.token_embedding.weight.grad[:FIRST_ADDED] = 0.0
    opt.step()
    sched.step()


@pytest.mark.parametrize("name", SCHEDULERS)
def test_tensor_lr_schedule_and_checkpoint(name, tmp_path):
    """The rate tensors follow lr_lambda over 10 updates, written in place
    (the same tensor objects throughout); a checkpoint keeps floats, and
    restores into tensor rates in place, from a tensor-rate run and from a
    float-rate one (the CPU optimizer's, as the parent commit wrote)."""
    spec = get_spec("tiny")
    fn = lr_lambda(name, 3, 10)
    te, opt, sched = _tensor_lr_run(name, spec)
    rates = [g["lr"] for g in opt.param_groups]
    for count in range(10):
        assert all(g["lr"] is r for g, r in zip(opt.param_groups, rates))
        assert [float(r) for r in rates] == [float(np.float32(base * fn(count)))
                                            for base in (1e-2, 1e-3)], count
        if count == 5:
            payload = checkpoint.snapshot(te, opt, sched, torch.Generator().manual_seed(1),
                                          step=5, micro_step=5, first_added_id=FIRST_ADDED)
            checkpoint.write_checkpoint(str(tmp_path / "checkpoint-5"), payload,
                                        first_added_id=FIRST_ADDED, token_to_id={},
                                        aug_tokens=[], lora_rank=4, base_model_name="tiny")
        _fake_update(te, opt, sched, count)
    for group in payload["optimizer"]["param_groups"]:
        assert isinstance(group["lr"], float) and isinstance(group["initial_lr"], float)
    assert all(isinstance(v, float) for v in payload["lr_scheduler"]["_last_lr"]
               + payload["lr_scheduler"]["base_lrs"])

    # Restore into a fresh tensor-rate run and carry it on to step 10.
    te2, opt2, sched2 = _tensor_lr_run(name, spec)
    rates2 = [g["lr"] for g in opt2.param_groups]
    checkpoint.restore_checkpoint(str(tmp_path / "checkpoint-5"), te2, opt2, sched2,
                                  torch.Generator(), FIRST_ADDED)
    assert all(g["lr"] is r for g, r in zip(opt2.param_groups, rates2))
    assert [float(r) for r in rates2] == [float(np.float32(b * fn(5))) for b in (1e-2, 1e-3)]
    for count in range(5, 10):
        _fake_update(te2, opt2, sched2, count)
    assert [float(r) for r in rates2] == [float(r) for r in rates]
    assert sched2.last_epoch == sched.last_epoch == 10
    labels = param_labels(te)
    for (name_, a), b in zip(te.named_parameters(), te2.parameters()):
        if labels[name_] == LORA_LABEL:
            assert torch.equal(a, b), name_
    assert torch.equal(te.token_embedding.weight[FIRST_ADDED:], te2.token_embedding.weight[FIRST_ADDED:])

    # A float-rate checkpoint (the CPU optimizer's) restores into tensor rates.
    te3 = CLIPTextModel(spec.text_encoder, lora_rank=4, vocab_size_override=FIRST_ADDED + 2)
    set_trainable(te3)
    opt3 = torch.optim.AdamW([{"params": [te3.token_embedding.weight], "lr": 1e-2},
                              {"params": lora_parameters(te3), "lr": 1e-3}], weight_decay=1e-2)
    sched3 = lr_schedule(opt3, name, 3, 10)
    for count in range(4):
        _fake_update(te3, opt3, sched3, count)
    float_payload = checkpoint.snapshot(te3, opt3, sched3, torch.Generator(), step=4,
                                        micro_step=4, first_added_id=FIRST_ADDED)
    checkpoint.write_checkpoint(str(tmp_path / "checkpoint-4"), float_payload,
                                first_added_id=FIRST_ADDED, token_to_id={}, aug_tokens=[],
                                lora_rank=4, base_model_name="tiny")
    te4, opt4, sched4 = _tensor_lr_run(name, spec)
    rates4 = [g["lr"] for g in opt4.param_groups]
    checkpoint.restore_checkpoint(str(tmp_path / "checkpoint-4"), te4, opt4, sched4,
                                  torch.Generator(), FIRST_ADDED)
    assert all(g["lr"] is r for g, r in zip(opt4.param_groups, rates4))
    assert [float(r) for r in rates4] == [float(np.float32(b * fn(4))) for b in (1e-2, 1e-3)]
    assert sched4.last_epoch == 4


# -- the launch counters ---------------------------------------------------------
def test_capture_delta_is_added_per_replay(monkeypatch):
    """A capture's Python calls count launches; the delta is taken back when
    the capture ends and added at each replay, the variant Counters kept as
    the same objects (chip_smoke reads them)."""
    monkeypatch.setattr(fa, "launches", 7)
    monkeypatch.setattr(fa, "bwd_launches", 1)
    monkeypatch.setattr(gn, "launches", 100)
    monkeypatch.setattr(gn, "bwd_launches", 50)
    variants, bwd_variants = fa.variant_counts, fa.bwd_variant_counts
    saved = (collections.Counter(variants), collections.Counter(bwd_variants))
    try:
        variants.clear()
        variants.update({"wgmma": 7})
        bwd_variants.clear()
        bwd_variants.update({"wgmma": 1})
        delta = graphs.LaunchDelta()
        with delta.recording():  # what one step's Python calls count
            fa.launches += 3
            fa.variant_counts.update({"wgmma": 2, "wgmma_wide": 1})
            fa.bwd_launches += 2
            fa.bwd_variant_counts.update({"mma": 2})
            gn.launches += 11
            gn.bwd_launches += 5
        assert (fa.launches, fa.bwd_launches, gn.launches, gn.bwd_launches) == (7, 1, 100, 50)
        assert variants == {"wgmma": 7} and bwd_variants == {"wgmma": 1}
        for _ in range(3):
            delta.add()
        assert (fa.launches, fa.bwd_launches, gn.launches, gn.bwd_launches) == (16, 7, 133, 65)
        assert fa.variant_counts is variants and fa.bwd_variant_counts is bwd_variants
        assert variants == {"wgmma": 13, "wgmma_wide": 3}
        assert bwd_variants == {"wgmma": 1, "mma": 6}
    finally:
        variants.clear()
        variants.update(saved[0])
        bwd_variants.clear()
        bwd_variants.update(saved[1])


# -- the schedule's table --------------------------------------------------------
def test_noise_schedule_gives_the_same_bits_and_moves_its_table_once():
    """add_noise, velocity and snr give the bits of the gather from the CPU
    table (the parent's arithmetic); another device gets one copy of the
    table, kept (the meta device stands in for a card here)."""
    sched = NoiseSchedule.create()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 4, 8, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((4, 4, 8, 8)).astype(np.float32))
    t = torch.tensor([0, 17, 500, 999])
    ac = sched.alphas_cumprod.to(t.device)[t]
    sa, s1 = torch.sqrt(ac).reshape(-1, 1, 1, 1), torch.sqrt(1.0 - ac).reshape(-1, 1, 1, 1)
    assert torch.equal(sched.add_noise(x, eps, t), sa * x + s1 * eps)
    assert torch.equal(sched.velocity(x, eps, t), sa * eps - s1 * x)
    assert torch.equal(sched.snr(t), ac / (1.0 - ac))
    assert sched.device_tables == {}  # the CPU reads the table itself

    meta = torch.device("meta")
    first = sched.alphas_on(meta)
    out = sched.add_noise(x.to(meta), eps.to(meta), t.to(meta))
    sched.snr(t.to(meta))
    assert out.device == meta and sched.alphas_on(meta) is first
    assert list(sched.device_tables) == [meta]


# -- on the card -------------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")


def _tiny_trainer(tmp_path, name, capture):
    from textboost_torch.train.trainer import Trainer

    inst = tmp_path / "instance"
    if not inst.exists():
        inst.mkdir()
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(inst / "a.png")
    graphs.set_capture(capture)
    try:
        return Trainer(parse_args([
            "--model_preset", "tiny", "--instance_data_dir", str(inst),
            "--output_dir", str(tmp_path / name), "--placeholder_token", "<v*>",
            "--initializer_token", "dog", "--train_batch_size", "2", "--resolution", "64",
            "--max_train_steps", "5", "--lr_scheduler", "cosine", "--lr_warmup_steps", "2",
            "--learning_rate", "1e-2", "--report_to", "none", "--seed", "3"]), device="cuda")
    finally:
        graphs.set_capture(True)


@pytest.mark.cuda
def test_captured_steps_equal_eager_steps_on_the_card(tmp_path):
    """Five steps at tiny, three eager then the capture and a replay, equal
    five eager steps from the same state, batches and draws, bit for bit.
    cuDNN's deterministic algorithms: at tiny's fp32 shapes its heuristics
    pick a convolution backward that adds with atomics, and two eager steps
    then differ in the last bits."""
    _cuda_or_skip()
    eager = _tiny_trainer(tmp_path, "eager", capture=False)
    captured = _tiny_trainer(tmp_path, "captured", capture=True)
    assert eager.eager_reason is not None and captured.eager_reason is None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        it, pit = iter(eager.train_loader), iter(eager.prior_loader)
        for i in range(5):
            batch = eager._device_batch(next(it), next(pit))
            draws = eager._draws()
            want = eager.run_step(batch, draws)
            got = captured.run_step(batch, {k: v.clone() for k, v in draws.items()})
            for key in want:
                assert torch.equal(got[key], want[key]), (i, key)
        assert captured.train_step.captured and captured.train_step.replays == 2
        for a, b in zip(eager.text_encoder.parameters(), captured.text_encoder.parameters()):
            assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for t in (eager, captured):
            t.train_loader.stop()
            t.prior_loader.stop()
            t.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["dpm++2m", "ddpm"])
def test_sampler_replays_equal_the_eager_call_on_the_card(sampler):
    """A signature's eager call, its capture and a replay, and a call with
    capture off: the same images, bit for bit."""
    _cuda_or_skip()
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.models.pretrained import load_models
    from textboost_torch.pipelines.text_to_image import TextToImagePipeline

    bundle = load_models("tiny", dtype=torch.float32, device="cuda")
    pipe = TextToImagePipeline("tiny", load_tokenizer(None), bundle.text_encoder, bundle.unet,
                               bundle.vae, device="cuda")
    res = get_spec("tiny").resolution
    pipe.graphs = graphs.CapturedSampler([(2, res, res, 3, True, sampler, 7.5)])
    latents = torch.randn(2, 16, 16, 4, generator=torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    kw = dict(num_inference_steps=3, guidance_scale=7.5, latents=latents, sampler=sampler)
    images = [pipe(["a dog", "a cat"], **kw) for _ in range(3)]
    graphs.set_capture(False)
    try:
        images.append(pipe(["a dog", "a cat"], **kw))
    finally:
        graphs.set_capture(True)
    stats = pipe.graphs.stats()
    assert len(stats) == 1 and next(iter(stats.values()))["replays"] == 2
    for other in images[1:]:
        assert np.array_equal(images[0], other)
    pipe.release_graphs()
