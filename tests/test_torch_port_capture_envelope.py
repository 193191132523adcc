"""The train step captured outside the JAX package's ahead-of-time envelope:
the UNet's kv-LoRA with the image prior, gradient checkpointing and the
padded CLIP mask; gradient accumulation as one graph per micro-step
position; and the data-parallel all-reduce inside the graph (an NCCL
launch at world 1).  textboost_torch/train/graph.py::eager_reason admits
them as the JAX trainer jits them (textboost_tpu/train/trainer.py:728).

Capture needs CUDA, so on the CPU the step runs through `RecordingGraph`, a
stand-in with the graph's interface: its capture runs the function once
with the host work deferred (graphs.per_replay), as a real capture records
it, and each replay returns what the function returns with the deferred
work run again.  Through it the captured step equals the plain eager step
bit for bit, the static-buffer accumulation holds the JAX step with
optax's MultiSteps, and the all-reduce's counters count each replay.  The
`cuda` cases run the same three captures on the card against eager
trainers (this file imports JAX inside the tests that need it, so the
card, which has no JAX, collects it).
"""
import copy
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from textboost_torch import graphs
from textboost_torch.lora.partition import lora_parameters, lr_schedule, make_optimizer, set_trainable
from textboost_torch.models.pretrained import load_models
from textboost_torch.ops import group_norm as gn
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.parallel.mesh import GradReducer
from textboost_torch.train import graph
from textboost_torch.train.step import StepConfig, TrainState, make_train_step, micro_step_position

FIRST_ADDED = 49408
ROWS = 2  # instance rows of a micro-batch (the image prior adds as many class rows)
# The JAX step's metrics, as tests/test_torch_port_train_step.py holds them:
# fp32 on both sides, sums in another order.
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


class RecordingGraph:
    """graphs.Graph's interface on the CPU.  `capture(fn)` runs fn once with
    the host work it defers (graphs.per_replay) kept, as a real capture
    records it; the first replay returns that run's outputs, a later one
    runs fn again with its deferred work dropped; every replay then runs
    the kept host work."""

    def __init__(self):
        self.fn, self.outputs, self.host_work = None, None, []
        self.captures = self.replays = 0
        self._fresh = False

    def capture(self, fn):
        self.fn, self.captures, self.host_work = fn, self.captures + 1, []
        with graphs.recording_host_work(self.host_work):
            self.outputs = fn()
        self._fresh = True

    def replay(self):
        if not self._fresh:
            with graphs.recording_host_work([]):
                self.outputs = self.fn()
        self._fresh = False
        for work in self.host_work:
            work()
        self.replays += 1
        return self.outputs

    def stats(self):
        return {"replays": self.replays}


# -- a tiny state of the port ---------------------------------------------------
def _tiny_state(accumulate=1, unet_lora=False, checkpointing=False, prior=False, mask=False,
                reduce=None):
    """The trainer's state at tiny from seeded weights (fp32 on the CPU):
    one added token, the UNet's kv-LoRA when `unet_lora`; its step."""
    bundle = load_models("tiny", lora_rank=4, unet_lora_rank=4 if unet_lora else 0,
                         dtype=torch.float32, device="cpu", seed=0, memo=False)
    te, unet, vae = bundle.text_encoder, bundle.unet, bundle.vae
    frozen = copy.deepcopy(te)
    for mod in (te, frozen, unet, vae):
        mod.requires_grad_(False)
    table = te.token_embedding.weight.detach()
    grown = torch.cat([table.float(), table[1234:1235].float()])
    te.set_token_embedding(grown, dtype=torch.float32)
    set_trainable(te, unet if unet_lora else None)
    unet.gradient_checkpointing = checkpointing
    optimizer = make_optimizer(te, 1e-3, 1e-2, unet=unet if unet_lora else None)
    null_ids = torch.full((1, 77), 49407).index_fill_(1, torch.tensor([0]), 49406)
    with torch.no_grad():
        null = frozen(null_ids, use_lora=False)[0][0].float()
    state = TrainState(
        text_encoder=te, frozen_text_encoder=frozen, unet=unet, vae=vae, optimizer=optimizer,
        lr_scheduler=lr_schedule(optimizer, "cosine", 1, 12), schedule=NoiseSchedule.create(),
        null_embedding=null,
        target_norm=torch.linalg.vector_norm(grown, dim=-1).mean(),
        original_rows=grown[:FIRST_ADDED].clone(),
        unet_lora=lora_parameters(unet) if unet_lora else [])
    config = StepConfig(vae_scaling=bundle.spec.vae.scaling_factor,
                        first_added_token_id=FIRST_ADDED, kpl_weight=0.1, max_grad_norm=1.0,
                        accumulate_steps=accumulate, with_image_prior=prior,
                        use_attention_mask=mask)
    return make_train_step(config, reduce=reduce), state


def _micro_batch(seed, prior=False):
    """Distinct pixels, ids and draws a micro-step (class rows after the
    instance rows with the image prior)."""
    rng = np.random.default_rng(seed)
    rows = 2 * ROWS if prior else ROWS
    ids = np.full((rows, 77), 49407, np.int64)
    ids[:, 0] = 49406
    ids[:, 1] = rng.integers(300, 40000, rows)
    ids[:ROWS, 2] = FIRST_ADDED  # the added token trains
    ids[:, 3] = rng.integers(300, 40000, rows)
    kpl = np.full((ROWS, 77), 49407, np.int64)
    kpl[:, 0] = 49406
    kpl[:, 1:3] = rng.integers(300, 40000, (ROWS, 2))
    gen = torch.Generator().manual_seed(seed)
    batch = {"pixel_values": torch.from_numpy(rng.integers(0, 256, (rows, 128, 128, 3),
                                                           dtype=np.uint8)),
             "input_ids": torch.from_numpy(ids), "prior_input_ids": torch.from_numpy(kpl)}
    draws = {"vae_eps": torch.randn(rows, 4, 16, 16, generator=gen),
             "noise": torch.randn(rows, 4, 16, 16, generator=gen),
             "timesteps": torch.randint(0, 1000, (rows,), generator=gen)}
    return batch, draws


def _assert_same_state(a, b):
    for x, y in zip(a.text_encoder.parameters(), b.text_encoder.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.unet_lora, b.unet_lora):
        assert torch.equal(x, y)
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.step == b.step
    assert a.lr_scheduler.last_epoch == b.lr_scheduler.last_epoch


def _run_pair(calls, warmup, *, prior=False, **kw):
    """`calls` micro-steps through CapturedStep (RecordingGraph stand-ins)
    and the plain step from equal states; each micro-step's metrics equal
    bit for bit.  Returns the held step, the two states and the stand-ins."""
    plain_step, plain = _tiny_state(prior=prior, **kw)
    step, state = _tiny_state(prior=prior, **kw)
    made = []

    def new_graph():
        made.append(RecordingGraph())
        return made[-1]

    held = graph.CapturedStep(step, "cpu", warmup=warmup, accumulate=step.config.accumulate_steps,
                              new_graph=new_graph)
    for i in range(calls):
        batch, draws = _micro_batch(20 + i, prior)
        want = plain_step(plain, batch, draws)
        got = held(state, {k: v.clone() for k, v in batch.items()},
                   {k: v.clone() for k, v in draws.items()})
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
    _assert_same_state(state, plain)
    return held, state, plain, made


def test_kv_lora_prior_checkpointing_step_captured_equals_eager(monkeypatch):
    """The snapshot run's configuration at tiny (the UNet's kv-LoRA, the
    image prior's class rows after the instance rows, gradient
    checkpointing, the padded CLIP mask): one eager step, the capture and
    two replays from the static buffers equal four plain steps bit for bit,
    the batch and the draws changing every step; the UNet's LoRA trains,
    the recompute runs, and no GroupNorm falls back to its plain version
    for a trainable affine (group_norm.group_norm's torch-math branch)."""
    recomputed = {"n": 0}
    from textboost_torch.models import unet as unet_mod

    real_checkpoint = unet_mod.checkpoint

    def counting(*args, **kwargs):
        recomputed["n"] += 1
        return real_checkpoint(*args, **kwargs)

    affine_fallbacks = {"n": 0}
    real_reference = gn.group_norm_reference

    def reference(x, gamma, beta, *args, **kwargs):
        if torch.is_grad_enabled() and (gamma.requires_grad or beta.requires_grad):
            affine_fallbacks["n"] += 1
        return real_reference(x, gamma, beta, *args, **kwargs)

    monkeypatch.setattr(unet_mod, "checkpoint", counting)
    monkeypatch.setattr(gn, "group_norm_reference", reference)
    held, state, _, made = _run_pair(4, 1, prior=True, unet_lora=True, checkpointing=True,
                                     mask=True)
    assert [(g.captures, g.replays) for g in made] == [(1, 3)]
    assert held.eager_steps == 1 and held.replays == 3 and held.stats()["graphs"] == 1
    assert recomputed["n"] > 0 and affine_fallbacks["n"] == 0
    b_weights = state.unet_lora[1::2]
    assert b_weights and all(int(torch.count_nonzero(b)) for b in b_weights)


@pytest.mark.parametrize("accumulate", [2, 3])
def test_accumulation_positions_captured_equal_eager(accumulate):
    """--gradient_accumulation_steps as one graph per micro-step position:
    one whole step eager (its micro-steps make the fixed accumulation
    buffers), then the first, (middle) and last positions each captured at
    their first call and replayed at the next update; every micro-step
    equals the plain step bit for bit (the same static-buffer code runs
    eagerly), the update lands on the last micro-step only, and the
    buffers keep their addresses."""
    held, state, _, made = _run_pair(3 * accumulate, 1, accumulate=accumulate)
    positions = ["first"] + ["middle"] * (accumulate > 2) + ["last"]
    assert list(held.graphs) == positions
    assert [(g.captures, g.replays) for g in made] == [(1, 2)] * len(positions)
    assert held.eager_steps == accumulate and held.replays == 2 * accumulate
    assert state.step == 3 * accumulate and state.lr_scheduler.last_epoch == 3
    assert [micro_step_position(i, accumulate) for i in range(accumulate)] == positions
    buffers = [t.data_ptr() for t in state.accumulated]
    held(state, *_micro_batch(99))  # the first position again: a replay
    assert [t.data_ptr() for t in state.accumulated] == buffers
    assert held.step.updates(state) is (accumulate == 2)


def test_static_buffer_accumulation_matches_jax_multisteps():
    """Accumulation 3 (the fixed buffers through CapturedStep) against the
    JAX step with optax's MultiSteps, on distinct micro-batches and the
    draws the JAX step makes from its key: two updates, the metrics after
    every micro-step and the weights after the last."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_train_step as ts
    from textboost_tpu.models import AutoencoderKL, UNet2DCondition, get_spec
    from textboost_torch.models.convert import jax_tree_from_state_dict

    # The JAX modules over the port's seeded tiny weights (the JAX package's
    # own init compiles for tens of seconds).
    port = load_models("tiny", lora_rank=4, dtype=torch.float32, device="cpu", memo=False)
    params = {kind: jax.tree.map(lambda t: t.numpy(), jax_tree_from_state_dict(
        kind, getattr(port, kind).state_dict())) for kind in ("text_encoder", "unet", "vae")}
    spec = get_spec("tiny")
    jax_bundle = types.SimpleNamespace(
        te_params=params["text_encoder"], unet_params=params["unet"], vae_params=params["vae"],
        unet=UNet2DCondition(spec.unet, dtype=jnp.float32),
        vae=AutoencoderKL(spec.vae, dtype=jnp.float32))
    bundle, base, te_params, null_emb, target_norm, jax_step, jstate, frozen = ts._jax_side(
        np.random.default_rng(0), accumulate_steps=3, bundle=jax_bundle)
    _, state = ts._port_side(bundle, base, te_params, null_emb, target_norm)
    step = make_train_step(ts.port_step_config(accumulate_steps=3))
    held = graph.CapturedStep(step, "cpu", warmup=0, accumulate=3, new_graph=RecordingGraph)
    for i in range(6):
        batch = ts._batch(np.random.default_rng(30 + i))
        draws = ts._jax_draws(jstate)
        jstate, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, frozen)
        pm = held(state, ts._to_torch(batch), draws)
        for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=f"micro-step {i} {key}")
        # AdamW's step count: the updates land on micro-steps 3 and 6.
        counts = {int(s["step"]) for s in state.optimizer.state.values()}
        assert counts == ({(i + 1) // 3} if i >= 2 else set()), i
    assert held.replays == 6 and list(held.graphs) == ["first", "middle", "last"]
    te, jp = state.text_encoder, jstate.te_params["params"]
    emb = te.token_embedding.weight.detach().numpy()
    np.testing.assert_allclose(emb[FIRST_ADDED], np.asarray(jp["token_embedding"])[FIRST_ADDED],
                               rtol=0, atol=2e-5)
    for i, layer in enumerate(te.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            mod = getattr(layer.self_attn, proj)
            leaf = jp[f"layers_{i}"]["self_attn"][proj]
            np.testing.assert_allclose(mod.lora_A.weight.detach().numpy(),
                                       np.asarray(leaf["lora_a"]).T, rtol=0, atol=2e-5)
            np.testing.assert_allclose(mod.lora_B.weight.detach().numpy(),
                                       np.asarray(leaf["lora_b"]).T, rtol=0, atol=2e-5)


@pytest.fixture
def one_rank_group(tmp_path):
    """A torch.distributed group of one process (gloo on the CPU)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_all_reduce_counts_each_replay(one_rank_group):
    """The data-parallel reduce inside the captured step (the NCCL world-1
    launch's, here over a 1-rank gloo group): its `calls` and `bytes` count
    the eager micro-step and then each replay (graphs.per_replay), none at
    the capture; only the eager reduce is timed; the step equals the plain
    step without a reduce bit for bit (a mean over one rank).  A capture
    before any eager reduce raises: the communicator is the first
    reduce's."""
    def reducer(state):
        te = state.text_encoder
        return GradReducer(te.token_embedding.weight, FIRST_ADDED, lora_parameters(te))

    plain_step, plain = _tiny_state(accumulate=2)
    step, state = _tiny_state(accumulate=2)
    step.reduce = reducer(state)
    held = graph.CapturedStep(step, "cpu", warmup=1, accumulate=2, new_graph=RecordingGraph)
    for i in range(6):
        batch, draws = _micro_batch(40 + i)
        want = plain_step(plain, batch, draws)
        got = held(state, batch, draws)
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
        assert (step.reduce.calls, step.reduce.replayed) == (i + 1, max(i - 1, 0))
    r = step.reduce
    assert r.bytes == 6 * 4 * r.values() and len(r.milliseconds()) == 2
    assert held.replays == 4 and held.eager_steps == 2

    fresh_step, fresh = _tiny_state()
    fresh_step.reduce = reducer(fresh)
    early = graph.CapturedStep(fresh_step, "cpu", warmup=0, new_graph=RecordingGraph)
    with pytest.raises(RuntimeError, match="does not fall back") as err:
        early(fresh, *_micro_batch(50))
    assert "communicator" in str(err.value.__cause__)


# -- on the card -------------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _card_trainer(tmp_path, name, capture, *extra):
    from textboost_torch.models import pretrained
    from textboost_torch.train.config import parse_args
    from textboost_torch.train.trainer import Trainer

    inst, cls = tmp_path / "instance", tmp_path / "class"
    if not inst.exists():
        inst.mkdir()
        cls.mkdir()
        rng = np.random.default_rng(0)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(inst / "a.png")
        for i in range(2):  # the class images exist: the run generates none
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                cls / f"{i}-class.png")
    graphs.set_capture(capture)
    try:
        # Each trainer its own UNet: a kv-LoRA run trains the preset memo's in place.
        pretrained._PRESET_MEMO.clear()
        return Trainer(parse_args([
            "--model_preset", "tiny", "--instance_data_dir", str(inst),
            "--output_dir", str(tmp_path / name), "--placeholder_token", "<v*>",
            "--initializer_token", "dog", "--train_batch_size", "2", "--resolution", "64",
            "--max_train_steps", "8", "--lr_scheduler", "cosine", "--lr_warmup_steps", "2",
            "--learning_rate", "1e-2", "--report_to", "none", "--seed", "3",
            *[str(cls) if a == "CLASS_DIR" else a for a in extra]]), device="cuda")
    finally:
        graphs.set_capture(True)


def _steps_equal(eager, captured, steps):
    """`steps` steps of both trainers on the eager one's batches and draws,
    bit for bit, with cuDNN's deterministic algorithms (at tiny's fp32
    shapes its heuristics pick a convolution backward that adds with
    atomics).  Returns the captured step's stats, taken before the graphs
    are released."""
    accum = eager.step_config.accumulate_steps
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        it, pit = iter(eager.train_loader), iter(eager.prior_loader)
        for i in range(steps * accum):
            batch = eager._device_batch(next(it), next(pit))
            draws = eager._draws()
            want = eager.run_step(batch, draws)
            got = captured.run_step(batch, {k: v.clone() for k, v in draws.items()})
            for key in want:
                assert torch.equal(got[key], want[key]), (i, key)
        for a, b in zip(eager.text_encoder.parameters(), captured.text_encoder.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(eager.state.unet_lora, captured.state.unet_lora):
            assert torch.equal(a, b)
        return captured.train_step.stats()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for t in (eager, captured):
            t.train_loader.stop()
            t.prior_loader.stop()
            t.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kv_lora_prior", "accumulation_3"])
def test_captures_equal_eager_steps_on_the_card(tmp_path, case):
    """The snapshot run's configuration (kv-LoRA, the image prior,
    checkpointing, the padded mask) over 5 steps, and accumulation 3 over 5
    steps (15 micro-steps: 9 eager, then each position captured and
    replayed twice), captured against capture off, bit for bit."""
    _cuda_or_skip()
    extra = {"kv_lora_prior": ["--unet_params_to_train", "crossattn_kv", "--with_image_prior",
                               "--class_data_dir", "CLASS_DIR", "--class_token", "dog",
                               "--num_prior_images", "2", "--gradient_checkpointing",
                               "--text_encoder_use_attention_mask"],
             "accumulation_3": ["--gradient_accumulation_steps", "3"]}[case]
    eager = _card_trainer(tmp_path, "eager", False, *extra)
    captured = _card_trainer(tmp_path, "captured", True, *extra)
    assert eager.eager_reason is not None and captured.eager_reason is None
    stats = _steps_equal(eager, captured, 5)
    accum = captured.step_config.accumulate_steps
    assert stats["eager_steps"] == graph.WARMUP_STEPS * accum
    assert stats["replays"] == (5 - graph.WARMUP_STEPS) * accum
    assert stats["graphs"] == min(accum, 3)


@pytest.mark.cuda
def test_nccl_world_1_step_captured_on_the_card(tmp_path):
    """An NCCL group of one process: the step is captured with its
    all-reduce inside the graph, equals the step with capture off bit for
    bit, and the all-reduce counts one call a micro-step, the replays
    included."""
    _cuda_or_skip()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        eager = _card_trainer(tmp_path, "eager", False)
        captured = _card_trainer(tmp_path, "captured", True)
        assert captured.eager_reason is None and captured.reducer is not None
        assert "set_capture(False)" in eager.eager_reason
        _steps_equal(eager, captured, 5)
        r = captured.reducer
        assert (r.calls, r.replayed) == (5, 5 - graph.WARMUP_STEPS)
        assert len(r.milliseconds()) == graph.WARMUP_STEPS
    finally:
        dist.destroy_process_group()
