"""The reference against textboost_torch at the tiny preset on the CPU (this
test alone imports both), and the harness's comparison run on the CPU: sound
runs come out correct, runs with the timed path broken underneath do not."""
import json
import os
import tempfile
import time

import pytest
import torch

from conftest import ROOT
from portbench import harness, inputs, program
from portbench.reference import models as ref

TINY = json.load(open(os.path.join(ROOT, "portbench", "tests", "tiny.json")))


def modules(seed=3):
    from textboost_torch.models.layers import set_impl
    from textboost_torch.models.pretrained import load_models

    weights = inputs.make_weights(TINY, seed, "cpu", lora_rank=4, lora_b=0.01,
                                  dtype=torch.float32)
    bundle = load_models(preset="tiny", lora_rank=4, dtype=torch.float32, device="cpu",
                         memo=False)
    for part in inputs.PARTS:
        program.copy_into(getattr(bundle, part), weights[part], part)
        set_impl(getattr(bundle, part), "math")
    mods = ref.build(ref.Ops(), TINY, lora_rank=4, device="cpu")
    for part, m in mods.items():
        m.load_state_dict(weights[part])
    return bundle, mods


def test_reference_models_match_the_package(one_thread):
    bundle, mods = modules()
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 49406, (2, 77), generator=gen)
    ids[:, 0], ids[:, 9:] = 49406, 49407
    with torch.no_grad():
        want = bundle.text_encoder(ids)[0]
        got = mods["text_encoder"](ids)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        x = torch.randn(2, 4, 16, 16, generator=gen)
        t = torch.tensor([10, 900])
        assert torch.allclose(mods["unet"](x, t, got), bundle.unet(x, t, want),
                              rtol=1e-4, atol=1e-4)
        px = torch.rand(2, 3, 128, 128, generator=gen) * 2 - 1
        m1, l1 = bundle.vae.encode_moments(px)
        m2, l2 = mods["vae"].encode(px)
        assert torch.allclose(m1, m2, rtol=1e-4, atol=1e-4)
        assert torch.allclose(l1, l2, rtol=1e-4, atol=1e-4)
        assert torch.allclose(bundle.vae.decode(m1), mods["vae"].decode(m1),
                              rtol=1e-4, atol=1e-4)


def tiny_run(workload, seed, patch=None, monkeypatch=None):
    """A cell's run at the tiny preset on the CPU, its traffic cut to tiny
    sizes; `patch(monkeypatch)` breaks the program first."""
    cell = harness.cell(harness.benchmark(), workload)
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    if traffic["kind"] == "train":
        traffic["flags"] = [f for f in traffic["flags"] if not f.startswith(
            ("--resolution", "--train_batch_size"))] + ["--resolution=128",
                                                        "--train_batch_size=2"]
    else:
        traffic.update(steps=4, warmup_calls=2)
    if patch is not None:
        patch(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(workload=workload, config=TINY, traffic=traffic,
                              limits=harness.load_json("limits", f"{workload}.json"),
                              seed=seed, seconds=0.1, trace=False, device=torch.device("cpu"),
                              tmp=tmp, trace_path="", t0=time.perf_counter())
        out = harness.run_cell(ctx)
    return {name: (value, limit) for name, value, limit in out["checks"]}


def correct(checks):
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("workload", ["sd21base-train-paper", "sd15-train-paper",
                                      "sd21base-sample-eval"])
def test_a_sound_run_is_correct(workload, one_thread):
    checks = tiny_run(workload, 2**31 + 11)
    assert correct(checks), checks


def state_unchanged(mp):
    from textboost_torch.train import step

    real = step.TrainStep.body

    def body(self, state, batch, draws):
        te = state.text_encoder
        kept = [p.detach().clone() for p in te.parameters() if p.requires_grad]
        out = real(self, state, batch, draws)
        with torch.no_grad():
            for p, k in zip([p for p in te.parameters() if p.requires_grad], kept):
                p.copy_(k)
        return out

    mp.setattr(step.TrainStep, "body", body)


def half_batch(mp):
    from textboost_torch.train import step

    real = step.forward_backward

    def forward_backward(state, config, batch, draws):
        h = batch["input_ids"].shape[0] // 2
        return real(state, config, {k: v[:h] for k, v in batch.items()},
                    {k: v[:h] for k, v in draws.items()})

    mp.setattr(step, "forward_backward", forward_backward)


def half_batch_after_warmup(mp):
    """Half the batch from the first step after the eager warm-up on: on a
    card, in the capture and so in every replay of the step's graph."""
    from textboost_torch.train import graph, step

    real = step.forward_backward
    calls = [0]

    def forward_backward(state, config, batch, draws):
        calls[0] += 1
        if calls[0] <= graph.WARMUP_STEPS:
            return real(state, config, batch, draws)
        h = batch["input_ids"].shape[0] // 2
        return real(state, config, {k: v[:h] for k, v in batch.items()},
                    {k: v[:h] for k, v in draws.items()})

    mp.setattr(step, "forward_backward", forward_backward)


def table_frozen(mp):
    """The token table left as it was by every step (the LoRA weights move)."""
    from textboost_torch.train import step

    real = step.TrainStep.body

    def body(self, state, batch, draws):
        emb = state.text_encoder.token_embedding.weight
        kept = emb.detach().clone()
        out = real(self, state, batch, draws)
        with torch.no_grad():
            emb.copy_(kept)
        return out

    mp.setattr(step.TrainStep, "body", body)


def emb_lr_doubled(mp):
    """The added rows' learning rate twice the configuration's."""
    from textboost_torch.train import trainer

    real = trainer.make_optimizer

    def make_optimizer(te, lr, emb_lr, **kwargs):
        return real(te, lr, 2 * emb_lr, **kwargs)

    mp.setattr(trainer, "make_optimizer", make_optimizer)


def token_altered(mp):
    from textboost_torch.data import tokenizer

    real = tokenizer.CLIPTokenizer.__call__

    def call(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        out["input_ids"][:, 2] = (out["input_ids"][:, 2] + 1) % 49406
        return out

    mp.setattr(tokenizer.CLIPTokenizer, "__call__", call)


def image_altered(mp):
    from textboost_torch.pipelines import text_to_image

    real = text_to_image.to_uint8

    def to_uint8(images):
        out = real(images)
        out[0] = 255 - out[0]
        return out

    mp.setattr(text_to_image, "to_uint8", to_uint8)


@pytest.mark.parametrize("workload,fault,fails", [
    ("sd21base-train-paper", state_unchanged, "change3_median"),
    ("sd21base-train-paper", half_batch, "grad"),
    ("sd15-train-paper", half_batch_after_warmup, "grad6_embedding"),
    ("sd21base-train-paper", table_frozen, "change3_embedding"),
    ("sd21base-train-paper", emb_lr_doubled, "change3_embedding"),
    ("sd21base-train-paper", token_altered, "token_rows_differing"),
    ("sd21base-sample-eval", token_altered, None),
    ("sd21base-sample-eval", image_altered, "image_gap")])
def test_a_broken_run_is_not_correct(workload, fault, fails, monkeypatch, one_thread):
    """The run is not correct, and the number named fails (a fault after
    the warm-up passes the first step's gradient and fails the last's)."""
    checks = tiny_run(workload, 5, fault, monkeypatch)
    assert not correct(checks), checks
    if fails is not None:
        value, limit = checks[fails]
        assert value > limit, checks
    if fault is half_batch_after_warmup:
        value, limit = checks["grad"]
        assert value <= limit, checks
