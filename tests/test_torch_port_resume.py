"""Checkpoint, resume and validation of the port's trainer, on the CPU at `tiny`.

A run of 4 steps with paired augmentation and its tokens, a checkpoint and
a validation round every 2 steps, against a run that resumes from the
first run's `checkpoint-2/`: on the CPU the two must end bit-identical
(every trained tensor, the AdamW state, the LR scheduler, the generator of
the draws), which also shows that a validation round does not touch the
training draws.  The sweep runner's flags (`build_cmd`) train through the
CLI.  That a periodic checkpoint loads in the JAX package's
`load_textboost_pipeline` is held in tests/test_torch_port_train.py, beside
the final export, where the JAX model is already built.
"""
import argparse
import logging
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import run_textboost_db
from textboost_torch.lora.peft_io import import_token_embeddings, load_safetensors
from textboost_torch.train import checkpoint
from textboost_torch.train import main as train_main
from textboost_torch.train.config import parse_args
from textboost_torch.train.trainer import Trainer


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
def instance_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_instance")
    rng = np.random.default_rng(0)
    for i, size in enumerate([(96, 80), (72, 72)]):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(d / f"img{i}.png")
    return str(d)


def _flags(instance_dir, out, *extra):
    return ["--model_preset", "tiny", "--instance_data_dir", instance_dir, "--output_dir", out,
            "--placeholder_token", "<v*>", "--initializer_token", "dog",
            "--max_train_steps", "4", "--train_batch_size", "2", "--resolution", "64",
            "--checkpointing_steps", "2", "--validation_steps", "2",
            "--validation_prompts", "photo of a <0>", "a <0> on a table",
            "--num_validation_images", "1", "--augment", "pda", "--augment_inversion",
            "--lr_scheduler", "cosine", "--lr_warmup_steps", "1", "--learning_rate", "1e-2",
            "--report_to", "none", "--seed", "5", *extra]


@pytest.fixture(scope="module")
def runs(instance_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    straight = Trainer(parse_args(_flags(instance_dir, str(root / "straight"))), device="cpu")
    straight_metrics = straight.train()
    resumed_dir = root / "resumed"
    shutil.copytree(root / "straight" / "checkpoint-2", resumed_dir / "checkpoint-2")
    resumed = Trainer(parse_args(_flags(instance_dir, str(resumed_dir), "--resume_from_checkpoint",
                                        "latest", "--checkpoints_total_limit", "1")),
                      device="cpu")
    return {"root": root, "straight": straight, "straight_metrics": straight_metrics,
            "resumed": resumed, "start_step": resumed.start_step,
            "resumed_metrics": resumed.train()}


def _assert_state_equal(a, b):
    for (name, p), (_, q) in zip(a.text_encoder.named_parameters(),
                                 b.text_encoder.named_parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for idx in sa["state"]:
        for key, value in sa["state"][idx].items():
            assert torch.equal(value, sb["state"][idx][key]), (idx, key)
    assert a.state.lr_scheduler.state_dict() == b.state.lr_scheduler.state_dict()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.state.step == b.state.step


def test_two_steps_plus_a_resume_are_bit_identical_to_four(runs):
    assert runs["start_step"] == 2
    assert runs["resumed_metrics"]["steps"] == runs["straight_metrics"]["steps"] == 4
    for key in ("loss", "kpl", "grad_norm", "added_embedding_norm"):
        assert runs["resumed_metrics"][key] == runs["straight_metrics"][key], key
    _assert_state_equal(runs["straight"], runs["resumed"])
    # The LR followed the cosine (1 warm-up step, 3 of decay) across the resume.
    payload = torch.load(runs["root"] / "straight" / "checkpoint-2" / "state.pt",
                         weights_only=True)
    assert payload["optimizer"]["param_groups"][1]["lr"] == pytest.approx(0.75e-2)
    assert runs["resumed"].state.optimizer.param_groups[1]["lr"] == 0.0
    straight, resumed = runs["root"] / "straight", runs["root"] / "resumed"
    for name in ["text_encoder/adapter_model.safetensors", "validation_4.jpg"] + sorted(
            f for f in os.listdir(straight) if f.endswith(".bin")):
        assert (straight / name).read_bytes() == (resumed / name).read_bytes(), name


def test_checkpoint_holds_the_compact_state(runs):
    trainer, ckpt = runs["straight"], runs["root"] / "straight" / "checkpoint-2"
    assert json_load(ckpt / "meta.json") == {"format": checkpoint.FORMAT,
                                             "first_added_id": 49408, "step": 2}
    te_bytes = sum(p.numel() * p.element_size() for p in trainer.text_encoder.parameters())
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    assert ckpt_bytes < te_bytes / 3, (ckpt_bytes, te_bytes)
    payload = torch.load(ckpt / "state.pt", weights_only=True)
    n_added = len(trainer.token_to_id)
    assert payload["added_rows"].shape == (n_added, 64)
    emb_state = payload["optimizer"]["state"][0]
    assert emb_state["exp_avg"].shape == (n_added, 64) and float(emb_state["step"]) == 2
    assert payload["lr_scheduler"]["last_epoch"] == 2
    # The original rows' moments, left out, are zero in the live optimizer.
    live = trainer.state.optimizer.state[trainer.text_encoder.token_embedding.weight]
    assert not live["exp_avg"][:49408].any() and not live["exp_avg_sq"][:49408].any()


def test_frozen_encoder_is_taken_before_the_token_surgery(runs):
    """The KPL reference and the null embedding come from the encoder as it
    was before the placeholder and the augmentation bank were added."""
    trainer = runs["straight"]
    frozen = trainer.frozen_te.token_embedding.weight
    live = trainer.text_encoder.token_embedding.weight
    assert frozen.shape[0] == 49408 and live.shape[0] == 49408 + len(trainer.token_to_id)
    assert len(trainer.aug_tokens) == len(trainer.token_to_id) - 1  # all but <v*>
    assert torch.equal(live[:49408].detach(), frozen.detach().float())
    assert not any(p.requires_grad for p in trainer.frozen_te.parameters())


def json_load(path):
    import json

    with open(path) as f:
        return json.load(f)


def test_checkpoints_total_limit_prunes(runs, tmp_path):
    # The resumed run kept one checkpoint: its own, not the copied one.
    assert checkpoint.checkpoint_dirs(str(runs["root"] / "resumed")) == ["checkpoint-4"]
    assert checkpoint.checkpoint_dirs(str(runs["root"] / "straight")) == [
        "checkpoint-2", "checkpoint-4"]
    for step in (2, 10, 9, 1):
        (tmp_path / f"checkpoint-{step}").mkdir()
    (tmp_path / "checkpoint-x").mkdir()
    assert checkpoint.checkpoint_dirs(str(tmp_path)) == [
        "checkpoint-1", "checkpoint-2", "checkpoint-9", "checkpoint-10"]
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-10")
    checkpoint.prune_checkpoints(str(tmp_path), 2)  # room for one more
    assert checkpoint.checkpoint_dirs(str(tmp_path)) == ["checkpoint-10"]
    checkpoint.prune_checkpoints(str(tmp_path), None)
    assert checkpoint.resolve_checkpoint(str(tmp_path / "checkpoint-10")) == str(
        tmp_path / "checkpoint-10")
    assert checkpoint.resolve_checkpoint(str(tmp_path / "nothing")) is None


def test_periodic_checkpoint_exports_its_adapter_and_token_bins(runs):
    ckpt = str(runs["root"] / "straight" / "checkpoint-2")
    payload = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    bins = import_token_embeddings([os.path.join(ckpt, f) for f in os.listdir(ckpt)
                                    if f.endswith(".bin")])
    trainer = runs["straight"]
    assert set(bins) == set(trainer.token_to_id)
    for tok, row in bins.items():
        assert np.array_equal(row, payload["added_rows"][trainer.token_to_id[tok] - 49408].numpy())
    for tok in trainer.aug_tokens:  # augmentation tokens are saved [1, hidden]
        path = os.path.join(ckpt, tok.strip("<>") + ".bin")
        assert torch.load(path, weights_only=True)[tok].shape == (1, 64)
    lora = load_safetensors(os.path.join(ckpt, "text_encoder", "adapter_model.safetensors"))
    assert len(lora) == 2 * 3 * 2  # layers x q/k/v x A/B
    for name, value in payload["lora"].items():
        assert np.array_equal(lora["base_model.model." + name], value.numpy()), name
    assert any(np.abs(v).max() > 0 for k, v in lora.items() if "lora_B" in k)


def test_validation_prompt_list_substitutes_repeats_and_warns(runs, caplog):
    trainer = runs["straight"]
    joined = trainer.concept_tokens["<v*>"]
    prompts = trainer.validation_prompt_list()
    assert prompts == [f"photo of a {joined}", f"a {joined} on a table"]
    ids = trainer.tokenizer(prompts[0])["input_ids"]
    assert trainer.token_to_id["<v*>"] in ids
    config = trainer.config
    saved = config.validation_prompts
    try:
        config.validation_prompts = ["a photo of <i>"]
        config.num_validation_images = 3
        assert trainer.validation_prompt_list() == [f"a photo of {joined}"] * 3
        with caplog.at_level(logging.WARNING, logger="textboost_torch"):
            config.validation_prompts = ["a photo of <1>"]
            assert trainer.validation_prompt_list() == ["a photo of <1>"] * 3
        assert any("unresolved placeholder" in r.getMessage() for r in caplog.records)
        config.validation_prompts = None
        assert trainer.validation_prompt_list() == [f"a photo of {joined}"] * 3
    finally:
        config.validation_prompts, config.num_validation_images = saved, 1


def test_validation_grid_and_the_training_state(runs):
    """Rows are prompts, columns images; a round changes neither the weights
    nor the generator of the training draws, and reuses one pipeline over
    the live modules."""
    trainer = runs["straight"]
    # Two prompts, one image each: two rows of one 128-px tile.
    assert Image.open(runs["root"] / "straight" / "validation_2.jpg").size == (128, 256)
    pipe = trainer._val_pipe
    assert pipe.text_encoder is trainer.text_encoder and pipe.unet is trainer.bundle.unet
    weights = [p.detach().clone() for p in trainer.text_encoder.parameters()]
    gen_state = trainer.generator.get_state()
    modules = (trainer.text_encoder, trainer.bundle.unet, trainer.bundle.vae)
    trainer.text_encoder.train()  # a mode the round must hand back
    modes = [m.training for m in modules]
    saved = (trainer.config.validation_prompts, trainer.config.num_validation_images)
    try:
        trainer.config.validation_prompts = ["photo of a <0>"]
        trainer.config.num_validation_images = 2
        path = trainer.run_validation(99)
        trainer.join_validation_writers()
    finally:
        trainer.config.validation_prompts, trainer.config.num_validation_images = saved
    assert trainer._val_pipe is pipe
    grid = np.asarray(Image.open(path))
    assert grid.shape == (128, 2 * 128, 3)  # one prompt, two images of 128 px
    assert not np.array_equal(grid[:, :128], grid[:, 128:])  # each image its own latent
    assert torch.equal(trainer.generator.get_state(), gen_state)
    assert all(torch.equal(a, b) for a, b in zip(weights, trainer.text_encoder.parameters()))
    assert all(p.requires_grad for p in trainer.text_encoder.token_embedding.parameters())
    assert [m.training for m in modules] == modes
    trainer.text_encoder.eval()


def test_checkpoint_writer_failure_raises_at_the_join(instance_dir, tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(checkpoint, "write_checkpoint", boom)
    trainer = Trainer(parse_args([
        "--model_preset", "tiny", "--instance_data_dir", instance_dir,
        "--output_dir", str(tmp_path / "out"), "--max_train_steps", "1",
        "--checkpointing_steps", "1", "--resolution", "64", "--report_to", "none",
        "--dataloader_num_workers", "0"]), device="cpu")
    with pytest.raises(RuntimeError, match="checkpoint writer"):
        trainer.train()
    # train() stops the loaders on the failure path too.
    assert trainer.train_loader._stop.is_set() and trainer.prior_loader._stop.is_set()


def test_cli_takes_the_sweep_runners_flags(instance_dir, tmp_path):
    """`run_textboost_db.py::build_cmd`'s flags (augmentation with its
    tokens, --mixing, validation prompts, bf16) at `tiny`, 2 steps."""
    args = argparse.Namespace(model="tiny", data_dir=os.path.dirname(instance_dir),
                              lora_rank=4, lr=1e-4, emb_lr=1e-3, batch_size=2, total_steps=2,
                              train_params="none", augment="pda", augment_p=0.5,
                              null_prob=0.1, kpl_weight=0.1, mesh_tp=1, num_samples=1,
                              no_inversion=False, no_weighted_sample=False, mixing=True,
                              validation_steps=0)
    cmd = run_textboost_db.build_cmd(args, os.path.basename(instance_dir), "toy", "red",
                                     str(tmp_path))
    assert "--augment_inversion" in cmd and "--mixing" in cmd and "--augment=pda" in cmd
    metrics = train_main(["--device", "cpu", *cmd, "--report_to", "none"])
    out = tmp_path / os.path.basename(instance_dir)
    assert metrics["steps"] == 2 and np.isfinite(metrics["loss"])
    assert metrics["aug:samples"] == 4
    placeholder = "<" + os.path.basename(instance_dir) + "_0>"
    tokens = torch.load(out / (placeholder.strip("<>") + ".bin"), weights_only=True)
    assert tokens[placeholder].shape == (64,)
    for name in ("zoom-in_0", "collage_1", "hflip", "grayscale"):
        blob = torch.load(out / f"{name}.bin", weights_only=True)
        assert blob[f"<{name}>"].shape == (1, 64)
    # --mixing with the object bank: lora_B's odd output rows get no
    # gradient, so from their zero init they stay exactly zero.
    lora = load_safetensors(str(out / "text_encoder" / "adapter_model.safetensors"))
    lora_b = [v for k, v in lora.items() if "lora_B" in k]
    assert len(lora_b) == 6 and all(not b[1::2].any() and b[0::2].any() for b in lora_b)
