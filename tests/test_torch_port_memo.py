"""The port's cross-instance memos, on the CPU at `tiny`.

The memos of the JAX package have counterparts in the port:
`models/pretrained.py::_PRESET_MEMO` (a preset's bundle, with a pristine
text encoder that no taker changes, which also serves what the JAX
package's `_BASE_CACHE` kept for the eval), `pipelines/loading.py`'s
`reuse=` binding the next instance in place, with the eval's capture rule
over runs of instances that `reuse=` keeps its graphs across, and
`train/graph.py::_AOT_MEMO` (the step, its optimizer and the tensors it
reads, which the next instance of a `--sequential` sweep binds itself
into; one entry).  The CPU captures no graph, but the binding runs here as
on the card, so these cases hold it: the addresses an entry keeps, and
every number of an instance trained through the memo against the same
instance trained alone with the memos cleared, to the bit.

The numerics against the JAX package are carried by the single-instance
parity tests (tests/test_torch_port_train.py, tests/test_torch_port_pipeline.py);
bit-equality to a run alone extends them to every instance of a sweep.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from textboost_torch.eval import __main__ as eval_cli
from textboost_torch.lora.partition import lora_parameters
from textboost_torch.models import pretrained
from textboost_torch.models.pretrained import load_models, save_snapshot
from textboost_torch.pipelines import loading
from textboost_torch.train import graph
from textboost_torch.train import trainer as trainer_mod
from textboost_torch.train.config import TrainConfig
from textboost_torch.utils import sweep

# Sub-tokens of each initializer: dog and clock add as many rows, cat fewer.
INSTANCES = {"dog": "corgi dog", "clock": "alarm clock", "cat": "cat"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run many small ops; with the suite's other processes on
    every core, torch's thread pool waits on its own threads far longer
    than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clear_memos(monkeypatch):
    monkeypatch.setattr(pretrained, "_PRESET_MEMO", {})
    monkeypatch.setattr(graph, "_AOT_MEMO", {})


def _tensors(module):
    return dict(module.state_dict(keep_vars=True))


def _same_bits(a, b):
    ta, tb = a.state_dict(), b.state_dict()
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)


def test_a_preset_is_served_from_the_memo_and_a_snapshot_dir_is_not(tmp_path, monkeypatch):
    _clear_memos(monkeypatch)
    kw = dict(lora_rank=4, dtype=torch.float32, device="cpu", seed=3)
    a, b = load_models("tiny", **kw), load_models("tiny", **kw)
    assert a.unet is b.unet and a.vae is b.vae
    assert a.frozen_text_encoder is b.frozen_text_encoder is not None
    # Each taker gets its own copy of the pristine encoder.
    assert a.text_encoder is not b.text_encoder
    assert _same_bits(a.text_encoder, b.text_encoder)
    assert _same_bits(a.text_encoder, a.frozen_text_encoder)
    fresh = load_models("tiny", memo=False, **kw)
    assert fresh.unet is not a.unet and fresh.frozen_text_encoder is None
    assert _same_bits(fresh.unet, a.unet) and _same_bits(fresh.text_encoder, a.text_encoder)
    assert pretrained.memo_bytes() == sum(
        t.numel() * t.element_size() for t in _tensors(a.frozen_text_encoder).values())
    # Another key replaces the entry.
    other = load_models("tiny", **{**kw, "seed": 4})
    assert other.unet is not a.unet and load_models("tiny", **kw).unet is not a.unet

    save_snapshot(fresh, str(tmp_path / "native"))
    c, d = (load_models(str(tmp_path / "native"), **kw) for _ in range(2))
    assert c.unet is not d.unet and c.frozen_text_encoder is None
    assert _same_bits(c.unet, d.unet)


def test_a_taker_that_changes_a_shared_tensor_spends_the_entry(monkeypatch):
    _clear_memos(monkeypatch)
    kw = dict(unet_lora_rank=2, dtype=torch.float32, device="cpu")
    a = load_models("tiny", **kw)
    with torch.no_grad():
        lora_parameters(a.unet)[1].add_(1.0)  # as training the UNet's LoRA does
    b = load_models("tiny", **kw)
    assert b.unet is not a.unet
    assert _same_bits(b.unet, load_models("tiny", memo=False, **kw).unet)
    assert load_models("tiny", **kw).unet is b.unet


def test_the_per_instance_fields_are_the_jax_packages_and_every_other_field_splits_the_key():
    from textboost_tpu.train import aot

    assert graph._PER_INSTANCE_FIELDS == aot._PER_INSTANCE_FIELDS
    cfg = TrainConfig(instance_data_dir="a", instance_token="<x>", initializer_token="dog",
                      output_dir="o", model_preset="tiny")
    spec = pretrained.get_spec("tiny")

    def key(**change):
        return graph._memo_key("step", types.SimpleNamespace(**{**dataclasses.asdict(cfg),
                                                                **change}),
                               spec, "cpu", torch.float32, 1001, 999, None)

    base = key()
    assert base == graph._memo_key("step", cfg, spec, "cpu", torch.float32, 1001, 999, None)
    for field in dataclasses.fields(TrainConfig):
        value = getattr(cfg, field.name)
        other = (not value if isinstance(value, bool) else value + 1
                 if isinstance(value, (int, float)) else ["x"] if isinstance(value, list)
                 else f"{value}x")
        assert (key(**{field.name: other}) == base) == (
            field.name in graph._PER_INSTANCE_FIELDS), field.name
    for extra in ((1002, 999, None), (1001, 998, None), (1001, 999, "capture turned off")):
        assert graph._memo_key("step", cfg, spec, "cpu", torch.float32, *extra) != base
    assert graph._memo_key("step", cfg, spec, "meta", torch.float32, 1001, 999, None) != base
    assert graph._memo_key("step", cfg, spec, "cpu", torch.bfloat16, 1001, 999, None) != base


def _flags(data, out, name):
    return ["--model_preset=tiny", f"--instance_data_dir={os.path.join(data, name)}",
            f"--output_dir={os.path.join(out, name)}", f"--placeholder_token=<{name}>",
            f"--initializer_token={INSTANCES[name]}", "--max_train_steps=3",
            "--train_batch_size=2", "--resolution=64", "--checkpointing_steps=0",
            "--validation_steps=0", "--lr_scheduler=cosine", "--lr_warmup_steps=1",
            "--learning_rate=1e-2", "--augment=pda", "--augment_inversion", "--seed=5",
            "--report_to=none"]


def _spy(monkeypatch):
    """Each trainer's addresses at its first step, and every step's loss and
    learning rates."""
    runs = []
    real = trainer_mod.Trainer.run_step

    def run_step(self, batch, draws):
        if not runs or runs[-1]["trainer"] is not self:
            te = self.text_encoder
            runs.append({"trainer": self, "steps": [], "addresses": {
                "table": te.token_embedding.weight.data_ptr(),
                "lora": [p.data_ptr() for p in lora_parameters(te)],
                "null": self.null_embedding.data_ptr(),
                "frozen": self.frozen_te.token_embedding.weight.data_ptr()}})
        metrics = real(self, batch, draws)
        opt = self.state.optimizer
        runs[-1]["steps"].append((float(metrics["loss"]), [float(g["lr"]) for g in
                                                           opt.param_groups]))
        runs[-1]["addresses"]["state"] = [t.data_ptr() for s in opt.state.values()
                                          for t in s.values()]
        return metrics

    monkeypatch.setattr(trainer_mod.Trainer, "run_step", run_step)
    return runs


def _logged(run_dir):
    """metrics.jsonl's records: their steps, losses, rates and norms (not the
    timings)."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k == "step" or "loss" in k or "lr" in k
             or "norm" in k} for r in records]


def _exports(run_dir):
    files = ["text_encoder/adapter_model.safetensors"] + sorted(
        f for f in os.listdir(run_dir) if f.endswith(".bin"))
    return {f: open(os.path.join(run_dir, f), "rb").read() for f in files}


@pytest.fixture(scope="module")
def sweep_runs(tmp_path_factory):
    """dog, clock, then cat (another vocabulary size) as one --sequential
    sweep through `run_job`, then clock and cat alone, each with the memos
    cleared; the trainers run without tensorboard, as on the card's machine."""
    root = tmp_path_factory.mktemp("memo_sweep")
    data = str(root / "data")
    for k, name in enumerate(INSTANCES):
        os.makedirs(os.path.join(data, name))
        img = np.random.default_rng(k).integers(0, 256, (80, 96, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(data, name, "0.png"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        _clear_memos(mp)
        runs = _spy(mp)
        for name in INSTANCES:
            sweep.run_job(_flags(data, str(root / "sweep"), name), sequential=True,
                          device="cpu")
        entries = list(graph._AOT_MEMO.values())
        memo_trainer = dict(runs[0]["trainer"].bundle.__dict__)
        alone = {}
        for name in ("clock", "cat"):
            _clear_memos(mp)
            sweep.run_job(_flags(data, str(root / name), name), sequential=True, device="cpu")
            alone[name] = runs[-1]
    for run in runs:
        del run["trainer"]
    return {"root": root, "sweep": dict(zip(INSTANCES, runs)), "alone": alone,
            "entries": entries, "bundle": memo_trainer}


def test_sequential_instances_bind_into_the_memos_entry(sweep_runs):
    dog, clock, cat = (sweep_runs["sweep"][n] for n in INSTANCES)
    assert clock["addresses"] == dog["addresses"]  # table, LoRA, null, frozen, optimizer state
    # Another vocabulary size misses: other tensors, and its entry replaces
    # the first (the memo keeps one).
    assert len(sweep_runs["entries"]) == 1 and not sweep_runs["entries"][0].busy
    assert sweep_runs["entries"][0].text_encoder.token_embedding.weight.data_ptr() == \
        cat["addresses"]["table"]
    assert cat["addresses"]["table"] != dog["addresses"]["table"]
    assert cat["addresses"]["lora"] != dog["addresses"]["lora"]


@pytest.mark.parametrize("name", ["clock", "cat"])
def test_an_instance_through_the_memo_equals_it_alone(sweep_runs, name):
    """Losses and learning rates at every step (the cosine schedule with
    its warm-up starts again), metrics.jsonl's records and the exported
    adapter and token bins, to the bit."""
    got, want = sweep_runs["sweep"][name], sweep_runs["alone"][name]
    assert got["steps"] == want["steps"] and len(got["steps"]) == 3
    assert got["steps"][0][1] != got["steps"][1][1]  # the schedule moves
    root = sweep_runs["root"]
    assert _exports(str(root / "sweep" / name)) == _exports(str(root / name / name))
    logged = _logged(str(root / "sweep" / name))
    assert logged == _logged(str(root / name / name))
    assert logged[-1]["step"] == 3 and "loss" in logged[-1]


def test_the_pristine_encoder_is_untouched_by_the_trainers(sweep_runs):
    """After three trainers grew, trained and exported over the entry, its
    pristine encoder still equals a fresh load."""
    kept = sweep_runs["bundle"]["frozen_text_encoder"]
    assert kept is not None
    fresh = load_models(None, preset="tiny", lora_rank=4, dtype=torch.float32, device="cpu",
                        seed=5, memo=False)
    assert _same_bits(kept, fresh.text_encoder)


def _pipe(path, reuse=None):
    return loading.load_textboost_pipeline(path, "tiny", dtype=torch.float32, device="cpu",
                                           reuse=reuse)


def _images(pipe):
    return pipe(["a photo of a <clock> dog", "a <cat> on the grass"], num_inference_steps=2,
                generator=torch.Generator().manual_seed(0))


def test_reuse_binds_in_place_when_the_geometry_matches(sweep_runs, monkeypatch):
    """dog, then clock (as many added rows): the same tensors; then cat
    (fewer rows): a new table; each instance's images equal a fresh load's."""
    _clear_memos(monkeypatch)
    root = str(sweep_runs["root"] / "sweep")
    pipe = _pipe(os.path.join(root, "dog"))
    te = pipe.text_encoder
    before = (te.token_embedding.weight.data_ptr(), [p.data_ptr() for p in lora_parameters(te)])
    for name, kept in (("clock", True), ("cat", False)):
        again = _pipe(os.path.join(root, name), reuse=pipe)
        assert again is pipe
        now = (te.token_embedding.weight.data_ptr(), [p.data_ptr() for p in lora_parameters(te)])
        assert (now == before) == kept and now[1] == before[1]
        got = _images(pipe)
        _clear_memos(monkeypatch)
        fresh = _pipe(os.path.join(root, name))
        assert fresh.unet is not pipe.unet
        np.testing.assert_array_equal(got, _images(fresh))
    # A fresh load over the memo's base computes the null embedding from its
    # pristine encoder, whatever the last taker bound into its own copy.
    first = _pipe(os.path.join(root, "dog"))
    second = _pipe(os.path.join(root, "clock"))
    assert second.unet is first.unet and second.text_encoder is not first.text_encoder
    np.testing.assert_array_equal(second.null_embedding, first.null_embedding)


def test_the_memo_keeps_one_entry_and_releases_what_it_evicts(monkeypatch):
    """A new key evicts the entry before it: released at once when no
    trainer holds it, when it is handed back when one does."""
    _clear_memos(monkeypatch)
    released = []
    monkeypatch.setattr(graph, "_release", released.append)

    def entry():
        return graph.MemoEntry(*[None] * 9)

    a, b, c = entry(), entry(), entry()
    graph.memo_put("a", a)
    graph.memo_give_back("a", a)
    assert graph.memo_take("a") is a and graph.memo_take("a") is None  # taken
    graph.memo_give_back("a", a)
    graph.memo_put("b", b)  # a is free: released now
    assert released == [a] and list(graph._AOT_MEMO) == ["b"]
    graph.memo_put("c", c)  # b is still taken: released when handed back
    assert released == [a] and list(graph._AOT_MEMO) == ["c"]
    graph.memo_give_back("b", b)
    assert released == [a, b]
    graph.memo_give_back("c", c)
    assert released == [a, b] and graph.memo_take("c") is c


def _instance_dirs(root, rows):
    """Instance dirs of the benchmark's first instances, each with its
    number of {token}.bin rows."""
    from textboost_torch.eval.dreambooth_bench import INSTANCES as BENCH

    names = list(BENCH)[:len(rows)]
    for name, n in zip(names, rows):
        os.makedirs(root / name)
        for i in range(n):
            torch.save({f"<{name}_{i}>": torch.zeros(8)}, root / name / f"{name}_{i}.bin")
    return names


# Each case: the instances' added rows, seeds, device, distributed, and each
# run's captured chunk batches.
EVAL_CASES = {
    "benchmark": ([2] * 30, 4, "cuda", False, [[16, 9]]),  # 120 calls of each chunk
    "one_short": ([2] * 8, 4, "cuda", False, [[]]),  # 32 calls: one short of paying back
    "enough": ([2] * 9, 4, "cuda", False, [[16, 9]]),
    "cpu": ([2] * 30, 4, "cpu", False, [[]]),
    "distributed": ([2] * 30, 4, "cuda", True, [[]]),  # ranks under torch.distributed
    "alternating": ([2, 3] * 15, 4, "cuda", False, [[]] * 30),  # runs of one: 4 calls
    "two_runs": ([2] * 9 + [3] * 9, 4, "cuda", False, [[16, 9], [16, 9]]),
    "second_run_short": ([3] * 9 + [1] * 8, 4, "cuda", False, [[16, 9], []]),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_the_eval_captures_the_signatures_a_run_calls_often_enough(tmp_path, case):
    """The reused pipeline keeps its graphs across consecutive instances
    that add as many rows: the eval counts each such run's calls of a
    signature, and captures those called VALIDATION_CAPTURE_ROUNDS times."""
    from textboost_torch import graphs
    from textboost_torch.eval.dreambooth_bench import INSTANCES as BENCH

    rows, seeds, device, distributed, captured = EVAL_CASES[case]
    names = _instance_dirs(tmp_path, rows)
    args = eval_cli.parse_args([str(tmp_path), "--seeds", *map(str, range(seeds))])
    runs = eval_cli.planned_runs(args, dict(BENCH), 64)
    assert sum((run for run, _ in runs), []) == names and len(runs) == len(captured)
    assert graphs.VALIDATION_CAPTURE_ROUNDS == 33

    def key(batch):
        return graphs.sampler_key(batch, 512, 512, 25, eval_cli.GUIDANCE, eval_cli.SAMPLER)

    for (run, calls), want in zip(runs, captured):
        assert calls == {key(16): seeds * len(run), key(9): seeds * len(run)}
        got = eval_cli.sampler_signatures(calls, torch.device(device), distributed=distributed)
        assert got == [key(b) for b in want]
        assert all(k == (b, 512, 512, 25, True, "dpm++2m", 7.5) for k, b in zip(got, want))


def test_the_eval_gives_each_run_its_graphs_and_calls_them_by_their_key(tmp_path, monkeypatch):
    """`generate` names a run's signatures to the pipeline at the run's
    first instance, and every call it makes is looked up by the key it
    named (graphs.sampler_key of the call's own arguments)."""
    from textboost_torch import graphs

    _instance_dirs(tmp_path, [2] * 9 + [3] * 2)
    calls = []

    class Pipe:
        graphs = None

        def release_graphs(self):
            if self.graphs is not None:
                self.graphs.release()

        def __call__(self, prompts, *, num_inference_steps, guidance_scale, sampler, latents,
                     height, width):
            calls.append((graphs.sampler_key(len(prompts), height, width, num_inference_steps,
                                             guidance_scale, sampler),
                          None if self.graphs is None else set(self.graphs.signatures)))
            return np.zeros((len(prompts), 8, 8, 3), np.uint8)

    pipe = Pipe()
    monkeypatch.setattr(loading, "load_textboost_pipeline", lambda *a, **k: pipe)
    # The rule as on a card: this host's CPU would make every run eager.
    real = eval_cli.sampler_signatures
    monkeypatch.setattr(eval_cli, "sampler_signatures",
                        lambda calls, device, distributed=False: real(calls, "cuda", distributed))
    eval_cli.generate(eval_cli.parse_args([str(tmp_path), "--model", "tiny", "--outdir",
                                           str(tmp_path / "out"), "--device", "cpu"]))
    first, second = calls[:9 * 4 * 2], calls[9 * 4 * 2:]
    assert len(second) == 2 * 4 * 2
    assert all(named == {key for key, _ in first} and key in named for key, named in first)
    assert all(named is None for _, named in second)  # 8 calls a signature: eager
