"""Data-parallel generation of the port over torch.distributed, on the CPU
(two gloo ranks at `tiny`, fp32).

One `python -m torch.distributed.run --nproc_per_node 2` launch runs, in
each rank, `textboost_torch.inference` over seeds 0-3 (they divide: each
rank samples its contiguous half), over seeds 0-2 (they do not: rank 0
samples them all), then `textboost_torch.eval` over two instances at
--batch-size 4 (sub-chunks of 2 a rank, the base reused across instances,
5 prompts an instance so that the tail chunk leaves rank 1 idle).  This
file is the ranks' program (`python -m test_torch_port_dp_generate
<dir>`): it records, with chip_smoke's audit hook, every path each rank
opens for writing or makes under the run's dir.

Held, as the equality rules of the slice state them: each rank's images
are bit-identical to a one-process run over the same sub-batch (inference:
that rank's seeds; eval: --batch-size 2), and the eval's CSV is identical
to that run's; rank 0 alone writes.
"""
import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_dp import _start, _wait
from textboost_torch import inference
from textboost_torch.eval import __main__ as port_eval
from textboost_torch.eval import dreambooth_bench
from textboost_torch.lora.peft_io import export_lora_adapter, export_token_embeddings
from textboost_torch.models.pretrained import load_models
from textboost_torch.parallel import mesh

PROMPTS = 5  # of each instance's 25: chunks of 4 and 1 at --batch-size 4
INSTANCES = ("clock", "dog")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _short_prompts():
    full = dreambooth_bench.prompts_for
    return lambda instance: full(instance)[:PROMPTS]


def _write_model_dir(path, seed):
    """A trained-looking tiny model dir: LoRA B off zero, one learned row."""
    bundle = load_models("tiny", lora_rank=4, dtype=torch.float32, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in bundle.text_encoder.text_model.encoder.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                proj.lora_B.weight.normal_(0.0, 0.2, generator=gen)
    export_lora_adapter(bundle.text_encoder, os.path.join(path, "text_encoder"), rank=4,
                        base_model_name="tiny")
    name = os.path.basename(path)
    export_token_embeddings(torch.randn(1, 64, generator=gen) * 0.3, {f"<{name}>": 0}, path)


def _inference_argv(model_dir, seeds, *extra):
    return [model_dir, "--model", "tiny", "--prompt", "photo of a <clock> clock", "--seeds",
            *map(str, seeds), "--steps", "2", "--device", "cpu", *extra]


def _eval_argv(root, batch, desc):
    return [os.path.join(root, "sweep"), "--model", "tiny", "--seeds", "0", "--steps", "2",
            "--batch-size", str(batch), "--outdir", os.path.join(root, "out", "bench"),
            "--output-desc", desc, "--metric", "clip-t", "clip-i", "dino",
            "--allow-random-scorers", "--train-dir", os.path.join(root, "train"),
            "--val-dir", os.path.join(root, "val"), "--device", "cpu"]


def _rank_program(root):
    """One rank of the launch: the jobs of `root/jobs.json` in order, then
    what this rank wrote under `root` (chip_smoke's audit hook) into
    `root/rank{r}.json`."""
    import chip_smoke

    torch.set_num_threads(1)
    dreambooth_bench.prompts_for = _short_prompts()
    with open(os.path.join(root, "jobs.json")) as f:
        jobs = json.load(f)
    with mesh.distributed("cpu") as backend:
        assert backend == "gloo"
        r = mesh.rank()
        writes = chip_smoke.record_writes(root)
        for entry, argv in jobs:
            if entry == "inference":
                inference.main(inference.parse_args(argv))
            else:
                port_eval.main(argv)
        mesh.barrier()
    written = sorted(set(writes))
    with open(os.path.join(root, f"rank{r}.json"), "w") as f:
        json.dump({"writes": written}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launch, and meanwhile the one-process runs it is held to."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("dpgen"))
    for i, instance in enumerate(INSTANCES):
        _write_model_dir(os.path.join(root, "sweep", instance), seed=3 + i)
        for sub, seed in (("train", 10), ("val", 20)):
            os.makedirs(os.path.join(root, sub, instance))
            Image.fromarray(np.random.default_rng(seed + i).integers(
                0, 256, (32, 32, 3), dtype=np.uint8)).save(os.path.join(root, sub, instance, "0.png"))
    model_dir = os.path.join(root, "sweep", "clock")
    grids = {n: os.path.join(root, "out", f"grid{n}.png") for n in (4, 3)}
    jobs = [["inference", _inference_argv(model_dir, range(4), "--output", grids[4])],
            ["inference", _inference_argv(model_dir, range(3), "--output", grids[3])],
            ["eval", _eval_argv(root, 4, "dp")]]
    with open(os.path.join(root, "jobs.json"), "w") as f:
        json.dump(jobs, f)
    launch = _start(2, ["-m", "test_torch_port_dp_generate", root], root)
    try:
        one = {key: inference.generate(inference.parse_args(_inference_argv(model_dir, seeds)))
               for key, seeds in (("01", (0, 1)), ("23", (2, 3)), ("012", (0, 1, 2)),
                                  ("0123", range(4)))}
        mp = pytest.MonkeyPatch()
        mp.setattr(dreambooth_bench, "prompts_for", _short_prompts())
        try:
            csv_one = port_eval.main(_eval_argv(root, 2, "one"))
        finally:
            mp.undo()
    finally:
        stdout = _wait(launch)
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"root": root, "one": one, "grids": grids, "csv_one": csv_one, "stdout": stdout,
            "ranks": ranks}


def _grid(path, n):
    from PIL import Image

    return np.stack(np.split(np.asarray(Image.open(path).convert("RGB")), n, axis=1))


def test_seeds_follow_the_jax_condition():
    assert inference.seeds_of_rank([5, 6, 7, 8], 2, 0) == ([5, 6], True)
    assert inference.seeds_of_rank([5, 6, 7, 8], 2, 1) == ([7, 8], True)
    assert inference.seeds_of_rank([5, 6, 7, 8], 4, 3) == ([8], True)
    assert inference.seeds_of_rank([5, 6, 7], 2, 0) == ([5, 6, 7], False)
    assert inference.seeds_of_rank([5, 6, 7], 2, 1) == ([], False)
    assert inference.seeds_of_rank([5, 6, 7], 1, 0) == ([5, 6, 7], False)


def test_rank_messages_are_read_from_interleaved_output(runs):
    import chip_smoke

    line = "torch.distributed: rank {} of 2 (local {} of 2), backend gloo, device cuda:{}"
    one, zero = line.format(1, 1, 1), line.format(0, 0, 0)
    # a message and its newline are two writes: rank 0's may land between rank 1's
    interleaved = f"x\n{one}{zero}\n\n[Gloo] Rank 0 is connected\n"
    assert chip_smoke.joined_ranks(interleaved) == [("1", "2", "gloo"), ("0", "2", "gloo")]
    assert sorted(chip_smoke.joined_ranks(runs["stdout"])) == [("0", "2", "gloo"),
                                                               ("1", "2", "gloo")]


def test_inference_ranks_equal_one_process_runs_of_their_seeds(runs):
    one = runs["one"]
    dp = _grid(runs["grids"][4], 4)
    assert dp.dtype == np.uint8 and dp.shape == (4, 128, 128, 3)
    assert np.array_equal(dp[:2], one["01"]) and np.array_equal(dp[2:], one["23"])
    assert "Sharding the 4 seeds over 2 ranks, 2 a rank" in runs["stdout"]
    # All four seeds in one batch: reported, not held (on a card the GPU
    # libraries pick their algorithms by batch size).
    gap = np.abs(dp.astype(np.int16) - one["0123"]).max()
    print(f"dp grid vs one batch of 4: largest uint8 gap {gap}")


def test_seeds_that_do_not_divide_are_sampled_by_rank_zero(runs):
    assert np.array_equal(_grid(runs["grids"][3], 3), runs["one"]["012"])
    assert "3 seeds do not divide over 2 ranks: rank 0 samples them all" in runs["stdout"]


def test_eval_ranks_equal_a_one_process_run_at_the_sub_batch(runs):
    from PIL import Image

    root = runs["root"]
    base = os.path.join(root, "out", "bench")
    dp, one = base + "/sweep_dp", base + "/sweep_one"
    assert "Sharding generation batches over 2 ranks: sub-chunks of 2 prompts" in runs["stdout"]
    for instance in INSTANCES:
        names = sorted(os.listdir(os.path.join(dp, "seed0", instance)))
        assert len(names) == PROMPTS
        assert names == sorted(os.listdir(os.path.join(one, "seed0", instance)))
        for name in names:
            a, b = (np.asarray(Image.open(os.path.join(d, "seed0", instance, name)))
                    for d in (dp, one))
            assert np.array_equal(a, b), (instance, name)
    with open(os.path.join(root, "sweep", "metric_last_dp.csv")) as f:
        got = f.read()
    with open(runs["csv_one"]) as f:
        want = f.read()
    rows = list(csv.reader(got.splitlines()))
    assert got == want and len(rows) == 2 and float(rows[1][1]) != 0.0


def test_rank_one_writes_nothing(runs):
    rank0, rank1 = (r["writes"] for r in runs["ranks"])
    assert rank1 == []
    assert {"out/grid4.png", "out/grid3.png", "sweep/metric_last_dp.csv"} <= set(rank0)
    assert sum(w.endswith(".png") and "sweep_dp" in w for w in rank0) == PROMPTS * len(INSTANCES)


if __name__ == "__main__":
    _rank_program(sys.argv[1])
