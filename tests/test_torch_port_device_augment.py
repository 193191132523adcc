"""The port's device augmentation (--augment_device), held against the JAX
package's executor and against the port's host PIL path.

At size 64, one batch of encoded plans that reaches every op goes through
the JAX `make_augment_fn` and the port's `augment_batch` on the same uint8
bank: the gathers must agree exactly, the resamplings within one uint8
level.  At size 96, each op against the host path at the JAX test's limits
(tests/test_device_augment.py).  Then the plans themselves: `encode_plan`,
the dataset's plan-only samples and `collate` byte-identical to the JAX
dataset's for one seed; and a 2-step run of the training CLI with
--augment_device --validation_scheduler DDIMScheduler.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from textboost_tpu.data import augment as jax_augment
from textboost_tpu.data import datasets as jax_datasets
from textboost_tpu.data import device_augment as jax_da
from textboost_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from textboost_torch.data import device_augment as da
from textboost_torch.data.augment import (
    REFERENCE_CAPTION_MAP,
    PairedAugmentation,
    exec_adjust_scale,
    exec_crop,
    exec_grayscale,
    exec_horizontal_translate,
    exec_square_photo_collage,
    plan_adjust_scale,
    plan_crop,
    plan_horizontal_translate,
)
from textboost_torch.data.datasets import TextBoostDataset, resize_shorter_side
from textboost_torch.data.tokenizer import load_tokenizer
from textboost_torch.samplers import solvers
from textboost_torch.train import main as train_main
from textboost_torch.train import trainer as trainer_mod

S = 64  # against the JAX executor
HS = 96  # against the host path, as the JAX test
EXACT = ("identity", "base_hflip", "hflip", "translate", "grayscale")
RESAMPLED = ("zoom", "crop", "collage2", "collage3", "plans")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases():
    """{case: [(steps, img_idx, top, left)]}: every op, from the non-square
    image (64 x 84) at several offsets and the square one."""
    captions = REFERENCE_CAPTION_MAP
    cases = {"identity": [([], 0, 0, 0), ([], 1, 0, 20)],
             "base_hflip": [([{"op": "base_hflip"}], 1, 0, 7)],
             "hflip": [([{"op": "hflip"}], 0, 0, 0), ([{"op": "hflip"}], 1, 0, 3)],
             "grayscale": [([{"op": "grayscale"}], 1, 0, 11)],
             "collage2": [([{"op": "collage", "axis": 2}], 0, 0, 0)],
             "collage3": [([{"op": "collage", "axis": 3}], 1, 0, 5)]}  # 64 % 3: the lanczos tail
    for name, planner in (("translate", plan_horizontal_translate), ("zoom", plan_adjust_scale),
                          ("crop", plan_crop)):
        cases[name] = [([planner((S, S), "p", True, np.random.default_rng((4, seed)),
                                 captions)[0]], seed % 2, 0, 3 * seed) for seed in range(5)]
    pipe = PairedAugmentation(hflip="inversion", inversion=True, p=0.9, ops="object", seed=0)
    cases["plans"] = [(pipe.plan((S, S), "a <x>", np.random.default_rng((9, trial)))[0],
                       trial % 2, 0, trial) for trial in range(16)]
    return cases


@pytest.fixture(scope="module")
def executed():
    """(cases, JAX output, port output) of one batch holding every case."""
    rng = np.random.RandomState(0)
    bank = np.zeros((2, S, S + 20, 3), np.uint8)
    bank[0, :, :S] = rng.randint(0, 256, (S, S, 3))
    bank[1] = rng.randint(0, 256, (S, S + 20, 3))
    cases = _cases()
    rows = [(name, i) for name, items in cases.items() for i in range(len(items))]
    params = da.stack_aug_params([da.encode_plan(*cases[name][i][:1], S, *cases[name][i][1:])
                                  for name, i in rows])
    want = np.asarray(jax.jit(jax_da.make_augment_fn(S))(bank, params))
    got = da.augment_batch(torch.from_numpy(bank), params, S)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(rows), S, S, 3)
    return rows, want, got.numpy()


@pytest.mark.parametrize("case", EXACT + RESAMPLED)
def test_each_op_matches_the_jax_executor(executed, case):
    rows, want, got = executed
    idx = [k for k, (name, _) in enumerate(rows) if name == case]
    diff = np.abs(got[idx].astype(int) - want[idx].astype(int))
    assert diff.max() <= (0 if case in EXACT else 1), (case, diff.max())
    if case == "identity":  # the window at (0, 20) of the non-square image
        assert not np.array_equal(got[idx[0]], got[idx[1]])


@pytest.mark.parametrize("totals, usual", [([488, 488, 15], 488), ([504, 517, 517], 517),
                                           ([488, 488, 488, 517, 488, 488], 488),
                                           ([492, 517, 517, 492], 492)])
def test_a_call_s_operations_are_what_most_sessions_read(totals, usual):
    import chip_smoke

    assert chip_smoke.usual_count(totals) == usual


def _img(size=HS, seed=0):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (size, size, 3),
                                                               dtype=np.uint8))


def _device_apply(image, steps, size=None):
    size = size or image.size[0]
    params = da.stack_aug_params([da.encode_plan(steps, size, 0, 0, 0)])
    bank = torch.from_numpy(np.asarray(image, np.uint8)[None].copy())
    return da.augment_batch(bank, params, size)[0].numpy().astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_translate_is_the_host_path(seed):
    img = _img(seed=seed)
    p, _ = plan_horizontal_translate(img.size, "p", True, np.random.default_rng(seed),
                                     REFERENCE_CAPTION_MAP)
    np.testing.assert_array_equal(_device_apply(img, [p]),
                                  np.asarray(exec_horizontal_translate(img, p)))


def test_grayscale_and_flips_are_the_host_path():
    arr = np.random.RandomState(3).randint(0, 256, (64, 64, 3), dtype=np.uint8)
    arr[0, :3] = [(255, 255, 255), (0, 0, 0), (128, 128, 128)]
    img = Image.fromarray(arr)
    np.testing.assert_array_equal(_device_apply(img, [{"op": "grayscale"}]),
                                  np.asarray(exec_grayscale(img, {})))
    np.testing.assert_array_equal(_device_apply(img, []), arr)
    for op in ("base_hflip", "hflip"):
        np.testing.assert_array_equal(_device_apply(img, [{"op": op}]), arr[:, ::-1])


@pytest.mark.parametrize("seed", range(8))
def test_zoom_within_one_level_of_the_host_path(seed):
    img = _img(seed=seed)
    p, _ = plan_adjust_scale(img.size, "p", True, np.random.default_rng((5, seed)),
                             REFERENCE_CAPTION_MAP)
    diff = np.abs(_device_apply(img, [p]) - np.asarray(exec_adjust_scale(img, p)).astype(int))
    assert diff.max() <= 1, (p, diff.max())


@pytest.mark.parametrize("seed", range(8))
def test_crop_within_two_levels_of_the_host_path(seed):
    img = _img(seed=seed)
    p, _ = plan_crop(img.size, "p", True, np.random.default_rng((7, seed)), REFERENCE_CAPTION_MAP)
    diff = np.abs(_device_apply(img, [p]) - np.asarray(exec_crop(img, p)).astype(int))
    assert diff.max() <= 2, (p, diff.max())


@pytest.mark.parametrize("axis,size", [(2, 96), (3, 96), (2, 128), (3, 128)])
def test_collage_within_three_levels_of_the_host_path(axis, size):
    img = _img(size=size, seed=axis)
    p = {"op": "collage", "axis": axis}
    want = np.asarray(resize_shorter_side(exec_square_photo_collage(img, p), size)).astype(int)
    got = _device_apply(img, [p], size=size)
    assert got.shape == want.shape and np.abs(got - want).max() <= 3


def test_full_plans_match_the_host_path():
    """The same seeded stream gives the same caption, and pixels within 3
    levels (exact for plans without a resampling op) on a square image at
    the resolution."""
    img = _img(seed=42)
    pipe = PairedAugmentation(hflip="inversion", inversion=True, p=0.5, ops="object", seed=0)
    n_exact = 0
    for trial in range(24):
        host_img, host_prompt, _ = pipe(img, "a <x>", np.random.default_rng((99, trial)))
        want = np.asarray(resize_shorter_side(host_img, HS)).astype(int)
        steps, prompt = pipe.plan(img.size, "a <x>", np.random.default_rng((99, trial)))
        got = _device_apply(img, steps)
        assert prompt == host_prompt and got.shape == want.shape
        assert np.abs(got - want).max() <= 3, (steps, np.abs(got - want).max())
        n_exact += np.array_equal(got, want)
    assert n_exact >= 8


def test_launches_do_not_grow_with_the_batch():
    """Each op runs once over its samples: a batch of 16 that repeats a
    batch of 8 runs the same torch ops (counted by the profiler)."""
    bank = torch.from_numpy(np.asarray(_img(seed=1), np.uint8)[None].copy())
    pipe = PairedAugmentation(hflip="inversion", inversion=True, p=0.9, ops="object", seed=0)
    plans = [da.encode_plan(pipe.plan((HS, HS), "x", np.random.default_rng((3, i)))[0],
                            HS, 0, 0, 0) for i in range(8)]
    counts = []
    for batch in (plans, plans + plans):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            da.augment_batch(bank, da.stack_aug_params(batch), HS)
        counts.append(sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")))
    assert counts[0] == counts[1] > 0


def test_plans_and_batches_are_the_jax_datasets(tmp_path):
    """encode_plan, the plan-only samples (template, plan, crop offsets in
    the host path's draw order), the image bank and collate give the JAX
    dataset's bytes for one seed; a non-square image draws crop offsets."""
    inst = tmp_path / "inst"
    inst.mkdir()
    rng = np.random.RandomState(5)
    Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(inst / "a.png")
    Image.fromarray(rng.randint(0, 255, (80, 100, 3), dtype=np.uint8)).save(inst / "b.png")
    datasets = []
    for mod, aug, tok in ((jax_datasets, jax_augment, jax_load_tokenizer(None)),
                          (None, None, load_tokenizer(None))):
        cls = mod.TextBoostDataset if mod else TextBoostDataset
        pipe = (aug.PairedAugmentation if aug else PairedAugmentation)(
            hflip="inversion", inversion=True, p=0.8, ops="object", seed=0)
        datasets.append(cls([{"instance_data_dir": str(inst), "instance_token": "<v*>"}], tok,
                            template="imagenet_small", size=64, augment_pipe=pipe, seed=0,
                            device_augment=True))
    banks = [ds.build_image_bank() for ds in datasets]
    for a, b in zip(*banks):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert banks[1][0].shape == (2, 64, 80, 3)
    for step in range(4):
        samples = [[ds.__getitem__(i % 2, rng=np.random.default_rng((0, step, i)))
                    for i in range(6)] for ds in datasets]
        for js, ps in zip(*samples):
            assert set(ps["aug"]) == set(js["aug"]) == set(da.AUG_PARAM_FIELDS)
            for k in da.AUG_PARAM_FIELDS:
                assert ps["aug"][k].dtype == js["aug"][k].dtype
                assert ps["aug"][k].tobytes() == js["aug"][k].tobytes(), k
            assert ps["input_ids"].tobytes() == js["input_ids"].tobytes()
        jb, pb = jax_datasets.TextBoostDataset.collate(samples[0]), TextBoostDataset.collate(
            samples[1])
        assert pb["input_ids"].tobytes() == jb["input_ids"].tobytes()
        assert all(pb["aug"][k].tobytes() == jb["aug"][k].tobytes() for k in jb["aug"])
        assert pb["prompt"] == [s["prompt"] for s in samples[1]]
    lefts = [datasets[1].__getitem__(1, rng=np.random.default_rng((1, i)))["aug"]["left"]
             for i in range(8)]
    assert len(set(int(v) for v in lefts)) > 1
    steps = [{"op": "scale", "scale": 0.5, "pad_w": 32, "pad_h": 32}, {"op": "collage", "axis": 3},
             {"op": "grayscale"}, {"op": "base_hflip"}]
    for a, b in zip(da.encode_plan(steps, 64, 1, 2, 3).values(),
                    jax_da.encode_plan(steps, 64, 1, 2, 3).values()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for op in ({"op": "brightness", "factor": 1.4}, {"op": "jpeg", "quality": 50}):
        with pytest.raises(ValueError, match="no device executor"):
            da.encode_plan([op], 64, 0, 0, 0)


def test_param_schema_is_small():
    nbytes = sum(np.dtype(dt).itemsize for dt in da.AUG_PARAM_FIELDS.values())
    assert nbytes <= 80 and da.h2d_bytes(1) <= 80
    assert da.AUG_PARAM_FIELDS == jax_da.AUG_PARAM_FIELDS


def test_train_cli_with_device_augmentation_and_ddim_validation(tmp_path, monkeypatch):
    inst = tmp_path / "inst"
    inst.mkdir()
    rng = np.random.RandomState(6)
    Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(inst / "a.png")
    Image.fromarray(rng.randint(0, 255, (64, 96, 3), dtype=np.uint8)).save(inst / "b.png")
    calls = []
    real = trainer_mod.augment_batch

    def counted(bank, params, size):
        out = real(bank, params, size)
        calls.append((tuple(bank.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(trainer_mod, "augment_batch", counted)
    rounds = []
    ddim = solvers.SAMPLERS["DDIMScheduler"]
    monkeypatch.setitem(solvers.SAMPLERS, "DDIMScheduler",
                        lambda *a, **k: rounds.append(a[3]) or ddim(*a, **k))
    out = tmp_path / "out"
    metrics = train_main([
        "--device", "cpu", "--model_preset", "tiny", "--instance_data_dir", str(inst),
        "--output_dir", str(out), "--placeholder_token", "<v*>", "--initializer_token", "dog",
        "--max_train_steps", "2", "--train_batch_size", "2", "--resolution", "64",
        "--augment", "pda", "--augment_inversion", "--augment_p", "0.9", "--augment_device",
        "--validation_scheduler", "DDIMScheduler", "--validation_steps", "2",
        "--num_validation_images", "1", "--validation_prompts", "photo of a <0>",
        "--checkpointing_steps", "1", "--report_to", "none"])
    assert metrics["steps"] == 2 and np.isfinite(metrics["loss"])
    # One batch per step, and the next one made ahead; the bank holds both
    # images padded to the wider one's 96 columns.
    assert calls and set(calls) == {((2, 64, 96, 3), (2, 64, 64, 3))}
    assert rounds == [25]  # the validation round sampled with DDIM, 25 steps
    assert Image.open(out / "validation_2.jpg").size == (128, 128)  # the preset's resolution
    for name in ("checkpoint-1/state.pt", "text_encoder/adapter_model.safetensors", "v*.bin"):
        assert (out / name).is_file(), name
    records = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert records[-1]["step"] == 2
    assert os.path.getsize(out / "training.log") > 0
    assert metrics["aug:samples"] == 4.0
