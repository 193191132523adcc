"""The port's paired augmentation held against the JAX package.

The native image ops (the port's own copy of image_ops.cpp, built into
textboost_torch/csrc/build/) against the JAX package's build and against
PIL; every augmentation op's plan and pixels, the `PairedAugmentation`
stream with and without inversion, and the tokens the trainer adds for
--augment_inversion, against the JAX package's functions on the same seeds.
Images and captions must agree byte for byte.
"""
import threading

import numpy as np
import pytest
from PIL import Image

from textboost_tpu.data import augment as jax_augment
from textboost_tpu.data import native as jax_native
from textboost_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from textboost_tpu.tokens import surgery as jax_surgery
from textboost_torch.data import augment, native
from textboost_torch.data.tokenizer import HashTokenizer
from textboost_torch.train.trainer import plan_tokens

OPS = ["adjust_scale", "rotate", "horizontal_flip", "horizontal_translate",
       "adjust_brightness", "grayscale", "crop", "jpeg_compression", "square_photo_collage"]
# Both banks of PairedAugmentation ("object" and "style") and the two ops
# neither bank uses.
BANKS = {"object": ["adjust_scale", "crop", "horizontal_translate", "grayscale",
                    "square_photo_collage", "horizontal_flip"],
         "style": ["grayscale", "horizontal_flip"]}


def _image(seed, w=96, h=80):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2, yy * 3, (xx + yy)], axis=-1) % 256
    noise = rng.integers(0, 64, (h, w, 3))
    return Image.fromarray(((base + noise) % 256).astype(np.uint8))


def _bicubic_cases():
    """The 25 seeded cases of tests/test_native.py::test_affine_bicubic_matches_pil."""
    rng = np.random.default_rng(3)
    for _ in range(25):
        w, h = int(rng.integers(8, 90)), int(rng.integers(8, 90))
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        inv = 1.0 / rng.uniform(0.3, 2.0)
        pad_w, pad_h = int(rng.integers(0, 25)), int(rng.integers(0, 25))
        pw, ph = w + 2 * pad_w, h + 2 * pad_h
        m2 = inv * (-pw * 0.5) + pw * 0.5 + rng.uniform(-3, 3)
        m5 = inv * (-ph * 0.5) + ph * 0.5 + rng.uniform(-3, 3)
        out_w, out_h = int(rng.integers(4, w + 8)), int(rng.integers(4, h + 8))
        yield src, pad_w, pad_h, out_w, out_h, inv, m2, m5


def test_native_bicubic_is_bit_exact_with_the_jax_build_and_pil():
    assert native.library_path().parent.name == "build"
    assert native.library_path().parent.parent.name == "csrc"
    for src, pad_w, pad_h, out_w, out_h, inv, m2, m5 in _bicubic_cases():
        padded = np.pad(src, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)), mode="edge")
        pil = np.asarray(Image.fromarray(padded).transform(
            (out_w, out_h), Image.AFFINE, (inv, 0, m2, 0, inv, m5), resample=Image.BICUBIC))
        got = native.affine_scale_bicubic(src, pad_w, pad_h, out_w, out_h, inv, m2, inv, m5)
        want = jax_native.affine_scale_bicubic(src, pad_w, pad_h, out_w, out_h, inv, m2, inv, m5)
        np.testing.assert_array_equal(got, pil)
        np.testing.assert_array_equal(got, want)


def test_native_normalize_matches_numpy():
    arr = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out = native.normalize_u8(arr)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, (arr.astype(np.float32) / 255.0 - 0.5) / 0.5, atol=1e-6)


def test_native_build_is_safe_to_race_and_raises_on_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1 and paths[0].is_file()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]  # no temporaries

    broken = tmp_path / "image_ops.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()


def test_adjust_scale_native_matches_its_pil_plain_version():
    image = _image(7)
    for trial in range(12):
        p, _ = augment.plan_adjust_scale(image.size, "x", False,
                                         np.random.default_rng((21, trial)), {})
        np.testing.assert_array_equal(np.asarray(augment.exec_adjust_scale(image, p)),
                                      np.asarray(augment.exec_adjust_scale_pil(image, p)))


@pytest.mark.parametrize("inversion", [False, True], ids=["captions", "inversion"])
@pytest.mark.parametrize("op", OPS)
def test_op_plans_pixels_and_captions_match_jax(op, inversion):
    captions = dict(augment.REFERENCE_CAPTION_MAP)
    planner, executor = augment._OP_IMPLS[getattr(augment, op)]
    jplanner, jexecutor = jax_augment._OP_IMPLS[getattr(jax_augment, op)]
    for seed in range(6):
        image = _image(seed, 96 - 8 * seed, 80 + 4 * seed)
        plan, prompt = planner(image.size, "a photo of <v*>", inversion,
                               np.random.default_rng((5, seed)), captions)
        jplan, jprompt = jplanner(image.size, "a photo of <v*>", inversion,
                                  np.random.default_rng((5, seed)), dict(captions))
        assert plan == jplan and prompt == jprompt
        got, want = executor(image.copy(), plan), jexecutor(image.copy(), jplan)
        assert got.size == want.size and got.mode == want.mode
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        # The wrapper draws the same numbers as plan + execute.
        out, wprompt = getattr(augment, op)(image.copy(), "a photo of <v*>", inversion,
                                            np.random.default_rng((5, seed)), captions)
        assert wprompt == prompt
        np.testing.assert_array_equal(np.asarray(out), np.asarray(got))


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_banks_hold_the_same_ops(bank):
    hflip = "inversion"
    pipe = augment.PairedAugmentation(hflip=hflip, ops=bank)
    jpipe = jax_augment.PairedAugmentation(hflip=hflip, ops=bank)
    names = sorted(op.__name__ for op in pipe.geometric_ops + pipe.color_ops + pipe.other_ops)
    jnames = sorted(op.__name__ for op in jpipe.geometric_ops + jpipe.color_ops + jpipe.other_ops)
    assert names == jnames == sorted(BANKS[bank])


def _token_plans(augment_ops):
    """(port plan_tokens, the JAX trainer's surgery, trainer.py:213-275,
    through the JAX package's functions) for one concept of three
    sub-tokens."""
    concepts = [{"instance_token": "<0>", "placeholder_token": "<teapot>",
                 "initializer_token": "brown teapot pot"}]
    port = plan_tokens(HashTokenizer(), concepts, "dog", augment_inversion=True,
                       augment_ops=augment_ops)
    tok = JaxHashTokenizer()
    token_to_id, caption_map, aug_tokens = {}, {}, []
    toks, pids, _ = jax_surgery.plan_token_addition(tok, "<teapot>", "brown teapot pot")
    token_to_id.update(zip(toks, pids))
    bank = (jax_surgery.OBJECT_AUGMENTATIONS if augment_ops == "object"
            else jax_surgery.STYLE_AUGMENTATIONS)
    for placeholder, initializer in bank.items():
        toks, pids, _ = jax_surgery.plan_token_addition(tok, placeholder, initializer)
        token_to_id.update(zip(toks, pids))
        aug_tokens += toks
        caption_map[placeholder] = " ".join(toks)
    return port, (token_to_id, caption_map, aug_tokens)


@pytest.mark.parametrize("augment_ops", ["object", "style"])
def test_augmentation_tokens_match_the_jax_surgery(augment_ops):
    port, (token_to_id, caption_map, aug_tokens) = _token_plans(augment_ops)
    assert port.token_to_id == token_to_id
    assert port.caption_map == caption_map
    assert port.aug_tokens == aug_tokens
    assert port.concept_tokens["<0>"] == "<teapot_0> <teapot_1> <teapot_2>"
    assert port.new_row_ids == list(range(49408, 49408 + len(token_to_id)))


@pytest.mark.parametrize("inversion", [False, True], ids=["captions", "inversion"])
def test_paired_augmentation_stream_matches_jax(inversion):
    caption_map = _token_plans("object")[0].caption_map if inversion else None
    kwargs = dict(hflip="inversion" if inversion else "false", inversion=inversion, p=0.5,
                  augment_prompt=True, ops="object", caption_map=caption_map, seed=0)
    pipe, jpipe = augment.PairedAugmentation(**kwargs), jax_augment.PairedAugmentation(**kwargs)
    image = _image(11, 64, 64)
    ops_seen = set()
    for i in range(64):
        steps, _ = pipe.plan(image.size, "a <v*>", np.random.default_rng((9, i)))
        ops_seen.update(p["op"] for p in steps)
        got, prompt, mask = pipe(image.copy(), "a <v*>", np.random.default_rng((9, i)))
        want, jprompt, jmask = jpipe(image.copy(), "a <v*>", np.random.default_rng((9, i)))
        assert prompt == jprompt and mask is None and jmask is None
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        if inversion:
            assert "zoom in" not in prompt and "photo collage" not in prompt
    # The stream exercises every op of the object bank.
    assert ops_seen == {"scale", "crop", "translate", "grayscale", "collage"} | (
        {"hflip"} if inversion else set())
