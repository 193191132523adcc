"""The JAX package's native formats read and written by the port without
flax: the msgpack codec, the native snapshot, the converted scorer trees.

  * utils/msgpack.py against flax.serialization (0.12): every form flax
    writes (ext 1 arrays of several dtypes and widths, bfloat16, ext 3
    scalars, maps and strings past their fix forms, bin32), decoded to
    flax's values and encoded to flax's bytes; the chunked form of a leaf
    over MAX_CHUNK_SIZE (lowered to 64 bytes on both sides) both ways;
  * models/convert.py's inverse of `state_dict_from_jax`, exactly, both
    ways, on the three parts at `tiny` (LoRA leaves included);
  * the native snapshot at `tiny`: the JAX package's `load_models` reads the
    port's `save_snapshot` into trees bit-equal to the port's weights, and
    its own `save_snapshot` of them writes the port's bytes; the port reads
    JAX-written dirs (with and without LoRA leaves, which both loaders pass
    over) into state dicts bit-equal to `state_dict_from_jax` of the trees,
    bf16 leaves bit for bit; training and sampling from the native dir give
    the bits they give from a diffusers dir of the same weights;
  * the scorer trees (`.msgpack`, `params/` `.safetensors`) the JAX
    package's converters write, for CLIP, DINO and the clip-flant5 parts:
    state dicts bit-equal to those read from the torch checkpoints, equal
    scores, the JAX package's precedence, and the port's inverse
    converters equal to the JAX converters.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from textboost_torch.eval import scorer_weights
from textboost_torch.eval.clip_scorer import TINY_CLIP, CLIPScorer
from textboost_torch.eval.dino import TINY_VIT, DINOScorer
from textboost_torch.models.convert import jax_tree_from_state_dict, state_dict_from_jax
from textboost_torch.models.pretrained import PARTS, load_models, save_snapshot
from textboost_torch.utils import msgpack

KINDS = {"text_encoder": "te_params", "unet": "unet_params", "vae": "vae_params"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _bits(x):
    """A leaf's bytes and dtype name (numpy, JAX or torch; bfloat16 too)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).rsplit(".", 1)[1]
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).contiguous().numpy() \
            .tobytes(), name, tuple(x.shape)
    arr = np.ascontiguousarray(np.asarray(x))
    return arr.tobytes(), arr.dtype.name, arr.shape


def _assert_trees_equal(got, want):
    a, b = _flat(got), _flat(want)
    assert sorted(a) == sorted(b), set(a) ^ set(b)
    for path in a:
        assert _bits(a[path]) == _bits(b[path]), path


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------
def _codec_tree():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    return {"params": {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": np.asarray(rng.standard_normal((2, 5)), jnp.bfloat16),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i32": rng.integers(-9, 9, (2, 3), dtype=np.int32),
        "u8_bin32": rng.integers(0, 255, 70000, dtype=np.uint8),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(3.5), "i64": np.int64(-70000), "b": np.bool_(True)},
        "a_key_longer_than_thirty_one_characters": np.arange(5, dtype=np.float64),
        "map16": {f"k{i}": np.full((2,), i, np.float32) for i in range(17)},
    }}


@pytest.mark.parametrize("chunked", [False, True], ids=["plain", "chunked"])
def test_codec_matches_flax_byte_streams(monkeypatch, tmp_path, chunked):
    import flax.serialization as fs

    if chunked:  # every leaf over 64 bytes goes in chunks of 64
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = _codec_tree()
    flax_bytes = fs.msgpack_serialize(tree)
    assert (b"__msgpack_chunked_array__" in flax_bytes) == chunked
    path = tmp_path / "tree.msgpack"
    path.write_bytes(flax_bytes)
    got = msgpack.load(str(path))
    assert got["params"]["bf16"].dtype == torch.bfloat16
    assert isinstance(got["params"]["scalars"]["i64"], np.int64)
    _assert_trees_equal(got, tree)
    # The port's encoding of flax's tree, and of its own decoded one, is
    # flax's byte stream; flax reads it back.
    assert msgpack.dumps(tree) == flax_bytes
    assert msgpack.dumps(got) == flax_bytes
    _assert_trees_equal(fs.msgpack_restore(msgpack.dumps(got)), tree)


def test_codec_refuses_what_flax_trees_do_not_hold(tmp_path):
    import flax.serialization as fs

    with pytest.raises(ValueError, match="ext type 2 .native_complex"):
        msgpack.loads(fs.msgpack_serialize({"c": complex(1, 2)}))
    with pytest.raises(ValueError, match="bytes follow"):
        msgpack.loads(fs.msgpack_serialize({"a": 1}) + b"\x00")
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(fs.msgpack_serialize({"a": np.zeros(64, np.float32)})[:-8])
    with pytest.raises(ValueError, match="cut.msgpack is not a flax msgpack tree"):
        msgpack.load(str(cut))
    with pytest.raises(TypeError, match="set has no flax msgpack form"):
        msgpack.dumps({"a": {1, 2}})


# ---------------------------------------------------------------------------
# The native snapshot
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_bundle():
    return load_models("tiny", lora_rank=4, dtype=torch.float32, device="cpu", seed=5)


def _base_state(module):
    return {k: v for k, v in module.state_dict().items() if ".lora_" not in k}


@pytest.fixture(scope="module")
def port_native(port_bundle, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native") / "port")
    save_snapshot(port_bundle, root)
    return root


@pytest.fixture(scope="module")
def jax_read(port_native):
    """The JAX package's `load_models` of the port's dir (fp32, no LoRA)."""
    import jax.numpy as jnp

    from textboost_tpu.models.pretrained import load_models as jax_load_models

    return jax_load_models(port_native, dtype=jnp.float32)


def _with_lora_leaves(te_params, seed=0):
    """A copy of a JAX text-encoder tree with LoRA leaves beside q/k/v, as
    the JAX package's trees carry them at lora_rank 4."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, leaf in _flat(te_params).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(leaf)
        if path[-2:-1] in (("q_proj",), ("k_proj",), ("v_proj",)) and path[-1] == "kernel":
            d_in, d_out = np.shape(leaf)
            node["lora_a"] = rng.standard_normal((d_in, 4)).astype(np.float32)
            node["lora_b"] = rng.standard_normal((4, d_out)).astype(np.float32)
    return tree


@pytest.mark.parametrize("kind", PARTS)
def test_the_inverse_converter_round_trips(port_bundle, jax_read, kind):
    tree = getattr(jax_read, KINDS[kind])
    if kind == "text_encoder":
        tree = _with_lora_leaves(tree)
    sd = state_dict_from_jax(kind, tree)
    _assert_trees_equal(jax_tree_from_state_dict(kind, sd), tree)
    state = getattr(port_bundle, kind).state_dict()  # the text encoder's LoRA included
    _assert_state_equal(state_dict_from_jax(kind, jax_tree_from_state_dict(kind, state)), state)


def test_jax_reads_the_ports_native_snapshot(port_bundle, port_native, jax_read, tmp_path):
    from textboost_tpu.models.pretrained import save_snapshot as jax_save_snapshot

    assert jax_read.spec.name == "tiny"
    for kind, attr in KINDS.items():
        want = jax_tree_from_state_dict(kind, _base_state(getattr(port_bundle, kind)))
        _assert_trees_equal(getattr(jax_read, attr), want)
    # The JAX package's own save of those trees writes the port's bytes.
    jax_save_snapshot(jax_read, str(tmp_path))
    for name in ("spec.json",) + tuple(f"{p}.msgpack" for p in PARTS):
        with open(os.path.join(port_native, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def diffusers_dir(port_bundle, tmp_path_factory):
    """A diffusers snapshot of the port's weights (with a BPE tokenizer)."""
    root = str(tmp_path_factory.mktemp("diffusers") / "snap")
    chip_smoke.write_snapshot(root, {p: {k: v.numpy() for k, v in _base_state(
        getattr(port_bundle, p)).items()} for p in PARTS})
    return root


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_the_port_reads_a_jax_written_native_snapshot(jax_read, diffusers_dir, tmp_path,
                                                      lora_rank):
    """The JAX package's `save_snapshot` of a bundle whose text encoder
    carries LoRA leaves (as its trees do at lora_rank 4): the port passes
    over them, as JAX's loader does, and its adapters keep their fresh
    init, those of a load from a diffusers dir of the same weights."""
    import dataclasses

    from textboost_tpu.models.pretrained import save_snapshot as jax_save_snapshot

    bundle = dataclasses.replace(jax_read, te_params=_with_lora_leaves(jax_read.te_params))
    jax_save_snapshot(bundle, str(tmp_path))
    port = load_models(str(tmp_path), preset="sd15", lora_rank=lora_rank, dtype=torch.float32,
                       device="cpu")
    assert port.spec.name == "tiny"  # spec.json names the spec, not the preset
    ref = load_models(diffusers_dir, preset="tiny", lora_rank=lora_rank, dtype=torch.float32,
                      device="cpu")
    for kind, attr in KINDS.items():
        tree = {"params": {k: v for k, v in getattr(jax_read, attr)["params"].items()}}
        _assert_state_equal(_base_state(getattr(port, kind)), state_dict_from_jax(kind, tree))
        _assert_state_equal(getattr(port, kind).state_dict(), getattr(ref, kind).state_dict())


def test_bf16_leaves_load_bit_for_bit(jax_read, tmp_path):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from textboost_tpu.models.pretrained import save_snapshot as jax_save_snapshot

    cast = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, jnp.bfloat16), t)
    bundle = dataclasses.replace(jax_read, **{a: cast(getattr(jax_read, a)) for a in KINDS.values()})
    jax_save_snapshot(bundle, str(tmp_path))
    port = load_models(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    for kind, attr in KINDS.items():
        tree = msgpack.load(str(tmp_path / f"{kind}.msgpack"))
        assert all(v.dtype == torch.bfloat16 for v in _flat(tree).values())
        state = getattr(port, kind).state_dict()
        for key, want in state_dict_from_jax(kind, getattr(bundle, attr)).items():
            # GroupNorm affines stay fp32 in the port: the bf16 value, widened.
            assert torch.equal(state[key], want.to(state[key].dtype)), key
            assert torch.equal(state[key].bfloat16(), want.bfloat16()), key


def test_training_and_sampling_from_the_native_dir_equal_the_diffusers_dir(
        port_native, diffusers_dir, tmp_path, monkeypatch):
    from PIL import Image

    from textboost_torch import inference
    from textboost_torch.lora.peft_io import import_token_embeddings
    from textboost_torch.models import convert
    from textboost_torch.train import main as train_main

    native = str(tmp_path / "native")
    shutil.copytree(port_native, native)
    shutil.copytree(os.path.join(diffusers_dir, "tokenizer"), os.path.join(native, "tokenizer"))
    (tmp_path / "instance").mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(
        tmp_path / "instance" / "a.png")
    monkeypatch.setitem(convert.FAMILY_BY_WIDTH, 64, "tiny")  # the diffusers dir's width
    outs, images = {}, {}
    for name, base in (("native", native), ("diffusers", diffusers_dir)):
        outs[name] = out = str(tmp_path / f"out_{name}")
        metrics = train_main([
            "--device", "cpu", "--pretrained_model_name_or_path", base, "--model_preset", "tiny",
            "--instance_data_dir", str(tmp_path / "instance"), "--output_dir", out,
            "--placeholder_token", "<v*>", "--initializer_token", "dog", "--max_train_steps", "2",
            "--train_batch_size", "1", "--resolution", "64", "--checkpointing_steps", "0",
            "--learning_rate", "1e-2", "--report_to", "none", "--mixed_precision", "no"])
        assert metrics["steps"] == 2 and np.isfinite(metrics["loss"])
        images[name] = inference.generate(inference.parse_args(
            [out, "--model", base, "--prompt", "photo of a <v*>", "--seeds", "0", "1",
             "--steps", "2", "--device", "cpu"]))
    keys = ("step", "loss", "den_loss", "kpl", "grad_norm", "added_embedding_norm")
    logs = {}
    for name, out in outs.items():
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logs[name] = [[json.loads(line).get(k) for k in keys] for line in f]
    assert logs["native"] == logs["diffusers"] and len(logs["native"]) >= 2
    with open(os.path.join(outs["native"], "text_encoder", "adapter_model.safetensors"), "rb") as a, \
            open(os.path.join(outs["diffusers"], "text_encoder", "adapter_model.safetensors"),
                 "rb") as b:
        assert a.read() == b.read()
    rows = [import_token_embeddings([os.path.join(o, "v*.bin")]) for o in outs.values()]
    assert np.array_equal(rows[0]["<v*>"], rows[1]["<v*>"])
    assert images["native"].shape == (2, 128, 128, 3)
    assert np.array_equal(images["native"], images["diffusers"])


# ---------------------------------------------------------------------------
# The scorer trees
# ---------------------------------------------------------------------------
def _hf_weights(part, tmp_path, seed):
    """(the torch checkpoint's path or weights dir, its state dict as numpy)
    of one scorer part at the tiny geometry, written by transformers."""
    from test_torch_port_eval import _hf_clip, _hf_dinov2, _hf_vqa_parts

    if part == "vqa":
        wdir, sds = _hf_vqa_parts(tmp_path, seed)
        return wdir, sds
    hf = _hf_clip(TINY_CLIP, seed) if part == "clip" else _hf_dinov2(TINY_VIT, seed)
    path = str(tmp_path / "torch" / part)
    hf.save_pretrained(path)
    return path, {k: v.numpy() for k, v in hf.state_dict().items()}


def _jax_trees(part, sd):
    """The JAX package's converters' trees of a torch state dict:
    {file stem: tree}."""
    import jax
    import jax.numpy as jnp

    from textboost_tpu.eval import clip_scorer as jax_clip
    from textboost_tpu.eval import dino as jax_dino
    from textboost_tpu.eval import vqa as jax_vqa
    from textboost_tpu.eval.scorer_weights import (
        convert_clip_model,
        convert_clip_vision,
        convert_dinov2,
        convert_mm_projector,
        convert_t5,
    )

    if part == "clip":
        cfg = jax_clip.TINY_CLIP
        template = jax.eval_shape(jax_clip.CLIPModel(cfg).init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 77), jnp.int32),
                                  jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3)))
        return {"clip": convert_clip_model(sd, template)}
    if part == "dino":
        cfg = jax_dino.TINY_VIT
        template = jax.eval_shape(jax_dino.ViTFeatures(cfg).init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
        return {"dino": convert_dinov2(sd, template)}
    template = jax_vqa.CLIPT5Model(*jax_vqa._tiny_vqa_config()).shape_template()
    return {"t5": convert_t5(sd["t5"], template["t5"]),
            "vision": convert_clip_vision(sd["vision"], template["vision"]),
            "projector": convert_mm_projector(sd["projector"], template["projector"])}


def _write_trees(trees, root, form):
    """Each tree as the JAX package writes it: `save_converted` (flax
    msgpack) or the streaming converter's `params/` safetensors."""
    from flax.traverse_util import flatten_dict

    from textboost_tpu.eval.scorer_weights import save_converted, stream_convert_to_safetensors

    os.makedirs(root, exist_ok=True)
    for stem, tree in trees.items():
        if form == "msgpack":
            save_converted(tree, os.path.join(root, f"{stem}.msgpack"))
        else:
            flat = flatten_dict(tree["params"])
            stream_convert_to_safetensors(tree, lambda k, flat=flat: np.asarray(flat[k]),
                                          os.path.join(root, f"{stem}.safetensors"))


def _images(seed, n, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("form", ["msgpack", "safetensors"])
@pytest.mark.parametrize("part", ["clip", "dino", "vqa"])
def test_scorer_trees_load_bit_equal_to_the_torch_checkpoints(tmp_path, part, form):
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.eval.vqa import NativeVQAScorer

    path, sd = _hf_weights(part, tmp_path, seed=7)
    tree_dir = str(tmp_path / "trees")
    _write_trees(_jax_trees(part, sd), tree_dir, form)
    imgs, prompts = _images(1, 3), ["a dog in the jungle", "a red clock", "a teapot"]
    if part == "vqa":
        shutil.copy(os.path.join(path, "config.json"), tree_dir)
        from_tree, from_torch = (NativeVQAScorer(d, device="cpu") for d in (tree_dir, path))
        _assert_state_equal(from_tree.model.state_dict(), from_torch.model.state_dict())
        assert np.array_equal(from_tree.score_pairs(imgs, prompts),
                              from_torch.score_pairs(imgs, prompts))
        return
    weights = scorer_weights.part_weights(os.path.join(tree_dir, part), part)
    if part == "clip":
        ref = scorer_weights.clip_weights(path)
        scorers = [CLIPScorer(TINY_CLIP, weights=w, device="cpu") for w in (weights, ref)]
        tok = load_tokenizer(None)
        assert scorers[0].clip_t(tok, imgs, prompts) == scorers[1].clip_t(tok, imgs, prompts)
        assert scorers[0].clip_i(imgs, imgs[:2]) == scorers[1].clip_i(imgs, imgs[:2])
    else:
        ref = scorer_weights.dino_weights(path)
        scorers = [DINOScorer(TINY_VIT, weights=w, device="cpu") for w in (weights, ref)]
        assert scorers[0].dino_score(imgs, imgs[:2]) == scorers[1].dino_score(imgs, imgs[:2])
    _assert_state_equal(*(s.model.state_dict() for s in scorers))


def test_trees_are_read_in_the_jax_packages_precedence(tmp_path):
    """<part>.safetensors of params/ names, then <part>.msgpack, then the
    torch checkpoint; a transformers .safetensors is a torch checkpoint."""
    from textboost_torch.lora.peft_io import save_safetensors

    (path, a), (_, b), (_, c) = (_hf_weights("clip", tmp_path / str(s), seed=s) for s in (1, 2, 3))
    base = str(tmp_path / "w" / "clip")
    os.makedirs(os.path.dirname(base))
    state = lambda w: {k: w[k] for k in w}
    shutil.copytree(path, base)
    _assert_state_equal(state(scorer_weights.part_weights(base, "clip")),
                        state(scorer_weights.clip_weights(path)))
    _write_trees(_jax_trees("clip", b), os.path.dirname(base), "msgpack")
    got = state(scorer_weights.part_weights(base, "clip"))
    assert torch.equal(got["visual_projection.weight"],
                       torch.from_numpy(b["visual_projection.weight"]))
    _write_trees(_jax_trees("clip", c), os.path.dirname(base), "safetensors")
    got = state(scorer_weights.part_weights(base, "clip"))
    assert torch.equal(got["visual_projection.weight"],
                       torch.from_numpy(c["visual_projection.weight"]))
    # A transformers .safetensors beside no tree is the torch checkpoint.
    other = str(tmp_path / "x" / "clip")
    os.makedirs(os.path.dirname(other))
    save_safetensors(a, other + ".safetensors")
    assert scorer_weights.resolve(other) == other + ".safetensors"
    assert scorer_weights.read_jax_tree(other) is None


def test_the_ports_inverse_scorer_converters_are_the_jax_converters(tmp_path):
    for part, inverse in (("clip", scorer_weights.clip_tree_from_state_dict),
                          ("dino", scorer_weights.dino_tree_from_state_dict)):
        path, sd = _hf_weights(part, tmp_path, seed=4)
        read = scorer_weights.clip_weights if part == "clip" else scorer_weights.dino_weights
        state = dict(read(path).items())
        _assert_trees_equal(inverse(state), _jax_trees(part, sd)[part])
