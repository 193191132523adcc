"""The four training flags the port serves since the DB runner's slice,
held against the JAX package's `make_train_step` on the CPU at `tiny`.

`--unet_params_to_train crossattn_kv` (the UNet's cross-attention LoRA in
the LoRA group), `--with_image_prior` (class samples after the instance
ones, their MSE weighted in), `--text_encoder_use_attention_mask` (the
padded CLIP mask) each alone, and all together with
`--gradient_checkpointing` (JAX `remat=True`) and an augmentation mask.
Both packages start from the same seeded weights (the JAX trees converted
from the port's by the JAX package's own converters, over shape-only
templates, so no init program compiles), take the same batch and the same
draws (the port is handed the JAX step's threefry numbers).  Checkpointing
is also held bit-identical to the plain port step.  Then the class-prior
dataset and collate against the JAX package's, prior generation, the
`unet/` adapter against the JAX exporter and importer, and a 2 + 2 step
resume bit-identical to 4 straight steps.
"""
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from textboost_tpu.data.datasets import TextBoostDataset as JaxTextBoostDataset
from textboost_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from textboost_tpu.lora import peft_io as jax_peft
from textboost_tpu.lora.partition import make_optimizer as jax_make_optimizer
from textboost_tpu.lora.partition import split_lora
from textboost_tpu.models import CLIPTextModel as JaxCLIP
from textboost_tpu.models.convert import convert_text_encoder, convert_unet, convert_vae
from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
from textboost_tpu.models.vae import AutoencoderKL as JaxVAE
from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
from textboost_tpu.train.step import StepConfig as JaxStepConfig
from textboost_tpu.train.step import TextBoostTrainState, make_train_step as jax_make_train_step
from textboost_torch.data.datasets import TextBoostDataset
from textboost_torch.data.tokenizer import HashTokenizer
from textboost_torch.lora import peft_io
from textboost_torch.lora.partition import lora_parameters, lr_schedule, make_optimizer, set_trainable
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import clip_key, unet_key
from textboost_torch.models.pretrained import PARTS, build_models, load_models
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.pipelines.text_to_image import TextToImagePipeline
from textboost_torch.train import main as train_main
from textboost_torch.train.prior_generation import generate_prior_images
from textboost_torch.train.step import StepConfig, TrainState, make_train_step

SPEC = get_spec("tiny")
FIRST_ADDED = 49408
EMB_KEY = "text_model.embeddings.token_embedding.weight"
BATCH = 2
KEY = jax.random.PRNGKey(0)
STEPS = 3


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
def weights():
    """Seeded tiny weights with nonzero LoRA B (text encoder and UNet), so
    that A trains from the first step, and one added token row."""
    bundle = load_models("tiny", lora_rank=4, unet_lora_rank=4, dtype=torch.float32,
                         device="cpu", seed=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for model in (bundle.text_encoder, bundle.unet):
            for p in lora_parameters(model)[1::2]:  # the B of each adapter
                p.normal_(0.0, 0.02, generator=gen)
    sd = {part: {k: v.detach().numpy().copy() for k, v in getattr(bundle, part).state_dict().items()}
          for part in PARTS}
    emb = sd["text_encoder"][EMB_KEY]
    sd["text_encoder"][EMB_KEY] = np.concatenate([emb, emb[1234:1235]])
    return sd


def _jax_tree(module, args, sd, mapper):
    """`module`'s param tree from the port's state dict: the base through the
    JAX package's converter over a shape-only template, the LoRA leaves by
    the port's key mapping."""
    template = jax.eval_shape(module.init, KEY, *args)
    convert = {JaxCLIP: convert_text_encoder, JaxUNet: convert_unet, JaxVAE: convert_vae}
    tree = convert[type(module)]({k: v for k, v in sd.items() if ".lora_" not in k}, template)
    flat = flax.traverse_util.flatten_dict(tree["params"])
    for path in flat:
        if path[-1] in ("lora_a", "lora_b"):
            base, _ = mapper(path[:-1] + ("kernel",))
            flat[path] = sd[base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a"
                                                      else "lora_B.weight")].T
    return {"params": flax.traverse_util.unflatten_dict(flat)}


@pytest.fixture(scope="module")
def jax_trees(weights):
    ids = (jnp.zeros((1, 77), jnp.int32),)
    te = _jax_tree(JaxCLIP(SPEC.text_encoder, lora_rank=4, dtype=jnp.float32,
                           vocab_size_override=FIRST_ADDED + 1), ids, weights["text_encoder"],
                   clip_key)
    base_sd = dict(weights["text_encoder"], **{EMB_KEY: weights["text_encoder"][EMB_KEY][:FIRST_ADDED]})
    frozen_te = _jax_tree(JaxCLIP(SPEC.text_encoder, dtype=jnp.float32), ids, base_sd, clip_key)
    s = SPEC.unet.sample_size
    unet = _jax_tree(JaxUNet(SPEC.unet, dtype=jnp.float32, cross_lora_rank=4),
                     (jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64))),
                     weights["unet"], unet_key)
    vae = _jax_tree(JaxVAE(SPEC.vae, dtype=jnp.float32), (jnp.zeros((1, 64, 64, 3)), KEY),
                    weights["vae"], None)
    return {"te": te, "frozen_te": frozen_te, "unet": unet, "vae": vae}


def _batch(rng, prior: bool, loss_mask: bool):
    """Instance rows (then as many class rows with the prior), padded with
    id 0 after the EOS (sd2's pad), so that the padded mask matters."""
    rows = 2 * BATCH if prior else BATCH
    ids = np.zeros((rows, 77), np.int32)
    ids[:, 0] = 49406
    ids[:, 1:4] = rng.integers(300, 40000, (rows, 3))
    ids[:BATCH, 2] = FIRST_ADDED  # the added token trains
    ids[:, 4] = 49407
    ids[-1, 4:6] = [5000, 49407]
    kpl = np.zeros((BATCH, 77), np.int32)
    kpl[:, 0], kpl[0, 1:4], kpl[0, 4] = 49406, [4000, 4001, 4002], 49407
    kpl[1, 1] = 49407  # the null prompt (patched)
    batch = {"pixel_values": rng.integers(0, 256, (rows, 128, 128, 3), dtype=np.uint8),
             "input_ids": ids, "prior_input_ids": kpl}
    if loss_mask:
        batch["mask"] = (rng.random((rows, 16, 16, 1)) < 0.6).astype(np.float32)
    return batch


def _jax_draws(rng_key, rows):
    """The numbers the JAX step draws from its state's key (step.py:200-221)."""
    _, r_noise, r_t, r_vae = jax.random.split(rng_key, 4)
    shape = (rows, 16, 16, 4)
    nchw = lambda x: torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()
    return {"noise": nchw(jax.random.normal(r_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.asarray(
                jax.random.randint(r_t, (rows,), 0, 1000))).long(),
            "vae_eps": nchw(jax.random.normal(r_vae, shape, jnp.float32))}


def _null_and_norm(weights):
    te = CLIPTextModel(SPEC.text_encoder, lora_rank=4)
    te.load_state_dict({k: torch.from_numpy(v[:FIRST_ADDED] if k == EMB_KEY else v)
                        for k, v in weights["text_encoder"].items()}, strict=True)
    ids = torch.full((1, 77), 49407)
    ids[0, 0] = 49406
    with torch.no_grad():
        null = te(ids, use_lora=False)[0][0].numpy()
    norm = float(np.linalg.norm(weights["text_encoder"][EMB_KEY], axis=-1).mean())
    return null, norm


def _port_state(weights, kv: bool, checkpointing: bool, null, norm):
    te, unet, vae = build_models(SPEC, lora_rank=4, unet_lora_rank=4 if kv else 0, device="cpu")
    frozen_te = CLIPTextModel(SPEC.text_encoder, lora_rank=4)
    te.set_token_embedding(torch.zeros(FIRST_ADDED + 1, 64))
    tensors = lambda sd: {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    te.load_state_dict(tensors(weights["text_encoder"]), strict=True)
    frozen_te.load_state_dict(tensors(dict(weights["text_encoder"], **{
        EMB_KEY: weights["text_encoder"][EMB_KEY][:FIRST_ADDED]})), strict=True)
    unet.load_state_dict(tensors({k: v for k, v in weights["unet"].items()
                                  if kv or ".lora_" not in k}), strict=True)
    vae.load_state_dict(tensors(weights["vae"]), strict=True)
    for mod in (te, frozen_te, unet, vae):
        mod.requires_grad_(False)
    unet.gradient_checkpointing = checkpointing
    set_trainable(te, unet if kv else None)
    optimizer = make_optimizer(te, 1e-3, 1e-2, unet=unet if kv else None)
    return TrainState(
        text_encoder=te, frozen_text_encoder=frozen_te, unet=unet, vae=vae, optimizer=optimizer,
        lr_scheduler=lr_schedule(optimizer, "constant", 0, STEPS),
        schedule=NoiseSchedule.create(), null_embedding=torch.from_numpy(null.copy()),
        target_norm=torch.tensor(norm), original_rows=te.token_embedding.weight[:FIRST_ADDED].clone(),
        unet_lora=lora_parameters(unet) if kv else [])


def _port_config(prior, mask):
    return StepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                      kpl_weight=0.1, max_grad_norm=1.0, with_image_prior=prior,
                      image_ppl_weight=0.7, use_attention_mask=mask)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


FLAGS = {"kv_lora": dict(kv=True, prior=False, mask=False, remat=False),
         "image_prior": dict(kv=False, prior=True, mask=False, remat=False),
         "attention_mask": dict(kv=False, prior=False, mask=True, remat=False),
         "all_with_checkpointing": dict(kv=True, prior=True, mask=True, remat=True)}


@pytest.mark.parametrize("case", list(FLAGS))
def test_port_step_matches_jax(weights, jax_trees, case):
    kv, prior, mask, remat = (FLAGS[case][k] for k in ("kv", "prior", "mask", "remat"))
    null, norm = _null_and_norm(weights)
    batch = _batch(np.random.default_rng(1), prior, loss_mask=remat)

    # The JAX step (train/trainer.py's wiring of make_train_step).
    te = JaxCLIP(SPEC.text_encoder, lora_rank=4, dtype=jnp.float32,
                 vocab_size_override=FIRST_ADDED + 1)
    unet = JaxUNet(SPEC.unet, dtype=jnp.float32, remat=remat, cross_lora_rank=4 if kv else 0)
    vae = JaxVAE(SPEC.vae, dtype=jnp.float32)
    base_flat, lora_flat = split_lora(jax_trees["unet"])
    trainable = {"te": jax_trees["te"], "unet_lora": lora_flat} if kv else jax_trees["te"]
    optimizer = jax_make_optimizer(1e-3, 1e-2, trainable, max_grad_norm=1.0)
    step = jax.jit(jax_make_train_step(
        text_encoder_apply=te.apply,
        frozen_text_encoder_apply=JaxCLIP(SPEC.text_encoder, dtype=jnp.float32).apply,
        unet_apply=unet.apply,
        vae_encode_moments=lambda p, x: vae.apply(p, x, method="encode_moments"),
        optimizer=optimizer, schedule=JaxSchedule.create(),
        config=JaxStepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                             kpl_weight=0.1, train_unet=kv, with_image_prior=prior,
                             image_ppl_weight=0.7, use_attention_mask=mask),
        null_embedding=None))
    trainable = jax.tree.map(jnp.asarray, trainable)
    jstate = TextBoostTrainState(step=jnp.zeros((), jnp.int32), te_params=trainable,
                                 opt_state=optimizer.init(trainable), rng=KEY)
    frozen = {"vae": jax_trees["vae"], "te": jax_trees["frozen_te"],
              "embedding_target_norm": jnp.float32(norm), "null_embedding": jnp.asarray(null),
              **({"unet_base": base_flat} if kv else {"unet": {"params": flax.traverse_util.
                                                               unflatten_dict(base_flat)}})}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    pstate = _port_state(weights, kv, remat, null, norm)
    port_step = make_train_step(_port_config(prior, mask))
    tbatch = _torch_batch(batch)
    rows = batch["input_ids"].shape[0]
    for i in range(STEPS):
        draws = _jax_draws(jstate.rng, rows)
        jstate, jm = step(jstate, jbatch, frozen)
        pm = port_step(pstate, tbatch, draws)
        for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss", "prior_loss"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"{case} step {i} {key}")
        assert (float(pm["prior_loss"]) > 0) == prior

    jte = jstate.te_params["te"] if kv else jstate.te_params
    emb = pstate.text_encoder.token_embedding.weight.detach().numpy()
    np.testing.assert_allclose(emb[FIRST_ADDED], np.asarray(jte["params"]["token_embedding"])[
        FIRST_ADDED], rtol=0, atol=2e-5)
    got = {f"{name}": p.detach().numpy() for name, p in pstate.text_encoder.named_parameters()
           if ".lora_" in name}
    assert got
    for path, leaf in flax.traverse_util.flatten_dict(jte["params"]).items():
        if path[-1] in ("lora_a", "lora_b"):
            base, _ = clip_key(path[:-1] + ("kernel",))
            key = base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a" else "lora_B.weight")
            np.testing.assert_allclose(got[key], np.asarray(leaf).T, rtol=0, atol=2e-5, err_msg=key)
    if kv:  # the UNet's adapters trained, and agree
        unet_got = dict(pstate.unet.named_parameters())
        start = dict(zip([k for k in weights["unet"] if ".lora_" in k],
                         [v for k, v in weights["unet"].items() if ".lora_" in k]))
        for path, leaf in jstate.te_params["unet_lora"].items():
            base, _ = unet_key(path[:-1] + ("kernel",))
            key = base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a" else "lora_B.weight")
            mine = unet_got[key].detach().numpy()
            assert np.abs(mine - start[key]).max() > 1e-4, key
            np.testing.assert_allclose(mine, np.asarray(leaf).T, rtol=0, atol=2e-5, err_msg=key)


def test_gradient_checkpointing_is_bit_identical_to_the_plain_step(weights):
    null, norm = _null_and_norm(weights)
    batch = _torch_batch(_batch(np.random.default_rng(2), prior=True, loss_mask=True))
    gen = torch.Generator().manual_seed(0)
    draws = {"noise": torch.randn(2 * BATCH, 4, 16, 16, generator=gen),
             "vae_eps": torch.randn(2 * BATCH, 4, 16, 16, generator=gen),
             "timesteps": torch.tensor([10, 300, 600, 990])}
    results = []
    for checkpointing in (False, True):
        state = _port_state(weights, True, checkpointing, null, norm)
        step = make_train_step(_port_config(prior=True, mask=True))
        metrics = [step(state, batch, draws) for _ in range(2)]
        results.append((metrics, [p.detach().clone() for p in
                                  list(state.text_encoder.parameters()) + state.unet_lora]))
    (m0, p0), (m1, p1) = results
    for a, b in zip(m0, m1):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ---------------------------------------------------------------------------
# Data, prior generation, the unet/ adapter, resume
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flags")
    rng = np.random.default_rng(0)
    for name, n, size in (("instance", 2, (96, 80)), ("class", 3, (72, 90))):
        (root / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
                root / name / f"{i}-{'ab' * 20}-a_photo_of_dog_{i}.png")
    return root


@pytest.mark.parametrize("class_token", [None, "dog"])
def test_class_samples_and_collate_equal_jax(dirs, class_token):
    kwargs = dict(num_instance=None, template="imagenet_small",
                  prior_data_root=str(dirs / "class"), class_token=class_token, num_prior=2,
                  size=64, seed=4)
    concepts = [{"instance_data_dir": str(dirs / "instance"), "instance_token": "<v*>"}]
    port = TextBoostDataset(concepts, HashTokenizer(), **kwargs)
    jax_ds = JaxTextBoostDataset(concepts, JaxHashTokenizer(), **kwargs)
    assert len(port) == len(jax_ds) == 2
    for step in range(3):
        idx = [0, 1]
        ps = [port.__getitem__(i, rng=np.random.default_rng((4, step, i))) for i in idx]
        js = [jax_ds.__getitem__(i, rng=np.random.default_rng((4, step, i))) for i in idx]
        pb = TextBoostDataset.collate(ps, with_prior_preservation=True)
        jb = JaxTextBoostDataset.collate(js, with_prior_preservation=True)
        assert pb["pixel_values"].shape == (4, 64, 64, 3)
        for key in ("pixel_values", "input_ids"):
            np.testing.assert_array_equal(pb[key], jb[key])


def test_generate_prior_images_tops_the_dir_up(tmp_path):
    bundle = load_models("tiny", dtype=torch.float32, device="cpu")
    pipe = TextToImagePipeline(bundle.spec, HashTokenizer(), bundle.text_encoder, bundle.unet,
                               bundle.vae, device="cpu")
    class_dir = tmp_path / "class"
    class_dir.mkdir()
    Image.new("RGB", (8, 8)).save(class_dir / "0-old-a_photo_of_dog.jpg")
    made = generate_prior_images(pipe, str(class_dir), "dog", 3, sample_batch_size=2,
                                 num_inference_steps=2)
    names = sorted(os.listdir(class_dir))
    assert made == 2 and len(names) == 3
    for i, name in enumerate(names[1:], start=1):
        idx, digest, caption = name.split("-")
        assert idx == str(i) and len(digest) == 40 and caption == "a_photo_of_dog.jpg"
    assert generate_prior_images(pipe, str(class_dir), "dog", 3) == 0


def test_unet_adapter_equals_the_jax_exporter_and_round_trips(weights, jax_trees, tmp_path):
    unet = load_models("tiny", unet_lora_rank=4, dtype=torch.float32, device="cpu").unet
    tensors = lambda sd: {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    unet.load_state_dict(tensors(weights["unet"]), strict=True)
    peft_io.export_unet_lora_adapter(unet, str(tmp_path / "port"), rank=4)
    _, lora_flat = split_lora(jax_trees["unet"])
    jax_peft.export_unet_lora_adapter(lora_flat, str(tmp_path / "jax"), rank=4)
    port_t = peft_io.load_safetensors(str(tmp_path / "port" / "adapter_model.safetensors"))
    jax_t = peft_io.load_safetensors(str(tmp_path / "jax" / "adapter_model.safetensors"))
    assert port_t.keys() == jax_t.keys() and len(port_t) == len(lora_flat)
    for key in port_t:
        np.testing.assert_array_equal(port_t[key], jax_t[key], err_msg=key)
    read = lambda d: open(tmp_path / d / "adapter_config.json").read()
    assert read("port") == read("jax")
    merged, rank = jax_peft.import_unet_lora_adapter(
        {"params": flax.traverse_util.unflatten_dict(split_lora(jax_trees["unet"])[0])},
        str(tmp_path / "port"))
    assert rank == 4
    flat = flax.traverse_util.flatten_dict(merged["params"])
    for path, leaf in lora_flat.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf))


def test_a_partial_unet_adapter_is_refused(weights, tmp_path):
    """An adapter that lacks one of the UNet's LoRA weights raises and
    leaves the UNet as it was; a complete one loads."""
    tensors = lambda sd: {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    unet = load_models("tiny", unet_lora_rank=4, dtype=torch.float32, device="cpu").unet
    unet.load_state_dict(tensors(weights["unet"]), strict=True)
    peft_io.export_unet_lora_adapter(unet, str(tmp_path / "full"), rank=4)
    full = peft_io.load_safetensors(str(tmp_path / "full" / "adapter_model.safetensors"))
    dropped = sorted(full)[-1]
    peft_io.export_unet_lora_adapter(unet, str(tmp_path / "partial"), rank=4)
    peft_io.save_safetensors({k: v for k, v in full.items() if k != dropped},
                             str(tmp_path / "partial" / "adapter_model.safetensors"))
    fresh = load_models("tiny", unet_lora_rank=4, dtype=torch.float32, device="cpu").unet
    before = peft_io.unet_lora_tensors(fresh)
    with pytest.raises(ValueError, match="lacks 1 of the UNet's"):
        peft_io.import_unet_lora_adapter(fresh, str(tmp_path / "partial"))
    after = peft_io.unet_lora_tensors(fresh)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    peft_io.import_unet_lora_adapter(fresh, str(tmp_path / "full"))
    loaded = peft_io.unet_lora_tensors(fresh)
    assert loaded.keys() == full.keys()
    assert all(np.array_equal(loaded[k], full[k]) for k in full)


def _resume_flags(dirs, out, steps, *extra):
    return ["--device", "cpu", "--model_preset", "tiny",
            "--instance_data_dir", str(dirs / "instance"), "--output_dir", out,
            "--placeholder_token", "<v*>", "--initializer_token", "dog",
            "--max_train_steps", str(steps), "--train_batch_size", "2", "--resolution", "64",
            "--checkpointing_steps", "2", "--learning_rate", "1e-2", "--report_to", "none",
            "--unet_params_to_train", "crossattn_kv", "--with_image_prior",
            "--class_data_dir", str(dirs / "class"), "--class_token", "dog",
            "--num_prior_images", "3", "--seed", "5", *extra]


def test_two_plus_two_resumed_steps_are_bit_identical_to_four(dirs, tmp_path):
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    m4 = train_main(_resume_flags(dirs, straight, 4))
    train_main(_resume_flags(dirs, resumed, 2))
    assert os.path.isfile(os.path.join(resumed, "checkpoint-2", "unet", "adapter_model.safetensors"))
    m22 = train_main(_resume_flags(dirs, resumed, 4, "--resume_from_checkpoint", "latest"))
    assert m4["loss"] == m22["loss"] and m4["prior_loss"] == m22["prior_loss"] > 0
    for sub in ("unet", "text_encoder"):
        a, b = (peft_io.load_safetensors(os.path.join(d, sub, "adapter_model.safetensors"))
                for d in (straight, resumed))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    bins = [f for f in os.listdir(straight) if f.endswith(".bin")]
    a, b = (peft_io.import_token_embeddings([os.path.join(d, f) for f in bins])
            for d in (straight, resumed))
    for tok in a:
        np.testing.assert_array_equal(a[tok], b[tok])


def test_derived_launches_count_the_recompute():
    """`chip_smoke.train_step_calls` (the card's expected launches, derived
    on the meta device) gives the plain step's counts without checkpointing,
    and with it every UNet flash forward (10) and every checkpointed
    GroupNorm (58 of 61: not the output norm, not down-block 0's first
    resnet, whose inputs need no gradient) once more."""
    import chip_smoke

    def counts(**kwargs):
        calls = chip_smoke.train_step_calls("sd21base", **kwargs)
        return tuple(sum(calls[k].values()) for k in ("flash", "flash_bwd", "gn", "gn_bwd"))

    plain = counts(unet_batch=8, encode_batch=8, checkpointing=False, cross_lora_rank=0)
    assert plain == chip_smoke.expected_train_launches(get_spec("sd21base")) == (11, 9, 83, 58)
    assert counts(unet_batch=16, encode_batch=16, checkpointing=True,
                  cross_lora_rank=4) == (21, 9, 141, 58)
