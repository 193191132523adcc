"""The port's training slice held against the JAX package on the same inputs.

The plain versions of the two backward kernels (flash attention, GroupNorm
input gradient) against the Pallas kernels in interpret mode; both autograd
Functions against autograd of the math path; the schedule's training
queries; the optimizer pieces (schedules, gradient surgery, renorm); the
data stream; the config's flag parity; and a `--device cpu` run of
`python -m textboost_torch.train` whose output dir the JAX pipeline loads
and the port's inference CLI samples from.
Inputs come from numpy seeds and go to both sides.  The step itself is held
against `make_train_step` in tests/test_torch_port_train_step.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.data.datasets import PriorDataset as JaxPriorDataset
from textboost_tpu.data.datasets import InstructPix2PixDataset as JaxIP2P
from textboost_tpu.data.datasets import TextBoostDataset as JaxTextBoostDataset
from textboost_tpu.data.augment import PairedAugmentation as JaxPairedAugmentation
from textboost_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from textboost_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from textboost_tpu.lora import partition as jax_partition
from textboost_tpu.ops.flash_attention import flash_attention as jax_flash
from textboost_tpu.ops.group_norm import _run_bwd as jax_gn_bwd
from textboost_tpu.ops.group_norm import _run_fwd as jax_gn_fwd
from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
from textboost_tpu.ops.schedule import snr_timestep_weights as jax_snr_weights
from textboost_tpu.pipelines.loading import load_textboost_pipeline as jax_load_pipeline
from textboost_tpu.train import config as jax_config
from textboost_torch.data.augment import PairedAugmentation
from textboost_torch.data.datasets import InstructPix2PixDataset, PriorDataset, TextBoostDataset
from textboost_torch.data.loader import PrefetchLoader
from textboost_torch import inference
from textboost_torch.data.tokenizer import HashTokenizer
from textboost_torch.lora import partition
from textboost_torch.lora.peft_io import import_token_embeddings
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.layers import GroupNorm
from textboost_torch.ops import flash_attention as fa
from textboost_torch.ops import group_norm as gn
from textboost_torch.ops.attention import math_attention, multi_head_attention
from textboost_torch.ops.schedule import NoiseSchedule, sample_timesteps, snr_timestep_weights
from textboost_torch.train import config as port_config
from textboost_torch.train import main as train_main
from textboost_torch.train.trainer import plan_tokens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops; with the suite's other
    processes on every core, torch's thread pool waits on its own threads
    at each op far longer than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# Flash-attention backward (K2): plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,h,d,m", [
    (1, 256, 2, 64, 256),
    (1, 256, 1, 40, 256),  # head dim padded to 128 lanes on the TPU side
    (1, 256, 1, 32, 77),  # KV tail masked past 77
    (2, 256, 2, 40, 100),
])
def test_flash_backward_reference_matches_jax_kernel(b, n, h, d, m):
    rng = np.random.default_rng(10)
    q, k, v, do = (_randn(rng, b, n, h, d), _randn(rng, b, m, h, d), _randn(rng, b, m, h, d),
                   _randn(rng, b, n, h, d))
    scale = d**-0.5
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, scale=scale, interpret=True,
                                                block_q=128, block_k=128, bwd_block_q=128,
                                                bwd_block_k=128),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = fa.flash_attention_reference(tq, tk, tv, scale)
    got = fa.flash_attention_backward_reference(tq, tk, tv, o, lse, tdo, scale)
    # fp32 on both sides; the tolerance of tests/test_flash_attention.py.
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{name}")


def test_flash_backward_reference_zeroes_the_masked_keys():
    rng = np.random.default_rng(11)
    q, k, v, do = _t(_randn(rng, 1, 128, 2, 16), _randn(rng, 1, 64, 2, 16),
                     _randn(rng, 1, 64, 2, 16), _randn(rng, 1, 128, 2, 16))
    o, lse = fa.flash_attention_reference(q, k, v, 0.25, 40)
    dq, dk, dv = fa.flash_attention_backward_reference(q, k, v, o, lse, do, 0.25, 40)
    assert dk.shape == dv.shape == (1, 64, 2, 16)
    assert not dk[:, 40:].any() and not dv[:, 40:].any() and dk[:, :40].abs().max() > 0


@pytest.mark.parametrize("kv_len", [None, 50])
def test_flash_function_matches_math_autograd(kv_len):
    rng = np.random.default_rng(12)
    q, k, v = (t.requires_grad_() for t in _t(*(_randn(rng, 2, 128, 2, 40) for _ in range(3))))
    do = torch.from_numpy(_randn(rng, 2, 128, 2, 40))
    fa.flash_attention(q, k, v, scale=40**-0.5, kv_len=kv_len).backward(do)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    mask = None
    if kv_len is not None:
        mask = torch.arange(128)[None, None, None, :] < kv_len
    math_attention(q, k, v, mask, 40**-0.5).backward(do)
    for g, t, name in zip(got, (q, k, v), "qkv"):
        torch.testing.assert_close(g, t.grad, atol=2e-6, rtol=1e-5, msg=f"d{name}")


def test_flash_dispatch_trains_through_the_function():
    rng = np.random.default_rng(13)
    q, k, v = (t.requires_grad_() for t in _t(*(_randn(rng, 1, 256, 2, 40) for _ in range(3))))
    before = fa.bwd_launches
    out = multi_head_attention(q, k, v, impl="flash")
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.square().sum().backward()
    assert q.grad is not None and fa.bwd_launches == before  # the CPU takes the plain version


def test_flash_backward_envelope():
    q = torch.zeros(1, 256, 1, 512, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue B"):
        fa.check_backward_envelope(q)
    with pytest.raises(NotImplementedError, match="queue B"):
        fa.check_backward_envelope(torch.zeros(1, 256, 1, 40))  # fp32
    with pytest.raises(NotImplementedError, match="queue B"):
        fa.check_backward_envelope(torch.zeros(1, 256, 1, 44, dtype=torch.float16))
    fa.check_backward_envelope(torch.zeros(1, 256, 1, 80, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# GroupNorm backward (K4): plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,eps", [((2, 8, 8, 128), 1e-5), ((1, 16, 16, 64), 1e-6),
                                       ((1, 8, 8, 320), 1e-5)])
def test_group_norm_backward_reference_matches_jax_kernel(shape, eps, silu):
    rng = np.random.default_rng(14)
    x, dy = _randn(rng, *shape) * 2 + 0.5, _randn(rng, *shape)
    gamma = _randn(rng, shape[-1]) * 0.2 + 1.0
    beta = _randn(rng, shape[-1]) * 0.1
    b, c = shape[0], shape[-1]
    x3, dy3 = jnp.asarray(x.reshape(b, -1, c)), jnp.asarray(dy.reshape(b, -1, c))
    _, jmean, jrstd = jax_gn_fwd(x3, jnp.asarray(gamma), jnp.asarray(beta), 32, eps, silu, True)
    want = jax_gn_bwd(x3, jnp.asarray(gamma), jnp.asarray(beta), jmean, jrstd, dy3, 32, eps,
                      silu, True)
    tx, tdy = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in (x, dy))
    tg, tb = _t(gamma, beta)
    _, mean, rstd = gn.group_norm_reference(tx, tg, tb, 32, eps, silu)
    got = gn.group_norm_backward_reference(tx, tg, tb, mean, rstd, tdy, 32, eps, silu)
    # fp32 on both sides; the tolerance of tests/test_group_norm.py's gradient test.
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want).reshape(shape),
                               atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_function_matches_math_autograd(silu):
    rng = np.random.default_rng(15)
    x = torch.from_numpy(_randn(rng, 2, 64, 6, 5)).requires_grad_()
    gamma, beta = _t(_randn(rng, 64) * 0.2 + 1.0, _randn(rng, 64) * 0.1)
    dy = torch.from_numpy(_randn(rng, 2, 64, 6, 5))
    before = gn.bwd_launches
    y = gn.group_norm(x, gamma, beta, 32, eps=1e-6, silu=silu)
    assert "GroupNormFunction" in type(y.grad_fn).__name__
    y.backward(dy)
    got, x.grad = x.grad.clone(), None
    gn.group_norm_reference(x, gamma, beta, 32, 1e-6, silu)[0].backward(dy)
    torch.testing.assert_close(got, x.grad, atol=2e-6, rtol=1e-5)
    assert gn.bwd_launches == before  # the CPU takes the plain version


def test_group_norm_trains_affine_by_plain_math():
    """A GroupNorm whose gamma/beta train takes the plain path under
    autograd (the JAX dispatch rule), so gamma and beta get gradients."""
    mod = GroupNorm(32, 64, eps=1e-6, silu=True)
    x = torch.randn(2, 64, 4, 4, requires_grad=True)
    y = mod(x)
    assert "GroupNormFunction" not in type(y.grad_fn).__name__
    y.square().sum().backward()
    assert mod.weight.grad is not None and mod.bias.grad is not None and x.grad is not None
    mod.requires_grad_(False)
    assert "GroupNormFunction" in type(mod(x).grad_fn).__name__


# ---------------------------------------------------------------------------
# Schedule: training queries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_schedule_training_queries_bit_identical(prediction_type):
    rng = np.random.default_rng(16)
    sample, noise = _randn(rng, 3, 8, 8, 4), _randn(rng, 3, 8, 8, 4)
    t = np.array([0, 517, 999], np.int32)
    js = JaxSchedule.create(prediction_type=prediction_type)
    ts = NoiseSchedule.create(prediction_type=prediction_type)
    a, b_, tt = jnp.asarray(sample), jnp.asarray(noise), jnp.asarray(t)
    x, e, tl = torch.from_numpy(sample), torch.from_numpy(noise), torch.from_numpy(t).long()
    pairs = [
        (js.add_noise(a, b_, tt), ts.add_noise(x, e, tl)),
        (js.velocity(a, b_, tt), ts.velocity(x, e, tl)),
        (js.snr(tt), ts.snr(tl)),
        (js.training_target(a, b_, tt), ts.training_target(x, e, tl)),
        (js.pred_original_sample(b_, a, tt), ts.pred_original_sample(e, x, tl)),
    ]
    for i, (want, got) in enumerate(pairs):
        assert np.array_equal(got.numpy(), np.asarray(want)), i


def test_snr_timestep_weights_and_sampling():
    js, ts = JaxSchedule.create(), NoiseSchedule.create()
    got, want = snr_timestep_weights(ts).numpy(), np.asarray(jax_snr_weights(js))
    # float32 log on both sides, from different libm implementations: 1 ulp.
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    gen = torch.Generator().manual_seed(0)
    uniform = sample_timesteps(gen, ts, 4096)
    assert uniform.dtype == torch.int64 and 0 <= int(uniform.min()) and int(uniform.max()) < 1000
    weighted = sample_timesteps(gen, ts, 4096, weighted=True)
    assert float(weighted.float().mean()) > float(uniform.float().mean())  # noisy t favoured


# ---------------------------------------------------------------------------
# Optimizer pieces and gradient surgery
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,warmup,total", [
    ("constant", 0, 10), ("constant_with_warmup", 3, 10), ("linear", 3, 10),
    ("linear", 0, 5), ("cosine", 3, 10), ("cosine", 0, 7),
])
def test_lr_schedules_match_optax(name, warmup, total):
    want = jax_partition.lr_schedule(name, 2e-3, warmup, total)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=2e-3)
    sched = partition.lr_schedule(opt, name, warmup, total)
    for count in range(total + 3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{name} at {count}")
        opt.step()
        sched.step()


def _tiny_te(rng):
    te = CLIPTextModel(get_spec("tiny").text_encoder, lora_rank=4, vocab_size_override=49410)
    with torch.no_grad():
        for p in te.parameters():
            p.copy_(torch.from_numpy(_randn(rng, *p.shape)) * 0.1)
    return te


def test_surgery_matches_jax():
    rng = np.random.default_rng(17)
    te = _tiny_te(rng)
    params = partition.set_trainable(te)
    labels = partition.param_labels(te)
    assert sum(v == "embedding" for v in labels.values()) == 1
    assert sum(v == "lora" for v in labels.values()) == 2 * 3 * 2  # A, B x q/k/v x 2 layers
    assert len(params) == 13
    for p in params:
        p.grad = torch.from_numpy(_randn(rng, *p.shape))
    emb = te.token_embedding.weight
    lora = partition.lora_parameters(te)
    # JAX surgery on the same gradients, in its [in, out] lora layout.
    grads = {"token_embedding": emb.grad.numpy().copy()}
    for i, layer in enumerate(te.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            mod = getattr(layer.self_attn, proj)
            grads[f"l{i}{proj}"] = {"lora_a": mod.lora_A.weight.grad.numpy().T.copy(),
                                    "lora_b": mod.lora_B.weight.grad.numpy().T.copy()}
    jg = jax_partition.apply_mixing_mask(
        jax_partition.zero_original_vocab_rows(jax.tree.map(jnp.asarray, grads), 49408), "object")
    partition.zero_original_vocab_rows(emb.grad, 49408)
    partition.apply_mixing_mask(te, "object")
    np.testing.assert_array_equal(emb.grad.numpy(), np.asarray(jg["token_embedding"]))
    for i, layer in enumerate(te.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            mod = getattr(layer.self_attn, proj)
            np.testing.assert_array_equal(mod.lora_B.weight.grad.numpy().T,
                                          np.asarray(jg[f"l{i}{proj}"]["lora_b"]))
    want_norm = jax_partition.encoder_grad_norm({k: v for k, v in jg.items() if k != "token_embedding"})
    np.testing.assert_allclose(float(partition.encoder_grad_norm(lora)), float(want_norm), rtol=1e-6)
    clipped, _ = jax_partition.clip_encoder_grads(jg, 0.5)
    partition.clip_encoder_grads(lora, 0.5)
    mod = te.text_model.encoder.layers[1].self_attn.v_proj
    np.testing.assert_allclose(mod.lora_A.weight.grad.numpy().T,
                               np.asarray(clipped["l1v_proj"]["lora_a"]), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(emb.grad.numpy(), np.asarray(clipped["token_embedding"]))


def test_renorm_and_pin_match_jax():
    rng = np.random.default_rng(18)
    emb = _randn(rng, 49410, 8)
    emb[49408:] *= 5.0  # one added row over the target, one under
    emb[49409] *= 0.01
    jax_params = {"token_embedding": jnp.asarray(emb)}
    want = np.asarray(jax_partition.renorm_added_embeddings(jax_params, 49408, 1.5)["token_embedding"])
    got = torch.from_numpy(emb.copy())
    partition.renorm_added_embeddings(got, 49408, torch.tensor(1.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(partition.added_embedding_norm(got, 49408)),
                               float(jax_partition.added_embedding_norm({"token_embedding": want}, 49408)),
                               rtol=1e-6)
    pristine = got[:49408].clone()
    got[:49408] *= 0.99
    partition.pin_original_rows(got, pristine)
    assert torch.equal(got[:49408], pristine)


def test_lora_weights_stay_fp32_and_cast_at_use():
    te = CLIPTextModel(get_spec("tiny").text_encoder, lora_rank=4)
    a = te.text_model.encoder.layers[0].self_attn.q_proj.lora_A.weight.detach().clone()
    te.to(torch.bfloat16)
    mod = te.text_model.encoder.layers[0].self_attn.q_proj
    assert mod.weight.dtype == torch.bfloat16 and mod.lora_A.weight.dtype == torch.float32
    assert torch.equal(mod.lora_A.weight, a)
    te.set_token_embedding(torch.randn(49409, 64), dtype=torch.float32)
    hidden, _ = te(torch.full((1, 77), 49408))
    assert hidden.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Data: the same bytes as the JAX loader
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def instance_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("instance")
    rng = np.random.default_rng(19)
    for i, size in enumerate([(96, 80), (64, 64), (70, 100)]):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(d / f"img{i}.png")
    return str(d)


@pytest.mark.parametrize("num_workers,augmented,start_step", [
    pytest.param(1, False, 0, id="1"),
    pytest.param(3, False, 0, id="3"),
    pytest.param(3, True, 0, id="pda-inversion-threads"),
    pytest.param(3, True, 5, id="pda-inversion-threads-from-step-5"),
])
def test_batches_byte_identical_to_the_jax_loader(instance_dir, num_workers, augmented,
                                                   start_step):
    """The port's loader, with --augment pda --augment_inversion or without,
    against the JAX loader's thread producer; a loader started at step s
    (resume) yields the JAX stream's batches from s on."""
    concepts = [{"instance_data_dir": instance_dir, "instance_token": "<v*>"}]
    streams = []
    for ds_cls, ip2p_cls, prior_cls, loader_cls, tok_cls, aug_cls in (
            (JaxTextBoostDataset, JaxIP2P, JaxPriorDataset, JaxPrefetchLoader, JaxHashTokenizer,
             JaxPairedAugmentation),
            (TextBoostDataset, InstructPix2PixDataset, PriorDataset, PrefetchLoader, HashTokenizer,
             PairedAugmentation)):
        tok = tok_cls()
        tok.add_tokens("<v*>")
        kwargs = {}
        if augmented:
            caption_map = plan_tokens(tok, [], "dog", augment_inversion=True).caption_map
            kwargs["augment_pipe"] = aug_cls(hflip="inversion", inversion=True, p=0.5,
                                             caption_map=caption_map, seed=3)
        ds = ds_cls(concepts, tok, template="textboost", size=64, seed=3, **kwargs)
        prior = prior_cls(ip2p_cls(None), tok, additional_template="textboost",
                          additional_category=["dog"], seed=4)
        loaders = [loader_cls(ds, 3, ds_cls.collate, seed=3, num_workers=num_workers),
                   loader_cls(prior, 3, prior_cls.collate, seed=4, num_workers=num_workers)]
        skip = start_step  # the JAX stream is read past them, the port's starts there
        if loader_cls is PrefetchLoader:
            for ld in loaders:
                ld.set_start_step(start_step)
            skip = 0
        try:
            its = [iter(ld) for ld in loaders]
            batches = [(next(its[0]), next(its[1])) for _ in range(skip + 4)]
            streams.append(batches[skip:])
        finally:
            for ld in loaders:
                ld.stop()
    for (jb, jp), (pb, pp) in zip(*streams):
        assert pb["pixel_values"].dtype == np.uint8 and pb["pixel_values"].shape == (3, 64, 64, 3)
        for key in ("pixel_values", "input_ids"):
            assert np.array_equal(pb[key], jb[key]), key
        assert np.array_equal(pp["input_ids"], jp["input_ids"]) and pp["prompt"] == jp["prompt"]
    if augmented:  # the captions carry augmentation tokens
        prompts = [p for pb, _ in streams[1] for p in pb["prompt"]]
        assert any(tok in p for p in prompts for tok in ("<collage", "<zoom", "<crop>", "<hflip>"))


# ---------------------------------------------------------------------------
# Config and the CLI
# ---------------------------------------------------------------------------
def test_config_has_flag_parity_with_the_jax_cli():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.TrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(port_config.TrainConfig)}
    assert pf == jf
    argv = ["--model_preset", "tiny", "--train_batch_size", "8", "--no-center_crop",
            "--lr_scheduler", "cosine", "--validation_prompts", "a", "b"]
    assert dataclasses.asdict(port_config.parse_args(argv)) == dataclasses.asdict(
        jax_config.parse_args(argv))


@pytest.mark.parametrize("flags,match", [
    (["--mesh_tp", "2"], "multi-card"),
    (["--augment_device"], "device-side augmentation"),
])
def test_unserved_flags_raise_at_setup(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        train_main(["--device", "cpu", "--model_preset", "tiny", "--output_dir", str(tmp_path),
                    "--max_train_steps", "10", *flags])


@pytest.mark.parametrize("flag", ["image_prior", "kv_lora", "gradient_checkpointing",
                                  "attention_mask"])
def test_served_flags_train_one_step_on_cpu(instance_dir, tmp_path, flag):
    """The four flags the port once refused train one step through the CLI;
    the image prior first tops its empty class dir up to 2 generated images."""
    class_dir = tmp_path / "class"
    extra = {"image_prior": ["--with_image_prior", "--class_data_dir", str(class_dir),
                             "--class_token", "dog", "--num_prior_images", "2",
                             "--sample_batch_size", "2"],
             "kv_lora": ["--unet_params_to_train", "crossattn_kv"],
             "gradient_checkpointing": ["--gradient_checkpointing"],
             "attention_mask": ["--text_encoder_use_attention_mask"]}[flag]
    out = str(tmp_path / "out")
    metrics = train_main([
        "--device", "cpu", "--model_preset", "tiny", "--instance_data_dir", instance_dir,
        "--output_dir", out, "--placeholder_token", "<v*>", "--initializer_token", "dog",
        "--max_train_steps", "1", "--train_batch_size", "1", "--resolution", "128",
        "--checkpointing_steps", "0", "--report_to", "none", *extra])
    assert metrics["steps"] == 1 and np.isfinite(metrics["loss"])
    assert (metrics["prior_loss"] > 0) == (flag == "image_prior")
    if flag == "image_prior":
        names = sorted(os.listdir(class_dir))
        assert len(names) == 2 and all(n.endswith("-a_photo_of_dog.jpg") for n in names)
    assert os.path.isfile(os.path.join(out, "unet", "adapter_model.safetensors")) == (
        flag == "kv_lora")


def test_cli_trains_on_cpu_and_the_jax_pipeline_loads_its_output(instance_dir, tmp_path):
    out = str(tmp_path / "out")
    metrics = train_main([
        "--device", "cpu", "--model_preset", "tiny", "--instance_data_dir", instance_dir,
        "--output_dir", out, "--placeholder_token", "<v*>", "--initializer_token", "dog",
        "--max_train_steps", "2", "--train_batch_size", "2", "--resolution", "128",
        "--checkpointing_steps", "2", "--report_to", "none", "--learning_rate", "1e-2",
    ])
    assert metrics["steps"] == 2 and np.isfinite(metrics["loss"])
    recs = [line for line in open(os.path.join(out, "metrics.jsonl"))]
    assert '"step": 0' in recs[0] and '"step": 2' in recs[-1]
    assert os.path.getsize(os.path.join(out, "training.log")) > 0
    assert sorted(os.listdir(os.path.join(out, "text_encoder"))) == [
        "adapter_config.json", "adapter_model.safetensors"]
    learned = import_token_embeddings([os.path.join(out, "v*.bin")])["<v*>"]
    pipe = jax_load_pipeline(out, "tiny", lora_rank=4, dtype=jnp.float32)
    emb = np.asarray(pipe.te_params["params"]["token_embedding"])
    tid = pipe.tokenizer.convert_tokens_to_ids("<v*>")
    assert emb.shape[0] == 49409 and np.array_equal(emb[tid], learned)
    lora_b = np.asarray(pipe.te_params["params"]["layers_0"]["self_attn"]["q_proj"]["lora_b"])
    assert np.abs(lora_b).max() > 0  # the trained adapter was loaded
    # The periodic checkpoint of the last step loads on its own, to the same weights.
    ckpt = jax_load_pipeline(out, "tiny", checkpoint=2, lora_rank=4, dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(ckpt.te_params), jax.tree.leaves(pipe.te_params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    images = inference.generate(inference.parse_args(
        [out, "--model", "tiny", "--seeds", "0", "--steps", "1", "--device", "cpu"]))
    assert images.dtype == np.uint8 and images.shape == (1, 128, 128, 3)
