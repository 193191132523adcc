"""Data parallelism of the port over torch.distributed, on the CPU (gloo).

  * `python -m torch.distributed.run --nproc_per_node 2 -m
    textboost_torch.train` at `tiny` (global batch 4, 3 steps, a checkpoint
    at 2, --scale_lr) against the same CLI in one process: per-step losses,
    the final metrics, the checkpoint and the exported adapter and token
    bins; rank 0 alone writes, and a 2-rank resume from checkpoint-2 lands
    on the straight run;
  * one step over 2 ranks with the image prior, each rank holding
    [instance_r, class_r], against the JAX package's `make_train_step` on
    the global batch [instance_0, instance_1, class_0, class_1], and the
    reducer alone: it averages exactly the LoRA, added-row and UNet-LoRA
    gradients and the loss scalars (this file is the ranks' program:
    `python -m test_torch_port_dp <dir>`);
  * the loader's shards: at world 1 byte-equal to the JAX loader; the JAX
    loader's two shards of a one-image dataset are the same batch, the
    port's are the two halves of the one-process batch;
  * the mesh and batch checks, the backend choice, and the sweep runners'
    data-parallel launch.

Every process runs on one torch thread, as the port's other test files do.
"""
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from textboost_torch.lora.partition import lora_parameters, lr_schedule, make_optimizer, set_trainable
from textboost_torch.lora.peft_io import import_token_embeddings, load_safetensors
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.pretrained import PARTS, build_models, load_models
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.parallel import mesh
from textboost_torch.train.step import StepConfig, TrainState, forward_backward, make_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SPEC = get_spec("tiny")
FIRST_ADDED = 49408
EMB_KEY = "text_model.embeddings.token_embedding.weight"
REL = 1e-5  # 2 ranks against one process, fp32: the batch means sum in another order
LAUNCH_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops; with the suite's other
    processes on every core, torch's thread pool waits on its own threads
    at each op far longer than one thread takes to do the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([REPO, TESTS] + ([path] if path else [])))


def _start(nproc, args, cwd):
    """Start `python -m torch.distributed.run --standalone --nproc_per_node
    nproc <args>`; `_wait` for it."""
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={nproc}", *args], cwd=cwd, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _wait(proc):
    """The launch's stdout; it must exit 0 within LAUNCH_TIMEOUT_S (else
    the launcher and its ranks are killed)."""
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# The CLI: 2 ranks against one process, and a 2-rank resume
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def instance_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("instance")
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (128, 128, 3), dtype=np.uint8)
                    ).save(d / "dog.png")
    return str(d)


def _flags(instance_dir, out, *extra):
    return ["--model_preset", "tiny", "--device", "cpu", "--instance_data_dir", instance_dir,
            "--output_dir", out, "--placeholder_token", "<v*>", "--initializer_token", "dog",
            "--max_train_steps", "3", "--train_batch_size", "4", "--resolution", "128",
            "--augment", "pda", "--augment_inversion", "--checkpointing_steps", "2",
            "--validation_steps", "0", "--report_to", "none", "--mixed_precision", "no",
            "--scale_lr", "--seed", "7", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, instance_dir):
    """One process in-process, 2 ranks through torchrun, then 2 ranks
    resumed from a copy of the 2-rank run's checkpoint-2."""
    from textboost_torch.train import main as train_main

    root = tmp_path_factory.mktemp("dp")
    dirs = {name: str(root / name) for name in ("one", "two", "resumed")}
    two = _start(2, ["-m", "textboost_torch.train", *_flags(instance_dir, dirs["two"])], root)
    train_main(_flags(instance_dir, dirs["one"]))
    stdout = _wait(two)
    shutil.copytree(os.path.join(dirs["two"], "checkpoint-2"),
                    os.path.join(dirs["resumed"], "checkpoint-2"))
    _wait(_start(2, ["-m", "textboost_torch.train", *_flags(
        instance_dir, dirs["resumed"], "--resume_from_checkpoint", "latest")], root))
    return dirs, stdout


def _losses(run_dir):
    """{step: loss} of the trainer's "Loss by step a-b: [...]" log lines."""
    out = {}
    with open(os.path.join(run_dir, "training.log")) as f:
        for m in re.finditer(r"Loss by step (\d+)-\d+: (\[.*\])", f.read()):
            out.update(enumerate(json.loads(m.group(2)), start=int(m.group(1))))
    return out


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _artifacts(run_dir):
    """{name: array} of the exported adapter and token bins (and, under
    `checkpoint-2/`, the checkpoint's)."""
    out = {}
    for d in ("", "checkpoint-2"):
        base = os.path.join(run_dir, d)
        for k, v in load_safetensors(os.path.join(base, "text_encoder",
                                                  "adapter_model.safetensors")).items():
            out[f"{d}/{k}"] = v
        for t, v in import_token_embeddings(sorted(glob.glob(os.path.join(base, "*.bin")))).items():
            out[f"{d}/{t}"] = v
    return out


def _files(run_dir):
    return sorted(os.path.relpath(os.path.join(d, f), run_dir)
                  for d, _, files in os.walk(run_dir) for f in files)


def test_two_ranks_train_as_one_process(runs):
    dirs, stdout = runs
    assert stdout.count("backend gloo, device cpu") == 2
    one, two = _losses(dirs["one"]), _losses(dirs["two"])
    assert sorted(one) == sorted(two) == [1, 2, 3]
    for s in one:
        assert abs(two[s] - one[s]) <= REL * abs(one[s]), (s, one[s], two[s])
    (r1,), (r2,) = ([r for r in _records(d) if r["step"] == 3] for d in (dirs["one"], dirs["two"]))
    for key in ("loss", "den_loss", "grad_norm", "added_embedding_norm"):
        assert abs(r2[key] - r1[key]) <= REL * abs(r1[key]), key
    # kpl is 1 - cos of near-equal encodings (~5e-6): it cancels to a few digits.
    assert abs(r2["kpl"] - r1["kpl"]) <= 1e-8
    a1, a2 = _artifacts(dirs["one"]), _artifacts(dirs["two"])
    assert sorted(a1) == sorted(a2) and len(a1) > 10
    for name in a1:
        assert _rel(a2[name], a1[name]) <= REL, name


def test_rank_zero_alone_writes(runs):
    dirs, _ = runs
    assert _files(dirs["two"]) == _files(dirs["one"])
    assert [r["step"] for r in _records(dirs["two"])] == [0, 3]
    with open(os.path.join(dirs["two"], "training.log")) as f:
        log = f.read()
    assert log.count("Training took") == log.count("Saving state") == 1
    assert "data parallel over 2 ranks" in log and "all-reduce: 3 calls" in log


def test_two_rank_resume_lands_on_the_straight_run(runs):
    dirs, _ = runs
    straight, resumed = _losses(dirs["two"]), _losses(dirs["resumed"])
    assert sorted(resumed) == [3] and resumed[3] == straight[3]
    a, b = _artifacts(dirs["two"]), _artifacts(dirs["resumed"])
    for name in a:
        assert np.array_equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# One step over 2 ranks with the image prior, against the JAX step; the reducer
# ---------------------------------------------------------------------------
def _weights():
    """Seeded tiny weights with nonzero LoRA B (text encoder and UNet), so
    that A trains from the first step, and one added token row; the same in
    every process."""
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


def _null_and_norm(weights):
    te = CLIPTextModel(SPEC.text_encoder, lora_rank=4)
    te.load_state_dict({k: torch.from_numpy(v[:FIRST_ADDED] if k == EMB_KEY else v)
                        for k, v in weights["text_encoder"].items()}, strict=True)
    ids = torch.full((1, 77), 49407)
    ids[0, 0] = 49406
    with torch.no_grad():
        null = te(ids, use_lora=False)[0][0].numpy()
    return null, float(np.linalg.norm(weights["text_encoder"][EMB_KEY], axis=-1).mean())


def _port_state(weights, kv: bool):
    null, norm = _null_and_norm(weights)
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
    set_trainable(te, unet if kv else None)
    optimizer = make_optimizer(te, 1e-3, 1e-2, unet=unet if kv else None)
    return TrainState(
        text_encoder=te, frozen_text_encoder=frozen_te, unet=unet, vae=vae, optimizer=optimizer,
        lr_scheduler=lr_schedule(optimizer, "constant", 0, 1), schedule=NoiseSchedule.create(),
        null_embedding=torch.from_numpy(null.copy()), target_norm=torch.tensor(norm),
        original_rows=te.token_embedding.weight[:FIRST_ADDED].clone(),
        unet_lora=lora_parameters(unet) if kv else [])


STEP = StepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                  kpl_weight=0.1, max_grad_norm=1.0, with_image_prior=True, image_ppl_weight=0.7)


def _rank_program(work: str) -> None:
    """One rank of the 2-rank launch: the reducer alone on a forward and
    backward with the UNet's LoRA training (iii), then one whole step with
    the image prior (ii), on this rank's rows; writes rank{r}.npz."""
    torch.set_num_threads(1)
    assert mesh.init_distributed("cpu") == "gloo"
    r = mesh.rank()
    inputs = np.load(os.path.join(work, f"inputs{r}.npz"))
    batch = {k: torch.from_numpy(inputs[k]).long() if inputs[k].dtype == np.int32
             else torch.from_numpy(inputs[k]) for k in ("pixel_values", "input_ids",
                                                          "prior_input_ids")}
    draws = {k: torch.from_numpy(inputs[k]) for k in ("noise", "vae_eps", "timesteps")}
    weights = _weights()
    out = {}

    state = _port_state(weights, kv=True)
    loss, aux = forward_backward(state, STEP, batch, draws)
    emb = state.text_encoder.token_embedding.weight
    params = lora_parameters(state.text_encoder) + state.unet_lora
    reducer = mesh.GradReducer(emb, FIRST_ADDED, params)
    grads = lambda: [emb.grad] + [p.grad for p in params]
    out.update({f"local{i}": g.numpy().copy() for i, g in enumerate(grads())})
    out.update({f"local_{k}": v.numpy() for k, v in dict(aux, loss=loss).items()})
    loss, aux = reducer(loss, aux)
    out.update({f"reduced{i}": g.numpy().copy() for i, g in enumerate(grads())})
    out.update({f"reduced_{k}": v.numpy() for k, v in dict(aux, loss=loss).items()})
    out.update(values=reducer.values(), bytes=reducer.bytes, calls=reducer.calls,
               lora_values=sum(p.numel() for p in lora_parameters(state.text_encoder)),
               unet_values=sum(p.numel() for p in state.unet_lora), tensors=1 + len(params))

    state = _port_state(weights, kv=False)
    te = state.text_encoder
    step = make_train_step(STEP, reduce=mesh.GradReducer(te.token_embedding.weight, FIRST_ADDED,
                                                         lora_parameters(te)))
    metrics = step(state, batch, draws)
    out.update({f"metric_{k}": v.numpy() for k, v in metrics.items()})
    out["added_row"] = te.token_embedding.weight[FIRST_ADDED].detach().numpy()
    out.update({f"lora:{n}": p.detach().numpy() for n, p in te.named_parameters() if ".lora_" in n})
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    dist.destroy_process_group()


def _jax_tree(module, args, sd, mapper):
    """`module`'s param tree from the port's state dict: the base through the
    JAX package's converter over a shape-only template, the LoRA leaves by
    the port's key mapping."""
    import flax
    import jax

    from textboost_tpu.models import CLIPTextModel as JaxCLIP
    from textboost_tpu.models.convert import convert_text_encoder, convert_unet, convert_vae
    from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
    from textboost_tpu.models.vae import AutoencoderKL as JaxVAE

    template = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    convert = {JaxCLIP: convert_text_encoder, JaxUNet: convert_unet,
               JaxVAE: convert_vae}[type(module)]
    tree = convert({k: v for k, v in sd.items() if ".lora_" not in k}, template)
    flat = flax.traverse_util.flatten_dict(tree["params"])
    for path in flat:
        if path[-1] in ("lora_a", "lora_b"):
            base, _ = mapper(path[:-1] + ("kernel",))
            flat[path] = sd[base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a"
                                                      else "lora_B.weight")].T
    return {"params": flax.traverse_util.unflatten_dict(flat)}


@pytest.fixture(scope="module")
def prior_step(tmp_path_factory):
    """The JAX step on the global batch [instance_0, instance_1, class_0,
    class_1] and the 2 ranks' outputs, each rank on [instance_r, class_r]."""
    import jax
    import jax.numpy as jnp

    from textboost_tpu.lora.partition import make_optimizer as jax_make_optimizer
    from textboost_tpu.models import CLIPTextModel as JaxCLIP
    from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
    from textboost_tpu.models.vae import AutoencoderKL as JaxVAE
    from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
    from textboost_tpu.train.step import StepConfig as JaxStepConfig
    from textboost_tpu.train.step import TextBoostTrainState, make_train_step as jax_make_train_step
    from textboost_torch.models.convert import clip_key, unet_key

    rng = np.random.default_rng(1)
    ids = np.full((4, 77), 49407, np.int32)
    ids[:, 0] = 49406
    ids[:, 1:4] = rng.integers(300, 40000, (4, 3))
    ids[:2, 2] = FIRST_ADDED  # the instance rows carry the added token
    kpl = np.full((2, 77), 49407, np.int32)
    kpl[:, 0], kpl[0, 1:4] = 49406, [4000, 4001, 4002]
    batch = {"pixel_values": rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8),
             "input_ids": ids, "prior_input_ids": kpl}
    key = jax.random.PRNGKey(0)
    _, r_noise, r_t, r_vae = jax.random.split(key, 4)
    nchw = lambda x: np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))
    draws = {"noise": nchw(jax.random.normal(r_noise, (4, 16, 16, 4), jnp.float32)),
             "timesteps": np.asarray(jax.random.randint(r_t, (4,), 0, 1000)).astype(np.int64),
             "vae_eps": nchw(jax.random.normal(r_vae, (4, 16, 16, 4), jnp.float32))}

    work = str(tmp_path_factory.mktemp("prior"))
    for r in range(2):
        rows = [r, 2 + r]  # this rank's instance row, then its class row
        np.savez(os.path.join(work, f"inputs{r}.npz"), prior_input_ids=kpl[r:r + 1],
                 **{k: batch[k][rows] for k in ("pixel_values", "input_ids")},
                 **{k: v[rows] for k, v in draws.items()})
    launch = _start(2, ["-m", "test_torch_port_dp", work], work)  # runs while JAX compiles

    weights = _weights()
    null, norm = _null_and_norm(weights)
    te_mod = JaxCLIP(SPEC.text_encoder, lora_rank=4, dtype=jnp.float32,
                     vocab_size_override=FIRST_ADDED + 1)
    frozen_mod = JaxCLIP(SPEC.text_encoder, dtype=jnp.float32)
    unet_mod, vae_mod = JaxUNet(SPEC.unet, dtype=jnp.float32), JaxVAE(SPEC.vae, dtype=jnp.float32)
    tok = (jnp.zeros((1, 77), jnp.int32),)
    te = _jax_tree(te_mod, tok, weights["text_encoder"], clip_key)
    frozen_te = _jax_tree(frozen_mod, tok, dict(weights["text_encoder"], **{
        EMB_KEY: weights["text_encoder"][EMB_KEY][:FIRST_ADDED]}), clip_key)
    s = SPEC.unet.sample_size
    unet = _jax_tree(unet_mod, (jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 77, 64))),
                     {k: v for k, v in weights["unet"].items() if ".lora_" not in k}, unet_key)
    vae = _jax_tree(vae_mod, (jnp.zeros((1, 64, 64, 3)), key), weights["vae"], None)
    optimizer = jax_make_optimizer(1e-3, 1e-2, te, max_grad_norm=1.0)
    step = jax.jit(jax_make_train_step(
        text_encoder_apply=te_mod.apply, frozen_text_encoder_apply=frozen_mod.apply,
        unet_apply=unet_mod.apply,
        vae_encode_moments=lambda p, x: vae_mod.apply(p, x, method="encode_moments"),
        optimizer=optimizer, schedule=JaxSchedule.create(),
        config=JaxStepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                             kpl_weight=0.1, with_image_prior=True, image_ppl_weight=0.7),
        null_embedding=None))
    te = jax.tree.map(jnp.asarray, te)
    jstate = TextBoostTrainState(step=jnp.zeros((), jnp.int32), te_params=te,
                                 opt_state=optimizer.init(te), rng=key)
    frozen = {"vae": vae, "te": frozen_te, "unet": unet, "embedding_target_norm": jnp.float32(norm),
              "null_embedding": jnp.asarray(null)}
    jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, frozen)
    _wait(launch)
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]
    return ranks, jstate, {k: float(v) for k, v in jm.items()}


def test_image_prior_step_over_two_ranks_matches_the_jax_step(prior_step):
    import flax

    from textboost_torch.models.convert import clip_key

    ranks, jstate, jm = prior_step
    for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss", "prior_loss"):
        got = [float(r[f"metric_{key}"]) for r in ranks]
        assert got[0] == got[1], key  # every rank reports the global batch's metrics
        # The tolerance of tests/test_torch_port_train_flags.py (fp32, sums in another order).
        np.testing.assert_allclose(got[0], jm[key], rtol=2e-4, atol=1e-6, err_msg=key)
    assert jm["prior_loss"] > 0
    jp = jstate.te_params["params"]
    for r in ranks:
        np.testing.assert_allclose(r["added_row"], np.asarray(jp["token_embedding"])[FIRST_ADDED],
                                   rtol=0, atol=2e-5)
    n = 0
    for path, leaf in flax.traverse_util.flatten_dict(jp).items():
        if path[-1] in ("lora_a", "lora_b"):
            base, _ = clip_key(path[:-1] + ("kernel",))
            name = base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a"
                                             else "lora_B.weight")
            assert np.array_equal(ranks[0][f"lora:{name}"], ranks[1][f"lora:{name}"]), name
            np.testing.assert_allclose(ranks[0][f"lora:{name}"], np.asarray(leaf).T, rtol=0,
                                       atol=2e-5, err_msg=name)
            n += 1
    assert n == 2 * 3 * SPEC.text_encoder.num_hidden_layers


def test_reducer_averages_exactly_what_trains(prior_step):
    ranks, _, _ = prior_step
    r0, r1 = ranks
    hidden = SPEC.text_encoder.hidden_size
    # One call; the LoRA weights, the one added row, the UNet's LoRA and
    # four loss scalars, in fp32: never the embedding's 49409 x 64 gradient.
    assert int(r0["calls"]) == 1 and int(r0["unet_values"]) > 0
    assert int(r0["values"]) == int(r0["lora_values"]) + hidden + int(r0["unet_values"]) + 4
    assert int(r0["bytes"]) == 4 * int(r0["values"])
    grads = sorted(k for k in r0 if re.fullmatch(r"local\d+", k))
    assert len(grads) == int(r0["tensors"])
    for k in grads:
        i = k[len("local"):]
        a, b = r0[f"local{i}"], r1[f"local{i}"]
        mean = (torch.from_numpy(a) + torch.from_numpy(b)) / 2
        for r in ranks:
            got = torch.from_numpy(r[f"reduced{i}"])
            if i == "0":  # the embedding: only the added rows are averaged
                assert torch.equal(got[FIRST_ADDED:], mean[FIRST_ADDED:])
                assert torch.equal(got[:FIRST_ADDED], torch.from_numpy(r[f"local{i}"])[:FIRST_ADDED])
            else:
                assert torch.equal(got, mean), k
        assert not np.array_equal(a, b), k  # the ranks' batches differ
    for key in ("loss", "den_loss", "kpl", "prior_loss"):
        want = (torch.from_numpy(r0[f"local_{key}"]) + torch.from_numpy(r1[f"local_{key}"])) / 2
        assert torch.equal(torch.from_numpy(r0[f"reduced_{key}"]), want), key
        assert torch.equal(torch.from_numpy(r1[f"reduced_{key}"]), want), key


# ---------------------------------------------------------------------------
# The loader's shards
# ---------------------------------------------------------------------------
def _loader_batches(loader_mod, ds_mod, tok_cls, instance_dir, batch, shard, shards, steps=3):
    """`steps` (instance, prior-prompt) batches of shard `shard` of `shards`
    from the package's loader over a one-image TextBoostDataset and the
    built-in prompt bank."""
    tok = tok_cls()
    tok.add_tokens("<v*>")
    ds = ds_mod.TextBoostDataset([{"instance_data_dir": instance_dir, "instance_token": "<v*>"}],
                                 tok, template="imagenet_small", size=64, seed=3)
    prior = ds_mod.PriorDataset(ds_mod.InstructPix2PixDataset(None), tok,
                                additional_template="textboost", additional_category=["dog"],
                                seed=4)
    loaders = [loader_mod.PrefetchLoader(d, batch, type(d).collate, shard_id=shard,
                                         num_shards=shards, seed=seed, num_workers=2)
               for d, seed in ((ds, 3), (prior, 4))]
    try:
        its = [iter(ld) for ld in loaders]
        return [(next(its[0]), next(its[1])) for _ in range(steps)]
    finally:
        for ld in loaders:
            ld.stop()


def test_loader_shards_are_the_halves_of_the_one_process_batch(instance_dir):
    from textboost_tpu.data import datasets as jax_datasets
    from textboost_tpu.data import loader as jax_loader
    from textboost_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
    from textboost_torch.data import datasets, loader
    from textboost_torch.data.tokenizer import HashTokenizer

    port = lambda b, k, n: _loader_batches(loader, datasets, HashTokenizer, instance_dir, b, k, n)
    jax = lambda b, k, n: _loader_batches(jax_loader, jax_datasets, JaxHashTokenizer,
                                          instance_dir, b, k, n)
    whole, jax_whole = port(4, 0, 1), jax(4, 0, 1)
    halves, jax_halves = [port(2, k, 2) for k in range(2)], [jax(2, k, 2) for k in range(2)]
    for step in range(3):
        (b, p), (jb, jp) = whole[step], jax_whole[step]
        # World 1: the JAX loader's bytes.
        assert np.array_equal(b["pixel_values"], jb["pixel_values"])
        assert np.array_equal(b["input_ids"], jb["input_ids"]) and p["prompt"] == jp["prompt"]
        # The JAX loader's shards of a one-image dataset are one batch, twice.
        (j0, jp0), (j1, jp1) = (h[step] for h in jax_halves)
        assert np.array_equal(j0["pixel_values"], j1["pixel_values"])
        assert np.array_equal(j0["input_ids"], j1["input_ids"])
        # The port's are not: together they are the one-process batch.
        (h0, hp0), (h1, hp1) = (h[step] for h in halves)
        assert not np.array_equal(h0["input_ids"], h1["input_ids"])
        for key in ("pixel_values", "input_ids"):
            assert np.array_equal(np.concatenate([h0[key], h1[key]]), b[key]), key
        assert hp0["prompt"] + hp1["prompt"] == p["prompt"]
        assert np.array_equal(np.concatenate([hp0["input_ids"], hp1["input_ids"]]), p["input_ids"])


# ---------------------------------------------------------------------------
# The mesh, the batch checks, the backend; the runners' launch
# ---------------------------------------------------------------------------
def test_mesh_and_batch_checks():
    from textboost_torch.train.config import TrainConfig
    from textboost_torch.train.trainer import local_batch_size

    # Tensor parallelism is served: 2 processes at tp 2 are one tp group.
    assert mesh.make_mesh(None, 2, world=2) == mesh.Mesh(dp=1, tp=2, rank=0)
    with pytest.raises(ValueError, match="--mesh_dp 2 x --mesh_tp 2 = 4 processes, but 2 were"):
        mesh.make_mesh(2, 2, world=2)
    with pytest.raises(ValueError, match="--mesh_dp 2 x --mesh_tp 1 = 2 processes, but 1 were"):
        mesh.make_mesh(2, 1, world=1)
    assert mesh.make_mesh(None, 1, world=4) == mesh.Mesh(dp=4, tp=1, rank=0)
    assert mesh.make_mesh(4, 1, world=4).dp == 4
    assert local_batch_size(TrainConfig(train_batch_size=8), 2) == 4
    with pytest.raises(ValueError, match=r"train_batch_size \(6\) must be divisible .* \(4\)"):
        local_batch_size(TrainConfig(train_batch_size=6), 4)
    with pytest.raises(ValueError, match="--augment_device is single-process only"):
        local_batch_size(TrainConfig(train_batch_size=8, augment_device=True), 2)
    assert local_batch_size(TrainConfig(train_batch_size=8, augment_device=True), 1) == 8


@pytest.mark.parametrize("device,local_world,cards,backend", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo"), ("cpu", 2, 0, "gloo"),
])
def test_backend_follows_the_topology(device, local_world, cards, backend):
    assert mesh.choose_backend(device, local_world, cards) == backend


def test_one_process_has_no_group(monkeypatch):
    for key in mesh.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    assert mesh.init_distributed("cpu") is None and not dist.is_initialized()
    assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)
    mesh.barrier()  # a no-op


@pytest.mark.parametrize("gpus,parallel,sequential,want,tp", [
    ("0,1", 1, False, (2, "0,1"), 1),
    ("0,1,2", 1, False, (1, "0,1,2"), 1),  # gcd(3, 8): the job runs in one process
    ("0,1", 1, True, (1, "0,1"), 1),  # in-process (where the environment is not changed)
    ("3", 2, False, None, 1),  # waves: one card per job
    ("0,1", 1, False, (2, "0,1"), 2),  # one tp group of 2
    ("0,1,2,3", 1, False, (4, "0,1,2,3"), 2),  # tp 2 x gcd(2, 8) groups
    ("0,1,2", 1, False, "refused", 2),  # 3 cards make no groups of 2
])
def test_runner_launches_a_job_over_its_cards(tmp_path, monkeypatch, capsys, gpus, parallel,
                                              sequential, want, tp):
    from textboost_torch import run_textboost_db as port_db
    from textboost_torch.utils import sweep

    calls = []
    monkeypatch.setattr(sweep, "run_job", lambda cmd, **kw: calls.append(kw))
    monkeypatch.setattr(sweep, "launch_waves", lambda jobs, n, out, archive, **kw: calls.append(
        {"waves": n, **kw}))
    argv = ["-m", "tiny", "--instances", "dog", "--outdir", str(tmp_path), "-g", gpus,
            "--parallel", str(parallel), "--mesh-tp", str(tp)] + (
        ["--sequential"] if sequential else [])
    if want == "refused":
        with pytest.raises(ValueError, match="--mesh-tp 2 splits the frozen models over groups "
                                             "of 2 cards, but 3 cards are visible"):
            port_db.main(port_db.parse_args(argv))
        assert calls == []
        return
    port_db.main(port_db.parse_args(argv))
    if want is None:
        assert calls == [{"waves": 2, "device": "cuda", "dry_run": False, "cards": ["3"]}]
        return
    nproc, visible = want
    assert calls == [{"sequential": sequential, "device": "cuda", "nproc": nproc,
                      "env": {"CUDA_VISIBLE_DEVICES": visible} if visible else {}}]
    with open(tmp_path / "dog" / "cmd.txt") as f:
        first = f.readline().strip()
    launcher = (f"python -m torch.distributed.run --standalone --nproc_per_node={nproc} "
                if nproc > 1 else "python ")
    assert first == launcher + "-m textboost_torch.train"
    assert first in capsys.readouterr().out
    argv_ = sweep.train_command(["--x"], "cuda", nproc)
    assert argv_[1:] == first.split()[1:] + ["--x", "--device=cuda"]


def test_runner_refuses_parallel_jobs_of_several_cards(tmp_path):
    from textboost_torch import run_textboost_sdrp as port_sdrp

    args = port_sdrp.parse_args(["-g", "0,1,2,3", "--parallel", "2", "--dry-run"])
    with pytest.raises(ValueError, match="--parallel 2 runs one card per job, but 4 cards"):
        port_sdrp.run_jobs(args, port_sdrp.INSTANCES[:2], str(tmp_path), "sd21")


if __name__ == "__main__":
    _rank_program(sys.argv[1])
