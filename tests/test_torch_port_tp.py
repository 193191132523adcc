"""Tensor parallelism of the port over torch.distributed, on the CPU (gloo).

  * `python -m torch.distributed.run --nproc_per_node 2 -m
    textboost_torch.train --mesh_tp 2` at `tiny` (global batch 4, 3 steps,
    a checkpoint at 2, --unet_params_to_train crossattn_kv) against the same
    CLI in one process: per-step losses, the final metrics, the checkpoint
    and the exported adapters and token bins; rank 1 writes nothing, the
    tensor-parallel collectives are counted, and a 2-rank resume from
    checkpoint-2 lands on the straight run;
  * one step at world 4 (dp 2 x tp 2) with the image prior, the UNet's
    kv-LoRA and gradient checkpointing, on a `tiny` variant whose level-0
    head count (1) does not divide tp, so that split and whole attentions
    run in one step, against the JAX package's `make_train_step` on the
    global batch; the same ranks hold the two autograd collectives' forward
    and backward values (this file is the ranks' program: `python -m
    test_torch_port_tp <dir>`);
  * `parallel/validate.py`'s reports at sd15 (against the JAX package's
    `tp_rule_report` on `jax.eval_shape` trees) and sd21base;
  * the mesh's layout, and the shards and draws that give the ranks of a
    tp group the same rows.

Every process runs on one torch thread, as the port's other test files do.
"""
import dataclasses
import os
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_port_dp import (
    _artifacts,
    _files,
    _flags,
    _jax_tree,
    _losses,
    _null_and_norm,
    _records,
    _rel,
    _start,
    _wait,
    _weights,
    instance_dir,  # noqa: F401 (a fixture)
)
from textboost_torch.lora.partition import lora_parameters, lr_schedule, make_optimizer, set_trainable
from textboost_torch.lora.peft_io import load_safetensors
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.pretrained import build_models
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.parallel import mesh
from textboost_torch.parallel.tensor import (
    TP_RULES,
    TensorParallel,
    copy_to_tp,
    reduce_from_tp,
    shard_,
    tp_partial_parameters,
    tp_rule_report,
)
from textboost_torch.train.step import StepConfig, TrainState, make_train_step

SPEC = get_spec("tiny")
# Level 0 keeps one head: its attentions stay whole at tp 2, the others split.
VARIANT = dataclasses.replace(SPEC, unet=dataclasses.replace(SPEC.unet,
                                                             num_attention_heads=(1, 2, 2, 2)))
FIRST_ADDED = 49408
EMB_KEY = "text_model.embeddings.token_embedding.weight"
REL = 1e-5  # losses and metrics: 2 tp ranks against one process, fp32
# The exports after 3 AdamW steps.  The sharded frozen encoder's outputs
# differ from the whole one's in the last bits (the row-parallel sums), and
# the KPL gradient at step 1 is the difference of two equal encodings: on
# an x86-64 CPU the largest gap was 1.4e-5 (layer 0's q_proj lora_B).
EXPORT_REL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The CLI: 2 tp ranks against one process, and a 2-rank resume
# ---------------------------------------------------------------------------
def _tp_flags(instance_dir, out, *extra):
    return _flags(instance_dir, out, "--unet_params_to_train", "crossattn_kv", *extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, instance_dir):  # noqa: F811
    from textboost_torch.train import main as train_main

    root = tmp_path_factory.mktemp("tp")
    dirs = {name: str(root / name) for name in ("one", "two", "resumed")}
    two = _start(2, ["-m", "textboost_torch.train",
                     *_tp_flags(instance_dir, dirs["two"], "--mesh_tp", "2")], root)
    train_main(_tp_flags(instance_dir, dirs["one"]))
    stdout = _wait(two)
    shutil.copytree(os.path.join(dirs["two"], "checkpoint-2"),
                    os.path.join(dirs["resumed"], "checkpoint-2"))
    _wait(_start(2, ["-m", "textboost_torch.train", *_tp_flags(
        instance_dir, dirs["resumed"], "--mesh_tp", "2", "--resume_from_checkpoint", "latest")],
        root))
    return dirs, stdout


def _all_artifacts(run_dir):
    """`_artifacts` and the `unet/` adapters (final and checkpoint-2)."""
    out = _artifacts(run_dir)
    for d in ("", "checkpoint-2"):
        path = os.path.join(run_dir, d, "unet", "adapter_model.safetensors")
        out.update({f"{d}/unet/{k}": v for k, v in load_safetensors(path).items()})
    return out


def test_tp_ranks_train_as_one_process(runs):
    dirs, stdout = runs
    assert stdout.count("backend gloo, device cpu") == 2
    one, two = _losses(dirs["one"]), _losses(dirs["two"])
    assert sorted(one) == sorted(two) == [1, 2, 3]
    for s in one:
        assert abs(two[s] - one[s]) <= REL * abs(one[s]), (s, one[s], two[s])
    (r1,), (r2,) = ([r for r in _records(d) if r["step"] == 3] for d in (dirs["one"], dirs["two"]))
    for key in ("loss", "den_loss", "grad_norm", "added_embedding_norm"):
        assert abs(r2[key] - r1[key]) <= REL * abs(r1[key]), key
    # kpl is 1 - cos of near-equal encodings in fp32, where the frozen one
    # differs in its last bits: within an fp32 ulp of a cosine near 1 (6e-8).
    assert abs(r2["kpl"] - r1["kpl"]) <= 6e-8
    a1, a2 = _all_artifacts(dirs["one"]), _all_artifacts(dirs["two"])
    assert sorted(a1) == sorted(a2) and sum("/unet/" in k for k in a1) == 2 * 2 * 2 * 10
    for name in a1:
        assert _rel(a2[name], a1[name]) <= EXPORT_REL, name


def test_tp_rank_zero_alone_writes_and_counts_the_collectives(runs):
    dirs, _ = runs
    assert _files(dirs["two"]) == _files(dirs["one"])
    with open(os.path.join(dirs["two"], "training.log")) as f:
        log = f.read()
    assert log.count("Training took") == log.count("Saving state") == 1
    assert "tensor parallel over 2 ranks (dp 1 x tp 2), UNet: 110 weights split" in log
    # A step at tiny: the frozen encoder's 2 layers x 2 blocks + its embedding,
    # and the UNet's 10 transformer blocks x (attn1, attn2, ff) forward; the
    # backward sums the inputs of the 10 x 4 column-parallel regions but the
    # first block's attn1 and attn2 inputs, which the text does not reach.
    m = re.search(r"tensor-parallel all-reduces a step: (\d+) forward \+ (\d+) backward, "
                  r"(\d+) bytes", log)
    assert m and (int(m.group(1)), int(m.group(2))) == (2 * 2 + 1 + 10 * 3, 10 * 4 - 2)


def test_tp_resume_lands_on_the_straight_run(runs):
    dirs, _ = runs
    straight, resumed = _losses(dirs["two"]), _losses(dirs["resumed"])
    assert sorted(resumed) == [3] and resumed[3] == straight[3]
    a, b = _all_artifacts(dirs["two"]), _all_artifacts(dirs["resumed"])
    for name in a:
        assert np.array_equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# World 4 (dp 2 x tp 2): the collectives, and one step against the JAX step
# ---------------------------------------------------------------------------
STEP = StepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                  kpl_weight=0.1, max_grad_norm=1.0, with_image_prior=True, image_ppl_weight=0.7)


def _port_state(weights):
    """The step's state on the variant at fp32 with the UNet's LoRA training
    and gradient checkpointing (as tests/test_torch_port_dp.py builds it)."""
    te, unet, vae = build_models(VARIANT, lora_rank=4, unet_lora_rank=4, device="cpu")
    frozen_te = CLIPTextModel(VARIANT.text_encoder, lora_rank=4)
    te.set_token_embedding(torch.zeros(FIRST_ADDED + 1, 64))
    tensors = lambda sd: {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    te.load_state_dict(tensors(weights["text_encoder"]), strict=True)
    frozen_te.load_state_dict(tensors(dict(weights["text_encoder"], **{
        EMB_KEY: weights["text_encoder"][EMB_KEY][:FIRST_ADDED]})), strict=True)
    unet.load_state_dict(tensors(weights["unet"]), strict=True)
    vae.load_state_dict(tensors(weights["vae"]), strict=True)
    for mod in (te, frozen_te, unet, vae):
        mod.requires_grad_(False)
    unet.gradient_checkpointing = True
    set_trainable(te, unet)
    optimizer = make_optimizer(te, 1e-3, 1e-2, unet=unet)
    null, norm = _null_and_norm(weights)
    return TrainState(
        text_encoder=te, frozen_text_encoder=frozen_te, unet=unet, vae=vae, optimizer=optimizer,
        lr_scheduler=lr_schedule(optimizer, "constant", 0, 1), schedule=NoiseSchedule.create(),
        null_embedding=torch.from_numpy(null.copy()), target_norm=torch.tensor(norm),
        original_rows=te.token_embedding.weight[:FIRST_ADDED].clone(),
        unet_lora=lora_parameters(unet))


def _rank_program(work: str) -> None:
    """One rank of the world-4 launch: the two collectives on known values
    over its tp group, then one step on its dp index's rows with the frozen
    encoder and the UNet split over the group; writes rank{r}.npz."""
    torch.set_num_threads(1)
    assert mesh.init_distributed("cpu") == "gloo"
    m = mesh.make_mesh(2, 2)
    tp = TensorParallel(m.tp_group, m.tp, m.tp_index)
    r = m.rank
    out = {"dp_index": m.dp_index, "tp_index": m.tp_index}
    for name, fn in (("reduce", reduce_from_tp), ("copy", copy_to_tp)):
        x = torch.full((3,), float(r + 1), requires_grad=True)
        y = fn(x, tp)
        y.backward(torch.arange(3.0) * (r + 1))
        out[f"{name}_fwd"], out[f"{name}_bwd"] = y.detach().numpy(), x.grad.numpy()

    inputs = np.load(os.path.join(work, f"inputs{m.dp_index}.npz"))
    batch = {k: torch.from_numpy(inputs[k]).long() if inputs[k].dtype == np.int32
             else torch.from_numpy(inputs[k]) for k in ("pixel_values", "input_ids",
                                                          "prior_input_ids")}
    draws = {k: torch.from_numpy(inputs[k]) for k in ("noise", "vae_eps", "timesteps")}
    state = _port_state(_weights())
    plans = {name: shard_(getattr(state, name), tp) for name in ("frozen_text_encoder", "unet")}
    te = state.text_encoder
    step = make_train_step(STEP, reduce=mesh.GradReducer(
        te.token_embedding.weight, FIRST_ADDED, lora_parameters(te) + state.unet_lora,
        tp_partial=tp_partial_parameters(state.unet), tp=m.tp))
    calls = tp.calls
    metrics = step(state, batch, draws)
    out.update({f"metric_{k}": v.numpy() for k, v in metrics.items()})
    out["added_row"] = te.token_embedding.weight[FIRST_ADDED].detach().numpy()
    out.update({f"lora:{n}": p.detach().numpy() for n, p in te.named_parameters() if ".lora_" in n})
    out.update({f"unet:{n}": p.detach().numpy() for n, p in state.unet.named_parameters()
                if ".lora_" in n})
    out["whole"] = sorted(plans["unet"].whole)
    out["step_calls"] = tp.calls - calls
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4_step(tmp_path_factory):
    """The JAX step on the global batch [instance_0, instance_1, class_0,
    class_1] and the 4 ranks' outputs, dp index d on [instance_d, class_d]."""
    import flax
    import jax
    import jax.numpy as jnp

    from textboost_tpu.lora.partition import make_optimizer as jax_make_optimizer
    from textboost_tpu.lora.partition import split_lora
    from textboost_tpu.models import CLIPTextModel as JaxCLIP
    from textboost_tpu.models.configs import get_spec as jax_get_spec
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

    work = str(tmp_path_factory.mktemp("world4"))
    for d in range(2):
        rows = [d, 2 + d]  # this dp index's instance row, then its class row
        np.savez(os.path.join(work, f"inputs{d}.npz"), prior_input_ids=kpl[d:d + 1],
                 **{k: batch[k][rows] for k in ("pixel_values", "input_ids")},
                 **{k: v[rows] for k, v in draws.items()})
    launch = _start(4, ["-m", "test_torch_port_tp", work], work)  # runs while JAX compiles

    weights = _weights()
    jspec = jax_get_spec("tiny")
    junet_cfg = dataclasses.replace(jspec.unet, num_attention_heads=VARIANT.unet.num_attention_heads)
    te_mod = JaxCLIP(jspec.text_encoder, lora_rank=4, dtype=jnp.float32,
                     vocab_size_override=FIRST_ADDED + 1)
    frozen_mod = JaxCLIP(jspec.text_encoder, dtype=jnp.float32)
    unet_mod = JaxUNet(junet_cfg, dtype=jnp.float32, remat=True, cross_lora_rank=4)
    vae_mod = JaxVAE(jspec.vae, dtype=jnp.float32)
    tok = (jnp.zeros((1, 77), jnp.int32),)
    te = _jax_tree(te_mod, tok, weights["text_encoder"], clip_key)
    base_sd = dict(weights["text_encoder"], **{EMB_KEY: weights["text_encoder"][EMB_KEY][:FIRST_ADDED]})
    frozen_te = _jax_tree(frozen_mod, tok, base_sd, clip_key)
    s = jspec.unet.sample_size
    unet = _jax_tree(unet_mod, (jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 77, 64))), weights["unet"], unet_key)
    vae = _jax_tree(vae_mod, (jnp.zeros((1, 64, 64, 3)), key), weights["vae"], None)
    null, norm = _null_and_norm(weights)
    base_flat, lora_flat = split_lora(unet)
    trainable = jax.tree.map(jnp.asarray, {"te": te, "unet_lora": lora_flat})
    optimizer = jax_make_optimizer(1e-3, 1e-2, trainable, max_grad_norm=1.0)
    step = jax.jit(jax_make_train_step(
        text_encoder_apply=te_mod.apply, frozen_text_encoder_apply=frozen_mod.apply,
        unet_apply=unet_mod.apply,
        vae_encode_moments=lambda p, x: vae_mod.apply(p, x, method="encode_moments"),
        optimizer=optimizer, schedule=JaxSchedule.create(),
        config=JaxStepConfig(vae_scaling=SPEC.vae.scaling_factor, first_added_token_id=FIRST_ADDED,
                             kpl_weight=0.1, train_unet=True, with_image_prior=True,
                             image_ppl_weight=0.7),
        null_embedding=None))
    jstate = TextBoostTrainState(step=jnp.zeros((), jnp.int32), te_params=trainable,
                                 opt_state=optimizer.init(trainable), rng=key)
    frozen = {"vae": vae, "te": frozen_te, "unet_base": base_flat,
              "embedding_target_norm": jnp.float32(norm), "null_embedding": jnp.asarray(null)}
    jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, frozen)
    _wait(launch)
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(4)]
    jte = flax.traverse_util.flatten_dict(jstate.te_params["te"]["params"])
    want = {"added_row": np.asarray(jte[("token_embedding",)])[FIRST_ADDED]}
    for path, leaf in jte.items():
        if path[-1] in ("lora_a", "lora_b"):
            base, _ = clip_key(path[:-1] + ("kernel",))
            want["lora:" + base[: -len("weight")] + {"lora_a": "lora_A.weight",
                                                     "lora_b": "lora_B.weight"}[path[-1]]] = leaf.T
    for path, leaf in jstate.te_params["unet_lora"].items():
        base, _ = unet_key(path[:-1] + ("kernel",))
        want["unet:" + base[: -len("weight")] + {"lora_a": "lora_A.weight",
                                                 "lora_b": "lora_B.weight"}[path[-1]]] = leaf.T
    return ranks, {k: np.asarray(v) for k, v in want.items()}, {k: float(v) for k, v in jm.items()}


def test_world4_step_matches_the_jax_step(world4_step):
    ranks, want, jm = world4_step
    assert [(int(r["dp_index"]), int(r["tp_index"])) for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                                         (1, 1)]
    for key in ("loss", "kpl", "grad_norm", "added_embedding_norm", "den_loss", "prior_loss"):
        got = [float(r[f"metric_{key}"]) for r in ranks]
        assert len(set(got)) == 1, (key, got)  # every rank reports the global batch's
        # The tolerance of tests/test_torch_port_dp.py (fp32, sums in another order).
        np.testing.assert_allclose(got[0], jm[key], rtol=2e-4, atol=1e-6, err_msg=key)
    assert jm["prior_loss"] > 0
    assert sum(k.startswith("unet:") for k in want) == 2 * 2 * 10
    for name, leaf in want.items():
        for r in ranks:  # every rank holds the same whole trainable weights
            assert np.array_equal(r[name], ranks[0][name]), name
        np.testing.assert_allclose(ranks[0][name], leaf, rtol=0, atol=2e-5, err_msg=name)
    # Level 0's attentions (1 head) stayed whole, the others split; the step
    # ran the collectives of both.
    whole = list(ranks[0]["whole"])
    assert whole and all(re.match(r"(down|up)_blocks\.(0|3)\.attentions\.\d\.transformer_blocks"
                                  r"\.0\.attn[12]\.to_(q|k|v|out\.0)\.weight$", k) for k in whole)
    assert len(whole) == (1 + 2) * 2 * 4 and int(ranks[0]["step_calls"]) > 0


def test_autograd_collectives(world4_step):
    ranks, _, _ = world4_step
    g = np.arange(3.0)
    for r, out in enumerate(ranks):
        peers = [p for p in range(4) if p // 2 == r // 2]  # this rank's tp group
        # reduce_from_tp: the sum forward, the gradient as it came backward.
        np.testing.assert_array_equal(out["reduce_fwd"], np.full(3, sum(p + 1 for p in peers)))
        np.testing.assert_array_equal(out["reduce_bwd"], g * (r + 1))
        # copy_to_tp: identity forward, the sum of the gradients backward.
        np.testing.assert_array_equal(out["copy_fwd"], np.full(3, r + 1.0))
        np.testing.assert_array_equal(out["copy_bwd"], g * sum(p + 1 for p in peers))


# ---------------------------------------------------------------------------
# The rules at real dims; the mesh; the shards and draws of a tp group
# ---------------------------------------------------------------------------
CLIP_QKV, UNET_QKV, EMBEDDING = TP_RULES[0][0], TP_RULES[6][0], TP_RULES[11][0]


def test_validate_reports_every_rule_at_sd15_as_the_jax_report():
    import jax
    import jax.numpy as jnp

    from textboost_tpu.models import CLIPTextModel as JaxCLIP
    from textboost_tpu.models import get_spec as jax_get_spec
    from textboost_tpu.models.unet import UNet2DCondition as JaxUNet
    from textboost_tpu.parallel.mesh import _TP_RULES, make_mesh, tp_rule_report as jax_report
    from textboost_torch.parallel.validate import validate_tp_rules_at_shape

    report = validate_tp_rules_at_shape("sd15", 2)
    matches = report["tp_rule_matches"]
    assert all(n > 0 for n in matches.values()) and report["whole"] == {}
    assert (matches[CLIP_QKV], matches[UNET_QKV], matches[EMBEDDING]) == (36, 96, 1)
    # The JAX report over the same models' shape trees, rule by rule (the
    # two tables list the same twelve rules in one order).
    spec, key = jax_get_spec("sd15"), jax.random.PRNGKey(0)
    trees = [jax.eval_shape(JaxCLIP(spec.text_encoder).init, key, jnp.zeros((1, 77), jnp.int32)),
             jax.eval_shape(JaxUNet(spec.unet).init, key, jnp.zeros((1, 64, 64, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)))]
    jax_mesh = make_mesh(dp=jax.device_count() // 2, tp=2)
    jax_counts = [0] * len(_TP_RULES)
    for tree in trees:
        counts, indivisible = jax_report(tree, jax_mesh)
        assert indivisible == {}
        jax_counts = [n + counts[p] for n, (p, _) in zip(jax_counts, _TP_RULES)]
    assert list(matches.values()) == jax_counts


def test_validate_leaves_sd21base_level0_attention_whole():
    from textboost_torch.parallel.validate import validate_tp_rules_at_shape

    report = validate_tp_rules_at_shape("sd21base", 2)
    whole = sorted(report["whole"])
    # Level 0 (5 heads): 2 down and 3 up transformer blocks x 2 attentions
    # x (q, k, v, out), and nothing else.
    assert len(whole) == 5 * 2 * 4
    assert all(re.fullmatch(r"unet/(down_blocks\.0\.attentions\.[01]|up_blocks\.3\.attentions\.[012])"
                            r"\.transformer_blocks\.0\.attn[12]\.to_(q|k|v|out\.0)\.weight", k)
               for k in whole), whole
    assert report["tp_rule_matches"][UNET_QKV] == (16 - 5) * 2 * 3
    assert report["tp_rule_matches"][CLIP_QKV] == 23 * 3
    # A step's all-reduces: forward, the frozen encoder's 23 layers x 2 and
    # its embedding, and the UNet's 11 split attention blocks x 2 and 16 FFs;
    # backward, the 11 x 3 split attentions' inputs (attn2's context too)
    # and the 16 FFs'.
    assert report["collectives"]["fwd"] == 23 * 2 + 1 + 11 * 2 + 16
    assert report["collectives"]["bwd"] == 11 * 3 + 16


def test_rule_report_lists_what_stays_whole():
    unet = build_models(VARIANT, device="cpu")[1]
    counts, whole = tp_rule_report(unet, 2)
    assert len(whole) == 3 * 2 * 4 and counts[UNET_QKV] == 7 * 2 * 3
    assert tp_rule_report(unet, 1)[1] == {}  # tp 1 divides everything


def test_mesh_lays_the_world_out_as_dp_by_tp(monkeypatch):
    for r, (d, t) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        got = mesh.make_mesh(None, 2, world=4)
        assert got == mesh.Mesh(dp=2, tp=2, rank=r, dp_index=d, tp_index=t)
    with pytest.raises(ValueError, match="--mesh_dp 1 x --mesh_tp 2 = 2 processes, but 3 were"):
        mesh.make_mesh(None, 2, world=3)


def test_shards_and_draws_give_a_tp_group_the_same_rows(monkeypatch):
    from textboost_torch.data.sharding import process_shard_info
    from textboost_torch.train.config import TrainConfig
    from textboost_torch.train.step import sample_draws
    from textboost_torch.train.trainer import Trainer

    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    draws = {}
    for r in range(4):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        # tp 2: the dp index (r // 2) of 2; tp 1: the rank of 4, as before.
        assert process_shard_info(tp=2) == (r // 2, 2)
        assert process_shard_info(2, 1, tp=2) == (r // 2 * 2 + 1, 4)
        assert process_shard_info() == (r, 4)
        for tp in (1, 2):
            m = mesh.make_mesh(None, tp, world=4)
            trainer = types.SimpleNamespace(
                config=TrainConfig(train_batch_size=4, with_image_prior=True),
                local_batch_size=4 // m.dp, mesh=m, latent_shape=(4, 2, 2),
                generator=torch.Generator().manual_seed(0), schedule=NoiseSchedule.create(),
                step_config=StepConfig())
            draws[tp, r] = Trainer._draws(trainer)
    whole = sample_draws(torch.Generator().manual_seed(0), batch_size=8, latent_shape=(4, 2, 2),
                         schedule=NoiseSchedule.create())
    for k, v in whole.items():
        for r in range(4):
            # tp 1: rank r takes instance row r and class row 4 + r, as before.
            assert torch.equal(draws[1, r][k], v[[r, 4 + r]])
            # tp 2: both ranks of dp index d take instance rows 2d, 2d + 1
            # and the class rows after them.
            d = r // 2
            assert torch.equal(draws[2, r][k], v[[2 * d, 2 * d + 1, 4 + 2 * d, 5 + 2 * d]])


if __name__ == "__main__":
    _rank_program(sys.argv[1])
