"""The benchmark's contact with the measured package, `textboost_torch`:
the hand-off of the run's weights, the check that the package's preset has
the configuration's sizes, and the record of the four kernels' calls.

The package takes base weights only from a snapshot dir or from its own
seeded preset init.  A snapshot would write gigabytes per run, so the
hand-off is in memory: while `weights_into(...)` is active, every
`load_models` that the named modules call builds the preset as usual and
then has the run's weights copied into it (every key of each component,
the LoRA adapters included where the run gives them), the memo's pristine
text encoder too.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterable

import torch


def check_preset(config: dict) -> None:
    """Raise unless the package's preset `config["preset"]` has the sizes the
    configuration file states."""
    from textboost_torch.models.configs import get_spec

    spec = get_spec(config["preset"])
    te, un, va = config["text_encoder"], config["unet"], config["vae"]
    heads = un["attention_head_dim"]
    heads = tuple(heads) if isinstance(heads, list) else (heads,) * len(un["block_out_channels"])
    want = {
        "text hidden": (spec.text_encoder.hidden_size, te["hidden_size"]),
        "text ffn": (spec.text_encoder.intermediate_size, te["intermediate_size"]),
        "text layers": (spec.text_encoder.num_hidden_layers, te["num_hidden_layers"]),
        "text heads": (spec.text_encoder.num_attention_heads, te["num_attention_heads"]),
        "text act": (spec.text_encoder.hidden_act, te["hidden_act"]),
        "unet channels": (tuple(spec.unet.block_out_channels), tuple(un["block_out_channels"])),
        "unet heads": (tuple(spec.unet.num_attention_heads), heads),
        "unet cross dim": (spec.unet.cross_attention_dim, un["cross_attention_dim"]),
        "unet linear proj": (spec.unet.use_linear_projection, un["use_linear_projection"]),
        "unet layers": (spec.unet.layers_per_block, un["layers_per_block"]),
        "unet sample": (spec.unet.sample_size, un["sample_size"]),
        "vae channels": (tuple(spec.vae.block_out_channels), tuple(va["block_out_channels"])),
        "vae scaling": (spec.vae.scaling_factor, va["scaling_factor"]),
        "resolution": (spec.resolution, config["resolution"]),
        "prediction": (spec.scheduler.prediction_type, config["scheduler"]["prediction_type"]),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"the package's preset {config['preset']!r} differs from the "
                         f"configuration (package, file): {bad}")


@torch.no_grad()
def copy_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], part: str) -> None:
    """Copy `weights` into `module`'s tensors of the same keys; every base
    key of the module must be given (LoRA adapters may keep theirs)."""
    state = module.state_dict()
    missing = [k for k in state if k not in weights and ".lora_" not in k]
    extra = [k for k in weights if k not in state]
    if missing or extra:
        raise KeyError(f"{part}: the run's weights do not fit the package's module: missing "
                       f"{missing[:4]} ({len(missing)}), unexpected {extra[:4]} ({len(extra)})")
    for k, t in weights.items():
        state[k].copy_(t)


@contextlib.contextmanager
def weights_into(weights: Dict[str, Dict[str, torch.Tensor]], preset: str, modules: Iterable):
    """While active, `load_models` as called from each of `modules` builds
    `preset` (whatever base it was asked for) and returns the bundle with
    `weights` ({part: {key: tensor}}) copied in."""
    from textboost_torch.models import pretrained

    real = pretrained.load_models

    def load(model_name_or_path=None, **kwargs):
        bundle = real(None, **{**kwargs, "preset": preset})
        for part in pretrained.PARTS:
            copy_into(getattr(bundle, part), weights[part], part)
        if bundle.frozen_text_encoder is not None:
            copy_into(bundle.frozen_text_encoder, weights["text_encoder"], "text_encoder")
        pretrained._PRESET_MEMO.clear()  # its pristine copy and guard hold the old bits
        return bundle

    modules = list(modules)
    saved = [m.load_models for m in modules]
    for m in modules:
        m.load_models = load
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.load_models = fn


WRAPPERS = ("flash", "flash_bwd", "gn", "gn_bwd")  # the four kernels' Python wrappers


class KernelCalls:
    """Counts of every call of the four kernel wrappers by shape and dtype.
    A CUDA graph's replay makes no Python call: the calls its capture made
    are taken back when the capture ends (it launched nothing) and added at
    each replay.  `snapshot()` gives the counts so far; the difference of two
    is what ran between them."""

    def __init__(self):
        self.counts = {name: collections.Counter() for name in WRAPPERS}
        self._undo = []

    def __enter__(self):
        from textboost_torch import graphs as graph_mod
        from textboost_torch.ops import flash_attention as fa
        from textboost_torch.ops import group_norm as gn

        wrappers = {"flash": (fa, "flash_attention_forward"),
                    "flash_bwd": (fa, "flash_attention_backward"),
                    "gn": (gn, "group_norm_forward"), "gn_bwd": (gn, "group_norm_backward")}
        counts = self.counts

        def recording(name, real):
            def call(*args, **kwargs):
                x = args[0]
                if name.startswith("flash"):
                    key = (*x.shape, args[1].shape[1], str(x.dtype))  # B, N, H, D, M
                else:
                    key = (tuple(x.shape), str(x.dtype))
                counts[name][key] += 1
                return real(*args, **kwargs)
            return call

        for name, (mod, attr) in wrappers.items():
            real = getattr(mod, attr)
            setattr(mod, attr, recording(name, real))
            self._undo.append((mod, attr, real))

        real_capture, real_replay = graph_mod.Graph.capture, graph_mod.Graph.replay

        def capture(graph, fn):
            before = self.snapshot()
            try:
                return real_capture(graph, fn)
            finally:
                graph.portbench_calls = {k: counts[k] - before[k] for k in counts}
                for k, c in counts.items():
                    c.clear()
                    c.update(before[k])

        def replay(graph):
            out = real_replay(graph)
            for k, c in getattr(graph, "portbench_calls", {}).items():
                counts[k].update(c)
            return out

        graph_mod.Graph.capture, graph_mod.Graph.replay = capture, replay
        self._undo += [(graph_mod.Graph, "capture", real_capture),
                       (graph_mod.Graph, "replay", real_replay)]
        return self

    def __exit__(self, *exc):
        for obj, attr, real in reversed(self._undo):
            setattr(obj, attr, real)
        self._undo = []

    def snapshot(self) -> Dict[str, collections.Counter]:
        return {k: collections.Counter(c) for k, c in self.counts.items()}
