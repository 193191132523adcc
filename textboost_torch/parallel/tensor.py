"""Tensor parallelism of the frozen models over a tp process group.

Counterpart of `_TP_RULES`, `param_sharding`, `tp_rule_report` and
`shard_params` (textboost_tpu/parallel/mesh.py:109-207).  In JAX the split
is declarative: GSPMD shards a weight wherever its width divides tp and
inserts whatever collectives keep the result exact.  Here each rank is one
process holding a slice, so the split follows the computation (the
Megatron layout):

- an attention splits by whole heads: q/k/v are column-parallel (each rank
  computes its heads), the output projection row-parallel (each rank
  multiplies its heads' rows of it; one all-reduce sums the parts, then the
  bias is added once);
- a feed-forward splits its hidden width: CLIP's fc1 and the UNet's GEGLU
  projection column-parallel (the GEGLU's rank r takes its slice of each
  of the [hidden | gate] halves, so that its own chunk(2) pairs them), the
  second projection row-parallel;
- the CLIP token embedding splits its vocabulary rows: a masked lookup,
  then an all-reduce.

Two autograd Functions carry the collectives: `copy_to_tp` (identity
forward, all-reduce backward) at the input of a column-parallel block, and
`reduce_from_tp` (all-reduce forward, identity backward) at the output of
a row-parallel one.  A block whose heads or width do not divide tp stays
whole on every rank (JAX's indivisible -> replicated), as does every module
that no rule names (convolutions, norms, the VAE).  The trainer shards the
frozen UNet and the frozen (KPL) text encoder; the trainable text encoder
stays whole (textboost_tpu/train/trainer.py:668-676).

`TP_RULES` names the split of each weight by its state-dict key; `plan`
says which weights of a model split on rank r, `shard_` slices them in
place from the full weights every rank loaded, and `tp_rule_report` counts
the rules as the JAX report does.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# (pattern on the state-dict key, split).  A torch weight is [out, in]:
# "columns" (column-parallel, JAX P(None, "tp") on the [in, out] kernel)
# takes dim 0, "rows" (row-parallel) dim 1; "geglu" takes dim 0 from each
# half; "vocab" the embedding's rows.  Biases of column-parallel weights
# split with them; those of row-parallel ones stay whole.
TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r".*self_attn\.(q|k|v)_proj\.weight$", "columns"),
    (r".*self_attn\.(q|k|v)_proj\.bias$", "columns"),
    (r".*self_attn\.out_proj\.weight$", "rows"),
    (r".*mlp\.fc1\.weight$", "columns"),
    (r".*mlp\.fc1\.bias$", "columns"),
    (r".*mlp\.fc2\.weight$", "rows"),
    (r".*attn[12]\.to_(q|k|v)\.weight$", "columns"),
    (r".*attn[12]\.to_out\.0\.weight$", "rows"),
    (r".*ff\.net\.0\.proj\.weight$", "geglu"),
    (r".*ff\.net\.0\.proj\.bias$", "geglu"),
    (r".*ff\.net\.2\.weight$", "rows"),
    (r".*token_embedding\.weight$", "vocab"),
)


class TensorParallel:
    """A tp group as the sharded modules see it: its process group (None
    on the meta device, where the collectives are skipped), size and this
    rank's index, and the count of its collectives: one entry per
    all-reduce in `kinds` ("fwd" or "bwd") and `bytes`, and its time
    (`milliseconds`: CUDA events on the card, around the host copies, gloo
    and the wait for the peers; the host clock on the CPU)."""

    def __init__(self, group: Optional[dist.ProcessGroup], size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.kinds: List[str] = []
        self.bytes: List[int] = []
        self._host_ms: List[float] = []
        self._marks: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._host: Dict[Tuple[torch.Size, torch.dtype], torch.Tensor] = {}

    @property
    def calls(self) -> int:
        return len(self.kinds)

    def all_reduce(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The sum of `x` over the group, in a new tensor (on the meta
        device, where only shapes exist, `x` itself: the call is counted,
        not timed)."""
        self.kinds.append(kind)
        self.bytes.append(x.numel() * x.element_size())
        if x.is_meta:
            return x.clone()
        x = x.contiguous()
        cuda = x.is_cuda
        if cuda:
            marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            marks[0].record()
        t0 = time.perf_counter()
        if cuda and dist.get_backend(self.group) == "gloo":
            # gloo reduces host memory: through a pinned buffer (the copies
            # are synchronous, so one buffer a shape serves every call).
            host = self._host.get((x.shape, x.dtype))
            if host is None:
                host = self._host[(x.shape, x.dtype)] = torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            dist.all_reduce(host, group=self.group)
            out = torch.empty_like(x).copy_(host)
        else:
            out = x.clone()
            dist.all_reduce(out, group=self.group)
        if cuda:
            marks[1].record()
            self._marks.append(marks)
        else:
            self._host_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def milliseconds(self) -> List[float]:
        """Each timed all-reduce's time, in call order (one device, so
        either all events or all host times)."""
        for _, end in self._marks:
            end.synchronize()
        return self._host_ms + [a.elapsed_time(b) for a, b in self._marks]


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward (each
    rank's heads or columns contributed a part of it)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad, "bwd"), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial outputs summed over the group forward; identity backward
    (every rank's part takes the whole gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x, "fwd")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp)


def row_parallel_linear(linear: nn.Linear, x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """`linear(x)` of a row-parallel linear: this rank's rows times its part
    of x, summed over the group, then the whole bias, once."""
    y = reduce_from_tp(F.linear(x, linear.weight), tp)
    return y if linear.bias is None else y + linear.bias


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Plan:
    """One rank's shards of a model: `splits` maps each split weight's key
    to (rule pattern, dim, the indices of the whole it keeps); `whole`
    maps each weight a rule matched but that stays whole to its shape."""

    splits: Dict[str, Tuple[str, int, torch.Tensor]]
    whole: Dict[str, Tuple[int, ...]]


def _rule(key: str) -> Optional[Tuple[str, str]]:
    for pattern, split in TP_RULES:
        if re.match(pattern, key):
            return pattern, split
    return None


def _indices(split: str, n: int, size: int, rank: int) -> Tuple[int, torch.Tensor]:
    """(dim, indices) of rank's shard of a weight whose split axis is n long."""
    if split == "geglu":  # rank's slice of each of the [hidden | gate] halves
        half, k = n // 2, n // 2 // size
        return 0, torch.cat([torch.arange(rank * k, (rank + 1) * k),
                             torch.arange(half + rank * k, half + (rank + 1) * k)])
    k = n // size
    return (1 if split == "rows" else 0), torch.arange(rank * k, (rank + 1) * k)


def _units(model: nn.Module):
    """(prefix, module, width that must divide tp, its weights) of every
    block a rule names: attentions (their head count), feed-forwards
    (their hidden width) and the CLIP model's token embedding (its
    vocabulary)."""
    from ..models.clip import CLIPAttention, CLIPMLP, CLIPTextModel
    from ..models.layers import CrossAttention, FeedForward

    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, (CLIPAttention, CrossAttention)):
            yield prefix, mod, mod.heads, mod.named_parameters()
        elif isinstance(mod, CLIPMLP):
            yield prefix, mod, mod.fc1.out_features, mod.named_parameters()
        elif isinstance(mod, FeedForward):
            yield prefix, mod, mod.net[0].proj.out_features // 2, mod.named_parameters()
        elif isinstance(mod, CLIPTextModel):
            yield (prefix, mod, mod.token_embedding.num_embeddings,
                   [("text_model.embeddings.token_embedding.weight", mod.token_embedding.weight)])


def plan(model: nn.Module, size: int, rank: int) -> Plan:
    """Rank `rank`'s shards of `model` over a group of `size`.  A block
    whose width does not divide `size` keeps every weight whole."""
    out = Plan({}, {})
    for prefix, _, width, params in _units(model):
        for name, p in params:
            key = prefix + name
            rule = _rule(key)
            if rule is None or ".lora_" in key:
                continue
            if width % size:
                out.whole[key] = tuple(p.shape)
                continue
            dim, idx = _indices(rule[1], p.shape[1 if rule[1] == "rows" else 0], size, rank)
            out.splits[key] = (rule[0], dim, idx)
    return out


def tp_rule_report(model: nn.Module, size: int) -> Tuple[Dict[str, int], Dict[str, Tuple[int, ...]]]:
    """(counts, whole) as textboost_tpu/parallel/mesh.py::tp_rule_report
    gives them: the number of weights each rule splits at this tp size,
    and the weights a rule matched that stay whole, with their shapes."""
    p = plan(model, size, 0)
    counts = {pattern: 0 for pattern, _ in TP_RULES}
    for pattern, _, _ in p.splits.values():
        counts[pattern] += 1
    return counts, p.whole


def tp_partial_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The LoRA weights of `model`'s column-parallel shards: each rank's
    gradient of them is its heads' part, which `GradReducer` sums over the
    tp group (those of a block left whole are whole on every rank)."""
    from ..models.layers import LoRALinear

    return [lin.weight for m in model.modules()
            if isinstance(m, LoRALinear) and m.lora_rank > 0 and m.lora_rows is not None
            for lin in (m.lora_A, m.lora_B)]


def shard_(model: nn.Module, tp: TensorParallel) -> Plan:
    """Slice `model`'s split weights to `tp.rank`'s shards, in place, and
    set each split block's group (and its local head count, the LoRA rows
    of its columns, the embedding's first row).  Returns the plan."""
    from ..models.clip import CLIPTextModel
    from ..models.layers import LoRALinear

    p = plan(model, tp.size, tp.rank)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, (_, dim, idx) in p.splits.items():
            params[key].data = params[key].data.index_select(dim, idx.to(params[key].device))
    for _, mod, width, _ in _units(model):
        if width % tp.size:
            continue
        mod.tp = tp
        if hasattr(mod, "heads"):
            mod.heads //= tp.size
        if isinstance(mod, CLIPTextModel):
            emb = mod.token_embedding
            mod.vocab_start = tp.rank * (emb.num_embeddings // tp.size)
            emb.num_embeddings = emb.weight.shape[0]
    for prefix, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        mod.out_features, mod.in_features = mod.weight.shape
        key = f"{prefix}.weight"
        if isinstance(mod, LoRALinear) and key in p.splits and p.splits[key][1] == 0:
            idx = p.splits[key][2]
            mod.lora_rows = slice(int(idx[0]), int(idx[-1]) + 1)
    return p
