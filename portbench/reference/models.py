"""Plain PyTorch Stable Diffusion: the CLIP text encoder (with LoRA on q/k/v),
the UNet2DCondition and the AutoencoderKL, under diffusers' and
transformers' state-dict keys.

This is the benchmark's yardstick.  It imports nothing of the measured
package: every layer is written out with torch operations, attention as
softmax(q k^T / sqrt(d)) v in float32 over chunks of the batch, GroupNorm
and LayerNorm as torch's.  The published architectures (diffusers
UNet2DConditionModel / AutoencoderKL, transformers CLIPTextModel) with the
numerics the paper's code uses: UNet downsampling pads symmetrically, the
VAE encoder's asymmetrically (0, 1); Transformer2D and VAE GroupNorms take
eps 1e-6, the UNet's resnets 1e-5; GEGLU's gate is the exact gelu; the
timestep embedding is flip_sin_to_cos with shift 0.

Every matrix product of a linear or convolution layer goes through an
`Ops` object that the caller builds: `Ops()` computes in float32, and a
subclass may compute them in another precision (reference/quant.py, the
lower-precision control).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ATTENTION_CHUNK_ELEMENTS = 2**28  # score elements per attention chunk (1 GiB in fp32)


class Ops:
    """The products of the linear and convolution layers, in float32."""

    def linear(self, x, weight, bias=None):
        return F.linear(x, weight, bias)

    def conv(self, x, weight, bias, stride: int, padding: int):
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)


class Linear(nn.Linear):
    def __init__(self, ops: Ops, fan_in: int, fan_out: int, bias: bool = True,
                 lora_rank: int = 0):
        super().__init__(fan_in, fan_out, bias=bias)
        self.ops = ops
        self.lora_rank = lora_rank
        if lora_rank:
            self.lora_A = nn.Linear(fan_in, lora_rank, bias=False)
            self.lora_B = nn.Linear(lora_rank, fan_out, bias=False)

    def forward(self, x, use_lora: bool = True):
        y = self.ops.linear(x, self.weight, self.bias)
        if self.lora_rank and use_lora:  # PEFT, alpha = r: scale 1
            y = y + self.ops.linear(self.ops.linear(x, self.lora_A.weight), self.lora_B.weight)
        return y


class Conv(nn.Conv2d):
    def __init__(self, ops: Ops, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.ops = ops

    def forward(self, x):
        return self.ops.conv(x, self.weight, self.bias, self.stride[0], self.padding[0])


class GroupNorm(nn.GroupNorm):
    def __init__(self, groups: int, channels: int, eps: float, silu: bool = False):
        super().__init__(groups, channels, eps=eps)
        self.silu = silu

    def forward(self, x):
        y = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


def attention(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D]; `mask` broadcastable
    to [B, H, N, M], True keeps.  Chunked over the batch so that the scores
    of a chunk hold at most ATTENTION_CHUNK_ELEMENTS."""
    b, n, h, d = q.shape
    m = k.shape[1]
    per = max(1, ATTENTION_CHUNK_ELEMENTS // (h * n * m))
    outs = []
    for s in range(0, b, per):
        logits = torch.einsum("bnhd,bmhd->bhnm", q[s:s + per], k[s:s + per]) * d**-0.5
        if mask is not None:
            mk = mask if mask.shape[0] == 1 else mask[s:s + per]
            logits = logits.masked_fill(~mk, float("-inf"))
        outs.append(torch.einsum("bhnm,bmhd->bnhd", logits.softmax(-1), v[s:s + per]))
    return torch.cat(outs)


class _Container(nn.Module):
    """Holds submodules under the published key names."""


# -- CLIP text encoder -----------------------------------------------------------
class CLIPLayer(nn.Module):
    def __init__(self, ops, cfg, lora_rank):
        super().__init__()
        dim = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.act = cfg["hidden_act"]
        self.layer_norm1 = nn.LayerNorm(dim, eps=cfg["layer_norm_eps"])
        self.layer_norm2 = nn.LayerNorm(dim, eps=cfg["layer_norm_eps"])
        att = self.self_attn = _Container()
        att.q_proj = Linear(ops, dim, dim, lora_rank=lora_rank)
        att.k_proj = Linear(ops, dim, dim, lora_rank=lora_rank)
        att.v_proj = Linear(ops, dim, dim, lora_rank=lora_rank)
        att.out_proj = Linear(ops, dim, dim)
        mlp = self.mlp = _Container()
        mlp.fc1 = Linear(ops, dim, cfg["intermediate_size"])
        mlp.fc2 = Linear(ops, cfg["intermediate_size"], dim)

    def forward(self, x, mask, use_lora):
        b, n, c = x.shape
        att = self.self_attn
        h = self.layer_norm1(x)
        split = lambda t: t.view(b, n, self.heads, c // self.heads)  # noqa: E731
        o = attention(split(att.q_proj(h, use_lora)), split(att.k_proj(h, use_lora)),
                      split(att.v_proj(h, use_lora)), mask).reshape(b, n, c)
        x = x + att.out_proj(o)
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class CLIPTextModel(nn.Module):
    """transformers' CLIPTextModel: causal pre-LN layers, final LayerNorm;
    returns the last hidden state [B, 77, hidden]."""

    def __init__(self, ops: Ops, cfg: dict, lora_rank: int = 0, vocab: Optional[int] = None):
        super().__init__()
        tm = self.text_model = _Container()
        tm.embeddings = _Container()
        tm.embeddings.token_embedding = nn.Embedding(vocab or cfg["vocab_size"],
                                                     cfg["hidden_size"])
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                                        cfg["hidden_size"])
        tm.encoder = _Container()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(ops, cfg, lora_rank) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])

    def forward(self, ids: torch.Tensor, use_lora: bool = True,
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`table` replaces the token-embedding weight (a grown, trained one)."""
        tm = self.text_model
        emb = tm.embeddings
        n = ids.shape[1]
        tok = F.embedding(ids, emb.token_embedding.weight if table is None else table)
        x = tok + emb.position_embedding.weight[:n][None]
        mask = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, mask, use_lora)
        return tm.final_layer_norm(x)


def null_patch(hidden, ids, null, eos_id: int):
    """TextBoost's patch of the encoder output: the rows of an empty prompt
    (second token EOS) become the null embedding, and position 0 of every
    row its first vector."""
    is_null = (ids[:, 1] == eos_id)[:, None, None]
    hidden = torch.where(is_null, null[None], hidden)
    return torch.cat([null[0].expand(hidden.shape[0], 1, hidden.shape[2]), hidden[:, 1:]], 1)


# -- UNet and VAE building blocks -----------------------------------------------
class Resnet(nn.Module):
    def __init__(self, ops, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = Conv(ops, cin, cout, 3, padding=1)
        if temb:
            self.time_emb_proj = Linear(ops, temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = Conv(ops, cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(ops, cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class Attention(nn.Module):
    def __init__(self, ops, dim, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(ops, dim, dim, bias=False)
        self.to_k = Linear(ops, ctx_dim or dim, dim, bias=False)
        self.to_v = Linear(ops, ctx_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(ops, dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, n, c = x.shape
        split = lambda t: t.view(b, t.shape[1], self.heads, c // self.heads)  # noqa: E731
        o = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        return self.to_out[0](o.reshape(b, n, c))


class TransformerBlock(nn.Module):
    def __init__(self, ops, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(ops, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(ops, dim, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = _Container()
        self.ff.net = nn.ModuleList([_Container(), nn.Identity(), Linear(ops, dim * 4, dim)])
        self.ff.net[0].proj = Linear(ops, dim, dim * 8)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        h, gate = self.ff.net[0].proj(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff.net[2](h * F.gelu(gate))


class Transformer2D(nn.Module):
    def __init__(self, ops, c, heads, ctx_dim, depth, linear_proj, groups):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Linear(ops, c, c) if linear_proj else Conv(ops, c, c, 1)
        self.proj_out = Linear(ops, c, c) if linear_proj else Conv(ops, c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ops, c, heads, ctx_dim) for _ in range(depth)])

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        t = self.norm(x)
        if self.linear_proj:
            t = self.proj_in(t.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            t = self.proj_in(t).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            t = blk(t, ctx)
        if self.linear_proj:
            t = self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            t = self.proj_out(t.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return t + x


class Down(nn.Module):
    def __init__(self, ops, c, asym):
        super().__init__()
        self.asym = asym
        self.conv = Conv(ops, c, c, 3, stride=2, padding=0 if asym else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asym else x)


class Up(nn.Module):
    def __init__(self, ops, c):
        super().__init__()
        self.conv = Conv(ops, c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([args.cos(), args.sin()], -1)


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel as the SD 1.x / 2.x configs build it:
    CrossAttnDownBlock2D on the levels with attention, DownBlock2D on the
    last; UNetMidBlock2DCrossAttn; the mirrored up blocks."""

    def __init__(self, ops: Ops, cfg: dict):
        super().__init__()
        chans = cfg["block_out_channels"]
        heads = cfg["attention_head_dim"]  # diffusers' name: SD 1.x gives one count
        heads = list(heads) if isinstance(heads, Sequence) else [heads] * len(chans)
        attn_levels = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        g, ch0 = cfg["norm_num_groups"], chans[0]
        temb = ch0 * 4
        self.ch0 = ch0
        self.conv_in = Conv(ops, cfg["in_channels"], ch0, 3, padding=1)
        self.time_embedding = _Container()
        self.time_embedding.linear_1 = Linear(ops, ch0, temb)
        self.time_embedding.linear_2 = Linear(ops, temb, temb)

        def make_attn(level, c):
            return Transformer2D(ops, c, heads[level], cfg["cross_attention_dim"], 1,
                                 cfg["use_linear_projection"], g)

        skips, c_in = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for level, c in enumerate(chans):
            blk = _Container()
            blk.resnets = nn.ModuleList()
            if attn_levels[level]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg["layers_per_block"]):
                blk.resnets.append(Resnet(ops, c_in, c, temb, g, 1e-5))
                if attn_levels[level]:
                    blk.attentions.append(make_attn(level, c))
                skips.append(c)
                c_in = c
            if level != len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Down(ops, c, asym=False)])
                skips.append(c)
            self.down_blocks.append(blk)
        mid = self.mid_block = _Container()
        mid.resnets = nn.ModuleList([Resnet(ops, chans[-1], chans[-1], temb, g, 1e-5)
                                     for _ in range(2)])
        mid.attentions = nn.ModuleList([make_attn(len(chans) - 1, chans[-1])])
        self.up_blocks = nn.ModuleList()
        for up, level in enumerate(reversed(range(len(chans)))):
            c = chans[level]
            blk = _Container()
            blk.resnets = nn.ModuleList()
            if attn_levels[level]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg["layers_per_block"] + 1):
                blk.resnets.append(Resnet(ops, c_in + skips.pop(), c, temb, g, 1e-5))
                if attn_levels[level]:
                    blk.attentions.append(make_attn(level, c))
                c_in = c
            if up != len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Up(ops, c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, ch0, 1e-5, silu=True)
        self.conv_out = Conv(ops, ch0, cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx):
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(timestep_embedding(t, self.ch0))))
        x = self.conv_in(x)
        skips = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if attns is not None:
                    x = attns[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, temb)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], 1), temb)
                if attns is not None:
                    x = attns[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class VAEAttention(nn.Module):
    def __init__(self, ops, c, g):
        super().__init__()
        self.group_norm = GroupNorm(g, c, 1e-6)
        self.to_q = Linear(ops, c, c)
        self.to_k = Linear(ops, c, c)
        self.to_v = Linear(ops, c, c)
        self.to_out = nn.ModuleList([Linear(ops, c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        o = attention(self.to_q(t)[:, :, None], self.to_k(t)[:, :, None],
                      self.to_v(t)[:, :, None])[:, :, 0]
        return x + self.to_out[0](o).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _mid(ops, c, g):
    mid = _Container()
    mid.resnets = nn.ModuleList([Resnet(ops, c, c, None, g, 1e-6) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ops, c, g)])
    return mid


def _run_mid(mid, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class VAE(nn.Module):
    """diffusers' AutoencoderKL (the encoder, quant convs and decoder)."""

    def __init__(self, ops: Ops, cfg: dict):
        super().__init__()
        chans, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        lpb, lat = cfg["layers_per_block"], cfg["latent_channels"]
        enc = self.encoder = _Container()
        enc.conv_in = Conv(ops, cfg["in_channels"], chans[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        c_in = chans[0]
        for level, c in enumerate(chans):
            blk = _Container()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(Resnet(ops, c_in, c, None, g, 1e-6))
                c_in = c
            if level != len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Down(ops, c, asym=True)])
            enc.down_blocks.append(blk)
        enc.mid_block = _mid(ops, chans[-1], g)
        enc.conv_norm_out = GroupNorm(g, chans[-1], 1e-6, silu=True)
        enc.conv_out = Conv(ops, chans[-1], 2 * lat, 3, padding=1)
        dec = self.decoder = _Container()
        dec.conv_in = Conv(ops, lat, chans[-1], 3, padding=1)
        dec.mid_block = _mid(ops, chans[-1], g)
        dec.up_blocks = nn.ModuleList()
        c_in = chans[-1]
        for up, level in enumerate(reversed(range(len(chans)))):
            c = chans[level]
            blk = _Container()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(Resnet(ops, c_in, c, None, g, 1e-6))
                c_in = c
            if up != len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Up(ops, c)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = GroupNorm(g, chans[0], 1e-6, silu=True)
        dec.conv_out = Conv(ops, chans[0], cfg["out_channels"], 3, padding=1)
        self.quant_conv = Conv(ops, 2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(ops, lat, lat, 1)

    def encode(self, pixels):
        """[B, 3, H, W] in [-1, 1] -> (mean, logvar clamped to [-30, 20])."""
        enc = self.encoder
        x = enc.conv_in(pixels)
        for blk in enc.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = enc.conv_out(enc.conv_norm_out(_run_mid(enc.mid_block, x)))
        mean, logvar = self.quant_conv(x).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        dec = self.decoder
        x = _run_mid(dec.mid_block, dec.conv_in(self.post_quant_conv(z)))
        for blk in dec.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return dec.conv_out(dec.conv_norm_out(x))


def build(ops: Ops, config: dict, *, lora_rank: int = 0, device="meta"):
    """{"text_encoder", "unet", "vae"} of a configuration file's three
    component configs, uninitialised on `device`."""
    with torch.device(device):
        return {"text_encoder": CLIPTextModel(ops, config["text_encoder"], lora_rank),
                "unet": UNet(ops, config["unet"]), "vae": VAE(ops, config["vae"])}
