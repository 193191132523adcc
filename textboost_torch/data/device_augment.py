"""Paired augmentation executed on the device (`--augment_device`).

Counterpart of textboost_tpu/data/device_augment.py.  The instance images
go to the device once, as a uint8 bank; the host only PLANS each sample
(augment.PairedAugmentation.plan: a few scalars and the caption), and
`augment_batch` executes the plans of a batch with torch ops on the bank's
device.  Per-step host-to-device traffic shrinks to the token ids and one
int32 row of plan scalars per sample.

The host side (`AUG_PARAM_FIELDS`, `encode_plan`, `stack_aug_params`,
`build_image_bank`) is a copy of the JAX package's.  The device side
follows the JAX executor's semantics op by op, in float32 (the JAX tap
loops and their order of additions kept), and differs in how a batch is
run: each op runs once over the samples that take it, so the number of
kernel launches per batch depends on which ops the batch holds, not on its
size.  The samples are sorted on the host by (collage, geometric op), so
that each op's samples are one contiguous slice, and put back in their
order at the end.

Execution order differs from the host path in one documented way: the host
augments the ORIGINAL image and then resizes and crops to `size`; the
device crops from the (host-pre-resized) bank first and augments at
`size`².  For a square instance image at the training resolution the two
paths coincide; otherwise they are statistically equivalent but not
pixel-identical.  The host PIL path remains the default.

Pixel semantics per op:
- hflip / translate / grayscale: bit-exact vs the PIL path (gathers,
  integer luma with PIL's fixed-point coefficients).
- zoom (adjust_scale): PIL `Image.transform(AFFINE, BICUBIC)` semantics,
  a=-1 cubic in difference-Horner form, taps clamped into the virtual
  edge pad then into the source, truncation to uint8.
- crop / collage: PIL `resize(BICUBIC)` semantics, the a=-0.5 Keys kernel,
  out-of-range taps dropped and the weights renormalised, antialias on
  downscale, rounded to uint8 between the two passes.
- collage axis 3 tiles to (size//3)*3 < size when 3 does not divide size;
  the host pipeline then LANCZOS-upscales back, replicated with lanczos3.
Every float result is rounded (truncated for the zoom), clipped to
[0, 255], then cast.  Matrix products are not used, so TF32 never enters.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .augment import _inverse_affine_matrix

# Per-sample parameter schema ([B]-stacked by `stack_aug_params`).
AUG_PARAM_FIELDS: Dict[str, np.dtype] = {
    "img_idx": np.int32,
    "top": np.int32,
    "left": np.int32,
    "flip_first": np.int32,
    "geo_op": np.int32,  # 0 none, 1 zoom, 2 crop, 3 translate, 4 hflip
    "zoom_a": np.float32,
    "zoom_cx": np.float32,
    "zoom_cy": np.float32,
    "zoom_pad_w": np.int32,
    "zoom_pad_h": np.int32,
    "crop_x": np.int32,
    "crop_y": np.int32,
    "crop_nw": np.int32,
    "crop_nh": np.int32,
    "tr_dir": np.int32,
    "tr_shift": np.int32,
    "collage_axis": np.int32,  # 0 none, 2, 3
    "gray": np.int32,
}

_GEO_OPS = {"scale": 1, "crop": 2, "translate": 3, "hflip": 4}


def encode_plan(
    steps: List[Dict], size: int, img_idx: int, top: int, left: int
) -> Dict[str, np.ndarray]:
    """PairedAugmentation.plan() steps -> fixed-size numeric params.

    The plan's op order (base_hflip -> geometric -> collage -> grayscale)
    maps onto fixed slots; the executor applies the slots in that order."""
    p = {k: np.zeros((), dt) for k, dt in AUG_PARAM_FIELDS.items()}
    p["img_idx"] = np.int32(img_idx)
    p["top"] = np.int32(top)
    p["left"] = np.int32(left)
    for st in steps:
        op = st["op"]
        if op == "base_hflip":
            p["flip_first"] = np.int32(1)
        elif op == "hflip":
            p["geo_op"] = np.int32(_GEO_OPS["hflip"])
        elif op == "scale":
            p["geo_op"] = np.int32(_GEO_OPS["scale"])
            pad_w, pad_h = st["pad_w"], st["pad_h"]
            pw, ph = size + 2 * pad_w, size + 2 * pad_h
            inv, m2, m5 = _inverse_affine_matrix(pw, ph, st["scale"])
            # The output window's offset folds into the matrix constants,
            # as in augment.exec_adjust_scale.
            left_off = int(round((pw - size) / 2.0))
            top_off = int(round((ph - size) / 2.0))
            p["zoom_a"] = np.float32(inv)
            p["zoom_cx"] = np.float32(m2 + inv * left_off)
            p["zoom_cy"] = np.float32(m5 + inv * top_off)
            p["zoom_pad_w"] = np.int32(pad_w)
            p["zoom_pad_h"] = np.int32(pad_h)
        elif op == "crop":
            p["geo_op"] = np.int32(_GEO_OPS["crop"])
            p["crop_x"] = np.int32(st["x"])
            p["crop_y"] = np.int32(st["y"])
            p["crop_nw"] = np.int32(st["nw"])
            p["crop_nh"] = np.int32(st["nh"])
        elif op == "translate":
            p["geo_op"] = np.int32(_GEO_OPS["translate"])
            p["tr_dir"] = np.int32(st["direction"])
            p["tr_shift"] = np.int32(st["shift"])
        elif op == "collage":
            p["collage_axis"] = np.int32(st["axis"])
        elif op == "grayscale":
            p["gray"] = np.int32(1)
        else:
            # brightness / rotate / jpeg are unreachable from the object and
            # style op banks; no device executor exists for them.
            raise ValueError(f"augmentation op '{op}' has no device executor")
    return p


def stack_aug_params(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in AUG_PARAM_FIELDS}


def build_image_bank(paths, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and shorter-side-resize every instance image once; pad to the
    common extent.  Returns (bank uint8 [N, Hb, Wb, 3], dims int32 [N, 2]
    true h/w); the trainer uploads the bank once."""
    from .datasets import load_rgb, resize_shorter_side

    imgs = [np.asarray(resize_shorter_side(load_rgb(path), size), np.uint8) for path in paths]
    hb = max(a.shape[0] for a in imgs)
    wb = max(a.shape[1] for a in imgs)
    bank = np.zeros((len(imgs), hb, wb, 3), np.uint8)
    dims = np.zeros((len(imgs), 2), np.int32)
    for i, a in enumerate(imgs):
        bank[i, : a.shape[0], : a.shape[1]] = a
        dims[i] = (a.shape[0], a.shape[1])
    return bank, dims


# ---------------------------------------------------------------------------
# Device execution.  Images are [b, S, S, 3] (NHWC); "dim" 2 resamples along
# the width, 1 along the height.  Per-sample scalars are [b] tensors.
# ---------------------------------------------------------------------------
def _along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A per-sample [b, L] row of positions or weights shaped to broadcast
    over an image's axis `dim`."""
    return t[:, :, None, None] if dim == 1 else t[:, None, :, None]


def _take(img: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """img[b, ..., idx[b, j], ...] along `dim`, per sample (idx int64)."""
    shape = list(img.shape)
    shape[dim] = idx.shape[1]
    return torch.gather(img, dim, _along(idx, dim).expand(shape))


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, as IEEE division: CUDA multiplies by the
    reciprocal when the divisor is a Python number, which can move a value
    by one ulp and then across a rounding boundary."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _taps(n: int, device) -> torch.Tensor:
    """Tap offsets 0..n-1 shaped [n, 1, 1], to broadcast over [b, L]."""
    return torch.arange(n, dtype=torch.int32, device=device)[:, None, None]


def _weighted_taps(img, idx, w, dim: int):
    """sum_t w[t] * img[idx[t]] along `dim`, divided by sum_t w[t], added in
    tap order (the JAX tap loop's order).  idx, w: [T, b, L] per sample, or
    [T, L] shared by every sample."""
    shared = idx.dim() == 2
    view = [1, 1, 1, 1]
    view[dim] = idx.shape[-1]
    acc = wsum = None
    for t in range(idx.shape[0]):
        if shared:
            term = w[t].view(view) * img.index_select(dim, idx[t])
        else:
            term = _along(w[t], dim) * _take(img, idx[t], dim)
        acc = term if acc is None else acc + term
        wsum = w[t] if wsum is None else wsum + w[t]
    return acc / (wsum.view(view) if shared else _along(wsum, dim))


def _pil_cubic(v1, v2, v3, v4, d):
    """Pillow's BICUBIC transform macro (a=-1) in its difference-Horner form."""
    p2 = -v1 + v3
    p3 = 2.0 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return v2 + d * (p2 + d * (p3 + d * p4))


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    """Pillow's resize BICUBIC filter (Keys a=-0.5)."""
    a = -0.5
    at = t.abs()
    return torch.where(
        at < 1.0,
        ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0,
        torch.where(at < 2.0, a * (((at - 5.0) * at + 8.0) * at - 4.0), 0.0),
    )


def _lanczos3(t: torch.Tensor) -> torch.Tensor:
    at = t.abs()
    pt = math.pi * t
    safe = torch.where(at < 1e-6, 1.0, pt)
    val = torch.where(at < 1e-6, 1.0, 3.0 * torch.sin(safe) * torch.sin(_div(safe, 3.0))
                      / (safe * safe))
    return torch.where(at < 3.0, val, 0.0)


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip, cast (the cast is undefined out of range on
    CUDA, so the clip always comes first)."""
    return x.round().clamp(0.0, 255.0).to(torch.uint8)


def _affine_axis(img, a, c, pad, size: int, dim: int):
    """Resample `img` along `dim` with PIL-transform bicubic: position
    a*(j+0.5)+c in the virtual edge-padded extent [0, size+2*pad).  Returns
    (values float32, in_bounds [b, size])."""
    w_ext = size + 2 * pad  # [b]
    j = torch.arange(size, dtype=torch.float32, device=img.device) + 0.5
    pos = a[:, None] * j + c[:, None]
    ok = (pos >= 0.0) & (pos < w_ext.float()[:, None])
    p = pos - 0.5
    f = torch.floor(p)
    d = _along(p - f, dim)
    idx = torch.minimum(torch.clamp(f.int() - 1 + _taps(4, img.device), min=0),
                        (w_ext - 1)[:, None]) - pad[:, None]
    idx = idx.clamp(0, size - 1).long()
    return _pil_cubic(*(_take(img, idx[t], dim) for t in range(4)), d), ok


def _zoom(x, p, size: int):
    """adjust_scale: separable PIL-transform bicubic over the virtual edge
    pad, truncated to uint8 (the native host op's semantics)."""
    h_out, ok_x = _affine_axis(x.float(), p["zoom_a"], p["zoom_cx"], p["zoom_pad_w"], size, 2)
    out, ok_y = _affine_axis(h_out, p["zoom_a"], p["zoom_cy"], p["zoom_pad_h"], size, 1)
    out = torch.where(ok_y[:, :, None, None] & ok_x[:, None, :, None], out, 0.0)
    return out.clamp(0.0, 255.0).to(torch.uint8)  # truncates, like the C cast


def _resize_axis_traced(img, x0, n_src, size: int, dim: int):
    """PIL resize BICUBIC upscale along `dim`: the source window
    [x0, x0+n_src) -> `size` samples, 5 taps; taps outside the window are
    dropped and the weights renormalised (PIL's xmin/xmax truncation)."""
    scale = _div(n_src.float(), float(size))
    j = torch.arange(size, dtype=torch.float32, device=img.device) + 0.5
    center = x0.float()[:, None] + j * scale[:, None]
    idx = torch.floor(center - 2.0 + 0.5).int() + _taps(5, img.device)  # [5, b, size]
    w = _keys_cubic(idx.float() + 0.5 - center)
    w = torch.where((idx >= x0[:, None]) & (idx < (x0 + n_src)[:, None]), w, 0.0)
    return _weighted_taps(img, idx.clamp(0, img.shape[dim] - 1).long(), w, dim)


def _crop_rrc(x, p, size: int):
    """random_resized_crop (ratio 1): the crop box, then a BICUBIC upscale
    back to size², PIL resize semantics, rounded between the passes."""
    h_out = _resize_axis_traced(x.float(), p["crop_x"], p["crop_nw"], size, 2)
    h_out = h_out.round().clamp(0.0, 255.0)
    out = _resize_axis_traced(h_out, p["crop_y"], p["crop_nh"], size, 1)
    return _u8(out)


def _translate(x, p, size: int):
    """Integer column shift with the edge column replicated (a gather)."""
    j = torch.arange(size, dtype=torch.int32, device=x.device)
    shift = p["tr_shift"][:, None]
    src = torch.where(p["tr_dir"][:, None] == 0, torch.clamp(j + shift, max=size - 1),
                      torch.clamp(j - shift, min=0))
    return _take(x, src.long(), 2)


def _resize_axis_static(img, out_size: int, kernel, support: float, antialias: bool, dim: int):
    """PIL resize along `dim` with static geometry (the collage's down- and
    upscales): the same taps and weights for every sample."""
    in_size = img.shape[dim]
    scale = in_size / out_size
    filterscale = max(scale, 1.0) if antialias else 1.0
    supp = support * filterscale
    ksize = int(math.ceil(supp)) * 2 + 1
    center = (torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5) * scale
    idx = torch.floor(center - supp + 0.5).int() + _taps(ksize, img.device)[:, :, 0]
    w = kernel(_div(idx.float() + 0.5 - center, filterscale))
    w = torch.where((idx >= 0) & (idx < in_size), w, 0.0)
    return _weighted_taps(img, idx.clamp(0, in_size - 1).long(), w, dim)


def _resize_static(x, out_h: int, out_w: int, kernel, support: float, antialias: bool):
    h = _resize_axis_static(x, out_w, kernel, support, antialias, 2)
    h = h.round().clamp(0.0, 255.0)  # PIL quantizes between the passes
    return _resize_axis_static(h, out_h, kernel, support, antialias, 1)


def _collage(x, size: int, axis: int):
    """square_photo_collage: BICUBIC downscale (antialiased) to the grid
    tile, black borders, tiled axis², then, when axis does not divide size,
    the host pipeline's trailing LANCZOS upscale back to size."""
    g = size // axis
    small = _u8(_resize_static(x.float(), g, g, _keys_cubic, 2.0, True))
    small[:, 0, :] = 0
    small[:, -1, :] = 0
    small[:, :, 0] = 0
    small[:, :, -1] = 0
    grid = small.repeat(1, axis, axis, 1)
    if g * axis != size:
        grid = _u8(_resize_static(grid.float(), size, size, _lanczos3, 3.0, False))
    return grid


def _grayscale(x):
    """PIL convert('L'): (19595 R + 38470 G + 7471 B + 0x8000) >> 16, as RGB."""
    xi = x.int()
    l24 = 19595 * xi[..., 0] + 38470 * xi[..., 1] + 7471 * xi[..., 2] + 0x8000
    l8 = (l24 >> 16).to(torch.uint8)
    return torch.stack([l8, l8, l8], dim=-1)


_GEO = {  # geo_op -> executor
    0: lambda x, p, size: x,
    1: _zoom,
    2: _crop_rrc,
    3: _translate,
    4: lambda x, p, size: x.flip(2),
}
_COL = {name: i for i, name in enumerate(AUG_PARAM_FIELDS)}  # field -> column of a packed row


def _runs(keys: np.ndarray) -> List[Tuple[int, int, object]]:
    """(start, end, key) of each run of equal keys."""
    runs, start = [], 0
    for i in range(1, len(keys) + 1):
        if i == len(keys) or keys[i] != keys[start]:
            runs.append((start, i, keys[start]))
            start = i
    return runs


def pack_params(params: Dict[str, np.ndarray]) -> np.ndarray:
    """Host side of `augment_batch`: one int32 row per sample (the fields of
    AUG_PARAM_FIELDS, float32 ones by their bits), the rows sorted by
    (collage axis, geometric op), and in row i's last column the sorted
    position of sample i.  Returns rows [B, F + 1]."""
    geo = np.clip(np.asarray(params["geo_op"]), 0, 4)
    order = np.lexsort((geo, np.asarray(params["collage_axis"])))
    rows = np.empty((len(order), len(AUG_PARAM_FIELDS) + 1), np.int32)
    for k, dt in AUG_PARAM_FIELDS.items():
        rows[:, _COL[k]] = np.asarray(params[k], dt)[order].view(np.int32)
    rows[order, -1] = np.arange(len(order), dtype=np.int32)
    return rows


def augment_batch(bank: torch.Tensor, params: Dict[str, np.ndarray], size: int) -> torch.Tensor:
    """Execute a batch of encoded plans on the bank's device.

    bank: uint8 [N, Hb, Wb, 3] on the device; params: {field: [B]} numpy
    (`stack_aug_params`).  Returns uint8 [B, size, size, 3] on the bank's
    device, in the samples' order.  One host-to-device copy per call: the
    packed rows (`pack_params`)."""
    dev = bank.device
    rows = pack_params(params)
    packed = torch.from_numpy(rows)
    packed = (packed.pin_memory() if dev.type == "cuda" else packed).to(dev, non_blocking=True)
    p = {k: packed[:, _COL[k]] if dt == np.int32 else packed[:, _COL[k]].view(torch.float32)
         for k, dt in AUG_PARAM_FIELDS.items()}

    # The size² window at (top, left) of each sample's image, clamped into
    # the bank like a dynamic slice.
    top = p["top"].clamp(0, bank.shape[1] - size)
    left = p["left"].clamp(0, bank.shape[2] - size)
    span = torch.arange(size, dtype=torch.int32, device=dev)
    x = bank[p["img_idx"].long()[:, None, None], (top[:, None] + span)[:, :, None].long(),
             (left[:, None] + span)[:, None, :].long()]
    x = torch.where((p["flip_first"] == 1)[:, None, None, None], x.flip(2), x)

    def by_runs(x, keys, fn):
        """fn(samples, their params, key) over each run of one key (the rows
        are sorted); a run of key 0 passes through."""
        pieces = [x[s:e] if key == 0 else fn(x[s:e], {k: v[s:e] for k, v in p.items()}, key)
                  for s, e, key in _runs(keys)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)

    col = rows[:, _COL["collage_axis"]]
    geo = np.clip(rows[:, _COL["geo_op"]], 0, 4)
    # Each geometric op over its run within a collage group, then each collage.
    x = by_runs(x, col * 8 + geo, lambda xs, ps, key: _GEO[key % 8](xs, ps, size))
    x = by_runs(x, col, lambda xs, ps, axis: _collage(xs, size, int(axis)))
    x = torch.where((p["gray"] == 1)[:, None, None, None], _grayscale(x), x)
    return x.index_select(0, packed[:, -1].long())


def h2d_bytes(batch_size: int) -> int:
    """Bytes `augment_batch` sends to the device per call."""
    return batch_size * (len(AUG_PARAM_FIELDS) + 1) * 4
