"""The subset of msgpack that `flax.serialization` reads and writes, in pure
Python (the card's machine has neither flax nor msgpack).

The JAX package stores its native snapshot (`{text_encoder,unet,vae}.msgpack`,
textboost_tpu/models/pretrained.py::save_snapshot) and its converted scorer
trees (`convert_scorers.py`) with `flax.serialization.to_bytes`: a msgpack
map of nested string-keyed maps whose leaves are arrays, each an ext of
type 1 holding a msgpack `(shape, dtype name, raw C-order bytes)`; ext 3 is
a numpy scalar in the same form; ext 2, a Python complex, is not read.
A leaf over `MAX_CHUNK_SIZE` bytes is written as the map
`{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat array, ...}}` (flax 0.12's `_chunk`); it is read back whole.

`load(path)` maps the file (copy-on-write) and returns every array leaf as
a CPU torch tensor over the mapping: no leaf is copied while the tree is
read, so a 3.5 GB UNet file costs no second 3.5 GB.  bfloat16 leaves (which
numpy cannot hold) are read as uint16 and viewed as torch.bfloat16, bit for
bit.  A chunked leaf is concatenated (one copy of that leaf).

`dump(tree, f)` writes the same forms with the encodings msgpack-python
chooses (the smallest header for each value, floats as float64) and each
map's keys sorted, as jax's tree functions order a dict's, so that a tree
of the same keys and arrays gives flax's bytes; tensors may live on a
device and are copied to the host one leaf at a time.
"""
from __future__ import annotations

import mmap
import struct
from typing import Any, BinaryIO, Callable, Dict, Optional, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}
_BE_SIGNED = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------
def _array(buf, shape, dtype_name: str, start: int, nbytes: int) -> torch.Tensor:
    """The leaf's bytes `buf[start:start + nbytes]` as a tensor of `shape`,
    sharing `buf`'s memory."""
    bf16 = dtype_name == "bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else dtype_name)
    if nbytes != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"an array of shape {tuple(shape)} and dtype {dtype_name} holds "
                         f"{nbytes} bytes")
    arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize, offset=start)
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(torch.bfloat16) if bf16 else t


class _Decoder:
    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)

    def _unpack(self, fmt: str, pos: int):
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def _len(self, pos: int, width: int) -> Tuple[int, int]:
        return self._unpack(_BE[width], pos), pos + width

    def read(self, pos: int, raw_bin: bool = False) -> Tuple[Any, int]:
        """(the value at `pos`, the position after it); with `raw_bin` a bin
        value is returned as its (start, length) in the buffer."""
        b = self.buf[pos]
        pos += 1
        if b <= 0x7F:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8F:
            return self._map(pos, b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._list(pos, b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b in (0xC2, 0xC3):
            return b == 0xC3, pos
        if b in (0xC4, 0xC5, 0xC6):
            n, pos = self._len(pos, 1 << (b - 0xC4))
            if raw_bin:
                return (pos, n), pos + n
            return bytes(self.view[pos:pos + n]), pos + n
        if b in (0xC7, 0xC8, 0xC9):
            n, pos = self._len(pos, 1 << (b - 0xC7))
            return self._ext(pos + 1, self._unpack(">b", pos), n)
        if b in _FIXEXT_LEN:
            return self._ext(pos + 1, self._unpack(">b", pos), _FIXEXT_LEN[b])
        if b == 0xCA:
            return self._unpack(">f", pos), pos + 4
        if b == 0xCB:
            return self._unpack(">d", pos), pos + 8
        if 0xCC <= b <= 0xCF:
            w = 1 << (b - 0xCC)
            return self._unpack(_BE[w], pos), pos + w
        if 0xD0 <= b <= 0xD3:
            w = 1 << (b - 0xD0)
            return self._unpack(_BE_SIGNED[w], pos), pos + w
        if b in (0xD9, 0xDA, 0xDB):
            n, pos = self._len(pos, 1 << (b - 0xD9))
            return self._str(pos, n)
        if b in (0xDC, 0xDD):
            n, pos = self._len(pos, 2 if b == 0xDC else 4)
            return self._list(pos, n)
        if b in (0xDE, 0xDF):
            n, pos = self._len(pos, 2 if b == 0xDE else 4)
            return self._map(pos, n)
        raise ValueError(f"byte 0x{b:02x} at offset {pos - 1} starts no msgpack value")

    def _str(self, pos: int, n: int) -> Tuple[str, int]:
        return bytes(self.view[pos:pos + n]).decode("utf-8"), pos + n

    def _list(self, pos: int, n: int) -> Tuple[list, int]:
        out = []
        for _ in range(n):
            val, pos = self.read(pos)
            out.append(val)
        return out, pos

    def _map(self, pos: int, n: int) -> Tuple[Any, int]:
        out = {}
        for _ in range(n):
            key, pos = self.read(pos)
            out[key], pos = self.read(pos)
        return (_unchunk(out) if CHUNKED in out else out), pos

    def _ext(self, pos: int, code: int, n: int) -> Tuple[Any, int]:
        end = pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            name = "native_complex (a Python complex)" if code == EXT_COMPLEX else "unknown"
            raise ValueError(f"msgpack ext type {code} ({name}) at offset {pos} is not an "
                             "array; flax trees of the JAX package hold none")
        (shape, dtype_name, (start, nbytes)), inner_end = self._ndarray(pos)
        if inner_end != end:
            raise ValueError(f"the array ext at offset {pos} spans {n} bytes, its "
                             f"contents {inner_end - pos}")
        t = _array(self.buf, shape, dtype_name, start, nbytes)
        if code == EXT_NPSCALAR:
            return (t.reshape(()) if t.dtype == torch.bfloat16 else t.numpy()[()]), end
        return t, end

    def _ndarray(self, pos: int):
        b = self.buf[pos]
        if b != 0x93:
            raise ValueError(f"an array ext at offset {pos} does not hold (shape, dtype, bytes)")
        shape, pos = self.read(pos + 1)
        dtype_name, pos = self.read(pos)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        data, pos = self.read(pos, raw_bin=True)
        return (shape, dtype_name, data), pos


def _unchunk(d: Dict[str, Any]) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def loads(buf) -> Any:
    """Decode one msgpack value from a buffer (bytes, bytearray, mmap);
    array leaves share the buffer's memory."""
    if isinstance(buf, bytes):  # np.frombuffer over bytes gives read-only arrays
        buf = bytearray(buf)
    val, end = _Decoder(buf).read(0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes follow the msgpack value")
    return val


def load(path: str) -> Any:
    """Decode a msgpack file through a copy-on-write mapping (see the module
    docstring); raises ValueError naming the file on a malformed one."""
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise ValueError(f"{path} is empty")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    try:
        return loads(buf)
    except (ValueError, IndexError, struct.error, UnicodeDecodeError, KeyError) as e:
        raise ValueError(f"{path} is not a flax msgpack tree: {e}") from e


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------
def _header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[Tuple[int, int], ...]) -> bytes:
    """The header of a value of length `n`: `fix` = (first byte, limit) of
    its fix form, then (code, width) forms in order of size."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, width in codes:
        if n < 1 << (8 * width):
            return bytes([code]) + struct.pack(_BE[width], n)
    raise ValueError(f"a msgpack value of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * width):
                return bytes([code]) + struct.pack(_BE[width], v)
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                return bytes([code]) + struct.pack(_BE_SIGNED[width], v)
    raise ValueError(f"{v} does not fit a msgpack integer")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), (0xA0, 32), ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n]]) + struct.pack(">b", code)
    return _header(n, None, ((0xC7, 1), (0xC8, 2), (0xC9, 4))) + struct.pack(">b", code)


def _host_array(x) -> Tuple[np.ndarray, str]:
    """(C-order host bytes as a numpy array, flax's dtype name) of a leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        name = str(t.dtype).rsplit(".", 1)[1]
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(), name
    arr = np.ascontiguousarray(x)
    return arr, arr.dtype.name


class _Encoder:
    def __init__(self, f: BinaryIO, convert: Optional[Callable]):
        self.f = f
        self.convert = convert

    def write(self, obj: Any) -> None:
        w = self.f.write
        if obj is None:
            w(b"\xc0")
        elif isinstance(obj, bool):
            w(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, int):
            w(_int(obj))
        elif isinstance(obj, float):
            w(b"\xcb" + struct.pack(">d", obj))
        elif isinstance(obj, str):
            w(_str(obj))
        elif isinstance(obj, (bytes, bytearray)):
            w(_header(len(obj), None, ((0xC4, 1), (0xC5, 2), (0xC6, 4))))
            w(obj)
        elif isinstance(obj, dict):
            w(_header(len(obj), (0x80, 16), ((0xDE, 2), (0xDF, 4))))
            for key in sorted(obj):
                self.write(key)
                self.write(obj[key])
        elif isinstance(obj, (list, tuple)):
            w(_header(len(obj), (0x90, 16), ((0xDC, 2), (0xDD, 4))))
            for val in obj:
                self.write(val)
        elif isinstance(obj, np.generic):
            self._ndarray(EXT_NPSCALAR, np.asarray(obj))
        elif isinstance(obj, (torch.Tensor, np.ndarray)):
            leaf = self.convert(obj) if self.convert is not None else obj
            arr, name = _host_array(leaf)
            if arr.nbytes > MAX_CHUNK_SIZE:
                self._chunked(arr, name)
            else:
                self._ndarray(EXT_NDARRAY, arr, name)
        else:
            raise TypeError(f"{type(obj).__name__} has no flax msgpack form")

    def _ndarray(self, code: int, arr: np.ndarray, name: Optional[str] = None) -> None:
        shape = b"".join([_header(arr.ndim, (0x90, 16), ((0xDC, 2), (0xDD, 4)))]
                         + [_int(int(d)) for d in arr.shape])
        head = b"\x93" + shape + _str(name or arr.dtype.name) + _header(
            arr.nbytes, None, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        self.f.write(_ext_header(code, len(head) + arr.nbytes))
        self.f.write(head)
        self.f.write(memoryview(arr.reshape(-1).view(np.uint8)))

    def _chunked(self, arr: np.ndarray, name: str) -> None:
        """flax's `_chunk` form of a leaf over MAX_CHUNK_SIZE bytes."""
        flat = arr.reshape(-1)
        step = max(1, MAX_CHUNK_SIZE // arr.itemsize)
        starts = range(0, flat.size, step)
        self.f.write(b"\x83")
        for key, val in ((CHUNKED, True), ("shape", {str(i): int(d) for i, d in enumerate(arr.shape)})):
            self.write(key)
            self.write(val)
        self.write("chunks")
        self.f.write(_header(len(starts), (0x80, 16), ((0xDE, 2), (0xDF, 4))))
        for i, s in enumerate(starts):
            self.write(str(i))
            self._ndarray(EXT_NDARRAY, flat[s:s + step], name)


def dump(tree: Any, f: BinaryIO, convert: Optional[Callable] = None) -> None:
    """Write `tree` (nested dicts, lists, scalars, strings; torch tensors or
    numpy arrays as leaves) to the binary file `f` in flax's forms;
    `convert(leaf)` is applied to each tensor leaf as it is written."""
    _Encoder(f, convert).write(tree)


def dumps(tree: Any, convert: Optional[Callable] = None) -> bytes:
    import io

    buf = io.BytesIO()
    dump(tree, buf, convert)
    return buf.getvalue()
