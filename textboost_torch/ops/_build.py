"""Build and load the port's CUDA kernels.

Each source in `textboost_torch/csrc/` is compiled by `nvcc` into its own
shared library with a plain C interface and loaded with ctypes (no PyTorch
headers, so a build takes seconds).  Libraries go to `csrc/build/`, named by
a hash of the source, of the `csrc/` headers it includes (directly or
through another header) and of the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Builds happen at first use, never
at import, and `build()` starts one `nvcc` per source at once.

A missing `nvcc` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "group_norm_fwd.cu", "group_norm_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_c_ptr, _c_int, _c_float, _c_ll = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
)
# C signatures of the entry points, by source.
SIGNATURES = {
    "flash_attention_fwd.cu": {
        "tb_flash_attention_fwd": [_c_int] + [_c_ptr] * 5 + [_c_int] * 5
        + [_c_ll] * 9 + [_c_float, _c_ptr, ctypes.POINTER(_c_int)],
    },
    "flash_attention_bwd.cu": {
        "tb_flash_attention_bwd": [_c_int] + [_c_ptr] * 10 + [_c_int] * 6
        + [_c_ll] * 24 + [_c_float, _c_ptr, ctypes.POINTER(_c_int)],
        "tb_flash_attention_bwd_wgmma_form": [_c_int] * 2,
    },
    "group_norm_fwd.cu": {
        "tb_group_norm_fwd": [_c_int] + [_c_ptr] * 6 + [_c_int] * 4
        + [_c_float] + [_c_int] * 8 + [_c_ptr],
        "tb_group_norm_fwd_active_clusters": [_c_int] * 3 + [ctypes.POINTER(_c_int)],
    },
    "group_norm_bwd.cu": {
        "tb_group_norm_bwd": [_c_int] + [_c_ptr] * 7 + [_c_int] * 12 + [_c_ptr],
        "tb_group_norm_bwd_active_clusters": [_c_int] * 3 + [ctypes.POINTER(_c_int)],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of textboost_torch cannot be built"
    )


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def included_headers(source: str) -> List[str]:
    """Names of the `csrc/` files that `source` includes with quotes,
    directly or through one of them, sorted."""
    seen, todo = set(), [source]
    while todo:
        for name in _INCLUDE.findall((CSRC / todo.pop()).read_bytes()):
            name = name.decode()
            if name not in seen and (CSRC / name).is_file():
                seen.add(name)
                todo.append(name)
    return sorted(seen)


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + included_headers(source):
        digest.update(b"\0" + name.encode() + b"\0" + (CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once.

    Returns {source: library path}."""
    sources = list(sources)
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out[src])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(source: str, path: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        path = path or build([source])[source]
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[source] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
