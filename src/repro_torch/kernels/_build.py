"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

All `src/repro_torch/csrc/*.cu` files (and the `*.cuh` headers they
include) are compiled and linked for `sm_90a`
by one `nvcc -shared` call into a shared library with a plain C interface.
The library lands in `build/repro_torch/<digest>/` at the repository root
when the package runs from a checkout (`build/` is git-ignored), and under
`$XDG_CACHE_HOME/repro_torch/` (default `~/.cache`) when it runs from an
installed copy; the digest covers the sources and headers, the flags and the compiler,
so an edited kernel rebuilds and an unchanged one loads. The
compiler's output (with `-Xptxas -v`: registers, shared memory and spills
of each kernel) is kept beside the library as `build.log`.

Nothing here runs at import time. There is no fallback: a missing `nvcc`,
a failed build or a failed load raises.

Each C entry point takes its pointers and the stream as `void*` and returns
`cudaGetLastError()` after its launch; `check()` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreprotorch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64

# C signatures, one per exported symbol: (argtypes, restype)
SIGNATURES = {
    "spikemm_f32": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "spikemm_block_m": ((), _I),
    "spikemm_block_k": ((), _I),
    "linrec_f32": ((_P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "lif_f32": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P), _I),
    "lifrec_f32": ((_P,) * 7 + (_I, _I, _I, _F, _P), _I),
    "rec_scan_max_n": ((), _I),
    "rec_scan_w_in_smem": ((_I,), _I),
    "alif_f32": ((_P,) * 8 + (_I, _I, _I, _F, _F, _P), _I),
    "alifrec_f32": ((_P,) * 10 + (_I, _I, _I, _F, _F, _P), _I),
    "cuda_error_string": ((_I,), ctypes.c_char_p),
}


def build_root() -> Path:
    """`<checkout>/build/repro_torch` for a source checkout (the package at
    `src/repro_torch` beside `pyproject.toml`), else a per-user cache."""
    root = PKG.parents[1]
    if PKG.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "repro_torch"


BUILD_ROOT = build_root()
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else
    /usr/local/cuda/bin/nvcc. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("repro_torch kernels need nvcc (the CUDA toolkit) to "
                       "build src/repro_torch/csrc/*.cu; none was found")


def sources() -> List[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(nvcc: str, srcs: List[Path]) -> str:
    real = os.path.realpath(nvcc)
    st = os.stat(real)
    h = hashlib.sha256()
    for part in (real, f"{st.st_size}:{st.st_mtime_ns}",
                 " ".join(NVCC_FLAGS)):
        h.update(part.encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):     # the headers too
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link every source with one nvcc call; returns the
    library's path. Reuses an existing build with the same digest."""
    nvcc = nvcc_path()
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(nvcc, srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        p = subprocess.run([nvcc, *NVCC_FLAGS, *map(str, srcs),
                            "-o", str(tmp_lib)],
                           capture_output=True, text=True)
        log = p.stdout + p.stderr
        (out_dir / "build.log").write_text(log)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc exited {p.returncode} building "
                               f"{[s.name for s in srcs]}:\n{log[-4000:]}")
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _LIB = lib
    return _LIB


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        text = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({text}) at launch")


__all__ = ["build", "build_root", "library", "check", "nvcc_path",
           "sources", "BUILD_ROOT", "CSRC", "LIB_NAME"]
