"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

All `src/repro_torch/csrc/*.cu` files (and the `*.cuh` headers they
include) are compiled for `sm_90a`, one `nvcc -c` per source, all started
together, and linked by one `nvcc -shared` call into a shared library with
a plain C interface.
The library lands in `build/repro_torch/<digest>/` at the repository root
when the package runs from a checkout (`build/` is git-ignored), and under
`$XDG_CACHE_HOME/repro_torch/` (default `~/.cache`) when it runs from an
installed copy; the digest covers the sources and headers, the flags and the compiler,
so an edited kernel rebuilds and an unchanged one loads. The
compiler's output (with `-Xptxas -v`: registers, shared memory and spills
of each kernel), headed by each source's seconds from the start of the
build to its object, is kept beside the library as `build.log`.

Nothing here runs at import time. There is no fallback: a missing `nvcc`,
a failed build or a failed load raises.

Each C entry point takes its pointers and the stream as `void*` and returns
`cudaGetLastError()` after its launch; `check()` raises on a non-zero code.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
# (bm, bk): the spike block shape at which the block-sparse spikemm channel
# measures occupancy and skips work. This is its one definition:
# `spikemm/sparse.py` measures at it, and `csrc/spikemm_sparse.cu` takes
# it from the -D flags below (and refuses to build without them).
SPARSE_BLOCK = (64, 64)
# The steps of a group of `stdp_seq` (`csrc/stdp.cu`): their dw are summed
# in parallel, then each weight's clip chain runs over them. Its one
# definition, passed as -DSTDP_SEQ_GROUP.
STDP_SEQ_GROUP = 32
# The most neurons a lane owns on the recurrent scan's warp route
# (`csrc/rec_scan.cuh`, and its backward `csrc/rec_bwd.cu`): rows of up to
# 32 times as many neurons run a warp a row (`common.rec_route`). Its one
# definition, -DREC_LANE_NEURONS.
REC_LANE_NEURONS = 4
# The lane scans' staging ring (`csrc/lane_scan.cuh`: `linrec`, `lif`,
# `alif`): steps a stage holds and stages of the ring (chunks in flight:
# one fewer). Their one definition, -DLANE_SCAN_CHUNK and
# -DLANE_SCAN_STAGES; `common.lane_plan` sizes the ring from them. Four
# stages: on an H100, eight made the SHD window's call 0.5 us slower (a
# longer prologue) and two left too few steps in flight at T = 300.
LANE_SCAN_CHUNK = 16
LANE_SCAN_STAGES = 4
# The steps of a segment of the lane backward kernels `lif_bwd` and
# `alif_bwd` (`csrc/lane_bwd.cuh`, their shared skeleton), whose planes
# they hold in shared memory (five planes of 32 lanes: 40 KB at 64); a
# call of more steps keeps a checkpoint a segment. Its one definition,
# -DLANE_BWD_SEG; the wrappers size the checkpoint scratch from it.
LANE_BWD_SEG = 64
# The shared memory a CTA may opt into on the build's one target, sm_90
# (227 KB: 232 448 bytes a block on an H100), and its SM count. The tile
# plans read the card's own figures where there is a card
# (`common.smem_budget`, `common.plan_sms`); these stand in for them on
# the CPU, where the static checks (`repro_torch.analysis`) plan the same
# launches.
SM90_SMEM_OPTIN = 232448
SM90_SMS = 132
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# compile flags (each source with -c), then the link's
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v",
                      f"-DSPIKEMM_SPARSE_BM={SPARSE_BLOCK[0]}",
                      f"-DSPIKEMM_SPARSE_BK={SPARSE_BLOCK[1]}",
                      f"-DSTDP_SEQ_GROUP={STDP_SEQ_GROUP}",
                      f"-DREC_LANE_NEURONS={REC_LANE_NEURONS}",
                      f"-DLANE_SCAN_CHUNK={LANE_SCAN_CHUNK}",
                      f"-DLANE_SCAN_STAGES={LANE_SCAN_STAGES}",
                      f"-DLANE_BWD_SEG={LANE_BWD_SEG}")
LINK_FLAGS = _ARCH + ("-shared",)
LIB_NAME = "libreprotorch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64

# C signatures, one per exported symbol: (argtypes, restype)
SIGNATURES = {
    "spikemm_f32": ((_P, _P, _P) + (_I,) * 5 + (_P,), _I),
    "spikemm_sessions_f32": ((_P, _P, _P) + (_I,) * 6 + (_P,), _I),
    "spikemm_wgrad_f32": ((_P, _I) + (_P,) * 4 + (_I,) * 7 + (_P,), _I),
    "linrec_f32": ((_P, _L, _L, _L, _P, _P, _P, _P) + (_I,) * 5 + (_P,),
                   _I),
    "lif_f32": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P), _I),
    "lif_bwd_f32": ((_P,) * 12 + (_I, _I, _I, _F, _I, _I, _F, _P), _I),
    "linrec_bwd_f32": ((_P, _L, _L, _L) + (_P,) * 9 + (_I,) * 6 + (_P,),
                       _I),
    "lifrec_f32": ((_P,) * 7 + (_I, _I, _I, _F, _I, _I, _I, _P), _I),
    "lifrec_bwd_f32": ((_P,) * 14 + (_I, _I, _I, _F, _I, _F) + (_I,) * 3
                       + (_P,), _I),
    "alifrec_bwd_f32": ((_P,) * 20 + (_I, _I, _I, _F, _F, _I, _F)
                        + (_I,) * 3 + (_P,), _I),
    "alif_bwd_f32": ((_P,) * 17 + (_I, _I, _I, _F, _F, _I, _F, _P), _I),
    "alif_f32": ((_P,) * 8 + (_I, _I, _I, _F, _F, _I, _I, _P), _I),
    "alifrec_f32": ((_P,) * 10 + (_I, _I, _I, _F, _F, _I, _I, _I, _P),
                    _I),
    "spikemm_occupancy_f32": ((_P, _P, _P, _I, _I, _P), _I),
    "spikemm_sparse_f32": ((_P,) * 4 + (_I,) * 4 + (_P,), _I),
    "spikemm_gather_f32": ((_P,) * 6 + (_I,) * 10 + (_P,), _I),
    "spikemm_gather_bwd_f32": ((_P,) * 6 + (_I,) * 7 + (_P,), _I),
    "stdp_seq_f32": ((_P,) * 5 + (_I,) * 7 + (_F, _F, _P), _I),
    "stdp_seq_sessions_f32": ((_P,) * 5 + (_I,) * 7 + (_F, _F, _P), _I),
    "stdp_f32": ((_P,) * 6 + (_I,) * 3 + (_F,) * 4 + (_I, _P), _I),
    "stdp_bf16": ((_P,) * 6 + (_I,) * 3 + (_F,) * 4 + (_I, _P), _I),
    "flash_attention_f32": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _P), _I),
    "flash_attention_bf16": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _P), _I),
    "flash_attention_bf16_tc": ((_P,) * 6 + (_I,) * 6 + (_F, _I, _P), _I),
    "flash_attention_combine_bf16": ((_P, _P, _P, _L, _I, _I, _P), _I),
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
                 " ".join(NVCC_FLAGS), " ".join(LINK_FLAGS)):
        h.update(part.encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):     # the headers too
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one nvcc process each, all running at once)
    and link them with one more; returns the library's path. Reuses an
    existing build with the same digest."""
    nvcc = nvcc_path()
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(nvcc, srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]

        def finish(p):                       # (output, seconds since start)
            out = p.communicate()[0]
            return out, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, procs))
        logs = [f"== {s.name} ({secs:.1f} s)\n{out}"
                for s, (out, secs) in zip(srcs, done)]
        failed = [(s.name, p.returncode) for s, p in zip(srcs, procs)
                  if p.returncode != 0]
        tmp_lib = Path(tmp) / LIB_NAME
        if not failed:
            p = subprocess.run([nvcc, *LINK_FLAGS, *map(str, objs), "-o",
                                str(tmp_lib)], capture_output=True,
                               text=True)
            logs.append(f"== link\n{p.stdout}{p.stderr}")
            if p.returncode != 0:
                failed.append(("link", p.returncode))
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        if failed:
            # each failed source's own messages, without ptxas's reports
            why = "\n".join(
                f"== {n}\n" + "\n".join(
                    ln for ln in (done[srcs.index(CSRC / n)][0] if n != "link"
                                  else logs[-1]).splitlines()
                    if not ln.startswith(("ptxas info", "    "))
                )[:3000] for n, _ in failed)
            raise RuntimeError(f"nvcc exited {failed[0][1]} building "
                               f"{[n for n, _ in failed]}:\n{why}")
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
