"""Block-gather spikemm: execute IE tables, not dense matrices.

The port of `repro/kernels/spikemm/gather.py`. `core/topology.py` stores
connectivity the way the chip does (typed fan-in IE tables); this module
is their execution form. The (pre, post, weight) triples an
`EncodedTopology` derives from its IE tables are packed once into a
block-level COO (`GatherTables`, numpy, built exactly as the JAX package
builds it):

    jj[t], kk[t]   post-/pre- block coordinates of occupied (bk, bn) blocks,
                   sorted post-block-major (the accumulation order),
    wblk[t]        the (bk, bn) dense patch of weights inside that block,
    act[t]         0 marks sentinels (one per empty post block, so every
                   output tile is visited and initialised exactly once)

and `spikemm_gather` contracts an (M, n_pre) spike raster against those
tables. Work scales with the number of occupied blocks E, never with
n_pre * n_post: the dense matrix is never built.

Registered as the `spikemm_gather` family: CUDA tensors launch
`csrc/spikemm_gather.cu` (one CTA per output tile of a post block, walking
that block's entries in order); CPU tensors run `spikemm_gather_ref`,
which sums every output in the kernel's order (entries ascending, k
ascending, a separately rounded multiply and add per term), so the card
matches it bit for bit.

Not ported yet: `GatherTables.transpose()` and the gather's VJP (the
backward runs the same kernel on the transposed tables) wait for the
training slice.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import _build, registry

DEFAULT_BK = 128
DEFAULT_BN = 128


@dataclasses.dataclass(eq=False)
class GatherTables:
    """Packed block-level COO for one encoded topology (host-side numpy).

    Identity-hashed (eq=False), as in the JAX package: the tables are
    configuration, built once per topology and block shape."""

    jj: np.ndarray        # (E,) int32 post-block ids, non-decreasing
    kk: np.ndarray        # (E,) int32 pre-block ids
    act: np.ndarray       # (E,) int32, 0 = sentinel (empty post block)
    wblk: np.ndarray      # (E, bk, bn) float32 packed weight blocks
    n_pre: int
    n_post: int
    bk: int
    bn: int

    def __post_init__(self):
        self._device: Dict[torch.device, SimpleNamespace] = {}

    @property
    def n_entries(self) -> int:
        return int(self.act.sum())

    @property
    def n_post_blocks(self) -> int:
        return max(1, -(-self.n_post // self.bn))

    def jptr(self) -> np.ndarray:
        """(n_post_blocks + 1,) int32: entries [jptr[j], jptr[j+1]) belong
        to post block j."""
        return np.searchsorted(self.jj, np.arange(self.n_post_blocks + 1)
                               ).astype(np.int32)

    def device(self, device: torch.device) -> SimpleNamespace:
        """Memoised copies of the tables (and `jptr`) on `device`."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = SimpleNamespace(**{
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in (("jj", self.jj), ("kk", self.kk),
                             ("act", self.act), ("wblk", self.wblk),
                             ("jptr", self.jptr()))})
        return self._device[device]


def _finalize_tables(jj, kk, wblk, *, n_pre, n_post, bk, bn) -> GatherTables:
    """Sort entries post-block-major and add one inactive sentinel per empty
    post block so the kernel visits (and zero-initializes) every output
    tile."""
    jj = np.asarray(jj, np.int32)
    kk = np.asarray(kk, np.int32)
    wblk = np.asarray(wblk, np.float32).reshape(-1, bk, bn)
    act = np.ones(len(jj), np.int32)
    n_post_blocks = max(1, -(-n_post // bn))
    missing = np.setdiff1d(np.arange(n_post_blocks, dtype=np.int32),
                           np.unique(jj))
    if len(missing):
        jj = np.concatenate([jj, missing])
        kk = np.concatenate([kk, np.zeros(len(missing), np.int32)])
        act = np.concatenate([act, np.zeros(len(missing), np.int32)])
        wblk = np.concatenate(
            [wblk, np.zeros((len(missing), bk, bn), np.float32)])
    order = np.lexsort((kk, jj))
    return GatherTables(jj=np.ascontiguousarray(jj[order]),
                        kk=np.ascontiguousarray(kk[order]),
                        act=np.ascontiguousarray(act[order]),
                        wblk=np.ascontiguousarray(wblk[order]),
                        n_pre=int(n_pre), n_post=int(n_post),
                        bk=int(bk), bn=int(bn))


def build_gather_tables(pre, post, w, n_pre: int, n_post: int, *,
                        bk: int = DEFAULT_BK, bn: int = DEFAULT_BN
                        ) -> GatherTables:
    """Pack (pre, post, weight) COO triples into block tables.

    Duplicated (pre, post) pairs accumulate into the same block slot,
    matching the event-driven `propagate()` semantics. Out-of-range indices
    raise — ghost IE entries must never silently scatter.
    """
    pre = np.asarray(pre, np.int64).ravel()
    post = np.asarray(post, np.int64).ravel()
    w = np.asarray(w, np.float32).ravel()
    if not (len(pre) == len(post) == len(w)):
        raise ValueError("pre/post/weight lengths differ")
    if len(pre):
        if pre.min() < 0 or pre.max() >= n_pre:
            raise ValueError(f"ghost pre index outside [0, {n_pre})")
        if post.min() < 0 or post.max() >= n_post:
            raise ValueError(f"ghost post index outside [0, {n_post})")
    n_pre_blocks = max(1, -(-n_pre // bk))
    bid = (post // bn) * n_pre_blocks + (pre // bk)
    uniq = np.unique(bid)
    wblk = np.zeros((len(uniq), bk, bn), np.float32)
    if len(pre):
        rank = np.searchsorted(uniq, bid)
        np.add.at(wblk, (rank, pre % bk, post % bn), w)
    jj = (uniq // n_pre_blocks).astype(np.int32)
    kk = (uniq % n_pre_blocks).astype(np.int32)
    return _finalize_tables(jj, kk, wblk, n_pre=n_pre, n_post=n_post,
                            bk=bk, bn=bn)


# ---------------------------------------------------------------------------
# plain version and CUDA wrapper
# ---------------------------------------------------------------------------


def spikemm_gather_ref(spikes: torch.Tensor, tables: GatherTables
                       ) -> torch.Tensor:
    """Plain version: (M, n_pre) spikes -> (M, n_post) currents.

    Every output element is one sequential fp32 sum, in the kernel's
    order: the entries of its post block in list order (ascending kk),
    then each entry's bk rows in ascending k, adding `s * w` rounded as a
    product and then as a sum. The loop runs over (entry slot, k) and is
    vectorised over rows and post blocks; a post block with fewer entries
    adds exact zeros in its missing slots, which change nothing."""
    M = spikes.shape[0]
    bk, bn = tables.bk, tables.bn
    kb = max(1, -(-tables.n_pre // bk))
    jb = tables.n_post_blocks
    dt = tables.device(spikes.device)
    s = torch.zeros((M, kb * bk), dtype=torch.float32, device=spikes.device)
    s[:, :spikes.shape[1]] = spikes
    sb = s.reshape(M, kb, bk)
    jptr = tables.jptr().astype(np.int64)
    counts = jptr[1:] - jptr[:-1]
    acc = torch.zeros((M, jb, bn), dtype=torch.float32, device=spikes.device)
    for e in range(int(counts.max())):
        t = np.minimum(jptr[:-1] + e, jptr[1:] - 1)          # (jb,)
        live = (counts > e) & (tables.act[t] != 0)
        t_dev = torch.from_numpy(t).to(spikes.device)
        live_dev = torch.from_numpy(live).to(spikes.device)
        w_e = torch.where(live_dev[:, None, None], dt.wblk[t_dev],
                          torch.zeros((), device=spikes.device))
        s_e = sb[:, dt.kk[t_dev].long(), :]                  # (M, jb, bk)
        for k in range(bk):
            acc = acc + s_e[:, :, k, None] * w_e[None, :, k, :]
    return acc.reshape(M, jb * bn)[:, :tables.n_post]


def spikemm_gather_cuda(spikes: torch.Tensor, tables: GatherTables
                        ) -> torch.Tensor:
    """Launch `csrc/spikemm_gather.cu` on a CUDA raster."""
    if not spikes.is_cuda:
        raise ValueError(f"spikemm_gather: the CUDA kernel takes CUDA "
                         f"tensors, got {spikes.device}")
    if spikes.dim() != 2 or spikes.shape[1] != tables.n_pre:
        raise ValueError(f"spikemm_gather: spikes {tuple(spikes.shape)} "
                         f"must be (M, {tables.n_pre})")
    if spikes.dtype != torch.float32:
        raise TypeError(f"spikemm_gather: spikes must be float32, got "
                        f"{spikes.dtype}")
    if not spikes.is_contiguous():
        raise ValueError("spikemm_gather: spikes must be contiguous")
    M = spikes.shape[0]
    out = torch.empty((M, tables.n_post), dtype=torch.float32,
                      device=spikes.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    if -(-M // lib.spikemm_gather_block_m()) > 65535:
        raise ValueError(f"spikemm_gather: M={M} rows exceed one launch")
    dt = tables.device(spikes.device)
    with torch.cuda.device(spikes.device):
        code = lib.spikemm_gather_f32(
            spikes.data_ptr(), dt.wblk.data_ptr(), dt.jptr.data_ptr(),
            dt.kk.data_ptr(), dt.act.data_ptr(), out.data_ptr(), M,
            tables.n_pre, tables.n_post, tables.bk, tables.bn,
            tables.n_post_blocks, torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_gather", code)
    spikemm_gather_cuda.launches += 1
    return out


spikemm_gather_cuda.launches = 0


def spikemm_gather(spikes: torch.Tensor, tables: GatherTables
                   ) -> torch.Tensor:
    """IE-table contraction: (M, n_pre) spikes -> (M, n_post) currents."""
    return registry.dispatch("spikemm_gather", (spikes, tables))


def _make_inputs(generator: torch.Generator):
    m, n_pre, n_post = 96, 260, 200               # non-multiples: padding
    mask = (torch.rand((n_pre, n_post), generator=generator) < 0.05).numpy()
    pre, post = np.nonzero(mask)
    w = torch.randn((len(pre),), generator=generator).numpy()
    tables = build_gather_tables(pre, post, w, n_pre, n_post)
    spikes = (torch.rand((m, n_pre), generator=generator) < 0.3).float()
    return spikes, tables


registry.register(registry.KernelSpec(
    name="spikemm_gather", plain=spikemm_gather_ref,
    cuda=spikemm_gather_cuda, make_inputs=_make_inputs, tol=1e-4))

__all__ = ["GatherTables", "build_gather_tables", "spikemm_gather",
           "spikemm_gather_cuda", "spikemm_gather_ref", "DEFAULT_BK",
           "DEFAULT_BN"]
