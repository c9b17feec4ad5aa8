"""The gather kernel's event-driven walk, held on the CPU.

`csrc/spikemm_gather.cu` reads a patch row only where (a) it holds a
nonzero weight (`GatherTables.row_bitmap`) and (b) a spike of the warp's
rows meets it, and sums the rest in the plain version's order. Here:

* `row_bitmap` equals a numpy recount of `wblk != 0` per entry and word;
* `gather_plan` gives the rows and post blocks a CTA that the kernel's
  header describes, at the topology benchmark's calls and ragged M;
* a plain walk over the compacted lists of (a) and (b), with the plan's
  rows a warp (written here, used by nothing on the path), equals
  `spikemm_gather_ref` bit for bit, on -0.0 weights and spikes, graded
  spikes, silent rows, all-zero patch rows and sentinel post blocks;
* the plain version on those inputs agrees with the JAX `spikemm_gather`
  within the family's `KernelSpec.tol`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.spikemm.gather import build_gather_tables as jbuild
from repro_torch.kernels import registry
from repro_torch.kernels.spikemm.gather import (GATHER_MAX_ACC,
                                                GATHER_MAX_WARPS,
                                                GATHER_ROWS,
                                                GATHER_WARPS_PER_SM,
                                                build_gather_tables,
                                                gather_plan,
                                                spikemm_gather_ref)

N_SM = 132                          # the H100 SXM's SMs
N_PRE, N_POST, NO_FAN_IN = 150, 110, 90
BLOCKS = [(8, 8), (32, 32), (128, 128), (8, 4), (16, 40), (100, 64)]


def _coo(seed):
    """A ragged topology at 10 % density whose posts from NO_FAN_IN on have
    no fan-in: its last post blocks hold only sentinels at every bn."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N_PRE, N_POST)) < 0.1
    mask[:, NO_FAN_IN:] = False
    pre, post = np.nonzero(mask)
    return pre, post, rng.standard_normal(len(pre)).astype(np.float32)


def _tables(bk, bn, seed, signed_zeros=True):
    """The topology's tables; with `signed_zeros`, about 10 % of the patch
    rows become all -0.0, 10 % all +0.0, and some zero weights -0.0."""
    t = build_gather_tables(*_coo(seed), N_PRE, N_POST, bk=bk, bn=bn)
    if signed_zeros:
        rng = np.random.default_rng(seed + 1)
        pick = rng.random(t.wblk.shape[:2])
        t.wblk[pick < 0.1] = -0.0
        t.wblk[(pick >= 0.1) & (pick < 0.2)] = 0.0
        t.wblk[(t.wblk == 0) & (rng.random(t.wblk.shape) < 0.05)] = -0.0
    return t


def _raster(M, seed, rate=0.3):
    """Graded spikes of either sign at `rate`, some zeros -0.0, and (for
    M > 1) row M // 2 silent."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((M, N_PRE)) < rate,
                 rng.uniform(0.25, 2.0, (M, N_PRE))
                 * rng.choice([-1, 1], (M, N_PRE)), 0.0).astype(np.float32)
    x[(x == 0) & (rng.random((M, N_PRE)) < 0.1)] = -0.0
    if M > 1:
        x[M // 2] = 0.0
    return x


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# ---------------------------------------------------------------------------
# (a) the row-occupancy bitmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bk", [8, 16, 32, 100, 128])
def test_row_bitmap_recounts_nonzero_rows(bk):
    t = _tables(bk, 16, seed=bk)
    bits = t.row_bitmap()
    words = -(-bk // 32)
    assert bits.dtype == np.int32 and bits.shape == (len(t.jj), words)
    bits = bits.view(np.uint32)
    for e in range(len(t.jj)):
        for q in range(words):
            want = 0
            for k in range(32 * q, min(bk, 32 * q + 32)):
                if (t.act[e] and t.kk[e] * bk + k < N_PRE
                        and np.count_nonzero(t.wblk[e, k] != 0)):
                    want |= 1 << (k - 32 * q)
            assert int(bits[e, q]) == want, (e, q)
    # sentinels and rows of +-0 hold no bit; some rows of -0.0 exist
    assert not bits[t.act == 0].any()
    assert np.signbit(t.wblk[t.act != 0]).any()


def test_row_bitmap_memoised_on_the_device():
    t = _tables(32, 32, seed=3)
    d = t.device(torch.device("cpu"))
    assert d is t.device("cpu")
    assert d.rowbits.dtype == torch.int32
    assert np.array_equal(d.rowbits.numpy(), t.row_bitmap())


# ---------------------------------------------------------------------------
# the plan: rows and post blocks a CTA
# ---------------------------------------------------------------------------


# (M, bn, post blocks) -> (rows a warp, columns a lane, column warps,
# units, groups, grid)
BENCH_PLANS = {
    "topology_banded chunk": ((64, 128, 64), (1, 4, 1, 1, 8, (64, 8))),
    "exec_vs_dense": ((64, 128, 64), (1, 4, 1, 1, 8, (64, 8))),
    "scale_1e5": ((8, 128, 782), (2, 4, 1, 2, 4, (391, 1))),
    "scale_1e6": ((8, 32, 31250), (8, 1, 1, 8, 1, (3907, 1))),
}


@pytest.mark.parametrize("call", sorted(BENCH_PLANS))
def test_gather_plan_at_the_bench_calls(call):
    (M, bn, jb), want = BENCH_PLANS[call]
    p = gather_plan(M, bn, jb, N_SM)
    assert (p.rows, p.cols, p.col_warps, p.units, p.groups, p.grid) == want


@pytest.mark.parametrize("bn,jb", [(4, 28), (32, 31250), (40, 3), (64, 9),
                                   (100, 2), (128, 64), (300, 3)])
@pytest.mark.parametrize("M", [1, 8, 9, 64, 65])
def test_gather_plan_covers_the_output(M, bn, jb):
    """Columns a lane: 4 where 4 divides bn and bn >= 128, else 1; rows a
    warp: at most 8, the least power of two that
    holds M and 16 accumulators a thread, and the most of those that gives
    the card 16 warps an SM (else 1); at most 8 warps a CTA; the grid covers
    every row and every column warp of every post block; a CTA's row
    groups share its post blocks."""
    p = gather_plan(M, bn, jb, N_SM)
    assert p.cols == {4: 1, 40: 1, 32: 1, 64: 1, 100: 1, 128: 4,
                      300: 4}[bn]
    assert p.rows in GATHER_ROWS
    top = min(GATHER_ROWS[-1], GATHER_MAX_ACC // p.cols,
              1 << (M - 1).bit_length())
    assert p.rows <= top

    def warps(r):
        return jb * p.col_warps * -(-M // r)
    assert p.rows == 1 or warps(p.rows) >= GATHER_WARPS_PER_SM * N_SM
    assert p.rows == top or warps(2 * p.rows) < GATHER_WARPS_PER_SM * N_SM
    assert p.col_warps == -(-bn // (32 * p.cols))
    assert 1 <= p.warps <= GATHER_MAX_WARPS
    assert p.grid[0] * p.units >= jb * p.col_warps
    assert (p.grid[0] - 1) * p.units < jb * p.col_warps
    assert p.grid[1] * p.rows_per_cta >= M
    assert (p.grid[1] - 1) * p.rows_per_cta < M
    if p.col_warps < GATHER_MAX_WARPS:
        assert p.units % p.col_warps == 0     # whole post blocks a CTA
        assert p.post_blocks_per_cta == p.units // p.col_warps


@pytest.mark.parametrize("rows,cols,bn", [(3, 1, 32), (16, 1, 32),
                                          (8, 4, 128), (8, 3, 96),
                                          (4, 4, 130), (2, 2, 64)])
def test_gather_plan_refuses_other_instantiations(rows, cols, bn):
    with pytest.raises(ValueError, match="gather_plan"):
        gather_plan(8, bn, 4, N_SM, rows=rows, cols=cols)


def test_gather_plan_refuses_rows_past_one_launch():
    """The grid's y dimension holds 65535 CTAs of 8 row groups of 8."""
    assert gather_plan(65535 * 8 * 8, 32, 1, N_SM).grid == (1, 65535)
    with pytest.raises(ValueError, match="exceed one launch"):
        gather_plan(65535 * 8 * 8 + 1, 32, 1, N_SM)


# ---------------------------------------------------------------------------
# the skip rule, bit for bit
# ---------------------------------------------------------------------------


def event_walk(spikes, tables, rows):
    """The kernel's walk in plain PyTorch: for each group of `rows` rows
    and each post block, its entries in list order and, in each, the rows
    k in ascending order that (a) the bitmap lists and (b) a spike of the
    group meets, adding s * w rounded as a product and then as a sum.
    Returns the output and the (row, k) terms it skipped."""
    M = spikes.shape[0]
    bk, bn = tables.bk, tables.bn
    bits = tables.row_bitmap().view(np.uint32)
    jptr = tables.jptr()
    w = torch.from_numpy(tables.wblk)
    out = torch.zeros((M, tables.n_post_blocks * bn), dtype=torch.float32)
    skipped = 0
    for m0 in range(0, M, rows):
        s = spikes[m0:m0 + rows]
        for j in range(tables.n_post_blocks):
            acc = torch.zeros((s.shape[0], bn), dtype=torch.float32)
            for t in range(jptr[j], jptr[j + 1]):
                for k in range(bk):
                    p = int(tables.kk[t]) * bk + k
                    listed = bool(bits[t, k // 32] >> (k % 32) & 1)
                    if listed and bool((s[:, p] != 0).any()):
                        acc = acc + s[:, p, None] * w[t, k][None, :]
                    else:
                        skipped += 1
            out[m0:m0 + rows, j * bn:(j + 1) * bn] = acc
    return out[:, :tables.n_post], skipped


@pytest.mark.parametrize("M", [1, 9, 65])
@pytest.mark.parametrize("bk,bn", BLOCKS)
def test_event_walk_equals_plain_bit_for_bit(bk, bn, M):
    t = _tables(bk, bn, seed=bk + bn)
    x = torch.from_numpy(_raster(M, seed=M + bk))
    rows = gather_plan(M, bn, t.n_post_blocks, N_SM).rows
    got, skipped = event_walk(x, t, rows)
    want = spikemm_gather_ref(x, t)
    assert skipped > 0
    assert got.abs().sum() > 0
    assert _same_bits(got, want)


@pytest.mark.parametrize("bk,bn", BLOCKS)
def test_event_walk_on_edge_rasters(bk, bn):
    """An all-silent raster gives +0 everywhere; a raster where only the
    last pre neuron of each block fires (and the last of all) walks one
    row an entry; both equal the plain version bit for bit."""
    t = _tables(bk, bn, seed=7 * bk + bn)
    rows = gather_plan(9, bn, t.n_post_blocks, N_SM).rows
    silent = torch.zeros((9, N_PRE))
    got, _ = event_walk(silent, t, rows)
    want = spikemm_gather_ref(silent, t)
    assert _same_bits(got, want) and _same_bits(got, torch.zeros_like(got))
    last = torch.zeros((9, N_PRE))
    last[:, bk - 1::bk] = 1.0
    last[:, N_PRE - 1] = -0.5
    got, _ = event_walk(last, t, rows)
    assert got.abs().sum() > 0
    assert _same_bits(got, spikemm_gather_ref(last, t))


@pytest.mark.parametrize("bk,bn", [(8, 4), (8, 8), (32, 32)])
def test_sentinel_post_blocks_are_plus_zero(bk, bn):
    """Post blocks made only of sentinels hold +0 in every row."""
    t = _tables(bk, bn, seed=5)
    x = torch.from_numpy(_raster(9, seed=4))
    out = spikemm_gather_ref(x, t)
    empty = np.flatnonzero(np.bincount(t.jj[t.act != 0],
                                       minlength=t.n_post_blocks) == 0)
    assert len(empty)
    for j in empty:
        cols = out[:, j * bn:min((j + 1) * bn, N_POST)]
        assert _same_bits(cols, torch.zeros_like(cols))


@pytest.mark.parametrize("M", [1, 9, 65])
@pytest.mark.parametrize("bk,bn", [(8, 8), (32, 32), (8, 4), (100, 64)])
def test_plain_matches_jax_on_graded_spikes(bk, bn, M):
    """The plain version on graded, signed spikes with -0.0 entries and a
    silent row against the JAX `spikemm_gather` (its reference route),
    both from the same COO, within the family's tolerance."""
    pre, post, w = _coo(bk * bn)
    x = _raster(M, seed=3 * M + bk)
    tt = build_gather_tables(pre, post, w, N_PRE, N_POST, bk=bk, bn=bn)
    jt = jbuild(pre, post, w, N_PRE, N_POST, bk=bk, bn=bn)
    want = np.asarray(jreg.dispatch("spikemm_gather", (jnp.asarray(x), jt)))
    got = spikemm_gather_ref(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=registry.get("spikemm_gather").tol)
