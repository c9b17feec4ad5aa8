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
from repro_torch.kernels.spikemm.gather import (GATHER_BWD_RPT,
                                                GATHER_BWD_SLAB,
                                                GATHER_MAX_ACC,
                                                GATHER_MAX_WARPS,
                                                GATHER_ROWS,
                                                GATHER_WARPS_PER_SM,
                                                build_gather_tables,
                                                gather_bwd_plan, gather_plan,
                                                spikemm_gather_bwd_ref,
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


# ---------------------------------------------------------------------------
# B6, the gather's backward: the sub-tile mask, the step lists, the plan
# ---------------------------------------------------------------------------


def _dense_of(tables):
    """The dense (n_pre, n_post) matrix of `tables`, each active patch
    scattered to its block (what lies past n_pre or n_post dropped)."""
    bk, bn = tables.bk, tables.bn
    kb = max(1, -(-tables.n_pre // bk))
    dense = np.zeros((kb * bk, tables.n_post_blocks * bn), np.float32)
    for t in np.flatnonzero(tables.act):
        k0, n0 = tables.kk[t] * bk, tables.jj[t] * bn
        dense[k0:k0 + bk, n0:n0 + bn] = tables.wblk[t]
    return dense[:tables.n_pre, :tables.n_post]


def _banded_tables(n, band, bk):
    rows = np.repeat(np.arange(n), 2 * band + 1)
    cols = rows + np.tile(np.arange(-band, band + 1), n)
    keep = (cols >= 0) & (cols < n)
    w = np.random.default_rng(n).standard_normal(keep.sum())
    return build_gather_tables(rows[keep], cols[keep], w, n, n, bk=bk, bn=bk)


def _bwd_tables(kind):
    """Tables whose transpose B6 walks: the band (ragged against 128-wide
    blocks, and at 32), the registry's random inputs (n_pre 260, n_post
    200), and the ragged topology whose last post blocks hold only
    sentinels (its transpose then has pre blocks with no entry)."""
    if kind == "banded 128":
        return _banded_tables(300, 40, 128)
    if kind == "banded 32":
        return _banded_tables(300, 40, 32)
    if kind == "make_inputs":
        from repro_torch.kernels.spikemm.gather import _make_inputs
        return _make_inputs(torch.Generator().manual_seed(0))[1]
    bk, bn = {"empty post blocks 8x4": (8, 4),
              "empty post blocks 32x32": (32, 32)}[kind]
    return _tables(bk, bn, seed=bk + bn, signed_zeros=False)


BWD_KINDS = ["banded 128", "banded 32", "make_inputs",
             "empty post blocks 8x4", "empty post blocks 32x32"]


@pytest.mark.parametrize("side", ["transposed", "forward"])
@pytest.mark.parametrize("kind", BWD_KINDS)
def test_tile_mask_is_any_nonzero_of_the_dense_sub_tile(kind, side):
    """`tile_mask` equals numpy's "any nonzero weight in the (32 x 32)
    sub-tile" of the dense matrix (W^T for the transposed tables), block
    by block; sentinels hold no bit, and the transpose's dense matrix is
    the forward's transposed."""
    fwd = _bwd_tables(kind)
    t = fwd.transpose() if side == "transposed" else fwd
    dense = _dense_of(t)
    if side == "transposed":
        assert np.array_equal(dense, _dense_of(fwd).T)
    mask = t.tile_mask()
    kw, cw = -(-t.bk // 32), -(-t.bn // 32)
    assert mask.dtype == bool and mask.shape == (len(t.jj), kw, cw)
    want = np.zeros_like(mask)
    for e in np.flatnonzero(t.act):
        for w in range(kw):
            for c in range(cw):
                k0 = t.kk[e] * t.bk + 32 * w
                n0 = t.jj[e] * t.bn + 32 * c
                k1 = min(k0 + 32, (t.kk[e] + 1) * t.bk)
                n1 = min(n0 + 32, (t.jj[e] + 1) * t.bn)
                want[e, w, c] = bool((dense[k0:k1, n0:n1] != 0).any())
    assert np.array_equal(mask, want)
    assert mask.any() and not mask[t.act == 0].any()
    if kind.startswith("empty") and side == "forward":
        assert (t.act == 0).any()


@pytest.mark.parametrize("kind", BWD_KINDS)
def test_bwd_steps_list_each_slab_s_sub_tiles_in_order(kind):
    """Each (post block, slab)'s steps are the sub-tiles the mask sets at
    that slab, over the block's entries in list order and each entry's
    words ascending; the lists are memoised on the device with the
    tables."""
    t = _bwd_tables(kind).transpose()
    mask = t.tile_mask()
    kw, cw = mask.shape[1:]
    sptr, steps = t.bwd_steps()
    assert sptr.dtype == steps.dtype == np.int32
    assert len(sptr) == t.n_post_blocks * cw + 1 and sptr[-1] == len(steps)
    jptr = t.jptr()
    for j in range(t.n_post_blocks):
        for c in range(cw):
            want = [e * kw + w for e in range(jptr[j], jptr[j + 1])
                    for w in range(kw) if mask[e, w, c]]
            b = j * cw + c
            assert steps[sptr[b]:sptr[b + 1]].tolist() == want
    d = t.device(torch.device("cpu"), bwd=True)
    assert d is t.device("cpu") and d is t.device("cpu", bwd=True)
    assert np.array_equal(d.steps.numpy(), steps)
    assert np.array_equal(d.sptr.numpy(), sptr)


def bwd_walk(g, tables, rows_per_cta):
    """B6's kernel in plain PyTorch: for each tile of `rows_per_cta` rows
    of g, each post block and each 32-column slab of the transposed
    `tables`, the listed steps in order, each adding 32 terms k ascending
    of g's zero-filled (rows, 32) tile times the patch's zero-filled
    (32, 32) tile, rounded as a product and then as a sum. Returns the
    output and the sub-tiles skipped."""
    M = g.shape[0]
    bk, bn = tables.bk, tables.bn
    kw, cw = -(-bk // 32), -(-bn // 32)
    sptr, steps = tables.bwd_steps()
    w = torch.from_numpy(tables.wblk)
    out = torch.zeros((M, tables.n_post_blocks * cw * 32))
    for m0 in range(0, M, rows_per_cta):
        gm = g[m0:m0 + rows_per_cta]
        for b in range(tables.n_post_blocks * cw):
            j, c = divmod(b, cw)
            acc = torch.zeros((gm.shape[0], 32))
            for code in steps[sptr[b]:sptr[b + 1]]:
                t, wd = divmod(int(code), kw)
                k0 = 32 * wd
                rows = min(32, bk - k0)
                p0 = int(tables.kk[t]) * bk + k0
                gt = torch.zeros((gm.shape[0], 32))
                have = max(0, min(rows, tables.n_pre - p0))
                gt[:, :have] = gm[:, p0:p0 + have]
                wt = torch.zeros((32, 32))
                cols = min(32, bn - 32 * c)
                wt[:rows, :cols] = w[t, k0:k0 + rows, 32 * c:32 * c + cols]
                for k in range(32):
                    acc = acc + gt[:, k, None] * wt[None, k, :]
            n0 = j * bn + 32 * c
            width = min(32, bn - 32 * c)
            out[m0:m0 + rows_per_cta, n0:n0 + width] = acc[:, :width]
    skipped = len(tables.jj) * kw * cw - len(steps)
    return out[:, :tables.n_post], skipped


@pytest.mark.parametrize("M", [1, 9, 65])
@pytest.mark.parametrize("bk,bn", BLOCKS)
def test_bwd_walk_equals_plain_bit_for_bit(bk, bn, M):
    """B6's walk of the step lists, at the plan's rows a CTA, equals
    `spikemm_gather_bwd_ref` bit for bit on a dense, signed cotangent with
    -0.0 entries and tables with rows of +-0 and -0.0 weights."""
    fwd = _tables(bk, bn, seed=bk + bn)
    t = fwd.transpose()
    rng = np.random.default_rng(M + bk)
    g = rng.standard_normal((M, N_POST)).astype(np.float32)
    g[rng.random((M, N_POST)) < 0.05] = -0.0
    g = torch.from_numpy(g)
    plan = gather_bwd_plan(M, t.bn, t.n_post_blocks, N_SM)
    got, skipped = bwd_walk(g, t, plan.rows_per_cta)
    want = spikemm_gather_bwd_ref(g, fwd)
    # at 32 x 32 blocks a sub-tile is a whole patch, none of them zero
    assert (skipped > 0) != ((bk, bn) == (32, 32))
    assert got.abs().sum() > 0 and _same_bits(got, want)


# (M, bn, post blocks) -> (rows a thread, grid): train_banded's backward
# (1024 rows) and 64 rows, on the band and at scale_1e5
BWD_PLANS = {
    "train_banded": ((1024, 128, 64), (4, (256, 16))),
    "banded, 64 rows": ((64, 128, 64), (2, (256, 2))),
    "scale_1e5": ((1024, 128, 782), (4, (3128, 16))),
    "scale_1e5, 64 rows": ((64, 128, 782), (4, (3128, 1))),
}


@pytest.mark.parametrize("call", sorted(BWD_PLANS))
def test_gather_bwd_plan_at_the_b6_calls(call):
    (M, bn, jb), want = BWD_PLANS[call]
    p = gather_bwd_plan(M, bn, jb, N_SM)
    assert (p.rows, p.grid) == want


@pytest.mark.parametrize("bn,jb", [(4, 28), (32, 31250), (40, 3),
                                   (128, 64), (300, 3)])
@pytest.mark.parametrize("M", [1, 8, 9, 64, 65, 1024])
def test_gather_bwd_plan_covers_the_output(M, bn, jb):
    """Rows a thread: of 4, 2, 1, a CTA under twice M's rows (or 1), the
    most that still gives two CTAs an SM (else the fewest); the grid covers
    every row and every 32-column slab of every post block."""
    p = gather_bwd_plan(M, bn, jb, N_SM)
    assert p.rows in GATHER_BWD_RPT
    assert p.rows == 1 or p.rows_per_cta < 2 * M
    slabs = jb * -(-bn // GATHER_BWD_SLAB)
    assert p.grid[0] == slabs
    assert p.grid[1] * p.rows_per_cta >= M > (p.grid[1] - 1) * p.rows_per_cta
    assert p.rows == 1 or slabs * p.grid[1] >= 2 * N_SM
    bigger = [r for r in GATHER_BWD_RPT if r > p.rows and 16 * r < 2 * M]
    assert all(slabs * -(-M // (16 * r)) < 2 * N_SM for r in bigger)


def test_gather_bwd_plan_refuses_other_instantiations():
    """No plan for an empty output, and none past one launch's grid."""
    for M, bn, jb in ((0, 32, 4), (8, 0, 4), (8, 32, 0)):
        with pytest.raises(ValueError, match="gather_bwd_plan"):
            gather_bwd_plan(M, bn, jb, N_SM)
    p = gather_bwd_plan(65535 * 64, 32, 1, N_SM)
    assert (p.rows, p.grid) == (4, (1, 65535))
    with pytest.raises(ValueError, match="exceed one launch"):
        gather_bwd_plan(65535 * 64 + 1, 32, 1, N_SM)


@pytest.mark.parametrize("M", [1, 64, 130])
def test_gather_bwd_wrapper_is_one_launch(monkeypatch, M):
    """With a recording stand-in for the library (no card here), B6's
    wrapper makes one C call, `spikemm_gather_bwd_f32`, on the transposed
    tables with the planned rows, counts one launch as
    `spikemm_gather_bwd`, and launches and counts nothing of the forward
    gather."""
    from contextlib import nullcontext
    from unittest import mock

    from repro_torch.kernels import _build
    from repro_torch.kernels.spikemm import gather
    lib = mock.Mock(**{"spikemm_gather_bwd_f32.return_value": 0})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(gather, "sm_count", lambda dev: N_SM)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    fwd = _tables(32, 32, seed=2)
    t = fwd.transpose()
    registry.reset_launches()
    try:
        out = gather.spikemm_gather_bwd_cuda(torch.zeros((M, N_POST)), fwd)
        counts = registry.launch_counts()
    finally:
        registry.reset_launches()
    assert out.shape == (M, N_PRE)
    assert [c[0] for c in lib.method_calls] == ["spikemm_gather_bwd_f32"]
    plan = gather_bwd_plan(M, t.bn, t.n_post_blocks, N_SM)
    assert lib.spikemm_gather_bwd_f32.call_args.args[6:13] == (
        M, t.n_pre, t.n_post, t.bk, t.bn, t.n_post_blocks, plan.rows)
    assert counts["spikemm_gather_bwd"] == 1
    assert counts["spikemm_gather"] == 0
    with pytest.raises(ValueError, match=r"must be \(M, 110\)"):
        gather.spikemm_gather_bwd_cuda(torch.zeros((M, N_PRE)), fwd)
