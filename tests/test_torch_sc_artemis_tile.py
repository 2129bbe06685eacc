"""sc_matmul's artemis path above decode (M > 16), restated in torch.

The CUDA kernel (`artemis_tile_kernel` in
`repro_torch/kernels/sc_matmul/csrc/sc_matmul.cu`) runs only on the
card, where `chip_smoke.py` holds it bit for bit against the plain
version. Here `_tile_emulation` restates its partition and order: the
operands zero-filled to whole tiles of 4R x 8C outputs and to whole
32-deep windows, each thread's walk over K in order (pairs of k, a
single k at a group's odd end), the products in the 16-bit lanes of
the kernel's words (2|a| times a pair of |b|, the floor as the high
bytes, negative products routed by the sign masks), and at each group's
end the readout of both lanes into f32 accumulators, in group order,
with the level looked up in the readout table as the kernel looks it up
(or the sum itself for the ideal readout). It is held:

- bit-equal to the plain version at depths 1, 16, 20 and 128 and
  readouts of 1, 8 and 12 bits and ideal, on every thread tile, with K
  ragged against the group and the window and -128 rows and columns;
- within the reference's own 2e-4 of the Pallas kernel in interpret
  mode at its depth of 20 (it multiplies by 1/delta and sums block by
  block), on outputs dequantized at unit operand scale.

The split over K for grids too small to fill the card (parts of whole
groups, their levels stored as bytes, or past 8 bits and ideally their
sums as 16-bit words, and scanned in group order) is held the same ways, and so are the plan (its thread tile and parts at
the serve shapes, a mirror of the .cu's), the wrapper's argument block
and scratch above decode, and the constants the emulation shares with
the CUDA source.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from test_torch_sc_launch import _int8 as _launch_int8  # noqa: E402
from test_torch_kernel_launch import _Recorder  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sc_matmul.sc_matmul import (  # noqa: E402
    sc_matmul_quantized as jpallas,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sc_matmul import sc_matmul as sc_mod  # noqa: E402
from repro_torch.kernels.sc_matmul.ref import (  # noqa: E402
    SC_LEVELS,
    _fma,
    readout_table,
    sc_matmul_ref,
)

MASK = 0xFFFFFFFF
TILE_WK = 32                       # k rows a warp stages at a time
SPLIT_MAX_M = 16                   # M above which the tile path runs
TILE_FILL_WARPS = 1024             # warps below which K is split
TILES = {"8x8": (8, 8), "8x4": (8, 4)}
PALLAS_TOL = dict(rtol=2e-4, atol=2e-4)
UNIT_SCALE = 128 / 127**2      # SC product units -> dequantized, |a|,|b|<=1


def _operands(seed, m, k, n):
    """int8 operands from [-128, 127], with row 1 of A and column 2 of B
    all -128 (floor(128 * 128 / 128) = 128 in a product's 8 bits)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    a[1] = -128
    b[:, 2] = -128
    return a, b


def _negative_bytes(x):
    """0xFF in each byte of x whose bit 7 is set (prmt 0xBA98)."""
    return ((x >> 7) & 0x01010101) * 0xFF


def _b_words(row):
    """One k row of B (Np int8 values, Np a multiple of 4) as the
    kernel's words: for each 4-column word c, the magnitudes of columns
    (c, c + 2) and (c + 1, c + 3) in 16-bit lanes and their sign masks
    (`b_pairs`)."""
    u = (row.to(torch.int64) & 0xFF).view(-1, 4)
    x = u[:, 0] | (u[:, 1] << 8) | (u[:, 2] << 16) | (u[:, 3] << 24)
    s = _negative_bytes(x)
    mag = ((x ^ s) + (s & 0x01010101)) & MASK
    m02 = (mag & 0xFF) | (((mag >> 16) & 0xFF) << 16)
    m13 = ((mag >> 8) & 0xFF) | (((mag >> 24) & 0xFF) << 16)
    return (m02, m13), (s, s >> 8)


def _a_words(col):
    """One k column of A as the kernel's words: 2|a| from the bytewise
    magnitude, and all ones where a < 0."""
    x = col.to(torch.int64) & 0xFF
    s = torch.where(x >= 0x80, 0xFF, 0)
    mag = ((x ^ s) + (s & 1)) & 0xFF
    return mag << 1, torch.where(s > 0, MASK, 0)


def _levels(x, acc_depth, readout_bits, scale=1):
    """The level of each group sum x (f32) as the kernel reads it out;
    scale 4: x is a lane kept at 4x, the level's byte offset."""
    if readout_bits is None:
        return x
    assert bool(((x.long() % scale) == 0).all())
    return readout_table(acc_depth, readout_bits)[x.long() // scale]


def _tile_emulation(a, b, acc_depth, readout_bits, tile, per_split=None,
                    seed=0):
    """The kernel above decode in torch, as the module docstring says.
    a: (M, K), b: (K, N) int8 numpy; returns the (M, N) f32 product.
    per_split: K split over parts of that many groups (8 x 8 tiles), the
    parts walked in a random order, each group stored as the kernel
    stores it (u8 level pairs; where `wide`, the sums as u16 pairs, whose
    levels the scan looks up), then scanned. An
    8 x 4 tile's table readout below depth 128 keeps tot's lanes at 4x,
    as the kernel does (kReadTable4: `one` = 4, neg scaled at the
    readout)."""
    r_, c_ = TILES[tile]
    rows, cols = 4 * r_, 8 * c_
    m, k = a.shape
    n = b.shape[1]
    d = acc_depth
    groups = -(-k // d)
    kend = groups * d
    mp, np_ = -(-m // rows) * rows, -(-n // cols) * cols
    kp = kend + TILE_WK
    ta = torch.zeros((mp, kp), dtype=torch.int8)
    tb = torch.zeros((kp, np_), dtype=torch.int8)
    ta[:m, :k] = torch.from_numpy(a)
    tb[:k, :n] = torch.from_numpy(b)
    tot = [torch.zeros((mp, np_ // 4), dtype=torch.int64) for _ in range(2)]
    neg = [torch.zeros((mp, np_ // 4), dtype=torch.int64) for _ in range(2)]
    acc = torch.zeros((mp, np_), dtype=torch.float32)
    wide = readout_bits is None or readout_bits > 8
    shift = 16 if wide else 8
    one = 4 if (tile == "8x4" and readout_bits is not None
                and per_split is None and d < 128) else 1
    stored = torch.full((groups, mp, np_), -1, dtype=torch.int64)
    if readout_bits is not None:
        delta = torch.tensor(d * (SC_LEVELS - 1) / (2**readout_bits - 1),
                             dtype=torch.float32)

    def products(kk):
        am, an = _a_words(ta[:, kk])
        bm, bn = _b_words(tb[kk])
        ys = []
        for p in range(2):
            prod = (am[:, None] * bm[p][None, :]) & MASK
            y = (prod >> 8) & 0x00FF00FF              # floor_pair's PRMT
            tot[p][:] = (tot[p] + y * one) & MASK
            ys.append(y & (an[:, None] ^ bn[p][None, :]))
        return ys

    def step(kk, two):
        y0 = products(kk)
        y1 = products(kk + 1) if two else [0, 0]
        for p in range(2):                            # one IADD3 for two k
            neg[p][:] = (neg[p] + y0[p] + y1[p]) & MASK

    def scan_step(sl, pl, nl):
        if readout_bits is None:
            acc[:, sl] = (acc[:, sl] + pl) - nl
        else:
            acc[:, sl] = _fma(-nl, delta, _fma(pl, delta, acc[:, sl]))

    def group_end(g):
        for p in range(2):
            ng = (neg[p] * one) & MASK
            pos = (tot[p] - ng) & MASK
            for h in range(2):
                lane = lambda w: ((w >> (16 * h)) & 0xFFFF)
                ps, ns = lane(pos), lane(ng)
                # no lane carried into the next: each is its own sum
                assert int(ps.max()) <= one * d * 128 and \
                    int(ns.max()) <= one * d * 128 < 1 << 16
                pl = _levels(ps.float(), d, readout_bits, one)
                nl = _levels(ns.float(), d, readout_bits, one)
                # word c holds columns (4c, 4c + 2) or (4c + 1, 4c + 3)
                sl = slice(p + 2 * h, None, 4)
                if per_split is None:
                    scan_step(sl, pl, nl)
                elif wide:
                    stored[g][:, sl] = ps | (ns << shift)
                else:
                    assert int(max(pl.max(), nl.max())) < 1 << shift
                    stored[g][:, sl] = pl.long() | (nl.long() << shift)
            tot[p].zero_()
            neg[p].zero_()

    def walk(g_begin, g_end):
        """One part's warps: its k rows in 32-deep windows from its first
        group's first k, a group's readout where it ends."""
        kbeg, kstop = g_begin * d, g_end * d
        assert kbeg % 16 == 0
        gend = kbeg + d
        for k0 in range(kbeg, kstop, TILE_WK):
            wend = min(TILE_WK, kstop - k0)
            kk = 0
            while kk < wend:
                stop = min(wend, gend - k0)
                while kk + 1 < stop:
                    step(k0 + kk, True)
                    kk += 2
                if kk < stop:
                    step(k0 + kk, False)
                    kk += 1
                if k0 + kk == gend:
                    group_end(gend // d - 1)
                    gend += d
        assert gend == kstop + d

    if per_split is None:
        walk(0, groups)
        return acc[:m, :n].numpy()
    assert tile == "8x8"
    parts = [(g, min(groups, g + per_split))
             for g in range(0, groups, per_split)]
    for i in np.random.default_rng(seed).permutation(len(parts)):
        walk(*parts[i])
    assert int(stored.min()) >= 0                     # every group stored
    mask = (1 << shift) - 1
    for g in range(groups):                           # the scan, in order
        pl, nl = (stored[g] & mask).float(), (stored[g] >> shift).float()
        if wide:
            pl = _levels(pl, d, readout_bits)
            nl = _levels(nl, d, readout_bits)
        scan_step(slice(None), pl, nl)
    return acc[:m, :n].numpy()


def _cdiv(x, y):
    return -(-x // y)


def _tile_plan(m, n, k, acc_depth):
    """The .cu's artemis_tile_plan: (thread tile, parts, groups a part)."""
    t88 = _cdiv(m, 32) * _cdiv(n, 64)
    if t88 >= TILE_FILL_WARPS:
        return "8x8", 1, 0
    if _cdiv(m, 32) * _cdiv(n, 32) >= TILE_FILL_WARPS // 2:
        return "8x4", 1, 0
    groups = _cdiv(k, acc_depth)
    unit = 16 // math.gcd(acc_depth, 16)
    per = _cdiv(_cdiv(groups, _cdiv(TILE_FILL_WARPS, t88)), unit) * unit
    if per >= groups:
        return "8x8", 1, 0
    return "8x8", _cdiv(groups, per), per


def _scratch_bytes(m, n, k, mode, acc_depth):
    """The .cu's sc_matmul_scratch_bytes (the split's levels sized as u16
    pairs)."""
    if mode == 1:
        return 2 * m * n * 4
    if mode == 2 and m <= SPLIT_MAX_M:
        return _cdiv(k, acc_depth) * m * n * 4
    if mode == 2 and _tile_plan(m, n, k, acc_depth)[1] > 1:
        return 4 * _cdiv(k, acc_depth) * m * n
    return 0


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("readout_bits", [1, 8, 12, None])
@pytest.mark.parametrize("acc_depth", [1, 16, 20, 128])
def test_tile_walk_is_the_plain_version(acc_depth, readout_bits, tile):
    """Every thread tile, K ragged against the group and the 32-deep
    window: bit-equal to the plain version, -128 rows and columns
    included."""
    k = {1: 45, 16: 7 * 16 + 3, 20: 7 * 20 + 3, 128: 2 * 128 + 5}[acc_depth]
    a, b = _operands(acc_depth + k, 37, k, 70)
    want = sc_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                         mode="artemis", acc_depth=acc_depth,
                         readout_bits=readout_bits).numpy()
    got = _tile_emulation(a, b, acc_depth, readout_bits, tile)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("acc_depth,readout_bits",
                         [(20, 8), (20, 15), (14, 7), (3, 8), (127, 12),
                          (128, 24)])
@pytest.mark.parametrize("m", [17, 32, 33])
def test_tile_rows_and_depths_at_the_edges(m, acc_depth, readout_bits):
    """M on both sides of a 32-row tile (17 is the first M the path
    takes), odd depths whose groups straddle every window, the widest
    readout, K one group and a half: bit-equal to the plain version."""
    k = acc_depth + acc_depth // 2 + 16
    a, b = _operands(m + k, m, k, 36)
    want = sc_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                         mode="artemis", acc_depth=acc_depth,
                         readout_bits=readout_bits).numpy()
    got = _tile_emulation(a, b, acc_depth, readout_bits, "8x4")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("readout_bits", [1, 8, 12, 17, 24, None])
@pytest.mark.parametrize("acc_depth", [1, 16, 20, 128])
def test_split_walk_is_the_plain_version(acc_depth, readout_bits):
    """K split over parts of whole groups, each part's first k on a
    16-byte boundary, the parts walked in any order, the levels stored
    as bytes (the sums as 16-bit words past 8 bits and for the ideal
    readout, where a level may not fit 16 bits) and scanned in group
    order: bit-equal to the plain version, the last part ragged, -128
    rows and columns included."""
    unit = 16 // math.gcd(acc_depth, 16)
    k = {1: 45, 16: 7 * 16 + 3, 20: 11 * 20 + 3, 128: 3 * 128 + 5}[acc_depth]
    a, b = _operands(acc_depth + k + 1, 37, k, 70)
    want = sc_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                         mode="artemis", acc_depth=acc_depth,
                         readout_bits=readout_bits).numpy()
    for per, seed in ((unit, 0), (2 * unit, 1)):
        got = _tile_emulation(a, b, acc_depth, readout_bits, "8x8",
                              per_split=per, seed=seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n,want",
                         [(256, 4096, 12288, ("8x8", 1, 0)),
                          (256, 4096, 4096, ("8x4", 1, 0)),
                          (256, 12288, 4096, ("8x4", 1, 0)),
                          (256, 4096, 1024, ("8x8", 8, 28)),
                          (1024, 4096, 1024, ("8x4", 1, 0)),
                          (1024, 4096, 12288, ("8x8", 1, 0)),
                          (256, 2048, 1408, ("8x8", 6, 20)),
                          (20, 2048, 1408, ("8x8", 26, 4)),
                          (17, 16, 36, ("8x8", 1, 0))])
def test_tile_plan_at_the_serve_shapes(m, k, n, want):
    """The plan at qwen3_8b's projections (M 256 and 1024) and
    qwen2_moe's at a prefill chunk: 8 x 8 where that fills the card,
    8 x 4 where half of it does, else a split over K whose parts start
    on a 16-byte boundary and fill it; at depth 20."""
    plan = _tile_plan(m, n, k, 20)
    assert plan == want
    tile, parts, per = plan
    if parts > 1:
        groups = _cdiv(k, 20)
        assert (per * 20) % 16 == 0 and (parts - 1) * per < groups <= \
            parts * per
        assert parts * _cdiv(m, 32) * _cdiv(n, 64) >= TILE_FILL_WARPS or \
            per == 16 // math.gcd(20, 16)


@pytest.mark.parametrize("per_split", [None, 4])
@pytest.mark.parametrize("readout_bits", [1, 8, 12, None])
def test_tile_walk_matches_pallas_kernel(readout_bits, per_split):
    """The same walk, whole and split, against the Pallas kernel in
    interpret mode, at its depth of 20, within the reference's own
    tolerance (it multiplies by 1/delta and sums block by block)."""
    a, b = _operands(29, 128, 320, 128)
    got = _tile_emulation(a, b, 20, readout_bits, "8x8", per_split)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), mode="artemis",
                              readout_bits=readout_bits, bk=160,
                              interpret=True))
    np.testing.assert_allclose(got * UNIT_SCALE, want * UNIT_SCALE,
                               **PALLAS_TOL)


@pytest.mark.parametrize("m,k,n,acc_depth,readout_bits",
                         [(37, 64, 48, 20, 8), (17, 1013, 36, 20, 12),
                          (37, 1013, 48, 14, 7), (256, 4096, 1024, 20, 8),
                          (256, 100, 1024, 128, None),
                          (1024, 4096, 1024, 1, 8)])
def test_plan_above_decode_hands_over_the_table_and_the_split_scratch(
        monkeypatch, m, k, n, acc_depth, readout_bits):
    """Above decode (M > 16) the argument block carries the readout
    table of the call's depth and readout, and scratch (from the kept
    workspace) only where the plan splits K: a u16 pair for every
    output and group (levels or sums); an unsplit call's sums never
    leave the warp."""
    rec = _Recorder(sc_mod._Args)
    monkeypatch.setattr(sc_mod, "_entries", lambda: (rec, _scratch_bytes))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 4660, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    build.workspaces.clear()
    sc_mod._PLANS.clear()
    a, b = _launch_int8(0, m, k), _launch_int8(1, k, n)
    p = sc_mod._Plan(a, b, "artemis", acc_depth, readout_bits, 63.5,
                     kind="cuda")
    parts = _tile_plan(m, n + (-n) % 16, k + (-k) % 16, acc_depth)[1]
    assert m > SPLIT_MAX_M
    assert p.table is sc_mod._table(acc_depth, readout_bits,
                                    torch.device("cpu"))
    sc_mod._launch(p, a, b)
    block = rec.blocks[-1]
    assert block["table"] == p.table.data_ptr()
    assert (block["M"], block["acc_depth"]) == (m, acc_depth)
    if parts > 1:
        (scratch,) = build.workspaces.values()
        assert block["scratch"] == scratch.data_ptr()
        assert scratch.numel() * 4 >= _cdiv(k, acc_depth) * m * block["N"] * 4
    else:
        assert block["scratch"] is None and not build.workspaces
    build.workspaces.clear()
    sc_mod._PLANS.clear()


def test_tile_constants_are_the_kernels():
    """The window, the split at M 16, the thread tiles and the lane
    arithmetic the emulation above runs are the CUDA source's."""
    src = sc_mod.SOURCE.read_text()
    for needle in (f"constexpr int kTileWK = {TILE_WK};",
                   f"constexpr int kArtSplitMaxM = {SPLIT_MAX_M};",
                   "8388608.0f",
                   "__byte_perm(w, 0x4B000000u, h ? 0x7432 : 0x7410)",
                   "__byte_perm(mag, 0u, 0x4440 + b) << 1",
                   "__byte_perm(s, 0u, 0x1111 * b)",
                   "(x[q] ^ s) + (s & 0x01010101u)",
                   "return s_table[h ? w >> 16 : w & 0xFFFFu];",
                   "plan.shape == 84 && kRead == kReadTable && depth < "
                   "kMaxAccDepth",
                   "kRead == kReadTable4 ? 4u : 1u",
                   "kRead == kReadTable4 ? neg[i][j] << 2 : neg[i][j]",
                   f"constexpr int kTileFillWarps = {TILE_FILL_WARPS};",
                   "unit = 16 / std::gcd(depth, 16)",
                   "kRead == kReadIdeal || wide ? ps | ns << 16",
                   ": s_levels[ps] | s_levels[ns] << 8;",
                   "readout_bits > 8",
                   "__byte_perm(v, 0x4B000000u, 0x7440)",
                   "__byte_perm(v, 0x4B000000u, 0x7441)",
                   "return launch_artemis_scan(reinterpret_cast<const "
                   "uint32_t*>(levels),",
                   "return plan.splits > 1 ? 4LL * cdiv(K, depth) * M * N : 0;",
                   *(f"launch_artemis_tile<{r}, {c}, kRead, false>"
                     for r, c in TILES.values()),
                   "launch_artemis_tile<8, 8, kRead, true>"):
        assert needle in src, needle
