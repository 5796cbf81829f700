"""The backward kernels' walk (``csrc/grid_sample_bwd.cu``) emulated in
PyTorch on the CPU, its constants read from the source.

The emulation follows the kernel: a block of kWarps warps takes a tile of
kWarps rows by kRun pixels, a warp the run of one row, lane l the pixels
l + 32 k; the vector path's coords (float4s and shuffles), g (float4s,
through the warp's buffer for C = 1, 3) and d_coords (float4s of two
pixels regrouped by shuffle), and the scalar path (a row's ragged end, a
misaligned run, other C); for a non-empty ``grad_ch``, each lane's
in-image taps added to d_img one reduction each. It shows that every
output pixel's d_coords is written once and is bit-equal (``torch.equal``)
to ``grid_sample_bwd_plain``'s, that every in-image tap with a non-zero
product reaches d_img exactly once, and that d_img is within 1e-6 of the
plain version (the same f32 products, summed in another order). It also
holds ``chip_smoke.bwd_tile_boxes`` (the spread of the taps that the card
run prints for the d_img launches) against a loop.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm_torch.ops import grid_sample as gs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H = 2, 11
CASES = ["identity", "smooth", "pushed", "edge", "scattered"]


def _kernel_constants() -> dict:
    """The walk's integer constants in csrc/grid_sample_bwd.cu, by name."""
    src = (gs._build.CSRC / "grid_sample_bwd.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _identity_coords(b, h, w):
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    g = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    return np.broadcast_to(g, (b, h, w, 2)).astype(np.float64).copy()


def _coords(case, b, h, w, seed):
    rng = np.random.RandomState(seed)
    c = _identity_coords(b, h, w)
    px = np.array([2.0 / w, 2.0 / h])
    if case == "smooth":            # a warp of up to ~2 px, off-integer
        c += rng.uniform(-2.0, 2.0, (b, 1, 1, 2)) * px
        c += rng.uniform(-0.5, 0.5, (b, h, w, 2)) * px
    elif case == "pushed":          # whole tiles and single pixels at 2.0
        c += rng.uniform(-0.5, 0.5, (b, h, w, 2)) * px
        c[0, :8] = 2.0
        c[rng.rand(b, h, w) < 0.1] = 2.0
    elif case == "edge":            # taps straddling every border
        c += np.array([0.6, -0.6]) * px
        c[:, :, :2, 0] = -1.0 - 0.4 * px[0]
        c[:, -2:, :, 1] = 1.0 + 0.4 * px[1]
    elif case == "scattered":       # anywhere in [-1.2, 1.2]^2
        c = rng.uniform(-1.2, 1.2, (b, h, w, 2))
        c[rng.rand(b, h, w) < 0.05] = 2.0
    return c.astype(np.float32)


def _floats4(f4: torch.Tensor) -> torch.Tensor:
    """The float indices of the float4s ``f4``, lane by lane."""
    return (4 * f4[:, None] + torch.arange(4)).reshape(-1)


def _taps(coords: torch.Tensor, h: int, w: int):
    """Each pixel's taps as bilinear.cuh forms them: (in-image, column,
    row, weight) of taps 00, 10, 01, 11 (columns and rows of outside taps
    are not used)."""
    x = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    vx = [(x0 >= 0) & (x0 <= w - 1), (x0 + 1 >= 0) & (x0 + 1 <= w - 1)]
    vy = [(y0 >= 0) & (y0 <= h - 1), (y0 + 1 >= 0) & (y0 + 1 <= h - 1)]
    col = [x0.nan_to_num().clamp(-2, w + 1).long(),
           (x0 + 1).nan_to_num().clamp(-2, w + 1).long()]
    row = [y0.nan_to_num().clamp(-2, h + 1).long(),
           (y0 + 1).nan_to_num().clamp(-2, h + 1).long()]
    wx, wy = [wx0, wx1], [wy0, wy1]
    return [(vx[i] & vy[j], col[i], row[j], wx[i] * wy[j])
            for i, j in ((0, 0), (1, 0), (0, 1), (1, 1))]


def _emulate_bwd(img, coords, g, grad_ch, coords_offset=0, g_offset=0):
    """The backward kernels' walk. Returns d_coords, d_img (None for an
    empty ``grad_ch``) and the number of runs on the vector path; asserts
    that every d_coords float is written once and every in-image tap with a
    non-zero product reaches d_img once."""
    k = _kernel_constants()
    warps, run = k["kWarps"], 32 * k["kLanePixels"]
    b, h, w, c = img.shape
    cg = len(grad_ch)
    lanes = torch.arange(32)
    slots = [32 * j + lanes for j in range(k["kLanePixels"])]
    cflat = torch.cat([torch.zeros(coords_offset), coords.reshape(-1)])
    gflat = torch.cat([torch.zeros(g_offset), g.reshape(-1)])
    read_xy = torch.full((b * h * w, 2), float("nan"))
    read_g = torch.full((b * h * w, c), float("nan"))
    runs = []
    for bz, by, bx, warp in np.ndindex(b, math.ceil(h / warps),
                                       math.ceil(w / run), warps):
        row, x0 = by * warps + warp, bx * run
        if row >= h:
            continue
        n = min(run, w - x0)
        px0 = (bz * h + row) * w + x0
        c0, g0 = coords_offset + 2 * px0, g_offset + px0 * c
        vec = (c in (1, 3, 4) and n == run and c0 % 4 == 0 and g0 % 4 == 0
               and (2 * px0) % 4 == 0)
        if vec:
            # coords: float4 32 j + l in lane l, pixel 32 k + l's by shuffle
            c4 = [cflat[c0 + _floats4(32 * j + lanes)].view(32, 4)
                  for j in range(k["kLanePixels"] // 2)]
            for j, p in enumerate(slots):
                q = c4[j // 2][(16 * j + lanes // 2) % 32]
                read_xy[px0 + p] = torch.where((lanes % 2 == 1)[:, None],
                                               q[:, 2:], q[:, :2])
            if c == 4:      # a pixel's g is one float4
                for p in slots:
                    read_g[px0 + p] = gflat[g0 + _floats4(p)].view(32, 4)
            else:           # the run's float4s through the warp's buffer
                n4 = run * c // 4
                buf = torch.full((run * c,), float("nan"))
                for j in range(-(-n4 // 32)):
                    f4 = 32 * j + lanes
                    f4 = f4[f4 < n4]
                    buf[_floats4(f4)] = gflat[g0 + _floats4(f4)]
                for p in slots:
                    read_g[px0 + p] = buf[(p[:, None] * c + torch.arange(c))
                                          .reshape(-1)].view(32, c)
        else:
            for p in slots:
                p = p[p < n]
                read_xy[px0 + p, 0] = cflat[c0 + 2 * p]
                read_xy[px0 + p, 1] = cflat[c0 + 2 * p + 1]
                read_g[px0 + p] = gflat[g0 + (p[:, None] * c + torch.arange(
                    c)).reshape(-1)].view(-1, c)
        runs.append((bz, by, bx, px0, n, vec))

    # each lane's d_coords from what it read, in the plain arithmetic
    dc, _ = gs.grid_sample_bwd_plain(img, read_xy.view(b, h, w, 2),
                                     read_g.view(b, h, w, c), ())
    dc = dc.reshape(-1, 2)
    d_coords = torch.full((b * h * w * 2,), float("nan"))
    writes = torch.zeros(b * h * w * 2, dtype=torch.int64)
    upper = lanes >= 16
    for *_, px0, n, vec in runs:
        if vec:
            s = (2 * lanes) % 32
            for j in range(k["kLanePixels"] // 2):
                slot = 2 * j + upper.long()
                first, second = 32 * slot + s, 32 * slot + s + 1
                vals = torch.cat([dc[px0 + first], dc[px0 + second]], 1)
                f = _floats4(px0 // 2 + 32 * j + lanes)
                d_coords[f] = vals.reshape(-1)
                writes[f] += 1
        else:
            for p in slots:
                p = p[p < n]
                f = (2 * (px0 + p)[:, None] + torch.arange(2)).reshape(-1)
                d_coords[f] = dc[px0 + p].reshape(-1)
                writes[f] += 1
    assert bool((writes == 1).all())
    d_coords = d_coords.view(b, h, w, 2)

    vec_runs = sum(r[-1] for r in runs)
    if not grad_ch:
        return d_coords, None, vec_runs
    # d_img: each lane's in-image taps with a non-zero product, one global
    # reduction each
    d_img = torch.zeros(b * h * w * cg)
    hits = torch.zeros(b * h * w, 4, cg, dtype=torch.int64)
    taps = _taps(read_xy, h, w)
    for bz, by, bx, px0, n, vec in runs:
        p = px0 + torch.arange(n)
        image = bz * h * w
        for t, (inb, col, row, wt) in enumerate(taps):
            for kk, ch in enumerate(grad_ch):
                v = read_g[p, ch] * wt[p]
                on = inb[p] & (v != 0)
                q, v = p[on], v[on]
                hits[q, t, kk] += 1
                d_img.index_add_(
                    0, (image + row[q] * w + col[q]) * cg + kk, v)
    # every in-image tap with a non-zero product, exactly once
    expected = torch.zeros_like(hits)
    for t, (inb, _, _, wt) in enumerate(taps):
        for kk, ch in enumerate(grad_ch):
            expected[:, t, kk] = (inb & (read_g[:, ch] * wt != 0)).long()
    assert torch.equal(hits, expected)
    return d_coords, d_img.view(b, h, w, cg), vec_runs


def _inputs(case, c, w, seed, h=H):
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.rand(B, h, w, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, h, w, c).astype(np.float32))
    coords = torch.from_numpy(_coords(case, B, h, w, seed))
    return img, coords, g


def _check_against_plain(img, coords, g, grad_ch, **offsets):
    d_coords, d_img, vec_runs = _emulate_bwd(img, coords, g, grad_ch,
                                             **offsets)
    ref_coords, ref_img = gs.grid_sample_bwd_plain(img, coords, g, grad_ch)
    assert torch.equal(d_coords, ref_coords)
    if grad_ch:
        assert (d_img - ref_img).abs().max().item() <= 1e-6
    return vec_runs


@pytest.mark.parametrize("grad_ch", [(), (3,), (0, 1, 2, 3)])
@pytest.mark.parametrize("c", [3, 4, 7])
@pytest.mark.parametrize("w", [45, 63, 64, 65, 128])
def test_bwd_walk_is_bit_equal_to_plain(w, c, grad_ch):
    """B = 2, H = 11 (not a multiple of a tile's rows); rows whose runs end
    ragged, or do not fall on 16 bytes (odd W; the smooth case again with
    coords and g one float into their storage); C with and without a
    vector path; every coords case. A ``grad_ch`` naming channel 3 takes
    the last channel when C = 3."""
    grad_ch = tuple(sorted({min(k, c - 1) for k in grad_ch}))
    run = 32 * _kernel_constants()["kLanePixels"]
    for i, case in enumerate(CASES):
        img, coords, g = _inputs(case, c, w, seed=100 * w + 10 * c + i)
        vec_runs = _check_against_plain(img, coords, g, grad_ch)
        assert (vec_runs > 0) == (w >= run and c in (3, 4))
    img, coords, g = _inputs("smooth", c, w, seed=w + c)
    assert _check_against_plain(img, coords, g, grad_ch, coords_offset=1,
                                g_offset=1) == 0


def _boxes_by_loop(coords, cg, tile):
    """``chip_smoke.bwd_tile_boxes`` tile by tile, pixel by pixel."""
    b, h, w, _ = coords.shape
    rows, run = tile
    taps = _taps(coords.reshape(-1, 2), h, w)
    out = []
    for bz, by, bx in np.ndindex(b, math.ceil(h / rows), math.ceil(w / run)):
        cols, rws = [], []
        for y, x in np.ndindex(rows, run):
            y, x = by * rows + y, bx * run + x
            if y >= h or x >= w:
                continue
            i = (bz * h + y) * w + x
            for inb, col, row, _ in taps:
                if inb[i]:
                    cols.append(int(col[i]))
                    rws.append(int(row[i]))
        if not cols:
            out.append(0)
            continue
        span = -(-(max(cols) + 1) * cg // 4) * 4 - min(cols) * cg // 4 * 4
        out.append(span * (max(rws) - min(rws) + 1))
    return out


@pytest.mark.parametrize("tile", list(chip_smoke.BWD_TAP_BOXES))
@pytest.mark.parametrize("case", ["smooth", "pushed", "scattered"])
def test_tap_boxes_match_a_loop(case, tile):
    """The taps' spread that chip_smoke.py prints for the d_img launches
    (``bwd_tile_boxes``), against a loop over each tile's taps: H = 19, W =
    100 (tiles cut short on both edges), Cg = 1 and 3."""
    coords = torch.from_numpy(_coords(case, B, 19, 100, seed=3))
    for cg in (1, 3):
        got = chip_smoke.bwd_tile_boxes(torch, coords, cg, tile)
        assert got.long().tolist() == _boxes_by_loop(coords, cg, tile)
