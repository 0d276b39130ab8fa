"""The pruned walk of the `minplus_1d` kernel (fgoicp_tpu_torch/csrc/
minplus.cu): a float32 numpy mirror of it, kept here, against the plain
version `minplus_1d_plain`, bit for bit.

The mirror walks as the kernel does (ops/cuda_minplus.py's layout): blocks
of TILE_LINES lines, warps of WARP_LINES, output tiles of TILE_OUT with
OUTS_PER_THREAD outputs a thread, chunks of CHUNK j.  Each minimum starts at its j = i candidate;
the chunks are visited from the tile's diagonal outward; a thread skips a
chunk for a line when fl(gmin + cost(dmin)) >= the max of its running
minima, gmin the line's minimum over the chunk and dmin the least |i - j|
between its outputs and the chunk.  A warp (one line's tile) evaluates the
chunk when any of its threads needs it, and the counts are the kernel's
counters: triples evaluated (TILE_OUT x CHUNK per warp, line and chunk,
plus one per output) and (warp, chunk) pairs staged.  Skipping only what
cannot win, the mirror must equal the plain version bit for bit.
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.ops import cuda_minplus
from fgoicp_tpu_torch.ops import distance_field as tdf

TL, WL, TO, OPT, CH = (cuda_minplus.TILE_LINES, cuda_minplus.WARP_LINES,
                       cuda_minplus.TILE_OUT, cuda_minplus.OUTS_PER_THREAD,
                       cuda_minplus.CHUNK)
THREADS = TO // OPT  # threads across a tile: one warp


def _chunk_order(c0, n_chunks):
    """The kernel's chunk order for the tile starting at chunk c0."""
    diag = list(range(c0, min(c0 + TO // CH, n_chunks)))
    rings = []
    for r in range(1, max(c0, n_chunks - c0 - TO // CH) + 1):
        rings += [c for c in (c0 - r, c0 + TO // CH - 1 + r)
                  if 0 <= c < n_chunks]
    return diag + rings


def pruned_minplus_mirror(g, res):
    """(out [L, n] float32, triples evaluated, chunks staged) of the
    kernel's walk over g [L, n] float32."""
    lines, n = g.shape
    inf = np.float32(np.inf)
    n_chunks = -(-n // CH)
    tiles = -(-n // TO)
    lp = -(-lines // TL) * TL
    width = max(n_chunks * CH, tiles * TO)
    gp = np.full((lp, width), inf, np.float32)
    gp[:lines, :n] = g
    gmin = gp[:, :n_chunks * CH].reshape(lp, n_chunks, CH).min(-1)
    res32 = np.float32(res)

    def cost(d):
        c = np.asarray(d, np.float32) * res32
        return c * c

    out = np.empty((lines, n), np.float32)
    triples, staged = lines * n, 0
    line_ok = (np.arange(lp) < lines)[:, None]
    for t in range(tiles):
        i = t * TO + np.arange(TO)
        ia = t * TO + OPT * np.arange(THREADS)
        acc = np.where(line_ok & (i < n), gp[:, i] + cost(0), -inf)
        acc = acc.reshape(lp, THREADS, OPT)
        for c in _chunk_order(t * TO // CH, n_chunks):
            j0 = c * CH
            d_lo, d_hi = ia - (j0 + CH - 1), ia + OPT - 1 - j0
            cmin = cost(np.where(d_lo > 0, d_lo, np.where(d_hi < 0, d_hi, 0)))
            need = gmin[:, c][:, None] + cmin[None, :] < acc.max(-1)
            staged += int(need.reshape(lp // WL, -1).any(-1).sum())
            rows = np.flatnonzero(need.any(-1))
            if rows.size == 0:
                continue
            triples += TO * CH * rows.size
            j = j0 + np.arange(CH)
            cand = np.min(gp[rows][:, None, j0:j0 + CH]
                          + cost(i[:, None] - j[None, :])[None], axis=-1)
            acc[rows] = np.minimum(acc[rows], cand.reshape(-1, THREADS, OPT))
        keep = i < n
        out[:, i[keep]] = acc.reshape(lp, TO)[:lines, keep]
    return out, triples, staged


def _plain(g, res):
    return cuda_minplus.minplus_1d_plain(torch.from_numpy(g), res).numpy()


def _lines(kind, n, lines=70, seed=0):
    rng = np.random.default_rng(seed + n)
    big = np.float32(tdf.BIG)
    if kind == "random":
        return rng.uniform(0.0, 4.0, size=(lines, n)).astype(np.float32)
    if kind == "all_big":
        return np.full((lines, n), big, np.float32)
    if kind == "constant":
        return np.repeat(rng.uniform(0.0, 4.0, size=(lines, 1)), n,
                         axis=1).astype(np.float32)
    if kind == "negative":
        return rng.uniform(-4.0, 0.5, size=(lines, n)).astype(np.float32)
    if kind == "equal_values":
        # Few distinct values: ties between j inside and across chunks.
        return rng.choice(np.float32([0.0, 0.25, 1.0]), size=(lines, n))
    g = rng.uniform(0.0, 4.0, size=(lines, n)).astype(np.float32)
    g[::3] = big  # every third line unseeded, as chip_smoke.py draws them
    return g


@pytest.mark.parametrize("kind", ["random", "all_big", "constant",
                                  "negative", "equal_values", "third_big"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 129, 348])
def test_pruned_walk_equals_plain(n, kind):
    g = _lines(kind, n)
    res = 0.07
    out, triples, staged = pruned_minplus_mirror(g, res)
    np.testing.assert_array_equal(out, _plain(g, res))
    if kind in ("all_big", "constant"):
        # Each minimum starts at its own value, which nothing beats.
        assert triples == g.size and staged == 0


def _curve(n=300, seed=4):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 4.5, size=n)
    return np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                     0.1 * np.sin(3.0 * s + 0.5)], 1).astype(np.float32)


def test_pruned_walk_equals_plain_on_the_edt_passes():
    """The three passes of `distance_field._build_edt` on the seeded grid of
    a small curve (201 x 141 x 21 nodes): each pass bit-equal to the plain
    version on the same input, fewer triples than L n^2 over the three."""
    pts = _curve()
    bounds = np.stack([pts.min(0), pts.max(0)], axis=-1)
    res = 0.01
    dims = tdf.grid_dims(bounds, res)
    x, y, z = dims
    assert min(dims) >= 16 and max(dims) > TO
    f = tdf._seed_grid(torch.from_numpy(pts),
                       torch.tensor(bounds[:, 0], dtype=torch.float32),
                       torch.tensor(res), dims).numpy()
    evaluated = full = 0
    for lines, n, perm in (((x * y), z, (x, y, z)), ((z * x), y, (z, x, y)),
                           ((y * z), x, (y, z, x))):
        g = np.ascontiguousarray(f.reshape(lines, n))
        out, triples, _ = pruned_minplus_mirror(g, res)
        np.testing.assert_array_equal(out, _plain(g, res))
        evaluated += triples
        full += lines * n * n
        f = np.ascontiguousarray(out.reshape(perm).transpose(2, 0, 1))
    assert evaluated < full
