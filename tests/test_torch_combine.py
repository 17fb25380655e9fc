"""The merge kernel (``csrc/combine_update.cu``) on the CPU: the port's
``fused_combine_update`` (its plain version here) held bit for bit against
the reference's in interpret mode at odd row widths, and the kernel's index
walk emulated in numpy from the constants of its source (the cut of each
moving row into head, 16-byte body units in tiles and tail; the map of
blocks onto moving rows; the funnelled recv vectors and their neighbours), which shows every
element of every moving row written once from its own column and no KEEP
row touched, at every row offset mod 16 (the CUDA kernel itself runs in
``test_torch_kernels_gpu.py``)."""
from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.combine_update import fused_combine_update as j_fused_combine_update
from repro_torch.kernels import combine_update as cu
from repro_torch.models.convert import to_tensor

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

SOURCE = Path(cu.__file__).parent / "csrc" / "combine_update.cu"


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("combine", [0, 1])
@pytest.mark.parametrize("C,starts", [(1, (0, 1, 4, 2)), (7, (3, 4, 1, 0)),
                                      (131, (2, 0, 4, 1)), (1029, (4, 3, 2, 1))])
def test_odd_widths_match_reference_bit_for_bit(C, starts, combine, dt):
    """Rank-stacked (4, 7, C) at odd C with starts above 0: the port's
    round is bit-equal to the reference's Pallas ``fused_combine_update``
    run in interpret mode, rank by rank; KEEP rows keep -0.0 and NaN."""
    n, K, B = 4, 7, 3
    rng = np.random.RandomState(C + 10 * combine)
    buf = np.array(jnp.asarray(rng.randn(n, K, C) * 20, jnp.dtype(dt)))
    recv = np.array(jnp.asarray(rng.randn(n, B, C) * 20, jnp.dtype(dt)))
    start = np.array(starts, np.int32)
    lo = np.array([0, 1, 2, 1], np.int32)
    hi = np.array([3, 2, 3, 1], np.int32)  # 3, 1, 1 and 0 moving rows
    raw = buf.view(np.int16 if dt == "bfloat16" else np.int32)
    for r in range(n):
        kept = np.ones(K, bool)
        kept[start[r] + lo[r]:start[r] + hi[r]] = False
        buf[r, kept, 0] = -0.0
        # a quiet NaN in bf16, whose payload XLA's CPU select keeps
        raw[r, kept, C // 2] = 0x7FC0 if dt == "bfloat16" else 0x7FC01234

    out = cu.fused_combine_update(to_tensor(buf), to_tensor(recv), torch.from_numpy(start),
                                  torch.from_numpy(lo), torch.from_numpy(hi), combine)
    step = jax.jit(lambda b, r, s, l, h: j_fused_combine_update(
        b, r, s, l, h, combine=combine, interpret=True))
    for r in range(n):
        want = step(jnp.asarray(buf[r]), jnp.asarray(recv[r]), jnp.int32(start[r]),
                    jnp.int32(lo[r]), jnp.int32(hi[r]))
        np.testing.assert_array_equal(_bits(out[r]), _bits(want), err_msg=f"rank {r}")


# --- the kernel's index walk, emulated ---


def _constant(name: str) -> int:
    m = re.search(rf"constexpr \w+(?: \w+)? {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


THREADS, UNROLL = _constant("kThreads"), _constant("kUnroll")
TILE = THREADS * UNROLL  # kTile: 16-byte units a tile


def _row_tiles(C: int, es: int) -> int:
    """The entry point's cut: one tile a 32 KiB of the widest body (an
    aligned destination's ``C * es // 16`` units), at least one."""
    units = C * es // 16
    return (units + TILE - 1) // TILE if units > TILE else 1


def test_tile_constants_match_the_source():
    """A tile is kThreads x kUnroll 16-byte units, 32 KiB, and the entry
    point cuts rows and sizes the grid (one block a tile of every row) as
    :func:`_row_tiles` does."""
    src = SOURCE.read_text()
    assert (THREADS, UNROLL) == (256, 8) and TILE * 16 == 32 * 1024
    assert "kTile = kThreads * kUnroll" in src
    assert "tiles = units > kTile ? (units + kTile - 1) / kTile : 1;" in src
    assert "grid = tiles * n * B;" in src


def _locate(m, n, B, K, start, lo, hi):
    """locate() of the kernel: moving row m (rank r's rows lo[r]..hi[r]-1,
    clipped to the block, numbered rank by rank) -> (buf row, recv row),
    or None past the last."""
    for r in range(n):
        a = max(lo[r], 0)
        cnt = max(min(hi[r], B) - a, 0)
        if m < cnt:
            return r * K + start[r] + a + m, r * B + a + m
        m -= cnt
    return None


def _merge_tile(dst, src, writes, d_addr, s_addr, C, es, tile, tiles):
    """merge_tile() of the kernel for an overwrite, on byte arrays, every
    thread of the block at once: ``dst`` and ``src`` are the row's bytes,
    ``d_addr``/``s_addr`` the rows' addresses mod 16 (the cut and the
    funnel depend on nothing else)."""
    V = 16 // es
    head = min(((16 - d_addr % 16) % 16) // es, C)
    units = (C - head) // V
    tail = C - head - units * V
    tid = np.arange(THREADS)
    cols = list(tid[tid < head]) if tile == 0 else []
    if tile == tiles - 1:
        cols += list(head + units * V + tid[tid < tail])
    for c in cols:
        dst[c * es:(c + 1) * es] = src[c * es:(c + 1) * es]
        writes[c] += 1
    base = tile * THREADS * UNROLL
    if base >= units:
        return
    # aligned source vectors, as the kernel loads them: vector k starts
    # `off` bytes before the body's first source byte, plus 16 k; bytes past
    # the row read as the next row's (here: 0xEE), which lie in the same
    # aligned 16 bytes; a vector past `avail` is not loaded (zero)
    off = (s_addr + head * es) % 16
    avail = units + (off != 0)
    vecs = np.full((avail + 1, 16), 0xEE, np.uint8).reshape(-1)
    body = src[head * es:]
    vecs[off:off + len(body)] = body
    vecs = vecs.reshape(-1, 16)
    vecs[avail] = 0
    lane = tid & 31
    j0 = base + (tid >> 5) * 32 * UNROLL + lane
    u = np.arange(UNROLL)[:, None]
    j = j0 + 32 * u  # (UNROLL, THREADS)
    # next: lane + 1's vector of this span (shfl_down), lane 0's of the next
    # span (shfl from lane 0), or, after the last span, lane 31's own load
    nxt = np.where(lane < 31, j + 1,
                   np.where(u + 1 < UNROLL, j0 - lane + 32 * (u + 1), j0 + 32 * UNROLL - lane))
    live = j < units
    j, nxt = j[live], np.minimum(nxt[live], avail)
    both = np.concatenate([vecs[np.minimum(j, avail)], vecs[nxt]], axis=1)
    out = both[:, off:off + 16]  # funnel(a, next, off / 4, off % 4)
    rows = dst[head * es:head * es + 16 * units].reshape(units, 16)
    rows[j] = out
    np.add.at(writes, (head + V * j[:, None] + np.arange(V)).reshape(-1), 1)


def _emulate(n, K, B, C, es, start, lo, hi, d_base, s_base):
    """merge_rows() over the whole grid for an overwrite round: returns the
    destination bytes (n, K, C * es), the source bytes, and per-element
    write counts."""
    rng = np.random.RandomState(C + d_base)
    src = rng.randint(0, 256, (n * B, C * es)).astype(np.uint8)
    dst = np.zeros((n * K, C * es), np.uint8)
    writes = np.zeros((n * K, C), np.int64)
    tiles = _row_tiles(C, es)
    rows = n * B
    for b in range(tiles * rows):  # one block a tile of every row
        m, tile = b % rows, b // rows
        where = _locate(m, n, B, K, start, lo, hi)
        if where is None:
            continue  # past the moving rows: the block exits
        row, q = where
        _merge_tile(dst[row], src[q], writes[row], d_base + row * C * es,
                    s_base + q * C * es, C, es, tile, tiles)
    return dst, src, writes


def _check_walk(n, K, B, C, es, start, lo, hi, d_base, s_base):
    dst, src, writes = _emulate(n, K, B, C, es, start, lo, hi, d_base, s_base)
    moving = np.zeros(n * K, bool)
    for r in range(n):
        for i in range(max(lo[r], 0), min(hi[r], B)):
            row = r * K + start[r] + i
            moving[row] = True
            np.testing.assert_array_equal(dst[row], src[r * B + i], err_msg=f"row {row}")
    assert (writes[moving] == 1).all(), "a moving element not written exactly once"
    assert (writes[~moving] == 0).all() and (dst[~moving] == 0).all(), "a KEEP row touched"


# 1, 2 and 3 moving rows of 4 (one a rank, recv rows (4, 1, C)), the
# training plans' classes of block 1
ROUNDS = [((0, 1, 0, 0), (1, 1, 1, 1)), ((0, 1, 1, 0), (2, 1, 0, 1)),
          ((0, 1, 1, 1), (1, 2, 3, 1))]


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("hi,start", ROUNDS)
def test_walk_writes_each_moving_element_once_at_every_offset(hi, start, es):
    """At every destination and recv base offset mod 16 that the dtype
    allows, with an odd width whose rows cross 16-byte boundaries at every
    offset and a body of two full tiles and a partial one, the emulated
    grid (one block a tile of every row) merges every element of the 1-3
    moving rows once, from its own column, and touches no KEEP row."""
    n, K, B = 4, 5, 1
    C = 2 * TILE * 16 // es + 37
    for d_base in range(0, 16, es):
        for s_base in range(0, 16, es):
            _check_walk(n, K, B, C, es, start, (0,) * n, hi, d_base, s_base)


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("C", [1, 3, 7, 9, 1029])
def test_walk_at_head_and_tail_only_widths(C, es):
    """Rows of fewer bytes than a vector, or a few vectors, at every
    destination x recv offset pair: head, body and tail meet once."""
    start, lo, hi = (1, 0, 2, 1), (0, 1, 0, 2), (2, 2, 1, 2)
    for d_base in range(0, 16, es):
        for s_base in range(0, 16, es):
            _check_walk(4, 5, 2, C, es, start, lo, hi, d_base, s_base)


@pytest.mark.parametrize("B,hi", [(1, (1, 1, 0, 1)), (3, (3, 1, 0, 2))])
def test_walk_over_ranks_of_several_rows(B, hi):
    """Ranks of several block rows (recv (4, B, C)): the moving rows of
    each rank land at start + lo.. of its window, each element once."""
    C = TILE * 4 + 5
    _check_walk(4, 6, B, C, 4, (1, 2, 3, 0), (0, 1, 0, 0), hi, 4, 8)


def test_row_tiles_counts_the_widest_body():
    """One tile a 32 KiB of the widest body, at least one; the training
    and serving rounds' widths."""
    assert _row_tiles(1, 4) == 1 and _row_tiles(4 * TILE, 4) == 1
    assert _row_tiles(4 * TILE + 4, 4) == 2
    assert _row_tiles(4 * TILE + 3, 4) == 1  # 3 more floats: a tail
    assert _row_tiles(23_301_689, 4) == 2845
    assert _row_tiles(32_768_000, 2) == 2000
    assert _row_tiles(49_932_191, 2) == 3048


@pytest.mark.parametrize("n", [4, 9])
def test_locate_numbers_the_rows_the_plain_version_merges(n):
    """The kernel's moving rows are exactly the rows the plain version
    merges (block rows i with lo <= i < hi, 0 <= i < B, for any lo and
    hi), in rank order, and nothing past them."""
    rng = np.random.RandomState(n)
    B, K = 3, 7
    lo = rng.randint(-1, B + 1, n)
    hi = rng.randint(-1, B + 2, n)
    start = rng.randint(0, K - B + 1, n)
    want = [(r * K + start[r] + i, r * B + i)
            for r in range(n) for i in range(B) if lo[r] <= i < hi[r]]
    got = [_locate(m, n, B, K, start, lo, hi) for m in range(len(want) + 2)]
    assert got == want + [None, None]
