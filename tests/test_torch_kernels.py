"""The port's kernels (plain versions on the CPU) held bit for bit against
the reference's oracles and its Pallas kernels run in interpret mode (the
CUDA kernels against their plain versions: ``test_torch_kernels_gpu.py``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.combine_update import fused_combine_update as j_fused_combine_update
from repro_torch.kernels import _build
from repro_torch.kernels import chunked_copy as cc
from repro_torch.kernels import combine_update as cu
from repro_torch.kernels.chunked_copy import chunked_copy
from repro_torch.models.convert import to_tensor

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]


def _bits(a) -> np.ndarray:
    """Raw bit pattern of a jax/numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.view({2: torch.int16, 4: torch.int32, 1: torch.int8}[a.element_size()])
        return a.numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 1: np.int8}[a.dtype.itemsize])


def _with_special_keep_rows(cur: np.ndarray, modes: np.ndarray, dt: str) -> np.ndarray:
    """-0.0, a quiet NaN and a NaN with a payload in every KEEP row."""
    cur = np.array(jnp.asarray(cur, jnp.dtype(dt)))
    raw = cur.view(np.int16 if dt == "bfloat16" else np.int32)
    for r in np.flatnonzero(modes == cu.KEEP):
        cur[r, 0] = -0.0
        cur[r, 1] = np.nan
        raw[r, 2] = 0x7FC3 if dt == "bfloat16" else 0x7FC01234
    return cur


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", [(8, 300), (5, 2065), (1, 3), (12, 128)])
def test_fused_combine_matches_reference(shape, dt):
    rng = np.random.RandomState(sum(shape))
    B, C = shape
    modes = rng.randint(0, 3, size=B).astype(np.int32)
    modes[0] = cu.KEEP
    cur = _with_special_keep_rows(rng.randn(B, C) * 50, modes, dt)
    recv = np.array(jnp.asarray(rng.randn(B, C) * 50, jnp.dtype(dt)))
    mode = modes.reshape(B, 1)

    t_cur = to_tensor(cur)
    out = cu.fused_combine(t_cur, to_tensor(recv), torch.from_numpy(mode))
    assert out is t_cur  # in place, like the reference's aliased output
    want_ref = jref.fused_combine_ref(jnp.asarray(cur), jnp.asarray(recv), jnp.asarray(mode))
    want_pallas = jops.fused_combine(jnp.asarray(cur), jnp.asarray(recv), jnp.asarray(mode),
                                     interpret=True)
    keep = modes == cu.KEEP
    got, ref_bits, pallas_bits = _bits(out), _bits(want_ref), _bits(want_pallas)
    if dt == "bfloat16":
        # XLA's CPU bf16 select quiets the NaN payload of column 2; the port
        # keeps it, which the KEEP-row check below holds it to
        got, ref_bits, pallas_bits = (np.delete(a, 2, axis=1) for a in (got, ref_bits, pallas_bits))
    np.testing.assert_array_equal(got, ref_bits)
    np.testing.assert_array_equal(got, pallas_bits)
    np.testing.assert_array_equal(_bits(out)[keep], _bits(cur)[keep])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("combine", [0, 1])
@pytest.mark.parametrize("n,K,B,C", [(3, 6, 2, 130), (4, 9, 4, 33), (2, 1, 1, 7)])
def test_fused_combine_update_matches_reference(n, K, B, C, combine, dt):
    rng = np.random.RandomState(n * 100 + K + combine)
    buf = np.array(jnp.asarray(rng.randn(n, K, C) * 20, jnp.dtype(dt)))
    recv = np.array(jnp.asarray(rng.randn(n, B, C) * 20, jnp.dtype(dt)))
    start = rng.randint(0, K - B + 1, size=n).astype(np.int32)
    lo = rng.randint(0, B + 1, size=n).astype(np.int32)
    hi = np.array([rng.randint(l, B + 1) for l in lo], np.int32)
    # -0.0 everywhere; outside the merge windows also a NaN (with a payload
    # in f32; bf16 gets the quiet NaN, whose payload XLA's CPU select keeps)
    buf[:, :, 0] = -0.0
    buf_raw = buf.view(np.int16 if dt == "bfloat16" else np.int32)
    for r in range(n):
        kept = np.ones(K, bool)
        kept[start[r] + lo[r]:start[r] + hi[r]] = False
        buf_raw[r, kept, 1] = 0x7FC0 if dt == "bfloat16" else 0x7FC01234

    out = cu.fused_combine_update(to_tensor(buf), to_tensor(recv), torch.from_numpy(start),
                                  torch.from_numpy(lo), torch.from_numpy(hi), combine)
    step = jax.jit(lambda b, r, s, l, h: j_fused_combine_update(
        b, r, s, l, h, combine=combine, interpret=True))
    for r in range(n):
        want = step(jnp.asarray(buf[r]), jnp.asarray(recv[r]), jnp.int32(start[r]),
                    jnp.int32(lo[r]), jnp.int32(hi[r]))
        np.testing.assert_array_equal(_bits(out[r]), _bits(want), err_msg=f"rank {r}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("size,chunk", [(1, 128), (100, 128), (127, 128), (1000, 256),
                                        (4099, 1024), (70_001, 8192)])
def test_chunked_copy_matches_reference(size, chunk, dt):
    rng = np.random.RandomState(size)
    x = np.array(jnp.asarray(rng.randn(size) * 100, jnp.dtype(dt)))
    got = chunked_copy(to_tensor(x), chunk_elems=chunk)
    np.testing.assert_array_equal(_bits(got), _bits(jref.chunked_copy_ref(jnp.asarray(x))))
    pallas = jops.chunked_copy(jnp.asarray(x), chunk_elems=chunk, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


@pytest.mark.parametrize("chunk", [-1, 0, 1, 127, 129, 10**9])
@pytest.mark.parametrize("size", [1, 300])
def test_chunked_copy_accepts_every_chunk_the_reference_does(chunk, size):
    """The reference clamps ``chunk_elems`` to at least 128 elements and at
    most the buffer, so it refuses no value; the port accepts the same
    values and copies the same bytes."""
    x = np.arange(size, dtype=np.float32) - 7.5
    got = chunked_copy(to_tensor(x), chunk_elems=chunk)
    pallas = jops.chunked_copy(jnp.asarray(x), chunk_elems=chunk, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


def test_wrappers_check_their_inputs():
    f32 = torch.zeros((2, 4))
    mode = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        cu.fused_combine(torch.zeros((2, 4), dtype=torch.int32),
                         torch.zeros((2, 4), dtype=torch.int32), mode)
    with pytest.raises(ValueError):
        cu.fused_combine(f32, torch.zeros((2, 5)), mode)
    with pytest.raises(TypeError):
        cu.fused_combine(f32, torch.zeros((2, 4)), mode.long())
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        cu.fused_combine_update(torch.zeros((2, 3, 4)), torch.zeros((2, 1, 4)),
                                idx.long(), idx, idx, 0)
    with pytest.raises(ValueError):
        chunked_copy(torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        chunked_copy(torch.zeros(8)[::2])


def _check_copy_plan(nbytes: int, dst: int) -> None:
    """The plan the kernel is launched with cuts ``nbytes`` into a head that
    reaches the destination's 16-byte boundary, aligned units and a tail of
    less than a unit, every byte exactly once; its grid is one block a tile
    of :data:`TILE_UNITS` units (every tile full but the last), and block 0
    takes the head, the last block the tail."""
    plan = cc.copy_plan(nbytes, dst)
    assert plan.head == min((16 - dst % 16) % 16, nbytes) and 0 <= plan.tail < 16
    assert plan.head + 16 * plan.units + plan.tail == nbytes
    assert plan.units == 0 or (dst + plan.head) % 16 == 0
    assert plan.grid >= 1
    assert (plan.grid - 1) * cc.TILE_UNITS < max(plan.units, 1) <= plan.grid * cc.TILE_UNITS


@pytest.mark.parametrize("nbytes", [1, 15, 16, 17, 31, 32, 16 * cc.TILE_UNITS,
                                    16 * cc.TILE_UNITS + 1, 200_006, 4 * 100_003,
                                    2 * 1_048_576_037])
def test_copy_plan_covers_every_byte_once(nbytes):
    """:func:`_check_copy_plan` at every destination offset mod 16, so every
    head meets every tail (the source's offset does not enter the plan: the
    kernel funnels each store from the aligned source vectors around it)."""
    for dst in range(4096, 4096 + 16):
        _check_copy_plan(nbytes, dst)


def test_copy_plan_takes_a_block_per_tile():
    """The staging bucket of 1,048,576,037 bf16 takes 64,001 blocks of 32
    KiB; a copy of a few tiles one block a tile; head-only and tail-only
    copies one block."""
    assert cc.copy_plan(2 * 1_048_576_037, 0) == cc.CopyPlan(64_001, 0, 131_072_004, 10)
    assert cc.copy_plan(16 * 3000, 0).grid == 2
    assert cc.copy_plan(16 * 3000 + 7, 9) == cc.CopyPlan(2, 7, 3000, 0)
    assert cc.copy_plan(5, 3) == cc.CopyPlan(1, 5, 0, 0)
    assert cc.copy_plan(5, 0) == cc.CopyPlan(1, 0, 0, 5)


def test_copy_plan_refuses_a_grid_cuda_cannot_launch():
    """A copy that would need 2**31 blocks of 32 KiB raises before any
    launch; one block less is planned."""
    tile = 16 * cc.TILE_UNITS
    assert cc.copy_plan((2 ** 31 - 1) * tile, 0).grid == 2 ** 31 - 1
    with pytest.raises(ValueError, match="over CUDA's grid"):
        cc.copy_plan((2 ** 31 - 1) * tile + 16, 0)


def test_build_target_hashes_the_headers_a_source_includes(monkeypatch, tmp_path):
    """A changed header, reached directly or through another header, names
    another library, so a kept build directory never loads a stale one; a
    header the source does not include changes nothing."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build._target("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


def test_port_sources_hash_the_shared_vector_header():
    """The kernels that funnel 16-byte vectors at any alignment include
    ``vec16.cuh``, so its digest is part of their libraries' names; a
    source that includes no header of ``csrc/`` hashes itself alone."""
    for name in ("chunked_copy", "inkernel_rdma", "combine_update"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "vec16.cuh"], name
    assert [p.name for p in _build._sources("quantize")] == ["quantize.cu"]
