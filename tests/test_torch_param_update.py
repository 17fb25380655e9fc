"""The port's mix / scaled_add against the reference's Pallas kernels
(interpret mode on the CPU) and their oracles."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import launch_counts, param_update as pu

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({2: np.uint16, 4: np.uint32}[x.dtype.itemsize])


def _pair(n: int, dt: str, seed: int):
    rng = np.random.RandomState(seed)
    j = [jnp.asarray(rng.randn(n) * 3, jnp.dtype(dt)) for _ in range(2)]
    t = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dt)) for x in j]
    return j, t


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


# XLA's CPU build of the reference's interpret-mode kernel contracts the f32
# arithmetic into an FMA (mix = fma(1 - a, w, a * u), scaled_add =
# fma(-a, u, w)); its oracle, the port's plain version and the CUDA kernel
# round every product and sum on its own (a TPU has no f32 FMA either). So
# the port is bit-equal to the oracle, and within the two roundings that
# differ, eps * (|(1 - a) w| + |a u|), of the interpreted kernel: eps 2^-22
# in f32, one bf16 step (2^-7) in bf16. The reference's own test allows 1e-2.
EPS = {"float32": 2.0**-22, "bfloat16": 2.0**-7}


# the reference test's sizes, a ragged 65,537 (one past a tile) and odd
# coefficients whose 1 - a rounds in f32
@pytest.mark.parametrize("n", [131, 4096, 65_537, 100_000])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("a", [0.25, 0.01, 0.3, 1e-3 / 7])
def test_param_updates_match_reference(n, dt, a):
    (jw, ju), (w, u) = _pair(n, dt, seed=n % 97)
    wf, uf = np.array(jw, np.float64), np.array(ju, np.float64)
    for port, kernel, oracle, size in (
        (pu.mix, ops.mix, ref.mix_ref, np.abs((1 - a) * wf) + np.abs(a * uf)),
        (pu.scaled_add, ops.scaled_add, ref.scaled_add_ref, np.abs(wf) + np.abs(a * uf)),
    ):
        got = port(w, u, a)
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_array_equal(_np(got), _bits(np.asarray(oracle(jw, ju, a))))
        want = np.asarray(kernel(jw, ju, a), np.float64)
        diff = np.abs(got.double().numpy() - want)
        assert (diff <= EPS[dt] * size).all(), (port.__name__, diff.max())


def test_wrappers_take_the_plain_version_on_cpu():
    (_jw, _ju), (w, u) = _pair(1000, "bfloat16", seed=3)
    before = launch_counts()
    assert torch.equal(pu.mix(w, u, 0.5), pu.mix_plain(w, u, 0.5))
    assert torch.equal(pu.scaled_add(w, u, 0.5), pu.scaled_add_plain(w, u, 0.5))
    after = launch_counts()
    assert after["mix"] == before["mix"] and after["scaled_add"] == before["scaled_add"]


@pytest.mark.parametrize("w_shape, u_shape", [((8,), (9,)), ((2, 4), (2, 4))])
def test_param_updates_refuse_other_shapes(w_shape, u_shape):
    with pytest.raises(ValueError, match="flat buffers"):
        pu.mix(torch.zeros(w_shape), torch.zeros(u_shape), 0.5)
    with pytest.raises(ValueError, match="flat buffers"):
        pu.scaled_add(torch.zeros(w_shape), torch.zeros(u_shape), 0.5)
