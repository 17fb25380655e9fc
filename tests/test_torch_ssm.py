"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU, at smoke widths from seeded
numpy inputs: the chunked diagonal scan, each mixer's ``*_seq`` (from a
zero and from a given state) and ``*_step`` with the state carried from
``*_seq``, at a length the chunk does not divide (T = 40 at chunk 16);
Mamba's scan at decays whose running sums would overflow ``exp``; the
init functions' trees and their constant leaves. f32 within atol = rtol =
1e-4."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as js
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.models import ssm as ts

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
B, T_ODD, STEPS = 2, 40, 3
# the config each mixer comes from (its smoke variant: ssm_chunk 16)
MIXERS = {"mamba": "hymba-1.5b-smoke", "mlstm": "xlstm-350m-smoke",
          "slstm": "xlstm-350m-smoke"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def mixers():
    """Each mixer's f32 parameters (the reference's draw, carried over),
    inputs, a given state, and the reference's results, computed once:
    ``seq`` from zero at T = 40, ``seq_state`` from the given state, and
    ``STEPS`` ``*_step`` calls from ``seq``'s final state (jitted)."""
    out = {}
    for i, (kind, arch) in enumerate(MIXERS.items()):
        cfg = j_get_config(arch)
        jp = getattr(js, f"init_{kind}")(jax.random.PRNGKey(10 + i), cfg, jnp.float32)
        rng = np.random.RandomState(10 + i)
        x = rng.randn(B, T_ODD, cfg.d_model).astype(np.float32)
        xs = rng.randn(STEPS, B, 1, cfg.d_model).astype(np.float32)
        seq = jax.jit(lambda p, x, st, fn=getattr(js, f"{kind}_seq"), c=cfg: fn(p, x, c, st))
        step = jax.jit(lambda p, x1, st, fn=getattr(js, f"{kind}_step"), c=cfg: fn(p, x1, st, c))
        y, st = seq(jp, jnp.asarray(x), None)
        given = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.5),
                             st)
        y_given, st_given = seq(jp, jnp.asarray(x), given)
        steps, carry = [], st
        for x1 in xs:
            y1, carry = step(jp, jnp.asarray(x1), carry)
            steps.append((_np(y1), _np(carry)))
        out[kind] = dict(cfg=t_get_config(arch), jp=jp, tp=_t(jp), x=x, xs=xs,
                         seq=(_np(y), _np(st)), given=_np(given),
                         seq_given=(_np(y_given), _np(st_given)), steps=steps)
    return out


@pytest.mark.parametrize("T, chunk", [(40, 16), (64, 16), (16, 16), (7, 16)])
def test_chunked_diag_scan_matches_reference(T, chunk):
    rng = np.random.RandomState(T)
    la = -np.abs(rng.randn(B, T, 3, 5)).astype(np.float32)
    b = rng.randn(B, T, 3, 5).astype(np.float32)
    h0 = rng.randn(B, 3, 5).astype(np.float32)
    want = jax.jit(js.chunked_diag_scan, static_argnums=3)(jnp.asarray(la), jnp.asarray(b),
                                                           jnp.asarray(h0), chunk)
    got = ts.chunked_diag_scan(torch.from_numpy(la), torch.from_numpy(b),
                               torch.from_numpy(h0), chunk)
    assert tuple(got[0].shape) == (B, T, 3, 5) and tuple(got[1].shape) == (B, 3, 5)
    _close([g.numpy() for g in got], want)


@pytest.mark.parametrize("T", [1, 7, 16, 40, 64, 100, 128, 4096])
@pytest.mark.parametrize("chunk", [16, 128])
def test_pick_chunk_is_the_references(T, chunk):
    assert ts._pick_chunk(T, chunk) == js._pick_chunk(T, chunk)


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)``, as ``jax.nn.softplus``; torch's own softplus
    returns x above its threshold of 20."""
    x = np.linspace(-40.0, 40.0, 161, dtype=np.float32)
    np.testing.assert_allclose(ts._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_seq_matches_reference(mixers, kind):
    m = mixers[kind]
    y, st = getattr(ts, f"{kind}_seq")(m["tp"], torch.from_numpy(m["x"]), m["cfg"])
    assert y.dtype == torch.float32 and tuple(y.shape) == m["x"].shape
    assert all(s.dtype == torch.float32 for s in st)
    _close((y.numpy(), [s.numpy() for s in st]), m["seq"])


@pytest.mark.parametrize("kind", list(MIXERS))
def test_seq_from_a_given_state_matches_reference(mixers, kind):
    m = mixers[kind]
    given = tuple(torch.from_numpy(np.array(a)) for a in m["given"])
    y, st = getattr(ts, f"{kind}_seq")(m["tp"], torch.from_numpy(m["x"]), m["cfg"],
                                       state=given)
    _close((y.numpy(), [s.numpy() for s in st]), m["seq_given"])


@pytest.mark.parametrize("kind", list(MIXERS))
def test_step_carries_the_seq_state(mixers, kind):
    """``*_seq``'s final state goes into ``STEPS`` calls of ``*_step``,
    each output and state against the reference's."""
    m = mixers[kind]
    _y, st = getattr(ts, f"{kind}_seq")(m["tp"], torch.from_numpy(m["x"]), m["cfg"])
    for x1, want in zip(m["xs"], m["steps"]):
        y1, st = getattr(ts, f"{kind}_step")(m["tp"], torch.from_numpy(x1), st, m["cfg"])
        assert tuple(y1.shape) == x1.shape
        _close((y1.numpy(), [s.numpy() for s in st]), want)


def test_mamba_scan_stays_finite_at_large_decays():
    """dt near 4 (``b_dt`` = 4) with A down to -16: over a 128-position
    chunk the log decays sum to thousands below 0, so exp(-cumsum(log_a))
    would overflow f32 (above 88). The doubling scan exponentiates only
    window sums (<= 0); the output and state match the reference's."""
    import dataclasses

    jcfg = dataclasses.replace(j_get_config("hymba-1.5b-smoke"), ssm_chunk=128)
    tcfg = dataclasses.replace(t_get_config("hymba-1.5b-smoke"), ssm_chunk=128)
    jp = js.init_mamba(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jp = {**jp, "b_dt": jnp.full_like(jp["b_dt"], 4.0)}
    x = np.random.RandomState(3).randn(1, 256, jcfg.d_model).astype(np.float32)
    want = jax.jit(lambda p, x: js.mamba_seq(p, x, jcfg))(jp, jnp.asarray(x))
    y, st = ts.mamba_seq(_t(jp), torch.from_numpy(x), tcfg)
    assert torch.isfinite(y).all() and all(torch.isfinite(s).all() for s in st)
    _close((y.numpy(), [s.numpy() for s in st]), want)


@pytest.mark.parametrize("kind", list(MIXERS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_tree_matches_reference(kind, dtype):
    """Keys, shapes, dtypes and flatten order of ``init_*`` equal the
    reference's; with ``lead`` every leaf gains the stacked dimension."""
    arch = MIXERS[kind]
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    want = getattr(js, f"init_{kind}")(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    gen = torch.Generator().manual_seed(0)
    got = getattr(ts, f"init_{kind}")(gen, tcfg, getattr(torch, dtype))
    stacked = getattr(ts, f"init_{kind}")(gen, tcfg, getattr(torch, dtype), lead=(3,))
    assert tree_paths(got) == sorted(want)
    for g, s, w in zip(tree_leaves(got), tree_leaves(stacked), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
        assert tuple(s.shape) == (3,) + w.shape and s.dtype == g.dtype


@pytest.mark.parametrize("kind, name", [("mlstm", "bf"), ("slstm", "b"), ("mamba", "b_dt"),
                                        ("mamba", "d_skip"), ("mamba", "a_log")])
def test_constant_leaves(kind, name):
    """The constant leaves bit for bit (and the same in every stacked row):
    mLSTM's forget bias 2.0, sLSTM's gate biases (0, 0, 2, 0 by quarter),
    Mamba's ``b_dt`` -4 and ``d_skip`` 1. ``a_log`` = log 1..N is rounded
    once from float64 (the same bits on every device); XLA's f32 log on the
    CPU lies one ulp above it at log 7, so against the reference it holds
    within one ulp."""
    arch = MIXERS[kind]
    want = np.asarray(getattr(js, f"init_{kind}")(jax.random.PRNGKey(0), j_get_config(arch))[name])
    got = getattr(ts, f"init_{kind}")(torch.Generator().manual_seed(0), t_get_config(arch),
                                      lead=(2,))[name].numpy()
    assert got.dtype == want.dtype == np.float32
    for row in got:
        if name == "a_log":
            N = want.shape[-1]
            exact = np.log(np.arange(1, N + 1, dtype=np.float64)).astype(np.float32)
            np.testing.assert_array_equal(row, np.broadcast_to(exact, want.shape))
            ulps = np.abs(row.view(np.int32).astype(np.int64) - want.view(np.int32))
            assert ulps.max() <= 1, ulps.max()
        else:
            np.testing.assert_array_equal(row, want)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_seq_gradient_matches_reference(mixers, kind):
    """``*_seq`` is differentiable (the doubling scan builds each step
    without ``out=``, which autograd refuses): the gradient of a weighted
    sum of the output with respect to every parameter and the input,
    against ``jax.grad`` of the same."""
    m = mixers[kind]
    cfg = j_get_config(MIXERS[kind])
    w = np.random.RandomState(20).randn(*m["x"].shape).astype(np.float32)
    fn = getattr(js, f"{kind}_seq")
    want = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x, cfg)[0] * w), argnums=(0, 1)))(
        m["jp"], jnp.asarray(m["x"]))
    tp = {k: v.clone().requires_grad_(True) for k, v in m["tp"].items()}
    x = torch.from_numpy(m["x"]).requires_grad_(True)
    y, _st = getattr(ts, f"{kind}_seq")(tp, x, m["cfg"])
    (y * torch.from_numpy(w)).sum().backward()
    got = ({k: t.grad.numpy() for k, t in tp.items()}, x.grad.numpy())
    for key in want[0]:
        np.testing.assert_allclose(got[0][key], np.asarray(want[0][key]), **TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
