"""The paper's schedule checks and the plan cache's reference name, held
against the reference on the CPU.

* ``core/simulator.py``'s ``simulate_bcast``, ``simulate_reduce`` and
  ``check_complete`` over every builder of both ``schedules`` modules at
  n in {2, 3, 4, 6, 8}: the same buffers bit for bit, or the same error
  type and message (a schedule that is not a broadcast fails the
  broadcast's ownership check in both). A schedule mutated to send a
  chunk before its sender owns it, and a reduce whose rank sends its
  partial twice, raise ``CausalityError`` in both packages.
* ``plan_cache_info`` is ``cache_stats`` under the reference's name.
* Every public top-level name of a reference module is in the port's
  module of the same path, but for an allow-list keyed by the ROADMAP item
  that ports it (or by why it has no port).
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import repro.comm.schedules as jcs
import repro.core.schedules as js
import repro.core.simulator as jsim
import repro_torch
import repro_torch.comm.schedules as tcs
import repro_torch.core.schedules as ts
import repro_torch.core.simulator as tsim

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

NS = (2, 3, 4, 6, 8)
ROOT = 1  # a root other than 0 relabels every builder's ranks


def _builds():
    """(label, build(pkg_core, pkg_comm, n)) for every builder: the
    broadcast builders of ``core/schedules.py``, the op builders of
    ``comm/schedules.py`` (ragged ones with a size vector that has a
    zero), its pipelined reduce chain and the composite
    ``reduce_then_bcast``."""
    out = []
    for algo in js.ALGORITHMS:
        kw = {"pipelined_chain": {"num_chunks": 5}, "bidir_chain": {"num_chunks": 5},
              "knomial": {"k": 3}}.get(algo, {})
        out.append((f"bcast/{algo}",
                    lambda core, comm, n, a=algo, kw=kw: core.build(a, n, ROOT % n, **kw)))
    for op, algos in jcs.OP_BUILDERS.items():
        for algo in algos:
            def build(core, comm, n, op=op, algo=algo):
                if op == "allgatherv":
                    return comm.build_op(op, algo, n, ROOT % n,
                                         sizes=tuple((2 * r + 1) % 4 for r in range(n)))
                if op == "alltoallv":
                    return comm.build_op(op, algo, n, ROOT % n,
                                         sizes=tuple((i + 2 * j) % 3 for i in range(n)
                                                     for j in range(n)))
                return comm.build_op(op, algo, n, ROOT % n, num_chunks=4)
            out.append((f"{op}/{algo}", build))
    out.append(("reduce/pipelined_reduce_chain(6)",
                lambda core, comm, n: comm.pipelined_reduce_chain(n, ROOT % n, num_chunks=6)))
    out.append(("allreduce/reduce_then_bcast",
                lambda core, comm, n: comm.reduce_then_bcast(
                    n, ROOT % n, core.pipelined_chain(n, ROOT % n, num_chunks=3))))
    return out


BUILDS = _builds()


def _outcome(fn, *args):
    """('ok', result) or (error type name, message)."""
    try:
        return "ok", fn(*args)
    except (AssertionError, ValueError) as e:
        return type(e).__name__, str(e)


def _same(a, b) -> None:
    assert a[0] == b[0], (a, b)
    if a[0] != "ok":
        assert a[1] == b[1]
    elif a[1] is not None:
        assert len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x.view(np.uint64), y.view(np.uint64))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("label,build", BUILDS, ids=[b[0] for b in BUILDS])
def test_schedule_checks_equal_reference(label, build, n):
    try:
        want = build(js, jcs, n)
    except (AssertionError, ValueError) as e:  # a builder that takes no such n
        with pytest.raises(type(e)):
            build(ts, tcs, n)
        return
    got = build(ts, tcs, n)
    rng = np.random.RandomState(n)
    data = [rng.randn(max(want.num_chunks, 1), 3) for _ in range(n)]
    for fn in ("simulate_bcast", "simulate_reduce"):
        got_out = _outcome(getattr(tsim, fn), got, data)
        _same(got_out, _outcome(getattr(jsim, fn), want, data))
        if fn == "simulate_reduce" and got_out[0] == "ok":  # whole-partial reduces
            np.testing.assert_allclose(got_out[1][want.root], np.sum(data, axis=0), rtol=1e-12)
    _same(_outcome(tsim.check_complete, got), _outcome(jsim.check_complete, want))
    if want.kind == "bcast":
        tsim.check_complete(got)  # every broadcast builder completes


def _early(core):
    """A pipelined chain whose last round runs first: rank 2 sends chunk 3
    before it owns it."""
    s = core.pipelined_chain(4, 0, num_chunks=4)
    return dataclasses.replace(s, rounds=(s.rounds[-1],) + s.rounds[:-1])


def _twice(core, comm):
    """A binomial reduce whose first transfer is repeated a round later:
    a merged partial sent again."""
    s = comm.build_op("reduce", "binomial_reduce", 4, 0)
    first = s.rounds[0].transfers[0]
    extra = core.Round((first,))
    return dataclasses.replace(s, rounds=(s.rounds[0], extra) + s.rounds[1:])


def test_a_schedule_that_sends_too_early_raises_in_both():
    data = [np.zeros((4, 2)) for _ in range(4)]
    for core, sim in ((js, jsim), (ts, tsim)):
        with pytest.raises(sim.CausalityError, match="before owning it"):
            sim.simulate_bcast(_early(core), data)
        with pytest.raises(sim.CausalityError, match="before owning it"):
            sim.check_complete(_early(core))
    _same(_outcome(tsim.simulate_bcast, _early(ts), data),
          _outcome(jsim.simulate_bcast, _early(js), data))
    one = [np.ones((1, 2)) for _ in range(4)]
    for core, comm, sim in ((js, jcs, jsim), (ts, tcs, tsim)):
        with pytest.raises(sim.CausalityError, match="already merged"):
            sim.simulate_reduce(_twice(core, comm), one)
    _same(_outcome(tsim.simulate_reduce, _twice(ts, tcs), one),
          _outcome(jsim.simulate_reduce, _twice(js, jcs), one))
    assert issubclass(tsim.CausalityError, AssertionError)


def test_plan_cache_info_is_cache_stats():
    from repro_torch import comm
    from repro_torch.comm import plan

    assert comm.plan_cache_info is plan.plan_cache_info is plan.cache_stats
    plan.plan_cache_clear()
    plan.plan_cached("bcast", 1 << 20, 4)
    plan.plan_cached("bcast", 1 << 20, 4)
    assert comm.plan_cache_info() == comm.cache_stats()
    assert comm.plan_cache_info()["hits"] >= 1


# public names of a reference module that the port's module of the same
# path does not have, by the ROADMAP item that ports them (or the reason
# they have no port)
MISSING_ALLOWED = {
    "Tooling": {"configs.base": {"ShapeSpec", "INPUT_SHAPES"}},
    "JAX-only: a TPU v5e cost profile": {"core.cost_model": {"TPU_V5E"}},
}


def _public(mod) -> set[str]:
    """``__all__``, or the names a module defines itself (no submodules,
    no imports)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", mod.__name__) == mod.__name__ and n != "annotations"}


def test_reference_names_missing_from_the_port_are_queued():
    """Module files only: a package's ``__init__`` re-exports what its users
    call, and the two packages' sets differ by design."""
    allowed: dict[str, set] = {}
    for mods in MISSING_ALLOWED.values():
        for m, names in mods.items():
            allowed.setdefault(m, set()).update(names)
    missing = {}
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if info.ispkg:
            continue
        name = info.name[len("repro_torch."):]
        try:
            ref = importlib.import_module(f"repro.{name}")
        except ModuleNotFoundError:
            continue
        port = importlib.import_module(info.name)
        gone = {n for n in _public(ref) if not hasattr(port, n)}
        if gone:
            missing[name] = gone
    assert missing == allowed
