"""The port's tuner tables against the reference's, on the CPU: the same
``record``/``calibrate`` calls give the same table, a table saved by either
package loads into the other with the same decisions, ``load`` rejects the
same rotten tables, and ``t_exec_path`` prices the three executors alike."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest

from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro.core.tuner import TunerTableError as JTableError
from repro_torch.core import cost_model as tcm
from repro_torch.core.tuner import RECORD_DIMENSIONS, Tuner, TunerTableError

HW = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))


def _record_all(t) -> None:
    """One of every kind of entry, improvement-only replacements and
    same-algorithm carryover included."""
    t.record(1 << 20, 8, "pipelined_chain", 8, 2e-6, extras={"exec_path": "inkernel"})
    t.record(1 << 20, 8, "pipelined_chain", 16, 1e-6)  # faster, same algo: keeps exec_path
    t.record(1 << 20, 8, "chain", 1, 5e-6)  # slower: discarded
    t.record(3 << 24, 4, "fused_rsb", 32, 4e-3, op="allreduce",
             extras={"exec_path": "compiled", "fused_path": True, "overlap_depth": 3})
    t.record(1 << 12, 4, "binomial_reduce", 1, 1e-5, op="reduce", inter_pod=True)
    t.record(1 << 16, 4, "ring_allgatherv", 7, 3e-5, op="allgatherv", sizes=(4, 1, 1, 1))
    t.record(1 << 18, 4, "fused_rsb", 4, 9e-6, op="allreduce", extras={"wire_format": "int8"})
    t.record_overlap(1 << 26, 4, 2)
    t.record_stream("grads", overlap_depth=2, priority=1)


def _saved(t, path) -> dict:
    t.save(str(path))
    return json.loads(path.read_text())


def test_same_records_save_the_same_table(tmp_path):
    jt, tt = JTuner(jcm.TPU_V5E), Tuner(HW)
    _record_all(jt)
    _record_all(tt)
    j, t = _saved(jt, tmp_path / "j.json"), _saved(tt, tmp_path / "t.json")
    assert j == t
    assert t["table"]["8:20:0"] == {"algo": "pipelined_chain", "num_chunks": 16,
                                    "measured_s": 1e-6, "exec_path": "inkernel"}
    assert tt.stream_decision("grads") == jt.stream_decision("grads")


def test_fingerprint_follows_the_table():
    t = Tuner(HW)
    before = t.fingerprint()
    t.record(1 << 20, 8, "chain", 1, 1e-6)
    after = t.fingerprint()
    assert after != before
    t.record(1 << 20, 8, "chain", 1, 2e-6)  # slower: no change
    t.record_stream("s")  # nothing to record
    assert t.fingerprint() == after
    t.record_stream("s", priority=2)
    assert t.fingerprint() != after


def test_calibrate_fills_the_same_table(tmp_path):
    def measure(algo, M, n, k):
        return (len(algo) * 1e-6 + M / 1e12) / k + 1e-6 * k

    jt, tt = JTuner(jcm.TPU_V5E), Tuner(HW)
    for t in (jt, tt):
        t.calibrate(measure, [1 << 12, 1 << 22], 8)
        t.calibrate(measure, [1 << 20, 1 << 26], 4, op="allreduce")
    assert _saved(jt, tmp_path / "j.json") == _saved(tt, tmp_path / "t.json")


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_tables_load_across_packages(tmp_path, direction):
    jt, tt = JTuner(jcm.TPU_V5E), Tuner(HW)
    src = jt if direction == "reference_to_port" else tt
    _record_all(src)
    path = str(tmp_path / "table.json")
    src.save(path)
    jl, tl = JTuner.load(path, hw=jcm.TPU_V5E), Tuner.load(path, hw=HW)
    assert jl.table == tl.table and tl.max_chunks == src.max_chunks
    points = [("bcast", 1 << 20, 8, {}), ("allreduce", 3 << 24, 4, {}),
              ("reduce", 1 << 12, 4, {"inter_pod": True}),
              ("allgatherv", 1 << 16, 4, {"sizes": (4, 1, 1, 1)}),
              ("allreduce", 1 << 18, 4, {}), ("allreduce", 1 << 26, 4, {}),
              ("bcast", 1 << 24, 4, {}), ("reduce_scatter", 1 << 22, 8, {})]
    for op, M, n, kw in points:
        a, b = jl.select(M, n, op=op, **kw), tl.select(M, n, op=op, **kw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b), (op, M, n)
    assert tl.select(1 << 20, 8).exec_path == "inkernel"
    assert tl.select(3 << 24, 4, op="allreduce").overlap_depth == 3


def _good_blob() -> dict:
    t = Tuner(HW)
    _record_all(t)
    return {"hw": "x", "max_chunks": 64, "knomial_k": 4, "table": t.table}


def _rot(blob: dict, key: str, **changes) -> dict:
    blob["table"][key] = {**blob["table"][key], **changes}
    return blob


ROTTEN = {
    "bad_exec_path": lambda b: _rot(b, "8:20:0", exec_path="warp_specialized"),
    "bad_wire_format": lambda b: _rot(b, "8:20:0", wire_format="fp4"),
    "bad_fused_path": lambda b: _rot(b, "8:20:0", fused_path=1),
    "bad_overlap_depth": lambda b: _rot(b, "8:20:0", overlap_depth=0),
    "unknown_algo": lambda b: _rot(b, "8:20:0", algo="tree_of_life"),
    "zero_chunks": lambda b: _rot(b, "8:20:0", num_chunks=0),
    "float_chunks": lambda b: _rot(b, "8:20:0", num_chunks=2.5),
    "nan_time": lambda b: _rot(b, "8:20:0", measured_s=math.nan),
    "string_time": lambda b: _rot(b, "8:20:0", measured_s="fast"),
    "missing_field": lambda b: {**b, "table": {**b["table"], "4:3:0": {"algo": "chain"}}},
    "entry_not_object": lambda b: {**b, "table": {**b["table"], "4:3:0": [1, 2]}},
    "stream_extra_key": lambda b: _rot(b, "stream:grads", algo="chain"),
    "stream_bad_priority": lambda b: _rot(b, "stream:grads", priority="high"),
    "table_not_object": lambda b: {**b, "table": [1]},
    "payload_not_object": lambda b: [1, 2, 3],
}


@pytest.mark.parametrize("case", sorted(ROTTEN))
def test_load_rejects_rotten_tables_as_the_reference_does(tmp_path, case):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(ROTTEN[case](_good_blob())))
    with pytest.raises(JTableError):
        JTuner.load(str(path))
    with pytest.raises(TunerTableError) as err:
        Tuner.load(str(path))
    assert str(path) in str(err.value) and isinstance(err.value, ValueError)


def test_load_rejects_corrupt_and_missing_files(tmp_path):
    p = tmp_path / "table.json"
    p.write_text('{"hw": "h100_sxm", "table": {')
    with pytest.raises(TunerTableError, match="corrupt or truncated"):
        Tuner.load(str(p))
    with pytest.raises(TunerTableError, match="unreadable"):
        Tuner.load(str(tmp_path / "nope.json"))


def test_load_clamps_num_chunks_to_the_tables_max(tmp_path):
    blob = _good_blob()
    blob["max_chunks"] = 8
    path = tmp_path / "t.json"
    path.write_text(json.dumps(blob))
    a, b = JTuner.load(str(path)), Tuner.load(str(path))
    assert a.table == b.table and b.table["8:20:0"]["num_chunks"] == 8
    assert b.select(1 << 20, 8).num_chunks == 8


def test_dryrun_tables_keep_only_structure(tmp_path):
    t = Tuner(HW)
    _record_all(t)
    path = str(tmp_path / "dry.json")
    t.save(path, dryrun=True)
    for load, err in ((Tuner.load, TunerTableError), (JTuner.load, JTableError)):
        with pytest.raises(err, match="dryrun"):
            load(path)
    kept = Tuner.load(path, allow_dryrun=True).table
    assert kept == JTuner.load(path, allow_dryrun=True).table
    assert sorted(kept) == ["allreduce:4:26:0", "stream:grads"]
    assert all("measured_s" not in e for e in kept.values())


def test_record_rejects_unknown_or_bad_dimensions():
    t = Tuner(HW)
    assert set(RECORD_DIMENSIONS) == {"overlap_depth", "fused_path", "exec_path", "wire_format"}
    with pytest.raises(ValueError, match="unknown record dimension"):
        t.record(1 << 20, 8, "chain", 1, 1e-9, extras={"colour": "red"})
    with pytest.raises(ValueError):
        t.record(1 << 20, 8, "chain", 1, 1e-9, extras={"exec_path": "warp_specialized"})
    assert t.table == {}


def test_t_exec_path_equals_the_reference():
    for path in ("inkernel", "compiled", "unrolled"):
        for rounds, classes in ((0, 1), (3, 1), (37, 2), (109, 1)):
            assert tcm.t_exec_path(path, rounds, classes, HW) == \
                jcm.t_exec_path(path, rounds, classes, jcm.TPU_V5E)
    ink, comp, unr = (tcm.t_exec_path(p, 37, 2, tcm.H100_SXM)
                      for p in ("inkernel", "compiled", "unrolled"))
    assert 0 < ink < comp < unr
    with pytest.raises(ValueError):
        tcm.t_exec_path("warp_specialized", 4, 1, HW)
