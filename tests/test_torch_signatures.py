"""Every public function and class that the port shares with the reference
accepts the reference's keywords (ROADMAP C.4) and keeps its plain-value
defaults (ROADMAP C.5): ``inspect.signature`` of both, module by module,
with explicit allow-lists of the names that exist only for JAX, of those
owned by a queued ROADMAP item and of the defaults the port holds
otherwise (each with its reason), and one call of the port with each
keyword that was repaired."""
from __future__ import annotations

import importlib
import inspect
import json
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# names that exist only for JAX: mesh axes inside shard_map, Pallas's
# interpret switch and tiling, PRNG keys, shardings (grad_specs is a tree of
# NamedShardings), the shared-buffer replay's scratch, scan unrolling
JAX_ONLY = frozenset({"axis_name", "interpret", "key", "shardings", "grad_specs", "shared",
                      "tile", "unroll"})

# keywords whose module is queued in ROADMAP, by the item that ports them
QUEUED: dict = {}

# plain-value defaults (None, bool, int, float, str, and dtypes by name) the
# port holds otherwise, with the reason
DEFAULTS_DIFFER = {
    "models.layers.init_attn_cache": {
        "dtype": "required: the port's cache takes its device as the next positional "
                 "argument, and every caller passes both"},
}

MODULES = sorted(m.name[len("repro_torch."):]
                 for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def _shared(mod: str):
    """(qualified name, port callable, reference callable) for every public
    function and class of port module ``mod`` that the reference module of
    the same name has, and every public method of such a class that the
    reference class has."""
    port = importlib.import_module(f"repro_torch.{mod}")
    try:
        ref = importlib.import_module(f"repro.{mod}")
    except ModuleNotFoundError:
        return []
    names = getattr(port, "__all__", None) or [n for n in dir(port) if not n.startswith("_")]
    out = []
    for name in names:
        p, r = getattr(port, name, None), getattr(ref, name, None)
        if r is None or not (inspect.isfunction(p) or inspect.isclass(p)) \
                or p.__module__ != port.__name__:
            continue
        out.append((f"{mod}.{name}", p, r))
        if inspect.isclass(p) and inspect.isclass(r):
            for meth, fn in vars(p).items():
                if not meth.startswith("_") and inspect.isfunction(fn) \
                        and callable(getattr(r, meth, None)):
                    out.append((f"{mod}.{name}.{meth}", fn, getattr(r, meth)))
    return out


def _params(obj) -> dict:
    try:
        return dict(inspect.signature(obj).parameters)
    except (TypeError, ValueError):  # a builtin without a signature
        return {}


def _refused(qual: str, port, ref) -> list[str]:
    """The reference's parameters the port does not take: a required
    positional one by position (the port may name it otherwise: ``stacked``
    for ``params``), every other one by keyword."""
    pps, rps = _params(port), _params(ref)
    allowed = JAX_ONLY | QUEUED.get(qual, set())
    positional = [p for p in pps.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    missing = []
    for i, (name, rp) in enumerate(rps.items()):
        if name in allowed or rp.kind in (rp.VAR_POSITIONAL, rp.VAR_KEYWORD):
            continue
        if rp.default is rp.empty and rp.kind != rp.KEYWORD_ONLY:
            if i >= len(positional):
                missing.append(name)
            continue
        pp = pps.get(name)
        if pp is None or pp.kind in (pp.POSITIONAL_ONLY, pp.VAR_POSITIONAL):
            missing.append(name)
    return missing


def _default(v):
    """A comparable form of a plain-value default: a dtype by its name
    (``jnp.bfloat16`` and ``torch.bfloat16`` alike), None, bool, int,
    float or str with its type; None for any other default (a hardware
    profile, a callable), which is not compared."""
    if isinstance(v, torch.dtype):
        return ("dtype", str(v)[len("torch."):])
    if isinstance(v, type) or type(v).__module__.split(".")[0] in ("jax", "numpy", "ml_dtypes"):
        try:
            return ("dtype", np.dtype(v).name)
        except TypeError:
            return None
    if v is None or isinstance(v, (bool, int, float, str)):
        return (type(v).__name__, v)
    return None


def _defaults_differ(qual: str, port, ref) -> dict:
    """The reference's plain-value defaults that the port's parameter of the
    same name does not have (``'required'`` where it has none), beyond the
    allow-lists."""
    pps, rps = _params(port), _params(ref)
    allowed = JAX_ONLY | QUEUED.get(qual, set()) | set(DEFAULTS_DIFFER.get(qual, {}))
    out = {}
    for name, rp in rps.items():
        want = None if rp.default is rp.empty else _default(rp.default)
        pp = pps.get(name)
        if want is None or pp is None or name in allowed:
            continue
        got = "required" if pp.default is pp.empty else _default(pp.default)
        if got != want:
            out[name] = (want, got)
    return out


@pytest.mark.parametrize("mod", MODULES)
def test_port_keeps_the_references_defaults(mod):
    """A call that leaves an argument out runs the same mode in both
    packages: every plain-value default of the reference is the port's,
    beyond the allow-list."""
    differ = {q: d for q, p, r in _shared(mod) if (d := _defaults_differ(q, p, r))}
    assert not differ, f"the port's defaults differ from the reference's: {differ}"


@pytest.mark.parametrize("mod", MODULES)
def test_port_accepts_the_references_keywords(mod):
    """No public function of this module raises TypeError on a keyword the
    reference's namesake accepts, beyond the allow-list."""
    refused = {q: m for q, p, r in _shared(mod) if (m := _refused(q, p, r))}
    assert not refused, f"the port refuses the reference's keywords: {refused}"


def test_allow_list_names_only_what_the_port_lacks():
    """Every queued keyword exists in the reference and is still missing
    from the port (drop it here when its ROADMAP item lands), every
    JAX-only name is taken by some shared reference function, and every
    allowed default still differs."""
    shared = {q: (p, r) for mod in MODULES for q, p, r in _shared(mod)}
    for qual, names in QUEUED.items():
        port, ref = shared[qual]
        rp, pp = _params(ref), _params(port)
        assert names <= set(rp), (qual, names - set(rp))
        assert not names & set(pp), (qual, names & set(pp))
    taken = {n for _p, r in shared.values() for n in _params(r)}
    assert JAX_ONLY <= taken, JAX_ONLY - taken
    for qual, names in DEFAULTS_DIFFER.items():
        port, ref = shared[qual]
        for name in names:
            rp, pp = _params(ref)[name], _params(port)[name]
            assert _default(rp.default) != (
                "required" if pp.default is pp.empty else _default(pp.default)), (qual, name)


def test_signatures_cover_the_moe_slice():
    """The MoE module and the ragged entry points are among the shared
    names this file compares (the port's ``mesh=`` and ``transport=`` are
    keywords of its own, which no comparison asks of the reference)."""
    covered = {q for mod in MODULES for q, _p, _r in _shared(mod)}
    assert {"models.moe.init_moe", "models.moe.moe_ffn", "models.moe.expert_partition",
            "comm.api.pallgatherv", "comm.api.palltoallv"} <= covered
    for mod, name in (("models.moe", "moe_ffn"), ("models.blocks", "apply_block"),
                      ("models.transformer", "apply_lm")):
        assert {"mesh", "transport"} <= set(_params(getattr(
            importlib.import_module(f"repro_torch.{mod}"), name)))


# --- one call of the port with each repaired keyword ---


def _stacked(n: int = 3):
    rng = np.random.RandomState(0)
    tree = {"w": torch.from_numpy(rng.randn(n, 300).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(n, 5, 7).astype(np.float32)).to(torch.bfloat16)}
    for leaf in tree.values():
        leaf[1:] = float("nan")
    return tree


def test_distribute_weights_takes_stage_chunk_and_donate():
    """``stage_chunk`` and ``donate`` change nothing on one card: the
    replicas are bit-equal to a call without them, staged and not."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import distribute_weights

    mesh = make_mesh(3, device="cpu")
    for stage in (False, True):
        plain = distribute_weights(_stacked(), mesh, bucket_bytes=512, double_buffer=stage)
        got = distribute_weights(_stacked(), mesh, bucket_bytes=512, double_buffer=stage,
                                 stage_chunk=128, donate=True)
        for k in plain:
            assert torch.equal(got[k].view(torch.int16), plain[k].view(torch.int16))
            assert torch.equal(got[k][1:].float(), got[k][:1].float().expand_as(got[k][1:]))


def test_execute_stream_entry_takes_stage_chunk_and_fused():
    """``fused=False`` routes every bucket to the unrolled replay, which
    is bit-identical to the compiled one; ``stage_chunk`` changes
    nothing."""
    from repro_torch.comm import streams
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import distribution_stream_graph

    mesh = make_mesh(3, device="cpu")
    graph, _spec, _plans = distribution_stream_graph(_stacked(), mesh, algo="pipelined_chain",
                                                     bucket_bytes=512)
    entry = graph.entry("distribute")
    want = streams.execute_stream_entry(entry, _stacked(), stage=True, compiled=True)
    got = streams.execute_stream_entry(entry, _stacked(), stage=True, stage_chunk=256,
                                       fused=False)
    for k in want:
        assert torch.equal(got[k].view(torch.int16), want[k].view(torch.int16))


def test_tree_collectives_take_stage_chunk():
    """``pbcast_tree`` and ``pallreduce_tree`` accept ``stage_chunk`` and
    give what they give without it."""
    from repro_torch import comm

    t = {"a": torch.arange(3 * 40, dtype=torch.float32).reshape(3, 40)}
    got = comm.pbcast_tree({"a": t["a"].clone()}, root=1, bucket_bytes=64, stage_chunk=128)
    assert torch.equal(got["a"], t["a"][1:2].expand(3, 40))
    got = comm.pallreduce_tree({"a": t["a"].clone()}, ("data",), bucket_bytes=64,
                               stage_chunk=128)
    assert torch.equal(got["a"], t["a"].sum(0, keepdim=True).expand(3, 40))


def test_save_checkpoint_writes_extra_into_the_marker(tmp_path):
    """``extra``'s fields land in the json commit marker beside the step,
    as the reference writes them, and the checkpoint restores."""
    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as tckpt

    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    extra = {"loss": 1.5, "tag": "warm"}
    tckpt.save_checkpoint(str(tmp_path / "port"), 7, tree, extra=extra)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 7, {"w": jnp.arange(6.0).reshape(2, 3)},
                          extra=extra)
    marker = lambda d: json.loads((tmp_path / d / "ckpt_00000007.json").read_text())  # noqa: E731
    assert marker("port") == marker("ref") == {"step": 7, **extra}
    assert tckpt.latest_step(str(tmp_path / "port")) == 7
    back = tckpt.restore_checkpoint(str(tmp_path / "port"), 7, tree)
    assert torch.equal(back["w"], tree["w"])


def test_init_block_cache_takes_dtype_as_the_reference_does():
    """``dtype`` is read by no attention cache, here as in the reference:
    both give the config's ``kv_cache_dtype`` and the same shapes."""
    from repro.configs import get_config as j_get_config
    from repro.models.blocks import init_block_cache as j_init
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models.blocks import init_block_cache as t_init

    jcfg, tcfg = j_get_config("minitron-8b-smoke"), t_get_config("minitron-8b-smoke")
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = j_init(jcfg, "attn", None, 2, 16, jdt)["attn"]
        got = t_init(tcfg, "attn", None, 2, 16, "cpu", dtype=tdt)["attn"]
        for k in ("k", "v"):
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype)[6:] == str(want[k].dtype) == tcfg.kv_cache_dtype


def test_attention_positions_match_the_reference():
    """``positions`` rotate q and k in place of ``0..T-1`` in train and
    prefill, through ``attention`` and ``apply_block``, as the
    reference's do (f32, within the reference tests' 1e-5)."""
    from repro.configs import get_config as j_get_config
    from repro.models import blocks as jb
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models import blocks as tb

    jcfg, tcfg = j_get_config("minitron-8b-smoke"), t_get_config("minitron-8b-smoke")
    rng = np.random.RandomState(3)
    d = tcfg.d_model
    p = {"norm1": {"scale": rng.randn(d).astype(np.float32)},
         "attn": {k: rng.randn(*shape).astype(np.float32) * 0.05 for k, shape in (
             ("wq", (d, tcfg.num_heads, tcfg.head_dim)),
             ("wk", (d, tcfg.num_kv_heads, tcfg.head_dim)),
             ("wv", (d, tcfg.num_kv_heads, tcfg.head_dim)),
             ("wo", (tcfg.num_heads, tcfg.head_dim, d)))}}
    x = rng.randn(2, 12, d).astype(np.float32)
    pos = (np.arange(12)[None, :] + np.array([[5], [40]])).astype(np.int32)
    tp = {k: {kk: torch.from_numpy(v) for kk, v in sub.items()} for k, sub in p.items()}
    jp = {k: {kk: jnp.asarray(v) for kk, v in sub.items()} for k, sub in p.items()}
    got, _, _ = tb.apply_block(tp, torch.from_numpy(x), tcfg, "attn", None, mode="train",
                               positions=torch.from_numpy(pos))
    want = jb.apply_block(jp, jnp.asarray(x), jcfg, "attn", None, mode="train",
                          positions=jnp.asarray(pos))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    moved, _, _ = tb.apply_block(tp, torch.from_numpy(x), tcfg, "attn", None, mode="train")
    assert not torch.allclose(moved, got)  # the positions were used


def test_decompress_casts_to_dtype():
    """``CompressedWire.decompress(dtype=)`` casts the f32 rows, as the
    reference's does."""
    from repro.comm.compress import CompressedWire as JWire
    from repro.comm.compress import WireFormat as JFormat
    from repro_torch.comm.compress import CompressedWire as TWire
    from repro_torch.comm.compress import WireFormat as TFormat

    x = np.random.RandomState(4).randn(3, 300).astype(np.float32)
    tw, jw = TWire(TFormat("int8")), JWire(JFormat("int8"), interpret=True)
    tv, ts = tw.compress(torch.from_numpy(x))
    jv, js = jw.compress(jnp.asarray(x))
    got = tw.decompress(tv, ts, out_cols=300, dtype=torch.bfloat16)
    want = jw.decompress(jv, js, out_cols=300, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert tw.decompress(tv, ts, out_cols=300).dtype == torch.float32


def test_distribute_weights_takes_specs():
    """``specs`` lays the broadcast result out per a spec tree: on a (2, 2)
    ('data', 'model') mesh whose rows of data coordinate 0 hold the
    weights, each rank's row is its model coordinate's block."""
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import distribute_weights

    mesh = make_mesh((2, 2), axis_names=("data", "model"), device="cpu")
    w = torch.from_numpy(np.random.RandomState(1).randn(4, 6).astype(np.float32))
    stacked = {"w": torch.full((4, 4, 6), float("nan"))}
    stacked["w"][:2] = w
    got = distribute_weights(stacked, mesh, specs={"w": P(None, "model")}, bucket_bytes=64)
    assert got["w"].shape == (4, 4, 3) and got["w"].is_contiguous()
    for r in range(4):
        assert torch.equal(got["w"][r], w[:, 3 * (r % 2):3 * (r % 2) + 3])
