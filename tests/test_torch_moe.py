"""The port's MoE model against the reference's, on the CPU.

* Unit functions: ``_capacity``, ``_group_size`` and ``expert_partition``
  exactly; ``_route``'s dispatch and ``ce`` exactly, its ``combine`` and
  ``me`` within 1e-6 (the router's f32 logits and softmax sum in another
  order in torch and XLA: readings up to 1.2e-7), on the reference
  invariants' cases. Under a zeroed router every probability ties: the
  port's stable sort takes the lowest expert first, as ``jax.lax.top_k``
  does, so which tokens overflow capacity is the reference's, exactly.
* ``moe_ffn``: the einsum path against the reference's within 1e-5 (f32);
  the port's expert-parallel route (``mesh=`` a 4-rank CPU mesh,
  ``moe_dispatch='alltoallv'``, E = 6: partition (2, 2, 1, 1), a shared
  expert) against the reference's alltoallv result under ``shard_map`` and
  its einsum oracle, within 1e-5. The reference's own alltoallv result
  differs from its oracle by 9.5e-7 (its contraction order differs), so no
  bit-equality is asked of either route.
* The three MoE ``-smoke`` configs: the reference's parameters carried
  across with ``params_from_jax`` bit for bit, then ``apply_lm`` train,
  prefill and decode logits and ``aux``, and ``Model.loss`` within the
  port's existing f32 tolerance (1e-4).
* The aux loss the port used to drop: ``Model.loss`` returns ``nll + aux``
  with the reference's ``{"nll", "aux"}``; a dense model's aux is exactly
  0. Training a MoE model is held in tests/test_torch_train_moe.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JConfig
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.comm import palltoallv
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from test_torch_ragged import MOE_B, MOE_CFG, MOE_T, N, moe_reference

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCHS_MOE = ("mixtral-8x7b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
F32 = {"dtype": "float32", "kv_cache_dtype": "float32"}
# the reference invariants' routing cases: (k, E, seed)
ROUTE_CASES = ((1, 4, 0), (2, 4, 3), (2, 6, 7), (3, 4, 11), (2, 4, 0), (3, 4, 5))


def _cfgs(**kw):
    base = dict(name="t", family="moe", num_layers=1, d_model=8, num_heads=2,
                num_kv_heads=2, d_ff=16, vocab_size=32, num_experts=4,
                experts_per_token=2, moe_group_size=8)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _tp(p) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------- unit functions


def test_capacity_matches_reference():
    """Every (S, k, E, capacity factor) of a grid, the floor clamp's cases
    included (S=2 k=1; S=1)."""
    for S in (1, 2, 3, 8, 16, 64, 512):
        for k in (1, 2, 3, 6, 8):
            for E in (4, 6, 8, 64, 128):
                for cf in (0.01, 1.0, 1.25, 2.0):
                    assert tmoe._capacity(S, k, E, cf) == jmoe._capacity(S, k, E, cf), \
                        (S, k, E, cf)
    assert tmoe._capacity(2, 1, 4, 1.25) <= 2
    assert tmoe._capacity(16, 2, 4, 1.25) >= 4
    assert tmoe._capacity(1, 2, 4, 1.25) == 2
    assert tmoe._capacity(512, 2, 8, 1.25) == 161  # mixtral's 4096-token prefill


@pytest.mark.parametrize("T,group,want", [(17, 16, 1), (520, 512, 260), (64, 16, 16),
                                          (24, 16, 12), (4096, 512, 512), (128, 512, 128)])
def test_group_size_matches_reference(T, group, want):
    jc, tc = _cfgs(moe_group_size=group)
    assert tmoe._group_size(T, tc) == jmoe._group_size(T, jc) == want


def test_group_size_grid_matches_reference():
    for group in (1, 7, 16, 64, 512):
        jc, tc = _cfgs(moe_group_size=group)
        for T in range(1, 130):
            assert tmoe._group_size(T, tc) == jmoe._group_size(T, jc), (T, group)


def test_expert_partition_matches_reference():
    for E in range(0, 20):
        for n in range(1, 9):
            assert tmoe.expert_partition(E, n) == jmoe.expert_partition(E, n)
    assert tmoe.expert_partition(6, 4) == (2, 2, 1, 1)


def _route_both(k: int, E: int, seed: int, *, uniform: bool = False, S: int = 8, **kw):
    jc, tc = _cfgs(experts_per_token=k, num_experts=E, moe_group_size=S, **kw)
    p = dict(jmoe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32))
    if uniform:
        p["router"] = jnp.zeros_like(p["router"])
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (2, 2 * S, 8), jnp.float32))
    xg = x.reshape(2, 2, S, 8)
    want = [np.asarray(a) for a in jmoe._route(p, jnp.asarray(xg), jc)]
    with torch.no_grad():
        got = [t.numpy() for t in tmoe._route(_tp(p), torch.from_numpy(xg), tc)]
    return got, want


@pytest.mark.parametrize("k,E,seed", ROUTE_CASES)
def test_route_matches_reference(k, E, seed):
    (combine, dispatch, me, ce), (jcombine, jdispatch, jme, jce) = _route_both(k, E, seed)
    np.testing.assert_array_equal(dispatch, jdispatch)
    np.testing.assert_array_equal(ce, jce)
    np.testing.assert_allclose(combine, jcombine, rtol=0, atol=1e-6)
    np.testing.assert_allclose(me, jme, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_uniform_router_ties_take_the_lowest_expert_first(k):
    """Every probability ties: the top k are experts 0..k-1 for every
    token, as the reference's ``top_k`` gives them, so the same tokens fill
    each expert's capacity and the same ones drop — every output of
    ``_route`` exact."""
    got, want = _route_both(k, 4, 0, uniform=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dispatch = got[1]
    assert dispatch[..., k:, :].sum() == 0  # only experts 0..k-1 are used
    C = tmoe._capacity(8, k, 4, 1.25)
    assert (dispatch.sum(axis=(2, 4))[..., :k] == min(C, 8)).all()  # drops at capacity


@pytest.mark.parametrize("k", [1, 2])
def test_aux_loss_calibrated_under_uniform_router(k):
    """The reference invariant: under a zeroed router the aux loss is
    exactly router_aux_coef for any k; the port's equals the reference's."""
    jc, tc = _cfgs(experts_per_token=k)
    p = dict(jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.float32))
    p["router"] = jnp.zeros_like(p["router"])
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 8), jnp.float32))
    _, jaux = jmoe.moe_ffn(p, jnp.asarray(x), jc)
    with torch.no_grad():
        _, aux = tmoe.moe_ffn(_tp(p), torch.from_numpy(x), tc)
    assert abs(float(aux) - tc.router_aux_coef) < 1e-5
    assert float(aux) == float(jaux)


def test_over_capacity_tokens_are_dropped_not_wrapped():
    """A router biased hard toward expert 0 with a tiny capacity factor:
    exactly C tokens reach expert 0 and the rest drop, as in the
    reference."""
    jc, tc = _cfgs(experts_per_token=1, capacity_factor=0.01, moe_group_size=16)
    p = dict(jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.float32))
    r = np.zeros((8, 4), np.float32)
    r[:, 0] = 100.0
    p["router"] = jnp.asarray(r)
    xg = np.ones((1, 1, 16, 8), np.float32)
    want = [np.asarray(a) for a in jmoe._route(p, jnp.asarray(xg), jc)]
    got = [t.numpy() for t in tmoe._route(_tp(p), torch.from_numpy(xg), tc)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][..., 0, :].sum() == tmoe._capacity(16, 1, 4, 0.01)


# ------------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("kw,T", [({}, 16), ({"num_shared_experts": 1}, 16),
                                  ({"num_experts": 6, "experts_per_token": 3}, 24),
                                  ({"moe_group_size": 16}, 17), ({"moe_group_size": 16}, 520)])
def test_moe_ffn_einsum_matches_reference(kw, T):
    jc, tc = _cfgs(**kw)
    p = jmoe.init_moe(jax.random.PRNGKey(2), jc, jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, T, 8), jnp.float32))
    jy, jaux = jmoe.moe_ffn(p, jnp.asarray(x), jc)
    with torch.no_grad():
        y, aux = tmoe.moe_ffn(_tp(p), torch.from_numpy(x), tc)
    assert y.shape == (2, T, 8) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.fixture(scope="module")
def ep(dist, tmp_path_factory):
    """The reference's alltoallv moe_ffn and its einsum oracle (from
    ``tests/test_torch_ragged.py``'s subprocess), its parameters and input,
    and the port's result on a 4-rank CPU mesh."""
    ref = moe_reference(dist, tmp_path_factory)
    p = {k[len("moe/p/"):]: ref[k] for k in ref if k.startswith("moe/p/")
         and not k.startswith("moe/p/shared/")}
    p["shared"] = {k[len("moe/p/shared/"):]: ref[k] for k in ref
                   if k.startswith("moe/p/shared/")}
    x = np.random.RandomState(1).randn(MOE_B, MOE_T, MOE_CFG["d_model"]).astype(np.float32)
    cfg = dataclasses.replace(TConfig(**MOE_CFG), moe_dispatch="alltoallv")
    with torch.no_grad():
        y, aux = tmoe.moe_ffn(params_from_jax(p), torch.from_numpy(x), cfg,
                              mesh=make_mesh(N, device="cpu"))
    return ref, params_from_jax(p), x, y, aux


def test_moe_ffn_alltoallv_matches_reference(ep):
    ref, _p, _x, y, aux = ep
    assert tmoe.expert_partition(MOE_CFG["num_experts"], N) == (2, 2, 1, 1)
    np.testing.assert_allclose(y.numpy(), ref["moe/y"], rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(ref["moe/aux"])) < 1e-6


def test_moe_ffn_alltoallv_matches_einsum_oracle(ep):
    """Both the port's expert-parallel result and the reference's stand
    within 1e-5 of the reference's einsum oracle (the reference's own
    reading: 9.5e-7), and the port's einsum path equals its oracle too."""
    ref, p, x, y, aux = ep
    np.testing.assert_allclose(y.numpy(), ref["moe/y_einsum"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref["moe/y"], ref["moe/y_einsum"], rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(ref["moe/aux_einsum"])) < 1e-6
    with torch.no_grad():
        ye, auxe = tmoe.moe_ffn(p, torch.from_numpy(x), TConfig(**MOE_CFG),
                                mesh=make_mesh(N, device="cpu"))  # einsum: mesh unused
    np.testing.assert_allclose(y.numpy(), ye.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ye.numpy(), ref["moe/y_einsum"], rtol=1e-5, atol=1e-5)



@pytest.mark.parametrize("pin", ({"compiled": True}, {"inkernel": True}, {"fused": False}),
                         ids=("compiled", "inkernel", "unrolled"))
def test_transport_pins_the_executor(ep, pin):
    """``transport=`` moves both of the expert-parallel route's blocks:
    ``palltoallv`` pinned to the compiled, the in-kernel (its plain
    version here) or the unrolled executor gives the default route's bits,
    out with the per-destination sizes and a padded output, back with the
    transposed matrix and a padded input."""
    _ref, p, x, y, aux = ep
    calls = []

    def transport(t, **kw):
        calls.append(kw)
        return palltoallv(t, **kw, **pin)

    cfg = dataclasses.replace(TConfig(**MOE_CFG), moe_dispatch="alltoallv")
    with torch.no_grad():
        yp, auxp = tmoe.moe_ffn(p, torch.from_numpy(x), cfg, mesh=make_mesh(N, device="cpu"),
                                transport=transport)
    assert torch.equal(yp, y) and float(auxp) == float(aux)
    S = tmoe._group_size(MOE_T, cfg)
    R = MOE_B // N * (MOE_T // S) * tmoe._capacity(S, cfg.experts_per_token,
                                                   cfg.num_experts, cfg.capacity_factor)
    cnt = tmoe.expert_partition(cfg.num_experts, N)
    assert calls == [{"sizes": [c * R for c in cnt], "out_padded": True},
                     {"sizes": [[c * R] * N for c in cnt], "in_padded": True}]


def test_apply_lm_threads_the_transport():
    """``apply_lm(mesh=, transport=)`` hands the transport to every moe
    block, two calls a block, in prefill and in train mode (with remat);
    the logits are the default transport's bit for bit."""
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b-smoke"), moe_dispatch="alltoallv",
                              **F32)
    params = TModel(cfg).init(seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size - 1,
                                                               size=(N, 32)))
    mesh = make_mesh(N, device="cpu")
    calls = []

    def transport(t, **kw):
        calls.append(kw)
        return palltoallv(t, **kw, compiled=True)

    with torch.no_grad():
        for mode, kw in (("prefill", {"max_len": 32}), ("train", {"remat": True})):
            calls.clear()
            want, _, want_aux = tt.apply_lm(params, cfg, tokens=tokens, mode=mode, mesh=mesh,
                                            **kw)
            got, _, got_aux = tt.apply_lm(params, cfg, tokens=tokens, mode=mode, mesh=mesh,
                                          transport=transport, **kw)
            assert len(calls) == 2 * cfg.num_layers, (mode, calls)
            assert torch.equal(got, want) and float(got_aux) == float(want_aux), mode

def test_alltoallv_route_refuses_an_uneven_batch():
    cfg = dataclasses.replace(TConfig(**MOE_CFG), moe_dispatch="alltoallv")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="does not divide"):
        tmoe.moe_ffn(p, torch.zeros((6, MOE_T, 8)), cfg, mesh=make_mesh(N, device="cpu"))


# --------------------------------------------------------- the MoE smoke configs


def test_moe_configs_are_registered():
    for arch in ARCHS_MOE:
        assert arch in ARCHS
        tc, jc = t_get_config(f"{arch}-smoke"), j_get_config(f"{arch}-smoke")
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(j_get_config(arch))


T_SMOKE, STEPS = 80, 3  # past mixtral-smoke's window of 64


@pytest.fixture(scope="module", params=ARCHS_MOE)
def smoke(request):
    arch = f"{request.param}-smoke"
    jcfg = dataclasses.replace(j_get_config(arch), **F32)
    tcfg = dataclasses.replace(t_get_config(arch), **F32)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = _tp(jparams)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, jcfg.vocab_size - 1, size=(2, T_SMOKE))
    labels = rng.randint(0, jcfg.vocab_size - 1, size=(2, T_SMOKE))
    return jcfg, tcfg, jparams, tparams, tokens, labels


def test_params_cross_bit_for_bit(smoke):
    """The router (f32), the experts' (E, d, f)/(E, f, d) weights and the
    shared experts' cross unchanged."""
    _jc, _tc, jparams, tparams, *_ = smoke
    jl, tl = jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    moe = tparams["decoder"]["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_down"].dim() == 4


def test_apply_lm_train_logits_and_aux(smoke):
    jcfg, tcfg, jparams, tparams, tokens, _ = smoke
    jl, _, jaux = jax.jit(lambda p, t: jt.apply_lm(p, jcfg, tokens=t, mode="train"))(
        jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        tl, caches, taux = tt.apply_lm(tparams, tcfg, tokens=torch.from_numpy(tokens),
                                       mode="train")
    assert caches is None and taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6 and float(taux) > 0


def test_prefill_and_decode_logits_and_aux(smoke):
    jcfg, tcfg, jparams, tparams, tokens, _ = smoke
    max_len = T_SMOKE + STEPS
    jl, jc, jaux = jt.apply_lm(jparams, jcfg, tokens=jnp.asarray(tokens, jnp.int32),
                               mode="prefill", max_len=max_len)
    with torch.no_grad():
        tl, tc, taux = tt.apply_lm(tparams, tcfg, tokens=torch.from_numpy(tokens),
                                   mode="prefill", max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    for i in range(STEPS):
        jl, jc, jaux = jt.apply_lm(jparams, jcfg, tokens=jnp.asarray(nxt, jnp.int32),
                                   mode="decode", caches=jc,
                                   cur_pos=jnp.asarray(T_SMOKE + i, jnp.int32))
        with torch.no_grad():
            tl, tc, taux = tt.apply_lm(tparams, tcfg, tokens=torch.from_numpy(nxt.copy()),
                                       mode="decode", caches=tc, cur_pos=T_SMOKE + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        assert abs(float(taux) - float(jaux)) < 1e-6
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None]


def test_loss_is_nll_plus_aux(smoke):
    """``Model.loss`` returns the reference's ``nll + aux`` and its
    ``{"nll", "aux"}`` within 1e-4, the router's aux loss included (the
    port dropped it before), with remat and without."""
    jcfg, tcfg, jparams, tparams, tokens, labels = smoke
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    jloss, jm = jax.jit(lambda p, b: JModel(jcfg).loss(p, b))(jparams, jb)
    for remat in (False, True):
        loss, metrics = TModel(tcfg).loss(tparams, tb, remat=remat)
        assert set(metrics) == {"nll", "aux"}
        assert abs(float(loss) - float(jloss)) <= 1e-4
        assert abs(float(metrics["nll"]) - float(jm["nll"])) <= 1e-4
        assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-4
        assert float(metrics["aux"]) > 0
        assert float(loss) == float(metrics["nll"] + metrics["aux"])


def test_loss_gradient_reaches_the_router(smoke):
    """The aux term is in the graph: the router gets a gradient from it."""
    _jc, tcfg, _jp, tparams, tokens, labels = smoke
    router = tparams["decoder"]["blocks"][0]["moe"]["router"].clone().requires_grad_(True)
    params = dict(tparams, decoder=dict(tparams["decoder"]))
    block = dict(tparams["decoder"]["blocks"][0])
    block["moe"] = dict(block["moe"], router=router)
    params["decoder"]["blocks"] = [block]
    _loss, metrics = TModel(tcfg).loss(params, {"tokens": torch.from_numpy(tokens),
                                                "labels": torch.from_numpy(labels)})
    (grad,) = torch.autograd.grad(metrics["aux"], router)
    assert float(grad.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_expert_parallel_apply_lm_matches_einsum(arch):
    """``apply_lm(mesh=)`` with ``moe_dispatch='alltoallv'`` on a 4-rank
    CPU mesh: the batch of 4 splits one sequence a rank, every moe block
    moves its expert rows through ``palltoallv``, and the prefill logits
    and aux stand within 1e-4 of the reference's einsum dispatch."""
    jcfg = dataclasses.replace(j_get_config(f"{arch}-smoke"), **F32)
    tcfg = dataclasses.replace(t_get_config(f"{arch}-smoke"), moe_dispatch="alltoallv", **F32)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1))
    tparams = _tp(jparams)
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab_size - 1, size=(N, 64))
    jl, _, jaux = jt.apply_lm(jparams, jcfg, tokens=jnp.asarray(tokens, jnp.int32),
                              mode="prefill", max_len=64)
    with torch.no_grad():
        tl, _, taux = tt.apply_lm(tparams, tcfg, tokens=torch.from_numpy(tokens),
                                  mode="prefill", max_len=64, mesh=make_mesh(N, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6


# ----------------------------------------------------- the dense path's aux


def test_dense_aux_is_exactly_zero():
    """A dense model's aux is 0.0 in every mode, and its loss is its nll
    bit for bit: the repair changes no dense result."""
    cfg = dataclasses.replace(t_get_config("minitron-8b-smoke"), **F32)
    model = TModel(cfg)
    params = model.init(seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tokens})
        assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) == 0.0
        _l, caches, aux = tt.apply_lm(params, cfg, tokens=tokens, mode="prefill", max_len=14)
        assert float(aux) == 0.0
        _l, _c, aux = tt.apply_lm(params, cfg, tokens=tokens[:, :1], mode="decode",
                                  caches=caches, cur_pos=12)
        assert float(aux) == 0.0
        loss, metrics = model.loss(params, {"tokens": tokens, "labels": tokens})
    assert float(loss) == float(metrics["nll"]) and float(metrics["aux"]) == 0.0
