"""PaliGemma (a vision-prefix decoder) in the port against the reference, on
paligemma-3b-smoke widened to the full model's head width 256 and prefix
of 256 stub patches: the configs, the stub embeddings and the parameters
bit for bit, the prefix reaching every block, then prefill, loss and
``Engine.generate`` in f32, on the dense path and on the long-prompt path
(the flash kernel's plain version with query tiles that cover the prefix
in the port, the block-scanned softmax in the reference)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS, RunConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine as TEngine
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "paligemma-3b-smoke"
PREFIX = 256   # the full model's 256 patches: longer than a 128-row query tile
STEPS = 4
SHORT = 32     # text tokens: 288 positions, the dense softmax
LONG = 256     # 512 positions, at the lowered threshold: the long-prompt path
LOW_MIN_S = 512
WIDE = {"head_dim": 256, "prefix_len": PREFIX, "frontend_len": PREFIX}


def _configs(**extra):
    kw = {"dtype": "float32", "kv_cache_dtype": "float32", **WIDE, **extra}
    return (dataclasses.replace(j_get_config(ARCH), **kw),
            dataclasses.replace(t_get_config(ARCH), **kw))


@pytest.fixture(scope="module")
def pali():
    jcfg, tcfg = _configs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(6))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(6)
    tokens = {T: rng.randint(0, jcfg.vocab_size - 1, size=(4, T)) for T in (SHORT, LONG)}
    embeds = rng.randn(4, PREFIX, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, tokens, embeds


def _lower_threshold(monkeypatch):
    """The long-prompt path at a CPU-sized prompt: the threshold lowered in
    both packages' layer modules for this test only."""
    monkeypatch.setattr(jl, "CHUNKED_ATTN_MIN_S", LOW_MIN_S)
    monkeypatch.setattr(tl, "CHUNKED_ATTN_MIN_S", LOW_MIN_S)


def test_config_matches_reference():
    assert "paligemma-3b" in ARCHS
    for name in ("paligemma-3b", ARCH):
        j, t = j_get_config(name), t_get_config(name)
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
            {f.name: getattr(j, f.name) for f in dataclasses.fields(t)}
    full = t_get_config("paligemma-3b")
    assert (full.head_dim, full.prefix_len, full.frontend) == (256, 256, "vision")


@pytest.mark.parametrize("name, dtype", [("paligemma-3b", "bfloat16"), (ARCH, "float32")])
def test_stub_embeds_bit_equal_to_reference(name, dtype):
    jcfg = dataclasses.replace(j_get_config(name), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(name), dtype=dtype)
    jit = jpipe.batches(jpipe.make_source(jcfg, seed=2), jcfg, batch=2, seq=12, start_step=3)
    tit = tpipe.batches(tpipe.make_source(tcfg, seed=2), tcfg, batch=2, seq=12, start_step=3)
    for _ in range(2):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want) == ["embeds", "labels", "tokens"]
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got["embeds"].dtype == getattr(torch, dtype)
        assert tuple(got["embeds"].shape) == (2, jcfg.prefix_len, jcfg.d_model)
        bits = {"bfloat16": (torch.int16, np.int16), "float32": (torch.int32, np.int32)}[dtype]
        np.testing.assert_array_equal(got["embeds"].view(bits[0]).numpy(),
                                      np.asarray(want["embeds"]).view(bits[1]))


def test_audio_frontend_and_vision_training_are_refused():
    """Training the vision prefix is ported (held in
    tests/test_torch_train_vlm.py), and so is the audio frontend with its
    encoder-decoder (tests/test_torch_encdec.py). What stays refused is
    audio frames on a decoder-only config, which has no encoder to read
    them: by the model and so the trainer. Its batches are the reference's,
    tokens and labels without frames."""
    audio = dataclasses.replace(t_get_config(ARCH), frontend="audio")
    jaudio = dataclasses.replace(j_get_config(ARCH), frontend="audio")
    got = next(tpipe.batches(tpipe.make_source(audio), audio, batch=1, seq=4))
    want = next(jpipe.batches(jpipe.make_source(jaudio), jaudio, batch=1, seq=4))
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    with pytest.raises(ValueError, match="encoder-decoders over audio frames"):
        TModel(audio).init(0, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoders over audio frames"):
        Trainer(audio, RunConfig(), device="cpu").train(batch=1, seq=4, steps=1)


def test_params_cross_bit_for_bit(pali):
    _jcfg, tcfg, jparams, tparams, *_ = pali
    jleaves, tleaves = jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a port-initialized tree has the reference's structure and shapes
    fresh = tree_leaves(TModel(tcfg).init(0, device="cpu"))
    assert [tuple(t.shape) for t in fresh] == [tuple(a.shape) for a in jleaves]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_prefix_reaches_every_block(pali, mode):
    """The stack cut to its first layer, over 288 positions: with the prefix
    of 256 the output differs from the causal one, and matches the
    reference's stack (its ``full_mask`` with the prefix) within 1e-5."""
    jcfg, tcfg = _configs(num_layers=1)
    _jc, _tc, jparams, tparams, *_ = pali
    jdec = jax.tree.map(lambda a: a[:1], jparams["decoder"])
    tdec = tree_map(lambda t: t[:1], tparams["decoder"])
    x = np.random.RandomState(8).randn(2, PREFIX + SHORT, jcfg.d_model).astype(np.float32)
    want = jax.jit(lambda p, x: jt._apply_stack(p, x, jcfg, jt.StackLayout(jcfg), mode=mode,
                                                prefix_len=PREFIX)[0])(jdec, x)
    with torch.no_grad():
        got, _, _ = tt._apply_stack(tdec, torch.from_numpy(x), tcfg, tt.StackLayout(tcfg),
                                    mode=mode, prefix_len=PREFIX)
        causal, _, _ = tt._apply_stack(tdec, torch.from_numpy(x), tcfg, tt.StackLayout(tcfg),
                                       mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert float((got - causal)[:, :PREFIX].abs().max()) > 1e-2
    np.testing.assert_allclose(got[:, PREFIX:].numpy(), causal[:, PREFIX:].numpy(),
                               atol=1e-5, rtol=1e-5)  # text rows see the whole prefix either way


def _prefill(pali, T: int):
    jcfg, tcfg, jparams, tparams, tokens, embeds = pali
    tok = tokens[T]
    jm, tm = JModel(jcfg), TModel(tcfg)
    # jitted here, after any threshold patch
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=T + STEPS))
    jlog, jc = j_prefill(jparams, {"tokens": jnp.asarray(tok, jnp.int32),
                                   "embeds": jnp.asarray(embeds)})
    with torch.no_grad():
        tlog, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(tok),
                                        "embeds": torch.from_numpy(embeds)}, max_len=T + STEPS)
    assert tuple(tlog.shape) == (4, T, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert [tuple(a.shape) for a in jleaves] == [tuple(b.shape) for b in tleaves]
    assert tleaves[0].shape[-3] == PREFIX + T + STEPS  # k's slots: the prefix keeps its own
    for a, b in zip(jleaves, tleaves):
        if b.dtype == torch.int32:  # cache positions
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=1e-4)


def test_prefill_matches_reference_dense_path(pali, monkeypatch):
    import repro_torch.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: pytest.fail("kernel called"))
    _prefill(pali, SHORT)


def test_prefill_matches_reference_flash_path(pali, monkeypatch):
    """512 positions with the threshold lowered to 512: every layer's
    prefill goes through the kernel's plain version with query tiles of 256,
    which cover the prefix (with 128 rows 0-127 would lose keys 128-255)."""
    import repro_torch.kernels.flash_attention as fa

    _lower_threshold(monkeypatch)
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], q.shape[3], kw["prefix"], kw["bq"], kw["bk"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    _prefill(pali, LONG)
    assert calls == [(PREFIX + LONG, 256, PREFIX, 256, 128)] * 2  # both layers


def test_loss_matches_reference(pali):
    jcfg, tcfg, jparams, tparams, tokens, embeds = pali
    tok = tokens[SHORT]
    labels = np.roll(tok, -1, axis=1)
    jloss, jaux = JModel(jcfg).loss(jparams, {"tokens": jnp.asarray(tok, jnp.int32),
                                              "labels": jnp.asarray(labels, jnp.int32),
                                              "embeds": jnp.asarray(embeds)})
    with torch.no_grad():
        tloss, taux = TModel(tcfg).loss(tparams, {"tokens": torch.from_numpy(tok),
                                                  "labels": torch.from_numpy(labels),
                                                  "embeds": torch.from_numpy(embeds)})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]), atol=1e-4, rtol=1e-4)


_REFERENCE_GENERATE: dict = {}


@pytest.mark.parametrize("T", [SHORT, LONG])
def test_generate_matches_reference(pali, T, monkeypatch):
    """Four requests on four emulated ranks (weights broadcast from the
    root), each rank's decode at positions after its prefix and text: the
    tokens equal to the reference's single-device run, log-probs within
    1e-4."""
    jcfg, tcfg, jparams, tparams, tokens, embeds = pali
    if T == LONG:
        _lower_threshold(monkeypatch)
    tok = tokens[T]
    if T not in _REFERENCE_GENERATE:
        _REFERENCE_GENERATE[T] = JEngine(jcfg, jparams).generate(
            {"tokens": jnp.asarray(tok, jnp.int32), "embeds": jnp.asarray(embeds)}, steps=STEPS)
    want = _REFERENCE_GENERATE[T]
    engine = TEngine(tcfg, tree_map(torch.clone, tparams), mesh=make_mesh(4, device="cpu"),
                     distribute=True, device="cpu")
    got = engine.generate({"tokens": tok, "embeds": torch.from_numpy(embeds)}, steps=STEPS)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    assert got.prefill_len == want.prefill_len == T
