"""Recurrent and state-space mixers: mLSTM and sLSTM (xLSTM) and Mamba (S6).

Plain functions over dicts of tensors, in the reference's layouts. The
sequence is processed chunkwise, as in the reference: a loop over chunks
carries the recurrent state while each chunk is computed at once (matmuls
for mLSTM; for the diagonal Mamba recurrence an inclusive scan with the
reference's combine, taken by log-step doubling). sLSTM is a loop over the
tokens. As in the reference, xLSTM's stabilized exponential gating is
log-sigmoid gating (decay factors <= 1).

The f32 projections (mLSTM's gates, sLSTM's input and recurrent weights,
Mamba's conv, dt and B/C) multiply in f32: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` at PyTorch's default, off.

All mixers expose:
    init_*(gen, cfg, dtype, lead)    -> params (``lead`` stacks layers)
    *_seq(p, x, cfg, state=None)     -> (y, final_state)   # train / prefill
    *_step(p, x1, state, cfg)        -> (y1, new_state)    # one-token decode
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _norm_init, down_proj

__all__ = [
    "chunked_diag_scan",
    "init_mlstm",
    "mlstm_seq",
    "mlstm_step",
    "init_slstm",
    "slstm_seq",
    "slstm_step",
    "init_mamba",
    "mamba_seq",
    "mamba_step",
]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) as ``logaddexp(x, 0)``: torch's
    ``softplus`` returns x itself above its threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# generic chunked diagonal-linear scan: h_t = exp(log_a_t) * h_{t-1} + b_t
# ---------------------------------------------------------------------------


def _pick_chunk(T: int, chunk: int) -> int:
    """Largest divisor of T that is <= chunk (production Ts are powers of
    two, so this returns `chunk`; odd smoke lengths degrade gracefully)."""
    L = min(chunk, T)
    while T % L:
        L -= 1
    return L


def _doubling_scan(s: torch.Tensor, h: torch.Tensor, log_a_of=None):
    """Inclusive scan over dim 1 with the reference's combine, (la1, h1) then
    (la2, h2) -> (la1 + la2, exp(la2) h1 + h2), by log-step doubling: after
    the step of offset d, position t holds the combine of the 2d positions
    ending at t. ``s`` holds each position's log decay, or, with
    ``log_a_of``, a quantity whose sums over a window ``log_a_of`` maps
    linearly to the window's log decay (Mamba's dt, at 1/16 of the state's
    size). Only differences of log decays over a window are exponentiated,
    each <= 0 where every log decay is: nothing overflows. Returns (the
    inclusive sums of ``s``, the scanned ``h``)."""
    L = h.shape[1]
    d = 1
    while d < L:
        la = s[:, d:] if log_a_of is None else log_a_of(s[:, d:])
        h = torch.cat([h[:, :d], torch.addcmul(h[:, d:], torch.exp(la), h[:, :L - d])], dim=1)
        s = torch.cat([s[:, :d], s[:, :L - d] + s[:, d:]], dim=1)
        d *= 2
    return s, h


def chunked_diag_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, chunk: int):
    """log_a, b: (B, T, *S); h0: (B, *S). Returns (h (B,T,*S), h_last)."""
    B, T = b.shape[:2]
    L = _pick_chunk(T, chunk)
    h = torch.empty_like(b)
    H = h0
    for c0 in range(0, T, L):
        la_cum, h_intra = _doubling_scan(log_a[:, c0:c0 + L], b[:, c0:c0 + L])
        h_c = h_intra + torch.exp(la_cum) * H[:, None]
        h[:, c0:c0 + L] = h_c
        H = h_c[:, -1]
    return h, H


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM, chunkwise linear attention with decay)
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg, dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    s = d**-0.5
    return {
        "wq": _norm_init(gen, lead + (d, di), s, dtype),
        "wk": _norm_init(gen, lead + (d, di), s, dtype),
        "wv": _norm_init(gen, lead + (d, di), s, dtype),
        "wg": _norm_init(gen, lead + (d, di), s, dtype),
        "wi": _norm_init(gen, lead + (d, H), s, torch.float32),
        "wf": _norm_init(gen, lead + (d, H), s, torch.float32),
        # open forget gates
        "bf": torch.full(lead + (H,), 2.0, dtype=torch.float32, device=gen.device),
        "wo": _norm_init(gen, lead + (di, d), di**-0.5, dtype),
    }


def _mlstm_qkvg(p, x, cfg):
    B, T, d = x.shape
    H = cfg.num_heads
    di = cfg.ssm_expand * d
    hd = di // H
    q = (x @ p["wq"]).reshape(B, T, H, hd) * hd**-0.5
    k = (x @ p["wk"]).reshape(B, T, H, hd) * hd**-0.5
    v = (x @ p["wv"]).reshape(B, T, H, hd)
    g = torch.sigmoid(x @ p["wg"])
    xf = x.float()
    lf = F.logsigmoid((xf @ p["wf"]) + p["bf"])  # (B,T,H)
    li = F.logsigmoid(xf @ p["wi"])
    return q, k, v, g, lf, li


def _mlstm_decay(lf, li, causal):
    """A chunk's gate terms, each (B, H, L, ...): the inclusive log-decay
    sums ``Fc``, their exponentials and the intra-chunk weights ``E``
    (``E_ts = exp(F_t - F_s + li_s)``, s <= t, else 0)."""
    Fc = torch.cumsum(lf, dim=-1)  # inclusive decay sums
    dec = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    return Fc, torch.exp(Fc), torch.exp(torch.where(causal, dec, -math.inf))


def _mlstm_partial(qf, kf, vf, eF, E, C, n):
    """A chunk's numerator (B, H, L, hd) and normalizer (B, H, L) over the
    key dims that ``qf``/``kf`` (B, H, L, k), ``C`` (B, H, k, hd) and ``n``
    (B, H, k) hold: linear in them, so the partials of disjoint key slices
    sum to the whole's."""
    # intra-chunk: scores_ts = (q_t.k_s) exp(F_t - F_s + li_s), s <= t
    scores = (qf @ kf.transpose(-1, -2)) * E
    num = scores @ vf
    # inter-chunk: exp(F_t) * (C q_t, n q_t)
    qe = qf * eF[..., None]
    num = num + qe @ C
    nq = (qe @ n[..., None])[..., 0]
    # intra normalizer: sum_s exp(F_t - F_s + li_s) (k_s . q_t)
    nq = nq + ((E @ kf) * qf).sum(-1)
    return num, nq


def _mlstm_carry(kf, vf, Fc, li, C, n):
    """The state's key rows that ``kf`` holds, carried over a chunk."""
    eL = torch.exp(Fc[..., -1])[..., None]  # (B,H,1)
    w_s = torch.exp(Fc[..., -1:] - Fc + li)  # (B,H,L)
    C = C * eL[..., None] + (kf * w_s[..., None]).transpose(-1, -2) @ vf
    n = n * eL + (w_s[..., None, :] @ kf)[..., 0, :]
    return C, n


def _mlstm_step_partial(qf, kf, vf, f, i, C, n):
    """One decode token over the key dims that ``qf``/``kf`` (B, H, k),
    ``C`` and ``n`` hold: (num (B, H, hd), nq (B, H), C, n)."""
    C = C * f[..., None] + i[..., None] * kf[..., :, None] * vf[..., None, :]
    n = n * f + i * kf
    num = (qf[..., None, :] @ C)[..., 0, :]
    nq = (qf * n).sum(-1)
    return num, nq, C, n


def _mlstm_normalize(num, nq):
    """``num / (|nq| + 1)`` of the whole key range's sums: the abs comes
    after the sum, so key slices' partials are summed before it."""
    return num / (torch.abs(nq)[..., None] + 1.0)


def mlstm_seq(p, x: torch.Tensor, cfg, state=None):
    """Chunkwise mLSTM. Returns (y, (C, n)) with C (B,H,hd,hd), n (B,H,hd)."""
    B, T, d = x.shape
    H = cfg.num_heads
    di = cfg.ssm_expand * d
    hd = di // H
    L = _pick_chunk(T, cfg.ssm_chunk)
    q, k, v, g, lf, li = _mlstm_qkvg(p, x, cfg)
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C, n = state
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    hs = torch.empty((B, T, H, hd), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, L):
        # (B, L, H, ...) -> heads before the chunk's positions
        qf, kf, vf = (a[:, c0:c0 + L].transpose(1, 2).float() for a in (q, k, v))
        lii = li[:, c0:c0 + L].transpose(1, 2)  # (B,H,L)
        Fc, eF, E = _mlstm_decay(lf[:, c0:c0 + L].transpose(1, 2), lii, causal)
        num, nq = _mlstm_partial(qf, kf, vf, eF, E, C, n)
        hs[:, c0:c0 + L] = _mlstm_normalize(num, nq).transpose(1, 2)
        C, n = _mlstm_carry(kf, vf, Fc, lii, C, n)
    h = hs.reshape(B, T, di).to(x.dtype)
    return down_proj(g * h, p["wo"]), (C, n)


def mlstm_step(p, x: torch.Tensor, state, cfg):
    """Single-token decode. x: (B, 1, d); state (C, n)."""
    B = x.shape[0]
    H = cfg.num_heads
    di = cfg.ssm_expand * cfg.d_model
    hd = di // H
    q, k, v, g, lf, li = _mlstm_qkvg(p, x, cfg)
    qf, kf, vf = (a[:, 0].reshape(B, H, hd).float() for a in (q, k, v))
    f = torch.exp(lf[:, 0])[..., None]  # (B,H,1)
    i = torch.exp(li[:, 0])[..., None]
    num, nq, C, n = _mlstm_step_partial(qf, kf, vf, f, i, *state)
    h = _mlstm_normalize(num, nq).reshape(B, 1, di).to(x.dtype)
    return down_proj(g * h, p["wo"]), (C, n)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with head-wise recurrent mixing): sequential
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg, dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    dev = gen.device
    # gate biases in the order z, i, f, o: the forget gates open at 2.0
    b = torch.cat([torch.zeros(2 * d, device=dev), torch.full((d,), 2.0, device=dev),
                   torch.zeros(d, device=dev)])
    return {
        "w": _norm_init(gen, lead + (d, 4 * d), d**-0.5, torch.float32),
        "r": _norm_init(gen, lead + (H, hd, 4 * hd), hd**-0.5, torch.float32),
        "b": b.expand(lead + (4 * d,)).clone(),
        "wo_r": _norm_init(gen, lead + (d, d), d**-0.5, dtype),
    }


def _slstm_update(z, i, f, o, c, n):
    """The cell on the pre-activations of its gates z, i, f, o and its state
    (c, n), each (B, k) over the same k units: returns (c, n, h)."""
    z = torch.tanh(z)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    c = f * c + i * z
    n = f * n + i
    h = o * c / (torch.abs(n) + 1.0)
    return (c, n, h)


def _slstm_cell(p, xt, carry, cfg):
    """xt: (B, 4d) pre-projected input; carry: (c, n, h) each (B, d)."""
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    c, n, h = carry
    hr = h.reshape(-1, H, hd)
    rec = torch.einsum("bhk,hkm->bhm", hr, p["r"]).reshape(-1, 4 * d)
    z, i, f, o = torch.split(xt + rec + p["b"], d, dim=-1)
    return _slstm_update(z, i, f, o, c, n)


def slstm_seq(p, x: torch.Tensor, cfg, state=None):
    B, T, d = x.shape
    xp = x.float() @ p["w"]  # (B,T,4d)
    if state is None:
        state = tuple(torch.zeros((B, d), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    hs = []
    for t in range(T):
        state = _slstm_cell(p, xp[:, t], state, cfg)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).to(x.dtype) @ p["wo_r"]
    return y, state


def slstm_step(p, x: torch.Tensor, state, cfg):
    xt = x[:, 0].float() @ p["w"]
    state = _slstm_cell(p, xt, state, cfg)
    y = state[2][:, None].to(x.dtype) @ p["wo_r"]
    return y, state


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan, diagonal state): chunked scan
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg, dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dev = gen.device
    # log 1..N rounded once from float64 on the host: the same bits on every
    # device (an f32 log may be an ulp off; XLA's CPU log is at log 7)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float64)).float().to(dev)
    return {
        "w_in": _norm_init(gen, lead + (d, 2 * di), d**-0.5, dtype),
        "conv": _norm_init(gen, lead + (cfg.ssm_conv, di), 0.5, torch.float32),
        "w_bc": _norm_init(gen, lead + (di, 2 * N), di**-0.5, torch.float32),
        "w_dt": _norm_init(gen, lead + (di, di), di**-0.5, torch.float32),
        # softplus(-4) ~= 0.018
        "b_dt": torch.full(lead + (di,), -4.0, dtype=torch.float32, device=dev),
        "a_log": a_log.expand(lead + (di, N)).clone(),
        "d_skip": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "w_out": _norm_init(gen, lead + (di, d), di**-0.5, dtype),
    }


def _mamba_conv(p, xb, conv_state=None):
    """Depthwise causal conv, width W. xb: (B,T,di) f32.
    conv_state: (B, W-1, di) previous inputs (or None -> zeros)."""
    W = p["conv"].shape[0]
    B, T, di = xb.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, di), dtype=xb.dtype, device=xb.device)
    xp = torch.cat([conv_state, xb], dim=1)  # (B, T+W-1, di)
    out = sum(xp[:, i:i + T] * p["conv"][i] for i in range(W))
    new_state = xp[:, -(W - 1):]
    return F.silu(out), new_state


def _mamba_scan(dt, xc, Bm, Cm, A, h, L: int):
    """The selective scan of the channels that ``dt``/``xc`` (B, T, c), ``A``
    (c, N) and the state ``h`` (B, c, N) hold, over B/C ``Bm``/``Cm`` (B, T,
    N), chunks of ``L``: returns (y (B, T, c) f32, the final h).

    Fused chunkwise, as in the reference: the (B, T, c, N) state sequence
    never materializes; each chunk's scan and its C projection run in one
    step of the loop (peak state memory O(B * L * c * N))."""
    B, T = dt.shape[:2]
    y = torch.empty((B, T, dt.shape[-1]), dtype=torch.float32, device=dt.device)
    for c0 in range(0, T, L):
        dt_c, xc_c = dt[:, c0:c0 + L], xc[:, c0:c0 + L]
        bu = (dt_c * xc_c)[..., None] * Bm[:, c0:c0 + L, None, :]  # (B,L,c,N)
        # log decay of a window: (its dt's sum) * A
        s_cum, h_intra = _doubling_scan(dt_c, bu, lambda s: s[..., None] * A)
        h_c = h_intra + torch.exp(s_cum[..., None] * A) * h[:, None]
        y[:, c0:c0 + L] = torch.einsum("bldn,bln->bld", h_c, Cm[:, c0:c0 + L])
        h = h_c[:, -1]
    return y, h


def _mamba_step_scan(dt, xc, Bm, Cm, A, h0):
    """One decode token of the channels that ``dt``/``xc`` (B, 1, c), ``A``
    and ``h0`` (B, c, N) hold: returns (y (B, c) before the skip, h)."""
    a = torch.exp(dt[:, 0, :, None] * A)  # (B,c,N)
    h = h0 * a + (dt[:, 0] * xc[:, 0])[..., None] * Bm[:, 0, None, :]
    return (h @ Cm[:, 0, :, None])[..., 0], h


def mamba_seq(p, x: torch.Tensor, cfg, state=None):
    """Returns (y, (ssm_state (B,di,N), conv_state (B,W-1,di)))."""
    B, T, d = x.shape
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    xb, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    xc, conv_state = _mamba_conv(p, xb.float(), None if state is None else state[1])
    dt = _softplus(xc @ p["w_dt"] + p["b_dt"])  # (B,T,di)
    Bm, Cm = torch.chunk(xc @ p["w_bc"], 2, dim=-1)  # (B,T,N)
    A = -torch.exp(p["a_log"])  # (di,N)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device) if state is None \
        else state[0]
    y, h = _mamba_scan(dt, xc, Bm, Cm, A, h, _pick_chunk(T, cfg.ssm_chunk))
    y = y + p["d_skip"] * xc
    y = down_proj(y.to(x.dtype) * F.silu(z), p["w_out"])
    return y, (h, conv_state)


def mamba_step(p, x: torch.Tensor, state, cfg):
    """x: (B,1,d); state: (ssm_state, conv_state)."""
    xb, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    h0, conv_state = state
    xc, conv_state = _mamba_conv(p, xb.float(), conv_state)
    dt = _softplus(xc @ p["w_dt"] + p["b_dt"])
    Bm, Cm = torch.chunk(xc @ p["w_bc"], 2, dim=-1)
    y, h = _mamba_step_scan(dt, xc, Bm, Cm, -torch.exp(p["a_log"]), h0)
    y = y + p["d_skip"] * xc[:, 0]
    y = down_proj(y[:, None].to(x.dtype) * F.silu(z), p["w_out"])
    return y, (h, conv_state)
