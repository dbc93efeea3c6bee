"""Recurrent mixers: RG-LRU (Griffin / recurrentgemma) and the xLSTM blocks
(the port of ``repro/models/recurrent.py``).

RG-LRU is a gated linear recurrence: prefill runs it as a log-step
(Hillis-Steele) scan over the sequence, decode as the cell update.  mLSTM
prefills in its stabilized parallel form (an (S, S) decay matrix per head)
and decodes with the (C, n, m) state update.  sLSTM's hidden-to-gate
feedback is nonlinear, so it is a loop over the sequence in both modes.

States, as the reference returns them: RG-LRU ``(h (B, R) in x's type,
conv (B, cw-1, R))``; mLSTM ``(C (B, H, hd, hd), n (B, H, hd), m (B, H))``
in fp32; sLSTM ``(c, n, h, m)`` each (B, H, hd) fp32; ``m`` starts at
-1e30.  The xLSTM blocks use ``hd = d_model // n_heads``, not the
config's ``head_dim``.

Under an ambient mesh with a "model" axis above 1 each mixer runs on the
blocks ``distributed.sharding`` gives this rank, and its output is whole on
every rank.  RG-LRU: ``wx``, ``wgate`` and ``conv`` are column blocks of the
``d_rnn`` channels, so the input branch, the conv, the recurrence and the
gelu gate run on the rank's channels; ``wi`` and ``wr`` (``(R, R)``,
column blocks) need the whole conv output, which one gather over "model"
gives; ``lam`` is replicated and cut; ``wo_r`` is row-sharded, so the
rank's products are summed (``layers._partial_sum``).  mLSTM and sLSTM: a
column block of ``wq``/``wk``/``wv``/``wog``, of ``wi``/``wf`` (``(d,
H)``) and of ``in_*``, and a block of ``r_*`` (``(H, hd, hd)``), are the
rank's heads where they divide the axis, and each head's recurrence is its
own; ``wo_m``/``wo_s`` are row-sharded.  Where the channels or heads do not
divide, the rules leave the layer's leaves whole or split, and the layer
runs whole on every rank from its gathered weights.

A decode step under the mesh takes its state as the rank's blocks under
the cache's specs (``layers.DecodeShard``) and gives the new state back in
the same blocks.  Those blocks are the rules', not the ones the mixer
computes on, so each leaf is regrouped (``sharding.regroup``) to the
compute layout (the activations' batch rows; the rank's channels or
heads on "model" where the mixer runs tensor-parallel) and back: the
RG-LRU's ``h`` and conv state, whole over "model" by the rules, are cut to
the rank's channels and the new ones gathered; mLSTM's ``C``, which the
rules split on its third dim (ROADMAP C20) or, for a batch of 1, on its
heads over every axis, is gathered and cut to the rank's heads, and back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm, hints, sharding
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, logistic, mm

__all__ = ["rglru_params", "rglru", "rglru_init_state", "mlstm_params",
           "mlstm", "mlstm_init_state", "slstm_params", "slstm",
           "slstm_init_state", "linear_scan"]

Params = Dict[str, torch.Tensor]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def rglru_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, r = cfg.d_model, cfg.d_rnn_
    dev = gen.device
    lam = torch.log(torch.expm1(torch.linspace(0.9, 4.0, r,
                                               dtype=torch.float32,
                                               device=dev)))
    return {
        "wx": dense_init(gen, (d, r), dtype),
        "wgate": dense_init(gen, (d, r), dtype),
        "conv": dense_init(gen, (cfg.conv_width, r), dtype, scale=0.1),
        "wi": dense_init(gen, (r, r), dtype),
        "wr": dense_init(gen, (r, r), dtype),
        "lam": lam,     # a^c ~ 0.9..0.999 (Griffin's appendix), fp32
        "wo_r": dense_init(gen, (r, d), dtype),
    }


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; u: (B, S, R), w: (cw, R).  The taps are summed
    in u's type in the reference's order, ``((t0 + t1) + t2) + ...``.
    ``state`` (B, cw-1, R) holds the previous inputs (decode); returns
    ``(y, new_state)``."""
    cw = w.shape[0]
    B, S, R = u.shape
    if state is None:
        state = torch.zeros((B, cw - 1, R), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)
    y = ext[:, 0:S] * w[0]
    for i in range(1, cw):
        y = y + ext[:, i:i + S] * w[i]
    new_state = ext[:, -(cw - 1):] if cw > 1 else None
    return y, new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a log-step
    scan (Hillis-Steele: step ``d`` combines each element with the one ``d``
    before it).  The reference's ``associative_scan`` combines in another
    tree, so fp32 results differ in the last bits."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _model_group(state, shard):
    """The ambient "model" axis ``(tp, rank, group)`` where it is above 1,
    else None; a state there needs its ``shard``."""
    m = L.model_axis()
    if m is None or m[0] == 1:
        return None
    if state is not None and shard is None:
        raise ValueError(L.DECODE_NEEDS_SPECS)
    return m


def _regroup(state, src, dst):
    """Each leaf of a state from its blocks under ``src`` to ``dst`` (the
    spec tuples of its leaves)."""
    mesh = hints.current_mesh()
    return tuple(sharding.regroup(t, a, b, mesh)
                 for t, a, b in zip(state, src, dst))


def _whole_layer(p: Params, cols: Dict[str, int], rows: Dict[str, int]
                 ) -> Params:
    """The layer's logical weights from this rank's blocks: ``cols`` (name
    -> width) are column-sharded where the width divides the model axis,
    ``rows`` (name -> height) row- or head-sharded likewise."""
    return {k: L._whole(v, cols[k]) if k in cols
            else L._whole_rows(v, rows[k]) if k in rows else v
            for k, v in p.items()}


def rglru(p: Params, x: torch.Tensor, cfg: ModelConfig,
          state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          shard: Optional[L.DecodeShard] = None):
    """RG-LRU mixer.  x: (B, S, d); state = (h (B, R), conv (B, cw-1, R)) for
    decode (``shard``: its blocks under the mesh).  Returns (out (B, S, d),
    new_state); on a model axis without a ``shard`` (a full pass), the new
    state is the rank's channels'."""
    B, S, _ = x.shape
    m = _model_group(state, shard)
    if m is not None and cfg.d_rnn_ % m[0]:
        m = None             # the rules leave every leaf whole
    if shard is not None:
        ch = "model" if m is not None else None
        comp = ((shard.batch, ch), (shard.batch, None, ch))
        state = _regroup(state, shard.spec, comp)
    xin, lam = x, p["lam"]
    if m is not None:
        tp, rank, group = m
        width = cfg.d_rnn_ // tp
        xin = comm.copy_to(x, group)
        lam = comm.copy_to(lam, group)[rank * width:(rank + 1) * width]
    u = mm(xin, p["wx"])
    u, new_conv = _causal_conv1d(u, p["conv"],
                                 state[1] if state is not None else None)
    uf = u.float()
    # the gate products take every channel: the rank's are gathered
    uw = uf if m is None else comm.gather(u, group, -1).float()
    i_gate = logistic(uw @ p["wi"].float())
    r_gate = logistic(uw @ p["wr"].float())
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -_C_RGLRU * torch.logaddexp(lam, torch.zeros_like(lam)) * r_gate
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_gate * uf)
    if state is None:
        h = linear_scan(a, gated_x)
        new_h = h[:, -1]
    else:
        h_t = state[0].float()
        hs = []
        for t in range(S):
            h_t = a[:, t] * h_t + gated_x[:, t]
            hs.append(h_t)
        h = torch.stack(hs, dim=1)
        new_h = h_t
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(mm(xin, p["wgate"]).float(), approximate="tanh")
    y = (h * gate).to(x.dtype)
    out = mm(y, p["wo_r"]) if m is None \
        else L._partial_sum(y, p["wo_r"], group)
    new_state = (new_h.to(x.dtype), new_conv)
    if shard is not None:
        new_state = _regroup(new_state, comp, shard.spec)
    return out, new_state


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device):
    r = cfg.d_rnn_
    return (torch.zeros((batch, r), dtype=dtype, device=device),
            torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype,
                        device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(gen, (d, d), dtype),
        "wk": dense_init(gen, (d, d), dtype),
        "wv": dense_init(gen, (d, d), dtype),
        "wi": dense_init(gen, (d, h), torch.float32),
        "wf": dense_init(gen, (d, h), torch.float32),
        "wog": dense_init(gen, (d, d), dtype),
        "wo_m": dense_init(gen, (d, d), dtype),
    }


def _heads(p: Params, cfg: ModelConfig, state, shard, cols: Dict[str, int],
           rows: Dict[str, int]):
    """``(params, model group or None)`` of an xLSTM mixer: on a model
    axis above 1 that divides the heads, the rank's blocks (its heads) and
    the group; where the heads do not divide, the whole layer's weights
    (gathered) and None; else as given."""
    m = _model_group(state, shard)
    if m is None:
        return p, None
    if cfg.n_heads % m[0]:
        return _whole_layer(p, cols, rows), None
    return p, m[2]


def _head_specs(shard, group, dims):
    """The compute layout of an xLSTM state whose leaves have ``dims``
    dims: the activations' batch rows, the rank's heads (dim 1) where the
    mixer runs on them."""
    h = "model" if group is not None else None
    return tuple((shard.batch, h) + (None,) * (n - 2) for n in dims)


def mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig,
          state: Optional[Tuple] = None,
          shard: Optional[L.DecodeShard] = None):
    """mLSTM mixer: the stabilized parallel form (prefill, which builds
    (B, S, S, H) fp32 tensors) or the recurrent form (decode, ``state`` =
    (C, n, m); ``shard``: its blocks under the mesh).  Returns (out,
    new_state); on a model axis without a ``shard``, the new state is the
    rank's heads'."""
    B, S, d = x.shape
    hd = d // cfg.n_heads
    p, group = _heads(p, cfg, state, shard,
                      {**dict.fromkeys(("wq", "wk", "wv", "wog"), d),
                       "wi": cfg.n_heads, "wf": cfg.n_heads}, {"wo_m": d})
    if shard is not None:
        comp = _head_specs(shard, group, (4, 3, 2))
        state = _regroup(state, shard.spec, comp)
    xin = x if group is None else comm.copy_to(x, group)
    H = p["wi"].shape[1]                     # the heads these blocks hold
    q = mm(xin, p["wq"]).reshape(B, S, H, hd)
    k = mm(xin, p["wk"]).reshape(B, S, H, hd) / (hd ** 0.5)
    v = mm(xin, p["wv"]).reshape(B, S, H, hd)
    xf = xin.float()
    log_i = mm(xf, p["wi"])                                # (B, S, H)
    log_f = F.logsigmoid(mm(xf, p["wf"]))                  # (B, S, H) <= 0
    qf, kf, vf = q.float(), k.float(), v.float()

    if state is None:
        Fc = torch.cumsum(log_f, dim=1)
        # L[t, s] = log_i[s] + F[t] - F[s] for s <= t
        Lmat = Fc[:, :, None, :] + (log_i - Fc)[:, None, :, :]  # (B,t,s,H)
        tpos = torch.arange(S, device=x.device)
        causal = tpos[:, None] >= tpos[None, :]
        Lmat = torch.where(causal[None, :, :, None], Lmat, -torch.inf)
        m = Lmat.amax(dim=2)                               # (B, S, H)
        Dmat = torch.exp(Lmat - m[:, :, None, :])
        Smat = torch.einsum("bthd,bshd->btsh", qf, kf) * Dmat
        norm = torch.maximum(Smat.sum(dim=2).abs(), torch.exp(-m))
        h = torch.einsum("btsh,bshd->bthd", Smat / norm[:, :, None, :], vf)
        # the decode state at the last position
        mT = m[:, -1]
        decay = torch.exp(Fc[:, -1][:, None, :] - Fc + log_i
                          - mT[:, None, :])
        C_end = torch.einsum("bsh,bshd,bshe->bhde", decay, kf, vf)
        n_end = torch.einsum("bsh,bshd->bhd", decay, kf)
        new_state = (C_end, n_end, mT)
    else:
        C, n, m_prev = state
        hs = []
        for t in range(S):
            m_new = torch.maximum(log_f[:, t] + m_prev, log_i[:, t])  # (B,H)
            fdec = torch.exp(log_f[:, t] + m_prev - m_new)[:, :, None]
            idec = torch.exp(log_i[:, t] - m_new)[:, :, None]
            kt, vt, qt = kf[:, t], vf[:, t], qf[:, t]
            C = fdec[..., None] * C + idec[..., None] * torch.einsum(
                "bhd,bhe->bhde", kt, vt)
            n = fdec * n + idec * kt
            num = torch.einsum("bhde,bhd->bhe", C, qt)
            den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(),
                                torch.exp(-m_new))[:, :, None]
            hs.append(num / den)
            m_prev = m_new
        h = torch.stack(hs, dim=1)
        new_state = (C, n, m_prev)

    og = logistic(mm(xin, p["wog"]))
    y = og * h.reshape(B, S, H * hd).to(x.dtype)
    out = mm(y, p["wo_m"]) if group is None \
        else L._partial_sum(y, p["wo_m"], group)
    if shard is not None:
        new_state = _regroup(new_state, comp, shard.spec)
    return out, new_state


def mlstm_init_state(cfg: ModelConfig, batch: int, device):
    H = cfg.n_heads
    hd = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, hd, hd), **f32),
            torch.zeros((batch, H, hd), **f32),
            torch.full((batch, H), -1e30, **f32))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
_SLSTM_GATES = ("i", "f", "z", "o")


def slstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    p = {f"in_{g}": dense_init(gen, (d, d), torch.float32)
         for g in _SLSTM_GATES}
    for g in _SLSTM_GATES:
        p[f"r_{g}"] = dense_init(gen, (H, hd, hd), torch.float32,
                                 scale=hd ** -0.5)
    p["wo_s"] = dense_init(gen, (d, d), dtype)
    return p


def slstm(p: Params, x: torch.Tensor, cfg: ModelConfig,
          state: Optional[Tuple] = None,
          shard: Optional[L.DecodeShard] = None):
    """sLSTM mixer: a loop over the sequence (hidden-to-gate recurrence) in
    fp32, one batched product of the four recurrent matrices a step.
    state = (c, n, h, m), each (B, H, hd) (``shard``: their blocks under
    the mesh).  Returns (out, new_state); on a model axis without a
    ``shard``, the new state is the rank's heads'."""
    B, S, d = x.shape
    hd = d // cfg.n_heads
    p, group = _heads(p, cfg, state, shard,
                      {f"in_{g}": d for g in _SLSTM_GATES},
                      {"wo_s": d, **{f"r_{g}": cfg.n_heads
                                     for g in _SLSTM_GATES}})
    if shard is not None:
        comp = _head_specs(shard, group, (3, 3, 3, 3))
        state = _regroup(state, shard.spec, comp)
    xin = x if group is None else comm.copy_to(x, group)
    H = p["r_i"].shape[0]                    # the heads these blocks hold
    xf = xin.float()
    z = [mm(xf, p[f"in_{g}"]).reshape(B, S, H, hd) for g in _SLSTM_GATES]
    if state is None:
        state = _slstm_zeros(B, H, hd, x.device)
    c, n, h, m = state
    # (H, hd, 4 hd): each gate's recurrent product is its own columns
    r = torch.cat([p[f"r_{g}"] for g in _SLSTM_GATES], dim=-1).float()
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, r).split(hd, dim=-1)
        gi = z[0][:, t] + rec[0]
        gf = z[1][:, t] + rec[1]
        gz = torch.tanh(z[2][:, t] + rec[2])
        go = logistic(z[3][:, t] + rec[3])
        log_f = F.logsigmoid(gf)
        m_new = torch.maximum(log_f + m, gi)
        fdec = torch.exp(log_f + m - m_new)
        idec = torch.exp(gi - m_new)
        c = fdec * c + idec * gz
        n = fdec * n + idec
        h = go * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    out = mm(y, p["wo_s"]) if group is None \
        else L._partial_sum(y, p["wo_s"], group)
    if shard is not None:
        return out, _regroup((c, n, h, m), comp, shard.spec)
    return out, (c, n, h, m)


def _slstm_zeros(batch: int, H: int, hd: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    zero = torch.zeros((batch, H, hd), **f32)
    return (zero, zero, zero, torch.full((batch, H, hd), -1e30, **f32))


def slstm_init_state(cfg: ModelConfig, batch: int, device):
    return _slstm_zeros(batch, cfg.n_heads, cfg.d_model // cfg.n_heads,
                        device)
