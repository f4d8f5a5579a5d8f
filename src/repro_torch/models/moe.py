"""Top-k MoE FFN with sort-based dispatch: port of ``repro.models.moe``.

:class:`MoE` holds ``repro``'s leaves in its layout: ``router`` (d, E),
``w1`` and ``w3`` (E, d, f), ``w2`` (E, f, d); ``reset`` draws
``moe_init``'s distributions in its order.  :func:`moe_forward` is the
non-mesh branch of ``repro``'s ``moe_forward``: softmax routing in fp32,
the top-k experts of each token (the lower expert first on ties, as
``lax.top_k``), a stable per-row sort of the (token, k) picks by expert,
a capacity of ``expert_capacity`` slots an expert with the picks beyond it
sent to one sink slot that is sliced away, the expert FFN as batched
products over the expert axis, the combine gather weighted by the
renormalized gates, and the Switch load-balance aux loss.

The dispatch writes unique slots plus the sink (``index_put`` with
repeated indices has no defined winner on the card; the sink is never
read).  Expert parallelism over a mesh (``repro``'s ``moe_forward_ep``,
``shard_map``) waits for ROADMAP module 13e.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Weights, _param


class MoE(Weights):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, e), device)
        self.w1 = _param((e, d, f), device)
        self.w2 = _param((e, f, d), device)
        if cfg.act in ("silu", "gelu"):
            self.w3 = _param((e, d, f), device)

    def reset(self, gen: torch.Generator) -> None:
        """``moe_init``: N(0, 1/d) router, w1 and w3, N(0, 1/f) w2."""
        d, f = self.w1.shape[1], self.w1.shape[2]
        for name, scale in (("router", 1 / math.sqrt(d)), ("w1", 1 / math.sqrt(d)),
                            ("w2", 1 / math.sqrt(f)), ("w3", 1 / math.sqrt(d))):
            if hasattr(self, name):
                w = getattr(self, name)
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * scale)


def expert_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots an expert: ceil(cf * seq * k / E), at least 8, a multiple of 8."""
    c = math.ceil(cfg.capacity_factor * seq * cfg.topk_experts / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(cfg: ModelConfig, p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """(B, E, C, D) dispatched tokens -> (B, E, C, D) expert outputs."""
    dtype = buf.dtype
    h = torch.einsum("becd,edf->becf", buf, p.w("w1", dtype))
    if cfg.act == "silu":
        h = F.silu(h) * torch.einsum("becd,edf->becf", buf, p.w("w3", dtype))
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh") * torch.einsum("becd,edf->becf", buf,
                                                         p.w("w3", dtype))
    elif cfg.act == "relu2":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(cfg.act)
    return torch.einsum("becf,efd->becd", h, p.w("w2", dtype))


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (output (B, S, D), aux load-balance loss, fp32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk_experts
    t = s * k
    cap = expert_capacity(cfg, s)
    dtype = x.dtype

    logits = (x @ p.w("router", dtype)).float()                     # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: descending, the lower expert first on ties.
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]                         # (B,S,K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss: E * sum_e f_e * p_e (f token fraction, p prob mass).
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(eidx, e).float().sum(2).mean(dim=(0, 1)) / k
    aux = e * (me * ce).sum()

    # Dispatch: each row's picks sorted by expert (stable, as jnp.argsort).
    flat_e = eidx.reshape(b, t)
    sort_i = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, sort_i)
    counts = F.one_hot(flat_e, e).sum(1)                              # (B,E)
    starts = counts.cumsum(1) - counts                                # exclusive
    pos_in_e = (torch.arange(t, device=x.device)[None, :]
                - starts.gather(1, sorted_e))
    slot_sorted = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, e * cap)
    slot = torch.empty_like(slot_sorted).scatter_(1, sort_i, slot_sorted)

    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    xk = x[:, :, None, :].expand(b, s, k, d).reshape(b, t, d)        # token of pick
    buf = x.new_zeros((b, e * cap + 1, d)).index_put((rows, slot), xk)
    y = _expert_ffn(cfg, p, buf[:, : e * cap].reshape(b, e, cap, d))

    # Combine: each token's k expert outputs (the sink row reads zeros).
    y_flat = torch.cat([y.reshape(b, e * cap, d), y.new_zeros((b, 1, d))], dim=1)
    gath = y_flat[rows, slot].reshape(b, s, k, d)
    out = (gath * gate[..., None].to(dtype)).sum(2)
    return out, aux


def moe_forward_ep(*args, **kwargs):
    raise NotImplementedError(
        "moe_forward_ep (experts sharded over a mesh's model axis) waits for its "
        "port: ROADMAP.md module 13e (H100 counterparts of the mesh tools and "
        "ShardingRules)")
