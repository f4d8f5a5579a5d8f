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
read).

:func:`moe_forward_ep` is ``repro``'s expert-parallel branch, which
``moe_forward`` takes when the rules carry a mesh whose model axis
divides the experts: each model rank holds E / m experts, routes the
(model-replicated) rows, dispatches only into its local slots, runs its
experts (all-gathering their weights over the data axis under ``fsdp``),
combines from its local experts and all-reduces the (B, S, D) partial
over the model axis, once.  Autograd through those collectives is
Megatron's pair: an identity forward whose backward all-reduces where a
model-replicated value enters rank-local work (the rows the experts read,
the gates the combine weighs), and an all-reduce forward whose backward
is the identity where the partial leaves.  The Switch aux loss takes its
means over the whole batch (an all-reduce over the batch axes);
``repro``'s takes them over one data shard's rows and returns that
shard's value for the whole batch, so its aux and router gradient are
off wherever the data axis is larger than 1.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RULES, Weights, _param
from repro_torch.sharding import (ShardingRules, axis_size, batch_shard_axes,
                                  mesh_axis_names, shard)


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


def _expert_ffn(cfg: ModelConfig, buf: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3=None, rules: ShardingRules = RULES) -> torch.Tensor:
    """(B, E, C, D) dispatched tokens -> (B, E, C, D) expert outputs."""
    h = torch.einsum("becd,edf->becf", buf, w1)
    # EP shards the expert axis; intra-expert TP (experts None) shards F.
    h = shard(h, rules, "batch", "experts", "capacity", None if rules.experts else "mlp")
    if cfg.act == "silu":
        h = F.silu(h) * torch.einsum("becd,edf->becf", buf, w3)
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh") * torch.einsum("becd,edf->becf", buf, w3)
    elif cfg.act == "relu2":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(cfg.act)
    return torch.einsum("becf,efd->becd", h, w2)


def _route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """(probs (B,S,E) fp32, renormalized gates (B,S,K), experts (B,S,K))."""
    k = cfg.topk_experts
    logits = (x @ router).float()                                   # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: descending, the lower expert first on ties.
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]                         # (B,S,K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, eidx


def _dispatch_slots(eidx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """(B, S*K) slot of each pick: expert * cap + its place among the row's
    picks of that expert, or the sink e * cap past the capacity."""
    b = eidx.shape[0]
    t = eidx.shape[1] * eidx.shape[2]
    # Each row's picks sorted by expert (stable, as jnp.argsort).
    flat_e = eidx.reshape(b, t)
    sort_i = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, sort_i)
    counts = F.one_hot(flat_e, e).sum(1)                              # (B,E)
    starts = counts.cumsum(1) - counts                                # exclusive
    pos_in_e = (torch.arange(t, device=eidx.device)[None, :]
                - starts.gather(1, sorted_e))
    slot_sorted = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, e * cap)
    return torch.empty_like(slot_sorted).scatter_(1, sort_i, slot_sorted)


def _combine(cfg: ModelConfig, x, slot, gate, n_slots: int, experts):
    """Dispatch the picks into ``n_slots`` slots (+ the sink), run
    ``experts`` on them, and sum each token's K outputs by its gates."""
    b, s, d = x.shape
    k = cfg.topk_experts
    t = s * k
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    xk = x[:, :, None, :].expand(b, s, k, d).reshape(b, t, d)        # token of pick
    buf = x.new_zeros((b, n_slots + 1, d)).index_put((rows, slot), xk)
    y = experts(buf[:, :n_slots])
    # the sink row reads zeros
    y_flat = torch.cat([y, y.new_zeros((b, 1, d))], dim=1)
    gath = y_flat[rows, slot].reshape(b, s, k, d)
    return (gath * gate[..., None].to(x.dtype)).sum(2)


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, rules: ShardingRules = RULES
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (output (B, S, D), aux load-balance loss, fp32 scalar).

    With a mesh whose model axis divides the experts (and ``rules.experts``
    on it) this is :func:`moe_forward_ep`, as in ``repro``."""
    if (rules.mesh is not None and rules.experts == "model"
            and cfg.n_experts % axis_size(rules.mesh, "model") == 0):
        return moe_forward_ep(cfg, p, x, rules)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk_experts
    cap = expert_capacity(cfg, s)
    dtype = x.dtype

    probs, gate, eidx = _route(cfg, x, p.w("router", dtype))
    # Switch aux loss: E * sum_e f_e * p_e (f token fraction, p prob mass).
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(eidx, e).float().sum(2).mean(dim=(0, 1)) / k
    aux = e * (me * ce).sum()

    def experts(buf):
        buf = shard(buf.reshape(b, e, cap, d), rules, "batch", "experts", "capacity",
                    "d_model")
        y = _expert_ffn(cfg, buf, p.w("w1", dtype), p.w("w2", dtype),
                        p.w("w3", dtype) if hasattr(p, "w3") else None, rules)
        y = shard(y, rules, "batch", "experts", "capacity", "d_model")
        return y.reshape(b, e * cap, d)

    out = _combine(cfg, x, _dispatch_slots(eidx, e, cap), gate, e * cap, experts)
    return shard(out, rules, "batch", "seq", "d_model"), aux


class _ToModelRanks(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    axis (Megatron's f): a model-replicated value entering rank-local work
    gets each rank's partial gradient back as the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _FromModelRanks(torch.autograd.Function):
    """All-reduce (sum) forward over the model axis, identity backward
    (Megatron's g): the partial each rank combined leaves as the whole."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverBatch(torch.autograd.Function):
    """Mean over the batch ranks of a per-rank mean (equal rows a rank);
    every rank then holds the same value, so the backward is the cotangent
    over the rank count, with no communication."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.n = 1
        for g in groups:
            x = _all_reduce(x, g)
            ctx.n *= g[0].size(g[1])
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", group))


def _gather(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather a weight's data shards (its backward reduce-scatters)."""
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_gather_tensor_autograd(w.contiguous(), dim, group))


def moe_forward_ep(cfg: ModelConfig, p: MoE, x: torch.Tensor, rules: ShardingRules
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``rules.mesh``: ``x`` (B, S, D) and the
    weights are DTensors on that mesh (placed by
    :mod:`repro_torch.launch.shardings`); returns (output (B, S, D) with
    its rows over the batch axes and replicated over the model axis, the
    aux loss replicated).  Each model rank dispatches only into its local
    slots [e0 cap, (e0 + E/m) cap) plus the sink, and one all-reduce of the
    (B, S, D) partial ends the layer."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = rules.mesh
    names = mesh_axis_names(mesh)
    e, k = cfg.n_experts, cfg.topk_experts
    m = axis_size(mesh, "model")
    e_loc = e // m
    b, s, d = x.shape
    cap = expert_capacity(cfg, s)
    dtype = x.dtype
    model_group = (mesh, names.index("model"))
    # The rows shard over the batch axes when they divide B; else every rank
    # holds them all, and the means need no all-reduce.
    row_axes = batch_shard_axes(mesh, rules, b)
    n_rows = 1
    for a in row_axes:
        n_rows *= axis_size(mesh, a)
    fsdp = rules.fsdp if rules.fsdp in names else None
    has_w3 = hasattr(p, "w3")

    def place(**shards):
        return tuple(Shard(shards[n]) if n in shards else Replicate() for n in names)

    def grad_place(value_place):
        # A weight replicated over a row axis gathers its gradient from that
        # rank's rows only: a partial sum there.
        return tuple(Partial() if n in row_axes and pl == Replicate() else pl
                     for n, pl in zip(names, value_place))

    x_place = place(**{a: 0 for a in row_axes})
    router_place = place(**({fsdp: 0} if fsdp else {}))
    w13_place = place(model=0, **({fsdp: 1} if fsdp else {}))
    w2_place = place(model=0, **({fsdp: 2} if fsdp else {}))
    out_place = x_place
    aux_place = place()

    def body(xl, router, w1, w2, w3=None):
        if fsdp is not None:
            group = (mesh, names.index(fsdp))
            router, w1, w2 = _gather(router, 0, group), _gather(w1, 1, group), _gather(w2, 2, group)
            if w3 is not None:
                w3 = _gather(w3, 1, group)
        bl = xl.shape[0]
        e0 = mesh.get_local_rank("model") * e_loc
        probs, gate, eidx = _route(cfg, xl, router)
        row_groups = [(mesh, names.index(a)) for a in row_axes]
        me = _MeanOverBatch.apply(probs.mean(dim=(0, 1)), row_groups)
        ce = F.one_hot(eidx, e).float().sum(2).mean(dim=(0, 1)) / k
        for g in row_groups:
            ce = _all_reduce(ce, g)
        aux = e * (me * (ce / n_rows)).sum()

        slot = _dispatch_slots(eidx, e, cap) - e0 * cap
        in_range = (slot >= 0) & (slot < e_loc * cap)
        slot = torch.where(in_range, slot, e_loc * cap)

        def experts(buf):
            y = _expert_ffn(cfg, buf.reshape(bl, e_loc, cap, d), w1, w2, w3)
            return y.reshape(bl, e_loc * cap, d)

        partial = _combine(cfg, _ToModelRanks.apply(xl, model_group), slot,
                           _ToModelRanks.apply(gate, model_group), e_loc * cap, experts)
        return _FromModelRanks.apply(partial, model_group), aux

    args = [x, p.w("router", dtype), p.w("w1", dtype), p.w("w2", dtype)]
    in_place = [x_place, router_place, w13_place, w2_place]
    if has_w3:
        args.append(p.w("w3", dtype))
        in_place.append(w13_place)
    grads = [x_place] + [grad_place(pl) for pl in in_place[1:]]
    fn = local_map(body, out_placements=(out_place, aux_place), in_placements=tuple(in_place),
                   in_grad_placements=tuple(grads), redistribute_inputs=True)
    return fn(*args)
