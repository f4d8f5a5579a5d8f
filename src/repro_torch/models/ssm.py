"""Mamba-2 SSD (state-space duality) block: port of ``repro.models.ssm``.

The sequence is split into chunks of ``ssm_chunk`` tokens; within a chunk
the interactions are dense (Q, Q) products, and only the chunk-boundary
states thread through a loop over the nc = S / Q chunks (``repro``'s
``lax.scan``).  Decode keeps a constant-size state (B, H, N, P).

:class:`SSM` holds ``repro``'s leaves in its layout (ngroups 1, B and C
shared across heads): ``in_proj`` (D, 2 di + 2 N + H) -> z, x, B, C, dt;
``conv_w`` (cw, di + 2 N) and ``conv_b``, a depthwise causal conv over
[x, B, C]; ``a_log``, ``d_skip``, ``dt_bias`` (H,); ``norm_scale`` (di,),
the gated RMSNorm; ``out_proj`` (di, D).  ``reset`` draws ``ssm_init``'s
distributions.

:func:`ssm_forward` keeps ``repro``'s order of operations: dt's softplus
(plus ``dt_bias``) and the cumulative log-decay in fp32, the upper
triangle masked to -1e30 before the exp (an overflow to inf there would
give NaN gradients), the decays cast to the compute dtype, S padded to a
multiple of the chunk with dt = 0 (identity decay, zero input), and the
inter-chunk recurrence in the compute dtype.  With ``emit_cache`` it also
returns the prefill's :class:`SSMCache`, as ``repro``'s
``_ssm_final_state`` computes it: the same chunk states carried in fp32,
and the conv tail, the last cw - 1 pre-conv inputs, left-padded with zeros
when S < cw - 1.  :func:`ssm_decode` advances one token and updates the
cache in place.

Two differences from ``repro``, both where its numerics fail: the conv
tail stays in the compute dtype (``repro`` stores it in bf16 in any run,
so its fp32 prefill then decode misses its forward), and the intra-chunk
decay exponents are segment sums da_{j+1} + ... + da_i taken directly,
where ``repro`` subtracts prefix sums cum_i - cum_j.  Over a chunk of 256
those prefix sums grow large and their difference keeps few bits: at a
chunk of 256 ``repro``'s forward misses the float64 recurrence where the
port's stays within 1e-4 / 1e-5 (``tests/test_torch_ssm.py``), and on an
H100 mamba2_780m's 48 layers missed their own prefill and decode by
6.3e-4 with the differences (``chip_smoke.py``'s ``ssm_full_width``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RULES, Weights, _param
from repro_torch.sharding import (ShardingRules, axis_size, batch_shard_axes,
                                  mesh_axis_names, shard)


class SSM(Weights):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * n
        self.in_proj = _param((d, 2 * di + 2 * n + h), device)
        self.conv_w = _param((cfg.ssm_conv_width, conv_ch), device)
        self.conv_b = _param((conv_ch,), device)
        self.a_log = _param((h,), device)
        self.d_skip = _param((h,), device)
        self.dt_bias = _param((h,), device)
        self.norm_scale = _param((di,), device)
        self.out_proj = _param((di, d), device)

    def reset(self, gen: torch.Generator) -> None:
        """``ssm_init``: N(0, 1/fan_in) projections, N(0, 1/cw) conv
        weights, A = -(1 .. H), D 1, the biases 0, the norm scale 1."""
        for name in ("in_proj", "conv_w", "out_proj"):
            w = getattr(self, name)
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                    / math.sqrt(w.shape[0]))
        h = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.linspace(1.0, float(h), h,
                                                  device=self.a_log.device)))
        self.conv_b.zero_()
        self.d_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.norm_scale.fill_(1.0)


@dataclasses.dataclass
class SSMCache:
    """Decode-time state of one SSM layer."""

    h: torch.Tensor     # (B, H, N, P) fp32 state
    conv: torch.Tensor  # (B, cw - 1, di + 2N) the last pre-conv inputs, compute dtype


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> SSMCache:
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return SSMCache(
        h=torch.zeros((batch, h, n, pd), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n), dtype=dtype,
                         device=device),
    )


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: xbc (B, S, C), w (cw, C) -> (B, S, C)."""
    cw, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(cw):
        out = out + pad[:, i : i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di : 2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n :]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` (x times the logistic) in the form whose roundings
    are XLA's: in bf16 the logistic expanded as 1 / (1 + exp(-x)), each
    step rounded (``F.silu`` rounds once, and its bf16 results differ in
    the last bit); in fp32 ``x * sigmoid(x)``."""
    if x.dtype == torch.float32:
        return x * torch.sigmoid(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def _gated_norm(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    gf = (y * _silu(z)).float()
    ms = (gf * gf).mean(dim=-1, keepdim=True)
    return (gf * torch.rsqrt(ms + 1e-6) * p.norm_scale).to(y.dtype)


def _decay_rates(p: SSM, dt_raw: torch.Tensor):
    """(dt, its log-decay dt * A), both fp32."""
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    return dt, dt * -torch.exp(p.a_log)


def _ssd(cfg: ModelConfig, xin, bmat, cmat, dt, da, d_skip, emit_cache: bool):
    """The chunked SSD of (B, S, H P) inputs, their (B, S, N) B and C and
    (B, S, H) dt and log-decays: (y (B, S, H P) with the D skip, the final
    state (B, H, N, P) in fp32 or None).  H is the inputs' own, so a rank
    can run it on its heads."""
    bsz, s, _ = xin.shape
    n, h, pd = bmat.shape[-1], dt.shape[-1], cfg.ssm_head_dim
    q = cfg.ssm_chunk
    dtype = xin.dtype

    pad = (-s) % q  # dt = 0 on the padding: identity decay, zero input
    if pad:
        xin, bmat, cmat, dt, da = (F.pad(t, (0, 0, 0, pad))
                                   for t in (xin, bmat, cmat, dt, da))
    nc = (s + pad) // q

    xh = xin.reshape(bsz, nc, q, h, pd)
    bc = bmat.reshape(bsz, nc, q, n)
    cc = cmat.reshape(bsz, nc, q, n)
    dtc = dt.reshape(bsz, nc, q, h)
    cum = torch.cumsum(da.reshape(bsz, nc, q, h), dim=2)  # (B,nc,Q,H) inclusive, fp32
    xbar = xh * dtc[..., None].to(dtype)  # dt-scaled input

    # intra-chunk: (L o C B^T) xbar.  L's exponents are the segment sums
    # da_{j+1} + ... + da_i, summed directly (a masked cumsum) rather than
    # as cum_i - cum_j, which loses the last bits of both to cancellation;
    # the upper triangle is masked before the exp.
    tri = torch.ones((q, q), dtype=torch.bool, device=xin.device).tril()
    dac = da.reshape(bsz, nc, q, h)
    li = dac[:, :, :, None, :].expand(bsz, nc, q, q, h).masked_fill(
        tri.tril(-1).logical_not()[None, None, :, :, None], 0.0).cumsum(dim=2)
    li = li.masked_fill(~tri[None, None, :, :, None], -1e30)  # (B,nc,Qi,Qj,H)
    decay = torch.exp(li).to(dtype)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xbar)

    # chunk states, then the recurrence over chunks
    cum_end = cum[:, :, -1:, :]
    seg = torch.exp(li[:, :, -1]).to(dtype)  # decay from j to the chunk's end
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, seg, xbar)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum_end[:, :, 0, :]).to(dtype)  # (B,nc,H)
    hstate = xin.new_zeros((bsz, h, n, pd))
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)  # the state entering chunk c
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", cc, hprevs, torch.exp(cum).to(dtype))
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, pd)[:, :s]
    y = y + xin.reshape(bsz, nc * q, h, pd)[:, :s] * d_skip[None, None, :, None]
    if not emit_cache:
        return y.reshape(bsz, s, h * pd), None
    # _ssm_final_state: the same chunk states carried in fp32
    hfinal = torch.zeros((bsz, h, n, pd), dtype=torch.float32, device=xin.device)
    for c in range(nc):
        hfinal = hfinal * chunk_decay[:, c, :, None, None].float() + states[:, c].float()
    return y.reshape(bsz, s, h * pd), hfinal


def _ssd_sharded(cfg: ModelConfig, xin, bmat, cmat, dt, da, d_skip, emit_cache: bool,
                 rules: ShardingRules):
    """:func:`_ssd`; on DTensors, on each rank's rows and heads (heads over
    the model axis where it divides them, else replicated there): a
    DTensor cannot run its einsums, which flatten (batch, heads) into one
    dim sharded over two mesh axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if rules.mesh is None or not isinstance(xin, DTensor):
        return _ssd(cfg, xin, bmat, cmat, dt, da, d_skip, emit_cache)
    mesh = rules.mesh
    row_axes = batch_shard_axes(mesh, rules, xin.shape[0])
    rows, heads = [], []
    for name in mesh_axis_names(mesh):
        n = axis_size(mesh, name)
        rows.append(Shard(0) if name in row_axes else Replicate())
        heads.append(name == "model" and n > 1 and cfg.ssm_heads % n == 0)
    rows = tuple(rows)

    def place(head_dim):
        return tuple(Shard(head_dim) if hd else r for r, hd in zip(rows, heads))

    def ssd(*args):
        y, hfinal = _ssd(cfg, *args, emit_cache)
        return (y, hfinal) if emit_cache else y

    hfinal_place = tuple(Shard(1) if hd else r for r, hd in zip(rows, heads))
    fn = local_map(ssd, out_placements=(place(2), hfinal_place) if emit_cache else list(place(2)),
                   in_placements=(place(2), rows, rows, place(2), place(2),
                                  tuple(Shard(0) if hd else Replicate() for hd in heads)),
                   redistribute_inputs=True)
    out = fn(xin, bmat, cmat, dt, da, d_skip)
    return out if emit_cache else (out, None)


def ssm_forward(cfg: ModelConfig, p: SSM, x: torch.Tensor, *, emit_cache: bool = False,
                rules: ShardingRules = RULES) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence SSD: x (B, S, D) -> ((B, S, D), the prefill's cache or None)."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    dtype = x.dtype

    zxbcdt = x @ p.w("in_proj", dtype)
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    z = shard(z, rules, "batch", None, "mlp")
    xbc = _silu(_causal_conv(xbc_raw, p.w("conv_w", dtype), p.w("conv_b", dtype)))
    xin, bmat, cmat = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    xin = shard(xin, rules, "batch", None, "mlp")
    dt, da = _decay_rates(p, dt_raw)

    y, hfinal = _ssd_sharded(cfg, xin, bmat, cmat, dt, da, p.w("d_skip", dtype),
                             emit_cache, rules)
    y = shard(y.reshape(bsz, s, di), rules, "batch", None, "mlp")
    y = _gated_norm(p, y, z)
    out = shard(y @ p.w("out_proj", dtype), rules, "batch", "seq", "d_model")
    if not emit_cache:
        return out, None

    tail = xbc_raw[:, max(0, s - (cfg.ssm_conv_width - 1)) :, :]
    tail = F.pad(tail, (0, 0, cfg.ssm_conv_width - 1 - tail.shape[1], 0))
    return out, SSMCache(h=hfinal, conv=tail.contiguous())


def ssm_decode(cfg: ModelConfig, p: SSM, x: torch.Tensor, cache: SSMCache,
               rules: ShardingRules = RULES) -> Tuple[torch.Tensor, SSMCache]:
    """One token a batch row: x (B, 1, D) -> (B, 1, D); ``cache`` is updated
    in place (its state in fp32, its conv window in the cache's dtype)."""
    bsz = x.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype

    # (rows unsharded under fsdp, the projection comes back as partial sums
    # over the data axis: sum them before the state's einsums)
    zxbcdt = shard(x[:, 0, :] @ p.w("in_proj", dtype), rules, "batch", "mlp")
    z, xbc_new, dt_raw = _split_proj(cfg, zxbcdt)
    window = torch.cat([cache.conv.to(dtype), xbc_new[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window, p.w("conv_w", dtype))
    conv_out = _silu(conv_out + p.w("conv_b", dtype))

    xin = conv_out[:, :di].reshape(bsz, h, pd)
    bvec, cvec = conv_out[:, di : di + n], conv_out[:, di + n :]
    dt, da = _decay_rates(p, dt_raw)  # (B, H)
    xbar = xin.float() * dt[:, :, None]
    hnew = cache.h * torch.exp(da)[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", bvec.float(), xbar)
    y = torch.einsum("bn,bhnp->bhp", cvec.float(), hnew).to(dtype)
    y = y + xin * p.w("d_skip", dtype)[None, :, None]
    y = _gated_norm(p, y.reshape(bsz, 1, di), z[:, None, :])
    cache.h.copy_(hnew)
    cache.conv.copy_(window[:, 1:, :])
    return shard(y @ p.w("out_proj", dtype), rules, "batch", "seq", "d_model"), cache
