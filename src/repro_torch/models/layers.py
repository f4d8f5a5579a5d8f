"""Decoder and encoder building blocks: port of ``repro.models.layers``.

Each block is an ``nn.Module`` holding its weights in ``repro``'s layout
(``wq`` is ``(d_model, n_heads * head_dim)``, used as ``x @ wq``); its
constructor allocates them and ``reset`` draws ``repro``'s initial values
(the counterparts of ``norm_init``, ``attn_init``, ``ffn_init`` and
``embed_init``).  The computation is a plain function over it, named as
in ``repro``:
``apply_norm``, ``rope``, ``sinusoidal_positions``, ``attn_forward``
(full sequence, causal or not, self- or cross-attention over ``x_kv``,
optionally emitting its KV cache), ``attn_decode`` (one token against a
ring-buffer cache), ``cross_attn_decode`` (one token against a static
cross-attention cache; ``repro``'s ``attn_decode(is_cross=True)``),
``ffn_forward``, ``embed_tokens`` and ``unembed``.  An encoder-decoder
config (whisper) has no rotary embedding on any attention: its positions
are sinusoidal, added to the inputs.  Cross-attention uses the same
:class:`Attention` block (``repro``'s ``attn_init`` ignores ``cross``).

Numerics follow ``repro``: norm statistics in fp32 with the multiply in
``x.dtype``; rotary cos/sin cast to ``x.dtype``; attention scores in the
compute dtype, masked with that dtype's ``finfo.min``, softmax in fp32 and
cast back; ``jax.nn.gelu``'s default tanh approximation.  Attention is
plain ``einsum`` as in ``repro`` (no fused kernel there either).

Decode caches hold a ``pos`` row per batch row, ``(B, L)``: lanes of the
continuous-batching scheduler sit at different positions, each writing its
own ring slot ``pos % L`` (``repro`` vmaps batch-1 caches for that).
:func:`attn_decode` updates the cache in place.  A layer with
cross-attention keeps its static cache of ``enc_frames`` slots in the self
cache's ``cross`` field.  The MoE FFN is :mod:`repro_torch.models.moe`,
the Mamba-2 mixer :mod:`repro_torch.models.ssm`.

Each function takes ``rules`` (:class:`repro_torch.sharding.ShardingRules`;
the default has no mesh and changes nothing).  With a mesh, weights and
activations are DTensors (:mod:`repro_torch.launch.shardings`): the
activations are constrained where ``repro`` calls ``shard``, the attention
core and the cache writes run on each rank's shard (``local_map``), and
the lookup of a table whole in vocab is DTensor's embedding op.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.sharding import ShardingRules, shard

RULES = ShardingRules()  # no mesh: every constraint below is a no-op

_QUERY_CHUNK = 512  # query rows a chunk of full-sequence attention


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class Weights(nn.Module):
    """A module whose big weights the model casts to bf16.

    :meth:`w` returns weight ``name`` in ``dtype``:

    * under autograd, for a weight that requires grad, the cast the model
      made inside the graph for the current loss (``Transformer.train_hidden``),
      so gradients flow through it in bf16 back to the fp32 weight, as
      through ``repro``'s per-step ``_bf16_params``;
    * otherwise the model's cached bf16 copy (``Transformer._bf16_params``)
      while the weight is unchanged since the copy was made: an in-place
      update (an optimizer step, ``load_state_dict``) bumps the weight's
      ``_version`` and the stale copy is never served;
    * else a cast at the use site, as ``repro``'s ``p[name].astype(dtype)``.
    """

    def __init__(self):
        super().__init__()
        self._cast: Dict[str, torch.Tensor] = {}
        self._cast_version: Dict[str, int] = {}
        self._step_cast: Dict[str, torch.Tensor] = {}

    def w(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        p = getattr(self, name)
        if torch.is_grad_enabled() and p.requires_grad:
            cast = self._step_cast.get(name)
        else:
            cast = self._cast.get(name)
            if cast is not None and self._cast_version[name] != p._version:
                cast = None
        if cast is not None and cast.dtype == dtype:
            return cast
        return p.to(dtype)


def _param(shape, device) -> nn.Parameter:
    """An fp32 weight; it requires grad only once training turns that on
    (``repro_torch.train.init_train_state``)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


def _init_linear(w: torch.Tensor, gen: torch.Generator, scale=None) -> None:
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(Weights):
    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.scale = _param((d,), device)
        if cfg.norm == "layernorm":
            self.bias = _param((d,), device)

    def reset(self) -> None:
        self.scale.fill_(1.0)
        if hasattr(self, "bias"):
            self.bias.zero_()


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    # Moment statistics in fp32; the normalizing multiply stays in x.dtype.
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + 1e-5).to(x.dtype)
        out = (x - mu.to(x.dtype)) * inv * p.scale.to(x.dtype)
        return out + p.bias.to(x.dtype)
    ms = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + 1e-6).to(x.dtype)
    return x * inv * p.scale.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) -> rotated x."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)  # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Parameter-free position encoding (whisper's stub; any length):
    (...,) positions -> (..., d) fp32, sines then cosines."""
    half = d // 2
    freqs = torch.tensor(10_000.0, device=positions.device) ** (
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA; full / local / SWA via the spec's window)
# ---------------------------------------------------------------------------


class Attention(Weights):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param((d, hq * dh), device)
        self.wk = _param((d, hkv * dh), device)
        self.wv = _param((d, hkv * dh), device)
        self.wo = _param((hq * dh, d), device)

    def reset(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            _init_linear(w, gen)


@dataclasses.dataclass
class AttnCache:
    """Decode-time KV cache; ``length`` slots (= window for local layers)."""

    k: torch.Tensor    # (B, L, Hkv, Dh)
    v: torch.Tensor    # (B, L, Hkv, Dh)
    pos: torch.Tensor  # (B, L) int32 absolute positions stored (-1 = empty)
    # A cross-attention layer's static cache over the encoder's frames.
    cross: Optional["AttnCache"] = None


def _project_qkv(cfg, p: Attention, x, x_kv, positions, spec, is_cross, rules):
    dtype = x.dtype
    q = _split_heads(x @ p.w("wq", dtype), cfg.n_heads, cfg.head_dim)
    k = _split_heads(x_kv @ p.w("wk", dtype), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x_kv @ p.w("wv", dtype), cfg.n_kv_heads, cfg.head_dim)
    if not is_cross and not cfg.is_encdec:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    if not rules.attn_unconstrained:
        # Inside the mixer seq is whole and heads carry the model axis; k and
        # v shard by kv heads or replicate (the dh-sharded layout is for
        # caches only, at the cache emit).
        q = shard(q, rules, "batch", None, "heads", "head_dim")
        k = shard(k, rules, "batch", None, "kv_heads", None)
        v = shard(v, rules, "batch", None, "kv_heads", None)
    return q, k, v


def _split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, H Dh) -> (B, S, H, Dh).  A DTensor whose last dim is sharded
    over a mesh axis that does not divide H is gathered on that axis first
    (GSPMD pads such a split; a DTensor cannot make it)."""
    if _is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh = t.device_mesh
        place = [Replicate() if isinstance(pl, Shard) and pl.dim == t.ndim - 1
                 and heads % mesh.size(i) else pl for i, pl in enumerate(t.placements)]
        if place != list(t.placements):
            t = t.redistribute(mesh, place)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def _attend(cfg, q, k, v, mask=None, rules=RULES):
    """q: (B,Sq,Hq,Dh), k/v: (B,Sk,Hkv,Dh), mask: broadcastable to
    (B,Hkv,G,Sq,Sk) or None.  On DTensors it runs on each rank's rows and
    heads (:func:`_attend_local_map`)."""
    if rules.mesh is not None and _is_dtensor(q):
        return _attend_local_map(cfg, q, k, v, mask, rules)
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq * dh)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _attend_local_map(cfg, q, k, v, mask, rules):
    """:func:`_attend` on each rank's shard: batch rows over the batch axes,
    and KV heads (with their query groups) over the model axis where both
    head counts divide it, else replicated there.  A DTensor cannot run the
    einsums itself: they flatten (batch, heads) into one dim sharded over
    two mesh axes, which its batched matmul has no strategy for.  A cache
    sharded by head_dim (``kv_head_dim``) is gathered here."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import axis_size, batch_shard_axes, mesh_axis_names

    mesh = rules.mesh
    names = mesh_axis_names(mesh)
    row_axes = batch_shard_axes(mesh, rules, q.shape[0])
    b = q.shape[0]
    place = []
    for name in names:
        n = axis_size(mesh, name)
        if name in row_axes:
            place.append(Shard(0))
        elif (name == rules.heads and n > 1 and cfg.n_kv_heads % n == 0
              and cfg.n_heads % n == 0):
            place.append(Shard(2))
        else:
            place.append(Replicate())
    place = tuple(place)
    mask_place = None
    if mask is not None:
        mask = _replicated(mask, mesh)
        mask_place = tuple(Shard(0) if p == Shard(0) and mask.shape[0] == b else Replicate()
                           for p in place)
    # the output (B, Sq, Hq * Dh) keeps the rows' and the heads' shards
    args, in_place = (q, k, v), (place, place, place)
    if mask is not None:
        args, in_place = args + (mask,), in_place + (mask_place,)
    fn = local_map(functools.partial(_attend, cfg), out_placements=list(place),
                   in_placements=in_place, redistribute_inputs=True)
    return fn(*args)


def _replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """A plain tensor every rank holds whole, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    if _is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _write_slot(buf: torch.Tensor, lanes: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``buf[lanes, slot] = new`` in place: row b's slot ``slot[b]`` of a
    (B, L, ...) cache.  A DTensor cache is written on each rank's shard
    (:func:`_write_slot_sharded`)."""
    if _is_dtensor(buf):
        _write_slot_sharded(buf, slot, new)
    else:
        buf[lanes, slot] = new


def _write_slot_sharded(buf, slot, new) -> None:
    """The write of :func:`_write_slot` on a DTensor cache, rank-locally:
    the new row follows the cache's batch and head shards; where the slot
    axis is sharded (``cache_seq``), the rank that holds the slot writes it
    and the others write back what they hold (no data-dependent shapes)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = buf.device_mesh
    new_place, slot_place, seq_dims = [], [], []
    for i, pl in enumerate(buf.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            new_place.append(Shard(0))
            slot_place.append(Shard(0))
            continue
        if isinstance(pl, Shard) and pl.dim == 1:
            seq_dims.append(i)
        new_place.append(Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 1
                         else Replicate())
        slot_place.append(Replicate())

    def body(b, s, n):
        length = b.shape[1]
        offset = 0
        for i in seq_dims:  # the slots this rank holds start here
            offset = offset * mesh.size(i) + mesh.get_local_rank(i)
        rel = s - offset * length
        inside = (rel >= 0) & (rel < length)
        rel = rel.clamp(0, length - 1)
        rows = torch.arange(b.shape[0], device=b.device)
        keep = b[rows, rel]
        b[rows, rel] = torch.where(inside.reshape((-1,) + (1,) * (n.dim() - 1)), n, keep)
        return b

    local_map(body, out_placements=list(buf.placements),
              in_placements=(buf.placements, tuple(slot_place), tuple(new_place)),
              redistribute_inputs=True)(buf, _replicated(slot, mesh), _replicated(new, mesh))


def _causal_mask(qpos, kpos, spec: LayerSpec):
    mask = kpos[None, :] <= qpos[:, None]
    if spec.window > 0:
        mask &= kpos[None, :] > qpos[:, None] - spec.window
    return mask[None, None, None]


def _attend_qchunked(cfg, q, k, v, qpos_row, kpos_row, spec, causal, rules=RULES):
    """Exact attention (causal or not) over query chunks of at most 512 rows.

    Each chunk's softmax axis (Sk) is complete, so chunking the query dim
    is exact and bounds the (B, h, g, C, Sk) probabilities.  ``repro``
    scans chunks of ``_chunk_divisor(S)`` rows, since ``lax.scan`` needs
    equal ones; a loop does not, so the port takes 512-row chunks and a
    shorter last one (a prime S would otherwise give 1-row chunks).
    qpos_row/kpos_row are single (Sq,)/(Sk,) rows: masks are never built
    per batch row.
    """
    out = []
    for a in range(0, q.shape[1], _QUERY_CHUNK):
        mask = (_causal_mask(qpos_row[a : a + _QUERY_CHUNK], kpos_row, spec)
                if causal else None)
        out.append(_attend(cfg, q[:, a : a + _QUERY_CHUNK], k, v, mask, rules))
    out = out[0] if len(out) == 1 else torch.cat(out, dim=1)
    if rules.attn_unconstrained:
        return out
    return shard(out, rules, "batch", None, "heads")


def attn_forward(cfg: ModelConfig, spec: LayerSpec, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 x_kv: Optional[torch.Tensor] = None, emit_cache: bool = False,
                 rules: ShardingRules = RULES
                 ) -> Tuple[torch.Tensor, Optional[AttnCache]]:
    """Full-sequence attention (forward / prefill / encoder / cross).

    With ``x_kv`` (B, F, D) it is cross-attention over those frames: no
    mask, key positions 0 .. F - 1.
    """
    is_cross = x_kv is not None
    x_kv = x if x_kv is None else x_kv
    kv_positions = positions if not is_cross else torch.arange(
        x_kv.shape[1], dtype=positions.dtype, device=x.device)[None].expand(
            x.shape[0], x_kv.shape[1])
    q, k, v = _project_qkv(cfg, p, x, x_kv, positions, spec, is_cross, rules)
    # positions are uniform across the batch: masks come from one row.
    out = _attend_qchunked(cfg, q, k, v, positions[0], kv_positions[0], spec,
                           causal and not is_cross, rules)
    out = shard(out @ p.w("wo", x.dtype), rules, "batch", "seq", "d_model")
    cache = None
    if emit_cache:
        kc = shard(k, rules, "batch", "cache_seq", "kv_heads", "kv_head_dim")
        vc = shard(v, rules, "batch", "cache_seq", "kv_heads", "kv_head_dim")
        cache = AttnCache(k=kc, v=vc, pos=kv_positions.to(torch.int32).contiguous())
    return out, cache


def attn_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention, x: torch.Tensor,
                idx: torch.Tensor, cache: AttnCache, rules: ShardingRules = RULES
                ) -> Tuple[torch.Tensor, AttnCache]:
    """One token a batch row against its ring-buffer KV cache.

    x: (B, 1, D); idx: (B,) absolute position each row generates.  Row b
    writes slot ``idx[b] % L`` of its own cache (in place) and attends to
    the slots whose positions are at most ``idx[b]`` (and inside the
    window for local layers).
    """
    b = x.shape[0]
    dtype = x.dtype
    positions = idx[:, None]
    q = _split_heads(x @ p.w("wq", dtype), cfg.n_heads, cfg.head_dim)
    k_new = _split_heads(x @ p.w("wk", dtype), cfg.n_kv_heads, cfg.head_dim)
    v_new = _split_heads(x @ p.w("wv", dtype), cfg.n_kv_heads, cfg.head_dim)
    if not cfg.is_encdec:  # enc-dec (whisper) uses sinusoidal positions only
        q = rope(q, positions, spec.rope_theta)
        k_new = rope(k_new, positions, spec.rope_theta)
    # The new slice takes the cache's layout before the write.
    k_new = shard(k_new, rules, "batch", None, "kv_heads", "kv_head_dim")
    v_new = shard(v_new, rules, "batch", None, "kv_heads", "kv_head_dim")
    if rules.attn_unconstrained:
        q = shard(q, rules, "batch", None, None, "kv_head_dim")
    else:
        q = shard(q, rules, "batch", "seq", "heads", "head_dim")

    lanes = torch.arange(b, device=x.device)
    slot = idx % cache.k.shape[1]
    _write_slot(cache.k, lanes, slot, k_new[:, 0].to(cache.k.dtype))
    _write_slot(cache.v, lanes, slot, v_new[:, 0].to(cache.v.dtype))
    _write_slot(cache.pos, lanes, slot, idx.to(torch.int32))

    pos = cache.pos
    valid = (pos >= 0) & (pos <= positions)
    if spec.window > 0:
        valid &= pos > positions - spec.window
    mask = valid[:, None, None, None, :]  # (B,1,1,1,L)
    out = _attend(cfg, q, cache.k.to(dtype), cache.v.to(dtype), mask, rules)
    return shard(out @ p.w("wo", dtype), rules, "batch", "seq", "d_model"), cache


def cross_attn_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      cache: AttnCache, rules: ShardingRules = RULES) -> torch.Tensor:
    """One token a batch row against its static cross-attention cache: no
    update, no mask, every frame attended."""
    dtype = x.dtype
    q = _split_heads(x @ p.w("wq", dtype), cfg.n_heads, cfg.head_dim)
    q = shard(q, rules, "batch", "seq", "heads", "head_dim")
    out = _attend(cfg, q, cache.k.to(dtype), cache.v.to(dtype), None, rules)
    return shard(out @ p.w("wo", dtype), rules, "batch", "seq", "d_model")


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> AttnCache:
    """Empty self cache (ring-sized for a windowed layer); a layer with
    cross-attention also gets an empty cross cache of ``enc_frames`` slots."""
    length = min(spec.window, max_seq) if spec.window > 0 else max_seq
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    cross = None
    if spec.cross_attn:
        fshape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
        cross = AttnCache(
            k=torch.zeros(fshape, dtype=dtype, device=device),
            v=torch.zeros(fshape, dtype=dtype, device=device),
            pos=torch.arange(cfg.enc_frames, dtype=torch.int32, device=device)[None]
            .expand(batch, -1).contiguous())
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
        cross=cross,
    )


# ---------------------------------------------------------------------------
# Dense FFN: SwiGLU / GeGLU / squared-ReLU / plain GELU
# ---------------------------------------------------------------------------


class FFN(Weights):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = _param((d, f), device)
        self.w2 = _param((f, d), device)
        if cfg.act in ("silu", "gelu"):
            self.w3 = _param((d, f), device)

    def reset(self, gen: torch.Generator) -> None:
        for name in ("w1", "w2", "w3"):
            if hasattr(self, name):
                _init_linear(getattr(self, name), gen)


def ffn_forward(cfg: ModelConfig, p: FFN, x: torch.Tensor,
                rules: ShardingRules = RULES) -> torch.Tensor:
    dtype = x.dtype
    h = shard(x @ p.w("w1", dtype), rules, "batch", None, "mlp")
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p.w("w3", dtype))
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh") * (x @ p.w("w3", dtype))
    elif cfg.act == "relu2":
        r = F.relu(h)
        h = r * r
    elif cfg.act == "gelu_plain":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(cfg.act)
    h = shard(h, rules, "batch", None, "mlp")
    return shard(h @ p.w("w2", dtype), rules, "batch", "seq", "d_model")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


class Embedding(Weights):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = _param((vp, d), device)
        if not cfg.tie_embeddings:
            self.unembed = _param((d, vp), device)

    def reset(self, gen: torch.Generator) -> None:
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen,
                                     device=self.embed.device) * 0.02)
        if hasattr(self, "unembed"):
            self.unembed.copy_(torch.randn(self.unembed.shape, generator=gen,
                                           device=self.unembed.device) * 0.02)


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens: torch.Tensor,
                 rules: ShardingRules = RULES) -> torch.Tensor:
    w = p.w("embed", compute_dtype(cfg))
    if _is_dtensor(w) and not any(pl.is_shard(0) for pl in w.placements):
        # A table whole in vocab: DTensor's embedding op keeps the gradient
        # of batch-sharded rows a partial sum, where index_put (the backward
        # of w[tokens]) gathers every rank's rows first.  A vocab-sharded
        # table keeps w[tokens]: the embedding op's masked partial sum cannot
        # take a tied unembed's gradient.
        x = F.embedding(tokens, w)
    else:
        x = w[tokens]
    return shard(x, rules, "batch", "seq", "d_model")


def unembed(cfg: ModelConfig, p: Embedding, x: torch.Tensor,
            rules: ShardingRules = RULES) -> torch.Tensor:
    dtype = x.dtype
    w = p.w("embed", dtype).t() if cfg.tie_embeddings else p.w("unembed", dtype)
    logits = x @ w
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    # seq None: logits live inside the chunked loss, where seq is a chunk
    return shard(logits, rules, "batch", None, "vocab")
