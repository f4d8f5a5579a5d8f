"""Dense decoder building blocks: port of ``repro.models.layers``.

Each block is an ``nn.Module`` holding its weights in ``repro``'s layout
(``wq`` is ``(d_model, n_heads * head_dim)``, used as ``x @ wq``); its
constructor allocates them and ``reset`` draws ``repro``'s initial values
(the counterparts of ``norm_init``, ``attn_init``, ``ffn_init`` and
``embed_init``).  The computation is a plain function over it, named as
in ``repro``:
``apply_norm``, ``rope``, ``attn_forward`` (full sequence, optionally
emitting its KV cache), ``attn_decode`` (one token against a ring-buffer
cache), ``ffn_forward``, ``embed_tokens`` and ``unembed``.

Numerics follow ``repro``: norm statistics in fp32 with the multiply in
``x.dtype``; rotary cos/sin cast to ``x.dtype``; attention scores in the
compute dtype, masked with that dtype's ``finfo.min``, softmax in fp32 and
cast back; ``jax.nn.gelu``'s default tanh approximation.  Attention is
plain ``einsum`` as in ``repro`` (no fused kernel there either).

Decode caches hold a ``pos`` row per batch row, ``(B, L)``: lanes of the
continuous-batching scheduler sit at different positions, each writing its
own ring slot ``pos % L`` (``repro`` vmaps batch-1 caches for that).
:func:`attn_decode` updates the cache in place.  Sinusoidal positions and
cross-attention (whisper) wait for ROADMAP module 13's encoder-decoder item;
the MoE FFN is :mod:`repro_torch.models.moe`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import LayerSpec, ModelConfig

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


def _project_qkv(cfg, p: Attention, x, positions, spec):
    b, s, _ = x.shape
    dtype = x.dtype
    q = (x @ p.w("wq", dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p.w("wk", dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p.w("wv", dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    return q, k, v


def _attend(cfg, q, k, v, mask):
    """q: (B,Sq,Hq,Dh), k/v: (B,Sk,Hkv,Dh), mask: broadcastable to
    (B,Hkv,G,Sq,Sk) or None."""
    b, sq, hq, dh = q.shape
    hkv = cfg.n_kv_heads
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq * dh)


def _causal_mask(qpos, kpos, spec: LayerSpec):
    mask = kpos[None, :] <= qpos[:, None]
    if spec.window > 0:
        mask &= kpos[None, :] > qpos[:, None] - spec.window
    return mask[None, None, None]


def _attend_qchunked(cfg, q, k, v, qpos_row, kpos_row, spec):
    """Exact causal attention over query chunks of at most 512 rows.

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
        mask = _causal_mask(qpos_row[a : a + _QUERY_CHUNK], kpos_row, spec)
        out.append(_attend(cfg, q[:, a : a + _QUERY_CHUNK], k, v, mask))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def attn_forward(cfg: ModelConfig, spec: LayerSpec, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor, *, emit_cache: bool = False
                 ) -> Tuple[torch.Tensor, Optional[AttnCache]]:
    """Full-sequence causal self-attention (forward / prefill)."""
    q, k, v = _project_qkv(cfg, p, x, positions, spec)
    # positions are uniform across the batch: masks come from one row.
    out = _attend_qchunked(cfg, q, k, v, positions[0], positions[0], spec)
    out = out @ p.w("wo", x.dtype)
    cache = None
    if emit_cache:
        cache = AttnCache(k=k, v=v, pos=positions.to(torch.int32).contiguous())
    return out, cache


def attn_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention, x: torch.Tensor,
                idx: torch.Tensor, cache: AttnCache
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
    q = (x @ p.w("wq", dtype)).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k_new = (x @ p.w("wk", dtype)).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v_new = (x @ p.w("wv", dtype)).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, spec.rope_theta)
    k_new = rope(k_new, positions, spec.rope_theta)

    lanes = torch.arange(b, device=x.device)
    slot = idx % cache.k.shape[1]
    cache.k[lanes, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[lanes, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[lanes, slot] = idx.to(torch.int32)

    pos = cache.pos
    valid = (pos >= 0) & (pos <= positions)
    if spec.window > 0:
        valid &= pos > positions - spec.window
    mask = valid[:, None, None, None, :]  # (B,1,1,1,L)
    out = _attend(cfg, q, cache.k.to(dtype), cache.v.to(dtype), mask)
    return out @ p.w("wo", dtype), cache


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> AttnCache:
    length = min(spec.window, max_seq) if spec.window > 0 else max_seq
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
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


def ffn_forward(cfg: ModelConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    h = x @ p.w("w1", dtype)
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
    return h @ p.w("w2", dtype)


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


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.w("embed", compute_dtype(cfg))[tokens]


def unembed(cfg: ModelConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    w = p.w("embed", dtype).t() if cfg.tie_embeddings else p.w("unembed", dtype)
    logits = x @ w
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits
