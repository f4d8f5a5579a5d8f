"""Config-driven dense decoder: port of ``repro.models.model``'s serving side.

:class:`Transformer` is an ``nn.Module`` over an ``nn.ModuleList`` of the
``n_layers`` decoder layers in ``repro``'s order (block b, pattern position
s is layer ``b * pattern_len + s``; then the tail), where ``repro`` scans
stacked blocks.  It provides ``forward`` (``last_only``,
``return_hidden``), ``prefill``, ``decode_step`` (``with_hidden``),
``make_decode_caches`` and ``pad_caches``; :func:`init_params` draws
``repro``'s distributions from a ``torch.Generator`` on the target device.

``decode_step`` takes the position as a scalar or as a ``(B,)`` tensor, so
scheduler lanes at different positions decode in one call (``repro``
vmaps batch-1 caches for that).  Caches are a list of one
:class:`~repro_torch.models.layers.AttnCache` a layer, updated in place.

Two differences from ``repro``, both where ``repro`` would be wrong or
cannot run: a prefill shorter than a local layer's window emits a ring of
``window`` slots (``repro`` keeps a cache of the prompt's length, which
decode then wraps inside the window), and ``pad_caches`` trims a ring
longer than ``max_seq``.

What waits for ROADMAP module 13 raises ``NotImplementedError`` naming
its item: the training losses, MoE, Mamba-2, encoder-decoder and patch
inputs.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.index.facade import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ATTN, DENSE, MOE, NONE, LayerSpec, ModelConfig
from repro_torch.models.layers import AttnCache, Weights

Caches = List[AttnCache]

_BF16_MIN_ELEMENTS = 1_000_000

_ITEMS = {
    "training": "13a (training: the losses, optim/adamw.py, train/train_loop.py)",
    "moe": "13b (MoE: models/moe.py)",
    "mamba": "13c (Mamba-2: models/ssm.py)",
    "encdec": "13d (encoder-decoder and VLM: whisper, llava)",
}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for its port: ROADMAP.md module "
                               f"{_ITEMS[item]}")


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer != ATTN:
            raise _unported(f"{cfg.name}: mixer {spec.mixer!r}", "mamba")
        if spec.ffn == MOE:
            raise _unported(f"{cfg.name}: MoE layers", "moe")
        if spec.cross_attn:
            raise _unported(f"{cfg.name}: cross-attention", "encdec")
    if cfg.is_encdec or cfg.n_patches:
        raise _unported(f"{cfg.name}: encoder or patch inputs", "encdec")


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """Every layer's spec in stack order: the blocks, then the tail."""
    return list(cfg.pattern) * cfg.n_blocks + list(cfg.tail_specs)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        self.spec = spec
        self.norm1 = layers.Norm(cfg, cfg.d_model, device)
        self.mixer = layers.Attention(cfg, device)
        if spec.ffn != NONE:
            self.norm2 = layers.Norm(cfg, cfg.d_model, device)
            self.ffn = layers.FFN(cfg, device)

    def reset(self, gen: torch.Generator) -> None:
        self.norm1.reset()
        self.mixer.reset(gen)
        if self.spec.ffn != NONE:
            self.norm2.reset()
            self.ffn.reset(gen)


class Transformer(nn.Module):
    """The dense decoder of ``cfg``, its weights fp32 on ``device``.

    Weights are allocated uninitialised: use :func:`init_params`, or
    ``load_state_dict`` (e.g. of :func:`repro_torch.models.convert.params_from_jax`).
    """

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = layers.compute_dtype(cfg)
        self.embed = layers.Embedding(cfg, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, spec, dev)
                                    for spec in layer_specs(cfg))
        self.final_norm = layers.Norm(cfg, cfg.d_model, dev)

    # -- weights -------------------------------------------------------------

    def _bf16_params(self) -> None:
        """Cast weights over 1M elements to bf16 once, for a bf16 model.

        ``repro`` casts them once a step; the cast values are the same.
        Small leaves (norm scales) are cast at their use sites.
        """
        for module in self.modules():
            if isinstance(module, Weights):
                module._cast = {}
                if self.dtype != torch.bfloat16:
                    continue
                for name, p in module.named_parameters(recurse=False):
                    if p.dtype == torch.float32 and p.numel() > _BF16_MIN_ELEMENTS:
                        module._cast[name] = p.detach().to(torch.bfloat16)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self._bf16_params()
        return out

    # -- full sequence ---------------------------------------------------------

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int64, device=self.device)[None].expand(b, s)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _run(self, tokens: torch.Tensor, emit_caches: bool):
        cfg = self.cfg
        b, s = tokens.shape
        positions = self._positions(b, s)
        x = layers.embed_tokens(cfg, self.embed, tokens).to(self.dtype)
        caches = [] if emit_caches else None
        for layer in self.layers:
            spec = layer.spec
            h = layers.apply_norm(cfg, layer.norm1, x)
            a, c = layers.attn_forward(cfg, spec, layer.mixer, h, positions,
                                       emit_cache=emit_caches)
            if emit_caches:
                caches.append(_ring_compress(cfg, spec, c))
            x = x + a
            if spec.ffn == DENSE:
                h = layers.apply_norm(cfg, layer.norm2, x)
                x = x + layers.ffn_forward(cfg, layer.ffn, h)
        return layers.apply_norm(cfg, self.final_norm, x), caches

    @torch.no_grad()
    def forward(self, tokens, *, last_only: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        """(B, S) tokens -> logits (B, S, Vp), or (B, 1, Vp) with
        ``last_only``, or the final-norm hidden states (B, S, D) with
        ``return_hidden`` (no unembed)."""
        x, _ = self._run(self._tokens(tokens), emit_caches=False)
        if return_hidden:
            return x
        return layers.unembed(self.cfg, self.embed, x[:, -1:] if last_only else x)

    @torch.no_grad()
    def prefill(self, tokens, *, with_hidden: bool = False):
        """Run the full prompt; returns (last-token logits (B, Vp), caches),
        plus the last hidden state (B, D) with ``with_hidden``."""
        x, caches = self._run(self._tokens(tokens), emit_caches=True)
        logits = layers.unembed(self.cfg, self.embed, x[:, -1:])[:, -1]
        if with_hidden:
            return logits, caches, x[:, -1]
        return logits, caches

    # -- decode ----------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, tokens, idx, caches: Caches, *, with_hidden: bool = False):
        """One autoregressive step for the whole batch.

        Args:
          tokens: (B, 1) the tokens generated at positions ``idx - 1``.
          idx: the position to write and attend, a scalar or a (B,) tensor
            (each batch row at its own position).
          caches: from :meth:`prefill` + :func:`pad_caches` or
            :meth:`make_decode_caches`; updated in place.

        Returns (logits (B, Vp), caches), plus the hidden state (B, D) the
        retrieval path queries with ``with_hidden``.
        """
        cfg = self.cfg
        tokens = self._tokens(tokens)
        b = tokens.shape[0]
        idx = torch.as_tensor(idx, device=self.device).long()
        if idx.ndim == 0:
            idx = idx.expand(b)
        x = layers.embed_tokens(cfg, self.embed, tokens).to(self.dtype)
        for layer, cache in zip(self.layers, caches):
            spec = layer.spec
            h = layers.apply_norm(cfg, layer.norm1, x)
            a, _ = layers.attn_decode(cfg, spec, layer.mixer, h, idx, cache)
            x = x + a
            if spec.ffn == DENSE:
                h = layers.apply_norm(cfg, layer.norm2, x)
                x = x + layers.ffn_forward(cfg, layer.ffn, h)
        x = layers.apply_norm(cfg, self.final_norm, x)
        logits = layers.unembed(cfg, self.embed, x)[:, 0]
        if with_hidden:
            return logits, caches, x[:, 0]
        return logits, caches

    def make_decode_caches(self, batch: int, max_seq: int,
                           dtype: torch.dtype = torch.bfloat16) -> Caches:
        """Empty decode caches (ring-sized for windowed layers)."""
        return [layers.init_attn_cache(self.cfg, layer.spec, batch, max_seq, dtype,
                                       device=self.device)
                for layer in self.layers]

    def pad_caches(self, caches: Caches, max_seq: int) -> Caches:
        """Grow prefill-emitted full-attention caches to ``max_seq`` slots
        (pos -1), and trim windowed rings longer than ``max_seq`` (their
        positions sit at slots ``pos < max_seq`` then)."""
        out = []
        for layer, c in zip(self.layers, caches):
            window, cur = layer.spec.window, c.k.shape[1]
            if window == 0 and cur < max_seq:
                grow = max_seq - cur
                pad = (0, 0, 0, 0, 0, grow)
                c = AttnCache(k=F.pad(c.k, pad), v=F.pad(c.v, pad),
                              pos=F.pad(c.pos, (0, grow), value=-1))
            elif window > 0 and cur > max_seq:
                c = AttnCache(k=c.k[:, :max_seq], v=c.v[:, :max_seq],
                              pos=c.pos[:, :max_seq])
            out.append(c)
        return out


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Transformer:
    """A :class:`Transformer` with ``repro``'s distributions: linear weights
    N(0, 1/fan_in), embeddings N(0, 0.02^2), norm scales 1 and biases 0,
    drawn in layer order from a ``torch.Generator`` seeded with ``seed`` on
    the model's device."""
    model = Transformer(cfg, device=device)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(seed)
    with torch.no_grad():
        model.embed.reset(generator)
        model.final_norm.reset()
        for layer in model.layers:
            layer.reset(generator)
    model._bf16_params()
    return model


def _ring_compress(cfg: ModelConfig, spec: LayerSpec, c: AttnCache) -> AttnCache:
    """Convert a full prefill cache to the layer's ring-buffer layout:
    the last ``window`` positions at slots ``pos % window``."""
    s = c.k.shape[1]
    w = spec.window
    if w <= 0 or s == w:
        return c
    keep_pos = torch.arange(max(s - w, 0), s, dtype=torch.int64, device=c.k.device)
    slots = keep_pos % w
    b = c.k.shape[0]
    k = c.k.new_zeros((b, w) + tuple(c.k.shape[2:]))
    v = c.v.new_zeros((b, w) + tuple(c.v.shape[2:]))
    k[:, slots] = c.k[:, s - keep_pos.numel():]
    v[:, slots] = c.v[:, s - keep_pos.numel():]
    pos = torch.full((b, w), -1, dtype=torch.int32, device=c.k.device)
    pos[:, slots] = keep_pos.to(torch.int32)
    return AttnCache(k=k, v=v, pos=pos)


# ---------------------------------------------------------------------------
# Training (ROADMAP module 13a)
# ---------------------------------------------------------------------------


def lm_loss(*args, **kwargs):
    raise _unported("lm_loss", "training")


def chunked_lm_loss(*args, **kwargs):
    raise _unported("chunked_lm_loss", "training")


def train_loss(*args, **kwargs):
    raise _unported("train_loss", "training")
