"""Config-driven model of all ten configs: port of ``repro.models.model``.

:class:`Transformer` is an ``nn.Module`` over an ``nn.ModuleList`` of the
``n_layers`` decoder layers in ``repro``'s order (block b, pattern position
s is layer ``b * pattern_len + s``; then the tail), where ``repro`` scans
stacked blocks.  A layer's mixer is attention or a Mamba-2 SSM
(:mod:`repro_torch.models.ssm`), its FFN dense, MoE or none, so jamba's
mixed block runs as one stack.  An encoder-decoder config (whisper) adds
``enc``, ``n_enc_layers`` non-causal layers and a final norm over the
frames (sinusoidal positions added to the frames and to the decoder's
input), and a cross-attention in each decoder layer; a config with
patches (llava) adds ``patch_proj``, whose projections of the
``patches`` overwrite the first ``n_patches`` positions.  The entry
points take ``frames`` and ``patches`` keywords as ``repro``'s do.
It provides ``forward`` (``last_only``,
``return_hidden``), ``prefill``, ``decode_step`` (``with_hidden``),
``make_decode_caches`` and ``pad_caches``, all without autograd, and
``train_hidden``, the forward the losses differentiate: it casts the big
weights to bf16 once inside the graph (``repro``'s ``_bf16_params`` under
its identity-VJP pin) and runs each layer under ``cfg.remat_policy``
(``repro``'s ``_maybe_remat``: ``"none"``; ``"full"``, only the layer's
input saved; ``"minimal"``, the outputs of the matmuls without batch dims
saved as ``dots_with_no_batch_dims_saveable`` does).  The losses are
:func:`lm_loss`, :func:`chunked_lm_loss` and :func:`train_loss`;
:func:`init_params` draws ``repro``'s distributions from a
``torch.Generator`` on the target device.

``decode_step`` takes the position as a scalar or as a ``(B,)`` tensor, so
scheduler lanes at different positions decode in one call (``repro``
vmaps batch-1 caches for that).  Caches are a list of one cache a layer,
updated in place: an :class:`~repro_torch.models.layers.AttnCache` (with
its static cross cache in ``cross`` where the layer has cross-attention)
or an :class:`~repro_torch.models.ssm.SSMCache`.

Differences from ``repro``, each where ``repro`` would be wrong or cannot
run: a prefill shorter than a local layer's window emits a ring of
``window`` slots (``repro`` keeps a cache of the prompt's length, which
decode then wraps inside the window); ``pad_caches`` trims a ring longer
than ``max_seq``; and the SSM keeps its conv tail in the compute dtype and
sums its decay exponents segment by segment (:mod:`repro_torch.models.ssm`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.index.facade import DeviceLike, resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.models.config import ATTN, DENSE, MAMBA, NONE, LayerSpec, ModelConfig
from repro_torch.models.layers import AttnCache
from repro_torch.models.ssm import SSMCache

Cache = Union[AttnCache, SSMCache]
Caches = List[Cache]

_BF16_MIN_ELEMENTS = 1_000_000
ENC_SPEC = LayerSpec(mixer=ATTN, ffn=DENSE)


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """Every layer's spec in stack order: the blocks, then the tail."""
    return list(cfg.pattern) * cfg.n_blocks + list(cfg.tail_specs)


class DecoderLayer(nn.Module):
    """One layer of ``spec`` (``repro``'s ``_layer_init``): ``norm1`` and the
    mixer; ``norm_cross`` and ``cross`` with cross-attention; ``norm2`` and
    the FFN unless it is none."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        self.spec = spec
        self.norm1 = layers.Norm(cfg, cfg.d_model, device)
        if spec.mixer == ATTN:
            self.mixer = layers.Attention(cfg, device)
        elif spec.mixer == MAMBA:
            self.mixer = ssm.SSM(cfg, device)
        else:
            raise ValueError(spec.mixer)
        if spec.cross_attn:
            self.norm_cross = layers.Norm(cfg, cfg.d_model, device)
            self.cross = layers.Attention(cfg, device)
        if spec.ffn != NONE:
            self.norm2 = layers.Norm(cfg, cfg.d_model, device)
            self.ffn = (layers.FFN(cfg, device) if spec.ffn == DENSE
                        else moe.MoE(cfg, device))

    def reset(self, gen: torch.Generator) -> None:
        self.norm1.reset()
        self.mixer.reset(gen)
        if self.spec.cross_attn:
            self.norm_cross.reset()
            self.cross.reset(gen)
        if self.spec.ffn != NONE:
            self.norm2.reset()
            self.ffn.reset(gen)


class Encoder(nn.Module):
    """``repro``'s ``enc`` subtree: ``n_enc_layers`` layers of ``ENC_SPEC``
    and a final norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList(DecoderLayer(cfg, ENC_SPEC, device)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = layers.Norm(cfg, cfg.d_model, device)

    def reset(self, gen: torch.Generator) -> None:
        for layer in self.blocks:
            layer.reset(gen)
        self.final_norm.reset()


def _ffn(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor):
    """The layer's FFN residual branch: (x + ffn(norm2(x)), MoE aux)."""
    h = layers.apply_norm(cfg, layer.norm2, x)
    if layer.spec.ffn == DENSE:
        return x + layers.ffn_forward(cfg, layer.ffn, h), None
    f, aux = moe.moe_forward(cfg, layer.ffn, h)
    return x + f, aux


def _layer_forward(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor,
                   positions: torch.Tensor, emit_cache: bool = False,
                   enc_out: Optional[torch.Tensor] = None, causal: bool = True):
    """One layer over the full sequence: (x, MoE aux or None, cache or None);
    a cross-attention layer attends to ``enc_out`` and emits its cross
    cache into the self cache's ``cross``."""
    spec = layer.spec
    h = layers.apply_norm(cfg, layer.norm1, x)
    if spec.mixer == ATTN:
        a, cache = layers.attn_forward(cfg, spec, layer.mixer, h, positions,
                                       causal=causal, emit_cache=emit_cache)
        if emit_cache:
            cache = _ring_compress(cfg, spec, cache)
    else:
        a, cache = ssm.ssm_forward(cfg, layer.mixer, h, emit_cache=emit_cache)
    x = x + a
    if spec.cross_attn:
        h = layers.apply_norm(cfg, layer.norm_cross, x)
        a, cross = layers.attn_forward(cfg, spec, layer.cross, h, positions,
                                       x_kv=enc_out, emit_cache=emit_cache)
        if emit_cache:
            cache.cross = cross
        x = x + a
    aux = None
    if layer.spec.ffn != NONE:
        x, aux = _ffn(cfg, layer, x)
    return x, aux, cache


_MATMULS = (torch.ops.aten.mm.default,)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of plain
    matmuls (projections, router); recompute the rest, batched products
    (attention, experts) included."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(policy: str, fn):
    """``repro``'s ``_maybe_remat`` for one layer: remat changes what is
    kept for the backward pass, never a value."""
    if policy == "none":
        return fn
    if policy == "minimal":
        context = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context)
    return functools.partial(checkpoint, fn, use_reentrant=False)  # "full"


class Transformer(nn.Module):
    """The decoder of ``cfg`` (dense or MoE FFNs), its weights fp32 on ``device``.

    Weights are allocated uninitialised: use :func:`init_params`, or
    ``load_state_dict`` (e.g. of :func:`repro_torch.models.convert.params_from_jax`).
    """

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = layers.compute_dtype(cfg)
        self.embed = layers.Embedding(cfg, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, spec, dev)
                                    for spec in layer_specs(cfg))
        self.final_norm = layers.Norm(cfg, cfg.d_model, dev)
        if cfg.is_encdec:
            self.enc = Encoder(cfg, dev)
        if cfg.n_patches:
            self.patch_proj = layers._param((cfg.patch_dim, cfg.d_model), dev)

    # -- weights -------------------------------------------------------------

    def _weights(self):
        return (m for m in self.modules() if isinstance(m, layers.Weights))

    def _big(self, module: layers.Weights):
        """(name, weight) of the module's weights that a bf16 model casts
        whole: fp32 and over 1M elements (``repro``'s ``_bf16_params``).
        Small leaves (norm scales, the router) are cast at their use sites."""
        if self.dtype != torch.bfloat16:
            return
        for name, p in module.named_parameters(recurse=False):
            if p.dtype == torch.float32 and p.numel() > _BF16_MIN_ELEMENTS:
                yield name, p

    def _bf16_params(self) -> None:
        """Make the serving path's bf16 copies of the big weights, each only
        where its weight changed since its copy was made.

        ``repro`` casts them once a step; the cast values are the same.  The
        serving entry points call this first, so a weight updated in place
        since (an optimizer step) is cast anew before it is served.
        """
        for module in self._weights():
            for name, p in self._big(module):
                if module._cast_version.get(name) != p._version:
                    module._cast[name] = p.detach().to(torch.bfloat16)
                    module._cast_version[name] = p._version

    def _cast_for_step(self) -> None:
        """Cast the big weights to bf16 inside autograd for one loss (their
        gradients flow back in bf16 and reach the fp32 weights as fp32), and
        drop the serving copies, which training makes stale."""
        for module in self._weights():
            module._cast, module._cast_version = {}, {}
            module._step_cast = {name: p.to(torch.bfloat16)
                                 for name, p in self._big(module)}

    def release_step(self) -> None:
        """Free the casts of the last loss once its gradients are taken."""
        for module in self._weights():
            module._step_cast = {}

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self._bf16_params()
        return out

    # -- full sequence ---------------------------------------------------------

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int64, device=self.device)[None].expand(b, s)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor, patches, frames, remat: str = "none"):
        """The decoder's input (B, S, D) and the encoder's output (or None):
        token embeddings, the first ``n_patches`` positions overwritten by
        the projected ``patches``, and for an encoder-decoder the encoded
        ``frames`` and sinusoidal positions added."""
        cfg = self.cfg
        b, s = tokens.shape
        x = layers.embed_tokens(cfg, self.embed, tokens).to(self.dtype)
        if cfg.n_patches and patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
            if patches.shape[1] > s:
                raise ValueError(f"{cfg.name}: {patches.shape[1]} patches do not fit "
                                 f"a sequence of {s} tokens")
            pe = patches.to(self.dtype) @ self.patch_proj.to(self.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        if not cfg.is_encdec:
            return x, None
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frames")
        enc_out = self._encode(torch.as_tensor(frames, device=self.device).to(self.dtype),
                               remat)
        positions = self._positions(b, s)
        return x + layers.sinusoidal_positions(positions, cfg.d_model).to(self.dtype), enc_out

    def _encode(self, frames: torch.Tensor, remat: str) -> torch.Tensor:
        """``repro``'s ``_encode``: sinusoidal positions on the frames, the
        non-causal layers (each under ``remat``), the encoder's final norm."""
        cfg = self.cfg
        b, f, _ = frames.shape
        positions = self._positions(b, f)
        x = frames + layers.sinusoidal_positions(positions, cfg.d_model).to(frames.dtype)
        for layer in self.enc.blocks:
            def body(x, layer=layer):
                return _layer_forward(cfg, layer, x, positions, causal=False)[0]
            x = _maybe_remat(remat, body)(x)
        return layers.apply_norm(cfg, self.enc.final_norm, x)

    def _run(self, tokens: torch.Tensor, emit_caches: bool, patches=None, frames=None):
        cfg = self.cfg
        self._bf16_params()
        b, s = tokens.shape
        positions = self._positions(b, s)
        x, enc_out = self._embed(tokens, patches, frames)
        caches = [] if emit_caches else None
        for layer in self.layers:
            x, _, c = _layer_forward(cfg, layer, x, positions, emit_caches, enc_out)
            if emit_caches:
                caches.append(c)
        return layers.apply_norm(cfg, self.final_norm, x), caches

    def train_hidden(self, tokens, *, patches=None, frames=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward the losses differentiate: (B, S) tokens (and the
        config's ``patches`` or ``frames``) -> (final-norm hidden states
        (B, S, D), the summed MoE aux loss, fp32).

        Big weights are cast to bf16 once, inside the graph; each layer,
        the encoder's too, runs under ``cfg.remat_policy``.  The casts stay
        referenced until :meth:`release_step` or the next call, since a
        rematerialized layer reads them again in the backward pass.
        """
        cfg = self.cfg
        self._cast_for_step()
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        positions = self._positions(b, s)
        x, enc_out = self._embed(tokens, patches, frames, cfg.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            def body(x, layer=layer):
                x, a, _ = _layer_forward(cfg, layer, x, positions, enc_out=enc_out)
                return x, a
            x, a = _maybe_remat(cfg.remat_policy, body)(x)
            if a is not None:
                aux = aux + a
        return layers.apply_norm(cfg, self.final_norm, x), aux

    @torch.no_grad()
    def forward(self, tokens, *, patches=None, frames=None, last_only: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        """(B, S) tokens -> logits (B, S, Vp), or (B, 1, Vp) with
        ``last_only``, or the final-norm hidden states (B, S, D) with
        ``return_hidden`` (no unembed).  ``patches`` (B, n_patches,
        patch_dim) and ``frames`` (B, enc_frames, D) as the config needs."""
        x, _ = self._run(self._tokens(tokens), False, patches, frames)
        if return_hidden:
            return x
        return layers.unembed(self.cfg, self.embed, x[:, -1:] if last_only else x)

    @torch.no_grad()
    def prefill(self, tokens, *, patches=None, frames=None, with_hidden: bool = False):
        """Run the full prompt; returns (last-token logits (B, Vp), caches),
        plus the last hidden state (B, D) with ``with_hidden``."""
        x, caches = self._run(self._tokens(tokens), True, patches, frames)
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
        self._bf16_params()
        tokens = self._tokens(tokens)
        b = tokens.shape[0]
        idx = torch.as_tensor(idx, device=self.device).long()
        if idx.ndim == 0:
            idx = idx.expand(b)
        x = layers.embed_tokens(cfg, self.embed, tokens).to(self.dtype)
        if cfg.is_encdec:
            x = x + layers.sinusoidal_positions(idx[:, None], cfg.d_model).to(self.dtype)
        for layer, cache in zip(self.layers, caches):
            h = layers.apply_norm(cfg, layer.norm1, x)
            if layer.spec.mixer == ATTN:
                a, _ = layers.attn_decode(cfg, layer.spec, layer.mixer, h, idx, cache)
            else:
                a, _ = ssm.ssm_decode(cfg, layer.mixer, h, cache)
            x = x + a
            if layer.spec.cross_attn:
                h = layers.apply_norm(cfg, layer.norm_cross, x)
                x = x + layers.cross_attn_decode(cfg, layer.cross, h, cache.cross)
            if layer.spec.ffn != NONE:
                x, _ = _ffn(cfg, layer, x)
        x = layers.apply_norm(cfg, self.final_norm, x)
        logits = layers.unembed(cfg, self.embed, x)[:, 0]
        if with_hidden:
            return logits, caches, x[:, 0]
        return logits, caches

    def make_decode_caches(self, batch: int, max_seq: int,
                           dtype: torch.dtype = torch.bfloat16) -> Caches:
        """Empty decode caches (ring-sized for windowed layers; an SSM
        layer's state fp32, its conv window in ``dtype``)."""
        return [layers.init_attn_cache(self.cfg, layer.spec, batch, max_seq, dtype,
                                       device=self.device)
                if layer.spec.mixer == ATTN else
                ssm.init_ssm_cache(self.cfg, batch, dtype, device=self.device)
                for layer in self.layers]

    def pad_caches(self, caches: Caches, max_seq: int) -> Caches:
        """Grow prefill-emitted full-attention caches to ``max_seq`` slots
        (pos -1), and trim windowed rings longer than ``max_seq`` (their
        positions sit at slots ``pos < max_seq`` then).  SSM and cross
        caches are final-sized and pass through."""
        out = []
        for layer, c in zip(self.layers, caches):
            if layer.spec.mixer != ATTN:
                out.append(c)
                continue
            window, cur = layer.spec.window, c.k.shape[1]
            if window == 0 and cur < max_seq:
                grow = max_seq - cur
                pad = (0, 0, 0, 0, 0, grow)
                c = dataclasses.replace(c, k=F.pad(c.k, pad), v=F.pad(c.v, pad),
                                        pos=F.pad(c.pos, (0, grow), value=-1))
            elif window > 0 and cur > max_seq:
                c = dataclasses.replace(c, k=c.k[:, :max_seq], v=c.v[:, :max_seq],
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
        if cfg.is_encdec:
            model.enc.reset(generator)
        if cfg.n_patches:
            model.patch_proj.copy_(torch.randn(model.patch_proj.shape, generator=generator,
                                               device=model.device) * 0.02)
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
    return dataclasses.replace(c, k=k, v=v, pos=pos)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _nll(lf: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked token NLLs of fp32 logits over the whole padded vocab (the
    padding rows are in the log-sum-exp, as in ``repro``); the label logit
    is a gather, equal to ``repro``'s one-hot contraction."""
    logz = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - ll) * mask


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Mean masked NLL of (B, S, Vp) logits."""
    nll = _nll(logits.float(), labels, mask)
    return nll.sum() / mask.sum().clamp_min(1.0)


def _loss_chunk_size(s: int, cap: int = 512) -> int:
    """Largest divisor of s that is <= cap (full s if s <= cap)."""
    if s <= cap:
        return s
    for c in range(cap, 0, -1):
        if s % c == 0:
            return c
    return s


def chunked_lm_loss(model: Transformer, x: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy of final hidden states (B, S, D) without the
    (B, S, Vp) logits: the unembed and the loss run over sequence chunks in
    ``repro``'s order, each chunk rematerialized in the backward pass, so
    only one chunk's (B, C, Vp) logits are live."""
    cfg = model.cfg
    s = x.shape[1]
    c = _loss_chunk_size(s)

    def chunk(xi, li, mi):
        lf = layers.unembed(cfg, model.embed, xi).float()
        return _nll(lf, li, mi).sum(), mi.sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, s, c):
        nll, m = checkpoint(chunk, x[:, a : a + c], labels[:, a : a + c],
                            mask[:, a : a + c], use_reentrant=False)
        nll_sum, m_sum = nll_sum + nll, m_sum + m
    return nll_sum / m_sum.clamp_min(1.0)


def train_loss(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``repro``'s ``train_loss``: the chunked NLL of ``batch["tokens"]``
    (with ``batch["patches"]`` and ``batch["frames"]`` where present)
    against ``batch["labels"]`` under ``batch["mask"]``, plus 0.01 x the
    MoE aux loss.  Differentiable in the model's weights."""
    x, aux = model.train_hidden(batch["tokens"], patches=batch.get("patches"),
                                frames=batch.get("frames"))
    dev = model.device
    loss = chunked_lm_loss(model, x, torch.as_tensor(batch["labels"], device=dev),
                           torch.as_tensor(batch["mask"], device=dev))
    return loss + 0.01 * aux
