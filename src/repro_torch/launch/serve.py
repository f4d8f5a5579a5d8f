"""Batched serving driver: prefill + autoregressive decode (+ retrieval).

Port of ``repro.launch.serve``.  CPU smoke::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch gemma3_1b --smoke --batch 4 --prompt-len 24 --gen 16 [--retrieval]

The model is random-initialised from ``--seed`` at the config's widths.
An encoder-decoder config (whisper_small) gets random frames and a config
with patches (llava_next_34b) random patch embeddings, for the prompts
and for the datastore's corpus, as ``repro``'s driver stubs them.
``--retrieval`` builds a kNN-LM datastore from the hidden states of a
16 x 64 token corpus through the model and mixes a Hilbert-forest lookup
into every decode step (:func:`repro_torch.serve.retrieval.knn_lm_mix`).
``--shards N`` builds it on N logical shards of the device (the
sharded-mutable layout); ``--churn`` appends each step's (hidden, token)
pairs every 4 steps and deletes the previous batch; ``--engine`` serves
the lookups through a :class:`~repro_torch.serve.engine.RetrievalEngine`
with background maintenance.  The body is functions a caller can drive
at any size: :func:`datastore_keys` and :func:`store_from_keys` (together
:func:`build_datastore`), and :func:`decode`.  ``--device`` defaults to
``cuda``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.types import ForestConfig, SearchParams
from repro_torch.index.config import IndexConfig
from repro_torch.models.model import Transformer, init_params
from repro_torch.serve.engine import MaintenancePolicy
from repro_torch.serve.retrieval import RetrievalStore, knn_lm_mix

SEARCH = SearchParams(k1=32, k2=64, h=1, k=8)
CORPUS = (16, 64)  # sequences x tokens of the CLI's datastore corpus
CHURN_EVERY = 4  # decode steps between churn batches


def retrieval_forest(d_model: int) -> ForestConfig:
    return ForestConfig(n_trees=8, bits=4, key_bits=min(256, d_model * 4), leaf_size=32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_inputs(cfg, rng: np.random.Generator, n: int) -> dict:
    """Random ``frames`` (n, enc_frames, D) and ``patches`` (n, n_patches,
    patch_dim), fp32, where the config takes them (``repro``'s stubs of the
    audio and vision front ends)."""
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = rng.normal(size=(n, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        extra["patches"] = rng.normal(size=(n, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return extra


def datastore_keys(model: Transformer, corpus, *, batch: int = 16, **extra
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys (n, D) fp32, values (n,)) of a (N, T) token corpus: the
    hidden state at each position but the last, keyed to the next token;
    ``batch`` sequences a forward pass.  ``extra``: the corpus's
    ``frames`` or ``patches`` (N, ...), as the config needs."""
    corpus = torch.as_tensor(corpus, device=model.device).long()
    extra = {k: torch.as_tensor(v, device=model.device) for k, v in extra.items()}
    keys = [model(corpus[i : i + batch], return_hidden=True,
                  **{k: v[i : i + batch] for k, v in extra.items()})[:, :-1]
            .reshape(-1, model.cfg.d_model).float()
            for i in range(0, corpus.shape[0], batch)]
    return torch.cat(keys), corpus[:, 1:].reshape(-1).to(torch.int32)


def store_from_keys(keys: torch.Tensor, values: torch.Tensor, *, shards: int = 1,
                    store_points: bool = False) -> RetrievalStore:
    """The kNN-LM datastore over (keys, values) on the keys' device.

    ``store_points`` keeps the raw keys, which compaction re-sorts (the
    churn path needs it); ``shards > 1`` selects the sharded-mutable
    layout on that many logical shards.
    """
    cfg = IndexConfig(forest=retrieval_forest(keys.shape[1]), store_points=store_points)
    return RetrievalStore.build(keys, values, cfg, shards=shards, device=keys.device)


def build_datastore(model: Transformer, corpus, *, shards: int = 1,
                    store_points: bool = False, batch: int = 16,
                    **extra) -> RetrievalStore:
    """The kNN-LM datastore of ``corpus`` (and its ``frames`` or
    ``patches``) through ``model``."""
    keys, vals = datastore_keys(model, corpus, batch=batch, **extra)
    return store_from_keys(keys, vals, shards=shards, store_points=store_points)


def decode(model: Transformer, prompts, gen: int, *,
           store: Optional[RetrievalStore] = None, params: SearchParams = SEARCH,
           lam: float = 0.25, churn: bool = False,
           on_step: Optional[Callable] = None, **extra) -> dict:
    """Prefill ``prompts`` (B, S) (with ``extra``: their ``frames`` or
    ``patches``) and decode ``gen`` greedy steps.

    With a ``store`` each step's hidden state queries it and the token is
    the argmax of :func:`knn_lm_mix`; with ``churn`` every 4th step
    appends the step's (hidden, token) pairs and deletes the batch
    appended before (a rolling-window datastore).  ``on_step(t, hidden,
    logp)`` runs after each step's mix, before its churn.  Returns the
    tokens (B, gen+1) and the prefill and decode seconds.
    """
    dev = model.device
    prompts = torch.as_tensor(prompts, device=dev).long()
    sp = prompts.shape[1]
    total = sp + gen
    t0 = time.perf_counter()
    logits, caches = model.prefill(prompts, **extra)
    caches = model.pad_caches(caches, total)
    tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    churned: list = []
    t0 = time.perf_counter()
    for t in range(sp, total):
        logits_t, caches, hid = model.decode_step(tok, t, caches, with_hidden=True)
        if store is None:
            tok = logits_t.argmax(dim=-1)[:, None]
        else:
            hid = hid.float()
            logp = knn_lm_mix(logits_t.float(), hid, store, params, lam=lam)
            tok = logp.argmax(dim=-1)[:, None]
            if on_step is not None:
                on_step(t, hid, logp)
            if churn and (t - sp) % CHURN_EVERY == 0:
                new_ids = store.append(hid, tok[:, 0])
                if churned:
                    store.delete(churned.pop())
                churned.append(new_ids)
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="build the retrieval datastore on this many logical "
                         "shards of the device (1 = the mutable store)")
    ap.add_argument("--churn", action="store_true",
                    help="append/delete datastore entries while decoding")
    ap.add_argument("--engine", action="store_true",
                    help="serve the datastore through the RetrievalEngine "
                         "(admission queue, micro-batcher, background "
                         "maintenance with an atomic index swap)")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="attach a write-ahead log under PATH (the store's "
                         "checkpoint directory)")
    ap.add_argument("--wal-sync-every", type=int, default=32,
                    help="fsync the WAL every N records")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="with --engine: per-request queue deadline")
    ap.add_argument("--lam", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /metrics.json and /trace on this "
                         "port (0 = ephemeral; the bound port is printed)")
    ap.add_argument("--trace-export", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome-trace JSON "
                         "on exit")
    ap.add_argument("--recall-probe", type=float, default=None, metavar="FRACTION",
                    help="with --engine: score online recall@k on this "
                         "fraction of served batches")
    ap.add_argument("--linger", type=float, default=0.0, metavar="SECONDS",
                    help="keep the process (and the metrics endpoint) alive "
                         "this long after the workload finishes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    from repro_torch import obs

    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = obs.serve_metrics(args.metrics_port)
        print(f"[obs] metrics endpoint at {metrics_server.url}/metrics "
              f"(also /metrics.json, /trace)", flush=True)
    if args.trace_export:
        obs.enable()

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = init_params(cfg, args.seed,
                        device=None if args.device == "cuda" else args.device)
    rng = np.random.default_rng(args.seed)
    b, sp = args.batch, args.prompt_len
    prompts = rng.integers(0, cfg.vocab_size, (b, sp))
    extra = stub_inputs(cfg, rng, b)

    store = None
    if args.retrieval:
        corpus = rng.integers(0, cfg.vocab_size, CORPUS)
        # compaction re-sorts raw keys, so the churn demo keeps them
        store = build_datastore(model, corpus, shards=args.shards,
                                store_points=args.churn,
                                **stub_inputs(cfg, rng, CORPUS[0]))
        layout = (f"sharded-mutable x{args.shards}" if store.is_sharded
                  else "mutable (single device)")
        n = CORPUS[0] * (CORPUS[1] - 1)
        print(f"[retrieval] datastore: {n} entries, {layout}")
        if args.wal:
            from repro_torch.checkpoint.wal import WalConfig

            store.enable_wal(args.wal, WalConfig(sync_every=args.wal_sync_every))
            print(f"[wal] durable writes -> {args.wal}/wal.log "
                  f"(sync_every={args.wal_sync_every})")
        if args.engine:
            recall_cfg = None
            if args.recall_probe:
                recall_cfg = obs.RecallProbeConfig(fraction=args.recall_probe,
                                                   seed=args.seed)
            engine = store.serving_engine(
                SEARCH, maintenance=MaintenancePolicy() if args.churn else None,
                recall=recall_cfg, default_deadline_ms=args.deadline_ms, start=True)
            print(f"[engine] {engine!r}")

    run = decode(model, prompts, args.gen, store=store, lam=args.lam,
                 churn=args.churn and store is not None, **extra)
    print(f"[prefill] {b}x{sp} in {run['prefill_s']:.2f}s")
    if store is not None and store.engine is not None:
        store.engine.stop(drain=True)
        snap = store.engine.metrics.snapshot()
        lat = snap["latency_ms"]
        print(f"[engine] {snap['counters']['batches']} batches / "
              f"{snap['counters']['rows_searched']} rows, "
              f"p50={lat.get('p50', 0):.1f}ms p99={lat.get('p99', 0):.1f}ms, "
              f"swaps={snap['counters']['swaps']} "
              f"(maintenance runs={snap['counters']['maintenance_runs']})")
    if store is not None and args.churn:
        rep = store.memory_report()
        print(f"[churn] live={rep['n_live']} deleted={rep['n_deleted']} "
              f"buffered={rep['n_buffered']} segments={rep['n_segments']}")
        store.compact()
        print(f"[churn] compacted -> segments={store.memory_report()['n_segments']}")
    gen = run["tokens"].cpu().numpy()
    print(f"[decode] {args.gen} steps x batch {b}: "
          f"{1000 * run['decode_s'] / max(args.gen, 1):.0f} ms/step")
    print("[tokens]", gen[0][:16], "...")
    if args.trace_export:
        obs.default_tracer().dump(args.trace_export)
        print(f"[obs] wrote Chrome trace to {args.trace_export}", flush=True)
    if args.linger > 0:
        print(f"[obs] lingering {args.linger:.0f}s for scrapers", flush=True)
        time.sleep(args.linger)
    if metrics_server is not None:
        metrics_server.close()


if __name__ == "__main__":
    main()
