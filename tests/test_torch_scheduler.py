"""Port parity: ``repro_torch.serve.scheduler`` and ``repro_torch.launch.serve``.

The continuous-batching engine on granite_3_8b's smoke config (fp32):
its tokens equal the port's sequential greedy decode exactly, and
``repro``'s engine on the same weights wherever the sequential logits'
top-1 leads by more than 2e-2; EOS and refill as in
``tests/test_scheduler.py``; a kNN-LM sampler composes with it.  The
serve driver runs in a subprocess on the CPU, single store and 4 logical
shards with churn and the engine, and the port's modules import no jax.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.sharding import ShardingRules
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,
                                         knn_lm_sampler)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = (9, 5, 12, 7, 10)  # ragged; more requests than slots
NEW = 6
MAX_SEQ = 32
GAP = 2e-2


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jconfigs.get_config("granite_3_8b", smoke=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("granite_3_8b", smoke=True),
                               compute_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tm = tmodel.Transformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tm


def prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


def sequential(tm, prompt, new, sample=None):
    """Greedy decode of one request alone; (tokens, logits of each pick)."""
    sample = sample or (lambda logits, hidden: logits.argmax(-1))
    logits, caches, hid = tm.prefill(prompt[None, :], with_hidden=True)
    caches = tm.pad_caches(caches, MAX_SEQ)
    out, seen = [int(sample(logits, hid)[0])], [logits[0].numpy()]
    for t in range(len(prompt), len(prompt) + new):
        logits, caches, hid = tm.decode_step([[out[-1]]], t, caches, with_hidden=True)
        out.append(int(sample(logits, hid)[0]))
        seen.append(logits[0].numpy())
    return out, seen


def test_engine_matches_sequential_decode_and_repro(models):
    jcfg, jp, tm = models
    ps = prompts(tm.cfg)
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_seq=MAX_SEQ)
    for uid, p in enumerate(ps):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW))
    done = eng.run()
    assert len(done) == len(ps) and eng.active == 0
    assert all(len(r.output) == NEW + 1 for r in done.values())  # prefill tok + NEW

    jeng = JEngine(jcfg, jp, ShardingRules(), n_slots=2, max_seq=MAX_SEQ)
    for uid, p in enumerate(ps):
        jeng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=NEW))
    jdone = jeng.run()
    for uid, p in enumerate(ps):
        want, seen = sequential(tm, p, NEW)
        assert done[uid].output == want, (uid, done[uid].output, want)
        got = jdone[uid].output
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if first is not None:  # only past a step whose top-1 was not decisive
            top2 = np.sort(seen[first])[-2:]
            assert top2[1] - top2[0] <= GAP, (uid, first, got, want)


def test_engine_eos_and_refill(models):
    _, _, tm = models
    p0 = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, 6).astype(np.int32)
    first = sequential(tm, p0, 0)[0][0]
    eng = ContinuousBatchingEngine(tm, n_slots=1, max_seq=MAX_SEQ)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=p0, max_new_tokens=3, eos_id=None))
    eng.submit(Request(uid=3, prompt=p0, max_new_tokens=5,
                       eos_id=sequential(tm, p0, 1)[0][1]))
    done = eng.run()
    assert len(done) == 4 and eng.active == 0  # one slot served all via refill
    assert all(done[u].output[0] == first and len(done[u].output) == 4 for u in range(3))
    assert len(done[3].output) == 2 and done[3].done  # stopped at its EOS


def test_windowed_lanes_at_different_positions_match_sequential():
    """gemma3's smoke config (local windows of 8): prompts shorter and
    longer than the window, in two lanes that decode at other positions."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3_1b", smoke=True),
                              compute_dtype="float32")
    tm = tmodel.init_params(cfg, 4, device="cpu")
    ps = prompts(cfg, seed=4)
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_seq=MAX_SEQ)
    for uid, p in enumerate(ps):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW))
    done = eng.run()
    for uid, p in enumerate(ps):
        assert done[uid].output == sequential(tm, p, NEW)[0]


def test_knn_lm_sampler_composes_with_the_engine(models):
    """Sampling through ``knn_lm_mix`` over a datastore of the model's own
    hidden states: the engine's tokens equal a sequential decode that
    mixes the same way."""
    from repro_torch.launch import serve
    from repro_torch.serve.retrieval import knn_lm_mix

    _, _, tm = models
    corpus = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (8, 33))
    store = serve.build_datastore(tm, corpus)
    sample = knn_lm_sampler(store, serve.SEARCH, lam=0.5)
    ps = prompts(tm.cfg, seed=5)
    eng = ContinuousBatchingEngine(tm, n_slots=3, max_seq=MAX_SEQ, sample=sample)
    for uid, p in enumerate(ps):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW))
    done = eng.run()
    mixed = 0
    for uid, p in enumerate(ps):
        want, seen = sequential(tm, p, NEW, sample=sample)
        assert done[uid].output == want
        mixed += sum(int(np.argmax(s) != w) for s, w in zip(seen, want))
    assert mixed > 0  # the datastore moved some picks off the model's argmax
    logp = knn_lm_mix(torch.zeros(2, tm.cfg.padded_vocab), torch.from_numpy(
        serve.datastore_keys(tm, corpus[:1])[0][:2].numpy()), store, serve.SEARCH)
    np.testing.assert_allclose(logp.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


# The driver as ``python -m repro_torch.launch.serve`` runs it (``runpy``),
# in a process that then imports the rest of the port's serving modules
# and reports any jax or repro module loaded.  One intra-op thread: the
# suite runs several workers at once.
_DRIVER = (
    "import runpy, sys\n"
    "sys.argv = ['repro_torch.launch.serve'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "import repro_torch.models.convert, repro_torch.serve.scheduler\n"
    "from repro_torch import configs\n"
    "for a in configs.ARCH_IDS:\n"
    "    configs.get_config(a); configs.get_config(a, smoke=True)\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    "print('[imports]', 'clean' if not bad else bad)\n"
)


@pytest.mark.parametrize("flags,lines", [
    (("--gen", "4", "--retrieval"),
     ("[retrieval] datastore: 1008 entries, mutable (single device)",
      "[prefill] 2x8 in", "[decode] 4 steps x batch 2:", "[tokens]")),
    (("--gen", "6", "--retrieval", "--shards", "4", "--churn", "--engine"),
     ("[retrieval] datastore: 1008 entries, sharded-mutable x4",
      "[engine] RetrievalEngine(index=ShardedMutableHilbertIndex", "batches /",
      "[churn] live=1010 deleted=2", "[churn] compacted -> segments=1",
      "[decode] 6 steps x batch 2:")),
], ids=["single_store", "sharded_churn_engine"])
def test_serve_driver(flags, lines):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _DRIVER, "--device", "cpu", "--arch",
                          "gemma3_1b", "--smoke", "--batch", "2", "--prompt-len", "8",
                          *flags],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    for line in lines:
        assert line in out.stdout, (line, out.stdout)
    assert ("[engine]" in out.stdout) == ("--engine" in flags)
    assert "[imports] clean" in out.stdout, out.stdout


def test_serve_driver_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--gen", "1"])
