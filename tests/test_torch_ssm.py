"""Port parity: Mamba-2 (``repro_torch.models.ssm``) and the hybrid stack.

On the CPU, ``repro``'s weights carried over by ``params_from_jax``, the
same numpy-seeded inputs:

* ``ssm_forward`` of one layer within rtol 1e-4 / atol 1e-5 of ``repro``'s
  (fp32), at S a multiple of the chunk and not; the port's chunked
  forward equals S steps of its own ``ssm_decode`` from a zero cache; at
  a chunk of 256 it stays within the tolerance of the float64
  recurrence, where ``repro``'s cum_i - cum_j loses more;
* mamba2_780m and jamba_v01_52b smoke configs (jamba at its drop-free
  capacity 2.0) in fp32: forward logits and hidden states, prefill
  logits, the prefill caches (``h`` within the tolerance, the port's fp32
  conv tail rounding to ``repro``'s bf16 tail, attention k/v as in
  ``tests/test_torch_models.py``), and 4 decode steps from
  ``repro``'s caches carried across by ``caches_from_jax``;
* the port's own prefill then decode equals its forward pass at prefills
  of 28, 2 and 1 tokens (the last two shorter than the conv window); at
  28, ``repro``'s own prefill then decode misses its forward by more than
  1e-4, the bf16 conv tail the port does not copy;
* mamba2_780m in bf16: forward and decode within 2e-2, argmax equal where
  decisive (jamba stays fp32: bf16 router ties, see
  ``tests/test_torch_models.py``);
* ``train_loss`` and its gradients against ``jax.grad``; the scheduler on
  SSM lanes against sequential decode and ``repro``'s engine; params and
  train states round-tripped through ``repro``'s tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.sharding import ShardingRules
from repro.train import train_loop as jtrain
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import (caches_from_jax, params_from_jax,
                                        train_state_from_jax, train_state_to_jax)
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.scheduler import ContinuousBatchingEngine, Request
from repro_torch.train import train_loop as ttrain

RULES = ShardingRules()
B, S = 2, 32
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ARCHS = ("mamba2_780m", "jamba_v01_52b")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Small models under the suite's six workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True), compute_dtype=dtype),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True), compute_dtype=dtype))


def pair(arch, dtype="float32", seed=1):
    """(repro cfg, repro params, port model) on the same weights."""
    jcfg, tcfg = cfg_pair(arch, dtype)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    tm = tmodel.Transformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tm


_JITTED = {}


def jitted(cfg):
    """``repro``'s forward / hidden / prefill / decode_step, jitted once a config."""
    if cfg not in _JITTED:
        _JITTED[cfg] = (
            jax.jit(lambda p, t: jmodel.forward(cfg, p, t, RULES)[0]),
            jax.jit(lambda p, t: jmodel.forward(cfg, p, t, RULES, return_hidden=True)[0]),
            jax.jit(lambda p, t: jmodel.prefill(cfg, p, t, RULES)),
            jax.jit(lambda p, t, i, c: jmodel.decode_step(cfg, p, t, i, c, RULES)))
    return _JITTED[cfg]


def tokens_for(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=rtol, atol=atol, err_msg=msg)


def jax_layer_cache(cfg, caches, i):
    """``repro``'s cache of layer i (blocks stacked by pattern position)."""
    p = cfg.pattern_len
    if i < cfg.n_blocks * p:
        return jax.tree.map(lambda a: np.asarray(a)[i // p], caches["blocks"][i % p]["mixer"])
    return jax.tree.map(np.asarray, caches["tail"][i - cfg.n_blocks * p]["mixer"])


def assert_rounds_to(got, want_bf16, msg):
    """The port's conv tail ``got`` rounds to ``repro``'s bf16 tail: within
    half a bf16 ulp of it, plus the fp32 tolerance for a value that sits on
    a rounding tie (there the two packages' fp32 inputs, which differ in
    their last bits, may round either way)."""
    got, want = f32(got), f32(want_bf16)
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 8)
    bound = half_ulp + RTOL * np.abs(want) + ATOL
    assert (np.abs(got - want) <= bound).all(), msg


def assert_caches_match(cfg, jcaches, tcaches):
    """h within the tolerance, the conv tail rounding to ``repro``'s bf16
    tail; attention k/v within the tolerance, pos exactly."""
    assert len(tcaches) == cfg.n_layers
    for i, tc in enumerate(tcaches):
        jc = jax_layer_cache(cfg, jcaches, i)
        if isinstance(tc, tssm.SSMCache):
            assert tc.conv.dtype == tmodel.layers.compute_dtype(cfg)
            assert jc["conv"].dtype.itemsize == 2  # repro's bf16 tail
            close(tc.h, jc["h"], f"layer {i} h")
            assert tc.conv.shape == jc["conv"].shape
            assert_rounds_to(tc.conv, jc["conv"], f"layer {i} conv")
        else:
            close(tc.k, jc.k, f"layer {i} k")
            close(tc.v, jc.v, f"layer {i} v")
            for row in tc.pos.numpy():
                np.testing.assert_array_equal(row, jc.pos, err_msg=f"layer {i} pos")


def decisive_argmax_equal(got, want, gap=BF16_TOL):
    top2 = np.partition(want, -2, axis=-1)
    decisive = (top2[..., -1] - top2[..., -2]) > gap
    assert ((got.argmax(-1) == want.argmax(-1)) | ~decisive).all()


# ---------------------------------------------------------------------------
# One SSD layer
# ---------------------------------------------------------------------------


def ssm_pair(arch="mamba2_780m", seed=3):
    jcfg, tcfg = cfg_pair(arch)
    jp = jssm.ssm_init(jcfg, jax.random.key(seed))
    layer = tssm.SSM(tcfg, "cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jcfg, jp, tcfg, layer


@pytest.mark.parametrize("s", [32, 27])  # two chunks of 16; one and a padded one
def test_ssm_forward_matches_repro(s):
    jcfg, jp, tcfg, layer = ssm_pair()
    x = np.random.default_rng(0).standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.ssm_forward(jcfg, p, x, RULES))(jp, x)
    got, cache = tssm.ssm_forward(tcfg, layer, torch.from_numpy(x))
    assert cache is None and got.shape == (B, s, jcfg.d_model)
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_forward_equals_stepwise_decode(arch):
    """The SSD's chunked form and its recurrence are the same map: S steps
    of ``ssm_decode`` from a zero cache give the forward's outputs, and end
    in the prefill's cache."""
    _, _, tcfg, layer = ssm_pair(arch)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 21, tcfg.d_model)).astype(np.float32))
    full, pre = tssm.ssm_forward(tcfg, layer, x, emit_cache=True)
    cache = tssm.init_ssm_cache(tcfg, B, torch.float32)
    steps = [tssm.ssm_decode(tcfg, layer, x[:, t : t + 1], cache)[0] for t in range(21)]
    close(torch.cat(steps, dim=1), full)
    close(cache.h, pre.h)
    close(cache.conv, pre.conv)


def ssd_recurrence_f64(cfg, layer, x):
    """The SSM layer as its per-token recurrence in float64 (the exact map
    the chunked SSD computes)."""
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    b, s, _ = x.shape
    p = {k: v.double() for k, v in layer.state_dict().items()}
    z, xbc, dt_raw = tssm._split_proj(cfg, x.double() @ p["in_proj"])
    conv = tssm._causal_conv(xbc, p["conv_w"], p["conv_b"])
    conv = conv * torch.sigmoid(conv)
    xin = conv[..., :di].reshape(b, s, h, pd)
    bm, cm = conv[..., di : di + n], conv[..., di + n :]
    dt = torch.nn.functional.softplus(dt_raw + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    state = torch.zeros((b, h, n, pd), dtype=torch.float64)
    ys = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", bm[:, t], xin[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], state)
                  + xin[:, t] * p["d_skip"][None, :, None])
    y = torch.stack(ys, 1).reshape(b, s, di)
    g = y * (z * torch.sigmoid(z))
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-6) * p["norm_scale"]
    return g @ p["out_proj"]


def test_chunked_forward_keeps_fp32_accuracy_at_a_long_chunk():
    """mamba2_780m's chunk of 256 at smoke widths: the log-decays summed
    over a chunk pass -1,000, where ``repro``'s cum_i - cum_j loses the
    last bits of both terms; the port's segment sums keep the forward
    within rtol 1e-4 / atol 1e-5 of the float64 recurrence, ``repro``'s
    misses it by more than 3e-5."""
    jcfg, tcfg = (dataclasses.replace(c, ssm_chunk=256) for c in cfg_pair("mamba2_780m"))
    jp = jssm.ssm_init(jcfg, jax.random.key(3))
    layer = tssm.SSM(tcfg, "cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    x = np.random.default_rng(0).standard_normal((B, 512, jcfg.d_model)).astype(np.float32)
    exact = ssd_recurrence_f64(tcfg, layer, torch.from_numpy(x)).numpy()
    _, _, dt_raw = tssm._split_proj(tcfg, torch.from_numpy(x) @ layer.in_proj)
    _, da = tssm._decay_rates(layer, dt_raw)
    assert da[:, :256].sum(1).min() < -1000
    got, _ = tssm.ssm_forward(tcfg, layer, torch.from_numpy(x))
    close(got, exact)
    theirs = np.asarray(jax.jit(lambda p, x: jssm.ssm_forward(jcfg, p, x, RULES))(jp, x))
    assert np.abs(theirs - exact).max() > 3e-5


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_forward_prefill_decode_match_repro(arch):
    jcfg, jp, tm = pair(arch)
    forward, hidden, prefill, decode_step = jitted(jcfg)
    toks = tokens_for(jcfg)
    jlogits = forward(jp, jnp.asarray(toks))
    close(tm(toks), jlogits)
    close(tm(toks, return_hidden=True), hidden(jp, jnp.asarray(toks)))

    s_pre = S - 4  # 28: not a multiple of the chunk of 16
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :s_pre]))
    tpre, tc = tm.prefill(toks[:, :s_pre])
    close(tpre, jpre)
    jc, tc = jmodel.pad_caches(jcfg, jc, S), tm.pad_caches(tc, S)
    assert_caches_match(jcfg, jc, tc)
    # Decode from repro's caches, carried across with their dtypes.
    tc = caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), device="cpu")
    for t in range(s_pre, S):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        close(tl, jl, f"step {t}")


def repro_prefill_decode_gap(jcfg, jp, toks, s_pre):
    forward, _, prefill, decode_step = jitted(jcfg)
    full = f32(forward(jp, jnp.asarray(toks)))
    _, jc = prefill(jp, jnp.asarray(toks[:, :s_pre]))
    jc = jmodel.pad_caches(jcfg, jc, S)
    gap = 0.0
    for t in range(s_pre, S):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        gap = max(gap, float(np.abs(f32(jl) - full[:, t]).max()))
    return gap


@pytest.mark.parametrize("arch,s_pre", [(a, s) for a in ARCHS for s in (28, 2, 1)])
def test_prefill_then_decode_equals_forward(arch, s_pre):
    """fp32 within 1e-4 / 1e-5, prompts shorter than the conv window (cw - 1
    = 3) included; ``repro``'s bf16 conv tail misses by more than 1e-4."""
    jcfg, jp, tm = pair(arch, seed=4)
    toks = tokens_for(jcfg, seed=4)
    full = tm(toks)
    pre, caches = tm.prefill(toks[:, :s_pre])
    caches = tm.pad_caches(caches, S)
    close(pre, full[:, s_pre - 1])
    for t in range(s_pre, S):
        logits, caches = tm.decode_step(toks[:, t : t + 1], t, caches)
        close(logits, full[:, t], f"step {t}")
    if s_pre == 28:
        assert repro_prefill_decode_gap(jcfg, jp, toks, s_pre) > 1e-4


def test_bf16_forward_and_decode_match_repro():
    jcfg, jp, tm = pair("mamba2_780m", dtype="bfloat16", seed=2)
    forward, _, prefill, decode_step = jitted(jcfg)
    toks = tokens_for(jcfg, seed=2)
    want = f32(forward(jp, jnp.asarray(toks)))
    got = tm(toks)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    decisive_argmax_equal(f32(got), want)
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :-2]))
    tpre, tc = tm.prefill(toks[:, :-2])
    assert tc[0].conv.dtype == torch.bfloat16 and tc[0].h.dtype == torch.float32
    close(tpre, jpre, rtol=BF16_TOL, atol=BF16_TOL)
    for t in (S - 2, S - 1):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        close(tl, jl, rtol=BF16_TOL, atol=BF16_TOL)
        decisive_argmax_equal(f32(tl), f32(jl))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_repro(arch):
    """The loss within rtol 1e-5; each gradient entry within rtol 1e-4
    plus 1e-4 of its leaf's largest entry: through jamba's seven SSD
    backward passes the two packages' fp32 sums drift to ~3e-5 of a leaf's
    scale (layer 0's attention, the embedding)."""
    jcfg, jp, tm = pair(arch)
    tm.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(jcfg, p, b, RULES)))(jp, batch)
    tloss = tmodel.train_loss(tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(tloss, params)))
    want = params_from_jax(tm.cfg, jax.tree.map(f32, jgrads))
    assert set(grads) == set(want)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL + GRAD_RTOL * np.abs(w).max(), err_msg=name)


def test_scheduler_on_ssm_lanes_matches_sequential_and_repro():
    """Lanes of SSM caches (each lane's h and conv copied in at prefill):
    the engine's tokens equal sequential greedy decode exactly, and
    ``repro``'s engine wherever the sequential top-1 leads by > 2e-2."""
    jcfg, jp, tm = pair("mamba2_780m", seed=5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (9, 2, 12, 7)]
    new, max_seq = 6, 32
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_seq=max_seq)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=new))
    done = eng.run()
    jeng = JEngine(jcfg, jp, RULES, n_slots=2, max_seq=max_seq)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=new))
    jdone = jeng.run()
    for uid, p in enumerate(prompts):
        logits, caches = tm.prefill(p[None, :])
        want, seen = [int(logits.argmax(-1)[0])], [f32(logits[0])]
        for t in range(len(p), len(p) + new):
            logits, caches = tm.decode_step([[want[-1]]], t, caches)
            want.append(int(logits.argmax(-1)[0]))
            seen.append(f32(logits[0]))
        assert done[uid].output == want, (uid, done[uid].output, want)
        got = jdone[uid].output
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if first is not None:
            top2 = np.sort(seen[first])[-2:]
            assert top2[1] - top2[0] <= BF16_TOL, (uid, first, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_train_states_round_trip_through_repros_tree(arch):
    """``repro``'s train state -> the port's -> ``repro``'s tree, bit-equal
    leaf for leaf (structure included); the port's module has exactly
    ``repro``'s leaves, the SSM ones under ``mixer``."""
    jcfg, tcfg = cfg_pair(arch)
    jt = jtrain.TrainConfig(optimizer=jadamw.OptimizerConfig(lr=1e-3))
    tt = ttrain.TrainConfig(optimizer=tadamw.OptimizerConfig(lr=1e-3))
    jstate = jax.tree.map(np.asarray, jtrain.init_train_state(jcfg, jt, jax.random.key(6)))
    tstate = train_state_from_jax(tcfg, tt, jstate, device="cpu")
    ssm_names = {n for n in tstate["params"].state_dict() if ".mixer.in_proj" in n}
    assert len(ssm_names) == sum(s.mixer == "mamba" for s in tmodel.layer_specs(tcfg))
    back = train_state_to_jax(tcfg, tstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    jax.tree.map(np.testing.assert_array_equal, back, jstate)
    tm = tmodel.init_params(tcfg, 0, device="cpu")
    layer = next(m for m in tm.modules() if isinstance(m, tssm.SSM))
    h = tcfg.ssm_heads
    assert torch.equal(layer.a_log, torch.log(torch.linspace(1.0, float(h), h)))
    assert abs(layer.in_proj.std().item() * np.sqrt(tcfg.d_model) - 1.0) < 0.1
    assert set(tm.state_dict()) == set(params_from_jax(tcfg, jstate["params"]))
