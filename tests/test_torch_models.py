"""Port parity: ``repro_torch.models`` against ``repro.models``.

Both packages run the same weights (``repro``'s ``init_params``, carried
over by ``params_from_jax``) on the same numpy-seeded tokens, on the CPU:

* fp32: forward logits and hidden states, prefill logits, the caches after
  ``pad_caches`` and after each of 4 decode steps (k/v within rtol 1e-4 /
  atol 1e-5, ``pos`` exactly), the decode logits within the same;
* bf16: forward and decode logits within 2e-2, argmax equal where the
  reference's top-1 leads by more than 2e-2;
* the port alone: prefill then decode equals the forward pass, also for a
  prompt shorter than a local window (where ``repro``'s cache is wrong);
* the configs: every field of all ten, ``param_count`` at published
  scale, the shape rules (Mamba-2, the hybrid, the encoder-decoder and
  patch inputs are held to ``repro`` in ``tests/test_torch_ssm.py`` and
  ``tests/test_torch_encdec.py``).

The MoE decoders (granite_moe_1b, mixtral_8x22b) run the fp32 checks at
their smoke configs' drop-free capacity.  The bf16 checks stay with the
dense decoders: in bf16 a token whose router scores tie within rounding
picks another expert in either package, which moves its whole FFN output
(`tests/test_torch_moe.py` holds the routing itself, ties included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.sharding import ShardingRules
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax

RULES = ShardingRules()
B, S = 2, 32
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
DENSE_PARITY_ARCHS = ("gemma3_1b", "granite_3_8b")
PARITY_ARCHS = DENSE_PARITY_ARCHS + ("granite_moe_1b", "mixtral_8x22b")
DENSE_ARCHS = ("yi_34b", "gemma3_1b", "nemotron_4_340b", "granite_3_8b")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The models here are small and the suite's workers share the cores:
    one intra-op thread (with eight, on an 8-core CPU under six workers,
    tests here ran up to 40x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch, dtype="float32", seed=1):
    """(repro cfg, repro params, port model) on the same weights."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), compute_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), compute_dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    tm = tmodel.Transformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tm


def jitted(cfg):
    """``repro``'s forward / hidden / prefill / decode_step, each jitted
    once (the eager calls compile every op: 4x slower here)."""
    return (jax.jit(lambda p, t: jmodel.forward(cfg, p, t, RULES)[0]),
            jax.jit(lambda p, t: jmodel.forward(cfg, p, t, RULES, return_hidden=True)[0]),
            jax.jit(lambda p, t: jmodel.prefill(cfg, p, t, RULES)),
            jax.jit(lambda p, t, i, c: jmodel.decode_step(cfg, p, t, i, c, RULES)))


def tokens_for(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_layer_cache(cfg, caches, i):
    """``repro``'s cache of layer i (blocks stacked by pattern position)."""
    p = cfg.pattern_len
    if i < cfg.n_blocks * p:
        c = caches["blocks"][i % p]["mixer"]
        return tuple(np.asarray(a)[i // p] for a in (c.k, c.v, c.pos))
    c = caches["tail"][i - cfg.n_blocks * p]["mixer"]
    return tuple(np.asarray(a) for a in (c.k, c.v, c.pos))


def assert_caches_match(cfg, jcaches, tcaches):
    assert len(tcaches) == cfg.n_layers
    for i, tc in enumerate(tcaches):
        jk, jv, jpos = jax_layer_cache(cfg, jcaches, i)
        assert tc.k.shape == jk.shape, (i, tc.k.shape, jk.shape)
        np.testing.assert_allclose(f32(tc.k), jk.astype(np.float32), rtol=RTOL, atol=ATOL,
                                   err_msg=f"layer {i} k")
        np.testing.assert_allclose(f32(tc.v), jv.astype(np.float32), rtol=RTOL, atol=ATOL,
                                   err_msg=f"layer {i} v")
        for row in tc.pos.numpy():
            np.testing.assert_array_equal(row, jpos, err_msg=f"layer {i} pos")


def decisive_argmax_equal(got, want, gap=BF16_TOL):
    top2 = np.partition(want, -2, axis=-1)
    decisive = (top2[..., -1] - top2[..., -2]) > gap
    assert ((got.argmax(-1) == want.argmax(-1)) | ~decisive).all()


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_fp32_forward_prefill_decode_match_repro(arch):
    jcfg, jp, tm = pair(arch)
    forward, hidden, prefill, decode_step = jitted(jcfg)
    toks = tokens_for(jcfg)
    jlogits = forward(jp, jnp.asarray(toks))
    np.testing.assert_allclose(f32(tm(toks)), f32(jlogits), rtol=RTOL, atol=ATOL)
    jhid = hidden(jp, jnp.asarray(toks))
    np.testing.assert_allclose(f32(tm(toks, return_hidden=True)), f32(jhid), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f32(tm(toks, last_only=True)), f32(jlogits[:, -1:]),
                               rtol=RTOL, atol=ATOL)

    s_pre = S - 4
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :s_pre]))
    tpre, tc = tm.prefill(toks[:, :s_pre])
    np.testing.assert_allclose(f32(tpre), f32(jpre), rtol=RTOL, atol=ATOL)
    jc = jmodel.pad_caches(jcfg, jc, S)
    tc = tm.pad_caches(tc, S)
    assert_caches_match(jcfg, jc, tc)
    for t in range(s_pre, S):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {t}")
        assert_caches_match(jcfg, jc, tc)


@pytest.mark.parametrize("arch", DENSE_PARITY_ARCHS)
def test_bf16_forward_and_decode_match_repro(arch):
    jcfg, jp, tm = pair(arch, dtype="bfloat16", seed=2)
    forward, _, prefill, decode_step = jitted(jcfg)
    toks = tokens_for(jcfg, seed=2)
    jlogits = forward(jp, jnp.asarray(toks))
    tlogits = tm(toks)
    assert tlogits.dtype == torch.bfloat16
    want = f32(jlogits)
    np.testing.assert_allclose(f32(tlogits), want, rtol=BF16_TOL, atol=BF16_TOL)
    decisive_argmax_equal(f32(tlogits), want)
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :-2]))
    tpre, tc = tm.prefill(toks[:, :-2])
    np.testing.assert_allclose(f32(tpre), f32(jpre), rtol=BF16_TOL, atol=BF16_TOL)
    jc, tc = jmodel.pad_caches(jcfg, jc, S), tm.pad_caches(tc, S)
    for t in (S - 2, S - 1):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=BF16_TOL, atol=BF16_TOL)
        decisive_argmax_equal(f32(tl), f32(jl))


@pytest.mark.parametrize("arch,s_pre", [(a, S - 4) for a in DENSE_ARCHS]
                         + [("gemma3_1b", 5)])
def test_prefill_then_decode_consistency(arch, s_pre):
    """Prefill + decode reproduce the teacher-forced forward logits (fp32),
    as ``repro``'s ``test_prefill_then_decode_consistency``; ``s_pre`` 5 is
    shorter than gemma3's smoke window of 8."""
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), compute_dtype="float32")
    tm = tmodel.init_params(cfg, 1, device="cpu")
    toks = tokens_for(cfg)
    full = f32(tm(toks))
    pre, caches = tm.prefill(toks[:, :s_pre])
    caches = tm.pad_caches(caches, S)
    np.testing.assert_allclose(f32(pre), full[:, s_pre - 1], rtol=2e-2, atol=2e-2)
    for t in range(s_pre, S):
        logits, caches = tm.decode_step(toks[:, t : t + 1], t, caches)
        np.testing.assert_allclose(f32(logits), full[:, t], rtol=2e-2, atol=2e-2)
        decisive_argmax_equal(f32(logits), full[:, t])


def test_per_row_positions_decode_like_separate_rows():
    """A (B,) position vector: each row decodes as it would alone."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3_1b", smoke=True),
                              compute_dtype="float32")
    tm = tmodel.init_params(cfg, 3, device="cpu")
    toks = tokens_for(cfg, seed=3)
    lens = (11, 20)
    caches = tm.make_decode_caches(2, S, dtype=torch.float32)
    alone = []
    for r, n in enumerate(lens):
        _, c = tm.prefill(toks[r : r + 1, :n])
        c = tm.pad_caches(c, S)
        for lane, one in zip(caches, c):
            lane.k[r], lane.v[r], lane.pos[r] = one.k[0], one.v[0], one.pos[0]
        logits, _ = tm.decode_step(toks[r : r + 1, n : n + 1], n, c)
        alone.append(f32(logits)[0])
    step = np.array([toks[0, lens[0]], toks[1, lens[1]]])[:, None]
    logits, _ = tm.decode_step(step, torch.tensor(lens), caches)
    np.testing.assert_allclose(f32(logits), np.stack(alone), rtol=RTOL, atol=ATOL)


def test_bf16_copy_of_large_weights_is_made_once():
    cfg = dataclasses.replace(tconfigs.get_config("gemma3_1b", smoke=True), d_model=1024,
                              vocab_size=1024)
    tm = tmodel.init_params(cfg, 0, device="cpu")
    cast = tm.embed._cast["embed"]
    assert cast.dtype == torch.bfloat16 and cast.numel() > 1_000_000
    assert not tm.layers[0].mixer._cast  # (1024, 64) stays fp32
    assert tm.embed.w("embed", torch.bfloat16) is cast
    fp32 = tmodel.init_params(dataclasses.replace(cfg, compute_dtype="float32"), 0,
                              device="cpu")
    assert not fp32.embed._cast


def test_init_params_draws_repros_distributions():
    cfg = tconfigs.get_config("granite_3_8b", smoke=True)
    tm = tmodel.init_params(cfg, 0, device="cpu")
    a = tmodel.init_params(cfg, 0, device="cpu").state_dict()
    assert all(torch.equal(v, a[k]) for k, v in tm.state_dict().items())
    wq = tm.layers[0].mixer.wq
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.1
    assert abs(tm.embed.embed.std().item() - 0.02) < 0.002
    assert torch.equal(tm.final_norm.scale, torch.ones(cfg.d_model))
    assert sum(p.numel() for p in tm.parameters()) == cfg.param_count()
    jcfg = jconfigs.get_config("granite_3_8b", smoke=True)
    jp = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(0)))
    assert set(params_from_jax(cfg, jp)) == set(tm.state_dict())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_and_param_counts_equal_repro(arch):
    for smoke in (False, True):
        j, t = jconfigs.get_config(arch, smoke=smoke), tconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.padded_vocab, t.pattern_len, t.n_blocks) == (j.padded_vocab,
                                                               j.pattern_len, j.n_blocks)
        for shape in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(t, shape) == jconfigs.shape_applicable(j, shape)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and tconfigs.SHAPES == jconfigs.SHAPES


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.Transformer(tconfigs.get_config("gemma3_1b", smoke=True))


def test_serving_cache_follows_in_place_updates_and_training_casts_carry_grads():
    """The bf16 copy of a big weight is never served once the weight has
    changed in place (an optimizer step); a training forward casts inside
    the graph, so the fp32 weight gets its gradient."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3_1b", smoke=True), d_model=1024,
                              vocab_size=1024)
    tm = tmodel.init_params(cfg, 0, device="cpu")
    toks = tokens_for(cfg, s=8)
    before = tm(toks)
    with torch.no_grad():
        tm.embed.embed.mul_(2.0)
    fresh = tmodel.Transformer(cfg, device="cpu")
    fresh.load_state_dict(tm.state_dict())
    after = tm(toks)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh(toks))
    tm.requires_grad_(True)
    x, _ = tm.train_hidden(toks)
    assert tm.embed._step_cast["embed"].grad_fn is not None and not tm.embed._cast
    (g,) = torch.autograd.grad(x.float().square().sum(), [tm.embed.embed])
    assert g.dtype == torch.float32 and g.abs().sum() > 0
    tm.release_step()
    assert torch.equal(tm(toks), after)
