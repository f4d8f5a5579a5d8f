"""Port parity: the encoder-decoder and patch inputs of ``repro_torch.models``.

On the CPU, ``repro``'s weights carried over by ``params_from_jax``, the
same numpy-seeded tokens, frames and patches:

* ``sinusoidal_positions`` against ``repro``'s;
* whisper_small (12 + 12 layers cut to its smoke 2 + 2, 16 frames,
  cross-attention, no rotary embedding) and llava_next_34b (8 patches
  overwriting the first positions) smoke configs in fp32: forward logits
  and hidden states, prefill logits and caches (self and cross k/v within
  rtol 1e-4 / atol 1e-5, pos exactly), 4 decode steps from ``repro``'s
  caches carried across; in bf16 within 2e-2, argmax equal where decisive;
* the port's own prefill then decode equals its forward pass;
* ``train_loss`` and its gradients with frames and patches against
  ``jax.grad``; params and train states round-tripped through ``repro``'s
  tree (``enc`` stacked over its layers, ``patch_proj``);
* a prompt shorter than ``n_patches`` raises in both packages, and an
  encoder-decoder without frames raises;
* ``python -m repro_torch.launch.serve --device cpu --smoke`` for both
  configs, with no jax imported.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.sharding import ShardingRules
from repro.train import train_loop as jtrain
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.convert import (caches_from_jax, params_from_jax,
                                        train_state_from_jax, train_state_to_jax)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_loop as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ShardingRules()
B, S = 2, 32
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ARCHS = ("whisper_small", "llava_next_34b")


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


def inputs(cfg, seed=1, b=B, s=S):
    """Tokens (b, s) and the config's frames or patches, fp32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = rng.normal(size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        extra["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return toks, extra


_JITTED = {}


def jitted(cfg):
    """``repro``'s forward / hidden / prefill / decode_step, jitted once a config."""
    if cfg not in _JITTED:
        _JITTED[cfg] = (
            jax.jit(lambda p, t, e: jmodel.forward(cfg, p, t, RULES, **e)[0]),
            jax.jit(lambda p, t, e: jmodel.forward(cfg, p, t, RULES, return_hidden=True,
                                                   **e)[0]),
            jax.jit(lambda p, t, e: jmodel.prefill(cfg, p, t, RULES, **e)),
            jax.jit(lambda p, t, i, c: jmodel.decode_step(cfg, p, t, i, c, RULES)))
    return _JITTED[cfg]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=rtol, atol=atol, err_msg=msg)


def assert_caches_match(cfg, jcaches, tcaches):
    """Self caches (and cross caches where the layer has them): k, v within
    the tolerance, pos exactly."""
    p = cfg.pattern_len
    for i, tc in enumerate(tcaches):
        spec = cfg.pattern[i % p]
        if i < cfg.n_blocks * p:
            jc = jax.tree.map(lambda a: np.asarray(a)[i // p], jcaches["blocks"][i % p])
        else:
            jc = jax.tree.map(np.asarray, jcaches["tail"][i - cfg.n_blocks * p])
        pairs = [("self", tc, jc["mixer"])]
        if spec.cross_attn:
            assert tc.cross.k.shape[1] == cfg.enc_frames
            pairs.append(("cross", tc.cross, jc["cross"]))
        else:
            assert tc.cross is None
        for what, t, j in pairs:
            close(t.k, j.k, f"layer {i} {what} k")
            close(t.v, j.v, f"layer {i} {what} v")
            for row in t.pos.numpy():
                np.testing.assert_array_equal(row, j.pos, err_msg=f"layer {i} {what} pos")


def decisive_argmax_equal(got, want, gap=BF16_TOL):
    top2 = np.partition(want, -2, axis=-1)
    decisive = (top2[..., -1] - top2[..., -2]) > gap
    assert ((got.argmax(-1) == want.argmax(-1)) | ~decisive).all()


def test_sinusoidal_positions_match_repro():
    pos = np.arange(0, 4096, 7, dtype=np.int32)[None].repeat(2, 0)
    for d in (64, 768, 2):
        want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), d))
        got = tlayers.sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        # The angle grows with the position: 4,000 x one fp32 ulp of a frequency.
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
        np.testing.assert_allclose(got.numpy()[:, :10], want[:, :10], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_forward_prefill_decode_match_repro(arch):
    jcfg, jp, tm = pair(arch)
    forward, hidden, prefill, decode_step = jitted(jcfg)
    toks, extra = inputs(jcfg)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    close(tm(toks, **extra), forward(jp, jnp.asarray(toks), jextra))
    close(tm(toks, return_hidden=True, **extra), hidden(jp, jnp.asarray(toks), jextra))

    s_pre = S - 4
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :s_pre]), jextra)
    tpre, tc = tm.prefill(toks[:, :s_pre], **extra)
    close(tpre, jpre)
    jc, tc = jmodel.pad_caches(jcfg, jc, S), tm.pad_caches(tc, S)
    assert_caches_match(jcfg, jc, tc)
    tc = caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), device="cpu")
    for t in range(s_pre, S):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        close(tl, jl, f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_decode_match_repro(arch):
    jcfg, jp, tm = pair(arch, dtype="bfloat16", seed=2)
    forward, _, prefill, decode_step = jitted(jcfg)
    toks, extra = inputs(jcfg, seed=2)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    want = f32(forward(jp, jnp.asarray(toks), jextra))
    got = tm(toks, **extra)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    decisive_argmax_equal(f32(got), want)
    jpre, jc = prefill(jp, jnp.asarray(toks[:, :-2]), jextra)
    tpre, tc = tm.prefill(toks[:, :-2], **extra)
    close(tpre, jpre, rtol=BF16_TOL, atol=BF16_TOL)
    jc, tc = jmodel.pad_caches(jcfg, jc, S), tm.pad_caches(tc, S)
    for t in (S - 2, S - 1):
        jl, jc = decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = tm.decode_step(toks[:, t : t + 1], t, tc)
        close(tl, jl, rtol=BF16_TOL, atol=BF16_TOL)
        decisive_argmax_equal(f32(tl), f32(jl))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    _, _, tm = pair(arch, seed=4)
    toks, extra = inputs(tm.cfg, seed=4)
    full = tm(toks, **extra)
    s_pre = 12  # past llava's 8 patches
    pre, caches = tm.prefill(toks[:, :s_pre], **extra)
    caches = tm.pad_caches(caches, S)
    close(pre, full[:, s_pre - 1])
    for t in range(s_pre, S):
        logits, caches = tm.decode_step(toks[:, t : t + 1], t, caches)
        close(logits, full[:, t], f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_repro(arch):
    jcfg, jp, tm = pair(arch)
    tm.requires_grad_(True)
    toks, extra = inputs(jcfg, seed=0)
    rng = np.random.default_rng(9)
    batch = {"tokens": toks, "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32), **extra}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(jcfg, p, b, RULES)))(jp, batch)
    tloss = tmodel.train_loss(tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(tloss, params)))
    want = params_from_jax(tm.cfg, jax.tree.map(f32, jgrads))
    assert set(grads) == set(want)
    assert any(n.startswith("enc.") for n in grads) == jcfg.is_encdec
    assert ("patch_proj" in grads) == bool(jcfg.n_patches)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_train_states_round_trip_through_repros_tree(arch):
    jcfg, tcfg = cfg_pair(arch)
    jt = jtrain.TrainConfig(optimizer=jadamw.OptimizerConfig(lr=1e-3))
    tt = ttrain.TrainConfig(optimizer=tadamw.OptimizerConfig(lr=1e-3))
    jstate = jax.tree.map(np.asarray, jtrain.init_train_state(jcfg, jt, jax.random.key(6)))
    tstate = train_state_from_jax(tcfg, tt, jstate, device="cpu")
    back = train_state_to_jax(tcfg, tstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    jax.tree.map(np.testing.assert_array_equal, back, jstate)
    tm = tmodel.init_params(tcfg, 0, device="cpu")
    assert set(tm.state_dict()) == set(params_from_jax(tcfg, jstate["params"]))
    if tcfg.n_patches:
        assert abs(tm.patch_proj.std().item() - 0.02) < 0.002


def test_prompt_shorter_than_patches_raises_in_both_packages():
    jcfg, jp, tm = pair("llava_next_34b")
    toks, extra = inputs(jcfg, s=jcfg.n_patches - 1)
    with pytest.raises(Exception):
        jmodel.forward(jcfg, jp, jnp.asarray(toks), RULES,
                       patches=jnp.asarray(extra["patches"]))
    with pytest.raises(ValueError, match="patches do not fit"):
        tm(toks, **extra)
    with pytest.raises(ValueError, match="patches do not fit"):
        tm.prefill(toks, **extra)
    _, _, whisper = pair("whisper_small")
    with pytest.raises(ValueError, match="needs frames"):
        whisper(toks)


# The driver as ``python -m repro_torch.launch.serve`` runs it, then a check
# that no jax or repro module was loaded (``tests/test_torch_scheduler.py``).
_DRIVER = (
    "import runpy, sys\n"
    "sys.argv = ['repro_torch.launch.serve'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    "print('[imports]', 'clean' if not bad else bad)\n"
)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_with_frames_and_patches(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _DRIVER, "--device", "cpu", "--arch", arch,
                          "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "4",
                          "--retrieval"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    for line in ("[retrieval] datastore: 1008 entries, mutable (single device)",
                 "[prefill] 2x12 in", "[decode] 4 steps x batch 2:", "[tokens]",
                 "[imports] clean"):
        assert line in out.stdout, (line, out.stdout)
