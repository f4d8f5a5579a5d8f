"""Port parity: the training side of ``repro_torch`` against ``repro``.

On the CPU, on the same numpy-seeded inputs and the same weights
(``params_from_jax``):

* losses: ``chunked_lm_loss`` (several chunks) and ``lm_loss`` within rtol
  1e-5, ``train_loss`` on four smoke configs (dense and MoE) in fp32 within
  rtol 1e-5 with gradients within rtol 1e-4 / atol 1e-6 of ``jax.grad``,
  and in bf16 within the bf16 tests' 2e-2;
* remat: the three policies give bit-equal gradients;
* AdamW fed the same numpy gradients: params, m, v and err within 1e-6 of
  ``repro``'s ``apply_updates`` for every compression mode and bf16
  moments; ``lr_at`` within one float32 ulp over a whole schedule;
* the train step: 5-step loss trajectories within rtol 1e-4 of ``repro``'s
  jitted ``make_train_step`` (gemma3_1b with bf16 moments, granite_moe_1b
  with 2 microbatches); microbatch accumulation equal to the full batch,
  and summed in bf16 under ``accum_dtype="bfloat16"``;
* the token pipeline bit-equal to ``repro``'s, host-sharded too;
* train checkpoints across packages (bf16 moments included), bit-exact
  resume, ``AsyncCheckpointer`` snapshots and partial ``.tmp`` steps, and
  ``repro_torch.launch.train``'s resume.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.sharding import ShardingRules
from repro.train import train_loop as jtrain
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_verifiable_step,
                                    restore_tree)
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models.convert import (params_from_jax, train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_loop as ttrain

RULES = ShardingRules()
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_TOL = 2e-2
OPT_TOL = 1e-6
TRAJ_RTOL = 1e-4
LOSS_ARCHS = ("gemma3_1b", "granite_3_8b", "granite_moe_1b", "mixtral_8x22b")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The models here are small and the suite's workers share the cores:
    one intra-op thread (with eight, on an 8-core CPU under six workers,
    tests here ran up to 40x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw))


def model_pair(arch, seed=1, **kw):
    jcfg, tcfg = cfg_pair(arch, **kw)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    tm = tmodel.Transformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    tm.requires_grad_(True)
    return jcfg, jp, tm


def numpy_batch(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def f32(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def named_grads(tm, loss):
    names, params = zip(*tm.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_chunked_and_plain_lm_loss_match_repro():
    """S = 1030 gives 5 chunks of 206 (its largest divisor <= 512); the
    labels reach the padded vocab's last real token, and a masked row."""
    jcfg, jp, tm = model_pair("granite_3_8b")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1030, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 1030)).astype(np.int32)
    labels[0, 0] = jcfg.vocab_size - 1
    mask = np.ones((2, 1030), np.float32)
    mask[1, 500:] = 0
    assert tmodel._loss_chunk_size(1030) == jmodel._loss_chunk_size(1030) == 206
    jloss, jgx = jax.jit(jax.value_and_grad(
        lambda x: jmodel.chunked_lm_loss(jcfg, jp, x, labels, mask, RULES)))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    tloss = tmodel.chunked_lm_loss(tm, tx, torch.from_numpy(labels), torch.from_numpy(mask))
    (tgx,) = torch.autograd.grad(tloss, [tx])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    logits = rng.standard_normal((2, 8, jcfg.padded_vocab)).astype(np.float32)
    np.testing.assert_allclose(
        float(tmodel.lm_loss(tm.cfg, torch.from_numpy(logits), torch.from_numpy(labels[:, :8]),
                             torch.from_numpy(mask[:, :8]))),
        float(jmodel.lm_loss(jcfg, logits, labels[:, :8], mask[:, :8])), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in LOSS_ARCHS]
                         + [("granite_3_8b", "bfloat16")])
def test_train_loss_and_grads_match_repro(arch, dtype):
    jcfg, jp, tm = model_pair(arch, compute_dtype=dtype)
    batch = numpy_batch(jcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(jcfg, p, b, RULES)))(jp, batch)
    tloss = tmodel.train_loss(tm, torch_batch(batch))
    grads = named_grads(tm, tloss)
    want = params_from_jax(tm.cfg, f32(jgrads))
    assert set(grads) == set(want)
    loss_rtol, rtol, atol = ((LOSS_RTOL, GRAD_RTOL, GRAD_ATOL) if dtype == "float32"
                             else (BF16_TOL,) * 3)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=loss_rtol)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b"])
def test_remat_policies_give_bit_equal_gradients(arch):
    _, _, tm = model_pair(arch)
    batch = torch_batch(numpy_batch(tm.cfg.vocab_size, seed=3))
    out = {}
    for policy in ("none", "full", "minimal"):
        tm.cfg = dataclasses.replace(tm.cfg, remat_policy=policy)
        loss = tmodel.train_loss(tm, batch)
        out[policy] = (loss.detach(), named_grads(tm, loss))
    for policy in ("full", "minimal"):
        assert torch.equal(out[policy][0], out["none"][0])
        for name, g in out["none"][1].items():
            assert torch.equal(out[policy][1][name], g), (policy, name)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT_SHAPES = {"a": (64, 48), "b": (48,), "c": (3, 16, 40)}


@pytest.mark.parametrize("moment_dtype,compression,clip_norm", [
    ("float32", "none", 0.5), ("float32", "bf16", 0.5), ("float32", "topk", 0.5),
    ("bfloat16", "none", 1e3), ("bfloat16", "topk", 1e3)])
def test_adamw_matches_repro_on_the_same_gradients(moment_dtype, compression, clip_norm):
    """bf16 moments run unclipped: the clip scale comes from a norm whose
    summation order differs by package, and one ulp of the scale can round
    a moment to the neighbouring bf16 value."""
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, moment_dtype=moment_dtype,
                compression=compression, clip_norm=clip_norm)
    jcfg, tcfg = jadamw.OptimizerConfig(**ocfg), tadamw.OptimizerConfig(**ocfg)
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = jadamw.init_opt_state(jparams, jcfg)
    tstate = tadamw.init_opt_state(tparams, tcfg)
    jupdate = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, jcfg))
    for _ in range(4):
        grads = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                 for k, s in OPT_SHAPES.items()}
        jparams, jstate, jm = jupdate(jparams, {k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate)
        tparams, tstate, tm = tadamw.apply_updates(
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=OPT_TOL)
        assert int(tstate["step"]) == int(jstate["step"])
        for k in OPT_SHAPES:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)
            for leaf in ("m", "v", "err"):
                if leaf in jstate:
                    assert tstate[leaf][k].dtype == getattr(torch, str(jstate[leaf][k].dtype))
                    np.testing.assert_allclose(
                        tstate[leaf][k].float().numpy(), f32(jstate[leaf][k]),
                        rtol=OPT_TOL, atol=OPT_TOL, err_msg=f"{leaf} {k}")


def test_lr_schedule_within_one_ulp_of_repro():
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.lr_at(jadamw.OptimizerConfig(**cfg), s))(
        jnp.asarray(steps)))
    got = tadamw.lr_at(tadamw.OptimizerConfig(**cfg), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


# ---------------------------------------------------------------------------
# The train step and the data pipeline
# ---------------------------------------------------------------------------


def train_configs(n_micro=1, moment_dtype="float32", accum="float32"):
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5, moment_dtype=moment_dtype)
    return (jtrain.TrainConfig(n_microbatches=n_micro, accum_dtype=accum,
                               optimizer=jadamw.OptimizerConfig(**ocfg)),
            ttrain.TrainConfig(n_microbatches=n_micro, accum_dtype=accum,
                               optimizer=tadamw.OptimizerConfig(**ocfg)))


def pipelines(vocab, batch=4, seq=S):
    return (jpipeline.TokenPipeline(jpipeline.DataConfig(vocab, batch, seq)),
            tpipeline.TokenPipeline(tpipeline.DataConfig(vocab, batch, seq)))


def assert_trajectories_match(jcfg, tcfg, jt, tt, jstep, seed):
    """5 steps of both packages from ``repro``'s initial state."""
    jstate = jtrain.init_train_state(jcfg, jt, jax.random.key(seed))
    tstate = train_state_from_jax(tcfg, tt, jax.tree.map(np.asarray, jstate), device="cpu")
    tstep = ttrain.make_train_step(tcfg, tt)
    jpipe, tpipe = pipelines(jcfg.vocab_size)
    for s in range(5):
        jstate, jm = jstep(jstate, jpipe.batch_at(s))
        tstate, tm = tstep(tstate, tpipe.torch_batch(s, "cpu"))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TRAJ_RTOL,
                                       err_msg=f"step {s} {key}")
    assert int(tstate["step"]) == int(jstate["step"]) == 5


def test_train_steps_match_repro_moe_microbatches():
    jcfg, tcfg = cfg_pair("granite_moe_1b")
    jt, tt = train_configs(n_micro=2)
    assert_trajectories_match(jcfg, tcfg, jt, tt,
                              jax.jit(jtrain.make_train_step(jcfg, jt, RULES)), 3)


def test_microbatch_accumulation_matches_the_full_batch():
    """Dense: a MoE aux loss is a product of batch means, so its
    microbatch mean is not the full batch's (in ``repro`` too)."""
    _, tcfg = cfg_pair("gemma3_1b")
    batch = tpipeline.TokenPipeline(tpipeline.DataConfig(tcfg.vocab_size, 4, S)
                                    ).torch_batch(0, "cpu")
    out = {}
    for n in (1, 2):
        tt = ttrain.TrainConfig(n_microbatches=n, optimizer=tadamw.OptimizerConfig(lr=1e-3))
        state = ttrain.init_train_state(tcfg, tt, 0, device="cpu")
        state, metrics = ttrain.make_train_step(tcfg, tt)(state, batch)
        out[n] = (metrics, state["opt"]["m"])
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(out[2][0][key], out[1][0][key], rtol=1e-5, atol=0)
    for name, m in out[1][1].items():  # m = 0.1 g after one step
        torch.testing.assert_close(out[2][1][name], m, rtol=1e-4, atol=1e-8)


def test_bf16_accumulation_sums_in_bf16():
    _, tcfg = cfg_pair("gemma3_1b")
    tt = ttrain.TrainConfig(n_microbatches=2, accum_dtype="bfloat16",
                            optimizer=tadamw.OptimizerConfig(lr=1e-3))
    state = ttrain.init_train_state(tcfg, tt, 0, device="cpu")
    batch = tpipeline.TokenPipeline(tpipeline.DataConfig(tcfg.vocab_size, 4, S)
                                    ).torch_batch(0, "cpu")
    model = state["params"]
    names, params = zip(*model.named_parameters())
    want = [torch.zeros(p.shape, dtype=torch.bfloat16) for p in params]
    for mb in ttrain._split_micro(batch, 2):
        for acc, g in zip(want, torch.autograd.grad(tmodel.train_loss(model, mb), params)):
            acc.add_(g.to(torch.bfloat16))
    model.release_step()
    state, _ = ttrain.make_train_step(tcfg, tt)(state, batch)
    for name, g in zip(names, want):  # m = (1 - b1) * clip * g after one step
        m = state["opt"]["m"][name]
        assert torch.equal(m, (1 - 0.9) * ((g / 2).float() * torch.clamp(
            1.0 / (tadamw._global_norm({n: (w / 2).float() for n, w in zip(names, want)})
                   + 1e-9), max=1.0))), name


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_pipeline_batches_bit_equal_to_repro(n_hosts):
    jpipe, tpipe = pipelines(777, batch=6, seq=40)
    for step in (0, 9):
        for host in range(n_hosts):
            want = jpipe.batch_at(step, host, n_hosts)
            got = tpipe.batch_at(step, host, n_hosts)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    tb = tpipe.torch_batch(3, "cpu")
    for key, v in jpipe.batch_at(3).items():
        np.testing.assert_array_equal(tb[key].numpy(), v)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_bf16_moments():
    """gemma3_1b smoke, fp32 compute, bf16 moments: both packages' configs
    and repro's jitted train step (compiled once for the module)."""
    jcfg, tcfg = cfg_pair("gemma3_1b")
    jt, tt = train_configs(moment_dtype="bfloat16")
    return jcfg, tcfg, jt, tt, jax.jit(jtrain.make_train_step(jcfg, jt, RULES))


def test_train_steps_match_repro_dense_bf16_moments(gemma_bf16_moments):
    assert_trajectories_match(*gemma_bf16_moments, 3)


def test_repro_checkpoint_with_bf16_moments_restores_and_continues(tmp_path,
                                                                   gemma_bf16_moments):
    jcfg, tcfg, jt, tt, jstep = gemma_bf16_moments
    jpipe, tpipe = pipelines(jcfg.vocab_size)
    jstate = jtrain.init_train_state(jcfg, jt, jax.random.key(5))
    for s in range(2):
        jstate, _ = jstep(jstate, jpipe.batch_at(s))
    jckpt.save(str(tmp_path), 2, jstate)
    assert latest_verifiable_step(str(tmp_path)) == 2  # bf16 leaves read as 2-byte void
    tree, _ = restore_tree(str(tmp_path), 2)
    tstate = train_state_from_jax(tcfg, tt, tree, device="cpu")
    m = tstate["opt"]["m"]["layers.0.mixer.wq"]
    assert m.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m.float().numpy(), f32(jstate["opt"]["m"]["blocks"][0]["mixer"]["wq"])[0])
    tstep = ttrain.make_train_step(tcfg, tt)
    for s in range(2, 5):
        jstate, jm = jstep(jstate, jpipe.batch_at(s))
        tstate, tm = tstep(tstate, tpipe.torch_batch(s, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TRAJ_RTOL)


def test_port_checkpoint_restores_through_repro(tmp_path, gemma_bf16_moments):
    jcfg, tcfg, jt, tt, jstep = gemma_bf16_moments
    jpipe, tpipe = pipelines(jcfg.vocab_size)
    tstate = ttrain.init_train_state(tcfg, tt, 4, device="cpu")
    tstep = ttrain.make_train_step(tcfg, tt)
    for s in range(2):
        tstate, _ = tstep(tstate, tpipe.torch_batch(s, "cpu"))
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(2, train_state_to_jax(tcfg, tstate))
    ckpt.wait()
    assert ckpt.last_path == os.path.join(str(tmp_path), "step_00000002")
    jstate, _ = jckpt.restore(str(tmp_path), 2, jtrain.abstract_train_state(jcfg, jt))
    assert jstate["opt"]["m"]["embed"]["embed"].dtype == jnp.bfloat16
    want = train_state_to_jax(tcfg, tstate)
    got = dict((jax.tree_util.keystr(p), f32(leaf))
               for p, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in flat}
    for p, leaf in flat:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(p)], leaf.astype(np.float32))
    jstate, jm = jstep(jstate, jpipe.batch_at(2))
    tstate, tm = tstep(tstate, tpipe.torch_batch(2, "cpu"))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TRAJ_RTOL)


def test_port_resume_is_bit_exact(tmp_path, gemma_bf16_moments):
    _, tcfg, _, _, _ = gemma_bf16_moments
    tt = ttrain.TrainConfig(n_microbatches=2, optimizer=tadamw.OptimizerConfig(
        lr=3e-3, warmup_steps=1, total_steps=6, moment_dtype="bfloat16",
        compression="topk"))
    _, tpipe = pipelines(tcfg.vocab_size)
    step = ttrain.make_train_step(tcfg, tt)
    state = ttrain.init_train_state(tcfg, tt, 6, device="cpu")
    ckpt = AsyncCheckpointer(str(tmp_path))
    losses = []
    for s in range(5):
        if s == 2:
            ckpt.save(2, train_state_to_jax(tcfg, state))
        state, m = step(state, tpipe.torch_batch(s, "cpu"))
        losses.append(m["loss"])
    ckpt.wait()
    tree, _ = restore_tree(str(tmp_path), 2)
    state = train_state_from_jax(tcfg, tt, tree, device="cpu")
    assert int(state["step"]) == 2 and set(state["opt"]) == {"m", "v", "err", "step"}
    for s in range(2, 5):
        state, m = step(state, tpipe.torch_batch(s, "cpu"))
        assert torch.equal(m["loss"], losses[s]), s


def test_async_snapshot_survives_the_next_in_place_update(tmp_path):
    w = torch.zeros(1 << 20)
    m = torch.zeros(1 << 20, dtype=torch.bfloat16)
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, {"w": w, "opt": {"m": m}, "blocks": [w[:8]]})
    w.add_(1.0)
    m.add_(1.0)
    ckpt.wait()
    tree, manifest = restore_tree(str(tmp_path), 1)
    assert set(manifest["leaves"]) == {"['w']", "['opt']['m']", "['blocks'][0]"}
    assert manifest["leaves"]["['opt']['m']"][1] == "float32"  # bf16 written exactly
    assert not tree["w"].any() and not tree["opt"]["m"].any() and not tree["blocks"][0].any()


def test_partial_tmp_step_is_ignored_and_the_launcher_resumes(tmp_path, capsys):
    ckpt = str(tmp_path)
    argv = ["--device", "cpu", "--arch", "gemma3_1b", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt", ckpt, "--ckpt-every", "2"]
    tlaunch.main(argv)
    first = capsys.readouterr().out
    assert "[init]" in first and "step     3" in first
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    shutil.copytree(os.path.join(ckpt, "step_00000002"), os.path.join(ckpt, "step_00000005.tmp"))
    assert latest_verifiable_step(ckpt) == 2
    tlaunch.main(argv)
    second = capsys.readouterr().out
    assert f"[resume] restored step 2 from {ckpt}" in second
    line = [ln for ln in first.splitlines() if ln.startswith("step     3")][0]
    again = [ln for ln in second.splitlines() if ln.startswith("step     3")][0]
    assert again.split()[:4] == line.split()[:4]  # step 3's loss, to 4 decimals
