"""The port's expert-parallel MoE (``moe_forward_ep``) on four gloo ranks.

Run as a script (``python tests/test_torch_moe_ep.py OUT_DIR``) this file
is the rank program: it spawns 4 CPU processes on a gloo process group
and, for the granite_moe_1b and mixtral_8x22b smoke configs in fp32, on
the meshes (data 1, model 4), (2, 2) and (2, 2) with ``fsdp="data"``,
runs ``moe_forward`` under rules with the mesh (which dispatches to
``moe_forward_ep``) on the weights and input of ``tests/_jax_moe_ep_4dev.py``,
distributed by ``launch/shardings.py``, and records the output, the aux
loss and the gradients of ``1e-3 * sum(out ** 2) + aux``; then a smoke MoE
decoder's forward logits and ``train_loss`` with its gradients at (2, 2).
The tests run it once (module fixture) beside ``repro``'s 4-device run and
hold, within rtol 1e-5 / atol 1e-6:

* the output against the port's non-EP ``moe_forward`` and against
  ``repro``'s EP output;
* the aux against the non-EP aux (the means taken over the whole batch),
  where ``repro``'s EP aux is more than 1e-3 off at (2, 2);
* the gradients of x, router, w1, w2 and w3 against the non-EP ones, where
  ``repro``'s router gradient is off by more than 1e-2 of its largest
  entry at (2, 2);
* the decoder's logits, loss and gradients against the non-EP run.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_moe_ep_4dev import ARCHS, MESHES, B, S, case_name, inputs, reference, weights  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
RANKS = 4
DECODER_MESH = (2, 2)
DECODER_SEED = 3
RANKS_TIMEOUT_S = 240
CASES = [(a, case_name(*m)) for a in ARCHS for m in MESHES]


def port_cfg(arch):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch, smoke=True), compute_dtype="float32")


def loaded_moe(cfg, w):
    from repro_torch.models import moe

    p = moe.MoE(cfg, device="cpu")
    p.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in w.items()})
    return p.requires_grad_(True)


def moe_loss_and_grads(cfg, p, x, rules=None):
    """(out, aux, {"x": dx, name: dw}) of 1e-3 * sum(out^2) + aux."""
    from repro_torch.models import moe

    kw = {} if rules is None else {"rules": rules}
    out, aux = moe.moe_forward(cfg, p, x, **kw)
    names, params = zip(*p.named_parameters())
    grads = torch.autograd.grad(1e-3 * (out ** 2).sum() + aux, (x,) + params)
    return out, aux, dict(zip(("x",) + names, grads))


def decoder_batch(cfg):
    rng = np.random.default_rng(DECODER_SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1)),
            "mask": torch.ones((B, S), dtype=torch.float32)}


def decoder_run(cfg, rules=None):
    """(logits, loss, grads by name) of the smoke decoder from DECODER_SEED."""
    from repro_torch.launch import shardings
    from repro_torch.models import model

    m = model.init_params(cfg, DECODER_SEED, device="cpu").requires_grad_(True)
    batch = decoder_batch(cfg)
    kw = {}
    if rules is not None:
        shardings.distribute(m, rules)
        batch = shardings.distribute_batch(batch, rules)
        kw = {"rules": rules}
    logits = m(batch["tokens"], **kw)
    loss = model.train_loss(m, batch, **kw)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, params)
    m.release_step()
    return logits, loss, dict(zip(names, grads))


# ---------------------------------------------------------------------------
# The rank program
# ---------------------------------------------------------------------------


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings
    from repro_torch.launch.multihost import bootstrap
    from repro_torch.sharding import make_rules

    torch.set_num_threads(1)
    bootstrap(coordinator=f"localhost:{port}", host_id=0, n_hosts=1, local_rank=rank,
              gpus_per_host=RANKS, backend="gloo")
    assert dist.get_world_size() == RANKS
    out = {}
    for arch in ARCHS:
        cfg = port_cfg(arch)
        w, x = weights(cfg), inputs(cfg)
        for data, model_axis, fsdp in MESHES:
            mesh = init_device_mesh("cpu", (data, model_axis), mesh_dim_names=("data", "model"))
            rules = make_rules(mesh, fsdp=fsdp)
            p = shardings.distribute(loaded_moe(cfg, w), rules, "layers.0.ffn.")
            xd = shardings.distribute_batch({"x": torch.from_numpy(x.copy())}, rules)["x"]
            o, aux, grads = moe_loss_and_grads(cfg, p, xd.requires_grad_(True), rules)
            name = case_name(data, model_axis, fsdp)
            out[f"{arch}/{name}/out"] = _full(o)
            out[f"{arch}/{name}/aux"] = _full(aux)
            out.update({f"{arch}/{name}/g_{k}": _full(g) for k, g in grads.items()})
        mesh = init_device_mesh("cpu", DECODER_MESH, mesh_dim_names=("data", "model"))
        with implicit_replication():
            logits, loss, grads = decoder_run(cfg, make_rules(mesh))
        out[f"{arch}/decoder/logits"] = _full(logits)
        out[f"{arch}/decoder/loss"] = _full(loss)
        out.update({f"{arch}/decoder/g/{k}": _full(g) for k, g in grads.items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, "ranks.npz"), **out)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(_free_port(), out_dir), nprocs=RANKS)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Small models on cores the suite's workers share: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's 4-device record, the 4 gloo ranks' record): the ranks run in
    a subprocess while ``repro``'s script runs in another."""
    out = str(tmp_path_factory.mktemp("torch_moe_ep_ranks"))
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ranks = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = reference(tmp_path_factory)
        _, err = ranks.communicate(timeout=RANKS_TIMEOUT_S)
    finally:
        ranks.kill()
    if ranks.returncode != 0:
        raise RuntimeError(f"the gloo ranks failed:\n{err[-4000:]}")
    with np.load(os.path.join(out, "ranks.npz")) as z:
        return ref, dict(z)


@pytest.fixture(scope="module")
def plain():
    """The port's non-EP MoE on the reference weights, per arch."""
    res = {}
    for arch in ARCHS:
        cfg = port_cfg(arch)
        x = torch.from_numpy(inputs(cfg)).requires_grad_(True)
        out, aux, grads = moe_loss_and_grads(cfg, loaded_moe(cfg, weights(cfg)), x)
        res[arch] = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
                     **{f"g_{k}": g.numpy() for k, g in grads.items()}}
    return res


def test_port_non_ep_matches_repro_without_a_mesh(runs, plain):
    ref, _ = runs
    for arch in ARCHS:
        for key in ("out", "aux", "g_x", "g_router", "g_w1", "g_w2", "g_w3"):
            np.testing.assert_allclose(plain[arch][key], ref[f"{arch}/plain/{key}"],
                                       rtol=RTOL, atol=ATOL, err_msg=f"{arch} {key}")


@pytest.mark.parametrize("arch,case", CASES)
def test_ep_output_matches_non_ep_and_repro_ep(runs, plain, arch, case):
    ref, got = runs
    out = got[f"{arch}/{case}/out"]
    np.testing.assert_allclose(out, plain[arch]["out"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, ref[f"{arch}/{case}/out"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,case", CASES)
def test_ep_aux_is_the_whole_batch_aux(runs, plain, arch, case):
    ref, got = runs
    np.testing.assert_allclose(got[f"{arch}/{case}/aux"], plain[arch]["aux"],
                               rtol=RTOL, atol=ATOL)
    if case.startswith("d2"):  # repro's EP aux: one data shard's value
        assert abs(ref[f"{arch}/{case}/aux"] - ref[f"{arch}/plain/aux"]) > 1e-3


@pytest.mark.parametrize("arch,case", CASES)
def test_ep_gradients_match_non_ep(runs, plain, arch, case):
    ref, got = runs
    for name in ("x", "router", "w1", "w2", "w3"):
        np.testing.assert_allclose(got[f"{arch}/{case}/g_{name}"], plain[arch][f"g_{name}"],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if case.startswith("d2"):  # repro's router gradient follows its aux
        want = ref[f"{arch}/plain/g_router"]
        gap = np.abs(ref[f"{arch}/{case}/g_router"] - want).max()
        assert gap > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decoder_forward_and_train_loss_through_ep(runs, arch):
    _, got = runs
    logits, loss, grads = decoder_run(port_cfg(arch))
    key = f"{arch}/decoder"
    np.testing.assert_allclose(got[f"{key}/logits"], logits.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[f"{key}/loss"], loss.detach().numpy(), rtol=RTOL)
    assert {k[len(key) + 3:] for k in got if k.startswith(f"{key}/g/")} == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(got[f"{key}/g/{name}"], g.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


if __name__ == "__main__":
    main(sys.argv[1])
