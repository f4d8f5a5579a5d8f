"""``repro``'s expert-parallel MoE on 4 virtual CPU devices.

Run as ``python tests/_jax_moe_ep_4dev.py OUT_DIR`` (it sets its own
``XLA_FLAGS``).  The port's EP tests call :func:`reference`, which runs it
once per pytest run in a subprocess, so the pytest processes keep their
one-device view.

For each MoE smoke config (fp32) it draws the layer's weights and an
input x (B 4, S 32) with numpy from ``SEED``, and records ``repro``'s
``moe_forward`` without a mesh and with each mesh of :data:`MESHES`
(``moe_forward_ep`` through ``shard_map``): the output, the aux loss, and
the gradients of ``1e-3 * sum(out ** 2) + aux`` in x and every weight.
``OUT_DIR/ref.npz`` holds ``{arch}/w/{name}``, ``{arch}/x`` and
``{arch}/{case}/{out,aux,g_x,g_<name>}`` with case ``plain`` or
:func:`case_name`.
"""

import os
import shutil
import sys

import numpy as np

ARCHS = ("granite_moe_1b", "mixtral_8x22b")
MESHES = ((1, 4, None), (2, 2, None), (2, 2, "data"))  # (data, model, fsdp)
B, S = 4, 32
SEED = 0
SUBPROCESS_TIMEOUT_S = 240


def case_name(data: int, model: int, fsdp) -> str:
    return f"d{data}m{model}" + ("_fsdp" if fsdp else "")


def weights(cfg, seed: int = SEED) -> dict:
    """``moe_init``'s shapes and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w1": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w2": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if cfg.act in ("silu", "gelu"):
        w["w3"] = rng.standard_normal((e, d, f)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in w.items()}


def inputs(cfg, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def main(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import moe
    from repro.sharding import ShardingRules, make_rules

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                  compute_dtype="float32")
        w, x = weights(cfg), inputs(cfg)
        out.update({f"{arch}/w/{k}": v for k, v in w.items()})
        out[f"{arch}/x"] = x
        cases = [("plain", ShardingRules())]
        for data, model, fsdp in MESHES:
            mesh = jax.make_mesh((data, model), ("data", "model"))
            cases.append((case_name(data, model, fsdp), make_rules(mesh, fsdp=fsdp)))
        for name, rules in cases:
            def loss(x, p, rules=rules):
                o, aux = moe.moe_forward(cfg, p, x, rules)
                return 1e-3 * jnp.sum(o ** 2) + aux, (o, aux)

            (_, (o, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                     {k: jnp.asarray(v) for k, v in w.items()})
            out[f"{arch}/{name}/out"] = np.asarray(o)
            out[f"{arch}/{name}/aux"] = np.asarray(aux)
            out[f"{arch}/{name}/g_x"] = np.asarray(gx)
            out.update({f"{arch}/{name}/g_{k}": np.asarray(v) for k, v in gp.items()})
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


def reference(tmp_path_factory) -> dict:
    """This pytest run's ``ref.npz``, as a dict of arrays.

    The script runs once per pytest run: under xdist every worker shares
    the run's base temp directory, and a lock file serializes the first
    call.  Its own time limit is ``SUBPROCESS_TIMEOUT_S``."""
    import fcntl
    import subprocess

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = os.path.join(str(root), "jax_moe_ep_4dev")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(out, "ref.npz")):
            shutil.rmtree(out, ignore_errors=True)
            os.makedirs(out)
            env = dict(os.environ)
            src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "src")
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            r = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                               capture_output=True, text=True,
                               timeout=SUBPROCESS_TIMEOUT_S, env=env)
            if r.returncode != 0:
                raise RuntimeError(f"{__file__} failed:\n{r.stderr[-4000:]}")
    with np.load(os.path.join(out, "ref.npz")) as z:
        return dict(z)


if __name__ == "__main__":
    main(sys.argv[1])
