"""``repro``'s dry-run planning for every cell, recorded without compiling.

Run as ``python tests/_jax_dryrun_plan.py OUT.json``.  Importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices before jax
starts, so this runs in its own process (:func:`reference`), never in a
pytest worker: one that imported it would see 512 devices in every later
test.

For each arch x shape x mesh (``repro``'s production meshes, (16, 16) and
(2, 16, 16)) it records ``rules_for``'s fields, ``needs_seq_shard``,
``microbatches_for`` and ``saved_stack_bytes`` as ``lower_cell`` calls them
for a train cell, ``saved_stack_bytes`` of one microbatch for every cell,
and the shapes and dtypes of ``input_specs`` (decode caches by key path).
"""

import json
import os
import sys

SUBPROCESS_TIMEOUT_S = 240


def _fields(rules) -> dict:
    import dataclasses

    out = {}
    for f in dataclasses.fields(rules):
        if f.name != "mesh":
            v = getattr(rules, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def main(out_path: str) -> None:
    import jax

    from repro import configs
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh

    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    rec = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape, (seq, batch, kind) in configs.SHAPES.items():
            specs = dryrun.input_specs(cfg, shape)
            flat = jax.tree_util.tree_flatten_with_path(specs)[0]
            inputs = {jax.tree_util.keystr(p): [list(l.shape), str(l.dtype)] for p, l in flat}
            for mesh_name, mesh in meshes.items():
                rules = dryrun.rules_for(cfg, shape, mesh)
                shards = 32 if mesh_name == "multi" else 16
                seq_sharded = rules.seq is not None
                entry = {"rules": _fields(rules),
                         "needs_seq_shard": dryrun.needs_seq_shard(cfg, seq, batch),
                         "saved_one": dryrun.saved_stack_bytes(
                             cfg, seq, batch, 1, batch_shards=shards,
                             seq_sharded=seq_sharded),
                         "inputs": inputs}
                if kind == "train":
                    n = dryrun.microbatches_for(cfg, seq, batch, seq_sharded=seq_sharded,
                                                batch_shards=shards)
                    entry["microbatches"] = n
                    entry["saved"] = dryrun.saved_stack_bytes(
                        cfg, seq, batch, n, batch_shards=shards, seq_sharded=seq_sharded)
                rec[f"{arch}|{shape}|{mesh_name}"] = entry
    with open(out_path, "w") as f:
        json.dump(rec, f)


def reference(tmp_path_factory) -> dict:
    """This pytest run's record (the script runs once per run; xdist
    workers share it through a lock file in the run's base temp dir)."""
    import fcntl
    import subprocess

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = os.path.join(str(root), "jax_dryrun_plan.json")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            env = dict(os.environ)
            src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "src")
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            r = subprocess.run([sys.executable, os.path.abspath(__file__), out + ".tmp"],
                               capture_output=True, text=True,
                               timeout=SUBPROCESS_TIMEOUT_S, env=env)
            if r.returncode != 0:
                raise RuntimeError(f"{__file__} failed:\n{r.stderr[-4000:]}")
            os.replace(out + ".tmp", out)
    with open(out) as f:
        return json.load(f)


if __name__ == "__main__":
    main(sys.argv[1])
