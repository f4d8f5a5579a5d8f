"""Out-of-process LSM compaction: the shadow compacts in a child process.

Port of ``repro.serve.compactor``, with the same bundle handoff, result
marker and fault points::

    parent (serving process)                 child (python -m repro_torch.serve.compactor)
    ------------------------                 -------------------------------------------
    snapshot() the serving index
    save(workdir/in)           ── spawn ──►  load(workdir/in) on DEVICE
    keep serving + logging writes            compact()
                                             save(workdir/out)
                                             atomically commit result marker
    load(workdir/out)          ◄── exit ──
    verify marker vs loaded state
    replay write log, swap epoch  (the engine's existing protocol)

``repro`` configures the child's JAX devices through its environment.
The port passes the index's device to the child instead
(``--device cuda``): the child of a CUDA index loads and compacts on the
card — a second CUDA context on the same GPU — or fails, and the cycle
fails with :class:`CompactionChildError`.  It never compacts on the CPU
in its place.  The child reports its peak device memory in the marker.

Safety properties:

* the parent NEVER trusts ``workdir/out`` unless the child exited 0 AND
  the result marker — written atomically, after the bundle — is present
  and matches the reloaded index;
* a failed/killed/hung child fails ONLY that maintenance cycle: the
  serving index received every write first and stays authoritative;
* the snapshot is saved WITHOUT a WAL, so nothing is double-logged
  across the process boundary.

Fault-point arming crosses the process boundary as in ``repro``:
``REPRO_COMPACTOR_FAULTS`` / ``REPRO_COMPACTOR_FAULT_TRACE`` in the
parent's environment become the child's ``REPRO_FAULTS`` /
``REPRO_FAULT_TRACE``, and the parent's own are stripped from the child.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "CompactionChildError",
    "compact_in_child",
    "child_main",
]

_RESULT_MARKER = "compact_result.json"
_MUTABLE_MANIFEST = "mutable_manifest.json"
_SHARDED_MANIFEST = "sharded_mutable_manifest.json"


class CompactionChildError(RuntimeError):
    """The compaction child failed/died/produced an unverifiable bundle.

    Raised in the PARENT; the maintenance cycle fails, the shadow is
    abandoned, and the serving index (which received every write first)
    stays authoritative.  The engine's maintainer backs off and retries.
    """


def _detect_layout(path: str) -> str:
    if os.path.exists(os.path.join(path, _SHARDED_MANIFEST)):
        raise NotImplementedError(
            "out-of-process compaction of a sharded-mutable index waits for "
            "the port of the sharded layouts (ROADMAP module 12)"
        )
    if os.path.exists(os.path.join(path, _MUTABLE_MANIFEST)):
        return "mutable"
    raise FileNotFoundError(f"no mutable-index manifest under {path!r}")


def _summary(index) -> Dict[str, int]:
    """The identity a compaction must preserve: the live set and the id
    cursor (three-way agreement before a swap is allowed)."""
    stats = index.maintenance_stats()
    return {
        "n_live": int(stats["n_live"]),
        "n_deleted": int(stats["n_deleted"]),
        "next_id": int(index._lsm.next_id),
    }


def _load(path: str, device):
    _detect_layout(path)
    from repro_torch.index.mutable import MutableHilbertIndex

    return MutableHilbertIndex.load(path, device=device)


# -- child entry point -------------------------------------------------------


def child_main(argv=None) -> int:
    """``python -m repro_torch.serve.compactor IN_DIR OUT_DIR --device DEV``:
    load on DEV, compact, save, then atomically commit the result marker
    (the commit point the parent keys on)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.compactor")
    ap.add_argument("in_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--device", required=True,
                    help="device of the serving index (cpu, cuda, cuda:N)")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.checkpoint.bundle import atomic_write_json
    from repro_torch.testing.faults import fault_point

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            # the serving index lives on a GPU: compacting it anywhere
            # else would hand back a CPU index under a CUDA engine
            print(f"compactor child: device {device} requested but no GPU "
                  "is available", file=sys.stderr)
            return 3
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    index = _load(args.in_dir, device)
    fault_point("compactor.child.loaded", path=args.in_dir)
    pre = _summary(index)
    load_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    index.compact()
    fault_point("compactor.child.compacted", path=args.out_dir)
    compact_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    index.save(args.out_dir)
    # marker LAST: its atomic rename is the child's commit point.
    fault_point("compactor.child.pre_marker", path=args.out_dir)
    atomic_write_json(os.path.join(args.out_dir, _RESULT_MARKER), {
        "layout": "mutable",
        "summary": _summary(index),
        "pre_compact_summary": pre,
        "n_segments": int(index.n_segments),
        "pid": os.getpid(),
        "device": str(device),
        "peak_device_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if device.type == "cuda" else 0),
        "phases_s": {
            "load": load_s,
            "compact": compact_s,
            "save": time.perf_counter() - t2,
        },
    })
    fault_point("compactor.child.post_marker", path=args.out_dir)
    return 0


# -- parent side -------------------------------------------------------------


def _child_env() -> Dict[str, str]:
    env = dict(os.environ)
    # the parent's own armed faults must not replicate into the child;
    # REPRO_COMPACTOR_* is the dedicated cross-process arming channel
    env.pop("REPRO_FAULTS", None)
    env.pop("REPRO_FAULT_TRACE", None)
    if "REPRO_COMPACTOR_FAULTS" in env:
        env["REPRO_FAULTS"] = env.pop("REPRO_COMPACTOR_FAULTS")
    if "REPRO_COMPACTOR_FAULT_TRACE" in env:
        env["REPRO_FAULT_TRACE"] = env.pop("REPRO_COMPACTOR_FAULT_TRACE")
    # make `repro_torch` importable in the child regardless of install mode
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    env["PYTHONPATH"] = (
        src_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else src_root
    )
    return env


def compact_in_child(
    index,
    workdir: str,
    *,
    timeout: Optional[float] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Save ``index`` (the engine's shadow), compact it in a child process
    on the index's device, and return ``(compacted_index, phases)``.

    Raises :class:`CompactionChildError` if the child exits nonzero, dies
    on a signal, or the result bundle fails three-way verification
    (marker summary vs reloaded state vs the pre-save live set);
    ``subprocess.TimeoutExpired`` is mapped by the caller's watchdog
    policy.  ``workdir`` is reused across cycles (``in``/``out`` are
    cleared first); callers own its lifetime.
    """
    if hasattr(index, "_owned_rows"):
        raise NotImplementedError(
            "out-of-process compaction of a sharded-mutable index waits for "
            "the port of the sharded layouts (ROADMAP module 12)"
        )
    phases: Dict[str, Any] = {}
    in_dir = os.path.join(workdir, "in")
    out_dir = os.path.join(workdir, "out")
    for d in (in_dir, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)

    expect = _summary(index)
    t0 = time.perf_counter()
    index.save(in_dir)
    phases["save_in_ms"] = 1000.0 * (time.perf_counter() - t0)

    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.compactor", in_dir, out_dir,
         "--device", str(index.device)],
        env=_child_env(), timeout=timeout,
        capture_output=True, text=True,
    )
    phases["child_ms"] = 1000.0 * (time.perf_counter() - t1)
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()[-8:]
        raise CompactionChildError(
            f"compactor child exited {proc.returncode}"
            + (f" (signal {-proc.returncode})" if proc.returncode < 0 else "")
            + (": " + " | ".join(tail) if tail else "")
        )

    marker_path = os.path.join(out_dir, _RESULT_MARKER)
    if not os.path.exists(marker_path):
        raise CompactionChildError(
            "compactor child exited 0 but committed no result marker — "
            "refusing the bundle"
        )
    with open(marker_path) as f:
        marker = json.load(f)

    t2 = time.perf_counter()
    compacted = _load(out_dir, index.device)
    phases["load_out_ms"] = 1000.0 * (time.perf_counter() - t2)
    phases["child_phases_s"] = marker.get("phases_s", {})
    phases["child_peak_device_bytes"] = marker.get("peak_device_bytes", 0)

    got = _summary(compacted)
    if not (got == marker.get("summary") and got == expect):
        raise CompactionChildError(
            "compacted bundle failed verification: "
            f"expected {expect}, marker {marker.get('summary')}, "
            f"loaded {got} — refusing to swap it in"
        )
    return compacted, phases


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(child_main())
