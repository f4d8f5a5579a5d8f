"""Index bundles in the JAX package's checkpoint layout, with numpy alone.

A bundle is ``<dir>/step_%08d/`` holding ``host0.npz`` (one array per
leaf, keyed ``"['<name>']"`` as jax's ``keystr`` writes dict leaves) and
``manifest.json`` (format 5: shape, dtype, SHA-256 digest and byte size
per leaf, plus the caller's ``extra``).  :func:`save` writes into
``step_%08d.tmp/``, fsyncs the payload and the manifest, renames, then
fsyncs the parent directory, as ``repro.checkpoint.checkpoint.save`` does,
so bundles written by either package load in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "MANIFEST_VERSION",
    "CorruptBundleError",
    "leaf_key",
    "save",
    "restore",
    "read_manifest",
    "latest_step",
    "prune_steps",
]

MANIFEST_VERSION = 5

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CorruptBundleError(IOError):
    """A bundle failed verification (unreadable, missing leaf, digest mismatch)."""

    def __init__(self, ckpt_dir: str, step: int, problems: List[str]):
        super().__init__(
            f"corrupt checkpoint bundle {ckpt_dir}/step_{step:08d}: "
            + "; ".join(problems[:4])
        )
        self.problems = problems


def leaf_key(name: str) -> str:
    """npz/manifest key of a top-level dict leaf (jax ``keystr`` form)."""
    return f"['{name}']"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _digest(arr: np.ndarray) -> Tuple[str, int]:
    buf = np.ascontiguousarray(arr).tobytes()
    return hashlib.sha256(buf).hexdigest(), len(buf)


def save(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
         extra: Optional[Dict] = None) -> str:
    """Atomic synchronous save of named numpy arrays. Returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {leaf_key(k): np.asarray(arrays[k]) for k in sorted(arrays)}
    npz_path = os.path.join(tmp, "host0.npz")
    np.savez(npz_path, **flat)
    with open(npz_path, "rb") as f:
        os.fsync(f.fileno())
    manifest = {
        "format_version": MANIFEST_VERSION,
        "step": step,
        "n_hosts": 1,
        "leaves": {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()},
        "digests": {k: list(_digest(v)) for k, v in flat.items()},
        "extra": extra or {},
    }
    manifest_path = os.path.join(tmp, "manifest.json")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    return final


def read_manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, names: Iterable[str]
            ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read the named leaves of one step, verifying each against its digest.

    Returns ``(arrays, manifest)``; raises :class:`CorruptBundleError` on an
    unreadable payload, a missing leaf or a digest mismatch (manifests
    before format 5 carry no digests and load unverified).
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        manifest = read_manifest(ckpt_dir, step)
        data = np.load(os.path.join(d, "host0.npz"))
    except (OSError, ValueError, EOFError) as e:
        raise CorruptBundleError(ckpt_dir, step, [f"bundle unreadable: {e}"]) from e
    digests = manifest.get("digests", {})
    out: Dict[str, np.ndarray] = {}
    try:
        for name in names:
            key = leaf_key(name)
            try:
                arr = data[key]
            except KeyError as e:
                raise CorruptBundleError(ckpt_dir, step, [f"{key}: missing"]) from e
            if key in digests:
                want_hex, want_n = digests[key]
                got_hex, got_n = _digest(arr)
                if got_n != want_n or got_hex != want_hex:
                    raise CorruptBundleError(ckpt_dir, step, [
                        f"{key}: digest mismatch ({got_hex[:12]} != {want_hex[:12]})"
                    ])
            out[name] = arr
    finally:
        data.close()
    return out, manifest


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1))
        for m in map(_STEP_RE.match, os.listdir(ckpt_dir))
        if m is not None
        and os.path.exists(os.path.join(ckpt_dir, m.group(0), "manifest.json"))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest fully written step (``.tmp`` partials are ignored)."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def prune_steps(ckpt_dir: str, keep) -> None:
    """Remove ``step_*`` bundles whose step number is not in ``keep``."""
    keep = {k for k in keep if k is not None}
    for step in _steps(ckpt_dir):
        if step not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:08d}"), ignore_errors=True)
