"""Index bundles in the JAX package's checkpoint layout, with numpy alone.

A bundle is ``<dir>/step_%08d/`` holding ``host0.npz`` (one array per
leaf, keyed ``"['<name>']"`` as jax's ``keystr`` writes dict leaves) and
``manifest.json`` (format 5: shape, dtype, SHA-256 digest and byte size
per leaf, plus the caller's ``extra``).  :func:`save` writes into
``step_%08d.tmp/``, fsyncs the payload and the manifest, renames, then
fsyncs the parent directory, as ``repro.checkpoint.checkpoint.save`` does,
so bundles written by either package load in the other.

Crash-consistency points sit where ``repro.checkpoint.checkpoint`` has
them (:func:`repro_torch.testing.faults.fault_point`), and reads are
corruption-aware: :func:`restore` raises :class:`CorruptBundleError` for
any unreadable payload and first moves the step aside as
``step_%08d.quarantine/``, so resolution falls back to an older step.
Only flat dicts of arrays are saved, and their leaf keys are jax's
``keystr`` of a dict, so a state bundle of either package restores in the
other.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import zipfile
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.testing.faults import fault_point

__all__ = [
    "MANIFEST_VERSION",
    "CorruptBundleError",
    "atomic_write_json",
    "latest_step",
    "latest_verifiable_step",
    "leaf_key",
    "prune_steps",
    "quarantine_step",
    "read_manifest",
    "restore",
    "save",
    "steps_present",
    "verify_step",
]

MANIFEST_VERSION = 5

_STEP_RE = re.compile(r"^step_(\d{8})$")


# What reading a damaged ``.npz`` can raise: a bad CRC or local header
# (BadZipFile), a garbled ``.npy`` header (ValueError), a short file.
_READ_ERRORS = (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile)


class CorruptBundleError(IOError):
    """A bundle failed verification (unreadable, missing leaf, digest mismatch).

    ``quarantined`` is where the bundle was moved aside, when a load path
    moved it.
    """

    def __init__(self, ckpt_dir: str, step: int, problems: List[str],
                 quarantined: Optional[str] = None):
        detail = "; ".join(problems[:4]) + ("..." if len(problems) > 4 else "")
        super().__init__(
            f"corrupt checkpoint bundle {ckpt_dir}/step_{step:08d}: {detail}"
        )
        self.ckpt_dir = ckpt_dir
        self.step = step
        self.problems = problems
        self.quarantined = quarantined


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
    fault_point("ckpt.npz.post_write", path=npz_path)
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
    fault_point("ckpt.manifest.pre_rename", path=manifest_path)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fault_point("ckpt.manifest.post_rename", path=ckpt_dir)
    _fsync_dir(ckpt_dir)
    return final


def atomic_write_json(path: str, obj: Any) -> str:
    """Write JSON via tmp + fsync + rename + parent-dir fsync: the commit
    point of a save that spans several bundles (a mutable index).  A crash
    before the rename leaves the previous file, and what it references,
    intact.
    """
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    fault_point("ckpt.json.pre_rename", path=tmp)
    os.replace(tmp, path)
    fault_point("ckpt.json.post_rename", path=path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path


def read_manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, names: Iterable[str]
            ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read the named leaves of one step, verifying each against its digest.

    Returns ``(arrays, manifest)``.  An unreadable manifest or payload, a
    missing or unreadable leaf, or a digest mismatch moves the step aside
    (:func:`quarantine_step`) and raises :class:`CorruptBundleError`
    (manifests before format 5 carry no digests and load unverified).
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        manifest = read_manifest(ckpt_dir, step)
        data = np.load(os.path.join(d, "host0.npz"))
    except _READ_ERRORS as e:
        raise CorruptBundleError(ckpt_dir, step, [f"bundle unreadable: {e}"],
                                 quarantine_step(ckpt_dir, step)) from e
    digests = manifest.get("digests", {})
    out: Dict[str, np.ndarray] = {}
    problem = None
    try:
        for name in names:
            key = leaf_key(name)
            try:
                arr = data[key]
            except _READ_ERRORS as e:
                problem = f"{key}: missing/unreadable ({e!r})"
                break
            if key in digests:
                want_hex, want_n = digests[key]
                got_hex, got_n = _digest(arr)
                if got_n != want_n or got_hex != want_hex:
                    problem = (f"{key}: digest mismatch "
                               f"({got_hex[:12]} != {want_hex[:12]})")
                    break
            out[name] = arr
    finally:
        data.close()
    if problem is not None:
        raise CorruptBundleError(ckpt_dir, step, [problem],
                                 quarantine_step(ckpt_dir, step))
    return out, manifest


def verify_step(ckpt_dir: str, step: int) -> List[str]:
    """Scrub one bundle; returns problem strings (empty = verified).

    The manifest must parse, every manifest leaf must be in the payload
    with the declared shape and dtype, and (format 5) match its SHA-256
    and byte size.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        manifest = read_manifest(ckpt_dir, step)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    digests = manifest.get("digests", {})
    try:
        data = np.load(os.path.join(d, "host0.npz"))
    except _READ_ERRORS as e:
        return [f"payload unreadable: {e}"]
    problems: List[str] = []
    try:
        for key, (shape, dtype) in manifest.get("leaves", {}).items():
            try:
                arr = data[key]
            except _READ_ERRORS as e:
                problems.append(f"{key}: missing/unreadable ({e!r})")
                continue
            if list(arr.shape) != list(shape) or str(arr.dtype) != dtype:
                problems.append(f"{key}: shape/dtype {arr.shape}/{arr.dtype} != "
                                f"manifest {tuple(shape)}/{dtype}")
                continue
            if key in digests and list(_digest(arr)) != list(digests[key]):
                problems.append(f"{key}: digest mismatch")
    finally:
        data.close()
    return problems


def quarantine_step(ckpt_dir: str, step: int) -> Optional[str]:
    """Move a corrupt bundle aside as ``step_%08d.quarantine`` (kept as
    evidence, invisible to step resolution).  Returns the new path."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(src):
        return None
    dst = src + ".quarantine"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.quarantine.{n}"
    os.rename(src, dst)
    _fsync_dir(ckpt_dir)
    return dst


def steps_present(ckpt_dir: str) -> List[int]:
    """Every fully written step, newest first (``.tmp`` partials and
    quarantined steps excluded)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        (int(m.group(1))
         for m in map(_STEP_RE.match, os.listdir(ckpt_dir))
         if m is not None
         and os.path.exists(os.path.join(ckpt_dir, m.group(0), "manifest.json"))),
        reverse=True,
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest fully written step (``.tmp`` partials are ignored)."""
    steps = steps_present(ckpt_dir)
    return steps[0] if steps else None


def latest_verifiable_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose bundle verifies; corrupt steps on the way are
    quarantined."""
    for step in steps_present(ckpt_dir):
        if not verify_step(ckpt_dir, step):
            return step
        quarantine_step(ckpt_dir, step)
    return None


def prune_steps(ckpt_dir: str, keep) -> None:
    """Remove ``step_*`` bundles whose step number is not in ``keep``."""
    keep = {k for k in keep if k is not None}
    for step in steps_present(ckpt_dir):
        if step not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:08d}"), ignore_errors=True)
