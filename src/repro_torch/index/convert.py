"""Carry an index across from the JAX package: numpy arrays in, port index out.

The JAX index's state reaches numpy through ``np.asarray(leaf)`` (its
``HilbertIndex._array_bundle()``) or through its saved bundle; both use the
leaf names of :data:`LEAF_NAMES`.  Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.core import forest as forest_lib
from repro_torch.core import quantize
from repro_torch.index.config import IndexConfig
from repro_torch.index.facade import (KIND, LEAF_NAMES, DeviceLike, HilbertIndex,
                                      resolve_device)

__all__ = ["LEAF_NAMES", "index_from_arrays", "load_index_bundle"]

_WORDS = ("forest.directories", "codes_master", "sketches_master")


def _tensor(name: str, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if name in _WORDS:
        arr = arr.astype(np.uint32, copy=False).view(np.int32)
    else:
        arr = arr.astype(LEAF_NAMES[name], copy=False)
    if not arr.flags.writeable:  # e.g. np.asarray of a jax array: own a copy
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def index_from_arrays(arrays: Mapping[str, np.ndarray], config_dict: Dict, *,
                      device: DeviceLike = None) -> HilbertIndex:
    """Build the port's index from the JAX index's arrays, as numpy arrays.

    ``arrays`` maps the leaf names of :data:`LEAF_NAMES` to arrays
    (``points`` optional); ``config_dict`` is ``IndexConfig.to_dict()`` of
    either package.  Unpacked ``(n, d)`` uint8 codes (format 1 bundles)
    are nibble-packed on the way in.
    """
    dev = resolve_device(device)
    t = {k: _tensor(k, arrays[k], dev) for k in LEAF_NAMES
         if k != "codes_master" and k in arrays}
    codes = np.asarray(arrays["codes_master"])
    if codes.dtype == np.uint8:  # v1 layout: unpacked codes, repack
        t["codes_master"] = quantize.pack_codes(torch.from_numpy(codes).to(dev))
    else:
        t["codes_master"] = _tensor("codes_master", codes, dev)
    return HilbertIndex(
        config=IndexConfig.from_dict(config_dict),
        forest=forest_lib.HilbertForest(
            perms=t["forest.perms"],
            flips=t["forest.flips"],
            orders=t["forest.orders"],
            directories=t["forest.directories"],
            lo=t["forest.lo"],
            hi=t["forest.hi"],
        ),
        quant=quantize.Quantizer(t["quant.boundaries"], t["quant.centroids"]),
        codes_master=t["codes_master"],
        sketches_master=t["sketches_master"],
        master_order=t["master_order"],
        master_rank=t["master_rank"],
        points=t.get("points"),
    )


def load_index_bundle(path: str, *, kind: str = KIND, device: DeviceLike = None
                      ) -> Tuple[HilbertIndex, Dict[str, np.ndarray], Dict]:
    """Load the newest verifiable step of an index bundle saved by either
    package (``repro.index.facade.load_index_bundle``).

    Returns ``(index, extra_arrays, manifest_extra)``; sidecar arrays keep
    the dtype the manifest records.  A step that fails verification is
    quarantined (``step_%08d.quarantine/``) and the next older one tried;
    when none is left the last :class:`~bundle.CorruptBundleError` is
    raised.  Format 1 bundles (unpacked uint8 codes) are repacked.
    """
    dev = resolve_device(device)
    last_err: Optional[bundle.CorruptBundleError] = None
    while True:
        step = bundle.latest_step(path)
        if step is None:
            if last_err is not None:
                raise last_err
            raise FileNotFoundError(f"no HilbertIndex checkpoint under {path!r}")
        try:
            return _load_index_bundle_step(path, step, kind, dev)
        except bundle.CorruptBundleError as e:  # quarantined; try an older step
            last_err = e


def _load_index_bundle_step(path: str, step: int, kind: str, dev: torch.device):
    try:
        manifest = bundle.read_manifest(path, step)
    except ValueError as e:
        raise bundle.CorruptBundleError(
            path, step, [f"manifest unparseable: {e}"],
            bundle.quarantine_step(path, step)) from e
    extra = manifest.get("extra", {})
    if extra.get("kind") != kind:
        raise ValueError(
            f"{path!r} is not a HilbertIndex checkpoint of kind {kind!r} "
            f"(kind={extra.get('kind')!r})"
        )
    names = [k for k in LEAF_NAMES if k != "points" or extra.get("has_points")]
    extra_names = list(extra.get("extra_arrays", []))
    arrays, _ = bundle.restore(path, step, names + extra_names)
    index = index_from_arrays(arrays, extra["config"], device=dev)
    return index, {k: arrays[k] for k in extra_names}, extra
