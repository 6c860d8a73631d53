"""Tree <-> disk, in ``repro.checkpoint.serialization``'s format: a flat
``<path>.npz`` payload with one entry ``a{i}`` a leaf, over the leaves'
sorted "/"-joined key paths (``params/layers/attn/wq``,
``opt/mu/...``), and a ``<path>.json`` manifest holding those ``keys``
and the caller's ``extra``.

numpy has no bfloat16 of its own, so a bfloat16 leaf is stored as its
uint16 bit pattern, and the manifest's extra ``dtypes`` list names every
leaf's torch dtype.  The reference's reader looks only at ``keys`` and
``extra``, so a float32 tree written here restores there, and one
written there (no ``dtypes``: each leaf's numpy dtype) restores here.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import paths, unflatten


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """-> (payload array, torch dtype name) of a tensor leaf."""
    x = x.detach().cpu()
    name = str(x.dtype).removeprefix("torch.")
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), name
    return x.numpy(), name


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_pytree(tree, path: str, extra_meta: Dict | None = None) -> None:
    flat = paths(tree)
    arrays = {}
    meta: Dict[str, Any] = {"keys": [], "extra": extra_meta or {},
                            "dtypes": []}
    for i, k in enumerate(sorted(flat)):
        arrays[f"a{i}"], name = _to_numpy(flat[k])
        meta["keys"].append(k)
        meta["dtypes"].append(name)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_pytree(template, path: str, place=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (shapes must match);
    each leaf takes its template leaf's dtype and device.  ``place(key,
    tensor)``, where given, maps each stored (whole) leaf to the part
    the template holds before the check."""
    with open(path + ".json") as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes")
    tmpl = paths(template)
    missing = set(tmpl) - set(meta["keys"])
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    index = {k: i for i, k in enumerate(meta["keys"])}
    out = []
    with np.load(path + ".npz") as payload:
        for key, leaf in tmpl.items():
            i = index[key]
            a = payload[f"a{i}"]
            t = _from_numpy(a, dtypes[i] if dtypes else a.dtype.name)
            if place is not None:
                t = place(key, t)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: ckpt {tuple(t.shape)} != "
                                 f"template {tuple(leaf.shape)}")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(template, out), meta["extra"]
