"""npz checkpoints in the reference's layout (``train/checkpoint.py``).

Keys are the leaves' tree paths (dict keys and sequence indices joined with
'/'); bf16 is stored as its uint16 bit pattern under the key plus
``__bf16__`` (npz has no bfloat16). Saves are atomic: the npz is written to
a temporary file, synced and renamed, then the json sidecar the same way,
and only a step with both files counts. A checkpoint the reference writes
restores into the port and the other way round.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core.tree import tree_flatten, tree_paths, tree_unflatten
from ..models.convert import to_tensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_BF16_TAG = "__bf16__"


def _atomic_write(final: str, write_fn) -> None:
    """Write-temp + fsync + rename: the final path either does not exist or
    holds a complete file."""
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def save_checkpoint(path: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Save ``tree`` as ``ckpt_<step>.npz`` with its json commit marker,
    which holds the step and the fields of ``extra``."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for key, leaf in zip(tree_paths(tree), tree_flatten(tree)[0]):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[key] = t.numpy()
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    _atomic_write(fname, lambda f: np.savez(f, **arrays))
    meta = json.dumps({"step": step, **(extra or {})}).encode()
    _atomic_write(os.path.join(path, f"ckpt_{step:08d}.json"), lambda f: f.write(meta))
    return fname


def latest_step(path: str) -> Optional[int]:
    """Latest complete checkpoint step (an npz without its json is a torn
    save and is skipped), or None."""
    if not os.path.isdir(path):
        return None
    files = set(os.listdir(path))
    steps = [
        int(f[len("ckpt_"): -len(".npz")])
        for f in files
        if f.startswith("ckpt_") and f.endswith(".npz")
        and f[: -len(".npz")] + ".json" in files
    ]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, like: Any, *, device=None) -> Any:
    """The checkpoint's tree, structured as ``like`` (a tree of tensors);
    each leaf lands on the device of ``like``'s leaf (a meta leaf, one that
    gives only its shape and dtype, on ``device``) and must match its shape
    and dtype."""
    data = np.load(os.path.join(path, f"ckpt_{step:08d}.npz"))
    leaves, treedef = tree_flatten(like)
    out = []
    for key, ref in zip(tree_paths(like), leaves):
        dev = device if ref.device.type == "meta" else ref.device
        if key + _BF16_TAG in data:
            arr = data[key + _BF16_TAG].view(np.int16)
            t = torch.from_numpy(arr.copy()).view(torch.bfloat16).to(dev)
        else:
            t = to_tensor(data[key], dev)
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"checkpoint leaf {key!r} is {tuple(t.shape)} {t.dtype}; "
                             f"expected {tuple(ref.shape)} {ref.dtype}")
        out.append(t)
    return tree_unflatten(treedef, out)
