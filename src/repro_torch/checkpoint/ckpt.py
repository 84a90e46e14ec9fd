"""Flat-npz tree checkpointing (``repro.checkpoint.ckpt``).

Leaves are stored under their '/'-joined key paths
(``utils.tree.path_leaves``); restore rebuilds into a caller-provided
target structure, which imposes dtypes and devices.  The layout is the
reference's, so each package reads the other's files.

bfloat16 has no numpy dtype: the reference's ``np.savez`` writes a
bfloat16 leaf as its raw 16 bits under the void dtype ``|V2``, and this
module does the same.  A ``|V2`` leaf loads into a bfloat16 target as
those bits, bit for bit (the reference cannot read its own such leaves
back; the port resumes bf16 runs from either package's files).

Crash safety: ``save_checkpoint`` writes to a ``.tmp.npz`` sidecar and
``os.replace``s it into place, so ``latest_step`` (which matches only the
final ``ckpt_<step>.npz`` names) never sees a torn checkpoint.  A crash
between the write and the rename strands the sidecar; the next
``save_checkpoint`` in the directory sweeps stale ``.tmp.npz`` files
before writing its own.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.utils.tree import map_with_path, path_leaves

_RAW_BF16 = np.dtype("V2")       # how np.savez stores a bfloat16 leaf


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW_BF16)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":              # ml_dtypes, as JAX hands it
        return a.view(_RAW_BF16)
    return a


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    # sweep sidecars stranded by a crash mid-save (never matched by
    # latest_step, but they would otherwise accumulate)
    for f in os.listdir(directory):
        if f.endswith(".tmp.npz"):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass                      # a concurrent saver won the race
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless already present
    np.savez(tmp, **{p: _to_numpy(v) for p, v in path_leaves(tree)})
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _restore_leaf(key: str, arr: np.ndarray, tgt, cast: bool):
    raw_bf16 = arr.dtype == _RAW_BF16
    have = "bfloat16 (raw |V2)" if raw_bf16 else str(arr.dtype)
    if raw_bf16:
        bits = torch.from_numpy(arr.view(np.int16).copy())
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(tgt, torch.Tensor):
        want, same = tgt.dtype, t.dtype == tgt.dtype
    else:
        want = np.dtype(tgt.dtype)
        same = not raw_bf16 and arr.dtype == want
    if not same and not cast:
        raise ValueError(f"{key}: checkpoint dtype {have} != target {want}; "
                         f"pass cast=True to convert explicitly")
    if isinstance(tgt, torch.Tensor):
        return t.to(device=tgt.device, dtype=tgt.dtype)
    if raw_bf16:
        arr = t.float().numpy()
    return arr.astype(want)


def load_checkpoint(directory: str, step: int, target, *, cast: bool = False):
    """Restore into the structure of ``target`` (shapes must match).

    A tensor leaf of the target comes back as a tensor on its device, any
    other leaf (numpy arrays and scalars) as a numpy array.  Dtypes must
    match too: a checkpoint leaf whose dtype differs from the target's
    raises unless ``cast=True`` explicitly opts into the conversion (a
    silent fp32 -> int8 cast truncates without complaint).
    """
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        def restore(key, tgt):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(tgt.shape)}")
            return _restore_leaf(key, arr, tgt, cast)

        return map_with_path(restore, target)
