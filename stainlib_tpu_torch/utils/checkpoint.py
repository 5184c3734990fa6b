"""Checkpoint save / resume for training-state pytrees.

Port of the JAX package's ``utils/checkpoint.py``: keep-last-N rotation
plus a ``most_recent`` copy holding the full state (the reference's
``utils.save_checkpoint`` at ``train_img_horo.py:1149-1165``), and an
explicit resume (``:421-448``). A state is any pytree (``torch.utils.
_pytree``: NamedTuples, dicts, lists) of tensors, ints and floats. Its
leaves are saved with ``torch.save`` under their key paths, as CPU tensors
and plain numbers, and read back with ``torch.load(weights_only=True)``
into the structure of a template, on the template's devices.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch
from torch.utils._pytree import keystr, tree_flatten_with_path, tree_unflatten


def _name(tag: str, step: Optional[int]) -> str:
    return f"{tag}_most_recent.pt" if step is None else f"{tag}_{step:08d}.pt"


def _steps(directory: str, tag: str) -> list:
    pattern = re.compile(rf"{re.escape(tag)}_(\d+)\.pt$")
    return sorted(int(m.group(1))
                  for m in (pattern.match(p) for p in os.listdir(directory))
                  if m)


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return leaf


def save_checkpoint(directory: str, state: Any, step: int,
                    keep_last: int = 5, tag: str = "ckpt") -> str:
    """Write ``state`` to ``{directory}/{tag}_{step:08d}.pt``, keep the
    newest ``keep_last`` of them and refresh ``{tag}_most_recent.pt``."""
    os.makedirs(directory, exist_ok=True)
    leaves, _ = tree_flatten_with_path(state)
    blob = {keystr(path): _to_host(leaf) for path, leaf in leaves}
    path = os.path.join(directory, _name(tag, step))
    for target in (path, os.path.join(directory, _name(tag, None))):
        tmp = target + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, target)
    for old in _steps(directory, tag)[:-keep_last]:
        os.remove(os.path.join(directory, _name(tag, old)))
    return path


def latest_step(directory: str, tag: str = "ckpt") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory, tag)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None, tag: str = "ckpt") -> Any:
    """Restore into the structure of ``target`` (a template state): each
    tensor leaf lands on the device of the template's leaf.

    ``step=None`` loads the ``most_recent`` copy. Raises FileNotFoundError
    if nothing is there (resume is explicit, like ``--resume ckpt``), and
    ValueError if the checkpoint's leaves are not the template's."""
    path = os.path.join(directory, _name(tag, step))
    blob = torch.load(path, weights_only=True)
    leaves, spec = tree_flatten_with_path(target)
    keys = [keystr(p) for p, _ in leaves]
    if sorted(keys) != sorted(blob):
        raise ValueError(
            f"{path} holds {len(blob)} leaves that do not match the "
            f"template's {len(keys)}: missing {sorted(set(keys) - set(blob))[:5]}, "
            f"unexpected {sorted(set(blob) - set(keys))[:5]}")
    out = []
    for key, (_, like) in zip(keys, leaves):
        got = blob[key]
        if isinstance(like, torch.Tensor):
            if tuple(got.shape) != tuple(like.shape):
                raise ValueError(f"{path}: {key} has shape "
                                 f"{tuple(got.shape)}, the template "
                                 f"{tuple(like.shape)}")
            got = got.to(like.device)
        out.append(got)
    return tree_unflatten(out, spec)
