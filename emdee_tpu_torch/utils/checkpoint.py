"""Checkpoint / resume for simulation state (counterpart of
emdee_tpu/utils/checkpoint.py).

The reference has none (SURVEY.md §5).  A checkpoint is a flat .npz of the
state's leaves plus a JSON `__meta__`, and that file format is the
contract: `leaf_i` holds the i-th leaf in the order `jax.tree_util`
flattens the same structure — NamedTuple fields in order, tuples and lists
in order, dict entries by sorted key, `None` fields dropped — so a
checkpoint written by either package loads into the other (the dense
engine's `CellDenseState` has the same fields in both).  A torch generator
(a thermostat's `rng`) rides beside the leaves as `__rng__`, which readers
of the leaf format ignore.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _normalized(path: str) -> str:
    """np.savez silently appends '.npz' when missing — normalize up front so
    save_state(p) / load_state(p) agree for any spelling of p."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: Any, path: str = ""):
    """(path, leaf) pairs of a nest of NamedTuples, tuples, lists and dicts
    in `jax.tree_util.tree_flatten`'s order — NamedTuple fields and
    sequences in order, dict entries by sorted key, None no leaf — each
    path spelled as `jax.tree_util.keystr` spells it (`.field`, `[0]`,
    `['key']`)."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name, child in zip(tree._fields, tree):
            yield from leaves_with_paths(child, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, child in enumerate(tree):
            yield from leaves_with_paths(child, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, torch.Generator):
        raise TypeError(f"a torch.Generator (at {path or 'the root'}) is no checkpoint leaf: pass it as rng=")
    else:
        yield path, tree


def _leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _rebuild(like: Any, leaves) -> Any:
    """`like`'s structure with its leaves taken in order from the iterator."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(child, leaves) for child in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(child, leaves) for child in like)
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves) for key in sorted(like)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _numpy_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_state(path: str, state: Any, rng: Optional[torch.Generator] = None, **metadata) -> None:
    """Write `state`'s leaves and `metadata` (JSON-able) to `path` (.npz);
    rng: a generator whose state is saved too, for a bitwise resume of a
    thermostatted run."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"num_leaves": len(leaves), **metadata}).encode(), dtype=np.uint8
    )
    if rng is not None:
        arrays["__rng__"] = rng.get_state().numpy()
    np.savez(_normalized(path), **arrays)


def load_state(path: str, like: Any, rng: Optional[torch.Generator] = None) -> Tuple[Any, dict]:
    """Load a checkpoint into the structure of `like` (same fields, same
    None fields), each tensor leaf on `like`'s leaf's device and numpy
    leaves as numpy arrays.  rng: a generator set to the saved one's state
    (the checkpoint must hold one).

    Leaf count/shapes/dtypes are validated against `like` so a mismatched
    checkpoint fails here with a clear error instead of downstream inside
    a rollout.
    """
    with np.load(_normalized(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta.pop("num_leaves"))]
        saved_rng = data["__rng__"] if "__rng__" in data.files else None
    like_leaves = _leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint {path!r} holds {len(leaves)} leaves but the target "
            f"structure has {len(like_leaves)}"
        )
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        shape, dtype = tuple(np.shape(want)), _numpy_dtype(want)
        if got.shape != shape or got.dtype != dtype:
            raise ValueError(
                f"checkpoint leaf {i}: shape/dtype {got.shape}/{got.dtype} does "
                f"not match target {shape}/{dtype} — was the geometry "
                "(capacity, cells, atom count) changed since the save?"
            )
    if rng is not None:
        if saved_rng is None:
            raise ValueError(f"checkpoint {path!r} holds no generator state")
        rng.set_state(torch.from_numpy(saved_rng))
    placed = (
        torch.from_numpy(got).to(want.device) if isinstance(want, torch.Tensor) else got
        for got, want in zip(leaves, like_leaves)
    )
    return _rebuild(like, placed), meta
