"""Copies of the program's state taken at the trainer's own boundaries, kept
on the host so that they add nothing to the card's memory, and turned into
the reference's own types for the check."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """`fn` over every tensor of a nest of dataclasses, dicts, lists, tuples
    and named tuples; other leaves pass through. A dataclass becomes a dict
    with its class name under "__class__"."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        out["__class__"] = type(tree).__name__
        return out
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def to_host(tree: Any) -> Any:
    """A copy of every tensor of `tree` on the host (waits for the device)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def rebuild(tree: Any, classes: Dict[str, type], device) -> Any:
    """A tree of `to_host` back as objects of `classes` (by class name) with
    their tensors on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict) and "__class__" in tree:
        cls = classes[tree["__class__"]]
        return cls(**{k: rebuild(v, classes, device) for k, v in tree.items() if k != "__class__"})
    if isinstance(tree, dict):
        return {k: rebuild(v, classes, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(v, classes, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, classes, device) for v in tree)
    return tree
