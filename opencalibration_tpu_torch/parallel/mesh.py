"""Shards of a group axis over devices: the port's counterpart of the
reference's one-dimensional ``"groups"`` mesh axis.

The reference lays the leading group axis of its stacked problems over a
``jax.sharding.Mesh`` and reduces across it with ``psum`` / ``pmax`` inside
``shard_map``. The port runs one process that drives an ordered list of
shards, each a ``torch.device``: the host launches each shard's work on its
device in shard order, and a cross-shard reduction copies the shards'
partials to shard 0's device, adds them there in shard order and copies the
result back to every shard. The order is fixed, so a run is reproducible.

One device may appear more than once (several shards on one card, or on the
CPU), as the reference's tests run a mesh of virtual CPU devices. Every
tensor handed to a shard is then its own copy, never a view or an alias of
another shard's tensor or of the caller's, so an in-place update on one
shard reaches no other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from opencalibration_tpu_torch.relax.blocks import BlockSpec
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams
from opencalibration_tpu_torch.utils.device import resolve_device


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in: a bare
    ``"cuda"`` is the current card, so that two names of one card compare
    equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_devices(device, devices=None) -> List[torch.device]:
    """The shards a stage on ``device`` spreads its groups over: ``devices``
    when given; every card when ``device`` is ``"cuda"`` without an index
    and the host has several (the reference uses every visible device);
    else ``device`` alone."""
    if devices is not None:
        return [canonical_device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, copy=True)


def map_tree(fn, tree):
    """``fn`` on every tensor of a RelaxParams, BlockSpec, dataclass of
    tensors (``SolveInfo``), tuple or list of these, or tensor; ``None``
    passes through."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, t) for t in tree)
    if isinstance(tree, BlockSpec):
        return dataclasses.replace(tree, slots=fn(tree.slots), weight=fn(tree.weight),
                                   data={k: fn(v) for k, v in tree.data.items()})
    if isinstance(tree, RelaxParams):
        return RelaxParams(**{f: fn(getattr(tree, f)) for f in FIELDS})
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: map_tree(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    raise TypeError(f"cannot map over {type(tree).__name__}")


def _leaves(tree) -> list:
    out = []
    map_tree(lambda x: out.append(x) or x, tree)
    return out


def _zip_tree(fn, parts: Sequence):
    """``fn(list of the parts' k-th tensors)`` for every k, in the structure
    of ``parts[0]``."""
    columns = list(zip(*[_leaves(p) for p in parts]))
    it = iter(columns)
    return map_tree(lambda _: fn(list(next(it))), parts[0])


class GroupMesh:
    """An ordered list of shards, each one device; a device may repeat."""

    def __init__(self, devices: Sequence):
        if not len(devices):
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [canonical_device(d) for d in devices]

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"GroupMesh({[str(d) for d in self.devices]})"

    def shard_sizes(self, G: int) -> List[int]:
        """Groups per shard, contiguous and in order: G // D each, the first
        G % D shards one more. The callers pad G to a multiple of D, as a
        ``P("groups")`` split of a leading axis requires."""
        D = len(self.devices)
        return [G // D + (k < G % D) for k in range(D)]

    def _bounds(self, G: int):
        lo = 0
        for n in self.shard_sizes(G):
            yield lo, lo + n
            lo += n

    def split(self, tree) -> list:
        """One part per shard: every tensor's leading (group) axis cut into
        the shards' contiguous ranges, each range copied to its shard's
        device."""
        if tree is None:
            return [None] * len(self.devices)
        G = _leaves(tree)[0].shape[0]
        return [map_tree(lambda x, lo=lo, hi=hi, d=d: _copy_to(x[lo:hi], d), tree)
                for (lo, hi), d in zip(self._bounds(G), self.devices)]

    def gather(self, parts: Sequence, device=None):
        """The shards' parts joined along the leading axis on ``device``
        (shard 0's by default)."""
        dev = self.devices[0] if device is None else canonical_device(device)
        return _zip_tree(lambda xs: torch.cat([x.to(dev) for x in xs]), parts)

    def _all_reduce(self, parts: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
        """``op`` folded over the parts in shard order on shard 0's device;
        one new copy of the result on each shard's device."""
        if len(parts) != len(self.devices):
            raise ValueError(f"{len(parts)} parts for {len(self.devices)} shards")
        dev0 = self.devices[0]
        total = _copy_to(parts[0], dev0)
        for x in parts[1:]:
            total = op(total, x.to(dev0))
        return [total] + [_copy_to(total, d) for d in self.devices[1:]]

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the shards' partial tensors, replicated on every shard."""
        return self._all_reduce(parts, torch.add)

    def pmax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum of the shards' tensors, replicated."""
        return self._all_reduce(parts, torch.maximum)

    def any(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise or of the shards' boolean tensors, replicated."""
        return self._all_reduce(parts, torch.logical_or)
