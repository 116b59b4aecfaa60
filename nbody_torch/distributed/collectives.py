"""The collectives of a slab decomposition, on a list of shards.

Counterpart of ``shard_map`` with ``jax.lax.axis_index``, ``ppermute``,
``psum``, ``pmax``, ``pmin``, ``all_gather`` and ``all_to_all`` over a 1-D
mesh axis.  One process drives every shard: a shard's data is one tensor
of a Python list, indexed by the shard's position d on the axis, and
lives on ``group.devices[d]``.  A collective takes the list of per-shard tensors
and returns the list of results, each moved to its shard's device with
``.to(device)``.  Several shards may share one device (four shards on one
card run the arithmetic of four cards); then a move is no copy, and a
result may share memory with an input, so callers do not update the
results of a collective in place.

Reductions add and compare in shard order, so a result does not depend on
where the shards live.  A group keeps no state between calls.
"""

from __future__ import annotations

from typing import Sequence

import torch


class ShardGroup:
    """D shards on a 1-D axis; shard d lives on ``devices[d]``."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a ShardGroup needs at least one shard")
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def _check(self, xs) -> None:
        if len(xs) != self.size:
            raise ValueError(f"expected {self.size} shards, got {len(xs)}")

    def ppermute(self, xs, shift: int) -> list:
        """Shard d receives shard (d - shift) mod D's tensor: shift +1 is
        the JAX package's forward ring (i -> i + 1), -1 the backward."""
        self._check(xs)
        D = self.size
        return [xs[(d - shift) % D].to(self.devices[d]) for d in range(D)]

    def _reduce(self, xs, op) -> list:
        self._check(xs)
        total = xs[0].to(self.devices[0])
        for x in xs[1:]:
            total = op(total, x.to(self.devices[0]))
        return [total.to(dev) for dev in self.devices]

    def psum(self, xs) -> list:
        """Every shard receives the sum, taken in shard order."""
        return self._reduce(xs, torch.add)

    def pmax(self, xs) -> list:
        """Every shard receives the elementwise maximum."""
        return self._reduce(xs, torch.maximum)

    def pmin(self, xs) -> list:
        """Every shard receives the elementwise minimum."""
        return self._reduce(xs, torch.minimum)

    def all_gather(self, xs, dim: int = 0) -> list:
        """Every shard receives the shards' tensors concatenated along
        ``dim`` in shard order."""
        self._check(xs)
        return [torch.cat([x.to(dev) for x in xs], dim=dim)
                for dev in self.devices]

    def all_to_all(self, xs, split_dim: int, concat_dim: int) -> list:
        """``jax.lax.all_to_all(..., tiled=True)``: each shard cuts its
        tensor into D equal blocks along ``split_dim`` and sends block j to
        shard j, which concatenates what it receives along ``concat_dim``
        in shard order."""
        self._check(xs)
        D = self.size
        blocks = []
        for x in xs:
            if x.shape[split_dim] % D:
                raise ValueError(f"all_to_all: dim {split_dim} of size "
                                 f"{x.shape[split_dim]} does not split over "
                                 f"{D} shards")
            blocks.append(torch.chunk(x, D, dim=split_dim))
        return [torch.cat([blocks[i][j].to(self.devices[j])
                           for i in range(D)], dim=concat_dim)
                for j in range(D)]
