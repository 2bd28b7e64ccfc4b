"""The port's device mesh: what the reference takes from `jax.sharding`.

The reference serves a multi-shard index as one SPMD program: a
`jax.sharding.Mesh` names the devices, `shard_map` runs one body per
device, and `all_gather` / `psum` join the bodies' outputs into
replicated results (`parallel/sharded.py`). This module has no JAX
counterpart of its own; it keeps that single-controller model in
PyTorch: one process drives every card the index sits on.

- `Mesh(devices, axis_names)`: `devices` is an array of `torch.device`
  (numpy object array, one dimension per axis name); `mesh.shape[axis]`
  works as in JAX. Entries may repeat one device: eight shards on one
  card (or on the CPU) are a mesh of eight equal entries, as the
  reference's tests run eight shards on one host's forced devices.
- `run_bodies(devices, body)`: one body per shard, each launched on its
  own device, in shard order. Nothing synchronises between them, so on
  distinct cards the launches overlap; a body must not read a device
  value on the host (`.item()`, `.tolist()`), or the cards serialise.
- `all_gather(pieces, lead)`: each shard's piece copied to the lead
  device (`Tensor.to(lead, non_blocking=True)`: a peer copy between two
  cards, nothing on one) and stacked in shard order.
- `psum(pieces, lead)`: the stacked pieces summed over the shard axis on
  the lead device. Only integer planes are summed (totals, bucket
  counts): integer addition is exact in any order, so the sum equals the
  host loop's fold. A float plane raises; per-shard float planes come
  back stacked for the host's float64 finish instead.

Replicated outputs live on the mesh's first device (`Mesh.lead`).
Multi-process collectives (NCCL across hosts) are not here: they belong
to the cluster (ROADMAP queue A13).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch


class Mesh:
    """An n-d array of torch devices with one name per axis."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        arr.reshape(-1)[:] = [torch.device(d) for d in flat]
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(
                f"{arr.ndim}-d devices for axes {self.axis_names}"
            )
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The device that holds replicated outputs."""
        return self.devices.reshape(-1)[0]

    def axis_devices(self, axis: str, **coords: int) -> list[torch.device]:
        """The devices along `axis`, the other axes fixed at `coords`
        (default 0): a shard axis's home devices."""
        index = tuple(
            slice(None) if name == axis else coords.get(name, 0)
            for name in self.axis_names
        )
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make `device` current for a body's launches (CUDA only)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def run_bodies(devices: list[torch.device], body: Callable[[int], Any]) -> list:
    """body(s) for every shard s, each with its device current, in shard
    order; returns the bodies' outputs in shard order."""
    out = []
    for s, dev in enumerate(devices):
        with on_device(dev):
            out.append(body(s))
    return out


def all_gather(pieces: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The shards' pieces on the lead device, stacked in shard order
    ([S, ...])."""
    return torch.stack([p.to(lead, non_blocking=True) for p in pieces])


def psum(pieces: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The sum of the shards' integer pieces on the lead device."""
    for p in pieces:
        if p.is_floating_point() or p.is_complex():
            raise TypeError(
                f"psum sums integer planes only, got {p.dtype}: float "
                f"planes come back stacked for the host's fold"
            )
    return all_gather(pieces, lead).sum(dim=0, dtype=pieces[0].dtype)
