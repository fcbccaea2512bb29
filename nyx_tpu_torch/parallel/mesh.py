"""Device meshes for ensemble-parallel propagation.

Port of nyx_tpu/parallel/mesh.py. The reference shards the ensemble axis
over a `jax.sharding.Mesh` and lets XLA's SPMD partitioner run each lane's
adaptive stepping on its device, with no communication until the results
are gathered. Here a `Mesh` is a tuple of `torch.device`, the axis name
beside it: the batch is padded to a multiple of the device count
(`pad_to_multiple`, copies of the last row), cut into one slice a device
(`shard_ensemble`), and each slice runs in a host thread of its own under a
CUDA stream of its own (`run_on_shards`), so shards on several cards run
side by side; the caller gathers the slices in order. Shards that share a
device take turns on it: every eager torch operation drops and retakes
the GIL, so threads dispatching to one card at once hand the GIL over at
every operation, and on one H100 three overlapping shards took 3.2x as
long as the same shards in turn (PERF.md, §6). Shards on several cards
take turns only in the forward-mode AD sections (`xmath.FORWARD_AD`).

A device may appear more than once (`[cuda:0] * 3`, or `[cpu] * 8` in the
tests, the counterpart of the 8 virtual CPU devices the reference's tests
give JAX): each appearance is a shard.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..errors import ConfigError
from ..tracing import annotate

ENSEMBLE_AXIS = "ensemble"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one shard a device entry, along `axis_names[0]`."""

    devices: tuple
    axis_names: tuple = (ENSEMBLE_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ConfigError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        """The number of shards (the reference's `mesh.devices.size`)."""
        return len(self.devices)


def ensemble_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every CUDA device (or the given ones) with the ensemble
    axis. Without a CUDA device and without `devices` it raises: it never
    builds a CPU mesh on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ConfigError("ensemble_mesh() found no CUDA device; pass the devices to "
                              "shard over explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices))


@dataclass(frozen=True)
class EnsembleSharding:
    """The batch axis cut into `mesh.size` equal, consecutive slices, slice k
    on `mesh.devices[k]` (the reference's NamedSharding along the axis)."""

    mesh: Mesh

    def slices(self, n: int) -> List[slice]:
        """The slices of a batch of `n`, a multiple of the mesh's size."""
        k = self.mesh.size
        if n % k:
            raise ConfigError(f"a batch of {n} does not split over {k} shards; pad it first "
                              "(pad_to_multiple)")
        per = n // k
        return [slice(i * per, (i + 1) * per) for i in range(k)]


def ensemble_sharding(mesh: Mesh) -> EnsembleSharding:
    return EnsembleSharding(mesh)


def shard_ensemble(arr, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """A [B, ...] array cut along its batch axis over the mesh: one tensor a
    shard, on its device (B a multiple of the mesh's size)."""
    mesh = mesh or ensemble_mesh()
    t = torch.as_tensor(arr)
    return [t[sl].to(dev) for sl, dev in zip(ensemble_sharding(mesh).slices(t.shape[0]),
                                             mesh.devices)]


def pad_to_multiple(arr, multiple: int):
    """Pad the batch axis so it divides the device count; returns (arr, n_pad).

    Padding replicates the last row so padded lanes converge identically
    (no NaN risk) and are sliced away afterwards. Takes a tensor or a numpy
    array and returns the same kind."""
    b = arr.shape[0]
    n_pad = (-b) % multiple
    if n_pad == 0:
        return arr, 0
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((n_pad,) + tuple(arr.shape[1:]))]), n_pad
    arr = np.asarray(arr)
    return np.concatenate([arr, np.repeat(arr[-1:], n_pad, axis=0)]), n_pad


def _card(dev: torch.device) -> tuple:
    """The physical device `dev` names (cuda and cuda:0 are one card)."""
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


def run_on_shards(mesh: Mesh, fn: Callable[[int, torch.device], object],
                  label: str = "shard") -> list:
    """[fn(k, mesh.devices[k]) for each shard k], each call in a host thread
    of its own; on a CUDA device under a stream of its own (which first
    waits for the device's current stream, so inputs made there are ready,
    and is synchronized before the thread ends). Shards of one device take
    turns. Each call runs inside a profiler region "<label> <k> on
    <device>" and with the caller's grad mode. The threads are joined, and
    the first exception raised in any shard is raised again here."""
    results = [None] * mesh.size
    errors = []
    lock = threading.Lock()
    grad = torch.is_grad_enabled()
    turns = {_card(d): threading.Lock() for d in mesh.devices}

    def work(k: int):
        dev = mesh.devices[k]
        try:
            with turns[_card(dev)], torch.set_grad_enabled(grad), annotate(f"{label} {k} on {dev}"):
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        stream = torch.cuda.Stream(dev)
                        stream.wait_stream(torch.cuda.current_stream(dev))
                        with torch.cuda.stream(stream):
                            results[k] = fn(k, dev)
                        stream.synchronize()
                else:
                    results[k] = fn(k, dev)
        except BaseException as e:  # noqa: BLE001 - handed to the caller's thread
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=work, args=(k,), name=f"{label}-{k}", daemon=True)
               for k in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
