"""Device mesh setup and sharding helpers.

Accelerator-native replacement for the reference's (nonexistent) parallelism
(SURVEY.md §2.3: the reference is single-process; its only sharding structure
is per-branch grouping + ``key % 32`` k-mer batches). Here:

* the **branch axis** shards data-parallel over the mesh ("branch") — each
  device enumerates its slice of ghost matrices;
* the **key axis** ("key") shards the k-mer space for the distributed MI
  reduction and the merge — the direct analog of ``kmer_batch``
  (``branch_group.cpp:104-107``), but as contiguous device-resident ranges
  with XLA collectives instead of spill-to-disk hash maps.

Multi-host: ``jax.distributed.initialize`` + the same mesh spanning all
processes; XLA hands the collectives to NCCL. Every card of a host reaches
every other at the same rate (NVLink, all to all), so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "branch_sharding", "replicated", "P", "Mesh",
           "initialize_distributed"]


def make_mesh(n_branch: Optional[int] = None, n_key: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a ("branch", "key") mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_branch is None:
        n_branch = len(devices) // n_key
    if n_branch * n_key != len(devices):
        raise ValueError(
            f"mesh {n_branch}x{n_key} does not cover {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(n_branch, n_key)
    return Mesh(dev_array, axis_names=("branch", "key"))


def branch_sharding(mesh: Mesh) -> NamedSharding:
    """First-axis sharding over the branch axis (ghost/group tensors)."""
    return NamedSharding(mesh, P("branch"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host init (``jax.distributed``); no-op when single-process."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
