"""Device-mesh construction for the (data, model) sharding layout.

The framework's two scaling axes (SURVEY.md §2.6):
  data  — training vectors: the batch is sharded across chips (DP); the
          reference's analogue was streaming via LOADMODE_BUFFER.
  model — the codebook: rows are sharded across chips (TP); the global
          1-NN winner is resolved with a gather+min over the model axis
          (the reference's linear scan had no analogue — new design).

The reference package is single-threaded C with no distribution at all;
this module is new design, not a port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    model: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2-D (data, model) mesh.

    With only n_devices given, every device goes on the model axis: a
    model shard's only collective is the (B, S) gather of winner
    candidates, while each data shard adds a psum of its (rows, D)
    update accumulators — a codebook's worth of bytes per step.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if data is None and model is None:
        data, model = 1, n_devices
    elif data is None:
        data = n_devices // model
    elif model is None:
        model = n_devices // data
    if data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up: wraps jax.distributed.initialize (no-op when
    already initialized or running single-process).  Pass the
    coordinator address, process count and id explicitly: nothing in a
    plain GPU cluster announces them.  After this, jax.devices() spans
    all hosts and make_mesh() lays the (data, model) axes over the global
    device set."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # suppress only the benign re-initialization case; real
        # misconfiguration (bad coordinator, inconsistent process ids)
        # must surface or the mesh silently spans one host
        if "already" not in str(e).lower():
            raise


def class_blocked_order(labels) -> "np.ndarray":
    """Permutation putting same-class codebook rows in contiguous blocks
    — the expert-parallel analogue (SURVEY.md §2.6): with the codebook
    sharded by rows over the model axis, a class-blocked layout lands
    each class's codes on as few shards as possible, so per-class
    workloads (LVQ updates, class statistics) touch fewer shards and the
    balance/eveninit quota logic stays shard-local.

    Returns indices such that codes.take(order) is class-blocked; a
    stable sort keeps the within-class (file) order the quota rules
    depend on."""
    labels = np.asarray(labels)
    return np.argsort(labels, kind="stable")

