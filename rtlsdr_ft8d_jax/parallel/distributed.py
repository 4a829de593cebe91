"""Multi-host (N>=2 process) scaffolding: jax.distributed + global meshes.

BASELINE.md config 5 asks for 1000+ channels across N>=2 hosts. The
reference has no distributed story at all (SURVEY §2.2: its only
concurrency is two pthreads); here channel shards live on different
PROCESSES, the mesh is built from the global device list with 'host' as
the slowest-varying axis (collectives between hosts ride DCN, within a
host the cards' own links), and inputs are assembled from per-process local shards.

Launch (one command per host):

  python -m rtlssdr... --coordinator HOST0:1234 --num-processes 2 \
      --process-id 0 ...           # on host 0
  ... --process-id 1 ...           # on host 1

or set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
and call `initialize()` with no args.

Tested without real hosts by tests/test_distributed.py: two CPU processes
(4 virtual devices each) run decode_window_dense over a global
('host','chip') mesh and each asserts its local channels decode.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments, relies on the environment (JAX_COORDINATOR_ADDRESS
    / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    """
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # initialize() raises if the runtime is already up — the only
        # public idempotency signal (probing jax._src internals breaks
        # across JAX upgrades)
        if "already" not in str(e).lower():
            raise


def make_global_grid_mesh(chips_per_host: int | None = None) -> Mesh:
    """('host', 'chip') mesh over ALL processes' devices.

    'host' is the slowest-varying axis: each mesh row is one process's
    local devices, so sharding a channel batch with P(('host','chip'))
    keeps every channel's decode on the host that captured it, and the
    dense-path score all-gather crosses DCN exactly once per window.
    """
    devs = jax.devices()              # global, ordered by process
    n_proc = jax.process_count()
    per = chips_per_host or len(devs) // n_proc
    grid = np.asarray(devs[:n_proc * per]).reshape(n_proc, per)
    return Mesh(grid, ("host", "chip"))


def shard_channels(mesh: Mesh, *local_arrays):
    """Assemble global channel-sharded arrays from per-process local data.

    Each process passes its OWN channels (b_local, ...); the result is the
    global (b_local * n_proc, ...) jax.Array sharded over the mesh, built
    without any cross-host data movement (each shard stays where it was
    produced)."""
    spec = P(tuple(mesh.axis_names))
    sharding = NamedSharding(mesh, spec)
    out = tuple(
        jax.make_array_from_process_local_data(sharding,
                                               np.ascontiguousarray(a))
        for a in local_arrays)
    return out if len(out) > 1 else out[0]


def local_rows(global_array):
    """This process's rows of a channel-sharded global array, as numpy,
    with their global row indices. Used to report each host's own spots."""
    shards = sorted(global_array.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    rows = []
    idx = []
    for s in shards:
        start = s.index[0].start or 0
        data = np.asarray(s.data)
        rows.append(data)
        idx.extend(range(start, start + data.shape[0]))
    return np.concatenate(rows, axis=0), idx
