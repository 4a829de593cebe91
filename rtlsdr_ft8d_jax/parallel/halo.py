"""Sequence-parallel decimation: time axis sharded, halos between devices.

The direct distributed analogue of the reference's static filter-state
carry (rtlsdr_ft8d.c:80-86,112-114): when one channel's 2.4 Msps stream is
split in time across devices, each shard needs the previous shard's last
HISTORY (=5250) input samples. That halo travels with jax.lax.ppermute over
the mesh's device links inside shard_map — no host round-trip, no gather of the
full stream anywhere.
"""


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.decimate import HISTORY, R, polyphase_decimate
from .sharding import make_mesh

TIME_AXIS = "t"


def make_time_mesh(num_devices: int | None = None) -> Mesh:
    return make_mesh(num_devices, TIME_AXIS)


def _check_span(n: int, axis_size: int, history: int, what: str) -> None:
    local_span = n // axis_size
    assert local_span >= history, (
        f"per-device span {local_span} must cover the {history}-sample "
        f"{what} halo (use fewer devices or longer windows)")


def decimate_time_sharded(i_s, q_s, mesh: Mesh):
    """Decimate a 1-D (n,) stream whose time axis is sharded over the mesh.

    n must be divisible by (mesh_size * 750) and each device's span must
    cover the HISTORY halo. Each device filters its local span using a
    HISTORY-sample halo received from its left neighbor via ppermute;
    device 0 uses zeros (stream start). Output is the (n/750,) decimated
    stream, time-sharded the same way. For (B, n) inputs use
    decimate_batch_time_sharded — in_specs here shard axis 0, so a 2-D
    input would be batch-sharded and halo the wrong data.
    """
    assert i_s.ndim == 1, "1-D stream expected; see decimate_batch_time_sharded"
    axis_size = mesh.shape[TIME_AXIS]
    _check_span(i_s.shape[-1], axis_size, HISTORY, "decimator")

    def local(i_loc, q_loc):
        # i_loc: (n_local,) — this device's time span
        perm = [(d, d + 1) for d in range(axis_size - 1)]
        halo_i = jax.lax.ppermute(i_loc[..., -HISTORY:], TIME_AXIS, perm)
        halo_q = jax.lax.ppermute(q_loc[..., -HISTORY:], TIME_AXIS, perm)
        # device 0 received nothing -> ppermute fills zeros (stream start)
        i_full = jnp.concatenate([halo_i, i_loc], axis=-1)
        q_full = jnp.concatenate([halo_q, q_loc], axis=-1)
        return polyphase_decimate(i_full, q_full)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(TIME_AXIS), P(TIME_AXIS)),
                   out_specs=(P(TIME_AXIS), P(TIME_AXIS)))
    return fn(i_s, q_s)


def channelize_time_sharded(i_s, q_s, mesh: Mesh):
    """Sequence-parallel wideband channelization: the 2.4 Msps stream's time
    axis sharded over the mesh, each device channelizing its span with a
    WB_HISTORY (=47250) sample halo from its left neighbor via ppermute.
    Returns (1500, n/750) per-channel baseband, time-sharded on the output
    axis."""
    from ..ops.channelize import WB_HISTORY, channelize

    axis_size = mesh.shape[TIME_AXIS]
    local_span = i_s.shape[-1] // axis_size
    assert local_span >= WB_HISTORY, (
        f"per-device span {local_span} must cover the {WB_HISTORY}-sample "
        "channelizer halo (use fewer devices or longer windows)")
    local_frames = local_span // R

    def local(i_loc, q_loc):
        perm = [(d, d + 1) for d in range(axis_size - 1)]
        halo_i = jax.lax.ppermute(i_loc[..., -WB_HISTORY:], TIME_AXIS, perm)
        halo_q = jax.lax.ppermute(q_loc[..., -WB_HISTORY:], TIME_AXIS, perm)
        i_full = jnp.concatenate([halo_i, i_loc], axis=-1)
        q_full = jnp.concatenate([halo_q, q_loc], axis=-1)
        # global frame offset keeps the odd channels' (-1)^m rotation
        # continuous across shards with odd per-device frame counts
        offset = jax.lax.axis_index(TIME_AXIS) * local_frames
        return channelize(i_full, q_full, offset % 2)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(TIME_AXIS), P(TIME_AXIS)),
                   out_specs=(P(None, TIME_AXIS), P(None, TIME_AXIS)))
    return fn(i_s, q_s)


def decimate_batch_time_sharded(i_s, q_s, mesh: Mesh):
    """(B, n) variant: batch replicated dims first, time axis last."""
    axis_size = mesh.shape[TIME_AXIS]
    _check_span(i_s.shape[-1], axis_size, HISTORY, "decimator")

    def local(i_loc, q_loc):
        perm = [(d, d + 1) for d in range(axis_size - 1)]
        halo_i = jax.lax.ppermute(i_loc[..., -HISTORY:], TIME_AXIS, perm)
        halo_q = jax.lax.ppermute(q_loc[..., -HISTORY:], TIME_AXIS, perm)
        i_full = jnp.concatenate([halo_i, i_loc], axis=-1)
        q_full = jnp.concatenate([halo_q, q_loc], axis=-1)
        return polyphase_decimate(i_full, q_full)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(None, TIME_AXIS), P(None, TIME_AXIS)),
                   out_specs=(P(None, TIME_AXIS), P(None, TIME_AXIS)))
    return fn(i_s, q_s)
