"""Device mesh + channel-sharded decode.

The reference decodes ONE band channel on one CPU core (rtlsdr_ft8d.c:1278
tunes a single dial frequency). This build's scale axis is *channels*:
N simultaneous band channels sharded over a 1-D ('ch',) mesh — the decode
graph is embarrassingly parallel per channel, so XLA partitions every stage
(waterfall FFT, sync reduction, LDPC BP) without inserting collectives;
traffic between devices appears only in the streaming front-end's overlap-save halo exchange
(ops/decimate.py) and optional global candidate gathers.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..pipeline import decode_window_device

CHANNEL_AXIS = "ch"


def make_mesh(num_devices: int | None = None,
              axis_name: str = CHANNEL_AXIS) -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CHANNEL_AXIS))


def decode_window_sharded(i_samples, q_samples, mesh: Mesh, **kw):
    """Decode (B, 48000) float32 I/Q channels sharded over the mesh.

    B must be a multiple of the mesh size. Returns the same dict as
    decode_window_device with outputs sharded along the channel axis.
    """
    sharding = channel_sharding(mesh)
    i_s = jax.device_put(jax.numpy.asarray(i_samples), sharding)
    q_s = jax.device_put(jax.numpy.asarray(q_samples), sharding)
    return decode_window_device(i_s, q_s, **kw)
