"""Multi-chip scaling: device mesh + sharded multi-stream encoding.

The reference's only parallelism is shared-memory pthreads over frames
(encoder.c:2358-2362, doc/threads.txt); there is no distributed backend
to port (SURVEY.md §2.4). The device scaling axes are:

- dp ("streams"): independent video streams/GOPs sharded across cards —
  embarrassingly parallel.
- tile: the MB grid of one frame split across chips along MB rows; ME
  windows need a halo exchange of the reference planes (future work:
  ppermute halos; today each chip holds the full reference and slices
  its own rows, which is bandwidth-fine at video sizes).

`encode_streams_sharded` jits the full fused P-step over a Mesh with the
stream axis sharded; XLA partitions every stage (ME scan, transforms,
stego cost tensor) with zero collectives on the hot path, plus one psum
for global stats so the collective path is exercised.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import pipeline


def build_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def build_multi_encoder(params, mesh: Mesh, axis: str = "dp"):
    """A MultiEncoder whose stream axis is sharded over the mesh: one
    stream per chip. Every stacked device input (frames, refs, MV
    fields) is placed with NamedSharding(mesh, P(axis)), so the vmapped
    analyse/encode/stego/re-encode jits are partitioned by XLA with no
    collectives on the hot path — the device analog of the
    reference's one-thread-per-frame pthreads model
    (/root/reference/encoder/encoder.c:2358-2362, doc/threads.txt)."""
    from ..encoder.multistream import MultiEncoder
    sh = NamedSharding(mesh, P(axis))
    return MultiEncoder(params, mesh.devices.size, sharding=sh)


def encode_streams_sharded(mesh: Mesh, ys, us, vs, ref_lumas, ref_us,
                           ref_vs, prev_mvs, **kw):
    """Run the fused P-step for S streams sharded over the mesh's dp
    axis. All inputs have a leading stream axis divisible by the mesh
    size. Returns the per-stream outputs + a globally-psummed SAD-ish
    stat (forces one collective between the cards)."""
    sh = NamedSharding(mesh, P("dp"))
    put = lambda x: jax.device_put(x, sh)
    args = tuple(map(put, (ys, us, vs, ref_lumas, ref_us, ref_vs,
                           prev_mvs)))

    @functools.partial(jax.jit, static_argnames=tuple(kw.keys()))
    def step(ys, us, vs, rl, ru, rv, pm, **kw2):
        out = pipeline.multi_stream_step(ys, us, vs, rl, ru, rv, pm,
                                         **kw2)
        # cross-stream global stat -> all-reduce over dp
        mv = out["mv8"] if "mv8" in out else out["mv"]
        out["global_mv_mag"] = jnp.sum(jnp.abs(mv))
        return out

    return step(*args, **kw)
