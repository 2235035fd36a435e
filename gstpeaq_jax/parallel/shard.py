"""Multi-device sharding: codec-eval sweeps over a jax.sharding.Mesh.

PEAQ pairs are embarrassingly parallel, so the sweep is pure data
parallelism: the pair axis is sharded over the mesh's 'pairs' axis and XLA
runs each shard's vmapped pipeline locally — no collectives in the metric
path.  The mesh is flat: the GPUs of one host reach each other all to all.
The cognitive-model training step shards its example batch the same way
with pmean'd gradients.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from .. import constants as C

PAIR_AXIS = "pairs"


def default_mesh(devices=None):
    import jax
    from jax.sharding import Mesh
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (PAIR_AXIS,))


def _mesh_key(mesh) -> tuple:
    """Stable cache key for a mesh: axis names + device ids.  (Keying on
    id(mesh) can alias a new mesh to a dead one's compiled fn after GC;
    two meshes over the same devices/axes are interchangeable here.)"""
    return (tuple(mesh.axis_names),
            tuple(d.id for d in mesh.devices.flat))


@functools.lru_cache(maxsize=16)
def _jitted_sharded(advanced: bool, playback_level: float,
                    settings: C.Settings, dtype_name: str, mesh_key: tuple,
                    buckets: tuple):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .. import api
    mesh = _MESHES[mesh_key]
    dtype, sdtype = api.resolve_dtypes(dtype_name)
    if advanced:
        from ..models import advanced as mod
        pipe, consts = mod.make_pipeline(
            playback_level, settings, dtype, sdtype,
            fft_spectra=api.use_fft_spectra(dtype_name),
            accurate=api.use_accurate(dtype_name))
        pipe = mod.unified_input(pipe, buckets[0], buckets[1])
        # sig_pair ships PAIR-OUTERMOST [2, B, ...] (batch.prepare_chunk)
        in_axes = (None, 1, 0, 0)
    else:
        from ..models import basic as mod
        pipe, consts = mod.make_pipeline(
            C.BASIC_BAND_COUNT, playback_level, settings, dtype, sdtype,
            fft_spectra=api.use_fft_spectra(dtype_name),
            accurate=api.use_accurate(dtype_name))
        in_axes = (None, 0, 0, 0)
    batched = jax.vmap(pipe, in_axes=in_axes)
    data_sharding = NamedSharding(mesh, P(PAIR_AXIS))
    rep = NamedSharding(mesh, P())
    consts_shardings = jax.tree.map(lambda _: rep, consts)
    # shard every data array along its BATCH axis (dim 1 for the
    # pair-outermost advanced sig_pair, dim 0 otherwise)
    arg_shardings = tuple(
        NamedSharding(mesh, P(*([None] * ax + [PAIR_AXIS])))
        for ax in in_axes[1:])
    jfn = jax.jit(
        batched,
        in_shardings=(consts_shardings,) + arg_shardings,
        out_shardings=NamedSharding(mesh, P(PAIR_AXIS)))
    return lambda *args: jfn(consts, *args)


_MESHES: dict[tuple, object] = {}


def peaq_sharded(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                 mesh=None, advanced: bool = False,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, granularity: int = 64):
    """Batched ODG sharded across all devices of `mesh` (default: all).

    The pair count is padded to a multiple of the mesh size with dummy pairs
    (results discarded).  Returns dict of numpy arrays like peaq_batch,
    plus "devices": the ids of the devices that hold the output shards.
    """
    from .. import api
    from . import batch as B
    mesh = mesh if mesh is not None else default_mesh()
    n_dev = mesh.devices.size
    refs = [B.as_2d_ship(r) for r in refs]
    tests = [B.as_2d_ship(t) for t in tests]
    n = len(refs)
    pad = (-n) % n_dev
    if pad:
        refs = list(refs) + [refs[-1]] * pad
        tests = list(tests) + [tests[-1]] * pad
    dtype = dtype or api.default_dtype()
    buckets = B.compute_buckets(refs, tests, advanced, granularity)
    arrays = B.prepare_chunk(refs, tests, buckets)
    key = _mesh_key(mesh)
    _MESHES[key] = mesh
    fn = _jitted_sharded(advanced, playback_level, settings, dtype, key,
                         buckets)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P(PAIR_AXIS))
    # advanced sig_pair is pair-outermost [2, B, ...]: batch axis is dim 1
    sh_pair = NamedSharding(mesh, P(None, PAIR_AXIS))
    arrays = [jax.device_put(a, sh_pair if advanced and i == 0 else sh)
              for i, a in enumerate(arrays)]
    out = fn(*arrays)
    return {
        "odg": np.asarray(out.odg)[:n],
        "di": np.asarray(out.di)[:n],
        "movs": np.asarray(out.movs)[:n],
        "devices": {s.device.id for s in out.odg.addressable_shards},
    }


def train_cognitive_sharded(movs: np.ndarray, target_di: np.ndarray,
                            mesh=None, advanced: bool = False,
                            steps: int = 100, lr: float = 1e-2):
    """Refit the MOV->DI cognitive model with data-parallel SGD on a mesh.

    movs: [N, M]; target_di: [N].  The example axis is sharded over the mesh;
    gradients are averaged across devices (jax.lax.pmean under shard_map).
    Returns (params, losses); params are replicated over the mesh.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map
    from ..models import nn

    mesh = mesh if mesh is not None else default_mesh()
    n_dev = mesh.devices.size
    n = movs.shape[0]
    pad = (-n) % n_dev
    if pad:
        movs = np.concatenate([movs, movs[:pad]], axis=0)
        target_di = np.concatenate([target_di, target_di[:pad]], axis=0)
    params = nn.init_cognitive_params(advanced)

    data_spec = P(PAIR_AXIS)
    rep = P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(rep, data_spec, data_spec),
        out_specs=(rep, rep), check_vma=False)
    def step(params, movs_shard, target_shard):
        return nn.sgd_train_step(params, movs_shard, target_shard, lr,
                                 axis_name=PAIR_AXIS)

    step = jax.jit(step)
    data = NamedSharding(mesh, data_spec)
    movs_j = jax.device_put(jnp.asarray(movs), data)
    tgt_j = jax.device_put(jnp.asarray(target_di), data)
    losses = []
    for _ in range(steps):
        params, loss = step(params, movs_j, tgt_j)
        losses.append(float(loss))
    return params, losses
