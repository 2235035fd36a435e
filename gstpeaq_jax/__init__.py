"""PEAQ (ITU-R BS.1387-1) in JAX.

A ground-up reimplementation of perceptual audio-quality measurement with the
capabilities of HSU-ANT/gstpeaq: both the Basic (FFT ear model, 11 MOVs) and
Advanced (FFT + 40-band filter-bank ear models, 5 MOVs) versions, a
`peaq(ref, test, advanced=...)` API and CLI reporting ODG/DI, batched and
sharded evaluation across device meshes, and chunked streaming for long
programs.
"""

__version__ = "0.1.0"

from .constants import Settings, DEFAULT_SETTINGS  # noqa: F401


def peaq(*args, **kwargs):
    """See gstpeaq_jax.api.peaq (lazy import to keep CLI startup fast)."""
    from . import api
    return api.peaq(*args, **kwargs)


def peaq_batch(*args, **kwargs):
    """See gstpeaq_jax.parallel.batch.peaq_batch."""
    from .parallel import batch
    return batch.peaq_batch(*args, **kwargs)


def peaq_sharded(*args, **kwargs):
    """See gstpeaq_jax.parallel.shard.peaq_sharded."""
    from .parallel import shard
    return shard.peaq_sharded(*args, **kwargs)


__all__ = ["Settings", "DEFAULT_SETTINGS", "__version__", "peaq",
           "peaq_batch", "peaq_sharded"]
