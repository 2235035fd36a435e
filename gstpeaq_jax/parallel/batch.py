"""Batched PEAQ over many pairs (single device): vmap + length bucketing.

Pairs are zero-padded to a shared frame count per bucket; the accumulator
tentative semantics mask trailing padding frames automatically (accum.py),
so padding changes nothing — no per-pair masks needed.  Bucket frame counts
are rounded up to a coarse grid to bound the number of compiled programs.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from .. import constants as C
from ..ops import framing


def bucket_frames(n_frames: int, granularity: int = 64) -> int:
    """Round a frame count up to the bucket grid."""
    return max(granularity,
               -(-n_frames // granularity) * granularity)


@functools.lru_cache(maxsize=16)
def _jitted_basic_batch(playback_level: float, settings: C.Settings,
                        dtype_name: str):
    import jax
    from .. import api
    from ..models import basic
    dtype, sdtype = api.resolve_dtypes(dtype_name)
    pipe, consts = basic.make_pipeline(
        C.BASIC_BAND_COUNT, playback_level, settings, dtype, sdtype,
        fft_spectra=api.use_fft_spectra(dtype_name),
        accurate=api.use_accurate(dtype_name))
    jfn = jax.jit(jax.vmap(pipe, in_axes=(None, 0, 0, 0)))
    return lambda *args: jfn(consts, *args)


@functools.lru_cache(maxsize=64)
def _jitted_advanced_batch(playback_level: float, settings: C.Settings,
                           dtype_name: str, n_fft: int, n_fb: int):
    """Keyed on the bucket frame counts too: the unified raw-input
    wrapper (models/advanced.unified_input) needs them statically."""
    import jax
    from .. import api
    from ..models import advanced
    dtype, sdtype = api.resolve_dtypes(dtype_name)
    pipe, consts = advanced.make_pipeline(
        playback_level, settings, dtype, sdtype,
        fft_spectra=api.use_fft_spectra(dtype_name),
        accurate=api.use_accurate(dtype_name))
    upipe = advanced.unified_input(pipe, n_fft, n_fb)
    # sig_pair ships PAIR-OUTERMOST [2, B, ...] (see prepare_chunk):
    # the batch axis is dim 1
    jfn = jax.jit(jax.vmap(upipe, in_axes=(None, 1, 0, 0)))
    return lambda *args: jfn(consts, *args)


def as_2d_ship(x):
    """[T]/[T, C] -> [T, C], keeping int16 sources int16 (the PCM16 ship
    path: raw transfer + device-side framing.dequantize — half the
    host->device bytes); everything else converts to float32."""
    if getattr(x, "dtype", None) == np.int16:
        return x if x.ndim == 2 else x[:, None]
    from .. import api
    return api._as_2d_f32(x)


def _ship_dtype(refs, tests):
    """int16 when EVERY source is int16 (PCM16 ships raw and dequantizes
    on device — framing.dequantize — halving transfer bytes), else
    float32."""
    if all(s.dtype == np.int16 for s in refs) and \
            all(s.dtype == np.int16 for s in tests):
        return np.int16
    return np.float32


def _pad_pairwise(refs, tests, n_bucket, frame_size, step_size):
    """Truncate each pair at its *own* flush-frame boundary (audio past the
    flush frame is dropped by the reference, src/gstpeaq.c:715-745), then
    zero-extend to the bucket frame count — the padding frames are silent and
    thus auto-masked by the tentative accumulator semantics.  Output is
    CHANNEL-MAJOR ([B, CH, T], [B, CH, T], valid), written directly from
    the sources (the former pad_signal intermediate buffer DOUBLED the
    host copy volume, and host prep — not the device — bounds sweep
    throughput on few-core hosts)."""
    length = framing.padded_length(n_bucket, frame_size, step_size)
    ch = refs[0].shape[1]
    b = len(refs)
    dt = _ship_dtype(refs, tests)
    out_r = np.zeros((b, ch, length), dtype=dt)
    out_t = np.zeros((b, ch, length), dtype=dt)
    valids = np.empty((b,), dtype=np.int32)
    for i, (r, t) in enumerate(zip(refs, tests)):
        n_own = framing.num_frames(r.shape[0], t.shape[0], frame_size,
                                   step_size)
        own_len = framing.padded_length(n_own, frame_size, step_size)
        for sig, dst in ((r, out_r), (t, out_t)):
            take = min(own_len, sig.shape[0])
            dst[i, :, :take] = sig[:take].T
        valids[i] = n_own
    return out_r, out_t, valids


def compute_buckets(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                    advanced: bool = False, granularity: int = 64):
    """Shared bucket frame counts (n_fft[, n_fb]) for a set of pairs."""
    n_fft = max(framing.num_frames(r.shape[0], t.shape[0],
                                   C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                for r, t in zip(refs, tests))
    n_fft = bucket_frames(n_fft, granularity)
    if not advanced:
        return (n_fft,)
    n_fb = max(framing.num_frames(r.shape[0], t.shape[0],
                                  C.FB_FRAMESIZE, C.FB_FRAMESIZE)
               for r, t in zip(refs, tests))
    # ~5.3 FB frames per FFT frame: a 6x grid keeps the FB bucket count
    # in step with the FFT one
    return (n_fft, bucket_frames(n_fb, granularity * 6))


def prepare_chunk(refs, tests, buckets):
    """Pad one chunk of [T, C] pairs to the shared `buckets` frame counts.

    Basic: returns (ref_fft [B, CH, T], test_fft, valid_fft).
    Advanced: returns (sig_pair, valid_fft, valid_fb) — ONE raw
    ref/test-stacked audio array [2, B, CH, Tmax] covering BOTH paths
    (models/advanced.unified_input slices each path's prefix on device;
    shipping per-path padded copies doubled transfer and host-padding
    cost).  The PAIR axis is outermost: the compiled program indexes
    sig_pair[0]/sig_pair[1], so shipping pair-major makes the default
    layout the wanted one.  When aligned it ships in the HOP
    [2, B, CH, Tmax/1024, 1024] or blocked [2, B, CH, Tmax/128, 128]
    layout (free host reshapes)."""
    if len(buckets) == 1:
        out_r, out_t, valid = _pad_pairwise(refs, tests, buckets[0],
                                            C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        # HOP-layout ship [B, CH, F+1, 1024] (free host reshape; T is
        # always (n+1)*1024): the rows ARE the rDFT's hop blocks, so the
        # device never runs a blocked->flat merge or blocks_hop retile —
        # see models/basic.py and framing.fft_gate_from_max5_hops
        hop = C.FFT_STEPSIZE
        return (out_r.reshape(*out_r.shape[:-1], -1, hop),
                out_t.reshape(*out_t.shape[:-1], -1, hop), valid)
    t_fft = framing.padded_length(buckets[0], C.FFT_FRAMESIZE,
                                  C.FFT_STEPSIZE)
    t_fb = buckets[1] * C.FB_FRAMESIZE
    t_max = max(t_fft, t_fb)
    ch = refs[0].shape[1]
    b = len(refs)
    out = np.zeros((2, b, ch, t_max), dtype=_ship_dtype(refs, tests))
    valid_fft = np.empty((b,), dtype=np.int32)
    valid_fb = np.empty((b,), dtype=np.int32)
    for i, (r, t) in enumerate(zip(refs, tests)):
        valid_fft[i] = framing.num_frames(r.shape[0], t.shape[0],
                                          C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        valid_fb[i] = framing.num_frames(r.shape[0], t.shape[0],
                                         C.FB_FRAMESIZE, C.FB_FRAMESIZE)
        for j, sig in enumerate((r, t)):
            take = min(t_max, sig.shape[0])
            out[j, i, :, :take] = sig[:take].T
    hop = C.FFT_STEPSIZE
    if t_max % hop == 0 and t_fb % hop == 0:
        # HOP-layout ship (see the basic branch above; the FB path
        # re-tiles its prefix to 128-blocks on device in one reshape)
        out = out.reshape(*out.shape[:-1], -1, hop)
    elif t_max % 128 == 0 and t_fb % 128 == 0:
        out = out.reshape(*out.shape[:-1], -1, 128)
    return out, valid_fft, valid_fb


def prepare_batch(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                  advanced: bool = False, granularity: int = 64):
    """Pad a list of [T, C] float32 pairs into stacked batch arrays.

    Returns (ref_fft, test_fft[, ref_fb, test_fb]) stacked [B, CH, T]."""
    return prepare_chunk(
        refs, tests, compute_buckets(refs, tests, advanced, granularity))


def peaq_batch(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
               advanced: bool = False, playback_level: float = 92.0,
               settings: C.Settings = C.DEFAULT_SETTINGS,
               dtype: str | None = None, granularity: int = 64,
               microbatch: int = 8, prefetch_gb: float = 6.0,
               timings: dict | None = None):
    """Compute ODG/DI for a batch of pairs on the current default device.

    refs/tests: sequences of [T] or [T, C] float arrays (48 kHz).  The batch
    is processed in `microbatch`-sized device invocations to bound HBM
    footprint (activations scale with pairs x frames); the last chunk is
    padded with duplicates (discarded).

    All input chunks are shipped with explicit device_put; when the padded
    batch fits `prefetch_gb`, every chunk is transferred BEFORE the first
    dispatch, and larger batches interleave prep/put/dispatch.
    Returns dict with 'odg' [B], 'di' [B], 'movs' [B, M] numpy arrays.

    `timings`, if given, is filled with wall-second phase attribution:
    'stage' (host padding + device puts), 'dispatch' (all fn() calls),
    'first_sync' (first result materialization, which includes the first
    program's execution), 'drain' (the remaining materializations).
    """
    import time as _time

    import jax
    from .. import api
    api.enable_compile_cache()
    refs = [as_2d_ship(r) for r in refs]
    tests = [as_2d_ship(t) for t in tests]
    dtype = dtype or api.default_dtype()
    buckets = compute_buckets(refs, tests, advanced, granularity)
    if advanced:
        fn = _jitted_advanced_batch(playback_level, settings, dtype,
                                    buckets[0], buckets[1])
    else:
        fn = _jitted_basic_batch(playback_level, settings, dtype)
    n = len(refs)
    mb = min(microbatch, n) if microbatch else n

    def chunks_np():
        for start in range(0, n, mb):
            # host padding happens PER MICROBATCH (sweep-scale batches
            # would otherwise hold a second fully-padded copy of the
            # whole corpus)
            r_chunk = refs[start:start + mb]
            t_chunk = tests[start:start + mb]
            pad = mb - len(r_chunk)
            if pad:
                r_chunk = list(r_chunk) + [r_chunk[-1]] * pad
                t_chunk = list(t_chunk) + [t_chunk[-1]] * pad
            yield prepare_chunk(r_chunk, t_chunk, buckets), mb - pad

    t_fft = framing.padded_length(buckets[0], C.FFT_FRAMESIZE,
                                  C.FFT_STEPSIZE)
    bytes_per_pair = float(_ship_dtype(refs, tests)().itemsize) \
        * 2 * refs[0].shape[1] * (
        max(t_fft, buckets[1] * C.FB_FRAMESIZE) if advanced else t_fft)
    prefetch = (-(-n // mb) * mb) * bytes_per_pair <= prefetch_gb * 1e9

    outs, takes = [], []
    t0 = _time.perf_counter()
    if prefetch:
        staged = [([jax.device_put(a) for a in chunk], take)
                  for chunk, take in chunks_np()]
        t1 = _time.perf_counter()
        for chunk, take in staged:
            # dispatch every chunk before materializing any result:
            # syncing inside the dispatch loop would serialize host round
            # trips with compute
            outs.append(fn(*chunk))
            takes.append(take)
    else:
        t1 = t0
        for chunk, take in chunks_np():
            outs.append(fn(*[jax.device_put(a) for a in chunk]))
            takes.append(take)
    t2 = _time.perf_counter()
    odgs = [np.asarray(outs[0].odg)]
    t3 = _time.perf_counter()
    odgs += [np.asarray(o.odg) for o in outs[1:]]
    res = {
        "odg": np.concatenate([o[:t] for o, t in zip(odgs, takes)]),
        "di": np.concatenate([np.asarray(o.di)[:t]
                              for o, t in zip(outs, takes)]),
        "movs": np.concatenate([np.asarray(o.movs)[:t]
                                for o, t in zip(outs, takes)]),
    }
    if timings is not None:
        t4 = _time.perf_counter()
        timings.update(stage=t1 - t0, dispatch=t2 - t1,
                       first_sync=t3 - t2, drain=t4 - t3)
    return res
