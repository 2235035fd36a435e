"""Public API: peaq(ref, test, advanced=...) -> ODG/DI/MOVs.

Host side prepares fixed-shape, zero-padded signal arrays (the GstAdapter
drain + flush semantics, src/gstpeaq.c:596-611,715-745); the device side is a
single jitted program per (frame-count bucket, mode, dtype).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

from . import constants as C
from .ops import framing


@dataclasses.dataclass
class PeaqResult:
    odg: float
    di: float
    movs: dict[str, float]
    total_snr_db: float | None = None


_CACHE_ENABLED = False


def compile_cache_dir() -> str | None:
    """Where enable_compile_cache points JAX's persistent compilation
    cache: None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself, so no directory is set in code), else `.jax_cache`
    at the checkout root — a fixed path, since the path is part of the
    cache key."""
    import os
    import pathlib
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(pathlib.Path(__file__).resolve().parents[1] / ".jax_cache")


def enable_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent); see
    compile_cache_dir for the directory."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    import jax
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    _CACHE_ENABLED = True


def _bucket(n: int, granularity: int) -> int:
    """Round a frame count up to the bucket grid, bounding the number of
    distinct compiled programs across input lengths.  Padding frames carry
    silence and are excluded via the valid-frame mask, so results are
    identical to exact-length processing (same mechanism as
    parallel/batch.py)."""
    return max(granularity, -(-n // granularity) * granularity)


def _as_2d_f32(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError("signals must be [samples] or [samples, channels]")
    return x


def resolve_dtypes(name: str):
    """Map a precision name to (band_dtype, spectrum_dtype).

    "float64"  exact double everywhere (bit-faithful to the C reference);
               enables jax_enable_x64 process-wide
    "float32"  the throughput tier: DFT-GEMM spectra with the front-end
               GEMMs (rDFT, FB conv, DC tables) at Precision.HIGH — TF32
               on the GPU — and the float32 band chain
    "accurate" the default tier: the SAME dense DFT-GEMM pipelines with
               EVERY front-end GEMM (rDFT, FB conv, EHS) at HIGHEST
               precision + the f32 band chain (tools/noise_budget.py
               bounds every band stage's ODG contribution); its gate is
               |dODG| <= 1e-3 against the float64 tier on the drift
               corpus (tools/drift.py)
    "mixed"    A/B tier: FFT spectra + the same f32 band chain
    Use use_fft_spectra(name) / use_accurate(name) to pick a tier's
    spectrum path and GEMM precision.
    """
    import jax
    import jax.numpy as jnp
    if name == "float64":
        jax.config.update("jax_enable_x64", True)
    if name in ("mixed", "accurate"):
        return jnp.float32, jnp.float32
    d = jnp.dtype(name)
    return d, d


def use_fft_spectra(name: str) -> bool:
    """Whether a precision tier computes spectra with the FFT instead of
    the DFT GEMM (see resolve_dtypes)."""
    return name == "mixed"


def use_accurate(name: str) -> bool:
    """Whether a precision tier pins EVERY front-end GEMM (rDFT/CT, FB
    conv, EHS) to HIGHEST precision (see resolve_dtypes)."""
    return name == "accurate"


def _pad_bucketed(sig: np.ndarray, n_own: int, n_bucket: int,
                  frame_size: int, step_size: int) -> np.ndarray:
    """Pad to the pair's own flush-frame boundary, then zero-extend to the
    bucket frame count (padding is masked out via the valid-frame count).
    Returns CHANNEL-MAJOR [CH, T] (the device layout)."""
    own = framing.pad_signal(sig, n_own, frame_size, step_size)
    length = framing.padded_length(n_bucket, frame_size, step_size)
    out = np.zeros((sig.shape[1], length), dtype=np.float32)
    out[:, :own.shape[0]] = own.T
    return out


@functools.lru_cache(maxsize=32)
def _jitted_basic(n_frames: int, channels: int, playback_level: float,
                  settings: C.Settings, dtype_name: str,
                  band_count: int = C.BASIC_BAND_COUNT):
    import jax
    from .models import basic
    dtype, sdtype = resolve_dtypes(dtype_name)
    pipe, consts = basic.make_pipeline(band_count, playback_level,
                                       settings, dtype, sdtype,
                                       fft_spectra=use_fft_spectra(dtype_name),
                                       accurate=use_accurate(dtype_name))
    jfn = jax.jit(pipe)
    return lambda *args: jfn(consts, *args)


@functools.lru_cache(maxsize=32)
def _jitted_advanced(n_fft_frames: int, n_fb_frames: int, channels: int,
                     playback_level: float, settings: C.Settings,
                     dtype_name: str):
    import jax
    from .models import advanced
    dtype, sdtype = resolve_dtypes(dtype_name)
    pipe, consts = advanced.make_pipeline(
        playback_level, settings, dtype, sdtype,
        fft_spectra=use_fft_spectra(dtype_name),
        accurate=use_accurate(dtype_name))
    jfn = jax.jit(advanced.unified_input(pipe, n_fft_frames, n_fb_frames))
    return lambda *args: jfn(consts, *args)


def default_dtype() -> str:
    """float64 when x64 is enabled, else "accurate" (dense rDFT with
    every front-end GEMM at HIGHEST).  The default is correctness-first:
    the float32 tier is opt-in (`dtype="float32"` /
    `--precision float32`).  See docs/precision.md.
    """
    import jax
    return "float64" if jax.config.jax_enable_x64 else "accurate"


def peaq(ref, test, advanced: bool = False, playback_level: float = 92.0,
         settings: C.Settings = C.DEFAULT_SETTINGS,
         dtype: str | None = None, return_snr: bool = False,
         band_count: int | None = None) -> PeaqResult:
    """Compute PEAQ ODG/DI for one 48 kHz pair.

    ref/test: arrays [samples] or [samples, channels], float; 48 kHz.
    band_count: FFT-ear critical-band count, 55..109 (the reference's
    runtime `number-of-bands` property, src/fftearmodel.c:207-214); basic
    mode only — defaults to 109.  Advanced mode pins 55 as the reference's
    mode switch does (src/gstpeaq.c:534-541).
    """
    enable_compile_cache()
    ref = _as_2d_f32(ref)
    test = _as_2d_f32(test)
    if ref.shape[1] != test.shape[1]:
        raise ValueError("ref/test channel counts differ")
    dtype = dtype or default_dtype()
    if band_count is not None:
        if advanced:
            raise ValueError("band_count applies to basic mode only "
                             "(advanced pins 55)")
        if not 55 <= band_count <= 109:
            raise ValueError("band_count must be in 55..109")

    n_fft = framing.num_frames(ref.shape[0], test.shape[0],
                               C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    n_fft_b = _bucket(n_fft, 32)

    import jax
    if not advanced:
        ref_fft = _pad_bucketed(ref, n_fft, n_fft_b, C.FFT_FRAMESIZE,
                                C.FFT_STEPSIZE)
        test_fft = _pad_bucketed(test, n_fft, n_fft_b, C.FFT_FRAMESIZE,
                                 C.FFT_STEPSIZE)
        # HOP layout [CH, F+1, 1024] (free host reshape; the rows ARE
        # the rDFT's hop blocks) — see models/basic.py
        ref_fft = ref_fft.reshape(ref_fft.shape[0], -1, C.FFT_STEPSIZE)
        test_fft = test_fft.reshape(test_fft.shape[0], -1, C.FFT_STEPSIZE)
        fn = _jitted_basic(n_fft_b, ref.shape[1], playback_level, settings,
                           dtype, band_count or C.BASIC_BAND_COUNT)
        out = fn(jax.device_put(ref_fft), jax.device_put(test_fft),
                 np.int32(n_fft))
        movs = {name: float(v)
                for name, v in zip(C.MOV_BASIC_NAMES, np.asarray(out.movs))}
        snr = None
        if return_snr:
            snr = float(10 * np.log10(out.total_signal_energy
                                      / out.total_noise_energy))
        return PeaqResult(odg=float(out.odg), di=float(out.di), movs=movs,
                          total_snr_db=snr)

    n_fb = framing.num_frames(ref.shape[0], test.shape[0],
                              C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    # 6x the FFT grid (~5.3 FB frames per FFT frame); padding frames are
    # masked
    n_fb_b = _bucket(n_fb, 192)
    # ONE raw signal-pair array covers both ear-model paths (the device
    # slices each path's prefix — models/advanced.unified_input); the
    # blocked [2, CH, Tmax/128, 128] form is a free reshape
    t_fft = framing.padded_length(n_fft_b, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    t_fb = n_fb_b * C.FB_FRAMESIZE
    t_max = max(t_fft, t_fb)
    sig_pair = np.zeros((2, ref.shape[1], t_max), np.float32)
    for j, sig in enumerate((ref, test)):
        take = min(t_max, sig.shape[0])
        sig_pair[j, :, :take] = sig[:take].T
    hop = C.FFT_STEPSIZE
    if t_max % hop == 0 and t_fb % hop == 0:
        # HOP layout (models/advanced.unified_input re-blocks the FB
        # prefix to 128-sample rows on device in one reshape)
        sig_pair = sig_pair.reshape(*sig_pair.shape[:-1], -1, hop)
    elif t_max % 128 == 0 and t_fb % 128 == 0:
        sig_pair = sig_pair.reshape(*sig_pair.shape[:-1], -1, 128)
    fn = _jitted_advanced(n_fft_b, n_fb_b, ref.shape[1], playback_level,
                          settings, dtype)
    out = fn(jax.device_put(sig_pair), np.int32(n_fft), np.int32(n_fb))
    movs = {name: float(v)
            for name, v in zip(C.MOV_ADVANCED_NAMES, np.asarray(out.movs))}
    snr = None
    if return_snr:
        snr = float(10 * np.log10(out.total_signal_energy
                                  / out.total_noise_energy))
    return PeaqResult(odg=float(out.odg), di=float(out.di), movs=movs,
                      total_snr_db=snr)
