"""Level and pattern adaptation, vectorized over the frame axis.

The reference (src/leveladapter.c:242-340) carries eight per-band state
arrays frame by frame. All of them are first-order *linear* recurrences, so
the whole adapter runs as a handful of associative scans over the frame axis
plus elementwise math — no serial loop:

  1. ref/test filtered excitations  (smoothing IIR)      -> scan
  2. scalar level correction        (per-frame reduction) -> elementwise
  3. filtered num/den               (IIR without (1-a))   -> scan
  4. pattern-adaptation sliding average over bands        -> static matmul
  5. pattcorr smoothing             (smoothing IIR)       -> scan

Layout: all band-domain arrays are [..., Z, F] — bands major, frames
minor (the MOV-tail convention).  The banded recurrences consume this
layout natively (no moveaxis) and band reductions contract axis -2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import iir


def sliding_average_matrix(band_count: int) -> np.ndarray:
    """Static [Z, Z] matrix for the +-M1/M2 band average;
    src/leveladapter.c:313-325.  Orientation: out[k] = sum_w in[w] * mat[w, k]
    (bands-minor right-multiply); the transposed-layout left-multiply uses
    mat.T."""
    m1c = band_count // 36
    m2c = band_count // 25
    mat = np.zeros((band_count, band_count))
    for k in range(band_count):
        m1 = min(k, m1c)
        m2 = min(band_count - k - 1, m2c)
        mat[k - m1:k + m2 + 1, k] = 1.0 / (m1 + m2 + 1)
    return mat


def adapt_stage2(a: jnp.ndarray, avg_matrix: jnp.ndarray,
                 ref_excitation: jnp.ndarray, test_excitation: jnp.ndarray,
                 ref_filt: jnp.ndarray, test_filt: jnp.ndarray,
                 state2=None):
    """level_adapt AFTER its stage-1 smoothing (src/leveladapter.c:260-340):
    level correction, num/den smoothers, pattern correlation.  Split out so
    the batch pipelines can run stage 1 fused with the modulation smoothers
    (level_adapt_fused_mod) — the four adapt_a recurrences are mutually
    independent, so one banded call replaces two.

    state2: (filt_num, filt_den, pattcorr_ref, pattcorr_test) or None.
    Returns (adapted_ref, adapted_test, new_state2)."""
    s = state2 if state2 is not None else (None,) * 4
    num = jnp.sum(jnp.sqrt(ref_filt * test_filt), axis=-2)
    den = jnp.sum(test_filt, axis=-2)
    lev_corr = (num * num / (den * den))[..., None, :]   # [..., 1, F]
    louder_ref = lev_corr > 1.0
    levcorr_ref = jnp.where(louder_ref, ref_excitation / lev_corr,
                            ref_excitation)
    levcorr_test = jnp.where(louder_ref, test_excitation,
                             test_excitation * lev_corr)
    # (48); note the input terms are *not* scaled by (1-a);
    # src/leveladapter.c:291-298
    pair2 = None if s[0] is None else jnp.stack([s[0], s[1]])
    nd = iir.linear_recurrence_banded(
        a, jnp.stack([levcorr_test * levcorr_ref,
                      levcorr_ref * levcorr_ref]), axis=-1, y0=pair2)
    filt_num, filt_den = nd[0], nd[1]
    num_ge = filt_num >= filt_den
    pattadapt_ref = jnp.where(num_ge, 1.0, filt_num / filt_den)
    pattadapt_test = jnp.where(num_ge, filt_den / filt_num, 1.0)
    hp = jax.lax.Precision.HIGHEST
    ra = jnp.matmul(avg_matrix.T,
                    jnp.stack([pattadapt_ref, pattadapt_test]),
                    precision=hp)
    a_col = a[:, None]
    pair4 = None if s[2] is None else jnp.stack([s[2], s[3]])
    pc = iir.linear_recurrence_banded(a, (1.0 - a_col) * ra, axis=-1,
                                      y0=pair4)
    pattcorr_ref, pattcorr_test = pc[0], pc[1]
    new_state2 = tuple(x[..., -1] for x in (
        filt_num, filt_den, pattcorr_ref, pattcorr_test))
    return (levcorr_ref * pattcorr_ref, levcorr_test * pattcorr_test,
            new_state2)


def level_adapt_fused_mod(a: jnp.ndarray, avg_matrix: jnp.ndarray,
                          exc2: jnp.ndarray, uns2: jnp.ndarray,
                          step_size: int):
    """Fused level_adapt(exc2[0], exc2[1]) + modulation(uns2) for the batch
    pipelines: the level adapter's stage-1 excitation smoothers and the
    modulation processor's derivative/loudness smoothers are four mutually
    independent adapt_a recurrences over the same [.., Z, F] grid — one
    stacked banded call replaces two (each call pays its own Toeplitz
    einsum dispatch, entry scan, and FMA pass).  Per-slice results are
    bit-identical to the separate calls (the streaming twins keep those).

    exc2/uns2: [2(sig), ..., Z, F].  Returns
    (adapted_ref, adapted_test, mod2, avg_loud2)."""
    from ..constants import SAMPLING_RATE
    scale = SAMPLING_RATE / step_size
    a_col = a[:, None]
    loud = uns2 ** 0.3
    prev = jnp.concatenate(
        [jnp.zeros_like(loud[..., :1]), loud[..., :-1]], axis=-1)
    deriv = scale * jnp.abs(loud - prev)
    drives = (1.0 - a_col) * jnp.stack([exc2, deriv, loud])
    filt = iir.linear_recurrence_banded(a, drives, axis=-1)
    exc_filt, filt_deriv, filt_loud = filt[0], filt[1], filt[2]
    mod2 = filt_deriv / (1.0 + filt_loud / 0.3)
    adapted_ref, adapted_test, _ = adapt_stage2(
        a, avg_matrix, exc2[0], exc2[1], exc_filt[0], exc_filt[1])
    return adapted_ref, adapted_test, mod2, filt_loud


def level_adapt(a: jnp.ndarray, avg_matrix: jnp.ndarray,
                ref_excitation: jnp.ndarray, test_excitation: jnp.ndarray,
                state=None):
    """Process all frames at once.

    a:                [Z] smoothing coefficients (tau 0.008/0.05)
    avg_matrix:       [Z, Z] from sliding_average_matrix
    ref/test_excitation: [..., Z, F]
    `state` carries the six per-band IIR states ([..., Z] each) for chunked
    streaming (ref_filt, test_filt, filt_num, filt_den, pattcorr_ref,
    pattcorr_test).
    Returns (adapted_ref, adapted_test, new_state), each [..., Z, F].
    """
    # The six per-band recurrences batch pairwise into three banded
    # Toeplitz-GEMM calls (a leading ref/test stack axis): same math per
    # slice, half the recurrence-GEMM dispatches with doubled M rows.
    # (45)/(48) in BS.1387; src/leveladapter.c:260-340.
    s = state if state is not None else (None,) * 6
    a_col = a[:, None]                # broadcast against the band axis
    pair0 = None if s[0] is None else jnp.stack([s[0], s[1]])
    filt = iir.linear_recurrence_banded(
        a, (1.0 - a_col) * jnp.stack([ref_excitation, test_excitation]),
        axis=-1, y0=pair0)
    ref_filt, test_filt = filt[0], filt[1]
    adapted_ref, adapted_test, st2 = adapt_stage2(
        a, avg_matrix, ref_excitation, test_excitation, ref_filt, test_filt,
        state2=None if s[2] is None else s[2:])
    new_state = (ref_filt[..., -1], test_filt[..., -1]) + st2
    return adapted_ref, adapted_test, new_state
