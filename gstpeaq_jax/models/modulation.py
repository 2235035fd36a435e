"""Modulation-pattern processing, vectorized over the frame axis.

src/modpatt.c:222-251: per band, loudness E^0.3, scaled absolute derivative
and loudness both smoothed by first-order IIRs -> two associative scans.

Layout: [..., Z, F] (bands major, frames minor — the MOV-tail
convention); the one-frame derivative shift is a minor-axis slice and the
banded recurrences run with no moveaxis.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants as C
from ..ops import iir


def modulation(a: jnp.ndarray, unsmeared_excitation: jnp.ndarray,
               step_size: int, state=None):
    """unsmeared_excitation: [..., Z, F] ->
    (modulation, average_loudness, new_state), each [..., Z, F].

    `state` carries (previous_loudness, filtered_derivative,
    filtered_loudness), each [..., Z], for chunked streaming; None = zeros.
    """
    derivative_factor = C.SAMPLING_RATE / step_size
    loud = unsmeared_excitation ** 0.3
    if state is None:
        prev0 = jnp.zeros_like(loud[..., 0])
        fd0 = fl0 = None
    else:
        prev0, fd0, fl0 = state
    prev = jnp.concatenate([prev0[..., None], loud[..., :-1]], axis=-1)
    deriv = derivative_factor * jnp.abs(loud - prev)
    # one banded recurrence call for both smoothers (leading stack axis)
    y0 = None if fd0 is None else jnp.stack([fd0, fl0])
    filt = iir.linear_recurrence_banded(
        a, (1.0 - a[:, None]) * jnp.stack([deriv, loud]), axis=-1, y0=y0)
    filt_deriv, filt_loud = filt[0], filt[1]
    mod = filt_deriv / (1.0 + filt_loud / 0.3)
    new_state = (loud[..., -1], filt_deriv[..., -1], filt_loud[..., -1])
    return mod, filt_loud, new_state
