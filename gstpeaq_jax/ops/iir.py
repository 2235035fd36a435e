"""First-order linear recurrences as parallel (log-depth) scans.

Every stateful stage in PEAQ — time-domain smearing (src/fftearmodel.c:496-504),
forward masking (src/fbearmodel.c:388-395), level adaptation smoothers
(src/leveladapter.c:262-332), modulation smoothers (src/modpatt.c:233-250),
the slope filter (src/fbearmodel.c:336-338) and the MFPD max filter
(src/movaccum.c:415-422) — is a recurrence y_t = a_t * y_{t-1} + b_t.
They are evaluated as parallel scans instead of a serial loop over
hundreds/thousands of frames: jax.lax.associative_scan (Blelloch, ~log2(T)
vectorized steps) for short axes, and blocked Toeplitz-GEMM forms
(linear_recurrence_blocked / _banded) for long ones.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def linear_recurrence(a: jnp.ndarray, b: jnp.ndarray, axis: int = 0,
                      y0=None) -> jnp.ndarray:
    """Solve y_t = a_t * y_{t-1} + b_t along `axis` with y_{-1} = y0 (or 0).

    `a` is broadcast against `b` (e.g. constant per-band coefficients against
    per-frame inputs). Returns y with the same shape as b.
    """
    a = jnp.broadcast_to(a, b.shape)
    aa, bb = jax.lax.associative_scan(_combine, (a, b), axis=axis)
    if y0 is not None:
        bb = bb + aa * jnp.expand_dims(y0, axis)
    return bb


def running_max(x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Cumulative maximum along `axis` (associative, log-depth)."""
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


def linear_recurrence_banded(a: jnp.ndarray, b: jnp.ndarray, axis: int = 0,
                             y0=None, block: int = 128) -> jnp.ndarray:
    """y_t = a_z * y_{t-1} + b_t along `axis`, per-band coefficients.

    a: [Z] matching b's LAST axis; b: [..., Z] with the recurrence along
    `axis`.  Same blocked Toeplitz-GEMM scheme as linear_recurrence_blocked
    but with a per-band [Z, L, L] coefficient tensor (a batched matmul),
    in place of associative_scan's ~2*log2(T) levels of small slice/concat
    ops over long frame axes.

    y0: [..., Z] initial state (b's shape without `axis`).
    """
    dtype = b.dtype
    b2 = jnp.moveaxis(b, axis, -1)              # [..., Z, T]
    shape = b2.shape
    t = shape[-1]
    z = shape[-2]
    pad = (-t) % block
    if pad:
        b2 = jnp.concatenate(
            [b2, jnp.zeros((*shape[:-1], pad), dtype)], axis=-1)
    tt = t + pad
    g = tt // block
    bb = b2.reshape(-1, z, g, block)            # [M, Z, g, L]
    m = bb.shape[0]

    if jnp.issubdtype(dtype, jnp.complexfloating):
        wide = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
    else:
        wide = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    # toep[z, j, l] = a_z^(l-j) for l >= j, via exp(expo * log a) — the
    # PEAQ smoothing coefficients are in (0, 1).
    idx = np.arange(block)
    expo = idx[None, :] - idx[:, None]          # [j, l] -> l - j
    log_a = jnp.log(jnp.asarray(a, wide))[:, None, None]
    toep = (jnp.exp(jnp.asarray(np.maximum(expo, 0), wide) * log_a)
            * jnp.asarray(expo >= 0, wide)).astype(dtype)   # [Z, L, L]
    prefix = jnp.einsum("mzgj,zjl->mzgl", bb, toep,
                        precision=jax.lax.Precision.HIGHEST)

    a_l = jnp.exp(log_a[:, 0, 0] * block).astype(dtype)         # a^L  [Z]
    if y0 is None:
        init = jnp.zeros((m, z), dtype)
    else:
        init = jnp.broadcast_to(jnp.asarray(y0, dtype),
                                (*shape[:-2], z)).reshape(m, z)
    inclusive = linear_recurrence(a_l[:, None], prefix[..., -1], axis=-1,
                                  y0=init)
    entries = jnp.concatenate(
        [init[..., None], inclusive[..., :-1]], axis=-1)    # [M, Z, g]

    pwr = jnp.exp(jnp.asarray(np.arange(1, block + 1), wide)
                  * log_a[:, 0]).astype(dtype)              # a^(1..L) [Z, L]
    y = prefix + entries[..., None] * pwr[:, None, :]
    y = y.reshape(*shape[:-1], tt)
    if pad:
        y = y[..., :t]
    return jnp.moveaxis(y, -1, axis)


def linear_recurrence_blocked(a, b: jnp.ndarray, y0=None,
                              block: int = 128) -> jnp.ndarray:
    """y_t = a * y_{t-1} + b_t along the LAST axis; `a` must be a Python /
    NumPy scalar (trace-time constant).

    Blocked algorithm: associative_scan makes ~2*log2(T) passes
    over the data; for sample-rate recurrences (T ~ 5e5) that is memory-
    bound and slow, and any serial lax.scan pays thousands of tiny
    sequential steps.  Here the axis splits into L-sample blocks:

      1. block-local prefixes as ONE [.., g, L] @ [L, L] GEMM with the
         lower-triangular Toeplitz matrix T[j, l] = a^(l-j)  (the data
         layout keeps L contiguous so there are no transposes);
      2. cross-block entry states by a log-depth associative scan over the
         g block summaries (tiny);
      3. one fused broadcast FMA  y = prefix + a^(l+1) * entry.

    The power tables are built host-side in float64/complex128 (repeated
    low-precision products would lose ~block * eps relative accuracy).
    b: [..., T]; y0: [...] initial state (broadcast over leading axes).
    """
    dtype = b.dtype
    a = complex(a) if np.iscomplexobj(a) else float(a)
    shape = b.shape
    t = shape[-1]
    pad = (-t) % block
    if pad:
        b = jnp.concatenate(
            [b, jnp.zeros((*shape[:-1], pad), dtype)], axis=-1)
    tt = t + pad
    g = tt // block
    bb = b.reshape(-1, g, block)
    n = bb.shape[0]

    pw_np = np.power(a, np.arange(block + 1))          # exact-ish in f64
    idx = np.arange(block)
    expo = idx[None, :] - idx[:, None]                  # [j, l] -> l - j
    toep = jnp.asarray(
        np.where(expo >= 0, pw_np[np.maximum(expo, 0)], 0.0), dtype)
    prefix = jnp.einsum("ngj,jl->ngl", bb, toep,
                        precision=jax.lax.Precision.HIGHEST)

    # cross-block exclusive prefix: entry state of block k is
    # E_k = a^L E_{k-1} + final_{k-1}, E_0 = y0.  For sample-rate inputs g
    # is still thousands of blocks, and associative_scan's ~2*log2(g)
    # slice/pad levels dominate — recurse into the blocked scheme once
    # (g -> g / block) before falling back to the log-depth scan.
    a_l = jnp.asarray(pw_np[block], dtype)
    init = (jnp.zeros((n,), dtype) if y0 is None
            else jnp.asarray(y0, dtype).reshape(-1))
    if g > 2 * block:
        inclusive = linear_recurrence_blocked(pw_np[block], prefix[..., -1],
                                              y0=init, block=block)
    else:
        inclusive = linear_recurrence(a_l, prefix[..., -1], axis=-1, y0=init)
    entries = jnp.concatenate(
        [init[:, None], inclusive[:, :-1]], axis=-1)   # state BEFORE block k

    y = prefix + entries[..., None] * jnp.asarray(pw_np[1:], dtype)
    y = y.reshape(*shape[:-1], tt)
    return y[..., :t] if pad else y
