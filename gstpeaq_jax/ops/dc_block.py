"""Blocked evaluation of the DC-rejection cascade (float32 fast path).

The reference filter (src/fbearmodel.c:291-303) is ff1 -> poles1 (real
near-degenerate pair, cascade form) -> ff2 -> poles2 (complex-conjugate
pair) run serially at sample rate.  The general form (fb_ear.dc_reject)
costs ~10 passes over device memory + 4 Toeplitz-GEMM recurrences +
complex pack/unpack, after a blocked->flat copy of the input.

Here each pole stage is one [128, 128] block-response GEMM against
tables built from the exact serial f64 filter, with the FEEDFORWARD TAPS
FOLDED IN (the ff passes never materialize), reading/writing the blocked
[.., G, 128] layout in place:

  stage 1a: w0  = x  @ Tw   (ff1+pole_p response), + xm/entry rank-1s
  stage 1b: y10 = w  @ Tm   (pole_m Toeplitz),     + entry rank-1
  stage 2:  y20 = y1 @ T2   (ff2+pair REAL y2 response), + tail/u2 rank-1s

Cross-block carries are scalar scans over [M, G] block summaries; the
complex pair's u2 block drive comes from two weighted reduces over
y1 (fused into y1's correction pass), and its output correction uses the
2 Re(g u) rows directly — no complex sample-rate array ever exists.

CONDITIONING (why three GEMMs, not one): collapsing the whole cascade
into a single [128, 128] operator + 7 carried states is algebraically
exact but numerically ill-conditioned — the near-degenerate double pole
gives the block state-transition couplings magnitude ~95 (t*lam^t at
t=128), and the carry algebra then cancels ~1e4-scale terms to O(90)
outputs: 3.7e-3 relative hp2 error vs the XLA chain's 6.3e-4.
Materializing the corrected w and y1 arrays keeps every GEMM's
partial sums at the XLA path's scale, so the staged form matches its
accuracy while still cutting the pass count and FLOPs (3 vs 4 GEMMs, ff
and output maps folded).  Validated against dc_reject in
tests/test_dc_block.py (f64 ~1e-11; f32 at the shared intrinsic
near-unit-pole rounding scale) and the drift corpus.

The carried state uses dc_reject's tuple (x_tail, u1, y1_tail, u2) in
the scaled domain, so the paths interoperate chunk by chunk.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import iir

BLOCK = 128


def _poles():
    a1, a2 = C.HP1_A
    d1 = np.sqrt(a1 * a1 + 4.0 * a2)        # real (near-degenerate) pair
    lam_p = (a1 + d1) / 2.0
    lam_m = (a1 - d1) / 2.0
    b1, b2 = C.HP2_A
    disc = complex(0.0, np.sqrt(-(b1 * b1 + 4.0 * b2)))
    lam2 = (b1 + disc) / 2.0
    g2 = lam2 / (lam2 - np.conj(lam2))
    return lam_p, lam_m, lam2, g2


def _sim_1a(x, xm1, xm2, w, lam_p):
    """Exact serial ff1 + pole_p: returns w[t] trace."""
    out = np.empty_like(x)
    for t in range(len(x)):
        v1 = x[t] - 2.0 * xm1 + xm2
        xm2, xm1 = xm1, x[t]
        w = lam_p * w + v1
        out[t] = w
    return out


def _sim_2(y1, y1m1, y1m2, u2, lam2, g2):
    """Exact serial ff2 + complex pair: returns (y2[t] trace, final u2)."""
    out = np.empty_like(y1)
    for t in range(len(y1)):
        v2 = y1[t] - 2.0 * y1m1 + y1m2
        y1m2, y1m1 = y1m1, y1[t]
        u2 = lam2 * u2 + v2
        out[t] = 2.0 * (g2.real * u2.real - g2.imag * u2.imag)
    return out, u2


@functools.lru_cache(maxsize=None)
def _tables(block: int = BLOCK):
    lam_p, lam_m, lam2, g2 = _poles()
    z = np.zeros(block)
    # stage 1a: ff1 folded into the pole_p response
    tw = np.stack([_sim_1a(np.eye(block)[j], 0.0, 0.0, 0.0, lam_p)
                   for j in range(block)])               # [j, l]
    cx1 = _sim_1a(z, 1.0, 0.0, 0.0, lam_p)               # xm1 = x[-1]
    cx2 = _sim_1a(z, 0.0, 1.0, 0.0, lam_p)               # xm2 = x[-2]
    pw_p = lam_p ** np.arange(1, block + 1)              # entry response
    # stage 1b: plain pole_m Toeplitz
    idx = np.arange(block)
    expo = idx[None, :] - idx[:, None]
    tm = np.where(expo >= 0, lam_m ** np.maximum(expo, 0), 0.0)
    pw_m = lam_m ** np.arange(1, block + 1)
    # stage 2: ff2 + complex pair, REAL output rows + u2 block responses
    t2 = np.empty((block, block))
    bu = np.empty(block, complex)
    for j in range(block):
        t2[j], bu[j] = _sim_2(np.eye(block)[j], 0.0, 0.0, 0j, lam2, g2)
    cy1, au1 = _sim_2(z, 1.0, 0.0, 0j, lam2, g2)
    cy2, au2 = _sim_2(z, 0.0, 1.0, 0j, lam2, g2)
    cur, _ = _sim_2(z, 0.0, 0.0, 1.0 + 0j, lam2, g2)     # init u2 = 1
    cui, _ = _sim_2(z, 0.0, 0.0, 1j, lam2, g2)           # init u2 = i
    return dict(tw=tw, cx1=cx1, cx2=cx2, pw_p=pw_p, a_p=lam_p ** block,
                tm=tm, pw_m=pw_m, a_m=lam_m ** block,
                t2=t2, bu_re=bu.real.copy(), bu_im=bu.imag.copy(),
                cy1=cy1, cy2=cy2, cur=cur, cui=cui,
                au1=complex(au1), au2=complex(au2),
                a_2=complex(lam2 ** block))


def _entries(a_diag, drive: jnp.ndarray, init: jnp.ndarray):
    """Entry (exclusive-prefix) states of s_{k+1} = a s_k + drive_k over
    the last axis.  Blocked evaluation: one tiny Toeplitz GEMM instead
    of the log-depth associative scan's ~12 slice/concat levels over the
    [M, G] summaries."""
    inc = iir.linear_recurrence_blocked(a_diag, drive, y0=init)
    return (jnp.concatenate([init[..., None], inc[..., :-1]], axis=-1),
            inc[..., -1])


def dc_chain_blocked(x3: jnp.ndarray, level: jnp.ndarray, state=None,
                     return_state: bool = False, precision=None):
    """DC cascade of `level * x` on the blocked layout.

    x3: [..., G, 128] raw-signal blocks; `level` scalar (the playback-
    level factor, folded into stage 1a so the scaled signal never
    materializes).  `state`/returned state use dc_reject's tuple
    (x_tail [.., 2], u1 [.., 2], y1_tail [.., 2], u2 [.., 2]) in the
    SCALED domain.  Returns y2 [..., G, 128] (+ state).

    `precision` sets the three table GEMMs' matmul precision (default
    HIGHEST).  The f32 tier passes its front-end conv precision (HIGH):
    the K=128 block-response contractions are as well-conditioned as the
    FIR bank's (the staged form exists exactly so no GEMM cancels
    large terms — module docstring).  The `accurate` tier passes
    HIGHEST.
    """
    dtype = x3.dtype
    lead = x3.shape[:-2]
    g_blocks, block = x3.shape[-2], x3.shape[-1]
    tb = _tables(block)
    hp = precision if precision is not None else jax.lax.Precision.HIGHEST
    f = lambda m: jnp.asarray(m, dtype)
    x = x3.reshape(-1, g_blocks, block)
    m = x.shape[0]

    if state is None:
        zz = jnp.zeros((m,), dtype)
        xm1_0 = xm2_0 = w_0 = y1m1_0 = y1m2_0 = u2r_0 = u2i_0 = zz
    else:
        x_tail, u1, y1_tail, u2s = state
        rs = lambda v: v.reshape(m)
        xm1_0, xm2_0 = rs(x_tail[..., 1]), rs(x_tail[..., 0])
        w_0, y1m1_0 = rs(u1[..., 0]), rs(u1[..., 1])
        y1m2_0 = rs(y1_tail[..., 0])
        u2r_0, u2i_0 = rs(u2s[..., 0]), rs(u2s[..., 1])

    # ---- stage 1a: w (ff1 folded; level folded here, once) ----
    # Per-block summaries come from ONE fused multi-reduce pass per big
    # array (minor-axis slices can each re-read the whole array when XLA
    # duplicates them into consumers; the optimization_barrier pins the
    # small results so the big operand is read once).  The boundary
    # columns are ONE-HOT REDUCES, not slices, which XLA may serve with a
    # full transposed copy; a masked sum fuses into r1's reduce pass and
    # is bit-exact (v + 127 zeros = v).
    w0 = jnp.dot(x, f(tb["tw"]), precision=hp) * level
    r1 = jnp.sum(x * f(tb["tw"][:, -1]), axis=-1) * level  # = w0[.., -1]
    eye1 = np.zeros(block, np.float64); eye1[block - 1] = 1.0
    eye2 = np.zeros(block, np.float64); eye2[block - 2] = 1.0
    xm1c = jnp.sum(x * f(eye1), axis=-1) * level
    xm2c = jnp.sum(x * f(eye2), axis=-1) * level
    r1, xm1c, xm2c = jax.lax.optimization_barrier((r1, xm1c, xm2c))
    xm1_e = jnp.concatenate([xm1_0[:, None], xm1c[:, :-1]], axis=1)
    xm2_e = jnp.concatenate([xm2_0[:, None], xm2c[:, :-1]], axis=1)
    c1l, c2l = float(tb["cx1"][-1]), float(tb["cx2"][-1])
    dw = r1 + c1l * xm1_e + c2l * xm2_e
    w_e, w_fin = _entries(float(tb["a_p"]), dw, w_0)
    w = (w0 + xm1_e[..., None] * f(tb["cx1"]) + xm2_e[..., None] * f(tb["cx2"])
         + w_e[..., None] * f(tb["pw_p"]))

    # ---- stage 1b: y1 (plain pole_m blocked recurrence) ----
    y10 = jnp.dot(w, f(tb["tm"]), precision=hp)
    # NOTE: the drive is y10's last column, recomputed as a reduce over the
    # MATERIALIZED w — expressing it instead as composite x-reduces
    # (tw @ tm[:, -1] columns) re-separates the w-entry coupling into one
    # ~95-scale coefficient and re-opens the single-operator conditioning
    # trap (module docstring).
    ry = jax.lax.optimization_barrier(
        jnp.sum(w * f(tb["tm"][:, -1]), axis=-1))
    y1_e, _ = _entries(float(tb["a_m"]), ry, y1m1_0)
    y1 = y10 + y1_e[..., None] * f(tb["pw_m"])

    # ---- stage 2: y2 (ff2 + complex pair; real output rows) ----
    # u2 block drives + boundary columns: one fused multi-reduce over y1
    fur = jnp.sum(y1 * f(tb["bu_re"]), axis=-1)
    fui = jnp.sum(y1 * f(tb["bu_im"]), axis=-1)
    y1m1c = jnp.sum(y1 * f(eye1), axis=-1)   # = y1[.., -1], fused reduce
    y1m2c = jnp.sum(y1 * f(eye2), axis=-1)
    fur, fui, y1m1c, y1m2c = jax.lax.optimization_barrier(
        (fur, fui, y1m1c, y1m2c))
    y1m1_e = jnp.concatenate([y1m1_0[:, None], y1m1c[:, :-1]], axis=1)
    y1m2_e = jnp.concatenate([y1m2_0[:, None], y1m2c[:, :-1]], axis=1)
    au1, au2 = tb["au1"], tb["au2"]
    dur = fur + float(au1.real) * y1m1_e + float(au2.real) * y1m2_e
    dui = fui + float(au1.imag) * y1m1_e + float(au2.imag) * y1m2_e
    # complex scalar scan over block summaries (complex never crosses jit)
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    u2_inc = iir.linear_recurrence_blocked(
        tb["a_2"], (dur + 1j * dui).astype(cdtype),
        y0=(u2r_0 + 1j * u2i_0).astype(cdtype))
    u2_e = jnp.concatenate(
        [(u2r_0 + 1j * u2i_0).astype(cdtype)[:, None], u2_inc[:, :-1]],
        axis=1)
    ur_e = jnp.real(u2_e).astype(dtype)
    ui_e = jnp.imag(u2_e).astype(dtype)
    y20 = jnp.dot(y1, f(tb["t2"]), precision=hp)
    y2 = (y20 + y1m1_e[..., None] * f(tb["cy1"])
          + y1m2_e[..., None] * f(tb["cy2"])
          + ur_e[..., None] * f(tb["cur"]) + ui_e[..., None] * f(tb["cui"]))
    y2 = y2.reshape(*lead, g_blocks, block)
    if not return_state:
        return y2
    # final states from the carry scans / summary columns — never another
    # slice of the big arrays
    rl = lambda v: v.reshape(*lead)
    new_state = (
        jnp.stack([rl(xm2c[:, -1]), rl(xm1c[:, -1])], axis=-1),
        jnp.stack([rl(w_fin), rl(y1m1c[:, -1])], axis=-1),
        jnp.stack([rl(y1m2c[:, -1]), rl(y1m1c[:, -1])], axis=-1),
        jnp.stack([rl(jnp.real(u2_inc[:, -1]).astype(dtype)),
                   rl(jnp.imag(u2_inc[:, -1]).astype(dtype))], axis=-1))
    return y2, new_state
