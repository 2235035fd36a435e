"""Filter-bank ear model (advanced PEAQ).

The reference walks sample by sample through a ring buffer with a per-band
FIR evaluation every 32nd sample (src/fbearmodel.c:275-435) — the hottest
loop in its advanced path.  Here:

* the DC-rejection biquad cascade becomes pole-cascaded blocked
  Toeplitz-GEMM recurrences (no per-sample loop, no ill-conditioned
  partial fractions);
* the 40-band complex FIR bank becomes ONE phase-concatenated stride-1
  convolution over 128-sample blocks ([13, 128, 320] kernel) — an implicit
  GEMM without materialized sliding windows, whose phase-split output
  feeds the spreading directly;
* the band domain runs TRANSPOSED ([40 bands major, instants minor]): the
  level-dependent frequency spreading is a per-instant [40, 40]
  contraction (the Triton kernel ops/pallas_fb on the GPU), the
  slope-filter state a natively instants-last blocked recurrence,
  backward masking two per-frame [6]-contractions, and forward masking a
  banded Toeplitz-GEMM recurrence in its natural [Z, F] layout.

The reference's ring-buffer aliasing quirk (the lag-1456 tap reads the newest
sample, see earparams/numpy_ref) is preserved by folding that coefficient
into lag 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import earparams as EP
from . import iir


@dataclasses.dataclass(frozen=True)
class FBEarConsts:
    h_phase: Any           # [13, 128, 320] phase-concatenated conv kernels
    h_group_kernels: Any   # tuple of [w_g, 128, 8 * |G|] grouped kernels
    conv_precision: Any    # matmul precision of the FIR bank conv
    back_mask: Any         # [11]
    back_mask_w: Any       # [2, 6] frame taps (Wa, Wb); _back_mask_blocks
    internal_noise: Any
    ear_a: Any
    adapt_a: Any
    fc: Any
    lower_matrix: Any      # [40, 40] CL^(j-k) for j >= k (row j -> col k)
    level_factor: Any
    threshold: Any
    excitation_threshold: Any
    loudness_factor: Any
    band_count: int
    swap_slope: bool = False  # settings.h:97 SWAP_SLOPE_FILTER_COEFFICIENTS
    group_blocks: tuple = ()  # per group: (first, one-past-last) 128-block


# Band groups for the window-length-split conv (see filter_bank_t): Table-8
# filter lengths fall 1456 -> 52 across the 40 bands, and each band's taps
# sit CENTERED in the 1456-lag window (delay D = 1 + (1456 - N) / 2,
# src/fbearmodel.c:408), so high-band channel groups touch only the middle
# input blocks.  Groups of 16 bands give 128 output channels per group
# (8 channels/band: 4 phases x re/im).
_CONV_GROUPS = ((0, 16), (16, 32), (32, 40))

# Leading zeros folded into the conv kernels so the DATA never needs a
# shifting pad: the conv history is carried as 1536 = 12 aligned
# 128-blocks (1455 real samples + 81 never-read zeros, since the kernels
# are zero below offset 81), so no pass over the sample stream realigns
# it.
_KERNEL_OFF = 81
_HIST_LEN = 1455 + _KERNEL_OFF          # 1536 = 12 * 128

_FB_LEAF_FIELDS = (
    "h_phase", "h_group_kernels", "back_mask", "back_mask_w",
    "internal_noise", "ear_a", "adapt_a", "fc",
    "lower_matrix", "level_factor", "threshold", "excitation_threshold",
    "loudness_factor")


def _fb_consts_flatten(k):
    return (tuple(getattr(k, f) for f in _FB_LEAF_FIELDS),
            (k.band_count, k.swap_slope, k.conv_precision, k.group_blocks))


def _fb_consts_unflatten(aux, children):
    kwargs = dict(zip(_FB_LEAF_FIELDS, children))
    return FBEarConsts(band_count=aux[0], swap_slope=aux[1],
                       conv_precision=aux[2], group_blocks=aux[3], **kwargs)


jax.tree_util.register_pytree_node(
    FBEarConsts, _fb_consts_flatten, _fb_consts_unflatten)


def build_consts(params: EP.FBEarParams, dtype=jnp.float64,
                 spectrum_dtype=None, swap_slope: bool = False,
                 accurate: bool = False) -> FBEarConsts:
    """`dtype` = band-domain type (spreading, masking, 40-band arrays);
    `spectrum_dtype` = sample-domain type (DC filter, FIR bank conv).
    `swap_slope` = SWAP_SLOPE_FILTER_COEFFICIENTS (settings.h:97): swap the
    slope filter's smoothing coefficients vs the BS.1387 pseudo code."""
    spectrum_dtype = spectrum_dtype or dtype
    fs = lambda x: jnp.asarray(x, dtype=spectrum_dtype)
    f = lambda x: jnp.asarray(x, dtype=dtype)
    # fold aliased lag-1456 tap into lag 0, then reverse lags for conv
    h_re = params.h_re[:, :C.FB_BUFFER_LENGTH].copy()
    h_im = params.h_im[:, :C.FB_BUFFER_LENGTH].copy()
    h_re[:, 0] += params.h_re[:, C.FB_BUFFER_LENGTH]
    h_im[:, 0] += params.h_im[:, C.FB_BUFFER_LENGTH]
    h = np.concatenate([h_re, h_im], axis=0)          # [80, 1456] lag order
    h_rev = h[:, ::-1]                                 # conv kernel layout
    # Phase-split conv kernels: out[4t + p] needs kpad shifted by 32p in a
    # 13x128 window (see filter_bank); kpad = [zeros(_KERNEL_OFF) | h_rev].
    # All four phases read IDENTICAL input windows, so they concatenate
    # along the output-channel axis into ONE conv: channel 80p + c is
    # (phase p, band c) — the [ti, 4, 80] -> [4t+p] interleave then becomes
    # a single reshape instead of a stack+slice pass.
    off = _KERNEL_OFF
    phases = []
    for p in range(4):
        kp = np.pad(h_rev, ((0, 0), (off + 32 * p, 127 - 32 * p)))
        phases.append(kp.reshape(80, 13, 128).transpose(1, 2, 0))
    h_phase = np.concatenate(phases, axis=-1)          # [13, 128, 320]
    # Window-length-split kernels (filter_bank_t): each band group's taps
    # span a contiguous block subrange; the footprint is derived from the
    # actual nonzero taps so kernel-layout changes can't silently misalign.
    nz_cols = np.abs(h_rev) > 0.0                       # [80, 1456]
    group_kernels = []
    group_blocks = []
    for b0, b1 in _CONV_GROUPS:
        rows = list(range(b0, b1)) + [40 + b for b in range(b0, b1)]
        nz = np.nonzero(nz_cols[rows].any(axis=0))[0]
        lo_blk = (off + nz.min()) // 128                # phase 0 low edge
        hi_blk = (off + 96 + nz.max()) // 128 + 1       # phase 3 high edge
        gph = []
        for p in range(4):
            kp = np.pad(h_rev[rows], ((0, 0), (off + 32 * p, 127 - 32 * p)))
            kp = kp.reshape(len(rows), 13, 128)[:, lo_blk:hi_blk]
            gph.append(kp.transpose(1, 2, 0))
        group_kernels.append(fs(np.concatenate(gph, axis=-1)))
        group_blocks.append((int(lo_blk), int(hi_blk)))
    Z = C.FB_BAND_COUNT
    idx = np.arange(Z)
    expo = idx[:, None] - idx[None, :]                 # [j, k] -> j - k
    lower = np.where(expo >= 0, C.CL ** np.maximum(expo, 0), 0.0)
    return FBEarConsts(
        h_phase=fs(h_phase),
        h_group_kernels=tuple(group_kernels),
        group_blocks=tuple(group_blocks),
        # band-domain f32 = the throughput tier: bf16x3 conv (~1e-5 rel err)
        # is invisible under its band-chain-dominated ODG noise; wider band
        # domains and the accurate tier keep the full-precision conv.
        conv_precision=(jax.lax.Precision.HIGH
                        if jnp.dtype(dtype) == jnp.float32 and not accurate
                        else jax.lax.Precision.HIGHEST),
        back_mask=f(params.back_mask),
        back_mask_w=f(_back_mask_blocks(params.back_mask)),
        internal_noise=f(params.internal_noise),
        ear_a=f(params.ear_time_constants),
        adapt_a=f(params.adapt_time_constants),
        fc=f(params.fc),
        lower_matrix=f(lower),
        level_factor=fs(params.level_factor),
        threshold=f(params.threshold),
        excitation_threshold=f(params.excitation_threshold),
        loudness_factor=f(params.loudness_factor),
        band_count=Z,
        swap_slope=swap_slope,
    )


def _back_mask_blocks(back_mask: np.ndarray) -> np.ndarray:
    """Rearrange the 11-tap backward-masking FIR into two 6-instant frame
    taps: E1[f] = sum_i h[i] e0[6f + 5 - i] (i = 0..10, out-of-range
    indices zero) touches only instants of frames f and f-1, so
    E1[f] = sum_r Wb[r] e0f[f, r] + sum_r Wa[r] e0f[f - 1, r]
    with Wb[r] = h[5 - r] and Wa[r] = h[11 - r] (Wa[0] = 0)."""
    wb = back_mask[5::-1]
    wa = np.concatenate([[0.0], back_mask[10:5:-1]])
    return np.stack([wa, wb])                           # [2, 6]


def _biquad_feedback(a1: float, a2: float, v: jnp.ndarray, state=None,
                     return_state: bool = False):
    """Solve y_t = a1 y_{t-1} + a2 y_{t-2} + v_t along the last axis with
    zero initial state.

    Numerics: the 2x2 companion-form scan cancels catastrophically in f32
    for poles near the unit circle (the DC filter's poles sit at r~0.9988),
    so the recurrence is diagonalized into a complex-conjugate pair of
    first-order recurrences (partial fractions): y = 2 Re(g * u),
    u_t = lambda * u_{t-1} + v_t.  Complex magnitudes multiply cleanly, so
    the associative scan stays accurate to ~eps * log T.

    `state` is a REAL [..., 2] pair (complex exists only inside the jitted
    computation): the streaming state crosses the jit boundary and is
    checkpointed, so it stays real.  Complex branch: state = (Re u_last, Im u_last); real-pole
    branch: state = (w_last, y_last) of the cascade.
    """
    dtype = v.dtype
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    disc2 = a1 * a1 + 4.0 * a2
    if disc2 < 0:
        # complex-conjugate pair: u_m = conj(u_p) for real input, so one
        # complex scan suffices: y = 2 Re(g_p * u_p)
        disc = complex(0.0, np.sqrt(-disc2))
        lam_p = (a1 + disc) / 2.0
        g_p = complex(lam_p / (lam_p - np.conj(lam_p)))
        y0 = None
        if state is not None:
            y0 = (state[..., 0] + 1j * state[..., 1]).astype(cdtype)
        u_p = iir.linear_recurrence_blocked(lam_p, v.astype(cdtype), y0=y0)
        y = 2.0 * jnp.real(jnp.asarray(g_p, cdtype) * u_p).astype(dtype)
        if return_state:
            u_last = u_p[..., -1]
            return y, jnp.stack([jnp.real(u_last).astype(dtype),
                                 jnp.imag(u_last).astype(dtype)], axis=-1)
        return y
    # Real distinct poles: CASCADE of two real scans, w = rec(lam_p, v),
    # y = rec(lam_m, w).  The partial-fraction form y = g_p u_p + g_m u_m
    # has |g| ~ 369 for the DC filter's near-degenerate poles, which
    # amplifies the f32 state quantization ~370x (1.25e-4 vs 4.2e-5
    # relative DC-output error); the cascade has no large gains.
    # (The complex branch above is already well-conditioned: 2 Re(g u)
    # reduces to Re u + (Re lam / Im lam) Im u with |Im u| ~ Im lam.)
    # float() the np scalars: a strong-typed np.float64 would silently
    # promote f32 inputs to f64 under x64.
    disc = float(np.sqrt(disc2))
    lam_p = (a1 + disc) / 2.0
    lam_m = (a1 - disc) / 2.0
    s_p = state[..., 0] if state is not None else None
    s_m = state[..., 1] if state is not None else None
    w = iir.linear_recurrence_blocked(lam_p, v, y0=s_p)
    y = iir.linear_recurrence_blocked(lam_m, w, y0=s_m)
    if return_state:
        return y, jnp.stack([w[..., -1], y[..., -1]], axis=-1)
    return y


def dc_reject(x: jnp.ndarray, state=None, return_state: bool = False):
    """DC-rejection cascade; src/fbearmodel.c:291-303.  x: [..., T].

    The stage structure ff1 -> poles1 -> ff2 -> poles2 is numerically
    LOAD-BEARING: commuting both (1 - z^-1)^2 feedforwards to the front
    (one 5-tap pass, algebraically identical) lets the four near-unit
    pole recurrences compound their ~833x-per-pole DC amplification on
    the feedforward's rounding noise — 2.9e-7 relative error in f64 vs
    the serial reference (the interleaved ff2 kills the DC noise
    poles1 amplified).  Keep the interleaving.

    `state` (streaming) = (x_tail, u1, y1_tail, u2) with x_tail/y1_tail
    the previous two inputs of each stage's feedforward and u1/u2 each
    stage's REAL [..., 2] recurrence carry (see _biquad_feedback — the
    state crosses the jit boundary and stays complex-free).
    """
    def ff(u, tail):
        if tail is None:
            pad = jnp.zeros_like(u[..., :2])
        else:
            pad = tail
        ext = jnp.concatenate([pad, u], -1)
        return u - 2.0 * ext[..., 1:-1] + ext[..., :-2]

    if state is None:
        x_tail = u1 = y1_tail = u2 = None
    else:
        x_tail, u1, y1_tail, u2 = state
    v1 = ff(x, x_tail)
    y1, u1n = _biquad_feedback(C.HP1_A[0], C.HP1_A[1], v1, u1, True)
    v2 = ff(y1, y1_tail)
    y2, u2n = _biquad_feedback(C.HP2_A[0], C.HP2_A[1], v2, u2, True)
    if return_state:
        return y2, (x[..., -2:], u1n, y1[..., -2:], u2n)
    return y2


def filter_bank(k: FBEarConsts, hp2: jnp.ndarray, history=None,
                interleave: bool = True):
    """Strided complex FIR bank; src/fbearmodel.c:398-435.

    hp2: [..., T] DC-filtered signal (T divisible by 32).  Output evaluated
    at every 32nd sample: fb(t)[band] = sum_lag h[band, lag] x[t-lag],
    lag in [0, 1455].  `history`: [..., _HIST_LEN=1536] previous samples
    (streaming; the leading 81 are never read — see _KERNEL_OFF); zeros
    when None.  Returns (re, im): [..., I, 40] with I = T / 32.

    Implementation: with z[j] = x[j - 1536] and kpad[:, s] = h[1536 - s]
    (zero outside lag [0, 1455]), out[i] = sum_s kpad[:, s] z[32i + s] — an
    aligned stride-32 correlation.  It is evaluated PHASE-SPLIT: for
    i = 4t + p, 32i = 128t + 32p, so reshaping z into 128-sample blocks
    turns each phase p into a stride-1 conv over the block axis with a
    32p-shifted kernel (window 13, 128 features in), instead of a
    32-feature or a natively strided conv.  All four phase
    kernels see identical input windows, so they run as ONE conv with
    4 * 80 output channels (build_consts concatenates them); channel
    80p + c is (phase p, band c), so the de-interleave to instant order
    is a single [ti, 4, 80] -> [4 ti, 80] reshape instead of a
    stack+slice interleave pass.
    """
    dtype = hp2.dtype
    blocks, front, n_inst, ti, lead = _blocks_for_conv(hp2, history)
    n = blocks.shape[0]
    o = jax.lax.conv_general_dilated(
        blocks, k.h_phase, window_strides=(1,), padding=((front, 1),),
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=dtype,
        precision=k.conv_precision)          # [n, ti + 1, 320]
    if not interleave:
        # phase-split form [.., ti, 4, 80] (instant 4t + p at [t, p]) for
        # process_signal's transposed band-major regroup
        return o[:, :ti].reshape(*lead, ti, 4, 80)
    out = o[:, :ti].reshape(n, 4 * ti, 80)
    out = out[:, :n_inst].reshape(*lead, n_inst, 80)
    return out[..., :40], out[..., 40:]


def _blocks_for_conv(hp2: jnp.ndarray, history):
    """Shared front half of the FIR-bank convs: history splice + the
    [n, m, 128] block layout (see filter_bank).  Returns
    (blocks, front_blocks, n_inst, ti, lead) where `front_blocks` is the
    number of leading zero 128-blocks STILL OWED — supplied through the
    convolution's own spatial padding instead of a data pad (which would
    be a copy pass over the sample stream); the 13-block tail window is
    likewise conv padding.

    `history` is the previous _HIST_LEN (1536) samples — 12 aligned
    128-blocks, so the splice never shifts the stream within a block (the
    kernels carry the _KERNEL_OFF leading zeros); zeros (via conv
    padding) when None.  T must be a multiple of 128 (true for every
    host-prepared bucket: FB frame counts are even)."""
    lead = hp2.shape[:-1]
    t = hp2.shape[-1]
    n_inst = t // C.FB_SUBSAMPLING
    ti = -(-n_inst // 4)
    if history is not None:
        base = jnp.concatenate([history, hp2], axis=-1)  # [..., 1536+T]
        front = 0
    else:
        base = hp2
        front = _HIST_LEN // 128                         # 12
    total = base.shape[-1]
    pad = (-total) % 128
    if pad:
        # only reached for ad-hoc (test-sized) inputs: every host-prepared
        # bucket has an even FB frame count, so T is already 128-aligned
        base = jnp.concatenate(
            [base, jnp.zeros((*base.shape[:-1], pad), base.dtype)], axis=-1)
        total += pad
    z = base.reshape(-1, total // 128, 128)
    return z, front, n_inst, ti, lead


def filter_bank_t(k: FBEarConsts, hp2: jnp.ndarray, history=None):
    """Window-length-split FIR bank producing the TRANSPOSED band-major
    layout [..., 40, I] (re, im) the band chain consumes.

    Same phase-split implicit-GEMM scheme as filter_bank, but the 40 bands
    are split into _CONV_GROUPS by tap footprint: Table-8 band lengths
    average ~400 of the padded 1456 taps, so the uniform conv spends ~73%
    of its FLOPs multiplying structural zeros.  Each group's conv reads
    only its [lo, hi) input-block subrange (out[t] = sum_j blocks[t+j]k[j]
    restricted to the nonzero j) — 21 vs 39 128-channel output tiles, a
    1.86x FLOP cut with no band reshuffle: group outputs regroup exactly
    like the uniform conv and concatenate on the major band axis.
    """
    dtype = hp2.dtype
    blocks, front, n_inst, ti, lead = _blocks_for_conv(hp2, history)
    n = blocks.shape[0]
    res, ims = [], []
    for og in _conv_group_outputs(k, blocks, front, ti):
        g2 = og.shape[-1] // 4                 # 2 * |G|
        og = og[:, :ti].reshape(n, ti, 4, g2)
        og = jnp.moveaxis(og, -1, -3).reshape(n, g2, 4 * ti)[..., :n_inst]
        res.append(og[:, :g2 // 2])
        ims.append(og[:, g2 // 2:])
    re = jnp.concatenate(res, axis=-2).reshape(*lead, 40, n_inst)
    im = jnp.concatenate(ims, axis=-2).reshape(*lead, 40, n_inst)
    return re, im


def _conv_group_outputs(k: FBEarConsts, blocks, front: int, ti: int):
    """The three window-split group convs on the raw [n, m0, 128] block
    stream.  Group g's taps live in absolute blocks [lo, hi) of the
    12-front-padded stream; the front zeros are supplied as conv spatial
    padding (negative low padding skips leading history blocks a group
    does not read), so no data pad OR slice pass ever runs — all three
    convs consume the IDENTICAL operand, so XLA materializes the
    conv-friendly {H, N, C} operand layout once instead of per group.
    Yields
    [n, >=ti, 8|G|] arrays whose row t is output instant group t (phases
    on channels)."""
    for (lo, hi), kern in zip(k.group_blocks, k.h_group_kernels):
        shift = lo - front
        yield jax.lax.conv_general_dilated(
            blocks, kern, window_strides=(1,), padding=((-shift, hi - lo),),
            dimension_numbers=("NHC", "HIO", "NHC"),
            preferred_element_type=blocks.dtype,
            precision=k.conv_precision)


def _slope_inputs(k: FBEarConsts, fb_re, fb_im):
    """Slope-filter drive dist_s and smoothing coefficient (decay);
    src/fbearmodel.c:326-339, settings.h:97.  Default (pseudo-code)
    smoother cu' = cu + A (dist_s - cu); with
    SWAP_SLOPE_FILTER_COEFFICIENTS, cu' = dist_s + A (cu - dist_s)."""
    level = 10.0 * jnp.log10(fb_re * fb_re + fb_im * fb_im)
    s = jnp.maximum(4.0, 24.0 + 230.0 / k.fc - 0.2 * level)
    dist_s = C.DIST ** s
    decay = C.SLOPE_FILTER_A if k.swap_slope else 1.0 - C.SLOPE_FILTER_A
    return dist_s, decay


def _spread_core(k: FBEarConsts, fb_re, fb_im, cu):
    """Upper + lower spreading given the smoothed slope state cu; bands on
    the LAST axis, any leading layout.  Returns E0 = |A|^2.

    Upper spreading U[i, j] = cu[i]^(j-i) for j > i (+ identity), applied
    in static destination-band blocks (unrolled; see fft_ear.spread for
    why neither lax.scan nor one big einsum is used).
    """
    Z = k.band_count
    dtype = fb_re.dtype
    # f32: block = full band count — each of re/im is ONE fused
    # mul+exp+reduce reading fb and log_cu once.  Wider dtypes keep small
    # blocks so that XLA never materializes a [.., I, Z, Z] weight
    # tensor.  Keep re/im as SEPARATE sums: stacking them on a leading
    # axis (to share the exp weights) breaks the fusion.
    block = Z if dtype == jnp.float32 else 8
    i_idx = jnp.arange(Z, dtype=dtype)
    log_cu = jnp.log(cu)[..., None]  # [..., Z, 1]
    ups_re, ups_im = [], []
    for jb in range(0, Z, block):
        j = jnp.arange(jb, min(jb + block, Z), dtype=dtype)
        expo = j - i_idx[:, None]                        # [Z, block]
        w = jnp.where(expo > 0, jnp.exp(expo * log_cu), 0.0)
        ups_re.append(jnp.sum(fb_re[..., None] * w, axis=-2))
        ups_im.append(jnp.sum(fb_im[..., None] * w, axis=-2))
    a_re = fb_re + jnp.concatenate(ups_re, axis=-1)
    a_im = fb_im + jnp.concatenate(ups_im, axis=-1)
    # constant lower spreading: final[c] = sum_{j>=c} CL^(j-c) A[j]
    hp = jax.lax.Precision.HIGHEST
    a_re = jnp.einsum("...j,...jc->...c", a_re, k.lower_matrix,
                      precision=hp)
    a_im = jnp.einsum("...j,...jc->...c", a_im, k.lower_matrix,
                      precision=hp)
    return a_re * a_re + a_im * a_im


def spread(k: FBEarConsts, fb_re: jnp.ndarray, fb_im: jnp.ndarray,
           cu_state=None, return_state: bool = False):
    """Level-dependent frequency spreading per subsampled instant;
    src/fbearmodel.c:326-354.  fb_re/fb_im: [..., I, 40], instants axis -2.
    Returns E0 = |A|^2: [..., I, 40] (+ final cu state when requested)."""
    dist_s, decay = _slope_inputs(k, fb_re, fb_im)
    # instants axis is long (1500/s): blocked recurrence over it (move the
    # instants axis last, bands stay a leading axis)
    cu = jnp.moveaxis(iir.linear_recurrence_blocked(
        decay, jnp.moveaxis((1.0 - decay) * dist_s, -2, -1),
        y0=cu_state), -1, -2)
    e0 = _spread_core(k, fb_re, fb_im, cu)
    if return_state:
        return e0, cu[..., -1, :]
    return e0


def use_spread_kernel(dtype, platform: str | None = None) -> bool:
    """Whether spread_t runs the Triton spreading kernel (ops/pallas_fb):
    float32 band domains on the GPU.  Everywhere else (the float64 tier,
    the CPU) spread_t keeps its XLA exp form."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and jnp.dtype(dtype) == jnp.float32


def spread_t(k: FBEarConsts, fb_re: jnp.ndarray, fb_im: jnp.ndarray,
             cu_state=None, return_state: bool = False,
             kernel: bool | None = None, interpret: bool = False):
    """spread() on the TRANSPOSED layout [..., Z, I] (bands major,
    instants minor) — the pipeline's native FB band-domain layout.

    The slope-filter recurrence is natively instants-last here (no
    moveaxis), and the banded forward-masking recurrence downstream wants
    exactly this [Z, T] layout.  The upper + lower spreading runs as the
    Triton kernel ops/pallas_fb.spread_apply where use_spread_kernel()
    says so (`kernel` overrides the choice; `interpret` runs the kernel
    in the Pallas interpreter, for tests on the CPU).
    Returns E0 [..., Z, I] (+ cu state [..., Z] at the last instant).
    """
    level = 10.0 * jnp.log10(fb_re * fb_re + fb_im * fb_im)
    s = jnp.maximum(4.0, 24.0 + 230.0 / k.fc[:, None] - 0.2 * level)
    dist_s = C.DIST ** s
    decay = C.SLOPE_FILTER_A if k.swap_slope else 1.0 - C.SLOPE_FILTER_A
    cu = iir.linear_recurrence_blocked(
        decay, (1.0 - decay) * dist_s, y0=cu_state)      # [.., Z, I]
    dtype = fb_re.dtype
    if kernel is None:
        kernel = use_spread_kernel(dtype)
    if kernel:
        from . import pallas_fb
        e0 = pallas_fb.spread_apply(fb_re, fb_im, cu,
                                    interpret=interpret).astype(dtype)
    else:
        e0 = _spread_t_xla(k, fb_re, fb_im, cu)
    if return_state:
        return e0, cu[..., -1]
    return e0


def _spread_t_xla(k: FBEarConsts, fb_re, fb_im, cu):
    """XLA exp form of the upper + lower spreading on [..., Z, I]."""
    Z = k.band_count
    dtype = fb_re.dtype
    # see _spread_core for the block-size and separate-re/im rationale
    block = Z if dtype == jnp.float32 else 8
    i_idx = np.arange(Z)
    log_cu = jnp.log(cu)[..., :, None, :]                # [.., Z, 1, I]
    ups_re, ups_im = [], []
    for jb in range(0, Z, block):
        j = np.arange(jb, min(jb + block, Z))
        expo = jnp.asarray((j[None, :] - i_idx[:, None])[..., None],
                           dtype)                        # [Z, blk, 1]
        w = jnp.where(expo > 0, jnp.exp(expo * log_cu), 0.0)
        ups_re.append(jnp.sum(fb_re[..., :, None, :] * w, axis=-3))
        ups_im.append(jnp.sum(fb_im[..., :, None, :] * w, axis=-3))
    a_re = fb_re + jnp.concatenate(ups_re, axis=-2)
    a_im = fb_im + jnp.concatenate(ups_im, axis=-2)
    # constant lower spreading contracts the band axis
    hp = jax.lax.Precision.HIGHEST
    a_re = jnp.einsum("...jt,jc->...ct", a_re, k.lower_matrix,
                      precision=hp)
    a_im = jnp.einsum("...jt,jc->...ct", a_im, k.lower_matrix,
                      precision=hp)
    return a_re * a_re + a_im * a_im


def back_and_forward_masking_t(k: FBEarConsts, e0: jnp.ndarray,
                               n_frames: int, state=None,
                               return_state: bool = False):
    """back_and_forward_masking() on the TRANSPOSED layout [..., Z, I]
    (see spread_t): the [6]-contractions reduce the minor axis, the
    one-frame shift is a minor-axis slice, and the banded forward-masking
    recurrence consumes its native [Z, F] layout with no moveaxis.
    `state` = (e0_tail [..., Z, 10], excitation [..., Z]).
    Returns (excitation, unsmeared): [..., Z, F]."""
    if state is None:
        e0_tail, exc0 = None, None
    else:
        e0_tail, exc0 = state
    ipf = C.FB_FRAMESIZE // C.FB_SUBSAMPLING  # 6
    e0f = e0.reshape(*e0.shape[:-1], n_frames, ipf)
    wa, wb = k.back_mask_w[0], k.back_mask_w[1]
    # ONE pass over e0 for both tap sets: two separate reduces would each
    # re-read the full instant-rate array; stacking the weights on a new
    # major axis makes XLA emit a single two-output fusion, and the
    # [..., 0/1] major-dim slices fuse into the consumers.  This form
    # pads nothing.
    w2 = jnp.stack([wb, wa])                            # [2, ipf]
    sab = jnp.sum(e0f[..., None, :, :, :]
                  * w2[:, None, None, :], axis=-1)      # [..., 2, Z, F]
    sb = sab[..., 0, :, :]                              # [..., Z, F]
    sa = sab[..., 1, :, :]
    if e0_tail is None:
        prev = jnp.zeros_like(sa[..., :1])
    else:  # previous chunk's last frame, instants 1..5 (wa[0] = 0)
        prev = jnp.sum(e0_tail[..., -5:] * wa[1:], axis=-1, keepdims=True)
    e1 = sb + jnp.concatenate([prev, sa[..., :-1]], axis=-1)
    unsmeared = e1 + k.internal_noise[:, None]
    # forward masking: banded Toeplitz-GEMM recurrence; the (1 - a)
    # drive broadcasts against the band axis (-2) here
    excitation = iir.linear_recurrence_banded(
        k.ear_a, (1.0 - k.ear_a)[:, None] * unsmeared, axis=-1, y0=exc0)
    if return_state:
        if e0.shape[-1] >= 10:
            tail_new = e0[..., -10:]
        else:
            base = (e0_tail if e0_tail is not None
                    else jnp.zeros((*e0.shape[:-1], 10), e0.dtype))
            tail_new = jnp.concatenate([base, e0], axis=-1)[..., -10:]
        return excitation, unsmeared, (tail_new, excitation[..., -1])
    return excitation, unsmeared


def process_signal(k: FBEarConsts, signal: jnp.ndarray, n_frames: int,
                   state=None, return_state: bool = False,
                   blocked: bool = False, kernel: bool | None = None,
                   interpret: bool = False):
    """Whole-signal / chunked FB ear model.  signal: [..., T] with
    T = 192 * n_frames — or, with `blocked=True`, the BLOCKED layout
    [..., T // 128, 128] that models/advanced.unified_input ships.
    `state` carries (dc_state, hp2_history, cu, masking_state) for
    streaming (flat layout only).  `kernel` / `interpret` pass through
    to spread_t.  Returns (excitation, unsmeared) [..., 40, F] — the
    transposed MOV-tail layout (bands major, frames minor), which is also
    the chain's native internal layout (+ new state when requested)."""
    if state is None:
        dc_state = hp2_hist = cu_state = mask_state = None
    else:
        dc_state, hp2_hist, cu_state, mask_state = state
    bdtype = k.internal_noise.dtype
    if blocked:
        t_sig = signal.shape[-2] * signal.shape[-1]
        lead_sig = signal.shape[:-2]
    else:
        t_sig = signal.shape[-1]
        lead_sig = signal.shape[:-1]
    if k.level_factor.dtype == jnp.float32 and t_sig % 128 == 0:
        # float32: blocked state-space cascade (ops/dc_block) — one
        # f64-exact block-response GEMM + scalar carry scans, reading the
        # [.., T/128, 128] blocks in place.  The flat hp2 reshape below
        # cancels against _blocks_for_conv's re-block.
        from . import dc_block
        if blocked:
            x3 = signal.astype(jnp.float32)
        else:
            x3 = signal.astype(jnp.float32).reshape(
                *lead_sig, t_sig // 128, 128)
        hp2, dc_new = dc_block.dc_chain_blocked(
            x3, k.level_factor, state=dc_state, return_state=True,
            precision=k.conv_precision)
        hp2 = hp2.reshape(*lead_sig, t_sig)
    else:
        if blocked:
            signal = signal.reshape(*lead_sig, t_sig)
        hp2, dc_new = dc_reject(
            signal.astype(k.level_factor.dtype) * k.level_factor,
            dc_state, True)
    # grouped conv into the transposed band-major layout [.., 40, I]
    # (instant 4t + p minor)
    fb_re, fb_im = filter_bank_t(k, hp2, history=hp2_hist)
    e0, cu_new = spread_t(
        k, fb_re.astype(bdtype), fb_im.astype(bdtype), cu_state, True,
        kernel=kernel, interpret=interpret)          # [.., 40, I]
    exc, uns, mask_new = back_and_forward_masking_t(
        k, e0, n_frames, mask_state, True)           # [.., 40, F]
    if return_state:
        hist = (jnp.concatenate([hp2_hist, hp2], -1)[..., -_HIST_LEN:]
                if hp2_hist is not None else
                jnp.concatenate(
                    [jnp.zeros((*hp2.shape[:-1], _HIST_LEN),
                               hp2.dtype), hp2], -1)[..., -_HIST_LEN:])
        return exc, uns, (dc_new, hist, cu_new, mask_new)
    return exc, uns


def loudness(k: FBEarConsts, excitation: jnp.ndarray,
             axis: int = -1) -> jnp.ndarray:
    """Overall loudness; src/earmodel.c:890-907.  Reduces the band axis
    (`axis`; -2 in the transposed [..., Z, F] MOV-tail layout — the
    per-band constants broadcast in place, no transpose)."""
    if axis == -1 or axis == excitation.ndim - 1:
        lf, th, et = k.loudness_factor, k.threshold, k.excitation_threshold
    elif axis == -2 or axis == excitation.ndim - 2:
        lf = k.loudness_factor[:, None]
        th = k.threshold[:, None]
        et = k.excitation_threshold[:, None]
    else:
        raise ValueError("loudness: band axis must be -1 or -2")
    val = lf * ((1.0 - th + th * excitation / et) ** 0.23 - 1.0)
    return jnp.sum(jnp.maximum(val, 0.0), axis=axis) * (24.0 / k.band_count)
