"""FFT-based ear model.

The reference processes one frame at a time inside a GStreamer chain
(src/fftearmodel.c:432-515). Here the whole stateless part — Hann window,
real FFT, playback-level scaling, outer/middle-ear weighting, critical-band
grouping (a dense [1025, Z] matmul), internal noise, frequency
spreading — runs batched over an arbitrary number of leading axes (frames,
channels, signals, pairs). The only stateful part, time-domain smearing, is a
first-order recurrence solved with an associative scan over the frame axis.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import earparams as EP
from . import ct_dft as CT
from . import iir


@dataclasses.dataclass(frozen=True)
class FFTEarConsts:
    """Device-resident constants of the FFT ear model (a pytree of arrays)."""

    hann: Any
    dft_matrix: Any        # [2048, 2 * 1025] windowed rDFT matrix, or None
    dft_precision: Any
    ehs_fwd: Any           # [512, 2*257] rDFT for the EHS autocorrelation
    ehs_inv_re: Any        # [257, 256] truncated inverse rDFT (real part)
    ehs_inv_im: Any        # [257, 256] truncated inverse rDFT (imag part)
    ehs_fwd2: Any          # [256, 2*129] final EHS spectrum rDFT
    om_weight: Any
    level_factor: Any
    group_matrix: Any
    internal_noise: Any
    a_uc_log: Any          # log(a_uc), for the spreading matrix exponentials
    a_uc: Any
    g_il: Any
    lower_matrix: Any      # static [Z, Z] lower-spreading weights aLe^(i-j)
    spread_norm: Any
    delta_z: Any
    ear_a: Any             # time-smearing coefficients
    adapt_a: Any
    masking_difference: Any
    threshold: Any
    excitation_threshold: Any
    loudness_factor: Any
    band_count: int
    group_bin_hi: int = C.FFT_FRAMESIZE // 2 + 1  # grouping-support bins
    spec_bins: int = C.FFT_FRAMESIZE // 2 + 1     # spectrum bins computed
    # Cooley-Tukey factored-GEMM spectrum path (ops/ct_dft): bins live in
    # the permuted [k2, k1] grid order; per-bin constants above are then
    # permuted to match, bin_idx maps grid position -> bin number, and
    # ehs_mask/ehs_dmat replace the order-dependent EHS slices/cumsum
    ct_mats: Any = None
    bin_idx: Any = None
    ehs_mask: Any = None
    ehs_dmat: Any = None
    # EHS dead-bin mask (om_weight == 0, i.e. the DC bin): the weighted
    # spectrum is identically zero there so the reference's (rw==0 & tw==0)
    # test zeroes d; the pipelines feed EHS plain POWER (om folded into the
    # grouping rows instead), where those bins are nonzero — mask them
    ehs_zero: Any = None


# Registered as a pytree with the arrays as leaves so the bundle can be
# passed as a jit ARGUMENT: closing over multi-MB constants (the 16 MB DFT
# matrix!) would inline them into the HLO and slow compilation.
_FFT_LEAF_FIELDS = (
    "hann", "dft_matrix", "ehs_fwd", "ehs_inv_re", "ehs_inv_im", "ehs_fwd2",
    "om_weight", "level_factor", "group_matrix",
    "internal_noise", "a_uc_log", "a_uc", "g_il", "lower_matrix",
    "spread_norm", "delta_z", "ear_a", "adapt_a", "masking_difference",
    "threshold", "excitation_threshold", "loudness_factor",
    "ct_mats", "bin_idx", "ehs_mask", "ehs_dmat", "ehs_zero")


def _fft_consts_flatten(k):
    return (tuple(getattr(k, f) for f in _FFT_LEAF_FIELDS),
            (k.dft_precision, k.band_count, k.group_bin_hi, k.spec_bins))


def _fft_consts_unflatten(aux, children):
    kwargs = dict(zip(_FFT_LEAF_FIELDS, children))
    return FFTEarConsts(dft_precision=aux[0], band_count=aux[1],
                        group_bin_hi=aux[2], spec_bins=aux[3], **kwargs)


jax.tree_util.register_pytree_node(
    FFTEarConsts, _fft_consts_flatten, _fft_consts_unflatten)


# Cooley-Tukey rDFT dispatch: OFF for every tier — the `accurate` tier is
# the DENSE rDFT with all front-end GEMMs at HIGHEST.  GSTPEAQ_CT_DFT=1
# forces CT back on (A/B only); unset/0 leaves it off.
USE_CT_DFT = {"1": True, "0": False}.get(
    os.environ.get("GSTPEAQ_CT_DFT", ""), None)


def build_consts(params: EP.FFTEarParams, dtype=jnp.float64,
                 use_dft_gemm: bool | None = None,
                 spectrum_dtype=None,
                 truncate_spectrum: bool = False,
                 use_ct_dft: bool | None = None,
                 accurate: bool = False) -> FFTEarConsts:
    """`dtype` is the band-domain compute type (Z-length arrays: spreading,
    smearing, adaptation, modulation, MOVs); `spectrum_dtype` the bin-domain
    type (frames, DFT, 1025-bin spectra).  Mixed f64/f32 gives near-f64 MOV
    accuracy at f32 spectrum cost: the modulation derivative amplifies
    frame-independent rounding noise of the *band chain*, while the spectrum
    noise contribution is ~10x smaller.

    `truncate_spectrum`: compute only the grouping-supported bins
    (group_bin_hi, ~18 kHz -> 769 of 1025).  Valid when no consumer reads
    bins above it — the ADVANCED FFT path (NMR needs bins < group_bin_hi,
    EHS bins < 512, energy threshold is time-domain); NOT the basic path
    (bandwidth scans bins up to 1024).  Cuts the rDFT GEMM's N by 25%.

    `use_ct_dft`: replace the dense rDFT GEMM with the two-stage
    Cooley-Tukey factorization (ops/ct_dft: ~4x fewer MACs, ~3x less
    rounding).  Bins then live in the permuted [k2, k1] grid order and
    ALL per-bin constants built here (om_weight, group_matrix rows, EHS
    forward-DFT rows) are permuted to match; spec_bins/group_bin_hi
    become 1024 so the pipelines' bin slices are no-ops, and index-based
    consumers (bandwidth) read bin_idx.  Default None = OFF everywhere;
    GSTPEAQ_CT_DFT=1 re-enables it for A/B."""
    spectrum_dtype = spectrum_dtype or dtype
    fs = lambda x: jnp.asarray(x, dtype=spectrum_dtype)
    f = lambda x: jnp.asarray(x, dtype=dtype)
    Z = params.band_count
    idx = np.arange(Z)
    expo = idx[None, :] - idx[:, None]  # [i, j] -> j - i
    aLe = params.lower_spreading_exponentiated
    lower = np.where(expo <= 0, aLe ** np.maximum(-expo, 0), 0.0)
    # last spectrum bin the critical-band grouping touches (~18 kHz)
    group_bin_hi = int(np.nonzero(
        params.group_matrix.any(axis=1))[0].max() + 1)
    spec_bins = group_bin_hi if truncate_spectrum else C.FFT_FRAMESIZE // 2 + 1
    # float32 spectra: windowed rDFT as one [N, 2048] @ [2048, 2050] GEMM
    # (the Hann window folded into the DFT matrix removes a pass over the
    # frames).  float64 spectra: jnp.fft on every backend, so the float64
    # tier runs the same code as the CPU spec tier.  (Choosing between
    # the FFT and the DFT-GEMM for float32 is ROADMAP S3.)
    if use_dft_gemm is None:
        use_dft_gemm = jnp.dtype(spectrum_dtype) == jnp.float32
    if use_ct_dft is None:
        use_ct_dft = use_dft_gemm and bool(USE_CT_DFT)
    om_weight = params.outer_middle_ear_weight
    # the outer/middle-ear weight is FOLDED into the grouping rows: the
    # weighted spectrum (power * om) then never materializes — grouping and
    # NMR contract (om * G) against plain POWER quantities, and EHS's
    # log-ratios/masks are om-invariant (om > 0 cancels in wt/wr and
    # dl/wr), which saves a pass over the bin-domain arrays.
    group_matrix = params.group_matrix * om_weight[:, None]
    dft = None
    ct_mats = bin_idx = ehs_mask = ehs_dmat = None
    zero_nat = om_weight[:2 * C.MAXLAG] == 0.0
    ehs_zero = jnp.asarray(zero_nat)
    if use_ct_dft:
        ct_mats = CT.build_mats(params.hann_window, spectrum_dtype)
        bin_idx = jnp.asarray(CT.bin_index(), jnp.int32)
        perm = CT.bin_perm()
        om_weight = om_weight[perm]
        group_matrix = group_matrix[perm]
        # permuted order makes every bin "grouping-supported" (zero matrix
        # rows handle the real support); slices at group_bin_hi are no-ops
        spec_bins = group_bin_hi = CT.BINS
    elif use_dft_gemm:
        n = C.FFT_FRAMESIZE
        kk = np.arange(spec_bins)
        nn = np.arange(n)
        ang = -2.0 * np.pi * np.outer(nn, kk) / n
        win = params.hann_window[:, None]
        dft = fs(np.concatenate([np.cos(ang) * win, np.sin(ang) * win], 1))
    # EHS autocorrelation DFT-GEMM matrices (float32 spectra).
    # Independent of the MAIN spectrum path: the "mixed" (FFT) tier
    # keeps these — the EHS transforms at HIGHEST are accuracy-neutral
    # (EHS error is set by the d log-difference, not its DFTs).  The CT
    # path REQUIRES them (the log-difference sequence d inherits the
    # permuted bin order; only row-permutable matrix transforms may
    # consume it, never an FFT), with rows permuted to the EHS head grid
    # and the order-dependent sliding-window cumsum replaced by the
    # banded ehs_dmat matmul (movs.ehs).
    ehs_fwd = ehs_inv_re = ehs_inv_im = ehs_fwd2 = None
    if jnp.dtype(spectrum_dtype) == jnp.float32 or use_ct_dft:
        n = 2 * C.MAXLAG                       # 512
        kk = np.arange(n // 2 + 1)
        ang = -2.0 * np.pi * np.outer(np.arange(n), kk) / n
        fwd = np.concatenate([np.cos(ang), np.sin(ang)], 1)
        wk = np.where((kk == 0) | (kk == n // 2), 1.0, 2.0) / n
        ehs_inv_re = fs((np.cos(ang) * wk).T[:, :C.MAXLAG])
        ehs_inv_im = fs((np.sin(ang) * wk).T[:, :C.MAXLAG])
        m = C.MAXLAG                           # 256
        kk2 = np.arange(m // 2 + 1)
        ang2 = -2.0 * np.pi * np.outer(np.arange(m), kk2) / m
        ehs_fwd2 = fs(np.concatenate([np.cos(ang2), np.sin(ang2)], 1))
        if use_ct_dft:
            hperm = CT.head_perm()
            fwd = fwd[hperm]
            ehs_mask = jnp.asarray(CT.head_mask(C.MAXLAG))
            ehs_zero = jnp.asarray(zero_nat[hperm])
            # dk[i] = d0 + sum_{j<i} (dsq[m+j] - dsq[j])  as a banded
            # matmul over the (permuted) bin axis: D[b, i] = +1 for
            # m <= b < m + i, -1 for b < i (column 0 is zero)
            bb = np.arange(n)[:, None]
            ii = np.arange(m)[None, :]
            dmat = ((bb >= m) & (bb < m + ii)).astype(np.float64)
            dmat -= (bb < ii)
            ehs_dmat = fs(dmat[hperm])
        ehs_fwd = fs(fwd)
    # band-domain f32 = the throughput tier: the spectrum GEMM runs at
    # Precision.HIGH (TF32 on the GPU).  Wider band domains — and the
    # accurate tier — keep the full-precision GEMM.
    precision = (jax.lax.Precision.HIGH
                 if jnp.dtype(dtype) == jnp.float32 and not accurate
                 else jax.lax.Precision.HIGHEST)
    return FFTEarConsts(
        hann=fs(params.hann_window),
        dft_matrix=dft,
        dft_precision=precision,
        ehs_fwd=ehs_fwd,
        ehs_inv_re=ehs_inv_re,
        ehs_inv_im=ehs_inv_im,
        ehs_fwd2=ehs_fwd2,
        om_weight=fs(om_weight[:spec_bins]),
        level_factor=fs(params.level_factor),
        group_matrix=fs(group_matrix[:spec_bins]),
        internal_noise=f(params.internal_noise),
        a_uc_log=f(np.log(params.a_uc)),
        a_uc=f(params.a_uc),
        g_il=f(params.g_il),
        lower_matrix=f(lower),
        spread_norm=f(params.spreading_normalization),
        delta_z=f(params.delta_z),
        ear_a=f(params.ear_time_constants),
        adapt_a=f(params.adapt_time_constants),
        masking_difference=f(params.masking_difference),
        threshold=f(params.threshold),
        excitation_threshold=f(params.excitation_threshold),
        loudness_factor=f(params.loudness_factor),
        band_count=Z,
        group_bin_hi=group_bin_hi,
        spec_bins=spec_bins,
        ct_mats=ct_mats,
        bin_idx=bin_idx,
        ehs_mask=ehs_mask,
        ehs_dmat=ehs_dmat,
        ehs_zero=ehs_zero,
    )


def rfft_flat(x: jnp.ndarray) -> jnp.ndarray:
    """rfft over the last axis with leading dims flattened to one batch dim
    (one 2-d batched transform; the flatten/unflatten is free)."""
    shape = x.shape
    out = jnp.fft.rfft(x.reshape(-1, shape[-1]))
    return out.reshape(*shape[:-1], shape[-1] // 2 + 1)


def irfft_flat(x: jnp.ndarray) -> jnp.ndarray:
    """irfft over the last axis with leading dims flattened (see rfft_flat)."""
    shape = x.shape
    n = 2 * (shape[-1] - 1)
    out = jnp.fft.irfft(x.reshape(-1, shape[-1]))
    return out.reshape(*shape[:-1], n)


def group_into_bands(k: FFTEarConsts, spectrum: jnp.ndarray) -> jnp.ndarray:
    """Critical-band grouping with the 1e-12 floor;
    src/fftearmodel.c:603-620.  spectrum: the POWER spectrum [..., bins]
    -> [..., Z] (the outer/middle-ear weight is folded into
    k.group_matrix's rows, so the weighted spectrum never materializes)."""
    # explicit precision: a DEFAULT-precision matmul may run in a reduced
    # format (bf16 / TF32), and that quantization of the band powers
    # would dominate the float32 tier's ODG noise
    return jnp.maximum(
        jnp.dot(spectrum, k.group_matrix,
                precision=jax.lax.Precision.HIGHEST), 1e-12)


def spread(k: FFTEarConsts, pitch_power: jnp.ndarray,
           block: int = 16) -> jnp.ndarray:
    """Level-dependent frequency spreading; src/fftearmodel.c:636-676.

    Combined spreading weights
        W[i, j] = aUCEe[i]^(j-i)  for j > i   (level-dependent upper slope)
        W[i, j] = aLe^(i-j)       for j <= i  (constant lower slope)
    applied as E2[j] = sum_i Ene[i] * W[i, j]; out = E2^(1/0.4) / norm.

    The constant lower part is one static [Z, Z] matmul.  The
    level-dependent upper part is evaluated in destination-band blocks under
    a lax.scan so only a [..., Z, block] slab of W is ever materialized
    (the full per-frame [.., Z, Z] tensor would be O(frames * Z^2) memory —
    terabytes for large batches).  pitch_power: [..., Z].
    """
    Z = k.band_count
    dz = k.delta_z
    dtype = pitch_power.dtype
    a_uce = k.a_uc * pitch_power ** (0.2 * dz)
    n_up = Z - jnp.arange(Z, dtype=dtype)
    g_iu = (1.0 - a_uce ** n_up) / (1.0 - a_uce)
    en = pitch_power / (k.g_il + g_iu - 1.0)
    ene = en ** 0.4
    log_a_ucee = 0.4 * jnp.log(a_uce)  # [..., Z]

    # lower (constant) part, j <= i, includes the diagonal
    e2 = jnp.dot(ene, k.lower_matrix,
                 precision=jax.lax.Precision.HIGHEST)

    # upper (level-dependent) part, j > i, in static blocks of destination
    # bands (an unrolled Python loop: a single [.., Z, Z] einsum would
    # over-allocate)
    i_idx = jnp.arange(Z, dtype=dtype)
    ene_w = ene[..., None]          # [..., Z, 1]
    log_a = log_a_ucee[..., None]   # [..., Z, 1]
    chunks = []
    for jb in range(0, Z, block):
        j = jnp.arange(jb, min(jb + block, Z), dtype=dtype)
        expo = j - i_idx[:, None]                         # [Z, <=block]
        w = jnp.where(expo > 0, jnp.exp(expo * log_a), 0.0)
        chunks.append(jnp.sum(ene_w * w, axis=-2))        # [..., <=block]
    e2 = e2 + jnp.concatenate(chunks, axis=-1)
    # e2^2.5 as e2^2 * sqrt(e2): the generic pow lowers to exp(2.5*log x)
    # (two transcendentals)
    return (e2 * e2) * jnp.sqrt(e2) / k.spread_norm


def stateless(k: FFTEarConsts, frames: jnp.ndarray):
    """Window + FFT + level + ear weight + grouping + noise + spreading.

    frames: [..., 2048] (any leading axes).  Returns
    (power_spectrum, weighted_power_spectrum, unsmeared_excitation,
     energy_threshold_reached).
    """
    sdtype = k.hann.dtype           # spectrum (bin-domain) dtype
    bdtype = k.internal_noise.dtype  # band-domain dtype (may be wider)
    x = frames.astype(sdtype)
    if k.ct_mats is not None:
        xp = CT.spec_frames(k.ct_mats, x, k.dft_precision)
        power = CT.power_flat(xp) * k.level_factor   # permuted bin order
    elif k.dft_matrix is not None:
        bins = k.spec_bins
        spec_ri = jnp.dot(x, k.dft_matrix, precision=k.dft_precision)
        power = (spec_ri[..., :bins] ** 2
                 + spec_ri[..., bins:] ** 2) * k.level_factor
    else:
        windowed = x * k.hann
        spec = rfft_flat(windowed)[..., :k.spec_bins]
        power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) * k.level_factor
    # `weighted` is returned for the spec tests only; the pipelines'
    # grouping/NMR/EHS all consume plain power (om folded into the rows)
    weighted = power * k.om_weight
    band_power = group_into_bands(k, power).astype(bdtype)
    unsmeared = spread(k, band_power + k.internal_noise)
    energy = jnp.sum(x[..., C.FFT_FRAMESIZE // 2:] ** 2, axis=-1)
    threshold_reached = energy >= C.EHS_ENERGY_THRESHOLD
    return power, weighted, unsmeared, threshold_reached


def _spec_ri_hop(k: FFTEarConsts, blocks: jnp.ndarray) -> jnp.ndarray:
    """Windowed rDFT of hop blocks [..., CH, F + 1, 1024] as stacked
    real/imag parts [..., CH, F, 2050]: two half-frame GEMMs
    spec = b0 @ W[:1024] + b1 @ W[1024:] (frame f = blocks[.., f] |
    blocks[.., f+1]); channel-major throughout (see framing.blocks_hop)."""
    hop = C.FFT_STEPSIZE
    if k.dft_matrix is not None and k.spec_bins < C.FFT_FRAMESIZE // 2 + 1:
        # ADVANCED (truncated-spectrum) consts only: flatten the leading
        # batch axes to ONE before the dots, so that XLA's batched-dot
        # lowering keeps the natural contiguous layout instead of
        # reformatting both operands.  The BASIC (full-width) pipeline
        # keeps the sliced two-dot path below.
        lead = blocks.shape[:-2]
        fp1 = blocks.shape[-2]
        x = blocks.reshape(-1, fp1, hop)
        spec = (jnp.dot(x[:, :-1], k.dft_matrix[:hop],
                        precision=k.dft_precision)
                + jnp.dot(x[:, 1:], k.dft_matrix[hop:],
                          precision=k.dft_precision))
        return spec.reshape(*lead, fp1 - 1, spec.shape[-1])
    if k.dft_matrix is not None:
        b0 = blocks[..., :-1, :]
        b1 = blocks[..., 1:, :]
        return (jnp.dot(b0, k.dft_matrix[:hop], precision=k.dft_precision)
                + jnp.dot(b1, k.dft_matrix[hop:], precision=k.dft_precision))
    b0 = blocks[..., :-1, :]
    b1 = blocks[..., 1:, :]
    windowed = jnp.concatenate([b0, b1], axis=-1) * k.hann
    spec = rfft_flat(windowed)[..., :k.spec_bins]
    return jnp.concatenate([jnp.real(spec), jnp.imag(spec)], axis=-1)


def stateless_pair_hop(k: FFTEarConsts, ref_blocks: jnp.ndarray,
                       test_blocks: jnp.ndarray,
                       spread_ref_only: bool = False):
    """stateless() for a ref/test PAIR of hop-sized blocks
    [..., F + 1, CH, 1024] (frame f = blocks[f] | blocks[f+1]) with an
    accurately-cancelled NMR noise difference — at the cost of exactly the
    same two rDFT GEMMs.  The hop-block form means the 2x 50%-overlap
    duplication never materializes (those copies were ~27% of the basic
    device time); _spec_ri_hop contracts the halves with split DFT
    matrices.

    The transform runs on (ref, ref - test) instead of (ref, test): the
    input difference is EXACT in floating point, so the difference
    spectrum D's error scales with |D| (the distortion) instead of |R|
    (the signal), and the test spectrum reconstructs as T = R - D with
    the same noise as computing it directly.  The power difference for
    NMR is then
        pr - pt = level * (Dre * Sre + Dim * Sim),   S = R + T,
    algebraically identical to the (sqrt(pr) - sqrt(pt))^2 form but
    immune to the f32 cancellation that dominated the spectrum-f32
    tiers' ODG drift on near-transparent pairs (~9% relative NMR error).
    Only grouping-supported bins (group_bin_hi, ~18 kHz) are kept.

    The WEIGHTED spectra never materialize: the outer/middle-ear weight
    is folded into k.group_matrix's rows (grouping AND the NMR noise
    contraction), and EHS's log-ratios and zero-masks are om-invariant
    (om > 0 cancels in pt/pr and dp/pr).

    ref/test_blocks: [..., CH, F + 1, 1024] hop blocks (channel-major,
    see framing.blocks_hop).  Returns
    (power, unsmeared, energy_threshold, delta_power) with the first
    three stacked [2(ref,test), ..., CH, F, :] and delta_power
    [..., CH, F, group_bin_hi].
    """
    sdtype = k.hann.dtype
    bdtype = k.internal_noise.dtype
    bins = k.spec_bins
    hi = k.group_bin_hi
    ref = ref_blocks.astype(sdtype)
    test = test_blocks.astype(sdtype)
    if k.ct_mats is not None:
        # factored CT spectra in the packed [.., F, 8, 256] grid; all bin
        # arrays come out flat [.., 1024] in the permuted order (hi ==
        # bins == 1024, so the delta slices below are full-width no-ops)
        both = jnp.stack([ref, ref - test])
        spec = CT.spec_hop(k.ct_mats, both, k.dft_precision)
        r_x, d_x = spec[0], spec[1]
        t_x = r_x - d_x
        power = CT.power_flat(jnp.stack([r_x, t_x])) * k.level_factor
        delta_power = CT.cross_flat(d_x, r_x + t_x) * k.level_factor
    else:
        # ref and delta transform as SEPARATE calls: the stacked form
        # materializes the [2, .., F+1, 1024] pair just to batch two
        # dots; separately, ref feeds its dots directly and the exact
        # subtract fuses into delta's operand copy
        r_ri = _spec_ri_hop(k, ref)
        d_ri = _spec_ri_hop(k, ref - test)
        # ONE fused pass over (r, d): the full-width t/s spectra and the
        # [2, ..] spec stack never hit device memory (materializing them
        # costs ~3 extra spectrum-rate passes).  The elementwise operations and
        # their order are IDENTICAL to the materialized form (t = r - d
        # inline, s = r + t inline), so results are bit-equal.
        r_re, r_im = r_ri[..., :bins], r_ri[..., bins:]
        d_re, d_im = d_ri[..., :bins], d_ri[..., bins:]
        t_re, t_im = r_re - d_re, r_im - d_im
        power = jnp.stack([r_re ** 2 + r_im ** 2,
                           t_re ** 2 + t_im ** 2]) * k.level_factor
        delta_power = (d_re[..., :hi] * (r_re[..., :hi] + t_re[..., :hi])
                       + d_im[..., :hi] * (r_im[..., :hi] + t_im[..., :hi])
                       ) * k.level_factor
    # spread_ref_only: the advanced path consumes ONLY the ref unsmeared
    # excitation (NMR masks against ref; no FFT-path level adapter) — the
    # test signal's grouping + spreading are dead, but they live inside
    # stacked ops XLA will not split, so skip them explicitly.  Returned
    # unsmeared is then [..., CH, F, Z] (no signal axis).
    gp = power[0] if spread_ref_only else power
    band_power = group_into_bands(k, gp).astype(bdtype)
    unsmeared = spread(k, band_power + k.internal_noise)
    energy = jnp.sum(jnp.stack([ref, test])[..., 1:, :] ** 2, axis=-1)
    threshold_reached = energy >= C.EHS_ENERGY_THRESHOLD
    return power, unsmeared, threshold_reached, delta_power


def time_smear(k: FFTEarConsts, unsmeared: jnp.ndarray, axis: int = 0,
               state=None, return_state: bool = False):
    """Time-domain smearing E = max(filtered, unsmeared);
    src/fftearmodel.c:496-504.  The filtered state is a linear recurrence
    solved in log-depth; the max is elementwise.  `state` carries the
    filtered excitation across chunks (streaming).

    Layouts: with axis != -1 the band axis is LAST ([..., F, ..., Z]);
    with axis == -1 the input is the transposed MOV-tail layout
    [..., Z, F] (bands major, frames minor) and the banded
    recurrence runs with no moveaxis."""
    transposed = axis == -1 or axis == unsmeared.ndim - 1
    drive = ((1.0 - k.ear_a)[:, None] * unsmeared if transposed
             else (1.0 - k.ear_a) * unsmeared)
    filtered = iir.linear_recurrence_banded(k.ear_a, drive, axis=axis,
                                            y0=state)
    out = jnp.maximum(filtered, unsmeared)
    if return_state:
        return out, jnp.take(filtered, -1, axis=axis)
    return out


def loudness(k: FFTEarConsts, excitation: jnp.ndarray,
             axis: int = -1) -> jnp.ndarray:
    """Overall loudness per frame; src/earmodel.c:890-907.
    Reduces the band axis (`axis`; -2 in the transposed [..., Z, F]
    MOV-tail layout — the per-band constants broadcast in place, no
    transpose)."""
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
