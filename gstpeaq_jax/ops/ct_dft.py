"""Cooley-Tukey GEMM rDFT: the windowed 2048-point real DFT factored as
two GEMM stages instead of one dense [2048, 2050] matrix (an A/B option,
off by default: fft_ear.USE_CT_DFT).

The dense windowed rDFT GEMM (fft_ear.build_consts) is the single largest
compute stage of both pipelines by FLOPs.  Factoring
N = 2048 = N2 * N1 with N2 = 8, N1 = 256 (decimation in time,
n = 256*n2 + n1) cuts the executed MACs per frame from ~4.2M to ~1.1M
while REDUCING rounding error (each output is a
K=256 contraction instead of K=2048: eps*sqrt(256) vs eps*sqrt(2048)):

    X[8*k1 + k2] = sum_n1 W256[n1, k1] * T[k2, n1]
                   * sum_n2 x[256*n2 + n1] * W8[n2, k2]

  stage 1   S[k2, n1]: contract the 8-long n2 axis (trivial FLOPs)
  twiddle   P = S * T (elementwise, fuses into stage 2's operand)
  stage 2   per-k2 K=256 GEMM with the SHARED [256, 128] quarter-DFT
            matrix, re/im packed into one [256, 256] output matrix pair

Real input needs bins k = 0..1023 only (Hermitian symmetry; bin 1024 is
consumed by NO downstream stage -- the grouping support ends at ~18 kHz,
bandwidth scans bins < 1024, EHS reads bins < 512), so stage 2 keeps
k1 < 128 and the output grid is EXACTLY [8, 256] = (k2 rows) x
(128 re | 128 im columns), and the [.., 8, 128] -> [.., 1024] flatten of
the power spectrum is a pure reshape.

Bins therefore come out PERMUTED: grid position q = k2 * 128 + k1 holds
bin 8*k1 + k2 (a bijection on 0..1023).  No consumer ever needs natural
order: they are all either elementwise with per-bin constants (permute
the constants), matmuls over the bin axis (permute the matrix rows), or
index comparisons (use the bin_index vector) -- see fft_ear.build_consts
(use_ct_dft=True) and movs.bandwidth/ehs.

Reference for WHAT is computed: src/fftearmodel.c:432-515 (Hann window +
FFT + level scaling); the factorization itself has no counterpart there.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

N1 = 256          # lane-axis length of the frame view (n = 256*n2 + n1)
N2 = 8            # residue classes: bin k = 8*k1 + k2
K1 = 128          # stage-2 outputs per class (bins 0..1023)
BINS = N2 * K1    # 1024 spectrum bins (Nyquist bin 1024 unused, see above)


class CTMats(NamedTuple):
    """Constant operands of the factored transform (a pytree of arrays)."""

    w0: Any         # [4, 256] Hann window, first frame half  (hop block f)
    w1: Any         # [4, 256] Hann window, second frame half (block f + 1)
    a0_re: Any      # [4, 8] W8[n2, k2] real part, n2 < 4
    a0_im: Any
    a1_re: Any      # [4, 8] W8[n2, k2], n2 >= 4
    a1_im: Any
    t_re: Any       # [8, 256] twiddles T[k2, n1] = exp(-2i pi n1 k2 / 2048)
    t_im: Any
    m_a: Any        # [256, 256] = [W256_re | W256_im]   (k1 < 128)
    m_b: Any        # [256, 256] = [-W256_im | W256_re]


@functools.lru_cache(maxsize=4)
def bin_index() -> np.ndarray:
    """bin_index[q] = spectral bin held at grid position q = k2*128 + k1."""
    k2, k1 = np.divmod(np.arange(BINS), K1)
    return (N2 * k1 + k2).astype(np.int32)


@functools.lru_cache(maxsize=4)
def bin_perm() -> np.ndarray:
    """perm[q] = bin_index[q]; natural-order per-bin constants / matrix rows
    reorder as  c_perm = c[bin_perm()]  (bins >= 1024 have no slot)."""
    return bin_index()


def head_mask(n_bins: int) -> np.ndarray:
    """[512] mask over the EHS head grid (see head_grid): True where the
    held bin is < n_bins.  bin < 512 <=> k1 < 64, so the EHS head is the
    k1 slice [..., :64] of each class row and its own grid position
    q' = k2 * 64 + k1 holds bin 8*k1 + k2."""
    k2, k1 = np.divmod(np.arange(N2 * 64), 64)
    return (N2 * k1 + k2) < n_bins


def head_perm() -> np.ndarray:
    """[512] perm for the EHS head grid: natural-order rows of a matrix
    operating on bins < 512 reorder as m[head_perm()]."""
    k2, k1 = np.divmod(np.arange(N2 * 64), 64)
    return (N2 * k1 + k2).astype(np.int32)


def head_grid(flat: jnp.ndarray) -> jnp.ndarray:
    """Extract the 512 EHS bins (< 512) from a flat permuted bin array
    [..., 1024] as the head-grid layout [..., 512] (see head_mask)."""
    g = flat.reshape(*flat.shape[:-1], N2, K1)
    return g[..., :64].reshape(*flat.shape[:-1], N2 * 64)


def build_mats(hann_window: np.ndarray, dtype) -> CTMats:
    f = lambda x: jnp.asarray(x, dtype=dtype)
    assert hann_window.shape == (C.FFT_FRAMESIZE,)
    w = np.asarray(hann_window, np.float64).reshape(N2, N1)
    n2 = np.arange(N2)
    k2 = np.arange(N2)
    ang8 = -2.0 * np.pi * np.outer(n2, k2) / N2
    a_re, a_im = np.cos(ang8), np.sin(ang8)
    n1 = np.arange(N1)
    angt = -2.0 * np.pi * np.outer(k2, n1) / C.FFT_FRAMESIZE   # [8, 256]
    k1 = np.arange(K1)
    ang2 = -2.0 * np.pi * np.outer(n1, k1) / N1                # [256, 128]
    w2_re, w2_im = np.cos(ang2), np.sin(ang2)
    return CTMats(
        w0=f(w[:4]), w1=f(w[4:]),
        a0_re=f(a_re[:4]), a0_im=f(a_im[:4]),
        a1_re=f(a_re[4:]), a1_im=f(a_im[4:]),
        t_re=f(np.cos(angt)), t_im=f(np.sin(angt)),
        m_a=f(np.concatenate([w2_re, w2_im], axis=1)),
        m_b=f(np.concatenate([-w2_im, w2_re], axis=1)),
    )


def _sum8(x0, x1, a0, a1):
    """sum_n2 a[n2, k2] * x[n2, n1] -> [..., k2, n1], as a broadcast
    multiply-reduce rather than a dot: a dot_general would put the rhs
    free axis (k2) MINOR ([..., n1, k2]) or need a transpose; the reduce
    fuses with the output directly in the [k2, n1] layout and the
    input tile reused across the 8 k2 rows.  8 + 8 MACs per element —
    trivial next to stage 2."""
    return ((x0[..., None, :, :] * a0.T[:, :, None]).sum(-2)
            + (x1[..., None, :, :] * a1.T[:, :, None]).sum(-2))


def _stages(m: CTMats, x0, x1, precision):
    """x0/x1: windowed frame halves [..., F, 4, 256] -> packed spectrum
    [..., F, 8, 256] ([re | im] minor, class k2 major)."""
    s_re = _sum8(x0, x1, m.a0_re, m.a1_re)
    s_im = _sum8(x0, x1, m.a0_im, m.a1_im)
    p_re = s_re * m.t_re - s_im * m.t_im
    p_im = s_re * m.t_im + s_im * m.t_re
    return (jnp.matmul(p_re, m.m_a, precision=precision)
            + jnp.matmul(p_im, m.m_b, precision=precision))


def spec_hop(m: CTMats, blocks: jnp.ndarray, precision) -> jnp.ndarray:
    """Packed permuted spectrum of hop blocks [..., F + 1, 1024]
    (frame f = blocks[f] | blocks[f + 1]) -> [..., F, 8, 256]."""
    h = blocks.reshape(*blocks.shape[:-1], 4, N1)
    return _stages(m, h[..., :-1, :, :] * m.w0, h[..., 1:, :, :] * m.w1,
                   precision)


def spec_frames(m: CTMats, frames: jnp.ndarray, precision) -> jnp.ndarray:
    """Packed permuted spectrum of whole frames [..., 2048]
    -> [..., 8, 256]."""
    h = frames.reshape(*frames.shape[:-1], N2, N1)
    return _stages(m, h[..., :4, :] * m.w0, h[..., 4:, :] * m.w1, precision)


def power_flat(x: jnp.ndarray) -> jnp.ndarray:
    """|X|^2 of a packed spectrum [..., 8, 256] as the flat permuted bin
    layout [..., 1024] (a tile-exact reshape)."""
    p = x[..., :K1] ** 2 + x[..., K1:] ** 2
    return p.reshape(*x.shape[:-2], BINS)


def cross_flat(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """re(A * conj(B)) of packed spectra [..., 8, 256] -> flat [..., 1024]
    (the NMR delta path's  D_re * S_re + D_im * S_im)."""
    p = (a[..., :K1] * b[..., :K1] + a[..., K1:] * b[..., K1:])
    return p.reshape(*a.shape[:-2], BINS)
