"""Cooley-Tukey factored-GEMM spectrum path vs the dense rDFT GEMM.

The CT path (ops/ct_dft) produces bins in a permuted grid order and relies
on every consumer absorbing the permutation into constants; these tests pin
the permutation bookkeeping and the end-to-end MOV/ODG equivalence in f64,
where both paths agree to ~1e-12 relative (different summation orders).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gstpeaq_jax import constants as C
from gstpeaq_jax import earparams as EP
from gstpeaq_jax.models import advanced, basic, movs as MOVS
from gstpeaq_jax.ops import ct_dft as CT
from gstpeaq_jax.ops import fft_ear as FE
from gstpeaq_jax.utils import testsignals as TS


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want) / (np.abs(want) + 1e-300))


def _consts_pair(band_count=C.BASIC_BAND_COUNT):
    p = EP.fft_ear_params(band_count)
    dense = FE.build_consts(p, use_dft_gemm=True, use_ct_dft=False)
    ct = FE.build_consts(p, use_ct_dft=True)
    return dense, ct


def test_bin_permutation_is_a_bijection():
    idx = CT.bin_index()
    assert sorted(idx.tolist()) == list(range(1024))
    hp = CT.head_perm()
    assert sorted(hp.tolist()) == list(range(512))


def test_spectrum_matches_dense():
    dense, ct = _consts_pair()
    rng = np.random.default_rng(5)
    blocks = jnp.asarray(rng.standard_normal((2, 7, 1024)) * 0.3)
    out_d = FE.stateless_pair_hop(dense, blocks, 0.9 * blocks)
    out_c = FE.stateless_pair_hop(ct, blocks, 0.9 * blocks)
    perm = CT.bin_perm()
    # power: permuted 1024 grid vs natural 1025 (Nyquist unused)
    assert rel_err(np.asarray(out_c[0]),
                   np.asarray(out_d[0])[..., perm]) < 1e-11
    # band-domain outputs are identical up to summation order
    assert rel_err(out_c[1], out_d[1]) < 1e-11          # unsmeared exc
    np.testing.assert_array_equal(np.asarray(out_c[2]), np.asarray(out_d[2]))
    # delta path: dense is truncated at the grouping support
    hi = dense.group_bin_hi
    d_c = np.asarray(out_c[3])[..., np.argsort(perm)][..., :hi]
    assert rel_err(d_c, np.asarray(out_d[3])) < 1e-11


def test_whole_frame_spectrum_matches_dense():
    dense, ct = _consts_pair()
    rng = np.random.default_rng(6)
    frames = jnp.asarray(rng.standard_normal((3, 2048)) * 0.5)
    p_d = FE.stateless(dense, frames)[0]
    p_c = FE.stateless(ct, frames)[0]
    assert rel_err(np.asarray(p_c), np.asarray(p_d)[..., CT.bin_perm()]) < 1e-11


def test_bandwidth_matches_dense():
    rng = np.random.default_rng(7)
    perm = CT.bin_perm()
    rp = rng.standard_normal((6, 1025)) ** 2 * np.logspace(0, -8, 1025)
    tp = rp * (0.3 + 0.1 * rng.standard_normal((6, 1025)) ** 2)
    want = MOVS.bandwidth(jnp.asarray(rp), jnp.asarray(tp))
    got = MOVS.bandwidth(jnp.asarray(rp[:, perm]), jnp.asarray(tp[:, perm]),
                         bin_idx=jnp.asarray(CT.bin_index()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _pipeline_pair(make, *args):
    pipe, consts = make(*args)
    return pipe, consts


def test_basic_pipeline_ct_equals_dense():
    n = 30 * 1024
    rng = np.random.default_rng(9)
    # harmonic-rich ref (to ~15 kHz) vs lowpassed test: keeps the
    # Bandwidth* MOVs valid so the bin-index max path is exercised
    t = np.arange(n) / 48000.0
    ref = np.zeros(n)
    test = np.zeros(n)
    f0, k = 331.0, 1
    while k * f0 < 15000.0:
        tone = np.sin(2 * np.pi * k * f0 * t + 0.7 * k) / k
        ref += tone
        if k * f0 < 9000.0:
            test += tone
        k += 1
    ref = (0.5 * ref).astype(np.float32)
    test = (0.5 * test + 1e-4 * rng.standard_normal(n)).astype(np.float32)
    from gstpeaq_jax.ops import framing
    n_frames = framing.num_frames(n, n, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    sig = framing.pad_signal(ref[:, None], n_frames, C.FFT_FRAMESIZE,
                             C.FFT_STEPSIZE).T
    tsig = framing.pad_signal(test[:, None], n_frames, C.FFT_FRAMESIZE,
                              C.FFT_STEPSIZE).T

    pipe, consts = basic.make_pipeline()
    k_dense = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT),
                              use_dft_gemm=True, use_ct_dft=False)
    k_ct = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT),
                           use_ct_dft=True)
    out_d = pipe((k_dense, consts[1]), jnp.asarray(sig), jnp.asarray(tsig))
    out_c = pipe((k_ct, consts[1]), jnp.asarray(sig), jnp.asarray(tsig))
    movs_d = np.asarray(out_d.movs)
    movs_c = np.asarray(out_c.movs)
    # the synthetic item leaves Bandwidth* invalid (NaN) in BOTH paths
    assert np.array_equal(np.isnan(movs_c), np.isnan(movs_d))
    ok = ~np.isnan(movs_d)
    assert rel_err(movs_c[ok], movs_d[ok]) < 1e-9, (movs_c, movs_d)
    assert abs(float(out_c.odg) - float(out_d.odg)) < 1e-9


def test_advanced_pipeline_ct_equals_dense():
    n = 64 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    from gstpeaq_jax import api

    want = api.peaq(sa, tr, advanced=True, dtype="float64")

    pipe, consts = advanced.make_pipeline()
    kf_ct = FE.build_consts(
        EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT),
        truncate_spectrum=True, use_ct_dft=True)
    from gstpeaq_jax.ops import framing
    n_fft = framing.num_frames(n, n, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    n_fb = framing.num_frames(n, n, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    ref2 = np.stack([sa, sa], 0)
    t_fft = framing.padded_length(n_fft, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    pad = lambda s, t: np.pad(np.stack([s, s], 0), ((0, 0), (0, t - n)))
    out = pipe((kf_ct, consts[1], consts[2]),
               jnp.asarray(pad(sa, t_fft)), jnp.asarray(pad(tr, t_fft)),
               jnp.asarray(np.stack([pad(sa, n_fb * C.FB_FRAMESIZE),
                                     pad(tr, n_fb * C.FB_FRAMESIZE)])))
    got = {name: float(v)
           for name, v in zip(C.MOV_ADVANCED_NAMES, np.asarray(out.movs))}
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], got[name]
        assert abs(g - w) <= 1e-9 * (1 + abs(w)), (name, g, w)
    assert abs(float(out.odg) - want.odg) < 1e-9
