"""The plain JAX stages that run on every backend, against serial NumPy.

These are the forms the GPU runs where no hand-written kernel is kept: the
banded Toeplitz-GEMM recurrences (level adapter, modulation, forward
masking, time smearing), the FFT ear's frequency spreading, and the
float64 tier's FFT spectra.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gstpeaq_jax import earparams as EP
from gstpeaq_jax.ops import fft_ear as FE
from gstpeaq_jax.ops import iir
from gstpeaq_jax.utils import numpy_ref as R


@pytest.mark.parametrize("m, z, f, with_y0", [
    (6, 40, 2560, False),     # FB frame-rate arrays (several 128-blocks)
    (4, 55, 512, True),       # advanced FFT band count, carried state
    (2, 40, 60, False),       # shorter than one block (padding path)
])
def test_linear_recurrence_banded_matches_serial(m, z, f, with_y0):
    rng = np.random.default_rng(11)
    a = np.exp(-rng.uniform(0.01, 3.0, z))
    b = rng.standard_normal((m, z, f))
    y0 = rng.standard_normal((m, z)) if with_y0 else None
    want = np.empty_like(b)
    prev = np.zeros((m, z)) if y0 is None else y0
    for t in range(f):
        prev = a * prev + b[..., t]
        want[..., t] = prev
    got = iir.linear_recurrence_banded(
        jnp.asarray(a), jnp.asarray(b), axis=-1,
        y0=None if y0 is None else jnp.asarray(y0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-12)
    # float32: the drive scale sets the error
    got32 = iir.linear_recurrence_banded(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), axis=-1,
        y0=None if y0 is None else jnp.asarray(y0, jnp.float32))
    assert np.abs(np.asarray(got32) - want).max() < 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("bands", [109, 55])
def test_fft_spread_matches_numpy_ref(bands):
    p = EP.fft_ear_params(bands)
    k = FE.build_consts(p, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    pp = rng.uniform(1e-6, 1e4, (7, bands))
    got = np.asarray(FE.spread(k, jnp.asarray(pp)))
    want = np.stack([R.fft_ear_spread(p, row) for row in pp])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_float64_spectra_use_fft_on_any_platform(monkeypatch):
    """The float64 tier computes spectra with jnp.fft whatever the
    backend (the GPU has double-precision FFTs); only float32 spectra
    take the DFT-GEMM."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    p = EP.fft_ear_params(109)
    k64 = FE.build_consts(p, dtype=jnp.float64)
    k32 = FE.build_consts(p, dtype=jnp.float32)
    assert k64.dft_matrix is None and k64.ehs_fwd is None
    assert k32.dft_matrix is not None
    x = np.random.default_rng(2).standard_normal((3, 2048))
    np.testing.assert_allclose(np.asarray(FE.rfft_flat(jnp.asarray(x))),
                               np.fft.rfft(x), rtol=1e-12, atol=1e-9)
