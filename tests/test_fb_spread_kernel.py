"""The Triton FB spreading kernel (ops/pallas_fb) against the XLA form.

On the CPU the kernel runs in the Pallas interpreter (interpret=True); the
compiled kernel runs only on the GPU (the `gpu`-marked test, run there by
chip_smoke.py's bench and drift phases as well).  The kernel reassociates
the spreading sums (products of cu instead of exp(e log cu), a Horner
lower recurrence instead of a matrix), so agreement is at float32
rounding level.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gstpeaq_jax import earparams as EP
from gstpeaq_jax.ops import fb_ear as FB


@pytest.fixture(scope="module")
def consts():
    return FB.build_consts(EP.fb_ear_params(), dtype=jnp.float32)


def _fb_inputs(n_inst, seed=23):
    rng = np.random.default_rng(seed)
    fb = [jnp.asarray(rng.standard_normal((2, 40, n_inst)) * 0.1,
                      jnp.float32) for _ in range(2)]
    cu0 = jnp.asarray(rng.uniform(0.2, 0.9, (2, 40)), jnp.float32)
    return fb, cu0


@pytest.mark.parametrize("n_inst, carried_cu", [
    (300, True),        # ragged last tile (300 = 2 * 128 + 44), cu state
    (300, False),
    (256, False),       # whole tiles only
])
def test_spread_apply_matches_xla_spread_t(consts, n_inst, carried_cu):
    (fb_re, fb_im), cu0 = _fb_inputs(n_inst)
    cu0 = cu0 if carried_cu else None
    ref, cu_ref = FB.spread_t(consts, fb_re, fb_im, cu0, True, kernel=False)
    got, cu_got = FB.spread_t(consts, fb_re, fb_im, cu0, True, kernel=True,
                              interpret=True)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    ref, got = np.asarray(ref), np.asarray(got)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 1e-4
    np.testing.assert_array_equal(np.asarray(cu_got), np.asarray(cu_ref))


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_process_signal_fused_spread_path(consts, layout):
    """process_signal with the spreading kernel (interpret mode) agrees
    with its XLA spreading, for the flat [.., T] and the blocked
    [.., T/128, 128] signal layouts, including the streaming state."""
    n_frames = 50                       # n_inst = 300: a ragged tile
    t = 192 * n_frames
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, t)) * 0.2).astype(np.float32)
    x[1] *= 0.5
    xj = jnp.asarray(x)
    blocked = layout == "blocked"
    if blocked:
        xj = xj.reshape(2, t // 128, 128)
    exc_ref, uns_ref = FB.process_signal(consts, xj, n_frames,
                                         blocked=blocked, kernel=False)
    exc, uns = FB.process_signal(consts, xj, n_frames, blocked=blocked,
                                 kernel=True, interpret=True)
    for want, got in ((exc_ref, exc), (uns_ref, uns)):
        want, got = np.asarray(want), np.asarray(got)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    if not blocked:
        _, _, st_ref = FB.process_signal(consts, xj, n_frames,
                                         return_state=True, kernel=False)
        _, _, st = FB.process_signal(consts, xj, n_frames,
                                     return_state=True, kernel=True,
                                     interpret=True)
        e0_tail_ref, e0_tail = st_ref[3][0], st[3][0]
        np.testing.assert_allclose(np.asarray(e0_tail),
                                   np.asarray(e0_tail_ref), rtol=1e-4)


@pytest.mark.parametrize("platform, dtype, want", [
    ("gpu", jnp.float32, True),
    ("gpu", jnp.float64, False),     # the float64 tier keeps the XLA form
    ("cpu", jnp.float32, False),     # no compiled Triton kernel on the CPU
    ("rocm", jnp.float32, False),
])
def test_spread_kernel_choice(platform, dtype, want):
    assert FB.use_spread_kernel(dtype, platform) is want


def test_spread_kernel_default_choice_follows_backend(consts, monkeypatch):
    """Without an override spread_t asks use_spread_kernel about the
    running backend: on the CPU the XLA form runs (a compiled Triton
    call would fail to lower here)."""
    (fb_re, fb_im), _ = _fb_inputs(64)
    assert not FB.use_spread_kernel(jnp.float32)
    calls = []
    monkeypatch.setattr(FB, "_spread_t_xla",
                        lambda *a: calls.append(1) or jnp.zeros_like(a[1]))
    FB.spread_t(consts, fb_re, fb_im)
    assert calls == [1]


@pytest.mark.gpu
def test_spread_kernel_compiled_on_gpu(consts):
    """The kernel as compiled for the GPU agrees with the XLA form at the
    advanced pipeline's instant count for 10 s (16128 instants)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel compiles only there")
    (fb_re, fb_im), cu0 = _fb_inputs(16128)
    ref = FB.spread_t(consts, fb_re, fb_im, cu0, kernel=False)
    got = FB.spread_t(consts, fb_re, fb_im, cu0, kernel=True)
    ref, got = np.asarray(ref), np.asarray(got)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
