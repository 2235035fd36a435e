"""Blocked state-space DC cascade (ops/dc_block) vs the XLA reference
chain (fb_ear.dc_reject).  The block tables are built from the exact
serial f64 filter, so in f64 the two paths agree to ~1e-12 relative; in
f32 both carry the intrinsic near-unit-pole rounding (~6e-4 * max|hp2|)
and agree at the f32-reordering tolerance."""

import numpy as np
import jax
import jax.numpy as jnp

from gstpeaq_jax.ops import dc_block
from gstpeaq_jax.ops import fb_ear as FB


def _mk(n, t, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, t)) * 2500.0).astype(dtype)


def test_dc_block_matches_serial_f64():
    x = _mk(2, 12 * 128, dtype=np.float64)
    lf = 0.0357
    want = np.asarray(FB.dc_reject(jnp.asarray(x) * lf))
    got = np.asarray(dc_block.dc_chain_blocked(
        jnp.asarray(x).reshape(2, -1, 128), lf)).reshape(2, -1)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-11


def test_dc_block_matches_xla_f32():
    t = 49152
    x = _mk(2, t)
    lf = 0.0357
    want = np.asarray(FB.dc_reject(jnp.asarray(x, jnp.float32) * lf))
    got = np.asarray(dc_block.dc_chain_blocked(
        jnp.asarray(x).reshape(2, t // 128, 128), lf)).reshape(2, t)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-3
    assert abs(got.mean()) < 1e-3 * scale


def test_dc_block_streaming_state_interop():
    """Chunked runs with the carried tuple match the whole-signal run,
    and the state interoperates with dc_reject's in BOTH directions."""
    tc = 49152
    x = _mk(2, 2 * tc, seed=13)
    lf = 0.0357
    x3 = jnp.asarray(x).reshape(2, -1, 128)
    whole = np.asarray(dc_block.dc_chain_blocked(x3, lf)).reshape(2, -1)
    h1, st = dc_block.dc_chain_blocked(x3[:, :tc // 128], lf,
                                       return_state=True)
    h2 = dc_block.dc_chain_blocked(x3[:, tc // 128:], lf, state=st)
    got = np.concatenate([np.asarray(h1).reshape(2, -1),
                          np.asarray(h2).reshape(2, -1)], axis=1)
    scale = np.abs(whole).max()
    assert np.abs(got - whole).max() / scale < 2e-3
    # kernel-state -> XLA chain and XLA-state -> kernel both resume
    xs = jnp.asarray(x, jnp.float32) * lf
    _, st_xla = FB.dc_reject(xs[:, :tc], None, True)
    h2x = np.asarray(dc_block.dc_chain_blocked(
        x3[:, tc // 128:], lf, state=st_xla)).reshape(2, -1)
    want2 = np.asarray(FB.dc_reject(xs[:, tc:], st_xla, False))
    assert np.abs(h2x - want2).max() / scale < 2e-3
    want3 = np.asarray(FB.dc_reject(xs[:, tc:], st, False))
    assert np.abs(want3 - want2).max() / scale < 2e-3


def test_dc_block_f64_streaming_state_tight():
    """In f64 the chunked blocked path matches the serial-exact chain to
    ~1e-11 INCLUDING the carried state round trip."""
    tc = 6 * 128
    x = _mk(1, 2 * tc, seed=3, dtype=np.float64)
    lf = 0.0357
    want = np.asarray(FB.dc_reject(jnp.asarray(x) * lf))
    x3 = jnp.asarray(x).reshape(1, -1, 128)
    h1, st = dc_block.dc_chain_blocked(x3[:, :tc // 128], lf,
                                       return_state=True)
    h2 = dc_block.dc_chain_blocked(x3[:, tc // 128:], lf, state=st)
    got = np.concatenate([np.asarray(h1).reshape(1, -1),
                          np.asarray(h2).reshape(1, -1)], axis=1)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-11


def test_process_signal_uses_dc_block_f32():
    """The f32 batch path rides the blocked cascade (blocked AND flat
    inputs) and stays equivalent to a forced-XLA-dc run."""
    from gstpeaq_jax import earparams as EP
    p = EP.fb_ear_params()
    k = FB.build_consts(p, dtype=jnp.float32)
    n_frames = 128
    t = 192 * n_frames
    x = _mk(2, t, seed=5) / 2500.0 * 0.2
    sig = jnp.asarray(x, jnp.float32)
    exc_flat, uns_flat = FB.process_signal(k, sig, n_frames)
    exc_blk, uns_blk = FB.process_signal(
        k, sig.reshape(2, t // 128, 128), n_frames, blocked=True)
    np.testing.assert_allclose(np.asarray(exc_flat), np.asarray(exc_blk),
                               rtol=2e-5, atol=1e-12)
    # force the old XLA dc path for comparison
    lam = k.level_factor
    hp_old = FB.dc_reject(sig.astype(lam.dtype) * lam)
    from gstpeaq_jax.ops import dc_block as DB
    hp_new = DB.dc_chain_blocked(
        sig.reshape(2, t // 128, 128), lam).reshape(2, t)
    rel = (np.abs(np.asarray(hp_new) - np.asarray(hp_old)).max()
           / np.abs(np.asarray(hp_old)).max())
    assert rel < 2e-3
