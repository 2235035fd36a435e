"""Chunked streaming == whole-signal results, exact (long-form config)."""

import numpy as np
import pytest

from gstpeaq_jax import api
from gstpeaq_jax import constants as C
from gstpeaq_jax.parallel.stream import PeaqStream, PeaqStreamAdvanced
from gstpeaq_jax.utils import testsignals as TS


@pytest.mark.slow
def test_stream_equals_whole_signal():
    n = 60 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    want = api.peaq(sa, tr)
    s = PeaqStream(channels=1, chunk_frames=16)
    rng = np.random.default_rng(0)
    pos = 0
    while pos < n:
        step = int(rng.integers(1000, 30000))
        s.feed(sa[pos:pos + step], tr[pos:pos + step])
        pos += step
    res = s.finalize()
    assert abs(res.odg - want.odg) < 1e-10
    for name in C.MOV_BASIC_NAMES:
        w, g = want.movs[name], res.movs[name]
        assert abs(g - w) <= 1e-8 * (1 + abs(w)), (name, g, w)


def test_stream_equals_whole_signal_accurate_ct():
    """The accurate tier's streaming path rides the CT-DFT permuted bin
    order (spectra, bandwidth index maxes, permuted-row EHS) — chunked
    must match whole-signal.  (The plain f32 tier defaults CT off since
    the on-chip A/B; `accurate` is the tier defined by the CT spectra.)
    f32 chunk boundaries reassociate the blocked recurrences, so the
    gate is loose; a bin-permutation bug would be grossly wrong, not
    1e-4."""
    n = 60 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    want = api.peaq(sa, tr, dtype="accurate")
    s = PeaqStream(channels=1, chunk_frames=16, dtype="accurate")
    s.feed(sa, tr)
    res = s.finalize()
    assert abs(res.odg - want.odg) < 2e-4, (res.odg, want.odg)


def test_stream_equals_whole_signal_f32_ct_forced(monkeypatch):
    """GSTPEAQ_CT_DFT=1's force-on path (CT spectra in the plain float32
    tier) stays exercised end to end, streaming vs whole-signal."""
    from gstpeaq_jax.ops import fft_ear
    monkeypatch.setattr(fft_ear, "USE_CT_DFT", True)
    api._jitted_basic.cache_clear()
    try:
        n = 40 * 1024
        sa, tr = TS.saw(n), TS.triangle(n)
        want = api.peaq(sa, tr, dtype="float32")
        s = PeaqStream(channels=1, chunk_frames=16, dtype="float32")
        s.feed(sa, tr)
        res = s.finalize()
        assert abs(res.odg - want.odg) < 2e-4, (res.odg, want.odg)
    finally:
        api._jitted_basic.cache_clear()


@pytest.mark.slow
def test_stream_queryable_mid_stream():
    """ODG is readable at any prefix (the element's live `odg` property,
    src/gstpeaq.c:475-503)."""
    n = 50 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    s = PeaqStream(channels=1, chunk_frames=16)
    s.feed(sa, tr)
    mid = s.current()
    assert np.isfinite(mid.di)
    res = s.finalize()
    assert np.isfinite(res.odg)


@pytest.mark.slow
def test_stream_advanced_equals_whole_signal():
    n = 60 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    want = api.peaq(sa, tr, advanced=True)
    s = PeaqStreamAdvanced(channels=1, chunk_frames=16)
    rng = np.random.default_rng(0)
    pos = 0
    while pos < n:
        step = int(rng.integers(1000, 30000))
        s.feed(sa[pos:pos + step], tr[pos:pos + step])
        pos += step
    res = s.finalize()
    assert abs(res.odg - want.odg) < 1e-10
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], res.movs[name]
        assert abs(g - w) <= 1e-7 * (1 + abs(w)), (name, g, w)


def test_stream_state_is_complex_free():
    """No stream-state leaf may be complex: the state crosses the jit
    boundary every chunk and is checkpointed (utils/checkpoint), so it
    stays a pytree of real arrays (the DC-filter carries are real
    [..., 2] pairs, fb_ear._biquad_feedback)."""
    import jax
    n = 16 * 1024
    for cls in (PeaqStream, PeaqStreamAdvanced):
        s = cls(channels=1, chunk_frames=8)
        s.feed(TS.saw(n), TS.triangle(n))
        for leaf in jax.tree.leaves(s.state):
            assert not np.iscomplexobj(np.asarray(leaf)), cls.__name__


def test_stream_state_checkpoint_roundtrip(tmp_path):
    """The stream state is a savable pytree: checkpoint/resume gives
    identical results."""
    import jax
    n = 50 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    s1 = PeaqStream(channels=1, chunk_frames=8)
    s1.feed(sa[:30 * 1024], tr[:30 * 1024])
    # checkpoint to host numpy and restore into a fresh stream
    snapshot = jax.tree.map(np.asarray, s1.state)
    s2 = PeaqStream(channels=1, chunk_frames=8)
    s2.state = jax.tree.map(lambda x: x, snapshot)
    s2._buf_ref = s1._buf_ref.copy()
    s2._buf_test = s1._buf_test.copy()
    s1.feed(sa[30 * 1024:], tr[30 * 1024:])
    s2.feed(sa[30 * 1024:], tr[30 * 1024:])
    r1, r2 = s1.finalize(), s2.finalize()
    assert r1.odg == r2.odg


def test_stream_tentative_trailing_silence():
    """Trailing silence must not change the committed value (quiet-tail
    suppression, src/movaccum.c:34-41)."""
    n = 40 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    s1 = PeaqStream(channels=1, chunk_frames=8)
    s1.feed(sa, tr)
    s1.feed(np.zeros(16 * 1024, np.float32), np.zeros(16 * 1024, np.float32))
    r1 = s1.finalize()
    want = api.peaq(
        np.concatenate([sa, np.zeros(16 * 1024, np.float32)]),
        np.concatenate([tr, np.zeros(16 * 1024, np.float32)]))
    assert abs(r1.odg - want.odg) < 1e-9


def test_stream_f32_equals_whole_signal():
    """Chunked float32 streaming matches whole-signal processing in the
    same tier (the recurrences' y0 carry across chunk boundaries)."""
    n = 60 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    want = api.peaq(sa, tr, dtype="float32")
    s = PeaqStream(channels=1, chunk_frames=16, dtype="float32")
    s.feed(sa, tr)
    res = s.finalize()
    assert abs(res.odg - want.odg) < 5e-4, (res.odg, want.odg)


def test_stream_pool_equals_scalar_streams():
    """PeaqStreamPool (N lockstep streams, one vmapped program) matches N
    independent PeaqStream runs bit-for-bit on CPU, basic mode."""
    from gstpeaq_jax.parallel.stream import PeaqStreamPool
    n = 40 * 1024
    # refs are all saws: BandwidthRefB only accumulates when the REF has
    # content past ~8.1 kHz (src/movs.c:775-809) — a triangle's 1/k^2
    # harmonics never qualify and the ODG is NaN (reference-faithful)
    sigs = [(TS.saw(n), TS.triangle(n)),
            (TS.saw(n), TS.triangle(n) * 0.9),
            (TS.saw(n), 0.5 * TS.saw(n) + 0.5 * TS.triangle(n))]
    want = []
    for sa, tr in sigs:
        s = PeaqStream(channels=1, chunk_frames=16)
        s.feed(sa, tr)
        want.append(s.finalize())
    pool = PeaqStreamPool(3, channels=1, chunk_frames=16)
    refs = np.stack([sa for sa, _ in sigs])
    tests = np.stack([tr for _, tr in sigs])
    # two lockstep feeds with a ragged boundary
    cut = 17_321
    pool.feed(refs[:, :cut], tests[:, :cut])
    pool.feed(refs[:, cut:], tests[:, cut:])
    got = pool.finalize()
    for i, w in enumerate(want):
        assert abs(got.odg[i] - w.odg) < 1e-10, (i, got.odg[i], w.odg)
        for name in C.MOV_BASIC_NAMES:
            assert abs(got.movs[name][i] - w.movs[name]) \
                <= 1e-8 * (1 + abs(w.movs[name])), name


@pytest.mark.slow
def test_stream_pool_advanced_equals_scalar():
    """Advanced pool (dual-rate vmapped steps) matches the scalar
    advanced stream per stream."""
    from gstpeaq_jax.parallel.stream import PeaqStreamPool
    n = 40 * 1024
    sigs = [(TS.saw(n), TS.triangle(n)),
            (TS.saw(n), TS.triangle(n) * 0.9)]
    want = []
    for sa, tr in sigs:
        s = PeaqStreamAdvanced(channels=1, chunk_frames=16)
        s.feed(sa, tr)
        want.append(s.finalize())
    pool = PeaqStreamPool(2, channels=1, chunk_frames=16, advanced=True)
    pool.feed(np.stack([sa for sa, _ in sigs]),
              np.stack([tr for _, tr in sigs]))
    got = pool.finalize()
    for i, w in enumerate(want):
        assert abs(got.odg[i] - w.odg) < 1e-10, (i, got.odg[i], w.odg)
        for name in C.MOV_ADVANCED_NAMES:
            assert abs(got.movs[name][i] - w.movs[name]) \
                <= 1e-8 * (1 + abs(w.movs[name])), name


def test_stream_pcm16_feed_bit_exact():
    """int16 PCM feeds ship raw and dequantize on DEVICE
    (framing.dequantize); /32768 is a power of two, so the result is
    bit-identical to feeding x/32768 as float32."""
    n = 40 * 1024
    rng = np.random.default_rng(7)
    ri = (rng.integers(-2000, 2000, n) * 8).astype(np.int16)
    ti = (ri * 0.9).astype(np.int16)
    s_i = PeaqStream(channels=1, chunk_frames=16)
    s_i.feed(ri, ti)
    got = s_i.finalize()
    s_f = PeaqStream(channels=1, chunk_frames=16)
    s_f.feed(ri.astype(np.float32) / 32768.0, ti.astype(np.float32) / 32768.0)
    want = s_f.finalize()
    for name in C.MOV_BASIC_NAMES:
        w, g = want.movs[name], got.movs[name]
        if np.isnan(w):
            assert np.isnan(g), name
        else:
            assert g == w, (name, g, w)


def test_stream_pool_sharded_equals_unsharded():
    """PeaqStreamPool over the 8-device CPU mesh (stream-axis data
    parallelism) matches the unsharded pool exactly."""
    from gstpeaq_jax.parallel import shard as S
    from gstpeaq_jax.parallel.stream import PeaqStreamPool
    n = 40 * 1024
    refs = np.stack([TS.saw(n), TS.saw(n) * 0.8] * 4)
    tests = np.stack([TS.triangle(n), TS.triangle(n) * 0.7] * 4)
    plain = PeaqStreamPool(8, channels=1, chunk_frames=16)
    plain.feed(refs, tests)
    want = plain.finalize()
    mesh = S.default_mesh()
    pool = PeaqStreamPool(8, channels=1, chunk_frames=16, mesh=mesh)
    pool.feed(refs, tests)
    got = pool.finalize()
    # per-shard codegen reassociates reductions at the ULP level (the
    # parallel/shard tests gate ODG the same way), so not array_equal
    np.testing.assert_allclose(got.odg, want.odg, atol=1e-12)
    for name in C.MOV_BASIC_NAMES:
        np.testing.assert_allclose(got.movs[name], want.movs[name],
                                   rtol=1e-9)
