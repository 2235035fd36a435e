"""WAV I/O round-trips, resampling, CLI output format."""

import os
import subprocess
import sys

import numpy as np
import pytest


def _cpu_env():
    """CLI subprocess env pinned to the CPU backend: these tests check
    output format, not device numerics."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env

from gstpeaq_jax.utils import testsignals as TS
from gstpeaq_jax.utils import wavio


def test_wav_float_roundtrip(tmp_path):
    x = TS.sine(4800)[:, None]
    path = str(tmp_path / "f.wav")
    wavio.write_wav(path, x, 48000)
    y, rate = wavio.read_wav(path)
    assert rate == 48000
    np.testing.assert_array_equal(x, y)


def test_wav_pcm16(tmp_path):
    import struct
    x = (np.array([-32768, -1, 0, 1, 32767], dtype="<i2"))
    payload = x.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 48000, 96000, 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    path = tmp_path / "i16.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    y, rate = wavio.read_wav(str(path))
    np.testing.assert_allclose(
        y[:, 0], x.astype(np.float64) / 32768.0, atol=1e-7)


def test_wav_pcm16_raw_ship(tmp_path):
    """read_wav_pcm16_48k returns the untouched int16 payload for 48 kHz
    PCM16 files (the device dequantizes, framing.dequantize) and None for
    anything else; load_audio_48k_ship falls back to float for the rest."""
    import struct

    from gstpeaq_jax.utils import native
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, size=(4800, 2)).astype("<i2")
    payload = x.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, 48000, 192000, 4, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    path = tmp_path / "i16.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    raw = wavio.read_wav_pcm16_48k(str(path))
    np.testing.assert_array_equal(raw, x)
    assert raw.dtype == np.int16
    ship = native.load_audio_48k_ship(str(path))
    np.testing.assert_array_equal(ship, x)
    fpath = tmp_path / "f.wav"
    wavio.write_wav(str(fpath), TS.sine(4800)[:, None], 48000)
    assert wavio.read_wav_pcm16_48k(str(fpath)) is None
    assert native.load_audio_48k_ship(str(fpath)).dtype == np.float32


def test_resample_identity():
    x = TS.sine(4800)[:, None]
    assert wavio.resample_to_48k(x, 48000) is x


def test_resample_44k1_tone():
    # a 1 kHz tone at 44.1k resampled to 48k stays a 1 kHz tone
    n = 44100
    t = np.arange(n) / 44100.0
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)[:, None]
    y = wavio.resample_to_48k(x, 44100)
    assert abs(y.shape[0] - 48000) <= 2
    mid = y[2000:40000, 0]
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    peak_hz = np.argmax(spec) * 48000.0 / len(mid)
    assert abs(peak_hz - 1000.0) < 5.0


@pytest.fixture(scope="module")
def native():
    """The native loader, built from native/peaqio.c for these tests."""
    from gstpeaq_jax.utils import native as N
    if not N.build():
        pytest.skip("native/libpeaqio.so cannot be built here "
                    "(make -C native needs make and a C compiler)")
    return N


def test_native_read_wav_matches_python(tmp_path, native):
    x = TS.sine(4800)[:, None]
    path = str(tmp_path / "f.wav")
    wavio.write_wav(path, x, 48000)
    y_nat, rate = native.read_wav(path)
    assert rate == 48000
    np.testing.assert_array_equal(x, y_nat)


def test_native_load_audio_48k_resample_parity(tmp_path, native):
    """Native 44.1->48 kHz resample: <=1e-4 from the ideal tone (beats the
    scipy fallback's ~7e-4) and within ~1e-3 of wavio's scipy path."""
    n = 44100
    t = np.arange(n) / 44100.0
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)[:, None]
    path = str(tmp_path / "t44.wav")
    wavio.write_wav(path, x, 44100)
    y = native.load_audio_48k(path)
    assert abs(y.shape[0] - 48000) <= 2
    m = y.shape[0]
    ideal = np.sin(2 * np.pi * 1000.0 * np.arange(m) / 48000.0)
    assert np.max(np.abs(y[2000:m - 2000, 0]
                         - ideal[2000:m - 2000])) < 1e-4
    y_py = wavio.resample_to_48k(x, 44100)
    mm = min(m, y_py.shape[0])
    assert np.max(np.abs(y[2000:mm - 2000] - y_py[2000:mm - 2000])) < 2e-3


def test_native_resample_speed(native):
    """The polyphase inner loop steps only the ~32 valid taps per phase;
    10 s of 44.1 kHz stereo must resample in well under realtime."""
    import ctypes
    import time
    lib = native._find_lib()
    n = 441000
    t = np.arange(n) / 44100.0
    x = np.stack([np.sin(2 * np.pi * 997.0 * t),
                  np.sin(2 * np.pi * 3001.0 * t)], 1).astype(np.float32)
    cap = n * 48000 // 44100 + 64
    out = np.empty((cap, 2), np.float32)
    t0 = time.perf_counter()
    got = lib.peaq_resample_48k(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, 2, 44100,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    dt = time.perf_counter() - t0
    assert got == 480000
    assert dt < 0.25, f"resample took {dt * 1000:.0f} ms"  # measured ~37 ms


def test_conformance_table_regeneration():
    """xml_table/stats regenerate the reference's DocBook table format
    (doc/make_conformance_tables.sh equivalent); data-free check on
    synthetic rows."""
    from gstpeaq_jax import conformance as CF
    rows = [CF.ConformanceRow(item=i, di=d, odg=o, itu_di=d - 0.01,
                              blessed_di=d, itu_odg=o + 0.02)
            for i, d, o in [("acodsna", 1.30, -0.68),
                            ("bcodtri", 1.95, -0.30)]]
    xml = CF.xml_table(rows, advanced=False)
    assert xml.startswith('<table frame="none" id="conformance_basic_table"')
    assert "<entry>acodsna</entry>" in xml
    assert "<entry>1.290</entry>" in xml  # itu_di to 3 decimals
    assert xml.count("<row>") == 3  # header + 2 items
    s = CF.stats(rows)
    assert "ODG mean error (bias): -0.020" in s
    assert "DI mean error (bias): 0.010" in s


def test_conformance_run_end_to_end(tmp_path, monkeypatch):
    """Drive conformance.run() -> report() -> exit-code logic on a synthetic
    fake dataset: covers the {item} -> {item.replace('cod','ref')} file
    naming and loader wiring that would otherwise first execute the day the
    real (proprietary) BS.1387 dataset appears.  Tolerance values are
    irrelevant — fake audio won't match the blessed DIs."""
    from gstpeaq_jax import conformance as CF
    items = ["acodsna", "bcodtri"]          # real ITU item names
    n = 48000 * 3 // 5                       # 0.6 s per item, mono
    rng = np.random.default_rng(0)
    t = np.arange(n) / 48000.0
    for i, item in enumerate(items):
        # MOV validity gates must stay OPEN (CLAUDE.md): the ref needs
        # content past 8.1 kHz + a dither floor or BandwidthRefB is 0/0=NaN
        ref = (0.3 * np.sin(2 * np.pi * (440 + 100 * i) * t)
               + 0.1 * np.sin(2 * np.pi * 3500.0 * t)
               + 0.03 * np.sin(2 * np.pi * 9200.0 * t)
               + 2e-5 * rng.standard_normal(n))
        test = ref + 0.01 * rng.standard_normal(n)
        # naming convention under test: acodsna -> arefsna.wav + acodsna.wav
        wavio.write_wav(str(tmp_path / (item.replace("cod", "ref") + ".wav")),
                        ref.astype(np.float32)[:, None], 48000)
        wavio.write_wav(str(tmp_path / (item + ".wav")),
                        test.astype(np.float32)[:, None], 48000)
    fake_table = {k: CF.CONFORMANCE_BASIC[k] for k in items}
    monkeypatch.setattr(CF, "CONFORMANCE_BASIC", fake_table)
    rows = CF.run(advanced=False, directory=str(tmp_path))
    assert [r.item for r in rows] == items
    assert all(np.isfinite(r.di) and np.isfinite(r.odg) for r in rows)
    rep = CF.report(rows)
    assert "acodsna" in rep and "max |dBlessed|" in rep
    # main()'s pass/fail gate: synthetic audio must NOT match the blessed DIs
    assert max(abs(r.delta_blessed) for r in rows) >= 1e-3
    # absent-dataset path raises (main() maps this to exit code 77)
    monkeypatch.delenv("CONFORMANCEDATADIR", raising=False)
    with pytest.raises(FileNotFoundError):
        CF.run(advanced=False)


@pytest.mark.slow
def test_cli_matches_reference_format(tmp_path):
    ref = TS.saw(64 * 1024)
    test = TS.triangle(64 * 1024)
    rp, tp = str(tmp_path / "r.wav"), str(tmp_path / "t.wav")
    wavio.write_wav(rp, ref[:, None])
    wavio.write_wav(tp, test[:, None])
    proc = subprocess.run(
        [sys.executable, "-m", "gstpeaq_jax", rp, tp],
        capture_output=True, text=True, check=True, env=_cpu_env())
    lines = proc.stdout.strip().splitlines()
    assert lines[-2].startswith("Objective Difference Grade: ")
    assert lines[-1].startswith("Distortion Index: ")
    odg = float(lines[-2].split(": ")[1])
    assert -4.0 <= odg <= 0.3


@pytest.mark.slow
def test_cli_precision_mixed_and_totalsnr(tmp_path):
    """--precision mixed is accepted (docs/peaq.md) and --totalsnr prints
    the reference's totalsnr property (src/gstpeaq.c:493-497)."""
    ref = TS.saw(48 * 1024)
    test = TS.triangle(48 * 1024)
    rp, tp = str(tmp_path / "r.wav"), str(tmp_path / "t.wav")
    wavio.write_wav(rp, ref[:, None])
    wavio.write_wav(tp, test[:, None])
    proc = subprocess.run(
        [sys.executable, "-m", "gstpeaq_jax", "--precision", "mixed",
         "--totalsnr", rp, tp],
        capture_output=True, text=True, check=True, env=_cpu_env())
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("Total SNR: ")
    assert lines[-1].endswith(" dB")
    snr = float(lines[-1].split(": ")[1].split(" ")[0])
    assert np.isfinite(snr)


@pytest.mark.slow
def test_cli_bands_property(tmp_path):
    """--bands N (the reference's number-of-bands property,
    src/fftearmodel.c:207-214): a 55-band basic run produces a finite ODG
    different from the 109-band default, and the API rejects out-of-range
    and advanced-mode requests."""
    from gstpeaq_jax import api

    ref = TS.saw(48 * 1024)
    test = TS.triangle(48 * 1024)
    rp, tp = str(tmp_path / "r.wav"), str(tmp_path / "t.wav")
    wavio.write_wav(rp, ref[:, None])
    wavio.write_wav(tp, test[:, None])
    out = {}
    for bands in (None, 55):
        cmd = [sys.executable, "-m", "gstpeaq_jax", rp, tp]
        if bands:
            cmd[-2:-2] = ["--bands", str(bands)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=True, env=_cpu_env())
        out[bands] = float(
            proc.stdout.strip().splitlines()[-2].split(": ")[1])
    assert np.isfinite(out[55]) and np.isfinite(out[None])
    assert out[55] != out[None]

    with pytest.raises(ValueError, match="55..109"):
        api.peaq(ref, test, band_count=110)
    with pytest.raises(ValueError, match="basic mode only"):
        api.peaq(ref, test, advanced=True, band_count=60)


def test_cli_float64_keeps_platform(tmp_path, monkeypatch):
    """--precision float64 runs on whatever backend JAX chose: the CLI
    never switches platform (the GPU runs float64 natively)."""
    import jax

    from gstpeaq_jax import api, cli
    rp, tp = str(tmp_path / "r.wav"), str(tmp_path / "t.wav")
    wavio.write_wav(rp, TS.saw(4800)[:, None])
    wavio.write_wav(tp, TS.triangle(4800)[:, None])
    seen = {}

    def fake_peaq(ref, test, dtype=None, **kw):
        seen["dtype"] = dtype
        return api.PeaqResult(odg=-1.5, di=0.25, movs={})

    updates = []
    real_update = jax.config.update
    monkeypatch.setattr(api, "peaq", fake_peaq)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: (updates.append(k), real_update(k, v)))
    assert cli.main(["--precision", "float64", rp, tp]) == 0
    assert seen["dtype"] == "float64"
    assert "jax_platforms" not in updates
