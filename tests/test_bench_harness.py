"""bench.py / chip_smoke.py harness behaviour that must not regress silently.

Both measure the GPU: without one they fail instead of falling back, and no
CPU number is written under a device metric's name.  The compile cache
follows JAX_COMPILATION_CACHE_DIR or a fixed path in the checkout.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_spread_fields_reports_median_and_extremes():
    sp = bench.spread_fields([9500.0, 9100.0, 9800.0])
    assert sp == {"value": 9500.0, "spread": [9100.0, 9800.0],
                  "n_repeats": 3}
    sp2 = bench.spread_fields([100.0, 200.0])
    assert sp2["value"] == 150.0
    sp1 = bench.spread_fields([7.0])
    assert sp1["value"] == 7.0 and sp1["spread"] == [7.0, 7.0]


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_cell_record_names_its_device(platform):
    device = {"platform": platform, "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "power_limit": "700.00 W"}
    rec = bench.cell_record("advanced", "accurate", 64, 10.0,
                            {"rates": [6400.0, 6300.0, 6500.0],
                             "compile_s": 12.345}, device, 123)
    assert rec["platform"] == platform and rec["power_limit"] == "700.00 W"
    assert rec["kind"] == device["kind"] and rec["peak_bytes_in_use"] == 123
    assert rec["value"] == 6400.0 and rec["vs_baseline"] == 1.0
    assert rec["compile_s"] == 12.35
    if platform == "gpu":
        assert rec["metric"].startswith("audio-seconds/sec/gpu (")
    else:
        assert "/gpu" not in rec["metric"] and "not a device metric" in \
            rec["metric"]


def test_bench_exits_nonzero_without_gpu(capsys):
    assert bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_exits_nonzero_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_last_line():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.last_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code
    (JAX reads the variable itself); otherwise `.jax_cache` at the root
    of the checkout, wherever the process runs from."""
    import jax

    from gstpeaq_jax import api
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(api, "_CACHE_ENABLED", False)
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
        assert api.compile_cache_dir() is None
        api.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".jax_cache")
        assert api.compile_cache_dir() == want
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: seen.__setitem__(k, v))
        seen = {}
        api.enable_compile_cache()
        assert seen["jax_compilation_cache_dir"] == want
