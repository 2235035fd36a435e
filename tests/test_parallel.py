"""Batched / sharded evaluation equals single-pair results; training step."""

import numpy as np
import pytest

from gstpeaq_jax import api
from gstpeaq_jax.parallel import batch as B
from gstpeaq_jax.parallel import shard as S
from gstpeaq_jax.utils import testsignals as TS


@pytest.fixture(scope="module")
def pairs():
    n = 40 * 1024
    return [(TS.saw(n + 3000 * i), TS.triangle(n + 3000 * i))
            for i in range(5)]


@pytest.mark.slow
def test_batch_equals_single(pairs):
    singles = [api.peaq(r, t).odg for r, t in pairs[:2]]
    out = B.peaq_batch([p[0] for p in pairs], [p[1] for p in pairs],
                       granularity=8)
    np.testing.assert_allclose(out["odg"][:2], singles, atol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("advanced", [False, True])
def test_pcm16_ship_equals_float(pairs, advanced):
    """int16-shipped inputs (device-side dequantize, framing.dequantize)
    give BIT-IDENTICAL results to float inputs when the sources are
    int16-representable: the 1/32768 scale is a power of two."""
    q = [(np.clip(np.round(r * 32768.0), -32768, 32767),
          np.clip(np.round(t * 32768.0), -32768, 32767)) for r, t in pairs]
    fl = [(np.float32(r / 32768.0), np.float32(t / 32768.0)) for r, t in q]
    i16 = [(r.astype(np.int16), t.astype(np.int16)) for r, t in q]
    kw = dict(advanced=advanced, granularity=8, microbatch=8)
    out_f = B.peaq_batch([p[0] for p in fl], [p[1] for p in fl], **kw)
    out_i = B.peaq_batch([p[0] for p in i16], [p[1] for p in i16], **kw)
    np.testing.assert_array_equal(out_i["odg"], out_f["odg"])
    np.testing.assert_array_equal(out_i["movs"], out_f["movs"])


@pytest.mark.slow
def test_sharded_equals_batch(pairs):
    import jax
    assert len(jax.devices()) == 8  # virtual CPU mesh from conftest
    out = B.peaq_batch([p[0] for p in pairs], [p[1] for p in pairs],
                       granularity=8)
    sh = S.peaq_sharded([p[0] for p in pairs], [p[1] for p in pairs],
                        granularity=8)
    np.testing.assert_allclose(sh["odg"], out["odg"], atol=1e-12)


@pytest.mark.slow
def test_sharded_equals_batch_advanced(pairs):
    """Advanced mode's dual-rate input pytree sharded over the 8-device
    mesh must agree with the single-device batch exactly."""
    import jax
    assert len(jax.devices()) == 8
    refs = [p[0] for p in pairs[:3]]
    tests = [p[1] for p in pairs[:3]]
    out = B.peaq_batch(refs, tests, advanced=True, granularity=8)
    sh = S.peaq_sharded(refs, tests, advanced=True, granularity=8)
    np.testing.assert_allclose(sh["odg"], out["odg"], atol=1e-12)


def test_train_cognitive_sharded_decreases_loss():
    rng = np.random.default_rng(5)
    movs = rng.standard_normal((64, 11)) * 10 + 50
    tgt = rng.standard_normal(64)
    _, losses = S.train_cognitive_sharded(movs, tgt, steps=10)
    assert losses[-1] < losses[0]


def test_dryrun_multichip():
    import __graft_entry__ as G
    G.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_driver_env():
    """dryrun_multichip in a fresh subprocess with no conftest, no pre-set
    XLA_FLAGS and no JAX_PLATFORMS: the function must set up the virtual
    CPU mesh itself, before the first backend use."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as G; G.dryrun_multichip(8)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert "metric batch 16 pairs OK" in proc.stdout
