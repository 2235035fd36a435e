"""Framing and the data-boundary threshold test.

Framing is done *inside* jit from padded signals via reshape (no gather, no
materialized overlap until the windowing matmul), matching the GstAdapter
drain semantics (src/gstpeaq.c:596-611) with the final zero-padded flush
frame (src/gstpeaq.c:715-745) supplied by host-side padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C


def dequantize(sig: jnp.ndarray) -> jnp.ndarray:
    """PCM16-shipped signals -> float32 on DEVICE, matching the host WAV
    convention exactly (utils/wavio.read_wav, native/peaqio.c: x / 32768,
    a power of two, so the device conversion is bit-identical to
    converting on the host).  Shipping int16 halves host->device bytes
    for file-sourced sweeps — the transfer path, not the device, bounds
    end-to-end sweep throughput (STATUS.md "End-to-end input pipeline").
    Float inputs pass through unchanged."""
    if jnp.issubdtype(sig.dtype, jnp.integer):
        return sig.astype(jnp.float32) * np.float32(1.0 / 32768.0)
    return sig


def num_frames(n_ref: int, n_test: int, frame_size: int, step_size: int) -> int:
    """Frame count under GstAdapter semantics: full frames while both
    signals have one, plus one zero-padded flush frame if either has
    leftover; src/gstpeaq.c:596-611,715-745."""
    n = min(n_ref, n_test)
    full = max(0, (n - frame_size) // step_size + 1) if n >= frame_size else 0
    consumed = full * step_size
    leftover = max(n_ref, n_test) - consumed
    return full + (1 if leftover > 0 else 0)


def padded_length(n_frames: int, frame_size: int, step_size: int) -> int:
    """Signal length needed to extract n_frames frames."""
    return (n_frames - 1) * step_size + frame_size if n_frames else 0


def pad_signal(sig: np.ndarray, n_frames: int, frame_size: int,
               step_size: int) -> np.ndarray:
    """Host-side: zero-pad/truncate [T, C] signal for n_frames frames."""
    length = padded_length(n_frames, frame_size, step_size)
    out = np.zeros((length, sig.shape[1]), dtype=sig.dtype)
    take = min(length, sig.shape[0])
    out[:take] = sig[:take]
    return out


def frames_overlap50(sig: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """[CH, T] -> [F, CH, 2048] frames with 50% overlap (FFT ear model).
    T must equal (n_frames + 1) * 1024."""
    hop = C.FFT_STEPSIZE
    ch = sig.shape[0]
    blocks = sig[:, :(n_frames + 1) * hop].reshape(ch, n_frames + 1, hop)
    frames = jnp.concatenate([blocks[:, :-1], blocks[:, 1:]], axis=-1)
    return jnp.moveaxis(frames, 0, 1)                  # [F, CH, 2048]


def blocks_hop(sig: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """[CH, T] -> [CH, F + 1, 1024] hop-sized blocks for the FFT ear
    model: frame f = blocks[:, f] | blocks[:, f + 1].  Keeping the
    50%-overlap implicit (fft_ear.stateless_pair_hop contracts the two
    halves with split DFT matrices) avoids materializing the
    2x-duplicated frame tensor.  Channel-major throughout: a pure
    reshape of the [CH, T] device layout (a frame-major [F+1, CH, 1024]
    moveaxis would be a real transpose); per-frame MOV values transpose
    to the accumulators' frame-major [F, CH] only at the tiny accum
    boundary."""
    hop = C.FFT_STEPSIZE
    ch = sig.shape[0]
    return sig[:, :(n_frames + 1) * hop].reshape(ch, n_frames + 1, hop)


def frames_disjoint(sig: jnp.ndarray, n_frames: int,
                    frame_size: int) -> jnp.ndarray:
    """[CH, T] -> [F, CH, frame_size] non-overlapping frames (FB model)."""
    ch = sig.shape[0]
    blocks = sig[:, :n_frames * frame_size].reshape(ch, n_frames, frame_size)
    return jnp.moveaxis(blocks, 0, 1)


def above_threshold_signal(sig: jnp.ndarray, n_frames: int, frame_size: int,
                           step_size: int) -> jnp.ndarray:
    """Data-boundary test evaluated on the signal (src/gstpeaq.c:1080-1099).

    Equivalent to testing each extracted frame but avoids the 2x overlap
    duplication: one 5-term shifted sum over |sig|, then per-hop-block
    reductions.  A frame is above threshold when any 5-sample window
    [i-4..i] with i >= 5 (frame-local) in any channel sums to >=
    200/32768.  (The reference accumulates the running sum serially; the
    exact sliding sums here give identical decisions except for
    sub-1e-4-relative borderline cases.)

    sig: [CH, T] with T = (n_frames - 1) * step_size + frame_size and
    frame_size in {step_size, 2 * step_size}.  Returns bool [n_frames].
    """
    t = sig.shape[-1]
    a = jnp.abs(sig)
    w = (a[..., 4:] + a[..., 3:-1] + a[..., 2:-2] + a[..., 1:-3]
         + a[..., :-4])                                # ends at j = 4..T-1
    # stay in f32 maxes until the per-frame compare: no sample-rate bool
    # vector materializes
    m = jnp.max(w, axis=0)                             # [T-4]
    g = jnp.concatenate([jnp.zeros(4, m.dtype), m])    # G[j], j = 0..T-1
    n_hops = t // step_size
    blocks = g[:n_hops * step_size].reshape(n_hops, step_size)
    tail_any = jnp.max(blocks[:, 5:], axis=1) >= C.FRAME_THRESHOLD
    if frame_size == step_size:
        return tail_any[:n_frames]
    full_any = jnp.max(blocks, axis=1) >= C.FRAME_THRESHOLD
    return tail_any[:n_frames] | full_any[1:n_frames + 1]


def sliding_max5_blocked(sig3: jnp.ndarray) -> jnp.ndarray:
    """Channel-max of the 5-sample sliding |.|-sums on a BLOCKED
    [CH, Tb, W] layout (W = 128-sample rows or 1024 hop rows) — minor
    shifts with a one-row carry, so no flat copy of the sample stream
    materializes.  Returns m [Tb, W] with
    m[j] = max_ch sum(|sig[j-4..j]|) (partial sums for j < 4 — every
    consumer skips or never reads those).

    ONE pass serves both ear models' data-boundary tests (the FFT and FB
    paths read the same reference samples; a flat-form test per path
    would duplicate the sample-rate traffic)."""
    wd = sig3.shape[-1]
    a = jnp.abs(sig3)
    # the four cross-row carries are 1..4-column slices of the
    # row-shifted stream — sliced lazily they can each cost a FULL
    # re-read of the pair array; extract the shared 4-column carry block
    # ONCE behind a barrier (ops/dc_block.py pattern)
    c4 = jax.lax.optimization_barrier(jnp.concatenate(
        [jnp.zeros_like(a[..., :1, -4:]), a[..., :-1, -4:]], axis=-2))
    w = a
    for s in range(1, 5):
        w = w + jnp.concatenate(
            [c4[..., 4 - s:], a[..., :wd - s]], axis=-1)
    return jnp.max(w, axis=-3)                   # over channels: [.., Tb, W]


def sliding_max5_chunks(sig3: jnp.ndarray):
    """sliding_max5_blocked reduced to per-64-sample-chunk maxima inside
    the PRODUCING pass: returns (cm, cm5), each [.., Tr, W//64], with
    cm[r, c] = max over columns 64c..64c+63 of the sliding sums and cm5
    the same with each chunk's first 5 columns masked to 0 (the
    frame-local j < 5 skip; sums are >= 0 so 0 is an identity for the
    >= threshold max, as in the gate functions below).  max-of-max is
    bit-exact vs reducing the full max5, and the sample-rate w/m arrays
    never reach device memory.  Every gate
    granularity is 64-aligned: FFT hop rows are 16 chunks, FB frames
    are exactly 3 (192 = 3 * 64)."""
    wd = sig3.shape[-1]
    assert wd % 64 == 0, wd
    a = jnp.abs(sig3)
    c4 = jax.lax.optimization_barrier(jnp.concatenate(
        [jnp.zeros_like(a[..., :1, -4:]), a[..., :-1, -4:]], axis=-2))
    w = a
    for s in range(1, 5):
        w = w + jnp.concatenate(
            [c4[..., 4 - s:], a[..., :wd - s]], axis=-1)
    wc = w.reshape(*w.shape[:-1], wd // 64, 64)
    cm = jnp.max(jnp.max(wc, axis=-1), axis=-3)          # [.., Tr, W/64]
    m5 = jnp.asarray(np.arange(64) >= 5)
    cm5 = jnp.max(jnp.max(jnp.where(m5, wc, 0.0), axis=-1), axis=-3)
    return cm, cm5


def fft_gate_from_chunks(cm: jnp.ndarray, cm5: jnp.ndarray,
                         n_frames: int) -> jnp.ndarray:
    """fft_gate_from_max5_hops on the chunked (cm, cm5) summaries
    ([.., rows, 16], one row per 1024-sample hop): the full-row max
    comes from cm; the row's skip-5 max combines chunk 0's masked max
    with chunks 1.. unmasked (the j < 5 skip lives entirely inside the
    first 64-sample chunk).  Identical decisions to the max5 form."""
    rows = n_frames + 1
    r = jnp.max(cm[..., :rows, :], axis=-1)               # [.., rows]
    r5 = jnp.maximum(cm5[..., :rows, 0],
                     jnp.max(cm[..., :rows, 1:], axis=-1))
    th = C.FRAME_THRESHOLD
    return (r5[..., :n_frames] >= th) | (r[..., 1:rows] >= th)


def fb_gate_from_chunks(cm: jnp.ndarray, cm5: jnp.ndarray,
                        n_frames: int) -> jnp.ndarray:
    """fb_gate_from_max5_hops on the chunked summaries: each column IS a
    64-sample segment and FB frames are exactly 3 segments starting on
    segment boundaries; frame-start segments take the skip-5 masked
    max.  Identical decisions to the max5 form."""
    segs = cm.shape[-2] * cm.shape[-1]
    assert segs % 3 == 0, cm.shape
    s = cm.reshape(*cm.shape[:-2], segs)
    s5 = cm5.reshape(*cm.shape[:-2], segs)
    rt = jnp.where(jnp.asarray(np.arange(segs) % 3 == 0), s5, s)
    fr = (jnp.max(rt.reshape(*cm.shape[:-2], -1, 3), axis=-1)
          >= C.FRAME_THRESHOLD)
    return fr[..., :n_frames]


def fb_gate_from_max5(m: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """FB-path frame gates (frame == step == 192) from sliding_max5_blocked
    output [.., Tb, 128].  Windows ending at frame-local samples 0..4 are
    skipped as the reference does (src/gstpeaq.c:1080-1099).  Requires
    Tb % 3 == 0 (true for every Pallas-aligned FB bucket)."""
    tb = m.shape[-2]
    assert tb % 3 == 0, tb
    v = m.reshape(*m.shape[:-2], tb // 3, 384)   # 3 blocks = 2 frames
    lane = np.arange(384)
    vm = jnp.where(jnp.asarray((lane % C.FB_FRAMESIZE) >= 5), v, 0.0)
    f0 = jnp.max(vm[..., :C.FB_FRAMESIZE], axis=-1)
    f1 = jnp.max(vm[..., C.FB_FRAMESIZE:], axis=-1)
    fr = (jnp.stack([f0, f1], axis=-1).reshape(*m.shape[:-2], -1)
          >= C.FRAME_THRESHOLD)
    return fr[..., :n_frames]


def fft_gate_from_max5(m: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """FFT-path frame gates (frame 2048 / hop 1024 = 8 blocked rows) from
    sliding_max5_blocked output [.., Tb, 128], Tb >= (n_frames + 1) * 8.
    Same decisions as above_threshold_signal(sig, n, 2048, 1024): the
    tail hop skips its first 5 frame-local windows; full hops (and the
    partial sums at j < 4, which only exist inside the never-consumed
    hop 0 head) match exactly."""
    rows = (n_frames + 1) * 8
    r = jnp.max(m[..., :rows, :], axis=-1)                    # [.., rows]
    m5 = jnp.where(jnp.asarray(np.arange(128) >= 5),
                   m[..., :rows, :], 0.0)
    r5 = jnp.max(m5, axis=-1)
    first = jnp.asarray(np.arange(rows) % 8 == 0)
    rt = jnp.where(first, r5, r)
    h_full = jnp.max(r.reshape(*r.shape[:-1], -1, 8), axis=-1)   # [.., F+1]
    h_tail = jnp.max(rt.reshape(*rt.shape[:-1], -1, 8), axis=-1)
    th = C.FRAME_THRESHOLD
    return (h_tail[..., :n_frames] >= th) | (h_full[..., 1:n_frames + 1] >= th)


def above_threshold_blocked(sig3: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """above_threshold_signal for the FB path on the BLOCKED [CH, Tb, 128]
    device layout (see sliding_max5_blocked / fb_gate_from_max5)."""
    return fb_gate_from_max5(sliding_max5_blocked(sig3), n_frames)


def fft_gate_from_max5_hops(m: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """fft_gate_from_max5 on the HOP-layout max5 [.., Tq, 1024] (one row
    per hop — the ship layout whose rows ARE the rDFT's hop blocks).
    Hop == row makes this the cheapest form: the tail hop of frame f is
    row f with its first 5 frame-local windows skipped; the full hop is
    row f + 1 whole.  Same decisions as above_threshold_signal(sig, n,
    2048, 1024) — the j < 4 partial sums exist only in row 0, which the
    >= 5 skip covers."""
    rows = n_frames + 1
    mr = m[..., :rows, :]
    r = jnp.max(mr, axis=-1)                               # [.., rows]
    m5 = jnp.where(jnp.asarray(np.arange(C.FFT_STEPSIZE) >= 5), mr, 0.0)
    r5 = jnp.max(m5, axis=-1)
    th = C.FRAME_THRESHOLD
    return (r5[..., :n_frames] >= th) | (r[..., 1:n_frames + 1] >= th)


def fb_gate_from_max5_hops(m: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """fb_gate_from_max5 on the HOP-layout max5 [.., Tq, 1024].
    1024 = 16 segments of 64 and gcd(192, 64) = 64, so FB frames are
    exactly 3 segments starting on segment boundaries: two fused
    segment-max passes (full, and frame-start skip-5 masked) reduce the
    sample-rate data once; the 3-segment frame combine then runs on the
    tiny [.., T/64] summary.  Requires (Tq * 16) % 3 == 0 (every
    1024-aligned FB bucket: t_fb % 3072 == 0 whenever t_fb % 1024 == 0,
    since t_fb = 192 * n_fb)."""
    tq = m.shape[-2]
    segs = tq * 16
    assert segs % 3 == 0, tq
    sm = jnp.max(m.reshape(*m.shape[:-1], 16, 64), axis=-1)   # [.., Tq, 16]
    m5 = jnp.where(jnp.asarray(np.arange(1024) % 64 >= 5), m, 0.0)
    sm5 = jnp.max(m5.reshape(*m.shape[:-1], 16, 64), axis=-1)
    s = sm.reshape(*m.shape[:-2], segs)
    s5 = sm5.reshape(*m.shape[:-2], segs)
    rt = jnp.where(jnp.asarray(np.arange(segs) % 3 == 0), s5, s)
    fr = (jnp.max(rt.reshape(*m.shape[:-2], -1, 3), axis=-1)
          >= C.FRAME_THRESHOLD)
    return fr[..., :n_frames]
