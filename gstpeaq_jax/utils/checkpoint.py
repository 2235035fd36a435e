"""Checkpoint/resume for streaming PEAQ state.

The stream state is an explicit pytree of real arrays (parallel/stream.py),
which makes checkpointing trivial: save its leaves to one `.npz` file and
restore them into a fresh stream.  The reference has no checkpointing — its
"state" lives in C structs inside a running GStreamer pipeline; this module
enables resumable hour-scale evaluations.

Every checkpoint embeds parallel.stream.STATE_FORMAT_VERSION; loading a
checkpoint written under a different state layout fails with an explicit
message instead of opaque shape/transfer errors mid-stream.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _format_version() -> int:
    from ..parallel.stream import STATE_FORMAT_VERSION
    return STATE_FORMAT_VERSION


def _check_version(found: int | None, path: str) -> None:
    want = _format_version()
    if found is None:
        raise ValueError(
            f"checkpoint {path!r} carries no state-format version: it was "
            f"written by a pre-v{want} revision whose state layout is "
            "incompatible (complex biquad carries / transposed e0 tail); "
            "re-run the evaluation from the start")
    if int(found) != want:
        raise ValueError(
            f"checkpoint {path!r} has state-format version {int(found)}, "
            f"this build expects {want}; the carried state layouts are "
            "incompatible — re-run the evaluation from the start")


def save_state(path: str, state: Any) -> None:
    """Save a stream state pytree to `path + ".npz"`."""
    import jax

    leaves = jax.tree.leaves(state)
    np.savez(str(path) + ".npz", format_version=np.int64(_format_version()),
             **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})


def load_state(path: str, like: Any) -> Any:
    """Restore a stream state saved by save_state; `like` provides the
    pytree structure (e.g. a freshly initialized stream's .state)."""
    import jax

    data = np.load(str(path) + ".npz")
    _check_version(data["format_version"]
                   if "format_version" in data else None, path)
    leaves, treedef = jax.tree.flatten(like)
    return jax.tree.unflatten(
        treedef, [data[f"leaf_{i}"] for i in range(len(leaves))])
