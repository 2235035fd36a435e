"""Cognitive model: the BS.1387 chapter-6 MLP mapping MOVs to DI/ODG.

src/nn.c: fixed sigmoid networks 11->3->1 (basic) and 5->5->1 (advanced),
plus the ODG squashing.  Also provides a trainable variant (`CognitiveModel`)
so the mapping can be refit to subjective-score datasets on a device mesh — the
standard's weights were themselves trained on the ITU listening tests.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from .. import constants as C


def _sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


def _di(movs, amin, amax, wx, wxb, wy, wyb, clamp):
    m = (movs - amin) / (amax - amin)
    if clamp:
        m = jnp.clip(m, 0.0, 1.0)
    x = wxb + jnp.dot(m, wx, precision=jax.lax.Precision.HIGHEST)
    return wyb + jnp.sum(wy * _sigmoid(x), axis=-1)


def di_basic(movs: jnp.ndarray, clamp: bool = False) -> jnp.ndarray:
    """movs: [..., 11] in MOV_BASIC_NAMES order; src/nn.c:186-216."""
    d = movs.dtype
    return _di(movs, jnp.asarray(C.NN_AMIN_BASIC, d),
               jnp.asarray(C.NN_AMAX_BASIC, d),
               jnp.asarray(C.NN_WX_BASIC, d),
               jnp.asarray(C.NN_WXB_BASIC, d),
               jnp.asarray(C.NN_WY_BASIC, d), C.NN_WYB_BASIC, clamp)


def di_advanced(movs: jnp.ndarray, clamp: bool = False) -> jnp.ndarray:
    """movs: [..., 5] in MOV_ADVANCED_NAMES order; src/nn.c:303-335."""
    d = movs.dtype
    return _di(movs, jnp.asarray(C.NN_AMIN_ADVANCED, d),
               jnp.asarray(C.NN_AMAX_ADVANCED, d),
               jnp.asarray(C.NN_WX_ADVANCED, d),
               jnp.asarray(C.NN_WXB_ADVANCED, d),
               jnp.asarray(C.NN_WY_ADVANCED, d), C.NN_WYB_ADVANCED, clamp)


def odg(di: jnp.ndarray) -> jnp.ndarray:
    """ODG = -3.98 + 4.2 * sigmoid(DI); src/nn.c:371-375."""
    return C.NN_BMIN + (C.NN_BMAX - C.NN_BMIN) * _sigmoid(di)


# ---------------------------------------------------------------------------
# Trainable cognitive model (refit the MOV->DI mapping to subjective scores)
# ---------------------------------------------------------------------------


def init_cognitive_params(advanced: bool = False) -> dict[str, Any]:
    """Initialize trainable parameters from the standard's weights."""
    if advanced:
        return {
            "amin": jnp.asarray(C.NN_AMIN_ADVANCED),
            "amax": jnp.asarray(C.NN_AMAX_ADVANCED),
            "wx": jnp.asarray(C.NN_WX_ADVANCED),
            "wxb": jnp.asarray(C.NN_WXB_ADVANCED),
            "wy": jnp.asarray(C.NN_WY_ADVANCED),
            "wyb": jnp.asarray(C.NN_WYB_ADVANCED),
        }
    return {
        "amin": jnp.asarray(C.NN_AMIN_BASIC),
        "amax": jnp.asarray(C.NN_AMAX_BASIC),
        "wx": jnp.asarray(C.NN_WX_BASIC),
        "wxb": jnp.asarray(C.NN_WXB_BASIC),
        "wy": jnp.asarray(C.NN_WY_BASIC),
        "wyb": jnp.asarray(C.NN_WYB_BASIC),
    }


def cognitive_forward(params: dict[str, Any], movs: jnp.ndarray) -> jnp.ndarray:
    """Differentiable DI from a parameter pytree; movs: [..., M] -> [...]."""
    m = (movs - params["amin"]) / (params["amax"] - params["amin"])
    x = params["wxb"] + jnp.dot(m, params["wx"],
                                precision=jax.lax.Precision.HIGHEST)
    return params["wyb"] + jnp.sum(params["wy"] * _sigmoid(x), axis=-1)


def cognitive_loss(params: dict[str, Any], movs: jnp.ndarray,
                   target_di: jnp.ndarray) -> jnp.ndarray:
    """MSE on DI — the objective used to fit chapter-6 weights."""
    pred = cognitive_forward(params, movs)
    return jnp.mean((pred - target_di) ** 2)


def sgd_train_step(params, movs, target_di, lr=1e-3, axis_name=None):
    """One SGD step; when used under shard_map/pmap pass axis_name to psum
    gradients across the data-parallel mesh axis."""
    loss, grads = jax.value_and_grad(cognitive_loss)(params, movs, target_di)
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        loss = jax.lax.pmean(loss, axis_name)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss
