"""Pallas kernel (Triton route) for the FB ear model's frequency spreading.

Replaces the XLA exp-form upper spreading of ops/fb_ear.spread_t (1,600
`exp` per instant, the [Z, Z] weight slab re-derived for every instant,
then a separate lower-spreading contraction and |A|^2 pass) with one
kernel on the transposed [rows * Z, I] layout (bands major, instants
minor):

* one program per (row, tile of TILE_I instants); the 40 bands live in
  registers as 40 per-band vectors of TILE_I instants, so fb_re / fb_im /
  cu are read from device memory once and only E0 is written;
* the level-dependent upper spreading U[i, j] = cu[i]^(j - i) (j > i) is
  unrolled at trace time as shift-multiply steps — source band i carries
  p_i = fb[i] cu[i]^(j - i) and adds it into each destination j > i — so
  it needs no transcendental at all;
* the constant lower spreading final[c] = sum_{j >= c} CL^(j - c) A[j] is
  the Horner recurrence final[c] = A[c] + CL final[c + 1] (39 FMAs in
  full f32; no matrix unit, so no TF32 rounding);
* the ragged last tile is masked; nothing carries between programs.

Numerics: same math as the XLA form, reassociated (products of cu
instead of exp(e log cu)); agreement is at float32 rounding level.

Reference: src/fbearmodel.c:326-360 (spreading + rectification).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import constants as _C

Z = 40            # FB band count (BS.1387 Table 8)
TILE_I = 128      # instants per program: one per thread at 4 warps
NUM_WARPS = 4


def _spread_kernel(fbr_ref, fbi_ref, cu_ref, out_ref, *, n_inst: int):
    row = pl.program_id(0)
    t0 = pl.program_id(1) * TILE_I
    mask = t0 + jnp.arange(TILE_I, dtype=jnp.int32) < n_inst
    cols = pl.ds(t0, TILE_I)

    def load(ref, b):
        return pltriton.load(ref.at[row * Z + b, cols], mask=mask, other=0.0)

    acc_r = [load(fbr_ref, b) for b in range(Z)]
    acc_i = [load(fbi_ref, b) for b in range(Z)]
    # descending sources: destination j > i only ever receives from
    # sources below it, so acc[i] still holds the bare fb[i] when source
    # i is processed and no second read of fb is needed
    for i in range(Z - 2, -1, -1):
        cu_i = load(cu_ref, i)
        p_r, p_i = acc_r[i], acc_i[i]
        for j in range(i + 1, Z):
            p_r = p_r * cu_i
            p_i = p_i * cu_i
            acc_r[j] = acc_r[j] + p_r
            acc_i[j] = acc_i[j] + p_i
    f_r, f_i = acc_r[Z - 1], acc_i[Z - 1]
    e0 = [None] * Z
    for c in range(Z - 1, -1, -1):
        if c < Z - 1:
            f_r = acc_r[c] + _C.CL * f_r
            f_i = acc_i[c] + _C.CL * f_i
        e0[c] = f_r * f_r + f_i * f_i
    # ascending stores: the same kernel, but the interpreter's XLA:CPU
    # compile of it is ~3x faster than storing inside the descending loop
    for c in range(Z):
        pltriton.store(out_ref.at[row * Z + c, cols], e0[c], mask=mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def spread_apply(fb_re: jnp.ndarray, fb_im: jnp.ndarray, cu: jnp.ndarray,
                 interpret: bool = False) -> jnp.ndarray:
    """E0 = |lower(fb + upper(fb, cu))|^2 on the [..., Z, I] layout.

    fb_re/fb_im/cu: [..., Z, I] float32.  Returns E0 [..., Z, I] float32.
    """
    shape = fb_re.shape
    assert shape[-2] == Z, shape
    n_inst = shape[-1]
    flat = [x.astype(jnp.float32).reshape(-1, n_inst)
            for x in (fb_re, fb_im, cu)]
    rows = flat[0].shape[0] // Z
    out = pl.pallas_call(
        functools.partial(_spread_kernel, n_inst=n_inst),
        out_shape=jax.ShapeDtypeStruct((rows * Z, n_inst), jnp.float32),
        grid=(rows, pl.cdiv(n_inst, TILE_I)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="fb_spread",
    )(*flat)
    return out.reshape(shape)
