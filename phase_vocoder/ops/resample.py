"""Linear-interpolation resampler (reference component C12 — pitch shift).

out[j] = x[j / factor], linear interpolation, edge-clamped — the golden
model's resample_linear. Two paths, chosen by the step 1/factor:

  * rational steps p/q (q small): out[m*q + r] = lerp(x[m*p + a_r], w_r)
    with per-residue constant offsets and weights. Covers every octave
    pitch shift EXACTLY (+-12 st resample by 2 or 1/2 is p/q in {2/1, 1/2};
    identity is 1/1), evaluated as one dense product against a constant
    lerp-weight matrix.
  * every other step: a per-element gather of the two lerp taps.

Precision: sample positions j/factor are split per block into an exact
host-computed float64 integer part and a small float32 fractional part, so
position error stays ~1e-4 samples for arbitrarily long outputs (naive
float32 j/factor drifts past 2^23 samples). Linear interpolation is
continuous in position, so the <=1-ulp position differences between
formulations are ~slope*2^-24 in the waveform — far below the 1e-4 gate.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

_BLOCK = 1024  # positions-precision block (f64 host starts)


def _as_rational_step(factor: float, max_q: int = 4, max_p: int = 8):
    """1/factor as an EXACT small fraction p/q, or None.

    Exactness in float64 is required (the golden model computes j/factor in
    f64); octave factors (powers of two) always qualify.
    """
    if factor <= 0:
        return None
    step = 1.0 / factor
    fr = Fraction(step).limit_denominator(max_q)
    if 0 < fr.numerator <= max_p and float(fr) == step:
        return fr
    return None


def resample_linear(x: jnp.ndarray, factor: float, out_len: int) -> jnp.ndarray:
    """Resample 1-D x by `factor` (>1 = more samples) to `out_len` samples.

    out[j] = x[j / factor], linear interpolation, edge-clamped. Matches
    golden/pv_ref.py::resample_linear.
    """
    if out_len <= 0:
        return jnp.zeros((0,), dtype=x.dtype)
    if x.shape[-1] == 0:
        return jnp.zeros((out_len,), dtype=x.dtype)
    fr = _as_rational_step(factor)
    if fr is not None:
        return _resample_rational(x, fr.numerator, fr.denominator, out_len)
    return _resample_gather(x, factor, out_len)


def _positions(factor: float, out_len: int, n: int):
    """(lo int32, frac f32) exact blocked positions, edge-clamped.

    The in-block offset j/factor is itself split into an exact integer
    part and a sub-1.0 f32 fraction: a single f32 j/factor has ulp
    ~2.4e-4 samples at j ~ 2048, which was the dominant error term of the
    whole pitch pipeline (measured ~8e-5 vs golden at +5/+7 st); with the
    split, position error is ~6e-8 samples at any block size.
    """
    nblocks = -(-out_len // _BLOCK)
    starts = np.arange(nblocks, dtype=np.float64) * (_BLOCK / factor)
    start_int = jnp.asarray(np.floor(starts), dtype=jnp.int32)
    start_frac = jnp.asarray(starts - np.floor(starts), dtype=jnp.float32)
    jo64 = np.arange(_BLOCK, dtype=np.float64) / factor
    jo_int = jnp.asarray(np.floor(jo64), dtype=jnp.int32)
    jo_frac = jnp.asarray(jo64 - np.floor(jo64), dtype=jnp.float32)
    local = start_frac[:, None] + jo_frac[None, :]  # in [0, 2)
    local_int = jnp.floor(local)
    lo = (
        start_int[:, None] + jo_int[None, :] + local_int.astype(jnp.int32)
    ).reshape(-1)[:out_len]
    frac = (local - local_int).reshape(-1)[:out_len]
    return jnp.clip(lo, 0, n - 1), frac


def _resample_gather(x: jnp.ndarray, factor: float, out_len: int) -> jnp.ndarray:
    """Irrational steps: gather the two lerp taps of every output sample."""
    n = x.shape[-1]
    lo, frac = _positions(factor, out_len, n)
    frac = frac.astype(x.dtype)
    hi = jnp.minimum(lo + 1, n - 1)
    return x[lo] * (1.0 - frac) + x[hi] * frac


@functools.lru_cache(maxsize=32)
def _rational_mats(p: int, q: int):
    """(M (128p, 128q) f32, cross (1, 128q) f32) for the rational resampler.

    Within one row of X (128p input samples starting at m0*p), output
    column c = j*q + r (j in [0,128), r in [0,q)) is
      out = x[j*p + a_r]*(1-w_r) + x[j*p + a_r + 1]*w_r,
    a_r = (r*p)//q, w_r = (r*p mod q)/q. All in-row terms land in M; the
    lerp neighbor of the last j that crosses the row boundary (j = 127,
    a_r + 1 == p) lands in `cross`, applied to the NEXT row's first sample.
    Entries are exact dyadic/q-adic fractions.
    """
    M = np.zeros((128 * p, 128 * q), np.float32)
    cross = np.zeros((1, 128 * q), np.float32)
    for j in range(128):
        for r in range(q):
            a = (r * p) // q
            w = ((r * p) % q) / q
            c = j * q + r
            M[j * p + a, c] += 1.0 - w
            if w:
                hi = j * p + a + 1
                if hi < 128 * p:
                    M[hi, c] += w
                else:
                    cross[0, c] = w
    return M, cross


def _resample_rational(x: jnp.ndarray, p: int, q: int, out_len: int) -> jnp.ndarray:
    """step = p/q exactly: one dense product per 128 output groups.

    Reads x as (R, 128p) rows and multiplies by a constant (128p, 128q)
    lerp-weight matrix at Precision.HIGHEST: a full-f32 product, exact for
    the dyadic weights (each output is a {1-w, w} two-term sum). The lerp
    neighbor crossing each row boundary is added via a (R, 1) next-row
    column — a pure slice.
    """
    n = x.shape[-1]
    m_out = -(-out_len // q)
    R = -(-m_out // 128)
    need = R * 128 * p + 1
    pad = max(0, need - n)
    xp = jnp.pad(x, (0, pad), mode="edge") if pad else x[:need]
    if xp.shape[-1] > need:
        xp = xp[:need]
    X = xp[: R * 128 * p].reshape(R, 128 * p)
    M, cross = _rational_mats(p, q)
    out = jnp.dot(
        X, jnp.asarray(M), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if np.any(cross):
        nxt = jnp.concatenate([X[1:, :1], xp[R * 128 * p :][None]], axis=0)
        out = out + nxt * jnp.asarray(cross)
    return out.reshape(R * 128 * q)[:out_len]


def _resample_rational_slices(x: jnp.ndarray, p: int, q: int, out_len: int) -> jnp.ndarray:
    """Strided-slice formulation (kept as the parity oracle for tests).

    out[m*q + r] = x[m*p + (r*p)//q] * (1-w_r) + x[m*p + (r*p)//q + 1] * w_r
    with w_r = (r*p mod q)/q — offsets and weights constant per residue r.
    """
    n = x.shape[-1]
    m_out = -(-out_len // q)
    # Edge-pad so m*p + a_r + 1 stays in range, with clamp semantics.
    max_idx = (m_out - 1) * p + ((q - 1) * p) // q + 1
    pad = max(0, max_idx + 1 - n)
    xp = jnp.pad(x, (0, pad), mode="edge") if pad else x
    cols = []
    for r in range(q):
        a = (r * p) // q
        w = ((r * p) % q) / q
        base = jax.lax.slice(xp, (a,), (a + (m_out - 1) * p + 1,), (p,))
        if w == 0.0:
            cols.append(base)
        else:
            nxt = jax.lax.slice(xp, (a + 1,), (a + 1 + (m_out - 1) * p + 1,), (p,))
            cols.append(base * (1.0 - w) + nxt * w)
    out = jnp.stack(cols, axis=1).reshape(m_out * q)
    return out[:out_len]
