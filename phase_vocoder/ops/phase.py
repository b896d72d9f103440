"""Phase unwrapping and synthesis-phase accumulation (components C7-C9).

The reference implements phase unwrap + accumulation as ONE THREAD PER BIN
with a serial loop over frames (SURVEY.md SS2.1 C8) — only ~513 live threads.
Here the psi recurrence is a plain prefix sum
(psi = phi[0] + cumsum(Rs * IF), proven in tests/test_golden.py), so it
becomes a log-depth associative scan over the frame axis, fully parallel
over bins.

Two accumulation methods:

  * "cumsum" — the literal prefix sum. Bit-matches the golden recurrence but
    the running phase grows linearly with audio length (up to ~Rs*pi rad per
    frame), so float32 loses absolute precision beyond ~1e5 frames.

  * "wrapped_scan" — numerically exact for arbitrary length. Only
    psi mod 2*pi matters (psi feeds e^{i*psi}), and addition mod 2*pi is
    associative, so:
      psi_i mod 2pi = wrap( phi_0                                 (small)
                          + 2pi * ((i * (Rs*k mod N)) mod N) / N   (exact int)
                          + wrap(sum_{j<i} (Rs/Ra) * dphi_j) )     (assoc scan
                                                                    of wrapped
                                                                    partials)
    The linear term i*Rs*omega_k is evaluated in integer arithmetic modulo N
    (exact — no float drift ever), and the scan's partial sums stay in
    (-pi, pi] so f32 precision is independent of audio length. This is the
    foundation for the cross-device phase-state carry in parallel/chunked.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 6.283185307179586

# Split representation of 2*pi for EXACT wrapping in f32. f32(2*pi) sits
# 1.748e-7 ABOVE the true value, so every princarg wrap event that
# subtracts it injects a -1.748e-7 rad bias. For sweeping content (a chirp
# moving through a bin) wrap events have a systematic sign, so the bias
# accumulates LINEARLY in the phase-residual sum: measured 5.4e-3 waveform
# rel err at 600 s / 2.0x on the streaming polar path. Wrapping
# with the (hi, lo) pair makes each wrap exact to ~f64: n*hi is exact for
# the small n here, and n*lo restores the 1.748e-7 residue.
_TWO_PI_HI = 6.2831854820251465  # == float(np.float32(2*pi))
_TWO_PI_LO = TWO_PI - _TWO_PI_HI  # ~ -1.7484556e-7


def princarg(x: jnp.ndarray) -> jnp.ndarray:
    """Principal argument: wrap phase to (-pi, pi]. Matches golden princarg.

    Exact split-constant wrap (see _TWO_PI_HI note): result is x - 2*pi*n
    with the 2*pi multiple applied to ~f64 accuracy, so repeated wrapping
    (the phase-residual scan) carries no systematic 2*pi-representation
    bias. n = ceil(x/2pi - 1/2) puts the result in (-pi, pi], matching
    golden/pv_ref.py's `pi - mod(pi - x, 2*pi)` on both boundaries.
    """
    hi = jnp.asarray(_TWO_PI_HI, dtype=x.dtype)
    lo = jnp.asarray(_TWO_PI_LO, dtype=x.dtype)
    n = jnp.ceil(x * (1.0 / TWO_PI) - 0.5)
    return (x - n * hi) - n * lo


def wrap_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Associative addition modulo 2*pi, result in (-pi, pi]."""
    return princarg(a + b)


def _het_split(ra: int, n_fft: int, n_bins: int):
    """Heterodyne constants Ra*omega_k mod 2*pi as an (hi, lo) f32 pair.

    The f32 rounding of 2*pi*((k*Ra) % N)/N is up to 2.4e-7 rad and is
    subtracted from EVERY frame's increment with the same sign per bin — a
    linear-in-length bias in the residual sum (the other half of the
    drift documented at _TWO_PI_HI). hi is the f32 constant; lo is the f64
    remainder, re-applied after the wrap.
    """
    import numpy as np

    m = (np.arange(n_bins) * ra) % n_fft
    het = (TWO_PI / n_fft) * m  # f64
    hi = het.astype(np.float32)
    lo = (het - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def heterodyne_increment(phi: jnp.ndarray, ra: int, n_fft: int) -> jnp.ndarray:
    """Wrapped heterodyned phase increment dphi (nf-1, n_bins).

    dphi[i,k] = princarg(phi[i+1,k] - phi[i,k] - Ra*omega_k). The expected
    advance Ra*omega_k is pre-reduced mod 2*pi via exact integer arithmetic
    ((k*Ra) mod N), applied as a split (hi, lo) constant so the f32
    rounding of the constant does not bias every frame (see _het_split).
    The result may overshoot (-pi, pi] by ~2e-7 — harmless downstream
    (it feeds a scaled re-wrap or e^{i psi}).
    """
    n_bins = phi.shape[-1]
    hi, lo = _het_split(ra, n_fft, n_bins)
    return princarg(phi[1:] - phi[:-1] - hi.astype(phi.dtype)) - lo.astype(phi.dtype)


def instantaneous_frequency(dphi: jnp.ndarray, ra: int, n_fft: int) -> jnp.ndarray:
    """IF[i,k] = omega_k + dphi[i,k]/Ra, rad/sample (diagnostic/API parity)."""
    n_bins = dphi.shape[-1]
    k = jnp.arange(n_bins, dtype=dphi.dtype)
    omega = (TWO_PI / n_fft) * k
    return omega + dphi / ra


def accumulate_phase(
    phi: jnp.ndarray,
    dphi: jnp.ndarray,
    ra: int,
    rs: int,
    n_fft: int,
    method: str = "wrapped_scan",
    frame_offset: int = 0,
) -> jnp.ndarray:
    """Synthesis phase psi (nf, n_bins) for spectrum rebuild Y = mag*e^{i psi}.

    psi[0] = phi[0]; psi[i] = psi[i-1] + Rs*(omega + dphi[i-1]/Ra).
    Returned wrapped to (-pi, pi] for "wrapped_scan", unwrapped for "cumsum"
    (only e^{i psi} is consumed downstream, so both are equivalent).

    frame_offset: global index of frame 0 (used by the sequence-parallel
    path so the exact integer linear term stays globally consistent).
    """
    nf, n_bins = phi.shape
    dtype = phi.dtype
    if method == "cumsum":
        k = jnp.arange(n_bins, dtype=dtype)
        omega = (TWO_PI / n_fft) * k
        steps = rs * (omega + dphi / ra)  # (nf-1, n_bins)
        zero = jnp.zeros((1, n_bins), dtype=dtype)
        psi = phi[0] + jnp.concatenate([zero, jnp.cumsum(steps, axis=0)])
    elif method == "wrapped_scan":
        # Compensated pair arithmetic straight from phi (see the double-f32
        # note above); dphi is ignored here — its f32 rounding is exactly
        # the bias the pairs exist to avoid.
        th, tl = residual_terms_c(phi, ra, rs, n_fft)
        rh, rl = blocked_scan(wrap_add_c, (th, tl))
        zero = jnp.zeros((1, n_bins), dtype=dtype)
        residual = jnp.concatenate([zero, rh + rl])
        psi = finalize_phase(phi[0], residual, rs, n_fft, frame_offset)
    else:
        raise ValueError(f"unknown phase method {method!r}")
    return pin_real_bins(psi, phi, rs, n_fft, frame_offset)


def pin_real_bins(
    psi: jnp.ndarray, phi: jnp.ndarray, rs: int, n_fft: int, frame_offset: int = 0
) -> jnp.ndarray:
    """Deterministic convention for the forced-real DC/Nyquist bins.

    Their spectrum phase is exactly 0 or pi, so the heterodyned increment
    sits exactly on the princarg branch point every frame — accumulating it
    is chaotic under any precision change. Instead: per-frame analysis-phase
    pass-through plus the exact integer-arithmetic linear rotation
    i*Rs*omega_k (an integer multiple of pi at these bins). Keeps identity
    resynthesis exact; mirrors golden/pv_ref.py.
    """
    nf, n_bins = psi.shape
    psi = psi.at[:, 0].set(phi[:, 0])
    if n_fft % 2 == 0 and n_bins == n_fft // 2 + 1:
        off = jnp.asarray(frame_offset, jnp.int32) % n_fft
        i = (jnp.arange(nf, dtype=jnp.int32) + off) % n_fft
        kr = jnp.int32((rs * (n_fft // 2)) % n_fft)
        lin = (TWO_PI / n_fft) * ((i * kr) % n_fft).astype(psi.dtype)
        psi = psi.at[:, -1].set(phi[:, -1] + lin)
    return psi


# ---------------------------------------------------------------------------
# Compensated (double-f32) residual accumulation.
#
# Angle-domain f32 cannot hold the 1e-4 waveform gate beyond a few minutes
# of TONAL audio: a stationary pitch is exactly periodic in frames (440 Hz
# at 16 kHz / hop 256 repeats every 25 frames), so the f32 rounding errors
# of phi[i+1]-phi[i]-het REPEAT with the same sign pattern and integrate
# LINEARLY into the residual sum — measured ~2e-7 rad/frame on the 440 Hz
# bins (2e-3 rad at 10 min), identical mechanism to a biased random walk
# with period-locked increments. The golden f64 model has the same bias at
# 2^-29 scale. Fix: carry every term and partial sum as an UNEVALUATED
# (hi, lo) f32 pair (TwoSum/Dekker arithmetic, ~2^-48 effective precision)
# so the bias floor sits far below the gate at any audio length. All ops
# stay f32; the cost is a few extra elementwise ops per element.
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


# f32(2*pi) split into two 11-bit-mantissa halves so n * _HI12A/_HI12B are
# exact for |n| up to ~2^11 (wrap multiples here are tiny integers).
import numpy as _np

_HI12A = float(_np.float32(_np.trunc(_TWO_PI_HI * 2048.0) / 2048.0))
_HI12B = float(_np.float32(_TWO_PI_HI - _HI12A))


def _wrap_pair(h, l):
    """Wrap an (h, l) pair to (-pi, pi] exactly: subtracts n*2pi with the
    multiple applied in three exact pieces, then renormalizes."""
    n = jnp.ceil(h * (1.0 / TWO_PI) - 0.5)
    s, e1 = _two_sum(h, -n * jnp.asarray(_HI12A, h.dtype))
    s, e2 = _two_sum(s, -n * jnp.asarray(_HI12B, h.dtype))
    l = l + (e1 + e2) - n * jnp.asarray(_TWO_PI_LO, h.dtype)
    return _two_sum(s, l)


def wrap_add_c(a, b):
    """Pair-compensated associative addition mod 2*pi: a, b = (hi, lo)."""
    ah, al = a
    bh, bl = b
    s, e = _two_sum(ah, bh)
    return _wrap_pair(s, al + bl + e)


def _scale_pair(rs: int, ra: int, h, l):
    """(rs/ra) * (h + l) as a compensated pair, exact for ANY rs, ra.

    Full Dekker two-product: the f32 scale k32 = fl(rs/ra) is pre-split
    into 12+12 mantissa-bit halves on the host and h is split in-kernel, so
    every partial product is exact; the f64 representation residue
    k_err = rs/ra - k32 (nonzero when ra is not a power of two) is folded
    into the lo word. No precondition on hop or stretch remains (round-2
    advisor finding: the old 12-bit shortcut silently biased non-pow2 hops).
    """
    k64 = rs / ra
    k32 = _np.float32(k64)
    kc = _np.float32(_np.float32(4097.0) * k32)
    k_hi = _np.float32(kc - _np.float32(kc - k32))
    k_lo = _np.float32(k32 - k_hi)
    k = jnp.asarray(float(k32), h.dtype)
    p = k * h
    c = jnp.asarray(4097.0, h.dtype) * h
    h_hi = c - (c - h)
    h_lo = h - h_hi
    kh, kl = jnp.asarray(float(k_hi), h.dtype), jnp.asarray(float(k_lo), h.dtype)
    err = ((kh * h_hi - p) + kh * h_lo + kl * h_hi) + kl * h_lo
    k_err = jnp.asarray(float(k64 - float(k32)), h.dtype)
    return p, k * l + err + k_err * h


def residual_terms_c(phi_ext: jnp.ndarray, ra: int, rs: int, n_fft: int):
    """Compensated scan terms ((F, nb) hi, lo) from phases (F+1, nb).

    term[j] = wrap((rs/ra) * wrap(phi[j+1] - phi[j] - Ra*omega_k)) carried
    as an exact pair: the only unrecoverable error left is the f32 atan2
    rounding inside phi itself, which TELESCOPES across the residual sum
    (each phi enters adjacent terms with opposite signs) and so stays
    bounded at any length.
    """
    n_bins = phi_ext.shape[-1]
    hi, lo = _het_split(ra, n_fft, n_bins)
    d, e1 = _two_sum(phi_ext[1:], -phi_ext[:-1])
    d, e2 = _two_sum(d, -hi.astype(phi_ext.dtype))
    h, l = _wrap_pair(d, (e1 + e2) - lo.astype(phi_ext.dtype))
    return _wrap_pair(*_scale_pair(rs, ra, h, l))


def zero_pair(n_bins: int, dtype=jnp.float32):
    """Identity element for wrap_add_c (the carry's initial value)."""
    z = jnp.zeros((n_bins,), dtype)
    return z, z


def pair_value(pair):
    """Collapse an (hi, lo) pair to plain f32 (for e^{i psi} consumption)."""
    return pair[0] + pair[1]


def blocked_scan(fn, terms, block: int = 1024):
    """Inclusive associative scan over axis 0 with bounded compile cost.

    jax.lax.associative_scan at non-power-of-two lengths can make XLA's
    compile time pathological (a 186 s compile at 3749 rows against 1.1 s
    at 4096 was seen on an earlier backend). This pads to B full
    power-of-two blocks of `block` rows, scans
    within blocks, scans the B block totals, and broadcasts the exclusive
    block prefix back — same O(log) depth, compile cost independent of
    length. `fn` must be associative with 0 as identity under padding
    (wrap_add, wrap_add_c, and plain add all qualify: padded rows are zeros
    and their results are sliced off). `terms` may be a pytree (e.g. the
    compensated (hi, lo) pair) whose leaves share the leading axis.
    """
    tmap = jax.tree_util.tree_map
    leaves = jax.tree_util.tree_leaves(terms)
    nf = leaves[0].shape[0]

    def pad_to(t, rows):
        return tmap(
            lambda a: jnp.pad(a, ((0, rows - nf),) + ((0, 0),) * (a.ndim - 1)),
            t,
        )

    if nf <= block:
        # Pad to the next power of two; tiny lengths stay single-level.
        p = 1
        while p < nf:
            p *= 2
        tp = pad_to(terms, p)
        out = jax.lax.associative_scan(fn, tp, axis=0)
        return tmap(lambda a: a[:nf], out)
    nb = -(-nf // block)
    tp = pad_to(terms, nb * block)
    tp = tmap(lambda a: a.reshape((nb, block) + a.shape[1:]), tp)
    incl = jax.lax.associative_scan(fn, tp, axis=1)
    totals = tmap(lambda a: a[:, -1], incl)
    prefix = jax.lax.associative_scan(fn, totals, axis=0)
    excl = tmap(
        lambda a: jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]]), prefix
    )
    out = fn(tmap(lambda a: jnp.expand_dims(a, 1), excl), incl)
    return tmap(lambda a: a.reshape((nb * block,) + a.shape[2:])[:nf], out)


def accumulate_phase_residual(dphi: jnp.ndarray, ra: int, rs: int) -> jnp.ndarray:
    """Wrapped exclusive prefix sum of the residual terms (Rs/Ra)*dphi.

    Returns (nf, n_bins): residual[i] = wrap(sum_{j<i} (Rs/Ra)*dphi[j]).
    Split out so the chunked/sequence-parallel path can compute per-chunk
    residuals locally and combine cross-chunk carries with wrap_add.
    """
    scale = jnp.asarray(rs / ra, dtype=dphi.dtype)
    terms = princarg(scale * dphi)  # pre-wrap each term: mod is homomorphic
    zero = jnp.zeros((1, terms.shape[-1]), dtype=terms.dtype)
    inclusive = blocked_scan(wrap_add, terms)
    return jnp.concatenate([zero, inclusive])


def linear_phase_term(
    nf: int, n_bins: int, rs: int, n_fft: int, frame_offset: int = 0, dtype=jnp.float32
) -> jnp.ndarray:
    """Exact (mod 2*pi) linear phase i*Rs*omega_k, via integer arithmetic.

    i*Rs*2pi*k/N mod 2pi == 2pi * ((i mod N) * ((Rs*k) mod N) mod N) / N.
    All intermediates fit int32 for any audio length.
    """
    off = jnp.asarray(frame_offset, jnp.int32) % n_fft  # python int or traced
    i = (jnp.arange(nf, dtype=jnp.int32) + off) % n_fft
    k = jnp.arange(n_bins, dtype=jnp.int32)
    kr = (k * jnp.int32(rs % n_fft)) % n_fft  # (n_bins,)
    grid = (i[:, None] * kr[None, :]) % n_fft  # (nf, n_bins), < N^2 < 2^31
    return (TWO_PI / n_fft) * grid.astype(dtype)


def finalize_phase(
    phi0: jnp.ndarray,
    residual: jnp.ndarray,
    rs: int,
    n_fft: int,
    frame_offset: int = 0,
) -> jnp.ndarray:
    """psi (wrapped) = wrap(phi0 + exact linear term + wrapped residual)."""
    nf, n_bins = residual.shape
    linear = linear_phase_term(
        nf, n_bins, rs, n_fft, frame_offset=frame_offset, dtype=residual.dtype
    )
    return princarg(phi0[None, :] + linear + residual)
