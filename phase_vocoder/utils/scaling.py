"""Scaling-efficiency harness (BASELINE.md: >=80% audio-s/s efficiency,
1 chip -> N>=2 hosts).

Measures the sequence-parallel chunked program's throughput at mesh sizes
D in {1, 2, 4, ...} and reports weak-scaling efficiency

    eff(D) = (audio_s_per_s(D) / D) / audio_s_per_s(1)

with the per-device workload held fixed (each device owns `seconds_per_dev`
of audio — the serving-relevant measure: can N chips stretch N hours in the
time one chip stretches one hour?).

Alongside the measurement, `collective_bytes_per_device` gives the
per-device communication volume of the chunked program, counted from its
shapes. On a virtual CPU mesh the timings reflect host threads, not a
device interconnect — the report labels which kind ran.

The communication inventory per device per run (parallel/chunked.py):
  input halo      ppermute   (N - Ra) * 4 B          send + recv
  phase halo      ppermute   n_bins * 4 B            send + recv
  carry totals    all_gather send 2*n_bins*4 B, recv D*2*n_bins*4 B
  anchor phase    all_gather send n_bins*4 B, recv D*n_bins*4 B
  OLA tail + norm ppermute   2 * (N - rs) * 4 B      send + recv
About 10 KB sent per device at N=1024 REGARDLESS of audio length, against
F*Ra*4 B of per-device sample I/O — the comm/compute ratio vanishes as the
recording grows.
"""

from __future__ import annotations

import time

import numpy as np


def collective_bytes_per_device(
    n_fft: int, hop: int, rs: int, d: int, dtype_bytes: int = 4
) -> dict:
    """Per-device collective bytes for one chunked-TSM run (see above)."""
    nb = n_fft // 2 + 1
    send = ((n_fft - hop) + nb + 2 * nb + nb + 2 * (n_fft - rs)) * dtype_bytes
    recv = send + (d - 1) * 3 * nb * dtype_bytes  # all_gather fan-in
    return {"send_bytes": send, "recv_bytes": recv, "n_collectives": 6}


def scaling_report(
    seconds_per_dev: float = 120.0,
    ratio: float = 2.0,
    cfg=None,
    device_counts: list[int] | None = None,
    iters: int = 3,
    sr: int = 16000,
) -> dict:
    """Measure chunked-TSM throughput at each mesh size; return the report.

    Weak scaling: the audio length grows with D (seconds_per_dev * D), so
    efficiency compares per-device throughput against the D=1 run.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ..config import PvocConfig
    from ..parallel.chunked import chunked_time_stretch

    if cfg is None:
        cfg = PvocConfig()
    rs = cfg.synthesis_hop(ratio)
    n_dev = jax.device_count()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    rows = []
    base_per_dev = None
    for d in device_counts:
        mesh = Mesh(np.array(jax.devices()[:d]), ("seq",))
        seconds = seconds_per_dev * d
        rng = np.random.default_rng(0)
        t = np.arange(int(seconds * sr)) / sr
        x_np = (
            0.5 * np.sin(2 * np.pi * 440.0 * t)
            + 0.3 * np.sin(2 * np.pi * (200.0 * t + 4.0 * t * t))
            + 0.05 * rng.standard_normal(len(t))
        ).astype(np.float32)
        x = jax.device_put(jnp.asarray(x_np))

        fn = jax.jit(
            lambda a, _mesh=mesh: jnp.sum(
                chunked_time_stretch(a, ratio, cfg, mesh=_mesh)
            )
        )
        float(fn(x))  # warmup/compile
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            float(fn(x))
            times.append(time.perf_counter() - t0)
        best = min(times)
        aps = seconds / best
        per_dev = aps / d
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append(
            {
                "devices": d,
                "audio_seconds": seconds,
                "wall_s_best": round(best, 4),
                "audio_s_per_s": round(aps, 1),
                "audio_s_per_s_per_device": round(per_dev, 1),
                "efficiency": round(per_dev / base_per_dev, 4),
                **collective_bytes_per_device(cfg.n_fft, cfg.hop, rs, d),
            }
        )

    dev0 = jax.devices()[0]
    return {
        "metric": "scaling_efficiency_weak",
        "mode": "weak (audio grows with D; per-device load fixed)",
        "ratio": ratio,
        "seconds_per_device": seconds_per_dev,
        "device_kind": str(dev0.device_kind if hasattr(dev0, "device_kind") else dev0),
        "platform": jax.default_backend(),
        "virtual_mesh": jax.default_backend() == "cpu",
        "rows": rows,
        "efficiency_at_max": rows[-1]["efficiency"] if rows else None,
        "note": (
            "virtual CPU mesh: all D 'devices' share one host's cores, so "
            "weak-scaling efficiency is ~1/D by construction and says "
            "nothing about a device interconnect"
            if jax.default_backend() == "cpu"
            else "real multi-device mesh: efficiency is directly measured"
        ),
    }
