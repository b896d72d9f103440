"""Smoke test of the main path on the GPU, in one process.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the multi-device path only

One GPU, at the project's operating point (16 kHz mono, N=1024, hop 256):

  1. device     platform, count and kind; the card's name and power limit
  2. stretch    time_stretch on 600 s at 0.5x, 1x, 1.5x and 2x
  3. hour       time_stretch at 2x on 3,600 s
  4. pitch      pitch_shift at -12, -7, -5, +7 and +12 st on 60 s
  5. batch      64 utterances of 1-16 s through batch_time_stretch_varied
  6. cli        `pvoc stretch --float32`, plain and with --checkpoint-dir
  7. transforms rfft/irfft (both backends) at N = 512, 1024, 2048, and the
                resampler, against numpy in float64

With --four: chunked_time_stretch over a 4-device "seq" mesh on 3,600 s at
2x and 0.5x, batched_chunked_time_stretch on a 2x2 mesh, and the
64-utterance batch on a 4-device "data" mesh, each compared with one
device.

Every waveform is compared with the float64 oracle (golden/pv_ref.py) on
the interior, below 1e-4 relative; long runs on their first 60 s (see
golden/gate.py). Each phase prints one line; the last line of the output
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Any failed check raises, so the script exits non-zero and prints no
result; it also refuses to run when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR, N_FFT, HOP = 16000, 1024, 256
PREFIX_S = 60.0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_waveform(y, expected_len: int, what: str) -> np.ndarray:
    y = np.asarray(y)
    require(y.shape == (expected_len,), f"{what}: shape {y.shape}, want ({expected_len},)")
    require(bool(np.all(np.isfinite(y))), f"{what}: non-finite samples")
    return y


def gated(err: float, what: str, tol: float | None = None) -> float:
    from golden import gate

    tol = gate.GATE if tol is None else tol
    require(err < tol, f"{what}: rel err {err:.3e} >= {tol:.0e}")
    return err


def timed(fn):
    """(result, seconds) of fn() with the result fetched to the host."""
    t0 = time.perf_counter()
    out = np.asarray(fn())
    return out, time.perf_counter() - t0


def warm_seconds(fn) -> float:
    """Wall time of a second call, ending in block_until_ready."""
    t0 = time.perf_counter()
    fn().block_until_ready()
    return time.perf_counter() - t0


# ---------------------------------------------------------------- phases


def phase_device(expect_count: int) -> dict:
    """Refuse anything but a GPU; print the card's name and power limit."""
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {d0.platform!r})")
    require(len(devs) >= expect_count, f"need {expect_count} GPUs, have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    info = {"platform": d0.platform, "kind": d0.device_kind, "count": len(devs)}
    log(f"device: {info}")
    return info


def phase_stretch(x, stretches=(0.5, 1.0, 1.5, 2.0), cfg=None, prefix_s=PREFIX_S,
                  name="stretch") -> list[dict]:
    import jax

    from golden import gate
    from phase_vocoder import PvocConfig, stretch_output_length, time_stretch

    cfg = cfg or PvocConfig()
    xd = jax.device_put(np.asarray(x, np.float32))
    rows = []
    for s in stretches:
        y, first = timed(lambda: time_stretch(xd, s, cfg))
        y = check_waveform(y, stretch_output_length(len(x), cfg, s), f"{name} {s}x")
        warm = warm_seconds(lambda: time_stretch(xd, s, cfg))
        err = gated(
            gate.stretch_prefix_err(y, x, s, cfg.n_fft, cfg.hop, int(prefix_s * SR)),
            f"{name} {s}x",
        )
        row = {"stretch": s, "audio_s": len(x) / SR, "first_call_s": first,
               "warm_s": warm, "audio_s_per_s": len(x) / SR / warm, "rel_err": err}
        log(f"{name} {s}x on {len(x) / SR:g} s: first call {first:.3f} s, warm "
            f"{warm:.4f} s ({row['audio_s_per_s']:.0f} audio-s/s), "
            f"rel err {err:.2e} on the first {prefix_s:g} s")
        rows.append(row)
    return rows


def phase_pitch(x, semitones=(-12.0, -7.0, -5.0, 7.0, 12.0), cfg=None) -> list[dict]:
    import jax

    from golden import gate
    from phase_vocoder import PvocConfig, pitch_shift, stretch_output_length

    cfg = cfg or PvocConfig()
    xd = jax.device_put(np.asarray(x, np.float32))
    rows = []
    for st in semitones:
        y, first = timed(lambda: pitch_shift(xd, st, cfg))
        # Duration is kept up to the synthesis hop's rounding of 2^(st/12).
        factor = 2.0 ** (st / 12.0)
        want = int(round(stretch_output_length(len(x), cfg, factor) / factor))
        check_waveform(y, want, f"pitch {st:+g}")
        err = gated(gate.pitch_err(y, x, st, cfg.n_fft, cfg.hop), f"pitch {st:+g} st")
        log(f"pitch {st:+g} st on {len(x) / SR:g} s: first call {first:.3f} s, "
            f"rel err {err:.2e}")
        rows.append({"semitones": st, "first_call_s": first, "rel_err": err})
    return rows


def utterances(n: int, lo_s: float, hi_s: float, ratios, seed: int):
    from golden import gate

    rng = np.random.default_rng(seed)
    lens = rng.uniform(lo_s, hi_s, n)
    xs = [gate.make_signal(s, seed=seed + 1 + i) for i, s in enumerate(lens)]
    return xs, [ratios[i % len(ratios)] for i in range(n)]


def phase_batch(n=64, lo_s=1.0, hi_s=16.0, ratios=(0.5, 1.0, 1.5, 2.0),
                check_rows=(0, 21, 42, 63), seed=0, cfg=None) -> dict:
    from golden import gate
    from phase_vocoder import PvocConfig, batch_time_stretch_varied, stretch_output_length

    cfg = cfg or PvocConfig()
    xs, rs = utterances(n, lo_s, hi_s, ratios, seed)
    ys, first = timed_list(lambda: batch_time_stretch_varied(xs, rs, cfg))
    for i, (x, r, y) in enumerate(zip(xs, rs, ys)):
        check_waveform(y, stretch_output_length(len(x), cfg, r), f"batch row {i}")
    errs = {}
    for i in check_rows:
        errs[i] = gated(gate.stretch_prefix_err(ys[i], xs[i], rs[i], cfg.n_fft, cfg.hop),
                        f"batch row {i} ({rs[i]}x)")
    audio = sum(len(x) for x in xs) / SR
    log(f"batch {n} utterances ({audio:.1f} audio-s, ratios {sorted(set(rs))}): "
        f"first call {first:.3f} s, rel err "
        + ", ".join(f"row {i} {rs[i]}x {e:.2e}" for i, e in errs.items()))
    return {"utterances": n, "audio_s": audio, "first_call_s": first, "rel_err": errs}


def timed_list(fn):
    t0 = time.perf_counter()
    out = [np.asarray(y) for y in fn()]
    return out, time.perf_counter() - t0


def phase_cli(x, stretch=2.0, segment_frames=None) -> dict:
    from golden import gate
    from phase_vocoder import cli
    from phase_vocoder.io.wav import read_wav, write_wav

    errs = {}
    with tempfile.TemporaryDirectory(prefix="pvoc_smoke_") as tmp:
        src = os.path.join(tmp, "in.wav")
        write_wav(src, np.asarray(x, np.float32), SR, pcm16=False)
        xr, _ = read_wav(src)
        runs = {"plain": [], "checkpointed": ["--checkpoint-dir", os.path.join(tmp, "ck")]}
        if segment_frames:
            runs["checkpointed"] += ["--segment-frames", str(segment_frames)]
        for name, extra in runs.items():
            out = os.path.join(tmp, f"{name}.wav")
            rc = cli.main(["stretch", src, out, "--ratio", str(stretch), "--float32", *extra])
            require(rc == 0, f"cli {name}: exit code {rc}")
            y, sr = read_wav(out)
            require(sr == SR, f"cli {name}: sample rate {sr}")
            errs[name] = gated(
                gate.stretch_prefix_err(y, xr, stretch, N_FFT, HOP), f"cli {name}"
            )
    log(f"cli stretch {stretch}x on {len(x) / SR:g} s WAV: rel err "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_transforms(sizes=(512, 1024, 2048), frames=512, seconds=PREFIX_S,
                     semitones=(-12, -7, -5, 5, 7, 12), seed=0) -> dict:
    import jax.numpy as jnp

    from golden import gate, pv_ref
    from phase_vocoder.ops import fft as fft_ops
    from phase_vocoder.ops.resample import resample_linear

    tol = 1e-5
    rng = np.random.default_rng(seed)
    out = {}
    for n in sizes:
        f64 = rng.standard_normal((frames, n))
        ref = np.fft.rfft(f64, axis=-1)
        scale = np.max(np.abs(ref))
        noise = rng.standard_normal(ref.shape) + 1j * rng.standard_normal(ref.shape)
        spec = ref + 0.1 * scale * noise
        spec[:, 0] = spec[:, 0].real
        spec[:, -1] = spec[:, -1].real
        iref = np.fft.irfft(spec, n=n, axis=-1)
        for backend in ("xla", "matmul"):
            re, im = fft_ops.rfft(jnp.asarray(f64, jnp.float32), backend=backend)
            fwd = max(np.max(np.abs(np.asarray(re) - ref.real)),
                      np.max(np.abs(np.asarray(im) - ref.imag))) / scale
            inv = np.asarray(fft_ops.irfft(
                jnp.asarray(spec.real, jnp.float32), jnp.asarray(spec.imag, jnp.float32),
                n, backend=backend))
            inv_err = np.max(np.abs(inv - iref)) / np.max(np.abs(iref))
            precision = ("XLA FFT op, float32" if backend == "xla"
                         else "float32 matmul, Precision.HIGHEST")
            gated(fwd, f"rfft {backend} N={n}", tol)
            gated(inv_err, f"irfft {backend} N={n}", tol)
            out[f"{backend}_{n}"] = {"rfft": fwd, "irfft": inv_err}
            log(f"transform {backend} N={n} ({precision}): rfft {fwd:.2e}, "
                f"irfft {inv_err:.2e}, tolerance {tol:.0e}")
    x64 = gate.make_signal(seconds, seed=seed)
    x32 = jnp.asarray(x64, jnp.float32)
    for st in semitones:
        factor = 1.0 / 2.0 ** (st / 12.0)  # what pitch_shift passes
        out_len = int(round(len(x64) * factor))
        ours = np.asarray(resample_linear(x32, factor, out_len), np.float64)
        err = float(np.max(np.abs(ours - pv_ref.resample_linear(x64, factor, out_len))))
        gated(err, f"resample {st:+d} st", 2e-6)
        out[f"resample_{st:+d}"] = err
        log(f"resample {st:+d} st on {seconds:g} s (float32, gather or exact "
            f"rational product): max abs err {err:.2e}, tolerance 2e-06")
    return out


# ------------------------------------------------------- four devices


def compare_to_one_device(y, one, stretch: float, cfg, prefix_s: float, what: str) -> dict:
    """Gate a multi-device output against the one-device result.

    For an integer hop ratio the two agree to float rounding at any length.
    For q >= 2 (0.5x, 1.5x) on branch-dense content — this signal's chirp
    aliases every ~10 s — a last-bit difference (another cuFFT plan, another
    scan order) can move one princarg branch decision in a bin at the noise
    floor, which flips that bin's synthesis phase by pi from then on: the
    f64 oracle itself moves by 0.24 under a 1e-7 input perturbation at
    600 s. So for q >= 2 the strict gate covers the first prefix_s (where
    the oracle is checked too); over the full length the difference, the
    correlation and the first sample past the gate are reported, and the
    correlation must show the same waveform.
    """
    from golden import gate
    from phase_vocoder import stretch_output_length

    n = cfg.n_fft
    full = gate.interior_rel_err(y, one, n)
    sl = slice(n, len(one) - n)
    diff = np.abs(np.asarray(y, np.float64)[sl] - np.asarray(one, np.float64)[sl])
    over = np.flatnonzero(diff >= gate.GATE * np.max(np.abs(one[sl])))
    out = {"full": full, "corr": float(np.corrcoef(y[sl], one[sl])[0, 1]),
           "first_over_s": None if over.size == 0 else float((over[0] + n) / SR / stretch)}
    if cfg.synthesis_hop(stretch) % cfg.hop == 0:
        gated(full, what)
        return out
    head = stretch_output_length(int(prefix_s * SR), cfg, stretch)
    out["head"] = gated(gate.interior_rel_err(y[:head], one[:head], n),
                        f"{what} (first {prefix_s:g} s)")
    require(out["corr"] > 0.9, f"{what}: correlation {out['corr']:.4f}")
    return out


def peak_bytes(devices) -> list[int]:
    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0)) for d in devices]


def phase_four_chunked(x, stretches=(2.0, 0.5), cfg=None, prefix_s=PREFIX_S,
                       n_devices=4) -> list[dict]:
    import jax

    from golden import gate
    from phase_vocoder import PvocConfig, chunked_time_stretch, make_mesh, time_stretch

    cfg = cfg or PvocConfig()
    devs = jax.devices()[:n_devices]
    mesh = make_mesh(n_devices, axis="seq")
    xd = jax.device_put(np.asarray(x, np.float32), devs[0])
    rows = []
    for s in stretches:
        y, first = timed(lambda: chunked_time_stretch(xd, s, cfg, mesh=mesh))
        warm = warm_seconds(lambda: chunked_time_stretch(xd, s, cfg, mesh=mesh))
        one, _ = timed(lambda: time_stretch(xd, s, cfg))
        y = check_waveform(y, len(one), f"chunked {s}x")
        err = gated(gate.stretch_prefix_err(y, x, s, cfg.n_fft, cfg.hop, int(prefix_s * SR)),
                    f"chunked {s}x")
        log(f"chunked {s}x over {n_devices} devices on {len(x) / SR:g} s: first call "
            f"{first:.3f} s, warm {warm:.4f} s ({len(x) / SR / warm:.0f} audio-s/s), "
            f"rel err {err:.2e} on the first {prefix_s:g} s")
        vs_one = compare_to_one_device(y, one, s, cfg, prefix_s, f"chunked {s}x vs one device")
        log(f"chunked {s}x vs one device: {vs_one}")
        rows.append({"stretch": s, "warm_s": warm, "vs_one_device": vs_one, "rel_err": err})
    peaks = peak_bytes(devs)
    if devs[0].platform == "gpu":  # the CPU backend keeps no memory stats
        require(min(peaks) > 0.05 * max(peaks), f"chunked work not spread: peak bytes {peaks}")
    log(f"chunked peak bytes per device: {peaks}")
    return rows


def phase_four_batched_chunked(seconds=600.0, stretch=2.0, cfg=None, seed=0,
                               prefix_s=PREFIX_S) -> dict:
    import jax

    from golden import gate
    from phase_vocoder import PvocConfig, make_mesh_2d, time_stretch
    from phase_vocoder.parallel.chunked import batched_chunked_time_stretch

    cfg = cfg or PvocConfig()
    xs = np.stack([gate.make_signal(seconds, seed=seed + i) for i in range(2)])
    mesh = make_mesh_2d(2, 2)
    ys, first = timed(lambda: batched_chunked_time_stretch(xs, stretch, cfg, mesh=mesh))
    errs = []
    for i in range(2):
        one = np.asarray(time_stretch(jax.device_put(xs[i].astype(np.float32),
                                                     jax.devices()[0]), stretch, cfg))
        y = check_waveform(ys[i], len(one), f"batched chunked row {i}")
        vs_one = gated(gate.interior_rel_err(y, one, cfg.n_fft),
                       f"batched chunked row {i} vs one device")
        err = gated(gate.stretch_prefix_err(y, xs[i], stretch, cfg.n_fft, cfg.hop,
                                            int(prefix_s * SR)), f"batched chunked row {i}")
        errs.append({"vs_one_device": vs_one, "rel_err": err})
    log(f"batched chunked {stretch}x, 2 x {seconds:g} s on a 2x2 mesh: first call "
        f"{first:.3f} s, " + ", ".join(
            f"row {i} vs one device {e['vs_one_device']:.2e} rel err {e['rel_err']:.2e}"
            for i, e in enumerate(errs)))
    return {"first_call_s": first, "rows": errs}


def phase_four_batch(n=64, lo_s=1.0, hi_s=16.0, ratios=(0.5, 1.0, 1.5, 2.0), seed=0,
                     cfg=None, n_devices=4) -> dict:
    from golden import gate
    from phase_vocoder import PvocConfig, batch_time_stretch_varied, make_mesh
    from phase_vocoder.parallel.batch import batch_time_stretch_rs

    cfg = cfg or PvocConfig()
    xs, rs = utterances(n, lo_s, hi_s, ratios, seed)
    mesh = make_mesh(n_devices, axis="data")
    ys, first = timed_list(lambda: batch_time_stretch_varied(xs, rs, cfg, mesh=mesh))
    ones = batch_time_stretch_varied(xs, rs, cfg)
    worst = max(gate.interior_rel_err(y, np.asarray(o), cfg.n_fft) for y, o in zip(ys, ones))
    gated(worst, "batch over 4 devices vs one device")
    probe = batch_time_stretch_rs(np.stack([x[: int(lo_s * SR)] for x in xs]),
                                  cfg.synthesis_hop(2.0), cfg, mesh=mesh)
    spread = len(probe.sharding.device_set)
    require(spread == n_devices, f"batch output on {spread} devices, want {n_devices}")
    log(f"batch {n} utterances over {n_devices} devices ('data' mesh): first call "
        f"{first:.3f} s, worst row vs one device {worst:.2e}, output on {spread} devices")
    return {"first_call_s": first, "vs_one_device": worst}


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device path (needs four GPUs)")
    ap.add_argument("--seed", type=int, default=0, help="seed of every signal")
    args = ap.parse_args(argv)

    device = phase_device(4 if args.four else 1)

    from golden import gate
    from phase_vocoder.utils.cache import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    t0 = time.perf_counter()
    hour = gate.make_signal(3600.0, seed=args.seed)
    if args.four:
        phase_four_chunked(hour)
        phase_four_batched_chunked(seed=args.seed)
        phase_four_batch(seed=args.seed)
    else:
        phase_stretch(hour[: int(600 * SR)])
        phase_stretch(hour, stretches=(2.0,), name="hour")
        minute = hour[: int(PREFIX_S * SR)]
        phase_pitch(minute)
        phase_batch(seed=args.seed)
        phase_cli(minute)
        phase_transforms(seed=args.seed)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
