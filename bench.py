"""Throughput benchmark of the phase vocoder on the GPU.

Times the route a user gets — time_stretch (default), pitch_shift
(--pitch), the 64-utterance data-parallel batch (--batch), the
checkpointed streaming run (--checkpoint) or the chunked program over the
visible devices (--scaling) — on generated chirp + tone + noise audio, and
gates the timed output against the float64 oracle (golden/gate.py) on its
first 60 s. Prints one JSON line. Every record names the platform, device
kind and device count; timings end in block_until_ready, and the first
call (compilation included) is reported apart from the warm calls.

    python bench.py [--seconds 600] [--ratio 2.0] [--n-fft 1024 --hop 256]
    python bench.py --pitch [--semitones -7 12]
    python bench.py --batch [--batch-size 64]
    python bench.py --checkpoint
    python bench.py --scaling [--seconds-per-device 120]

It refuses to run off a GPU unless --cpu is given; a CPU run is a
rehearsal, and its times are not device metrics.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

SR = 16000
GATE_S = 60.0


def device_record(allow_cpu: bool) -> dict:
    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu" and not allow_cpu:
        sys.exit(f"bench: JAX found no GPU (platform {d0.platform!r}); "
                 "pass --cpu for a CPU rehearsal")
    return {"platform": d0.platform, "kind": d0.device_kind, "count": jax.device_count()}


def time_calls(fn, iters: int) -> tuple[float, list[float]]:
    """(first call seconds, warm call seconds), each ending in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, warm


def throughput(audio_s: float, first: float, warm: list[float]) -> dict:
    med = float(np.median(warm))
    return {"value": audio_s / med, "unit": "audio-s/s", "audio_s": audio_s,
            "first_call_s": first, "warm_s": warm, "warm_median_s": med}


def run_stretch(cfg, seconds: float, ratio: float, iters: int) -> dict:
    import jax

    from golden import gate
    from phase_vocoder import time_stretch

    x = gate.make_signal(seconds)
    xd = jax.device_put(x.astype(np.float32))
    first, warm = time_calls(lambda: time_stretch(xd, ratio, cfg), iters)
    y = np.asarray(time_stretch(xd, ratio, cfg))
    err = gate.stretch_prefix_err(y, x, ratio, cfg.n_fft, cfg.hop, int(GATE_S * SR))
    return {"metric": "stretch_audio_seconds_per_second", "stretch": ratio,
            **throughput(seconds, first, warm), "rel_err": err}


def run_pitch(cfg, seconds: float, semitones, iters: int) -> dict:
    import jax

    from golden import gate
    from phase_vocoder import pitch_shift

    x = gate.make_signal(seconds)
    xd = jax.device_put(x.astype(np.float32))
    per = {}
    for st in semitones:
        first, warm = time_calls(lambda: pitch_shift(xd, st, cfg), iters)
        y = np.asarray(pitch_shift(xd, st, cfg))
        err = gate.pitch_err(y, x, st, cfg.n_fft, cfg.hop, int(GATE_S * SR))
        per[f"{st:+g}st"] = {**throughput(seconds, first, warm), "rel_err": err}
    return {"metric": "pitch_audio_seconds_per_second", "unit": "audio-s/s",
            "semitones": per}


def run_batch(cfg, batch: int, iters: int) -> dict:
    from golden import gate
    from phase_vocoder import batch_time_stretch_varied

    rng = np.random.default_rng(0)
    lens = rng.uniform(1.0, 16.0, batch)
    xs = [gate.make_signal(s, seed=1 + i) for i, s in enumerate(lens)]
    ratios = [(0.5, 1.0, 1.5, 2.0)[i % 4] for i in range(batch)]
    first, warm = time_calls(lambda: batch_time_stretch_varied(xs, ratios, cfg), iters)
    ys = batch_time_stretch_varied(xs, ratios, cfg)
    err = max(gate.stretch_prefix_err(ys[i], xs[i], ratios[i], cfg.n_fft, cfg.hop)
              for i in range(min(4, batch)))
    rec = throughput(float(sum(len(x) for x in xs)) / SR, first, warm)
    return {"metric": "batch_audio_seconds_per_second", "utterances": batch,
            "utterances_per_s": batch / rec["warm_median_s"], **rec, "rel_err": err}


def run_checkpoint(cfg, seconds: float, ratio: float) -> dict:
    from golden import gate
    from phase_vocoder.utils.checkpoint import checkpointed_stream_time_stretch

    x = gate.make_signal(seconds)
    ckdir = tempfile.mkdtemp(prefix="pvoc_bench_ck_")
    try:
        t0 = time.perf_counter()
        y = np.asarray(checkpointed_stream_time_stretch(
            x.astype(np.float32), ratio, cfg, checkpoint_dir=ckdir))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    err = gate.stretch_prefix_err(y, x, ratio, cfg.n_fft, cfg.hop, int(GATE_S * SR))
    return {"metric": "checkpointed_audio_seconds_per_second", "value": seconds / wall,
            "unit": "audio-s/s", "stretch": ratio, "audio_s": seconds,
            "wall_s": wall, "note": "one cold run: compilation, .npz state "
            "saves and .npy part writes included", "rel_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--ratio", type=float, default=2.0)
    ap.add_argument("--n-fft", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--backend", choices=["xla", "matmul"], default=None,
                    help="FFT backend (default: PvocConfig's)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--pitch", action="store_true", help="time pitch_shift instead")
    ap.add_argument("--semitones", type=float, nargs="+",
                    default=[-12.0, -7.0, -5.0, 5.0, 7.0, 12.0])
    ap.add_argument("--batch", action="store_true",
                    help="time the ragged 64-utterance batch (BASELINE config 4)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--checkpoint", action="store_true",
                    help="time one checkpointed streaming run")
    ap.add_argument("--scaling", action="store_true",
                    help="weak scaling of the chunked program over the devices")
    ap.add_argument("--seconds-per-device", type=float, default=120.0)
    ap.add_argument("--cpu", action="store_true",
                    help="allow a CPU rehearsal (times are not device metrics)")
    args = ap.parse_args(argv)

    device = device_record(args.cpu)
    from phase_vocoder import PvocConfig
    from phase_vocoder.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = PvocConfig(n_fft=args.n_fft, hop=args.hop,
                     **({"fft_backend": args.backend} if args.backend else {}))
    if args.scaling:
        from phase_vocoder.utils.scaling import scaling_report

        rec = scaling_report(seconds_per_dev=args.seconds_per_device,
                             ratio=args.ratio, cfg=cfg)
    elif args.pitch:
        rec = run_pitch(cfg, args.seconds, args.semitones, args.iters)
    elif args.batch:
        rec = run_batch(cfg, args.batch_size, args.iters)
    elif args.checkpoint:
        rec = run_checkpoint(cfg, args.seconds, args.ratio)
    else:
        rec = run_stretch(cfg, args.seconds, args.ratio, args.iters)
    rec.update(device=device, n_fft=cfg.n_fft, hop=cfg.hop, fft_backend=cfg.fft_backend)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
