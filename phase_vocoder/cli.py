"""Command-line front-end (reference component C1 — SURVEY.md SS2.1).

The reference is a batch CLI: input WAV, output WAV, stretch ratio /
semitones, FFT size, hop. This front-end covers that surface plus
extensions (batch mode, chunked sequence-parallel mode, bench).

Usage:
  pvoc stretch in.wav out.wav --ratio 2.0 [--n-fft 1024 --hop 256]
  pvoc pitch   in.wav out.wav --semitones -5
  pvoc batch   a.wav b.wav ... --ratio 1.5 --out-dir stretched/
  pvoc chunked in.wav out.wav --ratio 2.0 [--devices 4]
  pvoc bench   [--seconds 600 --ratio 2.0]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from .config import PvocConfig
from .io.wav import read_wav, write_wav
from .utils.metrics import audio_seconds_per_second, emit_metric
from .utils.cache import enable_compilation_cache


def _add_dsp_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-fft", type=int, default=1024, help="FFT size N")
    p.add_argument("--hop", type=int, default=256, help="analysis hop Ra")
    p.add_argument(
        "--float32", action="store_true",
        help="write float32 WAV instead of PCM16. PCM16 (the reference's "
        "convention) CLIPS stretched samples that overshoot +-1.0 — a "
        "time-stretched waveform can exceed the input peak by a few "
        "percent, and the clip then dominates any waveform-level "
        "comparison (measured: 1.077 golden peak -> 7.2e-2 apparent "
        "error from the clip alone vs 2.4e-5 true pipeline error)",
    )
    p.add_argument(
        "--fft-backend", choices=["xla", "matmul"],
        default=PvocConfig.fft_backend,
        help="'xla' (default): the XLA FFT op (cuFFT on the GPU); "
        "'matmul': the DFT as float32 matrix products",
    )
    p.add_argument(
        "--phase-method", choices=["wrapped_scan", "cumsum"], default="wrapped_scan",
        help="drift-free wrapped associative scan (default) or naive cumsum",
    )


def _cfg(args) -> PvocConfig:
    return PvocConfig(
        n_fft=args.n_fft,
        hop=args.hop,
        fft_backend=args.fft_backend,
        phase_method=args.phase_method,
    )


def _run_stretch(args) -> int:
    from .pipeline import time_stretch
    from .utils import profiling

    x, sr = read_wav(args.input)
    t0 = time.perf_counter()
    with profiling.trace(args.trace_dir):
        if args.checkpoint_dir:
            from .streaming import DEFAULT_SEGMENT_FRAMES
            from .utils.checkpoint import checkpointed_stream_time_stretch

            y = np.asarray(checkpointed_stream_time_stretch(
                x, args.ratio, _cfg(args),
                checkpoint_dir=args.checkpoint_dir,
                segment_frames=args.segment_frames or DEFAULT_SEGMENT_FRAMES,
                batch_segments=args.batch_segments,
            ))
        elif args.segment_frames:
            from .streaming import stream_time_stretch

            y = np.asarray(stream_time_stretch(
                x, args.ratio, _cfg(args), segment_frames=args.segment_frames
            ))
        else:
            y = np.asarray(time_stretch(x, args.ratio, _cfg(args)))
    dt = time.perf_counter() - t0
    write_wav(args.output, y, sr, pcm16=not args.float32)
    emit_metric("audio_seconds_per_second", audio_seconds_per_second(len(x), sr, dt),
                "audio-s/s", stretch=args.ratio, samples=len(x))
    return 0


def _run_pitch(args) -> int:
    from .pipeline import pitch_shift

    x, sr = read_wav(args.input)
    y = np.asarray(pitch_shift(x, args.semitones, _cfg(args)))
    write_wav(args.output, y, sr, pcm16=not args.float32)
    return 0


def _run_batch(args) -> int:
    from .parallel.batch import batch_time_stretch_ragged

    loaded = [read_wav(p) for p in args.inputs]
    srs = {sr for _, sr in loaded}
    if len(srs) != 1:
        print(f"error: mixed sample rates {sorted(srs)}", file=sys.stderr)
        return 2
    sr = srs.pop()
    xs = [x for x, _ in loaded]
    t0 = time.perf_counter()
    ys = batch_time_stretch_ragged(xs, args.ratio, _cfg(args))
    dt = time.perf_counter() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    for path, y in zip(args.inputs, ys):
        out = os.path.join(args.out_dir, os.path.basename(path))
        write_wav(out, np.asarray(y), sr, pcm16=not args.float32)
    total = sum(len(x) for x in xs)
    emit_metric("batch_audio_seconds_per_second",
                audio_seconds_per_second(total, sr, dt), "audio-s/s",
                utterances=len(xs))
    return 0


def _run_chunked(args) -> int:
    from .parallel.chunked import chunked_time_stretch
    from .parallel.mesh import make_mesh

    import jax

    multihost = args.coordinator is not None or args.num_processes is not None
    if multihost:
        # Multi-host bootstrap: one process per host contributes its local
        # devices to a single global mesh (parallel/distributed.py).
        from .parallel import distributed

        distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        mesh = distributed.global_mesh("seq")
    else:
        mesh = make_mesh(args.devices)

    x, sr = read_wav(args.input)
    t0 = time.perf_counter()
    y = chunked_time_stretch(x, args.ratio, _cfg(args), mesh=mesh)
    if multihost:
        from jax.experimental import multihost_utils

        y = multihost_utils.process_allgather(y, tiled=True)
    y = np.asarray(y)
    dt = time.perf_counter() - t0
    if not multihost or jax.process_index() == 0:
        write_wav(args.output, y, sr, pcm16=not args.float32)
        emit_metric("chunked_audio_seconds_per_second",
                    audio_seconds_per_second(len(x), sr, dt), "audio-s/s",
                    devices=mesh.devices.size,
                    processes=jax.process_count())
    return 0


def _run_bench(args) -> int:
    import bench as bench_mod  # repo-root bench harness

    return bench_mod.main(args.bench_args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pvoc", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stretch", help="time-stretch a WAV (pitch preserved)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--ratio", type=float, required=True, help="duration multiplier")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint/resume directory for long runs "
                        "(resumes at the last completed segment batch)")
    p.add_argument("--segment-frames", type=int, default=None,
                   help="frames per streaming segment (default 1024)")
    p.add_argument("--batch-segments", type=int, default=8,
                   help="segments per checkpoint batch (with --checkpoint-dir)")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace here (TensorBoard/Perfetto)")
    _add_dsp_args(p)
    p.set_defaults(fn=_run_stretch)

    p = sub.add_parser("pitch", help="pitch-shift a WAV (duration preserved)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--semitones", type=float, required=True)
    _add_dsp_args(p)
    p.set_defaults(fn=_run_pitch)

    p = sub.add_parser("batch", help="data-parallel TSM of many WAVs")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--ratio", type=float, required=True)
    p.add_argument("--out-dir", default="stretched")
    _add_dsp_args(p)
    p.set_defaults(fn=_run_batch)

    p = sub.add_parser("chunked", help="sequence-parallel TSM of one long WAV")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--ratio", type=float, required=True)
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size (default: all visible devices)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address "
                        "(run one pvoc process per host)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank")
    _add_dsp_args(p)
    p.set_defaults(fn=_run_chunked)

    p = sub.add_parser(
        "bench", add_help=False,
        help="run the throughput benchmark (bench.py; its options follow)",
    )
    p.set_defaults(fn=_run_bench)

    return ap


def main(argv=None) -> int:
    logging.basicConfig(level=os.environ.get("PVOC_LOGLEVEL", "INFO"))
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd == "bench":
        args.bench_args = extra  # bench.py parses its own options
    elif extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
