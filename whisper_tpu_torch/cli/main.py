"""Transcription CLI: whisper.cpp-compatible flag set, on the PyTorch port.

Counterpart of ``whisper_tpu.cli.main`` with the same parser and flags
(beam search ``-bs``, segment length ``-ml``, the ``.wts`` karaoke script
``-owts``, stereo speaker detection ``-di``, streamed input ``--stream``),
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).

Usage:
  python -m whisper_tpu_torch.cli.main -m ggml-large-v2.bin -f clip.wav -otxt -osrt
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch", description=__doc__)
    p.add_argument("-m", "--model", required=True, help="GGML model path")
    p.add_argument("-f", "--file", action="append", required=True, help="audio file(s)")
    p.add_argument("-l", "--language", default="en", help="spoken language")
    p.add_argument("-tr", "--translate", action="store_true", help="translate to English")
    p.add_argument("-ot", "--offset-t", type=int, default=0, help="time offset in ms")
    p.add_argument("-d", "--duration", type=int, default=0, help="duration to process in ms")
    p.add_argument("-mc", "--max-context", type=int, default=-1, help="max text context tokens")
    p.add_argument("-ml", "--max-len", type=int, default=0, help="max segment length in chars")
    p.add_argument("-ac", "--audio-ctx", type=int, default=0, help="encoder context override")
    p.add_argument("-bs", "--beam-size", type=int, default=0, help="beam search width (0=greedy)")
    p.add_argument("-nt", "--no-timestamps", action="store_true")
    p.add_argument("-di", "--diarize", action="store_true", help="stereo speaker detection")
    p.add_argument("-otxt", "--output-txt", action="store_true")
    p.add_argument("-osrt", "--output-srt", action="store_true")
    p.add_argument("-ovtt", "--output-vtt", action="store_true")
    p.add_argument("-ocsv", "--output-csv", action="store_true")
    p.add_argument("-owts", "--output-words", action="store_true",
                   help="output karaoke video script (token timestamps)")
    p.add_argument("-ps", "--print-special", action="store_true")
    p.add_argument("-pc", "--print-colors", action="store_true",
                   help="color tokens by probability")
    p.add_argument("-su", "--speed-up", action="store_true",
                   help="speed up audio 2x (reduced accuracy)")
    p.add_argument("-nf", "--no-fallback", action="store_true", help="(accepted, ignored)")
    p.add_argument("--stream", action="store_true", help="use the chunked/streamed mel path")
    p.add_argument("--prompt", default=None, help="initial prompt text")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--timings", action="store_true", help="print timings report")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.api.params import Flags, FullParams, SamplingStrategy
    from whisper_tpu_torch.audio.load import ChunkedReader, load_audio_file
    from whisper_tpu_torch.cli.writers import WRITERS, _ts, write_wts
    from whisper_tpu_torch.obs.profiler import TRACER

    model = load_model(args.model, device=args.device)
    print(
        f"loaded {args.model} ({model.dims.n_audio_layer}+{model.dims.n_text_layer} layers,"
        f" d={model.dims.n_audio_state}) on {model.device} in {model.load_time_total_s:.2f}s",
        file=sys.stderr,
    )

    flags = Flags.PRINT_TIMESTAMPS
    if args.translate:
        flags |= Flags.TRANSLATE
    if args.print_special:
        flags |= Flags.PRINT_SPECIAL
    if args.max_len or args.output_words:
        flags |= Flags.TOKEN_TIMESTAMPS
    if args.output_words and args.max_len == 0:
        # reference Examples/main/main.cpp:279 — wts defaults to 60-char segments
        args.max_len = 60
    if args.no_timestamps:
        flags &= ~Flags.PRINT_TIMESTAMPS
    if args.speed_up:
        flags |= Flags.SPEEDUP_AUDIO

    params = FullParams(
        strategy=SamplingStrategy.BEAM_SEARCH if args.beam_size > 0 else SamplingStrategy.GREEDY,
        n_threads=args.threads,
        offset_ms=args.offset_t,
        duration_ms=args.duration,
        language=args.language,
        flags=flags,
        max_len=args.max_len,
        audio_ctx=args.audio_ctx,
        beam_width=args.beam_size or 5,
    )
    if args.max_context >= 0:
        params.n_max_text_ctx = args.max_context
    if args.prompt:
        params.prompt_tokens = model.tokenize(args.prompt)

    if args.timings:
        TRACER.enable()

    for path in args.file:
        buf = load_audio_file(path, want_stereo=args.diarize)
        print(f"processing {path} ({buf.duration_s:.1f}s) ...", file=sys.stderr)

        ctx = model.create_context()

        # probability -> 256-color ramp (reference Examples/main/main.cpp:25-51)
        k_colors = [196, 202, 208, 214, 220, 226, 190, 154, 118, 82]

        def colorize(tok):
            col = k_colors[max(0, min(9, int(tok.probability ** 3 * 10)))]
            return f"\033[38;5;{col}m{tok.text}\033[0m"

        def seg_text(seg):
            if args.print_colors:
                return "".join(
                    colorize(t) for t in seg.tokens
                    if params.flag(Flags.PRINT_SPECIAL) or not t.flags
                )
            return seg.text

        def on_segment(c, n_new):
            for seg in c.result_all[-n_new:]:
                if params.flag(Flags.PRINT_TIMESTAMPS):
                    spk = ""
                    if args.diarize:
                        spk = f" (speaker {seg.speaker.name})"
                    print(f"[{_ts(seg.t0)} --> {_ts(seg.t1)}] {spk} {seg_text(seg).strip()}")
                else:
                    print(seg_text(seg), end="", flush=True)

        params.new_segment_callback = on_segment

        audio = buf.mono if buf.stereo is None else buf.stereo
        t1 = time.perf_counter()
        if args.stream:
            result = ctx.run_streamed(params, ChunkedReader(buf.mono))
        else:
            result = ctx.run_full(params, audio)
        dt = time.perf_counter() - t1
        print(
            f"done: {len(result.segments)} segments in {dt:.2f}s "
            f"(RTF {buf.duration_s/max(dt,1e-9):.2f})",
            file=sys.stderr,
        )

        stem = path.rsplit(".", 1)[0]
        for kind, enabled in (
            ("txt", args.output_txt), ("srt", args.output_srt),
            ("vtt", args.output_vtt), ("csv", args.output_csv),
        ):
            if enabled:
                with open(f"{stem}.{kind}", "w", encoding="utf-8") as f:
                    WRITERS[kind](result, f)
                print(f"wrote {stem}.{kind}", file=sys.stderr)

        if args.output_words:
            with open(f"{path}.wts", "w", encoding="utf-8") as f:
                write_wts(result, f, path, buf.duration_s + 0.0625)
            print(f"wrote {path}.wts", file=sys.stderr)

        if args.timings:
            ctx.timings_print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
