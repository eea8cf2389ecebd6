"""Transcript output writers: txt / srt / vtt / wts / csv.

The CLI example's writer set (reference Examples/main/textWriter.h:4-7,
miscUtils.cpp timestamp formatting). Times come in centiseconds.
"""

from __future__ import annotations

from typing import TextIO

from whisper_tpu_torch.api.result import TokenFlags, TranscribeResult


def _ts(t_cs: int, comma: bool = False) -> str:
    """Centiseconds -> HH:MM:SS.mmm (to_timestamp, ContextImpl.cpp:420-434)."""
    msec = t_cs * 10
    hr, msec = divmod(msec, 3_600_000)
    mn, msec = divmod(msec, 60_000)
    sec, msec = divmod(msec, 1_000)
    sep = "," if comma else "."
    return f"{hr:02d}:{mn:02d}:{sec:02d}{sep}{msec:03d}"


def write_txt(result: TranscribeResult, f: TextIO, timestamps: bool = False) -> None:
    for seg in result:
        if timestamps:
            f.write(f"[{_ts(seg.t0)} --> {_ts(seg.t1)}]  {seg.text.strip()}\n")
        else:
            f.write(seg.text)
    if not timestamps:
        f.write("\n")


def write_srt(result: TranscribeResult, f: TextIO) -> None:
    for i, seg in enumerate(result, 1):
        f.write(f"{i}\n{_ts(seg.t0, True)} --> {_ts(seg.t1, True)}\n{seg.text.strip()}\n\n")


def write_vtt(result: TranscribeResult, f: TextIO) -> None:
    f.write("WEBVTT\n\n")
    for seg in result:
        f.write(f"{_ts(seg.t0)} --> {_ts(seg.t1)}\n{seg.text.strip()}\n\n")


def write_csv(result: TranscribeResult, f: TextIO) -> None:
    f.write("start_cs,end_cs,text\n")
    for seg in result:
        text = seg.text.strip().replace('"', '""')
        f.write(f'{seg.t0},{seg.t1},"{text}"\n')


_WTS_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf"


def _wts_escape(text: str) -> str:
    """Escape for ffmpeg drawtext (reference OldMain/main.cpp:404-407)."""
    return text.replace("'", "’").replace('"', '\\"')


def write_wts(
    result: TranscribeResult,
    f: TextIO,
    audio_path: str,
    audio_len_s: float,
    font: str = _WTS_FONT,
) -> None:
    """Karaoke video script: emits a bash script that runs ffmpeg with a
    drawtext filter per token, highlighting each token over its [t0, t1]
    span (reference Examples/OldMain/main.cpp:331-434 ``output_wts``).

    Requires token-level timestamps (FullParams Flags.TOKEN_TIMESTAMPS).
    """
    f.write("#!/bin/bash\n\n")
    f.write(
        f"ffmpeg -i {audio_path} -f lavfi -i "
        f"color=size=1200x120:duration={audio_len_s}:rate=25:color=black -vf \""
    )

    filters: list[str] = []

    def drawtext(color: str, text: str, t0_cs: float, t1_cs: float, dx: int = 0, dy: int = 0) -> str:
        x = f"(w-text_w)/2{f'+{dx}' if dx else ''}"
        y = f"h/2{f'+{dy}' if dy else ''}"
        return (
            f"drawtext=fontfile='{font}':fontsize=24:fontcolor={color}:"
            f"x={x}:y={y}:text='{text}':"
            f"enable='between(t,{t0_cs / 100.0},{t1_cs / 100.0})'"
        )

    for seg in result:
        spoken = [t for t in seg.tokens if not (t.flags & TokenFlags.SPECIAL)]
        # zero-width marker at segment start (keeps filter graph aligned with
        # the reference's output shape even for token-less segments)
        filters.append(drawtext("gray", "", seg.t0, seg.t0))
        if not spoken:
            continue

        texts = [t.text for t in spoken]
        bg = "> " + _wts_escape("".join(texts))
        filters.append(drawtext("gray", bg, seg.t0, seg.t1))

        for j, token in enumerate(spoken):
            # foreground: this token's characters visible, all others blanked
            fg_parts = ["> "]
            ul_parts = ["\\ \\ "]
            for k, txt in enumerate(texts):
                esc = _wts_escape(txt)
                if k == j:
                    fg_parts.append(esc + "|")
                    ul_parts.append("_" * len(txt))
                else:
                    fg_parts.append("\\ " * len(txt))
                    ul_parts.append("\\ " * len(txt))
            filters.append(drawtext("lightgreen", "".join(fg_parts), token.t0, token.t1, dx=8))
            filters.append(drawtext("lightgreen", "".join(ul_parts), token.t0, token.t1, dx=8, dy=16))

    f.write(",".join(filters))
    f.write(f'" -c:v libx264 -pix_fmt yuv420p -y {audio_path}.mp4\n')
    f.write(f'\n\necho "Your video has been saved to {audio_path}.mp4"\n')
    f.write(f'\necho "  ffplay {audio_path}.mp4"\n\n')


WRITERS = {
    "txt": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "csv": write_csv,
}
