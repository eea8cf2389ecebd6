"""Transcription HTTP server on the PyTorch port.

Counterpart of the JAX package's serving example (``examples/serve.py``):
single model, batched. Concurrent requests are queued and transcribed
together through the BatchTranscriber (weight reads amortize across
requests; the reference clones the model per thread instead,
ModelImpl.cpp:40-60). Stdlib only, plus ``--device`` (default ``cuda``).

  python -m whisper_tpu_torch.cli.serve ggml-large-v2.bin --port 8080 --batch 4
  curl -X POST --data-binary @audio.wav http://localhost:8080/transcribe
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from whisper_tpu_torch.api.params import FullParams
from whisper_tpu_torch.audio.load import resample_to_16k
from whisper_tpu_torch.runtime.batch import BatchTranscriber


class _Job:
    def __init__(self, audio):
        self.audio = audio
        self.done = threading.Event()
        self.result = None
        self.error: str | None = None


# Minimal browser front-end — the WhisperDesktop transcribe-dialog role
# (Examples/WhisperDesktop/TranscribeDlg.h) as a single stdlib-served page.
INDEX = b"""<!doctype html><meta charset=utf-8><title>whisper_tpu_torch</title>
<body style="font-family:sans-serif;max-width:48rem;margin:2rem auto">
<h2>whisper_tpu_torch transcription</h2>
<p>Pick a 16-bit PCM .wav file; it is POSTed to <code>/transcribe</code>.</p>
<input type=file id=f accept=.wav>
<button onclick=go()>Transcribe</button>
<pre id=out style="white-space:pre-wrap;background:#f4f4f4;padding:1rem"></pre>
<script>
async function go(){
  const f=document.getElementById('f').files[0];
  const out=document.getElementById('out');
  if(!f){out.textContent='choose a .wav file first';return}
  out.textContent='transcribing...';
  const r=await fetch('/transcribe',{method:'POST',body:await f.arrayBuffer()});
  if(!r.ok){out.textContent='error: '+await r.text();return}
  const j=await r.json();
  out.textContent=j.segments.map(s=>
    '['+s.t0.toFixed(2)+' - '+s.t1.toFixed(2)+']'+s.text).join('\\n');
}
</script>"""


def result_json(result) -> dict:
    """The response body of one transcription (times in seconds)."""
    return {
        "text": result.text,
        "segments": [{"t0": s.t0 / 100.0, "t1": s.t1 / 100.0, "text": s.text}
                     for s in result.segments],
    }


class TranscribeServer(ThreadingHTTPServer):
    """The HTTP server and its batching worker; ``server_close`` also ends
    the worker."""

    def __init__(self, address, handler, jobs: "queue.Queue"):
        super().__init__(address, handler)
        self.jobs = jobs

    def server_close(self):
        super().server_close()
        self.jobs.put(None)


def make_server(model, batch: int, params: FullParams, port: int, host: str = "") -> TranscribeServer:
    """The server on ``(host, port)`` (port 0 picks a free one, read it from
    ``server.server_address``) with its worker thread started; run it with
    ``serve_forever()``, stop it with ``shutdown()`` and ``server_close()``."""
    bt = BatchTranscriber(model, batch=batch)
    jobs: "queue.Queue[_Job | None]" = queue.Queue()

    def worker():
        while True:
            first = jobs.get()
            if first is None:
                return
            group = [first]
            while len(group) < batch:
                try:
                    job = jobs.get_nowait()
                except queue.Empty:
                    break
                if job is None:
                    jobs.put(None)       # stop after this group
                    break
                group.append(job)
            try:
                results = bt.transcribe([j.audio for j in group], params)
                for j, r in zip(group, results):
                    j.result = r
            except Exception as e:  # the worker keeps serving: log, and fail this group's jobs
                traceback.print_exc(file=sys.stderr)
                for j in group:
                    j.error = str(e)
            for j in group:
                j.done.set()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(INDEX)))
            self.end_headers()
            self.wfile.write(INDEX)

        def do_POST(self):
            if self.path != "/transcribe":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                from scipy.io import wavfile

                rate, pcm = wavfile.read(io.BytesIO(data))
                if pcm.dtype.kind == "i":
                    pcm = pcm.astype(np.float32) / np.iinfo(pcm.dtype).max
                if pcm.ndim == 2:
                    pcm = pcm.mean(axis=1)
                audio = resample_to_16k(pcm.astype(np.float32), rate)
            except Exception as e:
                self.send_error(400, f"bad audio: {e}")
                return

            job = _Job(audio)
            jobs.put(job)
            job.done.wait()
            if job.error:
                self.send_error(500, job.error)
                return
            body = json.dumps(result_json(job.result)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = TranscribeServer((host, port), Handler, jobs)
    threading.Thread(target=worker, daemon=True).start()
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper_tpu_torch.cli.serve", description=__doc__)
    ap.add_argument("model")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--language", default="en")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from whisper_tpu_torch.api.model import load_model

    model = load_model(args.model, device=args.device)
    server = make_server(model, args.batch, FullParams(language=args.language), args.port)
    print(f"serving on :{server.server_address[1]} (batch={args.batch}, {model.device})",
          file=sys.stderr)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
