"""The port's HTTP server (``whisper_tpu_torch.cli.serve``) on the CPU: started
on port 0, it answers three concurrent POSTs of WAV files with what the
BatchTranscriber gives for the same clips, and serves its page."""

import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest

from tests.helpers import make_scripted_checkpoint

SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>


def _wav_bytes(pcm: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.cli.serve import make_server

    path = str(tmp_path_factory.mktemp("srv") / "scripted.bin")
    make_scripted_checkpoint(path, SCRIPT)
    model = Model(path, device="cpu")
    params = FullParams(language="en")
    srv = make_server(model, 4, params, 0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, model, params
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _post(port: int, body: bytes) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_three_concurrent_posts_match_batch_transcriber(server):
    from whisper_tpu_torch.cli.serve import result_json
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    srv, model, params = server
    port = srv.server_address[1]
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.standard_normal(int(16_000 * s))).astype(np.float32) for s in (1.6, 2.0, 2.4)]
    bodies = [_wav_bytes(c) for c in clips]
    # what the server decodes: the 16-bit samples scaled as it scales them
    heard = [np.frombuffer(b[44:], np.int16).astype(np.float32) / 32767 for b in bodies]
    answers = [None] * 3

    def ask(i):
        answers[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    want = [result_json(r) for r in BatchTranscriber(model, batch=4).transcribe(heard, params)]
    assert answers == want
    assert all(a["text"] == " hi" and a["segments"] == [{"t0": 0.0, "t1": 1.92, "text": " hi"}]
               for a in answers)


def test_index_page_and_errors(server):
    srv = server[0]
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        assert r.status == 200 and b"/transcribe" in r.read()
    for url, data in ((f"http://127.0.0.1:{port}/nothing", None),
                      (f"http://127.0.0.1:{port}/transcribe", b"not a wav")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=30)
        assert e.value.code == (404 if data is None else 400)
