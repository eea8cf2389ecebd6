"""The harness is driven by data, looks for its card, and loads no JAX.

A new configuration, traffic mix, metric reader and limit, each a new file
beside a manifest of its own, are found by name with no edit to the files
that are there; a run without a card prints no result; what a run loads
holds no module of JAX or of the JAX package (top-level names compared
whole: ``whisper_tpu_torch`` is the port, ``whisper_tpu`` the JAX package);
a directory holding only the manifest and the benchmark fails; and a run
is correct only where every number its limits file names holds its limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import tiny

from benchmark.harness import decide

NEW_READER = '''"""Rounds of the measured window per wall second."""


def read(run):
    return len(run.records) / run.lanes / run.window_s
'''


def _python(code: str, cwd, with_port: bool = True) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    if with_port:
        env["PYTHONPATH"] = str(tiny.REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "benchmark" / "metrics" / "rounds_per_s.py").write_text(NEW_READER)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["end_to_end"].append({"name": "rounds_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock", "workloads": ["tiny.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = f"""
import json, sys
sys.path.insert(0, {str(root)!r})
import benchmark.harness as h
assert h.__file__.startswith({str(root)!r}), h.__file__
res = h.run_cell("tiny.long", 2**33 + 7, 1.0, False, device="cpu", look_for_chip=False)
print(json.dumps({{"result": res, "forbidden": h.forbidden_modules(),
                  "top": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    out = _python(code, root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["result"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s", "rounds_per_s", "window_p95_ms"}
    assert list(res)[-1] == "check" and res["check"]["logit_err"]["limit"] == tiny.LIMIT
    assert got["forbidden"] == []
    assert "whisper_tpu_torch" in got["top"] and not {"jax", "jaxlib", "flax", "whisper_tpu"} & set(got["top"])


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v2-serving.longform-b8",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"], cwd=tiny.REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_manifest_and_benchmark_alone_fail(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = f"""
import sys
sys.path.insert(0, {str(tmp_path)!r})
from benchmark.harness import run_cell
print(run_cell("v2-serving.clips-b8", 1, 1.0, False, device="cpu", look_for_chip=False))
"""
    out = _python(code, tmp_path, with_port=False)
    assert out.returncode != 0
    assert "No module named 'whisper_tpu_torch'" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("readings, windows, failed, want", [
    ({"logit_err": 0.1, "logp_mean_err": 0.01}, 8, 0, True),
    ({"logit_err": 0.1, "logp_mean_err": 0.03}, 8, 0, False),   # one number over its limit is enough
    ({"logit_err": float("inf"), "logp_mean_err": 0.01}, 8, 0, False),
    ({"logit_err": 0.1, "logp_mean_err": 0.01}, 0, 0, False),    # no window finished
    ({"logit_err": 0.1, "logp_mean_err": 0.01}, 8, 1, False),
])
def test_every_number_compared_holds_its_limit(readings, windows, failed, want):
    limits = {"logit_err": {"limit": 0.17}, "logp_mean_err": {"limit": 0.022}}
    correct, compared = decide(dict(readings, gap=9.0), limits, windows, failed)
    assert correct is want
    assert compared == {k: {"value": readings[k], "limit": v["limit"]} for k, v in limits.items()}
