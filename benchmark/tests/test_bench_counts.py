"""The yardstick's arithmetic against figures worked by hand for large-v2
(the bounds of PERF.md's kernel table), and the roofline readers on traces
that hold the work counted, less of it, or more."""

from __future__ import annotations

import json

import pytest

from benchmark import counts
from benchmark.harness import load_reader
from benchmark.inputs import Dims
from tiny import REPO

V2 = Dims(json.loads((REPO / "benchmark/configs/large-v2.serving.json").read_text()))
TURBO = Dims(json.loads((REPO / "benchmark/configs/large-v3-turbo.bf16.json").read_text()))


@pytest.mark.parametrize("b, ms", [(1, 0.011648), (8, 0.093185)])
def test_k1_bound(b, ms):
    # 4 B H T^2 Dh = 11.52 GFLOP at B=1 over 989 TFLOP/s; its 15.36 MB take 0.0046 ms
    assert counts.k1_bound_s(b, 1500, 20, 64) * 1e3 == pytest.approx(ms, rel=1e-4)


@pytest.mark.parametrize("keys, kv_bytes, ms", [
    ([1500] * 8, 1, 0.0092169),     # cross, int8: 24,000 keys x 1280 B + 4 B scales, q and out
    ([1500] * 8, 2, 0.0183582),     # cross, bf16
    ([328 - s for s in (0, 7, 14, 21, 28, 35, 2, 9)], 2, 0.0038515),   # self, per-lane start
    ([328 - s for s in (0, 7, 14, 21, 28, 35, 2, 9)], 1, 0.0019409),
])
def test_k2_bound(keys, kv_bytes, ms):
    assert counts.k2_bound_s(keys, 1280, kv_bytes) * 1e3 == pytest.approx(ms, rel=1e-4)


def test_window_bounds_sum_their_calls():
    work = counts.Work(V2, kv_int8=True)
    assert work.k1_bound_s(8) == pytest.approx(32 * counts.k1_bound_s(8, 1500, 20, 64))
    one_step = (counts.k2_bound_s([1500] * 2, 1280, 1) + counts.k2_bound_s([229, 4], 1280, 1))
    assert work.k2_bound_s([228, 3], 1) == pytest.approx(32 * one_step)


def test_encode_flops_large_v2():
    stem = 2 * 3000 * 240 * 1280 + 2 * 1500 * 3840 * 1280
    block = 2 * 1500 * 1280 * (3 * 1280 + 1280 + 2 * 5120) + 4 * 1500**2 * 1280
    cross = 32 * 2 * 2 * 1500 * 1280**2
    assert counts.Work(V2, True).encode_flops(1) == stem + 32 * block + cross
    assert counts.Work(TURBO, False).encode_flops(2) == 2 * (
        2 * 3000 * 384 * 1280 + 2 * 1500 * 3840 * 1280 + 32 * block + 4 * 2 * 2 * 1500 * 1280**2)


def test_window_flops_large_v2():
    d, v = 1280, 51865
    per_layer = 2 * d * (3 * d + 3 * d + 2 * 4 * d)    # qkv, out, cross q, cross out, fc1, fc2

    def tok(keys):
        return 32 * (per_layer + 4 * d * keys + 4 * d * 1500)

    want = sum(tok(p + 1) for p in range(3)) + 2 * d * v + sum(tok(3 + i + 1) + 2 * d * v for i in range(2))
    assert counts.Work(V2, True).window_flops(3, 2) == want


def _traced(found: dict, k1_kernels: int = 64, k2_calls: int = 100):
    from types import SimpleNamespace
    return SimpleNamespace(trace={"found": found}, traced={
        "k1_bound_s": 2e-3, "k1_kernels": k1_kernels, "k2_bound_s": 1e-3, "k2_calls": k2_calls})


@pytest.mark.parametrize("split, combine, want", [
    (100, 100, 50.0),           # every call's two kernels: the whole bound over 2 ms
    (90, 100, 45.0),            # ten splits lost: the 90 calls kept
    (100, 80, 40.0),
    (101, 100, None),           # more K2 work than counted: no reading, never a clamp
    (100, 101, None),
])
def test_k2_roofline_reads_only_the_work_it_counted(split, combine, want):
    read = load_reader(REPO / "benchmark" / "metrics", "k2_roofline")
    run = _traced({"k2": [2e-3, split + combine], "k2_split": [0.0, split], "k2_combine": [0.0, combine]})
    assert read(run) == (None if want is None else pytest.approx(want))
    run.trace["found"]["k2"][1] += 1        # a K2-named kernel that is neither split nor combine
    assert read(run) is None


@pytest.mark.parametrize("n, want", [(64, 50.0), (32, 25.0), (65, None)])
def test_k1_roofline_reads_only_the_work_it_counted(n, want):
    read = load_reader(REPO / "benchmark" / "metrics", "k1_roofline")
    run = _traced({"k1": [4e-3, n]})
    assert read(run) == (None if want is None else pytest.approx(want))
