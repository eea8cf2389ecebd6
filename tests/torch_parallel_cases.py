"""The ranks' side of tests/test_torch_parallel.py and of the parallel tests
of tests/test_torch_cuda.py.

Each function but ``spawn_case`` runs in one process per rank, started by
``whisper_tpu_torch.parallel.launch.spawn`` (gloo on the CPU, one thread a
rank), and returns numpy arrays for the test to compare; the tests start
them with ``spawn_case``. The unsharded
reference each test needs is computed in the same processes, so both sides
run with the same thread count. This module imports neither JAX nor the
JAX package: the children do not need it.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def spawn_case(target: str, nprocs: int, **kw):
    """``parallel.launch.spawn`` of this module's ``target``, imported by the
    ranks as a top-level module from this directory (a ``tests`` package
    elsewhere on the path cannot shadow it). ``kw`` goes to ``spawn``."""
    import os

    import pytest

    from whisper_tpu_torch.parallel.launch import spawn

    here = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p))
        return spawn(f"torch_parallel_cases:{target}", nprocs, **kw)


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _runtime_window(params, dims, ids, mel):
    """The JAX sharding test's window (tests/test_sharding.py:_run) on the
    runtime: encode, cross K/V, one greedy window from a bare SOT."""
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    rt = WhisperRuntime(params, dims, ids, compute_dtype=F32, device="cpu")
    b = mel.shape[0]
    feats, cross = rt.encode_window(mel)
    res = rt.run_window(np.full((b, 4), ids.sot, np.int32), np.ones((b,), np.int32), cross,
                        np.zeros((b,), np.int32), np.full((b,), 10**6, np.int32))
    return feats, res


def mesh_runs(path: str, mel: np.ndarray) -> dict:
    """4 ranks: TP and DP on a 2x2 mesh, and DP alone on 4x1 (one lane a
    rank), each gathered over "data"; the unsharded window; make_mesh's
    refusal of a model axis that does not divide the ranks."""
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu_torch.parallel.mesh import make_mesh
    from whisper_tpu_torch.parallel.sharding import gather_batch, shard_batch, shard_params
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary

    cp = load_checkpoint(path)
    params = params_from_checkpoint(cp, DtypePolicy.f32(), "cpu")
    ids = SpecialIds.from_vocab(Vocabulary(cp.vocab_words, cp.dims.n_vocab))
    out = {}
    feats, res = _runtime_window(params, cp.dims, ids, mel)
    out["single"] = (_np(feats), {k: _np(v) for k, v in res._asdict().items()})
    for name, n_model in (("2x2", 2), ("4x1", 1)):
        mesh = make_mesh(n_model=n_model)
        sharded = shard_params(params, mesh)
        feats, res = _runtime_window(sharded, cp.dims, ids, shard_batch(mel, mesh))
        fields = {k: _np(gather_batch(v, mesh)) for k, v in res._asdict().items() if v.dim()}
        out[name] = (_np(gather_batch(feats, mesh)), fields, sharded.tp.size,
                     sharded.enc.blocks[0].qkv_w.shape)
    try:
        make_mesh(n_model=3)
    except ValueError as e:
        out["n_model=3"] = str(e)
    return out


def _decode_logits(params, dims, feats, tokens):
    """tests/test_quant_weights.py's step: cross K/V of ``feats``, then one
    decode step of ``tokens`` at positions 0.. into a fresh cache."""
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv
    from whisper_tpu_torch.model.encoder import precompute_cross_kv

    cross = precompute_cross_kv(params, dims, feats, compute_dtype=F32)
    kv = init_self_kv(dims, tokens.shape[0], dtype=F32, device="cpu", tp=params.tp)
    pos = torch.zeros((tokens.shape[0],), dtype=torch.int32)
    return decode_step(params, dims, tokens, pos, kv, cross, compute_dtype=F32)[0]


def tp_runs(trees: dict, dims_by_name: dict, scripted: str, random: str, audio: np.ndarray) -> dict:
    """2 ranks at n_model = 2: decode steps on host parameter trees (int8
    weights, odd vocabularies) against the unsharded step; the serving
    tier's int8 caches against the unsharded ones; Model(mesh=) on the
    scripted checkpoint."""
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv
    from whisper_tpu_torch.model.encoder import encode, precompute_cross_kv
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint, params_from_numpy
    from whisper_tpu_torch.parallel.mesh import make_mesh
    from whisper_tpu_torch.parallel.sharding import kv_sharding, local_part, shard_params

    mesh = make_mesh(n_model=2)
    out = {}
    tokens = torch.tensor([[3, 5], [7, 9]], dtype=torch.int32)
    for name, tree in trees.items():
        dims = dims_by_name[name]
        params = params_from_numpy(tree, "cpu", DtypePolicy.f32())
        feats = torch.ones((2, dims.n_audio_ctx, dims.n_audio_state)) * 0.1
        out[name] = dict(single=_np(_decode_logits(params, dims, feats, tokens)),
                         sharded=_np(_decode_logits(shard_params(params, mesh), dims, feats, tokens)))

    # the serving tier's int8 caches: the same features into both cross
    # K/V precomputes, then a 4-token prompt and 3 single-token steps
    cp = load_checkpoint(random)
    dims = cp.dims
    params = params_from_checkpoint(cp, DtypePolicy.serving(), "cpu")
    sharded = shard_params(params, mesh)
    mel = torch.from_numpy(np.random.default_rng(62).standard_normal(
        (2, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32))
    with torch.inference_mode():
        feats = encode(params, dims, mel)
        caches = {}
        for side, p in (("single", params), ("sharded", sharded)):
            cross = precompute_cross_kv(p, dims, feats, quant=True)
            kv = init_self_kv(dims, 2, device="cpu", quant=True, tp=p.tp)
            prompt = torch.tensor([[50_258, 50_259, 50_359, 50_363]] * 2, dtype=torch.int32)
            logits, _ = decode_step(p, dims, prompt, torch.zeros(2, dtype=torch.int32), kv, cross)
            for i in range(3):
                tok = logits.argmax(-1, keepdim=True).int()
                logits, _ = decode_step(p, dims, tok, torch.full((2,), 4 + i, dtype=torch.int32),
                                        kv, cross, write_pos=4 + i)
            caches[side] = dict(cross=cross, self=kv)
    spec = kv_sharding(mesh)
    out["int8 caches"] = {
        f"{which} {field}": (_np(getattr(caches["single"][which], field)),
                             _np(getattr(caches["sharded"][which], field)),
                             _np(local_part(getattr(caches["single"][which], field), spec, mesh))
                             if field in ("k", "v") else None)
        for which in ("cross", "self") for field in ("k", "v", "k_s", "v_s")}

    model = Model(scripted, policy=DtypePolicy.f32(), mesh=mesh, device="cpu")
    result = model.create_context().run_full(FullParams(language="en"), audio)
    out["golden"] = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in result.segments]
    tp = model.runtime.params.tp
    out["model group"] = (tp.size, tp.backend, tp.capturable,
                          tuple(model.runtime.self_kv(1).k.shape))
    return out


def fail_on_rank_1() -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def _window_on(model, seed: int):
    """encode_window + run_window of a seeded mel at B=1 from a bare SOT."""
    dims, rt = model.dims, model.runtime
    mel = np.random.default_rng(seed).standard_normal((1, dims.n_mels, 2 * dims.n_audio_ctx))
    feats, cross = rt.encode_window(mel.astype(np.float32))
    res = rt.run_window(np.full((1, 4), rt.ids.sot, np.int32), np.ones((1,), np.int32), cross,
                        np.zeros((1,), np.int32), np.full((1,), 10**6, np.int32))
    return _np(feats), {k: _np(v) for k, v in res._asdict().items()}


def card_tp_ranks(scripted: str) -> dict:
    """2 gloo ranks on one card at n_model = 2, eager steps: run_full of the
    scripted checkpoint and a seeded window, on the bf16 and f32 tiers;
    rank 0 also runs them unsharded. Whether graphs were refused."""
    import torch.distributed as dist

    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.model.params import DtypePolicy
    from whisper_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_model=2)
    out = {}
    try:
        Model(scripted, mesh=mesh)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    audio = np.zeros(16_000 * 2, np.float32)
    for tier, policy in (("bf16", None), ("f32", DtypePolicy.f32())):
        sides = [("sharded", mesh)] + ([("single", None)] if dist.get_rank() == 0 else [])
        for side, m in sides:
            model = Model(scripted, policy=policy, mesh=m, cuda_graphs=False)
            res = model.create_context().run_full(FullParams(language="en"), audio)
            out[tier, side] = dict(segments=[(s.text, s.t0, s.t1, [t.id for t in s.tokens])
                                             for s in res.segments],
                                   window=_window_on(model, 8), heads=model.runtime.params.tp.part(4))
    return out


def card_nccl_rank(scripted: str) -> dict:
    """NCCL at world size 1: Model(mesh=make_mesh()) (1x1) with its token
    steps replayed as graphs, and Model(mesh=None): run_full and a seeded
    window each, with the graph replays."""
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for side, mesh in (("mesh=None", None), ("1x1", make_mesh())):
        model = Model(scripted, mesh=mesh)
        res = model.create_context().run_full(FullParams(language="en"), np.zeros(32_000, np.float32))
        out[side] = dict(segments=[(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in res.segments],
                         window=_window_on(model, 8), replays=model.runtime.graphs.replays())
    return out
