"""The port's tensor and data parallelism against the JAX package's.

The JAX package shards one program over a virtual CPU mesh (GSPMD inserts
the collectives); the port runs one process per rank over gloo, with the
collectives written out in the model code. The ranks run in processes
started by ``whisper_tpu_torch.parallel.launch.spawn`` (a file store under
a temporary directory, one thread a rank, killed after 120 s), and compute
functions of tests/torch_parallel_cases.py; two runs serve every test
here: four ranks (the 2x2 and 4x1 meshes) and two (n_model = 2).

Tolerances: features 1e-3 (tests/test_sharding.py's, f32 with other
reduction orders); logits 1e-5 against one process; int8 cache scales
1e-5 relative and codes within 1 (the ranks' f32 projections may round
apart; a scale from one rank's rows alone would be off by far more).
Tokens, result_len and seek_delta are identical.
"""

import numpy as np
import pytest

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint
from torch_parallel_cases import spawn_case

BEG, EOT = 50_363, 50_256
SCRIPT = [BEG, 32, 104, 105, BEG + 96, EOT]  # <|0.00|> " hi" <|1.92|> <|eot|>
TIMEOUT = 120.0


def _quant_dims(n_vocab=512):
    """tests/test_quant_weights.py's dims."""
    from whisper_tpu.hparams import ModelDims

    return ModelDims(n_vocab=n_vocab, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                     n_audio_layer=2, n_text_ctx=16, n_text_head=4, n_text_state=64,
                     n_text_layer=2, n_mels=80, ftype=1)


def _port_dims(dims):
    from whisper_tpu_torch.hparams import ModelDims

    return ModelDims(**{f: getattr(dims, f) for f in dims.__dataclass_fields__})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_sharding.py's checkpoint (seed 60) and mel (seed 61)."""
    root = tmp_path_factory.mktemp("par")
    path = str(root / "m.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=60)
    rng = np.random.default_rng(61)
    mel = rng.standard_normal((4, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)
    scripted = str(root / "scripted.bin")
    make_scripted_checkpoint(scripted, SCRIPT)
    return path, mel, scripted


@pytest.fixture(scope="module")
def four_ranks(inputs):
    path, mel, _ = inputs
    return spawn_case("mesh_runs", 4, args=(path, mel), device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_windows(inputs):
    """The JAX package's window on one device, on a 2x2 mesh and on 4x1."""
    import jax
    import jax.numpy as jnp

    from tests.test_sharding import _run
    from whisper_tpu.ggml import load_checkpoint
    from whisper_tpu.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu.parallel.mesh import make_mesh
    from whisper_tpu.runtime.sampler import SpecialIds
    from whisper_tpu.vocab import Vocabulary

    path, mel, _ = inputs
    cp = load_checkpoint(path)
    params = params_from_checkpoint(cp, DtypePolicy.f32())
    ids = SpecialIds.from_vocab(Vocabulary(cp.vocab_words, cp.dims.n_vocab))
    return {name: _run(cp, params, ids, mel, jnp, mesh=mesh) for name, mesh in (
        ("single", None), ("2x2", make_mesh(n_model=2, devices=jax.devices()[:4])),
        ("4x1", make_mesh(n_model=1, devices=jax.devices()[:4])))}


def _same_window(a: dict, b: dict, lanes: int):
    assert (a["result_len"] == b["result_len"]).all()
    assert (a["seek_delta"] == b["seek_delta"]).all()
    for lane in range(lanes):
        n = int(a["result_len"][lane])
        assert list(a["tokens"][lane][:n]) == list(b["tokens"][lane][:n])


@pytest.mark.parametrize("mesh", ["2x2", "4x1"], ids=["tp_dp_2x2", "dp_only_4x1"])
def test_mesh_window_matches_jax_and_one_process(four_ranks, jax_windows, mesh):
    """tests/test_sharding.py:test_tp_dp_matches_single_device (2x2: 2 heads
    and 2 lanes a rank) and :test_data_parallel_only (4x1: one lane a rank),
    gathered over "data": the same on every rank, and each within 1e-3 of
    the JAX package's sharded run and of the unsharded port."""
    single_feats, single = four_ranks[0]["single"]
    feats, res, tp_size, qkv_shape = four_ranks[0][mesh]
    for rank in four_ranks[1:]:
        assert np.array_equal(rank[mesh][0], feats)
        assert all(np.array_equal(rank[mesh][1][k], v) for k, v in res.items())
    assert tp_size == (2 if mesh == "2x2" else 1)
    d = TINY_TEST_DIMS.n_audio_state
    assert qkv_shape == (d, 3 * d // tp_size)
    jfeats, jres = jax_windows[mesh]
    assert np.max(np.abs(feats - jfeats)) < 1e-3
    assert np.max(np.abs(feats - single_feats)) < 1e-3
    _same_window(res, jres, 4)
    _same_window(res, single, 4)
    _same_window(jres, jax_windows["single"][1], 4)


def test_make_mesh_refuses_an_axis_that_does_not_divide(four_ranks):
    """whisper_tpu.parallel.mesh.make_mesh's ValueError, raised on every rank."""
    assert all(r["n_model=3"] == "4 devices not divisible by n_model=3" for r in four_ranks)


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    from whisper_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(n_model=1)


def _spec(spec, stacked: bool = False) -> tuple:
    """A spec without trailing Nones (which split nothing); a JAX block
    spec also without its layer axis, which the port's Blocks lack."""
    spec = list(tuple(spec))[1 if stacked else 0:]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("tier", ["f32", "serving"])
def test_param_sharding_specs_match_jax(inputs, tier):
    """tests/test_sharding.py:test_param_sharding_specs, for every leaf of
    the tree (the int8 scales of the serving tier too)."""
    import jax

    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu.model.params import params_from_checkpoint as jparams
    from whisper_tpu.parallel.mesh import make_mesh as jmesh
    from whisper_tpu.parallel.sharding import param_shardings as jshardings
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu_torch.parallel.sharding import param_shardings

    path = inputs[0]
    jp = jparams(jload(path), JPolicy.f32() if tier == "f32" else JPolicy.serving())
    want = jshardings(jp, jmesh(n_model=2, devices=jax.devices()[:4]))
    params = params_from_checkpoint(load_checkpoint(path),
                                    DtypePolicy.f32() if tier == "f32" else DtypePolicy.serving(), "cpu")
    got = param_shardings(params, None)
    for sub in ("enc", "dec"):
        assert set(got[sub]) == set(want[sub])
        assert set(got[sub]["blocks"]) == set(want[sub]["blocks"])
        for key, sh in want[sub].items():
            if key != "blocks":
                assert _spec(got[sub][key]) == _spec(sh.spec), key
        for key, sh in want[sub]["blocks"].items():
            assert _spec(got[sub]["blocks"][key]) == _spec(sh.spec, stacked=True), key
    assert got["dec"]["blocks"]["qkv_w"] == (None, "model")
    assert got["dec"]["tok"] == ("model", None)
    assert got["enc"]["conv1_w"] == ()


@pytest.fixture(scope="module")
def two_ranks(inputs):
    """test_quant_weights' synthetic int8 tree, and f32 and int8 trees with
    an odd vocabulary (513), made by the JAX package; 2 ranks."""
    import jax
    import jax.numpy as jnp

    from whisper_tpu.tools.synthetic import make_synthetic_params
    path, _, scripted = inputs
    cases = {"int8 weights": (512, True), "odd vocab f32": (513, False), "odd vocab int8": (513, True)}
    trees, dims = {}, {}
    for name, (n_vocab, w8) in cases.items():
        jd = _quant_dims(n_vocab)
        p = make_synthetic_params(jd, jnp.float32, weights_int8=w8)
        trees[name] = jax.tree_util.tree_map(np.asarray, p)
        dims[name] = _port_dims(jd)
    audio = np.zeros(16_000 * 2, np.float32)
    return spawn_case("tp_runs", 2, args=(trees, dims, scripted, path, audio),
                      device="cpu", timeout=TIMEOUT), trees


@pytest.mark.parametrize("case", ["int8 weights", "odd vocab f32", "odd vocab int8"])
def test_tp_decode_step_matches_one_process(two_ranks, case):
    """tests/test_quant_weights.py:test_int8_weights_shard_and_run_tp at
    n_model = 2 (int8 weights with their scales sharded), and the same dims
    with 513 tokens, which do not split over 2 ranks: the table is padded
    and the gathered logits cut back. Both ranks give the unsharded step's
    logits within 1e-5, and the JAX package's within its test's bound."""
    import jax.numpy as jnp

    from whisper_tpu.model.decoder import decode_step, init_self_kv
    from whisper_tpu.model.encoder import precompute_cross_kv

    ranks, trees = two_ranks
    for r in ranks:
        got = r[case]
        assert got["sharded"].shape == (2, 513 if "odd" in case else 512)
        np.testing.assert_allclose(got["sharded"], got["single"], atol=1e-5, rtol=0)
    jd = _quant_dims(513 if "odd" in case else 512)
    params = trees[case]
    feats = jnp.ones((2, jd.n_audio_ctx, 64), jnp.float32) * 0.1
    cross = precompute_cross_kv(params, jd, feats, compute_dtype=jnp.float32)
    kv = init_self_kv(jd, 2, dtype=jnp.float32)
    want, _ = decode_step(params, jd, np.array([[3, 5], [7, 9]], np.int32), jnp.zeros((2,), jnp.int32),
                          kv, cross, compute_dtype=jnp.float32)
    np.testing.assert_allclose(ranks[0][case]["sharded"], np.asarray(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("which", ["cross", "self"])
def test_tp_int8_cache_scales_match_one_process(two_ranks, which):
    """The serving tier's int8 caches at n_model = 2 (a rank holds half of
    each column's HD rows): the column scales equal the unsharded ones
    within 1e-5 relative (the MAX all-reduce over the ranks' rows) and the
    codes are the unsharded codes of the rank's rows within 1."""
    ranks, _ = two_ranks
    for r in ranks:
        caches = r["int8 caches"]
        for field in ("k_s", "v_s"):
            single, sharded, _ = caches[f"{which} {field}"]
            assert sharded.shape == single.shape
            np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=0)
        for field in ("k", "v"):
            single, sharded, part = caches[f"{which} {field}"]
            assert sharded.shape == part.shape and sharded.shape[2] * 2 == single.shape[2]
            assert np.abs(sharded.astype(np.int32) - part.astype(np.int32)).max() <= 1
    # the rows of rank 0 and rank 1 put together are the whole column
    k0, k1 = (r["int8 caches"][f"{which} k"][1] for r in ranks)
    full = ranks[0]["int8 caches"][f"{which} k"][0]
    assert np.abs(np.concatenate([k0, k1], axis=2).astype(np.int32) - full).max() <= 1


def test_model_with_a_mesh_gives_the_golden_transcript(two_ranks):
    """Model(mesh=make_mesh(n_model=2)) on the scripted checkpoint: every
    rank's run_full gives the script; the model group is gloo, of 2 ranks,
    not capturable in a CUDA graph, and a rank's self cache holds half of
    the HD rows."""
    ranks, _ = two_ranks
    for r in ranks:
        assert r["golden"] == [(" hi", 0, 192, SCRIPT[:5])]
        assert r["model group"] == (2, "gloo", False, (2, 1, TINY_TEST_DIMS.n_text_state // 2, 48))


def _child_env(tmp_path, **env):
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    base = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    return dict(base, PYTHONPATH=str(root), **env)


@pytest.mark.parametrize("how", ["env", "args"])
def test_init_distributed(tmp_path, how):
    """init_distributed from the environment (env://, as torchrun sets it;
    port 0 lets the one rank's store take a free port) and with explicit
    arguments (a file under tmp_path), in a fresh interpreter."""
    import subprocess
    import sys

    call = ("init_distributed(device='cpu')" if how == "env" else
            f"init_distributed('file://{tmp_path}/store', 1, 0, device='cpu')")
    code = ("import torch.distributed as dist\n"
            "from whisper_tpu_torch.api.devices import init_distributed\n"
            f"{call}\n"
            "print(dist.get_backend(), dist.get_rank(), dist.get_world_size())\n"
            "dist.destroy_process_group()\n")
    env = _child_env(tmp_path, RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT="0")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gloo", "0", "1"]


def test_init_distributed_refuses_cuda_without_a_card():
    import torch

    from whisper_tpu_torch.api.devices import init_distributed

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed("127.0.0.1:1", 1, 0)


def test_spawn_kills_the_ranks_and_raises_when_one_fails():
    """A rank that raises fails the run at once, with its error output,
    and the rank left waiting in a collective is killed."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_case("fail_on_rank_1", 2, device="cpu", timeout=TIMEOUT)
