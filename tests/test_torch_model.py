"""The port's parameters, encoder and decoder against the JAX package, in f32
on the CPU, on the same random GGML checkpoint.

The JAX side runs with its Pallas kernels on (interpret mode), as
tests/test_kernels.py runs them; the port's wrappers run their plain
versions on CPU tensors. Tolerances: parameters exact (both sides apply the
same f32 arithmetic to the same f16 file), encoder and decoder 1e-4 (f32
throughout; summation order differs between XLA and PyTorch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint

TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from whisper_tpu.config import KernelConfig
    from whisper_tpu.ggml import load_checkpoint as jax_load
    from whisper_tpu.model import params as jp
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint

    path = str(tmp_path_factory.mktemp("m") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=1)
    jparams = jp.params_from_checkpoint(jax_load(path), jp.DtypePolicy.f32())
    cp = load_checkpoint(path)
    tparams = params_from_checkpoint(cp, DtypePolicy.f32(), device="cpu")
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((1, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)
    kernels = KernelConfig(flash_attention=True, interpret=True)
    return cp.dims, jparams, tparams, mel, kernels


def _leaves(tparams):
    """The port's tensors keyed like the JAX pytree's paths."""
    out = {}
    for part in ("enc", "dec"):
        mod = getattr(tparams, part)
        for name, t in mod.named_buffers():
            if name.startswith("blocks."):
                _, i, key = name.split(".")
                out.setdefault((part, "blocks", key), {})[int(i)] = t
            else:
                out[(part, name)] = t
    return {
        k: (torch.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else v)
        for k, v in out.items()
    }


def test_params_equal_jax_leaves(setup):
    dims, jparams, tparams, _, _ = setup
    jflat = {
        tuple(p.key for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }
    tflat = _leaves(tparams)
    assert set(jflat) == set(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == torch.float32, key
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(key))


def test_params_from_numpy_carries_jax_tree(setup):
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_numpy

    _, jparams, tparams, _, _ = setup
    host = jax.tree_util.tree_map(np.asarray, jparams)
    carried = params_from_numpy(host, "cpu", DtypePolicy.f32())
    a, b = _leaves(carried), _leaves(tparams)
    assert set(a) == set(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    # bf16 policy: matmul weights bf16, norms and biases f32
    bf = _leaves(params_from_numpy(host, "cpu", DtypePolicy()))
    assert bf[("enc", "blocks", "qkv_w")].dtype == torch.bfloat16
    assert bf[("dec", "tok")].dtype == torch.bfloat16
    assert bf[("enc", "blocks", "qkv_b")].dtype == torch.float32
    assert bf[("dec", "ln_w")].dtype == torch.float32
    assert bf[("enc", "conv1_b")].dtype == torch.float32


def test_encoder_and_cross_kv_match_jax(setup):
    from whisper_tpu.model.encoder import encode as jencode
    from whisper_tpu.model.encoder import precompute_cross_kv as jcross
    from whisper_tpu_torch.model.encoder import encode, precompute_cross_kv

    dims, jparams, tparams, mel, kernels = setup
    jfeat = jencode(jparams, dims, jnp.asarray(mel), compute_dtype=jnp.float32, kernels=kernels)
    jkv = jcross(jparams, dims, jfeat, compute_dtype=jnp.float32)
    feat = encode(tparams, dims, torch.from_numpy(mel), compute_dtype=torch.float32)
    kv = precompute_cross_kv(tparams, dims, feat, compute_dtype=torch.float32)
    assert feat.shape == jfeat.shape
    assert np.max(np.abs(feat.numpy() - np.asarray(jfeat))) < TOL
    for got, want in ((kv.k, jkv.k), (kv.v, jkv.v)):
        assert got.shape == want.shape  # [L, B, HD, T]
        assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


@pytest.fixture(scope="module")
def cross(setup):
    from whisper_tpu.model.encoder import encode as jencode
    from whisper_tpu.model.encoder import precompute_cross_kv as jcross
    from whisper_tpu_torch.model.encoder import CrossKV

    dims, jparams, _, mel, kernels = setup
    jfeat = jencode(jparams, dims, jnp.asarray(mel), compute_dtype=jnp.float32, kernels=kernels)
    jkv = jcross(jparams, dims, jfeat, compute_dtype=jnp.float32)
    # both decoders read the same cross K/V, so the comparison isolates them
    return jkv, CrossKV(torch.tensor(np.asarray(jkv.k)), torch.tensor(np.asarray(jkv.v)))


def test_decode_step_matches_jax_prompt_and_steps(setup, cross):
    """A left-padded prompt ingest (einsum path), then single-token steps
    (the decode-attention kernel, interpret vs plain version)."""
    from whisper_tpu.model.decoder import decode_step as jstep
    from whisper_tpu.model.decoder import init_self_kv as jinit
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv

    dims, jparams, tparams, _, kernels = setup
    jkv_x, tkv_x = cross
    prompt = [50257, 100, 200, 300]
    cap = 7
    lead = cap - len(prompt)
    padded = np.zeros((1, cap), np.int32)
    padded[0, lead:] = prompt
    start = np.array([lead], np.int32)
    pos0 = np.array([-lead], np.int32)

    jkv = jinit(dims, 1, dtype=jnp.float32)
    jl, jkv = jstep(jparams, dims, jnp.asarray(padded), jnp.asarray(pos0), jkv, jkv_x,
                    write_pos=0, attn_start=jnp.asarray(start), compute_dtype=jnp.float32,
                    kernels=kernels)
    tkv = init_self_kv(dims, 1, dtype=torch.float32, device="cpu")
    tl, tkv = decode_step(tparams, dims, torch.from_numpy(padded), torch.from_numpy(pos0), tkv,
                          tkv_x, write_pos=0, attn_start=torch.from_numpy(start),
                          compute_dtype=torch.float32)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL

    for i, tok in enumerate([400, 500, 600]):
        n_past = np.array([len(prompt) + i], np.int32)
        jl, jkv = jstep(jparams, dims, jnp.asarray([[tok]], jnp.int32), jnp.asarray(n_past), jkv,
                        jkv_x, write_pos=cap + i, attn_start=jnp.asarray(start),
                        compute_dtype=jnp.float32, kernels=kernels)
        tl, tkv = decode_step(tparams, dims, torch.tensor([[tok]], dtype=torch.int32),
                              torch.from_numpy(n_past), tkv, tkv_x, write_pos=cap + i,
                              attn_start=torch.from_numpy(start), compute_dtype=torch.float32)
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL, i
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), atol=TOL, rtol=0)


def test_incremental_equals_teacher_forced(setup, cross):
    """Feeding tokens one by one through the cache equals the teacher-forced
    pass (tests/test_model_vs_torch.py:143-170)."""
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv

    dims, _, tparams, _, _ = setup
    _, tkv_x = cross
    tokens = torch.tensor([[50257, 11, 22, 33, 44]], dtype=torch.int32)
    full, _ = decode_step(tparams, dims, tokens, torch.zeros(1, dtype=torch.int32),
                          init_self_kv(dims, 1, torch.float32, "cpu"), tkv_x,
                          compute_dtype=torch.float32, last_only=False)
    kv = init_self_kv(dims, 1, torch.float32, "cpu")
    steps = []
    for i in range(tokens.shape[1]):
        lg, kv = decode_step(tparams, dims, tokens[:, i : i + 1],
                             torch.full((1,), i, dtype=torch.int32), kv, tkv_x,
                             write_pos=i, compute_dtype=torch.float32)
        steps.append(lg)
    inc = torch.stack(steps, dim=1)
    assert (inc - full).abs().max().item() < TOL


def test_padded_prompt_matches_exact(setup, cross):
    """Left-padded ingest gives the exact prompt's last-token logits
    (tests/test_run_full.py:78)."""
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv

    dims, _, tparams, _, _ = setup
    _, tkv_x = cross
    prompt = [50257, 100, 200]
    exact, _ = decode_step(tparams, dims, torch.tensor([prompt], dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32),
                           init_self_kv(dims, 1, torch.float32, "cpu"), tkv_x,
                           compute_dtype=torch.float32)
    cap = 28
    lead = cap - len(prompt)
    padded = torch.zeros((1, cap), dtype=torch.int32)
    padded[0, lead:] = torch.tensor(prompt)
    pad, _ = decode_step(tparams, dims, padded, torch.tensor([-lead], dtype=torch.int32),
                         init_self_kv(dims, 1, torch.float32, "cpu"), tkv_x, write_pos=0,
                         attn_start=torch.tensor([lead], dtype=torch.int32),
                         compute_dtype=torch.float32)
    assert (exact - pad).abs().max().item() < TOL


def test_cache_write_past_the_end_raises(setup, cross):
    """Where JAX's dynamic_update_slice would clamp, the port raises."""
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv

    dims, _, tparams, _, _ = setup
    _, tkv_x = cross
    kv = init_self_kv(dims, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="outside cache length"):
        decode_step(tparams, dims, torch.tensor([[11]], dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), kv, tkv_x,
                    write_pos=dims.n_text_ctx, compute_dtype=torch.float32)
