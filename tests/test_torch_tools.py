"""The port's tools against the JAX package's, on the CPU: synthetic
parameters (``tools/synthetic.py``), the trace diff
(``tools/compare_traces.py``) and the HF -> GGML converter
(``tools/convert_hf_to_ggml.py``).

Tolerances: the int8 quantization and the converter's bytes are exact; the
encoder traces agree within 1e-4 (f32 on both sides, summation order only).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int8): torch.int8}


def _jax_tree(weights_int8, seed=0):
    from whisper_tpu.tools.synthetic import make_synthetic_params as jax_synth

    return jax_synth(TINY_TEST_DIMS, jnp.bfloat16, seed=seed, weights_int8=weights_int8)


@pytest.mark.parametrize("weights_int8", [False, True], ids=["bf16", "serving"])
def test_synthetic_tree_matches_jax(weights_int8):
    """Keys, shapes and dtypes of every leaf equal the JAX tree's (whose
    blocks are stacked [L, ...]; the port's are one Block per layer)."""
    from whisper_tpu_torch.tools.synthetic import make_synthetic_params

    want = _jax_tree(weights_int8)
    got = make_synthetic_params(TINY_TEST_DIMS, torch.bfloat16, weights_int8=weights_int8,
                                device="cpu")
    for part in ("enc", "dec"):
        mod, tree = getattr(got, part), want[part]
        top = {k for k, _ in mod.named_buffers(recurse=False)}
        assert top == set(tree) - {"blocks"}
        for k in top:
            t, a = getattr(mod, k), tree[k]
            assert (tuple(t.shape), t.dtype) == (a.shape, _DTYPES[a.dtype]), (part, k)
            assert t.device.type == "cpu"
        assert len(mod.blocks) == next(iter(tree["blocks"].values())).shape[0]
        for blk in mod.blocks:
            assert {k for k, _ in blk.named_buffers()} == set(tree["blocks"])
            for k, a in tree["blocks"].items():
                t = getattr(blk, k)
                assert (tuple(t.shape), t.dtype) == (a.shape[1:], _DTYPES[a.dtype]), (part, k)


def test_synthetic_int8_quantization_is_jax_exactly():
    """Fed the JAX tree's bf16 weights, the port's quantize_int8 gives the
    JAX serving tree's codes and scales bit for bit."""
    from whisper_tpu.model.params import _QUANT_KEYS
    from whisper_tpu_torch.tools.synthetic import quantize_int8

    plain, quant = _jax_tree(False, seed=3), _jax_tree(True, seed=3)

    def f32(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    pairs = [(plain["dec"]["blocks"][k], quant["dec"]["blocks"][k], quant["dec"]["blocks"][k + "_s"])
             for k in sorted(_QUANT_KEYS)]
    for w, codes, scales in pairs:
        q, s = quantize_int8(f32(w))
        np.testing.assert_array_equal(q.numpy(), np.asarray(codes))
        np.testing.assert_array_equal(s.numpy(), np.asarray(scales))
    q, s = quantize_int8(f32(plain["dec"]["tok"]).T)
    np.testing.assert_array_equal(q.T.numpy(), np.asarray(quant["dec"]["tok"]))
    np.testing.assert_array_equal(s.T.numpy(), np.asarray(quant["dec"]["tok_s"]))


@pytest.mark.parametrize("tier", ["f32", "serving"])
def test_synthetic_params_run_the_window_loop(tier):
    """Synthetic params in the port's tree drive encode and decode on the
    CPU: finite features, tokens in range, the forced step count."""
    from whisper_tpu_torch.runtime.context import WhisperRuntime
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.tools.synthetic import TIERS, make_synthetic_params

    policy, kv_int8 = TIERS[tier]
    dims = TINY_TEST_DIMS
    params = make_synthetic_params(dims, policy.param_dtype, weights_int8=policy.weights_int8,
                                   device="cpu")
    ids = SpecialIds(eot=50_256, sot=50_257, prev=50_360, solm=50_361, not_=50_362, beg=50_363)
    rt = WhisperRuntime(params, dims, ids, compute_dtype=policy.compute_dtype, device="cpu",
                        kv_int8=kv_int8)
    mel = np.random.default_rng(0).standard_normal((2, 80, 2 * dims.n_audio_ctx)).astype(np.float32)
    feats, cross = rt.encode_window(mel)
    assert bool(torch.isfinite(feats).all())
    prompt = np.zeros((2, rt.prompt_capacity), np.int32)
    prompt[:, 0] = ids.sot
    res = rt.run_window(prompt, np.ones(2, np.int32), cross, np.zeros(2, np.int32),
                        np.full(2, 10**7, np.int32), force_steps=3)
    assert int(res.steps) == 3
    assert bool(((res.tokens >= 0) & (res.tokens < dims.n_vocab)).all())


def test_encoder_traces_compare_across_packages(tmp_path, capsys):
    """One trace by the JAX package's TraceWriter, one by the port's, of the
    same f32 encoder on the same mel at TINY_TEST_DIMS: each package's
    compare_traces reads both and finds them within 1e-4; the port's CLI
    prints the table."""
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model.encoder import encode as jencode
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu.model.params import params_from_checkpoint as jparams
    from whisper_tpu.obs import trace as jtrace
    from whisper_tpu_torch.model.encoder import encode
    from whisper_tpu_torch.model.params import DtypePolicy, load_params
    from whisper_tpu_torch.obs import trace as ttrace
    from whisper_tpu_torch.tools.compare_traces import main

    path = str(tmp_path / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=7)
    mel = np.random.default_rng(1).standard_normal((1, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)

    jw = jtrace.TraceWriter(str(tmp_path / "jax"))
    jp = jparams(jload(path), JPolicy.f32())
    jw.tensor("mel", mel)
    jw.tensor("enc.features", jencode(jp, TINY_TEST_DIMS, jnp.asarray(mel), compute_dtype=jnp.float32))

    tw = ttrace.TraceWriter(str(tmp_path / "torch"))
    dims, tp, _ = load_params(path, DtypePolicy.f32(), device="cpu")
    x = ttrace.traced(tw, "mel", torch.from_numpy(mel))
    feats = ttrace.traced(tw, "enc.features", encode(tp, dims, x, compute_dtype=torch.float32))
    assert feats.shape == (1, TINY_TEST_DIMS.n_audio_ctx, TINY_TEST_DIMS.n_audio_state)

    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    for compare in (jtrace.compare_traces, ttrace.compare_traces):
        for x, y in ((a, b), (b, a)):
            diffs = compare(x, y)
            assert [d.name for d in diffs] == ["mel", "enc.features"]
            assert diffs[0].max_abs_diff == 0.0
            assert diffs[1].max_abs_diff < 1e-4
    assert main([a, b, "--top", "1"]) == 0
    out = capsys.readouterr().out
    assert "maxAbsDiff" in out and "enc.features" in out and "mel" not in out.split("\n", 1)[1]


def _hf_dir(tmp_path):
    """A randomly initialised WhisperForConditionalGeneration at TINY_TEST_DIMS
    and a 259-token byte-level tokenizer, saved as a local model directory
    (no download)."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration, WhisperTokenizer
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    d = TINY_TEST_DIMS
    torch.manual_seed(0)
    config = WhisperConfig(
        vocab_size=d.n_vocab, num_mel_bins=d.n_mels, d_model=d.n_audio_state,
        encoder_layers=d.n_audio_layer, encoder_attention_heads=d.n_audio_head,
        decoder_layers=d.n_text_layer, decoder_attention_heads=d.n_text_head,
        encoder_ffn_dim=4 * d.n_audio_state, decoder_ffn_dim=4 * d.n_text_state,
        max_source_positions=d.n_audio_ctx, max_target_positions=d.n_text_ctx,
    )
    out = tmp_path / "hf"
    WhisperForConditionalGeneration(config).save_pretrained(out)
    b2u = bytes_to_unicode()
    vocab = {b2u[b]: i for i, b in enumerate(range(256))}
    vocab.update({"Ġh": 256, "hi": 257, "<|endoftext|>": 258})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nĠ h\nh i\n")
    WhisperTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")).save_pretrained(out)
    return str(out)


@pytest.mark.parametrize("f32", [False, True], ids=["f16", "f32"])
def test_convert_hf_to_ggml_writes_the_jax_tools_bytes(tmp_path, monkeypatch, capsys, f32):
    """The port's converter writes the JAX tool's file byte for byte, and the
    file loads through the port's Model and transcribes on the CPU."""
    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed: no WhisperForConditionalGeneration to convert")
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.tools.convert_hf_to_ggml import main

    model_dir = _hf_dir(tmp_path)
    flag = ["--f32"] if f32 else []
    spec = importlib.util.spec_from_file_location("jax_convert", os.path.join(ROOT, "tools",
                                                                           "convert_hf_to_ggml.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want = str(tmp_path / "jax.bin")
    monkeypatch.setattr(sys, "argv", ["convert_hf_to_ggml.py", "--model", model_dir, "--out", want, *flag])
    assert jax_tool.main() == 0
    got = str(tmp_path / "torch.bin")
    assert main(["--model", model_dir, "--out", got, *flag]) == 0
    assert "wrote" in capsys.readouterr().out
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()

    model = Model(got, device="cpu")
    want_dims = dataclasses.replace(TINY_TEST_DIMS, ftype=0 if f32 else 1)
    assert dataclasses.astuple(model.dims) == dataclasses.astuple(want_dims)
    res = model.create_context().run_full(None, np.zeros(16_000, np.float32))
    assert isinstance(res.segments, list)
