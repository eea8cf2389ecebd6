"""The benchmark's plain float32 reference against the port's CPU path, at test sizes.

The reference imports nothing of the port; these tests hold the two
against each other on the same raw weights: the mel front end (80 and 128
mel bins), the encoder and every decoder layer's cross K/V, the decoder's
logits over a prompt and served tokens (4- and 2-layer decoders, the bf16
tier's layout and the serving tier's int8 forms), the special ids of the
three vocabulary sizes, and the window rules over a window the port ran.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.inputs import Dims, draw_pcm, draw_raw
from benchmark.reference import whisper_ref as ref
from tiny import TINY
from whisper_tpu_torch.ggml import mel_filter_bank
from whisper_tpu_torch.features.mel import LogMelSpectrogram
from whisper_tpu_torch.model.decoder import decode_step, init_self_kv
from whisper_tpu_torch.model.encoder import encode, precompute_cross_kv
from whisper_tpu_torch.model.params import DtypePolicy
from whisper_tpu_torch.runtime.context import WhisperRuntime
from whisper_tpu_torch.vocab import Vocabulary

CPU = torch.device("cpu")
F32 = DtypePolicy.f32()
F32_INT8 = DtypePolicy(torch.float32, torch.float32, torch.float32, weights_int8=True)
VARIANTS = [dict(num_mel_bins=80, decoder_layers=4, vocab_size=51865),
            dict(num_mel_bins=128, decoder_layers=2, vocab_size=51866)]


def dims_of(**kw) -> Dims:
    return Dims(dict(TINY, **kw))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_filters_and_log_mel_match_port(n_mels):
    filters = ref.mel_filters(n_mels)
    np.testing.assert_allclose(filters, mel_filter_bank(n_mels), rtol=1e-5, atol=1e-7)
    pcm = draw_pcm(5, 0, 3.3, CPU)
    got = LogMelSpectrogram(filters, device="cpu")(pcm)
    want = ref.log_mel(pcm, torch.from_numpy(filters))
    assert got.shape == want.shape == (n_mels, 330)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("kw", VARIANTS)
def test_encoder_and_cross_kv_match_port(kw):
    dims = dims_of(**kw)
    raw = draw_raw(dims, 11, CPU)
    params = program.build_params(raw, dims, F32)
    mel = torch.stack([ref.log_mel(draw_pcm(11, i, 1.92, CPU), torch.from_numpy(ref.mel_filters(dims.n_mels)))
                       for i in range(2)])
    feats = encode(params, program.model_dims(dims), mel, compute_dtype=torch.float32)
    want = ref.encode(raw, mel, dims.enc_heads, ref.Precision())
    torch.testing.assert_close(feats, want, rtol=1e-4, atol=1e-4)
    cross = precompute_cross_kv(params, program.model_dims(dims), want, compute_dtype=torch.float32)
    for i, (k, v) in enumerate(ref.cross_kv(raw, want, dims.dec_heads, ref.Precision())):
        torch.testing.assert_close(cross.k[i].transpose(1, 2), k, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(cross.v[i].transpose(1, 2), v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-layout", "serving-int8"])
def test_decoder_logits_match_port(kw, int8):
    """Teacher-forced logits over two sequences of different lengths, against
    the port's decoder over the same tokens (one pass over a fresh cache)."""
    dims = dims_of(**kw)
    sp = ref.specials(dims.n_vocab)
    raw = draw_raw(dims, 12, CPU)
    params = program.build_params(raw, dims, F32_INT8 if int8 else F32)
    prec = ref.Precision(weights_int8=int8, kv_int8=int8)
    feats = torch.randn((2, dims.n_audio_ctx, dims.d), generator=torch.Generator().manual_seed(1))
    md = program.model_dims(dims)
    cross = precompute_cross_kv(params, md, feats, compute_dtype=torch.float32, quant=int8)
    seqs = [[sp.sot, sp.lang(0), sp.transcribe, sp.beg + 3, 220, sp.beg + 40, 1000, 2000],
            [sp.prev, 500, 600, sp.sot, sp.lang(0), sp.transcribe]]
    ref_cross = ref.cross_kv(raw, feats, dims.dec_heads, prec)
    for b, seq in enumerate(seqs):
        toks = torch.tensor([seq])
        kv = init_self_kv(md, 1, dtype=torch.float32, device="cpu", quant=int8)
        one = type(cross)(*(None if a is None else a[:, b: b + 1] for a in cross))
        got, _ = decode_step(params, md, toks, torch.zeros(1, dtype=torch.int32), kv, one,
                             compute_dtype=torch.float32, last_only=False)
        sel = torch.arange(len(seq))[None]
        want = ref.decode_logits(raw, toks, sel, [(k[b: b + 1], v[b: b + 1]) for k, v in ref_cross],
                                 dims.dec_heads, prec)
        scale = want.abs().max()
        assert (got - want).abs().max() <= 2e-3 * scale, (got - want).abs().max() / scale


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
def test_specials_match_port_vocabulary(n_vocab):
    v = Vocabulary([], n_vocab)
    sp = ref.specials(n_vocab)
    assert (sp.eot, sp.sot, sp.prev, sp.solm, sp.not_, sp.beg, sp.translate, sp.transcribe) == (
        v.token_eot, v.token_sot, v.token_prev, v.token_solm, v.token_not, v.token_beg,
        v.token_translate, v.token_transcribe)


@pytest.mark.parametrize("kw", VARIANTS)
def test_window_rules_and_gaps_on_a_port_window(kw):
    """The port's forced window at f32: its rule outputs are the replay's,
    and every served token is the reference's best (gap ~0)."""
    dims = dims_of(**kw)
    sp = ref.specials(dims.n_vocab)
    raw = draw_raw(dims, 13, CPU)
    params = program.build_params(raw, dims, F32)
    rt = WhisperRuntime(params, program.model_dims(dims), program.special_ids(sp),
                        compute_dtype=torch.float32, device="cpu")
    filters = torch.from_numpy(ref.mel_filters(dims.n_mels))
    mel = torch.stack([ref.log_mel(draw_pcm(13, i, 1.92, CPU), filters) for i in range(2)])
    _, cross = rt.encode_window(mel)
    prompt = np.zeros((2, rt.prompt_capacity), np.int32)
    heads = [[sp.sot, sp.lang(0), sp.transcribe], [sp.prev, 300, 301, sp.sot, sp.lang(0), sp.transcribe]]
    for i, h in enumerate(heads):
        prompt[i, : len(h)] = h
    steps = 8
    res = rt.run_window(prompt, np.array([3, 6], np.int32), cross, np.zeros(2, np.int32),
                        np.full(2, 10**6, np.int32), force_steps=steps)
    feats = ref.encode(raw, mel, dims.enc_heads, ref.Precision())
    rc = ref.cross_kv(raw, feats, dims.dec_heads, ref.Precision())
    for b, h in enumerate(heads):
        toks = res.tokens[b, :steps].numpy()
        rp = ref.replay_rules(toks, steps, sp.beg, dims.window_frames)
        assert rp.known == steps and rp.consistent
        assert (rp.seek_delta, rp.result_len, rp.failed) == (
            int(res.seek_delta[b]), int(res.result_len[b]), bool(res.failed[b]))
        seq = torch.tensor([h + toks.tolist()])
        rows = torch.arange(len(h) - 1, len(h) - 1 + steps)[None]
        logits = ref.decode_logits(raw, seq, rows, [(k[b: b + 1], v[b: b + 1]) for k, v in rc],
                                   dims.dec_heads, ref.Precision())[0]
        initial = torch.zeros(steps, dtype=torch.bool)
        initial[0] = True
        allowed = ref.allowed_tokens(logits, sp, initial)
        best = torch.where(allowed, logits, float("-inf")).amax(-1)
        served = torch.as_tensor(toks, dtype=torch.long)
        assert bool(allowed[torch.arange(steps), served].all())
        assert float((best - logits[torch.arange(steps), served]).max()) < 1e-4
