"""Plain float32 Whisper: the yardstick that decides whether a run is correct.

Written from OpenAI's published model (``whisper/model.py``, ``audio.py``)
and whisper.cpp's greedy window rules, in plain PyTorch, with TF32 off. It
imports nothing of the program under test and takes nothing the program
made: it reads the raw, checkpoint-layout weights that ``benchmark.inputs``
draws from the seed (the same values the program is built from), the PCM
and the mel filterbank the benchmark makes, and the tokens the program
served, which it only judges.

  - ``log_mel``: the centred 400-point STFT in float64, the Slaney
    filterbank, log10 and Whisper's clamp to the global max - 8
  - ``encode``: conv stem, pre-LN blocks with (d/h)^-0.25 on q and k,
    ``ln_post``; ``cross_kv``: every decoder layer's K and V of the audio
  - ``decode_logits``: the decoder teacher-forced over prompt + tokens,
    causal, returning the logits before each served token
  - ``allowed_tokens``: the greedy sampler's token rules (text or
    timestamps, the initial timestamp window, the banned specials)
  - ``replay_rules``: the window rules over the served tokens

``Precision`` says which tier the configuration states and, for the
control, which lower precision to compute in. The serving tier's int8
forms (decoder weights and token table per output row, K/V per token)
are worked out here from the raw weights; the program's own are never
read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# special tokens and the mel filterbank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Specials:
    eot: int
    sot: int
    translate: int
    transcribe: int
    prev: int
    solm: int
    not_: int
    beg: int

    def lang(self, index: int) -> int:
        return self.sot + 1 + index


def specials(n_vocab: int) -> Specials:
    """OpenAI's tokenizer layout. English-only vocabularies (51864) have the
    GPT-2 specials; a multilingual one has 99 languages at 51865 and one more
    language per extra token (large-v3: 100 at 51866), after which come
    translate, transcribe, startoflm, startofprev, nospeech, notimestamps and
    the first timestamp."""
    if n_vocab < 51_865:
        return Specials(eot=50_256, sot=50_257, translate=50_358, transcribe=50_359,
                        prev=50_360, solm=50_361, not_=50_362, beg=50_363)
    n_lang = 99 + (n_vocab - 51_865)
    translate = 50_258 + 1 + n_lang
    transcribe = translate + 1
    return Specials(eot=50_257, sot=50_258, translate=translate, transcribe=transcribe,
                    prev=transcribe + 2, solm=transcribe + 3, not_=transcribe + 4,
                    beg=transcribe + 5)


def mel_filters(n_mels: int, sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """librosa's ``filters.mel(sr, n_fft, n_mels)`` (Slaney scale and area
    norm, fmax = sr / 2), which OpenAI's checkpoints carry: [n_mels, n_fft/2+1]."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def to_mel(hz):
        hz = np.asarray(hz, np.float64)
        return np.where(hz >= min_log_hz, min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
                        hz / f_sp)

    def to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), f_sp * mel)

    fft_freqs = np.linspace(0.0, sample_rate / 2, n_fft // 2 + 1)
    pts = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2), n_mels + 2))
    ramps = pts[:, None] - fft_freqs[None, :]
    fdiff = np.diff(pts)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


@contextlib.contextmanager
def full_f32():
    """float32 products without TF32, restoring the caller's settings."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def log_mel(pcm: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """[n_samples] -> normalised log-mel [n_mels, n_samples // 160] (float32),
    from a float64 STFT."""
    x = pcm.double()
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[:, :-1]
    mel = filters.double() @ spec.abs().square()
    lm = torch.clamp(mel, min=1e-10).log10()
    lm = torch.maximum(lm, lm.max() - 8.0)
    return ((lm + 4.0) / 4.0).float()


# ---------------------------------------------------------------------------
# precision: the tier a configuration states, and the control's lower one
# ---------------------------------------------------------------------------

def _int_q(x: torch.Tensor, dim, qmax: int) -> torch.Tensor:
    """Symmetric integer rounding with one scale per slice along ``dim``
    (max(amax, 1e-8) / qmax), returned dequantized."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """float8 e4m3 with one scale per slice along ``dim`` (amax to 448)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    """``weights_int8``: decoder matmul weights (self q/k/v/out, cross q/out,
    fc1, fc2) and the token table in int8, one scale per output row;
    ``kv_int8``: cross and self K/V in int8, one scale per token. ``lower``
    is the control's step down: "fp8" computes the operands of every
    product the tier holds in bfloat16 or float32 in float8 e4m3 (weights
    per output row, activations and K/V per token) and leaves the int8
    parts in int8; "int4" puts the int8 parts in int4 and leaves the rest."""

    weights_int8: bool = False
    kv_int8: bool = False
    lower: str | None = None

    def _int_bits(self) -> int:
        return 7 if self.lower == "int4" else 127

    def dec_weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.weights_int8:
            return _int_q(w, 1, self._int_bits())
        return self.weight(w)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.lower == "fp8":
            return _fp8(w, tuple(range(1, w.dim())))
        return w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.lower == "fp8" else x

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        """K or V [..., tokens, d]: one scale per token over all heads."""
        if self.kv_int8:
            return _int_q(x, -1, self._int_bits())
        return self.act(x)


def _lin(x, w, b, prec: Precision, dec: bool = False):
    w = prec.dec_weight(w.float()) if dec else prec.weight(w.float())
    y = prec.act(x) @ w.T
    return y if b is None else y + b.float()


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), LN_EPS)


def _heads(x, n_head):
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _attend(q, k, v, n_head, mask=None):
    """q [B, T, d], k/v [B, S, d], all already carrying their (d/h)^-0.25."""
    s = _heads(q, n_head) @ _heads(k, n_head).transpose(-1, -2)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    o = torch.softmax(s, dim=-1) @ _heads(v, n_head)
    b, h, t, dh = o.shape
    return o.transpose(1, 2).reshape(b, t, h * dh)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def encode(raw: dict, mel: torch.Tensor, n_head: int, prec: Precision) -> torch.Tensor:
    """mel [B, n_mels, 2 * n_ctx] -> audio features [B, n_ctx, d] (float32)."""
    e = raw["enc"]
    with full_f32():
        x = F.gelu(F.conv1d(prec.act(mel.float().transpose(1, 2)).transpose(1, 2),
                            prec.weight(e["conv1_w"].float()), e["conv1_b"].float(), padding=1))
        x = F.gelu(F.conv1d(prec.act(x.transpose(1, 2)).transpose(1, 2),
                            prec.weight(e["conv2_w"].float()), e["conv2_b"].float(), stride=2, padding=1))
        x = x.transpose(1, 2) + e["pos"][: x.shape[2]].float()
        blk = e["blocks"]
        scale = (x.shape[-1] // n_head) ** -0.25
        for i in range(blk["q_w"].shape[0]):
            h = _ln(x, blk["attn_ln_w"][i], blk["attn_ln_b"][i])
            q = _lin(h, blk["q_w"][i], blk["q_b"][i], prec) * scale
            k = _lin(h, blk["k_w"][i], None, prec) * scale
            v = _lin(h, blk["v_w"][i], blk["v_b"][i], prec)
            a = _attend(prec.act(q), prec.act(k), prec.act(v), n_head)
            x = x + _lin(a, blk["o_w"][i], blk["o_b"][i], prec)
            h = _ln(x, blk["mlp_ln_w"][i], blk["mlp_ln_b"][i])
            h = F.gelu(_lin(h, blk["fc1_w"][i], blk["fc1_b"][i], prec))
            x = x + _lin(h, blk["fc2_w"][i], blk["fc2_b"][i], prec)
        return _ln(x, e["ln_post_w"], e["ln_post_b"])


def cross_kv(raw: dict, feats: torch.Tensor, n_head: int, prec: Precision) -> list:
    """Every decoder layer's cross-attention (K, V), K carrying its
    (d/h)^-0.25, each [B, n_ctx, d] as the tier stores it."""
    blk = raw["dec"]["blocks"]
    scale = (feats.shape[-1] // n_head) ** -0.25
    out = []
    with full_f32():
        for i in range(blk["xk_w"].shape[0]):
            k = _lin(feats, blk["xk_w"][i], None, prec) * scale
            v = _lin(feats, blk["xv_w"][i], blk["xv_b"][i], prec)
            out.append((prec.kv(k), prec.kv(v)))
    return out


def decode_logits(raw: dict, tokens: torch.Tensor, rows: torch.Tensor, cross: list,
                  n_head: int, prec: Precision) -> torch.Tensor:
    """The decoder teacher-forced over ``tokens`` [B, S] (each sequence's
    real tokens first, at positions 0, 1, ...; pads after them are never
    attended by a real token), with ``cross`` from ``cross_kv``. Returns
    the logits [B, R, n_vocab] at the positions ``rows`` [B, R]."""
    d = raw["dec"]
    blk = d["blocks"]
    b, s = tokens.shape
    tok = prec.dec_weight(d["tok"].float())
    with full_f32():
        x = tok[tokens] + d["pos"][:s].float()[None]
        scale = (x.shape[-1] // n_head) ** -0.25
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        for i in range(blk["q_w"].shape[0]):
            h = _ln(x, blk["attn_ln_w"][i], blk["attn_ln_b"][i])
            q = _lin(h, blk["q_w"][i], blk["q_b"][i], prec, dec=True) * scale
            k = prec.kv(_lin(h, blk["k_w"][i], None, prec, dec=True) * scale)
            v = prec.kv(_lin(h, blk["v_w"][i], blk["v_b"][i], prec, dec=True))
            x = x + _lin(_attend(prec.act(q), k, v, n_head, causal), blk["o_w"][i], blk["o_b"][i],
                         prec, dec=True)
            h = _ln(x, blk["x_ln_w"][i], blk["x_ln_b"][i])
            q = _lin(h, blk["xq_w"][i], blk["xq_b"][i], prec, dec=True) * scale
            x = x + _lin(_attend(prec.act(q), *cross[i], n_head), blk["xo_w"][i], blk["xo_b"][i],
                         prec, dec=True)
            h = _ln(x, blk["mlp_ln_w"][i], blk["mlp_ln_b"][i])
            h = F.gelu(_lin(h, blk["fc1_w"][i], blk["fc1_b"][i], prec, dec=True))
            x = x + _lin(h, blk["fc2_w"][i], blk["fc2_b"][i], prec, dec=True)
        x = _ln(x, d["ln_w"], d["ln_b"])
        x = x.gather(1, rows[..., None].expand(-1, -1, x.shape[-1]))
        return prec.act(x) @ tok.T


# ---------------------------------------------------------------------------
# the greedy sampler's token rules and the window rules
# ---------------------------------------------------------------------------

def allowed_tokens(logits: torch.Tensor, sp: Specials, initial: torch.Tensor) -> torch.Tensor:
    """The tokens the greedy sampler may pick from ``logits`` [N, V] (a bool
    mask [N, V]): never sot, startoflm or notimestamps; at a window's first
    token (``initial`` [N]) a timestamp of the first 2 s only; and nothing
    but timestamps where the timestamps' summed probability beats every text
    token's, or at the first token."""
    v = logits.shape[-1]
    tok = torch.arange(v, device=logits.device)[None, :]
    init = initial[:, None]
    text = tok < sp.beg
    ts_ok = ~text & (~init | (tok <= sp.beg + 100))
    p = torch.softmax(logits.float(), dim=-1)
    max_text = torch.where(text, p, 0.0).amax(dim=-1, keepdim=True)
    sum_ts = torch.where(ts_ok, p, 0.0).sum(dim=-1, keepdim=True)
    take_ts = (sum_ts > max_text) | init
    banned = ((tok == sp.sot) | (tok == sp.solm) | (tok == sp.not_) | (take_ts & text)
              | (init & (tok > sp.beg + 100)))
    return ~banned


@dataclasses.dataclass
class RuleReplay:
    """What the window rules make of a window's served tokens under a fixed
    number of steps: how many of them are known fed tokens (``known``: a
    step whose token the rules drop is recorded as 0, and the token it fed
    is then unknown), whether every recorded token is one the rules keep
    (``consistent``), and the window's outputs."""

    known: int
    consistent: bool
    seek_delta: int
    result_len: int
    failed: bool


def replay_rules(tokens: np.ndarray, steps: int, beg: int, window_frames: int) -> RuleReplay:
    """whisper.cpp's rules for a window run for exactly ``steps`` token
    steps: a timestamp moves seek_delta to 2 * (id - beg) and result_len
    past it, unless it goes back in time after text, when it is dropped
    (recorded as 0); under a fixed step count no lane ends or fails early
    and result_len is the step count."""
    seek_delta, result_len, has_ts = window_frames, 0, False
    for i in range(steps):
        t = int(tokens[i])
        after_text = has_ts and result_len < i
        if t == 0 and after_text:
            return RuleReplay(i, True, seek_delta, steps, False)
        if t > beg:
            if after_text and seek_delta > 2 * (t - beg):
                return RuleReplay(i, False, seek_delta, steps, False)
            seek_delta, result_len, has_ts = 2 * (t - beg), i + 1, True
    return RuleReplay(steps, True, seek_delta, steps, False)
