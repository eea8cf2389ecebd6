"""Plain float32 Uni-MoE-2.0-Omni, audio in and text out: the yardstick of the omni family.

Written from the published configuration's description of the model
(HIT-TMG/Uni-MoE-2.0-Omni, ``config.json``; Qwen2-VL's M-RoPE and
Hugging Face's Whisper encoder), in plain PyTorch with TF32 off. It
imports nothing of the program under test: it reads tensors by the
published checkpoint's names, and only the tokens and the routing the
program recorded, which it judges. No cache and no batching: each
sequence runs whole, alone.

  - ``encode``: the Whisper encoder (conv stem, pre-LN blocks with
    (d/h)^-0.25 on q and k, the final layer norm), over a window's mel
  - ``audio_tokens``: the connector, frames averaged by ``pool`` then a
    linear layer with a bias
  - ``forward``: the language model over whole sequences, layer by layer
    (``layer(i)`` hands over one layer's tensors at a time, so a caller
    can draw them again from a seed and hold one layer): embeddings with
    the audio tokens at their placeholders, RMSNorm, grouped-query
    attention (K/V heads repeated) with M-RoPE as Qwen2-VL writes it
    (cos and sin per stream, split by ``mrope_section`` twice over),
    causal; the mixture of experts with its f32 router, the top-p cut at
    ``top_p`` capped at ``top_k``, null experts that add nothing, shared
    experts ungated and no renormalisation; the untied head.

Routing. At every layer and position the reference routes by its own
probabilities. Given the routing another run recorded (``follow``), it
compares: where the kept sets differ it records a margin, the least change
of its own probabilities that would give the recorded set (how far the
recorded experts lie below its own best ones, and how far the cut's sum
lies from ``top_p``), and then continues with the recorded choice,
weighted by its own probabilities, so that a near-tie is judged as such
and does not also count against the logits.

``Precision(lower="fp8")`` is the control: every product's weights (per
output row) and activations (per row) in float8 e4m3.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


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


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """float8 e4m3 with one scale per slice along ``dim`` (amax to 448)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    """``lower``: None (float32), or "fp8" for the control."""

    lower: str | None = None

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, tuple(range(1, w.dim()))) if self.lower == "fp8" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.lower == "fp8" else x


def _lin(x, w, b, prec: Precision):
    y = prec.act(x) @ prec.weight(w).T
    return y if b is None else y + b.float()


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), LN_EPS)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


# ---------------------------------------------------------------------------
# the audio tower and the connector
# ---------------------------------------------------------------------------

def encode(get, cfg: dict, mel: torch.Tensor, prec: Precision = Precision(), prefix: str = "model.audio_tower"):
    """mel [B, n_mels, 2 * T] -> features [B, T, whisper_hidden_size];
    ``get(name)``: a tensor by its checkpoint name."""
    def g(name):
        return get(f"{prefix}.{name}").float()

    n_head = cfg["whisper_encoder_attention_heads"]
    with full_f32():
        x = F.gelu(F.conv1d(prec.act(mel.float().transpose(1, 2)).transpose(1, 2), prec.weight(g("conv1.weight")),
                            g("conv1.bias"), padding=1))
        x = F.gelu(F.conv1d(prec.act(x.transpose(1, 2)).transpose(1, 2), prec.weight(g("conv2.weight")),
                            g("conv2.bias"), stride=2, padding=1))
        x = x.transpose(1, 2) + g("embed_positions.weight")[: x.shape[2]]
        b, t, d = x.shape
        scale = (d // n_head) ** -0.25
        for i in range(cfg["whisper_encoder_layers"]):
            p = f"layers.{i}"
            h = _ln(x, g(f"{p}.self_attn_layer_norm.weight"), g(f"{p}.self_attn_layer_norm.bias"))
            q = _lin(h, g(f"{p}.self_attn.q_proj.weight"), g(f"{p}.self_attn.q_proj.bias"), prec) * scale
            k = _lin(h, g(f"{p}.self_attn.k_proj.weight"), None, prec) * scale
            v = _lin(h, g(f"{p}.self_attn.v_proj.weight"), g(f"{p}.self_attn.v_proj.bias"), prec)
            q, k, v = (prec.act(z).view(b, t, n_head, -1).transpose(1, 2) for z in (q, k, v))
            a = (torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
            x = x + _lin(a, g(f"{p}.self_attn.out_proj.weight"), g(f"{p}.self_attn.out_proj.bias"), prec)
            h = _ln(x, g(f"{p}.final_layer_norm.weight"), g(f"{p}.final_layer_norm.bias"))
            h = F.gelu(_lin(h, g(f"{p}.fc1.weight"), g(f"{p}.fc1.bias"), prec))
            x = x + _lin(h, g(f"{p}.fc2.weight"), g(f"{p}.fc2.bias"), prec)
        return _ln(x, g("layer_norm.weight"), g("layer_norm.bias"))


def audio_tokens(get, cfg: dict, feats: torch.Tensor, prec: Precision = Precision(),
                 name: str = "model.audio_projector") -> torch.Tensor:
    """Encoder features [B, T, w] -> audio tokens [B, T / pool, hidden_size]."""
    pool = round(50 * cfg["whisper_audio_time"] / cfg["whisper_query_tokens_size"])
    b, t, w = feats.shape
    with full_f32():
        pooled = feats.float().reshape(b, t // pool, pool, w).mean(2)
        return _lin(pooled, get(f"{name}.weight").float(), get(f"{name}.bias").float(), prec)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def mrope_cos_sin(pos3: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's multimodal rotary tables: ``pos3`` [3, S] -> cos, sin [S, head_dim]."""
    dh = cfg["hidden_size"] // cfg["num_attention_heads"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, dh, 2, dtype=torch.int64, device=pos3.device).float() / dh))
    freqs = pos3.float()[..., None] * inv                          # [3, S, dh / 2]
    emb = torch.cat([freqs, freqs], dim=-1)                        # [3, S, dh]
    section = list(cfg["rope_scaling"]["mrope_section"]) * 2
    cos = torch.cat([c[i % 3] for i, c in enumerate(emb.cos().split(section, dim=-1))], dim=-1)
    sin = torch.cat([c[i % 3] for i, c in enumerate(emb.sin().split(section, dim=-1))], dim=-1)
    return cos, sin


def _rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([-x2, x1], dim=-1)


def routing(probs: list, top_p: float, top_k: int) -> list:
    """The kept experts of one position's router probabilities (a list of
    E floats), in order of probability: the shortest prefix reaching
    ``top_p``, at most ``top_k``."""
    order = sorted(range(len(probs)), key=lambda e: -probs[e])
    kept, total = [], 0.0
    for e in order[:top_k]:
        if kept and total >= top_p:
            break
        kept.append(e)
        total += probs[e]
    return kept


def margin(probs: list, recorded: list, top_p: float, top_k: int) -> float:
    """0 where ``recorded`` keeps the experts ``routing`` keeps; else the
    least change of ``probs`` that would make it so: the larger of how far
    the recorded set's least probability lies below the k-th best (k its
    size) and, where the counts differ, how far each sum between the two
    cuts lies from ``top_p``."""
    own = routing(probs, top_p, top_k)
    if set(own) == set(recorded):
        return 0.0
    p = sorted(probs, reverse=True)
    k = len(recorded)
    m = max(0.0, p[k - 1] - min(probs[e] for e in recorded))
    cum = [sum(p[: j + 1]) for j in range(len(p))]
    for j in range(min(k, len(own)) - 1, max(k, len(own)) - 1):
        m = max(m, abs(cum[j] - top_p))
    return m


def _swiglu(x, w, prefix, prec):
    g = _lin(x, w[f"{prefix}.gate_proj.weight"], None, prec)
    u = _lin(x, w[f"{prefix}.up_proj.weight"], None, prec)
    return _lin(F.silu(g) * u, w[f"{prefix}.down_proj.weight"], None, prec)


def _block(x, w: dict, cfg: dict, cos, sin, prec: Precision, follow):
    """One layer over one sequence x [S, d]: returns (x, routes [S, top_k]
    (-1 past the cut), margins [S])."""
    s, d = x.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // nh
    eps = cfg["rms_norm_eps"]
    h = _rms(x, w["input_layernorm.weight"], eps)
    q = _lin(h, w["self_attn.q_proj.weight"], w["self_attn.q_proj.bias"], prec).view(s, nh, dh).transpose(0, 1)
    k = _lin(h, w["self_attn.k_proj.weight"], w["self_attn.k_proj.bias"], prec).view(s, nkv, dh).transpose(0, 1)
    v = _lin(h, w["self_attn.v_proj.weight"], w["self_attn.v_proj.bias"], prec).view(s, nkv, dh).transpose(0, 1)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    k = k.repeat_interleave(nh // nkv, dim=0)
    v = v.repeat_interleave(nh // nkv, dim=0)
    scores = prec.act(q) @ prec.act(k).transpose(-1, -2) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1) @ prec.act(v)
    x = x + _lin(att.transpose(0, 1).reshape(s, d), w["self_attn.o_proj.weight"], None, prec)

    h = _rms(x, w["post_attention_layernorm.weight"], eps)
    n_routed, top_p, top_k = cfg["mlp_dynamic_expert_num"], cfg["mlp_dynamic_top_p"], cfg["mlp_dynamic_top_k"]
    probs = torch.softmax(_lin(h, w["mlp.gate.weight"], None, prec), dim=-1)
    chosen, margins = [], [0.0] * s
    recorded = None if follow is None else follow.tolist()
    for j, pj in enumerate(probs.cpu().tolist()):
        kept = routing(pj, top_p, top_k)
        if recorded is not None:
            rec = [e for e in recorded[j] if e >= 0]
            margins[j] = margin(pj, rec, top_p, top_k)
            kept = rec
        chosen.append(kept + [-1] * (top_k - len(kept)))
    routes, margins = torch.tensor(chosen, dtype=torch.long), torch.tensor(margins)
    out = sum(_swiglu(h, w, f"mlp.shared_experts.{e}", prec) for e in range(cfg["mlp_fixed_expert_num"]))
    for e in range(n_routed):
        rows = (routes == e).any(-1).nonzero().squeeze(1).to(x.device)
        if rows.numel():
            y = _swiglu(h[rows], w, f"mlp.experts.{e}", prec)
            out = out.index_add(0, rows, y * probs[rows, e:e + 1])
    return x + out, routes, margins


def forward(layer, top: dict, cfg: dict, seqs: list, prec: Precision = Precision(), follow: list | None = None,
            rows: list | None = None) -> list:
    """The language model over each sequence of ``seqs``, a list of (ids
    [S] (int64), audio tokens [A, d], n): the audio takes, in order, the
    positions among the first n (the prompt) that hold ``audio_token_id``;
    after them every id is a token. Layer by layer: ``layer(i)`` returns
    layer i's tensors by their names after ``model.layers.<i>.``; ``top``
    holds ``model.embed_tokens.weight``, ``model.norm.weight`` and
    ``lm_head.weight``. ``follow``: per sequence, the routing [L, S,
    top_k] to continue with (else its own). ``rows``: per sequence, the
    positions whose logits are wanted (else all). Returns per sequence
    {"logits": [R, V], "routes": [L, S, top_k], "margins": [L, S]}."""
    with full_f32():
        emb = top["model.embed_tokens.weight"]
        xs = []
        for ids, audio, n in seqs:
            is_audio = (ids == cfg["audio_token_id"]) & (torch.arange(len(ids), device=ids.device) < n)
            x = emb[torch.where(is_audio, 0, ids)].float()
            x[is_audio] = audio.float()
            xs.append(x)
        tables = [mrope_cos_sin(torch.arange(len(ids), device=emb.device)[None].expand(3, -1), cfg)
                  for ids, _, _ in seqs]
        routes = [[] for _ in seqs]
        margins = [[] for _ in seqs]
        for i in range(cfg["num_hidden_layers"]):
            w = {k: t.float() for k, t in layer(i).items()}
            for n, (cos, sin) in enumerate(tables):
                xs[n], r, m = _block(xs[n], w, cfg, cos[None], sin[None], prec,
                                     None if follow is None else follow[n][i])
                routes[n].append(r)
                margins[n].append(m)
            del w
        head = prec.weight(top["lm_head.weight"])
        out = []
        for n, x in enumerate(xs):
            if rows is not None:
                x = x[torch.as_tensor(rows[n], device=x.device)]
            h = _rms(x, top["model.norm.weight"], cfg["rms_norm_eps"])
            out.append({"logits": prec.act(h) @ head.T, "routes": torch.stack(routes[n]),
                        "margins": torch.stack(margins[n])})
        return out
