"""Plain float32 LongCat-Flash-Omni language model, one card's expert share: the yardstick of the longcat family.

Written from transformers' LongcatFlash code (``models/longcat_flash/
modeling_longcat_flash.py``, 4.57) and the published configuration, in
plain PyTorch with TF32 off. It imports nothing of the program under test:
it reads tensors by the checkpoint's names, and only the tokens and the
routing the program recorded, which it judges. No cache and no batching:
each sequence runs whole, alone, with latent attention in its expanded form
(``kv_b`` applied to the latent, every head's keys and values).

A double layer over x:

    h1 = x + MLA_0(RMSNorm(x));  n1 = RMSNorm(h1)
    m  = MoE(n1)                                  the shortcut branch
    h2 = h1 + FFN_0(n1)
    h3 = h2 + MLA_1(RMSNorm(h2))
    y  = h3 + FFN_1(RMSNorm(h3)) + m

MLA: ``q = q_b(RMSNorm(q_a x)) * (d / q_rank)^0.5``, heads of 128 + 64;
``[c, k_rope] = kv_a x``, ``c = RMSNorm(c) * (d / kv_rank)^0.5``; ``k_nope``
and ``v`` from ``kv_b c``; RoPE on the 64 rope dimensions in the
interleaved layout (each pair of adjacent dimensions gathered into halves,
then rotate-half), ``k_rope`` one head for all; scale (128 + 64)^-0.5,
causal; ``o`` over the heads' values.

MoE: the router ``softmax(n1_f32 @ W_r)`` over the published routed and
the zero experts; the top ``moe_topk`` of ``scores + e_score_correction_bias``
are chosen, each weighted by its score (without the bias) times
``routed_scaling_factor``, not renormalised. A routed expert is a SwiGLU; a
zero expert is the identity. The expert share: only the routed experts
``expert_share.held`` (this card's) are computed, and the zero experts;
a choice of a routed expert another card holds adds nothing here, as in the
program.

Departures from transformers' code: the audio positions take the audio
tokens in place of embeddings (the model's own audio path is not drawn:
``omni_ref.encode`` and ``omni_ref.audio_tokens``, the Whisper stand-in,
make them); the expert share above; tensors are handed over one double
layer at a time (``layer(i)``), so that a caller can draw them again from
a seed and hold one layer; and no rope_scaling.

Routing. At every layer and position the reference routes by its own
selection scores. Given the routing another run recorded (``follow``), it
compares: where the chosen sets differ it records a margin, how far the
least recorded choice's selection score lies below the reference's own
``moe_topk``-th best, in units of the mean score 1/n_experts, and then
continues with the recorded choice, weighted by its own scores, so that a
near-tie is judged as such and does not also count against the logits.

``Precision`` (``omni_ref``'s) takes the control: every product's weights
(per output row) and activations (per row) in float8 e4m3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.omni_ref import Precision, full_f32

__all__ = ["Precision", "forward", "rope_tables", "moe", "margin"]


def _lin(x, w, prec: Precision):
    return prec.act(x) @ prec.weight(w).T


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope_tables(n: int, cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [n, rope_dim] for positions 0..n-1 (rotate-half layout)."""
    dr = cfg["qk_rope_head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, dr, 2, dtype=torch.int64, device=device).float() / dr))
    freqs = torch.arange(n, device=device).float()[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope(x, cos, sin):
    """Interleaved RoPE of x [..., S, dr]: adjacent pairs gathered into halves, then rotate-half."""
    s, dr = x.shape[-2:]
    x = x.reshape(*x.shape[:-1], dr // 2, 2).transpose(-1, -2).reshape(*x.shape[:-1], dr)
    half = torch.cat([-x[..., dr // 2:], x[..., : dr // 2]], dim=-1)
    return x * cos + half * sin


def _mla(x, w: dict, j: int, cfg: dict, cos, sin, prec: Precision):
    s, d = x.shape
    h, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    a = f"self_attn.{j}."
    q = _lin(_rms(_lin(x, w[a + "q_a_proj.weight"], prec), w[a + "q_a_layernorm.weight"], 1e-6),
             w[a + "q_b_proj.weight"], prec)
    q = q.view(s, h, dn + dr).transpose(0, 1) * (d / cfg["q_lora_rank"]) ** 0.5      # [H, S, 192]
    ckv = _lin(x, w[a + "kv_a_proj_with_mqa.weight"], prec)
    c = _rms(ckv[:, : cfg["kv_lora_rank"]], w[a + "kv_a_layernorm.weight"], 1e-6) * (d / cfg["kv_lora_rank"]) ** 0.5
    kv = _lin(c, w[a + "kv_b_proj.weight"], prec).view(s, h, dn + dv).transpose(0, 1)  # [H, S, 256]
    k_rope = _rope(ckv[None, :, cfg["kv_lora_rank"]:], cos, sin).expand(h, s, dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope], dim=-1)
    scores = prec.act(q) @ prec.act(k).transpose(-1, -2) * (dn + dr) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1) @ prec.act(kv[..., dn:])
    return _lin(att.transpose(0, 1).reshape(s, h * dv), w[a + "o_proj.weight"], prec)


def _swiglu(x, w, prefix, prec):
    g = _lin(x, w[f"{prefix}.gate_proj.weight"], prec)
    u = _lin(x, w[f"{prefix}.up_proj.weight"], prec)
    return _lin(F.silu(g) * u, w[f"{prefix}.down_proj.weight"], prec)


def margin(select: torch.Tensor, recorded: torch.Tensor, top_k: int) -> torch.Tensor:
    """Per row of selection scores ``select`` [S, E]: 0 where ``recorded``
    [S, top_k] chooses the set the top ``top_k`` choose, else how far the
    least recorded choice lies below the top_k-th best, in units of the
    mean score 1 / E."""
    own = select.topk(top_k, dim=-1).indices
    same = (own.sort(-1).values == recorded.sort(-1).values).all(-1)
    kth = select.topk(top_k, dim=-1).values[:, -1]
    least = select.gather(1, recorded).min(-1).values
    return torch.where(same, 0.0, (kth - least).clamp_min(0) * select.shape[-1])


def moe(n1, w: dict, cfg: dict, prec: Precision, follow: torch.Tensor | None = None):
    """The expert layer over rows n1 [S, d]: (its output [S, d], the chosen
    experts [S, top_k] by the reference's own selection or ``follow``'s,
    margins [S])."""
    n_pub, (lo, hi) = cfg["expert_share"]["published"], cfg["expert_share"]["held"]
    top_k = cfg["moe_topk"]
    scores = torch.softmax(_lin(n1, w["mlp.router.classifier.weight"], prec), dim=-1)
    select = scores + w["mlp.router.e_score_correction_bias"].float()
    chosen = select.topk(top_k, dim=-1).indices
    margins = torch.zeros(len(n1), device=n1.device)
    if follow is not None:
        follow = follow.to(n1.device)
        margins = margin(select, follow, top_k)
        chosen = follow
    weight = scores.gather(1, chosen) * cfg["routed_scaling_factor"]
    out = (weight * (chosen >= n_pub)).sum(-1, keepdim=True) * n1             # the zero experts
    for e in range(lo, hi):
        hit = chosen == e
        rows = hit.any(-1).nonzero().squeeze(1)
        if rows.numel():
            y = _swiglu(n1[rows], w, f"mlp.experts.{e}", prec)
            out = out.index_add(0, rows, y * (weight[rows] * hit[rows]).sum(-1, keepdim=True))
    return out, chosen, margins


def _double(x, w: dict, cfg: dict, cos, sin, prec: Precision, follow):
    eps = cfg["rms_norm_eps"]
    h1 = x + _mla(_rms(x, w["input_layernorm.0.weight"], eps), w, 0, cfg, cos, sin, prec)
    n1 = _rms(h1, w["post_attention_layernorm.0.weight"], eps)
    m, routes, margins = moe(n1, w, cfg, prec, follow)
    h2 = h1 + _swiglu(n1, w, "mlps.0", prec)
    h3 = h2 + _mla(_rms(h2, w["input_layernorm.1.weight"], eps), w, 1, cfg, cos, sin, prec)
    return h3 + _swiglu(_rms(h3, w["post_attention_layernorm.1.weight"], eps), w, "mlps.1", prec) + m, routes, margins


def forward(layer, top: dict, cfg: dict, seqs: list, prec: Precision = Precision(), follow: list | None = None,
            rows: list | None = None) -> list:
    """The language model over each sequence of ``seqs``, a list of (ids
    [S] (int64), audio tokens [A, d] or None, n): the audio takes, in
    order, the positions among the first n (the prompt) that hold
    ``audio_token_id``; after them every id is a token. Double layer by
    double layer: ``layer(i)`` returns layer i's tensors by their names
    after ``model.layers.<i>.``; ``top`` holds ``model.embed_tokens.weight``,
    ``model.norm.weight`` and ``lm_head.weight``. ``follow``: per sequence,
    the routing [L, S, top_k] to continue with (else its own). ``rows``:
    per sequence, the positions whose logits are wanted (else all). Returns
    per sequence {"logits": [R, V], "routes": [L, S, top_k], "margins": [L, S]}."""
    with full_f32():
        emb = top["model.embed_tokens.weight"]
        xs = []
        for ids, audio, n in seqs:
            x = emb[ids].float()
            if audio is not None:
                is_audio = (ids == cfg["audio_token_id"]) & (torch.arange(len(ids), device=ids.device) < n)
                x[is_audio] = audio.float()
            xs.append(x)
        tables = [rope_tables(len(ids), cfg, emb.device) for ids, _, _ in seqs]
        routes = [[] for _ in seqs]
        margins = [[] for _ in seqs]
        for i in range(cfg["num_layers"]):
            w = {k: t.float() for k, t in layer(i).items()}
            for n, (cos, sin) in enumerate(tables):
                xs[n], r, m = _double(xs[n], w, cfg, cos, sin, prec, None if follow is None else follow[n][i])
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
