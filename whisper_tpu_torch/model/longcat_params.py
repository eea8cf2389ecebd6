"""LongCat-Flash-Omni's audio-to-text path, one card's share of it: its sizes and its parameters.

The language model (meituan-longcat/LongCat-Flash-Omni, ``model_type``
``longcat_flash``) is a stack of "double layers" with latent attention and a
shortcut-connected expert layer (``model/longcat.py`` has the equations).
``LongcatDims`` reads its sizes from a configuration under the published
``config.json``'s key names, plus:

  - ``expert_share``: the deployment's split of the routed experts over
    cards (``published``, ``cards``, ``rank``, ``held`` = [lo, hi)); this
    card holds routed experts lo..hi - 1 of every layer, and
    ``n_routed_experts`` is their count. The router scores all
    ``published`` + ``zero_expert_num`` outputs;
  - ``audio_config``: the audio tower, the Whisper encoder under the
    ``whisper_*`` keys (``model/omni_params.py:whisper_tower``), and a
    linear connector to the hidden size;
  - ``audio_token_id``: the placeholder id an audio position holds.

``params_from_tensors`` builds the parameter modules from tensors named as
transformers' LongcatFlash code names them (``tensor_names`` lists them;
Hugging Face Whisper's names for the audio tower). It pops each tensor from
the caller's dict as it converts it and keeps matmul weights in the
checkpoint's [out, in] layout, read through a transposed view, so nothing
is copied but each dense FFN's and expert's gate and up, fused. ``kv_b`` is
kept whole for the prefill's expanded attention, and as two views of the
same storage, its K and V halves per head, for the token step's absorbed
attention.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.model.omni_params import (
    LM, PROJECTOR, audio_tensor_names, encoder_from_tensors, pop_tensor, whisper_tower)
from whisper_tpu_torch.model.params import DtypePolicy
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup


@dataclasses.dataclass(frozen=True)
class LongcatDims:
    """The audio-to-text path's sizes (published ``config.json`` names in
    the comments)."""

    d: int                    # hidden_size
    n_layer: int              # num_layers: double layers, each two attention sublayers
    n_head: int               # num_attention_heads
    q_rank: int               # q_lora_rank
    kv_rank: int              # kv_lora_rank: the latent's width
    nope_dim: int             # qk_nope_head_dim
    rope_dim: int             # qk_rope_head_dim
    v_dim: int                # v_head_dim
    ffn: int                  # ffn_hidden_size: each dense FFN's width
    expert_width: int         # expert_ffn_hidden_size
    n_published: int          # expert_share.published: the routed experts of a layer
    held: tuple               # expert_share.held: [lo, hi), the routed experts this card holds
    n_zero: int               # zero_expert_num: identity experts
    top_k: int                # moe_topk
    routed_scale: float       # routed_scaling_factor
    rms_eps: float            # rms_norm_eps
    rope_theta: float         # rope_theta
    n_vocab: int              # vocab_size
    audio: ModelDims          # the Whisper encoder (audio_config)
    audio_pool: int           # encoder frames averaged into one audio token
    audio_token_id: int       # the placeholder id an audio position holds in a prompt

    @property
    def n_held(self) -> int:
        return self.held[1] - self.held[0]

    @property
    def n_experts(self) -> int:
        """Router outputs: the published routed experts, then the zero experts."""
        return self.n_published + self.n_zero

    @property
    def n_sublayers(self) -> int:
        """Attention sublayers: two a double layer, each with its latent cache."""
        return 2 * self.n_layer

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim

    @property
    def latent_dim(self) -> int:
        """Cache columns' width: the latent, then the shared rotated key."""
        return self.kv_rank + self.rope_dim

    @property
    def q_scale(self) -> float:
        return (self.d / self.q_rank) ** 0.5

    @property
    def kv_scale(self) -> float:
        return (self.d / self.kv_rank) ** 0.5

    @property
    def attn_scale(self) -> float:
        return self.qk_dim ** -0.5

    @property
    def audio_tokens(self) -> int:
        """Audio tokens of one 30 s window."""
        return self.audio.n_audio_ctx // self.audio_pool

    @staticmethod
    def from_config(cfg: dict) -> "LongcatDims":
        if cfg.get("attention_bias") or cfg.get("rope_scaling"):
            raise ValueError("attention biases and rope_scaling are not on this path")
        if cfg.get("zero_expert_type", "identity") != "identity" or not cfg.get("mla_scale_q_lora", True) \
                or not cfg.get("mla_scale_kv_lora", True):
            raise ValueError("this path takes identity zero experts and both MLA scales")
        share = cfg["expert_share"]
        audio, pool = whisper_tower(cfg["audio_config"])
        dims = LongcatDims(
            d=cfg["hidden_size"], n_layer=cfg["num_layers"], n_head=cfg["num_attention_heads"],
            q_rank=cfg["q_lora_rank"], kv_rank=cfg["kv_lora_rank"], nope_dim=cfg["qk_nope_head_dim"],
            rope_dim=cfg["qk_rope_head_dim"], v_dim=cfg["v_head_dim"], ffn=cfg["ffn_hidden_size"],
            expert_width=cfg["expert_ffn_hidden_size"], n_published=share["published"],
            held=tuple(share["held"]), n_zero=cfg["zero_expert_num"], top_k=cfg["moe_topk"],
            routed_scale=float(cfg["routed_scaling_factor"]), rms_eps=float(cfg["rms_norm_eps"]),
            rope_theta=float(cfg["rope_theta"]), n_vocab=cfg["vocab_size"], audio=audio, audio_pool=pool,
            audio_token_id=cfg["audio_token_id"])
        if dims.n_held != cfg["n_routed_experts"]:
            raise ValueError(f"expert_share holds {dims.n_held} experts, n_routed_experts says "
                             f"{cfg['n_routed_experts']}")
        dims.validate()
        return dims

    def validate(self) -> None:
        lo, hi = self.held
        if not 0 <= lo < hi <= self.n_published:
            raise ValueError(f"held experts [{lo}, {hi}) outside the {self.n_published} published")
        if self.top_k > self.n_experts or self.rope_dim % 2:
            raise ValueError(f"top {self.top_k} of {self.n_experts}, rope dims {self.rope_dim}")
        if self.audio.n_audio_ctx % self.audio_pool:
            raise ValueError(f"{self.audio.n_audio_ctx} frames do not pool by {self.audio_pool}")


def tensor_names(dims: LongcatDims) -> dict[str, tuple[int, ...]]:
    """Every tensor of this card's share of the audio-to-text path by its
    checkpoint name, with its shape (torch's [out, in] for a linear
    layer). Routed experts lo..hi - 1 keep their published indices."""
    d, h = dims.d, dims.n_head
    out = audio_tensor_names(dims.audio, d, dims.n_vocab)
    for i in range(dims.n_layer):
        p = f"{LM}.layers.{i}"
        for j in range(2):
            a = f"{p}.self_attn.{j}"
            out.update({f"{p}.input_layernorm.{j}.weight": (d,), f"{p}.post_attention_layernorm.{j}.weight": (d,),
                        f"{a}.q_a_proj.weight": (dims.q_rank, d), f"{a}.q_a_layernorm.weight": (dims.q_rank,),
                        f"{a}.q_b_proj.weight": (h * dims.qk_dim, dims.q_rank),
                        f"{a}.kv_a_proj_with_mqa.weight": (dims.latent_dim, d),
                        f"{a}.kv_a_layernorm.weight": (dims.kv_rank,),
                        f"{a}.kv_b_proj.weight": (h * (dims.nope_dim + dims.v_dim), dims.kv_rank),
                        f"{a}.o_proj.weight": (d, h * dims.v_dim)})
            m = f"{p}.mlps.{j}"
            out.update({f"{m}.gate_proj.weight": (dims.ffn, d), f"{m}.up_proj.weight": (dims.ffn, d),
                        f"{m}.down_proj.weight": (d, dims.ffn)})
        out.update({f"{p}.mlp.router.classifier.weight": (dims.n_experts, d),
                    f"{p}.mlp.router.e_score_correction_bias": (dims.n_experts,)})
        w = dims.expert_width
        for e in range(*dims.held):
            q = f"{p}.mlp.experts.{e}"
            out.update({f"{q}.gate_proj.weight": (w, d), f"{q}.up_proj.weight": (w, d),
                        f"{q}.down_proj.weight": (d, w)})
    return out


class LongcatBlock(nn.Module):
    """One double layer's tensors. Per sublayer j (0, 1): ``ln_in_j``,
    ``ln_post_j``, ``q_norm_j``, ``kv_norm_j`` (f32); [in, out] views
    ``q_a_j`` [d, q_rank], ``q_b_j`` [q_rank, H * 192], ``kv_a_j`` [d,
    576], ``kv_b_j`` [kv_rank, H * 256] (per head: k_nope, then v),
    ``o_j`` [H * v_dim, d], the dense FFN ``gate_up_j`` [d, 2 ffn] (gate
    columns first) and ``down_j`` [ffn, d]; and the per-head halves of
    kv_b's [out, in] storage, ``w_k_j`` and ``w_v_j`` [H, 128, kv_rank].
    The expert layer: ``router_w`` [d, n_experts] and ``router_bias``
    [n_experts] (f32), held expert k's ``gate_up_e<k>`` [d, 2w] and
    ``down_e<k>`` [w, d] (``kernels/moe.py``'s layout)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key, t)


class LongcatParams(nn.Module):
    """``enc``: the Whisper encoder in the port's layout; ``proj_w`` /
    ``proj_b``: the connector; ``embed`` [V, d], ``head_w`` [d, V]
    (untied), ``norm_w`` and the double layers ``blocks``. ``tp``:
    unsharded."""

    tp: AxisGroup = SINGLE

    def __init__(self, enc, tensors: dict[str, torch.Tensor], blocks: list[LongcatBlock]):
        super().__init__()
        self.enc = enc
        for key, t in tensors.items():
            self.register_buffer(key, t)
        self.blocks = nn.ModuleList(blocks)


def _block(dims: LongcatDims, tensors: dict, i: int, policy: DtypePolicy) -> LongcatBlock:
    d, h = dims.d, dims.n_head
    dt, nt = policy.param_dtype, policy.norm_dtype
    p = f"{LM}.layers.{i}"

    def get(name, shape, dtype=dt):
        return pop_tensor(tensors, f"{p}.{name}", shape).to(dtype)

    out = {}
    for j in range(2):
        a = f"self_attn.{j}"
        kv_b = get(f"{a}.kv_b_proj.weight", (h * (dims.nope_dim + dims.v_dim), dims.kv_rank))
        heads = kv_b.view(h, dims.nope_dim + dims.v_dim, dims.kv_rank)
        m = f"mlps.{j}"
        out.update({
            f"ln_in_{j}": get(f"input_layernorm.{j}.weight", (d,), nt),
            f"ln_post_{j}": get(f"post_attention_layernorm.{j}.weight", (d,), nt),
            f"q_a_{j}": get(f"{a}.q_a_proj.weight", (dims.q_rank, d)).T,
            f"q_norm_{j}": get(f"{a}.q_a_layernorm.weight", (dims.q_rank,), nt),
            f"q_b_{j}": get(f"{a}.q_b_proj.weight", (h * dims.qk_dim, dims.q_rank)).T,
            f"kv_a_{j}": get(f"{a}.kv_a_proj_with_mqa.weight", (dims.latent_dim, d)).T,
            f"kv_norm_{j}": get(f"{a}.kv_a_layernorm.weight", (dims.kv_rank,), nt),
            f"kv_b_{j}": kv_b.T, f"w_k_{j}": heads[:, : dims.nope_dim], f"w_v_{j}": heads[:, dims.nope_dim:],
            f"o_{j}": get(f"{a}.o_proj.weight", (d, h * dims.v_dim)).T,
            f"gate_up_{j}": torch.cat([get(f"{m}.gate_proj.weight", (dims.ffn, d)),
                                       get(f"{m}.up_proj.weight", (dims.ffn, d))]).T,
            f"down_{j}": get(f"{m}.down_proj.weight", (d, dims.ffn)).T,
        })
    out["router_w"] = get("mlp.router.classifier.weight", (dims.n_experts, d), torch.float32).T
    out["router_bias"] = get("mlp.router.e_score_correction_bias", (dims.n_experts,), torch.float32)
    w = dims.expert_width
    for k, e in enumerate(range(*dims.held)):
        q = f"mlp.experts.{e}"
        out[f"gate_up_e{k}"] = torch.cat([get(f"{q}.gate_proj.weight", (w, d)),
                                          get(f"{q}.up_proj.weight", (w, d))]).T
        out[f"down_e{k}"] = get(f"{q}.down_proj.weight", (d, w)).T
    return LongcatBlock(out)


def params_from_tensors(dims: LongcatDims, tensors: dict[str, torch.Tensor],
                        policy: DtypePolicy = DtypePolicy()) -> LongcatParams:
    """The parameter modules from ``tensors`` by checkpoint name, on their
    device. Each tensor is popped from ``tensors`` as it is converted (the
    dict is left empty): matmul weights take the policy's param dtype,
    norms, the router and its bias f32. Raises on a missing, misshapen or
    unexpected tensor."""
    d = dims.d
    enc = encoder_from_tensors(dims, tensors, policy)
    dt, nt = policy.param_dtype, policy.norm_dtype
    top = {"proj_w": pop_tensor(tensors, f"{PROJECTOR}.weight", (d, dims.audio.n_audio_state)).to(dt).T,
           "proj_b": pop_tensor(tensors, f"{PROJECTOR}.bias", (d,)).to(nt),
           "embed": pop_tensor(tensors, f"{LM}.embed_tokens.weight", (dims.n_vocab, d)).to(dt),
           "norm_w": pop_tensor(tensors, f"{LM}.norm.weight", (d,)).to(nt),
           "head_w": pop_tensor(tensors, "lm_head.weight", (dims.n_vocab, d)).to(dt).T}
    blocks = [_block(dims, tensors, i, policy) for i in range(dims.n_layer)]
    if tensors:
        raise ValueError(f"unexpected tensors: {sorted(tensors)[:5]}")
    return LongcatParams(enc, top, blocks)
