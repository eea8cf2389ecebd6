"""Uni-MoE-2.0-Omni's audio-to-text path: its sizes and its parameters.

The model (HIT-TMG/Uni-MoE-2.0-Omni, ``model_type`` ``grin_qwen2_vl``) on
the audio-in, text-out path is a Whisper-large encoder, a linear connector
and a Qwen2-shaped decoder-only language model whose MLPs are
dynamic-capacity mixtures of experts (``model/omni.py`` has the equations).
``OmniDims`` reads its sizes from a configuration under the published
``config.json``'s key names. The vision tower and the speech generator are
not on this path and are not held.

``params_from_tensors`` builds the parameter modules from tensors named as
the published checkpoint names them (Qwen2's names for the language model,
Hugging Face Whisper's for the audio tower; ``tensor_names`` lists them).
It pops each tensor from the caller's dict as it converts it and keeps
matmul weights in the checkpoint's [out, in] layout, read through a
transposed view (``dense`` takes ``w.T`` as it is), so nothing is copied
but the fused projections: one layer's q/k/v, each expert's gate and up,
the two shared experts, and the encoder's head-major QKV. At 26.8 billion
parameters the peak while loading is the weights plus one layer's fusions.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.model.params import Block, DtypePolicy, Encoder
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup

LM = "model"
AUDIO = "model.audio_tower"
PROJECTOR = "model.audio_projector"


@dataclasses.dataclass(frozen=True)
class OmniDims:
    """The audio-to-text path's sizes (published ``config.json`` names in
    the comments; the encoder's and the audio token's are assumed)."""

    d: int                    # hidden_size
    n_layer: int              # num_hidden_layers
    n_head: int               # num_attention_heads
    n_kv_head: int            # num_key_value_heads
    n_vocab: int              # vocab_size
    n_routed: int             # mlp_dynamic_expert_num
    n_null: int               # mlp_dynamic_null_expert_num
    n_shared: int             # mlp_fixed_expert_num
    routed_width: int         # dynamic_intermediate_size
    shared_width: int         # shared_intermediate_size
    top_p: float              # mlp_dynamic_top_p
    top_k: int                # mlp_dynamic_top_k
    rms_eps: float            # rms_norm_eps
    rope_theta: float         # rope_theta
    mrope_section: tuple      # rope_scaling.mrope_section: frequency pairs per t/h/w stream
    audio: ModelDims          # the Whisper encoder (whisper_hidden_size and assumed large-v3 sizes)
    audio_pool: int           # encoder frames averaged into one audio token
    audio_token_id: int       # the placeholder id an audio position holds in a prompt

    @property
    def head_dim(self) -> int:
        return self.d // self.n_head

    @property
    def group(self) -> int:
        """Query heads per K/V head."""
        return self.n_head // self.n_kv_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_head * self.head_dim

    @property
    def n_experts(self) -> int:
        """Router outputs: the routed experts, then the null ones."""
        return self.n_routed + self.n_null

    @property
    def audio_tokens(self) -> int:
        """Audio tokens of one 30 s window."""
        return self.audio.n_audio_ctx // self.audio_pool

    @staticmethod
    def from_config(cfg: dict) -> "OmniDims":
        """From a configuration with the published keys, plus the encoder's
        ``whisper_encoder_layers``, ``whisper_encoder_attention_heads``,
        ``whisper_num_mel_bins``, ``whisper_max_source_positions`` and
        ``audio_token_id``, which the published config does not give. The
        connector keeps ``whisper_query_tokens_size`` tokens per
        ``whisper_audio_time`` seconds of the encoder's 50 frames a second."""
        if cfg.get("use_sliding_window"):
            raise ValueError("sliding-window attention is not on this path")
        audio, pool = whisper_tower(cfg)
        dims = OmniDims(
            d=cfg["hidden_size"], n_layer=cfg["num_hidden_layers"], n_head=cfg["num_attention_heads"],
            n_kv_head=cfg["num_key_value_heads"], n_vocab=cfg["vocab_size"],
            n_routed=cfg["mlp_dynamic_expert_num"], n_null=cfg["mlp_dynamic_null_expert_num"],
            n_shared=cfg["mlp_fixed_expert_num"], routed_width=cfg["dynamic_intermediate_size"],
            shared_width=cfg["shared_intermediate_size"], top_p=float(cfg["mlp_dynamic_top_p"]),
            top_k=cfg["mlp_dynamic_top_k"], rms_eps=float(cfg["rms_norm_eps"]),
            rope_theta=float(cfg["rope_theta"]),
            mrope_section=tuple(cfg["rope_scaling"]["mrope_section"]), audio=audio,
            audio_pool=pool, audio_token_id=cfg["audio_token_id"])
        dims.validate()
        return dims

    def validate(self) -> None:
        if self.d % self.n_head or self.n_head % self.n_kv_head:
            raise ValueError(f"{self.n_head} heads over {self.n_kv_head} K/V heads do not divide {self.d}")
        if 2 * sum(self.mrope_section) != self.head_dim:
            raise ValueError(f"mrope_section {self.mrope_section} does not cover head {self.head_dim}")
        if self.audio.n_audio_ctx % self.audio_pool:
            raise ValueError(f"{self.audio.n_audio_ctx} frames do not pool by {self.audio_pool}")


def whisper_tower(cfg: dict) -> tuple[ModelDims, int]:
    """The Whisper encoder's sizes from a configuration's ``whisper_*`` keys
    (``whisper_hidden_size``, ``whisper_encoder_layers``,
    ``whisper_encoder_attention_heads``, ``whisper_num_mel_bins``,
    ``whisper_max_source_positions``), and the encoder frames averaged into
    one audio token: ``whisper_query_tokens_size`` tokens per
    ``whisper_audio_time`` seconds of the encoder's 50 frames a second."""
    frames_per_token = 50 * cfg["whisper_audio_time"] / cfg["whisper_query_tokens_size"]
    if frames_per_token != int(frames_per_token):
        raise ValueError(f"{frames_per_token} encoder frames an audio token: not whole")
    wd, heads = cfg["whisper_hidden_size"], cfg["whisper_encoder_attention_heads"]
    audio = ModelDims(n_vocab=0, n_audio_ctx=cfg["whisper_max_source_positions"], n_audio_state=wd,
                      n_audio_head=heads, n_audio_layer=cfg["whisper_encoder_layers"], n_text_ctx=0,
                      n_text_state=wd, n_text_head=heads, n_text_layer=0, n_mels=cfg["whisper_num_mel_bins"])
    return audio, int(frames_per_token)


def audio_tensor_names(a: ModelDims, d: int, n_vocab: int) -> dict[str, tuple[int, ...]]:
    """The audio tower's, the connector's (Whisper width -> ``d``), the
    embedding's, the final norm's and the head's tensors by checkpoint
    name, with their shapes."""
    wd, f = a.n_audio_state, 4 * a.n_audio_state
    out = {
        f"{AUDIO}.conv1.weight": (wd, a.n_mels, 3), f"{AUDIO}.conv1.bias": (wd,),
        f"{AUDIO}.conv2.weight": (wd, wd, 3), f"{AUDIO}.conv2.bias": (wd,),
        f"{AUDIO}.embed_positions.weight": (a.n_audio_ctx, wd),
        f"{AUDIO}.layer_norm.weight": (wd,), f"{AUDIO}.layer_norm.bias": (wd,),
        f"{PROJECTOR}.weight": (d, wd), f"{PROJECTOR}.bias": (d,),
        f"{LM}.embed_tokens.weight": (n_vocab, d), f"{LM}.norm.weight": (d,),
        "lm_head.weight": (n_vocab, d),
    }
    for i in range(a.n_audio_layer):
        p = f"{AUDIO}.layers.{i}"
        for proj in "qkv":
            out[f"{p}.self_attn.{proj}_proj.weight"] = (wd, wd)
        out.update({f"{p}.self_attn.q_proj.bias": (wd,), f"{p}.self_attn.v_proj.bias": (wd,),
                    f"{p}.self_attn.out_proj.weight": (wd, wd), f"{p}.self_attn.out_proj.bias": (wd,),
                    f"{p}.self_attn_layer_norm.weight": (wd,), f"{p}.self_attn_layer_norm.bias": (wd,),
                    f"{p}.fc1.weight": (f, wd), f"{p}.fc1.bias": (f,),
                    f"{p}.fc2.weight": (wd, f), f"{p}.fc2.bias": (wd,),
                    f"{p}.final_layer_norm.weight": (wd,), f"{p}.final_layer_norm.bias": (wd,)})
    return out


def tensor_names(dims: OmniDims) -> dict[str, tuple[int, ...]]:
    """Every tensor of the audio-to-text path by its checkpoint name, with
    its shape (torch's [out, in] for a linear layer)."""
    d, kv = dims.d, dims.kv_dim
    out = audio_tensor_names(dims.audio, d, dims.n_vocab)
    for i in range(dims.n_layer):
        p = f"{LM}.layers.{i}"
        out.update({f"{p}.input_layernorm.weight": (d,), f"{p}.post_attention_layernorm.weight": (d,),
                    f"{p}.self_attn.q_proj.weight": (d, d), f"{p}.self_attn.q_proj.bias": (d,),
                    f"{p}.self_attn.k_proj.weight": (kv, d), f"{p}.self_attn.k_proj.bias": (kv,),
                    f"{p}.self_attn.v_proj.weight": (kv, d), f"{p}.self_attn.v_proj.bias": (kv,),
                    f"{p}.self_attn.o_proj.weight": (d, d),
                    f"{p}.mlp.gate.weight": (dims.n_experts, d)})
        for kind, n, w in (("experts", dims.n_routed, dims.routed_width),
                           ("shared_experts", dims.n_shared, dims.shared_width)):
            for e in range(n):
                q = f"{p}.mlp.{kind}.{e}"
                out.update({f"{q}.gate_proj.weight": (w, d), f"{q}.up_proj.weight": (w, d),
                            f"{q}.down_proj.weight": (d, w)})
    return out


class OmniBlock(nn.Module):
    """One language-model layer's tensors. Matmul weights are [in, out]
    views (``qkv_w``: q, k and v columns; ``gate_up_<e>``: routed expert
    e's gate then up columns; ``shared_gate_up`` / ``shared_down``: the
    shared experts side by side, which sum as one SwiGLU of their summed
    width); ``router_w`` [d, n_experts] and the norms and biases in f32."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key, t)


class OmniParams(nn.Module):
    """``enc``: the Whisper encoder in the port's layout (``model/encoder.py:
    encode`` reads it as it reads Whisper's); ``proj_w`` / ``proj_b``: the
    connector; ``embed`` [V, d], ``head_w`` [d, V] (untied), ``norm_w``
    and the layers ``blocks``. ``tp``: unsharded."""

    tp: AxisGroup = SINGLE

    def __init__(self, enc: Encoder, tensors: dict[str, torch.Tensor], blocks: list[OmniBlock]):
        super().__init__()
        self.enc = enc
        for key, t in tensors.items():
            self.register_buffer(key, t)
        self.blocks = nn.ModuleList(blocks)


def pop_tensor(tensors: dict, name: str, shape: tuple[int, ...]) -> torch.Tensor:
    if name not in tensors:
        raise ValueError(f"missing tensor {name!r}")
    t = tensors.pop(name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t


def encoder_from_tensors(dims, tensors: dict, policy: DtypePolicy) -> Encoder:
    """The Whisper encoder in the port's layout (``model/params.py``): the
    conv stem as [3, in, out], a head-major fused QKV [d, 3d] with
    (d/h)^-0.25 folded into q and k, [in, out] views of the rest."""
    a = dims.audio
    wd, h, f = a.n_audio_state, a.n_audio_head, 4 * a.n_audio_state
    dt, nt = policy.param_dtype, policy.norm_dtype
    dh = wd // h
    scale = dh ** -0.25

    def get(name, shape, dtype=dt):
        return pop_tensor(tensors, f"{AUDIO}.{name}", shape).to(dtype)

    blocks = []
    for i in range(a.n_audio_layer):
        p = f"layers.{i}"
        q_w = get(f"{p}.self_attn.q_proj.weight", (wd, wd), torch.float32) * scale
        k_w = get(f"{p}.self_attn.k_proj.weight", (wd, wd), torch.float32) * scale
        v_w = get(f"{p}.self_attn.v_proj.weight", (wd, wd), torch.float32)
        qkv_w = torch.stack([q_w, k_w, v_w]).view(3, h, dh, wd).permute(3, 1, 0, 2).reshape(wd, 3 * wd)
        q_b = get(f"{p}.self_attn.q_proj.bias", (wd,), nt) * scale
        v_b = get(f"{p}.self_attn.v_proj.bias", (wd,), nt)
        qkv_b = torch.stack([q_b, torch.zeros_like(q_b), v_b]).view(3, h, dh).permute(1, 0, 2).reshape(3 * wd)
        del q_w, k_w, v_w
        blocks.append(Block({
            "attn_ln_w": get(f"{p}.self_attn_layer_norm.weight", (wd,), nt),
            "attn_ln_b": get(f"{p}.self_attn_layer_norm.bias", (wd,), nt),
            "qkv_w": qkv_w.to(dt), "qkv_b": qkv_b,
            "o_w": get(f"{p}.self_attn.out_proj.weight", (wd, wd)).T,
            "o_b": get(f"{p}.self_attn.out_proj.bias", (wd,), nt),
            "mlp_ln_w": get(f"{p}.final_layer_norm.weight", (wd,), nt),
            "mlp_ln_b": get(f"{p}.final_layer_norm.bias", (wd,), nt),
            "fc1_w": get(f"{p}.fc1.weight", (f, wd)).T, "fc1_b": get(f"{p}.fc1.bias", (f,), nt),
            "fc2_w": get(f"{p}.fc2.weight", (wd, f)).T, "fc2_b": get(f"{p}.fc2.bias", (wd,), nt),
        }))
    return Encoder({
        "conv1_w": get("conv1.weight", (wd, a.n_mels, 3)).permute(2, 1, 0).contiguous(),
        "conv1_b": get("conv1.bias", (wd,), nt),
        "conv2_w": get("conv2.weight", (wd, wd, 3)).permute(2, 1, 0).contiguous(),
        "conv2_b": get("conv2.bias", (wd,), nt),
        "pos": get("embed_positions.weight", (a.n_audio_ctx, wd)),
        "ln_post_w": get("layer_norm.weight", (wd,), nt), "ln_post_b": get("layer_norm.bias", (wd,), nt),
    }, blocks)


def _block(dims: OmniDims, tensors: dict, i: int, policy: DtypePolicy) -> OmniBlock:
    d, kv = dims.d, dims.kv_dim
    dt, nt = policy.param_dtype, policy.norm_dtype
    p = f"{LM}.layers.{i}"

    def get(name, shape, dtype=dt):
        return pop_tensor(tensors, f"{p}.{name}", shape).to(dtype)

    qkv_w = torch.cat([get("self_attn.q_proj.weight", (d, d)), get("self_attn.k_proj.weight", (kv, d)),
                       get("self_attn.v_proj.weight", (kv, d))])
    qkv_b = torch.cat([get(f"self_attn.{x}_proj.bias", (n,), nt) for x, n in (("q", d), ("k", kv), ("v", kv))])
    out = {"in_norm_w": get("input_layernorm.weight", (d,), nt), "qkv_w": qkv_w.T, "qkv_b": qkv_b,
           "o_w": get("self_attn.o_proj.weight", (d, d)).T,
           "post_norm_w": get("post_attention_layernorm.weight", (d,), nt),
           "router_w": get("mlp.gate.weight", (dims.n_experts, d), torch.float32).T}
    w = dims.routed_width
    for e in range(dims.n_routed):
        q = f"mlp.experts.{e}"
        out[f"gate_up_{e}"] = torch.cat([get(f"{q}.gate_proj.weight", (w, d)),
                                         get(f"{q}.up_proj.weight", (w, d))]).T
        out[f"down_{e}"] = get(f"{q}.down_proj.weight", (d, w)).T
    w = dims.shared_width
    q = "mlp.shared_experts"
    gates = [get(f"{q}.{s}.gate_proj.weight", (w, d)) for s in range(dims.n_shared)]
    ups = [get(f"{q}.{s}.up_proj.weight", (w, d)) for s in range(dims.n_shared)]
    out["shared_gate_up"] = torch.cat(gates + ups).T
    del gates, ups
    out["shared_down"] = torch.cat([get(f"{q}.{s}.down_proj.weight", (d, w))
                                    for s in range(dims.n_shared)], dim=1).T
    return OmniBlock(out)


def params_from_tensors(dims: OmniDims, tensors: dict[str, torch.Tensor],
                        policy: DtypePolicy = DtypePolicy()) -> OmniParams:
    """The parameter modules from ``tensors`` by checkpoint name, on their
    device. Each tensor is popped from ``tensors`` as it is converted (the
    dict is left empty): matmul weights take the policy's param dtype,
    norms, biases and the router f32. Raises on a missing, misshapen or
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
    return OmniParams(enc, top, blocks)
