"""The longcat expert layer's load on this card's share: choices of a held
expert per token and layer, from the program's counters ``moe.held_slots``
(choices of one of the experts this card holds, prompt positions and
steps) over ``moe.tokens`` (the token-layer pairs routed), both from
whisper_tpu_torch.obs.profiler.TRACER, always on, over every window of the
run after the set-up's rounds that balance the router's bias (the family
leaves the counters as those rounds left them in ``run.counters_base``).
Routing that spreads each token's top_k choices evenly over the
router's outputs reads top_k x held / outputs (12 x 8 / 768 = 0.125 at
LongCat-Flash's share). None where the program has no such counters."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    base = getattr(run, "counters_base", {})
    if "moe.tokens" not in TRACER.counters or "moe.held_slots" not in TRACER.counters:
        return None
    tokens = TRACER.counters["moe.tokens"] - base.get("moe.tokens", 0)
    held = TRACER.counters["moe.held_slots"] - base.get("moe.held_slots", 0)
    return held / tokens if tokens else None
