"""The work of one decode step of a decoder with a tree-routed MoE, and the
least time the cards of its mesh take for it.

One rule counts the work whatever implements it, from the configuration's
sizes alone: every weight read once in its served dtype (each layer's
attention and all its experts, as a step of 128 tokens or more, each routed to
``top_k`` neighbouring experts, reaches every expert: phi's 16 two ways,
granite's 40 eight ways; the router's projection and thresholds and the
norm scales in float32; the output projection over the real vocabulary),
the embedding rows of the step's tokens, the KV cache read once at the
positions before the step's and each new K and V written once; and the
multiply-adds of the projections a token uses (its attention, its router,
its ``top_k`` experts, the output head) and of its attention scores and
values.  The bound is the larger of the bytes over the cards' HBM bandwidth
and the operations over their dense bf16 peak (NVIDIA's H100 SXM data
sheet, the 700 W part), summed over ``chips`` cards.  Padding (vocabulary,
capacity slots, a dense dispatch's empty slots) counts as nothing, so a
share of this bound cannot pass 100% unless a time leaves out part of the
work.
"""

from __future__ import annotations

from perfbench.cost import HBM_BW

PEAK_BF16 = 989e12    # dense bf16 operations/s, H100 SXM

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def router_depth(cfg: dict) -> int:
    """The router tree's depth: the configuration's, else the least whose
    leaves cover the experts."""
    moe = cfg["moe"]
    return moe.get("router_tree_depth") or max(1, (moe["n_experts"] - 1).bit_length())


def _sizes(cfg: dict) -> dict:
    d, h, kv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    moe = cfg["moe"]
    return {"d": d, "h": h, "kv": kv, "hd": hd, "e": moe["n_experts"], "k": moe["top_k"],
            "f": moe["d_ff"], "i": (1 << router_depth(cfg)) - 1, "v": cfg["vocab_size"], "l": cfg["n_layers"]}


def decode_step_cost(cfg: dict, tokens: int, pos: int) -> dict[str, float]:
    """Bytes and operations of one decode step of ``tokens`` sequences, each
    at cache position ``pos`` (``pos`` positions already in the cache)."""
    s = _sizes(cfg)
    w = DTYPE_BYTES[cfg["param_dtype"]]
    a = DTYPE_BYTES[cfg["dtype"]]
    d, hd, l = s["d"], s["hd"], s["l"]
    attn = d * (s["h"] + 2 * s["kv"]) * hd + s["h"] * hd * d
    expert = 3 * d * s["f"]
    layer_bytes = (attn + s["e"] * expert) * w + (d * s["i"] + s["i"] + 2 * d) * 4
    kv_token = l * 2 * s["kv"] * hd * a                       # one position's K and V, every layer
    bytes_ = (l * layer_bytes + d * s["v"] * w + d * 4 + tokens * d * w
              + tokens * pos * kv_token + tokens * kv_token)
    macs = tokens * (l * (attn + d * s["i"] + s["k"] * expert + 2 * s["h"] * hd * (pos + 1)) + d * s["v"])
    return {"bytes": float(bytes_), "ops": 2.0 * macs}


def decode_step_bound_s(cfg: dict, tokens: int, pos: int, chips: int) -> float:
    """Least seconds for one decode step on ``chips`` cards."""
    c = decode_step_cost(cfg, tokens, pos)
    return max(c["bytes"] / (chips * HBM_BW), c["ops"] / (chips * PEAK_BF16))
