"""Plain PyTorch reference of a decoder with a tree-routed MoE, and the
weights the benchmark makes for it from ``--seed``.

Every model configuration of the benchmark names it (phi3.5-moe, its first,
gave the module its name; granite-moe uses it too).  The architecture is
the port's decoder as it serves a tree-routed MoE (each configuration
file's ``assumed`` lists where that departs from the published model):
token embedding; per layer RMSNorm (a scale, no bias), grouped-query
attention with plain RoPE (the head dim's halves rotate together) and a
causal softmax, RMSNorm, and a mixture of SwiGLU experts routed by a hard
tree: ``z = h @ router_proj`` and a serial descent from node 0 of the
perfect tree of depth ``d`` (node ``n`` goes right, to ``2n + 2``, when
``z[n] > router_thr[n]``, else left, to ``2n + 1``); leaf ``l`` picks
expert ``l mod E`` and the ``top_k - 1`` after it (mod E), each with gate
``1/top_k``; then a final RMSNorm and the output projection over the real
vocabulary.

Everything is float32 with TF32 off: no port code, no kernel, no cache;
each sequence is run whole, layer by layer, and each layer's weights are
made again from the seed (:class:`Weights`) and freed after it.  The
program is only read: its routes, where given, are followed at a near-tie
(the reference's router input within ``band`` of the threshold, in units
of the node's spread over the sequence, at the node where the reference's
descent parts from one to a leaf of the program's expert; the least such
reading where several leaves answer that expert) so that the program's
rounding does not send the reference down another expert; a differing
route outside the band is counted and not followed.  ``act_round`` rounds
the residual stream after the embedding and after every layer (the float8
control).
"""

from __future__ import annotations

import contextlib
import hashlib
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one purpose (``stream``) of one ``--seed``."""
    digest = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def tree_depth(cfg: dict) -> int:
    moe = cfg["moe"]
    return moe.get("router_tree_depth") or max(1, math.ceil(math.log2(moe["n_experts"])))


def layer_leaves(cfg: dict) -> tuple[list, list]:
    """(name, shape, std) of one layer's weights, in the weights' dtype and
    in float32: the draw's order."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    moe = cfg["moe"]
    e, f = moe["n_experts"], moe["d_ff"]
    n_int = (1 << tree_depth(cfg)) - 1
    wide = [("wq", (d, h * hd), d ** -0.5), ("wk", (d, kv * hd), d ** -0.5),
            ("wv", (d, kv * hd), d ** -0.5), ("wo", (h * hd, d), (h * hd) ** -0.5),
            ("wi", (e, d, f), d ** -0.5), ("wg", (e, d, f), d ** -0.5), ("wo_e", (e, f, d), f ** -0.5)]
    f32 = [("ln1", (d,), 0.1), ("ln2", (d,), 0.1), ("router_proj", (d, n_int), d ** -0.5),
           ("router_thr", (n_int,), 0.25)]
    return wide, f32


def top_leaves(cfg: dict) -> tuple[list, list]:
    d, v = cfg["d_model"], cfg["vocab_size"]
    return [("embed", (v, d), 1.0), ("lm_head", (d, v), d ** -0.5)], [("final_norm", (d,), 0.1)]


class Weights:
    """The cell's weights, made on ``device`` from ``seed``: for each layer
    (and for the embedding, final norm and head) one standard-normal draw
    in the served dtype and one in float32, from a generator seeded for
    that layer, cut into the leaves of :func:`layer_leaves` and scaled.
    Norm scales are 1 plus their draw.  The same seed gives the same
    tensors on the same kind of device, to the program and to the
    reference alike."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["param_dtype"]]

    def _draw(self, stream: int, wide: list, f32: list) -> dict:
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, stream))
        out = {}
        for leaves, dtype in ((wide, self.dtype), (f32, torch.float32)):
            n = sum(math.prod(shape) for _, shape, _ in leaves)
            flat = torch.empty(n, dtype=dtype, device=self.device).normal_(generator=g)
            at = 0
            for name, shape, std in leaves:
                size = math.prod(shape)
                t = flat[at:at + size].view(shape)
                at += size
                t.mul_(std)
                if name.startswith(("ln", "final_norm")):
                    t.add_(1.0)
                out[name] = t
        return out

    def layer(self, i: int) -> dict:
        return self._draw(1 + i, *layer_leaves(self.cfg))

    def top(self) -> dict:
        return self._draw(0, *top_leaves(self.cfg))


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32: TF32 off for the matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, S, heads, hd) rotated at positions 0..S-1, the halves together."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    n, s, _ = h.shape
    nh, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = rope((h @ w["wq"]).view(n, s, nh, hd), cfg["rope_theta"])
    k = rope((h @ w["wk"]).view(n, s, kv, hd), cfg["rope_theta"])
    v = (h @ w["wv"]).view(n, s, kv, hd)
    k = k.repeat_interleave(nh // kv, dim=2)            # query head j reads KV head j // (nh/kv)
    v = v.repeat_interleave(nh // kv, dim=2)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(n, s, nh, hd, dtype=h.dtype, device=h.device)
    for i in range(n):                                  # one sequence's scores at a time
        scores = torch.einsum("shd,thd->hst", q[i], k[i]) * hd ** -0.5
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        out[i] = torch.einsum("hst,thd->shd", probs, v[i])
    return out.reshape(n, s, nh * hd) @ w["wo"]


def descend(z: torch.Tensor, thr: torch.Tensor, depth: int) -> torch.Tensor:
    """Each token's leaf by serial descent of the perfect tree (long, z's shape
    less its last dim)."""
    node = torch.zeros(z.shape[:-1], dtype=torch.long, device=z.device)
    for _ in range(depth):
        right = (z.gather(-1, node[..., None])[..., 0] > thr[node]).long()
        node = 2 * node + 1 + right
    return node - ((1 << depth) - 1)


def split_node(a: torch.Tensor, b: torch.Tensor, depth: int) -> torch.Tensor:
    """The node at which the descents to leaves ``a`` and ``b`` part, as a
    heap index: the first level, from the root, whose path bits differ."""
    first = torch.full_like(a, depth - 1)
    for k in range(depth - 1, -1, -1):
        differs = (((a ^ b) >> (depth - 1 - k)) & 1) == 1
        first = torch.where(differs, torch.full_like(a, k), first)
    return (1 << first) - 1 + (a >> (depth - first))


def parting_margin(dist: torch.Tensor, leaf: torch.Tensor, expert: torch.Tensor, depth: int,
                   n_experts: int) -> torch.Tensor:
    """The band reading ``dist`` (..., I) at the node where the descent to
    ``leaf`` parts from the nearest descent that answers ``expert``: every
    leaf ``expert + j E`` below ``2**depth`` answers it (one where the tree
    has as many leaves as experts; one or two for 40 experts under 64)."""
    n_leaves = 1 << depth
    best = torch.full(leaf.shape, math.inf, dtype=dist.dtype, device=dist.device)
    for base in range(0, n_leaves, n_experts):
        other = expert + base
        ok = other < n_leaves
        node = split_node(leaf, torch.where(ok, other, expert), depth)
        best = torch.where(ok, torch.minimum(best, dist.gather(-1, node[..., None])[..., 0]), best)
    return best


def experts(h: torch.Tensor, w: dict, e1: torch.Tensor, n_experts: int, top_k: int) -> torch.Tensor:
    """Gate ``1/top_k`` on expert ``e1`` and on the ``top_k - 1`` after it
    (mod E): the SwiGLU FFN of each expert over the tokens routed to it."""
    flat = h.reshape(-1, h.shape[-1])
    first = e1.reshape(-1)
    y = torch.zeros_like(flat)
    for e in range(n_experts):
        rows = ((e - first) % n_experts < top_k).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        x = flat[rows]
        wi, wg, wo = (w[k][e].float() for k in ("wi", "wg", "wo_e"))
        y.index_add_(0, rows, (1.0 / top_k) * ((torch.nn.functional.silu(x @ wg) * (x @ wi)) @ wo))
    return y.view_as(h)


@torch.no_grad()
def forward(weights: Weights, tokens: torch.Tensor, *, routes: torch.Tensor | None = None,
            band: float = 0.0, act_round=None) -> dict:
    """The reference over whole sequences ``tokens`` (n, S).

    ``routes`` (L, n, S): the program's expert at every layer and position,
    followed where it differs at a near-tie.  Returns ``logits`` (n, S, V)
    float32, the ``routes`` the reference took (L, n, S), ``wrong_routes``
    (differing outside the band), ``near_ties`` and ``splits`` (the band
    reading of every differing route, at the node where the paths part)."""
    cfg = weights.cfg
    depth, n_exp, top_k = tree_depth(cfg), cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
    eps = cfg["norm_eps"]
    rnd = act_round or (lambda t: t)
    taken, wrong, ties, splits = [], 0, 0, []
    with exact_f32():
        top = weights.top()
        x = rnd(top["embed"][tokens.long()].float())
        for i in range(cfg["n_layers"]):
            w = {k: v.float() if k not in ("wi", "wg", "wo_e") else v for k, v in weights.layer(i).items()}
            x = x + attention(rmsnorm(x, w["ln1"], eps), w, cfg)
            h = rmsnorm(x, w["ln2"], eps)
            z = h @ w["router_proj"]
            leaf = descend(z, w["router_thr"], depth)
            if routes is not None:
                prog = routes[i].to(leaf.device).long()       # the program's experts
                differs = prog != leaf % n_exp
                if bool(differs.any()):
                    spread = z.std(dim=1, keepdim=True).clamp_min(1e-30)       # (n, 1, I)
                    margin = parting_margin((z - w["router_thr"]).abs() / spread, leaf, prog, depth, n_exp)
                    tie = differs & (margin <= band)
                    wrong += int((differs & ~tie).sum())
                    ties += int(tie.sum())
                    splits.append(margin[differs].cpu())
                    leaf = torch.where(tie, prog, leaf)
            taken.append(leaf % n_exp)
            x = rnd(x + experts(h, w, leaf % n_exp, n_exp, top_k))
            del w, h, z
        logits = rmsnorm(x, top["final_norm"].float(), eps) @ top["lm_head"].float()
    return {"logits": logits, "routes": torch.stack(taken), "wrong_routes": wrong,
            "near_ties": ties, "splits": torch.cat(splits) if splits else torch.zeros(0)}


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: to float8 e4m3 and back."""
    return t.to(torch.float8_e4m3fn).to(t.dtype)
