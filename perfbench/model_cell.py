"""The model kind of cell: a decoder served on a mesh of cards, its inputs
made from ``--seed``, its served tokens held against the plain reference.

A configuration file with ``"kind": "model"`` names its reference module
(``reference/<reference>.py``: the weights maker ``Weights`` and the plain
``forward``), the mesh, and the check's limits.  The benchmark makes the
weights and the prompts; the driver loads the weights into the program
and keeps, for the traffic's ``kept_rows`` seeded rows (spread evenly
over the batch shards), every served token, the program's route at every
layer and position, and the logits at the window's first step and one
seeded step in ``check_every``.  After the window every rank hands what
it kept to rank 0, which frees the program and runs the reference over
the kept rows' whole sequences, one batch of them a turn (a prompt and
the tokens decoded after it):

- ``logit_err``: the largest distance of a kept logit from the
  reference's, over the reference's largest magnitude at that position;
- ``token_gap``: the widest gap by which a served token's logit lies
  below the reference's best, over the reference's largest magnitude at
  that position;
- ``wrong_routes``: routes that differ from the reference's descent where
  its router input lies outside the stated band of the node where the two
  paths part (inside it, a near-tie: the reference follows the program);
- ``answers_missing``: steps whose next tokens were not one a row;
- ``tokens_checked``: served tokens compared.

The control (``control=True``) puts the reference itself, its residual
stream rounded to float8 e4m3 between layers, in the program's place over
the same sequences: its first-choice tokens, logits and routes are judged
alike and its check is the one reported.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from perfbench.cost import call_bound_s
from perfbench.cost_decode import decode_step_bound_s, router_depth


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def prompt_tokens(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """(B, S) int32 prompt ids drawn from the seed over the whole vocabulary."""
    ref = reference(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(ref.stream_seed(seed, 1 << 20))
    return torch.randint(0, cfg["vocab_size"], (traffic["batch"], traffic["prompt_tokens"]),
                         generator=g, device=device, dtype=torch.int64).to(torch.int32)


@dataclasses.dataclass
class Context:
    """What a model driver gets: the cell, the seed, the device, the ranks
    and the weights maker."""

    cell: object
    seed: int
    device: torch.device
    control: bool
    ranks: object = None          # perfbench.ranks.Ranks, or None on one card
    batch_shards: int = 1         # the shards the program splits the batch into (the driver's)

    def __post_init__(self):
        self.weights = reference(self.cell.config).Weights(self.cell.config, self.seed, self.device)
        mesh = self.cell.config["mesh"]
        self.chips = int(mesh["data"]) * int(mesh["model"])
        self.agree = self.ranks.agree if self.ranks is not None else None

    @property
    def rank(self) -> int:
        return self.ranks.rank if self.ranks is not None else 0

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed % 2**64, stream])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frames_of(self, records: int) -> float:
        return 0.0

    def call_bounds(self, pos: int, tokens: int) -> tuple[float, float]:
        """(the decode step's bound on the mesh, this rank's router launches'
        bound): one K1 call a layer over the rank's batch shard, each token
        its ``I`` projected features, the tree's tables and its expert id."""
        cfg = self.cell.config
        depth = router_depth(cfg)
        local = tokens // self.batch_shards
        k1 = cfg["n_layers"] * call_bound_s(local, (1 << depth) - 1, 1, (2 << depth) - 1, local * depth)
        return decode_step_bound_s(cfg, tokens, pos, self.chips), k1

    def judge(self, kept: dict, missing: int, device_info: dict):
        """Gather every rank's kept data and device readings on rank 0 and
        judge them there.  Returns (check, failed, device_info, info) on
        rank 0, None elsewhere."""
        parts = self.ranks.gather((kept, device_info)) if self.ranks is not None else [(kept, device_info)]
        if parts is None:
            return None
        kept_all = [p[0] for p in parts]
        dev = combine_devices([p[1] for p in parts])
        check, failed, info = judge(self, kept_all)
        return check, failed, dev, info


def combine_devices(infos: list[dict]) -> dict:
    """The fullest card's peak; trace seconds averaged over the cards."""
    out = {"peak": max(i["peak"] for i in infos)}
    for key in ("busy_s", "kernel_s", "collective_s", "launches"):
        if key in infos[0]:
            out[key] = sum(i[key] for i in infos) / len(infos)
    return out


def sequences(ctx: Context, kept_all: list[dict]) -> list[dict]:
    """One entry a turn, the kept rows of every batch shard batched: their
    token ids (R, S) (prompt, then the served tokens fed back), the
    program's routes (L, R, S), the served token at each position from the
    prompt's last on (-1 before), and the kept logits by position (R, V)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    s0 = tr["prompt_tokens"]
    prompt = prompt_tokens(cfg, tr, ctx.seed, ctx.device).cpu().long()
    lead = kept_all[0]
    tokens, positions, first = lead["tokens"].long(), lead["positions"], lead["first"].long()
    turns, turn = [], []
    for i, p in enumerate(positions):
        if p == s0 and turn:
            turns.append(turn)
            turn = []
        turn.append(i)
    if turn:
        turns.append(turn)
    shards = [next(k for k in kept_all if k["shard"] == s and k["lead"])
              for s in sorted({k["shard"] for k in kept_all})]
    rows = torch.tensor([r for own in shards for r in own["rows"]], dtype=torch.long)
    p_routes = []
    for own in shards:
        width = own["prompt_routes"].shape[2]
        part = torch.zeros((cfg["n_layers"], len(own["rows"]), s0), dtype=torch.long)
        for k in kept_all:
            if k["shard"] == own["shard"]:
                part[:, :, k["prompt_at"]:k["prompt_at"] + width] = k["prompt_routes"].long()
        p_routes.append(part)
    p_routes = torch.cat(p_routes, dim=1)                              # (L, R, s0)
    logits = {}                                                        # step → (R, V)
    for i, _ in shards[0]["kept_logits"]:
        logits[i] = torch.cat([dict(own["kept_logits"])[i] for own in shards])
    firsts = [own["first_logits"] for own in shards]
    out = []
    for t, steps in enumerate(turns):
        outs = tokens[steps][:, rows].T                                # (R, n)
        ids = torch.cat([prompt[rows], first[rows, None], outs[:, :-1]], dim=1)
        served = torch.full(ids.shape, -1, dtype=torch.long)
        served[:, s0 - 1] = first[rows]
        served[:, s0:] = outs
        dec = torch.cat([own["decode_routes"][steps] for own in shards], dim=2)   # (n, L, R)
        routes = torch.cat([p_routes, dec.permute(1, 2, 0).long()], dim=2)
        kl = {positions[i]: logits[i] for i in steps if i in logits}
        if t == 0 and all(f is not None for f in firsts):
            kl[s0 - 1] = torch.cat(firsts)
        out.append({"turn": t, "rows": rows.tolist(), "ids": ids, "routes": routes, "served": served,
                    "logits": kl})
    return out


def readings(ctx: Context, seqs: list[dict], ref_out: list[dict]) -> dict:
    """The compared numbers of ``seqs`` against the reference's outputs."""
    gap = err = 0.0
    checked = wrong = ties = 0
    splits = []
    vocab = ctx.cell.config["vocab_size"]
    for seq, ref in zip(seqs, ref_out):
        logits = ref["logits"]                                         # (R, S, V)
        scale = logits.abs().amax(-1)                                  # (R, S)
        served = seq["served"].to(logits.device)
        at = served >= 0
        bad = served >= vocab
        best = logits.amax(-1)
        got = logits.gather(-1, served.clamp(0, vocab - 1)[..., None])[..., 0]
        g = torch.where(bad, torch.full_like(best, math.inf), (best - got) / scale)
        if bool(at.any()):
            gap = max(gap, float(g[at].max()))
        checked += int(at.sum())
        for p, lg in seq["logits"].items():
            lg = lg.to(logits.device).float()[:, :vocab]
            err = max(err, float(((lg - logits[:, p]).abs().amax(-1) / scale[:, p]).max()))
        wrong += ref["wrong_routes"]
        ties += ref["near_ties"]
        splits.append(ref["splits"])
    splits = torch.cat(splits)
    return {"logit_err": err, "token_gap": gap, "wrong_routes": wrong, "tokens_checked": checked,
            "near_ties": ties, "widest_split": float(splits.max()) if splits.numel() else 0.0,
            "splits_past": {str(b): int((splits > b).sum()) for b in SPLIT_BANDS}}


# band readings at which differing routes are counted, for the record
SPLIT_BANDS = (0.02, 0.05, 0.1, 0.2, 0.4)


def run_reference(ctx: Context, seqs: list[dict], *, follow: str = "routes", act_round=None) -> list[dict]:
    """The reference over each turn's rows at once (its weights made once a
    layer a turn)."""
    ref = reference(ctx.cell.config)
    band = float(ctx.cell.config["check"]["route_band"])
    return [ref.forward(ctx.weights, seq["ids"].to(ctx.device), routes=seq[follow] if follow else None,
                        band=band, act_round=act_round) for seq in seqs]


def control_sequences(ctx: Context, seqs: list[dict]) -> list[dict]:
    """The float8 control in the program's place over the same sequences: its
    first-choice token at each served position, its routes, and its logits
    where the program's were kept."""
    ref = reference(ctx.cell.config)
    out = []
    for seq, c in zip(seqs, run_reference(ctx, seqs, follow=None, act_round=ref.fp8_round)):
        logits = c["logits"][..., :ctx.cell.config["vocab_size"]]
        served = torch.where(seq["served"] >= 0, logits.argmax(-1).cpu(), seq["served"])
        out.append({**seq, "served": served, "routes": c["routes"].cpu(),
                    "logits": {p: logits[:, p].cpu() for p in seq["logits"]}})
    return out


def compared(r: dict, missing: int, limits: dict) -> dict:
    return {
        "logit_err": {"value": r["logit_err"], "limit": limits["logit_err"]},
        "token_gap": {"value": r["token_gap"], "limit": limits["token_gap"]},
        "wrong_routes": {"value": r["wrong_routes"], "limit": 0},
        "answers_missing": {"value": missing, "limit": 0},
        "tokens_checked": {"value": r["tokens_checked"], "min": 1},
    }


def judge(ctx: Context, kept_all: list[dict]) -> tuple[dict, int, dict]:
    """(check, failed answers, info) on rank 0: the program's check, or with
    ``ctx.control`` the control's (the program's then in ``info``)."""
    limits = ctx.cell.config["check"]
    seqs = sequences(ctx, kept_all)
    missing = kept_all[0]["short"]            # every rank counts the batch's short answers alike
    r = readings(ctx, seqs, run_reference(ctx, seqs))
    check = compared(r, missing, limits)
    info = {"route_near_ties": r["near_ties"], "widest_route_split": r["widest_split"],
            "route_splits_past": r["splits_past"],
            "sequences": sum(len(q["rows"]) for q in seqs), "rows_checked": len(seqs[0]["rows"]) if seqs else 0,
            "batch_shards": ctx.batch_shards,
            # each rank's host ms a step up to its last launch, and its wait for the card
            "rank_step_ms": [[round(1e3 * a / max(n, 1), 3), round(1e3 * b / max(n, 1), 3)]
                             for a, b, n in (k["step_s"] for k in kept_all)]}
    if ctx.control:
        judged = control_sequences(ctx, seqs)
        c = readings(ctx, judged, run_reference(ctx, judged))
        info.update(program_check=check, control="fp8-e4m3-residual", control_near_ties=c["near_ties"],
                    control_widest_route_split=c["widest_split"], control_route_splits_past=c["splits_past"])
        check = compared(c, 0, limits)
    over = any(v["value"] > v["limit"] for v in check.values() if "limit" in v)
    return check, check["answers_missing"]["value"] + over, info
