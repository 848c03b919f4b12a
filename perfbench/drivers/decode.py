"""Closed-loop greedy decode through the port's split serving path.

Set-up builds the program as the port's planner serves it on the
configuration's mesh (``launch.specs.plan_cell`` for a decode cell of the
traffic's batch and cache length, then ``distribute``: the planner's
axes, FSDP and tensor-parallel choices and serving dtype), loads the
benchmark's weights into each rank's blocks, packs the routers, and
prefills the traffic's ``batch`` prompts into one cache of
``prompt_tokens + turn_tokens`` positions, ``prefill_rows`` global rows a
call (each call's cache rows copied into the rank's cache).  Every step of
the window is one ``decode_step`` of the whole batch, then
``gathered_logits``, each row's greedy token over the real vocabulary, and
the batch shards' tokens all-gathered over the mesh dims that carry the
batch (as the port's served flow agrees them), fed back as the next
step's input; an event is waited on at the end of each step.  After
``turn_tokens`` steps the cache's position rewinds to the prompt's end and
the same sessions begin a new turn from the prefill's token (a fresh cache
gives the same result).

Kept for the check, with no host read in the window: every step's tokens,
each layer's routes of the rank's rows (a forward hook on each layer's
``TreeRouter``, copied into a buffer), and for ``kept_rows`` seeded rows
spread over the batch shards their routes at the prompt's positions in
set-up and their logits at the window's first step and one seeded step in
``check_every``.  Each rank also times its steps: the host's seconds up to
the step's last launch, and the wait for the card after it.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from perfbench import model_cell


def program_config(cfg: dict):
    """The port's registry config with every size of the configuration file."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig

    fields = {k: cfg[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                                  "rope_theta", "norm_eps", "dtype", "param_dtype")}
    return dataclasses.replace(get_config(cfg["registry"]), moe=MoEConfig(**cfg["moe"]), **fields)


PARAMS = {"ln1": "ln1.scale", "ln2": "ln2.scale", "wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv",
          "wo": "attn.wo", "wi": "moe.wi", "wg": "moe.wg", "wo_e": "moe.wo",
          "router_proj": "moe.router_proj", "router_thr": "moe.router_thr"}
TOP = {"embed": "embed.table", "lm_head": "lm_head.w", "final_norm": "final_norm.scale"}


def kept_rows(ctx, n_shards: int, local: int) -> list[list[int]]:
    """Each batch shard's kept rows (its own indices, ascending): the
    traffic's ``kept_rows`` split evenly over the shards, drawn from the seed."""
    per = max(1, min(local, int(ctx.cell.traffic["kept_rows"]) // n_shards))
    rng = ctx.rng(2)
    return [sorted(int(r) for r in rng.choice(local, per, replace=False)) for _ in range(n_shards)]


class Driver:
    def __init__(self, ctx):
        import torch.distributed as dist

        from repro_torch.configs import ShapeConfig
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.specs import plan_cell, serving_config
        from repro_torch.models import build_model
        from repro_torch.parallel import sharding as shd

        self.ctx, self.dist, self.shd = ctx, dist, shd
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        self.cfg, self.vocab = cfg, cfg["vocab_size"]
        self.batch, self.s0 = int(tr["batch"]), int(tr["prompt_tokens"])
        self.max_len = self.s0 + int(tr["turn_tokens"])
        self.group = None
        if ctx.ranks is None:                          # one card: the model whole, in this process
            self.mesh, self.n_shards, self.shard, self.lead, self.model_index = None, 1, 0, True, 0
            self.model = build_model(serving_config(program_config(cfg)), device=ctx.device)
        else:
            cache = ctx.ranks.cache
            if "mesh" not in cache:
                cache["mesh"] = make_test_mesh(cfg["mesh"]["data"], cfg["mesh"]["model"])
            self.mesh = mesh = cache["mesh"]
            shape = ShapeConfig(ctx.cell.name, self.max_len, self.batch, "decode")
            self.model = plan_cell(program_config(cfg), shape, shd.from_mesh(mesh)).model.distribute(mesh)
            self._shards(mesh)
        ctx.batch_shards = self.n_shards
        self.local = self.batch // self.n_shards
        self._load_weights()
        self.model.pack_routers()
        self.kept = kept_rows(ctx, self.n_shards, self.local)[self.shard]
        self.kept_index = torch.tensor(self.kept, device=ctx.device)
        self.check_every = int(tr["check_every"])
        self.keep_rng = ctx.rng(3)
        self.max_steps = int(tr["max_kept_steps"])
        dev = ctx.device
        self.prompt = model_cell.prompt_tokens(cfg, tr, ctx.seed, dev)
        self.tokens = torch.zeros((self.max_steps, self.batch), dtype=torch.int32, device=dev)
        self.routes = torch.zeros((self.max_steps, cfg["n_layers"], self.local), dtype=torch.int32, device=dev)
        self.positions, self.kept_logits = [], []
        self.prompt_routes = {}
        self.first_logits = {}
        self.steps = self.missing = self.turns = 0
        self.issue_s = self.wait_s = 0.0
        self.mode, self.chunk = None, None
        self.event = torch.cuda.Event() if dev.type == "cuda" else None
        self.hooks = [r.register_forward_hook(self._hook(i)) for i, r in enumerate(self.model.tree_routers())]

    def _shards(self, mesh) -> None:
        """This rank's batch shard as the planned model splits the decode
        batch, and the group its tokens are agreed over."""
        shd = self.shd
        dims = shd.batch_dims(mesh, self.model.axes, self.batch)
        shards = shd.BatchShards(mesh, dims)
        self.n_shards, self.shard = shards.count, shards.index
        coord = mesh.get_coordinate()
        others = [d for d in range(mesh.ndim) if d not in dims]
        self.lead = all(coord[d] == 0 for d in others)            # the shard's first rank
        names = list(mesh.mesh_dim_names)
        model_dim = names.index("model") if "model" in names else None
        self.model_index = coord[model_dim] if model_dim in others else 0
        if len(dims) == 1:
            self.group = mesh.get_group(dims[0])
        elif len(dims) == mesh.ndim and len(dims) > 1:          # every rank its own shard, in rank order
            if shards.index != self.dist.get_rank():
                raise ValueError(f"batch shard {shards.index} on rank {self.dist.get_rank()}")
            self.group = self.dist.group.WORLD
        elif dims:
            raise ValueError(f"the decode batch splits over mesh dims {dims}; the driver agrees over one or all")

    # ------------------------------ weights ------------------------------

    def _place(self, params: dict, name: str, full: torch.Tensor) -> None:
        p = params[name]
        local = p.data if self.mesh is None else p.to_local()
        if full.shape != p.shape:                     # padded vocabulary: zeros past the real ids
            pad = torch.zeros(p.shape, dtype=full.dtype, device=full.device)
            pad[tuple(slice(0, n) for n in full.shape)] = full
            full = pad
        full = full.to(local.dtype)
        local.copy_(full if self.mesh is None else self.shd.local_shard(full, self.mesh, p.placements))

    @torch.no_grad()
    def _load_weights(self) -> None:
        w = self.ctx.weights
        params = dict(self.model.named_parameters()) if self.mesh is None else self.model.placed
        for i in range(self.cfg["n_layers"]):
            for key, t in w.layer(i).items():
                self._place(params, f"layers.{i}.{PARAMS[key]}", t)
        for key, t in w.top().items():
            self._place(params, TOP[key], t)

    # ------------------------------ the flow ------------------------------

    def _hook(self, layer: int):
        def hook(module, args, out):
            if self.mode == "decode":
                if self.steps < self.max_steps:
                    self.routes[self.steps, layer].copy_(out.reshape(-1))
            elif self.mode == "prefill":
                lo, hi = self.chunk
                rows = out.reshape(hi - lo, -1)
                for r in self.kept:
                    if lo <= r < hi:
                        self.prompt_routes.setdefault((layer, r), rows[r - lo].clone())
        return hook

    def _greedy(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows' greedy tokens (rows, 1) over the real vocabulary."""
        return full[:, -1, :self.vocab].argmax(-1, keepdim=True).to(torch.int32)

    def _agreed(self, local: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The batch's tokens (B, 1), all-gathered over the batch shards, and
        how many rows answered: a short answer is counted missing and padded
        with id 0 so that the sessions go on."""
        out = local.contiguous()
        if self.group is not None:
            out = torch.empty((out.shape[0] * self.dist.get_world_size(self.group), 1), dtype=torch.int32,
                              device=out.device)
            self.dist.all_gather_into_tensor(out, local.contiguous(), group=self.group)
        answered = int(out.shape[0])
        if answered != self.batch:
            self.missing += 1
            out = torch.cat([out.reshape(-1)[:self.batch],
                             torch.zeros(max(0, self.batch - answered), dtype=torch.int32,
                                         device=out.device)]).reshape(self.batch, 1)
        return out, min(answered, self.batch)

    def _decode(self, inp: torch.Tensor, pos: int):
        batch = {"tokens": inp}
        logits, _ = self.model.decode_step(self.cache._replace(pos=pos), batch)
        full = self.model.gathered_logits(logits, batch)
        return full, *self._agreed(self._greedy(full))

    def _wait(self) -> None:
        if self.event is not None:
            self.event.record()
            self.event.synchronize()

    @torch.no_grad()
    def warm(self) -> None:
        """Prefill every prompt (set-up the traffic needs), then
        ``warm_steps`` of the window's steps, their bookkeeping too, so that
        no kernel is first loaded in the window; the window starts afresh at
        the prompt's end."""
        tr = self.ctx.cell.traffic
        rows_call = int(tr["prefill_rows"]) // self.n_shards
        self.cache = self.model.init_cache(self.local, self.max_len)
        firsts = []
        self.mode = "prefill"
        for lo in range(0, self.local, rows_call):
            hi = lo + rows_call
            rows = torch.cat([torch.arange(d * self.local + lo, d * self.local + hi)
                              for d in range(self.n_shards)])
            batch = {"tokens": self.prompt[rows.to(self.prompt.device)]}
            self.chunk = (lo, hi)
            logits, part = self.model.prefill(batch, max_len=self.max_len)
            self.cache.kv.k[:, lo:hi].copy_(part.kv.k)
            self.cache.kv.v[:, lo:hi].copy_(part.kv.v)
            full = self.model.gathered_logits(logits, batch)
            firsts.append(self._greedy(full))
            for r in self.kept:
                if lo <= r < hi and r - lo < full.shape[0]:
                    self.first_logits[r] = full[r - lo, -1, :self.vocab].float().clone()
            del logits, part, full
        self.mode = None
        self.first, _ = self._agreed(torch.cat(firsts))
        self.pos, self.inp = self.s0, self.first
        for _ in range(int(tr["warm_steps"])):         # the window's own step, what it kept dropped
            self.step()
        self.pos, self.inp = self.s0, self.first
        self.steps = self.turns = 0
        self.issue_s = self.wait_s = 0.0
        self.positions, self.kept_logits = [], []
        self.keep_rng = self.ctx.rng(3)

    @torch.no_grad()
    def step(self) -> list[tuple[int, int]]:
        t0 = time.perf_counter()
        if self.pos == self.max_len:                   # a new turn of the same sessions
            self.pos, self.inp = self.s0, self.first
            self.turns += 1
        i, pos = self.steps, self.pos
        self.mode = "decode"
        full, nxt, answered = self._decode(self.inp, pos)
        self.mode = None
        if i < self.max_steps:
            self.tokens[i].copy_(nxt.reshape(-1))
            self.positions.append(pos)
            if i == 0 or self.keep_rng.integers(0, self.check_every) == 0:
                if self.kept[-1] < full.shape[0]:
                    self.kept_logits.append((i, full[self.kept_index, -1, :self.vocab].float().clone()))
        t1 = time.perf_counter()
        self._wait()
        self.issue_s += t1 - t0
        self.wait_s += time.perf_counter() - t1
        self.inp = nxt
        self.pos += 1
        self.steps += 1
        return [(pos, answered)]

    def finish(self) -> tuple[dict, int]:
        n = min(self.steps, self.max_steps)
        layers = self.cfg["n_layers"]
        prompt_routes = torch.zeros((layers, len(self.kept), 0), dtype=torch.long)
        if self.prompt_routes:
            prompt_routes = torch.stack([torch.stack([self.prompt_routes[(i, r)] for r in self.kept])
                                         for i in range(layers)]).long()
        width = prompt_routes.shape[2]
        first = [self.first_logits.get(r) for r in self.kept]
        kept = {
            "shard": self.shard, "lead": self.lead,
            "rows": [self.shard * self.local + r for r in self.kept],
            "positions": list(self.positions),
            "tokens": self.tokens[:n].cpu() if self.ctx.rank == 0 else None,
            "first": self.first.reshape(-1).cpu(),
            "first_logits": None if any(f is None for f in first) else torch.stack(first).cpu(),
            "decode_routes": self.routes[:n][:, :, self.kept_index].cpu(),
            "prompt_routes": prompt_routes.cpu(),
            "prompt_at": self.model_index * width if 0 < width < self.s0 else 0,
            "kept_logits": [(i, t.cpu()) for i, t in self.kept_logits],
            "short": self.missing,
            "step_s": (self.issue_s, self.wait_s, self.steps),
        }
        return kept, self.missing

    def counters(self) -> dict:
        return {"steps_kept": min(self.steps, self.max_steps), "steps_unkept": max(0, self.steps - self.max_steps),
                "short_answers": self.missing, "turns": self.turns + (self.steps > 0)}

    def close(self) -> None:
        for h in self.hooks:
            h.remove()
        self.model = self.cache = self.routes = self.tokens = None
        self.kept_logits = []
        gc.collect()                                   # the blocks' gather hooks hold cycles
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
