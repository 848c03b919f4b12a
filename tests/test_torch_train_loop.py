"""The port's training substrates on the CPU: optimizer, checkpoints, the
fault-tolerant loop, the data pipeline, losses and the launcher.

Mirrors ``tests/test_substrates.py`` (``TestAdamW``, ``TestCheckpoint``,
``TestFaultTolerantLoop``, ``TestDataPipeline``, ``TestLosses``) and the two
training tests of ``tests/test_arch_smoke.py`` for every family, plus what
the port adds: checkpoints of a model and its ``AdamWState`` restored in
place, a restart whose replayed losses equal an
uninterrupted run's, and the ``launch.train`` command.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, pipeline_for
from repro_torch.models import build_model
from repro_torch.models.lm import FAMILIES
from repro_torch.optim.adamw import adamw_apply, adamw_init, clip_by_global_norm, global_norm, lr_at
from repro_torch.train import (
    LoopState, SimulatedFailure, StragglerWatchdog, device_batch, make_eval_step, make_train_step, train_loop,
)
from repro_torch.utils.losses import chunked_softmax_xent, softmax_xent

REPO = Path(__file__).resolve().parents[1]
PORTED = [a for a in ARCH_IDS if get_smoke_config(a).family in FAMILIES]
SMOKE_SHAPE = ShapeConfig(name="smoke", seq_len=32, global_batch=2, kind="train")


def _model(cfg: ModelConfig, seed: int = 0):
    model = build_model(cfg, device="cpu")
    return model.init(torch.Generator().manual_seed(seed))


class TestAdamW:
    def _quadratic(self):
        target = torch.tensor([1.0, -2.0, 3.0])

        def loss(p):
            return torch.sum((p["w"] - target) ** 2)

        return loss, {"w": torch.zeros(3, requires_grad=True)}

    def test_converges_on_quadratic(self):
        loss, params = self._quadratic()
        cfg = TrainConfig(lr=0.1, warmup_steps=0, total_steps=300, weight_decay=0.0)
        state = adamw_init(params)
        for _ in range(300):
            (g,) = torch.autograd.grad(loss(params), [params["w"]])
            params, state, _ = adamw_apply(params, {"w": g}, state, cfg)
        assert float(loss(params).detach()) < 1e-3

    def test_grad_clip(self):
        tree = {"a": torch.full((10,), 100.0)}
        clipped, norm = clip_by_global_norm(tree, 1.0)
        assert float(norm) > 100
        assert abs(float(global_norm(clipped)) - 1.0) < 1e-5

    def test_lr_schedule_warmup_and_decay(self):
        cfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        assert float(lr_at(cfg, torch.tensor(0))) == 0.0
        assert abs(float(lr_at(cfg, torch.tensor(10))) - 1e-3) < 1e-9
        assert float(lr_at(cfg, torch.tensor(100))) < 2e-4

    def test_weight_decay_only_on_matrices(self):
        params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,))}
        g = {k: torch.zeros_like(v) for k, v in params.items()}
        cfg = TrainConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
        p2, _, _ = adamw_apply(params, g, adamw_init(params), cfg)
        assert float((p2["w"] - 1.0).abs().max()) > 1e-3       # decayed
        assert float((p2["scale"] - 1.0).abs().max()) < 1e-6   # untouched

    def test_state_stays_on_the_parameters_device_and_updates_in_place(self):
        params = {"w": torch.ones((2, 3))}
        state = adamw_init(params)
        m, count = state.m["w"], state.count
        p2, s2, stats = adamw_apply(params, {"w": torch.ones((2, 3))}, state, TrainConfig(warmup_steps=0))
        assert p2["w"] is params["w"] and s2.m["w"] is m and s2.count is count
        assert count.dtype == torch.int32 and int(count) == 1
        assert stats["lr"].dim() == 0 and stats["grad_norm"].dim() == 0


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 4))}}
        ckpt.save(str(tmp_path), 7, tree)
        assert ckpt.latest_step(str(tmp_path)) == 7
        target = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4))}}
        out, manifest = ckpt.restore(str(tmp_path), 7, target)
        assert manifest["step"] == 7 and out is target
        assert torch.equal(target["a"], tree["a"]) and torch.equal(target["b"]["c"], tree["b"]["c"])
        assert [e["path"] for e in manifest["leaves"]] == ["a", "b/c"]

    def test_atomic_publish_no_partial_dirs(self, tmp_path):
        tree = {"a": torch.ones(5)}
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, tree)
        names = sorted(os.listdir(tmp_path))
        assert "step_000001" in names and "step_000002" in names
        assert not any(n.endswith(".tmp") for n in names)
        assert (tmp_path / "LATEST").read_text() == "step_000002"

    def test_prune_keeps_newest(self, tmp_path):
        tree = {"a": torch.ones(2)}
        for s in range(5):
            ckpt.save(str(tmp_path), s, tree)
        ckpt.prune(str(tmp_path), keep=2)
        steps = [n for n in os.listdir(tmp_path) if n.startswith("step_")]
        assert sorted(steps) == ["step_000003", "step_000004"]

    def test_shape_mismatch_rejected(self, tmp_path):
        ckpt.save(str(tmp_path), 0, {"a": torch.ones((4,))})
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), 0, {"a": torch.ones((5,))})
        with pytest.raises(KeyError):
            ckpt.restore(str(tmp_path), 0, {"b": torch.ones((4,))})

    def test_async_saver(self, tmp_path):
        saver = ckpt.AsyncSaver()
        saver.submit(str(tmp_path), 3, {"a": torch.ones(4)})
        saver.wait()
        assert ckpt.latest_step(str(tmp_path)) == 3

    def test_async_saver_copies_before_the_next_in_place_step(self, tmp_path):
        """The host copy is taken on the caller's thread: an in-place write
        right after ``submit`` does not reach the checkpoint."""
        t = torch.ones(1000)
        saver = ckpt.AsyncSaver()
        saver.submit(str(tmp_path), 1, {"a": t})
        t.add_(1.0)
        saver.wait()
        target = {"a": torch.zeros(1000)}
        ckpt.restore(str(tmp_path), 1, target)
        assert torch.equal(target["a"], torch.ones(1000))

    def test_model_and_optimizer_state_roundtrip_in_place(self, tmp_path):
        cfg = get_smoke_config("granite-moe")
        model = _model(cfg, seed=1)
        opt = adamw_init(model)
        step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10))
        model, opt, _ = step(model, opt, device_batch(pipeline_for(cfg, SMOKE_SHAPE)(0), "cpu"))
        ckpt.save(str(tmp_path), 1, {"params": model, "opt": opt})
        manifest = json.loads((tmp_path / "step_000001" / "manifest.json").read_text())
        paths = [e["path"] for e in manifest["leaves"]]
        assert "params/embed.table" in paths and "opt/m/layers.1.moe.router_thr" in paths and "opt/count" in paths
        other = _model(cfg, seed=2)
        other_opt = adamw_init(other)
        assert other.tree_routers()[0].packed is not None
        ckpt.restore(str(tmp_path), 1, {"params": other, "opt": other_opt})
        for (n, a), b in zip(model.named_parameters(), other.parameters()):
            assert torch.equal(a, b), n
        for n in opt.m:
            assert torch.equal(opt.m[n], other_opt.m[n]) and torch.equal(opt.v[n], other_opt.v[n])
        assert int(other_opt.count) == 1
        # the restored model's routers were packed from the restored thresholds
        for mine, theirs in zip(other.layers, other.tree_routers()):
            assert not theirs.stale
            assert torch.equal(theirs.packed.threshold[: mine.moe.router_thr.numel()], mine.moe.router_thr)
        with pytest.raises(KeyError):
            ckpt.restore(str(tmp_path), 1, {"params": other, "opt": other_opt, "extra": torch.zeros(1)})


class TestFaultTolerantLoop:
    def _setup(self, tmp_path):
        cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                          dtype="float32")
        model = _model(cfg)
        tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=12, ckpt_every=3,
                           ckpt_dir=str(tmp_path))
        step = make_train_step(model, tcfg)
        pipe = pipeline_for(cfg, ShapeConfig("s", 16, 2, "train"))
        batches = lambda i: device_batch(pipe(i), "cpu")   # noqa: E731
        state = LoopState(model=model, opt_state=adamw_init(model), step=0)
        return state, step, batches, tcfg

    def test_loop_runs_and_checkpoints(self, tmp_path):
        state, step, batches, tcfg = self._setup(tmp_path)
        state, report = train_loop(state, step, batches, tcfg, max_steps=7)
        assert report.final_step == 7
        assert ckpt.latest_step(str(tmp_path)) == 6
        assert report.restarts == 0

    def test_restart_after_injected_failure(self, tmp_path):
        state, step, batches, tcfg = self._setup(tmp_path)
        fired = {"n": 0}

        def injector(i):
            if i == 5 and fired["n"] == 0:
                fired["n"] += 1
                raise SimulatedFailure("node died")

        def restore_fn(last_step):
            ckpt.restore(tcfg.ckpt_dir, last_step, {"params": state.model, "opt": state.opt_state})
            return LoopState(model=state.model, opt_state=state.opt_state, step=last_step)

        final, report = train_loop(
            state, step, batches, tcfg, max_steps=8,
            failure_injector=injector, restore_fn=restore_fn,
        )
        assert report.restarts == 1
        assert report.final_step == 8          # replayed through the failure

    def test_replayed_losses_equal_an_uninterrupted_run(self, tmp_path):
        """The restore rewinds the model and optimizer in place: the replayed
        steps 3 and 4 give the losses of the run that never failed, bit for bit."""
        state, step, batches, tcfg = self._setup(tmp_path / "a")
        _, clean = train_loop(state, step, batches, tcfg, max_steps=8)
        state, step, batches, tcfg = self._setup(tmp_path / "b")

        def injector(i):
            if i == 5 and not injector.fired:
                injector.fired = True
                raise SimulatedFailure("node died")
        injector.fired = False

        def restore_fn(last_step):
            ckpt.restore(tcfg.ckpt_dir, last_step, {"params": state.model, "opt": state.opt_state})
            return LoopState(model=state.model, opt_state=state.opt_state, step=last_step)

        _, report = train_loop(state, step, batches, tcfg, max_steps=8, failure_injector=injector,
                               restore_fn=restore_fn)
        assert report.restarts == 1 and report.final_step == 8
        # steps 0–4, then 3–7 again after the restore to step 3
        assert report.losses == clean.losses[:5] + clean.losses[3:]

    def test_only_simulated_failures_restart(self, tmp_path):
        state, step, batches, tcfg = self._setup(tmp_path)

        def injector(i):
            if i == 1:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

        with pytest.raises(RuntimeError, match="illegal memory access"):
            train_loop(state, step, batches, tcfg, max_steps=3, failure_injector=injector)

    def test_deterministic_replay(self, tmp_path):
        """Same (seed, step) → same batch → restart reproduces the loss."""
        state, step, batches, tcfg = self._setup(tmp_path)
        _, r1 = train_loop(state, step, batches, tcfg, max_steps=4)
        state2, step2, _, _ = self._setup(tmp_path)
        _, r2 = train_loop(state2, step2, batches, tcfg, max_steps=4)
        np.testing.assert_allclose(r1.losses, r2.losses, rtol=1e-6)

    def test_straggler_watchdog(self):
        w = StragglerWatchdog(factor=3.0, warmup=3)
        for _ in range(5):
            assert not w.observe(0.1)
        assert w.observe(1.0)
        assert w.events == 1


class TestDataPipeline:
    def test_deterministic_by_step(self):
        cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
        p = SyntheticLM(cfg)
        a, b = p(5), p(5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = p(6)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_labels_are_shifted_tokens(self):
        p = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=2))
        b = p(0)
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert np.all(b["labels"][:, -1] == -1)

    def test_sharding_is_slice_of_global(self):
        p = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=8))
        full = p(2)
        shard = p.shard(2, rank=1, world=4)
        np.testing.assert_array_equal(shard["tokens"], full["tokens"][2:4])

    def test_family_pipelines(self):
        vlm = get_smoke_config("qwen2-vl-72b")
        b = pipeline_for(vlm, ShapeConfig("s", 8, 2, "train"))(0)
        assert "embeds" in b and "positions" in b and "tokens" not in b
        assert b["positions"].shape == (2, 3, 8)
        aud = get_smoke_config("whisper-medium")
        b = pipeline_for(aud, ShapeConfig("s", 8, 2, "train"))(0)
        assert b["embeds"].shape == (2, aud.encoder.n_frames, aud.d_model)


class TestLosses:
    def test_softmax_xent_masks_padded_vocab(self):
        logits = torch.zeros((2, 4, 16))
        logits[..., 12:] = 100.0  # pad region hot
        labels = torch.zeros((2, 4), dtype=torch.int32)
        nll, _ = softmax_xent(logits, labels, vocab_size=12)
        assert abs(float(nll) - math.log(12)) < 1e-4

    def test_chunked_equals_dense(self):
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.normal(size=(2, 16, 8)), dtype=torch.float32)
        w = torch.tensor(rng.normal(size=(8, 32)), dtype=torch.float32)
        labels = torch.tensor(rng.integers(0, 30, size=(2, 16)), dtype=torch.int32)
        dense, _ = softmax_xent(x @ w, labels, vocab_size=30)
        for chunk in (4, 8, 16):
            c, _ = chunked_softmax_xent(x, w, labels, vocab_size=30, chunk=chunk)
            np.testing.assert_allclose(float(c), float(dense), rtol=1e-5)

    def test_chunked_gradients_match(self):
        rng = np.random.default_rng(1)
        x = torch.tensor(rng.normal(size=(2, 8, 8)), dtype=torch.float32)
        w = torch.tensor(rng.normal(size=(8, 16)), dtype=torch.float32, requires_grad=True)
        labels = torch.tensor(rng.integers(0, 16, size=(2, 8)), dtype=torch.int32)
        (g_dense,) = torch.autograd.grad(softmax_xent(x @ w, labels, vocab_size=16)[0], w)
        (g_chunk,) = torch.autograd.grad(chunked_softmax_xent(x, w, labels, vocab_size=16, chunk=4)[0], w)
        # f32 summation order differs between the chunked and dense paths;
        # the JAX test's rtol
        np.testing.assert_allclose(g_chunk.numpy(), g_dense.numpy(), rtol=5e-4)

    def test_label_masking(self):
        logits = torch.tensor(np.random.default_rng(2).normal(size=(1, 4, 8)), dtype=torch.float32)
        labels = torch.tensor([[1, 2, -1, -1]], dtype=torch.int32)
        _, nv = softmax_xent(logits, labels, vocab_size=8)
        assert float(nv) == 2.0


# ---------------------------------------------------------------------------
# test_arch_smoke.py's training tests, for every family
# ---------------------------------------------------------------------------


def _batch(cfg):
    return device_batch(pipeline_for(cfg, SMOKE_SHAPE, seed=0)(0), "cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_forward_and_train_step(arch):
    cfg = get_smoke_config(arch)
    model = _model(cfg)
    batch = _batch(cfg)

    with torch.no_grad():
        logits, aux = model(batch)
    assert logits.shape == (2, 32, model.v_pad), arch
    assert torch.isfinite(logits).all(), arch

    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    model, opt, metrics = step(model, adamw_init(model), batch)
    assert np.isfinite(float(metrics["loss"])), arch
    # params actually changed
    delta = sum(float((a - b.detach()).abs().sum()) for a, b in zip(before, model.parameters()))
    assert delta > 0, arch
    evals = make_eval_step(model)(model, batch)
    assert set(evals) == {"loss", "nll", "aux"} and torch.isfinite(evals["loss"])


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_loss_decreases(arch):
    cfg = get_smoke_config(arch)
    model = _model(cfg, seed=1)
    batch = _batch(cfg)
    step = make_train_step(model, TrainConfig(lr=3e-3, warmup_steps=1, total_steps=50))
    opt = adamw_init(model)
    losses = []
    for _ in range(8):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (arch, losses)


def test_every_arch_builds():
    """Every architecture's family is ported: the smoke and train tests above
    run all ten, and each builds on ``meta``."""
    assert PORTED == ARCH_IDS
    for arch in ARCH_IDS:
        model = build_model(get_smoke_config(arch), device="meta")
        assert all(p.device.type == "meta" for p in model.parameters()), arch


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_runs_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-moe", "--smoke",
         "--device", "cpu", "--steps", "4", "--seq", "32", "--batch", "2", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "arch=granite-moe-smoke" in out.stdout and "device=cpu" in out.stdout
    assert "4 steps in" in out.stdout and "restarts=0" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_launch_train_refuses_without_a_card_unless_told(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "yi", "--smoke", "--steps", "1"])
