"""Observability smoke: a traced serve pass, exported and sanity-checked.

The port's own copy of the JAX package's ``obs/smoke.py``.  Build a small
bagged forest, push a few record waves through a
:class:`repro_torch.serve.ForestServeEngine` with metrics + tracing enabled,
export a Chrome/Perfetto trace and a Prometheus text snapshot, then check
that

* the Chrome trace parses as JSON and contains nested ``serve.wave`` →
  ``stream.eval`` → ``kernel.dispatch`` spans;
* the Prometheus text parses line-by-line and names the core series
  (wave latency, chunker throughput/overlap, tuner resolutions);
* registering a conflicting duplicate metric raises
  :class:`repro_torch.obs.DuplicateMetricError`;
* a serve pass under an unmeetable SLO trips the flight recorder — breach
  counters land in the registry and the dumped bundle (``flight.json`` +
  Perfetto ``trace.json``) parses;
* a sampled shadow-profile pass publishes per-bucket d_µ / waste-ratio
  gauges and Perfetto **counter tracks** (``"ph": "C"`` events) that parse.

Artifacts (and the tuner's cache of the run) land in ``--out`` (default
``repro_torch_obs_smoke`` in the temporary directory).  The engine serves on
the card unless ``--device cpu`` is given (without a card that is required).
Exit code 0 means every check passed.

    PYTHONPATH=src python -m repro_torch.obs.smoke [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

N_TREES = 6
N_CLASSES = 7
WAVE_RECORDS = 512
REQUESTS = 4

# Series the serve path must populate for the snapshot to count as healthy.
CORE_METRICS = (
    "serve.waves",
    "serve.records",
    "serve.wave_ms",
    "serve.queue_wait_ms",
    "serve.pad_fraction",
    "stream.chunks",
    "stream.chunk_ms",
    "stream.overlap_ratio",
    "tune.resolutions",
)

# A wave span must (transitively) contain these children on the stream path.
NESTED_SPANS = ("serve.wave", "stream.eval", "kernel.dispatch")


def _forest(seed: int = 0):
    import numpy as np

    from repro_torch.core import CartConfig, EncodedForest, breadth_first_encode, train_cart
    from repro_torch.data.segmentation import make_segmentation

    data = make_segmentation(seed)
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(N_TREES):
        idx = rng.integers(0, data.x_train.shape[0], data.x_train.shape[0])
        root = train_cart(
            data.x_train[idx], data.y_train[idx], N_CLASSES,
            CartConfig(max_depth=6, min_samples_split=16, min_gain=4e-3),
        )
        trees.append(breadth_first_encode(root))
    return EncodedForest(trees), data


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _serve_traced(out_dir: Path, devices, registry, tracer, flight=None, profile=None):
    import numpy as np

    from repro_torch.serve import ForestServeEngine, TreeRequest
    from repro_torch.tune import TuneCache

    forest, data = _forest()
    rec = np.tile(data.x_test, (WAVE_RECORDS // data.x_test.shape[0] + 1, 1))
    rec = rec[:WAVE_RECORDS].astype(np.float32)
    # profile defaults to None (not the engine's default-on policy) so the
    # span-nesting and flight checks stay deterministic; check_profiler
    # passes an explicit synchronous policy
    eng = ForestServeEngine(
        forest, max_batch=WAVE_RECORDS, chunk_records=WAVE_RECORDS // 4,
        n_classes=N_CLASSES, retune=None, profile=profile,
        registry=registry, tracer=tracer, flight=flight,
        cache=TuneCache(out_dir / "tune_cache.json"), devices=devices,
    )
    reqs = [TreeRequest(uid=i, records=rec) for i in range(REQUESTS)]
    out = eng.run(reqs)
    _require(len(out) == REQUESTS, f"served {len(out)}/{REQUESTS} requests")
    return eng


def check_flight_bundle(out_dir: Path, devices) -> None:
    """A breach-forced serve pass must dump a loadable flight bundle."""
    from repro_torch import obs

    registry, tracer = obs.Registry(), obs.Tracer()
    policy = obs.FlightPolicy(slo_ms=1e-6, out_dir=str(out_dir),
                              min_dump_interval_s=0.0)
    eng = _serve_traced(out_dir, devices, registry, tracer, flight=policy)
    snap = obs.snapshot(registry)
    breach_series = [k for k in snap["counters"] if k.startswith("flight.slo_breaches")]
    _require(breach_series and all(snap["counters"][k] > 0 for k in breach_series),
             f"no SLO breaches counted under a {policy.slo_ms} ms SLO")
    bundles = sorted(out_dir.glob("flight-forest-*"))
    _require(bundles, "no flight bundle dumped on breach")
    bundle = bundles[-1]
    flight = json.loads((bundle / "flight.json").read_text())
    _require(flight["reason"] == "slo_breach" and flight["waves"], "flight.json missing reason/waves")
    trace = json.loads((bundle / "trace.json").read_text())
    _require(trace.get("traceEvents"), "flight trace.json has no traceEvents")
    _ = eng.dump_flight("smoke")  # the explicit path must work too
    print(f"flight recorder ok: {len(bundles)} bundle(s), "
          f"{len(flight['waves'])} waves in ring, breaches counted")


def check_chrome_trace(path: Path) -> None:
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    _require(events, "empty traceEvents")
    by_name: dict[str, list[dict]] = {}
    for ev in events:
        by_name.setdefault(ev.get("name", ""), []).append(ev)
    for name in NESTED_SPANS:
        _require(name in by_name, f"missing span {name!r} in trace")
    # nesting: some kernel.dispatch span must sit inside a stream.eval span
    # which sits inside a serve.wave span (same thread, time containment).
    def _contains(outer: dict, inner: dict) -> bool:
        return (outer["tid"] == inner["tid"]
                and outer["ts"] <= inner["ts"]
                and inner["ts"] + inner.get("dur", 0) <= outer["ts"] + outer.get("dur", 0))

    nested = any(
        _contains(w, e) and _contains(e, k)
        for w in by_name["serve.wave"]
        for e in by_name["stream.eval"]
        for k in by_name["kernel.dispatch"]
    )
    _require(nested, "no serve.wave > stream.eval > kernel.dispatch nesting found")
    print(f"chrome trace ok: {len(events)} events, nesting verified")


def check_prometheus(path: Path) -> None:
    text = path.read_text()
    _require(text.endswith("\n"), "prometheus text must end with a newline")
    seen = set()
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            seen.add(line.split()[2])
            continue
        _require(line, "blank line in prometheus exposition")
        name = line.split("{", 1)[0].split(" ", 1)[0]
        sample = line.rsplit(" ", 1)
        _require(len(sample) == 2, f"malformed sample line: {line!r}")
        float(sample[1])  # value must parse
        seen.add(name.removesuffix("_bucket").removesuffix("_count")
                 .removesuffix("_sum"))
    # exposition names are the dotted originals with dots sanitised away
    missing = [m for m in CORE_METRICS if m.replace(".", "_") not in seen]
    _require(not missing, f"core metrics absent from snapshot: {missing}")
    print(f"prometheus text ok: {len(seen)} series, core metrics present")


def check_profiler(out_dir: Path, devices) -> None:
    """A sampled shadow pass must publish gauges + parsable counter tracks."""
    from repro_torch import obs

    registry, tracer = obs.Registry(), obs.Tracer()
    eng = _serve_traced(
        out_dir, devices, registry, tracer,
        profile=obs.ProfilePolicy(sample_every=1, synchronous=True),
    )
    _require(eng.profiler is not None, "engine built without a profiler")
    eng.profiler.drain()
    snap = obs.snapshot(registry)
    sampled = [v for k, v in snap["counters"].items()
               if k.startswith("prof.sampled")]
    _require(sampled and sum(sampled) > 0, "no profiled waves counted")
    d_mu = {k: v for k, v in snap["gauges"].items() if k.startswith("prof.d_mu")}
    _require(d_mu and all(v >= 1.0 for v in d_mu.values()),
             f"per-bucket d_mu gauges missing or degenerate: {d_mu}")
    waste = {k: v for k, v in snap["gauges"].items()
             if k.startswith("prof.waste_ratio")}
    _require(waste and all(v >= 1.0 for v in waste.values()),
             f"per-bucket waste-ratio gauges missing or degenerate: {waste}")

    path = out_dir / "profile_trace.json"
    tracer.write_chrome_trace(path)
    doc = json.loads(path.read_text())
    counters = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    _require(counters, "no counter-track events in profile trace")
    for ev in counters:
        # Perfetto counter tracks: no dur, numeric args only
        _require("dur" not in ev, f"counter event carries dur: {ev}")
        args = ev.get("args")
        _require(args and all(isinstance(v, (int, float)) for v in args.values()),
                 f"counter event args not numeric: {ev}")
    tracks = {e["name"] for e in counters}
    for prefix in ("prof.d_mu/", "prof.waste/"):
        _require(any(t.startswith(prefix) for t in tracks),
                 f"no {prefix}* counter track among {sorted(tracks)}")
    print(f"profiler ok: {len(d_mu)} bucket(s), {len(counters)} counter "
          f"events across {len(tracks)} tracks")


def check_duplicate_registration(registry) -> None:
    from repro_torch.obs import DuplicateMetricError

    registry.counter("smoke.dup", "first registration")
    try:
        registry.gauge("smoke.dup", "conflicting kind")
    except DuplicateMetricError:
        print("duplicate registration raises: ok")
        return
    raise AssertionError("conflicting re-registration did not raise")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "repro_torch_obs_smoke"))
    parser.add_argument("--device", default=None,
                        help="where the engine serves: the card by default, 'cpu' for the host")
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    devices = None if args.device is None else (args.device,)

    from repro_torch import obs

    registry, tracer = obs.Registry(), obs.Tracer()
    eng = _serve_traced(out, devices, registry, tracer)
    print(f"served: {eng.stats.waves} waves, {eng.stats.records} records, "
          f"{eng.stats.chunks} chunks")

    trace_path = out / "trace.json"
    tracer.write_chrome_trace(trace_path)
    prom_path = out / "metrics.prom"
    prom_path.write_text(obs.prometheus_text(registry))
    snap_path = out / "snapshot.json"
    obs.write_json_snapshot(registry, snap_path)

    check_chrome_trace(trace_path)
    check_prometheus(prom_path)
    json.loads(snap_path.read_text())  # snapshot must round-trip
    check_duplicate_registration(registry)
    check_flight_bundle(out / "flight", devices)
    check_profiler(out, devices)
    print(f"artifacts in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
