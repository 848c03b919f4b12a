"""Persistent best-variant cache: JSON on disk, LRU dict in front.

One JSON file holds every tuning result, keyed by
``device:kind:xN|M…|N…|A…|d…`` bucket strings (see
:meth:`repro_torch.tune.space.WorkloadShape.key`).  Lookups go through a
bounded in-process LRU so the hot dispatch path never touches the
filesystem; writes go straight through to disk (atomic rename) so
concurrent processes at worst lose a race, never corrupt the file.

Staleness: the file carries a fingerprint of the kernel variant registry
(:func:`registry_fingerprint`): variant names and metadata, the sources of
the Python modules they lower through, the bytes of the CUDA source and the
``nvcc`` flags it is built with.  A kernel rewrite changes the fingerprint,
so every stored winner — timings of code that no longer exists — is
discarded on load and the affected buckets re-tune on next sight.

Default location: ``$REPRO_TORCH_TUNE_CACHE`` or
``~/.cache/repro_torch_tune/cache.json`` — apart from the JAX package's
``~/.cache/repro_tune/``, so neither package reads the other's rows.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
CACHE_VERSION = 1


@functools.lru_cache(maxsize=1)
def registry_fingerprint() -> str:
    """Hash of the kernel variant registry: names, metadata, sources, build.

    Any change to a variant's implementation (its Python wrapper, the
    modules it lowers through, the CUDA source or its compiler flags) must
    invalidate stored winners, since the cached medians priced code that no
    longer runs.
    """
    import hashlib
    import inspect

    from repro_torch.core import eval_dataparallel as _dp
    from repro_torch.core import eval_speculative as _spec
    from repro_torch.kernels import _build
    from repro_torch.kernels.tree_eval import cascade as _cascade
    from repro_torch.kernels.tree_eval import kernel as _kernel
    from repro_torch.kernels.tree_eval import ops as _ops
    from repro_torch.kernels.tree_eval import quant as _quant

    h = hashlib.sha256()
    registries = [
        ("tree", _ops.VARIANTS),
        ("forest", _ops.FOREST_VARIANTS),
        ("cascade", _cascade.CASCADE_VARIANTS),
    ]
    for tag, registry in registries:
        for name in sorted(registry):
            spec = registry[name]
            h.update(f"{tag}:{name}".encode())
            h.update(
                f"|{spec.algorithm}|{spec.engine}|{spec.jump_mode}|{spec.tunables}".encode()
            )
            h.update(f"|{getattr(spec, 'family', '')}".encode())
            h.update(f"|{getattr(spec, 'layout', '')}".encode())
            fn = getattr(spec, "fn", None) or getattr(spec, "build", None)
            try:
                h.update(inspect.getsource(fn).encode())
            except (OSError, TypeError):
                h.update(repr(fn).encode())
    # the registered fns are thin wrappers: hash the modules the variants
    # lower through, the CUDA source and how it is compiled
    for mod in (_ops, _kernel, _cascade, _spec, _dp, _quant):
        try:
            h.update(inspect.getsource(mod).encode())
        except (OSError, TypeError):
            pass
    h.update(_kernel.SOURCE.read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def default_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env).expanduser()
    return Path("~/.cache/repro_torch_tune/cache.json").expanduser()


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    """The winning candidate for one shape bucket."""

    variant: str
    params: dict
    median_ms: float
    # provenance, for reports / staleness checks
    shape: dict | None = None
    backend: str = ""
    # d_µ the resolution saw, and where it came from ("measured" = traversal
    # profiler, "sampled" = host descent on the batch, "prior" = geometry,
    # "caller" = heuristic_kw override, "" = unrecorded)
    d_mu: float | None = None
    d_mu_source: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TuneEntry":
        return cls(
            variant=str(d["variant"]),
            params=dict(d.get("params", {})),
            median_ms=float(d.get("median_ms", 0.0)),
            shape=d.get("shape"),
            backend=str(d.get("backend", "")),
            d_mu=(None if d.get("d_mu") is None else float(d["d_mu"])),
            d_mu_source=str(d.get("d_mu_source", "")),
        )


class TuneCache:
    """JSON-backed best-variant store with a bounded LRU front.

    The LRU only caches *hits*; misses always re-check the loaded table so a
    concurrent tuner's writes show up after :meth:`reload`.  In-process
    state is guarded by a lock: the serve engine's background re-tune stores
    winners from a worker thread while the request path looks up.
    """

    def __init__(
        self,
        path: os.PathLike | str | None = None,
        *,
        lru_size: int = 128,
        registry: str | None = None,
    ):
        self.path = Path(path) if path is not None else default_cache_path()
        self.lru_size = lru_size
        # injectable for tests; None = fingerprint of the live registry
        self._registry = registry
        self._lru: OrderedDict[str, TuneEntry] = OrderedDict()
        self._table: dict[str, dict] = {}
        self._lock = threading.Lock()      # in-memory state (lookup hot path)
        self._io_lock = threading.Lock()   # file writes — never held with _lock
        self._seq = 0                      # snapshot order, so a slow writer
        self._written_seq = 0              # can't clobber a newer flush
        self.reload()

    @property
    def registry(self) -> str:
        return self._registry if self._registry is not None else registry_fingerprint()

    # -- persistence --------------------------------------------------------

    def reload(self) -> None:
        """(Re)read the on-disk table; tolerates a missing/corrupt file.

        Entries written under a different schema version or a different
        kernel-registry fingerprint are discarded wholesale.
        """
        table = {}
        try:
            raw = json.loads(self.path.read_text())
            if (
                isinstance(raw, dict)
                and raw.get("version") == CACHE_VERSION
                and raw.get("registry") == self.registry
            ):
                table = dict(raw.get("entries", {}))
        except (OSError, ValueError):
            pass
        with self._lock:
            self._table = table
            self._lru.clear()

    def _flush(self, payload: dict, seq: int) -> None:
        """Write a table snapshot (atomic rename), skipping stale snapshots.

        Runs *outside* ``_lock`` so lookups on the serving request path
        never block on disk I/O.
        """
        with self._io_lock:
            if seq <= self._written_seq:
                return
            self._written_seq = seq
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # -- access -------------------------------------------------------------

    def lookup(self, key: str) -> Optional[TuneEntry]:
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                return hit
            raw = self._table.get(key)
            if raw is None:
                return None
            entry = TuneEntry.from_json(raw)
            self._lru[key] = entry
            if len(self._lru) > self.lru_size:
                self._lru.popitem(last=False)
            return entry

    def store(self, key: str, entry: TuneEntry) -> None:
        with self._lock:
            self._table[key] = entry.to_json()
            self._lru[key] = entry
            self._lru.move_to_end(key)
            if len(self._lru) > self.lru_size:
                self._lru.popitem(last=False)
            self._seq += 1
            seq = self._seq
            payload = {
                "version": CACHE_VERSION,
                "registry": self.registry,
                "entries": dict(self._table),
            }
        self._flush(payload, seq)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._table)
