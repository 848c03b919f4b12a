"""The port is complete, checked rather than asserted:

  * every module of the JAX package (``src/repro/**/*.py``) has its
    counterpart at the same path under ``src/repro_torch/``, but for the two
    that parse XLA's HLO text, whose counterpart is ``utils/op_cost.py``
    (it counts the same quantities from the aten ops a step dispatches);
  * every public function of the JAX package whose body reaches
    ``pl.pallas_call`` (directly, or through functions of its own module)
    is named in ``chip_smoke.py``'s ``REPLACES``: its wrapper's key plus
    ``_pallas``, and the ``file:line`` of its ``def``, the value the smoke's
    ``kernels`` line reports.  A ``def`` that moves without its value fails.

Both checks parse the files with ``ast``; nothing here imports JAX or the
port.  Each is also run on a small temporary tree, to show that it fails
where it should.
"""

from __future__ import annotations

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REF, PORT = REPO / "src" / "repro", REPO / "src" / "repro_torch"
# reference modules whose counterpart has another path
RENAMED = {"utils/hlo.py": "utils/op_cost.py", "utils/hlo_cost.py": "utils/op_cost.py"}


def missing_modules(ref: Path, port: Path) -> list[str]:
    """The modules under ``ref`` (paths relative to it) with no counterpart
    under ``port``."""
    out = []
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        if not (port / RENAMED.get(rel, rel)).is_file():
            out.append(rel)
    return out


def _callees(fn: ast.AST) -> set[str]:
    """The names ``fn`` calls: ``f(…)`` as ``f``, ``a.b(…)`` as ``b``."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                names.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                names.add(node.func.attr)
    return names


def pallas_kernels(root: Path, repo: Path) -> dict[str, str]:
    """Each public module-level function under ``root`` whose body reaches
    ``pallas_call``, directly or through functions of its own module → the
    ``file:line`` (relative to ``repo``) of its ``def``."""
    out = {}
    for f in sorted(root.rglob("*.py")):
        funcs = {n.name: n for n in ast.parse(f.read_text()).body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        callees = {name: _callees(fn) for name, fn in funcs.items()}
        reach = {name for name, c in callees.items() if "pallas_call" in c}
        while True:
            more = {name for name, c in callees.items() if c & reach} - reach
            if not more:
                break
            reach |= more
        out.update({name: f"{f.relative_to(repo).as_posix()}:{funcs[name].lineno}"
                    for name in reach if not name.startswith("_")})
    return out


def smoke_replaces(path: Path) -> dict[str, str]:
    """The literal ``REPLACES`` dict that ``path`` assigns at module level."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "REPLACES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} assigns no REPLACES")


def unmatched(kernels: dict[str, str], replaces: dict[str, str]) -> list[str]:
    """Where ``REPLACES`` (wrapper → ``file:line``) does not name exactly
    ``kernels`` (``<wrapper>_pallas`` → ``file:line``)."""
    named = {f"{wrapper}_pallas": where for wrapper, where in replaces.items()}
    return sorted(f"{name}: def at {kernels.get(name)}, REPLACES {named.get(name)}"
                  for name in kernels.keys() | named.keys() if kernels.get(name) != named.get(name))


def test_every_reference_module_has_its_counterpart():
    assert len(list(REF.rglob("*.py"))) > 50
    assert missing_modules(REF, PORT) == []
    for ref, port in RENAMED.items():     # the exceptions name modules that exist on both sides
        assert (REF / ref).is_file() and (PORT / port).is_file(), (ref, port)


def test_every_tpu_kernel_is_named_in_chip_smoke_replaces():
    kernels = pallas_kernels(REF, REPO)
    assert len(kernels) == 8, sorted(kernels)   # K7 and K8 share _fused_q_pallas, which is private
    assert unmatched(kernels, smoke_replaces(REPO / "chip_smoke.py")) == []


def test_completeness_checks_fail_where_they_should(tmp_path):
    ref, port = tmp_path / "src" / "repro", tmp_path / "src" / "repro_torch"
    for root, names in ((ref, ("a.py", "utils/hlo.py", "utils/hlo_cost.py", "sub/b.py")),
                        (port, ("a.py", "utils/op_cost.py"))):
        for name in names:
            (root / name).parent.mkdir(parents=True, exist_ok=True)
            (root / name).write_text("")
    assert missing_modules(ref, port) == ["sub/b.py"]
    (port / "sub").mkdir()
    (port / "sub" / "b.py").write_text("")
    assert missing_modules(ref, port) == []
    (port / "utils" / "op_cost.py").unlink()
    assert missing_modules(ref, port) == ["utils/hlo.py", "utils/hlo_cost.py"]

    body = ("from jax.experimental import pallas as pl\n\n"
            "def _shared(k, x):\n    return pl.pallas_call(k)(x)\n\n"
            "def one_pallas(x):\n    return pl.pallas_call(_body)(x)\n\n"
            "def two_pallas(x):\n    return _shared(_body, x)\n\n"
            "def helper(x):\n    return x\n")
    (ref / "k.py").write_text(body)
    kernels = pallas_kernels(ref, tmp_path)
    assert kernels == {"one_pallas": "src/repro/k.py:6", "two_pallas": "src/repro/k.py:9"}
    replaces = {"one": "src/repro/k.py:6", "two": "src/repro/k.py:9"}
    assert unmatched(kernels, replaces) == []
    assert unmatched(kernels, {"one": replaces["one"]}) == ["two_pallas: def at src/repro/k.py:9, REPLACES None"]
    assert unmatched(kernels, {**replaces, "three": "src/repro/k.py:12"}) != []
    (ref / "k.py").write_text("# a line above moves every def\n" + body)
    assert unmatched(pallas_kernels(ref, tmp_path), replaces) == [
        "one_pallas: def at src/repro/k.py:7, REPLACES src/repro/k.py:6",
        "two_pallas: def at src/repro/k.py:10, REPLACES src/repro/k.py:9"]
    (tmp_path / "smoke.py").write_text(f"X = 1\nREPLACES = {replaces!r}\n")
    assert smoke_replaces(tmp_path / "smoke.py") == replaces
