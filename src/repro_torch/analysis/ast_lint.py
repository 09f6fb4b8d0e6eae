"""Repo-specific AST lint rules for ``src/repro_torch``.

Port of ``repro.analysis.ast_lint``: three rules, each a convention the
runtime auditors cannot see by running one call.

``ast-host-sync``
    The port has no ``jit`` to mark its hot paths, so ``SYNC_FREE`` lists
    the functions that claim no host read: the targets of the registry's
    entries with a ``card`` call (``entries.registry``).  Inside one, no ``x.item()``,
    ``x.tolist()``, ``x.cpu()``, ``x.numpy()``, ``float(x)``, ``int(x)``,
    ``bool(x)`` of a non-constant, ``np.asarray(x)`` or ``np.array(x)``:
    on a CUDA tensor each waits for the card.  The rule FOLLOWS CALLS to
    functions of the same module, transitively, so a registered function
    is charged with the reads of its helpers (the finding's detail names
    the chain).  ``float``/``int``/``bool`` of host metadata (a constant,
    ``.shape``, ``.ndim``, ``len(...)``, ``.numel()``, ...) or of a
    parameter annotated as a Python number are not reads.

``ast-alive-thread``
    Every public ``core/`` function that accepts an ``alive`` parameter
    must read it somewhere beyond its ``alive is None`` default guard:
    accepting the mask and dropping it silently disables liveness gating.

``ast-receipt-json``
    Every ``*Receipt`` class in ``core/`` and ``launch/`` exposes a
    ``to_json`` method (receipts are the machine-readable audit trail).

Known violations live in ``audit_baseline.json`` beside this module, each
with a justification; the audit fails on anything new and on stale
entries (shrink-only).  The card's ``sync_audit`` checks the same
registry by running it under ``torch.cuda.set_sync_debug_mode("error")``.
"""

from __future__ import annotations

import ast
import os

from . import entries
from .report import Finding


def _sync_free() -> dict[str, tuple[str, ...]]:
    """The registry's sync-free targets (the entries with a ``card`` call),
    by file under src/repro_torch/."""
    out: dict[str, tuple[str, ...]] = {}
    for e in entries.registry():
        if e.card is not None and e.function not in out.get(e.path, ()):
            out[e.path] = out.get(e.path, ()) + (e.function,)
    return out


# Functions that claim no host read, by file under src/repro_torch/.
SYNC_FREE: dict[str, tuple[str, ...]] = _sync_free()

PACKAGE_DIRS = ("core", "kernels", "launch", "analysis")

_HOST_NP_FUNCS = {"asarray", "array"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"float", "int", "bool"}
_META_ATTRS = {"shape", "ndim", "dtype", "itemsize", "device"}
_META_CALLS = {"len", "numel", "dim", "size", "element_size", "is_floating_point"}
_NUMBER_TYPES = {"float", "int", "bool"}


def _np_aliases(tree: ast.Module) -> set[str]:
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases


def _number_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters annotated as Python numbers (``x: float``, ``k: int``)."""
    args = fn.args
    every = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
    return {
        a.arg for a in every
        if isinstance(a.annotation, ast.Name) and a.annotation.id in _NUMBER_TYPES
    }


def _host_meta(node: ast.expr, numbers: set[str]) -> bool:
    """True for an expression that holds no tensor value: a constant, a
    Python-number parameter, or shape/dtype metadata."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in numbers
    if isinstance(node, ast.Attribute):
        return node.attr in _META_ATTRS
    if isinstance(node, ast.Subscript):
        return _host_meta(node.value, numbers)
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        return name in _META_CALLS
    if isinstance(node, ast.BinOp):
        return _host_meta(node.left, numbers) and _host_meta(node.right, numbers)
    if isinstance(node, ast.UnaryOp):
        return _host_meta(node.operand, numbers)
    return False


def _host_sync_calls(fn: ast.FunctionDef, np_aliases: set[str]):
    """Yield (tag, lineno) for the host-reading calls inside ``fn``."""
    numbers = _number_params(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in _HOST_CASTS and node.args:
            if not _host_meta(node.args[0], numbers):
                yield f.id, node.lineno
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in np_aliases
            and f.attr in _HOST_NP_FUNCS
        ):
            yield f"np.{f.attr}", node.lineno
        elif isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
            yield f.attr, node.lineno


def _local_calls(fn: ast.FunctionDef, local: dict) -> list[str]:
    """Names of the module's own functions that ``fn`` calls."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in local and node.func.id not in out:
                out.append(node.func.id)
    return out


def _reads_through_calls(root: str, local: dict, np_aliases: set[str]):
    """Yield (tag, lineno, chain) for every host read reachable from
    ``root`` through calls to functions of the same module."""
    seen = {root}
    todo = [(root, root)]
    while todo:
        name, chain = todo.pop(0)
        for tag, lineno in _host_sync_calls(local[name], np_aliases):
            yield tag, lineno, chain
        for callee in _local_calls(local[name], local):
            if callee not in seen:
                seen.add(callee)
                todo.append((callee, f"{chain} -> {callee}"))


def _accepts_alive(fn: ast.FunctionDef) -> bool:
    args = fn.args
    every = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
    return any(a.arg == "alive" for a in every)


def _alive_threaded(fn: ast.FunctionDef) -> bool:
    """``alive`` is READ beyond its ``alive is (not) None`` default guard."""
    guard_reads = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Compare)
            and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.Is, ast.IsNot))
            and isinstance(node.left, ast.Name)
            and node.left.id == "alive"
        ):
            guard_reads.add(id(node.left))
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Name)
            and node.id == "alive"
            and isinstance(node.ctx, ast.Load)
            and id(node) not in guard_reads
        ):
            return True
    return False


def sync_free_names(rel: str) -> tuple[str, ...]:
    """The ``SYNC_FREE`` functions of the file at ``rel`` (a repo path)."""
    for key, names in SYNC_FREE.items():
        if rel == key or rel.endswith("/" + key):
            return names
    return ()


def lint_file(path: str, repo_root: str, sync_free=None) -> list[Finding]:
    """The three rules over one file.  ``sync_free`` overrides the file's
    ``SYNC_FREE`` names (default: looked up by its path)."""
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)

    in_core = "/core/" in f"/{rel}"
    findings: list[Finding] = []
    np_aliases = _np_aliases(tree)
    local = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    names = sync_free_names(rel) if sync_free is None else tuple(sync_free)

    for name in (n for n in names if n in local):
        for tag, lineno, chain in _reads_through_calls(name, local, np_aliases):
            findings.append(Finding(
                "ast-host-sync", f"{rel}:{name}", tag,
                f"line {lineno} ({chain}): {tag} reads a value on the host "
                "inside a function registered sync-free",
            ))

    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            if (
                in_core
                and not node.name.startswith("_")
                and _accepts_alive(node)
                and not _alive_threaded(node)
            ):
                findings.append(Finding(
                    "ast-alive-thread", f"{rel}:{node.name}", "",
                    f"line {node.lineno}: public function accepts 'alive' but "
                    "never threads it into a call or return: the liveness gate "
                    "is dropped",
                ))
        elif isinstance(node, ast.ClassDef):
            if node.name.endswith("Receipt") and not any(
                (isinstance(b, ast.FunctionDef) and b.name == "to_json")
                or (
                    isinstance(b, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "to_json" for t in b.targets)
                )
                for b in node.body
            ):
                findings.append(Finding(
                    "ast-receipt-json", f"{rel}:{node.name}", "",
                    f"line {node.lineno}: receipt class without to_json: "
                    "an unserializable audit trail",
                ))
    # one finding per key (the first read of each tag)
    out: dict[str, Finding] = {}
    for f in findings:
        out.setdefault(f.key, f)
    return list(out.values())


def default_paths(repo_root: str) -> list[str]:
    """All lintable modules: src/repro_torch/{core,kernels,launch,analysis}."""
    out = []
    for sub in PACKAGE_DIRS:
        d = os.path.join(repo_root, "src", "repro_torch", sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                out.append(os.path.join(d, name))
    return out


def repo_root() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def lint_paths(paths: list[str] | None = None, root: str | None = None) -> list[Finding]:
    root = repo_root() if root is None else root
    findings: list[Finding] = []
    for p in default_paths(root) if paths is None else paths:
        findings += lint_file(p, root)
    return findings
