"""Repo-specific AST lint over the port -- the source-level half of the
port's analysis gate.

The port's own copy of ``repro.analysis.lint`` (it imports nothing of
``repro``), with the same rule ids and the same suppression syntax, so a
finding reads the same in either gate.  Rules:

``host-time-in-jit``
    ``time.*``, ``datetime.*``, or ``np.random.*`` reachable from a
    function handed to a tracing callee (``jit``, ``vmap``, ``scan``,
    ``cond``, ...).  A host clock inside a traced function freezes at
    trace time; host RNG breaks reproducibility.
``np-in-traced``
    A bare ``np.`` op inside such a function: numpy forces the operand to
    the host.
``raw-env-flag``
    Any read of a ``REPRO_*`` flag: ``os.environ`` / ``os.getenv`` and the
    reference's ``envflags.bool_flag`` / ``path_flag`` alike.  The port
    has no environment flags at all (the tensor's device picks a
    kernel's route and nothing else), so it has no sanctioned read path
    either -- this is the reference rule's stricter reading.
``env-flag-scope``
    Kept for its id only: it flagged ``bool_flag`` called below module
    scope, and the port has no ``bool_flag``.  Every such call is a
    ``raw-env-flag`` finding here, wherever it stands, so this rule can
    never fire.
``unfrozen-config-dataclass``
    A dataclass named ``*Config`` / ``*Params`` / ``*Spec`` /
    ``*Profile`` without ``frozen=True``: the repo's convention for
    static configuration, which must stay immutable and hashable.

**Traced-set inference** is the reference's: a function is traced if it
(a) is decorated with ``jit`` (directly or via ``functools.partial``),
(b) is passed by name to a tracing callee, (c) is lexically nested inside
a traced function, or (d) is called by name from a traced function
(module-local call-edge closure).  The escape hatch is an inline
suppression, which must carry the rule id:

    x = np.round(v)  # repro-lint: allow=np-in-traced -- static schedule

A suppression on a ``def`` line covers that rule for the whole function.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

RULES = ("host-time-in-jit", "np-in-traced", "raw-env-flag",
         "env-flag-scope", "unfrozen-config-dataclass")

_ALLOW_RE = re.compile(r"repro-lint:\s*allow=([\w,-]+)")
_CONFIG_NAME_RE = re.compile(r"(Config|Params|Spec|Profile)$")

# callables that trace a function argument passed to them by name
_TRACING_CALLEES = {
    "jit", "vmap", "pmap", "grad", "value_and_grad", "checkpoint",
    "shard_map", "pallas_call", "scan", "cond", "while_loop", "fori_loop",
    "switch", "custom_vjp", "custom_jvp",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _terminal_attr(node: ast.AST) -> str:
    """Last attribute name of a dotted expression (``jax.lax.scan`` →
    ``scan``; bare ``jit`` → ``jit``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """``jax.lax.scan`` → ``"jax.lax.scan"`` (best-effort)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_jit_decorator(dec: ast.AST) -> bool:
    """``@jax.jit``, ``@jit``, ``@functools.partial(jax.jit, ...)``."""
    if _terminal_attr(dec) == "jit":
        return True
    if isinstance(dec, ast.Call):
        callee = _terminal_attr(dec.func)
        if callee == "jit":
            return True
        if callee == "partial" and dec.args:
            return _terminal_attr(dec.args[0]) == "jit"
    return False


def _line_allows(source: str) -> dict:
    """{lineno: set of allowed rule ids} from suppression comments."""
    allows = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            allows[i] = set(m.group(1).split(","))
    return allows


class _Scopes(ast.NodeVisitor):
    """Collect every function def, its parent def, and its call edges."""

    def __init__(self):
        self.defs: list = []           # every FunctionDef node
        self.parent: dict = {}         # def node -> enclosing def (or None)
        self.calls: dict = {}          # def node -> {called names}
        self.traced_roots: set = set()  # def nodes
        self.by_name: dict = {}        # name -> [def nodes]
        self._marks: list = []         # (scope, name) handed to a tracer
        self._stack: list = [None]

    def _enter(self, node):
        self.parent[node] = self._stack[-1]
        self.defs.append(node)
        self.by_name.setdefault(node.name, []).append(node)
        self.calls[node] = set()
        if any(_is_jit_decorator(d) for d in node.decorator_list):
            self.traced_roots.add(node)
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter

    def visit_Call(self, node: ast.Call):
        enclosing = self._stack[-1]
        if enclosing is not None and isinstance(node.func, ast.Name):
            self.calls[enclosing].add(node.func.id)
        # fn arguments handed by name to a tracing callee become roots:
        # jax.jit(run_epoch), shard_map(body, ...), lax.scan(tick, ...)
        if _terminal_attr(node.func) in _TRACING_CALLEES:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    self._marks.append((enclosing, arg.id))
        self.generic_visit(node)

    def resolve(self, scope, name: str):
        """Lexical-scope name resolution: a def named ``name`` whose
        parent is the *nearest* enclosing scope of ``scope`` (itself, an
        ancestor, or module level).  Keeps same-named defs in unrelated
        factory closures (four different ``act``s) from conflating."""
        chain = []
        s = scope
        while s is not None:
            chain.append(s)
            s = self.parent.get(s)
        chain.append(None)  # module scope
        for anchor in chain:
            hits = [d for d in self.by_name.get(name, [])
                    if self.parent.get(d) is anchor]
            if hits:
                return hits
        return []


def _traced_set(scopes: _Scopes) -> set:
    """Roots + by-name tracer args + lexical nesting + module-local
    call-edge closure, all resolved lexically."""
    traced = set(scopes.traced_roots)
    for scope, name in scopes._marks:
        traced.update(scopes.resolve(scope, name))
    changed = True
    while changed:
        changed = False
        for d in scopes.defs:
            if d in traced:
                continue
            p = scopes.parent[d]
            if p is not None and p in traced:
                traced.add(d)
                changed = True
        for d in list(traced):
            for callee in scopes.calls.get(d, ()):
                for target in scopes.resolve(d, callee):
                    if target not in traced:
                        traced.add(target)
                        changed = True
    return traced


def _suppressed(node: ast.AST, rule: str, allows: dict,
                def_lines=()) -> bool:
    """A finding is suppressed by an allow comment on its own line or on
    the ``def`` line of any enclosing function."""
    if rule in allows.get(getattr(node, "lineno", 0), ()):
        return True
    return any(rule in allows.get(ln, ()) for ln in def_lines)


def _host_call_rule(dotted: str) -> Optional[str]:
    if dotted.startswith(("time.", "datetime.")) or dotted == "time":
        return "host-time-in-jit"
    if dotted.startswith("np.random.") or dotted.startswith("numpy.random."):
        return "host-time-in-jit"
    return None


_ENV_READS = frozenset({"os.getenv", "os.environ.get"})
# the reference's strict readers (repro.analysis.envflags)
_FLAG_HELPERS = frozenset({"bool_flag", "path_flag"})


def _flag_name(node: ast.AST) -> str:
    """The flag a read names: a string constant or a variable's name."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_flag(name: str) -> bool:
    return name.startswith("REPRO") or name.endswith("_ENV")


def lint_source(source: str, path: str = "<string>") -> list:
    """Lint one module's source; returns :class:`Finding` records."""
    tree = ast.parse(source, filename=path)
    allows = _line_allows(source)
    scopes = _Scopes()
    scopes.visit(tree)
    traced = _traced_set(scopes)
    findings = []

    def add(node, rule, msg, def_lines=()):
        if not _suppressed(node, rule, allows, def_lines):
            findings.append(Finding(path, node.lineno, rule, msg))

    def _def_chain_lines(fn):
        lines = []
        while fn is not None:
            lines.append(fn.lineno)
            fn = scopes.parent.get(fn)
        return lines

    # ---- traced-function rules --------------------------------------
    for fn in traced:
        chain = _def_chain_lines(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute):
                dotted = _dotted(node)
                rule = _host_call_rule(dotted)
                if rule:
                    add(node, rule,
                        f"{dotted} reachable from jit-traced "
                        f"{fn.name!r} — host clocks/RNG freeze at trace "
                        f"time", chain)
                elif (isinstance(node.value, ast.Name)
                      and node.value.id in ("np", "numpy")):
                    add(node, "np-in-traced",
                        f"bare np.{node.attr} inside jit-traced "
                        f"{fn.name!r} — forces the operand to the host; "
                        f"use torch or hoist to static setup", chain)

    # ---- module-wide rules ------------------------------------------
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            callee = _dotted(node.func)
            # REPRO_* env reads, raw or through the reference's helpers
            if callee in _ENV_READS or callee.startswith("os.environ."):
                name = next((n for n in map(_flag_name, node.args)
                             if _is_flag(n)), "")
                if name:
                    add(node, "raw-env-flag",
                        f"env read of {name!r} -- the port has no "
                        f"environment flags")
            elif _terminal_attr(node.func) in _FLAG_HELPERS:
                add(node, "raw-env-flag",
                    f"{callee or _terminal_attr(node.func)}() reads a "
                    f"REPRO_* flag -- the port has no environment flags")
        if isinstance(node, ast.Subscript) and \
                _dotted(node.value) == "os.environ":
            name = _flag_name(node.slice)
            if _is_flag(name):
                add(node, "raw-env-flag",
                    f"env read of {name!r} -- the port has no environment "
                    f"flags")
        if isinstance(node, ast.ClassDef):
            if _CONFIG_NAME_RE.search(node.name):
                for dec in node.decorator_list:
                    if _terminal_attr(
                            dec if not isinstance(dec, ast.Call)
                            else dec.func) != "dataclass":
                        continue
                    frozen = isinstance(dec, ast.Call) and any(
                        kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in dec.keywords)
                    if not frozen:
                        add(node, "unfrozen-config-dataclass",
                            f"dataclass {node.name!r} looks like "
                            f"jit-static config but is not frozen=True "
                            f"(mutable + unhashable as a static arg)")
    # a node nested in two traced defs is walked once per def — dedupe
    # on (path, line, rule), keeping the innermost def's message
    seen, out = set(), []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if (f.path, f.line, f.rule) not in seen:
            seen.add((f.path, f.line, f.rule))
            out.append(f)
    return out


def lint_paths(paths: Iterable) -> list:
    """Lint every ``.py`` file under the given files/directories."""
    findings = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings
