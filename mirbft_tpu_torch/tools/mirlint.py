"""mirlint: the repo-wide static-analysis plane.

The reference design's core claim is a "single-threaded, deterministic,
non-blocking" state machine whose runs record and replay bit-identically —
and this repo maintains *two* engines (the Python testengine and the C++
``_native/fastengine.cpp`` twin) that must stay in lockstep.  Nothing about
either property is enforced by the type system; historically divergences
were found at runtime by fault choreography.  mirlint enforces the cheap
four-fifths statically, in five passes:

``determinism``
    AST lint over ``statemachine/``, ``processor/`` and ``testengine/``
    flagging nondeterminism sources in engine code: wall-clock reads
    (``time.time``/``time.monotonic``/``datetime.now`` — ``perf_counter``
    is exempt as the blessed interval-metering clock), unseeded randomness
    (module-level ``random`` functions, ``random.Random()`` with no seed,
    ``os.urandom``, ``uuid.uuid1/uuid4``, ``secrets``), ``id()`` used where
    its value can feed ordering or hashing, iteration over ``set`` displays
    feeding ordered outputs, and ``json.dumps`` without ``sort_keys=True``
    across serialization boundaries.

``parity``
    Structural extraction of constants from ``_native/fastengine.cpp`` /
    ``_native/ackplane.cpp`` (message-kind, action-kind, event-kind and
    persist-kind enums, wire tags, ``pdes_envelope[<code>]`` reason codes,
    mangler-DSL opcodes, native result-dict keys) diffed against the Python
    sources of truth (``messages.py``, ``state.py``,
    ``statemachine/actions.py``, ``testengine/fastengine.py``,
    ``testengine/manglers.py``, ``wire.py``).  Drift in either direction is
    a finding.  The metric/span-name rule (formerly
    ``tools/check_metric_names.py``) lives here too.

``locks``
    Lock-discipline lint for the threaded modules.  A module declares a
    module-level literal ``MIRLINT_SHARED_STATE = {"Class.attr":
    "lock_attr", ...}``; every attribute named in the map may only be
    touched lexically inside ``with <lock_attr>:`` or inside ``__init__``.
    Any module that creates a ``threading.Lock/RLock/Condition`` without
    declaring a map (or pragma-ing the creation site) is itself flagged.

``wire``
    Wire-schema drift lint: every dataclass in ``messages.py`` and
    ``state.py`` must be registered in ``wire.py``'s ``_REGISTRY_ORDER``,
    every field annotation must be expressible by the wire codec grammar,
    and (dynamically, on the real tree) a synthesized non-empty instance of
    every registered class must round-trip ``decode(encode(x)) == x`` and
    render every field through ``tools/textmarshal.py``.

``sched``
    Scheduler-path lint over ``processor/``, ``testengine/`` and
    ``node.py``: flags fixed-interval ``time.sleep(<constant>)`` calls
    inside loops (``sleep-poll``).  The one-scheduler contract is
    event-driven — condition waits, queue gets with timeouts, simulated
    events — and a constant-interval polling loop reintroduces exactly
    the latency floor the pipelined schedule removed.  Computed backoffs
    escape; genuinely-needed fixed sleeps take the pragma.

False positives are silenced with a pragma comment on the flagged line or
the line above::

    key = id(envelope)  # mirlint: allow(id-ordering) — identity cache, never ordered

Usage: ``python -m mirbft_tpu_torch.tools.mirlint [--passes a,b] [--json]``.
Exit 1 iff findings; always emits a ``mirlint_findings_total N`` summary
line.  Rule catalog and pragma syntax: docs/STATIC_ANALYSIS.md.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PASSES = ("determinism", "parity", "locks", "wire", "sched")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, pinned to a file and line."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _rel(path: Path, root: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# Pragma allowlist


_PRAGMA = re.compile(r"#\s*mirlint:\s*allow\(([a-z0-9_\-, ]+)\)")


class Pragmas:
    """``# mirlint: allow(<rule>[, <rule>...])`` markers in one file.

    A pragma silences a rule on its own line, or anywhere in the
    contiguous comment block directly above the flagged statement (so a
    multi-line rationale comment can carry it).
    """

    def __init__(self, text: str):
        self._lines: Dict[int, Set[str]] = {}
        self._comment_lines: Set[int] = set()
        for lineno, line in enumerate(text.splitlines(), start=1):
            if line.lstrip().startswith("#"):
                self._comment_lines.add(lineno)
            match = _PRAGMA.search(line)
            if match:
                self._lines[lineno] = {
                    rule.strip() for rule in match.group(1).split(",")
                }

    def allows(self, line: int, rule: str) -> bool:
        if rule in self._lines.get(line, ()):
            return True
        candidate = line - 1
        while candidate in self._comment_lines:
            if rule in self._lines.get(candidate, ()):
                return True
            candidate -= 1
        return False


def _parse(path: Path) -> Tuple[str, ast.Module, Pragmas]:
    text = path.read_text()
    return text, ast.parse(text, filename=str(path)), Pragmas(text)


# ---------------------------------------------------------------------------
# Pass 1: determinism


_ENGINE_DIRS = ("statemachine", "processor", "testengine", "eventlog")

# Dotted wall-clock reads that leak real time into engine code.  Interval
# metering via time.perf_counter/perf_counter_ns is deliberately exempt:
# durations feed metrics, never ordering (docs/STATIC_ANALYSIS.md).
_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.clock_gettime",
    "time.localtime",
    "time.gmtime",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

# Module-level random.* functions drawing from the shared, unseeded RNG.
_GLOBAL_RNG_FNS = {
    "random",
    "randint",
    "randrange",
    "choice",
    "choices",
    "sample",
    "shuffle",
    "uniform",
    "gauss",
    "getrandbits",
    "randbytes",
}

_ENTROPY = {"os.urandom", "uuid.uuid1", "uuid.uuid4"}


class _ImportMap:
    """Resolve names back to the modules they were imported from."""

    def __init__(self, tree: ast.Module):
        self.modules: Dict[str, str] = {}  # alias -> module dotted path
        self.names: Dict[str, str] = {}  # name -> "module.attr"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.modules[alias.asname or alias.name] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.names[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path for a Name/Attribute expression, or None."""
        if isinstance(node, ast.Name):
            if node.id in self.modules:
                return self.modules[node.id]
            if node.id in self.names:
                return self.names[node.id]
            return None
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            if base is None:
                return None
            return f"{base}.{node.attr}"
        return None


def _is_set_expr(node: ast.AST) -> bool:
    """Conservatively: does this expression statically denote a set?"""
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in (
            "set",
            "frozenset",
        ):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
            "union",
            "intersection",
            "difference",
            "symmetric_difference",
        ):
            return _is_set_expr(node.func.value)
        return False
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    ):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class _DeterminismVisitor(ast.NodeVisitor):
    def __init__(self, path: str, imports: _ImportMap, pragmas: Pragmas):
        self.path = path
        self.imports = imports
        self.pragmas = pragmas
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if not self.pragmas.allows(line, rule):
            self.findings.append(Finding(self.path, line, rule, message))

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.imports.resolve(node.func)
        if dotted in _WALL_CLOCK:
            self._flag(
                node,
                "wall-clock",
                f"{dotted}() reads wall-clock time in engine code; thread a "
                "logical clock (or use time.perf_counter for pure interval "
                "metering)",
            )
        elif dotted in _ENTROPY or (dotted or "").startswith("secrets."):
            self._flag(
                node,
                "unseeded-random",
                f"{dotted}() draws OS entropy; engine randomness must come "
                "from a seeded random.Random(seed)",
            )
        elif dotted is not None and dotted.startswith("random."):
            fn = dotted.split(".", 1)[1]
            if fn in _GLOBAL_RNG_FNS:
                self._flag(
                    node,
                    "unseeded-random",
                    f"{dotted}() uses the shared module-level RNG; use a "
                    "seeded random.Random(seed) instance",
                )
            elif fn == "Random" and not node.args and not node.keywords:
                self._flag(
                    node,
                    "unseeded-random",
                    "random.Random() without a seed argument is "
                    "OS-entropy-seeded; pass an explicit seed",
                )
        elif isinstance(node.func, ast.Name):
            if node.func.id == "id":
                self._flag(
                    node,
                    "id-ordering",
                    "id() values are allocation-order-dependent; using them "
                    "in ordering or hashing breaks replay (pragma legitimate "
                    "identity-cache uses)",
                )
            elif (
                node.func.id in ("list", "tuple", "enumerate")
                and node.args
                and _is_set_expr(node.args[0])
            ):
                self._flag(
                    node,
                    "set-iteration",
                    f"{node.func.id}() over a set materializes "
                    "hash-order-dependent sequence; sort first",
                )
        if dotted in ("json.dumps", "json.dump"):
            sort_keys = any(
                kw.arg == "sort_keys"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            if not sort_keys:
                self._flag(
                    node,
                    "dict-serialization",
                    f"{dotted}() without sort_keys=True serializes dict "
                    "insertion order; replay-compared output must be "
                    "canonical",
                )
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and node.args
            and _is_set_expr(node.args[0])
        ):
            self._flag(
                node,
                "set-iteration",
                "str.join over a set produces hash-order-dependent text; "
                "sort first",
            )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._flag(
                node,
                "set-iteration",
                "for-loop over a set display iterates in hash order; "
                "sort first if the loop feeds ordered output",
            )
        self.generic_visit(node)

    def _check_comprehension(self, node: ast.AST) -> None:
        for gen in node.generators:  # type: ignore[attr-defined]
            if _is_set_expr(gen.iter):
                self._flag(
                    node,
                    "set-iteration",
                    "comprehension over a set display iterates in hash "
                    "order; sort first if the result is ordered",
                )
        self.generic_visit(node)

    visit_ListComp = _check_comprehension
    visit_GeneratorExp = _check_comprehension
    visit_DictComp = _check_comprehension


def determinism_pass(
    root: Path, files: Optional[Sequence[Path]] = None
) -> List[Finding]:
    """Rule ids: wall-clock, unseeded-random, id-ordering, set-iteration,
    dict-serialization."""
    if files is None:
        files = []
        for sub in _ENGINE_DIRS:
            files.extend(sorted((root / "mirbft_tpu_torch" / sub).rglob("*.py")))
    findings: List[Finding] = []
    for path in files:
        text, tree, pragmas = _parse(path)
        visitor = _DeterminismVisitor(
            _rel(path, root), _ImportMap(tree), pragmas
        )
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings


# ---------------------------------------------------------------------------
# Pass 2: cross-engine parity


def _cpp_strip_comments(text: str) -> str:
    """Blank out // and /* */ comments, preserving line numbers."""
    text = re.sub(
        r"/\*.*?\*/",
        lambda m: re.sub(r"[^\n]", " ", m.group(0)),
        text,
        flags=re.S,
    )
    return re.sub(r"//[^\n]*", "", text)


def _cpp_enum(text: str, name: str) -> Optional[Tuple[int, List[str]]]:
    """(line, ordered member names) of ``enum [class] <name> ... { ... }``."""
    match = re.search(
        rf"enum\s+(?:class\s+)?{name}\b[^{{]*\{{([^}}]*)\}}", text
    )
    if not match:
        return None
    members = []
    for part in match.group(1).split(","):
        part = part.split("=")[0].strip()
        if part:
            members.append(part)
    return text.count("\n", 0, match.start()) + 1, members


def _union_members(tree: ast.Module, name: str) -> Optional[Tuple[int, List[str]]]:
    """(line, member names) of a module-level ``X = Union[A, B, ...]``."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
            and isinstance(node.value, ast.Subscript)
        ):
            sl = node.value.slice
            if isinstance(sl, ast.Index):  # pragma: no cover (py<3.9)
                sl = sl.value
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            names = [e.id for e in elts if isinstance(e, ast.Name)]
            return node.lineno, names
    return None


def _module_tuple(tree: ast.Module, name: str) -> Optional[Tuple[int, List[str]]]:
    """(line, items) of a module-level literal tuple/list of strings."""
    for node in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for target in targets:
            if isinstance(target, ast.Name) and target.id == name:
                try:
                    items = list(ast.literal_eval(value))
                except (ValueError, TypeError):
                    return None
                return node.lineno, [str(i) for i in items]
    return None


# Known, documented asymmetries between the engines.  ForwardRequest is a
# message class (wire tag 25) but has no native MT code: the native engine
# drops ActionForwardRequest exactly like the reference single-process
# harness (reference work.go:176), so it never serializes one.
PARITY_KNOWN_GAPS = {"ForwardRequest"}

_MT_ALIASES = {"Checkpoint": "CheckpointMsg"}
_AT_ALIASES = {"Hash": "HashRequest"}
_PET_ALIASES = {
    "Q": "QEntry",
    "P": "PEntry",
    "C": "CEntry",
    "N": "NEntry",
    "F": "FEntry",
    "EC": "ECEntry",
    "T": "TEntry",
    "Suspect": "Suspect",
}


def check_msg_kind_parity(
    cpp_path: Path, engine_path: Path, messages_path: Path
) -> List[Finding]:
    """C++ ``enum MT`` positions == ``_mt_codes()`` codes, and the dict
    covers the whole ``Msg`` union (minus PARITY_KNOWN_GAPS)."""
    findings: List[Finding] = []
    rule = "parity-msg-kinds"
    cpp = _cpp_strip_comments(cpp_path.read_text())
    enum = _cpp_enum(cpp, "MT")
    if enum is None:
        return [Finding(str(cpp_path), 1, rule, "enum MT not found")]
    enum_line, members = enum

    _, engine_tree, _ = _parse(engine_path)
    codes: Dict[str, int] = {}
    codes_line = 1
    for node in ast.walk(engine_tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_mt_codes":
            codes_line = node.lineno
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and isinstance(
                    ret.value, ast.Dict
                ):
                    for key, value in zip(ret.value.keys, ret.value.values):
                        if isinstance(key, ast.Attribute) and isinstance(
                            value, ast.Constant
                        ):
                            codes[key.attr] = int(value.value)
    if not codes:
        return [
            Finding(
                str(engine_path), 1, rule, "_mt_codes() dict not found"
            )
        ]
    expected = {
        _MT_ALIASES.get(name, name): code
        for code, name in enumerate(members)
    }
    for name, code in sorted(expected.items()):
        if codes.get(name) != code:
            findings.append(
                Finding(
                    str(engine_path),
                    codes_line,
                    rule,
                    f"_mt_codes() maps {name!r} to {codes.get(name)!r} but "
                    f"C++ enum MT says {code}",
                )
            )
    for name in sorted(set(codes) - set(expected)):
        findings.append(
            Finding(
                str(cpp_path),
                enum_line,
                rule,
                f"_mt_codes() has {name!r} but C++ enum MT does not",
            )
        )

    union = _union_members(ast.parse(messages_path.read_text()), "Msg")
    if union is None:
        findings.append(
            Finding(str(messages_path), 1, rule, "Msg union not found")
        )
        return findings
    union_line, union_names = union
    for name in sorted(set(union_names) - PARITY_KNOWN_GAPS - set(codes)):
        findings.append(
            Finding(
                str(messages_path),
                union_line,
                rule,
                f"Msg union member {name!r} has no native MT code in "
                "_mt_codes() (add it, or list it in "
                "mirlint.PARITY_KNOWN_GAPS with a rationale)",
            )
        )
    for name in sorted(set(codes) - set(union_names)):
        findings.append(
            Finding(
                str(messages_path),
                union_line,
                rule,
                f"_mt_codes() names {name!r} which is not in the Msg union",
            )
        )
    return findings


def _enum_vs_union(
    cpp_path: Path,
    py_path: Path,
    enum_name: str,
    union_name: str,
    strip_prefix: str,
    aliases: Dict[str, str],
    rule: str,
) -> List[Finding]:
    cpp = _cpp_strip_comments(cpp_path.read_text())
    enum = _cpp_enum(cpp, enum_name)
    if enum is None:
        return [
            Finding(str(cpp_path), 1, rule, f"enum {enum_name} not found")
        ]
    enum_line, members = enum
    tree = ast.parse(py_path.read_text())
    union = _union_members(tree, union_name)
    if union is None:
        return [
            Finding(str(py_path), 1, rule, f"{union_name} union not found")
        ]
    union_line, union_names = union
    mapped = {
        strip_prefix + aliases.get(member, member) for member in members
    }
    findings = []
    for name in sorted(set(union_names) - mapped):
        findings.append(
            Finding(
                str(py_path),
                union_line,
                rule,
                f"{union_name} union member {name!r} has no C++ "
                f"{enum_name} enum member",
            )
        )
    for name in sorted(mapped - set(union_names)):
        findings.append(
            Finding(
                str(cpp_path),
                enum_line,
                rule,
                f"C++ {enum_name} member for {name!r} has no "
                f"{union_name} union member in {py_path.name}",
            )
        )
    return findings


def check_action_event_parity(
    cpp_path: Path, state_path: Path, actions_path: Path
) -> List[Finding]:
    """C++ AT/ET enums == state.py Action/Event unions; every s.ActionX /
    s.EventX the fluent builders reference must exist in the unions."""
    findings = _enum_vs_union(
        cpp_path,
        state_path,
        "AT",
        "Action",
        "Action",
        _AT_ALIASES,
        "parity-action-kinds",
    )
    findings += _enum_vs_union(
        cpp_path,
        state_path,
        "ET",
        "Event",
        "Event",
        {},
        "parity-event-kinds",
    )
    state_tree = ast.parse(state_path.read_text())
    known: Set[str] = set()
    for union_name in ("Action", "Event"):
        union = _union_members(state_tree, union_name)
        if union:
            known.update(union[1])
    _, actions_tree, _ = _parse(actions_path)
    for node in ast.walk(actions_tree):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("s", "st")
            and (
                node.attr.startswith("Action")
                or node.attr.startswith("Event")
            )
            and node.attr not in ("Action", "Event")
            and node.attr not in known
        ):
            findings.append(
                Finding(
                    str(actions_path),
                    node.lineno,
                    "parity-action-kinds",
                    f"builder references state.{node.attr} which is not in "
                    "the Action/Event unions",
                )
            )
    return findings


def check_persist_parity(
    cpp_path: Path, messages_path: Path
) -> List[Finding]:
    """C++ ``enum PET`` == messages.py ``Persistent`` union."""
    return _enum_vs_union(
        cpp_path,
        messages_path,
        "PET",
        "Persistent",
        "",
        _PET_ALIASES,
        "parity-persist-kinds",
    )


def check_wire_tag_parity(cpp_path: Path, wire_path: Path) -> List[Finding]:
    """Every C++ ``TAG_<Name> = <n>`` must be <Name> at index n of
    wire.py ``_REGISTRY_ORDER`` (C++ declares a subset: only what the
    native engines serialize)."""
    rule = "parity-wire-tags"
    findings: List[Finding] = []
    cpp = _cpp_strip_comments(cpp_path.read_text())
    tags = [
        (
            cpp.count("\n", 0, m.start()) + 1,
            m.group(1),
            int(m.group(2)),
        )
        for m in re.finditer(r"\bTAG_(\w+)\s*=\s*(\d+)", cpp)
    ]
    if not tags:
        return [Finding(str(cpp_path), 1, rule, "no TAG_* constants found")]
    order = _registry_names(ast.parse(wire_path.read_text()))
    if not order:
        return [
            Finding(str(wire_path), 1, rule, "_REGISTRY_ORDER not found")
        ]
    for line, name, value in tags:
        actual = order[value] if 0 <= value < len(order) else None
        if actual != name:
            findings.append(
                Finding(
                    str(cpp_path),
                    line,
                    rule,
                    f"TAG_{name} = {value} but _REGISTRY_ORDER[{value}] is "
                    f"{actual!r} in {wire_path.name}",
                )
            )
    return findings


_CPP_ENVELOPE = re.compile(r"pdes_envelope\[([a-z_]+)\]")


def check_envelope_parity(cpp_path: Path, py_path: Path) -> List[Finding]:
    """``pdes_envelope[<code>]`` literals in the C++ engine and the
    ``PDES_ENVELOPE_REASONS`` tuple in testengine/fastengine.py must be
    exactly the same set, both directions."""
    rule = "parity-envelope-reasons"
    cpp_text = _cpp_strip_comments(cpp_path.read_text())
    cpp_codes: Dict[str, int] = {}
    for match in _CPP_ENVELOPE.finditer(cpp_text):
        cpp_codes.setdefault(
            match.group(1), cpp_text.count("\n", 0, match.start()) + 1
        )
    py_tree = ast.parse(py_path.read_text())
    declared = _module_tuple(py_tree, "PDES_ENVELOPE_REASONS")
    if declared is None:
        return [
            Finding(
                str(py_path),
                1,
                rule,
                "PDES_ENVELOPE_REASONS tuple not found (the Python source "
                "of truth for pdes_envelope[<code>] reason codes)",
            )
        ]
    py_line, py_codes = declared
    findings = []
    for code in sorted(set(cpp_codes) - set(py_codes)):
        findings.append(
            Finding(
                str(cpp_path),
                cpp_codes[code],
                rule,
                f"pdes_envelope[{code}] emitted by the native engine but "
                f"missing from PDES_ENVELOPE_REASONS in {py_path.name}",
            )
        )
    for code in sorted(set(py_codes) - set(cpp_codes)):
        findings.append(
            Finding(
                str(py_path),
                py_line,
                rule,
                f"PDES_ENVELOPE_REASONS lists {code!r} but the native "
                "engine never emits it",
            )
        )
    return findings


def _compare_literals(tree: ast.Module, var_name: str) -> Set[str]:
    """String constants compared against a bare name, e.g. the string set
    S in ``kind in ("a", "b")`` / ``kind == "c"`` for var_name="kind"."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        if not (
            isinstance(node.left, ast.Name) and node.left.id == var_name
        ):
            continue
        for comparator in node.comparators:
            if isinstance(comparator, ast.Constant) and isinstance(
                comparator.value, str
            ):
                out.add(comparator.value)
            elif isinstance(comparator, (ast.Tuple, ast.List)):
                for elt in comparator.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        out.add(elt.value)
    return out


def check_mangler_parity(
    cpp_path: Path, engine_path: Path, manglers_path: Path
) -> List[Finding]:
    """The mangler-DSL opcode vocabulary (descriptor kinds, wrap
    combinators, predicate kinds, action kinds) must match between the
    C++ descriptor parser and the Python compiler/DSL."""
    rule = "parity-mangler-ops"
    findings: List[Finding] = []
    cpp = _cpp_strip_comments(cpp_path.read_text())

    def cpp_set(var: str) -> Set[str]:
        return set(re.findall(rf'\b{var}\s*==\s*"([a-z_]+)"', cpp))

    _, engine_tree, _ = _parse(engine_path)
    compile_fn = None
    for node in ast.walk(engine_tree):
        if (
            isinstance(node, ast.FunctionDef)
            and node.name == "_compile_mangler"
        ):
            compile_fn = node
    if compile_fn is None:
        return [
            Finding(
                str(engine_path), 1, rule, "_compile_mangler() not found"
            )
        ]
    fn_tree = ast.Module(body=[compile_fn], type_ignores=[])
    py_preds = _compare_literals(fn_tree, "kind")
    py_actions = _compare_literals(fn_tree, "action")
    py_descriptors: Set[str] = set()
    for node in ast.walk(compile_fn):
        if isinstance(node, ast.Return) and isinstance(
            node.value, ast.Tuple
        ):
            first = node.value.elts[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                py_descriptors.add(first.value)
    manglers_tree = ast.parse(manglers_path.read_text())
    py_wraps: Set[str] = set()
    for node in ast.walk(manglers_tree):
        if (
            isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Attribute)
            and node.left.attr == "wrap"
        ):
            for comparator in node.comparators:
                if isinstance(comparator, ast.Constant) and isinstance(
                    comparator.value, str
                ):
                    py_wraps.add(comparator.value)

    pairs = [
        ("predicate kind", cpp_set("pk"), py_preds, engine_path),
        ("action kind", cpp_set("act"), py_actions, engine_path),
        ("descriptor kind", cpp_set("kind"), py_descriptors, engine_path),
        ("wrap combinator", cpp_set("wrap"), py_wraps, manglers_path),
    ]
    for label, cpp_vocab, py_vocab, py_src in pairs:
        for item in sorted(cpp_vocab - py_vocab):
            findings.append(
                Finding(
                    str(py_src),
                    1,
                    rule,
                    f"C++ mangler {label} {item!r} has no Python "
                    f"counterpart in {py_src.name}",
                )
            )
        for item in sorted(py_vocab - cpp_vocab):
            findings.append(
                Finding(
                    str(cpp_path),
                    1,
                    rule,
                    f"Python mangler {label} {item!r} is not handled by "
                    "the C++ descriptor parser",
                )
            )
    return findings


def check_native_key_parity(
    cpp_paths: Sequence[Path], engine_path: Path
) -> List[Finding]:
    """Every string key the Python wrapper reads off a native result dict
    (``res["steps"]``, ``stats["barrier_ns"]``, ...) must appear as a
    string literal in the native sources — catches silent key renames."""
    rule = "parity-native-keys"
    literals: Set[str] = set()
    for cpp_path in cpp_paths:
        if cpp_path.exists():
            literals.update(
                re.findall(
                    r'"([a-z][a-z0-9_]*)"',
                    _cpp_strip_comments(cpp_path.read_text()),
                )
            )
    findings: List[Finding] = []
    _, tree, _ = _parse(engine_path)
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            key = node.slice.value
            if key not in literals:
                findings.append(
                    Finding(
                        str(engine_path),
                        node.lineno,
                        rule,
                        f"wrapper reads native result key {key!r} which no "
                        "native source emits",
                    )
                )
    return findings


# --- metric/span name rule (folded from tools/check_metric_names.py) ------

_METRIC_CALL = re.compile(
    r"\.(?:counter|gauge|histogram|timer)\(\s*\"([^\"]+)\"", re.MULTILINE
)
_SPAN_CALL = re.compile(
    r"\.(?:span|complete|instant|counter_event)\(\s*\n?\s*\"([^\"]+)\"",
    re.MULTILINE,
)
_SNAKE_CASE = re.compile(r"^[a-z][a-z0-9_]*$")
_KIND_TUPLE = re.compile(
    r"^(ANOMALY_KINDS|FAULT_KINDS)\s*=\s*\(([^)]*)\)", re.MULTILINE
)
_KIND_ITEM = re.compile(r"\"([^\"]+)\"")

# Phase instruments that MUST exist somewhere in the tree: the
# pack/dispatch split is load-bearing for perf triage
# (docs/PERFORMANCE.md "Dispatch-path anatomy"), so losing one of these
# in a refactor fails the lint even though the name checks above only
# validate names still present.
REQUIRED_METRIC_NAMES = (
    "hash_pack_seconds",
    "hash_device_dispatch_seconds",
    "verify_pack_seconds",
    "verify_device_dispatch_seconds",
    "mesh_hash_dispatches",
    "mesh_hashed_messages",
    # Socket transport plane (net/tcp.py, docs/TRANSPORT.md).
    "net_tx_bytes_total",
    "net_rx_bytes_total",
    "net_tx_dropped_total",
    "net_reconnects_total",
    "net_peer_queue_depth",
    "net_peer_up",
    # Fused device pipeline (ops/fused.py) + adaptive wave sizing
    # + cross-group wave multiplexer (testengine/crypto.py SharedWaveMux).
    "fused_wave_dispatches",
    "fused_wave_messages",
    "hash_wave_autotune_size",
    "fused_wave_occupancy",
    "wave_mux_groups_per_wave",
    "wave_mux_rows_total",
    # Fault-injection plane (net/faults.py, docs/FAULTS.md).
    "net_faults_injected_total",
    "net_frames_corrupted_total",
    "scenario_verdict",
    # Conservative-PDES run stats (testengine/fastengine.py).
    "pdes_windows_total",
    "pdes_barrier_seconds",
    "pdes_partition_imbalance",
    # Group-commit storage engine (storage/, docs/STORAGE.md).
    "wal_append_bytes_total",
    "wal_fsync_seconds",
    "wal_group_commit_size",
    "store_gc_reclaimed_bytes_total",
    "snapshot_transfer_bytes_total",
    # Pipeline scheduler (processor/pipeline.py, docs/PERFORMANCE.md §14)
    # and the shared stage graph + depth autotuner (§15).
    "pipeline_depth",
    "pipeline_stall_seconds",
    "admission_window_size",
    "pipeline_depth_limit",
    "pipeline_autotune_adjustments_total",
    # Sharding plane: router + log-ship feed + observer/learner
    # (groups/, docs/SHARDING.md).
    "group_commits_total",
    "router_redirects_total",
    "observer_lag_batches",
    # Elastic resharding (groups/reshard.py, docs/SHARDING.md
    # "Elastic resharding").
    "reshard_state",
    "map_version",
    "reshard_cutover_seconds",
    "router_stale_map_redirects_total",
    # Fleet observability plane (fleet.py, net/telemetry.py,
    # docs/OBSERVABILITY.md "Fleet plane").
    "net_send_lock_wait_seconds",
    "fleet_pulls_total",
    "fleet_pull_seconds",
    "fleet_clock_offset_us",
    "fleet_trace_events_total",
    "fleet_trace_dropped_total",
    "trace_bindings_total",
    # Flight recorder plane (eventlog/journal.py, eventlog/incident.py,
    # docs/OBSERVABILITY.md "Flight recorder").
    "eventlog_dropped_events_total",
    "eventlog_bytes_total",
    "flight_recorder_captures_total",
)


def _collect_metric_names(root: Path) -> Dict[str, List[Tuple[str, int]]]:
    """{name: [(relpath, line), ...]} for every literal metric/span name
    under mirbft_tpu_torch/ and bench.py (this lint and the shim excluded)."""
    sources = [p for p in (root / "mirbft_tpu_torch").rglob("*.py")]
    bench = root / "bench.py"
    if bench.exists():
        sources.append(bench)
    out: Dict[str, List[Tuple[str, int]]] = {}
    for path in sources:
        if path.name in ("check_metric_names.py", "mirlint.py"):
            continue
        text = path.read_text()
        for pattern in (_METRIC_CALL, _SPAN_CALL):
            for match in pattern.finditer(text):
                line = text.count("\n", 0, match.start()) + 1
                out.setdefault(match.group(1), []).append(
                    (_rel(path, root), line)
                )
    return out


def _collect_kind_names(root: Path) -> Dict[str, List[Tuple[str, int]]]:
    text = (root / "mirbft_tpu_torch" / "health.py").read_text()
    out: Dict[str, List[Tuple[str, int]]] = {}
    for match in _KIND_TUPLE.finditer(text):
        line = text.count("\n", 0, match.start()) + 1
        for item in _KIND_ITEM.finditer(match.group(2)):
            out.setdefault(item.group(1), []).append(
                ("mirbft_tpu_torch/health.py", line)
            )
    return out


def check_metric_names(root: Path) -> List[Finding]:
    """Every instrument/span/kind name must be snake_case and documented
    in docs/OBSERVABILITY.md; REQUIRED_METRIC_NAMES must all still be
    emitted somewhere."""
    rule = "metric-names"
    docs = (root / "docs" / "OBSERVABILITY.md").read_text()
    findings: List[Finding] = []
    kinds = _collect_kind_names(root)
    if not kinds:
        findings.append(
            Finding(
                "mirbft_tpu_torch/health.py",
                1,
                rule,
                "no anomaly/fault kinds found (ANOMALY_KINDS/FAULT_KINDS "
                "tuples moved or renamed?)",
            )
        )
    named = _collect_metric_names(root)
    for kind, sites in kinds.items():
        named.setdefault(kind, []).extend(sites)
    for required in REQUIRED_METRIC_NAMES:
        if required not in named:
            findings.append(
                Finding(
                    "mirbft_tpu_torch",
                    0,
                    rule,
                    f"required dispatch-path instrument {required!r} is no "
                    "longer emitted anywhere under mirbft_tpu_torch/ or bench.py",
                )
            )
    for name, sites in sorted(named.items()):
        path, line = sites[0]
        if not _SNAKE_CASE.match(name):
            findings.append(
                Finding(
                    path,
                    line,
                    rule,
                    f"metric/span/kind name {name!r} is not snake_case",
                )
            )
        if f"`{name}`" not in docs:
            findings.append(
                Finding(
                    path,
                    line,
                    rule,
                    f"metric/span/kind name {name!r} is not documented in "
                    "docs/OBSERVABILITY.md",
                )
            )
    return findings


def parity_pass(root: Path) -> List[Finding]:
    """Rule ids: parity-msg-kinds, parity-action-kinds, parity-event-kinds,
    parity-persist-kinds, parity-wire-tags, parity-envelope-reasons,
    parity-mangler-ops, parity-native-keys, metric-names."""
    pkg = root / "mirbft_tpu_torch"
    cpp = pkg / "_native" / "fastengine.cpp"
    ackplane = pkg / "_native" / "ackplane.cpp"
    engine = pkg / "testengine" / "fastengine.py"
    findings: List[Finding] = []
    findings += check_msg_kind_parity(cpp, engine, pkg / "messages.py")
    findings += check_action_event_parity(
        cpp, pkg / "state.py", pkg / "statemachine" / "actions.py"
    )
    findings += check_persist_parity(cpp, pkg / "messages.py")
    findings += check_wire_tag_parity(cpp, pkg / "wire.py")
    findings += check_envelope_parity(cpp, engine)
    findings += check_mangler_parity(
        cpp, engine, pkg / "testengine" / "manglers.py"
    )
    findings += check_native_key_parity([cpp, ackplane], engine)
    findings += check_metric_names(root)
    # Pin findings to repo-relative paths for stable output.
    return [
        dataclasses.replace(f, path=_rel(Path(f.path), root))
        for f in findings
    ]


# ---------------------------------------------------------------------------
# Pass 3: lock discipline


_LOCK_FACTORIES = ("Lock", "RLock", "Condition")


def _shared_state_map(
    tree: ast.Module,
) -> Optional[Dict[str, str]]:
    """The module's ``MIRLINT_SHARED_STATE`` literal, or None."""
    decl = None
    for node in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for target in targets:
            if (
                isinstance(target, ast.Name)
                and target.id == "MIRLINT_SHARED_STATE"
            ):
                decl = ast.literal_eval(value)
    if decl is None:
        return None
    return {str(k): str(v) for k, v in decl.items()}


def _final_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class _LockWalker(ast.NodeVisitor):
    """Checks every access to a declared shared attribute for an enclosing
    ``with <lock>`` (lexically) or an enclosing ``__init__``."""

    def __init__(
        self,
        path: str,
        attr_locks: Dict[str, str],
        pragmas: Pragmas,
    ):
        self.path = path
        self.attr_locks = attr_locks
        self.pragmas = pragmas
        self.held: List[str] = []
        self.init_depth = 0
        self.findings: List[Finding] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        is_init = node.name == "__init__"
        if is_init:
            self.init_depth += 1
        self.generic_visit(node)
        if is_init:
            self.init_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            # The context expression itself runs before the lock is held.
            self.visit(item.context_expr)
            name = _final_name(item.context_expr)
            if name:
                acquired.append(name)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        lock = self.attr_locks.get(node.attr)
        if (
            lock is not None
            and self.init_depth == 0
            and lock not in self.held
            and not self.pragmas.allows(node.lineno, "lock-discipline")
        ):
            self.findings.append(
                Finding(
                    self.path,
                    node.lineno,
                    "lock-discipline",
                    f"shared attribute .{node.attr} (declared in "
                    "MIRLINT_SHARED_STATE) accessed outside "
                    f"`with <{lock}>:` and outside __init__",
                )
            )
        self.generic_visit(node)


def locks_pass(
    root: Path, files: Optional[Sequence[Path]] = None
) -> List[Finding]:
    """Rule ids: lock-discipline, lock-map.

    lock-map fires on any ``threading.Lock/RLock/Condition()`` creation in
    a module with no MIRLINT_SHARED_STATE declaration (pragma the creation
    line when lock-free access is intentional and documented)."""
    if files is None:
        files = sorted((root / "mirbft_tpu_torch").rglob("*.py"))
    findings: List[Finding] = []
    for path in files:
        text, tree, pragmas = _parse(path)
        rel = _rel(path, root)
        imports = _ImportMap(tree)
        declared = _shared_state_map(tree)
        creations = [
            node
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and imports.resolve(node.func)
            in tuple(f"threading.{n}" for n in _LOCK_FACTORIES)
        ]
        if declared is None:
            for node in creations:
                if not pragmas.allows(node.lineno, "lock-map"):
                    findings.append(
                        Finding(
                            rel,
                            node.lineno,
                            "lock-map",
                            f"{imports.resolve(node.func)}() created but "
                            "module declares no MIRLINT_SHARED_STATE map "
                            "(declare the guarded attributes, or pragma "
                            "this line with a rationale)",
                        )
                    )
            continue
        attr_locks = {
            key.rsplit(".", 1)[-1]: lock for key, lock in declared.items()
        }
        walker = _LockWalker(rel, attr_locks, pragmas)
        walker.visit(tree)
        findings.extend(walker.findings)
    return findings


# ---------------------------------------------------------------------------
# Pass 4: wire-schema drift


_WIRE_SCALARS = {"int", "bool", "bytes", "str"}


def _annotation_ok(node: ast.expr, known_classes: Set[str]) -> bool:
    """Does this annotation fit the wire codec grammar
    (int|bool|bytes|str|dataclass|Tuple[X,...]|Optional[X]|Union[...])?"""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(node, ast.Name):
        return node.id in _WIRE_SCALARS or node.id in known_classes
    if isinstance(node, ast.Attribute):
        return node.attr in known_classes
    if isinstance(node, ast.Subscript):
        head = node.value
        if not isinstance(head, ast.Name) or head.id not in (
            "Tuple",
            "Optional",
            "Union",
        ):
            return False
        sl = node.slice
        if isinstance(sl, ast.Index):  # pragma: no cover (py<3.9)
            sl = sl.value
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for elt in elts:
            if isinstance(elt, ast.Constant) and elt.value is Ellipsis:
                continue
            if isinstance(elt, ast.Constant) and elt.value is None:
                continue
            if not _annotation_ok(elt, known_classes):
                return False
        return True
    return False


def _union_aliases(tree: ast.Module) -> Set[str]:
    """Module-level ``X = Union[...]`` / ``X = Optional[...]`` aliases —
    valid leaf annotations for the wire codec grammar."""
    out: Set[str] = set()
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Subscript)
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id in ("Union", "Optional")
        ):
            out.add(node.targets[0].id)
    return out


def _dataclasses_of(tree: ast.Module) -> List[ast.ClassDef]:
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for deco in node.decorator_list:
                target = deco.func if isinstance(deco, ast.Call) else deco
                name = (
                    target.id
                    if isinstance(target, ast.Name)
                    else getattr(target, "attr", None)
                )
                if name == "dataclass":
                    out.append(node)
    return out


def _registry_names(wire_tree: ast.Module) -> List[str]:
    for node in wire_tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if (
            isinstance(target, ast.Name)
            and target.id == "_REGISTRY_ORDER"
            and isinstance(node.value, ast.List)
        ):
            return [
                e.attr if isinstance(e, ast.Attribute) else getattr(e, "id", "?")
                for e in node.value.elts
            ]
    return []


def wire_static_pass(
    messages_path: Path, state_path: Path, wire_path: Path
) -> List[Finding]:
    """Rule ids: wire-registry, wire-annotation."""
    findings: List[Finding] = []
    registry = _registry_names(ast.parse(wire_path.read_text()))
    if not registry:
        return [
            Finding(
                str(wire_path),
                1,
                "wire-registry",
                "_REGISTRY_ORDER not found",
            )
        ]
    known: Set[str] = set(registry)
    for src in (messages_path, state_path):
        tree = ast.parse(src.read_text())
        known.update(_union_aliases(tree))
        for cls in _dataclasses_of(tree):
            known.add(cls.name)
    for src in (messages_path, state_path):
        tree = ast.parse(src.read_text())
        for cls in _dataclasses_of(tree):
            if cls.name not in registry:
                findings.append(
                    Finding(
                        str(src),
                        cls.lineno,
                        "wire-registry",
                        f"dataclass {cls.name} is not registered in "
                        f"{wire_path.name} _REGISTRY_ORDER (its instances "
                        "cannot be recorded or replayed)",
                    )
                )
            for stmt in cls.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    if not _annotation_ok(stmt.annotation, known):
                        findings.append(
                            Finding(
                                str(src),
                                stmt.lineno,
                                "wire-annotation",
                                f"{cls.name}.{stmt.target.id} annotation is "
                                "outside the wire codec grammar "
                                "(int/bool/bytes/str/dataclass/Tuple/"
                                "Optional/Union)",
                            )
                        )
    return findings


def _synthesize(cls: type, depth: int = 0) -> object:
    """A non-empty instance of a registered dataclass, recursively."""
    import typing

    if depth > 6:
        raise RecursionError(f"synthesis depth exceeded at {cls.__name__}")
    hints = typing.get_type_hints(cls)
    values = {}
    for field in dataclasses.fields(cls):
        values[field.name] = _synth_value(hints[field.name], depth)
    return cls(**values)


def _synth_value(tp: object, depth: int) -> object:
    import typing

    if tp is int:
        return 1
    if tp is bool:
        return True
    if tp is bytes:
        return b"\x01"
    if tp is str:
        return "x"
    origin = typing.get_origin(tp)
    if origin is tuple:
        (elem, *_rest) = typing.get_args(tp)
        return (_synth_value(elem, depth + 1),)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _synth_value(args[0], depth + 1)
    if dataclasses.is_dataclass(tp):
        return _synthesize(tp, depth + 1)  # type: ignore[arg-type]
    raise TypeError(f"cannot synthesize {tp!r}")


def wire_dynamic_pass() -> List[Finding]:
    """Rule id: wire-roundtrip.  Imports the real package: every class in
    wire._REGISTRY_ORDER must round-trip encode/decode on a synthesized
    non-empty instance, and tools/textmarshal.compact_text must render
    every field name."""
    from .. import wire
    from . import textmarshal

    findings: List[Finding] = []
    for tag, cls in enumerate(wire._REGISTRY_ORDER):
        where = f"mirbft_tpu_torch/{cls.__module__.rsplit('.', 1)[-1]}.py"
        try:
            obj = _synthesize(cls)
        except Exception as exc:  # noqa: BLE001 — report, don't crash lint
            findings.append(
                Finding(
                    where,
                    0,
                    "wire-roundtrip",
                    f"cannot synthesize {cls.__name__}: {exc}",
                )
            )
            continue
        try:
            back = wire.decode(wire.encode(obj))
        except Exception as exc:  # noqa: BLE001
            findings.append(
                Finding(
                    where,
                    0,
                    "wire-roundtrip",
                    f"{cls.__name__} (tag {tag}) failed encode/decode: "
                    f"{exc}",
                )
            )
            continue
        if back != obj:
            findings.append(
                Finding(
                    where,
                    0,
                    "wire-roundtrip",
                    f"{cls.__name__} (tag {tag}) round-trip is lossy: "
                    f"{obj!r} != {back!r}",
                )
            )
            continue
        text = textmarshal.compact_text(obj)
        for field in dataclasses.fields(cls):
            if f"{field.name}=" not in text:
                findings.append(
                    Finding(
                        where,
                        0,
                        "wire-roundtrip",
                        f"{cls.__name__}.{field.name} is dropped by the "
                        "textmarshal path (compact_text)",
                    )
                )
    return findings


def check_frame_subtypes(ship_module=None) -> List[Finding]:
    """Rule id: frame-subtype.  The KIND_GROUP subframe registry
    (groups/ship.py) must stay in lockstep with its SHIP_*/MAP_*
    constants: every constant named and unique, every registered subtype
    covered by :func:`sample_payloads`, and every sample decoding back to
    its own subtype and re-encoding byte-identically.

    ``ship_module`` is injectable for tests; default is the real module.
    """
    if ship_module is None:
        from ..groups import ship as ship_module

    where = "mirbft_tpu_torch/groups/ship.py"
    findings: List[Finding] = []

    def flag(message: str) -> None:
        findings.append(Finding(where, 0, "frame-subtype", message))

    names = getattr(ship_module, "SUBTYPE_NAMES", None)
    if not isinstance(names, dict) or not names:
        flag("SUBTYPE_NAMES registry is missing or empty")
        return findings

    constants = {
        attr: value
        for attr, value in vars(ship_module).items()
        if attr.startswith(("SHIP_", "MAP_", "RESHARD_"))
        and isinstance(value, int)
    }
    for attr, value in sorted(constants.items()):
        if value not in names:
            flag(f"{attr} = {value} is not registered in SUBTYPE_NAMES")
    for value in sorted(names):
        if value not in constants.values():
            flag(
                f"SUBTYPE_NAMES[{value}] has no matching "
                "SHIP_*/MAP_*/RESHARD_* constant"
            )
    if len(set(constants.values())) != len(constants):
        flag(f"duplicate subtype values in {sorted(constants.items())}")
    seen_names: Dict[str, int] = {}
    for value, name in names.items():
        if not _SNAKE_CASE.match(name):
            flag(f"subtype name {name!r} is not snake_case")
        if name in seen_names:
            flag(f"subtype name {name!r} used by {seen_names[name]} and {value}")
        seen_names[name] = value

    try:
        samples = ship_module.sample_payloads()
    except Exception as exc:  # noqa: BLE001 — report, don't crash lint
        flag(f"sample_payloads() raised: {exc}")
        return findings
    for value, name in sorted(names.items()):
        if value not in samples:
            flag(f"sample_payloads() does not cover {name} ({value})")
    for value, payload in sorted(samples.items()):
        try:
            subtype, group_id, seq, body = ship_module.decode(payload)
        except Exception as exc:  # noqa: BLE001
            flag(f"sample for subtype {value} does not decode: {exc}")
            continue
        if subtype != value:
            flag(
                f"sample registered under subtype {value} decodes as "
                f"{subtype}"
            )
            continue
        if ship_module.encode(subtype, group_id, seq, body) != payload:
            flag(f"subtype {value} re-encode is not byte-identical")
    return findings


def check_telemetry_subtypes(telemetry_module=None) -> List[Finding]:
    """Rule id: telemetry-subtype.  The KIND_TELEMETRY registry
    (net/telemetry.py) mirrors the frame-subtype contract: every TEL_*
    constant named and unique in SUBTYPE_NAMES, every registered subtype
    covered by :func:`sample_payloads`, and every sample decoding back to
    its own subtype and re-encoding byte-identically through the 4-tuple
    ``(subtype, node_id, clock_us, body)`` codec.

    ``telemetry_module`` is injectable for tests; default is the real
    module.
    """
    if telemetry_module is None:
        from ..net import telemetry as telemetry_module

    where = "mirbft_tpu_torch/net/telemetry.py"
    findings: List[Finding] = []

    def flag(message: str) -> None:
        findings.append(Finding(where, 0, "telemetry-subtype", message))

    names = getattr(telemetry_module, "SUBTYPE_NAMES", None)
    if not isinstance(names, dict) or not names:
        flag("SUBTYPE_NAMES registry is missing or empty")
        return findings

    constants = {
        attr: value
        for attr, value in vars(telemetry_module).items()
        if attr.startswith("TEL_") and isinstance(value, int)
    }
    for attr, value in sorted(constants.items()):
        if value not in names:
            flag(f"{attr} = {value} is not registered in SUBTYPE_NAMES")
    for value in sorted(names):
        if value not in constants.values():
            flag(f"SUBTYPE_NAMES[{value}] has no matching TEL_* constant")
    if len(set(constants.values())) != len(constants):
        flag(f"duplicate subtype values in {sorted(constants.items())}")
    seen_names: Dict[str, int] = {}
    for value, name in names.items():
        if not _SNAKE_CASE.match(name):
            flag(f"subtype name {name!r} is not snake_case")
        if name in seen_names:
            flag(f"subtype name {name!r} used by {seen_names[name]} and {value}")
        seen_names[name] = value

    try:
        samples = telemetry_module.sample_payloads()
    except Exception as exc:  # noqa: BLE001 — report, don't crash lint
        flag(f"sample_payloads() raised: {exc}")
        return findings
    for value, name in sorted(names.items()):
        if value not in samples:
            flag(f"sample_payloads() does not cover {name} ({value})")
    for value, payload in sorted(samples.items()):
        try:
            subtype, node_id, clock_us, body = telemetry_module.decode(payload)
        except Exception as exc:  # noqa: BLE001
            flag(f"sample for subtype {value} does not decode: {exc}")
            continue
        if subtype != value:
            flag(
                f"sample registered under subtype {value} decodes as "
                f"{subtype}"
            )
            continue
        if telemetry_module.encode(subtype, node_id, clock_us, body) != payload:
            flag(f"subtype {value} re-encode is not byte-identical")
    return findings


def check_incident_manifest(incident_module=None) -> List[Finding]:
    """Rule id: incident-manifest.  The incident-bundle ``manifest.json``
    schema (eventlog/incident.py MANIFEST_KEYS) is a wire contract
    between the capture side (``AnomalyCapture``/``capture_incident``)
    and the readers (``replay_incident``, ``mircat --incident``): every
    key named once, snake_case, sorted (capture writes with
    ``sort_keys=True``, so the declared tuple is the on-disk order), and
    :func:`sample_manifest` producing exactly those keys — a key added
    on one side without the other breaks replay of archived bundles.

    ``incident_module`` is injectable for tests; default is the real
    module.
    """
    if incident_module is None:
        from ..eventlog import incident as incident_module

    where = "mirbft_tpu_torch/eventlog/incident.py"
    findings: List[Finding] = []

    def flag(message: str) -> None:
        findings.append(Finding(where, 0, "incident-manifest", message))

    keys = getattr(incident_module, "MANIFEST_KEYS", None)
    if not isinstance(keys, tuple) or not keys:
        flag("MANIFEST_KEYS registry is missing or empty")
        return findings
    if len(set(keys)) != len(keys):
        flag(f"duplicate manifest keys in {keys}")
    if list(keys) != sorted(keys):
        flag(
            "MANIFEST_KEYS is not sorted; capture writes sort_keys=True, "
            "so the declared order must match the on-disk order"
        )
    for key in keys:
        if not _SNAKE_CASE.match(key):
            flag(f"manifest key {key!r} is not snake_case")

    try:
        sample = incident_module.sample_manifest()
    except Exception as exc:  # noqa: BLE001 — report, don't crash lint
        flag(f"sample_manifest() raised: {exc}")
        return findings
    if not isinstance(sample, dict):
        flag(f"sample_manifest() returned {type(sample).__name__}, not dict")
        return findings
    missing = sorted(set(keys) - set(sample))
    extra = sorted(set(sample) - set(keys))
    if missing:
        flag(f"sample_manifest() lacks declared keys {missing}")
    if extra:
        flag(
            f"sample_manifest() emits undeclared keys {extra} — add them "
            "to MANIFEST_KEYS so the mircat/replay readers stay in lockstep"
        )
    return findings


def wire_pass(root: Path) -> List[Finding]:
    pkg = root / "mirbft_tpu_torch"
    findings = wire_static_pass(
        pkg / "messages.py", pkg / "state.py", pkg / "wire.py"
    )
    findings = [
        dataclasses.replace(f, path=_rel(Path(f.path), root))
        for f in findings
    ]
    if root == repo_root():
        findings += wire_dynamic_pass()
        findings += check_frame_subtypes()
        findings += check_telemetry_subtypes()
        findings += check_incident_manifest()
    return findings


# ---------------------------------------------------------------------------
# Pass 5: scheduler paths


class _SleepPollVisitor(ast.NodeVisitor):
    """Flags ``time.sleep(<numeric constant>)`` inside a loop body.

    Only constant intervals are flagged: a computed argument (adaptive
    backoff, a deadline remainder) is already event-shaped.  Condition
    waits and queue gets with timeouts never match — they wake early on
    the event, which is the whole point."""

    def __init__(self, path: str, imports: _ImportMap, pragmas: Pragmas):
        self.path = path
        self.imports = imports
        self.pragmas = pragmas
        self.findings: List[Finding] = []
        self._loop_depth = 0

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if not self.pragmas.allows(line, rule):
            self.findings.append(Finding(self.path, line, rule, message))

    def _visit_loop(self, node: ast.AST) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = _visit_loop
    visit_For = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        if (
            self._loop_depth > 0
            and self.imports.resolve(node.func) == "time.sleep"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, (int, float))
        ):
            self._flag(
                node,
                "sleep-poll",
                "fixed-interval time.sleep in a scheduler-path loop polls "
                "at a latency floor; wait on the event instead (condition "
                "wait, queue get with timeout, or a scheduled sim event)",
            )
        self.generic_visit(node)


def sched_pass(
    root: Path, files: Optional[Sequence[Path]] = None
) -> List[Finding]:
    """Rule ids: sleep-poll."""
    if files is None:
        files = []
        for sub in ("processor", "testengine", "groups"):
            files.extend(sorted((root / "mirbft_tpu_torch" / sub).rglob("*.py")))
        files.append(root / "mirbft_tpu_torch" / "node.py")
    findings: List[Finding] = []
    for path in files:
        text, tree, pragmas = _parse(path)
        visitor = _SleepPollVisitor(
            _rel(path, root), _ImportMap(tree), pragmas
        )
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings


# ---------------------------------------------------------------------------
# Driver


def lint(
    root: Optional[Path] = None,
    passes: Optional[Iterable[str]] = None,
) -> List[Finding]:
    root = root or repo_root()
    selected = tuple(passes) if passes is not None else PASSES
    unknown = set(selected) - set(PASSES)
    if unknown:
        raise ValueError(f"unknown mirlint passes: {sorted(unknown)}")
    findings: List[Finding] = []
    if "determinism" in selected:
        findings += determinism_pass(root)
    if "parity" in selected:
        findings += parity_pass(root)
    if "locks" in selected:
        findings += locks_pass(root)
    if "wire" in selected:
        findings += wire_pass(root)
    if "sched" in selected:
        findings += sched_pass(root)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.tools.mirlint",
        description="repo static-analysis plane (docs/STATIC_ANALYSIS.md)",
    )
    parser.add_argument(
        "--root", type=Path, default=None, help="repo root (default: auto)"
    )
    parser.add_argument(
        "--passes",
        default=",".join(PASSES),
        help=f"comma-separated subset of {','.join(PASSES)}",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit findings as JSON on stdout (summary line goes to stderr)",
    )
    args = parser.parse_args(argv)
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    try:
        findings = lint(root=args.root, passes=passes)
    except ValueError as exc:
        parser.error(str(exc))
    summary = f"mirlint_findings_total {len(findings)}"
    if args.json:
        json.dump(
            {
                "passes": passes,
                "findings": [dataclasses.asdict(f) for f in findings],
                "total": len(findings),
            },
            sys.stdout,
            indent=2,
        )
        sys.stdout.write("\n")
        print(summary, file=sys.stderr)
    else:
        for finding in findings:
            print(finding.render())
        print(summary)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
