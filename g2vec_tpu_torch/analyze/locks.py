"""lock-discipline: ``# guarded-by:`` race lint + lock-order cycles.

The port's copy of ``g2vec_tpu/analyze/locks.py``, whole. Annotation
grammar:

- ``self._idem: Dict[str, str] = {}   # guarded-by: _idem_lock`` — the
  attribute may only be MUTATED while ``with self._idem_lock:`` is
  held. The comment may also sit on its own line directly above the
  assignment. ``_rep_locks`` (a dict of locks) counts as held when any
  ``with self._rep_locks[...]:`` is open.
- ``# guarded-by: Router._rep_locks`` — a dotted lock name declares an
  EXTERNAL serializer (another class's lock). Recorded as documentation
  only: the checker cannot see the foreign holder, so these attributes
  are exempt from enforcement (the annotation still pins the contract
  in a greppable form).
- ``# analyze: holds[_lock]`` on (or directly above) a ``def`` declares
  a caller-holds contract: the method body is analyzed as if the lock
  were already held, and every same-class call site that does NOT hold
  it is flagged.

What fires:

- mutation of a guarded attribute outside its lock (assignment,
  augmented assignment, ``del``, subscript store, or a mutating method
  call such as ``.append``/``.pop``/``[k] =``) — ``__init__`` is exempt
  (construction happens-before any thread exists);
- check-then-act: a guarded attribute read under its lock in one
  ``with`` block and mutated under a RE-ACQUIRED lock later in the same
  function (the ``_idem`` bug class of the serve daemon's admission:
  lookup and reservation must be one critical section);
- a ``holds[...]`` method called without the promised lock;
- a cycle in the per-class lock-acquisition graph (nested ``with``
  scopes plus one level of ``self._method()`` propagation).

Conditions wrapping locks are understood: after
``self._not_empty = threading.Condition(self._lock)``, holding
``_not_empty`` IS holding ``_lock``.

Known limits (documented, deliberate): mutations through a local alias
(``tier = self._tiers[p]; tier.append(...)``) are invisible, as are
acquisitions through helpers more than one call deep. The checker is a
tripwire for the bug classes this repo has actually shipped, not a
proof system.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from g2vec_tpu_torch.analyze.core import (AnalysisContext, Checker,
                                          Finding, SourceFile)

_GUARD_RE = re.compile(r"#+:?\s*guarded-by:\s*"
                       r"([A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)")
_HOLDS_RE = re.compile(r"#\s*analyze:\s*holds\[([A-Za-z_][A-Za-z0-9_]*)\]")
_ATTR_DEF_RE = re.compile(r"\bself\.([A-Za-z_][A-Za-z0-9_]*)\s*"
                          r"(?::[^=]+)?=(?!=)")

#: Method calls that mutate their receiver in place.
_MUTATORS = {"append", "appendleft", "extend", "insert", "add", "update",
             "setdefault", "pop", "popitem", "popleft", "remove",
             "discard", "clear", "sort", "reverse", "move_to_end"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` / ``self.X[...]`` / ``self.X[...][...]`` -> ``X``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, sf: SourceFile):
        self.node = node
        self.sf = sf
        self.name = node.name
        #: attr -> lock name (local, enforceable)
        self.guards: Dict[str, str] = {}
        #: attr -> dotted external lock (documentation only)
        self.external: Dict[str, str] = {}
        #: condition/lock aliasing: held(_not_empty) => held(_lock)
        self.aliases: Dict[str, str] = {}
        #: method name -> locks its body acquires anywhere
        self.acquires: Dict[str, Set[str]] = {}
        #: method name -> caller-holds contract locks
        self.holds: Dict[str, Set[str]] = {}
        #: lock-order edges (outer, inner) -> first witness line
        self.edges: Dict[Tuple[str, str], int] = {}
        #: deferred same-class calls: (caller, callee, held, line)
        self.calls: List[Tuple[str, str, frozenset, int]] = []

    def canon(self, lock: str) -> str:
        seen = set()
        while lock in self.aliases and lock not in seen:
            seen.add(lock)
            lock = self.aliases[lock]
        return lock


class LockDisciplineChecker(Checker):
    id = "lock-discipline"
    description = ("guarded-by annotations: mutations outside the lock, "
                   "check-then-act across a release, holds[] contracts, "
                   "lock-order cycles")
    severity = "error"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        for sf in ctx.files():
            if "guarded-by:" not in sf.text and \
                    "analyze: holds[" not in sf.text:
                continue
            tree = sf.tree
            if tree is None:
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    info = self._collect(node, sf)
                    if info.guards or info.holds:
                        self._check_class(ctx, info, findings)
        return findings

    # ---- annotation + structure collection --------------------------------

    def _collect(self, node: ast.ClassDef, sf: SourceFile) -> _ClassInfo:
        info = _ClassInfo(node, sf)
        lo, hi = node.lineno, node.end_lineno or node.lineno
        for i in range(lo, hi + 1):
            line = sf.lines[i - 1]
            m = _GUARD_RE.search(line)
            if m:
                lock = m.group(1)
                attr = self._annotated_attr(sf, i, hi)
                if attr is not None:
                    if "." in lock:
                        info.external[attr] = lock
                    else:
                        info.guards[attr] = lock
        # Condition-wraps-lock aliasing, from any method body.
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call):
                fn = sub.value.func
                if isinstance(fn, ast.Attribute) and \
                        fn.attr == "Condition" and sub.value.args:
                    wrapped = _self_attr(sub.value.args[0])
                    for t in sub.targets:
                        cond = _self_attr(t)
                        if cond and wrapped:
                            info.aliases[cond] = wrapped
        # holds[...] contracts: on the def line or in the contiguous
        # comment block above it (above decorators too).
        for meth in self._methods(node):
            first = min([meth.lineno]
                        + [d.lineno for d in meth.decorator_list])
            cand = [meth.lineno]
            i = first - 1
            while i >= 1 and sf.lines[i - 1].lstrip().startswith("#"):
                cand.append(i)
                i -= 1
            for i in cand:
                for m in _HOLDS_RE.finditer(sf.lines[i - 1]):
                    info.holds.setdefault(meth.name,
                                          set()).add(m.group(1))
        return info

    def _annotated_attr(self, sf: SourceFile, line: int,
                        class_end: int) -> Optional[str]:
        """The ``self.X`` an annotation at ``line`` talks about: on the
        same line, or the next assignment below a standalone comment."""
        m = _ATTR_DEF_RE.search(sf.lines[line - 1])
        if m:
            return m.group(1)
        if sf.lines[line - 1].lstrip().startswith("#"):
            for j in range(line + 1, min(line + 4, class_end + 1)):
                text = sf.lines[j - 1]
                if text.lstrip().startswith("#"):
                    continue
                m = _ATTR_DEF_RE.search(text)
                return m.group(1) if m else None
        return None

    def _methods(self, node: ast.ClassDef) -> List[ast.FunctionDef]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(sub)
        return out

    # ---- per-class analysis -----------------------------------------------

    def _check_class(self, ctx: AnalysisContext, info: _ClassInfo,
                     findings: List[Finding]) -> None:
        sf = info.sf
        # Pass 1: per-method lock sets + direct findings.
        for meth in self._methods(info.node):
            acquired: Set[str] = set()
            events: List[Tuple[str, str, int, int]] = []
            held0 = frozenset(info.canon(l)
                              for l in info.holds.get(meth.name, ()))
            self._walk(info, meth, list(meth.body), held0, acquired,
                       events, findings, ctx)
            info.acquires[meth.name] = acquired
            if meth.name != "__init__":
                self._check_then_act(ctx, info, meth, events, findings)
        # Pass 2: one-level interprocedural lock edges + holds[] audit.
        for caller, callee, held, line in info.calls:
            for inner in info.acquires.get(callee, ()):
                for outer in held:
                    if outer != inner:
                        info.edges.setdefault((outer, inner), line)
            missing = sorted(info.holds.get(callee, set()) - set(held))
            if missing and caller != "__init__":
                findings.append(ctx.finding(
                    self, sf, line,
                    f"{info.name}.{callee} requires holds"
                    f"[{', '.join(missing)}] but {info.name}.{caller} "
                    f"calls it without holding the lock"))
        self._check_cycles(ctx, info, findings)

    def _walk(self, info: _ClassInfo, meth: ast.FunctionDef,
              stmts: List[ast.stmt], held: frozenset,
              acquired: Set[str], events: List[Tuple[str, str, int, int]],
              findings: List[Finding], ctx: AnalysisContext,
              with_id: int = 0) -> None:
        """Statement walk tracking the held-lock set. ``events`` records
        (attr, kind, with_id, line) touches on guarded attrs for the
        check-then-act pass; ``with_id`` is the id() of the innermost
        guarding With node (0 = no lock held)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # A nested def runs later, on whoever calls it — its
                # body starts with no locks held.
                inner_acq: Set[str] = set()
                inner_ev: List[Tuple[str, str, int, int]] = []
                self._walk(info, stmt, list(stmt.body), frozenset(),
                           inner_acq, inner_ev, findings, ctx)
                acquired |= inner_acq
                self._check_then_act(ctx, info, stmt, inner_ev, findings)
                continue
            if isinstance(stmt, ast.With):
                locks = []
                for item in stmt.items:
                    lock = _self_attr(item.context_expr)
                    if lock is not None and self._is_lock(info, lock):
                        lock = info.canon(lock)
                        locks.append(lock)
                        acquired.add(lock)
                        for outer in held:
                            if outer != lock:
                                info.edges.setdefault((outer, lock),
                                                      stmt.lineno)
                new_held = held | frozenset(locks)
                self._scan_exprs(info, meth, stmt, held, events,
                                 findings, ctx, with_id,
                                 items_only=True)
                self._walk(info, meth, list(stmt.body), new_held,
                           acquired, events, findings, ctx,
                           id(stmt) if locks else with_id)
                continue
            # Compound statements: recurse into bodies with same held set.
            self._scan_exprs(info, meth, stmt, held, events, findings,
                             ctx, with_id)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk(info, meth, list(sub), held, acquired,
                               events, findings, ctx, with_id)
            for handler in getattr(stmt, "handlers", []):
                self._walk(info, meth, list(handler.body), held,
                           acquired, events, findings, ctx, with_id)

    def _is_lock(self, info: _ClassInfo, attr: str) -> bool:
        if attr in info.aliases or attr in set(info.guards.values()):
            return True
        return bool(re.search(r"lock|_cv$|cond|not_empty|_mu$", attr))

    def _scan_exprs(self, info: _ClassInfo, meth: ast.FunctionDef,
                    stmt: ast.stmt, held: frozenset,
                    events: List[Tuple[str, str, int, int]],
                    findings: List[Finding], ctx: AnalysisContext,
                    with_id: int, items_only: bool = False) -> None:
        """Findings + events for one statement's own expressions (child
        bodies are walked separately so the held set stays accurate)."""
        nodes: List[ast.AST] = []
        if items_only:
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    self._touch(info, meth, attr, "mutate", held,
                                with_id, stmt.lineno, events, findings,
                                ctx)
            if stmt.value is not None:
                nodes.append(stmt.value)
            if isinstance(stmt, ast.AugAssign):
                # ``self.x += 1`` also reads self.x.
                attr = _self_attr(stmt.target)
                if attr:
                    self._touch(info, meth, attr, "read", held, with_id,
                                stmt.lineno, events, findings, ctx)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                attr = _self_attr(t)
                if attr:
                    self._touch(info, meth, attr, "mutate", held,
                                with_id, stmt.lineno, events, findings,
                                ctx)
        elif isinstance(stmt, (ast.If, ast.While)):
            nodes.append(stmt.test)
        elif isinstance(stmt, ast.For):
            nodes.extend([stmt.iter, stmt.target])
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            nodes.append(stmt.value)
        elif isinstance(stmt, ast.Expr):
            nodes.append(stmt.value)
        elif isinstance(stmt, (ast.Assert, ast.Raise)):
            nodes.extend([n for n in (getattr(stmt, "test", None),
                                      getattr(stmt, "exc", None)) if n])
        # A mutator call's receiver (``self._running`` in
        # ``self._running.update(...)``) is not a check-making READ —
        # counting it would turn every two-critical-section function
        # into a check-then-act false positive. Collect receivers first.
        receiver_ids = set()
        for node in nodes:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in _MUTATORS and \
                        _self_attr(sub.func.value) is not None:
                    receiver_ids.update(id(n) for n
                                        in ast.walk(sub.func.value))
        for node in nodes:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    fn = sub.func
                    if isinstance(fn, ast.Attribute):
                        base = _self_attr(fn.value)
                        if base is not None and fn.attr in _MUTATORS:
                            self._touch(info, meth, base, "mutate",
                                        held, with_id, sub.lineno,
                                        events, findings, ctx)
                        elif base is None and \
                                isinstance(fn.value, ast.Name) and \
                                fn.value.id == "self":
                            info.calls.append(
                                (meth.name, fn.attr, held, sub.lineno))
                elif isinstance(sub, ast.Attribute) and \
                        isinstance(sub.ctx, ast.Load) and \
                        id(sub) not in receiver_ids:
                    attr = _self_attr(sub)
                    if attr:
                        self._touch(info, meth, attr, "read", held,
                                    with_id, sub.lineno, events,
                                    findings, ctx)

    def _touch(self, info: _ClassInfo, meth: ast.FunctionDef, attr: str,
               kind: str, held: frozenset, with_id: int, line: int,
               events: List[Tuple[str, str, int, int]],
               findings: List[Finding], ctx: AnalysisContext) -> None:
        lock = info.guards.get(attr)
        if lock is None:
            return
        lock = info.canon(lock)
        if kind == "mutate" and meth.name != "__init__" \
                and lock not in held:
            findings.append(ctx.finding(
                self, info.sf, line,
                f"{info.name}.{attr} is guarded-by {lock} but "
                f"{meth.name} mutates it without holding the lock"))
        if lock in held:
            events.append((attr, kind, with_id, line))

    def _check_then_act(self, ctx: AnalysisContext, info: _ClassInfo,
                        meth: ast.FunctionDef,
                        events: List[Tuple[str, str, int, int]],
                        findings: List[Finding]) -> None:
        """A read of a guarded attr in one critical section and a
        mutation of it in a LATER, separately-acquired one: the decision
        made under the first lock is stale by the second (TOCTOU)."""
        span: Dict[int, Tuple[int, int]] = {}
        for _, _, wid, line in events:
            lo, hi = span.get(wid, (line, line))
            span[wid] = (min(lo, line), max(hi, line))
        mutates = [(a, w, l) for a, k, w, l in events
                   if k == "mutate" and w]
        # A critical section that reads AND mutates the attr committed
        # its decision atomically (classic check-AND-act, e.g. "if x in
        # s: return; s.add(x)") — later sections mutating the same attr
        # (cleanup in finally, etc.) are not TOCTOU against it.
        committed = {(a, w) for a, w, _ in mutates}
        reads = [(a, w, l) for a, k, w, l in events
                 if k == "read" and w and (a, w) not in committed]
        flagged = set()
        for attr, w_r, _ in reads:
            for attr_m, w_m, line_m in mutates:
                if attr_m != attr or w_m == w_r:
                    continue
                if span[w_m][0] > span[w_r][1] and \
                        (attr, line_m) not in flagged:
                    flagged.add((attr, line_m))
                    findings.append(ctx.finding(
                        self, info.sf, line_m,
                        f"check-then-act on {info.name}.{attr}: read "
                        f"under {info.canon(info.guards[attr])} in one "
                        f"critical section, mutated in a later one — "
                        f"the decision is stale once the lock is "
                        f"dropped (merge into one with-block)",
                        severity="error"))

    def _check_cycles(self, ctx: AnalysisContext, info: _ClassInfo,
                      findings: List[Finding]) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in info.edges:
            graph.setdefault(a, set()).add(b)
        state: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(node: str) -> Optional[List[str]]:
            state[node] = 1
            stack.append(node)
            for nxt in sorted(graph.get(node, ())):
                if state.get(nxt, 0) == 1:
                    return stack[stack.index(nxt):] + [nxt]
                if state.get(nxt, 0) == 0:
                    cyc = dfs(nxt)
                    if cyc:
                        return cyc
            stack.pop()
            state[node] = 2
            return None

        for node in sorted(graph):
            if state.get(node, 0) == 0:
                cyc = dfs(node)
                if cyc:
                    line = min(info.edges.get((a, b), 1)
                               for a, b in zip(cyc, cyc[1:]))
                    findings.append(ctx.finding(
                        self, info.sf, line,
                        f"lock-order cycle in {info.name}: "
                        f"{' -> '.join(cyc)} — two threads taking these "
                        f"in opposite orders deadlock"))
                    return
