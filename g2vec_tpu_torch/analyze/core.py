"""Analyzer plumbing: files, findings, waivers, baseline, runner.

The port's copy of ``g2vec_tpu/analyze/core.py``. Design rules every
checker obeys:

- **Pure AST + text.** Checkers never import the module under analysis
  (importing daemon.py would bring up torch and make the linter as slow
  as the code it guards). Everything is ``ast.parse`` plus line regexes
  for the comment grammar ``ast`` drops.
- **The port's own files.** The context lists only the port's files:
  ``g2vec_tpu_torch/``, ``chip_smoke.py`` and ``tests/test_torch_*.py``
  (see :func:`in_scope`). The JAX package beside it has its own suite;
  its ``fault_point`` call sites and its tests must not count for the
  port's seams, nor its classes for the port's locks.
- **Line-stable fingerprints.** A baseline entry must survive an
  unrelated edit shifting the file, so a finding's identity is
  (checker, file, enclosing ``Class.function`` context, message) — the
  line number is display-only and excluded from the hash.
- **Shrink-only baseline.** Baseline entries that no longer match any
  current finding are reported as *stale* and fail the run: the file
  may only shrink. Growing it requires a deliberate commit that CI (the
  repo-wide test in tests/test_torch_analyze.py) refuses.
- **Inline waivers beat baseline entries.** A deliberate exception
  belongs next to the code as ``# analyze: allow[<id>] <reason>`` (the
  reason is mandatory — a bare allow does not suppress anything); the
  baseline is only for pre-existing findings awaiting a fix.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: The package this suite lints, and its default baseline (relative to
#: the root).
PKG = "g2vec_tpu_torch"
BASELINE_FILE = f"{PKG}/analyze/baseline.json"

#: ``# analyze: allow[lock-discipline] boot-time, single-threaded``
#: The reason group is mandatory: a waiver that does not say why is not
#: a waiver, and the original finding fires (loudly) instead.
_WAIVER_RE = re.compile(
    r"#\s*analyze:\s*allow\[([A-Za-z0-9_-]+)\]\s+(\S.*)")

_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "build", "dist",
              ".eggs", "node_modules"}

_PORT_TEST_RE = re.compile(r"tests/test_torch_[^/]*\.py")


def in_scope(relpath: str) -> bool:
    """Whether a repo-relative ``.py`` path is one of the port's files."""
    return (relpath.startswith(PKG + "/") or relpath == "chip_smoke.py"
            or _PORT_TEST_RE.fullmatch(relpath) is not None)


@dataclasses.dataclass
class Finding:
    """One checker verdict, anchored to ``path:line`` for humans and to
    a line-free fingerprint for the baseline."""

    checker: str
    severity: str                 # "error" | "warning"
    path: str                     # repo-relative, forward slashes
    line: int
    message: str
    context: str = "<module>"     # enclosing Class.function, line-stable

    def fingerprint(self) -> str:
        raw = f"{self.checker}|{self.path}|{self.context}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"checker": self.checker, "severity": self.severity,
                "path": self.path, "line": self.line,
                "context": self.context, "message": self.message,
                "fingerprint": self.fingerprint()}


class SourceFile:
    """One parsed file: text, lines, AST (lazy), waivers, and a
    line → enclosing-scope map for stable finding contexts."""

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.relpath = relpath
        with open(abspath, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.Module] = None
        self._parse_error: Optional[str] = None
        self._scopes: Optional[List[Tuple[int, int, str]]] = None
        #: line number -> checker ids waived on that line
        self.waivers: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _WAIVER_RE.search(line)
            if m:
                self.waivers.setdefault(i, set()).add(m.group(1))

    @property
    def tree(self) -> Optional[ast.Module]:
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text, filename=self.relpath)
            except SyntaxError as e:
                self._parse_error = f"syntax error: {e}"
        return self._tree

    def scope_at(self, line: int) -> str:
        """``Class.function`` (or ``<module>``) enclosing ``line`` —
        the innermost def/class whose span covers it."""
        if self._scopes is None:
            self._scopes = []
            tree = self.tree
            if tree is not None:
                def visit(node, prefix):
                    for child in ast.iter_child_nodes(node):
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.ClassDef)):
                            name = (f"{prefix}.{child.name}" if prefix
                                    else child.name)
                            self._scopes.append(
                                (child.lineno,
                                 child.end_lineno or child.lineno, name))
                            visit(child, name)
                visit(tree, "")
        best = "<module>"
        best_span = None
        for lo, hi, name in self._scopes:
            if lo <= line <= hi and (best_span is None
                                     or hi - lo < best_span):
                best, best_span = name, hi - lo
        return best

    def is_waived(self, line: int, checker: str) -> bool:
        """A waiver suppresses findings on its own line or anywhere in
        the contiguous comment block directly above the statement (a
        waiver's reason often needs a second comment line)."""
        if checker in self.waivers.get(line, ()):
            return True
        cand = line - 1
        while 1 <= cand <= len(self.lines) and \
                self.lines[cand - 1].lstrip().startswith("#"):
            if checker in self.waivers.get(cand, ()):
                return True
            cand -= 1
        return False


class AnalysisContext:
    """The scanned file set plus shared lookups, built once per run."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, SourceFile] = {}
        self._all: Optional[List[SourceFile]] = None

    def _rel(self, abspath: str) -> str:
        return os.path.relpath(abspath, self.root).replace(os.sep, "/")

    def file(self, relpath: str) -> Optional[SourceFile]:
        """One file by repo-relative path, in scope or not (README.md,
        a package ``__init__`` on an import chain); None if absent
        (checkers skip targets a fixture tree does not provide)."""
        relpath = relpath.replace(os.sep, "/")
        if relpath not in self._files:
            abspath = os.path.join(self.root, relpath)
            if not os.path.isfile(abspath):
                return None
            self._files[relpath] = SourceFile(abspath, relpath)
        return self._files.get(relpath)

    def files(self, under: Optional[str] = None) -> List[SourceFile]:
        """Every ``.py`` file of the port under the root (or one
        subtree)."""
        if self._all is None:
            found = []
            for dirpath, dirnames, filenames in os.walk(self.root):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = self._rel(os.path.join(dirpath, fn))
                        if not in_scope(rel):
                            continue
                        sf = self.file(rel)
                        if sf is not None:
                            found.append(sf)
            self._all = found
        if under is None:
            return list(self._all)
        under = under.rstrip("/") + "/"
        return [sf for sf in self._all if sf.relpath.startswith(under)]

    def finding(self, checker: "Checker", sf: SourceFile, line: int,
                message: str, severity: Optional[str] = None) -> Finding:
        return Finding(checker=checker.id,
                       severity=severity or checker.severity,
                       path=sf.relpath, line=line, message=message,
                       context=sf.scope_at(line))


class Checker:
    """Plugin base: subclasses set ``id``/``description``/``severity``
    and implement :meth:`check` returning raw findings (the runner
    applies waivers and the baseline)."""

    id = "abstract"
    description = ""
    severity = "error"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        raise NotImplementedError


def all_checkers() -> List[Checker]:
    # Imported here, not at module top: core must stay importable from
    # a checker module without a cycle.
    from g2vec_tpu_torch.analyze.configdoc import ConfigDocChecker
    from g2vec_tpu_torch.analyze.epochs import EpochStampChecker
    from g2vec_tpu_torch.analyze.events import MetricsSchemaChecker
    from g2vec_tpu_torch.analyze.locks import LockDisciplineChecker
    from g2vec_tpu_torch.analyze.purity import TorchPurityChecker
    from g2vec_tpu_torch.analyze.seams import FaultSeamChecker
    return [LockDisciplineChecker(), TorchPurityChecker(),
            FaultSeamChecker(), MetricsSchemaChecker(),
            ConfigDocChecker(), EpochStampChecker()]


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> human note. Missing file = empty baseline."""
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    supp = data.get("suppressions", {})
    if not isinstance(supp, dict):
        raise ValueError(
            f"{path}: 'suppressions' must be an object mapping "
            f"fingerprint -> note")
    return dict(supp)


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    supp = {f.fingerprint(): f"{f.checker} {f.path} "
                             f"[{f.context}] {f.message}"
            for f in findings}
    # The default baseline sits inside the package, which a fixture
    # tree may not have.
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1,
                   "note": "shrink-only: entries may be removed when "
                           "fixed, never added (fix or use an inline "
                           "'# analyze: allow[id] reason' waiver)",
                   "suppressions": dict(sorted(supp.items()))},
                  f, indent=2, sort_keys=False)
        f.write("\n")


@dataclasses.dataclass
class AnalysisReport:
    """Runner output: what fires, what was deliberately quiet, and
    which baseline entries went stale (shrink-only enforcement)."""

    findings: List[Finding]               # active (fail the run)
    waived: List[Finding]                 # inline-waiver suppressed
    baselined: List[Finding]              # baseline suppressed
    stale_baseline: List[str]             # fingerprints with no match
    checkers_run: List[str]

    @property
    def clean(self) -> bool:
        return not self.findings and not self.stale_baseline

    def to_dict(self) -> dict:
        return {"clean": self.clean,
                "checkers": self.checkers_run,
                "counts": {"active": len(self.findings),
                           "waived": len(self.waived),
                           "baselined": len(self.baselined),
                           "stale_baseline": len(self.stale_baseline)},
                "findings": [f.to_dict() for f in self.findings],
                "waived": [f.to_dict() for f in self.waived],
                "baselined": [f.to_dict() for f in self.baselined],
                "stale_baseline": sorted(self.stale_baseline)}


def run_analysis(root: str,
                 checker_ids: Optional[List[str]] = None,
                 baseline_path: Optional[str] = None) -> AnalysisReport:
    """Run the suite (or a subset) over ``root``. Raises KeyError for an
    unknown checker id — the CLI maps that to the usage exit code."""
    ctx = AnalysisContext(root)
    checkers = all_checkers()
    known = {c.id for c in checkers}
    if checker_ids:
        unknown = sorted(set(checker_ids) - known)
        if unknown:
            raise KeyError(
                f"unknown checker(s) {unknown}; known: {sorted(known)}")
        checkers = [c for c in checkers if c.id in set(checker_ids)]
    baseline = load_baseline(baseline_path) if baseline_path else {}

    active: List[Finding] = []
    waived: List[Finding] = []
    baselined: List[Finding] = []
    seen_fps: Set[str] = set()
    for checker in checkers:
        for f in checker.check(ctx):
            sf = ctx.file(f.path)
            if sf is not None and sf.is_waived(f.line, f.checker):
                waived.append(f)
                continue
            fp = f.fingerprint()
            seen_fps.add(fp)
            if fp in baseline:
                baselined.append(f)
            else:
                active.append(f)
    stale = [fp for fp in baseline if fp not in seen_fps]
    active.sort(key=lambda f: (f.path, f.line, f.checker))
    return AnalysisReport(findings=active, waived=waived,
                          baselined=baselined, stale_baseline=stale,
                          checkers_run=[c.id for c in checkers])
