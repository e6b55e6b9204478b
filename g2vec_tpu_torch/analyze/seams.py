"""fault-seams: the ``fault_point`` vocabulary is a closed registry.

The port's copy of ``g2vec_tpu/analyze/seams.py``.
``g2vec_tpu_torch/resilience/faults.py`` declares the seam names
(``SEAMS``); fault plans, chaos tests, and the soak harness all speak
that vocabulary as string literals. Nothing ties the strings together at
runtime — a typo in a ``fault_point("hartbeat")`` call site silently
never fires, and a seam whose last call site was refactored away leaves
chaos plans testing nothing. So:

- every ``fault_point(<literal>)`` names a declared seam;
- a non-literal seam argument is flagged (the registry only works if
  the vocabulary is greppable);
- every declared seam has >= 1 call site in the port's package outside
  faults.py (a seam with no call site is dead vocabulary) and >= 1
  word-boundary reference in the port's tests, ``tests/test_torch_*.py``
  (an untested seam is an untested failure mode).

Only the port's files count: the JAX package's call sites and tests
speak the same vocabulary and would hide a seam the port lost.
The SEAMS tuple is read by AST, not by import, so the checker works on
fixture trees and never executes repo code.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from g2vec_tpu_torch.analyze.core import (PKG, AnalysisContext, Checker,
                                          Finding)

FAULTS_FILE = f"{PKG}/resilience/faults.py"


class FaultSeamChecker(Checker):
    id = "fault-seams"
    description = ("fault_point literals vs the declared SEAMS registry; "
                   "every seam called and test-referenced")
    severity = "error"

    def _declared(self, ctx: AnalysisContext) \
            -> Optional[Tuple[List[str], int]]:
        sf = ctx.file(FAULTS_FILE)
        if sf is None or sf.tree is None:
            return None
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "SEAMS":
                        try:
                            seams = list(ast.literal_eval(node.value))
                        except ValueError:
                            return None
                        return seams, node.lineno
        return None

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        decl = self._declared(ctx)
        if decl is None:
            return findings          # fixture tree without a registry
        seams, decl_line = decl
        declared = set(seams)
        call_sites: Dict[str, int] = {}
        for sf in ctx.files(PKG):
            if sf.relpath == FAULTS_FILE:
                continue
            tree = sf.tree
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                if name != "fault_point" or not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    seam = arg.value
                    call_sites[seam] = call_sites.get(seam, 0) + 1
                    if seam not in declared:
                        findings.append(ctx.finding(
                            self, sf, node.lineno,
                            f"fault_point({seam!r}) names an "
                            f"undeclared seam — add it to SEAMS in "
                            f"{FAULTS_FILE} or fix the typo"))
                else:
                    findings.append(ctx.finding(
                        self, sf, node.lineno,
                        f"fault_point seam argument is not a string "
                        f"literal — the registry is only checkable "
                        f"when the vocabulary is greppable"))
        tests_text = "\n".join(sf.text for sf in ctx.files("tests"))
        faults_sf = ctx.file(FAULTS_FILE)
        for seam in seams:
            if not call_sites.get(seam):
                findings.append(ctx.finding(
                    self, faults_sf, decl_line,
                    f"seam {seam!r} is declared in SEAMS but has no "
                    f"fault_point call site — dead vocabulary"))
            if tests_text and not re.search(
                    r"\b%s\b" % re.escape(seam), tests_text):
                findings.append(ctx.finding(
                    self, faults_sf, decl_line,
                    f"seam {seam!r} is declared in SEAMS but no test "
                    f"references it — an untested failure mode"))
        return findings
