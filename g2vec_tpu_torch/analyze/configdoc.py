"""config-doc-drift: the flag surface, job-key map, and payload
vocabulary stay mutually consistent.

The port's copy of ``g2vec_tpu/analyze/configdoc.py``, over the port's
``config.py``, ``serve/protocol.py``, ``serve/daemon.py`` and
``serve/router.py``. Three registries drift independently:

- **CLI flags vs README.** ``config.build_parser`` is the source of
  truth for the flag surface; the README is what users read. Every
  ``--flag`` the parser accepts must appear in README.md.
- **SERVE_JOB_KEYS vs G2VecConfig.** The serve job schema whitelists
  which config fields a submitted job may set. A key that is not a
  real dataclass field is accepted-then-ignored — the worst kind of
  API lie.
- **Serve payload keys vs the protocol vocabularies.** daemon.py/
  router.py read request-envelope keys by string; the torch-free
  protocol module owns the vocabularies. Each envelope has a
  conventional variable name, and every key read through that name is
  linted against its tuple: ``payload`` → ``SUBMIT_KEYS``, ``qreq``
  (query requests) → ``QUERY_KEYS``, ``fqreq`` (federated queries) →
  ``FQUERY_KEYS``, ``rreq`` (result requests) → ``RESULT_KEYS``,
  ``ureq`` (updates) → ``UPDATE_KEYS``. A key read in the daemon but
  absent from its whitelist is either a typo or an undocumented
  protocol extension.

Everything is AST + text: flags from ``add_argument`` literals, fields
from the dataclass's annotated assignments, payload keys from
``<name>["k"]`` / ``<name>.get("k")`` subscripts on the conventional
envelope names above.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from g2vec_tpu_torch.analyze.core import (PKG, AnalysisContext, Checker,
                                          Finding, SourceFile)

CONFIG_FILE = f"{PKG}/config.py"
PROTOCOL_FILE = f"{PKG}/serve/protocol.py"
README = "README.md"
_PAYLOAD_FILES = (f"{PKG}/serve/daemon.py",
                  f"{PKG}/serve/router.py")
#: Conventional envelope variable name -> the protocol tuple its key
#: reads are linted against.
_ENVELOPES = {"payload": "SUBMIT_KEYS",
              "qreq": "QUERY_KEYS",
              "fqreq": "FQUERY_KEYS",
              "rreq": "RESULT_KEYS",
              "ureq": "UPDATE_KEYS"}


def _tuple_of_str(tree: ast.Module, name: str) -> Optional[Set[str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    try:
                        return set(ast.literal_eval(node.value))
                    except ValueError:
                        return None
    return None


class ConfigDocChecker(Checker):
    id = "config-doc-drift"
    description = ("CLI flags vs README, SERVE_JOB_KEYS vs config "
                   "fields, serve payload keys vs protocol.SUBMIT_KEYS")
    severity = "error"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        cfg = ctx.file(CONFIG_FILE)
        if cfg is None or cfg.tree is None:
            return findings          # fixture tree without a config
        self._check_flags(ctx, cfg, findings)
        self._check_job_keys(ctx, cfg, findings)
        self._check_payload_keys(ctx, findings)
        return findings

    def _check_flags(self, ctx: AnalysisContext, cfg: SourceFile,
                     findings: List[Finding]) -> None:
        readme_path = ctx.file(README)
        if readme_path is None:
            return
        readme = readme_path.text
        for node in ast.walk(cfg.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"):
                continue
            for arg in node.args:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value.startswith("--"):
                    if arg.value not in readme:
                        findings.append(ctx.finding(
                            self, cfg, node.lineno,
                            f"CLI flag {arg.value} is accepted by "
                            f"config.build_parser but never mentioned "
                            f"in {README}"))

    def _check_job_keys(self, ctx: AnalysisContext, cfg: SourceFile,
                        findings: List[Finding]) -> None:
        keys = _tuple_of_str(cfg.tree, "SERVE_JOB_KEYS")
        if keys is None:
            return
        fields: Set[str] = set()
        for node in ast.walk(cfg.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name == "G2VecConfig":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and \
                            isinstance(stmt.target, ast.Name):
                        fields.add(stmt.target.id)
                    elif isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                fields.add(t.id)
        if not fields:
            return
        decl_line = next(
            (n.lineno for n in ast.walk(cfg.tree)
             if isinstance(n, ast.Assign)
             and any(isinstance(t, ast.Name)
                     and t.id == "SERVE_JOB_KEYS"
                     for t in n.targets)), 1)
        for key in sorted(keys - fields):
            findings.append(ctx.finding(
                self, cfg, decl_line,
                f"SERVE_JOB_KEYS entry {key!r} is not a G2VecConfig "
                f"field — jobs setting it are accepted-then-ignored"))

    def _check_payload_keys(self, ctx: AnalysisContext,
                            findings: List[Finding]) -> None:
        proto = ctx.file(PROTOCOL_FILE)
        if proto is None or proto.tree is None:
            return
        whitelists = {}
        for var, tuple_name in _ENVELOPES.items():
            wl = _tuple_of_str(proto.tree, tuple_name)
            if wl is not None:
                whitelists[var] = (tuple_name, wl)
        if not whitelists:
            return
        for rel in _PAYLOAD_FILES:
            sf = ctx.file(rel)
            if sf is None or sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                var = key = line = None
                if isinstance(node, ast.Subscript) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id in whitelists and \
                        isinstance(node.slice, ast.Constant) and \
                        isinstance(node.slice.value, str):
                    var, key, line = (node.value.id, node.slice.value,
                                      node.lineno)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "get" and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in whitelists and \
                        node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str):
                    var, key, line = (node.func.value.id,
                                      node.args[0].value, node.lineno)
                if key is not None:
                    tuple_name, wl = whitelists[var]
                    if key not in wl:
                        findings.append(ctx.finding(
                            self, sf, line,
                            f"{var} key {key!r} is read here but not "
                            f"whitelisted in protocol.{tuple_name} — "
                            f"typo or undocumented protocol extension"))
