"""metrics-schema: every MetricsWriter emission matches its declared
event schema.

The port's copy of ``g2vec_tpu/analyze/events.py``, held against the
port's own schema, ``g2vec_tpu_torch/utils/metrics_schema.py``. The
metrics JSONL is an API: the chaos-soak accountant sums
``job_done`` events, dashboards pivot on ``failover.latency_s``, and
tests assert field presence. Yet emission is stringly typed —
``metrics.emit("job_done", walltime=...)`` — so renaming a field at one
of a kind's five emit sites silently forks the stream's shape.

``utils/metrics_schema.py`` declares, per event kind, the fields every
emission must carry (``required``) and the fields any emission may
carry (``optional``). This checker lints every ``.emit("<literal>",
...)`` site:

- unknown event kind (not declared at all);
- unknown field (neither required nor optional for that kind);
- missing required field — skipped when the call splats ``**fields``
  (the checker cannot see inside a splat; unknown-field checking still
  applies to the literal kwargs).

Sites whose kind is not a string literal are skipped: the two generic
relay shims (e.g. re-emitting a child's event) are schema-checked at
the original emit site instead. Fields injected by the BoundMetrics
facade (``job``, ``lane``, ...) are declared optional, never required.
The schema file is read by AST — the checker never imports repo code.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from g2vec_tpu_torch.analyze.core import (PKG, AnalysisContext, Checker,
                                          Finding)

SCHEMA_FILE = f"{PKG}/utils/metrics_schema.py"
#: Dirs scanned for emit sites: the port's package, its tools included
#: (tests emit ad-hoc kinds on purpose).
_SCAN = (PKG,)


class MetricsSchemaChecker(Checker):
    id = "metrics-schema"
    description = ("MetricsWriter emissions vs the declared per-kind "
                   "event schemas (utils/metrics_schema.py)")
    severity = "error"

    def _schemas(self, ctx: AnalysisContext) \
            -> Optional[Dict[str, Dict[str, Set[str]]]]:
        sf = ctx.file(SCHEMA_FILE)
        if sf is None or sf.tree is None:
            return None
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id == "EVENT_SCHEMAS":
                        try:
                            raw = ast.literal_eval(node.value)
                        except ValueError:
                            return None
                        return {
                            kind: {"required": set(s.get("required",
                                                         ())),
                                   "optional": set(s.get("optional",
                                                         ()))}
                            for kind, s in raw.items()}
        return None

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        schemas = self._schemas(ctx)
        if schemas is None:
            return findings          # fixture tree without schemas
        for top in _SCAN:
            for sf in ctx.files(top):
                if sf.relpath == SCHEMA_FILE:
                    continue
                tree = sf.tree
                if tree is None:
                    continue
                for node in ast.walk(tree):
                    if not isinstance(node, ast.Call):
                        continue
                    fn = node.func
                    if not (isinstance(fn, ast.Attribute)
                            and fn.attr == "emit"):
                        continue
                    if not node.args:
                        continue
                    kind_node = node.args[0]
                    if not (isinstance(kind_node, ast.Constant)
                            and isinstance(kind_node.value, str)):
                        continue     # generic relay shim
                    kind = kind_node.value
                    schema = schemas.get(kind)
                    if schema is None:
                        findings.append(ctx.finding(
                            self, sf, node.lineno,
                            f"emit({kind!r}) is not a declared event "
                            f"kind — add it to EVENT_SCHEMAS in "
                            f"{SCHEMA_FILE}"))
                        continue
                    has_splat = any(kw.arg is None
                                    for kw in node.keywords)
                    present = {kw.arg for kw in node.keywords
                               if kw.arg is not None}
                    allowed = schema["required"] | schema["optional"]
                    for field in sorted(present - allowed):
                        findings.append(ctx.finding(
                            self, sf, node.lineno,
                            f"emit({kind!r}) passes undeclared field "
                            f"{field!r} — declare it in the "
                            f"{kind!r} schema or drop it"))
                    if not has_splat:
                        for field in sorted(schema["required"]
                                            - present):
                            findings.append(ctx.finding(
                                self, sf, node.lineno,
                                f"emit({kind!r}) is missing required "
                                f"field {field!r}"))
        return findings
