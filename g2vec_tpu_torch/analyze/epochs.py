"""Fencing-epoch discipline: every mutating router→daemon command
literal carries ``router_epoch``.

The port's copy of ``g2vec_tpu/analyze/epochs.py``, over the port's
``serve/router.py``. The partition-tolerance story (serve/leader.py)
only holds if a zombie ex-leader cannot emit even ONE mutating command
without its epoch stamped on it — daemons reject stale epochs, but an
epoch-LESS command is accepted for single-router compatibility, so a
forgotten stamp at a new call site silently reopens the split-brain
hole the lease closed.
That is a grep-able invariant, so this checker greps it (structurally):

- Every ``dict`` literal and every ``dict(...)`` call in
  serve/router.py whose ``op`` is one of the daemon's MUTATING ops
  (``submit`` / ``cancel`` / ``drain`` / ``shutdown``) must also carry
  a ``router_epoch`` key.
- The stamp must be the router's live view — ``self.router_epoch`` (or
  a local bound from it); a hard-coded integer other than 0 is flagged
  too, since a constant epoch can never be superseded.

Read-plane ops (status / ping / result / query) are exempt by design:
reads stay open during partitions — that IS degraded mode. The check
is literal-site-only on purpose (same philosophy as the metrics-schema
checker): a payload assembled dynamically goes through
``Router._request``, which refuses to invent an epoch, so the literal
sites are exactly where the invariant lives.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from g2vec_tpu_torch.analyze.core import (PKG, AnalysisContext, Checker,
                                          Finding, SourceFile)

#: Ops the daemon's connection handler epoch-gates (daemon.py keeps the
#: matching tuple in ``_handle_conn``); reads are deliberately absent.
MUTATING_OPS = ("submit", "cancel", "drain", "shutdown")

_ROUTER_FILE = f"{PKG}/serve/router.py"


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _literal_payload_keys(node: ast.AST):
    """(op, keys) for a dict literal or ``dict(...)`` call building a
    request payload; (None, None) for anything else. ``dict(base,
    op="submit", ...)`` counts the kwargs only — the positional base is
    an already-stamped (or client-sanitized) payload and the kwargs are
    what THIS site adds."""
    if isinstance(node, ast.Dict):
        keys = [_const_str(k) for k in node.keys]
        if None in keys:        # **splat or computed key: not a literal
            return None, None
        op = None
        for k, v in zip(keys, node.values):
            if k == "op":
                op = _const_str(v)
        return op, set(keys)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "dict":
        op = None
        keys = set()
        for kw in node.keywords:
            if kw.arg is None:
                return None, None
            keys.add(kw.arg)
            if kw.arg == "op":
                op = _const_str(kw.value)
        return op, keys
    return None, None


def _epoch_value(node: ast.AST) -> Optional[ast.AST]:
    """The expression bound to ``router_epoch`` in a payload literal."""
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            if _const_str(k) == "router_epoch":
                return v
    elif isinstance(node, ast.Call):
        for kw in node.keywords:
            if kw.arg == "router_epoch":
                return kw.value
    return None


class EpochStampChecker(Checker):
    id = "epoch-stamp"
    description = ("every mutating router->daemon payload literal "
                   "carries router_epoch")
    severity = "error"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        out: List[Finding] = []
        sf = ctx.file(_ROUTER_FILE)
        if sf is None or sf.tree is None:
            return out
        self._scan(ctx, sf, out)
        return out

    def _scan(self, ctx: AnalysisContext, sf: SourceFile,
              out: List[Finding]) -> None:
        for node in ast.walk(sf.tree):
            op, keys = _literal_payload_keys(node)
            if op is None or op not in MUTATING_OPS:
                continue
            if "router_epoch" not in keys:
                out.append(ctx.finding(
                    self, sf, node.lineno,
                    f"mutating payload literal (op={op!r}) without a "
                    f"router_epoch stamp — a zombie ex-leader could "
                    f"emit it unfenced; stamp self.router_epoch (0 "
                    f"strips to byte-identical HA-off wire form)"))
                continue
            val = _epoch_value(node)
            if isinstance(val, ast.Constant) and val.value != 0:
                out.append(ctx.finding(
                    self, sf, node.lineno,
                    f"op={op!r} stamps a constant router_epoch "
                    f"{val.value!r} — a fixed epoch can never be "
                    f"superseded; use self.router_epoch"))
