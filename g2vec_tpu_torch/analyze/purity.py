"""torch-purity: torch-free module boundaries + the no-JAX boundary.

The port's counterpart of ``g2vec_tpu/analyze/purity.py``'s
``jax-purity``. Two sub-checks, both pure AST:

1. **torch-free closure.** The declared torch-free modules (the router
   stack, the chaos tool and this suite must start fast and run on boxes
   with no CUDA) may not reach ``torch``/``triton`` through the
   MODULE-LEVEL import graph. The walk models real import semantics:
   importing ``g2vec_tpu_torch.serve.daemon`` executes
   ``g2vec_tpu_torch/__init__`` and ``g2vec_tpu_torch/serve/__init__``
   too, so a torch import smuggled into a package init is caught even
   though no declared module names it. Function-local (deferred) imports
   in *transitive* deps are the repo's sanctioned lazy idiom and are
   allowed; a declared module itself must not import torch anywhere,
   deferred or not.
2. **No JAX.** No module of the port (``g2vec_tpu_torch/`` and
   ``chip_smoke.py``) imports ``jax``, ``jaxlib``, ``optax``,
   ``ml_dtypes`` or anything of ``g2vec_tpu``, at module level or
   deferred: the port keeps its own copy of what it needs.

The reference's other two sub-checks, host bounces inside jitted
functions and use-after-donate, have no counterpart: the port has no
traced functions and no donated buffers.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from g2vec_tpu_torch.analyze.core import (PKG, AnalysisContext, Checker,
                                          Finding, SourceFile)

#: Modules that must never reach torch at import time (relpath -> why).
#: A path ending in ``/`` declares every module under it.
TORCH_FREE = {
    f"{PKG}/serve/protocol.py":
        "shared by the router process, which never imports torch",
    f"{PKG}/serve/router.py":
        "the front door must boot in milliseconds on accelerator-free "
        "hosts",
    f"{PKG}/serve/leader.py":
        "the leadership lease is watched by standby routers on "
        "accelerator-free hosts",
    f"{PKG}/resilience/lifecycle.py":
        "imported by router and daemon alike; pure state machines",
    f"{PKG}/tools/chaos_soak.py":
        "the soak harness supervises daemons, it never owns a device",
    f"{PKG}/analyze/":
        "the static-analysis suite runs in well under a second on boxes "
        "with no CUDA",
}

#: What a declared module may not reach.
_TORCH = ("torch", "triton")
#: What no module of the port may import at all.
_NO_JAX = ("jax", "jaxlib", "optax", "ml_dtypes", "g2vec_tpu")


def _all_imports(tree: ast.Module) -> List[Tuple[str, int]]:
    """(module name, line) for every import anywhere in the file,
    deferred ones included."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append((node.module, node.lineno))
    return out


class TorchPurityChecker(Checker):
    id = "torch-purity"
    description = ("torch-free module closure; no module of the port "
                   "imports jax or the JAX package")
    severity = "error"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        self._check_torch_free(ctx, findings)
        self._check_no_jax(ctx, findings)
        return findings

    # ---- no JAX anywhere in the port ---------------------------------------

    def _check_no_jax(self, ctx: AnalysisContext,
                      findings: List[Finding]) -> None:
        for sf in ctx.files():
            if sf.relpath.startswith("tests/") or sf.tree is None:
                continue        # the parity tests import both packages
            for name, line in _all_imports(sf.tree):
                if name.split(".")[0] in _NO_JAX:
                    findings.append(ctx.finding(
                        self, sf, line,
                        f"{sf.relpath} imports {name} — the port imports "
                        f"no JAX and nothing of g2vec_tpu; keep a copy "
                        f"of what it needs"))

    # ---- torch-free import closure -----------------------------------------

    def _declared(self, ctx: AnalysisContext) -> List[Tuple[str, str]]:
        out = []
        for path, why in sorted(TORCH_FREE.items()):
            if path.endswith("/"):
                out += [(sf.relpath, why) for sf in ctx.files(path)]
            else:
                out.append((path, why))
        return out

    def _module_files(self, ctx: AnalysisContext,
                      modname: str) -> List[str]:
        """Repo files executed by importing ``modname``: the module
        itself plus every ancestor package ``__init__``. Empty for
        external modules."""
        parts = modname.split(".")
        out: List[str] = []
        for i in range(1, len(parts) + 1):
            prefix = parts[:i]
            pkg = "/".join(prefix) + "/__init__.py"
            mod = "/".join(prefix) + ".py"
            if ctx.file(pkg) is not None:
                out.append(pkg)
            elif i == len(parts) and ctx.file(mod) is not None:
                out.append(mod)
            elif i < len(parts) and ctx.file(mod) is not None:
                # ``from g2vec_tpu_torch.config import X``: config is a
                # module, X an attribute.
                out.append(mod)
                break
        return out

    def _top_level_imports(self, sf: SourceFile) \
            -> List[Tuple[str, int]]:
        """(module name, line) for every import that executes at module
        import time — module body including class bodies and top-level
        try/if, excluding function bodies (the lazy idiom)."""
        out: List[Tuple[str, int]] = []
        tree = sf.tree
        if tree is None:
            return out

        def visit(stmts):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.Import):
                    for alias in stmt.names:
                        out.append((alias.name, stmt.lineno))
                elif isinstance(stmt, ast.ImportFrom):
                    base = stmt.module or ""
                    if stmt.level:
                        # Relative import: anchor at the file's package.
                        pkg = os.path.dirname(sf.relpath).replace("/",
                                                                  ".")
                        for _ in range(stmt.level - 1):
                            pkg = pkg.rpartition(".")[0]
                        base = f"{pkg}.{base}".rstrip(".") if base \
                            else pkg
                    if base:
                        out.append((base, stmt.lineno))
                        for alias in stmt.names:
                            # ``from pkg import sub`` may bind a
                            # submodule — the walk resolves both.
                            out.append((f"{base}.{alias.name}",
                                        stmt.lineno))
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        visit(sub)
                for handler in getattr(stmt, "handlers", []):
                    visit(handler.body)

        visit(tree.body)
        return out

    def _check_torch_free(self, ctx: AnalysisContext,
                          findings: List[Finding]) -> None:
        for root, why in self._declared(ctx):
            sf = ctx.file(root)
            if sf is None:
                continue
            # A declared module must not import torch anywhere AT ALL,
            # even deferred (that would just move the cost to runtime).
            tree = sf.tree
            if tree is not None:
                for name, line in _all_imports(tree):
                    if name.split(".")[0] in _TORCH:
                        findings.append(ctx.finding(
                            self, sf, line,
                            f"{root} is declared torch-free ({why}) "
                            f"but imports {name} directly"))
            # BFS over module-level imports with parent chains.
            parent: Dict[str, Tuple[Optional[str], int]] = {
                root: (None, 0)}
            queue = [root]
            while queue:
                cur = queue.pop(0)
                cur_sf = ctx.file(cur)
                if cur_sf is None:
                    continue
                for modname, line in self._top_level_imports(cur_sf):
                    top = modname.split(".")[0]
                    if top in _TORCH:
                        chain = [f"{top} (at line {line})"]
                        hop: Optional[str] = cur
                        while hop is not None:
                            chain.append(hop)
                            hop = parent[hop][0]
                        findings.append(ctx.finding(
                            self, sf, parent.get(cur, (None, 1))[1] or 1,
                            f"{root} is declared torch-free ({why}) but "
                            f"reaches {top} at import time: "
                            f"{' <- '.join(reversed(chain))}"))
                        continue
                    for dep in self._module_files(ctx, modname):
                        if dep not in parent:
                            parent[dep] = (cur,
                                           line if cur == root
                                           else parent[cur][1])
                            queue.append(dep)
