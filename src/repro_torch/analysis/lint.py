"""FL-specific source lints (AST pass) for bug classes the system has
paid for.  Run as ``python -m repro_torch.analysis lint`` (the port's
package by default; also in the CPU tests, ``tests/test_torch_analysis.py``).

The port's own copy of the reference's engine (``repro.analysis.lint``):
``Finding``, ``# noqa: <rule>`` handling, ``lint_source`` and
``lint_paths``.  Its rules:

  * ``bare-assert``, the reference's as it is;
  * ``import-time-device``, the reference's ``import-time-jnp`` in the
    port's terms: a module-scope call that touches ``torch.cuda`` or
    makes a tensor on a device.

The reference's ``traced-random-split`` and ``host-sync-in-program`` look
inside ``jax.jit`` bodies, for a key split or a host conversion that a
trace would bake into a compiled program.  The port compiles no program
(it runs eagerly, and its kernels are launched through ``ctypes``), so
those rules have nothing to look at and are left out.

Suppress a finding with ``# noqa: <rule-id>`` (or a bare ``# noqa``) on
the offending line.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[\w\-, ]+))?", re.IGNORECASE)


@dataclass(frozen=True)
class Finding:
    """One lint violation."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _suppressed(src_lines: Sequence[str], line: int, rule: str) -> bool:
    if not 1 <= line <= len(src_lines):
        return False
    m = _NOQA_RE.search(src_lines[line - 1])
    if m is None:
        return False
    codes = m.group("codes")
    if codes is None:
        return True
    return rule in {c.strip() for c in codes.split(",")}


# --------------------------------------------------------------------------
# rule: bare-assert
# --------------------------------------------------------------------------

def check_bare_assert(tree: ast.Module, path: str,
                      src_lines: Sequence[str]) -> List[Finding]:
    """No bare ``assert`` for input validation outside kernels.

    ``assert`` vanishes under ``python -O``: a checkpoint validated that
    way loads corrupt structures silently.  Validation must raise
    ``ValueError``/``TypeError`` with the offending value in the message.
    Kernel-internal asserts (``kernels/``) are exempt: they are developer
    invariants on shapes, not input validation.
    """
    rule = "bare-assert"
    norm = path.replace("\\", "/")
    if "/kernels/" in norm or norm.startswith("kernels/"):
        return []
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert) \
                and not _suppressed(src_lines, node.lineno, rule):
            out.append(Finding(
                path, node.lineno, node.col_offset, rule,
                "bare assert is stripped under python -O; raise "
                "ValueError with the offending value instead"))
    return out


# --------------------------------------------------------------------------
# rule: import-time-device
# --------------------------------------------------------------------------

def _device_call(node: ast.Call) -> Optional[str]:
    """What a call does to a device, or None: ``torch.cuda.*``, a
    ``torch.*`` call given ``device=``, ``.cuda()`` or ``.to(device=)``."""
    name = _dotted(node.func) or ""
    if name.startswith("torch.cuda."):
        return f"{name}(...)"
    keywords = {k.arg for k in node.keywords}
    if name.startswith("torch.") and "device" in keywords:
        return f"{name}(device=...)"
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda":
            return ".cuda()"
        if node.func.attr == "to" and ("device" in keywords or any(
                isinstance(a, ast.Constant) and isinstance(a.value, str)
                for a in node.args)):
            return ".to(<device>)"
    return None


def check_import_time_device(tree: ast.Module, path: str,
                             src_lines: Sequence[str]) -> List[Finding]:
    """No device work at module import time.

    The port imports on machines without a card (its CPU tests import
    every module) and builds nothing on import (``kernels.build``): a
    module-scope ``torch.cuda`` call or a tensor made on a device raises
    there, or initializes CUDA in a parent process before it spawns the
    ranks of a mesh.  Such constants belong inside functions.
    """
    rule = "import-time-device"
    out: List[Finding] = []

    def scan(body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.ClassDef):
                scan(stmt.body)
                continue
            deferred = set()
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    # deferred bodies don't run at import
                    deferred.update(id(n) for n in ast.walk(node))
                    continue
                if id(node) in deferred or not isinstance(node, ast.Call):
                    continue
                what = _device_call(node)
                if what and not _suppressed(src_lines, node.lineno, rule):
                    out.append(Finding(
                        path, node.lineno, node.col_offset, rule,
                        f"{what} at module import time touches a device; "
                        f"the port must import without a card"))

    scan(tree.body)
    return out


RULES = (check_bare_assert, check_import_time_device)


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Run every rule over one source string."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "syntax-error",
                        str(e.msg))]
    lines = src.splitlines()
    out: List[Finding] = []
    for rule in RULES:
        out.extend(rule(tree, path, lines))
    return sorted(out, key=lambda f: (f.path, f.line, f.col))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every ``*.py`` under the given files/directories."""
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        else:
            files.append(pp)
    out: List[Finding] = []
    for f in files:
        out.extend(lint_source(f.read_text(), str(f)))
    return out
