"""repro-lint for the port: an AST rule engine for repo-specific invariants
(port of ``repro/analysis/lint.py``; standard library only).

Rules ruff cannot express because they encode *this* codebase's contracts,
retargeted at ``src/repro_torch`` and its idiom:

* **RL001** — no wall-clock/ambient randomness in
  ``src/repro_torch/resilience/`` (the fault-clock code) or
  ``src/repro_torch/fleet/`` (the intermittency simulator):
  ``time.time``/``time_ns``, stdlib ``random``, ``datetime.now``, unseeded
  ``np.random`` calls, and torch's random draws (``torch.rand*``,
  ``normal``, ``bernoulli``, ``multinomial``) given no ``generator=`` all
  break the determinism contract that chaos runs and fleet studies are
  pure functions of (seed, mtbf/trace specs, submit order) on the logical
  work clock.
* **RL002** — no host syncs on device tensors in ``src/repro_torch``:
  ``.item()``, ``.cpu()``, ``float(torch...)`` / ``int(...)`` /
  ``bool(...)``, ``np.asarray(torch...)`` wait for the card and copy to
  the host; on the dispatch path they serialize the pipeline.  Where the
  wait is the point (a result handed back to its caller) the line says
  so in its suppression.
* **RL003** — no broad ``except Exception``/``BaseException``/bare
  ``except`` that swallows without a ``raise``.  A non-raising handler
  must either narrow the exception type or record the failure and carry an
  inline suppression stating why swallowing is the contract.
* **RL004** — every ``_lib.launcher(NAME, argtypes, suffix, restype)``
  call (the ctypes binding of a CUDA kernel) has an ``argtypes`` list
  that evaluates statically (list literals, ``+``, ``*`` by an int, and
  names bound by a simple assignment in the enclosing function) and
  matches the ``extern "C"`` signature of ``<NAME>_<suffix>`` in
  ``src/repro_torch/csrc/<library>.cu`` (the library from
  ``_lib.KERNELS``) in arity, in each parameter's kind (pointer, int,
  float, long long) and in return type.  A mismatch corrupts a launch
  silently; an ``argtypes`` the evaluator cannot read is reported as
  unverifiable, not skipped.
* **RL005** — engine-private state (underscore attributes of a
  non-``self`` object) is mutated only by its owner in
  ``launch/engine.py`` / ``resilience/engine.py``: the engines are
  single-threaded by contract and external writes to ``engine._pending``
  et al. bypass the accounting that the resilience checkpoints replay.

Suppression: append ``# repro-lint: disable=RL00X`` (comma list allowed)
to the offending line; ``# repro-lint: disable-file=RL00X`` in the first
ten lines silences a rule for the whole file.  Every suppression should
say why.  CLI: ``python -m repro_torch.analysis lint [paths...]``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re

RULES = {
    "RL001": "no wall-clock / ambient randomness in resilience/fleet "
             "fault-clock code",
    "RL002": "no host sync (float()/int()/bool()/.item()/.cpu()/"
             "np.asarray) on torch device tensors",
    "RL003": "no broad except that swallows without re-raise or recorded reason",
    "RL004": "ctypes launcher argtypes match the kernel's extern \"C\" "
             "signature",
    "RL005": "engine-private state mutated only by its owning engine",
}

# matched anywhere after a '#' on the line, so the pragma can ride along
# other tags ('# noqa: BLE001  repro-lint: disable=RL003 — why')
_SUPPRESS_LINE = re.compile(r"#.*repro-lint:\s*disable=([A-Za-z0-9_,]+)")
_SUPPRESS_FILE = re.compile(r"#.*repro-lint:\s*disable-file=([A-Za-z0-9_,]+)")

# RL001 allow-list: explicitly seeded constructors (call must pass a seed
# argument — checked at the call site).
_SEEDED_CTORS = {"RandomState", "default_rng", "Generator", "PRNGKey"}
# RL001: torch's random draws, each allowed only with an explicit generator
_TORCH_DRAWS = ("torch.normal", "torch.bernoulli", "torch.multinomial")

# RL005: container methods that mutate their receiver.
_MUTATORS = {"append", "appendleft", "extend", "update", "insert", "add",
             "remove", "discard", "pop", "popleft", "popitem", "clear",
             "setdefault"}

# RL004: where the kernel sources and the kernel -> library table live
_CSRC = "src/repro_torch/csrc"
_LIB_PY = "src/repro_torch/kernels/_lib.py"
# ctypes type -> the kind of C parameter it passes
_CTYPE_KINDS = {"c_void_p": "pointer", "c_char_p": "pointer",
                "c_int": "int", "c_int32": "int", "c_uint": "int",
                "c_float": "float", "c_double": "double",
                "c_longlong": "long long", "c_int64": "long long"}
_EXTERN_C = re.compile(r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b'
                       r'([A-Za-z_]\w*)\s*\(([^)]*)\)', re.S)


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"


def _dotted(node) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_torch(node) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "torch"
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# Rule checkers: (tree, rel, csrc) -> iterator of (node, message)
# ---------------------------------------------------------------------------

def _rl001(tree, rel, csrc):
    # fault-clock code AND the fleet simulator: a fleet study is a pure
    # function of (fleet seed, trace specs), same contract as chaos runs
    if not rel.startswith(("src/repro_torch/resilience/",
                           "src/repro_torch/fleet/")):
        return
    banned_calls = {"time.time", "time.time_ns", "time.monotonic",
                    "datetime.now", "datetime.utcnow",
                    "datetime.datetime.now", "datetime.datetime.utcnow"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = getattr(node, "module", None)
            names = [a.name for a in node.names]
            if mod == "random" or "random" in names:
                yield node, ("stdlib random imported — fault schedules "
                             "must come from a seeded np.random.RandomState")
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name is None:
            continue
        if name in banned_calls:
            yield node, (f"{name}() breaks the determinism contract: "
                         "chaos is a pure function of (seed, mtbf, submit "
                         "order) on the logical work clock")
        elif name.startswith("random."):
            yield node, (f"{name}() draws from ambient stdlib RNG state — "
                         "use the seeded fault-plan RandomState")
        elif (name.startswith(("np.random.", "numpy.random."))):
            leaf = name.rsplit(".", 1)[1]
            if leaf not in _SEEDED_CTORS:
                yield node, (f"{name}() uses the global numpy RNG — "
                             "construct a seeded RandomState instead")
            elif not (node.args or node.keywords):
                yield node, (f"{name}() without a seed argument is "
                             "entropy-seeded — pass the fault-plan seed")
        elif ((name.startswith("torch.rand") or name in _TORCH_DRAWS)
              and not any(kw.arg == "generator" for kw in node.keywords)):
            yield node, (f"{name}() without generator= draws from torch's "
                         "global RNG — pass a seeded torch.Generator")


def _rl002(tree, rel, csrc):
    if not rel.startswith("src/repro_torch/"):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and node.args and _mentions_torch(node.args[0])):
            yield node, (f"{node.func.id}() on a torch expression is a host "
                         "sync — it waits for the card and copies to the "
                         "host.  Keep the value on the device or suppress "
                         "with the reason it is off the dispatch path")
        name = _dotted(node.func)
        if (name in ("np.asarray", "np.array", "numpy.asarray",
                     "numpy.array")
                and node.args and _mentions_torch(node.args[0])):
            yield node, ("np.asarray on a torch expression forces a device "
                         "round trip — keep serve dataflow on the device")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in ("item", "cpu") and not node.args
                and not node.keywords):
            yield node, (f".{node.func.attr}() is a host sync — keep the "
                         "value on the device or suppress with the reason "
                         "it is off the dispatch path")


def _broad_handler(handler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [_dotted(e) for e in t.elts] if isinstance(t, ast.Tuple) \
        else [_dotted(t)]
    return any(n in ("Exception", "BaseException") for n in names)


def _rl003(tree, rel, csrc):
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler) or not _broad_handler(node):
            continue
        if any(isinstance(n, ast.Raise)
               for stmt in node.body for n in ast.walk(stmt)):
            continue
        yield node, ("broad except swallows without re-raise — narrow the "
                     "exception type, re-raise, or record the failure and "
                     "suppress with the reason")


# ---------------------------------------------------------------------------
# RL004: ctypes launchers against their extern "C" signatures
# ---------------------------------------------------------------------------

class _Unverifiable(Exception):
    """An expression the static evaluator does not read."""


class CSources:
    """The C side of RL004: each kernel's library (``_lib.KERNELS``, read
    from the source of ``kernels/_lib.py``) and the ``extern "C"``
    signatures of ``csrc/<library>.cu``.  ``texts`` ({library: source})
    stands in for the files (the tests' synthetic sources)."""

    def __init__(self, root: str | None = None, texts: dict | None = None):
        self.root = root or os.getcwd()
        self.texts = dict(texts or {})
        self._sigs: dict = {}
        self._kernels = None

    def kernels(self) -> dict:
        if self._kernels is None:
            self._kernels = {}
            path = os.path.join(self.root, _LIB_PY)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read())
                for node in tree.body:
                    if (isinstance(node, ast.Assign)
                            and [_dotted(t) for t in node.targets]
                            == ["KERNELS"]):
                        self._kernels = ast.literal_eval(node.value)
        return self._kernels

    def signatures(self, library: str) -> dict | None:
        """{function: (return kind, [parameter kinds])}, or None when the
        library has no source."""
        if library not in self._sigs:
            text = self.texts.get(library)
            path = os.path.join(self.root, _CSRC, f"{library}.cu")
            if text is None and os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            self._sigs[library] = None if text is None else {
                m.group(2): (_c_kind(m.group(1)),
                             [_c_kind(p) for p in _c_params(m.group(3))])
                for m in _EXTERN_C.finditer(text)}
        return self._sigs[library]


def _c_params(text: str) -> list[str]:
    params = [p.strip() for p in text.split(",") if p.strip()]
    return [] if params == ["void"] else params


def _c_kind(decl: str) -> str:
    """The kind of a C parameter or return type: ``pointer`` for any
    ``*``, else its type words less ``const`` and the parameter's name."""
    if "*" in decl:
        return "pointer"
    words = [w for w in decl.split() if w != "const"]
    if len(words) > 1 and words[-1] not in ("int", "long", "float",
                                            "double", "char", "void"):
        words = words[:-1]                      # the parameter's name
    return " ".join(words)


def _own_nodes(body):
    """Every node of ``body``'s statements outside nested functions,
    lambdas and classes (their bindings are their own)."""
    todo = list(body)
    while todo:
        node = todo.pop()
        yield node
        todo.extend(c for c in ast.iter_child_nodes(node)
                    if not isinstance(c, (ast.FunctionDef, ast.Lambda,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)))


def _bindings(body) -> dict:
    """Names bound by a simple assignment among ``body``'s statements
    (``x = e`` and ``a, b = e1, e2``); a name bound twice, or bound any
    other way, maps to None."""
    env: dict = {}

    def bind(name, value):
        env[name] = None if name in env else value

    for node in _own_nodes(body):
        if isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                             ast.With, ast.NamedExpr)):
            for n in ast.walk(getattr(node, "target", node)):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    bind(n.id, None)
            continue
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                bind(t.id, node.value)
            elif (isinstance(t, ast.Tuple) and isinstance(node.value,
                                                          ast.Tuple)
                  and len(t.elts) == len(node.value.elts)):
                for tt, vv in zip(t.elts, node.value.elts):
                    bind(tt.id, vv) if isinstance(tt, ast.Name) else None
            else:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        bind(n.id, None)
    return env


def _lookup(name: str, env: dict):
    if name not in env:
        raise _Unverifiable(f"{name!r} is not bound in the enclosing "
                            "function")
    if env[name] is None:
        raise _Unverifiable(f"{name!r} is not bound by one simple "
                            "assignment")
    return env[name]


def _ctype_kind(node, env: dict, depth: int = 0) -> str:
    if depth > 8:
        raise _Unverifiable("binding chain too deep")
    if isinstance(node, ast.Name):
        return _ctype_kind(_lookup(node.id, env), env, depth + 1)
    if isinstance(node, ast.Call) and _dotted(node.func) in (
            "ctypes.POINTER", "POINTER"):
        return "pointer"
    name = _dotted(node)
    leaf = name.rsplit(".", 1)[-1] if name else None
    if leaf in _CTYPE_KINDS and name in (leaf, f"ctypes.{leaf}"):
        return _CTYPE_KINDS[leaf]
    raise _Unverifiable(f"{ast.unparse(node)!r} is not a ctypes type the "
                        "evaluator knows")


def _argtype_kinds(node, env: dict, depth: int = 0) -> list[str]:
    """Statically evaluate an ``argtypes`` expression to parameter kinds:
    list literals, ``+``, ``*`` by an int, and bound names."""
    if depth > 8:
        raise _Unverifiable("binding chain too deep")
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_ctype_kind(e, env) for e in node.elts]
    if isinstance(node, ast.Name):
        return _argtype_kinds(_lookup(node.id, env), env, depth + 1)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_argtype_kinds(node.left, env, depth + 1)
                + _argtype_kinds(node.right, env, depth + 1))
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and type(n.value) is int:
                return _argtype_kinds(seq, env, depth + 1) * n.value
    raise _Unverifiable(f"{ast.unparse(node)!r} is not a list literal, a "
                        "sum of lists or a list times an int")


def _call_arg(node: ast.Call, pos: int, kw: str):
    if len(node.args) > pos:
        return node.args[pos]
    return next((k.value for k in node.keywords if k.arg == kw), None)


def _launcher_calls(tree):
    """(call, enclosing function's bindings) for every ``launcher(...)``."""
    module_env = _bindings(tree.body)
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seen = set()
    for fn in funcs:
        env = _bindings(fn.body)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and id(node) not in seen
                    and (_dotted(node.func) or "").rsplit(".", 1)[-1]
                    == "launcher"):
                seen.add(id(node))
                yield node, env, module_env
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and id(node) not in seen
                and (_dotted(node.func) or "").rsplit(".", 1)[-1]
                == "launcher"):
            yield node, module_env, module_env


def _check_launcher(node, env, module_env, csrc):
    """-> (C function, return kind, kinds) of one launcher call, or raise
    _Unverifiable / ValueError (a proven mismatch)."""
    kernel = _call_arg(node, 0, "kernel")
    if isinstance(kernel, ast.Name):
        kernel = module_env.get(kernel.id) or env.get(kernel.id)
    if not (isinstance(kernel, ast.Constant)
            and isinstance(kernel.value, str)):
        raise _Unverifiable("the kernel name is not a string constant")
    suffix = _call_arg(node, 2, "suffix")
    if suffix is None:
        suffix = "launch"
    elif isinstance(suffix, ast.Constant) and isinstance(suffix.value, str):
        suffix = suffix.value
    else:
        raise _Unverifiable("the suffix is not a string constant")
    argtypes = _call_arg(node, 1, "argtypes")
    if argtypes is None:
        raise _Unverifiable("no argtypes")
    kinds = _argtype_kinds(argtypes, env)
    restype = _call_arg(node, 3, "restype")
    ret = "int" if restype is None else _ctype_kind(restype, env)
    library = csrc.kernels().get(kernel.value)
    if library is None:
        raise ValueError(f"kernel {kernel.value!r} is not in _lib.KERNELS")
    sigs = csrc.signatures(library)
    if sigs is None:
        raise ValueError(f"no source {_CSRC}/{library}.cu for kernel "
                         f"{kernel.value!r}")
    fname = f"{kernel.value}_{suffix}"
    if fname not in sigs:
        raise ValueError(f'{_CSRC}/{library}.cu has no extern "C" '
                         f"{fname}")
    c_ret, c_kinds = sigs[fname]
    if len(c_kinds) != len(kinds):
        raise ValueError(f"argtypes give {fname} {len(kinds)} parameter(s), "
                         f"its C signature takes {len(c_kinds)}")
    for i, (got, want) in enumerate(zip(kinds, c_kinds)):
        if got != want:
            raise ValueError(f"{fname} parameter {i} is {want!r} in C but "
                             f"{got!r} in argtypes")
    if c_ret != ret:
        raise ValueError(f"{fname} returns {c_ret!r} in C but restype is "
                         f"{ret!r}")
    return fname, ret, kinds


def _rl004(tree, rel, csrc):
    if not rel.startswith("src/"):
        return
    for node, env, module_env in _launcher_calls(tree):
        try:
            _check_launcher(node, env, module_env, csrc)
        except _Unverifiable as e:
            yield node, (f"launcher argtypes not statically verifiable "
                         f"({e}) — the C signature cannot be proven")
        except ValueError as e:
            yield node, (f"{e} — a mismatched ctypes signature corrupts "
                         "the launch silently")


def launcher_signatures(paths, root: str | None = None) -> list[tuple]:
    """Every ``launcher`` call under ``paths`` that RL004 proves:
    ``(path, line, C function, return kind, parameter kinds)``."""
    csrc = CSources(root)
    out = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node, env, module_env in _launcher_calls(tree):
            try:
                sig = _check_launcher(node, env, module_env, csrc)
            except (_Unverifiable, ValueError):
                continue
            out.append((path, node.lineno) + sig)
    return out


def _rl005(tree, rel, csrc):
    if rel not in ("src/repro_torch/launch/engine.py",
                   "src/repro_torch/resilience/engine.py"):
        return
    msg = ("mutates engine-private state outside the owning engine — the "
           "single-threaded ownership contract keeps checkpoint replay "
           "consistent; route through an engine method")

    def _foreign_private(attr_node) -> bool:
        """True for `<non-self>._name`."""
        return (isinstance(attr_node, ast.Attribute)
                and attr_node.attr.startswith("_")
                and not attr_node.attr.startswith("__")
                and not (isinstance(attr_node.value, ast.Name)
                         and attr_node.value.id in ("self", "cls")))

    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AugAssign)
                       else node.targets)
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if _foreign_private(base):
                    yield node, msg
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _MUTATORS
              and _foreign_private(node.func.value)):
            yield node, msg


_CHECKERS = {"RL001": _rl001, "RL002": _rl002, "RL003": _rl003,
             "RL004": _rl004, "RL005": _rl005}


# ---------------------------------------------------------------------------
# Entry points: one source, one file, many paths
# ---------------------------------------------------------------------------

def _parse_suppressions(source: str):
    """(file-level set, {line: set}) of disabled rule IDs."""
    per_line: dict[int, set] = {}
    file_level: set = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_LINE.search(text)
        if m:
            per_line[i] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
        m = _SUPPRESS_FILE.search(text)
        if m and i <= 10:
            file_level |= {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
    return file_level, per_line


def lint_source(source: str, rel: str, path: str | None = None,
                csrc: CSources | None = None) -> list[LintViolation]:
    """Lint one file's source.  ``rel`` is the repo-relative posix path the
    rule scoping keys on; ``path`` is what violations display; ``csrc``
    the C side RL004 reads (default: the sources under the working
    directory)."""
    path = path or rel
    csrc = csrc or CSources()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [LintViolation(path, e.lineno or 0, e.offset or 0, "RL000",
                              f"syntax error: {e.msg}")]
    file_sup, line_sup = _parse_suppressions(source)
    out = []
    for rule, checker in sorted(_CHECKERS.items()):
        if rule in file_sup:
            continue
        for node, message in checker(tree, rel, csrc):
            line = getattr(node, "lineno", 0)
            if rule in line_sup.get(line, ()):
                continue
            out.append(LintViolation(path, line,
                                     getattr(node, "col_offset", 0) + 1,
                                     rule, message))
    return sorted(out, key=lambda v: (v.path, v.line, v.col, v.rule))


def lint_file(path: str, root: str | None = None,
              csrc: CSources | None = None) -> list[LintViolation]:
    root = root or os.getcwd()
    rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel, path, csrc or CSources(root))


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache__")))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def lint_paths(paths, root: str | None = None) -> list[LintViolation]:
    csrc = CSources(root)
    out = []
    for path in iter_py_files(paths):
        out.extend(lint_file(path, root, csrc))
    return out
