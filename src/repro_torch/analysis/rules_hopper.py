"""hopper-budget: every CUDA kernel fits an H100 SM's budgets, the
counterpart of the reference's ``rules_pallas.py`` (DESIGN.md §12.7).

A kernel that asks for more shared memory than an SM gives a block is
refused at *launch*, on the card, long after the CPU tests that merged it
passed; a kernel that spills runs its spilled values through local memory.
This rule prices each kernel of ``csrc/*.cu`` against the budgets of
compute capability 9.0:

  * registers ≤ 255 a thread, and registers × the block's threads ≤
    65,536, the SM's register file;
  * static plus dynamic shared memory ≤ 227 KB (232,448 bytes) a block;
  * spill stores and loads 0.

It prices a kernel two ways:

* From its launches on the path (``launches``): what the card recorded of
  each launch — registers a thread, the block's threads and the static
  plus dynamic shared memory the launch took — as ``torch.profiler``'s
  trace gives them (``parse_trace``; ``chip_smoke.py`` records the traces
  of its kernel timings at the path's shapes, ``tools/torch_lint.py
  --launches FILE`` reads them back). A launch over a budget is a finding
  whatever the source says, so a kernel whose sizes come from a runtime
  value (a row's width) is held to the sizes the path asks for.
* From the ``ptxas -v`` record of each instantiation ``kernels/_build.py``
  compiled (registers, static shared memory, spills, ``parse_ptxas``) and
  the source. The thread count is the kernel's ``__launch_bounds__`` (else
  its launch's block size); the dynamic shared memory the third launch
  argument (none without an ``extern __shared__``). Both are evaluated as
  C++ constant expressions (``_Source.value``): literals, ``constexpr``
  and ``const`` integers of the file, its headers and the launching
  function, names qualified by any namespace of the source, the kernel's
  template parameters bound from the instantiation's mangled name, static
  members of structs and struct templates and aliases of them, ``sizeof``
  of a scalar type, a bound type parameter or a struct of arrays, casts,
  arithmetic, comparisons and ``?:``. Where a size still depends on a
  runtime value and no launch on the path priced that instantiation, it
  cannot be priced, and that is itself a finding, as an unpriceable
  symbolic dim is for the reference's rule: an unpriceable kernel is an
  unreviewable kernel.

The rule has no ``.py`` file to check: it runs in ``finalize`` over the
ptxas records it was given (``{source stem: log text}``; ``chip_smoke.py``
passes this run's, ``tools/torch_lint.py --ptxas-log DIR`` a directory's
``<stem>[-<hash>].log`` files). A finding's path is the kernel's source,
its line the kernel's ``__global__`` declaration, its message the sizes,
and its fingerprint the kernel and the budget only, so every
instantiation of a template counts once against the baseline, and a
kernel over a budget is new even where the baseline holds it as
unpriced.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.engine import Finding, Rule

#: compute capability 9.0's budgets
MAX_REGISTERS = 255
REGISTER_FILE = 65_536
SMEM_PER_BLOCK = 232_448          # 227 KB
#: where the kernel sources live, relative to the repository root
CSRC = "src/repro_torch/csrc"

_SIZEOF = {"float": 4, "int": 4, "unsigned": 4, "unsigned int": 4,
           "uint32_t": 4, "int32_t": 4, "float2": 8, "float4": 16,
           "uint4": 16, "double": 8, "long": 8, "unsigned long": 8,
           "long long": 8, "unsigned long long": 8, "int64_t": 8,
           "uint64_t": 8, "size_t": 8, "__nv_bfloat16": 2, "half": 2,
           "__half": 2, "short": 2, "unsigned short": 2, "int16_t": 2,
           "uint16_t": 2, "uint8_t": 1, "int8_t": 1, "char": 1,
           "unsigned char": 1, "bool": 1}
# one-letter builtin types of the Itanium mangling
_MANGLED = {"f": "float", "d": "double", "i": "int", "j": "unsigned int",
            "l": "long", "m": "unsigned long", "x": "long long",
            "y": "unsigned long long", "b": "bool", "c": "char",
            "h": "unsigned char", "s": "short", "t": "unsigned short"}
_TOKEN = re.compile(r"\s*(0[xX][0-9a-fA-F]+[uUlL]*|\d+[uUlL]*|[A-Za-z_]\w*|"
                    r"::|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%<>()?:,!~&|^.\[\]])")
_BINARY = {"||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
           "<": 7, "<=": 7, ">": 7, ">=": 7, "<<": 8, ">>": 8, "+": 9,
           "-": 9, "*": 10, "/": 10, "%": 10}
_LOCAL = re.compile(r"(?:static\s+)?(?:constexpr|const)\s+(?:static\s+)?"
                    r"(?:unsigned\s+)?[\w:]+\s+(\w+)\s*=\s*([^;{}]+);")
_USING = re.compile(r"\busing\s+(\w+)\s*=\s*([^;]+);")


class _Unpriced(Exception):
    """An expression names something the source does not fix."""


def parse_ptxas(text: str) -> Dict[str, dict]:
    """{mangled kernel name: registers, smem_static_bytes, stack_bytes,
    spill_store_bytes, spill_load_bytes} of a ``ptxas -v`` log."""
    out: Dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "smem_static_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[name]["smem_static_bytes"] = int(m.group(1))
    return out


def parse_trace(trace) -> List[dict]:
    """The kernel launches of a ``torch.profiler`` chrome trace (the
    exported JSON, or its ``traceEvents``): one ``{"kernel": demangled
    name, "registers", "threads", "smem_bytes"}`` a launch, where
    ``smem_bytes`` is the static plus dynamic shared memory the launch
    took, as CUPTI records it."""
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    out = []
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") != "kernel" or "shared memory" not in args:
            continue
        out.append({"kernel": ev.get("name", ""),
                    "registers": int(args.get("registers per thread", 0)),
                    "threads": int(math.prod(args.get("block", [1]))),
                    "smem_bytes": int(args["shared memory"])})
    return out


def _mangled_parts(mangled: str) -> Tuple[str, int]:
    """(the function's own name, the offset just past it) of an
    Itanium-mangled symbol; the last component of a nested ``_ZN...E``
    name."""
    s, i = mangled, 2
    nested = s.startswith("N", i)
    i += nested
    last, end = mangled, len(mangled)
    while True:
        m = re.match(r"(\d+)", s[i:])
        if not m:
            break
        n = int(m.group(1))
        start = i + len(m.group(1))
        last, end = s[start:start + n], start + n
        i = end
        if not nested:
            break
    return last, end


def kernel_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled kernel symbol
    (``_Z16fwht_kernel_wideIfLi10EEvPKT_PS0_f`` → ``fwht_kernel_wide``;
    the last component of a nested ``_ZN...E`` name); an unmangled
    ``extern "C"`` name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    return _mangled_parts(mangled)[0]


def template_args(mangled: str) -> Optional[Tuple[str, ...]]:
    """The template arguments of a mangled kernel symbol, as a demangler
    spells them (``_Z16fwht_kernel_wideIfLi10EEvPKT_PS0_f`` → ``("float",
    "10")``; a bool ``true``/``false``); ``()`` for a plain function,
    None where they use a form this reader does not know."""
    if not mangled.startswith("_Z"):
        return ()
    _, i = _mangled_parts(mangled)
    s = mangled
    if not s.startswith("I", i):
        return ()
    i += 1
    out: List[str] = []
    while i < len(s) and s[i] != "E":
        if s[i] == "L":                          # a literal: L<type><value>E
            m = re.match(r"L([a-z])(n?)(\d+)E", s[i:])
            if not m:
                return None
            v = int(m.group(3)) * (-1 if m.group(2) else 1)
            out.append(("true" if v else "false") if m.group(1) == "b"
                       else str(v))
            i += m.end()
        elif s[i].isdigit():                     # a named type
            m = re.match(r"(\d+)", s[i:])
            n, start = int(m.group(1)), i + len(m.group(1))
            out.append(s[start:start + n])
            i = start + n
        elif s[i] in _MANGLED:
            out.append(_MANGLED[s[i]])
            i += 1
        else:
            return None
    return tuple(out)


def _top_split(s: str, sep: str = ",") -> List[str]:
    out, depth, cur = [], 0, ""
    for ch in s:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == sep and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def _norm_arg(a: str) -> str:
    a = re.sub(r"^\(\s*[\w ]+\)\s*", "", a.strip())       # (unsigned)3
    m = re.fullmatch(r"(-?\d+)[uUlL]*", a)
    return str(int(m.group(1))) if m else re.sub(r"\s+", " ", a)


def launch_key(name: str) -> Tuple[str, Optional[Tuple[str, ...]]]:
    """(kernel name, template arguments) of a demangled launch name, as
    ``torch.profiler`` spells it (``void (anonymous namespace)::
    fwht_kernel_wide<float, 10>(float const*, float*, float)`` →
    ``("fwht_kernel_wide", ("float", "10"))``), to match
    ``template_args`` of the ptxas record it launched."""
    s = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    head = s[:cut].strip()
    args: Tuple[str, ...] = ()
    if head.endswith(">"):
        depth = 0
        for i in range(len(head) - 1, -1, -1):
            depth += (head[i] == ">") - (head[i] == "<")
            if depth == 0:
                args = tuple(_norm_arg(a) for a in _top_split(head[i + 1:-1]))
                head = head[:i]
                break
    return re.split(r"[\s:]+", head.strip())[-1], args


def read_logs(directory: str) -> Dict[str, str]:
    """{source stem: log text} of a directory's ``<stem>[-<hash>].log``
    files (``kernels/_build.py`` keeps ``build/<stem>-<hash>.log``); of
    several logs of one stem, the newest."""
    found: Dict[str, Tuple[float, str]] = {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".log"):
            continue
        base = fname[:-4]
        stem, _, tail = base.rpartition("-")
        if not stem or not re.fullmatch(r"[0-9a-f]{8,}", tail):
            stem = base
        path = os.path.join(directory, fname)
        mtime = os.path.getmtime(path)
        if stem not in found or mtime > found[stem][0]:
            with open(path, "r", encoding="utf-8") as fh:
                found[stem] = (mtime, fh.read())
    return {k: v for k, (_, v) in found.items()}


class _Struct:
    """A struct (or struct template) of the source: its template
    parameters, its ``static constexpr`` members, its data members and
    its ``alignas``."""

    def __init__(self, params: List[Tuple[str, str]], body: str,
                 align: int):
        self.params = params
        self.align = align
        self.consts: Dict[str, str] = {}
        self.fields: List[Tuple[str, List[str]]] = []
        for stmt in body.split(";"):
            stmt = " ".join(stmt.split())
            if not stmt or stmt.startswith(("static_assert", "//")):
                continue
            m = re.match(r"static\s+constexpr\s+[\w:]+\s+(\w+)\s*=\s*(.+)",
                         stmt)
            if m:
                self.consts[m.group(1)] = m.group(2)
                continue
            m = re.match(r"(?:const\s+)?((?:unsigned\s+)?[\w:]+)\s+(.+)",
                         stmt)
            if m and "(" not in stmt:
                for decl in _top_split(m.group(2)):
                    dims = re.findall(r"\[([^\]]+)\]", decl)
                    self.fields.append((m.group(1), dims))


def _template_params(text: str) -> List[Tuple[str, str]]:
    """[(kind, name)] of a ``template <...>`` parameter list: kind
    ``typename`` or the value's type."""
    out = []
    for p in _top_split(text):
        p = p.split("=")[0].strip()
        m = re.match(r"(typename|class|[\w:]+)\s+(\w+)$", p)
        if m:
            out.append(("typename" if m.group(1) in ("typename", "class")
                        else m.group(1), m.group(2)))
    return out


class _Source:
    """A kernel source and its local headers: the constants, namespaces,
    structs and aliases, the ``__global__`` declarations and the launch
    sites."""

    def __init__(self, root: str, stem: str):
        self.rel = f"{CSRC}/{stem}.cu"
        path = os.path.join(root, self.rel)
        self.text = ""
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                self.text = fh.read()
        headers = ""
        for inc in re.findall(r'#include\s+"([^"]+)"', self.text):
            hp = os.path.join(root, CSRC, inc)
            if os.path.exists(hp):
                with open(hp, "r", encoding="utf-8") as fh:
                    headers += fh.read() + "\n"
        code = re.sub(r"//[^\n]*", "", headers + self.text)
        self.namespaces = set(re.findall(r"\bnamespace\s+(\w+)\s*\{", code))
        self.structs: Dict[str, _Struct] = {}
        for m in re.finditer(r"(?:template\s*<([^<>]*)>\s*)?struct\s+"
                             r"(?:alignas\((\d+)\)\s+)?(\w+)\s*\{", code):
            body = _braced(code, m.end() - 1)
            self.structs.setdefault(m.group(3), _Struct(
                _template_params(m.group(1) or ""), body,
                int(m.group(2) or 1)))
        # file-scope constants: those outside any function body
        outer = _outside_functions(code)
        self.consts: Dict[str, str] = {}
        for name, expr in _LOCAL.findall(outer):
            self.consts.setdefault(name, expr.strip())
        self.aliases: Dict[str, str] = dict(_USING.findall(outer))
        self.lines = self.text.splitlines()

    # -- constant expressions ------------------------------------------------

    def value(self, expr: str, env: Optional[dict] = None,
              local: str = "") -> Optional[int]:
        """The integer value of a C++ constant expression, or None where it
        names anything the source does not fix. ``env`` binds template
        parameters (a type's name or an integer); ``local`` is the text of
        the function around the expression, whose constants and aliases
        come before the file's."""
        scope = _Scope(self, dict(env or {}), local)
        try:
            return scope.eval(expr)
        except (_Unpriced, ArithmeticError, RecursionError):
            return None

    # -- a kernel's declaration and launches -----------------------------------

    def declaration(self, name: str) -> Tuple[int, str, bool]:
        """(line of the ``__global__`` declaring ``name``, its
        ``__launch_bounds__`` thread expression or '', whether its body
        declares ``extern __shared__``)."""
        line, bounds, dynamic, _ = self._declaration(name)
        return line, bounds, dynamic

    def _declaration(self, name: str):
        starts = [i for i, ln in enumerate(self.lines) if "__global__" in ln]
        for k, i in enumerate(starts):
            head = " ".join(self.lines[i:i + 3])
            if not re.search(r"\b" + re.escape(name) + r"\s*\(", head):
                continue
            bounds = ""
            at = head.find("__launch_bounds__")
            if at >= 0:
                inner, depth = "", 0
                for ch in head[head.index("(", at):]:
                    depth += (ch == "(") - (ch == ")")
                    inner += ch
                    if depth == 0:
                        break
                bounds = _top_split(inner[1:-1])[0]
            params: List[Tuple[str, str]] = []
            before = " ".join(self.lines[max(i - 2, 0):i])
            m = re.search(r"template\s*<([^<>]*)>\s*$", before)
            if m:
                params = _template_params(m.group(1))
            end = starts[k + 1] if k + 1 < len(starts) else len(self.lines)
            body = "\n".join(self.lines[i:end])
            return i + 1, bounds, "extern __shared__" in body, params
        return 1, "", True, []

    def launches(self, name: str) -> List[Tuple[List[str], str]]:
        """The launch configurations (``<<<grid, block, smem, stream>>>``
        split at top-level commas) of ``name``, directly or through a
        variable last assigned from it, each with the text of its
        function up to the launch."""
        out = []
        for m in re.finditer(r"\b(\w+)\s*(?:<[^;{}]*?>)?\s*<<<(.*?)>>>",
                             self.text, flags=re.S):
            local = self.text[self.text.rfind("\n}", 0, m.start()) + 1:
                              m.start()]
            callee = m.group(1)
            if callee != name:
                assigned = re.findall(r"\b(?:auto|const auto)\s+" + callee
                                      + r"\s*=\s*([^;]+);", local)
                if not assigned or not re.search(
                        r"\b" + re.escape(name) + r"\b", assigned[-1]):
                    continue
            out.append((_top_split(m.group(2)), local))
        return out


class _Scope:
    """One evaluation: the source, the bound template parameters, and the
    local text whose constants and aliases shadow the file's."""

    def __init__(self, src: _Source, env: dict, local: str = "",
                 struct: Optional[_Struct] = None):
        self.src, self.env, self.struct = src, env, struct
        self.local_consts = dict(_LOCAL.findall(local)) if local else {}
        self.local_aliases = dict(_USING.findall(local)) if local else {}
        self.depth = 0

    # -- the parser: tokens → an integer -------------------------------------

    def eval(self, expr: str) -> int:
        self.depth += 1
        if self.depth > 32:
            raise _Unpriced(expr)
        toks = _tokens(expr)
        self.toks, self.i = toks, 0
        v = self._ternary()
        if self.i != len(toks):
            raise _Unpriced(expr)
        self.depth -= 1
        return v

    def _peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def _take(self, want: Optional[str] = None) -> str:
        t = self._peek()
        if not t or (want is not None and t != want):
            raise _Unpriced(want or "end")
        self.i += 1
        return t

    def _ternary(self) -> int:
        c = self._binary(1)
        if self._peek() != "?":
            return c
        self._take("?")
        a = self._ternary()
        self._take(":")
        b = self._ternary()
        return a if c else b

    def _binary(self, prec: int) -> int:
        left = self._unary()
        while self._peek() in _BINARY and _BINARY[self._peek()] >= prec:
            op = self._take()
            right = self._binary(_BINARY[op] + 1)
            left = _apply(op, left, right)
        return left

    def _unary(self) -> int:
        t = self._peek()
        if t in ("-", "+", "!", "~"):
            self._take()
            v = self._unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[t]
        if t == "(":
            cast = self._cast()
            if cast:
                return self._unary()
            self._take("(")
            v = self._ternary()
            self._take(")")
            return v
        return self._primary()

    def _cast(self) -> bool:
        """Skips a C cast ``(type)`` at the cursor; False where the
        parenthesis opens an expression."""
        j, words = self.i + 1, []
        while j < len(self.toks) and re.fullmatch(r"[A-Za-z_]\w*",
                                                  self.toks[j]):
            words.append(self.toks[j])
            j += 1
        if j < len(self.toks) and self.toks[j] == ")" and words \
                and self._type_size(" ".join(words)) is not None:
            self.i = j + 1
            return True
        return False

    def _primary(self) -> int:
        t = self._take()
        m = re.fullmatch(r"(0[xX][0-9a-fA-F]+|\d+)[uUlL]*", t)
        if m:
            return int(m.group(1), 0)
        if t in ("true", "false"):
            return int(t == "true")
        if t == "sizeof":
            self._take("(")
            words = []
            while self._peek() not in (")", ""):
                words.append(self._take())
            self._take(")")
            size = self._type_size(" ".join(words))
            if size is None:
                raise _Unpriced(f"sizeof({' '.join(words)})")
            return size
        if not re.fullmatch(r"[A-Za-z_]\w*", t):
            raise _Unpriced(t)
        # a (namespace-, struct- or alias-) qualified name
        parts = [t]
        targs: Optional[List[str]] = None
        if self._peek() == "<" and self._is_template(t):
            targs = self._template_args()
        while self._peek() == "::":
            self._take("::")
            parts.append(self._take())
        return self._name(parts, targs)

    def _is_template(self, name: str) -> bool:
        s = self.src.structs.get(name)
        return s is not None and bool(s.params)

    def _template_args(self) -> List[str]:
        self._take("<")
        depth, cur, args = 0, [], []
        while True:
            t = self._take()
            if t in ("<", "("):
                depth += 1
            elif t in (">", ")"):
                if depth == 0 and t == ">":
                    args.append(" ".join(cur))
                    return args
                depth -= 1
            if t == "," and depth == 0:
                args.append(" ".join(cur))
                cur = []
            else:
                cur.append(t)

    # -- names -----------------------------------------------------------------

    def _name(self, parts: List[str], targs: Optional[List[str]]) -> int:
        while len(parts) > 1 and parts[0] in self.src.namespaces:
            parts = parts[1:]
        if len(parts) == 1 and targs is None:
            return self._constant(parts[0])
        if len(parts) != 2:
            raise _Unpriced("::".join(parts))
        struct, env = self._struct(parts[0], targs)
        if parts[1] not in struct.consts:
            raise _Unpriced("::".join(parts))
        return _Scope(self.src, env, struct=struct).eval(
            struct.consts[parts[1]])

    def _constant(self, name: str) -> int:
        if name in self.env:
            v = self.env[name]
            if isinstance(v, int):
                return v
            raise _Unpriced(name)                 # a type where a value is due
        if self.struct is not None and name in self.struct.consts:
            return _Scope(self.src, self.env, struct=self.struct).eval(
                self.struct.consts[name])
        for table in (self.local_consts, self.src.consts):
            if name in table:
                return _Scope(self.src, self.env if table is
                              self.local_consts else {}).eval(table[name])
        raise _Unpriced(name)

    def _struct(self, name: str, targs: Optional[List[str]]):
        """(the struct ``name`` names, its template parameters bound)."""
        alias = self.local_aliases.get(name) or self.src.aliases.get(name)
        if alias is not None and targs is None:
            toks = _tokens(alias)
            sub = _Scope(self.src, self.env)
            sub.toks, sub.i = toks, 1
            name = toks[0]
            targs = sub._template_args() if len(toks) > 1 else None
        struct = self.src.structs.get(name)
        if struct is None:
            raise _Unpriced(name)
        env: dict = {}
        for (kind, pname), arg in zip(struct.params, targs or []):
            if kind == "typename":
                env[pname] = self._type_name(arg)
            else:
                env[pname] = _Scope(self.src, self.env).eval(arg)
        if len(env) != len(struct.params):
            raise _Unpriced(name)
        return struct, env

    def _type_name(self, t: str) -> str:
        t = " ".join(t.split())
        v = self.env.get(t)
        return v if isinstance(v, str) else t

    def _type_size(self, t: str) -> Optional[int]:
        t = " ".join(t.replace("const", "").split())
        t = self._type_name(t)
        if t in _SIZEOF:
            return _SIZEOF[t]
        struct = self.src.structs.get(t)
        if struct is None or struct.params:
            return None
        try:
            return self._layout(struct)
        except (_Unpriced, ArithmeticError):
            return None

    def _layout(self, struct: _Struct) -> int:
        """sizeof a struct of scalars and arrays of them: each member at
        its type's alignment, the whole rounded to the largest alignment
        (or its ``alignas``)."""
        off, align = 0, struct.align
        for typ, dims in struct.fields:
            size = _SIZEOF.get(self._type_name(typ))
            if size is None:
                raise _Unpriced(typ)
            n = 1
            for d in dims:
                n *= _Scope(self.src, self.env, struct=struct).eval(d)
            off = -(-off // size) * size + size * n
            align = max(align, size)
        return -(-off // align) * align


def _bind(params: List[Tuple[str, str]],
          args: Optional[Tuple[str, ...]]) -> dict:
    """A kernel's template parameters bound to an instantiation's
    arguments: a type's name, or an integer; {} where they do not fit."""
    if args is None or len(args) != len(params):
        return {}
    env: dict = {}
    for (kind, pname), a in zip(params, args):
        if kind == "typename":
            env[pname] = a
        elif a in ("true", "false"):
            env[pname] = int(a == "true")
        elif re.fullmatch(r"-?\d+", a):
            env[pname] = int(a)
        else:
            return {}
    return env


def _apply(op: str, a: int, b: int) -> int:
    # both arms of a ?: are evaluated; a shift or a division a compiler
    # would refuse can stand only in the arm not taken
    if (op in ("<<", ">>") and b < 0) or (op in ("/", "%") and b == 0):
        return 0
    if op in ("/", "%"):
        q = abs(a) // abs(b) * (1 if (a >= 0) == (b >= 0) else -1)
        return q if op == "/" else a - q * b
    return {"||": lambda: int(bool(a or b)), "&&": lambda: int(bool(a and b)),
            "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
            "==": lambda: int(a == b), "!=": lambda: int(a != b),
            "<": lambda: int(a < b), "<=": lambda: int(a <= b),
            ">": lambda: int(a > b), ">=": lambda: int(a >= b),
            "<<": lambda: a << b, ">>": lambda: a >> b, "+": lambda: a + b,
            "-": lambda: a - b, "*": lambda: a * b}[op]()


def _tokens(expr: str) -> List[str]:
    out, i = [], 0
    expr = expr.strip()
    while i < len(expr):
        m = _TOKEN.match(expr, i)
        if not m:
            raise _Unpriced(expr)
        out.append(m.group(1))
        i = m.end()
        while i < len(expr) and expr[i].isspace():
            i += 1
    return out


def _braced(text: str, open_at: int) -> str:
    """The text inside the braces that open at ``open_at``."""
    depth = 0
    for j in range(open_at, len(text)):
        depth += (text[j] == "{") - (text[j] == "}")
        if depth == 0:
            return text[open_at + 1:j]
    return text[open_at + 1:]


def _outside_functions(code: str) -> str:
    """``code`` less the bodies of its functions: what namespaces and
    structs hold at file scope."""
    out, keep = [], [True]
    for i, ch in enumerate(code):
        if ch == "{":
            head = code[max(0, i - 200):i]
            scope = bool(re.search(r"(?:namespace\s*\w*|struct\s+[^;{}]*|"
                                   r"extern\s+\"C\")\s*$", head))
            keep.append(keep[-1] and scope)
        elif ch == "}":
            keep = keep[:-1] or [True]
        elif keep[-1]:
            out.append(ch)
    return "".join(out)


class HopperBudgetRule(Rule):
    name = "hopper-budget"
    doc = ("every CUDA kernel's ptxas record and its launches on the path "
           "fit the H100's registers, register file and shared memory a "
           "block, spill nothing, and its dynamic shared memory and threads "
           "can be priced")

    def __init__(self, ptxas_logs: Optional[Dict[str, str]] = None,
                 root: str = ".", launches: Optional[List[dict]] = None):
        self.ptxas_logs = dict(ptxas_logs or {})
        self.root = root
        self.launches = list(launches or [])

    def finalize(self) -> Iterable[Finding]:
        sources, records = {}, []
        for stem in sorted(self.ptxas_logs):
            src = sources[stem] = _Source(self.root, stem)
            for mangled, rec in parse_ptxas(self.ptxas_logs[stem]).items():
                records.append((src, mangled, rec))
        names = {kernel_name(m): src for src, m, _ in records}
        launched = self._launched(names)
        for (src, name, _), rows in sorted(launched.items(),
                                           key=lambda kv: kv[0][1:]):
            yield from self._price_launches(src, name, rows)
        priced = {(name, args) for _, name, args in launched}
        for src, mangled, rec in records:
            key = (kernel_name(mangled), template_args(mangled))
            yield from self._price(src, mangled, rec, key in priced)

    def _launched(self, names: dict) -> dict:
        """{(source, kernel name, template arguments): [launch records]} of
        the launches of this rule's kernels."""
        out: dict = {}
        for row in self.launches:
            name, args = launch_key(row.get("kernel", ""))
            if name in names:
                out.setdefault((names[name], name, args), []).append(row)
        return out

    def _finding(self, src: _Source, name: str, label: str, check: str,
                 message: str) -> Finding:
        line = src.declaration(name)[0]
        return Finding(rule=self.name, path=src.rel, line=line, col=0,
                       message=f"{label}: {message}",
                       snippet=f"{name}: {check}")

    def _price_launches(self, src: _Source, name: str,
                        rows: List[dict]) -> Iterable[Finding]:
        label = launch_key(rows[0]["kernel"])
        label = f"{name}<{', '.join(label[1])}>" if label[1] else name
        smem = max(r["smem_bytes"] for r in rows)
        regs = max(r["registers"] * r["threads"] for r in rows)
        if smem > SMEM_PER_BLOCK:
            yield self._finding(src, name, label, "shared memory",
                                f"a launch on the path took {smem} bytes of "
                                f"shared memory (static + dynamic), over the "
                                f"{SMEM_PER_BLOCK} a block may take")
        if regs > REGISTER_FILE:
            yield self._finding(src, name, label, "register file",
                                f"a launch on the path took {regs} registers "
                                f"(registers × threads), over the SM's "
                                f"{REGISTER_FILE}")

    def _price(self, src: _Source, mangled: str, rec: dict,
               launched: bool) -> Iterable[Finding]:
        name = kernel_name(mangled)
        _, bounds, dynamic_smem, params = src._declaration(name)
        env = _bind(params, template_args(mangled))

        def finding(check: str, message: str) -> Finding:
            return self._finding(src, name, f"{name} ({mangled})", check,
                                 message)

        regs = rec.get("registers") or 0
        if regs > MAX_REGISTERS:
            yield finding("registers", f"{regs} registers a thread, over "
                          f"the {MAX_REGISTERS} a thread can address")
        sites = src.launches(name)
        threads = src.value(bounds, env) if bounds else None
        if threads is None and not bounds:
            sizes = {src.value(cfg[1], env, local) for cfg, local in sites
                     if len(cfg) > 1}
            threads = sizes.pop() if len(sizes) == 1 else None
        if threads is None and not launched:
            yield finding("threads unpriced", "its block's thread count "
                          "cannot be priced from the source's constants "
                          f"({bounds or 'no __launch_bounds__'}) nor from a "
                          f"launch on the path, so {regs} registers × "
                          f"threads cannot be held to the {REGISTER_FILE}-"
                          f"register file")
        elif threads is not None and regs * threads > REGISTER_FILE:
            yield finding("register file", f"{regs} registers × {threads} "
                          f"threads = {regs * threads}, over the SM's "
                          f"{REGISTER_FILE}")
        static = rec.get("smem_static_bytes") or 0
        dynamic: Optional[int] = 0
        if dynamic_smem:
            sizes = {src.value(cfg[2], env, local) if len(cfg) > 2 else 0
                     for cfg, local in sites}
            dynamic = max(sizes) if sizes and None not in sizes else None
        if dynamic is None:
            if not launched:
                yield finding("dynamic shared memory unpriced",
                              "its dynamic shared memory is set from a "
                              "runtime value and no launch on the path "
                              f"priced it, so {static} static bytes + "
                              f"dynamic cannot be held to the "
                              f"{SMEM_PER_BLOCK}-byte block budget")
            dynamic = 0
        if static + dynamic > SMEM_PER_BLOCK:
            yield finding("shared memory", f"{static} static + {dynamic} "
                          f"dynamic bytes of shared memory, over the "
                          f"{SMEM_PER_BLOCK} a block may take")
        spills = (rec.get("spill_store_bytes") or 0,
                  rec.get("spill_load_bytes") or 0)
        if any(spills):
            yield finding("spills", f"{spills[0]} bytes spill stores, "
                          f"{spills[1]} bytes spill loads")
