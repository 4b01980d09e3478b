"""charon-lint rules R1-R6.

Each rule encodes one invariant this repo keeps re-fixing by hand (see
docs/static-analysis.md for the catalog with the real past bug behind each
rule).  Rules are AST-only — stdlib ``ast``, no imports of the code under
scan — so the linter runs on any tree, including broken ones, and in CI
without jax installed.

Scope strings are package-relative paths (``core/`` matches
``src/repro_torch/core/...`` and a fixture tree's ``core/...`` alike — see
``engine._normalize_rel``).
"""
from __future__ import annotations

import ast

from .engine import ParsedModule, parent
from .report import Finding

# ---------------------------------------------------------------- helpers

_FUNC_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def import_aliases(tree: ast.AST) -> dict:
    """Map local binding name -> dotted origin ("np" -> "numpy")."""
    amap: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    amap[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    amap[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                amap[a.asname or a.name] = f"{node.module}.{a.name}"
    return amap


def dotted(node: ast.AST, amap: dict) -> str | None:
    """Resolve a Name/Attribute chain to a dotted origin name, or None."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(amap.get(cur.id, cur.id))
        return ".".join(reversed(parts))
    return None


def scope_children(scope: ast.AST):
    """Yield nodes belonging to *scope* without descending into nested
    function/class/lambda scopes."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNC_SCOPES + (ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def iter_scopes(tree: ast.AST):
    """Yield every lexical scope root: the module and each function."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_SCOPES):
            yield node


class Rule:
    id = "R?"
    title = ""
    fixit = ""
    scopes: tuple = ()

    def finding(self, mod: ParsedModule, node: ast.AST, message: str,
                fixit: str | None = None) -> Finding:
        return Finding(rule=self.id, title=self.title, path=mod.rel,
                       line=getattr(node, "lineno", 1), message=message,
                       fixit=self.fixit if fixit is None else fixit)

    def check(self, mod: ParsedModule):  # pragma: no cover - interface
        raise NotImplementedError


# ---------------------------------------------------------------- R1

def _is_cache_get(node: ast.AST) -> bool:
    """A SimCache-style ``<obj>.get(bucket, key, build)`` 3-arg call with a
    string-literal bucket.  ``dict.get(key, default)`` never has 3 args, so
    this shape is a reliable discriminator."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and len(node.args) == 3
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str))


def _mutable_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set", "bytearray",
                                 "defaultdict"))


_MUTATORS = {"append", "extend", "update", "pop", "popitem", "clear",
             "setdefault", "add", "remove", "discard", "insert", "sort",
             "reverse"}


def _chain_root(node: ast.AST) -> ast.Name | None:
    """Root Name of an attribute/subscript access chain
    (``rep.kind_us["matmul"]`` -> ``rep``), or None."""
    cur = node
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        cur = cur.value
    return cur if isinstance(cur, ast.Name) else None


class CacheAliasRule(Rule):
    """R1: values fetched from a cache bucket must not be returned as
    aliased mutable containers, and must never be mutated in place."""
    id = "R1"
    title = "cache-alias"
    fixit = ("return an immutable value (tuple/frozen dataclass) from the "
             "cache build fn, or copy before returning; never mutate a "
             "cache-fetched value in place")
    scopes = ()  # everywhere

    def check(self, mod: ParsedModule):
        # module-level map of function name -> def node, for resolving
        # build callbacks passed by name
        defs = {n.name: n for n in ast.walk(mod.tree)
                if isinstance(n, _FUNC_SCOPES)}

        def build_is_mutable(call: ast.Call) -> bool:
            build = call.args[2]
            if isinstance(build, ast.Lambda):
                return _mutable_ctor(build.body)
            if isinstance(build, ast.Name) and build.id in defs:
                fn = defs[build.id]
                return any(_mutable_ctor(r.value)
                           for r in ast.walk(fn)
                           if isinstance(r, ast.Return) and r.value)
            return False

        for scope in iter_scopes(mod.tree):
            # names bound directly to a cache get() result in this scope
            cached: dict[str, ast.Call] = {}
            for node in scope_children(scope):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and _is_cache_get(node.value)):
                    cached[node.targets[0].id] = node.value

            for node in scope_children(scope):
                if isinstance(node, ast.Return) and node.value is not None:
                    v = node.value
                    call = None
                    if _is_cache_get(v):
                        call = v
                    elif isinstance(v, ast.Name) and v.id in cached:
                        call = cached[v.id]
                    if call is not None and build_is_mutable(call):
                        yield self.finding(
                            mod, node,
                            "returns a cache-fetched mutable container; "
                            "callers can mutate the cached value in place "
                            "(as a cached MemoryReport.timeline list once was)")
                # in-place mutation of a cache-fetched name
                tgt = None
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    tgts = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in tgts:
                        if isinstance(t, (ast.Subscript, ast.Attribute)):
                            root = _chain_root(t)
                            if root is not None and root.id in cached:
                                tgt = t
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript):
                            root = _chain_root(t)
                            if root is not None and root.id in cached:
                                tgt = t
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS):
                    root = _chain_root(node.func.value)
                    if root is not None and root.id in cached:
                        tgt = node
                if tgt is not None:
                    yield self.finding(
                        mod, node,
                        "mutates a cache-fetched value in place; the "
                        "mutation poisons the shared cache entry")


# ---------------------------------------------------------------- R2

_EPOCH_CALLS = {
    "time.time", "time.time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.now", "datetime.utcnow",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
}
_PERF_CALLS = {"time.perf_counter", "time.perf_counter_ns",
               "time.monotonic", "time.monotonic_ns"}
# measurement engines: the only files allowed to touch a wall clock inside
# the deterministic scopes (they time real hardware, not simulated time)
_PERF_EXEMPT = {"core/backend/profiling.py", "serving/sim/workload.py"}
_NP_RANDOM_FNS = {"rand", "randn", "randint", "random", "normal", "uniform",
                  "choice", "shuffle", "permutation", "seed",
                  "random_sample", "standard_normal", "exponential",
                  "poisson"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


class NondeterminismRule(Rule):
    """R2: no wall clocks, global/unseeded RNGs, ``id()``-derived keys, or
    set-order-dependent iteration inside the deterministic simulation
    scopes.  Reports must be a pure function of (spec, profile DB)."""
    id = "R2"
    title = "nondeterminism"
    fixit = ("use repro_torch.obs.clock.wall_s() for telemetry timing, a seeded "
             "random.Random(seed)/np.random.default_rng(seed) stream for "
             "randomness, stable keys instead of id(), and sorted(...) "
             "before iterating a set into ordered results")
    scopes = ("core/", "serving/sim/", "resilience/", "api/sweep.py")

    def check(self, mod: ParsedModule):
        amap = import_aliases(mod.tree)

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                name = dotted(node.func, amap)
                if name is None:
                    continue
                if name in _EPOCH_CALLS:
                    yield self.finding(
                        mod, node,
                        f"wall-clock/nondeterministic call {name}() in a "
                        "deterministic simulation scope")
                elif name in _PERF_CALLS and mod.rel not in _PERF_EXEMPT:
                    yield self.finding(
                        mod, node,
                        f"{name}() outside the measurement engines "
                        f"({', '.join(sorted(_PERF_EXEMPT))}); simulated "
                        "time must come from the event loop, telemetry "
                        "time from repro_torch.obs.clock")
                elif name.startswith("random."):
                    attr = name.split(".", 1)[1]
                    if attr == "SystemRandom":
                        yield self.finding(
                            mod, node, "random.SystemRandom is entropy-"
                            "seeded and never reproducible")
                    elif attr == "Random":
                        if not node.args:
                            yield self.finding(
                                mod, node,
                                "unseeded random.Random(); pass an explicit "
                                "seed derived from the spec")
                    elif "." not in attr and attr[:1].islower():
                        yield self.finding(
                            mod, node,
                            f"module-level random.{attr}() uses the global "
                            "interpreter-wide RNG state")
                elif name == "numpy.random.default_rng" and not node.args:
                    yield self.finding(
                        mod, node,
                        "unseeded np.random.default_rng(); pass an explicit "
                        "seed derived from the spec")
                elif (name.startswith("numpy.random.")
                        and name.split(".")[-1] in _NP_RANDOM_FNS):
                    yield self.finding(
                        mod, node,
                        f"legacy global-state {name}(); use a seeded "
                        "np.random.default_rng(seed) generator")
                elif (name == "id" and node.args
                        and self._in_key_position(node)):
                    yield self.finding(
                        mod, node,
                        "id() used as a key: object addresses vary run to "
                        "run and across processes, so any ordering or "
                        "persistence derived from them is nondeterministic")

            # set iteration feeding ordered results
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if _is_set_expr(it):
                    yield self.finding(
                        mod, it,
                        "iterating directly over a set; wrap in sorted() "
                        "before feeding ordered results")

        # names bound only to set expressions, then iterated
        for scope in iter_scopes(mod.tree):
            bound: dict[str, bool] = {}
            for node in scope_children(scope):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            is_set = _is_set_expr(node.value)
                            if t.id in bound:
                                bound[t.id] = bound[t.id] and is_set
                            else:
                                bound[t.id] = is_set
            set_names = {n for n, ok in bound.items() if ok}
            if not set_names:
                continue
            for node in scope_children(scope):
                iters = []
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iters = [node.iter]
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    iters = [g.iter for g in node.generators]
                for it in iters:
                    if isinstance(it, ast.Name) and it.id in set_names:
                        yield self.finding(
                            mod, it,
                            f"iterating over set-typed name '{it.id}'; "
                            "wrap in sorted() before feeding ordered "
                            "results")

    @staticmethod
    def _in_key_position(node: ast.Call) -> bool:
        """True if this id() call feeds a subscript slice, dict key,
        hash()/dict-method argument, or an ``in`` test."""
        cur: ast.AST = node
        p = parent(cur)
        while p is not None:
            if isinstance(p, ast.Subscript) and cur is p.slice:
                return True
            if isinstance(p, ast.Dict) and cur in p.keys:
                return True
            if isinstance(p, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in p.ops):
                return True
            if isinstance(p, ast.Call):
                if isinstance(p.func, ast.Name) and p.func.id == "hash":
                    return True
                if isinstance(p.func, ast.Attribute) and p.func.attr in (
                        "get", "setdefault", "pop", "add", "remove",
                        "discard"):
                    return True
                return False  # id() consumed by an unrelated call
            if isinstance(p, (ast.stmt,)):
                return False
            cur, p = p, parent(p)
        return False


# ---------------------------------------------------------------- R3

class SpecDriftRule(Rule):
    """R3: every field of a frozen spec dataclass must survive the
    to_json/from_dict round-trip and participate in hashing."""
    id = "R3"
    title = "spec-drift"
    fixit = ("wire the new field through from_dict (string-literal key), "
             "keep compare=True so it participates in __eq__/__hash__, and "
             "reference it in any manual __hash__")
    scopes = ("api/spec.py",)

    def check(self, mod: ParsedModule):
        classes = [n for n in mod.tree.body if isinstance(n, ast.ClassDef)]
        frozen = {c.name: c for c in classes if self._is_frozen(c)}
        literals = {n.value for n in ast.walk(mod.tree)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}

        for cls in frozen.values():
            fields = self._fields(cls)
            for fname, ann, kws, node in fields:
                if fname.startswith("_"):
                    continue  # private plumbing (e.g. memoized _hash)
                # (a) compare=False silently drops the field from __eq__
                # and __hash__ -> two unequal specs collide in caches
                cmp = kws.get("compare")
                if isinstance(cmp, ast.Constant) and cmp.value is False:
                    yield self.finding(
                        mod, node,
                        f"{cls.name}.{fname}: compare=False on a public "
                        "spec field drops it from __eq__/__hash__; unequal "
                        "specs would share cache entries")
                # (b) nested spec fields must show up as a string-literal
                # key somewhere in the module (from_dict reconstruction)
                if self._is_nested_spec(ann, kws, frozen) \
                        and fname not in literals:
                    yield self.finding(
                        mod, node,
                        f"{cls.name}.{fname}: nested spec field has no "
                        "string-literal key in this module — from_dict "
                        "cannot be reconstructing it, so JSON round-trip "
                        "drops the field")
            # (c) a manual __hash__ must reference every public field
            hash_fn = next((n for n in cls.body
                            if isinstance(n, _FUNC_SCOPES)
                            and n.name == "__hash__"), None)
            if hash_fn is not None:
                seen = {n.attr for n in ast.walk(hash_fn)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"}
                for fname, ann, kws, node in fields:
                    cmp = kws.get("compare")
                    off = isinstance(cmp, ast.Constant) and cmp.value is False
                    if fname.startswith("_") or off:
                        continue
                    if fname not in seen:
                        yield self.finding(
                            mod, hash_fn,
                            f"{cls.name}.__hash__ does not reference field "
                            f"'{fname}'; specs differing only in it would "
                            "collide as cache keys")

    @staticmethod
    def _is_frozen(cls: ast.ClassDef) -> bool:
        for dec in cls.decorator_list:
            if isinstance(dec, ast.Call):
                name = dec.func.attr if isinstance(dec.func, ast.Attribute) \
                    else getattr(dec.func, "id", "")
                if name == "dataclass":
                    for kw in dec.keywords:
                        if kw.arg == "frozen" and isinstance(
                                kw.value, ast.Constant) and kw.value.value:
                            return True
        return False

    @staticmethod
    def _fields(cls: ast.ClassDef):
        out = []
        for node in cls.body:
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                ann_src = ast.unparse(node.annotation) \
                    if node.annotation is not None else ""
                if "ClassVar" in ann_src:
                    continue
                kws = {}
                if isinstance(node.value, ast.Call):
                    fn = node.value.func
                    fname = fn.attr if isinstance(fn, ast.Attribute) \
                        else getattr(fn, "id", "")
                    if fname == "field":
                        kws = {kw.arg: kw.value
                               for kw in node.value.keywords}
                out.append((node.target.id, ann_src, kws, node))
        return out

    @staticmethod
    def _is_nested_spec(ann_src: str, kws: dict, frozen: dict) -> bool:
        if any(name in ann_src for name in frozen):
            return True
        df = kws.get("default_factory")
        return isinstance(df, ast.Name) and df.id in frozen


# ---------------------------------------------------------------- R4

_PRICING_HINTS = ("price", "run", "latency", "simulate", "schedule")


class MemoGuardRule(Rule):
    """R4: memo dicts on state-versioned engine objects must be cleared by
    the state-version guard (a memo that outlives the state it priced)."""
    id = "R4"
    title = "memo-guard"
    fixit = ("clear the memo (self.X.clear() or self.X = {}) inside the "
             "method that detects a _state_version change, so priced "
             "results cannot survive an engine reconfiguration")
    scopes = ("core/", "serving/sim/", "resilience/")

    def check(self, mod: ParsedModule):
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            refs_version = any(
                (isinstance(n, ast.Attribute) and "_state_version" in n.attr)
                or (isinstance(n, ast.Name) and "_state_version" in n.id)
                for n in ast.walk(cls))
            if not refs_version:
                continue
            memos = self._memo_attrs(cls)
            if not memos:
                continue
            cleared = self._cleared_attrs(cls)
            priced = self._priced_write_attrs(cls)
            for attr, node in memos.items():
                if attr in priced and attr not in cleared:
                    yield self.finding(
                        mod, node,
                        f"memo dict self.{attr} caches priced results but "
                        "is never cleared outside __init__; it will serve "
                        "stale values after a _state_version change")

    @staticmethod
    def _memo_attrs(cls: ast.ClassDef) -> dict:
        """self.X attrs assigned a dict in __init__/__post_init__."""
        out: dict = {}
        for fn in cls.body:
            if not (isinstance(fn, _FUNC_SCOPES)
                    and fn.name in ("__init__", "__post_init__")):
                continue
            for node in ast.walk(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                    value = node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets = [node.target]
                    value = node.value
                else:
                    continue
                has_dict = any(
                    isinstance(v, (ast.Dict, ast.DictComp))
                    or (isinstance(v, ast.Call)
                        and isinstance(v.func, ast.Name)
                        and v.func.id == "dict")
                    for v in ast.walk(value))
                if not has_dict:
                    continue
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        out[t.attr] = node
        return out

    @staticmethod
    def _cleared_attrs(cls: ast.ClassDef) -> set:
        """attrs cleared or reassigned outside __init__/__post_init__."""
        out: set = set()
        for fn in cls.body:
            if not isinstance(fn, _FUNC_SCOPES) \
                    or fn.name in ("__init__", "__post_init__"):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "clear"
                        and isinstance(node.func.value, ast.Attribute)
                        and isinstance(node.func.value.value, ast.Name)
                        and node.func.value.value.id == "self"):
                    out.add(node.func.value.attr)
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            out.add(t.attr)
        return out

    @staticmethod
    def _priced_write_attrs(cls: ast.ClassDef) -> set:
        """attrs written by subscript/setdefault inside a method that also
        calls something pricing-shaped (price/run/latency/simulate/
        schedule).  Pure key->spec tables (no pricing involved) are exempt:
        their entries cannot go stale."""
        out: set = set()
        for fn in cls.body:
            if not isinstance(fn, _FUNC_SCOPES) \
                    or fn.name in ("__init__", "__post_init__"):
                continue
            calls_pricing = False
            writes: set = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    name = None
                    if isinstance(node.func, ast.Attribute):
                        name = node.func.attr
                    elif isinstance(node.func, ast.Name):
                        name = node.func.id
                    if name and any(h in name.lower()
                                    for h in _PRICING_HINTS):
                        calls_pricing = True
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "setdefault"
                            and isinstance(node.func.value, ast.Attribute)
                            and isinstance(node.func.value.value, ast.Name)
                            and node.func.value.value.id == "self"):
                        writes.add(node.func.value.attr)
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Attribute) \
                                and isinstance(t.value.value, ast.Name) \
                                and t.value.value.id == "self":
                            writes.add(t.value.attr)
            if calls_pricing:
                out |= writes
        return out


# ---------------------------------------------------------------- R5

class RecorderThreadingRule(Rule):
    """R5: simulator entry points accept and forward recorder=/metrics= so
    observability reaches every nested event loop."""
    id = "R5"
    title = "recorder-threading"
    fixit = ("add recorder=None and metrics=None keyword params to the run "
             "method and forward them on delegated .run(...) calls "
             "(pricing calls on the owned self.sim core simulator are "
             "exempt: priced sub-runs are cache-shared and must not "
             "record)")
    scopes = ("core/simulator.py", "serving/sim/", "resilience/")

    def check(self, mod: ParsedModule):
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef) \
                    or not cls.name.endswith("Simulator"):
                continue
            run = next((n for n in cls.body if isinstance(n, _FUNC_SCOPES)
                        and n.name == "run"), None)
            if run is None:
                continue
            params = {a.arg for a in run.args.args} \
                | {a.arg for a in run.args.kwonlyargs}
            for missing in ("recorder", "metrics"):
                if missing not in params:
                    yield self.finding(
                        mod, run,
                        f"{cls.name}.run() does not accept {missing}=; "
                        "observability cannot be threaded through this "
                        "entry point")
            # delegated .run(...) calls must forward recorder=
            for node in ast.walk(run):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "run"):
                    continue
                recv = node.func.value
                if isinstance(recv, ast.Name) and recv.id == "self":
                    continue
                # self.sim is the owned core pricing simulator: its runs
                # are memoized step prices, deliberately not recorded
                if isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self" and recv.attr == "sim":
                    continue
                kwargs = {kw.arg for kw in node.keywords}
                if "recorder" not in kwargs:
                    yield self.finding(
                        mod, node,
                        f"{cls.name}.run() delegates to a nested .run() "
                        "without forwarding recorder=; trace lanes from "
                        "the inner loop are silently dropped")


# ---------------------------------------------------------------- R6

# exceptions that carry control flow (shutdown, Ctrl-C, generator close):
# swallowing one inside retry/cleanup logic turns "user pressed Ctrl-C"
# into "retry the candidate", making a sweep unkillable
_CONTROL_EXCS = {"BaseException", "KeyboardInterrupt", "SystemExit",
                 "GeneratorExit"}


def _caught_names(node: ast.expr | None) -> set:
    """Exception names named by an ``except`` clause (tuples flattened;
    ``mp.ProcessError``-style attributes reduce to their tail name)."""
    if node is None:
        return set()
    if isinstance(node, ast.Tuple):
        out: set = set()
        for e in node.elts:
            out |= _caught_names(e)
        return out
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    return set()


class ExceptionHygieneRule(Rule):
    """R6: the crash-recovery scopes (worker pool, sweep retry loop, chaos
    harness, atomic cache writes) must not swallow control-flow exceptions.
    A bare ``except:`` — or a handler naming BaseException / KeyboardInterrupt
    / SystemExit / GeneratorExit without a bare ``raise`` in its body — eats
    Ctrl-C and pool shutdown, leaving orphaned workers and half-written
    cache files.  Retry logic catches ``Exception``; anything wider must
    clean up and re-raise (see ``WorkerPool.run`` and ``atomic_pickle`` for
    the compliant shape)."""
    id = "R6"
    title = "exception-hygiene"
    fixit = ("catch Exception for retryable candidate errors; if a wider "
             "handler is needed for cleanup, end it with a bare `raise` so "
             "KeyboardInterrupt/SystemExit still propagate")
    scopes = ("api/pool.py", "api/sweep.py", "analysis/chaos.py",
              "core/simcache.py")

    def check(self, mod: ParsedModule):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield self.finding(
                    mod, node,
                    "bare `except:` in a crash-recovery scope catches "
                    "KeyboardInterrupt/SystemExit; retries would swallow "
                    "Ctrl-C and make the sweep unkillable")
                continue
            control = _caught_names(node.type) & _CONTROL_EXCS
            if not control:
                continue
            reraises = any(isinstance(n, ast.Raise) and n.exc is None
                           for n in ast.walk(node))
            if not reraises:
                yield self.finding(
                    mod, node,
                    f"handler catches {'/'.join(sorted(control))} without a "
                    "bare `raise`; control-flow exceptions must propagate "
                    "after cleanup or workers/cache writes leak")


ALL_RULES = (CacheAliasRule, NondeterminismRule, SpecDriftRule,
             MemoGuardRule, RecorderThreadingRule, ExceptionHygieneRule)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
