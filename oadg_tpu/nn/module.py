"""Modules, scopes and variable collections.

A module is a dataclass of hyper-parameters. Its parameters and state live
outside it, in nested dicts keyed by collection (``params``,
``batch_stats``, ``intermediates``) and then by the module path:
``variables["params"]["backbone_m"]["conv1"]["kernel"]``. ``init`` builds
them, ``apply`` runs a method against them.

The tree layout and the way initial parameters derive from the seed are
those of flax.linen, which the model zoo, its weight converters and saved
checkpoints were written against:

- a submodule is named after the attribute it is assigned to in
  ``setup()`` (``name_i`` inside a list, ``name_key`` inside a dict), or,
  inside a ``@compact`` method, by its ``name=`` argument or as
  ``ClassName_i`` in the order of creation within one call;
- ``make_rng(name)`` folds the module path and a per-scope call counter
  into the key given for ``name`` (``'params'`` when there is none), so a
  parameter's initial value depends only on the seed and its place in the
  tree.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp


class ScopeError(ValueError):
    """A variable or rng a module needs is missing or may not be written."""


class _Unspecified:
    def __repr__(self):
        return "<unspecified>"


_UNSPECIFIED = _Unspecified()
_CHILD = object()           # key prefix of child counters in a scope


class _Context(threading.local):
    def __init__(self):
        self.modules = []       # bound modules whose methods are running
        self.capture = []       # capture_intermediates filters of applies


_ctx = _Context()


def _fold_in_static(key, data: Tuple) -> jax.Array:
    """Fold strings and ints into ``key`` through one SHA-1 of all of
    them."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


def _copy_dicts(tree):
    """Copy the dict structure of ``tree``, sharing its leaves."""
    if isinstance(tree, Mapping):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _mutable_predicate(mutable) -> Callable[[str], bool]:
    if mutable is True:
        return lambda col: True
    if not mutable:
        return lambda col: False
    cols = {mutable} if isinstance(mutable, str) else set(mutable)
    return lambda col: col in cols


class _Root:
    """The variables of one ``init``/``apply`` call."""

    def __init__(self, variables, mutable: Callable[[str], bool],
                 initializing: bool):
        self.mutable = mutable
        self.initializing = initializing
        self.variables = {
            col: (_copy_dicts(tree) if mutable(col) else tree)
            for col, tree in (variables or {}).items() if tree is not None}


class Scope:
    """A module's view of the variables: its path, rngs and counters."""

    def __init__(self, root: _Root, path: Tuple[str, ...], rngs: Dict,
                 counters: Dict):
        self.root = root
        self.path = path
        self.rngs = rngs            # name -> (key, static suffix)
        self.counters = counters    # rng name -> calls; child -> counters
        self.reserved = set()

    @property
    def path_text(self) -> str:
        return "/" + "/".join(self.path)

    def push(self, name: str) -> "Scope":
        if name in self.reserved:
            raise ScopeError(f"submodule name {name!r} is used twice in "
                             f"{self.path_text}")
        self.reserved.add(name)
        rngs = {k: (key, suffix + (name,))
                for k, (key, suffix) in self.rngs.items()}
        counters = self.counters.setdefault((_CHILD, name),
                                            {k: 0 for k in rngs})
        return Scope(self.root, self.path + (name,), rngs, counters)

    def rewound(self) -> "Scope":
        """The same scope with its submodule names free again (a compact
        method creates its submodules anew on every call)."""
        return Scope(self.root, self.path, self.rngs, self.counters)

    def make_rng(self, name: str = "params") -> jax.Array:
        if name not in self.rngs:
            if "params" not in self.rngs:
                raise ScopeError(f"{self.path_text} needs an rng for {name!r}")
            name = "params"
        self.counters[name] += 1
        key, suffix = self.rngs[name]
        return _fold_in_static(key, suffix + (self.counters[name],))

    def _node(self, col: str, create: bool = False):
        tree = self.root.variables.get(col)
        if tree is None:
            if not create:
                return None
            tree = self.root.variables[col] = {}
        for p in self.path:
            sub = tree.get(p)
            if sub is None:
                if not create:
                    return None
                sub = tree[p] = {}
            tree = sub
        return tree

    def has_variable(self, col: str, name: str) -> bool:
        node = self._node(col)
        return node is not None and name in node

    def get_variable(self, col: str, name: str, default=None):
        node = self._node(col)
        return node[name] if node is not None and name in node else default

    def put_variable(self, col: str, name: str, value):
        if not self.root.mutable(col):
            raise ScopeError(f"cannot write {col}{self.path_text}/{name}: "
                             f"collection {col!r} is not mutable")
        self._node(col, create=True)[name] = value


class Variable:
    """A handle on one variable; ``.value`` reads and writes it."""

    def __init__(self, scope: Scope, col: str, name: str):
        self.scope, self.col, self.name = scope, col, name

    @property
    def value(self):
        return self.scope.get_variable(self.col, self.name)

    @value.setter
    def value(self, v):
        self.scope.put_variable(self.col, self.name, v)


def compact(fun):
    """Mark the one method of a module that may create submodules and
    parameters inline."""
    fun.compact = True
    return fun


class _State:
    __slots__ = ("in_setup", "setup_done", "in_compact", "autoname")

    def __init__(self):
        self.in_setup = False
        self.setup_done = False
        self.in_compact = False
        self.autoname = {}


def _wrap_method(fun, name: str):
    is_compact = getattr(fun, "compact", False)

    @functools.wraps(fun)
    def wrapped(self, *args, **kwargs):
        scope = self.__dict__.get("_scope")
        if scope is None:
            if is_compact:
                raise ScopeError(f"{type(self).__name__}.{name} creates "
                                 "parameters: call it through init or apply")
            return fun(self, *args, **kwargs)
        self._try_setup()
        st = self._state
        outermost = is_compact and not st.in_compact
        if is_compact:
            st.in_compact = True
        _ctx.modules.append(self)
        try:
            y = fun(self, *args, **kwargs)
            capture = _ctx.capture[-1] if _ctx.capture else None
            if capture is not None and capture(self, name):
                self._sow("intermediates", name, y)
            return y
        finally:
            _ctx.modules.pop()
            if outermost:
                st.in_compact = False
                st.autoname = {}
                object.__setattr__(self, "_scope", self._scope.rewound())

    wrapped._module_wrapped = True
    return wrapped


_UNWRAPPED = {"setup"}


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class of every layer, head and detector.

    Subclasses are dataclasses of their hyper-parameters. A module either
    assigns submodules to attributes in ``setup()`` or creates them inline
    in one ``@compact`` method; its other methods may call both.
    """
    parent: Any = dataclasses.field(default=_UNSPECIFIED, kw_only=True,
                                    repr=False)
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)
        fields = {f.name for f in dataclasses.fields(cls)}
        for key, val in list(cls.__dict__.items()):
            if (not inspect.isfunction(val) or key in fields
                    or key in _UNWRAPPED
                    or (key.startswith("__") and key != "__call__")
                    or getattr(val, "_module_wrapped", False)):
                continue
            setattr(cls, key, _wrap_method(val, key))

    def __post_init__(self):
        object.__setattr__(self, "_state", _State())
        object.__setattr__(self, "_scope", None)
        parent = self.parent
        if parent is _UNSPECIFIED:
            parent = _ctx.modules[-1] if _ctx.modules else None
            object.__setattr__(self, "parent", parent)
        if isinstance(parent, Scope):
            object.__setattr__(self, "_scope", parent)
            return
        if parent is None:
            return
        pst = parent._state
        if pst.in_setup:
            if self.name is None:
                return          # named when setup() assigns it
        elif not pst.in_compact:
            raise ScopeError(
                f"{type(self).__name__} is created in {type(parent).__name__}"
                " outside setup() and outside its @compact method")
        if self.name is None:
            prefix = type(self).__name__
            i = pst.autoname.get(prefix, 0)
            pst.autoname[prefix] = i + 1
            object.__setattr__(self, "name", f"{prefix}_{i}")
        self._bind()

    def _bind(self):
        object.__setattr__(self, "_scope",
                           self.parent._scope.push(self.name))

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"

    # ----------------------------------------------------- setup() --------

    def setup(self):
        pass

    def _try_setup(self):
        st = self._state
        if st.setup_done or st.in_setup or self._scope is None:
            return
        st.in_setup = True
        _ctx.modules.append(self)
        try:
            for f in dataclasses.fields(self):
                if f.name not in ("parent", "name"):
                    v = self.__dict__.get(f.name)
                    if _holds_module(v):
                        self._register(f.name, v)
            self.setup()
            st.setup_done = True
        finally:
            st.in_setup = False
            _ctx.modules.pop()

    def _register(self, attr: str, val):
        """Name and bind the submodules in ``val`` after ``attr``."""
        def adopt(v, suffix):
            if isinstance(v, Module):
                if v._scope is None:
                    if v.parent is not self:    # built outside: a copy
                        v = dataclasses.replace(v, parent=None)
                    object.__setattr__(v, "parent", self)
                    if v.name is None:
                        object.__setattr__(v, "name", f"{attr}{suffix}")
                    v._bind()
                return v
            if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
                return tuple(adopt(x, f"{suffix}_{i}")
                             for i, x in enumerate(v))
            if isinstance(v, dict):
                return {k: adopt(x, f"{suffix}_{k}") for k, x in v.items()}
            return v
        object.__setattr__(self, attr, adopt(val, ""))

    def __setattr__(self, name, val):
        st = self.__dict__.get("_state")
        if st is None:                  # the dataclass __init__
            object.__setattr__(self, name, val)
        elif st.in_setup:
            self._register(name, val)
        else:
            raise AttributeError(f"{type(self).__name__} can set attributes "
                                 f"only in setup(), not {name!r}")

    def __getattr__(self, name):
        d = self.__dict__
        st = d.get("_state")
        if (st is not None and d.get("_scope") is not None
                and not name.startswith("__")
                and not st.setup_done and not st.in_setup):
            self._try_setup()
            if name in d:
                return d[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # --------------------------------------------- variables and rngs ----

    def _require_scope(self) -> Scope:
        scope = self.__dict__.get("_scope")
        if scope is None:
            raise ScopeError(f"{type(self).__name__} is not bound to "
                             "variables: call it through init or apply")
        return scope

    def param(self, name: str, init_fn: Callable, *init_args, **init_kw):
        """The parameter ``name``; created with ``init_fn(rng, *init_args)``
        while ``params`` is mutable and it does not exist yet."""
        scope = self._require_scope()
        if scope.has_variable("params", name):
            return scope.get_variable("params", name)
        if not scope.root.mutable("params"):
            raise ScopeError(f"parameter {scope.path_text}/{name} is missing")
        value = init_fn(scope.make_rng("params"), *init_args, **init_kw)
        scope.put_variable("params", name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable = None,
                 *init_args, **init_kw) -> Variable:
        """A handle on variable ``name`` of collection ``col``; created
        with ``init_fn(*init_args)`` while ``col`` is mutable."""
        scope = self._require_scope()
        if not scope.has_variable(col, name):
            if init_fn is None or not scope.root.mutable(col):
                raise ScopeError(f"variable {col}{scope.path_text}/{name} "
                                 "is missing")
            scope.put_variable(col, name, init_fn(*init_args, **init_kw))
        return Variable(scope, col, name)

    def _sow(self, col: str, name: str, value):
        """Append ``value`` to the tuple ``col/<path>/name`` if ``col`` is
        mutable."""
        scope = self._require_scope()
        if scope.root.mutable(col):
            scope.put_variable(col, name,
                               scope.get_variable(col, name, ()) + (value,))

    def make_rng(self, name: str = "params") -> jax.Array:
        return self._require_scope().make_rng(name)

    def has_rng(self, name: str) -> bool:
        return name in self._require_scope().rngs

    def is_initializing(self) -> bool:
        return self._require_scope().root.initializing

    def is_mutable_collection(self, col: str) -> bool:
        return self._require_scope().root.mutable(col)

    # --------------------------------------------------- init / apply ----

    def _bound_copy(self, variables, rngs, mutable, initializing):
        if rngs is not None and not isinstance(rngs, Mapping):
            rngs = {"params": rngs}
        rngs = dict(rngs or {})
        root = _Root(variables, mutable, initializing)
        scope = Scope(root, (), {k: (v, ()) for k, v in rngs.items()},
                      {k: 0 for k in rngs})
        return dataclasses.replace(self, parent=scope), root

    def bind(self, variables, rngs=None, mutable=False) -> "Module":
        """A copy of this module bound to ``variables``, whose methods can
        be called directly (interactive use and tests)."""
        return self._bound_copy(variables, rngs, _mutable_predicate(mutable),
                                False)[0]

    def _run(self, rngs, variables, args, kwargs, method, mutable,
             capture, initializing):
        module, root = self._bound_copy(variables, rngs, mutable,
                                        initializing)
        if method is None:
            fn = type(module).__call__
        elif isinstance(method, str):
            fn = getattr(type(module), method)
        else:
            fn = method.__func__ if inspect.ismethod(method) else method
        _ctx.capture.append(capture or None)
        try:
            y = fn(module, *args, **kwargs)
        finally:
            _ctx.capture.pop()
        return y, {c: t for c, t in root.variables.items() if mutable(c)}

    def init(self, rngs, *args, method=None, capture_intermediates=False,
             **kwargs) -> Dict:
        """Create every variable by running ``method`` (default
        ``__call__``); ``rngs`` is a key (used for ``params``) or a dict of
        keys."""
        _, variables = self._run(
            rngs, {}, args, kwargs, method,
            lambda col: col != "intermediates" or bool(capture_intermediates),
            capture_intermediates, initializing=True)
        return variables

    def apply(self, variables, *args, rngs=None, method=None, mutable=False,
              capture_intermediates=False, **kwargs):
        """Run ``method`` (default ``__call__``; a name, a method or a
        function of the module) with ``variables``. With ``mutable`` (a
        collection name, a list of them, or True) returns ``(out,
        {collection: tree})`` of the mutable collections."""
        pred = _mutable_predicate(mutable)
        if capture_intermediates:
            base = pred
            pred = lambda col: col == "intermediates" or base(col)
        y, out = self._run(rngs, variables, args, kwargs, method, pred,
                           capture_intermediates, initializing=False)
        return y if mutable is False and not capture_intermediates else (
            y, out)


def _holds_module(v) -> bool:
    if isinstance(v, Module):
        return True
    if isinstance(v, (list, tuple)):
        return any(_holds_module(x) for x in v)
    if isinstance(v, dict):
        return any(_holds_module(x) for x in v.values())
    return False


def remat(module_cls):
    """``module_cls`` whose ``__call__`` recomputes its activations in the
    backward pass (``jax.checkpoint``) instead of keeping them."""

    class Checkpointed(module_cls):
        def __call__(self, *args):
            call = super().__call__
            root = self._scope.root
            if root.initializing:
                return call(*args)

            def mutable_state():
                return {c: t for c, t in root.variables.items()
                        if root.mutable(c)}

            # mutable collections go in and out as values: a write inside
            # the checkpointed trace must not leave its tracer behind
            def run(state, *a):
                saved = dict(root.variables)
                root.variables.update(state)
                try:
                    return call(*a), mutable_state()
                finally:
                    root.variables.clear()
                    root.variables.update(saved)

            y, state = jax.checkpoint(run)(mutable_state(), *args)
            root.variables.update(state)
            return y

    Checkpointed.__name__ = f"Checkpoint{module_cls.__name__}"
    Checkpointed.__qualname__ = Checkpointed.__name__
    return Checkpointed
