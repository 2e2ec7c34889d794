"""Attribute-style configuration dictionary (the port's own copy of
``basedet_tpu/utils/config_dict.py``; pure Python).

A plain ``dict`` subclass with attribute access, recursive ``merge``,
``diff``, ``find``, and pickling that round-trips through plain dicts so
configs can be checkpointed. ``merge`` takes a mapping or the CLI's flat
``KEY VALUE`` list, whose values go through ``ast.literal_eval``.
"""
from __future__ import annotations

import copy
import pprint
from typing import Any, Iterable, Mapping


class ConfigDict(dict):
    """dict with attribute access and recursive merge/diff semantics."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        if args or kwargs:
            self._absorb(dict(*args, **kwargs))

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    # -- construction helpers ------------------------------------------------
    def _absorb(self, mapping: Mapping) -> None:
        for k, v in mapping.items():
            self[k] = v

    # -- merge / diff ---------------------------------------------------------
    def merge(self, other=None, **kwargs) -> "ConfigDict":
        """Recursively merge ``other`` into self (in place) and return self.

        ``other`` may be a mapping, or a flat iterable of alternating
        ``key value`` strings (the CLI ``opts`` protocol,
        ``cfg.merge(args.opts)``). Dotted keys
        (``SOLVER.BASIC_LR``) address nested fields.
        """
        if other is None:
            other = {}
        if isinstance(other, Mapping):
            _merge_mapping(self, other)
        else:
            _merge_opts(self, list(other))
        if kwargs:
            _merge_mapping(self, kwargs)
        return self

    def diff(self, other: Mapping) -> "ConfigDict":
        """Return keys whose values differ between self and ``other``."""
        out = ConfigDict()
        for k, v in self.items():
            if k not in other:
                out[k] = v
            else:
                ov = other[k]
                if isinstance(v, Mapping) and isinstance(ov, Mapping):
                    sub = ConfigDict(v).diff(ov)
                    if sub:
                        out[k] = sub
                elif _neq(v, ov):
                    out[k] = v
        return out

    def find(self, key: str, case_sensitive: bool = False):
        """Return the sub-tree of entries whose key path contains ``key``."""
        needle = key if case_sensitive else key.lower()
        out = ConfigDict()
        for k, v in self.items():
            hay = k if case_sensitive else str(k).lower()
            if needle in hay:
                out[k] = v
            elif isinstance(v, ConfigDict):
                sub = v.find(key, case_sensitive)
                if sub:
                    out[k] = sub
        return out

    def to_dict(self) -> dict:
        return {k: _unwrap(v) for k, v in self.items()}

    def clone(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({pprint.pformat(self.to_dict())})"

    # -- pickle ---------------------------------------------------------------
    def __reduce__(self):
        return (_rebuild, (type(self), self.to_dict()))

    def __deepcopy__(self, memo):
        new = type(self).__new__(type(self))
        dict.__init__(new)
        memo[id(self)] = new
        for k, v in self.items():
            dict.__setitem__(new, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return new


def _rebuild(cls, data):
    obj = cls.__new__(cls)
    dict.__init__(obj)
    obj._absorb(data)
    return obj


def _unwrap(value: Any) -> Any:
    """Recursively convert ConfigDicts (incl. inside lists/tuples) to plain
    python containers."""
    if isinstance(value, ConfigDict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [_unwrap(v) for v in value]
        return tuple(out) if isinstance(value, tuple) else out
    return copy.deepcopy(value)


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    if isinstance(value, (list, tuple)):
        wrapped = [_wrap(v) for v in value]
        return type(value)(wrapped) if isinstance(value, tuple) else wrapped
    return value


def _neq(a, b) -> bool:
    try:
        import numpy as np

        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return not np.array_equal(a, b)
    except Exception:
        pass
    return a != b


def _merge_mapping(dst: ConfigDict, src: Mapping) -> None:
    for k, v in src.items():
        if (
            k in dst
            and isinstance(dst[k], Mapping)
            and isinstance(v, Mapping)
        ):
            _merge_mapping(dst[k], v)
        else:
            dst[k] = v


def _parse_literal(text: str) -> Any:
    import ast

    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _merge_opts(dst: ConfigDict, opts: Iterable[str]) -> None:
    opts = list(opts)
    if len(opts) % 2 != 0:
        raise ValueError(f"opts must be key/value pairs, got {opts}")
    for key, raw in zip(opts[0::2], opts[1::2]):
        node = dst
        parts = str(key).split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Mapping):
                node[p] = ConfigDict()
            node = node[p]
        if parts[-1] not in node:
            # new keys are allowed (upstream merge semantics) but a typo'd
            # override is otherwise invisible — surface it
            import logging

            logging.getLogger("basedet").warning(
                "config override created NEW key %r — check for typos "
                "(existing siblings: %s)",
                key,
                ", ".join(sorted(map(str, node))[:8]) or "<none>",
            )
        node[parts[-1]] = _parse_literal(raw)
