"""The yaml config factory (reference contrib/slim/core/config.py:26
ConfigFactory).

The slim schema's top-level sections (``pruners``, ``strategies``, ...)
map names to ``{class: <ClassName>, <constructor kwargs>...}``;
``compress_pass`` is a single entry. A kwarg (or list element) whose
string names another entry resolves to that entry's instance. The config
is a path to a yaml file (``yaml`` is imported only then) or the parsed
dict.
"""

from __future__ import annotations

import inspect

__all__ = ["ConfigFactory"]

_UNRESOLVED = object()


def _registry():
    from ..prune import (MagnitudePruner, PruneStrategy, RatioPruner,
                         SensitivePruneStrategy)
    from .compress_pass import CompressPass
    from .strategy import Strategy

    return {c.__name__: c for c in
            (MagnitudePruner, RatioPruner, PruneStrategy,
             SensitivePruneStrategy, CompressPass, Strategy)}


class ConfigFactory:
    def __init__(self, config):
        """``config``: a path to a yaml file, or the parsed dict."""
        self.instances = {}
        self.version = None
        if isinstance(config, dict):
            parsed = config
        else:
            import yaml
            with open(config) as f:
                parsed = yaml.safe_load(f)
        self._parse(parsed)

    def get_compress_pass(self):
        return self.instance("compress_pass")

    def instance(self, name):
        return self.instances.get(name)

    # ------------------------------------------------------------------
    def _parse(self, conf):
        if "version" in conf:
            self.version = str(conf["version"])
        entries = {}
        for section, body in conf.items():
            if section == "version":
                continue
            if section == "compress_pass":
                entries["compress_pass"] = body
            else:
                for name, attrs in (body or {}).items():
                    entries[name] = attrs
        for name, attrs in entries.items():
            if not isinstance(attrs, dict) or "class" not in attrs:
                raise ValueError(
                    f"config entry {name!r} needs a 'class' key")
        registry = _registry()
        names = set(entries)

        def resolve(val):
            """A named entry's instance for its name; _UNRESOLVED while
            that entry is not built yet."""
            if isinstance(val, str) and val in names:
                return self.instances.get(val, _UNRESOLVED)
            if isinstance(val, list):
                out = [resolve(v) for v in val]
                return (_UNRESOLVED if any(v is _UNRESOLVED for v in out)
                        else out)
            return val

        remaining = list(entries.items())
        while remaining:
            still = []
            for name, attrs in remaining:
                inst = self._build(attrs, registry, resolve)
                if inst is _UNRESOLVED:
                    still.append((name, attrs))
                else:
                    self.instances[name] = inst
            if len(still) == len(remaining):
                raise ValueError(
                    f"config entries {[n for n, _ in still]} have "
                    "circular or unknown references")
            remaining = still

    def _build(self, attrs, registry, resolve):
        cls = registry.get(attrs["class"])
        if cls is None:
            raise ValueError(f"unknown slim class {attrs['class']!r}")
        sig = inspect.signature(cls.__init__)
        keys = {p.name for p in sig.parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD} - {"self"}
        kwargs = {}
        for key in set(attrs) & keys:
            val = resolve(attrs[key])
            if val is _UNRESOLVED:
                return _UNRESOLVED
            kwargs[key] = val
        inst = cls(**kwargs)
        # a CompressPass takes its strategies through add_strategy (which
        # raises its epoch to theirs), not its constructor
        if attrs["class"] == "CompressPass":
            strategies = resolve(attrs.get("strategies") or [])
            if strategies is _UNRESOLVED:
                return _UNRESOLVED
            for s in strategies:
                inst.add_strategy(s)
        return inst
