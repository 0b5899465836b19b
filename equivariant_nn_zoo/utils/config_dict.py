"""ConfigDict — a dict with attribute access, for the model configs.

The configs build nested settings as ``config.model_config.n_dim = 64``.
Nested plain dicts become ConfigDicts when stored, so attribute access
reaches every level; dicts inside lists and tuples (the layer lists) are
left as they are.  Being a ``dict`` subclass, a ConfigDict passes every
``isinstance(node, dict)`` check in ``build`` and the layer executors.
"""

from __future__ import annotations


class ConfigDict(dict):
    __slots__ = ()

    def __init__(self, initial=None, **kwargs):
        super().__init__()
        self.update(initial or {}, **kwargs)

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def update(self, other=(), **kwargs):
        items = other.items() if hasattr(other, "items") else other
        for key, value in items:
            self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def to_dict(self) -> dict:
        """Plain nested dicts (recursively through ConfigDict values)."""
        return {
            k: v.to_dict() if isinstance(v, ConfigDict) else v
            for k, v in self.items()
        }

    def update_from_flattened_dict(self, flat: dict):
        """Set ``{"a.b.c": v}`` into ``self.a.b.c``; every parent must
        already exist (KeyError otherwise)."""
        for dotted, value in flat.items():
            *parents, leaf = dotted.split(".")
            node = self
            for name in parents:
                node = node[name]
            node[leaf] = value
