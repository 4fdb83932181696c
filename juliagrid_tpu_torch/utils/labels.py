"""Label registry: ordered label -> 0-based index mapping.

Equivalent of the reference's OrderedDict label machinery with ``"?"``
auto-numbering and ``"@name ?"`` templating
(JuliaGrid src/backend/utility.jl:151-318). Internal indices are
0-based (Python/JAX convention); labels are user-facing ints or strings.
"""

from __future__ import annotations
from .errors import LabelError


class LabelRegistry:
    __slots__ = ("_map", "_keys", "counter", "template")

    def __init__(self, template: str = "?"):
        self._map: dict = {}
        self._keys: list = []
        self.counter = 0          # highest integer label seen (reference layout.label)
        self.template = template  # "?" or e.g. "Bus ?"

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, label) -> bool:
        return label in self._map

    def add(self, label=None) -> int:
        """Register ``label`` (or auto-generate one); return its index."""
        idx = len(self._keys)
        if label is None:
            n = self.counter + 1
            label = n if self.template == "?" else self.template.replace("?", str(n))
        if isinstance(label, int):
            self.counter = max(self.counter, label)
        else:
            self.counter += 1
        if label in self._map:
            raise LabelError(f"the label {label!r} is not unique")
        self._map[label] = idx
        self._keys.append(label)
        return idx

    def index(self, label) -> int:
        try:
            return self._map[label]
        except KeyError:
            raise LabelError(f"the label {label!r} does not exist") from None

    def label(self, idx: int):
        return self._keys[idx]

    def labels(self) -> list:
        return list(self._keys)

    def items(self):
        return self._map.items()

    def copy(self) -> "LabelRegistry":
        new = LabelRegistry(self.template)
        new._map = dict(self._map)
        new._keys = list(self._keys)
        new.counter = self.counter
        return new
