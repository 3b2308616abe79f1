"""Tiny name -> strategy registry shared by the ``repro_torch.api``
detector and execution-backend extension points."""
from __future__ import annotations


class Registry:
    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._items: dict[str, object] = {}

    def register(self, name: str, obj) -> None:
        self._items[name] = obj

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._items))

    def get(self, name: str):
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(self.names())}") from None
