"""Mode registry, the unit of optimization (port of `opt/mode.py`).

A mode is a named, replayable model transformation with a serializable
config: `convert` maps a model handle to a new handle and metadata,
`restore` replays the transformation from (config, metadata), which is how
a checkpoint rebuilds its quantizer state before the weights load.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

ConvertFn = Callable[..., tuple[Any, dict]]  # (handle, config, **kw) -> (handle, metadata)
RestoreFn = Callable[..., Any]  # (handle, config, metadata) -> handle


@dataclasses.dataclass(frozen=True)
class ModeDescriptor:
    name: str
    convert: ConvertFn
    restore: RestoreFn
    config_to_dict: Callable[[Any], dict]
    config_from_dict: Callable[[dict], Any]
    next_modes: Optional[tuple[str, ...]] = None  # which modes may follow (None: any)
    export_mode: Optional[str] = None  # the mode that exports / strips this one


class ModeRegistry:
    """A technique's registry, and the lookup over every technique's."""

    _all: dict[str, "ModeRegistry"] = {}

    def __init__(self, technique: str):
        self.technique = technique
        self._modes: dict[str, ModeDescriptor] = {}
        ModeRegistry._all[technique] = self

    def register(self, desc: ModeDescriptor) -> ModeDescriptor:
        if desc.name in self._modes:
            raise ValueError(f"mode {desc.name!r} already registered in {self.technique}")
        self._modes[desc.name] = desc
        return desc

    def __contains__(self, name: str) -> bool:
        return name in self._modes

    def __getitem__(self, name: str) -> ModeDescriptor:
        return self._modes[name]

    @staticmethod
    def get_global(name: str) -> ModeDescriptor:
        for reg in ModeRegistry._all.values():
            if name in reg:
                return reg[name]
        raise KeyError(f"mode {name!r} not registered in any technique registry")

    @staticmethod
    def all_modes() -> dict[str, ModeDescriptor]:
        out = {}
        for reg in ModeRegistry._all.values():
            out.update(reg._modes)
        return out
