"""Typed runtime parameter registry (a copy of
modular_slam_tpu/utils/params.py, which the port may not import).

Number (min/max/step) and Choice definitions under string keys, with
subscriptions for new parameters and for changes.  The reference's three
bugs stay fixed as in the JAX package: registering returns True on
success, the range check accepts in-range values, and numbers are tagged
NUMBER.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence


class ParameterType(enum.Enum):
    NUMBER = "number"
    CHOICE = "choice"


@dataclasses.dataclass
class ParameterDefinition:
    key: str
    type: ParameterType
    value: Any
    min: Optional[float] = None
    max: Optional[float] = None
    step: Optional[float] = None
    choices: Optional[Sequence[Any]] = None


def make_number_parameter(key: str, value: float, lo: float, hi: float,
                          step: float = 1.0) -> ParameterDefinition:
    return ParameterDefinition(key, ParameterType.NUMBER, value, lo, hi, step)


def make_choice_parameter(key: str, value: Any,
                          choices: Sequence[Any]) -> ParameterDefinition:
    return ParameterDefinition(key, ParameterType.CHOICE, value,
                               choices=list(choices))


class ParameterRegistry:
    """In-memory registry with validation + subscriptions."""

    def __init__(self):
        self._params: Dict[str, ParameterDefinition] = {}
        self._subscribers: List[Callable[[ParameterDefinition], None]] = []
        self._change_subscribers: List[Callable[[str, Any], None]] = []

    def register(self, definition: ParameterDefinition) -> bool:
        if definition.key in self._params:
            return False
        if not self._validate(definition, definition.value):
            return False
        self._params[definition.key] = definition
        for cb in self._subscribers:
            cb(definition)
        return True

    def register_number(self, key: str, value: float, lo: float, hi: float,
                        step: float = 1.0) -> bool:
        return self.register(make_number_parameter(key, value, lo, hi, step))

    def register_choice(self, key: str, value: Any,
                        choices: Sequence[Any]) -> bool:
        return self.register(make_choice_parameter(key, value, choices))

    def set(self, key: str, value: Any) -> bool:
        p = self._params.get(key)
        if p is None or not self._validate(p, value):
            return False
        p.value = value
        for cb in self._change_subscribers:
            cb(key, value)
        return True

    def get(self, key: str) -> Any:
        p = self._params.get(key)
        if p is None:
            raise KeyError(key)
        return p.value

    def has(self, key: str) -> bool:
        return key in self._params

    def names(self) -> List[str]:
        return list(self._params)

    def definitions(self) -> List[ParameterDefinition]:
        return list(self._params.values())

    def subscribe_on_new_parameter(
            self, cb: Callable[[ParameterDefinition], None]) -> None:
        """GUI-facing: called for every future registration, and replayed
        for existing ones (the reference replays on subscribe too)."""
        self._subscribers.append(cb)
        for p in self._params.values():
            cb(p)

    def subscribe_on_change(self, cb: Callable[[str, Any], None]) -> None:
        self._change_subscribers.append(cb)

    @staticmethod
    def _validate(p: ParameterDefinition, value: Any) -> bool:
        if p.type == ParameterType.NUMBER:
            if not isinstance(value, (int, float)):
                return False
            return p.min <= value <= p.max
        return value in (p.choices or ())
