"""Explicit field checks shared by the plain-dataclass schemas.

The reference package validates with pydantic; the port cannot count on
pydantic being installed, so each schema reads its mapping through these
helpers.  A key the slice does not model raises
:class:`UnsupportedFeatureError`; any other unknown key raises
:class:`PayloadError`.  Nothing is silently ignored.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any

from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError


def read_fields(
    data: object,
    where: str,
    *,
    known: tuple[str, ...],
    required: tuple[str, ...] = (),
    unsupported: tuple[str, ...] = (),
) -> dict[str, Any]:
    """The mapping ``data`` as a dict, after checking its keys.

    Keys in ``unsupported`` are refused when their value is not None (an
    explicit ``null`` means the feature is off).
    """
    if not isinstance(data, Mapping):
        msg = f"{where}: expected a mapping, got {type(data).__name__}"
        raise PayloadError(msg)
    out = dict(data)
    for key in out:
        if key in unsupported:
            if out[key] is not None:
                raise UnsupportedFeatureError(key, where)
        elif key not in known:
            msg = f"{where}: unknown field {key!r}"
            raise PayloadError(msg)
    for key in required:
        if key not in out:
            msg = f"{where}: missing required field {key!r}"
            raise PayloadError(msg)
    return out


def as_float(value: object, name: str) -> float:
    """A finite number (int or float, never bool) as a float."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        msg = f"{name} must be a number (int or float), got {value!r}"
        raise PayloadError(msg)
    out = float(value)
    if not math.isfinite(out):
        msg = f"{name} must be finite, got {value!r}"
        raise PayloadError(msg)
    return out


def as_int(value: object, name: str) -> int:
    """An integer; an integral float (``10.0``) is accepted, as the
    reference's lax integer fields accept it."""
    if isinstance(value, bool):
        msg = f"{name} must be an integer, got {value!r}"
        raise PayloadError(msg)
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    msg = f"{name} must be an integer, got {value!r}"
    raise PayloadError(msg)


def as_str(value: object, name: str) -> str:
    if not isinstance(value, str):
        msg = f"{name} must be a string, got {value!r}"
        raise PayloadError(msg)
    return value


def as_enum(enum_cls: type, value: object, name: str):
    try:
        return enum_cls(value)
    except ValueError:
        allowed = ", ".join(repr(m.value) for m in enum_cls)
        msg = f"{name} must be one of {allowed}, got {value!r}"
        raise PayloadError(msg) from None


def check_range(
    value: float,
    name: str,
    *,
    ge: float | None = None,
    gt: float | None = None,
    le: float | None = None,
) -> None:
    if ge is not None and not value >= ge:
        msg = f"{name} must be >= {ge}, got {value}"
        raise PayloadError(msg)
    if gt is not None and not value > gt:
        msg = f"{name} must be > {gt}, got {value}"
        raise PayloadError(msg)
    if le is not None and not value <= le:
        msg = f"{name} must be <= {le}, got {value}"
        raise PayloadError(msg)


def as_list(value: object, name: str) -> list:
    if not isinstance(value, (list, tuple)):
        msg = f"{name} must be a list, got {type(value).__name__}"
        raise PayloadError(msg)
    return list(value)
