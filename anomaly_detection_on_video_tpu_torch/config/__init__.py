"""Config composition over the repository's ``configs/`` (port's copy)."""

from .compose import (
    compose,
    load_yaml,
    merge,
    parse_overrides,
    parse_value,
    resolve_interpolations,
    to_container,
)
from .registry import instantiate, locate

__all__ = [
    "compose",
    "load_yaml",
    "merge",
    "parse_overrides",
    "parse_value",
    "resolve_interpolations",
    "to_container",
    "instantiate",
    "locate",
]
