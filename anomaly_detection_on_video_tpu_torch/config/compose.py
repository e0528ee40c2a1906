"""Hydra-like YAML config-group composition (the port's own copy of the
JAX package's ``config/compose.py``; same grammar and results).

- a root YAML's ``defaults`` list of ``{group: choice}`` entries loads
  ``<config_dir>/<group>/<choice>.yaml`` into ``cfg[group]`` (nested groups
  such as ``trainer/callbacks`` land at ``cfg.trainer.callbacks``);
  ``_self_`` positions the root file's own keys;
- CLI overrides: ``group=choice`` re-selects a group file; ``a.b.c=value``
  deep-sets a value (YAML-parsed, ``1e-3`` is a float); ``+a.b=value`` adds
  a new key, ``++a.b=value`` adds or overrides, ``~a.b`` deletes a key
  (``~a.b=value`` only when it holds that value) and ``~group`` drops a
  group from the defaults list;
- ``${a.b}``, ``${hydra:runtime.choices.<group>}`` and ``${now:<fmt>}``
  interpolations resolve after the overrides.

Choices are recorded in ``cfg["_choices_"]``. PyYAML is imported only where
YAML is parsed (``load_yaml``, ``parse_value``), so a composed dict can be
used where PyYAML is not installed.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Bare scientific notation that YAML 1.1 parses as a string but Hydra treats
# as a float (e.g. "1e-3"). Quoted tokens never match (the quote chars break
# the pattern), and words like "nan"/"inf" stay strings, matching Hydra.
_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def merge(base: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``other`` into a copy of ``base`` (other wins)."""
    out = copy.deepcopy(base)
    for key, val in other.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def _deep_set(cfg: Dict[str, Any], dotted: str, value: Any, mode: Any) -> None:
    """Deep-set ``dotted`` to ``value``.

    ``mode`` is Hydra's override prefix: ``False`` (no prefix — the key must
    already exist), ``True`` (``+`` — the key must NOT exist yet) or ``"++"``
    (add-or-override unconditionally).
    """
    allow_new = mode is not False
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        if key in node and not isinstance(node[key], dict):
            # Hydra errors when an override path traverses a non-dict node;
            # silently replacing e.g. an int with {} would clobber config
            raise KeyError(
                f"override path {dotted!r}: {key!r} holds a non-dict value "
                f"({node[key]!r}) and cannot be traversed into"
            )
        if key not in node:
            if not allow_new:
                raise KeyError(
                    f"override path {dotted!r}: {key!r} not in config "
                    f"(use +{dotted}=... to add new keys)"
                )
            node[key] = {}
        node = node[key]
    last = keys[-1]
    if not allow_new and last not in node:
        raise KeyError(
            f"override key {dotted!r} does not exist "
            f"(use +{dotted}=... to add new keys)"
        )
    if mode is True and last in node:
        raise KeyError(
            f"could not append to config: an item is already at {dotted!r}; "
            f"either remove the + prefix ({dotted}=...) or use a second + "
            f"to add-or-override (++{dotted}=...)"
        )
    node[last] = value


# "no expected value" marker for ~key deletions without an =value part
_UNSET = object()


class _DeleteGroup:
    """Marker for a ``~group[=choice]`` defaults-list deletion.

    Hydra's delete grammar requires the ``=choice`` part, when given, to
    match the choice actually being deleted (``~runner=mgfn`` errors if the
    defaults list selects ``runner: default``); ``expected is None`` means
    the bare ``~group`` form, which deletes unconditionally.
    """

    def __init__(self, expected: Optional[str]) -> None:
        self.expected = expected

    def __repr__(self) -> str:  # aids error messages / debugging
        return f"~group={self.expected}" if self.expected else "~group"


def _deep_del(cfg: Dict[str, Any], dotted: str, expected: Any = _UNSET) -> None:
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        if not isinstance(node.get(key), dict):
            raise KeyError(
                f"cannot delete {dotted!r}: {key!r} not in config"
            )
        node = node[key]
    last = keys[-1]
    if last not in node:
        raise KeyError(f"cannot delete {dotted!r}: key not in config")
    if expected is not _UNSET and node[last] != expected:
        raise ValueError(
            f"cannot delete {dotted!r}: current value is {node[last]!r}, "
            f"not {expected!r}"
        )
    del node[last]


def parse_value(raw: str) -> Any:
    """Parse one CLI override value with Hydra-style scalar semantics.

    YAML typing (``[1,2]`` lists, ``true`` bools, numbers) plus the
    scientific-notation float coercion; quoted tokens stay strings.
    Raises ValueError naming the offending token on unparseable input.
    """
    import yaml

    try:
        value = yaml.safe_load(raw) if raw != "" else None
    except yaml.YAMLError as exc:
        raise ValueError(f"could not parse override value {raw!r}: {exc}")
    if isinstance(value, str) and _SCI_FLOAT.match(raw):
        value = float(value)
    return value


def parse_overrides(
    args: Iterable[str], config_dir: Optional[str] = None
) -> Tuple[Dict[str, Any], List[Tuple[str, Any, Any]]]:
    """Split CLI args into group selections and value overrides.

    Returns ``(group_choices, value_overrides)`` where value_overrides are
    ``(dotted_key, parsed_value, mode)`` tuples, ``mode`` one of ``False``
    (plain set), ``True`` (``+`` — add a NEW key; errors if it exists, like
    Hydra), ``"++"`` (add-or-override), or ``"~"`` (delete; the value is the
    expected current value, or the ``_UNSET`` sentinel for bare ``~key``).
    A deleted group appears in ``group_choices`` as a :class:`_DeleteGroup`
    carrying the expected choice (``None`` for bare ``~group``).

    A dot-free ``key=value`` is a group selection only when ``key`` names a
    config-group *directory* under ``config_dir``; otherwise it is a root
    value override (Hydra behavior — ``seed=1`` and ``wandb_key=KEY`` are
    plain overrides of root keys, reference: configs/default.yaml:9,
    run.py:9-12). Without a ``config_dir`` every dot-free key is treated as
    a group selection (legacy behavior, kept for direct callers).
    """
    groups: Dict[str, Any] = {}
    values: List[Tuple[str, Any, Any]] = []
    for arg in args:
        delete = arg.startswith("~")
        body = arg[1:] if delete else arg
        if "=" not in body:
            if not delete:
                raise ValueError(f"override {arg!r} must look like key=value")
            key, raw = body, None
        else:
            key, _, raw = body.partition("=")
        plus = len(key) - len(key.lstrip("+"))
        if delete and plus:
            raise ValueError(f"override {arg!r}: '~' and '+' cannot combine")
        if plus > 2:
            raise ValueError(
                f"override {arg!r}: at most two '+' prefixes (+key adds, "
                f"++key adds-or-overrides)"
            )
        allow_new = plus > 0
        key = key.lstrip("+")
        if not key:
            raise ValueError(f"override {arg!r} has an empty key")
        # YAML 1.1 parses bare scientific notation ("1e-3") as a string;
        # Hydra treats it as a float — parse_value matches that, keying off
        # the raw token so explicitly quoted strings ('"1e-3"') and bare
        # words (nan, inf) stay strings, like Hydra.
        value = parse_value(raw) if raw is not None else _UNSET
        if "." in key:
            is_group = False
        elif config_dir is not None:
            # a dot-free key naming a config-group DIRECTORY is a group
            # selection whether or not it is '+'-prefixed (Hydra's
            # +group=choice adds a group to the defaults; without this,
            # '+runner=mgfn' would clobber the composed runner dict with
            # the bare string 'mgfn')
            is_group = os.path.isdir(os.path.join(config_dir, key))
        else:
            is_group = not allow_new and not delete  # legacy direct callers
        if is_group:
            if plus == 2:
                # Hydra rejects '++' on defaults-list groups; only value
                # keys take the add-or-override prefix
                raise ValueError(
                    f"override {arg!r}: '++' cannot apply to config group "
                    f"{key!r} (use {key}={raw} to re-select or "
                    f"+{key}={raw} to add it)"
                )
            # group selection (e.g. runner=mgfn) or deletion (~runner /
            # ~runner=choice, the latter requiring the choice to match);
            # resolved against config dir
            groups[key] = _DeleteGroup(raw) if delete else str(raw)
        else:
            if delete:
                mode: Any = "~"
            elif plus == 2:
                mode = "++"
            else:
                mode = allow_new
            values.append((key, value, mode))
    return groups, values


def _load_group(config_dir: str, group: str, choice: str) -> Dict[str, Any]:
    path = os.path.join(config_dir, group, f"{choice}.yaml")
    if not os.path.exists(path):
        available = []
        gdir = os.path.join(config_dir, group)
        if os.path.isdir(gdir):
            available = sorted(
                os.path.splitext(f)[0] for f in os.listdir(gdir) if f.endswith(".yaml")
            )
        raise FileNotFoundError(
            f"config group {group!r} has no choice {choice!r}; available: {available}"
        )
    content = load_yaml(path)
    # nested defaults (Hydra group-local composition): e.g.
    # trainer/callbacks/all.yaml lists sibling choices to merge in order,
    # with the file's own keys winning (reference configs/trainer/callbacks/all.yaml)
    nested = content.pop("defaults", [])
    if not nested:
        return content
    merged: Dict[str, Any] = {}
    for entry in nested:
        if entry == "_self_":
            merged = merge(merged, content)
            continue
        if isinstance(entry, str):
            merged = merge(merged, _load_group(config_dir, group, entry))
        else:
            # {subgroup: choice} selects group/subgroup/<choice>.yaml and
            # nests its content under the subgroup key (Hydra semantics)
            (sub, choice), = entry.items()
            merged = merge(
                merged,
                {sub: _load_group(config_dir, f"{group}/{sub}", str(choice))},
            )
    if "_self_" not in nested:
        merged = merge(merged, content)
    return merged


def _set_group(cfg: Dict[str, Any], group: str, content: Dict[str, Any]) -> None:
    """Place a group file's content at the nested path given by ``group``."""
    keys = group.split("/")
    node = cfg
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    existing = node.get(keys[-1])
    if isinstance(existing, dict) and isinstance(content, dict):
        node[keys[-1]] = merge(existing, content)
    else:
        node[keys[-1]] = content


def compose(
    config_dir: str,
    config_name: str = "default",
    overrides: Optional[Iterable[str]] = None,
) -> Dict[str, Any]:
    """Compose the run config exactly like the reference's Hydra root.

    Reference semantics: configs/default.yaml declares a defaults list whose
    group choices may be re-selected from the CLI; remaining CLI args deep-set
    values (reference: run.py:15-16 + configs/default.yaml:1-9).
    """
    root = load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])
    group_over, value_over = parse_overrides(overrides or [], config_dir)

    cfg: Dict[str, Any] = {}
    choices: Dict[str, str] = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            cfg = merge(cfg, root)
            self_done = True
            continue
        if isinstance(entry, str):
            group, choice = entry, "default"
        else:
            (group, choice), = entry.items()
        selected = group_over.pop(group, choice)
        if isinstance(selected, _DeleteGroup):  # ~group / ~group=choice
            if selected.expected is not None and str(selected.expected) != str(
                choice
            ):
                raise ValueError(
                    f"cannot delete config group {group!r}: selected choice "
                    f"is {choice!r}, not {selected.expected!r}"
                )
            continue
        choice = selected
        if choice in (None, "null", "none"):  # null selection
            continue
        choices[group] = choice
        _set_group(cfg, group, _load_group(config_dir, group, str(choice)))
    if not self_done:
        cfg = merge(cfg, root)

    # group selections not present in the defaults list are still honored
    for group, choice in group_over.items():
        if isinstance(choice, _DeleteGroup):
            raise ValueError(
                f"cannot delete config group {group!r}: "
                "not in the defaults list"
            )
        choices[group] = choice
        _set_group(cfg, group, _load_group(config_dir, group, choice))

    for dotted, value, mode in value_over:
        if mode == "~":
            _deep_del(cfg, dotted, value)
        else:
            _deep_set(cfg, dotted, value, mode)

    cfg["_choices_"] = choices
    return resolve_interpolations(cfg)


def to_container(cfg: Any) -> Any:
    """A plain-container copy of ``cfg`` (a deep copy: composed configs are
    plain dicts already), kept for the JAX package's API."""
    return copy.deepcopy(cfg)


# ${...} interpolation grammar (innermost-first so ${a.${b}} resolves)
_INTERP = re.compile(r"\$\{([^${}]+)\}")
# placeholder protecting the \${ escape during substitution
_ESCAPED_INTERP = "\x00escaped-interp\x00"


def resolve_interpolations(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve OmegaConf/Hydra-style ``${...}`` value interpolations.

    The reference's configs rely on Hydra interpolation (the W&B run name,
    reference: configs/trainer/logger/wandb.yaml:3, interpolates
    ``${hydra:runtime.choices.*}`` and ``${now:...}``); user-authored config
    files here get the same grammar. Supported forms:

    - ``${a.b.c}`` — absolute dotted path into the composed config. A value
      that is exactly one interpolation keeps the referenced type
      (``bs: ${data.batch_size}`` stays an int); embedded in a larger
      string it is stringified (``None`` becomes the empty string).
    - ``${hydra:runtime.choices.<group>}`` — the selected config-group
      choice (recorded in ``cfg["_choices_"]``).
    - ``${now:<strftime format>}`` — current-time formatting.
    - ``\\${`` escapes a literal ``${``.

    Unknown keys, unsupported resolvers, and reference cycles raise
    ``ValueError`` naming the interpolation. Called by :func:`compose` after
    all CLI overrides are applied, so interpolations see final values.
    """

    def lookup(expr: str, stack: Tuple[str, ...]) -> Any:
        name = expr.strip()
        if name in stack:
            raise ValueError(
                "interpolation cycle: " + " -> ".join(stack + (name,))
            )
        if ":" in name:
            resolver, _, arg = name.partition(":")
            if resolver == "now":
                import datetime

                return datetime.datetime.now().strftime(arg)
            if name.startswith("hydra:runtime.choices."):
                group = name[len("hydra:runtime.choices.") :]
                choices = cfg.get("_choices_", {})
                if group not in choices:
                    raise ValueError(
                        f"interpolation ${{{name}}}: no choice recorded for "
                        f"config group {group!r} "
                        f"(recorded: {sorted(choices)})"
                    )
                return choices[group]
            raise ValueError(
                f"interpolation ${{{name}}}: unsupported resolver "
                f"{resolver!r} (supported: dotted config paths, "
                f"hydra:runtime.choices.<group>, now:<strftime>)"
            )
        node: Any = cfg
        for part in name.split("."):
            if not (isinstance(node, dict) and part in node):
                raise ValueError(
                    f"interpolation ${{{name}}} does not resolve to a "
                    f"config key ({part!r} not found)"
                )
            node = node[part]
        return resolve(node, stack + (name,))

    def resolve(value: Any, stack: Tuple[str, ...]) -> Any:
        if isinstance(value, dict):
            return {k: resolve(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, stack) for v in value]
        if not isinstance(value, str) or "${" not in value:
            return value
        text = value.replace("\\${", _ESCAPED_INTERP)
        for _ in range(20):
            if "${" not in text:
                break
            full = _INTERP.fullmatch(text)
            if full is not None:
                # a pure interpolation keeps the referenced value's type
                return lookup(full.group(1), stack)

            def sub(match: "re.Match[str]") -> str:
                result = lookup(match.group(1), stack)
                if isinstance(result, (dict, list)):
                    raise ValueError(
                        f"interpolation ${{{match.group(1).strip()}}} is a "
                        f"container; it cannot be embedded in a string"
                    )
                text = "" if result is None else str(result)
                # OmegaConf does not re-interpolate substitution output: a
                # referenced value containing a literal '${' (e.g. from an
                # escaped '\\${') must survive as text, not be re-scanned
                return text.replace("${", _ESCAPED_INTERP)

            new = _INTERP.sub(sub, text)
            if new == text:  # leftover "${" with no parseable body: literal
                break
            text = new
        else:
            raise ValueError(f"interpolation nests too deeply in {value!r}")
        return text.replace(_ESCAPED_INTERP, "${")

    return resolve(cfg, ())
