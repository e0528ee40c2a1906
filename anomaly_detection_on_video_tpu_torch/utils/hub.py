"""Weights and features from a local Hugging Face hub cache (counterpart of
the JAX package's ``utils/hub.py``).

The reference downloads its I3D weights from the HF model repo
``jinmang2/test_video_fe`` and its features from the dataset repo
``jinmang2/ucf_crime_tencrop_i3d_seg32``. The CLIs take such artifacts
behind an explicit scheme, so a weight flag stays a plain local path by
default:

    --weights hf://jinmang2/test_video_fe/converted_ref_i3d.pt
    --weights hf://org/repo@revision/sub/dir/file.pt

The port downloads nothing and does not use ``huggingface_hub``: it reads
the hub's standard cache layout itself, as ``hf_hub_download`` does on an
offline host. The cache root is ``cache_dir``, else ``HF_HUB_CACHE`` (or
the older ``HUGGINGFACE_HUB_CACHE``), else ``$HF_HOME/hub``, else
``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``,
read when a spec is resolved. A repo ``org/name`` of type ``model`` lives in
``<root>/models--org--name`` (``datasets--`` for a dataset); the revision
(``main`` unless given) names a file under ``refs/`` that holds a commit
hash, or is a 40-hex commit hash itself; the file is
``snapshots/<commit>/<path>``. A spec that does not resolve raises
``FileNotFoundError``; nothing falls back to random weights.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional, Tuple

# reference src/i3d.py:12-18: model-name -> filename in jinmang2/test_video_fe
WEIGHTS_HUB = "jinmang2/test_video_fe"
DEFAULT_WEIGHT_FILES = {
    "tushar-n-baseline": "converted_ref_i3d.pt",
    "i3d_8x8_r50": "I3D_8x8_R50.pyth",
}

_SCHEME = "hf://"
_COMMIT_HASH = re.compile(r"^[0-9a-f]{40}$")


def is_hub_spec(spec: Optional[str]) -> bool:
    return isinstance(spec, str) and spec.startswith(_SCHEME)


def default_weight_spec(model_name: str) -> str:
    """The reference's automatic weight artifact for ``model_name``."""
    try:
        filename = DEFAULT_WEIGHT_FILES[model_name]
    except KeyError:
        raise ValueError(
            f"no default hub weights for model {model_name!r} "
            f"(known: {sorted(DEFAULT_WEIGHT_FILES)})"
        ) from None
    return f"{_SCHEME}{WEIGHTS_HUB}/{filename}"


def parse_hub_spec(spec: str) -> Tuple[str, Optional[str], str]:
    """Split ``hf://org/repo[@revision]/path/to/file`` into ``(repo_id,
    revision, filename)``; ``revision`` is ``None`` without ``@``. A repo id
    is two path segments; the rest is the in-repo filename, so a revision
    that contains ``/`` cannot be written: use its commit hash."""
    if not is_hub_spec(spec):
        raise ValueError(f"not an hf:// spec: {spec!r}")
    parts = spec[len(_SCHEME):].split("/")
    if len(parts) < 3 or not all(parts[:3]):
        raise ValueError(
            f"malformed hub spec {spec!r}: expected "
            "hf://org/repo[@revision]/path/to/file"
        )
    org, repo = parts[0], parts[1]
    revision: Optional[str] = None
    if "@" in repo:
        repo, _, revision = repo.partition("@")
        if not repo or not revision:
            raise ValueError(
                f"malformed hub spec {spec!r}: empty repo or revision "
                "around '@'"
            )
    return f"{org}/{repo}", revision, "/".join(parts[2:])


def hub_cache_root(cache_dir: Optional[str] = None) -> str:
    """The hub cache directory, in ``huggingface_hub``'s order of lookup."""
    if cache_dir is not None:
        return str(cache_dir)
    root = os.getenv("HF_HUB_CACHE") or os.getenv("HUGGINGFACE_HUB_CACHE")
    if root is None:
        home = os.getenv("HF_HOME") or os.path.join(
            os.getenv("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
            "huggingface")
        root = os.path.join(os.path.expandvars(os.path.expanduser(home)), "hub")
    return os.path.expandvars(os.path.expanduser(root))


def cached_file(repo_id: str, filename: str, revision: Optional[str] = None,
                cache_dir: Optional[str] = None, repo_type: str = "model") -> str:
    """The snapshot path of ``filename`` in the cache of ``repo_id`` at
    ``revision`` (``main`` when ``None``), the path ``hf_hub_download``
    returns offline. Raises ``FileNotFoundError`` when the revision or the
    file is not cached, ``ValueError`` for a filename that leaves the
    snapshot."""
    revision = revision or "main"
    storage = os.path.join(hub_cache_root(cache_dir),
                           "--".join([f"{repo_type}s", *repo_id.split("/")]))
    commit = revision
    if not _COMMIT_HASH.match(revision):
        ref = os.path.join(storage, "refs", revision)
        if not os.path.isfile(ref):
            raise FileNotFoundError(f"{repo_type} {repo_id!r}: revision {revision!r} is not "
                                    f"in the cache ({ref} is missing)")
        with open(ref) as f:
            commit = f.read()
    snapshots = os.path.join(storage, "snapshots")
    path = os.path.join(snapshots, commit, *filename.split("/"))
    if Path(os.path.abspath(snapshots)) not in Path(os.path.abspath(path)).parents:
        raise ValueError(f"invalid filename {filename!r}: it leaves the snapshot folder")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{repo_type} {repo_id!r}: {filename!r} is not cached at "
                                f"revision {revision!r}")
    return path


def resolve_weights(spec: Optional[str], cache_dir: Optional[str] = None) -> Optional[str]:
    """A ``--weights`` value -> a local file path.

    Local paths (and ``None``) pass through; an ``hf://`` spec resolves in
    the local hub cache (``cached_file``). An artifact that is not cached
    raises ``FileNotFoundError`` with the JAX package's remediation hint,
    the same contract as the feature zips' (``data/features.py``)."""
    if not is_hub_spec(spec):
        return spec
    repo_id, revision, filename = parse_hub_spec(spec)
    try:
        return cached_file(repo_id, filename, revision, cache_dir)
    except FileNotFoundError as exc:
        raise FileNotFoundError(
            f"cannot download {repo_id}/{filename} from the HF hub "
            f"({type(exc).__name__}: no network, not cached, or a bad "
            f"repo/file/revision in {spec!r}; the port reads the local HF cache and does not "
            f"download). Pass a local file instead, "
            f"e.g. --weights /path/to/{filename.rsplit('/', 1)[-1]}"
        ) from exc
