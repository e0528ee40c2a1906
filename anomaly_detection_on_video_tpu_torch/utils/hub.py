"""Weights and features from the Hugging Face hub or its local cache
(counterpart of the JAX package's ``utils/hub.py``).

The reference downloads its I3D weights from the HF model repo
``jinmang2/test_video_fe`` and its features from the dataset repo
``jinmang2/ucf_crime_tencrop_i3d_seg32``. The CLIs take such artifacts
behind an explicit scheme, so a weight flag stays a plain local path by
default:

    --weights hf://jinmang2/test_video_fe/converted_ref_i3d.pt
    --weights hf://org/repo@revision/sub/dir/file.pt

Where ``huggingface_hub`` is installed, a spec downloads through its
``hf_hub_download`` (the standard HF cache, ``HF_HUB_OFFLINE``), as in the
JAX package; the package is imported only when a spec is resolved. Where it
is not, the port reads the hub's standard cache layout itself, as
``hf_hub_download`` does on an offline host, and downloads nothing
(``cached_file``). The cache root is ``cache_dir``, else ``HF_HUB_CACHE`` (or
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


def _hub_failure_types() -> tuple:
    """The ``huggingface_hub`` errors that mean an artifact cannot be had:
    not cached offline, a wrong repo, file or revision, a gated repo, an
    HTTP failure. Older versions keep them in ``huggingface_hub.utils``
    (or lack some); a missing name is skipped."""
    try:
        from huggingface_hub import errors as hub_errors
    except ImportError:  # versions before the errors module
        try:
            from huggingface_hub import utils as hub_errors
        except ImportError:
            hub_errors = None
    return tuple(
        t for t in (getattr(hub_errors, name, None)
                    for name in ("LocalEntryNotFoundError", "RepositoryNotFoundError",
                                 "EntryNotFoundError", "RevisionNotFoundError", "GatedRepoError",
                                 "HfHubHTTPError"))
        if hub_errors is not None and t is not None) or (FileNotFoundError,)


def resolve_weights(spec: Optional[str], cache_dir: Optional[str] = None) -> Optional[str]:
    """A ``--weights`` value -> a local file path.

    Local paths (and ``None``) pass through. An ``hf://`` spec downloads
    through ``hf_hub_download`` where ``huggingface_hub`` imports, else
    resolves in the local hub cache (``cached_file``). An artifact that
    cannot be had raises ``FileNotFoundError`` with the JAX package's
    remediation hint; the cache reader's text adds that it does not
    download."""
    if not is_hub_spec(spec):
        return spec
    repo_id, revision, filename = parse_hub_spec(spec)
    hint = f"Pass a local file instead, e.g. --weights /path/to/{filename.rsplit('/', 1)[-1]}"
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        try:
            return cached_file(repo_id, filename, revision, cache_dir)
        except FileNotFoundError as exc:
            raise FileNotFoundError(
                f"cannot download {repo_id}/{filename} from the HF hub "
                f"({type(exc).__name__}: no network, not cached, or a bad "
                f"repo/file/revision in {spec!r}; the port reads the local HF cache and does not "
                f"download). {hint}") from exc
    try:
        return hf_hub_download(repo_id=repo_id, filename=filename, revision=revision,
                               cache_dir=cache_dir)
    except _hub_failure_types() as exc:
        raise FileNotFoundError(
            f"cannot download {repo_id}/{filename} from the HF hub "
            f"({type(exc).__name__}: no network, not cached, or a bad "
            f"repo/file/revision in {spec!r}). {hint}") from exc
