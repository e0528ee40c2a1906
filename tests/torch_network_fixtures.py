"""Stand-ins for the network mode's optional packages: one set, shared by
the port's tests that hold it to the JAX package
(``tests/test_torch_network_mode.py``, ``tests/test_torch_extraction.py``)
and by ``chip_smoke.py``'s network-mode phase, whose CLI processes install
it with ``install_stand_ins``. Not a test module.

Both packages import ``huggingface_hub``, ``datasets``, ``wandb`` and
``decord`` inside the functions that use them, so one stand-in installed
with ``monkeypatch`` serves both: ``HubStandIn`` replaces
``huggingface_hub.hf_hub_download`` (files served from a local folder,
nothing downloaded), ``DatasetsStandIn``, ``WandbStandIn`` and
``DecordStandIn`` are modules put in ``sys.modules``, and
``StubExtractor`` replaces each CLI's ``FeatureExtractor`` so that no I3D
is built. Each records its calls as JSON-ready lists and dicts.
"""

import hashlib
import json
import os
import shutil
import sys
import types

import numpy as np

STUB_WIDTH = 8  # feature width of StubExtractor


class HubStandIn:
    """``hf_hub_download`` over ``files``, a ``{(repo_id, filename): local
    path}`` map: it records each call's keyword arguments and returns the
    local path, or raises ``LocalEntryNotFoundError`` as an offline hub
    does for a file it has not cached. With ``cache`` it copies the file
    into the hub's cache layout under the call's ``cache_dir``, else
    ``cache`` (blob, snapshot link, ref), and returns the snapshot path, as
    ``hf_hub_download`` does."""

    def __init__(self, files, cache=None):
        self.files = dict(files)
        self.cache = cache
        self.calls = []

    def __call__(self, **kwargs):
        from huggingface_hub.errors import LocalEntryNotFoundError

        self.calls.append(kwargs)
        try:
            path = self.files[kwargs["repo_id"], kwargs["filename"]]
        except KeyError:
            raise LocalEntryNotFoundError(f"{kwargs['repo_id']}/{kwargs['filename']} is not "
                                          "cached") from None
        return path if self.cache is None else self._cached(path, **kwargs)

    def _cached(self, src, repo_id, filename, revision=None, cache_dir=None, repo_type=None):
        revision = revision or "main"
        storage = os.path.join(cache_dir or self.cache,
                               "--".join([(repo_type or "model") + "s", *repo_id.split("/")]))
        commit = hashlib.sha1(f"{repo_id}@{revision}".encode()).hexdigest()
        blob = os.path.join(storage, "blobs", hashlib.sha1(src.encode()).hexdigest())
        link = os.path.join(storage, "snapshots", commit, *filename.split("/"))
        for d in (os.path.dirname(blob), os.path.dirname(link), os.path.join(storage, "refs")):
            os.makedirs(d, exist_ok=True)
        if not os.path.exists(blob):
            shutil.copyfile(src, blob)
        if not os.path.lexists(link):
            os.symlink(os.path.relpath(blob, os.path.dirname(link)), link)
        with open(os.path.join(storage, "refs", revision), "w") as f:
            f.write(commit)
        return link


def hub_package(hub):
    """``huggingface_hub`` and ``huggingface_hub.errors`` modules, for a
    process whose own package (if any) is replaced: ``hf_hub_download`` is
    ``hub``, and ``errors`` holds the error classes that ``HubStandIn``
    raises and the packages import by name."""
    errors = types.ModuleType("huggingface_hub.errors")

    class HfHubHTTPError(Exception):
        pass

    class EntryNotFoundError(HfHubHTTPError):
        pass

    class LocalEntryNotFoundError(EntryNotFoundError):
        pass

    errors.HfHubHTTPError = HfHubHTTPError
    errors.EntryNotFoundError = EntryNotFoundError
    errors.LocalEntryNotFoundError = LocalEntryNotFoundError
    package = types.ModuleType("huggingface_hub")
    package.errors, package.hf_hub_download = errors, hub
    return {"huggingface_hub": package, "huggingface_hub.errors": errors}


class DatasetsStandIn(types.ModuleType):
    """A ``datasets`` module whose ``load_dataset`` records its arguments
    in ``calls`` and returns ``splits`` (``{mode: [video path, ...]}``) as
    the dataset's rows: ``{"video_path": path, "label": 0}``."""

    def __init__(self, splits):
        super().__init__("datasets")
        self.calls = []

        def load_dataset(*args, **kwargs):
            self.calls.append([list(args), kwargs])
            return {mode: [{"video_path": path, "label": 0} for path in paths]
                    for mode, paths in splits.items()}

        self.load_dataset = load_dataset


class StubExtractor:
    """A cheap, deterministic ``FeatureExtractor``: ``extract_video`` reads
    the file's bytes and returns seeded ``(n_clips, 10, STUB_WIDTH)``
    features, n_clips 2-5, from their sha256. It has what both packages'
    serial ``extract_videos`` use, and records its keyword arguments."""

    crops = "ten"
    flow_backend = None

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.stream = kwargs.get("stream", "rgb")

    def pin_calibration(self, outdir):
        pass

    def extract_video(self, path, cache_dir=None, timer=None):
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).digest()
        rng = np.random.RandomState(int.from_bytes(digest[:4], "little"))
        return rng.rand(2 + digest[4] % 4, 10, STUB_WIDTH).astype(np.float32)


class WandbStandIn(types.ModuleType):
    """A ``wandb`` module that records every call in ``calls`` as
    ``[name, args...]`` lists: login, init, a run's log (an ``Image`` value
    as ``["Image", path]``) and log_artifact, Image and Artifact (with
    add_dir / add_file)."""

    def __init__(self):
        super().__init__("wandb")
        calls = self.calls = []

        class Run:
            def log(self, metrics, step=None):
                calls.append(["log", {k: ["Image", v.path] if isinstance(v, Image) else v
                                      for k, v in metrics.items()}, step])

            def log_artifact(self, artifact):
                calls.append(["log_artifact", artifact.name, artifact.type, artifact.added])

        class Image:
            def __init__(self, path):
                self.path = path
                calls.append(["Image", path])

        class Artifact:
            def __init__(self, name, type):
                self.name, self.type, self.added = name, type, []

            def add_dir(self, path):
                self.added.append(["dir", path])

            def add_file(self, path):
                self.added.append(["file", path])

        def login(key=None):
            calls.append(["login", key])

        def init(project=None, name=None):
            calls.append(["init", project, name])
            return Run()

        self.login, self.init, self.Image, self.Artifact = login, init, Image, Artifact


class DecordStandIn(types.ModuleType):
    """A ``decord`` module whose ``VideoReader`` decodes the whole file with
    OpenCV to RGB and serves frames by index (``asnumpy()``), as decord's
    reader does."""

    def __init__(self):
        super().__init__("decord")

        class Frame:
            def __init__(self, array):
                self._array = array

            def asnumpy(self):
                return self._array

        class VideoReader:
            def __init__(self, uri):
                import cv2

                if not os.path.exists(uri):
                    raise RuntimeError(f"cannot open {uri}")
                cap = cv2.VideoCapture(uri)
                self._frames = []
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    self._frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                cap.release()

            def __len__(self):
                return len(self._frames)

            def __getitem__(self, i):
                return Frame(self._frames[i])

            def get_avg_fps(self):
                return 30.0

        self.VideoReader = VideoReader


def install_stand_ins(spec_path):
    """Put ``HubStandIn`` (with a cache), ``DatasetsStandIn`` and
    ``WandbStandIn`` into ``sys.modules`` for the rest of this process, from
    the JSON file ``spec_path``: ``hub`` (``[repo_id, filename, local
    path]`` triples), ``cache``, ``datasets`` (the splits) and ``record``.
    Returns a function that writes every recorded call to ``record`` as
    ``{"hub": ..., "datasets": ..., "wandb": ...}``."""
    with open(spec_path) as f:
        spec = json.load(f)
    hub = HubStandIn({(repo, name): path for repo, name, path in spec["hub"]}, spec["cache"])
    datasets, wandb = DatasetsStandIn(spec["datasets"]), WandbStandIn()
    sys.modules.update(hub_package(hub), datasets=datasets, wandb=wandb)

    def record():
        with open(spec["record"], "w") as f:
            json.dump({"hub": hub.calls, "datasets": datasets.calls, "wandb": wandb.calls}, f)

    return record
