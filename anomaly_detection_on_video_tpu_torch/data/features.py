"""The feature data plane (counterpart of the JAX package's
``data/features.py``): the on-disk contract and the MIL batch iterators.

Features live in zip archives (``train.zip`` / ``test.zip``) or in plain
directories of ``<video>_i3d.npy`` files: train features are ``(10, 32,
2048)`` segment bags, test features ``(n_clips, 10, 2048)``. A video is
normal iff ``"Normal"`` is in its filename. ``add_magnitude`` appends the
L2 norm channel, 2048 -> 2049. The test split carries frame-level ground
truth from ``ground_truth.json``. Training batches are numpy arrays
``(2 * bsz, 10, T, 2049)``, normal bags first. Local paths only: the JAX
package's Hugging Face hub download is not ported.
"""

from __future__ import annotations

import json
import os
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

DEFAULT_FILENAMES = {"train": "train.zip", "test": "test.zip"}


def add_magnitude(feature: np.ndarray) -> np.ndarray:
    """Append the L2 feature magnitude channel: (..., T, 2048) -> 2049."""
    magnitude = np.linalg.norm(feature, axis=-1, keepdims=True)
    return np.concatenate([feature, magnitude], axis=-1)


def pad_eval_batch(features: np.ndarray, bucket: int) -> np.ndarray:
    """(n_clips, n_crops, C) f32 features -> one (1, n_crops, bucket, C+1)
    eval batch: magnitude appended, crop axis first, clip axis zero-padded
    to ``bucket`` (masked by the scorer's ``length``)."""
    n_clips, n_crops = features.shape[:2]
    out = np.zeros((1, n_crops, bucket, features.shape[-1] + 1), np.float32)
    out[0, :, :n_clips] = add_magnitude(features).transpose(1, 0, 2)
    return out


def is_normal(filename: str) -> bool:
    """The reference's labeling rule: normal iff "Normal" in the filename."""
    return "Normal" in filename


def video_class(filename: str) -> str:
    """The anomaly class of a UCF-Crime filename: the leading alphabetic
    run of the basename (``Abuse028_x264`` -> ``Abuse``), ``"Normal"`` for
    every normal video."""
    stem = os.path.basename(filename)
    if is_normal(stem):
        return "Normal"
    head = []
    for ch in stem:
        if not ch.isalpha():
            break
        head.append(ch)
    return "".join(head) or stem


@dataclass
class FeatureDataset:
    """Named feature arrays, loaded eagerly or per access from a directory
    or a zip. ``labels`` maps a filename (or its stem) to frame-level GT
    for the test split; ``pairs`` maps an RGB file to its flow mate for a
    two-stream dataset, concatenated on the feature axis before the
    magnitude channel."""

    filenames: List[str]
    _arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    _zip_path: Optional[str] = None
    _zip_members: Dict[str, str] = field(default_factory=dict)
    _dir_path: Optional[str] = None
    labels: Optional[Dict[str, List[float]]] = None
    pairs: Dict[str, str] = field(default_factory=dict)
    _zipfile: Optional[zipfile.ZipFile] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.filenames)

    def _load(self, fname: str) -> np.ndarray:
        if fname in self._arrays:
            return self._arrays[fname]
        if self._dir_path is not None:
            # opened and closed per access: one open file per array would
            # exhaust the descriptor limit at dataset scale
            return np.load(os.path.join(self._dir_path, fname))
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._zip_path)
        with self._zipfile.open(self._zip_members[fname]) as f:
            return np.load(f)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        fname = self.filenames[idx]
        feature = self._load(fname)
        if fname in self.pairs:
            flow = self._load(self.pairs[fname])
            if flow.shape[:-1] != feature.shape[:-1]:
                raise ValueError(
                    f"{fname}: RGB {feature.shape} and flow {flow.shape} features disagree on "
                    f"clip/crop counts; were the two streams extracted from the same videos?")
            feature = np.concatenate([feature, flow], axis=-1)
        out = {
            "feature": add_magnitude(feature).astype(np.float32),
            "anomaly": np.float32(0.0 if is_normal(fname) else 1.0),
            "filename": fname,
        }
        if self.labels is not None:
            # hub GT keys by npy filename, make_gt_ucf by video stem
            key = fname
            if key not in self.labels:
                key = fname.replace("_i3d.npy", "").replace("_flow.npy", "")
            out["label"] = np.asarray(self.labels[key], dtype=np.float32)
        return out


def _index_zip(path: str, dynamic_load: bool) -> Tuple[List[str], Dict, Dict]:
    zipf = zipfile.ZipFile(path)
    filenames, arrays, members = [], {}, {}
    for member in zipf.infolist():
        if member.is_dir():
            continue
        fname = member.filename.split("/")[-1]
        if not fname.endswith(".npy"):
            continue
        filenames.append(fname)
        members[fname] = member.filename
        if not dynamic_load:
            with zipf.open(member) as f:
                arrays[fname] = np.load(f)
    return filenames, arrays, members


def _index_dir(path: str, dynamic_load: bool) -> Tuple[List[str], Dict, Dict]:
    """A feature directory's ``.npy`` files, sorted; ``dynamic_load=False``
    loads them all into memory."""
    filenames = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    arrays = {}
    if not dynamic_load:
        arrays = {f: np.load(os.path.join(path, f)) for f in filenames}
    return filenames, arrays, {}


def _select_stream(filenames: List[str], stream: str) -> Tuple[List[str], Dict[str, str]]:
    """``rgb`` keeps the RGB files (``<stem>_i3d.npy`` and any non-flow
    name), ``flow`` the ``<stem>_flow.npy`` files, ``both`` pairs each RGB
    file with its flow mate and raises where one is missing."""
    flow = {f for f in filenames if f.endswith("_flow.npy")}
    rgb = [f for f in filenames if f not in flow]
    if stream == "rgb":
        return rgb, {}
    if stream == "flow":
        return sorted(flow), {}
    if stream != "both":
        raise ValueError(f"stream must be rgb, flow, or both, got {stream!r}")
    pairs = {}
    for f in rgb:
        stem = f[: -len("_i3d.npy")] if f.endswith("_i3d.npy") else f[:-4]
        mate = f"{stem}_flow.npy"
        if mate not in flow:
            raise ValueError(
                f"stream='both' requires a flow mate for every RGB feature file; {mate!r} is "
                f"missing for {f!r} (extract with --stream both, or use stream='rgb')")
        pairs[f] = mate
    return rgb, pairs


def build_feature_dataset(
    mode: str = "train",
    local_path: Optional[str] = None,
    dynamic_load: bool = True,
    ground_truth_path: Optional[str] = None,
    stream: str = "rgb",
):
    """Train (``{"normal", "abnormal"}``) or test (one dataset) features
    from ``local_path``: a zip, a directory holding ``train.zip`` /
    ``test.zip``, or a directory of ``.npy`` files. ``stream`` is ``rgb``,
    ``flow`` or ``both``."""
    if mode not in ("train", "test"):
        raise ValueError(f"mode must be train or test, got {mode!r}")
    if local_path is None:
        raise FileNotFoundError(
            f"no {mode} features given: the port reads local features only; set "
            f"data.{mode}_path=<zip-or-dir> (or data.local_path=<dir> for both splits)")
    filepath = local_path
    if os.path.isdir(filepath):
        candidate = os.path.join(filepath, DEFAULT_FILENAMES[mode])
        if os.path.exists(candidate):
            filepath = candidate
    if not os.path.exists(filepath):
        raise FileNotFoundError(f"{mode} features: no such file or directory: {filepath!r}")

    if os.path.isdir(filepath):
        filenames, arrays, members = _index_dir(filepath, dynamic_load)
        zip_path, dir_path = None, filepath
    else:
        filenames, arrays, members = _index_zip(filepath, dynamic_load)
        zip_path, dir_path = filepath, None
    filenames, pairs = _select_stream(filenames, stream)

    if mode == "test":
        labels = None
        if ground_truth_path is not None:
            with open(ground_truth_path) as f:
                labels = json.load(f)
        return FeatureDataset(filenames=filenames, _arrays=arrays, _zip_path=zip_path,
                              _zip_members=members, _dir_path=dir_path, labels=labels,
                              pairs=pairs)

    def make(names):
        keys = list(names) + [pairs[n] for n in names if n in pairs]
        return FeatureDataset(
            filenames=names,
            _arrays={k: arrays[k] for k in keys if k in arrays},
            _zip_path=zip_path,
            _zip_members={k: members[k] for k in keys if k in members},
            _dir_path=dir_path,
            pairs={n: pairs[n] for n in names if n in pairs},
        )

    return {"normal": make([f for f in filenames if is_normal(f)]),
            "abnormal": make([f for f in filenames if not is_normal(f)])}


def train_batches(
    normal: FeatureDataset,
    abnormal: FeatureDataset,
    batch_size: int = 16,
    shuffle: bool = False,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """MIL training batches ``(2 * bsz, 10, T, 2049)``, normal first: per
    step ``batch_size`` normal bags then ``batch_size`` abnormal ones; an
    epoch is min(len(normal), len(abnormal)) // batch_size steps with
    ``drop_last``. ``shuffle`` permutes both by (seed, epoch)."""
    n_idx = np.arange(len(normal))
    a_idx = np.arange(len(abnormal))
    if shuffle:
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 31))
        rng.shuffle(n_idx)
        rng.shuffle(a_idx)
    # equal normal and abnormal counts in every step: the model splits the batch in half
    n_pairs = min(len(n_idx), len(a_idx))
    n_idx, a_idx = n_idx[:n_pairs], a_idx[:n_pairs]
    steps = n_pairs // batch_size
    if not drop_last and n_pairs % batch_size:
        steps += 1
    for step in range(steps):
        sl = slice(step * batch_size, (step + 1) * batch_size)
        n_items = [normal[i] for i in n_idx[sl]]
        a_items = [abnormal[i] for i in a_idx[sl]]
        yield {
            "feature": np.stack([it["feature"] for it in n_items + a_items]),
            "normal_labels": np.stack([it["anomaly"] for it in n_items]),
            "abnormal_labels": np.stack([it["anomaly"] for it in a_items]),
        }


def eval_batches(dataset: FeatureDataset) -> Iterator[Dict[str, np.ndarray]]:
    """Per-video eval batches ``(1, 10, n_clips, 2049)``."""
    for i in range(len(dataset)):
        item = dataset[i]
        yield {
            "feature": item["feature"].transpose(1, 0, 2)[None],
            "label": item.get("label"),
            "filename": item["filename"],
            "anomaly": item["anomaly"],
        }
