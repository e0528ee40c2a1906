"""Training and eval runtime (counterpart of the JAX package's
``training/runner.py``).

- ``TrainState``: the model, its optimizer, the optimizer-step count, the
  generator the model's dropout masks draw from and, under DP x TP, the
  sliced storage of its parameters (``parallel.ShardedParameters``).
- ``make_train_step``: one MIL step on a batch of normal then abnormal bags
  (the model's training forward and loss, backward, clip, coupled L2,
  Adam), in ``32-true`` or ``bf16-mixed``, optionally accumulated over
  micro-batches; on a mesh, data parallel over the bags (and tensor
  parallel storage over a ``model`` axis), computing the single-device
  step.
- ``make_eval_step`` / ``eval_bucket`` / ``evaluate``: padded-bucket
  scoring and frame-level ROC/PR AUC over a test set (``EvalResult``), the
  videos of each group split over a mesh's data axis.
- ``VideoAnomalyDetectionRunner``: the epoch loop with evaluation,
  checkpoints, logs, ``max_steps``, resume and a graceful stop on signals
  (agreed by every rank of a mesh), its numpy batches assembled on a
  prefetch thread (``data.num_workers >= 1``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.features import eval_batches, is_normal, train_batches, video_class
from ..data.prefetch import prefetch
from ..models import seeded_init_
from ..ops.metrics import false_alarm_rate, frame_level_scores, pr_auc, roc_auc
from ..parallel import Mesh, ShardedParameters, batch_sharding
from ..utils.device import DeviceLike, full_f32, resolve_device
from .optim import adam_with_l2

PRECISIONS = ("32-true", "bf16-mixed")


class DataConfigError(ValueError):
    """A data or config mistake found before training (e.g. a batch size
    larger than the dataset); the CLI reports it as a one-line error."""


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None  # the dropout masks' draws
    tp: Optional[ShardedParameters] = None  # DP x TP: the parameters' sliced storage

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer, seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        return cls(model, optimizer, 0, torch.Generator(device=device).manual_seed(seed))

    def shard_tensor_parallel(self, mesh: Mesh) -> None:
        """Keep the parameters and the optimizer's moments sliced over
        ``mesh``'s ``model`` axis (``tensor_parallel_specs``)."""
        if self.tp is None:
            self.tp = ShardedParameters(self.model, mesh)
            self.tp.adopt(self.optimizer)

    def materialized(self):
        """Context in which ``model`` holds its full weights (a gather
        under DP x TP, nothing otherwise)."""
        return contextlib.nullcontext() if self.tp is None else self.tp.materialized()

    def state_dicts(self) -> Tuple[dict, dict]:
        """(model, optimizer) state dicts in the single-device layout; under
        DP x TP a collective every rank of the mesh must call."""
        if self.tp is None:
            return self.model.state_dict(), self.optimizer.state_dict()
        return self.tp.state_dicts(self.optimizer)

    def load_state_dicts(self, model_sd: dict, optimizer_sd: dict) -> None:
        """Load single-device state dicts (sliced again under DP x TP)."""
        if self.tp is None:
            self.model.load_state_dict(model_sd)
            self.optimizer.load_state_dict(optimizer_sd)
        else:
            self.tp.load_state_dicts(self.optimizer, model_sd, optimizer_sd)


def _grouped(iterable, size: int):
    """Lists of up to ``size`` consecutive items (the last may be short)."""
    group = []
    for item in iterable:
        group.append(item)
        if len(group) == size:
            yield group
            group = []
    if group:
        yield group


_BATCH_KEYS = ("feature", "normal_labels", "abnormal_labels")


def _step_batches(batches, accumulate: int):
    """One optimizer step's numpy arrays per group of ``accumulate`` loader
    batches: the batch's own arrays, or each key stacked over the group's
    micro-batches. numpy only, so it may run on the prefetch thread."""
    for group in _grouped(batches, accumulate):
        if accumulate == 1:
            yield [group[0][key] for key in _BATCH_KEYS]
        else:
            yield [np.stack([b[key] for b in group]) for key in _BATCH_KEYS]


class _TrainForward(nn.Module):
    """Routes ``torch.func.functional_call`` to ``model.outputs``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.outputs(*args, **kwargs)


def _sum_gradients(model: nn.Module, shard) -> None:
    """Sum the parameter gradients over the data axis, divided by its size
    (``DataShard``: each rank's gradients are that many times its part of
    the single-device ones), in one collective."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=shard.group)
    flat /= shard.count
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(precision: str = "32-true", microbatched: bool = False,
                    mesh: Optional[Mesh] = None, state: Optional[TrainState] = None) -> Callable:
    """The train step: ``step(state, feature, normal_labels,
    abnormal_labels) -> loss`` (a float32 scalar tensor), which updates
    ``state`` in place.

    ``feature`` holds the batch's normal bags then its abnormal ones, on
    the model's device and in its parameter dtype. The model runs in train
    mode (batch-statistics BN, MGFN's feed-forward dropout and
    dropout-masked top-k, their masks from ``state.generator``); the loss's
    gradients go through the optimizer once. ``"32-true"`` runs with TF32
    off. ``"bf16-mixed"`` runs the forward and backward on bfloat16 copies of
    every float32 parameter and of the batch, as the JAX step casts them;
    master parameters, their
    gradients, the optimizer's moments and the BN statistics stay float32.

    ``microbatched=True``: every batch argument has a leading micro-batch
    axis ``(k, ...)``; the micro-batches run in order (BN statistics thread
    through them), their gradients and losses are averaged, and the
    optimizer steps once.

    ``mesh``: data parallel over its ``data`` axis. ``feature`` is then
    this rank's contiguous slice of the bags (``parallel.shard_batch``,
    axis 1 when micro-batched) and the labels are whole. Each rank runs
    the per-bag forward on its bags, the model gathers with autograd what
    the selection and the loss need (``outputs(shard=...)``), every rank
    computes the global loss, and the parameter gradients are summed over
    the data axis before the optimizer steps: the single-device step,
    with every rank's generator seeded alike. A ``model`` axis keeps the
    parameters and moments sliced over it (``TrainState.tp``); ``state``,
    when given, is placed so here, as the JAX step shards its template.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    half = precision == "bf16-mixed"
    shard = batch_sharding(mesh)
    if state is not None and mesh is not None and "model" in mesh.shape:
        state.shard_tensor_parallel(mesh)

    def loss_of(state: TrainState, x, n_labels, a_labels) -> torch.Tensor:
        kwargs = dict(abnormal_labels=a_labels, normal_labels=n_labels, train=True,
                      generator=state.generator)
        if shard is not None:
            kwargs["shard"] = shard
        if not half:
            return state.model.outputs(x, **kwargs).loss
        params = {f"model.{name}": p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                  for name, p in state.model.named_parameters()}
        out = torch.func.functional_call(_TrainForward(state.model), params,
                                         (x.to(torch.bfloat16),), kwargs)
        return out.loss

    def step(state: TrainState, feature, normal_labels, abnormal_labels) -> torch.Tensor:
        model = state.model
        with state.materialized():
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            micro = (zip(feature, normal_labels, abnormal_labels) if microbatched
                     else [(feature, normal_labels, abnormal_labels)])
            loss_sum, k = None, 0
            with contextlib.nullcontext() if half else full_f32():
                for x, n_labels, a_labels in micro:
                    loss = loss_of(state, x, n_labels, a_labels)
                    loss.backward()
                    loss = loss.detach().float()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    k += 1
                if k > 1:
                    for p in model.parameters():
                        if p.grad is not None:
                            p.grad.div_(k)
                if shard is not None:
                    _sum_gradients(model, shard)
                if state.tp is None:
                    state.optimizer.step()
                else:
                    state.tp.step(state.optimizer)
        state.step += 1
        return loss_sum / k

    return step


def eval_bucket(n_clips: int, minimum: int = 32) -> int:
    """Pad the clip axis to a power-of-two bucket (at least ``minimum``)."""
    bucket = minimum
    while bucket < n_clips:
        bucket *= 2
    return bucket


def buckets_up_to(max_clips: int, minimum: int = 32) -> list:
    """Every eval bucket a video of at most ``max_clips`` clips can hit
    (the JAX package's ``utils/aot.py`` ``export_buckets``)."""
    buckets, n = {eval_bucket(max_clips, minimum)}, 1
    while n <= max_clips:
        buckets.add(eval_bucket(n, minimum))
        n *= 2
    return sorted(buckets)


def make_eval_step(mesh: Optional[Mesh] = None
                   ) -> Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]:
    """The scoring step: ``step(model, feature (bs, ncrops, bucket, C+1),
    length (bs,)) -> scores (bs, bucket, 1)``.

    It runs in full float32 with TF32 off for cuDNN and cuBLAS, as the JAX
    step pins "highest" matmul precision: the scorer's operations are
    negligible next to extraction, and lower-precision products are not a
    stable numeric contract.

    ``mesh``: every rank passes the same whole batch; the videos are padded
    to a multiple of the data axis, each rank scores its slice and the
    scores are all-gathered, so every rank returns the whole batch's.
    """
    shard = batch_sharding(mesh)

    @torch.no_grad()
    def step(model: nn.Module, feature: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        with full_f32():
            if shard is None:
                return model(feature, length=length)
            n = feature.shape[0]
            pad = -n % shard.count
            if pad:  # one-clip zero videos, dropped below
                feature = torch.cat([feature, feature.new_zeros((pad, *feature.shape[1:]))])
                length = torch.cat([length, length.new_ones((pad,))])
            scores = model(shard.local(feature), length=shard.local(length))
            return shard.gather_detached(scores)[:n]

    return step


@dataclasses.dataclass
class EvalResult:
    rec_auc: float
    pr_auc: float
    preds: np.ndarray
    labels: np.ndarray
    # per-video (frame_scores, frame_labels) in dataset order; None for hand-built results
    videos: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None

    def false_alarm_rate(self, threshold: float = 0.5) -> float:
        """FAR at ``threshold`` over the normal test videos (all negative
        frames without per-video data); NaN without normal videos."""
        if self.videos is None:
            return false_alarm_rate(self.labels, self.preds, threshold)
        normal = [(s, lab) for name, (s, lab) in self.videos.items() if is_normal(name)]
        if not normal:
            return float("nan")
        return false_alarm_rate(np.concatenate([lab for _, lab in normal]),
                                np.concatenate([s for s, _ in normal]), threshold)

    def report(self, threshold: float = 0.5) -> Dict[str, Any]:
        """The pooled AUCs, FAR at ``threshold`` on normal videos, the ROC
        AUC over abnormal videos only, and per anomaly class the ROC AUC
        over that class's videos and all normal ones (None where the labels
        are single-valued), with video and frame counts."""
        if self.videos is None:
            raise ValueError("report() needs per-video data (videos=None)")

        def safe_auc(labels: np.ndarray, scores: np.ndarray):
            if labels.min() == labels.max():
                return None
            return roc_auc(labels, scores)

        by_class: Dict[str, list] = {}
        for name, (scores, labels) in self.videos.items():
            by_class.setdefault(video_class(name), []).append((scores, np.asarray(labels)))
        normal = by_class.pop("Normal", [])
        normal_scores = np.concatenate([s for s, _ in normal]) if normal else np.zeros((0,))
        normal_labels = np.concatenate([lab for _, lab in normal]) if normal else np.zeros((0,))
        per_class: Dict[str, Dict[str, Any]] = {}
        abnormal_scores, abnormal_labels = [], []
        for cls in sorted(by_class):
            items = by_class[cls]
            scores = np.concatenate([s for s, _ in items])
            labels = np.concatenate([lab for _, lab in items])
            abnormal_scores.append(scores)
            abnormal_labels.append(labels)
            per_class[cls] = {
                "auc": safe_auc(np.concatenate([labels, normal_labels]),
                                np.concatenate([scores, normal_scores])),
                "videos": len(items),
                "frames": int(labels.size),
            }
        return {
            "rec_auc": self.rec_auc,
            "pr_auc": self.pr_auc,
            "far": self.false_alarm_rate(threshold),
            "far_threshold": threshold,
            "normal_videos": len(normal),
            "abnormal_videos": sum(v["videos"] for v in per_class.values()),
            "per_class": per_class,
            "abnormal_auc": (safe_auc(np.concatenate(abnormal_labels),
                                      np.concatenate(abnormal_scores))
                             if abnormal_scores else None),
        }


def evaluate(state: TrainState, dataset, frames_per_clip: int = 16, eval_step=None,
             batch_videos: int = 1, prefetch_assembly: bool = True) -> EvalResult:
    """Frame-level ROC/PR AUC over a test set.

    Videos are grouped by power-of-two clip bucket, up to ``batch_videos``
    to a device batch, scored with masking so padded clips do not change
    the valid ones, repeated to frame level, concatenated in dataset order
    and held against the concatenated ground truth.

    As in the JAX ``evaluate``, up to two groups' scores are in flight
    before the oldest is read back, and ``prefetch_assembly`` (the default)
    pads the next groups on a worker thread (``data/prefetch.py``) while
    this thread copies, launches and reads back. Both keep the serial order,
    so the scores are the same either way; the worker touches numpy only.
    """
    eval_step = eval_step or make_eval_step()
    with state.materialized():
        return _evaluate(state.model, dataset, frames_per_clip, eval_step, batch_videos,
                         prefetch_assembly)


def _evaluate(model, dataset, frames_per_clip, eval_step, batch_videos, prefetch_assembly
              ) -> EvalResult:
    model.eval()
    param = next(model.parameters())
    buckets: Dict[int, list] = {}
    order = []
    for batch in eval_batches(dataset):
        if batch["label"] is None:
            raise ValueError(f"video {batch['filename']!r} has no frame-level ground truth")
        buckets.setdefault(eval_bucket(batch["feature"].shape[2]), []).append(batch)
        order.append((batch["filename"], np.asarray(batch["label"]).ravel()))

    def assemble():
        """(group, lengths, padded features) host batches, in serial order."""
        for bucket, items in buckets.items():
            for start in range(0, len(items), batch_videos):
                group = items[start: start + batch_videos]
                feats = np.zeros((len(group), 10, bucket, group[0]["feature"].shape[3]),
                                 np.float32)
                lengths = np.zeros((len(group),), np.int64)
                for k, item in enumerate(group):
                    n_clips = item["feature"].shape[2]
                    feats[k, :, :n_clips] = item["feature"][0]
                    lengths[k] = n_clips
                yield group, lengths, feats

    per_video: Dict[str, np.ndarray] = {}

    def materialize(entry) -> None:
        group, lengths, scores = entry
        scores = scores.float().cpu().numpy()
        for k, item in enumerate(group):
            per_video[item["filename"]] = scores[k, : lengths[k], 0]

    groups = prefetch(assemble(), depth=2) if prefetch_assembly else assemble()
    pending = []
    try:
        for group, lengths, feats in groups:
            scores = eval_step(model, torch.from_numpy(feats).to(param.device, param.dtype),
                               torch.from_numpy(lengths).to(param.device))
            pending.append((group, lengths, scores))
            if len(pending) >= 2:
                materialize(pending.pop(0))
    finally:
        groups.close()
    for entry in pending:
        materialize(entry)

    all_preds, all_labels = [], []
    videos: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for filename, label in order:
        frame_preds = frame_level_scores(per_video[filename], frames_per_clip)
        all_preds.append(frame_preds)
        all_labels.append(label)
        videos[filename] = (frame_preds, label)
    preds = np.concatenate(all_preds)
    labels = np.concatenate(all_labels)
    if preds.shape != labels.shape:
        raise ValueError(f"frame count mismatch: {preds.shape} predictions vs "
                         f"{labels.shape} labels")
    return EvalResult(rec_auc=roc_auc(labels, preds), pr_auc=pr_auc(labels, preds),
                      preds=preds, labels=labels, videos=videos)


class VideoAnomalyDetectionRunner:
    """The epoch loop (the reference's LightningModule role): a model and
    its optimizer settings, with evaluation, checkpoints and logs.
    ``data_cfg`` is the data config group; the runner reads its
    ``num_workers``.

    ``mesh`` (a ``parallel.Mesh``, one rank per device): every rank runs
    the loop on the same batches (the loader is deterministic given the
    seed and epoch) and feeds the train step its slice of the bags; eval
    groups split their videos over the data axis, ``eval_batch_videos``
    rounded up to a multiple of the mesh; a ``model`` axis keeps the state
    sliced (``TrainState.tp``). Checkpoints are written by rank 0 only
    (``TopKCheckpointer``), and a stop signal on any rank stops every rank
    at the same step."""

    def __init__(
        self,
        model: nn.Module,
        optimizer_cfg: Optional[Dict[str, Any]] = None,
        data_cfg: Optional[Dict[str, Any]] = None,
        loggers: Iterable = (),
        checkpointer=None,
        seed: int = 0,
        eval_batch_videos: int = 8,
        precision: str = "32-true",
        grad_clip: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        device: DeviceLike = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        optimizer_cfg = dict(optimizer_cfg or {})
        accumulate_grad_batches = int(accumulate_grad_batches)
        if accumulate_grad_batches < 1:
            raise ValueError("trainer.accumulate_grad_batches must be >= 1, got "
                             f"{accumulate_grad_batches}")
        self.precision = precision
        self.accumulate_grad_batches = accumulate_grad_batches
        self.device = resolve_device(device)
        self.model = model
        # the loader's prefetch thread (configs/data/default.yaml num_workers: 8,
        # a torch DataLoader knob there): any value >= 1 prefetches, 0 is synchronous
        self.num_workers = int(dict(data_cfg or {}).get("num_workers", 8) or 0)
        self.loggers = list(loggers)
        self.checkpointer = checkpointer
        self.seed = seed
        self.learning_rate = float(optimizer_cfg.get("learning_rate", 1e-3))
        self.weight_decay = float(optimizer_cfg.get("weight_decay", 5e-4))
        self.grad_clip = grad_clip
        self.mesh = mesh
        if mesh is not None:
            # groups split their videos over the mesh: a multiple of it fills every rank
            eval_batch_videos = -(-eval_batch_videos // mesh.size) * mesh.size
        self.eval_batch_videos = eval_batch_videos
        self._train_step = make_train_step(precision, microbatched=accumulate_grad_batches > 1,
                                           mesh=mesh)
        self._eval_step = make_eval_step(mesh)
        self.state: Optional[TrainState] = None

    def init_state(self) -> TrainState:
        """Fresh weights from ``seed`` (``seeded_init_``: LeCun-normal conv
        and linear weights, zero biases, identity norms) on the device, and
        a fresh optimizer; sliced over a mesh's ``model`` axis. Unlike the
        JAX runner it needs no example batch: a torch module has its
        shapes."""
        model = seeded_init_(self.model, self.seed).to(self.device)
        optimizer = adam_with_l2(model.parameters(), self.learning_rate, self.weight_decay,
                                 self.grad_clip)
        self.state = TrainState.create(model, optimizer, self.seed + 2)
        self._place(self.state)
        return self.state

    def _place(self, state: TrainState) -> None:
        if self.mesh is not None and "model" in self.mesh.shape:
            state.shard_tensor_parallel(self.mesh)

    def restore(self, state: TrainState) -> None:
        """Adopt a restored state, sliced over a mesh's ``model`` axis if
        it is not yet (a checkpoint holds the single-device layout)."""
        self._place(state)
        self.state = state

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for logger in self.loggers:
            logger.log(metrics, step)

    def evaluate(self, valid_dataset, frames_per_clip: int = 16,
                 prefetch_assembly: bool = True) -> EvalResult:
        return evaluate(self.state, valid_dataset, frames_per_clip, self._eval_step,
                        self.eval_batch_videos, prefetch_assembly)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        dtype = next(self.state.model.parameters()).dtype
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device, dtype)

    def _step_inputs(self, parts) -> list:
        """A step's arrays on the device: under a mesh, only this rank's
        slice of the bags (axis 1 of micro-batched arrays); labels whole."""
        feature, normal_labels, abnormal_labels = parts
        if self.mesh is not None:
            feature = batch_sharding(self.mesh).local(feature, 1 if self.accumulate_grad_batches > 1
                                                  else 0)
        return [self._to_device(a) for a in (feature, normal_labels, abnormal_labels)]

    def _stop_requested(self, stop_signal: Dict[str, Any]) -> bool:
        """Whether to stop after this step: the local signal, or with
        ``stop_signal["agree"]`` any rank's (an all-reduce of the flag every
        step, so all ranks stop at the same step)."""
        local = stop_signal["num"] is not None
        if not stop_signal["agree"]:
            return local
        flag = torch.tensor([int(local)], device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    def fit(
        self,
        train_datasets: Dict[str, Any],
        valid_dataset=None,
        max_epochs: int = 1000,
        batch_size: int = 16,
        shuffle: bool = False,
        eval_every: int = 1,
        frames_per_clip: int = 16,
        figure_dir: Optional[str] = None,
        handle_signals: Iterable[str] = (),
        max_steps: int = -1,
        log_every_n_steps: Optional[int] = None,
        checkpoint_every_n_epochs: int = 1,
    ) -> Optional[EvalResult]:
        """Train with evaluation every ``eval_every`` epochs.

        ``handle_signals`` names signals (``("SIGTERM", "SIGINT")``) that
        request a graceful stop: the current step finishes, a checkpoint of
        the step reached is saved (without a metric, kept as the latest)
        and fit returns, so a preempted job resumes from that step.
        ``figure_dir`` is accepted for the JAX runner's signature; eval
        figures are not ported and none is written.
        """
        if figure_dir:
            print(f"warning: eval figures are not ported; nothing is written to {figure_dir}")
        if isinstance(handle_signals, str):  # a CLI scalar override
            handle_signals = (handle_signals,)
        # on a mesh with signals handled, every rank agrees on the stop each step
        stop_signal: Dict[str, Any] = {"num": None,
                                       "agree": self.mesh is not None and bool(handle_signals)}
        restore_handlers = {}
        if handle_signals:
            import signal

            def request_stop(signum, frame):
                stop_signal["num"] = signum

            for name in handle_signals:
                signum = getattr(signal, name, None)
                if signum is None:
                    print(f"warning: unknown signal name {name!r} ignored")
                    continue
                try:
                    restore_handlers[signum] = signal.signal(signum, request_stop)
                except ValueError:
                    pass  # not the main thread: signals keep their handlers
        try:
            return self._fit_loop(train_datasets["normal"], train_datasets["abnormal"],
                                  valid_dataset, max_epochs, batch_size, shuffle, eval_every,
                                  frames_per_clip, stop_signal, max_steps,
                                  log_every_n_steps, checkpoint_every_n_epochs)
        finally:
            if restore_handlers:
                import signal

                for signum, handler in restore_handlers.items():
                    signal.signal(signum, handler)

    def _fit_loop(self, normal, abnormal, valid_dataset, max_epochs, batch_size, shuffle,
                  eval_every, frames_per_clip, stop_signal, max_steps,
                  log_every_n_steps, checkpoint_every_n_epochs) -> Optional[EvalResult]:
        last_eval: Optional[EvalResult] = None
        # a resumed run continues the step count and, derived from it, the
        # epoch count (exact while batch_size matches the run that saved)
        step = self.state.step if self.state is not None else 0
        accumulate = self.accumulate_grad_batches
        loader_batches = min(len(normal), len(abnormal)) // batch_size
        if loader_batches == 0:
            raise DataConfigError(
                f"batch_size={batch_size} exceeds the training data: {len(normal)} normal / "
                f"{len(abnormal)} abnormal videos yield zero batches under the drop-last dual "
                "loader; lower data.batch_size or add videos")
        steps_per_epoch = -(-loader_batches // accumulate)
        start_epoch = step // steps_per_epoch
        log_every = max(1, int(log_every_n_steps or 1))
        hit_max = max_steps >= 0 and step >= max_steps
        if self.state is not None:
            self.state.generator.manual_seed(self.seed + 2)
        for epoch in range(start_epoch, max_epochs):
            if hit_max:
                break
            epoch_losses = []
            t0 = time.time()
            batches = train_batches(normal, abnormal, batch_size=batch_size, shuffle=shuffle,
                                    seed=self.seed, epoch=epoch)
            # one optimizer step per group of loader batches; with num_workers
            # >= 1 a thread assembles the next steps' numpy arrays while this one
            # copies them to the device and runs the step (order-preserving, so
            # the losses are those of the serial loop)
            steps = _step_batches(batches, accumulate)
            if self.num_workers > 0:
                steps = prefetch(steps, depth=2)
            stopped = False
            try:
                for parts in steps:
                    if self.state is None:
                        self.init_state()
                    loss = float(self._train_step(self.state, *self._step_inputs(parts)))
                    epoch_losses.append(loss)
                    if (step + 1) % log_every == 0:
                        self._log({"train_loss": loss, "lr-Adam": self.learning_rate}, step)
                    step += 1
                    if max_steps >= 0 and step >= max_steps:
                        hit_max = True
                        break
                    if self._stop_requested(stop_signal):
                        stopped = True
                        break
            finally:
                # a max_steps or signal break leaves the epoch's iterator open:
                # close it now, so the prefetch thread stops loading at once
                steps.close()
            if stopped:
                # skip eval (the grace period is short) and save the exact step
                saved = False
                if self.checkpointer is not None and self.state is not None:
                    self.checkpointer.save(step=step, state=self.state, metric=None)
                    saved = True
                self._log({"preempted_at_step": step}, step)
                print(f"signal {stop_signal['num'] or 'on another rank'}: "
                      + (f"checkpoint saved at step {step}, stopping" if saved
                         else f"stopping at step {step}"))
                return last_eval
            metrics = {
                "epoch": epoch,
                "epoch_time_s": time.time() - t0,
                "train_loss_epoch": float(np.mean(epoch_losses)) if epoch_losses else float("nan"),
            }
            # the max_steps stop evaluates too, so its checkpoint ranks by a metric
            if valid_dataset is not None and ((epoch + 1) % eval_every == 0 or hit_max):
                last_eval = self.evaluate(valid_dataset, frames_per_clip)
                metrics["valid/rec_auc"] = last_eval.rec_auc
                metrics["valid/pr_auc"] = last_eval.pr_auc
                metrics["valid/far"] = last_eval.false_alarm_rate()
            self._log(metrics, step)
            save_this_epoch = ((epoch + 1) % max(1, checkpoint_every_n_epochs) == 0
                               or hit_max or epoch == max_epochs - 1)
            if self.checkpointer is not None and self.state is not None and save_this_epoch:
                self.checkpointer.save(step=step, state=self.state,
                                       metric=metrics.get("valid/rec_auc"))
            if hit_max:
                print(f"max_steps {max_steps} reached at step {step}, stopping")
                break
        if last_eval is None and valid_dataset is not None and self.state is not None:
            # a resumed run whose epoch budget is spent still reports where it stands
            last_eval = self.evaluate(valid_dataset, frames_per_clip)
            self._log({"valid/rec_auc": last_eval.rec_auc, "valid/pr_auc": last_eval.pr_auc,
                       "valid/far": last_eval.false_alarm_rate()}, step)
        return last_eval
