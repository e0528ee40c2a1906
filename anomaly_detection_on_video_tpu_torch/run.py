"""Training CLI (counterpart of the repository-root ``run.py``), over the
repository's ``configs/`` with the same override grammar:

    python -m anomaly_detection_on_video_tpu_torch.run runner=mgfn data.local_path=/data/features
    python -m anomaly_detection_on_video_tpu_torch.run runner=mgfn data.batch_size=8 device=cpu
    python -m anomaly_detection_on_video_tpu_torch.run runner=mgfn --cfg

It trains on the card unless ``device=cpu`` (or another torch device) is
given. Scale-out follows the root ``run.py`` with one process per card
(``parallel/``): ``trainer.data_parallel`` with several cards visible
starts one rank per card on this host (a localhost store on a free port);
``trainer.multihost=true`` joins a run over ``trainer.coordinator``
(``host:port``, with ``num_processes`` and ``process_id``) or torchrun's
environment; ``trainer.tensor_parallel=N`` builds the (data, model) DP x TP
mesh (``build_mesh``). The process group is ``nccl`` on the card and
``gloo`` on the CPU. Every rank feeds the same batches and computes the
single-device step; only rank 0 logs and writes checkpoints.
``main`` composes the config and calls ``train(cfg, device)``,
which takes a composed dict and needs no PyYAML. ``trainer.eval_only``
prints one JSON line of metrics. ``trainer.compile_cache: DIR`` builds the
CUDA kernels into DIR and loads them from there
(``utils/compile_cache.py``). ``-m`` sweeps comma-separated override values
as the root ``run.py`` does, one job after another, each a process of this
module with the sweep's ``device=``:

    python -m anomaly_detection_on_video_tpu_torch.run -m runner=mgfn seed=1,2,3 \
        --multirun-dir sweeps/seed

Not ported: W&B logging and eval figures.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO_ROOT, "configs")

HELP = """\
usage: python -m anomaly_detection_on_video_tpu_torch.run [GROUP=CHOICE ...] [KEY=VALUE ...] [flags]

overrides:
  GROUP=CHOICE      select a config-group file, e.g. runner=mgfn
  KEY=VALUE         dotted value override, e.g. data.batch_size=8 or seed=1
  +KEY=VALUE        add a key that is not in the composed config
  ~KEY[=VALUE]      delete a key (=VALUE must match the current value);
                    ~GROUP drops a config group from the defaults list
  device=DEVICE     the torch device to train on (default cuda)

flags:
  -h, --help        show this help and exit
  --cfg             print the composed config as YAML and exit
  -m, --multirun    sweep comma-separated override values, e.g.
                    `-m runner=mgfn seed=1,2,3` runs the cartesian product
                    sequentially; each job writes under --multirun-dir
  --multirun-dir D  sweep output root (default: multirun)

config groups (configs/):
"""


def print_help(config_dir: str) -> None:
    sys.stdout.write(HELP)
    for root, dirs, files in sorted(os.walk(config_dir)):
        dirs.sort()
        group = os.path.relpath(root, config_dir).replace(os.sep, "/")
        if group == ".":
            continue
        choices = sorted(f[:-5] for f in files if f.endswith(".yaml"))
        if choices:
            print(f"  {group}: {', '.join(choices)}")
    print("\na real run requires `runner=mgfn`; the default runner group has model_class: null.")


def split_device(argv: List[str]) -> Tuple[List[str], str]:
    """Take ``device=...`` out of the overrides (it is not a config key)."""
    device = "cuda"
    rest = []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.partition("=")[2]
        else:
            rest.append(arg)
    return rest, device


def expand_multirun(argv: List[str]) -> List[List[str]]:
    """Cartesian product of comma-separated override values (Hydra's -m).

    Only bare comma lists sweep; YAML collections and quoted values
    (``data.x=[1,2]``, ``key='a,b'``) stay single values.
    """
    per_arg = []
    for arg in argv:
        key, eq, value = arg.partition("=")
        if eq and "," in value and not any(ch in value for ch in "[]{}\"'"):
            per_arg.append([f"{key}={v}" for v in value.split(",")])
        else:
            per_arg.append([arg])
    return [list(combo) for combo in itertools.product(*per_arg)]


def run_multirun(config_dir: str, argv: List[str], sweep_dir: str, device: str) -> None:
    """Run each sweep job in its own process, one after another, as the
    root ``run.py`` does: every job gets its own writer paths
    (``{sweep_dir}/{job}/metrics.jsonl``, and ``checkpoints`` / ``figures``
    where the config sets them) unless the sweep's arguments set them, and
    ``device``. Data paths are passed unchanged (give absolute ones). Each
    job appends a line to ``{sweep_dir}/multirun.jsonl``; a failed job does
    not stop the sweep, and the sweep exits naming how many failed."""
    from .config import compose

    jobs = expand_multirun(argv)
    os.makedirs(sweep_dir, exist_ok=True)
    explicit = {arg.partition("=")[0].lstrip("+~") for arg in argv}
    # the job imports this package from wherever the sweep was started
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    failures = 0
    with open(os.path.join(sweep_dir, "multirun.jsonl"), "a") as log:
        for idx, job_args in enumerate(jobs):
            job_dir = os.path.join(sweep_dir, str(idx))
            os.makedirs(job_dir, exist_ok=True)
            extra = []
            if "trainer.log_path" not in explicit:
                extra.append(f"trainer.log_path={os.path.join(job_dir, 'metrics.jsonl')}")
            try:
                cfg = compose(config_dir, "default", job_args)
            except (ValueError, KeyError, FileNotFoundError) as exc:
                msg = exc.args[0] if exc.args else exc
                raise SystemExit(f"config error in multirun job {idx} ({' '.join(job_args)}): "
                                 f"{msg}\n(see --help)")
            trainer_cfg = cfg.get("trainer", {})
            if ((trainer_cfg.get("checkpoint") or {}).get("dirpath")
                    and "trainer.checkpoint.dirpath" not in explicit):
                extra.append("trainer.checkpoint.dirpath=" + os.path.join(job_dir, "checkpoints"))
            if trainer_cfg.get("figure_dir") and "trainer.figure_dir" not in explicit:
                extra.append(f"trainer.figure_dir={os.path.join(job_dir, 'figures')}")
            print(f"[multirun] job {idx}/{len(jobs)}: {' '.join(job_args)}", flush=True)
            proc = subprocess.run([sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.run",
                                   *job_args, *extra, f"device={device}"], env=env)
            if proc.returncode:
                failures += 1
            log.write(json.dumps({"job": idx, "dir": job_dir, "overrides": job_args,
                                  "returncode": proc.returncode}) + "\n")
            log.flush()
    if failures:
        raise SystemExit(f"multirun: {failures} of {len(jobs)} jobs failed")


def mesh_shape(trainer_cfg: Dict[str, Any], n_devices: int, distributed: bool = False
               ) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """(axis sizes, axis names) of the mesh the root ``run.build_mesh``
    builds over ``n_devices``, or None: ``tensor_parallel: N > 1`` -> the
    (data, model) DP x TP mesh, raising SystemExit when N does not divide
    the devices; else ``data_parallel`` -> the 1-D data mesh when there is
    more than one device, or (``distributed``) a process group joins even
    one."""
    tensor_parallel = int(trainer_cfg.get("tensor_parallel", 1) or 1)
    if not trainer_cfg.get("data_parallel", False) and tensor_parallel <= 1:
        return None
    if tensor_parallel > 1:
        if n_devices % tensor_parallel:
            raise SystemExit(f"trainer.tensor_parallel={tensor_parallel} does not divide the "
                             f"{n_devices} available devices")
        return (n_devices // tensor_parallel, tensor_parallel), ("data", "model")
    if n_devices > 1 or distributed:
        return (n_devices,), ("data",)
    return None


def build_mesh(trainer_cfg: Dict[str, Any]):
    """The training mesh over this run's ranks (``mesh_shape``); None for
    a single-device run."""
    import torch.distributed as dist

    from .parallel import make_mesh, process_count

    shape = mesh_shape(trainer_cfg, process_count(), dist.is_initialized())
    return None if shape is None else make_mesh(*shape)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _local_rank(index: int, cfg: Dict[str, Any], n: int, port: int) -> None:
    """One rank of ``spawn_local_ranks``: the config as a multihost run."""
    trainer = dict(cfg["trainer"], multihost=True, coordinator=f"127.0.0.1:{port}",
                   num_processes=n, process_id=index)
    train(dict(cfg, trainer=trainer), "cuda")


def spawn_local_ranks(cfg: Dict[str, Any], n: int) -> None:
    """``trainer.data_parallel`` with ``n`` > 1 cards on this host: one
    process per card, joined over a localhost store; a rank that fails
    stops the others and the run exits non-zero."""
    import torch.multiprocessing as mp

    print(f"data_parallel: starting {n} ranks, one per visible card", flush=True)
    try:
        mp.spawn(_local_rank, args=(cfg, n, _free_port()), nprocs=n, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        raise SystemExit(f"data_parallel: a rank failed: {exc}")


def train(cfg: Dict[str, Any], device: str = "cuda"):
    """Run a composed config: train with evaluation, or evaluate a
    checkpoint with ``trainer.eval_only``. Returns the last ``EvalResult``
    (None when there is no test split to evaluate, or when the ranks run in
    processes of their own)."""
    import torch

    from .parallel import initialize_multihost, shutdown
    from .utils.device import resolve_device

    device = resolve_device(device)
    trainer_cfg = cfg.get("trainer", {})
    if trainer_cfg.get("compile_cache"):  # before the first kernel launch
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache(trainer_cfg["compile_cache"])
    multihost = bool(trainer_cfg.get("multihost"))
    if (trainer_cfg.get("data_parallel") and not multihost and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        return spawn_local_ranks(cfg, torch.cuda.device_count())
    if multihost:
        # rendezvous before the model is built: every rank then builds the same one
        device = initialize_multihost(
            coordinator=trainer_cfg.get("coordinator"),
            num_processes=trainer_cfg.get("num_processes"),
            process_id=trainer_cfg.get("process_id"),
            autodetect=trainer_cfg.get("coordinator") is None, device=device)
    try:
        result = _train(cfg, device)
    except BaseException:
        shutdown(clean=False)
        raise
    shutdown()
    return result


def _train(cfg: Dict[str, Any], device):
    from .config import instantiate, locate
    from .data.features import build_feature_dataset
    from .parallel import process_index
    from .training import VideoAnomalyDetectionRunner
    from .training.checkpoints import TopKCheckpointer
    from .training.loggers import ConsoleLogger, JsonlLogger
    from .training.runner import DataConfigError

    trainer_cfg = cfg.get("trainer", {})
    # ranks other than 0 write nothing: no logs, no checkpoints, no hparams
    is_primary = process_index() == 0
    runner_cfg = cfg.get("runner") or {}
    if not runner_cfg.get("model_class"):
        raise SystemExit("no model selected: run with `runner=mgfn` (the default runner group "
                         "has model_class: null)")
    model_config = instantiate(runner_cfg["model_config"])
    model = locate(runner_cfg["model_class"])(model_config)
    data_cfg = cfg.get("data", {})

    loggers = [ConsoleLogger()] if is_primary else []
    log_path = trainer_cfg.get("log_path", "logs/metrics.jsonl")
    if log_path and is_primary:
        loggers.append(JsonlLogger(log_path))
    if cfg.get("wandb_key") and is_primary:
        print("warning: wandb_key is set but W&B logging is not ported; JSONL and console "
              "logging are unaffected", file=sys.stderr)

    checkpointer = None
    ckpt_cfg = trainer_cfg.get("checkpoint", {})
    if ckpt_cfg.get("dirpath"):
        # every rank reads the directory (a resume restores everywhere); rank 0 writes
        checkpointer = TopKCheckpointer(ckpt_cfg["dirpath"], top_k=int(ckpt_cfg.get("save_top_k", 10)))
        if is_primary and not trainer_cfg.get("eval_only"):
            checkpointer.write_metadata({
                "model_name": cfg.get("_choices_", {}).get("runner"),
                "model_class": runner_cfg["model_class"],
                "model_config": runner_cfg["model_config"],
                "optimizer": runner_cfg.get("optimizer", {}),
                "data": data_cfg,
                "seed": cfg.get("seed", 0),
            })

    runner = VideoAnomalyDetectionRunner(
        model,
        optimizer_cfg=runner_cfg.get("optimizer", {}),
        data_cfg=data_cfg,
        loggers=loggers,
        checkpointer=checkpointer,
        seed=int(cfg.get("seed", 0)),
        eval_batch_videos=int(trainer_cfg.get("eval_batch_videos", 8)),
        precision=str(trainer_cfg.get("precision", "32-true")),
        grad_clip=trainer_cfg.get("gradient_clip_val"),
        accumulate_grad_batches=(1 if trainer_cfg.get("accumulate_grad_batches") is None
                                 else int(trainer_cfg["accumulate_grad_batches"])),
        device=device,
        mesh=build_mesh(trainer_cfg),
    )

    stream = data_cfg.get("stream", "rgb")
    expected_channels = {"rgb": 2048, "flow": 2048, "both": 4096}.get(stream)
    model_channels = getattr(model_config, "channels", None)
    if expected_channels and model_channels and model_channels != expected_channels:
        print(f"warning: data.stream={stream} produces {expected_channels}-d features but the "
              f"model expects channels={model_channels}; set "
              f"runner.model_config.channels={expected_channels}", file=sys.stderr)

    def load_split(mode, **kw):
        try:
            return build_feature_dataset(
                mode, local_path=data_cfg.get(f"{mode}_path") or data_cfg.get("local_path"),
                dynamic_load=bool(data_cfg.get("dynamic_load", False)), stream=stream, **kw)
        except FileNotFoundError as exc:
            raise SystemExit(f"data error: {exc}")

    def restore_selected():
        try:
            runner.restore(checkpointer.restore(
                runner.state, step=trainer_cfg.get("checkpoint_step", "latest")))
        except ValueError as exc:
            raise SystemExit(f"trainer.checkpoint_step: {exc}")

    try:
        valid_dataset = load_split("test", ground_truth_path=data_cfg.get("ground_truth_path"))
        frames_per_clip = int(data_cfg.get("frames_per_clip", 16))
        if trainer_cfg.get("eval_only"):
            if checkpointer is None:
                raise SystemExit("trainer.eval_only=true requires trainer.checkpoint.dirpath")
            runner.init_state()
            restore_selected()
            if runner.state.step == 0:
                raise SystemExit(f"eval_only: no checkpoint found under {ckpt_cfg['dirpath']!r}; "
                                 "evaluating random weights would be meaningless")
            result = runner.evaluate(valid_dataset, frames_per_clip)
            metrics = {"step": runner.state.step, "valid/rec_auc": result.rec_auc,
                       "valid/pr_auc": result.pr_auc, "valid/far": result.false_alarm_rate()}
            runner._log(metrics, runner.state.step)
            if trainer_cfg.get("eval_report"):
                metrics["report"] = result.report()
            if is_primary:
                print(json.dumps(metrics))
            return result

        train_datasets = load_split("train")
        batch_size = int(data_cfg.get("batch_size", 16))
        if trainer_cfg.get("resume") and checkpointer is not None:
            runner.init_state()
            restore_selected()
            if is_primary:
                print(f"resumed from step {runner.state.step}")
        signals = trainer_cfg.get("preempt_signals") or ()
        try:
            result = runner.fit(
                train_datasets,
                valid_dataset=valid_dataset,
                max_epochs=int(trainer_cfg.get("max_epochs", 1000)),
                max_steps=(-1 if trainer_cfg.get("max_steps") is None
                           else int(trainer_cfg["max_steps"])),
                log_every_n_steps=trainer_cfg.get("log_every_n_steps"),
                checkpoint_every_n_epochs=int(ckpt_cfg.get("every_n_epochs", 1) or 1),
                batch_size=batch_size,
                shuffle=bool(data_cfg.get("shuffle", False)),
                eval_every=int(trainer_cfg.get("eval_every", 1)),
                frames_per_clip=frames_per_clip,
                figure_dir=trainer_cfg.get("figure_dir"),
                handle_signals=(signals,) if isinstance(signals, str) else tuple(signals),
            )
        except DataConfigError as exc:
            raise SystemExit(f"data error: {exc}")
        if result is not None and is_primary:
            print(f"final valid/rec_auc={result.rec_auc:.4f} valid/pr_auc={result.pr_auc:.4f}")
        return result
    finally:
        for logger in loggers:
            if hasattr(logger, "close"):
                logger.close()


def main(argv: Optional[List[str]] = None, config_dir: str = CONFIG_DIR):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-h" in argv or "--help" in argv:
        print_help(config_dir)
        return None
    sweep_dir = "multirun"
    while "--multirun-dir" in argv:
        i = argv.index("--multirun-dir")
        try:
            sweep_dir = argv[i + 1]
        except IndexError:
            raise SystemExit("--multirun-dir needs a directory argument")
        del argv[i: i + 2]
    print_cfg = "--cfg" in argv
    multirun = any(flag in argv for flag in ("-m", "--multirun"))
    argv = [arg for arg in argv if arg not in ("--cfg", "-m", "--multirun")]
    argv, device = split_device(argv)
    if multirun:
        return run_multirun(config_dir, argv, sweep_dir, device)

    from .config import compose

    try:
        cfg = compose(config_dir, "default", argv)
    except (ValueError, KeyError, FileNotFoundError) as exc:
        msg = exc.args[0] if exc.args else exc
        raise SystemExit(f"config error: {msg}\n(see --help)")
    if print_cfg:
        import yaml

        shown = {k: v for k, v in cfg.items() if k != "_choices_"}
        sys.stdout.write(yaml.safe_dump(shown, sort_keys=False))
        return None
    return train(cfg, device)


if __name__ == "__main__":
    main()
