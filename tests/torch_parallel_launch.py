"""The processes of the port's scale-out tests
(``tests/test_torch_parallel_*.py``) and the helpers both files share.

Run as ``python tests/torch_parallel_launch.py spawn <dir>`` it spawns 4
gloo ranks, each with one torch thread and jax, flax and the JAX package
made unimportable, which take the port's train steps over DP 4 and
DP 2 x TP 2 meshes and write their results to ``<dir>/rank<r>.npz``; as
``python tests/torch_parallel_launch.py extract <spec.json>`` it runs
``extract_features.main`` for each argv of the spec with a narrow
backbone. Not a test module.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCHER = os.path.abspath(__file__)  # this file, run as each launch's processes
BLOCKED = ("jax", "flax", "anomaly_detection_on_video_tpu")

# MGFN at two stages: a glance block, an intermediate, a focus block (BN)
SCORER_CFG = {"mgfn": dict(dims=(16, 32), depths=(1, 1), mgfn_types=("gb", "fb"), channels=64,
                           dim_head=8, dropout_rate=0.0),
              "rtfm": dict(channels=64, hidden_dims=(32, 16), dropout_rate=0.0),
              "sultani": dict(channels=64, hidden_dims=(32, 16), dropout_rate=0.0)}
DROPOUT = {"mgfn": dict(dropout=0.1, dropout_rate=0.7), "rtfm": dict(dropout_rate=0.1),
           "sultani": dict(dropout_rate=0.1)}
STEPS = {"mgfn": 3, "rtfm": 1, "sultani": 1}
MESHES = {"dp4": ((4,), ("data",)), "dp2tp2": ((2, 2), ("data", "model"))}
BS, T, LR, WD, GEN_SEED = 8, 16, 1e-3, 5e-4, 5
# the narrow I3D of tests/test_torch_i3d.py on 56-pixel crops
I3D_STAGES = ((8, 1, 1, (3,), (1,)), (16, 1, 2, (1,), (1,)))
CHILD_TIMEOUT = 240  # seconds, for every process launched here


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child_env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def batches(n, bs=BS, t=T, seed=20):
    """(video, normal labels, abnormal labels) float64 batches, normal bags first."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        out.append((np.abs(rng.randn(bs, 10, t, 65)) * 0.5, np.zeros(bs // 2), np.ones(bs // 2)))
    return out


# ------------------------------------------------------- the port's steps

def port_model(name, weights, dtype=torch.float64, **overrides):
    from anomaly_detection_on_video_tpu_torch.models import build_model

    _, model = build_model(name, **dict(SCORER_CFG[name], **overrides))
    model.load_state_dict(weights[name])
    return model.to(dtype).train()


def port_steps(name, weights, mesh=None, steps=None, precision="32-true", dtype=torch.float64,
               k=1, **overrides):
    """``steps`` optimizer steps of the port's train step -> (losses, state);
    on a mesh each rank feeds its slice of the bags."""
    from anomaly_detection_on_video_tpu_torch.parallel import shard_batch
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState, make_train_step

    model = port_model(name, weights, dtype, **overrides)
    state = TrainState.create(model, adam_with_l2(model.parameters(), LR, WD), GEN_SEED)
    step = make_train_step(precision, microbatched=k > 1, mesh=mesh, state=state)
    data = batches((steps or STEPS[name]) * k)
    losses = []
    for i in range(0, len(data), k):
        group = data[i:i + k]
        video, nlabels, alabels = ((np.stack([b[j] for b in group]) if k > 1 else group[0][j])
                                   for j in range(3))
        if mesh is not None:
            video = shard_batch(mesh, video, microbatched=k > 1)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        losses.append(float(step(state, as_t(video), as_t(nlabels), as_t(alabels))))
    return np.asarray(losses), state


def state_arrays(state) -> dict:
    model_sd, _ = state.state_dicts()
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16 else v.detach().numpy()
            for k, v in model_sd.items() if v.is_floating_point()}


def state_bytes(state) -> int:
    """Bytes of this rank's parameters and optimizer moments."""
    params = state.tp.parameters() if state.tp is not None else list(state.model.parameters())
    total = 0
    for p in params:
        total += p.numel() * p.element_size()
        for v in state.optimizer.state.get(p, {}).values():
            if isinstance(v, torch.Tensor) and v.dim():
                total += v.numel() * v.element_size()
    return total


def eval_runner(weights, mesh):
    from anomaly_detection_on_video_tpu_torch.data.synthetic import make_synthetic_eval
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import (
        TrainState,
        VideoAnomalyDetectionRunner,
    )

    model = port_model("mgfn", weights)
    runner = VideoAnomalyDetectionRunner(model, data_cfg={"num_workers": 0}, eval_batch_videos=3,
                                         device="cpu", mesh=mesh)
    runner.restore(TrainState.create(model, adam_with_l2(model.parameters()), GEN_SEED))
    return runner, runner.evaluate(make_synthetic_eval(3, n_videos=7, dim=64))


# ---------------------------------------------- the 4-rank spawn (worker)

def _rank(rank, world, port, out):
    for name in BLOCKED:
        sys.modules[name] = None
    torch.set_num_threads(1)
    from anomaly_detection_on_video_tpu_torch.models import Sultani, SultaniConfig, seeded_init_
    from anomaly_detection_on_video_tpu_torch.parallel import (
        barrier,
        initialize_multihost,
        make_mesh,
        shard_batch,
        shutdown,
    )
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState, make_train_step

    initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    weights = torch.load(os.path.join(out, "weights.pt"))
    meshes = {key: make_mesh(*shape) for key, shape in MESHES.items()}
    res = {"imports_blocked": all(sys.modules.get(n) is None for n in BLOCKED)}
    for name in SCORER_CFG:
        for key, mesh in meshes.items():
            losses, state = port_steps(name, weights, mesh)
            res[f"{name}/{key}/losses"] = losses
            for k, v in state_arrays(state).items():
                res[f"{name}/{key}/param/{k}"] = v
            if name == "mgfn" and key == "dp2tp2":
                ckpt = TopKCheckpointer(os.path.join(out, "tp_ckpt"))
                res["ckpt/returned"] = ckpt.save(STEPS[name], state) is not None
                ckpt.write_metadata({"model_name": "mgfn", "model_config": SCORER_CFG["mgfn"]})
        losses, state = port_steps(name, weights, meshes["dp4"], **DROPOUT[name])
        res[f"{name}/dropout/losses"] = losses
        for k, v in state_arrays(state).items():
            res[f"{name}/dropout/param/{k}"] = v
    losses, state = port_steps("mgfn", weights, meshes["dp4"], steps=1, precision="bf16-mixed",
                               dtype=torch.float32)
    res["bf16/losses"] = losses
    for k, v in state_arrays(state).items():
        res[f"bf16/param/{k}"] = v
    losses, state = port_steps("mgfn", weights, meshes["dp4"], steps=1, k=2)
    res["micro/losses"] = losses
    for k, v in state_arrays(state).items():
        res[f"micro/param/{k}"] = v
    for key, mesh in meshes.items():
        runner, result = eval_runner(weights, mesh)
        res[f"eval/{key}/preds"] = result.preds
        res[f"eval/{key}/aucs"] = np.array([result.rec_auc, result.pr_auc])
        res[f"eval/{key}/batch_videos"] = runner.eval_batch_videos
    # TP state bytes: full-width Sultani (the JAX TP audit's family), one step
    model = seeded_init_(Sultani(SultaniConfig(dropout_rate=0.0)), 0).train()
    state = TrainState.create(model, adam_with_l2(model.parameters(), LR, WD), GEN_SEED)
    step = make_train_step(mesh=meshes["dp2tp2"], state=state)
    video = np.random.RandomState(9).rand(4, 2, 8, 2049).astype(np.float32)
    step(state, torch.from_numpy(shard_batch(meshes["dp2tp2"], video)), torch.zeros(2),
         torch.ones(2))
    res["tp_bytes"] = state_bytes(state)
    res["stop/step"] = _stop_run(rank, weights, meshes["dp4"], out)
    # the store barrier: every rank sees every arrival after it
    time.sleep(0.1 * rank)
    open(os.path.join(out, f"arrived{rank}"), "w").close()
    barrier("arrivals")
    res["barrier/seen"] = sum(os.path.exists(os.path.join(out, f"arrived{r}"))
                              for r in range(world))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    shutdown()


def _stop_run(rank, weights, mesh, out) -> int:
    """``fit`` over the mesh with SIGTERM handled; rank 1 signals itself
    during its second step's logging: -> the step every rank stopped at."""
    from anomaly_detection_on_video_tpu_torch.data.synthetic import make_synthetic_train
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.runner import VideoAnomalyDetectionRunner

    class SignalAtStep:
        def log(self, metrics, step):
            if rank == 1 and step == 1 and "train_loss" in metrics:
                os.kill(os.getpid(), signal.SIGTERM)

    normal, abnormal = make_synthetic_train(4, n_videos=12, t=16, dim=64)
    runner = VideoAnomalyDetectionRunner(
        port_model("mgfn", weights), data_cfg={"num_workers": 0}, loggers=[SignalAtStep()],
        checkpointer=TopKCheckpointer(os.path.join(out, "stop_ckpt")), device="cpu", mesh=mesh)
    runner.init_state()
    runner.fit({"normal": normal, "abnormal": abnormal}, max_epochs=3, batch_size=2,
               handle_signals=("SIGTERM",))
    return runner.state.step


def _spawn(out, world=4):
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(world, free_port(), out), nprocs=world,
                       start_method="spawn")


def _extract(spec_path):
    """Run ``extract_features.main`` for each argv of the spec with the
    narrow backbone (the CLI's FeatureExtractor replaced)."""
    from anomaly_detection_on_video_tpu_torch import extract_features

    torch.set_num_threads(1)
    extract_features.FeatureExtractor = narrow_extractor
    with open(spec_path) as f:
        for argv in json.load(f):
            extract_features.main(argv)


def narrow_extractor(**kw):
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet

    kw.pop("model_name", None)
    kw.pop("state_dict", None)
    return FeatureExtractor(model=I3DResNet(stages=I3D_STAGES), resize=64, cropsize=56, **kw)


# ---------------------------------------------------- the parent's side

_VARIABLES = {}


def _jax_variables():
    """One flax variable tree per family, random: the shapes of
    ``model.init`` (traced, not run), LeCun-normal kernels, random biases,
    norms and BN statistics (so no top-k selection ties), in numpy."""
    import jax
    import jax.numpy as jnp

    from anomaly_detection_on_video_tpu.models import build_model as j_build_model

    if _VARIABLES:
        return _VARIABLES
    for i, name in enumerate(SCORER_CFG):
        _, model = j_build_model(name, **SCORER_CFG[name])
        shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(i),
                                             "dropout": jax.random.PRNGKey(9)},
                                jnp.zeros((2, 10, T, 65), jnp.float32))
        rng = np.random.RandomState(10 + i)

        def draw(path, leaf):
            key, shape = path[-1].key, leaf.shape
            if key == "kernel":
                value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif key in ("g", "scale", "var"):
                value = rng.rand(*shape) + 0.5
            else:  # bias, b, mean
                value = rng.randn(*shape) * 0.2
            return value.astype(np.float32)

        _VARIABLES[name] = jax.tree_util.tree_map_with_path(draw, shapes)
    return _VARIABLES


def _port_weights(variables):
    return {name: _from_flax(name, variables[name]) for name in SCORER_CFG}


def _jax_steps(name, variables, mesh_key):
    """The JAX package's mesh train step over 4 CPU devices, float64 ->
    (losses, final state in the port's names)."""
    import jax
    import jax.numpy as jnp

    from anomaly_detection_on_video_tpu.models import build_model as j_build_model
    from jax.sharding import NamedSharding, PartitionSpec

    from anomaly_detection_on_video_tpu.parallel import make_mesh as j_make_mesh
    from anomaly_detection_on_video_tpu.parallel import (
        tensor_parallel_specs as j_tensor_parallel_specs,
    )
    from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam
    from anomaly_detection_on_video_tpu.training.runner import TrainState as JTrainState
    from anomaly_detection_on_video_tpu.training.runner import make_train_step as j_make_train_step

    shape, names = MESHES[mesh_key]
    with jax.enable_x64(True):
        _, model = j_build_model(name, **SCORER_CFG[name])
        state = JTrainState.create(
            model, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables),
            j_adam(LR, WD))
        mesh = j_make_mesh(shape, names, devices=jax.devices()[:4])
        # placed as the JAX runner places it, so every step reuses one compile
        if "model" in names:
            state = jax.device_put(state, j_tensor_parallel_specs(state, mesh))
        else:
            state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
        step = j_make_train_step(mesh, state=state if "model" in names else None)
        losses = []
        for i, (video, nlabels, alabels) in enumerate(batches(STEPS[name])):
            state, loss = step(state, jnp.asarray(video), jnp.asarray(nlabels),
                               jnp.asarray(alabels), jax.random.PRNGKey(i))
            losses.append(float(loss))
        final = jax.tree_util.tree_map(np.asarray, state.variables)
    return np.asarray(losses), {k: v.numpy() for k, v in _from_flax(name, final).items()
                                if v.is_floating_point()}


def _from_flax(name, variables):
    from anomaly_detection_on_video_tpu_torch.utils import convert

    return getattr(convert, f"{name}_state_dict_from_flax")(variables)


def _write_videos(root, rng):
    import cv2

    os.makedirs(root)
    for i, n_frames in enumerate((24, 16, 20)):
        writer = cv2.VideoWriter(os.path.join(root, f"v{i}.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
        for _ in range(n_frames):
            writer.write(rng.randint(0, 256, (120, 160, 3), dtype=np.uint8))
        writer.release()


def _extract_argv(videos, outdir, dtype):
    return ["--videos", videos, "--outdir", outdir, "--split", "train", "--dtype", dtype,
            "--device", "cpu", "--decode-workers", "1", "--batch", "20"]


def _popen(cmd, log):
    return subprocess.Popen(cmd, cwd=REPO, env=child_env(), stdout=open(log, "w"),
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, logs):
    """Wait for every process (killing all at the timeout) -> their logs."""
    deadline = time.time() + CHILD_TIMEOUT
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    texts = [open(log).read() for log in logs]
    for proc, text in zip(procs, texts):
        assert proc.returncode == 0, text[-4000:]
    return texts


def _write_start_checkpoint(directory):
    """Step 0 of ``RUN_NARROW``'s MGFN with random norms: with the identity
    LayerNorms of a fresh init every clip's magnitude is sqrt(dim) to about
    1e-6, so float32 rounding would decide the top-k selection (the train
    tests randomize norms for the same reason)."""
    from anomaly_detection_on_video_tpu_torch.models import MGFN, MGFNConfig, seeded_init_
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState

    model = seeded_init_(MGFN(MGFNConfig(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8,
                                         channels=64)), 0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, value in model.state_dict().items():
            if name.endswith((".g", "norm.weight", "layer_norm.weight", "running_var")):
                value.copy_(torch.rand(value.shape, generator=gen) + 0.5)
            elif name.endswith((".b", "norm.bias", "layer_norm.bias", "running_mean")):
                value.copy_(torch.randn(value.shape, generator=gen) * 0.2)
    TopKCheckpointer(directory).save(0, TrainState(model, adam_with_l2(model.parameters())))


RUN_NARROW = ["runner=mgfn", "runner.model_config.dims=[16,16,32]",
              "runner.model_config.depths=[1,1,1]", "runner.model_config.dim_head=8",
              "runner.model_config.channels=64", "data.batch_size=4", "data.num_workers=0",
              "trainer.max_steps=2", "device=cpu"]


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "spawn":
        _spawn(sys.argv[2])
    elif mode == "extract":
        _extract(sys.argv[2])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
