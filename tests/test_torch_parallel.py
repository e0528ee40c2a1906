"""PyTorch port vs the JAX package: scale-out on ``torch.distributed``.

Held on the CPU over gloo, with three launches of processes, each with one
torch thread, a timeout and a store on a port the OS picks:

- one spawn of 4 ranks (this file's ``spawn`` mode): three MGFN steps and
  one step each of RTFM and Sultani in float64, as DP over 4 ranks and as
  DP 2 x TP 2, against the port's single-process step (1e-12) and the JAX
  ``make_train_step(mesh)`` over 4 of conftest's 8 CPU devices with a 1-D
  and a (2, 2) mesh (1e-10); dropout 0.1 with one shared generator, BN
  running statistics, bf16-mixed (by cosine), micro-batches (k = 2), eval
  scores and AUCs, a stop signal on rank 1, the store barrier, rank 0 alone
  writing, a DP x TP checkpoint read back by a single-device state and by
  ``infer.build_scorer``, and per-rank TP state bytes at 1/tp; the ranks
  import the port with jax, flax and the JAX package made unimportable;
- two processes of ``extract_features --multihost`` (``extract`` mode,
  narrow stages) in float32 and int8, bit-equal to one process;
- two processes of ``run trainer.multihost=true`` for 2 steps, against one
  process.

Results come back as ``.npz`` files through a module-scoped fixture per
launch. The tensor-parallel rule, ``build_mesh`` and the extractor's
clip-axis split are held in this process.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
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


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Start the three launches, compute the in-process references while
    they run, then wait for them. -> a dict of everything the tests read."""
    from anomaly_detection_on_video_tpu_torch import extract_features, run
    from anomaly_detection_on_video_tpu_torch.data.synthetic import write_synthetic_dataset

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("parallel")
    spawn_out = str(root / "spawn")
    os.makedirs(spawn_out)
    variables = _jax_variables()
    weights = _port_weights(variables)
    torch.save(weights, os.path.join(spawn_out, "weights.pt"))
    procs, logs = [], []

    def start(cmd, log):
        logs.append(str(root / log))
        procs.append(_popen(cmd, logs[-1]))

    start([sys.executable, __file__, "spawn", spawn_out], "spawn.log")
    # two processes of extract_features --multihost, float32 then int8
    videos = str(root / "videos")
    _write_videos(videos, np.random.RandomState(0))
    ports = {dtype: free_port() for dtype in ("float32", "int8")}
    for pid in range(2):
        spec = [_extract_argv(videos, str(root / f"multi_{dtype}"), dtype)
                + ["--multihost", "--coordinator", f"127.0.0.1:{ports[dtype]}",
                   "--num-processes", "2", "--process-id", str(pid)]
                for dtype in ("float32", "int8")]
        with open(root / f"extract{pid}.json", "w") as f:
            json.dump(spec, f)
        start([sys.executable, __file__, "extract", str(root / f"extract{pid}.json")],
              f"extract{pid}.log")
    # two processes of run trainer.multihost=true, resuming the same step-0
    # checkpoint as the one-process run
    train_dir, test_dir, gt = write_synthetic_dataset(str(root / "data"), t=32, dim=64)
    data = [f"data.train_path={train_dir}", f"data.test_path={test_dir}",
            f"data.ground_truth_path={gt}", "trainer.resume=true"]
    for tag in ("p0", "p1", "single"):
        _write_start_checkpoint(str(root / tag / "ckpt"))
    port = free_port()
    for pid in range(2):
        start([sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.run"] + RUN_NARROW
              + data + [f"trainer.log_path={root}/p{pid}/metrics.jsonl",
                        f"trainer.checkpoint.dirpath={root}/p{pid}/ckpt",
                        "trainer.multihost=true", f"trainer.coordinator=127.0.0.1:{port}",
                        "trainer.num_processes=2", f"trainer.process_id={pid}"], f"run{pid}.log")
    try:
        out = {"root": root, "weights": weights, "single": {}, "jax": {}}
        for name in SCORER_CFG:
            for key in ("plain", "dropout"):
                overrides = DROPOUT[name] if key == "dropout" else {}
                losses, state = port_steps(name, weights, **overrides)
                out["single"][f"{name}/{key}"] = (losses, state_arrays(state))
            for key in MESHES:
                out["jax"][f"{name}/{key}"] = _jax_steps(name, variables[name], key)
        losses, state = port_steps("mgfn", weights, steps=1, precision="bf16-mixed",
                                   dtype=torch.float32)
        out["single"]["bf16"] = (losses, state_arrays(state))
        out["bf16_initial"] = {k: v.numpy() for k, v in weights["mgfn"].items()}
        losses, state = port_steps("mgfn", weights, steps=1, k=2)
        out["single"]["micro"] = (losses, state_arrays(state))
        runner, result = eval_runner(weights, None)
        out["single"]["eval"] = result
        real_extractor = extract_features.FeatureExtractor
        extract_features.FeatureExtractor = narrow_extractor
        try:
            for dtype in ("float32", "int8"):
                extract_features.main(_extract_argv(videos, str(root / f"single_{dtype}"), dtype))
        finally:
            extract_features.FeatureExtractor = real_extractor
        run.main(RUN_NARROW + data + [f"trainer.log_path={root}/single/metrics.jsonl",
                                      f"trainer.checkpoint.dirpath={root}/single/ckpt"])
    finally:
        texts = _finish(procs, logs)
        torch.set_num_threads(threads)
    out["logs"] = dict(zip(["spawn", "extract0", "extract1", "run0", "run1"], texts))
    out["ranks"] = [dict(np.load(os.path.join(spawn_out, f"rank{r}.npz"))) for r in range(4)]
    return out


def _params(rank_res, prefix):
    return {k[len(prefix):]: v for k, v in rank_res.items() if k.startswith(prefix)}


def _assert_params(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name", list(SCORER_CFG))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_single_process_f64(launched, name, mesh):
    """DP over 4 gloo ranks and DP 2 x TP 2: every rank's losses and final
    parameters and BN statistics equal the port's single-process steps."""
    losses, params = launched["single"][f"{name}/plain"]
    for res in launched["ranks"]:
        np.testing.assert_allclose(res[f"{name}/{mesh}/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, f"{name}/{mesh}/param/"), params, 1e-12, 1e-12)


@pytest.mark.parametrize("name", list(SCORER_CFG))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_jax_mesh_step_f64(launched, name, mesh):
    """The same runs against the JAX ``make_train_step(mesh)`` over 4 CPU
    devices with the (4,) and (2, 2) meshes (dropout 0: the frameworks'
    draws differ). The JAX step returns its loss as float32, the port's
    float64 step its float64 loss: the port's is rounded as the JAX one is."""
    ref_losses, ref_params = launched["jax"][f"{name}/{mesh}"]
    res = launched["ranks"][0]
    np.testing.assert_allclose(np.float32(res[f"{name}/{mesh}/losses"]), ref_losses, rtol=1e-10,
                               atol=0)
    got = _params(res, f"{name}/{mesh}/param/")
    _assert_params({k: got[k] for k in ref_params}, ref_params, 1e-10, 1e-10)


@pytest.mark.parametrize("name", list(SCORER_CFG))
def test_dropout_masks_drawn_at_the_global_shape(launched, name):
    """Dropout 0.1 (and MGFN's selection dropout 0.7) under DP over 4 ranks
    with one shared generator seed drops what the single step drops."""
    losses, params = launched["single"][f"{name}/dropout"]
    plain_losses, _ = launched["single"][f"{name}/plain"]
    assert losses[0] != plain_losses[0]  # the masks do drop
    for res in launched["ranks"]:
        np.testing.assert_allclose(res[f"{name}/dropout/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, f"{name}/dropout/param/"), params, 1e-12, 1e-12)


def test_batch_norm_running_statistics_are_global(launched):
    """MGFN's FocusAttention BN: every rank's running mean and variance
    after 3 DP steps are the single device's (global count, unbiased)."""
    _, params = launched["single"]["mgfn/plain"]
    stats = [k for k in params if "running_" in k]
    assert stats
    for res in launched["ranks"]:
        for key in ("dp4", "dp2tp2"):
            got = _params(res, f"mgfn/{key}/param/")
            for k in stats:
                np.testing.assert_allclose(got[k], params[k], rtol=1e-12, atol=1e-14, err_msg=k)
                assert not np.allclose(got[k], launched["weights"]["mgfn"][k].numpy())


def test_bf16_mixed_step_over_ranks(launched):
    """bf16-mixed over 4 ranks: loss within 1e-2 and parameter update
    cosine >= 0.99 against the single bf16-mixed step."""
    losses, params = launched["single"]["bf16"]
    initial = launched["bf16_initial"]
    res = launched["ranks"][0]
    np.testing.assert_allclose(res["bf16/losses"], losses, rtol=1e-2)
    got = _params(res, "bf16/param/")
    keys = [k for k in params if "running_" not in k]
    a = np.concatenate([(got[k] - initial[k]).ravel() for k in keys])
    b = np.concatenate([(params[k] - initial[k]).ravel() for k in keys])
    assert a.dtype == np.float32 and np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b) >= 0.99


def test_microbatched_step_over_ranks(launched):
    """k = 2 micro-batches, each sliced on axis 1, over 4 ranks."""
    losses, params = launched["single"]["micro"]
    for res in launched["ranks"]:
        np.testing.assert_allclose(res["micro/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, "micro/param/"), params, 1e-12, 1e-12)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_scores_and_aucs_over_ranks(launched, mesh):
    """7 videos, eval_batch_videos 3 rounded up to 4 on a 4-rank mesh:
    the gathered scores and the AUCs equal the single ``evaluate``."""
    single = launched["single"]["eval"]
    for res in launched["ranks"]:
        assert int(res[f"eval/{mesh}/batch_videos"]) == 4
        np.testing.assert_allclose(res[f"eval/{mesh}/preds"], single.preds, rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(res[f"eval/{mesh}/aucs"], [single.rec_auc, single.pr_auc],
                                   rtol=1e-12)


def test_stop_signal_on_one_rank_stops_every_rank(launched):
    """SIGTERM on rank 1 during step 2: every rank stops at step 2, and
    rank 0 alone saves that step."""
    assert [int(res["stop/step"]) for res in launched["ranks"]] == [2, 2, 2, 2]
    ckpt = launched["root"] / "spawn" / "stop_ckpt"
    assert sorted(os.listdir(ckpt)) == ["2"]


def test_store_barrier_and_blocked_imports(launched):
    """Every rank saw every rank's arrival after the barrier, and the ranks
    ran with jax, flax and the JAX package unimportable."""
    for res in launched["ranks"]:
        assert int(res["barrier/seen"]) == 4
        assert bool(res["imports_blocked"])


def test_only_rank_zero_writes_checkpoints(launched):
    returned = [bool(res["ckpt/returned"]) for res in launched["ranks"]]
    assert returned == [True, False, False, False]
    assert sorted(os.listdir(launched["root"] / "spawn" / "tp_ckpt")) == ["3", "hparams.json"]


def test_tp_checkpoint_loads_single_device_and_serves(launched):
    """The DP 2 x TP 2 checkpoint holds the single-device layout: it
    restores into a one-device state (parameters and Adam moments of the
    single 3-step run) and into ``infer.build_scorer``."""
    import argparse

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState

    path = str(launched["root"] / "spawn" / "tp_ckpt")
    _, params = launched["single"]["mgfn/plain"]
    model = port_model("mgfn", launched["weights"])
    state = TopKCheckpointer(path).restore(TrainState(model, adam_with_l2(model.parameters())))
    assert state.step == 3
    _assert_params(state_arrays(state), params, 1e-12, 1e-12)
    _, single = port_steps("mgfn", launched["weights"])
    for p, q in zip(state.model.parameters(), single.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(state.optimizer.state[p][key].numpy(),
                                       single.optimizer.state[q][key].numpy(), rtol=1e-10,
                                       atol=1e-16)
    args = infer.build_parser().parse_args(["--outdir", str(launched["root"] / "o"),
                                            "--checkpoint", path, "--device", "cpu"])
    scorer, name = infer.build_scorer(argparse.Namespace(**vars(args)))
    assert name == "mgfn"
    for k, v in scorer.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.double().numpy(), params[k], rtol=1e-6, atol=1e-7)


def test_tp_state_bytes_per_rank(launched):
    """Full-width Sultani on DP 2 x TP 2 after one step: each rank holds
    1/tp of the replicated state's bytes (to 1e-3), as tests/test_tp_audit.py
    holds the JAX package."""
    from anomaly_detection_on_video_tpu_torch.models import Sultani, SultaniConfig
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState

    model = Sultani(SultaniConfig(dropout_rate=0.0))
    state = TrainState(model, adam_with_l2(model.parameters()))
    replicated = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    for res in launched["ranks"]:
        assert abs(int(res["tp_bytes"]) / replicated - 0.5) < 1e-3
    assert state_bytes(state) == replicated // 3  # no moments before a step


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extract_features_multihost_two_processes(launched, dtype):
    """Two processes of ``extract_features --multihost``: every feature
    file bit-equal to one process; int8 scales pinned once, by process 0,
    before any feature file, equal to one process's; only process 0 writes
    segments."""
    root = launched["root"]
    multi, single = root / f"multi_{dtype}" / "train", root / f"single_{dtype}" / "train"
    names = sorted(n for n in os.listdir(single) if n.endswith("_i3d.npy"))
    assert names == ["v0_i3d.npy", "v1_i3d.npy", "v2_i3d.npy"]
    for n in names:
        np.testing.assert_array_equal(np.load(multi / n), np.load(single / n))
        seg = f"segment_features_32/{n}"
        np.testing.assert_array_equal(np.load(root / f"multi_{dtype}" / seg),
                                      np.load(root / f"single_{dtype}" / seg))
    logs = launched["logs"]
    for pid in range(2):
        assert f"[process {pid}/2] extracted" in logs[f"extract{pid}"]
    assert logs["extract0"].count("segmented 3 feature files") == 2  # float32 and int8
    assert "segmented" not in logs["extract1"]
    if dtype == "int8":
        scales = multi / "act_scales_rgb.json"
        assert json.loads(scales.read_text()) == json.loads((single / "act_scales_rgb.json")
                                                            .read_text())
        assert scales.stat().st_mtime <= min((multi / n).stat().st_mtime for n in names)
    else:
        assert not (multi / "act_scales_rgb.json").exists()


def test_run_multihost_two_processes(launched):
    """Two processes of ``run trainer.multihost=true`` (2 steps, the
    selection dropout on): process 0's losses equal one process's (float32),
    and process 1 writes no metrics, checkpoints or hparams."""
    root = launched["root"]

    def losses(path):
        with open(path) as f:
            return [line["train_loss"] for line in map(json.loads, f) if "train_loss" in line]

    single = losses(root / "single" / "metrics.jsonl")
    assert len(single) == 2
    np.testing.assert_allclose(losses(root / "p0" / "metrics.jsonl"), single, rtol=1e-5)
    assert not (root / "p1" / "metrics.jsonl").exists()
    assert os.listdir(root / "p1" / "ckpt") == ["0"]  # the start checkpoint only
    assert sorted(os.listdir(root / "p0" / "ckpt")) == ["0", "2", "hparams.json"]
    assert "resumed from step 0" in launched["logs"]["run0"]
    assert "resumed from step 0" not in launched["logs"]["run1"]


# ------------------------------------------------------ in this process

def _jax_tp_specs(tree, tp=2):
    import jax
    import jax.numpy as jnp

    from anomaly_detection_on_video_tpu.parallel import make_mesh as j_make_mesh
    from anomaly_detection_on_video_tpu.parallel import tensor_parallel_specs as j_specs

    mesh = j_make_mesh((8 // tp, tp), ("data", "model"))
    specs = j_specs({k: jax.ShapeDtypeStruct(np.shape(v), jnp.float32) for k, v in tree.items()},
                    mesh)
    return {k: (list(s.spec).index("model") if "model" in s.spec else None)
            for k, s in specs.items()}


def _export(name, variables):
    from anomaly_detection_on_video_tpu.utils import convert as jconvert

    return getattr(jconvert, f"export_{name}_state_dict")(variables)


@pytest.mark.parametrize("tree", ["rule", "mgfn", "rtfm", "sultani"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_specs_match_jax(tree, tp):
    """The port's placement of every entry equals the JAX rule's: the
    tree of tests/test_sharding.py, and the state dicts that the JAX
    ``export_*_state_dict`` functions name."""
    from anomaly_detection_on_video_tpu_torch.parallel import Mesh, tensor_parallel_specs

    if tree == "rule":
        state = {"kernel": np.zeros((3, 64, 128)), "bias": np.zeros((128,)),
                 "odd": np.zeros((7, 3)), "scalar": np.zeros(()), "tie": np.zeros((64, 64))}
    else:
        state = _export(tree, _jax_variables()[tree])
    port = tensor_parallel_specs(state, Mesh({"data": 8 // tp, "model": tp}))
    assert port == _jax_tp_specs(state, tp)
    if tree == "rule" and tp == 2:
        assert port == {"kernel": 2, "bias": 0, "odd": None, "scalar": None, "tie": 1}


@pytest.mark.parametrize("cfg", [{"data_parallel": True, "tensor_parallel": 2},
                                 {"tensor_parallel": 4}, {"data_parallel": True},
                                 {"data_parallel": True, "tensor_parallel": 8}, {}],
                         ids=["dp_tp2", "tp4", "dp", "tp8", "none"])
def test_build_mesh_matches_run_py(cfg):
    """``run.mesh_shape`` over 8 devices gives the root ``run.build_mesh``'s
    shapes and axis names (pytest's 8 CPU devices)."""
    import run as j_run

    from anomaly_detection_on_video_tpu_torch import run as t_run

    ref = j_run.build_mesh(cfg)
    got = t_run.mesh_shape(cfg, 8)
    if ref is None:
        assert got is None
    else:
        assert got == (tuple(ref.devices.shape), tuple(ref.axis_names))


def test_build_mesh_does_not_divide_and_one_device():
    import run as j_run

    from anomaly_detection_on_video_tpu_torch import run as t_run

    errors = []
    for fn in (lambda: j_run.build_mesh({"tensor_parallel": 3}),
               lambda: t_run.mesh_shape({"tensor_parallel": 3}, 8)):
        with pytest.raises(SystemExit) as exc:
            fn()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert t_run.mesh_shape({"data_parallel": True}, 1) is None
    assert t_run.mesh_shape({"data_parallel": True}, 1, distributed=True) == ((1,), ("data",))
    assert t_run.build_mesh({"data_parallel": True}) is None  # no process group here


def _frames(rng, n):
    return rng.randint(0, 256, (n, 72, 96, 3), dtype=np.uint8)


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "int8"])
def test_feature_extractor_split_over_two_devices_is_bit_equal(quantize):
    """``FeatureExtractor(devices=["cpu", "cpu"])``: every group's clips
    split over two replicas, bit-equal to one device (int8: the leader's
    calibration reaches the replica)."""
    torch.set_num_threads(1)
    frames = _frames(np.random.RandomState(4), 16 * 2 + 3)  # 3 clips, the last short
    one = narrow_extractor(device="cpu", batch=20, quantize=quantize,
                           dtype=torch.bfloat16 if quantize else torch.float32)
    two = narrow_extractor(devices=["cpu", "cpu"], batch=20, quantize=quantize,
                           dtype=torch.bfloat16 if quantize else torch.float32)
    assert two.n_shards == 2 and two.group_clips == 2 * one.group_clips == 4
    want = one.extract_frames(frames)
    if quantize:  # the leader takes one's scales; its replica must take them from it
        two.model.act_scales = one.model.act_scales
    got = two.extract_frames(frames)
    assert got.shape == (3, 10, 64)
    np.testing.assert_array_equal(got, want)
    if quantize:
        assert two._models[1].act_scales == two.model.act_scales == one.model.act_scales


@pytest.mark.parametrize("crops,batch", [("ten", 240), ("center", 240), ("ten", 40)])
def test_group_sizes_match_jax_two_device_mesh(crops, batch):
    """``group_clips`` and the adaptive ladder ``_group_for(n)`` for n in
    1..70 equal the JAX extractor's with a two-device mesh."""
    import jax

    from anomaly_detection_on_video_tpu.data.extraction import FeatureExtractor as JExtractor
    from anomaly_detection_on_video_tpu.parallel import make_mesh as j_make_mesh

    ref = JExtractor(variables={}, batch=batch, crops=crops, adaptive_groups=True,
                     mesh=j_make_mesh((2,), ("data",), jax.devices()[:2]))
    port = narrow_extractor(devices=["cpu", "cpu"], batch=batch, crops=crops,
                            adaptive_groups=True)
    assert port.group_clips == ref.group_clips
    assert [port._group_for(n) for n in range(1, 71)] == [ref._group_for(n) for n in range(1, 71)]


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "spawn":
        _spawn(sys.argv[2])
    elif mode == "extract":
        _extract(sys.argv[2])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
