"""MGFN at full width in bf16-mixed: the port's train step against the JAX
package's on the CPU, on the seeded bags of ``chip_smoke.py`` phase 14 (b).

Not a test (pytest collects ``test_*.py`` only); run it by hand from the
repository root, on the CPU:

    python tests/bf16_fit_against_jax.py [--steps 20] [--lr 1e-4]

It prints, one line per step and run, the loss of:

- ``port-fit``: the port's ``VideoAnomalyDetectionRunner.fit`` exactly as
  phase 14 (b) runs it on the card (seed-0 weights, selection dropout 0.7
  from the runner's generator), on the CPU;
- ``jax-fit``: the JAX runner's ``fit`` on the same bags from the same
  weights (selection dropout 0.7 from its own keys: the draws differ);
- ``port-step`` / ``jax-step``: both packages' bf16-mixed steps on the same
  batches from the same weights with the selection dropout off, so the two
  trajectories are comparable step by step.

Before them it prints the first batch's train-mode loss of both packages
from the same weights with the selection dropout off, in float64 and in
float32 (the trajectories part from step 0 when the float32 losses
differ), and the gradient of both packages' ``bce_loss`` at a bfloat16
probability of exactly 1 with label 0 (the clamp at -100 bounds the loss,
not the gradient of ``log1p(-p)``). A NaN loss is printed as ``nan``; the
last line is one JSON object with the four loss lists.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from anomaly_detection_on_video_tpu.data import features as jfeatures  # noqa: E402
from anomaly_detection_on_video_tpu.losses.mgfn import bce_loss as j_bce_loss  # noqa: E402
from anomaly_detection_on_video_tpu.models.mgfn import MGFNConfig as JConfig  # noqa: E402
from anomaly_detection_on_video_tpu.models.mgfn import MGFNForVideoAnomalyDetection  # noqa: E402
from anomaly_detection_on_video_tpu.training import runner as jrunner  # noqa: E402
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam  # noqa: E402
from anomaly_detection_on_video_tpu.utils.convert import convert_mgfn_state_dict  # noqa: E402
from anomaly_detection_on_video_tpu_torch.data.features import train_batches  # noqa: E402
from anomaly_detection_on_video_tpu_torch.losses.mgfn import bce_loss  # noqa: E402
from anomaly_detection_on_video_tpu_torch.models import MGFN, MGFNConfig, seeded_init_  # noqa: E402
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner  # noqa: E402
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2  # noqa: E402
from anomaly_detection_on_video_tpu_torch.training.runner import (  # noqa: E402
    TrainState,
    make_train_step,
)
from anomaly_detection_on_video_tpu_torch.utils.convert import mgfn_state_dict_from_flax  # noqa: E402


class Losses:
    def __init__(self):
        self.values = []

    def log(self, metrics, step):
        if "train_loss" in metrics:
            self.values.append(float(metrics["train_loss"]))


def port_fit(bags, steps: int, lr: float):
    logger = Losses()
    runner = VideoAnomalyDetectionRunner(MGFN(), optimizer_cfg={"learning_rate": lr},
                                         data_cfg={"num_workers": 0}, loggers=[logger],
                                         precision="bf16-mixed", device="cpu")
    runner.init_state()
    runner.fit(bags, max_epochs=1000, max_steps=steps, batch_size=16)
    return logger.values


def jax_variables():
    """The port's seed-0 weights (what phase 14 (b) starts from) as flax
    variables, with the mapping checked both ways."""
    state_dict = seeded_init_(MGFN(), 0).state_dict()
    variables = convert_mgfn_state_dict({k: v.numpy() for k, v in state_dict.items()})
    back = mgfn_state_dict_from_flax(variables)
    assert sorted(back) == sorted(state_dict)
    for key, value in state_dict.items():
        assert torch.equal(back[key], value), key
    return variables


def jax_fit(bags, variables, steps: int, lr: float):
    """The JAX runner's fit on the same in-memory bags (its FeatureDataset
    takes the same arrays), from ``variables``."""
    logger = Losses()
    model = MGFNForVideoAnomalyDetection(JConfig())
    runner = jrunner.VideoAnomalyDetectionRunner(
        model, optimizer_cfg={"learning_rate": lr}, data_cfg={"num_workers": 0},
        loggers=[logger], precision="bf16-mixed")
    runner.state = jrunner.TrainState.create(model, jax.tree_util.tree_map(jnp.asarray, variables),
                                             j_adam(lr, 5e-4))
    jbags = {split: jfeatures.FeatureDataset(filenames=ds.filenames, _arrays=ds._arrays)
             for split, ds in bags.items()}
    runner.fit(jbags, max_epochs=1000, max_steps=steps, batch_size=16)
    return logger.values


def batches(bags, steps: int):
    out, epoch = [], 0
    while len(out) < steps:
        out += list(train_batches(bags["normal"], bags["abnormal"], batch_size=16, epoch=epoch))
        epoch += 1
    return out[:steps]


def first_losses(bags, variables):
    """{dtype: (port, jax)}: the first batch's train-mode loss, selection
    dropout off, from ``variables``, in float64 and float32."""
    batch = batches(bags, 1)[0]
    video, normal, abnormal = (batch[k] for k in ("feature", "normal_labels", "abnormal_labels"))
    model = MGFNForVideoAnomalyDetection(JConfig(dropout_rate=0.0))
    out = {}
    for np_dtype, dtype in ((np.float64, torch.float64), (np.float32, torch.float32)):
        with jax.enable_x64(np_dtype == np.float64):
            cast = lambda a: jnp.asarray(a, np_dtype)  # noqa: E731
            ref, _ = model.apply(jax.tree_util.tree_map(cast, variables), cast(video),
                                 abnormal_labels=cast(abnormal), normal_labels=cast(normal),
                                 train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
            ref = float(ref.loss)
        port = MGFN(MGFNConfig(dropout_rate=0.0))
        port.load_state_dict(mgfn_state_dict_from_flax(variables))
        port.train().to(dtype)
        got = port.outputs(*(torch.tensor(a, dtype=dtype) for a in (video, abnormal, normal)),
                           generator=torch.Generator())
        out[np.dtype(np_dtype).name] = (float(got.loss.detach()), ref)
    return out


def saturated_bce_gradients():
    """(port, jax): d bce_loss / d p at p = 1 in bfloat16, label 0."""
    p = torch.ones(1, dtype=torch.bfloat16, requires_grad=True)
    bce_loss(p, torch.zeros(1, dtype=torch.bfloat16)).backward()
    ref = jax.grad(lambda q: j_bce_loss(q, jnp.zeros(1, jnp.bfloat16)).astype(jnp.float32))(
        jnp.ones(1, jnp.bfloat16))
    return float(p.grad[0]), float(ref[0])


def steps_without_selection_dropout(bags, variables, steps: int, lr: float):
    """Both packages' bf16-mixed steps, selection dropout off, same batches."""
    cfg = dict(dropout_rate=0.0)
    port = MGFN(MGFNConfig(**cfg))
    port.load_state_dict(mgfn_state_dict_from_flax(variables))
    tstate = TrainState(port, adam_with_l2(port.parameters(), lr, 5e-4),
                        generator=torch.Generator().manual_seed(0))
    model = MGFNForVideoAnomalyDetection(JConfig(**cfg))
    jstate = jrunner.TrainState.create(model, jax.tree_util.tree_map(jnp.asarray, variables),
                                       j_adam(lr, 5e-4))
    t_step, j_step = make_train_step(precision="bf16-mixed"), jax.jit(
        jrunner.make_train_step(precision="bf16-mixed"))
    port_losses, jax_losses = [], []
    for i, batch in enumerate(batches(bags, steps)):
        parts = [batch[k] for k in ("feature", "normal_labels", "abnormal_labels")]
        port_losses.append(float(t_step(tstate, *map(torch.from_numpy, parts))))
        jstate, loss = j_step(jstate, *map(jnp.asarray, parts), jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    return port_losses, jax_losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-4)
    args = parser.parse_args(argv)
    bags = chip_smoke.seeded_bags(96, seed=14)
    variables = jax_variables()
    for dtype, (port, ref) in first_losses(bags, variables).items():
        print(f"first batch, {dtype}, selection dropout off: port {port!r}, jax {ref!r}", flush=True)
    port, ref = saturated_bce_gradients()
    print(f"bce_loss gradient at p = 1 (bfloat16), label 0: port {port}, jax {ref}", flush=True)
    runs = {"port-fit": port_fit(bags, args.steps, args.lr),
            "jax-fit": jax_fit(bags, variables, args.steps, args.lr)}
    runs["port-step"], runs["jax-step"] = steps_without_selection_dropout(
        bags, variables, args.steps, args.lr)
    for name, losses in runs.items():
        print(f"{name}: " + " ".join(f"{x:.6f}" for x in losses), flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
