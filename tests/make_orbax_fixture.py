"""Write ``tests/data/orbax_mgfn/``: a small run directory of the JAX
package's ``run.py`` (orbax steps), which the port reads on a card with
no JAX (``chip_smoke.py`` phase 19) and on the CPU
(``tests/test_torch_orbax.py``). Not a test; run from the repository
root:

    python tests/make_orbax_fixture.py

It trains ``runner=mgfn`` at ``channels=2048`` with narrow dims
(``FIXTURE_OVERRIDES``: 54,997 parameters) for two epochs, batch 3 + 3, on
the committed bags ``docs/i3d_segments_seed0.npz`` laid out as
``chip_smoke.write_training_data`` lays them out, from an init with random
norms (a fresh MGFN's identity LayerNorms tie the top-k in float32). It
writes:

- ``run/``: the run's checkpoint directory (``hparams.json``, steps 2
  and 4, each with its Adam moments);
- ``mgfn_step4.pt``: the JAX exporter's state dict of step 4;
- ``resume.json``: the overrides, the per-step losses and AUCs of the
  training run (``train_records``) and of the JAX ``run
  trainer.resume=true`` on a copy of ``run/`` for two more epochs
  (``records``; the copy is discarded).

The paths in ``hparams.json`` are relative (``data/...``): the runs start
in a scratch directory.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "data", "orbax_mgfn")

# the fixture's model and training; chip_smoke.py's phase 19 uses the same
FIXTURE_OVERRIDES = [
    "runner=mgfn", "runner.model_config.channels=2048", "runner.model_config.dims=[8,8,16]",
    "runner.model_config.depths=[1,1,1]", "runner.model_config.dim_head=4",
    "runner.model_config.dropout_rate=0.0", "runner.optimizer.learning_rate=1e-4",
    "data.train_path=data/train", "data.test_path=data/test",
    "data.ground_truth_path=data/ground_truth.json", "data.batch_size=3",
    "data.num_workers=0", "data.shuffle=true", "trainer.eval_every=1",
]


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [REPO, HERE]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    import run as j_run
    from anomaly_detection_on_video_tpu.models import build_model
    from anomaly_detection_on_video_tpu.training import runner as jrunner
    from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu.utils.convert import export_mgfn_state_dict
    from test_torch_mgfn import randomize_norms

    init = jrunner.VideoAnomalyDetectionRunner.init_state

    def init_random_norms(self, example):
        state = init(self, example)
        variables = randomize_norms({"params": state.params, "batch_stats": state.batch_stats},
                                    np.random.RandomState(5))
        self.state = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
        return self.state

    jrunner.VideoAnomalyDetectionRunner.init_state = init_random_norms
    work = tempfile.mkdtemp(prefix="orbax_fixture_")
    cwd = os.getcwd()
    try:
        os.chdir(work)
        chip_smoke.write_training_data("data")
        common = FIXTURE_OVERRIDES + ["trainer.data_parallel=false"]
        j_run.main(common + ["trainer.max_epochs=2", "trainer.log_path=train.jsonl",
                             "trainer.checkpoint.dirpath=run"])
        shutil.copytree("run", "resumed")
        j_run.main(common + ["trainer.max_epochs=4", "trainer.resume=true",
                             "trainer.log_path=resume.jsonl",
                             "trainer.checkpoint.dirpath=resumed"])
        records = {}
        for name in ("train", "resume"):
            with open(f"{name}.jsonl") as f:
                records[name] = [{k: r[k] for k in ("step", "train_loss", "valid/rec_auc",
                                                    "valid/pr_auc") if k in r}
                                 for r in map(json.loads, f)]
        ckpt = TopKCheckpointer(os.path.abspath("run"))
        runner = jrunner.VideoAnomalyDetectionRunner(build_model(
            "mgfn", channels=2048, dims=(8, 8, 16), depths=(1, 1, 1), dim_head=4,
            dropout_rate=0.0)[1])
        template = runner.init_state(np.zeros((2, 10, 32, 2049), np.float32))
        state = ckpt.restore(template, step=4)
        sd = export_mgfn_state_dict(jax.tree_util.tree_map(np.asarray, state.variables))
        n_params = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(state.params))

        shutil.rmtree(OUT, ignore_errors=True)
        os.makedirs(OUT)
        shutil.copytree("run", os.path.join(OUT, "run"))
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   os.path.join(OUT, "mgfn_step4.pt"))
        with open(os.path.join(OUT, "resume.json"), "w") as f:
            json.dump({"overrides": FIXTURE_OVERRIDES, "restored_step": 4, "max_epochs": 4,
                       "parameters": n_params, "train_records": records["train"],
                       "records": records["resume"]}, f, indent=1)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    steps = sorted(os.listdir(os.path.join(OUT, "run")))
    print(f"wrote {OUT}: {n_params} parameters, {steps}")


if __name__ == "__main__":
    main()
