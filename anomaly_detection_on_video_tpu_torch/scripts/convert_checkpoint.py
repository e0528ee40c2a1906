"""Checkpoint converter (the port's counterpart of
``scripts/convert_checkpoint.py``): torch state dicts to flax msgpack
variable files, the bytes the JAX script writes, through the port's own
codec (``utils/serialization.py``; no flax or msgpack needed)::

    python -m anomaly_detection_on_video_tpu_torch.scripts.convert_checkpoint \\
        --kind mgfn-official mgfn.pt out.msgpack
    ... --kind mgfn-hf hf_mgfn.pt out.msgpack
    ... --kind i3d i3res50.pt out.msgpack

and, with ``--reverse``, flax msgpack variables back to a torch state dict
(``torch.save``), the layout the port's CLIs and the reference load::

    ... --kind mgfn-hf --reverse vars.msgpack out.pt

Kinds: ``i3d`` (i3res50, the reference's names), ``i3d-8x8`` (a
pytorchvideo ``.pyth``'s ``model_state``), ``mgfn-hf``, ``mgfn-official``
(forward only, as in the reference), ``rtfm`` (the official release; a
BatchNorm after a conv folds into it) and ``sultani``. ``src`` may also be
a ``state.pt`` from a run of the earlier port, whose ``run`` saved its
checkpoints so (its ``model``; the port's ``run`` now writes orbax steps,
whose weights ``infer --checkpoint`` reads). Keys the
JAX converter ignores (an I3D file's Kinetics head) are dropped and named
on stderr; MGFN refuses unknown keys, as there. Host work only.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from ..utils.convert import (
    i3d_state_dict_from_flax,
    i3d_state_dict_from_pytorchvideo,
    i3d_state_dict_to_flax,
    i3d_state_dict_to_pytorchvideo,
    mgfn_state_dict_from_flax,
    mgfn_state_dict_from_official,
    mgfn_state_dict_to_flax,
    rtfm_state_dict_from_flax,
    rtfm_state_dict_from_official,
    rtfm_state_dict_to_flax,
    sultani_state_dict_from_flax,
    sultani_state_dict_to_flax,
)
from ..utils.serialization import load_variables, save_variables

KINDS = ("i3d", "i3d-8x8", "mgfn-hf", "mgfn-official", "rtfm", "sultani")

# kind -> torch state dict -> flax variables (the JAX script's converters)
TO_FLAX = {
    "i3d": lambda sd: i3d_state_dict_to_flax(sd, unknown="ignore"),
    "i3d-8x8": lambda sd: i3d_state_dict_to_flax(i3d_state_dict_from_pytorchvideo(sd)),
    "mgfn-hf": mgfn_state_dict_to_flax,
    "mgfn-official": lambda sd: mgfn_state_dict_to_flax(mgfn_state_dict_from_official(sd)),
    "rtfm": lambda sd: rtfm_state_dict_to_flax(rtfm_state_dict_from_official(sd)),
    "sultani": lambda sd: sultani_state_dict_to_flax(sd, unknown="ignore"),
}
# kind -> flax variables -> torch state dict (the JAX script's exporters)
FROM_FLAX = {
    "i3d": i3d_state_dict_from_flax,
    "i3d-8x8": lambda v: i3d_state_dict_to_pytorchvideo(i3d_state_dict_from_flax(v)),
    "mgfn-hf": mgfn_state_dict_from_flax,
    "mgfn-official": None,
    "rtfm": rtfm_state_dict_from_flax,
    "sultani": sultani_state_dict_from_flax,
}


def load_torch_state_dict(path: str) -> dict:
    """A torch weight file's state dict: a module's, a pytorchvideo
    ``.pyth``'s ``model_state``, a ``state_dict`` wrapper, or the
    ``model`` of a ``state.pt`` that a run of the earlier port saved as a
    checkpoint step."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    if isinstance(state_dict, dict):
        if "model_state" in state_dict:  # pytorchvideo .pyth layout
            state_dict = state_dict["model_state"]
        elif "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]
        elif {"model", "optimizer", "step"} <= set(state_dict):  # a port checkpoint
            state_dict = state_dict["model"]
    return state_dict


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("src", help="torch .pt state dict")
    parser.add_argument("dst", help="output .msgpack variables file")
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--reverse", action="store_true",
                        help="export flax msgpack variables (src) to a torch state dict (dst)")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.src):
        parser.error(f"src {args.src!r}: no such file")

    if args.reverse:
        exporter = FROM_FLAX[args.kind]
        if exporter is None:
            raise SystemExit("--reverse supports every kind but mgfn-official (the official "
                             "MGFN layout is write-only in the reference too)")
        sd = {k: v.contiguous() for k, v in exporter(load_variables(args.src)).items()}
        os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
        torch.save(sd, args.dst)
        print(f"exported {args.kind} flax variables -> torch state dict {args.dst}")
        return

    save_variables(args.dst, TO_FLAX[args.kind](load_torch_state_dict(args.src)))
    print(f"converted {args.kind} checkpoint -> {args.dst}")


if __name__ == "__main__":
    main()
