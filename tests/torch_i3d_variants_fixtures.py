"""Helpers of the port's tests of the other I3D backbones
(``tests/test_torch_i3d_variants_*.py``): the variants with their narrow
stages, and a port model of a factory's geometry over narrow stages. Not a
test module.
"""

import torch

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from test_torch_i3d import NARROW


# two blocks in stages 2 and 3, so the odd block of each holds a non-local block
NL_STAGES = ((8, 1, 1, (3,), (1,)), (8, 2, 2, (3, 1), (1, 1)), (16, 2, 2, (1, 3), (1, 1)))
# a narrow i3d_8x8_r50 with four stages (pytorchvideo's layout has four) and
# 2048-wide features (the scoring CLI's MGFN), whose head pool fits 56-pixel crops
STAGES_2048 = ((8, 1, 1, (3,), (1,)), (8, 1, 2, (1,), (1,)), (8, 1, 1, (1,), (1,)),
               (512, 1, 1, (1,), (1,)))

# variant -> (port factory kwargs, JAX factory, narrow stages, clip shape)
VARIANTS = {
    "i3d_8x8_r50": (("i3d_8x8_r50", {}), lambda: ji3d.i3d_8x8_r50(), NARROW, (1, 8, 224, 224, 3)),
    "i3res50_nl": (("tushar-n-baseline", {"use_nl": True}), lambda: ji3d.i3res50(use_nl=True),
                   NL_STAGES, (2, 16, 64, 64, 3)),
    "i3res50_s2d": (("tushar-n-baseline", {"s2d_stem": True}), lambda: ji3d.i3res50(s2d_stem=True),
                    NARROW, (2, 16, 64, 64, 3)),
}


def narrow_like(model: ti3d.I3DResNet, stages, dtype=torch.float32) -> ti3d.I3DResNet:
    """A port model of ``model``'s geometry (stem, pools, head, non-local
    stages, S2D stem) over ``stages``."""
    return ti3d.I3DResNet(stages, dtype, model.conv1.in_channels, *model.stem,
                          pool_after_stage=model.pool_after_stage,
                          head_pool_kernel=model.head_pool_kernel,
                          nonlocal_stages=model.nonlocal_stages, s2d_stem=model.s2d_stem)


def _port_full(variant):
    name, kwargs = VARIANTS[variant][0]
    return ti3d.build_i3d_feature_extractor(name, **kwargs)
