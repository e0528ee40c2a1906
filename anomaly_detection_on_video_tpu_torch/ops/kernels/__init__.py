"""Hand-written CUDA kernels for the H100, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter on the wrapper. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel or raises. The CUDA
sources live in ``csrc/`` and build at first use (``_build.py``).
"""

from .bottleneck import bottleneck_block, bottleneck_plain, pack_block_params
from .crop_norm import ten_crop_standardize, ten_crop_standardize_plain
from .int8_conv import int8_conv, int8_conv_plain, pack_int8_conv_weight
from .int8_matmul import int8_matmul, int8_matmul_plain
from .stem import pack_stem_params, stem_conv_pool, stem_plain

WRAPPERS = (ten_crop_standardize, stem_conv_pool, bottleneck_block, int8_matmul, int8_conv)


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    int8_conv.stem_launches = dict.fromkeys(int8_conv.stem_launches, 0)
    int8_conv.stem_stride_launches = dict.fromkeys(int8_conv.stem_stride_launches, 0)


def launch_counts() -> dict:
    return {wrapper.__name__: wrapper.launches for wrapper in WRAPPERS}


def stem_launch_counts() -> dict:
    """K5's stem launches by input channels (3: RGB, 2: the flow stream),
    a part of ``launch_counts()["int8_conv"]``."""
    return dict(int8_conv.stem_launches)


def stem_stride_launch_counts() -> dict:
    """K5's stem launches by temporal stride (2: i3res50, 1:
    i3d_8x8_r50), the same launches as ``stem_launch_counts``."""
    return dict(int8_conv.stem_stride_launches)


__all__ = [
    "WRAPPERS",
    "bottleneck_block",
    "bottleneck_plain",
    "int8_conv",
    "int8_conv_plain",
    "int8_matmul",
    "int8_matmul_plain",
    "launch_counts",
    "pack_block_params",
    "pack_int8_conv_weight",
    "pack_stem_params",
    "reset_launch_counts",
    "stem_launch_counts",
    "stem_stride_launch_counts",
    "stem_conv_pool",
    "stem_plain",
    "ten_crop_standardize",
    "ten_crop_standardize_plain",
]
