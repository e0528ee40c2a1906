"""Helpers of the port's int8 tests (``tests/test_torch_int8_*.py``) that
other port tests share: the conv geometries of the i3res50 int8 path, a
row-wise cosine, and a flax ConvBN's variables in a torch conv and BN.
Not a test module.
"""

import numpy as np
import torch


# (cin, kernel, stride, padding): every conv geometry of the i3res50 int8 path
GEOMETRIES = {
    "k133_s1": (16, (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    "k133_s2": (16, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    "k311": (16, (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    "k111": (16, (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    "k111_strided": (16, (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    "stem_k577_s2": (3, (5, 7, 7), (2, 2, 2), (2, 3, 3)),
}


def _cosine_rows(a, b):
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _port_conv_bn(variables, cin, cout, kernel, stride, padding, use_bn):
    conv = torch.nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
    bn = torch.nn.BatchNorm3d(cout)
    p = variables["params"]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(p["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)))
        if use_bn:
            s = variables["batch_stats"]["bn"]
            for tensor, value in ((bn.weight, p["bn"]["scale"]), (bn.bias, p["bn"]["bias"]),
                                  (bn.running_mean, s["mean"]), (bn.running_var, s["var"])):
                tensor.copy_(torch.from_numpy(np.asarray(value)))
    return conv, bn.eval()
