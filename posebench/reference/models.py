"""What the plain PyTorch forwards of the benchmark's networks share,
in fp32.

Each network is an architecture file, ``reference/archs/<model>.py``,
found by the configuration's ``model`` (``lib/spec.py:arch``): the
OpenPose two-branch networks as published, written from their layer
equations with ``torch.nn.functional`` alone. This module holds what
they share: TF ``SAME`` padding made explicit, convolutions in fp32
with TF32 off, BatchNorm in inference form ``(x - mean) / sqrt(var +
1e-3) * scale + bias``, the 2x2 max-pool. The weights are a flax
variables tree (``params`` and ``batch_stats``, conv kernels HWIO), as
the checkpoints store them; nothing here is the program's code or takes
anything the program made.

``random_tree`` builds a tree of seeded weights on a device from an
architecture's ``convs()`` (and its ``LEAVES``), and ``forward(model,
tree, x)`` maps a normalized NHWC batch to the stride-8 maps of its
``body``, NHWC: the heat channels of its skeleton, then the PAF
channels.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posebench.lib import spec

BN_EPS = 1e-3


class Conv(NamedTuple):
    """One convolution: its path in the tree, kernel size, input and
    output channels, stride, whether it is depthwise, whether a bias
    (CMU) or a BatchNorm (mobilenet) follows it, and the modules of the
    architecture's own ``LEAVES`` that follow it."""

    path: Tuple[str, ...]
    k: int
    cin: int
    cout: int
    stride: int = 1
    depthwise: bool = False
    bias: bool = False
    bn: str = ""
    leaves: Tuple[str, ...] = ()


class Leaf(NamedTuple):
    """A parameter leaf of an architecture's own, which follows a conv
    as its BatchNorm does: an entry ``module: Leaf`` of the file's
    ``LEAVES``, named in a ``Conv``'s ``leaves``, puts ``name`` of
    ``shape(conv)`` at the conv's path with ``module`` in place of the
    conv's own module name, filled with ``init`` in a seeded tree; the
    program's state dict calls it ``suffix`` (a PReLU's slopes:
    ``Leaf("alpha", lambda c: (c.cout,), 0.25, "weight")``)."""

    name: str
    shape: Callable[[Conv], Tuple[int, ...]]
    init: float
    suffix: str
    collection: str = "params"


def _node(tree: Dict, path) -> Dict:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict, path, leaf: str, value) -> None:
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def random_tree(model: str, generator: torch.Generator, device,
                root: str = spec.ROOT) -> Dict[str, Dict]:
    """A variables tree of seeded weights on ``device``: conv kernels
    drawn from N(0, 1 / fan_in) (LeCun normal) by one call of the
    generator for all of them, biases 0, BatchNorm at identity, the
    architecture's own leaves at their ``init``."""
    arch = spec.arch(model, root)
    convs = arch.convs()
    sizes = [c.k * c.k * (1 if c.depthwise else c.cin) * c.cout
             for c in convs]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    tree: Dict[str, Dict] = {"params": {}}
    offset = 0
    for c, n in zip(convs, sizes):
        fan_in = c.k * c.k * (1 if c.depthwise else c.cin)
        shape = (c.k, c.k, 1 if c.depthwise else c.cin, c.cout)
        _put(tree["params"], c.path, "kernel",
             flat[offset:offset + n].view(shape) * fan_in ** -0.5)
        offset += n
        if c.bias:
            _put(tree["params"], c.path, "bias",
                 torch.zeros(c.cout, device=device))
        if c.bn:
            bn_path = c.path[:-1] + (c.bn,)
            _put(tree["params"], bn_path, "scale",
                 torch.ones(c.cout, device=device))
            _put(tree["params"], bn_path, "bias",
                 torch.zeros(c.cout, device=device))
            stats = tree.setdefault("batch_stats", {})
            _put(stats, bn_path, "mean", torch.zeros(c.cout, device=device))
            _put(stats, bn_path, "var", torch.ones(c.cout, device=device))
        for module in c.leaves:
            leaf = arch.LEAVES[module]
            _put(tree.setdefault(leaf.collection, {}),
                 c.path[:-1] + (module,), leaf.name,
                 torch.full(leaf.shape(c), leaf.init, device=device))
    return tree


def tree_to(tree, device) -> Dict:
    """The tree's arrays as fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _Net:
    """Applies the convolutions of one tree; ``count`` collects the
    multiply-adds of each (for the work counts)."""

    def __init__(self, tree: Dict, count: List[int] = None):
        self.params = tree["params"]
        self.stats = tree.get("batch_stats", {})
        self.count = count

    def node(self, path) -> Dict:
        """The parameters at ``path`` (an architecture's own leaves)."""
        return _node(self.params, path)

    def conv(self, x: torch.Tensor, path, stride: int = 1,
             relu: bool = True, bn: str = "") -> torch.Tensor:
        node = _node(self.params, path)
        kernel = node["kernel"]                     # (kh, kw, cin, cout)
        kh, kw, cin, cout = kernel.shape
        depthwise = cin == 1 and x.shape[1] > 1
        groups = x.shape[1] if depthwise else 1
        top, bottom = _same_pads(x.shape[-2], kh, stride)
        left, right = _same_pads(x.shape[-1], kw, stride)
        x = F.pad(x, (left, right, top, bottom))
        w = kernel.permute(3, 2, 0, 1).to(x.dtype)
        bias = node.get("bias")
        y = F.conv2d(x, w, None, stride, 0, 1, groups)
        if bias is not None:
            y = y + bias.to(x.dtype)[:, None, None]
        if self.count is not None:
            self.count.append(y.numel() * kh * kw * cin)
        if bn:
            p = _node(self.params, path[:-1] + (bn,))
            s = _node(self.stats, path[:-1] + (bn,))
            inv = (s["var"] + BN_EPS).rsqrt() * p["scale"]
            y = ((y.float() - s["mean"][:, None, None]) * inv[:, None, None]
                 + p["bias"][:, None, None]).to(x.dtype)
        return F.relu(y) if relu else y

    def separable(self, x, path, stride: int = 1, relu: bool = True):
        x = self.conv(x, path + ("depthwise",), stride, bn="dw_bn")
        return self.conv(x, path + ("pointwise",), relu=relu, bn="pw_bn")

    @staticmethod
    def max_pool(x: torch.Tensor) -> torch.Tensor:
        """2x2, stride 2, TF ``SAME``."""
        top, bottom = _same_pads(x.shape[-2], 2, 2)
        left, right = _same_pads(x.shape[-1], 2, 2)
        x = F.pad(x, (left, right, top, bottom), value=-float("inf"))
        return F.max_pool2d(x, 2, 2)


@contextlib.contextmanager
def _tf32(enabled: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def forward(model: str, tree: Dict, x: torch.Tensor,
            tf32: bool = False, count: List[int] = None,
            dtype: torch.dtype = torch.float32,
            root: str = spec.ROOT) -> torch.Tensor:
    """Normalized (N, H, W, 3) fp32 -> (N, H/8, W/8, heat + PAF) fp32
    maps of ``model``'s architecture, in true fp32 (``tf32=True`` lets
    cuDNN round the convs' inputs to TF32: the control).
    ``dtype=torch.bfloat16`` computes as a bf16 network with fp32
    parameters does (activations, kernels and biases rounded to bf16,
    BatchNorm in fp32): what the stated precision alone gives. ``count``
    receives each conv's multiply-adds."""
    body = spec.arch(model, root).body
    with torch.no_grad(), _tf32(tf32):
        out = body(_Net(tree, count), x.to(dtype).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).float()


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> fp32 in [-0.5, 0.5): image / 256 - 0.5 (the
    reference repo's training convention)."""
    return img_u8.float() / 256.0 - 0.5
