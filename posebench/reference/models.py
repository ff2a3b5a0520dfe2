"""Plain PyTorch forwards of the benchmark's two backbones, in fp32.

The OpenPose two-branch networks as published (arXiv:1611.08050 for
CMU's VGG-19 network; ildoonet/tf-pose-estimation's
``network_mobilenet_thin.py`` for mobilenet_thin), written from their
layer equations with ``torch.nn.functional`` alone: TF ``SAME`` padding
made explicit, convolutions in fp32 with TF32 off, BatchNorm in
inference form ``(x - mean) / sqrt(var + 1e-3) * scale + bias``. The
weights are a flax variables tree (``params`` and ``batch_stats``,
conv kernels HWIO), as the checkpoints store them; nothing here is the
program's code or takes anything the program made.

``spec(model)`` lists every convolution of a network; ``random_tree``
builds a tree of seeded weights from it on a device, and
``forward(model, tree, x)`` maps a normalized NHWC batch to the
57-channel stride-8 maps (heat 19, then PAF 38), NHWC.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3

# mobilenet_thin: conv_width 0.75, conv_width2 0.5, depths at least 8
_THIN_BACKBONE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                  (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1)]
# CMU's VGG-19 prefix and CPM feature convs; "pool" is a 2x2 max-pool
_VGG = [("conv1_1", 64), ("conv1_2", 64), "pool",
        ("conv2_1", 128), ("conv2_2", 128), "pool",
        ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
        ("conv3_4", 256), "pool",
        ("conv4_1", 512), ("conv4_2", 512),
        ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
NUM_STAGES = 6


class Conv(NamedTuple):
    """One convolution: its path in the tree, kernel size, input and
    output channels, stride, whether it is depthwise, whether a bias
    (CMU) or a BatchNorm (mobilenet) follows it."""

    path: Tuple[str, ...]
    k: int
    cin: int
    cout: int
    stride: int = 1
    depthwise: bool = False
    bias: bool = False
    bn: str = ""


def _thin_depth(ch: int) -> int:
    return max(int(ch * 0.75), 8)


def _thin_depth2(ch: int) -> int:
    return max(int(ch * 0.5), 8)


def _separable(path, k, cin, cout, stride=1) -> List[Conv]:
    return [Conv(path + ("depthwise",), k, cin, cin, stride, True,
                 bn="dw_bn"),
            Conv(path + ("pointwise",), 1, cin, cout, bn="pw_bn")]


def _thin_stage_branches(s: int, in_ch: int):
    mid, mid2 = _thin_depth2(128), _thin_depth2(512)
    for li, out in ((1, 38), (2, 19)):
        ch, convs = in_ch, []
        for i, (k, o) in enumerate(((3, mid), (3, mid), (3, mid),
                                    (1, mid2), (1, out)), start=1):
            convs.append(((f"MConv_Stage{s}", f"L{li}_{i}"), k, ch, o))
            ch = o
        yield convs


def _thin_feat_ch() -> int:
    return _thin_depth(128) + _thin_depth(512) + _thin_depth(512)


def spec(model: str) -> List[Conv]:
    """Every convolution of ``model`` ("mobilenet_thin" or "cmu")."""
    out: List[Conv] = []
    if model == "mobilenet_thin":
        out.append(Conv(("Conv2d_0", "conv"), 3, 3, _thin_depth(32), 2,
                        bn="bn"))
        ch = _thin_depth(32)
        for i, (o, s) in enumerate(_THIN_BACKBONE, start=1):
            out += _separable((f"Conv2d_{i}",), 3, ch, _thin_depth(o), s)
            ch = _thin_depth(o)
        for s in range(1, NUM_STAGES + 1):
            in_ch = _thin_feat_ch() + (0 if s == 1 else 57)
            for branch in _thin_stage_branches(s, in_ch):
                for path, k, ci, co in branch:
                    out += _separable(path, k, ci, co)
        return out
    if model == "cmu":
        ch = 3
        for layer in _VGG:
            if layer != "pool":
                out.append(Conv((layer[0], "conv"), 3, ch, layer[1],
                                bias=True))
                ch = layer[1]
        for li, o in ((1, 38), (2, 19)):
            ch = 128
            for i in (1, 2, 3):
                out.append(Conv((f"conv5_{i}_CPM_L{li}", "conv"), 3, ch,
                                128, bias=True))
                ch = 128
            out.append(Conv((f"conv5_4_CPM_L{li}", "conv"), 1, 128, 512,
                            bias=True))
            out.append(Conv((f"conv5_5_CPM_L{li}", "conv"), 1, 512, o,
                            bias=True))
            for s in range(2, NUM_STAGES + 1):
                ch = 57 + 128
                for i in range(1, 6):
                    out.append(Conv((f"Mconv{i}_stage{s}_L{li}", "conv"), 7,
                                    ch, 128, bias=True))
                    ch = 128
                out.append(Conv((f"Mconv6_stage{s}_L{li}", "conv"), 1, 128,
                                128, bias=True))
                out.append(Conv((f"Mconv7_stage{s}_L{li}", "conv"), 1, 128,
                                o, bias=True))
        return out
    raise ValueError(f"no reference for model {model!r}")


def _node(tree: Dict, path) -> Dict:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict, path, leaf: str, value) -> None:
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def random_tree(model: str, generator: torch.Generator,
                device) -> Dict[str, Dict]:
    """A variables tree of seeded weights on ``device``: conv kernels
    drawn from N(0, 1 / fan_in) (LeCun normal) by one call of the
    generator for all of them, biases 0, BatchNorm at identity."""
    convs = spec(model)
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


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[-2], 2, 2)
    left, right = _same_pads(x.shape[-1], 2, 2)
    x = F.pad(x, (left, right, top, bottom), value=-float("inf"))
    return F.max_pool2d(x, 2, 2)


def _thin(net: _Net, x: torch.Tensor) -> torch.Tensor:
    x = net.conv(x, ("Conv2d_0", "conv"), 2, bn="bn")
    taps = {}
    for i, (_, s) in enumerate(_THIN_BACKBONE, start=1):
        x = net.separable(x, (f"Conv2d_{i}",), s)
        taps[i] = x
    feat = torch.cat([_max_pool(taps[3]), taps[7], taps[11]], 1)
    h = feat
    for s in range(1, NUM_STAGES + 1):
        if s > 1:
            h = torch.cat([paf, heat, feat], 1)
        branches = []
        for branch in _thin_stage_branches(s, h.shape[1]):
            b = h
            for i, (path, k, _, _) in enumerate(branch):
                b = net.separable(b, path, relu=i < 4)
            branches.append(b)
        paf, heat = branches
    return torch.cat([heat, paf], 1)


def _cmu(net: _Net, x: torch.Tensor) -> torch.Tensor:
    h = x
    for layer in _VGG:
        h = _max_pool(h) if layer == "pool" else net.conv(h, (layer[0],
                                                              "conv"))

    def branch(names, inp):
        for i, name in enumerate(names):
            inp = net.conv(inp, (name, "conv"), relu=i < len(names) - 1)
        return inp

    feat = h
    paf, heat = (branch([f"conv5_{i}_CPM_L{li}" for i in range(1, 6)], feat)
                 for li in (1, 2))
    for s in range(2, NUM_STAGES + 1):
        inp = torch.cat([paf, heat, feat], 1)
        paf, heat = (branch([f"Mconv{i}_stage{s}_L{li}" for i in range(1, 8)],
                            inp) for li in (1, 2))
    return torch.cat([heat, paf], 1)


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
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalized (N, H, W, 3) fp32 -> (N, H/8, W/8, 57) fp32 maps, in
    true fp32 (``tf32=True`` lets cuDNN round the convs' inputs to TF32:
    the control). ``dtype=torch.bfloat16`` computes as a bf16 network
    with fp32 parameters does (activations, kernels and biases rounded to
    bf16, BatchNorm in fp32): what the stated precision alone gives.
    ``count`` receives each conv's multiply-adds."""
    body = {"mobilenet_thin": _thin, "cmu": _cmu}[model]
    with torch.no_grad(), _tf32(tf32):
        out = body(_Net(tree, count), x.to(dtype).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).float()


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> fp32 in [-0.5, 0.5): image / 256 - 0.5 (the
    reference repo's training convention)."""
    return img_u8.float() / 256.0 - 0.5
