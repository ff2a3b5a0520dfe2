"""CMU (VGG-19) two-branch OpenPose network.

Port of ``tfpose_tpu/models/cmu.py`` (reference
``tf_pose/network_cmu.py``): the VGG-19 prefix conv1_1..conv4_2 (to
conv4_1 the stem it shares with BODY_25, ``layers.VGG19_STEM``) with
``SAME`` max-pools, the CPM feature convs conv4_3_CPM (256) and
conv4_4_CPM (128), stage 1 branches ``conv5_{1..5}_CPM_L{1,2}`` (L1 -> 38
PAF, L2 -> 19 heat), and stages 2..6, each taking concat(prev L1, prev
L2, conv4_4_CPM) through five 7x7 and two 1x1 convs
``Mconv{1..7}_stage{s}_L{1,2}``. Every layer is a conv with bias, ReLU
but the last of each branch, and no BatchNorm.

The public layout is the JAX package's: the input is NHWC and
``concat_stage7`` = concat(heat 19, paf 38) is NHWC at stride 8; inside,
the convs run NCHW. Submodule names are the flax names. ``dtype`` is
the compute type (fp32 or bf16); the parameters stay fp32; ``quant`` is the
JAX ``QuantConv`` mode of every conv (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from tfpose_tpu_torch.models.layers import (
    Conv,
    add_vgg19_stem,
    nhwc,
    set_compute_dtype,
    set_quant_mode,
    vgg19_stem,
)
from tfpose_tpu_torch.utils.profiling import span

# after the shared VGG-19 stem (``layers.VGG19_STEM``, to conv4_1): the
# last VGG conv and the CPM feature convs, each with ReLU
_CPM = [("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
_FEAT = 128


class CmuNetwork(nn.Module):
    """VGG-19 CPM network. Input NHWC in [-0.5, 0.5]; output dict with
    the 57-channel ``concat_stage7`` and per-stage branch outputs."""

    def __init__(self, num_stages: int = 6,
                 dtype: torch.dtype = torch.float32,
                 quant: str = "none"):
        super().__init__()
        self.num_stages = num_stages
        ch = add_vgg19_stem(self)
        for name, out in _CPM:
            setattr(self, name, Conv(ch, out, (3, 3)))
            ch = out
        for li, out in ((1, 38), (2, 19)):
            ch = _FEAT
            for i in (1, 2, 3):
                setattr(self, f"conv5_{i}_CPM_L{li}", Conv(ch, 128, (3, 3)))
                ch = 128
            setattr(self, f"conv5_4_CPM_L{li}", Conv(128, 512, (1, 1)))
            setattr(self, f"conv5_5_CPM_L{li}",
                    Conv(512, out, (1, 1), relu=False))
            for s in range(2, num_stages + 1):
                ch = 38 + 19 + _FEAT
                for i in (1, 2, 3, 4, 5):
                    setattr(self, f"Mconv{i}_stage{s}_L{li}",
                            Conv(ch, 128, (7, 7)))
                    ch = 128
                setattr(self, f"Mconv6_stage{s}_L{li}",
                        Conv(128, 128, (1, 1)))
                setattr(self, f"Mconv7_stage{s}_L{li}",
                        Conv(128, out, (1, 1), relu=False))
        # compute type (the parameters stay fp32) and quantisation mode
        set_compute_dtype(self, dtype)
        set_quant_mode(self, quant)

    def _branch(self, names, h: torch.Tensor) -> torch.Tensor:
        for name in names:
            h = getattr(self, name)(h)
        return h

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, H, W, 3) float -> {"concat_stage7": (N, H/8, W/8, 57),
        "stages": [(paf, heat), ...] NHWC}, in ``self.dtype``."""
        with span("model.stem"):
            h = vgg19_stem(self, x.to(self.dtype).permute(0, 3, 1, 2))
            feat = self._branch([name for name, _ in _CPM], h)
        with span("model.stages"):
            paf, heat = (self._branch([f"conv5_{i}_CPM_L{li}"
                                       for i in range(1, 6)], feat)
                         for li in (1, 2))
            stages = [(paf, heat)]
            for s in range(2, self.num_stages + 1):
                inp = torch.cat([paf, heat, feat], 1)
                paf, heat = (self._branch([f"Mconv{i}_stage{s}_L{li}"
                                           for i in range(1, 8)], inp)
                             for li in (1, 2))
                stages.append((paf, heat))
            out = torch.cat([heat, paf], 1)
        return {"concat_stage7": nhwc(out),
                "stages": [(nhwc(p), nhwc(q)) for p, q in stages]}
