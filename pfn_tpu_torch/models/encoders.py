"""Input encoders: (B, T, F) -> (B, T, D). Port of the part of
``pfn_tpu/models/encoders.py`` that the GP slice uses; the other encoders
are ROADMAP.md queue 1 item 9."""

from __future__ import annotations

from torch import nn

from pfn_tpu_torch.models.init import lecun_normal_


class LinearEncoder(nn.Linear):
    """nn.Linear parity (reference encoders.py:8). Its parameters are named
    ``weight`` and ``bias`` directly, as in the reference's state_dict."""

    def __init__(self, num_features: int, emsize: int):
        super().__init__(num_features, emsize)
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)
