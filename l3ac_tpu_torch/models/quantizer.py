"""VQ embed wrapper: proj_in -> FSQ -> proj_out (``l3ac_tpu/models/quantizer.py``).

Plain Linear feature_dim -> codebook_dim and back (none when they are
equal). Eval path only.
"""

import torch
from torch import nn

from ..config import VQConfig
from ..ops import fsq, linear
from ..utils import init as pinit


class Quantizer(nn.Module):
    def __init__(self, feature_dim: int, vq: VQConfig, device=None):
        super().__init__()
        self.levels = vq.levels
        self.has_proj = feature_dim != vq.codebook_dim
        if self.has_proj:
            self.proj_in = nn.Linear(feature_dim, vq.codebook_dim, device=device)
            self.proj_out = nn.Linear(vq.codebook_dim, feature_dim, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        if self.has_proj:
            pinit.torch_linear_(self.proj_in, gen)
            pinit.torch_linear_(self.proj_out, gen)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.proj_in.weight, self.proj_in.bias) if self.has_proj else x

    def forward(self, x: torch.Tensor):
        """x: (B, T, feature_dim) -> (q (B, T, feature_dim), indices (B, T)
        int32, level indices (B, T, D) int32)."""
        q_z, indices, li = fsq.quantize(self.project_in(x), self.levels)
        q = linear(q_z, self.proj_out.weight, self.proj_out.bias) if self.has_proj else q_z
        return q, indices, li
