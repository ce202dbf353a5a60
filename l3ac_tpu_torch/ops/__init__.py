"""Plain PyTorch ops of the port. The hand-written CUDA kernels and their
wrappers live in ``ops.kernels``."""

from .activations import gelu, geglu, silu, snake  # noqa: F401
from .conv import conv1d, conv1d_strided_matmul  # noqa: F401
from .norms import channel_norm, grn, instance_norm, layer_norm  # noqa: F401
from .pool import trend_pool  # noqa: F401
from .resample import upsample_linear  # noqa: F401
