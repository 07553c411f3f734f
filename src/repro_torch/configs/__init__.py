"""configs — assigned architectures (exact public configs) and input shapes.

The port's own copy of the reference package's `configs` (data only; the
port never imports the reference).
"""

from repro_torch.configs.registry import ARCH_IDS, get_config, shape_skip_reason
from repro_torch.configs.shapes import SHAPES, ShapeSpec

__all__ = ["ARCH_IDS", "get_config", "shape_skip_reason", "SHAPES", "ShapeSpec"]
