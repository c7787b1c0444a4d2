from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import (ARCH_IDS, get_config, input_specs,
                                          iter_cells, reduced_config)
from repro_torch.configs.shapes import SHAPES, shape_applicable
