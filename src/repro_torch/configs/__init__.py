from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          reduced_config)
