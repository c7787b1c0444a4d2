from repro_torch.quant.int8 import (dequantize, fake_quant, per_channel_scale,
                                    quantize, quantize_weights_tree)
