from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig, DeepSpeedTransformerLayer, TransformerConfig)
from deepspeed_tpu_torch.ops.transformer.functional import \
    scaled_dot_product_attention
