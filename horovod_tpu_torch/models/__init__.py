from horovod_tpu_torch.models.transformer import (  # noqa: F401
    BertBase,
    TransformerConfig,
    TransformerLM,
    causal_attention,
    dot_product_attention,
)
