"""The PFN transformer and its encoder, positional and decoder modules."""

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.encoders import LinearEncoder
from pfn_tpu_torch.models.positional import NoPositionalEncoding
from pfn_tpu_torch.models.transformer import (
    MultiheadPFNAttention,
    PFNEncoderLayer,
    PFNTransformer,
    TransformerConfig,
    num_params,
)

__all__ = [
    "LinearEncoder",
    "MLPDecoder",
    "MultiheadPFNAttention",
    "NoPositionalEncoding",
    "PFNEncoderLayer",
    "PFNTransformer",
    "TransformerConfig",
    "num_params",
]
