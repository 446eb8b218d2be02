"""The PFN transformer and its encoder, positional and decoder modules."""

from pfn_tpu_torch.models.decoders import FixedScaledDecoder, MLPDecoder, ScaledDecoder
from pfn_tpu_torch.models.encoders import (
    CanonicalEmbedding,
    EmbeddingEncoder,
    LinearEncoder,
    MLPEncoder,
    Normalize,
    NormalizedUniformEncoder,
)
from pfn_tpu_torch.models.moe import MoEFFN
from pfn_tpu_torch.models.positional import (
    LearnedPositionalEncoding,
    NoPositionalEncoding,
    PairedScrambledPositionalEncodings,
    SinusoidalPositionalEncoding,
)
from pfn_tpu_torch.models.transformer import (
    MultiheadPFNAttention,
    PFNEncoderLayer,
    PFNTransformer,
    SeqBN,
    TransformerConfig,
    num_params,
)

__all__ = [
    "CanonicalEmbedding",
    "EmbeddingEncoder",
    "FixedScaledDecoder",
    "LearnedPositionalEncoding",
    "LinearEncoder",
    "MLPDecoder",
    "MLPEncoder",
    "MoEFFN",
    "MultiheadPFNAttention",
    "NoPositionalEncoding",
    "Normalize",
    "NormalizedUniformEncoder",
    "PFNEncoderLayer",
    "PFNTransformer",
    "PairedScrambledPositionalEncodings",
    "ScaledDecoder",
    "SeqBN",
    "SinusoidalPositionalEncoding",
    "TransformerConfig",
    "num_params",
]
