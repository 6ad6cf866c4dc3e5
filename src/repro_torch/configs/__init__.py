from repro_torch.configs.base import TransformerConfig, TrustIRConfig, reduced
from repro_torch.configs.registry import get_config

__all__ = ["TransformerConfig", "TrustIRConfig", "reduced", "get_config"]
