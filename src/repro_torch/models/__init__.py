"""Model substrate on the port (counterpart of `repro.models`):
transformer / MoE / RWKV6 / RG-LRU / enc-dec families in PyTorch."""
from repro_torch.models.config import ModelConfig, ShapeConfig, INPUT_SHAPES
from repro_torch.models.transformer import Model, build_model as _build_decoder_only
from repro_torch.models.encdec import build_encdec


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Single entry point: dispatch on family. The model's tensors live on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    if cfg.family == "encdec":
        return build_encdec(cfg, device)
    return _build_decoder_only(cfg, device)


__all__ = ["ModelConfig", "ShapeConfig", "INPUT_SHAPES", "Model", "build_model"]
