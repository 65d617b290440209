"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUB (precomputed patch
embeddings via input_specs()). [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    frontend="vision", frontend_tokens=256, frontend_dim=1024,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=512, frontend_tokens=8,
                          frontend_dim=32, remat=False)
