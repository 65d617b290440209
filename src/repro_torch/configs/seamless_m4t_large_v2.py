"""seamless-m4t-large-v2 [audio]: enc-dec, 24L decoder (+24L encoder)
d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206; speech frontend STUB
(precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24,
    frontend="audio", frontend_dim=160,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=128, vocab_size=512,
                          frontend_dim=32, remat=False)
