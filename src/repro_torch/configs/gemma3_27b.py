"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab_size=262144,
    sliding_window=1024, global_every=6,  # layers 5, 11, ... are global
    rope_theta=1_000_000.0,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, sliding_window=8,
                          remat=False)
