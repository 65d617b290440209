"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attn+mamba heads; sliding-window
attention except 3 global layers (first/middle/last). [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    sliding_window=1024, global_layers=(0, 15, 31),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, sliding_window=8,
                          global_layers=(0,), remat=False)
