"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16, mamba1 arch. [arXiv:2410.05355; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, vocab_size=256, remat=False)
