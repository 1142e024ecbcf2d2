"""zamba2-2.7b [hybrid] — 54L d=2560 32H (kv=32) ff=10240 vocab=32000,
ssm_state=64; Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, ssm_state=64,
        attn_every=6)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=4, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=256, ssm_state=8,
                               attn_every=2, dtype="float32", max_seq=64)
