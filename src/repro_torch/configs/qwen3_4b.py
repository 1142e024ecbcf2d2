"""qwen3-4b [dense] — 36L d=2560 32H (GQA kv=8) ff=9728 vocab=151936,
qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128,
        qk_norm=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                               dtype="float32", max_seq=64)
