"""stablelm-1.6b [dense] — 24L d=2048 32H (kv=32) ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=256,
                               dtype="float32", max_seq=64)
