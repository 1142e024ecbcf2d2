"""rwkv6-1.6b [ssm] — 24L d=2048 (attention-free) ff=7168 vocab=65536,
Finch: data-dependent decay [arXiv:2404.05892; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=1,
                               n_kv_heads=1, d_ff=128, vocab=256,
                               dtype="float32", max_seq=64)
