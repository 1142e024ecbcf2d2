"""qwen1.5-32b [dense] — 64L d=5120 40H (kv=40) ff=27392 vocab=152064,
QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True,
        fsdp=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=160, vocab=256,
                               dtype="float32", fsdp=False, max_seq=64)
