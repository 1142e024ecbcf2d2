"""musicgen-large [audio] — 48L d=2048 32H (kv=32) ff=8192 vocab=2048,
decoder-only over EnCodec tokens (4 codebooks summed; frontend stub)
[arXiv:2306.05284; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048, n_codebooks=4)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=64,
                               n_codebooks=2, dtype="float32", max_seq=64)
