"""chameleon-34b [vlm] — 48L d=8192 64H (GQA kv=8) ff=22016 vocab=65536,
early-fusion VQ image tokens (frontend stub: ids arrive pre-tokenised)
[arXiv:2405.09818; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, fsdp=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=8,
                               n_kv_heads=2, d_ff=128, vocab=256,
                               dtype="float32", fsdp=False, max_seq=64)
