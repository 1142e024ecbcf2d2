"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072,
        n_experts=8, top_k=2, fsdp=True, opt_8bit=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=256, n_experts=4,
                               top_k=2, dtype="float32", fsdp=False,
                               opt_8bit=False, max_seq=64)
