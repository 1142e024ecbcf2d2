"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained) [hf:databricks/dbrx-base; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352,
        n_experts=16, top_k=4, fsdp=True, opt_8bit=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=96, vocab=256, n_experts=4,
                               top_k=2, dtype="float32", fsdp=False,
                               opt_8bit=False, max_seq=64)
