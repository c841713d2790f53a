"""The ten assigned architectures, exact full configs + reduced smoke
variants of the same family shape.

Sources are the public configs cited in the assignment brief; smoke
variants preserve the family structure (block pattern, attention type,
MoE topology, GQA grouping) at toy width so one forward/train step runs
on CPU in seconds.
"""

from __future__ import annotations

from ..models.common import ModelConfig

__all__ = ["ARCHS", "get_config", "arch_names"]

_JAMBA_PATTERN = ("mamba", "mamba", "mamba", "mamba",
                  "attn", "mamba", "mamba", "mamba")


def _pixtral_12b() -> ModelConfig:
    # Pixtral ViT frontend is a stub (input embeddings); backbone is the
    # Mistral-Nemo 12B decoder.
    return ModelConfig(
        name="pixtral-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
        rope_theta=1e6, input_mode="embeddings")


def _pixtral_12b_smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=352, vocab=512,
        rope_theta=1e6, input_mode="embeddings")


def _xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", n_layers=12, d_model=768, n_heads=4,
        n_kv_heads=4, head_dim=192, d_ff=0, vocab=50304,
        block_pattern=("slstm", "mlstm"), xlstm_proj_factor=2.0,
        use_rope=False)


def _xlstm_125m_smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=0, vocab=512,
        block_pattern=("slstm", "mlstm"), xlstm_proj_factor=2.0,
        use_rope=False)


def _mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=0, vocab=32000,
        n_experts=8, top_k=2, moe_d_ff=14336, sliding_window=4096)


def _mixtral_8x7b_smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=0, vocab=512,
        n_experts=4, top_k=2, moe_d_ff=96, sliding_window=64)


def _deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=12288, vocab=102400,
        attn_type="mla", kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_experts=160, top_k=6, n_shared_experts=2, moe_d_ff=1536,
        first_dense_layers=1)


def _deepseek_v2_236b_smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke", n_layers=3, d_model=128, n_heads=8,
        n_kv_heads=8, head_dim=16, d_ff=256, vocab=512,
        attn_type="mla", kv_lora_rank=64, q_lora_rank=48,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
        first_dense_layers=1)


def _qwen15_05b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=2816, vocab=151936,
        qkv_bias=True, tie_embeddings=True)


def _qwen15_05b_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-smoke", n_layers=4, d_model=96, n_heads=6,
        n_kv_heads=6, head_dim=16, d_ff=256, vocab=512,
        qkv_bias=True, tie_embeddings=True)


def _starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152,
        qkv_bias=True, act="gelu", norm="layernorm")


def _starcoder2_7b_smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", n_layers=4, d_model=144, n_heads=9,
        n_kv_heads=3, head_dim=16, d_ff=384, vocab=512,
        qkv_bias=True, act="gelu", norm="layernorm")


def _mistral_nemo_12b() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
        rope_theta=1e6)


def _mistral_nemo_12b_smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=352, vocab=512, rope_theta=1e6)


def _internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544)


def _internlm2_20b_smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", n_layers=4, d_model=96, n_heads=6,
        n_kv_heads=1, head_dim=16, d_ff=256, vocab=512)


def _jamba_v01_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=65536,
        n_experts=16, top_k=2, moe_d_ff=14336, moe_layer_period=2,
        block_pattern=_JAMBA_PATTERN, use_rope=False,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2)


def _jamba_v01_52b_smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        n_experts=4, top_k=2, moe_d_ff=96, moe_layer_period=2,
        block_pattern=_JAMBA_PATTERN, use_rope=False,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2)


def _hubert_xlarge() -> ModelConfig:
    # Encoder-only; the CNN waveform frontend is a stub (precomputed
    # frame embeddings arrive as inputs).
    return ModelConfig(
        name="hubert-xlarge", n_layers=48, d_model=1280, n_heads=16,
        n_kv_heads=16, head_dim=80, d_ff=5120, vocab=504,
        causal=False, act="gelu", norm="layernorm",
        input_mode="embeddings", use_rope=False)


def _hubert_xlarge_smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", n_layers=4, d_model=80, n_heads=4,
        n_kv_heads=4, head_dim=20, d_ff=192, vocab=64,
        causal=False, act="gelu", norm="layernorm",
        input_mode="embeddings", use_rope=False)


ARCHS: dict[str, dict] = {
    "pixtral-12b": {"full": _pixtral_12b, "smoke": _pixtral_12b_smoke},
    "xlstm-125m": {"full": _xlstm_125m, "smoke": _xlstm_125m_smoke},
    "mixtral-8x7b": {"full": _mixtral_8x7b, "smoke": _mixtral_8x7b_smoke},
    "deepseek-v2-236b": {"full": _deepseek_v2_236b,
                         "smoke": _deepseek_v2_236b_smoke},
    "qwen1.5-0.5b": {"full": _qwen15_05b, "smoke": _qwen15_05b_smoke},
    "starcoder2-7b": {"full": _starcoder2_7b, "smoke": _starcoder2_7b_smoke},
    "mistral-nemo-12b": {"full": _mistral_nemo_12b,
                         "smoke": _mistral_nemo_12b_smoke},
    "internlm2-20b": {"full": _internlm2_20b, "smoke": _internlm2_20b_smoke},
    "jamba-v0.1-52b": {"full": _jamba_v01_52b, "smoke": _jamba_v01_52b_smoke},
    "hubert-xlarge": {"full": _hubert_xlarge, "smoke": _hubert_xlarge_smoke},
}


def get_config(name: str, variant: str = "full") -> ModelConfig:
    return ARCHS[name][variant]()


def arch_names() -> list[str]:
    return list(ARCHS)
