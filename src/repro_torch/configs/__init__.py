"""Architecture registry of the port: importing this package registers every
config the port runs. Later slices add the other architectures of
``repro/configs`` as their model families are ported."""
from . import (  # noqa: F401
    gemma_2b,
    gpt_oss_20b,
    hubert_xlarge,
    hymba_1_5b,
    internvl2_76b,
    llama_3_1_8b,
    mixtral_8x7b,
    nemotron_4_340b,
    qwen3_1_7b,
    qwen3_32b,
    qwen3_235b,
    rwkv6_7b,
    stablelm_12b,
    starcoder2_7b,
)
from .shapes import smoke_config  # noqa: F401
