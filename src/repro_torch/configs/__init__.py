"""The ten architecture configs, the port's own copy of ``repro.configs``
(plain data: importing a module registers its ``ArchConfig``)."""
from . import (glm4_9b, granite_3_8b, granite_moe_1b_a400m, h2o_danube_3_4b,
               llama_3_2_vision_11b, mixtral_8x22b, phi3_mini_3_8b,
               whisper_tiny, xlstm_1_3b, zamba2_2_7b)

ALL_ARCHS = [
    "glm4-9b", "granite-3-8b", "granite-moe-1b-a400m", "h2o-danube-3-4b",
    "llama-3.2-vision-11b", "mixtral-8x22b", "phi3-mini-3.8b",
    "whisper-tiny", "xlstm-1.3b", "zamba2-2.7b",
]
