"""The architectures the port serves, all ten of ``repro/configs/``, copied
with the same values and citations. Importing this package populates the
registry of ``repro_torch.models.transformer.config.get_arch``."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    gemma_7b,
    granite_20b,
    hymba_1p5b,
    llava_next_mistral_7b,
    mamba2_2p7b,
    musicgen_medium,
    phi3_mini_3p8b,
    smollm_135m,
)
from repro_torch.models.transformer.config import get_arch, list_archs  # noqa: F401
