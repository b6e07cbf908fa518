"""The dense architectures the port serves, copied from ``repro/configs/``
with the same values and citations. Importing this package populates the
registry of ``repro_torch.models.transformer.config.get_arch``. The other
families' configs come with their slices of the port."""
from repro_torch.configs import (  # noqa: F401
    gemma_7b,
    granite_20b,
    phi3_mini_3p8b,
    smollm_135m,
)
from repro_torch.models.transformer.config import get_arch, list_archs  # noqa: F401
