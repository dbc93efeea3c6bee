"""Synthetic SNDS-shaped data (numpy generators; tables on a device)."""
from repro_torch.data.synthetic import (SyntheticConfig, generate_dcir,
                                        generate_pmsi, generate_snds)

__all__ = ["SyntheticConfig", "generate_dcir", "generate_pmsi",
           "generate_snds"]
